"""Training breadth end to end: ``lightgbm_tpu_torch.train`` against
``lightgbm_tpu.train`` on a 2000 x 10 synthetic task, 5 rounds of 15
leaves, for multiclass (3 classes), multiclassova, lambdarank (with a
valid set that has query groups) and every regression objective.

Tolerances:
* the first round's model text (its K trees, after the boost-from-average
  tree where there is one) is identical where the round's gradient sums
  are exact (multiclassova at score 0: gradients +-0.5, hessians 0.25);
  elsewhere the gradients are real-valued and the split scan's f32 sums
  round in each library's order, so the structure is identical and the
  values agree to rtol 1e-4 / atol 1e-5 (a leaf value is -G / H, G a sum
  of gradients of both signs that cancel; a gain is the children's G^2 / H
  less the parent's, which cancel too);
* after 5 rounds raw predictions within 2e-4 absolute and every metric
  value within 1e-5 (the gaussian hessian of L1 and huber, the softmax and
  the lambdarank sums carry more roundings than L2: 2e-4, not the L2 test's
  1e-4).

Every objective and metric name of the JAX registries also trains
through the port on the CPU."""
import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import SUPPORTED_OBJECTIVES

N, F, NV = 2000, 10, 600
COMMON = dict(num_leaves=15, learning_rate=0.1, verbose=-1,
              enable_bundle=False, enable_bin_packing=False)
QUERY = 25            # training query size; valid queries are 30 long
EXACT_FIRST_ROUND = ("multiclassova",)


def _rows(objective, seed, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, F))
    z = x @ np.linspace(1.5, 0.2, F) + 0.8 * np.sin(3 * x[:, 0])
    noise = rng.standard_normal(n) * 0.5
    if objective in ("multiclass", "multiclassova"):
        y = np.digitize(z + noise, [-1.0, 1.0])
    elif objective == "lambdarank":
        y = np.clip(np.round((z + noise) / 1.5 + 1.0), 0, 4)
    elif objective == "poisson":
        y = rng.poisson(np.exp(0.3 * np.clip(z, -3, 3)))
    elif objective in ("xentropy", "xentlambda"):
        y = 1.0 / (1.0 + np.exp(-(z + noise)))
    else:
        y = z + noise
    return x, y.astype(np.float32)


def _params(objective):
    p = dict(COMMON, objective=objective)
    if objective in ("multiclass", "multiclassova"):
        p.update(num_class=3, metric=["multi_logloss", "multi_error"])
    if objective == "lambdarank":
        p.update(metric=["ndcg", "map"], ndcg_eval_at=[1, 3, 5])
    return p


def _groups(objective):
    if objective != "lambdarank":
        return {}, {}
    return {"group": [QUERY] * (N // QUERY)}, {"group": [30] * (NV // 30)}


def tree_blocks(model_str):
    body = model_str.split("\nfeature importances:")[0]
    return ["Tree=" + b for b in body.split("Tree=")[1:]]


def assert_trees_match(a_blocks, b_blocks, exact):
    """Identical text (``exact``), or identical structure and values
    within rtol 1e-4 / atol 1e-5."""
    assert len(a_blocks) == len(b_blocks)
    for a, b in zip(a_blocks, b_blocks):
        if exact:
            assert a == b
            continue
        kv = lambda blk: dict(line.split("=", 1) for line in blk.splitlines()
                              if "=" in line)
        ka, kb = kv(a), kv(b)
        assert ka.keys() == kb.keys()
        for k in ka:
            if k in ("split_gain", "leaf_value", "internal_value"):
                np.testing.assert_allclose(
                    np.asarray(ka[k].split(), float),
                    np.asarray(kb[k].split(), float),
                    rtol=1e-4, atol=1e-5,
                    err_msg=k)
            else:
                assert ka[k] == kb[k], k


def train_both(objective, rounds=5, params=None, **data_kw):
    """Train both packages on the same rows; returns (port booster, JAX
    booster, port evals, JAX evals)."""
    x, y = _rows(objective, 2, N)
    xv, yv = _rows(objective, 102, NV)
    p = params or _params(objective)
    kw, kwv = _groups(objective)
    kw.update(data_kw)
    ev_j, ev_t = {}, {}
    dj = lj.Dataset(x, y, params=p, **kw)
    bj = lj.train(p, dj, rounds, valid_sets=[lj.Dataset(xv, yv, reference=dj,
                                                        **kwv)],
                  evals_result=ev_j, verbose_eval=False)
    tp = dict(p, device="cpu")
    dt = lt.Dataset(x, y, params=tp, **kw)
    bt = lt.train(tp, dt, rounds, valid_sets=[lt.Dataset(xv, yv, reference=dt,
                                                         **kwv)],
                  evals_result=ev_t, verbose_eval=False)
    return bt, bj, ev_t, ev_j


def assert_close_after_rounds(bt, bj, ev_t, ev_j, objective):
    x, _ = _rows(objective, 2, N)
    xv, _ = _rows(objective, 102, NV)
    for data in (x, xv):
        np.testing.assert_allclose(bt.predict(data, raw_score=True),
                                   bj.predict(data, raw_score=True),
                                   rtol=0, atol=2e-4)
    assert ev_t.keys() == ev_j.keys()
    for name in ev_j:
        assert ev_t[name].keys() == ev_j[name].keys()
        for metric in ev_j[name]:
            np.testing.assert_allclose(ev_t[name][metric],
                                       ev_j[name][metric], rtol=0,
                                       atol=1e-5, err_msg=metric)


@pytest.fixture(scope="module", params=[
    "multiclass", "multiclassova", "lambdarank", "regression_l1", "huber",
    "fair", "poisson"])
def trained(request):
    return (request.param,) + train_both(request.param)


def test_first_round_matches_jax(trained):
    obj, bt, bj, _, _ = trained
    st, sj = bt.model_to_string(), bj.model_to_string()
    assert st.split("Tree=")[0] == sj.split("Tree=")[0]      # header
    k = bj.inner.num_class
    first = k + (1 if "\nboost_from_average\n" in sj else 0)
    assert_trees_match(tree_blocks(st)[:first], tree_blocks(sj)[:first],
                       obj in EXACT_FIRST_ROUND)
    assert len(tree_blocks(st)) == len(tree_blocks(sj))


def test_predictions_and_metrics_close(trained):
    obj, bt, bj, ev_t, ev_j = trained
    assert_close_after_rounds(bt, bj, ev_t, ev_j, obj)
    xv, _ = _rows(obj, 102, NV)
    want, got = bj.predict(xv), bt.predict(xv)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_model_file_round_trip(trained, tmp_path):
    obj, bt, _, _, _ = trained
    xv, _ = _rows(obj, 102, NV)
    path = tmp_path / "model.txt"
    bt.save_model(str(path))
    loaded = lt.Booster(model_file=str(path), params={"device": "cpu"})
    assert loaded.model_to_string() == bt.model_to_string()
    assert loaded.inner.num_class == bt.inner.num_class
    np.testing.assert_array_equal(loaded.predict(xv), bt.predict(xv))
    # the port's model file loads in the JAX package too
    jb = lj.Booster(model_file=str(path))
    np.testing.assert_allclose(jb.predict(xv, raw_score=True),
                               bt.predict(xv, raw_score=True), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("objective", SUPPORTED_OBJECTIVES)
def test_every_objective_trains(objective):
    """Every name of the JAX objective registry trains through the port
    on the CPU, with its default metric."""
    kind = ("multiclass" if "multi" in objective or objective in (
        "softmax", "ova", "ovr") else objective)
    x, y = _rows(kind, 3, 300)
    p = dict(COMMON, objective=objective, device="cpu")
    if kind == "multiclass":
        p["num_class"] = 3
    kw = {"group": [30] * 10} if objective == "lambdarank" else {}
    ev = {}
    d = lt.Dataset(x, y, params=p, **kw)
    b = lt.train(p, d, 2, valid_sets=[d], evals_result=ev,
                 verbose_eval=False)
    assert ev and all(np.isfinite(v).all() for m in ev.values()
                      for v in m.values())
    assert np.isfinite(b.predict(x)).all()


def test_every_metric_trains():
    """Every name of the JAX metric factory evaluates through ``train``."""
    from lightgbm_tpu.metrics import _REGISTRY as jax_metrics
    x, y = _rows("lambdarank", 4, 300)
    y = (y > 1).astype(np.float32)      # binary, ranked, in [0, 1]
    names = sorted(n for n in jax_metrics
                   if n not in ("multi_logloss", "multiclass", "softmax",
                                "multiclassova", "multi_error"))
    p = dict(COMMON, objective="binary", device="cpu", metric=names)
    ev = {}
    d = lt.Dataset(x, y, group=[30] * 10, params=p)
    lt.train(p, d, 2, valid_sets=[d], evals_result=ev, verbose_eval=False)
    # one entry a metric (aliases merge), ndcg and map one an eval_at
    assert ({k.split("@")[0] for k in ev["valid_0"]}
            == {jax_metrics[n].name for n in names})
    pm = dict(COMMON, objective="multiclass", num_class=3, device="cpu",
              metric=["multi_logloss", "multiclass", "softmax",
                      "multiclassova", "multi_error"])
    xm, ym = _rows("multiclass", 4, 300)
    ev = {}
    dm = lt.Dataset(xm, ym, params=pm)
    lt.train(pm, dm, 2, valid_sets=[dm], evals_result=ev, verbose_eval=False)
    assert set(ev["valid_0"]) == {"multi_logloss", "multi_error"}
