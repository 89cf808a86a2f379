"""End to end: ``lightgbm_tpu_torch.train`` against ``lightgbm_tpu.train``
on a 5000 x 28 synthetic task (binary and L2, 5 rounds, 63 leaves), a
JAX-trained booster carried across by ``convert.py``, and the model-file
round trip.

Tolerances: the first tree's model text identical where its sums are
exact (binary: gradients +-0.5 and hessians 0.25 at score 0; L2: integer
labels without boost-from-average); raw predictions within 1e-4 absolute
after 5 rounds and metrics within 1e-5 (later trees see gradients through
an f32 exp, and the split scan's f32 sums, whose last bits the two
libraries round differently); a carried-across booster's raw scores rtol
1e-6 against the JAX ``predict(raw_score=True)``.

The 5-round agreement needs a task without near-tied splits: where two
candidate splits tie up to rounding (the same rows split by both scan
directions of a feature with missing values, or by two features), the
last bit decides, and the packages may decide differently.  So the task
here has no missing values; test_torch_split and test_torch_grower cover
them."""
import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import convert

N, F = 5000, 28
COMMON = dict(num_leaves=63, learning_rate=0.1, verbose=-1,
              enable_bundle=False, enable_bin_packing=False)


def _rows(objective, seed, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, F))
    z = x @ np.linspace(1.5, 0.2, F) + 0.8 * np.sin(3 * x[:, 0])
    noise = rng.standard_normal(n) * 0.5
    y = ((z + noise > 0) if objective == "binary" else z + noise)
    return x, y.astype(np.float32)


def _task(objective, seed=2):
    return _rows(objective, seed, N) + _rows(objective, seed + 100, 1000)


def _tree_blocks(model_str):
    body = model_str.split("\nfeature importances:")[0]
    return ["Tree=" + b for b in body.split("Tree=")[1:]]


def _first_split_tree(model_str):
    return next(b for b in _tree_blocks(model_str)
                if "num_leaves=1\n" not in b)


def _assert_first_tree_matches(st, sj, objective):
    """Binary: identical text (exact sums).  L2 with real labels: the
    gradients init - y are real, and the split scan's f32 sums round in
    each library's order, so values agree to rtol 1e-5 / atol 1e-5 (a
    leaf value is a child sum that cancels to near 0) while the structure
    is identical."""
    a, b = _first_split_tree(st), _first_split_tree(sj)
    if objective == "binary":
        assert a == b
        return
    kv = lambda blk: dict(line.split("=", 1) for line in blk.splitlines()
                          if "=" in line)
    ka, kb = kv(a), kv(b)
    assert ka.keys() == kb.keys()
    for k in ka:
        if k in ("split_gain", "leaf_value", "internal_value", "threshold"):
            np.testing.assert_allclose(np.asarray(ka[k].split(), float),
                                       np.asarray(kb[k].split(), float),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            assert ka[k] == kb[k], k


@pytest.fixture(scope="module", params=["binary", "regression"])
def trained(request):
    obj = request.param
    x, y, xv, yv = _task(obj)
    params = dict(COMMON, objective=obj,
                  metric=["binary_logloss", "auc"] if obj == "binary"
                  else ["l2"])
    ev_j, ev_t = {}, {}
    dj = lj.Dataset(x, y, params=params)
    bj = lj.train(params, dj, 5, valid_sets=[lj.Dataset(xv, yv, reference=dj)],
                  evals_result=ev_j, verbose_eval=False)
    tp = dict(params, device="cpu")
    dt = lt.Dataset(x, y, params=tp)
    bt = lt.train(tp, dt, 5, valid_sets=[lt.Dataset(xv, yv, reference=dt)],
                  evals_result=ev_t, verbose_eval=False)
    return obj, x, xv, bj, bt, ev_j, ev_t, dj


def test_first_tree_model_text_identical(trained):
    obj, _, _, bj, bt, _, _, _ = trained
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert st.split("Tree=")[0] == sj.split("Tree=")[0]     # header
    _assert_first_tree_matches(st, sj, obj)
    assert len(_tree_blocks(st)) == len(_tree_blocks(sj))


def test_first_l2_tree_identical_under_integer_labels():
    x, y, _, _ = _task("regression")
    y = np.round(y)
    params = dict(COMMON, objective="regression", boost_from_average=False)
    bj = lj.train(params, lj.Dataset(x, y, params=params), 1)
    bt = lt.train(dict(params, device="cpu"),
                  lt.Dataset(x, y, params=dict(params, device="cpu")), 1)
    assert bt.model_to_string() == bj.model_to_string()


def test_predictions_and_metrics_close(trained):
    obj, x, xv, bj, bt, ev_j, ev_t, _ = trained
    for data in (x, xv):
        np.testing.assert_allclose(bt.predict(data, raw_score=True),
                                   bj.predict(data, raw_score=True),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(bt.predict(xv), bj.predict(xv), atol=1e-4)
    assert ev_t.keys() == ev_j.keys()
    for name in ev_j:
        assert ev_t[name].keys() == ev_j[name].keys()
        for metric in ev_j[name]:
            np.testing.assert_allclose(ev_t[name][metric],
                                       ev_j[name][metric], rtol=0,
                                       atol=1e-5, err_msg=metric)


def test_jax_booster_carried_across(trained):
    obj, x, xv, bj, _, _, _, _ = trained
    want = bj.predict(xv, raw_score=True)
    by_text = convert.booster_from_arrays(
        model_str=bj.model_to_string(), params={"device": "cpu"})
    # the same sequential float64 sums on the same leaves: the same bits
    np.testing.assert_array_equal(by_text.predict(xv, raw_score=True), want)
    trees = [{k: getattr(t, k) for k in (
        "num_leaves", "split_feature", "split_gain", "threshold",
        "decision_type", "left_child", "right_child", "leaf_parent",
        "leaf_value", "leaf_count", "internal_value", "internal_count",
        "shrinkage")} for t in bj.inner.models]
    by_fields = convert.booster_from_arrays(
        trees=trees, objective=bj.inner.objective.to_string(),
        max_feature_idx=F - 1, params={"device": "cpu"})
    np.testing.assert_array_equal(by_fields.predict(xv, raw_score=True),
                                  want)
    if obj == "binary":
        np.testing.assert_allclose(by_fields.predict(xv), bj.predict(xv),
                                   rtol=1e-6)


def test_jax_dataset_carried_across(trained):
    obj, _, _, bj, _, _, _, dj = trained
    td = dj.constructed
    used = td.used_features
    mappers = [td.bin_mappers[j] for j in used]
    ds = convert.dataset_from_arrays(
        td.binned, [m.num_bin for m in mappers],
        [m.missing_type for m in mappers], [m.default_bin for m in mappers],
        [m.bin_upper_bound for m in mappers], td.metadata.label,
        used_features=used, num_total_features=td.num_total_features,
        min_max=[(m.min_val, m.max_val) for m in mappers],
        params={"device": "cpu"})
    bt = lt.train(dict(COMMON, objective=obj, device="cpu"), ds, 1)
    _assert_first_tree_matches(bt.model_to_string(), bj.model_to_string(),
                               obj)


def test_save_load_round_trip(trained, tmp_path):
    _, _, xv, _, bt, _, _, _ = trained
    path = tmp_path / "model.txt"
    bt.save_model(str(path))
    loaded = lt.Booster(model_file=str(path), params={"device": "cpu"})
    assert loaded.model_to_string() == bt.model_to_string()
    np.testing.assert_array_equal(loaded.predict(xv, raw_score=True),
                                  bt.predict(xv, raw_score=True))
    # the port's model file loads in the JAX package too
    jb = lj.Booster(model_file=str(path))
    np.testing.assert_allclose(jb.predict(xv, raw_score=True),
                               bt.predict(xv, raw_score=True), rtol=1e-6,
                               atol=1e-12)


def test_early_stopping_matches_jax():
    x, y, xv, yv = _task("binary", seed=4)
    params = dict(COMMON, objective="binary", num_leaves=31,
                  min_data_in_leaf=2, learning_rate=1.0,
                  metric="binary_logloss")
    dj = lj.Dataset(x[:300], y[:300], params=params)
    bj = lj.train(params, dj, 40, valid_sets=[lj.Dataset(xv, yv,
                                                         reference=dj)],
                  early_stopping_rounds=3, verbose_eval=False)
    tp = dict(params, device="cpu")
    dt = lt.Dataset(x[:300], y[:300], params=tp)
    bt = lt.train(tp, dt, 40, valid_sets=[lt.Dataset(xv, yv, reference=dt)],
                  early_stopping_rounds=3, verbose_eval=False)
    assert 0 < bt.best_iteration < 40
    assert bt.best_iteration == bj.best_iteration
    np.testing.assert_allclose(
        bt.best_score["valid_0"]["binary_logloss"],
        bj.best_score["valid_0"]["binary_logloss"], atol=1e-5)


@pytest.mark.parametrize("impl,ordered", [("sort", "off"), ("scatter", "on"),
                                          ("compact", "on")])
def test_partition_modes_give_the_same_model(trained, impl, ordered):
    """``partition_impl`` and ``ordered_bins`` change how a split moves its
    rows, not which rows go where: the model text is identical."""
    obj, _, xv, _, bt, _, _, _ = trained
    x, y, _, _ = _task(obj)
    params = dict(COMMON, objective=obj, device="cpu", partition_impl=impl,
                  ordered_bins=ordered,
                  metric=["binary_logloss", "auc"] if obj == "binary"
                  else ["l2"])
    other = lt.train(params, lt.Dataset(x, y, params=params), 5)
    assert other.model_to_string() == bt.model_to_string()
    np.testing.assert_array_equal(other.predict(xv, raw_score=True),
                                  bt.predict(xv, raw_score=True))


@pytest.mark.parametrize("params", [{"partition_impl": "fast"},
                                    {"ordered_bins": "maybe"}])
def test_layout_parameters_are_checked(params):
    x, y, _, _ = _task("binary")
    p = dict(COMMON, objective="binary", device="cpu", **params)
    with pytest.raises(RuntimeError, match="must be"):
        lt.train(p, lt.Dataset(x[:200], y[:200], params=p), 1)
