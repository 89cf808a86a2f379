"""Categorical features in the port against lightgbm_tpu.

* binning: identical bin matrix, num_bin, kept categories, missing type
  and default bin, with NaN, category 0, unseen, negative and fractional
  values;
* the split scan: ``best_split`` on the same integer-valued histograms
  (exact sums): feature, is_cat and the bins routed left identical, gains
  rtol 1e-6, over the max_cat_threshold / max_cat_group / smoothing knobs;
* end to end: the first tree's model text identical (its sums are exact);
  on the tests/test_categorical.py task raw predictions within 1e-4 after
  5 rounds.  On the Expo-shaped task the later trees are not compared:
  they see real-valued gradients whose f32 ``exp`` the two libraries
  round differently in the last bit, a categorical split sorts its bins
  by a ratio of such sums, and near-equal ratios then swap, so a later
  tree may take another category set.  There the held-out AUC is held to
  0.02;
* a JAX categorical booster carried across (raw scores rtol 1e-6), the
  model-file round trip, unseen / NaN / negative categories routed as the
  JAX package routes them, and valid-set scores equal to ``predict``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops.split import SplitConfig as JaxSplitConfig
from lightgbm_tpu.ops.split import best_split as jax_best_split
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops.split import (SplitConfig, best_split,
                                          cat_group_accept,
                                          cat_group_accept_plain,
                                          make_fused_ctx)

COMMON = dict(objective="binary", verbose=-1, enable_bundle=False,
              enable_bin_packing=False)
EXPO_CAT = chip_smoke.EXPO_CATEGORICAL


def _cat_data(n=4000, n_cat=30, seed=7):
    """The task of tests/test_categorical.py: one categorical column whose
    codes carry the label (code % 3 == 0), one numerical column."""
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, n_cat, n)
    num = rng.randn(n)
    logit = np.where(cat % 3 == 0, 2.0, -1.0) + 0.3 * rng.randn(n)
    y = (logit > 0).astype(np.float64)
    return np.stack([cat.astype(np.float64), num], axis=1), y


def _binning_data(n, seed):
    rng = np.random.default_rng(seed)
    x = np.empty((n, 6))
    x[:, 0] = rng.choice(21, n, p=np.r_[0.3, np.full(20, 0.035)])  # 0 common
    x[:, 1] = rng.integers(1, 9, n)
    x[rng.random(n) < 0.1, 1] = np.nan                    # NaN categories
    w = 1.0 / np.arange(1, 301) ** 1.3
    x[:, 2] = rng.choice(300, n, p=w / w.sum())           # long tail
    x[:, 3] = rng.standard_normal(n)                      # numerical
    x[:, 4] = rng.integers(0, 5, n) + 0.7                 # fractional codes
    x[:, 5] = rng.integers(0, 2, n) * 4.0                 # two categories
    y = (x[:, 0] % 3 == 0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("params", [{}, {"max_bin": 31},
                                    {"use_missing": False}])
def test_categorical_binning_matches_jax(params):
    x, y = _binning_data(4000, seed=len(params))
    cat = [0, 1, 2, 4, 5]
    p = dict(COMMON, **params)
    ref = lj.Dataset(x, y, categorical_feature=cat, params=p).construct()
    port = lt.Dataset(x, y, categorical_feature=cat,
                      params=dict(p, device="cpu")).construct()
    a, b = port.constructed, ref.constructed
    assert a.used_features == b.used_features
    np.testing.assert_array_equal(a.binned, b.binned)
    for j in range(x.shape[1]):
        ma, mb = a.bin_mappers[j], b.bin_mappers[j]
        assert (ma.bin_type, ma.is_trivial) == (mb.bin_type, mb.is_trivial)
        assert (ma.num_bin, ma.missing_type, ma.default_bin) == (
            mb.num_bin, mb.missing_type, mb.default_bin), j
        assert ma.bin_2_categorical == mb.bin_2_categorical, j
        assert ma.feature_info_str() == mb.feature_info_str(), j
    np.testing.assert_array_equal(
        a.feature_meta()["is_categorical"],
        [b.bin_mappers[j].bin_type == 1 for j in b.used_features])
    # unseen, NaN, negative, fractional and huge values bin alike
    probe = np.asarray([999.0, np.nan, -1.0, -0.5, 0.0, 2.7, 1e30, -np.inf,
                        np.inf, 4.0, 3.999])
    for j in cat:
        np.testing.assert_array_equal(
            a.bin_mappers[j].value_to_bin(probe),
            b.bin_mappers[j].value_to_bin(probe), err_msg=str(j))


def test_categorical_parameter_and_names_select_columns():
    x, y = _binning_data(2000, seed=3)
    p = dict(COMMON, device="cpu")
    by_index = lt.Dataset(x, y, categorical_feature=[0, 2],
                          params=p).construct().constructed
    by_param = lt.Dataset(x, y, params=dict(
        p, categorical_feature="0,2")).construct().constructed
    names = [f"f{i}" for i in range(6)]
    by_name = lt.Dataset(x, y, feature_name=names,
                         categorical_feature=["f0", "f2"],
                         params=p).construct().constructed
    for td in (by_param, by_name):
        np.testing.assert_array_equal(td.binned, by_index.binned)
        assert [m.bin_type for m in td.bin_mappers] == [
            m.bin_type for m in by_index.bin_mappers]
    assert by_index.bin_mappers[0].bin_type == 1
    assert by_index.bin_mappers[1].bin_type == 0


def test_column_past_256_bins_raises():
    """A categorical column keeps categories past max_bin until they cover
    99 % of the rows; past 256 bins that needs the uint16 matrix, which
    the port once refused.  It no longer raises: the same 600-category
    column bins into the JAX package's uint16 matrix, and trees grown
    under integer-valued gradients (exact sums) give the JAX package's
    model text."""
    n = 6000
    cat = np.arange(n, dtype=np.float64) % 600
    num = np.random.default_rng(3).standard_normal(n)
    x = np.stack([cat, num], axis=1)
    y = ((cat % 7 < 3) ^ (num > 1.0)).astype(np.float32)
    p = dict(COMMON, num_leaves=15, min_data_in_leaf=5)
    ref = lj.Dataset(x, y, categorical_feature=[0], params=p)
    port = lt.Dataset(x, y, categorical_feature=[0],
                      params=dict(p, device="cpu"))
    a, b = port.construct().constructed, ref.construct().constructed
    assert a.bin_mappers[0].num_bin == b.bin_mappers[0].num_bin > 256
    assert a.binned.dtype == np.asarray(b.binned).dtype == np.uint16
    np.testing.assert_array_equal(a.binned, b.binned)

    def fobj(seed):
        calls = [0]

        def f(preds, data):
            rng = np.random.default_rng(seed + calls[0])
            calls[0] += 1
            return (rng.integers(-3, 4, len(preds)).astype(np.float64),
                    rng.integers(1, 4, len(preds)).astype(np.float64))
        return f
    bj = lj.train(p, ref, 3, fobj=fobj(5), verbose_eval=False)
    bt = lt.train(dict(p, device="cpu"), port, 3, fobj=fobj(5),
                  verbose_eval=False)
    assert sum(t.num_cat for t in bt.inner.models) > 0
    assert bt.model_to_string() == bj.model_to_string()


# ---------------------------------------------------------------- the scan

B = 48


def _hist(seed):
    """Integer-valued [F, B, 3] histogram of 3000 rows over 6 features, 4
    of them categorical; every feature's column sums to the parent."""
    rng = np.random.default_rng(seed)
    n = 3000
    num_bin = np.asarray([40, 12, 48, 30, 6, 48], np.int32)
    is_cat = np.asarray([True, True, False, True, True, False])
    missing = np.asarray([0, 1, 2, 2, 0, 0], np.int32)
    default_bin = np.where(is_cat, 0, 7).astype(np.int32)
    bins = np.stack([rng.integers(0, nb, n) for nb in num_bin], 1)
    effect = rng.integers(-3, 4, 64)
    g = (rng.integers(-2, 3, n) + effect[bins[:, 0]]
         - 2 * (bins[:, 3] % 4 == 1)).astype(np.float32)
    h = rng.integers(1, 4, n).astype(np.float32)
    hist = np.zeros((len(num_bin), B, 3), np.float32)
    for f in range(len(num_bin)):
        for k, w in enumerate((g, h, np.ones(n, np.float32))):
            np.add.at(hist[f, :, k], bins[:, f], w)
    return hist, num_bin, missing, default_bin, is_cat, (
        np.float32(g.sum()), np.float32(h.sum()), np.float32(n))


SCAN_CASES = [
    dict(),
    dict(max_cat_threshold=4),
    dict(max_cat_group=2),
    dict(max_cat_group=1000),
    dict(cat_smooth_ratio=0.5, min_cat_smooth=1.0, max_cat_smooth=20.0),
    dict(min_data_in_leaf=200, min_sum_hessian_in_leaf=50.0),
    dict(lambda_l1=2.0, lambda_l2=3.0, min_gain_to_split=1.0),
    dict(min_data_in_leaf=3000),                         # nothing splits
    dict(max_cat_threshold=1),                           # one position
]


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_categorical_scan_matches_jax(case, seed):
    hist, nb, mt, db, ic, (pg, ph, pc) = _hist(seed * 10 + len(case))
    valid = np.ones(len(nb), bool)
    valid[4] = seed == 0                          # a pruned feature
    kw = dict(dict(min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3),
              **case)
    jcfg = JaxSplitConfig(has_categorical=True, split_find="fused", **kw)
    jres, jok = jax_best_split(
        jnp.asarray(hist), jnp.float32(pg), jnp.float32(ph),
        jnp.float32(pc), jnp.asarray(nb), jnp.asarray(mt), jnp.asarray(db),
        jnp.asarray(valid), jcfg, is_cat=jnp.asarray(ic), with_feat_ok=True)
    tcfg = SplitConfig(has_categorical=True, **kw)
    t = torch.from_numpy
    ctx = make_fused_ctx(t(nb), t(mt), t(db), B, tcfg, t(ic))
    tres, tok = best_split(t(hist)[None], torch.tensor([pg]),
                           torch.tensor([ph]), torch.tensor([pc]),
                           t(valid)[None], tcfg, ctx)
    for name in ("found", "feature", "threshold", "default_left", "is_cat"):
        assert int(getattr(tres, name)[0]) == int(getattr(jres, name)), name
    np.testing.assert_array_equal(tres.cat_bins[0].numpy(),
                                  np.asarray(jres.cat_bins))
    np.testing.assert_array_equal(tok[0].numpy(), np.asarray(jok))
    for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                 "right_sum_g", "right_sum_h", "right_count",
                 "left_output", "right_output"):
        np.testing.assert_allclose(getattr(tres, name)[0].numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-6, err_msg=name)
    if case.get("min_data_in_leaf") == 3000:
        assert not bool(tres.found[0])
    elif not case:
        assert bool(tres.is_cat[0])


def test_categorical_scan_batched_and_cpu_takes_plain_loop():
    """Both children in one call equal their single scans, and the CPU
    path runs the plain group loop without a kernel launch."""
    h1, nb, mt, db, ic, p1 = _hist(5)
    h2, _, _, _, _, p2 = _hist(6)
    t = torch.from_numpy
    cfg = SplitConfig(has_categorical=True)
    ctx = make_fused_ctx(t(nb), t(mt), t(db), B, cfg, t(ic))
    valid = torch.ones((2, len(nb)), dtype=torch.bool)
    before = cat_group_accept.launches
    pair, _ = best_split(torch.stack([t(h1), t(h2)]),
                         torch.tensor([p1[0], p2[0]]),
                         torch.tensor([p1[1], p2[1]]),
                         torch.tensor([p1[2], p2[2]]), valid, cfg, ctx)
    for k, (h, p) in enumerate(((h1, p1), (h2, p2))):
        one, _ = best_split(t(h)[None], *(torch.tensor([v]) for v in p),
                            valid[:1], cfg, ctx)
        for a, b in zip(pair, one):
            assert torch.equal(a[k], b[0])
    assert cat_group_accept.launches == before


def _group_inputs(seed, shape=(2, 6, 2, 40)):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    return (t(rng.poisson(30.0, shape).astype(np.float32)),
            t(rng.random(shape) < 0.8),
            t(rng.integers(0, 5000, shape).astype(np.float32)),
            t(np.maximum(1.0, np.floor(rng.integers(1, 5000, shape[:-1])
                                       / 8.0)).astype(np.float32)))


def _scalar_accepts(step, ok, rc, m0, max_cat_group):
    """The reference's accounting written out one lane at a time
    (feature_histogram.hpp:142-147,169-177), in float32; ``m0``
    broadcasts over the lanes as numpy broadcasts it."""
    s, o, r = (a.numpy() for a in (step, ok, rc))
    m = np.broadcast_to(m0.numpy(), o.shape[:-1])
    out = np.zeros(o.shape, bool)
    for lane in np.ndindex(o.shape[:-1]):
        cnt, rest, mdpg = np.float32(0), np.float32(max_cat_group), m[lane]
        for j in range(o.shape[-1]):
            cnt = np.float32(cnt + s[lane][j])
            acc = bool(o[lane][j]) and cnt >= mdpg
            out[lane][j] = acc
            if acc:
                rest = np.float32(rest - 1)
                if rest > 0:
                    mdpg = np.float32(max(1.0, np.floor(
                        np.float32(r[lane][j] / max(rest, np.float32(1))))))
                cnt = np.float32(0)
    return out


def test_group_loop_matches_scalar_reference():
    """The plain group loop equals the reference's accounting written out
    one lane at a time."""
    step, ok, rc, m0 = _group_inputs(3)
    got = cat_group_accept_plain(step, ok, rc, m0, 8).numpy()
    np.testing.assert_array_equal(got, _scalar_accepts(step, ok, rc, m0, 8))


def _group_edge_case(case):
    """Inputs of the group loop at its edges: one position (T = 1), no
    position ok, 42 lanes (not a multiple of a kernel block's lanes), 300
    positions (past one 256-position chunk) and one minimum group size a
    leaf (``[K, 1, 1]``, the form the split scan passes)."""
    if case == "one_position":
        return _group_inputs(4, (2, 6, 2, 1))
    if case == "42_lanes":
        return _group_inputs(6, (3, 7, 2, 40))
    if case == "300_positions":
        return _group_inputs(7, (1, 3, 2, 300))
    step, ok, rc, m0 = _group_inputs(5, (3, 5, 2, 37))
    if case == "all_false":
        return step, torch.zeros_like(ok), rc, m0
    return step, ok, rc, m0[:, :1, :1].contiguous()


GROUP_EDGE_CASES = ["one_position", "all_false", "42_lanes",
                    "300_positions", "mdpg0_per_leaf"]


@pytest.mark.parametrize("case", GROUP_EDGE_CASES)
def test_group_loop_edge_cases(case):
    """bool in, bool out, equal to the scalar accounting."""
    step, ok, rc, m0 = _group_edge_case(case)
    got = cat_group_accept_plain(step, ok, rc, m0, 4)
    assert got.dtype == torch.bool and got.shape == ok.shape
    np.testing.assert_array_equal(got.numpy(),
                                  _scalar_accepts(step, ok, rc, m0, 4))
    if case == "all_false":
        assert not got.any()


@pytest.mark.gpu
def test_group_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "at the main path's shapes")
    cases = [_group_inputs(seed, (2, 8, 2, 255)) for seed in range(3)]
    cases += [_group_edge_case(c) for c in GROUP_EDGE_CASES]
    for args in cases:
        args = [a.cuda() for a in args]
        k = cat_group_accept(*args, 64)
        p = cat_group_accept_plain(*args, 64)
        torch.cuda.synchronize()
        assert k.dtype == torch.bool and torch.equal(k, p)


# ---------------------------------------------------------------- end to end

def _first_split_tree(model_str):
    body = model_str.split("\nfeature importances:")[0]
    return next("Tree=" + b for b in body.split("Tree=")[1:]
                if "num_leaves=1\n" not in b)


@pytest.fixture(scope="module")
def cat_task():
    x, y = _cat_data(seed=13)
    xt, yt, xv, yv = x[:3000], y[:3000], x[3000:], y[3000:]
    params = dict(COMMON, num_leaves=15, metric="binary_logloss")
    dj = lj.Dataset(xt, yt, categorical_feature=[0], params=params)
    bj = lj.train(params, dj, 5)
    tp = dict(params, device="cpu", partition_impl="compact",
              ordered_bins="on")
    ev = {}
    dt = lt.Dataset(xt, yt, categorical_feature=[0], params=tp)
    bt = lt.train(tp, dt, 5, valid_sets=[lt.Dataset(xv, yv, reference=dt)],
                  evals_result=ev, verbose_eval=False)
    return xt, yt, xv, yv, dj, bj, bt, ev


def test_cat_task_first_tree_identical_and_predictions_close(cat_task):
    xt, _, xv, _, _, bj, bt, _ = cat_task
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert st.split("Tree=")[0] == sj.split("Tree=")[0]     # header
    assert _first_split_tree(st) == _first_split_tree(sj)
    assert "num_cat=0" not in _first_split_tree(st)
    for data in (xt, xv):
        np.testing.assert_allclose(bt.predict(data, raw_score=True),
                                   bj.predict(data, raw_score=True),
                                   rtol=0, atol=1e-4)


def test_valid_scores_match_predict(cat_task):
    """The valid set is scored through the binned categorical route on the
    device; it must equal ``predict`` on the raw rows."""
    _, _, xv, yv, _, _, bt, ev = cat_task
    p = np.clip(bt.predict(xv), 1e-15, 1 - 1e-15)
    loss = float(-np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p)))
    assert ev["valid_0"]["binary_logloss"][-1] == pytest.approx(loss,
                                                                abs=1e-5)


def test_expo_like_first_tree_identical():
    x, y = chip_smoke.expo_like(6000, np.random.default_rng(5))
    xt, yt, xv, yv = x[:5000], y[:5000], x[5000:], y[5000:]
    params = dict(COMMON, num_leaves=63)
    bj = lj.train(params, lj.Dataset(xt, yt, categorical_feature=EXPO_CAT,
                                     params=params), 5)
    tp = dict(params, device="cpu", partition_impl="compact",
              ordered_bins="on", categorical_feature=EXPO_CAT)
    bt = lt.train(tp, lt.Dataset(xt, yt, params=tp), 5)
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert st.split("Tree=")[0] == sj.split("Tree=")[0]
    assert _first_split_tree(st) == _first_split_tree(sj)
    assert sum(t.num_cat for t in bt.inner.models) > 0
    auc_t = chip_smoke.auc(bt.predict(xv), yv)
    auc_j = chip_smoke.auc(bj.predict(xv), yv)
    assert auc_t > 0.6 and abs(auc_t - auc_j) < 0.02


def test_jax_categorical_booster_carried_across(cat_task):
    _, _, xv, _, _, bj, _, _ = cat_task
    want = bj.predict(xv, raw_score=True)
    by_text = convert.booster_from_arrays(model_str=bj.model_to_string(),
                                          params={"device": "cpu"})
    np.testing.assert_allclose(by_text.predict(xv, raw_score=True), want,
                               rtol=1e-6, atol=1e-12)
    trees = [{k: getattr(t, k) for k in (
        "num_leaves", "num_cat", "split_feature", "split_gain", "threshold",
        "decision_type", "left_child", "right_child", "leaf_parent",
        "leaf_value", "leaf_count", "internal_value", "internal_count",
        "cat_boundaries", "cat_threshold", "shrinkage")}
        for t in bj.inner.models]
    by_fields = convert.booster_from_arrays(
        trees=trees, objective=bj.inner.objective.to_string(),
        max_feature_idx=1, params={"device": "cpu"})
    np.testing.assert_allclose(by_fields.predict(xv, raw_score=True), want,
                               rtol=1e-6, atol=1e-12)


def test_jax_categorical_dataset_carried_across(cat_task):
    _, _, _, _, dj, bj, _, _ = cat_task
    td = dj.constructed
    used = td.used_features
    mappers = [td.bin_mappers[j] for j in used]
    ds = convert.dataset_from_arrays(
        td.binned, [m.num_bin for m in mappers],
        [m.missing_type for m in mappers], [m.default_bin for m in mappers],
        [m.bin_upper_bound for m in mappers], td.metadata.label,
        used_features=used, num_total_features=td.num_total_features,
        min_max=[(m.min_val, m.max_val) for m in mappers],
        bin_2_categorical=[m.bin_2_categorical for m in mappers],
        params={"device": "cpu"})
    bt = lt.train(dict(COMMON, num_leaves=15, device="cpu"), ds, 1)
    assert (_first_split_tree(bt.model_to_string())
            == _first_split_tree(bj.model_to_string()))


def test_save_load_round_trip(cat_task, tmp_path):
    _, _, xv, _, _, _, bt, _ = cat_task
    path = tmp_path / "cat_model.txt"
    bt.save_model(str(path))
    loaded = lt.Booster(model_file=str(path), params={"device": "cpu"})
    assert loaded.model_to_string() == bt.model_to_string()
    np.testing.assert_array_equal(loaded.predict(xv, raw_score=True),
                                  bt.predict(xv, raw_score=True))
    jb = lj.Booster(model_file=str(path))
    np.testing.assert_allclose(jb.predict(xv, raw_score=True),
                               bt.predict(xv, raw_score=True), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("nan_in_training", [False, True])
def test_unseen_nan_and_negative_categories_route_as_jax(nan_in_training):
    """CategoricalDecision (tree.h:268-283): negative and unseen categories
    go right, NaN goes right when the column's missing type is NaN (and
    reads as category 0 otherwise), as the JAX package routes them."""
    x, y = _cat_data(seed=5)
    if nan_in_training:
        x[::17, 0] = np.nan
    params = dict(COMMON, num_leaves=8)
    bj = lj.train(params, lj.Dataset(x, y, categorical_feature=[0],
                                     params=params), 5)
    bt = lt.Booster(model_str=bj.model_to_string(), params={"device": "cpu"})
    probe = np.repeat(x[:6], 8, axis=0)
    probe[:, 0] = np.tile([999.0, np.nan, -1.0, 1e6, -0.5, 3.0, 31.0, 0.0],
                          6)
    np.testing.assert_allclose(bt.predict(probe, raw_score=True),
                               bj.predict(probe, raw_score=True),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("missing_type", [0, 2])
def test_categorical_decision_on_raw_values(missing_type):
    """A hand-made stump with categories {0, 3} left: unseen, negative and
    large values go right; a fraction truncates toward zero (-0.5 is 0);
    NaN goes right under NaN missing handling and reads as category 0
    otherwise."""
    stump = dict(num_leaves=2, num_cat=1, split_feature=[0],
                 threshold=[0.0], decision_type=[1 | (missing_type << 2)],
                 left_child=[~0], right_child=[~1], leaf_value=[1.0, -1.0],
                 cat_boundaries=[0, 1], cat_threshold=[(1 << 0) | (1 << 3)])
    bst = convert.booster_from_arrays(trees=[stump], objective="binary",
                                      max_feature_idx=1,
                                      params={"device": "cpu"})
    vals = [3.0, 0.0, -0.5, 3.9, 999.0, -1.0, 1e6, 4.0, np.nan]
    x = np.stack([vals, np.zeros(len(vals))], 1)
    nan_side = -1.0 if missing_type == 2 else 1.0
    np.testing.assert_array_equal(
        bst.predict(x, raw_score=True),
        [1, 1, 1, 1, -1, -1, -1, -1, nan_side])
