"""Row and feature sampling and the boosting variants of the port
(bagging in both regimes, ``feature_fraction``, GOSS, DART, RF) against
lightgbm_tpu on the same seeded data.

Sampling decisions compare exactly: the same bag rows, the same 0/1 bag
weights, the same feature mask per tree, the same GOSS kept rows and
weights, the same DART drop sets and tree weights.  Trees compare exactly
where their sums are exact: a custom objective hands both packages the
same integer-valued gradients and hessians (seeded per iteration), so every
histogram sum is exact in any order and the model text is identical,
DART's normalised trees included (both shrink the same float64 host
trees).  Under the built-in objective the first tree is identical (binary
gradients +-0.5 and hessians 0.25 at score 0) and the raw predictions
agree within 1e-4 after 5 rounds, as in ``test_torch_engine``.  The
training scores a bagged tree leaves (its out-of-bag rows routed through
it) equal ``predict(raw_score=True)`` within 1e-5."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

N, F = 2048, 10
BASE = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
            verbose=-1, enable_bundle=False, enable_bin_packing=False)


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, F))
    z = x[:, 0] + 0.5 * x[:, 1] - 0.3 * x[:, 2] * x[:, 3]
    y = (z + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    return x, y


def _int_fobj(seed):
    """A custom objective of integer-valued gradients and hessians, the
    same sequence in every package: exact sums in any order."""
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(seed + calls[0])
        calls[0] += 1
        n = len(preds)
        g = rng.integers(-3, 4, n).astype(np.float64)
        h = rng.integers(1, 4, n).astype(np.float64)
        return g, h
    return fobj


def _record_masks(inner):
    """Wrap a booster's per-tree feature draw to record each mask."""
    masks = []
    draw = inner._feature_sample

    def wrapped():
        m = np.asarray(draw())
        masks.append(m.copy())
        return m
    inner._feature_sample = wrapped
    return masks


def _jax_bag(inner):
    """The JAX booster's current bag: (sorted rows, their weights) in the
    subset regime, else (None, the weight vector)."""
    st = inner._subset_state
    if st is not None:
        w = np.asarray(st[2])
        m = int((w > 0).sum())
        return np.asarray(st[1])[:m], w[:m]
    return None, np.asarray(inner._bag_weight)


def _port_bag(inner):
    if inner._subset is not None:
        rows, w = inner._subset
        rows = rows.numpy()
        return rows, w.numpy()[rows]
    w = inner._bag_weight
    return None, (np.ones(inner.num_data, np.float32) if w is None
                  else w.numpy())


def _step_both(params, rounds, x, y, fobj_seed=None, each=None):
    """Both packages' boosters stepped together, ``each(i, bj, bt)`` after
    iteration i; returns the boosters and the recorded feature masks."""
    bj = lj.Booster(params=params, train_set=lj.Dataset(x, y, params=params))
    tp = dict(params, device="cpu")
    bt = lt.Booster(params=tp, train_set=lt.Dataset(x, y, params=tp))
    masks = (_record_masks(bj.inner), _record_masks(bt.inner))
    fobj = ((None, None) if fobj_seed is None
            else (_int_fobj(fobj_seed), _int_fobj(fobj_seed)))
    for i in range(rounds):
        bj.update(fobj=fobj[0])
        bt.update(fobj=fobj[1])
        if each is not None:
            each(i, bj, bt)
    return bj, bt, masks


def _assert_same_bags(i, bj, bt):
    rj, wj = _jax_bag(bj.inner)
    rt, wt = _port_bag(bt.inner)
    assert (rj is None) == (rt is None), i
    if rj is not None:
        np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(wt, wj)


def _assert_same_model(bj, bt):
    assert bt.model_to_string() == bj.model_to_string()


@pytest.mark.parametrize("fraction,freq,regime", [
    (0.5, 1, "subset"), (0.3, 2, "subset"), (0.8, 1, "mask"),
    (0.7, 3, "mask")])
def test_bagging_rows_and_trees_match_jax(fraction, freq, regime):
    """The same bag every iteration in both regimes (a subset at fractions
    up to 0.5 on the serial learner, Bernoulli weights above), and the same
    trees on it."""
    x, y = _data(1)
    p = dict(BASE, bagging_fraction=fraction, bagging_freq=freq)

    def each(i, bj, bt):
        _assert_same_bags(i, bj, bt)
        assert (bt.inner._subset is not None) == (regime == "subset")
    bj, bt, _ = _step_both(p, 4, x, y, fobj_seed=3, each=each)
    _assert_same_model(bj, bt)


@pytest.mark.parametrize("fraction", [0.5, 0.8])
def test_bagged_training_scores_equal_predict(fraction):
    """Out-of-bag rows are scored: the training scores the loop kept equal
    the model's raw predictions of the training rows."""
    x, y = _data(2)
    p = dict(BASE, bagging_fraction=fraction, bagging_freq=1, device="cpu")
    bt = lt.train(p, lt.Dataset(x, y, params=p), 5, verbose_eval=False)
    np.testing.assert_allclose(bt.inner.scores[0].double().numpy(),
                               bt.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)


def test_bagging_under_builtin_objective_close_to_jax():
    x, y = _data(3)
    p = dict(BASE, bagging_fraction=0.5, bagging_freq=1,
             feature_fraction=0.7)
    bj = lj.train(p, lj.Dataset(x, y, params=p), 5, verbose_eval=False)
    tp = dict(p, device="cpu")
    bt = lt.train(tp, lt.Dataset(x, y, params=tp), 5, verbose_eval=False)
    first = lambda s: s.split("Tree=")[1]
    assert first(bt.model_to_string()) == first(bj.model_to_string())
    np.testing.assert_allclose(bt.predict(x, raw_score=True),
                               bj.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)


def test_bagging_switched_off_mid_training():
    """``reset_parameter`` turns bagging off at round 3: every row weighs 1
    again, as in the JAX package (boosting.py:1147-1154)."""
    x, y = _data(4)
    p = dict(BASE, bagging_fraction=0.5, bagging_freq=1)
    fracs = [0.5, 0.5, 1.0, 1.0]
    out = {}
    for pkg, params in ((lj, p), (lt, dict(p, device="cpu"))):
        out[pkg] = pkg.train(
            params, pkg.Dataset(x, y, params=params), 4, fobj=_int_fobj(5),
            callbacks=[pkg.callback.reset_parameter(bagging_fraction=fracs)
                       if pkg is lj else
                       lt.reset_parameter(bagging_fraction=fracs)],
            verbose_eval=False)
    bt = out[lt]
    assert bt.inner._subset is None and bt.inner._bag_weight is None
    assert not bt.inner._bagging_on
    _assert_same_model(out[lj], bt)


@pytest.mark.parametrize("fraction", [0.3, 0.6, 0.9])
def test_feature_masks_match_jax(fraction):
    """The same mask every tree, and every split inside its tree's mask."""
    x, y = _data(5)
    p = dict(BASE, feature_fraction=fraction, feature_fraction_seed=7)
    bj, bt, (mj, mt) = _step_both(p, 4, x, y, fobj_seed=9)
    assert len(mt) == len(mj) == 4
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, b)
        assert a.sum() == max(1, int(F * fraction))
    for tree, mask in zip(bt.inner.models, mt):
        feats = tree.split_feature[:tree.num_leaves - 1]
        assert mask[feats].all()
    _assert_same_model(bj, bt)


def test_feature_masks_per_class_tree():
    """K trees a round draw K masks, class by class."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((900, F))
    y = rng.integers(0, 3, 900).astype(np.float32)
    p = dict(BASE, objective="multiclass", num_class=3,
             feature_fraction=0.5)
    bj, bt, (mj, mt) = _step_both(p, 2, x, y)
    assert len(mt) == 6
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, b)


def test_feature_mask_is_one_device_tensor():
    """Each tree's mask is copied into the one tensor the growers read
    (a captured split step holds its address)."""
    x, y = _data(7)
    p = dict(BASE, feature_fraction=0.5, device="cpu")
    bt = lt.Booster(params=p, train_set=lt.Dataset(x, y, params=p))
    ptr = bt.inner._feat_valid.data_ptr()
    seen = []
    for _ in range(3):
        bt.update()
        assert bt.inner._feat_valid.data_ptr() == ptr
        seen.append(bt.inner._feat_valid.clone())
    assert not all(torch.equal(seen[0], s) for s in seen[1:])


@pytest.mark.parametrize("top,other", [(0.2, 0.1), (0.3, 0.3)])
def test_goss_sample_in_isolation(top, other):
    """The same g, h into both packages' ``_sample``: the same kept rows
    and weights (the subset regime at top + other <= 0.5), twice in a row
    from the one random stream."""
    x, y = _data(8)
    p = dict(BASE, boosting_type="goss", top_rate=top, other_rate=other,
             learning_rate=0.5)
    bj = lj.Booster(params=p, train_set=lj.Dataset(x, y, params=p))
    tp = dict(p, device="cpu")
    bt = lt.Booster(params=tp, train_set=lt.Dataset(x, y, params=tp))
    rng = np.random.default_rng(9)
    for it in (0, 2, 3):        # 0 is inside the warm-up of int(1 / 0.5)
        g = rng.standard_normal((1, N)).astype(np.float32)
        h = rng.uniform(0.1, 1.0, (1, N)).astype(np.float32)
        _, _, cj = bj.inner._sample(it, jnp.asarray(g), jnp.asarray(h))
        _, _, ct = bt.inner._sample(it, torch.from_numpy(g),
                                    torch.from_numpy(h))
        _assert_same_bags(it, bj, bt)
        if it == 0:
            assert bt.inner._subset is None and bt.inner._bag_weight is None
            continue
        assert (bt.inner._subset is not None) == (top + other <= 0.5)
        if bt.inner._subset is None:
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        kept = (bt.inner._bag_cnt.numpy() > 0).sum()
        assert kept >= int(N * top)
    assert bt.inner.stats["sample_host_reads"] == 2


@pytest.mark.parametrize("top,other", [(0.2, 0.1), (0.4, 0.3)])
def test_goss_trees_match_jax(top, other):
    """2,000 rows: the other rows' weight (N - top_k) / other_k is 8 and 2,
    so the weighted integer gradients stay exact."""
    x, y = _data(10, 2000)
    p = dict(BASE, boosting_type="goss", top_rate=top, other_rate=other,
             learning_rate=0.5)
    bj, bt, _ = _step_both(p, 5, x, y, fobj_seed=11, each=_assert_same_bags)
    _assert_same_model(bj, bt)


def test_goss_builtin_objective_close_to_jax():
    """Real-valued gradients: trees may part where a gradient at the top-k
    threshold differs by an ulp, so the raw scores are held to 1e-3."""
    x, y = _data(12)
    p = dict(BASE, boosting_type="goss", learning_rate=0.5)
    bj = lj.train(p, lj.Dataset(x, y, params=p), 5, verbose_eval=False)
    tp = dict(p, device="cpu")
    bt = lt.train(tp, lt.Dataset(x, y, params=tp), 5, verbose_eval=False)
    np.testing.assert_allclose(bt.predict(x, raw_score=True),
                               bj.predict(x, raw_score=True), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(bt.inner.scores[0].double().numpy(),
                               bt.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("extra", [
    {}, {"xgboost_dart_mode": True}, {"uniform_drop": True},
    {"uniform_drop": True, "max_drop": 2}])
def test_dart_drops_and_trees_match_jax(extra):
    x, y = _data(13)
    p = dict(BASE, boosting_type="dart", drop_rate=0.4, skip_drop=0.2,
             **extra)

    dropped = []

    def each(i, bj, bt):
        assert bt.inner._drop_index == bj.inner._drop_index, i
        assert bt.inner.tree_weight == bj.inner.tree_weight
        assert bt.inner.sum_weight == bj.inner.sum_weight
        dropped.append(len(bt.inner._drop_index))
    bj, bt, _ = _step_both(p, 6, x, y, fobj_seed=14, each=each)
    assert sum(dropped) > 0
    _assert_same_model(bj, bt)


def test_dart_scores_equal_predict_and_jax():
    """The training and valid scores the loop keeps equal the normalised
    model's predictions, and the JAX package's scores."""
    x, y = _data(15)
    xv, yv = _data(16, 500)
    p = dict(BASE, boosting_type="dart", drop_rate=0.5, skip_drop=0.0)
    dj = lj.Dataset(x, y, params=p)
    bj = lj.train(p, dj, 6, valid_sets=[lj.Dataset(xv, yv, reference=dj)],
                  verbose_eval=False)
    tp = dict(p, device="cpu")
    dt = lt.Dataset(x, y, params=tp)
    bt = lt.train(tp, dt, 6, valid_sets=[lt.Dataset(xv, yv, reference=dt)],
                  verbose_eval=False)
    assert bt.inner.tree_weight == bj.inner.tree_weight
    assert bt.inner.tree_weight != [0.1] * 6     # some iteration dropped
    np.testing.assert_allclose(bt.inner.scores[0].double().numpy(),
                               bt.predict(x, raw_score=True), atol=1e-5)
    np.testing.assert_allclose(
        bt.inner.valid_sets[0].scores[0].double().numpy(),
        bt.predict(xv, raw_score=True), atol=1e-5)
    np.testing.assert_allclose(bt.predict(xv, raw_score=True),
                               bj.predict(xv, raw_score=True), atol=1e-4)


def test_rf_model_text_round_trip(tmp_path):
    """RF: the same trees as the JAX package (gradients once, from the zero
    score: exact), ``average_output`` written, loaded by both packages,
    averaged predictions identical after the round trip."""
    x, y = _data(17)
    p = dict(BASE, boosting_type="rf", bagging_fraction=0.5,
             bagging_freq=1, feature_fraction=0.6,
             metric=["binary_logloss"])
    dj = lj.Dataset(x, y, params=p)
    ev_j, ev_t = {}, {}
    bj = lj.train(p, dj, 5, valid_sets=[dj], evals_result=ev_j,
                  verbose_eval=False)
    tp = dict(p, device="cpu")
    dt = lt.Dataset(x, y, params=tp)
    bt = lt.train(tp, dt, 5, valid_sets=[dt], evals_result=ev_t,
                  verbose_eval=False)
    st = bt.model_to_string()
    assert "\naverage_output\n" in st
    assert st == bj.model_to_string()
    np.testing.assert_allclose(ev_t["valid_0"]["binary_logloss"],
                               ev_j["valid_0"]["binary_logloss"], atol=1e-6)
    path = str(tmp_path / "rf.txt")
    bt.save_model(path)
    loaded = lt.Booster(model_file=path, params={"device": "cpu"})
    assert loaded.inner.average_output
    assert loaded.model_to_string() == st
    np.testing.assert_array_equal(loaded.predict(x), bt.predict(x))
    np.testing.assert_allclose(bt.predict(x), bj.predict(x), rtol=1e-12)
    np.testing.assert_allclose(lj.Booster(model_file=path).predict(x),
                               bt.predict(x), rtol=1e-12)
    # averaged: the transformed output is the raw sum over the iterations
    np.testing.assert_allclose(bt.predict(x),
                               bt.predict(x, raw_score=True) / 5, rtol=1e-12)


@pytest.mark.parametrize("params,message", [
    ({"boosting_type": "rf"}, "Random forest needs bagging"),
    ({"boosting_type": "rf", "bagging_freq": 1, "bagging_fraction": 1.0},
     "Random forest needs bagging"),
    ({"boosting_type": "boosted"}, "Unknown boosting type"),
])
def test_boosting_type_checked_as_jax(params, message):
    x, y = _data(18, 200)
    p = dict(BASE, device="cpu", **params)
    with pytest.raises(RuntimeError, match=message):
        lt.train(p, lt.Dataset(x, y, params=p), 1)


def test_data_parallel_takes_the_mask_regime():
    """The data-parallel learner bags by weights at any fraction, as the
    JAX package's (``_can_subset = not use_dist``): at 0.8 its trees equal
    the serial learner's on the same bag; at 0.5 it keeps no subset."""
    x, y = _data(19)
    serial = dict(BASE, bagging_fraction=0.8, bagging_freq=1,
                  feature_fraction=0.7, device="cpu")
    dp = dict(serial, tree_learner="data", mesh_devices=2, mesh_shape="2x1")
    out = {}
    for name, p in (("serial", serial), ("dp", dp)):
        out[name] = lt.train(p, lt.Dataset(x, y, params=p), 3,
                             fobj=_int_fobj(20), verbose_eval=False)
    assert out["dp"].inner._gspmd is not None
    assert out["dp"].model_to_string() == out["serial"].model_to_string()
    half = dict(dp, bagging_fraction=0.5)
    b = lt.train(half, lt.Dataset(x, y, params=half), 2, verbose_eval=False)
    assert b.inner._subset is None and b.inner._bag_weight is not None
    np.testing.assert_allclose(b.inner.scores[0].double().numpy(),
                               b.predict(x, raw_score=True), atol=1e-5)


def test_dart_categorical_scores_equal_predict():
    """DART's re-scoring of dropped trees routes categorical nodes by
    their bins: with two categorical columns the scores the loop keeps,
    after drops and an arithmetic rollback, equal the predictions."""
    rng = np.random.default_rng(21)
    x, _ = _data(21)
    x[:, 0] = rng.integers(0, 12, N)
    x[:, 1] = rng.integers(0, 40, N)
    y = ((x[:, 0] % 3 == 0) ^ (x[:, 1] > 25) ^ (x[:, 2] > 0.5)).astype(
        np.float32)
    p = dict(BASE, boosting_type="dart", drop_rate=0.5, skip_drop=0.0,
             categorical_feature=[0, 1], device="cpu")
    bt = lt.train(p, lt.Dataset(x, y, params=p), 6, verbose_eval=False)
    assert sum(t.num_cat for t in bt.inner.models) > 0
    assert bt.inner.tree_weight != [0.1] * 6
    np.testing.assert_allclose(bt.inner.scores[0].double().numpy(),
                               bt.predict(x, raw_score=True), atol=1e-5)
    bt.rollback_one_iter()
    np.testing.assert_allclose(bt.inner.scores[0].double().numpy(),
                               bt.predict(x, raw_score=True), atol=1e-5)
