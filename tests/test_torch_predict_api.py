"""The port's prediction breadth against lightgbm_tpu: leaf indices,
margin early stopping, TreeSHAP contributions and ``pred_parameter``.

Each model is trained by the JAX package and loaded into the port from
its model text, and, for the cases a custom objective can train, also
trained by the port under integer-valued gradients (whose trees are the
JAX package's exactly).  Tolerances: leaf indices and early-stopped
scores are equal exactly (the port replays the JAX package's float64
margin loop); contributions agree within 1e-12 x (1 + |value|) and each
row's sum equals its raw score within 1e-9 x (1 + |raw|)."""
import functools

import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs import model_quality as mq

N, F = 1200, 6
BASE = dict(num_leaves=15, min_data_in_leaf=5, verbose=-1)
CASES = ["numerical", "nan", "zero_missing", "categorical", "multiclass",
         "rf", "boost_from_average"]


def _data(case, seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, F))
    x[:, 3] = rng.integers(0, 12, n)
    if case in ("nan", "categorical"):
        x[rng.random((n, F)) < 0.06] = np.nan
    if case == "zero_missing":
        x[rng.random((n, F)) < 0.15] = 0.0
    signal = (np.nan_to_num(x[:, 0]) - 0.8 * np.nan_to_num(x[:, 1])
              + 0.6 * np.isin(x[:, 3], (2, 5, 7, 11))
              + 0.4 * rng.standard_normal(n))
    if case == "multiclass":
        y = np.digitize(signal, [-0.8, 0.0, 0.8]).astype(np.float32)
    elif case == "boost_from_average":
        y = (signal + 3.0).astype(np.float32)
    else:
        y = (signal > 0).astype(np.float32)
    return x, y


def _params(case):
    p = dict(BASE, objective="binary")
    if case == "zero_missing":
        p["zero_as_missing"] = True
    if case == "categorical":
        p["categorical_feature"] = "3"
    if case == "multiclass":
        p.update(objective="multiclass", num_class=4)
    if case == "rf":
        p.update(boosting_type="rf", bagging_freq=1, bagging_fraction=0.6,
                 feature_fraction=0.8)
    if case == "boost_from_average":
        p["objective"] = "regression"
    return p


def _rows(case, x):
    """Rows to predict: held-out rows, and for categorical nodes negative,
    unseen and NaN categories, which go right."""
    rows = _data(case, seed=1, n=400)[0]
    if case == "categorical":
        rows[:30, 3] = [-1, 12, 40, np.nan, 3.7, -0.5] * 5
    return rows


@functools.lru_cache(maxsize=None)
def _jax_model(case):
    x, y = _data(case)
    p = _params(case)
    cat = [3] if case == "categorical" else "auto"
    bj = lj.train(p, lj.Dataset(x, y, params=p, categorical_feature=cat), 6,
                  verbose_eval=False)
    return bj, _rows(case, x)


def _port_of(bj):
    return lt.Booster(model_str=bj.model_to_string(),
                      params={"device": "cpu"})


def _int_fobj(seed):
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(seed + calls[0])
        calls[0] += 1
        return (rng.integers(-3, 4, len(preds)).astype(np.float64),
                rng.integers(1, 4, len(preds)).astype(np.float64))
    return fobj


@functools.lru_cache(maxsize=None)
def _integer_models(case):
    """The same model trained by both packages under integer gradients."""
    x, y = _data(case)
    p = _params(case)
    # categorical columns through the Dataset argument, which both
    # packages read (the JAX package ignores the parameter)
    p.pop("categorical_feature", None)
    cat = [3] if case == "categorical" else "auto"
    out = {}
    for pkg, pp in ((lj, p), (lt, dict(p, device="cpu"))):
        kw = {} if pkg is lt else {"verbose_eval": False}
        out[pkg] = pkg.train(pp, pkg.Dataset(x, y, params=pp,
                                             categorical_feature=cat), 4,
                             fobj=_int_fobj(7), **kw)
    assert out[lt].model_to_string() == out[lj].model_to_string()
    return out[lj], out[lt], _rows(case, x)


def _pairs(case, source):
    if source == "jax_text":
        bj, rows = _jax_model(case)
        return bj, _port_of(bj), rows
    return _integer_models(case)


SOURCES = [(c, "jax_text") for c in CASES] + [
    (c, "port_trained") for c in ("numerical", "nan", "categorical",
                                  "multiclass")]


@pytest.mark.parametrize("case,source", SOURCES)
def test_leaf_indices_equal_jax(case, source):
    bj, bt, rows = _pairs(case, source)
    want = bj.predict(rows, pred_leaf=True)
    got = bt.predict(rows, pred_leaf=True)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the leaves are those of the traversal behind the scores
    lv = [t.leaf_value for t in bt.inner.models]
    k = bt.inner.num_class
    raw = bt.predict(rows, raw_score=True).reshape(len(rows), k)
    for c in range(k):
        own = [lv[t][got[:, t]] for t in range(c, got.shape[1], k)]
        np.testing.assert_allclose(np.sum(own, 0), raw[:, c], rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("case,source", SOURCES)
def test_contributions_match_jax_and_sum_to_raw(case, source):
    bj, bt, rows = _pairs(case, source)
    want = bj.predict(rows, pred_contrib=True)
    got = bt.predict(rows, pred_contrib=True)
    assert got.shape == want.shape == (
        len(rows), bt.inner.num_class * (bt.num_feature() + 1))
    assert np.all(np.abs(got - want) <= 1e-12 * (1 + np.abs(want)))
    k = bt.inner.num_class
    raw = bt.predict(rows, raw_score=True).reshape(len(rows), k)
    if bt.inner.average_output:
        raw = raw / (len(bt.inner.models) // k)
    sums = got.reshape(len(rows), k, -1).sum(-1)
    assert np.all(np.abs(sums - raw) <= 1e-9 * (1 + np.abs(raw)))


@pytest.mark.parametrize("case", ["numerical", "multiclass"])
@pytest.mark.parametrize("freq,margin", [(1, 0.3), (2, 0.15), (3, 0.05),
                                         (1, 1e9)])
def test_early_stopped_scores_equal_jax(case, freq, margin):
    """Binary and multiclass early stopping (JAX tests/test_engine.py:241):
    equal bit for bit; a margin no row reaches gives the full scores."""
    bj, rows = _jax_model(case)
    bt = _port_of(bj)
    kw = dict(pred_early_stop=True, pred_parameter={
        "pred_early_stop_freq": freq, "pred_early_stop_margin": margin})
    for raw_score in (True, False):
        want = bj.predict(rows, raw_score=raw_score, **kw)
        got = bt.predict(rows, raw_score=raw_score, **kw)
        np.testing.assert_array_equal(got, want)
    full = bt.predict(rows, raw_score=True)
    stopped = bt.predict(rows, raw_score=True, **kw)
    if margin > 1e8:
        np.testing.assert_allclose(stopped, full, rtol=0, atol=1e-12)
    else:
        assert np.any(np.abs(stopped - full) > 1e-9)


def test_early_stop_defaults_from_config():
    """Without ``pred_parameter`` the frequency and margin are the
    Booster's config values (lightgbm_tpu/boosting.py:1793)."""
    bj, rows = _jax_model("numerical")
    p = {"pred_early_stop_freq": 2, "pred_early_stop_margin": 0.5}
    bt = lt.Booster(model_str=bj.model_to_string(),
                    params=dict(p, device="cpu"))
    bj2 = lj.Booster(model_str=bj.model_to_string(), params=p)
    want = bj2.predict(rows, pred_early_stop=True)
    np.testing.assert_array_equal(bt.predict(rows, pred_early_stop=True),
                                  want)
    assert not np.array_equal(want, bj2.predict(rows))


@pytest.mark.parametrize("pred_parameter,kw", [
    ({"predict_leaf_index": True}, {}),
    ({"is_predict_leaf_index": "true"}, {}),
    ({"raw_score": True}, {}),
    ({"is_predict_raw_score": False}, {"raw_score": True}),
    ({"pred_early_stop": True, "pred_early_stop_margin": 0.2}, {}),
    ({"pred_early_stop_freq": 1}, {"pred_early_stop": True}),
    ({}, {"pred_leaf": True, "unused_keyword": 3}),
])
def test_pred_parameter_merged_as_jax(pred_parameter, kw):
    """``pred_parameter``'s keys (aliases resolved) override the
    keywords; other keywords are accepted and not used.  Leaf indices and
    early-stopped scores are equal; plain scores, which each package sums
    in its own order, within 1e-12."""
    bj, rows = _jax_model("numerical")
    bt = _port_of(bj)
    want = bj.predict(rows, pred_parameter=dict(pred_parameter), **kw)
    got = bt.predict(rows, pred_parameter=dict(pred_parameter), **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    exact = (want.dtype == np.int32 or kw.get("pred_early_stop")
             or pred_parameter.get("pred_early_stop"))
    np.testing.assert_allclose(got, want, rtol=0, atol=0 if exact else 1e-12)


def test_pred_parameter_rejects_unknown_keys():
    bj, rows = _jax_model("numerical")
    with pytest.raises(ValueError, match="Unknown parameter"):
        _port_of(bj).predict(rows, pred_parameter={"nonsense": 1})


@pytest.mark.parametrize("case", ["boost_from_average", "multiclass"])
def test_num_iteration_counts_the_average_tree(case):
    """``num_iteration`` cuts leaf indices and contributions as the JAX
    package does: the boost-from-average tree counts as one more
    iteration."""
    bj, rows = _jax_model(case)
    bt = _port_of(bj)
    for it in (1, 3):
        for kw in ({"pred_leaf": True}, {"pred_contrib": True},
                   {"raw_score": True}):
            want = bj.predict(rows, num_iteration=it, **kw)
            got = bt.predict(rows, num_iteration=it, **kw)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_contributions_match_the_oracle():
    """The row-parallel recursion on the device's go-left matrices
    against the literal per-row recursion on raw values."""
    bj, rows = _jax_model("categorical")
    bt = _port_of(bj)
    got = bt.predict(rows[:40], pred_contrib=True)
    nf = bt.num_feature()
    want = np.zeros_like(got)
    for tree in bt.inner.models:
        for r in range(40):
            want[r] += mq.contribs_oracle(tree, rows[r], nf)
    assert np.all(np.abs(got - want) <= 1e-12 * (1 + np.abs(want)))


def test_go_matrix_is_the_traversal():
    """Following each tree's go-left matrix from the root reaches the
    leaf the traversal gives, on every row."""
    bj, rows = _jax_model("categorical")
    p = _port_of(bj).inner.predictor(lt.basic.resolve_device("cpu"))
    leaves = p.bundle.leaves(rows)
    binned = p.bundle.bin_rows(rows)
    for t, tree in enumerate(p.trees):
        go = p.bundle.go_matrix(t, binned).numpy()
        assert go.shape == (tree.num_leaves - 1, len(rows))
        node = np.zeros(len(rows), np.int64)
        for _ in range(tree.max_depth()):
            inner = node >= 0
            nd = np.where(inner, node, 0)
            nxt = np.where(go[nd, np.arange(len(rows))],
                           tree.left_child[nd], tree.right_child[nd])
            node = np.where(inner, nxt, node)
        np.testing.assert_array_equal(~node, leaves[t])


def test_stumps_only_model():
    """A model of one-leaf trees: leaves all 0, contributions the bias."""
    x, y = _data("boost_from_average")
    p = dict(_params("boost_from_average"), min_sum_hessian_in_leaf=1e9)
    bj = lj.train(p, lj.Dataset(x, y, params=p), 2, verbose_eval=False)
    bt = _port_of(bj)
    for kw in ({"pred_leaf": True}, {"pred_contrib": True},
               {"pred_early_stop": True}):
        np.testing.assert_array_equal(bt.predict(x[:50], **kw),
                                      bj.predict(x[:50], **kw))


def test_contrib_rows_past_one_pass(monkeypatch):
    """Rows cut into passes give the contributions of one pass."""
    import lightgbm_tpu_torch.predictor as pr
    bj, rows = _jax_model("nan")
    want = _port_of(bj).predict(rows, pred_contrib=True)
    monkeypatch.setattr(pr, "ROWS_PER_PASS", 64)
    np.testing.assert_array_equal(
        _port_of(bj).predict(rows, pred_contrib=True), want)
    np.testing.assert_array_equal(
        _port_of(bj).predict(rows, pred_leaf=True),
        bj.predict(rows, pred_leaf=True))


@pytest.mark.parametrize("case", ["nan", "categorical", "multiclass"])
def test_recursion_is_the_jax_recursion_bit_for_bit(case):
    """The port's recursion, which takes each one fraction as 0 or 1, gives
    the JAX package's vectorized recursion's float64 values exactly, tree
    by tree, from the same go-left decisions."""
    from lightgbm_tpu.obs import model_quality as jmq
    bj, rows = _jax_model(case)
    p = _port_of(bj).inner.predictor(lt.basic.resolve_device("cpu"))
    binned = p.bundle.bin_rows(rows)
    nf = bj.num_feature()
    for t, (tree, jtree) in enumerate(zip(p.trees, bj.inner.models)):
        if tree.num_leaves < 2:
            continue
        go = p.bundle.go_matrix(t, binned).numpy()
        np.testing.assert_array_equal(
            mq.tree_contribs(tree, go, nf),
            jmq.contribs_from_raw(jtree, rows, nf))
