"""Init scores, continued training, state carried across from the JAX
package, and K trees a round through the data-parallel learner, against
lightgbm_tpu on the task of ``test_torch_breadth``.

Tolerances as there: the first round's trees identical in structure with
values within rtol 1e-4 / atol 1e-5 where its gradients are real-valued,
raw predictions within 2e-4 and metrics within 1e-5 after the rounds; a
booster carried across, raw scores rtol 1e-6 against the JAX
``predict(raw_score=True)`` (both sum the same float64 leaf values, in
another order).  The data-parallel learner over a 2x1 mesh adds each
histogram as two shard partials, so its trees are the serial trees in
structure and its raw scores agree to 1e-5."""
import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import convert

from test_torch_breadth import (N, NV, _groups, _params, _rows,
                                assert_close_after_rounds,
                                assert_trees_match, train_both, tree_blocks)


@pytest.mark.parametrize("objective", ["regression", "multiclass"])
def test_init_score_matches_jax(objective):
    rng = np.random.default_rng(21)
    k = 3 if objective == "multiclass" else 1
    init = rng.normal(0.0, 0.5, k * N)
    bt, bj, ev_t, ev_j = train_both(objective, rounds=3, init_score=init)
    st, sj = bt.model_to_string(), bj.model_to_string()
    assert "boost_from_average" not in st     # an init score replaces it
    assert st.split("Tree=")[0] == sj.split("Tree=")[0]
    assert_trees_match(tree_blocks(st)[:k], tree_blocks(sj)[:k], False)
    assert_close_after_rounds(bt, bj, ev_t, ev_j, objective)


@pytest.mark.parametrize("objective", ["binary", "multiclass",
                                       "lambdarank"])
def test_init_model_continues_as_jax(objective, tmp_path):
    """3 rounds, then 2 more from the saved model (``init_model=`` a file)
    and from the booster itself, in both packages."""
    x, y = _rows(objective, 2, N)
    xv, yv = _rows(objective, 102, NV)
    p = _params(objective)
    kw, kwv = _groups(objective)
    tp = dict(p, device="cpu")
    out = {}
    for pkg, params in ((lj, p), (lt, tp)):
        d = pkg.Dataset(x, y, params=params, **kw)
        first = pkg.train(params, d, 3, verbose_eval=False)
        path = str(tmp_path / f"{pkg.__name__}.txt")
        first.save_model(path)
        ev = {}
        by_file = pkg.train(params, pkg.Dataset(x, y, params=params, **kw),
                            2, init_model=path, evals_result=ev,
                            valid_sets=[pkg.Dataset(xv, yv, reference=d,
                                                    **kwv)],
                            verbose_eval=False)
        by_booster = pkg.train(params, pkg.Dataset(x, y, params=params,
                                                   **kw), 2,
                               init_model=first, verbose_eval=False)
        out[pkg] = (first, by_file, by_booster, ev)
    ft, bt, bbt, ev_t = out[lt]
    fj, bj, bbj, ev_j = out[lj]
    k = bt.inner.num_class
    n_first = len(ft.inner.models)
    assert len(bt.inner.models) == n_first + 2 * k
    assert bt.inner.num_init_iteration == bj.inner.num_init_iteration
    # the continued model starts with the first model's trees, text for text
    assert (tree_blocks(bt.model_to_string())[:n_first]
            == tree_blocks(ft.model_to_string()))
    np.testing.assert_allclose(bbt.predict(xv, raw_score=True),
                               bt.predict(xv, raw_score=True), rtol=0,
                               atol=1e-9)
    assert_close_after_rounds(bt, bj, ev_t, ev_j, objective)


def test_jax_multiclass_booster_carried_across():
    _, bj, _, _ = train_both("multiclass", rounds=3)
    xv, _ = _rows("multiclass", 102, NV)
    want = bj.predict(xv, raw_score=True)
    by_text = convert.booster_from_arrays(
        model_str=bj.model_to_string(), params={"device": "cpu"})
    assert by_text.inner.num_class == 3
    # the same sequential float64 sums on the same leaves: the same bits
    np.testing.assert_array_equal(by_text.predict(xv, raw_score=True), want)
    trees = [{k: getattr(t, k) for k in (
        "num_leaves", "split_feature", "split_gain", "threshold",
        "decision_type", "left_child", "right_child", "leaf_parent",
        "leaf_value", "leaf_count", "internal_value", "internal_count",
        "shrinkage")} for t in bj.inner.models]
    by_fields = convert.booster_from_arrays(
        trees=trees, objective=bj.inner.objective.to_string(),
        max_feature_idx=9, params={"device": "cpu"}, num_class=3)
    np.testing.assert_array_equal(by_fields.predict(xv, raw_score=True),
                                  want)
    np.testing.assert_allclose(by_fields.predict(xv), bj.predict(xv),
                               rtol=1e-6, atol=1e-12)
    assert by_fields.predict(xv).shape == (NV, 3)


def test_jax_ranking_dataset_carried_across():
    """A JAX dataset with query boundaries and init scores, carried
    across: the port's first tree on it is the JAX package's."""
    x, y = _rows("lambdarank", 2, N)
    p = _params("lambdarank")
    kw, _ = _groups("lambdarank")
    init = np.random.default_rng(3).normal(0.0, 0.3, N)
    dj = lj.Dataset(x, y, params=p, init_score=init, **kw)
    bj = lj.train(p, dj, 1, verbose_eval=False)
    td = dj.constructed
    used = td.used_features
    mappers = [td.bin_mappers[j] for j in used]
    ds = convert.dataset_from_arrays(
        td.binned, [m.num_bin for m in mappers],
        [m.missing_type for m in mappers], [m.default_bin for m in mappers],
        [m.bin_upper_bound for m in mappers], td.metadata.label,
        used_features=used, num_total_features=td.num_total_features,
        min_max=[(m.min_val, m.max_val) for m in mappers],
        params={"device": "cpu"},
        query_boundaries=td.metadata.query_boundaries,
        init_score=td.metadata.init_score)
    meta = ds.constructed.metadata
    np.testing.assert_array_equal(meta.query_boundaries,
                                  td.metadata.query_boundaries)
    np.testing.assert_array_equal(meta.init_score, td.metadata.init_score)
    bt = lt.train(dict(p, device="cpu"), ds, 1)
    assert_trees_match(tree_blocks(bt.model_to_string()),
                       tree_blocks(bj.model_to_string()), False)


def test_multiclass_data_parallel_matches_serial():
    """``tree_learner=data`` over a 2x1 mesh of CPU slots: K trees a round
    through the one ``GspmdGrower``, each class's gradients copied into
    its inputs; the trees are the serial learner's."""
    x, y = _rows("multiclass", 2, N)
    xv, _ = _rows("multiclass", 102, NV)
    p = dict(_params("multiclass"), device="cpu")
    serial = lt.train(p, lt.Dataset(x, y, params=p), 3, verbose_eval=False)
    pd = dict(p, tree_learner="data", mesh_shape="2x1", mesh_devices=2)
    dp = lt.train(pd, lt.Dataset(x, y, params=pd), 3, verbose_eval=False)
    assert dp.inner.parallel_impl == "gspmd"
    assert dp.inner.stats["trees"] == 9
    for ts, td in zip(serial.inner.models, dp.inner.models):
        assert ts.num_leaves == td.num_leaves
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(td, f))
    np.testing.assert_allclose(dp.predict(xv, raw_score=True),
                               serial.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)


def test_multiclass_predict_shapes_and_num_iteration():
    x, y = _rows("multiclass", 2, 400)
    p = dict(_params("multiclass"), device="cpu")
    b = lt.train(p, lt.Dataset(x, y, params=p), 4, verbose_eval=False)
    prob = b.predict(x)
    assert prob.shape == (400, 3)
    np.testing.assert_allclose(prob.sum(1), 1.0, rtol=1e-12)
    text = b.model_to_string(num_iteration=2)
    assert len(tree_blocks(text)) == 6
    assert "num_tree_per_iteration=3" in text
    first_two = lt.Booster(model_str=text, params={"device": "cpu"})
    np.testing.assert_array_equal(
        first_two.predict(x, raw_score=True),
        b.predict(x, num_iteration=2, raw_score=True))
    # the JAX package reads the cut model the same way
    jb = lj.Booster(model_str=text)
    np.testing.assert_allclose(jb.predict(x, raw_score=True),
                               b.predict(x, num_iteration=2, raw_score=True),
                               rtol=1e-6, atol=1e-12)


def test_early_stopping_over_many_valued_metrics_as_jax():
    """NDCG@1 and NDCG@3 are two results of one metric, each with its own
    best iteration, as the JAX engine keeps them."""
    x, y = _rows("lambdarank", 5, 400)
    xv, yv = _rows("lambdarank", 105, 300)
    p = dict(_params("lambdarank"), ndcg_eval_at=[1, 3], metric="ndcg",
             learning_rate=1.0, min_data_in_leaf=2)
    out = {}
    for pkg, params in ((lj, p), (lt, dict(p, device="cpu"))):
        d = pkg.Dataset(x, y, group=[25] * 16, params=params)
        out[pkg] = pkg.train(params, d, 30, valid_sets=[pkg.Dataset(
            xv, yv, group=[30] * 10, reference=d)],
            early_stopping_rounds=2, verbose_eval=False)
    bt, bj = out[lt], out[lj]
    assert 0 < bt.best_iteration < 30
    assert bt.best_iteration == bj.best_iteration
    assert bt.best_score["valid_0"].keys() == bj.best_score["valid_0"].keys()
    for k, v in bj.best_score["valid_0"].items():
        np.testing.assert_allclose(bt.best_score["valid_0"][k], v, atol=1e-5)
