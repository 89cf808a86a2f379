"""The training API of the port against lightgbm_tpu: callbacks,
``learning_rates``, ``fobj``/``feval``, ``cv`` (stratified, shuffled,
query groups), the Booster's methods and the Dataset's fields and subsets.

Tolerances: trees grown from integer-valued gradients and hessians (a
custom objective, or the binary objective's first tree) are identical,
so model text, ``dump_model`` and gain importance compare exactly; the
scores of a rolled-back iteration are restored bit for bit
(``torch.equal``); metrics, predictions and cv means and deviations agree
within 1e-5 after several rounds of the built-in objective, where the
float32 sums round in each package's order."""
import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

N, F = 1500, 8
BASE = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
            verbose=-1, enable_bundle=False, enable_bin_packing=False,
            metric=["binary_logloss", "auc"])


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, F))
    y = (x[:, 0] - 0.7 * x[:, 1] + 0.5 * rng.standard_normal(n) > 0
         ).astype(np.float32)
    return x, y


def _cpu(p):
    return dict(p, device="cpu")


def _int_fobj(seed):
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(seed + calls[0])
        calls[0] += 1
        return (rng.integers(-3, 4, len(preds)).astype(np.float64),
                rng.integers(1, 4, len(preds)).astype(np.float64))
    return fobj


def _logloss_fobj(preds, data):
    """The binary log loss's gradients, as the objective computes them."""
    y = data.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - y, p * (1.0 - p)


def _error_feval(preds, data):
    return "my_error", float(np.mean((preds > 0) != data.get_label())), False


def _train_both(params, rounds, x, y, xv=None, yv=None, **kw):
    """``train`` in both packages; ``kw`` may hold callables made per
    package (``make_*`` keys)."""
    out = {}
    for pkg, p in ((lj, params), (lt, _cpu(params))):
        extra = {k[5:]: v(pkg) for k, v in kw.items() if k.startswith("make_")}
        extra.update({k: v for k, v in kw.items() if not k.startswith("make_")})
        d = pkg.Dataset(x, y, params=p)
        vs = [] if xv is None else [pkg.Dataset(xv, yv, reference=d)]
        ev = {}
        b = pkg.train(p, d, rounds, valid_sets=vs, evals_result=ev,
                      verbose_eval=False, **extra)
        out[pkg] = (b, ev)
    return out


def _assert_evals_close(ev_t, ev_j):
    assert ev_t.keys() == ev_j.keys()
    for name in ev_j:
        assert list(ev_t[name]) == list(ev_j[name])
        for metric in ev_j[name]:
            np.testing.assert_allclose(ev_t[name][metric], ev_j[name][metric],
                                       rtol=0, atol=1e-5, err_msg=metric)


# ---- callbacks, learning rates, fobj and feval -----------------------------

@pytest.mark.parametrize("rates", ["list", "function"])
def test_learning_rates_match_jax(rates):
    """A schedule through ``reset_parameter``: with exact trees the model
    text is identical, each tree shrunk by its round's rate."""
    x, y = _data(1)
    sched = [0.3, 0.2, 0.1, 0.05]
    lr = sched if rates == "list" else (lambda i: sched[i])
    out = _train_both(BASE, 4, x, y, make_fobj=lambda pkg: _int_fobj(2),
                      learning_rates=lr)
    bt, bj = out[lt][0], out[lj][0]
    assert bt.model_to_string() == bj.model_to_string()
    assert bt.inner.models[-1].shrinkage == 0.05
    assert bt.inner.config.learning_rate == 0.05


def test_callbacks_record_print_and_reset():
    x, y = _data(3)
    xv, yv = _data(4, 500)
    rec = {}
    seen = []

    def spy(env):
        seen.append((env.iteration, len(env.evaluation_result_list)))
    spy.order = 5
    p = _cpu(BASE)
    d = lt.Dataset(x, y, params=p)
    b = lt.train(p, d, 3, valid_sets=[d.create_valid(xv, yv)],
                 callbacks=[lt.record_evaluation(rec), spy,
                            lt.print_evaluation(1),
                            lt.reset_parameter(
                                learning_rate=[0.1, 0.2, 0.3])],
                 verbose_eval=False)
    assert seen == [(0, 2), (1, 2), (2, 2)]
    assert list(rec["valid_0"]) == ["binary_logloss", "auc"]
    assert len(rec["valid_0"]["auc"]) == 3
    assert b.inner.config.learning_rate == 0.3
    with pytest.raises(ValueError, match="num_boost_round"):
        lt.train(p, lt.Dataset(x, y, params=p), 3, verbose_eval=False,
                 callbacks=[lt.reset_parameter(learning_rate=[0.1])])
    with pytest.raises(TypeError):
        lt.record_evaluation([])


def test_early_stopping_callback_matches_jax():
    x, y = _data(5, 400)
    xv, yv = _data(6, 600)
    p = dict(BASE, learning_rate=1.0, num_leaves=31, min_data_in_leaf=2)
    out = _train_both(p, 40, x, y, xv, yv,
                      make_fobj=lambda pkg: _int_fobj(30),
                      make_callbacks=lambda pkg: [
                          (lj.callback if pkg is lj else lt).early_stopping(
                              3, verbose=False)])
    (bt, ev_t), (bj, ev_j) = out[lt], out[lj]
    assert 0 < bt.best_iteration < 40
    assert bt.best_iteration == bj.best_iteration
    for name in bj.best_score:
        for m, v in bj.best_score[name].items():
            assert abs(bt.best_score[name][m] - v) < 1e-5
    _assert_evals_close(ev_t, ev_j)


def test_fobj_and_feval_match_jax():
    """A custom binary log loss grows the built-in objective's first tree;
    ``feval`` values enter the records beside the built-in metrics."""
    x, y = _data(7)
    xv, yv = _data(8, 500)
    out = _train_both(BASE, 4, x, y, xv, yv, fobj=_logloss_fobj,
                      feval=_error_feval)
    (bt, ev_t), (bj, ev_j) = out[lt], out[lj]
    _assert_evals_close(ev_t, ev_j)
    assert "my_error" in ev_t["valid_0"]
    p = _cpu(BASE)
    builtin = lt.train(p, lt.Dataset(x, y, params=p), 1, verbose_eval=False)
    first = lambda s: s.split("Tree=")[1].split("\n\n")[0]
    assert first(bt.model_to_string()) == first(builtin.model_to_string())
    np.testing.assert_allclose(bt.predict(xv, raw_score=True),
                               bj.predict(xv, raw_score=True), atol=1e-5)


def test_feval_on_training_data_in_valid_sets():
    x, y = _data(9)
    p = _cpu(BASE)
    d = lt.Dataset(x, y, params=p)
    ev = {}
    lt.train(p, d, 2, valid_sets=[d], valid_names=["train"],
             feval=_error_feval, evals_result=ev, verbose_eval=False)
    assert list(ev["train"]) == ["binary_logloss", "auc", "my_error"]


def test_resume_names_its_roadmap_item(tmp_path):
    """``resume=True`` with no snapshot trains from scratch (checkpoints
    are ported); the elastic resume across process counts is not, and
    names its roadmap item."""
    x, y = _data(10, 200)
    p = _cpu(dict(BASE, output_model=str(tmp_path / "m.txt")))
    fresh = lt.train(p, lt.Dataset(x, y, params=p), 1, resume=True)
    assert fresh.model_to_string() == lt.train(
        p, lt.Dataset(x, y, params=p), 1).model_to_string()
    with pytest.raises(NotImplementedError,
                       match="checkpoints, serving, observability"):
        lt.train(dict(p, elastic_resume=True), lt.Dataset(x, y, params=p),
                 1, resume=True)


# ---- cv ----------------------------------------------------------------------

@pytest.mark.parametrize("stratified,shuffle", [(True, True), (False, True),
                                                (False, False)])
def test_cv_matches_jax(stratified, shuffle):
    """Integer-valued gradients (one sequence over the folds in their
    order): every fold's trees exact, so only the scores' float32 rounding
    separates the means."""
    x, y = _data(11)
    out = {}
    for pkg, p in ((lj, BASE), (lt, _cpu(BASE))):
        out[pkg] = pkg.cv(p, pkg.Dataset(x, y, params=p), 4, nfold=3,
                          stratified=stratified, shuffle=shuffle, seed=5,
                          fobj=_int_fobj(31))
    rt, rj = out[lt], out[lj]
    assert list(rt) == list(rj) == ["binary_logloss-mean",
                                    "binary_logloss-stdv", "auc-mean",
                                    "auc-stdv"]
    for k in rj:
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_cv_early_stopping_matches_jax():
    x, y = _data(12, 600)
    p = dict(BASE, learning_rate=1.0, num_leaves=31, min_data_in_leaf=2,
             metric="binary_logloss")
    out = {}
    for pkg, pp in ((lj, p), (lt, _cpu(p))):
        out[pkg] = pkg.cv(pp, pkg.Dataset(x, y, params=pp), 30, nfold=3,
                          early_stopping_rounds=2, seed=1,
                          fobj=_int_fobj(32))
    assert len(out[lt]["binary_logloss-mean"]) < 30
    assert len(out[lt]["binary_logloss-mean"]) == len(
        out[lj]["binary_logloss-mean"])
    np.testing.assert_allclose(out[lt]["binary_logloss-mean"],
                               out[lj]["binary_logloss-mean"], atol=1e-5)


def test_cv_with_query_groups_matches_jax():
    rng = np.random.default_rng(13)
    sizes = rng.integers(5, 30, 60)
    n = int(sizes.sum())
    x = rng.standard_normal((n, F))
    y = np.clip(np.round(x[:, 0] + rng.standard_normal(n)), 0, 3).astype(
        np.float32)
    p = dict(BASE, objective="lambdarank", metric="ndcg", ndcg_eval_at=[3])
    out = {}
    for pkg, pp in ((lj, p), (lt, _cpu(p))):
        out[pkg] = pkg.cv(pp, pkg.Dataset(x, y, group=sizes, params=pp), 3,
                          nfold=3, seed=2)
    assert list(out[lt]) == ["ndcg@3-mean", "ndcg@3-stdv"]
    for k in out[lj]:
        np.testing.assert_allclose(out[lt][k], out[lj][k], atol=1e-5)


def test_cv_folds_match_jax():
    x, y = _data(14, 300)
    dt = lt.Dataset(x, y, params=_cpu(BASE))
    dj = lj.Dataset(x, y, params=BASE)
    from lightgbm_tpu.engine import _make_n_folds as folds_j
    from lightgbm_tpu_torch.engine import _make_n_folds as folds_t
    dt.construct()
    for strat in (True, False):
        ft = list(folds_t(dt, 4, BASE, 3, strat, True, None))
        fj = list(folds_j(dj, 4, BASE, 3, strat, True, None))
        for (a, b, _), (c, d, _) in zip(ft, fj):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_cv_booster_dispatches_to_every_fold():
    x, y = _data(15, 300)
    p = _cpu(BASE)
    folds = [lt.Booster(params=p, train_set=lt.Dataset(x[i::2], y[i::2],
                                                       params=p))
             for i in range(2)]
    cvb = lt.CVBooster(folds)
    assert cvb.update() == [False, False]
    assert cvb.current_iteration() == [1, 1]
    with pytest.raises(AttributeError):
        cvb._hidden


# ---- the Booster ---------------------------------------------------------------

@pytest.fixture(scope="module")
def exact_pair():
    """Both packages' boosters after 4 rounds of integer-valued gradients,
    with a valid set: identical trees."""
    x, y = _data(16)
    xv, yv = _data(17, 400)
    boosters = {}
    for pkg, p in ((lj, BASE), (lt, _cpu(BASE))):
        d = pkg.Dataset(x, y, params=p)
        b = pkg.Booster(params=p, train_set=d)
        b.add_valid(pkg.Dataset(xv, yv, reference=d), "valid_0")
        fobj = _int_fobj(18)
        for _ in range(4):
            b.update(fobj=fobj)
        boosters[pkg] = b
    return boosters[lt], boosters[lj], x, xv, yv


def test_dump_model_equals_jax(exact_pair):
    bt, bj, _, _, _ = exact_pair
    assert bt.model_to_string() == bj.model_to_string()
    assert bt.dump_model() == bj.dump_model()
    assert bt.dump_model(2) == bj.dump_model(2)


@pytest.mark.parametrize("kind", ["split", "gain"])
def test_feature_importance_equals_jax(exact_pair, kind):
    bt, bj, _, _, _ = exact_pair
    np.testing.assert_array_equal(bt.feature_importance(kind),
                                  bj.feature_importance(kind))
    np.testing.assert_array_equal(bt.feature_importance(kind, 2),
                                  bj.feature_importance(kind, 2))
    with pytest.raises(ValueError):
        bt.feature_importance("cover")


def test_model_accessors(exact_pair):
    bt, bj, _, _, _ = exact_pair
    assert bt.feature_name() == bj.feature_name()
    assert bt.num_trees() == bj.num_trees() == 4
    assert bt.num_feature() == bj.num_feature() == F
    assert bt.current_iteration() == bj.current_iteration()
    assert bt.get_leaf_output(1, 2) == bj.get_leaf_output(1, 2)


@pytest.mark.parametrize("model", ["gbdt", "dart"])
def test_rollback_restores_scores(model):
    """The last iteration's rollback restores the training and valid scores
    bit for bit; with DART (no stash) and for an older iteration it
    subtracts the trees' outputs: the scores then equal the predictions of
    the trees left, within float32 rounding."""
    x, y = _data(19)
    xv, yv = _data(20, 400)
    p = _cpu(dict(BASE, boosting_type=model, drop_rate=0.5, skip_drop=0.0))
    d = lt.Dataset(x, y, params=p)
    b = lt.Booster(params=p, train_set=d)
    b.add_valid(d.create_valid(xv, yv), "valid_0")
    for _ in range(3):
        b.update()
    t0 = b.inner.scores.clone()
    v0 = b.inner.valid_sets[0].scores.clone()
    text = b.model_to_string()
    b.update()
    b.rollback_one_iter()
    assert b.current_iteration() == 3 and b.num_trees() == 3
    if model == "gbdt":
        assert torch.equal(b.inner.scores, t0)
        assert torch.equal(b.inner.valid_sets[0].scores, v0)
        assert b.model_to_string() == text
    # DART's normalisation of the dropped trees stays: the scores follow
    # the model that is left
    # an older iteration: the stash covers one
    b.rollback_one_iter()
    np.testing.assert_allclose(b.inner.scores[0].double().numpy(),
                               b.predict(x, raw_score=True), atol=1e-5)
    np.testing.assert_allclose(
        b.inner.valid_sets[0].scores[0].double().numpy(),
        b.predict(xv, raw_score=True), atol=1e-5)


def test_rollback_matches_jax():
    x, y = _data(21)
    boosters = {}
    for pkg, p in ((lj, BASE), (lt, _cpu(BASE))):
        b = pkg.Booster(params=p, train_set=pkg.Dataset(x, y, params=p))
        fobj = _int_fobj(22)
        for _ in range(3):
            b.update(fobj=fobj)
        b.rollback_one_iter()
        b.rollback_one_iter()
        b.update(fobj=fobj)
        boosters[pkg] = b
    assert boosters[lt].model_to_string() == boosters[lj].model_to_string()


def test_eval_and_reset_parameter(exact_pair):
    bt, bj, _, xv, yv = exact_pair
    attached = bt._valid_datasets[0]
    res = bt.eval(attached, "valid_0", feval=_error_feval)
    assert [r[1] for r in res] == ["binary_logloss", "auc", "my_error"]
    assert res[:2] == bt.eval_valid()
    # a dataset not attached is scored from scratch
    fresh = lt.Dataset(xv, yv, reference=attached.reference)
    res2 = bt.eval(fresh, "other", feval=_error_feval)
    for a, b in zip(res, res2):     # scored in float64, then rounded
        assert a[1] == b[1] and abs(a[2] - b[2]) < 1e-6
    jres = bj.eval(lj.Dataset(xv, yv, reference=bj._train_dataset),
                   "other", feval=_error_feval)
    for a, b in zip(res2, jres):
        assert a[1] == b[1] and abs(a[2] - b[2]) < 1e-5
    assert bt.eval_train(_error_feval)[-1][1] == "my_error"
    bt.reset_parameter({"learning_rate": "0.25", "bagging_fraction": 0.9})
    assert bt.inner.config.learning_rate == 0.25
    assert bt.params["learning_rate"] == "0.25"
    with pytest.raises(ValueError, match="Unknown parameter"):
        bt.reset_parameter({"nonsense": 1})


def test_attr_leaf_output_merge_and_pickle(exact_pair, tmp_path):
    bt, bj, x, _, _ = exact_pair
    b = lt.Booster(model_str=bt.model_to_string(), params={"device": "cpu"})
    b.set_attr(a=1, b="x")
    assert b.attr("a") == "1" and b.attr("b") == "x" and b.attr("c") is None
    b.set_attr(a=None)
    assert b.attr("a") is None
    b.set_train_data_name("train")
    before = b.predict(x, raw_score=True)
    b.set_leaf_output(0, 0, b.get_leaf_output(0, 0) + 1.0)
    after = b.predict(x, raw_score=True)
    assert not np.array_equal(before, after)     # the cached predictor
    other = lt.Booster(model_str=bt.model_to_string(), params={"device":
                                                               "cpu"})
    other.merge(b)
    jb = lj.Booster(model_str=bj.model_to_string())
    jb.merge(lj.Booster(model_str=b.model_to_string()))
    assert other.num_trees() == 8 and other.current_iteration() == 8
    np.testing.assert_allclose(other.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=1e-12)
    clone = pickle.loads(pickle.dumps(bt))
    assert clone.model_to_string() == bt.model_to_string()
    np.testing.assert_array_equal(clone.predict(x), bt.predict(x))


def test_free_dataset_keeps_prediction():
    x, y = _data(23)
    p = _cpu(BASE)
    b = lt.train(p, lt.Dataset(x, y, params=p), 2, verbose_eval=False)
    want = b.predict(x)
    b.free_dataset()
    assert b.inner.bins is None and b.inner.scores is None
    np.testing.assert_array_equal(b.predict(x), want)
    assert "Tree=1" in b.model_to_string()


# ---- the Dataset ---------------------------------------------------------------

def test_dataset_fields_and_subset_match_jax():
    rng = np.random.default_rng(24)
    sizes = np.array([3, 5, 4, 6, 2])
    n = int(sizes.sum())
    x = rng.standard_normal((n, F))
    y = rng.integers(0, 3, n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n)
    init = rng.standard_normal(n)
    dt = lt.Dataset(x, y, weight=w, group=sizes, init_score=init,
                    params=_cpu(BASE))
    dj = lj.Dataset(x, y, weight=w, group=sizes, init_score=init,
                    params=BASE)
    for f in ("label", "weight", "group", "query", "init_score"):
        np.testing.assert_array_equal(dt.get_field(f), dj.get_field(f))
    assert dt.num_data() == n and dt.num_feature() == F
    idx = [0, 1, 5, 6, 7, 19]
    st, sj = dt.subset(idx), dj.subset(idx)
    for f in ("label", "weight", "group", "init_score"):
        np.testing.assert_array_equal(st.get_field(f), sj.get_field(f))
    np.testing.assert_array_equal(st.get_group(), [2, 3, 1])
    assert st.reference is dt
    dt.set_field("label", y[::-1].copy())
    np.testing.assert_array_equal(dt.get_label(), y[::-1])
    dt.set_weight(None)
    assert dt.get_weight() is None
    with pytest.raises(ValueError, match="Unknown field"):
        dt.get_field("colour")
