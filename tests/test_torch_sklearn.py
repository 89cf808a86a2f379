"""The port's scikit-learn estimators (``lightgbm_tpu_torch/sklearn.py``)
against the JAX package's (``lightgbm_tpu/sklearn.py``), the port with
``device="cpu"``, on the same numpy-seeded data:

* ``LGBMRegressor`` under integer-valued gradients (a custom objective
  through the adapter): the same model text; with the default objective,
  the same first tree and predictions within 1e-4, and under ``eval_set``
  and ``early_stopping_rounds`` the same ``best_iteration_``;
* ``LGBMClassifier`` (binary and multiclass, labels encoded) and
  ``LGBMRanker``: probabilities and scores within 1e-4, the same classes,
  a custom eval metric recorded beside the built-in one;
* ``get_params``/``set_params``, ``clone``, pickling, ``GridSearchCV``;
  without scikit-learn (the card's machine) the module imports on its
  stand-ins, the regressor trains the same model and the classifier
  raises at ``fit``.
"""
import pickle

import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import sklearn as t_sklearn

CPU = {"device": "cpu"}
SMALL = {"num_leaves": 7, "min_child_samples": 5, "silent": True}


def _tree_blocks(text):
    return text.split("Tree=")[1:]


def _regression(seed=2, n=600):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6))
    y = np.round(x @ rng.standard_normal(6) + rng.standard_normal(n))
    return x, y


def _int_objective(y_true, y_pred):
    """Integer-valued gradients that follow the scores: every sum is
    exact in any order."""
    q = np.floor(np.asarray(y_pred) * 4.0)
    return (np.sign(y_pred - y_true) + np.mod(q, 3.0) - 1.0,
            1.0 + np.mod(q, 2.0))


def test_regressor_custom_integer_objective_same_model():
    x, y = _regression()
    kw = dict(SMALL, n_estimators=4, objective=_int_objective)
    jm = lj.LGBMRegressor(**kw).fit(x, y)
    tm = lt.LGBMRegressor(**kw, **CPU).fit(x, y)
    assert tm._fobj is not None
    assert tm.booster_.model_to_string() == jm.booster_.model_to_string()
    assert (tm.predict(x) == jm.predict(x)).all()


def test_regressor_early_stopping_matches_jax():
    x, y = _regression(seed=3, n=900)
    kw = dict(SMALL, n_estimators=40, learning_rate=0.3)
    fit = dict(eval_set=[(x[700:], y[700:])], early_stopping_rounds=3,
               verbose=False)
    jm = lj.LGBMRegressor(**kw).fit(x[:700], y[:700], **fit)
    tm = lt.LGBMRegressor(**kw, **CPU).fit(x[:700], y[:700], **fit)
    assert 0 < tm.best_iteration_ == jm.best_iteration_ < 40
    assert tm.best_iteration == tm.best_iteration_
    tj, tt = (m.booster_.model_to_string() for m in (jm, tm))
    assert _tree_blocks(tt)[0] == _tree_blocks(tj)[0]
    np.testing.assert_allclose(tm.predict(x[700:]), jm.predict(x[700:]),
                               rtol=0, atol=1e-4)
    assert tm.evals_result_.keys() == jm.evals_result_.keys()
    np.testing.assert_allclose(tm.evals_result_["valid_0"]["l2"],
                               jm.evals_result_["valid_0"]["l2"],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tm.feature_importances_,
                                  tm.booster_.feature_importance())
    assert tm.n_features_ == 6 and tm.objective_ == "regression"


@pytest.mark.parametrize("classes", [2, 3])
def test_classifier_matches_jax(classes):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((700, 5))
    score = x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.standard_normal(700)
    y = np.digitize(score, [-0.5, 0.5][:classes - 1])
    labels = np.array(["no", "yes", "maybe"])[y]
    kw = dict(SMALL, n_estimators=5)

    def share(y_true, y_pred):          # a custom eval metric
        return "share", float(np.mean(np.asarray(y_pred) > 0)), False

    fit = dict(eval_set=[(x[500:], labels[500:])],
               eval_metric=["multi_logloss" if classes > 2 else
                            "binary_logloss", share])
    jm = lj.LGBMClassifier(**kw).fit(x[:500], labels[:500], **fit)
    tm = lt.LGBMClassifier(**kw, **CPU).fit(x[:500], labels[:500], **fit)
    assert list(tm.classes_) == list(jm.classes_)
    assert tm.n_classes_ == classes
    pj, pt = jm.predict_proba(x[500:]), tm.predict_proba(x[500:])
    assert pt.shape == (200, classes)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pt.sum(axis=1), 1.0, atol=1e-9)
    sure = np.sort(pj, axis=1)[:, -1] - np.sort(pj, axis=1)[:, -2] > 1e-3
    assert (tm.predict(x[500:])[sure] == jm.predict(x[500:])[sure]).all()
    assert set(tm.evals_result_["valid_0"]) == set(
        jm.evals_result_["valid_0"])
    np.testing.assert_allclose(tm.evals_result_["valid_0"]["share"],
                               jm.evals_result_["valid_0"]["share"],
                               atol=0.01)


def test_ranker_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.random((600, 5))
    rel = (x[:, 0] * 3).astype(np.int64)
    group = np.full(30, 20)
    kw = dict(SMALL, n_estimators=4)
    jm = lj.LGBMRanker(**kw).fit(x, rel, group=group)
    tm = lt.LGBMRanker(**kw, **CPU).fit(x, rel, group=group)
    # lambdarank's gradients are sums of float pairs: the first tree's
    # splits are the JAX package's, its sums within rounding
    tj, tt = (_tree_blocks(m.booster_.model_to_string())[0].splitlines()
              for m in (jm, tm))
    for key in ("split_feature=", "threshold=", "left_child=",
                "right_child=", "leaf_count="):
        assert [ln for ln in tt if ln.startswith(key)] == \
            [ln for ln in tj if ln.startswith(key)]
    np.testing.assert_allclose(tm.predict(x), jm.predict(x), rtol=0,
                               atol=1e-4)
    with pytest.raises(ValueError, match="group"):
        lt.LGBMRanker(**CPU).fit(x, rel)
    with pytest.raises(ValueError, match="Eval_group"):
        lt.LGBMRanker(**CPU).fit(x, rel, group=group,
                                 eval_set=[(x, rel)])


def test_params_clone_pickle_and_grid_search():
    from sklearn.base import clone
    from sklearn.model_selection import GridSearchCV
    reg = lt.LGBMRegressor(n_estimators=6, num_leaves=9, silent=True,
                           min_data_in_leaf=5, **CPU)
    ref = lj.LGBMRegressor(n_estimators=6, num_leaves=9, silent=True,
                           min_data_in_leaf=5)
    assert reg.get_params().keys() == set(ref.get_params()) | {"device"}
    assert reg.get_params()["min_data_in_leaf"] == 5
    reg.set_params(min_data_in_leaf=11)
    assert reg.get_params()["min_data_in_leaf"] == 11
    cl = clone(reg)
    assert cl.get_params() == reg.get_params()
    x, y = _regression(seed=6, n=400)
    reg.fit(x, y)
    again = pickle.loads(pickle.dumps(reg))
    assert (again.predict(x) == reg.predict(x)).all()
    yc = (x[:, 0] > 0).astype(np.int64)
    gs = GridSearchCV(lt.LGBMClassifier(silent=True, n_estimators=3, **CPU),
                      {"num_leaves": [3, 7]}, cv=2).fit(x, yc)
    assert gs.best_params_["num_leaves"] in (3, 7)
    with pytest.raises(t_sklearn.LGBMError, match="fit beforehand"):
        lt.LGBMRegressor(**CPU).booster_


def test_estimators_exported_lazily():
    assert lt.LGBMRegressor is t_sklearn.LGBMRegressor
    assert set(t_sklearn.__name__.split(".")) == {"lightgbm_tpu_torch",
                                                  "sklearn"}
    for name in ("LGBMModel", "LGBMClassifier", "LGBMRegressor",
                 "LGBMRanker"):
        assert name in lt.__all__
    with pytest.raises(AttributeError):
        lt.NotAnEstimator


def test_without_sklearn_the_regressor_runs_on_stand_ins(tmp_path):
    """Where scikit-learn is missing (the card's machine) the module
    imports on its stand-ins: the regressor trains the model it trains
    with scikit-learn, and the classifier raises at ``fit``."""
    import os
    import subprocess
    import sys
    x, y = _regression(seed=9, n=300)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    code = (
        "import sys; sys.modules['sklearn'] = None\n"
        "import numpy as np\n"
        "from lightgbm_tpu_torch import sklearn as s\n"
        "assert not s._SKLEARN_INSTALLED\n"
        f"x, y = np.load({str(tmp_path / 'x.npy')!r}), "
        f"np.load({str(tmp_path / 'y.npy')!r})\n"
        "m = s.LGBMRegressor(n_estimators=3, num_leaves=7, device='cpu')\n"
        "assert m.get_params()['num_leaves'] == 7\n"
        "print(m.fit(x, y).booster_.model_to_string(), end='')\n"
        "try:\n"
        "    s.LGBMClassifier(device='cpu').fit(x, y > 0)\n"
        "except s.LGBMError as e:\n"
        "    assert 'scikit-learn' in str(e)\n"
        "else:\n"
        "    raise SystemExit('the classifier trained without sklearn')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0, res.stderr[-2000:]
    want = lt.LGBMRegressor(n_estimators=3, num_leaves=7, **CPU).fit(x, y)
    assert res.stdout == want.booster_.model_to_string()
