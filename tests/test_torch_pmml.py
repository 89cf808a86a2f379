"""The port's PMML export against the JAX package's: for the same model
string (written by the JAX package, or by the port's trainer) the XML text
is the same, byte for byte; a multiclass model is refused with the same
message; the command line prints the same document."""
import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import pmml as j_pmml
from lightgbm_tpu_torch import pmml as t_pmml


def _data(seed, n=800, f=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n, f) < 0.05] = np.nan
    return rng, X


def _binary(params=None):
    rng, X = _data(8)
    X[:, 4] = np.where(rng.rand(len(X)) < 0.3, 0.0, X[:, 4])
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0)
    p = dict({"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 10}, **(params or {}))
    return lj.train(p, lj.Dataset(X, y.astype(np.float32), params=p), 6,
                    verbose_eval=False).model_to_string()


def _categorical():
    rng, X = _data(9)
    X[:, 2] = rng.randint(0, 20, len(X))
    y = ((X[:, 2] % 4 == 1) + np.nan_to_num(X[:, 0]) > 0.5)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "min_data_in_leaf": 10}
    ds = lj.Dataset(X, y.astype(np.float32), params=p,
                    categorical_feature=[2])
    return lj.train(p, ds, 6, verbose_eval=False).model_to_string()


def _regression_rf():
    rng, X = _data(10)
    y = np.nan_to_num(X[:, 0]) * 2 + rng.randn(len(X)) * 0.1
    p = {"objective": "regression", "boosting_type": "rf", "verbose": -1,
         "bagging_freq": 1, "bagging_fraction": 0.7, "num_leaves": 7}
    return lj.train(p, lj.Dataset(X, y, params=p), 4,
                    verbose_eval=False).model_to_string()


def _port_trained():
    rng, X = _data(11)
    y = (np.nan_to_num(X[:, 3]) > 0).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "device": "cpu", "min_data_in_leaf": 10}
    return lt.train(p, lt.Dataset(X, y, params=p), 4).model_to_string()


MODELS = {"binary": _binary, "zero_as_missing": lambda: _binary(
    {"zero_as_missing": True}), "categorical": _categorical,
    "random_forest": _regression_rf, "port_trained": _port_trained}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pmml_text_identical(name):
    text = MODELS[name]()
    got = t_pmml.model_to_pmml(text)
    assert got == j_pmml.model_to_pmml(text)
    assert got.startswith("<?xml") and "<Segmentation" in got


def test_multiclass_refused_as_jax():
    rng, X = _data(12)
    y = rng.randint(0, 3, len(X))
    p = {"objective": "multiclass", "num_class": 3, "verbose": -1,
         "num_leaves": 7}
    text = lj.train(p, lj.Dataset(X, y, params=p), 2,
                    verbose_eval=False).model_to_string()
    with pytest.raises(ValueError) as te:
        t_pmml.model_to_pmml(text)
    with pytest.raises(ValueError) as je:
        j_pmml.model_to_pmml(text)
    assert str(te.value) == str(je.value)


def test_main_prints_the_document(tmp_path, capsys):
    text = _categorical()
    path = tmp_path / "model.txt"
    path.write_text(text)
    assert t_pmml.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert out == j_pmml.model_to_pmml(text)
    assert t_pmml.main([]) == 2
    assert "usage" in capsys.readouterr().err
