"""The PyTorch port stands alone: no JAX, nothing of lightgbm_tpu; its
entry points run on the card unless asked for the CPU, and every
parameter of the JAX package is read or taken as-is, while unknown ones
raise."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lightgbm_tpu_torch")
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|lightgbm_tpu(?!_torch))(\W|$)",
    re.MULTILINE)


# a JAX package module named in the text of the native library's sources
# (the embedded interpreter imports by name)
_NAMES_JAX_MODULE = re.compile(r"\blightgbm_tpu\.")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files
                if f.endswith((".py", ".cpp"))]
    return sorted(out)


def test_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        for m in _FORBIDDEN.finditer(text):
            bad.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
        if path.endswith(".cpp") or path.endswith("capi_bridge.py"):
            bad += [f"{os.path.relpath(path, ROOT)}: {m.group(0)}"
                    for m in _NAMES_JAX_MODULE.finditer(text)]
    assert not bad, bad


def test_import_loads_no_jax_module():
    modules = sorted(
        f"lightgbm_tpu_torch.{os.path.relpath(os.path.join(d, f), PKG)[:-3]}"
        .replace(os.sep, ".").replace(".__init__", "")
        for d, _, files in os.walk(PKG) for f in files if f.endswith(".py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lightgbm_tpu')]\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_import_loads_no_pandas_or_scipy():
    """pandas is absent on the card's machine: the package imports
    neither it nor scipy, and reads a DataFrame by its attributes."""
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.data\n"
            "print(repr(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pandas', 'scipy'))))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 4))
    return x, (x[:, 0] > 0).astype(np.float32)


def test_dataset_construct_raises_without_card(no_card):
    x, y = _small()
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Dataset(x, y).construct()


def test_train_raises_without_card(no_card):
    x, y = _small()
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.train({"objective": "binary"}, lt.Dataset(x, y), 1)


def test_predict_raises_without_card(no_card):
    x, y = _small()
    params = {"objective": "binary", "device": "cpu", "verbose": -1}
    bst = lt.train(params, lt.Dataset(x, y, params=params), 2)
    np.testing.assert_array_equal(bst.predict(x).shape, (300,))
    with pytest.raises(RuntimeError, match="CUDA"):
        bst.predict(x, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Booster(model_str=bst.model_to_string())


@pytest.mark.parametrize("params", [
    {"input_model": "model.txt"},
    {"convert_model": "model.cpp"},
    {"output_result": "out.txt"},
    {"task": "predict"},
])
def test_unsupported_params_raise(params):
    """The CLI keys, which raised until the CLI was ported, train and are
    read into the config; no key of the JAX package raises any more."""
    x, y = _small()
    p = dict({"objective": "binary", "device": "cpu", "verbose": -1},
             **params)
    cfg = lt.train(p, lt.Dataset(x, y, params=p), 1).inner.config
    for key, value in params.items():
        assert getattr(cfg, key) == value


@pytest.mark.parametrize("params", [
    {"latency_budget_ms": 5.0},
    {"serving_buckets": "1,8"},
    {"drift_threshold": 0.5},
])
def test_serving_params_train(params):
    """The serving keys, which raised until the serving slice, train and
    are read into the config."""
    x, y = _small()
    p = dict({"objective": "binary", "device": "cpu", "verbose": -1},
             **params)
    cfg = lt.train(p, lt.Dataset(x, y, params=p), 1).inner.config
    for key, value in params.items():
        assert getattr(cfg, key) == value


SERVING_MODULES = ("inference.py", "serving.py", "pmml.py",
                   os.path.join("ops", "traverse.py"), "cli.py", "sklearn.py",
                   "plotting.py", os.path.join("native", "__init__.py"),
                   os.path.join("native", "capi_bridge.py"),
                   os.path.join("native", "gbt_native.cpp"),
                   os.path.join("native", "gbt_capi_train.cpp"))


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_checked(module):
    """The serving slice's and the CLI slice's modules (and the native
    library's C++) are among the sources checked above and import neither
    JAX nor the JAX package."""
    path = os.path.join(PKG, module)
    assert path in _port_sources()
    with open(path) as f:
        text = f.read()
    assert not _FORBIDDEN.search(text)
    if module.startswith("native"):
        assert not _NAMES_JAX_MODULE.search(text)


def _text_files(tmp_path):
    x, y = _small()
    path = tmp_path / "train.tsv"
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t")
    return str(path)


def test_cli_slice_entry_points_raise_without_card(no_card, tmp_path):
    """The CLI's ``task=train``, ``supervisor.main`` (before it launches a
    worker), the C ABI's ``GBTN_BoosterCreate`` and an estimator's ``fit``
    run on the card unless asked for the CPU, and raise without one."""
    import ctypes

    from lightgbm_tpu_torch import cli, native, supervisor
    from lightgbm_tpu_torch.sklearn import LGBMRegressor
    data = _text_files(tmp_path)
    out = str(tmp_path / "m.txt")
    argv = ["task=train", f"data={data}", "objective=binary",
            f"output_model={out}", "num_trees=1", "verbose=-1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        supervisor.main(argv)
    assert not os.path.exists(out + ".rank_0.log")
    assert cli.main(argv + ["device=cpu"]) == 0
    lib = native.get_lib()
    x, y = _small()
    x = np.ascontiguousarray(x)
    y = y.astype(np.float32)
    ds, bst = ctypes.c_void_p(), ctypes.c_void_p()
    assert lib.GBTN_DatasetCreateFromMat(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(x), 4,
        b"objective=binary", y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        None, ctypes.byref(ds)) == 0
    assert lib.GBTN_BoosterCreate(ds, b"objective=binary",
                                  ctypes.byref(bst)) != 0
    assert b"CUDA" in lib.GBTN_GetLastError()
    assert lib.GBTN_BoosterCreate(ds, b"objective=binary device=cpu",
                                  ctypes.byref(bst)) == 0
    lib.GBTN_BoosterFree(bst)
    lib.GBTN_DatasetFree(ds)
    with pytest.raises(RuntimeError, match="CUDA"):
        LGBMRegressor(n_estimators=1).fit(x, y)
    assert LGBMRegressor(n_estimators=1, device="cpu").fit(x, y).predict(
        x).shape == (len(x),)


def _model_text():
    x, y = _small()
    params = {"objective": "binary", "device": "cpu", "verbose": -1}
    return lt.train(params, lt.Dataset(x, y, params=params),
                    2).model_to_string()


def test_serving_entry_points_raise_without_card(no_card, tmp_path):
    """The engine, the server and ``python -m lightgbm_tpu_torch.serving``
    run on the card unless asked for the CPU, and raise without one."""
    from lightgbm_tpu_torch import serving
    from lightgbm_tpu_torch.boosting import GBDT
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.inference import PredictEngine
    text = _model_text()
    trees = GBDT.load_from_string(text, Config()).models
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictEngine(trees)
    assert PredictEngine(trees, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.ModelServer(model_str=text, autostart=False)
    path = tmp_path / "m.txt"
    path.write_text(text)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.main(["--model", str(path), "--replay", "2"])


@pytest.mark.parametrize("params", [
    {"tree_learner": "voting", "mesh_devices": 2},
    {"shard_axes": "batch,feature"},
    {"tree_learner": "data", "mesh_devices": 2},
    {"hbm_budget": 1e9},
    {"collective_retries": 5},
    {"snapshot_freq": 5},
])
def test_formerly_unsupported_params_train(params):
    """Values that raised until the planner was ported: two mesh slots at
    ``mesh_shape=auto`` are planned (2x1, with no capacity on the CPU),
    ``shard_axes`` leaves the serial learner as it is, and ``hbm_budget``
    holds the placement walk and the pre-flight to its bytes; the
    collectives' retries and the snapshot cadence (checkpoints) are read,
    a one-round training writing no snapshot."""
    x, y = _small()
    p = dict({"objective": "binary", "device": "cpu", "verbose": -1},
             **params)
    inner = lt.train(p, lt.Dataset(x, y, params=p), 1).inner
    if "mesh_devices" in params:
        plan = inner.mesh_plan
        assert (plan.data, plan.feature) == (2, 1) and inner._gspmd
        assert "no capacity signal" in plan.reason
    else:
        assert inner.plan.learner == "serial" and inner.mesh_plan is None
        assert inner.placement.mode == "resident"
    if "hbm_budget" in params:
        assert inner.placement.capacity == 10 ** 9
        assert inner.plan.prediction["peak_bytes"] <= 10 ** 9


@pytest.mark.parametrize("params,message", [
    ({"objective": "multiclass", "num_class": 1}, "greater than 1"),
    ({"objective": "multiclassova"}, "greater than 1"),
    ({"objective": "binary", "num_class": 3}, "must be 1"),
    ({"objective": "binary", "num_class": 0}, "positive"),
])
def test_num_class_checked_as_jax(params, message):
    """lightgbm_tpu/config.py:645-652: multiclass needs num_class > 1,
    every other objective num_class == 1."""
    x, y = _small()
    p = dict({"device": "cpu"}, **params)
    with pytest.raises(RuntimeError, match=message):
        lt.train(p, lt.Dataset(x, y, params=p), 1)


def test_bundleable_dataset_raises_unless_bundling_off():
    """The data that once raised at the default ``enable_bundle=true``
    now trains bundled (two exclusive columns share one) and grows the
    trees it grows unbundled with ``enable_bundle=false``."""
    rng = np.random.default_rng(1)
    x = np.zeros((400, 3))
    x[:100, 0] = rng.standard_normal(100)      # mutually exclusive sparse
    x[100:200, 1] = rng.standard_normal(100)
    x[:, 2] = rng.standard_normal(400)
    y = (x.sum(1) > 0).astype(np.float32)
    p = {"objective": "binary", "device": "cpu", "min_data_in_leaf": 5,
         "num_leaves": 7, "verbose": -1}
    bundled = lt.Dataset(x, y, params=p).construct()
    assert bundled.bins.shape == (400, 2)
    q = dict(p, enable_bundle=False)
    plain = lt.Dataset(x, y, params=q).construct()
    assert plain.bins.shape == (400, 3)

    def fobj(preds, data):      # integer gradients: exact sums either way
        r = np.random.default_rng(int(np.abs(preds).sum() * 1e3) % 997)
        return (r.integers(-3, 4, len(preds)).astype(np.float64),
                r.integers(1, 3, len(preds)).astype(np.float64))
    a = lt.train(p, bundled, 3, fobj=fobj)
    b = lt.train(q, plain, 3, fobj=fobj)
    assert a.num_trees() == 3
    assert a.model_to_string() == b.model_to_string()


def test_unknown_parameter_rejected():
    x, y = _small()
    with pytest.raises(ValueError, match="Unknown parameter"):
        lt.train({"objective": "binary", "device": "cpu", "nonsense": 3},
                 lt.Dataset(x, y), 1)
