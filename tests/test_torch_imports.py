"""The PyTorch port stands alone: no JAX, nothing of lightgbm_tpu; its
entry points run on the card unless asked for the CPU, and parameters
outside the ported slice raise instead of being ignored."""
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


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                bad.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
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
    {"elastic_min_ranks": 2},
    {"elastic_resume": True},
    {"telemetry": True},
    {"straggler_factor": 5.0},
])
def test_unsupported_params_raise(params):
    x, y = _small()
    p = dict({"objective": "binary", "device": "cpu"}, **params)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lt.train(p, lt.Dataset(x, y, params=p), 1)


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
