"""The port's command-line application (``lightgbm_tpu_torch/cli.py``)
against the JAX package's (``lightgbm_tpu/cli.py``), both driven through
``main`` on the same text files, the port with ``device=cpu``:

* an L2 training under integer labels writes the same model file, byte
  for byte; a binary training the same first tree, its predictions within
  1e-4 (``tests/test_torch_engine.py``'s rule past the first tree), and
  eval-log lines of the same names (the R package's patterns) with values
  within 1e-4;
* ``task=convert_model`` writes the same C++ text for one model file,
  which compiles, and whose ``PredictRawAll`` gives the port's raw scores;
* ``task=dump_model`` writes the same JSON;
* ``task=predict``: raw scores equal to the JAX ``Booster.predict``'s bit
  for bit after the ``%.18g`` round trip, and within 1e-10 of the JAX
  CLI's (its host C++ predictor, ``tests/test_native.py``'s tolerance);
  probabilities and leaf indices too;
* the command line wins over the config file, as the JAX ``parse_cli``
  reads it.
"""
import ctypes
import json
import logging
import os
import re
import subprocess

import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import cli as j_cli
from lightgbm_tpu_torch import cli as t_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["num_leaves=7", "min_data_in_leaf=5", "verbose=1"]


def _write(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t",
               fmt="%.17g")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1200, 6))
    x[rng.random(x.shape) < 0.03] = np.nan
    y_bin = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1])
             + 0.3 * rng.standard_normal(1200) > 0).astype(np.float64)
    y_int = np.round(2 * np.nan_to_num(x[:, 2]) + rng.integers(0, 3, 1200))
    return dict(
        dir=d, x_valid=x[900:],
        bin_train=_write(d / "bin.train", x[:900], y_bin[:900]),
        bin_valid=_write(d / "bin.valid", x[900:], y_bin[900:]),
        l2_train=_write(d / "l2.train", x[:900], y_int[:900]))


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run(main, logger, argv):
    h = _Lines()
    lg = logging.getLogger(logger)
    lg.addHandler(h)
    try:
        assert main(argv) == 0
    finally:
        lg.removeHandler(h)
    return h.lines


def _both(argv, out_dir, name):
    """Run both CLIs on ``argv``; each writes ``<name>.<pkg>``."""
    j_out, t_out = str(out_dir / f"{name}.jax"), str(out_dir / f"{name}.torch")
    jl = _run(j_cli.main, "lightgbm_tpu", argv + [f"output_model={j_out}"])
    tl = _run(t_cli.main, "lightgbm_tpu_torch",
              argv + [f"output_model={t_out}", "device=cpu"])
    return j_out, t_out, jl, tl


@pytest.fixture(scope="module")
def binary_models(files):
    argv = ["task=train", "objective=binary", f"data={files['bin_train']}",
            f"valid_data={files['bin_valid']}", "is_training_metric=true",
            "metric=auc,binary_logloss", "num_trees=5"] + COMMON
    return _both(argv, files["dir"], "binary")


def _tree_blocks(text):
    return text.split("Tree=")[1:]


def test_l2_model_file_byte_identical_under_integer_labels(files):
    argv = ["task=train", "objective=regression", "boost_from_average=false",
            f"data={files['l2_train']}", "num_trees=1"] + COMMON
    j_out, t_out, _, _ = _both(argv, files["dir"], "l2")
    with open(j_out) as fj, open(t_out) as ft:
        assert ft.read() == fj.read()


def test_binary_first_tree_and_predictions(files, binary_models):
    j_out, t_out, _, _ = binary_models
    tj, tt = open(j_out).read(), open(t_out).read()
    assert tt.split("Tree=")[0] == tj.split("Tree=")[0]
    assert _tree_blocks(tt)[0] == _tree_blocks(tj)[0]
    assert len(_tree_blocks(tt)) == len(_tree_blocks(tj)) == 5
    bj = lj.Booster(model_file=j_out)
    bt = lt.Booster(model_file=t_out, params={"device": "cpu"})
    np.testing.assert_allclose(bt.predict(files["x_valid"]),
                               bj.predict(files["x_valid"]), rtol=0,
                               atol=1e-4)


def _r_patterns():
    """The R package's eval-log regexes, read from its sources as
    ``tests/test_r_package.py`` reads them."""
    src = open(os.path.join(ROOT, "R-package", "R", "utils.R")).read()
    return [p.replace("\\\\", "\\")
            for p in re.findall(r'regexec\("((?:[^"\\]|\\.)*)"', src)]


def _eval_log(lines):
    iter_pat, part_pat = _r_patterns()
    out = {}
    for ln in lines:
        m = re.search(iter_pat, ln)
        if not m:
            continue
        for part in m.group(2).split("\t"):
            pm = re.match(part_pat, part)
            assert pm, part
            out[(int(m.group(1)), pm.group(1), pm.group(2))] = float(
                pm.group(3))
    return out


def test_eval_log_lines_match(binary_models):
    _, _, jl, tl = binary_models
    ej, et = _eval_log(jl), _eval_log(tl)
    assert len(ej) == 5 * 2 * 2
    assert et.keys() == ej.keys()
    for k in ej:
        assert abs(et[k] - ej[k]) <= 1e-4, (k, et[k], ej[k])


def _task(main, argv, device):
    argv = argv + (["device=cpu"] if device else [])
    assert main(argv) == 0


@pytest.mark.parametrize("kind", ["raw", "prob", "leaf"])
def test_predict_files(files, binary_models, kind):
    j_model = binary_models[0]
    flags = {"raw": ["is_predict_raw_score=true"], "prob": [],
             "leaf": ["is_predict_leaf_index=true"]}[kind]
    d = files["dir"]
    argv = ["task=predict", f"data={files['bin_valid']}",
            f"input_model={j_model}", "verbose=-1"] + flags
    _task(t_cli.main, argv + [f"output_result={d / f'p_{kind}.torch'}"],
          True)
    _task(j_cli.main, argv + [f"output_result={d / f'p_{kind}.jax'}"],
          False)
    got = np.loadtxt(d / f"p_{kind}.torch", ndmin=2)
    native = np.loadtxt(d / f"p_{kind}.jax", ndmin=2)
    bj = lj.Booster(model_file=j_model)
    want = np.asarray(bj.predict(files["x_valid"], raw_score=kind == "raw",
                                 pred_leaf=kind == "leaf"))
    want = want.reshape(want.shape[0], -1)
    if kind == "leaf":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, native)
        return
    if kind == "raw":
        assert (got.view(np.int64) == want.view(np.int64)).all()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got, native, rtol=1e-10)


def _model_file(files):
    """One model file both converters read: the JAX package's, with a
    categorical split among its trees."""
    path = files["dir"] / "mixed.txt"
    if not path.exists():
        rng = np.random.default_rng(3)
        x = rng.standard_normal((800, 4))
        x[:, 3] = rng.integers(0, 9, 800)
        x[rng.random(800) < 0.05, 1] = np.nan
        y = x[:, 0] + (x[:, 3] % 3 == 0) + 0.1 * rng.standard_normal(800)
        p = {"objective": "regression", "num_leaves": 7, "verbose": -1,
             "min_data_in_leaf": 5}
        lj.train(p, lj.Dataset(x, y, params=p, categorical_feature=[3]),
                 4).save_model(str(path))
    return str(path)


def test_convert_model_cpp_identical_and_compiled(files):
    model = _model_file(files)
    d = files["dir"]
    for main, name, cpu in ((j_cli.main, "jax", False),
                            (t_cli.main, "torch", True)):
        _task(main, ["task=convert_model", f"input_model={model}",
                     f"convert_model={d / f'm.{name}.cpp'}", "verbose=-1"],
              cpu)
    text = (d / "m.torch.cpp").read_text()
    assert text == (d / "m.jax.cpp").read_text()
    assert "InBitset(kCat_" in text
    so = d / "m.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(d / "m.torch.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.PredictRawAll.restype = None
    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 4))
    x[:, 3] = rng.integers(-1, 11, 300)
    x[::17, 1] = np.nan
    got = np.empty(300)
    for i in range(300):
        row = np.ascontiguousarray(x[i])
        out = np.zeros(1)
        lib.PredictRawAll(row.ctypes.data_as(ctypes.c_void_p),
                          out.ctypes.data_as(ctypes.c_void_p))
        got[i] = out[0]
    want = lt.Booster(model_file=model, params={"device": "cpu"}).predict(
        x, raw_score=True)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_dump_model_json_equal(files):
    model = _model_file(files)
    d = files["dir"]
    for main, name, cpu in ((j_cli.main, "jax", False),
                            (t_cli.main, "torch", True)):
        _task(main, ["task=dump_model", f"input_model={model}",
                     f"convert_model={d / f'dump.{name}.json'}",
                     "verbose=-1"], cpu)
    dj = json.loads((d / "dump.jax.json").read_text())
    dt = json.loads((d / "dump.torch.json").read_text())
    assert dt == dj
    assert len(dt["tree_info"]) == 5       # the average tree and 4 rounds
    # without convert_model= the dump lands beside the model
    _task(t_cli.main, ["task=dump_model", f"input_model={model}",
                       "verbose=-1"], True)
    assert json.loads(open(model + ".json").read()) == dj


def test_config_file_precedence(files):
    d = files["dir"]
    conf = d / "train.conf"
    conf.write_text("# a comment line\n"
                    "task = train\nobjective=regression  # trailing\n"
                    "num_trees=4\nnum_leaves=5\nlearning_rate=0.5\n\n"
                    "not a key value line\n")
    argv = [f"config={conf}", "num_trees=2", f"data={files['l2_train']}",
            "verbose=-1", "stray"]
    assert t_cli.parse_cli(argv) == j_cli.parse_cli(argv)
    params = t_cli.parse_cli(argv)
    assert params["num_trees"] == "2" and params["num_leaves"] == "5"
    out = d / "prec.txt"
    _task(t_cli.main, argv + [f"output_model={out}"], True)
    bst = lt.Booster(model_file=str(out), params={"device": "cpu"})
    assert bst.num_trees() == 3       # the average tree and 2 rounds
    assert max(t.num_leaves for t in bst.inner.models) <= 5


def test_unknown_task_raises(files):
    with pytest.raises(RuntimeError, match="Unknown task"):
        t_cli.main(["task=nonsense", "device=cpu"])
