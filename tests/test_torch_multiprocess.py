"""Training over several processes (``num_machines=2``, a machine list of
two loopback ports) with ``torch.distributed`` over gloo on the CPU: two
worker processes, spawned as tests/test_multiprocess.py spawns the JAX
package's, each one rank.

* Data, voting and feature learners: the model text is identical on both
  ranks, and byte-identical to the port's in-process learner over the same
  rows (two row shards, 2x1; the feature learner two column slices, 1x2),
  whose two partial sums are the ranks' all-reduced pair; the data
  learner's predictions within 1e-3 of the JAX package's serial model on
  the union (tests/test_multiprocess.py's bound).
* A regression run's ``boost_from_average`` (the processes' label sums
  added) is the same on both ranks, and its predictions within 1e-5 of
  the in-process learner's, whose one label sum rounds otherwise.
* A file both ranks share: each keeps the rows of one draw of
  ``lightgbm_tpu.utils.random.make_rng(data_random_seed)``, and a Dataset
  built before the parallel parameters is rebuilt.
* Distributed FindBin (each rank fits every second feature, the mappers
  allgathered; rank 0's bundles broadcast) equals the serial fit.
* The feature learner fed each rank's own rows fails with the JAX
  package's "FULL identical dataset" message.
* A non-finite gradient on one rank only trips the guard on both.
* A collective that a rank never joins raises ``CollectiveError`` naming
  the operation after ``collective_timeout``; the machine list, the rank
  and the backend's choice.

Each worker run takes a few seconds; the file runs on one xdist worker.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.utils.random import make_rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
import numpy as np
import torch

rank = int(os.environ["LGBM_TPU_RANK"])
mlist = os.environ["TEST_MLIST"]
out = os.environ["TEST_OUT"]
mode = os.environ["TEST_MODE"]

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu_torch.parallel import sync

rng = np.random.RandomState(7)
n, f = 3000, 8
# a grid of 24 values: both halves hold every value, so the mappers fitted
# from either half, or from both, are the same
X = (rng.randint(0, 24, size=(n, f)) / 4.0).astype(np.float32)
w = rng.randn(f)
y = ((X @ w + 2.0 * rng.randn(n)) > np.median(X @ w)).astype(np.float32)
lo, hi = (0, n // 2) if rank == 0 else (n // 2, n)
base = dict(objective="binary", num_leaves=15, min_data_in_leaf=10,
            learning_rate=0.2, verbose=-1, num_machines=2,
            machine_list_file=mlist, device="cpu")


def done():
    # the group torn down before the interpreter exits, so that no gloo
    # thread outlives it
    from lightgbm_tpu_torch.parallel.mesh import shutdown_distributed
    shutdown_distributed()
    print("WORKER_OK", rank, flush=True)
    sys.exit(0)


if mode in ("data", "voting"):
    p = dict(base, tree_learner=mode, top_k=3)
    bst = lt.train(p, lt.Dataset(X[lo:hi], y[lo:hi], params=p), 5)
    assert sync.process_count() == 2 and bst.inner.dist_backend == "gloo"
    assert bst.inner._gspmd.procs.count == 2
    bst.save_model(out)
    yr = (X @ w).astype(np.float32) + np.linspace(0, 3, n, dtype=np.float32)
    pr = dict(p, objective="regression", num_leaves=7)
    lt.train(pr, lt.Dataset(X[lo:hi], yr[lo:hi], params=pr), 2).save_model(
        out + ".reg")
    done()

if mode == "feature":
    p = dict(base, tree_learner="feature")
    bst = lt.train(p, lt.Dataset(X, y, params=p), 5)
    assert bst.inner.parallel_impl == "shardmap"
    assert bst.inner._gspmd.procs.axis == "feature"
    bst.save_model(out)
    done()

if mode == "feature_bad":
    p = dict(base, tree_learner="feature")
    try:
        lt.train(p, lt.Dataset(X[lo:hi], y[lo:hi], params=p), 2)
    except RuntimeError as e:
        assert "FULL identical dataset" in str(e), e
        done()
    print("NO_ERROR: per-process rows were accepted", flush=True)
    sys.exit(1)

if mode == "sharedfile":
    p = dict(base, tree_learner="data")
    d = lt.Dataset(os.environ["TEST_DATA"], params=p)
    if os.environ.get("TEST_EARLY") == "1":
        # built before the parallel parameters reach it: all rows
        d.construct(config_from_params(dict(device="cpu", verbose=-1)))
        assert d.num_data() == n
    bst = lt.train(p, d, 5)
    np.save(out + ".rows.npy", d.raw)
    bst.save_model(out)
    done()

if mode == "findbin":
    # both ranks hold the same rows: the distributed fit equals the serial
    from lightgbm_tpu_torch.data.dataset import construct
    from lightgbm_tpu_torch.parallel.mesh import init_distributed_from_config
    cfg = config_from_params(dict(base, tree_learner="data", max_bin=63))
    assert init_distributed_from_config(cfg) == "gloo"
    assert sync.process_count() == 2
    r = np.random.RandomState(11)
    Xf = np.where(r.rand(5000, 6) < 0.3, 0.0, r.randn(5000, 6))
    Xf[:, 0] = r.randint(0, 9, size=5000)
    Xf[:, 5] = np.where(Xf[:, 4] != 0, 0.0, Xf[:, 5])   # exclusive: a bundle
    yf = (Xf.sum(1) > 0).astype(np.float32)
    dist = construct(Xf, cfg, label=yf)
    real = sync.process_count
    sync.process_count = lambda: 1
    serial = construct(Xf, cfg, label=yf)
    sync.process_count = real
    a = [m.feature_info_str() for m in dist.bin_mappers]
    assert a == [m.feature_info_str() for m in serial.bin_mappers], a
    assert dist.bundled and dist.layout.bundles == serial.layout.bundles
    assert np.array_equal(dist.binned, serial.binned)
    done()

if mode == "nonfinite":
    # clamp: rank 1's third gradients hold a NaN, rank 0's never do; both
    # ranks trip the guard once and train the same trees
    calls = [0]

    def fobj(preds, data):
        calls[0] += 1
        lab = data.get_label()
        prob = 1.0 / (1.0 + np.exp(-preds))
        g, h = prob - lab, prob * (1.0 - prob)
        if rank == 1 and calls[0] == 3:
            g[5] = np.nan
        return g, h
    p = dict(base, tree_learner="data", nonfinite_policy="clamp")
    bst = lt.train(p, lt.Dataset(X[lo:hi], y[lo:hi], params=p), 5,
                   fobj=fobj)
    assert bst.inner.stats["nonfinite_trips"] == 1, bst.inner.stats
    bst.save_model(out)
    done()

if mode == "timeout":
    # rank 1 never joins the collective: rank 0's raises CollectiveError
    # naming it once the group's timeout passes
    import time
    from lightgbm_tpu_torch.parallel.mesh import (
        distributed_is_initialized, init_distributed_from_config,
        shutdown_distributed)
    assert init_distributed_from_config(config_from_params(dict(
        base, tree_learner="data", collective_timeout=3))) == "gloo"
    if rank == 1:
        time.sleep(8)
        done()
    try:
        sync.allgather_object(rank)
    except sync.CollectiveError as e:
        assert "allgather_object" in str(e), e
        shutdown_distributed()
        assert not distributed_is_initialized()
        done()      # a second teardown is a no-op
    print("NO_ERROR: the collective did not fail", flush=True)
    sys.exit(1)

raise SystemExit(f"unknown mode {mode}")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmp_path, mode, extra_env=None):
    """The two ranks of ``mode``; each must exit 0 with WORKER_OK."""
    mlist = tmp_path / "mlist.txt"
    mlist.write_text(f"127.0.0.1 {_free_port()}\n127.0.0.1 {_free_port()}\n")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env.update(LGBM_TPU_RANK=str(rank), TEST_MLIST=str(mlist),
                   TEST_OUT=str(tmp_path / f"model_{rank}.txt"),
                   TEST_MODE=mode, OMP_NUM_THREADS="2", **(extra_env or {}))
        procs.append(subprocess.Popen([sys.executable, str(script)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      env=env))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a worker hung (mode={mode})")
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"WORKER_OK {rank}" in out
    return [(tmp_path / f"model_{r}.txt") for r in range(2)]


def _grid_problem():
    """The workers' rows (the JAX test's grid)."""
    rng = np.random.RandomState(7)
    n, f = 3000, 8
    x = (rng.randint(0, 24, size=(n, f)) / 4.0).astype(np.float32)
    w = rng.randn(f)
    y = ((x @ w + 2.0 * rng.randn(n)) > np.median(x @ w)).astype(np.float32)
    yr = (x @ w).astype(np.float32) + np.linspace(0, 3, n, dtype=np.float32)
    return x, y, yr


BASE = dict(objective="binary", num_leaves=15, min_data_in_leaf=10,
            learning_rate=0.2, verbose=-1)


def _in_process(learner, shape, y=None, rounds=5, **extra):
    """The port's learner in one process over two CPU slots."""
    x, yb, _ = _grid_problem()
    p = dict(BASE, tree_learner=learner, mesh_devices=2, mesh_shape=shape,
             device="cpu", top_k=3, **extra)
    return lt.train(p, lt.Dataset(x, yb if y is None else y, params=p),
                    rounds)


@pytest.mark.parametrize("learner,shape", [("data", "2x1"),
                                           ("voting", "2x1")])
def test_rows_learners_agree_across_ranks_and_with_one_process(
        tmp_path, learner, shape):
    m0, m1 = (p.read_text() for p in _run_workers(tmp_path, learner))
    assert m0 == m1, "the ranks disagreed on the model"
    assert m0.count("Tree=") == 5
    assert m0 == _in_process(learner, shape).model_to_string()
    r0, r1 = ((tmp_path / f"model_{r}.txt.reg").read_text()
              for r in range(2))
    assert r0 == r1, "boost_from_average diverged across ranks"
    # the label sums of the two halves, added, round otherwise than the
    # sum of all labels: the start score agrees to float32's precision
    x, y, yr = _grid_problem()
    one = _in_process(learner, shape, y=yr, rounds=2, objective="regression",
                      num_leaves=7)
    np.testing.assert_allclose(
        lt.Booster(model_str=r0, params=dict(device="cpu")).predict(x),
        one.predict(x), rtol=0, atol=1e-5)
    if learner == "data":
        bj = lj.train(BASE, lj.Dataset(x, y, params=BASE), 5,
                      verbose_eval=False)
        np.testing.assert_allclose(lt.Booster(model_str=m0, params=dict(
            device="cpu")).predict(x[:500]), bj.predict(x[:500]),
            rtol=1e-3, atol=1e-3)


def test_feature_learner_agrees_across_ranks_and_with_one_process(
        tmp_path):
    m0, m1 = (p.read_text() for p in _run_workers(tmp_path, "feature"))
    assert m0 == m1
    assert m0 == _in_process("feature", "1x2").model_to_string()


def test_feature_learner_rejects_rows_of_their_own(tmp_path):
    _run_workers(tmp_path, "feature_bad")


@pytest.mark.parametrize("early", [False, True], ids=["lazy", "early"])
def test_shared_file_rows_are_one_draw(tmp_path, early):
    x, y, _ = _grid_problem()
    path = tmp_path / "shared.tsv"
    np.savetxt(path, np.column_stack([y, x]), delimiter="\t", fmt="%.6g")
    m = _run_workers(tmp_path, "sharedfile", {
        "TEST_DATA": str(path), "TEST_EARLY": "1" if early else "0"})
    assert m[0].read_text() == m[1].read_text()
    assign = make_rng(1).integers(0, 2, size=len(y))
    for r in range(2):
        rows = np.load(str(m[r]) + ".rows.npy")
        np.testing.assert_array_equal(rows, x[assign == r].astype(rows.dtype))


def test_distributed_findbin_equals_serial(tmp_path):
    _run_workers(tmp_path, "findbin")


def test_nonfinite_on_one_rank_trips_both(tmp_path):
    m0, m1 = (p.read_text() for p in _run_workers(tmp_path, "nonfinite"))
    assert m0 == m1


def test_timed_out_collective_names_the_operation(tmp_path):
    _run_workers(tmp_path, "timeout")


def test_bring_up_helpers(tmp_path, monkeypatch):
    """The machine list (``ip port`` lines), the rank from
    ``LGBM_TPU_RANK``, the backend from the layout, and a teardown that
    is a no-op without a group."""
    from lightgbm_tpu_torch.parallel import mesh
    path = tmp_path / "mlist.txt"
    path.write_text("10.0.0.1 12400\n10.0.0.1 12401\n\n10.0.0.2 12400\n")
    machines = mesh.parse_machine_list(str(path))
    assert machines == [("10.0.0.1", 12400), ("10.0.0.1", 12401),
                        ("10.0.0.2", 12400)]
    monkeypatch.setenv("LGBM_TPU_RANK", "2")
    assert mesh._local_rank(machines) == 2
    monkeypatch.delenv("LGBM_TPU_RANK")
    assert mesh._local_rank(machines) is None       # no local address
    loop = [("127.0.0.1", 1), ("127.0.0.1", 2)]
    assert mesh._local_rank(loop) is None            # two local entries
    assert mesh.choose_backend(machines, 1, torch.device("cpu")) == (
        "gloo", 1)
    assert mesh.choose_backend(machines, 2, torch.device("cpu")) == (
        "gloo", 0)
    assert not mesh.distributed_is_initialized()
    mesh.shutdown_distributed()
    assert lt.train(dict(BASE, device="cpu"), lt.Dataset(
        *_grid_problem()[:2]), 1).inner.dist_backend is None
