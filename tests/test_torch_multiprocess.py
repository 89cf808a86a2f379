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
* Block-sharded bins (``mode=block``: two CPU slots a rank, the global
  ``mesh_shape=2x2``, ``shard_axes=batch,feature``, each rank a 1x2 mesh
  of its own rows): identical on both ranks, with even halves and with
  1,400 and 1,600 rows; byte-identical to the in-process block-sharded and
  replicated 2x2 models, and under integer gradients to the serial one;
  predictions within 1e-4 of the JAX package's block-sharded 2x2 learner
  on the union; ``mesh_shape=auto`` under a budget from the port's
  ``predict_hbm`` plans the block-sharded 2x2 mesh.
* ``mesh_shape`` over two processes of two slots each resolves, or is
  refused, as the JAX package decides (no process spawned), and the
  voting and feature learners over processes take the 1-D mesh whatever
  ``mesh_shape`` and ``shard_axes`` say (in the spawned runs too).
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


def int_fobj(preds, data):
    # integer-valued gradients and hessians that follow the scores: every
    # sum is exact in any order
    q = np.floor(np.asarray(preds, np.float64) * 8.0)
    return (np.where(data.get_label() > 0, -3.0, 2.0) + np.mod(q, 5.0) - 2.0,
            1.0 + np.mod(q, 3.0))


def mesh_of(bst):
    plan, g = bst.inner.mesh_plan, bst.inner._gspmd
    return dict(plan=[plan.data, plan.feature, plan.block_shard_bins],
                local=[g.mesh.shape["batch"], g.mesh.shape["feature"]],
                block=g.block is not None, route_bins=g.route_bins is not None,
                cols=[[c.start, c.stop] for c in g.cols],
                pad=bst.inner._row_pad)


if mode in ("data", "voting"):
    p = dict(base, tree_learner=mode, top_k=3)
    bst = lt.train(p, lt.Dataset(X[lo:hi], y[lo:hi], params=p), 5)
    assert sync.process_count() == 2 and bst.inner.dist_backend == "gloo"
    assert bst.inner._gspmd.procs.count == 2
    bst.save_model(out)
    if mode == "voting":
        # the shard_map learner's 1-D mesh: neither key is read
        pb = dict(p, mesh_shape="2x2", shard_axes="batch,feature")
        b2 = lt.train(pb, lt.Dataset(X[lo:hi], y[lo:hi], params=pb), 5)
        m = mesh_of(b2)
        assert m["plan"] == [2, 1, False] and not m["block"], m
        assert b2.model_to_string() == bst.model_to_string()
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
    # the shard_map learner's 1-D mesh: neither key is read
    pb = dict(p, mesh_shape="2x2", shard_axes="batch,feature")
    b2 = lt.train(pb, lt.Dataset(X, y, params=pb), 5)
    m = mesh_of(b2)
    assert m["plan"] == [1, 2, False] and not m["block"], m
    assert b2.model_to_string() == bst.model_to_string()
    done()

if mode == "block":
    # two CPU slots a process and the global 2x2 mesh, block-sharded:
    # each rank a 1x2 mesh over its own rows; over even halves, then over
    # ranks of 1,400 and 1,600 rows; then mesh_shape=auto under a budget
    # that only the block-sharded 2x2 layout meets
    import json
    from lightgbm_tpu_torch.boosting import _model_layout
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.obs.memory import predict_hbm
    from lightgbm_tpu_torch.parallel.mesh import mesh_slots
    p = dict(base, tree_learner="data", mesh_devices=2, mesh_shape="2x2",
             shard_axes="batch,feature")
    res = {}
    for tag, (a, b) in (("even", (lo, hi)),
                        ("uneven", (0, 1400) if rank == 0 else (1400, n))):
        ds = lt.Dataset(X[a:b], y[a:b], params=p)
        bst = lt.train(p, ds, 5)
        res[tag] = dict(mesh_of(bst), model=bst.model_to_string(),
                        integer=lt.train(p, ds, 3, fobj=int_fobj)
                        .model_to_string())
    # the auto run holds the first 2,998 rows: in the memory model a 4x1
    # mesh over even shards costs what the block-sharded 2x2 does, and
    # the data learner's walk takes 4x1 first; 1,499 rows a rank pad the
    # 4x1 mesh's two local shards, whose padded copy makes it dearer
    n2 = 2998
    a, b = (0, n2 // 2) if rank == 0 else (n2 // 2, n2)
    pa = dict(base, tree_learner="data", mesh_devices=2)
    cfg = config_from_params(pa)
    ds = lt.Dataset(X[a:b], y[a:b], params=pa)
    ds.construct(cfg, "cpu", on_device=False)
    cpu = torch.device("cpu")
    layout = dict(_model_layout(cfg, ds.constructed, create_objective(cfg),
                                cpu, mesh_slots(2, cpu), True),
                  rows=n2, processes=2)
    peak = lambda d, f, blk: predict_hbm(
        data_shards=d, feature_shards=f, block_shard_bins=blk,
        **layout)["peak_bytes"]
    budget = peak(2, 2, True)
    assert budget < min(peak(4, 1, False), peak(2, 2, False)), (
        budget, peak(4, 1, False), peak(2, 2, False))
    bst = lt.train(dict(pa, hbm_budget=budget), ds, 5)
    res["auto"] = dict(mesh_of(bst), model=bst.model_to_string(),
                       budget=int(budget), reason=bst.inner.mesh_plan.reason)
    with open(out, "w") as f:
        json.dump(res, f)
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


@pytest.fixture(scope="module")
def block_runs(tmp_path_factory):
    """The two ranks of the block-sharded worker (mode ``block``): each
    rank's results, by run (``even``, ``uneven``, ``auto``)."""
    import json
    paths = _run_workers(tmp_path_factory.mktemp("block"), "block")
    return [json.loads(p.read_text()) for p in paths]


@pytest.fixture(scope="module")
def block_in_process():
    """The port's in-process 2x2 learner over four CPU slots, block-sharded
    and replicated, under the binary objective and integer gradients, and
    the serial learner under the integer gradients."""
    x, y, _ = _grid_problem()
    p = dict(BASE, tree_learner="data", mesh_devices=4, mesh_shape="2x2",
             device="cpu")
    out = {}
    pa = dict(p, shard_axes="batch,feature")
    out["auto"] = lt.train(pa, lt.Dataset(x[:2998], y[:2998], params=pa),
                           5).model_to_string()
    for sa in ("batch,feature", "batch"):
        ps = dict(p, shard_axes=sa)
        ds = lt.Dataset(x, y, params=ps)
        out[sa] = lt.train(ps, ds, 5).model_to_string()
        out[sa + ":integer"] = lt.train(ps, ds, 3,
                                        fobj=_int_fobj).model_to_string()
    ps = dict(BASE, device="cpu")
    out["serial:integer"] = lt.train(ps, lt.Dataset(x, y, params=ps), 3,
                                     fobj=_int_fobj).model_to_string()
    return out


def _int_fobj(preds, data):
    """The worker's integer gradients (``int_fobj``)."""
    q = np.floor(np.asarray(preds, np.float64) * 8.0)
    return (np.where(data.get_label() > 0, -3.0, 2.0) + np.mod(q, 5.0) - 2.0,
            1.0 + np.mod(q, 3.0))


@pytest.mark.parametrize("run", ["even", "uneven", "auto"])
def test_block_sharded_ranks_agree(block_runs, run):
    """Each rank a 1x2 mesh of the global block-sharded 2x2 one, routing
    its own rows over its own slices; the ranks' column slices line up and
    their models are identical, also with 1,400 and 1,600 rows."""
    r0, r1 = (r[run] for r in block_runs)
    for r in (r0, r1):
        assert r["plan"] == [2, 2, True], r["plan"]
        assert r["local"] == [1, 2] and r["block"] and not r["route_bins"]
    assert r0["cols"] == r1["cols"] == [[0, 4], [4, 8]]
    assert r0["model"] == r1["model"]
    if run != "auto":
        assert r0["integer"] == r1["integer"]


def test_block_sharded_equals_one_process(block_runs, block_in_process):
    """Byte for byte: the two processes' model equals the in-process
    block-sharded and replicated 2x2 models; under integer gradients, the
    serial model too, with even and uneven ranks; and ``mesh_shape=auto``
    under the budget planned the block-sharded 2x2 mesh and trained the
    same model as the in-process 2x2 block-sharded learner over the same
    2,998 rows."""
    r0 = block_runs[0]
    ref = block_in_process
    assert r0["even"]["model"] == ref["batch,feature"] == ref["batch"]
    assert r0["auto"]["model"] == ref["auto"]
    assert "bins block-sharded" in r0["auto"]["reason"]
    for run in ("even", "uneven"):
        assert r0[run]["integer"] == ref["batch,feature:integer"] \
            == ref["batch:integer"] == ref["serial:integer"], run


def test_block_sharded_predicts_as_the_jax_package(block_runs):
    """The two processes' predictions within 1e-4 of the JAX package's
    block-sharded 2x2 learner on the union, over four of the 8 virtual CPU
    devices (test_torch_block_shard.py's tolerance)."""
    x, y, _ = _grid_problem()
    pj = dict(BASE, tree_learner="data", mesh_devices=4, mesh_shape="2x2",
              shard_axes="batch,feature")
    bj = lj.train(pj, lj.Dataset(x, y, params=pj), 5, verbose_eval=False)
    for run in ("even", "uneven"):
        got = lt.Booster(model_str=block_runs[0][run]["model"],
                         params=dict(device="cpu")).predict(x)
        np.testing.assert_allclose(got, bj.predict(x), rtol=0, atol=1e-4)


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


def _planned(monkeypatch, **params):
    """``boosting.plan_training``'s mesh for the first half of the grid
    rows as one of two processes of two CPU slots each, with no process
    spawned: the process count is 2 and the allgather returns this
    process's values twice.  A refusal is ``(its type, its words)``."""
    from lightgbm_tpu_torch.boosting import plan_training
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.parallel import sync
    from lightgbm_tpu_torch.parallel.mesh import MeshPlanError
    x, y, _ = _grid_problem()
    p = dict(BASE, mesh_devices=2, device="cpu", **params)
    cfg = config_from_params(p)
    ds = lt.Dataset(x[:1500], y[:1500], params=p)
    ds.construct(cfg, "cpu", on_device=False)
    monkeypatch.setattr(sync, "process_count", lambda: 2)
    monkeypatch.setattr(sync, "allgather_object", lambda obj: [obj, obj])
    try:
        return plan_training(cfg, ds.constructed, create_objective(cfg),
                             torch.device("cpu")).mesh
    except (ValueError, MeshPlanError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", ["2x2", "4x1", "2x1", "1x4", "data",
                                  "feature", "1x2", "4x2"])
def test_mesh_shape_reads_over_every_process(monkeypatch, spec):
    """``mesh_shape`` over two processes of two slots each names the global
    extents, or is refused, as the JAX package decides
    (``lightgbm_tpu/boosting.py:887-912``: ``parse_mesh_shape`` over every
    process's devices, then ``mesh_shape_fits_processes``)."""
    from lightgbm_tpu.parallel import mesh as jax_mesh
    try:
        want = jax_mesh.parse_mesh_shape(spec, 4, "data")
        refusal = jax_mesh.mesh_shape_fits_processes(*want, 2, 2)
        if refusal is not None:
            want = ("MeshPlanError", f"mesh_shape={spec} cannot serve "
                    f"2-process training: {refusal}")
    except ValueError as e:
        want = ("ValueError", str(e))
    got = _planned(monkeypatch, tree_learner="data", mesh_shape=spec,
                   shard_axes="batch,feature")
    if isinstance(want, tuple) and isinstance(want[0], str):
        assert got == want
        return
    assert (got.data, got.feature, got.block_shard_bins) == (*want, True)


@pytest.mark.parametrize("learner,shape", [("voting", (4, 1)),
                                           ("feature", (1, 4))])
def test_shard_map_learners_take_the_1d_mesh(monkeypatch, learner, shape):
    """Over several processes the voting and feature learners are the JAX
    package's shard_map learners, whose mesh is 1-D over every process's
    devices: ``mesh_shape`` and ``shard_axes=batch,feature`` change
    nothing."""
    got = _planned(monkeypatch, tree_learner=learner, mesh_shape="2x2",
                   shard_axes="batch,feature")
    assert (got.data, got.feature, got.block_shard_bins) == (*shape, False)


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
