"""The port's supervisor (``lightgbm_tpu_torch/supervisor.py``) and its
liveness machinery, as ``tests/test_supervisor.py`` holds the JAX
package's: heartbeat files, crash reports, the sweeps, the hang timeout's
composition, the rank qualifier of fault specs, and supervised groups
of real processes over gloo on the CPU:

* one rank of a two-process data-parallel group killed hard
  (``rank_crash@4:rank=1``), or wedged (``rank_hang@4:rank=1``, its peer
  surfacing a ``CollectiveError`` from the snapshot barrier and leaving a
  crash report): the supervisor restarts the group, both ranks resume from
  the last committed set, and the model is byte-identical on both ranks
  and to the in-process learner over the same two row shards;
* a crash loop with no forward progress spends the restart budget;
* a previous job's leftovers are swept before the first launch.

And the collectives across two real processes: a fault injected before a
collective is issued is retried on the one rank it hit, a corrupted
payload on every rank at the same call, and a collective that gloo timed
out is not retried: its group's connections are closed, and the next
collective fails at once on both ranks.

Every test that spawns processes has a deadline of its own
(:func:`_bounded`, or its processes' ``communicate`` timeout).
"""
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import checkpoint as ckpt
from lightgbm_tpu_torch import supervisor as sup_mod
from lightgbm_tpu_torch.obs.counters import counters
from lightgbm_tpu_torch.parallel import mesh
from lightgbm_tpu_torch.utils import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
       "OMP_NUM_THREADS": "2"}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _small(seed=0, n=300):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6)
    return x, (x @ rng.randn(6) > 0).astype(np.float64)


# ------------------------------------------------------------ heartbeats

def test_heartbeat_stamp_roundtrip_and_throttle(tmp_path):
    path = str(tmp_path / "m.txt.heartbeat.rank_0")
    hb = ckpt.Heartbeat(path, interval=30.0)
    hb.stamp(3, force=True)
    it, age = ckpt.read_heartbeat(path)
    assert it == 3 and 0 <= age < 5.0
    hb.stamp(4)                      # throttled: 30 s not elapsed
    assert ckpt.read_heartbeat(path)[0] == 3
    hb.stamp(5, force=True)
    assert ckpt.read_heartbeat(path)[0] == 5
    assert ckpt.read_heartbeat(str(tmp_path / "nope")) is None
    with open(path, "w") as f:
        f.write("not json")
    assert ckpt.read_heartbeat(path) is None


def test_slow_heartbeat_fault_suppresses_writes(tmp_path):
    path = str(tmp_path / "m.txt.heartbeat.rank_0")
    hb = ckpt.Heartbeat(path, interval=0.0)
    faults.install("slow_heartbeat")
    hb.stamp(1, force=True)
    assert not os.path.exists(path)
    faults.clear()
    hb.stamp(2, force=True)
    assert ckpt.read_heartbeat(path)[0] == 2


def test_heartbeat_zero_added_collectives(tmp_path):
    """Heartbeats, snapshots and the preemption watch on the no-failure
    path add no host-object collective."""
    x, y = _small()
    out = str(tmp_path / "m.txt")
    counters.reset()
    lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
              "device": "cpu", "snapshot_freq": 2, "output_model": out,
              "heartbeat_interval": 0.001, "preempt_signal": "sigterm"},
             lt.Dataset(x, y), 4, verbose_eval=False, resume=True)
    assert counters.get("collective_calls") == {}
    got = ckpt.read_heartbeat(ckpt.heartbeat_path(out, 0))
    assert got is not None and got[0] == 4


# -------------------------------------------------------- crash reports

def test_write_crash_report_contents(tmp_path):
    counters.reset()
    counters.event("group_restart", attempt=1)
    out = str(tmp_path / "m.txt")
    try:
        raise RuntimeError("the poisoned iteration")
    except RuntimeError as e:
        path = ckpt.write_crash_report(out, 1, exc=e)
    assert path == ckpt.crash_report_path(out, 1)
    text = open(path).read()
    assert "the poisoned iteration" in text
    assert "test_write_crash_report_contents" in text
    assert "group_restart" in text


def test_engine_writes_crash_report_on_abnormal_exit(tmp_path):
    x, y = _small(1)
    out = str(tmp_path / "m.txt")
    with pytest.raises(lt.NonFiniteError):
        lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                  "device": "cpu", "heartbeat_interval": 0.001,
                  "output_model": out, "fault_inject": "nan_grad@2"},
                 lt.Dataset(x, y), 4, verbose_eval=False)
    text = open(ckpt.crash_report_path(out, 0)).read()
    assert "NonFiniteError" in text and "iteration 2" in text


# ------------------------------------------------------------ the sweeps

def test_sweep_stale_tmp_dead_pid_only(tmp_path):
    counters.reset()
    out = str(tmp_path / "m.txt")
    dead = str(tmp_path / ".m.txt.snapshot_iter_4.rank_1.tmp.r1.999999999")
    live = str(tmp_path / f".m.txt.snapshot_iter_4.rank_0.tmp.r0.{os.getpid()}")
    other = str(tmp_path / "unrelated.txt")
    for p in (dead, live, other):
        with open(p, "w") as f:
            f.write("x")
    assert ckpt.sweep_stale_tmp(out) == [dead]
    assert os.path.exists(live) and os.path.exists(other)
    evs = counters.events("stale_sweep")
    assert len(evs) == 1 and "dead pid" in evs[0]["reason"]


def test_sweep_orphan_crash_reports_and_heartbeats(tmp_path):
    out = str(tmp_path / "m.txt")
    for p in (ckpt.crash_report_path(out, 0), ckpt.heartbeat_path(out, 1)):
        with open(p, "w") as f:
            f.write("old")
    assert ckpt.sweep_stale_tmp(out) == []
    removed = ckpt.sweep_stale_tmp(out, crash_reports=True, heartbeats=True)
    assert sorted(removed) == sorted([ckpt.crash_report_path(out, 0),
                                      ckpt.heartbeat_path(out, 1)])


def test_sweep_by_epoch_keeps_the_live_incarnation(tmp_path):
    """``current_epoch`` sweeps the liveness files stamped by a dead
    incarnation and keeps the current one's."""
    out = str(tmp_path / "m.txt")
    old = ckpt.Heartbeat(ckpt.heartbeat_path(out, 0), 0.0)
    old.stamp(1, force=True)                       # epoch 0 (no variable)
    os.environ[ckpt.GROUP_EPOCH_ENV] = "2"
    try:
        ckpt.Heartbeat(ckpt.heartbeat_path(out, 1), 0.0).stamp(1, force=True)
        ckpt.write_crash_report(out, 1)
    finally:
        del os.environ[ckpt.GROUP_EPOCH_ENV]
    removed = ckpt.sweep_stale_tmp(out, current_epoch=2)
    assert removed == [ckpt.heartbeat_path(out, 0)]
    assert os.path.exists(ckpt.crash_report_path(out, 1))


def test_group_resume_sweeps_stale_tmp_orphan_free(tmp_path):
    import zlib
    out = str(tmp_path / "m.txt")
    world, fps = 2, [11, 22]

    def write_gather(payload):
        return [{"rank": r, "fingerprint": fps[r],
                 "crc": zlib.crc32(open(ckpt.shard_path(out, 2, r),
                                        "rb").read())}
                for r in range(world)
                if os.path.exists(ckpt.shard_path(out, 2, r))]

    for r in (1, 0):
        ckpt.write_group_snapshot(out, 2, "tree\n" if r == 0 else "",
                                  {"version": 1, "iteration": 2, "rank": r},
                                  rank=r, world=world, fingerprint=fps[r],
                                  gather=write_gather)
    stale = str(tmp_path / ".m.txt.snapshot_iter_4.rank_1.tmp.r1.999999999")
    with open(stale, "w") as f:
        f.write("half")

    def resume_gather(payload):
        return [dict(zip(("ok", "fatal"),
                         ckpt._local_valid_group_iters(out, r, world,
                                                       fps[r])), rank=r)
                for r in range(world)]

    it, _, _ = ckpt.find_latest_valid_group(out, rank=0, world=world,
                                            fingerprint=fps[0],
                                            gather=resume_gather)
    assert it == 2 and not os.path.exists(stale)
    assert [p for p in os.listdir(tmp_path) if ".tmp.r" in p] == []


def test_latest_committed_iteration(tmp_path):
    out = str(tmp_path / "m.txt")
    assert ckpt.latest_committed_iteration(out) is None
    ckpt.write_atomic(ckpt.snapshot_path(out, 2),
                      ckpt.encode("tree\n", {"version": 1, "iteration": 2}))
    assert ckpt.latest_committed_iteration(out) == 2
    torn = ckpt.encode("tree\n", {"version": 1, "iteration": 6})
    with open(ckpt.snapshot_path(out, 6), "wb") as f:
        f.write(torn[:len(torn) // 2])
    assert ckpt.latest_committed_iteration(out) == 2
    ckpt.write_atomic(ckpt.manifest_path(out, 4),
                      ckpt.encode("", {"version": 1, "iteration": 4,
                                       "process_count": 2,
                                       "shard_crc32": [0, 0],
                                       "data_fingerprint": [0, 0]}))
    assert ckpt.latest_committed_iteration(out) == 4


# ---------------------------------------------- composition and parameters

def test_effective_hang_timeout_composes_with_collective_timeout():
    from lightgbm_tpu import supervisor as jsup
    for args in ((60.0, 1.0, 5.0, 2), (2.0, 0.5, 5.0, 1), (0.0, 1.0, None)):
        assert sup_mod.effective_hang_timeout(*args) == \
            jsup.effective_hang_timeout(*args)
    assert sup_mod.effective_hang_timeout(2.0, 0.5, 5.0, 1) == \
        pytest.approx(5.0 * 2 + 0.5 + 1.0)
    assert sup_mod.effective_hang_timeout(0.0, 1.0, None) == \
        sup_mod.DEFAULT_HANG_TIMEOUT


@pytest.mark.parametrize("bad", [
    {"heartbeat_interval": -1}, {"hang_timeout": -2}, {"restart_limit": -1},
    {"restart_backoff": -0.5}, {"heartbeat_interval": 5, "hang_timeout": 2},
    {"collective_retries": -1}, {"preempt_signal": "sigkill"},
    {"fault_inject": "rank_crash@3:rank=1"}])
def test_config_validates_liveness_params_as_jax(bad):
    """Each value the JAX package's config refuses, the port's refuses
    with the same message."""
    from lightgbm_tpu.config import config_from_params as jcfg
    from lightgbm_tpu_torch.config import config_from_params as tcfg
    with pytest.raises(Exception) as je:
        jcfg(bad)
    with pytest.raises(RuntimeError) as te:
        tcfg(bad)
    assert str(te.value) == str(je.value)


def test_fault_rank_qualifier_parse():
    es = faults.parse_spec("rank_crash@3:rank=1")
    assert (es[0].point, es[0].iteration, es[0].rank) == ("rank_crash", 3, 1)
    for bad in ("rank_crash@3:rank=x", "rank_crash:cpu=1",
                "rank_crash:rank=-2"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)
    # parsed the same way in both packages
    spec = "rank_hang@2:rank=1,slow_heartbeat_once,host_lost@5:rank=0"
    mine = [(e.point, e.iteration, e.once, e.rank)
            for e in faults.parse_spec(spec)]
    theirs = [(e.point, e.iteration, e.once, e.rank)
              for e in lj.utils.faults.parse_spec(spec)]
    assert mine == theirs


def test_fault_rank_qualifier_targets_one_rank(monkeypatch):
    plan = faults.FaultPlan("rank_hang@2:rank=1,slow_heartbeat:rank=0")
    monkeypatch.setenv("LGBM_TPU_RANK", "0")
    assert not plan.fire("rank_hang", 2)
    assert plan.fire("slow_heartbeat")
    monkeypatch.setenv("LGBM_TPU_RANK", "1")
    assert plan.fire("rank_hang", 2)
    assert not plan.fire("slow_heartbeat")


# ------------------------------------------------- supervised groups

SUP_WORKER = r"""
import os
import numpy as np
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.parallel.mesh import shutdown_distributed

rank = int(os.environ["LGBM_TPU_RANK"])
first = os.environ.get("LGBM_TPU_SUPERVISOR_ATTEMPT", "0") == "0"
rng = np.random.RandomState(7)
n, f = 3000, 8
X = (rng.randint(0, 24, size=(n, f)) / 4.0).astype(np.float32)
w = rng.randn(f)
y = ((X @ w + 2.0 * rng.randn(n)) > np.median(X @ w)).astype(np.float32)
lo, hi = (0, n // 2) if rank == 0 else (n // 2, n)
params = dict(objective="binary", num_leaves=15, min_data_in_leaf=10,
              learning_rate=0.2, verbose=-1, tree_learner="data",
              num_machines=2, machine_list_file=os.environ["TEST_MLIST"],
              snapshot_freq=2, output_model=os.environ["TEST_SNAP"],
              heartbeat_interval=0.05, collective_timeout=3,
              collective_retries=0, device="cpu")
fault = os.environ.get("TEST_FAULT", "")
if fault and first:
    # only the first incarnation is poisoned: the restarted group recovers
    params["fault_inject"] = fault
bst = lt.train(params, lt.Dataset(X[lo:hi], y[lo:hi], params=params), 6,
               verbose_eval=False, resume=True)
bst.save_model(os.environ["TEST_OUT"] + f".rank{rank}.txt")
shutdown_distributed()
print("WORKER_DONE", rank, flush=True)
"""


def _grid_problem():
    rng = np.random.RandomState(7)
    n, f = 3000, 8
    x = (rng.randint(0, 24, size=(n, f)) / 4.0).astype(np.float32)
    w = rng.randn(f)
    y = ((x @ w + 2.0 * rng.randn(n)) > np.median(x @ w)).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def in_process_ref():
    """The in-process data learner over the same two row shards (2x1 CPU
    slots), whose model the two processes' equals (tests/
    test_torch_multiprocess.py)."""
    x, y = _grid_problem()
    p = dict(objective="binary", num_leaves=15, min_data_in_leaf=10,
             learning_rate=0.2, verbose=-1, tree_learner="data",
             mesh_devices=2, mesh_shape="2x1", device="cpu")
    return lt.train(p, lt.Dataset(x, y, params=p), 6).model_to_string()


def _bounded(sup, seconds: float) -> int:
    """``sup.run()`` under a deadline of its own: past it the ranks are
    killed with no restart left, and the test fails."""
    box = []
    t = threading.Thread(target=lambda: box.append(sup.run()), daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        sup.restart_limit = 0
        for rk in list(sup._ranks):
            rk.proc.kill()
        t.join(30)
        pytest.fail(f"the supervised group outlived {seconds} s")
    return box[0]


def _run_supervised_pair(tmp_path, fault):
    """One supervised two-process group under ``fault``: (exit code, the
    ranks' model texts or None)."""
    script = tmp_path / "sup_worker.py"
    script.write_text(SUP_WORKER)
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("127.0.0.1 0\n127.0.0.1 0\n")     # prelaunch binds
    snap, out = str(tmp_path / "snap" / "m.txt"), str(tmp_path / "model")
    sup = sup_mod.Supervisor(
        [sys.executable, str(script)], snap, 2,
        heartbeat_interval=0.05, hang_timeout=60.0, restart_limit=2,
        restart_backoff=0.05, term_grace=8.0, poll_interval=0.05,
        env=dict(ENV, TEST_MLIST=str(mlist), TEST_SNAP=snap, TEST_OUT=out,
                 TEST_FAULT=fault),
        prelaunch=lambda s: mesh.refresh_local_ports(str(mlist)))
    rc = _bounded(sup, 180)
    models = [out + f".rank{r}.txt" for r in range(2)]
    return rc, [open(m).read() if os.path.exists(m) else None
                for m in models]


@pytest.mark.parametrize("fault", ["rank_crash@4:rank=1",
                                   "rank_hang@4:rank=1"],
                         ids=["kill", "hang"])
def test_supervisor_two_process_fault_byte_identical(tmp_path, fault,
                                                     in_process_ref):
    """Rank 1 of a two-process group is killed hard at iteration 4 (or
    wedges there, its peer's snapshot barrier failing after
    ``collective_timeout`` with a crash report).  The supervisor tears the
    group down, relaunches it, both ranks resume from the set committed at
    2, and the model is byte-identical on both ranks and to the in-process
    learner's."""
    counters.reset()
    rc, (m0, m1) = _run_supervised_pair(tmp_path, fault)
    assert rc == 0, "the supervisor did not heal the group"
    dead = counters.events("rank_dead")
    if fault.startswith("rank_crash"):
        assert dead and dead[0]["rank"] == 1 and dead[0]["exit_code"] == 70
    else:
        assert dead and dead[0]["rank"] == 0        # the in-band failure
        assert any(e["rank"] == 0 for e in counters.events("crash_report"))
    restarts = counters.events("group_restart")
    assert len(restarts) == 1 and restarts[0]["resume_iteration"] == 2
    assert m0 is not None and m0 == m1 == in_process_ref


def test_supervisor_restart_budget_exhausted(tmp_path):
    """A crash loop with no forward progress (``rank_crash`` at every
    boundary) spends ``restart_limit`` and the supervisor returns 1."""
    counters.reset()
    script = tmp_path / "worker.py"
    script.write_text(
        "import os\n"
        "import numpy as np\n"
        "import lightgbm_tpu_torch as lt\n"
        "rng = np.random.RandomState(0)\n"
        "X = rng.randn(200, 5)\n"
        "y = (X @ rng.randn(5) > 0).astype(np.float64)\n"
        "lt.train({'objective': 'binary', 'num_leaves': 4, 'verbose': -1,\n"
        "          'device': 'cpu', 'snapshot_freq': 2,\n"
        "          'output_model': os.environ['OUT'],\n"
        "          'heartbeat_interval': 0.05, 'fault_inject': 'rank_crash'},\n"
        "         lt.Dataset(X, y), 6, verbose_eval=False, resume=True)\n")
    out = str(tmp_path / "run" / "m.txt")
    sup = sup_mod.Supervisor([sys.executable, str(script)], out, 1,
                             heartbeat_interval=0.05, hang_timeout=60.0,
                             restart_limit=1, restart_backoff=0.05,
                             term_grace=2.0, poll_interval=0.05,
                             env=dict(ENV, OUT=out))
    assert _bounded(sup, 90) != 0
    evs = counters.events("restart_budget_exhausted")
    assert len(evs) == 1 and evs[0]["limit"] == 1
    assert len(counters.events("rank_dead")) == 2
    assert len(counters.events("group_restart")) == 1
    # each incarnation stamped the epoch it was launched under
    assert ckpt.read_group_epoch_file(out) == 1


def test_supervisor_startup_sweep_is_orphan_free(tmp_path):
    counters.reset()
    out = str(tmp_path / "m.txt")
    stale = str(tmp_path / ".m.txt.snapshot_iter_2.rank_0.tmp.r0.999999999")
    for p in (stale, ckpt.crash_report_path(out, 0),
              ckpt.heartbeat_path(out, 0)):
        with open(p, "w") as f:
            f.write("old")
    script = tmp_path / "noop.py"
    script.write_text("")
    sup = sup_mod.Supervisor([sys.executable, str(script)], out, 1,
                             poll_interval=0.02)
    assert _bounded(sup, 30) == 0
    for p in (stale, ckpt.crash_report_path(out, 0),
              ckpt.heartbeat_path(out, 0)):
        assert not os.path.exists(p), p
    assert len(counters.events("stale_sweep")) >= 3


# ------------------------------------------- collectives across two processes

LADDER_WORKER = r"""
import os, sys, time
import lightgbm_tpu_torch  # noqa: F401
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu_torch.obs.counters import counters
from lightgbm_tpu_torch.parallel import sync
from lightgbm_tpu_torch.parallel.mesh import (init_distributed_from_config,
                                              shutdown_distributed)
from lightgbm_tpu_torch.utils import faults

rank = int(os.environ["LGBM_TPU_RANK"])
mode = os.environ["TEST_MODE"]
init_distributed_from_config(config_from_params(dict(
    num_machines=2, tree_learner="data", device="cpu",
    machine_list_file=os.environ["TEST_MLIST"], collective_timeout=3)))

if mode == "retry":
    # a fault before the collective is issued, on rank 1 only: rank 1
    # retries and meets rank 0's call; then a payload corrupted on both
    # ranks at the same call: both fail the CRC check and retry together
    faults.install("collective_fail_once:rank=1")
    assert sync.allgather_object(("a", rank)) == [("a", 0), ("a", 1)]
    want = {"op=allgather_object": 1} if rank == 1 else {}
    assert counters.get("collective_retries") == want, counters.get(
        "collective_retries")
    faults.install("collective_corrupt_once")
    assert sync.allgather_object({"r": rank}) == [{"r": 0}, {"r": 1}]
    assert sync.broadcast_object("b" if rank == 0 else None) == "b"
    assert counters.total("collective_retries") == (2 if rank == 1 else 1)
    shutdown_distributed()
    print("WORKER_OK", rank, flush=True)
    sys.exit(0)

if mode == "timeout":
    # rank 1 joins late: rank 0's collective times out, is not retried,
    # and every later collective of the group fails at once on both ranks
    if rank == 1:
        time.sleep(5)
    t0 = time.time()
    try:
        sync.allgather_object(rank)
        raise SystemExit("the late collective succeeded")
    except sync.CollectiveError as e:
        assert "allgather_object" in str(e), e
    assert counters.get("collective_retries") == {}
    t1 = time.time()
    try:
        sync.allgather_object(("again", rank))
        raise SystemExit("a collective after the timeout succeeded")
    except sync.CollectiveError as e:
        assert "not retried" in str(e), e
    assert time.time() - t1 < 2.0, time.time() - t1
    shutdown_distributed()
    print("WORKER_OK", rank, flush=True)
    sys.exit(0)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("mode", ["retry", "timeout"])
def test_collectives_across_two_processes(tmp_path, mode):
    mlist = tmp_path / "mlist.txt"
    mlist.write_text(f"127.0.0.1 {_free_port()}\n127.0.0.1 {_free_port()}\n")
    script = tmp_path / "worker.py"
    script.write_text(LADDER_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, **ENV, LGBM_TPU_RANK=str(r),
                 TEST_MLIST=str(mlist), TEST_MODE=mode))
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=90)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a worker hung (mode={mode})")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in out, out[-3000:]
