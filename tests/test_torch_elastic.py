"""Elastic groups in the port (``lightgbm_tpu_torch/checkpoint.py``'s
elastic resume, ``supervisor.py:Supervisor._shrink``, the
``LGBM_TPU_WORLD`` override and the ``host_lost`` / ``stale_rejoin``
fault points), held against the JAX package (``tests/test_elastic.py``).

The byte-identity cases use integer-valued gradients: every histogram sum
is exact in float32 in any order, so "the model after a topology change
is the uninterrupted run's" is a pin, not a tolerance.

* The reassembly: the port's and the JAX package's
  ``_reassemble_elastic_state``, ``_splice_rows``, ``_overlapping`` and
  ``elastic_fingerprint_partial`` give the same results on the same
  seeded shard states and cuts.
* Across packages: a two-rank set written by the JAX package's
  ``write_group_snapshot`` resumes at one rank in the port, byte-identical
  to the serial run in both packages.
* Within the port: a two-rank set resumes at one rank (2 -> 1); a
  single-process snapshot resumes in two processes (1 -> 2); both
  byte-identical to the serial run.  A strict resume across a topology
  change is refused, naming ``elastic_resume``; a frame of a dead
  incarnation raises ``StaleEpochError``.
* The supervisor: a lost host (``host_lost@3:rank=1``) is evicted after
  ``world_shrink_after`` startup failures and the group finishes at one
  rank, byte-identical; a shrink that cannot be planned stops with
  ``mesh_plan_failed``; the shrink rewrites the machine list and sweeps
  the evicted top rank's files.
"""
import copy
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import checkpoint as jckpt
from lightgbm_tpu_torch import checkpoint as ckpt
from lightgbm_tpu_torch import supervisor as sup_mod
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu_torch.obs.counters import counters
from lightgbm_tpu_torch.parallel import mesh, sync
from lightgbm_tpu_torch.utils import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
       "JAX_PLATFORMS": "cpu"}
N = 1600
BASE = dict(objective="regression", num_leaves=15, min_data_in_leaf=10,
            learning_rate=0.5, verbose=-1, boost_from_average=False)


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.clear()
    counters.reset()
    yield
    faults.clear()


def _problem():
    rng = np.random.RandomState(7)
    x = (rng.randint(0, 24, size=(N, 8)) / 4.0).astype(np.float32)
    w = rng.randn(8)
    y = np.rint((x @ w) - np.median(x @ w)).astype(np.float32)
    return x, y


def _int_fobj(preds, ds):
    y = np.asarray(ds.get_label(), np.float32)
    g = np.clip(np.rint(np.asarray(preds, np.float64) - y), -64, 64)
    return g.astype(np.float32), np.ones_like(g, np.float32)


def _cpu(p):
    return dict(p, device="cpu")


@pytest.fixture(scope="module")
def serial5():
    """The uninterrupted 5-round serial model: the JAX package's and the
    port's, equal."""
    x, y = _problem()
    mj = lj.train(dict(BASE), lj.Dataset(x, label=y), 5, verbose_eval=False,
                  fobj=_int_fobj).model_to_string(-1)
    mt = lt.train(_cpu(BASE), lt.Dataset(x, y, params=_cpu(BASE)), 5,
                  verbose_eval=False, fobj=_int_fobj).model_to_string(-1)
    assert mt == mj
    return mt


# ---- the reassembly against the JAX package -------------------------------

def _shard_states(parts, vparts, seed=0, subset=False):
    """Seeded shard states in the JAX package's form (every key present,
    bag vectors as arrays)."""
    rng = np.random.default_rng(seed)
    out = {}
    for r, n in enumerate(parts):
        bst = {"data_fingerprint": 1000 + r, "kind": "tree",
               "models": ["tree-a", "tree-b"], "iter_": 3,
               "num_init_iteration": 0, "boost_from_average_": False,
               "best_iteration": -1,
               "scores": rng.standard_normal((2, n)).astype(np.float32),
               "valid_scores": [rng.standard_normal((2, vparts[r][v]))
                                .astype(np.float32)
                                for v in range(len(vparts[r]))],
               "bag_rng": {"state": 5}, "feat_rng": {"state": 6},
               "bagging_on": subset,
               "bag_weight": rng.integers(0, 3, n).astype(np.float32),
               "bag_cnt": rng.integers(0, 2, n).astype(np.float32),
               "subset": ({"idx": np.sort(rng.choice(n, n // 2,
                                                     replace=False)),
                           "w": rng.random(n // 2).astype(np.float32)}
                          if subset else None),
               "learning_rate": 0.1}
        out[r] = {"version": 1, "iteration": 3, "booster": bst,
                  "best_iteration": -1, "best_score": {"v": {"l2": 1.0}},
                  "evals_result": {"v": {"l2": [1.0, 0.5]}},
                  "callback_states": [{"best": 2}]}
    return out


def _equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.asarray(b).dtype
    else:
        assert a == b


CUTS = [(0, 16), (0, 5), (5, 12), (3, 9), (12, 16), (7, 8)]


@pytest.mark.parametrize("subset", [False, True], ids=["mask", "subset"])
@pytest.mark.parametrize("lo,hi", CUTS)
def test_reassemble_equals_jax(lo, hi, subset):
    """One new rank's state spliced out of three old shards of 5, 7 and 4
    rows (valid sets of 2/3/1 and 4/0/2 rows): the port's reassembly
    equals the JAX package's, key by key and array by array."""
    parts, vparts = [5, 7, 4], [[2, 4], [3, 0], [1, 2]]
    states = _shard_states(parts, vparts, seed=lo * 31 + hi, subset=subset)
    vranges = [(0, 6), (1, 5)] if (lo, hi) != (0, 16) else [(0, 6), (0, 6)]
    want = jckpt._reassemble_elastic_state(copy.deepcopy(states), parts,
                                           vparts, lo, hi, vranges)
    got = ckpt._reassemble_elastic_state(copy.deepcopy(states), parts,
                                         vparts, lo, hi, vranges)
    _equal(got, want)


@pytest.mark.parametrize("lo,hi", CUTS)
def test_splice_and_overlap_equal_jax(lo, hi):
    parts = [5, 7, 4]
    rng = np.random.default_rng(lo + 17 * hi)
    arrays = [rng.standard_normal((2, n)) for n in parts]
    assert ckpt._overlapping(parts, lo, hi) == \
        jckpt._overlapping(parts, lo, hi)
    assert ckpt._offsets(parts) == jckpt._offsets(parts)
    np.testing.assert_array_equal(
        ckpt._splice_rows(arrays, parts, lo, hi, 1),
        jckpt._splice_rows(arrays, parts, lo, hi, 1))


@pytest.mark.parametrize("offset", [0, 5, 63, 64, 130])
def test_global_fingerprint_partial_equals_jax(offset):
    """The same summand as the JAX package's from the host matrix and from
    a tensor; the ranks' partials sum to the one-rank value at any cut."""
    a = np.random.RandomState(offset).randint(0, 255, (1000, 7)) \
        .astype(np.uint8)
    want = jckpt.elastic_fingerprint_partial(a, 1000, offset)
    assert ckpt.elastic_fingerprint_partial(a, 1000, offset) == want
    assert ckpt.elastic_fingerprint_partial(torch.from_numpy(a), 1000,
                                            offset) == want
    cut = 1 + offset % 999
    whole = ckpt.elastic_fingerprint_partial(a, 1000, 0)
    parts = (ckpt.elastic_fingerprint_partial(a[:cut], cut, 0)
             + ckpt.elastic_fingerprint_partial(a[cut:], 1000 - cut, cut))
    assert parts % (1 << 64) == whole


# ---- two-rank sets resumed at one rank ------------------------------------

def _write_two_rank_set(mod, out, state, model_str, binned, it=3):
    """A committed two-rank set of ``mod``'s writer at ``it``: the serial
    run's state cut into rows [0, N/2) and [N/2, N), the shards and the
    manifest written through ``write_group_snapshot`` with an injected
    gather (the ranks' barrier payloads, as two processes ship them)."""
    half = N // 2
    infos = []
    cuts = [(0, half), (half, N)]
    states = []
    for r, (lo, hi) in enumerate(cuts):
        st = copy.deepcopy(state)
        b = st["booster"]
        b["scores"] = np.asarray(b["scores"])[:, lo:hi]
        for k in ("bag_weight", "bag_cnt"):
            if b.get(k) is not None:
                b[k] = np.asarray(b[k])[lo:hi]
        b["data_fingerprint"] = mod.data_fingerprint(binned[lo:hi], hi - lo)
        states.append(st)
        infos.append({"rank": r, "fingerprint": b["data_fingerprint"],
                      "elastic": {
                          "num_data": hi - lo, "valid_num_data": [],
                          "fp_partial": mod.elastic_fingerprint_partial(
                              binned[lo:hi], hi - lo, lo),
                          "num_features": binned.shape[1], "num_class": 1,
                          "num_leaves": 15, "max_bin": 255}})
    for r in (1, 0):      # rank 0, which commits, last
        st = states[r]
        data = mod.encode(model_str if r == 0 else "", st)
        import zlib
        infos[r]["crc"] = zlib.crc32(data)

        def gather(payload, _infos=infos):
            return [dict(i) for i in _infos]
        mod.write_group_snapshot(
            out, it, model_str if r == 0 else "", st, rank=r, world=2,
            fingerprint=infos[r]["fingerprint"], gather=gather,
            elastic_meta=infos[r]["elastic"])
    manifest = mod.load_manifest(out, it)
    assert manifest["partition_rows"] == [half, N - half]
    return manifest


def test_jax_two_rank_set_resumes_at_one_rank_in_port(tmp_path, serial5):
    """A two-rank set written by the JAX package resumes at one rank in the
    port (its trees read as the port's, its rows spliced, its global
    fingerprint re-verified): the model is the uninterrupted serial run's,
    and an ``elastic_resume`` event names the topology change."""
    x, y = _problem()
    src = str(tmp_path / "j" / "m.txt")
    lj.train(dict(BASE, output_model=src, snapshot_freq=3),
             lj.Dataset(x, label=y), 3, verbose_eval=False, fobj=_int_fobj)
    model_str, state = jckpt.load_snapshot(jckpt.snapshot_path(src, 3))
    binned = lj.Dataset(x, label=y, params=dict(BASE)).constructed.binned
    out = str(tmp_path / "set" / "m.txt")
    os.makedirs(os.path.dirname(out))
    _write_two_rank_set(jckpt, out, state, model_str, np.asarray(binned))
    p = _cpu(dict(BASE, output_model=out, elastic_resume=True))
    bst = lt.train(p, lt.Dataset(x, y, params=p), 5, verbose_eval=False,
                   fobj=_int_fobj, resume=True)
    assert bst.model_to_string(-1) == serial5
    ev = counters.events("elastic_resume")[-1]
    assert (ev["old_world"], ev["new_world"], ev["iteration"], ev["rows"],
            ev["kind"]) == (2, 1, 3, [0, N], "group")
    assert counters.get("collective_calls") == {}


def test_port_two_rank_set_resumes_at_one_rank(tmp_path, serial5):
    """2 -> 1 within the port: the port's own two-rank set (its writer, its
    shard states) resumes at one rank, byte-identical to the serial run."""
    x, y = _problem()
    src = str(tmp_path / "t" / "m.txt")
    p = _cpu(dict(BASE, output_model=src, snapshot_freq=3))
    ds = lt.Dataset(x, y, params=p)
    lt.train(p, ds, 3, verbose_eval=False, fobj=_int_fobj)
    model_str, state = ckpt.load_snapshot(ckpt.snapshot_path(src, 3))
    out = str(tmp_path / "set" / "m.txt")
    os.makedirs(os.path.dirname(out))
    _write_two_rank_set(ckpt, out, state, model_str,
                        ds.construct().constructed.binned)
    p = _cpu(dict(BASE, output_model=out, elastic_resume=True))
    bst = lt.train(p, lt.Dataset(x, y, params=p), 5, verbose_eval=False,
                   fobj=_int_fobj, resume=True)
    assert bst.model_to_string(-1) == serial5


def test_strict_resume_refuses_topology_change(tmp_path):
    """Without ``elastic_resume`` a set of another process count is a
    structured error naming the key that would accept it."""
    x, y = _problem()
    src = str(tmp_path / "t" / "m.txt")
    p = _cpu(dict(BASE, output_model=src, snapshot_freq=3))
    ds = lt.Dataset(x, y, params=p)
    lt.train(p, ds, 3, verbose_eval=False, fobj=_int_fobj)
    model_str, state = ckpt.load_snapshot(ckpt.snapshot_path(src, 3))
    out = str(tmp_path / "set" / "m.txt")
    os.makedirs(os.path.dirname(out))
    _write_two_rank_set(ckpt, out, state, model_str,
                        ds.construct().constructed.binned)

    def gather1(payload):
        ok, fatal = ckpt._local_valid_group_iters(out, 0, 1, None)
        return [{"rank": 0, "ok": ok, "fatal": fatal}]
    with pytest.raises(ckpt.CheckpointError, match="elastic_resume"):
        ckpt.find_latest_valid_group(out, rank=0, world=1, fingerprint=None,
                                     gather=gather1)


def test_repartitioned_rows_fail_the_global_fingerprint(tmp_path):
    """A group whose rows are not the set's (here a shifted row order)
    fails the global fingerprint audit, as the JAX package's."""
    x, y = _problem()
    src = str(tmp_path / "t" / "m.txt")
    p = _cpu(dict(BASE, output_model=src, snapshot_freq=3))
    ds = lt.Dataset(x, y, params=p)
    lt.train(p, ds, 3, verbose_eval=False, fobj=_int_fobj)
    model_str, state = ckpt.load_snapshot(ckpt.snapshot_path(src, 3))
    out = str(tmp_path / "set" / "m.txt")
    os.makedirs(os.path.dirname(out))
    _write_two_rank_set(ckpt, out, state, model_str,
                        ds.construct().constructed.binned)
    p = _cpu(dict(BASE, output_model=out, elastic_resume=True))
    xr, yr = np.roll(x, 1, axis=0), np.roll(y, 1)
    with pytest.raises(ckpt.CheckpointError, match="global dataset"):
        lt.train(p, lt.Dataset(xr, yr, params=p), 5, verbose_eval=False,
                 fobj=_int_fobj, resume=True)


# ---- 1 -> 2 across two processes --------------------------------------------

WORKER = r"""
import os, sys
import numpy as np
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.parallel.mesh import shutdown_distributed

rng = np.random.RandomState(7)
n = 1600
x = (rng.randint(0, 24, size=(n, 8)) / 4.0).astype(np.float32)
w = rng.randn(8)
y = np.rint((x @ w) - np.median(x @ w)).astype(np.float32)

def int_fobj(preds, ds):
    lab = np.asarray(ds.get_label(), np.float32)
    g = np.clip(np.rint(np.asarray(preds, np.float64) - lab), -64, 64)
    return g.astype(np.float32), np.ones_like(g, np.float32)

rank = int(os.environ["LGBM_TPU_RANK"])
world = int(os.environ.get("LGBM_TPU_WORLD") or 2)
lo, hi = rank * n // world, (rank + 1) * n // world
params = dict(objective="regression", num_leaves=15, min_data_in_leaf=10,
              learning_rate=0.5, verbose=-1, boost_from_average=False,
              tree_learner="data", num_machines=2, device="cpu",
              machine_list_file=os.environ["EL_MLIST"],
              output_model=os.environ["EL_OUT"], snapshot_freq=1,
              elastic_resume=True, collective_timeout=30,
              heartbeat_interval=float(os.environ.get("EL_HB", "0")),
              world_shrink_after=2)
if os.environ.get("EL_FAULT"):
    params["fault_inject"] = os.environ["EL_FAULT"]
union = lt.Dataset(x, y, params=params).construct()
share = union.subset(np.arange(lo, hi)).construct()
bst = lt.train(params, share, 5, verbose_eval=False, fobj=int_fobj,
               resume=True)
bst.save_model(os.environ["EL_OUT"] + f".final_{rank}.w{world}")
shutdown_distributed()
print("ELASTIC_WORKER_OK", rank, flush=True)
"""


def test_grow_resume_1_to_2_byte_identical(tmp_path, serial5):
    """1 -> 2: a single-process snapshot at 3 resumes in a two-process
    group over gloo, each rank reassembling its half; both ranks' models
    equal the serial run's."""
    x, y = _problem()
    out = str(tmp_path / "m.txt")
    p = _cpu(dict(BASE, output_model=out, snapshot_freq=3))
    lt.train(p, lt.Dataset(x, y, params=p), 3, verbose_eval=False,
             fobj=_int_fobj)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("127.0.0.1 0\n127.0.0.1 0\n")
    mesh.refresh_local_ports(str(mlist))
    procs = [subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, **ENV, LGBM_TPU_RANK=str(r),
                 EL_MLIST=str(mlist), EL_OUT=out)) for r in range(2)]
    for r, pr in enumerate(procs):
        o, _ = pr.communicate(timeout=240)
        assert pr.returncode == 0, f"rank {r}:\n{o[-4000:]}"
    models = [open(out + f".final_{r}.w2").read() for r in range(2)]
    assert models[0] == models[1] == serial5


# ---- the supervisor's shrink ------------------------------------------------

def test_host_lost_heals_to_smaller_world_byte_identical(tmp_path, serial5):
    """Rank 1's host is lost at iteration 3 (``host_lost@3:rank=1``) and
    its relaunches die at startup; after ``world_shrink_after=2`` of those
    the supervisor evicts it and relaunches rank 0 alone
    (``LGBM_TPU_WORLD=1``), which resumes elastically from the two-rank
    set at 2: the model is the serial run's."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("127.0.0.1 0\n127.0.0.1 0\n")
    out = str(tmp_path / "snap" / "m.txt")
    sup = sup_mod.Supervisor(
        [sys.executable, str(script)], out, 2, heartbeat_interval=0.05,
        hang_timeout=60.0, restart_limit=2, restart_backoff=0.05,
        term_grace=5.0, poll_interval=0.05,
        env=dict(ENV, EL_MLIST=str(mlist), EL_OUT=out, EL_HB="0.05",
                 EL_FAULT="host_lost@3:rank=1"),
        prelaunch=lambda s: mesh.refresh_local_ports(str(mlist)),
        elastic_resume=True, elastic_min_ranks=1, world_shrink_after=2,
        machine_list_file=str(mlist))
    box = []
    th = threading.Thread(target=lambda: box.append(sup.run()), daemon=True)
    th.start()
    th.join(240)
    if th.is_alive():
        sup.restart_limit = 0
        for rk in list(sup._ranks):
            rk.proc.kill()
        th.join(30)
        pytest.fail("the supervised group outlived 240 s")
    assert box == [0]
    ev = counters.events("rank_evicted")
    assert [e["rank"] for e in ev] == [1]
    resize = counters.events("world_resize")
    assert len(resize) == 1 and resize[0]["world"] == 1
    assert sup.world == 1 and len(mlist.read_text().splitlines()) == 1
    with open(out + ".final_0.w1") as f:
        assert f.read() == serial5
    assert set(sup.shrink_seconds) == {"teardown", "preflight", "sweep",
                                       "relaunch"}


def _manifest_set(out, rows=N, feats=8):
    """A committed manifest with the elastic keys (no shards needed by the
    supervisor's pre-flight)."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    manifest = {"version": 1, "iteration": 2, "process_count": 2,
                "shard_crc32": [0, 0], "data_fingerprint": [0, 0],
                "partition_rows": [rows // 2, rows - rows // 2],
                "valid_partition_rows": [[], []], "num_data_global": rows,
                "global_fingerprint": 0, "num_features": feats,
                "num_class": 1, "num_leaves": 255, "max_bin": 255}
    ckpt.write_atomic(ckpt.manifest_path(out, 2), ckpt.encode("", manifest))


def test_shrink_that_cannot_be_planned_stops(tmp_path):
    """The pre-flight of the smaller world through the port's
    ``plan_mesh``: with an ``hbm_budget`` nothing fits under, the shrink
    refuses (``mesh_plan_failed``) and supervision ends with 1."""
    out = str(tmp_path / "m.txt")
    _manifest_set(out, rows=10_000_000, feats=100)
    sup = sup_mod.Supervisor(["true"], out, 2, elastic_resume=True,
                             hbm_budget=1 << 20)
    sup._launch = lambda: pytest.fail("a shrink that cannot plan launched")
    assert sup._shrink(1, "rank_dead", "exit code 70", 0.0) == 1
    ev = counters.events("mesh_plan_failed")
    assert ev and ev[0]["world"] == 1 and ev[0]["evicted_rank"] == 1
    assert sup.world == 2


def test_shrink_rewrites_machine_list_and_sweeps_the_top_rank(tmp_path):
    """Evicting rank 1 of 3: its machine-list line goes, the top index's
    (rank 2's) heartbeat, crash report and flight stream go, the
    ``world_size`` / ``rank_evicted_total`` gauges and the
    ``rank_evicted`` / ``world_resize`` events say so."""
    out = str(tmp_path / "m.txt")
    stream = str(tmp_path / "fl")
    _manifest_set(out)
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("10.0.0.1 1000\n10.0.0.2 1001\n10.0.0.3 1002\n")
    files = [ckpt.heartbeat_path(out, 2), ckpt.crash_report_path(out, 2),
             stream + ".rank_2"]
    for f in files:
        with open(f, "w") as fh:
            fh.write("{}\n")
    sup = sup_mod.Supervisor(["true"], out, 3, elastic_resume=True,
                             machine_list_file=str(mlist), obs_stream=stream)
    launched = []
    sup._launch = lambda: launched.append(sup.world)
    assert sup._shrink(1, "rank_dead", "exit code 70", 0.0) is None
    assert launched == [2] and sup.world == 2 and sup.attempt == 1
    assert mlist.read_text() == "10.0.0.1 1000\n10.0.0.3 1002\n"
    assert not any(os.path.exists(f) for f in files)
    snap = counters.snapshot()["gauges"]
    assert snap["world_size"] == 2 and snap["rank_evicted_total"] == 1
    assert counters.events("rank_evicted")[0]["rank"] == 1
    assert counters.events("world_resize")[0]["world"] == 2


# ---- the fault points, the override and the keys ----------------------------

HOST_LOST = r"""
import numpy as np
import lightgbm_tpu_torch as lt
rng = np.random.RandomState(0)
x = rng.randn(200, 4)
y = (x[:, 0] > 0).astype(float)
lt.train({"objective": "binary", "num_leaves": 4, "verbose": 0,
          "device": "cpu", "fault_inject": "host_lost@2:rank=0"},
         lt.Dataset(x, y), 4, verbose_eval=False)
print("FINISHED", flush=True)
"""


@pytest.mark.parametrize("attempt,dies_at", [("0", "iteration 2"),
                                              ("1", "startup")])
def test_host_lost_fires_mid_run_and_at_every_relaunch(tmp_path, attempt,
                                                       dies_at):
    """``host_lost@2:rank=0``: the first incarnation dies hard (exit 70) at
    iteration 2; a relaunched one (``LGBM_TPU_SUPERVISOR_ATTEMPT`` > 0)
    dies at startup, before its first heartbeat."""
    script = tmp_path / "w.py"
    script.write_text(HOST_LOST)
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, **ENV, LGBM_TPU_RANK="0",
                                  LGBM_TPU_SUPERVISOR_ATTEMPT=attempt))
    assert res.returncode == 70, res.stdout + res.stderr
    assert "FINISHED" not in res.stdout
    assert "host_lost fault" in res.stderr
    assert ("at startup of attempt" in res.stderr) == (dies_at == "startup")


def test_stale_epoch_frame_rejected(monkeypatch):
    """``stale_rejoin``: a frame of the previous incarnation reaches the
    collective and the fence rejects it with both epochs, no retry burned,
    a ``stale_epoch_rejected`` event recorded (tests/test_elastic.py:216)."""
    monkeypatch.setenv(ckpt.GROUP_EPOCH_ENV, "3")
    faults.install("stale_rejoin")
    with pytest.raises(sync.StaleEpochError) as ei:
        sync.allgather_object({"probe": 1})
    assert ei.value.frame_epoch == 2 and ei.value.group_epoch == 3
    assert "epoch 2" in str(ei.value) and "epoch 3" in str(ei.value)
    assert counters.get("collective_retries") == {}
    ev = counters.events("stale_epoch_rejected")[-1]
    assert ev["op"] == "allgather_object" and ev["frame_epoch"] == 2
    faults.install("stale_rejoin")
    with pytest.raises(sync.StaleEpochError):
        sync.broadcast_object(1)


def test_world_override_skips_the_distributed_bring_up(monkeypatch,
                                                       tmp_path):
    """``LGBM_TPU_WORLD=1`` cuts ``num_machines=2`` to one process: no
    machine list is read, and a fault spec naming the evicted rank is
    accepted (lightgbm_tpu/config.py:751)."""
    monkeypatch.setenv("LGBM_TPU_WORLD", "1")
    x, y = _problem()
    p = _cpu(dict(BASE, tree_learner="data", num_machines=2,
                  machine_list_file=str(tmp_path / "absent.txt"),
                  fault_inject="host_lost@3:rank=1"))
    bst = lt.train(p, lt.Dataset(x, y, params=p), 2, verbose_eval=False,
                   fobj=_int_fobj)
    assert sync.process_count() == 1 and bst.current_iteration() == 2


def test_elastic_armed_single_process_zero_collectives(tmp_path):
    """Elastic resume alone adds no host-object collective (the JAX
    package's comm-audit pin, tests/test_elastic.py:267)."""
    rng = np.random.RandomState(0)
    x = rng.randn(300, 6)
    y = (x @ rng.randn(6) > 0).astype(np.float64)
    out = str(tmp_path / "m.txt")
    p = dict(objective="binary", num_leaves=7, verbose=-1, device="cpu",
             telemetry=True, snapshot_freq=2, output_model=out,
             elastic_resume=True, preempt_signal="sigterm")
    lt.train(p, lt.Dataset(x, y, params=p), 4, verbose_eval=False,
             resume=True)
    counters.reset()
    lt.train(p, lt.Dataset(x, y, params=p), 4, verbose_eval=False,
             resume=True)
    assert counters.events("elastic_resume")
    assert counters.get("collective_calls") == {}


@pytest.mark.parametrize("key,value,message", [
    ("elastic_min_ranks", 0, "elastic_min_ranks must be >= 1"),
    ("world_shrink_after", 0, "world_shrink_after must be >= 1"),
])
def test_elastic_keys_checked_as_jax(key, value, message):
    with pytest.raises(RuntimeError, match=message):
        config_from_params({key: value})
    with pytest.raises(Exception, match=message):
        lj.config.config_from_params({key: value})
    cfg = config_from_params({"elastic_resume": "true", key: 3})
    assert cfg.elastic_resume is True and getattr(cfg, key) == 3
