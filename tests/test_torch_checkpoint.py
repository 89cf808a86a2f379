"""Resumable training checkpoints of the port (``lightgbm_tpu_torch/
checkpoint.py``), its fault points and its collectives' ladder, held
against the JAX package where both write or read the same thing.

* The file format: ``encode`` of the same model text and a state of
  builtins and numpy arrays gives the same bytes in both packages, and
  each package's ``decode`` reads the other's framing; the data
  fingerprint is the same integer for the same Dataset.
* The resume choice: ``find_latest_valid`` and ``find_latest_valid_group``
  pick the same iteration in both packages on the same directory of
  torn, valid and manifest-less files (the group function through the JAX
  tests' injected gather, each package's local scan).
* A snapshot's model text, under integer-valued gradients, equals the JAX
  package's snapshot's at the same iteration.
* A crash and resume (a torn snapshot at 6, resume from 4) is byte-identical
  to the uninterrupted run on the serial, data-parallel (4x1 slots),
  feature (1x2), block-sharded (2x2), voting, DART, bagging, GOSS,
  multiclass and ``data_stream=chunked`` paths.
* The port's versions of ``tests/test_robustness.py``'s retention,
  preemption (the ``preempt`` point, a real SIGTERM, a second SIGTERM or
  SIGINT), retry-ladder, corruption and group-set cases.

``hist_fail``: on the CPU a wrapper checks the point when it is called,
which these tests drive through ``train``; on a card the graph loop
checks it at the start of each replayed step instead, which
:func:`test_hist_fail_checked_at_replayed_step_start` drives with a
stand-in graph (a capture needs a card).
"""
import os
import signal
import zlib

import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import checkpoint as jckpt
from lightgbm_tpu_torch import checkpoint as ckpt
from lightgbm_tpu_torch.obs.counters import counters
from lightgbm_tpu_torch.parallel import sync
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.faults import InjectedFault, SimulatedCrash


@pytest.fixture(autouse=True)
def _clean_faults():
    """No test leaks an armed fault plan or a ladder budget into the next."""
    faults.clear()
    sync.configure(retries=2)
    yield
    faults.clear()
    sync.configure(retries=2)


def _small():
    rng = np.random.RandomState(0)
    x = rng.randn(600, 10)
    w = rng.randn(10)
    y = (x @ w + 0.3 * rng.randn(600) > 0).astype(np.float64)
    return x, y


X, Y = _small()


def _datasets(x=X, y=Y):
    train = lt.Dataset(x, y, free_raw_data=False)
    return train, train.create_valid(x[:200], y[:200])


def _params(out=None, **kw):
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "device": "cpu"}
    if out is not None:
        p.update({"bagging_fraction": 0.4, "bagging_freq": 2,
                  "feature_fraction": 0.8, "snapshot_freq": 2,
                  "output_model": str(out)})
    p.update(kw)
    return p


# ------------------------------------------------------------ the format

def test_encode_bytes_equal_jax_and_decode_crosswise():
    state = {"version": 1, "iteration": 4, "blob": np.arange(7),
             "scores": np.linspace(-1, 1, 12, dtype=np.float32).reshape(2, 6),
             "nested": [1.5, None, {"a": (1, 2)}, "text"], "flag": True}
    model = "tree\nversion=v2\nnum_class=1\n"
    ours, theirs = ckpt.encode(model, state), jckpt.encode(model, state)
    assert ours == theirs
    for decode, data in ((ckpt.decode, theirs), (jckpt.decode, ours)):
        model_str, got = decode(data)
        assert model_str == model
        assert got["iteration"] == 4 and got["nested"] == state["nested"]
        np.testing.assert_array_equal(got["scores"], state["scores"])


def test_checkpoint_roundtrip_and_integrity():
    state = {"version": 1, "iteration": 4, "blob": np.arange(7)}
    data = ckpt.encode("tree\nnum_class=1\n", state)
    model_str, got = ckpt.decode(data)
    assert model_str.startswith("tree") and got["iteration"] == 4
    for cut in (1, len(data) // 2, len(data) - 2):
        with pytest.raises(ckpt.CheckpointError):
            ckpt.decode(data[:cut])
    corrupt = bytearray(data)
    corrupt[len(data) // 3] ^= 0xFF
    with pytest.raises(ckpt.CheckpointError):
        ckpt.decode(bytes(corrupt))


@pytest.mark.parametrize("max_bin", [63, 300])
def test_data_fingerprint_equals_jax(max_bin):
    """The same integer as the JAX package's for the same bins (uint8, and
    uint16 past 256 bins), from the host matrix and from a tensor."""
    import torch
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3000, 4))
    y = (x[:, 0] > 0).astype(np.float64)
    p = dict(max_bin=max_bin, min_data_in_bin=1, verbose=-1)
    ours = lt.Dataset(x, y, params=dict(p, device="cpu")).construct()
    theirs = lj.Dataset(x, y, params=p).constructed
    want = jckpt.data_fingerprint(theirs.binned, theirs.num_data)
    td = ours.constructed
    assert ckpt.data_fingerprint(td.binned, td.num_data) == want
    assert ckpt.data_fingerprint(ours.bins, td.num_data) == want
    assert ours.bins.dtype == (torch.uint8 if max_bin < 256
                               else torch.uint16)


# ------------------------------------------------- the resume choice vs JAX

WORLD = 2
FPS = [1111, 2222]


def _write_gather(out, it):
    """The commit barrier's stand-in: the shards' CRCs read off disk."""
    def gather(payload):
        infos = []
        for r in range(WORLD):
            p = ckpt.shard_path(out, it, r)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    infos.append({"rank": r, "crc": zlib.crc32(f.read()),
                                  "fingerprint": FPS[r]})
        return infos
    return gather


def _resume_gather(mod, out, fps=None, world=WORLD):
    """The resume barrier's stand-in (the JAX tests'): every rank's local
    scan by ``mod``'s own ``_local_valid_group_iters``."""
    fps = fps or FPS

    def gather(payload):
        return [dict(zip(("ok", "fatal"),
                         mod._local_valid_group_iters(out, r, world,
                                                      fps[r])),
                     rank=r) for r in range(world)]
    return gather


def _write_set(out, it, ranks=(1, 0)):
    for r in ranks:
        ckpt.write_group_snapshot(
            out, it, "tree\n" if r == 0 else "",
            {"version": 1, "iteration": it, "rank": r},
            rank=r, world=WORLD, fingerprint=FPS[r],
            gather=_write_gather(out, it))


def _tear(path):
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])


def _append(path):
    with open(path, "ab") as f:
        f.write(b"x")


def _plain(out, it, torn=False):
    data = ckpt.encode("tree\n", {"version": 1, "iteration": it})
    with open(ckpt.snapshot_path(out, it), "wb") as f:
        f.write(data[:len(data) // 2] if torn else data)


SCENARIOS = {
    "valid_sets": lambda out: [_write_set(out, 2), _write_set(out, 4)],
    "torn_shard_rank1": lambda out: [_write_set(out, 2), _write_set(out, 4),
                                     _tear(ckpt.shard_path(out, 4, 1))],
    "torn_manifest": lambda out: [_write_set(out, 2), _write_set(out, 4),
                                  _tear(ckpt.manifest_path(out, 4))],
    "manifest_less": lambda out: [_write_set(out, 2), _write_set(out, 4),
                                  _write_set(out, 6, ranks=(1,))],
    "crc_mismatch": lambda out: [_write_set(out, 2), _write_set(out, 4),
                                 _append(ckpt.shard_path(out, 4, 0))],
    "nothing_valid": lambda out: [_write_set(out, 2),
                                  _tear(ckpt.manifest_path(out, 2))],
    "plain_torn_newest": lambda out: [_plain(out, 2), _plain(out, 4),
                                      _plain(out, 6, torn=True)],
    "plain_all_torn": lambda out: [_plain(out, 2, torn=True)],
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_resume_choice_equals_jax(tmp_path, case):
    out = str(tmp_path / "m.txt")
    SCENARIOS[case](out)
    mine, theirs = ckpt.find_latest_valid(out), jckpt.find_latest_valid(out)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert mine[:2] == theirs[:2] and mine[2] == theirs[2]
    for r in range(WORLD):
        got = [mod.find_latest_valid_group(
            out, rank=r, world=WORLD, fingerprint=FPS[r],
            gather=_resume_gather(mod, out)) for mod in (ckpt, jckpt)]
        assert (got[0] is None) == (got[1] is None), case
        if got[0] is not None:
            assert got[0][:2] == got[1][:2] and got[0][2] == got[1][2]


# ------------------------------------------------- group sets (test_robustness)

def test_group_snapshot_roundtrip(tmp_path):
    out = str(tmp_path / "m.txt")
    _write_set(out, 2)
    _write_set(out, 4)
    for r in range(WORLD):
        it, path, state = ckpt.find_latest_valid_group(
            out, rank=r, world=WORLD, fingerprint=FPS[r],
            gather=_resume_gather(ckpt, out))
        assert it == 4 and state["rank"] == r
        assert path == ckpt.shard_path(out, 4, r)
    man = ckpt.load_manifest(out, 4)
    assert man["process_count"] == WORLD and man["data_fingerprint"] == FPS


def test_torn_shard_on_one_rank_demotes_group(tmp_path):
    counters.reset()
    out = str(tmp_path / "m.txt")
    _write_set(out, 2)
    _write_set(out, 4)
    _tear(ckpt.shard_path(out, 4, 1))
    for r in range(WORLD):
        it, _, state = ckpt.find_latest_valid_group(
            out, rank=r, world=WORLD, fingerprint=FPS[r],
            gather=_resume_gather(ckpt, out))
        assert it == 2 and state["iteration"] == 2
    evs = counters.events("checkpoint_skipped")
    assert any(e["iteration"] == 4 and "CRC" in e["reason"] for e in evs)
    assert any("demoted" in e["reason"] for e in evs)


def test_topology_mismatch_is_structured_error(tmp_path):
    out = str(tmp_path / "m.txt")
    _write_set(out, 2)
    with pytest.raises(ckpt.CheckpointError, match="process"):
        ckpt.find_latest_valid_group(
            out, rank=0, world=3, fingerprint=FPS[0],
            gather=lambda p: [dict(zip(("ok", "fatal"),
                                       ckpt._local_valid_group_iters(
                                           out, 0, 3, FPS[0])), rank=0)])


def test_partition_fingerprint_mismatch_is_structured_error(tmp_path):
    out = str(tmp_path / "m.txt")
    _write_set(out, 2)
    with pytest.raises(ckpt.CheckpointError, match="fingerprint"):
        ckpt.find_latest_valid_group(
            out, rank=0, world=WORLD, fingerprint=FPS[0],
            gather=_resume_gather(ckpt, out, fps=[9999, FPS[1]]))


def test_torn_manifest_fault_demotes_to_previous_set(tmp_path):
    out = str(tmp_path / "m.txt")
    _write_set(out, 2)
    faults.install("torn_manifest@4")
    with pytest.raises(SimulatedCrash, match="torn_manifest"):
        _write_set(out, 4)
    faults.clear()
    assert os.path.exists(ckpt.manifest_path(out, 4))
    it, _, _ = ckpt.find_latest_valid_group(
        out, rank=0, world=WORLD, fingerprint=FPS[0],
        gather=_resume_gather(ckpt, out))
    assert it == 2


@pytest.mark.parametrize("point", ["rank_crash_in_barrier", "torn_shard_rank"])
def test_rank_dying_before_the_barrier_never_commits(tmp_path, point):
    out = str(tmp_path / "m.txt")
    _write_set(out, 2)
    faults.install(f"{point}@4")
    with pytest.raises(SimulatedCrash, match=point):
        _write_set(out, 4, ranks=(0,))
    faults.clear()
    assert os.path.exists(ckpt.shard_path(out, 4, 0))
    assert not os.path.exists(ckpt.manifest_path(out, 4))
    it, _, _ = ckpt.find_latest_valid_group(
        out, rank=0, world=WORLD, fingerprint=FPS[0],
        gather=_resume_gather(ckpt, out))
    assert it == 2


def test_explicit_group_resume_pins_one_set(tmp_path):
    out = str(tmp_path / "m.txt")
    _write_set(out, 2)
    _write_set(out, 4)
    it, _, _ = ckpt.find_latest_valid_group(
        out, rank=0, world=WORLD, fingerprint=FPS[0],
        gather=_resume_gather(ckpt, out),
        only_iteration=ckpt.iteration_from_path(ckpt.shard_path(out, 2, 0)))
    assert it == 2
    with pytest.raises(ckpt.CheckpointError, match="not valid"):
        ckpt.find_latest_valid_group(
            out, rank=0, world=WORLD, fingerprint=FPS[0],
            gather=_resume_gather(ckpt, out), only_iteration=3)


def test_prune_is_set_aware_no_orphans(tmp_path):
    out = str(tmp_path / "m.txt")
    for it in (2, 4, 6):
        _write_set(out, it)
    ckpt.write_atomic(ckpt.snapshot_path(out, 3),
                      ckpt.encode("tree\n", {"version": 1, "iteration": 3}))
    ckpt.prune_snapshots(out, 2)
    assert sorted(os.listdir(tmp_path)) == [
        "m.txt.snapshot_iter_4.manifest", "m.txt.snapshot_iter_4.rank_0",
        "m.txt.snapshot_iter_4.rank_1",
        "m.txt.snapshot_iter_6.manifest", "m.txt.snapshot_iter_6.rank_0",
        "m.txt.snapshot_iter_6.rank_1"]


def test_write_atomic_tmp_name_is_rank_keyed(tmp_path, monkeypatch):
    seen = []
    real_replace = os.replace

    def spy(src, dst):
        seen.append(os.path.basename(src))
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    monkeypatch.setattr(ckpt, "_process_index", lambda: 0)
    ckpt.write_atomic(str(tmp_path / "f"), b"a")
    monkeypatch.setattr(ckpt, "_process_index", lambda: 1)
    ckpt.write_atomic(str(tmp_path / "f"), b"b")
    assert seen == [f".f.tmp.r0.{os.getpid()}", f".f.tmp.r1.{os.getpid()}"]


# ------------------------------------------- snapshots and JAX's model text

def _int_fobj(seed):
    """Integer-valued gradients and hessians, seeded by call: exact sums
    in any order, the same sequence in both packages."""
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(seed + calls[0])
        calls[0] += 1
        n = len(preds)
        return (rng.integers(-3, 4, n).astype(np.float64),
                rng.integers(1, 4, n).astype(np.float64))
    return fobj


def test_snapshot_model_text_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1024, 6))
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    p = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
             verbose=-1, enable_bundle=False, enable_bin_packing=False,
             snapshot_freq=2)
    oj, ot = str(tmp_path / "j" / "m.txt"), str(tmp_path / "t" / "m.txt")
    lj.train(dict(p, output_model=oj), lj.Dataset(x, y, params=p), 4,
             fobj=_int_fobj(11), verbose_eval=False)
    pt = dict(p, output_model=ot, device="cpu")
    lt.train(pt, lt.Dataset(x, y, params=pt), 4, fobj=_int_fobj(11),
             verbose_eval=False)
    for it in (2, 4):
        mj, sj = jckpt.load_snapshot(jckpt.snapshot_path(oj, it))
        mt, st = ckpt.load_snapshot(ckpt.snapshot_path(ot, it))
        assert mt == mj, it
        assert st["iteration"] == sj["iteration"] == it
        assert st["booster"]["iter_"] == sj["booster"]["iter_"]
        assert st["booster"]["data_fingerprint"] == \
            sj["booster"]["data_fingerprint"]


# ------------------------------------------------------- crash and resume

PATHS = {
    "serial": {},
    "data_4x1": dict(tree_learner="data", mesh_devices=4, mesh_shape="4x1"),
    "voting_4x1": dict(tree_learner="voting", top_k=3, mesh_devices=4,
                       mesh_shape="4x1"),
    "feature_1x2": dict(tree_learner="feature", mesh_devices=2,
                        mesh_shape="1x2"),
    "block_2x2": dict(tree_learner="data", mesh_devices=4, mesh_shape="2x2",
                      shard_axes="batch,feature"),
    "dart": dict(boosting_type="dart", drop_rate=0.5, skip_drop=0.0),
    "bagging_mask": dict(bagging_fraction=0.8, bagging_freq=1),
    "goss": dict(boosting_type="goss", top_rate=0.3, other_rate=0.2,
                 learning_rate=0.5),
    "multiclass": dict(objective="multiclass", num_class=3),
    "chunked": dict(data_stream="chunked", stream_chunk_rows=128),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_crash_resume_byte_identical(tmp_path, path):
    """A torn snapshot at 6 (``SimulatedCrash``), resume skips it and
    continues from 4; the model text equals the uninterrupted run's, its
    evaluation history and early-stopping best too."""
    extra = dict(PATHS[path])
    y = Y if extra.get("objective") != "multiclass" else \
        np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float64)
    if path == "chunked":   # the subset regime is off when streamed
        extra.update(bagging_fraction=0.8)
    kw = dict(verbose_eval=False, early_stopping_rounds=50)

    def run(out, **more):
        tr, va = _datasets(X, y)
        ev = {}
        bst = lt.train(_params(out, **extra, **more), tr, 8,
                       valid_sets=[va], evals_result=ev, **kw)
        return bst, ev

    ref, ev_ref = run(tmp_path / "a" / "m.txt")
    out = tmp_path / "b" / "m.txt"
    with pytest.raises(SimulatedCrash):
        run(out, fault_inject="torn_checkpoint@6")
    assert os.path.exists(ckpt.snapshot_path(str(out), 6))
    counters.reset()
    got, ev = run(out, snapshot_resume=True)
    assert got.model_to_string() == ref.model_to_string()
    assert ev == ev_ref and got.best_iteration == ref.best_iteration
    res = counters.events("checkpoint_resume")
    assert [e["iteration"] for e in res] == [4]
    assert any(e["iteration"] == 6 for e in
               counters.events("checkpoint_skipped"))


def test_resume_from_explicit_path_and_fresh_start(tmp_path):
    out = str(tmp_path / "m.txt")
    tr, va = _datasets()
    ref = lt.train(_params(out), tr, 6, valid_sets=[va],
                   verbose_eval=False).model_to_string()
    tr, va = _datasets()
    got = lt.train(_params(out), tr, 6, valid_sets=[va], verbose_eval=False,
                   resume=ckpt.snapshot_path(out, 4))
    assert got.model_to_string() == ref
    tr, va = _datasets()
    fresh = lt.train(_params(str(tmp_path / "fresh" / "m.txt")), tr, 6,
                     valid_sets=[va], verbose_eval=False, resume=True)
    assert fresh.model_to_string() == ref


def test_resume_onto_other_data_raises(tmp_path):
    out = str(tmp_path / "m.txt")
    tr, _ = _datasets()
    lt.train(_params(out), tr, 4, verbose_eval=False)
    other = lt.Dataset(X[::-1].copy(), Y[::-1].copy(), free_raw_data=False)
    with pytest.raises(ckpt.CheckpointError, match="fingerprint"):
        lt.train(_params(out), other, 6, verbose_eval=False, resume=True)


def test_snapshot_is_still_a_valid_model_file(tmp_path):
    out = str(tmp_path / "m.txt")
    tr, _ = _datasets()
    bst = lt.train(_params(out), tr, 4, verbose_eval=False)
    loaded = lt.Booster(model_file=ckpt.snapshot_path(out, 4),
                        params=dict(device="cpu"))
    np.testing.assert_array_equal(loaded.predict(X[:16]),
                                  bst.predict(X[:16]))


def test_snapshot_keep_prunes_retention(tmp_path):
    out = str(tmp_path / "m.txt")
    tr, _ = _datasets()
    lt.train(_params(out, snapshot_keep=2), tr, 8, verbose_eval=False)
    assert [it for it, _ in ckpt.list_snapshots(out)] == [6, 8]


def test_snapshot_state_reads_device_once_per_snapshot(tmp_path):
    """The snapshot copies the scores, the valid scores, the bag and the
    fingerprint's sample once each; iterations between snapshots read
    nothing more."""
    out = str(tmp_path / "m.txt")
    tr, va = _datasets()
    bst = lt.train(_params(out, snapshot_freq=4), tr, 8, valid_sets=[va],
                   verbose_eval=False)
    # two snapshots: scores, valid scores, the subset's rows and weights,
    # the count weights and the fingerprint's sample
    assert bst.inner.stats["snapshot_host_reads"] == 2 * 6


# ------------------------------------------------------------ fault points

def test_fault_spec_parsing_and_known_points():
    plan = faults.FaultPlan("nan_grad@3,collective_fail_once,hist_fail")
    assert not plan.fire("nan_grad", 2)
    assert plan.fire("nan_grad", 3) and not plan.fire("nan_grad", 3)
    assert plan.fire("collective_fail") and not plan.fire("collective_fail")
    assert plan.fire("hist_fail") and plan.fire("hist_fail")
    assert faults.KNOWN_POINTS == lj.utils.faults.KNOWN_POINTS
    for bad in ("no_such_point", "nan_grad@x"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)
    with pytest.raises(RuntimeError, match="unknown point"):
        lt.train(_params(fault_inject="bogus_point"), _datasets()[0], 1)
    assert faults.get_faults() is faults.NULL_FAULTS   # scoped, restored


@pytest.mark.parametrize("spec,iteration", [("nan_grad@3", 3),
                                            ("inf_hess@1", 1)])
def test_gradient_fault_points_trip_the_guard(spec, iteration):
    with pytest.raises(lt.NonFiniteError, match=f"iteration {iteration}"):
        lt.train(_params(fault_inject=spec), _datasets()[0], 6,
                 verbose_eval=False)
    bst = lt.train(_params(fault_inject=spec, nonfinite_policy="rollback"),
                   _datasets()[0], 6, verbose_eval=False)
    assert bst.inner.stats["nonfinite_trips"] == 1
    assert np.isfinite(bst.predict(X, raw_score=True)).all()


def test_hist_fail_surfaces_at_the_wrapper():
    with pytest.raises(InjectedFault, match="hist_fail"):
        lt.train(_params(fault_inject="hist_fail_once"), _datasets()[0], 2,
                 verbose_eval=False)


def test_hist_fail_checked_at_replayed_step_start():
    """On the graph loop the wrappers' Python runs at the capture only, so
    ``SplitLoop.replay`` checks the point before each replay: a stand-in
    graph shows the check comes first and the replay never runs."""
    import torch
    from lightgbm_tpu_torch.grower import GrowerConfig, SplitLoop

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    loop = SplitLoop(GrowerConfig(num_leaves=7), torch.device("cpu"), 2)
    loop.graph = Graph()
    loop.replay()
    assert Graph.replays == 1 and loop.replays == 1
    faults.install("hist_fail_once")
    with pytest.raises(InjectedFault, match="replayed split step"):
        loop.replay()
    assert Graph.replays == 1
    loop.replay()                        # the _once entry is spent
    assert Graph.replays == 2


# ------------------------------------------------------- preemption safety

def test_preempt_fault_checkpoints_and_resumes(tmp_path):
    out = str(tmp_path / "m.txt")
    tr, _ = _datasets()
    ref = lt.train(_params(out), tr, 8, verbose_eval=False).model_to_string()
    out2 = str(tmp_path / "p" / "m.txt")
    counters.reset()
    bst = lt.train(_params(out2, fault_inject="preempt@3"), _datasets()[0],
                   8, verbose_eval=False)
    assert bst.current_iteration() == 3
    assert os.path.exists(ckpt.snapshot_path(out2, 3))
    evs = counters.events("preempt_checkpoint")
    assert len(evs) == 1 and evs[0]["iteration"] == 3
    bst2 = lt.train(_params(out2), _datasets()[0], 8, verbose_eval=False,
                    resume=True)
    assert bst2.model_to_string() == ref


def test_preempt_real_sigterm(tmp_path):
    out = str(tmp_path / "m.txt")
    prev = signal.getsignal(signal.SIGTERM)

    def send_sigterm(env):
        if env.iteration == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    bst = lt.train(_params(out, preempt_signal="sigterm"), _datasets()[0],
                   8, verbose_eval=False, callbacks=[send_sigterm])
    assert bst.current_iteration() == 2
    assert os.path.exists(ckpt.snapshot_path(out, 2))
    assert signal.getsignal(signal.SIGTERM) is prev


@pytest.mark.parametrize("spec,sig", [("sigterm", signal.SIGTERM),
                                      ("sigterm,sigint", signal.SIGINT)],
                         ids=["sigterm", "sigint"])
def test_second_signal_forces_immediate_exit(tmp_path, spec, sig):
    """A second notice while the first is being honoured exits at once
    (``SystemExit(128 + signum)``), the handlers restored and a crash
    report left behind."""
    out = str(tmp_path / "m.txt")
    prev = signal.getsignal(sig)

    def send_two(env):
        if env.iteration == 1:
            signal.raise_signal(sig)
            signal.raise_signal(sig)

    with pytest.raises(SystemExit) as ei:
        lt.train(_params(out, preempt_signal=spec, heartbeat_interval=0.001),
                 _datasets()[0], 8, verbose_eval=False, callbacks=[send_two])
    assert ei.value.code == 128 + int(sig)
    assert signal.getsignal(sig) is prev
    report = ckpt.crash_report_path(out, 0)
    assert "SystemExit" in open(report).read()


def test_preempt_signal_param_validated():
    with pytest.raises(RuntimeError, match="preempt_signal"):
        lt.train(_params(preempt_signal="sigkill"), _datasets()[0], 1)


def test_single_process_checkpointing_adds_zero_collectives(tmp_path):
    counters.reset()
    lt.train(_params(str(tmp_path / "m.txt"), preempt_signal="sigterm"),
             _datasets()[0], 4, verbose_eval=False, resume=True)
    assert counters.get("collective_calls") == {}
    assert counters.get("collective_bytes") == {}


# ----------------------------------------------------- the collectives' ladder

def test_collective_retry_recovers_and_counts():
    counters.reset()
    faults.install("collective_fail_once")
    assert sync.allgather_object({"a": 1}) == [{"a": 1}]
    assert counters.get("collective_retries") == {"op=allgather_object": 1}
    assert counters.events("collective_retry")[0]["op"] == "allgather_object"
    faults.install("collective_fail_once")
    assert sync.broadcast_object({"x": 2}) == {"x": 2}


def test_collective_persistent_failure_surfaces():
    faults.install("collective_fail")
    with pytest.raises(sync.CollectiveError, match="after 3 attempt"):
        sync.allgather_object(1)
    sync.configure(retries=0)
    with pytest.raises(sync.CollectiveError, match="after 1 attempt"):
        sync.allgather_object(1)


def test_corrupt_frame_fails_its_crc_and_is_retried():
    """``collective_corrupt`` flips the first received byte: the CRC check
    catches it and the ladder retries; a frame of another incarnation
    epoch raises ``StaleEpochError``, which is never retried."""
    frame = sync._frame({"k": [1, 2]})
    faults.install("collective_corrupt_once")
    bad = sync._maybe_corrupt([frame])[0]
    with pytest.raises(sync.CollectiveError, match="CRC"):
        sync._unframe(bad, "allgather_object", 0)
    assert sync._unframe(sync._maybe_corrupt([frame])[0], "op", 0) == \
        {"k": [1, 2]}
    counters.reset()
    calls = [0]

    def attempt():
        calls[0] += 1
        return sync._unframe(bad if calls[0] == 1 else frame, "op", 0)

    assert sync._retrying("op", attempt) == {"k": [1, 2]}
    assert counters.get("collective_retries") == {"op=op": 1}
    stale = (frame[0], frame[1], frame[2] + 1, frame[3])
    calls[0] = 0

    def stale_attempt():
        calls[0] += 1
        return sync._unframe(stale, "op", 1)

    with pytest.raises(sync.StaleEpochError) as e:
        sync._retrying("op", stale_attempt)
    assert calls[0] == 1 and e.value.frame_epoch == frame[2] + 1


def test_rendezvous_refuses_a_stale_incarnation(tmp_path, monkeypatch):
    """A worker launched under epoch 1 while the supervisor stamped 2
    raises ``StaleEpochError`` before it touches the rendezvous."""
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.parallel.mesh import init_distributed_from_config
    out = str(tmp_path / "m.txt")
    ckpt.write_group_epoch_file(out, 2)
    monkeypatch.setenv(ckpt.GROUP_EPOCH_ENV, "1")
    cfg = config_from_params(dict(num_machines=2, tree_learner="data",
                                  machine_list_file=str(tmp_path / "none"),
                                  output_model=out, device="cpu"))
    with pytest.raises(sync.StaleEpochError, match="epoch 1"):
        init_distributed_from_config(cfg)
    assert ckpt.read_group_epoch_file(out) == 2
