"""Atomic, resumable training checkpoints (``lightgbm_tpu/checkpoint.py``
:1-962: everything but the elastic reassembly, which waits for elastic
groups, ROADMAP.md §1.6).

* **File format**: the snapshot file starts with the ordinary model text
  (so ``Booster(model_file=snapshot)`` keeps working), followed by one
  ``checkpoint:v1:<base64 zlib pickle>`` line carrying the
  :func:`capture_state` payload, and a final ``checkpoint_crc32=XXXXXXXX``
  footer over every preceding byte.  The bytes are the JAX package's: each
  package decodes the other's framing.
* **Atomic write**: a tmp file keyed by rank and pid in the destination
  directory, flush, ``os.fsync``, ``os.replace``.
* **Resume**: :func:`find_latest_valid` walks ``*.snapshot_iter_N`` in
  descending N and skips invalid (torn) files; the captured state restores
  the training bit for bit: the score matrices (copied from the card at a
  snapshot only), the bagging and feature RNG streams, the live bag, DART's
  drop stream and tree weights, early stopping's bests, ``evals_result``
  and the learning rate.
* **Retention**: :func:`prune_snapshots` keeps the ``snapshot_keep`` newest
  snapshots; a snapshot set of several processes goes as a unit, manifest
  first.

**Several processes**: each rank writes
``<output_model>.snapshot_iter_N.rank_R`` atomically (the model text on
rank 0 only; the state, with that rank's scores, everywhere), the ranks
allgather their shards' CRC32s (the barrier, through the collectives'
ladder), then rank 0 writes ``<output_model>.snapshot_iter_N.manifest``,
the commit point, with the CRCs, ``process_count`` and each rank's data
fingerprint.  A set without a manifest never existed; a torn shard on any
rank demotes the whole group to the previous set
(:func:`find_latest_valid_group`); a manifest of another process count or
data fingerprint raises :class:`CheckpointError`.

The ``torn_checkpoint``, ``torn_shard_rank``, ``torn_manifest`` and
``rank_crash_in_barrier`` fault points
(:mod:`lightgbm_tpu_torch.utils.faults`) leave a half file at the final
path and/or raise :class:`~lightgbm_tpu_torch.utils.faults.SimulatedCrash`
at each instant of the protocol.
"""
from __future__ import annotations

import base64
import copy
import glob
import os
import pickle
import re
import signal
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from .utils import faults as faults_mod
from .utils import log

CHECKPOINT_VERSION = 1
_STATE_PREFIX = "checkpoint:v1:"
_CRC_PREFIX = "checkpoint_crc32="
_SNAP_RE = re.compile(r"\.snapshot_iter_(\d+)$")
_SHARD_RE = re.compile(r"\.snapshot_iter_(\d+)\.rank_(\d+)$")
_MANIFEST_RE = re.compile(r"\.snapshot_iter_(\d+)\.manifest$")

# the incarnation epoch fence: the supervisor stamps each launch's attempt
# counter into this variable; sync.py carries it in every collective
# payload, and every liveness file (heartbeat, crash report) is stamped
# with it, so that a dead incarnation's leftovers can be told apart
GROUP_EPOCH_ENV = "LGBM_TPU_GROUP_EPOCH"


def group_epoch() -> int:
    """The incarnation epoch this process was launched under (0 when not
    running under an epoch-stamping supervisor)."""
    try:
        return int(os.environ.get(GROUP_EPOCH_ENV, "0") or 0)
    except ValueError:
        return 0


def group_epoch_path(output_model: str) -> str:
    """The on-disk fence of the process group's rendezvous: the supervisor
    writes the current incarnation epoch here before each launch, so that
    a stale worker of a dead incarnation refuses the rendezvous
    (``StaleEpochError``) instead of joining the new group."""
    return output_model + ".group_epoch"


def write_group_epoch_file(output_model: str, epoch: int) -> None:
    """Atomically stamp the group's current incarnation epoch (supervisor
    side, before spawning workers)."""
    path = group_epoch_path(output_model)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{int(epoch)}\n")
    os.replace(tmp, path)


def read_group_epoch_file(output_model: str) -> Optional[int]:
    """The stamped group epoch, or None when no supervisor stamped one
    (unsupervised runs have no fence to check)."""
    try:
        with open(group_epoch_path(output_model)) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return None


class CheckpointError(RuntimeError):
    """The file is not a valid checkpoint (torn tail, bad CRC, bad blob)."""


# --------------------------------------------------------------- file format

def encode(model_str: str, state: Dict[str, Any]) -> bytes:
    """Model text + state line + CRC footer as the on-disk byte string."""
    blob = base64.b64encode(zlib.compress(
        pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL))).decode()
    body = model_str
    if not body.endswith("\n"):
        body += "\n"
    payload = (body + _STATE_PREFIX + blob + "\n").encode()
    return payload + f"{_CRC_PREFIX}{zlib.crc32(payload):08x}\n".encode()


def decode(data: bytes) -> Tuple[str, Dict[str, Any]]:
    """Validate CRC footer and return ``(model_str, state)``.

    Raises :class:`CheckpointError` on any integrity failure — a torn tail
    is indistinguishable from corruption and treated identically.
    """
    tail = data.rstrip(b"\n")
    nl = tail.rfind(b"\n")
    footer = tail[nl + 1:]
    if nl < 0 or not footer.startswith(_CRC_PREFIX.encode()):
        raise CheckpointError("missing checkpoint CRC footer (torn file?)")
    payload = data[:nl + 1]
    try:
        want = int(footer[len(_CRC_PREFIX):], 16)
    except ValueError:
        raise CheckpointError("garbled checkpoint CRC footer")
    got = zlib.crc32(payload)
    if got != want:
        raise CheckpointError(
            f"checkpoint CRC mismatch (stored {want:08x}, computed {got:08x})")
    text = payload.decode()
    lines = text.splitlines()
    state_line = next((ln for ln in reversed(lines)
                       if ln.startswith(_STATE_PREFIX)), None)
    if state_line is None:
        raise CheckpointError("no checkpoint state line in file")
    try:
        state = pickle.loads(zlib.decompress(
            base64.b64decode(state_line[len(_STATE_PREFIX):])))
    except Exception as e:
        raise CheckpointError(f"undecodable checkpoint state: {e}")
    model_str = text[:text.rindex(_STATE_PREFIX)]
    return model_str, state


def _process_index() -> int:
    """This process's rank (0 without a process group).  Part of the tmp
    file's name: on a shared filesystem two hosts can hold the same pid."""
    from .parallel.sync import process_index
    return process_index()


def write_atomic(path: str, data: bytes) -> None:
    """tmp + fsync + ``os.replace``: all-or-nothing at the final path."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(
        d, f".{os.path.basename(path)}.tmp.r{_process_index()}.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


# ------------------------------------------------------------- preemption

class PreemptionWatch:
    """Preemption safety (``preempt_signal`` param): turns SIGTERM/SIGINT
    into "write a coordinated checkpoint at the next iteration boundary
    and exit the training loop cleanly" instead of dying wherever the
    signal lands.  The handler only flips :attr:`requested`; all actual
    work happens at the loop boundary where the training state is
    consistent.  ``install``/``restore`` scope the handlers to one
    ``train()`` call.

    **Double-signal semantics**: a SECOND notice of a watched signal while
    the first request is still being honored (typically: the coordinated
    preempt checkpoint is in flight) means the platform is done waiting —
    the handler raises ``SystemExit(128 + signum)`` immediately instead of
    re-queuing, and the ``finally`` that wraps the training loop restores
    the previous handlers on the way out.  SIGINT behaves identically to
    SIGTERM when listed in ``preempt_signal``."""

    def __init__(self, spec: str):
        self.spec = str(spec or "")
        self.requested = False
        self.armed = False
        self._installed: List[Tuple[int, Any]] = []

    def _signals(self) -> List[int]:
        sigs = []
        for tok in self.spec.replace(",", " ").split():
            t = tok.strip().lower()
            if t in ("sigterm", "term"):
                sigs.append(signal.SIGTERM)
            elif t in ("sigint", "int"):
                sigs.append(signal.SIGINT)
        return sigs

    def _on_signal(self, signum, frame) -> None:
        if self.requested:
            # second notice while the first is being honored: the platform
            # is done waiting — exit NOW (the in-flight atomic write leaves
            # either the old file or the new one, never a torn checkpoint,
            # and train()'s finally restores the handlers)
            log.warning("second preemption signal (%d) before the "
                        "coordinated checkpoint completed; exiting "
                        "immediately", signum)
            raise SystemExit(128 + int(signum))
        self.requested = True

    def install(self) -> "PreemptionWatch":
        if not self.spec:
            return self
        if threading.current_thread() is not threading.main_thread():
            # signal.signal() is a main-thread-only API; say so instead of
            # dying — the deterministic `preempt` fault point still works
            log.warning("preempt_signal: handlers can only be installed "
                        "from the main thread; preemption checkpointing "
                        "is disabled for this training")
            return self
        for s in self._signals():
            self._installed.append((s, signal.signal(s, self._on_signal)))
        self.armed = bool(self._installed)
        return self

    def restore(self) -> None:
        for s, old in self._installed:
            signal.signal(s, old)
        self._installed = []
        self.armed = False


def iteration_from_path(path: str) -> Optional[int]:
    """The ``N`` of any ``*.snapshot_iter_N[...]`` file name (plain
    snapshot, rank shard, or manifest); None when the name carries no
    iteration."""
    m = re.search(r"\.snapshot_iter_(\d+)", str(path))
    return int(m.group(1)) if m else None


# ------------------------------------------------- liveness: heartbeat files

def heartbeat_path(output_model: str, rank: int) -> str:
    return f"{output_model}.heartbeat.rank_{rank}"


class Heartbeat:
    """Per-rank liveness stamp (``heartbeat_interval`` param): one tiny
    JSON line — iteration, wall-time, pid — rewritten atomically at each
    iteration boundary, throttled to at most one write per ``interval``
    seconds (plus the forced stamps at loop entry/exit).  Pure host-side
    file writes: no fsync (liveness, not durability — the reader trusts
    mtime recency, not crash persistence), no collectives, no device
    syncs.  The supervisor declares a rank hung when the file's mtime is
    older than ``hang_timeout``, so the stamp cadence bounds detection
    latency at ``iteration_time + interval``.

    The ``slow_heartbeat`` fault point makes writes silently never land
    (the stalled-NFS failure mode): the rank is alive but looks dead to
    file-based liveness."""

    def __init__(self, path: str, interval: float):
        self.path = path
        self.interval = float(interval)
        self._last = 0.0

    def stamp(self, iteration: int, force: bool = False) -> None:
        import json
        import time
        now = time.time()
        if not force and now - self._last < self.interval:
            return
        fi = faults_mod.get_faults()
        if fi.enabled and fi.fire("slow_heartbeat", iteration):
            return
        self._last = now
        line = json.dumps({"iteration": int(iteration), "time": now,
                           "pid": os.getpid(),
                           "epoch": group_epoch()}) + "\n"
        # atomic but UNSYNCED: a heartbeat that evaporates in a crash is
        # indistinguishable from the death it would have reported anyway
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(line)
            os.replace(tmp, self.path)
        except OSError as e:           # liveness must never kill training
            log.debug("heartbeat write failed: %s", e)
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass


def read_heartbeat(path: str):
    """``(iteration, age_seconds)`` of a heartbeat file, or ``None`` when
    it is missing/unreadable/garbled (a torn heartbeat is just a stale
    one — the supervisor falls back to the file's absence semantics)."""
    import json
    import time
    try:
        age = time.time() - os.stat(path).st_mtime
        with open(path) as f:
            rec = json.loads(f.readline())
        return int(rec["iteration"]), age
    except (OSError, ValueError, KeyError, TypeError):
        return None


# --------------------------------------------------- per-rank crash reports

def crash_report_path(output_model: str, rank: int) -> str:
    return f"{output_model}.crash.rank_{rank}"


def write_crash_report(output_model: str, rank: int,
                       exc: Optional[BaseException] = None) -> Optional[str]:
    """Flush a per-rank crash report on abnormal exit: the exception, a
    ``faulthandler`` dump of every thread's stack, and the tail of this
    rank's obs event ring — so a supervisor (or a human) can read WHY a
    rank died without re-running under a debugger.  Best-effort by
    construction: a crash report about a crashing process must never mask
    the original failure.  Returns the path written, or None."""
    import faulthandler
    import json
    import time
    import traceback
    from .obs.counters import counters
    path = crash_report_path(output_model, rank)
    events = counters.events_tail(64)
    try:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(f"# crash report: rank {rank}, pid {os.getpid()}, "
                    f"time {time.time():.3f}, epoch {group_epoch()}\n")
            if exc is not None:
                f.write("## exception\n")
                f.write("".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__)))
            f.write("## thread stacks (faulthandler)\n")
            f.flush()
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.write(f"\n## obs event ring tail ({len(events)} events)\n")
            for e in events:
                f.write(json.dumps(e, default=str) + "\n")
        return path
    except Exception as e:             # pragma: no cover - dying process
        try:
            log.debug("crash report write failed: %s", e)
        except Exception:
            pass
        return None


# -------------------------------------------------- startup hygiene: sweeps

def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):  # pragma: no cover - foreign pid
        return True                     # exists but not ours: leave it be

_TMP_RE = re.compile(r"\.tmp\.r(\d+)\.(\d+)$")


def _stamped_epoch(path: str) -> int:
    """The incarnation epoch a liveness file was stamped with: the
    ``epoch`` key of a heartbeat's JSON line, or the ``epoch N`` field of a
    crash report's header.  A file with no stamp reads as epoch 0 (always
    sweepable by a later incarnation)."""
    import json
    try:
        with open(path, "rb") as f:
            head = f.read(4096).decode("utf-8", errors="replace")
    except OSError:
        return 0
    first = head.splitlines()[0] if head.splitlines() else ""
    m = re.search(r"\bepoch (\d+)\b", first)
    if first.startswith("# crash report:"):
        return int(m.group(1)) if m else 0
    best = 0
    try:
        with open(path, "rb") as f:
            for line in f.read().decode("utf-8", errors="replace").splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    try:
                        best = max(best, int(rec.get("epoch", 0) or 0))
                    except (TypeError, ValueError):
                        continue
    except OSError:
        return 0
    return best


def sweep_stale_tmp(output_model: str, crash_reports: bool = False,
                    heartbeats: bool = False, *,
                    current_epoch: Optional[int] = None) -> List[str]:
    """Startup hygiene for crashed ranks: remove ``.tmp.r<rank>.<pid>``
    atomic-write leftovers whose writer pid is dead (a SIGKILLed rank's
    half-written tmp otherwise lives forever on a shared filesystem), and
    — when asked — orphan crash reports and heartbeat files from previous
    incarnations.  Live pids are never touched: a peer rank mid-write
    keeps its tmp.  Returns the removed paths; every removal is recorded
    as a ``stale_sweep`` obs event so the cleanup is observable.

    ``current_epoch`` (keyword-only; the supervisor's launch counter)
    also sweeps heartbeat and crash-report files stamped with an OLDER
    epoch: a dead incarnation's files are never taken for the live
    group's.  ``None`` sweeps by pid and the two flags only."""
    from .obs.counters import counters
    base = os.path.basename(output_model)
    d = os.path.dirname(os.path.abspath(output_model))
    removed: List[str] = []
    victims: List[Tuple[str, str]] = []
    for p in glob.glob(os.path.join(glob.escape(d),
                                    "." + glob.escape(base) + "*.tmp.r*.*")):
        m = _TMP_RE.search(p)
        if m and not _pid_alive(int(m.group(2))):
            victims.append((p, f"stale tmp (rank {m.group(1)}, dead pid "
                               f"{m.group(2)})"))
    if crash_reports:
        victims += [(p, "orphan crash report") for p in
                    glob.glob(glob.escape(output_model) + ".crash.rank_*")]
    if heartbeats:
        victims += [(p, "stale heartbeat") for p in
                    glob.glob(glob.escape(output_model)
                              + ".heartbeat.rank_*")]
    if current_epoch is not None:
        epoch_files = (
            glob.glob(glob.escape(output_model) + ".heartbeat.rank_*")
            + glob.glob(glob.escape(output_model) + ".crash.rank_*"))
        for p in epoch_files:
            ep = _stamped_epoch(p)
            if ep < int(current_epoch):
                victims.append((p, f"dead epoch ({ep} < current "
                                   f"{int(current_epoch)})"))
    seen: set = set()
    for p, why in victims:
        if p in seen:
            continue
        seen.add(p)
        try:
            os.unlink(p)
        except OSError:                # pragma: no cover - races/permissions
            continue
        removed.append(p)
        counters.event("stale_sweep", path=p, reason=why)
    if removed:
        log.info("Swept %d stale file(s) for %s", len(removed), output_model)
    return removed


def latest_committed_iteration(output_model: str) -> Optional[int]:
    """The newest iteration with a durable commit under this prefix, from
    THIS process's view of the filesystem: the max over valid plain
    snapshots and snapshot sets whose manifest validates.  No gather, no
    shard-CRC audit — this is the supervisor's forward-progress marker
    (did the group commit anything since the last restart?), not the
    resume agreement (:func:`find_latest_valid_group` stays that)."""
    best: Optional[int] = None
    for it, path in reversed(list_snapshots(output_model)):
        try:
            load_snapshot(path)
        except CheckpointError:
            continue
        best = it
        break
    for it in sorted(list_snapshot_sets(output_model), reverse=True):
        if best is not None and it <= best:
            break
        try:
            load_manifest(output_model, it)
        except CheckpointError:
            continue
        best = it
        break
    return best


# ------------------------------------------------------------ capture/restore

def capture_state(booster, iteration: int, callbacks=(),
                  evals_result: Optional[Dict] = None) -> Dict[str, Any]:
    """Everything ``train`` needs to continue from ``iteration`` as if the
    process had never died.  Callbacks exposing a ``checkpoint_state()``
    hook (``callback.early_stopping`` does) contribute theirs, in callback
    order."""
    return {
        "version": CHECKPOINT_VERSION,
        "iteration": int(iteration),
        "booster": booster.inner.checkpoint_state(),
        "best_iteration": booster.best_iteration,
        "best_score": copy.deepcopy(booster.best_score),
        "evals_result": (copy.deepcopy(evals_result)
                         if evals_result is not None else None),
        "callback_states": [cb.checkpoint_state() for cb in callbacks
                            if hasattr(cb, "checkpoint_state")],
    }


def restore_state(booster, state: Dict[str, Any], callbacks=(),
                  evals_result: Optional[Dict] = None) -> int:
    """Inverse of :func:`capture_state`; returns the next loop iteration."""
    if state.get("version") != CHECKPOINT_VERSION:
        raise CheckpointError(
            f"unsupported checkpoint version {state.get('version')!r}")
    booster.inner.load_checkpoint_state(state["booster"])
    booster.best_iteration = state["best_iteration"]
    booster.best_score = copy.deepcopy(state["best_score"])
    if evals_result is not None and state.get("evals_result") is not None:
        evals_result.clear()
        evals_result.update(copy.deepcopy(state["evals_result"]))
    hooked = [cb for cb in callbacks if hasattr(cb, "restore_state")]
    for cb, st in zip(hooked, state.get("callback_states") or []):
        cb.restore_state(st)
    return int(state["iteration"])


# ----------------------------------------------------------------- snapshots

def snapshot_path(output_model: str, iteration: int) -> str:
    return f"{output_model}.snapshot_iter_{iteration}"


def write_snapshot(path: str, booster, iteration: int, callbacks=(),
                   evals_result: Optional[Dict] = None) -> None:
    """Write one atomic snapshot checkpoint (or, under an armed
    ``torn_checkpoint`` fault, die mid-write leaving a torn file)."""
    state = capture_state(booster, iteration, callbacks, evals_result)
    data = encode(booster.model_to_string(-1), state)
    fi = faults_mod.get_faults()
    if fi.enabled and fi.fire("torn_checkpoint", iteration):
        # the legacy failure mode on purpose: non-atomic write killed
        # halfway — the torn file sits at the FINAL path
        with open(path, "wb") as f:
            f.write(data[:max(1, len(data) // 2)])
        raise faults_mod.SimulatedCrash(
            f"torn_checkpoint fault: training killed while writing {path}")
    write_atomic(path, data)


def load_snapshot(path: str) -> Tuple[str, Dict[str, Any]]:
    """Read + validate one snapshot; raises :class:`CheckpointError`."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CheckpointError(f"unreadable checkpoint {path}: {e}")
    return decode(data)


def list_snapshots(output_model: str) -> List[Tuple[int, str]]:
    """All ``<output_model>.snapshot_iter_N`` files, ascending N."""
    out = []
    for p in glob.glob(glob.escape(output_model) + ".snapshot_iter_*"):
        m = _SNAP_RE.search(p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def _skip_event(iteration: int, path: str, reason: str) -> None:
    """Structured twin of every snapshot-skip warning: the event ring,
    not only stderr, carries why a resume did not use a snapshot."""
    from .obs.counters import counters
    counters.event("checkpoint_skipped", iteration=int(iteration),
                   path=path, reason=reason)


def find_latest_valid(output_model: str):
    """Newest *valid* snapshot for this model prefix, as
    ``(iteration, path, state)``; invalid (torn) files are skipped with a
    warning + a ``checkpoint_skipped`` obs event — the previous good
    snapshot wins.  None when nothing valid exists."""
    for it, path in reversed(list_snapshots(output_model)):
        try:
            _, state = load_snapshot(path)
        except CheckpointError as e:
            _skip_event(it, path, str(e))
            log.warning("Skipping invalid snapshot %s: %s", path, e)
            continue
        return it, path, state
    return None


def prune_snapshots(output_model: str, keep: int) -> None:
    """Keep the ``keep`` highest-iteration snapshots; remove the rest
    (``keep <= 0`` keeps everything).

    Shard/manifest-aware: a multi-process snapshot *set* counts as one
    snapshot and is removed as a unit — manifest (the commit point) FIRST,
    so at no instant does a partially deleted set still look committed,
    and no orphan rank shards are ever stranded behind."""
    if keep <= 0:
        return
    iters = sorted(set(it for it, _ in list_snapshots(output_model))
                   | set(list_snapshot_sets(output_model)))
    for it in iters[:-keep]:
        sets = list_snapshot_sets(output_model)
        paths = []
        if it in sets:
            man, shards = sets[it]
            paths = ([man] if man else []) + [p for _, p in sorted(shards)]
        plain = snapshot_path(output_model, it)
        if os.path.exists(plain):
            paths.append(plain)
        for path in paths:
            try:
                os.unlink(path)
            except OSError as e:  # pragma: no cover - races with external rm
                log.debug("snapshot prune: could not remove %s (%s)",
                          path, e)


# ------------------------------------- multi-process coordinated snapshots

def shard_path(output_model: str, iteration: int, rank: int) -> str:
    return f"{output_model}.snapshot_iter_{iteration}.rank_{rank}"


def manifest_path(output_model: str, iteration: int) -> str:
    return f"{output_model}.snapshot_iter_{iteration}.manifest"


def list_snapshot_sets(output_model: str) -> Dict[int, tuple]:
    """Multi-process snapshot sets for this model prefix:
    ``{iteration: (manifest_path_or_None, [(rank, shard_path), ...])}``.
    A set with no manifest was never committed."""
    sets: Dict[int, tuple] = {}
    for p in glob.glob(glob.escape(output_model) + ".snapshot_iter_*"):
        m = _SHARD_RE.search(p)
        if m:
            it = int(m.group(1))
            sets.setdefault(it, (None, []))
            sets[it][1].append((int(m.group(2)), p))
            continue
        m = _MANIFEST_RE.search(p)
        if m:
            it = int(m.group(1))
            old = sets.get(it, (None, []))
            sets[it] = (p, old[1])
    return sets


def data_fingerprint(binned, num_data: int) -> int:
    """Cheap stable identity of THIS rank's dataset partition: shape,
    dtype, and a strided row sample of the binned matrix.  Rides every
    checkpoint and the manifest, so that a resume onto other data (another
    row shard, another binning) is a structured error, not silent
    divergence.  ``binned`` is the matrix wherever it lives: a numpy array
    (the host matrix, page-locked when streamed) or a tensor on any device;
    only the sampled rows are copied to the host, and the integer is the
    JAX package's for the same bins, on the CPU and on the card."""
    import numpy as np
    crc = zlib.crc32(f"{num_data}".encode())
    if binned is not None:
        shape = tuple(binned.shape)
        if isinstance(binned, np.ndarray):
            dtype = binned.dtype
        else:    # a tensor: its numpy type, its sample through a movable view
            dtype = np.dtype(str(binned.dtype).replace("torch.", ""))
        crc = zlib.crc32(f"{shape}:{dtype}".encode(), crc)
        step = max(1, shape[0] // 4096) if len(shape) else 1
        if isinstance(binned, np.ndarray):
            sample = np.ascontiguousarray(binned[::step])
        else:
            from .ops.histogram import movable
            sample = movable(binned)[::step].cpu().numpy().view(dtype)
        crc = zlib.crc32(np.ascontiguousarray(sample).tobytes(), crc)
    return crc


def _default_gather():
    from .parallel.sync import allgather_object
    return allgather_object


def write_group_snapshot(output_model: str, iteration: int, model_str: str,
                         state: Dict[str, Any], *, rank: int, world: int,
                         fingerprint: int, gather=None) -> None:
    """One rank's half of the coordinated snapshot protocol.

    Shard write (atomic, every rank) -> barrier (allgather of shard CRCs
    through the hardened collective ladder) -> manifest write (rank 0, the
    commit point).  A crash at ANY instant leaves either the previous
    committed set or the new one: shards without a manifest never existed."""
    gather = gather or _default_gather()
    fi = faults_mod.get_faults()
    spath = shard_path(output_model, iteration, rank)
    data = encode(model_str, state)
    if fi.enabled and fi.fire("torn_shard_rank", iteration):
        # SIGKILL mid-shard-write on this rank: torn file at the FINAL
        # path; peers block in the barrier until the collective timeout
        with open(spath, "wb") as f:
            f.write(data[:max(1, len(data) // 2)])
        raise faults_mod.SimulatedCrash(
            f"torn_shard_rank fault: rank {rank} killed writing {spath}")
    write_atomic(spath, data)
    if fi.enabled and fi.fire("rank_crash_in_barrier", iteration):
        raise faults_mod.SimulatedCrash(
            f"rank_crash_in_barrier fault: rank {rank} killed before the "
            f"iteration-{iteration} snapshot barrier")
    # barrier + CRC exchange: nobody commits until every shard is durable
    info = {"rank": rank, "crc": zlib.crc32(data),
            "fingerprint": int(fingerprint)}
    infos = gather(info)
    if rank != 0:
        return
    by_rank = {int(i["rank"]): i for i in infos}
    manifest = {
        "version": CHECKPOINT_VERSION,
        "iteration": int(iteration),
        "process_count": int(world),
        "shard_crc32": [int(by_rank[r]["crc"]) for r in range(world)],
        "data_fingerprint": [int(by_rank[r]["fingerprint"])
                             for r in range(world)],
    }
    mdata = encode("", manifest)
    mpath = manifest_path(output_model, iteration)
    if fi.enabled and fi.fire("torn_manifest", iteration):
        with open(mpath, "wb") as f:
            f.write(mdata[:max(1, len(mdata) // 2)])
        raise faults_mod.SimulatedCrash(
            f"torn_manifest fault: rank 0 killed writing {mpath}")
    write_atomic(mpath, mdata)


def load_manifest(output_model: str, iteration: int) -> Dict[str, Any]:
    """Read + validate one committed manifest; :class:`CheckpointError` on
    a torn/garbled file."""
    _, manifest = load_snapshot(manifest_path(output_model, iteration))
    return manifest


def _local_valid_group_iters(output_model: str, rank: int, world: int,
                             fingerprint: int):
    """Scan committed sets newest-first from THIS rank's point of view.

    Returns ``(ok_iters, fatal)``: iterations whose manifest AND this
    rank's shard validate (descending), plus a structured-mismatch message
    (topology / partition fingerprint) that must fail the whole group —
    reported through the gather so every rank raises the same error
    instead of one rank dying while its peers wait in the barrier."""
    ok: List[int] = []
    fatal: Optional[str] = None
    for it in sorted(list_snapshot_sets(output_model), reverse=True):
        try:
            manifest = load_manifest(output_model, it)
        except CheckpointError as e:
            # torn/uncommitted manifest: the set never existed — demote
            _skip_event(it, manifest_path(output_model, it), str(e))
            log.warning("Skipping snapshot set iter %d: %s", it, e)
            continue
        if int(manifest.get("process_count", -1)) != world:
            old_world = int(manifest.get("process_count", 0) or 0)
            fatal = (f"checkpoint set at iteration {it} was written by "
                     f"{manifest.get('process_count')} process(es) but this "
                     f"job runs {world} — resuming across a topology change "
                     "would silently diverge; candidate set "
                     f"{os.path.basename(manifest_path(output_model, it))} "
                     f"(shards rank_0..rank_{max(0, old_world - 1)}): "
                     "restart from scratch or rerun with the original "
                     "process count (elastic resume is not ported)")
            break
        if int(manifest["data_fingerprint"][rank]) != int(fingerprint):
            fatal = (f"checkpoint set at iteration {it}: rank {rank}'s "
                     "dataset-partition fingerprint does not match the "
                     "manifest — the data shard this rank holds is not the "
                     "one the checkpoint was taken over")
            break
        spath = shard_path(output_model, it, rank)
        try:
            with open(spath, "rb") as f:
                data = f.read()
            got = zlib.crc32(data)
            want = int(manifest["shard_crc32"][rank])
            if got != want:
                raise CheckpointError(
                    f"shard CRC mismatch vs manifest (manifest {want:08x}, "
                    f"file {got:08x})")
            decode(data)     # torn-tail/garble check on the shard itself
        except (OSError, CheckpointError) as e:
            _skip_event(it, spath, f"rank {rank}: {e}")
            log.warning("Snapshot set iter %d invalid on rank %d (%s); "
                        "demoting the group to an older set", it, rank, e)
            continue
        ok.append(it)
    return ok, fatal


def find_latest_valid_group(output_model: str, *, rank: int, world: int,
                            fingerprint: int, gather=None,
                            only_iteration: Optional[int] = None):
    """The resume barrier: every rank scans its own shards, the ranks
    allgather their locally-valid iteration lists, and the group agrees on
    the newest iteration valid on EVERY rank (a torn shard on any rank
    demotes all of them — mirroring the single-process torn-tail
    fallback).  Returns ``(iteration, shard_path, state)`` for this rank,
    or None when no set is valid everywhere.

    ``only_iteration`` pins resume to one explicit set: anything less than
    group-wide validity of exactly that set raises."""
    gather = gather or _default_gather()
    # startup hygiene: a previous incarnation SIGKILLed mid-write left
    # .tmp.r<rank>.<pid> leftovers behind — their pids are dead by the time
    # a group resumes, so sweep them here (live writers are never touched)
    sweep_stale_tmp(output_model)
    ok, fatal = _local_valid_group_iters(output_model, rank, world,
                                         fingerprint)
    views = gather({"rank": rank, "ok": ok, "fatal": fatal})
    if only_iteration is not None:
        # pin applied to EVERY view after the gather, so the agreement is
        # on exactly that set no matter what each rank was asked locally
        keep = int(only_iteration)
        ok = [it for it in ok if it == keep]
        views = [dict(v, ok=[i2 for i2 in v["ok"] if i2 == keep])
                 for v in views]
    for v in sorted(views, key=lambda v: int(v["rank"])):
        if v["fatal"]:
            raise CheckpointError(f"rank {v['rank']}: {v['fatal']}")
    agreed = set.intersection(*[set(v["ok"]) for v in views]) \
        if views else set()
    local_best = max(ok, default=None)
    if not agreed:
        if only_iteration is not None:
            raise CheckpointError(
                f"snapshot set at iteration {only_iteration} of "
                f"{output_model} is not valid on every rank")
        return None
    best = max(agreed)
    if local_best is not None and best != local_best:
        # visible demotion: this rank had a newer set, but a peer's torn
        # shard drags the whole group back to the last everywhere-good one
        bad_ranks = [int(v["rank"]) for v in views
                     if local_best not in v["ok"]]
        _skip_event(local_best, shard_path(output_model, local_best, rank),
                    f"demoted to iteration {best}: rank(s) {bad_ranks} "
                    "hold no valid shard")
        log.warning("Snapshot set iter %d demoted to iter %d (invalid on "
                    "rank(s) %s)", local_best, best, bad_ranks)
    _, state = load_snapshot(shard_path(output_model, best, rank))
    return best, shard_path(output_model, best, rank), state
