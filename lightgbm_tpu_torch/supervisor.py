"""Self-healing training: the supervisor process
(``lightgbm_tpu/supervisor.py:87-587``).

The supervisor spawns the rank processes of one training group, each any
command line (``argv``, the same for every rank and every relaunch; the
rank travels as ``LGBM_TPU_RANK``, the launch count as
``LGBM_TPU_SUPERVISOR_ATTEMPT`` and the incarnation epoch as
``LGBM_TPU_GROUP_EPOCH``), and watches two liveness signals, cheapest
first:

* **exit codes**: a rank that dies is seen at the next poll
  (``rank_dead``);
* **heartbeat files**: each rank stamps iteration and wall time into
  ``<output_model>.heartbeat.rank_R`` at its iteration boundaries
  (``heartbeat_interval``); a live process whose stamp is older than the
  effective hang timeout is wedged (``rank_hang``).

``hang_timeout`` is raised to clear the collectives' worst case
(:func:`effective_hang_timeout`), so that a rank stuck in a host-object
collective surfaces first as a named ``CollectiveError`` with a crash
report.

On either signal the supervisor runs one restart cycle:

1. **teardown**: SIGTERM to every live rank, SIGKILL to whatever is left
   after ``term_grace`` seconds;
2. **triage**: the ranks' crash reports (``<output_model>.crash.rank_R``)
   become ``crash_report`` events;
3. **budget**: at most ``restart_limit`` restarts without forward progress,
   with a backoff doubling from ``restart_backoff``; a newer committed
   checkpoint than at the last restart refills the budget;
4. **relaunch**: stale tmp files and the dead incarnation's liveness files
   are swept, the new epoch stamped beside ``output_model`` (the
   rendezvous fence), and the group spawned again; workers that train with
   ``resume=True`` continue from the newest set valid on every rank.

Every decision is an event of :mod:`~lightgbm_tpu_torch.obs.counters`:
``rank_dead``, ``rank_hang``, ``group_restart``,
``restart_budget_exhausted``, ``crash_report`` and ``stale_sweep``.  The
straggler and metrics legs wait for the observability item, the shrinking
of the group for elastic groups, and ``python -m`` for the CLI (ROADMAP.md
§1.6).
"""
from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

from . import checkpoint as checkpoint_mod
from .obs.counters import counters
from .utils import log

DEFAULT_HANG_TIMEOUT = 300.0
# the launch count each incarnation sees: lets a harness arm behaviour on
# the first incarnation only
ATTEMPT_ENV = "LGBM_TPU_SUPERVISOR_ATTEMPT"


def effective_hang_timeout(hang_timeout: float, heartbeat_interval: float,
                           collective_timeout: Optional[float],
                           collective_retries: int = 0) -> float:
    """The hang timeout enforced: the configured one (0: 300 s), raised to
    clear the collective ladder's worst case, ``collective_timeout *
    (collective_retries + 1) + heartbeat_interval + 1``, so that an
    in-band ``CollectiveError`` surfaces first (a dead rank's exit code
    and crash report say more than a quiet heartbeat)."""
    t = float(hang_timeout) if hang_timeout and hang_timeout > 0 \
        else DEFAULT_HANG_TIMEOUT
    if collective_timeout and collective_timeout > 0:
        floor = (float(collective_timeout) * (int(collective_retries) + 1)
                 + float(heartbeat_interval) + 1.0)
        if t < floor:
            log.warning("hang_timeout %gs raised to %gs so the collective "
                        "ladder (timeout %gs x %d attempt(s)) can surface "
                        "an in-band CollectiveError first", t, floor,
                        collective_timeout, collective_retries + 1)
            t = floor
    return t


class _Rank:
    __slots__ = ("rank", "proc", "spawned_at")

    def __init__(self, rank: int, proc: subprocess.Popen, spawned_at: float):
        self.rank = rank
        self.proc = proc
        self.spawned_at = spawned_at


class Supervisor:
    """Spawn, watch and heal one training group of ``world`` ranks running
    ``argv``, whose snapshots and liveness files live under the prefix
    ``output_model``.  ``env`` is added to every rank's environment;
    ``prelaunch(supervisor)`` runs before every launch (for example
    :func:`~.parallel.mesh.refresh_local_ports` for a group on one host).
    Each rank's output goes to ``<output_model>.rank_R.log``."""

    def __init__(self, argv: Sequence[str], output_model: str,
                 world: int = 1, *,
                 heartbeat_interval: float = 1.0,
                 hang_timeout: float = 0.0,
                 restart_limit: int = 3,
                 restart_backoff: float = 1.0,
                 collective_timeout: Optional[float] = None,
                 collective_retries: int = 0,
                 term_grace: Optional[float] = None,
                 startup_grace: Optional[float] = None,
                 poll_interval: float = 0.1,
                 env: Optional[Dict[str, str]] = None,
                 prelaunch: Optional[Callable[["Supervisor"], None]] = None):
        self.argv = list(argv)
        self.output_model = str(output_model)
        self.world = max(1, int(world))
        self.heartbeat_interval = float(heartbeat_interval)
        self.hang_timeout = effective_hang_timeout(
            hang_timeout, heartbeat_interval, collective_timeout,
            collective_retries)
        # before its first heartbeat a rank is starting (imports, device
        # set-up, the Dataset), with a deadline of its own
        self.startup_grace = float(startup_grace) \
            if startup_grace is not None else max(self.hang_timeout, 60.0)
        self.restart_limit = max(0, int(restart_limit))
        self.restart_backoff = max(0.0, float(restart_backoff))
        self.term_grace = float(term_grace) if term_grace is not None \
            else (float(collective_timeout or 10.0) + 5.0)
        self.poll_interval = float(poll_interval)
        self.env = dict(env or {})
        self.prelaunch = prelaunch
        self.attempt = 0              # relaunches so far
        self._ranks: List[_Rank] = []
        self._progress_mark: Optional[int] = None
        self._restarts_since_progress = 0

    # ------------------------------------------------------------- lifecycle

    def run(self) -> int:
        """Supervise until the group completes (0) or the restart budget is
        spent (1)."""
        d = os.path.dirname(os.path.abspath(self.output_model))
        os.makedirs(d, exist_ok=True)
        # a previous job's leftovers under this prefix: dead-pid tmps,
        # orphan crash reports, stale heartbeats
        checkpoint_mod.sweep_stale_tmp(self.output_model,
                                       crash_reports=True, heartbeats=True)
        self._progress_mark = checkpoint_mod.latest_committed_iteration(
            self.output_model)
        self._restarts_since_progress = 0
        self._launch()
        while True:
            time.sleep(self.poll_interval)
            verdict = self._check()
            if verdict is None:
                continue
            if verdict == "done":
                log.info("Supervisor: all %d rank(s) completed cleanly "
                         "(%d restart(s) along the way)", self.world,
                         self.attempt)
                return 0
            reason, rank, detail = verdict
            self._teardown()
            self._collect_crash_reports()
            it = checkpoint_mod.latest_committed_iteration(self.output_model)
            if it is not None and (self._progress_mark is None
                                   or it > self._progress_mark):
                # forward progress since the last restart: refill the budget
                self._progress_mark = it
                self._restarts_since_progress = 0
            self._restarts_since_progress += 1
            since = self._restarts_since_progress
            if since > self.restart_limit:
                counters.event("restart_budget_exhausted",
                               limit=self.restart_limit,
                               attempts=self.attempt + 1,
                               reason=reason, rank=rank,
                               resume_iteration=it)
                log.warning("Supervisor: restart budget exhausted (%d "
                            "restart(s) without forward progress, last "
                            "failure: %s on rank %d); giving up — the last "
                            "committed checkpoint is iteration %s",
                            self.restart_limit, reason, rank, it)
                return 1
            delay = self.restart_backoff * (2 ** (since - 1))
            self.attempt += 1
            counters.event("group_restart", attempt=self.attempt,
                           restarts_since_progress=since,
                           resume_iteration=it, backoff=delay,
                           reason=reason, rank=rank, detail=detail)
            log.warning("Supervisor: %s (rank %d, %s) — restarting the "
                        "group from committed iteration %s in %.2gs "
                        "(restart %d/%d since last progress)", reason, rank,
                        detail, it, delay, since, self.restart_limit)
            if delay > 0:
                time.sleep(delay)
            self._launch()

    def _launch(self) -> None:
        # a fresh incarnation inherits none of the last one's liveness
        # files: dead-pid tmps, old heartbeats and files stamped with a
        # dead epoch are swept (the crash reports of the incarnation that
        # just failed were read by _collect_crash_reports)
        checkpoint_mod.sweep_stale_tmp(self.output_model, heartbeats=True,
                                       current_epoch=self.attempt)
        # the rendezvous fence: the new epoch is stamped before any spawn
        checkpoint_mod.write_group_epoch_file(self.output_model,
                                              self.attempt)
        if self.prelaunch is not None:
            self.prelaunch(self)
        self._ranks = []
        for r in range(self.world):
            env = dict(os.environ)
            env.update(self.env)
            env["LGBM_TPU_RANK"] = str(r)
            env[ATTEMPT_ENV] = str(self.attempt)
            env[checkpoint_mod.GROUP_EPOCH_ENV] = str(self.attempt)
            logf = open(f"{self.output_model}.rank_{r}.log", "ab")
            try:
                proc = subprocess.Popen(self.argv, env=env, stdout=logf,
                                        stderr=subprocess.STDOUT)
            finally:
                logf.close()      # the child holds its own descriptor
            self._ranks.append(_Rank(r, proc, time.time()))
        log.info("Supervisor: launched %d rank(s) (attempt %d): %s",
                 self.world, self.attempt, " ".join(self.argv))

    # ------------------------------------------------------------- liveness

    def _check(self):
        """One poll: None (healthy), ``"done"`` (every rank exited 0), or
        ``(reason, rank, detail)`` for the first failure seen."""
        all_done = True
        for rk in self._ranks:
            rc = rk.proc.poll()
            if rc is None:
                all_done = False
            elif rc != 0:
                hb = checkpoint_mod.read_heartbeat(
                    checkpoint_mod.heartbeat_path(self.output_model,
                                                  rk.rank))
                counters.event("rank_dead", rank=rk.rank, exit_code=rc,
                               last_heartbeat_iteration=(
                                   hb[0] if hb else None))
                return ("rank_dead", rk.rank, f"exit code {rc}")
        if all_done:
            return "done"
        now = time.time()
        for rk in self._ranks:
            if rk.proc.poll() is not None:      # exited 0: stops beating
                continue
            hb = checkpoint_mod.read_heartbeat(
                checkpoint_mod.heartbeat_path(self.output_model, rk.rank))
            age = hb[1] if hb is not None else now - rk.spawned_at
            deadline = self.hang_timeout if hb is not None \
                else self.startup_grace
            if age > deadline:
                counters.event("rank_hang", rank=rk.rank,
                               heartbeat_age=round(age, 3),
                               hang_timeout=deadline,
                               phase="beating" if hb else "starting",
                               iteration=(hb[0] if hb else None))
                return ("rank_hang", rk.rank,
                        f"heartbeat {age:.1f}s old (timeout {deadline:g}s"
                        + ("" if hb else ", never stamped") + ")")
        return None

    # ------------------------------------------------------------- teardown

    def _teardown(self) -> None:
        """SIGTERM first (a rank with ``preempt_signal`` checkpoints and
        exits), SIGKILL for whatever is alive after ``term_grace``."""
        live = [rk for rk in self._ranks if rk.proc.poll() is None]
        for rk in live:
            try:
                rk.proc.terminate()
            except OSError:      # pragma: no cover - exited under our feet
                pass
        deadline = time.time() + self.term_grace
        for rk in live:
            try:
                rk.proc.wait(timeout=max(0.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                log.warning("Supervisor: rank %d still alive %gs after "
                            "SIGTERM; escalating to SIGKILL", rk.rank,
                            self.term_grace)
                try:
                    rk.proc.kill()
                except OSError:  # pragma: no cover - exited under our feet
                    pass
                rk.proc.wait()

    def _collect_crash_reports(self) -> None:
        for r in range(self.world):
            path = checkpoint_mod.crash_report_path(self.output_model, r)
            if not os.path.exists(path):
                continue
            counters.event("crash_report", rank=r, path=path,
                           bytes=os.path.getsize(path))
            log.warning("Supervisor: rank %d left a crash report: %s",
                        r, path)
