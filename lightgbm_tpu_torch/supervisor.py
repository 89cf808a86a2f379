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

**Elastic groups** (``elastic_resume``, :meth:`Supervisor._shrink`,
``lightgbm_tpu/supervisor.py:336-422``): a rank that dies before its
first heartbeat ``world_shrink_after`` launches in a row is a lost host.
The supervisor evicts it (``rank_evicted``), pre-flights the smaller
group's layout with :func:`~.parallel.mesh.plan_mesh` from the newest
manifest (a layout that cannot be planned ends supervision:
``mesh_plan_failed``), drops the rank from the machine list, sweeps the
evicted top rank's heartbeat, crash report and flight stream, and
relaunches one rank smaller (``world_resize``) with ``LGBM_TPU_WORLD``
set, through the elastic resume.  Never below ``elastic_min_ranks``.

**Health** (:meth:`Supervisor._straggler_check`, :504-549): with
``obs_stream`` it tails every rank's flight stream and raises one
``rank_straggler`` event an incarnation for a rank ``straggler_factor``
behind the group's median progress rate (a verdict, not a restart),
citing the rank's idle gap where devprof stamped one.  With
``metrics_port`` it serves its own ``/metrics`` (:meth:`_metrics_samples`,
:200-235): the restart budget left, the last restart, ``world_size``,
``rank_evicted_total`` and each rank's heartbeat age.

Every decision is an event of :mod:`~lightgbm_tpu_torch.obs.counters`:
``rank_dead``, ``rank_hang``, ``group_restart``,
``restart_budget_exhausted``, ``crash_report``, ``stale_sweep``,
``rank_evicted``, ``world_resize``, ``mesh_plan_failed`` and
``rank_straggler``.

:func:`main` (``python -m lightgbm_tpu_torch.supervisor <cli args>``)
supervises the same arguments' ``python -m lightgbm_tpu_torch.cli``
training (``lightgbm_tpu/supervisor.py:588-644``).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

from . import checkpoint as checkpoint_mod
from .obs import flight as flight_mod
from .obs import metrics as metrics_mod
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
    Each rank's output goes to ``<output_model>.rank_R.log``.  The
    keyword arguments after ``prelaunch`` are the health and elastic legs
    (module docstring)."""

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
                 prelaunch: Optional[Callable[["Supervisor"], None]] = None,
                 obs_stream: str = "",
                 straggler_factor: float = 4.0,
                 straggler_interval: float = 1.0,
                 metrics_port: int = 0,
                 elastic_resume: bool = False,
                 elastic_min_ranks: int = 1,
                 world_shrink_after: int = 2,
                 machine_list_file: str = "",
                 hbm_budget: int = 0):
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
        # health: the ranks' flight streams under obs_stream, tailed for
        # straggler verdicts, and the supervisor's own /metrics
        self.obs_stream = str(obs_stream or "")
        self.straggler_factor = max(1.001, float(straggler_factor))
        self.straggler_interval = max(0.1, float(straggler_interval))
        self.metrics_port = int(metrics_port or 0)
        self._last_restart_unix = 0.0
        self._last_straggler_check = 0.0
        self._stragglers_flagged: set = set()
        # elastic groups: consecutive startup failures a rank, and the
        # evictions so far
        self.elastic_resume = bool(elastic_resume)
        self.elastic_min_ranks = max(1, int(elastic_min_ranks))
        self.world_shrink_after = max(1, int(world_shrink_after))
        self.machine_list_file = str(machine_list_file or "")
        self.hbm_budget = int(hbm_budget or 0)
        self._startup_failures: Dict[int, int] = {}
        self._evicted_total = 0
        # seconds of the last shrink by leg (detection to relaunch)
        self.shrink_seconds: Dict[str, float] = {}
        metrics_mod.register_source(self._metrics_samples)

    def _metrics_samples(self) -> list:
        """The supervisor's ``/metrics`` (supervisor.py:200): the restart
        budget left, the last restart's time, ``world_size`` and
        ``rank_evicted_total`` (a shrink is the drop of one and the rise
        of the other in one scrape), and each live rank's heartbeat age
        (-1: never stamped), read from the files at scrape time."""
        out = [
            ("restart_budget_remaining", {},
             float(max(0, self.restart_limit
                       - self._restarts_since_progress)), "gauge"),
            ("last_restart_unix", {}, float(self._last_restart_unix),
             "gauge"),
            ("supervisor_restarts", {}, float(self.attempt), "counter"),
            ("supervisor_world", {}, float(self.world), "gauge"),
            ("world_size", {}, float(self.world), "gauge"),
            ("rank_evicted_total", {}, float(self._evicted_total),
             "counter"),
        ]
        for r in range(self.world):
            hb = checkpoint_mod.read_heartbeat(
                checkpoint_mod.heartbeat_path(self.output_model, r))
            out.append(("rank_heartbeat_age_seconds", {"rank": str(r)},
                        float(hb[1]) if hb else -1.0, "gauge"))
            if hb:
                out.append(("rank_iteration", {"rank": str(r)},
                            float(hb[0]), "gauge"))
        return out

    # ------------------------------------------------------------- lifecycle

    def run(self) -> int:
        """Supervise until the group completes (0) or the restart budget is
        spent or a shrunk world cannot be planned (1)."""
        d = os.path.dirname(os.path.abspath(self.output_model))
        os.makedirs(d, exist_ok=True)
        # a previous job's leftovers under this prefix: dead-pid tmps,
        # orphan crash reports, stale heartbeats
        checkpoint_mod.sweep_stale_tmp(self.output_model,
                                       crash_reports=True, heartbeats=True)
        self._progress_mark = checkpoint_mod.latest_committed_iteration(
            self.output_model)
        exporter = False
        if self.metrics_port > 0:
            metrics_mod.start_exporter(self.metrics_port)
            exporter = True
        try:
            return self._run_loop()
        finally:
            if exporter:
                metrics_mod.stop_exporter()

    def _run_loop(self) -> int:
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
            t_detect = time.perf_counter()
            self._teardown()
            self._collect_crash_reports()
            # a rank with no heartbeat of this incarnation (_launch sweeps
            # them) died before its first iteration boundary: the
            # repeatable shape of a lost host.  One that beat resets.
            hb = checkpoint_mod.read_heartbeat(
                checkpoint_mod.heartbeat_path(self.output_model, rank))
            if hb is None:
                self._startup_failures[rank] = \
                    self._startup_failures.get(rank, 0) + 1
            else:
                self._startup_failures.pop(rank, None)
            if (self.elastic_resume
                    and self._startup_failures.get(rank, 0)
                    >= self.world_shrink_after
                    and self.world - 1 >= self.elastic_min_ranks):
                rc = self._shrink(rank, reason, detail, t_detect)
                if rc is not None:
                    return rc
                continue
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
            self._last_restart_unix = time.time()
            counters.gauge("restart_budget_remaining",
                           max(0, self.restart_limit - since))
            counters.gauge("last_restart_unix", self._last_restart_unix)
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

    def _shrink(self, rank: int, reason: str, detail: str,
                t_detect: float) -> Optional[int]:
        """Evict ``rank`` (its host is not coming back), pre-flight the
        smaller group's layout and relaunch at ``world - 1`` through the
        elastic resume (supervisor.py:336-422).  Returns None when
        supervision goes on, 1 when the smaller world cannot be planned.
        ``shrink_seconds`` keeps each leg's seconds from ``t_detect`` (the
        failed launch's detection): the teardown, the pre-flight, the
        sweep and the relaunch."""
        t_plan = time.perf_counter()
        counters.event("rank_evicted", rank=rank, reason=reason,
                       detail=detail, world=self.world,
                       startup_failures=self._startup_failures.get(rank, 0))
        log.warning("Supervisor: rank %d failed at startup %d time(s) in a "
                    "row (%s, %s) — declaring its host lost and shrinking "
                    "the group", rank, self._startup_failures.get(rank, 0),
                    reason, detail)
        new_world = self.world - 1
        # the pre-flight of the shrunk device set, from the newest
        # manifest; a capacity is enforced only under an hbm_budget
        it = checkpoint_mod.latest_committed_iteration(self.output_model)
        manifest = None
        if it is not None:
            try:
                manifest = checkpoint_mod.load_manifest(self.output_model,
                                                        it)
            except checkpoint_mod.CheckpointError:
                manifest = None
        if manifest and manifest.get("num_data_global"):
            from .parallel.mesh import MeshPlanError, plan_mesh
            try:
                plan_mesh(new_world, int(manifest["num_data_global"]),
                          max(1, int(manifest.get("num_features", 1) or 1)),
                          bins=max(1, int(manifest.get("max_bin", 255)
                                          or 255)),
                          leaves=max(2, int(manifest.get("num_leaves", 31)
                                            or 31)),
                          num_class=max(1, int(manifest.get("num_class", 1)
                                               or 1)),
                          capacity=(self.hbm_budget
                                    if self.hbm_budget > 0 else None))
            except MeshPlanError as e:
                counters.event("mesh_plan_failed", world=new_world,
                               evicted_rank=rank, error=str(e))
                log.warning("Supervisor: cannot shrink to %d rank(s) — "
                            "mesh pre-flight refused the layout: %s",
                            new_world, e)
                return 1
        # the smaller group's rendezvous never waits on the lost host
        if self.machine_list_file \
                and os.path.exists(self.machine_list_file):
            from .parallel import mesh
            machines = mesh.parse_machine_list(self.machine_list_file)
            if rank < len(machines):
                del machines[rank]
                mesh.write_machine_list(self.machine_list_file, machines)
        t_sweep = time.perf_counter()
        old_world = self.world
        self.world = new_world
        self.attempt += 1
        self._startup_failures = {}
        self._restarts_since_progress = 0
        self._last_restart_unix = time.time()
        self._evicted_total += 1
        # the per-rank gauges cover range(world): the top index leaves
        # /metrics by renumbering, and its files go too
        for r in range(new_world, old_world):
            victims = [checkpoint_mod.heartbeat_path(self.output_model, r),
                       checkpoint_mod.crash_report_path(self.output_model,
                                                        r)]
            if self.obs_stream:
                victims.append(flight_mod.stream_path(self.obs_stream, r))
            for path in victims:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        counters.gauge("world_size", self.world)
        counters.gauge("rank_evicted_total", self._evicted_total)
        counters.event("world_resize", world=self.world, evicted_rank=rank,
                       attempt=self.attempt, resume_iteration=it)
        log.warning("Supervisor: relaunching at world=%d (attempt %d) via "
                    "elastic resume from committed iteration %s",
                    self.world, self.attempt, it)
        t_launch = time.perf_counter()
        self._launch()
        t_end = time.perf_counter()
        self.shrink_seconds = {
            "teardown": round(t_plan - t_detect, 6),
            "preflight": round(t_sweep - t_plan, 6),
            "sweep": round(t_launch - t_sweep, 6),
            "relaunch": round(t_end - t_launch, 6)}
        return None

    def _launch(self) -> None:
        # a fresh incarnation inherits none of the last one's liveness
        # files: dead-pid tmps, old heartbeats and files stamped with a
        # dead epoch are swept (the crash reports of the incarnation that
        # just failed were read by _collect_crash_reports)
        checkpoint_mod.sweep_stale_tmp(self.output_model, heartbeats=True,
                                       current_epoch=self.attempt,
                                       flight_base=self.obs_stream)
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
            # the elastic world override (engine.train)
            env["LGBM_TPU_WORLD"] = str(self.world)
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
        self._straggler_check(now)
        return None

    def _straggler_check(self, now: float) -> None:
        """Health beyond liveness (supervisor.py:504): every
        ``straggler_interval`` seconds, tail each rank's flight stream and
        compare progress rates; a rank ``straggler_factor`` behind the
        median raises one ``rank_straggler`` event an incarnation (a
        verdict, never a restart), citing its ``idle_gap_fraction`` when
        devprof stamped one.  Host file reads only."""
        if not self.obs_stream \
                or now - self._last_straggler_check < self.straggler_interval:
            return
        self._last_straggler_check = now
        rates, tails = {}, {}
        for r in range(self.world):
            recs = flight_mod.tail_records(
                flight_mod.stream_path(self.obs_stream, r))
            tails[r] = recs
            rates[r] = flight_mod.progress_rate(recs)
        for s in flight_mod.detect_stragglers(rates, self.straggler_factor):
            key = (s["rank"], self.attempt)
            if key in self._stragglers_flagged:
                continue
            self._stragglers_flagged.add(key)
            extra = {}
            gap = flight_mod.recent_idle_gap(tails.get(s["rank"], []))
            if gap is not None:
                extra["idle_gap_fraction"] = gap
            counters.event("rank_straggler", rank=s["rank"],
                           rate=s["rate"], median_rate=s["median_rate"],
                           behind=s["behind"],
                           factor=self.straggler_factor,
                           attempt=self.attempt, **extra)
            counters.gauge(f"rank_straggler_behind_r{s['rank']}",
                           s["behind"])
            log.warning("Supervisor: rank %d is a straggler — %.3g it/s "
                        "vs group median %.3g (%.3gx behind, threshold "
                        "%gx); group is alive but not healthy",
                        s["rank"], s["rate"], s["median_rate"],
                        s["behind"], self.straggler_factor)

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


# ------------------------------------------------------------------ CLI

def main(argv: Optional[List[str]] = None) -> int:
    """``python -m lightgbm_tpu_torch.supervisor <cli args>``: supervise
    the ``python -m lightgbm_tpu_torch.cli`` training of the same
    arguments.  The worker command is that argument list plus
    ``snapshot_resume=true`` (every incarnation resumes from the newest
    set valid everywhere; a first launch with no snapshots trains from
    scratch) and the effective ``heartbeat_interval``; with
    ``metrics_port`` P the supervisor serves P and the ranks P + 1 + rank.
    The workers' device is the arguments' (``cuda`` unless ``device=cpu``):
    without a card the supervisor raises before it launches any."""
    argv = list(sys.argv[1:] if argv is None else argv)
    from .cli import parse_cli
    from .config import config_from_params, resolve_device
    params = parse_cli(argv)
    cfg = config_from_params(params)
    log.set_verbosity(cfg.verbose)
    resolve_device(cfg.device)
    heartbeat = cfg.heartbeat_interval if cfg.heartbeat_interval > 0 else 1.0
    worker_argv = ([sys.executable, "-m", "lightgbm_tpu_torch.cli"] + argv +
                   [f"heartbeat_interval={heartbeat}",
                    "snapshot_resume=true"])
    if cfg.metrics_port > 0:
        worker_argv.append(f"metrics_port={cfg.metrics_port + 1}")
    prelaunch = None
    if cfg.num_machines > 1 and cfg.machine_list_file:
        from .parallel import mesh

        def prelaunch(sup, _path=cfg.machine_list_file):
            # a group on one host: the dead coordinator's port can linger
            # in TIME_WAIT, so the loopback entries get fresh ports each
            # incarnation (other entries are left as they are)
            mesh.refresh_local_ports(_path)
    sup = Supervisor(
        worker_argv, cfg.output_model, cfg.num_machines,
        heartbeat_interval=heartbeat, hang_timeout=cfg.hang_timeout,
        restart_limit=cfg.restart_limit,
        restart_backoff=cfg.restart_backoff,
        collective_timeout=cfg.collective_timeout,
        collective_retries=cfg.collective_retries, prelaunch=prelaunch,
        obs_stream=cfg.obs_stream_path,
        straggler_factor=cfg.straggler_factor,
        metrics_port=cfg.metrics_port,
        elastic_resume=cfg.elastic_resume,
        elastic_min_ranks=cfg.elastic_min_ranks,
        world_shrink_after=cfg.world_shrink_after,
        machine_list_file=cfg.machine_list_file,
        hbm_budget=cfg.hbm_budget)
    rc = sup.run()
    for name in ("rank_dead", "rank_hang", "group_restart",
                 "restart_budget_exhausted", "rank_straggler",
                 "rank_evicted", "world_resize", "mesh_plan_failed"):
        for e in counters.events(name):
            log.info("supervisor event: %s", e)
    return rc


if __name__ == "__main__":
    sys.exit(main())
