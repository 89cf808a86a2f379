"""Training entry points ``train`` and ``cv`` (python-package
engine.py:18-460, as ``lightgbm_tpu/engine.py`` writes them): the
callback-driven boosting loop with custom objectives and metrics
(``fobj``, ``feval``), a learning-rate schedule, early stopping and
evaluation records, continued training from ``init_model``,
cross-validation over stratified, shuffled or query-grouped folds, and
the robustness of ``lightgbm_tpu/engine.py:100-135, :233-400``: resumable
snapshots (``snapshot_freq``, ``snapshot_keep``, ``snapshot_resume`` /
``resume=``; one file alone, the coordinated shard set over processes),
preemption safety (``preempt_signal``), liveness heartbeats and crash
reports for the supervisor (``heartbeat_interval``), and the fault points
of the iteration boundary (``rank_crash``, ``rank_hang``, ``preempt``)."""
from __future__ import annotations

import collections
import os
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from . import callback as callback_mod
from . import checkpoint as checkpoint_mod
from .basic import Booster, Dataset
from .config import canonicalize_params, config_from_params
from .obs.counters import counters
from .parallel import sync
from .parallel.mesh import init_distributed_from_config
from .utils import faults as faults_mod
from .utils import log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name: Union[str, List[str]] = "auto",
          categorical_feature: Union[str, List] = "auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int] = True,
          learning_rates: Optional[Union[List[float], Callable]] = None,
          keep_training_booster: bool = True,
          callbacks: Optional[List[Callable]] = None,
          resume: Optional[Union[bool, str]] = None) -> Booster:
    """Train a booster (``lightgbm_tpu/engine.py:24``); runs on the CUDA
    device unless ``params`` has ``device="cpu"``.  ``fobj(preds,
    train_data) -> (grad, hess)`` replaces the objective's gradients,
    ``feval(preds, data)`` adds metrics; ``learning_rates`` (a list or a
    function of the iteration) schedules the learning rate through the
    ``reset_parameter`` callback.  ``init_model`` (a ``Booster`` or a
    model file) continues training (``lightgbm_tpu/engine.py:145-157``):
    its raw predictions of the training rows are added to the training
    scores, its trees come first in the model and its iterations count as
    done.  ``resume`` (also the ``snapshot_resume`` param): ``True`` finds
    the newest valid ``<output_model>.snapshot_iter_N`` (a torn file falls
    back to the one before; over processes, the newest set valid on every
    rank) and continues from it with the training state restored bit for
    bit; a string resumes from that snapshot file."""
    params = canonicalize_params(params)
    cfg = config_from_params(params)
    # a fault plan of the params is this training's; one armed from the
    # environment stays the process's
    prev_faults = faults_mod.get_faults()
    if cfg.fault_inject:
        faults_mod.install(cfg.fault_inject)
    try:
        return _train(params, cfg, train_set, num_boost_round, valid_sets,
                      valid_names, fobj, feval, init_model, feature_name,
                      categorical_feature, early_stopping_rounds,
                      evals_result, verbose_eval, learning_rates, callbacks,
                      resume)
    finally:
        if cfg.fault_inject:
            faults_mod.restore(prev_faults)


def _resume_flag(resume):
    """``resume`` as True, False or a snapshot path."""
    if isinstance(resume, str):
        s = resume.strip().lower()
        if s in ("false", "0", "no", "off", "-", ""):
            return False
        if s in ("true", "1", "yes", "on", "+", "auto"):
            return True
    return resume


def _train(params, cfg, train_set, num_boost_round, valid_sets, valid_names,
           fobj, feval, init_model, feature_name, categorical_feature,
           early_stopping_rounds, evals_result, verbose_eval, learning_rates,
           callbacks, resume) -> Booster:
    sync.configure(retries=cfg.collective_retries)
    # several processes (lightgbm_tpu/engine.py:106-135): the process
    # group comes up before the Dataset is built, with its timeout
    if cfg.num_machines > 1:
        init_distributed_from_config(cfg)
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    if params.get("early_stopping_round"):
        early_stopping_rounds = int(params.pop("early_stopping_round"))
    if fobj is not None:
        params.setdefault("objective", "regression")
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    booster = Booster(params=params, train_set=train_set)
    if init_model is not None:
        prev = (init_model if isinstance(init_model, Booster)
                else Booster(model_file=str(init_model), params=params))
        inner = booster.inner
        raw = train_set.ensure_raw()
        if raw is None:
            log.fatal("Continued training requires raw data "
                      "(set free_raw_data=False)")
        raw = prev.inner.predictor(inner.device).predict_raw(raw)
        inner.scores += torch.from_numpy(raw.astype(np.float32)).to(
            inner.device)
        inner.num_init_iteration = prev.inner.current_iteration()
        inner.models = list(prev.inner.models) + inner.models
        inner.boost_from_average_ = prev.inner.boost_from_average_

    valid_sets = valid_sets or []
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    valid_names = valid_names or [f"valid_{i}" for i in range(len(valid_sets))]
    contains_train = False
    train_name = "training"
    for vs, name in zip(valid_sets, valid_names):
        if vs is train_set:
            contains_train, train_name = True, name
            continue
        booster.add_valid(vs, name)

    cbs = list(callbacks or [])
    if verbose_eval is True:
        cbs.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        cbs.append(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback_mod.early_stopping(early_stopping_rounds,
                                               bool(verbose_eval)))
    if learning_rates is not None:
        cbs.append(callback_mod.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        cbs.append(callback_mod.record_evaluation(evals_result))
    before = sorted((cb for cb in cbs if getattr(cb, "before_iteration",
                                                 False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in cbs if not getattr(cb, "before_iteration",
                                                    False)),
                   key=lambda cb: getattr(cb, "order", 0))

    snapshot_out = cfg.output_model
    world = sync.process_count()
    # alone, the rank of LGBM_TPU_RANK: a supervisor may run independent
    # single-process workers under one prefix, whose liveness files stay
    # apart
    rank = sync.process_index() if world > 1 else faults_mod.current_rank()
    single = world == 1
    ckpt_callbacks = before + after     # a fixed capture/restore order

    def write_checkpoint(iteration: int) -> None:
        """One atomic snapshot at an iteration boundary: the single file
        alone, the shard set (shards, the CRC barrier, rank 0's manifest)
        over processes."""
        if single:
            checkpoint_mod.write_snapshot(
                checkpoint_mod.snapshot_path(snapshot_out, iteration),
                booster, iteration, ckpt_callbacks, evals_result)
            if cfg.snapshot_keep > 0:
                checkpoint_mod.prune_snapshots(snapshot_out,
                                               cfg.snapshot_keep)
            return
        state = checkpoint_mod.capture_state(booster, iteration,
                                             ckpt_callbacks, evals_result)
        checkpoint_mod.write_group_snapshot(
            snapshot_out, iteration,
            booster.model_to_string(-1) if rank == 0 else "", state,
            rank=rank, world=world,
            fingerprint=state["booster"]["data_fingerprint"])
        if cfg.snapshot_keep > 0 and rank == 0:
            # after the manifest's commit, which every shard preceded
            checkpoint_mod.prune_snapshots(snapshot_out, cfg.snapshot_keep)

    # ---- resume from the newest valid snapshot ----
    resume = _resume_flag(cfg.snapshot_resume if resume is None else resume)
    start_iter = 0
    if resume:
        pinned = isinstance(resume, str)
        if single and pinned:
            _, state = checkpoint_mod.load_snapshot(resume)
            found = (int(state["iteration"]), resume, state)
        elif single:
            found = checkpoint_mod.find_latest_valid(snapshot_out)
        else:
            # the resume barrier: the newest set valid on every rank; a
            # topology or data mismatch raises on every rank together
            found = checkpoint_mod.find_latest_valid_group(
                snapshot_out, rank=rank, world=world,
                fingerprint=booster.inner.data_fingerprint(),
                only_iteration=(checkpoint_mod.iteration_from_path(resume)
                                if pinned else None))
        if found is None:
            log.info("snapshot_resume: no valid snapshot for %s; "
                     "training from scratch", snapshot_out)
        else:
            _, ck_path, state = found
            start_iter = checkpoint_mod.restore_state(
                booster, state, ckpt_callbacks, evals_result)
            counters.event("checkpoint_resume", iteration=start_iter,
                           path=ck_path, kind="single" if single else "group")
            log.info("Resumed training from %s (continuing at iteration %d)",
                     ck_path, start_iter)

    # preemption: the handlers are installed right before the try whose
    # finally restores them
    preempt_watch = checkpoint_mod.PreemptionWatch(cfg.preempt_signal).install()
    preempt_armed = (preempt_watch.armed
                     or faults_mod.get_faults().has_point("preempt"))
    heartbeat = None
    if cfg.heartbeat_interval > 0:
        heartbeat = checkpoint_mod.Heartbeat(
            checkpoint_mod.heartbeat_path(snapshot_out, rank),
            cfg.heartbeat_interval)
        heartbeat.stamp(start_iter, force=True)

    def boundary_liveness(iteration: int) -> None:
        """Once an iteration boundary: the supervisor's fault points (a
        hard death, a wedged rank), then the heartbeat."""
        fi = faults_mod.get_faults()
        if fi.enabled and fi.fire("rank_crash", iteration):
            log.warning("rank_crash fault: rank %d dying hard at iteration "
                        "%d (os._exit, no checkpoint)", rank, iteration)
            os._exit(70)
        if fi.enabled and fi.fire("rank_hang", iteration):
            log.warning("rank_hang fault: rank %d wedging at iteration %d "
                        "(heartbeats stop now)", rank, iteration)
            while True:      # only SIGKILL, or the supervisor, ends this
                time.sleep(3600)
        if heartbeat is not None:
            heartbeat.stamp(iteration)

    try:
        for i in range(start_iter, num_boost_round):
            for cb in before:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=None))
            finished = booster.update(fobj=fobj)
            results = []
            if valid_sets:
                if contains_train:
                    results.extend((train_name, m, v, hib) for (_, m, v, hib)
                                   in booster.eval_train(feval))
                results.extend(booster.eval_valid(feval))
            try:
                for cb in after:
                    cb(callback_mod.CallbackEnv(
                        model=booster, params=params, iteration=i,
                        begin_iteration=0, end_iteration=num_boost_round,
                        evaluation_result_list=results))
            except callback_mod.EarlyStopException as es:
                booster.best_iteration = es.best_iteration + 1
                for item in es.best_score or []:
                    booster.best_score.setdefault(item[0], {})[item[1]] = \
                        item[2]
                break
            # before the snapshot: a death at boundary K loses the
            # iterations since the last committed snapshot, as a real one
            boundary_liveness(i + 1)
            wrote = False
            if cfg.snapshot_freq > 0 and (i + 1) % cfg.snapshot_freq == 0:
                # after the callbacks, so the captured state is iteration i's
                write_checkpoint(i + 1)
                wrote = True
            if preempt_armed:
                fi = faults_mod.get_faults()
                want = preempt_watch.requested or (
                    fi.enabled and fi.fire("preempt", i + 1))
                if not single:
                    # a notice may reach one rank only: the group agrees
                    want = any(sync.allgather_object(bool(want)))
                if want:
                    if not wrote:
                        write_checkpoint(i + 1)
                    counters.event("preempt_checkpoint", iteration=i + 1)
                    log.info("Preemption requested: checkpoint written at "
                             "iteration %d; leaving the training loop "
                             "(snapshot_resume continues from here)", i + 1)
                    break
            if finished:
                break
        if booster.best_iteration <= 0:
            booster.best_iteration = booster.current_iteration()
        if heartbeat is not None:
            heartbeat.stamp(booster.current_iteration(), force=True)
    except BaseException as e:
        # a supervised rank (heartbeats on) leaves a crash report: the
        # exception, every thread's stack, the event ring's tail
        if heartbeat is not None:
            checkpoint_mod.write_crash_report(snapshot_out, rank, exc=e)
        raise
    finally:
        preempt_watch.restore()
    return booster


class CVBooster:
    """Every fold's booster of a cv run (reference engine.py:230-252): an
    unknown method is called on each fold's booster and returns their
    results as a list."""

    def __init__(self, boosters=None):
        self.boosters = list(boosters or [])
        self.best_iteration = -1

    def append(self, booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs)
                    for b in self.boosters]
        return handler


def _make_n_folds(full_data: Dataset, nfold: int, params: Dict, seed: int,
                  stratified: bool, shuffle: bool,
                  group_info: Optional[np.ndarray]):
    """(train rows, test rows, test queries or None) of each fold: whole
    queries where ``group_info`` gives them, else rows, stratified by label
    or not, shuffled from ``seed`` or not (lightgbm_tpu/engine.py:592)."""
    num_data = full_data.num_data()
    rng = np.random.RandomState(seed)
    if group_info is not None:
        group_sizes = np.asarray(group_info, dtype=np.int64)
        gidx = np.arange(len(group_sizes))
        if shuffle:
            rng.shuffle(gidx)
        bounds = np.concatenate([[0], np.cumsum(group_sizes)])
        for fg in np.array_split(gidx, nfold):
            test_idx = (np.concatenate(
                [np.arange(bounds[g], bounds[g + 1]) for g in fg])
                if len(fg) else np.empty(0, dtype=np.int64))
            yield np.setdiff1d(np.arange(num_data), test_idx), test_idx, fg
        return
    if stratified:
        label = full_data.get_label().astype(np.int64)
        folds = [[] for _ in range(nfold)]
        for cls in np.unique(label):
            idx = np.nonzero(label == cls)[0]
            if shuffle:
                rng.shuffle(idx)
            for f, part in enumerate(np.array_split(idx, nfold)):
                folds[f].append(part)
        for f in range(nfold):
            test_idx = np.concatenate(folds[f])
            yield np.setdiff1d(np.arange(num_data), test_idx), test_idx, None
        return
    idx = np.arange(num_data)
    if shuffle:
        rng.shuffle(idx)
    for part in np.array_split(idx, nfold):
        yield np.setdiff1d(np.arange(num_data), part), part, None


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True,
       metrics: Optional[Union[str, List[str]]] = None,
       fobj=None, feval=None, init_model=None,
       feature_name="auto", categorical_feature="auto",
       early_stopping_rounds: Optional[int] = None,
       verbose_eval=None, seed: int = 0,
       callbacks: Optional[List[Callable]] = None,
       eval_train_metric: bool = False) -> Dict[str, List[float]]:
    """Cross-validation (lightgbm_tpu/engine.py:629): a booster a fold,
    trained round by round; returns ``{"<metric>-mean": [...],
    "<metric>-stdv": [...]}`` over the folds, cut at the best iteration
    when ``early_stopping_rounds`` stops it.  As in the JAX package,
    ``init_model``, ``feature_name``, ``categorical_feature`` and
    ``callbacks`` are accepted and not used."""
    params = canonicalize_params(params)
    # several processes (lightgbm_tpu/engine.py:106-135): the process
    # group comes up before the Dataset is built, with its timeout
    cfg = config_from_params(params)
    if cfg.num_machines > 1:
        init_distributed_from_config(cfg)
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    if metrics is not None:
        params["metric"] = metrics
    # stratified folds only for classification objectives (engine.py:655)
    if params.get("objective", "").startswith(("binary",)) is False \
            and params.get("objective") not in ("binary", "multiclass",
                                                "multiclassova"):
        stratified = False if params.get("objective") else stratified

    train_set.construct(device=config_from_params(params).device,
                        on_device=False)
    raw = train_set.ensure_raw()
    if raw is None:
        log.fatal("cv requires raw data (set free_raw_data=False)")
    label = train_set.get_label()
    weight = train_set.get_weight()
    group = train_set.get_group()
    if folds is None:
        folds = list(_make_n_folds(train_set, nfold, params, seed,
                                   stratified and group is None, shuffle,
                                   group))
    else:
        folds = [(tr, te, None) if len(f) == 2 else f
                 for f in (tuple(f) for f in folds)]

    boosters: List[Booster] = []
    for train_idx, test_idx, _ in folds:
        tr = Dataset(raw[train_idx], label=label[train_idx],
                     weight=None if weight is None else weight[train_idx],
                     params=dict(params))
        te = tr.create_valid(
            raw[test_idx], label=label[test_idx],
            weight=None if weight is None else weight[test_idx])
        if group is not None:
            # each fold's query sizes
            gid = np.repeat(np.arange(len(group)),
                            np.asarray(group, dtype=np.int64))
            tr.group = np.bincount(gid[train_idx])[np.unique(gid[train_idx])]
            te.group = np.bincount(gid[test_idx])[np.unique(gid[test_idx])]
        booster = Booster(params=dict(params), train_set=tr)
        booster.add_valid(te, "valid")
        boosters.append(booster)

    results: Dict[str, List[float]] = collections.defaultdict(list)
    es_cb = (callback_mod.early_stopping(early_stopping_rounds, False)
             if early_stopping_rounds else None)
    for i in range(num_boost_round):
        all_evals = []
        for booster in boosters:
            booster.update(fobj=fobj)
            evals = booster.eval_valid(feval)
            if eval_train_metric:
                evals = list(booster.eval_train(feval)) + list(evals)
            all_evals.append(evals)
        agg: Dict[tuple, List[float]] = collections.defaultdict(list)
        order: List[tuple] = []
        for evals in all_evals:
            for name, metric, value, hib in evals:
                key = (name, metric, hib)
                if key not in agg:
                    order.append(key)
                agg[key].append(value)
        merged = []
        for key in order:
            name, metric, hib = key
            vals = agg[key]
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results[f"{metric}-mean"].append(mean)
            results[f"{metric}-stdv"].append(std)
            merged.append((f"cv_agg {name}", metric, mean, hib, std))
        if verbose_eval:
            log.info("[%d]\t%s", i + 1,
                     "\t".join(f"{m[1]}: {m[2]:g} + {m[4]:g}" for m in merged))
        if es_cb is not None:
            try:
                es_cb(callback_mod.CallbackEnv(
                    model=CVBooster(boosters), params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=merged))
            except callback_mod.EarlyStopException as es:
                for k in results:
                    results[k] = results[k][:es.best_iteration + 1]
                break
    return dict(results)
