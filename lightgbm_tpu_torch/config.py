"""Parameter system of the port.

The reference's config surface (``include/LightGBM/config.h``) as one flat
dataclass, cut to the fields this port reads.  The alias table
(``config.h:353-483``) is the JAX package's, and every key of the JAX
package's ``Config`` gets exactly one of three outcomes:

* **ported**: a field of :class:`Config`, read by the port;
* **taken as-is** (:data:`TAKEN_AS_IS`): accepted with any value and
  dropped, because the JAX package reads it nowhere, or only to pick TPU
  machinery that the port does not have;
* **not ported** (:data:`NOT_PORTED`): a value other than the JAX
  package's default raises ``NotImplementedError`` naming the ROADMAP.md
  port-queue item that brings it, instead of being ignored.

Unknown parameters are rejected as the reference rejects them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from .parallel.mesh import mesh_shape_extents
from .utils import log

# Alias -> canonical name (reference config.h:353-483, KeyAliasTransform),
# the JAX package's table (lightgbm_tpu/config.py:17-95)
PARAM_ALIASES: Dict[str, str] = {
    "config": "config_file",
    "nthread": "num_threads",
    "num_thread": "num_threads",
    "random_seed": "seed",
    "train_data": "data",
    "train": "data",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "pre_partition": "is_pre_partition",
    "training_metric": "is_training_metric",
    "train_metric": "is_training_metric",
    "local_port": "local_listen_port",
    "two_round_loading": "use_two_round_loading",
    "two_round": "use_two_round_loading",
    "mlist": "machine_list_file",
    "is_save_binary": "is_save_binary_file",
    "save_binary": "is_save_binary_file",
    "header": "has_header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "query": "group_column",
    "query_column": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "predict_raw_score": "is_predict_raw_score",
    "predict_leaf_index": "is_predict_leaf_index",
    "raw_score": "is_predict_raw_score",
    "leaf_index": "is_predict_leaf_index",
    "topk": "top_k",
    "boosting": "boosting_type",
    "boost": "boosting_type",
    "application": "objective",
    "app": "objective",
    "bin_packing": "enable_bin_packing",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "num_leaf": "num_leaves",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_trees": "num_iterations",
    "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "shrinkage_rate": "learning_rate",
    "tree": "tree_learner",
    "num_machine": "num_machines",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "categorical_feature": "categorical_column",
    "cat_column": "categorical_column",
    "cat_feature": "categorical_column",
    "min_split_gain": "min_gain_to_split",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "num_classes": "num_class",
    "unbalanced_sets": "is_unbalance",
    "ndcg_at": "ndcg_eval_at",
    "eval_at": "ndcg_eval_at",
    "bagging_fraction_seed": "bagging_seed",
}


@dataclasses.dataclass
class Config:
    """Flat parameter set with reference defaults (config.h:94-295)."""

    device: str = "cuda"           # cuda | cpu; cpu only when asked for
    verbose: int = 1

    # objective / boosting
    objective: str = "regression"
    boosting_type: str = "gbdt"
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_class: int = 1
    tree_learner: str = "serial"

    # tree
    num_leaves: int = 31
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    feature_fraction: float = 1.0
    feature_fraction_seed: int = 2
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    top_rate: float = 0.2          # GOSS
    other_rate: float = 0.1        # GOSS

    # DART
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4

    # categorical splits (feature_histogram.hpp:113-223)
    max_cat_group: int = 64
    max_cat_threshold: int = 256
    cat_smooth_ratio: float = 0.01
    min_cat_smooth: float = 5.0
    max_cat_smooth: float = 100.0

    # the grower's layout
    ordered_bins: str = "auto"     # leaf-ordered copy of the bins and
    #                                weights: auto (= off) | on | off
    partition_impl: str = "auto"   # window partition: scatter | sort |
    #                                compact (the kernel; the split step
    #                                replayed as a CUDA graph) | auto (=
    #                                compact on a card, scatter on the CPU)

    # distributed: the data-parallel learners over a (batch, feature) mesh
    # of device slots (parallel/mesh.py), in one process or several
    num_machines: int = 1
    machine_list_file: str = ""    # "ip port" a line; machine 0 rendezvous
    is_pre_partition: bool = False  # each process holds its own rows; else
    #                                a shared file is split over them
    collective_timeout: float = 120.0   # seconds a collective may take
    top_k: int = 20                # features each voter votes (voting)
    mesh_devices: int = 0          # mesh slots; 0 = one per visible card
    #                                (cuda; one a process under several) or
    #                                one (cpu)
    parallel_impl: str = "auto"    # auto | gspmd | shardmap, resolved as
    #                                the JAX package resolves it
    #                                (boosting.py:resolve_parallel_impl);
    #                                both run the one learner
    mesh_shape: str = "auto"       # DxF | data | feature | auto (planner)
    shard_axes: str = "auto"       # auto | batch | batch,feature
    gspmd_hist: str = "auto"       # fused (the shard-local kernel) | flat
    #                                (masked scatter-add) | auto (= fused
    #                                on a card, flat on the CPU)
    hbm_budget: float = 0.0        # device-memory budget in bytes of the
    #                                pre-flight and the planner (0: the
    #                                card's memory, warn only;
    #                                obs/memory.py)

    # binning
    max_bin: int = 255
    min_data_in_bin: int = 5
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    use_missing: bool = True
    zero_as_missing: bool = False
    enable_bundle: bool = True
    enable_bin_packing: bool = True
    max_conflict_rate: float = 0.0
    categorical_column: str = ""
    # streamed out-of-core training (lightgbm_tpu/config.py:302-318):
    # auto | resident | chunked, and the block size (0: default_chunk_rows)
    data_stream: str = "auto"
    stream_chunk_rows: int = 0

    # data files (lightgbm_tpu/config.py:159-161): a header line, the
    # "<data>.bin" cache written beside a text file, and two-round loading
    # (the file binned as it is read; not data_stream=chunked)
    has_header: bool = False
    is_save_binary_file: bool = False
    use_two_round_loading: bool = False

    # prediction (lightgbm_tpu/config.py:198-202): the keys that
    # Booster.predict's pred_parameter reads, and margin early stopping
    is_predict_raw_score: bool = False
    is_predict_leaf_index: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0

    # objectives' knobs
    sigmoid: float = 1.0
    huber_delta: float = 1.0
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    gaussian_eta: float = 1.0
    scale_pos_weight: float = 1.0
    is_unbalance: bool = False
    boost_from_average: bool = True
    max_position: int = 20
    label_gain: Optional[List[float]] = None

    # metric / eval
    metric: List[str] = dataclasses.field(default_factory=list)
    ndcg_eval_at: List[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 3, 4, 5])
    early_stopping_round: int = 0

    # model text: the importance written to its "feature importances:"
    # section, 0 = split counts, 1 = total gain (lightgbm_tpu/boosting.py:
    # 1937)
    saved_feature_importance_type: int = 0
    # the guard on non-finite gradients, hessians and leaf values
    # (lightgbm_tpu/boosting.py:1566-1621): raise | rollback | clamp
    nonfinite_policy: str = "raise"

    # checkpoints, preemption and the supervisor's liveness
    # (lightgbm_tpu/config.py:205-215, :323-368, :491; checkpoint.py,
    # supervisor.py): snapshots <output_model>.snapshot_iter_N every
    # snapshot_freq iterations (-1: none), the snapshot_keep newest kept
    # (-1: all), snapshot_resume from the newest valid one
    output_model: str = "LightGBM_model.txt"
    snapshot_freq: int = -1
    snapshot_keep: int = -1
    snapshot_resume: bool = False
    fault_inject: str = ""         # utils/faults.py spec, e.g. nan_grad@3
    heartbeat_interval: float = 0.0  # seconds between liveness stamps
    #                                  (<output_model>.heartbeat.rank_R);
    #                                  0 = off
    hang_timeout: float = 0.0      # the supervisor's hang verdict (0 = its
    #                                default, 300 s)
    restart_limit: int = 3         # restarts without forward progress
    restart_backoff: float = 1.0   # seconds before the first relaunch;
    #                                doubles a restart
    preempt_signal: str = ""       # sigterm and/or sigint: a checkpoint at
    #                                the next iteration boundary, then a
    #                                clean exit ("" = off)
    collective_retries: int = 2    # the host-object collectives' retries

    def copy(self) -> "Config":
        return dataclasses.replace(self)


_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Config)}
_LIST_FIELDS = {"metric", "ndcg_eval_at", "label_gain"}
_BOOL_TRUE = {"true", "1", "yes", "on", "+"}
_BOOL_FALSE = {"false", "0", "no", "off", "-"}

# every objective name of the registry (objectives.py:_REGISTRY, as
# lightgbm_tpu/objectives.py:466-491)
SUPPORTED_OBJECTIVES = (
    "regression", "regression_l2", "mean_squared_error", "mse", "l2",
    "regression_l1", "l1", "mean_absolute_error", "mae", "huber", "fair",
    "poisson", "binary", "multiclass", "softmax", "multiclassova",
    "multiclass_ova", "ova", "ovr", "xentropy", "cross_entropy",
    "xentlambda", "cross_entropy_lambda", "lambdarank")
# lightgbm_tpu/config.py:656 and boosting.py:2247 create_boosting
BOOSTING_TYPES = ("gbdt", "gbrt", "dart", "goss", "rf", "random_forest")
MULTICLASS_OBJECTIVES = ("multiclass", "multiclassova", "softmax",
                         "multiclass_ova", "ova", "ovr")


# Keys of the JAX package's Config that the port accepts with any value and
# drops: the JAX package reads them nowhere (the reference's threading,
# sparse storage, file-column and network keys), or only to pick TPU
# machinery that the port does not have (Pallas and gather layouts, XLA's
# CPU histogram, the split scan's two formulations, which grow the same
# trees, and the delayed host copy of trees, which the port makes at once)
TAKEN_AS_IS = frozenset((
    "seed", "num_threads", "histogram_pool_size", "is_enable_sparse",
    "sparse_threshold", "label_column", "weight_column", "group_column",
    "ignore_column", "metric_freq", "local_listen_port", "time_out",
    "gpu_platform_id", "gpu_device_id", "gpu_use_dp", "hist_dtype",
    "convert_model_language", "use_pallas", "cpu_hist_method",
    "pallas_row_tile", "pallas_bucket_min_log2", "pallas_fused",
    "gather_words", "gather_panel", "bucket_scheme", "split_find",
    "pipeline_trees", "objective_seed"))

# the ROADMAP.md port-queue items (their bold titles) of NOT_PORTED
_SERVING = ("checkpoints, serving, observability, CLI, sklearn and "
            "plotting")

# Keys of the JAX package's Config that the port does not honour yet: the
# JAX package's default, and the port-queue item that brings the key.  A
# value other than the default raises.
NOT_PORTED: Dict[str, tuple] = {
    "task": ("train", _SERVING),
    "data": ("", _SERVING),
    "valid_data": ([], _SERVING),
    "config_file": ("", _SERVING),
    "is_training_metric": (False, _SERVING),
    "output_freq": (1, _SERVING),
    "num_iteration_predict": (-1, _SERVING),
    "input_model": ("", _SERVING),
    "output_result": ("LightGBM_predict_result.txt", _SERVING),
    "convert_model": ("gbdt_prediction.cpp", _SERVING),
    "profile_dir": ("", _SERVING),
    "device_profile": (False, _SERVING),
    "profile_iters": (2, _SERVING),
    "trace_path": ("", _SERVING),
    "telemetry": (False, _SERVING),
    "metrics_port": (0, _SERVING),
    "obs_stream_path": ("", _SERVING),
    "model_quality": ("auto", _SERVING),
    "straggler_factor": (4.0, _SERVING),
    "elastic_resume": (False, _SERVING),
    "elastic_min_ranks": (1, _SERVING),
    "world_shrink_after": (2, _SERVING),
    "latency_budget_ms": (2.0, _SERVING),
    "serving_buckets": ("1,8,64,512,4096", _SERVING),
    "model_watch": ("", _SERVING),
    "model_watch_interval": (1.0, _SERVING),
    "drift_threshold": (0.2, _SERVING),
    "drift_window_rows": (4096, _SERVING),
    "serving_traversal": ("auto", _SERVING),
}


def _is_default(value: Any, default: Any) -> bool:
    """Whether a raw value of a not-ported key parses to its default."""
    if isinstance(default, list):
        if isinstance(value, str):
            value = [p for p in value.replace(",", " ").split() if p]
        return list(value or []) == default
    if isinstance(default, bool):
        if isinstance(value, bool):
            return value == default
        s = str(value).strip().lower()
        return (s in _BOOL_TRUE) == default and (s in _BOOL_TRUE
                                                 or s in _BOOL_FALSE)
    if isinstance(default, (int, float)):
        try:
            return float(value) == default
        except (TypeError, ValueError):
            return False
    return str(value) == default


def _parse_value(name: str, value: Any) -> Any:
    """Coerce a raw (possibly string) value to the field's declared type."""
    ftype = str(_FIELD_TYPES[name])
    if name == "categorical_column" and isinstance(value, (list, tuple)):
        return ",".join(str(v) for v in value)
    if name in _LIST_FIELDS:
        if value is None:
            return None
        if isinstance(value, str):
            parts = [p for p in value.replace(",", " ").split() if p]
        elif isinstance(value, (set, frozenset)):
            # metric={'l2', 'auc'}: ordered for a fixed eval-log order
            parts = sorted(value, key=str)
        elif isinstance(value, (list, tuple)):
            parts = list(value)
        else:
            parts = [value]
        if name == "ndcg_eval_at":
            ks = sorted(int(p) for p in parts)   # ascending (config.cpp:341)
            for k in ks:
                if k <= 0:
                    log.fatal("eval_at positions must be positive; got %d",
                              k)
            return ks
        if name == "label_gain":
            return [float(p) for p in parts]
        return [str(p) for p in parts]
    if "bool" in ftype:
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in _BOOL_TRUE:
            return True
        if s in _BOOL_FALSE:
            return False
        raise ValueError(f"cannot parse bool parameter {name}={value!r}")
    if "int" in ftype:
        return int(float(value)) if isinstance(value, str) else int(value)
    if "float" in ftype:
        return float(value)
    return str(value)


def canonicalize_params(params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Alias-resolve a raw param dict; reject unknown keys (config.h:478-481).

    Explicit canonical keys win over aliased ones, as in the reference."""
    out: Dict[str, Any] = {}
    aliased: Dict[str, Any] = {}
    for key, value in dict(params or {}).items():
        k = key.strip().lower()
        k = PARAM_ALIASES.get(k, k)
        if k in TAKEN_AS_IS:
            continue
        if k in NOT_PORTED:
            default, item = NOT_PORTED[k]
            if not _is_default(value, default):
                _unsupported(f"{key}={value!r}", item)
            continue
        if k not in _FIELD_TYPES:
            raise ValueError(f"Unknown parameter: {key}")
        if k != key.strip().lower():
            aliased[k] = value
        else:
            out[k] = value
    for k, v in aliased.items():
        out.setdefault(k, v)
    return out


def config_from_params(params: Optional[Dict[str, Any]] = None,
                       base: Optional[Config] = None) -> Config:
    cfg = base.copy() if base is not None else Config()
    for k, v in canonicalize_params(params).items():
        setattr(cfg, k, _parse_value(k, v))
    check_params(cfg)
    return cfg


def _unsupported(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to lightgbm_tpu_torch yet "
        f"(ROADMAP.md, port queue: {item})")


def _check_distributed(cfg: Config) -> None:
    """The distributed knobs (lightgbm_tpu/config.py:653-711, :765-768,
    :782): syntax checks.  ``mesh_shape=auto`` over more than one mesh
    slot is sized at learner setup, where the number of slots is known
    (``parallel/mesh.py:plan_mesh``)."""
    if cfg.tree_learner not in ("serial", "feature", "data", "voting",
                                "data_feature"):
        log.fatal("Unknown tree learner type %s", cfg.tree_learner)
    if cfg.tree_learner == "serial" and cfg.num_machines > 1:
        log.warning("tree_learner=serial forces num_machines=1 "
                    "(config.cpp:222-225 semantics)")
        cfg.num_machines = 1
    if cfg.parallel_impl not in ("auto", "gspmd", "shardmap"):
        log.fatal("parallel_impl must be auto, gspmd, or shardmap; got %r",
                  cfg.parallel_impl)
    try:
        mesh_shape_extents(cfg.mesh_shape)
    except ValueError as e:
        log.fatal("%s", e)
    sa = str(cfg.shard_axes or "auto").strip().lower().replace(" ", "")
    if sa not in ("auto", "batch", "batch,feature", "feature,batch"):
        log.fatal("shard_axes must be auto, batch, or batch,feature; "
                  "got %r", cfg.shard_axes)
    if cfg.gspmd_hist not in ("auto", "fused", "flat"):
        log.fatal("gspmd_hist must be auto, fused, or flat; got %r",
                  cfg.gspmd_hist)
    if cfg.mesh_devices < 0:
        log.fatal("mesh_devices must be >= 0; got %d", cfg.mesh_devices)
    if cfg.tree_learner == "data_feature" and cfg.num_machines > 1:
        # lightgbm_tpu/config.py:686-691
        log.fatal("tree_learner=data_feature is single-process (it shards "
                  "data x feature over one process's device mesh); use "
                  "data, voting, or feature across machines")
    if cfg.collective_timeout <= 0:
        log.fatal("collective_timeout must be positive; got %r",
                  cfg.collective_timeout)
    if cfg.top_k <= 0:
        log.fatal("top_k must be positive; got %d", cfg.top_k)
    if cfg.hbm_budget < 0:
        log.fatal("hbm_budget must be >= 0 bytes (0 = warn-only pre-flight "
                  "against the detected device capacity); got %r",
                  cfg.hbm_budget)


def check_params(cfg: Config) -> None:
    """Cross-field checks (src/io/config.cpp:188-240) plus the slice's
    limits: every value outside the slice raises."""
    if cfg.device not in ("cuda", "cpu"):
        log.fatal("device must be cuda or cpu; got %r", cfg.device)
    if cfg.num_class <= 0:
        log.fatal("num_class must be positive")
    if cfg.objective.lower() not in SUPPORTED_OBJECTIVES:
        log.fatal("Unknown objective type name: %s", cfg.objective)
    is_multiclass = cfg.objective.lower() in MULTICLASS_OBJECTIVES
    if is_multiclass and cfg.num_class <= 1:
        log.fatal("Number of classes should be specified and greater than 1 "
                  "for multiclass training")
    if not is_multiclass and cfg.num_class != 1:
        log.fatal("Number of classes must be 1 for non-multiclass training")
    if cfg.boosting_type not in BOOSTING_TYPES:
        log.fatal("Unknown boosting type %s", cfg.boosting_type)
    if cfg.boosting_type in ("rf", "random_forest"):
        if not (cfg.bagging_freq > 0 and 0.0 < cfg.bagging_fraction < 1.0):
            log.fatal("Random forest needs bagging (bagging_freq > 0 and "
                      "0 < bagging_fraction < 1)")
    _check_distributed(cfg)
    # lightgbm_tpu/config.py:769-781; data_stream=auto is the capacity
    # walk (parallel/mesh.py:resolve_placement)
    if cfg.data_stream not in ("auto", "resident", "chunked"):
        log.fatal("data_stream must be auto, resident, or chunked; got %r",
                  cfg.data_stream)
    if cfg.stream_chunk_rows < 0:
        log.fatal("stream_chunk_rows must be >= 0 rows (0 = auto block "
                  "size); got %r", cfg.stream_chunk_rows)
    if cfg.data_stream == "chunked" \
            and cfg.boosting_type in ("dart", "goss"):
        log.fatal("data_stream=chunked is incompatible with "
                  "boosting_type=%s: dart's drop/rescale and goss's top-k "
                  "sampling assume the resident row layout; use "
                  "data_stream=resident or boosting_type=gbdt",
                  cfg.boosting_type)
    if cfg.ordered_bins not in ("auto", "on", "off"):
        log.fatal("ordered_bins must be auto, on, or off; got %r",
                  cfg.ordered_bins)
    if cfg.partition_impl not in ("auto", "scatter", "sort", "compact"):
        log.fatal("partition_impl must be auto, scatter, sort, or compact; "
                  "got %r", cfg.partition_impl)
    if cfg.max_bin > 65535:
        log.fatal("max_bin too large (must fit uint16)")
    if cfg.num_leaves < 2:
        log.fatal("num_leaves must be >= 2; got %d", cfg.num_leaves)
    if cfg.saved_feature_importance_type not in (0, 1):
        log.fatal("saved_feature_importance_type must be 0 (split) or "
                  "1 (gain); got %d", cfg.saved_feature_importance_type)
    if cfg.nonfinite_policy not in ("raise", "rollback", "clamp"):
        log.fatal("nonfinite_policy must be raise, rollback, or clamp; "
                  "got %r", cfg.nonfinite_policy)
    _check_robustness(cfg)


def _check_robustness(cfg: Config) -> None:
    """The checkpoint and liveness keys (lightgbm_tpu/config.py:739-799,
    :825-829): the fault spec parses, its rank qualifiers name ranks of
    ``num_machines``, ``preempt_signal`` names sigterm and/or sigint, and
    the liveness knobs are in range."""
    if cfg.fault_inject:
        # fail at parse time with the real cause, not at the fault point
        from .utils.faults import parse_spec
        try:
            entries = parse_spec(cfg.fault_inject)
        except ValueError as e:
            log.fatal("%s", e)
        world = max(1, cfg.num_machines)
        for e in entries:
            if e.rank is not None and e.rank >= world:
                log.fatal("fault_inject: rank=%d targets a rank this job "
                          "does not run (num_machines=%d)", e.rank, world)
    if cfg.preempt_signal:
        for tok in str(cfg.preempt_signal).replace(",", " ").split():
            if tok.strip().lower() not in ("sigterm", "sigint", "term",
                                           "int"):
                log.fatal("preempt_signal must name sigterm and/or sigint "
                          "(comma-separated); got %r", cfg.preempt_signal)
    if cfg.collective_retries < 0:
        log.fatal("collective_retries must be >= 0; got %d",
                  cfg.collective_retries)
    if cfg.heartbeat_interval < 0:
        log.fatal("heartbeat_interval must be >= 0 seconds (0 = off); "
                  "got %r", cfg.heartbeat_interval)
    if cfg.hang_timeout < 0:
        log.fatal("hang_timeout must be >= 0 seconds (0 = the supervisor "
                  "default); got %r", cfg.hang_timeout)
    if cfg.hang_timeout and cfg.heartbeat_interval \
            and cfg.hang_timeout <= cfg.heartbeat_interval:
        log.fatal("hang_timeout (%g s) must exceed heartbeat_interval "
                  "(%g s): every rank would look hung between two stamps",
                  cfg.hang_timeout, cfg.heartbeat_interval)
    if cfg.restart_limit < 0:
        log.fatal("restart_limit must be >= 0; got %d", cfg.restart_limit)
    if cfg.restart_backoff < 0:
        log.fatal("restart_backoff must be >= 0 seconds; got %r",
                  cfg.restart_backoff)


def resolve_device(name: Optional[str]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asked
    for ``cpu``.  A missing card raises; it never falls back to the CPU."""
    name = name or "cuda"
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"device must be cuda or cpu; got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "lightgbm_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
