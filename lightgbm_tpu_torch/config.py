"""Parameter system of the port.

The reference's config surface (``include/LightGBM/config.h``) as one flat
dataclass, cut to the fields this port reads: the alias table
(``config.h:353-483``) resolves onto them, unknown parameters are rejected
as the reference rejects them, and a value this port cannot honour yet
raises ``NotImplementedError`` naming the ROADMAP.md port-queue item that
brings it, instead of being ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from .parallel.mesh import mesh_shape_extents
from .utils import log

# Alias -> canonical name (reference config.h:353-483, KeyAliasTransform),
# for the canonical names this Config carries.
PARAM_ALIASES: Dict[str, str] = {
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
    bagging_fraction: float = 1.0
    bagging_freq: int = 0

    # categorical splits (feature_histogram.hpp:113-223)
    max_cat_group: int = 64
    max_cat_threshold: int = 256
    cat_smooth_ratio: float = 0.01
    min_cat_smooth: float = 5.0
    max_cat_smooth: float = 100.0

    # the grower's layout
    ordered_bins: str = "auto"     # leaf-ordered copy of the bins and
    #                                weights: auto (= off) | on | off
    partition_impl: str = "auto"   # window partition: auto (= scatter) |
    #                                scatter | sort | compact (the kernel)

    # distributed: the data-parallel learner over a (batch, feature) mesh
    # of device slots (parallel/mesh.py)
    num_machines: int = 1
    mesh_devices: int = 0          # mesh slots; 0 = one per visible card
    #                                (cuda) or one (cpu)
    parallel_impl: str = "auto"    # auto (= gspmd) | gspmd | shardmap
    mesh_shape: str = "auto"       # DxF | data | feature | auto (planner)
    shard_axes: str = "auto"       # auto | batch | batch,feature
    gspmd_hist: str = "auto"       # fused (the shard-local kernel) | flat
    #                                (masked scatter-add) | auto (= flat)

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
    data_stream: str = "auto"

    # objectives' knobs
    sigmoid: float = 1.0
    scale_pos_weight: float = 1.0
    is_unbalance: bool = False
    boost_from_average: bool = True

    # metric / eval
    metric: List[str] = dataclasses.field(default_factory=list)
    early_stopping_round: int = 0

    def copy(self) -> "Config":
        return dataclasses.replace(self)


_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Config)}
_BOOL_TRUE = {"true", "1", "yes", "on", "+"}
_BOOL_FALSE = {"false", "0", "no", "off", "-"}

# objective names of the slice (objectives.py registry)
SUPPORTED_OBJECTIVES = ("regression", "regression_l2", "mean_squared_error",
                        "mse", "l2", "binary")


def _parse_value(name: str, value: Any) -> Any:
    """Coerce a raw (possibly string) value to the field's declared type."""
    ftype = str(_FIELD_TYPES[name])
    if name == "categorical_column" and isinstance(value, (list, tuple)):
        return ",".join(str(v) for v in value)
    if name == "metric":
        if isinstance(value, str):
            return [p for p in value.replace(",", " ").split() if p]
        if isinstance(value, (set, frozenset)):
            return sorted(str(p) for p in value)
        if isinstance(value, (list, tuple)):
            return [str(p) for p in value]
        return [str(value)]
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
        if k in PARAM_ALIASES:
            aliased[PARAM_ALIASES[k]] = value
        elif k in _FIELD_TYPES:
            out[k] = value
        else:
            raise ValueError(f"Unknown parameter: {key}")
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
    """The distributed knobs (lightgbm_tpu/config.py:653-711): syntax
    checks, and a raise for every value outside the ported data-parallel
    learner.  ``mesh_shape=auto`` raises later, at learner setup, where
    the number of mesh slots is known."""
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
    if cfg.tree_learner == "voting":
        _unsupported("tree_learner=voting",
                     "multi-device learners (the shard_map learners)")
    if cfg.parallel_impl == "shardmap":
        _unsupported("parallel_impl=shardmap",
                     "multi-device learners (the shard_map learners)")
    if cfg.num_machines > 1:
        _unsupported(f"num_machines={cfg.num_machines}",
                     "multi-device learners (multi-process over "
                     "torch.distributed)")
    if sa in ("batch,feature", "feature,batch"):
        _unsupported(f"shard_axes={cfg.shard_axes}",
                     "multi-device learners (block-sharded bins)")


def check_params(cfg: Config) -> None:
    """Cross-field checks (src/io/config.cpp:188-240) plus the slice's
    limits: every value outside the slice raises."""
    if cfg.device not in ("cuda", "cpu"):
        log.fatal("device must be cuda or cpu; got %r", cfg.device)
    if cfg.num_class != 1:
        _unsupported(f"num_class={cfg.num_class}",
                     "training breadth (multiclass)")
    if cfg.objective.lower() not in SUPPORTED_OBJECTIVES:
        _unsupported(f"objective={cfg.objective}",
                     "training breadth (other objectives)")
    if cfg.boosting_type not in ("gbdt", "gbrt"):
        _unsupported(f"boosting_type={cfg.boosting_type}",
                     "boosting variants and sampling (DART/GOSS/RF)")
    if cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0:
        _unsupported("bagging", "boosting variants and sampling")
    if cfg.feature_fraction < 1.0:
        _unsupported("feature_fraction < 1", "boosting variants and sampling")
    _check_distributed(cfg)
    if cfg.data_stream not in ("auto", "resident"):
        _unsupported(f"data_stream={cfg.data_stream}",
                     "streamed out-of-core training")
    if cfg.ordered_bins not in ("auto", "on", "off"):
        log.fatal("ordered_bins must be auto, on, or off; got %r",
                  cfg.ordered_bins)
    if cfg.partition_impl not in ("auto", "scatter", "sort", "compact"):
        log.fatal("partition_impl must be auto, scatter, sort, or compact; "
                  "got %r", cfg.partition_impl)
    if cfg.max_bin > 256:
        # the bin matrix is uint8 and the histogram kernel is 256 bins wide
        _unsupported(f"max_bin={cfg.max_bin} (> 256)",
                     "training breadth (uint16 bin matrix)")
    if cfg.num_leaves < 2:
        log.fatal("num_leaves must be >= 2; got %d", cfg.num_leaves)


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
