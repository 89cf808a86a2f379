"""The GBDT boosting loop (``src/boosting/gbdt.cpp:67-581``).

Boost-from-average init tree, gradients, one tree per iteration through the
serial grower or the data-parallel learner (``parallel/gspmd.py``) over a
mesh of device slots, shrinkage, the O(N) training-score update through the
grower's ``row_leaf`` map, valid-set scores by routing their binned rows
through the fresh tree on the device, and the model text of the
reference (``SaveModelToString``, gbdt.cpp:948-997) and its parser.
"""
from __future__ import annotations

import io
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import Config, _unsupported
from .data.dataset import TrainingData
from .grower import (FeatureMeta, GrowerConfig, WindowBuffers, grow_tree,
                     resolve_partition_impl)
from .metrics import Metric, create_metric, default_metric_for_objective
from .objectives import Objective, parse_objective_string
from .parallel import mesh as mesh_mod
from .parallel.gspmd import GspmdGrower, resolve_gspmd_hist
from .predictor import Predictor, predict_binned_leaf
from .tree import Tree
from .utils import log

# nibble packing (lightgbm_tpu/data/packing.py) pairs columns of at most
# this many bins; 256 is the joint histogram width
_PACK_MAX_BIN, _PACK_JOINT_BINS = 16, 256


def _would_pack(col_num_bins) -> bool:
    """Whether the JAX package's ``build_pack_plan`` would nibble-pack
    these columns (data/packing.py:130)."""
    nb = np.asarray(col_num_bins, dtype=np.int64)
    narrow = int((nb <= _PACK_MAX_BIN).sum())
    if narrow < 2:
        return False
    n_storage = (len(nb) - narrow) + (narrow + 1) // 2
    return n_storage * _PACK_JOINT_BINS <= len(nb) * int(nb.max())


class _ValidSet:
    def __init__(self, data: TrainingData, bins: torch.Tensor, name: str,
                 metrics: List[Metric]):
        self.data = data
        self.name = name
        self.bins = bins
        self.metrics = metrics
        self.scores = torch.zeros((1, data.num_data), dtype=torch.float32,
                                  device=bins.device)


class GBDT:
    """Gradient Boosting Decision Tree driver (gbdt.cpp)."""

    sub_model_name = "tree"

    def __init__(self, config: Config, train_set: Optional[TrainingData] = None,
                 objective: Optional[Objective] = None,
                 bins: Optional[torch.Tensor] = None):
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.models: List[Tree] = []
        self.iter_ = 0
        self.num_init_iteration = 0
        self.boost_from_average_ = False
        self.valid_sets: List[_ValidSet] = []
        self.train_metrics: List[Metric] = []
        self.num_class = 1
        self.label_idx = 0
        self.feature_names: List[str] = (train_set.feature_names
                                         if train_set else [])
        self.max_feature_idx = (train_set.num_total_features - 1
                                if train_set else 0)
        self.feature_infos = ""      # a loaded model's feature_infos line
        # per-training counters: host reads of the grow loop, splits, trees
        self.stats: Dict[str, int] = {"host_syncs": 0, "splits": 0,
                                      "trees": 0}
        # the learner as resolved, and a record of a loud fallback to serial
        self.parallel_impl = "serial"
        self.gspmd_hist: Optional[str] = None
        self.mesh: Optional[mesh_mod.Mesh] = None
        self.downgrades: List[Dict[str, str]] = []
        # the data-parallel learner, made once per training: it holds its
        # device state across trees (and, with every mesh slot on one card,
        # its split step captured as a CUDA graph)
        self._gspmd: Optional[GspmdGrower] = None
        # the serial grower's device state, made at the first tree
        self._windows: Optional[WindowBuffers] = None
        self._row_pad = 0
        if train_set is not None:
            self._setup_device(train_set, bins)

    # ------------------------------------------------------------------ setup

    def _setup_device(self, train: TrainingData, bins: torch.Tensor) -> None:
        """The device state of training (boosting.py:216 ``_setup_device``,
        serial single-device subset): the bin matrix, feature metadata,
        grower config, objective state and scores."""
        cfg = self.config
        self.device = bins.device
        self.bins = bins
        fm = train.feature_meta()
        # the learner (boosting.py:443-445): distributed when a parallel
        # tree_learner has more than one mesh slot
        slots = (mesh_mod.mesh_slots(cfg.mesh_devices, bins.device)
                 if cfg.tree_learner != "serial" else [bins.device])
        use_dist = cfg.tree_learner != "serial" and (
            cfg.mesh_devices != 1 and len(slots) > 1)
        # the JAX package packs no columns for the feature-sliced learners
        packs = not (use_dist and cfg.tree_learner in ("feature",
                                                       "data_feature"))
        if cfg.enable_bin_packing and packs and _would_pack(fm["num_bin"]):
            _unsupported("enable_bin_packing=true on a dataset with "
                         "nibble-packable columns (pass "
                         "enable_bin_packing=false)", "EFB and bin packing")
        put = lambda a: torch.from_numpy(a).to(self.device)
        self.meta = FeatureMeta(num_bin=put(fm["num_bin"]),
                                missing_type=put(fm["missing_type"]),
                                default_bin=put(fm["default_bin"]),
                                is_categorical=put(fm["is_categorical"]))
        self.num_data = train.num_data
        self.grower_cfg = GrowerConfig(
            num_leaves=cfg.num_leaves,
            max_depth=cfg.max_depth,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            lambda_l1=cfg.lambda_l1,
            lambda_l2=cfg.lambda_l2,
            min_gain_to_split=cfg.min_gain_to_split,
            max_bin=train.max_num_bin(),
            has_missing=bool((fm["missing_type"] != 0).any()),
            has_categorical=bool(fm["is_categorical"].any()),
            max_cat_threshold=cfg.max_cat_threshold,
            max_cat_group=cfg.max_cat_group,
            cat_smooth_ratio=cfg.cat_smooth_ratio,
            min_cat_smooth=cfg.min_cat_smooth,
            max_cat_smooth=cfg.max_cat_smooth,
            partition_impl=resolve_partition_impl(cfg.partition_impl,
                                                  self.device),
            ordered_bins=("off" if cfg.ordered_bins == "auto"
                          else cfg.ordered_bins))
        self.objective.init(train.metadata, self.num_data, self.device)
        self.scores = torch.zeros((1, self.num_data), dtype=torch.float32,
                                  device=self.device)
        self._feat_valid = torch.ones(len(fm["num_bin"]), dtype=torch.bool,
                                      device=self.device)
        self._count_weight = torch.ones(self.num_data, dtype=torch.float32,
                                        device=self.device)
        self.metric_names = (cfg.metric
                             or [default_metric_for_objective(cfg.objective)])
        self.train_metrics = self._make_metrics(train)
        if use_dist:
            self._setup_gspmd(cfg, slots)
        elif cfg.tree_learner != "serial":      # loud fallback (:555-565)
            log.warning(f"tree_learner={cfg.tree_learner} requested but only "
                        f"one mesh slot is in use (slots={len(slots)}, "
                        f"mesh_devices={cfg.mesh_devices}); falling back to "
                        f"serial")
            self.downgrades.append({
                "requested": f"tree_learner={cfg.tree_learner}",
                "resolved": "serial", "reason": "only one device is in use"})

    def _setup_gspmd(self, cfg: Config, slots) -> None:
        """The data-parallel learner (lightgbm_tpu/boosting.py:830-1049,
        single-process with an explicit mesh): resolve the histogram
        formulation, size the mesh, pad the rows to whole shards and build
        the grower.  ``parallel_impl`` auto resolves to gspmd; shardmap and
        voting raise in the config checks."""
        gspmd_hist = resolve_gspmd_hist(cfg.gspmd_hist, self.device)
        ncols = self.bins.shape[1]
        explicit = mesh_mod.parse_mesh_shape(cfg.mesh_shape, len(slots))
        if explicit is None:
            _unsupported("mesh_shape=auto over more than one mesh slot",
                         "multi-device learners (the memory-driven mesh "
                         "planner)")
        d, fs = explicit
        if cfg.ordered_bins == "on" or cfg.partition_impl not in ("auto",
                                                                  "scatter"):
            log.warning("ordered_bins and partition_impl act on the serial "
                        "grower's order window; the data-parallel learner "
                        "keeps a row -> leaf map and ignores them")
        self.parallel_impl = "gspmd"
        self.gspmd_hist = gspmd_hist
        self.mesh = mesh_mod.make_named_mesh(d, fs, slots)
        # rows padded to whole shards with zero weights (:1026-1031)
        self._row_pad = mesh_mod.pad_rows(self.num_data, d)
        bins = self.bins
        if self._row_pad:
            bins = torch.cat([bins, bins.new_zeros((self._row_pad, ncols))])
            self._count_weight = self._dist_row_vec(self._count_weight)
        log.info("Using the data-parallel %s learner over a %dx%d (batch, "
                 "feature) mesh, %s histogram", cfg.tree_learner, d, fs,
                 gspmd_hist)
        self._gspmd = GspmdGrower(self.grower_cfg, self.mesh, bins,
                                  gspmd_hist)

    def _dist_row_vec(self, x: torch.Tensor) -> torch.Tensor:
        """A per-row vector ``[N]`` -> the learner's ``[N + pad]``, the
        padding rows zero (boosting.py:1443)."""
        if not self._row_pad:
            return x
        return torch.cat([x, x.new_zeros(self._row_pad)])

    def _make_metrics(self, data: TrainingData) -> List[Metric]:
        out = []
        for name in self.metric_names:
            m = create_metric(name, self.config)
            if m is not None:
                m.init(data.metadata, data.num_data)
                out.append(m)
        return out

    def add_valid_set(self, data: TrainingData, bins: torch.Tensor,
                      name: str) -> None:
        if self.models:
            _unsupported("adding a valid set after training started",
                         "training breadth (continued training)")
        self.valid_sets.append(
            _ValidSet(data, bins, name, self._make_metrics(data)))

    # --------------------------------------------------------------- training

    def _boost_from_average(self) -> None:
        """gbdt.cpp:407-480: constant init tree from the label average."""
        num, den = self.objective.average_stats()
        init = self.objective.init_from_average(num / max(den, 1e-300))
        tree = Tree(1)
        tree.leaf_value[0] = init
        self.models.append(tree)
        self.scores = self.scores + init
        for vs in self.valid_sets:
            vs.scores = vs.scores + init
        self.boost_from_average_ = True
        log.info("Start training from score %f", init)

    def train_one_iter(self) -> bool:
        """One boosting iteration; True when training should stop
        (gbdt.cpp:465-581 TrainOneIter)."""
        if (self.iter_ == 0 and self.num_init_iteration == 0
                and self.objective.boost_from_average
                and self.config.boost_from_average
                and not self.boost_from_average_):
            self._boost_from_average()
        g, h = self.objective.get_gradients(self.scores)
        lr = self.config.learning_rate
        if self._gspmd is not None:
            arrays, row_leaf = self._gspmd(
                self._dist_row_vec(g[0]), self._dist_row_vec(h[0]),
                self._count_weight, self.meta, self._feat_valid, self.stats)
            row_leaf = row_leaf[:self.num_data]     # the local rows
        else:
            if self._windows is None:
                # the grower's device state, made once per training: the
                # partition's buffers, the leaf pool and, on a card with
                # compact, the split step captured at the first split
                self._windows = WindowBuffers(*self.bins.shape,
                                              self.grower_cfg, self.device)
            arrays, row_leaf = grow_tree(self.bins, g[0], h[0],
                                         self._count_weight, self.meta,
                                         self._feat_valid, self.grower_cfg,
                                         self.stats, self._windows)
        self.stats["trees"] += 1
        host = arrays._replace(**{
            k: v.cpu().numpy() for k, v in arrays._asdict().items()
            if isinstance(v, torch.Tensor)})
        tree = Tree.from_arrays(host, self.train_set.used_features,
                                self.train_set.bin_mappers)
        tree.shrink(lr)
        if tree.num_leaves <= 1:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        self.models.append(tree)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=self.device)
        self.scores[0] = self.scores[0] + lr_t * arrays.leaf_value[row_leaf.long()]
        depth = int(host.leaf_depth[:tree.num_leaves].max())
        for vs in self.valid_sets:
            vleaf = predict_binned_leaf(vs.bins, arrays, self.meta, depth)
            vs.scores[0] = vs.scores[0] + lr_t * arrays.leaf_value[vleaf]
        self.iter_ += 1
        return False

    # ------------------------------------------------------------------- eval

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        return self._eval("training", self.train_metrics, self.scores)

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for vs in self.valid_sets:
            out.extend(self._eval(vs.name, vs.metrics, vs.scores))
        return out

    def _eval(self, name, metrics, scores) -> List[Tuple[str, str, float, bool]]:
        host = scores.double().cpu().numpy()
        return [(name, m.name, float(m.eval(host, self.objective)),
                 m.is_higher_better) for m in metrics]

    # ---------------------------------------------------------------- predict

    def predictor(self, device: torch.device,
                  num_iteration: int = -1) -> Predictor:
        trees = self.models
        if num_iteration > 0:
            trees = trees[:num_iteration + (1 if self.boost_from_average_
                                            else 0)]
        return Predictor(trees, self.objective, device)

    # ------------------------------------------------------------- model file

    def feature_importance(self, num_iteration: int = -1) -> np.ndarray:
        """Split-count importance over the kept trees (gbdt.cpp
        FeatureImportance), written to the model file."""
        n_feat = self.max_feature_idx + 1
        trees = self.models
        if num_iteration > 0:
            trees = trees[:num_iteration + (1 if self.boost_from_average_
                                            else 0)]
        split_trees = [t for t in trees if t.num_leaves > 1]
        if not split_trees:
            return np.zeros(n_feat, dtype=np.float64)
        feats = np.concatenate([t.split_feature[:t.num_leaves - 1]
                                for t in split_trees])
        gains = np.concatenate([t.split_gain[:t.num_leaves - 1]
                                for t in split_trees])
        return np.bincount(feats[gains > 0],
                           minlength=n_feat).astype(np.float64)

    def save_model_to_string(self, num_iteration: int = -1) -> str:
        """gbdt.cpp:948-997 SaveModelToString — reference text format."""
        buf = io.StringIO()
        buf.write(self.sub_model_name + "\n")
        buf.write(f"num_class={self.num_class}\n")
        buf.write(f"num_tree_per_iteration={self.num_class}\n")
        buf.write(f"label_index={self.label_idx}\n")
        buf.write(f"max_feature_idx={self.max_feature_idx}\n")
        if self.objective is not None:
            buf.write(f"objective={self.objective.to_string()}\n")
        if self.boost_from_average_:
            buf.write("boost_from_average\n")
        buf.write("feature_names=" + " ".join(self.feature_names) + "\n")
        infos = (" ".join(m.feature_info_str()
                          for m in self.train_set.bin_mappers)
                 if self.train_set else self.feature_infos)
        buf.write("feature_infos=" + infos + "\n")
        buf.write("\n")
        num_used = len(self.models)
        if num_iteration > 0:
            ni = num_iteration + (1 if self.boost_from_average_ else 0)
            num_used = min(ni * self.num_class, num_used)
        for i in range(num_used):
            buf.write(self.models[i].to_string(i))
            buf.write("\n")
        buf.write("\nfeature importances:\n")
        imp = self.feature_importance(num_iteration)
        for f in np.argsort(-imp, kind="mergesort"):
            if imp[f] > 0:
                buf.write(f"{self.feature_names[f]}={int(imp[f])}\n")
        return buf.getvalue()

    @staticmethod
    def load_from_string(model_str: str, config: Config) -> "GBDT":
        """gbdt.cpp:1010+ LoadModelFromString."""
        lines = model_str.splitlines()
        booster = GBDT(config)
        header: Dict[str, str] = {}
        i = 0
        if lines and lines[0].strip() != "tree":
            _unsupported(f"model type {lines[0].strip()!r}",
                         "boosting variants and sampling")
        i = 1
        while i < len(lines):
            line = lines[i].strip()
            if line.startswith("Tree="):
                break
            if line == "boost_from_average":
                booster.boost_from_average_ = True
            elif line == "average_output":
                _unsupported("average_output models",
                             "boosting variants and sampling")
            elif "=" in line:
                k, v = line.split("=", 1)
                header[k] = v
            i += 1
        booster.num_class = int(header.get("num_tree_per_iteration",
                                           header.get("num_class", "1")))
        if booster.num_class != 1:
            _unsupported("multiclass models", "training breadth (multiclass)")
        booster.label_idx = int(header.get("label_index", "0"))
        booster.max_feature_idx = int(header.get("max_feature_idx", "0"))
        booster.feature_names = header.get("feature_names", "").split()
        booster.feature_infos = header.get("feature_infos", "")
        if "objective" in header:
            booster.objective = parse_objective_string(header["objective"],
                                                       config)
        blocks: List[List[str]] = []
        for line in lines[i:]:
            s = line.strip()
            if s.startswith("Tree="):
                blocks.append([])
            elif s.startswith("feature importances"):
                break
            elif s and blocks:
                blocks[-1].append(s)
        booster.models = [Tree.from_string("\n".join(b)) for b in blocks]
        booster.num_init_iteration = len(booster.models)
        return booster
