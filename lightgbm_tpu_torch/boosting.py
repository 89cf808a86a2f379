"""The boosting loops: GBDT (``src/boosting/gbdt.cpp:67-581``) and its
variants DART, GOSS and RF (``dart.hpp``, ``goss.hpp``, ``rf.hpp``), as
``lightgbm_tpu/boosting.py`` writes them.

Boost-from-average init tree, init scores, gradients (or the caller's),
row sampling (bagging, GOSS), a feature mask drawn per tree, K trees per
iteration (one per class, tree k from ``g[k]``, ``h[k]``) through the
serial grower or the data-parallel learners (``parallel/gspmd.py``, the
voting one in ``parallel/learner.py``) over a mesh of device slots, in
one process or several (``num_machines``), shrinkage, the O(N) training-score update through the
grower's ``row_leaf`` map, valid-set scores by routing their binned rows
through the fresh tree on the device, the rollback of an iteration, and
the model text of the reference (``SaveModelToString``, gbdt.cpp:948-997)
and its parser.  Scores are ``[K, N]`` on the training device, as in
``lightgbm_tpu/boosting.py:292-298``.

Sampling draws from the JAX package's host random streams with the same
seeds, in the same order and amounts, so both packages sample the same
rows and features.  Its device state is made to suit the split loops'
captured steps, which hold tensor addresses: each tree's feature mask is
copied into the one mask tensor, and a bag (bagging at a fraction of at
most 0.5, or GOSS at ``top_rate + other_rate <= 0.5``, on the serial
learner) becomes the grower's root window (``grower.WindowBuffers.start``)
instead of a gathered matrix, its other rows weighted 0 and routed through
the fresh tree afterwards for their scores.

The bin matrix is the dataset's physical columns (EFB bundles, whose
decode maps ride the feature meta); with nibble packing a second, packed
storage matrix beside it feeds the histogram kernels only
(``data/packing.py``), planned where the JAX package plans it
(``lightgbm_tpu/boosting.py:497-528``).  The non-finite guard
(``nonfinite_policy``, ``lightgbm_tpu/boosting.py:1566-1621``) checks the
gradients, hessians and leaf values on the device and reads its flags
with each tree's copy to the host.

Over several processes every decision that one rank could take alone is
taken from values all ranks hold: the trees from all-reduced histograms,
``boost_from_average`` from the ranks' summed label statistics (when each
holds its own rows), the non-finite guard from the minimum of the ranks'
flags; bagging, GOSS, DART and RF draw over each rank's own rows, as the
JAX package's do.

Where the training runs is decided before its bin matrix is copied to the
card (:func:`plan_training`): the learner, the placement walk of
``data_stream=auto`` (resident, streamed, sharded), the mesh the planner
sizes for ``mesh_shape=auto``, and the pre-flight of the memory model's
prediction against ``hbm_budget`` (``obs/memory.py``).  On the streamed
rung the bin matrix never
lands on the device (``lightgbm_tpu/boosting.py:772-829``): it stays in
page-locked host memory, and the streamed grower
(``grower.StreamedGrower``) moves it through the card block by block,
one pass a split; every other use of the training bins (the rollback's
re-scoring, the out-of-bag rows) goes through the same blocks
(:meth:`GBDT._over_train_bins`).  Packing, ``ordered_bins=on`` and the
bagging subset regime are turned off for it, each loudly.
"""
from __future__ import annotations

import copy
import io
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import Config, resolve_device
from .data.dataset import TrainingData
from .data.packing import PackedBins, build_pack_plan, pack_bins
from .data.stream import BlockStreamer
from .grower import (FeatureMeta, GrowerConfig, StreamedGrower, TreeArrays,
                     WindowBuffers, grow_tree, resolve_partition_impl)
from .metrics import Metric, create_metric, default_metric_for_objective
from .objectives import Objective, parse_objective_string
from .obs import memory
from .ops.histogram import movable
from .ops.lambdarank import default_label_gain
from .parallel import mesh as mesh_mod
from .parallel import sync
from .parallel.gspmd import GspmdGrower, Procs, resolve_gspmd_hist
from .predictor import (Predictor, SoABundle, predict_binned_leaf,
                        trees_scores_binned)
from . import checkpoint as checkpoint_mod
from .tree import Tree
from .utils import faults as faults_mod
from .utils import log
from .utils.random import make_rng, sample_k


def training_device(cfg: Config) -> torch.device:
    """The device training runs on, from the config: ``cuda`` (the current
    card) unless ``device="cpu"`` (``config.resolve_device``)."""
    dev = resolve_device(cfg.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class TrainingPlan(NamedTuple):
    """Where one training runs, decided from the host Dataset's shapes
    before its bin matrix is copied to the card (:func:`plan_training`):
    the ``learner`` (``serial``, ``streamed`` or ``gspmd``), its mesh
    ``slots``, the placement walk's decision (``data_stream=auto`` on the
    serial learner) and the mesh plan (the data-parallel learners, or the
    walk's sharded rung), and ``layout``, the memory model's keywords of
    the chosen layout, whose prediction (``prediction``) the pre-flight
    held to the budget."""
    learner: str
    slots: list
    placement: Optional[mesh_mod.PlacementPlan]
    mesh: Optional[mesh_mod.MeshPlan]
    layout: dict
    prediction: dict


def _slots_per_card(slots: list, device: torch.device) -> int:
    """Mesh slots on the busiest card (``parallel/mesh.py:mesh_slots``
    deals them round-robin over the visible cards; the CPU is one)."""
    if device.type != "cuda":
        return len(slots)
    cards = min(len(slots), torch.cuda.device_count())
    return -(-len(slots) // max(cards, 1))


def _model_layout(cfg: Config, train: TrainingData, objective: Objective,
                  device: torch.device, slots: list, dist: bool) -> dict:
    """The memory model's keywords (``obs/memory.predict_hbm``) of a
    training, from the host Dataset and the config: the shapes, the
    packing and ordered copies :class:`GBDT` will make, the objective's
    device vectors, and how the mesh slots share cards."""
    fm = train.feature_meta()
    procs = sync.process_count()
    pack = None
    if cfg.enable_bin_packing and procs == 1 and not (
            dist and cfg.tree_learner in ("feature", "data_feature")):
        pack = build_pack_plan(train.col_num_bins())
    md = train.metadata
    K = objective.num_tree_per_iteration
    gains = len(cfg.label_gain or default_label_gain())
    return dict(
        rows=train.num_data, features=train.binned.shape[1],
        bins=train.max_num_bin(), leaves=cfg.num_leaves, num_class=K,
        bin_bytes=train.binned.dtype.itemsize,
        packed_cols=0 if pack is None else pack.num_storage_cols,
        slots_per_card=_slots_per_card(slots, device),
        ordered_bins=cfg.ordered_bins == "on" and pack is None,
        voting=(len(slots) * procs if cfg.tree_learner == "voting" else 0),
        bundled=len(fm["num_bin"]) if "col" in fm else 0,
        gspmd_fused=resolve_gspmd_hist(cfg.gspmd_hist, device) == "fused",
        categorical=bool(fm["is_categorical"].any()),
        compact=resolve_partition_impl(cfg.partition_impl,
                                       device) == "compact",
        cuda=device.type == "cuda",
        rollback=cfg.boosting_type != "dart",
        objective_bytes=memory.objective_device_bytes(
            objective.name, train.num_data, K, md.weight is not None,
            md.query_boundaries, gains),
        objective_work=memory.objective_work_bytes(objective.name,
                                                   train.num_data, K))


def plan_training(cfg: Config, train: TrainingData, objective: Objective,
                  device: Optional[torch.device] = None) -> TrainingPlan:
    """Decide the learner, the placement and the mesh from the host
    Dataset, then hold the memory model's prediction to the budget
    (``hbm_budget``, else the card's memory), all before the bin matrix
    is copied to the card (``lightgbm_tpu/boosting.py:443-445``,
    :717-770, :903-961).

    * A parallel ``tree_learner`` over more than one mesh slot (of all
      processes) is the data-parallel learner: an explicit ``mesh_shape``
      is priced as it is, ``auto`` over several slots is sized by
      ``parallel/mesh.plan_mesh`` (``prefer`` from the learner), and
      ``shard_axes`` then overrides whether the bins are block-sharded.
    * Otherwise the serial learner walks ``resolve_placement``:
      resident, then streamed blocks, then, past both, the mesh the
      planner sizes over the mesh slots, handed to the data-parallel
      learner loudly.  DART and GOSS skip the walk (their drops and
      sampling assume the resident rows, :725).

    Raises ``parallel.mesh.MeshPlanError`` when no rung fits, and the
    pre-flight raises when the chosen layout's prediction is over an
    explicit ``hbm_budget``."""
    device = device if device is not None else training_device(cfg)
    procs = sync.process_count()
    slots = (mesh_mod.mesh_slots(cfg.mesh_devices, device)
             if cfg.tree_learner != "serial" else [device])
    use_dist = cfg.tree_learner != "serial" and (
        cfg.mesh_devices != 1 and len(slots) * procs > 1)
    if procs > 1 and not use_dist:
        log.fatal("num_machines > 1 requires tree_learner=data, voting "
                  "(per-process row partitions) or feature (full data "
                  "on every process) over >1 devices; a serial learner "
                  "would silently train per-partition models")
    capacity = (int(cfg.hbm_budget) if cfg.hbm_budget > 0
                else memory.device_capacity(device))
    layout = _model_layout(cfg, train, objective, device, slots, use_dist)
    placement = mesh_plan = None
    learner = "gspmd" if use_dist else "serial"
    if not use_dist:
        if cfg.boosting_type not in ("dart", "goss"):
            all_slots = mesh_mod.mesh_slots(cfg.mesh_devices, device)
            placement = mesh_mod.resolve_placement(
                capacity=capacity, data_stream=cfg.data_stream,
                stream_chunk_rows=cfg.stream_chunk_rows,
                n_devices=len(all_slots), prefer="data",
                local_devices=len(all_slots),
                **dict(layout, slots_per_card=_slots_per_card(all_slots,
                                                              device)))
        if placement is not None and placement.mode == "chunked":
            learner = "streamed"
            layout["stream_chunk_rows"] = placement.chunk_rows
            layout["packed_cols"] = 0
            layout["ordered_bins"] = False
        elif placement is not None and placement.mode == "sharded":
            # past streaming: the mesh the planner sized over the slots
            # (:571-585)
            log.warning("training data exceeds single-device capacity "
                        "even streamed; sharding over the %dx%d mesh the "
                        "placement planner sized", placement.mesh.data,
                        placement.mesh.feature)
            learner, mesh_plan = "gspmd", placement.mesh
            slots = mesh_mod.mesh_slots(cfg.mesh_devices, device)
            layout = _model_layout(cfg, train, objective, device, slots,
                                   True)
    else:
        prefer = {"data": "data", "feature": "feature",
                  "data_feature": "square"}.get(cfg.tree_learner, "data")
        explicit = mesh_mod.parse_mesh_shape(cfg.mesh_shape, len(slots))
        sa = str(cfg.shard_axes).strip().lower().replace(" ", "")
        if explicit is not None or len(slots) == 1:
            # one slot of this process (several processes): a 1x1 mesh
            d, fs = explicit or (1, 1)
            block = sa in ("batch,feature", "feature,batch")
            pred = mesh_mod.predict_hbm(data_shards=d, feature_shards=fs,
                                        block_shard_bins=block, **layout)
            mesh_plan = mesh_mod.MeshPlan(
                d, fs, block, int(pred["peak_bytes"]), capacity,
                memory.top_terms(pred, 4),
                f"explicit mesh_shape={cfg.mesh_shape}"
                if explicit is not None else "one mesh slot a process")
        else:
            mesh_plan = mesh_mod.plan_mesh(len(slots), capacity=capacity,
                                           prefer=prefer, **layout)
        if sa == "batch":
            mesh_plan = mesh_plan._replace(block_shard_bins=False)
        elif sa in ("batch,feature", "feature,batch"):
            mesh_plan = mesh_plan._replace(block_shard_bins=True)
        if procs > 1 and mesh_plan.block_shard_bins:
            # each process routes its own rows over its own slices; a
            # split column another process holds would need a collective
            # in the route, which the port does not have
            log.fatal("block-sharded bins (shard_axes=batch,feature or the "
                      "planner's choice) are single-process; use "
                      "shard_axes=batch across processes")
    if mesh_plan is not None:
        layout.update(data_shards=mesh_plan.data,
                      feature_shards=mesh_plan.feature,
                      block_shard_bins=mesh_plan.block_shard_bins)
    pred = mesh_mod.predict_hbm(**layout)
    memory.preflight(pred, cfg.hbm_budget,
                     f"{train.num_data} rows x {train.binned.shape[1]} "
                     f"cols, {learner} learner", capacity)
    return TrainingPlan(learner, slots, placement, mesh_plan, layout, pred)


def resolve_parallel_impl(cfg: Config, procs: int):
    """``parallel_impl`` as the JAX package resolves it
    (``lightgbm_tpu/boosting.py:453-497``): ``gspmd`` becomes ``shardmap``
    for the voting learner and for the feature learner over several
    processes, each loudly, and ``auto`` is ``shardmap`` for those and
    ``gspmd`` otherwise.  Returns ``(impl, downgrades)``.  The port has
    one learner, which sums the shards' partials by hand, the shard_map
    choreography; both names run it."""
    impl, downgrades = cfg.parallel_impl, []
    cases = ((procs > 1 and cfg.tree_learner == "feature",
              "multi-process tree_learner=feature (the "
              "full-data-everywhere replication contract)",
              "multi-process feature-parallel replicates the full dataset"),
             (cfg.tree_learner == "voting",
              "tree_learner=voting (PV-tree vote compression IS call-site "
              "collective machinery)",
              "voting learner needs explicit vote collectives"))
    for hit, what, reason in cases:
        if impl == "gspmd" and hit:
            log.warning("parallel_impl=gspmd is unavailable for %s; "
                        "falling back to shard_map", what)
            downgrades.append({"requested": "parallel_impl=gspmd",
                               "resolved": "shardmap", "reason": reason})
            impl = "shardmap"
    if impl == "auto":
        impl = "shardmap" if any(hit for hit, _, _ in cases) else "gspmd"
    return impl, downgrades


class NonFiniteError(RuntimeError):
    """A gradient, hessian or leaf value went non-finite and the
    ``nonfinite_policy`` could not (or was asked not to) recover
    (``lightgbm_tpu/boosting.py:52``)."""


def _init_scores(data: TrainingData, num_class: int,
                 device: torch.device) -> torch.Tensor:
    """``[K, N]`` f32 scores, from the dataset's init scores or 0."""
    n = data.num_data
    init = data.metadata.init_score
    if init is None:
        return torch.zeros((num_class, n), dtype=torch.float32, device=device)
    if init.size != num_class * n:
        raise ValueError(f"init_score has {init.size} values; the data needs "
                         f"{num_class} x {n}")
    return torch.from_numpy(np.asarray(init, np.float32).reshape(
        num_class, n)).to(device)


def _tree_to_host(arrays: TreeArrays, *flags: torch.Tensor):
    """A tree's arrays, and the scalar bool ``flags`` beside them, in one
    copy to the host: every field's bytes concatenated on the device,
    copied, and cut into numpy arrays of the fields' types and shapes.
    Returns (the arrays with numpy fields, the flags as Python bools)."""
    fields = {f: v for f, v in arrays._asdict().items()
              if isinstance(v, torch.Tensor)}
    parts = [*fields.values(), *(f.reshape(1) for f in flags)]
    raw = torch.cat([t.contiguous().view(-1).view(torch.uint8)
                     for t in parts]).cpu().numpy()
    out, at = [], 0
    for t in parts:
        dt = np.dtype(str(t.dtype).replace("torch.", ""))
        n = t.numel() * dt.itemsize
        out.append(raw[at:at + n].view(dt).reshape(tuple(t.shape)).copy())
        at += n
    host = arrays._replace(**dict(zip(fields, out)))
    return host, [bool(a[0]) for a in out[len(fields):]]


class _ValidSet:
    def __init__(self, data: TrainingData, bins: torch.Tensor, name: str,
                 num_class: int, metrics: List[Metric]):
        self.data = data
        self.name = name
        self.bins = bins
        self.metrics = metrics
        self.scores = _init_scores(data, num_class, bins.device)


class GBDT:
    """Gradient Boosting Decision Tree driver (gbdt.cpp)."""

    sub_model_name = "tree"
    # RF averages its trees' outputs (model text line ``average_output``)
    average_output = False
    allow_boost_from_average = True
    # rollback of the last iteration restores the scores stashed at its
    # start; DART's drop and normalisation cannot be unwound that way
    rollback_safe = True

    def __init__(self, config: Config, train_set: Optional[TrainingData] = None,
                 objective: Optional[Objective] = None,
                 bins: Optional[torch.Tensor] = None,
                 plan: Optional[TrainingPlan] = None):
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
        # per-training counters: host reads of the grow loop, splits, trees,
        # the host reads of row sampling (GOSS: one a sampled iteration), the
        # non-finite guard's trips and the copies a snapshot reads from the
        # device (checkpoint_state)
        self.stats: Dict[str, int] = {"host_syncs": 0, "splits": 0,
                                      "trees": 0, "sample_host_reads": 0,
                                      "nonfinite_trips": 0,
                                      "snapshot_host_reads": 0}
        # (iteration, training scores, valid scores) cloned at the start of
        # the last iteration: its rollback restores them bit for bit
        self._score_stash = None
        # bumped whenever the stored trees change other than by appending
        # (rollback, merge, DART's normalisation, a leaf edit): a cached
        # predictor of the trees is stale then
        self.model_epoch = 0
        self._bundle, self._bundle_key = None, None   # predictor()'s cache
        # the learner as resolved, and a record of a loud fallback to serial
        # or to shard_map; the tensors' backend under several processes
        self.parallel_impl = "serial"
        self.dist_backend: Optional[str] = None
        self.gspmd_hist: Optional[str] = None
        self.mesh: Optional[mesh_mod.Mesh] = None
        self.downgrades: List[Dict[str, str]] = []
        # the data-parallel learner, made once per training: it holds its
        # device state across trees (and, with every mesh slot on one card,
        # its split step captured as a CUDA graph)
        self._gspmd: Optional[GspmdGrower] = None
        # the serial grower's device state, made at the first tree
        self._windows: Optional[WindowBuffers] = None
        # data_stream=chunked: the pipeline of the host bin matrix and the
        # streamed grower, made once per training
        self._streamer: Optional[BlockStreamer] = None
        self._streamed: Optional[StreamedGrower] = None
        self._row_pad = 0
        # nibble packing: the packed storage matrix the histogram reads,
        # with its plan (None: the histogram reads the bins)
        self.packed: Optional[PackedBins] = None
        # the non-finite guard: the iteration whose trip was logged, and
        # the iteration rolled back once (a second trip there raises)
        self._nf_event_iter: Optional[int] = None
        self._nf_rolled_iter: Optional[int] = None
        # where the training runs (plan_training): the placement walk's and
        # the mesh planner's decisions, and the memory model's prediction
        self.plan: Optional[TrainingPlan] = None
        self.placement: Optional[mesh_mod.PlacementPlan] = None
        self.mesh_plan: Optional[mesh_mod.MeshPlan] = None
        if train_set is not None:
            self._setup_device(train_set, bins, plan)

    # ------------------------------------------------------------------ setup

    def _setup_device(self, train: TrainingData,
                      bins: Optional[torch.Tensor],
                      plan: Optional[TrainingPlan] = None) -> None:
        """The device state of training (boosting.py:216 ``_setup_device``):
        the learner and layout of ``plan`` (:func:`plan_training`'s, made
        here when not given), the bin matrix (None when it is streamed),
        feature metadata, grower config, objective state, scores and
        sampling state."""
        cfg = self.config
        self.device = training_device(cfg)
        self.bins = bins
        fm = train.feature_meta()
        procs = sync.process_count()
        if plan is None:
            plan = plan_training(cfg, train, self.objective, self.device)
        self.plan, self.placement, self.mesh_plan = (plan, plan.placement,
                                                     plan.mesh)
        slots = plan.slots
        use_dist = plan.learner == "gspmd"
        if procs > 1:
            self.dist_backend = torch.distributed.get_backend()
        streamed = plan.learner == "streamed"
        if streamed != (bins is None):
            raise ValueError("the bin matrix must be on the device unless "
                             "training streams it (the placement's chunked "
                             "rung), and absent when it does")
        # nibble packing over the physical columns (boosting.py:497-528);
        # the feature-sliced learners keep the 1:1 layout
        ordered = "off" if cfg.ordered_bins == "auto" else cfg.ordered_bins
        plan = None
        if cfg.enable_bin_packing and procs == 1 and not (
                use_dist and cfg.tree_learner in ("feature", "data_feature")):
            plan = build_pack_plan(train.col_num_bins())
        if plan is not None and streamed:
            # boosting.py:781-792
            log.warning("nibble bin packing is ignored under "
                        "data_stream=chunked (the packed histogram copy "
                        "is a second resident copy of exactly the matrix "
                        "streaming exists to keep off-device); streaming "
                        "the raw 1:1 bin layout")
            self.downgrades.append({
                "requested": "enable_bin_packing=true",
                "resolved": "unpacked",
                "reason": "streamed blocks keep the raw 1:1 bin layout"})
            plan = None
        if streamed and ordered == "on":
            # boosting.py:806-815
            log.warning("ordered_bins=on is ignored under "
                        "data_stream=chunked (leaf-ordered storage "
                        "assumes the resident row layout); using the "
                        "direct layout")
            self.downgrades.append({
                "requested": "ordered_bins=on", "resolved": "off",
                "reason": "streamed blocks keep source row order"})
            ordered = "off"
        if plan is not None:
            if ordered == "on":
                log.warning("ordered_bins=on is ignored while nibble bin "
                            "packing is active (the packed storage matrix "
                            "has its own layout); set "
                            "enable_bin_packing=false to use the "
                            "leaf-ordered path")
                ordered = "off"
            self.packed = pack_bins(bins, plan)
            log.info("Bin packing: %d of %d columns nibble-packed into %d "
                     "bytes/row (histogram path)", plan.num_packed,
                     plan.num_phys_cols, plan.num_storage_cols)
        put = lambda a: torch.from_numpy(a).to(self.device)
        self.meta = FeatureMeta(
            num_bin=put(fm["num_bin"]), missing_type=put(fm["missing_type"]),
            default_bin=put(fm["default_bin"]),
            is_categorical=put(fm["is_categorical"]),
            col=put(fm["col"]) if "col" in fm else None,
            offset=put(fm["offset"]) if "offset" in fm else None)
        self.used_feature_index = {f: i for i, f in
                                   enumerate(train.used_features)}
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
            ordered_bins=ordered)
        self.objective.init(train.metadata, self.num_data, self.device)
        self.num_class = self.objective.num_tree_per_iteration
        self.scores = _init_scores(train, self.num_class, self.device)
        self._has_init_score = train.metadata.init_score is not None
        # the feature mask the growers read at every step: each tree's
        # sample is copied into it (boosting.py:1179 _feature_sample)
        self._feat_valid = torch.ones(len(fm["num_bin"]), dtype=torch.bool,
                                      device=self.device)
        self._feat_sampled = False
        self._ones = torch.ones(self.num_data, dtype=torch.float32,
                                device=self.device)
        # row sampling (boosting.py:303-304): the gradients' weights (None:
        # all 1), the count weights, and the bag of the subset regime as
        # (sorted int32 rows, their weights over all rows, 0 elsewhere)
        self._bag_weight: Optional[torch.Tensor] = None
        self._bag_cnt = self._ones
        self._subset: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._bagging_on = False
        self._bag_rng = make_rng(cfg.bagging_seed)
        self._feat_rng = make_rng(cfg.feature_fraction_seed)
        # a bag as the root window: the serial learner only (:554); under
        # streaming bagging keeps the weight-mask form (:816-818)
        self._can_subset = not use_dist and not streamed
        self.metric_names = (cfg.metric
                             or [default_metric_for_objective(cfg.objective)])
        self.train_metrics = self._make_metrics(train)
        if use_dist:
            self._setup_gspmd(cfg, slots, procs)
        elif streamed:
            self._setup_streamed(cfg, train, self.placement.chunk_rows)
        if not use_dist and cfg.tree_learner != "serial":
            # loud fallback (:555-565)
            log.warning(f"tree_learner={cfg.tree_learner} requested but only "
                        f"one mesh slot is in use (slots={len(slots)}, "
                        f"mesh_devices={cfg.mesh_devices}); falling back to "
                        f"serial")
            self.downgrades.append({
                "requested": f"tree_learner={cfg.tree_learner}",
                "resolved": "serial", "reason": "only one device is in use"})

    def _setup_streamed(self, cfg: Config, train: TrainingData,
                        chunk: int) -> None:
        """The placement's chunked rung (lightgbm_tpu/boosting.py:772-829):
        the bin matrix cut into host row blocks of ``chunk`` rows,
        page-locked on a card, and the streamed grower over their
        pipeline.  Packing and ``ordered_bins=on`` were turned off
        above."""
        store = train.to_blocks(chunk, pin=self.device.type == "cuda")
        self._streamer = BlockStreamer(store, self.device)
        self._streamed = StreamedGrower(self.grower_cfg, self._streamer,
                                        n_logical=self.meta.num_bin.numel())
        log.info("Using streamed serial tree learner: %d blocks of %d "
                 "rows, double-buffered", store.num_blocks,
                 store.chunk_rows)

    def _over_train_bins(self, fn) -> torch.Tensor:
        """``fn(bins)`` (a ``[..., rows]`` result on the device) over the
        training bin matrix: on the device matrix, or, when it is
        streamed, block by block through the pipeline, concatenated in row
        order (the JAX package uploads a cached whole copy instead,
        ``lightgbm_tpu/boosting.py:1503-1512``)."""
        if self._streamer is None:
            return fn(self.bins)
        return torch.cat([fn(block) for _, _, _, block
                          in self._streamer.blocks()], dim=-1)

    def _setup_gspmd(self, cfg: Config, slots, procs: int) -> None:
        """The data-parallel learners (lightgbm_tpu/boosting.py:443-500,
        :600-716, :830-1049, with an explicit mesh): resolve
        ``parallel_impl`` and the histogram formulation, size this
        process's mesh, pad its rows to whole shards and build the
        grower, which votes under ``tree_learner=voting``.  Over several
        processes the data and voting learners extend the batch axis (each
        process holds its own rows), the feature learner the feature axis
        (each holds every row, which the ranks check)."""
        impl, downgrades = resolve_parallel_impl(cfg, procs)
        self.downgrades.extend(downgrades)
        gspmd_hist = resolve_gspmd_hist(cfg.gspmd_hist, self.device)
        # the shape plan_training chose: explicit, or the planner's
        d, fs = self.mesh_plan.data, self.mesh_plan.feature
        if cfg.ordered_bins == "on" or cfg.partition_impl not in ("auto",
                                                                  "scatter"):
            log.warning("ordered_bins and partition_impl act on the serial "
                        "grower's order window; the data-parallel learner "
                        "keeps a row -> leaf map and ignores them")
        self.parallel_impl = impl
        self.gspmd_hist = gspmd_hist
        self.mesh = mesh_mod.make_named_mesh(d, fs, slots)
        axis = (mesh_mod.FEATURE_AXIS if cfg.tree_learner == "feature"
                else mesh_mod.BATCH_AXIS)
        if procs > 1 and axis == mesh_mod.FEATURE_AXIS:
            # the replication contract (:676-692): every process feeds the
            # same full matrix
            binned = self.train_set.binned
            sig = (tuple(binned.shape),
                   zlib.crc32(np.ascontiguousarray(binned)))
            sigs = sync.allgather_object(sig)
            if any(x != sig for x in sigs):
                log.fatal("feature-parallel multi-process training "
                          "requires the FULL identical dataset on every "
                          "process (got differing data signatures %s); "
                          "per-process row partitions need "
                          "tree_learner=data or voting", sigs)
        # rows padded to whole shards with zero weights (:1026-1031)
        self._row_pad = mesh_mod.pad_rows(self.num_data, d)
        pad = lambda t: (t if not self._row_pad or t is None else torch.cat(
            [movable(t), movable(t).new_zeros((self._row_pad, t.shape[1]))]
        ).view(t.dtype))
        log.info("Using the data-parallel %s learner over a %dx%d (batch, "
                 "feature) mesh of %d process(es) (%s), %s histogram, bins "
                 "%s (%s)", cfg.tree_learner, d, fs, procs, impl, gspmd_hist,
                 "block-sharded" if self.mesh_plan.block_shard_bins
                 else "replicated over feature", self.mesh_plan.reason)
        packed = (None if self.packed is None else
                  self.packed._replace(matrix=pad(self.packed.matrix)))
        self._gspmd = GspmdGrower(
            self.grower_cfg, self.mesh, pad(self.bins), gspmd_hist,
            self.meta.num_bin.numel(), packed,
            top_k=cfg.top_k if cfg.tree_learner == "voting" else None,
            procs=Procs(procs, sync.process_index(), axis),
            block_shard=self.mesh_plan.block_shard_bins)

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
                      name: str, raw: Optional[np.ndarray] = None) -> None:
        """A valid set; the trees already held (continued training) are
        replayed onto its scores from its raw rows ``raw``."""
        vs = _ValidSet(data, bins, name, self.num_class,
                       self._make_metrics(data))
        if self.models:
            if raw is None:
                raise ValueError("a valid set added after the model holds "
                                 "trees needs its raw rows")
            pred = Predictor(self.models, self.num_class, None,
                             bins.device).predict_raw(raw)
            vs.scores += torch.from_numpy(pred.astype(np.float32)).to(
                bins.device)
        self.valid_sets.append(vs)

    # --------------------------------------------------------------- training

    def _rows_partitioned(self) -> bool:
        """Whether each process holds its own rows: the data and voting
        learners over several processes."""
        return (self._gspmd is not None and self._gspmd.procs is not None
                and self._gspmd.procs.axis == mesh_mod.BATCH_AXIS)

    def _boost_from_average(self) -> None:
        """gbdt.cpp:407-480: constant init tree from the label average;
        with each process holding its own rows, from the processes'
        ``(num, den)`` summed in rank order (GlobalSyncUpByMean,
        lightgbm_tpu/boosting.py:1103-1120)."""
        num, den = self.objective.average_stats()
        if self._rows_partitioned():
            parts = sync.allgather_object((num, den))
            num = sum(p[0] for p in parts)
            den = sum(p[1] for p in parts)
        init = self.objective.init_from_average(num / max(den, 1e-300))
        tree = Tree(1)
        tree.leaf_value[0] = init
        self.models.append(tree)
        self.scores = self.scores + init
        for vs in self.valid_sets:
            vs.scores = vs.scores + init
        self.boost_from_average_ = True
        log.info("Start training from score %f", init)

    def _wants_boost_from_average(self) -> bool:
        return (self.iter_ == 0 and self.allow_boost_from_average
                and self.objective is not None
                and self.objective.boost_from_average
                and not self._has_init_score
                and self.num_class == 1
                and self.config.boost_from_average
                and not self.boost_from_average_)

    def _bagging(self, it: int) -> None:
        """Row bagging (gbdt.cpp:323-382, boosting.py:1124-1154): every
        ``bagging_freq`` iterations a new bag.  At a fraction of at most
        0.5 on the serial learner, exactly ``fraction * N`` rows without
        replacement, grown as the root window (the reference's
        ``is_use_subset_``); else a Bernoulli 0/1 weight per row.  Bagging
        switched off mid-training (``reset_parameter``) restores every
        row."""
        cfg = self.config
        if cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0:
            if it % cfg.bagging_freq == 0:
                n = self.num_data
                if self._can_subset and cfg.bagging_fraction <= 0.5:
                    m = max(1, int(n * cfg.bagging_fraction))
                    self._set_subset(sample_k(self._bag_rng, n, m), None)
                else:
                    self._subset = None
                    mask = (self._bag_rng.random(n)
                            < cfg.bagging_fraction).astype(np.float32)
                    self._bag_weight = torch.from_numpy(mask).to(self.device)
                    self._bag_cnt = self._bag_weight
                self._bagging_on = True
        elif self._bagging_on:
            self._bagging_on = False
            self._subset = None
            self._bag_weight = None
            self._bag_cnt = self._ones

    def _set_subset(self, idx: np.ndarray, w: Optional[np.ndarray]) -> None:
        """The bag ``idx`` (sorted row ids) with its weights ``w`` (None:
        1), grown as the root window: the rows go to the device once, and
        the weights become a vector over all rows, 0 off the bag, that
        the gradients are multiplied by (boosting.py:1156-1177 gathers the
        rows into a matrix instead)."""
        rows = torch.from_numpy(idx.astype(np.int32)).to(self.device)
        weight = torch.zeros(self.num_data, dtype=torch.float32,
                             device=self.device)
        weight[rows.long()] = (1.0 if w is None else torch.from_numpy(
            w.astype(np.float32)).to(self.device))
        self._subset = (rows, weight)
        self._bag_weight = None
        self._bag_cnt = (weight > 0).float()

    def _sample(self, it: int, g: torch.Tensor, h: torch.Tensor):
        """Row sampling hook: bagging for GBDT, overridden by GOSS.
        Returns the gradients, hessians and the count weights ``[N]``."""
        self._bagging(it)
        return g, h, self._bag_cnt

    def _feature_sample(self) -> np.ndarray:
        """A tree's feature mask (boosting.py:1179): ``feature_fraction``
        of the features without replacement."""
        mask = np.ones(self._feat_valid.numel(), dtype=bool)
        frac = self.config.feature_fraction
        if frac < 1.0:
            f = len(mask)
            k = max(1, int(f * frac))
            chosen = self._feat_rng.choice(f, size=k, replace=False)
            sub = np.zeros(f, dtype=bool)
            sub[chosen] = True
            mask &= sub
        return mask

    def _next_feature_mask(self) -> None:
        """Draw a tree's mask and copy it into the one mask tensor, which
        the captured split steps read where it lies."""
        sampled = self.config.feature_fraction < 1.0
        if sampled or self._feat_sampled:
            self._feat_valid.copy_(torch.from_numpy(self._feature_sample()))
        self._feat_sampled = sampled

    def _custom_gradients(self, grad, hess):
        """The caller's gradients and hessians (numpy or tensors, ``K * N``
        values) as ``[K, N]`` float32 on the training device."""
        return tuple(torch.as_tensor(a, dtype=torch.float32,
                                     device=self.device).reshape(
                                         self.num_class, -1)
                     for a in (grad, hess))

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration; True when training should stop
        (gbdt.cpp:465-581 TrainOneIter).  ``grad`` and ``hess`` (``K *
        N`` values each) replace the objective's gradients
        (boosting.py:1289-1293)."""
        if self.num_init_iteration == 0 and self._wants_boost_from_average():
            self._boost_from_average()
        if self.rollback_safe:
            self._score_stash = (self.iter_, self.scores.clone(),
                                 [vs.scores.clone() for vs in self.valid_sets])
        if grad is None or hess is None:
            g, h = self.objective.get_gradients(self.scores)
        else:
            g, h = self._custom_gradients(grad, hess)
        fi = faults_mod.get_faults()
        if fi.enabled:
            # the fault points beside the guard (boosting.py:1294-1299); a
            # copy, so that RF's gradients of the zero score stay clean
            if fi.fire("nan_grad", int(self.iter_)):
                g = g.clone()
                g[0, 0].fill_(float("nan"))
            if fi.fire("inf_hess", int(self.iter_)):
                h = h.clone()
                h[0, 0].fill_(float("inf"))
        # the guard's flag on the device (boosting.py:1298-1306), read with
        # the tree's copy to the host; clamp sanitizes g -> 0, h -> 1
        gh_ok = torch.isfinite(g).all() & torch.isfinite(h).all()
        if self.config.nonfinite_policy == "clamp":
            g = torch.where(torch.isfinite(g), g, 0.0)
            h = torch.where(torch.isfinite(h), h, 1.0)
        g, h, cnt = self._sample(self.iter_, g, h)
        lr = self._shrinkage_rate()
        lr_t = torch.tensor(lr, dtype=torch.float32, device=self.device)
        any_split = False
        for k in range(self.num_class):
            # a mask per tree, like the reference's BeforeTrain
            # (serial_tree_learner.cpp:234-260)
            self._next_feature_mask()
            # tree k from class k's gradients, through the one grower made
            # for the training (on the graph loop, the same captured step)
            if self._subset is not None:
                rows, w = self._subset
                arrays, row_leaf = self._grow(g[k] * w, h[k] * w, cnt, rows)
            else:
                bw = self._bag_weight
                arrays, row_leaf = self._grow(
                    g[k] if bw is None else g[k] * bw,
                    h[k] if bw is None else h[k] * bw, cnt)
            self.stats["trees"] += 1
            # the flags ride the tree's one copy to the host; over several
            # processes every rank acts on their minimum (the gradients
            # are each rank's own)
            host, (tree_ok, grads_ok) = _tree_to_host(
                arrays, gh_ok & torch.isfinite(arrays.leaf_value).all(),
                gh_ok)
            if sync.process_count() > 1:
                tree_ok, grads_ok = (bool(v) for v in sync.all_reduce(
                    torch.tensor([tree_ok, grads_ok], dtype=torch.int32),
                    "min", "nonfinite_flags", host=True))
            if not tree_ok and self._handle_nonfinite(k, grads_ok):
                return False    # the iteration rolled back; retried next
            tree = Tree.from_arrays(host, self.train_set.used_features,
                                    self.train_set.bin_mappers)
            tree.shrink(lr)
            self.models.append(tree)
            if tree.num_leaves <= 1:
                continue
            any_split = True
            depth = int(host.leaf_depth[:tree.num_leaves].max())
            if self._subset is not None:
                # the out-of-bag rows need scores too (UpdateScoreOutOfBag,
                # gbdt.cpp:452-463): every row routed through the tree
                row_leaf = self._over_train_bins(
                    lambda b: predict_binned_leaf(b, arrays, self.meta,
                                                  depth))
            self.scores[k] = (self.scores[k]
                              + lr_t * arrays.leaf_value[row_leaf.long()])
            for vs in self.valid_sets:
                vleaf = predict_binned_leaf(vs.bins, arrays, self.meta, depth)
                vs.scores[k] = vs.scores[k] + lr_t * arrays.leaf_value[vleaf]
        if not any_split:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            del self.models[-self.num_class:]
            return True
        self.iter_ += 1
        return False

    def _handle_nonfinite(self, k: int, gh_ok: bool) -> bool:
        """The guard's trip at tree ``k`` of this iteration, before the
        tree is stored or a score moves (boosting.py:1579-1621): raise,
        roll the iteration back (True: retry it), or, under clamp, go on
        when the gradients were the cause.  A second trip at the same
        iteration after a rollback raises."""
        it = self.iter_
        policy = self.config.nonfinite_policy
        stage = "leaf_value" if gh_ok else "grad/hess"
        # one trip an iteration, however many of its class trees see it
        if self._nf_event_iter != it:
            self._nf_event_iter = it
            self.stats["nonfinite_trips"] += 1
            log.warning("Non-finite %s detected at iteration %d "
                        "(nonfinite_policy=%s)", stage, it, policy)
        if policy == "clamp":
            # the gradients were sanitized on the device; a non-finite
            # leaf from finite gradients has no safe clamp
            if gh_ok:
                raise NonFiniteError(
                    f"non-finite leaf values at iteration {it} (tree {k}) "
                    "with finite gradients; clamping cannot recover")
            return False
        if policy == "rollback" and self.rollback_safe:
            if self._nf_rolled_iter == it:
                raise NonFiniteError(
                    f"non-finite {stage} persisted at iteration {it} after "
                    "rollback — the source is not transient; fix the "
                    "objective/data or use nonfinite_policy=clamp")
            self._nf_rolled_iter = it
            self.model_epoch += 1
            # this iteration's earlier class trees go, and the scores
            # cloned at its start come back bit for bit
            if self._stash_usable(it):
                if k:
                    del self.models[-k:]
                _, self.scores, vscores = self._score_stash
                for vs, sc in zip(self.valid_sets, vscores):
                    vs.scores = sc
                self._score_stash = None
            else:
                for kk in reversed(range(k)):
                    self._pop_tree_and_revert(kk)
            log.warning("Rolled back iteration %d (%d earlier class "
                        "tree(s) unwound); retrying", it, k)
            return True
        hint = ("rollback is unavailable for this boosting type; use "
                "nonfinite_policy=clamp" if policy == "rollback" else
                "set nonfinite_policy=rollback or clamp to recover")
        raise NonFiniteError(
            f"non-finite {stage} detected at iteration {it} (tree {k}); "
            f"{hint}, or fix the objective/data producing it")

    def _grow(self, g: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              rows: Optional[torch.Tensor] = None):
        """One tree from gradients ``g``, hessians ``h`` and count weights
        ``c`` ``[N]`` (of the bag ``rows`` only, when given):
        ``(TreeArrays, row_leaf [N])``."""
        if self._streamed is not None:
            return self._streamed(g, h, c, self.meta, self._feat_valid,
                                  self.stats)
        if self._gspmd is not None:
            arrays, row_leaf = self._gspmd(
                self._dist_row_vec(g), self._dist_row_vec(h),
                self._dist_row_vec(c), self.meta, self._feat_valid,
                self.stats)
            return arrays, row_leaf[:self.num_data]     # the local rows
        if self._windows is None:
            # the grower's device state, made once per training: the
            # partition's buffers, the leaf pool and, on a card with
            # compact, the split step captured at the first split
            self._windows = WindowBuffers(
                *self.bins.shape, self.grower_cfg, self.device,
                n_logical=self.meta.num_bin.numel(), packed=self.packed,
                bin_dtype=self.bins.dtype)
        return grow_tree(self.bins, g, h, c, self.meta, self._feat_valid,
                         self.grower_cfg, self.stats, self._windows,
                         rows=rows)

    def _shrinkage_rate(self) -> float:
        return self.config.learning_rate

    def current_iteration(self) -> int:
        return self.iter_ + self.num_init_iteration

    # --------------------------------------------------------------- rollback

    def _trees_scores(self, trees: List[Tree],
                      bins: torch.Tensor) -> torch.Tensor:
        """Host trees' outputs ``[T, N]`` on binned rows, on the device
        (``lightgbm_tpu/predictor.py:98``)."""
        return trees_scores_binned(bins, trees, self.used_feature_index,
                                   self.meta, self.train_set.bin_mappers)

    def _pop_tree_and_revert(self, k: int) -> None:
        """Pop the last tree (class ``k``) and subtract its outputs from
        the training and valid scores (boosting.py:1518)."""
        tree = self.models.pop()
        if tree.num_leaves > 1:
            tree.shrink(-1.0)
            self.scores[k] += self._over_train_bins(
                lambda b: self._trees_scores([tree], b))[0]
            for vs in self.valid_sets:
                vs.scores[k] += self._trees_scores([tree], vs.bins)[0]

    def _stash_usable(self, expect_iter: int) -> bool:
        stash = self._score_stash
        return (self.rollback_safe and stash is not None
                and stash[0] == expect_iter
                and len(stash[2]) == len(self.valid_sets))

    def rollback_one_iter(self) -> None:
        """gbdt.cpp:583-600 (boosting.py:1544).  The last iteration's
        rollback restores the training and valid scores cloned at its start,
        bit for bit; an older one (the stash covers one iteration) subtracts
        the trees' outputs, exact up to float32 rounding."""
        if self.iter_ <= 0:
            return
        self.model_epoch += 1
        if self._stash_usable(self.iter_ - 1):
            del self.models[-self.num_class:]
            _, self.scores, vscores = self._score_stash
            for vs, sc in zip(self.valid_sets, vscores):
                vs.scores = sc
        else:
            for k in reversed(range(self.num_class)):
                self._pop_tree_and_revert(k)
        self._score_stash = None
        self.iter_ -= 1

    # ------------------------------------------------------------ checkpoint

    def data_fingerprint(self) -> int:
        """Identity of this process's training rows (boosting.py:1637):
        shape, type and a strided sample of the bin matrix where the
        training holds it — on the device, or in page-locked host memory
        when streamed.  The same integer on the CPU and on the card for the
        same Dataset, so a snapshot taken on one resumes on the other."""
        ts = self.train_set
        binned = (self.bins if self.bins is not None
                  else None if ts is None else ts.binned)
        return checkpoint_mod.data_fingerprint(
            binned, 0 if ts is None else ts.num_data)

    def checkpoint_state(self) -> dict:
        """Everything ``train_one_iter`` reads that the config and the
        Dataset do not give (boosting.py:1648): the trees, the iteration
        counts, the training and valid scores, the bagging and feature
        streams, the live bag and the learning rate.  The device tensors
        are copied to the host here, at a snapshot only; the iterations
        between snapshots read nothing more."""
        def host(t):
            if t is None:
                return None
            self.stats["snapshot_host_reads"] += 1
            return t.cpu().numpy()

        if self.bins is not None:     # the fingerprint's sample of the bins
            self.stats["snapshot_host_reads"] += 1
        return {
            "data_fingerprint": self.data_fingerprint(),
            "kind": self.sub_model_name,
            "models": list(self.models),
            "iter_": self.iter_,
            "num_init_iteration": self.num_init_iteration,
            "boost_from_average_": self.boost_from_average_,
            "scores": host(self.scores),
            "valid_scores": [host(vs.scores) for vs in self.valid_sets],
            "bag_rng": self._bag_rng.bit_generator.state,
            "feat_rng": self._feat_rng.bit_generator.state,
            "bagging_on": self._bagging_on,
            "bag_weight": host(self._bag_weight),
            # the count weights when they are not all 1 or the bag weights
            "bag_cnt": (None if self._bag_cnt is self._ones
                        or self._bag_cnt is self._bag_weight
                        else host(self._bag_cnt)),
            "subset": (None if self._subset is None else
                       {"idx": host(self._subset[0]),
                        "w": host(self._subset[1])}),
            "learning_rate": self.config.learning_rate,
        }

    def load_checkpoint_state(self, st: dict) -> None:
        """Inverse of :meth:`checkpoint_state` (boosting.py:1672), on a
        booster of the same Dataset and parameters: a fingerprint of other
        data raises :class:`~.checkpoint.CheckpointError`.  It runs before
        the first tree, so before any capture, and writes the scores into
        the existing tensors in place (``copy_``); the tensors a captured
        split step reads (bins, metadata, the feature mask, the grower's
        own buffers) are never replaced, so a graph captured earlier stays
        valid."""
        fp = st.get("data_fingerprint")
        if fp is not None and int(fp) != self.data_fingerprint():
            raise checkpoint_mod.CheckpointError(
                "checkpoint dataset-partition fingerprint does not match "
                "the training data this booster holds — resuming would "
                "silently diverge (did the row shard or binning change?)")
        scores = np.asarray(st["scores"])
        if tuple(scores.shape) != tuple(self.scores.shape):
            raise checkpoint_mod.CheckpointError(
                f"checkpoint scores of shape {scores.shape} do not fit "
                f"this booster's {tuple(self.scores.shape)}")
        dev = self.device
        put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        self.models = list(st["models"])
        self.iter_ = int(st["iter_"])
        self.num_init_iteration = int(st["num_init_iteration"])
        self.boost_from_average_ = bool(st["boost_from_average_"])
        self.scores.copy_(torch.from_numpy(scores))
        for vs, sc in zip(self.valid_sets, st["valid_scores"]):
            vs.scores.copy_(torch.from_numpy(np.asarray(sc)))
        self._bag_rng = make_rng(0)
        self._bag_rng.bit_generator.state = st["bag_rng"]
        self._feat_rng = make_rng(0)
        self._feat_rng.bit_generator.state = st["feat_rng"]
        self._bagging_on = bool(st["bagging_on"])
        self._bag_weight = (None if st["bag_weight"] is None
                            else put(st["bag_weight"]))
        self._bag_cnt = (put(st["bag_cnt"]) if st["bag_cnt"] is not None
                         else self._bag_weight
                         if self._bag_weight is not None and self._bagging_on
                         else self._ones)
        if st["subset"] is not None and self._streamer is not None:
            log.fatal("checkpoint carries a bagged-subset gather state but "
                      "this booster streams its binned data "
                      "(data_stream=chunked keeps no device row matrix to "
                      "gather from); resume with data_stream=resident")
        if st["subset"] is not None:
            w = put(st["subset"]["w"])
            self._subset = (put(st["subset"]["idx"]), w)
            self._bag_cnt = (w > 0).float()
        else:
            self._subset = None
        self.config.learning_rate = float(st["learning_rate"])
        # the next tree draws and copies its feature mask afresh
        self._feat_sampled = True
        self._score_stash = None
        self._nf_event_iter = self._nf_rolled_iter = None
        self.model_epoch += 1

    def merge_from(self, other: "GBDT") -> None:
        """GBDT::MergeFrom (gbdt.h:47-66, boosting.py:1867): the other
        model's trees come first, as init iterations; training scores are
        not recomputed."""
        merged = [copy.deepcopy(t) for t in other.models]
        self.num_init_iteration += len(merged) // max(self.num_class, 1)
        self.models = merged + self.models
        self.model_epoch += 1

    # ------------------------------------------------------------------- eval

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        return self._eval("training", self.train_metrics,
                          self.scores.double().cpu().numpy())

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for vs in self.valid_sets:
            out.extend(self._eval(vs.name, vs.metrics,
                                  vs.scores.double().cpu().numpy()))
        return out

    def _eval(self, name, metrics,
              scores: np.ndarray) -> List[Tuple[str, str, float, bool]]:
        """Every metric's values on float64 host scores ``[K, N]``."""
        return [(name, mn, float(v), m.is_higher_better) for m in metrics
                for mn, v in zip(m.names(), m.eval(scores, self.objective))]

    # ---------------------------------------------------------------- predict

    def _kept_trees(self, num_iteration: int) -> List[Tree]:
        """The trees of the first ``num_iteration`` iterations (all when
        not positive), the boost-from-average tree included."""
        if num_iteration <= 0:
            return self.models
        return self.models[:(num_iteration + (1 if self.boost_from_average_
                                              else 0)) * self.num_class]

    def predictor(self, device: torch.device, num_iteration: int = -1,
                  pred_early_stop: bool = False,
                  pred_early_stop_freq: Optional[int] = None,
                  pred_early_stop_margin: Optional[float] = None
                  ) -> Predictor:
        """A predictor of the kept trees on ``device``; early stopping's
        frequency and margin default to the config's
        (``lightgbm_tpu/boosting.py:1793``).  The trees' device bundle is
        built once for each model state, device and ``num_iteration``."""
        key = (len(self.models), self.model_epoch, num_iteration,
               str(device))
        trees = self._kept_trees(num_iteration)
        if self._bundle_key != key:
            self._bundle = SoABundle(trees, device, self.num_class)
            self._bundle_key = key
        cfg = self.config
        return Predictor(
            trees, self.num_class, self.objective, device,
            self.average_output, early_stop=pred_early_stop,
            early_stop_freq=(cfg.pred_early_stop_freq
                             if pred_early_stop_freq is None
                             else pred_early_stop_freq),
            early_stop_margin=(cfg.pred_early_stop_margin
                               if pred_early_stop_margin is None
                               else pred_early_stop_margin),
            bundle=self._bundle)

    def predict(self, x: np.ndarray, device: torch.device,
                num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False,
                pred_early_stop_freq: Optional[int] = None,
                pred_early_stop_margin: Optional[float] = None):
        """Scores, leaf indices (``pred_leaf``) or TreeSHAP contributions
        (``pred_contrib``, over ``max_feature_idx + 1`` features) of the
        raw rows ``x`` (``lightgbm_tpu/boosting.py:1812``)."""
        if pred_contrib:
            return self.predictor(device, num_iteration).predict_contrib(
                x, num_features=self.max_feature_idx + 1)
        p = self.predictor(device, num_iteration, pred_early_stop,
                           pred_early_stop_freq, pred_early_stop_margin)
        if pred_leaf:
            return p.predict_leaf_index(x)
        return p.predict(x, raw_score=raw_score)

    # ------------------------------------------------------------- model file

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """Split-count or total-gain importance over the kept trees
        (gbdt.cpp FeatureImportance, boosting.py:1882); the split counts
        are written to the model file."""
        if importance_type not in ("split", "gain"):
            raise ValueError(f"importance_type must be split or gain; got "
                             f"{importance_type!r}")
        n_feat = self.max_feature_idx + 1
        trees = self._kept_trees(num_iteration)
        split_trees = [t for t in trees if t.num_leaves > 1]
        if not split_trees:
            return np.zeros(n_feat, dtype=np.float64)
        feats = np.concatenate([t.split_feature[:t.num_leaves - 1]
                                for t in split_trees])
        gains = np.concatenate([t.split_gain[:t.num_leaves - 1]
                                for t in split_trees])
        mask = gains > 0
        weights = gains[mask] if importance_type == "gain" else None
        return np.bincount(feats[mask], weights=weights,
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
        if self.average_output:
            buf.write("average_output\n")
        buf.write("feature_names=" + " ".join(self.feature_names) + "\n")
        infos = (" ".join(m.feature_info_str()
                          for m in self.train_set.bin_mappers)
                 if self.train_set else self.feature_infos)
        buf.write("feature_infos=" + infos + "\n")
        buf.write("\n")
        for i, tree in enumerate(self._kept_trees(num_iteration)):
            buf.write(tree.to_string(i))
            buf.write("\n")
        buf.write("\nfeature importances:\n")
        # saved_feature_importance_type=1 writes total gain at full
        # precision (boosting.py:1937)
        gain_mode = self.config.saved_feature_importance_type == 1
        imp = self.feature_importance(
            importance_type="gain" if gain_mode else "split",
            num_iteration=num_iteration)
        for f in np.argsort(-imp, kind="mergesort"):
            if imp[f] > 0:
                val = repr(float(imp[f])) if gain_mode else int(imp[f])
                buf.write(f"{self.feature_names[f]}={val}\n")
        return buf.getvalue()

    @staticmethod
    def load_from_string(model_str: str, config: Config) -> "GBDT":
        """gbdt.cpp:1010+ LoadModelFromString (boosting.py:1974)."""
        lines = model_str.splitlines()
        booster = GBDT(config)
        header: Dict[str, str] = {}
        i = 0
        if lines and lines[0].strip() in ("tree", "dart", "goss", "rf"):
            booster.sub_model_name = lines[0].strip()
            i = 1
        while i < len(lines):
            line = lines[i].strip()
            if line.startswith("Tree="):
                break
            if line == "boost_from_average":
                booster.boost_from_average_ = True
            elif line == "average_output":
                booster.average_output = True
            elif "=" in line:
                k, v = line.split("=", 1)
                header[k] = v
            i += 1
        booster.num_class = int(header.get("num_tree_per_iteration",
                                           header.get("num_class", "1")))
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
        booster.num_init_iteration = (len(booster.models)
                                      // max(booster.num_class, 1))
        return booster


class DART(GBDT):
    """dart.hpp, Dropouts meet MART (boosting.py:2032-2176).  Before the
    gradients, a random set of earlier iterations is dropped: their trees'
    outputs leave the training scores; the new tree is shrunk by
    ``learning_rate / (1 + k)`` for k dropped (``k + learning_rate`` in
    xgboost mode); then the dropped trees are scaled by ``k / (k + 1)``
    and the scores follow (:meth:`_normalize`).  The dropped trees are
    re-scored on the training and valid bins on the device every
    iteration, all in one batched traversal a set.  Model files start
    with ``tree``: a DART model is its trees, already normalised."""

    rollback_safe = False

    def __init__(self, config, train_set=None, objective=None, bins=None,
                 plan=None):
        super().__init__(config, train_set, objective, bins, plan)
        self._drop_rng = make_rng(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self._drop_index: List[int] = []
        self._shrinkage = config.learning_rate
        self._drop_train_contrib: Dict[Tuple[int, int], torch.Tensor] = {}

    def _select_drop(self) -> None:
        cfg = self.config
        self._drop_index = []
        if self._drop_rng.random() >= cfg.skip_drop:
            drop_rate = cfg.drop_rate
            n_iter = self.iter_
            if cfg.uniform_drop:
                if cfg.max_drop > 0 and n_iter > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / n_iter)
                self._drop_index = [i for i in range(n_iter)
                                    if self._drop_rng.random() < drop_rate]
            elif self.sum_weight > 0:
                inv_avg = len(self.tree_weight) / self.sum_weight
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop * inv_avg / self.sum_weight)
                self._drop_index = [
                    i for i in range(n_iter)
                    if self._drop_rng.random()
                    < drop_rate * self.tree_weight[i] * inv_avg]
        k = len(self._drop_index)
        if not cfg.xgboost_dart_mode:
            self._shrinkage = cfg.learning_rate / (1.0 + k)
        else:
            self._shrinkage = (cfg.learning_rate if k == 0
                               else cfg.learning_rate / (cfg.learning_rate + k))

    def _model_index(self, it: int, k: int) -> int:
        return (1 if self.boost_from_average_ else 0) + it * self.num_class + k

    def train_one_iter(self, grad=None, hess=None) -> bool:
        # the dropped trees' outputs at their current weight w leave the
        # training scores before the gradients; the normalisation adds back
        # F * w to them and takes (1 - F) * w from the valid scores, F =
        # k / (k + 1) (k / (lr + k) in xgboost mode)
        if self._wants_boost_from_average():
            self._boost_from_average()
        self._select_drop()
        self._drop_train_contrib = {}
        pairs = [(i, k) for i in self._drop_index
                 for k in range(self.num_class)]
        if pairs:
            trees = [self.models[self._model_index(i, k)] for i, k in pairs]
            contribs = self._over_train_bins(
                lambda b: self._trees_scores(trees, b))
            for t, (i, k) in enumerate(pairs):
                self._drop_train_contrib[(i, k)] = contribs[t]
                self.scores[k] -= contribs[t]
        finished = super().train_one_iter(grad, hess)
        if not finished:
            self.tree_weight.append(self._shrinkage)
            self.sum_weight += self._shrinkage
            self._normalize()
        else:
            for (i, k), contrib in self._drop_train_contrib.items():
                self.scores[k] += contrib
        return finished

    def _shrinkage_rate(self) -> float:
        return self._shrinkage

    def checkpoint_state(self) -> dict:
        """With DART's drop stream, tree weights and shrinkage
        (boosting.py:2132)."""
        st = super().checkpoint_state()
        st["dart"] = {"drop_rng": self._drop_rng.bit_generator.state,
                      "tree_weight": list(self.tree_weight),
                      "sum_weight": self.sum_weight,
                      "shrinkage": self._shrinkage}
        return st

    def load_checkpoint_state(self, st: dict) -> None:
        super().load_checkpoint_state(st)
        d = st.get("dart") or {}
        if "drop_rng" in d:
            self._drop_rng = make_rng(0)
            self._drop_rng.bit_generator.state = d["drop_rng"]
        self.tree_weight = list(d.get("tree_weight", []))
        self.sum_weight = float(d.get("sum_weight", 0.0))
        self._shrinkage = float(d.get("shrinkage", self.config.learning_rate))

    def _normalize(self) -> None:
        """dart.hpp:141-180 (boosting.py:2150)."""
        cfg = self.config
        k = float(len(self._drop_index))
        if k == 0:
            return
        factor = (k / (k + 1.0) if not cfg.xgboost_dart_mode
                  else k / (k + cfg.learning_rate))
        pairs = [(i, c) for i in self._drop_index
                 for c in range(self.num_class)]
        dropped = [self.models[self._model_index(i, c)] for i, c in pairs]
        self.model_epoch += 1
        # one batched traversal a valid set for every dropped tree
        valid_contribs = [self._trees_scores(dropped, vs.bins)
                          for vs in self.valid_sets]
        for t, (i, c) in enumerate(pairs):
            dropped[t].shrink(factor)
            self.scores[c] += self._drop_train_contrib[(i, c)] * factor
            for vs, contrib in zip(self.valid_sets, valid_contribs):
                vs.scores[c] += contrib[t] * (factor - 1.0)
        for i in self._drop_index:
            if not cfg.uniform_drop and i < len(self.tree_weight):
                denom = (k + 1.0 if not cfg.xgboost_dart_mode
                         else k + cfg.learning_rate)
                self.sum_weight -= self.tree_weight[i] / denom
                self.tree_weight[i] *= factor


class GOSS(GBDT):
    """goss.hpp, Gradient-based One-Side Sampling (boosting.py:2179-2217).
    After ``int(1 / learning_rate)`` iterations, each iteration keeps the
    ``top_rate`` rows of largest ``sum_k |g h|`` and a ``other_rate``
    share of the rest, drawn from the bagging stream, weighted
    ``(N - top_k) / other_k``.  The threshold is found on the host, which
    reads ``sum_k |g h|`` once a sampled iteration (``stats
    ["sample_host_reads"]``); the kept rows are the root window where
    ``top_rate + other_rate <= 0.5`` on the serial learner."""

    def _sample(self, it, g, h):
        cfg = self.config
        n = self.num_data
        if it < int(1.0 / max(cfg.learning_rate, 1e-10)):
            self._bag_weight = None
            self._subset = None
            return g, h, self._ones
        s = (g * h).abs().sum(0).cpu().numpy()
        self.stats["sample_host_reads"] += 1
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        thr = np.partition(s, n - top_k)[n - top_k]
        is_top = s >= thr
        n_top = int(is_top.sum())
        rest = n - n_top
        keep_prob = min(1.0, other_k / max(rest, 1))
        keep_other = (~is_top) & (self._bag_rng.random(n) < keep_prob)
        multiply = (n - top_k) / other_k
        if self._can_subset and cfg.top_rate + cfg.other_rate <= 0.5:
            # goss.hpp:120-130: the kept rows alone are grown
            idx = np.flatnonzero(is_top | keep_other)
            self._set_subset(idx, np.where(is_top[idx], 1.0, multiply))
            return g, h, self._bag_cnt
        self._subset = None
        w = np.where(is_top, 1.0, np.where(keep_other, multiply, 0.0)
                     ).astype(np.float32)
        self._bag_weight = torch.from_numpy(w).to(self.device)
        return g, h, (self._bag_weight > 0).float()


class RF(GBDT):
    """rf.hpp, a bagged random forest (boosting.py:2220-2244): the
    gradients once, from the zero score; no shrinkage; no boost from
    average; metrics and the transformed prediction over the trees'
    average (``average_output``)."""

    average_output = True
    allow_boost_from_average = False

    def __init__(self, config, train_set=None, objective=None, bins=None,
                 plan=None):
        super().__init__(config, train_set, objective, bins, plan)
        if train_set is not None:
            self._g0, self._h0 = self.objective.get_gradients(
                torch.zeros_like(self.scores))

    def train_one_iter(self, grad=None, hess=None) -> bool:
        if grad is None or hess is None:
            grad, hess = self._g0, self._h0
        return super().train_one_iter(grad, hess)

    def _shrinkage_rate(self) -> float:
        return 1.0

    def _eval(self, name, metrics, scores):
        return super()._eval(name, metrics, scores / max(self.iter_, 1))


def create_boosting(config: Config, train_set: Optional[TrainingData] = None,
                    objective: Optional[Objective] = None,
                    bins: Optional[torch.Tensor] = None,
                    plan: Optional[TrainingPlan] = None) -> GBDT:
    """Factory (boosting.cpp:29-76, boosting.py:2247); ``plan`` is
    :func:`plan_training`'s for ``train_set``, made at set-up when not
    given."""
    t = config.boosting_type
    cls = {"gbdt": GBDT, "gbrt": GBDT, "dart": DART, "goss": GOSS, "rf": RF,
           "random_forest": RF}.get(t)
    if cls is None:
        log.fatal("Unknown boosting type %s", t)
    return cls(config, train_set, objective, bins, plan)
