"""The port's device-memory model, its pre-flight, its census and the
live memory monitor.

The counterpart of ``lightgbm_tpu/obs/memory.py:322 predict_hbm``, over
the port's own allocations instead of XLA's layout (sentinel staging, pow2
gather buffers, the gather-word panel): :func:`predict_hbm` predicts the
bytes one training holds on a card, from the host Dataset's shapes and the
config, before anything is copied there.  The memory-driven planner
(``parallel/mesh.py:plan_mesh``, ``resolve_placement``) walks its
predictions.

**Per card.**  The JAX model's "device" is one mesh slot.  Here several
slots may share a card (``parallel/mesh.py:mesh_slots``), so the
prediction is for the busiest card, the primary one (slot 0's): it holds
every slot that lands on it (``slots_per_card``, slot ``s`` on card
``s % cards``), the split pool, the scores, the objective's vectors and
the valid sets.

**Residents** are tensors that live across trees.  Each term names the
tensor it counts by class and attribute (``GspmdGrower.route_bins``,
``LeafPool.store``, ...), and :func:`live_census` sums the bytes of
exactly those tensors on a trained booster, so a test can hold the two
equal to the byte.  **Transients** are the bytes above the residents at
the peak: an iteration's gradients, the larger of the objective's work
and the tree's end (the serial grower's row -> leaf map, the score
update), the split step's workspace (on a card, the captured step's
private pool), or, when it is larger, the set-up's packing of the bins.
Their counts of row vectors come from reading the code; the constants
(:data:`STEP_FIXED_BYTES`, :data:`STEP_SCAN_BYTES`, :data:`SLACK`) were
set from ``max_memory_allocated`` on an H100 (``chip_smoke.py`` phase
23a, PERF.md §5).

:func:`preflight` holds a prediction to ``hbm_budget`` (raise) or to the
card's capacity (warn), as ``lightgbm_tpu/obs/memory.py:511`` does.

**Live accounting** (``lightgbm_tpu/obs/memory.py:62-272``):
:class:`MemoryMonitor`, armed with telemetry (:func:`start` /
:func:`stop`), samples the card's allocator at every iteration and phase
(:func:`device_memory_stats`, over ``torch.cuda.memory_stats``: a host
read of the caching allocator's counters, never a wait on the card).
On the CPU, which has no allocator statistics, it sums :func:`live_census`
over the boosters registered with :func:`register_residents`: the same
census the tests hold the model to, not a second one.  Disarmed, the
active monitor is the shared :data:`NULL_MEMORY` no-op.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.lambdarank import LambdarankSchedule, schedule_bytes
from ..utils import log
from .counters import counters

# the partition kernel's positions a status word (ops/partition.py TILE)
PARTITION_TILE = 2048
# the split step's workspace, which does not scale with the rows: the
# smaller child's histogram on every slot, their sum, the two children's
# scan over [2, E, B] and, on a card, the captured step's private pool
# holding them: a fixed part and bytes a (feature x bin) cell of the
# scanned histograms (a voter's cells each, under voting)
STEP_FIXED_BYTES = 4 << 20
STEP_SCAN_BYTES = 64
# allocator rounding and small tensors the terms leave out (the scan's
# masks, feature mask copies, per-tree host copies), as a share of the
# counted peak
SLACK = 0.04

RESIDENT_TERMS = (
    "Dataset.bins", "GBDT.packed", "GBDT.scores", "GBDT._score_stash",
    "GBDT._ones", "GBDT.meta", "Objective", "_ValidSet.bins",
    "_ValidSet.scores",
    "WindowBuffers.iota", "WindowBuffers.bufs", "WindowBuffers.weights",
    "WindowBuffers.goes_left", "WindowBuffers.scratch",
    "WindowBuffers.state",
    "BlockStreamer.buffers", "StreamedGrower.row_leaf",
    "StreamedGrower.counts", "StreamedGrower.weights",
    "StreamedGrower.state",
    "GspmdGrower.route_bins", "GspmdGrower.slices",
    "GspmdGrower.route_slices", "GspmdGrower.row_leaf",
    "GspmdGrower.counts", "GspmdGrower.weights", "GspmdGrower.state",
    "LeafPool.store")


def _slice_sizes(n_cols: int, shards: int) -> List[int]:
    """Columns of each feature slice (``parallel/gspmd.py:column_slices``,
    ``np.array_split``'s cut)."""
    return [len(a) for a in np.array_split(np.arange(n_cols), shards)]


def pool_bytes(leaves: int, features: int, bins: int, logical: int,
               categorical: bool, slots: int = 0) -> int:
    """``LeafPool``'s store as ``grower.LeafPool.__init__`` allocates it:
    the ``[L + 1, (slots,) F, B, 3]`` f32 histograms (``slots``: the
    voting learner's per-voter store), the pool's gains, split rows and
    flags, the node and leaf records and the topology."""
    L, B = leaves, bins
    hist = (L + 1) * max(slots, 1) * features * B * 3 * 4
    pool = (L + 1) * (logical + 4 + 32 + 12)          # feat_ok, sgain, sf32,
    if categorical:                                    # si32; scat, scatb
        pool += (L + 1) * (1 + B)
    nodes = L * (12 + 12 + 1 + B)                      # node_f/i/cat/catb
    leaves_b = (L + 1) * 8 + L * 8 + (L + 1) * 8       # leaf_f, children,
    return hist + pool + nodes + leaves_b              # parent, depth


def objective_device_bytes(objective: str, rows: int, num_class: int = 1,
                           weighted: bool = False,
                           query_boundaries: Optional[np.ndarray] = None,
                           label_gain: int = 0,
                           label: Optional[np.ndarray] = None) -> int:
    """The bytes an objective's ``init`` puts on the device
    (``objectives.py``; ``objective`` its ``name``): the f32 labels (and
    weights), plus binary's sign and weight, the multiclass objectives'
    ``[K, N]`` one-hot or sign, or lambdarank's int32 labels, query bounds
    and its three f32 tables (``label_gain`` entries of gains) and, on a
    card (``label`` given), its kernel's schedule
    (``ops/lambdarank.py:schedule_bytes``)."""
    n = int(rows)
    out = 4 * n + (4 * n if weighted else 0)
    if objective == "binary":
        out += 8 * n
    elif objective in ("multiclass", "multiclassova"):
        out += 4 * num_class * n
    elif objective == "lambdarank":
        sizes = np.diff(np.asarray(query_boundaries, np.int64))
        q = len(sizes)
        longest = int(sizes.max()) if q else 1
        out += 4 * n + 4 * (q + 1) + 4 * q + 4 * label_gain + 4 * longest
        if label is not None:
            out += schedule_bytes(label, query_boundaries)
    return out


def objective_work_bytes(objective: str, rows: int,
                         num_class: int = 1) -> int:
    """The most bytes an objective's ``get_gradients`` holds besides the
    gradients it returns: binary's response, its absolute value and the
    exponential's temporaries; the multiclass objectives' ``[K, N]``
    probabilities and their temporaries; lambdarank's kernel writes the
    gradients directly; the regressions a residual or two."""
    n, k = int(rows), int(num_class)
    if objective == "binary":
        return 12 * n
    if objective in ("multiclass", "multiclassova"):
        return 12 * k * n
    if objective == "lambdarank":
        return 0
    return 8 * n


def _mesh_card(d: int, fs: int, slots_per_card: int):
    """The slots and batch shards of the primary card: slot ``i * fs + j``
    (batch shard i, feature slice j) lies on card ``s % cards``."""
    k = d * fs
    cards = max(1, -(-k // max(1, int(slots_per_card))))
    slots = [(s // fs, s % fs) for s in range(k) if s % cards == 0]
    held = sorted({i for i, _ in slots})
    return cards, slots, held


def predict_hbm(rows: int, features: int, bins: int = 255, leaves: int = 31,
                num_class: int = 1, bin_bytes: Optional[int] = None,
                packed_cols: int = 0, valid_rows: int = 0,
                data_shards: int = 1, feature_shards: int = 1,
                block_shard_bins: bool = False,
                stream_chunk_rows: int = 0, slots_per_card: int = 1,
                ordered_bins: bool = False, voting: int = 0,
                bundled: int = 0, gspmd_fused: bool = True,
                categorical: bool = False, compact: bool = True,
                cuda: bool = True, rollback: bool = True,
                objective_bytes: Optional[int] = None,
                objective_work: Optional[int] = None,
                serving_trees: int = 0, serving_nodes: int = 0,
                serving_cols: int = 0, serving_bins: int = 0,
                serving_buckets: Sequence[int] = (),
                serving_classes: int = 1, serving_cat_rows: int = 1,
                serving_cat_width: int = 1, serving_packed: bool = False,
                serving_layout: str = "xla",
                processes: int = 1) -> Dict[str, Any]:
    """Predicted bytes of one training on its primary card, or of one
    serving engine.

    The JAX signature where it applies: ``rows`` and ``features``
    (physical columns, after EFB), ``bins`` (the widest column's bins),
    ``leaves``, ``num_class``, ``bin_bytes`` (1 or 2; from ``bins`` when
    None), ``packed_cols`` (the nibble-packed storage matrix's columns, 0
    unpacked), ``valid_rows`` (all valid sets), ``data_shards`` x
    ``feature_shards`` (the data-parallel mesh; 1 x 1 the serial
    learner), ``block_shard_bins`` (each slot holds only its column slice
    of its batch shard), ``stream_chunk_rows`` (> 0 on the serial
    learner: ``data_stream=chunked`` at that block size).

    The port's layout: ``slots_per_card`` (mesh slots sharing a card; 1 is
    the JAX package's one slot a device), ``ordered_bins`` (the serial
    grower's leaf-ordered copies), ``voting`` (the voting learner's voter
    count, 0 for the others), ``bundled`` (the logical features when EFB
    bundles columns, 0 when columns and features are 1:1),
    ``gspmd_fused`` (the shard-local kernel, else the flat scatter-add),
    ``categorical`` (the pool's bins-left rows), ``compact`` (the serial
    grower's partition kernel and its scratch), ``cuda`` (the card's
    buffers: the partition scratch and the streamed blocks),
    ``rollback`` (the scores cloned at each iteration's start; not DART),
    ``objective_bytes`` (:func:`objective_device_bytes`; binary's when
    None) and ``objective_work`` (:func:`objective_work_bytes`; binary's
    when None).  ``processes`` > 1 prices one process of the batch-axis
    learner over several processes from the global mesh, as the planner
    walks it (``parallel/mesh.py:plan_mesh``): ``rows`` and
    ``data_shards`` are the global ones, and the process holds its even
    share of them, ``ceil(rows / processes)`` rows over ``data_shards /
    processes`` batch shards.

    With ``serving_buckets`` non-empty the prediction is one serving
    engine's (``lightgbm_tpu/obs/memory.py:468-480``, from the port's own
    tables: :func:`serving_terms`), and the training arguments are not
    read (the engine passes ``rows=0``, as the JAX engine does).

    Returns ``residents`` and ``transients`` ({term: bytes}), their sums
    ``resident_bytes`` and ``transient_bytes``, and ``peak_bytes``."""
    if serving_buckets:
        model, batches = serving_terms(
            serving_trees, serving_nodes, serving_cols, serving_bins,
            serving_buckets, serving_classes, serving_cat_rows,
            serving_cat_width, serving_packed, serving_layout)
        return {"inputs": {"serving_trees": int(serving_trees),
                           "serving_nodes": int(serving_nodes),
                           "serving_cols": int(serving_cols),
                           "serving_bins": int(serving_bins),
                           "serving_buckets": list(serving_buckets),
                           "serving_classes": int(serving_classes),
                           "serving_layout": serving_layout},
                "residents": {"serving_model": model},
                "transients": {"serving_batches": batches},
                "resident_bytes": model, "transient_bytes": batches,
                "peak_bytes": model + batches}
    N, F = int(rows), int(features)
    d, fs = max(int(data_shards), 1), max(int(feature_shards), 1)
    dist = d * fs > 1
    if processes > 1:
        N, d = -(-N // int(processes)), max(d // int(processes), 1)
    B, L, K = int(bins), int(leaves), int(num_class)
    bb = int(bin_bytes) if bin_bytes else (1 if B <= 256 else 2)
    E = int(bundled) or F
    C = int(packed_cols)
    Nv = int(valid_rows)
    chunk = min(int(stream_chunk_rows), N) if stream_chunk_rows and not dist \
        else 0
    obj = (objective_bytes if objective_bytes is not None
           else 12 * N)
    r = {t: 0 for t in RESIDENT_TERMS}
    r["Dataset.bins"] = 0 if chunk else N * F * bb
    r["GBDT.packed"] = N * C * bb + 13 * F if C and not chunk else 0
    r["GBDT.scores"] = 4 * K * N
    r["GBDT._score_stash"] = 4 * K * (N + Nv) if rollback else 0
    r["GBDT._ones"] = 4 * N
    # num_bin, missing_type, default_bin i32, is_categorical, the feature
    # mask, and EFB's col and offset i32
    r["GBDT.meta"] = E * (12 + 1 + 1 + (8 if bundled else 0))
    r["Objective"] = int(obj)
    r["_ValidSet.bins"] = Nv * F * bb
    r["_ValidSet.scores"] = 4 * K * Nv
    t: Dict[str, int] = {}
    # the iteration: g and h [K, N], alive through every tree of it; then
    # the larger of the objective's work vectors while it computes them and
    # the tree's end (below), which never overlap
    t["GBDT.train_one_iter gradients"] = 8 * K * N
    work = int(objective_work if objective_work is not None else 12 * N)
    if not dist and not chunk:
        r["WindowBuffers.iota"] = 4 * N
        r["WindowBuffers.bufs"] = 2 * (4 * N + (N * F * bb + 12 * N
                                                if ordered_bins else 0))
        r["WindowBuffers.weights"] = 0 if ordered_bins else 12 * N
        r["WindowBuffers.goes_left"] = N
        r["WindowBuffers.scratch"] = (
            8 * (-(-max(N, 1) // PARTITION_TILE) + 1)
            if compact and cuda else 0)
        # lsc, sc_root, sc_bag, the counters
        r["WindowBuffers.state"] = 16 * (L + 1) + 16 + 24
        r["LeafPool.store"] = pool_bytes(L, F, B, E, categorical)
        # the tree's end (grower._row_leaf_from_intervals): the leaf of
        # each position (int64) and its int32 copy, the order gathered and
        # widened, and the map; the score update's gather of the leaf
        # values after it takes less
        end = ("grow_tree row -> leaf map", 8 * N + 4 * N + 8 * N + 4 * N
               + 4 * N)
    elif chunk:
        blocks = -(-N // chunk)
        r["BlockStreamer.buffers"] = 2 * chunk * F * bb if cuda else 0
        r["StreamedGrower.row_leaf"] = 4 * N
        r["StreamedGrower.counts"] = 4 * blocks * (L + 1)
        r["StreamedGrower.weights"] = 12 * N
        # block_rows, root_id, the counters
        r["StreamedGrower.state"] = 4 * blocks + 4 + 16
        r["LeafPool.store"] = pool_bytes(L, F, B, E, categorical)
        # a block's routed flags and masks in the pass
        t["streamed pass"] = 16 * chunk
        # the score update: the map widened, the leaf values gathered
        end = ("score update", 8 * N + 4 * N)
    else:
        n_loc = -(-N // d)
        pad = n_loc * d - N
        cards, slots, held = _mesh_card(d, fs, slots_per_card)
        h = len(held)
        hist_cols = C or F
        hcols = _slice_sizes(hist_cols, fs)
        rcols = _slice_sizes(F, fs)
        # each slot's column slice of its batch shard: a copy, except a
        # full-width slice (fs == 1) of the matrix on its own card, which
        # is a view of it (of its padded copy when rows were padded)
        if fs > 1:
            r["GspmdGrower.slices"] = sum(n_loc * hcols[j] * bb
                                          for _, j in slots)
        elif pad:
            r["GspmdGrower.slices"] = n_loc * d * hist_cols * bb
        if block_shard_bins:
            # the unpacked slices routing reads beside packed ones
            if C and fs > 1:
                r["GspmdGrower.route_slices"] = sum(n_loc * rcols[j] * bb
                                                    for _, j in slots)
            elif C and pad:
                r["GspmdGrower.route_slices"] = n_loc * d * F * bb
        else:
            r["GspmdGrower.route_bins"] = F * h * n_loc * bb
        r["GspmdGrower.row_leaf"] = 4 * h * n_loc
        r["GspmdGrower.counts"] = 4 * h * (L + 1)
        r["GspmdGrower.weights"] = 12 * h * n_loc
        # root_id, the counters; block-sharded, the route table: each held
        # shard's slice addresses (int64) and the slices' first columns
        r["GspmdGrower.state"] = 4 + 16 + (
            8 * h * fs + 4 * (fs + 1) if block_shard_bins else 0)
        r["LeafPool.store"] = pool_bytes(L, F, B, E, categorical,
                                         slots=d if voting else 0)
        if pad or (C and pad):
            # the padded copies the set-up cuts the slices from
            t["GspmdGrower set-up padding"] = n_loc * d * (F + C) * bb
        if not gspmd_fused:
            # flat: the weights masked to the leaf, and the scatter-add's
            # indices and values over a shard's columns
            t["GspmdGrower flat histogram"] = (
                12 * h * n_loc + n_loc * max(hcols) * (8 + 12))
        # the tree's map gathered onto the primary card, widened, and the
        # leaf values gathered for the score update
        end = ("GspmdGrower row -> leaf map, score update",
               4 * n_loc * d + 8 * N + 4 * N)
    t["Objective work" if work >= end[1] else end[0]] = max(work, end[1])
    t["split step workspace"] = STEP_FIXED_BYTES + STEP_SCAN_BYTES * (
        E * B * (d if voting else 1))
    resident_bytes = sum(r.values())
    # the set-up's peak, before the residents but the bins exist: packing
    # stages the storage matrix in int32 beside the bins and its result,
    # with a column's widened temporaries (data/packing.py:pack_columns)
    setup = (N * F * bb + N * C * bb + 4 * N * C + 16 * N
             if C and not chunk else 0)
    if setup > resident_bytes + sum(t.values()):
        t = {"pack_columns set-up (int32 staging)": setup - resident_bytes}
    counted = resident_bytes + sum(t.values())
    t["allocator slack"] = int(SLACK * counted)
    transient_bytes = sum(t.values())
    return {
        "inputs": {"rows": N, "features": F, "bins": B, "leaves": L,
                   "num_class": K, "bin_bytes": bb, "packed_cols": C,
                   "valid_rows": Nv, "data_shards": d, "feature_shards": fs,
                   "block_shard_bins": bool(block_shard_bins),
                   "stream_chunk_rows": chunk,
                   "slots_per_card": int(slots_per_card),
                   "ordered_bins": bool(ordered_bins), "voting": int(voting),
                   "bundled": int(bundled), "gspmd_fused": bool(gspmd_fused),
                   "categorical": bool(categorical), "compact": bool(compact),
                   "cuda": bool(cuda), "rollback": bool(rollback),
                   "processes": int(processes)},
        "residents": {k: v for k, v in r.items() if v},
        "transients": t,
        "resident_bytes": resident_bytes,
        "transient_bytes": transient_bytes,
        "peak_bytes": resident_bytes + transient_bytes,
    }


def serving_terms(trees: int, nodes: int, cols: int, bins: int,
                  buckets: Sequence[int], classes: int = 1,
                  cat_rows: int = 1, cat_width: int = 1,
                  packed: bool = False, layout: str = "xla"):
    """``(serving_model, serving_batches)`` bytes of one serving engine
    (``inference.py:PredictEngine``): the bundle's tensors
    (``predictor.py:SoABundle``: the float64 threshold table ``[max(Fc,
    1), bins]``, six int32 and two bool ``[T, P]`` node tables, the bool
    ``[C, W]`` category mask, the float64 leaf values ``[T, P + 1]`` and,
    ``packed``, the two int32 node words) and, summed over the ladder,
    each bucket's device buffers (``inference.py:_BucketBuffers``: the
    rows in float64, their int32 ranks and categories, two bool masks and,
    under the ``packed`` layout, the int32 data words, ``[Fc, b]`` each;
    the int32 leaves ``[T, b]`` and float64 scores ``[K, b]``).  Every
    bucket's buffers are allocated at prewarm and kept, so the sum is the
    engine's and not a bound."""
    t, p, fc = int(trees), max(int(nodes), 1), int(cols)
    model = (max(fc, 1) * int(bins) * 8 + t * p * (6 * 4 + 2)
             + int(cat_rows) * int(cat_width) + t * (p + 1) * 8
             + (t * p * 8 if packed else 0))
    per_row = (fc * (8 + 4 + 4 + 1 + 1 + (4 if layout == "packed" else 0))
               + 4 * t + 8 * int(classes))
    return model, sum(int(b) * per_row for b in buckets)


def device_capacity(device=None) -> Optional[int]:
    """A card's total memory in bytes (``torch.cuda.mem_get_info``), or
    None on the CPU, whose memory is not the budgeted resource
    (``lightgbm_tpu/obs/memory.py:503``)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(dev)[1])


def top_terms(pred: Dict[str, Any], k: int = 3) -> Dict[str, int]:
    """The ``k`` largest terms of a prediction, largest first."""
    return dict(sorted({**pred["residents"], **pred["transients"]}.items(),
                       key=lambda kv: -kv[1])[:k])


def preflight(pred: Dict[str, Any], hbm_budget: float = 0.0,
              context: str = "", capacity: Optional[int] = None
              ) -> Dict[str, Any]:
    """Hold a :func:`predict_hbm` prediction to the budget before the
    learner allocates (``lightgbm_tpu/obs/memory.py:511``):
    ``hbm_budget`` > 0 is a hard budget in bytes, and a predicted peak
    over it raises with the largest components; with no budget, a peak
    over the card's ``capacity`` warns.  Returns the verdict."""
    peak = int(pred["peak_bytes"])
    budget = int(hbm_budget) if hbm_budget and hbm_budget > 0 else None
    limit = budget if budget is not None else capacity
    verdict = "ok"
    if limit is not None and peak > limit:
        verdict = "over_budget" if budget is not None else "over_capacity"
    detail = ", ".join(f"{name}={v / 1e9:.2f} GB"
                       for name, v in top_terms(pred).items())
    if verdict == "over_budget":
        log.fatal("predicted peak device memory %.2f GB exceeds hbm_budget "
                  "%.2f GB (%s; top components: %s) — shrink the shape "
                  "(max_bin/num_leaves/rows) or raise hbm_budget",
                  peak / 1e9, limit / 1e9, context or "pre-flight", detail)
    if verdict == "over_capacity":
        log.warning("predicted peak device memory %.2f GB exceeds the "
                    "card's %.2f GB (%s; top components: %s) — an "
                    "out-of-memory error is likely; set hbm_budget to fail "
                    "fast", peak / 1e9, limit / 1e9, context or "pre-flight",
                    detail)
    return {"predicted_peak_bytes": peak, "capacity_bytes": capacity,
            "hbm_budget": budget, "verdict": verdict}


# ---- the census ------------------------------------------------------------


def _tensors(obj, out: list) -> list:
    """Every tensor in ``obj``: a tensor, or tensors inside tuples, lists,
    dicts and NamedTuples, recursively."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    return out


_POOL_ATTRS = ("hist_store", "feat_ok", "sgain", "sf32", "si32", "scat",
               "scatb", "node_f", "node_i", "node_cat", "node_catb", "leaf_f",
               "left_child", "right_child", "leaf_parent", "leaf_depth")


def _named(inner) -> Dict[str, list]:
    """Each resident term's objects on a trained booster's ``GBDT``."""
    g = lambda o, *names: [getattr(o, n, None) for n in names] if o else []
    win, st, gs = inner._windows, inner._streamed, inner._gspmd
    packed = inner.packed
    pool = (win or st or gs).pool if (win or st or gs) else None
    return {
        "Dataset.bins": [inner.bins],
        "GBDT.packed": [] if packed is None else [
            packed.matrix, packed.plan.byte_col, packed.plan.shift,
            packed.plan.is_packed],
        "GBDT.scores": [inner.scores],
        "GBDT._score_stash": [inner._score_stash],
        "GBDT._ones": [inner._ones],
        "GBDT.meta": [inner.meta, inner._feat_valid],
        "Objective": [t for v in vars(inner.objective).values()
                      for t in ([v] if isinstance(v, torch.Tensor) else
                                v.tensors() if isinstance(
                                    v, LambdarankSchedule) else [])],
        "_ValidSet.bins": [vs.bins for vs in inner.valid_sets],
        "_ValidSet.scores": [vs.scores for vs in inner.valid_sets],
        "WindowBuffers.iota": g(win, "iota"),
        "WindowBuffers.bufs": g(win, "bufs"),
        "WindowBuffers.weights": g(win, "weights"),
        "WindowBuffers.goes_left": g(win, "goes_left"),
        "WindowBuffers.scratch": g(win, "scratch"),
        "WindowBuffers.state": g(win, "lsc", "sc_root", "sc_bag",
                                 "counters"),
        "BlockStreamer.buffers": g(inner._streamer, "_dst"),
        "StreamedGrower.row_leaf": g(st, "row_leaf"),
        "StreamedGrower.counts": g(st, "counts"),
        "StreamedGrower.weights": g(st, "weights"),
        "StreamedGrower.state": g(st, "block_rows", "root_id", "counters"),
        "GspmdGrower.route_bins": g(gs, "route_bins"),
        "GspmdGrower.slices": g(gs, "slices"),
        "GspmdGrower.route_slices": g(gs, "route_slices"),
        "GspmdGrower.row_leaf": g(gs, "row_leaf"),
        "GspmdGrower.counts": g(gs, "counts"),
        "GspmdGrower.weights": g(gs, "weights"),
        "GspmdGrower.state": g(gs, "root_id", "counters") + (
            [] if gs is None or gs.block is None else
            [(b.ptrs, b.first) for b in gs.block.values()]),
        "LeafPool.store": g(pool, *_POOL_ATTRS),
    }


def live_census(booster, device=None) -> Dict[str, int]:
    """The bytes of the tensors each resident term of :func:`predict_hbm`
    names, on a trained booster (a ``Booster`` or its ``GBDT``), on its
    primary card (``device``: the training device when None).  A storage
    is counted once, in the first term that reaches it, whatever views of
    it the others hold.  For the tests and ``chip_smoke.py``."""
    inner = getattr(booster, "inner", booster)
    dev = torch.device(device) if device is not None else inner.device
    if inner._gspmd is not None:
        dev = inner._gspmd.device
    seen = set()
    out = {}
    for term, objs in _named(inner).items():
        total = 0
        for t in _tensors(objs, []):
            if t.device != dev:
                continue
            s = t.untyped_storage()
            key = (s.data_ptr(), s.nbytes())
            if key in seen or s.nbytes() == 0:
                continue
            seen.add(key)
            total += s.nbytes()
        if total:
            out[term] = total
    return out


# ---- live accounting --------------------------------------------------------


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The card's allocator statistics under the JAX package's keys
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``,
    ``num_allocs``), or None off a card.  Host reads of the caching
    allocator's counters: nothing waits on the card."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    if dev is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    st = torch.cuda.memory_stats(dev)
    if not st:
        return None
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev).total_memory),
            "num_allocs": int(st.get("allocation.all.current", 0))}


# the boosters (GBDTs) whose residents the CPU census sums, weakly held:
# registered at set-up, gone with their booster
_boosters: List[Any] = []


def register_residents(booster) -> None:
    """Register a booster for the monitor's census (held through a weak
    reference, so it never keeps the booster alive)."""
    _boosters.append(weakref.ref(booster))


def resident_census() -> Dict[str, Any]:
    """:func:`live_census` summed over the registered boosters: total bytes
    and bytes by resident term."""
    live, by_tag = [], {}
    for ref in _boosters:
        booster = ref()
        if booster is None:
            continue
        live.append(ref)
        for tag, b in live_census(booster).items():
            by_tag[tag] = by_tag.get(tag, 0) + b
    _boosters[:] = live
    return {"total_bytes": sum(by_tag.values()), "by_tag": by_tag}


class NullMemoryMonitor:
    """Disarmed monitor: every operation a constant no-op, shared
    process-wide."""
    enabled = False
    source = None

    def sample(self, site: str = "") -> Optional[int]:
        return None

    def annotate(self, span) -> None:
        pass

    def measured_peak(self) -> int:
        return 0

    def baseline(self) -> int:
        return 0

    def top_residents(self, k: int = 6) -> List[Dict[str, Any]]:
        return []

    def summary(self) -> Dict[str, Any]:
        return {}


NULL_MEMORY = NullMemoryMonitor()


class MemoryMonitor:
    """Armed monitor.  ``source`` names the evidence: ``memory_stats`` (the
    card's allocator, which counts the split step's private pool too) or
    ``live_census`` (the CPU: the registered boosters' resident tensors)."""
    enabled = True

    def __init__(self):
        self._peak = 0
        self._flight_mark = 0
        self._last_census: Optional[Dict[str, Any]] = None
        stats = device_memory_stats()
        self.source = "memory_stats" if stats else "live_census"
        self._baseline = (stats["bytes_in_use"] if stats
                          else resident_census()["total_bytes"])
        counters.gauge("memory_baseline_bytes", self._baseline)

    def sample(self, site: str = "") -> Optional[int]:
        """Record the current occupancy; returns the sampled bytes."""
        stats = device_memory_stats() if self.source == "memory_stats" \
            else None
        if stats:
            in_use = stats["bytes_in_use"]
            peak = stats["peak_bytes_in_use"]
        else:
            self._last_census = resident_census()
            in_use = peak = self._last_census["total_bytes"]
        self._peak = max(self._peak, peak)
        counters.gauge("memory_bytes_in_use", in_use)
        counters.gauge("memory_peak_bytes", self._peak)
        if self._peak > self._flight_mark * 1.1:
            # the peak grew more than 10 % past its last streamed mark
            self._flight_mark = self._peak
            from .flight import get_flight
            get_flight().record("hbm_peak", peak_bytes=int(self._peak),
                                site=site, source=self.source)
        return in_use

    def annotate(self, span) -> None:
        """Attach the peak to a recording tracer span (the phase timers'
        hook); a ``NULL_SPAN`` has no ``_args`` and is skipped."""
        args = getattr(span, "_args", None)
        if args is None:
            return
        if self.sample(site="phase") is not None:
            args["peak_bytes"] = int(self._peak)

    def measured_peak(self) -> int:
        return self._peak

    def baseline(self) -> int:
        return self._baseline

    def top_residents(self, k: int = 6) -> List[Dict[str, Any]]:
        """The largest resident terms of the latest census (taken now when
        the monitor reads the allocator)."""
        census = self._last_census or resident_census()
        tags = sorted(census["by_tag"].items(), key=lambda kv: -kv[1])
        return [{"tag": t, "bytes": b} for t, b in tags[:k]]

    def summary(self) -> Dict[str, Any]:
        return {"source": self.source,
                "baseline_bytes": self._baseline,
                "measured_peak_bytes": self._peak,
                "top_residents": self.top_residents()}


_active: Any = NULL_MEMORY


def get_memory():
    """The process-wide active monitor (NULL_MEMORY when disarmed)."""
    return _active


def start() -> MemoryMonitor:
    """Arm a recording monitor as the process-wide active one."""
    global _active
    _active = MemoryMonitor()
    return _active


def stop() -> Dict[str, Any]:
    """Disarm; the final summary goes into the counter registry (one
    ``memory_summary`` event and the ``memory_measured_peak_bytes``
    gauge), so that a trace written afterwards carries it."""
    global _active
    mon, _active = _active, NULL_MEMORY
    if not mon.enabled:
        return {}
    mon.sample(site="final")
    summ = mon.summary()
    counters.gauge("memory_measured_peak_bytes", summ["measured_peak_bytes"])
    counters.event("memory_summary", **{
        k: v for k, v in summ.items() if k != "top_residents"},
        top_residents=[f"{r['tag']}={r['bytes']}"
                       for r in summ["top_residents"]])
    return summ
