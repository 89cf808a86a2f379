"""Leaf-wise tree growing on one device: the serial learner.

The port of ``lightgbm_tpu/grower.py:make_grower`` with ``SerialStrategy``
(the reference's ``SerialTreeLearner::Train``,
``src/treelearner/serial_tree_learner.cpp:152-205``):

* an index array ``order`` keeps every leaf's rows contiguous
  (``data_partition.hpp:94-146``); a split routes only the splitting
  leaf's window and stably partitions it (lefts first), so a split costs
  O(leaf rows).  ``partition_impl`` picks how (``ops/partition.py``):
  ``scatter`` (a cumsum rank and one scatter), ``sort`` (a stable sort on
  the 0/1 key) or ``compact`` (the hand-written kernel).  Partitions are
  out of place: :class:`WindowBuffers` holds two buffers of ``order`` (and
  of the ordered copies below), allocated once per training, and a leaf
  at depth d keeps its window in buffer ``d % 2``; its split writes both
  children into the same positions of the other buffer;
* with ``ordered_bins=on`` a leaf-ordered copy of the bins and of the
  three weight vectors (the reference's ``OrderedBin``) rides along: the
  partition moves their rows with ``order``, the split column is read
  from the ordered window, and a histogram reads a contiguous window
  instead of gathering rows.  Trees are the same either way;
* only the smaller child is histogrammed, by the hand-written gather
  kernel over its window (``ops/histogram.py:hist_window``); the larger
  child is the parent minus it (``serial_tree_learner.cpp:482-488``), and
  every leaf's histogram stays in an ``[L, F, B, 3]`` store of physical
  columns.  With EFB a column is a bundle of features: the scan sees each
  histogram expanded into one per logical feature
  (:func:`expand_bundle_hist`), and routing decodes the bundle's slot.
  With nibble packing the kernel reads the packed storage matrix and its
  histogram is unfolded into physical columns right away
  (``data/packing.py:unfold_packed_hist``), so the store, the parent
  subtraction and the expansion never see a packed column;
* the best split of each leaf waits in a per-leaf pool; the leaf with the
  largest gain splits next.  A categorical split carries the set of bins
  it routes left (``is_cat``/``cat_bins``) in the pool and in the node
  records.

The JAX package grows a tree as one device program: a ``lax.while_loop``
whose ``cond`` stops when no gain is above 0 or ``L - 1`` splits are made,
over fixed-shape device state.  The port keeps that structure: a split is
one **step**, a function of fixed-shape device tensors that reads the
chosen leaf, its window, its depth parity and the step counter from device
memory and holds no shape that depends on a window.  The stop is an
``active`` flag on the device; once it is down, every later step writes
only to the sink rows of the pool (row ``L`` of each leaf tensor, row
``L - 1`` of each node tensor) and moves no row.  So the host need not
know when the tree stopped:

* on a card with ``partition_impl=compact`` the step is captured once per
  training as a CUDA graph and replayed; the host reads the counters back
  once every ``STOP_CHECK_STEPS`` steps, to stop replaying early;
* elsewhere (the CPU; ``scatter`` or ``sort`` on a card) the same step
  runs eagerly.  The PyTorch partitions slice the window on the host, so
  there the step makes one host read a split, which also carries the stop.

All per-tree state (the histogram store, the split pool, the node records
and the topology) is a :class:`LeafPool` of device tensors.  The loop
itself (the leaf choice and the stop flag, the capture, the replays and
the counter reads) is a :class:`SplitLoop`, which the data-parallel
learner (``parallel/gspmd.py``) and the streamed grower
(:class:`StreamedGrower`, ``data_stream=chunked``: the bin matrix stays
on the host and every split streams it through the card) share with
their own steps.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, NamedTuple, Optional

import torch

from .data.packing import PackedBins
from .ops.histogram import (hist_local, hist_window, maybe_hist_fault,
                            movable, plan_device, sm_count)
from .ops.partition import (partition_scratch, partition_window,
                            partition_window_plain, partition_window_sort)
from .ops.route import route_rows, route_window
from .ops.split import (SplitConfig, SplitResult, best_split,
                        cat_group_accept, leaf_output, make_fused_ctx)

# steps the split loop takes between two reads of the stop flag: at most
# ceil((L - 1) / 32) reads a tree, 8 at 255 leaves
STOP_CHECK_STEPS = 32


class GrowerConfig(NamedTuple):
    """Training params of one tree."""
    num_leaves: int = 31
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    max_bin: int = 256          # B: histogram width (max over features)
    has_missing: bool = True    # False skips the dir=+1 scan
    has_categorical: bool = False   # False skips the categorical scan
    max_cat_threshold: int = 256
    max_cat_group: int = 64
    cat_smooth_ratio: float = 0.01
    min_cat_smooth: float = 5.0
    max_cat_smooth: float = 100.0
    partition_impl: str = "scatter"   # scatter | sort | compact (kernel)
    ordered_bins: str = "off"         # on: leaf-ordered bins and weights

    def split_config(self) -> SplitConfig:
        return SplitConfig(self.lambda_l1, self.lambda_l2,
                           self.min_gain_to_split, self.min_data_in_leaf,
                           self.min_sum_hessian_in_leaf, self.has_missing,
                           self.has_categorical, self.max_cat_threshold,
                           self.max_cat_group, self.cat_smooth_ratio,
                           self.min_cat_smooth, self.max_cat_smooth)


class TreeArrays(NamedTuple):
    """SoA tree; mirrors the reference Tree fields (tree.h:316-370) and the
    JAX package's ``grower.TreeArrays`` field by field."""
    num_leaves: int               # leaves grown
    split_feature: torch.Tensor   # [L-1] i32 column index
    threshold_bin: torch.Tensor   # [L-1] i32
    default_left: torch.Tensor    # [L-1] bool
    left_child: torch.Tensor      # [L-1] i32 (node index, or ~leaf if < 0)
    right_child: torch.Tensor     # [L-1] i32
    split_gain: torch.Tensor      # [L-1] f32
    internal_value: torch.Tensor  # [L-1] f32
    internal_count: torch.Tensor  # [L-1] f32
    leaf_value: torch.Tensor      # [L] f32 (unshrunk)
    leaf_count: torch.Tensor      # [L] f32
    leaf_parent: torch.Tensor     # [L] i32
    leaf_depth: torch.Tensor      # [L] i32
    is_cat: torch.Tensor          # [L-1] bool: categorical decision node
    cat_bins: torch.Tensor        # [L-1, B] bool: bins routed left


class FeatureMeta(NamedTuple):
    """Per-logical-feature metadata as device tensors
    (``lightgbm_tpu/grower.py:123-128``).  With EFB several logical
    features share one physical column: ``col`` and ``offset`` are the
    decode maps (both None when columns and features are 1:1)."""
    num_bin: torch.Tensor       # [E] i32
    missing_type: torch.Tensor  # [E] i32 (0 none / 1 zero / 2 nan)
    default_bin: torch.Tensor   # [E] i32
    is_categorical: Optional[torch.Tensor] = None   # [E] bool
    col: Optional[torch.Tensor] = None      # [E] i32 physical column
    offset: Optional[torch.Tensor] = None   # [E] i32 first slot (-1: alone)


class ExpandMaps(NamedTuple):
    """Gather and reconstruction maps from physical (bundle) histograms
    to logical ones, made once a training (:func:`make_expand_maps`)."""
    src: torch.Tensor        # [E, B] i64: flat physical bin of each bin
    valid: torch.Tensor      # [E, B] bool: a bin of the feature
    recon: torch.Tensor      # [E, B] bool: the default bin, rebuilt


def make_expand_maps(meta: FeatureMeta, num_bins: int) -> ExpandMaps:
    """The maps that expand physical histograms ``[Fp, B, 3]`` into
    per-logical-feature ones (``lightgbm_tpu/grower.py:310-349``, the
    reference's ``FixHistogram`` in tensor form), as tensors on the
    meta's device.  Both learners expand the whole histogram: the
    data-parallel one after its shard sum and column concatenation."""
    dev = meta.num_bin.device
    b = torch.arange(num_bins, dtype=torch.int64, device=dev)[None, :]
    off, nb, db, c = (t.long()[:, None] for t in (
        meta.offset, meta.num_bin, meta.default_bin, meta.col))
    slot = off + b - (b > db).long()
    src = torch.where(off < 0, c * num_bins + b,
                      c * num_bins + slot.clamp(0, num_bins - 1))
    valid = b < nb
    recon = (off >= 0) & (b == db) & valid
    return ExpandMaps(src, valid, recon)


def expand_bundle_hist(hist: torch.Tensor, pg: torch.Tensor,
                       ph: torch.Tensor, pc: torch.Tensor,
                       maps: ExpandMaps) -> torch.Tensor:
    """``[K, Fp, B, 3]`` physical histograms of K leaves with sums ``pg``,
    ``ph``, ``pc`` ``[K]`` -> ``[K, E, B, 3]`` logical ones
    (``lightgbm_tpu/grower.py:351-367``): each bundled feature's slots
    gathered into its own bins, its default bin rebuilt as the leaf's sum
    minus the sum of its slots.  The JAX package takes that sum as a
    difference of two prefix sums over the whole flat histogram; here it
    is the sum of the gathered slots, as the reference's FixHistogram
    adds them (the same rows; under integer weights the same value)."""
    k, s = hist.shape[0], hist.shape[-1]
    e, b = maps.src.shape
    flat = hist.reshape(k, -1, s)                           # [K, Fp*B, 3]
    out = flat.index_select(1, maps.src.reshape(-1)).view(k, e, b, s)
    out = torch.where(maps.valid[None, :, :, None], out, 0.0)
    recon = maps.recon[None, :, :, None]
    slots = torch.where(recon, 0.0, out).sum(dim=2)         # [K, E, 3]
    parent = torch.stack([pg, ph, pc], dim=-1).to(flat.dtype)   # [K, 3]
    return torch.where(recon, (parent[:, None, :] - slots)[:, :, None, :],
                       out)


def resolve_partition_impl(requested: str, device) -> str:
    """``partition_impl`` as the serial grower runs it: ``auto`` is the
    partition kernel (``compact``) on a card, where the grower replays its
    split step as a CUDA graph, and ``scatter`` on the CPU, as
    ``gspmd_hist=auto`` picks by the device.  The partition is stable, so
    the trees are the same either way."""
    if requested != "auto":
        return requested
    return "compact" if torch.device(device).type == "cuda" else "scatter"


def _depth_gate(res: SplitResult, depth: torch.Tensor,
                max_depth: int) -> SplitResult:
    """A leaf at depth d (root = 0) may split iff d < max_depth
    (serial_tree_learner.cpp:326+); ``depth`` holds each leaf's depth on
    the device."""
    if max_depth <= 0:
        return res
    deep = depth >= max_depth
    return res._replace(found=res.found & ~deep,
                        gain=torch.where(deep, float("-inf"), res.gain))


def pool_rows(res: SplitResult):
    """SplitResult -> split-pool rows ``[K, 8]`` f32 and ``[K, 3]`` i32."""
    f32 = torch.stack([res.left_sum_g, res.left_sum_h, res.left_count,
                       res.right_sum_g, res.right_sum_h, res.right_count,
                       res.left_output, res.right_output], dim=1)
    i32 = torch.stack([res.feature, res.threshold,
                       res.default_left.long()], dim=1).int()
    return f32, i32


def _row_leaf_from_intervals(orders, leaf_start: torch.Tensor,
                             leaf_cnt: torch.Tensor, leaf_odd: torch.Tensor,
                             n: int, m: int) -> torch.Tensor:
    """row -> leaf map ``[n]`` from the final leaf intervals: the
    intervals partition positions [0, m) (``m`` the root window's rows,
    ``n`` unless the tree grew on a bag), so the leaf of each position is
    its interval's, pushed through the ``order`` buffer of that leaf's
    depth parity (``orders[0]`` for even depths, ``orders[1]`` for odd,
    ``leaf_odd`` per leaf).  Rows outside the root window get -1."""
    by_start = torch.argsort(leaf_start, stable=True)
    leaf_of_pos = torch.repeat_interleave(by_start, leaf_cnt[by_start],
                                          output_size=m)
    order = torch.where(leaf_odd[leaf_of_pos], orders[1][:m], orders[0][:m])
    dev = order.device
    out = (torch.empty(n, dtype=torch.int32, device=dev) if m == n
           else torch.full((n,), -1, dtype=torch.int32, device=dev))
    return out.scatter_(0, order.long(), leaf_of_pos.int())


def _tensor_key(*tensors):
    """What a captured step holds of these tensors: address, shape, type."""
    return tuple(None if t is None else (t.data_ptr(), tuple(t.shape),
                                         t.dtype) for t in tensors)


class LeafPool:
    """The per-tree bookkeeping both growers share, as device tensors
    allocated once and reset per tree (:meth:`reset`): every leaf's
    histogram (an ``[L + 1, F, B, 3]`` store), the best split of each leaf
    waiting in a pool, the node and leaf records, and the topology
    (children, parents and depths, int32).  Leaf row ``L`` and node row
    ``L - 1`` are sinks: a step taken after the tree stopped writes there,
    and no read of a live step does.

    The methods take leaves and nodes as device ``int64[1]`` tensors.
    :meth:`record` writes the node (``Tree::Split``, tree.h:319-345);
    :meth:`children` turns the smaller child's histogram into both
    children's (the larger is the parent minus it,
    serial_tree_learner.cpp:482-488) and scans them for their best splits
    in one batched scan."""

    def __init__(self, cfg: GrowerConfig, n_feat: int, device,
                 dtype: torch.dtype = torch.float32,
                 n_logical: Optional[int] = None,
                 slots: Optional[int] = None):
        # histograms of n_feat physical columns, or with ``slots`` each
        # leaf's histograms of that many row shards (the voting learner's
        # local store, parallel/learner.py); the scan's flags and the
        # feature mask over n_logical features (n_feat unless bundled)
        L, B = cfg.num_leaves, cfg.max_bin
        f = n_feat if n_logical is None else n_logical
        self.cfg, self.f = cfg, f
        self.scfg = cfg.split_config()
        self.has_cat = cfg.has_categorical

        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        self.hist_store = z(L + 1, *(() if slots is None else (slots,)),
                            n_feat, B, 3)
        self.feat_ok = z(L + 1, f, dt=torch.bool)
        self.sgain = z(L + 1)
        self.sf32 = z(L + 1, 8)
        self.si32 = z(L + 1, 3, dt=torch.int32)
        # the pool's categorical half: is_cat, bins-left
        self.scat = z(L + 1, dt=torch.bool) if self.has_cat else None
        self.scatb = z(L + 1, B, dt=torch.bool) if self.has_cat else None
        self.node_f = z(L, 3)
        self.node_i = z(L, 3, dt=torch.int32)
        self.node_cat = z(L, dt=torch.bool)
        self.node_catb = z(L, B, dt=torch.bool)
        self.leaf_f = z(L + 1, 2)
        self.left_child = z(L, dt=torch.int32)
        self.right_child = z(L, dt=torch.int32)
        self.leaf_parent = z(L + 1, dt=torch.int32)
        self.leaf_depth = z(L + 1, dt=torch.int32)
        self.ctx = self.meta_key = self.feat_valid = self.maps = None

    def reset(self, meta: FeatureMeta, feat_valid: torch.Tensor,
              hist_root: torch.Tensor, root_g: torch.Tensor,
              root_h: torch.Tensor, root_c: torch.Tensor) -> None:
        """Start a tree: the root's histogram, sums and best split in row
        0, every other record cleared.  The scan's masks (and, bundled,
        the expansion's maps) are rebuilt only when ``meta`` holds other
        tensors than the last tree's."""
        key = _tensor_key(*meta)
        if key != self.meta_key:
            self.ctx = make_fused_ctx(meta.num_bin, meta.missing_type,
                                      meta.default_bin, self.cfg.max_bin,
                                      self.scfg, meta.is_categorical)
            self.maps = (None if meta.col is None
                         else make_expand_maps(meta, self.cfg.max_bin))
            self.meta_key = key
        self.feat_valid = feat_valid
        res, fok = self.find(hist_root[None], root_g.reshape(1),
                             root_h.reshape(1), root_c.reshape(1),
                             feat_valid[None])
        self.hist_store[0] = hist_root
        self.feat_ok[0] = fok[0]
        self.sgain.fill_(float("-inf"))
        self.sgain[:1] = res.gain
        for t in (self.sf32, self.si32, self.node_f, self.node_i,
                  self.node_cat, self.node_catb, self.leaf_f,
                  self.left_child, self.right_child, self.leaf_depth):
            t.zero_()
        self.sf32[:1], self.si32[:1] = pool_rows(res)
        if self.has_cat:
            self.scat.zero_()
            self.scatb.zero_()
            self.scat[:1], self.scatb[:1] = res.is_cat, res.cat_bins
        self.leaf_f[0, 1] = root_c
        self.leaf_parent.fill_(-1)

    def scan_hist(self, hist: torch.Tensor, pg: torch.Tensor,
                  ph: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
        """The histograms ``[K, Fp, B, 3]`` as the split scan reads them:
        expanded into logical features when bundled."""
        if self.maps is None:
            return hist
        return expand_bundle_hist(hist, pg, ph, pc, self.maps)

    def find(self, hist: torch.Tensor, pg: torch.Tensor, ph: torch.Tensor,
             pc: torch.Tensor, feat_valid: torch.Tensor):
        """The best splits of K leaves from their stored histograms
        ``[K, ...]``, sums ``[K]`` and feature masks ``[K, F]``: returns
        ``(SplitResult, feat_ok [K, F])``.  Here one batched scan; the
        voting learner votes first (``parallel/learner.py``)."""
        return best_split(self.scan_hist(hist, pg, ph, pc), pg, ph, pc,
                          feat_valid, self.scfg, self.ctx)

    def split_args(self, l: torch.Tensor):
        """The pooled split of leaf ``l``: its int and float rows, and
        ``(feat, thr, dleft, is_cat_l, cat_row)`` for routing."""
        irow = self.si32.index_select(0, l)[0]
        frow = self.sf32.index_select(0, l)[0]
        route = (irow[0:1].long(), irow[1:2].long(), irow[2:3].bool(),
                 self.scat.index_select(0, l) if self.has_cat else None,
                 self.scatb.index_select(0, l)[0] if self.has_cat else None)
        return irow, frow, route

    def record(self, l: torch.Tensor, new: torch.Tensor, node: torch.Tensor,
               irow: torch.Tensor, frow: torch.Tensor, is_cat_l,
               cat_row) -> torch.Tensor:
        """Write node ``node`` splitting leaf ``l`` into (``l``, ``new``);
        returns the children's depth, an int32[1]."""
        sink = self.cfg.num_leaves - 1
        # the parent's child pointer to l now points to node; the root's
        # split has no parent and writes the sink node
        parent = self.leaf_parent.index_select(0, l)
        pidx = torch.where(parent >= 0, parent.long(), sink)
        lc = self.left_child.index_select(0, pidx)
        rc = self.right_child.index_select(0, pidx)
        node32, was_l = node.int(), (~l).int()
        was_left = lc == was_l
        self.left_child.index_copy_(0, pidx, torch.where(was_left, node32, lc))
        self.right_child.index_copy_(0, pidx,
                                     torch.where(was_left, rc, node32))
        self.left_child.index_copy_(0, node, was_l)
        self.right_child.index_copy_(0, node, (~new).int())
        pair = torch.cat([l, new])
        child_depth = self.leaf_depth.index_select(0, l) + 1
        self.leaf_parent.index_copy_(0, pair, node32.expand(2))
        self.leaf_depth.index_copy_(0, pair, child_depth.expand(2))
        self.node_i.index_copy_(0, node, irow.view(1, 3))
        self.node_f.index_copy_(0, node, torch.cat([
            self.sgain.index_select(0, l),
            leaf_output(frow[0:1] + frow[3:4], frow[1:2] + frow[4:5],
                        self.cfg.lambda_l1, self.cfg.lambda_l2),
            self.leaf_f.index_select(0, l)[:, 1]]).view(1, 3))
        if self.has_cat:
            self.node_cat.index_copy_(0, node, is_cat_l)
            self.node_catb.index_copy_(0, node, cat_row.view(1, -1))
        self.leaf_f.index_copy_(0, pair, torch.stack(
            [frow[6], frow[2], frow[7], frow[5]]).view(2, 2))
        return child_depth

    def children(self, l: torch.Tensor, new: torch.Tensor,
                 frow: torch.Tensor, small_left: torch.Tensor,
                 hist_small: torch.Tensor, child_depth: torch.Tensor) -> None:
        """Both children's histograms and best splits into the pool."""
        hist_large = self.hist_store.index_select(0, l)[0] - hist_small
        hist2 = torch.stack([hist_small, hist_large])
        # the (smaller, larger) pair's leaf ids
        pair = torch.cat([torch.where(small_left, l, new),
                          torch.where(small_left, new, l)])
        self.hist_store.index_copy_(0, pair, hist2)

        # both children scan the features the PARENT found splittable
        # (serial_tree_learner.cpp:406-417), in one batched scan
        fok_parent = self.feat_ok.index_select(0, l)
        lr3 = frow[:6].view(2, 3)
        sl3 = torch.where(small_left, lr3, lr3.flip(0))
        res2, fok2 = self.find(hist2, sl3[:, 0], sl3[:, 1], sl3[:, 2],
                               (self.feat_valid & fok_parent).expand(
                                   2, self.f))
        res2 = _depth_gate(res2, child_depth.expand(2), self.cfg.max_depth)
        self.feat_ok.index_copy_(0, pair, fok2 & fok_parent)
        self.sgain.index_copy_(0, pair, res2.gain)
        f32, i32 = pool_rows(res2)
        self.sf32.index_copy_(0, pair, f32)
        self.si32.index_copy_(0, pair, i32)
        if self.has_cat:
            self.scat.index_copy_(0, pair, res2.is_cat)
            self.scatb.index_copy_(0, pair, res2.cat_bins)

    def tree(self, splits: int) -> TreeArrays:
        """The records of a tree of ``splits`` splits as
        :class:`TreeArrays`, copied out of the pool (which the next tree
        reuses), sink rows left out."""
        L = self.cfg.num_leaves
        node_i, node_f, leaf_f = (self.node_i[:L - 1], self.node_f[:L - 1],
                                  self.leaf_f[:L])
        return TreeArrays(
            num_leaves=splits + 1,
            split_feature=node_i[:, 0].clone(),
            threshold_bin=node_i[:, 1].clone(),
            default_left=node_i[:, 2].bool(),
            left_child=self.left_child[:L - 1].clone(),
            right_child=self.right_child[:L - 1].clone(),
            split_gain=node_f[:, 0].clone(),
            internal_value=node_f[:, 1].clone(),
            internal_count=node_f[:, 2].clone(),
            leaf_value=leaf_f[:, 0].clone(),
            leaf_count=leaf_f[:, 1].clone(),
            leaf_parent=self.leaf_parent[:L].clone(),
            leaf_depth=self.leaf_depth[:L].clone(),
            is_cat=self.node_cat[:L - 1].clone(),
            cat_bins=self.node_catb[:L - 1].clone())


class SplitLoop:
    """What both growers' split loops share: the step counter and the
    ``active`` flag in device memory (``counters[0]`` and ``[1]``, after
    which a grower may keep its own), the choice of the leaf that splits
    (:meth:`pick`), and the loop that takes the steps: eagerly, or captured
    once as a CUDA graph and replayed, the counters read back every
    ``STOP_CHECK_STEPS`` steps (:meth:`run_steps`).  A subclass supplies
    :meth:`step` and ``wrappers``, the kernel wrappers its step reaches."""

    wrappers: tuple = ()

    def __init__(self, cfg: GrowerConfig, device: torch.device,
                 n_counters: int):
        cuda = device.type == "cuda"
        self.cfg, self.device = cfg, device
        self.counters = torch.zeros(n_counters, dtype=torch.int64,
                                    device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # each wrapper's count at the capture, which launches nothing: the
        # captured step's launches, which every replay makes
        self.graph_launches: Dict[str, int] = {}
        self.replays = self.captures = 0
        self.host = (torch.empty(n_counters, dtype=torch.int64,
                                 pin_memory=True) if cuda else None)
        self.event = torch.cuda.Event() if cuda else None

    def choose_loop(self, loop: Optional[str], can_graph: bool,
                    why: str) -> str:
        """The loop a tree takes: ``graph`` where ``can_graph`` (``why``
        says where that is) or ``eager``; None takes the graph where it
        can, and ``graph`` where it cannot raises."""
        if loop is None:
            return "graph" if can_graph else "eager"
        if loop not in ("graph", "eager") or (loop == "graph"
                                              and not can_graph):
            raise ValueError(f"loop={loop!r}; the graph loop runs {why}, "
                             f"the eager loop everywhere")
        return loop

    def start_counters(self) -> None:
        """A tree's counters: no split made, ``active`` up.  ``fill_``,
        not item assignment: assigning a Python number copies it from the
        host."""
        self.counters.zero_()
        self.counters[1].fill_(1)

    def pick(self, pool: LeafPool):
        """The step's leaf choice, from device memory: the leaf with the
        largest gain splits while ``active`` holds; the step that finds no
        gain above 0, or ``L - 1`` splits made, lowers ``active``, and from
        then on the leaf is the sink ``L``, the new leaf ``L`` and the node
        ``L - 1``.  Returns ``(act, leaf, new, node)``, each ``[1]`` on the
        device; ``act`` is what :meth:`end_step` adds to the splits."""
        L = self.cfg.num_leaves
        i = self.counters[0:1]
        best = torch.argmax(pool.sgain[:L]).view(1)
        act = ((self.counters[1:2] > 0)
               & (pool.sgain.index_select(0, best) > 0) & (i < L - 1))
        self.counters[1:2] = act
        return (act, torch.where(act, best, L), torch.where(act, i + 1, L),
                torch.where(act, i, L - 1))

    def end_step(self, act: torch.Tensor) -> None:
        self.counters[0:1] += act

    def step(self) -> bool:
        raise NotImplementedError

    def launch_counts(self) -> Dict[str, int]:
        """Every kernel wrapper's launch count that the step reaches."""
        return {f.__name__: f.launches for f in self.wrappers}

    def capture(self) -> None:
        """The graph loop's first step: the step eagerly on a side stream
        (the warm-up that capture asks for, which builds and sets up every
        kernel, and a real step of the tree), then the step captured once.
        A capture launches nothing, though each wrapper counts it:
        ``graph_launches`` keeps those counts, the launches of every
        replay."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step()
        cur.wait_stream(side)
        before = self.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step()
        self.graph_launches = {k: v - before[k]
                               for k, v in self.launch_counts().items()}
        self.graph = graph
        self.captures += 1

    def replay(self) -> None:
        """One step of the graph loop.  The ``hist_fail`` fault point is
        checked at the start of each replayed step: the wrappers' own check
        runs only where their Python does, at the warm-up and the capture
        (``ops.histogram.maybe_hist_fault``)."""
        if self.graph is None:
            self.capture()
            return
        maybe_hist_fault("replayed split step")
        self.graph.replay()
        self.replays += 1

    def read_counters(self):
        """The loop's read of the counters. On a card through pinned
        memory and an event: the one wait on the device, which
        ``torch.cuda.set_sync_debug_mode`` does not flag, so a run under
        ``"error"`` finds any other read."""
        if self.host is None:
            return self.counters.tolist()
        self.host.copy_(self.counters, non_blocking=True)
        self.event.record()
        self.event.synchronize()
        return self.host.tolist()

    def run_steps(self, loop: str):
        """Take a tree's steps, ``STOP_CHECK_STEPS`` between two reads of
        the counters, until ``active`` is down or ``L - 1`` steps are
        taken; returns (the last counters read, steps taken, host
        reads)."""
        L = self.cfg.num_leaves
        step = self.replay if loop == "graph" else self.step
        done = reads = 0
        while done < L - 1:
            k = min(STOP_CHECK_STEPS, L - 1 - done)
            for _ in range(k):
                step()
            done += k
            counters = self.read_counters()
            reads += 1
            if not counters[1]:
                break
        return counters, done, reads


class WindowBuffers(SplitLoop):
    """The serial grower's device state that lives across trees, allocated
    once per training for ``rows`` x ``n_feat`` bins, ``cfg`` and
    ``device``:

    * two buffers of every matrix that the partition moves: ``order`` and,
      with ``ordered_bins=on``, the leaf-ordered bins and weights.  A leaf
      at depth d keeps its window in ``bufs[d % 2]``;
    * the partition kernel's scratch (``compact`` on a card);
    * the split step's state: the ``goes_left`` mask, every leaf's window
      ``lsc`` (start, cnt), the counters (splits made, the active flag,
      positions partitioned), the :class:`LeafPool` and copies of the
      weights that the histogram reads;
    * on a card with ``compact``, the split step captured as a CUDA graph
      at the first split of the first tree (:meth:`capture`); the graph
      holds the addresses of all of the above, and of the bins, metadata
      and feature mask it was captured on.

    ``n_logical`` is the features the scan sees (``n_feat`` unless EFB
    bundled); ``packed`` the nibble-packed storage matrix of the ``rows``
    x ``n_feat`` bins with its plan (:class:`~.data.packing.PackedBins`),
    which the histogram then reads instead of the bins (not with
    ``ordered_bins=on``); ``bin_dtype`` the bins' type (uint8, or uint16
    past 256 bins a column), which the ordered copies keep: their rows
    are ``2 * n_feat + 12`` bytes of payload under uint16.

    :meth:`start` starts a tree and :meth:`run` takes its steps."""

    wrappers = (hist_window, partition_window, route_window,
                cat_group_accept)

    def __init__(self, rows: int, n_feat: int, cfg: GrowerConfig, device,
                 n_logical: Optional[int] = None,
                 packed: Optional[PackedBins] = None,
                 bin_dtype: torch.dtype = torch.uint8):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        cuda = dev.type == "cuda"
        # counters: splits made, the active flag, positions partitioned
        super().__init__(cfg, dev, 3)
        self.rows, self.n_feat = rows, n_feat
        self.ordered = cfg.ordered_bins == "on"
        if packed is not None and (
                self.ordered or packed.plan.num_phys_cols != n_feat
                or packed.matrix.shape[0] != rows):
            raise ValueError("WindowBuffers: packed bins of rows x n_feat "
                             "columns, and not with ordered_bins=on")
        self.packed, self.bin_dtype = packed, bin_dtype
        # the matrix the histogram reads: its columns and width
        self.hist_cols = (n_feat if packed is None
                          else packed.plan.num_storage_cols)
        self.hist_width = (cfg.max_bin if packed is None
                           else packed.hist_width(cfg.max_bin))
        # the PyTorch partitions slice the window on the host
        self.read_window = cfg.partition_impl in ("scatter", "sort")
        self.iota = torch.arange(rows, dtype=torch.int32, device=dev)

        def one():
            if not self.ordered:
                return (torch.empty_like(self.iota),)
            return (torch.empty_like(self.iota),
                    torch.empty((rows, n_feat), dtype=bin_dtype,
                                device=dev),
                    *[torch.empty(rows, dtype=torch.float32, device=dev)
                      for _ in range(3)])

        self.bufs = (one(), one())
        self.scratch = (partition_scratch(rows, dev)
                        if cfg.partition_impl == "compact" and cuda else None)
        L = cfg.num_leaves
        self.goes_left = torch.zeros(rows, dtype=torch.bool, device=dev)
        self.lsc = torch.zeros((L + 1, 2), dtype=torch.int64, device=dev)
        self.sc_root = torch.tensor([0, rows], dtype=torch.int32, device=dev)
        self.sc_bag = torch.zeros(2, dtype=torch.int32, device=dev)
        self.pool = LeafPool(cfg, n_feat, dev, n_logical=n_logical)
        self.weights = None if self.ordered else tuple(
            torch.empty(rows, dtype=torch.float32, device=dev)
            for _ in range(3))
        self.hist_plan = (plan_device(rows, self.hist_cols, self.hist_width,
                                      num_sms=sm_count(dev.index),
                                      bin_bytes=bin_dtype.itemsize)
                          if cuda else None)
        self.bins = self.hist_bins = self.meta = self.bound = None
        self.route_bins = self.route_order = None
        self.reads = self.host_positions = 0

    def fits(self, rows: int, n_feat: int, cfg: GrowerConfig, device,
             n_logical: int, bin_dtype: torch.dtype = torch.uint8) -> bool:
        """Whether this state serves a tree of these shapes and ``cfg``."""
        return (rows == self.rows and n_feat == self.n_feat
                and cfg == self.cfg and n_logical == self.pool.f
                and bin_dtype == self.bin_dtype
                and self.bufs[0][0].device == torch.device(device))

    def histogram(self, *args, **kwargs) -> torch.Tensor:
        """``hist_window`` over the matrix the histogram reads, unfolded
        into physical columns when it is the packed storage matrix."""
        hist = hist_window(*args, **kwargs)
        if self.packed is None:
            return hist
        return self.packed.unfold(hist, self.cfg.max_bin)

    def loop(self, loop: Optional[str]) -> str:
        """The split loop a tree takes: ``graph`` (replay the captured
        step; a card with ``compact``) or ``eager``; None takes the graph
        where it can."""
        return self.choose_loop(
            loop, self.device.type == "cuda"
            and self.cfg.partition_impl == "compact",
            "on a card with partition_impl=compact")

    def start(self, bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
              cw: torch.Tensor, meta: FeatureMeta, feat_valid: torch.Tensor,
              rows: Optional[torch.Tensor] = None) -> int:
        """Start a tree: the root's window in buffer 0, the weights copied
        where the step reads them, the counters and windows cleared, and
        the pool reset with the root's histogram.  The root window holds
        every row in natural order (so the ordered copies are the inputs),
        or only ``rows`` (sorted int32 row ids: a bag), whose bins and
        weights are then gathered into the ordered copies' first ``m``
        positions.  Nothing in the captured step depends on the window's
        size, so a bag of any size replays the same graph.  The feature
        mask is read where it lies at every step: a new mask is copied
        into the captured tensor, never passed as another.  Returns ``m``,
        the root window's rows."""
        key = _tensor_key(bins, *meta, feat_valid)
        if self.graph is not None and key != self.bound:
            raise ValueError("grow_tree: the split step was captured on "
                             "other bins, metadata or feature mask")
        self.bound, self.bins, self.meta = key, bins, meta
        self.hist_bins = (bins if self.packed is None
                          else self.packed.matrix)
        if self.ordered:
            self.route_bins, self.route_order = (
                (self.bufs[0][1], self.bufs[1][1]), (None, None))
        else:
            self.route_bins, self.route_order = (
                (bins, bins), (self.bufs[0][0], self.bufs[1][0]))
        b0 = self.bufs[0]
        m = self.rows if rows is None else rows.numel()
        if rows is None:
            b0[0].copy_(self.iota)
        else:
            b0[0][:m].copy_(rows)
        if self.ordered:
            if rows is None:
                for dst, src in zip(b0[1:], (bins, gw, hw, cw)):
                    dst.copy_(src)
            else:
                idx = rows.long()
                for dst, src in zip(b0[1:], (bins, gw, hw, cw)):
                    torch.index_select(movable(src), 0, idx,
                                       out=movable(dst)[:m])
        else:
            for dst, src in zip(self.weights, (gw, hw, cw)):
                dst.copy_(src)
        # fill_, not item assignment: assigning a Python number copies it
        # from the host
        self.lsc.zero_()
        self.lsc[0, 1].fill_(m)
        self.start_counters()
        if rows is None:
            hist_root = self.histogram(self.iota, self.sc_root,
                                       self.hist_bins, gw, hw, cw,
                                       self.hist_width,
                                       rows_upper_bound=self.rows)
        else:   # the bag's window, through the kernel like any window
            self.sc_bag[1].fill_(m)
            src = ((self.iota, *b0[1:]) if self.ordered
                   else (b0[0], self.hist_bins, gw, hw, cw))
            hist_root = self.histogram(src[0], self.sc_bag, *src[1:],
                                       self.hist_width, rows_upper_bound=m)
        self.pool.reset(meta, feat_valid, hist_root, gw.sum(), hw.sum(),
                        cw.sum())
        return m

    def step(self) -> bool:
        """One split: the body of ``make_grower``'s loop
        (``lightgbm_tpu/grower.py:986``) over fixed-shape device tensors.
        The leaf with the largest gain splits while ``active`` holds; the
        step that finds no gain above 0, or ``L - 1`` splits made, lowers
        ``active``, and from then on every write goes to the sink rows and
        the window is empty.  Returns False only where the step reads its
        window to the host (``scatter``, ``sort``) and finds the tree
        stopped; it then returns before changing anything else."""
        cfg, pool, meta = self.cfg, self.pool, self.meta
        B = self.hist_width
        act, l, new, node = self.pick(pool)
        sc = self.lsc.index_select(0, l)[0] * act    # (start, cnt)
        odd = pool.leaf_depth.index_select(0, l) & 1  # its buffer
        bound = None
        if self.read_window:
            start, cnt, par, live = torch.cat([
                sc, odd.long(), act.long()]).tolist()
            self.reads += 1
            if not live:
                return False
            self.host_positions += cnt
            bound = cnt

        # --- route the leaf's window and partition it stably -------------
        route_window(sc, odd, l, pool.si32, pool.scat, pool.scatb, meta,
                     self.route_bins, self.route_order, self.goes_left)
        if self.read_window:
            part = (partition_window_sort if cfg.partition_impl == "sort"
                    else partition_window_plain)
            nl = part(self.bufs[par], self.bufs[1 - par], start, cnt,
                      self.goes_left)
        else:   # the kernel reads the window and its buffer on the device
            nl = partition_window(self.bufs[0], self.bufs[1], sc,
                                  self.goes_left, self.rows, self.scratch,
                                  odd)
        start_t, cnt_t, nl = sc[0:1], sc[1:2], nl.long()
        nr = cnt_t - nl
        self.counters[2:3] += cnt_t
        self.lsc.index_copy_(0, torch.cat([l, new]), torch.stack([
            torch.cat([start_t, nl]), torch.cat([start_t + nl, nr])]))
        irow, frow, route = pool.split_args(l)
        child_depth = pool.record(l, new, node, irow, frow, route[3],
                                  route[4])

        # --- smaller-child histogram; the pool derives the larger --------
        # the children live in the other buffer than their parent
        small_left = frow[2] <= frow[5]
        sc_small = torch.cat([torch.where(small_left, start_t, start_t + nl),
                              torch.where(small_left, nl, nr)]).int()
        kids = odd ^ 1
        plan = None if bound is not None else self.hist_plan
        if self.ordered:     # a contiguous window of the ordered copies
            hist_small = self.histogram(
                self.iota, sc_small, *self.bufs[0][1:], B, bound, plan,
                alt=(self.iota, *self.bufs[1][1:]), sel=kids)
        else:
            hist_small = self.histogram(
                self.bufs[0][0], sc_small, self.hist_bins, *self.weights, B,
                bound, plan,
                alt=(self.bufs[1][0], self.hist_bins, *self.weights),
                sel=kids)
        pool.children(l, new, frow, small_left, hist_small, child_depth)
        self.end_step(act)
        return True

    def run(self, loop: str):
        """Take the tree's steps; returns (splits, steps taken, host reads,
        positions partitioned)."""
        L = self.cfg.num_leaves
        if self.read_window:   # the step reads its window and the stop
            self.reads = self.host_positions = 0
            splits = 0
            while splits < L - 1 and self.step():
                splits += 1
            return (splits, splits + (splits < L - 1), self.reads,
                    self.host_positions)
        (splits, _, positions), done, reads = self.run_steps(loop)
        return splits, done, reads, positions


def grow_tree(bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
              cw: torch.Tensor, meta: FeatureMeta, feat_valid: torch.Tensor,
              cfg: GrowerConfig, stats: Optional[Dict[str, int]] = None,
              buffers: Optional[WindowBuffers] = None,
              loop: Optional[str] = None,
              rows: Optional[torch.Tensor] = None):
    """Grow one tree.

    bins ``[N, F]`` uint8 or uint16 (F physical columns); gw/hw/cw ``[N]`` f32
    (gradient, hessian, count weight); feat_valid ``[E]`` bool over the
    logical features of ``meta``.  Returns ``(TreeArrays, row_leaf [N]
    i32)``; the tree's split features are logical.
    ``rows`` (sorted int32 row ids, a bag) grows the tree on those rows
    only, the root window holding them (the weights of other rows must be
    0: the root's sums run over all rows); their row_leaf is -1.
    ``buffers`` (a :class:`WindowBuffers` for these shapes and ``cfg``,
    reused across trees, with its captured step and, packed, the storage
    matrix its histogram reads) is allocated unpacked when not given.
    ``loop`` is ``"graph"`` (replay the captured split step: a card with
    ``partition_impl=compact``) or ``"eager"``; None takes the graph where
    it can.  Both grow the same tree.

    ``stats`` (optional) counts ``host_syncs`` (reads of device state back
    to the host), ``splits``, ``steps`` (steps taken, those after the stop
    included), ``graph_replays`` and ``partition_positions`` (the windows'
    positions partitioned)."""
    n, f = bins.shape
    dev = bins.device
    stats = stats if stats is not None else {}
    for k in ("host_syncs", "splits", "steps", "graph_replays",
              "partition_positions"):
        stats.setdefault(k, 0)
    e = meta.num_bin.numel()
    if buffers is None:
        buffers = WindowBuffers(n, f, cfg, dev, n_logical=e,
                                bin_dtype=bins.dtype)
    elif not buffers.fits(n, f, cfg, dev, e, bins.dtype):
        raise ValueError("grow_tree: the window buffers were made for other "
                         "shapes or another grower config")
    loop = buffers.loop(loop)
    m = buffers.start(bins, gw, hw, cw, meta, feat_valid, rows)
    replays = buffers.replays
    # the capture and the replays take the current card's streams
    with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
        splits, steps, reads, positions = buffers.run(loop)
    stats["host_syncs"] += reads
    stats["splits"] += splits
    stats["steps"] += steps
    stats["graph_replays"] += buffers.replays - replays
    stats["partition_positions"] += positions

    pool = buffers.pool
    row_leaf = _row_leaf_from_intervals(
        (buffers.bufs[0][0], buffers.bufs[1][0]),
        buffers.lsc[:splits + 1, 0], buffers.lsc[:splits + 1, 1],
        (pool.leaf_depth[:splits + 1] & 1) == 1, n, m)
    return pool.tree(splits), row_leaf


class StreamedGrower(SplitLoop):
    """The serial learner over a bin matrix that stays on the host
    (``data_stream=chunked``): the port of ``lightgbm_tpu/grower.py:1162
    StreamedGrower``, built on the :class:`LeafPool` as the data-parallel
    learner builds its step (``parallel/gspmd.py:GspmdGrower``).

    The state lives across trees, made once per training for
    ``streamer`` (a :class:`~.data.stream.BlockStreamer`): one ``row_leaf
    [N]`` int32 map, ``counts [blocks, L + 1]`` int32 (every leaf's rows
    in each block, as the data-parallel learner keeps them per shard),
    the weights, copied in per tree, and the pool.  Each split is one
    pass over every block, in block order (:meth:`_measure`): block k's
    part of ``row_leaf`` is routed on the pending split by
    ``route_rows`` (reading the row-major block through its strides,
    which also moves the leaf's count in ``counts[k]``), then the
    smaller child's partial histogram is taken by ``hist_local`` (K3 in
    its device regime, the block a shard whose leaf count it reads from
    ``counts[k]``) and added to the pass's sum.  The root pass routes
    nothing: every row is in leaf 0.  Under integer-valued weights, whose
    sums are exact in any order, its trees are the resident grower's and
    the JAX package's streamed grower's.

    A pass streams the whole matrix, so the loop reads the ``active``
    flag before each one, right after :meth:`SplitLoop.pick`: one host
    read a split (and one for the stop), as the JAX loop reads ``cont``
    (:1540); a step after the stop would otherwise stream every block for
    nothing.  Nothing else in a pass waits on the host.  The pass runs
    eagerly."""

    wrappers = (hist_local, route_rows, cat_group_accept)

    def __init__(self, cfg: GrowerConfig, streamer,
                 n_logical: Optional[int] = None):
        # counters: splits made, the active flag
        super().__init__(cfg, streamer.device, 2)
        store, self.streamer = streamer.store, streamer
        dev, n, L = self.device, store.num_rows, cfg.num_leaves
        self.row_leaf = torch.zeros(n, dtype=torch.int32, device=dev)
        self.counts = torch.zeros((store.num_blocks, L + 1),
                                  dtype=torch.int32, device=dev)
        self.block_rows = torch.tensor(store.block_rows(), dtype=torch.int32,
                                       device=dev)
        self.weights = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                             for _ in range(3))
        self.root_id = torch.zeros(1, dtype=torch.int32, device=dev)
        self.pool = LeafPool(cfg, store.num_cols, dev, n_logical=n_logical)
        self.meta: Optional[FeatureMeta] = None
        self.reads = 0
        # each block's views of the map, the weights and its counts (as
        # route_rows' [1, L + 1] and K3's [L + 1]), made once: a pass of
        # many blocks is host-bound
        self.views = [(self.row_leaf[lo:hi],
                       *(w[lo:hi] for w in self.weights),
                       self.counts[k:k + 1], self.counts[k])
                      for k, (lo, hi) in enumerate(map(
                          store.bounds, range(store.num_blocks)))]

    def _measure(self, leaf_id: torch.Tensor, split=None) -> torch.Tensor:
        """One pass over the blocks: ``split`` (``(leaf, new)``, device
        ``int64[1]``) routed first in each block, when given, then the
        ``[F, B, 3]`` histogram of leaf ``leaf_id`` (an int32[1]) summed
        over the blocks in block order."""
        pool, B = self.pool, self.cfg.max_bin
        acc = None
        for k, _, _, block in self.streamer.blocks():
            rl, gw, hw, cw, route_counts, counts = self.views[k]
            if split is not None:
                route_rows(rl, block.t(), *split, pool.si32, pool.scat,
                           pool.scatb, self.meta, route_counts)
            part = hist_local(rl, leaf_id, block, gw, hw, cw, B,
                              leaf_rows=counts)
            acc = part if acc is None else acc + part
        return acc

    def start(self, gw: torch.Tensor, hw: torch.Tensor, cw: torch.Tensor,
              meta: FeatureMeta, feat_valid: torch.Tensor) -> None:
        """Start a tree: the weights copied in, every row in leaf 0 and
        every block's rows counted there, the counters cleared, and the
        pool reset with the root's histogram (the root pass)."""
        self.meta = meta
        for dst, src in zip(self.weights, (gw, hw, cw)):
            dst.copy_(src)
        self.row_leaf.zero_()
        self.counts.zero_()
        self.counts[:, 0].copy_(self.block_rows)
        self.start_counters()
        self.pool.reset(meta, feat_valid, self._measure(self.root_id),
                        gw.sum(), hw.sum(), cw.sum())

    def step(self) -> bool:
        """One split, unless the tree has stopped: the leaf chosen on the
        device, the ``active`` flag read back (the loop's one host read),
        and on a live step the pass that routes the split and measures the
        smaller child; the pool then records the node and derives both
        children.  Returns whether the step split."""
        pool = self.pool
        act, l, new, node = self.pick(pool)
        self.reads += 1
        if not self.read_counters()[1]:
            return False
        irow, frow, route = pool.split_args(l)
        small_left = frow[2] <= frow[5]
        small_id = torch.where(small_left, l, new).int()
        hist_small = self._measure(small_id, (l, new))
        child_depth = pool.record(l, new, node, irow, frow, route[3],
                                  route[4])
        pool.children(l, new, frow, small_left, hist_small, child_depth)
        self.end_step(act)
        return True

    def __call__(self, gw: torch.Tensor, hw: torch.Tensor, cw: torch.Tensor,
                 meta: FeatureMeta, feat_valid: torch.Tensor,
                 stats: Optional[Dict[str, int]] = None):
        """Grow one tree from the weights ``[N]`` f32 on the device.
        Returns ``(TreeArrays, row_leaf [N] i32)``.  ``stats`` counts
        ``host_syncs`` (reads of the ``active`` flag), ``splits``,
        ``steps`` (the splits: no step runs after the stop),
        ``stream_passes``, ``stream_blocks`` and ``stream_bytes``."""
        stats = stats if stats is not None else {}
        for k in ("host_syncs", "splits", "steps", "stream_passes",
                  "stream_blocks", "stream_bytes"):
            stats.setdefault(k, 0)
        sm = self.streamer
        before = (sm.passes, sm.blocks_streamed, sm.bytes_streamed)
        self.reads = splits = 0
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else nullcontext()):
            self.start(gw, hw, cw, meta, feat_valid)
            while splits < self.cfg.num_leaves - 1 and self.step():
                splits += 1
        stats["host_syncs"] += self.reads
        stats["splits"] += splits
        stats["steps"] += splits
        for key, b, a in zip(("stream_passes", "stream_blocks",
                              "stream_bytes"), before,
                             (sm.passes, sm.blocks_streamed,
                              sm.bytes_streamed)):
            stats[key] += a - b
        return self.pool.tree(splits), self.row_leaf.clone()
