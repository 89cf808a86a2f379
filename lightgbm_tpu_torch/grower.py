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
  every leaf's histogram stays in an ``[L, F, B, 3]`` store;
* the best split of each leaf waits in a per-leaf pool; the leaf with the
  largest gain splits next.  A categorical split carries the set of bins
  it routes left (``is_cat``/``cat_bins``) in the pool and in the node
  records.

PyTorch has dynamic shapes, so the loop runs on the host: each split reads
four scalars back from the device in one copy (the chosen leaf, its window
start and count, and whether any gain is above 0).  That copy is the
loop's only host synchronization; everything else stays on the device,
and the histogram kernel reads its window (start, cnt) from device memory.
The tree's topology (parents, children, depths) depends only on which
leaf splits, so it is kept on the host.

The histogram store, the split pool and the node records are a
:class:`LeafPool`, which the data-parallel learner
(``parallel/gspmd.py``) shares.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .ops.histogram import hist_window
from .ops.partition import (partition_scratch, partition_window,
                            partition_window_plain, partition_window_sort)
from .ops.split import (MISSING_NAN, MISSING_ZERO, SplitConfig, SplitResult,
                        best_split, leaf_output, make_fused_ctx)


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
    """Per-column metadata as device tensors."""
    num_bin: torch.Tensor       # [F] i32
    missing_type: torch.Tensor  # [F] i32 (0 none / 1 zero / 2 nan)
    default_bin: torch.Tensor   # [F] i32
    is_categorical: Optional[torch.Tensor] = None   # [F] bool


def route_goes_left(binf: torch.Tensor, meta: FeatureMeta,
                    feat: torch.Tensor, thr: torch.Tensor,
                    dleft: torch.Tensor,
                    is_cat_l: Optional[torch.Tensor] = None,
                    cat_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Left/right decision for rows with bins ``binf`` of column ``feat``
    (tree.h:257-313); ``feat``/``thr``/``dleft``/``is_cat_l`` are
    one-element device tensors, ``cat_row`` the split's ``[B]`` bins-left
    set (given only when the dataset has categorical features)."""
    mt_f = meta.missing_type.index_select(0, feat)
    nb_f = meta.num_bin.index_select(0, feat)
    db_f = meta.default_bin.index_select(0, feat)
    is_missing = (((mt_f == MISSING_NAN) & (binf == nb_f - 1))
                  | ((mt_f == MISSING_ZERO) & (binf == db_f)))
    goes_left = torch.where(is_missing, dleft, binf <= thr)
    if cat_row is not None:
        cat_go_left = cat_row[torch.clamp(binf, 0, cat_row.shape[0] - 1)]
        goes_left = torch.where(is_cat_l, cat_go_left, goes_left)
    return goes_left


def _depth_gate(res: SplitResult, leaf_depth: int,
                max_depth: int) -> SplitResult:
    """A leaf at depth d (root = 0) may split iff d < max_depth
    (serial_tree_learner.cpp:326+)."""
    if max_depth <= 0 or leaf_depth < max_depth:
        return res
    return res._replace(found=torch.zeros_like(res.found),
                        gain=torch.full_like(res.gain, float("-inf")))


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
                             n: int) -> torch.Tensor:
    """row -> leaf map from the final leaf intervals: the intervals
    partition positions [0, n), so the leaf of each position is its
    interval's, pushed through the ``order`` buffer of that leaf's depth
    parity (``orders[0]`` for even depths, ``orders[1]`` for odd,
    ``leaf_odd`` per leaf)."""
    by_start = torch.argsort(leaf_start, stable=True)
    leaf_of_pos = torch.repeat_interleave(by_start, leaf_cnt[by_start],
                                          output_size=n)
    order = torch.where(leaf_odd[leaf_of_pos], orders[1], orders[0])
    return torch.empty(n, dtype=torch.int32, device=order.device).scatter_(
        0, order.long(), leaf_of_pos.int())


def unpack_tree(num_leaves: int, node_i: torch.Tensor, node_f: torch.Tensor,
                leaf_f: torch.Tensor, node_cat: torch.Tensor,
                node_catb: torch.Tensor, left_child: np.ndarray,
                right_child: np.ndarray, leaf_parent: np.ndarray,
                leaf_depth: np.ndarray) -> TreeArrays:
    """Device records + host topology -> :class:`TreeArrays`."""
    dev = node_i.device

    def host(a):
        return torch.from_numpy(a).to(dev)

    return TreeArrays(
        num_leaves=num_leaves,
        split_feature=node_i[:, 0],
        threshold_bin=node_i[:, 1],
        default_left=node_i[:, 2].bool(),
        left_child=host(left_child),
        right_child=host(right_child),
        split_gain=node_f[:, 0],
        internal_value=node_f[:, 1],
        internal_count=node_f[:, 2],
        leaf_value=leaf_f[:, 0],
        leaf_count=leaf_f[:, 1],
        leaf_parent=host(leaf_parent),
        leaf_depth=host(leaf_depth),
        is_cat=node_cat,
        cat_bins=node_catb)


def _partition(impl: str, src, dst, lsc_row: torch.Tensor, start: int,
               cnt: int, goes_left: torch.Tensor,
               scratch: Optional[torch.Tensor]) -> torch.Tensor:
    """Stable partition of the window (start, cnt) = ``lsc_row`` of the
    ``src`` buffer into ``dst`` by ``partition_impl``; returns the left
    count as a device ``int32[1]``.  The kernel reads the window from the
    device row and the bool mask as they are."""
    if impl == "compact":
        return partition_window(src, dst, lsc_row, goes_left, cnt, scratch)
    if impl == "sort":
        return partition_window_sort(src, dst, start, cnt, goes_left)
    return partition_window_plain(src, dst, start, cnt, goes_left)


class WindowBuffers:
    """The serial grower's two buffers of every matrix that the partition
    moves: ``order`` and, with ``ordered_bins=on``, the leaf-ordered bins
    and weights.  A leaf at depth d keeps its window in ``bufs[d % 2]``.
    Allocated once per training (``rows`` x ``n_feat`` bins on
    ``device``), with the kernel's scratch when ``partition_impl`` is
    ``compact``; :meth:`reset` starts a tree."""

    def __init__(self, rows: int, n_feat: int, cfg: GrowerConfig, device):
        self.ordered = cfg.ordered_bins == "on"
        self.iota = torch.arange(rows, dtype=torch.int32, device=device)

        def one():
            if not self.ordered:
                return (torch.empty_like(self.iota),)
            return (torch.empty_like(self.iota),
                    torch.empty((rows, n_feat), dtype=torch.uint8,
                                device=device),
                    *[torch.empty(rows, dtype=torch.float32, device=device)
                      for _ in range(3)])

        self.bufs = (one(), one())
        self.scratch = (partition_scratch(rows, device)
                        if cfg.partition_impl == "compact"
                        and torch.device(device).type == "cuda" else None)

    def fits(self, rows: int, n_feat: int, cfg: GrowerConfig, device) -> bool:
        """Whether these buffers serve a tree of these shapes and ``cfg``."""
        b = self.bufs[0]
        return (b[0].shape[0] == rows and b[0].device == torch.device(device)
                and self.ordered == (cfg.ordered_bins == "on")
                and (not self.ordered or b[1].shape[1] == n_feat)
                and (self.scratch is not None) == (
                    cfg.partition_impl == "compact"
                    and b[0].device.type == "cuda"))

    def reset(self, bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
              cw: torch.Tensor) -> None:
        """The root's window in buffer 0: rows in natural order, so the
        ordered copies are the inputs."""
        b0 = self.bufs[0]
        b0[0].copy_(self.iota)
        if self.ordered:
            for dst, src in zip(b0[1:], (bins, gw, hw, cw)):
                dst.copy_(src)


class LeafPool:
    """The per-tree bookkeeping both growers share: every leaf's histogram
    (an ``[L, F, B, 3]`` store), the best split of each leaf waiting in a
    pool, the node and leaf records, and the host-side topology.

    ``next_leaf`` makes the split's one host read; ``record`` writes the
    node (``Tree::Split``, tree.h:319-345); ``children`` turns the smaller
    child's histogram into both children's (the larger is the parent
    minus it, serial_tree_learner.cpp:482-488) and scans them for their
    best splits in one batched scan."""

    def __init__(self, cfg: GrowerConfig, meta: FeatureMeta,
                 feat_valid: torch.Tensor, hist_root: torch.Tensor,
                 root_g: torch.Tensor, root_h: torch.Tensor,
                 root_c: torch.Tensor):
        f = hist_root.shape[0]
        dev = hist_root.device
        dtype = hist_root.dtype
        L, B = cfg.num_leaves, cfg.max_bin
        self.cfg = cfg
        self.f = f
        self.feat_valid = feat_valid
        self.scfg = cfg.split_config()
        self.ctx = make_fused_ctx(meta.num_bin, meta.missing_type,
                                  meta.default_bin, B, self.scfg,
                                  meta.is_categorical)
        self.has_cat = cfg.has_categorical
        res_root, fok_root = best_split(
            hist_root[None], root_g[None], root_h[None], root_c[None],
            feat_valid[None], self.scfg, self.ctx)
        res_root = _depth_gate(res_root, 0, cfg.max_depth)

        self.hist_store = torch.zeros((L, f, B, 3), dtype=dtype, device=dev)
        self.hist_store[0] = hist_root
        self.feat_ok = torch.zeros((L, f), dtype=torch.bool, device=dev)
        self.feat_ok[0] = fok_root[0]
        self.sgain = torch.full((L,), float("-inf"), dtype=dtype, device=dev)
        self.sgain[0] = res_root.gain[0]
        self.sf32 = torch.zeros((L, 8), dtype=dtype, device=dev)
        self.si32 = torch.zeros((L, 3), dtype=torch.int32, device=dev)
        self.sf32[:1], self.si32[:1] = pool_rows(res_root)
        if self.has_cat:   # the pool's categorical half: is_cat, bins-left
            self.scat = torch.zeros(L, dtype=torch.bool, device=dev)
            self.scatb = torch.zeros((L, B), dtype=torch.bool, device=dev)
            self.scat[:1], self.scatb[:1] = res_root.is_cat, res_root.cat_bins

        self.node_f = torch.zeros((L - 1, 3), dtype=dtype, device=dev)
        self.node_i = torch.zeros((L - 1, 3), dtype=torch.int32, device=dev)
        self.node_cat = torch.zeros(L - 1, dtype=torch.bool, device=dev)
        self.node_catb = torch.zeros((L - 1, B), dtype=torch.bool,
                                     device=dev)
        self.leaf_f = torch.zeros((L, 2), dtype=dtype, device=dev)
        self.leaf_f[0, 1] = root_c
        self.left_child = np.zeros(L - 1, np.int32)
        self.right_child = np.zeros(L - 1, np.int32)
        self.leaf_parent = np.full(L, -1, np.int32)
        self.leaf_depth = np.zeros(L, np.int32)

    def next_leaf(self, extra: Optional[torch.Tensor] = None):
        """The split's one host read: the leaf with the largest gain, the
        ``extra`` row of that leaf (the serial grower's window, the
        data-parallel grower's row count), and whether its gain is above
        0."""
        l_t = torch.argmax(self.sgain).view(1)
        parts = [l_t] + ([extra.index_select(0, l_t)[0]]
                         if extra is not None else [])
        return torch.cat(parts + [(self.sgain.index_select(0, l_t) > 0)
                                  .long()]).tolist()

    def split_args(self, l: int):
        """The pooled split of leaf ``l``: its int and float rows, and
        ``(feat, thr, dleft, is_cat_l, cat_row)`` for routing."""
        irow = self.si32[l].clone()
        frow = self.sf32[l].clone()
        route = (irow[0:1].long(), irow[1:2].long(), irow[2:3].bool(),
                 self.scat[l:l + 1] if self.has_cat else None,
                 self.scatb[l] if self.has_cat else None)
        return irow, frow, route

    def record(self, l: int, new: int, node: int, irow: torch.Tensor,
               frow: torch.Tensor, is_cat_l, cat_row) -> int:
        """Write node ``node`` splitting leaf ``l`` into (``l``, ``new``);
        returns the children's depth."""
        parent = self.leaf_parent[l]
        if parent >= 0:
            if self.left_child[parent] == ~l:
                self.left_child[parent] = node
            else:
                self.right_child[parent] = node
        self.left_child[node], self.right_child[node] = ~l, ~new
        child_depth = int(self.leaf_depth[l]) + 1
        self.leaf_parent[[l, new]] = node
        self.leaf_depth[[l, new]] = child_depth
        self.node_i[node] = irow
        self.node_f[node] = torch.stack([
            self.sgain[l], leaf_output(frow[0] + frow[3], frow[1] + frow[4],
                                       self.cfg.lambda_l1,
                                       self.cfg.lambda_l2),
            self.leaf_f[l, 1]])
        if self.has_cat:
            self.node_cat[node:node + 1] = is_cat_l
            self.node_catb[node] = cat_row
        self.leaf_f[l] = torch.stack([frow[6], frow[2]])
        self.leaf_f[new] = torch.stack([frow[7], frow[5]])
        return child_depth

    def children(self, l: int, new: int, frow: torch.Tensor,
                 small_left: torch.Tensor, hist_small: torch.Tensor,
                 child_depth: int) -> None:
        """Both children's histograms and best splits into the pool."""
        hist_large = self.hist_store[l] - hist_small
        hist2 = torch.stack([hist_small, hist_large])
        # the (smaller, larger) pair's leaf ids
        pair = torch.stack([torch.where(small_left, l, new),
                            torch.where(small_left, new, l)])
        self.hist_store[pair] = hist2

        # both children scan the features the PARENT found splittable
        # (serial_tree_learner.cpp:406-417), in one batched scan
        fok_parent = self.feat_ok[l].clone()
        lr3 = frow[:6].view(2, 3)
        sl3 = torch.where(small_left, lr3, lr3.flip(0))
        res2, fok2 = best_split(hist2, sl3[:, 0], sl3[:, 1], sl3[:, 2],
                                (self.feat_valid & fok_parent).expand(
                                    2, self.f), self.scfg, self.ctx)
        res2 = _depth_gate(res2, child_depth, self.cfg.max_depth)
        self.feat_ok[pair] = fok2 & fok_parent
        self.sgain[pair] = res2.gain
        self.sf32[pair], self.si32[pair] = pool_rows(res2)
        if self.has_cat:
            self.scat[pair], self.scatb[pair] = res2.is_cat, res2.cat_bins

    def tree(self, splits: int) -> TreeArrays:
        return unpack_tree(splits + 1, self.node_i, self.node_f, self.leaf_f,
                           self.node_cat, self.node_catb, self.left_child,
                           self.right_child, self.leaf_parent,
                           self.leaf_depth)


def grow_tree(bins: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
              cw: torch.Tensor, meta: FeatureMeta, feat_valid: torch.Tensor,
              cfg: GrowerConfig, stats: Optional[Dict[str, int]] = None,
              buffers: Optional[WindowBuffers] = None):
    """Grow one tree.

    bins ``[N, F]`` uint8; gw/hw/cw ``[N]`` f32 (gradient, hessian, count
    weight); feat_valid ``[F]`` bool.  Returns ``(TreeArrays, row_leaf
    [N] i32)``.  ``stats`` (optional) counts ``host_syncs``, ``splits``
    and ``partition_positions`` (the windows' positions partitioned).
    ``buffers`` (a :class:`WindowBuffers` for these shapes and ``cfg``,
    reused across trees) is allocated when not given."""
    n, f = bins.shape
    dev = bins.device
    L = cfg.num_leaves
    B = cfg.max_bin
    stats = stats if stats is not None else {}
    stats.setdefault("host_syncs", 0)
    stats.setdefault("splits", 0)
    stats.setdefault("partition_positions", 0)

    # ---- root -----------------------------------------------------------
    # leaf-ordered copies (the reference's OrderedBin) ride in the buffers
    # with ``order``: rows start in natural order, so the copies are the
    # inputs; every partition moves their rows with ``order``, and a leaf's
    # histogram then reads a contiguous window of them
    if buffers is None:
        buffers = WindowBuffers(n, f, cfg, dev)
    elif not buffers.fits(n, f, cfg, dev):
        raise ValueError("grow_tree: the window buffers were made for other "
                         "shapes or another partition_impl/ordered_bins")
    buffers.reset(bins, gw, hw, cw)
    ordered, bufs, iota = buffers.ordered, buffers.bufs, buffers.iota
    sc_root = torch.tensor([0, n], dtype=torch.int32, device=dev)
    hist_root = hist_window(iota, sc_root, bins, gw, hw, cw, B,
                            rows_upper_bound=n)
    pool = LeafPool(cfg, meta, feat_valid, hist_root, gw.sum(), hw.sum(),
                    cw.sum())
    lsc = torch.zeros((L, 2), dtype=torch.int64, device=dev)  # (start, cnt)
    lsc[0, 1] = n

    step = 0
    for i in range(L - 1):
        l, start, cnt, positive = pool.next_leaf(lsc)
        stats["host_syncs"] += 1
        if not positive:
            break
        new, node = i + 1, i
        irow, frow, (feat, thr, dleft, is_cat_l, cat_row) = pool.split_args(l)
        # the leaf's window is in the buffer of its depth parity; its
        # children go to the same positions of the other one
        odd = int(pool.leaf_depth[l]) % 2
        cur, nxt = bufs[odd], bufs[1 - odd]

        # --- route the leaf's window and partition it stably ------------
        if ordered:     # the split column of the ordered window: no gather
            binf = cur[1][start:start + cnt].index_select(1, feat)[:, 0]
        else:
            win = cur[0][start:start + cnt]
            binf = bins.view(-1).index_select(0, win.long() * f + feat)
        goes_left = route_goes_left(binf.long(), meta, feat, thr, dleft,
                                    is_cat_l, cat_row)
        nl = _partition(cfg.partition_impl, cur, nxt, lsc[l], start, cnt,
                        goes_left, buffers.scratch)[0].long()
        stats["partition_positions"] += cnt
        nr = cnt - nl
        lsc[l, 1] = nl
        lsc[new, 0] = start + nl
        lsc[new, 1] = nr
        child_depth = pool.record(l, new, node, irow, frow, is_cat_l,
                                  cat_row)

        # --- smaller-child histogram; the pool derives the larger --------
        small_left = frow[2] <= frow[5]
        sc = torch.stack([torch.where(small_left, start, start + nl),
                          torch.where(small_left, nl, nr)]).int()
        if ordered:     # a contiguous window of the ordered copies
            hist_small = hist_window(iota, sc, *nxt[1:], B,
                                     rows_upper_bound=cnt)
        else:
            hist_small = hist_window(nxt[0], sc, bins, gw, hw, cw, B,
                                     rows_upper_bound=cnt)
        pool.children(l, new, frow, small_left, hist_small, child_depth)
        step += 1
    stats["splits"] += step

    leaf_odd = torch.from_numpy(pool.leaf_depth[:step + 1] % 2 == 1).to(dev)
    row_leaf = _row_leaf_from_intervals((bufs[0][0], bufs[1][0]),
                                        lsc[:step + 1, 0], lsc[:step + 1, 1],
                                        leaf_odd, n)
    return pool.tree(step), row_leaf
