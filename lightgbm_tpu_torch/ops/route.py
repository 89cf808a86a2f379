"""Routing a split: which rows of the splitting leaf go left.

:func:`route_goes_left` is the port of ``lightgbm_tpu/grower.py:372
route_goes_left`` (tree.h:257-313), which the JAX package computes in XLA:
a missing bin (the NaN bin, or the default bin of a zero-missing column)
goes the split's default way, another bin left when it is at most the
threshold, and a categorical split sends a bin left when its ``[B]``
bins-left row says so.  With EFB the split feature is logical: its bin
is read from its bundle's column ``meta.col[feat]`` and decoded from the
bundle's slot first (:func:`decode_bundle_bin`).

:func:`route_window` routes the window of the leaf that splits, with
everything it needs read from device memory: the window (start, cnt), the
parity of the buffer that holds it, the leaf, and through the leaf its
pooled split.  The serial grower's split step is captured as a CUDA graph,
in which the host knows none of these.  On a CUDA tensor it launches the
hand-written kernel ``csrc/route.cu``; on a CPU tensor it runs
:func:`route_window_plain`, the plain PyTorch version (a slice of the
window, a gather of the split column and :func:`route_goes_left`).

:func:`route_rows` is the routing of the data-parallel learner
(``lightgbm_tpu/parallel/gspmd.py:305-320``) and of the streamed grower
(``lightgbm_tpu/grower.py:1223 block_step``): one update in place of a
row -> leaf map over some row shards (a device's, or one streamed
block), the rows of the leaf that go right moving to the new leaf, with
the split read through the leaf from the pool.  The bins come as an ``[F, n]``
tensor in either of two layouts, which the wrapper reads from its
strides: a column-major copy (the data-parallel learner's), or the
transpose of a row-major ``[n, F]`` block as it arrived from the host
(the streamed grower's).  It also moves those rows' counts in a
per-shard count of every leaf, which the shard-local histogram's device
regime reads.  On a CUDA tensor it launches the second kernel of
``csrc/route.cu`` over the grid of :func:`rows_grid` (column-major: a
wave at most, each thread ``ROWS_UNROLL`` 4-row vectors of ``row_leaf``;
row-major: one row a thread); on a CPU tensor it runs
:func:`route_rows_plain` (:func:`route_goes_left`, ``masked_fill_`` and a
per-shard ``sum``).
Neither reads anything back to the host.

:func:`route_rows_block` is :func:`route_rows` over block-sharded bins
(``shard_axes=batch,feature``, ``lightgbm_tpu/parallel/gspmd.py:89``):
no tensor holds a shard's every column; each (batch shard, feature
shard) slot holds its row-major column slice (:class:`BlockBins`), and
the split column is read from the slice that owns it.  On a CUDA tensor
it launches the third kernel of ``csrc/route.cu`` over a device table of
the slices' addresses; on a CPU tensor it runs
:func:`route_rows_block_plain`.
"""
from __future__ import annotations

import bisect
import ctypes
import struct
from typing import List, NamedTuple, Optional, Sequence

import torch

from . import build
from .histogram import BIN_DTYPES, bin_rows, sm_count
from .split import MISSING_NAN, MISSING_ZERO

THREADS = 256           # threads a block (csrc/route.cu kThreads)
MAX_BLOCKS_PER_SM = 16  # the grid's cap; threads stride beyond it
ROWS_UNROLL = 4         # route_rows, column-major: 4-row vectors in
#                         flight a thread (csrc/route.cu kRowsUnroll)
ROWS_BLOCKS_PER_SM = 4  # route_rows, column-major: resident blocks an SM,
#                         held by the kernel's launch bounds
#                         (kRowsBlocksPerSm)


def decode_slot(raw: torch.Tensor, off: torch.Tensor, nb: torch.Tensor,
                db: torch.Tensor) -> torch.Tensor:
    """Bundle slots ``raw`` -> the bins of a feature with first slot
    ``off``, ``nb`` bins and default bin ``db`` (broadcast against
    ``raw``), as ``lightgbm_tpu/grower.py:145-158``: the feature owns
    slots ``[off, off + nb - 2]``, its bins with the default one left
    out; any other slot means another feature of the bundle is
    non-default, so this one sits in its default bin.  A feature alone in
    its column (``off`` -1) reads its bins as they are."""
    local = raw - off
    in_range = (local >= 0) & (local < nb - 1)
    sub = torch.where(in_range, local + (local >= db).to(raw.dtype),
                      db.to(raw.dtype))
    return torch.where(off < 0, raw, sub)


def decode_bundle_bin(raw: torch.Tensor, feat: torch.Tensor,
                      meta) -> torch.Tensor:
    """:func:`decode_slot` for logical feature ``feat`` (a one-element
    device tensor) of ``meta``."""
    return decode_slot(raw, *(t.index_select(0, feat) for t in (
        meta.offset, meta.num_bin, meta.default_bin)))


def feature_column(meta, feat: torch.Tensor) -> torch.Tensor:
    """The physical column of logical feature ``feat``."""
    return feat if meta.col is None else meta.col.index_select(0, feat).long()


def route_goes_left(binf: torch.Tensor, meta, feat: torch.Tensor,
                    thr: torch.Tensor, dleft: torch.Tensor,
                    is_cat_l: Optional[torch.Tensor] = None,
                    cat_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Left/right decision for rows with bins ``binf`` of the physical
    column of feature ``feat`` (tree.h:257-313), decoded first when
    ``meta`` carries bundles; ``feat``/``thr``/``dleft``/``is_cat_l`` are
    one-element device tensors, ``cat_row`` the split's ``[B]`` bins-left
    set (given only when the dataset has categorical features); ``meta`` a
    ``grower.FeatureMeta``."""
    if meta.col is not None:
        binf = decode_bundle_bin(binf, feat, meta)
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


def route_window_plain(sc: torch.Tensor, odd: torch.Tensor,
                       leaf: torch.Tensor, split_i32: torch.Tensor,
                       split_cat: Optional[torch.Tensor],
                       split_catb: Optional[torch.Tensor], meta,
                       bins: Sequence[torch.Tensor],
                       order: Sequence[Optional[torch.Tensor]],
                       out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`route_window`: reads the window,
    the parity and the leaf back to the host, slices the window of buffer
    ``odd % 2``, gathers its split column and routes it."""
    start, cnt, par, l = (int(v) for v in torch.cat([
        sc.reshape(2).long(), odd.reshape(1).long(),
        leaf.reshape(1).long()]).tolist())
    par &= 1
    cnt = max(0, min(cnt, bins[0].shape[0] - start))
    if cnt == 0:
        return out
    feat = split_i32[l, 0:1].long()
    col = feature_column(meta, feat)
    f = bins[par].shape[1]
    if order[par] is None:      # the window's rows, in buffer order
        binf = bin_rows(bins[par][start:start + cnt], col, dim=1)[:, 0]
    else:
        win = order[par][start:start + cnt].long()
        binf = bin_rows(bins[par].reshape(-1), win * f + col)
    out[:cnt] = route_goes_left(
        binf, meta, feat, split_i32[l, 1:2].long(),
        split_i32[l, 2:3].bool(),
        split_cat[l:l + 1] if split_cat is not None else None,
        split_catb[l] if split_catb is not None else None)
    return out


# the C entry point's one argument (csrc/route.cu: Args): 16 pointers, the
# rows, 6 ints and the stream
_ARGS = struct.Struct("@16Pq6iP")


def _meta_tensors(meta):
    """The meta tensors a kernel reads: three, and the bundle maps."""
    return [t for t in (meta.num_bin, meta.missing_type, meta.default_bin,
                        meta.col, meta.offset) if t is not None]


def _meta_ok(meta) -> bool:
    return (all(m.dtype == torch.int32 for m in _meta_tensors(meta))
            and (meta.col is None) == (meta.offset is None))


def route_window(sc: torch.Tensor, odd: torch.Tensor, leaf: torch.Tensor,
                 split_i32: torch.Tensor, split_cat: Optional[torch.Tensor],
                 split_catb: Optional[torch.Tensor], meta,
                 bins: Sequence[torch.Tensor],
                 order: Sequence[Optional[torch.Tensor]],
                 out: torch.Tensor,
                 rows_upper_bound: Optional[int] = None) -> torch.Tensor:
    """Write ``goes_left`` (1 = left) for positions ``[0, cnt)`` of the
    window (start, cnt) = ``sc`` (``int64[2]``) into ``out`` (bool or
    uint8, at least cnt long) and return ``out``.

    The window lies in buffer ``odd % 2`` (``odd`` an ``int32[1]``):
    ``bins[k]`` holds the leaf-ordered bins of buffer k and ``order`` is
    ``(None, None)`` (``ordered_bins=on``), or ``bins[0] is bins[1]`` is
    the natural bin matrix and ``order[k]`` the row ids of buffer k.  The
    split is leaf ``leaf``'s (an ``int64[1]``) in the pool: row ``leaf`` of
    ``split_i32`` (int32 ``[leaves, 3]``: feature, threshold,
    default_left) and, when the data has categorical columns, of
    ``split_cat`` (bool ``[leaves]``) and ``split_catb`` (bool
    ``[leaves, B]``).  ``meta`` is a ``grower.FeatureMeta`` of int32
    tensors; with EFB's ``col`` and ``offset`` the kernel reads the
    feature's bundle column and decodes its slot.  ``rows_upper_bound``
    bounds cnt (the rows when not given) and sizes the grid.  CPU tensors
    take the plain version; CUDA tensors launch the kernel, on their own
    card, or raise."""
    if not bins[0].is_cuda:
        if bins[0].device.type == "cpu":
            return route_window_plain(sc, odd, leaf, split_i32, split_cat,
                                      split_catb, meta, bins, order, out)
        raise ValueError(f"route_window: unsupported device {bins[0].device}")
    dev = bins[0].get_device()
    rows, f = bins[0].shape
    tensors = [sc, odd, leaf, split_i32, *_meta_tensors(meta), *bins, out,
               *[t for t in (split_cat, split_catb, *order) if t is not None]]
    if (any(t.get_device() != dev or not t.is_contiguous() for t in tensors)
            or sc.dtype != torch.int64 or sc.numel() != 2
            or odd.dtype != torch.int32 or odd.numel() != 1
            or leaf.dtype != torch.int64 or leaf.numel() != 1
            or split_i32.dtype != torch.int32 or split_i32.dim() != 2
            or split_i32.shape[1] != 3 or not _meta_ok(meta)
            or bins[0].dtype not in BIN_DTYPES
            or any(b.dtype != bins[0].dtype or b.shape != (rows, f)
                   for b in bins)
            or (order[0] is None) != (order[1] is None)
            or any(o is not None and (o.dtype != torch.int32
                                      or o.numel() != rows) for o in order)
            or (split_cat is None) != (split_catb is None)
            or (split_cat is not None and (
                split_cat.dtype != torch.bool or split_catb.dtype != torch.bool
                or split_catb.dim() != 2))
            or out.element_size() != 1 or out.numel() < min(
                rows, rows if rows_upper_bound is None
                else int(rows_upper_bound))):
        raise ValueError("route_window: contiguous tensors on one card: "
                         "sc int64[2], odd int32[1], leaf int64[1], "
                         "split_i32 int32 [leaves, 3], int32 meta (col "
                         "and offset together), uint8 or uint16 "
                         "bins [rows, F] for both buffers, int32 orders of "
                         "both or neither, bool split_cat and split_catb "
                         "together, and a 1-byte out over the bound")
    bound = rows if rows_upper_bound is None else int(rows_upper_bound)
    grid = max(1, min(-(-bound // THREADS),
                      MAX_BLOCKS_PER_SM * sm_count(dev)))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = build.function("route", "lgbt_route", [ctypes.c_char_p])(
        _ARGS.pack(sc.data_ptr(), odd.data_ptr(), leaf.data_ptr(),
                   split_i32.data_ptr(), ptr(split_cat), ptr(split_catb),
                   meta.num_bin.data_ptr(), meta.missing_type.data_ptr(),
                   meta.default_bin.data_ptr(), ptr(meta.col),
                   ptr(meta.offset), bins[0].data_ptr(),
                   bins[1].data_ptr(), ptr(order[0]), ptr(order[1]),
                   out.data_ptr(), rows, f, meta.num_bin.numel(),
                   0 if split_catb is None else split_catb.shape[1], grid,
                   dev, bins[0].element_size(),
                   torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"route kernel launch failed: CUDA error {err}")
    route_window.launches += 1
    return out


# kernel launches, counted where the kernel is launched and nowhere else
route_window.launches = 0


def route_rows_plain(row_leaf: torch.Tensor, bins_t: torch.Tensor,
                     leaf: torch.Tensor, new: torch.Tensor,
                     split_i32: torch.Tensor,
                     split_cat: Optional[torch.Tensor],
                     split_catb: Optional[torch.Tensor], meta,
                     counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`route_rows`: the split column's
    rows routed by :func:`route_goes_left`, the leaf's right rows set to
    ``new`` with ``masked_fill_``, and their number in each shard moved
    from the leaf's count to the new leaf's."""
    split = split_i32.index_select(0, leaf)[0].long()
    # the sink row of a step after the stop may hold no valid feature; no
    # row is in the sink leaf, so any feature routes the same
    feat = split[0:1].clamp(0, meta.num_bin.numel() - 1)
    goes_left = route_goes_left(
        bin_rows(bins_t, feature_column(meta, feat))[0], meta,
        feat, split[1:2],
        split[2:3].bool(),
        split_cat.index_select(0, leaf) if split_cat is not None else None,
        split_catb.index_select(0, leaf)[0]
        if split_catb is not None else None)
    right = (row_leaf == leaf) & ~goes_left
    row_leaf.masked_fill_(right, new.to(row_leaf.dtype).view(()))
    moved = right.view(counts.shape[0], -1).sum(1, dtype=counts.dtype)
    counts.index_add_(1, new, moved[:, None])
    counts.index_add_(1, leaf, -moved[:, None])
    return row_leaf


def rows_grid(n_loc: int, shards: int, sms: int, column: bool) -> int:
    """Blocks a shard of the ``route_rows`` kernel on a card of ``sms``
    SMs.  Column-major bins (``column``, a row stride of 1): enough
    blocks to give each thread ``ROWS_UNROLL`` vectors of 4 rows, and no
    more than one wave over all ``shards`` (``ROWS_BLOCKS_PER_SM``
    resident blocks an SM), past which a thread takes them round after
    round.  Row-major: one row a thread, at most ``MAX_BLOCKS_PER_SM``
    blocks an SM over the shards, the threads striding beyond."""
    if column:
        need = -(-(n_loc // 4 + 1) // (THREADS * ROWS_UNROLL))
        cap = ROWS_BLOCKS_PER_SM * sms // shards
    else:
        need = -(-n_loc // THREADS)
        cap = MAX_BLOCKS_PER_SM * sms // shards
    return max(1, min(need, cap))


# the C entry point's one argument (csrc/route.cu: RowsArgs): 13 pointers,
# the shard's rows, the row and column strides, 8 ints and the stream
_ROWS_ARGS = struct.Struct("@13P3q8iP")


def route_rows(row_leaf: torch.Tensor, bins_t: torch.Tensor,
               leaf: torch.Tensor, new: torch.Tensor,
               split_i32: torch.Tensor, split_cat: Optional[torch.Tensor],
               split_catb: Optional[torch.Tensor], meta,
               counts: torch.Tensor) -> torch.Tensor:
    """Route leaf ``leaf``'s rows of a device's row -> leaf map in place
    and return it: ``row_leaf`` (int32 ``[S * n_loc]``, the ``S`` row
    shards the device holds, in order) gets ``new`` at every row of the
    leaf that goes right, and ``counts`` (int32 ``[S, leaves]``, every
    leaf's rows in each shard) moves their number in each shard from
    column ``leaf`` to column ``new``.

    ``leaf`` and ``new`` are device ``int64[1]``; the split is row
    ``leaf`` of the pool's ``split_i32`` (int32 ``[leaves, 3]``: feature,
    threshold, default_left) and, when the data has categorical columns,
    of ``split_cat`` (bool ``[leaves]``) and ``split_catb`` (bool
    ``[leaves, B]``); ``meta`` a ``grower.FeatureMeta`` of int32 tensors,
    whose EFB maps ``col`` and ``offset``, when given, make the kernel
    read the feature's bundle column and decode its slot.  A leaf that
    holds no row (the sink after the tree's stop) moves nothing.

    ``bins_t`` is a uint8 or uint16 ``[F, S * n_loc]`` tensor of the
    rows' bins in one of two layouts, taken from its strides: the
    contiguous column-major copy (strides ``(S * n_loc, 1)``: a warp
    reads neighbouring bins of the split column), or ``block.t()`` of a
    contiguous row-major ``[S * n_loc, F]`` block (strides ``(1, F)``:
    each row's bin a row apart).  The kernel reads column c of row r at
    ``c * stride(0) + r * stride(1)``; the plain version selects the same
    column of the same view.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, on their own card, or raise.  The launch
    counter counts each launch once, in either layout."""
    if not row_leaf.is_cuda:
        if row_leaf.device.type == "cpu":
            return route_rows_plain(row_leaf, bins_t, leaf, new, split_i32,
                                    split_cat, split_catb, meta, counts)
        raise ValueError(f"route_rows: unsupported device {row_leaf.device}")
    dev = row_leaf.get_device()
    n = row_leaf.numel()
    shards = counts.shape[0] if counts.dim() == 2 else 0
    tensors = [row_leaf, leaf, new, split_i32, *_meta_tensors(meta), counts,
               *[t for t in (split_cat, split_catb) if t is not None]]
    if (any(t.get_device() != dev or not t.is_contiguous() for t in tensors)
            or row_leaf.dtype != torch.int32 or row_leaf.dim() != 1
            or bins_t.get_device() != dev
            or bins_t.dtype not in BIN_DTYPES or bins_t.dim() != 2
            or bins_t.shape[1] != n
            or not (bins_t.is_contiguous() or bins_t.t().is_contiguous())
            or any(t.dtype != torch.int64 or t.numel() != 1
                   for t in (leaf, new))
            or split_i32.dtype != torch.int32 or split_i32.dim() != 2
            or split_i32.shape[1] != 3 or not _meta_ok(meta)
            or counts.dtype != torch.int32 or shards < 1 or n % shards
            or counts.shape[1] != split_i32.shape[0]
            or (split_cat is None) != (split_catb is None)
            or (split_cat is not None and (
                split_cat.dtype != torch.bool or split_catb.dtype != torch.bool
                or split_catb.dim() != 2))):
        raise ValueError("route_rows: contiguous tensors on one card: int32 "
                         "row_leaf [S * n_loc], uint8 or uint16 bins_t "
                         "[F, S * n_loc] (column-major, or the transpose "
                         "of a row-major block), "
                         "leaf and new int64[1], split_i32 int32 [leaves, "
                         "3], int32 meta (col and offset together), int32 "
                         "counts [S, leaves], and bool "
                         "split_cat and split_catb together")
    n_loc = n // shards
    grid = rows_grid(n_loc, shards, sm_count(dev),
                     bins_t.stride(1) == 1)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = build.function("route", "lgbt_route_rows", [ctypes.c_char_p])(
        _ROWS_ARGS.pack(row_leaf.data_ptr(), bins_t.data_ptr(),
                        leaf.data_ptr(), new.data_ptr(),
                        split_i32.data_ptr(), ptr(split_cat),
                        ptr(split_catb), meta.num_bin.data_ptr(),
                        meta.missing_type.data_ptr(),
                        meta.default_bin.data_ptr(), ptr(meta.col),
                        ptr(meta.offset), counts.data_ptr(),
                        n_loc, bins_t.stride(1), bins_t.stride(0),
                        shards, bins_t.shape[0], meta.num_bin.numel(),
                        0 if split_catb is None else split_catb.shape[1],
                        counts.shape[1], grid, dev, bins_t.element_size(),
                        torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"route_rows kernel launch failed: CUDA error "
                           f"{err}")
    route_rows.launches += 1
    return row_leaf


# kernel launches, counted where the kernel is launched and nowhere else
route_rows.launches = 0


class BlockBins(NamedTuple):
    """Block-sharded bins as one device holds them: ``slices[k][j]`` is
    the row-major ``[n_loc, w_j]`` slice of the device's k-th batch shard
    over feature shard j's columns ``[edges[j], edges[j + 1])``, or None
    where another device holds that slot.  ``ptrs`` (int64 ``[S * fs]``,
    the slices' addresses, 0 for None) and ``first`` (int32 ``[fs + 1]``,
    the edges) are the kernel's table, on the slices' device
    (:func:`make_block_bins`)."""
    slices: List[List[Optional[torch.Tensor]]]
    edges: tuple
    ptrs: torch.Tensor
    first: torch.Tensor


def make_block_bins(slices, edges, device) -> BlockBins:
    """The :class:`BlockBins` of ``slices`` (a device's batch shards, each
    a list over the feature shards) cut at column ``edges``, its table
    made once on ``device``."""
    ptrs = torch.tensor([[0 if t is None else t.data_ptr() for t in row]
                         for row in slices], dtype=torch.int64).reshape(-1)
    return BlockBins([list(row) for row in slices], tuple(int(e) for e in edges),
                     ptrs.to(device),
                     torch.tensor(edges, dtype=torch.int32, device=device))


def route_rows_block_plain(row_leaf: torch.Tensor, block: BlockBins,
                           leaf: torch.Tensor, new: torch.Tensor,
                           split_i32: torch.Tensor,
                           split_cat: Optional[torch.Tensor],
                           split_catb: Optional[torch.Tensor], meta,
                           counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`route_rows_block`: the split's
    physical column read back to the host, its feature shard found in the
    edges, and each shard whose owning slice is here routed as
    :func:`route_rows_plain` routes it, from that slice's column."""
    split = split_i32.index_select(0, leaf)[0].long()
    # the sink row of a step after the stop may hold no valid feature; no
    # row is in the sink leaf, so any feature routes the same
    feat = split[0:1].clamp(0, meta.num_bin.numel() - 1)
    col = feature_column(meta, feat)
    c = int(col)
    edges = block.edges
    j = min(max(bisect.bisect_right(edges, c) - 1, 0), len(edges) - 2)
    n_loc = row_leaf.numel() // len(block.slices)
    cat = (split_cat.index_select(0, leaf) if split_cat is not None
           else None)
    catb = (split_catb.index_select(0, leaf)[0] if split_catb is not None
            else None)
    for k, row in enumerate(block.slices):
        sl = row[j]
        if sl is None:
            continue
        binf = bin_rows(sl, col - edges[j], dim=1)[:, 0]
        goes_left = route_goes_left(binf, meta, feat, split[1:2],
                                    split[2:3].bool(), cat, catb)
        rl = row_leaf[k * n_loc:(k + 1) * n_loc]
        right = (rl == leaf) & ~goes_left
        rl.masked_fill_(right, new.to(rl.dtype).view(()))
        moved = right.sum(dtype=counts.dtype).reshape(1)
        counts[k].index_add_(0, new, moved)
        counts[k].index_add_(0, leaf, -moved)
    return row_leaf


# the C entry point's one argument (csrc/route.cu: BlockArgs): 14 pointers,
# the shard's rows, 8 ints and the stream
_BLOCK_ARGS = struct.Struct("@14Pq8iP")


def route_rows_block(row_leaf: torch.Tensor, block: BlockBins,
                     leaf: torch.Tensor, new: torch.Tensor,
                     split_i32: torch.Tensor,
                     split_cat: Optional[torch.Tensor],
                     split_catb: Optional[torch.Tensor], meta,
                     counts: torch.Tensor) -> torch.Tensor:
    """:func:`route_rows` over block-sharded bins: route leaf ``leaf``'s
    rows of a device's row -> leaf map (int32 ``[S * n_loc]``, its ``S``
    batch shards in order) in place and move their counts in ``counts``
    (int32 ``[S, leaves]``), reading the split column from ``block``'s
    slice that owns it (:class:`BlockBins`).  A shard whose owning slice
    another device holds is left as it is.  The other arguments are
    :func:`route_rows`'s.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, on their own card, or raise.  The launch
    counter counts each launch once."""
    if not row_leaf.is_cuda:
        if row_leaf.device.type == "cpu":
            return route_rows_block_plain(row_leaf, block, leaf, new,
                                          split_i32, split_cat, split_catb,
                                          meta, counts)
        raise ValueError(f"route_rows_block: unsupported device "
                         f"{row_leaf.device}")
    dev = row_leaf.get_device()
    shards = len(block.slices)
    fs = len(block.edges) - 1
    n = row_leaf.numel()
    n_loc = n // max(shards, 1)
    held = [t for row in block.slices for t in row if t is not None]
    tensors = [row_leaf, leaf, new, split_i32, *_meta_tensors(meta), counts,
               block.ptrs, block.first, *held,
               *[t for t in (split_cat, split_catb) if t is not None]]
    if (any(t.get_device() != dev or not t.is_contiguous() for t in tensors)
            or not held or shards < 1 or n % shards
            or any(len(row) != fs for row in block.slices)
            or row_leaf.dtype != torch.int32 or row_leaf.dim() != 1
            or any(t.dtype != held[0].dtype for t in held)
            or held[0].dtype not in BIN_DTYPES
            or any(t is not None and t.shape != (
                n_loc, block.edges[j + 1] - block.edges[j])
                for row in block.slices for j, t in enumerate(row))
            or block.ptrs.dtype != torch.int64
            or block.ptrs.numel() != shards * fs
            or block.first.dtype != torch.int32
            or block.first.numel() != fs + 1
            or any(t.dtype != torch.int64 or t.numel() != 1
                   for t in (leaf, new))
            or split_i32.dtype != torch.int32 or split_i32.dim() != 2
            or split_i32.shape[1] != 3 or not _meta_ok(meta)
            or counts.dtype != torch.int32 or counts.dim() != 2
            or counts.shape[0] != shards
            or counts.shape[1] != split_i32.shape[0]
            or (split_cat is None) != (split_catb is None)
            or (split_cat is not None and (
                split_cat.dtype != torch.bool or split_catb.dtype != torch.bool
                or split_catb.dim() != 2))):
        raise ValueError("route_rows_block: contiguous tensors on one card: "
                         "int32 row_leaf [S * n_loc], S rows of fs uint8 or "
                         "uint16 slices [n_loc, w_j] (or None) with their "
                         "int64 address table and int32 edges, leaf and "
                         "new int64[1], split_i32 int32 [leaves, 3], int32 "
                         "meta (col and offset together), int32 counts [S, "
                         "leaves], and bool split_cat and split_catb "
                         "together")
    grid = max(1, min(-(-n_loc // THREADS),
                      MAX_BLOCKS_PER_SM * sm_count(dev) // shards))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = build.function("route", "lgbt_block_route",
                         [ctypes.c_char_p])(
        _BLOCK_ARGS.pack(row_leaf.data_ptr(), block.ptrs.data_ptr(),
                         block.first.data_ptr(), leaf.data_ptr(),
                         new.data_ptr(), split_i32.data_ptr(),
                         ptr(split_cat), ptr(split_catb),
                         meta.num_bin.data_ptr(),
                         meta.missing_type.data_ptr(),
                         meta.default_bin.data_ptr(), ptr(meta.col),
                         ptr(meta.offset), counts.data_ptr(), n_loc, shards,
                         fs, meta.num_bin.numel(),
                         0 if split_catb is None else split_catb.shape[1],
                         counts.shape[1], grid, dev, held[0].element_size(),
                         torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"route_rows_block kernel launch failed: CUDA "
                           f"error {err}")
    route_rows_block.launches += 1
    return row_leaf


# kernel launches, counted where the kernel is launched and nowhere else
route_rows_block.launches = 0
