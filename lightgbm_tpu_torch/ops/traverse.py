"""Tree traversal and margin sums of the serving path.

:func:`traverse` gives each tree's leaf index of every row, int32 ``[T,
B]``, from rows binned against the ensemble's threshold tables
(``predictor.py:SoABundle.bin_rows``), in either node layout:

* ``xla``: the structure-of-arrays node tables, int32 ``[T, P]`` feature,
  threshold rank, missing type, children (a leaf encoded ``~leaf``) and
  category-mask row, bool ``[T, P]`` default-left and categorical flags
  and the bool ``[C, W]`` category mask, over int32 ``[Fc, B]`` ranks and
  category values and bool ``[Fc, B]`` NaN and zero masks
  (``lightgbm_tpu/inference.py:317 _traverse``);
* ``packed``: two int32 node words ``[T, P]`` and one int32 data word a
  (column, row) of a numerical-only ensemble
  (``lightgbm_tpu/inference.py:396 _traverse_packed``, the words of
  :223-229 and :428).

:func:`margin` adds each tree's leaf value to its class's raw score, trees
oldest first, in float64 (``lightgbm_tpu/inference.py:826-833``): the JAX
engine's ``raw_scores`` bit for bit.

On a CUDA tensor each wrapper launches its kernel, ``csrc/traverse.cu``
(``lgbt_traverse``, ``lgbt_margin``), on the tensor's card, or raises; on
a CPU tensor it runs the plain PyTorch version beside it
(:func:`traverse_plain`, :func:`traverse_packed_plain`,
:func:`margin_plain`).  Each wrapper counts its launches.
:func:`traverse_plan` lays a traversal over the kernel's blocks: each a
group of trees and a tile of rows, a packed layout's node words and the
tile's data words staged in shared memory where they fit.
"""
from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional, Sequence

import torch

from . import build
from .histogram import sm_count

MISSING_NONE, MISSING_ZERO, MISSING_NAN = 0, 1, 2
LAYOUTS = ("xla", "packed")

# the C entry points' one argument each (csrc/traverse.cu TraverseArgs,
# MarginArgs): pointers, ints and the stream
_TRAVERSE_ARGS = struct.Struct("@17P10iP")
_MARGIN_ARGS = struct.Struct("@3P5iP")

ROWS_TILE = 128            # rows a traversal block at most (kMaxRows)
GROUP_MAX = 8              # trees a traversal block at most
# blocks an SM that a plan's tree groups leave: a packed group shares one
# staged copy of its nodes, so groups form at half a card of 128-thread
# blocks; node tables stage nothing and group only past a full card (at
# 4,096 rows a group of three lost to one, PERF.md §6)
PACKED_BLOCKS_PER_SM = 8
SOA_BLOCKS_PER_SM = 16
STAGE_NONE, STAGE_ALL = 0, 1   # csrc/traverse.cu kStage*
STAGE_BYTES = 96 * 1024    # a block's staged node words and data words
#                            (kMaxSmem)


class TraversePlan(NamedTuple):
    """How ``lgbt_traverse`` lays a traversal over its blocks: block ``i``
    walks trees ``[g * group, (g + 1) * group)`` (``g = i // tiles``) one
    after another over rows ``[(i % tiles) * rows_tile, ...)``, one thread
    a row (``threads`` a block); ``stage`` says whether a packed layout's
    block first copies its group's node words and its tile's data words
    into ``smem`` bytes of shared memory."""
    rows_tile: int
    threads: int
    group: int
    stage: int
    smem: int
    tiles: int
    groups: int


def traverse_plan(t_count: int, rows: int, nodes: int, cols: int,
                  layout: str, sms: int) -> TraversePlan:
    """The plan of a traversal of ``t_count`` trees of ``nodes`` node
    slots over ``rows`` rows of ``cols`` binned columns on a card of
    ``sms`` SMs.  Rows go in tiles of up to ``ROWS_TILE`` (a power of 2,
    at least the rows when fewer).  Trees go in groups of as many as
    leave ``PACKED_BLOCKS_PER_SM`` blocks an SM (packed) or
    ``SOA_BLOCKS_PER_SM`` (node tables), at most ``GROUP_MAX`` (one at a
    few rows, over every SM).  The packed layout stages the group's node
    words beside the tile's data words where both fit ``STAGE_BYTES``, and
    nothing where they do not (many columns, or a tree of more than
    ``STAGE_BYTES`` of nodes).  The SoA layout stages nothing."""
    rows_tile = min(ROWS_TILE, 1 << max(rows - 1, 0).bit_length())
    tiles = -(-rows // rows_tile)
    per_sm = PACKED_BLOCKS_PER_SM if layout == "packed" else \
        SOA_BLOCKS_PER_SM
    group = max(1, min(GROUP_MAX, t_count,
                       t_count * tiles // (per_sm * sms)))
    node_b = 8 * nodes * group
    data_b = 4 * cols * rows_tile
    if layout == "packed" and node_b + data_b <= STAGE_BYTES:
        stage, smem = STAGE_ALL, node_b + data_b
    else:
        stage, smem = STAGE_NONE, 0
    return TraversePlan(rows_tile, max(32, rows_tile), group, stage, smem,
                        tiles, -(-t_count // group))


def call_plan(binned: Sequence[torch.Tensor], nodes: Sequence[torch.Tensor],
              layout: str) -> TraversePlan:
    """The plan of ``traverse(binned, nodes, layout)`` on the card that
    holds ``binned``."""
    fc, n = binned[0].shape
    t_count, p = nodes[0].shape
    return traverse_plan(t_count, n, p, fc, layout,
                         sm_count(binned[0].get_device()))


def go_left(b, c, isnan, iszero, mt, dl, thr, ic, cref, cat_mask):
    """Numerical/CategoricalDecision (tree.h:257-313) on gathered rows: the
    threshold rank ``b`` and category ``c`` of the node's column, its NaN
    and zero masks, and the node's missing type, default-left flag,
    threshold rank, categorical flag and mask row (int64 indices)."""
    w = cat_mask.shape[1]
    nan_missing = (mt == MISSING_NAN) & isnan
    missing = nan_missing | ((mt == MISSING_ZERO) & iszero)
    go = torch.where(missing, dl, b <= thr)
    if not bool(ic.any()):
        return go
    in_set = cat_mask.view(-1)[cref * w + c.clamp(0, w - 1)]
    go_cat = ~nan_missing & (c >= 0) & (c < w) & in_set
    return torch.where(ic, go_cat, go)


def _descend(t_count: int, n: int, device, step) -> torch.Tensor:
    """The descent of every (tree, row) from node 0 until its child is a
    leaf: ``step(node)`` gives the next node of each active ``[T, n]``
    entry (int64), the loop stops once every entry reached a leaf (the
    data-dependent stop of ``_traverse``); int32 ``[T, n]`` leaves."""
    node = torch.zeros((t_count, n), dtype=torch.int64, device=device)
    leaf = torch.zeros_like(node)
    while True:
        active = node >= 0
        if not bool(active.any()):
            break
        nxt = step(node.clamp(min=0))
        leaf = torch.where(active & (nxt < 0), ~nxt, leaf)
        node = torch.where(active, nxt, node)
    return leaf.to(torch.int32)


def traverse_plain(bins, cats, nanm, zerom, feat, thr, dl, miss, lc, rc, ic,
                   cat_ref, cat_mask) -> torch.Tensor:
    """Plain PyTorch version of :func:`traverse`, ``xla`` layout: gathers
    over depth, one level a loop."""
    t_count, n = feat.shape[0], bins.shape[1]
    if bins.shape[0] == 0 or t_count == 0:
        # no used column: every tree is a stump, every row at leaf 0
        return torch.zeros((t_count, n), dtype=torch.int32,
                           device=bins.device)
    lc, rc, feat = lc.long(), rc.long(), feat.long()
    b64, c64 = bins.long(), cats.long()

    def step(nd):
        f = feat.gather(1, nd)
        go = go_left(b64.gather(0, f), c64.gather(0, f), nanm.gather(0, f),
                     zerom.gather(0, f), miss.gather(1, nd), dl.gather(1, nd),
                     thr.gather(1, nd), ic.gather(1, nd),
                     cat_ref.long().gather(1, nd), cat_mask)
        return torch.where(go, lc.gather(1, nd), rc.gather(1, nd))
    return _descend(t_count, n, bins.device, step)


def pack_nodes(feat, thr, dl, miss, lc, rc):
    """The two int32 node words of the packed layout
    (``lightgbm_tpu/inference.py:223-227``), int64 arithmetic on the host
    or the device."""
    w0 = (feat.long() | (thr.long() << 12) | (dl.long() << 28)
          | (miss.long() << 29)).to(torch.int32)
    w1 = ((lc.long() & 0xffff) | ((rc.long() & 0xffff) << 16)).to(
        torch.int32)
    return w0, w1


def pack_data(bins, nanm, zerom, out: Optional[torch.Tensor] = None):
    """The packed layout's data word of each (column, row), rank | nan << 24
    | zero << 25 (``lightgbm_tpu/inference.py:428``), int32; into ``out``
    when given."""
    word = (bins | (nanm.to(torch.int32) << 24)
            | (zerom.to(torch.int32) << 25))
    if out is None:
        return word
    return out.copy_(word)


def traverse_packed_plain(data, w0, w1) -> torch.Tensor:
    """Plain PyTorch version of :func:`traverse`, ``packed`` layout: the
    fields unpacked from the words a level, as ``_traverse_packed`` does."""
    t_count, n = w0.shape[0], data.shape[1]
    if data.shape[0] == 0 or t_count == 0:
        return torch.zeros((t_count, n), dtype=torch.int32,
                           device=data.device)
    w0, w1, d64 = w0.long(), w1.long(), data.long()

    def step(nd):
        v0, v1 = w0.gather(1, nd), w1.gather(1, nd)
        dw = d64.gather(0, v0 & 0xfff)
        mt = (v0 >> 29) & 3
        missing = (((mt == MISSING_NAN) & (((dw >> 24) & 1) == 1))
                   | ((mt == MISSING_ZERO) & (((dw >> 25) & 1) == 1)))
        go = torch.where(missing, ((v0 >> 28) & 1) == 1,
                         (dw & 0xffffff) <= ((v0 >> 12) & 0xffff))
        lo = v1 & 0xffff
        lo = torch.where(lo >= 0x8000, lo - 0x10000, lo)
        hi = v1 >> 16                # int64 of a sign-extended int32 word
        return torch.where(go, lo, hi)
    return _descend(t_count, n, data.device, step)


def _check(tensors: Sequence[torch.Tensor], dev: int, what: str) -> None:
    if any(t.get_device() != dev or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: contiguous tensors on one card")


def traverse(binned: Sequence[torch.Tensor], nodes: Sequence[torch.Tensor],
             layout: str = "xla",
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each tree's leaf index of every row, int32 ``[T, B]`` (into ``out``
    when given, a contiguous int32 ``[T, B]``).  ``layout="xla"``:
    ``binned = (bins, cats, nanm, zerom)`` and ``nodes = (feat, thr, dl,
    miss, lc, rc, ic, cat_ref, cat_mask)``; ``layout="packed"``: ``binned =
    (data,)`` and ``nodes = (w0, w1)`` (module docstring).  CPU tensors
    take the plain versions; CUDA tensors launch ``lgbt_traverse`` on
    their card, or raise."""
    if layout not in LAYOUTS:
        raise ValueError(f"traverse: layout must be xla or packed; got "
                         f"{layout!r}")
    first = binned[0]
    if not first.is_cuda:
        if first.device.type != "cpu":
            raise ValueError(f"traverse: unsupported device {first.device}")
        leaf = (traverse_plain(*binned, *nodes) if layout == "xla"
                else traverse_packed_plain(*binned, *nodes))
        return leaf if out is None else out.copy_(leaf)
    dev = first.get_device()
    fc, n = first.shape
    t_count, p = nodes[0].shape
    if out is None:
        out = torch.empty((t_count, n), dtype=torch.int32,
                          device=first.device)
    if layout == "xla":
        bins, cats, nanm, zerom = binned
        feat, thr, dl, miss, lc, rc, ic, cref, cmask = nodes
        int32s = (bins, cats, feat, thr, miss, lc, rc, cref, out)
        bools = (nanm, zerom, dl, ic, cmask)
        ok = (all(t.dtype == torch.int32 for t in int32s)
              and all(t.dtype == torch.bool for t in bools)
              and all(t.shape == (fc, n) for t in binned)
              and all(t.shape == (t_count, p) for t in nodes[:8])
              and cmask.dim() == 2)
        _check((*binned, *nodes, out), dev, "traverse")
        ptrs = (bins, cats, nanm, zerom, feat, thr, miss, lc, rc, cref, dl,
                ic, cmask, None, None, None, out)
        width = cmask.shape[1]
    else:
        (data,), (w0, w1) = binned, nodes
        ok = (all(t.dtype == torch.int32 for t in (data, w0, w1, out))
              and w1.shape == (t_count, p))
        _check((data, w0, w1, out), dev, "traverse")
        ptrs = (None,) * 13 + (data, w0, w1, out)
        width = 1
    if not ok or out.shape != (t_count, n) or out.dtype != torch.int32:
        raise ValueError(f"traverse ({layout}): int32 and bool tensors of "
                         f"the shapes in the module docstring")
    if t_count == 0 or n == 0:
        return out
    plan = call_plan(binned, nodes, layout)
    err = build.function("traverse", "lgbt_traverse", [ctypes.c_char_p])(
        _TRAVERSE_ARGS.pack(*(0 if t is None else t.data_ptr()
                              for t in ptrs),
                            t_count, n, p, width, LAYOUTS.index(layout), dev,
                            fc, plan.rows_tile, plan.group, plan.stage,
                            torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: CUDA error "
                           f"{err}")
    traverse.launches += 1
    traverse.layout_launches[layout] += 1
    return out


def margin_plain(leaf: torch.Tensor, leaf_value: torch.Tensor,
                 num_class: int, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`margin`: tree by tree, oldest
    first, each tree's leaf values added to its class's row of ``out``."""
    for t in range(leaf.shape[0]):
        out[t % num_class].add_(leaf_value[t].gather(0, leaf[t].long()))
    return out


def margin(leaf: torch.Tensor, leaf_value: torch.Tensor, num_class: int,
           out: torch.Tensor) -> torch.Tensor:
    """Add tree ``t``'s value at its leaf ``leaf[t]`` (int32 ``[T, B]``)
    to class ``t % num_class`` of the raw scores ``out`` (float64 ``[K,
    B]``, in place), trees oldest first, from the float64 leaf values
    ``[T, P + 1]``.  CPU tensors take :func:`margin_plain`; CUDA tensors
    launch ``lgbt_margin`` on their card, or raise."""
    if not leaf.is_cuda:
        if leaf.device.type != "cpu":
            raise ValueError(f"margin: unsupported device {leaf.device}")
        return margin_plain(leaf, leaf_value, num_class, out)
    dev = leaf.get_device()
    t_count, n = leaf.shape
    if (leaf.dtype != torch.int32 or leaf_value.dtype != torch.float64
            or out.dtype != torch.float64 or leaf_value.dim() != 2
            or leaf_value.shape[0] != t_count
            or out.shape != (num_class, n)):
        raise ValueError("margin: int32 leaf [T, B], f64 leaf_value "
                         "[T, P + 1] and f64 out [K, B]")
    _check((leaf, leaf_value, out), dev, "margin")
    if t_count == 0 or n == 0:
        return out
    err = build.function("traverse", "lgbt_margin", [ctypes.c_char_p])(
        _MARGIN_ARGS.pack(leaf.data_ptr(), leaf_value.data_ptr(),
                          out.data_ptr(), t_count, n, leaf_value.shape[1],
                          num_class, dev,
                          torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"margin kernel launch failed: CUDA error {err}")
    margin.launches += 1
    return out


# kernel launches, counted where each kernel is launched and nowhere else
traverse.launches = 0
traverse.layout_launches = {layout: 0 for layout in LAYOUTS}
margin.launches = 0
