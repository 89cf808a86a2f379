"""LambdaRank gradients: the pairwise |delta NDCG|-weighted lambdas of every
query (``lightgbm_tpu/objectives.py:405-463``, ``LambdarankNDCG``).

:func:`lambdarank_tables` builds the host tables once per dataset, as the
JAX objective's ``init`` (:365-403) builds them: each query's inverse max
DCG at ``max_position``, the label gains and the position discounts, all
float32.  :func:`lambdarank_schedule` builds the kernel's schedule once per
dataset, from the labels and query bounds alone: each query's documents
grouped by label, highest first, and the work items of one launch.

:func:`lambdarank_grad` computes ``(g, h)``.  On a CUDA tensor it launches
the hand-written kernel ``csrc/lambdarank.cu`` over the schedule; on a CPU
tensor it runs :func:`lambdarank_grad_plain`, the padded, chunked PyTorch
form of the JAX program: queries taken in order of length, each chunk
padded to its longest query and bounded to ``budget`` pair entries, each
chunk one dense ``[C, D, D]`` pair matrix with the JAX arithmetic.
"""
from __future__ import annotations

import ctypes
import math
import struct
from dataclasses import dataclass, fields
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build

PAIR_BUDGET = 16e6    # pair entries a chunk of the plain version (:403)

# the kernel's schedule (csrc/lambdarank.cu)
MASKED_MAX = 32       # kMaskedDocs: a query this short takes one masked tile
WARP_QUERY_MAX = 256  # kWarpDocs: a query this short takes one warp
WARPS = 8             # warps a block: queries of a bundle, tiles dealt
ITEM_DOCS = 512       # kItemDocs: the documents a block item holds
TILE = 256            # kTile: a long query's tiles, TILE x TILE pairs
WARP_BUNDLE, WHOLE, PREFIX, PAIR_TILE = 0, 1, 2, 3   # item kinds


def default_label_gain(max_label: int = 31) -> List[float]:
    """``2^i - 1`` label gains (DCGCalculator::DefaultLabelGain)."""
    return [float((1 << i) - 1) for i in range(max_label)]


def lambdarank_tables(label: np.ndarray, bounds: np.ndarray,
                      label_gain: Optional[Sequence[float]],
                      max_position: int):
    """``(inv_max_dcg [Q], gains [G], discount [D])`` float32 from the
    labels and query boundaries (``lightgbm_tpu/objectives.py:368-401``):
    the max DCG truncated at ``min(max_position, D)`` documents, ``D`` the
    longest query, and ``1 / log2(i + 2)`` discounts, computed in float64
    and stored as float32."""
    bounds = np.asarray(bounds, dtype=np.int64)
    label = np.asarray(label)
    sizes = np.diff(bounds)
    D = int(sizes.max()) if len(sizes) else 1
    gains = np.asarray(label_gain or default_label_gain(), dtype=np.float64)
    k = min(max_position, D)
    discounts = 1.0 / np.log2(np.arange(D + 2, dtype=np.float64) + 2.0)
    inv = np.zeros(len(sizes), dtype=np.float64)
    for q in range(len(sizes)):
        ls = np.sort(label[bounds[q]:bounds[q + 1]])[::-1][:k]
        mdcg = float((gains[ls.astype(np.int32)] * discounts[:len(ls)]).sum())
        inv[q] = 1.0 / mdcg if mdcg > 0 else 0.0
    return (inv.astype(np.float32), gains.astype(np.float32),
            discounts[:D].astype(np.float32))


def plain_chunks(bounds: np.ndarray, budget: float = PAIR_BUDGET):
    """The plain version's chunks: ``(query ids, padded length)`` for runs
    of queries taken in order of length, each run's queries times its
    longest query squared within ``budget`` (a run of one query past it)."""
    sizes = np.diff(np.asarray(bounds, dtype=np.int64))
    order = np.argsort(sizes, kind="stable")
    chunks, cur = [], []
    for q in order:
        d = max(int(sizes[q]), 1)
        if cur and (len(cur) + 1) * d * d > budget:
            chunks.append((np.asarray(cur), max(int(sizes[cur[-1]]), 1)))
            cur = []
        cur.append(int(q))
    if cur:
        chunks.append((np.asarray(cur), max(int(sizes[cur[-1]]), 1)))
    return chunks


def lambdarank_grad_plain(score: torch.Tensor, label: torch.Tensor,
                          bounds, inv_max_dcg: torch.Tensor,
                          gains: torch.Tensor, discount: torch.Tensor,
                          sigma: float, weight: Optional[torch.Tensor] = None,
                          chunks=None, abs_sums: bool = False):
    """Plain PyTorch version of :func:`lambdarank_grad`, the JAX program's
    arithmetic over padded ``[C, D, D]`` chunks (:func:`plain_chunks`,
    given or made from ``bounds``).  With ``abs_sums`` it also returns each
    document's sums of ``|lam|`` and ``|hes|`` over its pairs, which scale
    the kernel's tolerance."""
    dev = score.device
    n = score.shape[0]
    b_host = (bounds.cpu().numpy() if isinstance(bounds, torch.Tensor)
              else np.asarray(bounds)).astype(np.int64)
    if chunks is None:
        chunks = plain_chunks(b_host)
    s_pad = torch.cat([score.float(), score.new_zeros(1, dtype=torch.float32)])
    y_pad = torch.cat([label.int(), label.new_full((1,), -1,
                                                   dtype=torch.int32)])
    outs = [torch.zeros(n + 1, dtype=torch.float32, device=dev)
            for _ in range(4 if abs_sums else 2)]
    two_sigma = float(2.0 * sigma)
    for qs, D in chunks:
        starts, sizes = b_host[qs], b_host[qs + 1] - b_host[qs]
        pos = np.arange(D)
        qidx_h = np.where(pos[None] < sizes[:, None], starts[:, None] + pos,
                          n)
        qidx = torch.from_numpy(qidx_h).to(dev)
        valid = qidx < n
        inv = inv_max_dcg.index_select(0, torch.from_numpy(qs).to(dev))
        s = torch.where(valid, s_pad[qidx], -torch.inf)
        y = torch.where(valid, y_pad[qidx], -1)
        order = torch.argsort(-s, dim=1, stable=True)
        ss = s.gather(1, order)
        sy = y.gather(1, order)
        sval = valid.gather(1, order)
        gain = gains[sy.clamp(0, gains.shape[0] - 1)]
        disc = torch.where(sval, discount[:D][None, :], 0.0)
        best = ss[:, :1]
        cnt = sval.sum(1)
        worst = ss.gather(1, (cnt - 1).clamp(min=0)[:, None])
        nondegen = best != worst
        ds = ss[:, :, None] - ss[:, None, :]
        pair = ((sy[:, :, None] > sy[:, None, :])
                & sval[:, :, None] & sval[:, None, :])
        dcg_gap = gain[:, :, None] - gain[:, None, :]
        paired_disc = torch.abs(disc[:, :, None] - disc[:, None, :])
        delta = dcg_gap * paired_disc * inv[:, None, None]
        delta = torch.where(nondegen[:, :, None],
                            delta / (0.01 + torch.abs(ds)), delta)
        p = 2.0 / (1.0 + torch.exp(two_sigma * ds))
        lam = torch.where(pair, -delta * p, 0.0)
        hes = torch.where(pair, p * (2.0 - p) * 2.0 * delta, 0.0)
        rows = qidx.gather(1, order).reshape(-1)
        per_doc = [lam.sum(2) - lam.sum(1), hes.sum(2) + hes.sum(1)]
        if abs_sums:
            la, ha = lam.abs(), hes.abs()
            per_doc += [la.sum(2) + la.sum(1), ha.sum(2) + ha.sum(1)]
        for out, v in zip(outs, per_doc):
            out.index_add_(0, rows, v.reshape(-1))
    outs = [o[:n] for o in outs]
    if weight is not None:
        outs[0] = outs[0] * weight
        outs[1] = outs[1] * weight
    return tuple(outs)


@dataclass
class LambdarankSchedule:
    """The kernel's work, from the labels and query bounds (they do not
    change during a training), as int32/float32 tensors on one device:

    - ``perm`` [rows]: grouped slot -> row.  A query's slots hold its
      documents by label, highest first, ties in their original order.
    - ``gain`` [rows]: the gain of the slot's label.
    - ``items`` [items, 8]: one block each, heaviest first: ``kind, query,
      a0, a1, c0, c1, ordinal, cost``.  ``WARP_BUNDLE``: queries
      ``warp_queries[a0:a0 + a1]``, one a warp (up to ``MASKED_MAX``
      documents one masked 32 x 32 tile, else the warp tiles of its label
      groups' rectangles).  ``WHOLE``: slots ``[0,
      a1)``, the whole query.  ``PREFIX``: slots ``[0, a1)`` of a longer
      query, whole label groups.  ``PAIR_TILE``: the pairs of high slots
      ``[a0, a1)`` and low slots ``[c0, c1)`` of one label group's
      rectangle.  ``ordinal``: the item's place among its query's partial
      sums (the prefix 0, tiles from 1 in group, low-tile, high-tile order).
    - ``qgroup`` [Q + 1], ``gstarts``: each query's label-group starts in
      slot order, then its length.
    - ``qsplit`` [Q]: a long query's index into ``split_info`` [S, 4]
      (scratch offset, items, prefix end, 0), else -1; ``tickets`` [S]
      (0 between calls) and ``scratch`` [S items x ITEM_DOCS, 2] hold its
      items' partial sums.  One call at a time uses them.
    - ``smem_docs``: the documents of the largest block item.

    The tensors are in the order of the kernel's arguments."""
    perm: torch.Tensor
    gain: torch.Tensor
    items: torch.Tensor
    warp_queries: torch.Tensor
    qgroup: torch.Tensor
    gstarts: torch.Tensor
    qsplit: torch.Tensor
    split_info: torch.Tensor
    tickets: torch.Tensor
    scratch: torch.Tensor
    smem_docs: int

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def to(self, device) -> "LambdarankSchedule":
        return LambdarankSchedule(**{
            f.name: (getattr(self, f.name).to(device)
                     if isinstance(getattr(self, f.name), torch.Tensor)
                     else getattr(self, f.name)) for f in fields(self)})


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _rect_tiles(n_low: int, n_high: int) -> int:
    """Warp tiles (32 low x 32 high documents) of a rectangle."""
    return _ceil(n_low, 32) * _ceil(n_high, 32)


def _groups(label: np.ndarray, bounds: np.ndarray):
    """Each query's label groups in slot order (highest label first):
    ``(qgroup [Q + 1], gstarts)``, the starts of a query's groups then its
    length at ``gstarts[qgroup[q]:qgroup[q + 1]]``."""
    sizes = np.diff(bounds)
    nq = len(sizes)
    qid = np.repeat(np.arange(nq), sizes)
    lo = int(label.min()) if len(label) else 0
    width = (int(label.max()) - lo + 1) if len(label) else 1
    counts = np.bincount(qid * width + (label - lo), minlength=nq * width)
    counts = counts.reshape(nq, width)[:, ::-1]          # highest first
    per_q = (counts > 0).sum(1)
    qgroup = np.concatenate([[0], np.cumsum(per_q + 1)])
    gstarts = np.empty(int(qgroup[-1]), dtype=np.int64)
    q_of, _ = np.nonzero(counts > 0)         # a query's groups, in order
    ends = np.cumsum(counts, axis=1)[counts > 0]
    gstarts[np.arange(len(q_of)) + q_of] = ends - counts[counts > 0]
    gstarts[qgroup[1:] - 1] = sizes
    return qgroup, gstarts


def _plan(sizes: np.ndarray, qgroup: np.ndarray, gstarts: np.ndarray):
    """The work items, heaviest first, the bundles' queries, each long
    query's ``split_info`` row (``qsplit`` its index) and the scratch
    slots their items take (:class:`LambdarankSchedule`)."""
    nq = len(sizes)

    def work(q: int, e: int) -> int:
        """Warp tiles of query q's rectangles within its first e slots."""
        gs = gstarts[qgroup[q]:qgroup[q + 1]].tolist()
        return sum(_rect_tiles(gs[g + 1] - gs[g], gs[g])
                   for g in range(1, len(gs) - 1) if gs[g + 1] <= e)

    items, warp_queries, split_info, qsplit = [], [], [], np.full(nq, -1)
    small = np.nonzero((sizes >= 1) & (sizes <= WARP_QUERY_MAX))[0]
    small = small[np.argsort(-sizes[small], kind="stable")].tolist()
    for i in range(0, len(small), WARPS):
        chunk = small[i:i + WARPS]
        cost = sum(1024 if sizes[q] <= MASKED_MAX else
                   1024 * work(q, int(sizes[q])) + 64 * int(sizes[q])
                   for q in chunk)
        items.append([WARP_BUNDLE, chunk[0], len(warp_queries), len(chunk),
                      0, 0, 0, cost])
        warp_queries += chunk
    slots = 0
    for q in np.nonzero(sizes > WARP_QUERY_MAX)[0]:
        q = int(q)
        m = int(sizes[q])
        if m <= ITEM_DOCS:
            items.append([WHOLE, q, 0, m, 0, 0, 0, 1024 * work(q, m) + 64 * m])
            continue
        gs = gstarts[qgroup[q]:qgroup[q + 1]].tolist()
        e = max(x for x in gs if x <= ITEM_DOCS)
        own = [[PREFIX, q, 0, e, 0, 0, 0, 1024 * work(q, e) + 64 * m]]
        for g in range(1, len(gs) - 1):
            st, en = gs[g], gs[g + 1]
            if en <= e:
                continue
            for lo in range(st, en, TILE):
                for hi in range(0, st, TILE):
                    c1, a1 = min(en, lo + TILE), min(st, hi + TILE)
                    own.append([PAIR_TILE, q, hi, a1, lo, c1, len(own),
                                1024 * _rect_tiles(c1 - lo, a1 - hi)
                                + 64 * m])
        qsplit[q] = len(split_info)
        split_info.append([slots * ITEM_DOCS, len(own), e, 0])
        slots += len(own)
        items += own
    items = np.asarray(items, dtype=np.int64).reshape(-1, 8)
    items = items[np.argsort(-items[:, 7], kind="stable")]
    return items, warp_queries, split_info, qsplit, slots


def _check_lengths(sizes: np.ndarray) -> None:
    if sizes.size and int(sizes.max()) >= 1 << 23:
        raise ValueError("lambdarank_schedule: a query of 2^23 documents or "
                         "more (the kernel's sort key holds 23 bits of "
                         "position)")


def lambdarank_schedule(label, bounds,
                        gains: Sequence[float]) -> LambdarankSchedule:
    """The kernel's schedule (:class:`LambdarankSchedule`, on the CPU) for
    int ``label`` [rows] in queries ``bounds`` [Q + 1] with the label gains
    ``gains``.  Queries of at most ``WARP_QUERY_MAX`` documents go eight to
    a block, one a warp, in order of length; up to ``ITEM_DOCS`` one a
    block; a longer one becomes a prefix of whole label groups within
    ``ITEM_DOCS`` and ``TILE x TILE`` tiles of each later group's rectangle
    (the group's documents against those before it).  Items are ordered
    by their estimated work, largest first."""
    label = np.asarray(label).astype(np.int64)
    bounds = np.asarray(bounds, dtype=np.int64)
    sizes = np.diff(bounds)
    _check_lengths(sizes)
    n = len(label)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    perm = np.lexsort((np.arange(n), -label, qid))
    gains = np.asarray(gains, dtype=np.float32)
    gain = gains[np.clip(label[perm], 0, len(gains) - 1)]
    qgroup, gstarts = _groups(label, bounds)
    items, warp_queries, split_info, qsplit, slots = _plan(sizes, qgroup,
                                                           gstarts)
    block = items[items[:, 0] != WARP_BUNDLE]
    docs = np.where(block[:, 0] == PAIR_TILE,
                    block[:, 3] - block[:, 2] + block[:, 5] - block[:, 4],
                    block[:, 3])
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a,
                                                          dtype=np.int32))
    return LambdarankSchedule(
        perm=i32(perm), gain=torch.from_numpy(gain.astype(np.float32)),
        items=i32(np.minimum(items, 2 ** 31 - 1)),
        warp_queries=i32(warp_queries), qgroup=i32(qgroup),
        gstarts=i32(gstarts), qsplit=i32(qsplit),
        split_info=i32(np.asarray(split_info).reshape(-1, 4)),
        tickets=torch.zeros(len(split_info), dtype=torch.int32),
        scratch=torch.zeros(slots * ITEM_DOCS * 2, dtype=torch.float32),
        smem_docs=max(int(docs.max()), 1) if len(block) else 0)


def schedule_bytes(label, bounds) -> int:
    """The device bytes of :func:`lambdarank_schedule`'s tensors for these
    labels and bounds, from their label groups alone (the memory model's
    term; no permutation is built)."""
    label = np.asarray(label).astype(np.int64)
    bounds = np.asarray(bounds, dtype=np.int64)
    sizes = np.diff(bounds)
    _check_lengths(sizes)
    qgroup, gstarts = _groups(label, bounds)
    items, warp_queries, split_info, qsplit, slots = _plan(sizes, qgroup,
                                                           gstarts)
    return 4 * (2 * len(label) + items.size + len(warp_queries)
                + len(qgroup) + len(gstarts) + len(qsplit)
                + 5 * len(split_info) + 2 * slots * ITEM_DOCS)


# the C entry point's one argument (csrc/lambdarank.cu: Args): 18 pointers,
# 2 ints, a float, an int and the stream
_ARGS = struct.Struct("@18P2ifiP")


def lambdarank_grad(score: torch.Tensor, label: torch.Tensor,
                    bounds: torch.Tensor, inv_max_dcg: torch.Tensor,
                    gains: torch.Tensor, discount: torch.Tensor,
                    sigma: float, max_len: int,
                    weight: Optional[torch.Tensor] = None,
                    chunks=None,
                    schedule: Optional[LambdarankSchedule] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LambdaRank ``(g, h)``, f32 ``[rows]``, of ``score`` (f32 ``[rows]``)
    for queries ``bounds`` (int32 ``[Q + 1]``) of int32 ``label``s, from the
    tables of :func:`lambdarank_tables` (``discount`` at least ``max_len``
    long, ``max_len`` the longest query), with ``weight`` (f32 ``[rows]``)
    or none.  CPU tensors take the plain version (over ``chunks``, made
    from ``bounds`` when not given); CUDA tensors launch the kernel, on
    their own card, over ``schedule`` (:func:`lambdarank_schedule` of the
    same labels and bounds, on that card), or raise."""
    if not score.is_cuda:
        if score.device.type == "cpu":
            return lambdarank_grad_plain(score, label, bounds, inv_max_dcg,
                                         gains, discount, sigma, weight,
                                         chunks)
        raise ValueError(f"lambdarank_grad: unsupported device "
                         f"{score.device}")
    if schedule is None:
        raise ValueError("lambdarank_grad: a CUDA call needs the schedule "
                         "of lambdarank_schedule(label, bounds, gains)")
    dev = score.get_device()
    n = score.numel()
    q = bounds.numel() - 1
    tensors = [score, label, bounds, inv_max_dcg, gains, discount,
               *schedule.tensors(),
               *([weight] if weight is not None else [])]
    if (any(t.get_device() != dev or not t.is_contiguous() for t in tensors)
            or score.dtype != torch.float32 or score.dim() != 1
            or label.dtype != torch.int32 or label.shape != (n,)
            or bounds.dtype != torch.int32 or q < 0
            or inv_max_dcg.dtype != torch.float32
            or inv_max_dcg.shape != (q,)
            or gains.dtype != torch.float32 or gains.numel() < 1
            or discount.dtype != torch.float32
            or discount.numel() < max_len
            or schedule.perm.shape != (n,) or schedule.gain.shape != (n,)
            or schedule.qsplit.shape != (q,)
            or (weight is not None and (weight.dtype != torch.float32
                                        or weight.shape != (n,)))):
        raise ValueError("lambdarank_grad: contiguous tensors on one card: "
                         "f32 score [rows], int32 label [rows], int32 "
                         "bounds [Q + 1], f32 inv_max_dcg [Q], f32 gains, "
                         "f32 discount [>= max_len], f32 weight [rows] or "
                         "none, and the schedule of these labels")
    if not sigma > 0:
        raise ValueError(f"lambdarank_grad: sigmoid {sigma} must be > 0")
    g = torch.empty_like(score)
    h = torch.empty_like(score)
    s = schedule
    err = build.function("lambdarank", "lgbt_lambdarank",
                         [ctypes.c_char_p])(
        _ARGS.pack(score.data_ptr(), label.data_ptr(), bounds.data_ptr(),
                   inv_max_dcg.data_ptr(), discount.data_ptr(),
                   0 if weight is None else weight.data_ptr(),
                   *(t.data_ptr() for t in s.tensors()),
                   g.data_ptr(), h.data_ptr(), s.items.shape[0],
                   s.smem_docs, float(2.0 * sigma / math.log(2.0)), dev,
                   torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"lambdarank kernel launch failed: CUDA error "
                           f"{err}")
    lambdarank_grad.launches += 1
    return g, h


# kernel launches, counted where the kernel is launched and nowhere else
lambdarank_grad.launches = 0
