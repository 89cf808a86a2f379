"""LambdaRank gradients: the pairwise |delta NDCG|-weighted lambdas of every
query (``lightgbm_tpu/objectives.py:405-463``, ``LambdarankNDCG``).

:func:`lambdarank_tables` builds the host tables once per dataset, as the
JAX objective's ``init`` (:365-403) builds them: each query's inverse max
DCG at ``max_position``, the label gains and the position discounts, all
float32.

:func:`lambdarank_grad` computes ``(g, h)``.  On a CUDA tensor it launches
the hand-written kernel ``csrc/lambdarank.cu`` (one block a query); on a
CPU tensor it runs :func:`lambdarank_grad_plain`, the padded, chunked
PyTorch form of the JAX program: queries taken in order of length, each
chunk padded to its longest query and bounded to ``budget`` pair
entries, each chunk one dense ``[C, D, D]`` pair matrix with the JAX
arithmetic.
"""
from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build

STAGE_MAX = 2048      # a query staged in shared memory (kStageMax)
PAIR_BUDGET = 16e6    # pair entries a chunk of the plain version (:403)


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


# the C entry point's one argument (csrc/lambdarank.cu: Args): 10 pointers,
# 2 ints, a float, an int and the stream
_ARGS = struct.Struct("@10P2ifiP")


def lambdarank_grad(score: torch.Tensor, label: torch.Tensor,
                    bounds: torch.Tensor, inv_max_dcg: torch.Tensor,
                    gains: torch.Tensor, discount: torch.Tensor,
                    sigma: float, max_len: int,
                    weight: Optional[torch.Tensor] = None,
                    chunks=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """LambdaRank ``(g, h)``, f32 ``[rows]``, of ``score`` (f32 ``[rows]``)
    for queries ``bounds`` (int32 ``[Q + 1]``) of int32 ``label``s, from the
    tables of :func:`lambdarank_tables` (``discount`` at least ``max_len``
    long, ``max_len`` the longest query), with ``weight`` (f32 ``[rows]``)
    or none.  CPU tensors take the plain version (over ``chunks``, made
    from ``bounds`` when not given); CUDA tensors launch the kernel, on
    their own card, or raise."""
    if not score.is_cuda:
        if score.device.type == "cpu":
            return lambdarank_grad_plain(score, label, bounds, inv_max_dcg,
                                         gains, discount, sigma, weight,
                                         chunks)
        raise ValueError(f"lambdarank_grad: unsupported device "
                         f"{score.device}")
    dev = score.get_device()
    n = score.numel()
    q = bounds.numel() - 1
    tensors = [score, label, bounds, inv_max_dcg, gains, discount,
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
            or (weight is not None and (weight.dtype != torch.float32
                                        or weight.shape != (n,)))):
        raise ValueError("lambdarank_grad: contiguous tensors on one card: "
                         "f32 score [rows], int32 label [rows], int32 "
                         "bounds [Q + 1], f32 inv_max_dcg [Q], f32 gains, "
                         "f32 discount [>= max_len] and f32 weight [rows] "
                         "or none")
    g = torch.empty_like(score)
    h = torch.empty_like(score)
    scratch = (torch.empty(n, dtype=torch.int32, device=score.device)
               if max_len > STAGE_MAX else None)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = build.function("lambdarank", "lgbt_lambdarank",
                         [ctypes.c_char_p])(
        _ARGS.pack(score.data_ptr(), label.data_ptr(), bounds.data_ptr(),
                   inv_max_dcg.data_ptr(), gains.data_ptr(),
                   discount.data_ptr(), ptr(weight), ptr(scratch),
                   g.data_ptr(), h.data_ptr(), q, gains.numel(),
                   float(2.0 * sigma), dev,
                   torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"lambdarank kernel launch failed: CUDA error "
                           f"{err}")
    lambdarank_grad.launches += 1
    return g, h


# kernel launches, counted where the kernel is launched and nowhere else
lambdarank_grad.launches = 0
