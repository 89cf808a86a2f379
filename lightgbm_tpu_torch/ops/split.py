"""Best-split scan over feature histograms, fused form.

The port of ``lightgbm_tpu/ops/split.py``'s fused scan (``make_fused_ctx``
:355, ``_fused_numerical`` :382, ``best_split`` :609), itself
``FeatureHistogram::FindBestThresholdNumerical`` /
``FindBestThresholdSequence`` (``src/treelearner/feature_histogram.hpp:
82-418``) as one tensor program over all features, batched over a leading
leaf axis K (the grower scans both children of a split in one call).
Numerical features:

* the two scan directions are two cumulative sums over the bin axis;
* the reference's ``continue``/``break`` guards are masks;
* missing values (none / zero / NaN) select which bins feed each side and
  which thresholds are candidates;
* ties break as the reference scan order: smallest feature index, then
  direction -1 (missing left) before +1, the -1 scan preferring the
  largest threshold and the +1 scan the smallest.

Categorical features (``FindBestThresholdCategorical``,
feature_histogram.hpp:104-223; JAX ``_categorical_candidates`` :188,
``_cat_result_from_index`` :557, ``_combine_categorical`` :672): each
feature's bins are sorted by their smoothed gradient / hessian ratio, the
candidates are prefixes of that order and of its reverse, up to
``max_cat_threshold`` of them, gated by the ``max_cat_group`` accounting,
and the best one is a set of bins routed left.  The accounting is a
sequential loop over candidate positions (a ``lax.scan`` in the JAX
package, :300): :func:`cat_group_accept` launches the hand-written kernel
``csrc/cat_group.cu`` for CUDA tensors and runs the loop in plain PyTorch
(:func:`cat_group_accept_plain`) for CPU tensors.

Gain = ``G(left) + G(right) - G(parent) - min_gain_to_split`` with
``G(s, h) = max(0, |s| - l1)^2 / (h + l2)`` (feature_histogram.hpp:255-262).
The arithmetic follows the JAX scan operation for operation, so equal
histograms whose sums are exact give equal results.
"""
from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional

import torch

from . import build

K_EPSILON = 1e-15  # reference kEpsilon
MISSING_NONE, MISSING_ZERO, MISSING_NAN = 0, 1, 2


class SplitConfig(NamedTuple):
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    has_missing: bool = True    # False skips the dir=+1 scan (no feature
    #                             is two-directional without missing values)
    has_categorical: bool = False   # False skips the categorical scan
    max_cat_threshold: int = 256
    max_cat_group: int = 64
    cat_smooth_ratio: float = 0.01
    min_cat_smooth: float = 5.0
    max_cat_smooth: float = 100.0


class SplitResult(NamedTuple):
    """Best split of K leaves, one entry per leaf (SplitInfo,
    src/treelearner/split_info.hpp:17-120)."""
    found: torch.Tensor         # [K] bool
    gain: torch.Tensor          # [K] f32, reduced by the gain shift; -inf if none
    feature: torch.Tensor       # [K] i64 column index; -1 if none
    threshold: torch.Tensor     # [K] i64 bin threshold (left: bin <= threshold)
    default_left: torch.Tensor  # [K] bool
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor
    is_cat: torch.Tensor        # [K] bool: categorical split (a bin set)
    cat_bins: torch.Tensor      # [K, B] bool: bins routed left (cat only)


class FusedSplitCtx(NamedTuple):
    """Masks of the scan that depend only on feature metadata, built once
    per tree.  ``keep_p1``/``cand_p1``/``force_right`` are None when the
    dataset has no missing values (no dir=+1 scan); the categorical fields
    are None when it has no categorical feature."""
    keep_m1: torch.Tensor               # [F, B] bool: bins feeding dir=-1
    cand_m1: torch.Tensor               # [F, B] bool: dir=-1 candidacy
    keep_p1: Optional[torch.Tensor]     # [F, B] bool
    cand_p1: Optional[torch.Tensor]     # [F, B] bool
    force_right: Optional[torch.Tensor]  # [F] bool: 2-bin NaN features
    is_cat: Optional[torch.Tensor] = None       # [F] bool
    cat_num_bin: Optional[torch.Tensor] = None  # [F] i32
    cat_used_bin: Optional[torch.Tensor] = None  # [F] i64: bins scanned
    cat_dir_m1: Optional[torch.Tensor] = None   # [F] bool: dir=-1 scanned


def cat_group_accept_plain(step: torch.Tensor, ok: torch.Tensor,
                           right_count: torch.Tensor, mdpg0: torch.Tensor,
                           max_cat_group: int) -> torch.Tensor:
    """The max_cat_group accounting over positions (the last axis), lane by
    lane: accept position t when ``ok`` holds and the count accumulated
    since the last accept reaches the minimum group size; an accept resets
    the count, spends a group and, while groups remain, sets the minimum
    to ``max(1, floor(right_count[t] / groups_left))``.  Returns the bool
    accepts, shaped like ``ok``."""
    dtype = step.dtype
    accept = torch.zeros_like(ok)
    cnt = torch.zeros(ok.shape[:-1], dtype=dtype, device=ok.device)
    rest = torch.full_like(cnt, float(max_cat_group))
    mdpg = mdpg0.to(dtype)
    for t in range(ok.shape[-1]):
        cnt = cnt + step[..., t]
        acc = ok[..., t] & (cnt >= mdpg)
        accept[..., t] = acc
        rest = rest - acc.to(dtype)
        mdpg = torch.where(acc & (rest > 0), torch.clamp(torch.floor(
            right_count[..., t] / torch.clamp(rest, min=1.0)), min=1.0), mdpg)
        cnt = torch.where(acc, 0.0, cnt)
    return accept


# the C entry point's one argument (csrc/cat_group.cu: Args): 5 pointers,
# the lanes, 3 ints, max_cat_group, padding and the stream
_GROUP_ARGS = struct.Struct("@5Pq3ifiP")


def _mdpg_group(m0: torch.Tensor, ok: torch.Tensor) -> int:
    """Lanes that share one entry of ``m0``: its shape must be ``ok``'s
    without the last axis, or a prefix of it followed by 1s (one value a
    leaf, ``[K, 1, 1]``).  0 when it is neither."""
    lead = ok.shape[:-1]
    if m0.dim() != len(lead):
        return 0
    d = len(lead)
    while d and m0.shape[d - 1] == 1 and lead[d - 1] != 1:
        d -= 1
    if m0.shape[:d] != lead[:d] or any(s != 1 for s in m0.shape[d:]):
        return 0
    return max(1, ok.numel() // max(ok.shape[-1], 1) // max(m0.numel(), 1))


def cat_group_accept(step: torch.Tensor, ok: torch.Tensor,
                     right_count: torch.Tensor, mdpg0: torch.Tensor,
                     max_cat_group: int) -> torch.Tensor:
    """:func:`cat_group_accept_plain` for ``[..., T]`` inputs (``ok`` and
    the result ``torch.bool``; ``mdpg0`` shaped like ``ok`` without its
    last axis, or broadcast along its trailing axes, as ``[K, 1, 1]``):
    CPU tensors take the plain loop; CUDA tensors launch the kernel, on
    their own card, or raise."""
    if not ok.is_cuda:
        if ok.device.type == "cpu":
            return cat_group_accept_plain(step, ok, right_count, mdpg0,
                                          max_cat_group)
        raise ValueError(f"cat_group_accept: unsupported device {ok.device}")
    dev = ok.get_device()
    for t in (step, right_count, mdpg0):
        if t.dtype != torch.float32 or t.get_device() != dev:
            raise TypeError("cat_group_accept: step, right_count and mdpg0 "
                            "must be float32 on ok's card")
    group = _mdpg_group(mdpg0, ok)
    if (ok.dtype != torch.bool or step.shape != ok.shape
            or right_count.shape != ok.shape or not group
            or not (step.is_contiguous() and ok.is_contiguous()
                    and right_count.is_contiguous()
                    and mdpg0.is_contiguous())):
        raise ValueError("cat_group_accept: step, ok (bool) and right_count "
                         "must be contiguous of one shape, mdpg0 that shape "
                         "without its last axis or broadcast along its "
                         "trailing axes")
    positions = ok.shape[-1]
    lanes = ok.numel() // max(positions, 1)
    accept = torch.empty_like(ok)
    # the C side makes the tensors' card current only if it is not
    err = build.function("cat_group", "lgbt_cat_group", [ctypes.c_char_p])(
        _GROUP_ARGS.pack(step.data_ptr(), ok.data_ptr(),
                         right_count.data_ptr(), mdpg0.data_ptr(),
                         accept.data_ptr(), lanes, positions, group, dev,
                         float(max_cat_group), 0,
                         torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"cat_group kernel launch failed: CUDA error "
                           f"{err}")
    cat_group_accept.launches += 1
    return accept


# kernel launches, counted where the kernel is launched and nowhere else
cat_group_accept.launches = 0


def leaf_split_gain(sum_g, sum_h, l1, l2):
    """G(s, h) with L1 soft-thresholding (feature_histogram.hpp:255-262)."""
    reg = torch.clamp(torch.abs(sum_g) - l1, min=0.0)
    return reg * reg / (sum_h + l2)


def leaf_output(sum_g, sum_h, l1, l2):
    """Leaf weight -sign(s)*max(0,|s|-l1)/(h+l2) (feature_histogram.hpp:269-274)."""
    reg = torch.clamp(torch.abs(sum_g) - l1, min=0.0)
    return -torch.sign(sum_g) * reg / (sum_h + l2)


def make_fused_ctx(num_bin: torch.Tensor, missing_type: torch.Tensor,
                   default_bin: torch.Tensor, num_bins: int,
                   cfg: SplitConfig,
                   is_cat: Optional[torch.Tensor] = None) -> FusedSplitCtx:
    """Build the loop-invariant masks of the scan (split.py:355), and the
    categorical scan's per-feature constants when ``cfg.has_categorical``
    (``is_cat`` then flags the categorical features)."""
    ctx = _numerical_ctx(num_bin, missing_type, default_bin, num_bins, cfg)
    if not cfg.has_categorical:
        return ctx
    # used_bin = num_bin - 1 + (missing == None): the overflow/NaN bin is
    # scanned only when the mapper kept every category
    used_bin = (num_bin.long() - 1
                + (missing_type == MISSING_NONE).long())
    dir_m1 = ~((missing_type == MISSING_NONE)
               & (2 * cfg.max_cat_threshold >= num_bin))
    return ctx._replace(is_cat=is_cat, cat_num_bin=num_bin,
                        cat_used_bin=used_bin, cat_dir_m1=dir_m1)


def _numerical_ctx(num_bin, missing_type, default_bin, num_bins: int,
                   cfg: SplitConfig) -> FusedSplitCtx:
    f = num_bin.shape[0]
    bins = torch.arange(num_bins, device=num_bin.device).expand(f, num_bins)
    nb = num_bin[:, None].long()
    mt = missing_type[:, None].long()
    db = default_bin[:, None].long()
    nan_bin = nb - 1
    two_dir = (nb > 2) & (mt != MISSING_NONE)
    na_excl = two_dir & (mt == MISSING_NAN)
    zero_skip = two_dir & (mt == MISSING_ZERO)
    keep_m1 = ~((zero_skip & (bins == db)) | (na_excl & (bins == nan_bin)))
    cand_m1 = ((bins <= nb - 2 - na_excl.long())
               & ~(zero_skip & (bins == db - 1)))
    if not cfg.has_missing:
        return FusedSplitCtx(keep_m1, cand_m1, None, None, None)
    keep_p1 = ~(zero_skip & (bins == db))
    cand_p1 = two_dir & (bins <= nb - 2) & ~(zero_skip & (bins == db))
    force_right = (num_bin <= 2) & (missing_type == MISSING_NAN)
    return FusedSplitCtx(keep_m1, cand_m1, keep_p1, cand_p1, force_right)


def _constants(cfg: SplitConfig):
    """The scan's scalar constants as Python floats: ``(l1, l2, min_data,
    min_hess, -inf)``.  A float32 tensor meets them in float32, as it meets
    a 0-dim float32 tensor, and they reach a kernel as its arguments: no
    host-to-device copy, so the scan can be captured in a CUDA graph."""
    return (float(cfg.lambda_l1), float(cfg.lambda_l2),
            float(cfg.min_data_in_leaf), float(cfg.min_sum_hessian_in_leaf),
            float("-inf"))


def _numerical_scan(hist: torch.Tensor, pg: torch.Tensor, ph: torch.Tensor,
                    pc: torch.Tensor, num_valid: torch.Tensor,
                    cfg: SplitConfig, ctx: FusedSplitCtx):
    """Both scan directions of the numerical features: each feature's best
    candidate gain (not yet reduced by the shift) and its position, with
    the left sums of every candidate.  The parent sums ``pg``, ``ph``,
    ``pc`` are ``[K, 1, 1]``, a leaf's, or ``[K, F, 1]``, one a feature
    (the voting learner's local sums).  Returns ``(gm, jm, lg_m1, lh_m1,
    lc_m1)`` and, with missing values, ``(gp, jp, lg_p1, lh_p1, lc_p1)``
    after them."""
    k, f = hist.shape[:2]
    l1, l2, min_data, min_hess, neg_inf = _constants(cfg)
    tot_h = ph + 2.0 * K_EPSILON
    min_gain_shift = leaf_split_gain(pg, tot_h, l1, l2) + cfg.min_gain_to_split
    valid = num_valid.view(k, f, 1)

    def eval_gains(left_g, left_h, left_c, cand):
        right_g = pg - left_g
        right_h = tot_h - left_h
        right_c = pc - left_c
        ok = (cand
              & (left_c >= min_data) & (right_c >= min_data)
              & (left_h >= min_hess) & (right_h >= min_hess))
        gain = (leaf_split_gain(left_g, left_h, l1, l2)
                + leaf_split_gain(right_g, right_h, l1, l2))
        ok = ok & (gain > min_gain_shift)
        return torch.where(ok, gain, neg_inf)

    # ---- dir = -1: accumulate from the right; missing defaults LEFT ----
    kept = (torch.where(ctx.keep_m1[None, :, :, None], hist, 0.0)
            if cfg.has_missing else hist)
    right_m1 = (kept.sum(dim=2, keepdim=True) - torch.cumsum(kept, dim=2))
    lg_m1 = pg - right_m1[..., 0]
    lh_m1 = tot_h - (right_m1[..., 1] + K_EPSILON)
    lc_m1 = pc - right_m1[..., 2]
    gains_m1 = eval_gains(lg_m1, lh_m1, lc_m1, valid & ctx.cand_m1[None])
    # largest threshold first: the first max over the REVERSED gains
    flipped_m1 = torch.flip(gains_m1, dims=[2])
    out = (torch.amax(flipped_m1, dim=2), torch.argmax(flipped_m1, dim=2),
           lg_m1, lh_m1, lc_m1)
    if not cfg.has_missing:
        return out
    # ---- dir = +1: accumulate from the left; missing defaults RIGHT ----
    kept = torch.where(ctx.keep_p1[None, :, :, None], hist, 0.0)
    left_p1 = torch.cumsum(kept, dim=2)
    lg_p1 = left_p1[..., 0]
    lh_p1 = left_p1[..., 1] + K_EPSILON
    lc_p1 = left_p1[..., 2]
    gains_p1 = eval_gains(lg_p1, lh_p1, lc_p1, valid & ctx.cand_p1[None])
    return out + (torch.amax(gains_p1, dim=2), torch.argmax(gains_p1, dim=2),
                  lg_p1, lh_p1, lc_p1)


def select_ctx(ctx: FusedSplitCtx, idx: torch.Tensor) -> FusedSplitCtx:
    """The scan's masks of the features ``idx`` (in that order), as
    :func:`make_fused_ctx` would build them for those features alone."""
    return FusedSplitCtx(*[None if t is None else t.index_select(0, idx)
                           for t in ctx])


def per_feature_best_gain(hist: torch.Tensor, parent_g: torch.Tensor,
                          parent_h: torch.Tensor, parent_c: torch.Tensor,
                          feat_valid: torch.Tensor, cfg: SplitConfig,
                          ctx: FusedSplitCtx) -> torch.Tensor:
    """Each feature's best gain less its shift, ``-inf`` where none
    (``lightgbm_tpu/ops/split.py:705``): the voting learner's local vote
    (``voting_parallel_tree_learner.cpp:255-330``).  hist ``[K, F, B,
    3]``; the parent sums ``[K, F]``, one a feature; feat_valid ``[K,
    F]``."""
    k, f = hist.shape[:2]
    l1, l2 = float(cfg.lambda_l1), float(cfg.lambda_l2)
    use_cat = cfg.has_categorical and ctx.is_cat is not None
    num_valid = feat_valid & ~ctx.is_cat if use_cat else feat_valid
    pg, ph, pc = (p.view(k, f, 1) for p in (parent_g, parent_h, parent_c))
    scan = _numerical_scan(hist, pg, ph, pc, num_valid, cfg, ctx)
    best = torch.maximum(scan[0], scan[5]) if cfg.has_missing else scan[0]
    shift = (leaf_split_gain(parent_g, parent_h + 2.0 * K_EPSILON, l1, l2)
             + cfg.min_gain_to_split)
    neg_inf = float("-inf")
    out = torch.where(best > neg_inf, best - shift, neg_inf)
    if not use_cat:
        return out
    gain2, c_shift = _categorical_gains(hist, parent_g, parent_h, parent_c,
                                        feat_valid, cfg, ctx)[:2]
    cbest = gain2.reshape(k, f, -1).amax(dim=2)
    return torch.maximum(out, torch.where(cbest > neg_inf, cbest - c_shift,
                                          neg_inf))


def best_split(hist: torch.Tensor, parent_g: torch.Tensor,
               parent_h: torch.Tensor, parent_c: torch.Tensor,
               feat_valid: torch.Tensor, cfg: SplitConfig,
               ctx: FusedSplitCtx):
    """Best split of K leaves (split.py:609 with ``split_find=fused``):
    numerical, or categorical when ``cfg.has_categorical`` and ``ctx``
    flags categorical features.

    hist ``[K, F, B, 3]`` (sum_g, sum_h, count); parent_g/h/c ``[K]``;
    feat_valid ``[K, F]`` bool.  Returns ``(SplitResult, feat_ok [K, F])``
    where feat_ok flags the features that produced any candidate beating
    the gain shift (the reference's subtree feature pruning,
    serial_tree_learner.cpp:406-417)."""
    k, f, b, _ = hist.shape
    dev = hist.device
    l1, l2, min_data, min_hess, neg_inf = _constants(cfg)
    tot_h_k = parent_h + 2.0 * K_EPSILON                       # [K]
    min_gain_shift_k = (leaf_split_gain(parent_g, tot_h_k, l1, l2)
                        + cfg.min_gain_to_split)               # [K]
    use_cat = cfg.has_categorical and ctx.is_cat is not None
    num_valid = feat_valid & ~ctx.is_cat if use_cat else feat_valid
    scan = _numerical_scan(hist, parent_g.view(k, 1, 1),
                           parent_h.view(k, 1, 1), parent_c.view(k, 1, 1),
                           num_valid, cfg, ctx)
    gm, jm, lg_m1, lh_m1, lc_m1 = scan[:5]
    if cfg.has_missing:
        gp, jp, lg_p1, lh_p1, lc_p1 = scan[5:]
        best_f = torch.maximum(gm, gp)          # per feature, dir=-1 first
    else:
        best_f = gm

    # smallest feature index wins ties (argmax returns the first maximum)
    fi = torch.argmax(best_f, dim=1)                           # [K]
    ar = torch.arange(k, device=dev)
    best_gain = best_f[ar, fi]
    found = best_gain > neg_inf

    bin_m1 = b - 1 - jm[ar, fi]
    if cfg.has_missing:
        use_m1 = gm[ar, fi] >= gp[ar, fi]       # ties: dir=-1 precedes +1
        pos_p1 = jp[ar, fi]
        threshold = torch.where(use_m1, bin_m1, pos_p1)
        left_sum_g = torch.where(use_m1, lg_m1[ar, fi, bin_m1],
                                 lg_p1[ar, fi, pos_p1])
        left_sum_h_raw = torch.where(use_m1, lh_m1[ar, fi, bin_m1],
                                     lh_p1[ar, fi, pos_p1])
        left_count = torch.where(use_m1, lc_m1[ar, fi, bin_m1],
                                 lc_p1[ar, fi, pos_p1])
        default_left = torch.where(found, use_m1, True)
        # 2-bin NaN features always default right
        default_left = torch.where(found & ctx.force_right[fi], False,
                                   default_left)
    else:
        threshold = bin_m1
        left_sum_g = lg_m1[ar, fi, bin_m1]
        left_sum_h_raw = lh_m1[ar, fi, bin_m1]
        left_count = lc_m1[ar, fi, bin_m1]
        default_left = torch.ones(k, dtype=torch.bool, device=dev)

    right_sum_g = parent_g - left_sum_g
    right_sum_h_raw = tot_h_k - left_sum_h_raw
    right_count = parent_c - left_count
    res = SplitResult(
        found=found,
        gain=torch.where(found, best_gain - min_gain_shift_k, neg_inf),
        feature=torch.where(found, fi, -1),
        threshold=torch.where(found, threshold, 0),
        default_left=default_left,
        left_sum_g=left_sum_g,
        left_sum_h=left_sum_h_raw - K_EPSILON,
        left_count=left_count,
        right_sum_g=right_sum_g,
        right_sum_h=right_sum_h_raw - K_EPSILON,
        right_count=right_count,
        left_output=leaf_output(left_sum_g, left_sum_h_raw, l1, l2),
        right_output=leaf_output(right_sum_g, right_sum_h_raw, l1, l2),
        is_cat=torch.zeros(k, dtype=torch.bool, device=dev),
        cat_bins=torch.zeros((k, b), dtype=torch.bool, device=dev),
    )
    num_ok = best_f > neg_inf
    if not use_cat:
        return res, num_ok
    cat_res, cat_ok = _categorical_best(hist, parent_g, parent_h, parent_c,
                                        feat_valid, cfg, ctx)
    # features are numerical or categorical; the smallest feature index
    # wins a tie (the serial learner's feature-major order)
    pick_cat = cat_res.found & (~res.found | (cat_res.gain > res.gain)
                                | ((cat_res.gain == res.gain)
                                   & (cat_res.feature < res.feature)))
    res = SplitResult(*[
        torch.where(pick_cat.view(-1, *([1] * (a.dim() - 1))), c, a)
        for a, c in zip(res, cat_res)])
    return res, torch.where(ctx.is_cat[None], cat_ok, num_ok)


def _categorical_gains(hist, parent_g, parent_h, parent_c, feat_valid,
                       cfg: SplitConfig, ctx: FusedSplitCtx):
    """Every categorical candidate's gain, ``[K, F, 2, T]`` (split.py:188):
    returns ``(gain2, min_gain_shift, order, lg2, lh2, lc2, tot_h)``.
    The parent sums are ``[K]``, a leaf's, or ``[K, F]``, one a feature
    (the voting learner's local sums); ``min_gain_shift`` and ``tot_h``
    are ``[K, 1]`` or ``[K, F]`` then."""
    k, f, b, _ = hist.shape
    dev = hist.device
    t_max = min(int(cfg.max_cat_threshold), b)
    l1, l2, min_data, min_hess, neg_inf = _constants(cfg)
    used_bin = ctx.cat_used_bin                                 # [F]
    pg = parent_g.view(k, -1)
    ph = parent_h.view(k, -1)
    pc = parent_c.view(k, -1)
    tot_h = ph + 2.0 * K_EPSILON                                # [K, 1|F]
    min_gain_shift = leaf_split_gain(pg, tot_h, l1, l2) + cfg.min_gain_to_split

    # smoothing (feature_histogram.hpp:122-126)
    smooth_hess = torch.clamp(torch.clamp(
        cfg.cat_smooth_ratio * pc / torch.clamp(ctx.cat_num_bin, min=1),
        min=cfg.min_cat_smooth), max=cfg.max_cat_smooth)        # [K, F]
    smooth_grad = smooth_hess * pg / torch.where(ph == 0, 1.0, ph)
    bins = torch.arange(b, device=dev)
    in_scan = bins[None, :] < used_bin[:, None]                 # [F, B]
    key = ((hist[..., 0] + smooth_grad[..., None])
           / (hist[..., 1] + smooth_hess[..., None]))
    key = torch.where(in_scan, key, float("inf"))   # unscanned bins last
    order = torch.argsort(key, dim=2, stable=True)              # [K, F, B]
    shist = torch.gather(hist, 2, order[..., None].expand(-1, -1, -1, 3))
    cs = torch.cumsum(shist, dim=2)                             # [K, F, B, 3]

    def at(a, idx):
        """``a [K, F, B, ...]`` at per-feature bin positions ``idx [F, T]``."""
        ix = idx[None].expand(k, -1, -1)
        if a.dim() == 4:
            return torch.gather(a, 2, ix[..., None].expand(-1, -1, -1, 3))
        return torch.gather(a, 2, ix)

    last = torch.clamp(used_bin - 1, 0, b - 1)[:, None]         # [F, 1]
    tot = at(cs, last)[:, :, 0]                                 # [K, F, 3]
    pos = torch.arange(t_max, device=dev)
    # dir=+1: prefixes of the sorted order
    take_p1 = torch.clamp(pos, max=b - 1)[None].expand(f, -1)   # [F, T]
    pre_p1 = at(cs, take_p1)                                    # [K, F, T, 3]
    step_p1 = at(shist[..., 2], take_p1)                        # [K, F, T]
    # dir=-1: prefixes of the reversed order = totals minus cumsum at
    # used_bin - 2 - i
    idx_m1 = used_bin[:, None] - 2 - pos[None, :]               # [F, T]
    pre_m1 = torch.where((idx_m1 >= 0)[None, :, :, None],
                         at(cs, torch.clamp(idx_m1, 0, b - 1)), 0.0)
    lr_m1 = tot[:, :, None, :] - pre_m1
    step_m1 = at(shist[..., 2],
                 torch.clamp(used_bin[:, None] - 1 - pos[None, :], 0, b - 1))

    cat_ok = feat_valid & ctx.is_cat[None]                      # [K, F]
    base_valid = cat_ok[..., None] & (pos[None, :] < used_bin[:, None])
    # [K, F, 2, T]: direction +1 then -1
    left = torch.stack([pre_p1, lr_m1], dim=2)
    lg2 = left[..., 0]
    lh2 = left[..., 1] + K_EPSILON
    lc2 = left[..., 2]
    step_c = torch.stack([step_p1, step_m1], dim=2)
    valid2 = torch.stack([base_valid,
                          base_valid & ctx.cat_dir_m1[None, :, None]], dim=2)
    rg2 = pg[:, :, None, None] - lg2
    rh2 = tot_h[:, :, None, None] - lh2
    rc2 = pc[:, :, None, None] - lc2
    cont_ok = (lc2 >= min_data) & (lh2 >= min_hess)
    right_ok = (rc2 >= min_data) & (rh2 >= min_hess)

    # max_cat_group gating: sequential accounting over the candidate
    # positions (feature_histogram.hpp:142-147,169-177)
    both_ok = cont_ok & right_ok
    mdpg0 = torch.clamp(torch.floor(pc / cfg.max_cat_group),
                        min=1.0)[..., None]                 # [K, 1|F, 1]
    accept = cat_group_accept(step_c, both_ok, rc2, mdpg0,
                              cfg.max_cat_group)

    gain2 = (leaf_split_gain(lg2, lh2, l1, l2)
             + leaf_split_gain(rg2, rh2, l1, l2))
    ok = (valid2 & both_ok & accept
          & (gain2 > min_gain_shift[:, :, None, None]))
    return (torch.where(ok, gain2, neg_inf), min_gain_shift, order, lg2,
            lh2, lc2, tot_h)


def _categorical_best(hist, parent_g, parent_h, parent_c, feat_valid,
                      cfg: SplitConfig, ctx: FusedSplitCtx):
    """Best categorical split of K leaves (split.py:188 candidates, :557
    result): returns ``(SplitResult, cat_ok [K, F])``.

    Candidate order per feature: dir=+1 positions ascending, then dir=-1
    positions ascending (the reference's ``dirs = {1, -1}`` loop); the
    first maximum wins."""
    k, f, b, _ = hist.shape
    dev = hist.device
    t_max = min(int(cfg.max_cat_threshold), b)
    l1, l2 = float(cfg.lambda_l1), float(cfg.lambda_l2)
    neg_inf = float("-inf")
    used_bin = ctx.cat_used_bin
    bins = torch.arange(b, device=dev)
    gain2, min_gain_shift, order, lg2, lh2, lc2, tot_h = _categorical_gains(
        hist, parent_g, parent_h, parent_c, feat_valid, cfg, ctx)
    flat = gain2.reshape(k, -1)
    idx = torch.argmax(flat, dim=1)                             # [K]
    ar = torch.arange(k, device=dev)
    best_gain = flat[ar, idx]
    found = best_gain > neg_inf
    fi = idx // (2 * t_max)
    rem = idx % (2 * t_max)
    is_p1 = rem < t_max
    p = (rem % t_max)[:, None]
    ub = used_bin[fi][:, None]
    # bins routed left: sorted positions [0..p] (dir=+1) or
    # [ub-1-p..ub-1] (dir=-1); rank = the sort's inverse permutation
    order_row = order[ar, fi]                                   # [K, B]
    rank = torch.empty_like(order_row).scatter_(
        1, order_row, bins[None].expand(k, -1).contiguous())
    member = torch.where(is_p1[:, None], rank <= p,
                         rank >= ub - 1 - p) & (rank < ub)
    left_sum_g = lg2.reshape(k, -1)[ar, idx]
    left_sum_h_raw = lh2.reshape(k, -1)[ar, idx]
    left_count = lc2.reshape(k, -1)[ar, idx]
    right_sum_g = parent_g - left_sum_g
    right_sum_h_raw = tot_h[:, 0] - left_sum_h_raw
    right_count = parent_c - left_count
    res = SplitResult(
        found=found,
        gain=torch.where(found, best_gain - min_gain_shift[:, 0], neg_inf),
        feature=torch.where(found, fi, -1),
        threshold=torch.zeros(k, dtype=torch.int64, device=dev),
        default_left=torch.zeros(k, dtype=torch.bool, device=dev),
        left_sum_g=left_sum_g,
        left_sum_h=left_sum_h_raw - K_EPSILON,
        left_count=left_count,
        right_sum_g=right_sum_g,
        right_sum_h=right_sum_h_raw - K_EPSILON,
        right_count=right_count,
        left_output=leaf_output(left_sum_g, left_sum_h_raw, l1, l2),
        right_output=leaf_output(right_sum_g, right_sum_h_raw, l1, l2),
        is_cat=found,
        cat_bins=found[:, None] & member,
    )
    return res, gain2.reshape(k, f, -1).amax(dim=2) > neg_inf
