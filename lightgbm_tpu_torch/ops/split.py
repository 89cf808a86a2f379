"""Best-split scan over feature histograms, numerical features, fused form.

The port of ``lightgbm_tpu/ops/split.py``'s fused scan (``make_fused_ctx``
:355, ``_fused_numerical`` :382, ``best_split`` :609), itself
``FeatureHistogram::FindBestThresholdNumerical`` /
``FindBestThresholdSequence`` (``src/treelearner/feature_histogram.hpp:
82-418``) as one tensor program over all features, batched over a leading
leaf axis K (the grower scans both children of a split in one call):

* the two scan directions are two cumulative sums over the bin axis;
* the reference's ``continue``/``break`` guards are masks;
* missing values (none / zero / NaN) select which bins feed each side and
  which thresholds are candidates;
* ties break as the reference scan order: smallest feature index, then
  direction -1 (missing left) before +1, the -1 scan preferring the
  largest threshold and the +1 scan the smallest.

Gain = ``G(left) + G(right) - G(parent) - min_gain_to_split`` with
``G(s, h) = max(0, |s| - l1)^2 / (h + l2)`` (feature_histogram.hpp:255-262).
The arithmetic follows the JAX scan operation for operation, so equal
histograms whose sums are exact give equal results.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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


class FusedSplitCtx(NamedTuple):
    """Masks of the scan that depend only on feature metadata, built once
    per tree.  ``keep_p1``/``cand_p1``/``force_right`` are None when the
    dataset has no missing values (no dir=+1 scan)."""
    keep_m1: torch.Tensor               # [F, B] bool: bins feeding dir=-1
    cand_m1: torch.Tensor               # [F, B] bool: dir=-1 candidacy
    keep_p1: Optional[torch.Tensor]     # [F, B] bool
    cand_p1: Optional[torch.Tensor]     # [F, B] bool
    force_right: Optional[torch.Tensor]  # [F] bool: 2-bin NaN features


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
                   cfg: SplitConfig) -> FusedSplitCtx:
    """Build the loop-invariant masks of the scan (split.py:355)."""
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


def best_split(hist: torch.Tensor, parent_g: torch.Tensor,
               parent_h: torch.Tensor, parent_c: torch.Tensor,
               feat_valid: torch.Tensor, cfg: SplitConfig,
               ctx: FusedSplitCtx):
    """Best numerical split of K leaves (split.py:609 with
    ``split_find=fused``).

    hist ``[K, F, B, 3]`` (sum_g, sum_h, count); parent_g/h/c ``[K]``;
    feat_valid ``[K, F]`` bool.  Returns ``(SplitResult, feat_ok [K, F])``
    where feat_ok flags the features that produced any candidate beating
    the gain shift (the reference's subtree feature pruning,
    serial_tree_learner.cpp:406-417)."""
    dtype = hist.dtype
    k, f, b, _ = hist.shape
    dev = hist.device
    pg = parent_g.view(k, 1, 1)
    pc = parent_c.view(k, 1, 1)
    l1 = torch.tensor(cfg.lambda_l1, dtype=dtype, device=dev)
    l2 = torch.tensor(cfg.lambda_l2, dtype=dtype, device=dev)
    min_data = torch.tensor(cfg.min_data_in_leaf, dtype=dtype, device=dev)
    min_hess = torch.tensor(cfg.min_sum_hessian_in_leaf, dtype=dtype,
                            device=dev)
    tot_h_k = parent_h + 2.0 * K_EPSILON                       # [K]
    tot_h = tot_h_k.view(k, 1, 1)
    min_gain_shift_k = (leaf_split_gain(parent_g, tot_h_k, l1, l2)
                        + cfg.min_gain_to_split)               # [K]
    min_gain_shift = min_gain_shift_k.view(k, 1, 1)
    neg_inf = torch.tensor(float("-inf"), dtype=dtype, device=dev)
    valid = feat_valid.view(k, f, 1)

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
    gm = torch.amax(flipped_m1, dim=2)                         # [K, F]
    jm = torch.argmax(flipped_m1, dim=2)

    if cfg.has_missing:
        # ---- dir = +1: accumulate from the left; missing defaults RIGHT
        kept = torch.where(ctx.keep_p1[None, :, :, None], hist, 0.0)
        left_p1 = torch.cumsum(kept, dim=2)
        lg_p1 = left_p1[..., 0]
        lh_p1 = left_p1[..., 1] + K_EPSILON
        lc_p1 = left_p1[..., 2]
        gains_p1 = eval_gains(lg_p1, lh_p1, lc_p1,
                              valid & ctx.cand_p1[None])
        gp = torch.amax(gains_p1, dim=2)
        jp = torch.argmax(gains_p1, dim=2)
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
    )
    return res, best_f > neg_inf
