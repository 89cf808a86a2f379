"""Feature binning (quantization) on the host.

The reference BinMapper semantics (``src/io/bin.cpp:72-344``,
``include/LightGBM/bin.h:60-208,451-483``) in numpy, numerical features
only:

* ``greedy_find_bin``          — equal-count greedy bin boundaries (bin.cpp:72-141)
* ``find_bin_zero_as_missing`` — split around the zero range (bin.cpp:143-191)
* ``BinMapper.fit``            — missing-type resolution and trivial-feature
                                 detection (bin.cpp:193-344)
* ``BinMapper.value_to_bin``   — vectorized binary-search binning (bin.h:451-483)

Every feature maps to ``[0, num_bin)`` with the NaN bin (if
``missing_type == NAN``) at ``num_bin - 1``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# |value| <= this is treated as "zero" for MissingType.ZERO (reference kZeroAsMissingValueRange)
ZERO_AS_MISSING_RANGE = 1e-35

# MissingType encoding matches the reference decision_type bits ((dt >> 2) & 3)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Greedy equal-count bin boundary search (bin.cpp:72-141 semantics).

    The loop carries a sequential dependence (``mean_bin_size`` is
    re-derived every time a bin closes), so it runs over Python lists."""
    num_distinct = len(distinct_values)
    dv = np.asarray(distinct_values, np.float64).tolist()
    cnts = [int(c) for c in np.asarray(counts).tolist()]
    bounds: List[float] = []
    if max_bin <= 0:
        return [np.inf]
    if num_distinct <= max_bin:
        cur = 0
        for i in range(num_distinct - 1):
            cur += cnts[i]
            if cur >= min_data_in_bin:
                bounds.append((dv[i] + dv[i + 1]) / 2.0)
                cur = 0
        bounds.append(np.inf)
        return bounds
    # more distinct values than bins: greedy mean-size packing with
    # "big count" values pinned to their own bin
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    is_big = [c >= mean_bin_size for c in cnts]
    rest_bin_cnt = max_bin - sum(is_big)
    rest_sample_cnt = total_cnt - sum(c for c, b in zip(cnts, is_big) if b)
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    upper = [np.inf] * max_bin
    lower = [np.inf] * max_bin
    bin_cnt = 0
    lower[0] = dv[0]
    cur = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= cnts[i]
        cur += cnts[i]
        if (is_big[i] or cur >= mean_bin_size or
                (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5))):
            upper[bin_cnt] = dv[i]
            bin_cnt += 1
            lower[bin_cnt] = dv[i + 1]
            if bin_cnt >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    bin_cnt += 1
    bounds = [(upper[i] + lower[i + 1]) / 2.0 for i in range(bin_cnt - 1)]
    bounds.append(np.inf)
    return bounds


def find_bin_zero_as_missing(distinct_values: np.ndarray, counts: np.ndarray,
                             max_bin: int, total_sample_cnt: int,
                             min_data_in_bin: int) -> List[float]:
    """Bin boundaries with the zero range isolated (bin.cpp:143-191 semantics):
    negative and positive values are binned independently around a
    dedicated zero bin."""
    zero_l, zero_r = -ZERO_AS_MISSING_RANGE, ZERO_AS_MISSING_RANGE
    left_mask = distinct_values <= zero_l
    right_mask = distinct_values > zero_r
    left_cnt_data = int(counts[left_mask].sum())
    right_cnt_data = int(counts[right_mask].sum())
    cnt_missing = total_sample_cnt - left_cnt_data - right_cnt_data

    bounds: List[float] = []
    left_cnt = int(left_mask.sum())
    if left_cnt > 0:
        denom = max(total_sample_cnt - cnt_missing, 1)
        left_max_bin = int(left_cnt_data / denom * (max_bin - 1))
        lb = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                             left_max_bin, left_cnt_data, min_data_in_bin)
        lb[-1] = zero_l
        bounds.extend(lb)

    if right_cnt_data > 0:
        right_start = int(np.argmax(right_mask))
        right_max_bin = max_bin - 1 - len(bounds)
        rb = greedy_find_bin(distinct_values[right_start:], counts[right_start:],
                             right_max_bin, right_cnt_data, min_data_in_bin)
        bounds.append(zero_r)
        bounds.extend(rb)
    else:
        bounds.append(np.inf)
    return bounds


@dataclasses.dataclass
class BinMapper:
    """Per-feature value→bin mapping of a numerical feature (bin.h:60-208)."""

    num_bin: int = 1
    missing_type: int = MISSING_NONE
    is_trivial: bool = True
    bin_upper_bound: Optional[np.ndarray] = None
    min_val: float = 0.0
    max_val: float = 0.0
    default_bin: int = 0   # bin of value 0.0

    @staticmethod
    def fit(values: np.ndarray, total_sample_cnt: int, max_bin: int,
            min_data_in_bin: int, min_split_data: int,
            use_missing: bool = True,
            zero_as_missing: bool = False) -> "BinMapper":
        """Build a BinMapper from sampled values (bin.cpp:193-344 semantics).

        ``values`` are the sampled *non-zero-filtered* values; rows absent
        from the sample are implicitly zero (``total_sample_cnt -
        len(values)``), the reference's sparse sampling convention."""
        m = BinMapper()
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        vals = values[~nan_mask]

        if not use_missing:
            m.missing_type = MISSING_NONE
            na_cnt = 0
        elif zero_as_missing:
            m.missing_type = MISSING_ZERO
        else:
            m.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE

        # rows absent from the sample and (unless NaN-tracked) NaN rows count as zero
        zero_cnt = total_sample_cnt - len(vals)
        if m.missing_type == MISSING_NAN:
            zero_cnt -= na_cnt
        zero_cnt = max(int(zero_cnt), 0)
        # distinct values with zero injected at its sorted position carrying zero_cnt
        vals = np.sort(vals)
        distinct, counts = (np.unique(vals, return_counts=True)
                            if len(vals) else (np.empty(0), np.empty(0, dtype=np.int64)))
        if zero_cnt > 0 or len(distinct) == 0:
            if len(distinct) == 0 or 0.0 not in distinct:
                pos = int(np.searchsorted(distinct, 0.0))
                distinct = np.insert(distinct, pos, 0.0)
                counts = np.insert(counts, pos, zero_cnt)
            else:
                counts = counts.copy()
                counts[np.searchsorted(distinct, 0.0)] += zero_cnt
        distinct = distinct.astype(np.float64)
        counts = counts.astype(np.int64)
        m.min_val = float(distinct[0]) if len(distinct) else 0.0
        m.max_val = float(distinct[-1]) if len(distinct) else 0.0
        num_distinct = len(distinct)

        if m.missing_type == MISSING_ZERO:
            bounds = find_bin_zero_as_missing(distinct, counts, max_bin,
                                              total_sample_cnt, min_data_in_bin)
            if len(bounds) == 2:
                m.missing_type = MISSING_NONE
        elif m.missing_type == MISSING_NONE:
            bounds = find_bin_zero_as_missing(distinct, counts, max_bin,
                                              total_sample_cnt, min_data_in_bin)
        else:  # NAN: reserve last bin for NaN
            bounds = find_bin_zero_as_missing(distinct, counts, max_bin - 1,
                                              total_sample_cnt - na_cnt,
                                              min_data_in_bin)
            bounds.append(np.nan)
        m.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        m.num_bin = len(bounds)
        # count per bin for the trivial/filter checks
        cnt_in_bin = np.zeros(m.num_bin, dtype=np.int64)
        effective_bins = m.num_bin - (1 if m.missing_type == MISSING_NAN else 0)
        if num_distinct:
            # value goes to the first bin whose upper bound is >= value
            idx = np.searchsorted(m.bin_upper_bound[:effective_bins - 1],
                                  distinct, side="left")
            np.add.at(cnt_in_bin, idx, counts)
        if m.missing_type == MISSING_NAN:
            cnt_in_bin[m.num_bin - 1] = na_cnt
        m.default_bin = int(m.value_to_bin(np.zeros(1))[0])

        m.is_trivial = m.num_bin <= 1
        if not m.is_trivial and _need_filter(cnt_in_bin, total_sample_cnt,
                                             min_split_data):
            m.is_trivial = True
        return m

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin (bin.h:451-483 semantics)."""
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        v = np.where(nan_mask, 0.0, values)
        n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
        # first bin whose upper bound >= value (upper bounds strictly increasing)
        bins = np.searchsorted(self.bin_upper_bound[:n_search - 1], v,
                               side="left")
        if self.missing_type == MISSING_NAN:
            bins = np.where(nan_mask, self.num_bin - 1, bins)
        return bins.astype(np.int32)

    def bin_to_value(self, bin_idx: int) -> float:
        """Real threshold of a bin (written to the model file)."""
        return float(self.bin_upper_bound[bin_idx])

    def feature_info_str(self) -> str:
        """Model-file feature_infos token (gbdt.cpp SaveModelToString)."""
        if self.is_trivial:
            return "none"
        return f"[{self.min_val:g}:{self.max_val:g}]"


def _need_filter(cnt_in_bin: np.ndarray, total_cnt: int,
                 filter_cnt: int) -> bool:
    """True if no split of this feature can satisfy min_split_data (bin.cpp:48-70)."""
    left = np.cumsum(cnt_in_bin[:-1])
    ok = (left >= filter_cnt) & (total_cnt - left >= filter_cnt)
    return not bool(ok.any())
