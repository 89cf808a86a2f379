"""Feature binning (quantization) on the host.

The reference BinMapper semantics (``src/io/bin.cpp:72-344``,
``include/LightGBM/bin.h:60-208,451-483``) in numpy, as the JAX package's
``data/binning.py`` has them:

* ``greedy_find_bin``          — equal-count greedy bin boundaries (bin.cpp:72-141)
* ``find_bin_zero_as_missing`` — split around the zero range (bin.cpp:143-191)
* ``BinMapper.fit``            — missing-type resolution and trivial-feature
                                 detection (bin.cpp:193-344)
* ``BinMapper.value_to_bin``   — vectorized binning (bin.h:451-483):
                                 binary search over the bin bounds, or over
                                 the sorted kept categories

Every feature maps to ``[0, num_bin)`` with the NaN bin (if
``missing_type == NAN``) at ``num_bin - 1``.  A categorical feature keeps
its most frequent integer values, one bin each, until they cover 99 % of
the sample; NaN, negative and unkept values share bin ``num_bin - 1``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# |value| <= this is treated as "zero" for MissingType.ZERO (reference kZeroAsMissingValueRange)
ZERO_AS_MISSING_RANGE = 1e-35

# MissingType encoding matches the reference decision_type bits ((dt >> 2) & 3)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_TYPE_NUMERICAL = 0
BIN_TYPE_CATEGORICAL = 1


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
    """Per-feature value→bin mapping (bin.h:60-208)."""

    num_bin: int = 1
    bin_type: int = BIN_TYPE_NUMERICAL
    missing_type: int = MISSING_NONE
    is_trivial: bool = True
    bin_upper_bound: Optional[np.ndarray] = None     # numerical
    categorical_2_bin: Optional[Dict[int, int]] = None
    bin_2_categorical: Optional[List[int]] = None
    min_val: float = 0.0
    max_val: float = 0.0
    default_bin: int = 0   # bin of value 0.0

    @staticmethod
    def fit(values: np.ndarray, total_sample_cnt: int, max_bin: int,
            min_data_in_bin: int, min_split_data: int,
            bin_type: int = BIN_TYPE_NUMERICAL,
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
        if num_distinct + (1 if na_cnt > 0 else 0) <= 2:
            bin_type = BIN_TYPE_NUMERICAL
        m.bin_type = bin_type
        if bin_type == BIN_TYPE_NUMERICAL:
            cnt_in_bin = m._fit_numerical(distinct, counts, na_cnt,
                                          total_sample_cnt, max_bin,
                                          min_data_in_bin)
        else:
            cnt_in_bin = m._fit_categorical(distinct, counts, na_cnt,
                                            total_sample_cnt, max_bin)
        m.is_trivial = m.num_bin <= 1
        if not m.is_trivial and _need_filter(cnt_in_bin, total_sample_cnt,
                                             min_split_data, m.bin_type):
            m.is_trivial = True
        return m

    def _fit_numerical(self, distinct, counts, na_cnt, total_sample_cnt,
                       max_bin, min_data_in_bin) -> np.ndarray:
        """Bin bounds of a numerical feature; returns the count per bin."""
        if self.missing_type == MISSING_ZERO:
            bounds = find_bin_zero_as_missing(distinct, counts, max_bin,
                                              total_sample_cnt, min_data_in_bin)
            if len(bounds) == 2:
                self.missing_type = MISSING_NONE
        elif self.missing_type == MISSING_NONE:
            bounds = find_bin_zero_as_missing(distinct, counts, max_bin,
                                              total_sample_cnt, min_data_in_bin)
        else:  # NAN: reserve last bin for NaN
            bounds = find_bin_zero_as_missing(distinct, counts, max_bin - 1,
                                              total_sample_cnt - na_cnt,
                                              min_data_in_bin)
            bounds.append(np.nan)
        self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        self.num_bin = len(bounds)
        cnt_in_bin = np.zeros(self.num_bin, dtype=np.int64)
        effective_bins = self.num_bin - (
            1 if self.missing_type == MISSING_NAN else 0)
        if len(distinct):
            # value goes to the first bin whose upper bound is >= value
            idx = np.searchsorted(self.bin_upper_bound[:effective_bins - 1],
                                  distinct, side="left")
            np.add.at(cnt_in_bin, idx, counts)
        if self.missing_type == MISSING_NAN:
            cnt_in_bin[self.num_bin - 1] = na_cnt
        self.default_bin = int(self.value_to_bin(np.zeros(1))[0])
        return cnt_in_bin

    def _fit_categorical(self, distinct, counts, na_cnt, total_sample_cnt,
                         max_bin) -> np.ndarray:
        """Kept categories of a categorical feature (bin.cpp:290-330): the
        integer values by count, most frequent first, until they cover 99 %
        of the non-NaN sample; returns the count per bin."""
        ints = distinct.astype(np.int64)
        cats, inv = np.unique(ints, return_inverse=True)
        cat_cnt = np.bincount(inv.ravel(), weights=counts,
                              minlength=len(cats)).astype(np.int64)
        if len(cats) and cats[0] < 0:
            raise RuntimeError("Cannot use negative numbers in categorical "
                               "features")
        # count descending, ties by value (the JAX package's stable sort of
        # its value-ordered dict)
        by_cnt = np.argsort(-cat_cnt, kind="stable")
        items = [(int(cats[k]), int(cat_cnt[k])) for k in by_cnt]
        # avoid first bin being category 0 (reference bin.cpp:305-308)
        if len(items) > 1 and items[0][0] == 0:
            items[0], items[1] = items[1], items[0]
        cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
        counts_sorted = np.asarray([c for _, c in items], dtype=np.int64)
        mb = min(len(items), max_bin)
        # the first nb with (covered >= cut_cnt and nb >= mb), else all
        covered = np.cumsum(counts_sorted)
        nb = len(items)
        for k in range(mb, len(items) + 1):
            if k == 0 or covered[k - 1] >= cut_cnt:
                nb = k
                break
        used_cnt = int(covered[nb - 1]) if nb else 0
        self.bin_2_categorical = [c for c, _ in items[:nb]]
        self.categorical_2_bin = {c: b for b, c in
                                  enumerate(self.bin_2_categorical)}
        self.num_bin = nb
        if nb == len(items) and na_cnt == 0:
            self.missing_type = MISSING_NONE
        elif na_cnt == 0:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN
        cnt_in_bin = counts_sorted[:nb].copy()
        if nb > 0:
            cnt_in_bin[-1] += total_sample_cnt - used_cnt
        self.default_bin = 0
        return cnt_in_bin

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin (bin.h:451-483 semantics)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            return self._category_to_bin(values)
        nan_mask = np.isnan(values)
        v = np.where(nan_mask, 0.0, values)
        n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
        # first bin whose upper bound >= value (upper bounds strictly increasing)
        bins = np.searchsorted(self.bin_upper_bound[:n_search - 1], v,
                               side="left")
        if self.missing_type == MISSING_NAN:
            bins = np.where(nan_mask, self.num_bin - 1, bins)
        return bins.astype(np.int32)

    def _category_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Bins of categorical values: the value truncated toward zero, as
        ``int(v)`` does, looked up among the sorted kept categories; NaN
        and every value not kept go to ``num_bin - 1``."""
        out = np.full(values.shape, self.num_bin - 1, dtype=np.int32)
        if not self.categorical_2_bin:
            return out
        cats = np.asarray(sorted(self.categorical_2_bin), dtype=np.int64)
        bins_of = np.asarray([self.categorical_2_bin[int(c)] for c in cats],
                             dtype=np.int32)
        ok = ~np.isnan(values)
        # clip before the cast: values past the kept range are misses
        iv = np.clip(np.trunc(values[ok]), -1, cats[-1] + 1).astype(np.int64)
        pos = np.minimum(np.searchsorted(cats, iv), len(cats) - 1)
        hit = cats[pos] == iv
        sub = out[ok]
        sub[hit] = bins_of[pos[hit]]
        out[ok] = sub
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """Real threshold of a bin, or the category of a categorical bin
        (written to the model file)."""
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        return float(self.bin_upper_bound[bin_idx])

    def feature_info_str(self) -> str:
        """Model-file feature_infos token (gbdt.cpp SaveModelToString)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            return ":".join(str(c) for c in sorted(self.bin_2_categorical))
        return f"[{self.min_val:g}:{self.max_val:g}]"


def _need_filter(cnt_in_bin: np.ndarray, total_cnt: int, filter_cnt: int,
                 bin_type: int) -> bool:
    """True if no split of this feature can satisfy min_split_data (bin.cpp:48-70)."""
    if bin_type == BIN_TYPE_NUMERICAL:
        left = np.cumsum(cnt_in_bin[:-1])
        ok = (left >= filter_cnt) & (total_cnt - left >= filter_cnt)
        return not bool(ok.any())
    if len(cnt_in_bin) <= 2:
        c = cnt_in_bin[:-1]
        return not bool(((c >= filter_cnt)
                         & (total_cnt - c >= filter_cnt)).any())
    return False
