"""Exclusive Feature Bundling (EFB), as ``lightgbm_tpu/data/bundling.py``.

The greedy conflict-bounded bundling of the reference (``FindGroups`` /
``FastFeatureBundling``, ``src/io/dataset.cpp:66-210``): mutually
exclusive sparse features share ONE physical column, so the
histogram's width follows the bundles, not the features.

Layout of a bundle column:

* slot 0: every bundled feature at its default bin ("all zero");
* feature f with ``num_bin`` bins and default bin ``db`` owns the slots
  ``[offset_f, offset_f + num_bin - 2]``: its non-default bins in
  ascending order with ``db`` skipped (``slot = offset + b - (b > db)``).

Rows where two bundled features are both non-default are conflicts; the
search bounds them by ``max_conflict_rate`` and a conflicting row takes
the last feature's value.  Bundles cap at 256 slots, so a bundle alone
never makes the matrix uint16; it is written into a uint16 matrix when
another column has more than 256 bins.  The split scan never sees a
bundle column: the grower expands its histogram into one per feature
(``grower.expand_bundle_hist``, the reference's ``FixHistogram``), and
routing decodes the slot (``ops/route.py:decode_bundle_bin``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def find_bundles(nonzero: np.ndarray,            # [S, F] bool sample matrix
                 num_bins: Sequence[int],        # per feature
                 max_conflict_rate: float,
                 max_bundle_bins: int = 256,
                 max_sparse_rate: float = 0.8) -> List[List[int]]:
    """Greedy first-fit bundling (FindGroups, dataset.cpp:66-136 semantics).

    Returns a list of bundles (lists of feature indices into the input
    ordering); singleton lists are unbundled features.  Features denser than
    ``max_sparse_rate`` never bundle.
    """
    s, f = nonzero.shape
    nz_cnt = nonzero.sum(axis=0)
    budget = max_conflict_rate * s
    order = np.argsort(-nz_cnt, kind="mergesort")  # densest first (stable)

    bundles: List[List[int]] = []
    bundle_rows: List[np.ndarray] = []    # union of nonzero rows per bundle
    bundle_conflicts: List[float] = []
    bundle_bins: List[int] = []

    for j in order:
        nb = int(num_bins[j])
        sparse_ok = s == 0 or nz_cnt[j] <= max_sparse_rate * s
        placed = False
        if sparse_ok:
            for gi in range(len(bundles)):
                extra_bins = nb - 1
                if bundle_bins[gi] + extra_bins > max_bundle_bins:
                    continue
                conflicts = int(np.count_nonzero(bundle_rows[gi] & nonzero[:, j]))
                if bundle_conflicts[gi] + conflicts <= budget:
                    bundles[gi].append(int(j))
                    bundle_rows[gi] |= nonzero[:, j]
                    bundle_conflicts[gi] += conflicts
                    bundle_bins[gi] += extra_bins
                    placed = True
                    break
        if not placed:
            if sparse_ok and nb <= max_bundle_bins:
                bundles.append([int(j)])
                bundle_rows.append(nonzero[:, j].copy())
                bundle_conflicts.append(0.0)
                bundle_bins.append(1 + (nb - 1))
            else:
                # dense / oversized feature: its own column, never joined
                bundles.append([int(j)])
                bundle_rows.append(np.ones(s, dtype=bool))
                bundle_conflicts.append(float("inf"))
                bundle_bins.append(max_bundle_bins + 1)
    # restore deterministic order: bundles sorted by their first feature
    for b in bundles:
        b.sort()
    bundles.sort(key=lambda b: b[0])
    return bundles


class BundleLayout:
    """Per-logical-feature decode tables of a bundled dataset
    (``lightgbm_tpu/data/bundling.py:91-133``).  Logical features are the
    used features in bundle order; physical columns are the bin matrix's
    columns, one a bundle."""

    def __init__(self, bundles: List[List[int]], mappers):
        # bundles hold original feature ids, each bundle in ascending order
        self.bundles = bundles
        self.sub_features: List[int] = []  # original id a logical feature
        self.sub_col: List[int] = []       # its physical column
        self.sub_offset: List[int] = []    # its first slot (-1: unbundled)
        self.col_num_bin: List[int] = []   # slots a physical column
        for col, bundle in enumerate(bundles):
            if len(bundle) == 1:
                j = bundle[0]
                self.sub_features.append(j)
                self.sub_col.append(col)
                self.sub_offset.append(-1)
                self.col_num_bin.append(mappers[j].num_bin)
            else:
                offset = 1
                for j in bundle:
                    self.sub_features.append(j)
                    self.sub_col.append(col)
                    self.sub_offset.append(offset)
                    offset += mappers[j].num_bin - 1
                self.col_num_bin.append(offset)

    @property
    def num_columns(self) -> int:
        return len(self.bundles)

    @property
    def has_bundles(self) -> bool:
        return any(len(b) > 1 for b in self.bundles)

    def max_col_bins(self) -> int:
        return max(self.col_num_bin) if self.col_num_bin else 1


def build_bundled_column(columns, bundle: List[int], mappers,
                         offsets: List[int],
                         out: Optional[np.ndarray] = None) -> np.ndarray:
    """Bin one bundle's features and merge them into one column of the
    bin matrix's type, ``out``'s (uint8 when not given; a bundle's slots
    stay within 256, but the matrix is uint16 when another column is
    wide) (``lightgbm_tpu/data/bundling.py:136-161``).  ``columns`` maps a
    feature id to its float64 column; ``offsets[i]`` is the first slot of
    ``bundle[i]``; a conflicting row takes the LAST feature's value."""
    n = len(columns[bundle[0]])
    col = np.zeros(n, dtype=np.uint8) if out is None else out
    if out is not None:
        col.fill(0)
    for j, off in zip(bundle, offsets):
        m = mappers[j]
        b = m.value_to_bin(columns[j]).astype(np.int32)
        nondef = b != m.default_bin
        slot = off + b - (b > m.default_bin)
        col[nondef] = slot[nondef].astype(col.dtype)
    return col
