"""Exclusive Feature Bundling (EFB): the bundle search only.

The greedy conflict-bounded bundling of the reference (``FindGroups`` /
``FastFeatureBundling``, ``src/io/dataset.cpp:66-210``).  The port does
not store bundled columns yet; dataset construction runs this search so
that a dataset which would bundle raises instead of silently training
unbundled.
"""
from __future__ import annotations

from typing import List, Sequence

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
