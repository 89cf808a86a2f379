"""TreeSHAP feature contributions (``pred_contrib``).

The port's own copy of the TreeSHAP part of
``lightgbm_tpu/obs/model_quality.py`` (:237-481): the exact
Lundberg/Lee path-attribution recursion (the reference's
tree.cpp:TreeSHAP), vectorized over rows, float64 on the host.  The
recursion's structure (node visit order, path features, cover fractions,
the unwinds of a feature met twice) depends only on the tree; only the
hot-child indicators and path weights depend on the row, so one pass a
tree carries ``[N]`` vectors instead of recursing once a row.  A path
element carries (feature, zero_fraction, one_fraction, pweight); every
branch on ``one_fraction != 0`` becomes a masked ``np.where`` with
guarded denominators.  The go-left decisions come from the device
(``predictor.SoABundle.go_matrix``); :func:`contribs_oracle`, the literal
per-row recursion on raw values, is the parity twin the tests hold it
against.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK

MISSING_ZERO, MISSING_NAN = 1, 2
ZERO_RANGE = 1e-20           # kZeroAsMissingValueRange (reference meta.h:22)


def expected_value(tree) -> float:
    """``Tree::ExpectedValue``: the training-cover-weighted mean output —
    the bias term TreeSHAP assigns to the last contribution column."""
    if tree.num_leaves <= 1:
        return float(tree.leaf_value[0]) if len(tree.leaf_value) else 0.0
    total = float(tree.internal_count[0])
    if total <= 0:
        return 0.0
    return float(np.dot(tree.leaf_count[:tree.num_leaves].astype(np.float64),
                        tree.leaf_value[:tree.num_leaves]) / total)


def _node_count(tree, child: int) -> float:
    return float(tree.leaf_count[~child] if child < 0
                 else tree.internal_count[child])


def tree_contribs(tree, go: np.ndarray, num_features: int,
                  phi: Optional[np.ndarray] = None) -> np.ndarray:
    """SHAP contributions of one tree for all rows at once.

    ``go`` is the [num_internal, N] go-left decision matrix (from the
    bundle's binned rows, ``predictor.SoABundle.go_matrix``); returns or
    accumulates ``phi`` [N, num_features + 1] with the expected value in
    the last column."""
    N = go.shape[1] if tree.num_leaves > 1 else \
        (phi.shape[0] if phi is not None else 0)
    if phi is None:
        phi = np.zeros((N, num_features + 1), np.float64)
    phi[:, num_features] += expected_value(tree)
    if tree.num_leaves <= 1:
        return phi
    n_rows = go.shape[1]

    # path state, one slot per unique feature on the path (+ the leading
    # sentinel): feature / zero_fraction are row-independent per slot
    def recurse(node: int, depth: int, pfeat: List[int], pzero: List[float],
                pone: List[np.ndarray], ppw: List[np.ndarray],
                parent_zero: float, parent_one: np.ndarray,
                parent_feat: int) -> None:
        # ExtendPath
        pfeat = pfeat + [parent_feat]
        pzero = pzero + [parent_zero]
        pone = pone + [parent_one]
        ppw = ppw + [np.ones(n_rows) if depth == 0 else np.zeros(n_rows)]
        for i in range(depth - 1, -1, -1):
            ppw[i + 1] = ppw[i + 1] + parent_one * ppw[i] \
                * ((i + 1) / (depth + 1))
            ppw[i] = parent_zero * ppw[i] * ((depth - i) / (depth + 1))
        if node < 0:                                    # leaf
            leaf_v = float(tree.leaf_value[~node])
            for i in range(1, depth + 1):
                w = _unwound_sum(pzero, pone, ppw, depth, i)
                phi[:, pfeat[i]] += w * (pone[i] - pzero[i]) * leaf_v
            return
        lc = int(tree.left_child[node])
        rc = int(tree.right_child[node])
        node_cnt = float(tree.internal_count[node])
        feat = int(tree.split_feature[node])
        left_zero = _node_count(tree, lc) / node_cnt
        right_zero = _node_count(tree, rc) / node_cnt
        inc_zero, inc_one = 1.0, np.ones(n_rows)
        # a feature already on the path: undo its previous extension and
        # fold its fractions into the incoming ones
        for pi in range(1, depth + 1):
            if pfeat[pi] == feat:
                inc_zero, inc_one = pzero[pi], pone[pi]
                pfeat, pzero, pone, ppw, depth = _unwind(
                    pfeat, pzero, pone, ppw, depth, pi)
                break
        go_l = go[node]
        # hot/cold is per-row: each child's incoming one_fraction keeps
        # the rows routed to it and zeroes the rest
        recurse(lc, depth + 1, pfeat, pzero, pone, ppw,
                left_zero * inc_zero, np.where(go_l, inc_one, 0.0), feat)
        recurse(rc, depth + 1, pfeat, pzero, pone, ppw,
                right_zero * inc_zero, np.where(go_l, 0.0, inc_one), feat)

    recurse(0, 0, [], [], [], [], 1.0, np.ones(n_rows), -1)
    return phi


def _unwound_sum(pzero, pone, ppw, depth: int, pi: int) -> np.ndarray:
    """UnwoundPathSum, rows at once: total permutation weight of the
    subsets along the path with element ``pi`` removed.  A one fraction
    is 1 on the rows that follow the path and 0 on the others, so the
    reference's two branches are the two sides of one ``np.where``, each
    computed with the JAX package's operations in its order (the same
    float64 results, with fewer array passes)."""
    zero = pzero[pi]
    nonzero = pone[pi] != 0
    next_one = ppw[depth]
    total = np.zeros_like(next_one)
    for i in range(depth - 1, -1, -1):
        tmp = next_one * ((depth + 1) / (i + 1))
        alt = (ppw[i] * ((depth + 1) / (depth - i)) / zero if zero != 0
               else 0.0)
        total = total + np.where(nonzero, tmp, alt)
        next_one = np.where(nonzero,
                            ppw[i] - tmp * zero * ((depth - i) / (depth + 1)),
                            next_one)
    return total


def _unwind(pfeat, pzero, pone, ppw, depth: int, pi: int):
    """UnwindPath, rows at once: remove path element ``pi``, restoring
    the pweights to the state before it was extended in (one fractions
    0 or 1, as in :func:`_unwound_sum`)."""
    zero = pzero[pi]
    nonzero = pone[pi] != 0
    ppw = list(ppw)
    next_one = ppw[depth]
    for i in range(depth - 1, -1, -1):
        new_if = next_one * ((depth + 1) / (i + 1))
        new_else = (ppw[i] * ((depth + 1) / (depth - i)) / zero if zero != 0
                    else 0.0)
        tmp = ppw[i]
        ppw[i] = np.where(nonzero, new_if, new_else)
        next_one = np.where(nonzero,
                            tmp - ppw[i] * zero * ((depth - i) / (depth + 1)),
                            next_one)
    # shift feature/zero/one down over the removed slot; the RESTORED
    # pweights stay in place and the LAST slot drops (tree_shap.h
    # unwind_path shifts everything except pweight)
    pfeat = pfeat[:pi] + pfeat[pi + 1:]
    pzero = pzero[:pi] + pzero[pi + 1:]
    pone = pone[:pi] + pone[pi + 1:]
    ppw = ppw[:depth]
    return pfeat, pzero, pone, ppw, depth - 1


def contribs_oracle(tree, x: np.ndarray, num_features: int) -> np.ndarray:
    """Independent single-row TreeSHAP: the literal reference recursion
    with scalar path elements (tree.cpp:TreeSHAP).  Kept as the parity
    twin the vectorized path is pinned against."""
    phi = np.zeros(num_features + 1, np.float64)
    phi[num_features] += expected_value(tree)
    if tree.num_leaves <= 1:
        return phi
    x = np.asarray(x, np.float64)

    def decision(node: int) -> bool:
        fv = float(x[tree.split_feature[node]])
        dt = int(tree.decision_type[node])
        mt = (dt >> 2) & 3
        if dt & K_CATEGORICAL_MASK:
            return _cat_decision(tree, fv, node)
        is_nan = np.isnan(fv)
        if is_nan and mt != MISSING_NAN:
            fv = 0.0
        missing = ((mt == MISSING_ZERO) and abs(fv) <= ZERO_RANGE) or \
                  (mt == MISSING_NAN and is_nan)
        if missing:
            return bool(dt & K_DEFAULT_LEFT_MASK)
        return fv <= tree.threshold[node]

    def extend(path, zero, one, feat):
        path = [dict(p) for p in path]
        d = len(path)
        path.append({"f": feat, "z": zero, "o": one,
                     "w": 1.0 if d == 0 else 0.0})
        for i in range(d - 1, -1, -1):
            path[i + 1]["w"] += one * path[i]["w"] * (i + 1) / (d + 1)
            path[i]["w"] = zero * path[i]["w"] * (d - i) / (d + 1)
        return path

    def unwound_sum(path, pi):
        d = len(path) - 1
        one, zero = path[pi]["o"], path[pi]["z"]
        next_one = path[d]["w"]
        total = 0.0
        for i in range(d - 1, -1, -1):
            if one != 0:
                tmp = next_one * (d + 1) / ((i + 1) * one)
                total += tmp
                next_one = path[i]["w"] - tmp * zero * (d - i) / (d + 1)
            elif zero != 0:
                total += path[i]["w"] * (d + 1) / (zero * (d - i))
        return total

    def unwind(path, pi):
        d = len(path) - 1
        one, zero = path[pi]["o"], path[pi]["z"]
        path = [dict(p) for p in path]
        next_one = path[d]["w"]
        for i in range(d - 1, -1, -1):
            if one != 0:
                tmp = path[i]["w"]
                path[i]["w"] = next_one * (d + 1) / ((i + 1) * one)
                next_one = tmp - path[i]["w"] * zero * (d - i) / (d + 1)
            elif zero != 0:
                path[i]["w"] = path[i]["w"] * (d + 1) / (zero * (d - i))
        # shift feature/fractions down over the removed slot; pweights
        # stay in place and the LAST slot drops (tree_shap.h unwind_path)
        for i in range(pi, d):
            path[i]["f"] = path[i + 1]["f"]
            path[i]["z"] = path[i + 1]["z"]
            path[i]["o"] = path[i + 1]["o"]
        return path[:d]

    def rec(node, path, zero, one, feat):
        path = extend(path, zero, one, feat)
        if node < 0:
            for i in range(1, len(path)):
                w = unwound_sum(path, i)
                phi[path[i]["f"]] += w * (path[i]["o"] - path[i]["z"]) \
                    * float(tree.leaf_value[~node])
            return
        lc, rc = int(tree.left_child[node]), int(tree.right_child[node])
        hot, cold = (lc, rc) if decision(node) else (rc, lc)
        node_cnt = float(tree.internal_count[node])
        hot_zero = _node_count(tree, hot) / node_cnt
        cold_zero = _node_count(tree, cold) / node_cnt
        inc_zero, inc_one = 1.0, 1.0
        sf = int(tree.split_feature[node])
        for pi in range(1, len(path)):
            if path[pi]["f"] == sf:
                inc_zero, inc_one = path[pi]["z"], path[pi]["o"]
                path = unwind(path, pi)
                break
        rec(hot, path, hot_zero * inc_zero, inc_one, sf)
        rec(cold, path, cold_zero * inc_zero, 0.0, sf)

    rec(0, [], 1.0, 1.0, -1)
    return phi


def _cat_decision(tree, fval: float, node: int) -> bool:
    """CategoricalDecision (tree.h:268-283) on one raw value: NaN under
    NaN missing handling, negative and unseen categories go right."""
    if np.isnan(fval):
        if tree.missing_type(node) == MISSING_NAN:
            return False
        fval = 0.0
    int_val = int(fval)
    if int_val < 0:
        return False
    bitset = tree.cat_bitset(node)
    i1, i2 = int_val // 32, int_val % 32
    if i1 < len(bitset):
        return bool((int(bitset[i1]) >> i2) & 1)
    return False
