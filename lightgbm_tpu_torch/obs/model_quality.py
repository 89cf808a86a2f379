"""The model-quality plane (``lightgbm_tpu/obs/model_quality.py``).

* **Split audit** (:class:`ModelQualityTracker`, :75-200): every tree the
  trainer copies to the host is folded into per-feature cumulative gain
  and split counts (the ``feature_gain`` / ``feature_split`` metric
  families) and, with the flight recorder armed, one ``split_audit``
  record a split.  It reads the host tree the loop already made: no
  device read, no collective.
* **The training distribution** (:func:`training_bin_distribution`,
  :func:`format_distribution`, :func:`parse_distribution`, :484-550):
  each numerical feature's ``(value, count)`` histogram of the training
  bins, written into the model text as its ``feature_distribution:``
  section at save when the tracker is armed, for the serving drift
  monitor.  Computed once, from bincounts over the binned matrix.
* **TreeSHAP** feature contributions (``pred_contrib``, :237-481): the
  exact Lundberg/Lee path-attribution recursion (the reference's
  tree.cpp:TreeSHAP), vectorized over rows, float64 on the host.  The
  recursion's structure (node visit order, path features, cover
  fractions, the unwinds of a feature met twice) depends only on the
  tree; only the hot-child indicators and path weights depend on the
  row, so one pass a tree carries ``[N]`` vectors instead of recursing
  once a row.  A path element carries (feature, zero_fraction,
  one_fraction, pweight); every branch on ``one_fraction != 0`` becomes a
  masked ``np.where`` with guarded denominators.  The go-left decisions
  come from the device (``predictor.SoABundle.go_matrix``);
  :func:`contribs_oracle`, the literal per-row recursion on raw values,
  is the parity twin the tests hold it against.

* **Serving drift** (:func:`psi`, :class:`DriftMonitor`, :551-669): the
  served rows' per-feature threshold-rank histograms, folded on the
  device from each microbatch's binned rows, held by the population
  stability index against the training distribution every
  ``drift_window_rows`` rows; ``feature_drift`` events past
  ``drift_threshold`` and ``feature_drift`` gauges.

Armed by the ``model_quality`` key (``auto`` follows ``telemetry``).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK
from . import flight as obs_flight
from . import metrics as obs_metrics
from .counters import counters

MISSING_ZERO, MISSING_NAN = 1, 2
ZERO_RANGE = 1e-20           # kZeroAsMissingValueRange (reference meta.h:22)


def _feature_name(names: Optional[Sequence[str]], idx: int) -> str:
    if names is not None and 0 <= idx < len(names):
        return str(names[idx])
    return f"Column_{idx}"


# ---------------------------------------------------------------- split audit


class NullModelQuality:
    """Disarmed tracker (the shared no-op)."""
    enabled = False

    def observe_tree(self, iteration: int, tree_index: int, tree) -> None:
        pass

    def note_eval(self, dataset: str, metric: str, value: float) -> None:
        pass

    def eval_fields(self) -> Dict[str, float]:
        return {}

    def metrics_samples(self) -> list:
        return []

    def summary(self, top_k: int = 10) -> Dict[str, Any]:
        return {}


NULL_MODEL_QUALITY = NullModelQuality()


class ModelQualityTracker:
    """Training-side split auditor: folds each host tree into per-feature
    gain and split-count accumulators, streams one ``split_audit`` record
    a split into the flight recorder, and keeps the latest evaluation
    values for the next ``progress`` record."""

    enabled = True

    def __init__(self, feature_names: Optional[Sequence[str]] = None):
        self.feature_names = list(feature_names) if feature_names else None
        self._gain: Dict[int, float] = {}
        self._splits: Dict[int, int] = {}
        # the gain-decay curve: each iteration's total split gain
        self._iter_gain: Dict[int, float] = {}
        self._evals: Dict[str, float] = {}
        self.trees_seen = 0
        obs_metrics.register_source(self.metrics_samples)

    def observe_tree(self, iteration: int, tree_index: int, tree) -> None:
        n = tree.num_leaves - 1
        self.trees_seen += 1
        if n <= 0:
            return
        feats = np.asarray(tree.split_feature[:n], np.int64)
        gains = np.asarray(tree.split_gain[:n], np.float64)
        for f in np.unique(feats):
            sel = feats == f
            self._gain[int(f)] = self._gain.get(int(f), 0.0) \
                + float(gains[sel].sum())
            self._splits[int(f)] = self._splits.get(int(f), 0) \
                + int(sel.sum())
        self._iter_gain[int(iteration)] = \
            self._iter_gain.get(int(iteration), 0.0) + float(gains.sum())
        fl = obs_flight.get_flight()
        if not fl.enabled:
            return
        lc = tree.left_child[:n]
        rc = tree.right_child[:n]
        child_count = np.where(
            lc < 0, tree.leaf_count[~np.minimum(lc, -1)],
            tree.internal_count[np.maximum(lc, 0)])
        rchild_count = np.where(
            rc < 0, tree.leaf_count[~np.minimum(rc, -1)],
            tree.internal_count[np.maximum(rc, 0)])
        # one write for the tree's records (the JAX package's lines)
        fl.records("split_audit", (dict(
            iteration=int(iteration), tree=int(tree_index), node=i,
            feature=_feature_name(self.feature_names, int(feats[i])),
            bin_threshold=int(tree.threshold_bin[i]),
            threshold=float(tree.threshold[i]), gain=float(gains[i]),
            left_count=int(child_count[i]),
            right_count=int(rchild_count[i]),
            default_left=bool(tree.decision_type[i] & K_DEFAULT_LEFT_MASK),
            categorical=bool(tree.decision_type[i] & K_CATEGORICAL_MASK))
            for i in range(n)))

    def note_eval(self, dataset: str, metric: str, value: float) -> None:
        self._evals[f"{dataset}:{metric}"] = float(value)

    def eval_fields(self) -> Dict[str, float]:
        """The latest value of each evaluated metric, for the progress
        record."""
        return dict(self._evals)

    def metrics_samples(self) -> list:
        out = []
        for f, g in sorted(self._gain.items()):
            name = _feature_name(self.feature_names, f)
            out.append(("feature_gain", {"feature": name}, g, "counter"))
            out.append(("feature_split", {"feature": name},
                        self._splits.get(f, 0), "counter"))
        return out

    def summary(self, top_k: int = 10) -> Dict[str, Any]:
        order = sorted(self._gain, key=lambda f: -self._gain[f])
        return {
            "trees_seen": self.trees_seen,
            "top_features": [
                {"feature": _feature_name(self.feature_names, f),
                 "gain": self._gain[f], "splits": self._splits.get(f, 0)}
                for f in order[:top_k]],
            "gain_curve": [[it, self._iter_gain[it]]
                           for it in sorted(self._iter_gain)],
        }


_active: Any = NULL_MODEL_QUALITY


def get_tracker():
    """The process-wide active tracker (the no-op when disarmed)."""
    return _active


def start(feature_names: Optional[Sequence[str]] = None
          ) -> ModelQualityTracker:
    global _active
    _active = ModelQualityTracker(feature_names)
    return _active


def stop():
    """Disarm; returns the retired tracker."""
    global _active
    t, _active = _active, NULL_MODEL_QUALITY
    return t


def resolve_armed(model_quality: str, telemetry_on: bool) -> bool:
    """The ``model_quality`` key: ``auto`` follows telemetry."""
    if model_quality == "on":
        return True
    if model_quality == "off":
        return False
    return telemetry_on


# ------------------------------------------------- the training distribution


def training_bin_distribution(train_set, bins=None
                              ) -> Dict[int, List[Tuple[float, int]]]:
    """Each numerical feature's ``(representative value, count)`` histogram
    of the training bins, by original feature index
    (``lightgbm_tpu/obs/model_quality.py:484``): NaN bins at 0.0; bundled
    (EFB) layouts and categorical features are skipped.  The counts are
    bincounts over the host bin matrix, or, when the training holds its
    bins on the device only, over ``bins`` (one read, at save)."""
    out: Dict[int, List[Tuple[float, int]]] = {}
    if train_set is None:
        return out
    if getattr(train_set, "bundled", False):
        return out
    binned = train_set.binned
    dev = None
    if binned is None:
        if bins is None:
            return out
        dev = bins
    for j, f in enumerate(train_set.used_features):
        m = train_set.bin_mappers[f]
        if getattr(m, "bin_2_categorical", None):
            continue
        if dev is None:
            cnt = np.bincount(np.asarray(binned[:, j], np.int64),
                              minlength=m.num_bin)
        else:
            import torch
            cnt = torch.bincount(dev[:, j].long(),
                                 minlength=m.num_bin).cpu().numpy()
        pairs: List[Tuple[float, int]] = []
        nan_bin = m.num_bin - 1 if m.missing_type == MISSING_NAN else -1
        for b in range(m.num_bin):
            if cnt[b] == 0:
                continue
            v = 0.0 if b == nan_bin else float(m.bin_to_value(b))
            pairs.append((v, int(cnt[b])))
        if pairs:
            out[int(f)] = pairs
    return out


def format_distribution(dist: Dict[int, List[Tuple[float, int]]]) -> str:
    """The model file's ``feature_distribution:`` section."""
    lines = ["feature_distribution:"]
    for f in sorted(dist):
        body = " ".join(f"{v:.17g}:{c}" for v, c in dist[f])
        lines.append(f"{f}={body}")
    return "\n".join(lines) + "\n"


def parse_distribution(lines: Sequence[str]
                       ) -> Dict[int, List[Tuple[float, int]]]:
    """Inverse of :func:`format_distribution` over a model file's lines."""
    out: Dict[int, List[Tuple[float, int]]] = {}
    it = iter(lines)
    for line in it:
        if line.strip() == "feature_distribution:":
            break
    else:
        return out
    for line in it:
        s = line.strip()
        if not s or "=" not in s:
            break
        f, body = s.split("=", 1)
        try:
            pairs = [(float(p.split(":")[0]), int(p.split(":")[1]))
                     for p in body.split()]
        except (ValueError, IndexError):
            continue
        out[int(f)] = pairs
    return out


# -------------------------------------------------------------- serving drift


def psi(p_counts: np.ndarray, q_counts: np.ndarray,
        eps: float = 1e-6) -> float:
    """Population stability index between two count histograms
    (``lightgbm_tpu/obs/model_quality.py:551``)."""
    ps = p_counts.sum()
    qs = q_counts.sum()
    if ps <= 0 or qs <= 0:
        return 0.0
    p = np.maximum(p_counts / ps, eps)
    q = np.maximum(q_counts / qs, eps)
    return float(np.sum((p - q) * np.log(p / q)))


class DriftMonitor:
    """Serving-side train-against-serve distribution watchdog
    (``lightgbm_tpu/obs/model_quality.py:563``).

    Attached to an ``inference.PredictEngine``: every microbatch's binned
    rows fold into per-feature threshold-rank histograms on the device
    (:meth:`add_device_bins`, one scatter-add over ranks the engine made
    anyway, no host read).  Once a window holds ``window_rows`` served rows
    its histograms come to the host, each feature's PSI against the
    stored training distribution is computed, features past ``threshold``
    fire one ``feature_drift`` event each, and every feature exports a
    ``feature_drift`` gauge.  Windows, events and gauges are the JAX
    package's for the same rows and microbatches."""

    def __init__(self, bundle, distribution: Dict[int, List[Tuple[float,
                                                                  int]]],
                 feature_names: Optional[Sequence[str]] = None,
                 threshold: float = 0.2, window_rows: int = 4096):
        self.threshold = float(threshold)
        self.window_rows = max(int(window_rows), 1)
        self.feature_names = list(feature_names) if feature_names else None
        nb1 = bundle.num_bins + 1
        self.cols = np.asarray(bundle.cols, np.int64)
        # the training distribution in THIS bundle's rank space: rank =
        # searchsorted(thr64, value), the left-side rank the serving
        # binning gives the raw value
        self.ref = np.zeros((len(self.cols), nb1), np.float64)
        self.active = np.zeros(len(self.cols), bool)
        for i, f in enumerate(self.cols):
            pairs = distribution.get(int(f))
            u = bundle.thr64[i]
            if not pairs or not len(u):
                continue
            vals = np.asarray([v for v, _ in pairs], np.float64)
            cnts = np.asarray([c for _, c in pairs], np.float64)
            ranks = np.searchsorted(u, vals, side="left")
            np.add.at(self.ref[i], ranks, cnts)
            self.active[i] = True
        self._dev = None              # the window's counts on the device
        self.rows_in_window = 0
        self.rows_total = 0
        self.windows = 0
        self.last_psi = np.zeros(len(self.cols), np.float64)
        self.events_fired = 0
        # the window is folded, evaluated and read under one lock
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self.active.any())

    def _name(self, col: int) -> str:
        return _feature_name(self.feature_names, int(self.cols[col]))

    def add_device_bins(self, bins, rows: int) -> None:
        """Fold one microbatch's int32 ranks ``[Fc, rows]`` (a tensor on
        the engine's device) into the window's counts there; a full
        window is evaluated."""
        if not self.enabled or rows <= 0:
            return
        with self._lock:
            self._fold(bins, rows)

    def _fold(self, bins, rows: int) -> None:
        if self._dev is None or self._dev.device != bins.device:
            self._dev = torch.zeros(self.ref.shape, dtype=torch.float64,
                                    device=bins.device)
        self._dev.scatter_add_(1, bins.long(), torch.ones(
            bins.shape, dtype=torch.float64, device=bins.device))
        self.rows_in_window += int(rows)
        self.rows_total += int(rows)
        if self.rows_in_window >= self.window_rows:
            self._evaluate()

    def _evaluate(self) -> None:
        """The window's one host read: its counts, then each active
        feature's PSI and the events past the threshold."""
        obs = self._dev.cpu().numpy()     # a view of the counts on the CPU
        self.windows += 1
        for i in range(len(self.cols)):
            if not self.active[i]:
                continue
            self.last_psi[i] = psi(self.ref[i], obs[i])
            if self.threshold > 0 and self.last_psi[i] > self.threshold:
                self.events_fired += 1
                counters.event(
                    "feature_drift", feature=self._name(i),
                    psi=round(self.last_psi[i], 6),
                    threshold=self.threshold,
                    window_rows=self.rows_in_window, window=self.windows)
        self._dev.zero_()
        self.rows_in_window = 0

    def samples(self) -> list:
        """The live ``/metrics`` rows (the ModelServer folds these into
        its registered source)."""
        out = []
        with self._lock:
            for i in range(len(self.cols)):
                if self.active[i]:
                    out.append(("feature_drift", {"feature": self._name(i)},
                                float(self.last_psi[i]), "gauge"))
            out.append(("drift_windows", {}, float(self.windows),
                        "counter"))
        return out

    def stats(self) -> Dict[str, Any]:
        """The ``GET /stats`` drift block."""
        with self._lock:
            return self._stats()

    def _stats(self) -> Dict[str, Any]:
        return {
            "rows_seen": self.rows_total,
            "windows": self.windows,
            "window_rows": self.window_rows,
            "threshold": self.threshold,
            "events_fired": self.events_fired,
            "psi": {self._name(i): round(float(self.last_psi[i]), 6)
                    for i in range(len(self.cols)) if self.active[i]},
        }


# ------------------------------------------------------------------ TreeSHAP


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
