"""Prediction on the device.

* :class:`SoABundle` flattens the ensemble once into ``[T, P]``
  structure-of-arrays node tables, as ``lightgbm_tpu/inference.py:SoABundle``
  (:99) does.  Per used column, the sorted unique split thresholds form a
  table; raw features are binned against it with ``torch.searchsorted``
  (float64, so ``value <= threshold`` is decided exactly as the host
  ``Tree.predict`` decides it) and node thresholds become integer ranks
  into the same table.  A categorical node's bitset becomes a row of a
  ``[C, W]`` bool mask over raw category values (``inference.py:119-120``).
* :func:`traverse` descends every tree by gathers over depth
  (``inference.py:_traverse``, :317) and returns leaf indices; a
  categorical node sends a row left iff its value, truncated to an
  integer, is a category of the node's set (CategoricalDecision,
  tree.h:268-283): NaN (under NaN missing handling), negative and unseen
  values go right.  :meth:`SoABundle.go_matrix` takes the same decision
  (:func:`_go_left`) at every node of one tree, for TreeSHAP.
* :class:`Predictor` gives raw and transformed scores, leaf indices,
  margin early stopping and TreeSHAP contributions
  (``lightgbm_tpu/predictor.py:165-334``).
* :func:`predict_binned_leaf` routes a binned matrix through one freshly
  grown tree's device arrays (valid-set scores during training, and the
  out-of-bag rows of a tree grown on a bag);
* :func:`trees_scores_binned` routes a binned matrix through several host
  trees at once and returns their outputs ``[T, N]``
  (``lightgbm_tpu/predictor.py:98``): the rollback of an iteration and
  DART's dropped trees.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .grower import FeatureMeta, TreeArrays
from .ops.histogram import movable, widen
from .ops.route import decode_slot
from .tree import K_DEFAULT_LEFT_MASK, Tree

MISSING_NONE, MISSING_ZERO, MISSING_NAN = 0, 1, 2
ZERO_RANGE = 1e-20           # kZeroAsMissingValueRange (tree.py ZERO_RANGE)
TREES_PER_PASS = 64          # traversal batch: [trees, rows] index tensors
ROWS_PER_PASS = 1 << 16
BINNED_PASS_ELEMENTS = 1 << 24   # trees x rows of one binned traversal pass


class SoABundle:
    """The ensemble flattened once: node tables and leaf values on the
    device."""

    def __init__(self, trees: Sequence[Tree], device: torch.device,
                 num_class: int = 1):
        t_count = len(trees)
        self.num_class = max(num_class, 1)
        if t_count % self.num_class:
            raise ValueError(f"{t_count} trees are no whole number of "
                             f"iterations of {self.num_class}")
        p = max([t.num_leaves - 1 for t in trees] + [1])
        used = {}
        cat_bits, cat_rows = 1, 0
        for t in trees:
            for i in range(max(t.num_leaves - 1, 0)):
                vals = used.setdefault(int(t.split_feature[i]), [])
                if t.is_categorical(i):
                    cat_rows += 1
                    cat_bits = max(cat_bits, 32 * len(t.cat_bitset(i)))
                else:
                    vals.append(float(t.threshold[i]))
        self.cols = np.asarray(sorted(used), dtype=np.int64)
        col_of = {int(f): i for i, f in enumerate(self.cols)}
        thr64 = [np.unique(np.asarray(used[int(f)], np.float64))
                 for f in self.cols]
        nb = max([len(u) for u in thr64] + [1])
        table = np.full((max(len(self.cols), 1), nb), np.inf, np.float64)
        for i, u in enumerate(thr64):
            table[i, :len(u)] = u
        feat = np.zeros((t_count, p), np.int64)
        thr = np.zeros((t_count, p), np.int64)
        dl = np.zeros((t_count, p), bool)
        miss = np.zeros((t_count, p), np.int64)
        lc = np.full((t_count, p), -1, np.int64)   # stumps end at leaf 0
        rc = np.full((t_count, p), -1, np.int64)
        ic = np.zeros((t_count, p), bool)
        cref = np.zeros((t_count, p), np.int64)
        cmask = np.zeros((max(cat_rows, 1), cat_bits), bool)
        ci = 0
        lv = np.zeros((t_count, p + 1), np.float64)
        for ti, t in enumerate(trees):
            lv[ti, :t.num_leaves] = t.leaf_value[:t.num_leaves]
            nn = t.num_leaves - 1
            if nn <= 0:
                continue
            fc = np.asarray([col_of[int(f)] for f in t.split_feature[:nn]])
            feat[ti, :nn] = fc
            dl[ti, :nn] = (t.decision_type[:nn] & K_DEFAULT_LEFT_MASK) > 0
            miss[ti, :nn] = (t.decision_type[:nn].astype(np.int64) >> 2) & 3
            lc[ti, :nn] = t.left_child[:nn]
            rc[ti, :nn] = t.right_child[:nn]
            for i in range(nn):
                if t.is_categorical(i):
                    ic[ti, i] = True
                    cmask[ci] = t.cat_value_mask(i, cat_bits)
                    cref[ti, i] = ci
                    ci += 1
                else:
                    thr[ti, i] = np.searchsorted(thr64[fc[i]],
                                                 float(t.threshold[i]))
        self.num_trees = t_count
        self.num_nodes = [max(t.num_leaves - 1, 0) for t in trees]
        self.max_depth = max([t.max_depth() for t in trees] + [1])
        self.device = device
        put = lambda a: torch.from_numpy(a).to(device)
        self.thr_table = put(table)
        self.feat, self.thr, self.default_left = put(feat), put(thr), put(dl)
        self.miss, self.left, self.right = put(miss), put(lc), put(rc)
        self.is_cat, self.cat_ref, self.cat_mask = put(ic), put(cref), put(
            cmask)
        self.leaf_value = put(lv)

    def bin_rows(self, x: np.ndarray):
        """Raw ``[N, F]`` float64 rows -> device ``[Fc, N]`` threshold
        ranks, integer category values, and NaN and zero masks of the used
        columns."""
        xc = torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, np.float64)[:, self.cols].T)).to(self.device)
        nanm = torch.isnan(xc)
        xz = torch.where(nanm, torch.zeros_like(xc), xc)
        zerom = torch.abs(xz) <= ZERO_RANGE
        bins = torch.searchsorted(self.thr_table[:len(self.cols)], xz,
                                  side="left")
        cats = torch.clamp(torch.trunc(xz), -2.0 ** 31,
                           2.0 ** 31 - 1).long()
        return bins, cats, nanm, zerom

    def _leaf_passes(self, x: np.ndarray):
        """``(row slice, tree slice, [trees, rows] leaf indices)`` over
        passes of at most ``ROWS_PER_PASS`` rows and whole iterations of
        about ``TREES_PER_PASS`` trees: the one traversal behind scores,
        leaf indices and early stopping."""
        n, k = x.shape[0], self.num_class
        per_pass = max(TREES_PER_PASS // k, 1) * k
        for r0 in range(0, n, ROWS_PER_PASS):
            rs = slice(r0, min(n, r0 + ROWS_PER_PASS))
            binned = self.bin_rows(x[rs])
            for t0 in range(0, self.num_trees, per_pass):
                ts = slice(t0, t0 + per_pass)
                yield rs, ts, traverse(
                    *binned, self.feat[ts], self.thr[ts],
                    self.default_left[ts], self.miss[ts], self.left[ts],
                    self.right[ts], self.is_cat[ts], self.cat_ref[ts],
                    self.cat_mask, self.max_depth)

    def raw_scores(self, x: np.ndarray) -> np.ndarray:
        """Each class's sum of its trees' leaf values per row, float64
        ``[K, N]``: tree i adds to class ``i % K``."""
        n, k = x.shape[0], self.num_class
        out = torch.zeros((k, n), dtype=torch.float64, device=self.device)
        if not len(self.cols):          # stumps only: one leaf per tree
            out += self.leaf_value[:, 0].view(-1, k).sum(0)[:, None]
            return out.cpu().numpy()
        for rs, ts, leaf in self._leaf_passes(x):
            vals = self.leaf_value[ts].gather(1, leaf)
            out[:, rs] += vals.view(-1, k, vals.shape[1]).sum(0)
        return out.cpu().numpy()

    def leaves(self, x: np.ndarray) -> np.ndarray:
        """Each tree's leaf index of every row, int32 ``[T, N]`` on the
        host (``lightgbm_tpu/inference.py:739``)."""
        out = np.zeros((self.num_trees, x.shape[0]), np.int32)
        if len(self.cols):              # else stumps: every row at leaf 0
            for rs, ts, leaf in self._leaf_passes(x):
                out[ts, rs] = leaf.cpu().numpy()
        return out

    def go_matrix(self, t: int, binned) -> torch.Tensor:
        """Tree ``t``'s go-left decision at every internal node for every
        row of ``binned`` (:meth:`bin_rows`): bool ``[nodes, N]`` on the
        device, the decision :func:`traverse` takes at the nodes a row
        visits (``lightgbm_tpu/inference.py:259``)."""
        bins, cats, nanm, zerom = binned
        nn = self.num_nodes[t]
        f = self.feat[t, :nn]
        col = lambda a: a[t, :nn, None]
        return _go_left(bins.index_select(0, f), cats.index_select(0, f),
                        nanm.index_select(0, f), zerom.index_select(0, f),
                        col(self.miss), col(self.default_left),
                        col(self.thr), col(self.is_cat), col(self.cat_ref),
                        self.cat_mask)


def _go_left(b, c, isnan, iszero, mt, dl, thr, ic, cref, cat_mask):
    """Numerical/CategoricalDecision (tree.h:257-313) on gathered rows: the
    threshold rank ``b`` and category ``c`` of the node's column, its NaN
    and zero masks, and the node's missing type, default-left flag,
    threshold rank, categorical flag and mask row."""
    w = cat_mask.shape[1]
    nan_missing = (mt == MISSING_NAN) & isnan
    missing = nan_missing | ((mt == MISSING_ZERO) & iszero)
    go = torch.where(missing, dl, b <= thr)
    in_set = cat_mask.view(-1)[cref * w + c.clamp(0, w - 1)]
    go_cat = ~nan_missing & (c >= 0) & (c < w) & in_set
    return torch.where(ic, go_cat, go)


def traverse(bins, cats, nanm, zerom, feat, thr, dl, miss, lc, rc, ic,
             cat_ref, cat_mask, max_depth: int) -> torch.Tensor:
    """Descend T trees for every row: ``[Fc, N]`` binned rows -> ``[T, N]``
    leaf indices (Numerical/CategoricalDecision, tree.h:257-313).  Rows
    that reach a leaf keep it; the loop runs the ensemble's depth."""
    t_count, n = feat.shape[0], bins.shape[1]
    node = torch.zeros((t_count, n), dtype=torch.int64, device=bins.device)
    leaf = torch.zeros_like(node)
    for _ in range(max_depth):
        active = node >= 0
        nd = node.clamp(min=0)
        f = feat.gather(1, nd)
        go = _go_left(bins.gather(0, f), cats.gather(0, f),
                      nanm.gather(0, f), zerom.gather(0, f),
                      miss.gather(1, nd), dl.gather(1, nd),
                      thr.gather(1, nd), ic.gather(1, nd),
                      cat_ref.gather(1, nd), cat_mask)
        nxt = torch.where(go, lc.gather(1, nd), rc.gather(1, nd))
        leaf = torch.where(active & (nxt < 0), ~nxt, leaf)
        node = torch.where(active, nxt, node)
    return leaf


def binned_leaves(bins: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                  dl: torch.Tensor, lc: torch.Tensor, rc: torch.Tensor,
                  ic: torch.Tensor, cat: Optional[torch.Tensor],
                  meta: FeatureMeta, depth: int) -> torch.Tensor:
    """Leaf index ``[T, N]`` of every row of the ``[N, F]`` bin matrix
    (uint8, or uint16 read through its int16 view, ``ops/histogram.py:
    movable``) under T trees (tree.h:257-313 on bins), given as ``[T, P]``
    node
    tables: the column, threshold bin, default-left flag, children (``~leaf``
    below 0) and categorical flag of each node, and ``cat`` ``[T, P, W]``
    the bins a categorical node routes left (None where no tree has one).
    Node features are logical: with EFB's ``meta.col``/``meta.offset`` a
    node reads its feature's bundle column and decodes the slot
    (``ops/route.py:decode_bundle_bin``).  The loop runs ``depth`` levels,
    the trees' longest path."""
    t, p = feat.shape
    n, dev = bins.shape[0], bins.device
    flat = movable(bins).reshape(-1)
    row_off = torch.arange(n, device=dev) * bins.shape[1]
    if cat is not None:
        w = cat.shape[2]
        cat = cat.reshape(-1)
        base = (torch.arange(t, device=dev) * p)[:, None]
    node = torch.zeros((t, n), dtype=torch.int64, device=dev)
    leaf = torch.zeros_like(node)
    for _ in range(depth):
        active = node >= 0
        nd = node.clamp(min=0)
        f = feat.gather(1, nd)
        mt, nb, db = (meta.missing_type[f], meta.num_bin[f],
                      meta.default_bin[f])
        if meta.col is None:
            b = widen(flat[row_off + f])
        else:
            b = decode_slot(widen(flat[row_off + meta.col[f]]),
                            meta.offset[f], nb, db)
        missing = (((mt == MISSING_NAN) & (b == nb - 1))
                   | ((mt == MISSING_ZERO) & (b == db)))
        go = torch.where(missing, dl.gather(1, nd), b <= thr.gather(1, nd))
        if cat is not None:
            go = torch.where(ic.gather(1, nd),
                             cat[(base + nd) * w + b.clamp(0, w - 1)], go)
        nxt = torch.where(go, lc.gather(1, nd), rc.gather(1, nd))
        leaf = torch.where(active & (nxt < 0), ~nxt, leaf)
        node = torch.where(active, nxt, node)
    return leaf


def predict_binned_leaf(bins: torch.Tensor, tree: TreeArrays,
                        meta: FeatureMeta, max_depth: int) -> torch.Tensor:
    """Leaf index ``[N]`` of every row of the ``[N, F]`` bin matrix
    under one grown tree's device arrays."""
    one = lambda x: x.long()[None]
    return binned_leaves(bins, one(tree.split_feature),
                         one(tree.threshold_bin), tree.default_left[None],
                         one(tree.left_child), one(tree.right_child),
                         tree.is_cat[None], tree.cat_bins[None], meta,
                         max_depth)[0]


def trees_scores_binned(bins: torch.Tensor, trees: Sequence[Tree],
                        used_feature_index, meta: FeatureMeta,
                        bin_mappers) -> torch.Tensor:
    """Each host tree's output on every row of the ``[N, F]`` bin
    matrix: float32 ``[T, N]`` (leaf values rounded to float32, as
    ``lightgbm_tpu/predictor.py:98 trees_scores_binned`` has them).
    ``used_feature_index`` maps a tree's feature to its column of
    ``bins``; ``bin_mappers`` (per original feature) give the bin
    thresholds of a tree read from text and the bins of a categorical
    node's categories.  The trees pass in groups of at most
    ``BINNED_PASS_ELEMENTS`` trees x rows."""
    n, dev = bins.shape[0], bins.device
    if not trees:
        return torch.zeros((0, n), dtype=torch.float32, device=dev)
    p = max(max(t.num_leaves - 1, 1) for t in trees)
    num_t = len(trees)
    any_cat = any(t.num_cat > 0 for t in trees)
    width = int(meta.num_bin.max()) if any_cat else 0
    sf = np.zeros((num_t, p), np.int64)
    thr = np.zeros((num_t, p), np.int64)
    dl = np.zeros((num_t, p), bool)
    lc = np.full((num_t, p), -1, np.int64)       # stumps end at leaf 0
    rc = np.full((num_t, p), -1, np.int64)
    ic = np.zeros((num_t, p), bool)
    cm = np.zeros((num_t, p, width), bool) if any_cat else None
    lv = np.zeros((num_t, p + 1), np.float32)
    depth = np.zeros(num_t, np.int64)
    for ti, tree in enumerate(trees):
        nn = tree.num_leaves - 1
        lv[ti, :tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
        if nn <= 0:
            continue
        tree.ensure_binned(bin_mappers)
        depth[ti] = tree.max_depth()
        sf[ti, :nn] = [used_feature_index[int(f)]
                       for f in tree.split_feature[:nn]]
        thr[ti, :nn] = tree.threshold_bin[:nn]
        dl[ti, :nn] = (tree.decision_type[:nn] & K_DEFAULT_LEFT_MASK) > 0
        lc[ti, :nn] = tree.left_child[:nn]
        rc[ti, :nn] = tree.right_child[:nn]
        for i in range(nn):
            if tree.is_categorical(i):
                ic[ti, i] = True
                cm[ti, i] = tree.cat_bin_mask(
                    i, bin_mappers[int(tree.split_feature[i])], width)
    put = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    out = torch.empty((num_t, n), dtype=torch.float32, device=dev)
    per_pass = max(1, BINNED_PASS_ELEMENTS // max(n, 1))
    for t0 in range(0, num_t, per_pass):
        ts = slice(t0, t0 + per_pass)
        leaf = binned_leaves(bins, *(put(a[ts]) for a in (sf, thr, dl, lc,
                                                          rc, ic)),
                             put(None if cm is None else cm[ts]), meta,
                             int(depth[ts].max()))
        out[ts] = put(lv[ts]).gather(1, leaf)
    return out


class Predictor:
    """Raw and transformed predictions, leaf indices and TreeSHAP
    contributions of a list of trees, ``num_class`` a round
    (``lightgbm_tpu/predictor.py:Predictor``).  With ``average_output``
    (a random forest) the transformed output is the raw sum over the
    iterations, not passed through the objective
    (``gbdt_prediction.cpp:29-38``).  With ``early_stop`` a row stops
    adding trees once its margin reaches ``early_stop_margin``, checked
    every ``early_stop_freq`` iterations
    (``prediction_early_stop.cpp:13-70``)."""

    def __init__(self, trees: List[Tree], num_class: int, objective,
                 device: torch.device, average_output: bool = False,
                 early_stop: bool = False, early_stop_freq: int = 10,
                 early_stop_margin: float = 10.0,
                 bundle: Optional[SoABundle] = None):
        self.trees = trees
        self.k = max(num_class, 1)
        self.objective = objective
        self.average_output = average_output
        self.num_iteration = len(trees) // self.k
        self.early_stop = early_stop
        self.early_stop_freq = max(early_stop_freq, 1)
        self.early_stop_margin = early_stop_margin
        # the caller may hand in the bundle of these trees it already has
        self.bundle = bundle or SoABundle(trees, device, num_class)

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        """Raw scores ``[K, N]`` float64.  Early stopping takes every
        leaf from one traversal on the device, then replays the JAX
        package's margin loop on the host (``lightgbm_tpu/predictor.py:
        199-229``): float64 adds, iteration by iteration and class by
        class, over the rows still active, so its output is that
        package's bit for bit."""
        x = np.atleast_2d(x)
        if not self.early_stop:
            return self.bundle.raw_scores(x)
        leaves = self.bundle.leaves(x)
        lv = [t.leaf_value for t in self.trees]
        n = x.shape[0]
        out = np.zeros((self.k, n), dtype=np.float64)
        active = np.ones(n, dtype=bool)
        for it in range(self.num_iteration):
            if not active.any():
                break
            idx = np.nonzero(active)[0]
            for k in range(self.k):
                t = it * self.k + k
                out[k, idx] += lv[t][leaves[t, idx]]
            if (it + 1) % self.early_stop_freq == 0:
                margin = self._margin(out[:, idx])
                active[idx[margin >= self.early_stop_margin]] = False
        return out

    @staticmethod
    def _margin(scores: np.ndarray) -> np.ndarray:
        """One class: |s|; several: top1 - top2
        (prediction_early_stop.cpp)."""
        if scores.shape[0] == 1:
            return np.abs(scores[0])
        srt = np.sort(scores, axis=0)
        return srt[-1] - srt[-2]

    def predict(self, x: np.ndarray, raw_score: bool = False) -> np.ndarray:
        """``[N]`` for one class, else ``[N, K]``, as the reference's
        python package returns them; transformed by the objective unless
        ``raw_score``."""
        out = self.predict_raw(x)
        if not raw_score:
            if self.average_output:
                if self.num_iteration > 0:
                    out = out / self.num_iteration
            elif self.objective is not None:
                out = np.asarray(self.objective.convert_output(out),
                                 dtype=np.float64)
        return out[0] if out.shape[0] == 1 else out.T

    def predict_leaf_index(self, x: np.ndarray) -> np.ndarray:
        """Each tree's leaf index of every row, int32 ``[N, T]``."""
        return np.ascontiguousarray(self.bundle.leaves(np.atleast_2d(x)).T)

    def predict_contrib(self, x: np.ndarray,
                        num_features: Optional[int] = None) -> np.ndarray:
        """TreeSHAP contributions ``[N, K * (num_features + 1)]``
        (``pred_contrib``, gbdt.cpp PredictContrib): per class, each
        feature's SHAP value and the expected value last, summing to the
        raw score up to float64 rounding; divided by the iterations under
        ``average_output``.  Each tree's go-left matrix is computed on the
        device from the rows binned once a pass; the recursion
        (:mod:`.obs.model_quality`) runs in float64 on the host."""
        from .obs import model_quality as mq
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        n = x.shape[0]
        if num_features is None:
            num_features = x.shape[1]
        phi = np.zeros((n, self.k, num_features + 1), np.float64)
        bundle = self.bundle
        for r0 in range(0, n, ROWS_PER_PASS):
            rs = slice(r0, min(n, r0 + ROWS_PER_PASS))
            binned = bundle.bin_rows(x[rs]) if len(bundle.cols) else None
            for t, tree in enumerate(self.trees):
                go = (bundle.go_matrix(t, binned).cpu().numpy()
                      if tree.num_leaves > 1
                      else np.zeros((0, rs.stop - r0), bool))
                mq.tree_contribs(tree, go, num_features,
                                 phi[rs, t % self.k])
        if self.average_output and self.num_iteration > 0:
            phi /= self.num_iteration
        return phi.reshape(n, self.k * (num_features + 1))
