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
  values go right.
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

    def raw_scores(self, x: np.ndarray) -> np.ndarray:
        """Each class's sum of its trees' leaf values per row, float64
        ``[K, N]``: tree i adds to class ``i % K``."""
        n, k = x.shape[0], self.num_class
        out = torch.zeros((k, n), dtype=torch.float64, device=self.device)
        if not len(self.cols):          # stumps only: one leaf per tree
            out += self.leaf_value[:, 0].view(-1, k).sum(0)[:, None]
            return out.cpu().numpy()
        # whole iterations a pass, so a pass's trees fold into [K, rows]
        per_pass = max(TREES_PER_PASS // k, 1) * k
        for r0 in range(0, n, ROWS_PER_PASS):
            bins, cats, nanm, zerom = self.bin_rows(
                x[r0:r0 + ROWS_PER_PASS])
            for t0 in range(0, self.num_trees, per_pass):
                ts = slice(t0, t0 + per_pass)
                leaf = traverse(bins, cats, nanm, zerom, self.feat[ts],
                                self.thr[ts], self.default_left[ts],
                                self.miss[ts], self.left[ts],
                                self.right[ts], self.is_cat[ts],
                                self.cat_ref[ts], self.cat_mask,
                                self.max_depth)
                vals = self.leaf_value[ts].gather(1, leaf)
                out[:, r0:r0 + ROWS_PER_PASS] += vals.view(
                    -1, k, vals.shape[1]).sum(0)
        return out.cpu().numpy()


def traverse(bins, cats, nanm, zerom, feat, thr, dl, miss, lc, rc, ic,
             cat_ref, cat_mask, max_depth: int) -> torch.Tensor:
    """Descend T trees for every row: ``[Fc, N]`` binned rows -> ``[T, N]``
    leaf indices (Numerical/CategoricalDecision, tree.h:257-313).  Rows
    that reach a leaf keep it; the loop runs the ensemble's depth."""
    t_count, n = feat.shape[0], bins.shape[1]
    w = cat_mask.shape[1]
    node = torch.zeros((t_count, n), dtype=torch.int64, device=bins.device)
    leaf = torch.zeros_like(node)
    for _ in range(max_depth):
        active = node >= 0
        nd = node.clamp(min=0)
        f = feat.gather(1, nd)
        b = bins.gather(0, f)
        mt = miss.gather(1, nd)
        nan_missing = (mt == MISSING_NAN) & nanm.gather(0, f)
        missing = nan_missing | ((mt == MISSING_ZERO) & zerom.gather(0, f))
        go = torch.where(missing, dl.gather(1, nd), b <= thr.gather(1, nd))
        c = cats.gather(0, f)
        in_set = cat_mask.view(-1)[cat_ref.gather(1, nd) * w
                                   + c.clamp(0, w - 1)]
        go_cat = ~nan_missing & (c >= 0) & (c < w) & in_set
        go = torch.where(ic.gather(1, nd), go_cat, go)
        nxt = torch.where(go, lc.gather(1, nd), rc.gather(1, nd))
        leaf = torch.where(active & (nxt < 0), ~nxt, leaf)
        node = torch.where(active, nxt, node)
    return leaf


def binned_leaves(bins: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                  dl: torch.Tensor, lc: torch.Tensor, rc: torch.Tensor,
                  ic: torch.Tensor, cat: Optional[torch.Tensor],
                  meta: FeatureMeta, depth: int) -> torch.Tensor:
    """Leaf index ``[T, N]`` of every row of the ``[N, F]`` uint8 matrix
    under T trees (tree.h:257-313 on bins), given as ``[T, P]`` node
    tables: the column, threshold bin, default-left flag, children (``~leaf``
    below 0) and categorical flag of each node, and ``cat`` ``[T, P, W]``
    the bins a categorical node routes left (None where no tree has one).
    Node features are logical: with EFB's ``meta.col``/``meta.offset`` a
    node reads its feature's bundle column and decodes the slot
    (``ops/route.py:decode_bundle_bin``).  The loop runs ``depth`` levels,
    the trees' longest path."""
    t, p = feat.shape
    n, dev = bins.shape[0], bins.device
    flat = bins.reshape(-1)
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
            b = flat[row_off + f].long()
        else:
            b = decode_slot(flat[row_off + meta.col[f]].long(),
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
    """Leaf index ``[N]`` of every row of the ``[N, F]`` uint8 matrix
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
    """Each host tree's output on every row of the ``[N, F]`` uint8
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
    """Raw and transformed predictions of a list of trees, ``num_class``
    a round (``lightgbm_tpu/predictor.py:Predictor``).  With
    ``average_output`` (a random forest) the transformed output is the raw
    sum over the iterations, not passed through the objective
    (``gbdt_prediction.cpp:29-38``)."""

    def __init__(self, trees: List[Tree], num_class: int, objective,
                 device: torch.device, average_output: bool = False):
        self.objective = objective
        self.average_output = average_output
        self.num_iteration = len(trees) // max(num_class, 1)
        self.bundle = SoABundle(trees, device, num_class)

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        """Raw scores ``[K, N]`` float64."""
        return self.bundle.raw_scores(np.atleast_2d(x))

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
