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
  grown tree's device arrays (valid-set scores during training).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .grower import FeatureMeta, TreeArrays
from .tree import K_DEFAULT_LEFT_MASK, Tree

MISSING_NONE, MISSING_ZERO, MISSING_NAN = 0, 1, 2
ZERO_RANGE = 1e-20           # kZeroAsMissingValueRange (tree.py ZERO_RANGE)
TREES_PER_PASS = 64          # traversal batch: [trees, rows] index tensors
ROWS_PER_PASS = 1 << 16


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


def predict_binned_leaf(bins: torch.Tensor, tree: TreeArrays,
                        meta: FeatureMeta, max_depth: int) -> torch.Tensor:
    """Leaf index ``[N]`` of every row of the ``[N, F]`` uint8 matrix
    under one grown tree (tree.h:257-313 on bins)."""
    n = bins.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=bins.device)
    leaf = torch.zeros_like(node)
    sf = tree.split_feature.long()
    thr = tree.threshold_bin.long()
    lc, rc = tree.left_child.long(), tree.right_child.long()
    for _ in range(max_depth):
        active = node >= 0
        nd = node.clamp(min=0)
        f = sf[nd]
        b = bins.gather(1, f[:, None])[:, 0].long()
        mt = meta.missing_type[f]
        nb = meta.num_bin[f]
        db = meta.default_bin[f]
        missing = (((mt == MISSING_NAN) & (b == nb - 1))
                   | ((mt == MISSING_ZERO) & (b == db)))
        go = torch.where(missing, tree.default_left[nd], b <= thr[nd])
        cat_left = tree.cat_bins[nd, b.clamp(0, tree.cat_bins.shape[1] - 1)]
        go = torch.where(tree.is_cat[nd], cat_left, go)
        nxt = torch.where(go, lc[nd], rc[nd])
        leaf = torch.where(active & (nxt < 0), ~nxt, leaf)
        node = torch.where(active, nxt, node)
    return leaf


class Predictor:
    """Raw and transformed predictions of a list of trees, ``num_class``
    a round (``lightgbm_tpu/predictor.py:Predictor``)."""

    def __init__(self, trees: List[Tree], num_class: int, objective,
                 device: torch.device):
        self.objective = objective
        self.bundle = SoABundle(trees, device, num_class)

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        """Raw scores ``[K, N]`` float64."""
        return self.bundle.raw_scores(np.atleast_2d(x))

    def predict(self, x: np.ndarray, raw_score: bool = False) -> np.ndarray:
        """``[N]`` for one class, else ``[N, K]``, as the reference's
        python package returns them; transformed by the objective unless
        ``raw_score``."""
        out = self.predict_raw(x)
        if not raw_score and self.objective is not None:
            out = np.asarray(self.objective.convert_output(out),
                             dtype=np.float64)
        return out[0] if out.shape[0] == 1 else out.T
