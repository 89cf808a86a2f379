"""Prediction on the device.

* :class:`SoABundle` flattens the ensemble once into ``[T, P]``
  structure-of-arrays node tables, as ``lightgbm_tpu/inference.py:SoABundle``
  (:99) does, int32 and without the JAX package's pow2 padding.  Per used
  column, the sorted unique split thresholds form a float64 table; raw
  features are binned against it with ``torch.searchsorted`` (float64, so
  ``value <= threshold`` is decided exactly as the host ``Tree.predict``
  decides it, for every input) and node thresholds become integer ranks
  into the same table.  A categorical node's bitset becomes a row of a
  ``[C, W]`` bool mask over raw category values (``inference.py:119-120``).
  A numerical-only ensemble within the word budget also gets the two
  packed node words of ``inference.py:223-229``.
* The traversal (``ops/traverse.py:traverse``, ``csrc/traverse.cu`` on a
  card) gives leaf indices; a categorical node sends a row left iff its
  value, truncated to an integer, is a category of the node's set
  (CategoricalDecision, tree.h:268-283): NaN (under NaN missing handling),
  negative and unseen values go right.  The raw scores add each tree's
  leaf value to its class's score, trees oldest first, in float64
  (``ops/traverse.py:margin``): the JAX engine's order, bit for bit.
  :meth:`SoABundle.go_matrix` takes the same decision
  (``ops/traverse.py:go_left``) at every node of one tree, for TreeSHAP.
* :class:`Predictor` gives raw and transformed scores, leaf indices,
  margin early stopping and TreeSHAP contributions
  (``lightgbm_tpu/predictor.py:165-334``), the scores and leaves through
  its serving engine (``inference.py:PredictEngine``).
* :func:`predict_binned_leaf` routes a binned matrix through one freshly
  grown tree's device arrays (valid-set scores during training, and the
  out-of-bag rows of a tree grown on a bag);
* :func:`trees_scores_binned` routes a binned matrix through several host
  trees at once and returns their outputs ``[T, N]``
  (``lightgbm_tpu/predictor.py:98``): the rollback of an iteration and
  DART's dropped trees.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from .grower import FeatureMeta, TreeArrays
from .ops.histogram import movable, widen
from .ops.route import decode_slot
from .ops.traverse import go_left, margin, pack_data, pack_nodes, traverse
from .tree import K_DEFAULT_LEFT_MASK, Tree

MISSING_NONE, MISSING_ZERO, MISSING_NAN = 0, 1, 2
ZERO_RANGE = 1e-20           # kZeroAsMissingValueRange (tree.py ZERO_RANGE)
TREES_PER_PASS = 64          # traversal batch: [trees, rows] leaf tensors
ROWS_PER_PASS = 1 << 16
BINNED_PASS_ELEMENTS = 1 << 24   # trees x rows of one binned traversal pass
CAT_LO, CAT_HI = -2.0 ** 31, 2.0 ** 31 - 1   # int32 range of a category


class SoABundle:
    """The ensemble flattened once: node tables, threshold tables and leaf
    values on the device.  ``node_w0``/``node_w1`` are the packed layout's
    words, None where the ensemble does not fit the word budget
    (categorical nodes, more than 4,096 used columns, 65,536 threshold
    ranks or 32,767 nodes: ``lightgbm_tpu/inference.py:220-222``)."""

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
        self.thr64 = [np.unique(np.asarray(used[int(f)], np.float64))
                      for f in self.cols]
        nb = max([len(u) for u in self.thr64] + [1])
        table = np.full((max(len(self.cols), 1), nb), np.inf, np.float64)
        for i, u in enumerate(self.thr64):
            table[i, :len(u)] = u
        feat = np.zeros((t_count, p), np.int32)
        thr = np.zeros((t_count, p), np.int32)
        dl = np.zeros((t_count, p), bool)
        miss = np.zeros((t_count, p), np.int32)
        lc = np.full((t_count, p), -1, np.int32)   # stumps end at leaf 0
        rc = np.full((t_count, p), -1, np.int32)
        ic = np.zeros((t_count, p), bool)
        cref = np.zeros((t_count, p), np.int32)
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
            miss[ti, :nn] = (t.decision_type[:nn].astype(np.int32) >> 2) & 3
            lc[ti, :nn] = t.left_child[:nn]
            rc[ti, :nn] = t.right_child[:nn]
            for i in range(nn):
                if t.is_categorical(i):
                    ic[ti, i] = True
                    cmask[ci] = t.cat_value_mask(i, cat_bits)
                    cref[ti, i] = ci
                    ci += 1
                else:
                    thr[ti, i] = np.searchsorted(self.thr64[fc[i]],
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
        self.node_w0 = self.node_w1 = None
        packable = (not ic.any() and table.shape[0] <= 4096
                    and int(thr.max(initial=0)) <= 0xffff and p <= 32767
                    and nb < (1 << 24))
        if packable:
            self.node_w0, self.node_w1 = (w.to(device) for w in pack_nodes(
                *map(torch.from_numpy, (feat, thr, dl, miss, lc, rc))))

    @property
    def num_cols(self) -> int:
        return len(self.cols)

    @property
    def num_bins(self) -> int:
        return int(self.thr_table.shape[1])

    @property
    def packed(self) -> bool:
        return self.node_w0 is not None

    def exec_id(self) -> str:
        """The shape tag of this bundle's traversal (the JAX engine's
        executable identity, ``lightgbm_tpu/inference.py:141``)."""
        return (f"t{self.num_trees}p{self.feat.shape[1]}f{self.num_cols}"
                f"b{self.num_bins}c{self.cat_mask.shape[0]}"
                f"w{self.cat_mask.shape[1]}")

    def tensors(self) -> List[torch.Tensor]:
        """Every device tensor the bundle holds."""
        return [t for t in (self.thr_table, self.feat, self.thr,
                            self.default_left, self.miss, self.left,
                            self.right, self.is_cat, self.cat_ref,
                            self.cat_mask, self.leaf_value, self.node_w0,
                            self.node_w1) if t is not None]

    def nodes(self, layout: str = "xla", ts: slice = slice(None)) -> tuple:
        """The node tables of trees ``ts`` in ``layout``
        (``ops/traverse.py:traverse``'s ``nodes``)."""
        if layout == "packed":
            return self.node_w0[ts], self.node_w1[ts]
        return (self.feat[ts], self.thr[ts], self.default_left[ts],
                self.miss[ts], self.left[ts], self.right[ts],
                self.is_cat[ts], self.cat_ref[ts], self.cat_mask)

    def bin_columns(self, xc: torch.Tensor, bins: torch.Tensor,
                    cats: torch.Tensor, nanm: torch.Tensor,
                    zerom: torch.Tensor,
                    data: Optional[torch.Tensor] = None) -> None:
        """Bin the used columns ``xc`` (float64 ``[Fc, B]`` on the device,
        whose NaNs this sets to 0) into the given ``[Fc, B]`` tensors:
        int32 threshold ranks and category values, bool NaN and zero
        masks and, when ``data`` is given, the packed layout's data
        words."""
        torch.ne(xc, xc, out=nanm)
        xc.masked_fill_(nanm, 0.0)
        torch.le(xc.abs(), ZERO_RANGE, out=zerom)
        if xc.shape[0]:
            torch.searchsorted(self.thr_table[:xc.shape[0]], xc,
                               out_int32=True, out=bins)
        cats.copy_(torch.trunc(xc).clamp_(CAT_LO, CAT_HI))
        if data is not None:
            pack_data(bins, nanm, zerom, out=data)

    def bin_rows(self, x: np.ndarray):
        """Raw ``[N, F]`` float64 rows -> device ``[Fc, N]`` int32 threshold
        ranks and category values, and bool NaN and zero masks of the used
        columns."""
        return self.bin_used(np.asarray(x, np.float64)[:, self.cols])

    def bin_used(self, xc: np.ndarray):
        """:meth:`bin_rows` of the used columns' values ``[N, Fc]``."""
        xt = torch.from_numpy(np.ascontiguousarray(
            np.asarray(xc, np.float64).T)).to(self.device)
        shape = xt.shape
        out = (torch.empty(shape, dtype=torch.int32, device=self.device),
               torch.empty(shape, dtype=torch.int32, device=self.device),
               torch.empty(shape, dtype=torch.bool, device=self.device),
               torch.empty(shape, dtype=torch.bool, device=self.device))
        self.bin_columns(xt, *out)
        return out

    def _total(self, num_trees: Optional[int]) -> int:
        return (self.num_trees if num_trees is None or num_trees < 0
                else min(num_trees, self.num_trees))

    def _leaf_passes(self, xc: np.ndarray, total: int, layout: str = "xla",
                     rows_per_pass: Optional[int] = None, timers=None,
                     on_pass=None):
        """``(row slice, tree slice, [trees, rows] leaf indices)`` of the
        used columns' rows ``xc`` over passes of ``rows_per_pass`` rows
        (``ROWS_PER_PASS`` when None; rows outermost) and whole iterations
        of about ``TREES_PER_PASS`` of the first ``total`` trees, in
        ``layout``: the engine's path for inputs past its largest bucket
        (``inference.py``).  ``on_pass`` sees each pass's int32 ranks;
        ``timers`` (a ``PhaseTimers``) times the binning and traversal."""
        n, k = xc.shape[0], self.num_class
        step = rows_per_pass or ROWS_PER_PASS
        per_pass = max(TREES_PER_PASS // k, 1) * k
        phase = (timers.phase if timers is not None
                 else lambda name: contextlib.nullcontext())
        for r0 in range(0, n, step):
            rs = slice(r0, min(n, r0 + step))
            with phase("predict_bin"):
                binned = self.bin_used(xc[rs])
                if on_pass is not None:
                    on_pass(binned[0])
                if layout == "packed":
                    binned = (pack_data(binned[0], binned[2], binned[3]),)
            for t0 in range(0, total, per_pass):
                ts = slice(t0, min(total, t0 + per_pass))
                with phase("predict_traverse"):
                    leaf = traverse(binned, self.nodes(layout, ts), layout)
                yield rs, ts, leaf

    def pass_scores(self, xc: np.ndarray, total: int, **kw) -> np.ndarray:
        """Each class's sum of its trees' leaf values per row of the used
        columns' rows ``xc``, float64 ``[K, N]``: tree i adds to class ``i
        % K``, oldest first, over the first ``total`` trees, in
        :meth:`_leaf_passes` (``kw``)."""
        n, k = xc.shape[0], self.num_class
        out = np.zeros((k, n), np.float64)
        timers = kw.get("timers")
        phase = (timers.phase if timers is not None
                 else lambda name: contextlib.nullcontext())
        acc = None
        for rs, ts, leaf in self._leaf_passes(xc, total, **kw):
            with phase("predict_margin"):
                if ts.start == 0:
                    acc = torch.zeros((k, rs.stop - rs.start),
                                      dtype=torch.float64,
                                      device=self.device)
                margin(leaf, self.leaf_value[ts], k, acc)
                if ts.stop == total:
                    out[:, rs] = acc.cpu().numpy()
        return out

    def pass_leaves(self, xc: np.ndarray, **kw) -> np.ndarray:
        """Each tree's leaf index of every row of the used columns' rows
        ``xc``, int32 ``[T, N]`` on the host, in :meth:`_leaf_passes`
        (``kw``)."""
        out = np.zeros((self.num_trees, xc.shape[0]), np.int32)
        for rs, ts, leaf in self._leaf_passes(xc, self.num_trees, **kw):
            out[ts, rs] = leaf.cpu().numpy()
        return out

    def leaves(self, x: np.ndarray) -> np.ndarray:
        """:meth:`pass_leaves` of raw ``[N, F]`` rows
        (``lightgbm_tpu/inference.py:739``)."""
        return self.pass_leaves(np.asarray(x, np.float64)[:, self.cols])

    def go_matrix(self, t: int, binned) -> torch.Tensor:
        """Tree ``t``'s go-left decision at every internal node for every
        row of ``binned`` (:meth:`bin_rows`): bool ``[nodes, N]`` on the
        device, the decision the traversal takes at the nodes a row
        visits (``lightgbm_tpu/inference.py:259``)."""
        bins, cats, nanm, zerom = binned
        nn = self.num_nodes[t]
        f = self.feat[t, :nn].long()
        col = lambda a: a[t, :nn, None]
        return go_left(bins.index_select(0, f), cats.index_select(0, f),
                       nanm.index_select(0, f), zerom.index_select(0, f),
                       col(self.miss), col(self.default_left),
                       col(self.thr), col(self.is_cat),
                       col(self.cat_ref).long(), self.cat_mask)


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
    (``prediction_early_stop.cpp:13-70``).

    ``engine`` (an ``inference.PredictEngine`` over these trees or a
    longer list that starts with them) serves the scores and leaf indices
    (``lightgbm_tpu/predictor.py:192-229``, :307-328); without one, an
    engine over ``bundle`` (built here when not given) is made, so that
    every prediction takes the engine's one path: a microbatch up to
    its largest bucket, row passes above."""

    def __init__(self, trees: List[Tree], num_class: int, objective,
                 device: torch.device, average_output: bool = False,
                 early_stop: bool = False, early_stop_freq: int = 10,
                 early_stop_margin: float = 10.0,
                 bundle: Optional[SoABundle] = None, engine=None):
        self.trees = trees
        self.k = max(num_class, 1)
        self.objective = objective
        self.average_output = average_output
        self.num_iteration = len(trees) // self.k
        self.early_stop = early_stop
        self.early_stop_freq = max(early_stop_freq, 1)
        self.early_stop_margin = early_stop_margin
        if engine is None:
            from .inference import PredictEngine
            engine = PredictEngine(
                trees, num_class, device=device,
                bundle=bundle or SoABundle(trees, device, num_class))
        self.engine = engine
        self.bundle = engine.bundle

    def attach_engine(self, prewarm: bool = False) -> "Predictor":
        """The serving engine of these trees, over this predictor's
        bundle, prewarmed when asked (``lightgbm_tpu/predictor.py:192``):
        every predictor has one."""
        if prewarm and not self.engine._warmed:
            self.engine.prewarm()
        return self

    def _leaves(self, x: np.ndarray) -> np.ndarray:
        """Leaf indices ``[T, N]`` of these trees."""
        return self.engine.leaves(x)[:len(self.trees)]

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        """Raw scores ``[K, N]`` float64.  Early stopping takes every
        leaf from one traversal on the device, then replays the JAX
        package's margin loop on the host (``lightgbm_tpu/predictor.py:
        199-229``): float64 adds, iteration by iteration and class by
        class, over the rows still active, so its output is that
        package's bit for bit."""
        x = np.atleast_2d(x)
        if not self.early_stop:
            return self.engine.raw_scores(x, num_trees=len(self.trees))
        leaves = self._leaves(x)
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
        return self._transform(self.predict_raw(x), raw_score)

    def _transform(self, out: np.ndarray,
                   raw_score: bool = False) -> np.ndarray:
        """Raw scores ``[K, N]`` -> the user's output (also the serving
        loop's per-request step, so that raw and transformed requests
        share one traversal)."""
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
        return np.ascontiguousarray(self._leaves(np.atleast_2d(x)).T)

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
