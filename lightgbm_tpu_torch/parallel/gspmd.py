"""The data-parallel learner: tree growing over a (batch, feature) mesh.

The port of ``lightgbm_tpu/parallel/gspmd.py:make_gspmd_grower`` as a host
loop like the serial grower (``grower.py:grow_tree``).  The JAX package
writes one program over global arrays and lets the XLA partitioner insert
the collectives; here the loop itself walks the shards of a
:class:`~.mesh.Mesh`:

* rows shard over ``batch``: batch shard ``i`` holds rows
  ``[i * n_loc, (i + 1) * n_loc)`` of the padded data (padding rows carry
  zero weights, so they reach no histogram sum and no leaf count);
* each ``(i, j)`` slot holds its batch shard's bins cut to column slice
  ``j`` as one contiguous tensor, made once per training (the port's
  counterpart of ``pack_island``, :186); the slices need not be equal;
* the partition is the direct row -> leaf map, not an ``order`` window:
  each device keeps one ``row_leaf`` over the rows of the batch shards it
  holds, and routing a split is one elementwise update of it (:302-320),
  reading the split column from a column-major copy of those rows' bins;
* the smaller child is measured on every ``(i, j)`` slot over its column
  slice (:204-240) by ``hist_local`` (the shard-local kernel, K3) with
  ``hist="fused"``, or by the masked scatter-add ``hist_flat`` with
  ``hist="flat"``.  The partials are summed over the batch shards in
  shard order on the primary device, never with atomics across shards,
  so the sum does not change from run to run; the column slices are
  concatenated into the ``[F, B, 3]`` histogram.  The larger child is
  the parent minus it;
* split choice, depth gate, node records and the tree's unpacking are the
  serial grower's (``grower.LeafPool``, ``route_goes_left``), so under
  integer-valued weights, whose sums are exact in any order, the trees
  are the serial grower's trees.

Each split makes one host read (the chosen leaf, its row count over all
shards and the stop test); the kernel takes the leaf id from device
memory, and the count bounds the smaller child's rows in every shard,
which picks the kernel's launch (``ops/histogram.py:plan_launch``).  A
slot's ``row_leaf`` and weights are views of its device's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..grower import FeatureMeta, GrowerConfig, LeafPool, route_goes_left
from ..ops.histogram import hist_flat, hist_local
from .mesh import BATCH_AXIS, FEATURE_AXIS, Mesh


def resolve_gspmd_hist(requested: str, device: torch.device) -> str:
    """``gspmd_hist`` as the learner runs it.  ``auto`` is the shard-local
    kernel on a card and, on the CPU, the flat scatter-add that ``auto``
    picks in the JAX package (``lightgbm_tpu/boosting.py:854``).  Neither
    formulation has a gate: the kernel takes each slot's column slice at
    its own width, so the even column split and the 512-column ceiling of
    the JAX package's fused layout do not apply."""
    if requested != "auto":
        return requested
    return "fused" if device.type == "cuda" else "flat"


def column_slices(n_cols: int, feature_shards: int) -> List[range]:
    """The columns of each feature slice, split as ``np.array_split``
    splits them: the first ``n_cols % feature_shards`` slices hold one
    column more."""
    edges = np.cumsum([0] + [len(a) for a in np.array_split(
        np.arange(n_cols), feature_shards)])
    return [range(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def _to(dev: torch.device, *ts):
    return [None if t is None else t.to(dev) for t in ts]


class GspmdGrower:
    """Grows trees over ``mesh`` from the padded bin matrix ``bins``
    ``[n_pad, F]`` uint8, ``n_pad`` a multiple of the batch extent.  Call
    it with the global padded weights on ``mesh.primary``."""

    def __init__(self, cfg: GrowerConfig, mesh: Mesh, bins: torch.Tensor,
                 hist: str = "fused"):
        if hist not in ("fused", "flat"):
            raise ValueError(f"hist must be fused or flat; got {hist!r}")
        d, fs = mesh.shape[BATCH_AXIS], mesh.shape[FEATURE_AXIS]
        n_pad, f = bins.shape
        if n_pad % d:
            raise ValueError(f"{n_pad} rows do not split evenly over {d} "
                             f"batch shards")
        self.cfg, self.mesh, self.hist = cfg, mesh, hist
        self.n_loc = n_pad // d
        self.cols = column_slices(f, fs)
        # the batch shards each device holds, in shard order; a device's
        # row -> leaf map and routing cover all of them at once
        self.held = {dv: [i for i in range(d) if dv in mesh.devices[i]]
                     for dv in dict.fromkeys(sum(mesh.devices, []))}
        # the positions, within a device's held shards, of those whose
        # routed rows it counts: a batch shard over several devices (a
        # feature extent above 1 over several cards) is counted once, on
        # the first device of its mesh row
        self.counted = {dv: [k for k, i in enumerate(held)
                             if mesh.devices[i][0] == dv]
                        for dv, held in self.held.items()}
        # column-major bins of each device's shards, for routing
        self.route_bins = {dv: self._rows(bins, dv).t().contiguous().to(dv)
                           for dv in self.held}
        # each slot's shard cut to its column slice, for the histogram
        self.slices = [[bins[i * self.n_loc:(i + 1) * self.n_loc,
                             c.start:c.stop].contiguous().to(
                                 mesh.devices[i][j])
                        for j, c in enumerate(self.cols)] for i in range(d)]

    def _rows(self, t: torch.Tensor, dv: torch.device) -> torch.Tensor:
        """The rows of ``t`` (global order) that ``dv``'s shards hold."""
        held, n = self.held[dv], self.n_loc
        if held == list(range(held[0], held[-1] + 1)):
            return t[held[0] * n:(held[-1] + 1) * n]
        return torch.cat([t[i * n:(i + 1) * n] for i in held])

    def _shard(self, t: torch.Tensor, i: int, dv: torch.device):
        """Batch shard ``i``'s part of a tensor over ``dv``'s rows."""
        k = self.held[dv].index(i) * self.n_loc
        return t[k:k + self.n_loc]

    def _count(self, mask: torch.Tensor, dv: torch.device):
        """The set rows of ``mask`` (over ``dv``'s held shards) in the
        shards that ``dv`` counts; None when it counts none."""
        ks, n = self.counted[dv], self.n_loc
        if len(ks) == len(self.held[dv]):
            return mask.sum()
        if not ks:
            return None
        return sum(mask[k * n:(k + 1) * n].sum() for k in ks)

    def _measure(self, row_leaf, leaf_id: torch.Tensor, w,
                 bound: int) -> torch.Tensor:
        """The leaf's ``[F, B, 3]`` histogram on the primary device:
        per-slot partials, summed over the batch shards in shard order,
        column slices concatenated.  ``bound`` bounds the leaf's rows in
        every shard and sizes the kernel's launch."""
        B = self.cfg.max_bin
        primary = self.mesh.primary
        leaf_on = {dv: leaf_id.to(dv) for dv in self.held}
        if self.hist == "flat":     # weights masked to the leaf
            w = {dv: [x * m for x in w[dv]] for dv, m in (
                (dv, (row_leaf[dv] == leaf_on[dv]).to(w[dv][0].dtype))
                for dv in self.held)}
        cols = []
        for j in range(len(self.cols)):
            acc = None
            for i in range(len(self.slices)):
                dv = self.mesh.devices[i][j]
                gw, hw, cw = (self._shard(x, i, dv) for x in w[dv])
                if self.hist == "fused":
                    part = hist_local(self._shard(row_leaf[dv], i, dv),
                                      leaf_on[dv], self.slices[i][j], gw, hw,
                                      cw, B, rows_upper_bound=bound)
                else:
                    part = hist_flat(self.slices[i][j], gw, hw, cw, B)
                part = part.to(primary)
                acc = part if acc is None else acc + part
            cols.append(acc)
        return cols[0] if len(cols) == 1 else torch.cat(cols)

    def __call__(self, gw: torch.Tensor, hw: torch.Tensor, cw: torch.Tensor,
                 meta: FeatureMeta, feat_valid: torch.Tensor,
                 stats: Optional[Dict[str, int]] = None):
        """Grow one tree from the global padded weights ``[n_pad]`` f32 on
        the primary device.  Returns ``(TreeArrays, row_leaf [n_pad] i32)``
        on the primary device; ``stats`` counts ``host_syncs`` and
        ``splits``."""
        cfg = self.cfg
        stats = stats if stats is not None else {}
        stats.setdefault("host_syncs", 0)
        stats.setdefault("splits", 0)
        # each device's weights and row -> leaf map over its shards' rows
        # (views of the inputs where the rows are contiguous and local)
        w = {dv: _to(dv, *(self._rows(x, dv) for x in (gw, hw, cw)))
             for dv in self.held}
        row_leaf = {dv: torch.zeros(len(held) * self.n_loc,
                                    dtype=torch.int32, device=dv)
                    for dv, held in self.held.items()}
        metas = {dv: FeatureMeta(*_to(dv, *meta)) for dv in self.held}
        primary = self.mesh.primary
        zero = torch.zeros(1, dtype=torch.int32, device=primary)
        n_pad = len(self.slices) * self.n_loc
        pool = LeafPool(cfg, meta, feat_valid,
                        self._measure(row_leaf, zero, w, n_pad),
                        gw.sum(), hw.sum(), cw.sum())
        # every leaf's rows over all shards, padding rows included: the
        # chosen leaf's count comes back with the split's one host read and
        # bounds its children's rows in any shard
        leaf_rows = torch.zeros((cfg.num_leaves, 1), dtype=torch.int64,
                                device=primary)
        leaf_rows[0] = n_pad

        step = 0
        for i in range(cfg.num_leaves - 1):
            l, cnt, positive = pool.next_leaf(leaf_rows)
            stats["host_syncs"] += 1
            if not positive:
                break
            new, node = i + 1, i
            irow, frow, route = pool.split_args(l)

            # --- routing: one elementwise update of each device's map ----
            moved = None
            for dv, binsT in self.route_bins.items():
                feat, thr, dleft, is_cat_l, cat_row = _to(dv, *route)
                goes_left = route_goes_left(
                    binsT.index_select(0, feat)[0].long(), metas[dv], feat,
                    thr, dleft, is_cat_l, cat_row)
                rl = row_leaf[dv]           # updated in place
                right = (rl == l) & ~goes_left
                rl.masked_fill_(right, new)
                n_right = self._count(right, dv)
                if n_right is not None:
                    n_right = n_right.to(primary)
                    moved = n_right if moved is None else moved + n_right
            leaf_rows[new] = moved
            leaf_rows[l] -= moved
            child_depth = pool.record(l, new, node, irow, frow, route[3],
                                      route[4])

            # --- smaller-child histogram; the pool derives the larger ----
            small_left = frow[2] <= frow[5]
            small_id = torch.where(small_left, l, new).int().view(1)
            pool.children(l, new, frow, small_left,
                          self._measure(row_leaf, small_id, w, cnt),
                          child_depth)
            step += 1
        stats["splits"] += step

        out = torch.cat([
            self._shard(row_leaf[devs[0]], i, devs[0]).to(primary)
            for i, devs in enumerate(self.mesh.devices)])
        return pool.tree(step), out
