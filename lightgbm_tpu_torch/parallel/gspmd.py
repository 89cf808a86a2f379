"""The data-parallel learner: tree growing over a (batch, feature) mesh.

The port of ``lightgbm_tpu/parallel/gspmd.py:make_gspmd_grower``.  The JAX
package writes one program over global arrays and lets the XLA partitioner
insert the collectives; here the split step itself walks the shards of a
:class:`~.mesh.Mesh`:

* rows shard over ``batch``: batch shard ``i`` holds rows
  ``[i * n_loc, (i + 1) * n_loc)`` of the padded data (padding rows carry
  zero weights, so they reach no histogram sum and no leaf count);
* each ``(i, j)`` slot holds its batch shard's bins cut to column slice
  ``j`` as one contiguous tensor, made once per training (the port's
  counterpart of ``pack_island``, :186); the slices need not be equal;
* the partition is the direct row -> leaf map, not an ``order`` window:
  each device keeps one ``row_leaf`` over the rows of the batch shards it
  holds, and routing a split is one kernel over it (:305-320,
  ``ops/route.py:route_rows``), reading the split column from a
  column-major copy of those rows' bins.  Routing also keeps, per device,
  every leaf's rows in each batch shard it holds (``counts``, int32
  ``[shards held, L + 1]``, padding rows included).  A shard that several
  devices hold is routed and counted by each of them alike, and each
  reads its own copy: no count is summed across devices;
* the smaller child is measured on every ``(i, j)`` slot over its column
  slice (:204-240) by ``hist_local`` (the shard-local kernel, K3) with
  ``hist="fused"``, which reads the child's count in the shard from
  ``counts`` and picks its regime on the device, or by the masked
  scatter-add ``hist_flat`` with ``hist="flat"``.  The partials are
  summed over the batch shards in shard order on the primary device
  (:233), never with atomics across shards, so the sum does not change
  from run to run; the column slices are concatenated into the
  ``[F, B, 3]`` histogram.  The larger child is the parent minus it;
* split choice, depth gate, node records and the tree's unpacking are the
  serial grower's (``grower.LeafPool``), so under integer-valued weights,
  whose sums are exact in any order, the trees are the serial grower's
  trees;
* with EFB the histograms stay physical through the shard sum and the
  column concatenation, and the pool expands them into logical features
  before its scan: globally, as the JAX package's data-parallel learner
  does after its shard sum (:127).  A feature slice owns whole physical
  columns, so a bundle is never split across slices, and since the
  slices are concatenated before the scan the global expansion serves
  the feature-sliced learners too;
* with nibble packing (not for ``tree_learner=feature`` or
  ``data_feature``, as in the JAX package) each slot's histogram reads
  its shard of the packed storage matrix at width ``max(256, B)``, and
  the summed, concatenated histogram is unfolded into physical columns
  (:238) before the pool sees it; routing reads the unpacked bins.
* with block-sharded bins (``block_shard``, ``shard_axes=batch,feature``
  or the planner's choice; :89, :177-178) no device holds the
  column-major copy: each slot holds only its column slice of its batch
  shard, and routing reads the split column from the slice that owns it
  (``ops/route.py:route_rows_block``, through a device table of the
  slices' addresses, so the graph loop stays fixed-shape).  Unpacked,
  the histogram's slices are those slices; packed, the histogram keeps
  its packed slices and routing reads unpacked column slices beside
  them (the JAX package keeps the packed copy ``P(batch, None)``,
  :181-184).  With slots on several cards, the card that owns a shard's
  split column routes it, and that shard's map and counts then go to
  the other cards of its batch row (:meth:`GspmdGrower._merge_routes`):
  the copy that stands in for the collective XLA inserts for the
  column's read, its bytes counted in ``coll_stats``.  Over several
  processes each process's slots tile whole batch rows of the global
  mesh over its full feature extent (``parallel/mesh.py:
  mesh_shape_fits_processes``), so every split column of a process's
  rows lies in its own slices: it builds its table over its own slots
  and routes its own rows, and no collective enters the route; the
  histogram is summed over its shards, its slices concatenated and then
  all-reduced, as with replicated bins;

* under ``tree_learner=voting`` each batch shard's histogram stays its
  own (concatenated over its column slices): the pool keeps them per
  shard and votes (``parallel/learner.py``, the JAX package's shard_map
  ``VotingStrategy``);
* over several processes (:class:`Procs`) the data and voting learners
  extend the batch axis, each process over its own rows: the root's sums
  and each measured histogram (under voting, the votes and the voted
  features' histograms) are all-reduced, so every process holds the same
  bits and grows the same tree.  The feature learner extends the feature
  axis: every process holds every row, measures its own column slices
  and gathers the rest (a zeroed full histogram, its slices written in,
  all-reduced).  The root's sums are each shard's, added in shard order,
  in one process as across several.

The loop is the JAX package's ``lax.while_loop`` (:404, ``cond`` :284,
``body`` :289) as the serial grower runs it (``grower.SplitLoop``): one
split is one step over fixed-shape device tensors that reads the chosen
leaf, the step counter and the ``active`` flag from device memory, and
after the stop writes only to the pool's sink rows and moves no row.
With every mesh slot on one card, ``hist="fused"`` and one process the
step is captured once per training as a CUDA graph and replayed;
elsewhere (the CPU, ``hist="flat"``, slots on several cards, several
processes, whose collectives are not captured) it runs eagerly, the split
row copied to each card and the partials to the primary device, device
to device.  Either way the host reads the counters once every
``STOP_CHECK_STEPS`` steps and nothing else.  The learner's state lives
across trees, allocated once per training.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..data.packing import PackedBins, unfold_packed_hist
from ..grower import (FeatureMeta, GrowerConfig, LeafPool, SplitLoop,
                      _tensor_key)
from ..ops.histogram import hist_flat, hist_local, movable
from ..ops.route import make_block_bins, route_rows, route_rows_block
from ..ops.split import cat_group_accept
from . import sync
from .learner import VotingPool
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


class Procs(NamedTuple):
    """The processes a learner spans (``num_machines > 1``): their
    ``count``, this one's ``index``, and the mesh ``axis`` they extend.
    ``batch``: each process holds its own rows, its batch shards follow
    those of the processes before it, and the partial histograms are
    all-reduced.  ``feature`` (the feature learner): every process holds
    every row and measures its own column slices, which are gathered into
    the full histogram."""
    count: int
    index: int
    axis: str = BATCH_AXIS


def _to(dev: torch.device, *ts):
    return [None if t is None else t.to(dev) for t in ts]


class GspmdGrower(SplitLoop):
    """Grows trees over ``mesh`` from the padded bin matrix ``bins``
    ``[n_pad, F]`` uint8 or uint16, ``n_pad`` a multiple of the batch
    extent.  Call
    it with the global padded weights on ``mesh.primary``.  ``n_logical``
    is the features of the meta (F unless EFB bundled); ``packed`` the
    nibble-packed storage matrix of ``bins`` with its plan, which the
    histogram then reads instead.  Made once per training: it holds the
    learner's device state (each device's row -> leaf map, per-shard leaf
    counts and weights, the :class:`LeafPool`, the counters) and, once a
    tree has taken the graph loop, the captured step."""

    wrappers = (hist_local, route_rows, route_rows_block, cat_group_accept)

    def __init__(self, cfg: GrowerConfig, mesh: Mesh, bins: torch.Tensor,
                 hist: str = "fused", n_logical: Optional[int] = None,
                 packed: Optional[PackedBins] = None,
                 top_k: Optional[int] = None,
                 procs: Optional[Procs] = None,
                 block_shard: bool = False):
        if hist not in ("fused", "flat"):
            raise ValueError(f"hist must be fused or flat; got {hist!r}")
        d, fs = mesh.shape[BATCH_AXIS], mesh.shape[FEATURE_AXIS]
        n_pad, f = bins.shape
        if n_pad % d:
            raise ValueError(f"{n_pad} rows do not split evenly over {d} "
                             f"batch shards")
        if packed is not None and (packed.plan.num_phys_cols != f
                                   or packed.matrix.shape[0] != n_pad):
            raise ValueError("GspmdGrower: packed bins of the rows and "
                             "columns of bins")
        # counters: splits made, the active flag
        super().__init__(cfg, mesh.primary, 2)
        self.mesh, self.hist = mesh, hist
        self.n_loc = n_loc = n_pad // d
        # the plan of the unfold, where the partials are summed (the
        # slices below hold the storage matrix)
        self.pack = None if packed is None else packed.plan.to(mesh.primary)
        hsrc = bins if packed is None else packed.matrix
        self.hist_width = (cfg.max_bin if packed is None
                           else packed.hist_width(cfg.max_bin))
        # the processes: this one's slices of the feature axis when it
        # spans them, and the collectives' counts (stats["timed"] adds
        # their seconds, parallel/sync.py:all_reduce)
        self.procs = procs if procs is not None and procs.count > 1 \
            else None
        self.coll_stats: Dict[str, float] = {}
        p, r = ((1, 0) if self.procs is None
                else (self.procs.count, self.procs.index))
        self.n_cols = hsrc.shape[1]
        if self.procs is not None and self.procs.axis == FEATURE_AXIS:
            self.cols = column_slices(self.n_cols, fs * p)[r * fs:
                                                          (r + 1) * fs]
        else:
            self.cols = column_slices(self.n_cols, fs)
        L = cfg.num_leaves
        # the batch shards each device holds, in shard order; a device's
        # row -> leaf map, counts and routing cover all of them at once
        self.held = {dv: [i for i in range(d) if dv in mesh.devices[i]]
                     for dv in dict.fromkeys(sum(mesh.devices, []))}
        self.row_leaf = {dv: torch.zeros(len(held) * n_loc,
                                         dtype=torch.int32, device=dv)
                         for dv, held in self.held.items()}
        self.counts = {dv: torch.zeros((len(held), L + 1),
                                       dtype=torch.int32, device=dv)
                       for dv, held in self.held.items()}
        # the weights the step reads, copied in per tree
        self.weights = {dv: tuple(torch.empty(len(held) * n_loc,
                                              dtype=torch.float32, device=dv)
                                  for _ in range(3))
                        for dv, held in self.held.items()}
        # each slot's shard cut to its column slice, for the histogram
        self.slices = self._cut(hsrc, self.cols)
        # routing: block-sharded, each device's table of the slots it
        # holds (the histogram's slices, or unpacked slices beside packed
        # ones); else the column-major bins of each device's shards, copied
        # through the int16 view of uint16 bins (ops/histogram.py:movable)
        self.route_bins = self.route_slices = self.block = None
        if block_shard:
            rcols = column_slices(f, fs)
            if packed is not None:
                self.route_slices = self._cut(bins, rcols)
            rs = self.route_slices or self.slices
            edges = [c.start for c in rcols] + [f]
            self.block = {dv: make_block_bins(
                [[rs[i][j] if mesh.devices[i][j] == dv else None
                  for j in range(fs)] for i in held], edges, dv)
                for dv, held in self.held.items()}
        else:
            self.route_bins = {
                dv: movable(self._rows(bins, dv)).t().contiguous().to(
                    dv).view(bins.dtype) for dv in self.held}
        self.root_id = torch.zeros(1, dtype=torch.int32, device=self.device)
        # the histogram store, split pool and records, reset per tree; the
        # voting learner's keeps each batch shard's (parallel/learner.py),
        # its voters counted over the processes
        self.voting = top_k is not None
        if self.voting:
            self.pool = VotingPool(cfg, f, self.device, d, top_k,
                                   n_logical=n_logical, voters=d * p,
                                   first=r * d, reduce=self._reduce)
        else:
            self.pool = LeafPool(cfg, f, self.device, n_logical=n_logical)
        self.metas: Optional[Dict[torch.device, FeatureMeta]] = None
        self.bound = None

    def _cut(self, src: torch.Tensor, cols: List[range]):
        """Each slot's batch shard of ``src`` cut to its column slice of
        ``cols``, on the slot's device (a view where the slice is the
        whole width on ``src``'s device)."""
        n = self.n_loc
        return [[movable(src)[i * n:(i + 1) * n, c.start:c.stop].contiguous(
                 ).to(self.mesh.devices[i][j]).view(src.dtype)
                 for j, c in enumerate(cols)]
                for i in range(len(self.mesh.devices))]

    def _rows(self, t: torch.Tensor, dv: torch.device) -> torch.Tensor:
        """The rows of ``t`` (global order) that ``dv``'s shards hold."""
        held, n = self.held[dv], self.n_loc
        if held == list(range(held[0], held[-1] + 1)):
            return t[held[0] * n:(held[-1] + 1) * n]
        return torch.cat([movable(t)[i * n:(i + 1) * n]
                          for i in held]).view(t.dtype)

    def _shard(self, t: torch.Tensor, i: int, dv: torch.device):
        """Batch shard ``i``'s part of a tensor over ``dv``'s rows."""
        k = self.held[dv].index(i) * self.n_loc
        return t[k:k + self.n_loc]

    def _reduce(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """``t`` summed in place across the processes."""
        return sync.all_reduce(t, "sum", what, self.coll_stats)

    def _unfold(self, hist: torch.Tensor) -> torch.Tensor:
        """Packed storage columns unfolded into physical ones: ``[C, Bj,
        3]``, or ``[shards, C, Bj, 3]`` (the voters') as ``3 x shards``
        channels of one unfold."""
        if self.pack is None:
            return hist
        mb = self.cfg.max_bin
        if hist.dim() == 3:
            return unfold_packed_hist(hist, self.pack, mb)
        d, c, bj, s = hist.shape
        out = unfold_packed_hist(hist.permute(1, 2, 0, 3).reshape(
            c, bj, d * s), self.pack, mb)
        return out.view(out.shape[0], mb, d, s).permute(2, 0, 1, 3)

    def _measure(self, leaf_id: torch.Tensor) -> torch.Tensor:
        """The leaf's ``[F, B, 3]`` histogram on the primary device:
        per-slot partials, summed over the batch shards in shard order,
        column slices concatenated, then summed (or, when the processes
        span the feature axis, gathered) across the processes, packed
        columns unfolded.  Under voting, each batch shard's own ``[shards,
        F, B, 3]``.  ``leaf_id`` is an int32[1] on the primary device."""
        B = self.hist_width
        leaf_on = {dv: leaf_id.to(dv) for dv in self.held}
        w = self.weights
        if self.hist == "flat":     # weights masked to the leaf
            w = {dv: [x * m for x in w[dv]] for dv, m in (
                (dv, (self.row_leaf[dv] == leaf_on[dv]).to(torch.float32))
                for dv in self.held)}
        parts = [[] for _ in self.mesh.devices]
        for j in range(len(self.cols)):
            for i, devs in enumerate(self.mesh.devices):
                dv = devs[j]
                gw, hw, cw = (self._shard(x, i, dv) for x in w[dv])
                if self.hist == "fused":
                    part = hist_local(
                        self._shard(self.row_leaf[dv], i, dv), leaf_on[dv],
                        self.slices[i][j], gw, hw, cw, B,
                        leaf_rows=self.counts[dv][self.held[dv].index(i)])
                else:
                    part = hist_flat(self.slices[i][j], gw, hw, cw, B)
                parts[i].append(part.to(self.device))
        cat = lambda ps: ps[0] if len(ps) == 1 else torch.cat(ps)
        if self.voting:
            return self._unfold(torch.stack([cat(ps) for ps in parts]))
        cols = []
        for j in range(len(self.cols)):
            acc = parts[0][j]
            for i in range(1, len(parts)):
                acc = acc + parts[i][j]
            cols.append(acc)
        hist = cat(cols)
        if self.procs is not None and self.procs.axis == FEATURE_AXIS:
            full = hist.new_zeros((self.n_cols, *hist.shape[1:]))
            full[self.cols[0].start:self.cols[-1].stop] = hist
            hist = self._reduce(full, "gather_columns")
        elif self.procs is not None:
            hist = self._reduce(hist, "hist")
        return self._unfold(hist)

    def _root_sums(self, gw: torch.Tensor, hw: torch.Tensor,
                   cw: torch.Tensor):
        """The root's sums: each batch shard's, added in shard order, then
        across the processes that hold rows of their own; so one process
        of two shards and two processes of one each add the same sums."""
        n, acc = self.n_loc, None
        for i in range(len(self.mesh.devices)):
            part = torch.stack([x[i * n:(i + 1) * n].sum()
                                for x in (gw, hw, cw)])
            acc = part if acc is None else acc + part
        if self.procs is not None and self.procs.axis == BATCH_AXIS:
            acc = self._reduce(acc, "root_sums")
        return acc[0], acc[1], acc[2]

    def start(self, gw: torch.Tensor, hw: torch.Tensor, cw: torch.Tensor,
              meta: FeatureMeta, feat_valid: torch.Tensor) -> None:
        """Start a tree: the weights copied where the step reads them,
        every row in leaf 0 and every shard's count there, the counters
        cleared, and the pool reset with the root's histogram."""
        key = _tensor_key(*meta, feat_valid)
        if self.graph is not None and key != self.bound:
            raise ValueError("GspmdGrower: the split step was captured on "
                             "other metadata or feature mask")
        if key != self.bound:
            self.metas = {dv: FeatureMeta(*_to(dv, *meta))
                          for dv in self.held}
            self.bound = key
        for dv in self.held:
            for dst, src in zip(self.weights[dv], (gw, hw, cw)):
                dst.copy_(self._rows(src, dv))
            self.row_leaf[dv].zero_()
            self.counts[dv].zero_()
            self.counts[dv][:, 0].fill_(self.n_loc)
        self.start_counters()
        self.pool.reset(meta, feat_valid, self._measure(self.root_id),
                        *self._root_sums(gw, hw, cw))

    def step(self) -> bool:
        """One split: the body of ``make_gspmd_grower``'s loop (:289) over
        fixed-shape device tensors, with no host read.  The chosen leaf's
        rows are routed on each device by its pooled split, the node is
        recorded, and the smaller child is measured on every slot, its
        count in each shard read by the kernel from ``counts``."""
        pool = self.pool
        act, l, new, node = self.pick(pool)
        irow, frow, route = pool.split_args(l)
        merge = self.block is not None and len(self.held) > 1
        before = ({dv: c.clone() for dv, c in self.counts.items()}
                  if merge else None)
        for dv, rl in self.row_leaf.items():
            args = _to(dv, l, new, pool.si32, pool.scat, pool.scatb)
            if self.block is None:
                route_rows(rl, self.route_bins[dv], *args, self.metas[dv],
                           self.counts[dv])
            else:
                route_rows_block(rl, self.block[dv], *args, self.metas[dv],
                                 self.counts[dv])
        if merge:
            self._merge_routes(before)
        child_depth = pool.record(l, new, node, irow, frow, route[3],
                                  route[4])
        small_left = frow[2] <= frow[5]
        small_id = torch.where(small_left, l, new).int()
        pool.children(l, new, frow, small_left, self._measure(small_id),
                      child_depth)
        self.end_step(act)
        return True

    def _merge_routes(self, before: Dict[torch.device, torch.Tensor]
                      ) -> None:
        """Block-sharded bins with slots on several cards: each batch
        shard was routed only on the card that holds the slot owning the
        split column; give its routed map and counts to every card that
        holds the shard.  A route moves rows from the leaf to the new
        leaf, whose id is larger than every other, and leaves the other
        cards' copies as they were, so the routed map is the element-wise
        maximum of the copies and the routed counts are the copies' common
        start (``before``) plus the sum of their changes.  No host read.
        The bytes copied between cards are counted in ``coll_stats``."""
        n, moved = self.n_loc, 0
        for i in range(len(self.mesh.devices)):
            cards = [dv for dv in self.held if i in self.held[dv]]
            if len(cards) < 2:
                continue
            home, k0 = cards[0], self.held[cards[0]].index(i)
            rl = self._shard(self.row_leaf[home], i, home)
            delta = self.counts[home][k0] - before[home][k0]
            for dv in cards[1:]:
                k = self.held[dv].index(i)
                torch.maximum(rl, self._shard(self.row_leaf[dv], i,
                                              dv).to(home), out=rl)
                delta += (self.counts[dv][k] - before[dv][k]).to(home)
            self.counts[home][k0] = before[home][k0] + delta
            for dv in cards[1:]:
                k = self.held[dv].index(i)
                self._shard(self.row_leaf[dv], i, dv).copy_(rl)
                self.counts[dv][k].copy_(self.counts[home][k0])
            moved += 2 * (len(cards) - 1) * (
                n * 4 + self.counts[home].shape[1] * 4)
        self.coll_stats["block_route_bytes"] = (
            self.coll_stats.get("block_route_bytes", 0) + moved)
        self.coll_stats["block_route_bytes_per_split"] = moved

    def loop(self, loop: Optional[str]) -> str:
        """The split loop a tree takes: ``graph`` (every mesh slot on one
        card, ``hist="fused"``, one process: gloo's collectives cannot be
        captured) or ``eager``; None takes the graph where it can."""
        return self.choose_loop(
            loop, self.device.type == "cuda" and len(self.held) == 1
            and self.hist == "fused" and self.procs is None,
            "in one process with every mesh slot on one card and "
            "gspmd_hist=fused")

    def __call__(self, gw: torch.Tensor, hw: torch.Tensor, cw: torch.Tensor,
                 meta: FeatureMeta, feat_valid: torch.Tensor,
                 stats: Optional[Dict[str, int]] = None,
                 loop: Optional[str] = None):
        """Grow one tree from the global padded weights ``[n_pad]`` f32 on
        the primary device.  Returns ``(TreeArrays, row_leaf [n_pad] i32)``
        on the primary device.  ``loop`` is ``"graph"``, ``"eager"`` or
        None (:meth:`loop`); both grow the same tree.  ``stats`` counts
        ``host_syncs`` (reads of device state back to the host),
        ``splits``, ``steps`` (those after the stop included) and
        ``graph_replays``."""
        stats = stats if stats is not None else {}
        for k in ("host_syncs", "splits", "steps", "graph_replays"):
            stats.setdefault(k, 0)
        loop = self.loop(loop)
        replays = self.replays
        # the capture and the replays take the primary card's streams
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else nullcontext()):
            self.start(gw, hw, cw, meta, feat_valid)
            (splits, _), steps, reads = self.run_steps(loop)
        stats["host_syncs"] += reads
        stats["splits"] += splits
        stats["steps"] += steps
        stats["graph_replays"] += self.replays - replays
        out = torch.cat([
            self._shard(self.row_leaf[devs[0]], i, devs[0]).to(self.device)
            for i, devs in enumerate(self.mesh.devices)])
        return self.pool.tree(splits), out
