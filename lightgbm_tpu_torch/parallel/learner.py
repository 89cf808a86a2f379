"""The voting learner (PV-Tree): the port of ``VotingStrategy``
(``lightgbm_tpu/parallel/learner.py:215-308``, the reference's
``voting_parallel_tree_learner.cpp``).

Rows shard over the batch axis of the mesh, as in the data-parallel
learner, but the shards' histograms are not summed whole.  Each batch
shard is a *voter*; the voters are counted across all processes, rank by
rank, and within a rank in shard order.  For each leaf to scan:

* every voter scans its own histogram, with its own sums (each feature's
  bin sums: :func:`~..ops.split.per_feature_best_gain`), under
  ``min_data_in_leaf`` and ``min_sum_hessian_in_leaf`` divided by the
  number of voters (:223-237), and votes its ``k = min(top_k, F)`` best
  features (with EFB, after expanding its bundles with its own sums,
  :255-266);
* the votes ``[voters, k, (gain, feature)]`` are gathered: each process
  writes its voters' rows into a zeroed tensor and all-reduces it (adding
  zeros is exact); the global top ``2k`` votes by gain name the features;
* only those features' histograms are summed over the voters (in voter
  order, then across processes) and scanned with the leaf's global sums
  and the unscaled gates; the winning feature is mapped back to its
  global index;
* ``is_splittable`` comes only from that global scan: a feature not
  voted this time stays splittable.

Both top-k choices take ``lax.top_k``'s order, among equal gains the lower
index first, through a stable descending sort (``torch.topk`` promises no
order among ties); a feature voted twice is scanned twice, harmlessly.
With ``top_k`` at least F every feature is voted, and the trees are the
data-parallel learner's.

The pool keeps every voter's histograms (``[L + 1, voters, F, B, 3]``), so
the parent-minus-smaller subtraction stays in each voter's own space, as
in the JAX package, where ``reduce_hist`` is the identity for voting.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..grower import GrowerConfig, LeafPool, expand_bundle_hist
from ..ops.split import (SplitResult, best_split, per_feature_best_gain,
                         select_ctx)


def _top(values: torch.Tensor, k: int) -> torch.Tensor:
    """The positions of the ``k`` largest of each row, largest first, the
    lower position first among equals (``lax.top_k``'s order)."""
    return torch.sort(values, dim=-1, descending=True,
                      stable=True).indices[..., :k]


class VotingPool(LeafPool):
    """The split pool of the voting learner: :class:`LeafPool` with each
    leaf's histograms kept per local voter (``slots`` of them), and a
    :meth:`find` that votes.  ``voters`` counts the voters of every
    process, ``first`` is the index of this process's first voter, and
    ``reduce`` sums a tensor across processes in place (the identity in
    one process)."""

    def __init__(self, cfg: GrowerConfig, n_feat: int, device, slots: int,
                 top_k: int, n_logical: Optional[int] = None,
                 voters: Optional[int] = None, first: int = 0,
                 reduce: Callable[[torch.Tensor, str], torch.Tensor]
                 = lambda t, what: t):
        super().__init__(cfg, n_feat, device, n_logical=n_logical,
                         slots=slots)
        self.slots, self.top_k = slots, top_k
        self.voters = slots if voters is None else voters
        self.first, self.reduce = first, reduce
        # the local vote's gates, divided by the voters (:223-237)
        self.local_scfg = self.scfg._replace(
            min_data_in_leaf=cfg.min_data_in_leaf // self.voters,
            min_sum_hessian_in_leaf=(cfg.min_sum_hessian_in_leaf
                                     / self.voters))

    def find(self, hist: torch.Tensor, pg: torch.Tensor, ph: torch.Tensor,
             pc: torch.Tensor, feat_valid: torch.Tensor):
        """The voting find of K leaves (:240-308): ``hist [K, slots, Fp, B,
        3]`` the local histograms, ``pg``, ``ph``, ``pc`` ``[K]`` the
        leaves' global sums, ``feat_valid [K, F]``."""
        kk, s = hist.shape[:2]
        local = hist.reshape(kk * s, *hist.shape[2:])
        if self.maps is not None:
            # each voter's own leaf sums: every row lies in exactly one bin
            # of physical column 0
            own = local[:, 0].sum(dim=1)
            local = expand_bundle_hist(local, own[:, 0], own[:, 1],
                                       own[:, 2], self.maps)
        f = local.shape[1]
        k = min(self.top_k, f)
        fv = feat_valid.repeat_interleave(s, dim=0)
        sums = local.sum(dim=2)                         # [K * s, F, 3]
        gain = per_feature_best_gain(local, sums[..., 0], sums[..., 1],
                                     sums[..., 2], fv, self.local_scfg,
                                     self.ctx)
        top = _top(gain, k)
        votes = torch.stack([gain.gather(1, top), top.to(gain.dtype)],
                            dim=-1).view(kk, s, k, 2)
        if self.voters != s:
            every = votes.new_zeros((kk, self.voters, k, 2))
            every[:, self.first:self.first + s] = votes
            votes = self.reduce(every, "votes")
        votes = votes.reshape(kk, self.voters * k, 2)
        sel = votes[..., 1].gather(
            1, _top(votes[..., 0], min(2 * k, self.voters * k))).long()
        # the voted features' histograms, summed over the voters in order
        chosen = local.view(kk, s, f, *local.shape[2:]).gather(
            2, sel[:, None, :, None, None].expand(
                -1, s, -1, *local.shape[2:]))
        acc = chosen[:, 0]
        for v in range(1, s):
            acc = acc + chosen[:, v]
        if self.voters != s:
            acc = self.reduce(acc.contiguous(), "voted_hist")
        results, oks = [], []
        for c in range(kk):
            idx = sel[c]
            res, ok = best_split(acc[c:c + 1], pg[c:c + 1], ph[c:c + 1],
                                 pc[c:c + 1], feat_valid[c:c + 1, idx],
                                 self.scfg, select_ctx(self.ctx, idx))
            results.append(res._replace(feature=torch.where(
                res.found, idx[res.feature.clamp(min=0)], -1)))
            oks.append(torch.ones_like(feat_valid[c]).scatter(0, idx, ok[0]))
        return (SplitResult(*[torch.cat(v) for v in zip(*results)]),
                torch.stack(oks))
