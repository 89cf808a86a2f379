#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --multi-card     # on a machine with four cards

Phases, each printing one line of numbers; any failure exits non-zero:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. build every kernel from ``lightgbm_tpu_torch/csrc`` (one nvcc per
   source, all started together);
2. the histogram kernel against its plain PyTorch version on the card, at
   the Higgs path's shapes (1,000,000 x 28 uint8 bins), on windows of 0 to
   1,000,000 rows and on both sides of the regime threshold, each in both
   regimes: exact under integer-valued weights, a stated tolerance under
   float weights; with times (single call, back-to-back calls and the
   profiler's device time, beside ``index_add_``) at the root, 65,536 and
   4,097 rows.  Then the device regime as the split step launches it
   (both kernels over the grid of all rows, each gated by the true count,
   and the buffer set picked by a parity in device memory), at both
   parities, exact under integer weights: on the Higgs shapes gathered
   through ``order`` and on the Expo path's 11,000,000 x 8 leaf-ordered
   layout, at 0 to all rows and on both sides of the small kernel's
   largest count;
2b. the partition kernel (out of place) against its plain version as the
   split step calls it: over the grid of all rows (and over the window's
   own tiles), with the depth parity in device memory at 0 (first buffer
   set into the second) and 1 (second into first); windows of 0 to
   1,000,000 rows of a shuffled 1,000,000-row ``order`` with the
   ordered-mode payload of 28 bin columns, windows at the small launch's
   threshold and one either side, and the full root window of the
   Expo-shaped path with its 20-byte payload (uint8 bins); all left, all
   right and random, with and without the payload, into a destination
   full of garbage: window, payload and left count identical bit for bit,
   the
   destination outside the window and the source unchanged; with times
   over the grid of all rows (single call, back-to-back calls and the
   profiler's device time, beside a stable ``torch.sort`` of the 0/1 key
   and ``partition_window_sort``) at the root and 4,097 rows;
2c. the max_cat_group kernel of the categorical split scan against its
   plain loop at the Expo-shaped path's shape, at one position, with no
   position ok, at 42 lanes, past one 256-position chunk and with one
   minimum group size a leaf: accepts identical, ``torch.bool`` in and
   out; with the same three times and the latency bound from the
   kernel's SASS (:func:`cat_group_latency`);
2d. the shard-local histogram kernel against its plain version at the
   row-shard shapes of the data-parallel paths (250,000 x 28 and
   500,000 x 14 uint8 bins), with a row -> leaf map of 255 skewed leaves:
   all rows, a mid-sized leaf, a leaf of about 1,000 rows, an absent leaf
   and leaves of the regime threshold's rows, one less and one more, each
   in both regimes and in the device regime of the data-parallel split
   step (both kernels, each gated by the leaf's count, read from a
   per-leaf count in device memory), exact under integer weights; with
   times at all rows and the 1,000-row leaf, the device regime beside the
   host's plans;
2e. the route kernel (the split column of the chosen leaf's window,
   routed left or right) against its plain version, bit for bit: windows
   of 0 to 1,000,000 rows gathered through either of two ``order``
   buffers of the Higgs path's bins, and the Expo path's 11,000,000-row
   root in either buffer of its leaf-ordered bins, on splits of each
   missing type and a categorical one; with times beside the PyTorch
   gather + ``where`` of the eager loop.  Then on a bundled column: the
   Covertype-shaped task's 464,809 x 12 bins in its EFB layout (the 41-slot
   soil bundle, the 5-slot wilderness bundle), gathered through either
   ``order`` buffer at the root and a 4,000-row window, on two soil
   features (one zero-missing), a wilderness feature, a numeric column
   and a categorical split on a soil feature, the slot decoded in the
   kernel; with times at both windows;
2f. what the captured split step's gated launches cost at the Expo
   path's size: the partition over the grid of all rows and the
   histogram's device regime, against the partition over the window's own
   tiles and the histogram's host-picked plan, at an empty window, 4,097
   and 1,000,000 rows;
2g. the data-parallel route kernel (a device's row -> leaf map updated in
   place, and each row shard's count of every leaf) against its plain
   version, bit for bit in the map and exact in the counts: 1,000,000
   rows of 28 columns held as four shards, splits of each missing type and
   a categorical one from a large leaf, a leaf of about 1,000 rows and the
   root, and the sink after a tree's stop, which moves nothing; with
   times at the root and the 1,000-row leaf beside the byte bound.  Then
   the same splits as 2e's on the bundled Covertype layout (464,808 rows
   as four shards), from the root and from a leaf of about 4,000 rows,
   with times at both;
2i. every kernel on a uint16 bin matrix (:func:`check_wide_kernels`):
   K1 and K3 at 1,023, 4,097 (one column a block, in shared memory past
   48 KB) and 20,000 bins (one column's bins in two slices), every
   window and leaf in both regimes and the device regime, exact under
   integer weights and within 1e-5 of sum |w| of the float64 sum under
   float32; both route kernels bit for bit on 1,000,000 x 28 bins of
   1,023 (numeric splits past bin 255, a categorical split whose bins
   reach past it, and a bundled column) and on 11,000,000 x 8
   leaf-ordered bins of 283; ``cat_group`` at 4,096 and 4,097
   positions; K2 with the 28-byte payload of phase 19 over 11,000,000
   rows at both parities; with times, byte bounds and the PyTorch
   yardsticks;
2j. ``route_rows`` on a row-major block, as the streamed grower passes it
   (the ``[n, F]`` block's transpose, strides (1, F)), against its plain
   version and the kernel on the column-major copy, bit for bit in the map
   and exact in the counts (:func:`check_route_rows_block`): MS-LTR's
   262,144 x 137 default block and its 173,144-row last one, a uint16
   100,000 x 28 block at 1,023 bins and the bundled Covertype layout's
   262,144 x 12; splits of each missing type and a categorical one, from
   a leaf of many rows, of about 1,000 and the root, an absent leaf and
   the sink; with times at MS-LTR's block beside the column-major form
   and the sector bound;
3. the Higgs path at full width: seeded synthetic Higgs-shaped data
   (1,000,000 x 28 float32, binary label from a fixed nonlinear rule plus
   noise, 100,000 held-out rows), ``train`` 10 rounds with 255 leaves and
   255 bins and ``partition_impl=scatter`` (the eager loop, one host read
   a split; not profiled), ``predict`` the held-out rows; the histogram
   kernel must have launched once per tree plus once per split, the route
   kernel once per split;
3b. the same with ``partition_impl=auto``, which on a card is
   ``compact``: the split step is captured once and replayed as a CUDA
   graph.  A capture counts each kernel once without launching it and a
   replay launches without counting, so the launches are the counts plus
   (replays - 1) times the captured step's: once a step taken for the
   step's kernels (the steps after a tree's stop included, at most 31 a
   tree), plus once a tree for the root's histogram and categorical scan;
   splits exact, at most ceil(254 / 32) + 1 host reads a tree.  This phase
   and phase 5 print, for one profiled tree, the partition's calls,
   launches and windows by the launch that did their work, its device ms
   beside the sum of its calls' bounds, route's and cat_group's launches
   and device ms, the runtime's launch calls, with the run's peak device
   memory.  In every profiled tree of phases 3 to 7 the kernels that the
   profiler saw run on the card, by name, must equal those that the
   counts give;
3c. scatter (eager loop) and compact (graph loop) in turns on one
   dataset, ms per tree;
4. the card against the CPU on a 50,000-row Higgs subset, 3 rounds;
5. the Expo-shaped categorical path at full width: seeded synthetic
   airline-delay data (8 columns, 6 of them categorical, 11,000,000
   training and 100,000 held-out rows), ``train`` 10 rounds with 255
   leaves and 255 bins, ``partition_impl=compact`` and ``ordered_bins=on``;
   histogram launches = trees + splits, partition calls = splits, every
   column within 256 bins, at least one categorical split;
4b. the card against the CPU on a 50,000-row subset of the Expo-shaped
   task: one tree under integer-valued gradients identical field by
   field, and 3 rounds of ``train`` with the first tree identical and the
   held-out AUC within 5e-3;
6. (run right after phase 4, on its data) the data-parallel learner on
   the Higgs path at full width:
   ``tree_learner=data`` (``gspmd_hist=auto``, on a card the shard-local
   kernel) over a 4x1 mesh of four slots on the card, 10 rounds, by the
   graph loop (every slot on one card: the split step captured once and
   replayed); launches = counts + (replays - 1) x the captured step's:
   the shard-local kernel 4 x (trees + steps) (two kernels a call, each
   gated by the count), the route kernel once a step, the gather kernel
   never; at most ceil(254 / 32) + 1 host reads a tree; held-out AUC
   within 1e-4 of phase 3's.  For one profiled tree: the runtime's launch
   calls, the busy share, the shard-local kernel's device ms and its
   calls by the kernel that did the work, and the route kernel's;
6b. the same over a 2x2 mesh (14 columns a feature slice), 3 rounds (not
   profiled);
6c. one tree under integer-valued gradients grown on both meshes and on
   a 1x3 mesh of uneven column slices (10, 9 and 9) by the data-parallel
   eager loop and graph loop (three replayed trees under
   ``torch.cuda.set_sync_debug_mode("error")``, timed in turns with the
   eager ones), and by the serial grower: identical field by field; and
   ``gspmd_hist=flat`` against ``fused`` on a 50,000-row subset, 3
   rounds;
7. (after phase 3c on the Higgs path and after phase 5 on the Expo path,
   on their data) one tree under integer-valued gradients grown by the
   graph loop and by the eager loop (and on Higgs by ``scatter``):
   identical field by field; the graph loop's trees after its capture run
   under ``torch.cuda.set_sync_debug_mode("error")``, so any read to the
   host but the counted stop reads raises; ms a tree in turns (graph,
   eager), and one profiled tree of the graph loop: device-busy share,
   launch calls, host reads.

2h. (before phase 8, on its labels) the lambdarank kernel against its
   plain version on the card, float32: per document |dg| <= 1e-5 x the
   sum of |lam| over its pairs + 1e-7, and the same for h with |hes|, on
   queries of 1, 2, 31, 120, 1,251 and 10,000 documents (the last past the
   kernel's shared-memory staging), all-equal scores, all-zero labels and
   tied scores, with and without weights, and on the whole MS-LTR-shaped
   training set at random scores; with its times there (single,
   back-to-back, device), the plain version's, and the bound (bytes, or
   each pair's exp and reciprocals at the special-function rate);
8. the MS-LTR-shaped lambdarank task at full width and at the defaults:
   seeded synthetic MSLR-WEB30K-like data (2,270,296 x 137 float32 in
   18,919 queries of mean length 120, the longest 1,251; labels 0-4 in
   MSLR's shares; 750,000 held-out rows in 6,000 queries), ``train`` 10
   rounds with 255 leaves and 255 bins, ``ndcg_eval_at=1,3,5,10``: no
   column bundles, and the count columns of at most 16 bins pack two a
   byte, so K1 reads the packed storage matrix; the kernels of phase 3b
   plus one lambdarank launch a round, at most 8 host reads a tree, one
   capture, held-out NDCG@1/3/5/10 above round 1's, the gradient's ms a
   round by the kernel and by the plain version on the card, and K1's
   bytes a tree.  Then the cut run (``enable_bin_packing=false``) on the
   same Dataset, 10 rounds, with the same numbers but the profiled
   tree's: NDCG@10 within 1e-3,
   the first trees compared (identical, or where they first differ, by
   how much, and which choice has the higher float64 gain; a difference
   beyond the float32 rounding of its histogram subtraction chain fails,
   :func:`chain_tie`), and one round under integer-valued gradients
   identical in both layouts and on the 4x1 data-parallel learner;
8a. (on phase 8's packed storage matrix, 2,270,296 x 117 at width 256)
   K1 at the root and a 4,000-row window, in both regimes and the device
   regime (and at the root once more with joint bin 255, both nibbles
   15, forced into 10,000 rows), and K3 on the matrix cut into 4 row
   shards, at a leaf of 4,000 rows and the rest, in both regimes and
   the device regime, against their plain versions: exact under integer
   weights, within 1e-5 of sum |w| of the float64 sum under float32;
   both unfolded (K3's after the shard sum) equal to the plain histogram
   of the unpacked bins; K1's times and bounds on the packed matrix
   beside the unpacked bins;
8c. one round of the data-parallel learner over 4x1 on the one card at
   the defaults (K3 reads each shard's packed slice, unfolded after the
   shard sum): held-out NDCG@10 within 1e-3 of phase 8's first round;
8b. the card against the CPU on 100,000 rows of the same generator, 1
   round, at the defaults: the first tree identical in structure up to
   its first near-tie (the gradients are real-valued and the card adds
   them in another order, so a split whose float64 gain differs from the
   other choice's by less than the float32 sums' rounding may go either
   way;
   :func:`near_tie` checks that in float64), NDCG on phase 8's 6,000
   held-out queries within 1e-3, and the
   card's model saved beside the script, reloaded predicting the same,
   and removed;
9. the Covertype-shaped multiclass task at the defaults: 581,012 x 54 (10
   continuous, 4 wilderness and 40 soil one-hot columns), 7 classes in
   Covertype's shares, an 80/20 split, which EFB bundles into 12 columns
   (nothing packs); ``multiclass`` 3 rounds (21 trees) with 255 leaves:
   one capture of the split step, every later step of every tree a
   replay, at most 8 host reads a tree.  Then the cut run
   (``enable_bundle=false``, ``enable_bin_packing=false``) on its own
   Dataset, 3 rounds: held-out multi_logloss within 1e-4, the first
   round's trees compared as phase 8's and, as the witness of the card's
   summation order alone, the bundled first round trained again and
   compared with the first run's; one round under integer-valued
   gradients identical in both layouts;
9b. one round of ``multiclassova`` on the bundled Dataset (not
   profiled);
9c. one round over the 4x1 data-parallel mesh on the one card, bundled
   (not profiled): held-out multi_logloss within 1e-4 of phase 9's first
   round;
9e. one integer-gradient tree over the 1x4 mesh of
   ``tree_learner=feature`` (three bundled columns a slice) by the eager
   and graph loops, identical to the serial tree, as phase 6c;
9f, 9g. bagging in the subset regime (0.5) and DART (``drop_rate=0.5``,
   ``skip_drop=0``) on the bundled Dataset, 3 rounds each (not
   profiled): one capture,
   the training scores within 1e-5 of ``predict(raw_score=True)`` (the
   out-of-bag rows and DART's re-scoring through the decoded
   ``trees_scores_binned``), every bag's root 232,404 rows;
9d. the card against the CPU at 50,000 rows, 1 round, at the defaults:
   the first round's 7 trees identical in structure up to their first
   near-ties; and on the CPU's plain path, whose sums run in one fixed
   order, the bundled first round against the cut one's, compared as
   phase 9's;
10. (phases 10 to 14 on phase 3's Higgs-shaped data and one Dataset)
   bagging in the subset regime (``bagging_fraction=0.5``,
   ``bagging_freq=1``, 10 rounds, the graph loop): each tree's root window
   holds its 500,000 bag rows, the step is captured once for the
   training, and the training scores the loop kept (its out-of-bag rows
   routed through each tree) equal ``predict(raw_score=True)`` of the
   training rows within ``SCORE_LIMIT``; one profiled tree as in phase 3;
10b. bagging by weights (0.8) with ``feature_fraction=0.8``, 10 rounds:
   the bags' sizes and each tree's feature mask redrawn on the host from
   the seeds, every split inside its tree's mask, one capture (phases 10b
   to 13 not profiled);
10c. (after phase 14) the Expo-shaped task's Dataset of phase 5 in the
   subset regime with ``ordered_bins=on``, 3 rounds: root counts of
   5,500,000, one capture, scores equal to predict;
10d. phase 10b's settings over the 4x1 data-parallel mesh on the one
   card, 3 rounds: the same bags, held-out AUC within 1e-4 of phase 10b's
   at 3 rounds;
11. GOSS (``top_rate=0.2``, ``other_rate=0.1``), 13 rounds: 10 warm-up
   trees of every row, then 200,000 top rows plus about 100,000 others as
   the root window, one host read of the gradients a sampled round, one
   capture, scores equal to predict;
12. DART at its default rates (``drop_seed=3``: the default seed drops
   nothing in 10 rounds) with the held-out rows as a valid set, 10 rounds:
   rounds 3, 7, 8 and 10 drop trees, and the training and valid scores the
   loop kept equal the normalised model's predictions;
13. RF (bagging 0.5, ``feature_fraction=0.6``), 10 rounds: the model file
   carries ``average_output``, and its reload predicts the same;
14. the training API: a ``reset_parameter`` callback changing the
   learning rate and switching bagging off after round 2 (no new
   capture), ``rollback_one_iter`` restoring the training and valid
   scores bit for bit, a custom binary log loss growing the built-in
   objective's first tree, and ``cv`` with 3 folds of 200,000 rows and
   early stopping (its means and deviations);
14b. the card against the CPU on 50,000 rows, 3 rounds, for bagging,
   GOSS (learning rate 0.5, so round 3 samples) and DART: the first tree
   identical up to a near-tie;
15. the non-finite guard on 200,000 of those rows (L2 regression): each
   policy tripped once (``raise`` by a NaN label, ``rollback`` and
   ``clamp`` by a custom objective with one NaN gradient at its third
   call), a clean run tripping nothing; one capture and at most 8 host
   reads a tree each;
16. prediction breadth on phase 3b's, 5's and 9's models, read from their
   model text, on held-out rows: leaf indices (Higgs 100,000 rows, Expo
   4,000), margin early stopping (``pred_early_stop_freq=2`` and a
   margin that stops some rows, Higgs 100,000 rows and Covertype 4,000,
   the stopped share reported) and TreeSHAP contributions (4,000 rows of
   each), every call held against the same call on the CPU: leaf indices
   and early-stopped scores exactly, contributions within 1e-12 x (1 +
   |value|) on their first 1,000 rows, and each row's contributions
   summing to its raw score within 1e-9 x (1 + |raw|); the seconds of
   each call;
17. the Dataset inputs at the Higgs path's size (:func:`dataset_inputs`):
   CSV with a header and a ``.weight`` side file, LibSVM, two-round
   loading, the binary dataset file of the 1,000,000-row training
   Dataset and a CSR matrix of 70 % zeros, each binned as the same rows
   in memory, with the seconds of each parse, construction, save and
   load;
18. the Higgs-shaped task at ``max_bin=1023``, a uint16 bin matrix
   (:func:`higgs_wide_path`): 10 rounds by the serial graph loop and by
   the 4x1 data-parallel learner on the one card, the numbers of phase
   3b for both; one integer-gradient round identical on the CPU, the
   card and 4x1 at 50,000 rows and on the card and 4x1 at 1,000,000;
   3 rounds against the CPU at 50,000 rows as phase 4;
19. the Expo-shaped task over the full airport tail (Origin and Dest of
   about 283 bins, a uint16 matrix; :func:`expo_wide_path`), 11,000,000
   rows as phase 5, with the categorical splits that route a bin past
   255 counted; the integer-gradient tree and 3 rounds against the CPU at
   50,000 rows as phase 4b.
20. streamed training (``data_stream=chunked``): the pinned
   host-to-device rate of one 1 GiB copy, then (20a, after phase 6c)
   one integer-gradient tree of the Higgs-shaped task streamed at
   100,000 (10 blocks) and 333,334 rows (3, the last short), identical
   to the resident graph loop's tree, one tree under
   ``torch.cuda.set_sync_debug_mode("error")`` and one profiled; (20b,
   after phase 8c) phase 8's MS-LTR Dataset streamed at the default
   block size (9 blocks), 3 rounds, its packing turned off loudly,
   NDCG@10 within 1e-3 of the cut run's at 3 rounds and its peak device
   memory at least 200,000,000 bytes below it; (20c, last)
   phase 5's Expo Dataset streamed (42 blocks), ``ordered_bins=on``
   turned off loudly, the integer tree identical to the resident one, 3
   rounds with AUC within 5e-3 of phase 5's model at 3 iterations.  Each
   line: ms a tree, blocks, bytes and host reads a tree, ``route_rows``
   and ``hist_local`` launches a tree held against the counts, the
   link's bound and share of the wall, the device-busy share, and a
   host-to-device copy overlapping a kernel in the profiled tree.

21. the voting learner (``tree_learner=voting``, ``top_k=20``) over the
   4x1 mesh of the one card on the graph loop: (21a, after phase 6c) one
   integer-gradient tree of the Higgs path, where every feature is voted,
   identical to the data-parallel learner's tree (replays under the sync
   check), then 3 rounds of the path; (21b, after phase 8c) phase 8's
   MS-LTR Dataset, packed, by the voting and the data-parallel learner over
   4x1, 3 rounds each, held-out NDCG@10 within 5e-3, with ms a tree, the
   histogram bytes a split sums and the peak memory of each;
22. two processes on the one card (after 21a): this script started twice
   with ``--worker`` over a loopback machine list, ranks of a gloo group
   carrying CUDA tensors (NCCL refuses two ranks on a card), each holding
   half of phase 3's rows (all of them for the feature learner): the data
   learner's integer tree equal to the serial tree on all rows, 3 rounds
   byte-identical on both ranks with AUC within 1e-4 of the serial
   learner's; the voting learner's model texts identical on both ranks; the
   feature learner's integer tree equal to the serial one; the distributed
   FindBin's mappers equal to the serial fit of 200,000 rows both hold; ms
   a tree and the collectives' share of a timed tree; the data learner's
   5 rounds under score-following integer gradients identical on both
   ranks (phase 24c's reference).
24. checkpoints (after phase 22): (24a) phase 3's Dataset on the serial
   graph loop, 8 rounds with a snapshot every 2, under integer gradients
   and then the binary objective: uninterrupted, crashed by
   ``torn_checkpoint@6``, resumed (the torn 6 skipped, resumed at 4): the
   integer model byte-identical, the binary one's restored trees exact
   and its AUC within 1e-4, 8 host reads and 254 graph launches a tree
   kept on every iteration after the first, no snapshot read between
   snapshots; the snapshot's bytes and write seconds; (24b) this script
   started with ``--worker`` trains with ``preempt_signal=sigterm``, gets
   SIGTERM after its second tree, checkpoints and exits 0, and this
   process resumes it to the integer model of 24a; (24c) the supervisor
   runs two ``--worker`` ranks on the card over gloo,
   ``rank_crash@3:rank=1`` kills rank 1, the group is torn down,
   relaunched and resumed from the committed set: the model identical on
   both ranks and to phase 22's; the restart's seconds by leg.

With ``--multi-card`` it runs only the build and, with the four mesh
slots on four cards (where the split step runs eagerly), phase 6c's trees
and 3 rounds of phase 6's path; then four processes, one a card, over
NCCL, phase 22's data learner: the integer tree equal to the serial tree
and 3 rounds identical on every rank, and a snapshot set written every 2
rounds and resumed from at 2, byte-identical on every rank.

The second-to-last lines are a JSON object of per-kernel numbers and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12    # float32 outside the tensor cores
N_ROWS, N_FEAT, N_BINS = 1_000_000, 28, 255
N_HELDOUT = 100_000
N_EXPO = 11_000_000           # training rows of the Expo-shaped path
EXPO_CATEGORICAL = [0, 1, 2, 4, 5, 6]
MESH_SLOTS = 4                # mesh slots of the data-parallel paths
SEED = 20240611
H100_SFU_OPS_PER_S = 132 * 16 * 1.98e9   # 132 SMs x 16 MUFU results a
#   clock (exp2, reciprocal: CUDA C programming guide, compute capability
#   9.0 throughput table) x the 1.98 GHz boost clock behind the data
#   sheet's 67 TFLOP/s float32
N_MSLR, Q_MSLR = 2_270_296, 18_919    # MSLR-WEB30K fold 1 (LightGBM's
#                                       Experiments page)
MSLR_LONGEST = 1_251
Q_MSLR_HELDOUT, N_MSLR_HELDOUT = 6_000, 750_000
N_COVTYPE = 581_012
COVTYPE_SHARES = (0.365, 0.488, 0.062, 0.005, 0.016, 0.030, 0.035)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def phase(name: str, **numbers) -> None:
    """One line of numbers, led by the seconds since the script started."""
    print(f"[{name}] t={time.perf_counter() - _T0:.1f}s " +
          " ".join(f"{k}={v}" for k, v in numbers.items()), flush=True)


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_many(fn, calls: int = 200, warmup: int = 5) -> float:
    """Time per call of ``fn`` in ms, by CUDA events around ``calls``
    back-to-back calls: the host enqueues while the card runs, so this is
    the device time unless the host's work per call is longer."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def profiled_ms(fn, calls: int = 50, tries: int = 3):
    """Device time per call of ``fn`` in ms from ``torch.profiler``: every
    device-side event of ``calls`` calls (kernels, memsets, copies), and the
    kernels alone.  A window in which the profiler saw no device event is
    taken again, up to ``tries`` windows; then None, None."""
    import torch
    import torch.profiler as tp
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                    tp.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = [(e.key, getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(us for _, us in dev)
        if total:
            kernels = sum(us for k, us in dev if "memset" not in k.lower()
                          and "memcpy" not in k.lower())
            return total / 1e3 / calls, kernels / 1e3 / calls
    return None, None


def window_bound_ms(cnt: int, f: int, num_bins: int = N_BINS) -> float:
    """Least time of a window histogram: each row's order entry, bins and
    three weights read, (start, cnt) read and the [F, num_bins, 3] f32
    output written, over the memory rate; or 3 * F f32 adds a row over the
    f32 rate."""
    nbytes = cnt * (4 + f + 3 * 4) + 8 + f * num_bins * 3 * 4
    return max(nbytes / H100_BYTES_PER_S,
               3 * f * cnt / H100_F32_OPS_PER_S) * 1e3


def time_kernel(kernel, plain, library, bound_ms: float, large) -> dict:
    """A kernel beside its plain version and its one-call PyTorch
    yardstick, on the same inputs: the single-call median of ``cuda_ms``
    (``ms``, ``plain_ms``, ``library_ms``), CUDA events around back-to-back
    calls (``ms_many``, ``library_ms_many``) and the profiler's device time
    per call (``device_ms`` with the output's zeroing,
    ``device_kernel_ms`` without it, ``library_device_ms``).  ``large`` is
    the kernel under the large regime's plan that a path call of this
    shape takes below a parent above the threshold (``large_ms_many``,
    ``large_device_ms``)."""
    dev_ms, dev_kernel_ms = profiled_ms(kernel)
    lib_dev_ms, _ = profiled_ms(library)
    return dict(ms=cuda_ms(kernel), ms_many=cuda_ms_many(kernel),
                device_ms=dev_ms, device_kernel_ms=dev_kernel_ms,
                large_ms_many=cuda_ms_many(large),
                large_device_ms=profiled_ms(large)[0],
                plain_ms=cuda_ms(plain, reps=3), library_ms=cuda_ms(library),
                library_ms_many=cuda_ms_many(library),
                library_device_ms=lib_dev_ms, bound_ms=bound_ms)


def small_window_fields(main: dict, small: dict) -> dict:
    """The kernels line's extra fields of a histogram kernel: the other
    measures at its main shape, and all of them at its small shape (the
    4,097-row window, the 1,000-row leaf), where also in the large regime
    that the main path's calls of that size take under a large parent."""
    out = {k: main[k] for k in ("ms_many", "device_ms", "device_kernel_ms",
                                "library_ms_many", "library_device_ms")}
    out.update(ms_small=small["ms"], ms_small_many=small["ms_many"],
               device_ms_small=small["device_ms"],
               device_kernel_ms_small=small["device_kernel_ms"],
               library_ms_small=small["library_ms"],
               library_ms_small_many=small["library_ms_many"],
               library_device_ms_small=small["library_device_ms"],
               bound_ms_small=small["bound_ms"],
               ms_small_large_regime_many=small["large_ms_many"],
               device_ms_small_large_regime=small["large_device_ms"])
    return out


def higgs_like(n: int, rng: np.random.Generator):
    """Higgs-shaped synthetic task: 21 low-level kinematic-like columns
    (momenta, angles) and 7 high-level derived ones, binary label from a
    fixed nonlinear rule plus noise."""
    low = np.empty((n, 21), np.float32)
    low[:, 0::3] = rng.lognormal(0.0, 0.5, (n, 7))          # momenta
    low[:, 1::3] = rng.normal(0.0, 1.1, (n, 7))             # pseudorapidity
    low[:, 2::3] = rng.uniform(-np.pi, np.pi, (n, 7))       # azimuth
    high = np.empty((n, 7), np.float32)
    for k in range(7):
        a, b = low[:, 3 * k], low[:, (3 * k + 3) % 21]
        high[:, k] = np.sqrt(a * b * (1.0 + np.cos(low[:, 3 * k + 2]
                                                   - low[:, (3 * k + 5) % 21])))
    x = np.concatenate([low, high], axis=1)
    z = (1.2 * np.log(high[:, 0] + 0.5) - 0.8 * np.abs(low[:, 1])
         + 0.6 * np.sin(low[:, 2] * 2.0) * low[:, 3]
         + 0.5 * (high[:, 3] > 1.0) - 0.4 * high[:, 5]
         + 0.3 * low[:, 4] * low[:, 7] - 0.1)
    y = (z + rng.logistic(0.0, 0.6, n) > 0).astype(np.float32)
    return x, y


def expo_like(n: int, rng: np.random.Generator, full_tail: bool = False):
    """Expo-shaped synthetic task: the 8 columns of the airline-delay data
    (Month, DayofMonth, DayOfWeek, DepTime as hhmm, UniqueCarrier, Origin,
    Dest, Distance in miles), columns 0, 1, 2, 4, 5 and 6 categorical.

    Origin and Dest are 300 airport codes drawn with weights
    ``1 / (rank + 3) ** 1.1``.  By default the weights are cut at rank
    255: the 255 most frequent hold 99.7 % of the rows, so the binner,
    which keeps categories until they cover 99 % of the rows, keeps every
    column within 256 bins and the bin matrix is uint8 (phase 5 and the
    paths built on it keep this cut, so their numbers stay comparable
    from PR to PR).  ``full_tail`` draws over all 300 airports at the
    same weights, as the real airline data's long tail of small airports
    does: 99 % coverage then takes about 283 bins, and the bin matrix is
    uint16 (phase 19).
    The label, "departure delayed >= 15 min" at a 19 % rate, is a fixed
    rule: an hour-of-day effect, per-carrier, per-origin, weekday and
    month effects drawn from ``rng``, a distance effect and logistic
    noise, thresholded at their 81st percentile."""
    month = rng.integers(1, 13, n)
    dom = rng.integers(1, 32, n)
    dow = rng.integers(1, 8, n)
    hour_w = np.asarray([1, 0.5, 0.3, 0.2, 0.3, 2, 6, 8, 8, 7, 7, 7, 7, 7,
                         7, 7, 7, 7, 7, 6, 5, 4, 3, 2], np.float64)
    hour = rng.choice(24, n, p=hour_w / hour_w.sum())
    dep = hour * 100 + rng.integers(0, 60, n)
    dep = np.where(dep == 0, 2400, dep)
    carrier_w = 1.0 / np.arange(1, 23) ** 0.8
    carrier = rng.choice(22, n, p=carrier_w / carrier_w.sum())
    rank = np.arange(300)
    if full_tail:
        ap_w = 1.0 / (rank + 3.0) ** 1.1
        ap_w /= ap_w.sum()
    else:
        ap_w = np.where(rank < 255, 1.0 / (rank + 3.0) ** 1.1, 0.0)
        ap_w = 0.997 * ap_w / ap_w.sum()
        ap_w[255:] = 0.003 / 45
    origin = rng.permutation(300)[rng.choice(300, n, p=ap_w)]
    dest = rng.permutation(300)[rng.choice(300, n, p=ap_w)]
    dist = np.clip(rng.lognormal(6.3, 0.6, n), 30.0, 5000.0)
    eff_carrier = rng.normal(0.0, 0.4, 22)
    eff_origin = rng.normal(0.0, 0.5, 300)
    eff_dow = rng.normal(0.0, 0.2, 8)
    eff_month = rng.normal(0.0, 0.2, 13)
    z = (0.09 * np.maximum(hour - 5, 0) + eff_carrier[carrier]
         + eff_origin[origin] + eff_dow[dow] + eff_month[month]
         - 0.15 * np.log(dist / 500.0) + rng.logistic(0.0, 0.6, n))
    # the delay threshold puts 19 % of the flights above it
    y = (z > np.quantile(z, 0.81)).astype(np.float32)
    x = np.stack([month, dom, dow, dep, carrier, origin, dest, dist],
                 1).astype(np.float32)
    return x, y


def auc(score: np.ndarray, label: np.ndarray) -> float:
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.metadata import Metadata
    from lightgbm_tpu_torch.metrics import AUCMetric
    m = AUCMetric(Config())
    md = Metadata(len(label))
    md.set_label(label)
    m.init(md, len(label))
    return m.eval(np.asarray(score, np.float64)[None], None)[0]


MARKERS = 32          # spin kernels that open a profiled window
MARKER_CYCLES = 20_000  # each spins about 10 µs: the window the profiler
#                         can lose at its start is covered by time as well
#                         as by records
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemsetAsync",
                 "cudaMemcpyAsync", "cudaEventSynchronize",
                 "cudaStreamSynchronize")


def device_ms(fn, names):
    """Run ``fn`` under ``torch.profiler``; returns its wall seconds, the
    device ms of kernels whose name holds each of ``names``, the device ms
    of every kernel and copy (device-side events only: CPU ops would count
    their kernels' time a second time), the five host operations with the
    most self CPU ms, the calls of each of ``RUNTIME_CALLS``, and how
    many times each kernel of :data:`KERNELS` ran on the card (those of a
    replayed CUDA graph among them)."""
    import torch
    import torch.profiler as tp
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]) as prof:
        # the profiler can lose the first kernel records of a window (seen
        # on the H100: a root histogram of a tree missing): spin kernels
        # take that place, and are left out of every number below
        for _ in range(MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = {e.key: (getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
              for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "spin_kernel" not in e.key}
    per = {n: sum(v for k, v in dev_us.items() if n in k) / 1e3
           for n in names}
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)[:5]
    calls = {k: sum(e.count for e in events if e.key == k)
             for k in RUNTIME_CALLS}
    calls["cudaLaunchKernel"] -= MARKERS
    ran = {n: sum(e.count for e in events if n in e.key and e.device_type
                  == torch.autograd.DeviceType.CUDA)
           for n in sum(KERNELS.values(), ())}
    return wall, per, sum(dev_us.values()) / 1e3, host, calls, ran


# each wrapper's kernels, by a part of their profiler names: a histogram
# call of a host-picked regime launches its small or its large kernel, one
# of the device regime both; a partition call launches all three
KERNELS = {"hist_window": ("hist_gather_small", "hist_gather_large"),
           "lambdarank_grad": ("lgbt_lambdarank",),
           "hist_local": ("hist_local_small", "hist_local_large"),
           "partition_window": ("lgbt_partition_small",
                                "lgbt_partition_count",
                                "lgbt_partition_write"),
           "route_window": ("lgbt_route_kernel",),
           "route_rows": ("lgbt_route_rows",),
           "route_rows_block": ("lgbt_block_route",),
           "cat_group_accept": ("lgbt_cat_group",)}


def count_snapshot(fns) -> tuple:
    """Each wrapper's count and its counts by regime, now."""
    return ({k: fn.launches for k, fn in fns.items()},
            {k: dict(getattr(fn, "regime_launches", {}))
             for k, fn in fns.items()})


def kernels_launched(fns, snap, replays: int, per_step: dict) -> dict:
    """How many times each kernel of :data:`KERNELS` was launched on the
    card since ``snap`` (:func:`count_snapshot`): each wrapper's calls
    counted since then, plus ``replays`` times the calls ``per_step`` of
    the captured step (a replay launches without counting, and the step's
    histogram calls take the device regime)."""
    counts, regimes = snap
    out = {}
    for k, fn in fns.items():
        calls = fn.launches - counts[k] + replays * per_step.get(k, 0)
        if hasattr(fn, "regime_launches"):
            host = {r: v - regimes[k][r]
                    for r, v in fn.regime_launches.items()}
            both = calls - host["small"] - host["large"]
            small, large = KERNELS[k]
            out[small] = host["small"] + both
            out[large] = host["large"] + both
        else:
            out.update({kernel: calls for kernel in KERNELS[k]})
    return out


def profile_checked(name, fns, grow_one, stats, per_step, dev_names,
                    tries: int = 2):
    """Profile one tree, ``grow_one()``, with :func:`device_ms`, and hold
    the kernels that the profiler saw run on the card against those that
    the counts give (:func:`kernels_launched`; ``stats()`` returns the
    grower's stats so far, ``per_step`` is the captured step's counts).
    The profiler can lose a record, so a tree whose kernels differ is
    profiled again, up to ``tries`` trees; the run fails if each of them
    differs.  Returns the last tree's :func:`device_ms` result, the
    counts and the stats before it, and the trees that differed."""
    missed = []
    for _ in range(tries):
        snap, st0 = count_snapshot(fns), dict(stats())
        res = device_ms(grow_one, dev_names)
        want = kernels_launched(fns, snap, stats().get("graph_replays", 0)
                                - st0.get("graph_replays", 0), per_step)
        if res[5] == want:
            return res, snap, st0, missed
        missed.append({k: f"{res[5][k]}/{v}" for k, v in want.items()
                       if res[5][k] != v})
    fail(f"{name}: in {tries} profiled trees the kernels that ran on the "
         f"card differ from those the counts give (ran/counted): {missed}")


def part_bound_bytes(cnt: int, widths) -> int:
    """Least bytes a partition call moves: each window position's mask
    (1 B) read, and each matrix row (``widths`` in bytes, ``order``'s 4
    among them) read once and written once."""
    return cnt * (1 + 2 * sum(widths))


_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;\s*/\*\s*(0x[0-9a-f]+)")
_SASS_HI = re.compile(r"^\s*/\*\s*(0x[0-9a-f]{16})\s*\*/\s*$")
_FADD = re.compile(r"(?:@!?P\w+\s+)?FADD\s+(R\d+), (R\d+), (R\d+)")


def sass_instructions(text: str, kernel: str):
    """(address, instruction, stall cycles) of each instruction of the
    function whose name holds ``kernel`` in ``cuobjdump -sass`` output.
    The stall count is the 4-bit field that the compiler sets in each
    instruction's control bits (bits 105-108 of the 128-bit word, the
    second 64-bit word's bits 41-44): the cycles the warp waits before it
    issues its next instruction."""
    out, inside, pending = [], False, None
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if not inside:
            continue
        m = _SASS_LINE.search(line)
        if m:
            pending = (int(m.group(1), 16), m.group(2).strip())
            continue
        m = _SASS_HI.match(line)
        if m and pending:
            out.append((*pending, (int(m.group(1), 16) >> 41) & 0xF))
            pending = None
    return out


def chain_cycles(ins) -> dict:
    """The cycles of a cat_group kernel's chain from its SASS
    (:func:`sass_instructions`).  Its step loop is the backward branch's
    body with the most register ``FADD``s.  There:

    * ``cycles_per_add``: the running count is one chain of dependent
      ``FADD``s (each reads the one before); the longest such chain's
      issue distance in stall cycles, on the path where no position
      accepts (the accept blocks that forward branches skip left out),
      over its links is what a position costs;
    * ``cycles_per_accept``: the block that a forward branch skips when a
      position does not accept and that holds the division (``MUFU``), in
      stall cycles, without the division's slow path (the block skipped
      around its ``CALL``)."""
    addr = [a for a, _, _ in ins]
    target = lambda op: re.search(r"\bBRA\S*\s+`?\(?(0x[0-9a-f]+)", op)
    loops = []
    for i, (a, op, _) in enumerate(ins):
        m = target(op)
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in addr:
            loops.append((addr.index(int(m.group(1), 16)), i))
    fadds = lambda l: sum(bool(_FADD.match(ins[k][1]))
                          for k in range(l[0], l[1] + 1))
    if not loops or not max(fadds(l) for l in loops):
        return {"error": "no step loop found", "instructions": len(ins)}
    lo, hi = max(loops, key=fadds)
    body = ins[lo:hi + 1]
    chain = {}     # register -> (links, index of the chain's first FADD)
    best = (0, 0, 0)
    for k, (_, op, _) in enumerate(body):
        m = _FADD.match(op)
        if not m:
            continue
        prev = [chain[r] for r in m.groups()[1:] if r in chain]
        links, first = max(prev) if prev else (0, k)
        chain[m.group(1)] = (links + 1, first)
        if links + 1 > best[0]:
            best = (links + 1, first, k)
    regions = []
    for k, (a, op, _) in enumerate(body):
        m = target(op)
        if m and op.startswith("@") and a < int(m.group(1), 16) <= body[-1][0]:
            regions.append({j for j in range(k + 1, len(body))
                            if body[j][0] < int(m.group(1), 16)})
    skipped = set().union(*regions) if regions else set()
    links, first, last = best
    per_add = (sum(body[j][2] for j in range(first, last)
                   if j not in skipped) / (links - 1)
               if links > 1 else float("nan"))
    has = lambda reg, name: any(name in body[j][1] for j in reg)
    slow = set().union(*[r for r in regions
                         if has(r, "CALL") and not has(r, "MUFU")])
    accept = [r for r in regions if has(r, "MUFU")]
    per_accept = (min(sum(body[j][2] for j in r - slow) for r in accept)
                  if accept else float("nan"))
    return {"loop_instructions": len(body), "count_chain_adds": links,
            "cycles_per_add": per_add, "cycles_per_accept": per_accept}


def cat_group_latency(lib_path: str, kernel: str = "cat_group",
                      sass_out: str = None) -> dict:
    """:func:`chain_cycles` of the kernel whose name holds ``kernel`` in
    the library at ``lib_path`` (``cuobjdump -sass``), with the card's top
    SM clock from ``nvidia-smi``; ``sass_out`` keeps the listing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"error": "cuobjdump not found"}
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120).stdout
    if sass_out:
        with open(sass_out, "w") as f:
            f.write(text)
    out = chain_cycles(sass_instructions(text, kernel))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    out["sm_clock_max_mhz"] = (float(smi.split()[0]) if smi.strip()
                               else float("nan"))
    return out


def cat_group_bound_ms(lat: dict, positions: int, accepts: int) -> float:
    """Latency bound of a cat_group call: the longest lane's chain, a
    dependent add for each of its ``positions`` and an accept block for
    each of its ``accepts`` (what this call's data needs), at the SASS
    cycles of :func:`cat_group_latency` and the card's top SM clock."""
    return ((positions * lat["cycles_per_add"]
             + accepts * lat["cycles_per_accept"])
            / (lat["sm_clock_max_mhz"] * 1e3))


def three_times(fn) -> dict:
    """A kernel's or a yardstick's time three ways: the single-call median
    (``ms``), CUDA events around back-to-back calls (``ms_many``) and the
    profiler's device time per call (``device_ms``)."""
    return dict(ms=cuda_ms(fn), ms_many=cuda_ms_many(fn),
                device_ms=profiled_ms(fn)[0])


def check_partition(dev, rng):
    """Phase 2b: the partition kernel (out of place, src -> dst) against
    its plain version, bit for bit, as the split step calls it: over the
    grid of all rows (and over the window's own tiles), with the depth
    parity in device memory at 0 (first set -> second) and 1 (second ->
    first), into a destination full of garbage.  Outside the window the
    destination keeps its garbage, and the source is left as it was."""
    import torch
    from lightgbm_tpu_torch.ops.partition import (SMALL_MAX_ROWS,
                                                  partition_scratch,
                                                  partition_window,
                                                  partition_window_plain,
                                                  partition_window_sort,
                                                  plan_launch)

    def matrices(n, f, gen):
        """order and the ordered-mode payload: [n, f] bins, 3 weights"""
        return [torch.randperm(n, device=dev, generator=gen).int(),
                torch.randint(0, 256, (n, f), dtype=torch.uint8,
                              device=dev, generator=gen),
                *[torch.randn(n, device=dev, generator=gen)
                  for _ in range(3)]]

    def bits(x):
        return x.view(torch.uint8)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    n1 = N_ROWS
    t = SMALL_MAX_ROWS
    sets = {
        "1M": (n1, N_FEAT,
               [(12345, 0), (777, 1), (5000, 511), (40000, 4097),
                (300000, 100000), (0, n1), (n1 - 4097, 4097),
                (3, t - 1), (101, t), (7, t + 1)]),
        "root": (N_EXPO, len(EXPO_CATEGORICAL) + 2, [(0, N_EXPO)]),
    }
    checked = 0
    for label, (n, f, windows) in sets.items():
        pair = (matrices(n, f, gen), matrices(n, f, gen))
        keep = [[x.clone() for x in m] for m in pair]
        scratch = partition_scratch(n, dev)
        ref = [torch.empty_like(x) for x in pair[0]]
        odd = [torch.tensor([p], dtype=torch.int32, device=dev)
               for p in (0, 1)]
        for start, cnt in windows:
            sc = torch.tensor([start, cnt], dtype=torch.int64, device=dev)
            w = slice(start, start + cnt)
            # the step's grid (every row) at both parities, and the
            # window's own grid
            calls = [(0, n), (1, n)] + ([(0, cnt)] if cnt < n else [])
            for frac in (0.0, 1.0, 0.43):
                # the step's mask covers every row; the window's first cnt
                gl = torch.rand(n, device=dev, generator=gen) < frac
                for with_pay in (False, True):
                    k = len(ref) if with_pay else 1
                    for par, bound in calls:
                        src, dst = pair[par][:k], pair[1 - par][:k]
                        for a, b in zip(src, keep[par]):  # the last call's
                            a.copy_(b)                    # destination
                        npl = partition_window_plain(src, ref[:k], start,
                                                     cnt, gl)
                        for x in dst:      # garbage before the call
                            x.view(torch.uint8).random_(generator=gen)
                        before = [x.clone() for x in dst]
                        nk = partition_window(pair[0][:k], pair[1][:k], sc,
                                              gl, bound, scratch, odd[par])
                        torch.cuda.synchronize()
                        where = (f"window ({start}, {cnt}) of {label}, left "
                                 f"fraction {frac}, payload {with_pay}, "
                                 f"parity {par}, bound {bound}")
                        if not torch.equal(nk, npl) or not all(
                                torch.equal(a[w], b[w])
                                for a, b in zip(dst, ref)):
                            fail(f"partition kernel != plain at {where}")
                        # bit for bit: the garbage holds NaNs
                        if not all(torch.equal(bits(a[:start]),
                                               bits(b[:start]))
                                   and torch.equal(bits(a[start + cnt:]),
                                                   bits(b[start + cnt:]))
                                   for a, b in zip(dst, before)):
                            fail(f"partition kernel wrote outside the "
                                 f"window at {where}")
                        if not all(torch.equal(a, b) for a, b in
                                   zip(src, keep[par])):
                            fail(f"partition kernel wrote its source at "
                                 f"{where}")
                        del before
                        checked += 1
        phase("partition_vs_plain", set=label, rows=n, windows=len(windows),
              small_max_rows=t, parities="0,1", calls_checked=checked,
              exact=True)
        del pair, keep, ref

    # times at the main path's largest call (the root window of the
    # Expo-shaped path, with its ordered payload) and at a 4,097-row
    # window, both over the grid of all rows as the split step launches
    # them: the kernel, the stable sort of the 0/1 key (a yardstick of one
    # PyTorch call), and partition_window_sort (the whole function in
    # PyTorch calls: the key sort and each matrix's index_select)
    src = matrices(N_EXPO, len(EXPO_CATEGORICAL) + 2, gen)
    dst = [torch.empty_like(x) for x in src]
    scratch = partition_scratch(N_EXPO, dev)
    widths = [x[0].numel() * x.element_size() for x in src]
    timing = {}
    for start, cnt in ((0, N_EXPO), (40000, 4097)):
        sc = torch.tensor([start, cnt], dtype=torch.int64, device=dev)
        gl = torch.rand(N_EXPO, device=dev, generator=gen) < 0.43
        key = (~gl[:cnt]).to(torch.uint8)
        k = three_times(lambda: partition_window(src, dst, sc, gl, N_EXPO,
                                                 scratch))
        lib = three_times(lambda: torch.sort(key, stable=True))
        srt = three_times(lambda: partition_window_sort(src, dst, start, cnt,
                                                        gl))
        p_ms = cuda_ms(lambda: partition_window_plain(src, dst, start, cnt,
                                                      gl), reps=3)
        nbytes = part_bound_bytes(cnt, widths)
        bound_ms = nbytes / H100_BYTES_PER_S * 1e3
        timing[cnt] = dict(k, plain_ms=p_ms, library_ms=lib["ms"],
                           library_ms_many=lib["ms_many"],
                           library_device_ms=lib["device_ms"],
                           sort_form_ms=srt["ms"],
                           sort_form_ms_many=srt["ms_many"],
                           sort_form_device_ms=srt["device_ms"],
                           bound_ms=bound_ms,
                           launches_a_call=plan_launch(N_EXPO).launches)
        phase("partition_time", window_rows=cnt, grid_rows=N_EXPO,
              launches_a_call=plan_launch(N_EXPO).launches,
              row_bytes=sum(widths), **{
                  key_: f"{v:.4f}" for key_, v in timing[cnt].items()
                  if isinstance(v, float) and key_ != "bound_ms"},
              bound_bytes=nbytes, bound_ms=f"{bound_ms:.5f}",
              bound_share=f"{bound_ms / k['device_ms']:.3f}"
              if k["device_ms"] else "not measured")
    return timing


def check_cat_group(dev, rng):
    """Phase 2c: the max_cat_group kernel against its plain loop: at the
    Expo-shaped path's shape (2 leaves x 8 features x 2 directions x 255
    positions) at three count scales, at one position, with no position
    ok, at 42 lanes (not a multiple of a block's lanes), past one
    256-position chunk and with one minimum group size a leaf; accepts
    identical, ``torch.bool`` in and out.  Times at the path's shape, and
    the latency bound from the kernel's SASS."""
    import torch
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.ops.split import (cat_group_accept,
                                              cat_group_accept_plain)
    shape = (2, len(EXPO_CATEGORICAL) + 2, 2, N_BINS)

    def inputs(shape, mean_cnt, none_ok=False, per_leaf=False):
        step = torch.from_numpy(rng.poisson(mean_cnt, shape).astype(
            np.float32)).to(dev)
        ok = torch.from_numpy(rng.random(shape) < 0.8).to(dev)
        rc = torch.from_numpy(rng.integers(0, 10 ** 6, shape).astype(
            np.float32)).to(dev)
        m0 = np.maximum(1.0, np.floor(rng.integers(1, 10 ** 6, shape[:-1])
                                      / 64.0)).astype(np.float32)
        if per_leaf:
            m0 = np.ascontiguousarray(m0[:, :1, :1])
        return step, ok & (not none_ok), rc, torch.from_numpy(m0).to(dev)

    cases = {f"mean_count_{m:g}": inputs(shape, m)
             for m in (1.0, 40.0, 4000.0)}
    cases["one_position"] = inputs(shape[:-1] + (1,), 40.0)
    cases["none_ok"] = inputs(shape, 40.0, none_ok=True)
    cases["42_lanes"] = inputs((3, 7, 2, N_BINS), 40.0)
    cases["300_positions"] = inputs((1, 3, 2, 300), 4000.0)
    cases["mdpg0_per_leaf"] = inputs(shape, 40.0, per_leaf=True)
    for name, args in cases.items():
        k = cat_group_accept(*args, 64)
        p = cat_group_accept_plain(*args, 64)
        torch.cuda.synchronize()
        if k.dtype != torch.bool or not torch.equal(k, p):
            fail(f"cat_group kernel != plain loop in case {name}")
    size = int(np.prod(shape))
    nbytes = size * (4 + 1 + 4 + 1) + size // shape[-1] * 4
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    lat = cat_group_latency(build.library_path("cat_group"))
    timing = {}
    # a lane of the Expo-shaped path accepts about every fourth position,
    # as the mean count 4000 case does; the mean count 40 case rarely
    for name in ("mean_count_4000", "mean_count_40"):
        step, ok, rc, m0 = cases[name]
        t = three_times(lambda: cat_group_accept(step, ok, rc, m0, 64))
        p_ms = cuda_ms(lambda: cat_group_accept_plain(step, ok, rc, m0, 64),
                       reps=3)
        accepts = int(cat_group_accept_plain(step, ok, rc, m0, 64).view(
            -1, shape[-1]).sum(1).max())
        lat_ms = (cat_group_bound_ms(lat, shape[-1], accepts)
                  if "cycles_per_add" in lat else None)
        timing[name] = dict(t, plain_ms=p_ms, bound_ms=bound_ms,
                            latency_bound_ms=lat_ms,
                            max_accepts_a_lane=accepts)
        phase("cat_group_time", case=name, shape="x".join(map(str, shape)),
              **{k_: f"{v:.4f}" for k_, v in t.items() if v is not None},
              plain_ms=f"{p_ms:.4f}", bound_bytes=nbytes,
              bound_ms=f"{bound_ms:.6f}", max_accepts_a_lane=accepts,
              **{f"sass_{k_}": v for k_, v in lat.items()},
              latency_bound_ms=lat_ms,
              latency_share=f"{lat_ms / t['device_ms']:.3f}"
              if t["device_ms"] and lat_ms else "not measured")
    phase("cat_group_vs_plain", cases=",".join(cases), exact=True)
    return timing["mean_count_4000"], lat


def check_hist_window(dev, rng):
    """Phase 2: the window histogram kernel against its plain version at
    the Higgs path's shapes, every window in both regimes."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (SMALL_MAX_ROWS,
                                                  hist_window,
                                                  hist_window_plain,
                                                  plan_launch, sm_count)
    sms = sm_count(torch.cuda.current_device())
    plan = lambda bound, **kw: plan_launch(bound, N_FEAT, N_BINS,
                                           num_sms=sms, **kw)
    bins = torch.from_numpy(rng.integers(0, N_BINS, (N_ROWS, N_FEAT),
                                         dtype=np.uint8)).to(dev)
    order = torch.from_numpy(rng.permutation(N_ROWS).astype(np.int32)).to(dev)
    w_int = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-8, 9, N_ROWS).astype(np.float32),
        rng.integers(0, 5, N_ROWS).astype(np.float32),
        np.ones(N_ROWS, np.float32))]
    w_f32 = [torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal(N_ROWS).astype(np.float32),
        rng.uniform(0.0, 0.25, N_ROWS).astype(np.float32),
        np.ones(N_ROWS, np.float32))]
    # windows on both sides of the regime threshold; each in both regimes
    # (the small and the large forced, the large under the root's bound as
    # for a small child of a large parent) and under its own plan
    windows = [(12345, 0), (777, 1), (5000, 511), (40000, 4097),
               (100000, SMALL_MAX_ROWS), (200000, SMALL_MAX_ROWS + 1),
               (600000, 65536), (300000, 100000), (0, N_ROWS)]
    max_err_f32 = 0.0
    for start, cnt in windows:
        sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
        p_int = hist_window_plain(order, sc, bins, *w_int, N_BINS)
        plans = {"own": plan(cnt), "small": plan(cnt, small_max_rows=N_ROWS),
                 "large": plan(cnt, small_max_rows=-1),
                 "large_root_bound": plan(N_ROWS)}
        for name, pl in plans.items():
            k_int = hist_window(order, sc, bins, *w_int, N_BINS, cnt, pl)
            torch.cuda.synchronize()
            if not torch.equal(k_int, p_int):
                fail(f"kernel != plain under integer weights at window "
                     f"({start}, {cnt}), {name} plan {pl}: max |diff| "
                     f"{(k_int - p_int).abs().max().item()}")
        k = hist_window(order, sc, bins, *w_f32, N_BINS, cnt)
        p = hist_window_plain(order, sc, bins, *w_f32, N_BINS)
        # tolerance: 1e-5 of the bin's sum of magnitudes (float atomics
        # add in a run-dependent order; the error scales with sum |w|)
        mag = hist_window_plain(order, sc, bins,
                                *[w.abs() for w in w_f32], N_BINS)
        err = (k - p).abs()
        rel = (err / mag.clamp(min=1e-30)).max().item() if cnt else 0.0
        if rel > 1e-5:
            fail(f"kernel vs plain beyond 1e-5 of sum |w| at window "
                 f"({start}, {cnt}): {rel}")
        max_err_f32 = max(max_err_f32, err.max().item())
        phase("kernel_vs_plain", window=f"{start}+{cnt}",
              own_regime=plans["own"].regime,
              exact_int=",".join(plans),
              f32_max_abs_err=f"{err.max().item():.3e}",
              f32_max_rel_to_sum_abs=f"{rel:.3e}")

    # times at the root window (the Higgs path's largest call, N rows), at
    # a 65,536-row window (large regime) and a 4,097-row one (small regime;
    # and in the large regime, which the path's calls take when the
    # parent's count is above the threshold)
    timing = {}
    for start, cnt in ((0, N_ROWS), (600000, 65536), (40000, 4097)):
        sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
        idx = order[start:start + cnt].long()
        rows = bins.index_select(0, idx).long() + (
            torch.arange(N_FEAT, device=dev) * N_BINS)
        vals = torch.stack([w[idx] for w in w_f32], -1)[:, None, :].expand(
            -1, N_FEAT, 3).reshape(-1, 3).contiguous()
        flat = rows.reshape(-1)
        acc = torch.zeros((N_FEAT * N_BINS, 3), device=dev)
        timing[cnt] = t = time_kernel(
            lambda: hist_window(order, sc, bins, *w_f32, N_BINS, cnt),
            lambda: hist_window_plain(order, sc, bins, *w_f32, N_BINS),
            lambda: acc.index_add_(0, flat, vals),
            window_bound_ms(cnt, N_FEAT),
            lambda: hist_window(order, sc, bins, *w_f32, N_BINS, cnt,
                                plan(N_ROWS)))
        phase("kernel_time", window_rows=cnt, regime=plan(cnt).regime,
              **{k: f"{v:.4f}" if isinstance(v, float) else v
                 for k, v in t.items()},
              bound_share=f"{t['bound_ms'] / t['device_ms']:.4f}"
              if t["device_ms"] else "not measured")
    return timing, max_err_f32


def check_hist_device(dev, rng):
    """Phase 2, the device regime: the window histogram as the split step
    calls it (both kernels over the grid of all rows, each gated by the
    true count, and the buffer set picked by the depth parity in device
    memory) against its plain version on the set that the parity picks,
    exact under integer weights: the Higgs path's shapes, gathered
    through ``order`` (two sets of order, bins and weights), and the Expo
    path's 11,000,000 x 8 leaf-ordered layout (``order`` the identity, two
    sets of bins and weights); at 0 to all rows and on both sides of the
    small kernel's largest count."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (SMALL_MAX_WINDOW,
                                                  hist_window,
                                                  hist_window_plain,
                                                  plan_device, sm_count)
    sms = sm_count(torch.cuda.current_device())
    put = lambda a: torch.from_numpy(a).to(dev)
    t = SMALL_MAX_WINDOW
    layouts = {
        "higgs_gathered": (N_ROWS, N_FEAT, False,
                           [(12345, 0), (777, 1), (5000, 511),
                            (40000, 4097), (3, t - 1), (101, t),
                            (7, t + 1), (600000, 65536), (300000, 100000),
                            (0, N_ROWS)]),
        "expo_ordered": (N_EXPO, len(EXPO_CATEGORICAL) + 2, True,
                         [(12345, 0), (40000, 4097), (101, t), (7, t + 1),
                          (123457, 1_000_000), (N_EXPO - 5_500_001,
                                                5_500_001), (0, N_EXPO)]),
    }
    checked = 0
    for label, (n, f, ordered, windows) in layouts.items():
        iota = torch.arange(n, dtype=torch.int32, device=dev)

        def one_set():
            order = iota if ordered else put(
                rng.permutation(n).astype(np.int32))
            return (order, put(rng.integers(0, N_BINS, (n, f),
                                            dtype=np.uint8)),
                    put(rng.integers(-8, 9, n).astype(np.float32)),
                    put(rng.integers(0, 5, n).astype(np.float32)),
                    torch.ones(n, dtype=torch.float32, device=dev))

        sets = (one_set(), one_set())
        plan = plan_device(n, f, N_BINS, num_sms=sms)
        for start, cnt in windows:
            sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
            for par in (0, 1):
                sel = torch.tensor([par], dtype=torch.int32, device=dev)
                want = hist_window_plain(sets[par][0], sc, *sets[par][1:],
                                         N_BINS)
                got = hist_window(*sets[0][:1], sc, *sets[0][1:], N_BINS,
                                  plan=plan, alt=sets[1], sel=sel)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"device-regime histogram != plain at window "
                         f"({start}, {cnt}) of {label}, parity {par}: max "
                         f"|diff| {(got - want).abs().max().item()}")
                checked += 1
        phase("hist_device_vs_plain", layout=label, rows=n, features=f,
              windows=len(windows), small_max_window=t, parities="0,1",
              calls_checked=checked, exact_int=True)
        del sets, iota


def local_bound_ms(n_loc: int, cnt: int, fc: int) -> float:
    """Least time of a shard-local histogram call: row_leaf read for every
    local row, the matching rows' bin bytes and three weights read, the
    leaf id read and the [Fc, 255, 3] f32 output written, over the memory
    rate; or 3 * Fc f32 adds a matching row over the f32 rate."""
    nbytes = 4 * n_loc + cnt * (fc + 12) + 4 + fc * N_BINS * 3 * 4
    return max(nbytes / H100_BYTES_PER_S,
               3 * fc * cnt / H100_F32_OPS_PER_S) * 1e3


def check_hist_local(dev, rng):
    """Phase 2d: the shard-local histogram kernel against its plain
    version at the row-shard shapes of the 4x1 and 2x2 meshes, every leaf
    in both regimes and in the device regime of the data-parallel split
    step (both kernels over the shard, each gated by the leaf's count,
    which the kernel reads from a per-leaf count in device memory): all
    rows, a leaf of about 1,000 rows, an absent leaf (count 0), and
    leaves of 65,535, 65,536 and 65,537 rows either side of the gate.
    Times at all rows and at the 1,000-row leaf: the device regime as the
    split step launches it, beside the host's plan at the leaf's count
    (``host_plan_*``) and the large regime under the shard's bound
    (``large_*``)."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (SMALL_MAX_ROWS_LOCAL,
                                                  hist_local,
                                                  hist_local_plain,
                                                  plan_device_local,
                                                  plan_launch, sm_count)
    sms = sm_count(torch.cuda.current_device())
    # the kernel of the device regime's two whose gate takes a leaf
    gated = lambda cnt: "small" if cnt <= SMALL_MAX_ROWS_LOCAL else "large"
    n_leaves = 255
    p = 1.0 / np.arange(1, n_leaves + 1) ** 1.1
    timing, max_err = {}, 0.0
    for n_loc, fc in ((N_ROWS // 4, N_FEAT), (N_ROWS // 2, N_FEAT // 2)):
        plan = functools.partial(plan_launch, n_feat=fc, num_bins=N_BINS,
                                 n_loc=n_loc, num_sms=sms)
        bins = torch.from_numpy(rng.integers(0, N_BINS, (n_loc, fc),
                                             dtype=np.uint8)).to(dev)
        skewed = rng.choice(n_leaves, n_loc, p=p / p.sum()).astype(np.int32)
        counts = np.bincount(skewed, minlength=n_leaves)
        small = int(np.argmin(np.abs(counts - 1000)))
        maps = {"all": (torch.zeros(n_loc, dtype=torch.int32, device=dev),
                        0, n_loc)}
        skewed_d = torch.from_numpy(skewed).to(dev)
        for name, leaf in (("mid", 0), ("small", small), ("absent", 300)):
            maps[name] = (skewed_d, leaf,
                          int(counts[leaf]) if leaf < n_leaves else 0)
        # leaves of exactly the regime threshold, one row more and one less
        t = SMALL_MAX_ROWS_LOCAL
        edge = np.zeros(n_loc, np.int32)
        perm = rng.permutation(n_loc)
        edge[perm[:t]], edge[perm[t:2 * t + 1]] = 1, 2
        edge[perm[2 * t + 1:3 * t]] = 3
        edge_d = torch.from_numpy(edge).to(dev)
        maps["threshold-1"] = (edge_d, 3, t - 1)
        maps["threshold"] = (edge_d, 1, t)
        maps["threshold+1"] = (edge_d, 2, t + 1)
        # every leaf's rows in the shard, as the split step keeps them
        # (the absent leaf, 300, among them)
        leaf_rows = {id(m): torch.bincount(m.long(), minlength=301).int()
                     for m in (maps["all"][0], skewed_d, edge_d)}
        dplan = plan_device_local(n_loc, fc, N_BINS, num_sms=sms)
        w_int = [torch.from_numpy(a).to(dev) for a in (
            rng.integers(-8, 9, n_loc).astype(np.float32),
            rng.integers(0, 5, n_loc).astype(np.float32),
            np.ones(n_loc, np.float32))]
        w_f32 = [torch.from_numpy(a).to(dev) for a in (
            rng.standard_normal(n_loc).astype(np.float32),
            rng.uniform(0.0, 0.25, n_loc).astype(np.float32),
            np.ones(n_loc, np.float32))]
        for name, (row_leaf, leaf, cnt) in maps.items():
            lid = torch.tensor([leaf], dtype=torch.int32, device=dev)
            lrows = leaf_rows[id(row_leaf)]
            if int(lrows[leaf]) != cnt:
                fail(f"phase 2d: leaf {name} holds {int(lrows[leaf])} rows, "
                     f"not {cnt}")
            pl = hist_local_plain(row_leaf, lid, bins, *w_int, N_BINS)
            # its own plan at the leaf's count, both regimes forced, the
            # plan under the shard's bound, and the device regime
            plans = {"own": plan(cnt),
                     "small": plan(cnt, small_max_rows=n_loc),
                     "large": plan(cnt, small_max_rows=-1),
                     "shard_bound": plan(n_loc), "device": dplan}
            for pname, lp in plans.items():
                k = hist_local(row_leaf, lid, bins, *w_int, N_BINS, plan=lp,
                               leaf_rows=lrows if pname == "device"
                               else None)
                torch.cuda.synchronize()
                if not torch.equal(k, pl):
                    fail(f"hist_local != plain under integer weights at "
                         f"{n_loc}x{fc}, leaf {name}, {pname} plan {lp}")
            k = hist_local(row_leaf, lid, bins, *w_f32, N_BINS,
                           leaf_rows=lrows)
            pl = hist_local_plain(row_leaf, lid, bins, *w_f32, N_BINS)
            mag = hist_local_plain(row_leaf, lid, bins,
                                   *[w.abs() for w in w_f32], N_BINS)
            err = (k - pl).abs()
            if bool((err > 1e-5 * mag).any()):
                fail(f"hist_local vs plain beyond 1e-5 of sum |w| at "
                     f"{n_loc}x{fc}, leaf {name}")
            max_err = max(max_err, err.max().item())
            phase("hist_local_vs_plain", shard=f"{n_loc}x{fc}", leaf=name,
                  rows=cnt, own_regime=plans["own"].regime,
                  device_regime_kernel=gated(cnt),
                  exact_int=",".join(plans),
                  f32_max_abs_err=f"{err.max().item():.3e}")
        for name in ("all", "small"):
            row_leaf, leaf, cnt = maps[name]
            lid = torch.tensor([leaf], dtype=torch.int32, device=dev)
            idx = torch.nonzero(row_leaf == leaf).view(-1)
            flat = (bins.index_select(0, idx).long() + torch.arange(
                fc, device=dev) * N_BINS).reshape(-1)
            vals = torch.stack([w[idx] for w in w_f32], -1)[:, None, :
                                                            ].expand(
                -1, fc, 3).reshape(-1, 3).contiguous()
            acc = torch.zeros((fc * N_BINS, 3), device=dev)
            lrows = leaf_rows[id(row_leaf)]
            # the device regime as the split step launches it
            timing[(n_loc, name)] = t = time_kernel(
                lambda: hist_local(row_leaf, lid, bins, *w_f32, N_BINS,
                                   leaf_rows=lrows),
                lambda: hist_local_plain(row_leaf, lid, bins, *w_f32,
                                         N_BINS),
                lambda: acc.index_add_(0, flat, vals),
                local_bound_ms(n_loc, cnt, fc),
                lambda: hist_local(row_leaf, lid, bins, *w_f32, N_BINS,
                                   plan=plan(n_loc)))
            host = lambda: hist_local(row_leaf, lid, bins, *w_f32, N_BINS,
                                      plan=plan(cnt))
            t["host_plan_ms"] = cuda_ms(host)
            t["host_plan_ms_many"] = cuda_ms_many(host)
            t["host_plan_device_ms"] = profiled_ms(host)[0]
            phase("hist_local_time", shard=f"{n_loc}x{fc}", leaf=name,
                  rows=cnt, host_plan_regime=plan(cnt).regime,
                  device_regime_kernel=gated(cnt),
                  **{k: f"{v:.4f}" if isinstance(v, float) else v
                     for k, v in t.items()},
                  bound_share=f"{t['bound_ms'] / t['device_ms']:.4f}"
                  if t["device_ms"] else "not measured")
        del bins, maps, skewed_d, edge_d, w_int, w_f32, idx, flat, vals, acc
        del leaf_rows
    return timing, max_err


def hist64(rows, bins, ws, num_bins, chunk=1 << 18):
    """The ``[F, num_bins, 3]`` histogram of ``bins``' rows ``rows`` (a
    1-D index tensor) under weights ``ws``, summed in float64: the
    reference of a float32 check where a bin holds so many rows that a
    float32 plain sum's own rounding would exceed the tolerance."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import bin_rows
    f = bins.shape[1]
    out = torch.zeros((f * num_bins, 3), dtype=torch.float64,
                      device=bins.device)
    base = torch.arange(f, device=bins.device) * num_bins
    for a in range(0, rows.numel(), chunk):
        idx = rows[a:a + chunk].long()
        flat = (bin_rows(bins, idx) + base).reshape(-1)
        vals = torch.stack([w[idx].double() for w in ws], -1)
        out.index_add_(0, flat, vals[:, None, :].expand(-1, f, 3)
                       .reshape(-1, 3))
    return out.view(f, num_bins, 3)


def packed_local_bound_ms(n_loc: int, cnt: int, cols: int,
                          width: int) -> float:
    """Least time of a shard-local histogram call on a matrix of ``cols``
    1-byte columns at histogram width ``width``: row_leaf for every local
    row, the ``cnt`` matching rows' bytes and three weights, the output
    written, over the memory rate; or 3 x cols f32 adds a matching row."""
    nbytes = 4 * n_loc + cnt * (cols + 12) + 4 + cols * width * 12
    return max(nbytes / H100_BYTES_PER_S,
               3 * cols * cnt / H100_F32_OPS_PER_S) * 1e3


def check_hist_packed(inner, rng, window=4_000, shards=4):
    """Phase 8a: K1 (``hist_window``) and K3 (``hist_local``) on phase 8's
    packed storage matrix as the main path reads it (2,270,296 x 117 at
    width 256, where joint bin 255, both nibbles 15, is a possible bin
    that no unpacked 255-bin column holds; the phase counts the cells that
    reach it, and checks K1 at the root once more on a copy whose first
    packed byte is 255 in 10,000 rows), against their plain versions: exact
    under integer weights and within 1e-5 of sum |w| under float32 of the
    float64 sum (:func:`hist64`; a joint bin here holds up to some two
    million rows, where the float32 plain version's own sequential
    rounding is above that tolerance).  K1 at
    the root and at a ``window``-row window of a shuffled ``order``, in
    its own plan, both regimes forced and the split step's device regime
    at both parities; its result unfolded equal to the plain histogram of
    the unpacked bins.  K3 on the matrix cut into ``shards`` row shards,
    at all rows and at a leaf of about ``window`` rows in all, in its own
    plan, both regimes and the device regime; the shards' partials summed
    in shard order and unfolded equal to the plain histogram of the
    unpacked bins, as the data-parallel learner unfolds after its shard
    sum.  With K1's times at both windows on the packed matrix and on the
    unpacked bins, and K3's (the device regime, as the 4x1 step calls it)
    on the first shard at both leaves."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (hist_local,
                                                  hist_local_plain,
                                                  hist_window,
                                                  hist_window_plain,
                                                  plan_device,
                                                  plan_device_local,
                                                  plan_launch, sm_count)
    packed, bins = inner.packed, inner.bins
    mat, max_bin = packed.matrix, inner.grower_cfg.max_bin
    W = packed.hist_width(max_bin)
    n, c = mat.shape
    dev = mat.device
    sms = sm_count(torch.cuda.current_device())
    put = lambda a: torch.from_numpy(a).to(dev)
    w_int = [put(rng.integers(-8, 9, n).astype(np.float32)),
             put(rng.integers(0, 5, n).astype(np.float32)),
             torch.ones(n, dtype=torch.float32, device=dev)]
    w_f32 = [put(rng.standard_normal(n).astype(np.float32)),
             put(rng.uniform(0.0, 0.25, n).astype(np.float32)),
             torch.ones(n, dtype=torch.float32, device=dev)]
    w_abs = [w.abs() for w in w_f32]
    cols_packed = torch.nonzero(packed.plan.is_packed).view(-1)
    joint255 = int((mat.index_select(1, packed.plan.byte_col[cols_packed]
                                     .unique()) == 255).sum())

    def held(name, got, want, mag=None):
        if mag is None:
            if not torch.equal(got, want):
                fail(f"phase 8a: {name} != plain under integer weights: "
                     f"max |diff| {(got - want).abs().max().item()}")
            return 0.0
        err = (got.double() - want).abs()
        rel = (err / mag.clamp(min=1e-300)).max().item()
        if rel > 1e-5:
            fail(f"phase 8a: {name} is {rel:.3e} of sum |w| from the "
                 f"float64 sum under float32 (limit 1e-5)")
        return err.max().item()

    # ---- K1 over a shuffled order: the root and a small window ------------
    order = put(rng.permutation(n).astype(np.int32))
    alt = (put(rng.permutation(n).astype(np.int32)), mat, *w_int)
    out, f32_err, times = {}, 0.0, {}
    for start, cnt in ((0, n), (n // 3, window)):
        sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
        want = hist_window_plain(order, sc, mat, *w_int, W)
        plans = {"own": plan_launch(cnt, c, W, num_sms=sms),
                 "small": plan_launch(cnt, c, W, num_sms=sms,
                                      small_max_rows=n),
                 "large": plan_launch(cnt, c, W, num_sms=sms,
                                      small_max_rows=-1)}
        for pname, pl in plans.items():
            held(f"K1 {pname} plan at ({start}, {cnt})",
                 hist_window(order, sc, mat, *w_int, W, cnt, pl), want)
        dplan = plan_device(n, c, W, num_sms=sms)
        for par, src in ((0, (order, mat, *w_int)), (1, alt)):
            sel = torch.tensor([par], dtype=torch.int32, device=dev)
            held(f"K1 device regime at ({start}, {cnt}), parity {par}",
                 hist_window(order, sc, mat, *w_int, W, plan=dplan,
                             alt=alt, sel=sel),
                 hist_window_plain(src[0], sc, *src[1:], W))
        held(f"K1 unfolded at ({start}, {cnt})",
             packed.unfold(hist_window(order, sc, mat, *w_int, W, cnt),
                           max_bin),
             hist_window_plain(order, sc, bins, *w_int, max_bin))
        idx = order[start:start + cnt]
        f32_err = max(f32_err, held(
            f"K1 at ({start}, {cnt})",
            hist_window(order, sc, mat, *w_f32, W, cnt),
            hist64(idx, mat, w_f32, W), hist64(idx, mat, w_abs, W)))
        times[cnt] = (
            cuda_ms(lambda: hist_window(order, sc, mat, *w_f32, W, cnt)),
            cuda_ms(lambda: hist_window(order, sc, bins, *w_f32, max_bin,
                                        cnt)),
            window_bound_ms(cnt, c, W),
            window_bound_ms(cnt, bins.shape[1], max_bin))
    # joint bin 255 forced into 10,000 rows of the first packed byte
    forced = mat.clone()
    forced[put(rng.choice(n, 10_000, replace=False)),
           packed.plan.byte_col[cols_packed[0]]] = 255
    sc = torch.tensor([0, n], dtype=torch.int32, device=dev)
    order = alt[0]
    want = hist_window_plain(order, sc, forced, *w_int, W)
    held("K1 at the root with joint bin 255 forced",
         hist_window(order, sc, forced, *w_int, W, n), want)
    held("K1's device regime at the root with joint bin 255 forced",
         hist_window(order, sc, forced, *w_int, W,
                     plan=plan_device(n, c, W, num_sms=sms)), want)
    del forced
    out.update(k1_windows=f"0+{n},{n // 3}+{window}",
               k1_joint_bin_255_forced_exact=True,
               k1_exact_int="own,small,large,device_parity0,"
               "device_parity1,unfolded",
               k1_f32_max_abs_err=f"{f32_err:.3e}",
               k1_root_ms_packed=f"{times[n][0]:.4f}",
               k1_root_ms_unpacked=f"{times[n][1]:.4f}",
               k1_root_bound_ms_packed=f"{times[n][2]:.5f}",
               k1_root_bound_ms_unpacked=f"{times[n][3]:.5f}",
               k1_window_ms_packed=f"{times[window][0]:.4f}",
               k1_window_ms_unpacked=f"{times[window][1]:.4f}",
               k1_window_bound_ms_packed=f"{times[window][2]:.5f}",
               k1_window_bound_ms_unpacked=f"{times[window][3]:.5f}")
    del order, alt

    # ---- K3 on row shards: all rows and a leaf of about `window` rows -----
    n_loc = n // shards
    leaf_map = np.zeros(n, np.int32)
    leaf_map[rng.choice(n_loc * shards, window, replace=False)] = 1
    leaf_map = put(leaf_map)
    f32_err, k3_times = 0.0, {}
    for leaf in (0, 1):
        lid = torch.tensor([leaf], dtype=torch.int32, device=dev)
        parts = []
        for i in range(shards):
            rows = slice(i * n_loc, (i + 1) * n_loc)
            rl, m = leaf_map[rows], mat[rows].contiguous()
            wi = [w[rows] for w in w_int]
            wf = [w[rows] for w in w_f32]
            cnt = int((rl == leaf).sum())
            lrows = torch.bincount(rl.long(), minlength=2).int()
            want = hist_local_plain(rl, lid, m, *wi, W)
            plans = {"own": plan_launch(cnt, c, W, n_loc, num_sms=sms),
                     "small": plan_launch(cnt, c, W, n_loc, num_sms=sms,
                                          small_max_rows=n_loc),
                     "large": plan_launch(cnt, c, W, n_loc, num_sms=sms,
                                          small_max_rows=-1),
                     "device": plan_device_local(n_loc, c, W, num_sms=sms)}
            for pname, pl in plans.items():
                held(f"K3 {pname} plan, shard {i}, leaf {leaf}",
                     hist_local(rl, lid, m, *wi, W, plan=pl,
                                leaf_rows=lrows if pname == "device"
                                else None), want)
            parts.append(hist_local(rl, lid, m, *wi, W, leaf_rows=lrows))
            if i == 0:      # K3 as the 4x1 step calls it, one shard
                ub = bins[rows].contiguous()
                k3_times[leaf] = (
                    cuda_ms(lambda: hist_local(rl, lid, m, *wf, W,
                                               leaf_rows=lrows)),
                    cuda_ms(lambda: hist_local(rl, lid, ub, *wf, max_bin,
                                               leaf_rows=lrows)),
                    cnt, packed_local_bound_ms(n_loc, cnt, c, W),
                    packed_local_bound_ms(n_loc, cnt, ub.shape[1], max_bin))
                del ub
            idx = torch.nonzero(rl == leaf).view(-1)
            f32_err = max(f32_err, held(
                f"K3 shard {i}, leaf {leaf}",
                hist_local(rl, lid, m, *wf, W, leaf_rows=lrows),
                hist64(idx, m, wf, W),
                hist64(idx, m, [w.abs() for w in wf], W)))
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        held(f"K3 shard sum unfolded, leaf {leaf}",
             packed.unfold(total, max_bin),
             hist_local_plain(leaf_map, lid, bins, *w_int, max_bin))
    out.update(k3_shards=f"{shards}x{n_loc}x{c}",
               k3_leaf_rows=f"{n - window},{window}",
               k3_exact_int="own,small,large,device,shard_sum_unfolded",
               k3_f32_max_abs_err=f"{f32_err:.3e}",
               **{f"k3_{w}_{k}": v for w, leaf in (("all_rows", 0),
                                                   ("leaf", 1))
                  for k, v in zip(("ms_packed", "ms_unpacked",
                                   "shard0_leaf_rows", "bound_ms_packed",
                                   "bound_ms_unpacked"),
                                  k3_times[leaf])})
    phase("packed_hist_vs_plain", storage=f"{n}x{c}", width=W,
          packed_cols=packed.plan.num_packed,
          joint_bin_255_cells=joint255, **out)
    return out


def route_bound_ms(cnt: int, gathered: bool, bundled: bool = False) -> float:
    """Least time of a route call: each window position's order entry
    (4 B, gathered windows only), its bin byte and its output byte, and the
    window, parity, leaf and split row (and, on a bundled column, the
    feature's column and first slot), over the memory rate."""
    nbytes = (cnt * ((4 if gathered else 0) + 2) + 16 + 4 + 8 + 12 + 1
              + N_BINS + (8 if bundled else 0))
    return nbytes / H100_BYTES_PER_S * 1e3


def check_route(dev, rng):
    """Phase 2e: the route kernel against its plain version, bit for bit:
    the Higgs path's 1,000,000 x 28 bins gathered through either of two
    ``order`` buffers on windows of 0 to 1,000,000 rows, and the Expo
    path's 11,000,000 x 8 leaf-ordered bins of either buffer at the root
    window; splits on a column without missing values, with zero and with
    NaN as missing, and a categorical split.  Times at the Expo root, the
    Higgs root and 4,097 gathered rows, beside the plain version and the
    PyTorch gather + ``where`` that the eager loop ran before (the split
    column's gather and ``route_goes_left``, given the window on the
    host)."""
    import torch
    from lightgbm_tpu_torch.grower import FeatureMeta
    from lightgbm_tpu_torch.ops.route import (route_goes_left, route_window,
                                              route_window_plain)

    def meta_for(f):
        return FeatureMeta(
            torch.full((f,), N_BINS, dtype=torch.int32, device=dev),
            torch.tensor([k % 3 for k in range(f)], dtype=torch.int32,
                         device=dev),
            torch.tensor([(37 * k) % N_BINS for k in range(f)],
                         dtype=torch.int32, device=dev))

    # pool rows: (feature, threshold, default_left) on columns of missing
    # type none, zero and NaN, and a categorical split
    splits = [(0, 100, 1, False), (1, 50, 0, False), (2, 200, 1, False),
              (4, 0, 0, True)]
    si32 = torch.tensor([s[:3] for s in splits], dtype=torch.int32,
                        device=dev)
    scat = torch.tensor([s[3] for s in splits], device=dev)
    scatb = torch.from_numpy(rng.random((len(splits), N_BINS)) < 0.5).to(dev)
    bins = lambda n, f: torch.from_numpy(rng.integers(
        0, N_BINS, (n, f), dtype=np.uint8)).to(dev)
    higgs = bins(N_ROWS, N_FEAT)
    orders = [torch.from_numpy(rng.permutation(N_ROWS).astype(np.int32)).to(
        dev) for _ in range(2)]
    f_expo = len(EXPO_CATEGORICAL) + 2
    expo = [bins(N_EXPO, f_expo) for _ in range(2)]
    sets = {
        "higgs_gathered": (meta_for(N_FEAT), (higgs, higgs), orders,
                           [(12345, 0), (777, 1), (5000, 511), (40000, 4097),
                            (300000, 100000), (0, N_ROWS),
                            (N_ROWS - 4097, 4097)]),
        "expo_ordered_root": (meta_for(f_expo), expo, (None, None),
                              [(0, N_EXPO)]),
    }
    out = torch.empty(N_EXPO, dtype=torch.bool, device=dev)
    ref = torch.empty_like(out)
    checked = 0
    for label, (meta, b2, o2, windows) in sets.items():
        for start, cnt in windows:
            sc = torch.tensor([start, cnt], dtype=torch.int64, device=dev)
            for par in (0, 1):
                odd = torch.tensor([par], dtype=torch.int32, device=dev)
                for leaf in range(len(splits)):
                    lt = torch.tensor([leaf], device=dev)
                    out.fill_(True)
                    ref.fill_(True)
                    route_window(sc, odd, lt, si32, scat, scatb, meta, b2, o2,
                                 out)
                    route_window_plain(sc, odd, lt, si32, scat, scatb, meta,
                                       b2, o2, ref)
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        fail(f"route kernel != plain at window ({start}, "
                             f"{cnt}) of {label}, buffer {par}, split "
                             f"{splits[leaf]}")
                    checked += 1
        phase("route_vs_plain", set=label, windows=len(windows),
              calls_checked=checked, exact=True)

    timing = {}
    for label, (meta, b2, o2, _), start, cnt in (
            ("expo_root", sets["expo_ordered_root"], 0, N_EXPO),
            ("higgs_root", sets["higgs_gathered"], 0, N_ROWS),
            ("higgs_4097", sets["higgs_gathered"], 40000, 4097)):
        sc = torch.tensor([start, cnt], dtype=torch.int64, device=dev)
        odd = torch.tensor([1], dtype=torch.int32, device=dev)
        lt = torch.tensor([2], device=dev)
        feat, thr, dleft = si32[2, 0:1].long(), si32[2, 1:2].long(), \
            si32[2, 2:3].bool()
        gathered = o2[0] is not None
        f = b2[1].shape[1]

        def replaced():
            if gathered:
                win = o2[1][start:start + cnt]
                binf = b2[1].view(-1).index_select(0, win.long() * f + feat)
            else:
                binf = b2[1][start:start + cnt].index_select(1, feat)[:, 0]
            return route_goes_left(binf.long(), meta, feat, thr, dleft,
                                   scat[2:3], scatb[2])

        k = three_times(lambda: route_window(sc, odd, lt, si32, scat, scatb,
                                             meta, b2, o2, out))
        old = three_times(replaced)
        p_ms = cuda_ms(lambda: route_window_plain(sc, odd, lt, si32, scat,
                                                  scatb, meta, b2, o2, ref),
                       reps=3)
        bound_ms = route_bound_ms(cnt, gathered)
        timing[label] = dict(k, plain_ms=p_ms, replaced_ms=old["ms"],
                             replaced_ms_many=old["ms_many"],
                             replaced_device_ms=old["device_ms"],
                             bound_ms=bound_ms)
        phase("route_time", window=label, rows=cnt,
              **{k_: f"{v:.4f}" for k_, v in timing[label].items()
                 if isinstance(v, float) and k_ != "bound_ms"},
              bound_ms=f"{bound_ms:.5f}",
              bound_share=f"{bound_ms / k['device_ms']:.3f}"
              if k["device_ms"] else "not measured")
    del higgs, orders, expo, out, ref
    return timing


def route_rows_bound_ms(n: int, leaf_rows: int, moved: int,
                        bundled: bool = False) -> float:
    """Least time of a route_rows call over ``n`` rows: each row's
    row_leaf entry (4 B) read; the split column's bytes of the leaf's
    ``leaf_rows`` rows only, the kernel's one column read, a 32-byte
    sector a scattered row and at most the whole column; each moved row's
    entry (4 B) written; and the leaf, new leaf and split row read (and,
    on a bundled column, the feature's column and first slot); over the
    memory rate."""
    column = min(32 * leaf_rows, n)
    return (4 * n + column + 4 * moved + 8 + 8 + 12 + 1 + N_BINS
            + (8 if bundled else 0)) / H100_BYTES_PER_S * 1e3


def check_route_rows(dev, rng):
    """Phase 2g: the data-parallel routing kernel against its plain
    version, bit for bit in the row -> leaf map and exact in the
    per-shard counts: 1,000,000 rows of the Higgs path's 28 columns held
    as four row shards (the 4x1 mesh's one card), a map of 255 skewed
    leaves, splits on a column without missing values, with zero and
    with NaN as missing, and a categorical split, each from a leaf of many
    rows and of about 1,000; the root (every row in leaf 0); and the sink
    after the tree's stop, which moves nothing.  Times at the root and at
    the 1,000-row leaf, where new = leaf makes a call repeatable (the
    same reads and writes, the counts unchanged)."""
    import torch
    from lightgbm_tpu_torch.grower import FeatureMeta
    from lightgbm_tpu_torch.ops.route import route_rows, route_rows_plain
    n, shards, L = N_ROWS, MESH_SLOTS, 255
    meta = FeatureMeta(
        torch.full((N_FEAT,), N_BINS, dtype=torch.int32, device=dev),
        torch.tensor([k % 3 for k in range(N_FEAT)], dtype=torch.int32,
                     device=dev),
        torch.tensor([(37 * k) % N_BINS for k in range(N_FEAT)],
                     dtype=torch.int32, device=dev))
    bins_t = torch.from_numpy(rng.integers(0, N_BINS, (N_FEAT, n),
                                           dtype=np.uint8)).to(dev)
    p = 1.0 / np.arange(1, L) ** 1.1
    skewed = rng.choice(L - 1, n, p=p / p.sum()).astype(np.int32)
    sizes = np.bincount(skewed, minlength=L)
    small = int(np.argmin(np.abs(sizes - 1000)))
    # the pool: splits of each missing type and a categorical one at
    # leaves 0 (many rows) and `small`, the sink row L without a column
    si32 = np.zeros((L + 1, 3), np.int32)
    si32[:, 0] = 5
    scat = np.zeros(L + 1, bool)
    splits = {"none": (0, 100, 1, False), "zero": (1, 50, 0, False),
              "nan": (2, 200, 1, False), "categorical": (4, 0, 0, True)}
    scatb = torch.from_numpy(rng.random((L + 1, N_BINS)) < 0.5).to(dev)
    maps = {"skewed": torch.from_numpy(skewed).to(dev),
            "root": torch.zeros(n, dtype=torch.int32, device=dev)}

    def counts_of(rl):
        return torch.stack([torch.bincount(r.long(), minlength=L + 1)
                            for r in rl.view(shards, -1)]).int()

    def pool(split, leaf):
        i32, cat = si32.copy(), scat.copy()
        i32[leaf] = split[:3]
        cat[leaf] = split[3]
        i32[L] = (-1, 0, 0)
        return (torch.from_numpy(i32).to(dev), torch.from_numpy(cat).to(dev))

    cases = [(f"{name}_{where}", maps[m], leaf, new, split)
             for name, split in splits.items()
             for where, m, leaf, new in (("many", "skewed", 0, L - 1),
                                         ("1000", "skewed", small, L - 1),
                                         ("root", "root", 0, 1))]
    cases.append(("sink", maps["skewed"], L, L, splits["none"]))
    checked = moved_total = 0
    for label, rl0, leaf, new, split in cases:
        i32, cat = pool(split, leaf)
        lt = torch.tensor([leaf], device=dev)
        nt = torch.tensor([new], device=dev)
        out = {}
        for name, fn in (("kernel", route_rows), ("plain", route_rows_plain)):
            rl, cnt = rl0.clone(), counts_of(rl0)
            fn(rl, bins_t, lt, nt, i32, cat, scatb, meta, cnt)
            out[name] = (rl, cnt)
        torch.cuda.synchronize()
        (rk, ck), (rp, cp) = out["kernel"], out["plain"]
        if not (torch.equal(rk, rp) and torch.equal(ck, cp)):
            fail(f"route_rows != plain at {label}: "
                 f"{int((rk != rp).sum())} rows of the map differ, counts "
                 f"{'equal' if torch.equal(ck, cp) else 'differ'}")
        if not torch.equal(ck, counts_of(rk)):
            fail(f"route_rows counts != the map's at {label}")
        moved = int((rk != rl0).sum())
        if (label == "sink") != (moved == 0):
            fail(f"route_rows moved {moved} rows at {label}")
        moved_total += moved
        checked += 1
    phase("route_rows_vs_plain", rows=n, shards=shards, cases=checked,
          rows_moved=moved_total, exact=True)

    timing = {}
    for label, m, leaf in (("root", "root", 0), ("leaf_1000", "skewed",
                                                 small)):
        rl = maps[m].clone()
        i32, cat = pool(splits["nan"], leaf)
        lt = torch.tensor([leaf], device=dev)
        cnt = counts_of(rl)
        leaf_rows = int((rl == leaf).sum())
        probe = rl.clone()
        route_rows_plain(probe, bins_t, lt, torch.tensor([L - 1], device=dev),
                         i32, cat, scatb, meta, cnt.clone())
        moved = int((probe != rl).sum())
        k = three_times(lambda: route_rows(rl, bins_t, lt, lt, i32, cat,
                                           scatb, meta, cnt))
        p_ms = cuda_ms(lambda: route_rows_plain(rl, bins_t, lt, lt, i32, cat,
                                                scatb, meta, cnt), reps=3)
        if not torch.equal(rl, maps[m]) or not torch.equal(cnt,
                                                           counts_of(rl)):
            fail(f"route_rows with new = leaf changed the map at {label}")
        bound_ms = route_rows_bound_ms(n, leaf_rows, moved)
        timing[label] = dict(k, plain_ms=p_ms, bound_ms=bound_ms,
                             leaf_rows=leaf_rows, moved=moved)
        phase("route_rows_time", leaf=label, rows=n,
              leaf_rows=timing[label]["leaf_rows"], moved=moved,
              **{k_: f"{v:.4f}" for k_, v in timing[label].items()
                 if isinstance(v, float) and k_ != "bound_ms"},
              bound_ms=f"{bound_ms:.5f}",
              bound_share=f"{bound_ms / k['device_ms']:.3f}"
              if k["device_ms"] else "not measured")
    del bins_t, maps
    return timing


# the Covertype-shaped task's training rows (an 80/20 split) and, at the
# defaults, its EFB layout: 10 numeric columns, the 4 wilderness columns
# in one bundle of 5 slots and the 40 soil columns in one of 41
N_COVTYPE_TRAIN = int(0.8 * N_COVTYPE)
COVTYPE_COLS = 12
# pool rows (logical feature, threshold, default_left, categorical) on the
# bundled layout: two soil features (one zero-missing), a wilderness
# feature, a numeric column, and a categorical split on a soil feature
BUNDLED_SPLITS = {"soil": (14 + 17, 0, 1, False),
                  "soil_zero_missing": (14 + 5, 0, 1, False),
                  "wilderness": (11, 0, 0, False),
                  "numeric": (3, 100, 1, False),
                  "soil_categorical": (14 + 22, 0, 0, True)}


def covtype_bundle_meta(dev):
    """The Covertype layout's feature meta with its decode maps: 54
    logical features over 12 columns (``col``), each one-hot feature of 2
    bins owning one slot of its bundle (``offset``)."""
    import torch
    from lightgbm_tpu_torch.grower import FeatureMeta
    put = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    missing = [0] * 54
    missing[14 + 5] = 1
    return FeatureMeta(
        put([N_BINS] * 10 + [2] * 44), put(missing),
        put([(37 * k) % N_BINS for k in range(10)] + [0] * 44), None,
        put(list(range(10)) + [10] * 4 + [11] * 40),
        put([-1] * 10 + list(range(1, 5)) + list(range(1, 41))))


def covtype_bundled_bins(n: int, rng) -> np.ndarray:
    """``[n, 12]`` uint8 bins in the Covertype layout: random numeric bins,
    one active wilderness and soil slot a row, and 5 % of the rows with
    every soil feature at its default (slot 0)."""
    b = np.empty((n, COVTYPE_COLS), np.uint8)
    b[:, :10] = rng.integers(0, N_BINS, (n, 10))
    b[:, 10] = rng.integers(1, 5, n)
    b[:, 11] = rng.integers(1, 41, n)
    b[rng.random(n) < 0.05, 11] = 0
    return b


def check_route_bundled(dev, rng):
    """Phase 2e on a bundled column: the route kernel against its plain
    version, bit for bit, on the Covertype-shaped task's 464,809 x 12
    bundled bins gathered through either of two ``order`` buffers, at the
    root window and a window of 4,000 rows, on each of
    :data:`BUNDLED_SPLITS` (the 41-slot soil bundle decoded in the
    kernel); times at both windows on the soil split."""
    import torch
    from lightgbm_tpu_torch.ops.route import route_window, route_window_plain
    n = N_COVTYPE_TRAIN
    meta = covtype_bundle_meta(dev)
    bins = torch.from_numpy(covtype_bundled_bins(n, rng)).to(dev)
    orders = [torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
              for _ in range(2)]
    splits = list(BUNDLED_SPLITS.values())
    si32 = torch.tensor([s[:3] for s in splits], dtype=torch.int32,
                        device=dev)
    scat = torch.tensor([s[3] for s in splits], device=dev)
    scatb = torch.from_numpy(rng.random((len(splits), N_BINS)) < 0.5).to(dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    ref = torch.empty_like(out)
    windows = {"bundled_root": (0, n), "bundled_4000": (100_000, 4_000)}
    checked = 0
    for label, (start, cnt) in windows.items():
        sc = torch.tensor([start, cnt], dtype=torch.int64, device=dev)
        for par in (0, 1):
            odd = torch.tensor([par], dtype=torch.int32, device=dev)
            for leaf, name in enumerate(BUNDLED_SPLITS):
                lt = torch.tensor([leaf], device=dev)
                out.fill_(True)
                ref.fill_(True)
                args = (sc, odd, lt, si32, scat, scatb, meta, (bins, bins),
                        orders)
                route_window(*args, out)
                route_window_plain(*args, ref)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    fail(f"route kernel != plain on the bundled column at "
                         f"{label}, buffer {par}, split {name}")
                checked += 1
    phase("route_vs_plain", set="covtype_bundled", windows=len(windows),
          splits=",".join(BUNDLED_SPLITS), calls_checked=checked,
          exact=True)
    timing = {}
    soil = torch.tensor([0], device=dev)
    odd = torch.tensor([1], dtype=torch.int32, device=dev)
    for label, (start, cnt) in windows.items():
        sc = torch.tensor([start, cnt], dtype=torch.int64, device=dev)
        args = (sc, odd, soil, si32, scat, scatb, meta, (bins, bins), orders)
        k = three_times(lambda: route_window(*args, out))
        p_ms = cuda_ms(lambda: route_window_plain(*args, ref), reps=3)
        bound_ms = route_bound_ms(cnt, True, bundled=True)
        timing[label] = dict(k, plain_ms=p_ms, bound_ms=bound_ms)
        phase("route_time", window=label, rows=cnt,
              **{k_: f"{v:.4f}" for k_, v in timing[label].items()
                 if isinstance(v, float) and k_ != "bound_ms"},
              bound_ms=f"{bound_ms:.5f}",
              bound_share=f"{bound_ms / k['device_ms']:.3f}"
              if k["device_ms"] else "not measured")
    del bins, orders, out, ref
    return timing


def check_route_rows_bundled(dev, rng):
    """Phase 2g on a bundled column: the data-parallel route kernel
    against its plain version, bit for bit in the map and exact in the
    counts, on the Covertype layout's bundled bins (464,808 rows as four
    row shards, column-major), from the root and from a leaf of about
    4,000 rows of a map of 255 skewed leaves, on each of
    :data:`BUNDLED_SPLITS`; times at both on the soil split (new = leaf,
    so that a call repeats)."""
    import torch
    from lightgbm_tpu_torch.ops.route import route_rows, route_rows_plain
    shards, L = MESH_SLOTS, 255
    n = N_COVTYPE_TRAIN // shards * shards
    meta = covtype_bundle_meta(dev)
    bins_t = torch.from_numpy(np.ascontiguousarray(
        covtype_bundled_bins(n, rng).T)).to(dev)
    p = 1.0 / np.arange(1, L) ** 1.1
    skewed = rng.choice(L - 1, n, p=p / p.sum()).astype(np.int32)
    sizes = np.bincount(skewed, minlength=L)
    small = int(np.argmin(np.abs(sizes - 4000)))
    maps = {"root": torch.zeros(n, dtype=torch.int32, device=dev),
            "skewed": torch.from_numpy(skewed).to(dev)}
    scatb = torch.from_numpy(rng.random((L + 1, N_BINS)) < 0.5).to(dev)

    def counts_of(rl):
        return torch.stack([torch.bincount(r.long(), minlength=L + 1)
                            for r in rl.view(shards, -1)]).int()

    def pool(split, leaf):
        i32 = np.zeros((L + 1, 3), np.int32)
        cat = np.zeros(L + 1, bool)
        i32[leaf], cat[leaf] = split[:3], split[3]
        return (torch.from_numpy(i32).to(dev), torch.from_numpy(cat).to(dev))

    checked = 0
    for name, split in BUNDLED_SPLITS.items():
        for where, m, leaf in (("root", "root", 0),
                               ("leaf_4000", "skewed", small)):
            i32, cat = pool(split, leaf)
            lt = torch.tensor([leaf], device=dev)
            nt = torch.tensor([L - 1], device=dev)
            got = {}
            for kind, fn in (("kernel", route_rows),
                             ("plain", route_rows_plain)):
                rl = maps[m].clone()
                cnt = counts_of(rl)
                fn(rl, bins_t, lt, nt, i32, cat, scatb, meta, cnt)
                got[kind] = (rl, cnt)
            torch.cuda.synchronize()
            (rk, ck), (rp, cp) = got["kernel"], got["plain"]
            if not (torch.equal(rk, rp) and torch.equal(ck, cp)
                    and torch.equal(ck, counts_of(rk))):
                fail(f"route_rows != plain on the bundled column at {name} "
                     f"from {where}")
            checked += 1
    phase("route_rows_vs_plain", set="covtype_bundled", rows=n,
          shards=shards, splits=",".join(BUNDLED_SPLITS), cases=checked,
          leaf_4000_rows=int(sizes[small]), exact=True)
    timing = {}
    for label, m, leaf in (("bundled_root", "root", 0),
                           ("bundled_leaf_4000", "skewed", small)):
        rl = maps[m].clone()
        i32, cat = pool(BUNDLED_SPLITS["soil"], leaf)
        lt = torch.tensor([leaf], device=dev)
        cnt = counts_of(rl)
        leaf_rows = int((rl == leaf).sum())
        probe = rl.clone()
        route_rows_plain(probe, bins_t, lt, torch.tensor([L - 1], device=dev),
                         i32, cat, scatb, meta, cnt.clone())
        moved = int((probe != rl).sum())
        k = three_times(lambda: route_rows(rl, bins_t, lt, lt, i32, cat,
                                           scatb, meta, cnt))
        p_ms = cuda_ms(lambda: route_rows_plain(rl, bins_t, lt, lt, i32, cat,
                                                scatb, meta, cnt), reps=3)
        bound_ms = route_rows_bound_ms(n, leaf_rows, moved, bundled=True)
        timing[label] = dict(k, plain_ms=p_ms, bound_ms=bound_ms,
                             leaf_rows=leaf_rows, moved=moved)
        phase("route_rows_time", leaf=label, rows=n, leaf_rows=leaf_rows,
              moved=moved,
              **{k_: f"{v:.4f}" for k_, v in timing[label].items()
                 if isinstance(v, float) and k_ != "bound_ms"},
              bound_ms=f"{bound_ms:.5f}",
              bound_share=f"{bound_ms / k['device_ms']:.3f}"
              if k["device_ms"] else "not measured")
    del bins_t, maps
    return timing


# the streamed paths' row-major blocks of phase 2j: MS-LTR's default block
# (262,144 of its 2,270,296 x 137 rows) and its last, short block
MSLR_BLOCK, MSLR_TAIL = 262_144, 173_144


def route_sectors(rows, c: int, row_stride: int, col_stride: int,
                  bin_bytes: int) -> int:
    """The 32-byte sectors that hold column ``c``'s bins of ``rows`` (a
    device tensor of row ids) in a layout of these strides (elements)."""
    import torch
    at = (c * col_stride + rows.long() * row_stride) * bin_bytes
    return int(torch.unique(at // 32).numel())


def route_block_bound_ms(n: int, sectors: int, moved: int, cat_width: int,
                         bundled: bool = False) -> float:
    """Least time of a route_rows call over ``n`` rows: each row's
    row_leaf entry (4 B) read; the split column's ``sectors`` 32-byte
    sectors that hold the leaf's rows' bins (a row-major block of 32 bytes
    or more a row puts each row's bin in a sector of its own); each moved
    row's entry written; the leaf, new leaf, split row and bins-left row
    read (and, bundled, the feature's column and first slot)."""
    return (4 * n + 32 * sectors + 4 * moved + 8 + 8 + 12 + 1 + cat_width
            + (8 if bundled else 0)) / H100_BYTES_PER_S * 1e3


def check_route_rows_block(dev, rng):
    """Phase 2j: ``route_rows`` on a row-major block, as the streamed
    grower passes it (``block.t()``, strides (1, F)), against its plain
    version on the same view and against the kernel on the column-major
    copy of the same rows: the map bit for bit and the counts exact.  On
    MS-LTR's default block (262,144 x 137 uint8) and its short last block
    (173,144 rows), a uint16 block of Higgs' 100,000 x 28 at 1,023 bins
    (splits past bin 255, a categorical one whose row reaches past it),
    and the Covertype layout's bundled 262,144 x 12; splits of each
    missing type and a categorical one from a leaf of many rows, of about
    1,000 and the root, an absent leaf and the sink, which move nothing.
    Times at MS-LTR's block (root and the 1,000-row leaf, new = leaf so
    that a call repeats) beside the column-major form at the same rows and
    the sector bound."""
    import torch
    from lightgbm_tpu_torch.grower import FeatureMeta
    from lightgbm_tpu_torch.ops.histogram import movable
    from lightgbm_tpu_torch.ops.route import route_rows, route_rows_plain
    L = 255
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)

    def plain_meta(f, nb):
        return FeatureMeta(i32([nb] * f), i32([k % 3 for k in range(f)]),
                           i32([(37 * k) % nb for k in range(f)]))

    def skewed_map(n):
        p = 1.0 / np.arange(1, L - 1) ** 1.1
        m = rng.choice(L - 2, n, p=p / p.sum()).astype(np.int32)
        return m, np.bincount(m, minlength=L)

    def counts_of(rl):
        return torch.bincount(rl.long(), minlength=L + 1).int()[None]

    def pool(split, leaf, width):
        si = np.zeros((L + 1, 3), np.int32)
        cat = np.zeros(L + 1, bool)
        si[leaf], cat[leaf] = split[:3], split[3]
        si[L] = (-1, 0, 0)
        return (torch.from_numpy(si).to(dev), torch.from_numpy(cat).to(dev),
                torch.from_numpy(rng.random((L + 1, width)) < 0.5).to(dev))

    num_splits = {"none": (0, 100, 1, False), "zero": (1, 50, 0, False),
                  "nan": (2, 200, 1, False), "categorical": (4, 0, 0, True)}
    u16_splits = {f"u16_{i}": s for i, s in enumerate(WIDE_SPLITS[:4])}
    sets = {
        "mslr_block": (MSLR_BLOCK, 137, np.uint8, N_BINS, False, num_splits),
        "mslr_tail": (MSLR_TAIL, 137, np.uint8, N_BINS, False, num_splits),
        "higgs_block_u16": (100_000, N_FEAT, np.uint16, WIDE_BINS, False,
                            u16_splits),
        "covtype_bundled": (MSLR_BLOCK, COVTYPE_COLS, np.uint8, N_BINS,
                            True, BUNDLED_SPLITS)}
    checked = moved_total = 0
    blocks = {}
    for label, (n, f, dtype, nb, bundled, splits) in sets.items():
        if bundled:
            host = covtype_bundled_bins(n, rng)
            meta = covtype_bundle_meta(dev)
        else:
            host = rng.integers(0, nb, (n, f)).astype(dtype)
            meta = plain_meta(f, nb)
        block = torch.from_numpy(host).to(dev)
        col_major = movable(block).t().contiguous().view(block.dtype)
        rows_t = block.t()
        if rows_t.stride() != (1, f) or col_major.stride() != (n, 1):
            fail(f"route_rows block layouts at {label}: {rows_t.stride()}, "
                 f"{col_major.stride()}")
        skewed, sizes = skewed_map(n)
        small = int(np.argmin(np.abs(sizes - 1000)))
        maps = {"skewed": torch.from_numpy(skewed).to(dev),
                "root": torch.zeros(n, dtype=torch.int32, device=dev)}
        cases = [(f"{name}_{where}", maps[m], leaf, new, split)
                 for name, split in splits.items()
                 for where, m, leaf, new in (("many", "skewed", 0, L - 1),
                                             ("1000", "skewed", small, L - 1),
                                             ("root", "root", 0, 1))]
        first = next(iter(splits.values()))
        cases += [("absent", maps["skewed"], L - 2, L - 1, first),
                  ("sink", maps["skewed"], L, L, first)]
        for case, rl0, leaf, new, split in cases:
            si, cat, catb = pool(split, leaf, nb)
            lt, nt = i32([leaf]).long(), i32([new]).long()
            out = {}
            for kind, fn, bins in (("kernel", route_rows, rows_t),
                                   ("plain", route_rows_plain, rows_t),
                                   ("column_major", route_rows, col_major)):
                rl, cnt = rl0.clone(), counts_of(rl0)
                fn(rl, bins, lt, nt, si, cat, catb, meta, cnt)
                out[kind] = (rl, cnt)
            torch.cuda.synchronize()
            rk, ck = out["kernel"]
            for other in ("plain", "column_major"):
                ro, co = out[other]
                if not (torch.equal(rk, ro) and torch.equal(ck, co)):
                    fail(f"row-major route_rows != {other} at {label} "
                         f"{case}: {int((rk != ro).sum())} rows differ")
            if not torch.equal(ck, counts_of(rk)):
                fail(f"row-major route_rows counts != the map's at {label} "
                     f"{case}")
            moved = int((rk != rl0).sum())
            if (case in ("absent", "sink")) != (moved == 0):
                fail(f"row-major route_rows moved {moved} rows at {label} "
                     f"{case}")
            moved_total += moved
            checked += 1
        if label == "mslr_block":
            blocks[label] = (block, col_major, rows_t, maps, small, meta)
        else:
            del block, col_major, rows_t, maps
    phase("route_rows_block_vs_plain", sets=",".join(sets),
          shapes=",".join(f"{n}x{f}:{np.dtype(d).name}"
                          for n, f, d, *_ in sets.values()),
          cases=checked, rows_moved=moved_total, exact=True)

    block, col_major, rows_t, maps, small, meta = blocks["mslr_block"]
    n, f = block.shape
    timing = {}
    for label, m, leaf in (("root", "root", 0), ("leaf_1000", "skewed",
                                                 small)):
        rl = maps[m].clone()
        si, cat, catb = pool(num_splits["nan"], leaf, N_BINS)
        lt = i32([leaf]).long()
        cnt = counts_of(rl)
        leaf_idx = torch.nonzero(rl == leaf).view(-1)
        probe = rl.clone()
        route_rows_plain(probe, rows_t, lt, i32([L - 1]).long(), si, cat,
                         catb, meta, cnt.clone())
        moved = int((probe != rl).sum())
        k = three_times(lambda: route_rows(rl, rows_t, lt, lt, si, cat, catb,
                                           meta, cnt))
        c = three_times(lambda: route_rows(rl, col_major, lt, lt, si, cat,
                                           catb, meta, cnt))
        p_ms = cuda_ms(lambda: route_rows_plain(rl, rows_t, lt, lt, si, cat,
                                                catb, meta, cnt), reps=3)
        if not torch.equal(rl, maps[m]) or not torch.equal(cnt,
                                                           counts_of(rl)):
            fail(f"row-major route_rows with new = leaf changed the map at "
                 f"{label}")
        col = num_splits["nan"][0]
        sectors = route_sectors(leaf_idx, col, f, 1, 1)
        col_sectors = route_sectors(leaf_idx, col, 1, n, 1)
        bound_ms = route_block_bound_ms(n, sectors, moved, N_BINS)
        timing[label] = dict(
            k, plain_ms=p_ms, bound_ms=bound_ms, leaf_rows=len(leaf_idx),
            moved=moved, sectors=sectors,
            column_major_ms=c["ms"], column_major_ms_many=c["ms_many"],
            column_major_device_ms=c["device_ms"],
            column_major_bound_ms=route_block_bound_ms(n, col_sectors,
                                                       moved, N_BINS))
        phase("route_rows_block_time", leaf=label, block=f"{n}x{f}",
              leaf_rows=len(leaf_idx), moved=moved, sectors=sectors,
              column_major_sectors=col_sectors,
              **{k_: f"{v:.4f}" for k_, v in timing[label].items()
                 if isinstance(v, float) and "bound" not in k_},
              bound_ms=f"{bound_ms:.5f}",
              column_major_bound_ms=(
                  f"{timing[label]['column_major_bound_ms']:.5f}"),
              bound_share=f"{bound_ms / k['device_ms']:.3f}"
              if k["device_ms"] else "not measured")
    del blocks, block, col_major, rows_t, maps
    return timing


# phase 2k's splits on the uint16 Higgs matrix: (feature, threshold,
# default_left, categorical) on columns of each feature shard, past bin 255
BLOCK_U16_SPLITS = {"c0": (0, 600, 1, False), "c9": (9, 300, 0, False),
                    "c15": (15, 900, 1, False), "c22": (22, 50, 1, False),
                    "c27_categorical": (27, 0, 0, True)}


def block_table(bins, shape, dev):
    """The block-sharded layout of ``bins`` (``[n, F]`` on the card) over
    a ``(data, feature)`` cut, as one card holds every slot: each slot's
    row-major slice and the route table (``ops/route.py:BlockBins``)."""
    from lightgbm_tpu_torch.ops.histogram import movable
    from lightgbm_tpu_torch.ops.route import make_block_bins
    from lightgbm_tpu_torch.parallel.gspmd import column_slices
    d, fs = shape
    n, f = bins.shape
    n_loc = n // d
    cols = column_slices(f, fs)
    slices = [[movable(bins)[i * n_loc:(i + 1) * n_loc, c.start:c.stop]
               .contiguous().view(bins.dtype) for c in cols]
              for i in range(d)]
    return make_block_bins(slices, [c.start for c in cols] + [f], dev), cols


def block_sectors(rl, leaf, cols, c, d, n_loc, bin_bytes) -> int:
    """The 32-byte sectors of column ``c``'s bins at the rows of ``leaf``
    in the slices that own it (each slot's row-major slice, ``w_j`` bins a
    row)."""
    j = next(k for k, r in enumerate(cols) if c in r)
    total = 0
    for i in range(d):
        rows = (rl[i * n_loc:(i + 1) * n_loc] == leaf).nonzero().view(-1)
        total += route_sectors(rows, c - cols[j].start, len(cols[j]), 1,
                               bin_bytes)
    return total


def check_block_route(dev, rng):
    """Phase 2k: the block-sharded form of ``route_rows``
    (``route_rows_block``, ``csrc/route.cu`` lgbt_block_route) against
    its plain version on the same slices, bit for bit (map and counts),
    and against the counts of the map it leaves.  At a 2x2 and a 1x4 cut
    of 1,000,000 x 28: uint8 bins with a split on every column (so the
    column owned by each feature shard in turn, every missing type), a
    uint16 matrix of 1,023 bins with splits past bin 255 on columns of
    each shard and a categorical one, and the Covertype layout's bundled
    12 columns (bundle slots decoded); from a leaf of many rows, the root,
    an absent leaf and the sink, which move nothing.  Times at the 2x2
    cut (the root, and a leaf of about 1,000 rows; new = leaf so that a
    call repeats) beside the plain version, with the sector bound."""
    import torch
    from lightgbm_tpu_torch.grower import FeatureMeta
    from lightgbm_tpu_torch.ops.route import (route_rows_block,
                                              route_rows_block_plain)
    L = 255
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)

    def plain_meta(f, nb):
        return FeatureMeta(i32([nb] * f), i32([k % 3 for k in range(f)]),
                           i32([(37 * k) % nb for k in range(f)]))

    def counts_of(rl, d):
        return torch.stack([torch.bincount(r.long(), minlength=L + 1).int()
                            for r in rl.view(d, -1)])

    def pool(split, leaf, width):
        si = np.zeros((L + 1, 3), np.int32)
        cat = np.zeros(L + 1, bool)
        si[leaf], cat[leaf] = split[:3], split[3]
        si[L] = (-1, 0, 0)
        return (torch.from_numpy(si).to(dev), torch.from_numpy(cat).to(dev),
                torch.from_numpy(rng.random((L + 1, width)) < 0.5).to(dev))

    every_col = {f"c{c}": (c, 40 + 7 * c, c % 2, False)
                 for c in range(N_FEAT)}
    sets = {
        "higgs_u8": (N_FEAT, np.uint8, N_BINS, False, every_col),
        "higgs_u16": (N_FEAT, np.uint16, WIDE_BINS, False,
                      BLOCK_U16_SPLITS),
        "covtype_bundled": (COVTYPE_COLS, np.uint8, N_BINS, True,
                            BUNDLED_SPLITS)}
    checked = moved_total = 0
    kept = None
    for label, (f, dtype, nb, bundled, splits) in sets.items():
        if bundled:
            host = covtype_bundled_bins(N_ROWS, rng)
            meta = covtype_bundle_meta(dev)
        else:
            host = rng.integers(0, nb, (N_ROWS, f)).astype(dtype)
            meta = plain_meta(f, nb)
        bins = torch.from_numpy(host).to(dev)
        del host
        skewed = torch.from_numpy(rng.integers(0, 4, N_ROWS).astype(
            np.int32)).to(dev)
        root = torch.zeros(N_ROWS, dtype=torch.int32, device=dev)
        for shape in ((2, 2), (1, 4)):
            d, set_moved = shape[0], 0
            block, cols = block_table(bins, shape, dev)
            cases = [(f"{name}_{where}", m, leaf, new, split)
                     for k, (name, split) in enumerate(splits.items())
                     for where, m, leaf, new in (
                         ("many", skewed, k % 4, L - 1), ("root", root, 0, 1))]
            first = next(iter(splits.values()))
            cases += [("absent", skewed, L - 2, L - 1, first),
                      ("sink", skewed, L, L, first)]
            for case, rl0, leaf, new, split in cases:
                si, cat, catb = pool(split, leaf, nb)
                lt, nt = i32([leaf]).long(), i32([new]).long()
                out = {}
                for kind, fn in (("kernel", route_rows_block),
                                 ("plain", route_rows_block_plain)):
                    rl, cnt = rl0.clone(), counts_of(rl0, d)
                    fn(rl, block, lt, nt, si, cat, catb, meta, cnt)
                    out[kind] = (rl, cnt)
                torch.cuda.synchronize()
                (rk, ck), (rp, cp) = out["kernel"], out["plain"]
                if not (torch.equal(rk, rp) and torch.equal(ck, cp)):
                    fail(f"route_rows_block != plain at {label} {shape} "
                         f"{case}: {int((rk != rp).sum())} rows differ")
                if not torch.equal(ck, counts_of(rk, d)):
                    fail(f"route_rows_block counts != the map's at {label} "
                         f"{shape} {case}")
                moved = int((rk != rl0).sum())
                if case in ("absent", "sink") and moved:
                    fail(f"route_rows_block moved {moved} rows at {label} "
                         f"{shape} {case}")
                moved_total += moved
                set_moved += moved
                checked += 1
            if not set_moved:
                fail(f"route_rows_block moved no row at {label} {shape}")
            if label == "higgs_u8" and shape == (2, 2):
                kept = (bins, block, cols, skewed, meta)
        del bins, skewed, root
    phase("block_route_vs_plain", sets=",".join(sets), cuts="2x2,1x4",
          rows=N_ROWS, cases=checked, rows_moved=moved_total, exact=True)

    bins, block, cols, skewed, meta = kept
    n, f = bins.shape
    d = 2
    sizes = np.bincount(skewed.cpu().numpy(), minlength=4)
    small_map = skewed.clone()
    # a leaf of about 1,000 rows: 1,000 rows of leaf 0 moved to leaf 5
    idx = torch.nonzero(small_map == 0).view(-1)[::max(1, int(
        sizes[0]) // 1000)][:1000]
    small_map[idx] = 5
    split = every_col["c20"]
    timing = {}
    for label, m, leaf in (("root", torch.zeros_like(skewed), 0),
                           ("leaf_1000", small_map, 5)):
        rl = m.clone()
        si, cat, catb = pool(split, leaf, N_BINS)
        lt = i32([leaf]).long()
        cnt = counts_of(rl, d)
        probe = rl.clone()
        route_rows_block_plain(probe, block, lt, i32([L - 1]).long(), si,
                               cat, catb, meta, cnt.clone())
        moved = int((probe != rl).sum())
        k = three_times(lambda: route_rows_block(rl, block, lt, lt, si, cat,
                                                 catb, meta, cnt))
        p_ms = cuda_ms(lambda: route_rows_block_plain(
            rl, block, lt, lt, si, cat, catb, meta, cnt), reps=3)
        if not torch.equal(rl, m):
            fail(f"route_rows_block with new = leaf changed the map at "
                 f"{label}")
        sectors = block_sectors(rl, leaf, cols, split[0], d, n // d, 1)
        bound_ms = route_block_bound_ms(n, sectors, moved, N_BINS)
        timing[label] = dict(k, plain_ms=p_ms, bound_ms=bound_ms,
                             leaf_rows=int((rl == leaf).sum()), moved=moved,
                             sectors=sectors)
        phase("block_route_time", leaf=label, cut=f"2x2 of {n}x{f}",
              leaf_rows=timing[label]["leaf_rows"], moved=moved,
              sectors=sectors,
              **{k_: f"{v:.4f}" for k_, v in timing[label].items()
                 if isinstance(v, float) and "bound" not in k_},
              bound_ms=f"{bound_ms:.5f}",
              bound_share=f"{bound_ms / k['device_ms']:.3f}"
              if k["device_ms"] else "not measured")
    del kept, bins, block
    return timing


def empty_launch_cost(dev, rng):
    """Phase 2f: what the captured step's gated launches cost at the Expo
    path's 11,000,000 rows and 8 columns.  The step knows the window's
    count only on the device, so it launches the partition's three kernels
    and the histogram's two over the grid of the largest window, and those
    that the window's count does not take return at once.  Against that,
    what a host that knows the count would launch: the partition over the
    window's own tiles (its three launches still gated by the count) and
    the histogram's host-picked plan; at an empty window (a step after the
    stop), 4,097 and 1,000,000 rows; device time a call (profiler, every
    kernel and memset) and CUDA events around back-to-back calls."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (hist_window, plan_device,
                                                  sm_count)
    from lightgbm_tpu_torch.ops.partition import (partition_scratch,
                                                  partition_window)
    n, f = N_EXPO, len(EXPO_CATEGORICAL) + 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    src = [torch.randperm(n, device=dev, generator=gen).int(),
           torch.randint(0, N_BINS, (n, f), dtype=torch.uint8, device=dev,
                         generator=gen),
           *[torch.rand(n, device=dev, generator=gen) for _ in range(3)]]
    dst = [torch.empty_like(x) for x in src]
    scratch = partition_scratch(n, dev)
    gl = torch.rand(n, device=dev, generator=gen) < 0.43
    odd = torch.zeros(1, dtype=torch.int32, device=dev)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    plan = plan_device(n, f, N_BINS, num_sms=sm_count(dev.index or 0))
    out = {}
    for cnt in (0, 4097, 1_000_000):
        sc = torch.tensor([1000, cnt], dtype=torch.int64, device=dev)
        sc32 = sc.int()
        cases = {
            "partition_device": lambda: partition_window(
                src, dst, sc, gl, n, scratch, odd),
            "partition_host": lambda: partition_window(
                src, dst, sc, gl, cnt, scratch),
            "hist_device": lambda: hist_window(
                iota, sc32, *src[1:], N_BINS, plan=plan),
            "hist_host": lambda: hist_window(
                iota, sc32, *src[1:], N_BINS, rows_upper_bound=cnt),
        }
        for name, fn in cases.items():
            t = dict(ms_many=cuda_ms_many(fn), device_ms=profiled_ms(fn)[0])
            out[(name, cnt)] = t
        phase("gated_launches", window_rows=cnt, **{
            f"{name}_{k}": f"{out[(name, cnt)][k]:.4f}"
            if out[(name, cnt)][k] is not None else "not measured"
            for name in cases for k in ("ms_many", "device_ms")})
    del src, dst, scratch, gl, iota
    return out


def loop_state(inner):
    """The split loop's state of a booster: the data-parallel learner's or
    the serial grower's (``grower.SplitLoop``), or None before a tree."""
    return inner._gspmd if inner._gspmd is not None else inner._windows


def real_launches(raw: dict, state, replays: int, captures: int) -> dict:
    """Each wrapper's launches on the card from its counts ``raw``: a
    capture counts the split step's launches without making them, and a
    replay makes them without counting (``SplitLoop.graph_launches``, the
    counts of one capture)."""
    per = state.graph_launches if state is not None else {}
    return {k: v + (replays - captures) * per.get(k, 0)
            for k, v in raw.items()}


def k3_work(grower, steps: int) -> dict:
    """Which kernel of the data-parallel step's device-regime K3 calls did
    the work in the tree the learner just grew: a call whose leaf holds at
    most ``SMALL_MAX_ROWS_LOCAL`` rows in its shard is the small kernel's,
    a larger one the large kernel's, and a call on a leaf of no rows (a
    step after the stop) neither's.  The rows a child held when it was
    measured are those of its subtree at the end: from the learner's final
    row -> leaf maps, node records and leaf counts, the smaller child
    picked as the step picks it (by count weight)."""
    from lightgbm_tpu_torch.ops.histogram import SMALL_MAX_ROWS_LOCAL
    pool, L = grower.pool, grower.cfg.num_leaves
    splits = int(grower.counters[0])
    per_leaf = np.stack([np.bincount(
        grower._shard(grower.row_leaf[devs[0]], i, devs[0]).cpu().numpy(),
        minlength=L + 1) for i, devs in enumerate(grower.mesh.devices)])
    left, right = (t.cpu().numpy() for t in (pool.left_child,
                                             pool.right_child))
    weight = pool.leaf_f[:, 1].cpu().numpy()

    def subtree(child):
        """The rows in each shard and the count weight of a subtree."""
        if child < 0:
            return per_leaf[:, ~child], weight[~child]
        (a, wa), (b, wb) = subtree(left[child]), subtree(right[child])
        return a + b, wa + wb

    rows = [per_leaf.sum(1)]      # the root's calls
    for node in range(splits):
        (a, wa), (b, wb) = subtree(left[node]), subtree(right[node])
        rows.append(a if wa <= wb else b)
    rows = np.concatenate(rows)
    slices = len(grower.cols)
    empty = slices * ((steps - splits) * len(grower.mesh.devices)
                      + int((rows == 0).sum()))
    return dict(
        hist_local_small_work_calls_per_tree=slices * int(
            ((rows > 0) & (rows <= SMALL_MAX_ROWS_LOCAL)).sum()),
        hist_local_large_work_calls_per_tree=slices * int(
            (rows > SMALL_MAX_ROWS_LOCAL).sum()),
        hist_local_empty_calls_per_tree=empty)


def graph_vs_eager(name, ds, y, dev_names, **cfg_kw):
    """Phase 7: one tree of a path under integer-valued gradients and
    hessians, whose sums are exact in any order, grown by the graph loop
    (the split step captured once and replayed), by the eager loop (the
    same step run as it is) and, with ``ordered_bins=off``, by the
    ``scatter`` partition: identical field by field, row -> leaf maps too.
    The graph loop's trees after its capture run under
    ``torch.cuda.set_sync_debug_mode("error")``, so any read back to the
    host but its counted stop reads (an event wait) raises.  Then ms a
    tree in turns (graph, eager) and one profiled tree of
    the graph loop: device-busy share, kernel and graph launch calls, host
    reads and the kernels' device ms."""
    import torch
    from lightgbm_tpu_torch.grower import (FeatureMeta, GrowerConfig,
                                           WindowBuffers, grow_tree)
    dev = ds.bins.device
    td = ds.constructed
    fm = td.feature_meta()
    n, f = ds.bins.shape
    rng = np.random.default_rng(SEED + 6)
    put = lambda a: torch.from_numpy(a).to(dev)
    g = put((np.where(y > 0, -3, 2) + rng.integers(-2, 3, n)).astype(
        np.float32))
    h = put(rng.integers(1, 4, n).astype(np.float32))
    c = torch.ones(n, dtype=torch.float32, device=dev)
    meta = FeatureMeta(put(fm["num_bin"]), put(fm["missing_type"]),
                       put(fm["default_bin"]), put(fm["is_categorical"]))
    fv = torch.ones(f, dtype=torch.bool, device=dev)
    cfg = GrowerConfig(
        num_leaves=255, min_data_in_leaf=1, min_sum_hessian_in_leaf=10.0,
        max_bin=td.max_num_bin(),
        has_missing=bool((fm["missing_type"] != 0).any()),
        has_categorical=bool(fm["is_categorical"].any()),
        partition_impl="compact", **cfg_kw)
    loops = {"graph": WindowBuffers(n, f, cfg, dev),
             "eager": WindowBuffers(n, f, cfg, dev)}
    stats = {k: {} for k in loops}
    grown = {k: 0 for k in loops}
    checked = [0]      # graph trees grown under the sync check

    def grow(loop, sync_check=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            tree, rl = grow_tree(ds.bins, g, h, c, meta, fv, cfg, stats[loop],
                                 loops[loop], loop)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        grown[loop] += 1
        checked[0] += sync_check
        return (time.perf_counter() - t0) * 1e3, tree, rl

    def host(tree, rl):
        return ({k: v.cpu().numpy() for k, v in tree._asdict().items()
                 if isinstance(v, torch.Tensor)}, rl.cpu().numpy(),
                tree.num_leaves)

    want = host(*grow("eager")[1:])
    got = {"graph_capture": host(*grow("graph")[1:]),
           "graph_replay": host(*grow("graph", sync_check=True)[1:])}
    if cfg.ordered_bins == "off":
        scatter = cfg._replace(partition_impl="scatter")
        got["scatter"] = host(*grow_tree(ds.bins, g, h, c, meta, fv, scatter,
                                         loop="eager"))
    for k, other in got.items():
        bad = [x for x in want[0] if not np.array_equal(want[0][x],
                                                        other[0][x])]
        if bad or want[2] != other[2] or not np.array_equal(want[1],
                                                            other[1]):
            fail(f"{name}: the {k} tree != the eager tree in "
                 f"{bad or 'num_leaves/row_leaf'}")
    ms = {"graph": [], "eager": []}
    for loop in ("graph", "eager"):
        ms[loop].append(grow(loop, sync_check=loop == "graph")[0])
    prof = {}
    fns = _kernel_wrappers()
    # the eager loop's profile (some 50,000 to 110,000 launches a tree)
    # took most of this phase's time; its ms a tree are timed above
    for loop in ("graph",):
        res, _, st0, missed = profile_checked(
            f"{name} {loop} loop", fns, lambda: grow(loop),
            lambda: stats[loop], loops[loop].graph_launches, dev_names)
        wall, per, all_ms, _, calls, ran = res
        prof[loop] = dict(
            profiled_ms=f"{wall * 1e3:.2f}",
            device_busy_share=f"{all_ms / (wall * 1e3):.4f}" if all_ms
            else "not measured",
            host_reads=stats[loop]["host_syncs"] - st0["host_syncs"],
            **{f"{k}_calls": v for k, v in calls.items()},
            **{f"{k}_ran": v for k, v in ran.items()},
            trees_profiled_again=len(missed),
            **{f"{k}_device_ms": f"{v:.3f}" if all_ms else "not measured"
               for k, v in per.items()})
    st = stats["graph"]
    if st["host_syncs"] > grown["graph"] * (
            -(-(cfg.num_leaves - 1) // 32) + 1):
        fail(f"{name}: {st['host_syncs']} host reads in {grown['graph']} "
             f"graph trees")
    out = dict(rows=n, leaves=want[2], identical=",".join(["eager", *got]),
               sync_checked_replay_trees=checked[0],
               captured_launches_per_step=loops["graph"].graph_launches,
               graph_ms_per_tree=",".join(f"{v:.2f}" for v in ms["graph"]),
               eager_ms_per_tree=",".join(f"{v:.2f}" for v in ms["eager"]),
               host_syncs_per_tree_graph=(
                   f"{st['host_syncs'] / grown['graph']:.3f}"),
               host_syncs_per_tree_eager=(
                   f"{stats['eager']['host_syncs'] / grown['eager']:.3f}"),
               **{f"{loop}_{k}": v for loop, d in prof.items()
                  for k, v in d.items()})
    phase(f"{name}_graph_vs_eager", **out)
    del loops
    return out


def _kernel_wrappers():
    """Every kernel wrapper of the paths, by name."""
    from lightgbm_tpu_torch.ops.histogram import hist_local, hist_window
    from lightgbm_tpu_torch.ops.lambdarank import lambdarank_grad
    from lightgbm_tpu_torch.ops.partition import partition_window
    from lightgbm_tpu_torch.ops.route import (route_rows, route_rows_block,
                                              route_window)
    from lightgbm_tpu_torch.ops.split import cat_group_accept
    return {f.__name__: f for f in (hist_window, hist_local, partition_window,
                                    route_window, route_rows,
                                    route_rows_block, cat_group_accept,
                                    lambdarank_grad)}


def auc_quality(bst, pred, x_te, y_te) -> dict:
    """The binary paths' held-out check: an AUC of a learned model."""
    test_auc = auc(pred, y_te)
    if not 0.6 < test_auc <= 1.0:
        fail(f"held-out AUC {test_auc} is not that of a learned model")
    return {"heldout_auc": f"{test_auc:.6f}"}


def train_path(name, params, x_tr, y_tr, x_te, y_te, rounds, dev_names,
               group=None, quality=auc_quality, ds=None, valid=False,
               train_kw=None, profile=True):
    """Drive one path through ``train`` and ``predict`` with the kernel
    counts set to 0 just before and read just after; returns its numbers
    and the booster.  ``group`` gives the training queries' sizes;
    ``quality(bst, pred, x_te, y_te)`` checks the held-out predictions and
    returns its numbers.  With K trees a round, the profiled update grows
    K trees, and its numbers "a tree" are the round's over K.  ``ds`` is
    the training rows' Dataset when it is already built; ``valid`` adds
    the held-out rows as a valid set; ``train_kw`` goes to ``train``;
    ``profile=False`` leaves out the profiled tree and its numbers.

    On the graph loop a wrapper counts once at the capture, which launches
    nothing, and never at a replay, which launches: the launches are the
    counts plus (replays - captures) times the captured step's counts
    (:func:`real_launches`), and the split step's kernels run once a step
    taken, the steps after a tree's stop included."""
    import torch
    from lightgbm_tpu_torch import Dataset, train
    from lightgbm_tpu_torch.ops.partition import SMALL_MAX_ROWS
    fns = _kernel_wrappers()
    t0 = time.perf_counter()
    if ds is None:
        ds = Dataset(x_tr, y_tr, group=group, params=params).construct()
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    kw = dict(train_kw or {})
    if valid:
        kw["valid_sets"] = [ds.create_valid(x_te, y_te)]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for fn in fns.values():
        fn.launches = 0
        for k in getattr(fn, "regime_launches", {}):
            fn.regime_launches[k] = 0
    t0 = time.perf_counter()
    bst = train(params, ds, num_boost_round=rounds, verbose_eval=False, **kw)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    raw = {k: fn.launches for k, fn in fns.items()}
    # the same counts by the regime of their plan
    by_regime = {f"{kernel}_{k}_count": v for kernel, fn in (
        ("hist", fns["hist_window"]), ("hist_local", fns["hist_local"]))
        for k, v in fn.regime_launches.items()}
    stats = dict(bst.inner.stats)
    state = loop_state(bst.inner)
    graph = state is not None and state.graph is not None
    launches = real_launches(raw, state, stats.get("graph_replays", 0),
                             int(graph))
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    pred = bst.predict(x_te)
    t_pred = time.perf_counter() - t0
    trees, splits = stats["trees"], stats["splits"]
    K = bst.inner.num_class
    rounds_run = trees // K
    if splits != sum(m.num_leaves - 1 for m in bst.inner.models):
        fail(f"{name}: {splits} splits counted, the models hold "
             f"{sum(m.num_leaves - 1 for m in bst.inner.models)}")
    # the data-parallel learner measures every leaf on each mesh slot with
    # the shard-local kernel; the serial grower with the gather kernel
    mesh = bst.inner.mesh
    shards = 0 if mesh is None else len(sum(mesh.devices, []))
    if (bst.inner.parallel_impl in ("gspmd", "shardmap")) != (
            params.get("tree_learner", "serial") != "serial"):
        fail(f"{name}: learner resolved to {bst.inner.parallel_impl}")
    # on a card gspmd_hist=auto is the shard-local kernel
    if shards and bst.inner.gspmd_hist != params.get("gspmd_hist", "fused"):
        fail(f"{name}: gspmd_hist resolved to {bst.inner.gspmd_hist}")
    compact = bst.inner.grower_cfg.partition_impl == "compact"
    # the graph loop: the serial grower's with compact, the data-parallel
    # learner's with the shard-local kernel and every slot on one card
    holders = len(bst.inner._gspmd.held) if shards else 0
    block = bool(shards) and bst.inner._gspmd.block is not None
    can_graph = (compact if not shards else
                 bst.inner.gspmd_hist == "fused" and holders == 1)
    if graph != can_graph:
        fail(f"{name}: took the {'graph' if graph else 'eager'} loop")
    # steps that ran the split step's kernels: every step of the device
    # loops; a step of the eager scatter/sort loop that found the tree
    # stopped returns before its first kernel
    steps = stats["steps"] if compact or shards else splits
    if (compact or shards) and not (splits <= stats["steps"]
                                    <= splits + 32 * trees):
        fail(f"{name}: {stats['steps']} steps for {splits} splits in "
             f"{trees} trees")
    categorical = bool(ds.constructed.feature_meta()["is_categorical"].any())
    want = {"hist_window": 0 if shards else trees + steps,
            "hist_local": (shards * (trees + steps)
                           if bst.inner.gspmd_hist == "fused" else 0),
            "partition_window": steps if compact and not shards else 0,
            "route_window": 0 if shards else steps,
            "route_rows": 0 if block else holders * steps,
            "route_rows_block": holders * steps if block else 0,
            "cat_group_accept": trees + steps if categorical else 0,
            "lambdarank_grad": (rounds_run if params["objective"]
                                == "lambdarank" else 0)}
    if launches != want or sum(launches.values()) == 0:
        fail(f"{name}: kernel launches {launches} (counted {raw}), "
             f"expected {want} ({shards} mesh slots, {trees} trees, "
             f"{splits} splits, {stats.get('steps')} steps, "
             f"{stats.get('graph_replays', 0)} replays)")
    for kernel, fn in (("hist", fns["hist_window"]),
                       ("hist_local", fns["hist_local"])):
        if sum(fn.regime_launches.values()) != fn.launches:
            fail(f"{name}: {kernel} counts by regime {by_regime} do not add "
                 f"up to {fn.launches}")
    if by_regime["hist_local_small_count"] or by_regime[
            "hist_local_large_count"]:
        fail(f"{name}: a hist_local call took a host-picked regime "
             f"({by_regime}); the split step leaves it to the device")
    syncs_per_tree = stats["host_syncs"] / trees
    if graph and syncs_per_tree > -(-(bst.inner.grower_cfg.num_leaves - 1)
                                    // 32) + 1:
        fail(f"{name}: {syncs_per_tree} host reads a tree on the graph loop")
    if graph and not stats["graph_replays"]:
        fail(f"{name}: the graph loop replayed no step")
    if (pred.shape != ((len(y_te),) if K == 1 else (len(y_te), K))
            or not np.isfinite(pred).all()):
        fail(f"{name}: held-out predictions are not finite of the expected "
             f"shape")
    held_out = quality(bst, pred, x_te, y_te)
    out = dict(rows=len(y_tr), features=x_tr.shape[1], trees=trees,
               rounds=rounds_run, trees_per_round=K,
               splits=splits, steps=stats.get("steps", splits),
               graph_replays=stats.get("graph_replays", 0),
               loop="graph" if graph else "eager",
               **{f"{k}_launches": v for k, v in launches.items()},
               **by_regime, construct_s=f"{t_data:.3f}",
               ms_per_tree=f"{t_train * 1e3 / trees:.2f}",
               host_syncs_per_split=f"{stats['host_syncs'] / splits:.4f}",
               host_syncs_per_tree=f"{syncs_per_tree:.3f}",
               peak_mem_bytes=peak, predict_s=f"{t_pred:.3f}",
               **memory_fields(bst, peak, base), **held_out)
    if not profile:
        return out, bst, ds

    # device time of the kernels over one more tree (profiling two made
    # the script take more than half its time limit)
    prof_bst = train(params, ds, num_boost_round=1, verbose_eval=False)
    per_step = loop_state(prof_bst.inner).graph_launches
    res, snap, st0, missed = profile_checked(
        name, fns, prof_bst.update, lambda: prof_bst.inner.stats, per_step,
        dev_names)
    wall, per, all_ms, host, calls, ran = res
    st1 = prof_bst.inner.stats
    replays = st1.get("graph_replays", 0) - st0.get("graph_replays", 0)
    tree_launches = {k: (fn.launches - snap[0][k] + replays
                         * per_step.get(k, 0)) / K for k, fn in fns.items()}
    tree_kernels = dict(
        partition_calls_per_tree=f"{tree_launches['partition_window']:g}",
        route_launches_per_tree=f"{tree_launches['route_window']:g}",
        route_rows_launches_per_tree=f"{tree_launches['route_rows']:g}",
        cat_group_launches_per_tree=f"{tree_launches['cat_group_accept']:g}",
        lambdarank_launches_per_round=round(
            tree_launches["lambdarank_grad"] * K),
        trees_in_profiled_round=K,
        host_syncs_in_profiled_tree=f"{(st1['host_syncs'] - st0['host_syncs']) / K:g}",
        **{f"{k}_ran_in_profiled_round": v for k, v in ran.items()},
        trees_profiled_again=len(missed),
        **{f"{k}_calls_per_tree": f"{v / K:g}" for k, v in calls.items()})
    if tree_launches["partition_window"]:
        # three launches a call; which windows did the small launch's
        # work and which the count and write launches', from the tree's
        # node counts (each node's count is its window)
        last = prof_bst.inner.models[-1]
        counts = last.internal_count[:last.num_leaves - 1]
        small = int((counts <= SMALL_MAX_ROWS).sum())
        tree_kernels.update(
            partition_launches_per_tree=f"{sum(ran[k] for k in KERNELS['partition_window']) / K:g}",
            partition_small_windows_per_tree=small,
            partition_large_windows_per_tree=len(counts) - small)
        # the sum of the tree's per-call bounds: every partitioned position
        # moves its mask and every matrix's row
        widths = [x[0].numel() * x.element_size()
                  for x in prof_bst.inner._windows.bufs[0]]
        positions = (st1["partition_positions"]
                     - st0.get("partition_positions", 0))
        bound = part_bound_bytes(positions, widths) / H100_BYTES_PER_S
        tree_kernels["partition_bound_ms_per_tree"] = (
            f"{bound * 1e3 / K:.4f}")
    if shards and tree_launches["hist_local"]:
        # which kernel of each device-regime call did the work
        tree_kernels.update(k3_work(prof_bst.inner._gspmd,
                                    st1["steps"] - st0["steps"]))
    phase(f"{name}_host_ops", profiled_s=f"{wall:.3f}", trees=K, **{
        key.replace(" ", "_"): f"{ms / K:.1f}ms/tree,{count / K:g}calls/tree"
        for ms, key, count in host})
    out.update(tree_kernels)
    for n, ms in per.items():   # 0 for a kernel this path does not run
        out[f"{n}_device_ms_per_tree"] = (f"{ms / K:.3f}" if all_ms
                                          else "not measured")
    out["device_busy_share"] = (f"{all_ms / (wall * 1e3):.4f}" if all_ms
                                else "not measured")
    return out, bst, ds


def memory_fields(bst, peak: int, base: int) -> dict:
    """The memory model (``obs/memory.py``) against the card for a
    training just run: the prediction at the layout it planned, with its
    valid sets, beside the training's own peak, ``max_memory_allocated``
    since the reset (``peak``) less what was allocated at the reset
    (``base``: earlier phases' tensors) plus the Dataset's matrix, which
    was on the card before the reset and which the model counts; and the
    census of the resident terms' tensors against the model's resident
    bytes, term by term."""
    from lightgbm_tpu_torch.obs import memory
    from lightgbm_tpu_torch.parallel import mesh as mesh_mod
    inner = bst.inner
    layout = dict(inner.plan.layout, valid_rows=sum(
        vs.data.num_data for vs in inner.valid_sets))
    pred = mesh_mod.predict_hbm(**layout)
    census = memory.live_census(bst)
    own = (inner.bins.numel() * inner.bins.element_size()
           if inner.bins is not None and inner.bins.is_cuda else 0)
    measured = peak - base + own
    return dict(
        mem_training_peak_bytes=measured,
        mem_predicted_peak_bytes=pred["peak_bytes"],
        mem_ratio=f"{pred['peak_bytes'] / max(measured, 1):.4f}",
        mem_predicted_resident_bytes=pred["resident_bytes"],
        mem_census_bytes=sum(census.values()),
        mem_census_equal=census == pred["residents"],
        mem_census_diff=";".join(
            f"{k}:{census.get(k, 0)}/{v}" for k, v in
            {**{k: 0 for k in census}, **pred["residents"]}.items()
            if census.get(k, 0) != v) or "none",
        mem_transients=";".join(f"{k}:{v}" for k, v in
                                pred["transients"].items()),
        mem_base_bytes=base, mem_layout=(
            f"{inner.plan.learner}:{layout.get('data_shards', 1)}x"
            f"{layout.get('feature_shards', 1)}"
            + (":block" if layout.get("block_shard_bins") else "")
            + (f":chunk{layout['stream_chunk_rows']}"
               if layout.get("stream_chunk_rows") else "")))


# phase 23a's paths: (label, phase, where its numbers are in ``runs``)
MODEL_PATHS = ("3b higgs_compact", "5 expo", "6 dp_4x1", "8 mslr_packed",
               "9 covtype_bundled", "18 higgs_1023", "18 higgs_1023_dp_4x1",
               "19 expo_wide", "20b mslr_streamed", "21b mslr_data_4x1",
               "21b mslr_voting_4x1")
# the band phase 23a holds the predicted peak to, over the measured
MODEL_BAND = (1.0, 1.3)


def model_vs_card(runs: dict) -> dict:
    """Phase 23a: for every path the smoke profiles, the memory model's
    predicted peak against the training's measured peak
    (:func:`memory_fields`, taken when the path ran: no new training),
    their ratio held to :data:`MODEL_BAND`, and the census of the resident
    terms' tensors equal to the model's resident bytes."""
    bad = []
    out = {}
    for label in MODEL_PATHS:
        r = runs[label]
        ratio = float(r["mem_ratio"])
        phase("model_vs_card", path=label.replace(" ", ":"),
              layout=r["mem_layout"],
              predicted_peak_bytes=r["mem_predicted_peak_bytes"],
              measured_peak_bytes=r["mem_training_peak_bytes"],
              max_memory_allocated=r["peak_mem_bytes"],
              allocated_at_reset=r["mem_base_bytes"], ratio=r["mem_ratio"],
              predicted_resident_bytes=r["mem_predicted_resident_bytes"],
              census_bytes=r["mem_census_bytes"],
              census_equal=r["mem_census_equal"],
              census_diff=r["mem_census_diff"],
              transients=r["mem_transients"])
        out[label] = ratio
        if not MODEL_BAND[0] <= ratio <= MODEL_BAND[1]:
            bad.append(f"{label}: predicted/measured {ratio}")
        if not r["mem_census_equal"]:
            bad.append(f"{label}: census != resident terms "
                       f"({r['mem_census_diff']})")
    if bad:
        fail(f"the memory model against the card: {bad}")
    return out


def planned_layout(params, ds) -> dict:
    """The memory model's keywords of a training of ``params`` on ``ds``,
    as ``train`` plans it on the card (``boosting.plan_training``), with
    no training and nothing moved to the card."""
    from lightgbm_tpu_torch.boosting import plan_training
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.objectives import create_objective
    cfg = config_from_params(params)
    return dict(plan_training(cfg, ds.constructed,
                              create_objective(cfg)).layout)


def chunked_rung(params, ds, y, tree20a) -> dict:
    """Phase 23b: the Higgs Dataset (1,000,000 x 28, its matrix off the
    card) by ``data_stream=auto`` with ``hbm_budget`` halfway between the
    model's resident peak and its streamed peak at the default block, 3
    rounds: the walk chooses the streamed rung at the default block, the
    training's peak stays under the budget, and the streamed grower it
    built grows phase 20a's integer-gradient tree, field by field and in
    the row -> leaf map."""
    import torch
    from lightgbm_tpu_torch import train
    from lightgbm_tpu_torch.parallel import mesh as mesh_mod
    p = dict(params, min_sum_hessian_in_leaf=10.0, ordered_bins="off")
    ds.bins = None
    layout = planned_layout(p, ds)
    chunk = mesh_mod.default_chunk_rows(len(y))
    res = mesh_mod.predict_hbm(**layout)["peak_bytes"]
    streamed = mesh_mod.predict_hbm(**dict(
        layout, stream_chunk_rows=chunk))["peak_bytes"]
    budget = (res + streamed) // 2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bst = train(dict(p, data_stream="auto", hbm_budget=budget), ds,
                num_boost_round=3, verbose_eval=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 3
    peak = torch.cuda.max_memory_allocated() - base
    inner = bst.inner
    pl = inner.placement
    out = dict(budget_bytes=budget, resident_predicted_bytes=res,
               streamed_predicted_bytes=streamed, mode=pl.mode,
               chunk_rows=pl.chunk_rows, reason=repr(pl.reason),
               measured_peak_bytes=peak, ms_per_tree=f"{ms:.2f}")
    if pl.mode != "chunked" or pl.chunk_rows != chunk \
            or inner._streamed is None or ds.bins is not None:
        fail(f"chunked rung: the walk chose {pl.mode} ({pl.reason})")
    if peak > budget:
        fail(f"chunked rung: measured peak {peak} over hbm_budget {budget}")
    g, h, c, meta, fv, want = tree20a
    tree, rl = inner._streamed(g, h, c, inner.meta, fv, {})
    got = {k: v.cpu().numpy() for k, v in tree._asdict().items()
           if isinstance(v, torch.Tensor)}
    bad = [k for k in want[0] if not np.array_equal(want[0][k], got[k])]
    if bad or tree.num_leaves != want[2] or not np.array_equal(
            rl.cpu().numpy(), want[1]):
        fail(f"chunked rung: the integer tree != phase 20a's in "
             f"{bad or 'num_leaves/row_leaf'}")
    out["tree_identical_to_20a"] = True
    phase("chunked_rung", **out)
    del bst
    torch.cuda.empty_cache()
    return out


def planner_rung(rank_params, ds, x_tr, y_tr, x_te, y_te, sizes_te,
                 names) -> dict:
    """Phase 23c: phase 8's Dataset unpacked (``enable_bin_packing=false``:
    2,270,296 x 137 uint8) by ``mesh_shape=auto`` over 4 mesh slots on the
    one card, 3 rounds through :func:`train_path` (kernel counts and
    launch checks), with ``hbm_budget`` halfway between the model's 2x2
    replicated and 2x2 block-sharded peaks of the card.  The learner is
    ``data_feature``, whose walk starts at the square 2x2 (``prefer``
    square): under ``tree_learner=data`` the walk starts at 4x1, whose one
    copy of the bins (its column-major route copy) is as large as the
    block-sharded slices and fits that budget first, as the plan printed
    beside shows.  The walk chooses 2x2 with block-sharded bins, no card
    holds a route copy, the measured peak stays under the budget, and the
    held-out NDCG@1/3/5/10 are printed."""
    import torch
    from lightgbm_tpu_torch.parallel import mesh as mesh_mod
    p = dict(rank_params, tree_learner="data_feature",
             mesh_devices=MESH_SLOTS, mesh_shape="auto",
             enable_bin_packing=False)
    layout = planned_layout(dict(p, mesh_shape="2x2"), ds)
    for k in ("data_shards", "feature_shards", "block_shard_bins"):
        layout.pop(k)
    peak = lambda d, f, b: mesh_mod.predict_hbm(**dict(
        layout, data_shards=d, feature_shards=f,
        block_shard_bins=b))["peak_bytes"]
    repl, block = peak(2, 2, False), peak(2, 2, True)
    budget = (repl + block) // 2
    as_data = mesh_mod.plan_mesh(MESH_SLOTS, capacity=budget,
                                 prefer="data", **layout)
    quality = lambda b, pred, x, y: {
        f"heldout_ndcg@{k}": f"{v:.6f}" for k, v in zip(
            MSLR_EVAL_AT, ndcg_at(pred, y, sizes_te, list(MSLR_EVAL_AT)))}
    torch.cuda.empty_cache()
    res, bst, _ = train_path("mslr_planner", dict(p, hbm_budget=budget),
                             x_tr, y_tr, x_te, y_te, 3, names,
                             quality=quality, ds=ds, profile=False)
    plan = bst.inner.mesh_plan
    g = bst.inner._gspmd
    measured = res["mem_training_peak_bytes"]
    out = dict(budget_bytes=budget, predicted_2x2_replicated_bytes=repl,
               predicted_2x2_block_bytes=block,
               predicted_4x1_bytes=peak(4, 1, False),
               plan=f"{plan.data}x{plan.feature}"
               + (":block" if plan.block_shard_bins else ""),
               reason=repr(plan.reason),
               tree_learner_data_plan=f"{as_data.data}x{as_data.feature}"
               + (":block" if as_data.block_shard_bins else ""),
               measured_peak_bytes=measured,
               route_copy=g.route_bins is not None,
               **{k: v for k, v in res.items() if k in (
                   "ms_per_tree", "loop", "route_rows_block_launches",
                   "route_rows_launches", "hist_local_launches",
                   "mem_predicted_peak_bytes", "mem_ratio",
                   "mem_census_equal") or k.startswith("heldout_ndcg")})
    phase("planner_rung", **out)
    if (plan.data, plan.feature, plan.block_shard_bins) != (2, 2, True) \
            or g.route_bins is not None:
        fail(f"planner rung: the walk chose {out['plan']} ({plan.reason})")
    if measured > budget:
        fail(f"planner rung: measured peak {measured} over hbm_budget "
             f"{budget}")
    if not res["route_rows_block_launches"]:
        fail("planner rung: the block route was launched no time")
    del bst, g
    torch.cuda.empty_cache()
    return out


def refused_walk(params, ds) -> dict:
    """Phase 23e: a budget below every rung of the walk (resident, every
    streamed block size, the meshes over 4 slots): ``MeshPlanError`` is
    raised before the Dataset's matrix reaches the card, so
    ``memory_allocated`` is the same before and after the call."""
    import torch
    from lightgbm_tpu_torch import train
    from lightgbm_tpu_torch.parallel.mesh import MeshPlanError
    ds.bins = None
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    msg = None
    try:
        train(dict(params, hbm_budget=1_000_000, mesh_devices=MESH_SLOTS),
              ds, num_boost_round=1, verbose_eval=False)
    except MeshPlanError as e:
        msg = str(e)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    out = dict(raised=msg is not None, allocated_before=before,
               allocated_after=after, message=repr((msg or "")[:160]))
    phase("refused_walk", **out)
    if msg is None or after != before or ds.bins is not None:
        fail(f"refused walk: raised={msg is not None}, memory_allocated "
             f"{before} -> {after}")
    return out


def partition_ab(params, ds):
    """Phase 3c: the Higgs path's ms per tree with the plain partition and
    with the kernel, in turns on one dataset (phase 3's; scatter, compact,
    compact, scatter; 2 trees each): the host's noise between runs is
    larger than the difference, so only turns within one process
    compare."""
    import torch
    from lightgbm_tpu_torch import train
    ms = {"scatter": [], "compact": []}
    for impl in ("scatter", "compact", "compact", "scatter"):
        bst = train(dict(params, partition_impl=impl), ds, num_boost_round=1,
                    verbose_eval=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            bst.update()
        torch.cuda.synchronize()
        ms[impl].append((time.perf_counter() - t0) * 1e3 / 2)
    phase("partition_ab", trees_per_turn=2, **{
        f"{k}_ms_per_tree": ",".join(f"{v:.2f}" for v in vals)
        for k, vals in ms.items()})


def card_vs_cpu(name, params, x, y, x_te, y_te, fields, max_pred_diff,
                max_auc_diff):
    """The card against the CPU on the same subset, 3 rounds: the first
    tree's ``fields`` identical (its sums are exact: gradients +-0.5 and
    hessians 0.25 at score 0), predictions and AUC within the limits."""
    from lightgbm_tpu_torch import Dataset, train
    out = {}
    for device in ("cpu", "cuda"):
        p = dict(params, device=device)
        b = train(p, Dataset(x, y, params=p), num_boost_round=3,
                  verbose_eval=False)
        first = b.inner.models[0]
        out[device] = ([getattr(first, f).copy() for f in fields],
                       b.predict(x_te), b.predict(x_te, raw_score=True))
    (tc, pc, rc), (tg, pg, rg) = out["cpu"], out["cuda"]
    same = all(np.array_equal(a, b) for a, b in zip(tc, tg))
    pdiff = float(np.abs(pc - pg).max())
    adiff = abs(auc(pc, y_te) - auc(pg, y_te))
    rdiff = float(np.abs(rc - rg).max())
    phase(name, rows=len(y), rounds=3, first_tree_identical=same,
          max_pred_diff=f"{pdiff:.3e}", max_raw_diff=f"{rdiff:.3e}",
          auc_diff=f"{adiff:.3e}")
    if not same:
        fail(f"{name}: first tree differs between the card and the CPU")
    if pdiff > max_pred_diff or adiff > max_auc_diff:
        fail(f"{name}: card vs CPU: prediction diff {pdiff} (limit "
             f"{max_pred_diff}), AUC diff {adiff} (limit {max_auc_diff})")


def grower_card_vs_cpu(params, x, y, name="expo_grower_card_vs_cpu"):
    """The grower of the Expo-shaped path under integer-valued gradients
    and hessians, whose sums are exact in any order: the card's tree
    (histogram, partition and cat_group kernels, leaf-ordered mode) equals
    the CPU's field by field, and so do the row -> leaf maps."""
    import torch
    from lightgbm_tpu_torch import Dataset
    from lightgbm_tpu_torch.grower import FeatureMeta, GrowerConfig, grow_tree
    rng = np.random.default_rng(SEED + 4)
    td = Dataset(x, y, params=dict(params, device="cpu")).construct(
        ).constructed
    fm = td.feature_meta()
    n = len(y)
    g = (np.where(y > 0, -3, 2) + rng.integers(-2, 3, n)).astype(np.float32)
    h = rng.integers(1, 4, n).astype(np.float32)
    cfg = GrowerConfig(
        num_leaves=params["num_leaves"], min_data_in_leaf=1,
        min_sum_hessian_in_leaf=10.0, max_bin=td.max_num_bin(),
        has_missing=bool((fm["missing_type"] != 0).any()),
        has_categorical=True, partition_impl="compact", ordered_bins="on")
    out = {}
    for device in ("cpu", "cuda"):
        put = lambda a: torch.from_numpy(a).to(device)
        meta = FeatureMeta(put(fm["num_bin"]), put(fm["missing_type"]),
                           put(fm["default_bin"]), put(fm["is_categorical"]))
        tree, row_leaf = grow_tree(
            put(td.binned), put(g), put(h), put(np.ones(n, np.float32)),
            meta, torch.ones(len(fm["num_bin"]), dtype=torch.bool,
                             device=device), cfg)
        out[device] = ({k: v.cpu().numpy() for k, v in tree._asdict().items()
                        if isinstance(v, torch.Tensor)},
                       row_leaf.cpu().numpy(), tree.num_leaves)
    (ac, rc, lc), (ag, rg, lg) = out["cpu"], out["cuda"]
    bad = [k for k in ac if not np.array_equal(ac[k], ag[k])]
    phase(name, rows=n, leaves=lg,
          categorical_nodes=int(ag["is_cat"].sum()),
          identical=not bad and lc == lg and np.array_equal(rc, rg))
    if bad or lc != lg or not np.array_equal(rc, rg):
        fail(f"{name}: grower under integer weights: card != CPU in "
             f"{bad or 'row_leaf'}")


def gspmd_trees_identical(ds, y, graph: bool = True,
                          shapes=((4, 1), (2, 2), (1, 3)),
                          block: bool = False):
    """Phase 6c: one tree of the Higgs path under integer-valued gradients
    and hessians, whose sums are exact in any order, grown on the 4x1, 2x2
    and 1x3 meshes (1x3: uneven slices of 10, 9 and 9 columns) with the
    shard-local kernel, by the data-parallel eager loop and (``graph``)
    its graph loop, and by the serial grower with the gather kernel:
    identical field by field, row -> leaf maps too.  Phase 9e runs the
    same on the Covertype-shaped task's bundled columns over ``shapes``
    1x4, ``tree_learner=feature``'s mesh.  The graph loop's
    three trees after its capture run under
    ``torch.cuda.set_sync_debug_mode("error")``, so any read to the host
    but the counted stop reads raises, and are timed beside two eager
    trees (in turns: eager, graph x 3, eager).  Phase 23d runs it with
    ``block`` (``shard_axes=batch,feature``: each slot holds only its
    column slice, routing reads the owner's through ``route_rows_block``)
    over 2x2, and profiles one more graph tree: the block route's
    launches on the card, one a step, and its device ms a tree.  Returns
    the last shape's numbers."""
    import torch
    from lightgbm_tpu_torch.grower import FeatureMeta, GrowerConfig, grow_tree
    from lightgbm_tpu_torch.parallel.gspmd import GspmdGrower
    from lightgbm_tpu_torch.parallel.mesh import make_named_mesh, mesh_slots
    dev = ds.bins.device
    td = ds.constructed
    fm = td.feature_meta()
    n = len(y)
    rng = np.random.default_rng(SEED + 5)
    put = lambda a: torch.from_numpy(a).to(dev)
    g = put((np.where(y > 0, -3, 2) + rng.integers(-2, 3, n)).astype(
        np.float32))
    h = put(rng.integers(1, 4, n).astype(np.float32))
    c = torch.ones(n, dtype=torch.float32, device=dev)
    meta = FeatureMeta(put(fm["num_bin"]), put(fm["missing_type"]),
                       put(fm["default_bin"]), put(fm["is_categorical"]),
                       *(put(fm[k]) if k in fm else None
                         for k in ("col", "offset")))
    n_logical = len(fm["num_bin"])
    fv = torch.ones(n_logical, dtype=torch.bool, device=dev)
    cfg = GrowerConfig(num_leaves=255, min_data_in_leaf=1,
                       min_sum_hessian_in_leaf=10.0, max_bin=td.max_num_bin(),
                       has_missing=bool((fm["missing_type"] != 0).any()))

    def host(tree, row_leaf):
        return ({k: v.cpu().numpy() for k, v in tree._asdict().items()
                 if isinstance(v, torch.Tensor)}, row_leaf.cpu().numpy(),
                tree.num_leaves)

    want = host(*grow_tree(ds.bins, g, h, c, meta, fv, cfg))
    slots = mesh_slots(MESH_SLOTS, dev)
    max_reads = -(-(cfg.num_leaves - 1) // 32) + 1
    for shape in shapes:
        mesh = make_named_mesh(*shape, slots)
        growers = {loop: GspmdGrower(cfg, mesh, ds.bins,
                                     n_logical=n_logical, block_shard=block)
                   for loop in (("eager", "graph") if graph else ("eager",))}
        stats = {loop: {} for loop in growers}
        ms = {loop: [] for loop in growers}
        got = []

        def grow(loop, sync_check=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if sync_check:
                torch.cuda.set_sync_debug_mode("error")
            try:
                res = growers[loop](g, h, c, meta, fv, stats[loop], loop)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            ms[loop].append((time.perf_counter() - t0) * 1e3)
            got.append((loop, host(*res)))

        turns = ["eager"] + (["graph"] * 4 if graph else []) + ["eager"]
        for k, loop in enumerate(turns):
            # the graph loop's first tree captures the step
            grow(loop, sync_check=loop == "graph" and turns[k - 1] == loop)
        bad = [(loop, k) for loop, other in got for k in want[0]
               if not np.array_equal(want[0][k], other[0][k])]
        bad += [(loop, "num_leaves/row_leaf") for loop, other in got
                if want[2] != other[2] or not np.array_equal(want[1],
                                                             other[1])]
        out = dict(mesh=f"{shape[0]}x{shape[1]}", rows=n,
                   bundled="col" in fm,
                   slice_cols=":".join(str(len(col)) for col in
                                       growers["eager"].cols),
                   cards=len(set(sum(mesh.devices, []))), leaves=want[2],
                   identical=not bad, trees=",".join(l for l, _ in got))
        for loop in growers:
            trees = len(ms[loop])
            out[f"{loop}_host_reads_per_tree"] = (
                f"{stats[loop]['host_syncs'] / trees:.3f}")
            out[f"{loop}_ms_per_tree"] = ",".join(
                f"{v:.2f}" for v in ms[loop][1 if loop == "graph" else 0:])
        if graph:
            out["sync_checked_replay_trees"] = 3
            out["graph_replays"] = stats["graph"]["graph_replays"]
        phase("gspmd_tree_vs_serial", **out)
        if bad:
            fail(f"integer-gradient tree on the {shape} mesh != serial: "
                 f"{bad[:5]}")
        for loop in growers:
            if stats[loop]["host_syncs"] > max_reads * len(ms[loop]):
                fail(f"{shape} {loop} loop: {stats[loop]['host_syncs']} "
                     f"host reads in {len(ms[loop])} trees")
        if graph and growers["graph"].graph is None:
            fail(f"{shape}: the graph loop captured no step")
        if block:
            # one more graph tree under the profiler: the block route runs
            # once a step taken, and the column-major route never
            st = stats["graph"]
            steps0 = st["steps"]
            wall, per, all_ms, _, _, ran = device_ms(
                lambda: growers["graph"](g, h, c, meta, fv, st, "graph"),
                ("lgbt_block_route",))
            steps = st["steps"] - steps0
            out.update(block=True, route_copy=growers["graph"].route_bins
                       is not None, profiled_steps=steps,
                       block_route_launches_per_tree=ran["lgbt_block_route"],
                       route_rows_launches_per_tree=ran["lgbt_route_rows"],
                       block_route_device_ms_per_tree=(
                           f"{per['lgbt_block_route']:.3f}"),
                       device_ms_per_tree=f"{all_ms:.3f}",
                       profiled_ms_per_tree=f"{wall * 1e3:.2f}")
            if (ran["lgbt_block_route"] != steps or ran["lgbt_route_rows"]
                    or out["route_copy"]):
                fail(f"{shape} block-sharded: {ran['lgbt_block_route']} "
                     f"block route launches for {steps} steps, "
                     f"{ran['lgbt_route_rows']} column-major ones")
            phase("block_route_tree", **{k: out[k] for k in (
                "mesh", "route_copy", "profiled_steps",
                "block_route_launches_per_tree",
                "route_rows_launches_per_tree",
                "block_route_device_ms_per_tree", "device_ms_per_tree",
                "profiled_ms_per_tree")})
        del growers
    return out


def flat_vs_fused(params, x, y, x_te):
    """Phase 6c: ``gspmd_hist=flat`` against ``fused`` on one subset, 3
    rounds: predictions within rtol 2e-5 (tests/test_gspmd.py:276)."""
    from lightgbm_tpu_torch import Dataset, train
    pred = {}
    for hist in ("flat", "fused"):
        p = dict(params, gspmd_hist=hist)
        b = train(p, Dataset(x, y, params=p), num_boost_round=3,
                  verbose_eval=False)
        if b.inner.gspmd_hist != hist:
            fail(f"flat_vs_fused: {hist} resolved to {b.inner.gspmd_hist}")
        pred[hist] = b.predict(x_te)
    rel = float((np.abs(pred["flat"] - pred["fused"])
                 / np.abs(pred["fused"])).max())
    phase("gspmd_flat_vs_fused", rows=len(y), rounds=3,
          max_rel_pred_diff=f"{rel:.3e}")
    if not np.allclose(pred["flat"], pred["fused"], rtol=2e-5, atol=0):
        fail(f"gspmd flat vs fused predictions differ by {rel} (rtol 2e-5)")


def query_sizes(nq: int, total: int, longest: int,
                rng: np.random.Generator) -> np.ndarray:
    """``nq`` query lengths summing to ``total``, the largest ``longest``:
    a lognormal body (most queries near the mean, a long tail) rounded and
    clipped to [1, longest], then one document added to (or taken from)
    each of as many random queries as the sum is off, until it is exact."""
    mean = total / nq
    sizes = rng.lognormal(np.log(mean) - 0.5 * 0.8 ** 2, 0.8, nq)
    sizes = np.clip(np.rint(sizes), 1, longest).astype(np.int64)
    sizes[int(np.argmax(sizes))] = longest
    top = int(np.argmax(sizes))
    while sizes.sum() != total:
        step = 1 if sizes.sum() < total else -1
        can = np.nonzero((sizes + step >= 1) & (sizes + step < longest))[0]
        can = can[can != top]
        k = min(abs(int(total - sizes.sum())), len(can))
        sizes[rng.choice(can, k, replace=False)] += step
    return sizes


def mslr_like(sizes: np.ndarray, rng: np.random.Generator):
    """MS-LTR-shaped ranking data for queries of ``sizes``: 137 float32
    columns as MSLR-WEB30K's ranker features are (70 dense continuous
    scores, 40 integer counts, 27 mostly-zero), and labels 0-4 in about
    MSLR's shares (51 / 33 / 12 / 3 / 1 %) from a per-query latent
    relevance plus a rule on ten of the columns plus noise, cut at the
    shares' quantiles."""
    n = int(sizes.sum())
    x = np.empty((n, 137), np.float32)
    x[:, :70] = rng.standard_normal((n, 70), dtype=np.float32)
    x[:, 70:110] = rng.poisson(3.0, (n, 40)).astype(np.float32)
    sparse = rng.lognormal(0.0, 1.0, (n, 27)).astype(np.float32)
    sparse[rng.random((n, 27), dtype=np.float32) < 0.9] = 0.0
    x[:, 110:] = sparse
    qid = np.repeat(np.arange(len(sizes)), sizes)
    latent = rng.normal(0.0, 0.7, len(sizes)).astype(np.float32)[qid]
    z = (0.9 * x[:, 0] + 0.6 * x[:, 3] - 0.5 * x[:, 7] * x[:, 8]
         + 0.4 * np.tanh(x[:, 11]) + 0.15 * x[:, 70] - 0.1 * x[:, 75]
         + 0.3 * np.log1p(x[:, 110]) + 0.2 * (x[:, 20] > 1.0) + latent
         + rng.standard_normal(n, dtype=np.float32) * 0.8)
    cuts = np.quantile(z, [0.51, 0.84, 0.96, 0.99])
    y = np.searchsorted(cuts, z).astype(np.float32)
    return x, y


def covtype_like(n: int, rng: np.random.Generator):
    """Covertype-shaped multiclass data: 10 continuous columns (elevation,
    aspect, slope, four distances, three hillshades), 4 wilderness-area and
    40 soil-type one-hot columns, and 7 cover types in Covertype's shares,
    cut from an elevation-led score (lowest: Cottonwood, Ponderosa, then
    Douglas-fir, Aspen, Lodgepole, Spruce/Fir, highest Krummholz)."""
    area = rng.choice(4, n, p=[0.45, 0.05, 0.44, 0.06])
    soil = (rng.choice(40, n, p=np.r_[np.full(10, 0.01),
                                      np.full(10, 0.05),
                                      np.full(20, 0.02)])
            + area * 3) % 40
    elev = (2950 + np.asarray([120, 60, -90, -420])[area]
            + rng.normal(0, 40, 40)[soil] + rng.normal(0, 230, n))
    aspect = rng.uniform(0, 360, n)
    slope = np.clip(rng.gamma(3.0, 4.7, n), 0, 66)
    hyd_h = rng.gamma(1.7, 160, n)
    hyd_v = rng.normal(46, 58, n)
    road = rng.gamma(1.6, 1450, n)
    fire = rng.gamma(1.7, 1170, n)
    hill = np.clip(np.stack([
        212 + 27 * np.cos(np.radians(aspect - 60)) - slope,
        223 + 20 * np.sin(np.radians(aspect)) - 0.3 * slope,
        142 - 38 * np.cos(np.radians(aspect - 60)) + 0.5 * slope], 1)
        + rng.normal(0, 12, (n, 3)), 0, 254)
    x = np.zeros((n, 54), np.float32)
    x[:, :10] = np.column_stack([elev, aspect, slope, hyd_h, hyd_v, road,
                                 hill, fire])
    x[np.arange(n), 10 + area] = 1.0
    x[np.arange(n), 14 + soil] = 1.0
    score = (elev + 0.05 * road - 0.03 * fire - 1.5 * slope
             + rng.normal(0, 25, 40)[soil] + rng.normal(0, 60, n))
    by_height = [3, 2, 5, 4, 1, 0, 6]        # cover types, lowest first
    shares = np.asarray(COVTYPE_SHARES)[by_height]
    cuts = np.quantile(score, np.cumsum(shares)[:-1])
    y = np.asarray(by_height)[np.searchsorted(cuts, score)]
    return x, y.astype(np.float32)


def ndcg_at(pred: np.ndarray, y: np.ndarray, sizes, eval_at) -> list:
    """The port's NDCG@k of ``pred`` on queries ``sizes``."""
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.data.metadata import Metadata
    from lightgbm_tpu_torch.metrics import NDCGMetric
    m = NDCGMetric(config_from_params({"ndcg_eval_at": list(eval_at),
                                       "device": "cpu"}))
    md = Metadata(len(y))
    md.set_label(y)
    md.set_query(sizes)
    m.init(md, len(y))
    return m.eval(np.asarray(pred, np.float64)[None], None)


def lambdarank_pairs(y: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Each query's pairs of unequal labels: (n^2 - sum of squared label
    counts) / 2."""
    sizes = np.diff(bounds)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    counts = np.zeros((len(sizes), int(y.max()) + 1), np.int64)
    np.add.at(counts, (qid, y.astype(np.int64)), 1)
    return (sizes.astype(np.int64) ** 2 - (counts ** 2).sum(1)) // 2


def lambdarank_bound_ms(y, bounds, degenerate, weighted: bool):
    """Least time of one gradient call: each row's score, label, g, h (and
    weight) and each query's bound and inverse max DCG over the memory
    rate, or each pair's exp and reciprocals (three; two in a degenerate
    query, which divides by no score gap) over the special-function rate,
    counted from these queries' labels.  Returns (ms, "bytes" or
    "operations")."""
    n, q = len(y), len(bounds) - 1
    nbytes = n * (16 + 4 * weighted) + 8 * q + 4
    pairs = lambdarank_pairs(y, bounds)
    ops = int((pairs * np.where(degenerate, 2, 3)).sum())
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_SFU_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def check_lambdarank(dev, rng, mslr_x_y=None):
    """Phase 2h: the lambdarank kernel against its plain version on the
    card, float32.  Per document |dg| <= 1e-5 * (its pairs' sum of |lam|)
    + 1e-7, and the same for h with |hes|, over: queries of 1, 2, 31, 120
    and 1,251 documents and one of 10,000 (past the kernel's shared-memory
    staging), all-equal scores (degenerate), all-zero labels (inverse max
    DCG 0), tied scores, with and without weights; and the whole MS-LTR
    training set at random scores.  Times of the whole set: single, b2b,
    device, the plain version's, and the bound."""
    import torch
    from lightgbm_tpu_torch.ops.lambdarank import (STAGE_MAX,
                                                   lambdarank_grad,
                                                   lambdarank_grad_plain,
                                                   lambdarank_tables)

    def case(sizes, y, s, w=None):
        bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        inv, gains, disc = lambdarank_tables(y, bounds, None, 20)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        args = (put(s.astype(np.float32)), put(y.astype(np.int32)),
                put(bounds), put(inv), put(gains), put(disc), 1.0)
        wt = None if w is None else put(w.astype(np.float32))
        return args, wt, int(np.max(sizes)), bounds

    def held(label, args, wt, max_len):
        g, h = lambdarank_grad(*args, max_len=max_len, weight=wt)
        pg, ph, la, ha = lambdarank_grad_plain(*args, weight=wt,
                                               abs_sums=True)
        torch.cuda.synchronize()
        wscale = 1.0 if wt is None else wt.abs()
        eg, eh = (g - pg).abs(), (h - ph).abs()
        ok = bool(((eg <= 1e-5 * la * wscale + 1e-7).all()
                   & (eh <= 1e-5 * ha * wscale + 1e-7).all()).item())
        err = float(torch.maximum(eg.max(), eh.max()))
        if not ok or not torch.isfinite(g).all() or not torch.isfinite(h).all():
            fail(f"lambdarank kernel vs plain ({label}): beyond |d| <= 1e-5 "
                 f"* sum|lam| + 1e-7, max abs err {err}")
        return err, g

    sizes = np.asarray([1, 2, 31, 120, MSLR_LONGEST, 10_000, 50, 40, 200])
    n = int(sizes.sum())
    y = rng.integers(0, 5, n).astype(np.float32)
    s = rng.standard_normal(n).astype(np.float32)
    b = np.concatenate([[0], np.cumsum(sizes)])
    s[b[6]:b[7]] = 0.375                       # all-equal scores
    y[b[7]:b[8]] = 0                           # all-zero labels
    s[b[8]:b[9]] = np.round(s[b[8]:b[9]] * 2) / 2   # tied scores
    w = rng.uniform(0.5, 2.0, n)
    if sizes.max() <= STAGE_MAX:
        fail("lambdarank: no case past the shared-memory staging")
    errs = {}
    for label, wt_host in (("cases", None), ("cases_weighted", w)):
        args, wt, max_len, bounds = case(sizes, y, s, wt_host)
        errs[label], g = held(label, args, wt, max_len)
        gq = g.cpu().numpy()
        if gq[0] != 0 or gq[b[7]:b[8]].any():
            fail("lambdarank: a lone or all-zero-label document has a "
                 "gradient")
    x_, y_all, sizes_all = mslr_x_y
    s_all = rng.standard_normal(len(y_all)).astype(np.float32)
    args, wt, max_len, bounds = case(sizes_all, y_all, s_all)
    errs["mslr_train"], _ = held("mslr_train", args, None, max_len)
    kernel = lambda: lambdarank_grad(*args, max_len=max_len)
    dev_ms, _ = profiled_ms(kernel, calls=20)
    out = dict(ms=cuda_ms(kernel), ms_many=cuda_ms_many(kernel, calls=50),
               device_ms=dev_ms,
               plain_ms=cuda_ms(lambda: lambdarank_grad_plain(*args),
                                reps=1, warmup=1),
               max_abs_err=max(errs.values()))
    # random scores: no query of two or more documents is degenerate
    out["bound_ms"], out["bound_by"] = lambdarank_bound_ms(
        y_all, bounds, sizes_all < 2, False)
    phase("lambdarank_vs_plain", cases=":".join(map(str, sizes)),
          stage_max=STAGE_MAX, tolerance="1e-5*sum|lam|+1e-7",
          mslr_rows=len(y_all), mslr_queries=len(sizes_all),
          **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()},
          **{k: (f"{v:.4f}" if isinstance(v, float) else v)
             for k, v in out.items()})
    return out


MSLR_EVAL_AT = (1, 3, 5, 10)


def mslr_quality(sizes_te):
    """Phase 8's held-out check: NDCG@1/3/5/10 of the model above those
    of its first round."""
    def check(bst, pred, x_te, y_te) -> dict:
        first = ndcg_at(bst.predict(x_te, num_iteration=1), y_te, sizes_te,
                        MSLR_EVAL_AT)
        last = ndcg_at(pred, y_te, sizes_te, MSLR_EVAL_AT)
        if not all(b > a for a, b in zip(first, last)):
            fail(f"held-out NDCG@{MSLR_EVAL_AT} {last} not above the first "
                 f"round's {first}")
        return {**{f"heldout_ndcg@{k}": f"{v:.6f}"
                   for k, v in zip(MSLR_EVAL_AT, last)},
                **{f"round1_ndcg@{k}": f"{v:.6f}"
                   for k, v in zip(MSLR_EVAL_AT, first)}}
    return check


def multi_metrics(prob: np.ndarray, y: np.ndarray):
    """multi_logloss and multi_error of ``[N, K]`` probabilities."""
    p = np.clip(prob[np.arange(len(y)), y.astype(np.int64)], 1e-15, None)
    return (float(-np.log(p).mean()),
            float((prob.argmax(1) != y.astype(np.int64)).mean()))


def covtype_quality(bst, pred, x_te, y_te) -> dict:
    """Phase 9's held-out check: multi_logloss below the first round's
    and below log(7), the error below 0.5."""
    first = multi_metrics(bst.predict(x_te, num_iteration=1), y_te)
    last = multi_metrics(pred, y_te)
    if not (last[0] <= first[0] < np.log(7.0) and last[1] < 0.5):
        fail(f"held-out multi_logloss/multi_error {last} (first round "
             f"{first}) are not those of a learned model")
    return {"heldout_multi_logloss": f"{last[0]:.6f}",
            "heldout_multi_error": f"{last[1]:.6f}",
            "round1_multi_logloss": f"{first[0]:.8f}",
            "round1_multi_error": f"{first[1]:.6f}"}


TREE_STRUCTURE = ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child", "leaf_count")
# float32's unit roundoff: a sum of n float32 values in any order is off
# by at most (n - 1) of it times the sum of their magnitudes
F32_U = 2.0 ** -24


def first_split_difference(a, b):
    """The first split (in the order the grower made them) at which trees
    ``a`` and ``b`` differ in ``TREE_STRUCTURE``, or None; the split
    records of a leaf-wise grower up to there are the same splits of the
    same rows."""
    for k in range(min(a.num_leaves, b.num_leaves) - 1):
        if any(getattr(a, f)[k] != getattr(b, f)[k]
               for f in ("split_feature", "threshold", "decision_type")):
            return k
    if a.num_leaves != b.num_leaves:
        return min(a.num_leaves, b.num_leaves) - 1
    if not all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in TREE_STRUCTURE):
        return 0
    return None


def node_rows(tree, bins, col_of, k):
    """The rows of uint8 ``bins`` that reach node ``k`` of ``tree``: every
    row routed through the nodes before k in their order (a node is made
    after its parent), ``bin <= threshold_bin`` going left (these tasks
    have no missing values)."""
    cur = np.zeros(len(bins), np.int64)
    for nd in range(k):
        sel = np.nonzero(cur == nd)[0]
        left = (bins[sel, col_of[int(tree.split_feature[nd])]]
                <= tree.threshold_bin[nd])
        cur[sel] = np.where(left, tree.left_child[nd], tree.right_child[nd])
    return cur == k


def split_gain64(g, h, rows, left):
    """A split's gain sum(G^2 / H) over its children less its leaf's, in
    float64 (lambda 0); its sensitivity to the sums (each term G^2 / H
    moves by 2 |G| / H dG + G^2 / H^2 dH, for dG and dH the sums of |g|
    and |h| times a relative error); its children's hessian sums and their
    sums of |h|."""
    gain = scale = 0.0
    hs, habs = [], []
    for sign, m in ((1.0, rows & left), (1.0, rows & ~left), (-1.0, rows)):
        gm, hm = g[m], h[m]
        G, H = gm.sum(), hm.sum()
        gain += sign * G * G / H
        scale += (2.0 * abs(G) / H * np.abs(gm).sum()
                  + G * G / (H * H) * np.abs(hm).sum())
        hs.append(H)
        habs.append(np.abs(hm).sum())
    return gain, scale, hs[:2], habs[:2]


def near_tie(tc, tg, k, bins, col_of, g, h, min_hess):
    """Whether the first difference of trees ``tc`` and ``tg`` (the CPU's
    and the card's, identical before split ``k``) is a choice that the
    float32 sums' rounding can decide: both trees' split ``k`` evaluated
    in float64 on the same gradients ``g``, ``h`` (their leaves' rows
    checked against the trees' own counts), their gains closer than the
    worst float32 error of the sums behind them, a histogram bin's rows
    and the split scan's 256 bins added in any order ((n + 256) x
    ``F32_U`` of the sums of magnitudes, n the larger leaf's rows), or a
    child's hessian sum that close to ``min_hess``.  A tree that stops
    first has a split of gain 0 there.  Returns (near, the float64 gap
    over its allowance)."""
    evals, n = [], 0
    for t in (tc, tg):
        if k >= t.num_leaves - 1:
            evals.append((0.0, 0.0, [], []))
            continue
        rows = node_rows(t, bins, col_of, k)
        if int(rows.sum()) != int(t.internal_count[k]):
            fail(f"near_tie: {int(rows.sum())} rows reach node {k}, the "
                 f"tree counts {int(t.internal_count[k])}")
        n = max(n, int(rows.sum()))
        left = (bins[:, col_of[int(t.split_feature[k])]]
                <= t.threshold_bin[k])
        evals.append(split_gain64(g, h, rows, left))
    (ga, sa, ha, aa), (gb, sb, hb, ab) = evals
    u = (n + 256) * F32_U
    gap = abs(ga - gb) / max(u * max(sa, sb), 1e-300)
    on_bound = any(abs(x - min_hess) <= u * a
                   for x, a in zip(ha + hb, aa + ab))
    return gap <= 1.0 or on_bound, gap


def path_rows(tree, bins, col_of, k) -> list:
    """The rows of ``bins`` at each node on the path from the root to node
    ``k`` of ``tree``, root first: a child's rows are those of its parent
    that the parent's split sends its way (``bin <= threshold_bin`` left;
    these tasks have no missing values)."""
    parent = {}
    for nd in range(k):
        for child, left in ((tree.left_child[nd], True),
                            (tree.right_child[nd], False)):
            if child >= 0:
                parent[int(child)] = (nd, left)
    path = [k]
    while path[-1] in parent:
        path.append(parent[path[-1]][0])
    rows = np.ones(len(bins), bool)
    out = [rows]
    for child in reversed(path[:-1]):
        nd, left = parent[child]
        goes = (bins[:, col_of[int(tree.split_feature[nd])]]
                <= tree.threshold_bin[nd])
        rows = rows & (goes if left else ~goes)
        out.append(rows)
    return out


def chain_tie(ta, tb, k, bins, col_of, g, h, min_hess):
    """Whether the first difference of trees ``ta`` and ``tb`` (identical
    before split ``k``, grown on the same rows in two layouts) is a choice
    that float32 rounding can decide, with the rounding bounded along the
    histogram subtraction chain behind each choice.  The grower measures
    the smaller child and takes the larger as its parent less it, so a
    histogram at node k carries the rounding of every ancestor's measured
    sums: at most ``F32_U * (n_a + 512) * S_a`` for each node ``a`` on the
    path from the root, n_a its rows and S_a their sum of |g| (or |h|),
    512 for the split scan's prefix sums over 256 bins and a bundle's
    default bin rebuilt from its slots.  Each layer is counted twice:
    once in the bins, once in the leaf sum that a rebuilt default bin
    subtracts its slots from.  A split's float64 gain then moves by at
    most the sum over its three terms of 2 |G| / H dG + G^2 / H^2 dH.  A
    tree that stops first has a split of gain 0 there.  Returns (each
    tree's float64 gain at k, their gap over the sum of both allowances,
    whether a child's hessian sum lies within dH of ``min_hess``)."""
    gains, errs, on_bound = [], [], False
    for t in (ta, tb):
        if k >= t.num_leaves - 1:
            gains.append(0.0)
            errs.append(0.0)
            continue
        path = path_rows(t, bins, col_of, k)
        rows = path[-1]
        if int(rows.sum()) != int(t.internal_count[k]):
            fail(f"chain_tie: {int(rows.sum())} rows reach node {k}, the "
                 f"tree counts {int(t.internal_count[k])}")
        dg = dh = 0.0
        for r in path:
            m = float(r.sum()) + 512.0
            dg += m * np.abs(g[r]).sum()
            dh += m * np.abs(h[r]).sum()
        dg, dh = 2.0 * F32_U * dg, 2.0 * F32_U * dh
        left = (bins[:, col_of[int(t.split_feature[k])]]
                <= t.threshold_bin[k])
        gain = err = 0.0
        for sign, m in ((1.0, rows & left), (1.0, rows & ~left),
                        (-1.0, rows)):
            G, H = g[m].sum(), h[m].sum()
            gain += sign * G * G / H
            err += 2.0 * abs(G) / H * dg + G * G / (H * H) * dh
            if sign > 0 and abs(H - min_hess) <= dh:
                on_bound = True
        gains.append(gain)
        errs.append(err)
    gap = abs(gains[0] - gains[1]) / max(errs[0] + errs[1], 1e-300)
    return gains, gap, on_bound


def logical_bins(td) -> np.ndarray:
    """A constructed dataset's bins by logical feature ``[N, E]``: its
    columns, with each bundle's slots decoded into its features' bins
    (``ops/route.py:decode_bundle_bin``), so that column ``e`` is feature
    ``used_features[e]``'s."""
    fm = td.feature_meta()
    if "col" not in fm:
        return td.binned
    out = np.empty((td.num_data, len(fm["col"])), np.uint8)
    for e, (c, off, nb, db) in enumerate(zip(fm["col"], fm["offset"],
                                             fm["num_bin"],
                                             fm["default_bin"])):
        raw = td.binned[:, c].astype(np.int32)
        if off < 0:
            out[:, e] = raw
            continue
        local = raw - off
        out[:, e] = np.where((local >= 0) & (local < nb - 1),
                             local + (local >= db), db)
    return out


def k1_rows(tree) -> int:
    """Rows the serial grower's histogram kernel reads for a tree: the
    root's, then the smaller child's of every split."""
    if tree.num_leaves <= 1:
        return int(tree.leaf_count[0])

    def rows(child):
        return int(tree.internal_count[child] if child >= 0
                   else tree.leaf_count[~child])
    return int(tree.internal_count[0]) + sum(
        min(rows(tree.left_child[k]), rows(tree.right_child[k]))
        for k in range(tree.num_leaves - 1))


def k1_bytes_per_tree(bst) -> int:
    """K1's bytes a tree of a training, as the kernel reads them: each
    measured row's storage bytes (the packed matrix's columns, or the
    bins'), its ``order`` entry and its three float32 weights."""
    inner = bst.inner
    width = (inner.bins if inner.packed is None
             else inner.packed.matrix).shape[1]
    trees = [t for t in inner.models if t.num_leaves > 1]
    rows = sum(k1_rows(t) for t in trees) / max(len(trees), 1)
    return int(rows * (width + 4 + 12))


def first_round_vs(a, b, first_trees):
    """Two trainings' first ``first_trees`` trees on the same rows (``a``
    and ``b`` their boosters) under the built-in objective: how many are
    identical in structure, and where each other first differs (on
    ``a``'s gradients at score 0).  A bundled or packed layout adds the
    same rows' values in another order (a bundle's default bin is its
    leaf's sum less its slots), so a split whose gain differs from
    another's by about the float32 sums' rounding may go either way.  Each
    difference is recorded as tree:split:its float64 gap over
    :func:`near_tie`'s one-sum allowance:its gap over :func:`chain_tie`'s
    subtraction-chain allowance:the layout whose choice has the higher
    float64 gain (a, b or = when equal), and held: a gap beyond the chain
    allowance, off the hessian bound, fails.  :func:`integer_round_identical`
    holds the layouts to identical trees where every sum is exact."""
    import torch
    ia, ib = a.inner, b.inner
    bins = logical_bins(ia.train_set)
    col_of = {f: i for i, f in enumerate(ia.train_set.used_features)}
    g, h = (t.double().cpu().numpy() for t in ia.objective.get_gradients(
        torch.zeros_like(ia.scores)))
    ma = [m for m in ia.models if m.num_leaves > 1][:first_trees]
    mb = [m for m in ib.models if m.num_leaves > 1][:first_trees]
    identical, diffs, bad = 0, [], []
    better = {"a": 0, "b": 0, "=": 0}
    min_hess = ia.config.min_sum_hessian_in_leaf
    for i, (ta, tb) in enumerate(zip(ma, mb)):
        k = first_split_difference(ta, tb)
        if k is None:
            identical += 1
            continue
        _, rel = near_tie(ta, tb, k, bins, col_of, g[i], h[i], min_hess)
        (ga, gb), chain, on_bound = chain_tie(ta, tb, k, bins, col_of, g[i],
                                              h[i], min_hess)
        won = "a" if ga > gb else "b" if gb > ga else "="
        better[won] += 1
        diffs.append(f"{i}:{k}:{rel:.2e}:{chain:.2e}:{won}")
        if chain > 1.0 and not on_bound:
            bad.append(diffs[-1])
    if bad:
        fail(f"first round in two layouts: trees differ beyond the float32 "
             f"rounding of their subtraction chains (tree:split:one-sum "
             f"gap:chain gap:higher gain): {bad}")
    return {"first_round_trees": len(ma), "identical_trees": identical,
            "first_differences": ",".join(diffs) or "none",
            "higher_float64_gain_a_b_equal": "{a}:{b}:{=}".format(**better)}


def integer_round_identical(name, runs) -> bool:
    """One round under integer-valued gradients and hessians (every sum
    exact in any order) for each ``(params, Dataset)`` of ``runs``: the
    same rows in other layouts (bundled or not, packed or not) must grow
    identical trees, model text and all."""
    from lightgbm_tpu_torch import train
    texts = []
    for params, ds in runs:
        rng = np.random.default_rng(SEED + 11)

        def fobj(preds, data):
            n = len(preds)
            return (rng.integers(-3, 4, n).astype(np.float64),
                    rng.integers(1, 4, n).astype(np.float64))
        texts.append(train(params, ds, num_boost_round=1, fobj=fobj,
                           verbose_eval=False).model_to_string())
    if any(t != texts[0] for t in texts[1:]):
        fail(f"{name}: one integer-gradient round grows other trees in "
             f"another layout")
    return True


def card_vs_cpu_trees(name, params, x, y, x_te, rounds, first_trees,
                      group=None):
    """The card against the CPU on the same data: the first round's
    ``first_trees`` trees identical in structure (``TREE_STRUCTURE``: the
    same splits of the same rows).  Their gradients are real-valued and
    the card adds them in another order, so two candidate splits whose
    gains differ by less than the sums' rounding are taken in either
    order: a tree that differs passes only where its first differing split
    is such a near-tie in float64 (:func:`near_tie`), identical before it.
    Returns both boosters with their held-out predictions, and the
    numbers."""
    import torch
    from lightgbm_tpu_torch import Dataset, train
    out = {}
    for device in ("cpu", "cuda"):
        p = dict(params, device=device)
        b = train(p, Dataset(x, y, group=group, params=p),
                  num_boost_round=rounds, verbose_eval=False)
        out[device] = (b, b.predict(x_te))
    cpu = out["cpu"][0].inner
    bins = logical_bins(cpu.train_set)
    col_of = {f: i for i, f in enumerate(cpu.train_set.used_features)}
    # the first round's gradients, from scores of 0 (no init score, no
    # boost from average for these objectives)
    g, h = (a.double().numpy() for a in cpu.objective.get_gradients(
        torch.zeros((cpu.num_class, cpu.num_data))))
    pairs = list(zip(cpu.models[:first_trees],
                     out["cuda"][0].inner.models[:first_trees]))
    identical, ties, bad = 0, [], []
    for i, (tc, tg) in enumerate(pairs):
        k = first_split_difference(tc, tg)
        if k is None:
            identical += 1
            continue
        near, rel = near_tie(tc, tg, k, bins, col_of, g[i], h[i],
                             cpu.config.min_sum_hessian_in_leaf)
        where = f"{i}:{k}:f{tc.split_feature[k] if k < tc.num_leaves - 1 else '-'}" \
                f"/f{tg.split_feature[k] if k < tg.num_leaves - 1 else '-'}:{rel:.2e}"
        (ties if near else bad).append(where)
    same = [first_split_difference(tc, tg) is None for tc, tg in pairs]
    dv = max((float(np.abs(tc.leaf_value - tg.leaf_value).max())
              for (tc, tg), s in zip(pairs, same) if s), default=float("nan"))
    numbers = {"first_trees": first_trees, "identical_trees": identical,
               "near_tie_trees": ",".join(ties) or "none",
               "max_leaf_value_diff_identical": f"{dv:.3e}"}
    if bad:
        fail(f"{name}: trees differ between the card and the CPU beyond a "
             f"near-tie (tree:split:features:float64 gap over the float32 "
             f"sums' worst error): {bad}")
    return out, numbers


def rank_card_vs_cpu(params, rng, run_dir, heldout):
    """Phase 8b: the MS-LTR-shaped generator at 100,000 rows (825
    queries), 1 round on the card and on the CPU: the first tree
    identical in structure (up to a near-tie, :func:`card_vs_cpu_trees`),
    NDCG@1/3/5/10 within 1e-3 on phase 8's held-out queries ``heldout``
    (x, y, sizes: 6,000 queries, so that one query's reordered top
    documents move an NDCG by under 2e-4), and the card's model saved,
    reloaded and predicting the same."""
    from lightgbm_tpu_torch import Booster
    x_te, y_te, sizes_te = heldout
    sizes = query_sizes(825, 100_000, MSLR_LONGEST, rng)
    x, y = mslr_like(sizes, rng)
    n = int(sizes.sum())
    out, same = card_vs_cpu_trees("rank_card_vs_cpu", params, x, y, x_te, 1,
                                  1, group=sizes)
    nd = {d: ndcg_at(out[d][1], y_te, sizes_te, MSLR_EVAL_AT) for d in out}
    gap = max(abs(a - b) for a, b in zip(nd["cpu"], nd["cuda"]))
    path = os.path.join(run_dir, "rank_model.txt.tmp")
    out["cuda"][0].save_model(path)
    again = Booster(model_file=path, params={"device": "cuda"}).predict(x_te)
    os.remove(path)
    reload_same = bool(np.array_equal(again, out["cuda"][1]))
    phase("rank_card_vs_cpu", rows=n, queries=len(sizes), rounds=1,
          heldout_queries=len(sizes_te), **same,
          ndcg_gap=f"{gap:.3e}", reload_predicts_same=reload_same,
          **{f"{d}_ndcg@{k}": f"{v:.6f}" for d in nd
             for k, v in zip(MSLR_EVAL_AT, nd[d])})
    if gap > 1e-3:
        fail(f"rank card vs CPU: held-out NDCG differ by {gap} (limit 1e-3)")
    if not reload_same:
        fail("rank: the saved model predicts otherwise after reloading")


def rank_path(params, names, rng, q_train=Q_MSLR, n_train=N_MSLR,
              q_te=Q_MSLR_HELDOUT, n_te=N_MSLR_HELDOUT, rounds=10,
              rate=None):
    """Phases 2h, 8, 8a, 8c and 20b: the MS-LTR-shaped lambdarank task at
    full width (2,270,296 x 137 in 18,919 queries, 750,000 held-out rows
    in 6,000), the lambdarank kernel checked on its labels first, K1 and
    K3 on the packed storage matrix after phase 8's training, the cut run
    and the data-parallel learner on the same Dataset, then the same
    Dataset streamed (``rate`` the pinned host-to-device rate); returns
    phase 8's numbers (20b's under ``streamed``), phase 2h's timing and
    the held-out (x, y, query sizes)."""
    import torch
    from lightgbm_tpu_torch.ops.lambdarank import lambdarank_grad_plain
    t0 = time.perf_counter()
    sizes = query_sizes(q_train, n_train, MSLR_LONGEST, rng)
    sizes_te = query_sizes(q_te, n_te, MSLR_LONGEST, rng)
    x_all, y_all = mslr_like(np.concatenate([sizes, sizes_te]), rng)
    t_gen = time.perf_counter() - t0
    n = int(sizes.sum())
    x_tr, y_tr, x_te, y_te = x_all[:n], y_all[:n], x_all[n:], y_all[n:]

    # ---- phase 2h: the lambdarank kernel against its plain version -------
    lam = check_lambdarank(torch.device("cuda"), rng, (x_tr, y_tr, sizes))
    torch.cuda.empty_cache()

    # ---- phase 8: train at full width, at the defaults --------------------
    rank_params = dict(params, objective="lambdarank", metric="ndcg",
                       ndcg_eval_at=list(MSLR_EVAL_AT))
    rank, bst, ds = train_path("mslr", rank_params, x_tr, y_tr, x_te, y_te,
                               rounds, names, group=sizes,
                               quality=mslr_quality(sizes_te))
    if ds.constructed.layout is not None or bst.inner.packed is None:
        fail("mslr: at the defaults the columns should pack and none "
             "bundle")
    plan = bst.inner.packed.plan
    obj, sc = bst.inner.objective, bst.inner.scores
    grad_ms = cuda_ms(lambda: obj.get_gradients(sc))
    plain_ms = cuda_ms(lambda: lambdarank_grad_plain(
        sc[0], obj._label_i32, obj._bounds, obj._inv_max_dcg, obj._gains,
        obj._discount, obj.config.sigmoid, obj.weights), reps=1, warmup=1)
    rank_ds = {"storage_cols": plan.num_storage_cols,
               "packed_cols": plan.num_packed,
               "bins_bytes": ds.bins.numel(),
               "storage_bytes": bst.inner.packed.matrix.numel(),
               "k1_bytes_per_tree": k1_bytes_per_tree(bst),
               "captures": one_capture("mslr", bst)}
    del obj, sc
    # ---- phase 8a: K1 and K3 on the packed storage matrix -----------------
    packed_check = check_hist_packed(bst.inner, rng)
    torch.cuda.empty_cache()
    # ---- phase 8, cut: the same Dataset (nothing bundles) unpacked --------
    cut, cut_bst, _ = train_path(
        "mslr_cut", dict(rank_params, enable_bundle=False,
                         enable_bin_packing=False), x_tr, y_tr, x_te, y_te,
        rounds, names, group=sizes, quality=mslr_quality(sizes_te), ds=ds,
        profile=False)
    if cut_bst.inner.packed is not None:
        fail("mslr_cut: packed with enable_bin_packing=false")
    cut_ds = {"storage_cols": ds.bins.shape[1],
              "k1_bytes_per_tree": k1_bytes_per_tree(cut_bst),
              "captures": one_capture("mslr_cut", cut_bst)}
    same = first_round_vs(cut_bst, bst, 1)
    # ---- phase 8c: the data-parallel learner over 4x1 on the packed ------
    # storage matrix, 1 round (K3 reads each shard's packed slice and the
    # unfold follows the shard sum)
    dp_params = dict(rank_params, tree_learner="data",
                     mesh_devices=MESH_SLOTS, mesh_shape="4x1")
    dp, dp_bst, _ = train_path(
        "mslr_dp_4x1", dp_params, x_tr, y_tr, x_te, y_te, 1, names,
        group=sizes, quality=lambda b, pred, x, y: {
            "heldout_ndcg@10": f"{ndcg_at(pred, y, sizes_te, [10])[0]:.6f}"},
        ds=ds, profile=False)
    if dp_bst.inner.packed is None:
        fail("mslr_dp_4x1: the data-parallel learner did not pack")
    dp_gap = abs(float(dp["heldout_ndcg@10"])
                 - float(rank["round1_ndcg@10"]))
    del dp_bst
    # ---- phase 21b: the voting learner over 4x1 on the same Dataset -------
    voting = mslr_voting(rank_params, ds, x_tr, y_tr, x_te, y_te, sizes_te,
                         names)
    torch.cuda.empty_cache()
    # ---- phase 23c: the mesh planner at full width -------------------------
    planner = planner_rung(rank_params, ds, x_tr, y_tr, x_te, y_te, sizes_te,
                           names)
    same["integer_round_identical"] = integer_round_identical(
        "mslr_packed_vs_cut", [(rank_params, ds), (dict(
            rank_params, enable_bin_packing=False), ds), (dp_params, ds)])
    gap = abs(float(rank["heldout_ndcg@10"]) - float(cut["heldout_ndcg@10"]))
    phase("mslr_path", generate_s=f"{t_gen:.3f}", queries=len(sizes),
          longest_query=int(sizes.max()), heldout_rows=len(y_te),
          heldout_queries=len(sizes_te),
          label_shares=":".join(f"{v:.3f}" for v in np.bincount(
              y_tr.astype(np.int64), minlength=5) / n),
          reduced="num_iterations 500->10",
          gradient_kernel_ms_per_round=f"{grad_ms:.4f}",
          gradient_plain_ms_per_round=f"{plain_ms:.2f}", **rank_ds, **rank)
    phase("mslr_cut_path", layout="enable_bundle=false;"
          "enable_bin_packing=false", ndcg10_gap_vs_defaults=f"{gap:.3e}",
          **same, **cut_ds, **cut)
    phase("mslr_dp_4x1", storage_cols=plan.num_storage_cols,
          ndcg10_gap_vs_serial_round1=f"{dp_gap:.3e}",
          integer_round_identical_to_serial=same["integer_round_identical"],
          **dp)
    for name, r in (("mslr", rank), ("mslr_cut", cut)):
        if float(r["host_syncs_per_tree"]) > 8:
            fail(f"{name}: {r['host_syncs_per_tree']} host reads a tree")
    if gap > 1e-3:
        fail(f"mslr: held-out NDCG@10 at the defaults is {gap} from the "
             f"unpacked run's (limit 1e-3)")
    if dp_gap > 1e-3:
        fail(f"mslr 4x1: held-out NDCG@10 is {dp_gap} from the serial "
             f"first round's (limit 1e-3)")
    del bst, cut_bst
    torch.cuda.empty_cache()
    # ---- phase 20b: the same Dataset streamed, 3 rounds -------------------
    streamed = mslr_streamed(rank_params, ds, x_te, y_te, sizes_te, rate)
    rank = dict(rank, **rank_ds, packed_check=packed_check,
                cut=dict(cut, **cut_ds), dp_4x1=dp, streamed=streamed,
                voting=voting, planner=planner)
    del ds
    torch.cuda.empty_cache()
    return rank, lam, (x_te, y_te, sizes_te)


def mslr_streamed(rank_params, ds, x_te, y_te, sizes_te, rate,
                  rounds=3) -> dict:
    """Phase 20b: phase 8's Dataset with ``data_stream=chunked`` at the
    default block size (9 blocks of 262,144 rows, the last 173,144), 3
    rounds at the defaults, whose packing is turned off, loudly.  Beside
    it the cut run (no EFB, no packing: the streamed run's layout) trains
    3 rounds resident, its peak device memory taken alone from a reset,
    as the streamed run's is after the matrix left the card: held-out
    NDCG@10 within 1e-3 of the cut run's, and the peak at least
    200,000,000 bytes below it (the matrix less two blocks is
    239,203,096)."""
    import torch
    from lightgbm_tpu_torch import train
    cut_params = dict(rank_params, enable_bundle=False,
                      enable_bin_packing=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cut = train(cut_params, ds, num_boost_round=rounds, verbose_eval=False)
    torch.cuda.synchronize()
    cut_ms = (time.perf_counter() - t0) * 1e3 / rounds
    cut_peak = torch.cuda.max_memory_allocated()
    cut_ndcg = ndcg_at(cut.predict(x_te), y_te, sizes_te, [10])[0]
    del cut
    # the streamed training never needs the Dataset's device copy
    ds.bins = None
    def quality(bst, pred, x, y):
        return {"heldout_ndcg@10":
                f"{ndcg_at(pred, y, sizes_te, [10])[0]:.6f}"}
    out, bst = stream_train("mslr_streamed", rank_params, ds, x_te, y_te,
                            rounds, quality, rate, 9, 173_144)
    gap = abs(float(out["heldout_ndcg@10"]) - cut_ndcg)
    saved = cut_peak - out["peak_mem_bytes"]
    out.update(cut_heldout_ndcg10=f"{cut_ndcg:.6f}",
               ndcg10_gap_vs_cut=f"{gap:.3e}", cut_ms_per_tree=f"{cut_ms:.2f}",
               cut_peak_mem_bytes=cut_peak, peak_mem_saved_bytes=saved)
    phase("mslr_streamed", **out)
    if "enable_bin_packing=true" not in out["downgrades"]:
        fail("mslr_streamed: the packing downgrade was not recorded")
    if gap > 1e-3:
        fail(f"mslr_streamed: held-out NDCG@10 is {gap} from the cut run's "
             f"at {rounds} iterations (limit 1e-3)")
    if saved < 200_000_000:
        fail(f"mslr_streamed: peak device memory {out['peak_mem_bytes']} is "
             f"only {saved} bytes below the cut run's {cut_peak}")
    del bst
    torch.cuda.empty_cache()
    return out


def expo_streamed(expo_params, ds, y_tr, x_te, y_te, model_str, rate,
                  rounds=3) -> dict:
    """Phase 20c (the last phase): phase 5's Expo-shaped Dataset
    (11,000,000 x 8) with ``data_stream=chunked`` at the default block
    size (42 blocks, the last 252,096 rows), ``ordered_bins=on`` turned
    off, loudly: one
    integer-gradient tree identical to the resident graph loop's
    (:func:`streamed_tree_vs_resident`, one tree: 20a runs the sync check;
    the training's third round is profiled), then 3 rounds with
    the held-out AUC within 5e-3 of phase 5's model at 3 iterations."""
    import torch
    from lightgbm_tpu_torch import Booster
    tree = streamed_tree_vs_resident("expo_streamed_tree", ds, y_tr,
                                     (262_144,), rate, checks=False,
                                     ordered_bins="on")
    phase("expo_streamed_tree", **tree)
    ds.bins = None
    torch.cuda.empty_cache()
    out, bst = stream_train("expo_streamed", expo_params, ds, x_te, y_te,
                            rounds, auc_quality, rate, 42, 252_096)
    ref = Booster(model_str=model_str, params={"device": "cuda"}).predict(
        x_te, num_iteration=rounds)
    gap = abs(float(out["heldout_auc"]) - auc(ref, y_te))
    out.update(phase5_auc_at_3=f"{auc(ref, y_te):.6f}",
               auc_gap_vs_phase5=f"{gap:.3e}")
    phase("expo_streamed", **out)
    if "ordered_bins=on" not in out["downgrades"]:
        fail("expo_streamed: the ordered_bins downgrade was not recorded")
    if gap > 5e-3:
        fail(f"expo_streamed: held-out AUC is {gap} from phase 5's model at "
             f"{rounds} iterations (limit 5e-3)")
    del bst
    torch.cuda.empty_cache()
    return dict(out, tree=tree)


def covtype_path(params, names, rng, n=N_COVTYPE, cpu_rows=50_000):
    """Phases 9 to 9g: the Covertype-shaped multiclass task (581,012 x 54,
    7 classes, an 80/20 split) at the defaults, where EFB bundles the 54
    features into 12 columns and nothing packs: 3 rounds of multiclass
    through the serial graph loop (one capture, its graph replayed for
    every tree of every round); the cut run (``enable_bundle=false``,
    ``enable_bin_packing=false``) on its own Dataset for the same rounds,
    its held-out multi_logloss within 1e-4, its first round compared with
    the bundled one's (:func:`first_round_vs`), and one integer-gradient
    round identical in both layouts; the bundled first round again,
    compared with the first run's; 1 round of multiclassova; 1 round of the
    data-parallel learner over 4x1 held to the serial first round's
    multi_logloss within 1e-4; the card against the CPU at ``cpu_rows``
    rows, 2 rounds, the first round's 7 trees identical in structure,
    and there on the CPU the bundled first round against the cut one's;
    one
    integer-gradient tree of ``tree_learner=feature`` over a 1x4 mesh on
    the bundled columns, identical to the serial tree; and bagging in the
    subset regime and DART over the bundles, 3 rounds each, their
    training scores within 1e-5 of ``predict(raw_score=True)``."""
    import torch
    from lightgbm_tpu_torch import Dataset, train
    x_all, y_all = covtype_like(n, rng)
    n_tr = int(0.8 * n)
    x_tr, y_tr, x_te, y_te = (x_all[:n_tr], y_all[:n_tr], x_all[n_tr:],
                              y_all[n_tr:])
    cov_params = dict(params, objective="multiclass", num_class=7,
                      metric="multi_logloss,multi_error", min_data_in_leaf=20,
                      min_sum_hessian_in_leaf=1e-3)
    cut_params = dict(cov_params, enable_bundle=False,
                      enable_bin_packing=False)
    reduced = "num_iterations 3 (21 trees)"
    # ---- phase 9: multiclass at the defaults, 3 rounds of 7 trees ---------
    cov, bst, ds = train_path("covtype", cov_params, x_tr, y_tr, x_te, y_te,
                              3, names, quality=covtype_quality)
    lay = ds.constructed.layout
    if (lay is None or ds.bins.shape[1] != COVTYPE_COLS
            or bst.inner.packed is not None):
        fail(f"covtype: at the defaults {ds.bins.shape[1]} columns, "
             f"packing {bst.inner.packed is not None}; expected "
             f"{COVTYPE_COLS} bundled columns and no packing")
    cov.update(columns=ds.bins.shape[1],
               bundle_slots=":".join(map(str, lay.col_num_bin[10:])),
               captures=one_capture("covtype", bst),
               k1_bytes_per_tree=k1_bytes_per_tree(bst))
    phase("covtype_path", classes=7, train_rows=n_tr, heldout_rows=len(y_te),
          label_shares=":".join(f"{v:.3f}" for v in np.bincount(
              y_tr.astype(np.int64), minlength=7) / n_tr),
          reduced=reduced, **cov)
    # ---- phase 9, cut: no EFB, no packing, its own Dataset ----------------
    cut, cut_bst, cut_ds = train_path("covtype_cut", cut_params, x_tr,
                                      y_tr, x_te, y_te, 3, names,
                                      quality=covtype_quality, profile=False)
    cut.update(columns=cut_bst.inner.bins.shape[1],
               captures=one_capture("covtype_cut", cut_bst),
               k1_bytes_per_tree=k1_bytes_per_tree(cut_bst))
    same = first_round_vs(cut_bst, bst, 7)
    # the witness of the card's own summation order: the bundled layout's
    # first round again, against the first run's
    again = train(cov_params, ds, num_boost_round=1, verbose_eval=False)
    same.update({f"rerun_{k}": v for k, v in
                 first_round_vs(bst, again, 7).items()})
    del again
    same["integer_round_identical"] = integer_round_identical(
        "covtype_bundled_vs_cut", [(cov_params, ds), (cut_params, cut_ds)])
    gap = abs(float(cov["heldout_multi_logloss"])
              - float(cut["heldout_multi_logloss"]))
    phase("covtype_cut_path", layout="enable_bundle=false;"
          "enable_bin_packing=false", logloss_gap_vs_defaults=f"{gap:.3e}",
          **same, **cut)
    for name, r in (("covtype", cov), ("covtype_cut", cut)):
        if float(r["host_syncs_per_tree"]) > 8:
            fail(f"{name}: {r['host_syncs_per_tree']} host reads a tree")
    if gap > 1e-4:
        fail(f"covtype: held-out multi_logloss at the defaults is {gap} "
             f"from the cut run's (limit 1e-4)")
    model = (bst.model_to_string(), x_te[:CONTRIB_ROWS].copy())
    del bst, cut_bst, cut_ds
    torch.cuda.empty_cache()
    # ---- phase 9b: multiclassova, 1 round ---------------------------------
    ova, _, _ = train_path("covtype_ova",
                           dict(cov_params, objective="multiclassova"),
                           x_tr, y_tr, x_te, y_te, 1, names,
                           quality=covtype_quality, ds=ds, profile=False)
    phase("covtype_ova", **ova)
    # ---- phase 9c: the data-parallel learner over 4x1, 1 round ------------
    dp, _, _ = train_path("covtype_dp_4x1",
                          dict(cov_params, tree_learner="data",
                               mesh_devices=MESH_SLOTS, mesh_shape="4x1"),
                          x_tr, y_tr, x_te, y_te, 1, names,
                          quality=covtype_quality, ds=ds, profile=False)
    gap = abs(float(dp["heldout_multi_logloss"])
              - float(cov["round1_multi_logloss"]))
    phase("covtype_dp_4x1", logloss_gap_vs_serial_round1=f"{gap:.3e}", **dp)
    if gap > 1e-4:
        fail(f"covtype 4x1: held-out multi_logloss "
             f"{dp['heldout_multi_logloss']} is more than 1e-4 from the "
             f"serial first round's {cov['round1_multi_logloss']}")
    torch.cuda.empty_cache()
    # ---- phase 9e: tree_learner=feature over 1x4 on the bundles -----------
    gspmd_trees_identical(ds, y_tr, shapes=((1, 4),))
    # ---- phases 9f, 9g: bagging (subset regime) and DART over bundles -----
    for name, extra in (("covtype_bagging", dict(bagging_fraction=0.5,
                                                 bagging_freq=1)),
                        ("covtype_dart", dict(boosting_type="dart",
                                              drop_seed=3, drop_rate=0.5,
                                              skip_drop=0.0))):
        out, b, _ = train_path(name, dict(cov_params, **extra), x_tr, y_tr,
                               x_te, y_te, 3, names, quality=covtype_quality,
                               ds=ds, profile=False)
        raw = b.predict(x_tr, raw_score=True)
        gap = float(np.abs(b.inner.scores.double().cpu().numpy().T
                           - raw).max())
        roots = root_counts(b)
        phase(name, captures=one_capture(name, b),
              scores_vs_predict=f"{gap:.3e}",
              root_counts=":".join(map(str, sorted(set(roots)))), **out)
        if not gap <= 1e-5:
            fail(f"{name}: training scores differ from predict by {gap} "
                 f"(limit 1e-5)")
        if "bagging_fraction" in extra and set(roots) != {n_tr // 2}:
            fail(f"{name}: root counts {sorted(set(roots))}, not the bag "
                 f"of {n_tr // 2}")
        del b
    del ds
    torch.cuda.empty_cache()
    # ---- phase 9d: card against CPU, at the defaults ----------------------
    out, same = card_vs_cpu_trees("covtype_card_vs_cpu", cov_params,
                                  x_tr[:cpu_rows], y_tr[:cpu_rows], x_te,
                                  1, 7)
    # the bundled-vs-cut comparison on the CPU's plain path, whose sums
    # run in one fixed order: its differences are the layouts' arithmetic
    # alone, without the card's atomics
    p_cpu = dict(cut_params, device="cpu")
    cut_cpu = train(p_cpu, Dataset(x_tr[:cpu_rows], y_tr[:cpu_rows],
                                   params=p_cpu),
                    num_boost_round=1, verbose_eval=False)
    same.update({f"cpu_bundled_vs_cut_{k}": v for k, v in
                 first_round_vs(cut_cpu, out["cpu"][0], 7).items()})
    del cut_cpu
    ll = {d: multi_metrics(out[d][1], y_te)[0] for d in out}
    cols = out["cuda"][0].inner.bins.shape[1]
    phase("covtype_card_vs_cpu", rows=cpu_rows, rounds=1, columns=cols,
          **same, cpu_multi_logloss=f"{ll['cpu']:.6f}",
          cuda_multi_logloss=f"{ll['cuda']:.6f}")
    if cols != COVTYPE_COLS:
        fail(f"covtype card vs CPU: {cols} columns at the defaults")
    return dict(cov, cut=cut), model


# ---- phases 10 to 14b: sampling, the boosting variants, the training API --

# training scores (float32, one add a tree) against the model's float64
# raw prediction of the same rows: 1e-4 is some 400 float32 roundings of
# a score of 1 and far below one tree's output, which a row the loop did
# not score would miss by
SCORE_LIMIT = 1e-4


def root_counts(bst) -> list:
    """Each grown tree's root count: the rows it grew on (count weights
    1), as the tree records them."""
    return [int(t.internal_count[0]) for t in bst.inner.models
            if t.num_leaves > 1]


def one_capture(name, bst) -> int:
    """The graph loop of a training captured its step once and replayed
    it for every other step of every tree, sampling included."""
    state = loop_state(bst.inner)
    st = bst.inner.stats
    if not (state is not None and state.captures == 1
            and st["graph_replays"] == st["steps"] - 1):
        fail(f"{name}: {getattr(state, 'captures', None)} captures, "
             f"{st.get('graph_replays')} replays for {st.get('steps')} "
             f"steps: not one graph for the training")
    return state.captures


def scores_vs_predict(name, scores, x, bst) -> str:
    """The largest gap between float32 scores ``[1, N]`` the loop kept and
    ``predict(raw_score=True)`` of the same rows; fails past
    ``SCORE_LIMIT``."""
    raw = bst.predict(x, raw_score=True)
    gap = float(np.abs(scores[0].double().cpu().numpy() - raw).max())
    if not gap <= SCORE_LIMIT:
        fail(f"{name}: scores kept by the loop differ from the model's "
             f"predictions by {gap} (limit {SCORE_LIMIT})")
    return f"{gap:.3e}"


def bag_draw_ms(n: int, fraction: float, seed: int = 3) -> str:
    """Host milliseconds of one subset-regime bag draw of ``fraction * n``
    rows, as the booster draws it (the JAX package's ``sample_k``: numpy's
    ``choice`` without replacement, then a sort)."""
    from lightgbm_tpu_torch.utils.random import make_rng, sample_k
    rng = make_rng(seed)
    t0 = time.perf_counter()
    sample_k(rng, n, max(1, int(n * fraction)))
    return f"{(time.perf_counter() - t0) * 1e3:.2f}"


def bag_counts(n: int, fraction: float, rounds: int, seed: int = 3) -> list:
    """The mask regime's bag sizes, drawn on the host from the bagging
    stream as the booster draws them (a Bernoulli draw of every row a
    round)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return [int((rng.random(n) < fraction).sum()) for _ in range(rounds)]


def feature_masks(f: int, fraction: float, trees: int,
                  seed: int = 2) -> list:
    """Each tree's feature mask, drawn on the host from the
    feature_fraction stream as the booster draws them."""
    rng = np.random.Generator(np.random.PCG64(seed))
    out = []
    for _ in range(trees):
        m = np.zeros(f, bool)
        m[rng.choice(f, size=max(1, int(f * fraction)), replace=False)] = True
        out.append(m)
    return out


def sampling_paths(params, names, x_tr, y_tr, x_te, y_te):
    """Phases 10, 10b, 10d, 11, 12, 13 and 14 on the Higgs-shaped task
    (one Dataset for all); returns their numbers by phase."""
    import torch
    from lightgbm_tpu_torch import Dataset, cv, reset_parameter, train
    run_dir = os.path.dirname(os.path.abspath(__file__))
    n = len(y_tr)
    ds = Dataset(x_tr, y_tr, params=params).construct()
    col_of = {f: i for i, f in enumerate(ds.constructed.used_features)}
    out = {}

    # ---- phase 10: bagging, the subset regime ------------------------------
    p10 = dict(params, bagging_fraction=0.5, bagging_freq=1)
    res, bst, _ = train_path("bag_subset", p10, x_tr, y_tr, x_te, y_te, 10,
                             names, ds=ds)
    roots = root_counts(bst)
    if roots != [n // 2] * 10:
        fail(f"bag_subset: root counts {roots}, not {n // 2} each")
    out["10"] = dict(captures=one_capture("bag_subset", bst),
                     root_counts=":".join(map(str, roots)),
                     host_bag_draw_ms=bag_draw_ms(n, 0.5),
                     train_scores_vs_predict=scores_vs_predict(
                         "bag_subset", bst.inner.scores, x_tr, bst), **res)
    phase("bagging_subset", **out["10"])
    del bst
    torch.cuda.empty_cache()

    # ---- phase 10b: bagging by weights, with feature sampling -------------
    p10b = dict(params, bagging_fraction=0.8, bagging_freq=1,
                feature_fraction=0.8)
    res, bst10b, _ = train_path("bag_mask_ff", p10b, x_tr, y_tr, x_te, y_te,
                                10, names, ds=ds, profile=False)
    roots = root_counts(bst10b)
    want = bag_counts(n, 0.8, 10)
    if roots != want:
        fail(f"bag_mask_ff: root counts {roots}, the host's bags {want}")
    masks = feature_masks(len(col_of), 0.8, 10)
    outside = [i for i, (t, m) in enumerate(zip(bst10b.inner.models, masks))
               if not m[[col_of[int(f)] for f in
                         t.split_feature[:t.num_leaves - 1]]].all()]
    if outside:
        fail(f"bag_mask_ff: trees {outside} split on a feature outside "
             f"their sampled mask")
    out["10b"] = dict(captures=one_capture("bag_mask_ff", bst10b),
                      root_counts=":".join(map(str, roots)),
                      features_per_tree=int(masks[0].sum()),
                      trees_within_mask=len(masks),
                      train_scores_vs_predict=scores_vs_predict(
                          "bag_mask_ff", bst10b.inner.scores, x_tr, bst10b),
                      **res)
    phase("bagging_mask_feature_fraction", **out["10b"])
    serial3 = auc(bst10b.predict(x_te, num_iteration=3), y_te)
    del bst10b
    torch.cuda.empty_cache()

    # ---- phase 10d: the same over the 4x1 data-parallel mesh --------------
    res, bst, _ = train_path(
        "dp_bag_mask_ff", dict(p10b, tree_learner="data",
                               mesh_devices=MESH_SLOTS, mesh_shape="4x1"),
        x_tr, y_tr, x_te, y_te, 3, names, ds=ds, profile=False)
    gap = abs(float(res["heldout_auc"]) - serial3)
    if bst.inner._subset is not None or root_counts(bst) != want[:3]:
        fail(f"dp_bag_mask_ff: not the serial path's bags "
             f"({root_counts(bst)} against {want[:3]})")
    out["10d"] = dict(auc_gap_vs_serial_3_rounds=f"{gap:.3e}",
                      captures=one_capture("dp_bag_mask_ff", bst),
                      root_counts=":".join(map(str, root_counts(bst))),
                      **res)
    phase("dp_bagging_mask_feature_fraction", **out["10d"])
    if gap > 1e-4:
        fail(f"dp_bag_mask_ff: held-out AUC {res['heldout_auc']} is more "
             f"than 1e-4 from the serial path's {serial3:.6f} at 3 rounds")
    del bst
    torch.cuda.empty_cache()

    # ---- phase 11: GOSS ---------------------------------------------------
    p11 = dict(params, boosting_type="goss", top_rate=0.2, other_rate=0.1)
    res, bst, _ = train_path("goss", p11, x_tr, y_tr, x_te, y_te, 13, names,
                             ds=ds, profile=False)
    roots = root_counts(bst)
    top, other = int(n * 0.2), int(n * 0.1)
    if roots[:10] != [n] * 10 or not all(
            top + 0.9 * other <= r <= top + 1.2 * other for r in roots[10:]):
        fail(f"goss: root counts {roots}: not {n} in the 10 warm-up rounds "
             f"and {top} plus about {other} kept others after")
    reads = bst.inner.stats["sample_host_reads"]
    if reads != 3:
        fail(f"goss: {reads} host reads of the gradients for 3 sampled "
             f"rounds")
    out["11"] = dict(captures=one_capture("goss", bst),
                     root_counts=":".join(map(str, roots)),
                     sample_host_reads=reads,
                     train_scores_vs_predict=scores_vs_predict(
                         "goss", bst.inner.scores, x_tr, bst), **res)
    phase("goss", **out["11"])
    del bst
    torch.cuda.empty_cache()

    # ---- phase 12: DART, with the held-out rows as a valid set ------------
    # the default rates (drop_rate 0.1, skip_drop 0.5, max_drop 50); the
    # default drop_seed 4 drops no tree in 10 rounds, seed 3 drops in
    # rounds 3, 7, 8 and 10 (the drop stream does not depend on the data)
    res, bst, _ = train_path("dart", dict(params, boosting_type="dart",
                                          drop_seed=3),
                             x_tr, y_tr, x_te, y_te, 10, names, ds=ds,
                             valid=True, profile=False)
    weights = bst.inner.tree_weight
    out["12"] = dict(
        captures=one_capture("dart", bst),
        tree_weights=":".join(f"{w:.6g}" for w in weights),
        valid_scores_vs_predict=scores_vs_predict(
            "dart valid", bst.inner.valid_sets[0].scores, x_te, bst),
        train_scores_vs_predict=scores_vs_predict(
            "dart", bst.inner.scores, x_tr, bst), **res)
    phase("dart", **out["12"])
    if all(w == params["learning_rate"] for w in weights):
        fail("dart: no iteration dropped a tree")
    del bst
    torch.cuda.empty_cache()

    # ---- phase 13: RF, its model file saved and loaded ---------------------
    p13 = dict(params, boosting_type="rf", bagging_fraction=0.5,
               bagging_freq=1, feature_fraction=0.6)
    res, bst, _ = train_path("rf", p13, x_tr, y_tr, x_te, y_te, 10, names,
                             ds=ds, profile=False)
    from lightgbm_tpu_torch import Booster
    path = os.path.join(run_dir, "rf_model.txt.tmp")
    bst.save_model(path)
    with open(path) as f:
        text = f.read()
    again = Booster(model_file=path, params={"device": params["device"]})
    os.remove(path)
    same = bool(np.array_equal(again.predict(x_te), bst.predict(x_te)))
    roots = root_counts(bst)
    out["13"] = dict(captures=one_capture("rf", bst),
                     root_counts=":".join(map(str, roots)),
                     average_output_line="\naverage_output\n" in text,
                     reload_predicts_same=same,
                     train_scores_vs_predict=scores_vs_predict(
                         "rf", bst.inner.scores, x_tr, bst), **res)
    phase("rf", **out["13"])
    if not out["13"]["average_output_line"] or not same or \
            roots != [n // 2] * 10:
        fail(f"rf: average_output in the file "
             f"{out['13']['average_output_line']}, the reloaded model "
             f"predicts the same {same}, root counts {roots}")
    del bst, again
    torch.cuda.empty_cache()

    # ---- phase 14: the training API on the card ----------------------------
    rounds = 6
    fracs = [0.5, 0.5] + [1.0] * (rounds - 2)
    rates = [0.1, 0.1] + [0.05] * (rounds - 2)
    res, bst, _ = train_path(
        "reset_bagging", p10, x_tr, y_tr, x_te, y_te, rounds, names, ds=ds,
        valid=True, train_kw=dict(callbacks=[reset_parameter(
            learning_rate=rates, bagging_fraction=fracs)]))
    roots = root_counts(bst)
    if roots != [n // 2] * 2 + [n] * (rounds - 2) or bst.inner._bagging_on:
        fail(f"reset_bagging: root counts {roots}: bagging not switched "
             f"off after round 2")
    captures = one_capture("reset_bagging", bst)
    # rollback of the last iteration: the scores cloned at its start
    inner = bst.inner
    t0, v0 = inner.scores.clone(), inner.valid_sets[0].scores.clone()
    text = bst.model_to_string()
    bst.update()
    bst.rollback_one_iter()
    rollback_exact = (torch.equal(inner.scores, t0)
                      and torch.equal(inner.valid_sets[0].scores, v0)
                      and bst.model_to_string() == text)
    if not rollback_exact:
        fail("rollback_one_iter did not restore the scores and the model "
             "bit for bit")
    del bst, inner, t0, v0
    # a custom binary log loss grows the built-in objective's first tree

    def logloss(preds, data):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - data.get_label(), p * (1.0 - p)
    first = lambda b: b.model_to_string().split("Tree=")[1]
    fobj_same = (first(train(params, ds, 1, fobj=logloss,
                             verbose_eval=False))
                 == first(train(params, ds, 1, verbose_eval=False)))
    if not fobj_same:
        fail("a custom binary log loss grew another first tree than the "
             "built-in objective")
    # cv, 3 folds of 200,000 rows, with early stopping
    fns = _kernel_wrappers()
    for fn in fns.values():
        fn.launches = 0
    cv_params = dict(params, metric=["binary_logloss", "auc"])
    sub = 200_000
    t_cv = time.perf_counter()
    result = cv(cv_params, Dataset(x_tr[:sub], y_tr[:sub], params=cv_params),
                3, nfold=3, early_stopping_rounds=2)
    t_cv = time.perf_counter() - t_cv
    cv_launches = {k: fn.launches for k, fn in fns.items()}
    if not all(cv_launches[k] for k in ("hist_window", "partition_window",
                                         "route_window")):
        fail(f"cv: kernel counts {cv_launches}")
    if sorted(result) != ["auc-mean", "auc-stdv", "binary_logloss-mean",
                          "binary_logloss-stdv"] or not np.isfinite(
            sum(result.values(), [])).all():
        fail(f"cv: {result}")
    out["14"] = dict(captures=captures,
                     root_counts=":".join(map(str, roots)),
                     rollback_bit_exact=rollback_exact,
                     fobj_first_tree_identical=fobj_same,
                     cv_rows=min(sub, n), cv_folds=3, cv_s=f"{t_cv:.3f}",
                     **{f"cv_{k}": ":".join(f"{v:.6f}" for v in vals)
                        for k, vals in result.items()},
                     **{f"cv_{k}_counted": v for k, v in cv_launches.items()
                        if v},
                     **{f"reset_{k}": v for k, v in res.items()})
    phase("training_api", **out["14"])
    torch.cuda.empty_cache()
    return out


def expo_subset_path(params, names, ds, x_tr, y_tr, x_te, y_te):
    """Phase 10c: the Expo-shaped task at full width (11,000,000 rows) in
    the bagging subset regime with ``ordered_bins=on``, 3 rounds: the root
    window holds the 5,500,000 bag rows, whose bins and weights start each
    tree in the ordered copies."""
    import torch
    n = len(y_tr)
    res, bst, _ = train_path(
        "expo_bag_subset", dict(params, bagging_fraction=0.5,
                                bagging_freq=1),
        x_tr, y_tr, x_te, y_te, 3, names, ds=ds)
    roots = root_counts(bst)
    if roots != [n // 2] * 3:
        fail(f"expo_bag_subset: root counts {roots}, not {n // 2} each")
    out = dict(captures=one_capture("expo_bag_subset", bst),
               root_counts=":".join(map(str, roots)),
               host_bag_draw_ms=bag_draw_ms(n, 0.5),
               train_scores_vs_predict=scores_vs_predict(
                   "expo_bag_subset", bst.inner.scores, x_tr, bst), **res)
    phase("expo_bagging_subset", **out)
    del bst
    torch.cuda.empty_cache()
    return out


def sampling_card_vs_cpu(params, x, y, x_te, y_te):
    """Phase 14b: the card against the CPU on 50,000 rows, 3 rounds, for
    bagging (subset regime), GOSS (learning_rate 0.5, so round 3 samples)
    and DART: the same sampling streams on both, the first tree identical
    (round 1's gradients are +-0.5 and 0.25, whose sums are exact) up to a
    float64-checked near-tie (:func:`card_vs_cpu_trees`)."""
    out = {}
    for name, p in (
            ("bagging", dict(params, bagging_fraction=0.5, bagging_freq=1)),
            ("goss", dict(params, boosting_type="goss", learning_rate=0.5)),
            ("dart", dict(params, boosting_type="dart", drop_rate=0.5,
                          skip_drop=0.0))):
        boosters, same = card_vs_cpu_trees(f"{name}_card_vs_cpu", p, x, y,
                                           x_te, 3, 1)
        a = {d: auc(boosters[d][1], y_te) for d in boosters}
        reads = {d: boosters[d][0].inner.stats["sample_host_reads"]
                 for d in boosters}
        out[name] = dict(rows=len(y), rounds=3, **same,
                         cpu_auc=f"{a['cpu']:.6f}", cuda_auc=f"{a['cuda']:.6f}",
                         sample_host_reads=":".join(
                             str(reads[d]) for d in ("cpu", "cuda")))
        phase(f"{name}_card_vs_cpu", **out[name])
        if name == "goss" and reads != {"cpu": 1, "cuda": 1}:
            fail(f"goss card vs CPU: sampled rounds {reads}, not round 3 "
                 f"on both")
    return out


def nonfinite_guard(params, x, y):
    """Phase 15: the non-finite guard on the card, on 200,000 Higgs-shaped
    rows of L2 regression, each policy tripped once: ``raise`` by a NaN
    label (the first tree's gradients), ``rollback`` and ``clamp`` by a
    custom objective of integer gradients that returns a NaN at its third
    call only (rollback retries the iteration, clamp sets the gradient to
    0 and its hessian to 1); then a clean run, which trips nothing.  Each
    run takes the graph loop with one capture and at most 8 host reads a
    tree, its flags read with the tree's copy to the host; the models
    that train predict finite values.  Returns the trips by policy."""
    from lightgbm_tpu_torch import Booster, Dataset, NonFiniteError

    def fobj_with_nan(nan_at):
        calls = [0]

        def fobj(preds, data):
            rng = np.random.default_rng(SEED + calls[0])
            calls[0] += 1
            g = rng.integers(-3, 4, len(preds)).astype(np.float64)
            h = rng.integers(1, 3, len(preds)).astype(np.float64)
            if calls[0] == nan_at:
                g[5] = np.nan
            return g, h
        return fobj

    y_nan = y.astype(np.float64)
    y_nan[17] = np.nan
    runs = (("raise", y_nan, None), ("rollback", y, fobj_with_nan(3)),
            ("clamp", y, fobj_with_nan(3)), ("clean", y, fobj_with_nan(0)))
    trips = {}
    for policy, label, fobj in runs:
        p = dict(params, objective="regression", nonfinite_policy=(
            "rollback" if policy == "clean" else policy))
        bst = Booster(params=p, train_set=Dataset(x, label, params=p))
        raised = None
        for _ in range(5):
            try:
                bst.update(fobj=fobj)
            except NonFiniteError as e:
                raised = str(e)
                break
        st = bst.inner.stats
        reads = st["host_syncs"] / max(st["trees"], 1)
        trips[policy] = st["nonfinite_trips"]
        want_trips = 0 if policy == "clean" else 1
        out = dict(policy=policy, trips=trips[policy], trees=st["trees"],
                   iterations=bst.current_iteration(),
                   host_syncs_per_tree=f"{reads:.3f}",
                   captures=one_capture(f"nonfinite_{policy}", bst),
                   raised=repr(raised))
        if (trips[policy] != want_trips or reads > 8
                or (raised is not None) != (policy == "raise")):
            fail(f"nonfinite guard, {policy}: {out}")
        if policy != "raise":
            pred = bst.predict(x[:1000])
            if not np.isfinite(pred).all():
                fail(f"nonfinite guard, {policy}: non-finite predictions")
            if bst.current_iteration() != (4 if policy == "rollback"
                                           else 5):
                fail(f"nonfinite guard, {policy}: "
                     f"{bst.current_iteration()} iterations")
        phase("nonfinite_guard", **out)
    return ":".join(f"{k}={v}" for k, v in trips.items())


# ---- phases 16 and 17: prediction breadth and the Dataset inputs ----------

CONTRIB_ROWS = 4_000          # rows whose TreeSHAP contributions the card
#                               computes a model
CONTRIB_CPU_ROWS = 1_000      # of them, those the CPU computes again: the
#                               recursion is the same host code on both, so
#                               the comparison holds the go-left matrices,
#                               and the CPU's binning takes its share


def timed(fn):
    """``fn()`` and its seconds, the card's queue drained on both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def early_stop_margin(bst, x) -> float:
    """A margin that stops some rows at the first check (2 iterations) and
    not others: the median margin of the scores after 2 iterations (|s|
    for one class, top1 - top2 for several)."""
    raw = np.asarray(bst.predict(x, num_iteration=2, raw_score=True))
    if raw.ndim == 1:
        return float(np.median(np.abs(raw)))
    top = np.sort(raw, axis=1)
    return float(np.median(top[:, -1] - top[:, -2]))


def prediction_breadth(models) -> dict:
    """Phase 16: ``pred_leaf``, ``pred_early_stop`` and ``pred_contrib``
    of phase 3b's, 5's and 9's models (from their model text) on held-out
    rows, each call on the card held against the same call on the CPU:
    leaf indices and early-stopped scores exactly, contributions within
    1e-12 x (1 + |value|) on the first ``CONTRIB_CPU_ROWS`` rows, and every
    row's contributions summing to its raw score within 1e-9 x (1 +
    |raw|); the seconds of each call."""
    from lightgbm_tpu_torch import Booster
    out = {}
    for name, (model_str, x, calls) in models.items():
        card = Booster(model_str=model_str, params={"device": "cuda"})
        cpu = Booster(model_str=model_str, params={"device": "cpu"})
        k = card.inner.num_class
        r = dict(rows=len(x), trees=card.num_trees(), classes=k)
        if "leaf" in calls:
            got, r["leaf_s"] = timed(lambda: card.predict(x, pred_leaf=True))
            want, r["leaf_cpu_s"] = timed(lambda: cpu.predict(x,
                                                              pred_leaf=True))
            if got.shape != (len(x), card.num_trees()) or not \
                    np.array_equal(got, want):
                fail(f"{name}: leaf indices differ between the card and "
                     f"the CPU")
        if "early_stop" in calls:
            margin = early_stop_margin(card, x)
            kw = dict(raw_score=True, pred_early_stop=True, pred_parameter={
                "pred_early_stop_freq": 2, "pred_early_stop_margin": margin})
            got, r["early_stop_s"] = timed(lambda: card.predict(x, **kw))
            want, r["early_stop_cpu_s"] = timed(lambda: cpu.predict(x, **kw))
            full = card.predict(x, raw_score=True)
            moved = (got != full).reshape(len(x), -1).any(1)
            r.update(early_stop_freq=2, early_stop_margin=f"{margin:.6f}",
                     stopped_share=f"{moved.mean():.4f}")
            if not np.array_equal(got, want):
                fail(f"{name}: early-stopped scores differ between the card "
                     f"and the CPU")
            if not 0 < moved.mean() < 1:
                fail(f"{name}: the early-stop margin {margin} stopped "
                     f"{moved.mean():.4f} of the rows, not some")
        if "contrib" in calls:
            rows = x[:CONTRIB_ROWS]
            m = CONTRIB_CPU_ROWS
            got, r["contrib_s"] = timed(lambda: card.predict(
                rows, pred_contrib=True))
            want, r["contrib_cpu_s"] = timed(lambda: cpu.predict(
                rows[:m], pred_contrib=True))
            raw = np.asarray(card.predict(rows, raw_score=True)).reshape(
                len(rows), k)
            sums = got.reshape(len(rows), k, -1).sum(-1)
            err = float((np.abs(got[:m] - want) / (1 + np.abs(want))).max())
            sum_err = float((np.abs(sums - raw) / (1 + np.abs(raw))).max())
            r.update(contrib_rows=len(rows), contrib_cpu_rows=m,
                     contrib_shape="x".join(map(str, got.shape)),
                     contrib_rel_err_vs_cpu=f"{err:.3e}",
                     contrib_sum_rel_err=f"{sum_err:.3e}")
            if got.shape != (len(rows), k * (card.num_feature() + 1)):
                fail(f"{name}: contributions of shape {got.shape}")
            if not err <= 1e-12:
                fail(f"{name}: contributions differ between the card and "
                     f"the CPU by {err} of 1 + |value| (limit 1e-12)")
            if not sum_err <= 1e-9:
                fail(f"{name}: contributions sum to the raw score within "
                     f"{sum_err} of 1 + |raw| (limit 1e-9)")
        r = {key: (f"{v:.3f}" if key.endswith("_s") else v)
             for key, v in r.items()}
        phase(f"predict_breadth_{name}", **r)
        out[name] = r
    return out


def csv_lines(x, y, header: bool) -> str:
    """Rows as CSV, the label first, every value as the float64 that reads
    back exactly."""
    buf = [",".join(["label"] + [f"f{j}" for j in range(x.shape[1])])
           ] if header else []
    body = np.column_stack([y, x]).astype(np.float64)
    buf += [",".join(map(repr, row)) for row in body.tolist()]
    return "\n".join(buf) + "\n"


def libsvm_lines(x, y) -> str:
    out = []
    for label, row in zip(y.tolist(), np.asarray(x, np.float64).tolist()):
        out.append(" ".join([repr(label)] + [f"{j}:{v!r}" for j, v in
                                             enumerate(row) if v != 0]))
    return "\n".join(out) + "\n"


def same_binned(name, a, b) -> None:
    """Two Datasets' bins, labels and weights equal."""
    ta, tb = a.constructed, b.constructed
    if not np.array_equal(ta.binned, tb.binned):
        fail(f"{name}: bins differ from those of the same rows in memory")
    for field in ("label", "weight"):
        va, vb = getattr(ta.metadata, field), getattr(tb.metadata, field)
        if (va is None) != (vb is None) or (
                va is not None and not np.array_equal(va, vb)):
            fail(f"{name}: {field} differs from that of the rows in memory")


def sixteenths_logloss(preds, data):
    """The binary log loss's gradients and hessians rounded to multiples
    of 1/16 (hessians at least 1/16): up to 2^20 rows of them sum in
    float32 exactly, in any order."""
    y = data.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return (np.round((p - y) * 16) / 16,
            np.maximum(np.round(p * (1 - p) * 16), 1) / 16)


def dataset_inputs(params, higgs_model, x_tr, y_tr, x_te, y_te) -> dict:
    """Phase 17: the Dataset inputs at the Higgs path's size, in a fresh
    temporary directory: the 100,000 held-out rows as a CSV with a header
    and a ``.weight`` side file, and as LibSVM, each a Dataset with the
    training Dataset as reference, binned, labelled and weighted as the
    same rows in memory; ``predict`` of the CSV's path equal bit for bit
    to that of the matrix (phase 3b's model); the CSV read twice
    (``use_two_round_loading``) against the rows in memory; the
    1,000,000-row training Dataset saved as a binary file, loaded, and one
    integer-gradient round on the loaded copy identical to one on the
    original; and the training matrix with 70 % of its values set to zero
    as a ``CsrMatrix``, binned as the dense matrix and trained 3 rounds
    under exact-sum gradients (:func:`sixteenths_logloss`): the dense
    run's trees, its held-out AUC within 1e-4 of the dense run's; with the
    built-in objective, the CSR run's AUC beside the dense run's and a
    dense rerun's.  The seconds of each parse, construction, save, load
    and training."""
    import tempfile
    from lightgbm_tpu_torch import Booster, Dataset, train
    from lightgbm_tpu_torch.data import CsrMatrix
    tmp = tempfile.mkdtemp(prefix="lgbt_smoke_")
    r = {}
    try:
        base, r["construct_train_s"] = timed(
            lambda: Dataset(x_tr, y_tr, params=params).construct())
        w = np.random.default_rng(SEED + 17).integers(1, 4, len(y_te))
        mem, r["construct_heldout_s"] = timed(lambda: Dataset(
            x_te, y_te, weight=w, reference=base, params=params).construct())
        # ---- CSV with a header and a .weight side file, and LibSVM ------
        csv = os.path.join(tmp, "heldout.csv")
        svm = os.path.join(tmp, "heldout.svm")
        t0 = time.perf_counter()
        with open(csv, "w") as f:
            f.write(csv_lines(x_te, y_te, header=True))
        np.savetxt(csv + ".weight", w, fmt="%d")
        r["write_csv_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(svm, "w") as f:
            f.write(libsvm_lines(x_te, y_te))
        np.savetxt(svm + ".weight", w, fmt="%d")
        r["write_libsvm_s"] = time.perf_counter() - t0
        for name, path, p in (("csv", csv, dict(params, header=True)),
                              ("libsvm", svm, params)):
            ds, r[f"{name}_parse_construct_s"] = timed(lambda: Dataset(
                path, reference=base, params=p).construct())
            same_binned(name, ds, mem)
        bst = Booster(model_str=higgs_model,
                      params={"device": "cuda", "header": True})
        want = bst.predict(x_te)
        got, r["csv_predict_s"] = timed(lambda: bst.predict(csv))
        if not np.array_equal(got, want):
            fail("csv: predict of the path differs from predict of the "
                 "matrix")
        # ---- two-round loading of the CSV -------------------------------
        mem_own, r["construct_heldout_alone_s"] = timed(lambda: Dataset(
            x_te, y_te, weight=w, params=params).construct())
        two, r["csv_two_round_s"] = timed(lambda: Dataset(csv, params=dict(
            params, header=True, use_two_round_loading=True)).construct())
        same_binned("two-round csv", two, mem_own)
        if two.raw is not None:
            fail("two-round loading kept the file's float rows")
        # ---- the binary file of the training Dataset --------------------
        path = os.path.join(tmp, "train.bin")
        _, r["save_binary_s"] = timed(lambda: base.save_binary(path))
        r["binary_bytes"] = os.path.getsize(path)
        loaded, r["load_binary_s"] = timed(lambda: Dataset.load_binary(path))
        same_binned("binary file", loaded.construct(device="cuda"), base)
        r["binary_integer_round_identical"] = integer_round_identical(
            "binary file", [(params, base), (params, loaded)])
        del loaded, base, mem, mem_own, two
        # ---- a CSR matrix, 70 % zeros -------------------------------------
        xs = np.where(np.random.default_rng(SEED + 18).random(x_tr.shape)
                      < 0.7, np.float32(0), x_tr)
        nz = xs != 0
        rows, cols = np.nonzero(nz)
        csr = CsrMatrix(np.concatenate([[0], np.cumsum(nz.sum(1))]), cols,
                        xs[rows, cols], xs.shape[1])
        del nz, rows, cols
        sparse, r["csr_construct_s"] = timed(lambda: Dataset(
            csr, y_tr, params=params).construct())
        dense, r["dense_construct_s"] = timed(lambda: Dataset(
            xs, y_tr, params=params).construct())
        same_binned("csr", sparse, dense)
        # 3 rounds on each under the log loss's gradients rounded to
        # sixteenths, whose float32 sums are exact in any order: the card
        # grows the same trees from the same bins, so the CSR run's model
        # and held-out AUC are the dense run's.  Then the built-in
        # objective on each, and on the dense Dataset again: its
        # real-valued sums round in the card's order, which differs from
        # run to run (the rerun is the witness)
        texts, aucs = {}, {}
        for name, ds, fobj in (("csr", sparse, sixteenths_logloss),
                               ("dense", dense, sixteenths_logloss),
                               ("csr_builtin", sparse, None),
                               ("dense_builtin", dense, None),
                               ("dense_builtin_rerun", dense, None)):
            b, r[f"{name}_train_s"] = timed(lambda: train(
                params, ds, num_boost_round=3, fobj=fobj,
                verbose_eval=False))
            texts[name] = b.model_to_string()
            aucs[name] = auc(b.predict(x_te, raw_score=True), y_te)
            del b
        gap = abs(aucs["csr"] - aucs["dense"])
        base_auc = aucs["dense_builtin"]
        r.update(csr_nnz=csr.nnz,
                 csr_model_identical=texts["csr"] == texts["dense"],
                 **{f"{k}_auc": f"{v:.6f}" for k, v in aucs.items()},
                 csr_auc_gap=f"{gap:.3e}",
                 csr_builtin_auc_gap=(
                     f"{abs(aucs['csr_builtin'] - base_auc):.3e}"),
                 dense_builtin_rerun_auc_gap=(
                     f"{abs(aucs['dense_builtin_rerun'] - base_auc):.3e}"))
        if not r["csr_model_identical"]:
            fail("csr: 3 rounds of exact sums grow other trees than on the "
                 "dense matrix")
        if gap > 1e-4:
            fail(f"csr: held-out AUC {aucs['csr']} is more than 1e-4 from "
                 f"the dense run's {aucs['dense']}")
        if not 0.6 < aucs["csr_builtin"] <= 1.0:
            fail(f"csr: held-out AUC {aucs['csr_builtin']} is not that of "
                 f"a learned model")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r = {k: (f"{v:.3f}" if k.endswith("_s") else v) for k, v in r.items()}
    phase("dataset_inputs", heldout_rows=len(y_te), train_rows=len(y_tr),
          **r)
    return r


def multi_card(params) -> None:
    """``--multi-card``: the data-parallel learner with its four mesh slots
    on four cards (slot s on card s) instead of one, so its split step
    runs eagerly, the split row copied to each card and the partials to
    the first: phase 6c's integer-gradient trees against the serial tree,
    and the 4x1 path for 3 rounds with its launch count.  Then four
    processes, one a card, over NCCL (phase 22's workers with
    ``tree_learner=data``): the integer tree equal to the serial tree, 3
    rounds identical on every rank, ms a tree and the collectives' share;
    4 rounds of the score-following integer gradients with a snapshot set
    every 2 rounds, and a resume from the set at 2 byte-identical on every
    rank.  Needs four cards."""
    import torch
    if torch.cuda.device_count() < MESH_SLOTS:
        fail(f"--multi-card needs {MESH_SLOTS} cards; "
             f"{torch.cuda.device_count()} visible")
    rng = np.random.default_rng(SEED + 1)
    x_all, y_all = higgs_like(N_ROWS + N_HELDOUT, rng)
    x_tr, y_tr = x_all[:N_ROWS], y_all[:N_ROWS]
    x_te, y_te = x_all[N_ROWS:], y_all[N_ROWS:]
    from lightgbm_tpu_torch import Dataset
    ds = Dataset(x_tr, y_tr, params=params).construct()
    # slots on several cards take the eager loop
    gspmd_trees_identical(ds, y_tr, graph=False)
    dp, bst, _ = train_path(
        "dp_4x1_four_cards", dict(params, tree_learner="data",
                                  mesh_devices=MESH_SLOTS, mesh_shape="4x1"),
        x_tr, y_tr, x_te, y_te, 3, ("hist_local", "lgbt_route_rows"))
    cards = {d.index for d in sum(bst.inner.mesh.devices, [])}
    if len(cards) != MESH_SLOTS:
        fail(f"the 4x1 mesh sits on cards {sorted(cards)}, not on four")
    phase("dp_path_4x1_four_cards", **dp)
    del bst
    torch.cuda.empty_cache()
    # four processes, one a card, over NCCL: the integer tree equal to the
    # serial one, 3 rounds identical on every rank
    from lightgbm_tpu_torch import train
    g_all, h_all = integer_gradients(y_tr)
    serial_int = train(params, ds, 1, fobj=lambda preds, data: (g_all, h_all),
                       verbose_eval=False).model_to_string()
    t0 = time.perf_counter()
    ranks = spawn_ranks(MESH_SLOTS, dict(params=params,
                                         learners={"data": (True, 3)},
                                         findbin=0, score_rounds=4,
                                         resume_check=True))
    checks = {"integer_tree_equals_serial": all(
                  r["data_integer_model"] == serial_int for r in ranks),
              "models_identical": all(r["data_model"] == ranks[0]["data_model"]
                                      for r in ranks),
              "group_resume_identical": all(
                  r["resume_identical"] and r["data_score_model"]
                  == ranks[0]["data_score_model"] for r in ranks)}
    r0 = ranks[0]
    phase("four_processes_four_cards", backend=r0["backend"],
          processes=r0["process_count"],
          devices=",".join(r["device"] for r in ranks),
          spawn_to_exit_s=f"{time.perf_counter() - t0:.1f}",
          integer_ms=r0["data_integer_ms"],
          ms_per_tree=r0["data_ms_per_tree"],
          timed_tree_ms=r0["data_timed_tree_ms"],
          collective_ms=r0["data_collective_ms"],
          collective_share=r0["data_collective_share"],
          hist_local_launches=r0["data_launches"]["hist_local"],
          route_rows_launches=r0["data_launches"]["route_rows"],
          resume_s=r0["resume_s"], shard_bytes=r0["shard_bytes"], **checks)
    bad = [k for k, v in checks.items() if not v]
    if bad or r0["backend"] != "nccl":
        fail(f"four processes on four cards: {bad}, backend {r0['backend']}")



# ---- phase 2i: every kernel on a uint16 bin matrix -------------------------

WIDE_BINS = 1023         # phase 18's max_bin: the Higgs path's histogram
# the K1/K3 cases: 4-column groups (1,023 bins), one column a group in
# shared memory past 48 KB (4,097), one column's bins in two slices
# (20,000 bins: 240,000 bytes, past the 232,448 a block may opt into)
WIDE_SHAPES = (WIDE_BINS, 4097, 20_000)
EXPO_WIDE_BINS = 283     # the Expo tail's columns over 300 airports


def wide_bound_ms(rows: int, cols: int, num_bins: int,
                  scanned: int = 0) -> float:
    """Least time of a uint16 histogram call: each of ``rows`` rows' bins
    (2 B a column), three weights and its order entry (a window) read, or,
    for a shard's masked scan, 4 B of row_leaf for each of ``scanned``
    rows and no order entry; the [cols, num_bins, 3] f32 output written;
    over the memory rate; or 3 x cols f32 adds a row over the f32 rate.
    A window's bytes are rows x (2 x cols + 16) plus the output."""
    nbytes = (rows * (2 * cols + 12) + (4 * scanned if scanned else 4 * rows)
              + cols * num_bins * 12)
    return max(nbytes / H100_BYTES_PER_S,
               3 * cols * rows / H100_F32_OPS_PER_S) * 1e3


def u16(a: np.ndarray, dev):
    """A uint16 numpy array on the card (a byte copy: no PyTorch kernel of
    the type runs)."""
    import torch
    return torch.from_numpy(np.ascontiguousarray(a, np.uint16)).to(dev)


def bits(x):
    """A tensor's bytes, which any comparison on the card takes."""
    import torch
    return x.contiguous().view(torch.uint8)


def check_wide_hist(dev, rng):
    """Phase 2i, K1 and K3 on uint16 bins: every case of ``WIDE_SHAPES``
    against the plain version, exact under integer weights in every plan
    (small, large, the split steps' device regime) and within 1e-5 of a
    float64 sum of |w| under float32 weights; times at phase 18's 1,023
    bins (K1: the 1,000,000-row root and 4,097 rows; K3: a 250,000-row
    shard, all rows and a leaf of about 1,000)."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (
        bin_rows, hist_local, hist_local_plain, hist_window,
        hist_window_plain, plan_device, plan_device_local, plan_launch,
        sm_count)
    sms = sm_count(torch.cuda.current_device())
    n, f = N_ROWS, N_FEAT
    order = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    w_int = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-8, 9, n).astype(np.float32),
        rng.integers(0, 5, n).astype(np.float32), np.ones(n, np.float32))]
    w_f32 = [torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal(n).astype(np.float32),
        rng.uniform(0.0, 0.25, n).astype(np.float32),
        np.ones(n, np.float32))]
    n_loc = n // 4
    leaf_np = np.where(rng.random(n_loc) < 0.004, 1, 0).astype(np.int32)
    row_leaf = torch.from_numpy(leaf_np).to(dev)
    leaf_rows = torch.from_numpy(np.bincount(leaf_np, minlength=3).astype(
        np.int32)).to(dev)
    timing, max_err = {}, 0.0

    def rel_err(k, rows, bins, nb):
        ref = hist64(rows, bins, w_f32, nb)
        mag = hist64(rows, bins, [w.abs() for w in w_f32], nb)
        err = (k.double() - ref).abs()
        return (err / mag.clamp(min=1e-30)).max().item(), err.max().item()

    for nb in WIDE_SHAPES:
        bins = u16(rng.integers(0, nb, (n, f)), dev)
        plan = lambda bound, loc=None, **kw: plan_launch(
            bound, f, nb, loc, num_sms=sms, bin_bytes=2, **kw)
        for start, cnt in ((12345, 0), (777, 1), (5000, 511),
                           (40000, 4097), (300000, 100000), (0, n)):
            sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
            p_int = hist_window_plain(order, sc, bins, *w_int, nb)
            plans = {"own": plan(cnt), "small": plan(cnt, small_max_rows=n),
                     "large": plan(cnt, small_max_rows=-1),
                     "device": plan_device(n, f, nb, num_sms=sms,
                                           bin_bytes=2)}
            for name, pl in plans.items():
                k = hist_window(order, sc, bins, *w_int, nb, cnt, pl)
                torch.cuda.synchronize()
                if not torch.equal(k, p_int):
                    fail(f"uint16 K1 != plain under integer weights at "
                         f"{nb} bins, window ({start}, {cnt}), {name} plan "
                         f"{pl}")
            if cnt:
                rel, err = rel_err(hist_window(order, sc, bins, *w_f32, nb,
                                               cnt),
                                   order[start:start + cnt], bins, nb)
                if rel > 1e-5:
                    fail(f"uint16 K1 beyond 1e-5 of the float64 sum of |w| "
                         f"at {nb} bins, window ({start}, {cnt}): {rel}")
                max_err = max(max_err, err)
        # K3 on the first shard of the same bins
        shard = bins[:n_loc]
        ws = [w[:n_loc] for w in w_int]
        for leaf in (0, 1, 2):
            lid = torch.tensor([leaf], dtype=torch.int32, device=dev)
            p = hist_local_plain(row_leaf, lid, shard, *ws, nb)
            for name, pl in (
                    ("small", plan(n_loc, n_loc, small_max_rows=n_loc)),
                    ("large", plan(n_loc, n_loc, small_max_rows=-1)),
                    ("device", plan_device_local(n_loc, f, nb, num_sms=sms,
                                                 bin_bytes=2))):
                k = hist_local(row_leaf, lid, shard, *ws, nb, plan=pl,
                               leaf_rows=leaf_rows)
                torch.cuda.synchronize()
                if not torch.equal(k, p):
                    fail(f"uint16 K3 != plain under integer weights at {nb} "
                         f"bins, leaf {leaf}, {name} plan {pl}")
            lid = torch.tensor([leaf], dtype=torch.int32, device=dev)
            rows = torch.nonzero(row_leaf == leaf).view(-1)
            if rows.numel():
                rel, err = rel_err(hist_local(
                    row_leaf, lid, shard, *[w[:n_loc] for w in w_f32], nb,
                    leaf_rows=leaf_rows), rows, shard, nb)
                if rel > 1e-5:
                    fail(f"uint16 K3 beyond 1e-5 of the float64 sum of |w| "
                         f"at {nb} bins, leaf {leaf}: {rel}")
                max_err = max(max_err, err)
        lp = plan(n, small_max_rows=-1)
        phase("wide_hist_vs_plain", bins=nb, groups=lp.grid_y,
              group_width=lp.group_width, bin_slices=lp.grid_z,
              smem_bytes=lp.smem_bytes, exact_int=True,
              f32_within_1e_5_of_sum_abs=True)
        if nb != WIDE_BINS:
            continue
        for start, cnt in ((0, n), (40000, 4097)):
            sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
            idx = order[start:start + cnt].long()
            flat = (bin_rows(bins, idx) + torch.arange(f, device=dev) * nb
                    ).reshape(-1)
            vals = torch.stack([w[idx] for w in w_f32], -1)[:, None, :
                                                            ].expand(
                -1, f, 3).reshape(-1, 3).contiguous()
            acc = torch.zeros((f * nb, 3), device=dev)
            timing[("k1", cnt)] = t = time_kernel(
                lambda: hist_window(order, sc, bins, *w_f32, nb, cnt),
                lambda: hist_window_plain(order, sc, bins, *w_f32, nb),
                lambda: acc.index_add_(0, flat, vals),
                wide_bound_ms(cnt, f, nb),
                lambda: hist_window(order, sc, bins, *w_f32, nb, cnt,
                                    plan(n)))
            phase("wide_hist_time", kernel="hist_window", bins=nb,
                  window_rows=cnt, **{k_: f"{v:.4f}" for k_, v in t.items()
                                      if isinstance(v, float)},
                  bound_share=f"{t['bound_ms'] / t['device_ms']:.4f}"
                  if t["device_ms"] else "not measured")
        ws = [w[:n_loc] for w in w_f32]
        for leaf in (0, 1):
            lid = torch.tensor([leaf], dtype=torch.int32, device=dev)
            rows = torch.nonzero(row_leaf == leaf).view(-1)
            flat = (bin_rows(shard, rows) + torch.arange(f, device=dev) * nb
                    ).reshape(-1)
            vals = torch.stack([w[rows] for w in ws], -1)[:, None, :
                                                          ].expand(
                -1, f, 3).reshape(-1, 3).contiguous()
            acc = torch.zeros((f * nb, 3), device=dev)
            timing[("k3", leaf)] = t = time_kernel(
                lambda: hist_local(row_leaf, lid, shard, *ws, nb,
                                   leaf_rows=leaf_rows),
                lambda: hist_local_plain(row_leaf, lid, shard, *ws, nb),
                lambda: acc.index_add_(0, flat, vals),
                wide_bound_ms(rows.numel(), f, nb, n_loc),
                lambda: hist_local(row_leaf, lid, shard, *ws, nb,
                                   plan=plan(n_loc, n_loc,
                                             small_max_rows=-1)))
            phase("wide_hist_time", kernel="hist_local", bins=nb,
                  shard_rows=n_loc, leaf_rows=rows.numel(),
                  **{k_: f"{v:.4f}" for k_, v in t.items()
                     if isinstance(v, float)},
                  bound_share=f"{t['bound_ms'] / t['device_ms']:.4f}"
                  if t["device_ms"] else "not measured")
        del flat, vals, acc
    return timing, max_err


def wide_route_meta(dev, f: int, nb: int, bundled: bool):
    """The feature meta of a uint16 matrix of ``f`` columns of ``nb``
    bins, missing types none, zero and NaN in turn; with ``bundled`` its
    last column is an EFB bundle of two features of 100 and 150 bins
    (slots 1-99 and 100-248), a bundle of 249 slots in a uint16 matrix."""
    import torch
    from lightgbm_tpu_torch.grower import FeatureMeta
    e = f + 1 if bundled else f
    num_bin = [nb] * f + ([150] if bundled else [])
    if bundled:
        num_bin[f - 1] = 100
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    meta = FeatureMeta(i32(num_bin), i32([k % 3 for k in range(e)]),
                       i32([(37 * k) % b for k, b in enumerate(num_bin)]))
    if not bundled:
        return meta
    return meta._replace(col=i32(list(range(f)) + [f - 1]),
                         offset=i32([-1] * (f - 1) + [1, 100]))


# pool rows of the wide route checks: (feature, threshold, default_left,
# categorical) on columns of missing type none, zero and NaN past bin 255,
# a categorical split whose bins-left row reaches past bin 255, and the two
# features of the bundled column
WIDE_SPLITS = [(0, 600, 1, False), (1, 300, 0, False), (2, 900, 1, False),
               (4, 0, 0, True), (27, 50, 1, False), (28, 30, 0, False)]


def check_wide_route(dev, rng):
    """Phase 2i, both route kernels on uint16 bins, bit for bit against
    their plain versions: ``route_window`` on the 1,000,000 x 28 matrix of
    1,023 bins (its last column a bundle) gathered through either order
    buffer, and on phase 19's 11,000,000 x 8 leaf-ordered matrix of 283
    bins at the root, every split of ``WIDE_SPLITS``; ``route_rows`` on
    the same 1,000,000 rows as four shards, each split's leaf routed
    and counted.  Times at both roots."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import movable
    from lightgbm_tpu_torch.ops.route import (route_rows, route_rows_plain,
                                              route_window,
                                              route_window_plain)
    n, f = N_ROWS, N_FEAT
    g_np = rng.integers(0, WIDE_BINS, (n, f))
    g_np[:, f - 1] = rng.integers(0, 249, n)           # the bundle's slots
    higgs = u16(g_np, dev)
    meta_g = wide_route_meta(dev, f, WIDE_BINS, True)
    si32 = torch.tensor([s[:3] for s in WIDE_SPLITS], dtype=torch.int32,
                        device=dev)
    scat = torch.tensor([s[3] for s in WIDE_SPLITS], device=dev)
    scatb = torch.from_numpy(rng.random((len(WIDE_SPLITS), WIDE_BINS))
                             < 0.5).to(dev)
    orders = [torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
              for _ in range(2)]
    fe = len(EXPO_CATEGORICAL) + 2
    expo = [u16(rng.integers(0, EXPO_WIDE_BINS, (N_EXPO, fe)), dev)
            for _ in range(2)]
    meta_e = wide_route_meta(dev, fe, EXPO_WIDE_BINS, False)
    # the Expo set's splits stay on its 8 columns; its categorical row is
    # the first 283 bins of the wide one
    si32_e = si32.clone()
    si32_e[:, 0] = torch.tensor([0, 1, 2, 4, 5, 6], dtype=torch.int32)
    si32_e[:, 1].clamp_(max=EXPO_WIDE_BINS - 2)
    scatb_e = scatb[:, :EXPO_WIDE_BINS].contiguous()
    sets = {"gathered_1023": (meta_g, si32, scatb, (higgs, higgs), orders,
                              [(12345, 0), (777, 1), (40000, 4097),
                               (300000, 100000), (0, n)]),
            "expo_ordered_283": (meta_e, si32_e, scatb_e, expo, (None, None),
                                 [(0, N_EXPO)])}
    out = torch.empty(N_EXPO, dtype=torch.bool, device=dev)
    ref = torch.empty_like(out)
    checked = 0
    for label, (meta, s32, sb, b2, o2, windows) in sets.items():
        for start, cnt in windows:
            sc = torch.tensor([start, cnt], dtype=torch.int64, device=dev)
            for par in (0, 1):
                odd = torch.tensor([par], dtype=torch.int32, device=dev)
                for leaf in range(len(WIDE_SPLITS)):
                    lt = torch.tensor([leaf], device=dev)
                    out.fill_(True)
                    ref.fill_(True)
                    route_window(sc, odd, lt, s32, scat, sb, meta, b2, o2,
                                 out)
                    route_window_plain(sc, odd, lt, s32, scat, sb, meta, b2,
                                       o2, ref)
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        fail(f"uint16 route kernel != plain at window "
                             f"({start}, {cnt}) of {label}, buffer {par}, "
                             f"split {WIDE_SPLITS[leaf]}")
                    checked += 1
    timing = {}
    for label, (meta, s32, sb, b2, o2, _), cnt in (
            ("expo_root", sets["expo_ordered_283"], N_EXPO),
            ("gathered_root", sets["gathered_1023"], n)):
        sc = torch.tensor([0, cnt], dtype=torch.int64, device=dev)
        odd = torch.tensor([1], dtype=torch.int32, device=dev)
        lt = torch.tensor([3], device=dev)         # the categorical split
        gathered = o2[0] is not None
        k = three_times(lambda: route_window(sc, odd, lt, s32, scat, sb,
                                             meta, b2, o2, out))
        p_ms = cuda_ms(lambda: route_window_plain(sc, odd, lt, s32, scat,
                                                  sb, meta, b2, o2, ref),
                       reps=3)
        # each position's order entry (gathered), 2-byte bin and output
        # byte; the window, parity, leaf, split and bins-left rows
        nbytes = (cnt * ((4 if gathered else 0) + 3) + 16 + 4 + 8 + 12 + 1
                  + sb.shape[1])
        timing[label] = dict(k, plain_ms=p_ms,
                             bound_ms=nbytes / H100_BYTES_PER_S * 1e3)
    phase("wide_route_vs_plain", sets=",".join(sets), calls_checked=checked,
          exact=True, **{f"{w}_{k_}": f"{v:.5f}" for w, d in timing.items()
                         for k_, v in d.items() if isinstance(v, float)})
    del expo, out, ref

    # route_rows: the same rows as four shards, column-major
    shards, n_loc = 4, n // 4
    bins_t = movable(higgs).t().contiguous().view(torch.uint16)
    leaves = len(WIDE_SPLITS) + 2
    rl_np = rng.integers(0, len(WIDE_SPLITS), n).astype(np.int32)
    counts_np = np.stack([np.bincount(rl_np[i * n_loc:(i + 1) * n_loc],
                                      minlength=leaves) for i in
                          range(shards)]).astype(np.int32)
    new = torch.tensor([leaves - 1], device=dev)
    si32_r = torch.cat([si32, torch.zeros((2, 3), dtype=torch.int32,
                                          device=dev)])
    scat_r = torch.cat([scat, torch.zeros(2, dtype=torch.bool, device=dev)])
    scatb_r = torch.cat([scatb, torch.zeros((2, WIDE_BINS), dtype=torch.bool,
                                            device=dev)])
    for leaf in range(len(WIDE_SPLITS)):
        lt = torch.tensor([leaf], device=dev)
        rk, rp = (torch.from_numpy(rl_np).to(dev) for _ in range(2))
        ck, cp = (torch.from_numpy(counts_np).to(dev) for _ in range(2))
        route_rows(rk, bins_t, lt, new, si32_r, scat_r, scatb_r, meta_g, ck)
        route_rows_plain(rp, bins_t, lt, new, si32_r, scat_r, scatb_r,
                         meta_g, cp)
        torch.cuda.synchronize()
        if not (torch.equal(rk, rp) and torch.equal(ck, cp)):
            fail(f"uint16 route_rows != plain on split {WIDE_SPLITS[leaf]}")
    # timed with the new leaf = the leaf (the map stays as it is), as
    # phase 2g times it; the bound counts the rows the split moves
    lt = torch.tensor([3], device=dev)
    rl = torch.from_numpy(rl_np).to(dev)
    ck = torch.from_numpy(counts_np).to(dev)
    probe = rl.clone()
    route_rows_plain(probe, bins_t, lt, new, si32_r, scat_r, scatb_r,
                     meta_g, ck.clone())
    moved = int((probe != rl).sum())
    leaf_rows = int((rl == 3).sum())
    k = three_times(lambda: route_rows(rl, bins_t, lt, lt, si32_r, scat_r,
                                       scatb_r, meta_g, ck))
    p_ms = cuda_ms(lambda: route_rows_plain(rl, bins_t, lt, lt, si32_r,
                                            scat_r, scatb_r, meta_g, ck),
                   reps=3)
    # each row's row_leaf entry, the leaf's 2-byte bins (a 32-byte sector
    # a scattered row, at most the column), each moved row's entry; the
    # leaf, new leaf, split and bins-left rows and the bundle maps
    nbytes = (4 * n + min(32 * leaf_rows, 2 * n) + 4 * moved + 8 + 8 + 12
              + 1 + WIDE_BINS + 8)
    timing["rows_root"] = dict(k, plain_ms=p_ms,
                               bound_ms=nbytes / H100_BYTES_PER_S * 1e3)
    phase("wide_route_rows_vs_plain", rows=n, shards=shards,
          splits=len(WIDE_SPLITS), exact=True,
          **{k_: f"{v:.5f}" for k_, v in timing["rows_root"].items()
             if isinstance(v, float)})
    return timing


def check_wide_cat_group(dev, rng, positions=4096):
    """Phase 2i, ``cat_group`` at T = 4,096 positions (2 leaves x 8
    features x 2 directions; a lane walked in three staged chunks) at
    two count scales, and at 4,097 (a ragged last chunk): accepts
    identical to the plain loop's.  Time at 4,096, with its byte
    bound."""
    import torch
    from lightgbm_tpu_torch.ops.split import (cat_group_accept,
                                              cat_group_accept_plain)
    shape = (2, len(EXPO_CATEGORICAL) + 2, 2, positions)

    def inputs(shape, mean_cnt):
        step = torch.from_numpy(rng.poisson(mean_cnt, shape).astype(
            np.float32)).to(dev)
        ok = torch.from_numpy(rng.random(shape) < 0.8).to(dev)
        rc = torch.from_numpy(rng.integers(0, 10 ** 6, shape).astype(
            np.float32)).to(dev)
        m0 = torch.from_numpy(np.maximum(1.0, np.floor(rng.integers(
            1, 10 ** 6, shape[:-1]) / 64.0)).astype(np.float32)).to(dev)
        return step, ok, rc, m0

    cases = {"mean_count_40": inputs(shape, 40.0),
             "mean_count_4000": inputs(shape, 4000.0),
             "4097_positions": inputs(shape[:-1] + (positions + 1,), 400.0)}
    for name, args in cases.items():
        k = cat_group_accept(*args, 64)
        p = cat_group_accept_plain(*args, 64)
        torch.cuda.synchronize()
        if k.dtype != torch.bool or not torch.equal(k, p):
            fail(f"cat_group kernel != plain loop at {name}")
    size = int(np.prod(shape))
    bound_ms = (size * 10 + size // positions * 4) / H100_BYTES_PER_S * 1e3
    args = cases["mean_count_4000"]
    t = three_times(lambda: cat_group_accept(*args, 64))
    p_ms = cuda_ms(lambda: cat_group_accept_plain(*args, 64), reps=1,
                   warmup=0)
    phase("wide_cat_group_vs_plain", shape="x".join(map(str, shape)),
          cases=",".join(cases), exact=True,
          **{k_: f"{v:.4f}" for k_, v in t.items() if v is not None},
          plain_ms=f"{p_ms:.1f}", bound_ms=f"{bound_ms:.6f}")
    return dict(t, plain_ms=p_ms, bound_ms=bound_ms)


def check_wide_partition(dev, rng):
    """Phase 2i, K2 with phase 19's ordered payload: order, 8 uint16 bin
    columns and three f32 weights (2 x 8 + 12 = 28 bytes of payload, 32
    with order), bit for bit against the plain version over the grid of
    all 11,000,000 rows at both parities, on windows either side of the
    small launch's limit; time at the root."""
    import torch
    from lightgbm_tpu_torch.ops.partition import (SMALL_MAX_ROWS,
                                                  partition_scratch,
                                                  partition_window,
                                                  partition_window_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    n, fe = N_EXPO, len(EXPO_CATEGORICAL) + 2

    def matrices():
        return [torch.randperm(n, device=dev, generator=gen).int(),
                u16(rng.integers(0, EXPO_WIDE_BINS, (n, fe)), dev),
                *[torch.randn(n, device=dev, generator=gen)
                  for _ in range(3)]]
    pair = (matrices(), matrices())
    widths = [x[0].numel() * x.element_size() for x in pair[0]]
    scratch = partition_scratch(n, dev)
    ref = [torch.empty_like(x) for x in pair[0]]
    odd = [torch.tensor([p], dtype=torch.int32, device=dev) for p in (0, 1)]
    checked = 0
    for start, cnt in ((777, 1), (40000, 4097), (7, SMALL_MAX_ROWS),
                       (101, SMALL_MAX_ROWS + 1), (0, n)):
        sc = torch.tensor([start, cnt], dtype=torch.int64, device=dev)
        w = slice(start, start + cnt)
        gl = torch.rand(n, device=dev, generator=gen) < 0.43
        for par in (0, 1):
            src, dst = pair[par], pair[1 - par]
            npl = partition_window_plain(src, ref, start, cnt, gl)
            nk = partition_window(pair[0], pair[1], sc, gl, n, scratch,
                                  odd[par])
            torch.cuda.synchronize()
            if not torch.equal(nk, npl) or not all(
                    torch.equal(bits(a[w]), bits(b[w]))
                    for a, b in zip(dst, ref)):
                fail(f"partition kernel != plain with the 28-byte payload "
                     f"at window ({start}, {cnt}), parity {par}")
            checked += 1
    sc = torch.tensor([0, n], dtype=torch.int64, device=dev)
    gl = torch.rand(n, device=dev, generator=gen) < 0.43
    key = (~gl).to(torch.uint8)
    src, dst = pair
    k = three_times(lambda: partition_window(src, dst, sc, gl, n, scratch))
    lib = three_times(lambda: torch.sort(key, stable=True))
    p_ms = cuda_ms(lambda: partition_window_plain(src, dst, 0, n, gl),
                   reps=3)
    nbytes = part_bound_bytes(n, widths)
    t = dict(k, plain_ms=p_ms, library_ms=lib["ms"],
             bound_ms=nbytes / H100_BYTES_PER_S * 1e3)
    phase("wide_partition_vs_plain", rows=n, row_bytes=sum(widths),
          calls_checked=checked, exact=True,
          **{k_: f"{v:.4f}" for k_, v in t.items()
             if isinstance(v, float) and k_ != "bound_ms"},
          bound_bytes=nbytes, bound_ms=f"{t['bound_ms']:.5f}")
    return t


def check_wide_kernels(dev, rng):
    """Phase 2i: every kernel of the uint16 paths against its plain
    version on the card; returns their times for the kernels line."""
    import torch
    out = {}
    out["hist"], out["hist_err"] = check_wide_hist(dev, rng)
    torch.cuda.empty_cache()
    out["route"] = check_wide_route(dev, rng)
    torch.cuda.empty_cache()
    out["cat_group"] = check_wide_cat_group(dev, rng)
    out["partition"] = check_wide_partition(dev, rng)
    torch.cuda.empty_cache()
    return out



# ---- phases 18 and 19: the uint16 bin matrix at full width -----------------

def higgs_wide_path(params, names, x_tr, y_tr, x_te, y_te, sub=50_000):
    """Phase 18: the Higgs-shaped task at ``max_bin=1023`` (a uint16 bin
    matrix of 1,000,000 x 28, a histogram of 28 x 1,023 x 3 f32 a leaf),
    10 rounds by the serial graph loop (``partition_impl=compact``) and by
    the 4x1 data-parallel learner on the one card (K3, ``route_rows``).
    Under integer-valued gradients (every sum exact in any order) one
    round's tree on ``sub`` rows is the CPU port's, by the serial loop and
    over 4x1, and on all rows the 4x1 tree is the serial tree; the
    held-out AUC is within 1e-4 of the CPU port's on ``sub`` rows (3
    rounds, as phase 4), and the 4x1 path's within 1e-4 of the serial
    path's."""
    import torch
    from lightgbm_tpu_torch import Dataset
    p18 = dict(params, max_bin=WIDE_BINS, partition_impl="compact")
    dp_p = dict(p18, tree_learner="data", mesh_devices=MESH_SLOTS,
                mesh_shape="4x1")
    serial, _, ds = train_path("higgs_1023", p18, x_tr, y_tr, x_te, y_te,
                               10, names)
    if ds.bins.dtype != torch.uint16:
        fail(f"phase 18: a {ds.bins.dtype} bin matrix at max_bin=1023")
    phase("higgs_1023_path", max_num_bin=ds.constructed.max_num_bin(),
          bin_matrix_bytes=ds.bins.numel() * ds.bins.element_size(),
          **serial)
    dp, _, _ = train_path("higgs_1023_dp_4x1", dp_p, x_tr, y_tr, x_te, y_te,
                          10, names, ds=ds)
    gap = abs(float(dp["heldout_auc"]) - float(serial["heldout_auc"]))
    phase("higgs_1023_dp_4x1", auc_gap_vs_serial=f"{gap:.3e}", **dp)
    if gap > 1e-4:
        fail(f"phase 18: the 4x1 AUC {dp['heldout_auc']} is more than 1e-4 "
             f"from the serial path's {serial['heldout_auc']}")
    cpu_p = dict(p18, device="cpu")
    small = Dataset(x_tr[:sub], y_tr[:sub], params=p18).construct()
    integer_round_identical("higgs_1023_integer_trees", [
        (cpu_p, Dataset(x_tr[:sub], y_tr[:sub], params=cpu_p).construct()),
        (p18, small), (dp_p, small)])
    integer_round_identical("higgs_1023_integer_trees_4x1",
                            [(p18, ds), (dp_p, ds)])
    phase("higgs_1023_integer_trees", cpu_serial_4x1_rows=sub,
          serial_4x1_rows=len(y_tr), identical=True)
    del small
    card_vs_cpu("higgs_1023_card_vs_cpu", p18, x_tr[:sub], y_tr[:sub],
                x_te[:sub], y_te[:sub], ("split_feature", "threshold"), 1e-4,
                1e-4)
    return serial, dp


def cat_splits_past_255(bst, td) -> int:
    """Categorical nodes of ``bst`` that route a bin past 255 left."""
    out = 0
    for tree in bst.inner.models:
        for i in range(tree.num_leaves - 1):
            if tree.is_categorical(i):
                m = td.bin_mappers[int(tree.split_feature[i])]
                out += bool(tree.cat_bin_mask(i, m, m.num_bin)[256:].any())
    return out


def expo_wide_path(params, names, sub=50_000):
    """Phase 19: the Expo-shaped task over the full airport tail
    (``expo_like(full_tail=True)``: Origin and Dest over about 283 bins,
    a uint16 bin matrix), 11,000,000 rows and 100,000 held out, as phase 5
    trains it (compact, ``ordered_bins=on``, 10 rounds): K1, K2 moving
    2 x 8 + 12 = 28 bytes of payload a row, ``route_window`` on
    categorical splits past bin 255, and ``cat_group``.  Under
    integer-valued gradients the card's tree equals the CPU's on ``sub``
    rows; the held-out AUC within 5e-3 of the CPU's there (3 rounds, as
    phase 4b)."""
    import torch
    rng = np.random.default_rng(SEED + 13)
    t0 = time.perf_counter()
    x_all, y_all = expo_like(N_EXPO + N_HELDOUT, rng, full_tail=True)
    t_gen = time.perf_counter() - t0
    x_tr, y_tr = x_all[:N_EXPO], y_all[:N_EXPO]
    x_te, y_te = x_all[N_EXPO:], y_all[N_EXPO:]
    expo_params = dict(params, categorical_feature=EXPO_CATEGORICAL,
                       partition_impl="compact", ordered_bins="on",
                       enable_bundle=False, enable_bin_packing=False)
    out, bst, ds = train_path("expo_wide", expo_params, x_tr, y_tr, x_te,
                              y_te, 10, names)
    td = ds.constructed
    num_bins = [td.bin_mappers[j].num_bin for j in td.used_features]
    if ds.bins.dtype != torch.uint16 or max(num_bins) <= 256:
        fail(f"phase 19: a {ds.bins.dtype} bin matrix, columns of "
             f"{num_bins} bins")
    n_cat = sum(t.num_cat for t in bst.inner.models)
    if n_cat == 0:
        fail("phase 19: the model holds no categorical split")
    payload = sum(x[0].numel() * x.element_size()
                  for x in bst.inner._windows.bufs[0][1:])
    phase("expo_wide_path", generate_s=f"{t_gen:.3f}",
          num_bin=":".join(str(b) for b in num_bins),
          categorical_splits=n_cat,
          categorical_splits_past_bin_255=cat_splits_past_255(bst, td),
          payload_bytes_a_row=payload, **out)
    del bst, ds
    torch.cuda.empty_cache()
    grower_card_vs_cpu(expo_params, x_tr[:sub], y_tr[:sub],
                       "expo_wide_grower_card_vs_cpu")
    card_vs_cpu("expo_wide_card_vs_cpu", expo_params, x_tr[:sub], y_tr[:sub],
                x_te[:sub], y_te[:sub],
                ("split_feature", "threshold", "decision_type",
                 "left_child", "right_child", "leaf_value",
                 "cat_boundaries", "cat_threshold"), float("inf"), 5e-3)
    return out


def h2d_rate(dev) -> float:
    """The pinned host-to-device rate, bytes a second: one 1 GiB copy
    from page-locked memory, alone on the card (the median of three)."""
    import torch
    size = 1 << 30
    src = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(size, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), reps=3,
                 warmup=1)
    del src, dst
    torch.cuda.empty_cache()
    return size / (ms / 1e3)


def merged(intervals) -> list:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(iv, union, starts) -> float:
    """How much of interval ``iv`` the disjoint sorted ``union`` (whose
    intervals start at ``starts``) covers."""
    import bisect
    s, e = iv
    total = 0.0
    for i in range(max(0, bisect.bisect_right(starts, s) - 1), len(union)):
        a, b = union[i]
        if a >= e:
            break
        total += max(0.0, min(b, e) - max(a, s))
    return total


def kineto_span_us(e):
    """A raw profiler record's (start, end) in µs."""
    if hasattr(e, "end_ns"):
        return e.start_ns() / 1e3, e.end_ns() / 1e3
    return e.start_us(), e.start_us() + e.duration_us()


def stream_profile(fn):
    """Profile ``fn()`` (a streamed tree) under ``torch.profiler``: its
    wall seconds; the device-busy share (the union of every kernel's and
    copy's device interval over the wall); the kernels' union share; the
    host-to-device copies, their device ms and how much of it a kernel
    ran beside; the runtime's launch calls; and how many times each
    kernel of :data:`KERNELS` ran."""
    import torch
    import torch.profiler as tp
    # the card's activity and the runtime's calls only, read from the
    # profiler's raw records: a streamed tree makes some 50,000 to 150,000
    # launches, and the PyTorch ops' records and the processed events
    # would take minutes
    with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [(e.name(), e.device_type(), *kineto_span_us(e))
              for e in prof.profiler.kineto_results.events()]
    dev = [(n, a, b) for n, d, a, b in events
           if d == torch.autograd.DeviceType.CUDA and "spin_kernel" not in n]
    copies = [(a, b) for n, a, b in dev if "HtoD" in n]
    kernels = merged((a, b) for n, a, b in dev
                     if "Memcpy" not in n and "Memset" not in n)
    busy = sum(b - a for a, b in merged((a, b) for _, a, b in dev))
    starts = [a for a, _ in kernels]
    overlap = sum(covered(c, kernels, starts) for c in copies)
    copy_us = sum(b - a for a, b in copies)
    calls = {k: sum(1 for e in events if e[0] == k) for k in RUNTIME_CALLS}
    calls["cudaLaunchKernel"] -= MARKERS
    ran = {k: sum(1 for n, _, _ in dev if k in n)
           for k in sum(KERNELS.values(), ())}
    if not dev:
        return wall, dict(device_busy_share="not measured",
                          h2d_overlaps_kernel="not measured"), calls, ran
    kernel_us = sum(b - a for a, b in kernels)
    return wall, dict(
        device_busy_share=f"{busy / (wall * 1e6):.4f}",
        kernel_busy_share=f"{kernel_us / (wall * 1e6):.4f}",
        h2d_copies=len(copies), h2d_device_ms=f"{copy_us / 1e3:.3f}",
        h2d_overlapped_ms=f"{overlap / 1e3:.3f}",
        h2d_overlapped_share=f"{overlap / copy_us:.4f}" if copy_us else 0,
        h2d_overlaps_kernel=overlap > 0), calls, ran


def streamed_launches(snap, fns) -> dict:
    """Each wrapper's launches since ``snap`` (:func:`count_snapshot`)."""
    return {k: fn.launches - snap[0][k] for k, fn in fns.items()}


def stream_checked_profile(name, fns, grow_one, trees: int,
                           tries: int = 2):
    """:func:`stream_profile` of ``grow_one()`` (``trees`` trees), with the
    kernels the profiler saw run held against those the counts give (the
    profiler can lose records, so a call whose kernels differ is profiled
    again, up to ``tries`` calls), and a host-to-device copy required to
    overlap a kernel."""
    missed = []
    for _ in range(tries):
        snap = count_snapshot(fns)
        wall, prof, calls, ran = stream_profile(grow_one)
        want = kernels_launched(fns, snap, 0, {})
        if prof["h2d_overlaps_kernel"] == "not measured":
            fail(f"{name}: the profiler saw no device event")
        if ran == want:
            break
        missed.append({k: f"{ran[k]}/{v}" for k, v in want.items()
                       if ran[k] != v})
    else:
        fail(f"{name}: in {tries} profiled calls the kernels that ran on "
             f"the card differ from those the counts give (ran/counted): "
             f"{missed}")
    if not prof["h2d_overlaps_kernel"]:
        fail(f"{name}: no host-to-device copy overlapped a kernel in the "
             f"profiled tree: the double buffer overlaps nothing")
    return dict(profiled_ms_per_tree=f"{wall * 1e3 / trees:.2f}", **prof,
                trees_profiled_again=len(missed),
                **{f"{k}_calls_per_tree": f"{v / trees:g}"
                   for k, v in calls.items()})


def link_fields(rate: float, passes: int, nbytes: int, trees: int,
                ms_per_tree: float) -> dict:
    """The host link's share of a streamed tree: every pass moves the
    whole matrix, at the measured pinned rate."""
    bound = passes / trees * nbytes / rate * 1e3
    return dict(h2d_gb_per_s=f"{rate / 1e9:.3f}",
                link_bound_ms_per_tree=f"{bound:.2f}",
                link_share_of_wall=f"{bound / ms_per_tree:.4f}")


def streamed_tree_vs_resident(name, ds, y, chunks, rate, checks=True,
                              keep=None, **cfg_kw):
    """Phases 20a and 20c's tree: one tree under integer-valued gradients
    (sums exact in any order) grown by the resident graph loop and by the
    streamed grower over the Dataset's matrix in page-locked memory at
    each block size of ``chunks``: identical field by field and in the
    row -> leaf map (its gradients, meta, mask and tree appended to
    ``keep`` when given).  With ``checks``, at the first block size a second
    streamed tree runs under ``torch.cuda.set_sync_debug_mode("error")``
    (its one host read a split is an event wait, which the mode does not
    flag) and a third is profiled; ms a tree, blocks, bytes and host
    reads a tree, and
    ``route_rows`` and ``hist_local`` launches a tree held against the
    splits and blocks."""
    import torch
    from lightgbm_tpu_torch.data.stream import (BlockStreamer,
                                                HostBlockStore, pin_matrix)
    from lightgbm_tpu_torch.grower import (FeatureMeta, GrowerConfig,
                                           StreamedGrower, WindowBuffers,
                                           grow_tree)
    dev = torch.device("cuda", torch.cuda.current_device())
    td = ds.constructed
    fm = td.feature_meta()
    n, f = td.binned.shape
    rng = np.random.default_rng(SEED + 6)
    put = lambda a: torch.from_numpy(a).to(dev)
    g = put((np.where(y > 0, -3, 2) + rng.integers(-2, 3, n)).astype(
        np.float32))
    h = put(rng.integers(1, 4, n).astype(np.float32))
    c = torch.ones(n, dtype=torch.float32, device=dev)
    meta = FeatureMeta(put(fm["num_bin"]), put(fm["missing_type"]),
                       put(fm["default_bin"]), put(fm["is_categorical"]))
    fv = torch.ones(f, dtype=torch.bool, device=dev)
    cfg = GrowerConfig(
        num_leaves=255, min_data_in_leaf=1, min_sum_hessian_in_leaf=10.0,
        max_bin=td.max_num_bin(),
        has_missing=bool((fm["missing_type"] != 0).any()),
        has_categorical=bool(fm["is_categorical"].any()),
        partition_impl="compact", **cfg_kw)
    bins = (ds.bins if ds.bins is not None
            else torch.from_numpy(td.binned).to(dev))
    tree, rl = grow_tree(bins, g, h, c, meta, fv, cfg,
                         buffers=WindowBuffers(n, f, cfg, dev), loop="graph")
    del bins
    host = lambda tr, r: ({k: v.cpu().numpy() for k, v in tr._asdict().items()
                           if isinstance(v, torch.Tensor)}, r.cpu().numpy(),
                          tr.num_leaves)
    want = host(tree, rl)
    splits = want[2] - 1
    if splits < 1:
        fail(f"{name}: the resident integer tree made no split")
    pinned = pin_matrix(td.binned)
    fns = _kernel_wrappers()
    out = dict(rows=n, features=f, leaves=want[2])
    for i, chunk in enumerate(chunks):
        store = HostBlockStore(pinned, chunk)
        nb = store.num_blocks
        grower = StreamedGrower(cfg, BlockStreamer(store, dev))
        stats = {}
        runs = 3 if i == 0 and checks else 1
        for run in range(runs):
            snap = count_snapshot(fns)
            before = stats.get("splits", 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if run == 1:
                torch.cuda.set_sync_debug_mode("error")
            grown = None
            try:
                if run == 2:
                    prof = stream_checked_profile(
                        f"{name} chunk {chunk}", fns,
                        lambda: grower(g, h, c, meta, fv, stats), 1)
                else:
                    grown = grower(g, h, c, meta, fv, stats)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = None if grown is None else host(*grown)
            launches = streamed_launches(snap, fns)
            # trees grown in this run: a profile taken again grows two
            k = (stats["splits"] - before) // splits
            expect = {key: 0 for key in launches}
            expect.update(hist_local=k * (splits + 1) * nb,
                          route_rows=k * splits * nb,
                          cat_group_accept=(k * (splits + 1)
                                            if cfg.has_categorical else 0))
            if launches != expect:
                fail(f"{name} chunk {chunk}: launches {launches}, expected "
                     f"{expect}")
            if got is None:
                continue
            bad = [k for k in want[0] if not np.array_equal(want[0][k],
                                                            got[0][k])]
            if bad or want[2] != got[2] or not np.array_equal(want[1],
                                                              got[1]):
                fail(f"{name}: the streamed tree at {chunk}-row blocks != "
                     f"the resident graph loop's in "
                     f"{bad or 'num_leaves/row_leaf'}")
            if run == 0:
                out[f"ms_per_tree_{nb}_blocks"] = f"{ms:.2f}"
        trees = stats["splits"] // splits
        if stats["host_syncs"] != trees * (splits + (splits < 254)):
            fail(f"{name}: {stats['host_syncs']} host reads in {trees} "
                 f"trees of {splits} splits")
        if (stats["stream_blocks"] != trees * (splits + 1) * nb
                or stats["stream_bytes"] != trees * (splits + 1)
                * store.nbytes):
            fail(f"{name}: streamed {stats['stream_blocks']} blocks, "
                 f"{stats['stream_bytes']} bytes in {trees} trees")
        ms_tree = float(out[f"ms_per_tree_{nb}_blocks"])
        out.update({f"{k}_{nb}_blocks": v for k, v in dict(
            block_rows=f"{store.chunk_rows}:{store.block_rows()[-1]}",
            blocks_per_tree=(splits + 1) * nb,
            bytes_per_tree=(splits + 1) * store.nbytes,
            host_reads_per_tree=stats["host_syncs"] // trees,
            route_rows_launches_per_tree=splits * nb,
            hist_local_calls_per_tree=(splits + 1) * nb,
            **link_fields(rate, splits + 1, store.nbytes, 1,
                          ms_tree)).items()})
        if i == 0 and checks:
            out.update(sync_checked_trees=1, **prof)
        del grower
    out["identical_to_resident_graph"] = True
    if keep is not None:
        # phase 23b grows this tree again by the placement's streamed rung
        keep.extend([g, h, c, meta, fv, want])
    del pinned
    torch.cuda.empty_cache()
    return out


def stream_train(name, params, ds, x_te, y_te, rounds, quality, rate,
                 blocks: int, last_rows: int):
    """Phases 20b and 20c's training: ``train`` with
    ``data_stream=chunked`` at the default block size on a Dataset whose
    matrix is not on the card, ``rounds - 1`` rounds timed with the kernel
    counts set to 0 just before and read just after, then the last round
    profiled (``Booster.update``) and the model held to ``quality``.
    Held: the streamed grower ran (``blocks`` blocks, the last of
    ``last_rows`` rows); the
    matrix stayed off the card; ``hist_local`` launched once a block of
    every pass (root and splits), ``route_rows`` once a block of every
    split, ``cat_group`` once a tree and a split on categorical data, the
    lambdarank kernel once a round, nothing else; one host read a split
    (and one a tree that stopped early); every pass streamed every block;
    a host-to-device copy overlapped a kernel.  Returns its numbers and
    the booster."""
    import torch
    from lightgbm_tpu_torch import train
    fns = _kernel_wrappers()
    params = dict(params, data_stream="chunked")
    if ds.bins is not None:
        fail(f"{name}: the Dataset's matrix is on the card before training")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for fn in fns.values():
        fn.launches = 0
        for k in getattr(fn, "regime_launches", {}):
            fn.regime_launches[k] = 0
    t0 = time.perf_counter()
    bst = train(params, ds, num_boost_round=rounds - 1, verbose_eval=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    raw = {k: fn.launches for k, fn in fns.items()}
    inner = bst.inner
    if (inner._streamed is None or ds.bins is not None
            or inner.bins is not None):
        fail(f"{name}: not streamed, or the matrix went to the card")
    store = inner._streamer.store
    if (store.num_blocks, store.block_rows()[-1]) != (blocks, last_rows):
        fail(f"{name}: {store.num_blocks} blocks, the last of "
             f"{store.block_rows()[-1]} rows; expected {blocks} and "
             f"{last_rows}")
    st = dict(inner.stats)
    trees, splits, nb = st["trees"], st["splits"], store.num_blocks
    K = inner.num_class
    grown = inner.models[-trees:]
    L = inner.grower_cfg.num_leaves
    early = sum(1 for m in grown if m.num_leaves - 1 < L - 1)
    categorical = bool(ds.constructed.feature_meta()["is_categorical"].any())
    want = {k: 0 for k in raw}
    want.update(hist_local=(trees + splits) * nb, route_rows=splits * nb,
                cat_group_accept=trees + splits if categorical else 0,
                lambdarank_grad=(rounds - 1 if params["objective"]
                                 == "lambdarank" else 0))
    if raw != want:
        fail(f"{name}: kernel launches {raw}, expected {want}")
    if fns["hist_local"].regime_launches["device"] != raw["hist_local"]:
        fail(f"{name}: a hist_local call took a host-picked regime")
    if st["host_syncs"] != splits + early:
        fail(f"{name}: {st['host_syncs']} host reads for {splits} splits in "
             f"{trees} trees ({early} stopped early)")
    passes = trees + splits
    if (st["stream_passes"] != passes or st["stream_blocks"] != passes * nb
            or st["stream_bytes"] != passes * store.nbytes):
        fail(f"{name}: {st['stream_passes']} passes, {st['stream_blocks']} "
             f"blocks, {st['stream_bytes']} bytes for {passes} passes of "
             f"{nb} blocks")
    prof = stream_checked_profile(name, fns, bst.update, K)
    pred = bst.predict(x_te, num_iteration=rounds)
    if (pred.shape != ((len(y_te),) if K == 1 else (len(y_te), K))
            or not np.isfinite(pred).all()
            or bst.current_iteration() < rounds):
        fail(f"{name}: held-out predictions are not finite of the expected "
             f"shape after {rounds} rounds")
    ms_tree = t_train * 1e3 / trees
    out = dict(rows=store.num_rows, features=store.num_cols,
               timed_trees=trees, rounds=rounds, splits=splits, blocks=nb,
               route_rows_launches=raw["route_rows"],
               hist_local_calls=raw["hist_local"],
               block_rows=f"{store.chunk_rows}:{store.block_rows()[-1]}",
               matrix_bytes=store.nbytes,
               block_bytes=store.chunk_rows * store.num_cols
               * store.matrix.dtype.itemsize,
               ms_per_tree=f"{ms_tree:.2f}",
               blocks_per_tree=f"{passes * nb / trees:g}",
               bytes_per_tree=f"{passes * store.nbytes / trees:g}",
               host_reads_per_tree=f"{st['host_syncs'] / trees:g}",
               route_rows_launches_per_tree=f"{raw['route_rows'] / trees:g}",
               hist_local_calls_per_tree=f"{raw['hist_local'] / trees:g}",
               hist_local_launches_per_tree=(
                   f"{2 * raw['hist_local'] / trees:g}"),
               peak_mem_bytes=peak, **memory_fields(bst, peak, base),
               downgrades=";".join(d["requested"] for d in inner.downgrades),
               **link_fields(rate, passes, store.nbytes, trees, ms_tree),
               **quality(bst, pred, x_te, y_te), **prof)
    return out, bst


def wide_kernel_fields(name: str, wide: dict, serial: dict, dp: dict,
                       expo: dict) -> dict:
    """The kernels line's uint16 fields of kernel ``name``: its launches
    on phases 18 and 19 (their counts, as the main path's) and its times,
    bound and PyTorch yardstick from phase 2i."""
    h = wide["hist"]
    if name == "hist_gather":
        t, s = h[("k1", N_ROWS)], h[("k1", 4097)]
        launches = (serial["hist_window_launches"]
                    + expo["hist_window_launches"])
        extra = dict(u16_ms_4097=s["ms"], u16_device_ms_4097=s["device_ms"],
                     u16_bound_ms_4097=s["bound_ms"],
                     u16_library_ms_4097=s["library_ms"],
                     u16_max_abs_err=wide["hist_err"])
    elif name == "hist_local":
        t, s = h[("k3", 0)], h[("k3", 1)]
        launches = 2 * dp["hist_local_launches"]
        extra = dict(u16_ms_leaf=s["ms"], u16_device_ms_leaf=s["device_ms"],
                     u16_bound_ms_leaf=s["bound_ms"],
                     u16_library_ms_leaf=s["library_ms"])
    elif name == "partition":
        t, extra = wide["partition"], {}
        launches = 3 * expo["partition_window_launches"]
    elif name == "cat_group":
        t, extra = wide["cat_group"], {"u16_positions": 4096}
        launches = expo["cat_group_accept_launches"]
    elif name == "route":
        t = wide["route"]["expo_root"]
        g = wide["route"]["gathered_root"]
        launches = (serial["route_window_launches"]
                    + expo["route_window_launches"])
        extra = dict(u16_ms_gathered_root=g["ms"],
                     u16_device_ms_gathered_root=g["device_ms"],
                     u16_bound_ms_gathered_root=g["bound_ms"])
    else:
        t, extra = wide["route"]["rows_root"], {}
        launches = dp["route_rows_launches"]
    return dict(u16_launches=launches, u16_ms=t["ms"],
                u16_device_ms=t["device_ms"], u16_plain_ms=t["plain_ms"],
                u16_bound_ms=t["bound_ms"],
                u16_library_ms=t.get("library_ms"), **extra)


# ---- phases 21 and 22: the voting learner, training over processes ---------

VOTE_TOP_K = 20     # LightGBM's default top_k


def voting_tree_vs_data(ds, y) -> dict:
    """Phase 21a: one tree of the Higgs path under integer-valued gradients
    and hessians grown by the voting learner over the 4x1 mesh of the one
    card with ``top_k=20`` (28 features: each of the 4 voters votes 20, the
    top 40 votes name every feature that any voter voted), and by the
    data-parallel learner over the same mesh (phase 6's tree), both on the
    graph loop: identical field by field, row -> leaf maps too; the voting
    loop's replays under ``torch.cuda.set_sync_debug_mode("error")``."""
    import torch
    from lightgbm_tpu_torch.grower import FeatureMeta, GrowerConfig
    from lightgbm_tpu_torch.parallel.gspmd import GspmdGrower
    from lightgbm_tpu_torch.parallel.mesh import make_named_mesh, mesh_slots
    dev = ds.bins.device
    td = ds.constructed
    fm = td.feature_meta()
    n = len(y)
    g, h = (torch.from_numpy(a).to(dev) for a in integer_gradients(y))
    c = torch.ones(n, dtype=torch.float32, device=dev)
    put = lambda a: torch.from_numpy(a).to(dev)
    meta = FeatureMeta(put(fm["num_bin"]), put(fm["missing_type"]),
                       put(fm["default_bin"]), put(fm["is_categorical"]))
    fv = torch.ones(len(fm["num_bin"]), dtype=torch.bool, device=dev)
    cfg = GrowerConfig(num_leaves=255, min_data_in_leaf=1,
                       min_sum_hessian_in_leaf=10.0, max_bin=td.max_num_bin(),
                       has_missing=bool((fm["missing_type"] != 0).any()))
    mesh = make_named_mesh(MESH_SLOTS, 1, mesh_slots(MESH_SLOTS, dev))
    out, trees = {}, {}
    for name, top_k in (("data", None), ("voting", VOTE_TOP_K)):
        grower = GspmdGrower(cfg, mesh, ds.bins, top_k=top_k)
        stats, ms = {}, []
        for k in range(3):      # the capture, then two replayed trees
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if k:
                torch.cuda.set_sync_debug_mode("error")
            try:
                tree, row_leaf = grower(g, h, c, meta, fv, stats, "graph")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        trees[name] = ({k: v.cpu().numpy() for k, v in tree._asdict().items()
                        if isinstance(v, torch.Tensor)},
                       row_leaf.cpu().numpy(), tree.num_leaves)
        out[f"{name}_ms_per_tree"] = ",".join(f"{v:.2f}" for v in ms[1:])
        out[f"{name}_host_reads_per_tree"] = f"{stats['host_syncs'] / 3:.3f}"
        if grower.graph is None or grower.captures != 1:
            fail(f"voting_tree_vs_data: the {name} learner captured "
                 f"{grower.captures} steps")
        del grower
    want, got = trees["data"], trees["voting"]
    bad = [k for k in want[0] if not np.array_equal(want[0][k], got[0][k])]
    if want[2] != got[2] or not np.array_equal(want[1], got[1]):
        bad.append("num_leaves/row_leaf")
    out.update(leaves=want[2], identical=not bad, top_k=VOTE_TOP_K,
               voters=MESH_SLOTS, sync_checked_replay_trees=2)
    phase("voting_tree_vs_data_4x1", **out)
    if bad:
        fail(f"the voting learner's integer tree (top_k={VOTE_TOP_K}, every "
             f"feature voted) != the data-parallel tree: {bad[:5]}")
    return out


def integer_gradients(y: np.ndarray):
    """Integer-valued gradients and hessians of the Higgs path's rows, the
    same in every process (phase 6c's): exact sums in any order."""
    rng = np.random.default_rng(SEED + 5)
    g = (np.where(y > 0, -3, 2) + rng.integers(-2, 3, len(y))).astype(
        np.float32)
    return g, rng.integers(1, 4, len(y)).astype(np.float32)


def summed_bytes_per_split(inner) -> int:
    """The histogram bytes a split sums across the voters or shards: the
    data-parallel learner every shard's partial of the smaller child (its
    storage columns at the histogram's width); the voting learner, for
    both children, each voter's vote (``k`` gains and features) and its
    histograms of the ``2k`` voted features."""
    gr = inner._gspmd
    shards = len(gr.mesh.devices)
    cols = sum(len(c) for c in gr.cols)
    if not gr.voting:
        return shards * cols * gr.hist_width * 3 * 4
    k = min(gr.pool.top_k, gr.pool.f)
    return 2 * shards * (k * 2 * 4 + 2 * k * gr.cfg.max_bin * 3 * 4)


def mslr_voting(rank_params, ds, x_tr, y_tr, x_te, y_te, sizes_te,
                names) -> dict:
    """Phase 21b: phase 8's Dataset (packed at the defaults) by the
    voting learner over 4x1 on the one card with ``top_k=20`` (40 of 137
    features voted a leaf) and by the data-parallel learner over the same
    mesh, 3 rounds each: held-out NDCG@10 within 5e-3 (the bound of
    tests/test_parallel.py:124-133 for the approximate voting learner), ms
    a tree, the histogram bytes a split sums, the peak device memory (set
    up's in both runs: the slots' copies of the bins) and the pool's
    histogram store of each."""
    quality = lambda b, pred, x, y: {
        "heldout_ndcg@10": f"{ndcg_at(pred, y, sizes_te, [10])[0]:.6f}"}
    out = {}
    for name, learner in (("data", "data"), ("voting", "voting")):
        p = dict(rank_params, tree_learner=learner, top_k=VOTE_TOP_K,
                 mesh_devices=MESH_SLOTS, mesh_shape="4x1")
        res, bst, _ = train_path(f"mslr_{name}_4x1", p, x_tr, y_tr, x_te,
                                 y_te, 3, names, quality=quality, ds=ds,
                                 profile=False)
        if bst.inner.packed is None:
            fail(f"mslr {name} 4x1: the storage matrix did not pack")
        pool = bst.inner._gspmd.pool.hist_store
        out[name] = dict(res, summed_bytes_per_split=summed_bytes_per_split(
            bst.inner), parallel_impl=bst.inner.parallel_impl,
            pool_bytes=pool.numel() * pool.element_size())
        del bst
    gap = abs(float(out["voting"]["heldout_ndcg@10"])
              - float(out["data"]["heldout_ndcg@10"]))
    phase("mslr_voting_4x1", top_k=VOTE_TOP_K, voted_features=2 * VOTE_TOP_K,
          ndcg10_gap_vs_data=f"{gap:.3e}",
          data_ms_per_tree=out["data"]["ms_per_tree"],
          data_summed_bytes_per_split=out["data"]["summed_bytes_per_split"],
          data_peak_mem_bytes=out["data"]["peak_mem_bytes"],
          data_pool_bytes=out["data"]["pool_bytes"], **out["voting"])
    if gap > 5e-3:
        fail(f"mslr voting: held-out NDCG@10 {gap} from the data-parallel "
             f"run's (limit 5e-3)")
    return out


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_ranks(world: int, spec: dict, timeout: float = 600.0) -> list:
    """This script again as ``world`` worker processes, ranks 0 to world - 1
    of a process group over a loopback machine list (``--worker``, read
    :func:`process_worker`): waits for them all, stops them all if one
    fails or outlives ``timeout`` seconds, and returns each rank's
    results."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="lgbt_ranks_")
    try:
        mlist = os.path.join(tmp, "mlist.txt")
        with open(mlist, "w") as f:
            f.write("".join(f"127.0.0.1 {_free_port()}\n"
                            for _ in range(world)))
        spec = dict(spec, world=world, mlist=mlist, dir=tmp)
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        procs = []
        for rank in range(world):
            env = dict(os.environ, LGBM_TPU_RANK=str(rank),
                       GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 spec_path], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        outs = [None] * world
        try:
            for rank, p in enumerate(procs):
                outs[rank] = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or text is None:
                fail(f"rank {rank} of {world} exited with {p.returncode}:\n"
                     f"{(text or '')[-4000:]}")
        res = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                res.append(json.load(f))
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def process_worker(spec_path: str) -> None:
    """One rank of phase 22 (or of ``--multi-card``'s four): phase 3's
    Higgs-shaped rows, this rank's share of them (a ``subset`` of the
    whole set's Dataset, so every rank bins with the serial fit's mappers),
    trained over the process group of ``spec["mlist"]``: for each learner
    of ``spec["learners"]`` (name: (integer tree or not, rounds)), one
    integer-gradient tree and that many rounds of the binary objective,
    their model texts, ms a tree, the collectives of one more tree timed,
    and the kernels' launches; with ``spec["findbin"]``, the mappers that the distributed
    FindBin fits to rows every rank holds.  Results go to
    ``<dir>/rank<r>.json``."""
    import torch
    from lightgbm_tpu_torch import Dataset, train
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.data.dataset import construct
    from lightgbm_tpu_torch.parallel import sync
    from lightgbm_tpu_torch.parallel.mesh import shutdown_distributed
    with open(spec_path) as f:
        spec = json.load(f)
    rank, world = int(os.environ["LGBM_TPU_RANK"]), spec["world"]
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    x_all, y_all = higgs_like(N_ROWS + N_HELDOUT, rng)
    x_tr, y_tr = x_all[:N_ROWS], y_all[:N_ROWS]
    del x_all, y_all
    g_all, h_all = integer_gradients(y_tr)
    lo, hi = rank * N_ROWS // world, (rank + 1) * N_ROWS // world
    params = spec["params"]
    # the serial fit's mappers, before the process group is up
    union = Dataset(x_tr, y_tr, params=params).construct()
    share = union.subset(np.arange(lo, hi)).construct()
    dist = dict(params, num_machines=world,
                machine_list_file=spec["mlist"])
    fns = _kernel_wrappers()
    out = {"rank": rank, "rows": hi - lo,
           "setup_s": f"{time.perf_counter() - t_start:.3f}"}
    for learner, (integer, rounds) in spec["learners"].items():
        full = learner == "feature"      # every rank holds every row
        ds, a, b = (union, 0, N_ROWS) if full else (share, lo, hi)
        p = dict(dist, tree_learner=learner, top_k=VOTE_TOP_K)
        for fn in fns.values():
            fn.launches = 0
        if integer:
            t0 = time.perf_counter()
            bst = train(p, ds, 1, fobj=lambda preds, data: (g_all[a:b],
                                                            h_all[a:b]),
                        verbose_eval=False)
            torch.cuda.synchronize()
            out[f"{learner}_integer_ms"] = (
                f"{(time.perf_counter() - t0) * 1e3:.2f}")
            out[f"{learner}_integer_model"] = bst.model_to_string()
        if rounds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst = train(p, ds, rounds, verbose_eval=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out[f"{learner}_ms_per_tree"] = (
                f"{wall * 1e3 / bst.inner.stats['trees']:.2f}")
            out[f"{learner}_model"] = bst.model_to_string()
            # one more tree with the collectives timed between syncs
            coll = bst.inner._gspmd.coll_stats
            coll.clear()
            coll["timed"] = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst.update()
            torch.cuda.synchronize()
            tree_ms = (time.perf_counter() - t0) * 1e3
            out[f"{learner}_timed_tree_ms"] = f"{tree_ms:.2f}"
            out[f"{learner}_collective_ms"] = (
                f"{coll.get('collective_s', 0.0) * 1e3:.2f}")
            out[f"{learner}_collective_share"] = (
                f"{coll.get('collective_s', 0.0) * 1e3 / tree_ms:.4f}")
            out[f"{learner}_collective_calls"] = coll.get(
                "collective_calls", 0)
            out[f"{learner}_collective_bytes"] = coll.get(
                "collective_bytes", 0)
        out[f"{learner}_launches"] = {k: fn.launches
                                      for k, fn in fns.items()}
        out["backend"] = bst.inner.dist_backend
        out["process_count"] = sync.process_count()
        out["device"] = str(bst.inner.device)
        del bst
    if spec.get("score_rounds"):
        # phase 24c's unsupervised reference: the data learner under the
        # score-following integer gradients; with --multi-card, a snapshot
        # set every 2 rounds and a resume from the set at 2 (the group
        # protocol over NCCL), byte-identical
        from lightgbm_tpu_torch import checkpoint
        rounds = spec["score_rounds"]
        p = dict(dist, tree_learner="data")
        fobj = score_integer_fobj(y_tr[lo:hi])
        t0 = time.perf_counter()
        bst = train(p, share, rounds, fobj=fobj, verbose_eval=False)
        out["data_score_model"] = bst.model_to_string()
        out["data_score_s"] = f"{time.perf_counter() - t0:.3f}"
        if spec.get("resume_check"):
            snap = os.path.join(spec["dir"], "snap", "m.txt")
            ps = dict(p, snapshot_freq=2, output_model=snap)
            a = train(ps, share, rounds, fobj=fobj, verbose_eval=False)
            t0 = time.perf_counter()
            b = train(ps, share, rounds, fobj=fobj, verbose_eval=False,
                      resume=checkpoint.shard_path(snap, 2, rank))
            out["resume_s"] = f"{time.perf_counter() - t0:.3f}"
            out["resume_identical"] = (a.model_to_string()
                                       == b.model_to_string()
                                       == out["data_score_model"])
            out["shard_bytes"] = os.path.getsize(
                checkpoint.shard_path(snap, 2, rank))
        del bst
    if spec.get("findbin"):
        # every rank holds the same rows: the distributed fit (rank r fits
        # features j = r mod P) equals the serial fit of those rows
        rows = x_tr[:spec["findbin"]]
        td = construct(rows, config_from_params(dist), label=y_tr[:len(rows)])
        out["findbin_mappers"] = [m.feature_info_str()
                                  for m in td.bin_mappers]
    out["seconds"] = f"{time.perf_counter() - t_start:.3f}"
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    # the group torn down before the interpreter exits, so that no
    # collective thread outlives it
    shutdown_distributed()


def two_processes(params, ds, x_tr, y_tr, x_te, y_te,
                  findbin_rows: int = 200_000) -> dict:
    """Phase 22: two processes on the one card (gloo carrying CUDA tensors:
    NCCL refuses two ranks on one card), each holding half of phase 3's
    rows (the data and voting learners) or all of them (the feature
    learner).  Held: the data learner's integer tree equal to the serial
    tree on all rows, its 3 rounds byte-identical on both ranks and their
    AUC within 1e-4 of the serial learner's; the voting learner's 3 rounds
    identical on both ranks; the feature learner's integer tree equal to
    the serial one and its round identical on both ranks; the distributed
    FindBin's mappers equal to the
    serial fit of the same rows; the data learner's ``SUP_ROUNDS`` rounds
    under the score-following integer gradients identical on both ranks
    (phase 24c's unsupervised reference, returned with the numbers).
    Reported: ms a tree, the collectives' share of a timed tree, the
    kernels' launches in the workers."""
    from lightgbm_tpu_torch import train
    from lightgbm_tpu_torch.data.dataset import construct
    from lightgbm_tpu_torch.config import config_from_params
    g_all, h_all = integer_gradients(y_tr)
    serial_int = train(params, ds, 1, fobj=lambda preds, data: (g_all, h_all),
                       verbose_eval=False).model_to_string()
    serial = train(params, ds, 3, verbose_eval=False)
    serial_auc = auc(serial.predict(x_te), y_te)
    mappers = [m.feature_info_str() for m in construct(
        x_tr[:findbin_rows], config_from_params(params),
        label=y_tr[:findbin_rows]).bin_mappers]
    t0 = time.perf_counter()
    # the voting learner's check is across the ranks; the feature
    # learner's the integer tree, with one round for the timed tree
    ranks = spawn_ranks(2, dict(params=params, learners={
        "data": (True, 3), "voting": (False, 3), "feature": (True, 1)},
        findbin=findbin_rows, score_rounds=SUP_ROUNDS))
    wall = time.perf_counter() - t0
    r0, r1 = ranks
    from lightgbm_tpu_torch import Booster
    data_auc = auc(Booster(model_str=r0["data_model"], params=dict(
        device=params["device"])).predict(x_te), y_te)
    checks = {
        "data_integer_tree_equals_serial":
            r0["data_integer_model"] == r1["data_integer_model"] == serial_int,
        "data_models_identical": r0["data_model"] == r1["data_model"],
        "voting_models_identical": r0["voting_model"] == r1["voting_model"],
        "feature_integer_tree_equals_serial":
            r0["feature_integer_model"] == r1["feature_integer_model"]
            == serial_int,
        "feature_models_identical": r0["feature_model"] == r1["feature_model"],
        "findbin_equals_serial":
            r0["findbin_mappers"] == r1["findbin_mappers"] == mappers,
        "score_models_identical":
            r0["data_score_model"] == r1["data_score_model"]}
    gap = abs(data_auc - serial_auc)
    out = dict(backend=r0["backend"], processes=r0["process_count"],
               devices=f"{r0['device']},{r1['device']}",
               rows=f"{r0['rows']},{r1['rows']}", spawn_to_exit_s=f"{wall:.1f}",
               worker_setup_s=f"{r0['setup_s']},{r1['setup_s']}",
               serial_auc=f"{serial_auc:.6f}", data_auc=f"{data_auc:.6f}",
               data_auc_gap=f"{gap:.3e}", data_score_s=r0["data_score_s"],
               **checks)
    for learner in ("data", "voting", "feature"):
        for k in ("integer_ms", "ms_per_tree", "timed_tree_ms",
                  "collective_ms", "collective_share", "collective_calls",
                  "collective_bytes"):
            if f"{learner}_{k}" in r0:
                out[f"{learner}_{k}"] = r0[f"{learner}_{k}"]
        for k, v in r0[f"{learner}_launches"].items():
            if v:
                out[f"{learner}_{k}_launches"] = v
    phase("two_processes_one_card", **out)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"two processes on one card: {bad}")
    if gap > 1e-4:
        fail(f"two processes: data-parallel AUC {data_auc} is {gap} from the "
             f"serial learner's {serial_auc} (limit 1e-4)")
    if r0["backend"] != "gloo":
        fail(f"two ranks on one card took backend {r0['backend']}, not gloo")
    for learner in ("data", "voting", "feature"):
        got = r0[f"{learner}_launches"]
        if not (got["hist_local"] and got["route_rows"]):
            fail(f"two processes, {learner}: kernel launches {got}")
    return out, r0["data_score_model"]


# ---- phases 24a-24c: checkpoints, preemption and the supervisor ----------

CKPT_ROUNDS, CKPT_FREQ = 8, 2     # 24a/24b: rounds, a snapshot every 2
SUP_ROUNDS = 5                    # 24c: rounds of the supervised group


def score_integer_fobj(y: np.ndarray):
    """Integer-valued gradients and hessians that follow the scores
    (phases 22, 24a-24c, ``--multi-card``): the label's -3 or 2 plus a
    step of the score, 1 to 3 for the hessian.  Every sum is exact in any
    order, so a tree on the card is the same in every run, and a resumed
    run, whose scores come back bit for bit, draws the uninterrupted run's
    gradients."""
    base = np.where(np.asarray(y) > 0, -3.0, 2.0)

    def fobj(preds, data):
        q = np.floor(np.asarray(preds, dtype=np.float64) * 8.0)
        return base + np.mod(q, 5.0) - 2.0, 1.0 + np.mod(q, 3.0)
    return fobj


def model_trees(text: str) -> list:
    """The ``Tree=`` blocks of a model text, in order, each stripped of
    the blank lines and sections after it."""
    for tail in ("end of trees", "feature importances:"):
        text = text.split(tail)[0]
    return [("Tree=" + b).strip() for b in text.split("Tree=")[1:]]


def iteration_recorder(rows: list):
    """A before-iteration callback that appends the booster's counters at
    the start of each iteration to ``rows``."""
    def record(env):
        rows.append(dict(env.model.inner.stats))
    record.before_iteration = True
    return record


def per_iteration(rows: list, final: dict) -> list:
    """Each iteration's counters: its tree and the snapshot after it."""
    marks = rows + [final]
    return [{k: b[k] - a.get(k, 0) for k in b}
            for a, b in zip(marks, marks[1:])]


class TimedWrites:
    """Times every single-file snapshot the engine writes while active
    (``checkpoint.write_snapshot``, which the engine calls through its
    module)."""

    def __enter__(self):
        from lightgbm_tpu_torch import checkpoint
        self.mod, self.real, self.seconds = (checkpoint,
                                             checkpoint.write_snapshot, [])

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            self.real(*args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
        checkpoint.write_snapshot = timed
        return self

    def __exit__(self, *exc):
        self.mod.write_snapshot = self.real


def checkpoint_resume(params, ds, y_tr, x_te, y_te) -> dict:
    """Phase 24a: phase 3's Dataset on the serial graph loop (compact),
    trained 8 rounds with a snapshot every 2, under the score-following
    integer gradients and then the binary objective: uninterrupted; again
    with ``fault_inject=torn_checkpoint@6`` (``SimulatedCrash``, the torn
    file at the final path); then ``train(resume=True)``, which must skip
    the torn 6 and resume at 4.  Held: the integer model byte-identical to
    the uninterrupted one; the binary run's first 4 trees byte-identical
    to those of the snapshot it resumed from and its held-out AUC within
    1e-4 of the uninterrupted run's (K1's float atomics make two runs on
    the card differ in the last bits, so its trees are compared with the
    uninterrupted run's and reported, not held); the data fingerprint of
    the card's bins equal to the host matrix's; on the binary runs
    (gradients from the card, no ``fobj`` read), every iteration after the
    first keeps 8 host reads and 254 graph launches a tree, those without
    a snapshot no snapshot read; the resumed runs launch K1, K2 and the
    route kernel.  Reported: the snapshot's bytes and write seconds."""
    import tempfile
    import torch
    from lightgbm_tpu_torch import checkpoint, train
    from lightgbm_tpu_torch.obs.counters import counters
    from lightgbm_tpu_torch.utils.faults import SimulatedCrash
    fns = _kernel_wrappers()
    tmp = tempfile.mkdtemp(prefix="lgbt_ckpt_")
    torn_at, resume_at = CKPT_ROUNDS - 2, CKPT_ROUNDS - 4
    out = {}
    try:
        for kind, fobj in (("integer", score_integer_fobj(y_tr)),
                           ("binary", None)):
            prefix = lambda run: os.path.join(tmp, kind, run, "m.txt")
            p = dict(params, snapshot_freq=CKPT_FREQ)
            rows = []
            with TimedWrites() as writes:
                t0 = time.perf_counter()
                ref = train(dict(p, output_model=prefix("ref")), ds,
                            CKPT_ROUNDS, fobj=fobj, verbose_eval=False,
                            callbacks=[iteration_recorder(rows)])
                torch.cuda.synchronize()
                ref_s = time.perf_counter() - t0
            its = per_iteration(rows, dict(ref.inner.stats))
            ref_text = ref.model_to_string()
            # the fingerprint of the bins on the card is the host matrix's
            td = ds.constructed
            fp_same = ref.inner.data_fingerprint() == \
                checkpoint.data_fingerprint(td.binned, td.num_data)
            ref_auc = auc(ref.predict(x_te), y_te)
            init = int(ref.inner.boost_from_average_)
            crash = prefix("crash")
            try:
                train(dict(p, output_model=crash,
                           fault_inject=f"torn_checkpoint@{torn_at}"),
                      ds, CKPT_ROUNDS, fobj=fobj, verbose_eval=False)
            except SimulatedCrash:
                pass
            else:
                fail(f"24a {kind}: torn_checkpoint@{torn_at} did not crash "
                     f"the run")
            try:
                checkpoint.load_snapshot(checkpoint.snapshot_path(crash,
                                                                  torn_at))
                fail(f"24a {kind}: snapshot {torn_at} is not torn")
            except checkpoint.CheckpointError:
                pass
            counters.reset()
            for fn in fns.values():
                fn.launches = 0
            t0 = time.perf_counter()
            res = train(dict(p, output_model=crash), ds, CKPT_ROUNDS,
                        fobj=fobj, verbose_eval=False, resume=True)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            launches = real_launches(
                {k: fn.launches for k, fn in fns.items()},
                loop_state(res.inner), res.inner.stats["graph_replays"], 1)
            resumed = [e["iteration"]
                       for e in counters.events("checkpoint_resume")]
            skipped = [e["iteration"]
                       for e in counters.events("checkpoint_skipped")]
            snap_text, _ = checkpoint.load_snapshot(
                checkpoint.snapshot_path(crash, resume_at))
            first = init + resume_at
            got = model_trees(res.model_to_string())
            restored = got[:first] == model_trees(snap_text)[:first]
            first_equal = got[:first] == model_trees(ref_text)[:first]
            res_auc = auc(res.predict(x_te), y_te)
            same = res.model_to_string() == ref_text
            size = os.path.getsize(checkpoint.snapshot_path(prefix("ref"),
                                                            CKPT_ROUNDS))
            out[kind] = {
                "snapshot_bytes": size,
                "write_s": ",".join(f"{t:.3f}" for t in writes.seconds),
                "uninterrupted_s": f"{ref_s:.3f}",
                "resumed_s": f"{resume_s:.3f}",
                "resumed_at": ",".join(map(str, resumed)),
                "skipped": ",".join(map(str, skipped)),
                "fingerprint_card_equals_host": fp_same,
                "model_identical": same, "restored_trees_exact": restored,
                "first_trees_equal_uninterrupted": first_equal,
                "auc": f"{ref_auc:.6f}", "resumed_auc": f"{res_auc:.6f}",
                **{f"{k}_launches": launches[k] for k in (
                    "hist_window", "partition_window", "route_window")}}
            if resumed != [resume_at] or torn_at not in skipped:
                fail(f"24a {kind}: resumed at {resumed}, skipped {skipped}")
            if not restored or not fp_same:
                fail(f"24a {kind}: the resumed model's first {resume_at} "
                     f"trees the snapshot's: {restored}; the fingerprint "
                     f"of the card's bins the host's: {fp_same}")
            if kind == "integer" and not same:
                fail("24a: the resumed integer model differs from the "
                     "uninterrupted one")
            if abs(res_auc - ref_auc) > 1e-4:
                fail(f"24a: resumed AUC {res_auc} is {abs(res_auc - ref_auc)}"
                     f" from the uninterrupted {ref_auc} (limit 1e-4)")
            for k in ("hist_window", "partition_window", "route_window"):
                if not launches[k]:
                    fail(f"24a {kind}: the resumed run launched no {k}")
            if kind == "binary":
                # iteration 0 holds the capture; a snapshot follows every
                # second iteration
                snap = [d for i, d in enumerate(its)
                        if i and (i + 1) % CKPT_FREQ == 0]
                plain = [d for i, d in enumerate(its)
                         if i and (i + 1) % CKPT_FREQ]
                for name, group in (("snapshot", snap), ("plain", plain)):
                    out[kind][f"{name}_iteration_host_reads"] = ",".join(
                        str(d["host_syncs"]) for d in group)
                    out[kind][f"{name}_iteration_graph_launches"] = ",".join(
                        str(d["graph_replays"]) for d in group)
                    out[kind][f"{name}_iteration_snapshot_reads"] = ",".join(
                        str(d["snapshot_host_reads"]) for d in group)
                bad = [d for d in snap + plain
                       if d["host_syncs"] != 8 or d["graph_replays"] != 254]
                bad += [d for d in plain if d["snapshot_host_reads"]]
                if bad:
                    fail(f"24a: iterations off 8 host reads and 254 graph "
                         f"launches a tree: {bad}")
            phase(f"checkpoint_resume_{kind}", **out[kind])
            if kind == "integer":      # phase 24b's reference
                out["integer_model"] = ref_text
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def preempt_worker(spec: dict) -> None:
    """Phase 24b's process: phase 3's Dataset trained on the card with
    ``preempt_signal=sigterm`` under the score-following integer
    gradients; after its second tree it tells the parent (``ready``) and
    waits for the parent's SIGTERM (``sent``), then the engine writes its
    checkpoint at the next boundary and leaves the loop."""
    from lightgbm_tpu_torch import Dataset, train
    rng = np.random.default_rng(SEED + 1)
    x_tr, y_tr = higgs_like(N_ROWS + N_HELDOUT, rng)
    x_tr, y_tr = x_tr[:N_ROWS], y_tr[:N_ROWS]
    ds = Dataset(x_tr, y_tr, params=spec["params"]).construct()
    ready = os.path.join(spec["dir"], "ready")
    sent = os.path.join(spec["dir"], "sent")

    def gate(env):
        if env.iteration == 1:
            open(ready, "w").close()
            deadline = time.monotonic() + 120
            while not os.path.exists(sent) and time.monotonic() < deadline:
                time.sleep(0.01)

    bst = train(dict(spec["params"], preempt_signal="sigterm",
                     output_model=os.path.join(spec["dir"], "m.txt")),
                ds, spec["rounds"], fobj=score_integer_fobj(y_tr),
                verbose_eval=False, callbacks=[gate])
    with open(os.path.join(spec["dir"], "result.json"), "w") as f:
        json.dump({"iteration": bst.current_iteration()}, f)


def preempt_sigterm(params, ds, y_tr, ref_text: str) -> dict:
    """Phase 24b: a real SIGTERM.  This script started with ``--worker``
    trains on the card (:func:`preempt_worker`); after its second tree the
    parent sends it SIGTERM; it must write its checkpoint at iteration 2
    and exit 0.  This process then resumes from that checkpoint (the
    Dataset built again in another process: the data fingerprint must
    agree) and finishes: the integer model byte-identical to 24a's."""
    import signal
    import tempfile
    import torch
    from lightgbm_tpu_torch import checkpoint, train
    from lightgbm_tpu_torch.obs.counters import counters
    tmp = tempfile.mkdtemp(prefix="lgbt_preempt_")
    try:
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(dict(mode="preempt", params=params, dir=tmp,
                           rounds=CKPT_ROUNDS), f)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             spec_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        ready, deadline = os.path.join(tmp, "ready"), time.monotonic() + 300
        while not os.path.exists(ready):
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                fail(f"24b: the worker never reached its second tree:\n"
                     f"{proc.communicate()[0][-4000:]}")
            time.sleep(0.02)
        t_ready = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        open(os.path.join(tmp, "sent"), "w").close()
        try:
            text = proc.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail("24b: the worker outlived SIGTERM by 300 s")
        t_exit = time.perf_counter()
        if proc.returncode != 0:
            fail(f"24b: the worker exited {proc.returncode} after SIGTERM:\n"
                 f"{text[-4000:]}")
        with open(os.path.join(tmp, "result.json")) as f:
            stopped = json.load(f)["iteration"]
        snap = os.path.join(tmp, "m.txt")
        if stopped != 2 or not os.path.exists(
                checkpoint.snapshot_path(snap, 2)):
            fail(f"24b: the worker stopped at {stopped}, snapshots "
                 f"{checkpoint.list_snapshots(snap)}")
        counters.reset()
        t0r = time.perf_counter()
        bst = train(dict(params, preempt_signal="sigterm",
                         output_model=snap), ds, CKPT_ROUNDS,
                    fobj=score_integer_fobj(y_tr), verbose_eval=False,
                    resume=True)
        torch.cuda.synchronize()
        t_res = time.perf_counter() - t0r
        resumed = [e["iteration"]
                   for e in counters.events("checkpoint_resume")]
        same = bst.model_to_string() == ref_text
        out = dict(worker_spawn_to_second_tree_s=f"{t_ready - t0:.3f}",
                   sigterm_to_exit_s=f"{t_exit - t_ready:.3f}",
                   stopped_at=stopped, resumed_at=",".join(map(str, resumed)),
                   resume_to_end_s=f"{t_res:.3f}", model_identical=same)
        phase("preempt_sigterm", **out)
        if resumed != [2] or not same:
            fail(f"24b: resumed at {resumed}; model identical {same}")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def supervised_worker(spec: dict) -> None:
    """One rank of phase 24c, started by the supervisor: phase 22's rows
    and learner (its share of the rows, binned with the whole set's
    mappers) over a gloo group on the one card, ``SUP_ROUNDS`` rounds of
    the score-following integer gradients with a snapshot every round,
    ``resume=True``; the first incarnation carries the fault.  It writes
    its model, the times of its legs and its launches to
    ``<dir>/rank<r>.attempt<a>.json``."""
    t_start = time.time()
    import torch
    from lightgbm_tpu_torch import Dataset, train
    from lightgbm_tpu_torch.obs.counters import counters
    from lightgbm_tpu_torch.parallel.mesh import shutdown_distributed
    rank = int(os.environ["LGBM_TPU_RANK"])
    attempt = int(os.environ["LGBM_TPU_SUPERVISOR_ATTEMPT"])
    world = spec["world"]
    rng = np.random.default_rng(SEED + 1)
    x_all, y_all = higgs_like(N_ROWS + N_HELDOUT, rng)
    x_tr, y_tr = x_all[:N_ROWS], y_all[:N_ROWS]
    del x_all, y_all
    lo, hi = rank * N_ROWS // world, (rank + 1) * N_ROWS // world
    union = Dataset(x_tr, y_tr, params=spec["params"]).construct()
    share = union.subset(np.arange(lo, hi)).construct()
    t_data = time.time()
    p = dict(spec["params"], tree_learner="data", num_machines=world,
             machine_list_file=spec["mlist"], snapshot_freq=1,
             output_model=spec["snap"], heartbeat_interval=0.5)
    if attempt == 0:
        p["fault_inject"] = spec["fault"]
    marks = {}

    def first(env):
        marks.setdefault("t_first_iteration", time.time())
        marks.setdefault("start_iteration", env.iteration)
    first.before_iteration = True
    fns = _kernel_wrappers()
    for fn in fns.values():
        fn.launches = 0
    t_train = time.time()
    bst = train(p, share, spec["rounds"], fobj=score_integer_fobj(y_tr[lo:hi]),
                verbose_eval=False, resume=True, callbacks=[first])
    torch.cuda.synchronize()
    out = dict(rank=rank, attempt=attempt, t_start=t_start, t_data=t_data,
               t_train=t_train, t_end=time.time(), **marks,
               model=bst.model_to_string(),
               resumed=[e["iteration"]
                        for e in counters.events("checkpoint_resume")],
               launches={k: fn.launches for k, fn in fns.items()},
               backend=bst.inner.dist_backend)
    with open(os.path.join(spec["dir"],
                           f"rank{rank}.attempt{attempt}.json"), "w") as f:
        json.dump(out, f)
    shutdown_distributed()


def supervised_restart(params, ref_text: str, fault="rank_crash@3:rank=1",
                       deadline_s: float = 420.0) -> dict:
    """Phase 24c: the supervisor runs two ranks of :func:`supervised_worker`
    that share the card over gloo; ``rank_crash@3:rank=1`` kills rank 1
    hard at iteration 3, before its snapshot.  The supervisor sees the
    death, tears rank 0 down (SIGTERM), relaunches both, and they resume
    from the set committed at 2 (or 3).  Held: one restart, both ranks
    resumed at the same committed set, the final integer model
    byte-identical on both ranks and to phase 22's unsupervised
    two-process run's.  Reported: the restart's wall seconds, split into
    detection to teardown, teardown to relaunch (triage, backoff, sweep,
    spawn) and relaunch to the first resumed iteration (the processes'
    start, the Dataset, the process group, the resume barrier and the
    restore), and each rank's legs of that last one."""
    import tempfile
    import threading
    from lightgbm_tpu_torch.obs.counters import counters
    from lightgbm_tpu_torch.parallel.mesh import refresh_local_ports
    from lightgbm_tpu_torch.supervisor import Supervisor

    legs = []

    class TimedSupervisor(Supervisor):
        """The supervisor with the wall clock of its restart's legs."""

        def _check(self):
            verdict = super()._check()
            if verdict not in (None, "done"):
                legs.append(("detected", time.time()))
            return verdict

        def _teardown(self):
            super()._teardown()
            legs.append(("torn_down", time.time()))

        def _launch(self):
            super()._launch()
            legs.append(("launched", time.time()))

    tmp = tempfile.mkdtemp(prefix="lgbt_sup_")
    try:
        mlist = os.path.join(tmp, "mlist.txt")
        with open(mlist, "w") as f:
            f.write("127.0.0.1 0\n127.0.0.1 0\n")
        snap = os.path.join(tmp, "snap", "m.txt")
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(dict(mode="supervised", params=params, world=2,
                           mlist=mlist, snap=snap, dir=tmp, fault=fault,
                           rounds=SUP_ROUNDS), f)
        counters.reset()
        sup = TimedSupervisor(
            [sys.executable, os.path.abspath(__file__), "--worker",
             spec_path], snap, 2, heartbeat_interval=0.5, hang_timeout=300,
            restart_limit=1, restart_backoff=0.5, term_grace=10.0,
            poll_interval=0.05,
            env=dict(GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo"),
            prelaunch=lambda s: refresh_local_ports(mlist))
        box = []
        t0 = time.time()
        th = threading.Thread(target=lambda: box.append(sup.run()),
                              daemon=True)
        th.start()
        th.join(deadline_s)
        if th.is_alive():
            sup.restart_limit = 0
            for rk in list(sup._ranks):
                rk.proc.kill()
            th.join(60)
        logs = ""
        for r in range(2):
            path = f"{snap}.rank_{r}.log"
            if os.path.exists(path):
                with open(path, errors="replace") as f:
                    logs += f"--- rank {r}\n{f.read()[-3000:]}\n"
        if box != [0]:
            fail(f"24c: the supervisor returned {box} after "
                 f"{time.time() - t0:.1f} s:\n{logs}")
        res = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.attempt1.json")) as f:
                res.append(json.load(f))
        dead = counters.events("rank_dead")
        restarts = counters.events("group_restart")
        at = dict(legs)
        first = max(r["t_first_iteration"] for r in res)
        out = dict(
            supervised_wall_s=f"{time.time() - t0:.1f}",
            rank_dead=",".join(f"{e['rank']}:{e['exit_code']}" for e in dead),
            restarts=len(restarts),
            resume_iteration=",".join(str(r["resumed"]) for r in res),
            detected_to_torn_down_s=f"{at['torn_down'] - at['detected']:.3f}",
            torn_down_to_relaunched_s=(
                f"{legs[-1][1] - at['torn_down']:.3f}"),
            relaunched_to_resumed_s=f"{first - legs[-1][1]:.3f}",
            **{f"rank{r['rank']}_{k}": v for r in res for k, v in (
                ("start_s", f"{r['t_start'] - legs[-1][1]:.3f}"),
                ("data_s", f"{r['t_data'] - r['t_start']:.3f}"),
                ("group_and_restore_s",
                 f"{r['t_first_iteration'] - r['t_train']:.3f}"),
                ("rounds_s", f"{r['t_end'] - r['t_first_iteration']:.3f}"))},
            backend=res[0]["backend"],
            models_identical=res[0]["model"] == res[1]["model"],
            equals_unsupervised=res[0]["model"] == ref_text,
            hist_local_launches_rank0=res[0]["launches"]["hist_local"],
            route_rows_launches_rank0=res[0]["launches"]["route_rows"])
        phase("supervised_restart", **out)
        if not (dead and dead[0]["rank"] == 1 and dead[0]["exit_code"] == 70
                and len(restarts) == 1):
            fail(f"24c: deaths {dead}, restarts {restarts}")
        if res[0]["resumed"] != res[1]["resumed"] or \
                res[0]["resumed"][0] not in (2, 3):
            fail(f"24c: the ranks resumed at {res[0]['resumed']} and "
                 f"{res[1]['resumed']}")
        if not (out["models_identical"] and out["equals_unsupervised"]):
            fail("24c: the supervised model differs across ranks or from "
                 "the unsupervised two-process run's")
        if not (res[0]["launches"]["hist_local"]
                and res[0]["launches"]["route_rows"]):
            fail(f"24c: rank 0's launches {res[0]['launches']}")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def worker(spec_path: str) -> None:
    """A process this script started: phase 22's and ``--multi-card``'s
    ranks, 24b's preempted training or 24c's supervised ranks."""
    with open(spec_path) as f:
        spec = json.load(f)
    mode = spec.get("mode", "ranks")
    if mode == "preempt":
        preempt_worker(spec)
    elif mode == "supervised":
        supervised_worker(spec)
    else:
        process_worker(spec_path)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    if sys.argv[1:2] == ["--worker"] and len(sys.argv) == 3:
        # a process that phase 22, 24b, 24c or --multi-card started
        worker(sys.argv[2])
        return
    multi = sys.argv[1:] == ["--multi-card"]
    if sys.argv[1:] and not multi:
        fail(f"unknown arguments {sys.argv[1:]}; the one option is "
             f"--multi-card")
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.ops.partition import LAUNCHES

    # ---- phase 0: the card ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    kind = torch.cuda.get_device_name(0)
    phase("card", nvidia_smi=repr(card), torch_device=repr(kind),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    for name in build.KERNEL_SOURCES:
        build.load(name)
    ptxas = " | ".join(line.strip() for text in logs.values()
                       for line in text.splitlines() if "Used" in line)
    phase("build", seconds=f"{time.perf_counter() - t0:.3f}",
          kernels=",".join(build.KERNEL_SOURCES), ptxas=repr(ptxas))
    params = dict(objective="binary", num_leaves=255, max_bin=N_BINS,
                  min_data_in_leaf=1, min_sum_hessian_in_leaf=100,
                  learning_rate=0.1, verbose=0, device="cuda")
    if multi:
        multi_card(params)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return

    # ---- phase 2: histogram kernel vs plain on the card -------------------
    rng = np.random.default_rng(SEED)
    timing, max_err_f32 = check_hist_window(dev, rng)
    check_hist_device(dev, rng)
    torch.cuda.empty_cache()

    # ---- phase 2b: partition kernel vs plain on the card ------------------
    part_timing = check_partition(dev, rng)
    torch.cuda.empty_cache()

    # ---- phase 2c: max_cat_group kernel vs plain on the card --------------
    group_timing, group_lat = check_cat_group(dev, rng)

    # ---- phase 2d: shard-local histogram kernel vs plain on the card ------
    local_timing, local_err = check_hist_local(dev, rng)
    torch.cuda.empty_cache()

    # ---- phase 2e: route kernel vs plain on the card ----------------------
    route_timing = check_route(dev, rng)
    route_timing.update(check_route_bundled(dev, rng))
    torch.cuda.empty_cache()

    # ---- phase 2f: the cost of the split step's gated launches ------------
    empty_launch_cost(dev, rng)
    torch.cuda.empty_cache()

    # ---- phase 2g: data-parallel route kernel vs plain on the card --------
    rows_timing = check_route_rows(dev, rng)
    rows_timing.update(check_route_rows_bundled(dev, rng))
    torch.cuda.empty_cache()

    # ---- phase 2j: data-parallel route kernel on a row-major block --------
    block_timing = check_route_rows_block(dev, rng)
    torch.cuda.empty_cache()

    # ---- phase 2k: the block-sharded route kernel -------------------------
    sharded_timing = check_block_route(dev, rng)
    torch.cuda.empty_cache()

    # ---- phase 2i: every kernel on a uint16 bin matrix --------------------
    wide = check_wide_kernels(dev, rng)

    # ---- phase 3: the Higgs path at full width ----------------------------
    rng = np.random.default_rng(SEED + 1)
    x_all, y_all = higgs_like(N_ROWS + N_HELDOUT, rng)
    x_tr, y_tr = x_all[:N_ROWS], y_all[:N_ROWS]
    x_te, y_te = x_all[N_ROWS:], y_all[N_ROWS:]
    names = ("hist_gather", "hist_local", "lgbt_partition", "lgbt_cat_group",
             "lgbt_route_kernel", "lgbt_route_rows", "lgbt_block_route",
             "lgbt_lambdarank")
    # scatter: the eager loop, one host read a split
    higgs, _, higgs_ds = train_path(
        "higgs", dict(params, partition_impl="scatter"), x_tr, y_tr, x_te,
        y_te, 10, names, profile=False)
    phase("main_path", **higgs)
    higgs_launches = higgs["hist_window_launches"]

    # ---- phase 3b: the Higgs path through the partition kernel ------------
    # partition_impl=auto: compact on a card, the split step replayed as a
    # CUDA graph
    compact, bst, _ = train_path("higgs_compact", params, x_tr, y_tr, x_te,
                                 y_te, 10, names, ds=higgs_ds)
    phase("main_path_compact", **compact)
    # phases 16 and 17 predict with this model
    higgs_model = bst.model_to_string()
    del bst
    partition_ab(params, higgs_ds)
    torch.cuda.empty_cache()

    # ---- phase 7: the graph loop against the eager loop, Higgs ------------
    higgs_loops = graph_vs_eager("higgs", higgs_ds, y_tr, names,
                                 ordered_bins="off")
    torch.cuda.empty_cache()

    # ---- phase 4: card against CPU ----------------------------------------
    sub = 50_000
    card_vs_cpu("card_vs_cpu", params, x_tr[:sub], y_tr[:sub], x_te[:sub],
                y_te[:sub], ("split_feature", "threshold"), 1e-4, 1e-4)

    # ---- phases 6, 6b: the data-parallel learner at full width ------------
    # four mesh slots on the one card: four row shards (4x1), or two row
    # shards of two 14-column slices (2x2); gspmd_hist is left at auto,
    # which on a card is the shard-local kernel, and the split loop at
    # auto, which with every slot on one card is the graph loop
    dp_params = dict(params, tree_learner="data", mesh_devices=MESH_SLOTS)
    dp, _, _ = train_path("dp_4x1", dict(dp_params, mesh_shape="4x1"),
                          x_tr, y_tr, x_te, y_te, 10, names)
    auc_gap = abs(float(dp["heldout_auc"]) - float(higgs["heldout_auc"]))
    phase("dp_path_4x1", auc_gap_vs_serial=f"{auc_gap:.3e}", **dp)
    if auc_gap > 1e-4:
        fail(f"4x1 data-parallel AUC {dp['heldout_auc']} is more than 1e-4 "
             f"from the serial path's {higgs['heldout_auc']}")
    dp22, _, _ = train_path("dp_2x2", dict(dp_params, mesh_shape="2x2"),
                            x_tr, y_tr, x_te, y_te, 3, names, profile=False)
    phase("dp_path_2x2", **dp22)
    torch.cuda.empty_cache()

    # ---- phase 6c: the data-parallel trees against the serial tree --------
    gspmd_trees_identical(higgs_ds, y_tr)
    torch.cuda.empty_cache()

    # ---- phase 21a: the voting learner over 4x1 on the one card ----------
    vote_tree = voting_tree_vs_data(higgs_ds, y_tr)
    vote, _, _ = train_path("voting_4x1", dict(
        dp_params, tree_learner="voting", top_k=VOTE_TOP_K, mesh_shape="4x1"),
        x_tr, y_tr, x_te, y_te, 3, names, ds=higgs_ds, profile=False)
    phase("voting_path_4x1", top_k=VOTE_TOP_K, **vote)
    torch.cuda.empty_cache()

    # ---- phase 22: two processes on the one card ---------------------------
    procs, procs_score_model = two_processes(params, higgs_ds, x_tr, y_tr,
                                             x_te, y_te)
    torch.cuda.empty_cache()

    # ---- phases 24a-24c: checkpoints, a real SIGTERM, the supervisor ------
    ckpt = checkpoint_resume(params, higgs_ds, y_tr, x_te, y_te)
    torch.cuda.empty_cache()
    preempt = preempt_sigterm(params, higgs_ds, y_tr, ckpt["integer_model"])
    sup = supervised_restart(params, procs_score_model)
    torch.cuda.empty_cache()

    # ---- phase 20a: streamed trees of the Higgs path ----------------------
    rate = h2d_rate(dev)
    tree20a = []
    higgs_stream = streamed_tree_vs_resident(
        "higgs_streamed", higgs_ds, y_tr, (100_000, 333_334), rate,
        ordered_bins="off", keep=tree20a)
    phase("higgs_streamed_trees", **higgs_stream)
    torch.cuda.empty_cache()

    # ---- phase 23d: block-sharded bins on the graph loop, 2x2 -------------
    block_tree = gspmd_trees_identical(higgs_ds, y_tr, shapes=((2, 2),),
                                       block=True)
    torch.cuda.empty_cache()
    # ---- phase 23b: the placement walk's streamed rung ---------------------
    chunked = chunked_rung(params, higgs_ds, y_tr, tree20a)
    del tree20a
    # ---- phase 23e: a budget below every rung ------------------------------
    refused_walk(params, higgs_ds)
    del higgs_ds
    flat_vs_fused(dict(dp_params, mesh_shape="4x1"), x_tr[:sub], y_tr[:sub],
                  x_te[:sub])
    del x_all, y_all, x_tr, y_tr, x_te, y_te
    torch.cuda.empty_cache()

    # ---- phase 5: the Expo-shaped categorical path at full width ----------
    rng = np.random.default_rng(SEED + 3)
    t0 = time.perf_counter()
    x_all, y_all = expo_like(N_EXPO + N_HELDOUT, rng)
    t_gen = time.perf_counter() - t0
    x_tr, y_tr = x_all[:N_EXPO], y_all[:N_EXPO]
    x_te, y_te = x_all[N_EXPO:], y_all[N_EXPO:]
    expo_params = dict(params, categorical_feature=EXPO_CATEGORICAL,
                       partition_impl="compact", ordered_bins="on",
                       enable_bundle=False, enable_bin_packing=False)
    expo, bst, ds = train_path("expo", expo_params, x_tr, y_tr, x_te, y_te,
                               10, names)
    td = ds.constructed
    num_bins = [td.bin_mappers[j].num_bin for j in td.used_features]
    if max(num_bins) > 256:
        fail(f"a column of the Expo-shaped data has {max(num_bins)} bins")
    n_cat = sum(t.num_cat for t in bst.inner.models)
    if n_cat == 0:
        fail("the Expo-shaped model holds no categorical split")
    phase("expo_path", generate_s=f"{t_gen:.3f}",
          label_rate=f"{float(y_tr.mean()):.4f}",
          num_bin=":".join(str(b) for b in num_bins),
          categorical_splits=n_cat, **expo)
    phase("expo_partition_cat_group",
          partition_device_ms=expo["lgbt_partition_device_ms_per_tree"],
          partition_bound_ms=expo.get("partition_bound_ms_per_tree"),
          partition_small_windows=expo["partition_small_windows_per_tree"],
          partition_large_windows=expo["partition_large_windows_per_tree"],
          partition_launches=expo["partition_launches_per_tree"],
          cat_group_launches=expo["cat_group_launches_per_tree"],
          cat_group_device_ms=expo["lgbt_cat_group_device_ms_per_tree"],
          route_device_ms=expo["lgbt_route_kernel_device_ms_per_tree"],
          ms_per_tree=expo["ms_per_tree"],
          peak_mem_bytes=expo["peak_mem_bytes"])
    expo_launches = {k: expo[f"{k}_launches"] for k in (
        "partition_window", "cat_group_accept", "route_window")}
    # phase 16 predicts with this model
    expo_model = (bst.model_to_string(), x_te[:CONTRIB_ROWS].copy())
    del bst
    torch.cuda.empty_cache()

    # ---- phase 7: the graph loop against the eager loop, Expo -------------
    expo_loops = graph_vs_eager("expo", ds, y_tr, names, ordered_bins="on")
    torch.cuda.empty_cache()

    # ---- phase 4b: card against CPU on the Expo-shaped task ---------------
    grower_card_vs_cpu(expo_params, x_tr[:sub], y_tr[:sub])
    # after the first tree the gradients are real-valued and the card adds
    # them in another order; a categorical split sorts its bins by a ratio
    # of such sums, near-equal ratios swap, and a later tree may take
    # another category set: predictions are not held to a limit here,
    # the held-out AUC is held to 5e-3
    card_vs_cpu("expo_card_vs_cpu", expo_params, x_tr[:sub], y_tr[:sub],
                x_te[:sub], y_te[:sub],
                ("split_feature", "threshold", "decision_type",
                 "left_child", "right_child", "leaf_value",
                 "cat_boundaries", "cat_threshold"), float("inf"), 5e-3)
    # phase 10c trains on this Dataset again after the other paths
    expo_kept = (ds, x_tr, y_tr, x_te, y_te)
    del ds, x_all, y_all, x_tr, y_tr, x_te, y_te
    torch.cuda.empty_cache()

    # ---- phases 2h and 8: lambdarank on the MS-LTR-shaped task ------------
    rng = np.random.default_rng(SEED + 7)
    run_dir = os.path.dirname(os.path.abspath(__file__))
    mslr, lam, heldout = rank_path(params, names, rng, rate=rate)
    # ---- phase 8b: card against CPU on the ranking task -------------------
    rank_card_vs_cpu(dict(params, objective="lambdarank", metric="ndcg",
                          ndcg_eval_at=list(MSLR_EVAL_AT)),
                     rng, run_dir, heldout)
    del heldout
    torch.cuda.empty_cache()

    # ---- phases 9-9g: multiclass on the Covertype-shaped task -------------
    cov, cov_model = covtype_path(params, names,
                                  np.random.default_rng(SEED + 9))
    torch.cuda.empty_cache()

    # ---- phases 10-14: sampling, the boosting variants, the training API --
    rng = np.random.default_rng(SEED + 1)
    x_all, y_all = higgs_like(N_ROWS + N_HELDOUT, rng)
    x_tr, y_tr = x_all[:N_ROWS], y_all[:N_ROWS]
    x_te, y_te = x_all[N_ROWS:], y_all[N_ROWS:]
    samp = sampling_paths(params, names, x_tr, y_tr, x_te, y_te)
    # ---- phase 10c: the bagging subset regime on the Expo-shaped task ----
    expo_bag = expo_subset_path(expo_params, names, *expo_kept)
    # phase 20c streams this Dataset last: its profiled tree's records (some
    # 150,000 launches) are the largest of the run, and later profiled
    # windows lost records after it
    expo_stream_kept = (expo_kept[0], expo_kept[2], expo_kept[3],
                        expo_kept[4], expo_model[0])
    expo_kept[0].bins = None
    del expo_kept
    torch.cuda.empty_cache()
    # ---- phase 14b: card against CPU for bagging, GOSS and DART ----------
    sampling_card_vs_cpu(params, x_tr[:50_000], y_tr[:50_000], x_te, y_te)
    # ---- phase 15: the non-finite guard, each policy tripped once ---------
    guard = nonfinite_guard(params, x_tr[:200_000], y_tr[:200_000])
    torch.cuda.empty_cache()
    # ---- phase 16: leaf indices, early stopping, contributions ------------
    prediction_breadth({
        "higgs": (higgs_model, x_te, ("leaf", "early_stop", "contrib")),
        "expo": (*expo_model, ("leaf", "contrib")),
        "covtype": (*cov_model, ("contrib", "early_stop"))})
    del expo_model, cov_model
    # ---- phase 17: files, the binary file, CSR, two-round loading ---------
    dataset_inputs(params, higgs_model, x_tr, y_tr, x_te, y_te)
    torch.cuda.empty_cache()
    # ---- phase 18: the Higgs-shaped task at max_bin=1023 (uint16) ---------
    wide_serial, wide_dp = higgs_wide_path(params, names, x_tr, y_tr, x_te,
                                           y_te)
    del x_all, y_all, x_tr, y_tr, x_te, y_te
    torch.cuda.empty_cache()
    # ---- phase 19: the Expo-shaped task over the full airport tail --------
    wide_expo = expo_wide_path(params, names)
    torch.cuda.empty_cache()
    # ---- phase 20c: the Expo-shaped task streamed -------------------------
    expo_stream = expo_streamed(expo_params, *expo_stream_kept, rate)
    del expo_stream_kept
    # ---- phase 23a: the memory model against the card ---------------------
    model_vs_card({
        "3b higgs_compact": compact, "5 expo": expo, "6 dp_4x1": dp,
        "8 mslr_packed": mslr, "9 covtype_bundled": cov,
        "18 higgs_1023": wide_serial, "18 higgs_1023_dp_4x1": wide_dp,
        "19 expo_wide": wide_expo, "20b mslr_streamed": mslr["streamed"],
        "21b mslr_data_4x1": mslr["voting"]["data"],
        "21b mslr_voting_4x1": mslr["voting"]["voting"]})
    phase("total", seconds=f"{time.perf_counter() - t_start:.1f}",
          higgs_ms_per_tree_scatter=higgs["ms_per_tree"],
          higgs_ms_per_tree_compact=compact["ms_per_tree"],
          higgs_graph_ms_per_tree=higgs_loops["graph_ms_per_tree"],
          higgs_eager_ms_per_tree=higgs_loops["eager_ms_per_tree"],
          expo_graph_ms_per_tree=expo_loops["graph_ms_per_tree"],
          expo_eager_ms_per_tree=expo_loops["eager_ms_per_tree"],
          higgs_ms_per_tree_dp_4x1=dp["ms_per_tree"],
          higgs_ms_per_tree_dp_2x2=dp22["ms_per_tree"],
          mslr_ms_per_tree=mslr["ms_per_tree"],
          mslr_cut_ms_per_tree=mslr["cut"]["ms_per_tree"],
          covtype_ms_per_tree=cov["ms_per_tree"],
          covtype_cut_ms_per_tree=cov["cut"]["ms_per_tree"],
          nonfinite_trips=guard,
          expo_bagging_subset_ms_per_tree=expo_bag["ms_per_tree"],
          **{f"phase_{k}_ms_per_tree": v["ms_per_tree"]
             for k, v in samp.items() if "ms_per_tree" in v},
          training_api_ms_per_tree=samp["14"]["reset_ms_per_tree"],
          higgs_1023_ms_per_tree=wide_serial["ms_per_tree"],
          higgs_1023_dp_4x1_ms_per_tree=wide_dp["ms_per_tree"],
          expo_wide_ms_per_tree=wide_expo["ms_per_tree"],
          higgs_streamed_ms_per_tree_10_blocks=higgs_stream[
              "ms_per_tree_10_blocks"],
          mslr_streamed_ms_per_tree=mslr["streamed"]["ms_per_tree"],
          expo_streamed_ms_per_tree=expo_stream["ms_per_tree"],
          voting_integer_ms_per_tree=vote_tree["voting_ms_per_tree"],
          voting_4x1_ms_per_tree=vote["ms_per_tree"],
          mslr_voting_ms_per_tree=mslr["voting"]["voting"]["ms_per_tree"],
          mslr_data_4x1_ms_per_tree=mslr["voting"]["data"]["ms_per_tree"],
          two_processes_data_ms_per_tree=procs["data_ms_per_tree"],
          two_processes_voting_ms_per_tree=procs["voting_ms_per_tree"],
          two_processes_feature_ms_per_tree=procs["feature_ms_per_tree"],
          block_sharded_graph_ms_per_tree=block_tree["graph_ms_per_tree"],
          chunked_rung_ms_per_tree=chunked["ms_per_tree"],
          planner_rung_ms_per_tree=mslr["planner"]["ms_per_tree"],
          snapshot_bytes=ckpt["binary"]["snapshot_bytes"],
          snapshot_write_s=ckpt["binary"]["write_s"],
          sigterm_to_exit_s=preempt["sigterm_to_exit_s"],
          supervised_wall_s=sup["supervised_wall_s"])
    u16 = lambda name: wide_kernel_fields(name, wide, wide_serial, wide_dp,
                                          wide_expo)

    root = timing[N_ROWS]
    proot = part_timing[N_EXPO]
    rroot = route_timing["expo_root"]
    lroot = local_timing[(N_ROWS // 4, "all")]
    lsmall = local_timing[(N_ROWS // 4, "small")]
    print(json.dumps({"kernels": [{
        "name": "hist_gather", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/hist_gather.cu",
        "replaces": "lightgbm_tpu/ops/pallas_hist.py:223",
        "launches": higgs_launches, "max_abs_err": max_err_f32,
        "ms": root["ms"], "plain_ms": root["plain_ms"],
        "bound_ms": root["bound_ms"], "bound_by": "bytes",
        "library_ms": root["library_ms"],
        # phase 24a's resumed runs (integer, binary), graph loop
        **{f"launches_24a_resumed_{k}": ckpt[k]["hist_window_launches"]
           for k in ("integer", "binary")},
        **small_window_fields(root, timing[4097]), **u16("hist_gather")}, {
        "name": "hist_local", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/hist_local.cu",
        "replaces": "lightgbm_tpu/ops/pallas_hist.py:284",
        # every call of the path takes the device regime: two kernels
        "launches": 2 * dp["hist_local_launches"],
        "calls": dp["hist_local_launches"], "max_abs_err": local_err,
        # the voting path's (phase 21a) and rank 0's of phase 22
        "launches_voting_4x1": 2 * vote["hist_local_launches"],
        **{f"launches_two_processes_{k}_rank0": 2 * procs.get(
            f"{k}_hist_local_launches", 0)
           for k in ("data", "voting", "feature")},
        # phase 24c's resumed incarnation, rank 0
        "launches_24c_supervised_rank0": 2 * sup["hist_local_launches_rank0"],
        "ms": lroot["ms"], "plain_ms": lroot["plain_ms"],
        "bound_ms": lroot["bound_ms"], "bound_by": "bytes",
        "library_ms": lroot["library_ms"],
        **small_window_fields(lroot, lsmall),
        # the host's plan at the leaf's count, for comparison
        **{f"{k}{w}": d[k] for w, d in (("", lroot), ("_small", lsmall))
           for k in ("host_plan_ms", "host_plan_ms_many",
                     "host_plan_device_ms")}, **u16("hist_local")}, {
        "name": "partition", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/partition.cu",
        "replaces": "lightgbm_tpu/ops/pallas_compact.py:98",
        "launches": LAUNCHES * expo_launches["partition_window"],
        "calls": expo_launches["partition_window"], "max_abs_err": 0.0,
        **{f"launches_24a_resumed_{k}": LAUNCHES * ckpt[k][
            "partition_window_launches"] for k in ("integer", "binary")},
        "ms": proot["ms"], "plain_ms": proot["plain_ms"],
        "bound_ms": proot["bound_ms"], "bound_by": "bytes",
        "library_ms": proot["library_ms"],
        **{k: v for k, v in proot.items() if k in (
            "ms_many", "device_ms", "library_ms_many", "library_device_ms",
            "sort_form_ms", "sort_form_ms_many", "sort_form_device_ms",
            "launches_a_call")},
        **{f"{k}_4097": v for k, v in part_timing[4097].items()},
        **u16("partition")}, {
        "name": "cat_group", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/cat_group.cu",
        "replaces": "lightgbm_tpu/ops/split.py:300",
        "launches": expo_launches["cat_group_accept"], "max_abs_err": 0.0,
        "ms": group_timing["ms"], "plain_ms": group_timing["plain_ms"],
        "bound_ms": group_timing["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ms_many": group_timing["ms_many"],
        "device_ms": group_timing["device_ms"],
        "latency_bound_ms": group_timing["latency_bound_ms"],
        "max_accepts_a_lane": group_timing["max_accepts_a_lane"],
        "sass_cycles_per_add": group_lat.get("cycles_per_add"),
        "sass_cycles_per_accept": group_lat.get("cycles_per_accept"),
        **u16("cat_group")}, {
        "name": "route", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/route.cu",
        "replaces": "lightgbm_tpu/grower.py:372",
        "launches": expo_launches["route_window"], "max_abs_err": 0.0,
        **{f"launches_24a_resumed_{k}": ckpt[k]["route_window_launches"]
           for k in ("integer", "binary")},
        "ms": rroot["ms"], "plain_ms": rroot["plain_ms"],
        "bound_ms": rroot["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ms_many": rroot["ms_many"],
        "device_ms": rroot["device_ms"],
        "replaced_ms": rroot["replaced_ms"],
        "replaced_device_ms": rroot["replaced_device_ms"],
        **{f"{k}_{w}": v for w in ("higgs_root", "higgs_4097",
                                   "bundled_root", "bundled_4000")
           for k, v in route_timing[w].items()}, **u16("route")}, {
        "name": "route_rows", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/route.cu",
        "replaces": "lightgbm_tpu/parallel/gspmd.py:305",
        "launches": dp["route_rows_launches"], "max_abs_err": 0.0,
        "launches_voting_4x1": vote["route_rows_launches"],
        **{f"launches_two_processes_{k}_rank0": procs.get(
            f"{k}_route_rows_launches", 0)
           for k in ("data", "voting", "feature")},
        "launches_24c_supervised_rank0": sup["route_rows_launches_rank0"],
        "ms": rows_timing["root"]["ms"],
        "plain_ms": rows_timing["root"]["plain_ms"],
        "bound_ms": rows_timing["root"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ms_many": rows_timing["root"]["ms_many"],
        "device_ms": rows_timing["root"]["device_ms"],
        **{f"{k}_{w}": v for w in ("leaf_1000", "bundled_root",
                                   "bundled_leaf_4000")
           for k, v in rows_timing[w].items()}, **u16("route_rows")}, {
        "name": "lambdarank", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/lambdarank.cu",
        "replaces": "lightgbm_tpu/objectives.py:405",
        "launches": mslr["lambdarank_grad_launches"],
        "max_abs_err": lam["max_abs_err"], "ms": lam["ms"],
        "plain_ms": lam["plain_ms"], "bound_ms": lam["bound_ms"],
        "bound_by": lam["bound_by"], "library_ms": None,
        "ms_many": lam["ms_many"], "device_ms": lam["device_ms"]}, {
        "name": "route_rows_block", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/route.cu",
        "replaces": "lightgbm_tpu/grower.py:1223",
        # the MS-LTR streamed path's launches; the Expo path's beside it
        "launches": mslr["streamed"]["route_rows_launches"],
        "launches_expo_streamed": expo_stream["route_rows_launches"],
        "max_abs_err": 0.0, "ms": block_timing["root"]["ms"],
        "plain_ms": block_timing["root"]["plain_ms"],
        "bound_ms": block_timing["root"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        **{k: v for k, v in block_timing["root"].items() if k in (
            "ms_many", "device_ms", "column_major_ms",
            "column_major_ms_many", "column_major_device_ms",
            "column_major_bound_ms", "sectors")},
        **{f"{k}_leaf_1000": v
           for k, v in block_timing["leaf_1000"].items()}}, {
        "name": "route_rows_block_sharded", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/route.cu",
        "replaces": "lightgbm_tpu/parallel/gspmd.py:305",
        # phase 23c's planned training (MS-LTR over 2x2, block-sharded);
        # phase 23d's profiled graph tree beside it
        "launches": mslr["planner"]["route_rows_block_launches"],
        "launches_23d_profiled_tree": block_tree[
            "block_route_launches_per_tree"],
        "max_abs_err": 0.0, "ms": sharded_timing["root"]["ms"],
        "plain_ms": sharded_timing["root"]["plain_ms"],
        "bound_ms": sharded_timing["root"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        **{k: v for k, v in sharded_timing["root"].items() if k in (
            "ms_many", "device_ms", "sectors", "moved", "leaf_rows")},
        "device_ms_per_tree": block_tree["block_route_device_ms_per_tree"],
        **{f"{k}_leaf_1000": v
           for k, v in sharded_timing["leaf_1000"].items()}}]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
