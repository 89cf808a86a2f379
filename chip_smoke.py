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
   Expo-shaped path with its 20-byte payload; all left, all right and
   random, with and without the payload, into a destination full of
   garbage: window, payload and left count identical bit for bit, the
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
   and leaves of the regime threshold's rows and one more, each in both
   regimes, exact under integer weights; with times at all rows and the
   1,000-row leaf;
2e. the route kernel (the split column of the chosen leaf's window,
   routed left or right) against its plain version, bit for bit: windows
   of 0 to 1,000,000 rows gathered through either of two ``order``
   buffers of the Higgs path's bins, and the Expo path's 11,000,000-row
   root in either buffer of its leaf-ordered bins, on splits of each
   missing type and a categorical one; with times beside the PyTorch
   gather + ``where`` of the eager loop;
2f. what the captured split step's gated launches cost at the Expo
   path's size: the partition over the grid of all rows and the
   histogram's device regime, against the partition over the window's own
   tiles and the histogram's host-picked plan, at an empty window, 4,097
   and 1,000,000 rows;
3. the Higgs path at full width: seeded synthetic Higgs-shaped data
   (1,000,000 x 28 float32, binary label from a fixed nonlinear rule plus
   noise, 100,000 held-out rows), ``train`` 10 rounds with 255 leaves and
   255 bins and ``partition_impl=scatter`` (the eager loop, one host read
   a split), ``predict`` the held-out rows; the histogram kernel must have
   launched once per tree plus once per split, the route kernel once per
   split;
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
   kernel) over a 4x1 mesh of four slots on the card, 10 rounds; the
   shard-local kernel must have launched 4 x (trees + splits) times and
   the gather kernel never; held-out AUC against phase 3's;
6b. the same over a 2x2 mesh (14 columns a feature slice), 3 rounds;
6c. one tree under integer-valued gradients grown on both meshes, on a
   1x3 mesh of uneven column slices (10, 9 and 9) and by the serial
   grower, identical field by field; and ``gspmd_hist=flat`` against
   ``fused`` on a 50,000-row subset, 3 rounds;
7. (after phase 3c on the Higgs path and after phase 5 on the Expo path,
   on their data) one tree under integer-valued gradients grown by the
   graph loop and by the eager loop (and on Higgs by ``scatter``):
   identical field by field; the graph loop's trees after its capture run
   under ``torch.cuda.set_sync_debug_mode("error")``, so any read to the
   host but the counted stop reads raises; ms a tree in turns (graph,
   eager, eager, graph), and one profiled tree of each loop: device-busy
   share, launch calls, host reads.

With ``--multi-card`` it runs only the build and, with the four mesh
slots on four cards, phase 6c's trees and 3 rounds of phase 6's path.

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


def window_bound_ms(cnt: int, f: int) -> float:
    """Least time of a window histogram: each row's order entry, bins and
    three weights read, (start, cnt) read and the [F, 255, 3] f32 output
    written, over the memory rate; or 3 * F f32 adds a row over the f32
    rate."""
    nbytes = cnt * (4 + f + 3 * 4) + 8 + f * N_BINS * 3 * 4
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


def expo_like(n: int, rng: np.random.Generator):
    """Expo-shaped synthetic task: the 8 columns of the airline-delay data
    (Month, DayofMonth, DayOfWeek, DepTime as hhmm, UniqueCarrier, Origin,
    Dest, Distance in miles), columns 0, 1, 2, 4, 5 and 6 categorical.

    Origin and Dest are 300 airport codes whose 255 most frequent hold
    99.7 % of the rows, so the binner keeps every column within 256 bins.
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
    return m.eval(np.asarray(score, np.float64)[None], None)


MARKERS = 32          # spin kernels that open a profiled window
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
            torch.cuda._sleep(100)
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
           "hist_local": ("hist_local_small", "hist_local_large"),
           "partition_window": ("lgbt_partition_small",
                                "lgbt_partition_count",
                                "lgbt_partition_write"),
           "route_window": ("lgbt_route",),
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
    in both regimes."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (SMALL_MAX_ROWS_LOCAL,
                                                  hist_local,
                                                  hist_local_plain,
                                                  plan_launch, sm_count)
    sms = sm_count(torch.cuda.current_device())
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
        # leaves of exactly the regime threshold and one row more
        t = SMALL_MAX_ROWS_LOCAL
        edge = np.zeros(n_loc, np.int32)
        perm = rng.permutation(n_loc)
        edge[perm[:t]], edge[perm[t:2 * t + 1]] = 1, 2
        edge_d = torch.from_numpy(edge).to(dev)
        maps["threshold"] = (edge_d, 1, t)
        maps["threshold+1"] = (edge_d, 2, t + 1)
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
            pl = hist_local_plain(row_leaf, lid, bins, *w_int, N_BINS)
            # its own plan at the leaf's count, both regimes forced, and
            # the plan under the shard's bound
            plans = {"own": plan(cnt),
                     "small": plan(cnt, small_max_rows=n_loc),
                     "large": plan(cnt, small_max_rows=-1),
                     "shard_bound": plan(n_loc)}
            for pname, lp in plans.items():
                k = hist_local(row_leaf, lid, bins, *w_int, N_BINS, cnt, lp)
                torch.cuda.synchronize()
                if not torch.equal(k, pl):
                    fail(f"hist_local != plain under integer weights at "
                         f"{n_loc}x{fc}, leaf {name}, {pname} plan {lp}")
            k = hist_local(row_leaf, lid, bins, *w_f32, N_BINS, cnt)
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
            timing[(n_loc, name)] = t = time_kernel(
                lambda: hist_local(row_leaf, lid, bins, *w_f32, N_BINS, cnt),
                lambda: hist_local_plain(row_leaf, lid, bins, *w_f32,
                                         N_BINS),
                lambda: acc.index_add_(0, flat, vals),
                local_bound_ms(n_loc, cnt, fc),
                lambda: hist_local(row_leaf, lid, bins, *w_f32, N_BINS, cnt,
                                   plan(n_loc)))
            phase("hist_local_time", shard=f"{n_loc}x{fc}", leaf=name,
                  rows=cnt,
                  regime=plan(cnt).regime,
                  **{k: f"{v:.4f}" if isinstance(v, float) else v
                     for k, v in t.items()},
                  bound_share=f"{t['bound_ms'] / t['device_ms']:.4f}"
                  if t["device_ms"] else "not measured")
        del bins, maps, skewed_d, edge_d, w_int, w_f32, idx, flat, vals, acc
    return timing, max_err


def route_bound_ms(cnt: int, gathered: bool) -> float:
    """Least time of a route call: each window position's order entry
    (4 B, gathered windows only), its bin byte and its output byte, and the
    window, parity, leaf and split row, over the memory rate."""
    nbytes = cnt * ((4 if gathered else 0) + 2) + 16 + 4 + 8 + 12 + 1 + N_BINS
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


def real_launches(raw: dict, windows, replays: int, captures: int) -> dict:
    """Each wrapper's launches on the card from its counts ``raw``: a
    capture counts the split step's launches without making them, and a
    replay makes them without counting (``WindowBuffers.graph_launches``,
    the counts of one capture)."""
    per = windows.graph_launches if windows is not None else {}
    return {k: v + (replays - captures) * per.get(k, 0)
            for k, v in raw.items()}


def graph_vs_eager(name, ds, y, dev_names, **cfg_kw):
    """Phase 7: one tree of a path under integer-valued gradients and
    hessians, whose sums are exact in any order, grown by the graph loop
    (the split step captured once and replayed), by the eager loop (the
    same step run as it is) and, with ``ordered_bins=off``, by the
    ``scatter`` partition: identical field by field, row -> leaf maps too.
    The graph loop's trees after its capture run under
    ``torch.cuda.set_sync_debug_mode("error")``, so any read back to the
    host but its counted stop reads (an event wait) raises.  Then ms a
    tree in turns (graph, eager, eager, graph) and one profiled tree of
    each loop: device-busy share, kernel and graph launch calls, host
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
    for loop in ("graph", "eager", "eager", "graph"):
        ms[loop].append(grow(loop, sync_check=loop == "graph")[0])
    prof = {}
    fns = _kernel_wrappers()
    for loop in ("graph", "eager"):
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
    from lightgbm_tpu_torch.ops.partition import partition_window
    from lightgbm_tpu_torch.ops.route import route_window
    from lightgbm_tpu_torch.ops.split import cat_group_accept
    return {f.__name__: f for f in (hist_window, hist_local, partition_window,
                                    route_window, cat_group_accept)}


def train_path(name, params, x_tr, y_tr, x_te, y_te, rounds, dev_names):
    """Drive one path through ``train`` and ``predict`` with the kernel
    counts set to 0 just before and read just after; returns its numbers
    and the booster.

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
    ds = Dataset(x_tr, y_tr, params=params).construct()
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches = 0
        for k in getattr(fn, "regime_launches", {}):
            fn.regime_launches[k] = 0
    t0 = time.perf_counter()
    bst = train(params, ds, num_boost_round=rounds, verbose_eval=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    raw = {k: fn.launches for k, fn in fns.items()}
    # the same counts by the regime of their plan
    by_regime = {f"{kernel}_{k}_count": v for kernel, fn in (
        ("hist", fns["hist_window"]), ("hist_local", fns["hist_local"]))
        for k, v in fn.regime_launches.items()}
    stats = dict(bst.inner.stats)
    windows = bst.inner._windows
    graph = windows is not None and windows.graph is not None
    launches = real_launches(raw, windows, stats.get("graph_replays", 0),
                             int(graph))
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    pred = bst.predict(x_te)
    t_pred = time.perf_counter() - t0
    trees, splits = stats["trees"], stats["splits"]
    if splits != sum(m.num_leaves - 1 for m in bst.inner.models):
        fail(f"{name}: {splits} splits counted, the models hold "
             f"{sum(m.num_leaves - 1 for m in bst.inner.models)}")
    # the data-parallel learner measures every leaf on each mesh slot with
    # the shard-local kernel; the serial grower with the gather kernel
    mesh = bst.inner.mesh
    shards = 0 if mesh is None else len(sum(mesh.devices, []))
    if (bst.inner.parallel_impl == "gspmd") != (
            params.get("tree_learner", "serial") != "serial"):
        fail(f"{name}: learner resolved to {bst.inner.parallel_impl}")
    # on a card gspmd_hist=auto is the shard-local kernel
    if shards and bst.inner.gspmd_hist != params.get("gspmd_hist", "fused"):
        fail(f"{name}: gspmd_hist resolved to {bst.inner.gspmd_hist}")
    compact = bst.inner.grower_cfg.partition_impl == "compact"
    if not shards and graph != compact:
        fail(f"{name}: partition_impl={bst.inner.grower_cfg.partition_impl} "
             f"took the {'graph' if graph else 'eager'} loop")
    # steps that ran the split step's kernels: every step of the graph
    # loop; a step of the eager scatter/sort loop that found the tree
    # stopped returns before its first kernel
    steps = (stats["steps"] if compact else splits) if not shards else splits
    if not shards and not splits <= stats["steps"] <= splits + 32 * trees:
        fail(f"{name}: {stats['steps']} steps for {splits} splits in "
             f"{trees} trees")
    categorical = bool(ds.constructed.feature_meta()["is_categorical"].any())
    want = {"hist_window": 0 if shards else trees + steps,
            "hist_local": (shards * (trees + splits)
                           if bst.inner.gspmd_hist == "fused" else 0),
            "partition_window": steps if compact and not shards else 0,
            "route_window": 0 if shards else steps,
            "cat_group_accept": trees + steps if categorical else 0}
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
    syncs_per_tree = stats["host_syncs"] / trees
    if graph and syncs_per_tree > -(-(bst.inner.grower_cfg.num_leaves - 1)
                                    // 32) + 1:
        fail(f"{name}: {syncs_per_tree} host reads a tree on the graph loop")
    if graph and not stats["graph_replays"]:
        fail(f"{name}: the graph loop replayed no step")
    if pred.shape != (len(y_te),) or not np.isfinite(pred).all():
        fail(f"{name}: held-out predictions are not finite of the expected "
             f"shape")
    test_auc = auc(pred, y_te)
    if not 0.6 < test_auc <= 1.0:
        fail(f"{name}: held-out AUC {test_auc} is not that of a learned "
             f"model")

    # device time of the kernels over one more tree (profiling two made
    # the script take more than half its time limit)
    prof_bst = train(params, ds, num_boost_round=1, verbose_eval=False)
    per_step = (prof_bst.inner._windows.graph_launches
                if prof_bst.inner._windows is not None else {})
    res, snap, st0, missed = profile_checked(
        name, fns, prof_bst.update, lambda: prof_bst.inner.stats, per_step,
        dev_names)
    wall, per, all_ms, host, calls, ran = res
    st1 = prof_bst.inner.stats
    replays = st1.get("graph_replays", 0) - st0.get("graph_replays", 0)
    tree_launches = {k: fn.launches - snap[0][k] + replays
                     * per_step.get(k, 0) for k, fn in fns.items()}
    tree_kernels = dict(
        partition_calls_per_tree=tree_launches["partition_window"],
        route_launches_per_tree=tree_launches["route_window"],
        cat_group_launches_per_tree=tree_launches["cat_group_accept"],
        host_syncs_in_profiled_tree=st1["host_syncs"] - st0["host_syncs"],
        **{f"{k}_ran_in_profiled_tree": v for k, v in ran.items()},
        trees_profiled_again=len(missed),
        **{f"{k}_calls_per_tree": v for k, v in calls.items()})
    if tree_launches["partition_window"]:
        # three launches a call; which windows did the small launch's
        # work and which the count and write launches', from the tree's
        # node counts (each node's count is its window)
        last = prof_bst.inner.models[-1]
        counts = last.internal_count[:last.num_leaves - 1]
        small = int((counts <= SMALL_MAX_ROWS).sum())
        tree_kernels.update(
            partition_launches_per_tree=sum(
                ran[k] for k in KERNELS["partition_window"]),
            partition_small_windows_per_tree=small,
            partition_large_windows_per_tree=len(counts) - small)
        # the sum of the tree's per-call bounds: every partitioned position
        # moves its mask and every matrix's row
        widths = [x[0].numel() * x.element_size()
                  for x in prof_bst.inner._windows.bufs[0]]
        positions = (st1["partition_positions"]
                     - st0.get("partition_positions", 0))
        bound = part_bound_bytes(positions, widths) / H100_BYTES_PER_S
        tree_kernels["partition_bound_ms_per_tree"] = f"{bound * 1e3:.4f}"
    phase(f"{name}_host_ops", profiled_s=f"{wall:.3f}", **{
        key.replace(" ", "_"): f"{ms:.1f}ms/tree,{count}calls/tree"
        for ms, key, count in host})
    out = dict(rows=len(y_tr), features=x_tr.shape[1], trees=trees,
               splits=splits, steps=stats.get("steps", splits),
               graph_replays=stats.get("graph_replays", 0),
               loop="graph" if graph else "eager",
               **{f"{k}_launches": v for k, v in launches.items()},
               **by_regime, construct_s=f"{t_data:.3f}",
               ms_per_tree=f"{t_train * 1e3 / trees:.2f}",
               host_syncs_per_split=f"{stats['host_syncs'] / splits:.4f}",
               host_syncs_per_tree=f"{syncs_per_tree:.3f}",
               peak_mem_bytes=peak, predict_s=f"{t_pred:.3f}",
               heldout_auc=f"{test_auc:.6f}", **tree_kernels)
    for n, ms in per.items():   # 0 for a kernel this path does not run
        out[f"{n}_device_ms_per_tree"] = (f"{ms:.3f}" if all_ms
                                          else "not measured")
    out["device_busy_share"] = (f"{all_ms / (wall * 1e3):.4f}" if all_ms
                                else "not measured")
    return out, bst, ds


def partition_ab(params, x, y):
    """Phase 3c: the Higgs path's ms per tree with the plain partition and
    with the kernel, in turns on one dataset (scatter, compact, compact,
    scatter; 3 trees each): the host's noise between runs is larger than
    the difference, so only turns within one process compare."""
    import torch
    from lightgbm_tpu_torch import Dataset, train
    ds = Dataset(x, y, params=params).construct()
    ms = {"scatter": [], "compact": []}
    for impl in ("scatter", "compact", "compact", "scatter"):
        bst = train(dict(params, partition_impl=impl), ds, num_boost_round=1,
                    verbose_eval=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            bst.update()
        torch.cuda.synchronize()
        ms[impl].append((time.perf_counter() - t0) * 1e3 / 3)
    phase("partition_ab", trees_per_turn=3, **{
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


def grower_card_vs_cpu(params, x, y):
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
    phase("expo_grower_card_vs_cpu", rows=n, leaves=lg,
          categorical_nodes=int(ag["is_cat"].sum()),
          identical=not bad and lc == lg and np.array_equal(rc, rg))
    if bad or lc != lg or not np.array_equal(rc, rg):
        fail(f"grower under integer weights: card != CPU in "
             f"{bad or 'row_leaf'}")


def gspmd_trees_identical(ds, y):
    """Phase 6c: one tree of the Higgs path under integer-valued gradients
    and hessians, whose sums are exact in any order, grown on the 4x1, 2x2
    and 1x3 meshes (1x3: uneven slices of 10, 9 and 9 columns) with the
    shard-local kernel and by the serial grower with the gather kernel:
    identical field by field, row -> leaf maps too."""
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
                       put(fm["default_bin"]), put(fm["is_categorical"]))
    fv = torch.ones(len(fm["num_bin"]), dtype=torch.bool, device=dev)
    cfg = GrowerConfig(num_leaves=255, min_data_in_leaf=1,
                       min_sum_hessian_in_leaf=10.0, max_bin=td.max_num_bin(),
                       has_missing=bool((fm["missing_type"] != 0).any()))

    def host(tree, row_leaf):
        return ({k: v.cpu().numpy() for k, v in tree._asdict().items()
                 if isinstance(v, torch.Tensor)}, row_leaf.cpu().numpy(),
                tree.num_leaves)

    want = host(*grow_tree(ds.bins, g, h, c, meta, fv, cfg))
    slots = mesh_slots(MESH_SLOTS, dev)
    for shape in ((4, 1), (2, 2), (1, 3)):
        mesh = make_named_mesh(*shape, slots)
        grower = GspmdGrower(cfg, mesh, ds.bins)
        got = host(*grower(g, h, c, meta, fv))
        bad = [k for k in want[0] if not np.array_equal(want[0][k],
                                                        got[0][k])]
        same = not bad and want[2] == got[2] and np.array_equal(want[1],
                                                                got[1])
        phase("gspmd_tree_vs_serial", mesh=f"{shape[0]}x{shape[1]}", rows=n,
              slice_cols=":".join(str(len(c)) for c in grower.cols),
              cards=len(set(sum(mesh.devices, []))), leaves=got[2],
              identical=same)
        if not same:
            fail(f"integer-gradient tree on the {shape} mesh != serial in "
                 f"{bad or 'num_leaves/row_leaf'}")


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


def multi_card(params) -> None:
    """``--multi-card``: the data-parallel learner with its four mesh slots
    on four cards (slot s on card s) instead of one: phase 6c's
    integer-gradient trees against the serial tree, and the 4x1 path for
    3 rounds with its launch count.  Needs four cards."""
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
    gspmd_trees_identical(ds, y_tr)
    dp, bst, _ = train_path(
        "dp_4x1_four_cards", dict(params, tree_learner="data",
                                  mesh_devices=MESH_SLOTS, mesh_shape="4x1"),
        x_tr, y_tr, x_te, y_te, 3, ("hist_local",))
    cards = {d.index for d in sum(bst.inner.mesh.devices, [])}
    if len(cards) != MESH_SLOTS:
        fail(f"the 4x1 mesh sits on cards {sorted(cards)}, not on four")
    phase("dp_path_4x1_four_cards", **dp)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
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
    torch.cuda.empty_cache()

    # ---- phase 2f: the cost of the split step's gated launches ------------
    empty_launch_cost(dev, rng)
    torch.cuda.empty_cache()

    # ---- phase 3: the Higgs path at full width ----------------------------
    rng = np.random.default_rng(SEED + 1)
    x_all, y_all = higgs_like(N_ROWS + N_HELDOUT, rng)
    x_tr, y_tr = x_all[:N_ROWS], y_all[:N_ROWS]
    x_te, y_te = x_all[N_ROWS:], y_all[N_ROWS:]
    names = ("hist_gather", "hist_local", "lgbt_partition", "lgbt_cat_group",
             "lgbt_route")
    # scatter: the eager loop, one host read a split
    higgs, _, higgs_ds = train_path(
        "higgs", dict(params, partition_impl="scatter"), x_tr, y_tr, x_te,
        y_te, 10, names)
    phase("main_path", **higgs)
    higgs_launches = higgs["hist_window_launches"]

    # ---- phase 3b: the Higgs path through the partition kernel ------------
    # partition_impl=auto: compact on a card, the split step replayed as a
    # CUDA graph
    compact, _, _ = train_path("higgs_compact", params, x_tr, y_tr, x_te,
                               y_te, 10, names)
    phase("main_path_compact", **compact)
    partition_ab(params, x_tr, y_tr)
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
    # which on a card is the shard-local kernel
    dp_params = dict(params, tree_learner="data", mesh_devices=MESH_SLOTS)
    dp, _, _ = train_path("dp_4x1", dict(dp_params, mesh_shape="4x1"),
                          x_tr, y_tr, x_te, y_te, 10, names)
    auc_gap = abs(float(dp["heldout_auc"]) - float(higgs["heldout_auc"]))
    phase("dp_path_4x1", auc_gap_vs_serial=f"{auc_gap:.3e}", **dp)
    if auc_gap > 1e-4:
        fail(f"4x1 data-parallel AUC {dp['heldout_auc']} is more than 1e-4 "
             f"from the serial path's {higgs['heldout_auc']}")
    dp22, _, _ = train_path("dp_2x2", dict(dp_params, mesh_shape="2x2"),
                            x_tr, y_tr, x_te, y_te, 3, names)
    phase("dp_path_2x2", **dp22)
    torch.cuda.empty_cache()

    # ---- phase 6c: the data-parallel trees against the serial tree --------
    gspmd_trees_identical(higgs_ds, y_tr)
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
          route_device_ms=expo["lgbt_route_device_ms_per_tree"],
          ms_per_tree=expo["ms_per_tree"],
          peak_mem_bytes=expo["peak_mem_bytes"])
    expo_launches = {k: expo[f"{k}_launches"] for k in (
        "partition_window", "cat_group_accept", "route_window")}
    del bst
    torch.cuda.empty_cache()

    # ---- phase 7: the graph loop against the eager loop, Expo -------------
    expo_loops = graph_vs_eager("expo", ds, y_tr, names, ordered_bins="on")
    del ds
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
    phase("total", seconds=f"{time.perf_counter() - t_start:.1f}",
          higgs_ms_per_tree_scatter=higgs["ms_per_tree"],
          higgs_ms_per_tree_compact=compact["ms_per_tree"],
          higgs_graph_ms_per_tree=higgs_loops["graph_ms_per_tree"],
          higgs_eager_ms_per_tree=higgs_loops["eager_ms_per_tree"],
          expo_graph_ms_per_tree=expo_loops["graph_ms_per_tree"],
          expo_eager_ms_per_tree=expo_loops["eager_ms_per_tree"],
          higgs_ms_per_tree_dp_4x1=dp["ms_per_tree"])

    root = timing[N_ROWS]
    proot = part_timing[N_EXPO]
    rroot = route_timing["expo_root"]
    lroot = local_timing[(N_ROWS // 4, "all")]
    print(json.dumps({"kernels": [{
        "name": "hist_gather", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/hist_gather.cu",
        "replaces": "lightgbm_tpu/ops/pallas_hist.py:223",
        "launches": higgs_launches, "max_abs_err": max_err_f32,
        "ms": root["ms"], "plain_ms": root["plain_ms"],
        "bound_ms": root["bound_ms"], "bound_by": "bytes",
        "library_ms": root["library_ms"],
        **small_window_fields(root, timing[4097])}, {
        "name": "hist_local", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/hist_local.cu",
        "replaces": "lightgbm_tpu/ops/pallas_hist.py:284",
        "launches": dp["hist_local_launches"], "max_abs_err": local_err,
        "ms": lroot["ms"], "plain_ms": lroot["plain_ms"],
        "bound_ms": lroot["bound_ms"], "bound_by": "bytes",
        "library_ms": lroot["library_ms"],
        **small_window_fields(lroot, local_timing[(N_ROWS // 4, "small")])
    }, {
        "name": "partition", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/partition.cu",
        "replaces": "lightgbm_tpu/ops/pallas_compact.py:98",
        "launches": LAUNCHES * expo_launches["partition_window"],
        "calls": expo_launches["partition_window"], "max_abs_err": 0.0,
        "ms": proot["ms"], "plain_ms": proot["plain_ms"],
        "bound_ms": proot["bound_ms"], "bound_by": "bytes",
        "library_ms": proot["library_ms"],
        **{k: v for k, v in proot.items() if k in (
            "ms_many", "device_ms", "library_ms_many", "library_device_ms",
            "sort_form_ms", "sort_form_ms_many", "sort_form_device_ms",
            "launches_a_call")},
        **{f"{k}_4097": v for k, v in part_timing[4097].items()}}, {
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
        "sass_cycles_per_accept": group_lat.get("cycles_per_accept")}, {
        "name": "route", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/route.cu",
        "replaces": "lightgbm_tpu/grower.py:372",
        "launches": expo_launches["route_window"], "max_abs_err": 0.0,
        "ms": rroot["ms"], "plain_ms": rroot["plain_ms"],
        "bound_ms": rroot["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ms_many": rroot["ms_many"],
        "device_ms": rroot["device_ms"],
        "replaced_ms": rroot["replaced_ms"],
        "replaced_device_ms": rroot["replaced_device_ms"],
        **{f"{k}_{w}": v for w in ("higgs_root", "higgs_4097")
           for k, v in route_timing[w].items()}}]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
