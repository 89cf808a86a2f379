#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing one line of numbers; any failure exits non-zero:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. build every kernel from ``lightgbm_tpu_torch/csrc`` (one nvcc per
   source, all started together);
2. the histogram kernel against its plain PyTorch version on the card, at
   the Higgs path's shapes (1,000,000 x 28 uint8 bins): exact under
   integer-valued weights, a stated tolerance under float weights; with
   times;
2b. the partition kernel against its plain version: windows of 0 to
   1,000,000 rows of a shuffled 1,000,000-row ``order`` with the
   ordered-mode payload of 28 bin columns, and the full root window of
   the Expo-shaped path, all left, all right and random: window, payload
   and left count identical bit for bit; with times;
2c. the max_cat_group kernel of the categorical split scan against its
   plain loop at the Expo-shaped path's shape: accepts identical;
3. the Higgs path at full width: seeded synthetic Higgs-shaped data
   (1,000,000 x 28 float32, binary label from a fixed nonlinear rule plus
   noise, 100,000 held-out rows), ``train`` 10 rounds with 255 leaves and
   255 bins, ``predict`` the held-out rows; the histogram kernel must have
   launched once per tree plus once per split;
3b. the same with ``partition_impl=compact``: the partition kernel must
   have been called once per split;
3c. scatter and compact in turns on one dataset, ms per tree;
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
   held-out AUC within 5e-3.

The second-to-last lines are a JSON object of per-kernel numbers and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
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
SEED = 20240611


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **numbers) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


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


def device_ms(fn, names):
    """Run ``fn`` under ``torch.profiler``; returns its wall seconds, the
    device ms of kernels whose name holds each of ``names``, the device ms
    of every kernel and copy (device-side events only: CPU ops would count
    their kernels' time a second time), and the five host operations with
    the most self CPU ms."""
    import torch
    import torch.profiler as tp
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = {e.key: (getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
              for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA}
    per = {n: sum(v for k, v in dev_us.items() if n in k) / 1e3
           for n in names}
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)[:5]
    return wall, per, sum(dev_us.values()) / 1e3, host


def part_bound_bytes(cnt: int, widths) -> int:
    """Least bytes a partition call moves: each window entry's order (4)
    and mask (1) read and order written (4), each payload row read and
    written once."""
    return cnt * (4 + 1 + 4) + 2 * cnt * sum(widths)


def check_partition(dev, rng):
    """Phase 2b: the partition kernel against its plain version."""
    import torch
    from lightgbm_tpu_torch.ops.partition import (partition_scratch,
                                                  partition_window,
                                                  partition_window_plain)

    def payload(n, f, gen):
        return [torch.randint(0, 256, (n, f), dtype=torch.uint8,
                              device=dev, generator=gen),
                *[torch.randn(n, device=dev, generator=gen)
                  for _ in range(3)]]

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    n1 = N_ROWS
    sets = {
        "1M": (torch.randperm(n1, device=dev, generator=gen).int(),
               payload(n1, N_FEAT, gen),
               [(12345, 0), (777, 1), (5000, 511), (40000, 4097),
                (300000, 100000), (0, n1), (n1 - 4097, 4097)]),
        "root": (torch.randperm(N_EXPO, device=dev, generator=gen).int(),
                 payload(N_EXPO, len(EXPO_CATEGORICAL) + 2, gen),
                 [(0, N_EXPO)]),
    }
    checked = 0
    for label, (order, pay, windows) in sets.items():
        scratch = partition_scratch(order, pay)
        for start, cnt in windows:
            for frac in (0.0, 1.0, 0.43):
                gl = (torch.rand(cnt, device=dev, generator=gen)
                      < frac).to(torch.uint8)
                for with_pay in (False, True):
                    k = [order.clone()] + ([p.clone() for p in pay]
                                           if with_pay else [])
                    p = [t.clone() for t in k]
                    sc = torch.tensor([start, cnt], dtype=torch.int32,
                                      device=dev)
                    nk = partition_window(k[0], sc, gl, k[1:],
                                          rows_upper_bound=cnt,
                                          scratch=scratch)
                    npl = partition_window_plain(p[0], start, cnt, gl, p[1:])
                    torch.cuda.synchronize()
                    if not torch.equal(nk, npl) or not all(
                            torch.equal(a, b) for a, b in zip(k, p)):
                        fail(f"partition kernel != plain at window "
                             f"({start}, {cnt}) of {label}, left fraction "
                             f"{frac}, payload {with_pay}")
                    checked += 1
                    del k, p
        phase("partition_vs_plain", set=label, rows=order.numel(),
              windows=len(windows), calls_checked=checked, exact=True)

    # times at the main path's largest call (the root window of the
    # Expo-shaped path, with its ordered payload) and at a 4,097-row window
    order, pay, _ = sets["root"]
    del sets["1M"]
    scratch = partition_scratch(order, pay)
    widths = [p[0].numel() * p.element_size() for p in pay]
    timing = {}
    for start, cnt in ((0, N_EXPO), (40000, 4097)):
        gl = (torch.rand(cnt, device=dev, generator=gen) < 0.43).to(
            torch.uint8)
        sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
        k_ms = cuda_ms(lambda: partition_window(
            order, sc, gl, pay, rows_upper_bound=cnt, scratch=scratch))
        p_ms = cuda_ms(lambda: partition_window_plain(order, start, cnt, gl,
                                                      pay), reps=3)
        key = (1 - gl).contiguous()
        lib_ms = cuda_ms(lambda: torch.sort(key, stable=True))
        nbytes = part_bound_bytes(cnt, widths)
        bound_ms = nbytes / H100_BYTES_PER_S * 1e3
        timing[cnt] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                           bound_ms=bound_ms)
        phase("partition_time", window_rows=cnt,
              payload_row_bytes=sum(widths), kernel_ms=f"{k_ms:.4f}",
              plain_ms=f"{p_ms:.4f}", sort_ms=f"{lib_ms:.4f}",
              bound_bytes=nbytes, bound_ms=f"{bound_ms:.5f}",
              bound_share=f"{bound_ms / k_ms:.3f}")
    return timing


def check_cat_group(dev, rng):
    """Phase 2c: the max_cat_group kernel against its plain loop at the
    Expo-shaped path's shape (2 leaves x 8 features x 2 directions x 255
    positions)."""
    import torch
    from lightgbm_tpu_torch.ops.split import (cat_group_accept,
                                              cat_group_accept_plain)
    shape = (2, len(EXPO_CATEGORICAL) + 2, 2, N_BINS)
    cases = []
    for mean_cnt in (1.0, 40.0, 4000.0):
        step = torch.from_numpy(rng.poisson(mean_cnt, shape).astype(
            np.float32)).to(dev)
        ok = torch.from_numpy(rng.random(shape) < 0.8).to(dev)
        rc = torch.from_numpy(rng.integers(0, 10 ** 6, shape).astype(
            np.float32)).to(dev)
        m0 = torch.from_numpy(np.maximum(1.0, np.floor(
            rng.integers(1, 10 ** 6, shape[:-1]) / 64.0)).astype(
                np.float32)).to(dev)
        k = cat_group_accept(step, ok, rc, m0, 64)
        p = cat_group_accept_plain(step, ok, rc, m0, 64)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            fail(f"cat_group kernel != plain loop at mean count {mean_cnt}")
        cases.append((step, ok, rc, m0))
    step, ok, rc, m0 = cases[1]
    k_ms = cuda_ms(lambda: cat_group_accept(step, ok, rc, m0, 64))
    p_ms = cuda_ms(lambda: cat_group_accept_plain(step, ok, rc, m0, 64),
                   reps=3)
    lanes = ok.numel() // shape[-1]
    nbytes = ok.numel() * (4 + 1 + 4 + 1) + lanes * 4
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    phase("cat_group_vs_plain", shape="x".join(map(str, shape)),
          cases=len(cases), exact=True, kernel_ms=f"{k_ms:.4f}",
          plain_ms=f"{p_ms:.4f}", bound_bytes=nbytes,
          bound_ms=f"{bound_ms:.6f}", bound_share=f"{bound_ms / k_ms:.4f}")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms)


def train_path(name, params, x_tr, y_tr, x_te, y_te, rounds, dev_names):
    """Drive one path through ``train`` and ``predict`` with the kernel
    counts set to 0 just before and read just after; returns its numbers
    and the booster."""
    import torch
    from lightgbm_tpu_torch import Dataset, train
    from lightgbm_tpu_torch.ops.histogram import hist_window
    from lightgbm_tpu_torch.ops.partition import partition_window
    from lightgbm_tpu_torch.ops.split import cat_group_accept
    t0 = time.perf_counter()
    ds = Dataset(x_tr, y_tr, params=params).construct()
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    hist_window.launches = 0
    partition_window.launches = 0
    cat_group_accept.launches = 0
    t0 = time.perf_counter()
    bst = train(params, ds, num_boost_round=rounds, verbose_eval=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    hist_calls = hist_window.launches
    part_calls = partition_window.launches
    group_calls = cat_group_accept.launches
    stats = dict(bst.inner.stats)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    pred = bst.predict(x_te)
    t_pred = time.perf_counter() - t0
    expected = stats["trees"] + stats["splits"]
    if hist_calls != expected or hist_calls == 0:
        fail(f"{name}: histogram kernel launched {hist_calls} times, "
             f"expected trees + splits = {expected}")
    compact = params.get("partition_impl") == "compact"
    if part_calls != (stats["splits"] if compact else 0):
        fail(f"{name}: partition kernel called {part_calls} times with "
             f"partition_impl={params.get('partition_impl', 'auto')}, "
             f"{stats['splits']} splits")
    # one split scan per tree (the root) and per split (both children)
    categorical = bool(ds.constructed.feature_meta()["is_categorical"].any())
    if group_calls != (expected if categorical else 0):
        fail(f"{name}: cat_group kernel launched {group_calls} times, "
             f"expected {expected if categorical else 0}")
    if pred.shape != (len(y_te),) or not np.isfinite(pred).all():
        fail(f"{name}: held-out predictions are not finite of the expected "
             f"shape")
    test_auc = auc(pred, y_te)
    if not 0.6 < test_auc <= 1.0:
        fail(f"{name}: held-out AUC {test_auc} is not that of a learned "
             f"model")

    # device time of the kernels over two more trees
    prof_bst = train(params, ds, num_boost_round=2, verbose_eval=False)
    wall, per, all_ms, host = device_ms(
        lambda: [prof_bst.update() for _ in range(2)], dev_names)
    phase(f"{name}_host_ops", profiled_s=f"{wall:.3f}", **{
        key.replace(" ", "_"): f"{ms / 2:.1f}ms/tree,{count // 2}calls/tree"
        for ms, key, count in host})
    trees = stats["trees"]
    out = dict(rows=len(y_tr), features=x_tr.shape[1], trees=trees,
               splits=stats["splits"], hist_launches=hist_calls,
               partition_calls=part_calls, cat_group_launches=group_calls,
               construct_s=f"{t_data:.3f}",
               ms_per_tree=f"{t_train * 1e3 / trees:.2f}",
               host_syncs_per_split=(
                   f"{stats['host_syncs'] / stats['splits']:.4f}"),
               peak_mem_bytes=peak, predict_s=f"{t_pred:.3f}",
               heldout_auc=f"{test_auc:.6f}")
    for n, ms in per.items():   # 0 for a kernel this path does not run
        out[f"{n}_device_ms_per_tree"] = (f"{ms / 2:.3f}" if all_ms
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.ops.histogram import (hist_window,
                                                  hist_window_plain)

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

    # ---- phase 2: histogram kernel vs plain on the card -------------------
    rng = np.random.default_rng(SEED)
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
    windows = [(12345, 0), (777, 1), (5000, 511), (40000, 4097),
               (300000, 100000), (0, N_ROWS)]
    max_err_f32 = 0.0
    for start, cnt in windows:
        sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
        k_int = hist_window(order, sc, bins, *w_int, N_BINS, cnt)
        p_int = hist_window_plain(order, sc, bins, *w_int, N_BINS)
        torch.cuda.synchronize()
        if not torch.equal(k_int, p_int):
            fail(f"kernel != plain under integer weights at window "
                 f"({start}, {cnt}): max |diff| "
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
        phase("kernel_vs_plain", window=f"{start}+{cnt}", exact_int=True,
              f32_max_abs_err=f"{err.max().item():.3e}",
              f32_max_rel_to_sum_abs=f"{rel:.3e}")

    # times at the root window (the Higgs path's largest call, N rows) and
    # at a 4,097-row split window
    timing = {}
    for start, cnt in ((0, N_ROWS), (40000, 4097)):
        sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
        k_ms = cuda_ms(lambda: hist_window(order, sc, bins, *w_f32, N_BINS,
                                           cnt))
        p_ms = cuda_ms(lambda: hist_window_plain(order, sc, bins, *w_f32,
                                                 N_BINS), reps=3)
        idx = order[start:start + cnt].long()
        rows = bins.index_select(0, idx).long() + (
            torch.arange(N_FEAT, device=dev) * N_BINS)
        vals = torch.stack([w[idx] for w in w_f32], -1)[:, None, :].expand(
            -1, N_FEAT, 3).reshape(-1, 3).contiguous()
        flat = rows.reshape(-1)
        acc = torch.zeros((N_FEAT * N_BINS, 3), device=dev)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, flat, vals))
        nbytes = cnt * (4 + N_FEAT + 3 * 4) + 8 + N_FEAT * N_BINS * 3 * 4
        ops = 3 * N_FEAT * cnt
        bound_ms = max(nbytes / H100_BYTES_PER_S,
                       ops / H100_F32_OPS_PER_S) * 1e3
        timing[cnt] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bytes=nbytes)
        phase("kernel_time", window_rows=cnt, kernel_ms=f"{k_ms:.4f}",
              plain_ms=f"{p_ms:.4f}", index_add_ms=f"{lib_ms:.4f}",
              bound_ms=f"{bound_ms:.5f}", bytes=nbytes,
              bound_share=f"{bound_ms / k_ms:.3f}")
    del bins, order, w_int, w_f32, rows, vals, flat, acc, idx
    torch.cuda.empty_cache()

    # ---- phase 2b: partition kernel vs plain on the card ------------------
    part_timing = check_partition(dev, rng)
    torch.cuda.empty_cache()

    # ---- phase 2c: max_cat_group kernel vs plain on the card --------------
    group_timing = check_cat_group(dev, rng)

    # ---- phase 3: the Higgs path at full width ----------------------------
    rng = np.random.default_rng(SEED + 1)
    x_all, y_all = higgs_like(N_ROWS + N_HELDOUT, rng)
    x_tr, y_tr = x_all[:N_ROWS], y_all[:N_ROWS]
    x_te, y_te = x_all[N_ROWS:], y_all[N_ROWS:]
    params = dict(objective="binary", num_leaves=255, max_bin=N_BINS,
                  min_data_in_leaf=1, min_sum_hessian_in_leaf=100,
                  learning_rate=0.1, verbose=0, device="cuda")
    names = ("hist_gather", "lgbt_partition", "lgbt_cat_group")
    higgs, _, _ = train_path("higgs", params, x_tr, y_tr, x_te, y_te, 10,
                             names)
    phase("main_path", **higgs)
    higgs_launches = higgs["hist_launches"]

    # ---- phase 3b: the Higgs path through the partition kernel ------------
    compact, _, _ = train_path("higgs_compact",
                               dict(params, partition_impl="compact"),
                               x_tr, y_tr, x_te, y_te, 10, names)
    phase("main_path_compact", **compact)
    partition_ab(params, x_tr, y_tr)
    torch.cuda.empty_cache()

    # ---- phase 4: card against CPU ----------------------------------------
    sub = 50_000
    card_vs_cpu("card_vs_cpu", params, x_tr[:sub], y_tr[:sub], x_te[:sub],
                y_te[:sub], ("split_feature", "threshold"), 1e-4, 1e-4)
    del x_all, y_all, x_tr, y_tr, x_te, y_te

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
    expo_launches = (expo["partition_calls"], expo["cat_group_launches"])
    del ds, bst
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
          higgs_ms_per_tree_compact=compact["ms_per_tree"])

    root = timing[N_ROWS]
    proot = part_timing[N_EXPO]
    print(json.dumps({"kernels": [{
        "name": "hist_gather", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/hist_gather.cu",
        "replaces": "lightgbm_tpu/ops/pallas_hist.py:223",
        "launches": higgs_launches, "max_abs_err": max_err_f32,
        "ms": root["ms"], "plain_ms": root["plain_ms"],
        "bound_ms": root["bound_ms"], "bound_by": "bytes",
        "library_ms": root["library_ms"]}, {
        "name": "partition", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/partition.cu",
        "replaces": "lightgbm_tpu/ops/pallas_compact.py:98",
        "launches": expo_launches[0], "max_abs_err": 0.0,
        "ms": proot["ms"], "plain_ms": proot["plain_ms"],
        "bound_ms": proot["bound_ms"], "bound_by": "bytes",
        "library_ms": proot["library_ms"]}, {
        "name": "cat_group", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/cat_group.cu",
        "replaces": "lightgbm_tpu/ops/split.py:300",
        "launches": expo_launches[1], "max_abs_err": 0.0,
        "ms": group_timing["ms"], "plain_ms": group_timing["plain_ms"],
        "bound_ms": group_timing["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
