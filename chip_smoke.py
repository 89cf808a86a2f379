#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing one line of numbers; any failure exits non-zero:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. build every kernel from ``lightgbm_tpu_torch/csrc`` (one nvcc per
   source, all started together);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (1,000,000 x 28 uint8 bins): exact under integer-valued
   weights, a stated tolerance under float weights; with times;
3. the main path at full width: seeded synthetic Higgs-shaped data
   (1,000,000 x 28 float32, binary label from a fixed nonlinear rule plus
   noise, 100,000 held-out rows), ``train`` 10 rounds with 255 leaves and
   255 bins, ``predict`` the held-out rows; the histogram kernel must have
   launched once per tree plus once per split;
4. the card against the CPU on a 50,000-row subset, 3 rounds.

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


def auc(score: np.ndarray, label: np.ndarray) -> float:
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.metadata import Metadata
    from lightgbm_tpu_torch.metrics import AUCMetric
    m = AUCMetric(Config())
    md = Metadata(len(label))
    md.set_label(label)
    m.init(md, len(label))
    return m.eval(np.asarray(score, np.float64)[None], None)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    from lightgbm_tpu_torch import Dataset, train
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

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    for name in build.KERNEL_SOURCES:
        build.load(name)
    ptxas = " | ".join(line.strip() for text in logs.values()
                       for line in text.splitlines() if "Used" in line)
    phase("build", seconds=f"{time.perf_counter() - t0:.3f}",
          kernels=",".join(build.KERNEL_SOURCES), ptxas=repr(ptxas))

    # ---- phase 2: kernel vs plain on the card -----------------------------
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

    # times at the root window (the main path's largest call, N rows) and
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
    del bins, order, w_int, w_f32
    torch.cuda.empty_cache()

    # ---- phase 3: the main path at full width ---------------------------
    rng = np.random.default_rng(SEED + 1)
    x_all, y_all = higgs_like(N_ROWS + N_HELDOUT, rng)
    x_tr, y_tr = x_all[:N_ROWS], y_all[:N_ROWS]
    x_te, y_te = x_all[N_ROWS:], y_all[N_ROWS:]
    params = dict(objective="binary", num_leaves=255, max_bin=N_BINS,
                  min_data_in_leaf=1, min_sum_hessian_in_leaf=100,
                  learning_rate=0.1, verbose=0, device="cuda")
    t0 = time.perf_counter()
    ds = Dataset(x_tr, y_tr, params=params).construct()
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    hist_window.launches = 0
    t0 = time.perf_counter()
    bst = train(params, ds, num_boost_round=10, verbose_eval=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = hist_window.launches
    stats = dict(bst.inner.stats)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    pred = bst.predict(x_te)
    t_pred = time.perf_counter() - t0
    expected = stats["trees"] + stats["splits"]
    if launches != expected or launches == 0:
        fail(f"histogram kernel launched {launches} times on the main path, "
             f"expected trees + splits = {expected}")
    if pred.shape != (N_HELDOUT,) or not np.isfinite(pred).all():
        fail("held-out predictions are not finite of the expected shape")
    test_auc = auc(pred, y_te)
    if not 0.6 < test_auc <= 1.0:
        fail(f"held-out AUC {test_auc} is not that of a learned model")
    trees = stats["trees"]

    # device time of the histogram kernel over two more trees
    import torch.profiler as tp
    prof_bst = train(params, ds, num_boost_round=2, verbose_eval=False)
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            prof_bst.update()
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    # device-side events only (kernels, copies): CPU ops would count
    # their kernels' time a second time
    dev_us = {e.key: (getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
    hist_us = sum(v for k, v in dev_us.items() if "hist_gather" in k)
    all_us = sum(dev_us.values())
    hist_ms_tree = (f"{hist_us / 2e3:.3f}" if hist_us else "not measured")
    phase("main_path", rows=N_ROWS, features=N_FEAT, trees=trees,
          splits=stats["splits"], hist_launches=launches,
          construct_s=f"{t_data:.3f}",
          ms_per_tree=f"{t_train * 1e3 / trees:.2f}",
          host_syncs_per_split=f"{stats['host_syncs'] / stats['splits']:.4f}",
          peak_mem_bytes=peak, predict_s=f"{t_pred:.3f}",
          heldout_auc=f"{test_auc:.6f}",
          hist_kernel_ms_per_tree=hist_ms_tree,
          hist_share_of_tree=(f"{hist_us / 1e3 / (t_prof * 1e3):.4f}"
                              if hist_us else "not measured"),
          device_busy_share=(f"{all_us / 1e3 / (t_prof * 1e3):.4f}"
                             if all_us else "not measured"))
    del ds, bst, prof_bst
    torch.cuda.empty_cache()

    # ---- phase 4: card against CPU ----------------------------------------
    sub = 50_000
    out = {}
    for device in ("cpu", "cuda"):
        p = dict(params, device=device)
        b = train(p, Dataset(x_tr[:sub], y_tr[:sub], params=p),
                  num_boost_round=3, verbose_eval=False)
        first = b.inner.models[0]
        out[device] = (first.split_feature.copy(), first.threshold.copy(),
                       b.predict(x_te[:sub]), b.predict(x_te[:sub],
                                                        raw_score=True))
    (fc, tc, pc, rc), (fg, tg, pg, rg) = out["cpu"], out["cuda"]
    if not (np.array_equal(fc, fg) and np.array_equal(tc, tg)):
        fail("first tree differs between the card and the CPU")
    pdiff = float(np.abs(pc - pg).max())
    adiff = abs(auc(pc, y_te[:sub]) - auc(pg, y_te[:sub]))
    if pdiff > 1e-4 or adiff > 1e-4:
        fail(f"card vs CPU: prediction diff {pdiff}, AUC diff {adiff}")
    phase("card_vs_cpu", rows=sub, rounds=3, first_tree_identical=True,
          max_pred_diff=f"{pdiff:.3e}",
          max_raw_diff=f"{float(np.abs(rc - rg).max()):.3e}",
          auc_diff=f"{adiff:.3e}")

    root = timing[N_ROWS]
    print(json.dumps({"kernels": [{
        "name": "hist_gather", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/hist_gather.cu",
        "replaces": "lightgbm_tpu/ops/pallas_hist.py:223",
        "launches": launches, "max_abs_err": max_err_f32,
        "ms": root["ms"], "plain_ms": root["plain_ms"],
        "bound_ms": root["bound_ms"], "bound_by": "bytes",
        "library_ms": root["library_ms"]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
