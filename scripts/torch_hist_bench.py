#!/usr/bin/env python3
"""Time the histogram kernels of lightgbm_tpu_torch on one CUDA card.

    python3 scripts/torch_hist_bench.py [--baseline DIR] [--out FILE]

Builds ``hist_gather`` (K1) and ``hist_local`` (K3), checks every launch
design below against the plain version (exact under integer weights), and
times, in turns within one process, at the main paths' shapes:

* K1 on windows of 1,024 to 1,000,000 rows of a shuffled 1,000,000 x 28
  ``order``: the small regime, the large regime, the large regime under
  the root's bound (a small child of a large parent, as in a tree), the
  launch plan's own choice, the small regime on a quarter of its grid,
  and ``index_add_`` over the pre-gathered rows;
* K3 on 250,000 x 28 and 500,000 x 14 row shards, at leaves of about 1,000
  to 45,000 rows and at all rows, with the same designs.

Each number is CUDA events around 200 back-to-back calls, divided by
their count (``chip_smoke.cuda_ms_many``), and for the plan's choice, the
small regime, the large regime, the baseline and
``index_add_`` also the profiler's device time per call
(``chip_smoke.profiled_ms``).  At 4,097 rows and at the 1,000-row leaves
it also gives the host's time per call.  With ``--baseline DIR``, a
checkout of an earlier commit, its ``hist_window`` and ``hist_local``
wrappers and kernels are built from DIR and timed beside the current ones
(K3's with the leaf's row count as its bound where its wrapper takes one).
It also prints the shared- and global-memory atomic instructions that
``cuobjdump -sass`` finds in each kernel.  Results go to ``--out`` as
JSON lines (default ``hist_bench.jsonl`` in the working directory).
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (N_BINS, cuda_ms_many, local_bound_ms,  # noqa: E402
                        profiled_ms, window_bound_ms)

SEED = 20240611
WINDOWS = (1024, 4097, 8192, 16384, 32768, 65536, 131072, 262144, 1_000_000)
LEAF_ROWS = (1000, 4000, 16000, 32000, 45000)
PROFILED = ("plan", "small", "small_grid4", "large", "large_bound_1M",
            "baseline", "index_add_")


def time_calls(calls: dict) -> dict:
    """Each call's time in ms, in turns (forward, then backward): CUDA
    events around back-to-back calls (the smaller of the two turns), and
    for the designs in PROFILED the profiler's device time per call, all
    device events and the kernels alone."""
    turns = {k: [] for k in calls}
    for turn in (calls, dict(reversed(list(calls.items())))):
        for k, fn in turn.items():
            turns[k].append(cuda_ms_many(fn))
    dev = {k: profiled_ms(fn) for k, fn in calls.items() if k in PROFILED}
    return dict(ms={k: min(v) for k, v in turns.items()}, ms_turns=turns,
                device_ms={k: v[0] for k, v in dev.items()},
                device_kernel_ms={k: v[1] for k, v in dev.items()})


def host_us(fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` in microseconds: the enqueue, while the
    card keeps up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def load_baseline_ops(root: str):
    """The ``ops`` package of the checkout at ``root``, under another name,
    so that its ``build`` module builds that checkout's sources."""
    pkg = os.path.join(root, "lightgbm_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        "baseline_ops", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_ops"] = mod
    spec.loader.exec_module(mod)
    importlib.import_module("baseline_ops.build").build_all(
        ["hist_gather", "hist_local"])
    return importlib.import_module("baseline_ops.histogram")


def sass_atomics(path: str) -> dict:
    """Atomic and reduction opcodes per kernel in the library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=120).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Z0-9.]*)", line)
        if m and fn:
            ops = out.setdefault(fn, {})
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return out


def main() -> None:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--out", default="hist_bench.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this bench needs a "
                 "CUDA card")
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.ops.histogram import (hist_local,
                                                  hist_local_plain,
                                                  hist_window,
                                                  hist_window_plain,
                                                  plan_launch, sm_count)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    sink = open(args.out, "w")

    def emit(**rec):
        print(json.dumps(rec), flush=True)
        sink.write(json.dumps(rec) + "\n")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit(card=smi.splitlines()[0] if smi else "nvidia-smi unavailable",
         torch=torch.__version__, cuda=torch.version.cuda)
    logs = build.build_all(["hist_gather", "hist_local"])
    emit(ptxas=[ln.strip() for t in logs.values() for ln in t.splitlines()
                if "Used" in ln or "spill" in ln])
    for name in ("hist_gather", "hist_local"):
        emit(sass=name, atomics=sass_atomics(build.library_path(name)))
    base = load_baseline_ops(args.baseline) if args.baseline else None

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n, f = 1_000_000, 28
    bins = torch.from_numpy(rng.integers(0, N_BINS, (n, f),
                                         dtype=np.uint8)).to(dev)
    order = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    w_int = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-8, 9, n).astype(np.float32),
        rng.integers(0, 5, n).astype(np.float32), np.ones(n, np.float32))]
    w_f32 = [torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal(n).astype(np.float32),
        rng.uniform(0.0, 0.25, n).astype(np.float32),
        np.ones(n, np.float32))]

    sms = sm_count(torch.cuda.current_device())

    def designs(bound, fc, n_loc=None):
        """name -> launch plan ("plan": the host's plan at the bound, which
        hist_window picks itself and hist_local is given)."""
        plan = lambda b, **kw: plan_launch(b, fc, N_BINS, n_loc,
                                           num_sms=sms, **kw)
        small = plan(bound, small_max_rows=1 << 62)
        d = {"plan": None if n_loc is None else plan(bound), "small": small,
             # the small regime's grid-stride loops on a quarter of its grid
             "small_grid4": small._replace(grid_x=-(-small.grid_x // 4)),
             # a shard's large grid does not depend on the bound
             "large": plan(bound, small_max_rows=-1)}
        if n_loc is None:   # a small child of a large parent, as in a tree
            d["large_bound_1M"] = plan(n)
        return d

    # ---- K1 ---------------------------------------------------------------
    for cnt in WINDOWS:
        start = 0 if cnt == n else 40000
        sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
        plain = hist_window_plain(order, sc, bins, *w_int, N_BINS)
        calls = {}
        for name, plan in designs(cnt, f).items():
            got = hist_window(order, sc, bins, *w_int, N_BINS, cnt, plan)
            if not torch.equal(got, plain):
                emit(kernel="hist_gather", rows=cnt, design=name,
                     error="differs from the plain version")
                continue
            calls[name] = (lambda p=plan: hist_window(
                order, sc, bins, *w_f32, N_BINS, cnt, p))
        if base is not None:
            calls["baseline"] = lambda: base.hist_window(
                order, sc, bins, *w_f32, N_BINS, cnt)
        idx = order[start:start + cnt].long()
        flat = (bins.index_select(0, idx).long() + torch.arange(
            f, device=dev) * N_BINS).reshape(-1)
        vals = torch.stack([w[idx] for w in w_f32], -1)[:, None, :].expand(
            -1, f, 3).reshape(-1, 3).contiguous()
        acc = torch.zeros((f * N_BINS, 3), device=dev)
        calls["index_add_"] = lambda: acc.index_add_(0, flat, vals)
        if cnt == 4097:
            emit(host_us={k: host_us(calls[k]) for k in (
                "plan", "baseline", "index_add_") if k in calls},
                 empty_us=host_us(lambda: torch.empty(
                     (f, N_BINS, 3), device=dev)), rows=cnt)
        emit(kernel="hist_gather", rows=cnt, features=f,
             plan=plan_launch(cnt, f, N_BINS, num_sms=sms)._asdict(),
             bound_ms=window_bound_ms(cnt, f), **time_calls(calls))
        del flat, vals, acc, idx

    # ---- K3 ---------------------------------------------------------------
    n_leaves = 255
    p = 1.0 / np.arange(1, n_leaves + 1) ** 1.1
    for n_loc, fc in ((n // 4, f), (n // 2, f // 2)):
        sbins = bins[:n_loc, :fc].contiguous()
        sw_int = [w[:n_loc] for w in w_int]
        sw_f32 = [w[:n_loc] for w in w_f32]
        skewed = rng.choice(n_leaves, n_loc, p=p / p.sum()).astype(np.int32)
        counts = np.bincount(skewed, minlength=n_leaves)
        skewed_d = torch.from_numpy(skewed).to(dev)
        cases = [("all", torch.zeros(n_loc, dtype=torch.int32, device=dev),
                  0, n_loc)]
        for want in LEAF_ROWS:
            leaf = int(np.argmin(np.abs(counts - want)))
            cases.append((f"leaf~{want}", skewed_d, leaf, int(counts[leaf])))
        for name, row_leaf, leaf, cnt in cases:
            lid = torch.tensor([leaf], dtype=torch.int32, device=dev)
            plain = hist_local_plain(row_leaf, lid, sbins, *sw_int, N_BINS)
            calls = {}
            for dname, plan in designs(cnt, fc, n_loc).items():
                got = hist_local(row_leaf, lid, sbins, *sw_int, N_BINS,
                                 plan=plan)
                if not torch.equal(got, plain):
                    emit(kernel="hist_local", shard=f"{n_loc}x{fc}",
                         leaf=name, design=dname,
                         error="differs from the plain version")
                    continue
                calls[dname] = (lambda pl=plan: hist_local(
                    row_leaf, lid, sbins, *sw_f32, N_BINS, plan=pl))
            if base is not None:
                # a baseline that takes the leaf's bound gets it, as the
                # grower gives it
                kw = ({"rows_upper_bound": cnt} if "rows_upper_bound" in
                      inspect.signature(base.hist_local).parameters else {})
                calls["baseline"] = lambda: base.hist_local(
                    row_leaf, lid, sbins, *sw_f32, N_BINS, **kw)
            idx = torch.nonzero(row_leaf == leaf).view(-1)
            flat = (sbins.index_select(0, idx).long() + torch.arange(
                fc, device=dev) * N_BINS).reshape(-1)
            vals = torch.stack([w[idx] for w in sw_f32], -1)[:, None, :
                                                             ].expand(
                -1, fc, 3).reshape(-1, 3).contiguous()
            acc = torch.zeros((fc * N_BINS, 3), device=dev)
            calls["index_add_"] = lambda: acc.index_add_(0, flat, vals)
            if name == "leaf~1000":
                emit(host_us={k: host_us(calls[k]) for k in (
                    "plan", "baseline", "index_add_") if k in calls},
                     shard=f"{n_loc}x{fc}", leaf=name)
            emit(kernel="hist_local", shard=f"{n_loc}x{fc}", leaf=name,
                 rows=cnt, plan=plan_launch(cnt, fc, N_BINS, n_loc,
                                            num_sms=sms)._asdict(),
                 bound_ms=local_bound_ms(n_loc, cnt, fc),
                 **time_calls(calls))
    sink.close()


if __name__ == "__main__":
    main()
