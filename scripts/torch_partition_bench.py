#!/usr/bin/env python3
"""Check and time the partition (K2) and cat_group kernels of
lightgbm_tpu_torch on one CUDA card.

    python3 scripts/torch_partition_bench.py [--baseline DIR] [--dev DIR]
                                             [--out FILE] [--check-only]

Builds ``partition`` and ``cat_group`` and checks them, bit for bit,
against their plain versions: the partition over a grid of the window's
own tiles (``tight``) and over the grid of all rows that the serial
grower's split step launches (``step``), on windows of 0 to 11,000,000
rows of the Expo-shaped path's matrices
(``order``, ``[N, 8]`` uint8 bins and three f32 weights), with left
fractions 0, 1 and 0.43, into a destination full of garbage, and with
payloads of 7 and 28 byte columns; cat_group on the Expo-shaped shape (2 x 8 x 2 x 255) at three count scales, at one
position, with no position ok, with 42 lanes, past 256 positions and with
one minimum group size a leaf.  ``--check-only`` stops there.

Then it times, in turns within one process, at the Expo-shaped path's
shapes: the partition on both grids on windows of 1,024 rows to the
11,000,000-row root, beside a stable ``torch.sort`` of the 0/1 key (one
PyTorch call) and ``partition_window_sort`` (the whole function in
PyTorch calls: the key sort and each matrix's ``index_select``); and
cat_group, on synthetic lanes that accept often and rarely and
on the inputs of every call of one tree of the Expo-shaped path, captured
on the card.  Each number is CUDA events around 200 back-to-back calls
over their count (``chip_smoke.cuda_ms_many``, the smaller of two turns),
the profiler's device time per call (``chip_smoke.profiled_ms``), and at
the root and 4,097 rows the median of single calls
(``chip_smoke.cuda_ms``).  With ``--baseline DIR``, a checkout of an
earlier commit, its partition and cat_group wrappers and kernels are built
from DIR and timed beside the current ones; ``--dev DIR`` does the same
for a checkout whose wrappers take this one's arguments (an earlier
design of the same interface).  It also gives the latency
bound of cat_group from the SASS of its step loop
(``chip_smoke.cat_group_latency``).  Results go to ``--out`` as JSON
lines.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (EXPO_CATEGORICAL, H100_BYTES_PER_S,  # noqa: E402
                        N_BINS, cat_group_bound_ms, cat_group_latency,
                        cuda_ms, cuda_ms_many, expo_like, part_bound_bytes,
                        profiled_ms)

SEED = 20240611
N_ROOT = 11_000_000
WINDOWS = (1024, 2048, 4097, 16384, 65536, 98304, 131072, 131073, 196608,
           262144, 524288, 1_048_576, N_ROOT)
SINGLE = (4097, N_ROOT)


def load_baseline_ops(root: str, name: str = "baseline_ops"):
    """The ``ops`` package of the checkout at ``root``, under the name
    ``name``, so that its ``build`` module builds that checkout's
    sources."""
    pkg = os.path.join(root, "lightgbm_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(f"{name}.build").build_all(
        ["partition", "cat_group"])
    return (importlib.import_module(f"{name}.partition"),
            importlib.import_module(f"{name}.split"))


def expo_tree_group_inputs(rows: int):
    """The inputs of every cat_group call of the second tree of the
    Expo-shaped path (``rows`` training rows, the path's parameters), as
    the split scan passes them, captured on the card."""
    from lightgbm_tpu_torch import Dataset, train
    from lightgbm_tpu_torch.ops import split as split_mod
    x, y = expo_like(rows, np.random.default_rng(SEED + 3))
    params = dict(objective="binary", num_leaves=255, max_bin=N_BINS,
                  min_data_in_leaf=1, min_sum_hessian_in_leaf=100,
                  learning_rate=0.1, verbose=-1, device="cuda",
                  categorical_feature=EXPO_CATEGORICAL,
                  partition_impl="compact", ordered_bins="on",
                  enable_bundle=False, enable_bin_packing=False)
    ds = Dataset(x, y, params=params)
    bst = train(params, ds, num_boost_round=1, verbose_eval=False)
    captured, kernel = [], split_mod.cat_group_accept

    def record(step, ok, rc, m0, max_cat_group):
        captured.append((step.clone(), ok.clone(), rc.clone(), m0.clone(),
                         max_cat_group))
        return kernel(step, ok, rc, m0, max_cat_group)

    record.__dict__.update(kernel.__dict__)   # its launch counter
    split_mod.cat_group_accept = record
    try:
        bst.update()
    finally:
        split_mod.cat_group_accept = kernel
    return captured


def time_calls(calls: dict, single=False) -> dict:
    """Each call's time in ms, in turns (forward, then backward): CUDA
    events around back-to-back calls (the smaller of the two turns), the
    profiler's device time per call, and with ``single`` the median of
    single calls."""
    turns = {k: [] for k in calls}
    for turn in (calls, dict(reversed(list(calls.items())))):
        for k, fn in turn.items():
            turns[k].append(cuda_ms_many(fn))
    out = dict(ms_many={k: min(v) for k, v in turns.items()},
               ms_many_turns=turns,
               device_ms={k: profiled_ms(fn)[0] for k, fn in calls.items()})
    if single:
        out["ms_single"] = {k: cuda_ms(fn) for k, fn in calls.items()}
    return out


def main() -> None:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--dev", default=None)
    ap.add_argument("--out", default="partition_bench.jsonl")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this bench needs a "
                 "CUDA card")
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.ops.partition import (SMALL_MAX_ROWS,
                                                  partition_scratch,
                                                  partition_window,
                                                  partition_window_plain,
                                                  partition_window_sort)
    from lightgbm_tpu_torch.ops.split import (cat_group_accept,
                                              cat_group_accept_plain)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    sink = open(args.out, "w")

    def emit(**rec):
        print(json.dumps(rec), flush=True)
        sink.write(json.dumps(rec) + "\n")
        sink.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         timeout=60).stdout.strip()
    emit(card=smi.splitlines()[0] if smi else "nvidia-smi unavailable",
         torch=torch.__version__, cuda=torch.version.cuda)
    logs = build.build_all(["partition", "cat_group"])
    emit(ptxas=[ln.strip() for t in logs.values() for ln in t.splitlines()
                if "Used" in ln or "spill" in ln or "Compiling" in ln])
    lat = {"kernel": cat_group_latency(
        build.library_path("cat_group"), "lgbt_cat_group_kernel",
        os.path.join(out_dir, "cat_group.sass"))}
    dev_part = dev_split = None
    if args.dev:
        dev_part, dev_split = load_baseline_ops(args.dev, "dev_ops")
        lat["dev"] = cat_group_latency(
            sys.modules["dev_ops.build"].library_path("cat_group"),
            "lgbt_cat_group_kernelILi0E")
    emit(cat_group_latency=lat)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n = N_ROOT
    src = [torch.randperm(n, device=dev, generator=gen).int(),
           torch.randint(0, 256, (n, 8), dtype=torch.uint8, device=dev,
                         generator=gen),
           *[torch.randn(n, device=dev, generator=gen) for _ in range(3)]]
    dst = [torch.empty_like(t) for t in src]
    scratch = partition_scratch(n, dev)
    # the grid's bound: the window's own count, or every row as in the
    # split step
    grids = {"tight": lambda cnt: cnt, "step": lambda cnt: n}
    sc_of = lambda start, cnt: torch.tensor([start, cnt], dtype=torch.int64,
                                            device=dev)

    # ---- checks -------------------------------------------------------------
    windows = [(0, 0), (5, 1), (77, 511), (1000, 4096), (40000, 4097),
               (3, SMALL_MAX_ROWS - 1), (9, SMALL_MAX_ROWS),
               (11, SMALL_MAX_ROWS + 1), (600000, 65536),
               (123457, 1_000_000), (n - 4097, 4097), (0, n)]
    ref = [torch.empty_like(t) for t in src]
    checked = 0
    for start, cnt in windows:
        sc = sc_of(start, cnt)
        for frac in (0.0, 1.0, 0.43):
            gl = torch.rand(n, device=dev, generator=gen) < frac
            npl = partition_window_plain(src, ref, start, cnt, gl)
            for grid, bound in grids.items():
                for t in dst:   # garbage
                    t.view(torch.uint8).random_(generator=gen)
                nk = partition_window(src, dst, sc, gl, bound(cnt), scratch)
                torch.cuda.synchronize()
                same = torch.equal(nk, npl) and all(
                    torch.equal(a[start:start + cnt], b[start:start + cnt])
                    for a, b in zip(dst, ref))
                checked += 1
                if not same:
                    emit(error="partition differs from the plain version",
                         window=[start, cnt], frac=frac, grid=grid)
                    sys.exit(1)
    # rows that are not whole words (7 bytes), and wide rows (28 bytes)
    for f in (7, 28):
        m = 300_000
        s2 = [torch.randperm(m, device=dev, generator=gen).int(),
              torch.randint(0, 256, (m, f), dtype=torch.uint8, device=dev,
                            generator=gen)]
        for start, cnt in ((3, 4097), (1, SMALL_MAX_ROWS + 1), (0, m)):
            gl = torch.rand(m, device=dev, generator=gen) < 0.43
            r2 = [torch.empty_like(t) for t in s2]
            npl = partition_window_plain(s2, r2, start, cnt, gl)
            for grid, bound in (("tight", cnt), ("step", m)):
                d2 = [torch.full_like(t, 3) for t in s2]
                nk = partition_window(s2, d2, sc_of(start, cnt), gl, bound,
                                      scratch)
                torch.cuda.synchronize()
                if not torch.equal(nk, npl) or not all(
                        torch.equal(a[start:start + cnt], b[start:start + cnt])
                        for a, b in zip(d2, r2)):
                    emit(error="partition differs from the plain version",
                         width=f, window=[start, cnt], grid=grid)
                    sys.exit(1)
                checked += 1
    emit(partition_checked=checked, exact=True)

    def group_inputs(shape, mean=40.0, per_leaf=False, none_ok=False):
        g = np.random.default_rng(sum(shape) + int(mean))
        t = lambda a: torch.from_numpy(a).to(dev)
        m0 = np.maximum(1.0, np.floor(g.integers(1, 10 ** 6, shape[:-1])
                                      / 64.0)).astype(np.float32)
        if per_leaf:
            m0 = np.ascontiguousarray(m0[:, :1, :1])
        ok = g.random(shape) < 0.8
        return (t(g.poisson(mean, shape).astype(np.float32)),
                t(ok & (not none_ok)),
                t(g.integers(0, 10 ** 6, shape).astype(np.float32)), t(m0))

    expo = (2, 8, 2, 255)
    cases = {f"mean_count_{m:g}": group_inputs(expo, m)
             for m in (1.0, 40.0, 4000.0)}
    cases.update(one_position=group_inputs((2, 8, 2, 1)),
                 none_ok=group_inputs(expo, none_ok=True),
                 lanes_42=group_inputs((3, 7, 2, 255)),
                 positions_300=group_inputs((1, 3, 2, 300), 4000.0),
                 mdpg0_per_leaf=group_inputs(expo, per_leaf=True))
    for name, c in cases.items():
        p = cat_group_accept_plain(*c, 64)
        k = cat_group_accept(*c, 64)
        torch.cuda.synchronize()
        if k.dtype != torch.bool or not torch.equal(k, p):
            emit(error="cat_group differs from the plain loop", case=name)
            sys.exit(1)
    emit(cat_group_checked=list(cases), exact=True)
    if args.check_only:
        sink.close()
        return

    # ---- times --------------------------------------------------------------
    base_part = base_split = None
    if args.baseline:
        base_part, base_split = load_baseline_ops(args.baseline)
        # the parent's kernel partitions in place, with its own scratch
        bsrc = [t.clone() for t in src]
        bscratch = base_part.partition_scratch(bsrc[0], bsrc[1:])
    widths = [t[0].numel() * t.element_size() for t in src]
    for cnt in WINDOWS:
        start = 0 if cnt == n else 40000
        sc = sc_of(start, cnt)
        gl = torch.rand(n, device=dev, generator=gen) < 0.43
        key = (~gl[:cnt]).to(torch.uint8)
        calls = {g: (lambda b=b(cnt): partition_window(src, dst, sc, gl, b,
                                                       scratch))
                 for g, b in grids.items()}
        if dev_part is not None:
            calls["dev"] = lambda: dev_part.partition_window(
                src, dst, sc, gl, cnt, scratch)
        if base_part is not None:
            gl8 = gl.to(torch.uint8)
            sc32 = sc.int()
            calls["baseline"] = lambda: base_part.partition_window(
                bsrc[0], sc32, gl8, bsrc[1:], rows_upper_bound=cnt,
                scratch=bscratch)
        calls["key_sort"] = lambda: torch.sort(key, stable=True)
        calls["sort_form"] = lambda: partition_window_sort(src, dst, start,
                                                           cnt, gl)
        rec = time_calls(calls, single=cnt in SINGLE)
        if cnt in SINGLE:
            rec["plain_ms_single"] = cuda_ms(lambda: partition_window_plain(
                src, dst, start, cnt, gl), reps=3)
        nbytes = part_bound_bytes(cnt, widths)
        emit(kernel="partition", rows=cnt, payload_row_bytes=sum(widths),
             bound_bytes=nbytes, bound_ms=nbytes / H100_BYTES_PER_S * 1e3,
             **rec)

    def bound(name, positions, accepts):
        la = lat[name]
        return (cat_group_bound_ms(la, positions, accepts)
                if "cycles_per_add" in la else None)

    # mean count 4000 accepts about every fourth position, as a lane of
    # the Expo-shaped path does; mean count 40 rarely
    for case in ("mean_count_4000", "mean_count_40"):
        step, ok, rc, m0 = cases[case]
        calls = {"kernel": lambda: cat_group_accept(step, ok, rc, m0, 64)}
        if dev_split is not None:
            calls["dev"] = lambda: dev_split.cat_group_accept(step, ok, rc,
                                                              m0, 64)
        if base_split is not None:
            m0_full = m0.expand(ok.shape[:-1]).contiguous()
            calls["baseline"] = lambda: base_split.cat_group_accept(
                step, ok, rc, m0_full, 64)
        rec = time_calls(calls, single=True)
        acc = cat_group_accept_plain(step, ok, rc, m0, 64)
        rec["plain_ms_single"] = cuda_ms(
            lambda: cat_group_accept_plain(step, ok, rc, m0, 64), reps=3)
        accepts = int(acc.view(-1, expo[-1]).sum(1).max())
        emit(kernel="cat_group", case=case, shape="x".join(map(str, expo)),
             max_accepts_a_lane=accepts,
             latency_bound_ms={d: bound(d, expo[-1], accepts)
                               for d in lat}, **rec)

    # the Expo-shaped path's own inputs: one tree's calls, back to back
    tree = expo_tree_group_inputs(N_ROOT)
    for c in tree[::25]:
        if not torch.equal(cat_group_accept(*c), cat_group_accept_plain(*c)):
            emit(error="cat_group differs from the plain loop on a path call")
            sys.exit(1)
    acc = [cat_group_accept_plain(*c).view(-1, c[1].shape[-1]).sum(1)
           for c in tree]
    accepts = torch.stack([a.max() for a in acc]).cpu().numpy()
    calls = {"kernel": lambda: [cat_group_accept(*c) for c in tree]}
    if dev_split is not None:
        calls["dev"] = lambda: [dev_split.cat_group_accept(*c) for c in tree]
    if base_split is not None:
        full = [(c[0], c[1], c[2], c[3].expand(c[1].shape[:-1]).contiguous(),
                 c[4]) for c in tree]
        calls["baseline"] = lambda: [base_split.cat_group_accept(*c)
                                     for c in full]
    rec = time_calls(calls)
    emit(kernel="cat_group", case="expo_tree", calls=len(tree),
         shape="x".join(map(str, tree[0][1].shape)),
         max_accepts_a_lane_mean=float(accepts.mean()),
         max_accepts_a_lane_max=int(accepts.max()),
         latency_bound_ms_per_tree={
             d: sum(bound(d, c[1].shape[-1], int(a))
                    for c, a in zip(tree, accepts))
             if "cycles_per_add" in lat[d] else None for d in lat},
         **rec)
    sink.close()


if __name__ == "__main__":
    main()
