#!/usr/bin/env python3
"""Time the lambdarank gradient kernel of lightgbm_tpu_torch on one CUDA
card.

    python3 scripts/torch_lambdarank_bench.py [--baseline DIR] [--out FILE]

Builds ``csrc/lambdarank.cu`` and, on an MS-LTR-shaped training set made
by ``chip_smoke.py``'s generators (18,919 queries, 2,270,296 rows, labels
0-4 in MSLR-WEB30K's shares) at random scores, checks it against the
plain version at phase 2h's tolerance and for the same bits on a second
launch, then times it: single (``chip_smoke.cuda_ms``), back to back
(``cuda_ms_many``) and the profiler's device time (``profiled_ms``), the
whole schedule and each kind of work item alone (the warp bundles, the
whole queries of one block, the long queries' prefixes and tiles), beside
the bound (``chip_smoke.lambdarank_bound_ms``) and each kind's pair slots
(1,024 a 32 x 32 warp tile, counted on the host) against its pairs of
unequal labels (``chip_smoke.lambdarank_pairs``).  With ``--baseline DIR``,
a checkout of an earlier commit, that commit's wrapper and kernel are
built from DIR and timed in turns with the current ones (baseline,
current, current, baseline).  It also counts, from ``cuobjdump -sass``,
the instructions of each fully unrolled 32-step pair sweep (three MUFU
results a step).  Results go to ``--out`` as JSON lines (default
``lambdarank_bench.jsonl`` in the working directory).  Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (MSLR_LONGEST, N_MSLR, Q_MSLR,  # noqa: E402
                        cuda_ms, cuda_ms_many, lambdarank_bound_ms,
                        lambdarank_pairs, mslr_like, profiled_ms,
                        query_sizes)

SEED = 20261018


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
    importlib.import_module("baseline_ops.build").build_all(["lambdarank"])
    return importlib.import_module("baseline_ops.lambdarank")


def pair_slots(lr, sched) -> dict:
    """Pair slots (1,024 a warp tile) of the schedule's items by kind."""
    items = sched.items.cpu().numpy()
    qgroup = sched.qgroup.cpu().numpy()
    gstarts = sched.gstarts.cpu().numpy()
    wq = sched.warp_queries.cpu().numpy()
    tiles = lambda a, b: -(-a // 32) * -(-b // 32)

    def rects(q, e):
        gs = gstarts[qgroup[q]:qgroup[q + 1]]
        return sum(tiles(gs[g + 1] - gs[g], gs[g])
                   for g in range(1, len(gs) - 1) if gs[g] < e)

    out = dict(bundles=0, whole=0, split=0)
    for kind, q, a0, a1, c0, c1, _, _ in items.tolist():
        if kind == lr.WARP_BUNDLE:
            for qq in wq[a0:a0 + a1].tolist():
                m = int(gstarts[qgroup[qq + 1] - 1])
                out["bundles"] += 1 if m <= lr.MASKED_MAX else rects(qq, m)
        elif kind == lr.WHOLE:
            out["whole"] += rects(q, a1)
        else:
            out["split"] += (tiles(c1 - c0, a1 - a0) if kind == lr.PAIR_TILE
                             else rects(q, a1))
    return {k: 1024 * int(v) for k, v in out.items()}


def sweep_instructions(path: str) -> list:
    """Instructions a step of each unrolled pair sweep in the library's
    SASS: runs of 96 MUFU (32 steps of 3) counted from their first to their
    last MUFU, divided by 32.  The warp-synchronous fallback copies that
    the compiler adds for shuffles show as the longer runs."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return []
    ops = [m.group(1) for m in (
        re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", l)
        for l in subprocess.run([tool, "-sass", path], capture_output=True,
                                text=True, timeout=120).stdout.splitlines())
        if m]
    mufu = [i for i, o in enumerate(ops) if o.startswith("MUFU")]
    runs, cur = [], mufu[:1]
    for i in mufu[1:]:
        if i - cur[-1] < 80:
            cur.append(i)
        else:
            runs.append(cur)
            cur = [i]
    runs.append(cur)
    return [round((r[-1] - r[0] + 1) / 32, 2) for r in runs if len(r) == 96]


def main() -> None:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--out", default="lambdarank_bench.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_lambdarank_bench: no CUDA card")
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.ops import lambdarank as lr
    build.build_all(["lambdarank"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    sizes = query_sizes(Q_MSLR, N_MSLR, MSLR_LONGEST, rng)
    _, y = mslr_like(sizes, rng)
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    inv, gains, disc = lr.lambdarank_tables(y, bounds, None, 20)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    call = (put(rng.standard_normal(len(y)).astype(np.float32)),
            put(y.astype(np.int32)), put(bounds), put(inv), put(gains),
            put(disc), 1.0)
    longest = int(sizes.max())
    sched = lr.lambdarank_schedule(y, bounds, gains).to(dev)
    kernel = lambda s=sched: lr.lambdarank_grad(*call, max_len=longest,
                                                schedule=s)
    g, h = kernel()
    pg, ph, la, ha = lr.lambdarank_grad_plain(*call, abs_sums=True)
    g2, h2 = kernel()
    torch.cuda.synchronize()
    held = bool((((g - pg).abs() <= 1e-5 * la + 1e-7).all()
                 & ((h - ph).abs() <= 1e-5 * ha + 1e-7).all()).item())
    bound_ms, bound_by = lambdarank_bound_ms(y, bounds, sizes < 2, False)
    out = dict(card=torch.cuda.get_device_name(0), rows=len(y),
               queries=len(sizes), items=int(sched.items.shape[0]),
               held_vs_plain=held,
               same_bits=bool(torch.equal(g, g2) and torch.equal(h, h2)),
               bound_ms=bound_ms, bound_by=bound_by,
               ms=cuda_ms(kernel), ms_many=cuda_ms_many(kernel, calls=50),
               device_ms=profiled_ms(kernel, calls=20)[0],
               sweep_instructions_a_step=sweep_instructions(
                   build.library_path("lambdarank")))
    pairs = lambdarank_pairs(y, bounds)
    kind_of = np.where(sizes <= lr.WARP_QUERY_MAX, 0,
                       np.where(sizes <= lr.ITEM_DOCS, 1, 2))
    for k, (name, slots) in enumerate(pair_slots(lr, sched).items()):
        out[f"{name}_pair_slots"] = slots
        out[f"{name}_pairs"] = int(pairs[kind_of == k].sum())
    kinds = sched.items[:, 0]
    for name, mask in (("bundles", kinds == lr.WARP_BUNDLE),
                       ("whole", kinds == lr.WHOLE),
                       ("split", kinds >= lr.PREFIX)):
        sub = dataclasses.replace(sched, items=sched.items[mask].contiguous())
        out[f"{name}_items"] = int(mask.sum())
        out[f"{name}_device_ms"] = profiled_ms(lambda: kernel(sub),
                                               calls=20)[0]
    if args.baseline:
        base = load_baseline_ops(args.baseline)
        extra = ({"schedule": base.lambdarank_schedule(y, bounds, gains).to(
            dev)} if "schedule" in inspect.signature(
                base.lambdarank_grad).parameters else {})
        old = lambda: base.lambdarank_grad(*call, max_len=longest, **extra)
        turns = []
        for name, fn in (("baseline", old), ("current", kernel),
                         ("current", kernel), ("baseline", old)):
            turns.append(dict(name=name, ms=cuda_ms(fn),
                              ms_many=cuda_ms_many(fn, calls=50),
                              device_ms=profiled_ms(fn, calls=20)[0]))
        out["turns"] = turns
    print(json.dumps(out), flush=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(out) + "\n")
    if not held or not out["same_bits"]:
        sys.exit("torch_lambdarank_bench: the kernel disagrees with its plain "
                 "version or with itself")


if __name__ == "__main__":
    main()
