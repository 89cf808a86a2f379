#!/usr/bin/env python3
"""Time the route_rows and lgbt_traverse kernels of lightgbm_tpu_torch on
one CUDA card, beside an earlier commit's.

    python3 scripts/torch_route_traverse_bench.py [--baseline DIR] [--out FILE]

Builds ``csrc/route.cu`` and ``csrc/traverse.cu`` and times, on inputs made
from a seed with numpy:

* ``route_rows`` on 1,000,000 rows of 28 uint8 columns held as four row
  shards, column-major (the data-parallel learner's copy), at the root
  (every row in the leaf) and at a leaf of about 1,000 rows of a map of
  255 skewed leaves; and on a row-major 262,144 x 137 block (the streamed
  grower's), at its root and at a leaf of about 1,000 rows.  The split is
  a NaN-missing one; new = leaf, so that a call repeats (the same reads
  and writes, the counts unchanged).  Bounds: ``chip_smoke``'s
  ``route_rows_bound_ms`` and, row-major, ``route_block_bound_ms``.
* ``lgbt_traverse`` on 100 synthetic trees of 255 leaves over 28 columns
  (``chip_smoke.synthetic_tables``: random shapes, so not the Higgs
  model's depth), packed words and node tables, at 1, 64, 4,096 and
  65,536 rows (a microbatch bucket's sizes and ``predictor.ROWS_PER_PASS``).

Each call is checked bit for bit against its plain version (and the
baseline's against the current kernel's), then timed: single
(``chip_smoke.cuda_ms``), back to back (``cuda_ms_many``) and the
profiler's device time (``profiled_ms``).  With ``--baseline DIR``, a
checkout of an earlier commit unpacked with ``git archive``, that
commit's wrappers and kernels are built from DIR and timed in turns with
the current ones (baseline, current, current, baseline) on the same
inputs.  Results go to ``--out`` as JSON lines (default
``route_traverse_bench.jsonl`` in the working directory), one a case.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (N_BINS, N_FEAT, N_ROWS, cuda_ms,  # noqa: E402
                        cuda_ms_many, profiled_ms, route_block_bound_ms,
                        route_rows_bound_ms, route_sectors, synthetic_rows,
                        synthetic_tables)

SEED = 20261019
SHARDS, LEAVES = 4, 255
BLOCK_ROWS, BLOCK_COLS = 262_144, 137
TRAVERSE_ROWS = (1, 64, 4096, 1 << 16)


def load_baseline_ops(root: str):
    """The ``route`` and ``traverse`` modules of the checkout at ``root``,
    its package under another name (its ``__init__`` not run, so that
    only what these modules import is loaded), so that its ``build``
    module builds that checkout's sources."""
    parent = types.ModuleType("baseline_pkg")
    parent.__path__ = [os.path.join(root, "lightgbm_tpu_torch")]
    sys.modules["baseline_pkg"] = parent
    importlib.import_module("baseline_pkg.ops.build").build_all(
        ["route", "traverse"])
    return (importlib.import_module("baseline_pkg.ops.route"),
            importlib.import_module("baseline_pkg.ops.traverse"))


def three(fn) -> dict:
    return dict(ms=cuda_ms(fn), ms_many=cuda_ms_many(fn, calls=100),
                device_ms=profiled_ms(fn, calls=50)[0])


def timed(case: dict, cur, base) -> dict:
    """The current call alone, or in turns with the baseline's."""
    if base is None:
        case["current"] = three(cur)
        return case
    case["turns"] = [dict(name=name, **three(fn)) for name, fn in (
        ("baseline", base), ("current", cur), ("current", cur),
        ("baseline", base))]
    return case


def route_cases(dev, rng):
    """(label, row_leaf, bins_t, leaf tensor, split, meta, counts, bound)
    of the four route_rows cases."""
    import torch
    from lightgbm_tpu_torch.grower import FeatureMeta
    from lightgbm_tpu_torch.ops.histogram import movable
    from lightgbm_tpu_torch.ops.route import route_rows_plain
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    p = 1.0 / np.arange(1, LEAVES) ** 1.1
    cases = []
    for layout, n, f in (("column_major", N_ROWS, N_FEAT),
                         ("row_major", BLOCK_ROWS, BLOCK_COLS)):
        meta = FeatureMeta(i32([N_BINS] * f), i32([k % 3 for k in range(f)]),
                           i32([(37 * k) % N_BINS for k in range(f)]))
        host = rng.integers(0, N_BINS, (n, f)).astype(np.uint8)
        block = torch.from_numpy(host).to(dev)
        shards = SHARDS if layout == "column_major" else 1
        bins_t = (movable(block).t().contiguous().view(torch.uint8)
                  if layout == "column_major" else block.t())
        skewed = rng.choice(LEAVES - 1, n, p=p / p.sum()).astype(np.int32)
        sizes = np.bincount(skewed, minlength=LEAVES)
        small = int(np.argmin(np.abs(sizes - 1000)))
        for where, rl, leaf in (("root", np.zeros(n, np.int32), 0),
                                ("leaf_1000", skewed, small)):
            rl = torch.from_numpy(rl).to(dev)
            si = torch.zeros((LEAVES + 1, 3), dtype=torch.int32, device=dev)
            si[leaf] = i32([2, 200, 1])
            cat = torch.zeros(LEAVES + 1, dtype=torch.bool, device=dev)
            catb = torch.zeros((LEAVES + 1, N_BINS), dtype=torch.bool,
                               device=dev)
            lt = i32([leaf]).long()
            cnt = torch.stack([torch.bincount(r.long(), minlength=LEAVES + 1)
                               for r in rl.view(shards, -1)]).int()
            probe = rl.clone()
            route_rows_plain(probe, bins_t, lt, i32([LEAVES - 1]).long(), si,
                             cat, catb, meta, cnt.clone())
            moved = int((probe != rl).sum())
            rows = torch.nonzero(rl == leaf).view(-1)
            bound = (route_rows_bound_ms(n, len(rows), moved)
                     if layout == "column_major" else route_block_bound_ms(
                         n, route_sectors(rows, 2, f, 1, 1), moved, N_BINS))
            cases.append((f"{layout}_{where}", rl, bins_t, lt,
                          (si, cat, catb), meta, cnt, bound,
                          dict(rows=n, leaf_rows=len(rows), moved=moved)))
    return cases


def main() -> None:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--out", default="route_traverse_bench.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_route_traverse_bench: no CUDA card")
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.ops import route as cur_route
    from lightgbm_tpu_torch.ops import traverse as cur_trav
    build.build_all(["route", "traverse"])
    base_route, base_trav = (load_baseline_ops(args.baseline)
                             if args.baseline else (None, None))
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    card = torch.cuda.get_device_name(0)
    results, agree = [], True

    for label, rl, bins_t, lt, split, meta, cnt, bound, info in route_cases(
            dev, rng):
        call = lambda mod: (lambda: mod.route_rows(rl, bins_t, lt, lt, *split,
                                                   meta, cnt))
        # one call that moves rows (new = the last leaf), held against the
        # plain version and the baseline's kernel
        nt = torch.tensor([LEAVES - 1], device=dev)
        got = {}
        for name, fn in (("current", cur_route.route_rows),
                         ("plain", cur_route.route_rows_plain),
                         ("baseline", getattr(base_route, "route_rows",
                                              None))):
            if fn is None:
                continue
            r, c = rl.clone(), cnt.clone()
            fn(r, bins_t, lt, nt, *split, meta, c)
            got[name] = (r, c)
        torch.cuda.synchronize()
        same = all(torch.equal(got["current"][0], v[0])
                   and torch.equal(got["current"][1], v[1])
                   for v in got.values())
        agree &= same
        results.append(timed(dict(kernel="route_rows", case=label, card=card,
                                  bound_ms=bound, exact=same, **info),
                             call(cur_route),
                             call(base_route) if base_route else None))

    tables = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in synthetic_tables(rng, 100, LEAVES, N_FEAT, N_BINS)]
    words = cur_trav.pack_nodes(*tables[:6])
    for n in TRAVERSE_ROWS:
        binned = tuple(torch.from_numpy(a).to(dev)
                       for a in synthetic_rows(rng, N_FEAT, n, N_BINS))
        data = cur_trav.pack_data(binned[0], binned[2], binned[3])
        for layout, b_in, nodes, plain in (
                ("packed", (data,), words, cur_trav.traverse_packed_plain),
                ("xla", binned, tables, cur_trav.traverse_plain)):
            got = cur_trav.traverse(b_in, nodes, layout)
            ref = plain(*b_in, *nodes)
            old = (base_trav.traverse(b_in, nodes, layout) if base_trav
                   else ref)
            torch.cuda.synchronize()
            same = torch.equal(got, ref) and torch.equal(old, ref)
            agree &= same
            plan = cur_trav.call_plan(b_in, nodes, layout)
            results.append(timed(
                dict(kernel="lgbt_traverse", case=f"{layout}_{n}", card=card,
                     rows=n, exact=same, plan=plan._asdict()),
                lambda: cur_trav.traverse(b_in, nodes, layout, out=got),
                (lambda: base_trav.traverse(b_in, nodes, layout, out=old))
                if base_trav else None))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for r in results:
            print(json.dumps(r), flush=True)
            f.write(json.dumps(r) + "\n")
    if not agree:
        sys.exit("torch_route_traverse_bench: a kernel disagrees with its "
                 "plain version or with the baseline's")


if __name__ == "__main__":
    main()
