#!/usr/bin/env python3
"""Times the serial grower's graph loop on one card for several values of
the histogram's device-regime threshold (``ops/histogram.py:
SMALL_MAX_WINDOW``: windows of at most that many rows take the small
regime, the rest the large).

    python3 scripts/torch_regime_bench.py [--out FILE]

On the Higgs-shaped (1,000,000 x 28) and the Expo-shaped (11,000,000 x 8,
six categorical columns, ordered bins) tasks of ``chip_smoke.py``, one
255-leaf tree under integer-valued gradients is grown by the graph loop
for each setting, in turns (each setting once in each half, the second
half in reverse order); each turn makes fresh grower state, captures,
then times one tree and profiles one more: ms a tree, the histogram
kernel's device ms a tree and the windows each regime took.  The trees
must be identical across settings.  One JSON line a turn goes to
``--out``; a summary line to stdout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SETTINGS = (16_384, 32_768, 4_096)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from lightgbm_tpu_torch import Dataset
    from lightgbm_tpu_torch.grower import (FeatureMeta, GrowerConfig,
                                           WindowBuffers, grow_tree)
    from lightgbm_tpu_torch.ops import build, histogram
    build.build_all()
    dev = torch.device("cuda")
    lines = []
    tasks = {
        "higgs": (cs.higgs_like, cs.N_ROWS, {}, "off"),
        "expo": (cs.expo_like, cs.N_EXPO,
                 dict(categorical_feature=cs.EXPO_CATEGORICAL,
                      enable_bundle=False, enable_bin_packing=False), "on"),
    }
    for task, (make, n, extra, ordered) in tasks.items():
        rng = np.random.default_rng(cs.SEED + 11)
        x, y = make(n, rng)
        params = dict(objective="binary", num_leaves=255, max_bin=cs.N_BINS,
                      verbose=0, device="cuda", **extra)
        ds = Dataset(x, y, params=params).construct()
        td = ds.constructed
        fm = td.feature_meta()
        put = lambda a: torch.from_numpy(a).to(dev)
        g = put((np.where(y > 0, -3, 2) + rng.integers(-2, 3, n)).astype(
            np.float32))
        h = put(rng.integers(1, 4, n).astype(np.float32))
        c = torch.ones(n, dtype=torch.float32, device=dev)
        meta = FeatureMeta(put(fm["num_bin"]), put(fm["missing_type"]),
                           put(fm["default_bin"]), put(fm["is_categorical"]))
        fv = torch.ones(ds.bins.shape[1], dtype=torch.bool, device=dev)
        cfg = GrowerConfig(
            num_leaves=255, min_data_in_leaf=1, min_sum_hessian_in_leaf=10.0,
            max_bin=td.max_num_bin(),
            has_missing=bool((fm["missing_type"] != 0).any()),
            has_categorical=bool(fm["is_categorical"].any()),
            partition_impl="compact", ordered_bins=ordered)
        del x
        first = None
        for thr in SETTINGS + SETTINGS[::-1]:
            histogram.SMALL_MAX_WINDOW = thr
            wb = WindowBuffers(*ds.bins.shape, cfg, dev)
            grow_tree(ds.bins, g, h, c, meta, fv, cfg, buffers=wb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, _ = grow_tree(ds.bins, g, h, c, meta, fv, cfg, buffers=wb)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            wall, per, all_ms, _, _ = cs.device_ms(
                lambda: grow_tree(ds.bins, g, h, c, meta, fv, cfg,
                                  buffers=wb), ("hist_gather",))
            # which regime took each window: a node's count is its window,
            # the smaller child's the histogrammed one
            lc = tree.leaf_count.cpu().numpy()
            ic = tree.internal_count.cpu().numpy()
            kids = np.concatenate([lc, ic])
            left, right = (tree.left_child.cpu().numpy(),
                           tree.right_child.cpu().numpy())
            cnt = lambda k: kids[~k] if k < 0 else kids[len(lc) + k]
            small = [min(cnt(a), cnt(b))
                     for a, b in zip(left[:tree.num_leaves - 1],
                                     right[:tree.num_leaves - 1])]
            leaves = tree.num_leaves
            if first is None:
                first = tree
            same = all(torch.equal(getattr(tree, f), getattr(first, f))
                       for f in tree._fields[1:])
            rec = dict(task=task, threshold=thr, ms_per_tree=round(ms, 3),
                       hist_device_ms_per_tree=round(per["hist_gather"], 4),
                       device_busy_share=round(all_ms / (wall * 1e3), 4),
                       small_windows=int(sum(s <= thr for s in small)),
                       large_windows=int(sum(s > thr for s in small)),
                       leaves=leaves, identical_to_first=same)
            lines.append(rec)
            print(json.dumps(rec), flush=True)
            if not same:
                sys.exit(f"{task}: the tree at threshold {thr} differs")
            del wb
            torch.cuda.empty_cache()
        del ds, g, h, c
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    summary = {}
    for rec in lines:
        key = f"{rec['task']}_{rec['threshold']}"
        summary.setdefault(key, []).append(rec["hist_device_ms_per_tree"])
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(json.dumps({"card": smi, "hist_device_ms_per_tree": summary}))


if __name__ == "__main__":
    main()
