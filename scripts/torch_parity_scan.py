"""How far lightgbm_tpu_torch drifts from lightgbm_tpu over a few rounds.

Trains both packages on the CPU on the same 5000 x 28 synthetic task
(binary and L2, 5 rounds, 63 leaves), with and without 3 % missing
values, over a few seeds and min_data_in_leaf values, and prints the
largest raw-score difference of each run on the train and valid rows.
With ``--breadth`` it runs the objectives of training breadth instead
(multiclass and multiclassova with 3 classes, lambdarank over queries of
25, L1, huber, fair, poisson, xentropy, xentlambda) without missing
values, and prints for each run the first tree that differs in structure
(split features or thresholds) and where.

    JAX_PLATFORMS=cpu python scripts/torch_parity_scan.py [--breadth]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import lightgbm_tpu as lj  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402

N, F = 5000, 28


def task(objective, seed, n, missing):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, F))
    if missing:
        x[rng.random(x.shape) < 0.03] = np.nan
    xz = np.nan_to_num(x)
    z = xz @ np.linspace(1.5, 0.2, F) + 0.8 * np.sin(3 * xz[:, 0])
    noise = rng.standard_normal(n) * 0.5
    if objective in ("multiclass", "multiclassova"):
        y = np.digitize(z + noise, [-1.0, 1.0])
    elif objective == "lambdarank":
        y = np.clip(np.round((z + noise) / 1.5 + 1.0), 0, 4)
    elif objective == "poisson":
        y = rng.poisson(np.exp(0.3 * np.clip(z, -3, 3)))
    elif objective in ("xentropy", "xentlambda"):
        y = 1.0 / (1.0 + np.exp(-(z + noise)))
    else:
        y = (z + noise > 0) if objective == "binary" else z + noise
    return x, y.astype(np.float32)


def first_difference(bt, bj):
    """(tree index, split index) of the first split whose feature or
    threshold differs between the two boosters' trees, or None."""
    for i, (a, b) in enumerate(zip(bt.inner.models, bj.inner.models)):
        n = min(a.num_leaves, b.num_leaves) - 1
        for k in range(n):
            if (a.split_feature[k] != b.split_feature[k]
                    or a.threshold[k] != b.threshold[k]):
                return i, k
        if a.num_leaves != b.num_leaves:
            return i, n
    return None


def breadth():
    print("objective seed first_differing_tree:split max_raw_diff")
    for obj in ("multiclass", "multiclassova", "lambdarank", "regression_l1",
                "huber", "fair", "poisson", "xentropy", "xentlambda"):
        for seed in (1, 2, 3):
            x, y = task(obj, seed, N, False)
            xv, yv = task(obj, seed + 100, 1000, False)
            p = dict(objective=obj, num_leaves=63, verbose=-1,
                     enable_bundle=False, enable_bin_packing=False)
            kw, kwv = {}, {}
            if obj.startswith("multiclass"):
                p["num_class"] = 3
            if obj == "lambdarank":
                kw, kwv = {"group": [25] * (N // 25)}, {"group": [25] * 40}
            dj = lj.Dataset(x, y, params=p, **kw)
            bj = lj.train(p, dj, 5, verbose_eval=False,
                          valid_sets=[lj.Dataset(xv, yv, reference=dj,
                                                 **kwv)])
            pt = dict(p, device="cpu")
            dt = lt.Dataset(x, y, params=pt, **kw)
            bt = lt.train(pt, dt, 5, verbose_eval=False,
                          valid_sets=[lt.Dataset(xv, yv, reference=dt,
                                                 **kwv)])
            d = max(np.abs(bt.predict(a, raw_score=True)
                           - bj.predict(a, raw_score=True)).max()
                    for a in (x, xv))
            where = first_difference(bt, bj)
            print(obj, seed, "none" if where is None else
                  f"{where[0]}:{where[1]}", repr(float(d)), flush=True)


def main():
    print("objective missing seed min_data max_raw_diff")
    for missing in (True, False):
        for obj in ("binary", "regression"):
            for seed in (1, 2, 3):
                for mdl in (20, 50):
                    x, y = task(obj, seed, N, missing)
                    xv, yv = task(obj, seed + 100, 1000, missing)
                    p = dict(objective=obj, num_leaves=63, verbose=-1,
                             enable_bundle=False, enable_bin_packing=False,
                             min_data_in_leaf=mdl)
                    dj = lj.Dataset(x, y, params=p)
                    bj = lj.train(p, dj, 5, verbose_eval=False,
                                  valid_sets=[lj.Dataset(xv, yv, reference=dj)])
                    pt = dict(p, device="cpu")
                    dt = lt.Dataset(x, y, params=pt)
                    bt = lt.train(pt, dt, 5, verbose_eval=False,
                                  valid_sets=[lt.Dataset(xv, yv, reference=dt)])
                    d = max(np.abs(bt.predict(a, raw_score=True)
                                   - bj.predict(a, raw_score=True)).max()
                            for a in (x, xv))
                    print(obj, missing, seed, mdl, repr(float(d)), flush=True)


if __name__ == "__main__":
    breadth() if sys.argv[1:] == ["--breadth"] else main()
