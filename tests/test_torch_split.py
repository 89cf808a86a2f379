"""The port's best-split scan against lightgbm_tpu's fused scan on the
same histogram (JAX's, passed as numpy): all missing types, L1/L2, and
the min_data / min_hess / min_gain gates.  Feature, threshold and
default_left identical; gains and child sums rtol 1e-6."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.histogram import subset_histogram_segment
from lightgbm_tpu.ops.split import SplitConfig as JaxSplitConfig
from lightgbm_tpu.ops.split import best_split as jax_best_split
from lightgbm_tpu_torch.ops.split import (SplitConfig, best_split,
                                          make_fused_ctx)

B = 64


def _problem(seed, has_missing):
    rng = np.random.default_rng(seed)
    n, f = 3000, 9
    num_bin = np.asarray([2, 3, 16, 63, 64, 5, 40, 2, 17], np.int32)
    if has_missing:
        missing = np.asarray([2, 1, 2, 1, 0, 2, 1, 0, 2], np.int32)
    else:
        missing = np.zeros(f, np.int32)
    default_bin = np.asarray([rng.integers(0, nb) for nb in num_bin],
                             np.int32)
    cols = []
    for j in range(f):
        # skewed bin occupancy so thresholds differ across features
        p = rng.dirichlet(np.full(num_bin[j], 0.7))
        cols.append(rng.choice(num_bin[j], size=n, p=p))
    bins = np.stack(cols, 1).astype(np.int32)
    signal = (bins[:, 3] > 30).astype(np.float32) - (bins[:, 6] < 10)
    g = (rng.standard_normal(n) * 0.5 - signal).astype(np.float32)
    h = rng.uniform(0.05, 0.3, n).astype(np.float32)
    c = np.ones(n, np.float32)
    hist = np.array(subset_histogram_segment(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(c), B))
    return hist, num_bin, missing, default_bin, (g.sum(dtype=np.float32),
                                                 h.sum(dtype=np.float32),
                                                 np.float32(n))


CASES = [
    dict(),
    dict(lambda_l1=0.5, lambda_l2=2.0),
    dict(min_data_in_leaf=400),
    dict(min_sum_hessian_in_leaf=150.0),
    dict(min_gain_to_split=5.0),
    dict(lambda_l1=1.0, min_data_in_leaf=100, min_sum_hessian_in_leaf=20.0),
    dict(min_data_in_leaf=5000),                    # nothing splits
]


@pytest.mark.parametrize("has_missing", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_best_split_matches_jax(case, has_missing):
    hist, nb, mt, db, (pg, ph, pc) = _problem(len(str(case)), has_missing)
    f = len(nb)
    valid = np.ones(f, bool)
    valid[5] = False                                  # a pruned feature
    kw = dict(dict(min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3),
              **case)
    jcfg = JaxSplitConfig(has_missing=has_missing, split_find="fused", **kw)
    jres, jok = jax_best_split(
        jnp.asarray(hist), jnp.float32(pg), jnp.float32(ph), jnp.float32(pc),
        jnp.asarray(nb), jnp.asarray(mt), jnp.asarray(db),
        jnp.asarray(valid), jcfg, with_feat_ok=True)
    tcfg = SplitConfig(has_missing=has_missing, **kw)
    t = torch.from_numpy
    ctx = make_fused_ctx(t(nb), t(mt), t(db), B, tcfg)
    tres, tok = best_split(t(hist)[None], torch.tensor([pg]),
                           torch.tensor([ph]), torch.tensor([pc]),
                           t(valid)[None], tcfg, ctx)
    assert bool(tres.found[0]) == bool(jres.found)
    assert int(tres.feature[0]) == int(jres.feature)
    assert int(tres.threshold[0]) == int(jres.threshold)
    assert bool(tres.default_left[0]) == bool(jres.default_left)
    np.testing.assert_array_equal(tok[0].numpy(), np.asarray(jok))
    for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                 "right_sum_g", "right_sum_h", "right_count",
                 "left_output", "right_output"):
        np.testing.assert_allclose(getattr(tres, name)[0].numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-6, err_msg=name)
    if case.get("min_data_in_leaf") == 5000:
        assert not bool(tres.found[0])


def test_batched_scan_equals_single_scans():
    """The grower scans both children in one call: each row of the batch
    equals the scan of that leaf alone."""
    h1, nb, mt, db, p1 = _problem(1, True)
    h2, _, _, _, p2 = _problem(2, True)
    t = torch.from_numpy
    cfg = SplitConfig()
    ctx = make_fused_ctx(t(nb), t(mt), t(db), B, cfg)
    valid = torch.ones((2, len(nb)), dtype=torch.bool)
    pair, _ = best_split(torch.stack([t(h1), t(h2)]),
                         torch.tensor([p1[0], p2[0]]),
                         torch.tensor([p1[1], p2[1]]),
                         torch.tensor([p1[2], p2[2]]), valid, cfg, ctx)
    for k, (h, p) in enumerate(((h1, p1), (h2, p2))):
        one, _ = best_split(t(h)[None], *(torch.tensor([v]) for v in p),
                            valid[:1], cfg, ctx)
        for a, b in zip(pair, one):
            assert torch.equal(a[k], b[0])


@pytest.mark.parametrize("categorical", [False, True])
def test_scan_builds_no_tensor_from_host_values(monkeypatch, categorical):
    """The grower captures the scan in a CUDA graph, where a tensor made
    from host values (``torch.tensor``) is a host-to-device copy: the scan
    takes its constants as Python numbers and makes none."""
    hist, nb, mt, db, (pg, ph, pc) = _problem(3, True)
    t = torch.from_numpy
    is_cat = torch.zeros(len(nb), dtype=torch.bool)
    is_cat[[2, 6]] = categorical
    cfg = SplitConfig(lambda_l1=0.5, lambda_l2=2.0,
                      has_categorical=categorical)
    ctx = make_fused_ctx(t(nb), t(mt), t(db), B, cfg, is_cat)
    args = (t(hist)[None], torch.tensor([pg]), torch.tensor([ph]),
            torch.tensor([pc]), torch.ones((1, len(nb)), dtype=torch.bool),
            cfg, ctx)
    want, want_ok = best_split(*args)

    def refused(*a, **k):
        raise AssertionError("torch.tensor inside the scan")
    monkeypatch.setattr(torch, "tensor", refused)
    got, got_ok = best_split(*args)
    monkeypatch.undo()
    assert torch.equal(got_ok, want_ok)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got.found[0])
