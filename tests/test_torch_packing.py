"""Nibble bin packing in the port against lightgbm_tpu on the same inputs.

Held exactly: the pack plan (``build_pack_plan``) on a list of column-bin
cases, the packed storage matrix (``pack_columns``), the unfolded
histograms (``unfold_packed_hist``, a sum of 16 integers a bin here), and
the model text of trees grown under integer-valued gradients and hessians
with packing on, packing off and in the JAX package, alone, with EFB and
with bagging.  The feature-sliced learner does not pack, and
``ordered_bins=on`` is ignored while packing is active, as in the JAX
package."""
import logging

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.data import packing as jp
from lightgbm_tpu_torch.data import packing as tp

BASE = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
            verbose=-1)


@pytest.mark.parametrize("col_bins", [
    [255, 255, 7],                        # one narrow column: no pair
    [3, 4],                               # all narrow, histograms tiny
    [255, 9, 16, 2, 255],                 # two pairs (+ wide pass-through)
    [255, 255, 255, 5, 6, 7],             # an odd leftover
    [17, 16, 17, 16],                     # 16 packs, 17 does not
    [255] * 40 + [4, 4],                  # a pair among many wide columns
    [200, 3, 3, 3, 3, 3, 3, 3, 3],        # mostly narrow
    [20, 3, 3],                           # unprofitable
])
def test_pack_plan_equals_jax(col_bins):
    want = jp.build_pack_plan(col_bins)
    got = tp.build_pack_plan(col_bins)
    assert (got is None) == (want is None)
    if want is None:
        return
    for f in ("byte_col", "shift", "is_packed"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.num_storage_cols == want.num_storage_cols
    assert got.num_phys_cols == want.num_phys_cols
    assert got.num_packed == want.num_packed


def _binned(col_bins, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, b, n) for b in col_bins],
                    axis=1).astype(np.uint8)


@pytest.mark.parametrize("col_bins", [[255, 9, 16, 2, 255],
                                      [255, 255, 255, 5, 6, 7]])
def test_pack_columns_and_unfold_equal_jax(col_bins):
    binned = _binned(col_bins)
    plan_j = jp.build_pack_plan(col_bins)
    plan_t = tp.build_pack_plan(col_bins)
    packed = tp.pack_columns(torch.from_numpy(binned), plan_t)
    np.testing.assert_array_equal(packed.numpy(),
                                  jp.pack_columns(binned, plan_j))
    # joint histograms of integer counts: every unfolded bin exact
    rng = np.random.default_rng(1)
    hist = rng.integers(0, 50, (plan_t.num_storage_cols, 256, 3)).astype(
        np.float32)
    B = max(col_bins)
    got = tp.unfold_packed_hist(torch.from_numpy(hist), plan_t.to("cpu"), B)
    want = jp.unfold_packed_hist(jnp.asarray(hist), plan_j, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rank_like(n=3000, seed=0):
    """4 numeric columns and 5 Poisson count columns of at most 16 bins,
    as MS-LTR's count features are."""
    rng = np.random.default_rng(seed)
    num = rng.standard_normal((n, 4))
    counts = rng.poisson(1.5, (n, 5)).clip(0, 12).astype(np.float64)
    z = num[:, 0] - 0.5 * num[:, 1] + 0.3 * counts[:, 0] - 0.2 * counts[:, 3]
    y = (z + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    return np.column_stack([num, counts]), y


def _int_fobj(seed):
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(seed + calls[0])
        calls[0] += 1
        n = len(preds)
        return (rng.integers(-3, 4, n).astype(np.float64),
                rng.integers(1, 4, n).astype(np.float64))
    return fobj


def _train(pkg, x, y, params, rounds=4, seed=5):
    p = dict(params, device="cpu") if pkg is lt else params
    return pkg.train(p, pkg.Dataset(x, y, params=p), rounds,
                     fobj=_int_fobj(seed), verbose_eval=False)


@pytest.mark.parametrize("extra", [
    {}, dict(partition_impl="compact"),
    dict(bagging_fraction=0.5, bagging_freq=1),
    dict(bagging_fraction=0.8, bagging_freq=1),
    dict(tree_learner="data", mesh_shape="4x1", mesh_devices=4)])
def test_packed_trees_equal_unpacked_and_jax(extra):
    x, y = _rank_like()
    p = dict(BASE, **extra)
    packed = _train(lt, x, y, p)
    assert packed.inner.packed is not None
    assert packed.inner.packed.matrix.shape[1] == \
        packed.inner.packed.plan.num_storage_cols < x.shape[1]
    unpacked = _train(lt, x, y, dict(p, enable_bin_packing=False))
    assert unpacked.inner.packed is None
    assert packed.model_to_string() == unpacked.model_to_string()
    jax_p = {k: v for k, v in p.items() if k != "partition_impl"}
    assert packed.model_to_string() == _train(lj, x, y,
                                              jax_p).model_to_string()


def test_packing_with_efb_equals_jax():
    """One-hot blocks bundled into a 5-slot and a 13-slot column, which
    then pack together beside the wide columns."""
    rng = np.random.default_rng(2)
    n = 2500
    num = rng.standard_normal((n, 4))
    blocks = []
    for width in (4, 12):
        blk = np.zeros((n, width))
        blk[np.arange(n), rng.integers(0, width, n)] = 1.0
        blocks.append(blk)
    x = np.column_stack([num] + blocks)
    y = (num[:, 0] + blocks[1][:, 2] > 0.3).astype(np.float32)
    bt = _train(lt, x, y, BASE)
    inner = bt.inner
    assert inner.meta.col is not None and inner.packed is not None
    assert inner.packed.plan.num_phys_cols == inner.bins.shape[1] == 6
    assert inner.packed.plan.num_packed == 2
    assert bt.model_to_string() == _train(lj, x, y, BASE).model_to_string()


def test_feature_learner_does_not_pack():
    x, y = _rank_like()
    p = dict(BASE, tree_learner="feature", mesh_shape="1x4", mesh_devices=4)
    bt = _train(lt, x, y, p)
    assert bt.inner.parallel_impl == "gspmd" and bt.inner.packed is None
    assert bt.model_to_string() == _train(lj, x, y, BASE).model_to_string()


def test_ordered_bins_ignored_while_packing(caplog):
    x, y = _rank_like()
    with caplog.at_level(logging.WARNING):
        bt = _train(lt, x, y, dict(BASE, ordered_bins="on", verbose=0))
    assert bt.inner.grower_cfg.ordered_bins == "off"
    assert "ordered_bins=on is ignored" in caplog.text
    off = _train(lt, x, y, dict(BASE, ordered_bins="on",
                                enable_bin_packing=False))
    assert off.inner.grower_cfg.ordered_bins == "on"
    assert bt.model_to_string() == off.model_to_string()


def test_pack_bins_carries_matrix_and_plan():
    """``pack_bins``: the storage matrix beside its plan on the matrix's
    device, read at width max(256, B) and unfolded as
    ``unfold_packed_hist`` unfolds."""
    col_bins = [255, 9, 16, 2, 255]
    binned = torch.from_numpy(_binned(col_bins))
    plan = tp.build_pack_plan(col_bins)
    packed = tp.pack_bins(binned, plan)
    assert torch.equal(packed.matrix, tp.pack_columns(binned, plan))
    for f in ("byte_col", "shift", "is_packed"):
        got = getattr(packed.plan, f)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), getattr(plan, f))
    assert packed.plan.num_packed == plan.num_packed == 2
    assert packed.hist_width(255) == 256 and packed.hist_width(300) == 300
    hist = torch.from_numpy(np.random.default_rng(5).integers(
        0, 50, (plan.num_storage_cols, 256, 3)).astype(np.float32))
    assert torch.equal(packed.unfold(hist, 255),
                       tp.unfold_packed_hist(hist, plan.to("cpu"), 255))
