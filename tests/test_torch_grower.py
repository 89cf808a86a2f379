"""The port's serial grower against lightgbm_tpu's ``make_grower`` (CPU
segment rung) under integer-valued gradients and hessians, whose
histogram sums are exact in any order: the TreeArrays must be identical
field by field, and the row -> leaf maps identical, at 31 and 255 leaves;
with categorical columns, under every ``partition_impl`` x
``ordered_bins`` combination."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.grower import FeatureMeta as JaxMeta
from lightgbm_tpu.grower import GrowerConfig as JaxGrowerConfig
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu_torch.grower import (FeatureMeta, GrowerConfig, WindowBuffers,
                                      grow_tree)


def _problem(n, seed):
    rng = np.random.default_rng(seed)
    num_bin = np.asarray([63, 2, 17, 63, 40, 5, 63, 30, 3, 63], np.int32)
    missing = np.asarray([0, 2, 1, 2, 0, 1, 0, 2, 0, 1], np.int32)
    default_bin = np.asarray([rng.integers(0, nb) for nb in num_bin],
                             np.int32)
    bins = np.stack([rng.integers(0, nb, n) for nb in num_bin],
                    1).astype(np.uint8)
    g = (rng.integers(-6, 7, n) - 3 * (bins[:, 0] > 31)
         + 2 * (bins[:, 7] % 3 == 0)).astype(np.float32)
    h = rng.integers(1, 4, n).astype(np.float32)
    c = np.ones(n, np.float32)
    return bins, g, h, c, num_bin, missing, default_bin


@pytest.mark.parametrize("num_leaves,min_data,max_depth", [
    (31, 20, -1), (255, 1, -1), (63, 5, 6)])
def test_tree_identical_to_jax(num_leaves, min_data, max_depth):
    n = 4000
    bins, g, h, c, nb, mt, db = _problem(n, seed=num_leaves)
    kw = dict(num_leaves=num_leaves, min_data_in_leaf=min_data,
              min_sum_hessian_in_leaf=1.0, lambda_l2=1.0, max_depth=max_depth,
              max_bin=63)
    jcfg = JaxGrowerConfig(hist_method="segment", **kw)
    jmeta = JaxMeta(num_bin=jnp.asarray(nb), missing_type=jnp.asarray(mt),
                    default_bin=jnp.asarray(db),
                    is_categorical=jnp.zeros(len(nb), bool))
    grow = jax.jit(make_grower(jcfg))
    jtree, jrow = grow(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
                       jnp.asarray(c), jmeta, jnp.ones(len(nb), bool))
    jtree = jax.tree_util.tree_map(np.asarray, jtree)

    t = torch.from_numpy
    tree, row_leaf = grow_tree(
        t(bins), t(g), t(h), t(c),
        FeatureMeta(t(nb), t(mt), t(db)), torch.ones(len(nb), dtype=bool),
        GrowerConfig(**kw))
    assert int(tree.num_leaves) == int(jtree.num_leaves)
    if max_depth < 0:
        assert int(tree.num_leaves) > num_leaves // 2
    for name in tree._fields:
        if name == "num_leaves":
            continue
        np.testing.assert_array_equal(getattr(tree, name).numpy(),
                                      getattr(jtree, name), err_msg=name)
    np.testing.assert_array_equal(row_leaf.numpy(), np.asarray(jrow))


def test_stats_count_one_sync_per_split_plus_stop():
    bins, g, h, c, nb, mt, db = _problem(2000, seed=3)
    t = torch.from_numpy
    stats = {}
    tree, _ = grow_tree(t(bins), t(g), t(h), t(c),
                        FeatureMeta(t(nb), t(mt), t(db)),
                        torch.ones(len(nb), dtype=bool),
                        GrowerConfig(num_leaves=15, max_bin=63), stats)
    assert stats["splits"] == tree.num_leaves - 1
    # the loop reads once per split, plus once more when it stops early
    assert stats["host_syncs"] in (stats["splits"], stats["splits"] + 1)


def _cat_problem(n, seed):
    """Four categorical columns (one past 32 categories, one with its
    overflow bin) beside three numerical ones, integer gradients."""
    rng = np.random.default_rng(seed)
    num_bin = np.asarray([12, 40, 63, 7, 63, 30, 5], np.int32)
    is_cat = np.asarray([True, True, False, True, False, True, False])
    missing = np.asarray([0, 1, 2, 0, 0, 2, 1], np.int32)
    default_bin = np.where(is_cat, 0, [rng.integers(0, nb)
                                       for nb in num_bin]).astype(np.int32)
    bins = np.stack([rng.integers(0, nb, n) for nb in num_bin],
                    1).astype(np.uint8)
    effect = rng.integers(-3, 4, 64)
    g = (rng.integers(-4, 5, n) + effect[bins[:, 1]]
         - 2 * (bins[:, 0] % 3 == 0) + (bins[:, 2] > 30)).astype(np.float32)
    h = rng.integers(1, 4, n).astype(np.float32)
    c = np.ones(n, np.float32)
    return bins, g, h, c, num_bin, missing, default_bin, is_cat


_CAT_KW = dict(min_sum_hessian_in_leaf=1.0, lambda_l2=1.0, max_bin=63,
               has_categorical=True, max_cat_threshold=24, max_cat_group=16,
               cat_smooth_ratio=0.02, min_cat_smooth=2.0)


@pytest.fixture(scope="module", params=[(31, 20), (255, 1)],
                ids=["31-leaves", "255-leaves"])
def jax_cat_tree(request):
    num_leaves, min_data = request.param
    prob = _cat_problem(4000, seed=num_leaves)
    bins, g, h, c, nb, mt, db, ic = prob
    kw = dict(_CAT_KW, num_leaves=num_leaves, min_data_in_leaf=min_data)
    jmeta = JaxMeta(num_bin=jnp.asarray(nb), missing_type=jnp.asarray(mt),
                    default_bin=jnp.asarray(db),
                    is_categorical=jnp.asarray(ic))
    grow = jax.jit(make_grower(JaxGrowerConfig(hist_method="segment", **kw)))
    jtree, jrow = grow(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
                       jnp.asarray(c), jmeta, jnp.ones(len(nb), bool))
    return (prob, kw, jax.tree_util.tree_map(np.asarray, jtree),
            np.asarray(jrow))


@pytest.mark.parametrize("impl,ordered", [
    ("scatter", "off"), ("scatter", "on"), ("sort", "off"), ("sort", "on"),
    ("compact", "off"), ("compact", "on")])
def test_partition_modes_identical_to_jax(jax_cat_tree, impl, ordered):
    (bins, g, h, c, nb, mt, db, ic), kw, jtree, jrow = jax_cat_tree
    t = torch.from_numpy
    tree, row_leaf = grow_tree(
        t(bins), t(g), t(h), t(c), FeatureMeta(t(nb), t(mt), t(db), t(ic)),
        torch.ones(len(nb), dtype=bool),
        GrowerConfig(partition_impl=impl, ordered_bins=ordered, **kw))
    assert int(tree.num_leaves) == int(jtree.num_leaves)
    assert bool(tree.is_cat.any())
    for name in tree._fields:
        if name == "num_leaves":
            continue
        np.testing.assert_array_equal(getattr(tree, name).numpy(),
                                      getattr(jtree, name), err_msg=name)
    np.testing.assert_array_equal(row_leaf.numpy(), jrow)


@pytest.mark.parametrize("impl,ordered", [
    ("scatter", "off"), ("scatter", "on"), ("sort", "off"), ("sort", "on"),
    ("compact", "off"), ("compact", "on")])
def test_leaf_windows_lie_in_their_depth_parity_buffer(impl, ordered):
    """Out-of-place partition: each final leaf's rows sit as one
    contiguous, ascending window of the ``order`` buffer of its depth
    parity (and, ordered, the bins and weights there are those rows'),
    with the buffers reused across two trees, whose trees equal those of
    fresh buffers."""
    bins, g, h, c, nb, mt, db, ic = _cat_problem(3000, seed=4)
    t = torch.from_numpy
    cfg = GrowerConfig(partition_impl=impl, ordered_bins=ordered,
                       num_leaves=31, min_data_in_leaf=5, **_CAT_KW)
    buffers = WindowBuffers(len(g), bins.shape[1], cfg, "cpu")
    meta = FeatureMeta(t(nb), t(mt), t(db), t(ic))
    valid = torch.ones(len(nb), dtype=bool)
    for seed in (4, 5):     # the second tree starts from used buffers
        g = np.random.default_rng(seed).permutation(g)
        tree, row_leaf = grow_tree(t(bins), t(g), t(h), t(c), meta, valid,
                                   cfg, buffers=buffers)
        fresh, fresh_rows = grow_tree(t(bins), t(g), t(h), t(c), meta, valid,
                                      cfg)
        for name in tree._fields[1:]:
            assert torch.equal(getattr(tree, name), getattr(fresh, name))
        assert torch.equal(row_leaf, fresh_rows)
        row_leaf = row_leaf.numpy()
        depth = tree.leaf_depth.numpy()
        assert len(set(depth[:tree.num_leaves] % 2)) == 2
        # every split puts its left child first, so the leaves' windows
        # follow the tree's in-order leaf sequence
        lc, rc = tree.left_child.numpy(), tree.right_child.numpy()

        def leaves(node):
            if node < 0:
                return [~node]
            return leaves(lc[node]) + leaves(rc[node])

        start = 0
        for leaf in leaves(0):
            rows = np.flatnonzero(row_leaf == leaf)
            pos = np.arange(start, start + len(rows))
            start += len(rows)
            buf = buffers.bufs[depth[leaf] % 2]
            np.testing.assert_array_equal(buf[0].numpy()[pos], rows)
            if ordered == "on":
                np.testing.assert_array_equal(buf[1].numpy()[pos], bins[rows])
                np.testing.assert_array_equal(buf[2].numpy()[pos], g[rows])
        assert start == len(g)


def test_buffers_of_other_shapes_are_refused():
    bins, g, h, c, nb, mt, db = _problem(500, seed=2)
    t = torch.from_numpy
    cfg = GrowerConfig(num_leaves=7, max_bin=63, ordered_bins="on")
    with pytest.raises(ValueError):
        grow_tree(t(bins), t(g), t(h), t(c), FeatureMeta(t(nb), t(mt), t(db)),
                  torch.ones(len(nb), dtype=bool), cfg,
                  buffers=WindowBuffers(400, bins.shape[1], cfg, "cpu"))
