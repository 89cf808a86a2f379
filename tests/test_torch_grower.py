"""The port's serial grower against lightgbm_tpu's ``make_grower`` (CPU
segment rung) under integer-valued gradients and hessians, whose
histogram sums are exact in any order: the TreeArrays must be identical
field by field, and the row -> leaf maps identical, at 31, 63 and 255
leaves, numerical and categorical, under every ``partition_impl`` x
``ordered_bins`` combination.  On the CPU every combination runs the split
step eagerly (the graph loop is a card's); the step's stop flag, its host
reads and the steps taken after the stop are checked here too."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.grower import FeatureMeta as JaxMeta
from lightgbm_tpu.grower import GrowerConfig as JaxGrowerConfig
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu_torch.grower import (STOP_CHECK_STEPS, FeatureMeta,
                                      GrowerConfig, WindowBuffers, grow_tree,
                                      resolve_partition_impl)


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


_MODES = [("scatter", "off"), ("scatter", "on"), ("sort", "off"),
          ("sort", "on"), ("compact", "off"), ("compact", "on")]
_TREES = [(31, 20, -1), (255, 1, -1), (63, 5, 6)]


@pytest.fixture(scope="module")
def jax_trees():
    """lightgbm_tpu's tree of each ``_TREES`` case, compiled once."""
    out = {}

    def get(num_leaves, min_data, max_depth):
        key = (num_leaves, min_data, max_depth)
        if key not in out:
            bins, g, h, c, nb, mt, db = _problem(4000, seed=num_leaves)
            jcfg = JaxGrowerConfig(hist_method="segment", **_kw(*key))
            jmeta = JaxMeta(num_bin=jnp.asarray(nb),
                            missing_type=jnp.asarray(mt),
                            default_bin=jnp.asarray(db),
                            is_categorical=jnp.zeros(len(nb), bool))
            grow = jax.jit(make_grower(jcfg))
            jtree, jrow = grow(jnp.asarray(bins), jnp.asarray(g),
                               jnp.asarray(h), jnp.asarray(c), jmeta,
                               jnp.ones(len(nb), bool))
            out[key] = (jax.tree_util.tree_map(np.asarray, jtree),
                        np.asarray(jrow))
        return out[key]
    return get


def _kw(num_leaves, min_data, max_depth):
    return dict(num_leaves=num_leaves, min_data_in_leaf=min_data,
                min_sum_hessian_in_leaf=1.0, lambda_l2=1.0,
                max_depth=max_depth, max_bin=63)


# the scatter / ordered-off case of each tree keeps its original id
@pytest.mark.parametrize("num_leaves,min_data,max_depth,impl,ordered", [
    pytest.param(*tree, impl, ordered, id="-".join(
        map(str, tree if (impl, ordered) == ("scatter", "off")
            else tree + (impl, ordered))))
    for tree in _TREES for impl, ordered in _MODES])
def test_tree_identical_to_jax(jax_trees, num_leaves, min_data, max_depth,
                               impl, ordered):
    n = 4000
    bins, g, h, c, nb, mt, db = _problem(n, seed=num_leaves)
    kw = _kw(num_leaves, min_data, max_depth)
    jtree, jrow = jax_trees(num_leaves, min_data, max_depth)

    t = torch.from_numpy
    tree, row_leaf = grow_tree(
        t(bins), t(g), t(h), t(c),
        FeatureMeta(t(nb), t(mt), t(db)), torch.ones(len(nb), dtype=bool),
        GrowerConfig(partition_impl=impl, ordered_bins=ordered, **kw))
    assert int(tree.num_leaves) == int(jtree.num_leaves)
    if max_depth < 0:
        assert int(tree.num_leaves) > num_leaves // 2
    for name in tree._fields:
        if name == "num_leaves":
            continue
        np.testing.assert_array_equal(getattr(tree, name).numpy(),
                                      getattr(jtree, name), err_msg=name)
    np.testing.assert_array_equal(row_leaf.numpy(), jrow)


def test_stats_count_one_sync_per_split_plus_stop():
    """Host reads a tree.  scatter and sort slice the window on the host:
    one read a split, plus one when the tree stops before ``L - 1``
    splits, which carries the stop.  compact reads nothing a split: its
    loop reads the counters once every ``STOP_CHECK_STEPS`` steps, so
    ``ceil((L - 1) / 32)`` reads at most, and the steps after the stop up
    to the next read change nothing."""
    bins, g, h, c, nb, mt, db = _problem(2000, seed=3)
    t = torch.from_numpy
    meta = FeatureMeta(t(nb), t(mt), t(db))
    for leaves in (15, 255):      # a tree that fills up, one that stops
        splits = {}
        for impl in ("scatter", "sort", "compact"):
            stats = {}
            tree, _ = grow_tree(t(bins), t(g), t(h), t(c), meta,
                                torch.ones(len(nb), dtype=bool),
                                GrowerConfig(num_leaves=leaves, max_bin=63,
                                             partition_impl=impl), stats)
            s = splits[impl] = stats["splits"]
            assert s == tree.num_leaves - 1
            stopped = s < leaves - 1
            if impl != "compact":
                assert stats["host_syncs"] == s + stopped
                assert stats["steps"] == s + stopped
            else:
                assert stats["host_syncs"] == (
                    s // STOP_CHECK_STEPS + 1 if stopped
                    else math.ceil((leaves - 1) / STOP_CHECK_STEPS))
                assert stats["steps"] == min(
                    leaves - 1, STOP_CHECK_STEPS * stats["host_syncs"])
                assert stats["host_syncs"] <= math.ceil(
                    (leaves - 1) / STOP_CHECK_STEPS) + 1
            assert stats["graph_replays"] == 0      # no graph on the CPU
        assert len(set(splits.values())) == 1
        assert (splits["scatter"] < leaves - 1) == (leaves == 255)


def _pool_state(buffers):
    """Every live tensor of the step's state: the buffers, the windows and
    counters, the mask and the pool without its sink rows."""
    L = buffers.cfg.num_leaves
    pool = buffers.pool
    live = {f"buf{k}_{j}": x.clone() for k, b in enumerate(buffers.bufs)
            for j, x in enumerate(b)}
    live.update(lsc=buffers.lsc[:L].clone(),
                splits_positions=buffers.counters[[0, 2]].clone(),
                goes_left=buffers.goes_left.clone())
    for name in ("hist_store", "feat_ok", "sgain", "sf32", "si32", "scat",
                 "scatb", "leaf_f", "leaf_parent", "leaf_depth"):
        if getattr(pool, name) is not None:
            live[name] = getattr(pool, name)[:L].clone()
    for name in ("node_f", "node_i", "node_cat", "node_catb", "left_child",
                 "right_child"):
        live[name] = getattr(pool, name)[:L - 1].clone()
    return live


@pytest.mark.parametrize("leaves", [7, 255], ids=["full", "stopped"])
@pytest.mark.parametrize("ordered", ["off", "on"])
def test_steps_after_the_stop_change_nothing(leaves, ordered):
    """Once the tree has stopped (no gain above 0, or ``L - 1`` splits),
    further steps write only the sink rows: every buffer, window, counter
    and pool tensor, and the tree they unpack to, stay as they were."""
    bins, g, h, c, nb, mt, db, ic = _cat_problem(3000, seed=6)
    t = torch.from_numpy
    cfg = GrowerConfig(partition_impl="compact", ordered_bins=ordered,
                       num_leaves=leaves, min_data_in_leaf=20, **_CAT_KW)
    buffers = WindowBuffers(len(g), bins.shape[1], cfg, "cpu")
    tree, row_leaf = grow_tree(t(bins), t(g), t(h), t(c),
                               FeatureMeta(t(nb), t(mt), t(db), t(ic)),
                               torch.ones(len(nb), dtype=bool), cfg,
                               buffers=buffers)
    assert (tree.num_leaves == leaves) == (leaves == 7)
    # a stopped tree's loop read the flag down; a full one stops at its
    # next step, which finds L - 1 splits made
    assert int(buffers.counters[1]) == (leaves == 7)
    before = _pool_state(buffers)
    for _ in range(3):
        assert buffers.step()
    assert int(buffers.counters[1]) == 0
    after = _pool_state(buffers)
    for name, x in before.items():
        assert torch.equal(x, after[name]), name
    again = buffers.pool.tree(tree.num_leaves - 1)
    for name in tree._fields[1:]:
        assert torch.equal(getattr(tree, name), getattr(again, name)), name


def test_auto_partition_is_the_kernel_on_a_card():
    """``partition_impl=auto`` is compact for a card (the graph loop) and
    scatter for the CPU; an explicit choice stands."""
    assert resolve_partition_impl("auto", "cuda") == "compact"
    assert resolve_partition_impl("auto", "cuda:1") == "compact"
    assert resolve_partition_impl("auto", torch.device("cuda")) == "compact"
    assert resolve_partition_impl("auto", "cpu") == "scatter"
    for impl in ("scatter", "sort", "compact"):
        assert resolve_partition_impl(impl, "cuda") == impl
        assert resolve_partition_impl(impl, "cpu") == impl


def test_graph_loop_needs_a_card_and_the_kernel():
    bins, g, h, c, nb, mt, db = _problem(500, seed=2)
    t = torch.from_numpy
    for impl in ("scatter", "compact"):
        with pytest.raises(ValueError):
            grow_tree(t(bins), t(g), t(h), t(c),
                      FeatureMeta(t(nb), t(mt), t(db)),
                      torch.ones(len(nb), dtype=bool),
                      GrowerConfig(num_leaves=7, max_bin=63,
                                   partition_impl=impl), loop="graph")


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
