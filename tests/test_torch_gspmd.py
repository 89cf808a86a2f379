"""The port's data-parallel learner against lightgbm_tpu's GSPMD learner
on eight mesh slots: the eight virtual CPU devices of tests/conftest.py
on the JAX side, ``mesh_devices=8`` CPU slots on the port's.

* ``hist_local_plain`` (the shard-local histogram's plain version) against
  the JAX ``subset_histogram_fused_local`` in interpret mode: exact under
  integer weights; under float weights within 1e-5 of the bin's sum of
  |w|, since the Pallas kernel splits each weight into bf16 hi/lo halves
  and loses at most 2^-18 of it.
* The grower on the 8x1, 1x8 and 2x4 meshes against ``make_gspmd_grower``
  with the fused kernel (on the uneven 1x3 and 2x3 meshes with the flat
  histogram, which the JAX package's fused layout cannot slice), and
  against the port's serial grower, under integer weights whose sums are
  exact in any order: every TreeArrays field and the row -> leaf map
  identical.  Also with missing values and with categorical columns.
* The split step: the host reads the counters once every
  ``STOP_CHECK_STEPS`` steps and nothing else, every ``hist_local`` call
  is given the per-shard leaf counts, which are exact after every step
  (padding rows and shards held by several devices included), and steps
  taken after the stop write only to the sink rows.
* ``train`` with ``tree_learner=data, gspmd_hist=fused`` on a 2x4 mesh
  against ``lightgbm_tpu.train`` with the same parameters: predictions
  within 1e-4 (as in test_torch_engine.py); fused against flat within
  rtol 2e-5 / atol 2e-6 (tests/test_gspmd.py:276); ``auto`` resolves flat
  on the CPU and fused on a card.
* Uneven column slices, fallbacks and raises: columns that do not split
  evenly over the feature shards stay on the fused histogram (the JAX
  package downgrades them to flat; its TPU layout needs equal slices)
  and agree with the JAX learner, one slot falls back to serial with a
  warning; block-sharded bins and the planner's ``mesh_shape=auto``,
  which raised before they were ported, train.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu.data.packing import pack_fused_panel
from lightgbm_tpu.grower import FeatureMeta as JaxMeta
from lightgbm_tpu.grower import GrowerConfig as JaxGrowerConfig
from lightgbm_tpu.ops.histogram import subset_histogram_fused_local
from lightgbm_tpu.parallel.gspmd import make_gspmd_grower
from lightgbm_tpu.parallel import mesh as jax_mesh
from lightgbm_tpu_torch.grower import (STOP_CHECK_STEPS, FeatureMeta,
                                       GrowerConfig, grow_tree)
from lightgbm_tpu_torch.ops.histogram import (hist_flat, hist_local,
                                              hist_local_plain)
from lightgbm_tpu_torch.parallel.gspmd import (GspmdGrower, column_slices,
                                               resolve_gspmd_hist)
from lightgbm_tpu_torch.parallel.mesh import (MeshPlanError, make_named_mesh,
                                              mesh_shape_extents, mesh_slots,
                                              parse_mesh_shape)

N, F, B, L = 4096, 8, 32, 15
SHAPES = [(8, 1), (1, 8), (2, 4)]
CPU8 = mesh_slots(8, torch.device("cpu"))
t = torch.from_numpy


# ---- the shard-local histogram -------------------------------------------


def _skewed_row_leaf(rng, n):
    """Leaf 0 about 60 % of the rows, leaf 1 about 39 %, leaf 2 about 40
    rows; leaf 7 has none."""
    u = rng.random(n)
    return np.where(u < 0.01, 2, np.where(u < 0.4, 1, 0)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_local_hist():
    """The JAX wrapper, compiled once: the leaf id is traced."""
    fn = jax.jit(lambda rl, leaf, panel: subset_histogram_fused_local(
        rl, leaf, panel, F, 4, B, interpret=True))

    def run(row_leaf, leaf, bins, g, h, c):
        zrow = np.zeros((1, bins.shape[1]), bins.dtype)
        zw = np.zeros(1, np.float32)
        panel, per = pack_fused_panel(
            jnp.asarray(np.concatenate([bins, zrow])),
            *[jnp.asarray(np.concatenate([w, zw])) for w in (g, h, c)])
        assert per == 4
        return np.asarray(fn(jnp.asarray(row_leaf), jnp.int32(leaf), panel))
    return run


@pytest.mark.parametrize("weights", ["integer", "float"])
def test_hist_local_plain_matches_jax_fused_local(jax_local_hist, weights):
    rng = np.random.default_rng(5)
    bins = rng.integers(0, B, (N, F)).astype(np.uint8)
    if weights == "integer":
        g = rng.integers(-8, 9, N).astype(np.float32)
        h = rng.integers(0, 5, N).astype(np.float32)
    else:
        g = rng.standard_normal(N).astype(np.float32)
        h = rng.uniform(0.0, 0.25, N).astype(np.float32)
    c = np.ones(N, np.float32)
    skewed = _skewed_row_leaf(rng, N)
    cases = [("root", np.zeros(N, np.int32), 0), ("mid", skewed, 1),
             ("small", skewed, 2), ("absent", skewed, 7)]
    for name, row_leaf, leaf in cases:
        want = jax_local_hist(row_leaf, leaf, bins, g, h, c)
        args = (t(row_leaf), torch.tensor([leaf], dtype=torch.int32),
                t(bins), t(g), t(h), t(c), B)
        got = hist_local_plain(*args).numpy()
        # on a CPU tensor the wrapper is the plain version
        np.testing.assert_array_equal(hist_local(*args).numpy(), got)
        assert got.shape == (F, B, 3)
        if name == "absent":
            assert not got.any()
        if weights == "integer":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            mag = hist_local_plain(args[0], args[1], args[2], t(np.abs(g)),
                                   t(np.abs(h)), t(c), B).numpy()
            assert (np.abs(got - want) <= 1e-5 * mag).all(), name
            np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert hist_local.launches == 0


def test_hist_flat_is_the_masked_scatter_add():
    rng = np.random.default_rng(6)
    bins = rng.integers(0, B, (N, F)).astype(np.uint8)
    g = rng.integers(-8, 9, N).astype(np.float32)
    row_leaf = _skewed_row_leaf(rng, N)
    mask = (row_leaf == 1).astype(np.float32)
    c = np.ones(N, np.float32)
    got = hist_flat(t(bins), t(g * mask), t(g * g * mask), t(c * mask),
                    B).numpy()
    want = hist_local_plain(t(row_leaf), torch.tensor([1], dtype=torch.int32),
                            t(bins), t(g), t(g * g), t(c), B).numpy()
    np.testing.assert_array_equal(got, want)


# ---- the grower ------------------------------------------------------------


def _int_args(seed=0):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(N, F)).astype(np.uint8)
    g = rng.randint(-8, 9, size=N).astype(np.float32)
    h = rng.randint(1, 9, size=N).astype(np.float32)
    c = np.ones(N, np.float32)
    return bins, g, h, c


def _meta_np(missing=False, categorical=0):
    return (np.full(F, B, np.int32), np.full(F, 2 if missing else 0, np.int32),
            np.zeros(F, np.int32),
            np.asarray([True] * categorical + [False] * (F - categorical)))


CASES = {
    "plain": (dict(), dict(), 0),
    "missing": (dict(has_missing=True), dict(missing=True), 3),
    "categorical": (dict(has_categorical=True, max_cat_threshold=16),
                    dict(categorical=3), 11),
}


def _kw(case):
    return dict(dict(num_leaves=L, min_data_in_leaf=1, max_bin=B,
                     has_missing=False), **CASES[case][0])


def _jax_gspmd(case, shape, hist="fused"):
    bins, g, h, c = _int_args(CASES[case][2])
    mesh = jax_mesh.make_named_mesh(*shape)
    grow = make_gspmd_grower(JaxGrowerConfig(hist_method=hist,
                                             hist_interpret=True,
                                             **_kw(case)), mesh)
    rs = NamedSharding(mesh, P(jax_mesh.BATCH_AXIS))
    meta = JaxMeta(*[jnp.asarray(a) for a in _meta_np(**CASES[case][1])])
    tree, row_leaf = grow(
        jax.device_put(bins, NamedSharding(mesh, P(jax_mesh.BATCH_AXIS,
                                                   None))),
        jax.device_put(g, rs), jax.device_put(h, rs), jax.device_put(c, rs),
        meta, jnp.ones((F,), bool))
    return jax.tree_util.tree_map(np.asarray, tree), np.asarray(row_leaf)


def _port(case, shape=None, hist="fused", stats=None):
    """The port's GSPMD grower on ``shape`` over CPU slots, or its serial
    grower for ``shape=None``."""
    bins, g, h, c = _int_args(CASES[case][2])
    meta = FeatureMeta(*[t(a) for a in _meta_np(**CASES[case][1])])
    cfg = GrowerConfig(**_kw(case))
    ones = torch.ones(F, dtype=torch.bool)
    if shape is None:
        return grow_tree(t(bins), t(g), t(h), t(c), meta, ones, cfg, stats)
    grower = GspmdGrower(cfg, make_named_mesh(*shape, CPU8), t(bins), hist)
    return grower(t(g), t(h), t(c), meta, ones, stats)


def _assert_same(tree, row_leaf, jtree, jrow, what):
    assert int(tree.num_leaves) == int(jtree.num_leaves), what
    assert int(tree.num_leaves) > 1, what
    for name in tree._fields:
        if name == "num_leaves":
            continue
        a, b = getattr(tree, name), getattr(jtree, name)
        np.testing.assert_array_equal(
            a.numpy() if isinstance(a, torch.Tensor) else a, np.asarray(b),
            err_msg=f"{what}: TreeArrays.{name}")
    np.testing.assert_array_equal(
        row_leaf.numpy() if isinstance(row_leaf, torch.Tensor) else row_leaf,
        np.asarray(jrow), err_msg=f"{what}: row_leaf")


@pytest.fixture(scope="module", params=SHAPES,
                ids=[f"{d}x{f}" for d, f in SHAPES])
def jax_plain_tree(request):
    return request.param, _jax_gspmd("plain", request.param)


def test_gspmd_tree_identical_to_jax_fused(jax_plain_tree):
    shape, (jtree, jrow) = jax_plain_tree
    stats = {}
    tree, row_leaf = _port("plain", shape, stats=stats)
    _assert_same(tree, row_leaf, jtree, jrow, f"{shape} vs JAX")
    # the counters read once every STOP_CHECK_STEPS steps, nothing else
    assert 1 <= stats["host_syncs"] <= MAX_READS
    assert stats["splits"] == int(tree.num_leaves) - 1


# at most this many host reads a tree: ceil((L - 1) / 32) + 1
MAX_READS = -(-(L - 1) // STOP_CHECK_STEPS) + 1
# 8 columns over 3 feature shards: slices of 3, 3 and 2 columns
UNEVEN = [(1, 3), (2, 3)]


@pytest.mark.parametrize("shape", UNEVEN, ids=["1x3", "2x3"])
def test_uneven_slices_identical_to_jax_and_serial(shape):
    """Uneven column slices: the port's fused step against the JAX
    learner's flat histogram (its fused layout needs equal slices) and
    against the serial grower."""
    jtree, jrow = _jax_gspmd("plain", shape, hist="flat")
    tree, row_leaf = _port("plain", shape)
    _assert_same(tree, row_leaf, jtree, jrow, f"{shape} vs JAX")
    stree, srow = _port("plain")
    _assert_same(tree, row_leaf, stree, srow, f"{shape} vs serial")


@pytest.mark.parametrize("shape", SHAPES + UNEVEN,
                         ids=[f"{d}x{f}" for d, f in SHAPES + UNEVEN])
@pytest.mark.parametrize("hist", ["fused", "flat"])
def test_gspmd_tree_identical_to_serial(shape, hist):
    tree, row_leaf = _port("plain", shape, hist)
    stree, srow = _port("plain")
    _assert_same(tree, row_leaf, stree, srow, f"{shape} {hist} vs serial")


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (2, 4)],
                         ids=["4x1", "2x2", "2x4"])
def test_slots_over_two_devices(shape):
    """Slots round-robin over two devices, as ``mesh_devices=4`` over two
    cards: each device routes the (non-contiguous) shards it holds, and
    the partials of both reach the primary device in shard order.  The
    two CPU device names stand in for two cards."""
    two = [torch.device("cpu"), torch.device("cpu", 0)] * 4
    bins, g, h, c = _int_args()
    meta = FeatureMeta(*[t(a) for a in _meta_np()])
    grower = GspmdGrower(GrowerConfig(**_kw("plain")),
                         make_named_mesh(*shape, two), t(bins))
    assert len(grower.held) == 2
    tree, row_leaf = grower(t(g), t(h), t(c), meta,
                            torch.ones(F, dtype=torch.bool))
    stree, srow = _port("plain")
    _assert_same(tree, row_leaf, stree, srow, f"{shape} over two devices")


@pytest.mark.parametrize("case", ["missing", "categorical"])
def test_gspmd_missing_and_categorical_identical(case):
    jtree, jrow = _jax_gspmd(case, (2, 4))
    tree, row_leaf = _port(case, (2, 4))
    _assert_same(tree, row_leaf, jtree, jrow, f"{case} vs JAX")
    stree, srow = _port(case)
    _assert_same(tree, row_leaf, stree, srow, f"{case} vs serial")
    if case == "categorical":
        assert bool(tree.is_cat.any())


def test_padded_rows_reach_no_leaf_count():
    """4096 - 3 rows over 8 batch shards: the padding rows carry zero
    weights, so the tree equals the serial tree of the real rows."""
    bins, g, h, c = _int_args()
    n = N - 3
    pad = lambda a: np.concatenate([a[:n], np.zeros((3,) + a.shape[1:],
                                                    a.dtype)])
    meta = FeatureMeta(*[t(a) for a in _meta_np()])
    cfg = GrowerConfig(**_kw("plain"))
    ones = torch.ones(F, dtype=torch.bool)
    grower = GspmdGrower(cfg, make_named_mesh(8, 1, CPU8), t(pad(bins)))
    tree, row_leaf = grower(t(pad(g)), t(pad(h)), t(pad(c)), meta, ones)
    stree, srow = grow_tree(t(bins[:n]), t(g[:n]), t(h[:n]), t(c[:n]), meta,
                            ones, cfg)
    _assert_same(tree, row_leaf[:n], stree, srow, "padded")
    assert float(tree.leaf_count.sum()) == n


READS = ("tolist", "item", "numpy", "cpu", "__bool__", "__int__",
         "__float__", "__index__")


# a batch shard held by several devices, as a feature extent above 1 over
# several cards: two CPU device names stand in for two cards, three for
# three (2x2 over three: the primary holds both batch shards, and counts
# only the first)
TWO = [torch.device("cpu"), torch.device("cpu", 0)] * 4
THREE = [torch.device("cpu"), torch.device("cpu", 0),
         torch.device("cpu", 1)] * 3


SLOT_CASES = [((8, 1), 0, CPU8), ((2, 4), 0, CPU8), ((8, 1), 3, CPU8),
              ((2, 2), 0, TWO), ((2, 2), 3, THREE), ((1, 3), 0, THREE)]
SLOT_IDS = ["8x1", "2x4", "8x1-padded", "2x2-two-devices",
            "2x2-three-devices-padded", "1x3-three-devices"]


def _padded(pad):
    """The integer-weight inputs, the last ``pad`` rows padding (zero bins
    and weights)."""
    bins, g, h, c = _int_args()
    if pad:
        n = N - pad
        bins[n:], g[n:], h[n:], c[n:] = 0, 0, 0, 0
    return bins, g, h, c


def _true_counts(grower):
    """Every leaf's rows in each batch shard, from the row -> leaf maps."""
    d, n_loc = len(grower.mesh.devices), grower.n_loc
    out = np.zeros((d, L + 1), np.int64)
    for i, devs in enumerate(grower.mesh.devices):
        for dv in devs:    # every device that holds the shard agrees
            rl = grower._shard(grower.row_leaf[dv], i, dv).numpy()
            got = np.bincount(rl, minlength=L + 1)
            k = grower.held[dv].index(i)
            np.testing.assert_array_equal(grower.counts[dv][k].numpy(), got)
        out[i] = got
    assert out.sum() == d * n_loc
    return out


@pytest.mark.parametrize("shape,pad,slots", SLOT_CASES, ids=SLOT_IDS)
def test_stop_reads_bound_host_reads_and_k3_reads_true_counts(
        monkeypatch, shape, pad, slots):
    """Every read of a tensor to the host during the grower's call, the
    plain histogram's own reads aside, is a read of the counters: at most
    ceil((L - 1) / 32) + 1 a tree.  Every ``hist_local`` call (one a slot
    and step, the root's and the steps after the stop included) is given
    its shard's per-leaf row counts, whose entry for the measured leaf
    equals that leaf's rows in the shard; a batch shard that several
    devices hold is counted by each of them alike."""
    import lightgbm_tpu_torch.parallel.gspmd as gspmd_mod
    bins, g, h, c = _padded(pad)
    cfg = GrowerConfig(**_kw("plain"))
    grower = GspmdGrower(cfg, make_named_mesh(*shape, slots), t(bins))
    reads, calls, inside = [0], [], [False]

    def counted(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **k):
            reads[0] += not inside[0]
            return orig(self, *a, **k)
        return read
    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, counted(name))
    local = gspmd_mod.hist_local

    def recorded(row_leaf, leaf_id, *a, leaf_rows=None, **k):
        # the plain version that a CPU tensor takes reads the leaf's rows
        # to the host; the kernel on a card does not
        inside[0] = True
        try:
            calls.append((row_leaf.clone(), leaf_id.clone(),
                          None if leaf_rows is None else leaf_rows.clone()))
            return local(row_leaf, leaf_id, *a, leaf_rows=leaf_rows, **k)
        finally:
            inside[0] = False
    monkeypatch.setattr(gspmd_mod, "hist_local", recorded)
    stats = {}
    tree, row_leaf = grower(t(g), t(h), t(c), FeatureMeta(
        *[t(a) for a in _meta_np()]), torch.ones(F, dtype=torch.bool), stats)
    monkeypatch.undo()

    assert reads[0] == stats["host_syncs"]
    assert 1 <= stats["host_syncs"] <= MAX_READS
    assert stats["splits"] == int(tree.num_leaves) - 1 > 1
    assert stats["splits"] <= stats["steps"] <= L - 1
    n_shards, per_split = shape
    assert len(calls) == n_shards * per_split * (stats["steps"] + 1)
    for rl, lid, leaf_rows in calls:
        assert leaf_rows is not None and leaf_rows.shape == (L + 1,)
        assert int(leaf_rows[int(lid)]) == int((rl == lid).sum())
    # the root's calls see every row of the shard in leaf 0
    assert {int(r[0]) for _, _, r in calls[:n_shards * per_split]} == {
        N // n_shards}
    # the counts after the tree are the map's, on every device
    np.testing.assert_array_equal(
        _true_counts(grower).sum(0),
        np.bincount(row_leaf.numpy(), minlength=L + 1))


@pytest.mark.parametrize("shape,pad,slots", SLOT_CASES[2:], ids=SLOT_IDS[2:])
def test_counts_equal_the_row_map_after_every_step(shape, pad, slots):
    """Stepping the learner by hand: after the root and after every step,
    each device's per-shard count of every leaf (sinks included) equals
    ``(row_leaf == leaf).sum()`` over that shard, padding rows included,
    and the moved rows are those the serial tree sends right."""
    bins, g, h, c = _padded(pad)
    cfg = GrowerConfig(**_kw("plain"))
    grower = GspmdGrower(cfg, make_named_mesh(*shape, slots), t(bins))
    meta = FeatureMeta(*[t(a) for a in _meta_np()])
    grower.start(t(g), t(h), t(c), meta, torch.ones(F, dtype=torch.bool))
    _true_counts(grower)
    for _ in range(L - 1):
        grower.step()
        _true_counts(grower)
    splits = int(grower.counters[0])
    stree, srow = grow_tree(t(bins), t(g), t(h), t(c), meta,
                            torch.ones(F, dtype=torch.bool), cfg)
    assert splits == int(stree.num_leaves) - 1
    full = torch.cat([grower._shard(grower.row_leaf[devs[0]], i, devs[0])
                      for i, devs in enumerate(grower.mesh.devices)])
    np.testing.assert_array_equal(full.numpy(), srow.numpy())


def _state(grower):
    """Every tensor of the learner's state, by name."""
    pool = grower.pool
    out = {k: v.clone() for k, v in vars(pool).items()
           if isinstance(v, torch.Tensor)}
    for dv in grower.held:
        out[f"row_leaf{dv}"] = grower.row_leaf[dv].clone()
        out[f"counts{dv}"] = grower.counts[dv].clone()
    out["counters"] = grower.counters.clone()
    return out


@pytest.mark.parametrize("shape,slots", [((8, 1), CPU8), ((2, 4), CPU8),
                                         ((2, 2), TWO)],
                         ids=["8x1", "2x4", "2x2-two-devices"])
def test_steps_after_the_stop_change_nothing_but_sinks(shape, slots):
    """A tree that stops early (at depth 2: four leaves, then no leaf
    may split), then more steps: the pool's leaf
    rows but the sink ``L``, its node rows but ``L - 1``, the row -> leaf
    maps, the counts of every real leaf and the counters stay as they
    were."""
    bins, g, h, c = _int_args()
    cfg = GrowerConfig(**dict(_kw("plain"), max_depth=2))
    grower = GspmdGrower(cfg, make_named_mesh(*shape, slots), t(bins))
    stats = {}
    tree, _ = grower(t(g), t(h), t(c), FeatureMeta(
        *[t(a) for a in _meta_np()]), torch.ones(F, dtype=torch.bool), stats)
    assert int(tree.num_leaves) == 4 and stats["steps"] == L - 1
    before = _state(grower)
    for _ in range(5):
        grower.step()
    after = _state(grower)
    sink_leaf = {"hist_store", "feat_ok", "sgain", "sf32", "si32", "scat",
                 "scatb", "leaf_f", "leaf_parent", "leaf_depth"}
    for k, v in before.items():
        w = after[k]
        if k in sink_leaf:
            v, w = v[:L], w[:L]
        elif k in ("node_f", "node_i", "node_cat", "node_catb",
                   "left_child", "right_child"):
            v, w = v[:L - 1], w[:L - 1]
        elif k.startswith("counts"):
            v, w = v[:, :L], w[:, :L]
        assert torch.equal(v, w), k


def test_booster_holds_one_learner_across_trees():
    """``train`` makes the learner once and grows every tree with it, on
    the loop it picks: the eager loop on the CPU, with no graph."""
    x, y = _task(n=1000)
    bst = _train_port(x, y, rounds=2, gspmd_hist="fused")
    inner = bst.inner
    learner = inner._gspmd
    assert learner.graph is None and learner.loop(None) == "eager"
    assert inner.stats["steps"] >= inner.stats["splits"] > 0
    bst.update()
    assert inner._gspmd is learner and inner.stats["trees"] == 3


def test_loop_choice_and_captured_inputs():
    """On the CPU the learner takes the eager loop; asking for the graph
    raises, and so does a tree on other metadata once a step is
    captured."""
    bins, g, h, c = _int_args()
    cfg = GrowerConfig(**_kw("plain"))
    grower = GspmdGrower(cfg, make_named_mesh(2, 4, CPU8), t(bins))
    assert grower.loop(None) == "eager" == grower.loop("eager")
    for bad in ("graph", "replay"):
        with pytest.raises(ValueError, match="loop="):
            grower.loop(bad)
    meta = FeatureMeta(*[t(a) for a in _meta_np()])
    ones = torch.ones(F, dtype=torch.bool)
    tree, _ = grower(t(g), t(h), t(c), meta, ones, loop="eager")
    grower.graph = object()     # as after a capture on a card
    with pytest.raises(ValueError, match="captured"):
        grower(t(g), t(h), t(c), FeatureMeta(*[t(a) for a in _meta_np()]),
               ones)
    with pytest.raises(ValueError, match="captured"):
        grower(t(g), t(h), t(c), meta, ones.clone())


# ---- train() ----------------------------------------------------------------


def _task(n=3000, f=16, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f))
    z = x @ np.linspace(1.5, 0.2, f) + 0.8 * np.sin(3 * x[:, 0])
    y = (z + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    return x, y


COMMON = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
              learning_rate=0.1, verbose=-1, enable_bundle=False,
              enable_bin_packing=False, tree_learner="data",
              mesh_shape="2x4", mesh_devices=8)


def _train_port(x, y, rounds=3, **kw):
    p = dict(COMMON, device="cpu", **kw)
    return lt.train(p, lt.Dataset(x, y, params=p), rounds, verbose_eval=False)


def test_train_fused_matches_jax_and_flat():
    x, y = _task()
    p = dict(COMMON, gspmd_hist="fused")
    bj = lj.train(p, lj.Dataset(x, y, params=p), 3, verbose_eval=False)
    assert bj.inner.grower_cfg.hist_method == "fused"
    bt = _train_port(x, y, gspmd_hist="fused")
    inner = bt.inner
    assert (inner.parallel_impl, inner.gspmd_hist) == ("gspmd", "fused")
    assert inner.mesh.shape == {"batch": 2, "feature": 4}
    assert not inner.downgrades
    np.testing.assert_allclose(bt.predict(x, raw_score=True),
                               bj.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(bt.predict(x), bj.predict(x), atol=1e-4)
    flat = _train_port(x, y, gspmd_hist="flat")
    assert flat.inner.gspmd_hist == "flat"
    np.testing.assert_allclose(bt.predict(x), flat.predict(x), rtol=2e-5,
                               atol=2e-6)
    assert _train_port(x, y, rounds=1).inner.gspmd_hist == "flat"   # auto


def test_auto_resolves_to_the_kernel_on_a_card():
    assert resolve_gspmd_hist("auto", torch.device("cuda")) == "fused"
    assert resolve_gspmd_hist("auto", torch.device("cuda", 1)) == "fused"
    assert resolve_gspmd_hist("auto", torch.device("cpu")) == "flat"
    for hist in ("fused", "flat"):
        assert resolve_gspmd_hist(hist, torch.device("cuda")) == hist


def test_train_pads_rows_and_matches_serial_first_tree():
    """3001 rows over 2 batch shards; the first tree's sums are exact
    (gradients +-0.5, hessians 0.25), so its text equals the serial
    learner's."""
    x, y = _task(n=3001)
    bt = _train_port(x, y, rounds=1, gspmd_hist="fused")
    assert bt.inner._row_pad == 1
    ps = dict(COMMON, device="cpu", tree_learner="serial")
    bs = lt.train(ps, lt.Dataset(x, y, params=ps), 1, verbose_eval=False)
    assert bt.model_to_string() == bs.model_to_string()


@pytest.mark.parametrize("learner,shape", [("feature", "feature"),
                                           ("data_feature", "2x4"),
                                           ("data", "data")])
def test_parallel_learners_take_the_mesh(learner, shape):
    """feature and data_feature run the same learner over their mesh; the
    first tree's sums are exact, so its text equals the serial one's."""
    x, y = _task(n=2000)
    bt = _train_port(x, y, rounds=1, tree_learner=learner, mesh_shape=shape,
                     gspmd_hist="fused")
    want = {"feature": (1, 8), "data_feature": (2, 4), "data": (8, 1)}
    m = bt.inner.mesh.shape
    assert (m["batch"], m["feature"]) == want[learner]
    assert bt.inner.gspmd_hist == "fused"
    ps = dict(COMMON, device="cpu", tree_learner="serial")
    bs = lt.train(ps, lt.Dataset(x, y, params=ps), 1, verbose_eval=False)
    assert bt.model_to_string() == bs.model_to_string()


# ---- uneven slices, fallbacks and raises -------------------------------------


def test_fused_downgrades_loudly_on_uneven_columns(caplog):
    """30 columns over 8 feature shards (slices of 4 and 3 columns): the
    JAX package downgrades fused to flat, since its TPU layout needs equal
    slices; the port's kernel takes each slice at its own width, so it
    stays fused, with no downgrade, and agrees with the JAX learner and
    with its own flat histogram."""
    x, y = _task(n=1500, f=30)
    p = dict(COMMON, mesh_shape="1x8", gspmd_hist="fused")
    bj = lj.train(p, lj.Dataset(x, y, params=p), 2, verbose_eval=False)
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        bst = _train_port(x, y, rounds=2, mesh_shape="1x8",
                          gspmd_hist="fused", verbose=0)
    assert bst.inner.gspmd_hist == "fused" and not bst.inner.downgrades
    assert "unavailable" not in caplog.text
    assert [len(c) for c in column_slices(30, 8)] == [4] * 6 + [3] * 2
    widths = [s.shape[1] for s in bst.inner._gspmd.slices[0]]
    assert widths == [4] * 6 + [3] * 2
    np.testing.assert_allclose(bst.predict(x, raw_score=True),
                               bj.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)
    flat = _train_port(x, y, rounds=2, mesh_shape="1x8", gspmd_hist="flat")
    np.testing.assert_allclose(bst.predict(x), flat.predict(x), rtol=2e-5,
                               atol=2e-6)


def test_one_slot_falls_back_to_serial(caplog):
    x, y = _task(n=1000)
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        bst = _train_port(x, y, rounds=1, mesh_devices=0, mesh_shape="auto",
                          verbose=0)
    assert bst.inner.parallel_impl == "serial" and bst.inner.mesh is None
    assert bst.inner.downgrades[0]["resolved"] == "serial"
    assert "falling back to serial" in caplog.text


@pytest.mark.parametrize("params", [
    dict(shard_axes="batch,feature"),
    dict(mesh_shape="auto"),
], ids=["block-shard", "mesh-auto"])
def test_values_outside_the_slice_raise(params):
    """The two values that were outside the slice and raised now train:
    block-sharded bins hold no full-width route copy and give the
    replicated layout's model; ``mesh_shape=auto`` is planned (with no
    capacity on the CPU, the preferred pure data-parallel shape)."""
    x, y = _task(n=500)
    bst = _train_port(x, y, rounds=1, **params)
    plan = bst.inner.mesh_plan
    if "shard_axes" in params:
        assert plan.block_shard_bins and bst.inner._gspmd.route_bins is None
        want = _train_port(x, y, rounds=1, shard_axes="batch")
        assert bst.model_to_string() == want.model_to_string()
    else:
        assert (plan.data, plan.feature, plan.block_shard_bins) == (8, 1,
                                                                    False)
        assert "no capacity signal" in plan.reason


def test_mesh_helpers():
    assert parse_mesh_shape("2x4", 8) == (2, 4)
    assert parse_mesh_shape("data", 8) == (8, 1)
    assert parse_mesh_shape("feature", 8) == (1, 8)
    assert parse_mesh_shape("auto", 8) is None
    assert mesh_shape_extents("2*4") == (2, 4)
    assert mesh_shape_extents(" Data ") == "data"
    with pytest.raises(ValueError):
        parse_mesh_shape("4x4", 8)
    for bad in ("0x2", "2x", "abc", "2x2x2"):
        with pytest.raises(ValueError):
            mesh_shape_extents(bad)
        with pytest.raises(RuntimeError, match="mesh_shape"):
            config_from_params(dict(mesh_shape=bad, device="cpu"))
    with pytest.raises(MeshPlanError):
        make_named_mesh(4, 4, CPU8)
    mesh = make_named_mesh(2, 4, CPU8)
    assert mesh.shape == {"batch": 2, "feature": 4}
    assert mesh_slots(0, torch.device("cpu")) == [torch.device("cpu")]
    assert len(CPU8) == 8
