"""Block-sharded bins (``shard_axes=batch,feature``) and the memory model's
census, held against lightgbm_tpu on the CPU.

* The plain block route (``ops/route.py:route_rows_block_plain``) against
  the plain ``route_rows`` on the gathered full matrix: the same row ->
  leaf map and per-shard counts, exactly, on uint8 and uint16 bins, a
  bundled column, a categorical split, and the split column owned by each
  feature shard in turn.
* The port's block-sharded learner (each slot holding only its column
  slice of its batch shard) against the JAX package's
  ``make_gspmd_grower(..., block_shard=True)`` over ``P(batch, feature)``
  bins on the 8 virtual CPU devices of tests/conftest.py, under integer
  weights whose sums are exact in any order: every TreeArrays field and
  the row -> leaf map identical, and identical to the port's replicated
  and serial trees; with the slots over two devices (the owner's route
  copied to the other device); under float weights, ``train``'s
  predictions within 1e-4 of the JAX package's (test_torch_gspmd.py's
  tolerance) and equal to the replicated layout's.
* ``obs/memory.live_census`` equal, term by term and to the byte, to the
  resident terms of ``obs/memory.predict_hbm`` at the layout the booster
  planned: the serial, streamed, 4x1, 2x2 replicated, 2x2 block-sharded
  and voting learners, uint8 and uint16, packed and bundled.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.grower import FeatureMeta as JaxMeta
from lightgbm_tpu.grower import GrowerConfig as JaxGrowerConfig
from lightgbm_tpu.parallel import mesh as jax_mesh
from lightgbm_tpu.parallel.gspmd import make_gspmd_grower
from lightgbm_tpu_torch.grower import FeatureMeta, GrowerConfig, grow_tree
from lightgbm_tpu_torch.obs import memory
from lightgbm_tpu_torch.ops.route import (make_block_bins,
                                          route_rows_block_plain,
                                          route_rows_plain)
from lightgbm_tpu_torch.parallel import mesh as mesh_mod
from lightgbm_tpu_torch.parallel.gspmd import GspmdGrower, column_slices
from lightgbm_tpu_torch.parallel.mesh import make_named_mesh, mesh_slots

N, F, B, L = 4096, 8, 32, 15
CPU8 = mesh_slots(8, torch.device("cpu"))
t = torch.from_numpy


# ---- the plain block route ---------------------------------------------------


def _route_meta(f, nb, bundled):
    """Meta of ``f`` physical columns of ``nb`` bins: column 0 NaN-missing,
    column 1 zero-missing; bundled, column f - 1 holds two features of
    (nb // 2) bins each, slots 1.. and nb // 2 ..."""
    e = f + 1 if bundled else f
    num_bin = np.full(e, nb, np.int32)
    mt = np.zeros(e, np.int32)
    mt[0], mt[1] = 2, 1
    db = np.zeros(e, np.int32)
    db[1] = 3
    col = off = None
    if bundled:
        half = nb // 2
        num_bin[-2:] = half
        col = np.concatenate([np.arange(f - 1), [f - 1, f - 1]]).astype(
            np.int32)
        off = np.full(e, -1, np.int32)
        off[-2], off[-1] = 1, half
        col, off = t(col), t(off)
    return FeatureMeta(t(num_bin), t(mt), t(db),
                       t(np.zeros(e, bool)), col, off)


@pytest.mark.parametrize("dtype,nb", [(np.uint8, 200), (np.uint16, 1000)],
                         ids=["uint8", "uint16"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 3)],
                         ids=["2x2", "1x4", "2x3"])
@pytest.mark.parametrize("bundled", [False, True], ids=["plain", "bundled"])
def test_block_route_equals_route_rows_on_the_gathered_matrix(
        dtype, nb, shape, bundled):
    """Each feature (so each column, so each feature shard in turn, the
    bundled column's two features among them) splits once; the block
    route and the plain route over the gathered ``[F, n]`` matrix leave
    the same map and counts, bit for bit."""
    d, fs = shape
    f, n_loc = 7, 600
    rng = np.random.default_rng(5)
    bins = rng.integers(0, nb, size=(d * n_loc, f)).astype(dtype)
    meta = _route_meta(f, nb, bundled)
    e = meta.num_bin.numel()
    cols = column_slices(f, fs)
    edges = [c.start for c in cols] + [f]
    slices = [[t(bins[i * n_loc:(i + 1) * n_loc, c.start:c.stop].copy())
               for c in cols] for i in range(d)]
    block = make_block_bins(slices, edges, torch.device("cpu"))
    rl_a = torch.from_numpy(rng.integers(0, 3, d * n_loc).astype(np.int32))
    rl_b = rl_a.clone()
    cnt = torch.stack([torch.bincount(rl_a[i * n_loc:(i + 1) * n_loc],
                                      minlength=L + 1).int()
                       for i in range(d)])
    cnt_a, cnt_b = cnt.clone(), cnt.clone()
    gathered = t(np.ascontiguousarray(bins.T))
    split_i32 = torch.zeros((L + 1, 3), dtype=torch.int32)
    cat = torch.zeros(L + 1, dtype=torch.bool)
    catb = torch.zeros((L + 1, nb), dtype=torch.bool)
    catb[1, ::3] = True
    for step, feat in enumerate(range(e)):
        leaf = step % 3
        new = 3 + step
        thr = int(meta.num_bin[feat]) // 3
        split_i32[leaf] = torch.tensor([feat, thr, step % 2])
        cat[leaf] = step == 1          # one categorical split
        args = (torch.tensor([leaf]), torch.tensor([new]), split_i32, cat,
                catb, meta)
        route_rows_block_plain(rl_a, block, *args, cnt_a)
        route_rows_plain(rl_b, gathered, *args, cnt_b)
        assert torch.equal(rl_a, rl_b), (feat, step)
        assert torch.equal(cnt_a, cnt_b), (feat, step)
        cat[leaf] = False
    assert int((rl_a >= 3).sum()) > 0


def test_block_route_leaves_shards_owned_elsewhere():
    """A shard whose owning slice another device holds is left as it
    is."""
    rng = np.random.default_rng(1)
    bins = rng.integers(0, 50, size=(200, 4)).astype(np.uint8)
    meta = _route_meta(4, 50, False)
    s = [[t(bins[i * 100:(i + 1) * 100, j * 2:(j + 1) * 2].copy())
          for j in range(2)] for i in range(2)]
    s[1][1] = None
    block = make_block_bins(s, [0, 2, 4], torch.device("cpu"))
    rl = torch.zeros(200, dtype=torch.int32)
    cnt = torch.tensor([[100] + [0] * L, [100] + [0] * L], dtype=torch.int32)
    split_i32 = torch.zeros((L + 1, 3), dtype=torch.int32)
    split_i32[0] = torch.tensor([3, 20, 0])
    route_rows_block_plain(rl, block, torch.tensor([0]), torch.tensor([1]),
                           split_i32, None, None, meta, cnt)
    assert int((rl[:100] == 1).sum()) == int((bins[:100, 3] > 20).sum())
    assert int(rl[100:].abs().sum()) == 0 and int(cnt[1, 0]) == 100


# ---- block-sharded trees -----------------------------------------------------


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


def _jax_block(case, shape):
    bins, g, h, c = _int_args(CASES[case][2])
    mesh = jax_mesh.make_named_mesh(*shape)
    grow = make_gspmd_grower(JaxGrowerConfig(hist_method="segment",
                                             **_kw(case)), mesh,
                             block_shard=True)
    rs = NamedSharding(mesh, P(jax_mesh.BATCH_AXIS))
    meta = JaxMeta(*[jnp.asarray(a) for a in _meta_np(**CASES[case][1])])
    tree, row_leaf = grow(
        jax.device_put(bins, NamedSharding(mesh, P(jax_mesh.BATCH_AXIS,
                                                   jax_mesh.FEATURE_AXIS))),
        jax.device_put(g, rs), jax.device_put(h, rs), jax.device_put(c, rs),
        meta, jnp.ones((F,), bool))
    return jax.tree_util.tree_map(np.asarray, tree), np.asarray(row_leaf)


def _port(case, shape=None, block=False, devices=CPU8, hist="fused"):
    bins, g, h, c = _int_args(CASES[case][2])
    meta = FeatureMeta(*[t(a) for a in _meta_np(**CASES[case][1])])
    cfg = GrowerConfig(**_kw(case))
    ones = torch.ones(F, dtype=torch.bool)
    if shape is None:
        return grow_tree(t(bins), t(g), t(h), t(c), meta, ones, cfg), None
    grower = GspmdGrower(cfg, make_named_mesh(*shape, devices), t(bins),
                         hist, block_shard=block)
    return grower(t(g), t(h), t(c), meta, ones), grower


def _assert_same(tree, row_leaf, jtree, jrow, what):
    assert int(tree.num_leaves) == int(jtree.num_leaves) > 1, what
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


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("case", ["plain", "missing", "categorical"])
def test_block_sharded_tree_identical_to_jax_replicated_and_serial(
        shape, case):
    jtree, jrow = _jax_block(case, shape)
    (tree, row_leaf), grower = _port(case, shape, block=True)
    # no device holds a full-width route copy; each slot its slice
    assert grower.route_bins is None and grower.block is not None
    assert [s.shape[1] for s in grower.slices[0]] == [
        len(c) for c in column_slices(F, shape[1])]
    _assert_same(tree, row_leaf, jtree, jrow, f"{shape} {case} vs JAX")
    (rtree, rrow), _ = _port(case, shape)
    _assert_same(tree, row_leaf, rtree, rrow, f"{shape} {case} replicated")
    (stree, srow), _ = _port(case)
    _assert_same(tree, row_leaf, stree, srow, f"{shape} {case} serial")


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 4)],
                         ids=["2x2", "1x4", "2x4"])
def test_block_sharded_slots_over_two_devices(shape):
    """Slots round-robin over two devices (the two CPU device names stand
    in for two cards): the device that owns a shard's split column routes
    it, and its map and counts go to the other device's copy; the tree is
    the serial tree and the counts stay exact."""
    two = [torch.device("cpu"), torch.device("cpu", 0)] * 4
    (tree, row_leaf), grower = _port("plain", shape, block=True,
                                     devices=two)
    assert len(grower.held) == 2
    (stree, srow), _ = _port("plain")
    _assert_same(tree, row_leaf, stree, srow, f"{shape} over two devices")
    for dv, held in grower.held.items():
        rl = grower.row_leaf[dv].view(len(held), -1)
        want = torch.stack([torch.bincount(r, minlength=L + 1).int()
                            for r in rl])
        assert torch.equal(grower.counts[dv], want)
    assert grower.coll_stats["block_route_bytes"] > 0


def _task(n=3000, f=16, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f))
    z = x @ np.linspace(1.5, 0.2, f) + 0.8 * np.sin(3 * x[:, 0])
    y = (z + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    return x, y


COMMON = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
              learning_rate=0.1, verbose=-1, enable_bundle=False,
              enable_bin_packing=False, tree_learner="data",
              mesh_devices=4)


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_train_block_sharded_matches_jax_and_replicated(shape):
    """Float weights through ``train``: the block-sharded learner within
    1e-4 of ``lightgbm_tpu.train`` with ``shard_axes=batch,feature`` on
    the same mesh (test_torch_gspmd.py's tolerance), and equal to the
    port's replicated layout, whose partial sums are the same."""
    x, y = _task()
    p = dict(COMMON, mesh_shape=shape, shard_axes="batch,feature")
    jp = dict(p, gspmd_hist="flat")
    bj = lj.train(jp, lj.Dataset(x, y, params=jp), 3, verbose_eval=False)
    pt = dict(p, device="cpu")
    bt = lt.train(pt, lt.Dataset(x, y, params=pt), 3, verbose_eval=False)
    assert bt.inner.mesh_plan.block_shard_bins
    assert bt.inner._gspmd.route_bins is None
    np.testing.assert_allclose(bt.predict(x, raw_score=True),
                               bj.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)
    pr = dict(pt, shard_axes="batch")
    br = lt.train(pr, lt.Dataset(x, y, params=pr), 3, verbose_eval=False)
    assert not br.inner.mesh_plan.block_shard_bins
    np.testing.assert_array_equal(bt.predict(x, raw_score=True),
                                  br.predict(x, raw_score=True))


def test_train_block_sharded_packed_routes_unpacked_slices():
    """Packed bins: the histogram keeps its packed slices, routing reads
    unpacked column slices beside them, and the model is the replicated
    layout's."""
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.standard_normal((3000, 4)),
                        rng.integers(0, 6, size=(3000, 8))], axis=1)
    y = (x[:, 0] + 0.3 * x[:, 5] + rng.standard_normal(3000) > 1).astype(
        np.float32)
    p = dict(COMMON, device="cpu", mesh_shape="2x2",
             enable_bin_packing=True, shard_axes="batch,feature")
    bt = lt.train(p, lt.Dataset(x, y, params=p), 3)
    g = bt.inner._gspmd
    assert bt.inner.packed is not None and g.route_slices is not None
    assert g.route_slices[0][0].shape[1] != g.slices[0][0].shape[1]
    pr = dict(p, shard_axes="batch")
    br = lt.train(pr, lt.Dataset(x, y, params=pr), 3)
    assert bt.model_to_string() == br.model_to_string()


# ---- the census ---------------------------------------------------------------


def _census_task(kind):
    rng = np.random.default_rng(7)
    n = 2501
    x = rng.standard_normal((n, 6))
    if kind in ("packed", "bundled"):
        x[:, 3] = rng.integers(0, 5, n)
        x[:, 4] = rng.integers(0, 9, n)
    if kind == "bundled":
        # four mutually exclusive sparse columns, which EFB bundles
        k = rng.integers(0, 12, n)
        x[:, 2:6] = 0
        for j in range(4):
            x[k == j, 2 + j] = rng.integers(1, 4, int((k == j).sum()))
    y = (x[:, 0] + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    return x, y


CENSUS = {
    "serial_u8": (dict(), "plain"),
    "serial_u16": (dict(max_bin=400), "plain"),
    "serial_ordered": (dict(ordered_bins="on", enable_bin_packing=False),
                       "plain"),
    "serial_packed": (dict(), "packed"),
    "serial_bundled": (dict(), "bundled"),
    "streamed": (dict(data_stream="chunked", stream_chunk_rows=700), "plain"),
    "dp_4x1": (dict(tree_learner="data", mesh_devices=4, mesh_shape="4x1"),
               "packed"),
    "dp_2x2": (dict(tree_learner="data", mesh_devices=4, mesh_shape="2x2"),
               "plain"),
    "dp_2x2_block": (dict(tree_learner="data", mesh_devices=4,
                          mesh_shape="2x2", shard_axes="batch,feature"),
                     "packed"),
    "dp_2x2_block_u16": (dict(tree_learner="data", mesh_devices=4,
                              mesh_shape="2x2", shard_axes="batch,feature",
                              max_bin=400), "bundled"),
    "dp_3x1_padded": (dict(tree_learner="data", mesh_devices=3,
                           mesh_shape="3x1"), "plain"),
    "voting_4x1": (dict(tree_learner="voting", mesh_devices=4,
                        mesh_shape="4x1"), "plain"),
}


@pytest.mark.parametrize("name", list(CENSUS))
def test_census_equals_the_resident_terms(name):
    extra, kind = CENSUS[name]
    x, y = _census_task(kind)
    p = dict(objective="binary", device="cpu", verbose=-1, num_leaves=15,
             **extra)
    ds = lt.Dataset(x, y, params=p)
    vx, vy = _census_task(kind)
    bst = lt.train(p, ds, 3, valid_sets=[ds.create_valid(vx[:500],
                                                          vy[:500])])
    inner = bst.inner
    if kind == "packed" and name != "dp_2x2_block":
        assert inner.packed is not None
    if kind == "bundled":
        assert inner.meta.col is not None
    layout = dict(inner.plan.layout, valid_rows=500)
    pred = mesh_mod.predict_hbm(**layout)
    census = memory.live_census(bst)
    assert census == pred["residents"], name
    assert pred["resident_bytes"] == sum(census.values())
