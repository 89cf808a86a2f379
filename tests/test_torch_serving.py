"""The port's serving path against the JAX package's, on the CPU.

Model texts are written by the JAX package (``model_to_string``) and read
by both packages; rows are made from seeds with numpy.  The JAX engine runs
with ``backend="xla"`` and small buckets, so its compiles stay cheap.

* The engine: leaf indices identical and raw scores bit for bit the JAX
  engine's (``lightgbm_tpu/inference.py:800``) for binary models with NaN
  and zero rows, float64 rows that are not exact in float32, multiclass,
  DART, categorical and stumps-only models, prefixes of the trees, on both
  traversals; the packed layout's loud degrade on a categorical model.
* The kernels' modules: the plain traversal of either layout against the
  JAX package's ``_traverse``/``_traverse_packed``, the plain margin
  against the JAX engine's host loop, bit for bit; the traversal kernel's
  plan (``traverse_plan``: tree groups, row tiles, what a block stages)
  within its budget, and the tables cut into its groups and tiles walked
  by the plain traversal equal to the JAX traversals.
* The rest of the slice: ``serving_buckets`` validation, the memory term
  against the engine's own tensors, the ModelServer's coalescing, hot
  swaps (the port trainer's snapshots, JAX-written snapshots and shard
  sets, a torn commit), drift windows and events, the HTTP front and its
  ``/metrics`` families, ``main --replay`` and the report's section.
"""
import contextlib
import gc
import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import checkpoint as j_checkpoint
from lightgbm_tpu import inference as j_inference
from lightgbm_tpu import serving as j_serving
from lightgbm_tpu.boosting import GBDT as JGBDT
from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.config import parse_serving_buckets as j_parse_buckets
from lightgbm_tpu.obs import model_quality as j_quality
from lightgbm_tpu.obs.counters import counters as j_counters
from lightgbm_tpu.predictor import Predictor as JPredictor
from lightgbm_tpu.tree import Tree as JTree
from lightgbm_tpu_torch import inference as t_inference
from lightgbm_tpu_torch import serving as t_serving
from lightgbm_tpu_torch.boosting import GBDT as TGBDT
from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.config import parse_serving_buckets as t_parse_buckets
from lightgbm_tpu_torch.obs import metrics as t_metrics
from lightgbm_tpu_torch.obs import model_quality as t_quality
from lightgbm_tpu_torch.obs import trace as t_trace
from lightgbm_tpu_torch.obs.counters import counters as t_counters
from lightgbm_tpu_torch.obs.report import render as t_render
from lightgbm_tpu_torch.ops import traverse as t_traverse

BUCKETS = (1, 8, 64)
CPU = {"device": "cpu", "verbose": -1}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float64)).view(np.uint64)


def _jax_model(params, X, y, rounds, cat=None):
    p = dict(params, verbose=-1)
    ds = lj.Dataset(X, np.asarray(y, np.float32), params=p,
                    categorical_feature=cat or "auto")
    return lj.train(p, ds, rounds, verbose_eval=False).model_to_string()


def _port_gbdt(model_str):
    return TGBDT.load_from_string(model_str, t_config(dict(CPU)))


@pytest.fixture(scope="module")
def binary_text():
    rng = np.random.RandomState(7)
    X = rng.randn(500, 6).astype(np.float32).astype(np.float64)
    X[rng.rand(500, 6) < 0.08] = np.nan
    X[rng.rand(500, 6) < 0.05] = 0.0
    y = np.nansum(X, axis=1) > 0
    return _jax_model({"objective": "binary", "num_leaves": 15,
                       "min_data_in_leaf": 5, "zero_as_missing": False},
                      X, y, 8)


@pytest.fixture(scope="module")
def test_rows():
    rng = np.random.RandomState(11)
    X = rng.randn(137, 6).astype(np.float32).astype(np.float64)
    X[rng.rand(137, 6) < 0.15] = np.nan
    X[rng.rand(137, 6) < 0.1] = 0.0
    return X


def _multiclass_text():
    rng = np.random.RandomState(1)
    X = rng.randn(400, 8)
    y = rng.randint(0, 5, 400)
    return _jax_model({"objective": "multiclass", "num_class": 5,
                       "num_leaves": 8, "min_data_in_leaf": 5}, X, y, 4)


def _dart_text():
    rng = np.random.RandomState(2)
    X = rng.randn(400, 5)
    y = X.sum(axis=1) > 0
    return _jax_model({"objective": "binary", "boosting_type": "dart",
                       "num_leaves": 8, "min_data_in_leaf": 5,
                       "drop_rate": 0.8, "skip_drop": 0.0}, X, y, 10)


def _categorical_data(n=600, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[:, 1] = rng.randint(0, 12, n)
    X[:, 3] = rng.randint(0, 40, n)
    y = (X[:, 0] + (X[:, 1] % 3 == 1) - (X[:, 3] % 5 == 2)) > 0
    return X, y


def _categorical_text():
    X, y = _categorical_data()
    return _jax_model({"objective": "binary", "num_leaves": 15,
                       "min_data_in_leaf": 5}, X, y, 8, cat=[1, 3])


def _categorical_rows(n=91, seed=5):
    rng = np.random.RandomState(seed)
    Xt = rng.randn(n, 5)
    Xt[:, 1] = rng.randint(-1, 14, n)      # unseen and negative categories
    Xt[:, 3] = rng.randint(0, 45, n)
    Xt[rng.rand(n, 5) < 0.1] = np.nan
    return Xt


def _stumps_text():
    """A model of stumps only: one leaf a tree, no used column."""
    head = ("tree\nnum_class=1\nnum_tree_per_iteration=1\nlabel_index=0\n"
            "max_feature_idx=3\nobjective=binary sigmoid:1\n"
            "feature_names=Column_0 Column_1 Column_2 Column_3\n"
            "feature_infos=none none none none\n\n")
    trees = []
    for i, v in enumerate((0.125, -0.3, 1e-3 / 3, 0.7)):
        t = JTree(1)
        t.leaf_value[0] = v
        trees.append(t.to_string(i))
    return head + "".join(trees) + "\nfeature importances:\n"


def _engine_pair(model_str, traversal):
    jg = JGBDT.load_from_string(model_str)
    je = j_inference.PredictEngine(jg.models, jg.num_class, backend="xla",
                                   buckets=BUCKETS, traversal="xla")
    tg = _port_gbdt(model_str)
    te = t_inference.PredictEngine(tg.models, tg.num_class, buckets=BUCKETS,
                                   traversal=traversal, device="cpu")
    return je, te


CASES = {
    "binary_nan_zero": (None, None),
    "multiclass_k5": (_multiclass_text, lambda: np.random.RandomState(9)
                      .randn(77, 8).astype(np.float32).astype(np.float64)),
    "dart": (_dart_text, lambda: np.random.RandomState(6).randn(60, 5)),
    "categorical": (_categorical_text, _categorical_rows),
    "stumps": (_stumps_text, lambda: np.random.RandomState(3).randn(70, 4)),
}


@pytest.mark.parametrize("traversal", ["xla", "packed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_parity(case, traversal, binary_text, test_rows):
    """Leaf indices identical and raw scores bitwise the JAX engine's, for
    every row count up to and past the largest bucket, on both traversals
    (a categorical model degrades ``packed`` to ``xla``)."""
    make_text, make_rows = CASES[case]
    text = binary_text if make_text is None else make_text()
    X = test_rows if make_rows is None else make_rows()
    je, te = _engine_pair(text, traversal)
    # all the rows (row passes) and the first 50 (one microbatch)
    for rows in (X, X[:50]):
        np.testing.assert_array_equal(te.leaves(rows), je.leaves(rows))
        assert (_bits(te.raw_scores(rows))
                == _bits(je.raw_scores(rows))).all()
    if te.bundle.packed:
        assert te.traversal == traversal
    # the booster's own predict (the bundle's passes) gives the same bits
    bst = lt.Booster(params=dict(CPU), model_str=text)
    raw = np.atleast_2d(bst.predict(X, raw_score=True).T)
    assert (_bits(raw) == _bits(je.raw_scores(X))).all()


def test_engine_parity_float64_rows(binary_text, test_rows):
    """Rows that are not exact in float32: the JAX engine bins them on the
    host in float64 (its ``binned`` path); the port bins every row on the
    device in float64 and gives the same leaves and bits."""
    rng = np.random.RandomState(3)
    X = test_rows + 1e-13 * rng.randn(*test_rows.shape)
    j_counters.reset()
    for traversal in ("xla", "packed"):
        je, te = _engine_pair(binary_text, traversal)
        np.testing.assert_array_equal(te.leaves(X), je.leaves(X))
        assert (_bits(te.raw_scores(X)) == _bits(je.raw_scores(X))).all()
    paths = {k.split("path=")[1].split(",")[0]
             for k in j_counters.get("predict_dispatch")}
    assert paths == {"binned"}


@pytest.mark.parametrize("num_trees", [1, 3, 7, 8, 100])
def test_engine_tree_prefixes(binary_text, test_rows, num_trees):
    """``raw_scores(num_trees=)`` and a Predictor of the first iterations
    through the engine, bitwise the JAX engine's."""
    je, te = _engine_pair(binary_text, "xla")
    want = je.raw_scores(test_rows, num_trees=num_trees)
    assert (_bits(te.raw_scores(test_rows, num_trees=num_trees))
            == _bits(want)).all()
    tg = _port_gbdt(binary_text)
    k = min(num_trees, len(tg.models))
    p = lt.predictor.Predictor(tg.models[:k], 1, None, torch.device("cpu"),
                               engine=te)
    assert (_bits(p.predict_raw(test_rows)) == _bits(want)).all()


def test_packed_degrades_loudly_on_categorical():
    """An explicit ``packed`` on a categorical model resolves to ``xla``
    with the JAX package's ``layout_downgrade`` event, in both packages."""
    text = _categorical_text()
    tg = _port_gbdt(text)
    t_counters.reset()
    te = t_inference.PredictEngine(tg.models, 1, traversal="packed",
                                   device="cpu")
    assert te.traversal == "xla" and not te.bundle.packed
    jg = JGBDT.load_from_string(text)
    j_counters.reset()
    je = j_inference.PredictEngine(jg.models, 1, backend="xla",
                                   traversal="packed")
    assert je.traversal == "xla"
    strip = lambda evs: [{k: v for k, v in e.items() if k not in ("ts",)}
                         for e in evs]
    assert strip(t_counters.events("layout_downgrade")) == strip(
        j_counters.events("layout_downgrade"))


def test_auto_traversal_resolves_as_jax(binary_text):
    """``auto`` is ``packed`` on the CPU for a packable model, as the JAX
    package resolves it on a bare CPU backend."""
    tg = _port_gbdt(binary_text)
    te = t_inference.PredictEngine(tg.models, 1, device="cpu")
    jg = JGBDT.load_from_string(binary_text)
    je = j_inference.PredictEngine(jg.models, 1, backend="xla")
    assert te.traversal == je.traversal == "packed"


# ---- the kernels' modules ---------------------------------------------------


def _random_tables(rng, t_count=6, fc=5, leaves=9):
    """Random trees' numerical node tables (every missing type) in the JAX
    ``SoABundle`` field layout: node 0 the root, each further node hung
    under an open child slot of an earlier one, the slots left over the
    leaves."""
    p = leaves - 1
    feat = rng.randint(0, fc, (t_count, p)).astype(np.int32)
    thr = rng.randint(0, 20, (t_count, p)).astype(np.int32)
    dl = rng.rand(t_count, p) < 0.5
    miss = rng.randint(0, 3, (t_count, p)).astype(np.int32)
    lc = np.full((t_count, p), -1, np.int32)
    rc = np.full((t_count, p), -1, np.int32)
    for t in range(t_count):
        slots = [(0, 0), (0, 1)]
        for i in range(1, p):
            node, side = slots.pop(rng.randint(len(slots)))
            (lc if side == 0 else rc)[t, node] = i
            slots += [(i, 0), (i, 1)]
        for leaf, (node, side) in enumerate(slots):
            (lc if side == 0 else rc)[t, node] = ~leaf
    return feat, thr, dl, miss, lc, rc


def test_plain_traversals_equal_jax_traversals():
    rng = np.random.RandomState(0)
    feat, thr, dl, miss, lc, rc = _random_tables(rng)
    t_count, p = feat.shape
    n, fc = 300, 5
    bins = rng.randint(0, 21, (n, fc)).astype(np.int32)
    cats = np.zeros((n, fc), np.int32)
    nanm = rng.rand(n, fc) < 0.2
    zerom = rng.rand(n, fc) < 0.2
    ic = np.zeros((t_count, p), bool)
    cref = np.zeros((t_count, p), np.int32)
    cmask = np.zeros((1, 1), bool)
    want = np.asarray(jax.jit(j_inference._traverse)(
        bins, cats, nanm, zerom, feat, thr, dl, miss, lc, rc, ic, cref,
        cmask))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    binned = (T(bins.T), T(cats.T), T(nanm.T), T(zerom.T))
    got = t_traverse.traverse(binned, (T(feat), T(thr), T(dl), T(miss),
                                       T(lc), T(rc), T(ic), T(cref),
                                       T(cmask)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the packed layout: the JAX package's words and data words
    w0, w1 = t_traverse.pack_nodes(T(feat), T(thr), T(dl), T(miss), T(lc),
                                   T(rc))
    data = t_traverse.pack_data(*binned[:1], *binned[2:])
    depth = int(p)
    jdata = np.asarray(j_inference._pack_data_words(bins, nanm, zerom))
    np.testing.assert_array_equal(data.numpy(), jdata.T)
    want_p = np.asarray(jax.jit(j_inference._traverse_packed)(
        jdata, w0.numpy(), w1.numpy(), depth))
    got_p = t_traverse.traverse((data,), (w0, w1), "packed")
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_p.numpy(), want)


def test_plain_traversal_categorical_equals_jax():
    """Categorical nodes (negative, unseen and NaN categories) through the
    plain traversal against ``_traverse`` on one real model's tables."""
    text = _categorical_text()
    Xt = _categorical_rows(200, seed=8)
    jg = JGBDT.load_from_string(text)
    jb = j_inference.SoABundle.build(jg.models, 1)
    jbins = jb.bin_host(Xt[:, jb.cols])
    want = np.asarray(jax.jit(j_inference._traverse)(
        *jbins, *jb.device_args()))[:jb.num_trees]
    tb = _port_gbdt(text)
    bundle = lt.predictor.SoABundle(tb.models, torch.device("cpu"))
    got = t_traverse.traverse(bundle.bin_rows(Xt), bundle.nodes("xla"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layout", ["packed", "xla"])
@pytest.mark.parametrize("rows", [1, 64, 300, 4096, 65536])
@pytest.mark.parametrize("nodes", [254, 16383])
def test_traverse_plan_stages_within_the_budget(rows, nodes, layout):
    """The kernel's plan for 100 trees over 28 columns on a 132-SM card:
    row tiles and tree groups cover every (tree, row) once; at a few rows
    one tree a block (every SM takes part), at many no more than
    ``GROUP_MAX`` and eight blocks an SM (packed; node tables sixteen,
    and no group up to 4,096 rows); the packed layout's shared
    memory is what its stage holds, within the budget, a tree past it
    (16,383 nodes: 131 KB) walked from global memory; node tables staged
    nowhere."""
    sms, t_count, cols = 132, 100, 28
    p = t_traverse.traverse_plan(t_count, rows, nodes, cols, layout, sms)
    assert p.rows_tile & (p.rows_tile - 1) == 0
    assert p.rows_tile <= t_traverse.ROWS_TILE
    assert p.threads == max(32, p.rows_tile)
    assert 1 <= p.group <= t_traverse.GROUP_MAX
    assert (p.tiles - 1) * p.rows_tile < rows <= p.tiles * p.rows_tile
    assert (p.groups - 1) * p.group < t_count <= p.groups * p.group
    if rows <= 64 or (layout == "xla" and rows <= 4096):
        assert p.group == 1 and p.groups == t_count
    if p.group > 1:
        per_sm = (t_traverse.PACKED_BLOCKS_PER_SM if layout == "packed"
                  else t_traverse.SOA_BLOCKS_PER_SM)
        assert p.tiles * p.groups >= per_sm * sms
    node_b = 8 * nodes * p.group
    data_b = 4 * cols * p.rows_tile
    want = {t_traverse.STAGE_NONE: 0,
            t_traverse.STAGE_ALL: node_b + data_b}[p.stage]
    assert p.smem == want <= t_traverse.STAGE_BYTES
    if layout == "xla" or node_b + data_b > t_traverse.STAGE_BYTES:
        assert p.stage == t_traverse.STAGE_NONE
    else:
        assert p.stage == t_traverse.STAGE_ALL


def _walk_blocks(plan, binned, nodes, layout):
    """The traversal walked block by block as the plan lays it out: each
    block's tree group (the node rows it stages) over its tile of rows
    (the columns' words it stages), by the plain traversal."""
    t_count, n = nodes[0].shape[0], binned[0].shape[1]
    out = torch.full((t_count, n), -1, dtype=torch.int32)
    for i in range(plan.tiles * plan.groups):
        g, tile = divmod(i, plan.tiles)
        ts = slice(g * plan.group, min(t_count, (g + 1) * plan.group))
        rs = slice(tile * plan.rows_tile, min(n, (tile + 1) * plan.rows_tile))
        staged = tuple(b[:, rs].contiguous() for b in binned)
        group = tuple(t[ts].contiguous() for t in nodes[:8]) + nodes[8:]
        assert (out[ts, rs] == -1).all()
        out[ts, rs] = t_traverse.traverse(staged, group, layout)
    assert (out >= 0).all()
    return out


@pytest.mark.parametrize("sms", [1, 4, 132])
def test_staged_groups_walk_equals_jax_traversals(sms):
    """Random trees' tables cut into the plan's tree groups and row tiles
    (groups of several trees on small cards) and walked group by group
    with the plain traversal: the leaves of ``_traverse`` and
    ``_traverse_packed``."""
    rng = np.random.RandomState(3)
    feat, thr, dl, miss, lc, rc = _random_tables(rng, t_count=21, leaves=31)
    t_count, p = feat.shape
    n, fc = 300, 5
    bins = rng.randint(0, 21, (n, fc)).astype(np.int32)
    nanm = rng.rand(n, fc) < 0.2
    zerom = rng.rand(n, fc) < 0.2
    cats = np.zeros((n, fc), np.int32)
    ic = np.zeros((t_count, p), bool)
    cref = np.zeros((t_count, p), np.int32)
    cmask = np.zeros((1, 1), bool)
    want = np.asarray(jax.jit(j_inference._traverse)(
        bins, cats, nanm, zerom, feat, thr, dl, miss, lc, rc, ic, cref,
        cmask))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    binned = (T(bins.T), T(cats.T), T(nanm.T), T(zerom.T))
    nodes = tuple(T(a) for a in (feat, thr, dl, miss, lc, rc, ic, cref,
                                 cmask))
    plan = t_traverse.traverse_plan(t_count, n, p, fc, "xla", sms)
    if sms == 1:
        assert plan.group > 1 and plan.tiles > 1
    np.testing.assert_array_equal(
        _walk_blocks(plan, binned, nodes, "xla").numpy(), want)
    w0, w1 = t_traverse.pack_nodes(*nodes[:6])
    data = t_traverse.pack_data(binned[0], binned[2], binned[3])
    want_p = np.asarray(jax.jit(j_inference._traverse_packed)(
        np.asarray(j_inference._pack_data_words(bins, nanm, zerom)),
        w0.numpy(), w1.numpy(), p))
    plan = t_traverse.traverse_plan(t_count, n, p, fc, "packed", sms)
    np.testing.assert_array_equal(
        _walk_blocks(plan, (data,), (w0, w1), "packed").numpy(), want_p)
    np.testing.assert_array_equal(want_p, want)


def test_staged_groups_walk_categorical_equals_jax():
    """A categorical model's node tables cut into the plan's groups and
    tiles on a 1-SM card (enough rows that node tables form groups): the
    leaves of ``_traverse``."""
    text = _categorical_text()
    Xt = _categorical_rows(512, seed=9)
    jg = JGBDT.load_from_string(text)
    jb = j_inference.SoABundle.build(jg.models, 1)
    want = np.asarray(jax.jit(j_inference._traverse)(
        *jb.bin_host(Xt[:, jb.cols]), *jb.device_args()))[:jb.num_trees]
    bundle = lt.predictor.SoABundle(_port_gbdt(text).models,
                                    torch.device("cpu"))
    binned = bundle.bin_rows(Xt)
    nodes = bundle.nodes("xla")
    plan = t_traverse.traverse_plan(
        bundle.num_trees, len(Xt), nodes[0].shape[1], binned[0].shape[0],
        "xla", 1)
    assert plan.group > 1 and plan.stage == t_traverse.STAGE_NONE
    np.testing.assert_array_equal(
        _walk_blocks(plan, binned, nodes, "xla").numpy(), want)


@pytest.mark.parametrize("k", [1, 3])
def test_plain_margin_bitwise_jax_host_loop(k):
    """The plain margin is the JAX engine's host loop
    (``inference.py:826-833``) bit for bit, continued across passes."""
    rng = np.random.RandomState(k)
    t_count, n, p1 = 12 * k, 257, 16
    leaf = rng.randint(0, p1, (t_count, n)).astype(np.int32)
    lv = rng.randn(t_count, p1) * 10.0 ** rng.randint(-8, 3, (t_count, 1))
    want = np.zeros((k, n), np.float64)
    for t in range(t_count):
        want[t % k] += lv[t][leaf[t]]
    out = torch.zeros((k, n), dtype=torch.float64)
    half = (t_count // (2 * k)) * k
    for ts in (slice(0, half), slice(half, t_count)):
        t_traverse.margin(torch.from_numpy(leaf[ts].copy()),
                          torch.from_numpy(lv[ts].copy()), k, out)
    assert (_bits(out.numpy()) == _bits(want)).all()
    assert t_traverse.margin.launches == 0     # the CPU launches nothing


# ---- configuration and memory ---------------------------------------------


def test_serving_buckets_validation_matches_jax():
    assert t_parse_buckets("1, 8,64") == j_parse_buckets("1, 8,64")
    assert t_parse_buckets([1, 8]) == (1, 8)
    for bad in ("", "0,4", "8,4", "4,4"):
        with pytest.raises(ValueError) as te:
            t_parse_buckets(bad)
        with pytest.raises(ValueError) as je:
            j_parse_buckets(bad)
        assert str(te.value) == str(je.value)
    for params in ({"serving_buckets": "8,4"}, {"latency_budget_ms": -1},
                   {"model_watch_interval": 0},
                   {"serving_traversal": "tree"},
                   {"drift_window_rows": 0}):
        with pytest.raises(RuntimeError) as te:
            t_config(params)
        with pytest.raises(RuntimeError) as je:
            j_config(params)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("case", ["binary_xla", "binary_packed",
                                  "categorical", "multiclass"])
def test_memory_term_equals_engine_bytes(case, binary_text):
    text = {"binary_xla": binary_text, "binary_packed": binary_text,
            "categorical": None, "multiclass": None}[case]
    if case == "categorical":
        text = _categorical_text()
    elif case == "multiclass":
        text = _multiclass_text()
    tg = _port_gbdt(text)
    eng = t_inference.PredictEngine(
        tg.models, tg.num_class, buckets=(1, 8, 64, 512), device="cpu",
        traversal="packed" if case == "binary_packed" else "xla",
        prewarm=True)
    pred = eng.memory_prediction()
    have = sum(t.numel() * t.element_size() for t in eng.device_tensors())
    assert pred["peak_bytes"] == have
    assert pred["residents"]["serving_model"] == sum(
        t.numel() * t.element_size() for t in eng.bundle.tensors())
    assert eng.preflight()["verdict"] == "ok"
    with pytest.raises(RuntimeError, match="hbm_budget"):
        eng.preflight(hbm_budget=have - 1)


def test_binned_arrays_equal_jax(binary_text, test_rows):
    """The engine's binned rows (``[N, Fc]``: ranks, categories, NaN and
    zero masks) are the JAX engine's, for float32-exact rows and for
    float64 rows it bins on the host."""
    je, te = _engine_pair(binary_text, "xla")
    rng = np.random.RandomState(4)
    for X in (test_rows, test_rows + 1e-13 * rng.randn(*test_rows.shape)):
        for got, want in zip(te.binned_arrays(X), je.binned_arrays(X)):
            np.testing.assert_array_equal(got, want)


def test_attach_engine_serves_the_same_bits(binary_text, test_rows):
    tg = _port_gbdt(binary_text)
    p = lt.predictor.Predictor(tg.models, 1, tg.objective,
                               torch.device("cpu"))
    want = p.predict(test_rows)
    assert p.attach_engine() is p and p.engine.bundle is p.bundle
    assert (_bits(p.predict(test_rows)) == _bits(want)).all()
    np.testing.assert_array_equal(p.predict_leaf_index(test_rows),
                                  p.engine.leaves(test_rows).T)


def test_engine_cache_reuse_and_invalidation(binary_text, test_rows):
    bst = lt.Booster(params=dict(CPU), model_str=binary_text)
    gbdt = bst.inner
    eng = bst.predict_engine(prewarm=False)
    assert gbdt.predict_engine() is eng
    p = gbdt.predictor(torch.device("cpu"))
    assert p.engine is eng and p.bundle is eng.bundle
    np.testing.assert_array_equal(bst.predict(test_rows, pred_leaf=True),
                                  eng.leaves(test_rows).T)
    gbdt._drop_serving_caches()
    assert gbdt.predict_engine(build=False) is None
    assert gbdt.predict_engine() is not eng


def test_engine_cache_keys_device_ladder_and_traversal(binary_text):
    """The cached engine is one per (model state, device, ladder,
    traversal): asking for another ladder or traversal builds another
    engine, and asking again for the first gives a fresh one of it."""
    bst = lt.Booster(params=dict(CPU), model_str=binary_text)
    gbdt = bst.inner
    eng = gbdt.predict_engine()
    small = gbdt.predict_engine(buckets=(1, 8))
    assert small is not eng and small.buckets == (1, 8)
    assert gbdt.predict_engine(buckets=(1, 8)) is small
    xla = gbdt.predict_engine(buckets=(1, 8), traversal="xla")
    assert xla is not small and xla.traversal == "xla"
    assert gbdt.predict_engine(build=False) is None   # the default's gone
    assert gbdt.predict_engine().buckets == t_inference.DEFAULT_BUCKETS


def test_server_engine_is_its_own(binary_text, test_rows):
    """A server on a booster whose engine is cached builds its own engine
    with its own ladder: the booster's later predicts fold nothing into
    the server's drift windows."""
    rng = np.random.RandomState(8)
    text = binary_text + "\n" + t_quality.format_distribution(
        _distribution(rng.randn(500, 6)))
    bst = lt.Booster(params=dict(CPU), model_str=text)
    cached = bst.predict_engine(prewarm=False)
    srv = t_serving.ModelServer(booster=bst, params=dict(
        CPU, serving_buckets="1,8", drift_window_rows=1000),
        prewarm=True, autostart=False)
    try:
        assert srv._engine is not cached and srv._engine.buckets == (1, 8)
        assert cached.drift is None and srv._drift is not None
        bst.predict(test_rows)
        bst.predict(test_rows[:5])
        assert srv._drift.rows_total == 0
        srv.start()
        srv.predict(test_rows[:5])
        assert srv._drift.rows_total == 5
    finally:
        stats = srv.stop()
    assert stats["dispatch_allocs"] == 0


def test_ladder_replay_allocates_nothing(binary_text, test_rows):
    """A mixed-size replay over a prewarmed ladder allocates no buffer set
    and moves no gauge; every microbatch is tagged with a bucket of the
    ladder, and inputs past the largest bucket run as row passes."""
    tg = _port_gbdt(binary_text)
    eng = t_inference.PredictEngine(tg.models, 1, buckets=BUCKETS,
                                    prewarm=True, device="cpu")
    warmed = t_inference.jit_entries()
    t_counters.reset()
    rng = np.random.RandomState(5)
    for n in (1, 2, 3, 7, 8, 9, 40, 64, 65, 130, 64, 1):
        eng.raw_scores(test_rows[rng.randint(0, 137, n)])
    assert t_inference.jit_entries() == warmed
    assert eng.dispatch_allocs == 0
    tags = [dict(kv.split("=", 1) for kv in k.split(","))
            for k in t_counters.get("predict_dispatch")]
    assert {int(t["bucket"]) for t in tags if t["path"] == "raw"} <= set(
        BUCKETS)
    assert {int(t["bucket"]) for t in tags if t["path"] == "pass"} == {
        65, 130}
    assert t_counters.snapshot()["gauges"]["predict_jit_entries"] == warmed


def test_early_stop_via_engine_bitwise_jax(binary_text, test_rows):
    kw = dict(early_stop=True, early_stop_freq=2, early_stop_margin=0.5)
    jg = JGBDT.load_from_string(binary_text)
    want = JPredictor(jg.models, 1, **kw).predict_raw_trees(test_rows)
    tg = _port_gbdt(binary_text)
    for traversal in ("xla", "packed"):
        eng = t_inference.PredictEngine(tg.models, 1, traversal=traversal,
                                        device="cpu")
        p = lt.predictor.Predictor(tg.models, 1, None, torch.device("cpu"),
                                   engine=eng, **kw)
        assert (_bits(p.predict_raw(test_rows)) == _bits(want)).all()


@pytest.mark.parametrize("which", ["binary", "multiclass", "categorical"])
def test_native_backend_names_its_queue_item(binary_text, test_rows, which):
    """The host library's item is done: ``backend="native"`` serves raw
    margins from the host predictor bit for bit the kernels' (plain
    versions on the CPU) and the JAX engine's, prefixes of the trees
    included, and its leaf indices from the kernels; it needs the model
    text, and ``auto`` never takes it."""
    text, rows = {
        "binary": (binary_text, test_rows),
        "multiclass": (_multiclass_text(), np.random.RandomState(3).randn(
            90, 8)),
        "categorical": (_categorical_text(), _categorical_rows())}[which]
    tg = _port_gbdt(text)
    k = tg.num_class
    nat = t_inference.PredictEngine(tg.models, k, backend="native",
                                    model_str=text, device="cpu")
    assert nat.backend == "native"
    xla = t_inference.PredictEngine(tg.models, k, device="cpu")
    assert xla.backend == "xla"
    jg = JGBDT.load_from_string(text)
    want = j_inference.PredictEngine(jg.models, k, buckets=BUCKETS,
                                     backend="xla").raw_scores(rows)
    for trees in (-1, k):
        got = nat.raw_scores(rows, num_trees=trees)
        assert (_bits(got) == _bits(xla.raw_scores(rows,
                                                    num_trees=trees))).all()
    assert (_bits(nat.raw_scores(rows)) == _bits(want)).all()
    np.testing.assert_array_equal(nat.leaves(rows), xla.leaves(rows))
    with pytest.raises(ValueError, match="model_str"):
        t_inference.PredictEngine(tg.models, k, backend="native",
                                  device="cpu")


# ---- the server -------------------------------------------------------------


def test_model_server_coalesces_and_matches(binary_text, test_rows):
    bst = lt.Booster(params=dict(CPU), model_str=binary_text)
    srv = t_serving.ModelServer(
        booster=bst, params=dict(CPU, latency_budget_ms=20.0),
        prewarm=False, autostart=False)
    futs = [srv.submit(test_rows[i:i + 7]) for i in range(0, 133, 7)]
    raw_fut = srv.submit(test_rows[:5], raw_score=True)
    srv.start()
    got = np.concatenate([f.result(timeout=120) for f in futs])
    want = bst.predict(test_rows[:133])
    assert (_bits(got) == _bits(want)).all()
    assert (_bits(raw_fut.result(timeout=120))
            == _bits(bst.predict(test_rows[:5], raw_score=True))).all()
    # and the JAX package's raw scores for the same model text (its
    # transform on the CPU runs in its native library's C++)
    jb = lj.Booster(model_str=binary_text)
    assert (_bits(raw_fut.result(timeout=120))
            == _bits(jb.predict(test_rows[:5], raw_score=True))).all()
    stats = srv.stop()
    assert stats["requests"] == len(futs) + 1
    assert stats["batches"] < stats["requests"]          # coalesced
    assert stats["buckets"] and all(
        "p50_ms" in b and "p99_ms" in b and "hist" in b
        for b in stats["buckets"].values())


def _port_publish(prefix, rounds, X, y):
    p = dict(CPU, objective="binary", num_leaves=15, min_data_in_leaf=5,
             output_model=prefix, snapshot_freq=5, snapshot_resume=True)
    return lt.train(p, lt.Dataset(X, np.asarray(y, np.float32), params=p),
                    rounds)


def test_hot_swap_mid_stream_from_port_snapshots(tmp_path):
    """A port trainer publishing through the commit point is picked up by
    a live server: no failed request, every answer one committed model's
    (the old one's never after the new one's), and no buffer set
    allocated by a dispatch: each model's sets come at its prewarm, before
    its swap."""
    rng = np.random.RandomState(0)
    X = rng.randn(500, 6)
    y = X.sum(axis=1) > 0
    prefix = str(tmp_path / "model.txt")
    bst_a = _port_publish(prefix, 5, X, y)
    Xt = rng.randn(40, 6).astype(np.float32).astype(np.float64)
    srv = t_serving.ModelServer(params=dict(
        CPU, model_watch=prefix, model_watch_interval=0.02,
        latency_budget_ms=0.5), prewarm=True)
    try:
        assert srv.loaded_iteration == 5
        old = np.asarray(srv.predict(Xt))
        assert (_bits(old) == _bits(bst_a.predict(Xt))).all()
        futures, stop = [], threading.Event()

        def stream():
            while not stop.is_set():
                futures.append(srv.submit(Xt))
                time.sleep(0.002)

        t = threading.Thread(target=stream)
        t.start()
        try:
            bst_b = _port_publish(prefix, 10, X, y)
            deadline = time.time() + 60
            while srv.loaded_iteration != 10 and time.time() < deadline:
                time.sleep(0.02)
        finally:
            stop.set()
            t.join(timeout=60)
        assert not t.is_alive()
        assert srv.loaded_iteration == 10
        new = np.asarray(srv.predict(Xt))
        assert (_bits(new) == _bits(bst_b.predict(Xt))).all()
        assert not np.array_equal(old, new)
        saw_new = False
        for f in futures:
            out = np.asarray(f.result(timeout=120))   # no failed request
            if np.array_equal(out, new):
                saw_new = True
                continue
            np.testing.assert_array_equal(out, old)
            assert not saw_new, "an old-model answer after a new-model one"
        stats = srv.stop()
        assert stats["dispatch_allocs"] == 0
        assert stats["swaps"] >= 1
        assert any(e.get("event") == "model_swap"
                   for e in t_counters.events())
    finally:
        srv._running = False


def test_swap_from_jax_written_snapshots(tmp_path):
    """JAX-written plain snapshots, then a JAX-written shard set, served by
    the port's watcher: each answer equals the port's prediction of that
    model text and the JAX package's, bit for bit."""
    rng = np.random.RandomState(1)
    X = rng.randn(400, 6)
    y = (X[:, 0] - X[:, 2] > 0).astype(np.float32)
    prefix = str(tmp_path / "jm.txt")
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "min_data_in_leaf": 5, "output_model": prefix, "snapshot_freq": 3}
    jb = lj.train(p, lj.Dataset(X, y, params={"verbose": -1}), 3,
                  verbose_eval=False)
    Xt = rng.randn(25, 6)
    srv = t_serving.ModelServer(params=dict(CPU, model_watch=prefix),
                                prewarm=False, autostart=False)
    try:
        assert srv.loaded_iteration == 3
        srv.start()
        got = srv.predict(Xt, raw_score=True)
        assert (_bits(got) == _bits(jb.predict(Xt, raw_score=True))).all()
        # a shard set (manifest + rank 0's shard) committed at 6
        jb6 = lj.train(dict(p, snapshot_freq=-1),
                       lj.Dataset(X, y, params={"verbose": -1}), 6,
                       verbose_eval=False)
        j_checkpoint.write_group_snapshot(
            prefix, 6, jb6.model_to_string(), {"version": 1, "iteration": 6},
            rank=0, world=1, fingerprint=0, gather=lambda obj: [obj])
        assert srv._poll_model_watch(prewarm=False)
        assert srv.loaded_iteration == 6
        got6 = srv.predict(Xt, raw_score=True)
        assert (_bits(got6) == _bits(jb6.predict(Xt, raw_score=True))).all()
        port6 = lt.Booster(params=dict(CPU), model_str=jb6.model_to_string())
        assert (_bits(srv.predict(Xt)) == _bits(port6.predict(Xt))).all()
    finally:
        srv.stop()


def test_torn_commit_is_invisible(tmp_path, binary_text):
    prefix = str(tmp_path / "torn.txt")
    with open(j_checkpoint.snapshot_path(prefix, 7), "wb") as f:
        f.write(b"tree\nnum_leaves=2\ngarbage")       # torn: no footer
    bst = lt.Booster(params=dict(CPU), model_str=binary_text)
    srv = t_serving.ModelServer(booster=bst,
                                params=dict(CPU, model_watch=prefix),
                                prewarm=False, autostart=False)
    assert not srv._poll_model_watch()
    assert srv.loaded_iteration is None               # the first model stays
    srv.stop()


# ---- drift ------------------------------------------------------------------


def _distribution(X):
    """A training distribution of every column: values rounded to 0.25
    and their counts (the model file's ``feature_distribution:`` form)."""
    out = {}
    for f in range(X.shape[1]):
        v, c = np.unique(np.round(X[:, f] * 4) / 4, return_counts=True)
        out[f] = [(float(a), int(b)) for a, b in zip(v, c)]
    return out


@pytest.mark.parametrize("a,b", [((5, 1, 0), (1, 5, 0)), ((0, 0), (1, 1)),
                                 ((3, 3, 3), (3, 3, 3))])
def test_psi_equals_jax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert t_quality.psi(a, b) == j_quality.psi(a, b)


def test_drift_windows_events_gauges_equal_jax(binary_text):
    """The same microbatches through both engines with a drift monitor
    attached: windows, ``feature_drift`` events, PSI and gauges equal."""
    rng = np.random.RandomState(12)
    train_x = rng.randn(2000, 6)
    dist = _distribution(train_x)
    jg = JGBDT.load_from_string(binary_text)
    je = j_inference.PredictEngine(jg.models, 1, backend="xla",
                                   buckets=BUCKETS, traversal="xla")
    jm = j_quality.DriftMonitor(je.bundle, dist, threshold=0.05,
                                window_rows=100)
    je.drift = jm
    tg = _port_gbdt(binary_text)
    te = t_inference.PredictEngine(tg.models, 1, buckets=BUCKETS,
                                   device="cpu")
    tm = t_quality.DriftMonitor(te.bundle, dist, threshold=0.05,
                                window_rows=100)
    te.drift = tm
    j_counters.reset()
    t_counters.reset()
    for i, n in enumerate((30, 50, 7, 100, 64, 200, 90)):
        x = rng.randn(n, 6).astype(np.float32).astype(np.float64)
        if i >= 3:
            x[:, 2] += 1.5                          # a shifted feature
        x[rng.rand(n, 6) < 0.05] = np.nan
        je.raw_scores(x)
        te.raw_scores(x)
    assert tm.windows == jm.windows >= 3
    np.testing.assert_array_equal(tm.last_psi, jm.last_psi)
    assert tm.events_fired == jm.events_fired > 0
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"}
                         for e in evs]
    assert strip(t_counters.events("feature_drift")) == strip(
        j_counters.events("feature_drift"))
    assert tm.samples() == jm.samples()
    assert tm.stats() == jm.stats()


def test_server_drift_from_model_text(binary_text):
    """A model text with a ``feature_distribution:`` section arms the
    server's drift monitor before its first batch; shifted rows fire
    ``feature_drift``, and the stats' drift block is the JAX server's."""
    rng = np.random.RandomState(2)
    dist = _distribution(rng.randn(2000, 6))
    text = binary_text + "\n" + t_quality.format_distribution(dist)
    params = dict(CPU, drift_threshold=0.1, drift_window_rows=64,
                  serving_buckets="1,8,64")
    srv = t_serving.ModelServer(model_str=text, params=params,
                                prewarm=False, autostart=False)
    jgbdt = JGBDT.load_from_string(text, j_config({"verbose": -1}))
    jgbdt.predict_engine(backend="xla", buckets=BUCKETS)
    jsrv = j_serving.ModelServer(
        booster=jgbdt, params={"verbose": -1, "drift_threshold": 0.1,
                               "drift_window_rows": 64,
                               "serving_buckets": "1,8,64"},
        prewarm=False, autostart=False)
    t_counters.reset()
    j_counters.reset()
    x = rng.randn(192, 6).astype(np.float32).astype(np.float64)
    x[:, 4] += 3.0
    for s in (srv, jsrv):
        s.start()
        for lo in range(0, 192, 64):
            s.predict(x[lo:lo + 64])
    assert srv.stats()["drift"] == jsrv.stats()["drift"]
    assert srv.stats()["drift"]["events_fired"] > 0
    assert [e["feature"] for e in t_counters.events("feature_drift")] == [
        e["feature"] for e in j_counters.events("feature_drift")]
    srv.stop()
    jsrv.stop()


# ---- the HTTP front, the command line, the report ---------------------------


@contextlib.contextmanager
def _http(run_http, server):
    from http.server import ThreadingHTTPServer
    box = {}
    orig = ThreadingHTTPServer.__init__

    def patched(self, addr, handler):
        orig(self, ("127.0.0.1", 0), handler)
        box["srv"] = self

    ThreadingHTTPServer.__init__ = patched
    try:
        t = threading.Thread(target=lambda: run_http(server, 0),
                             daemon=True)
        t.start()
        deadline = time.time() + 30
        while "srv" not in box and time.time() < deadline:
            time.sleep(0.01)
        ThreadingHTTPServer.__init__ = orig
        yield box["srv"].server_address[1]
    finally:
        ThreadingHTTPServer.__init__ = orig
        if "srv" in box:
            box["srv"].shutdown()
        t.join(timeout=30)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read().decode()


def _post(port, rows):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps({"data": rows.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["predictions"]


def _families(text):
    """``{family: {label names}}`` of a scrape's serving families."""
    out = {}
    for key in t_metrics.parse_prometheus(text):
        name, _, labels = key.partition("{")
        if not name.startswith(("lgbm_tpu_serving", "lgbm_tpu_predict",
                                "lgbm_tpu_feature_drift",
                                "lgbm_tpu_drift")):
            continue
        names = frozenset(kv.split("=")[0] for kv in
                          labels.rstrip("}").split(",") if kv)
        out.setdefault(name, set()).add(names)
    return out


def test_http_surface_and_metrics_families(binary_text, test_rows):
    """POST /predict, GET /stats, /healthz and /metrics on an ephemeral
    port; the scrape's serving families and label sets are the JAX
    server's for the same traffic."""
    rng = np.random.RandomState(3)
    text = binary_text + "\n" + t_quality.format_distribution(
        _distribution(rng.randn(500, 6)))
    gc.collect()
    t_counters.reset()
    j_counters.reset()
    srv = t_serving.ModelServer(model_str=text, params=dict(CPU),
                                prewarm=False)
    jgbdt = JGBDT.load_from_string(text, j_config({"verbose": -1}))
    jgbdt.predict_engine(backend="xla", buckets=(1, 8, 64, 512, 4096))
    jsrv = j_serving.ModelServer(booster=jgbdt, params={"verbose": -1},
                                 prewarm=False)
    scrapes = []
    try:
        for run_http, server in ((t_serving._run_http, srv),
                                 (j_serving._run_http, jsrv)):
            with _http(run_http, server) as port:
                out = _post(port, test_rows[:4])
                _post(port, test_rows[:9])
                assert json.loads(_get(port, "/healthz"))["ok"] is True
                assert json.loads(_get(port, "/stats"))["requests"] == 2
                scrapes.append(_get(port, "/metrics"))
                if server is srv:
                    want = lt.Booster(params=dict(CPU),
                                      model_str=text).predict(test_rows[:4])
                    assert (_bits(out) == _bits(want)).all()
    finally:
        srv.stop()
        jsrv.stop()
    port_fams, jax_fams = (_families(s) for s in scrapes)
    assert port_fams == jax_fams
    assert "lgbm_tpu_serving_latency_ms_bucket" in port_fams
    assert "lgbm_tpu_predict_dispatch_total" in port_fams


def test_main_replay(tmp_path, binary_text, capsys):
    path = tmp_path / "m.txt"
    path.write_text(binary_text)
    rc = t_serving.main(["--model", str(path), "--replay", "12",
                         "--features", "6", "--buckets", "1,8,64",
                         "--device", "cpu"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["requests"] == 12 and stats["rows"] > 0
    assert stats["predict_jit_entries"] >= 3


def test_report_serving_section(binary_text, test_rows, tmp_path):
    """The serving stats summary, the dispatch counters and the buffer-set
    gauge render in the port's report."""
    trace = str(tmp_path / "serving.json")
    t_counters.reset()
    t_trace.start(trace)
    try:
        bst = lt.Booster(params=dict(CPU), model_str=binary_text)
        srv = t_serving.ModelServer(booster=bst, params=dict(CPU),
                                    prewarm=False, autostart=False)
        futs = [srv.submit(test_rows[:9]) for _ in range(4)]
        srv.start()
        for f in futs:
            f.result(timeout=120)
        srv.stop()
    finally:
        t_trace.stop()
    md = t_render(trace)
    assert "## Serving / predict" in md
    assert "predict_jit_entries" in md
    assert "p50 ms" in md
    assert "predict_traverse" in md
