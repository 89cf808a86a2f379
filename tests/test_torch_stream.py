"""Streamed out-of-core training (``data_stream=chunked``) in the port
against lightgbm_tpu on the same seeded data, on the CPU.

* The grower: ``StreamedGrower`` over the port's ``BlockStreamer`` against
  lightgbm_tpu's ``StreamedGrower`` over its own, at 1, 2 and 5 row
  blocks (the last one short), on numerical, categorical, EFB-bundled and
  uint16 (``max_bin=1023``) bins, under integer-valued gradients whose
  sums are exact in any order: every ``TreeArrays`` field and the row ->
  leaf map identical, and identical to the port's resident serial tree.
* ``train`` with ``data_stream=chunked, stream_chunk_rows=1500`` against
  ``lightgbm_tpu.train`` with the same settings: the model text identical
  under a custom integer-gradient objective (at the defaults, with bagging
  by weights and ``feature_fraction``, RF, a valid set, ``init_model=``
  and ``nonfinite_policy=rollback`` tripped once); under binary,
  multiclass (3 classes) and lambdarank, predictions within 1e-4 of the
  JAX package's streamed run and of the port's resident one (the JAX
  package holds its streamed run to its resident one at 1e-4,
  tests/test_streaming.py:303).  A rollback past the stashed iteration
  re-scores the training rows block by block.
* Downgrades and refusals: packing and ``ordered_bins=on`` give the JAX
  package's downgrade records; ``dart``/``goss`` with ``chunked``,
  ``stream_chunk_rows=-1`` and ``data_stream=bogus`` raise as it does;
  ``tree_learner=data`` over a 2x4 mesh of CPU slots does not read
  ``data_stream``.
* ``route_rows``' plain version on a row-major block (the transpose the
  streamed grower passes) equals it on the column-major copy, bit for
  bit, for uint8 and uint16 bins and a bundled column.
* The matrix stays on the host: after a streamed ``train`` no tensor of
  the booster has the matrix's rows x columns, and the streamer counts
  every block of every pass.
The CUDA side (the pipeline's streams, the row-major route kernel) is
held against these plain versions on the card by ``chip_smoke.py``
(phases 2j and 20)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.data.stream import BlockStreamer as JaxStreamer
from lightgbm_tpu.data.stream import HostBlockStore as JaxStore
from lightgbm_tpu.grower import FeatureMeta as JaxMeta
from lightgbm_tpu.grower import GrowerConfig as JaxGrowerConfig
from lightgbm_tpu.grower import StreamedGrower as JaxStreamedGrower
from lightgbm_tpu.obs.counters import counters as jax_counters
from lightgbm_tpu.parallel.mesh import default_chunk_rows as jax_chunk_rows
from lightgbm_tpu_torch.data.stream import (BlockStreamer, HostBlockStore,
                                            pin_matrix)
from lightgbm_tpu_torch.grower import (FeatureMeta, GrowerConfig,
                                       StreamedGrower, grow_tree)
from lightgbm_tpu_torch.ops.histogram import movable
from lightgbm_tpu_torch.ops.route import (_ROWS_ARGS, route_rows,
                                          route_rows_plain)
from lightgbm_tpu_torch.parallel.mesh import default_chunk_rows

BASE = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
            verbose=-1)
STREAM = dict(data_stream="chunked", stream_chunk_rows=1500)
t = torch.from_numpy


def _int_fobj(seed):
    """Integer-valued gradients and hessians, the same sequence in both
    packages: exact sums in any order."""
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(seed + calls[0])
        calls[0] += 1
        return (rng.integers(-3, 4, len(preds)).astype(np.float64),
                rng.integers(1, 4, len(preds)).astype(np.float64))
    return fobj


# ---- the data of the grower cases ----------------------------------------

N_GROW = 4600         # 1,000-row blocks: 5, the last of 600 rows


def _numeric(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6))
    x[rng.random((n, 6)) < 0.1] = np.nan
    x[:, 5] = np.where(rng.random(n) < 0.3, 0.0, x[:, 5])
    return x, None


def _categorical(n, seed):
    rng = np.random.default_rng(seed)
    x = np.column_stack([rng.integers(0, 40, n), rng.integers(0, 7, n),
                         rng.standard_normal((n, 3))]).astype(np.float64)
    return x, [0, 1]


def _bundled(n, seed):
    """4 numeric columns and a 4-way and a 12-way one-hot block, which
    EFB bundles."""
    rng = np.random.default_rng(seed)
    blocks = []
    for width in (4, 12):
        blk = np.zeros((n, width))
        blk[np.arange(n), rng.integers(0, width, n)] = 1.0
        blocks.append(blk)
    return np.column_stack([rng.standard_normal((n, 4))] + blocks), None


def _wide(n, seed):
    """Continuous columns and a 600-valued integer one at max_bin=1023:
    a uint16 matrix."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4))
    x[:, 3] = rng.integers(0, 600, n)
    return x, None


GROW_CASES = {"numerical": (_numeric, {}),
              "categorical": (_categorical, {}),
              "bundled": (_bundled, {}),
              "uint16": (_wide, {"max_bin": 1023})}


def _grow_problem(case):
    """The binned matrix, both packages' metas and grower configs, and
    integer-valued gradients of one case."""
    make, extra = GROW_CASES[case]
    x, cat = make(N_GROW, seed=3)
    p = dict(verbose=-1, device="cpu", min_data_in_bin=1, **extra)
    td = lt.Dataset(x, np.zeros(N_GROW), params=p,
                    categorical_feature=cat or "auto").construct(
                        on_device=False).constructed
    fm = td.feature_meta()
    if case == "bundled":
        assert td.bundled
    if case == "uint16":
        assert td.binned.dtype == np.uint16
    kw = dict(num_leaves=31, min_data_in_leaf=5, min_sum_hessian_in_leaf=1.0,
              lambda_l2=1.0, max_bin=td.max_num_bin(),
              has_categorical=bool(fm["is_categorical"].any()),
              max_cat_threshold=24, max_cat_group=16, cat_smooth_ratio=0.02,
              min_cat_smooth=2.0)
    rng = np.random.default_rng(5)
    bins = td.binned
    g = (rng.integers(-4, 5, N_GROW)
         - 3 * (bins[:, 0].astype(np.int64) % 5 == 0)).astype(np.float32)
    h = rng.integers(1, 4, N_GROW).astype(np.float32)
    c = np.ones(N_GROW, np.float32)
    keys = ("num_bin", "missing_type", "default_bin", "is_categorical",
            "col", "offset")
    meta = FeatureMeta(*(t(fm[k]) if k in fm else None for k in keys))
    jmeta = JaxMeta(*(jnp.asarray(fm[k]) if k in fm else None
                      for k in keys))
    return bins, (g, h, c), meta, jmeta, kw


@pytest.fixture(scope="module")
def grow_problems():
    return {case: _grow_problem(case) for case in GROW_CASES}


def _host_tree(tree, row_leaf):
    return ({f: np.asarray(v) for f, v in tree._asdict().items()
             if f != "num_leaves"}, int(tree.num_leaves),
            np.asarray(row_leaf))


def _same_tree(a, b, what):
    assert a[1] == b[1], what
    for f in a[0]:
        np.testing.assert_array_equal(a[0][f], b[0][f], err_msg=f"{what} {f}")
    np.testing.assert_array_equal(a[2], b[2], err_msg=f"{what} row_leaf")


@pytest.mark.parametrize("case", list(GROW_CASES))
def test_streamed_tree_identical_to_jax_and_resident(grow_problems, case):
    bins, (g, h, c), meta, jmeta, kw = grow_problems[case]
    fv = np.ones(meta.num_bin.numel(), bool)
    resident = _host_tree(*grow_tree(t(bins), t(g), t(h), t(c), meta, t(fv),
                                     GrowerConfig(**kw), loop="eager"))
    assert resident[1] > 10
    jax_grow = JaxStreamedGrower(JaxGrowerConfig(hist_method="segment",
                                                 **kw))
    for chunk, blocks in ((N_GROW, 1), (N_GROW // 2, 2), (1000, 5)):
        store = HostBlockStore(bins, chunk)
        assert store.num_blocks == blocks
        assert store.block_rows()[-1] == N_GROW - (blocks - 1) * chunk
        stats = {}
        grower = StreamedGrower(GrowerConfig(**kw),
                                BlockStreamer(store, "cpu"),
                                n_logical=meta.num_bin.numel())
        got = _host_tree(*grower(t(g), t(h), t(c), meta, t(fv), stats))
        jt, jrl = jax_grow(JaxStreamer(JaxStore(bins, chunk)),
                           jnp.asarray(g), jnp.asarray(h), jnp.asarray(c),
                           jmeta, jnp.asarray(fv))
        want = _host_tree(jax.tree_util.tree_map(np.asarray, jt), jrl)
        _same_tree(got, want, f"{case} chunk={chunk} vs jax")
        _same_tree(got, resident, f"{case} chunk={chunk} vs resident")
        splits = got[1] - 1
        # one pass a split and the root's, every block in each; one host
        # read a split, and one for the stop before L - 1 splits
        assert stats["splits"] == splits
        assert stats["stream_passes"] == splits + 1
        assert stats["stream_blocks"] == (splits + 1) * blocks
        assert stats["stream_bytes"] == (splits + 1) * bins.nbytes
        assert stats["host_syncs"] == splits + (splits < kw["num_leaves"]
                                                - 1)


def test_a_second_tree_reuses_the_state(grow_problems):
    """The grower's state lives across trees: a second tree from the same
    weights is the first."""
    bins, (g, h, c), meta, _, kw = grow_problems["categorical"]
    fv = t(np.ones(meta.num_bin.numel(), bool))
    grower = StreamedGrower(GrowerConfig(**kw),
                            BlockStreamer(HostBlockStore(bins, 1000), "cpu"),
                            n_logical=meta.num_bin.numel())
    first = _host_tree(*grower(t(g), t(h), t(c), meta, fv))
    grower(t(-g), t(h), t(c), meta, fv)
    _same_tree(_host_tree(*grower(t(g), t(h), t(c), meta, fv)), first,
               "second tree")


def test_cpu_streamer_hands_out_host_slices():
    bins = np.arange(70, dtype=np.uint16).reshape(35, 2) * 1000
    s = BlockStreamer(HostBlockStore(bins, 10), "cpu")
    got = [(k, lo, hi, b) for k, lo, hi, b in s.blocks()]
    assert [(k, lo, hi) for k, lo, hi, _ in got] == [
        (0, 0, 10), (1, 10, 20), (2, 20, 30), (3, 30, 35)]
    for _, lo, hi, b in got:
        assert b.dtype == torch.uint16
        np.testing.assert_array_equal(b.view(torch.int16).numpy().view(
            np.uint16), bins[lo:hi])
    assert (s.passes, s.blocks_streamed, s.bytes_streamed) == (
        1, 4, bins.nbytes)


def test_pinning_needs_a_card():
    """``pin_matrix`` page-locks through the CUDA runtime: without a card
    it raises, and nothing falls back to pageable memory."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the card's side runs in "
                    "chip_smoke.py")
    with pytest.raises(RuntimeError):
        pin_matrix(np.zeros((4, 2), np.uint8))


@pytest.mark.parametrize("rows,requested", [(1, 0), (1000, 0), (1001, 0),
                                            (600_000, 0), (10**7, 0),
                                            (5000, 1500), (5000, 9000)])
def test_default_chunk_rows_is_the_jax_rule(rows, requested):
    assert default_chunk_rows(rows, requested) == jax_chunk_rows(rows,
                                                                requested)


# ---- route_rows on a row-major block ---------------------------------------

def _route_case(dtype, bundled):
    rng = np.random.default_rng(11)
    n, f, L = 3000, 5, 7
    hi = 1000 if dtype == np.uint16 else 250
    block = rng.integers(0, hi, (n, f)).astype(dtype)
    nb = np.asarray([hi] * f, np.int32)
    meta = [nb, np.asarray([2, 1, 0, 0, 2], np.int32),
            np.asarray([3, 0, 0, 5, 0], np.int32), None, None, None]
    if bundled:     # features 0-2 share column 0's slots, 3-4 alone
        block[:, 0] = rng.integers(0, 40, n)
        meta = [np.asarray([12, 15, 11, hi, hi], np.int32),
                np.asarray([0, 1, 0, 0, 2], np.int32),
                np.asarray([0, 0, 4, 5, 0], np.int32), None,
                np.asarray([0, 0, 0, 3, 4], np.int32),
                np.asarray([1, 12, 27, -1, -1], np.int32)]
    meta = FeatureMeta(*(None if m is None else t(m) for m in meta))
    split = torch.tensor([[0, 7, 1], [1, 3, 0], [2, 2, 1], [3, hi // 2, 0],
                          [4, hi - 1, 1], [0, 0, 0], [0, 0, 0], [0, 0, 0]],
                         dtype=torch.int32)
    cat = torch.zeros(L + 1, dtype=torch.bool)
    catb = torch.zeros((L + 1, hi), dtype=torch.bool)
    cat[4] = True
    catb[4, ::3] = True
    row_leaf = t(rng.integers(0, 6, n).astype(np.int32))
    return t(block), meta, split, cat, catb, row_leaf, L


@pytest.mark.parametrize("dtype,bundled", [(np.uint8, False),
                                           (np.uint16, False),
                                           (np.uint8, True)],
                         ids=["uint8", "uint16", "bundled"])
def test_route_rows_row_major_equals_column_major(dtype, bundled):
    block, meta, split, cat, catb, row_leaf, L = _route_case(dtype, bundled)
    shards = 3
    for leaf in range(6):
        new = torch.tensor([6])
        lt_ = torch.tensor([leaf])
        out = []
        for bins_t in (block.t(),
                       movable(block).t().contiguous().view(block.dtype)):
            rl = row_leaf.clone()
            counts = torch.stack([torch.bincount(
                rl.view(shards, -1)[s].long(), minlength=L + 1).int()
                for s in range(shards)])
            route_rows(rl, bins_t, lt_, new, split, cat, catb, meta, counts)
            out.append((rl, counts))
        assert not block.t().is_contiguous()
        assert torch.equal(out[0][0], out[1][0]), leaf
        assert torch.equal(out[0][1], out[1][1]), leaf
        want = torch.stack([torch.bincount(out[0][0].view(shards, -1)[s]
                                           .long(), minlength=L + 1).int()
                            for s in range(shards)])
        assert torch.equal(out[0][1], want)
    # the plain version is what the wrapper runs on CPU tensors
    rl_a, rl_b = row_leaf.clone(), row_leaf.clone()
    ca = torch.zeros((1, L + 1), dtype=torch.int32)
    cb = ca.clone()
    route_rows(rl_a, block.t(), torch.tensor([2]), torch.tensor([6]), split,
               cat, catb, meta, ca)
    route_rows_plain(rl_b, block.t(), torch.tensor([2]), torch.tensor([6]),
                     split, cat, catb, meta, cb)
    assert torch.equal(rl_a, rl_b) and torch.equal(ca, cb)


def test_route_rows_argument_block_carries_both_strides():
    # 13 pointers, the shard's rows and two strides, 8 ints, the stream
    assert _ROWS_ARGS.size == 13 * 8 + 3 * 8 + 8 * 4 + 8


# ---- train end to end ------------------------------------------------------

def _binary(n=5000, seed=7, f=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f))
    y = (x[:, 0] + 0.5 * x[:, 1] ** 2 + 0.3 * rng.standard_normal(n)
         > 0.4).astype(np.float32)
    return x, y


def _train_both(params, rounds, x, y, fobj_seed, cat="auto"):
    tp = dict(params, device="cpu")
    dj = lj.Dataset(x, y, params=params, categorical_feature=cat)
    dt = lt.Dataset(x, y, params=tp, categorical_feature=cat)
    bj = lj.train(params, dj, rounds, fobj=_int_fobj(fobj_seed),
                  verbose_eval=False)
    bt = lt.train(tp, dt, rounds, fobj=_int_fobj(fobj_seed),
                  verbose_eval=False)
    return bt, bj, dt


EXTRAS = {
    "defaults": {},
    "bagging_feature_fraction": dict(bagging_fraction=0.5, bagging_freq=1,
                                     feature_fraction=0.6),
    "rf": dict(boosting_type="rf", bagging_fraction=0.5, bagging_freq=1,
               feature_fraction=0.8),
    "categorical_uint16": dict(max_bin=1023),
}


@pytest.mark.parametrize("extra", list(EXTRAS))
def test_model_text_equals_jax_under_integer_gradients(extra):
    x, y = _binary()
    x[:, 9] = np.random.default_rng(1).integers(0, 300, len(y))
    p = dict(BASE, **STREAM, **EXTRAS[extra])
    cat = [9] if extra == "categorical_uint16" else "auto"
    bt, bj, dt = _train_both(p, 4, x, y, 1, cat)
    assert bt.inner._streamed is not None and dt.bins is None
    assert bt.model_to_string() == bj.model_to_string()
    if cat != "auto":
        assert dt.constructed.binned.dtype == np.uint16
        assert sum(m.num_cat for m in bt.inner.models) > 0
    if extra == "bagging_feature_fraction":
        # under streaming bagging keeps the weight-mask form
        assert bt.inner._subset is None and bt.inner._bag_weight is not None


@pytest.mark.parametrize("objective", ["binary", "multiclass", "lambdarank"])
def test_predictions_near_jax_and_resident(objective):
    rng = np.random.default_rng(3)
    n = 4500
    x = rng.standard_normal((n, 8))
    z = x @ np.linspace(1.2, 0.2, 8) + 0.5 * rng.standard_normal(n)
    kw, p = {}, dict(BASE, objective=objective, **STREAM)
    if objective == "binary":
        y = (z > 0).astype(np.float32)
    elif objective == "multiclass":
        y = np.digitize(z, [-1.0, 1.0]).astype(np.float32)
        p["num_class"] = 3
    else:
        y = np.clip(np.round(z / 1.5 + 1.0), 0, 4).astype(np.float32)
        kw["group"] = [30] * (n // 30)
    tp = dict(p, device="cpu")
    bj = lj.train(p, lj.Dataset(x, y, params=p, **kw), 6,
                  verbose_eval=False)
    bt = lt.train(tp, lt.Dataset(x, y, params=tp, **kw), 6,
                  verbose_eval=False)
    rp = dict(tp, data_stream="resident")
    br = lt.train(rp, lt.Dataset(x, y, params=rp, **kw), 6,
                  verbose_eval=False)
    assert bt.inner._streamed is not None and br.inner._streamed is None
    pt = bt.predict(x[:600], raw_score=True)
    np.testing.assert_allclose(pt, bj.predict(x[:600], raw_score=True),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(pt, br.predict(x[:600], raw_score=True),
                               rtol=0, atol=1e-4)


def test_valid_set_stays_resident_and_scores_as_jax():
    x, y = _binary(n=6000)
    p = dict(BASE, **STREAM)
    tp = dict(p, device="cpu")
    dt = lt.Dataset(x[:4500], y[:4500], params=tp)
    vt = dt.create_valid(x[4500:], y[4500:])
    ev_t, ev_j = {}, {}
    bt = lt.train(tp, dt, 4, valid_sets=[vt], fobj=_int_fobj(2),
                  evals_result=ev_t, verbose_eval=False)
    dj = lj.Dataset(x[:4500], y[:4500], params=p)
    vj = dj.create_valid(x[4500:], y[4500:])
    bj = lj.train(p, dj, 4, valid_sets=[vj], fobj=_int_fobj(2),
                  evals_result=ev_j, verbose_eval=False)
    assert dt.bins is None and vt.bins is not None
    assert bt.model_to_string() == bj.model_to_string()
    np.testing.assert_allclose(bt.inner.valid_sets[0].scores[0].numpy(),
                               bt.predict(x[4500:], raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ev_t["valid_0"]["binary_logloss"],
                               ev_j["valid_0"]["binary_logloss"], rtol=0,
                               atol=1e-5)


def test_init_model_continues_as_jax():
    x, y = _binary(seed=8)
    p = dict(BASE, **STREAM)
    tp = dict(p, device="cpu")
    prev_t = lt.train(dict(BASE, device="cpu"),
                      lt.Dataset(x, y, params=dict(BASE, device="cpu")), 2,
                      fobj=_int_fobj(3), verbose_eval=False)
    prev_j = lj.train(BASE, lj.Dataset(x, y, params=BASE), 2,
                      fobj=_int_fobj(3), verbose_eval=False)
    assert prev_t.model_to_string() == prev_j.model_to_string()
    bt = lt.train(tp, lt.Dataset(x, y, params=tp), 3, init_model=prev_t,
                  fobj=_int_fobj(4), verbose_eval=False)
    bj = lj.train(p, lj.Dataset(x, y, params=p), 3, init_model=prev_j,
                  fobj=_int_fobj(4), verbose_eval=False)
    assert bt.inner._streamed is not None
    assert bt.model_to_string() == bj.model_to_string()


def _transient_fobj():
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(40 + calls[0])
        calls[0] += 1
        g = rng.integers(-3, 4, len(preds)).astype(np.float64)
        h = rng.integers(1, 3, len(preds)).astype(np.float64)
        if calls[0] == 3:
            g[5] = np.nan
        return g, h
    return fobj


def test_nonfinite_rollback_tripped_once_as_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3000, 3))
    y = x[:, 0] + 0.1 * rng.standard_normal(3000)
    p = dict(objective="regression", num_leaves=15, verbose=-1,
             nonfinite_policy="rollback", **STREAM)
    tp = dict(p, device="cpu")
    bt = lt.train(tp, lt.Dataset(x, y, params=tp), 5, fobj=_transient_fobj(),
                  verbose_eval=False)
    jp = dict(p, pipeline_trees=False)
    bj = lj.train(jp, lj.Dataset(x, y, params=jp), 5,
                  fobj=_transient_fobj(), verbose_eval=False)
    assert bt.inner.stats["nonfinite_trips"] == 1
    assert bt.model_to_string() == bj.model_to_string()


def test_rollback_past_the_stash_rescores_block_by_block():
    """Two rollbacks: the first restores the stashed scores, the second
    subtracts the trees' outputs, computed over the streamed blocks; the
    scores equal the resident run's after the same rollbacks."""
    x, y = _binary(seed=9)
    out = []
    for stream in ("chunked", "resident"):
        p = dict(BASE, objective="multiclass", num_class=3, device="cpu",
                 data_stream=stream, stream_chunk_rows=1500)
        y3 = np.digitize(x[:, 0] + x[:, 1], [-0.7, 0.7]).astype(np.float32)
        b = lt.train(p, lt.Dataset(x, y3, params=p), 4, verbose_eval=False)
        before = b.inner._streamer.blocks_streamed if stream == "chunked" \
            else 0
        b.rollback_one_iter()
        b.rollback_one_iter()
        if stream == "chunked":    # one pass over the blocks a class tree
            store = b.inner._streamer.store
            assert (b.inner._streamer.blocks_streamed - before
                    == 3 * store.num_blocks)
        out.append((b.inner.scores.numpy(), b.current_iteration()))
    assert out[0][1] == out[1][1] == 2
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=0, atol=1e-5)


def test_the_matrix_stays_on_the_host():
    x, y = _binary(n=4700, f=6)
    p = dict(BASE, device="cpu", **STREAM)
    ds = lt.Dataset(x, y, params=p)
    bst = lt.train(p, ds, 3, verbose_eval=False)
    inner = bst.inner
    n, f = ds.constructed.binned.shape
    assert ds.bins is None and inner.bins is None
    seen = []

    def walk(obj, depth=0):
        if depth > 3:
            return
        if isinstance(obj, torch.Tensor):
            seen.append(obj)
        elif isinstance(obj, (list, tuple)):
            for o in obj:
                walk(o, depth + 1)
        elif isinstance(obj, dict):
            for o in obj.values():
                walk(o, depth + 1)
        elif hasattr(obj, "__dict__") and type(obj).__module__.startswith(
                "lightgbm_tpu_torch"):
            for o in vars(obj).values():
                walk(o, depth + 1)
    walk(inner)
    assert len(seen) > 20
    # no bin tensor of the matrix's size; the blocks the streamer hands out
    # are views of the host matrix itself, no copy
    bins = [s for s in seen
            if s.dtype in (torch.uint8, torch.uint16, torch.int16)]
    assert not [s.shape for s in bins if s.numel() >= n * f]
    base = ds.constructed.binned.ctypes.data
    blocks = [b for _, _, _, b in inner._streamer.blocks()]
    assert sum(b.numel() for b in blocks) == n * f
    assert all(base <= b.data_ptr() < base + n * f for b in blocks)
    st, store = inner.stats, inner._streamer.store
    assert store.num_blocks == 4 and store.block_rows()[-1] == 200
    assert st["stream_passes"] == st["trees"] + st["splits"]
    assert st["stream_blocks"] == st["stream_passes"] * store.num_blocks
    assert st["stream_bytes"] == st["stream_passes"] * store.nbytes


# ---- downgrades and refusals ----------------------------------------------

def _jax_downgrades(params, x, y):
    jax_counters.reset()
    lj.train(params, lj.Dataset(x, y, params=params), 1, verbose_eval=False)
    return [{k: e[k] for k in ("requested", "resolved", "reason")}
            for e in jax_counters.events("layout_downgrade")
            if "chunked" in str(e) or "stream" in e["reason"]]


@pytest.mark.parametrize("extra", [
    dict(enable_bin_packing=True, enable_bundle=False),
    dict(ordered_bins="on", enable_bin_packing=False)],
    ids=["packing", "ordered_bins"])
def test_downgrades_are_the_jax_records(extra):
    x, y = _binary(f=6)
    x[:, :3] = np.round(x[:, :3] * 2)       # a few bins: they pack
    p = dict(BASE, min_data_in_bin=1, **STREAM, **extra)
    want = _jax_downgrades(p, x, y)
    assert len(want) == 1
    tp = dict(p, device="cpu")
    bst = lt.train(tp, lt.Dataset(x, y, params=tp), 1, verbose_eval=False)
    assert bst.inner.downgrades == want
    assert bst.inner.packed is None
    assert bst.inner.grower_cfg.ordered_bins == "off"


@pytest.mark.parametrize("extra", [
    dict(boosting_type="dart", data_stream="chunked"),
    dict(boosting_type="goss", data_stream="chunked"),
    dict(stream_chunk_rows=-1), dict(data_stream="bogus")],
    ids=["dart", "goss", "negative_chunk", "bogus"])
def test_refusals_raise_as_jax(extra):
    x, y = _binary(n=500)
    p = dict(BASE, **extra)
    with pytest.raises(RuntimeError) as ej:
        lj.train(p, lj.Dataset(x, y, params=p), 1, verbose_eval=False)
    tp = dict(p, device="cpu")
    with pytest.raises(RuntimeError) as et:
        lt.train(tp, lt.Dataset(x, y, params=tp), 1, verbose_eval=False)
    assert str(et.value) == str(ej.value)


def test_data_parallel_learner_does_not_read_data_stream():
    x, y = _binary()
    p = dict(BASE, device="cpu", tree_learner="data", mesh_shape="2x4",
             mesh_devices=8)
    models = []
    for stream in ({}, STREAM):
        q = dict(p, **stream)
        ds = lt.Dataset(x, y, params=q)
        b = lt.train(q, ds, 3, fobj=_int_fobj(6), verbose_eval=False)
        assert b.inner.parallel_impl == "gspmd" and b.inner._streamed is None
        assert ds.bins is not None
        models.append(b.model_to_string())
    assert models[0] == models[1]


def test_auto_stays_resident():
    x, y = _binary(n=800)
    p = dict(BASE, device="cpu", data_stream="auto")
    ds = lt.Dataset(x, y, params=p)
    b = lt.train(p, ds, 1, verbose_eval=False)
    assert b.inner._streamed is None and ds.bins is not None
