"""The uint16 bin matrix in the port against lightgbm_tpu on the same
seeded data.

A column of more than 256 bins (``max_bin > 256``, or a categorical column
whose kept categories pass 256 at any ``max_bin``) makes the JAX package
store its bin matrix as uint16 (``lightgbm_tpu/data/dataset.py:140``); the
port keeps the same matrix, and its plain versions read it through an
int16 view.  Held exactly:

* the bins, the mappers and the matrix's type at ``max_bin`` 300, 1,023
  and 5,000 and for a 600-category column;
* the plain histogram (K1's and K3's plain versions) against the JAX
  package's scatter-add histograms, under integer weights; the plain
  routes against ``route_goes_left``; the categorical scan's
  ``max_cat_group`` loop against the JAX scan at 3,000 positions; the
  plain partitions and the packed storage matrix on uint16;
* model text under integer-valued gradients (every sum exact in any
  order) on a numeric ``max_bin=1023`` task and the 600-category task, by
  the serial eager loop, the leaf-ordered compact loop and the 4x1
  data-parallel learner, with EFB in a uint16 matrix and with packing
  where the JAX plan packs;
* binary dataset files both ways, and a JAX dataset and booster carried
  across by ``convert``.
The CUDA kernels' uint16 forms are held against these plain versions on
the card by ``chip_smoke.py`` (phase 2i)."""
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.data.packing import build_pack_plan as jax_pack_plan
from lightgbm_tpu.data.packing import pack_columns as jax_pack_columns
from lightgbm_tpu.grower import FeatureMeta as JaxMeta
from lightgbm_tpu.grower import route_goes_left as jax_route_goes_left
from lightgbm_tpu.ops.histogram import (subset_histogram_flat,
                                        subset_histogram_segment)
from lightgbm_tpu.ops.split import SplitConfig as JaxSplitConfig
from lightgbm_tpu.ops.split import best_split as jax_best_split
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu_torch.data.packing import build_pack_plan, pack_columns
from lightgbm_tpu_torch.grower import FeatureMeta
from lightgbm_tpu_torch.ops.histogram import (MAX_SMEM, MAX_SMEM_OPTIN,
                                              bin_rows, hist_flat,
                                              hist_local, hist_window,
                                              plan_device, plan_launch,
                                              widen)
from lightgbm_tpu_torch.ops.partition import (partition_window_plain,
                                              partition_window_sort)
from lightgbm_tpu_torch.ops.route import route_rows, route_window
from lightgbm_tpu_torch.ops.split import (SplitConfig, best_split,
                                          cat_group_accept_plain,
                                          make_fused_ctx)

BASE = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
            verbose=-1)
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


def _numeric(n=3000, seed=0):
    """Four continuous columns and a 600-valued integer one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5))
    x[:, 4] = rng.integers(0, 600, n)
    y = (x[:, 0] + 0.1 * (x[:, 4] % 7) > 0).astype(np.float32)
    return x, y


def _categories(n=3000, seed=1):
    """A 600-category column (about 5 rows each, so 99 % coverage keeps
    more than 256 categories at the default max_bin) beside two numeric
    columns."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 600, n).astype(np.float64)
    num = rng.standard_normal((n, 2))
    y = ((cat % 7 < 3) ^ (num[:, 0] > 0.8)).astype(np.float32)
    return np.column_stack([cat, num]), y


def _constructed(x, y, params, cat=None):
    dj = lj.Dataset(x, y, params=params, categorical_feature=cat).construct()
    dt = lt.Dataset(x, y, params=dict(params, device="cpu"),
                    categorical_feature=cat).construct()
    return dj.constructed, dt.constructed


# ---- the dataset ------------------------------------------------------------

@pytest.mark.parametrize("case", ["max_bin_300", "max_bin_1023",
                                  "max_bin_5000", "categories_600"])
def test_bins_mappers_and_dtype_equal_jax(case):
    if case == "categories_600":
        x, y = _categories()
        params, cat = dict(BASE), [0]
    else:
        rng = np.random.default_rng(2)
        x = rng.standard_normal((12000, 3))
        x[rng.random(12000) < 0.05, 1] = np.nan
        x[rng.random(12000) < 0.3, 2] = 0.0
        y = (x[:, 0] > 0).astype(np.float32)
        params = dict(BASE, max_bin=int(case.split("_")[-1]),
                      min_data_in_bin=1)
        cat = None
    b, a = _constructed(x, y, params, cat)
    assert a.max_num_bin() == b.max_num_bin() > 256
    assert a.binned.dtype == np.asarray(b.binned).dtype == np.uint16
    np.testing.assert_array_equal(a.binned, np.asarray(b.binned))
    assert a.used_features == list(b.used_features)
    for ma, mb in zip(a.bin_mappers, b.bin_mappers):
        assert (ma.num_bin, ma.missing_type, ma.default_bin, ma.bin_type) \
            == (mb.num_bin, mb.missing_type, mb.default_bin, mb.bin_type)
        if ma.bin_upper_bound is not None:
            np.testing.assert_array_equal(ma.bin_upper_bound,
                                          mb.bin_upper_bound)
        assert ma.bin_2_categorical == mb.bin_2_categorical


def test_narrow_matrix_stays_uint8():
    x, y = _numeric()
    b, a = _constructed(x[:, :4], y, dict(BASE))
    assert a.binned.dtype == np.asarray(b.binned).dtype == np.uint8


def test_max_bin_cap_is_the_jax_cap():
    """Any max_bin the JAX package takes (up to 65,535) is accepted; past
    it both raise."""
    for mb in (257, 1023, 65535):
        assert config_from_params({"max_bin": mb}).max_bin == mb
    with pytest.raises(RuntimeError, match="uint16"):
        config_from_params({"max_bin": 65536})
    with pytest.raises(RuntimeError, match="uint16"):
        lj.Dataset(np.zeros((10, 1)), np.zeros(10),
                   params={"max_bin": 65536}).construct()


def test_widen_reads_every_uint16_value():
    vals = np.asarray([[0, 255, 256], [32767, 32768, 65535]], np.uint16)
    bins = t(vals)
    np.testing.assert_array_equal(widen(bins).numpy(), vals.astype(np.int64))
    np.testing.assert_array_equal(
        bin_rows(bins, torch.tensor([1, 0])).numpy(),
        vals[[1, 0]].astype(np.int64))
    np.testing.assert_array_equal(
        bin_rows(bins, torch.tensor([2]), dim=1).numpy(),
        vals[:, [2]].astype(np.int64))


# ---- the kernels' plain versions ------------------------------------------

def _weights(rng, n):
    return (rng.integers(-8, 9, n).astype(np.float32),
            rng.integers(0, 5, n).astype(np.float32),
            (rng.random(n) > 0.2).astype(np.float32))


@pytest.mark.parametrize("num_bins", [300, 1023, 5000])
def test_plain_histograms_equal_jax(num_bins):
    """K1's plain version against ``subset_histogram_segment`` on windows
    of a shuffled order, K3's and the flat scatter-add against
    ``subset_histogram_flat`` on a leaf's masked rows: exact under
    integer weights."""
    rng = np.random.default_rng(num_bins)
    n, f = 4000, 6
    bins = rng.integers(0, num_bins, (n, f)).astype(np.uint16)
    bins[:5, 0] = num_bins - 1            # the last bin, past 255
    g, h, c = _weights(rng, n)
    perm = rng.permutation(n).astype(np.int32)
    for start, cnt in ((0, n), (333, 2049), (17, 1)):
        sel = perm[start:start + cnt]
        want = np.asarray(subset_histogram_segment(
            jnp.asarray(bins[sel]), jnp.asarray(g[sel]), jnp.asarray(h[sel]),
            jnp.asarray(c[sel]), num_bins))
        got = hist_window(t(perm), torch.tensor([start, cnt],
                                                dtype=torch.int32),
                          t(bins), t(g), t(h), t(c), num_bins)
        np.testing.assert_array_equal(got.numpy(), want)
    row_leaf = rng.integers(0, 3, n).astype(np.int32)
    mask = (row_leaf == 1).astype(np.float32)
    want = np.asarray(subset_histogram_flat(
        jnp.asarray(bins), jnp.asarray(g * mask), jnp.asarray(h * mask),
        jnp.asarray(c * mask), num_bins))
    got = hist_local(t(row_leaf), torch.tensor([1], dtype=torch.int32),
                     t(bins), t(g), t(h), t(c), num_bins)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        hist_flat(t(bins), t(g * mask), t(h * mask), t(c * mask),
                  num_bins).numpy(), want)


B_WIDE = 600
NUM_BIN = np.asarray([600, 400, 600, 300, 2], np.int32)
MISSING = np.asarray([0, 1, 2, 0, 2], np.int32)
DEFAULT = np.asarray([0, 270, 0, 0, 0], np.int32)
IS_CAT = np.asarray([False, False, False, True, False])
# (feature, threshold, default_left, categorical): thresholds past bin 255,
# the zero bin past it, and a categorical split whose bins reach past it
WIDE_SPLITS = [(0, 417, 1, False), (1, 300, 1, False), (1, 100, 0, False),
               (2, 520, 0, False), (3, 0, 0, True), (4, 0, 0, False)]


def _route_data(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    bins = np.stack([rng.integers(0, nb, n) for nb in NUM_BIN],
                    1).astype(np.uint16)
    orders = [rng.permutation(n).astype(np.int32) for _ in range(2)]
    cat_rows = rng.random((len(WIDE_SPLITS), B_WIDE)) < 0.5
    return bins, orders, cat_rows


def _jax_left(binf, split, cat_row):
    feat, thr, dleft, is_cat = split
    meta = JaxMeta(num_bin=jnp.asarray(NUM_BIN),
                   missing_type=jnp.asarray(MISSING),
                   default_bin=jnp.asarray(DEFAULT),
                   is_categorical=jnp.asarray(IS_CAT))
    return np.asarray(jax_route_goes_left(
        jnp.asarray(binf.astype(np.int32)), meta, jnp.int32(feat),
        jnp.int32(thr), jnp.asarray(bool(dleft)), True, jnp.asarray(is_cat),
        jnp.asarray(cat_row), B_WIDE))


def _meta():
    return FeatureMeta(t(NUM_BIN), t(MISSING), t(DEFAULT), t(IS_CAT))


@pytest.mark.parametrize("ordered", [False, True])
def test_plain_route_window_equals_jax(ordered):
    """``route_window`` (its plain version) on uint16 bins, gathered
    through either order buffer or leaf-ordered, every split of
    ``WIDE_SPLITS``, against ``route_goes_left``."""
    bins, orders, cat_rows = _route_data(4)
    si32 = t(np.asarray([s[:3] for s in WIDE_SPLITS], np.int32))
    scat = torch.tensor([s[3] for s in WIDE_SPLITS])
    scatb = t(cat_rows)
    out = torch.zeros(len(bins), dtype=torch.bool)
    for par in (0, 1):
        if ordered:
            b2 = (t(bins[orders[0]]), t(bins[orders[1]]))
            o2 = (None, None)
        else:
            b2, o2 = (t(bins), t(bins)), (t(orders[0]), t(orders[1]))
        for leaf, split in enumerate(WIDE_SPLITS):
            start, cnt = 211, 2500
            route_window(torch.tensor([start, cnt]),
                         torch.tensor([par], dtype=torch.int32),
                         torch.tensor([leaf]), si32, scat, scatb, _meta(),
                         b2, o2, out)
            rows = orders[par][start:start + cnt]
            want = _jax_left(bins[rows, split[0]], split, cat_rows[leaf])
            np.testing.assert_array_equal(out[:cnt].numpy(), want)


def test_plain_route_rows_equals_jax():
    """``route_rows`` (its plain version) on column-major uint16 bins of
    four shards: the rows of each split's leaf that ``route_goes_left``
    sends right move to the new leaf, and their counts with them."""
    bins, _, cat_rows = _route_data(5)
    n, shards = len(bins), 4
    bins_t = t(np.ascontiguousarray(bins.T))
    rng = np.random.default_rng(6)
    leaves = len(WIDE_SPLITS) + 2
    si32 = t(np.asarray([s[:3] for s in WIDE_SPLITS] + [(0, 0, 0)] * 2,
                        np.int32))
    scat = torch.tensor([s[3] for s in WIDE_SPLITS] + [False] * 2)
    scatb = t(np.concatenate([cat_rows, np.zeros((2, B_WIDE), bool)]))
    for leaf, split in enumerate(WIDE_SPLITS):
        rl = rng.integers(0, len(WIDE_SPLITS), n).astype(np.int32)
        counts = np.stack([np.bincount(r, minlength=leaves)
                           for r in rl.reshape(shards, -1)]).astype(np.int32)
        got_rl, got_c = t(rl.copy()), t(counts.copy())
        route_rows(got_rl, bins_t, torch.tensor([leaf]),
                   torch.tensor([leaves - 1]), si32, scat, scatb, _meta(),
                   got_c)
        right = (rl == leaf) & ~_jax_left(bins[:, split[0]], split,
                                          cat_rows[leaf])
        want = np.where(right, leaves - 1, rl)
        np.testing.assert_array_equal(got_rl.numpy(), want)
        np.testing.assert_array_equal(
            got_c.numpy(), np.stack([np.bincount(r, minlength=leaves)
                                     for r in want.reshape(shards, -1)]))


@pytest.mark.parametrize("max_cat_group", [64, 8])
def test_cat_scan_equals_jax_at_3000_positions(max_cat_group):
    """The categorical split scan of a 3,072-bin histogram whose
    categorical feature uses 3,050 bins, at ``max_cat_threshold=3000``:
    3,000 candidate positions a direction, so ``cat_group_accept_plain``
    walks lanes of T = 3,000 where the JAX package's ``lax.scan`` takes
    3,000 steps; the chosen split, its bins and sums identical under
    integer-valued histograms."""
    rng = np.random.default_rng(max_cat_group)
    b, n = 3072, 40000
    num_bin = np.asarray([3050, 700], np.int32)
    is_cat = np.asarray([True, False])
    bins = np.stack([rng.integers(0, nb, n) for nb in num_bin], 1)
    g = (rng.integers(-2, 3, n) + 3 * (bins[:, 0] % 5 == 1)).astype(
        np.float32)
    h = rng.integers(1, 4, n).astype(np.float32)
    hist = np.zeros((2, b, 3), np.float32)
    for f in range(2):
        for k, w in enumerate((g, h, np.ones(n, np.float32))):
            np.add.at(hist[f, :, k], bins[:, f], w)
    kw = dict(min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3,
              max_cat_threshold=3000, max_cat_group=max_cat_group,
              cat_smooth_ratio=0.01)
    mt, db = np.zeros(2, np.int32), np.zeros(2, np.int32)
    pg, ph, pc = np.float32(g.sum()), np.float32(h.sum()), np.float32(n)
    jres = jax_best_split(
        jnp.asarray(hist), pg, ph, pc, jnp.asarray(num_bin), jnp.asarray(mt),
        jnp.asarray(db), jnp.ones(2, bool),
        JaxSplitConfig(has_categorical=True, split_find="fused", **kw),
        is_cat=jnp.asarray(is_cat))
    cfg = SplitConfig(has_categorical=True, **kw)
    ctx = make_fused_ctx(t(num_bin), t(mt), t(db), b, cfg, t(is_cat))
    tres, _ = best_split(t(hist)[None], torch.tensor([pg]),
                         torch.tensor([ph]), torch.tensor([pc]),
                         torch.ones((1, 2), dtype=torch.bool), cfg, ctx)
    assert bool(jres.found) and bool(jres.is_cat)
    for name in ("feature", "is_cat"):
        assert int(getattr(tres, name)[0]) == int(getattr(jres, name))
    np.testing.assert_array_equal(tres.cat_bins[0].numpy(),
                                  np.asarray(jres.cat_bins))
    for name in ("left_count", "left_sum_g", "left_sum_h"):
        assert float(getattr(tres, name)[0]) == float(getattr(jres, name))


def test_cat_group_plain_walks_lanes_past_2048_positions():
    """The plain loop at T = 3,000 against a scalar float32 walk of the
    same accounting, lane by lane."""
    rng = np.random.default_rng(9)
    lanes, T = 6, 3000
    step = rng.poisson(30.0, (lanes, T)).astype(np.float32)
    ok = rng.random((lanes, T)) < 0.8
    rc = rng.integers(0, 10 ** 6, (lanes, T)).astype(np.float32)
    m0 = np.maximum(1.0, np.floor(rng.integers(1, 10 ** 6, lanes) / 64.0)
                    ).astype(np.float32)
    got = cat_group_accept_plain(t(step), t(ok), t(rc), t(m0), 64).numpy()
    for lane in range(lanes):
        cnt, rest, mdpg = np.float32(0), np.float32(64), m0[lane]
        for k in range(T):
            cnt = np.float32(cnt + step[lane, k])
            acc = ok[lane, k] and cnt >= mdpg
            assert got[lane, k] == acc, (lane, k)
            if acc:
                rest = np.float32(rest - 1)
                if rest > 0:
                    mdpg = max(np.float32(1), np.floor(np.float32(
                        rc[lane, k] / max(rest, np.float32(1)))))
                cnt = np.float32(0)


def test_plain_partitions_move_uint16_rows():
    """The plain and sort partitions of a window of order, uint16 bins
    (values past 32,767) and f32 weights: lefts first, both sides in
    order, the bytes of every row moved."""
    rng = np.random.default_rng(3)
    n = 2000
    src = [t(rng.permutation(n).astype(np.int32)),
           t(rng.integers(0, 65536, (n, 8)).astype(np.uint16)),
           t(rng.standard_normal(n).astype(np.float32))]
    gl = t(rng.random(n) < 0.4)
    start, cnt = 300, 1500
    idx = np.arange(start, start + cnt)
    left = gl[:cnt].numpy()
    perm = np.concatenate([idx[left], idx[~left]])
    for part in (partition_window_plain, partition_window_sort):
        dst = [torch.zeros_like(s) for s in src]
        nl = part(src, dst, start, cnt, gl)
        assert int(nl) == left.sum()
        for s, d in zip(src, dst):
            np.testing.assert_array_equal(d.numpy()[start:start + cnt],
                                          s.numpy()[perm])


def test_pack_columns_on_uint16_equals_jax():
    """A uint16 matrix whose narrow columns pack: the plan and the storage
    matrix (the same type, wide columns passed through) as the JAX
    package's."""
    col_bins = [300, 10, 12, 5, 16, 9, 700]
    rng = np.random.default_rng(8)
    binned = np.stack([rng.integers(0, b, 500) for b in col_bins],
                      1).astype(np.uint16)
    plan, jplan = build_pack_plan(col_bins), jax_pack_plan(col_bins)
    assert plan is not None and jplan is not None
    for name in ("byte_col", "shift", "is_packed"):
        np.testing.assert_array_equal(getattr(plan, name),
                                      getattr(jplan, name))
    got = pack_columns(t(binned), plan)
    want = jax_pack_columns(binned, jplan)
    assert got.dtype == torch.uint16 and want.dtype == np.uint16
    np.testing.assert_array_equal(got.numpy(), want)


def test_wide_launch_plans():
    """The kernels' plans at every width a uint16 matrix takes: a block's
    shared histogram within the opt-in limit (48 KB unless one column
    needs more), the groups covering every column, the slices every bin;
    uint8 widths plan as before."""
    for nb in (257, 1023, 1024, 1025, 4096, 4097, 19370, 19371, 65536):
        for f in (1, 7, 28):
            p = plan_launch(10 ** 6, f, nb, num_sms=132, bin_bytes=2)
            assert p.regime == "large"
            assert p.group_width * p.grid_y >= f
            assert p.grid_z * p.slice_bins >= nb
            assert p.smem_bytes >= p.group_width * p.slice_bins * 12
            assert p.smem_bytes <= (MAX_SMEM if nb * 12 <= MAX_SMEM
                                    else MAX_SMEM_OPTIN)
            assert (p.grid_z > 1) == (nb * 12 > MAX_SMEM_OPTIN)
            assert p.grid_z == 1 or p.group_width == 1
            d = plan_device(10 ** 6, f, nb, num_sms=132, bin_bytes=2)
            assert d[1:5] == p[1:5] and d[7:] == p[7:]
    assert plan_launch(10 ** 6, 28, 1023, num_sms=132,
                       bin_bytes=2).group_width == 4
    for nb in (2, 63, 255, 256):
        assert (plan_launch(10 ** 6, 28, nb, num_sms=132)
                == plan_launch(10 ** 6, 28, nb, num_sms=132, bin_bytes=2))
    with pytest.raises(ValueError):
        plan_launch(10, 28, 257, num_sms=132)
    with pytest.raises(ValueError):
        plan_launch(10, 28, 65537, num_sms=132, bin_bytes=2)


# ---- training ---------------------------------------------------------------

def _wide_efb(n=3000, seed=7):
    """A 600-valued column beside a 6-way one-hot block, which EFB
    bundles into one column of a uint16 matrix."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 8))
    x[:, 0] = rng.integers(0, 600, n)
    x[:, 1] = rng.standard_normal(n)
    x[np.arange(n), 2 + rng.integers(0, 6, n)] = 1.0
    y = ((x[:, 0] % 5 < 2) ^ (x[:, 3] > 0)).astype(np.float32)
    return x, y


def _wide_packed(n=3000, seed=8):
    """A 600-valued column and six columns of at most 10 values, which
    pack two a byte of a uint16 storage matrix (EFB off)."""
    rng = np.random.default_rng(seed)
    x = np.column_stack([rng.integers(0, 600, n), rng.standard_normal(n),
                         rng.integers(0, 10, (n, 6))]).astype(np.float64)
    y = ((x[:, 0] % 5 < 2) ^ (x[:, 2] > 4)).astype(np.float32)
    return x, y


TASKS = {"numeric_1023": (_numeric, dict(max_bin=1023), None),
         "categories_600": (_categories, {}, [0]),
         "efb_1023": (_wide_efb, dict(max_bin=1023), None),
         "packed_1023": (_wide_packed, dict(max_bin=1023,
                                            enable_bundle=False), None)}
LEARNERS = {"serial": dict(partition_impl="scatter"),
            "ordered_compact": dict(partition_impl="compact",
                                    ordered_bins="on",
                                    enable_bin_packing=False),
            "dp_4x1": dict(tree_learner="data", mesh_shape="4x1",
                           mesh_devices=4)}


@pytest.mark.parametrize("learner", list(LEARNERS))
@pytest.mark.parametrize("task", list(TASKS))
def test_model_text_equals_jax(task, learner):
    make, extra, cat = TASKS[task]
    x, y = make()
    p = dict(BASE, **extra)
    dj = lj.Dataset(x, y, params=p, categorical_feature=cat)
    bj = lj.train(p, dj, 3, fobj=_int_fobj(1), verbose_eval=False)
    tp = dict(p, device="cpu", **LEARNERS[learner])
    dt = lt.Dataset(x, y, params=tp, categorical_feature=cat)
    bt = lt.train(tp, dt, 3, fobj=_int_fobj(1), verbose_eval=False)
    inner = bt.inner
    assert dt.constructed.binned.dtype == np.uint16
    assert inner.bins.dtype == torch.uint16
    assert (inner.parallel_impl == "gspmd") == (learner == "dp_4x1")
    if task == "efb_1023":
        assert dt.constructed.bundled and inner.meta.col is not None
    if task == "packed_1023" and learner != "ordered_compact":
        assert inner.packed is not None and bj.inner._pack_plan is not None
        assert inner.packed.matrix.dtype == torch.uint16
    if cat:
        assert sum(m.num_cat for m in inner.models) > 0
    assert bt.model_to_string() == bj.model_to_string()


def test_bagging_and_dart_on_uint16_equal_jax():
    x, y = _categories(seed=4)
    for extra in (dict(bagging_fraction=0.5, bagging_freq=1),
                  dict(boosting_type="dart", drop_seed=3, drop_rate=0.5)):
        p = dict(BASE, **extra)
        bj = lj.train(p, lj.Dataset(x, y, params=p, categorical_feature=[0]),
                      4, fobj=_int_fobj(2), verbose_eval=False)
        tp = dict(p, device="cpu")
        bt = lt.train(tp, lt.Dataset(x, y, params=tp,
                                     categorical_feature=[0]),
                      4, fobj=_int_fobj(2), verbose_eval=False)
        assert bt.model_to_string() == bj.model_to_string(), extra
        # the scores the loop kept, through the binned traversal of the
        # uint16 matrix, equal predict on the raw rows
        np.testing.assert_allclose(bt.inner.scores[0].numpy(),
                                   bt.predict(x, raw_score=True), rtol=0,
                                   atol=1e-5)


def test_valid_set_and_leaf_indices_on_uint16():
    x, y = _categories(seed=5)
    xv, yv = _categories(n=800, seed=6)
    tp = dict(BASE, device="cpu")
    dt = lt.Dataset(x, y, params=tp, categorical_feature=[0])
    vt = dt.create_valid(xv, yv)
    bt = lt.train(tp, dt, 4, valid_sets=[vt], fobj=_int_fobj(3),
                  verbose_eval=False)
    assert vt.constructed.binned.dtype == np.uint16
    np.testing.assert_allclose(bt.inner.valid_sets[0].scores[0].numpy(),
                               bt.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)
    dj = lj.Dataset(x, y, params=BASE, categorical_feature=[0])
    bj = lj.train(BASE, dj, 4, fobj=_int_fobj(3), verbose_eval=False)
    np.testing.assert_array_equal(bt.predict(xv, pred_leaf=True),
                                  bj.predict(xv, pred_leaf=True))


# ---- files and carried state ------------------------------------------------

def test_binary_file_round_trips_uint16_both_ways():
    x, y = _categories(seed=9)
    tmp = tempfile.mkdtemp()
    jpath, tpath = (os.path.join(tmp, f) for f in ("jax.bin", "port.bin"))
    dj = lj.Dataset(x, y, params=BASE, categorical_feature=[0]).construct()
    dj.save_binary(jpath)
    dt = lt.Dataset(x, y, params=dict(BASE, device="cpu"),
                    categorical_feature=[0]).construct()
    dt.save_binary(tpath)
    from_jax = lt.Dataset(jpath, params=dict(BASE, device="cpu")).construct()
    from_port = lj.Dataset(tpath, params=BASE).construct()
    for got in (from_jax.constructed.binned,
                np.asarray(from_port.constructed.binned)):
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, dt.constructed.binned)
    assert from_jax.bins.dtype == torch.uint16
    assert ([m.bin_2_categorical for m in from_jax.constructed.bin_mappers]
            == [m.bin_2_categorical for m in dj.constructed.bin_mappers])


def test_jax_dataset_and_model_carried_across():
    """``convert`` takes the JAX package's uint16 matrix as it is, and
    its 600-category model: the port trains the JAX trees on the carried
    matrix, and both packages predict the same with the JAX model."""
    x, y = _categories(seed=10)
    dj = lj.Dataset(x, y, params=BASE, categorical_feature=[0]).construct()
    td = dj.constructed
    used = list(td.used_features)
    mappers = [td.bin_mappers[j] for j in used]
    ds = convert.dataset_from_arrays(
        np.asarray(td.binned), [m.num_bin for m in mappers],
        [m.missing_type for m in mappers], [m.default_bin for m in mappers],
        [m.bin_upper_bound for m in mappers], td.metadata.label,
        used_features=used, num_total_features=td.num_total_features,
        min_max=[(m.min_val, m.max_val) for m in mappers],
        bin_2_categorical=[m.bin_2_categorical for m in mappers],
        params={"device": "cpu"})
    assert ds.constructed.binned.dtype == np.uint16
    assert ds.bins.dtype == torch.uint16
    bj = lj.train(BASE, dj, 4, fobj=_int_fobj(4), verbose_eval=False)
    bt = lt.train(dict(BASE, device="cpu"), ds, 4, fobj=_int_fobj(4),
                  verbose_eval=False)
    assert bt.model_to_string() == bj.model_to_string()
    carried = convert.booster_from_arrays(model_str=bj.model_to_string(),
                                          params={"device": "cpu"})
    xv, _ = _categories(n=1000, seed=11)
    np.testing.assert_allclose(carried.predict(xv, raw_score=True),
                               bj.predict(xv, raw_score=True), rtol=1e-6,
                               atol=1e-12)
