"""The port's window routing (``ops/route.py``) against lightgbm_tpu's
``route_goes_left`` (``lightgbm_tpu/grower.py:372``): the same bins, split
and column metadata must send the same rows left, on numerical splits over
columns without missing values, with zero as missing and with NaN as
missing, and on categorical splits.  ``route_window`` reads the window, the
parity of its buffer and the splitting leaf from tensors, as the grower's
captured step holds them; on the CPU it takes the plain version.

``route_rows_plain`` (the data-parallel learner's routing) against the JAX
learner's update of its row -> leaf map (``lightgbm_tpu/parallel/
gspmd.py:305-320``): ``jnp.where(row_leaf == l, jnp.where(goes_left, l,
new), row_leaf)``, equal row for row, rows of other leaves untouched, and
each shard's count of every leaf moved exactly.

The ``route_rows`` kernel's grid (``rows_grid``): column-major, at most
one wave over the shards; and the kernel's column-major layout of a
shard's rows over its threads (``_rows_layout``, the kernel's indexing
written out in numpy): every row of every shard taken by one thread, the
4-row vectors on 16-byte boundaries of ``row_leaf`` whatever the shard's
first row's residue, and the map walked as it lays the rows out equal to
the JAX learner's update.  The kernel itself is held to that indexing on
the card (``chip_smoke.py`` phase 2g's shards of 250,001 rows)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.grower import FeatureMeta as JaxMeta
from lightgbm_tpu.grower import route_goes_left as jax_route_goes_left
from lightgbm_tpu_torch.grower import FeatureMeta
from lightgbm_tpu_torch.ops.route import (MAX_BLOCKS_PER_SM,
                                          ROWS_BLOCKS_PER_SM, ROWS_UNROLL,
                                          THREADS, route_goes_left,
                                          route_rows, route_rows_plain,
                                          route_window, route_window_plain,
                                          rows_grid)

N, F, B = 3000, 5, 40
# column metadata: no missing, zero as missing, NaN as missing, and a
# categorical column (missing none) beside one with 2 bins and NaN
NUM_BIN = np.asarray([40, 33, 40, 25, 2], np.int32)
MISSING = np.asarray([0, 1, 2, 0, 2], np.int32)
DEFAULT = np.asarray([0, 7, 0, 0, 0], np.int32)
IS_CAT = np.asarray([False, False, False, True, False])
t = torch.from_numpy


def _data(seed):
    rng = np.random.default_rng(seed)
    bins = np.stack([rng.integers(0, nb, N) for nb in NUM_BIN],
                    1).astype(np.uint8)
    orders = [rng.permutation(N).astype(np.int32) for _ in range(2)]
    cat_rows = rng.random((4, B)) < 0.5
    return bins, orders, cat_rows


def _jax_left(binf, feat, thr, dleft, is_cat, cat_row):
    meta = JaxMeta(num_bin=jnp.asarray(NUM_BIN),
                   missing_type=jnp.asarray(MISSING),
                   default_bin=jnp.asarray(DEFAULT),
                   is_categorical=jnp.asarray(IS_CAT))
    return np.asarray(jax_route_goes_left(
        jnp.asarray(binf.astype(np.int32)), meta, jnp.int32(feat),
        jnp.int32(thr), jnp.asarray(dleft), True, jnp.asarray(is_cat),
        jnp.asarray(cat_row), B))


# (feature, threshold, default_left, categorical): a split on each kind
SPLITS = {"numerical": (0, 17, 1, False),
          "missing_zero_left": (1, 9, 1, False),
          "missing_zero_right": (1, 3, 0, False),
          "missing_nan_left": (2, 20, 1, False),
          "missing_nan_right": (2, 5, 0, False),
          "two_bin_nan": (4, 0, 0, False), "categorical": (3, 0, 0, True)}


@pytest.mark.parametrize("split", list(SPLITS))
def test_route_goes_left_matches_jax(split):
    bins, _, cat_rows = _data(seed=1)
    feat, thr, dleft, is_cat = SPLITS[split]
    meta = FeatureMeta(t(NUM_BIN), t(MISSING), t(DEFAULT), t(IS_CAT))
    got = route_goes_left(
        t(bins[:, feat]).long(), meta, torch.tensor([feat]),
        torch.tensor([thr]), torch.tensor([bool(dleft)]),
        torch.tensor([is_cat]), t(cat_rows[1]))
    want = _jax_left(bins[:, feat], feat, thr, bool(dleft), is_cat,
                     cat_rows[1])
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < N


def _pool(split, leaf):
    """A pool whose row ``leaf`` holds ``split``, the other rows others."""
    feat, thr, dleft, is_cat = SPLITS[split]
    si32 = np.zeros((6, 3), np.int32)
    si32[:, 0] = np.arange(6) % F
    si32[:, 1] = 3
    si32[leaf] = (feat, thr, dleft)
    scat = np.zeros(6, bool)
    scat[leaf] = is_cat
    return t(si32), t(scat)


@pytest.mark.parametrize("ordered", [False, True], ids=["gathered",
                                                        "ordered"])
@pytest.mark.parametrize("split", list(SPLITS))
def test_route_window_matches_jax_in_both_buffers(split, ordered):
    """The plain version of the kernel: the window of either buffer (by
    the parity tensor), its split column gathered through that buffer's
    ``order`` or read from its leaf-ordered bins, routed as the JAX
    package routes those rows; positions past the window untouched, and
    an empty window writes nothing."""
    bins, orders, cat_rows = _data(seed=2)
    feat, thr, dleft, is_cat = SPLITS[split]
    leaf = 4
    si32, scat = _pool(split, leaf)
    scatb = t(np.zeros((6, B), bool))
    scatb[leaf] = t(cat_rows[2])
    meta = FeatureMeta(t(NUM_BIN), t(MISSING), t(DEFAULT), t(IS_CAT))
    obins = [bins[o] for o in orders]    # each buffer's rows, in order
    for par in (0, 1):
        for start, cnt in ((0, N), (123, 1000), (N - 1, 1), (7, 0)):
            out = torch.full((N,), True)
            route_window(torch.tensor([start, cnt]),
                         torch.tensor([par], dtype=torch.int32),
                         torch.tensor([leaf]), si32, scat, scatb, meta,
                         [t(b) for b in obins] if ordered else (t(bins),) * 2,
                         (None, None) if ordered else [t(o) for o in orders],
                         out)
            rows = orders[par][start:start + cnt]
            want = _jax_left(bins[rows, feat], feat, thr, bool(dleft),
                             is_cat, cat_rows[2])
            np.testing.assert_array_equal(out[:cnt].numpy(), want)
            assert out[cnt:].all()


def test_cpu_tensors_take_the_plain_version():
    bins, orders, cat_rows = _data(seed=3)
    si32, scat = _pool("categorical", 2)
    meta = FeatureMeta(t(NUM_BIN), t(MISSING), t(DEFAULT), t(IS_CAT))
    args = (torch.tensor([10, 500]), torch.tensor([1], dtype=torch.int32),
            torch.tensor([2]), si32, scat, t(cat_rows[:3].repeat(2, 0)),
            meta, (t(bins), t(bins)), [t(o) for o in orders])
    before = route_window.launches
    a = route_window(*args, torch.zeros(N, dtype=torch.bool))
    b = route_window_plain(*args, torch.zeros(N, dtype=torch.bool))
    assert torch.equal(a, b) and route_window.launches == before


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "at the main path's shapes")
    dev = torch.device("cuda")
    bins, orders, cat_rows = _data(seed=5)
    meta = FeatureMeta(*[t(a).to(dev) for a in (NUM_BIN, MISSING, DEFAULT,
                                                IS_CAT)])
    scatb = t(np.repeat(cat_rows[:1], 6, 0)).to(dev)
    for split in SPLITS:
        si32, scat = (x.to(dev) for x in _pool(split, 3))
        for par in (0, 1):
            for ordered in (False, True):
                args = (torch.tensor([11, 2900], device=dev),
                        torch.tensor([par], dtype=torch.int32, device=dev),
                        torch.tensor([3], device=dev), si32, scat, scatb,
                        meta,
                        [t(bins[o]).to(dev) for o in orders] if ordered
                        else (t(bins).to(dev),) * 2,
                        (None, None) if ordered
                        else [t(o).to(dev) for o in orders])
                k = route_window(*args, torch.zeros(N, dtype=torch.bool,
                                                    device=dev))
                p = route_window_plain(*args, torch.zeros(
                    N, dtype=torch.bool, device=dev))
                torch.cuda.synchronize()
                assert torch.equal(k, p)


SHARDS = 3      # N rows as three row shards of 1,000


def _rows_case(seed, split, leaf=4, new=3):
    """A row -> leaf map over leaves 0, 1, 2 and ``leaf`` (``new`` holds no
    row, as the new leaf of a step), the pool with ``split`` in row
    ``leaf``, and every leaf's rows in each shard."""
    bins, _, cat_rows = _data(seed)
    rng = np.random.default_rng(seed + 10)
    row_leaf = rng.choice([0, 1, 2, leaf], N).astype(np.int32)
    si32, scat = _pool(split, leaf)
    scatb = np.zeros((6, B), bool)
    scatb[leaf] = cat_rows[0]
    counts = np.stack([np.bincount(r, minlength=6) for r in
                       row_leaf.reshape(SHARDS, -1)]).astype(np.int32)
    return bins, row_leaf, si32, scat, scatb, counts


def _rows_args(bins, row_leaf, si32, scat, scatb, counts, leaf, new,
               dev="cpu"):
    put = lambda a: torch.as_tensor(a).to(dev)
    meta = FeatureMeta(*[put(a) for a in (NUM_BIN, MISSING, DEFAULT,
                                          IS_CAT)])
    return (put(row_leaf.copy()), put(np.ascontiguousarray(bins.T)),
            torch.tensor([leaf], device=dev), torch.tensor([new], device=dev),
            si32.to(dev), scat.to(dev), put(scatb), meta,
            put(counts.copy()))


@pytest.mark.parametrize("split", list(SPLITS))
def test_route_rows_matches_the_jax_update(split):
    """The leaf's right rows move to the new leaf as the JAX learner moves
    them; every other row keeps its leaf; each shard's counts of the leaf
    and of the new leaf move by the rows moved in that shard, exactly."""
    leaf, new = 4, 3
    bins, row_leaf, si32, scat, scatb, counts = _rows_case(7, split)
    feat, thr, dleft, is_cat = SPLITS[split]
    goes_left = _jax_left(bins[:, feat], feat, thr, bool(dleft), is_cat,
                          scatb[leaf])
    want = np.asarray(jnp.where(
        jnp.asarray(row_leaf) == leaf,
        jnp.where(jnp.asarray(goes_left), leaf, new), jnp.asarray(row_leaf)))
    args = _rows_args(bins, row_leaf, si32, scat, scatb, counts, leaf, new)
    got = route_rows_plain(*args)
    assert got is args[0]       # in place
    np.testing.assert_array_equal(got.numpy(), want)
    moved = (want == new).reshape(SHARDS, -1).sum(1)
    assert moved.sum() > 0 and (row_leaf == leaf).sum() > moved.sum()
    np.testing.assert_array_equal(
        args[-1].numpy(), np.stack([np.bincount(r, minlength=6)
                                    for r in want.reshape(SHARDS, -1)]))
    np.testing.assert_array_equal(args[-1][:, new].numpy(), moved)


def test_route_rows_moves_nothing_from_the_sink():
    """A step after the stop routes the sink leaf, which holds no row and
    whose pool row may hold no valid column: nothing changes."""
    bins, row_leaf, si32, scat, scatb, counts = _rows_case(8, "numerical")
    si32[5] = torch.tensor([-1, 0, 0], dtype=torch.int32)
    args = _rows_args(bins, row_leaf, si32, scat, scatb, counts, 5, 5)
    route_rows(*args)
    np.testing.assert_array_equal(args[0].numpy(), row_leaf)
    np.testing.assert_array_equal(args[-1].numpy(), counts)


def test_route_rows_cpu_tensors_take_the_plain_version():
    bins, row_leaf, si32, scat, scatb, counts = _rows_case(9, "categorical")
    a = _rows_args(bins, row_leaf, si32, scat, scatb, counts, 4, 3)
    b = _rows_args(bins, row_leaf, si32, scat, scatb, counts, 4, 3)
    before = route_rows.launches
    route_rows(*a)
    route_rows_plain(*b)
    assert torch.equal(a[0], b[0]) and torch.equal(a[-1], b[-1])
    assert route_rows.launches == before


@pytest.mark.gpu
def test_route_rows_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "at the main path's shapes")
    for split in SPLITS:
        case = _rows_case(11, split)
        k = _rows_args(*case, 4, 3, dev="cuda")
        p = _rows_args(*case, 4, 3, dev="cuda")
        route_rows(*k)
        route_rows_plain(*p)
        torch.cuda.synchronize()
        assert torch.equal(k[0], p[0]) and torch.equal(k[-1], p[-1]), split


# ---- the route_rows kernel's plan ------------------------------------------

def _rows_layout(n_loc: int, grid_x: int, lead: int) -> np.ndarray:
    """The column-major rows of a shard as the ``route_rows`` kernel lays
    them over its ``grid_x`` blocks: int64 ``[n_loc]``, the global thread
    id (block * ``THREADS`` + thread) that takes each row.  ``lead`` is
    the shard's first row's place in ``row_leaf`` mod 4 (its element
    offset from a 16-byte boundary).  The rows before the first 16-byte
    boundary (the head) go one a thread to block 0's threads 0, 1, 2;
    then vector j (rows ``head + 4j`` to ``head + 4j + 3``) to thread
    ``j mod (grid_x * THREADS)``, rounds of ``ROWS_UNROLL`` vectors a
    thread; the rows after the last whole vector (the tail) to block 0's
    threads 32, 33, 34."""
    head = min((4 - lead % 4) % 4, n_loc)
    nvec = (n_loc - head) // 4
    tail0 = head + 4 * nvec
    owner = np.empty(n_loc, np.int64)
    owner[:head] = np.arange(head)
    owner[head:tail0] = np.repeat(np.arange(nvec) % (grid_x * THREADS), 4)
    owner[tail0:] = 32 + np.arange(n_loc - tail0)
    return owner


@pytest.mark.parametrize("column", [True, False])
@pytest.mark.parametrize("n_loc,shards", [
    (0, 1), (3, 4), (250_000, 4), (250_001, 4), (567_574, 4),
    (2_750_000, 4), (11_000_000, 1), (1_000, 700)])
def test_rows_grid_is_one_wave(n_loc, shards, column):
    """Column-major: the blocks of all shards fit one wave of a 132-SM
    card (unless the shards alone outnumber it), and a thread takes one
    round of ``ROWS_UNROLL`` vectors unless the wave is full.  Row-major:
    one row a thread up to ``MAX_BLOCKS_PER_SM`` blocks an SM."""
    sms = 132
    grid = rows_grid(n_loc, shards, sms, column)
    assert grid >= 1
    if not column:
        assert grid == max(1, min(-(-n_loc // THREADS),
                                  MAX_BLOCKS_PER_SM * sms // shards))
        return
    wave = ROWS_BLOCKS_PER_SM * sms
    if shards <= wave:
        assert grid * shards <= wave
    rounds = -(-(n_loc // 4 + 1) // (grid * THREADS * ROWS_UNROLL))
    assert rounds <= 1 or grid == wave // shards
    if grid > 1:
        assert (grid - 1) * THREADS * ROWS_UNROLL < n_loc // 4 + 1


@pytest.mark.parametrize("lead", range(4))
@pytest.mark.parametrize("n_loc", [0, 1, 2, 3, 4, 5, 7, 8, 1_001, 250_001])
def test_rows_plan_covers_every_row_once(n_loc, lead):
    """Every row has one thread of the grid; the rows before the first
    16-byte boundary and after the last whole vector (at most 3 each) go
    to distinct threads of block 0; each vector is 4 rows from a 16-byte
    boundary, all 4 with one thread, vector j with thread j mod the
    grid's threads (several rounds on a 2-SM card); a thread may take a
    head or tail row besides its vectors."""
    grid = rows_grid(n_loc, 1, 2, True)
    owner = _rows_layout(n_loc, grid, lead)
    assert owner.shape == (n_loc,)
    assert ((owner >= 0) & (owner < grid * THREADS)).all()
    head = min((4 - lead) % 4, n_loc)
    nvec = (n_loc - head) // 4
    starts = head + 4 * np.arange(nvec)
    assert ((lead + starts) % 4 == 0).all()
    for i in range(1, 4):
        np.testing.assert_array_equal(owner[starts + i], owner[starts])
    np.testing.assert_array_equal(owner[starts],
                                  np.arange(nvec) % (grid * THREADS))
    solo = np.r_[0:head, head + 4 * nvec:n_loc]
    assert head <= 3 and n_loc - head - 4 * nvec <= 3
    assert len(set(owner[solo])) == len(solo)
    assert (owner[solo] < THREADS).all()


@pytest.mark.parametrize("lead", range(4))
@pytest.mark.parametrize("split", ["numerical", "missing_zero_right",
                                   "missing_nan_left", "categorical"])
def test_route_rows_plan_walk_matches_the_jax_update(split, lead):
    """Three shards of 999 rows (each shard's first row at another
    residue mod 4, past ``lead``) walked thread by thread as the plan lays
    them out, each row routed by the JAX package's ``route_goes_left``:
    every row taken once, the map the JAX learner's update, and the rows
    moved a shard summed over its threads."""
    leaf, new, shards, n_loc = 4, 3, 3, 999
    bins, row_leaf, _, _, scatb, _ = _rows_case(12, split)
    n = shards * n_loc
    bins, row_leaf = bins[:n], row_leaf[:n]
    feat, thr, dleft, is_cat = SPLITS[split]
    left = _jax_left(bins[:, feat], feat, thr, bool(dleft), is_cat,
                     scatb[leaf])
    want = np.asarray(jnp.where(
        jnp.asarray(row_leaf) == leaf,
        jnp.where(jnp.asarray(left), leaf, new), jnp.asarray(row_leaf)))
    got, taken = row_leaf.copy(), np.zeros(n, np.int64)
    moved = np.zeros(shards, np.int64)
    grid = rows_grid(n_loc, shards, 1, True)
    for s in range(shards):
        owner = _rows_layout(n_loc, grid, lead + s * n_loc)
        for th in np.unique(owner):
            rows = s * n_loc + np.flatnonzero(owner == th)
            taken[rows] += 1
            right = rows[(got[rows] == leaf) & ~left[rows]]
            got[right] = new
            moved[s] += len(right)
    assert (taken == 1).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        moved, (want != row_leaf).reshape(shards, -1).sum(1))
    assert moved.sum() > 0
