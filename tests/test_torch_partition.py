"""The port's window partition (``ops/partition.py``) against lightgbm_tpu's
``compact_window`` (the Pallas kernel, run in interpret mode) and against
a numpy stable-partition oracle.  A permutation is exact, so the window,
every payload and the left count must be identical.  The port partitions
out of place (``src -> dst``); positions of ``dst`` outside the window
keep what they held."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.pallas_compact import compact_window
from lightgbm_tpu_torch.ops.partition import (MAX_GRID_X, SMALL_MAX_ROWS,
                                              TILE, partition_scratch,
                                              partition_window,
                                              partition_window_plain,
                                              partition_window_sort,
                                              plan_launch)


def _oracle(win, gl, cnt):
    """Stable partition of the first ``cnt`` entries: lefts, then rights."""
    order = np.concatenate([np.flatnonzero(gl[:cnt]),
                            np.flatnonzero(~gl[:cnt])])
    out = win.copy()
    out[:cnt] = win[:cnt][order]
    return out


def _sc(start, cnt):
    """The window as the grower holds it: a device int64 (start, cnt)."""
    return torch.tensor([start, cnt], dtype=torch.int64)


def _port(win, gl, cnt, payload_u32, start=0, garbage_seed=None):
    """Partition ``win[:cnt]`` with the port (CPU: the plain version) into
    a second buffer, zeroed or full of garbage; u32 payload columns travel
    as int32 rows, bit for bit.  Returns the destination, with the
    source's entries outside the window."""
    src = [torch.from_numpy(win.copy())] + [
        torch.from_numpy(p.view(np.int32).copy()) for p in payload_u32]
    if garbage_seed is None:
        dst = [torch.zeros_like(t) for t in src]
    else:
        g = torch.Generator().manual_seed(garbage_seed)
        dst = [torch.randint(-2 ** 31, 2 ** 31 - 1, t.shape, generator=g,
                             dtype=torch.int32) for t in src]
    nl = partition_window(src, dst, _sc(start, cnt),
                          torch.from_numpy(gl.astype(np.uint8)), cnt)
    out = [d.numpy().copy() for d in dst]
    for o, s_ in zip(out, src):      # outside the window: the source's
        o[start + cnt:] = s_.numpy()[start + cnt:]
        o[:start] = s_.numpy()[:start]
    return out[0], [p.view(np.uint32) for p in out[1:]], int(nl[0])


def _check_against_jax(size, cnt, frac, npay, seed, garbage_seed=None):
    rng = np.random.RandomState(seed)
    win = rng.randint(0, 1 << 24, size).astype(np.int32)
    valid = np.arange(size) < cnt
    gl = (rng.rand(size) < frac) & valid
    pay = [rng.randint(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
           for _ in range(npay)]
    jw, jpay, jnl = compact_window(jnp.asarray(win), jnp.asarray(gl),
                                   jnp.asarray(valid),
                                   tuple(jnp.asarray(p) for p in pay),
                                   interpret=True)
    tw, tpay, tnl = _port(win, gl, cnt, pay, garbage_seed=garbage_seed)
    assert tnl == int(jnl) == int(gl.sum())
    np.testing.assert_array_equal(tw, np.asarray(jw))
    np.testing.assert_array_equal(tw, _oracle(win, gl, cnt))
    for a, b in zip(tpay, jpay):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("size,cnt,npay", [
    (1024, 1024, 0), (1024, 700, 2), (2048, 1, 1), (512, 0, 0),
    (1536, 1300, 3),
])
def test_plain_matches_jax_compact(size, cnt, npay):
    _check_against_jax(size, cnt, 0.4, npay, seed=size + cnt)


@pytest.mark.parametrize("trial", range(6))
def test_plain_matches_jax_compact_sweep(trial):
    """Seeded sweep over window size, valid-prefix length, left fraction
    (all-left, all-right, empty) and payload count, as test_compact's."""
    rng = np.random.RandomState(99 + trial)
    for _ in range(4):
        size = 512 * rng.randint(1, 5)
        cnt = int(rng.choice([0, 1, size, size - 1,
                              rng.randint(1, size + 1)]))
        frac = float(rng.choice([0.0, 1.0, rng.rand()]))
        _check_against_jax(size, cnt, frac, rng.randint(0, 4),
                           seed=int(rng.randint(1 << 30)))


@pytest.mark.parametrize("size,cnt,npay", [(1024, 1024, 2), (1536, 1300, 1),
                                            (512, 0, 0)])
def test_garbage_destination_matches_jax_compact(size, cnt, npay):
    """A destination full of garbage gets exactly the JAX compaction's
    window: every position of it is written."""
    _check_against_jax(size, cnt, 0.43, npay, seed=size + 3 * cnt,
                       garbage_seed=cnt + 1)


def _ordered_problem(n, seed):
    """The ordered-mode payload: ``[N, 28]`` uint8 bins and three f32
    weight vectors, rows following ``order``."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n).astype(np.int32)
    bins = rng.integers(0, 256, (n, 28), dtype=np.uint8)
    w = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    return order, bins, w


@pytest.mark.parametrize("cnt", [0, 1, 511, 4097])
@pytest.mark.parametrize("frac", [0.0, 1.0, 0.37])
def test_plain_matches_oracle_with_ordered_payload(cnt, frac):
    """Window sizes that are not multiples of 512, at an offset, with the
    ordered-mode payload; rows of dst outside the window are untouched and
    the source is only read."""
    n, start = 6000, 1234
    order, bins, w = _ordered_problem(n, seed=cnt)
    rng = np.random.default_rng(cnt + 7)
    gl = rng.random(cnt) < frac
    t = torch.from_numpy
    src = [t(order.copy()), t(bins.copy()), *[t(a.copy()) for a in w]]
    dst = [torch.full_like(x, 7) for x in src]
    nl = partition_window(src, dst, _sc(start, cnt), t(gl.astype(np.uint8)),
                          cnt)
    assert nl.dtype == torch.int32 and int(nl[0]) == int(gl.sum())
    perm = start + _oracle(np.arange(cnt), gl, cnt)
    for d, s_, ref in zip(dst, src, (order, bins, *w)):
        d = d.numpy()
        np.testing.assert_array_equal(d[start:start + cnt], ref[perm])
        assert (d[:start] == 7).all() and (d[start + cnt:] == 7).all()
        np.testing.assert_array_equal(s_.numpy(), ref)


def test_window_ending_at_last_row():
    n = 3000
    order, bins, w = _ordered_problem(n, seed=3)
    gl = np.random.default_rng(4).random(700) < 0.5
    t = torch.from_numpy
    src = [t(order.copy()), t(bins.copy())]
    dst = [x.clone() for x in src]
    nl = partition_window_plain(src, dst, n - 700, 700, t(gl))
    ref = _oracle(order[n - 700:], gl, 700)
    np.testing.assert_array_equal(dst[0].numpy()[n - 700:], ref)
    np.testing.assert_array_equal(dst[0].numpy()[:n - 700], order[:n - 700])
    assert int(nl[0]) == int(gl.sum())


@pytest.mark.parametrize("cnt", [0, 1, 4097])
def test_sort_form_equals_plain(cnt):
    """``partition_impl=sort`` (a stable sort on the 0/1 key) gives the
    plain version's permutation."""
    order, bins, w = _ordered_problem(5000, seed=11)
    gl = torch.from_numpy(np.random.default_rng(cnt).random(cnt) < 0.3)
    t = torch.from_numpy
    src = [t(order.copy()), t(bins.copy()), t(w[0].copy())]
    a = [torch.zeros_like(x) for x in src]
    b = [torch.zeros_like(x) for x in src]
    na = partition_window_plain(src, a, 300, cnt, gl)
    nb = partition_window_sort(src, b, 300, cnt, gl)
    assert torch.equal(na, nb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cpu_tensor_takes_plain_version_without_launch():
    order, bins, _ = _ordered_problem(2000, seed=5)
    gl = (np.random.default_rng(6).random(900) < 0.5).astype(np.uint8)
    before = partition_window.launches
    t = torch.from_numpy
    src = [t(order.copy())]
    a, b = [torch.zeros_like(src[0])], [torch.zeros_like(src[0])]
    na = partition_window(src, a, _sc(100, 900), t(gl), 900)
    nb = partition_window_plain(src, b, 100, 900, t(gl))
    assert torch.equal(a[0], b[0]) and torch.equal(na, nb)
    assert partition_window.launches == before


@pytest.mark.parametrize("cnt,small_grid,launches", [
    (0, 1, 0), (1, 1, 3), (4097, 3, 3),
    (SMALL_MAX_ROWS - 1, 96, 3), (SMALL_MAX_ROWS, 96, 3),
    (SMALL_MAX_ROWS + 1, 96, 3), (11_000_000, 96, 3)])
def test_launch_plan_at_its_edges(cnt, small_grid, launches):
    """Three launches a call, none for an empty bound: the small launch
    over the tiles of at most SMALL_MAX_ROWS positions of the bound, the
    count and write launches over all its tiles, a block a tile of TILE
    positions, within the grid's limit; the scratch holds a status word
    for every tile and the ticket, zeroed."""
    plan = plan_launch(cnt)
    assert (plan.small_grid, plan.launches) == (small_grid, launches)
    assert plan.grid == max(1, -(-cnt // TILE)) <= MAX_GRID_X
    assert (plan.grid - 1) * TILE < max(cnt, 1) <= plan.grid * TILE
    assert plan.small_grid * TILE >= min(cnt, SMALL_MAX_ROWS)
    scratch = partition_scratch(cnt, "cpu")
    assert scratch.numel() == plan.grid + 1 and scratch.eq(0).all()


def test_launch_plan_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError):
        plan_launch(-1)
    with pytest.raises(ValueError):
        plan_launch((MAX_GRID_X + 1) * TILE)
    assert plan_launch(10) == (1, 1, 3)


@pytest.mark.parametrize("cnt", [SMALL_MAX_ROWS - 1, SMALL_MAX_ROWS,
                                 SMALL_MAX_ROWS + 1])
def test_plain_at_the_small_form_threshold(cnt):
    """The windows at the form threshold and one either side."""
    n = SMALL_MAX_ROWS + 50
    order, bins, w = _ordered_problem(n, seed=cnt)
    gl = np.random.default_rng(cnt).random(cnt) < 0.43
    t = torch.from_numpy
    src = [t(order.copy()), t(bins.copy()), t(w[1].copy())]
    dst = [torch.zeros_like(x) for x in src]
    nl = partition_window(src, dst, _sc(20, cnt), t(gl), cnt)
    perm = 20 + _oracle(np.arange(cnt), gl, cnt)
    assert int(nl[0]) == int(gl.sum())
    for d, ref in zip(dst, (order, bins, w[1])):
        np.testing.assert_array_equal(d.numpy()[20:20 + cnt], ref[perm])


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "at the main path's shapes")
    dev = torch.device("cuda")
    n = 200_000
    order, bins, w = _ordered_problem(n, seed=8)
    rng = np.random.default_rng(9)
    scratch = partition_scratch(n, dev)
    one = [torch.from_numpy(a.copy()).to(dev) for a in (order, bins, *w)]
    two = [x.flip(0).contiguous() for x in one]
    for start, cnt in ((0, 0), (5, 1), (77, 511), (1000, 4097),
                       (3, SMALL_MAX_ROWS), (9, n - 9), (0, n),
                       (n - 4097, 4097)):
        for frac in (0.0, 1.0, 0.41):
            gl = torch.from_numpy(rng.random(n) < frac).to(dev)
            sc = torch.tensor([start, cnt], dtype=torch.int64, device=dev)
            for odd, bound in ((0, cnt), (0, n), (1, n)):
                src = two if odd else one
                k = [torch.randint_like(x, 0, 100) for x in src]
                p = [x.clone() for x in k]
                pair = (k, src) if odd else (src, k)
                nk = partition_window(*pair, sc, gl, bound, scratch,
                                      torch.tensor([odd], dtype=torch.int32,
                                                   device=dev))
                npl = partition_window_plain(src, p, start, cnt, gl)
                torch.cuda.synchronize()
                assert torch.equal(nk, npl)
                for x, y in zip(k, p):
                    assert torch.equal(x, y)


def test_device_form_launches_all_three():
    """The captured split step's call over the rows: all three launches
    over the tiles of the bound, gated on the device by the true cnt."""
    for bound in (1, 4097, SMALL_MAX_ROWS + 1, 11_000_000):
        plan = plan_launch(bound)
        assert plan == (-(-bound // TILE),
                        -(-min(bound, SMALL_MAX_ROWS) // TILE), 3)
    assert plan_launch(0).launches == 0


@pytest.mark.parametrize("odd", [0, 1, 2, 3])
def test_parity_swaps_source_and_destination(odd):
    """``odd`` in device memory picks the direction: an odd value
    partitions the second buffer set into the first."""
    n, cnt, start = 3000, 1700, 250
    order, bins, w = _ordered_problem(n, seed=odd + 20)
    gl = np.random.default_rng(odd).random(cnt) < 0.37
    t = torch.from_numpy
    one = [t(order.copy()), t(bins.copy())]
    two = [t(np.random.default_rng(odd).permutation(n).astype(np.int32)),
           t(np.ascontiguousarray(bins[::-1]))]
    src, dst = (two, one) if odd % 2 else (one, two)
    ref = [x.clone() for x in dst]
    want = partition_window_plain(src, ref, start, cnt, t(gl))
    keep = [x.clone() for x in src]
    nl = partition_window(one, two, _sc(start, cnt), t(gl), n,
                          odd=torch.tensor([odd], dtype=torch.int32))
    assert torch.equal(nl, want)
    for x, y in zip(dst, ref):
        assert torch.equal(x, y)
    for x, y in zip(src, keep):     # the source is left as it was
        assert torch.equal(x, y)
