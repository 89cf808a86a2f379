"""The port's window partition (``ops/partition.py``) against lightgbm_tpu's
``compact_window`` (the Pallas kernel, run in interpret mode) and against
a numpy stable-partition oracle.  A permutation is exact, so the window,
every payload and the left count must be identical."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.pallas_compact import compact_window
from lightgbm_tpu_torch.ops.partition import (partition_window,
                                              partition_window_plain,
                                              partition_window_sort)


def _oracle(win, gl, cnt):
    """Stable partition of the first ``cnt`` entries: lefts, then rights."""
    order = np.concatenate([np.flatnonzero(gl[:cnt]),
                            np.flatnonzero(~gl[:cnt])])
    out = win.copy()
    out[:cnt] = win[:cnt][order]
    return out


def _port(win, gl, cnt, payload_u32, start=0):
    """Partition ``win[:cnt]`` with the port (CPU: the plain version);
    u32 payload columns travel as int32 rows, bit for bit."""
    order = torch.from_numpy(win.copy())
    pay = [torch.from_numpy(p.view(np.int32).copy()) for p in payload_u32]
    sc = torch.tensor([start, cnt], dtype=torch.int32)
    nl = partition_window(order, sc, torch.from_numpy(gl.astype(np.uint8)),
                          pay)
    return order.numpy(), [p.numpy().view(np.uint32) for p in pay], int(nl[0])


def _check_against_jax(size, cnt, frac, npay, seed):
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
    tw, tpay, tnl = _port(win, gl, cnt, pay)
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
    ordered-mode payload; rows outside the window are untouched."""
    n, start = 6000, 1234
    order, bins, w = _ordered_problem(n, seed=cnt)
    rng = np.random.default_rng(cnt + 7)
    gl = rng.random(cnt) < frac
    t = torch.from_numpy
    o, b = t(order.copy()), t(bins.copy())
    ws = [t(a.copy()) for a in w]
    sc = torch.tensor([start, cnt], dtype=torch.int32)
    nl = partition_window(o, sc, t(gl.astype(np.uint8)), [b, *ws])
    assert nl.dtype == torch.int32 and int(nl[0]) == int(gl.sum())
    perm = np.arange(n)
    perm[start:start + cnt] = start + _oracle(np.arange(cnt), gl, cnt)
    np.testing.assert_array_equal(o.numpy(), order[perm])
    np.testing.assert_array_equal(b.numpy(), bins[perm])
    for a, ref in zip(ws, w):
        np.testing.assert_array_equal(a.numpy(), ref[perm])


def test_window_ending_at_last_row():
    n = 3000
    order, bins, w = _ordered_problem(n, seed=3)
    gl = np.random.default_rng(4).random(700) < 0.5
    t = torch.from_numpy
    o, b = t(order.copy()), t(bins.copy())
    nl = partition_window_plain(o, n - 700, 700, t(gl), [b])
    ref = _oracle(order[n - 700:], gl, 700)
    np.testing.assert_array_equal(o.numpy()[n - 700:], ref)
    np.testing.assert_array_equal(o.numpy()[:n - 700], order[:n - 700])
    assert int(nl[0]) == int(gl.sum())


@pytest.mark.parametrize("cnt", [0, 1, 4097])
def test_sort_form_equals_plain(cnt):
    """``partition_impl=sort`` (a stable sort on the 0/1 key) gives the
    plain version's permutation."""
    order, bins, w = _ordered_problem(5000, seed=11)
    gl = torch.from_numpy(np.random.default_rng(cnt).random(cnt) < 0.3)
    t = torch.from_numpy
    a = [t(order.copy()), t(bins.copy()), t(w[0].copy())]
    b = [t(order.copy()), t(bins.copy()), t(w[0].copy())]
    na = partition_window_plain(a[0], 300, cnt, gl, a[1:])
    nb = partition_window_sort(b[0], 300, cnt, gl, b[1:])
    assert torch.equal(na, nb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cpu_tensor_takes_plain_version_without_launch():
    order, bins, _ = _ordered_problem(2000, seed=5)
    gl = (np.random.default_rng(6).random(900) < 0.5).astype(np.uint8)
    before = partition_window.launches
    t = torch.from_numpy
    a, b = t(order.copy()), t(order.copy())
    na = partition_window(a, torch.tensor([100, 900], dtype=torch.int32),
                          t(gl))
    nb = partition_window_plain(b, 100, 900, t(gl))
    assert torch.equal(a, b) and torch.equal(na, nb)
    assert partition_window.launches == before


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "at the main path's shapes")
    dev = torch.device("cuda")
    n = 200_000
    order, bins, w = _ordered_problem(n, seed=8)
    rng = np.random.default_rng(9)
    for start, cnt in ((0, 0), (5, 1), (77, 511), (1000, 4097), (0, n),
                       (n - 4097, 4097)):
        for frac in (0.0, 1.0, 0.41):
            gl = torch.from_numpy(
                (rng.random(cnt) < frac).astype(np.uint8)).to(dev)
            k = [torch.from_numpy(a.copy()).to(dev) for a in (order, bins, *w)]
            p = [x.clone() for x in k]
            sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
            nk = partition_window(k[0], sc, gl, k[1:], rows_upper_bound=cnt)
            npl = partition_window_plain(p[0], start, cnt, gl, p[1:])
            torch.cuda.synchronize()
            assert torch.equal(nk, npl)
            for x, y in zip(k, p):
                assert torch.equal(x, y)
