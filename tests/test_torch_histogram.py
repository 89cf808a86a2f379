"""The port's window histogram (its plain version, which a CPU tensor
takes) against lightgbm_tpu's fused Pallas kernel in interpret mode and
its segment-sum reference, on windows of a shared ``order`` array.

Tolerances: counts exact everywhere; g/h exact against the segment
reference, whose 2048-row chunked accumulation order the plain version
keeps; against the fused kernel, whose bf16 hi/lo weight split leaves
about 2^-16 of each term, 2^-16 of the bin's sum of |terms| plus atol
1e-6; integer-valued g/h exact against both.  The CUDA kernel itself is held against the plain version on the
card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.data.packing import pack_fused_panel
from lightgbm_tpu.ops.histogram import (subset_histogram_fused,
                                        subset_histogram_segment)
from lightgbm_tpu.ops.pallas_hist import fused_idx_fetch
from lightgbm_tpu_torch.ops.histogram import hist_window, hist_window_plain

ROW_TILE = 512
N, F = 5000, 12


def _problem(b, seed, integer):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, (N, F)).astype(np.uint8)
    if integer:
        g = rng.integers(-8, 9, N).astype(np.float32)
        h = rng.integers(0, 5, N).astype(np.float32)
    else:
        g = rng.standard_normal(N).astype(np.float32)
        h = rng.uniform(0.0, 0.25, N).astype(np.float32)
    c = (rng.random(N) > 0.2).astype(np.float32)
    perm = rng.permutation(N).astype(np.int32)
    return bins, g, h, c, perm


def _jax_fused(bins, g, h, c, perm, start, cnt, b):
    pad = lambda a: jnp.concatenate([jnp.asarray(a),
                                     jnp.zeros((1,) + a.shape[1:], a.dtype)])
    panel, per = pack_fused_panel(pad(bins), pad(g), pad(h), pad(c))
    order = jnp.concatenate([jnp.asarray(perm),
                             jnp.full((fused_idx_fetch(ROW_TILE),), N,
                                      jnp.int32)])
    return np.asarray(subset_histogram_fused(
        order, panel, start, cnt, F, per, b, row_tile=ROW_TILE,
        num_row_tiles=max(1, -(-cnt // ROW_TILE)), interpret=True))


def _port(bins, g, h, c, perm, start, cnt, b):
    t = torch.from_numpy
    return hist_window(t(perm), torch.tensor([start, cnt], dtype=torch.int32),
                       t(bins), t(g), t(h), t(c), b).numpy()


WINDOWS = [(17, 0), (4999, 1), (0, 1), (333, 513), (1029, 2047),
           (100, 4100), (0, N)]


@pytest.mark.parametrize("b", [255, 63])
@pytest.mark.parametrize("start,cnt", WINDOWS)
def test_plain_matches_segment_and_fused(b, start, cnt):
    bins, g, h, c, perm = _problem(b, seed=b + cnt, integer=False)
    out = _port(bins, g, h, c, perm, start, cnt, b)
    assert out.shape == (F, b, 3) and out.dtype == np.float32
    sel = perm[start:start + cnt]
    seg = np.asarray(subset_histogram_segment(
        jnp.asarray(bins[sel]), jnp.asarray(g[sel]), jnp.asarray(h[sel]),
        jnp.asarray(c[sel]), b)) if cnt else np.zeros_like(out)
    np.testing.assert_array_equal(out, seg)
    if cnt in (0, 1, 513):        # the interpret-mode kernel is slow
        fused = _jax_fused(bins, g, h, c, perm, start, cnt, b)
        np.testing.assert_array_equal(out[..., 2], fused[..., 2])
        mag = _port(bins, np.abs(g), h, c, perm, start, cnt, b)
        assert (np.abs(out - fused) <= 2.0 ** -16 * mag + 1e-6).all()


@pytest.mark.parametrize("start,cnt", [(1029, 1536), (0, N)])
def test_integer_weights_exact_against_both(start, cnt):
    bins, g, h, c, perm = _problem(255, seed=7, integer=True)
    out = _port(bins, g, h, c, perm, start, cnt, 255)
    fused = _jax_fused(bins, g, h, c, perm, start, cnt, 255)
    np.testing.assert_array_equal(out, fused)
    sel = perm[start:start + cnt]
    ref = np.zeros((F, 255, 3), np.float64)
    for f in range(F):
        for k, w in enumerate((g, h, c)):
            np.add.at(ref[f, :, k], bins[sel, f], w[sel])
    np.testing.assert_array_equal(out, ref.astype(np.float32))


def test_cpu_tensor_takes_plain_version_without_launch():
    bins, g, h, c, perm = _problem(63, seed=1, integer=True)
    before = hist_window.launches
    t = torch.from_numpy
    sc = torch.tensor([5, 100], dtype=torch.int32)
    a = hist_window(t(perm), sc, t(bins), t(g), t(h), t(c), 63)
    b = hist_window_plain(t(perm), sc, t(bins), t(g), t(h), t(c), 63)
    assert torch.equal(a, b)
    assert hist_window.launches == before


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "at the main path's shapes")
    bins, g, h, c, perm = _problem(255, seed=2, integer=True)
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(a).to(dev)
    for start, cnt in WINDOWS:
        sc = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
        k = hist_window(t(perm), sc, t(bins), t(g), t(h), t(c), 255)
        p = hist_window_plain(t(perm), sc, t(bins), t(g), t(h), t(c), 255)
        assert torch.equal(k, p)
