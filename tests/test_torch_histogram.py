"""The port's window histogram (its plain version, which a CPU tensor
takes) against lightgbm_tpu's fused Pallas kernel in interpret mode and
its segment-sum reference, on windows of a shared ``order`` array.

Tolerances: counts exact everywhere; g/h exact against the segment
reference, whose 2048-row chunked accumulation order the plain version
keeps; against the fused kernel, whose bf16 hi/lo weight split leaves
about 2^-16 of each term, 2^-16 of the bin's sum of |terms| plus atol
1e-6; integer-valued g/h exact against both.  The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py; here the
launch plan that picks its regime and grid is checked for every bound, and
the build's library name for every header a source includes."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.data.packing import pack_fused_panel
from lightgbm_tpu.ops.histogram import (subset_histogram_fused,
                                        subset_histogram_segment)
from lightgbm_tpu.ops.pallas_hist import fused_idx_fetch
from lightgbm_tpu_torch.ops import build
from lightgbm_tpu_torch.ops.histogram import (LARGE_BLOCKS_PER_SM,
                                              MAX_GRID_Y, MAX_SMEM,
                                              SMALL_BLOCKS_PER_SM,
                                              SMALL_MAX_ROWS,
                                              SMALL_MAX_ROWS_LOCAL,
                                              hist_local, hist_window,
                                              hist_window_plain, plan_launch)

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


# ---- the launch plan of both kernels ---------------------------------------

GRID_X_MAX = 2 ** 31 - 1
H100_SMS = 132             # the H100 SXM; on a card the wrapper reads it


def _assert_valid(plan, n_feat, num_bins):
    assert plan.regime in ("small", "large")
    assert 1 <= plan.grid_x <= GRID_X_MAX and 1 <= plan.grid_y <= MAX_GRID_Y
    assert 0 <= plan.smem_bytes <= MAX_SMEM
    if plan.regime == "small":
        assert (plan.grid_y, plan.smem_bytes) == (1, 0)
        return
    assert plan.smem_bytes >= plan.group_width * num_bins * 3 * 4
    assert plan.group_width * plan.grid_y >= n_feat


# (columns, bins, local rows or None for a window of order): the Higgs
# window and its 4x1 and 2x2 shards, the Expo window, narrow and wide ones
SHAPES = [(28, 255, None), (28, 255, 250_000), (14, 255, 500_000),
          (8, 255, None), (12, 63, 5000), (1, 2, None), (3, 256, 7),
          (300, 255, None), (70_000, 255, 1000)]


@pytest.mark.parametrize("n_feat,num_bins,n_loc", SHAPES)
def test_every_bound_gets_a_valid_plan(n_feat, num_bins, n_loc):
    top = n_loc if n_loc is not None else 5000
    edges = [SMALL_MAX_ROWS, SMALL_MAX_ROWS + 1, SMALL_MAX_ROWS_LOCAL,
             SMALL_MAX_ROWS_LOCAL + 1, 1_000_000, 11_000_000, 2 ** 31 - 1]
    for bound in list(range(0, top + 1)) + edges:
        _assert_valid(plan_launch(bound, n_feat, num_bins, n_loc,
                                  num_sms=H100_SMS), n_feat, num_bins)
    for num_sms in (1, 114, 144):      # other cards
        for bound in [0, 1, top] + edges:
            _assert_valid(plan_launch(bound, n_feat, num_bins, n_loc,
                                      num_sms=num_sms), n_feat, num_bins)


@pytest.mark.parametrize("n_loc,limit", [(None, SMALL_MAX_ROWS),
                                         (250_000, SMALL_MAX_ROWS_LOCAL),
                                         (500_000, SMALL_MAX_ROWS_LOCAL)])
def test_regime_switches_at_the_threshold(n_loc, limit):
    plan = lambda bound: plan_launch(bound, 28, 255, n_loc,
                                     num_sms=H100_SMS)
    assert plan(0).regime == plan(1).regime == plan(limit).regime == "small"
    assert plan(limit + 1).regime == plan(10 ** 7).regime == "large"
    # the small regime spreads a window's (row, column group, statistic)
    # lanes, or a shard's rows, over the card; the large one fills it
    assert plan(4097).grid_x > 100
    assert plan(10 ** 6).grid_x * plan(10 ** 6).grid_y >= 2 * H100_SMS
    if n_loc is not None:      # a shard of at most `limit` rows is small
        assert plan_launch(10 ** 7, 28, 255, limit,
                           num_sms=H100_SMS).regime == "small"


@pytest.mark.parametrize("num_sms", [132, 114, 1])
def test_grid_follows_the_sm_count(num_sms):
    """The large regime aims at LARGE_BLOCKS_PER_SM blocks on each SM of
    the card it is given, the small one at most SMALL_BLOCKS_PER_SM."""
    for n_loc in (None, 10 ** 7):   # a window; a scan of a large shard
        big = plan_launch(10 ** 6, 28, 255, n_loc, num_sms=num_sms)
        assert big.regime == "large" and big.grid_y == 7
        assert big.grid_x == max(1, num_sms * LARGE_BLOCKS_PER_SM // 7)
        small = plan_launch(10 ** 6, 28, 255, n_loc, num_sms=num_sms,
                            small_max_rows=10 ** 6)
        assert small.regime == "small"
        assert small.grid_x == SMALL_BLOCKS_PER_SM * num_sms


@pytest.mark.parametrize("args,kw", [
    ((-1, 28, 255), {}), ((10, 0, 255), {}), ((10, 28, 257), {}),
    ((10, 28, 0), {}), ((10, 28, 255), dict(num_sms=0)),
    ((10, 28, 255), dict(num_sms=-4)),
    # 32-column groups at 255 bins need 97,920 bytes of shared memory
    ((10, 2_000_000, 255), dict(small_max_rows=-1))])
def test_plan_raises_outside_the_kernels_limits(args, kw):
    with pytest.raises(ValueError):
        plan_launch(*args, **{"num_sms": H100_SMS, **kw})


def test_cpu_tensors_take_the_plain_version_whatever_the_plan():
    bins, g, h, c, perm = _problem(63, seed=3, integer=True)
    sc = torch.tensor([40, 700], dtype=torch.int32)
    want = _port(bins, g, h, c, perm, 40, 700, 63)
    t = torch.from_numpy
    for plan in (None, plan_launch(700, F, 63, num_sms=H100_SMS),
                 plan_launch(700, F, 63, num_sms=H100_SMS,
                             small_max_rows=-1)):
        got = hist_window(t(perm), sc, t(bins), t(g), t(h), t(c), 63,
                          rows_upper_bound=N, plan=plan)
        np.testing.assert_array_equal(got.numpy(), want)
        row_leaf = t((np.arange(N) % 3).astype(np.int32))
        lid = torch.tensor([1], dtype=torch.int32)
        got = hist_local(row_leaf, lid, t(bins), t(g), t(h), t(c), 63,
                         plan=plan)
        np.testing.assert_array_equal(got.numpy(), hist_local(
            row_leaf, lid, t(bins), t(g), t(h), t(c), 63).numpy())
    assert hist_window.launches == hist_local.launches == 0
    assert sum(hist_window.regime_launches.values()) == 0
    assert sum(hist_local.regime_launches.values()) == 0


# ---- the build: a library's name hashes its source and its headers --------


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "hist_gather.cu").write_text(
        '#include "hist_core.cuh"\n#include <cuda_runtime.h>\n')
    (csrc / "hist_core.cuh").write_text('#include "detail.cuh"\nint a;\n')
    (csrc / "detail.cuh").write_text("int b;\n")
    (csrc / "unrelated.cuh").write_text("int c;\n")
    monkeypatch.setattr(build, "_PKG", str(tmp_path))
    monkeypatch.setitem(build.KERNEL_SOURCES, "hist_gather",
                        "csrc/hist_gather.cu")
    first = build.library_path("hist_gather")
    assert first == build.library_path("hist_gather")
    (csrc / "unrelated.cuh").write_text("int c2;\n")
    assert build.library_path("hist_gather") == first
    (csrc / "hist_core.cuh").write_text('#include "detail.cuh"\nint a2;\n')
    second = build.library_path("hist_gather")
    assert second != first
    (csrc / "detail.cuh").write_text("int b2;\n")   # included by a header
    assert build.library_path("hist_gather") not in (first, second)


@pytest.mark.parametrize("name", ["hist_gather", "hist_local"])
def test_histogram_sources_include_the_shared_core(name):
    files = [os.path.basename(p) for p in build._source_files(
        os.path.join(build._PKG, build.KERNEL_SOURCES[name]))]
    assert files == [f"{name}.cu", "hist_core.cuh"]


# ---- the captured split step: the device regime and the second buffer ------

@pytest.mark.parametrize("n_feat,num_bins", [(28, 255), (8, 255), (12, 63)])
def test_device_plan_launches_both_regimes(n_feat, num_bins):
    """The split step's plan: the large regime's grid for the bound, the
    small regime's for a window of at most SMALL_MAX_WINDOW rows, which
    the small kernel takes; the device picks by the true count."""
    from lightgbm_tpu_torch.ops.histogram import (SMALL_MAX_WINDOW,
                                                  plan_device)
    assert SMALL_MAX_WINDOW == SMALL_MAX_ROWS // 2
    for bound in (0, 1, SMALL_MAX_WINDOW, SMALL_MAX_WINDOW + 1, 10 ** 6,
                  11_000_000):
        plan = plan_device(bound, n_feat, num_bins, num_sms=H100_SMS)
        large = plan_launch(bound, n_feat, num_bins, num_sms=H100_SMS,
                            small_max_rows=-1)
        small = plan_launch(min(bound, SMALL_MAX_WINDOW), n_feat, num_bins,
                            num_sms=H100_SMS,
                            small_max_rows=SMALL_MAX_WINDOW)
        assert plan.regime == "device" and large.regime == "large"
        assert plan[1:5] == large[1:5]
        assert plan.small_grid_x == small.grid_x >= 1
        assert plan.split_rows == SMALL_MAX_WINDOW


def test_selector_picks_the_second_set_on_cpu():
    """``alt``/``sel``: the window of the second (order, bins, weights)
    when the selector is odd, of the first when even; the plain version
    reads the selector, and nothing launches."""
    a = _problem(63, seed=11, integer=True)
    b = _problem(63, seed=12, integer=True)
    t = torch.from_numpy
    sc = torch.tensor([100, 3000], dtype=torch.int32)
    first = [t(x) for x in (a[4], *a[:4])]
    second = [t(x) for x in (b[4], *b[:4])]
    before = hist_window.launches
    for sel, want in ((0, a), (1, b), (3, b), (2, a)):
        got = hist_window(first[0], sc, *first[1:], 63, alt=tuple(second),
                          sel=torch.tensor([sel], dtype=torch.int32))
        np.testing.assert_array_equal(
            got.numpy(), _port(*want[:4], want[4], 100, 3000, 63))
    assert hist_window.launches == before
    with pytest.raises(ValueError):
        hist_window(first[0], sc, *first[1:], 63, alt=tuple(second))


# ---- the data-parallel split step: K3's device regime ----------------------


@pytest.mark.parametrize("n_loc,n_feat", [(250_000, 28), (500_000, 14),
                                          (100_000, 10), (65_536, 28)])
def test_local_device_plan_gates_at_the_threshold(n_loc, n_feat):
    """``plan_device_local``: the large kernel's grid for a leaf of all
    ``n_loc`` rows (the host's bound), the small kernel's scan grid, and a
    gate that gives counts up to SMALL_MAX_ROWS_LOCAL to the small kernel
    and larger ones to the large kernel."""
    from lightgbm_tpu_torch.ops.histogram import plan_device_local
    plan = plan_device_local(n_loc, n_feat, 255, num_sms=H100_SMS)
    large = plan_launch(n_loc, n_feat, 255, n_loc, num_sms=H100_SMS,
                        small_max_rows=-1)
    small = plan_launch(min(n_loc, SMALL_MAX_ROWS_LOCAL), n_feat, 255, n_loc,
                        num_sms=H100_SMS)
    assert plan.regime == "device" and large.regime == "large"
    assert small.regime == "small"
    assert plan[1:5] == large[1:5]
    assert plan.small_grid_x == small.grid_x >= 1
    assert plan.split_rows == SMALL_MAX_ROWS_LOCAL == 65_536
    for count, kernel in ((0, "small"), (1000, "small"),
                          (65_535, "small"), (65_536, "small"),
                          (65_537, "large"), (n_loc, "small" if n_loc <=
                                               65_536 else "large")):
        assert ("small" if count <= plan.split_rows else "large") == kernel


@pytest.mark.parametrize("cnt", [0, 1000, 65_535, 65_536, 65_537, 140_000])
def test_local_leaf_rows_on_cpu_take_the_plain_version(cnt):
    """With the per-leaf counts and the device plan, a CPU tensor still
    takes the plain version, which ignores both: at counts either side of
    the gate the histogram is the masked scatter-add's, and nothing
    launches."""
    from lightgbm_tpu_torch.ops.histogram import (hist_flat,
                                                  hist_local_plain,
                                                  plan_device_local)
    n_loc, f, b = 140_000, 3, 15
    rng = np.random.default_rng(cnt)
    bins = torch.from_numpy(rng.integers(0, b, (n_loc, f)).astype(np.uint8))
    row_leaf = np.zeros(n_loc, np.int32)
    row_leaf[rng.permutation(n_loc)[:cnt]] = 1
    g = torch.from_numpy(rng.integers(-8, 9, n_loc).astype(np.float32))
    h = torch.from_numpy(rng.integers(0, 5, n_loc).astype(np.float32))
    c = torch.ones(n_loc)
    leaf_rows = torch.from_numpy(np.bincount(row_leaf, minlength=4)
                                 .astype(np.int32))
    rl, lid = torch.from_numpy(row_leaf), torch.tensor([1], dtype=torch.int32)
    before = hist_local.launches
    got = hist_local(rl, lid, bins, g, h, c, b,
                     plan=plan_device_local(n_loc, f, b, num_sms=H100_SMS),
                     leaf_rows=leaf_rows)
    assert hist_local.launches == before
    np.testing.assert_array_equal(
        got.numpy(), hist_local_plain(rl, lid, bins, g, h, c, b).numpy())
    m = (rl == 1).float()
    np.testing.assert_array_equal(got.numpy(), hist_flat(
        bins, g * m, h * m, c * m, b).numpy())
    assert float(got[..., 2].sum()) == f * cnt
