"""The port's window routing (``ops/route.py``) against lightgbm_tpu's
``route_goes_left`` (``lightgbm_tpu/grower.py:372``): the same bins, split
and column metadata must send the same rows left, on numerical splits over
columns without missing values, with zero as missing and with NaN as
missing, and on categorical splits.  ``route_window`` reads the window, the
parity of its buffer and the splitting leaf from tensors, as the grower's
captured step holds them; on the CPU it takes the plain version."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.grower import FeatureMeta as JaxMeta
from lightgbm_tpu.grower import route_goes_left as jax_route_goes_left
from lightgbm_tpu_torch.grower import FeatureMeta
from lightgbm_tpu_torch.ops.route import (route_goes_left, route_window,
                                          route_window_plain)

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
