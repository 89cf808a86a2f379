"""Dataset construction of the port against lightgbm_tpu's: identical bin
matrix, num_bin, bin upper bounds, default bins and missing types on the
same raw data (NaN, zero-heavy, constant and many-valued columns)."""
import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 10))
    x[rng.random(n) < 0.2, 1] = np.nan                 # NaN column
    x[rng.random(n) < 0.6, 2] = 0.0                    # zero-heavy column
    x[:, 3] = 1.5                                      # constant: trivial
    x[:, 4] = rng.integers(0, 7, n)                    # few distinct values
    x[:, 5] = np.round(rng.exponential(3.0, n), 1)     # skewed, ties
    x[:, 6] = -np.abs(x[:, 6])                         # negative only
    x[rng.random(n) < 0.3, 7] = np.nan
    x[rng.random(n) < 0.3, 7] = 0.0                    # NaN and zeros
    y = (np.nan_to_num(x[:, 0]) > 0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("n,params", [
    (3000, {}),
    (6000, {"bin_construct_sample_cnt": 2500}),        # sampled fit
    (3000, {"max_bin": 63, "min_data_in_bin": 3}),
    (3000, {"zero_as_missing": True}),
    (3000, {"use_missing": False}),
])
def test_dataset_matches_jax(n, params):
    x, y = _data(n, seed=n + len(params))
    p = dict(params, enable_bundle=False, enable_bin_packing=False,
             verbose=-1)
    ref = lj.Dataset(x, y, params=p).construct().constructed
    port = lt.Dataset(x, y, params=dict(p, device="cpu")).construct()
    td = port.constructed
    assert td.used_features == ref.used_features
    np.testing.assert_array_equal(td.binned, ref.binned)
    np.testing.assert_array_equal(port.bins.numpy(), ref.binned)
    for j in range(x.shape[1]):
        a, b = td.bin_mappers[j], ref.bin_mappers[j]
        assert a.is_trivial == b.is_trivial, j
        if a.is_trivial:
            continue
        assert (a.num_bin, a.missing_type, a.default_bin) == \
            (b.num_bin, b.missing_type, b.default_bin), j
        np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)
        assert a.feature_info_str() == b.feature_info_str()


def test_many_distinct_values_match_jax():
    """Columns with more distinct values than bins take the greedy
    mean-size packing (the JAX package runs its native binner there)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((20000, 3)) * [1.0, 100.0, 1e-3]
    y = np.zeros(20000, np.float32)
    p = {"enable_bundle": False, "enable_bin_packing": False, "verbose": -1}
    ref = lj.Dataset(x, y, params=p).construct().constructed
    td = lt.Dataset(x, y, params=dict(p, device="cpu")).construct().constructed
    np.testing.assert_array_equal(td.binned, ref.binned)
    for a, b in zip(td.bin_mappers, ref.bin_mappers):
        np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)


def test_valid_set_uses_training_mappers():
    x, y = _data(3000, seed=9)
    xv, yv = _data(1000, seed=10)
    p = {"enable_bundle": False, "enable_bin_packing": False, "verbose": -1}
    ref_tr = lj.Dataset(x, y, params=p)
    ref_v = lj.Dataset(xv, yv, reference=ref_tr, params=p)
    ref_v.construct()
    pp = dict(p, device="cpu")
    tr = lt.Dataset(x, y, params=pp)
    v = lt.Dataset(xv, yv, reference=tr, params=pp).construct()
    np.testing.assert_array_equal(v.constructed.binned,
                                  ref_v.constructed.binned)
