"""EFB (exclusive feature bundling) in the port against lightgbm_tpu on the
same seeded data.

The data is Covertype-shaped at test size: a few numeric columns beside a
4-column and a 12-column one-hot block, which EFB bundles into two columns
(optionally with conflicting rows injected under ``max_conflict_rate``).
Held exactly: the bundle layout and the bundled bin matrix; the expansion
maps, ``decode_bundle_bin``, the plain route on a bundle column, and the
gathered bins of ``expand_bundle_hist``; its rebuilt default bins, on the
same float histograms, within 8 float32 epsilons of the largest prefix sum
of the flat histogram (the JAX package subtracts two such prefix sums, the
port adds the feature's slots).
Held as identical model text: trees grown under a custom objective of
integer-valued gradients and hessians (every sum exact in any order) by
the serial grower (scatter and compact), the data-parallel learner over
4x1 and 2x2 meshes, ``tree_learner=feature``, bagging in the subset
regime and DART, all against the JAX package's serial learner at the
defaults (bundling and packing on)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import grower as jg
from lightgbm_tpu_torch import grower as tg
from lightgbm_tpu_torch.ops.route import decode_bundle_bin, route_window

BASE = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
            verbose=-1)


def _covtype_small(n=2000, seed=0, conflicts=0.0):
    """4 numeric columns, a 4-way and a 12-way one-hot block of 0/1
    columns, a label from all three; ``conflicts`` of the rows get a
    second 1 in each block."""
    rng = np.random.default_rng(seed)
    num = rng.standard_normal((n, 4))
    blocks, logit = [], num @ np.array([1.0, -0.7, 0.4, 0.2])
    for width in (4, 12):
        which = rng.integers(0, width, n)
        blk = np.zeros((n, width))
        blk[np.arange(n), which] = 1.0
        if conflicts:
            rows = rng.choice(n, int(n * conflicts), replace=False)
            blk[rows, (which[rows] + 1) % width] = 1.0
        logit += rng.standard_normal(width)[which]
        blocks.append(blk)
    x = np.column_stack([num] + blocks)
    y = (logit + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    return x, y


def _int_fobj(seed):
    """Integer-valued gradients and hessians, the same sequence in every
    package: exact sums in any order."""
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(seed + calls[0])
        calls[0] += 1
        n = len(preds)
        return (rng.integers(-3, 4, n).astype(np.float64),
                rng.integers(1, 4, n).astype(np.float64))
    return fobj


def _datasets(x, y, params):
    dj = lj.Dataset(x, y, params=params).construct()
    tp = dict(params, device="cpu")
    dt = lt.Dataset(x, y, params=tp).construct()
    return dj, dt


@pytest.mark.parametrize("conflict_rate", [0.0, 0.1])
def test_layout_and_bundled_matrix_equal_jax(conflict_rate):
    x, y = _covtype_small(conflicts=0.05 if conflict_rate else 0.0)
    p = dict(BASE, max_conflict_rate=conflict_rate)
    dj, dt = _datasets(x, y, p)
    lj_, lt_ = dj.constructed.layout, dt.constructed.layout
    assert lj_ is not None and lt_ is not None and lt_.has_bundles
    for f in ("bundles", "sub_features", "sub_col", "sub_offset",
              "col_num_bin"):
        assert getattr(lt_, f) == getattr(lj_, f), f
    assert dt.constructed.used_features == dj.constructed.used_features
    np.testing.assert_array_equal(dt.constructed.binned,
                                  np.asarray(dj.constructed.binned))
    assert dt.constructed.max_num_bin() == dj.constructed.max_num_bin()
    mj, mt = dj.constructed.feature_meta(), dt.constructed.feature_meta()
    assert set(mj) == set(mt)
    for k in mj:
        np.testing.assert_array_equal(mt[k], np.asarray(mj[k]), err_msg=k)
    if not conflict_rate:
        # the one-hot blocks each became one column
        assert dt.constructed.binned.shape[1] == 4 + 2


def _metas(dt):
    fm = dt.constructed.feature_meta()
    jm = jg.FeatureMeta(*(jnp.asarray(fm[k]) for k in (
        "num_bin", "missing_type", "default_bin", "is_categorical", "col",
        "offset")))
    tm = tg.FeatureMeta(*(torch.from_numpy(fm[k]) for k in (
        "num_bin", "missing_type", "default_bin", "is_categorical", "col",
        "offset")))
    return jm, tm


def test_expand_maps_and_histograms_equal_jax():
    x, y = _covtype_small()
    _, dt = _datasets(x, y, BASE)
    jm, tm = _metas(dt)
    B = dt.constructed.max_num_bin()
    jmaps = jg.make_expand_maps(jm, B)
    tmaps = tg.make_expand_maps(tm, B)
    # (src, valid, recon); the JAX package's prefix-sum bounds lo and hi
    # and its feature-slice window have no counterpart: both learners
    # expand the whole histogram
    for a, b in zip(tmaps, jmaps[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(3)
    fp = dt.constructed.binned.shape[1]
    hist = rng.standard_normal((2, fp, B, 3)).astype(np.float32)
    sums = rng.standard_normal((2, 3)).astype(np.float32) * 10
    got = tg.expand_bundle_hist(torch.from_numpy(hist),
                                *torch.from_numpy(sums).T, tmaps).numpy()
    recon = tmaps.recon.numpy()
    for k in range(2):
        want = np.asarray(jg.expand_bundle_hist(jnp.asarray(hist[k]),
                                                *sums[k], jmaps))
        # gathered bins are copies; a rebuilt default bin subtracts its
        # feature's slots, which the JAX package sums as a difference of
        # two float32 prefix sums of the flat histogram and the port adds
        # directly: the two differ by the prefix sums' rounding
        np.testing.assert_array_equal(got[k][~recon], want[~recon])
        prefix = np.abs(np.cumsum(hist[k].reshape(-1, 3), 0,
                                  dtype=np.float64)).max()
        np.testing.assert_allclose(got[k], want, rtol=0,
                                   atol=8 * np.finfo(np.float32).eps * prefix)


def test_decode_bundle_bin_equal_jax():
    x, y = _covtype_small()
    _, dt = _datasets(x, y, BASE)
    jm, tm = _metas(dt)
    raw = np.arange(256, dtype=np.int64)
    for feat in range(tm.num_bin.numel()):
        want = np.asarray(jg.decode_bundle_bin(jnp.asarray(raw, jnp.int32),
                                               feat, jm))
        got = decode_bundle_bin(torch.from_numpy(raw),
                                torch.tensor([feat]), tm).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(feat))


def test_route_window_decodes_like_jax_route_goes_left():
    """The plain route on a bundled column equals the JAX package's
    ``route_goes_left`` on every logical feature at several thresholds."""
    x, y = _covtype_small()
    _, dt = _datasets(x, y, BASE)
    jm, tm = _metas(dt)
    bins = torch.from_numpy(np.ascontiguousarray(dt.constructed.binned))
    n = bins.shape[0]
    order = torch.arange(n, dtype=torch.int32)
    out = torch.zeros(n, dtype=torch.bool)
    for feat in range(tm.num_bin.numel()):
        c = int(tm.col[feat])
        for thr in range(int(tm.num_bin[feat]) - 1):
            split = torch.tensor([[feat, thr, 1]], dtype=torch.int32)
            route_window(torch.tensor([0, n]),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int64), split, None,
                         None, tm, (bins, bins), (order, order), out)
            want = np.asarray(jg.route_goes_left(
                jnp.asarray(bins[:, c].numpy().astype(np.int32)), jm, feat,
                thr, True))
            np.testing.assert_array_equal(out.numpy(), want)


def _train_jax(x, y, params, rounds, fobj_seed, **kw):
    return lj.train(params, lj.Dataset(x, y, params=params), rounds,
                    fobj=_int_fobj(fobj_seed), verbose_eval=False, **kw)


def _train_port(x, y, params, rounds, fobj_seed, **kw):
    tp = dict(params, device="cpu")
    return lt.train(tp, lt.Dataset(x, y, params=tp), rounds,
                    fobj=_int_fobj(fobj_seed), verbose_eval=False, **kw)


@pytest.mark.parametrize("conflict_rate", [0.0, 0.1])
@pytest.mark.parametrize("learner", [
    dict(partition_impl="scatter"), dict(partition_impl="compact"),
    dict(tree_learner="data", mesh_shape="4x1", mesh_devices=4),
    dict(tree_learner="data", mesh_shape="2x2", mesh_devices=4),
    dict(tree_learner="feature", mesh_shape="1x4", mesh_devices=4)])
def test_bundled_trees_and_model_text_equal_jax(conflict_rate, learner):
    x, y = _covtype_small(conflicts=0.05 if conflict_rate else 0.0)
    p = dict(BASE, max_conflict_rate=conflict_rate)
    bj = _train_jax(x, y, p, 4, 7)
    bt = _train_port(x, y, dict(p, **learner), 4, 7)
    assert bt.inner.meta.col is not None
    if "tree_learner" in learner:
        assert bt.inner.parallel_impl == "gspmd"
    assert bt.model_to_string() == bj.model_to_string()


def test_bundled_bagging_subset_and_dart_equal_jax():
    x, y = _covtype_small(seed=1)
    for extra in (dict(bagging_fraction=0.5, bagging_freq=1),
                  dict(boosting_type="dart", drop_seed=3, drop_rate=0.5)):
        p = dict(BASE, **extra)
        bj = _train_jax(x, y, p, 5, 11)
        bt = _train_port(x, y, p, 5, 11)
        if "bagging_fraction" in extra:
            assert bt.inner._subset is not None
        assert bt.model_to_string() == bj.model_to_string(), extra
        np.testing.assert_allclose(
            bt.inner.scores[0].numpy(), bt.predict(x, raw_score=True),
            rtol=0, atol=1e-5)


def test_bundled_valid_set_and_subset_keep_the_layout():
    x, y = _covtype_small(seed=2)
    xv, yv = _covtype_small(n=600, seed=3)
    tp = dict(BASE, device="cpu")
    dt = lt.Dataset(x, y, params=tp)
    vt = dt.create_valid(xv, yv)
    ev_t = {}
    bt = lt.train(tp, dt, 4, valid_sets=[vt], evals_result=ev_t,
                  fobj=_int_fobj(5), verbose_eval=False)
    dj = lj.Dataset(x, y, params=BASE)
    vj = dj.create_valid(xv, yv)
    ev_j = {}
    bj = lj.train(BASE, dj, 4, valid_sets=[vj], evals_result=ev_j,
                  fobj=_int_fobj(5), verbose_eval=False)
    assert vt.constructed.layout is dt.constructed.layout
    np.testing.assert_array_equal(vt.constructed.binned,
                                  np.asarray(vj.constructed.binned))
    assert bt.model_to_string() == bj.model_to_string()
    # the valid scores the training kept equal predict on its raw rows
    np.testing.assert_allclose(bt.inner.valid_sets[0].scores[0].numpy(),
                               bt.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)
    rows = np.arange(0, len(y), 3)
    st = dt.subset(rows).construct()
    assert st.constructed.layout is dt.constructed.layout
    np.testing.assert_array_equal(st.constructed.binned,
                                  dt.constructed.binned[rows])


def test_bundled_dataset_carried_across_from_jax():
    """``convert.dataset_from_arrays`` takes the JAX package's bundled
    matrix and layout: the port trains the JAX package's trees on it."""
    from lightgbm_tpu_torch import convert
    x, y = _covtype_small(seed=4)
    dj = lj.Dataset(x, y, params=BASE).construct()
    td = dj.constructed
    used = list(td.used_features)
    mappers = [td.bin_mappers[j] for j in used]
    ds = convert.dataset_from_arrays(
        np.asarray(td.binned), [m.num_bin for m in mappers],
        [m.missing_type for m in mappers], [m.default_bin for m in mappers],
        [m.bin_upper_bound for m in mappers], td.metadata.label,
        used_features=used, num_total_features=td.num_total_features,
        min_max=[(m.min_val, m.max_val) for m in mappers],
        params={"device": "cpu"}, bundles=td.layout.bundles)
    assert ds.constructed.layout.sub_col == td.layout.sub_col
    bt = lt.train(dict(BASE, device="cpu"), ds, 3, fobj=_int_fobj(9),
                  verbose_eval=False)
    bj = lj.train(BASE, dj, 3, fobj=_int_fobj(9), verbose_eval=False)
    assert bt.model_to_string() == bj.model_to_string()
