"""The non-finite guard (``nonfinite_policy``) against lightgbm_tpu.

Three cases under each policy (raise, rollback, clamp):

* a regression label that is NaN: every gradient row of it is NaN;
* weights drawn from {0, 1, 2} with ``min_sum_hessian_in_leaf=0``: a leaf
  of zero-weight rows has zero hessian and an infinite value;
* a custom objective of integer-valued gradients that returns one NaN at
  its third call only: a transient fault, which rollback recovers from.

The port grows each tree and reads it back before the next one, as the
JAX package's synchronous path does, so it is held against the JAX
package with ``pipeline_trees=false``: the same ``NonFiniteError``
message (stage, iteration and tree), or the same model text.  (With its
default delayed tree copy the JAX package does not raise under clamp on
a non-finite leaf of finite gradients: the delayed path only logs.)"""
import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

POLICIES = ("raise", "rollback", "clamp")


def _nan_label():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1000, 3))
    y = x[:, 0] + 0.1 * rng.standard_normal(1000)
    y[17] = np.nan
    return x, y, None, {}


def _zero_weights():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1500, 3))
    y = (x[:, 0] > 0).astype(float) + 0.1 * x[:, 1]
    w = rng.integers(0, 3, 1500).astype(float)
    return x, y, w, {"min_sum_hessian_in_leaf": 0, "min_data_in_leaf": 1}


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


def _run(pkg, case, policy, fobj=None, rounds=5):
    x, y, w, extra = case()
    p = dict(objective="regression", num_leaves=15, verbose=-1,
             nonfinite_policy=policy, **extra)
    p = dict(p, device="cpu") if pkg is lt else dict(p, pipeline_trees=False)
    try:
        bst = pkg.train(p, pkg.Dataset(x, y, weight=w, params=p), rounds,
                        fobj=fobj, verbose_eval=False)
    except pkg.NonFiniteError as e:
        return "raised", str(e)
    return "trained", bst


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", [_nan_label, _zero_weights])
def test_guard_on_the_two_cases_as_jax(case, policy):
    kj, oj = _run(lj, case, policy)
    kt, ot = _run(lt, case, policy)
    assert kt == kj
    if kj == "raised":
        assert ot == oj
    else:
        assert ot.model_to_string() == oj.model_to_string()


@pytest.mark.parametrize("policy", POLICIES)
def test_transient_fault_as_jax(policy):
    kj, oj = _run(lj, _nan_label_free, policy, fobj=_transient_fobj())
    kt, ot = _run(lt, _nan_label_free, policy, fobj=_transient_fobj())
    assert kt == kj
    if kj == "raised":
        assert ot == oj
        assert "iteration 2" in ot
        return
    assert ot.model_to_string() == oj.model_to_string()
    pred = ot.predict(_nan_label_free()[0])
    assert np.isfinite(pred).all()
    if policy == "rollback":    # the faulty iteration is retried once
        assert ot.inner._nf_rolled_iter == 2
        assert ot.current_iteration() == 4


def _nan_label_free():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1000, 3))
    return x, x[:, 0], None, {}


def test_no_trip_on_finite_training():
    x, y, _, _ = _nan_label_free()
    p = dict(objective="regression", device="cpu", verbose=-1,
             nonfinite_policy="rollback")
    bst = lt.train(p, lt.Dataset(x, y, params=p), 3)
    assert bst.inner._nf_event_iter is None
    assert bst.inner._nf_rolled_iter is None


def test_policy_checked_as_jax():
    x, y, _, _ = _nan_label_free()
    p = dict(objective="regression", device="cpu", nonfinite_policy="skip")
    with pytest.raises(RuntimeError, match="nonfinite_policy must be"):
        lt.train(p, lt.Dataset(x, y, params=p), 1)


def _multiclass_nan_fobj(k=3):
    """Integer-valued gradients for ``k`` classes with a NaN in every
    class's rows at the second and third calls."""
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(60 + calls[0])
        calls[0] += 1
        n = len(preds)
        g = rng.integers(-3, 4, n).astype(np.float64)
        h = rng.integers(1, 3, n).astype(np.float64)
        if calls[0] in (2, 3):
            g[5::n // k] = np.nan
        return g, h
    return fobj


def test_trips_counted_once_an_iteration():
    """Under clamp a multiclass iteration whose every class tree sees the
    NaN gradients is one trip, as the JAX package counts it
    (``_nf_event``): two tripped iterations, not six tripped trees."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((900, 3))
    y = rng.integers(0, 3, 900).astype(float)
    p = dict(objective="multiclass", num_class=3, num_leaves=7, verbose=-1,
             device="cpu", nonfinite_policy="clamp")
    bst = lt.train(p, lt.Dataset(x, y, params=p), 4,
                   fobj=_multiclass_nan_fobj(), verbose_eval=False)
    assert bst.inner.stats["trees"] == 12
    assert bst.inner.stats["nonfinite_trips"] == 2
    assert bst.inner._nf_event_iter == 2


def test_tree_and_flags_leave_in_one_copy(monkeypatch):
    """A tree's arrays and the guard's flags reach the host in one copy,
    field for field as their own copies would (odd lengths, so the fields
    lie unaligned in the one buffer)."""
    import torch
    from lightgbm_tpu_torch.boosting import _tree_to_host
    from lightgbm_tpu_torch.grower import TreeArrays
    rng = np.random.default_rng(4)
    L, B = 6, 7
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    i32 = lambda *s: torch.from_numpy(rng.integers(-9, 9, s).astype(
        np.int32))
    b8 = lambda *s: torch.from_numpy(rng.integers(0, 2, s).astype(bool))
    arrays = TreeArrays(L, i32(L - 1), i32(L - 1), b8(L - 1), i32(L - 1),
                        i32(L - 1), f32(L - 1), f32(L - 1), f32(L - 1),
                        f32(L), f32(L), i32(L), i32(L), b8(L - 1),
                        b8(L - 1, B))
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: (
        copies.append(t.numel()), real_cpu(t, *a, **k))[1])
    host, flags = _tree_to_host(arrays, torch.tensor(False),
                                torch.tensor(True))
    assert len(copies) == 1 and flags == [False, True]
    assert host.num_leaves == L
    for name, v in arrays._asdict().items():
        if isinstance(v, torch.Tensor):
            got = getattr(host, name)
            assert got.dtype == v.numpy().dtype and got.shape == v.shape
            np.testing.assert_array_equal(got, v.numpy(), err_msg=name)
