"""Gradients and hessians of the port's objectives against lightgbm_tpu's
on the same scores, for every objective of the registry (K > 1 for the
multiclass ones).  rtol 1e-6: the losses go through f32 exp, log1p and
softmax, whose last bits the two libraries may round differently.  A
hessian that cancels (the binary and OVA |r| * (sigmoid - |r|) where |r|
nears sigmoid, the softmax 2p(1 - p) where p nears 1, xentropy's z(1 - z)
where z nears 1) loses its relative precision, so it is held to two ulps
of the cancelling term, sigmoid^2 * 2^-22 absolute; the Gaussian hessian
of L1 and huber multiplies four rounded factors, so 4e-6 relative.  The
weighted xentlambda terms start from z = 1 - exp(-w log1p(exp(s))), three
f32 roundings, and then cancel in 1 - y / z and in 1 + y b, and
c = 1 / (1 - z) multiplies z's rounding by 1 / (1 - z) as z nears 1: they
are held to 1e-5 of the cancelling terms' scale plus the effect of four
ulps of z (:func:`_xentlambda_allowance`, in float64).

LambdaRank: ``lambdarank_grad_plain`` (the CPU path of the kernel's
wrapper) against ``LambdarankNDCG.get_gradients`` on queries of lengths 1,
2, 7 and 64, tied scores, an all-zero-label query, a query of equal
scores (degenerate) and weights: each document's g and h within 1e-5 of
the sum of |lam| (or |hes|) over its pairs plus 1e-7, the sums the two
libraries add in different orders."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.config import config_from_params as jax_config
from lightgbm_tpu.data.metadata import Metadata as JaxMetadata
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu_torch.data.metadata import Metadata
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops.lambdarank import (lambdarank_grad,
                                               lambdarank_grad_plain,
                                               lambdarank_tables)


def _pair(params, label, weight, group=None):
    n = len(label)
    jo = jax_objective(jax_config(params))
    jm = JaxMetadata(n)
    jm.set_label(label)
    jm.set_weight(weight)
    jm.set_query(group)
    jo.init(jm, n)
    to = create_objective(config_from_params(dict(params, device="cpu")))
    tm = Metadata(n)
    tm.set_label(label)
    tm.set_weight(weight)
    tm.set_query(group)
    to.init(tm, n, torch.device("cpu"))
    return jo, to


def _xentlambda_allowance(score, label, weight):
    """Allowed |difference| of the weighted xentlambda gradient and
    hessian: 1e-5 of their terms' scales, (1 + y / z) w / (1 + e^-s) and
    a (1 + |y b|), plus what four ulps of z (2^-22) move them by:
    |dg/dz| = y w / (z^2 (1 + e^-s)), and through c = 1 / (1 - z),
    |dh/dc| dc/dz = a y |1 + w e^s - 2c| / d^2 * c / (1 - z)."""
    s, y, w = (np.asarray(a, np.float64) for a in (score, label, weight))
    epf = np.exp(s)
    z = 1.0 - np.exp(-w * np.log1p(epf))
    c = 1.0 / (1.0 - z)
    d = 1.0 + epf
    a = w * epf / (d * d)
    b = (c / (d * d)) * (1.0 + w * epf + c)
    dz = 2.0 ** -22
    g_tol = (1e-5 * (1.0 + y / z) + y / (z * z) * dz) * w / (1.0 + 1.0 / epf)
    h_tol = a * (1e-5 * (1.0 + np.abs(y * b))
                 + y * np.abs(1.0 + w * epf - 2.0 * c) / (d * d)
                 * c / (1.0 - z) * dz)
    return g_tol, h_tol


def _labels(objective, rng, n):
    if objective in ("binary",):
        return (rng.random(n) < 0.3).astype(np.float32)
    if objective in ("multiclass", "multiclassova"):
        return rng.integers(0, 3, n).astype(np.float32)
    if objective in ("xentropy", "xentlambda"):
        return rng.random(n).astype(np.float32)
    if objective == "poisson":
        return rng.poisson(3.0, n).astype(np.float32)
    return rng.normal(2.0, 3.0, n).astype(np.float32)


@pytest.mark.parametrize("params,weighted", [
    ({"objective": "binary"}, False),
    ({"objective": "binary", "sigmoid": 2.0}, True),
    ({"objective": "binary", "is_unbalance": True}, False),
    ({"objective": "binary", "scale_pos_weight": 3.0}, False),
    ({"objective": "regression"}, False),
    ({"objective": "regression"}, True),
    ({"objective": "regression_l1"}, False),
    ({"objective": "regression_l1", "gaussian_eta": 0.5}, True),
    ({"objective": "huber"}, False),
    ({"objective": "huber", "huber_delta": 2.5}, True),
    ({"objective": "fair"}, False),
    ({"objective": "fair", "fair_c": 0.3}, True),
    ({"objective": "poisson"}, False),
    ({"objective": "poisson", "poisson_max_delta_step": 1.5}, True),
    ({"objective": "multiclass", "num_class": 3}, False),
    ({"objective": "multiclass", "num_class": 3}, True),
    ({"objective": "multiclassova", "num_class": 3}, False),
    ({"objective": "multiclassova", "num_class": 3, "sigmoid": 2.0}, True),
    ({"objective": "xentropy"}, False),
    ({"objective": "xentropy"}, True),
    ({"objective": "xentlambda"}, False),
    ({"objective": "xentlambda"}, True),
])
def test_gradients_match_jax(params, weighted):
    rng = np.random.default_rng(3)
    n = 4000
    label = _labels(params["objective"], rng, n)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    k = params.get("num_class", 1)
    score = rng.normal(0.0, 2.0, (k, n)).astype(np.float32)
    jo, to = _pair(params, label, weight)
    assert to.num_tree_per_iteration == jo.num_tree_per_iteration == k
    jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    tgt, tht = to.get_gradients(torch.from_numpy(score))
    # the growers read each class's row in place
    assert all(t[i].is_contiguous() for t in (tgt, tht) for i in range(k))
    tg, th = tgt.numpy(), tht.numpy()
    assert tg.shape == th.shape == (k, n)
    if params["objective"] == "xentlambda" and weighted:
        g_tol, h_tol = _xentlambda_allowance(score, label, weight)
        np.testing.assert_array_less(np.abs(tg - jg), g_tol + 1e-7)
        np.testing.assert_array_less(np.abs(th - jh), h_tol + 1e-7)
    else:
        np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-7)
        sig = params.get("sigmoid", 1.0)
        rtol_h = 4e-6 if params["objective"] in ("regression_l1",
                                                 "huber") else 1e-6
        np.testing.assert_allclose(th, jh, rtol=rtol_h,
                                   atol=sig * sig * 2.0 ** -22)
    assert to.boost_from_average == jo.boost_from_average
    assert to.to_string() == jo.to_string()
    if to.boost_from_average:
        assert to.average_stats() == jo.average_stats()
    np.testing.assert_allclose(to.convert_output(score[0]),
                               jo.convert_output(score[0]), rtol=1e-12)


def test_parse_objective_string_carries_num_class():
    from lightgbm_tpu_torch.objectives import parse_objective_string
    cfg = config_from_params({"device": "cpu"})
    obj = parse_objective_string("multiclass num_class:4", cfg)
    assert obj.num_tree_per_iteration == 4
    assert obj.to_string() == "multiclass num_class:4"


def _ranking_case(rng, sizes, tie_query=None, zero_query=None,
                  flat_query=None):
    """Labels 0-4 in each query, scores N(0, 1); one query's scores
    rounded to a grid of 0.5 (ties), one query all label 0, one query of
    equal scores (degenerate)."""
    n = int(sum(sizes))
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    label = rng.integers(0, 5, n).astype(np.float32)
    score = rng.normal(0.0, 1.0, n).astype(np.float32)
    for q, fix in ((tie_query, lambda s: np.round(s * 2) / 2),
                   (flat_query, lambda s: np.full_like(s, 0.25))):
        if q is not None:
            sl = slice(bounds[q], bounds[q + 1])
            score[sl] = fix(score[sl])
    if zero_query is not None:
        label[bounds[zero_query]:bounds[zero_query + 1]] = 0
    return label, score


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("sigmoid", [1.0, 2.0])
def test_lambdarank_plain_matches_jax(weighted, sigmoid):
    rng = np.random.default_rng(11)
    sizes = [1, 2, 7, 64, 7, 64, 2, 31]
    label, score = _ranking_case(rng, sizes, tie_query=3, zero_query=4,
                                 flat_query=5)
    n = len(label)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    params = {"objective": "lambdarank", "sigmoid": sigmoid}
    jo, to = _pair(params, label, weight, group=sizes)
    jg, jh = (np.asarray(a)[0] for a in jo.get_gradients(
        jnp.asarray(score[None])))
    tg, th = (a.numpy()[0] for a in to.get_gradients(
        torch.from_numpy(score[None])))
    # each document's sums of |lam| and |hes| over its pairs, weighted
    tm = Metadata(n)
    tm.set_label(label)
    tm.set_query(sizes)
    inv, gains, disc = lambdarank_tables(label, tm.query_boundaries, None,
                                         20)
    _, _, lam_abs, hes_abs = lambdarank_grad_plain(
        torch.from_numpy(score), torch.from_numpy(label.astype(np.int32)),
        tm.query_boundaries, torch.from_numpy(inv), torch.from_numpy(gains),
        torch.from_numpy(disc), sigmoid, abs_sums=True)
    w = weight if weighted else 1.0
    np.testing.assert_array_less(np.abs(tg - jg),
                                 1e-5 * lam_abs.numpy() * w + 1e-7)
    np.testing.assert_array_less(np.abs(th - jh),
                                 1e-5 * hes_abs.numpy() * w + 1e-7)
    # the single document, the all-zero-label query: no pair, no gradient
    b = tm.query_boundaries
    assert tg[0] == 0 and th[0] == 0
    assert not tg[b[4]:b[5]].any() and not th[b[4]:b[5]].any()
    assert np.abs(tg).max() > 1e-3


def test_lambdarank_chunking_does_not_change_the_gradients():
    """The plain version's chunks (queries in order of length, each run
    padded to its longest) only regroup the same per-query arithmetic:
    one query a chunk gives the same numbers up to the order of the sums
    over the padded row (rtol 1e-6, atol 1e-7)."""
    rng = np.random.default_rng(5)
    sizes = [3, 40, 1, 17, 40, 9]
    label, score = _ranking_case(rng, sizes, tie_query=1)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    inv, gains, disc = lambdarank_tables(label, bounds, None, 20)
    args = (torch.from_numpy(score), torch.from_numpy(label.astype(np.int32)),
            bounds, torch.from_numpy(inv), torch.from_numpy(gains),
            torch.from_numpy(disc), 1.0)
    g1, h1 = lambdarank_grad_plain(*args)
    one_each = [(np.asarray([q]), max(sizes[q], 1)) for q in range(6)]
    g2, h2 = lambdarank_grad_plain(*args, chunks=one_each)
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(h1, h2, rtol=1e-6, atol=1e-7)
    # the wrapper takes the plain version for CPU tensors
    g3, h3 = lambdarank_grad(*args[:2], torch.from_numpy(
        bounds.astype(np.int32)), *args[3:], max_len=40)
    torch.testing.assert_close(g1, g3, rtol=0, atol=0)
    assert lambdarank_grad.launches == 0
