"""The port's voting learner (``tree_learner=voting``) against
lightgbm_tpu's ``VotingStrategy`` (PV-Tree): four mesh slots on the port's
side (``mesh_devices=4`` CPU slots, a 4x1 mesh), four of the eight virtual
CPU devices of tests/conftest.py on the JAX side.

* The grower under integer weights, whose sums are exact in any order:
  every TreeArrays field and the row -> leaf map identical to the JAX
  learner's, with ``top_k`` below the feature count, with missing values,
  with categorical columns, and on a tie that ``torch.topk`` would order
  otherwise (four identical columns: every voter's gains tie, and the
  lower feature index must win, as in ``lax.top_k``).  With ``top_k`` at
  least the feature count every feature is voted, and the tree is the
  data-parallel learner's.
* ``train`` under a custom objective of integer gradients: the model text
  identical to the JAX package's with EFB bundles (each voter expands its
  bundles with its own sums before it votes) and with the local gates
  divided by the voters (tests/test_parallel.py:164-208's case, where
  undivided gates stop the tree early); under the binary objective's float
  gradients, raw scores within 1e-5.
* ``parallel_impl``: resolved as the JAX package resolves it, a forced
  ``gspmd`` downgraded loudly to ``shardmap`` with a ``downgrades`` record.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.grower import FeatureMeta as JaxMeta
from lightgbm_tpu.grower import GrowerConfig as JaxGrowerConfig
from lightgbm_tpu.parallel import mesh as jax_mesh
from lightgbm_tpu.parallel.learner import make_distributed_grower
from lightgbm_tpu_torch.boosting import resolve_parallel_impl
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu_torch.grower import FeatureMeta, GrowerConfig
from lightgbm_tpu_torch.parallel.gspmd import GspmdGrower
from lightgbm_tpu_torch.parallel.learner import _top
from lightgbm_tpu_torch.parallel.mesh import make_named_mesh, mesh_slots

N, F, B, L = 4096, 8, 32, 15
VOTERS = 4
CPU4 = mesh_slots(VOTERS, torch.device("cpu"))
t = torch.from_numpy


def _args(seed, tie=False):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(N, F)).astype(np.uint8)
    if tie:
        bins[:, 1:4] = bins[:, :1]         # columns 0-3 identical
    g = rng.randint(-8, 9, size=N).astype(np.float32)
    h = rng.randint(1, 9, size=N).astype(np.float32)
    return bins, g, h, np.ones(N, np.float32)


CASES = {
    # name: (grower knobs, missing, categorical columns, seed, top_k)
    "top_k_below_f": (dict(), False, 0, 0, 2),
    "missing": (dict(has_missing=True), True, 0, 3, 3),
    "tie": (dict(), False, 0, 5, 1),
    "categorical": (dict(has_categorical=True, max_cat_threshold=16),
                    False, 3, 11, 2),
    "every_feature": (dict(), False, 0, 7, 20),
    "every_feature_categorical": (
        dict(has_categorical=True, max_cat_threshold=16), False, 3, 13, 20),
}


def _case(case):
    return CASES[case]


def _kw(case):
    return dict(dict(num_leaves=L, min_data_in_leaf=8, max_bin=B,
                     has_missing=False), **_case(case)[0])


def _meta_np(case):
    missing, cat = _case(case)[1:3]
    return (np.full(F, B, np.int32), np.full(F, 2 if missing else 0, np.int32),
            np.zeros(F, np.int32),
            np.asarray([True] * cat + [False] * (F - cat)))


def _jax_voting(case):
    seed, top_k = CASES[case][3:5]
    bins, g, h, c = _args(seed, tie=case == "tie")
    mesh = jax_mesh.make_mesh(VOTERS, "data")
    grow = make_distributed_grower(JaxGrowerConfig(**_kw(case)), mesh,
                                   "voting", top_k)
    tree, row_leaf = grow(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
                          jnp.asarray(c),
                          JaxMeta(*[jnp.asarray(a) for a in _meta_np(case)]),
                          jnp.ones((F,), bool))
    return {k: np.asarray(v) for k, v in tree._asdict().items()}, \
        np.asarray(row_leaf)


def _port(case, top_k="case"):
    seed, k = _case(case)[3:5]
    bins, g, h, c = _args(seed, tie=case == "tie")
    grower = GspmdGrower(GrowerConfig(**_kw(case)),
                         make_named_mesh(VOTERS, 1, CPU4), t(bins), "flat",
                         top_k=k if top_k == "case" else top_k)
    tree, row_leaf = grower(t(g), t(h), t(c),
                            FeatureMeta(*[t(a) for a in _meta_np(case)]),
                            torch.ones(F, dtype=torch.bool))
    return tree, row_leaf


def _assert_same(tree, row_leaf, jtree, jrow, what):
    assert int(tree.num_leaves) == int(jtree["num_leaves"]) > 2, what
    for name in tree._fields:
        if name == "num_leaves":
            continue
        np.testing.assert_array_equal(getattr(tree, name).numpy(),
                                      jtree[name], err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(row_leaf.numpy(), jrow,
                                  err_msg=f"{what}: row_leaf")


@pytest.mark.parametrize("case", sorted(CASES))
def test_voting_tree_identical_to_jax(case):
    jtree, jrow = _jax_voting(case)
    tree, row_leaf = _port(case)
    _assert_same(tree, row_leaf, jtree, jrow, case)
    if "categorical" in case:
        assert bool(tree.is_cat[:int(tree.num_leaves) - 1].any())
    if case == "tie":
        # the tied columns' lowest index wins wherever one of them splits
        used = set(tree.split_feature[:int(tree.num_leaves) - 1].tolist())
        assert 0 in used and not used & {1, 2, 3}


@pytest.mark.parametrize("case", ["every_feature",
                                  "every_feature_categorical"])
def test_every_feature_voted_is_the_data_parallel_tree(case):
    """``top_k`` 20 over 8 features: every feature is voted and summed,
    so the tree is the data-parallel learner's."""
    tree, row_leaf = _port(case)
    bins, g, h, c = _args(_case(case)[3])
    dp, dp_leaf = GspmdGrower(GrowerConfig(**_kw(case)),
                              make_named_mesh(VOTERS, 1, CPU4), t(bins),
                              "flat")(t(g), t(h), t(c),
                                      FeatureMeta(*[t(a) for a in _meta_np(
                                          case)]),
                                      torch.ones(F, dtype=torch.bool))
    assert int(tree.num_leaves) == int(dp.num_leaves) > 2
    for name in tree._fields[1:]:
        assert torch.equal(getattr(tree, name), getattr(dp, name)), name
    assert torch.equal(row_leaf, dp_leaf)


def test_top_orders_ties_as_lax_top_k():
    """The stable descending sort: among equal values the lower index
    first, ``-inf`` last (``lax.top_k``'s order)."""
    x = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, 2.0],
                      [float("-inf")] * 6])
    np.testing.assert_array_equal(_top(x, 4).numpy(),
                                  [[1, 2, 4, 5], [0, 1, 2, 3]])


# ---- train() against lightgbm_tpu.train ------------------------------------


def _int_fobj(seed):
    """Integer-valued gradients and hessians, the same sequence in both
    packages: exact sums in any order."""
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(seed + calls[0])
        calls[0] += 1
        n = len(preds)
        return (rng.integers(-3, 4, n).astype(np.float64),
                rng.integers(1, 4, n).astype(np.float64))
    return fobj


def _bundled_problem(n=3000, groups=3, cats=6, dense=2, seed=7):
    """One-hot blocks that EFB bundles, beside dense columns
    (tests/test_parallel.py:_bundled_problem)."""
    rng = np.random.RandomState(seed)
    cols, logits = [], np.zeros(n)
    for _ in range(groups):
        which = rng.randint(0, cats, size=n)
        block = np.zeros((n, cats))
        block[np.arange(n), which] = rng.rand(n) + 0.5
        logits += rng.randn(cats)[which]
        cols.append(block)
    xd = rng.randn(n, dense)
    logits += xd @ rng.randn(dense)
    x = np.column_stack(cols + [xd])
    return x, (logits + 0.3 * rng.randn(n) > 0).astype(np.float64)


def _higgs_like(n=7000, f=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f))
    z = x[:, 0] + 0.5 * x[:, 1] - 0.3 * x[:, 2] * x[:, 3] + 0.2 * x[:, 4]
    return x, (z + 0.5 * rng.standard_normal(n) > 0).astype(np.float64)


def _both(params, x, y, rounds, fobj_seed=None):
    jp = dict(params, mesh_devices=VOTERS)
    tp = dict(params, mesh_devices=VOTERS, mesh_shape=f"{VOTERS}x1",
              device="cpu")
    kw = dict(verbose_eval=False)
    bj = lj.train(jp, lj.Dataset(x, y, params=jp), rounds,
                  fobj=None if fobj_seed is None else _int_fobj(fobj_seed),
                  **kw)
    bt = lt.train(tp, lt.Dataset(x, y, params=tp), rounds,
                  fobj=None if fobj_seed is None else _int_fobj(fobj_seed),
                  **kw)
    return bj, bt


VOTE = dict(objective="regression", tree_learner="voting", num_leaves=15,
            min_data_in_leaf=5, verbose=-1)


def test_bundles_expanded_locally_model_identical_to_jax():
    x, y = _bundled_problem()
    bj, bt = _both(dict(VOTE, top_k=3), x, y, 3, fobj_seed=21)
    assert bt.inner.train_set.bundled and bj.inner.train_set.layout is not None
    assert bt.inner.parallel_impl == "shardmap" == bj.inner._parallel_impl
    assert bt.model_to_string() == bj.model_to_string()


def test_local_gates_divided_by_the_voters():
    """min_data_in_leaf=320 over 4 voters of about 1,750 rows: each voter
    scans under 80, as in the JAX package (:223-237); undivided, a voter
    could vote for nothing below the first levels.  The model text is the
    JAX package's, and the first tree grows about as far as the serial
    learner's."""
    x, y = _higgs_like()
    extra = dict(min_data_in_leaf=320, num_leaves=12)
    bj, bt = _both(dict(VOTE, top_k=4, **extra), x, y, 2, fobj_seed=31)
    assert bt.model_to_string() == bj.model_to_string()
    pool = bt.inner._gspmd.pool
    assert pool.local_scfg.min_data_in_leaf == 80
    assert pool.local_scfg.min_sum_hessian_in_leaf == pytest.approx(
        VOTE.get("min_sum_hessian_in_leaf", 1e-3) / VOTERS)
    ps = dict(VOTE, tree_learner="serial", device="cpu", **extra)
    bs = lt.train(ps, lt.Dataset(x, y, params=ps), 1, fobj=_int_fobj(31),
                  verbose_eval=False)
    leaves_s = bs.inner.models[-1].num_leaves
    assert leaves_s > 6
    assert bt.inner.models[1].num_leaves >= leaves_s - 2


def test_float_gradients_within_1e5_of_jax():
    x, y = _higgs_like(n=4000, seed=3)
    p = dict(VOTE, objective="binary", top_k=3)
    bj, bt = _both(p, x, y, 2)
    np.testing.assert_allclose(bt.predict(x, raw_score=True),
                               bj.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("learner,impl,procs,resolved,downgraded", [
    ("voting", "gspmd", 1, "shardmap", True),
    ("voting", "auto", 1, "shardmap", False),
    ("data", "auto", 1, "gspmd", False),
    ("data", "shardmap", 1, "shardmap", False),
    ("feature", "gspmd", 2, "shardmap", True),
    ("feature", "auto", 2, "shardmap", False),
    ("feature", "auto", 1, "gspmd", False),
])
def test_parallel_impl_resolves_as_jax(learner, impl, procs, resolved,
                                       downgraded):
    """lightgbm_tpu/boosting.py:453-497: voting, and the feature learner
    over several processes, keep the shard_map learner; a forced gspmd
    there is a loud downgrade with a record."""
    cfg = config_from_params(dict(tree_learner=learner, parallel_impl=impl,
                                  device="cpu"))
    got, downgrades = resolve_parallel_impl(cfg, procs)
    assert got == resolved
    assert [(d["requested"], d["resolved"]) for d in downgrades] == (
        [("parallel_impl=gspmd", "shardmap")] if downgraded else [])


def test_forced_gspmd_voting_downgrades_loudly(caplog):
    x, y = _higgs_like(n=2000)
    p = dict(VOTE, parallel_impl="gspmd", top_k=3, verbose=0)
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        bj, bt = _both(p, x, y, 1, fobj_seed=41)
    assert "falling back to shard_map" in caplog.text
    assert bt.inner.parallel_impl == "shardmap" == bj.inner._parallel_impl
    assert bt.inner.downgrades == [{
        "requested": "parallel_impl=gspmd", "resolved": "shardmap",
        "reason": "voting learner needs explicit vote collectives"}]
    assert bt.model_to_string() == bj.model_to_string()
