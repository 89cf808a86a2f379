"""The memory-driven planner and the placement walk, held against
lightgbm_tpu on the CPU, and their wiring in ``train``.

* The walk against the JAX package's: with the JAX package's
  ``obs/memory.predict_hbm`` put in place of the port's cost function
  (``parallel/mesh.predict_hbm``), the port's ``plan_mesh`` and
  ``resolve_placement`` return the same ``(data, feature,
  block_shard_bins)``, mode and block size as
  ``lightgbm_tpu.parallel.mesh``'s, and raise where they raise, over 1, 2,
  4 and 8 slots, each preference, 1 or 2 processes, budgets at, one byte
  under and one byte over every rung's predicted peak, ``data_stream``
  auto, resident and chunked, and an explicit and a default
  ``stream_chunk_rows``.  The decisions are compared exactly.
* The wiring: ``hbm_budget`` between the resident and the streamed peaks
  forces the streamed learner (whose integer-gradient model text is the
  explicit ``data_stream=chunked`` one), a budget past streaming hands the
  planned mesh to the data-parallel learner, a budget below every rung
  raises ``MeshPlanError`` before the Dataset's bins leave the host, an
  explicit budget over the prediction raises, ``mesh_shape=auto`` plans
  the mesh (block-sharded bins where only they fit), and DART and GOSS
  skip the walk.
"""
import inspect

import numpy as np
import pytest
import torch

from lightgbm_tpu.obs import memory as jax_memory
from lightgbm_tpu.parallel import mesh as jax_mesh
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs import memory
from lightgbm_tpu_torch.parallel import mesh as mesh_mod
from lightgbm_tpu_torch.parallel.mesh import MeshPlanError

_JAX_KEYS = set(inspect.signature(jax_memory.predict_hbm).parameters)


def jax_cost(**kw):
    """The JAX package's cost model, over the keywords it takes."""
    return jax_memory.predict_hbm(**{k: v for k, v in kw.items()
                                     if k in _JAX_KEYS})


SHAPES = {
    "higgs": dict(rows=1_000_000, features=28, bins=255, leaves=255),
    "mslr": dict(rows=2_270_296, features=137, bins=255, leaves=255,
                 valid_rows=241_521, packed_cols=70),
}


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except (MeshPlanError, jax_mesh.MeshPlanError) as e:
        return type(e).__name__


def _mesh_budgets(n, shape):
    """Capacities at, just under and just over each candidate's peak."""
    out = [None]
    for d, f in jax_mesh._mesh_factorizations(n):
        for block in (False, True) if f > 1 else (False,):
            p = jax_memory.predict_hbm(data_shards=d, feature_shards=f,
                                       block_shard_bins=block, **shape)
            peak = int(p["peak_bytes"])
            out += [peak - 1, peak, peak + 1]
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("procs", [1, 2])
@pytest.mark.parametrize("prefer", ["data", "feature", "square"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_plan_mesh_decides_as_the_jax_planner(monkeypatch, shape, procs,
                                              prefer, n):
    monkeypatch.setattr(mesh_mod, "predict_hbm", jax_cost)
    kw = SHAPES[shape]
    local = max(1, n // procs)
    for cap in _mesh_budgets(n, kw):
        a = _outcome(mesh_mod.plan_mesh, n, capacity=cap, prefer=prefer,
                     procs=procs, local_devices=local, **kw)
        b = _outcome(jax_mesh.plan_mesh, n, capacity=cap, prefer=prefer,
                     procs=procs, local_devices=local, **kw)
        if isinstance(b, str):
            assert a == b, (cap, a, b)
            continue
        assert (a.data, a.feature, a.block_shard_bins,
                a.per_device_bytes) == (b.data, b.feature,
                                        b.block_shard_bins,
                                        b.per_device_bytes), cap
        assert a.reason == b.reason


def _placement_budgets(kw, chunk_rows, n):
    """Capacities around the resident peak, every streamed block size
    down to the floor, and the mesh rung's candidates."""
    out = [None]
    peaks = [jax_memory.predict_hbm(**kw)["peak_bytes"]]
    chunk = jax_mesh.default_chunk_rows(kw["rows"], chunk_rows)
    while True:
        peaks.append(jax_memory.predict_hbm(stream_chunk_rows=chunk,
                                            **kw)["peak_bytes"])
        if chunk <= 4096:
            break
        chunk = max(4096, chunk // 2)
    for d, f in jax_mesh._mesh_factorizations(n):
        for block in (False, True) if f > 1 else (False,):
            peaks.append(jax_memory.predict_hbm(
                data_shards=d, feature_shards=f, block_shard_bins=block,
                **kw)["peak_bytes"])
    for p in peaks:
        out += [int(p) - 1, int(p), int(p) + 1]
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("chunk_rows", [0, 100_000], ids=["default",
                                                         "explicit"])
@pytest.mark.parametrize("stream", ["auto", "resident", "chunked"])
@pytest.mark.parametrize("n", [1, 4])
def test_resolve_placement_decides_as_the_jax_walk(monkeypatch, shape,
                                                   chunk_rows, stream, n):
    monkeypatch.setattr(mesh_mod, "predict_hbm", jax_cost)
    kw = SHAPES[shape]
    for cap in _placement_budgets(kw, chunk_rows, n):
        common = dict(capacity=cap, data_stream=stream,
                      stream_chunk_rows=chunk_rows, n_devices=n,
                      prefer="data", local_devices=n, **kw)
        a = _outcome(mesh_mod.resolve_placement, **common)
        b = _outcome(jax_mesh.resolve_placement, **common)
        if isinstance(b, str):
            assert a == b, (cap, a, b)
            continue
        assert (a.mode, a.chunk_rows, a.peak_bytes) == (
            b.mode, b.chunk_rows, b.peak_bytes), cap
        assert (a.mesh is None) == (b.mesh is None)
        if a.mesh is not None:
            assert (a.mesh.data, a.mesh.feature,
                    a.mesh.block_shard_bins) == (b.mesh.data, b.mesh.feature,
                                                 b.mesh.block_shard_bins)
        assert a.reason == b.reason


# ---- the wiring ---------------------------------------------------------------


def _task(n=4000, f=6, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f))
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.4 * rng.standard_normal(n) > 0
         ).astype(np.float32)
    return x, y


BASE = dict(objective="binary", device="cpu", verbose=-1, num_leaves=15,
            min_data_in_leaf=5, enable_bin_packing=False)


def _layout(x, y, **kw):
    """The memory model's keywords of a training of these params."""
    p = dict(BASE, **kw)
    return lt.train(p, lt.Dataset(x, y, params=p), 1).inner.plan.layout


def _peak(layout, **kw):
    return int(mesh_mod.predict_hbm(**dict(layout, **kw))["peak_bytes"])


def _integer_model(x, y, **kw):
    """Model text of 2 rounds under integer-valued gradients (exact sums
    in any order)."""
    def fobj(preds, data):
        return (np.round(4 * (preds - data.get_label())),
                np.ones_like(preds))
    p = dict(BASE, objective="regression", **kw)
    bst = lt.train(p, lt.Dataset(x, y, params=p), 2, fobj=fobj)
    return bst, bst.model_to_string()


def test_budget_between_resident_and_streamed_forces_chunked():
    x, y = _task()
    layout = _layout(x, y)
    res = _peak(layout)
    chunk = mesh_mod.default_chunk_rows(len(y))
    streamed = _peak(layout, stream_chunk_rows=chunk)
    assert streamed < res
    budget = (res + streamed) // 2
    bst, text = _integer_model(x, y, hbm_budget=budget)
    inner = bst.inner
    assert inner.placement.mode == "chunked"
    assert inner.placement.chunk_rows == chunk
    assert inner.plan.learner == "streamed" and inner._streamer is not None
    assert inner.plan.prediction["peak_bytes"] <= budget
    _, want = _integer_model(x, y, data_stream="chunked")
    assert text.split("parameters:")[0] == want.split("parameters:")[0]
    # no budget on the CPU: no capacity, resident
    none, _ = _integer_model(x, y)
    assert none.inner.placement.mode == "resident"
    assert "no capacity signal" in none.inner.placement.reason


def _toy_cost(**kw):
    """A cost by which each rung is cheaper than the last: 100 bytes
    resident, 80 streamed at any block size, 100 / (slots) sharded."""
    slots = kw.get("data_shards", 1) * kw.get("feature_shards", 1)
    peak = 80 if kw.get("stream_chunk_rows") else 100 // slots
    return {"residents": {"toy": peak}, "transients": {},
            "resident_bytes": peak, "transient_bytes": 0, "peak_bytes": peak}


def test_budget_past_streaming_shards_over_the_planned_mesh(monkeypatch):
    """On the CPU every slot shares the one device, so no mesh lowers the
    port's per-card peak; under a cost by which sharding does, a budget
    under every streamed block size hands the planned mesh to the
    data-parallel learner, whose integer-gradient model is the serial
    one."""
    x, y = _task()
    monkeypatch.setattr(mesh_mod, "predict_hbm", _toy_cost)
    bst, text = _integer_model(x, y, hbm_budget=50, mesh_devices=4)
    inner = bst.inner
    assert inner.placement.mode == "sharded"
    assert inner.placement.reason.startswith("sharded: 4x1 mesh")
    assert inner.plan.learner == "gspmd" and inner._gspmd is not None
    assert (inner.mesh_plan.data, inner.mesh_plan.feature) == (4, 1)
    monkeypatch.undo()
    _, want = _integer_model(x, y)
    assert text.split("parameters:")[0] == want.split("parameters:")[0]


def test_budget_below_every_rung_raises_before_the_bins_move():
    x, y = _task()
    p = dict(BASE, hbm_budget=1000, mesh_devices=4)
    ds = lt.Dataset(x, y, params=p)
    with pytest.raises(MeshPlanError, match="no data placement fits"):
        lt.train(p, ds, 1)
    # binned on the host; the bin matrix never reached a device tensor
    assert ds.constructed is not None and ds.bins is None


@pytest.mark.parametrize("boosting", ["dart", "goss"])
def test_dart_and_goss_skip_the_walk(boosting):
    x, y = _task()
    layout = _layout(x, y)
    res = _peak(layout)
    extra = dict(boosting_type=boosting, drop_seed=3)
    # below the resident peak: no streamed rung is tried, the pre-flight
    # refuses with the model's components
    with pytest.raises(RuntimeError, match="hbm_budget"):
        lt.train(dict(BASE, hbm_budget=res // 2, **extra),
                 lt.Dataset(x, y, params=BASE), 1)
    p = dict(BASE, hbm_budget=4 * res, **extra)
    bst = lt.train(p, lt.Dataset(x, y, params=p), 2)
    assert bst.inner.placement is None and bst.inner.plan.learner == "serial"


def test_mesh_auto_plans_block_sharded_bins_where_only_they_fit():
    """``mesh_shape=auto`` over 4 slots: the preferred 4x1 with no budget;
    with the budget at the 2x2 block-sharded peak, the first shape in the
    walk that fits, as ``plan_mesh`` finds it."""
    x, y = _task(f=8)
    kw = dict(tree_learner="data", mesh_devices=4)
    p = dict(BASE, **kw)
    bst = lt.train(p, lt.Dataset(x, y, params=p), 1)
    plan = bst.inner.mesh_plan
    assert (plan.data, plan.feature, plan.block_shard_bins) == (4, 1, False)
    assert "no capacity signal" in plan.reason
    layout = dict(bst.inner.plan.layout)
    for k in ("data_shards", "feature_shards", "block_shard_bins"):
        layout.pop(k)
    peaks = {(d, f, b): _peak(layout, data_shards=d, feature_shards=f,
                              block_shard_bins=b)
             for d, f, b in ((4, 1, False), (2, 2, False), (2, 2, True),
                             (1, 4, False), (1, 4, True))}
    budget = peaks[(2, 2, True)]
    want = mesh_mod.plan_mesh(4, capacity=budget, **layout)
    p = dict(p, hbm_budget=budget)
    bst = lt.train(p, lt.Dataset(x, y, params=p), 2)
    got = bst.inner.mesh_plan
    assert (got.data, got.feature, got.block_shard_bins) == (
        want.data, want.feature, want.block_shard_bins)
    assert bst.inner.plan.prediction["peak_bytes"] <= budget
    assert got.block_shard_bins == (bst.inner._gspmd.route_bins is None)


def test_explicit_budget_over_the_prediction_raises():
    x, y = _task()
    p = dict(BASE, tree_learner="data", mesh_devices=2, mesh_shape="2x1",
             hbm_budget=1000)
    with pytest.raises(RuntimeError, match="exceeds hbm_budget"):
        lt.train(p, lt.Dataset(x, y, params=p), 1)


def test_capacity_is_none_on_the_cpu_and_preflight_warns(caplog):
    assert memory.device_capacity(torch.device("cpu")) is None
    pred = memory.predict_hbm(rows=1000, features=4)
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        out = memory.preflight(pred, 0, "t", capacity=10)
    assert out["verdict"] == "over_capacity" and "exceeds" in caplog.text
    assert memory.preflight(pred, 0, "t")["verdict"] == "ok"
