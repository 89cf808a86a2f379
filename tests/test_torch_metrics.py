"""Every metric of the port against lightgbm_tpu's on the same scores,
labels, weights and queries, float64 on both sides.

Both packages evaluate on the host in numpy float64 with the same
formulas, so values agree to rtol 1e-12 (the port's AUC adds its groups
of equal scores in a vectorised order, the JAX package in a loop).  The
transforms come from each package's own objective of the same kind."""
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import config_from_params as jax_config
from lightgbm_tpu.data.metadata import Metadata as JaxMetadata
from lightgbm_tpu.metrics import create_metric as jax_metric
from lightgbm_tpu.metrics import \
    default_metric_for_objective as jax_default_metric
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_tpu_torch.config import SUPPORTED_OBJECTIVES, config_from_params
from lightgbm_tpu_torch.data.metadata import Metadata
from lightgbm_tpu_torch.metrics import _REGISTRY, create_metric
from lightgbm_tpu_torch.metrics import default_metric_for_objective
from lightgbm_tpu_torch.objectives import create_objective

N = 600
SIZES = [1, 5, 60, 34, 100, 200, 200]      # query sizes, sum N

# metric -> (objective whose transform it reads, label kind)
CASES = {
    "l2": (None, "real"), "rmse": (None, "real"), "l1": (None, "real"),
    "huber": (None, "real"), "fair": (None, "real"),
    "poisson": ("poisson", "count"),
    "binary_logloss": ("binary", "binary"),
    "binary_error": ("binary", "binary"), "auc": (None, "binary"),
    "multi_logloss": ("multiclass", "class"),
    "multi_error": ("multiclass", "class"),
    "xentropy": ("xentropy", "prob"), "xentlambda": ("xentlambda", "prob"),
    "kldiv": (None, "prob"), "ndcg": (None, "rank"), "map": (None, "rank"),
}


def _labels(kind, rng):
    return {"real": lambda: rng.normal(1.0, 2.0, N),
            "count": lambda: rng.poisson(2.0, N),
            "binary": lambda: rng.random(N) < 0.4,
            "class": lambda: rng.integers(0, 3, N),
            "prob": lambda: rng.random(N),
            "rank": lambda: rng.integers(0, 5, N)}[kind]().astype(np.float32)


def _metadata(cls, label, weight, group):
    m = cls(N)
    m.set_label(label)
    m.set_weight(weight)
    m.set_query(group)
    return m


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_matches_jax(name, weighted):
    rng = np.random.default_rng(7)
    obj_name, kind = CASES[name]
    params = {"ndcg_eval_at": [1, 3, 10], "huber_delta": 0.7, "fair_c": 0.5}
    if obj_name is not None:
        params["objective"] = obj_name
    if obj_name == "multiclass":
        params["num_class"] = 3
    label = _labels(kind, rng)
    weight = rng.uniform(0.5, 2.0, N).astype(np.float32) if weighted else None
    group = SIZES if kind == "rank" else None
    k = params.get("num_class", 1)
    score = rng.normal(0.0, 1.5, (k, N))
    if kind == "rank":      # ties inside a query
        score[0, 60:90] = np.round(score[0, 60:90])
    jcfg = jax_config(params)
    tcfg = config_from_params(dict(params, device="cpu"))
    jm = _metadata(JaxMetadata, label, weight, group)
    tm = _metadata(Metadata, label, weight, group)
    jobj = tobj = None
    if obj_name is not None:
        jobj, tobj = jax_objective(jcfg), create_objective(tcfg)
        jobj.init(jm, N)
        tobj.init(tm, N, torch.device("cpu"))
    jmet, tmet = jax_metric(name, jcfg), create_metric(name, tcfg)
    jmet.init(jm, N)
    tmet.init(tm, N)
    assert tmet.names() == jmet.names()
    assert tmet.is_higher_better == jmet.is_higher_better
    want = jmet.eval(score, jobj)
    got = tmet.eval(score, tobj)
    assert len(got) == len(tmet.names())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_metric_aliases_match_jax():
    from lightgbm_tpu.metrics import _REGISTRY as jax_registry
    assert sorted(_REGISTRY) == sorted(jax_registry)
    for alias, cls in _REGISTRY.items():
        assert cls.name == jax_registry[alias].name, alias


def test_default_metric_matches_jax():
    for objective in SUPPORTED_OBJECTIVES:
        assert (default_metric_for_objective(objective)
                == jax_default_metric(objective)), objective


def test_unknown_metric_raises():
    with pytest.raises(RuntimeError, match="Unknown metric"):
        create_metric("no_such_metric", config_from_params({"device": "cpu"}))
