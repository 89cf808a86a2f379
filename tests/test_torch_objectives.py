"""Gradients and hessians of the port's objectives against lightgbm_tpu's
on the same scores.  rtol 1e-6: the binary loss goes through an f32 exp,
whose last bit the two libraries may round differently.  The binary
hessian |r| * (sigmoid - |r|) cancels where |r| nears sigmoid, so one ulp
of r there is about sigmoid^2 * 2^-23 absolute: its atol is two such ulps."""
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


def _pair(params, label, weight):
    n = len(label)
    jo = jax_objective(jax_config(params))
    jm = JaxMetadata(n)
    jm.set_label(label)
    jm.set_weight(weight)
    jo.init(jm, n)
    to = create_objective(config_from_params(dict(params, device="cpu")))
    tm = Metadata(n)
    tm.set_label(label)
    tm.set_weight(weight)
    to.init(tm, n, torch.device("cpu"))
    return jo, to


@pytest.mark.parametrize("params,weighted", [
    ({"objective": "binary"}, False),
    ({"objective": "binary", "sigmoid": 2.0}, True),
    ({"objective": "binary", "is_unbalance": True}, False),
    ({"objective": "binary", "scale_pos_weight": 3.0}, False),
    ({"objective": "regression"}, False),
    ({"objective": "regression"}, True),
])
def test_gradients_match_jax(params, weighted):
    rng = np.random.default_rng(3)
    n = 4000
    if params["objective"] == "binary":
        label = (rng.random(n) < 0.3).astype(np.float32)
    else:
        label = rng.normal(2.0, 3.0, n).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    score = rng.normal(0.0, 2.0, (1, n)).astype(np.float32)
    jo, to = _pair(params, label, weight)
    jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    tg, th = (a.numpy() for a in to.get_gradients(torch.from_numpy(score)))
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-7)
    sig = params.get("sigmoid", 1.0)
    np.testing.assert_allclose(th, jh, rtol=1e-6, atol=sig * sig * 2.0 ** -22)
    assert to.boost_from_average == jo.boost_from_average
    assert to.to_string() == jo.to_string()
    if to.boost_from_average:
        assert to.average_stats() == jo.average_stats()
    np.testing.assert_allclose(to.convert_output(score[0]),
                               jo.convert_output(score[0]), rtol=1e-12)
