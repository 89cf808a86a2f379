"""The port's parameter table against the JAX package's ``Config``, and the
one recorded divergence in how the two read parameters.

Every field and alias of ``lightgbm_tpu.config.Config`` gets exactly one
outcome in the port: ported (a field of the port's ``Config``) or taken
as-is (accepted with any value and dropped).  Unknown keys still raise
``Unknown parameter``.

``categorical_feature`` given in ``params``: the port reads it, as
LightGBM does and as both alias tables declare; the JAX package declares
it and reads it nowhere, so the same script trains categorical splits on
the port and numerical ones on the JAX package.  Through the Dataset
argument both train the same trees."""
import dataclasses

import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import config as jc
from lightgbm_tpu_torch import config as tc

JAX_FIELDS = {f.name: f for f in dataclasses.fields(jc.Config)}
PORT_FIELDS = {f.name for f in dataclasses.fields(tc.Config)}


def _outcome(key):
    key = tc.PARAM_ALIASES.get(key, key)
    return [name for name, hit in (
        ("ported", key in PORT_FIELDS), ("as-is", key in tc.TAKEN_AS_IS))
        if hit]


def _jax_default(name):
    f = JAX_FIELDS[name]
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return f.default


def _other_value(default):
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 1
    if isinstance(default, list):
        return ["x"]
    return f"{default}x"


def test_alias_table_is_the_jax_table():
    assert tc.PARAM_ALIASES == jc.PARAM_ALIASES


@pytest.mark.parametrize("key",
                         sorted(set(JAX_FIELDS) | set(jc.PARAM_ALIASES)))
def test_every_jax_key_has_exactly_one_outcome(key):
    assert len(_outcome(key)) == 1, (key, _outcome(key))


def test_no_port_field_outside_the_jax_config():
    assert PORT_FIELDS <= set(JAX_FIELDS)


@pytest.mark.parametrize("key", sorted(tc.TAKEN_AS_IS - {"objective_seed"}))
def test_taken_as_is_accepts_any_value(key):
    value = _other_value(_jax_default(key))
    cfg = tc.config_from_params({key: value})
    assert not hasattr(cfg, key)


def test_ported_keys_read_as_jax():
    x = np.random.default_rng(0).standard_normal((400, 4))
    y = (x[:, 0] > 0).astype(np.float32)
    # the keys that stopped ordinary scripts before they started
    p = dict(objective="binary", device="cpu", verbose=-1, num_threads=4,
             nthread=2, seed=7, random_seed=1, sparse_threshold=1.0,
             metric_freq=1, histogram_pool_size=128,
             saved_feature_importance_type=1)
    # one round: the first tree's binary sums are exact, so are its gains
    bst = lt.train(p, lt.Dataset(x, y, params=p), 1)
    jp = {k: v for k, v in p.items() if k != "device"}
    bj = lj.train(jp, lj.Dataset(x, y, params=jp), 1, verbose_eval=False)
    imp_t = bst.model_to_string().split("feature importances:")[1]
    imp_j = bj.model_to_string().split("feature importances:")[1]
    assert imp_t.strip() == imp_j.strip()
    assert "." in imp_t          # total gain, at full precision


def test_unknown_key_still_rejected():
    with pytest.raises(ValueError, match="Unknown parameter"):
        tc.config_from_params({"nonsense": 3})


def _cat_task(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5))
    x[:, 3] = rng.integers(0, 12, n)
    x[:, 4] = rng.integers(0, 7, n)
    z = x[:, 0] + np.where(np.isin(x[:, 3], [2, 5, 9]), 1.5, -0.5) \
        + 0.3 * (x[:, 4] % 3)
    y = (z + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    return x, y


def _first_tree(model_str):
    return model_str.split("Tree=")[1].split("\n\n")[0]


def test_categorical_params_divergence_from_jax():
    """ROADMAP fault 3.3: ``categorical_feature`` in params trains
    categorical splits in the port and numerical ones in the JAX package;
    given through the Dataset, both trees are the same (the first tree's
    binary sums are exact)."""
    x, y = _cat_task()
    p = dict(objective="binary", num_leaves=15, verbose=-1,
             categorical_feature="3,4")
    tp = dict(p, device="cpu")
    bt = lt.train(tp, lt.Dataset(x, y, params=tp), 1)
    bj = lj.train(p, lj.Dataset(x, y, params=p), 1, verbose_eval=False)
    assert bt.inner.models[-1].num_cat > 0
    assert bj.inner.models[-1].num_cat == 0
    q = {k: v for k, v in p.items() if k != "categorical_feature"}
    tq = dict(q, device="cpu")
    bt = lt.train(tq, lt.Dataset(x, y, params=tq, categorical_feature=[3, 4]),
                  1)
    bj = lj.train(q, lj.Dataset(x, y, params=q, categorical_feature=[3, 4]),
                  1, verbose_eval=False)
    assert bt.inner.models[-1].num_cat > 0
    assert _first_tree(bt.model_to_string()) == \
        _first_tree(bj.model_to_string())


# the keys that the prediction and Dataset API slice moved out of
# NOT_PORTED
MOVED = ("is_save_binary_file", "is_predict_raw_score",
         "is_predict_leaf_index", "pred_early_stop", "pred_early_stop_freq",
         "pred_early_stop_margin", "has_header", "use_two_round_loading")


@pytest.mark.parametrize("key", sorted(
    MOVED + tuple(a for a, k in jc.PARAM_ALIASES.items() if k in MOVED)))
def test_prediction_and_file_keys_ported(key):
    """Each moved key and alias is a field read as the JAX package reads
    it, its default the JAX package's."""
    name = tc.PARAM_ALIASES.get(key, key)
    assert _outcome(key) == ["ported"]
    assert getattr(tc.Config(), name) == _jax_default(name)
    value = _other_value(_jax_default(name))
    cfg = tc.config_from_params({key: value})
    assert getattr(cfg, name) == value
    assert getattr(cfg, name) == getattr(jc.config_from_params({key: value}),
                                         name)
    assert getattr(tc.config_from_params({key: str(value).lower()}),
                   name) == value


# the keys that the multi-process slice moved out of NOT_PORTED
MOVED_MULTI = ("top_k", "is_pre_partition", "machine_list_file",
               "collective_timeout")


@pytest.mark.parametrize("key", sorted(
    MOVED_MULTI + tuple(a for a, k in jc.PARAM_ALIASES.items()
                        if k in MOVED_MULTI)))
def test_multi_process_keys_ported(key):
    """Each key of the voting and multi-process slice, and its alias, is
    a field read as the JAX package reads it, its default the JAX
    package's; ``collective_retries`` came with the supervisor (ROADMAP.md
    §1.6), which made it a field too."""
    _check_ported(key)
    assert "collective_retries" in PORT_FIELDS
    _check_ported_as(("collective_retries", 5))


def _check_ported(key):
    name = tc.PARAM_ALIASES.get(key, key)
    assert _outcome(key) == ["ported"]
    assert getattr(tc.Config(), name) == _jax_default(name)
    value = _other_value(_jax_default(name))
    cfg = tc.config_from_params({key: value})
    assert getattr(cfg, name) == value
    assert getattr(cfg, name) == getattr(jc.config_from_params({key: value}),
                                         name)


def _check_ported_as(case):
    """A key and a value that passes both packages' checks: a field of
    the port, the JAX default as its default, read as the JAX package
    reads it."""
    key, value = case
    name = tc.PARAM_ALIASES.get(key, key)
    assert _outcome(key) == ["ported"]
    assert getattr(tc.Config(), name) == _jax_default(name)
    got = getattr(tc.config_from_params({key: value}), name)
    assert got == getattr(jc.config_from_params({key: value}), name)
    assert got != _jax_default(name)


# the keys that the checkpoint slice moved out of NOT_PORTED, each with a
# value other than its default that both packages accept
MOVED_CHECKPOINT = (
    ("output_model", "m.txt"), ("model_output", "m.txt"),
    ("model_out", "m.txt"), ("snapshot_freq", 3), ("snapshot_keep", 2),
    ("snapshot_resume", True), ("fault_inject", "nan_grad@3,hist_fail_once"),
    ("heartbeat_interval", 0.5), ("hang_timeout", 30.0),
    ("restart_limit", 5), ("restart_backoff", 2.5),
    ("preempt_signal", "sigterm,sigint"), ("collective_retries", 0))


@pytest.mark.parametrize("case", MOVED_CHECKPOINT, ids=lambda c: str(c[0]))
def test_checkpoint_keys_ported(case):
    """Each key of the checkpoint and supervisor slice, and the aliases of
    ``output_model``: a field read as the JAX package reads it, its default
    the JAX package's; the elastic, straggler and observability keys are
    ported too (fields of the Config)."""
    _check_ported_as(case)
    for key in ("elastic_resume", "elastic_min_ranks", "world_shrink_after",
                "straggler_factor", "telemetry"):
        assert key in {f.name for f in dataclasses.fields(tc.Config)}


@pytest.mark.parametrize("params,message", [
    ({"tree_learner": "data_feature", "num_machines": 2},
     "data_feature is single-process"),
    ({"collective_timeout": 0}, "collective_timeout must be positive"),
    ({"tree_learner": "voting", "top_k": 0}, "top_k must be positive"),
])
def test_multi_process_values_checked(params, message):
    """lightgbm_tpu/config.py:686-691 and :782, and a vote of at least one
    feature."""
    with pytest.raises(RuntimeError, match=message):
        tc.config_from_params(params)


# the keys that the serving slice moved out of NOT_PORTED, each with a
# value other than its default that both packages accept
MOVED_SERVING = (
    ("latency_budget_ms", 5.0), ("serving_buckets", "1,8,64"),
    ("model_watch", "m.txt"), ("model_watch_interval", 0.25),
    ("drift_threshold", 0.5), ("drift_window_rows", 100),
    ("serving_traversal", "packed"))


@pytest.mark.parametrize("case", MOVED_SERVING, ids=lambda c: str(c[0]))
def test_serving_keys_ported(case):
    """Each serving key: a field read as the JAX package reads it, its
    default the JAX package's."""
    _check_ported_as(case)


# the ten keys of the CLI, the last that the port had not read, each with a
# value other than its default that both packages accept
CLI_KEYS = (
    ("task", "predict"), ("data", "train.txt"),
    ("valid_data", "a.txt,b.txt"), ("config_file", "train.conf"),
    ("is_training_metric", True), ("output_freq", 5),
    ("num_iteration_predict", 10), ("input_model", "m.txt"),
    ("output_result", "p.txt"), ("convert_model", "m.cpp"))


@pytest.mark.parametrize("case", CLI_KEYS, ids=lambda c: str(c[0]))
def test_cli_keys_ported(case):
    """Each CLI key: a field read as the JAX package reads it, its
    default the JAX package's; with them every JAX key is ported or taken
    as-is."""
    _check_ported_as(case)
    assert not hasattr(tc, "NOT_PORTED")
