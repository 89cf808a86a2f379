"""The port's plotting functions (``lightgbm_tpu_torch/plotting.py``)
against the JAX package's (``lightgbm_tpu/plotting.py``) on the same model:
the importance bars (split counts and gains), the contribution summary's
bars, and the metric curves of two trainings under integer-valued
gradients, where both packages grow the same trees.  The tree digraph is
checked where graphviz is installed, as the JAX package's test checks
it."""
import matplotlib
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import lightgbm_tpu as lj  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402

NAMES = [f"f{i}" for i in range(6)]
P = {"objective": "regression", "metric": "l2", "num_leaves": 7,
     "min_data_in_leaf": 5, "boost_from_average": False, "verbose": -1}


def _fobj(preds, data):
    """Integer-valued gradients that follow the scores."""
    q = np.floor(np.asarray(preds) * 4.0)
    return (np.sign(preds - data.get_label()) + np.mod(q, 3.0) - 1.0,
            1.0 + np.mod(q, 2.0))


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((600, 6))
    y = np.round(x @ rng.standard_normal(6))
    out = []
    for pkg, params in ((lj, dict(P)), (lt, dict(P, device="cpu"))):
        ds = pkg.Dataset(x[:450], y[:450], feature_name=NAMES, params=params)
        rec = {}
        bst = pkg.train(params, ds, 6, fobj=_fobj,
                        valid_sets=[ds.create_valid(x[450:], y[450:])],
                        evals_result=rec, verbose_eval=False)
        out.append((bst, rec))
    return out, x[450:]


def _bars(ax):
    return ([t.get_text() for t in ax.get_yticklabels()],
            [p.get_width() for p in ax.patches],
            [t.get_text() for t in ax.texts])


def test_same_model(trained):
    (bj, _), (bt, _) = trained[0]
    assert bt.model_to_string() == bj.model_to_string()


@pytest.mark.parametrize("importance_type", ["split", "gain"])
def test_importance_bars_equal(trained, importance_type):
    (bj, _), (bt, _) = trained[0]
    kw = dict(importance_type=importance_type, max_num_features=4,
              precision=2)
    tj = _bars(lj.plot_importance(bj, **kw))
    tt = _bars(lt.plot_importance(bt, **kw))
    assert tt == tj and len(tt[1]) == 4
    plt.close("all")


def test_contrib_summary_bars(trained):
    (bj, _), (bt, _) = trained[0]
    x = trained[1][:64]
    aj = lj.plot_contrib_summary(bj, x)
    at = lt.plot_contrib_summary(bt, x)
    assert at.get_title() == aj.get_title() == "Feature contributions"
    lj_, wj, _ = _bars(aj)
    lt_, wt, _ = _bars(at)
    assert lt_ == lj_
    np.testing.assert_allclose(wt, wj, rtol=1e-12)
    plt.close("all")


def test_metric_curves_equal(trained):
    (_, rj), (_, rt) = trained[0]
    aj, at = lj.plot_metric(rj), lt.plot_metric(rt)
    (cj,), (ct,) = aj.get_lines(), at.get_lines()
    assert ct.get_label() == cj.get_label()
    np.testing.assert_array_equal(ct.get_xdata(), cj.get_xdata())
    # the same trees; the valid scores are float32 and the L2 sum float64,
    # each package adding in its own order
    np.testing.assert_allclose(ct.get_ydata(), cj.get_ydata(), rtol=1e-8)
    assert at.get_ylabel() == "l2" and at.get_xlabel() == "Iterations"
    with pytest.raises(ValueError):
        lt.plot_metric({})
    with pytest.raises(TypeError):
        lt.plot_metric(trained[0][1][0])
    plt.close("all")


def test_create_tree_digraph(trained):
    pytest.importorskip("graphviz")
    (bj, _), (bt, _) = trained[0]
    info = ["split_gain", "leaf_count"]
    assert (lt.create_tree_digraph(bt, 1, show_info=info).source
            == lj.create_tree_digraph(bj, 1, show_info=info).source)
    with pytest.raises(IndexError):
        lt.create_tree_digraph(bt, tree_index=10 ** 6)
