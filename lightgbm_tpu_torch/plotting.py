"""Plotting utilities (feature importance, contributions, metric curves,
tree graphs; ``lightgbm_tpu/plotting.py``).

The API of the reference python package's ``plotting.py:22-428``
(``plot_importance``, ``plot_metric``, ``plot_tree``,
``create_tree_digraph``) over the port's Booster and ``dump_model``
structures.  matplotlib and graphviz are imported inside the functions:
the package imports without them, and a function that needs a missing one
raises ``ImportError`` naming it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np


def _check_not_tuple_of_2_elements(obj, obj_name: str) -> None:
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def _get_booster(booster):
    # a Booster or an sklearn estimator, as the reference's plotting takes
    from .basic import Booster
    if hasattr(booster, "booster_"):          # sklearn estimator
        booster = booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel instance")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim: Optional[Tuple[float, float]] = None,
                    ylim: Optional[Tuple[float, float]] = None,
                    title: Optional[str] = "Feature importance",
                    xlabel: Optional[str] = "Feature importance",
                    ylabel: Optional[str] = "Features",
                    importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, grid: bool = True,
                    precision: Optional[int] = 3,
                    **kwargs):
    """Horizontal bar chart of feature importance (plotting.py:22-120).

    ``importance_type="gain"`` values are float64 total gains
    (``GBDT.feature_importance``): they are annotated with ``precision``
    decimals instead of the split counts' integers."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot importance.")

    booster = _get_booster(booster)
    importance = np.asarray(booster.feature_importance(importance_type))
    feature_name = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")

    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples) if tuples else ((), ())

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                _float2str(x, precision) if importance_type == "gain"
                else str(int(x)), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1 if values else 1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_contrib_summary(booster, data, ax=None, height: float = 0.2,
                         max_num_features: Optional[int] = None,
                         title: Optional[str] = "Feature contributions",
                         xlabel: Optional[str] = "mean |SHAP contribution|",
                         ylabel: Optional[str] = "Features",
                         precision: Optional[int] = 3, figsize=None,
                         grid: bool = True, **kwargs):
    """Horizontal bar chart of mean absolute SHAP contributions over
    ``data`` (the ``plot_split_value_histogram``-style summary view of
    ``predict(pred_contrib=True)``): per-feature mean |phi|, classes
    aggregated, the expected-value column dropped."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot "
                          "contributions.")

    booster = _get_booster(booster)
    contribs = np.asarray(booster.predict(data, pred_contrib=True))
    feature_name = booster.feature_name()
    n_feat = len(feature_name)
    # [n, K*(F+1)] class-major -> mean |phi| per feature across rows and
    # classes; the last column of every class block is the expected value
    per_class = contribs.reshape(contribs.shape[0], -1, n_feat + 1)
    mean_abs = np.abs(per_class[:, :, :n_feat]).mean(axis=(0, 1))

    tuples = sorted(zip(feature_name, mean_abs), key=lambda x: x[1])
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples) if tuples else ((), ())

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x, y, _float2str(x, precision), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    ax.set_xlim((0, max(values) * 1.1 if values else 1))
    ax.set_ylim((-1, len(values)))
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster_or_record: Union[Dict, object],
                metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None,
                ax=None, xlim=None, ylim=None,
                title: Optional[str] = "Metric during training",
                xlabel: Optional[str] = "Iterations",
                ylabel: Optional[str] = "auto", figsize=None,
                grid: bool = True):
    """Plot metric curves recorded by ``record_evaluation``
    (plotting.py:123-222)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot metric.")

    if isinstance(booster_or_record, dict):
        eval_results = booster_or_record
    else:
        raise TypeError("booster_or_record must be a dict recorded by "
                        "record_evaluation (pass eval_result dict)")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)

    names = list(eval_results.keys())
    if dataset_names is None:
        dataset_names = names
    msg = "valid dataset names: " + ", ".join(names)

    num_iters = 0
    for name in dataset_names:
        if name not in eval_results:
            raise ValueError(f"dataset {name!r} not found; {msg}")
        metrics = eval_results[name]
        if metric is None:
            if len(metrics) > 1:
                raise ValueError("more than one metric available, "
                                 "please specify metric in params")
            metric = list(metrics.keys())[0]
        if metric not in metrics:
            raise ValueError(f"metric {metric!r} not recorded for {name!r}")
        results = metrics[metric]
        num_iters = max(num_iters, len(results))
        ax.plot(range(len(results)), results, label=name)

    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, num_iters)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if ylabel == "auto":
        ylabel = metric
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _float2str(value, precision: Optional[int] = 3) -> str:
    return (f"{value:.{precision}f}" if precision is not None
            else str(value))


def create_tree_digraph(booster, tree_index: int = 0,
                        show_info: Optional[List[str]] = None,
                        precision: Optional[int] = 3,
                        name: Optional[str] = None,
                        comment: Optional[str] = None,
                        format: Optional[str] = None,  # noqa: A002
                        engine: Optional[str] = None,
                        encoding: Optional[str] = None,
                        graph_attr=None, node_attr=None, edge_attr=None,
                        body=None, strict: bool = False):
    """Build a graphviz.Digraph of one tree from dump_model JSON
    (plotting.py:225-340)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("You must install graphviz to plot tree.")

    booster = _get_booster(booster)
    model = booster.dump_model()
    tree_infos = model["tree_info"]
    if tree_index >= len(tree_infos):
        raise IndexError("tree_index is out of range.")
    tree_info = tree_infos[tree_index]
    show_info = show_info or []
    feature_names = model.get("feature_names")

    graph = Digraph(name=name, comment=comment, format=format, engine=engine,
                    encoding=encoding, graph_attr=graph_attr,
                    node_attr=node_attr, edge_attr=edge_attr, body=body,
                    strict=strict)

    def add(node, parent=None, decision=None):
        if "split_index" in node:
            nid = f"split{node['split_index']}"
            feat = node["split_feature"]
            if feature_names is not None and 0 <= feat < len(feature_names):
                feat = feature_names[feat]
            label = f"split_feature_name: {feat}"
            is_cat = node.get("decision_type") == "categorical"
            if is_cat:
                left_edge, right_edge = "in set", "not in set"
            else:
                left_edge, right_edge = node.get("decision_type", "<="), ">"
                label += f"\\nthreshold: {_float2str(node['threshold'], precision)}"
            for info in ("split_gain", "internal_value", "internal_count"):
                if info in show_info and info in node:
                    label += f"\\n{info}: {_float2str(node[info], precision)}"
            graph.node(nid, label=label)
            add(node["left_child"], nid, left_edge)
            add(node["right_child"], nid, right_edge)
        else:
            nid = f"leaf{node['leaf_index']}"
            label = f"leaf_index: {node['leaf_index']}"
            label += f"\\nleaf_value: {_float2str(node['leaf_value'], precision)}"
            if "leaf_count" in show_info and "leaf_count" in node:
                label += f"\\nleaf_count: {node['leaf_count']}"
            graph.node(nid, label=label)
        if parent is not None:
            graph.edge(parent, nid, decision)

    add(tree_info["tree_structure"])
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None,
              show_info: Optional[List[str]] = None,
              precision: Optional[int] = 3, **kwargs):
    """Render one tree into a matplotlib axis (plotting.py:343-428)."""
    try:
        import matplotlib.image as mpimg
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot tree.")
    from io import BytesIO

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                **kwargs)
    s = BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
