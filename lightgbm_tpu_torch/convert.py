"""Carry state built by the JAX package across into the port, as numpy
arrays or model text, so both packages compute on the same state.

* :func:`dataset_from_arrays` takes a constructed dataset (bin matrix,
  per-feature ``num_bin`` / ``missing_type`` / ``default_bin`` / bin upper
  bounds or, for a categorical feature, its bins' categories, label, and
  optionally weights, query boundaries, init scores and the EFB bundles of
  a bundled matrix) and returns the port's :class:`~.basic.Dataset`.
* :func:`booster_from_arrays` takes trees as model text or as the
  ``Tree`` fields (``num_class`` trees an iteration) and returns the
  port's :class:`~.basic.Booster`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .basic import Booster, Dataset
from .data.binning import BIN_TYPE_CATEGORICAL, BinMapper
from .data.bundling import BundleLayout
from .data.dataset import TrainingData, bin_dtype
from .data.metadata import Metadata
from .tree import Tree

_TREE_FIELDS = ("split_feature", "split_gain", "threshold", "decision_type",
                "left_child", "right_child", "leaf_parent", "leaf_value",
                "leaf_count", "internal_value", "internal_count",
                "cat_boundaries", "cat_threshold")


def dataset_from_arrays(binned: np.ndarray, num_bin: Sequence[int],
                        missing_type: Sequence[int],
                        default_bin: Sequence[int],
                        bin_upper_bound: Sequence[np.ndarray],
                        label: np.ndarray,
                        used_features: Optional[Sequence[int]] = None,
                        num_total_features: Optional[int] = None,
                        min_max: Optional[Sequence[Sequence[float]]] = None,
                        feature_names: Optional[List[str]] = None,
                        weight: Optional[np.ndarray] = None,
                        params: Optional[Dict] = None,
                        device: Optional[str] = None,
                        bin_2_categorical: Optional[
                            Sequence[Optional[Sequence[int]]]] = None,
                        query_boundaries: Optional[np.ndarray] = None,
                        init_score: Optional[np.ndarray] = None,
                        bundles: Optional[Sequence[Sequence[int]]] = None
                        ) -> Dataset:
    """A constructed port Dataset from the arrays of a constructed one.

    ``binned`` is ``[N, F_used]``, kept as the JAX package's type: uint8
    when every column has at most 256 bins, else uint16
    (``data.dataset.bin_dtype``); the per-feature arrays describe
    its columns, which are the original features ``used_features``
    (default: all of them) of ``num_total_features``.  ``min_max`` gives
    each used feature's (min, max) for the model's ``feature_infos``.
    ``bin_2_categorical`` gives, per used feature, the category of each
    bin of a categorical feature, or None for a numerical one.
    ``query_boundaries`` (``[Q + 1]``, as the JAX metadata keeps them) and
    ``init_score`` (``[N * num_class]``) go to the metadata.

    ``bundles`` (the JAX dataset's ``layout.bundles``: original feature ids
    a physical column) marks ``binned`` as EFB-bundled: its columns are
    the bundles, and ``used_features`` must then list the features in
    bundle order, as the JAX dataset's ``used_features`` does."""
    binned = np.asarray(binned)
    n, f = binned.shape
    if used_features is None:
        used_features = (range(f) if bundles is None
                         else [j for b in bundles for j in b])
    used = list(used_features)
    total = num_total_features if num_total_features is not None else f
    mappers = [BinMapper() for _ in range(total)]      # trivial by default
    for k, j in enumerate(used):
        lo, hi = min_max[k] if min_max is not None else (0.0, 0.0)
        cats = bin_2_categorical[k] if bin_2_categorical is not None else None
        mappers[j] = BinMapper(
            num_bin=int(num_bin[k]), missing_type=int(missing_type[k]),
            is_trivial=False,
            bin_upper_bound=(None if cats is not None else np.asarray(
                bin_upper_bound[k], np.float64)),
            min_val=float(lo), max_val=float(hi),
            default_bin=int(default_bin[k]))
        if cats is not None:
            mappers[j].bin_type = BIN_TYPE_CATEGORICAL
            mappers[j].bin_2_categorical = [int(c) for c in cats]
            mappers[j].categorical_2_bin = {int(c): b
                                            for b, c in enumerate(cats)}
    td = TrainingData()
    td.num_data = n
    td.num_total_features = total
    td.bin_mappers = mappers
    td.used_features = used
    if bundles is not None:
        td.layout = BundleLayout([list(map(int, b)) for b in bundles],
                                 mappers)
        if td.layout.sub_features != used or td.layout.num_columns != f:
            raise ValueError("bundles must cover used_features in bundle "
                             "order, one bundle a column of binned")
    td.binned = np.ascontiguousarray(binned,
                                     dtype=bin_dtype(td.max_num_bin()))
    td.feature_names = (list(feature_names) if feature_names
                        else [f"Column_{i}" for i in range(total)])
    td.metadata = Metadata(n)
    td.metadata.set_label(label)
    td.metadata.set_weight(weight)
    if query_boundaries is not None:
        td.metadata.set_query(np.diff(np.asarray(query_boundaries)))
    td.metadata.set_init_score(init_score)
    ds = Dataset(None, label=label, params=params)
    ds.constructed = td
    return ds.construct(device=device)


def booster_from_arrays(model_str: Optional[str] = None,
                        trees: Optional[List[Dict[str, np.ndarray]]] = None,
                        objective: str = "regression",
                        max_feature_idx: int = 0,
                        boost_from_average: bool = False,
                        params: Optional[Dict] = None,
                        num_class: int = 1,
                        average_output: bool = False) -> Booster:
    """A port Booster from model text, or from trees given as dicts of the
    ``Tree`` fields (``num_leaves``, ``split_feature``, ``threshold``,
    ``decision_type``, ``left_child``, ``right_child``, ``leaf_value``, ...;
    ``num_cat``, ``cat_boundaries`` and ``cat_threshold`` for categorical
    nodes) with the model's objective string (e.g. ``"binary sigmoid:1"``),
    ``num_class`` trees an iteration, tree i of class ``i % num_class``.
    ``average_output`` marks a random forest's trees (their outputs
    averaged); a DART booster's trees are already normalised and need
    nothing more.  Model text carries both kinds as it is."""
    if model_str is not None:
        return Booster(params=params, model_str=model_str)
    names = " ".join(f"Column_{i}" for i in range(max_feature_idx + 1))
    header = ["tree", f"num_class={num_class}",
              f"num_tree_per_iteration={num_class}",
              "label_index=0", f"max_feature_idx={max_feature_idx}",
              f"objective={objective}"]
    if boost_from_average:
        header.append("boost_from_average")
    if average_output:
        header.append("average_output")
    header += [f"feature_names={names}", ""]
    blocks = []
    for i, fields in enumerate(trees or []):
        t = Tree(int(fields["num_leaves"]))
        for name in _TREE_FIELDS:
            if name in fields:
                setattr(t, name, np.asarray(fields[name],
                                            getattr(t, name).dtype))
        t.num_cat = int(fields.get("num_cat", 0))
        t.shrinkage = float(fields.get("shrinkage", 1.0))
        blocks.append(t.to_string(i))
    return Booster(params=params,
                   model_str="\n".join(header) + "\n" + "\n".join(blocks))
