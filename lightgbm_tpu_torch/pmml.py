"""PMML export (``lightgbm_tpu/pmml.py``): host code.

Emits a PMML 4.2 ``MiningModel`` whose ``Segmentation`` sums one
``TreeModel`` per boosted tree (the standard GBM encoding).  Like the
reference converter the output is the RAW margin sum: apply the
objective's link function (e.g. sigmoid for ``binary``) downstream.
Categorical splits become ``SimpleSetPredicate`` nodes.  For the same
model string the XML text is the JAX package's, byte for byte (its
header names ``lightgbm_tpu`` too), so either package's export reads the
same.

Usage::

    python -m lightgbm_tpu_torch.pmml model.txt > model.pmml
    # or
    from lightgbm_tpu_torch.pmml import model_to_pmml
"""
from __future__ import annotations

import sys
import xml.etree.ElementTree as ET
from typing import List, Optional

from .boosting import GBDT
from .config import Config
from .predictor import ZERO_RANGE
from .tree import Tree

PMML_NS = "http://www.dmg.org/PMML-4_2"


def _node(parent: ET.Element, predicate: Optional[ET.Element],
          score: Optional[float] = None) -> ET.Element:
    node = ET.SubElement(parent, "Node")
    if score is not None:
        node.set("score", repr(float(score)))
    if predicate is None:
        ET.SubElement(node, "True")
    else:
        node.append(predicate)
    return node


def _num_predicate(field: str, op: str, value: float) -> ET.Element:
    p = ET.Element("SimplePredicate")
    p.set("field", field)
    p.set("operator", op)
    p.set("value", repr(float(value)))
    return p


def _set_predicate(field: str, values: List[int]) -> ET.Element:
    p = ET.Element("SimpleSetPredicate")
    p.set("field", field)
    p.set("booleanOperator", "isIn")
    arr = ET.SubElement(p, "Array")
    arr.set("type", "int")
    arr.set("n", str(len(values)))
    arr.text = " ".join(str(v) for v in values)
    return p


def _not_zero_predicate(field: str) -> ET.Element:
    """v <= -1e-20 OR v > 1e-20 — excludes the reference's IsZero range."""
    p = ET.Element("CompoundPredicate")
    p.set("booleanOperator", "or")
    p.append(_num_predicate(field, "lessOrEqual", -ZERO_RANGE))
    p.append(_num_predicate(field, "greaterThan", ZERO_RANGE))
    return p


def _and(*preds: ET.Element) -> ET.Element:
    p = ET.Element("CompoundPredicate")
    p.set("booleanOperator", "and")
    for q in preds:
        p.append(q)
    return p


def _tree_nodes(tree: Tree, node: int, parent_el: ET.Element,
                feature_names: List[str],
                predicate: Optional[ET.Element],
                scale: float = 1.0) -> None:
    """Recursive emission; ``node`` >= 0 is internal, negative is ~leaf."""
    if node < 0:
        _node(parent_el, predicate,
              score=float(tree.leaf_value[~node]) * scale)
        return
    el = _node(parent_el, predicate)
    f = feature_names[tree.split_feature[node]]
    if tree.is_categorical(node):
        bs = tree.cat_bitset(node)
        cats = [w * 32 + b for w in range(len(bs)) for b in range(32)
                if (int(bs[w]) >> b) & 1]
        left_pred = _set_predicate(f, cats)
        right_pred = None          # everything else (incl. unseen) -> right
        left_first = True          # cat nodes always default right
    else:
        # encode the reference's exact NumericalDecision (tree.h:231-251)
        # under first-match-wins semantics: the NON-catch-all child gets an
        # explicit predicate; FALSE and UNKNOWN (missing) both fall through
        # to the <True/> catch-all, so the catch-all side carries every
        # "missing" route.
        thr = float(tree.threshold[node])
        mt = tree.missing_type(node)
        left_pred = _num_predicate(f, "lessOrEqual", thr)
        right_pred = _num_predicate(f, "greaterThan", thr)
        if mt == 2:          # NaN-missing: NaN -> default side
            left_first = not tree.default_left(node)
        elif mt == 1:        # zero-as-missing: zeros AND NaN -> default side
            left_first = not tree.default_left(node)
            nz = _not_zero_predicate(f)
            left_pred = _and(left_pred, nz)
            right_pred = _and(right_pred, _not_zero_predicate(f))
        else:                # no missing recorded: NaN behaves like 0.0
            left_first = not (0.0 <= thr)
    children = [(tree.left_child[node], left_pred),
                (tree.right_child[node], right_pred)]
    if not left_first:
        children.reverse()
    # the LAST child gets <True/> as catch-all (missing + its own range)
    _tree_nodes(tree, int(children[0][0]), el, feature_names,
                children[0][1], scale)
    _tree_nodes(tree, int(children[1][0]), el, feature_names, None, scale)


def model_to_pmml(model_str: str) -> str:
    """Convert a reference-format model string to a PMML document string.

    Multiclass models are refused (their per-class margins cannot be
    expressed as one summed Segmentation); ``average_output`` (random
    forest) models have their leaf scores pre-divided by the tree count so
    the summed segmentation reproduces the averaged prediction."""
    booster = GBDT.load_from_string(model_str, Config())
    if booster.num_class > 1:
        raise ValueError(
            "PMML export supports single-output models only; this model has "
            f"num_class={booster.num_class} (per-class trees cannot be "
            "summed into one PMML Segmentation)")
    leaf_scale = (1.0 / max(len(booster.models), 1)
                  if booster.average_output else 1.0)
    names = booster.feature_names or [
        f"Column_{i}" for i in range(booster.max_feature_idx + 1)]

    root = ET.Element("PMML")
    root.set("xmlns", PMML_NS)
    root.set("version", "4.2")
    header = ET.SubElement(root, "Header")
    header.set("copyright", "lightgbm_tpu")
    ET.SubElement(header, "Application").set("name", "lightgbm_tpu")

    dd = ET.SubElement(root, "DataDictionary")
    for name in names:
        f = ET.SubElement(dd, "DataField")
        f.set("name", name)
        f.set("optype", "continuous")
        f.set("dataType", "double")
    target = ET.SubElement(dd, "DataField")
    target.set("name", "prediction")
    target.set("optype", "continuous")
    target.set("dataType", "double")
    dd.set("numberOfFields", str(len(names) + 1))

    mm = ET.SubElement(root, "MiningModel")
    mm.set("functionName", "regression")
    mm.set("modelName", "lightgbm_tpu_gbdt")
    schema = ET.SubElement(mm, "MiningSchema")
    for name in names:
        mf = ET.SubElement(schema, "MiningField")
        mf.set("name", name)
    tf = ET.SubElement(schema, "MiningField")
    tf.set("name", "prediction")
    tf.set("usageType", "target")

    seg = ET.SubElement(mm, "Segmentation")
    seg.set("multipleModelMethod", "sum")
    for i, tree in enumerate(booster.models):
        s = ET.SubElement(seg, "Segment")
        s.set("id", str(i + 1))
        ET.SubElement(s, "True")
        tm = ET.SubElement(s, "TreeModel")
        tm.set("functionName", "regression")
        tm.set("modelName", f"tree_{i}")
        tm.set("splitCharacteristic", "binarySplit")
        ts = ET.SubElement(tm, "MiningSchema")
        tmf = ET.SubElement(ts, "MiningField")
        tmf.set("name", "prediction")
        tmf.set("usageType", "target")
        used = sorted({int(f) for f in
                       tree.split_feature[:max(tree.num_leaves - 1, 0)]})
        for f in used:
            mf = ET.SubElement(ts, "MiningField")
            mf.set("name", names[f])
        if tree.num_leaves <= 1:
            _node(tm, None, score=(float(tree.leaf_value[0]) * leaf_scale
                                   if len(tree.leaf_value) else 0.0))
        else:
            _tree_nodes(tree, 0, tm, names, None, leaf_scale)

    ET.indent(root)
    return ET.tostring(root, encoding="unicode", xml_declaration=True)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        sys.stderr.write("usage: python -m lightgbm_tpu_torch.pmml "
                         "model.txt\n")
        return 2
    with open(argv[0]) as f:
        sys.stdout.write(model_to_pmml(f.read()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
