"""Host-side tree model: SoA node arrays and text serialization.

A copy of the JAX package's numpy-only ``tree.py`` (its host prediction
left out: the port predicts on the device, ``predictor.py``), so that
model files keep one format across the two packages.  Mirrors the
reference ``Tree`` (``include/LightGBM/tree.h:20-370``,
``src/io/tree.cpp:192-280``):

* same SoA layout (split_feature / threshold / decision_type / children /
  leaf arrays), with leaves encoded as ``~leaf`` in child pointers;
* ``decision_type`` bitfield semantics preserved exactly (bit0 categorical,
  bit1 default-left, bits2-3 missing type — tree.h:157-176) because the text
  model format is the interop oracle with the reference CLI;
* ``to_string``/``from_string`` reproduce ``Tree::ToString`` so models can be
  exchanged with the reference implementation.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2


class Tree:
    def __init__(self, num_leaves: int):
        n = max(num_leaves - 1, 0)
        self.num_leaves = num_leaves
        self.num_cat = 0
        self.split_feature = np.zeros(n, dtype=np.int32)   # original feature idx
        self.split_gain = np.zeros(n, dtype=np.float64)
        self.threshold = np.zeros(n, dtype=np.float64)     # real-value threshold
        self.threshold_bin = np.zeros(n, dtype=np.int32)
        self.decision_type = np.zeros(n, dtype=np.int8)
        self.left_child = np.zeros(n, dtype=np.int32)
        self.right_child = np.zeros(n, dtype=np.int32)
        self.leaf_parent = np.zeros(num_leaves, dtype=np.int32)
        self.leaf_value = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_count = np.zeros(num_leaves, dtype=np.int64)
        self.internal_value = np.zeros(n, dtype=np.float64)
        self.internal_count = np.zeros(n, dtype=np.int64)
        self.cat_boundaries = np.zeros(1, dtype=np.int32)
        self.cat_threshold = np.zeros(0, dtype=np.uint32)
        self.shrinkage = 1.0
        # True when threshold_bin matches the real thresholds under the
        # training data's bin mappers (set by from_arrays; rebuilt for a
        # tree read from text by ensure_binned)
        self._binned_ok = False

    # ------------------------------------------------------------------ build

    @staticmethod
    def from_arrays(arrays, used_features: Sequence[int],
                    bin_mappers) -> "Tree":
        """Convert TreeArrays (see grower.TreeArrays, fields as numpy arrays)
        to a host Tree.

        ``used_features[i]`` maps inner feature i to the original column;
        ``bin_mappers`` are the per-original-feature mappers for real
        thresholds.
        """
        nl = int(arrays.num_leaves)
        t = Tree(nl)
        if nl <= 1:
            return t
        n = nl - 1
        inner_feat = np.asarray(arrays.split_feature[:n], dtype=np.int32)
        t.split_feature = np.asarray([used_features[i] for i in inner_feat],
                                     dtype=np.int32)
        t.threshold_bin = np.array(arrays.threshold_bin[:n], dtype=np.int32)
        t.split_gain = np.asarray(arrays.split_gain[:n], dtype=np.float64)
        t.left_child = np.asarray(arrays.left_child[:n], dtype=np.int32)
        t.right_child = np.asarray(arrays.right_child[:n], dtype=np.int32)
        t.leaf_parent = np.asarray(arrays.leaf_parent[:nl], dtype=np.int32)
        t.leaf_value = np.asarray(arrays.leaf_value[:nl], dtype=np.float64)
        t.leaf_count = np.asarray(np.round(arrays.leaf_count[:nl]), dtype=np.int64)
        t.internal_value = np.asarray(arrays.internal_value[:n], dtype=np.float64)
        t.internal_count = np.asarray(np.round(arrays.internal_count[:n]),
                                      dtype=np.int64)
        default_left = np.asarray(arrays.default_left[:n], dtype=bool)
        is_cat = np.asarray(arrays.is_cat[:n], dtype=bool)
        cat_bins = np.asarray(arrays.cat_bins[:n], dtype=bool)
        thresholds = np.zeros(n, dtype=np.float64)
        dtypes = np.zeros(n, dtype=np.int8)
        cat_boundaries = [0]
        cat_threshold: List[int] = []
        for i in range(n):
            mapper = bin_mappers[t.split_feature[i]]
            if is_cat[i]:
                # Tree::SplitCategorical (tree.h:347-370): bitset over the
                # raw category values of the bins routed left
                cats = [mapper.bin_2_categorical[b]
                        for b in np.nonzero(cat_bins[i][:mapper.num_bin])[0]]
                size = (max(cats) // 32 + 1) if cats else 1
                bs = np.zeros(size, dtype=np.uint32)
                for cval in cats:
                    bs[cval // 32] |= np.uint32(1 << (cval % 32))
                thresholds[i] = float(t.num_cat)
                t.threshold_bin[i] = t.num_cat
                cat_threshold.extend(int(v) for v in bs)
                cat_boundaries.append(len(cat_threshold))
                t.num_cat += 1
                dt = K_CATEGORICAL_MASK
            else:
                thresholds[i] = mapper.bin_to_value(int(t.threshold_bin[i]))
                dt = K_DEFAULT_LEFT_MASK if default_left[i] else 0
            dt |= (mapper.missing_type & 3) << 2
            dtypes[i] = dt
        t.threshold = thresholds
        t.decision_type = dtypes
        if t.num_cat > 0:
            t.cat_boundaries = np.asarray(cat_boundaries, dtype=np.int32)
            t.cat_threshold = np.asarray(cat_threshold, dtype=np.uint32)
        t._binned_ok = True
        return t

    def ensure_binned(self, bin_mappers) -> None:
        """Rebuild ``threshold_bin`` from the real thresholds of a tree read
        from text, so that it routes binned rows (a loaded model's trees
        replayed on the device: rollback and DART)."""
        if self._binned_ok or self.num_leaves <= 1:
            return
        for i in range(self.num_leaves - 1):
            if self.is_categorical(i):
                self.threshold_bin[i] = int(self.threshold[i])
            else:
                mapper = bin_mappers[self.split_feature[i]]
                self.threshold_bin[i] = int(mapper.value_to_bin(
                    np.asarray([self.threshold[i]]))[0])
        self._binned_ok = True

    # ---------------------------------------------------------------- helpers

    def missing_type(self, node: int) -> int:
        return (int(self.decision_type[node]) >> 2) & 3

    def default_left(self, node: int) -> bool:
        return bool(self.decision_type[node] & K_DEFAULT_LEFT_MASK)

    def is_categorical(self, node: int) -> bool:
        return bool(self.decision_type[node] & K_CATEGORICAL_MASK)

    def cat_bitset(self, node: int) -> np.ndarray:
        """The uint32 bitset of raw category values a categorical node
        routes left."""
        ci = int(self.threshold[node])
        return self.cat_threshold[self.cat_boundaries[ci]:
                                  self.cat_boundaries[ci + 1]]

    def cat_value_mask(self, node: int, width: int) -> np.ndarray:
        """bool[width]: which raw category VALUES route left at a
        categorical node (the bitset unpacked); values at or beyond the
        node's bitset stay False, like CategoricalDecision."""
        bits = np.unpackbits(self.cat_bitset(node).astype("<u4").view(
            np.uint8), bitorder="little")
        out = np.zeros(width, dtype=bool)
        k = min(width, len(bits))
        out[:k] = bits[:k].astype(bool)
        return out

    def cat_bin_mask(self, node: int, mapper, width: int) -> np.ndarray:
        """bool[width]: which *bins* of the split feature route left at a
        categorical node (inverse of the value bitset, for binned
        prediction)."""
        mask = np.zeros(width, dtype=bool)
        bs = self.cat_bitset(node)
        for b, cval in enumerate(mapper.bin_2_categorical or []):
            i1, i2 = cval // 32, cval % 32
            if i1 < len(bs) and (int(bs[i1]) >> i2) & 1:
                mask[b] = True
        return mask

    def shrink(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:130-137)."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate

    def max_depth(self) -> int:
        """Edges on the longest root->leaf path (0 for stumps) — bounds
        the traversal loop any flattened evaluator needs."""
        n = self.num_leaves - 1
        if n <= 0:
            return 0
        depth = np.zeros(n, dtype=np.int64)
        best = 1
        for i in range(n):          # parents precede children in this layout
            for c in (int(self.left_child[i]), int(self.right_child[i])):
                if c >= 0:
                    depth[c] = depth[i] + 1
                else:
                    best = max(best, int(depth[i]) + 1)
        return best

    # -------------------------------------------------------------- serialize

    def to_string(self, index: int) -> str:
        n = self.num_leaves - 1
        lines = [f"Tree={index}",
                 f"num_leaves={self.num_leaves}",
                 f"num_cat={self.num_cat}",
                 "split_feature=" + _join_int(self.split_feature[:n]),
                 "split_gain=" + _join_float(self.split_gain[:n]),
                 "threshold=" + _join_float(self.threshold[:n]),
                 "decision_type=" + _join_int(self.decision_type[:n]),
                 "left_child=" + _join_int(self.left_child[:n]),
                 "right_child=" + _join_int(self.right_child[:n]),
                 "leaf_parent=" + _join_int(self.leaf_parent[:self.num_leaves]),
                 "leaf_value=" + _join_float(self.leaf_value[:self.num_leaves]),
                 "leaf_count=" + _join_int(self.leaf_count[:self.num_leaves]),
                 "internal_value=" + _join_float(self.internal_value[:n]),
                 "internal_count=" + _join_int(self.internal_count[:n])]
        if self.num_cat > 0:
            lines.append("cat_boundaries=" + _join_int(self.cat_boundaries))
            lines.append("cat_threshold=" + _join_int(self.cat_threshold))
        lines.append(f"shrinkage={self.shrinkage:.17g}")
        lines.append("")
        return "\n".join(lines) + "\n"

    @staticmethod
    def from_string(block: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in block.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        nl = int(kv["num_leaves"])
        t = Tree(nl)
        t.num_cat = int(kv.get("num_cat", "0"))
        n = nl - 1
        if n > 0:
            t.split_feature = _parse_arr(kv["split_feature"], np.int32, n)
            t.split_gain = _parse_arr(kv.get("split_gain", ""), np.float64, n)
            t.threshold = _parse_arr(kv["threshold"], np.float64, n)
            t.decision_type = _parse_arr(kv["decision_type"], np.int8, n)
            t.left_child = _parse_arr(kv["left_child"], np.int32, n)
            t.right_child = _parse_arr(kv["right_child"], np.int32, n)
            t.internal_value = _parse_arr(kv.get("internal_value", ""), np.float64, n)
            t.internal_count = _parse_arr(kv.get("internal_count", ""), np.int64, n)
        t.leaf_parent = _parse_arr(kv.get("leaf_parent", ""), np.int32, nl)
        t.leaf_value = _parse_arr(kv["leaf_value"], np.float64, nl)
        t.leaf_count = _parse_arr(kv.get("leaf_count", ""), np.int64, nl)
        if t.num_cat > 0:
            t.cat_boundaries = _parse_arr(kv["cat_boundaries"], np.int32,
                                          t.num_cat + 1)
            t.cat_threshold = _parse_arr(kv["cat_threshold"], np.uint32, -1)
        t.shrinkage = float(kv.get("shrinkage", "1"))
        return t

    def to_json(self, index: int) -> Dict:
        """Tree::ToJSON (tree.cpp:229+) as a python dict."""
        def node_json(node: int) -> Dict:
            if node < 0:
                leaf = ~node
                return {"leaf_index": int(leaf),
                        "leaf_value": float(self.leaf_value[leaf]),
                        "leaf_count": int(self.leaf_count[leaf])}
            return {
                "split_index": int(node),
                "split_feature": int(self.split_feature[node]),
                "split_gain": float(self.split_gain[node]),
                "threshold": float(self.threshold[node]),
                "decision_type": ("categorical" if self.is_categorical(node)
                                  else "<="),
                "default_left": self.default_left(node),
                "missing_type": ["None", "Zero", "NaN"][
                    self.missing_type(node)],
                "internal_value": float(self.internal_value[node]),
                "internal_count": int(self.internal_count[node]),
                "left_child": node_json(int(self.left_child[node])),
                "right_child": node_json(int(self.right_child[node])),
            }
        root = node_json(0) if self.num_leaves > 1 else {
            "leaf_index": 0,
            "leaf_value": (float(self.leaf_value[0]) if len(self.leaf_value)
                           else 0.0),
            "leaf_count": (int(self.leaf_count[0]) if len(self.leaf_count)
                           else 0)}
        return {"tree_index": index, "num_leaves": int(self.num_leaves),
                "num_cat": int(self.num_cat),
                "shrinkage": float(self.shrinkage), "tree_structure": root}


def _join_int(arr) -> str:
    return " ".join(str(int(v)) for v in arr)


def _join_float(arr) -> str:
    return " ".join(f"{float(v):.17g}" for v in arr)


def _parse_arr(s: str, dtype, expect: int) -> np.ndarray:
    parts = s.split()
    if expect >= 0 and len(parts) != expect:
        if not parts:
            return np.zeros(expect, dtype=dtype)
    if dtype in (np.float64, np.float32):
        return np.asarray([float(p) for p in parts], dtype=dtype)
    return np.asarray([int(float(p)) for p in parts], dtype=dtype)
