"""User-facing ``Dataset`` and ``Booster`` (python-package basic.py
semantics, as in ``lightgbm_tpu/basic.py:76`` and :671).

Both run on the CUDA device unless the caller passes ``device="cpu"``
(as a keyword or in ``params``); with no card and no such request they
raise.  A Dataset takes a matrix, a :class:`~.data.CsrMatrix`, a pandas
DataFrame (detected by its attributes; pandas is never imported here) or
the path of a CSV, TSV or LibSVM file, of a binary dataset file, or of a
text file with a ``<data>.bin`` cache beside it.
"""
from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from . import data as data_mod
from .boosting import GBDT, create_boosting, streams
from .config import (Config, _parse_value, canonicalize_params,
                     config_from_params, resolve_device)
from .data.binning import BinMapper
from .data.bundling import BundleLayout
from .data.parser import load_text_file, read_header_names
from .objectives import create_objective
from .parallel import sync
from .parallel.mesh import init_distributed_from_config
from .utils import log
from .utils.random import make_rng


def _to_matrix(data) -> np.ndarray:
    mat = np.asarray(data, dtype=np.float64)
    return mat.reshape(1, -1) if mat.ndim == 1 else mat


def _is_path(data) -> bool:
    return isinstance(data, (str, os.PathLike))


def _is_frame(data) -> bool:
    return hasattr(data, "columns") and hasattr(data, "dtypes")


def _data_from_pandas(data, pandas_categorical):
    """A DataFrame's ``category`` columns as their integer codes
    (reference basic.py:225-263, ``lightgbm_tpu/basic.py:33``).  On the
    training data ``pandas_categorical`` is None and each column's levels
    are recorded; on other data the recorded levels realign the codes, so
    that a level has one code everywhere.  Code -1 (NaN, or a level the
    training data lacks) becomes NaN.

    Returns (float64 matrix, category column names, pandas_categorical)."""
    cat_cols = [c for c in data.columns
                if str(data[c].dtype) == "category"]
    if pandas_categorical is None:
        pandas_categorical = [list(data[c].cat.categories) for c in cat_cols]
    else:
        if len(cat_cols) != len(pandas_categorical):
            raise ValueError("train and valid dataset categorical_feature "
                             "do not match.")
        data = data.copy()
        for col, cats in zip(cat_cols, pandas_categorical):
            if list(data[col].cat.categories) != list(cats):
                data[col] = data[col].cat.set_categories(cats)
    if cat_cols:
        data = data.copy()
        for c in cat_cols:
            codes = data[c].cat.codes.to_numpy().astype(np.float64)
            codes[codes == -1] = np.nan
            data[c] = codes
    return (np.asarray(data.values, dtype=np.float64), cat_cols,
            pandas_categorical)


def _load_pandas_categorical(model_str: str):
    """The last line ``pandas_categorical:<json>`` of a model file
    (reference basic.py:277-289), or None."""
    last = model_str.rstrip().rsplit("\n", 1)[-1]
    if last.startswith("pandas_categorical:"):
        return json.loads(last[len("pandas_categorical:"):])
    return None


class Dataset:
    """Lazily-constructed dataset: binned on the host, then moved to the
    device once, unless a training streams it (``data_stream=chunked``):
    its bin matrix then stays on the host."""

    # the first bytes of a binary dataset file: the JAX package's token
    # and npz + JSON layout (``lightgbm_tpu/basic.py:558``), loaded with
    # allow_pickle=False, so a file either package writes loads in the
    # other
    BINARY_TOKEN = b"lightgbm_tpu.dataset.v2\n"

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = False, silent: bool = False):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group                # each query's size
        self.init_score = init_score      # [N * num_class] raw scores
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self.constructed: Optional[data_mod.TrainingData] = None
        self.bins: Optional[torch.Tensor] = None     # [N, F] u8/u16, on device
        self.raw: Optional[np.ndarray] = None        # a parsed file's rows
        self.pandas_categorical: Optional[List[List]] = None
        # a text file's rows: whether they were read from a file, their
        # labels too, and whether this process kept only its share of them
        self._from_file = self._label_from_file = self._dist_sharded = False

    def _categorical_indices(self, cfg: Config,
                             names: Optional[List[str]]) -> List[int]:
        """Column indices of the categorical features: this Dataset's
        ``categorical_feature`` (indices, or names of ``feature_name``),
        else the ``categorical_feature`` parameter (comma-separated)."""
        cats = self.categorical_feature
        if cats in ("auto", None):
            cats = [c for c in cfg.categorical_column.split(",") if c.strip()]
        out = []
        for c in cats:
            if isinstance(c, str) and not c.strip().lstrip("-").isdigit():
                if not names or c not in names:
                    raise ValueError(f"categorical feature {c!r} is not a "
                                     f"feature name")
                out.append(names.index(c))
            else:
                out.append(int(c))
        return out

    def _names(self) -> Optional[List[str]]:
        return (list(self.feature_name)
                if isinstance(self.feature_name, (list, tuple)) else None)

    def construct(self, config: Optional[Config] = None,
                  device: Optional[str] = None,
                  on_device: bool = True) -> "Dataset":
        """Bin on the host (dataset.py:92 ``construct``) and, unless
        ``on_device`` is False (a training that streams the matrix), move
        the bin matrix to ``device`` (default: ``params['device']``, else
        cuda)."""
        cfg = config or config_from_params(self.params)
        dev = resolve_device(device or cfg.device)
        # the training file of several processes that share it
        # (lightgbm_tpu/basic.py:130-200): each keeps its share of the
        # rows; validation data stays whole on every process
        dist_rows = (cfg.num_machines > 1 and not cfg.is_pre_partition
                     and cfg.tree_learner in ("data", "voting")
                     and self.reference is None)
        if (self.constructed is not None and dist_rows and self._from_file
                and not self._dist_sharded):
            # built before the parallel parameters (num_data() before
            # train()): every process would hold every row
            if not _is_path(self.data):
                log.fatal("Dataset was constructed without distributed row "
                          "partitioning and the raw file reference was "
                          "freed; pass the num_machines/tree_learner params "
                          "to the Dataset or construct it inside train()")
            log.warning("Reconstructing dataset with distributed row "
                        "partitioning (it was first constructed without "
                        "the parallel params)")
            self.constructed = self.bins = None
            if self._label_from_file:
                self.label = None
        if self.constructed is None:
            self.constructed = self._build(cfg, str(dev),
                                           dist_rows and _is_path(self.data))
        if on_device and (self.bins is None
                          or self.bins.device.type != dev.type):
            self.bins = torch.from_numpy(self.constructed.binned).to(dev)
        return self

    def _distributed_row_selection(self, cfg: Config,
                                   n_rows: int) -> np.ndarray:
        """This process's rows of a file that several processes share
        (``lightgbm_tpu/basic.py:100``, the reference's
        LoadTextDataToMemory, dataset_loader.cpp:563-607): one draw of
        ``make_rng(data_random_seed)``, the same on every process, assigns
        each row (each query, when there are queries) to a process."""
        nm, rank = sync.process_count(), sync.process_index()
        rng = make_rng(cfg.data_random_seed)
        if self.group is not None:
            counts = np.asarray(self.group, dtype=np.int64)
            assign = rng.integers(0, nm, size=len(counts))
            row_q = np.repeat(np.arange(len(counts)), counts)
            sel = np.flatnonzero(assign[row_q] == rank)
            self.group = counts[assign == rank]
        else:
            assign = rng.integers(0, nm, size=n_rows)
            sel = np.flatnonzero(assign == rank)
        log.info("Distributed loading: rank %d keeps %d of %d rows",
                 rank, len(sel), n_rows)
        return sel

    def _build(self, cfg: Config, dev: str,
               dist_rows: bool = False) -> data_mod.TrainingData:
        """The host dataset, from whichever input this Dataset holds
        (``lightgbm_tpu/basic.py:130-371``); ``dist_rows``: a training
        file shared by several processes, of which this one keeps its
        share."""
        # the reference's host dataset: its bins stay where they are
        ref = (self.reference.construct(cfg, dev, on_device=False)
               if self.reference is not None else None)
        td_ref = None if ref is None else ref.constructed
        path = str(self.data) if _is_path(self.data) else None
        if dist_rows:
            # the group first, so that an early construct() shards as the
            # one inside train() does
            init_distributed_from_config(cfg)
            if cfg.use_two_round_loading:
                log.warning("use_two_round_loading falls back to in-memory "
                            "loading when rows are distributed across "
                            "machines (set pre_partition=true to stream "
                            "per-machine files)")
        elif path is not None and ref is None:
            # CheckCanLoadFromBin (dataset_loader.cpp:980-1018): a
            # "<data>.bin" cache beside the file first, then the file
            # itself as a binary dataset file
            self._from_file = True
            for candidate in (path + ".bin", path):
                if self._is_binary_cache(candidate):
                    log.info("Loading dataset from binary cache %s",
                             candidate)
                    return self._from_binary(candidate)
            if cfg.use_two_round_loading:
                return self._from_file_two_round(path, cfg)
        if isinstance(self.data, data_mod.CsrMatrix):
            names = self._names()
            td = data_mod.construct_csr(
                self.data, cfg, **self._fields(),
                feature_names=names,
                categorical_features=self._categorical_indices(cfg, names),
                reference=td_ref)
            self._drop_raw()
            return td
        cat_idx: List[int] = []
        sel = None
        if path is not None:
            feats, labels, header = load_text_file(
                path, has_header=cfg.has_header, label_idx=0)
            if self.label is None:
                self.label = labels
                self._label_from_file = True
            if header and self.feature_name == "auto":
                self.feature_name = header
            self._side_files(path, len(labels))
            mat = feats
            self._from_file = True
            if dist_rows:
                sel = self._distributed_row_selection(cfg, len(mat))
                mat = self._keep_rows(mat, sel, cfg)
            self._dist_sharded = sel is not None
        elif _is_frame(self.data):
            # category columns become their codes, realigned on other data
            # to the training data's levels
            ref_pc = (ref.pandas_categorical if ref is not None
                      else self.pandas_categorical)
            mat, pd_cat_cols, self.pandas_categorical = _data_from_pandas(
                self.data, ref_pc)
            cols = [str(c) for c in self.data.columns]
            if self.feature_name == "auto":
                self.feature_name = cols
            # category columns are categorical features whatever the
            # explicit list says (reference basic.py:241-247)
            cat_idx = [cols.index(str(c)) for c in pd_cat_cols]
        else:
            mat = _to_matrix(self.data)
        names = self._names()
        for c in self._categorical_indices(cfg, names):
            if c not in cat_idx:
                cat_idx.append(c)
        td = data_mod.construct(mat, cfg, **self._fields(),
                                feature_names=names,
                                categorical_features=cat_idx,
                                reference=td_ref)
        # a parsed file's rows are kept (unless freed); a matrix or a
        # DataFrame is converted again when asked for (ensure_raw)
        self.raw = mat if path is not None and not self.free_raw_data else None
        if (path is not None and ref is None and cfg.is_save_binary_file
                and sel is None):
            self._save_binary_cache(td)
        self._drop_raw()
        return td

    def _keep_rows(self, mat: np.ndarray, sel: np.ndarray,
                   cfg: Config) -> np.ndarray:
        """``mat``'s rows ``sel``, and the labels, weights and init scores
        of those rows (the query sizes were cut with the draw)."""
        n_full = len(mat)
        if self.label is not None:
            self.label = np.asarray(self.label)[sel]
        if self.weight is not None:
            self.weight = np.asarray(self.weight)[sel]
        if self.init_score is not None:
            init = np.asarray(self.init_score)
            k = max(int(cfg.num_class or 1), 1)
            if k > 1 and init.size == k * n_full:
                # [num_class, N] flattened: the rows within each class
                init = init.reshape(k, n_full)[:, sel].ravel()
            else:
                init = init[sel]
            self.init_score = init
        return mat[sel]

    def _fields(self) -> Dict[str, Optional[np.ndarray]]:
        return dict(
            label=(None if self.label is None
                   else np.asarray(self.label, np.float32).ravel()),
            weight=None if self.weight is None else np.asarray(self.weight),
            group=None if self.group is None else np.asarray(self.group),
            init_score=(None if self.init_score is None
                        else np.asarray(self.init_score)))

    def _side_files(self, path: str, num_data: int) -> None:
        """Weights, query sizes and init scores from ``<data>.weight``,
        ``.query`` and ``.init``, where they were not given."""
        side = data_mod.Metadata(num_data)
        side.load_side_files(path)
        if self.weight is None and side.weight is not None:
            self.weight = side.weight
        if self.group is None and side.query_boundaries is not None:
            self.group = np.diff(side.query_boundaries)
        if self.init_score is None and side.init_score is not None:
            self.init_score = side.init_score

    def _from_binary(self, path: str) -> data_mod.TrainingData:
        """A binary dataset file; the fields given to this Dataset
        override the file's."""
        td = self._load_binary_training_data(path)
        meta = td.metadata
        if self.label is not None:
            meta.set_label(np.asarray(self.label))
        else:
            self.label = meta.label
        if self.weight is not None:
            meta.set_weight(np.asarray(self.weight))
        if self.group is not None:
            meta.set_query(np.asarray(self.group))
        if self.init_score is not None:
            meta.set_init_score(np.asarray(self.init_score))
        return td

    def _from_file_two_round(self, path: str,
                             cfg: Config) -> data_mod.TrainingData:
        """``use_two_round_loading``: the file read twice, binned as it is
        read (dataset_loader.cpp:181-207); no float matrix is kept."""
        self._side_files(path, 0)
        names = self._names() or (read_header_names(path, 0)
                                  if cfg.has_header else None)
        td = data_mod.construct_streamed(
            path, cfg, **self._fields(), feature_names=names,
            categorical_features=self._categorical_indices(cfg, names))
        self.label = td.metadata.label
        if cfg.is_save_binary_file:
            self._save_binary_cache(td)
        self._drop_raw()
        return td

    def _drop_raw(self) -> None:
        if self.free_raw_data:
            self.data = None

    def _save_binary_cache(self, td: data_mod.TrainingData) -> None:
        """``is_save_binary_file``: the "<data>.bin" cache beside the text
        file (dataset_loader.cpp SaveBinaryFile)."""
        bin_path = str(self.data) + ".bin"
        self._write_binary(td, bin_path)
        log.info("Saved binary dataset cache to %s", bin_path)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this dataset's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    # -- fields (lightgbm_tpu/basic.py:394-460) ------------------------------

    def _meta(self):
        return None if self.constructed is None else self.constructed.metadata

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._meta() is not None:
            self._meta().set_label(np.asarray(label))
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._meta() is not None:
            self._meta().set_weight(None if weight is None
                                    else np.asarray(weight))
        return self

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._meta() is not None:
            self._meta().set_query(None if group is None
                                   else np.asarray(group))
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._meta() is not None:
            self._meta().set_init_score(None if init_score is None
                                        else np.asarray(init_score))
        return self

    def _constructed_meta(self):
        if self.constructed is None:
            self.construct(on_device=False)
        return self.constructed.metadata

    def get_label(self):
        label = self._constructed_meta().label
        return None if label is None else np.asarray(label)

    def get_weight(self):
        return self._constructed_meta().weight

    def get_group(self):
        qb = self._constructed_meta().query_boundaries
        return None if qb is None else np.diff(qb)

    def get_init_score(self):
        return self._constructed_meta().init_score

    def set_field(self, field_name: str, data) -> "Dataset":
        setters = {"label": self.set_label, "weight": self.set_weight,
                   "group": self.set_group, "query": self.set_group,
                   "init_score": self.set_init_score}
        if field_name not in setters:
            raise ValueError(f"Unknown field {field_name!r}")
        return setters[field_name](data)

    def get_field(self, field_name: str):
        getters = {"label": self.get_label, "weight": self.get_weight,
                   "group": self.get_group, "query": self.get_group,
                   "init_score": self.get_init_score}
        if field_name not in getters:
            raise ValueError(f"Unknown field {field_name!r}")
        return getters[field_name]()

    # -- names and the reference (lightgbm_tpu/basic.py:452-481) -------------

    def _reset(self) -> None:
        self.constructed = None
        self.bins = None

    def set_feature_name(self, feature_name) -> "Dataset":
        if feature_name == "auto":     # the reference's sentinel: keep
            return self
        self.feature_name = list(feature_name)
        if self.constructed is not None:
            self.constructed.feature_names = list(feature_name)
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """A changed list resets construction: the Dataset is binned
        anew."""
        if (self.constructed is not None
                and categorical_feature != self.categorical_feature):
            log.warning("categorical_feature change after construction "
                        "requires reconstructing the Dataset")
            self._reset()
        self.categorical_feature = categorical_feature
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Another reference resets construction: the Dataset is binned
        anew with its mappers."""
        if self.constructed is not None and reference is not self.reference:
            self._reset()
        self.reference = reference
        return self

    def get_ref_chain(self, ref_limit: int = 100):
        """The datasets reachable through reference links, this one
        included."""
        chain, cur = [], self
        while cur is not None and len(chain) < ref_limit:
            chain.append(cur)
            cur = cur.reference
        return set(chain)

    def ensure_raw(self) -> Optional[np.ndarray]:
        """The float rows for the consumers that need them (``cv``,
        ``subset``, continued training): a parsed file's rows kept from
        construction, the matrix, DataFrame or CSR matrix converted again,
        or a text file parsed again (not a binary file, and only when its
        row count agrees with the constructed one).  None when they are
        gone (``free_raw_data``)."""
        if self.raw is not None:
            return self.raw
        if self.data is None:
            return None
        if _is_frame(self.data):
            return _data_from_pandas(self.data, self.pandas_categorical)[0]
        if _is_path(self.data) and not self._is_binary_cache(str(self.data)):
            cfg = config_from_params(self.params)
            try:
                feats, _, _ = load_text_file(str(self.data),
                                             has_header=cfg.has_header)
            except Exception as e:
                log.warning("Could not recover raw data from %s: %s",
                            self.data, e)
                return None
            if (self.constructed is not None
                    and len(feats) != self.constructed.num_data):
                log.warning("Raw file %s has %d rows but the constructed "
                            "dataset has %d; refusing the mismatch",
                            self.data, len(feats),
                            self.constructed.num_data)
                return None
            self.raw = feats
            return self.raw
        if _is_path(self.data):
            return None
        # a matrix, or a CSR matrix densified chunk by chunk
        return _to_matrix(self.data)

    def num_data(self) -> int:
        if self.constructed is None:
            self.construct(on_device=False)
        return self.constructed.num_data

    def num_feature(self) -> int:
        if self.constructed is None:
            self.construct(on_device=False)
        return self.constructed.num_total_features

    def subset(self, used_indices, params=None) -> "Dataset":
        """Rows ``used_indices`` as a Dataset binned with this dataset's
        mappers (lightgbm_tpu/basic.py:518): labels, weights and init
        scores follow their rows, and with query groups each query keeps
        its selected rows, the queries left empty dropped."""
        if self.constructed is None:
            self.construct(on_device=False)
        raw = self.ensure_raw()
        if raw is None:
            log.fatal("Cannot subset: raw data not in memory (construct "
                      "with free_raw_data=False from an in-memory matrix)")
        idx = np.asarray(used_indices, dtype=np.int64)
        label, w = self.get_label(), self.get_weight()
        init, group = self.get_init_score(), self.get_group()
        sub_group = None
        if group is not None:
            qid = np.repeat(np.arange(len(group)), group.astype(np.int64))
            counts = np.bincount(qid[idx], minlength=len(group))
            sub_group = counts[counts > 0]
        return Dataset(raw[idx],
                       label=None if label is None else label[idx],
                       weight=None if w is None else np.asarray(w)[idx],
                       group=sub_group,
                       init_score=(None if init is None
                                   else np.asarray(init)[idx]),
                       reference=self, params=dict(params or self.params))

    # -- binary dataset files (lightgbm_tpu/basic.py:556-669) ----------------

    def save_binary(self, filename: str, compress: bool = True) -> "Dataset":
        """Write the constructed dataset as a binary dataset file
        (Dataset::SaveBinaryFile); ``compress=False`` skips zlib."""
        if self.constructed is None:
            self.construct(on_device=False)
        self._write_binary(self.constructed, filename, compress)
        return self

    @staticmethod
    def _write_binary(c: data_mod.TrainingData, filename: str,
                      compress: bool = True) -> None:
        mappers = [{
            "num_bin": int(m.num_bin), "bin_type": int(m.bin_type),
            "missing_type": int(m.missing_type),
            "is_trivial": bool(m.is_trivial),
            "bin_upper_bound": (None if m.bin_upper_bound is None
                                else [float(x) for x in m.bin_upper_bound]),
            "categorical_2_bin": (None if m.categorical_2_bin is None
                                  else {str(k): int(v) for k, v
                                        in m.categorical_2_bin.items()}),
            "bin_2_categorical": (None if m.bin_2_categorical is None
                                  else [int(x) for x in m.bin_2_categorical]),
            "min_val": float(m.min_val), "max_val": float(m.max_val),
            "default_bin": int(m.default_bin),
        } for m in c.bin_mappers]
        meta = {
            "mappers": mappers,
            "feature_names": list(c.feature_names or []),
            "num_total_features": int(c.num_total_features),
            "used_features": [int(x) for x in c.used_features],
            "bundles": (None if c.layout is None
                        else [[int(j) for j in b] for b in c.layout.bundles]),
        }
        arrays = {"binned": np.asarray(c.binned),
                  "meta_json": np.frombuffer(
                      json.dumps(meta).encode(), dtype=np.uint8).copy()}
        for key, val in (("label", c.metadata.label),
                         ("weight", c.metadata.weight),
                         ("query_boundaries", c.metadata.query_boundaries),
                         ("init_score", c.metadata.init_score)):
            if val is not None:
                arrays[key] = np.asarray(val)
        buf = io.BytesIO()
        (np.savez_compressed if compress else np.savez)(buf, **arrays)
        with open(filename, "wb") as f:
            f.write(Dataset.BINARY_TOKEN)
            f.write(buf.getvalue())

    @staticmethod
    def _is_binary_cache(filename: str) -> bool:
        try:
            with open(filename, "rb") as f:
                return f.read(len(Dataset.BINARY_TOKEN)) == \
                    Dataset.BINARY_TOKEN
        except OSError:
            return False

    @staticmethod
    def _load_binary_training_data(filename: str) -> data_mod.TrainingData:
        with open(filename, "rb") as f:
            if f.read(len(Dataset.BINARY_TOKEN)) != Dataset.BINARY_TOKEN:
                raise ValueError(f"{filename} is not a lightgbm_tpu binary "
                                 "dataset cache")
            npz = np.load(io.BytesIO(f.read()), allow_pickle=False)
        meta = json.loads(bytes(npz["meta_json"]).decode())
        td = data_mod.TrainingData()
        td.binned = npz["binned"]
        td.used_features = list(meta["used_features"])
        td.feature_names = meta["feature_names"]
        td.num_total_features = meta["num_total_features"]
        td.num_data = len(td.binned)
        for d in meta["mappers"]:
            m = BinMapper()
            m.num_bin = d["num_bin"]
            m.bin_type = d["bin_type"]
            m.missing_type = d["missing_type"]
            m.is_trivial = d["is_trivial"]
            m.bin_upper_bound = (None if d["bin_upper_bound"] is None else
                                 np.asarray(d["bin_upper_bound"], np.float64))
            m.categorical_2_bin = (None if d["categorical_2_bin"] is None
                                   else {int(k): v for k, v
                                         in d["categorical_2_bin"].items()})
            m.bin_2_categorical = d["bin_2_categorical"]
            m.min_val = d["min_val"]
            m.max_val = d["max_val"]
            m.default_bin = d["default_bin"]
            td.bin_mappers.append(m)
        if meta.get("bundles") is not None:
            td.layout = BundleLayout(meta["bundles"], td.bin_mappers)
        td.metadata = data_mod.Metadata(td.num_data)
        td.metadata.set_label(npz["label"] if "label" in npz else None)
        td.metadata.set_weight(npz["weight"] if "weight" in npz else None)
        td.metadata.query_boundaries = (npz["query_boundaries"]
                                        if "query_boundaries" in npz
                                        else None)
        td.metadata.set_init_score(npz["init_score"]
                                   if "init_score" in npz else None)
        return td

    @staticmethod
    def load_binary(filename: str) -> "Dataset":
        """A Dataset of a binary dataset file, constructed on the host."""
        ds = Dataset(None)
        ds.constructed = Dataset._load_binary_training_data(filename)
        return ds


class Booster:
    """Training/prediction handle (basic.py:1213+ semantics, as
    ``lightgbm_tpu/basic.py:671-946``)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, silent: bool = False):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._train_dataset = train_set
        self._valid_datasets: List[Dataset] = []
        self._train_data_name = "training"
        self._attr: Dict[str, str] = {}
        cfg = config_from_params(self.params)
        self.device = resolve_device(cfg.device)
        log.set_verbosity(cfg.verbose)
        # category levels of a DataFrame's columns, from the training
        # Dataset or the model text's last line
        self.pandas_categorical: Optional[List[List]] = None
        if train_set is not None:
            # a streamed training's matrix never lands on the device
            streamed = streams(cfg)
            train_set.construct(cfg, str(self.device),
                                on_device=not streamed)
            self.pandas_categorical = train_set.pandas_categorical
            self.inner = create_boosting(cfg, train_set.constructed,
                                         create_objective(cfg),
                                         None if streamed else train_set.bins)
        else:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            elif model_str is None:
                raise ValueError("Booster needs train_set, model_file or "
                                 "model_str")
            self.inner = GBDT.load_from_string(model_str, cfg)
            self.pandas_categorical = _load_pandas_categorical(model_str)

    # -- training ------------------------------------------------------------

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct(self.inner.config, str(self.device))
        self.inner.add_valid_set(
            data.constructed, data.bins, name,
            data.ensure_raw() if self.inner.models else None)
        self._valid_datasets.append(data)
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True when training should stop.  A
        custom objective ``fobj(preds, train_data) -> (grad, hess)`` gets
        the raw training scores as float64 (``[N]``, or ``K * N`` class
        by class) and returns ``K * N`` gradients and hessians."""
        if fobj is None:
            return self.inner.train_one_iter()
        scores = self.inner.scores.double().cpu().numpy()
        preds = scores.reshape(-1) if scores.shape[0] > 1 else scores[0]
        grad, hess = fobj(preds, self._train_dataset)
        return self.inner.train_one_iter(np.asarray(grad), np.asarray(hess))

    def rollback_one_iter(self) -> "Booster":
        self.inner.rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        return self.inner.current_iteration()

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change parameters between iterations (the ``reset_parameter``
        callback's way to schedule ``learning_rate`` or bagging)."""
        canon = canonicalize_params(params)
        for k, v in canon.items():
            setattr(self.inner.config, k, _parse_value(k, v))
        self.params.update(canon)
        return self

    def attr(self, key: str):
        """A free-form model attribute (reference Booster.attr)."""
        return self._attr.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        for k, v in kwargs.items():
            if v is None:
                self._attr.pop(k, None)
            else:
                self._attr[k] = str(v)
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def free_dataset(self) -> "Booster":
        """Release the training and valid data (bin matrices, scores,
        bags): predict, save and dump still work; training and evaluation
        do not."""
        self._train_dataset = None
        self._valid_datasets = []
        inner = self.inner
        inner.train_set = None
        inner.valid_sets = []
        inner.bins = None
        inner._streamer = inner._streamed = None
        inner.scores = None
        inner._subset = None
        inner._score_stash = None
        return self

    # -- the model -----------------------------------------------------------

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """A leaf's raw output; ``tree_id`` counts the stored trees, the
        boost-from-average tree included (gbdt.cpp:467-483)."""
        return float(self.inner.models[tree_id].leaf_value[leaf_id])

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        self.inner.models[tree_id].leaf_value[leaf_id] = float(value)
        self.inner.model_epoch += 1
        return self

    def merge(self, other: "Booster") -> "Booster":
        """LGBM_BoosterMerge: the other model's trees come first."""
        self.inner.merge_from(other.inner)
        return self

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        return self.inner.feature_importance(importance_type, iteration)

    def feature_name(self) -> List[str]:
        return list(self.inner.feature_names)

    def num_trees(self) -> int:
        return len(self.inner.models)

    def num_feature(self) -> int:
        return self.inner.max_feature_idx + 1

    def dump_model(self, num_iteration: int = -1) -> Dict:
        """JSON model dump (gbdt.cpp DumpModel)."""
        inner = self.inner
        return {
            "name": "tree",
            "version": "v2",
            "num_class": inner.num_class,
            "num_tree_per_iteration": inner.num_class,
            "label_index": inner.label_idx,
            "max_feature_idx": inner.max_feature_idx,
            "objective": (inner.objective.to_string() if inner.objective
                          else ""),
            "average_output": inner.average_output,
            "feature_names": inner.feature_names,
            "tree_info": [t.to_json(i) for i, t in
                          enumerate(inner._kept_trees(num_iteration))],
        }

    # -- evaluation ----------------------------------------------------------

    def eval(self, data: Dataset, name: str, feval=None):
        """The current model's metrics (and ``feval``'s) on ``data``: a
        valid set already added, or a new one scored from scratch."""
        for ds, vs in zip(self._valid_datasets, self.inner.valid_sets):
            if ds is data:
                break
        else:
            self.add_valid(data, name)
            vs = self.inner.valid_sets[-1]
        res = [(name, m, v, h) for (_, m, v, h) in self.inner._eval(
            vs.name, vs.metrics, vs.scores.double().cpu().numpy())]
        return self._add_feval(res, name, feval, vs.scores, data)

    def eval_train(self, feval=None):
        return self._add_feval(self.inner.eval_train(), "training", feval,
                               self.inner.scores, self._train_dataset)

    def eval_valid(self, feval=None):
        res = self.inner.eval_valid()
        if feval is not None:
            for i, vs in enumerate(self.inner.valid_sets):
                ds = (self._valid_datasets[i]
                      if i < len(self._valid_datasets) else None)
                res = self._add_feval(res, vs.name, feval, vs.scores, ds)
        return res

    @staticmethod
    def _add_feval(res, name, feval, scores, dataset):
        """``feval(preds, data)`` -> ``(metric, value, higher_better)`` or a
        list of them, on the raw scores as float64 (``[N]``, or ``K * N``
        class by class)."""
        if feval is None:
            return res
        host = scores.double().cpu().numpy()
        preds = host.reshape(-1) if host.shape[0] > 1 else host[0]
        out = feval(preds, dataset)
        if isinstance(out, tuple):
            out = [out]
        return list(res) + [(name, metric, value, hib)
                            for metric, value, hib in out]

    # -- prediction and files ------------------------------------------------

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False,
                pred_parameter: Optional[Dict[str, Any]] = None,
                device: Optional[str] = None, **kwargs) -> np.ndarray:
        """Scores of ``data`` (a matrix ``[N, F]``, a CSR matrix, a
        DataFrame or a text file's path), computed on ``device`` (default:
        this booster's): ``[N]``, or ``[N, K]`` for K classes; with
        ``pred_leaf`` each tree's leaf ``[N, T]``; with ``pred_contrib``
        the TreeSHAP contributions ``[N, K * (F + 1)]``.  Keys of
        ``pred_parameter`` (``is_predict_raw_score``,
        ``is_predict_leaf_index``, ``pred_early_stop`` and its
        ``_freq`` and ``_margin``, or their aliases) override the keywords
        (``lightgbm_tpu/basic.py:838``); other keywords are accepted and
        not used."""
        dev = resolve_device(device) if device else self.device
        if _is_path(data):
            data = load_text_file(str(data),
                                  has_header=self.inner.config.has_header)[0]
        elif _is_frame(data):
            data = _data_from_pandas(data, self.pandas_categorical)[0]
        else:
            data = _to_matrix(data)
        if num_iteration is None or num_iteration <= 0:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        pp = {k: _parse_value(k, v) for k, v in
              canonicalize_params(pred_parameter or {}).items()}
        return self.inner.predict(
            data, dev, num_iteration,
            raw_score=pp.get("is_predict_raw_score", raw_score),
            pred_leaf=pp.get("is_predict_leaf_index", pred_leaf),
            pred_contrib=pred_contrib,
            pred_early_stop=pp.get("pred_early_stop", pred_early_stop),
            pred_early_stop_freq=pp.get("pred_early_stop_freq"),
            pred_early_stop_margin=pp.get("pred_early_stop_margin"))

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration))
        return self

    def model_to_string(self, num_iteration: int = -1) -> str:
        """The model text; with DataFrame categories, their levels as a
        last ``pandas_categorical:`` line (reference
        _save_pandas_categorical)."""
        if num_iteration is None or num_iteration <= 0:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        s = self.inner.save_model_to_string(num_iteration)
        if self.pandas_categorical:
            s += ("\npandas_categorical:"
                  + json.dumps(self.pandas_categorical) + "\n")
        return s

    # pickling goes through the model text
    def __getstate__(self):
        return {"params": self.params,
                "best_iteration": self.best_iteration,
                "best_score": self.best_score,
                "model_str": self.inner.save_model_to_string(-1)}

    def __setstate__(self, state):
        self.__init__(params=state["params"], model_str=state["model_str"])
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
