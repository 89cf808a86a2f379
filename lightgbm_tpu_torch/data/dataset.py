"""Binned dataset container: the dense path of the reference ``Dataset``.

The reference (``include/LightGBM/dataset.h:280-570``,
``src/io/dataset.cpp``) stores per-group ``Bin`` columns; the port keeps one
dense row-major ``[N, F]`` matrix of bin indices (its GPU learner's
``sparse_threshold=1`` recipe), uint8 when every column has at most 256
bins and uint16 otherwise (:func:`bin_dtype`, the JAX package's rule),
built on the host and moved to the device once by
:class:`~lightgbm_tpu_torch.basic.Dataset`.  With EFB
(``enable_bundle``, :mod:`.bundling`) a column is a bundle of mutually
exclusive features; the logical features are then the used features in
bundle order, and the meta carries each one's column and first slot.

Construction samples ``bin_construct_sample_cnt`` rows, fits a
:class:`~.binning.BinMapper` per feature, finds the bundles and bins every
column (``DatasetLoader::CostructFromSampleData``, dataset_loader.cpp:482+).
Valid datasets and subsets reuse their reference's mappers and layout.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..parallel import sync
from ..utils import log
from ..utils.random import make_rng, sample_k
from .binning import BIN_TYPE_CATEGORICAL, BIN_TYPE_NUMERICAL, BinMapper
from .bundling import BundleLayout, build_bundled_column, find_bundles
from .metadata import Metadata

# features per block in the construction loops: a bounded transpose
# working set (~2 MB of float64 at 64 columns)
_COL_BLOCK = 64


class TrainingData:
    """Fully constructed binned dataset (host side)."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bin_mappers: List[BinMapper] = []
        # original feature index per LOGICAL feature
        self.used_features: List[int] = []
        self.binned: Optional[np.ndarray] = None   # [N, F_physical] u8/u16
        self.layout: Optional[BundleLayout] = None  # EFB (None: 1:1)
        self.metadata: Metadata = Metadata()
        self.feature_names: List[str] = []

    @property
    def bundled(self) -> bool:
        return self.layout is not None and self.layout.has_bundles

    def feature_meta(self) -> Dict[str, np.ndarray]:
        """Per-logical-feature meta arrays consumed by the grower, with
        the bundle decode maps ``col`` and ``offset`` when EFB bundled
        (``lightgbm_tpu/data/dataset.py:55-68``)."""
        mappers = [self.bin_mappers[i] for i in self.used_features]
        out = {
            "num_bin": np.asarray([m.num_bin for m in mappers], np.int32),
            "missing_type": np.asarray([m.missing_type for m in mappers],
                                       np.int32),
            "default_bin": np.asarray([m.default_bin for m in mappers],
                                      np.int32),
            "is_categorical": np.asarray(
                [m.bin_type == BIN_TYPE_CATEGORICAL for m in mappers], bool),
        }
        if self.bundled:
            out["col"] = np.asarray(self.layout.sub_col, np.int32)
            out["offset"] = np.asarray(self.layout.sub_offset, np.int32)
        return out

    def col_num_bins(self) -> List[int]:
        """Bins of each physical column."""
        if self.bundled:
            return list(self.layout.col_num_bin)
        return [self.bin_mappers[i].num_bin for i in self.used_features]

    def to_blocks(self, chunk_rows: int, pin: bool = False):
        """The bin matrix as host row blocks for streamed training
        (``data_stream=chunked``, ``lightgbm_tpu/data/dataset.py:70``),
        which :class:`~.stream.BlockStreamer` moves through the device.
        ``pin`` (a card) first moves the matrix into page-locked memory
        for good: this dataset keeps that copy instead of its pageable
        one."""
        from .stream import make_block_store, pin_matrix
        if self.binned is None:
            log.fatal("Cannot build streamed blocks: dataset has no "
                      "binned matrix")
        if pin:
            self.binned = pin_matrix(self.binned)
        return make_block_store(self.binned, chunk_rows)

    def max_num_bin(self) -> int:
        """Histogram width: max bins over the PHYSICAL columns."""
        if self.bundled:
            return self.layout.max_col_bins()
        if not self.used_features:
            return 1
        return max(self.bin_mappers[i].num_bin for i in self.used_features)


def construct(data: np.ndarray, config: Config,
              label: Optional[np.ndarray] = None,
              weight: Optional[np.ndarray] = None,
              group: Optional[np.ndarray] = None,
              init_score: Optional[np.ndarray] = None,
              feature_names: Optional[Sequence[str]] = None,
              categorical_features: Optional[Sequence[int]] = None,
              reference: Optional[TrainingData] = None) -> TrainingData:
    """Build a TrainingData from a raw ``[N, F]`` feature matrix
    (dataset.py:92); ``categorical_features`` are column indices, ``group``
    each query's size, ``init_score`` ``[N * num_class]`` raw scores."""
    data = np.asarray(data)
    if data.ndim != 2:
        log.fatal("Training data must be 2-dimensional")
    ds = _new_dataset(*data.shape, feature_names)
    if reference is not None:
        _adopt_reference(ds, reference)
    else:
        idx = _sample_indices(config, ds.num_data)
        sample = np.asarray(data if idx is None else data[idx],
                            dtype=np.float64)
        _fit_from_sample(ds, sample, config,
                         set(int(c) for c in (categorical_features or [])))
    ds.binned = _allocate_binned(ds)
    _bin_rows(ds, data, ds.binned)
    _set_metadata(ds, label, weight, group, init_score)
    return ds


def construct_streamed(path: str, config: Config,
                       label: Optional[np.ndarray] = None,
                       weight: Optional[np.ndarray] = None,
                       group: Optional[np.ndarray] = None,
                       init_score: Optional[np.ndarray] = None,
                       feature_names: Optional[Sequence[str]] = None,
                       categorical_features: Optional[Sequence[int]] = None,
                       label_idx: int = 0,
                       chunk_rows: int = 200_000) -> TrainingData:
    """Two-round construction from a text file (``use_two_round_loading``,
    dataset_loader.cpp:181-207 and 265+; ``lightgbm_tpu/data/dataset.py:
    310``).  Round 1 reads the file once for the sampled rows (the same
    indices as the in-memory path, so the mappers are identical) and all
    labels; round 2 reads it again and bins each chunk straight into the
    bin matrix.  The file's float64 matrix never exists whole."""
    from .parser import count_data_rows, iter_parsed_chunks

    num_data, num_features = count_data_rows(path, config.has_header,
                                             label_idx)
    ds = _new_dataset(num_data, num_features, feature_names)
    idx = _sample_indices(config, num_data)
    sample_idx = np.arange(num_data) if idx is None else idx

    def chunks():
        return iter_parsed_chunks(path, config.has_header, label_idx,
                                  chunk_rows, ncol=num_features)

    sample = np.empty((len(sample_idx), num_features), dtype=np.float64)
    labels = np.empty(num_data, dtype=np.float32)
    row0 = 0
    for feats, labs in chunks():
        row1 = row0 + len(labs)
        labels[row0:row1] = labs
        lo, hi = np.searchsorted(sample_idx, [row0, row1])
        if hi > lo:
            sample[lo:hi] = feats[sample_idx[lo:hi] - row0]
        row0 = row1
    if row0 != num_data:
        log.fatal("Streamed loading row mismatch: counted %d, parsed %d",
                  num_data, row0)
    _fit_from_sample(ds, sample, config,
                     set(int(c) for c in (categorical_features or [])))
    del sample
    ds.binned = _allocate_binned(ds)
    row0 = 0
    for feats, _ in chunks():
        _bin_rows(ds, feats, ds.binned[row0:row0 + len(feats)])
        row0 += len(feats)
    _set_metadata(ds, labels if label is None else label, weight, group,
                  init_score)
    return ds


def construct_csr(csr, config: Config,
                  label: Optional[np.ndarray] = None,
                  weight: Optional[np.ndarray] = None,
                  group: Optional[np.ndarray] = None,
                  init_score: Optional[np.ndarray] = None,
                  feature_names: Optional[Sequence[str]] = None,
                  categorical_features: Optional[Sequence[int]] = None,
                  reference: Optional[TrainingData] = None) -> TrainingData:
    """Construction from a host :class:`~.sparse.CsrMatrix` without
    densifying it (``lightgbm_tpu/data/dataset.py:382``): only the sampled
    rows are densified to fit the mappers (the same indices as the
    in-memory path), then bounded dense chunks are binned straight into
    the bin matrix.  The bins, and so the trees, are those of the dense
    matrix."""
    ds = _new_dataset(*csr.shape, feature_names)
    if reference is not None:
        _adopt_reference(ds, reference)
    else:
        idx = _sample_indices(config, ds.num_data)
        _fit_from_sample(ds, csr.rows(np.arange(ds.num_data) if idx is None
                                      else idx), config,
                         set(int(c) for c in (categorical_features or [])))
    ds.binned = _allocate_binned(ds)
    for r0, block in csr.iter_dense_chunks():
        _bin_rows(ds, block, ds.binned[r0:r0 + len(block)])
    _set_metadata(ds, label, weight, group, init_score)
    return ds


def _new_dataset(num_data: int, num_features: int,
                 feature_names: Optional[Sequence[str]]) -> TrainingData:
    ds = TrainingData()
    ds.num_data = num_data
    ds.num_total_features = num_features
    ds.feature_names = (list(feature_names) if feature_names
                        else [f"Column_{i}" for i in range(num_features)])
    return ds


def _adopt_reference(ds: TrainingData, reference: TrainingData) -> None:
    """A valid set or subset bins with its reference's mappers and
    layout."""
    if ds.num_total_features != reference.num_total_features:
        log.fatal("Validation data has %d features, training data has %d",
                  ds.num_total_features, reference.num_total_features)
    ds.bin_mappers = reference.bin_mappers
    ds.used_features = reference.used_features
    ds.feature_names = reference.feature_names
    ds.layout = reference.layout


def _sample_indices(config: Config, num_data: int) -> Optional[np.ndarray]:
    """The rows the mappers are fitted on: ``bin_construct_sample_cnt`` of
    them drawn from ``data_random_seed``, or None for all rows."""
    sample_cnt = min(config.bin_construct_sample_cnt, num_data)
    if sample_cnt >= num_data:
        return None
    return sample_k(make_rng(config.data_random_seed), num_data, sample_cnt)


def bin_dtype(max_num_bin: int):
    """The bin matrix's type (``lightgbm_tpu/data/dataset.py:140``): uint8
    when every column has at most 256 bins, else uint16.  A categorical
    column keeps categories past ``max_bin`` until they cover 99 % of the
    rows, so it may need uint16 at the default ``max_bin``."""
    return np.uint8 if max_num_bin <= 256 else np.uint16


def _allocate_binned(ds: TrainingData) -> np.ndarray:
    """The ``[N, columns]`` bin matrix of the fitted layout."""
    ncols = (ds.layout.num_columns if ds.bundled
             else len(ds.used_features))
    return np.empty((ds.num_data, ncols), dtype=bin_dtype(ds.max_num_bin()))


def _set_metadata(ds: TrainingData, label, weight, group,
                  init_score) -> None:
    ds.metadata = Metadata(ds.num_data)
    ds.metadata.set_label(label if label is not None
                          else np.zeros(ds.num_data, dtype=np.float32))
    ds.metadata.set_weight(weight)
    ds.metadata.set_query(group)
    ds.metadata.set_init_score(init_score)


def _columns_T(data: np.ndarray, cols, chunk_rows: int = 4096) -> np.ndarray:
    """Contiguous ``[len(cols), N]`` float64 transpose of ``data[:, cols]``,
    copied in row chunks so every read stays sequential."""
    cols = np.asarray(cols, dtype=np.intp)
    n = data.shape[0]
    out = np.empty((len(cols), n), dtype=np.float64)
    for r0 in range(0, n, chunk_rows):
        r1 = min(n, r0 + chunk_rows)
        out[:, r0:r1] = data[r0:r1, cols].T
    return out


def _fit_from_sample(ds: TrainingData, sample: np.ndarray,
                     config: Config, cat_set) -> None:
    """Fit per-feature BinMappers from the sampled rows, filter trivial
    features (FindBin) and decide the EFB layout (FindGroups,
    ``lightgbm_tpu/data/dataset.py:180-290``).  Over several processes
    (the reference's distributed FindBin, dataset_loader.cpp:737-816)
    process p fits the features j = p (mod P) from its own sample, the
    fitted mappers are allgathered, and process 0 decides the bundles,
    which it broadcasts."""
    num_features = ds.num_total_features
    n_proc, rank = sync.process_count(), sync.process_index()
    mine = [j for j in range(num_features)
            if n_proc == 1 or j % n_proc == rank]
    min_split_data = int(config.min_data_in_leaf * len(sample)
                         / max(ds.num_data, 1))
    fitted: Dict[int, BinMapper] = {}
    for b0 in range(0, len(mine), _COL_BLOCK):
        chunk = mine[b0:b0 + _COL_BLOCK]
        for j, col in zip(chunk, _columns_T(sample, chunk)):
            # sparse convention: pass non-zero values; zeros implied by total count
            nz = col[(col != 0) | np.isnan(col)]
            fitted[j] = BinMapper.fit(
                nz, total_sample_cnt=len(col), max_bin=config.max_bin,
                min_data_in_bin=config.min_data_in_bin,
                min_split_data=min_split_data,
                bin_type=(BIN_TYPE_CATEGORICAL if j in cat_set
                          else BIN_TYPE_NUMERICAL),
                use_missing=config.use_missing,
                zero_as_missing=config.zero_as_missing)
    if n_proc > 1:
        for part in sync.allgather_object(fitted):
            fitted.update(part)
    mappers = [fitted[j] for j in range(num_features)]
    ds.bin_mappers = mappers
    ds.used_features = [j for j, m in enumerate(mappers) if not m.is_trivial]
    if not ds.used_features:
        log.fatal("Cannot construct Dataset: all features are trivial (constant)")
    if config.enable_bundle and len(ds.used_features) > 1:
        bundles = None      # rank 0 decides, every other rank receives
        if n_proc == 1 or rank == 0:
            bs = sample[:min(len(sample), 20000)]
            nonzero = np.zeros((bs.shape[0], len(ds.used_features)),
                               dtype=bool)
            for b0 in range(0, len(ds.used_features), _COL_BLOCK):
                chunk = ds.used_features[b0:b0 + _COL_BLOCK]
                cols_t = _columns_T(bs, chunk)
                nonzero[:, b0:b0 + len(chunk)] = ((cols_t != 0)
                                                  | np.isnan(cols_t)).T
            bundles = find_bundles(
                nonzero, [mappers[j].num_bin for j in ds.used_features],
                config.max_conflict_rate)
        if n_proc > 1:
            bundles = sync.broadcast_object(bundles)
        layout = BundleLayout([[ds.used_features[k] for k in b]
                               for b in bundles], mappers)
        if layout.has_bundles:
            ds.layout = layout
            ds.used_features = layout.sub_features
            log.info("EFB bundled %d features into %d columns",
                     len(layout.sub_features), layout.num_columns)


def _bin_rows(ds: TrainingData, data: np.ndarray, out: np.ndarray) -> None:
    """Bin raw rows into ``out`` (same row count) with the fitted mappers
    and, when bundled, the layout (one block of at most ``_COL_BLOCK``
    source features at a time)."""
    if ds.bundled:
        lay = ds.layout
        offsets = {}
        for k, c in enumerate(lay.sub_col):
            offsets.setdefault(c, []).append(lay.sub_offset[k])
        blocks, cur, n_src = [], [], 0
        for col, bundle in enumerate(lay.bundles):
            if cur and n_src + len(bundle) > _COL_BLOCK:
                blocks.append(cur)
                cur, n_src = [], 0
            cur.append((col, bundle))
            n_src += len(bundle)
        if cur:
            blocks.append(cur)
        buf = np.empty(data.shape[0], dtype=out.dtype)
        for block in blocks:
            src = sorted({j for _, b in block for j in b})
            cols_t = _columns_T(data, src)
            lookup = {j: cols_t[k] for k, j in enumerate(src)}
            for col, bundle in block:
                if len(bundle) == 1:
                    out[:, col] = ds.bin_mappers[bundle[0]].value_to_bin(
                        lookup[bundle[0]])
                else:
                    out[:, col] = build_bundled_column(
                        lookup, bundle, ds.bin_mappers, offsets[col], buf)
        return
    for b0 in range(0, len(ds.used_features), _COL_BLOCK):
        chunk = ds.used_features[b0:b0 + _COL_BLOCK]
        cols_t = _columns_T(data, chunk)
        for k, j in enumerate(chunk):
            out[:, b0 + k] = ds.bin_mappers[j].value_to_bin(cols_t[k])
