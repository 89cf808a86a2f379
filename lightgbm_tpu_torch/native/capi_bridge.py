"""Python side of the port's training C ABI (``gbt_capi_train.cpp``;
``lightgbm_tpu/native/capi_bridge.py``).

Each function is called from the C shim with plain buffers and handles and
delegates to the port's ``Dataset`` and ``Booster``, as the reference's
``c_api.cpp`` is a thin shim over its C++ ``GBDT``
(``include/LightGBM/c_api.h:37-719``).  Buffers that arrive from C are
copied before use: the caller may free them as soon as the call returns
(the reference's ``LGBM_DatasetCreateFromMat`` contract).

The device is the params string's: ``device=cpu`` trains and predicts on
the CPU, anything else on the card; without a card ``GBTN_BoosterCreate``
fails, and ``GBTN_GetLastError`` says why.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _parse_params(params: str) -> Dict[str, str]:
    """Space-separated ``key=value`` pairs — the reference c_api params
    convention (c_api.cpp ConfigStr2Map)."""
    out: Dict[str, str] = {}
    for tok in (params or "").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def dataset_from_mat(mv_data, nrow, ncol, params, mv_label, reference=None):
    from ..basic import Dataset
    X = np.frombuffer(mv_data, dtype=np.float64,
                      count=nrow * ncol).reshape(nrow, ncol).copy()
    label = (None if mv_label is None
             else np.frombuffer(mv_label, dtype=np.float32,
                                count=nrow).copy())
    return Dataset(X, label=label, reference=reference,
                   params=_parse_params(params))


def booster_create(dataset, params):
    from ..basic import Booster
    return Booster(params=_parse_params(params), train_set=dataset)


def booster_update(booster) -> bool:
    return bool(booster.update())


def booster_save(booster, num_iteration, filename) -> bool:
    booster.save_model(filename, num_iteration=num_iteration)
    return True


def booster_num_class(booster) -> int:
    return int(max(booster.inner.num_class, 1))


def booster_predict_into(booster, mv_in, nrow, ncol, mv_out) -> bool:
    X = np.frombuffer(mv_in, dtype=np.float64,
                      count=nrow * ncol).reshape(nrow, ncol)
    pred = np.asarray(booster.predict(X), dtype=np.float64)
    k = booster_num_class(booster)
    out = np.frombuffer(mv_out, dtype=np.float64,
                        count=nrow * k).reshape(nrow, k)
    out[:] = pred.reshape(nrow, k)
    return True


# ------------------------------------------------------------------ datasets
# Field dtype codes follow the reference (c_api.h C_API_DTYPE_*):
# 0 = float32, 1 = float64, 2 = int32.
_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
                np.dtype(np.int32): 2}


def dataset_from_file(filename, params, reference):
    from ..basic import Dataset
    return Dataset(filename, reference=reference,
                   params=_parse_params(params))


def _csr_matrix(mv_indptr, nindptr, mv_indices, mv_data, nelem, ncol):
    """The CSR triplet as a host :class:`~..data.sparse.CsrMatrix`,
    densified one bounded row chunk at a time when it is binned: the full
    ``[nrow, ncol]`` float64 matrix is never made on ingest."""
    from ..data.sparse import CsrMatrix
    indptr = np.frombuffer(mv_indptr, dtype=np.int32, count=nindptr)
    indices = np.frombuffer(mv_indices, dtype=np.int32, count=nelem)
    data = np.frombuffer(mv_data, dtype=np.float64, count=nelem)
    return CsrMatrix(indptr, indices, data, ncol)


def dataset_from_csr(mv_indptr, nindptr, mv_indices, mv_data, nelem, ncol,
                     params, reference):
    from ..basic import Dataset
    csr = _csr_matrix(mv_indptr, nindptr, mv_indices, mv_data, nelem, ncol)
    return Dataset(csr, reference=reference, params=_parse_params(params))


def dataset_from_csc(mv_colptr, ncolptr, mv_indices, mv_data, nelem, nrow,
                     params, reference):
    from ..basic import Dataset
    colptr = np.frombuffer(mv_colptr, dtype=np.int32, count=ncolptr)
    indices = np.frombuffer(mv_indices, dtype=np.int32, count=nelem)
    data = np.frombuffer(mv_data, dtype=np.float64, count=nelem)
    ncol = ncolptr - 1
    X = np.zeros((nrow, ncol), dtype=np.float64)
    col_of = np.repeat(np.arange(ncol), np.diff(colptr).astype(np.int64))
    X[indices, col_of] = data
    return Dataset(X, reference=reference, params=_parse_params(params))


def dataset_empty(nrow, ncol, params, reference):
    """Streaming construction start (LGBM_DatasetCreateFromSampledColumn +
    PushRows flow): rows arrive later; construction stays lazy until the
    first consumer."""
    from ..basic import Dataset
    X = np.zeros((nrow, ncol), dtype=np.float64)
    return Dataset(X, reference=reference, params=_parse_params(params))


def _push_target(ds, nrow, ncol, start_row) -> np.ndarray:
    """The preallocated dataset matrix a PushRows block lands in, with
    the shared contract checks."""
    X = ds.data
    if ds.constructed is not None or not isinstance(X, np.ndarray):
        raise RuntimeError("PushRows on an already-constructed dataset")
    if ncol != X.shape[1] or start_row + nrow > X.shape[0]:
        raise ValueError(f"push block [{start_row}:{start_row + nrow}) x "
                         f"{ncol} outside dataset {X.shape}")
    return X


def dataset_push_rows(ds, mv_data, nrow, ncol, start_row) -> bool:
    X = _push_target(ds, nrow, ncol, start_row)
    X[start_row:start_row + nrow] = np.frombuffer(
        mv_data, dtype=np.float64, count=nrow * ncol).reshape(nrow, ncol)
    return True


def dataset_push_rows_csr(ds, mv_indptr, nindptr, mv_indices, mv_data,
                          nelem, ncol, start_row) -> bool:
    csr = _csr_matrix(mv_indptr, nindptr, mv_indices, mv_data, nelem, ncol)
    X = _push_target(ds, csr.nrow, ncol, start_row)
    # budget-bounded chunks write straight into the preallocated rows —
    # no full dense copy of the pushed block ever exists
    for r0, block in csr.iter_dense_chunks():
        X[start_row + r0:start_row + r0 + len(block)] = block
    return True


def dataset_set_field(ds, name, mv_data, num_el, dtype_code) -> bool:
    if dtype_code not in _DTYPES:
        raise ValueError(f"unknown field dtype code {dtype_code}")
    data = None if mv_data is None else np.frombuffer(
        mv_data, dtype=_DTYPES[dtype_code], count=num_el).copy()
    ds.set_field(name, data)
    return True


def dataset_get_field(ds, name):
    """Returns (buffer_address, length, dtype_code) with the backing array
    cached on the handle so the pointer stays valid (reference GetField
    returns a pointer into the Dataset's own storage)."""
    if name in ("group", "query"):
        # the C contract returns CUMULATIVE query boundaries, int32,
        # num_queries+1 entries (c_api.cpp DatasetGetField "group") — not
        # the per-query counts the python-level get_field uses
        qb = ds._constructed_meta().query_boundaries
        if qb is None:
            return (0, 0, 0)
        val = np.asarray(qb, dtype=np.int32)
    else:
        val = ds.get_field(name)
    if val is None:
        return (0, 0, 0)
    arr = np.ascontiguousarray(val)
    if arr.dtype not in _DTYPE_CODES:
        arr = arr.astype(np.float64)
    cache = getattr(ds, "_capi_field_cache", {})
    old = cache.get(name)
    if (old is not None and old.dtype == arr.dtype
            and np.array_equal(old, arr)):
        arr = old          # unchanged field: keep earlier pointers valid
    else:
        cache[name] = arr  # changed (SetField): old pointer goes stale,
        ds._capi_field_cache = cache        # like the reference's storage
    return (arr.ctypes.data, int(arr.size), _DTYPE_CODES[arr.dtype])


def dataset_num_data(ds) -> int:
    return int(ds.num_data())


def dataset_num_feature(ds) -> int:
    return int(ds.num_feature())


def dataset_set_feature_names(ds, names) -> bool:
    ds.set_feature_name(list(names))
    return True


def dataset_feature_names(ds):
    ds._constructed_meta()
    return list(ds.constructed.feature_names or [])


def dataset_save_binary(ds, filename) -> bool:
    ds.save_binary(filename)
    return True


def dataset_load_binary(filename):
    from ..basic import Dataset
    return Dataset.load_binary(filename)


def dataset_subset(ds, mv_indices, num, params):
    idx = np.frombuffer(mv_indices, dtype=np.int32, count=num).copy()
    return ds.subset(idx, params=_parse_params(params) or None)


# ------------------------------------------------------------------ boosters

def booster_from_file(filename):
    from ..basic import Booster
    return Booster(model_file=filename)


def booster_from_string(model_str):
    from ..basic import Booster
    return Booster(model_str=model_str)


def booster_merge(dst, src) -> bool:
    dst.merge(src)
    return True


def booster_add_valid(bst, ds, name) -> bool:
    bst.add_valid(ds, name)
    return True


def booster_reset_training_data(bst, ds) -> bool:
    """Reference GBDT::ResetTrainingData: the model keeps its trees and
    boosts on from them on the new data, so the new trainer's scores start
    from the model's raw predictions on that data (continued training's
    recipe, ``engine.train(init_model=)``).  The valid sets stay attached,
    their scores replayed from the model."""
    from ..basic import Booster
    prev = bst.inner
    prev_valid_ds = list(getattr(bst, "_valid_datasets", []))
    prev_valid_names = [vs.name for vs in prev.valid_sets]
    fresh = Booster(params=bst.params, train_set=ds)
    inner = fresh.inner
    if prev.models:
        raw = ds.ensure_raw()
        if raw is None:
            raise RuntimeError("ResetTrainingData requires in-memory raw "
                               "data (free_raw_data=False)")
        init = prev.predictor(inner.device).predict_raw(np.asarray(raw))
        inner.scores += torch.from_numpy(init.astype(np.float32)).to(
            inner.device)
        inner.models = list(prev.models)
        inner.num_init_iteration = prev.current_iteration()
        inner.boost_from_average_ = prev.boost_from_average_
    bst.inner = inner
    bst._train_dataset = ds
    bst._valid_datasets = []
    for vds, name in zip(prev_valid_ds, prev_valid_names):
        bst.add_valid(vds, name)   # replays the model onto the valid scores
    return True


def booster_reset_parameter(bst, params) -> bool:
    bst.reset_parameter(_parse_params(params))
    return True


def booster_update_custom(bst, mv_grad, mv_hess, n) -> bool:
    grad = np.frombuffer(mv_grad, dtype=np.float32, count=n).copy()
    hess = np.frombuffer(mv_hess, dtype=np.float32, count=n).copy()
    return bool(bst.inner.train_one_iter(grad, hess))


def booster_rollback(bst) -> bool:
    bst.rollback_one_iter()
    return True


def booster_current_iteration(bst) -> int:
    return int(bst.current_iteration())


def booster_num_feature(bst) -> int:
    return int(bst.num_feature())


def booster_feature_names(bst):
    return list(bst.feature_name())


def _eval_results(bst, data_idx):
    """(name, metric, value, higher_better) rows for one data index:
    0 = train, i>0 = i-th validation set (reference GetEval convention)."""
    if data_idx == 0:
        return bst.eval_train()
    sets = bst.inner.valid_sets
    if data_idx > len(sets):
        raise IndexError(f"data_idx {data_idx} out of range "
                         f"({len(sets)} valid sets)")
    vs = sets[data_idx - 1]
    return bst.inner._eval(vs.name, vs.metrics,
                           vs.scores.double().cpu().numpy())


def booster_eval_counts(bst) -> int:
    metrics = bst.inner.train_metrics or (
        bst.inner.valid_sets[0].metrics if bst.inner.valid_sets else [])
    return sum(len(m.names()) for m in metrics)


def booster_eval_names(bst):
    metrics = bst.inner.train_metrics or (
        bst.inner.valid_sets[0].metrics if bst.inner.valid_sets else [])
    return [n for m in metrics for n in m.names()]


def booster_get_eval(bst, data_idx):
    vals = np.asarray([v for (_, _, v, _) in _eval_results(bst, data_idx)],
                      dtype=np.float64)
    cache = getattr(bst, "_capi_eval_cache", {})
    cache[data_idx] = vals
    bst._capi_eval_cache = cache
    return (vals.ctypes.data, int(vals.size))


def booster_num_predict(bst, data_idx) -> int:
    """O(1) element count of GetPredict's output (no conversion work)."""
    if data_idx == 0:
        scores = bst.inner.scores
    else:
        sets = bst.inner.valid_sets
        if data_idx > len(sets):
            raise IndexError(f"data_idx {data_idx} out of range")
        scores = sets[data_idx - 1].scores
    return int(np.prod(scores.shape))


def booster_get_predict(bst, data_idx):
    """Predictions of the train (0) / i-th valid (i) set, row-major
    [n, num_class] — reference LGBM_BoosterGetPredict semantics
    (GBDT::GetPredictAt, gbdt.cpp:756): ConvertOutput (sigmoid/softmax)
    applies only when the model is NOT average_output; RF models return
    the raw scores untouched."""
    if data_idx == 0:
        scores = bst.inner.scores
    else:
        sets = bst.inner.valid_sets
        if data_idx > len(sets):
            raise IndexError(f"data_idx {data_idx} out of range")
        scores = sets[data_idx - 1].scores
    scores = scores.double().cpu().numpy()
    if bst.inner.objective is not None and not bst.inner.average_output:
        scores = np.asarray(bst.inner.objective.convert_output(scores),
                            np.float64)
    out = np.ascontiguousarray(scores.T)         # [n, k]
    cache = getattr(bst, "_capi_pred_cache", {})
    cache[data_idx] = out
    bst._capi_pred_cache = cache
    return (out.ctypes.data, int(out.size))


def booster_get_leaf_value(bst, tree_idx, leaf_idx) -> float:
    return float(bst.get_leaf_output(tree_idx, leaf_idx))


def booster_set_leaf_value(bst, tree_idx, leaf_idx, value) -> bool:
    bst.set_leaf_output(tree_idx, leaf_idx, value)
    return True


def booster_model_string(bst, num_iteration) -> str:
    return bst.model_to_string(num_iteration)


def booster_dump_json(bst, num_iteration) -> str:
    import json
    return json.dumps(bst.dump_model(num_iteration))


def booster_calc_num_predict(bst, nrow, predict_type, num_iteration) -> int:
    k = booster_num_class(bst)
    if predict_type == 2:   # C_API_PREDICT_LEAF_INDEX
        iters = len(bst.inner.models) // max(k, 1)
        if num_iteration > 0:
            iters = min(num_iteration, iters)
        return int(nrow * iters * k)
    return int(nrow * k)


def _predict_array(bst, X, predict_type, num_iteration):
    ni = num_iteration if num_iteration and num_iteration > 0 else -1
    if predict_type == 2:
        return np.asarray(bst.predict(X, num_iteration=ni, pred_leaf=True),
                          dtype=np.float64)
    raw = predict_type == 1    # C_API_PREDICT_RAW_SCORE
    return np.asarray(bst.predict(X, num_iteration=ni, raw_score=raw),
                      dtype=np.float64)


def booster_predict_full_into(bst, mv_in, nrow, ncol, predict_type,
                              num_iteration, mv_out, out_capacity) -> int:
    """Dense predict with the reference's predict_type codes
    (0 normal / 1 raw / 2 leaf index); returns the element count."""
    X = np.frombuffer(mv_in, dtype=np.float64,
                      count=nrow * ncol).reshape(nrow, ncol)
    pred = _predict_array(bst, X, predict_type, num_iteration)
    flat = pred.reshape(-1)
    if flat.size > out_capacity:
        raise ValueError(f"output buffer too small: need {flat.size}, "
                         f"have {out_capacity}")
    out = np.frombuffer(mv_out, dtype=np.float64, count=flat.size)
    out[:] = flat
    return int(flat.size)


def booster_predict_csr_into(bst, mv_indptr, nindptr, mv_indices, mv_data,
                             nelem, ncol, predict_type, num_iteration,
                             mv_out, out_capacity) -> int:
    csr = _csr_matrix(mv_indptr, nindptr, mv_indices, mv_data, nelem, ncol)
    out = np.frombuffer(mv_out, dtype=np.float64, count=out_capacity)
    wrote = 0
    # predict one budget-bounded dense chunk at a time; per-row output
    # width is fixed, so chunk outputs concatenate contiguously
    for r0, block in csr.iter_dense_chunks():
        flat = _predict_array(bst, block, predict_type,
                              num_iteration).reshape(-1)
        if wrote + flat.size > out_capacity:
            raise ValueError(f"output buffer too small: need at least "
                             f"{wrote + flat.size}, have {out_capacity}")
        out[wrote:wrote + flat.size] = flat
        wrote += flat.size
    return int(wrote)


def booster_predict_csc_into(bst, mv_colptr, ncolptr, mv_indices, mv_data,
                             nelem, nrow, predict_type, num_iteration,
                             mv_out, out_capacity) -> int:
    colptr = np.frombuffer(mv_colptr, dtype=np.int32, count=ncolptr)
    indices = np.frombuffer(mv_indices, dtype=np.int32, count=nelem)
    data = np.frombuffer(mv_data, dtype=np.float64, count=nelem)
    ncol = ncolptr - 1
    X = np.zeros((nrow, ncol), dtype=np.float64)
    col_of = np.repeat(np.arange(ncol), np.diff(colptr).astype(np.int64))
    X[indices, col_of] = data
    pred = _predict_array(bst, X, predict_type, num_iteration)
    flat = pred.reshape(-1)
    if flat.size > out_capacity:
        raise ValueError(f"output buffer too small: need {flat.size}, "
                         f"have {out_capacity}")
    out = np.frombuffer(mv_out, dtype=np.float64, count=flat.size)
    out[:] = flat
    return int(flat.size)


def booster_predict_for_file(bst, data_filename, has_header,
                             result_filename, predict_type,
                             num_iteration) -> bool:
    """LGBM_BoosterPredictForFile: stream a text file through predict and
    write one line per row (tab-separated for multi-output)."""
    from ..data.parser import load_text_file
    feats, _, _ = load_text_file(data_filename, has_header=bool(has_header))
    pred = _predict_array(bst, feats, predict_type, num_iteration)
    pred2d = pred.reshape(len(feats), -1)
    with open(result_filename, "w") as f:
        for row in pred2d:
            f.write("\t".join(repr(float(v)) for v in row) + "\n")
    return True
