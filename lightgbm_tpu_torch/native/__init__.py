"""ctypes bindings of the port's native host library
(``gbt_native.cpp`` and ``gbt_capi_train.cpp``; ``lightgbm_tpu/native/``).

The reference keeps text parsing, value-to-bin quantization and model
prediction in C++ (parser.hpp, bin.cpp, predictor.hpp); this library is
the port's copy of that host runtime, OpenMP-parallel, together with the
training C ABI (``GBTN_*``), whose embedded interpreter delegates to the
port's ``Dataset`` and ``Booster`` through :mod:`.capi_bridge`.

The library is built at first use with ``g++ -O3 -fopenmp`` into
``lightgbm_tpu_torch/_build/`` under a name that hashes its sources and its
command, written to a temporary name and renamed into place, so that
parallel processes never load a half-written file.  It is linked against
``libpython`` where the host has it (standalone C programs can then train
through the ABI), else built as the unlinked shim, whose ``Py_*`` symbols
the hosting interpreter provides; in-process callers get the same ABI
from either.  There is no other variant and no Python fallback: a failed
build raises with the compiler's output.  :func:`available` and
:func:`train_api_available` report the build.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_DIR, "gbt_native.cpp"),
           os.path.join(_DIR, "gbt_capi_train.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _libpython_flags() -> List[str]:
    """``-L<dir> -lpython3.X -Wl,-rpath,<dir>`` where the host has a
    shared ``libpython``, else nothing (the unlinked shim)."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    name = f"python{sys.version_info.major}.{sys.version_info.minor}"
    if libdir and os.path.exists(os.path.join(libdir, f"lib{name}.so")):
        return [f"-L{libdir}", f"-l{name}", f"-Wl,-rpath,{libdir}"]
    return []


def build_command(out: str) -> List[str]:
    return (["g++", "-O3", "-shared", "-fPIC", "-std=c++14", "-fopenmp",
             "-o", out, *SOURCES, "-I" + sysconfig.get_paths()["include"]]
            + _libpython_flags())


def library_path() -> str:
    h = hashlib.sha256(" ".join(build_command("")).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"gbt_native_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless its hashed file exists; returns its
    path.  Processes that ask together wait on one lock file, so one of
    them compiles.  Raises with the compiler's output when ``g++``
    fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".gbt_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(build_command(tmp), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building the native library "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_ll, c_i, c_p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    c_d_p = ctypes.POINTER(ctypes.c_double)
    c_f_p = ctypes.POINTER(ctypes.c_float)
    c_i_p = ctypes.POINTER(ctypes.c_int)
    c_ll_p = ctypes.POINTER(ctypes.c_longlong)

    lib.GBTN_ParseFile.restype = c_p
    lib.GBTN_ParseFile.argtypes = [ctypes.c_char_p, c_i, c_i]
    lib.GBTN_ParsedRows.restype = c_ll
    lib.GBTN_ParsedRows.argtypes = [c_p]
    lib.GBTN_ParsedCols.restype = c_ll
    lib.GBTN_ParsedCols.argtypes = [c_p]
    lib.GBTN_ParsedError.restype = ctypes.c_char_p
    lib.GBTN_ParsedError.argtypes = [c_p]
    lib.GBTN_ParsedCopy.restype = None
    lib.GBTN_ParsedCopy.argtypes = [c_p, c_d_p, c_f_p]
    lib.GBTN_ParsedFree.restype = None
    lib.GBTN_ParsedFree.argtypes = [c_p]

    lib.GBTN_BinColumn.restype = None
    lib.GBTN_BinColumn.argtypes = [c_d_p, c_ll, c_d_p, c_i, c_i, c_i, c_p]
    lib.GBTN_GreedyFindBin.restype = c_i
    lib.GBTN_GreedyFindBin.argtypes = [c_d_p, c_ll_p, c_i, c_i, c_ll, c_i,
                                       c_d_p]
    lib.GBTN_BinColumnCategorical.restype = None
    lib.GBTN_BinColumnCategorical.argtypes = [c_d_p, c_ll, c_ll_p, c_i_p,
                                              c_i, c_i, c_i, c_p]

    lib.GBTN_LoadModelString.restype = c_p
    lib.GBTN_LoadModelString.argtypes = [ctypes.c_char_p]
    lib.GBTN_LoadModelFile.restype = c_p
    lib.GBTN_LoadModelFile.argtypes = [ctypes.c_char_p]
    lib.GBTN_ModelError.restype = ctypes.c_char_p
    lib.GBTN_ModelError.argtypes = [c_p]
    lib.GBTN_ModelNumClass.restype = c_i
    lib.GBTN_ModelNumClass.argtypes = [c_p]
    lib.GBTN_ModelNumTrees.restype = c_i
    lib.GBTN_ModelNumTrees.argtypes = [c_p]
    lib.GBTN_ModelNumFeatures.restype = c_i
    lib.GBTN_ModelNumFeatures.argtypes = [c_p]
    lib.GBTN_Predict.restype = None
    lib.GBTN_Predict.argtypes = [c_p, c_d_p, c_ll, c_i, c_i, c_i, c_d_p]
    lib.GBTN_PredictLeaf.restype = None
    lib.GBTN_PredictLeaf.argtypes = [c_p, c_d_p, c_ll, c_i, c_i, c_i_p]
    lib.GBTN_FreeModel.restype = None
    lib.GBTN_FreeModel.argtypes = [c_p]
    lib.GBTN_OpenMPThreads.restype = c_i
    lib.GBTN_OpenMPThreads.argtypes = []

    # the training ABI (gbt_capi_train.cpp), always built in
    lib.GBTN_GetLastError.restype = ctypes.c_char_p
    lib.GBTN_GetLastError.argtypes = []
    lib.GBTN_DatasetCreateFromMat.restype = c_i
    lib.GBTN_DatasetCreateFromMat.argtypes = [
        c_d_p, c_ll, c_i, ctypes.c_char_p, c_f_p, c_p,
        ctypes.POINTER(c_p)]
    lib.GBTN_DatasetFree.restype = c_i
    lib.GBTN_DatasetFree.argtypes = [c_p]
    lib.GBTN_BoosterCreate.restype = c_i
    lib.GBTN_BoosterCreate.argtypes = [c_p, ctypes.c_char_p,
                                       ctypes.POINTER(c_p)]
    lib.GBTN_BoosterUpdateOneIter.restype = c_i
    lib.GBTN_BoosterUpdateOneIter.argtypes = [c_p, c_i_p]
    lib.GBTN_BoosterSaveModel.restype = c_i
    lib.GBTN_BoosterSaveModel.argtypes = [c_p, c_i, ctypes.c_char_p]
    lib.GBTN_BoosterPredictForMat.restype = c_i
    lib.GBTN_BoosterPredictForMat.argtypes = [c_p, c_d_p, c_ll, c_i,
                                              c_d_p]
    lib.GBTN_BoosterGetNumClass.restype = c_i
    lib.GBTN_BoosterGetNumClass.argtypes = [c_p, c_i_p]
    lib.GBTN_BoosterFree.restype = c_i
    lib.GBTN_BoosterFree.argtypes = [c_p]

    c_c_p = ctypes.c_char_p
    c_cpp = ctypes.POINTER(c_c_p)       # char** (string arrays)
    c_pp = ctypes.POINTER(c_p)
    c_vpp = ctypes.POINTER(c_p)         # const void** out
    lib.GBTN_DatasetCreateFromFile.restype = c_i
    lib.GBTN_DatasetCreateFromFile.argtypes = [c_c_p, c_c_p, c_p, c_pp]
    lib.GBTN_DatasetCreateFromCSR.restype = c_i
    lib.GBTN_DatasetCreateFromCSR.argtypes = [
        c_i_p, c_ll, c_i_p, c_d_p, c_ll, c_ll, c_c_p, c_p, c_pp]
    lib.GBTN_DatasetCreateFromCSC.restype = c_i
    lib.GBTN_DatasetCreateFromCSC.argtypes = [
        c_i_p, c_ll, c_i_p, c_d_p, c_ll, c_ll, c_c_p, c_p, c_pp]
    lib.GBTN_DatasetCreateEmpty.restype = c_i
    lib.GBTN_DatasetCreateEmpty.argtypes = [c_ll, c_i, c_c_p, c_p, c_pp]
    lib.GBTN_DatasetPushRows.restype = c_i
    lib.GBTN_DatasetPushRows.argtypes = [c_p, c_d_p, c_ll, c_i, c_ll]
    lib.GBTN_DatasetPushRowsByCSR.restype = c_i
    lib.GBTN_DatasetPushRowsByCSR.argtypes = [
        c_p, c_i_p, c_ll, c_i_p, c_d_p, c_ll, c_ll, c_ll]
    lib.GBTN_DatasetSetField.restype = c_i
    lib.GBTN_DatasetSetField.argtypes = [c_p, c_c_p, c_p, c_ll, c_i]
    lib.GBTN_DatasetGetField.restype = c_i
    lib.GBTN_DatasetGetField.argtypes = [c_p, c_c_p, c_ll_p, c_vpp,
                                         c_i_p]
    lib.GBTN_DatasetGetNumData.restype = c_i
    lib.GBTN_DatasetGetNumData.argtypes = [c_p, c_ll_p]
    lib.GBTN_DatasetGetNumFeature.restype = c_i
    lib.GBTN_DatasetGetNumFeature.argtypes = [c_p, c_i_p]
    lib.GBTN_DatasetSetFeatureNames.restype = c_i
    lib.GBTN_DatasetSetFeatureNames.argtypes = [c_p, c_cpp, c_i]
    lib.GBTN_DatasetGetFeatureNames.restype = c_i
    lib.GBTN_DatasetGetFeatureNames.argtypes = [c_p, c_cpp, c_i, c_i_p]
    lib.GBTN_DatasetSaveBinary.restype = c_i
    lib.GBTN_DatasetSaveBinary.argtypes = [c_p, c_c_p]
    lib.GBTN_DatasetLoadBinary.restype = c_i
    lib.GBTN_DatasetLoadBinary.argtypes = [c_c_p, c_pp]
    lib.GBTN_DatasetGetSubset.restype = c_i
    lib.GBTN_DatasetGetSubset.argtypes = [c_p, c_i_p, c_ll, c_c_p, c_pp]

    lib.GBTN_BoosterCreateFromModelfile.restype = c_i
    lib.GBTN_BoosterCreateFromModelfile.argtypes = [c_c_p, c_i_p, c_pp]
    lib.GBTN_BoosterLoadModelFromString.restype = c_i
    lib.GBTN_BoosterLoadModelFromString.argtypes = [c_c_p, c_i_p, c_pp]
    lib.GBTN_BoosterMerge.restype = c_i
    lib.GBTN_BoosterMerge.argtypes = [c_p, c_p]
    lib.GBTN_BoosterAddValidData.restype = c_i
    lib.GBTN_BoosterAddValidData.argtypes = [c_p, c_p, c_c_p]
    lib.GBTN_BoosterResetTrainingData.restype = c_i
    lib.GBTN_BoosterResetTrainingData.argtypes = [c_p, c_p]
    lib.GBTN_BoosterResetParameter.restype = c_i
    lib.GBTN_BoosterResetParameter.argtypes = [c_p, c_c_p]
    lib.GBTN_BoosterUpdateOneIterCustom.restype = c_i
    lib.GBTN_BoosterUpdateOneIterCustom.argtypes = [c_p, c_f_p, c_f_p,
                                                    c_ll, c_i_p]
    lib.GBTN_BoosterRollbackOneIter.restype = c_i
    lib.GBTN_BoosterRollbackOneIter.argtypes = [c_p]
    lib.GBTN_BoosterGetCurrentIteration.restype = c_i
    lib.GBTN_BoosterGetCurrentIteration.argtypes = [c_p, c_i_p]
    lib.GBTN_BoosterGetNumFeature.restype = c_i
    lib.GBTN_BoosterGetNumFeature.argtypes = [c_p, c_i_p]
    lib.GBTN_BoosterGetFeatureNames.restype = c_i
    lib.GBTN_BoosterGetFeatureNames.argtypes = [c_p, c_cpp, c_i, c_i_p]
    lib.GBTN_BoosterGetEvalCounts.restype = c_i
    lib.GBTN_BoosterGetEvalCounts.argtypes = [c_p, c_i_p]
    lib.GBTN_BoosterGetEvalNames.restype = c_i
    lib.GBTN_BoosterGetEvalNames.argtypes = [c_p, c_cpp, c_i, c_i_p]
    lib.GBTN_BoosterGetEval.restype = c_i
    lib.GBTN_BoosterGetEval.argtypes = [c_p, c_i, c_i_p, c_d_p]
    lib.GBTN_BoosterGetNumPredict.restype = c_i
    lib.GBTN_BoosterGetNumPredict.argtypes = [c_p, c_i, c_ll_p]
    lib.GBTN_BoosterGetPredict.restype = c_i
    lib.GBTN_BoosterGetPredict.argtypes = [c_p, c_i, c_ll_p, c_d_p]
    lib.GBTN_BoosterGetLeafValue.restype = c_i
    lib.GBTN_BoosterGetLeafValue.argtypes = [c_p, c_i, c_i,
                                             ctypes.POINTER(
                                                 ctypes.c_double)]
    lib.GBTN_BoosterSetLeafValue.restype = c_i
    lib.GBTN_BoosterSetLeafValue.argtypes = [c_p, c_i, c_i,
                                             ctypes.c_double]
    lib.GBTN_BoosterSaveModelToString.restype = c_i
    lib.GBTN_BoosterSaveModelToString.argtypes = [c_p, c_i, c_ll,
                                                  c_ll_p, c_c_p]
    lib.GBTN_BoosterDumpModel.restype = c_i
    lib.GBTN_BoosterDumpModel.argtypes = [c_p, c_i, c_ll, c_ll_p, c_c_p]
    lib.GBTN_BoosterCalcNumPredict.restype = c_i
    lib.GBTN_BoosterCalcNumPredict.argtypes = [c_p, c_ll, c_i, c_i,
                                               c_ll_p]
    lib.GBTN_BoosterPredict.restype = c_i
    lib.GBTN_BoosterPredict.argtypes = [c_p, c_d_p, c_ll, c_i, c_i, c_i,
                                        c_ll, c_ll_p, c_d_p]
    lib.GBTN_BoosterPredictForCSR.restype = c_i
    lib.GBTN_BoosterPredictForCSR.argtypes = [
        c_p, c_i_p, c_ll, c_i_p, c_d_p, c_ll, c_ll, c_i, c_i, c_ll,
        c_ll_p, c_d_p]
    lib.GBTN_BoosterPredictForCSC.restype = c_i
    lib.GBTN_BoosterPredictForCSC.argtypes = [
        c_p, c_i_p, c_ll, c_i_p, c_d_p, c_ll, c_ll, c_i, c_i, c_ll,
        c_ll_p, c_d_p]
    lib.GBTN_BoosterPredictForFile.restype = c_i
    lib.GBTN_BoosterPredictForFile.argtypes = [c_p, c_c_p, c_i, c_c_p,
                                               c_i, c_i]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if missing."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(build()))
    return _lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def train_api_available() -> bool:
    """Whether the training C ABI is loaded: it is built into every
    library this module builds."""
    return available() and hasattr(get_lib(), "GBTN_BoosterCreate")


# ---------------------------------------------------------------- wrappers

def parse_file(path: str, has_header: bool,
               label_idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """A text file parsed with format sniffing (CSV, TSV, LibSVM):
    features ``[N, F]`` float64 and labels ``[N]`` float32."""
    lib = get_lib()
    h = lib.GBTN_ParseFile(path.encode(), int(has_header), int(label_idx))
    try:
        err = lib.GBTN_ParsedError(h)
        if err:
            raise ValueError(f"native parser: {err.decode()}")
        n, f = lib.GBTN_ParsedRows(h), lib.GBTN_ParsedCols(h)
        feats = np.empty((n, f), dtype=np.float64)
        labels = np.empty((n,), dtype=np.float32)
        lib.GBTN_ParsedCopy(
            h, feats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return feats, labels
    finally:
        lib.GBTN_ParsedFree(h)


def greedy_find_bin(distinct: np.ndarray, counts: np.ndarray, max_bin: int,
                    total_cnt: int, min_data_in_bin: int) -> List[float]:
    """The greedy bin-boundary search (bin.cpp GreedyFindBin) over sorted
    distinct values and their counts: the upper bounds."""
    lib = get_lib()
    distinct = np.ascontiguousarray(distinct, dtype=np.float64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty(max(int(max_bin), 1), dtype=np.float64)
    n = lib.GBTN_GreedyFindBin(
        distinct.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        len(distinct), int(max_bin), int(total_cnt), int(min_data_in_bin),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out[:n].tolist()


def bin_column(values: np.ndarray, bounds: np.ndarray, n_search: int,
               nan_bin: int, out: np.ndarray) -> None:
    """Numerical values to bins (bin.h:451-483 ValueToBin) into the
    preallocated uint8/uint16 ``out``: a binary search of the first
    ``n_search`` upper bounds, NaN to ``nan_bin`` (negative: searched as
    the value 0)."""
    lib = get_lib()
    values = np.ascontiguousarray(values, dtype=np.float64)
    bounds = np.ascontiguousarray(bounds, dtype=np.float64)
    bits = 8 if out.dtype == np.uint8 else 16
    lib.GBTN_BinColumn(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(values),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(n_search), int(nan_bin), bits, out.ctypes.data_as(ctypes.c_void_p))


def bin_column_categorical(values: np.ndarray, cat_to_bin: dict,
                           overflow_bin: int, out: np.ndarray) -> None:
    """Categorical values to bins into the preallocated ``out``: a
    category of ``cat_to_bin`` to its bin, anything else (NaN, negative,
    unseen) to ``overflow_bin``."""
    lib = get_lib()
    values = np.ascontiguousarray(values, dtype=np.float64)
    cats = np.asarray(sorted(cat_to_bin), dtype=np.int64)
    bins = np.asarray([cat_to_bin[c] for c in cats], dtype=np.int32)
    bits = 8 if out.dtype == np.uint8 else 16
    lib.GBTN_BinColumnCategorical(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(values),
        cats.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        bins.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(cats), int(overflow_bin), bits,
        out.ctypes.data_as(ctypes.c_void_p))


class NativePredictor:
    """The host predictor of a model text (predictor.hpp): each row's trees
    walked on the host in float64, the raw scores summed tree by tree,
    oldest first (the kernels' order, so the raw margins are theirs bit
    for bit)."""

    def __init__(self, model_str: Optional[str] = None,
                 model_file: Optional[str] = None):
        lib = get_lib()
        self._lib = lib
        if model_file is not None:
            self._h = lib.GBTN_LoadModelFile(model_file.encode())
        else:
            self._h = lib.GBTN_LoadModelString(model_str.encode())
        err = lib.GBTN_ModelError(self._h)
        if err:
            msg = err.decode()
            lib.GBTN_FreeModel(self._h)
            self._h = None
            raise ValueError(f"native model load: {msg}")
        self.num_class = lib.GBTN_ModelNumClass(self._h)
        self.num_trees = lib.GBTN_ModelNumTrees(self._h)
        self.num_features = lib.GBTN_ModelNumFeatures(self._h)

    def _prepare(self, X: np.ndarray) -> np.ndarray:
        """Contiguous f64 matrix padded/validated to the model's feature
        count (sparse prediction files may have fewer trailing columns)."""
        X = np.ascontiguousarray(np.atleast_2d(X), dtype=np.float64)
        f = X.shape[1]
        if f < self.num_features:
            X = np.pad(X, ((0, 0), (0, self.num_features - f)))
        elif f > self.num_features:
            X = np.ascontiguousarray(X[:, :self.num_features])
        return X

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        X = self._prepare(X)
        n, f = X.shape
        k = max(self.num_class, 1)
        out = np.empty((n, k), dtype=np.float64)
        self._lib.GBTN_Predict(
            self._h, X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, f, int(num_iteration), int(raw_score),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out[:, 0] if k == 1 else out

    def predict_leaf(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        X = self._prepare(X)
        n, f = X.shape
        k = max(self.num_class, 1)
        iters = self.num_trees // k if k else 0
        if num_iteration > 0:
            iters = min(num_iteration, iters)
        total = iters * k
        out = np.empty((n, total), dtype=np.int32)
        self._lib.GBTN_PredictLeaf(
            self._h, X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, f, int(num_iteration),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.GBTN_FreeModel(self._h)
