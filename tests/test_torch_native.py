"""The port's native host library (``lightgbm_tpu_torch/native/``) against
the port's own numpy data layer and the JAX package's library, and its
training C ABI against the port's engine and ``lightgbm_tpu.train``.

* The parser, ``bin_column``, ``greedy_find_bin`` and the categorical
  binner: bit-equal to ``data/parser.py`` and ``data/binning.py`` and to
  the JAX library on the same inputs.
* ``NativePredictor``: the port's ``Booster.predict`` for a binary and a
  multiclass model (raw margins bit for bit), and its leaf indices.
* The C ABI through ``ctypes`` with ``device=cpu``: under integer-valued
  gradients (``GBTN_BoosterUpdateOneIterCustom``), where every sum is
  exact, the model text of the port's ``train`` and of
  ``lightgbm_tpu.train``; datasets from CSR, CSC and pushed rows train the
  dense matrix's model; fields, the booster's surface and error
  reporting; and a standalone C program that trains through the ABI.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import native as j_native
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.data import binning as t_binning
from lightgbm_tpu_torch.data.parser import load_text_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "device=cpu verbose=-1"


def _bits(a):
    return np.asarray(a, np.float64).view(np.int64)


# ---- the data layer ----------------------------------------------------------


def _text(kind, tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / f"data.{kind}"
    mat = rng.standard_normal((300, 5)) * 10.0 ** rng.integers(-3, 4, 5)
    mat[:, 0] = rng.integers(0, 2, 300)
    with open(path, "w") as f:
        if kind == "csv":
            f.write("label,a,b,c,d\n")
        for i, row in enumerate(mat):
            if kind == "svm":
                f.write(f"{row[0]:g} " + " ".join(
                    f"{j}:{v:.17g}" for j, v in enumerate(row[1:])
                    if (i + j) % 3) + "\n")
                continue
            cells = [f"{v:.17g}" for v in row]
            if i % 7 == 0:
                cells[2] = "" if kind == "csv" else "nan"
            if i % 11 == 0:
                cells[3] = "NA"
            f.write(("," if kind == "csv" else "\t").join(cells) + "\n")
    return str(path), kind == "csv"


@pytest.mark.parametrize("kind", ["tsv", "csv", "svm"])
def test_parser_bit_equal(kind, tmp_path):
    path, header = _text(kind, tmp_path)
    feats, labels = native.parse_file(path, header, 0)
    want, want_label, _ = load_text_file(path, has_header=header,
                                         label_idx=0)
    assert feats.shape == want.shape
    assert (_bits(feats) == _bits(want)).all()
    np.testing.assert_array_equal(labels,
                                  np.asarray(want_label, np.float32))
    jf, jl = j_native.parse_file(path, header, 0)
    assert (_bits(feats) == _bits(jf)).all()
    np.testing.assert_array_equal(labels, jl)


def _column(rng, n=30000):
    v = rng.standard_normal(n) * 3.0
    v[::13] = np.nan
    v[::7] = 0.0
    v[::5] = np.round(v[::5], 1)
    return v


@pytest.mark.parametrize("max_bin,dtype", [(63, np.uint8), (255, np.uint8),
                                           (1023, np.uint16)])
def test_bin_column_bit_equal(max_bin, dtype):
    v = _column(np.random.default_rng(1))
    m = t_binning.BinMapper.fit(v[~np.isnan(v)], len(v), max_bin, 3, 2)
    nan = m.missing_type == t_binning.MISSING_NAN
    n_search = m.num_bin - (1 if nan else 0)
    nan_bin = m.num_bin - 1 if nan else -1
    out = np.empty(len(v), dtype)
    native.bin_column(v, m.bin_upper_bound, n_search, nan_bin, out)
    np.testing.assert_array_equal(out, m.value_to_bin(v))
    other = np.empty(len(v), dtype)
    assert j_native.bin_column(v, m.bin_upper_bound, n_search, nan_bin,
                               other)
    np.testing.assert_array_equal(out, other)


def test_greedy_find_bin_bit_equal():
    rng = np.random.default_rng(3)
    d = np.sort(rng.standard_normal(5000))
    c = rng.integers(1, 4, 5000).astype(np.int64)
    c[::97] = 4000               # heavy values get a bin of their own
    v = np.sort(rng.standard_normal(40000))
    cases = [(v, np.ones(len(v), np.int64), 255, len(v), 3),
             (d, c, 255, int(c.sum()), 3),
             (np.arange(10.0), np.full(10, 5, np.int64), 63, 50, 3),
             (d[:2000], c[:2000], 15, int(c[:2000].sum()), 200)]
    for distinct, counts, max_bin, total, mdib in cases:
        got = native.greedy_find_bin(distinct, counts, max_bin, total, mdib)
        want = t_binning.greedy_find_bin(distinct, counts, max_bin, total,
                                         mdib)
        assert (_bits(got) == _bits(want)).all()
        assert (_bits(got) == _bits(j_native.greedy_find_bin(
            distinct, counts, max_bin, total, mdib))).all()


@pytest.mark.parametrize("categories,dtype", [(30, np.uint8),
                                              (600, np.uint16)])
def test_bin_column_categorical_bit_equal(categories, dtype):
    rng = np.random.default_rng(2)
    v = rng.integers(0, categories, 20000).astype(np.float64)
    v[::11] = np.nan
    m = t_binning.BinMapper.fit(v[~np.isnan(v)], len(v),
                                max(categories + 2, 32), 1, 1,
                                bin_type=t_binning.BIN_TYPE_CATEGORICAL)
    v[::17] = -1.0                   # negative, fractional and unseen
    v[::19] += 0.5
    v[::23] = categories + 5
    out = np.empty(len(v), dtype)
    native.bin_column_categorical(v, m.categorical_2_bin, m.num_bin - 1,
                                  out)
    np.testing.assert_array_equal(out, m.value_to_bin(v))
    other = np.empty(len(v), dtype)
    assert j_native.bin_column_categorical(v, m.categorical_2_bin,
                                           m.num_bin - 1, other)
    np.testing.assert_array_equal(out, other)


# ---- the predictor -------------------------------------------------------------


def _rows(n, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f))
    x[rng.random((n, f)) < 0.05] = np.nan
    x[rng.random((n, f)) < 0.05] = 0.0
    return x


@pytest.fixture(scope="module")
def models():
    x = _rows(2000, 6, 0)
    z = np.nan_to_num(x)
    p = {"device": "cpu", "verbose": -1, "num_leaves": 15,
         "min_data_in_leaf": 10}
    yb = (z[:, 0] + z[:, 1] > 0).astype(np.float64)
    pb = dict(p, objective="binary")
    binary = lt.train(pb, lt.Dataset(x, yb, params=pb), 12)
    ym = np.digitize(z[:, 0] * 2 + z[:, 2], [-1, 1]).astype(np.float64)
    pm = dict(p, objective="multiclass", num_class=3)
    multi = lt.train(pm, lt.Dataset(x, ym, params=pm), 6)
    return binary, multi, _rows(700, 6, 1)


@pytest.mark.parametrize("which", ["binary", "multiclass"])
def test_native_predictor_matches_booster(models, which):
    bst = models[0] if which == "binary" else models[1]
    x = models[2]
    pred = native.NativePredictor(model_str=bst.model_to_string())
    assert (_bits(pred.predict(x, raw_score=True))
            == _bits(bst.predict(x, raw_score=True))).all()
    np.testing.assert_allclose(pred.predict(x), bst.predict(x),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(pred.predict_leaf(x),
                                  bst.predict(x, pred_leaf=True))
    # the first iterations only
    assert (_bits(pred.predict(x, num_iteration=3, raw_score=True))
            == _bits(bst.predict(x, num_iteration=3, raw_score=True))).all()


def test_native_model_error():
    with pytest.raises(ValueError, match="native model load"):
        native.NativePredictor(model_str="tree\nnum_class=1\nTree=0\n"
                                         "num_leaves=3\nleaf_value=1\n")


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (str(bad),))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "broken.cpp" in str(e.value)


# ---- the training C ABI --------------------------------------------------------

c_dp = ctypes.POINTER(ctypes.c_double)
c_fp = ctypes.POINTER(ctypes.c_float)
c_ip = ctypes.POINTER(ctypes.c_int)


def _dp(a):
    return a.ctypes.data_as(c_dp)


def _fp(a):
    return a.ctypes.data_as(c_fp)


def _ip(a):
    return a.ctypes.data_as(c_ip)


def _ok(rc):
    assert rc == 0, native.get_lib().GBTN_GetLastError().decode()


def _problem(n=900, f=6, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f))
    y = (x @ rng.standard_normal(f) + 0.5 * rng.standard_normal(n)
         > 0).astype(np.float32)
    return np.ascontiguousarray(x), y


def _dataset(x, y, params, reference=None):
    ds = ctypes.c_void_p()
    _ok(native.get_lib().GBTN_DatasetCreateFromMat(
        _dp(x), x.shape[0], x.shape[1], params.encode(),
        None if y is None else _fp(y), reference, ctypes.byref(ds)))
    return ds


def _booster(ds, params):
    bst = ctypes.c_void_p()
    _ok(native.get_lib().GBTN_BoosterCreate(ds, params.encode(),
                                            ctypes.byref(bst)))
    return bst


def _model_text(bst):
    lib = native.get_lib()
    need = ctypes.c_longlong(0)
    _ok(lib.GBTN_BoosterSaveModelToString(bst, -1, 0, ctypes.byref(need),
                                          None))
    buf = ctypes.create_string_buffer(need.value)
    _ok(lib.GBTN_BoosterSaveModelToString(bst, -1, need.value,
                                          ctypes.byref(need), buf))
    return buf.value.decode()


def _int_grads(n, rounds, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.integers(-3, 4, n).astype(np.float32),
             rng.integers(1, 4, n).astype(np.float32))
            for _ in range(rounds)]


INT = ("objective=regression boost_from_average=false num_leaves=15 "
       "min_data_in_leaf=5 min_sum_hessian_in_leaf=1")


def test_capi_integer_gradients_equal_engines():
    """Under integer gradients every sum is exact: the C ABI's model is
    the port's ``train`` and ``lightgbm_tpu.train``'s, byte for byte."""
    lib = native.get_lib()
    x, y = _problem()
    grads = _int_grads(len(x), 4)
    bst = _booster(_dataset(x, y, f"{INT} {CPU}"), f"{INT} {CPU}")
    fin = ctypes.c_int(0)
    for g, h in grads:
        _ok(lib.GBTN_BoosterUpdateOneIterCustom(bst, _fp(g), _fp(h), len(g),
                                                ctypes.byref(fin)))
    text = _model_text(bst)
    lib.GBTN_BoosterFree(bst)
    it = iter(grads)

    def fobj(preds, data):
        g, h = next(it)
        return g.astype(np.float64), h.astype(np.float64)

    params = dict(kv.split("=") for kv in INT.split())
    t = lt.train(dict(params, device="cpu", verbose=-1),
                 lt.Dataset(x, y, params=dict(params, device="cpu")),
                 len(grads), fobj=fobj)
    assert text == t.model_to_string()
    it = iter(grads)
    j = lj.train(dict(params, verbose=-1), lj.Dataset(x, y, params=params),
                 len(grads), fobj=fobj, verbose_eval=False)
    assert text == j.model_to_string()


def _to_csr(x):
    mask = x != 0.0
    indptr = np.zeros(len(x) + 1, dtype=np.int32)
    indptr[1:] = np.cumsum(mask.sum(axis=1))
    indices = np.ascontiguousarray(np.nonzero(mask)[1].astype(np.int32))
    return indptr, indices, np.ascontiguousarray(x[mask])


PARAMS = f"objective=binary num_leaves=15 min_data_in_leaf=20 {CPU}"


def _trained_text(ds, rounds=4):
    lib = native.get_lib()
    bst = _booster(ds, PARAMS)
    fin = ctypes.c_int(0)
    for _ in range(rounds):
        _ok(lib.GBTN_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    text = _model_text(bst)
    lib.GBTN_BoosterFree(bst)
    return text


def test_capi_csr_csc_and_pushed_rows_train_the_dense_model():
    lib = native.get_lib()
    x, y = _problem(700, 6)
    x[np.abs(x) < 0.4] = 0.0
    n, f = x.shape
    want = _trained_text(_dataset(x, y, PARAMS))
    lab = y.ctypes.data_as(ctypes.c_void_p)

    indptr, indices, data = _to_csr(x)
    ds = ctypes.c_void_p()
    _ok(lib.GBTN_DatasetCreateFromCSR(
        _ip(indptr), len(indptr), _ip(indices), _dp(data), len(data), f,
        PARAMS.encode(), None, ctypes.byref(ds)))
    _ok(lib.GBTN_DatasetSetField(ds, b"label", lab, n, 0))
    assert _trained_text(ds) == want

    mask = x != 0.0
    colptr = np.zeros(f + 1, dtype=np.int32)
    colptr[1:] = np.cumsum(mask.sum(axis=0))
    rows = np.ascontiguousarray(np.nonzero(mask.T)[1].astype(np.int32))
    vals = np.ascontiguousarray(x.T[mask.T])
    ds = ctypes.c_void_p()
    _ok(lib.GBTN_DatasetCreateFromCSC(
        _ip(colptr), len(colptr), _ip(rows), _dp(vals), len(vals), n,
        PARAMS.encode(), None, ctypes.byref(ds)))
    _ok(lib.GBTN_DatasetSetField(ds, b"label", lab, n, 0))
    assert _trained_text(ds) == want

    ds = ctypes.c_void_p()
    _ok(lib.GBTN_DatasetCreateEmpty(n, f, PARAMS.encode(), None,
                                    ctypes.byref(ds)))
    cut = n // 3
    a = np.ascontiguousarray(x[:cut])
    _ok(lib.GBTN_DatasetPushRows(ds, _dp(a), cut, f, 0))
    bp, bi, bd = _to_csr(np.ascontiguousarray(x[cut:]))
    _ok(lib.GBTN_DatasetPushRowsByCSR(ds, _ip(bp), len(bp), _ip(bi),
                                      _dp(bd), len(bd), f, cut))
    _ok(lib.GBTN_DatasetSetField(ds, b"label", lab, n, 0))
    assert _trained_text(ds) == want


def test_capi_fields_round_trip():
    lib = native.get_lib()
    x, y = _problem(400, 5)
    n = len(x)
    ds = _dataset(x, y, PARAMS)
    w = (np.arange(n) % 3 + 1).astype(np.float32)
    _ok(lib.GBTN_DatasetSetField(ds, b"weight",
                                 w.ctypes.data_as(ctypes.c_void_p), n, 0))
    group = np.array([100, 150, 150], dtype=np.int32)
    _ok(lib.GBTN_DatasetSetField(ds, b"group",
                                 group.ctypes.data_as(ctypes.c_void_p), 3, 2))
    for name, want, ctype, code in (
            (b"label", y, ctypes.c_float, 0),
            (b"weight", w, ctypes.c_float, 0),
            (b"group", np.array([0, 100, 250, 400]), ctypes.c_int, 2)):
        out_len, ptr, typ = ctypes.c_longlong(), ctypes.c_void_p(), \
            ctypes.c_int(-1)
        _ok(lib.GBTN_DatasetGetField(ds, name, ctypes.byref(out_len),
                                     ctypes.byref(ptr), ctypes.byref(typ)))
        assert (out_len.value, typ.value) == (len(want), code)
        got = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)),
                                    (len(want),))
        np.testing.assert_array_equal(got, want)
    nd, nf = ctypes.c_longlong(), ctypes.c_int()
    _ok(lib.GBTN_DatasetGetNumData(ds, ctypes.byref(nd)))
    _ok(lib.GBTN_DatasetGetNumFeature(ds, ctypes.byref(nf)))
    assert (nd.value, nf.value) == x.shape
    names = [f"col_{i}".encode() for i in range(5)]
    _ok(lib.GBTN_DatasetSetFeatureNames(ds, (ctypes.c_char_p * 5)(*names),
                                        5))
    bufs = [ctypes.create_string_buffer(32) for _ in range(5)]
    arr = (ctypes.c_char_p * 5)(*[ctypes.cast(b, ctypes.c_char_p)
                                  for b in bufs])
    cnt = ctypes.c_int()
    _ok(lib.GBTN_DatasetGetFeatureNames(ds, arr, 32, ctypes.byref(cnt)))
    assert [b.value for b in bufs] == names
    lib.GBTN_DatasetFree(ds)


def test_capi_booster_surface(tmp_path):
    """Valid data and evaluation, GetPredict, predict types and the
    file predict, rollback, leaf values, reset of the training data, the
    JSON dump, each against the port's Booster on the same model."""
    lib = native.get_lib()
    x, y = _problem(800, 6, seed=9)
    xv, yv = _problem(300, 6, seed=10)
    ds = _dataset(x, y, PARAMS)
    dv = _dataset(xv, yv, PARAMS, reference=ds)
    bst = _booster(ds, PARAMS + " metric=binary_logloss,auc")
    _ok(lib.GBTN_BoosterAddValidData(bst, dv, b"valid_0"))
    fin = ctypes.c_int(0)
    for _ in range(5):
        _ok(lib.GBTN_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    _ok(lib.GBTN_BoosterRollbackOneIter(bst))
    it = ctypes.c_int()
    _ok(lib.GBTN_BoosterGetCurrentIteration(bst, ctypes.byref(it)))
    assert it.value == 4
    ref = lt.Booster(model_str=_model_text(bst), params={"device": "cpu"})

    cnt = ctypes.c_int()
    _ok(lib.GBTN_BoosterGetEvalCounts(bst, ctypes.byref(cnt)))
    vals, out_len = np.zeros(cnt.value), ctypes.c_int()
    _ok(lib.GBTN_BoosterGetEval(bst, 1, ctypes.byref(out_len), _dp(vals)))
    pv = ref.predict(xv)
    ll = -np.mean(yv * np.log(pv) + (1 - yv) * np.log(1 - pv))
    assert abs(vals[0] - ll) < 1e-6
    n_pred = ctypes.c_longlong()
    _ok(lib.GBTN_BoosterGetNumPredict(bst, 1, ctypes.byref(n_pred)))
    got = np.zeros(n_pred.value)
    _ok(lib.GBTN_BoosterGetPredict(bst, 1, ctypes.byref(n_pred), _dp(got)))
    np.testing.assert_allclose(got, pv, rtol=1e-6)

    for ptype, want in ((0, ref.predict(xv)),
                        (1, ref.predict(xv, raw_score=True)),
                        (2, ref.predict(xv, pred_leaf=True))):
        need = ctypes.c_longlong()
        _ok(lib.GBTN_BoosterCalcNumPredict(bst, len(xv), ptype, -1,
                                           ctypes.byref(need)))
        out = np.zeros(need.value)
        _ok(lib.GBTN_BoosterPredict(bst, _dp(np.ascontiguousarray(xv)),
                                    len(xv), 6, ptype, -1, need.value,
                                    ctypes.byref(need), _dp(out)))
        assert (_bits(out) == _bits(np.asarray(want, np.float64)
                                    .reshape(-1))).all()
    path = tmp_path / "v.tsv"
    np.savetxt(path, np.column_stack([yv, xv]), delimiter="\t",
               fmt="%.17g")
    _ok(lib.GBTN_BoosterPredictForFile(bst, str(path).encode(), 0,
                                       str(tmp_path / "p.txt").encode(), 1,
                                       -1))
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "p.txt"),
                                  ref.predict(xv, raw_score=True))

    leaf = ctypes.c_double()
    _ok(lib.GBTN_BoosterGetLeafValue(bst, 1, 2, ctypes.byref(leaf)))
    assert leaf.value == ref.get_leaf_output(1, 2)
    _ok(lib.GBTN_BoosterSetLeafValue(bst, 1, 2, 0.25))
    _ok(lib.GBTN_BoosterGetLeafValue(bst, 1, 2, ctypes.byref(leaf)))
    assert leaf.value == 0.25

    need = ctypes.c_longlong()
    _ok(lib.GBTN_BoosterDumpModel(bst, -1, 0, ctypes.byref(need), None))
    buf = ctypes.create_string_buffer(need.value)
    _ok(lib.GBTN_BoosterDumpModel(bst, -1, need.value, ctypes.byref(need),
                                  buf))
    assert b'"tree_info"' in buf.value

    # new training data: boosting goes on from the model's scores on it
    x2, y2 = _problem(600, 6, seed=12)
    _ok(lib.GBTN_BoosterResetTrainingData(bst, _dataset(x2, y2, PARAMS)))
    _ok(lib.GBTN_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    after = lt.Booster(model_str=_model_text(bst), params={"device": "cpu"})
    assert after.num_trees() == ref.num_trees() + 1
    lib.GBTN_BoosterFree(bst)


def test_capi_predict_for_mat_bitwise():
    lib = native.get_lib()
    x, y = _problem(1000, 6)
    bst = _booster(_dataset(x, y, PARAMS), PARAMS)
    fin = ctypes.c_int()
    for _ in range(6):
        _ok(lib.GBTN_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    out = np.zeros(len(x))
    _ok(lib.GBTN_BoosterPredictForMat(bst, _dp(x), len(x), 6, _dp(out)))
    ref = lt.Booster(model_str=_model_text(bst), params={"device": "cpu"})
    assert (_bits(out) == _bits(ref.predict(x))).all()
    assert out[y > 0].mean() > out[y == 0].mean() + 0.2
    lib.GBTN_BoosterFree(bst)


def test_capi_error_reporting():
    lib = native.get_lib()
    bst = ctypes.c_void_p()
    assert lib.GBTN_BoosterCreate(None, b"objective=binary",
                                  ctypes.byref(bst)) != 0
    assert lib.GBTN_GetLastError()
    x, y = _problem(100, 3)
    ds = _dataset(x, y, PARAMS)
    assert lib.GBTN_BoosterCreate(ds, b"objective=binary nonsense=1 "
                                  b"device=cpu", ctypes.byref(bst)) != 0
    assert b"Unknown parameter" in lib.GBTN_GetLastError()
    lib.GBTN_DatasetFree(ds)


STANDALONE_C = r"""
#include <stdio.h>

extern const char* GBTN_GetLastError(void);
extern int GBTN_DatasetCreateFromMat(const double*, long long, int,
                                     const char*, const float*, void*,
                                     void**);
extern int GBTN_DatasetFree(void*);
extern int GBTN_BoosterCreate(void*, const char*, void**);
extern int GBTN_BoosterUpdateOneIter(void*, int*);
extern int GBTN_BoosterPredict(void*, const double*, long long, int, int,
                               int, long long, long long*, double*);
extern int GBTN_BoosterSaveModel(void*, int, const char*);
extern int GBTN_BoosterFree(void*);

#define N 400
#define F 4
#define CHECK(call) if ((call) != 0) { \
    fprintf(stderr, "FAIL %s: %s\n", #call, GBTN_GetLastError()); return 1; }

int main(int argc, char** argv) {
  static double X[N * F];
  static float y[N];
  unsigned s = 12345;
  for (int i = 0; i < N; ++i) {
    double acc = 0.0;
    for (int j = 0; j < F; ++j) {
      s = s * 1103515245u + 12345u;
      X[i * F + j] = ((double)(s % 2000) - 1000.0) / 250.0;
      acc += (j % 2 ? 1.0 : -1.0) * X[i * F + j];
    }
    y[i] = acc > 0.0 ? 1.0f : 0.0f;
  }
  const char* params = "objective=binary num_leaves=7 min_data_in_leaf=10 "
                       "learning_rate=0.2 verbose=-1 device=cpu";
  void* ds = NULL;
  void* bst = NULL;
  int finished = 0;
  CHECK(GBTN_DatasetCreateFromMat(X, N, F, params, y, NULL, &ds));
  CHECK(GBTN_BoosterCreate(ds, params, &bst));
  for (int it = 0; it < 4; ++it)
    CHECK(GBTN_BoosterUpdateOneIter(bst, &finished));
  static double out[N];
  long long out_len = 0;
  CHECK(GBTN_BoosterPredict(bst, X, N, F, 0, -1, N, &out_len, out));
  CHECK(GBTN_BoosterSaveModel(bst, -1, argv[1]));
  double pos = 0.0, neg = 0.0;
  int npos = 0, nneg = 0;
  for (int i = 0; i < N; ++i) {
    if (y[i] > 0.5f) { pos += out[i]; ++npos; } else { neg += out[i]; ++nneg; }
  }
  if (pos / npos <= neg / nneg + 0.1) {
    fprintf(stderr, "FAIL model did not fit\n");
    return 1;
  }
  GBTN_BoosterFree(bst);
  GBTN_DatasetFree(ds);
  printf("STANDALONE_OK %lld\n", out_len);
  return 0;
}
"""


@pytest.mark.skipif(shutil.which("gcc") is None, reason="no C compiler")
def test_capi_standalone_c_program(tmp_path):
    """A C program with no interpreter of its own, linked against the
    library, trains, predicts and saves through the ABI (the library
    brings the interpreter up), and the port loads its model."""
    so = native.build()
    src = tmp_path / "standalone.c"
    src.write_text(STANDALONE_C)
    exe = tmp_path / "standalone"
    subprocess.run(["gcc", "-o", str(exe), str(src), so,
                    f"-Wl,-rpath,{os.path.dirname(so)}"], check=True,
                   capture_output=True, text=True)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    model = tmp_path / "model.txt"
    r = subprocess.run([str(exe), str(model)], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "STANDALONE_OK 400" in r.stdout
    bst = lt.Booster(model_file=str(model), params={"device": "cpu"})
    assert bst.num_trees() == 4
