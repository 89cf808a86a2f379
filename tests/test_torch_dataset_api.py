"""The port's Dataset inputs and methods against lightgbm_tpu: CSV, TSV
and LibSVM files (with and without a header, with NA cells), side files,
the ``<data>.bin`` cache and binary dataset files written by either
package, CSR and two-round construction, pandas categoricals and the
``pandas_categorical`` model-text line, the reference and naming methods
and ``free_raw_data``.

Tolerances: parsed values, bin matrices, mappers, bundles and metadata
are equal exactly; models trained under integer-valued gradients have
identical model text, so their predictions are compared exactly where the
port replays the JAX package's arithmetic (leaf indices) and within 1e-12
where each package sums in its own order (scores)."""
import dataclasses
import os

import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.data import parser as jparser
from lightgbm_tpu.data import sparse as jsparse
from lightgbm_tpu_torch.data import parser as tparser

N, F = 900, 5
P = dict(objective="binary", num_leaves=7, min_data_in_leaf=5, verbose=-1)
NA_TOKENS = ["", "na", "nan", "NA", "NaN", "null"]


def _cpu(p):
    return dict(p, device="cpu")


def _data(seed=0, n=N, sparse=False):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((n, F)), 4)
    x[:, 2] = rng.integers(0, 9, n)
    if sparse:
        x[rng.random((n, F)) < 0.7] = 0.0
    y = (x[:, 0] - 0.5 * x[:, 1] > 0).astype(np.float32)
    return x, y


def _write_text(path, x, y, fmt, header=False, na=False):
    """``x`` and ``y`` as a CSV, TSV or LibSVM file, the label first; with
    ``na`` some cells hold the NA tokens (CSV and TSV)."""
    rng = np.random.default_rng(5)
    sep = {"csv": ",", "tsv": "\t"}.get(fmt)
    lines = []
    if header and fmt != "libsvm":
        lines.append(sep.join(["target"] + [f"f{j}" for j in range(
            x.shape[1])]))
    for i in range(len(y)):
        if fmt == "libsvm":
            toks = [f"{y[i]:g}"] + [f"{j}:{v:g}" for j, v in enumerate(x[i])
                                    if v != 0]
            lines.append(" ".join(toks))
            continue
        cells = [f"{v:g}" for v in x[i]]
        if na and i % 7 == 3:
            cells[i % x.shape[1]] = NA_TOKENS[i % len(NA_TOKENS)]
        lines.append(sep.join([f"{y[i]:g}"] + cells))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def _same_training_data(a, b):
    """Two packages' constructed datasets hold the same bins, mappers,
    layout and metadata."""
    np.testing.assert_array_equal(a.binned, b.binned)
    assert a.binned.dtype == b.binned.dtype
    assert list(a.used_features) == list(b.used_features)
    assert list(a.feature_names) == list(b.feature_names)
    assert a.num_total_features == b.num_total_features
    assert len(a.bin_mappers) == len(b.bin_mappers)
    for ma, mb in zip(a.bin_mappers, b.bin_mappers):
        for f in dataclasses.fields(ma):
            va, vb = getattr(ma, f.name), getattr(mb, f.name)
            if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb, f.name
    la = None if a.layout is None else a.layout.bundles
    lb = None if b.layout is None else b.layout.bundles
    assert la == lb
    for field in ("label", "weight", "query_boundaries", "init_score"):
        va, vb = getattr(a.metadata, field), getattr(b.metadata, field)
        assert (va is None) == (vb is None), field
        if va is not None:
            np.testing.assert_array_equal(va, vb)


def _td(ds):
    """A Dataset of either package, constructed."""
    return ds.construct().constructed


# -- text files -------------------------------------------------------------

@pytest.mark.parametrize("fmt,na", [("csv", False), ("csv", True),
                                    ("tsv", False), ("tsv", True),
                                    ("libsvm", False)])
@pytest.mark.parametrize("header", [False, True])
def test_text_file_parsed_as_jax(tmp_path, fmt, header, na):
    x, y = _data()
    path = _write_text(tmp_path / f"d.{fmt}", x, y, fmt, header, na)
    ft, lt_, nt = tparser.load_text_file(path, has_header=header)
    fj, lj_, nj = jparser.load_text_file(path, has_header=header)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(lt_, lj_)
    assert nt == nj
    if na:
        assert np.isnan(ft).any()
    assert tparser.count_data_rows(path, header) == \
        jparser.count_data_rows(path, header)
    # two-round loading's chunks hold the rows the JAX package parses
    # (its own chunked reader splits a TSV's empty cells on any
    # whitespace, and fails on them)
    ncol = jparser.count_data_rows(path, header)[1]
    chunks = list(tparser.iter_parsed_chunks(path, header, 0, 250,
                                             ncol=ncol))
    assert [len(c[1]) for c in chunks][:-1] == [250, 250, 250]
    np.testing.assert_array_equal(np.concatenate([c[0] for c in chunks]), fj)
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks]),
                                  lj_)
    assert tparser.read_header_names(path) == jparser.read_header_names(path)


@pytest.mark.parametrize("fmt,header", [("csv", True), ("tsv", False),
                                        ("libsvm", False)])
def test_file_dataset_bins_as_jax(tmp_path, fmt, header):
    """A Dataset from a path: labels from the file, header names, and the
    JAX package's bins; a valid set from a file bins with its
    reference's mappers."""
    x, y = _data()
    path = _write_text(tmp_path / f"d.{fmt}", x, y, fmt, header)
    vx, vy = _data(seed=3, n=300)
    vpath = _write_text(tmp_path / f"v.{fmt}", vx, vy, fmt, header)
    p = dict(P, header=header)
    dt = lt.Dataset(path, params=_cpu(p))
    dj = lj.Dataset(path, params=p)
    _same_training_data(_td(dt), _td(dj))
    _same_training_data(_td(lt.Dataset(vpath, reference=dt, params=_cpu(p))),
                        _td(lj.Dataset(vpath, reference=dj, params=p)))
    # the same rows given in memory bin the same way
    mem = lt.Dataset(tparser.load_text_file(path, header)[0], y,
                     params=_cpu(p)).construct().constructed
    np.testing.assert_array_equal(mem.binned, dt.constructed.binned)


def test_side_files_as_jax(tmp_path):
    x, y = _data()
    path = _write_text(tmp_path / "d.csv", x, y, "csv")
    rng = np.random.default_rng(2)
    np.savetxt(path + ".weight", rng.integers(1, 4, N))
    np.savetxt(path + ".query", [300, 200, 400], fmt="%d")
    np.savetxt(path + ".init", rng.standard_normal(N))
    td = _td(lt.Dataset(path, params=_cpu(P)))
    _same_training_data(td, _td(lj.Dataset(path, params=P)))
    assert td.metadata.num_queries == 3
    # two-round loading reads the same side files
    td2 = _td(lt.Dataset(path, params=_cpu(dict(
        P, two_round=True))))
    _same_training_data(td2, td)
    # a given field wins over its side file
    w = np.ones(N)
    td3 = _td(lt.Dataset(path, weight=w, params=_cpu(P)))
    np.testing.assert_array_equal(td3.metadata.weight, w)


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_two_round_loading_bins_as_jax(tmp_path, fmt):
    """``use_two_round_loading`` samples the rows of the in-memory path
    (here 400 of 900), so its bins are the in-memory path's and the JAX
    package's streamed ones."""
    x, y = _data()
    path = _write_text(tmp_path / f"d.{fmt}", x, y, fmt)
    p = dict(P, bin_construct_sample_cnt=400, use_two_round_loading=True)
    dt = lt.Dataset(path, params=_cpu(p))
    td = _td(dt)
    _same_training_data(td, _td(lj.Dataset(path, params=p)))
    mem = _td(lt.Dataset(path, params=_cpu(dict(
        p, use_two_round_loading=False))))
    _same_training_data(td, mem)
    np.testing.assert_array_equal(dt.get_label(), y)
    assert dt.raw is None
    from lightgbm_tpu.data.dataset import construct_streamed as js
    from lightgbm_tpu_torch.data import construct_streamed as ts
    cfg_t = lt.config.config_from_params(_cpu(p))
    cfg_j = lj.config.config_from_params(p)
    _same_training_data(ts(path, cfg_t, chunk_rows=128),
                        js(path, cfg_j, chunk_rows=128))


# -- binary files -------------------------------------------------------------

def _exclusive_data(seed=0, n=N):
    """Columns 0, 3 and 4 mutually exclusive (EFB bundles them)."""
    x, y = _data(seed, n)
    for j, (r0, r1) in zip((0, 3, 4), ((0, n // 3), (n // 3, 2 * n // 3),
                                       (2 * n // 3, n))):
        keep = np.zeros(n, bool)
        keep[r0:r1] = True
        x[~keep, j] = 0.0
    return x, y


def _rich_dataset(pkg, p):
    """Bundled columns, a categorical column, weights, query sizes and
    init scores."""
    x, y = _exclusive_data()
    rng = np.random.default_rng(4)
    return pkg.Dataset(x, y, weight=rng.integers(1, 4, N).astype(float),
                       group=[300, 250, 350],
                       init_score=rng.standard_normal(N),
                       categorical_feature=[2], params=p)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("compress", [True, False])
def test_binary_files_load_in_both_packages(tmp_path, writer, compress):
    dt, dj = _rich_dataset(lt, _cpu(P)), _rich_dataset(lj, P)
    _same_training_data(_td(dt), _td(dj))
    assert dt.constructed.bundled
    path = str(tmp_path / "d.bin")
    (dt if writer == "port" else dj).save_binary(path, compress=compress)
    loaded_t = lt.Dataset.load_binary(path)
    loaded_j = lj.Dataset.load_binary(path)
    _same_training_data(loaded_t.constructed, loaded_j.constructed)
    _same_training_data(loaded_t.constructed, dt.constructed)
    assert loaded_t.constructed.feature_meta().keys() == \
        dt.constructed.feature_meta().keys()


def test_binary_file_trains_the_same_tree(tmp_path):
    """A Dataset loaded from a binary file grows the tree of the Dataset
    it was saved from (integer gradients)."""
    x, y = _data(sparse=True)
    d = lt.Dataset(x, y, params=_cpu(P))
    path = str(tmp_path / "d.bin")
    d.construct().save_binary(path)
    fobj = _int_fobj(3)
    a = lt.train(_cpu(P), d, 2, fobj=fobj)
    b = lt.train(_cpu(P), lt.Dataset.load_binary(path), 2, fobj=_int_fobj(3))
    c = lt.train(_cpu(P), lt.Dataset(path, params=_cpu(P)), 2,
                 fobj=_int_fobj(3))
    assert a.model_to_string() == b.model_to_string() == c.model_to_string()


def test_bin_cache_preferred_and_saved(tmp_path):
    """``is_save_binary_file`` writes ``<data>.bin`` beside the text file;
    later Datasets of that path load the cache, not the text, as the JAX
    package does (a stale cache wins too)."""
    x, y = _data()
    path = _write_text(tmp_path / "d.csv", x, y, "csv")
    p = dict(P, is_save_binary_file=True)
    td = _td(lt.Dataset(path, params=_cpu(p)))
    assert lt.Dataset._is_binary_cache(path + ".bin")
    _same_training_data(lj.Dataset.load_binary(path + ".bin").constructed,
                        td)
    # overwrite the text: the cache still decides what loads
    _write_text(path, x[:100] * 3, y[:100], "csv")
    t2 = lt.Dataset(path, params=_cpu(P))
    j2 = lj.Dataset(path, params=P)
    _same_training_data(_td(t2), _td(j2))
    assert t2.num_data() == N
    np.testing.assert_array_equal(t2.get_label(), y)
    # the path of a binary file itself
    d3 = lt.Dataset(path + ".bin", params=_cpu(P))
    _same_training_data(_td(d3), td)
    # two-round loading writes the cache as well
    os.remove(path + ".bin")
    _write_text(path, x, y, "csv")
    lt.Dataset(path, params=_cpu(dict(p, two_round=True))).construct()
    _same_training_data(lt.Dataset.load_binary(path + ".bin").constructed,
                        td)


# -- CSR ----------------------------------------------------------------------

def _csr(x, pkg_sparse):
    nz = x != 0
    indptr = np.concatenate([[0], np.cumsum(nz.sum(1))])
    rows, cols = np.nonzero(nz)
    return pkg_sparse.CsrMatrix(indptr, cols, x[rows, cols], x.shape[1])


def test_csr_matrix_as_jax():
    x, _ = _data(sparse=True)
    ct, cj = _csr(x, lt.data), _csr(x, jsparse)
    np.testing.assert_array_equal(np.asarray(ct), x)
    idx = np.array([5, 0, 899, 5, 17])
    np.testing.assert_array_equal(ct.rows(idx), cj.rows(idx))
    for (ra, a), (rb, b) in zip(ct.iter_dense_chunks(97),
                                cj.iter_dense_chunks(97)):
        assert ra == rb
        np.testing.assert_array_equal(a, b)
    assert (ct.nnz, ct.nbytes, ct.shape) == (cj.nnz, cj.nbytes, cj.shape)
    assert lt.data.sparse.csr_chunk_rows(28) == jsparse.csr_chunk_rows(28)
    with pytest.raises(ValueError, match="disagree"):
        lt.data.CsrMatrix([0, 2], [0], [1.0], 3)


@pytest.mark.parametrize("sample_cnt", [200_000, 300])
@pytest.mark.parametrize("layout", ["sparse", "bundled"])
def test_csr_dataset_bins_as_jax_and_dense(sample_cnt, layout, monkeypatch):
    """``construct_csr`` bins as the JAX package's and as the dense matrix
    (sampled or not, in chunks of 64 rows; EFB's layout too), and never
    densifies the whole matrix; a valid CSR set bins with its
    reference's mappers."""
    x, y = _data(sparse=True) if layout == "sparse" else _exclusive_data()
    p = dict(P, bin_construct_sample_cnt=sample_cnt)
    monkeypatch.setattr(lt.data.sparse, "CSR_CHUNK_BUDGET_BYTES", 64 * F * 8)
    monkeypatch.setattr(lt.data.CsrMatrix, "__array__", None)
    dt = lt.Dataset(_csr(x, lt.data), y, categorical_feature=[2],
                    params=_cpu(p))
    dj = lj.Dataset(_csr(x, jsparse), y, categorical_feature=[2], params=p)
    _same_training_data(_td(dt), _td(dj))
    assert dt.constructed.bundled == (layout == "bundled")
    _same_training_data(_td(dt), _td(lt.Dataset(
        x, y, categorical_feature=[2], params=_cpu(p))))
    vx, vy = _data(seed=6, n=200, sparse=True)
    _same_training_data(
        _td(lt.Dataset(_csr(vx, lt.data), vy, reference=dt,
                       params=_cpu(p))),
        _td(lj.Dataset(_csr(vx, jsparse), vy, reference=dj)))


def test_csr_dataset_trains_the_dense_tree():
    x, y = _data(sparse=True)
    a = lt.train(_cpu(P), lt.Dataset(_csr(x, lt.data), y, params=_cpu(P)), 2,
                 fobj=_int_fobj(1))
    b = lt.train(_cpu(P), lt.Dataset(x, y, params=_cpu(P)), 2,
                 fobj=_int_fobj(1))
    assert a.model_to_string() == b.model_to_string()
    np.testing.assert_array_equal(a.predict(_csr(x, lt.data)), a.predict(x))


# -- pandas -------------------------------------------------------------------

def _frames():
    """JAX tests/test_engine.py:336's DataFrames: four category columns;
    the test frame holds a level ("e") the training frame lacks."""
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(42)
    X = pd.DataFrame({
        "A": rng.permutation(["a", "b", "c", "d"] * 75),
        "B": rng.permutation([1, 2, 3] * 100),
        "C": rng.permutation([0.1, 0.2, -0.1, -0.1, 0.2] * 60),
        "D": rng.permutation([True, False] * 150),
        "E": rng.standard_normal(300)})
    y = rng.permutation([0, 1] * 150).astype(np.float64)
    X_test = pd.DataFrame({
        "A": rng.permutation(["a", "b", "e"] * 20),
        "B": rng.permutation([1, 3] * 30),
        "C": rng.permutation([0.1, -0.1, 0.2, 0.2] * 15),
        "D": rng.permutation([True, False] * 30),
        "E": rng.standard_normal(60)})
    for col in "ABCD":
        X[col] = X[col].astype("category")
        X_test[col] = X_test[col].astype("category")
    return X, y, X_test


def _int_fobj(seed):
    calls = [0]

    def fobj(preds, data):
        rng = np.random.default_rng(seed + calls[0])
        calls[0] += 1
        return (rng.integers(-3, 4, len(preds)).astype(np.float64),
                rng.integers(1, 4, len(preds)).astype(np.float64))
    return fobj


def test_pandas_categoricals_as_jax(tmp_path):
    """Category columns become codes (-1 as NaN), their levels recorded on
    the training frame and realigned on others; the model text ends with
    the ``pandas_categorical`` line, equal to the JAX package's, and a
    model file carries it back."""
    X, y, X_test = _frames()
    p = dict(P, min_data_in_leaf=10)
    dt, dj = lt.Dataset(X, y, params=_cpu(p)), lj.Dataset(X, y, params=p)
    _same_training_data(_td(dt), _td(dj))
    assert dt.pandas_categorical == dj.pandas_categorical
    # A, B and C categorical; D's two levels bin as a numerical column
    assert [m.bin_type for m in dt.constructed.bin_mappers] == [1, 1, 1, 0, 0]
    _same_training_data(_td(lt.Dataset(X_test, reference=dt, params=_cpu(p))),
                        _td(lj.Dataset(X_test, reference=dj)))
    bt = lt.train(_cpu(p), dt, 3, fobj=_int_fobj(2))
    bj = lj.train(p, dj, 3, fobj=_int_fobj(2), verbose_eval=False)
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    assert text.rstrip().rsplit("\n", 1)[-1].startswith("pandas_categorical:")
    np.testing.assert_allclose(bt.predict(X_test), bj.predict(X_test),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(bt.predict(X_test, pred_leaf=True),
                                  bj.predict(X_test, pred_leaf=True))
    path = str(tmp_path / "m.txt")
    bt.save_model(path)
    with open(path) as f:
        assert f.read() == text
    back = lt.Booster(model_file=path, params={"device": "cpu"})
    assert back.pandas_categorical == bj.pandas_categorical
    np.testing.assert_array_equal(back.predict(X_test, pred_leaf=True),
                                  bj.predict(X_test, pred_leaf=True))
    assert lj.Booster(model_file=path).pandas_categorical == \
        back.pandas_categorical


def test_pandas_valid_with_other_levels_rejected():
    X, y, X_test = _frames()
    dt = lt.Dataset(X, y, params=_cpu(P))
    with pytest.raises(ValueError, match="do not match"):
        lt.Dataset(X_test[["A", "E"]], reference=dt,
                   params=_cpu(P)).construct()


# -- the reference and naming methods ----------------------------------------

def test_set_categorical_feature_and_reference_reset_construction():
    x, y = _data()
    for pkg, p in ((lt, _cpu(P)), (lj, P)):
        d = pkg.Dataset(x, y, params=p).construct()
        before = d.constructed.bin_mappers[2].bin_type
        d.set_categorical_feature([2])
        after = d.construct().constructed.bin_mappers[2].bin_type
        assert (before, after) == (0, 1)
    dt, dj = (lt.Dataset(x, y, params=_cpu(P)).set_categorical_feature([2]),
              lj.Dataset(x, y, params=P).set_categorical_feature([2]))
    _same_training_data(_td(dt), _td(dj))
    # another reference: the valid set is binned anew with its mappers
    vx, _ = _data(seed=9, n=200)
    other = lt.Dataset(x * 2, y, params=_cpu(P)).construct()
    v = lt.Dataset(vx, reference=dt, params=_cpu(P)).construct()
    first = v.constructed.binned.copy()
    v.set_reference(dt)                       # the same: nothing resets
    assert v.constructed is not None
    v.set_reference(other)
    assert v.constructed is None and v.bins is None
    vj = lj.Dataset(vx, reference=lj.Dataset(x * 2, y, params=P))
    np.testing.assert_array_equal(_td(v).binned, _td(vj).binned)
    assert not np.array_equal(first, v.constructed.binned)


def test_set_feature_name():
    x, y = _data()
    names = [f"n{j}" for j in range(F)]
    for pkg, p in ((lt, _cpu(P)), (lj, P)):
        d = pkg.Dataset(x, y, params=p).construct()
        assert d.set_feature_name("auto") is d
        d.set_feature_name(names)
        assert d.constructed.feature_names == names
        bst = pkg.train(p, d, 1, **({} if pkg is lt else
                                    {"verbose_eval": False}))
        assert bst.feature_name() == names


def test_get_ref_chain():
    x, y = _data()
    a = lt.Dataset(x, y, params=_cpu(P))
    b = lt.Dataset(x, y, reference=a)
    c = lt.Dataset(x, y, reference=b)
    assert c.get_ref_chain() == {a, b, c}
    assert c.get_ref_chain(ref_limit=2) == {b, c}
    ja = lj.Dataset(x, y)
    jc = lj.Dataset(x, y, reference=lj.Dataset(x, y, reference=ja))
    assert len(jc.get_ref_chain()) == len(c.get_ref_chain())


def test_free_raw_data_stops_cv_and_subset_as_jax():
    x, y = _data()
    for pkg, p in ((lt, _cpu(P)), (lj, P)):
        d = pkg.Dataset(x, y, params=p, free_raw_data=True, silent=True)
        d.construct()
        assert d.data is None
        with pytest.raises(RuntimeError, match="Cannot subset: raw data "
                                               "not in memory"):
            d.subset([0, 1, 2])
        with pytest.raises(RuntimeError, match=r"cv requires raw data "
                                               r"\(set free_raw_data=False\)"):
            pkg.cv(p, d, 2, nfold=2)


def test_file_dataset_subset_cv_and_predict(tmp_path):
    """A Dataset of a path gives its rows to ``subset`` and ``cv`` by
    parsing the file again; ``predict`` of the path is ``predict`` of
    the matrix."""
    x, y = _data()
    path = _write_text(tmp_path / "d.csv", x, y, "csv", header=True)
    p = dict(P, header=True)
    dt = lt.Dataset(path, params=_cpu(p))
    dj = lj.Dataset(path, params=p)
    idx = np.arange(0, N, 3)
    _same_training_data(_td(dt.subset(idx)), _td(dj.subset(idx)))
    res = lt.cv(_cpu(p), dt, 2, nfold=2)
    assert len(res["binary_logloss-mean"]) == 2
    bst = lt.Booster(_cpu(p), dt, silent=True)
    bst.update()
    np.testing.assert_array_equal(bst.predict(path),
                                  bst.predict(tparser.load_text_file(
                                      path, True)[0]))
    np.testing.assert_array_equal(bst.predict(path, pred_leaf=True),
                                  bst.predict(x, pred_leaf=True))
