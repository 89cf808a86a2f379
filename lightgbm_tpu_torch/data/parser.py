"""Text data parsers: CSV / TSV / LibSVM with format auto-detection.

The port's own copy of ``lightgbm_tpu/data/parser.py``'s numpy path; the
host library's parser (``native.parse_file``) reads the same formats to
the same bits.  Mirrors the reference
parser surface (``src/io/parser.{hpp,cpp}``): the format is sniffed from
the first lines (``CreateParser``), labels sit in a configurable column,
LibSVM rows are ``label idx:val ...`` sparse pairs.  Implemented with
numpy batch parsing rather than per-line virtual calls.
"""
from __future__ import annotations

import io
from typing import List, Optional, Tuple

import numpy as np

from ..utils import log


NA_VALUES = ["", "na", "nan", "NA", "NaN", "null"]


def _read_head(path: str, n_lines: int = 32) -> List[str]:
    """First lines of a file for sniffing; fatal on an empty file."""
    with open(path, "r") as f:
        head = [line for _, line in zip(range(n_lines), f)]
    if not head:
        log.fatal("Data file %s is empty", path)
    return head


def sniff_file(path: str, has_header: bool) -> Tuple[str, int]:
    """(format, num_columns) for a data file — blank lines skipped."""
    head = _read_head(path)
    start = 1 if has_header else 0
    return _sniff_format(head[start:] or head)


def read_header_names(path: str, label_idx: int = 0) -> Optional[List[str]]:
    """Column names from a header line, label column removed (None for
    libsvm, which has no per-column header)."""
    head = _read_head(path)
    fmt, _ = _sniff_format(head[1:] or head)
    if fmt == "libsvm":
        return None
    sep = "," if fmt == "csv" else "\t"
    names = [t.strip() for t in head[0].strip().split(sep)]
    if label_idx >= 0:
        names = [h for i, h in enumerate(names) if i != label_idx]
    return names


def _sniff_format(lines: List[str]) -> Tuple[str, int]:
    """Return (format, num_columns). format in {csv, tsv, libsvm}."""
    for line in lines:
        line = line.strip()
        if not line:
            continue
        tokens_tab = line.split("\t")
        tokens_comma = line.split(",")
        tokens_space = line.split()
        if any(":" in t for t in tokens_space[1:]):
            return "libsvm", 0
        if len(tokens_tab) > 1:
            return "tsv", len(tokens_tab)
        if len(tokens_comma) > 1:
            return "csv", len(tokens_comma)
        if len(tokens_space) > 1:
            return "tsv", len(tokens_space)  # space-separated handled like TSV
    return "csv", 1


def _delimiter(fmt: str, lines: List[str]) -> Optional[str]:
    """``genfromtxt``'s delimiter: a comma, a tab where the data lines hold
    tabs (so that an empty cell stays a cell, as the native parser reads
    it), else any whitespace."""
    if fmt == "csv":
        return ","
    return "\t" if any("\t" in line for line in lines) else None


def load_text_file(path: str, has_header: bool = False,
                   label_idx: int = 0) -> Tuple[np.ndarray, np.ndarray, Optional[List[str]]]:
    """Parse a data file into (features [N, F] float64, labels [N], feature_names).

    Missing values (empty CSV cells, "na"/"nan") become NaN.  LibSVM zero
    default is 0.0 as in the reference.
    """
    head = _read_head(path)
    start = 1 if has_header else 0
    fmt, _ = _sniff_format(head[start:] or head)

    header_names: Optional[List[str]] = None
    if has_header and fmt != "libsvm":
        sep_h = "," if fmt == "csv" else "\t"
        header_names = [t.strip() for t in head[0].strip().split(sep_h)]

    if fmt == "libsvm":
        return _load_libsvm(path, has_header, label_idx) + (None,)

    delim = _delimiter(fmt, head[start:] or head)

    def conv(text: str) -> np.ndarray:
        return np.genfromtxt(io.StringIO(text), delimiter=delim,
                             skip_header=start, dtype=np.float64,
                             missing_values=NA_VALUES,
                             filling_values=np.nan)

    with open(path, "r") as f:
        mat = conv(f.read())
    if mat.ndim == 1:
        mat = mat.reshape(-1, 1) if mat.size else mat.reshape(0, 1)
    if label_idx >= 0:
        labels = mat[:, label_idx].astype(np.float32)
        features = np.delete(mat, label_idx, axis=1)
        if header_names is not None:
            header_names = [h for i, h in enumerate(header_names) if i != label_idx]
    else:
        labels = np.zeros(mat.shape[0], dtype=np.float32)
        features = mat
    return features, labels, header_names


def count_data_rows(path: str, has_header: bool,
                    label_idx: int = 0) -> Tuple[int, int]:
    """Round-0 scan of the streamed loader: (num_rows, num_features)
    without materializing any floats (dataset_loader.cpp CountLine).

    CSV/TSV: a newline scan plus the sniffed column count.  LibSVM: the
    scan must also tokenize to learn the feature-space width (the maximum
    index may appear on any line) — the price of a headerless sparse
    format."""
    fmt, ncol = sniff_file(path, has_header)
    n = 0
    if fmt == "libsvm":
        max_idx = -1
        with open(path, "r") as f:
            if has_header:
                f.readline()
            for line in f:
                if not line.strip():
                    continue
                n += 1
                for tok in line.split():
                    i, _, _v = tok.partition(":")
                    if _v and i.isdigit():
                        idx = int(i)
                        if idx > max_idx:
                            max_idx = idx
        return n, max_idx + 1
    with open(path, "r") as f:
        if has_header:
            f.readline()
        for line in f:
            if line.strip():
                n += 1
    return n, ncol - (1 if label_idx >= 0 else 0)


def iter_parsed_chunks(path: str, has_header: bool, label_idx: int,
                       chunk_rows: int = 200_000, ncol: int = None):
    """Stream (features [c, F] f64, labels [c] f32) chunks — the per-chunk
    worker of the two-round loader.  ``ncol`` fixes the feature count
    (required for libsvm, where any single chunk may not witness the
    maximum feature index)."""
    fmt, _ = sniff_file(path, has_header)
    head = _read_head(path)
    delim = _delimiter(fmt, head[1 if has_header else 0:] or head)

    def flush_csv(lines):
        mat = np.genfromtxt(io.StringIO("".join(lines)),
                            delimiter=delim,
                            dtype=np.float64,
                            missing_values=NA_VALUES,
                            filling_values=np.nan)
        if mat.ndim == 1:
            mat = mat.reshape(len(lines), -1)
        if label_idx >= 0:
            return (np.delete(mat, label_idx, axis=1),
                    mat[:, label_idx].astype(np.float32))
        return mat, np.zeros(len(mat), dtype=np.float32)

    def flush_libsvm(lines):
        feats = np.zeros((len(lines), ncol), dtype=np.float64)
        labs = np.zeros(len(lines), dtype=np.float32)
        for r, line in enumerate(lines):
            toks = line.split()
            if label_idx >= 0 and toks and ":" not in toks[0]:
                labs[r] = float(toks[0])
                toks = toks[1:]
            for t in toks:
                i, _, v = t.partition(":")
                # non-numeric ids (e.g. ranking "qid:3") are skipped, same
                # as in the counting pass
                if v and i.isdigit():
                    feats[r, int(i)] = float(v)
        return feats, labs

    flush = flush_libsvm if fmt == "libsvm" else flush_csv
    buf = []
    with open(path, "r") as f:
        if has_header:
            f.readline()
        for line in f:
            if not line.strip():
                continue
            buf.append(line)
            if len(buf) >= chunk_rows:
                yield flush(buf)
                buf = []
    if buf:
        yield flush(buf)


def _load_libsvm(path: str, has_header: bool, label_idx: int) -> Tuple[np.ndarray, np.ndarray]:
    rows: List[List[Tuple[int, float]]] = []
    labels: List[float] = []
    max_idx = -1
    with open(path, "r") as f:
        if has_header:
            f.readline()
        for line in f:
            line = line.strip()
            if not line:
                continue
            toks = line.split()
            if label_idx >= 0:
                labels.append(float(toks[0]))
                toks = toks[1:]
            else:
                labels.append(0.0)
            row = []
            for t in toks:
                if ":" not in t:
                    continue
                i, v = t.split(":", 1)
                i = int(i)
                row.append((i, float(v)))
                max_idx = max(max_idx, i)
            rows.append(row)
    mat = np.zeros((len(rows), max_idx + 1), dtype=np.float64)
    for r, row in enumerate(rows):
        for i, v in row:
            mat[r, i] = v
    return mat, np.asarray(labels, dtype=np.float32)
