"""Readers and writers of the reference file formats, in numpy and gzip.

Counterpart of hygeia_tpu/utils/io.py. That module imports pandas, which
the port does not depend on; the formats are simple enough to read and
write directly:

* count files (preprocess output, read by ``infer``): header-less,
  comma-separated, one row per CpG site (``positions_{chrom}.txt.gz``...);
* the single-group engine's files: headed CSVs as pandas writes them (a
  header line of column names, then one row per record, no index column);
  count matrices are stored (n_sites, n_samples) with ``sample_i`` columns;
* the theta file: a headed CSV with one ``data`` column.

Every writer gzips when the path ends in ``.gz``, as pandas does.

Integer tables are written byte-identically (after decompression) to the
JAX package's writer: one row per line, values joined by ",", "\\n" line
ends, no header.
"""

from __future__ import annotations

import gzip
import io as _io
import os
import zipfile

import numpy as np


def _ensure_dir(path):
    d = os.path.dirname(str(path))
    if d:
        os.makedirs(d, exist_ok=True)


def _read_text(path):
    path = str(path)
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _write_text(path, text, level=1):
    _ensure_dir(path)
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=level) as f:
            f.write(text.encode())
    else:
        with open(path, "w") as f:
            f.write(text)


def read_count_matrix(path, dtype=np.float32):
    """(T, S) matrix from a header-less comma-separated (.gz) file."""
    text = _read_text(path)
    lines = text.splitlines()
    while lines and not lines[-1].strip():
        lines.pop()
    if not lines:
        return np.zeros((0, 0), dtype)
    n_cols = lines[0].count(b",") + 1
    vals = np.array(text.replace(b",", b" ").split(), dtype=np.float64)
    if vals.size != len(lines) * n_cols:
        raise ValueError(f"{path}: ragged table ({vals.size} values, {len(lines)} rows)")
    return vals.reshape(len(lines), n_cols).astype(dtype, copy=False)


def read_positions(path):
    return read_count_matrix(path, np.int64).ravel()


def write_count_matrix(path, arr, level=1):
    """Header-less comma-separated integer table, gzip level 1 when the path
    ends in .gz. Only integer arrays: the port writes the trimmed counts and
    positions, which are integers."""
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a[:, None]
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"write_count_matrix writes integer tables, got {a.dtype}")
    buf = _io.StringIO()
    np.savetxt(buf, a, fmt="%d", delimiter=",", newline="\n")
    _write_text(path, buf.getvalue(), level)


# ---------- headed CSVs (the single-group engine's files) ----------

def read_headed_table(path):
    """(column names, (n_rows, n_cols) float64 array) of a headed CSV."""
    lines = _read_text(path).decode().splitlines()
    header = [h.strip().strip('"') for h in lines[0].split(",")]
    rows = [ln for ln in lines[1:] if ln.strip()]
    text = " ".join(ln.replace(",", " ") for ln in rows)
    vals = np.array(text.split(), dtype=np.float64)
    if vals.size != len(rows) * len(header):
        raise ValueError(f"{path}: ragged table ({vals.size} values, {len(rows)} rows)")
    return header, vals.reshape(len(rows), len(header))


def read_headed_matrix(path):
    """(n_cols, n_rows): a count matrix stored (n_sites, n_samples) with
    ``sample_i`` columns comes back (n_samples, n_sites)."""
    return read_headed_table(path)[1].T


def read_headed_column(path):
    """The first column of a headed CSV."""
    return read_headed_table(path)[1][:, 0]


def _format(a):
    """Strings of an array's values: integers as integers, floats by the
    shortest repr of their own precision (float32 stays short)."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == bool:
        return a.astype(np.int64).astype(str)
    return a.astype(str)


def write_headed_columns(path, columns):
    """A headed CSV from {name: 1-D array} (all of one length)."""
    names = list(columns)
    cols = [_format(v).ravel() for v in columns.values()]
    body = "".join(",".join(row) + "\n" for row in zip(*cols))
    _write_text(path, ",".join(names) + "\n" + body)


def write_headed_column(path, values, name):
    write_headed_columns(path, {name: np.asarray(values).ravel()})


def write_headed_matrix(path, matrix, prefix):
    """A (k, n) matrix written (n, k) with ``{prefix}_i`` columns (the
    count matrices are stored (n_sites, n_samples))."""
    m = np.asarray(matrix)
    write_headed_columns(path, {f"{prefix}_{i + 1}": m[i] for i in range(m.shape[0])})


def write_headed_table(path, table, names, first=None):
    """A (n, k) table with the given column names, after an optional first
    column (name, values)."""
    t = np.asarray(table)
    cols = {} if first is None else {first[0]: np.asarray(first[1])}
    cols.update({name: t[:, j] for j, name in enumerate(names)})
    write_headed_columns(path, cols)


def read_theta(path):
    """theta vector from the single-group ``data``-column CSV."""
    header, vals = read_headed_table(path)
    return vals[:, header.index("data")]


def write_theta(path, theta):
    """The ``data``-column CSV; float values by their shortest repr."""
    write_headed_column(path, theta, "data")


def theta_file_to_p_softmax(theta, n_regimes):
    """(log P, omega_logit) from the packed theta: exponentiate the R(R-1)
    off-diagonal entries row-major, renormalise each row, take log (the
    diagonal becomes -inf); the last R entries are logit(omega)."""
    R = n_regimes
    theta = np.asarray(theta, np.float64)
    p = np.zeros((R, R))
    i = 0
    for r in range(R):
        for c in range(R):
            if c != r:
                p[r, c] = np.exp(theta[i])
                i += 1
        p[r] = p[r] / p[r].sum()
    with np.errstate(divide="ignore"):
        log_p = np.log(p)
    return log_p, theta[-R:]


def savez_fast(path, arr, level=1):
    """Single-array .npz (member "arr_0", as np.savez_compressed(path, arr)
    names it) at zlib level ``level``, or stored when level=0."""
    path = str(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    buf = _io.BytesIO()
    np.lib.format.write_array(buf, np.asanyarray(arr), allow_pickle=False)
    if level:
        zf = zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED, compresslevel=level)
    else:
        zf = zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED)
    with zf:
        zf.writestr("arr_0.npy", buf.getvalue())
