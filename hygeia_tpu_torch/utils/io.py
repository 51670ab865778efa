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


def _write_bytes(path, data, level=1):
    _ensure_dir(path)
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=level) as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


_ROWS_PER_PIECE = 1 << 16


def format_int_rows(values, sep=",", index=None, suffix=""):
    """Bytes of an integer table, one row a line: each value in decimal
    followed by ``suffix`` (``"%d" + suffix`` of it), joined by ``sep``,
    after an optional integer index column; "\n" line ends. The same bytes
    as np.savetxt(fmt="%d" + suffix) or pandas' to_csv of an int frame,
    built from digit arrays instead of one format call a value (a few
    seconds less a table at chromosome scale)."""
    a = np.asarray(values)
    if a.ndim == 1:
        a = a[:, None]
    if not (np.issubdtype(a.dtype, np.integer) or a.dtype == bool):
        raise TypeError(f"format_int_rows formats integer tables, got {a.dtype}")
    a = a.astype(np.int64)
    if index is not None:
        a = np.concatenate([np.asarray(index, np.int64)[:, None], a], axis=1)
    n, k = a.shape
    if n == 0 or k == 0:
        return b"\n" * n
    sfx = np.frombuffer(suffix.encode(), np.uint8)
    sep_b, nl = ord(sep), ord("\n")
    pieces = []
    for lo in range(0, n, _ROWS_PER_PIECE):
        v = a[lo : lo + _ROWS_PER_PIECE]
        neg = v < 0
        mag = np.abs(v).astype(np.uint64)
        n_dig = np.ones(v.shape, np.int64)
        for e in range(1, 19):  # |int64| has at most 19 digits
            more = mag >= np.uint64(10**e)
            if not more.any():
                break
            n_dig += more
        width = int(n_dig.max()) + 1  # sign, digits
        W = width + sfx.size + 1  # then the suffix and the separator
        cell = np.zeros((*v.shape, W), np.uint8)
        m = mag.copy()
        for d in range(width - 1):  # right-aligned digits, last first
            cell[..., width - 1 - d] = (m % np.uint64(10)).astype(np.uint8) + ord("0")
            m //= np.uint64(10)
        cell[(*np.nonzero(neg), (width - 1 - n_dig)[neg])] = ord("-")
        cell[..., width : width + sfx.size] = sfx
        cell[..., -1] = sep_b
        cell[:, -1, -1] = nl
        pos = np.arange(W)
        keep = pos >= (width - n_dig - neg)[..., None]
        pieces.append(cell[keep].tobytes())
    return b"".join(pieces)


def write_count_matrix(path, arr, level=1):
    """Header-less comma-separated integer table, gzip level 1 when the path
    ends in .gz. Only integer arrays: the port writes the trimmed counts and
    positions, which are integers."""
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a[:, None]
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"write_count_matrix writes integer tables, got {a.dtype}")
    _write_bytes(path, format_int_rows(a, ","), level)


def write_int_table(path, values, *, index=None, header=None, sep="\t", level=1):
    """An integer table with an optional header line and index column, as
    pandas' to_csv of an int frame writes it (the aggregate stage's
    tables: header ``pos\t0\t1...``, the positions as the index)."""
    head = b"" if header is None else header.encode() + b"\n"
    _write_bytes(path, head + format_int_rows(values, sep, index=index), level)


def read_int_table(path, sep="\t"):
    """(header names, index (n,) int64, values (n, k) int64) of a table
    write_int_table wrote."""
    lines = _read_text(path).split(b"\n")
    header = lines[0].decode().split(sep)
    rows = [ln for ln in lines[1:] if ln.strip()]
    vals = np.array(b" ".join(rows).replace(sep.encode(), b" ").split(), dtype=np.int64)
    vals = vals.reshape(len(rows), len(header))
    return header, vals[:, 0], vals[:, 1:]


def _float_cells(a, sig_digits=9):
    """The cells of a float table as the JAX package's native float writer
    formats them: integral values below 1e15 in magnitude as "%d.0",
    others "%.{sig_digits}g"."""
    a = np.asarray(a, np.float64)
    out = np.char.mod(f"%.{sig_digits}g", a).astype(object)
    integral = np.isfinite(a) & (np.abs(a) < 1e15) & (a == np.trunc(np.where(np.isfinite(a), a, 0)))
    out[integral] = [f"{int(v)}.0" for v in a[integral]]
    return out


def write_float_table(path, values, *, index=None, header=None, sep=",", level=1):
    """A float table (regime probabilities, theta traces) with an optional
    header line and integer index column, in the JAX package's native
    writer's format (%.9g, integral values as "x.0"; %.9g restores a float32
    exactly). Runs of equal rows (a theta trace between updates) are
    formatted once."""
    a = np.asarray(values, np.float64)
    if a.ndim == 1:
        a = a[:, None]
    n = a.shape[0]
    if n:
        starts = np.flatnonzero(np.concatenate([[True], np.any(a[1:] != a[:-1], axis=1)]))
        cells = _float_cells(a[starts])
        rows = np.array([sep.join(r) for r in cells.tolist()], dtype=object)
        rows = rows[np.searchsorted(starts, np.arange(n), side="right") - 1]
        if index is not None:
            rows = np.asarray(index, np.int64).astype(str).astype(object) + sep + rows
        body = "\n".join(rows.tolist()) + "\n"
    else:
        body = ""
    _write_text(path, ("" if header is None else header + "\n") + body, level)


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
