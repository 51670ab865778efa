"""Readers and writers of the reference file formats, in numpy and gzip.

Counterpart of the parts of hygeia_tpu/utils/io.py that ``infer`` uses.
That module imports pandas, which the port does not depend on; the formats
are simple enough to read and write directly:

* count files (preprocess output, read by ``infer``): header-less,
  comma-separated, one row per CpG site (``positions_{chrom}.txt.gz``...);
* the theta file: a headed CSV with one ``data`` column.

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
    _ensure_dir(path)
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a[:, None]
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"write_count_matrix writes integer tables, got {a.dtype}")
    buf = _io.StringIO()
    np.savetxt(buf, a, fmt="%d", delimiter=",", newline="\n")
    data = buf.getvalue().encode()
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=level) as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def read_theta(path):
    """theta vector from the single-group ``data``-column CSV."""
    lines = _read_text(path).decode().splitlines()
    header = [h.strip().strip('"') for h in lines[0].split(",")]
    col = header.index("data")
    return np.array([float(ln.split(",")[col]) for ln in lines[1:] if ln.strip()])


def write_theta(path, theta):
    """The ``data``-column CSV; float values by their shortest repr."""
    _ensure_dir(path)
    text = "data\n" + "".join(f"{float(v)!r}\n" for v in np.asarray(theta).ravel())
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(text.encode())
    else:
        with open(path, "w") as f:
            f.write(text)


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
