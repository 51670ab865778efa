"""BED-format methylation preprocessing, in numpy.

Counterpart of hygeia_tpu/pipeline/preprocess_bed.py, which is written in
pandas; the files written here are that stage's byte for byte after
decompression. Steps:

1. per sample: keep the (chromosome, ref CG) records, collapse +/- strands
   by joining +.end == -.start (coverage-weighted methylation average,
   position +.start, or -.start - 1 when only the minus strand is covered);
2. counts: methylated = round(cov * pct / 100), unmethylated =
   round(cov * (100 - pct) / 100), rounding half away from zero;
3. outer-join all samples onto the reference CpG positions (0-based,
   Pos0 = cpg.start - 1), 0 reads where a sample has none;
4. write positions / n_methylated_reads_* / n_total_reads_* /
   cpg_sites_merged as comma-separated .txt.gz.

The pandas behaviours the output depends on, reproduced: an outer merge
orders its rows by key and expands a key present several times on both
sides as the product of its rows (left-major); ``sort_values`` is numpy's
argsort(kind="quicksort"), not stable, on the column's own dtype (float64
when the merge left holes in it); a missing sample file keeps its two
column slots as NaN, written as 0 after ``nan_to_num``; ``np.savetxt``
with ``fmt="%s"`` writes the float counts as "3.0".
"""

from __future__ import annotations

import gzip
import os
import re
from pathlib import Path

import numpy as np

from hygeia_tpu_torch.utils import io as hio

_BED_COLUMNS = [
    "chr", "start", "end", "name", "score", "strand", "thickStart", "thickEnd",
    "itemRgb", "coverage", "percent_methylated", "ref_genotype", "sample_genotype",
    "quality_score",
]
_INT = re.compile(r"^[+-]?\d+$")


def _read_rows(path, skip):
    """Tab-separated fields of the non-blank lines after the first ``skip``."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.read().splitlines()[skip:]
    return [ln.split("\t") for ln in lines if ln.strip()]


def _as_str(values):
    """A column's strings as pandas' read_csv then astype(str) gives them: an
    all-integer column as its integers, an all-float one as their reprs,
    any other as read."""
    if all(_INT.match(v.strip()) for v in values):
        return [str(int(v)) for v in values]
    try:
        return [repr(float(v)) for v in values]
    except ValueError:
        return list(values)


def _floats(values):
    return np.array([float(v) if v.strip() else np.nan for v in values], np.float64)


def _outer_merge(left_key, right_key):
    """Row indices (left, right) of pandas' outer merge on one key, -1 where
    a side has no row: the keys ascending; a key's left rows in their order,
    each with every right row of the key in theirs."""
    left_key, right_key = np.asarray(left_key), np.asarray(right_key)
    keys = np.union1d(left_key, right_key)
    lo, ro = np.argsort(left_key, kind="stable"), np.argsort(right_key, kind="stable")
    ls, rs = left_key[lo], right_key[ro]
    l0 = np.searchsorted(ls, keys, "left")
    r0 = np.searchsorted(rs, keys, "left")
    nl = np.searchsorted(ls, keys, "right") - l0
    nr = np.searchsorted(rs, keys, "right") - r0
    ml, mr = np.maximum(nl, 1), np.maximum(nr, 1)
    per_key = ml * mr
    k = np.repeat(np.arange(keys.size), per_key)
    j = np.arange(k.size) - np.repeat(np.cumsum(per_key) - per_key, per_key)
    li = _through(lo, np.where(nl[k] > 0, l0[k] + j // mr[k], -1))
    ri = _through(ro, np.where(nr[k] > 0, r0[k] + j % mr[k], -1))
    return li, ri


def _through(rows, idx):
    """rows[idx], -1 where idx is -1."""
    out = np.full(idx.shape, -1, np.int64)
    out[idx >= 0] = rows[idx[idx >= 0]]
    return out


def _take(values, idx, fill=np.nan):
    """values[idx] as float64, ``fill`` where idx is -1."""
    v = np.asarray(values, np.float64)
    out = np.full(idx.shape, fill, np.float64)
    hit = idx >= 0
    out[hit] = v[idx[hit]]
    return out


def collapse_strands(bed):
    """Merge +/- strand records of each CpG into one site. ``bed``: columns
    start, end (int64), strand (str), coverage, percent_methylated
    (float64). Returns {start, total_coverage, avg_percent_methylated},
    sorted by start."""
    strand = np.asarray(bed["strand"])
    p, n = np.flatnonzero(strand == "+"), np.flatnonzero(strand == "-")
    li, ri = _outer_merge(bed["end"][p], bed["start"][n])
    lp, rn = _through(p, li), _through(n, ri)
    cov_p = np.nan_to_num(_take(bed["coverage"], lp), nan=0.0)
    cov_n = np.nan_to_num(_take(bed["coverage"], rn), nan=0.0)
    pct_p = np.nan_to_num(_take(bed["percent_methylated"], lp), nan=0.0)
    pct_n = np.nan_to_num(_take(bed["percent_methylated"], rn), nan=0.0)
    total = cov_p + cov_n
    # pandas' "start" holds NaN (so float64) where only the minus strand is.
    start = np.where(lp >= 0, _take(bed["start"], lp), _take(bed["start"], rn) - 1)
    if not (li < 0).any():
        start = start.astype(np.int64)
    avg = np.where(total > 0, (cov_p * pct_p + cov_n * pct_n) / np.where(total > 0, total, 1.0), 0.0)
    keep = total > 0
    start, total, avg = start[keep], total[keep], avg[keep]
    order = start.argsort(kind="quicksort")
    return {"start": start[order], "total_coverage": total[order], "avg_percent_methylated": avg[order]}


def _round_half_away(x):
    """Round half away from zero on non-negative values (the reference's
    polars round; numpy's rounds half to even)."""
    return np.floor(np.asarray(x, float) + 0.5)


def read_bed_sample(path, chromosome):
    """One BED methylation file -> {Pos0, methylated, unmethylated} (int64
    arrays) of the chromosome's collapsed CpGs."""
    rows = [r[: len(_BED_COLUMNS)] for r in _read_rows(path, 1)]
    cols = {name: [r[i] if i < len(r) else "" for r in rows] for i, name in enumerate(_BED_COLUMNS)}
    keep = [i for i, (c, g) in enumerate(zip(_as_str(cols["chr"]), cols["ref_genotype"]))
            if c == str(chromosome) and g == "CG"]
    if not keep:
        empty = np.zeros(0, np.int64)
        return {"Pos0": empty, "methylated": empty, "unmethylated": empty}
    bed = {
        "start": np.array([int(cols["start"][i]) for i in keep], np.int64),
        "end": np.array([int(cols["end"][i]) for i in keep], np.int64),
        "strand": np.array([cols["strand"][i] for i in keep]),
        "coverage": _floats([cols["coverage"][i] for i in keep]),
        "percent_methylated": _floats([cols["percent_methylated"][i] for i in keep]),
    }
    c = collapse_strands(bed)
    cov, pct = c["total_coverage"], c["avg_percent_methylated"]
    return {
        "Pos0": c["start"].astype(np.int64),
        "methylated": _round_half_away(cov * pct / 100.0).astype(np.int64),
        "unmethylated": _round_half_away(cov * (100.0 - pct) / 100.0).astype(np.int64),
    }


def _savetxt_s(path, arr):
    """np.savetxt(path, arr, delimiter=",", fmt="%s"): integers as
    integers, float64 by their repr ("3.0")."""
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a[:, None]
    if np.issubdtype(a.dtype, np.integer):
        data = hio.format_int_rows(a, ",")
    elif np.all(np.isfinite(a)) and np.all(a == np.trunc(a)) and np.all(np.abs(a) < 1e16):
        data = hio.format_int_rows(a.astype(np.int64), ",", suffix=".0")
    else:
        data = "".join(",".join(repr(float(v)) for v in row) + "\n" for row in a).encode()
    hio._write_bytes(path, data)


def process_bed(
    cpg_file_path,
    output_path,
    chromosome,
    *,
    control_data_paths=(),
    control_id_names=(),
    case_data_paths=(),
    case_id_names=(),
):
    """Run the full preprocessing; returns the number of CpG sites written."""
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)

    rows = _read_rows(cpg_file_path, 0)
    header, rows = rows[0], rows[1:]
    seq = _as_str([r[header.index("seqID")] for r in rows])
    starts = [int(r[header.index("start")]) for r, s in zip(rows, seq) if s == str(chromosome)]
    if not starts:
        raise ValueError(f"No CpG sites found for chromosome {chromosome}")

    pos0 = np.asarray(starts, np.int64) - 1
    columns = []  # (non_conv, conv) float64 columns, NaN where a sample has no row

    def _add_group(paths, names):
        nonlocal pos0, columns
        for path, _name in zip(paths, names):
            if not os.path.exists(path):
                # The reference logs the missing file and keeps the sample as
                # all-null columns -> zeros after nan_to_num; the slots keep
                # later samples in their places.
                columns += [np.full(pos0.shape, np.nan), np.full(pos0.shape, np.nan)]
                continue
            sample = read_bed_sample(path, chromosome)
            li, ri = _outer_merge(pos0, sample["Pos0"])
            pos0 = np.where(li >= 0, _take(pos0, li), _take(sample["Pos0"], ri)).astype(np.int64)
            columns = [_take(c, li) for c in columns]
            columns += [_take(sample["methylated"], ri), _take(sample["unmethylated"], ri)]

    _add_group(control_data_paths, control_id_names)
    _add_group(case_data_paths, case_id_names)
    order = pos0.argsort(kind="quicksort")
    positions = pos0[order]
    data = np.stack([c[order] for c in columns], axis=1) if columns else np.zeros((pos0.size, 0))
    data = np.nan_to_num(data)

    n_control = len(control_id_names)
    n_case = len(case_id_names)
    files = {
        "positions": positions,
        "cpg_sites_merged": np.array([len(positions)]),
    }
    if n_control:
        meth = data[:, 0 : 2 * n_control : 2]
        unmeth = data[:, 1 : 2 * n_control : 2]
        files["n_methylated_reads_control"] = meth
        files["n_total_reads_control"] = meth + unmeth
    if n_case:
        off = 2 * n_control
        meth = data[:, off::2]
        unmeth = data[:, off + 1 :: 2]
        files["n_methylated_reads_case"] = meth
        files["n_total_reads_case"] = meth + unmeth

    for name, arr in files.items():
        _savetxt_s(output_path / f"{name}_{chromosome}.txt.gz", arr)
    return len(positions)
