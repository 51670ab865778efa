"""gemBS-format methylation preprocessing, in numpy.

Counterpart of hygeia_tpu/pipeline/preprocess_gembs.py, which is written in
pandas; the files written here are that stage's byte for byte after
decompression. gemBS tab files carry per-CpG methylated / unmethylated
counts as ``{sample}:non_conv`` / ``{sample}:conv`` columns keyed by
``Pos0``, so no strand collapse is needed: keep the (``chr{chromosome}``,
``Ref == 'CG'``) rows, outer-merge them onto the reference CpG positions
(``seqID == chr{chromosome}``), zeros where a sample has no row, and write
the BED path's count matrices.

Per-sample failure semantics, as the JAX stage's: a sample file that does
not exist gets no column slot at all (which can shift the control / case
column split; the split's shape guards are kept); an empty chromosome
slice, missing columns or a read error keep the sample's two column slots
as NaN (zero counts). A NaN slot named like an existing column overwrites
it, and a merge whose columns collide renames them with pandas' ``_x`` /
``_y`` suffixes, so the columns stay in pandas' order.

The merges and the final sort reuse ``preprocess_bed``'s reproductions of
pandas' outer merge and unstable ``sort_values``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from hygeia_tpu_torch.pipeline.preprocess_bed import (
    _floats,
    _outer_merge,
    _read_rows,
    _savetxt_s,
    _take,
)

logger = logging.getLogger(__name__)


def read_gembs_sample(path, chromosome, sample_id):
    """The sample's (Pos0, non_conv, conv) columns on the chromosome's CG
    rows, or None where the JAX stage keeps NaN column slots (an empty
    slice or missing columns). Raises on an unreadable file."""
    rows = _read_rows(path, 0)
    header, rows = rows[0], rows[1:]
    col = {name: i for i, name in enumerate(header)}
    ci, ri = col["Contig"], col["Ref"]
    contig = f"chr{chromosome}"
    rows = [r for r in rows if r[ci] == contig and r[ri] == "CG"]
    if not rows:
        return None
    names = ["Pos0", f"{sample_id}:non_conv", f"{sample_id}:conv"]
    if any(c not in col for c in names):
        return None
    pos0 = np.array([int(r[col["Pos0"]]) for r in rows], np.int64)
    return pos0, [(c, _floats([r[col[c]] for r in rows])) for c in names[1:]]


def _merge(pos0, columns, sample):
    """pandas' outer merge of (Pos0, columns) with a sample on Pos0."""
    s_pos0, s_cols = sample
    li, ri = _outer_merge(pos0, s_pos0)
    pos0 = np.where(li >= 0, _take(pos0, li), _take(s_pos0, ri)).astype(np.int64)
    overlap = {name for name, _ in columns} & {name for name, _ in s_cols}
    left = [(n + "_x" if n in overlap else n, _take(c, li)) for n, c in columns]
    right = [(n + "_y" if n in overlap else n, _take(c, ri)) for n, c in s_cols]
    return pos0, left + right


def _nan_slot(columns, name, n):
    """``merged[name] = np.nan``: in place if the column exists, else last."""
    nan = np.full(n, np.nan)
    for i, (c, _) in enumerate(columns):
        if c == name:
            columns[i] = (name, nan)
            return
    columns.append((name, nan))


def process_gembs(
    cpg_file_path,
    output_path,
    chromosome,
    *,
    control_data_paths=(),
    control_id_names=(),
    case_data_paths=(),
    case_id_names=(),
):
    """Run the preprocessing; returns the number of CpG sites written."""
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)

    rows = _read_rows(cpg_file_path, 0)
    header, rows = rows[0], rows[1:]
    si, st = header.index("seqID"), header.index("start")
    starts = [int(r[st]) for r in rows if r[si] == f"chr{chromosome}"]
    if not starts:
        raise ValueError(f"No CpG sites found for chromosome {chromosome}")

    pos0 = np.asarray(starts, np.int64) - 1
    columns = []  # (name, float64 column), NaN where a sample has no row
    for paths, names in (
        (control_data_paths, control_id_names),
        (case_data_paths, case_id_names),
    ):
        for path, name in zip(paths, names):
            if not Path(path).exists():
                logger.error("gemBS sample file not found, skipping: %s", path)
                continue
            try:
                sample = read_gembs_sample(path, chromosome, name)
            except Exception as exc:
                logger.error("error processing gemBS sample %s: %s", name, exc)
                sample = None
            if sample is None:
                _nan_slot(columns, f"{name}:non_conv", pos0.size)
                _nan_slot(columns, f"{name}:conv", pos0.size)
                continue
            pos0, columns = _merge(pos0, columns, sample)
    order = pos0.argsort(kind="quicksort")
    positions = pos0[order]
    data = (
        np.nan_to_num(np.stack([c[order] for _, c in columns], axis=1))
        if columns
        else np.zeros((positions.size, 0))
    )

    n_control = len(control_id_names)
    n_case = len(case_id_names)
    empty = np.zeros((len(positions), 0))
    meth_control = total_control = meth_case = total_case = empty
    if n_control > 0:
        end = 2 * n_control
        if data.shape[1] >= end:
            meth_control = data[:, 0:end:2]
            total_control = meth_control + data[:, 1:end:2]
            if n_case > 0 and data.shape[1] > end:
                meth_case = data[:, end::2]
                total_case = meth_case + data[:, end + 1 :: 2]
    elif n_case > 0:
        meth_case = data[:, 0::2]
        total_case = meth_case + data[:, 1::2]

    files = {
        "positions": positions,
        "cpg_sites_merged": np.array([len(positions)]),
    }
    if meth_control.size > 0:
        files["n_methylated_reads_control"] = meth_control
        files["n_total_reads_control"] = total_control
    if meth_case.size > 0:
        files["n_methylated_reads_case"] = meth_case
        files["n_total_reads_case"] = total_case
    for name, arr in files.items():
        _savetxt_s(output_path / f"{name}_{chromosome}.txt.gz", arr)
    return len(positions)
