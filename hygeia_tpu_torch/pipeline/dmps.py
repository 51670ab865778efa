"""DMP (differentially methylated position) calling under FDR control.

Counterpart of hygeia_tpu/pipeline/dmps.py, in numpy; the CSVs equal the
JAX stage's byte for byte. The test statistic per site is the posterior
probability of the null, 1 - (1/B) #{backward particles with control regime
!= case regime}; sites are selected with the plain and weighted FDR
procedures at each threshold, with per-regime METEOR frequency columns and
position-gap false-negative weights w_fn = 1 / (mean of the 1-, 2- and
3-lag position differences), 1e-5 where a lag is missing. ``dmp_{thr}``
and ``weighted_dmp_{thr}`` print floats with "%.4f", the regime-combination
files by their repr, as pandas' to_csv does with and without
``float_format``."""

from __future__ import annotations

import csv
import io
import os

import numpy as np

from hygeia_tpu_torch.pipeline.multiple_testing import fdr_procedure, weighted_fdr_procedure
from hygeia_tpu_torch.utils import io as hio


def _regime_freqs(regimes, rows, n_regimes):
    freqs = np.zeros((len(rows), n_regimes))
    for i, row in enumerate(regimes[rows]):
        freqs[i] = np.bincount(row, minlength=n_regimes) / row.shape[0]
    return freqs


def _float_text(values, float_format):
    """Cells of a float64 column as pandas' to_csv formats them."""
    v = np.asarray(values, np.float64)
    if float_format is None:
        return [repr(x) for x in v.tolist()]
    return [float_format % x for x in v.tolist()]


def _write_csv(path, columns, float_format=None):
    """{name: ("float" | "raw", values)} as pandas' to_csv(index=False)."""
    cells = []
    for kind, values in columns.values():
        cells.append(_float_text(values, float_format) if kind == "float" else [str(x) for x in values])
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(list(columns))
    w.writerows(zip(*cells))
    with open(path, "w") as f:
        f.write(buf.getvalue())


def call_dmps(
    results_dir,
    output_dir,
    chrom,
    *,
    n_regimes=6,
    fdr_thresholds=(0.01, 0.05),
    test_regime_combinations=False,
):
    os.makedirs(output_dir, exist_ok=True)
    _, _, ctrl = hio.read_int_table(os.path.join(results_dir, f"control_regimes_chrom_{chrom}.csv.gz"))
    _, _, case = hio.read_int_table(os.path.join(results_dir, f"case_regimes_chrom_{chrom}.csv.gz"))
    num_particles = ctrl.shape[-1]
    # Posterior probability of the null (same regime in both groups).
    null_stats = 1.0 - np.sum(ctrl != case, axis=1) / num_particles

    text = hio._read_text(os.path.join(results_dir, f"split_probs_{chrom}.csv.gz")).decode()
    pos = np.array([ln.split("\t")[0] for ln in text.splitlines()[1:] if ln.strip()], np.int64)
    # Mean of the 1-, 2- and 3-lag position gaps, NaN where a lag is missing.
    lag = [np.concatenate([np.full(min(k, pos.size), np.nan), (pos[k:] - pos[:-k]).astype(np.float64)])
           for k in (1, 2, 3)]
    gaps = (lag[0] + lag[1] + lag[2]) / 3.0
    w_fp = np.ones(pos.size)
    w_fn = 1.0 / np.where(np.isnan(gaps), 1e5, gaps)

    def _frame(rows, stats, fn_weights):
        cols = {
            "chrom": ("raw", [chrom] * len(rows)),
            "position": ("raw", pos[rows].tolist()),
            "null_stats": ("float", stats),
            "false_negative_weight": ("float", np.broadcast_to(fn_weights, (len(rows),))),
        }
        for prefix, regimes in (("Control", ctrl), ("Case", case)):
            f = _regime_freqs(regimes, rows, n_regimes)
            for i in range(n_regimes):
                cols[f"{prefix}_METEOR_{i + 1}"] = ("float", f[:, i])
        return cols

    for thr in fdr_thresholds:
        _, _, cutoff = fdr_procedure(null_stats, thr)
        rows = np.flatnonzero(null_stats < cutoff)
        _write_csv(os.path.join(output_dir, f"dmp_{thr}.csv"), _frame(rows, null_stats[rows], 1.0), "%.4f")

        w_rows, _ = weighted_fdr_procedure(null_stats, thr, w_fp, w_fn)
        w_rows = np.sort(w_rows)
        _write_csv(os.path.join(output_dir, f"weighted_dmp_{thr}.csv"),
                   _frame(w_rows, null_stats[w_rows], w_fn[w_rows]), "%.4f")

        if test_regime_combinations:
            for i in range(n_regimes):
                for j in range(n_regimes):
                    if i == j:
                        continue
                    stats_ij = 1.0 - np.sum((ctrl == i) & (case == j), axis=1) / num_particles
                    _, _, cut_ij = fdr_procedure(stats_ij, thr)
                    rows_ij = np.flatnonzero(stats_ij < cut_ij)
                    _write_csv(os.path.join(output_dir, f"dmp_{i}_{j}_{thr}.csv"), {
                        "chrom": ("raw", [chrom] * len(rows_ij)),
                        "position": ("raw", pos[rows_ij].tolist()),
                        "null_stats": ("float", stats_ij[rows_ij]),
                        "false_negative_weight": ("float", np.ones(len(rows_ij))),
                    })
                    wr, _ = weighted_fdr_procedure(stats_ij, thr, w_fp, w_fn)
                    wr = np.sort(wr)
                    _write_csv(os.path.join(output_dir, f"weighted_dmp_{i}_{j}_{thr}.csv"), {
                        "chrom": ("raw", [chrom] * len(wr)),
                        "position": ("raw", pos[wr].tolist()),
                        "null_stats": ("float", stats_ij[wr]),
                        "false_negative_weight": ("float", w_fn[wr]),
                    })
