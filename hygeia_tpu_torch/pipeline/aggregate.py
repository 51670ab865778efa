"""Aggregate per-(batch, seed) inference outputs into per-chromosome tables.

Counterpart of hygeia_tpu/pipeline/aggregate.py, in numpy: walks the
``chrom_{chrom}_{batch}`` result directories, concatenates the backward
trajectories across seeds (along the particle axis) and batches (along the
genome), and writes the per-chromosome tables with the reference's names
and layout (tab-separated, a ``pos`` index column, gzip). The files equal
the JAX stage's byte for byte after decompression, ``split_probs`` (pandas'
``Series.to_csv`` of a float64 mean) and the ``--compute_freqs`` tables
(pandas' row-wise ``value_counts(normalize=True)``) included. The integer
tables go through utils/io's vectorised formatter."""

from __future__ import annotations

import os

import numpy as np

from hygeia_tpu_torch.utils import io as hio

_COUNT_FILES = (
    ("n_tot_ctrl", "n_total_reads_control.csv.gz", "n_total_reads_control_chrom_{}.csv.gz"),
    ("n_tot_case", "n_total_reads_case.csv.gz", "n_total_reads_case_chrom_{}.csv.gz"),
    ("obs_ctrl", "observations_control.csv.gz", "n_meth_reads_control_chrom_{}.csv.gz"),
    ("obs_case", "observations_case.csv.gz", "n_meth_reads_case_chrom_{}.csv.gz"),
)


def _archive(data_dir, kind, N, seed):
    return os.path.join(data_dir, f"optimal_backward_particles_{kind}_state_{N}_{seed}.npz")


def _load(path):
    with np.load(path) as z:
        return z["arr_0"]


def _value_counts_order(row_values, counts):
    """The index order of pandas' value_counts() of one row: counts
    descending through Series.sort_values (numpy's argsort(kind=
    "quicksort") of the reversed counts, reversed), the values in order of
    first appearance before it."""
    c = np.asarray(counts, np.int64)[::-1]
    v = np.asarray(row_values)[::-1]
    return v[c.argsort(kind="quicksort")][::-1]


def _freq_table(regimes):
    """(column values, (n, k) float64 with NaN) of pandas'
    ``df.apply(lambda x: x.value_counts(normalize=True), axis=1)``: a
    column per regime value seen, in the rows' common value_counts order
    when every row has the same one, else ascending."""
    n, B = regimes.shape
    values = np.unique(regimes)
    counts = np.stack([(regimes == v).sum(axis=1) for v in values], axis=1)  # (n, V)
    present = counts > 0
    # Each row's distinct values in order of first appearance.
    first = np.stack([np.where((regimes == v).any(axis=1), (regimes == v).argmax(axis=1), B)
                      for v in values], axis=1)
    same_order = False
    if n and (present == present[:1]).all():
        cols = np.flatnonzero(present[0])
        pattern = np.concatenate([first[:, cols], counts[:, cols]], axis=1)
        uniq = np.unique(pattern, axis=0)
        orders = set()
        for p in uniq:
            seen = np.argsort(p[: cols.size], kind="stable")
            orders.add(tuple(_value_counts_order(values[cols][seen], p[cols.size :][seen])))
        if len(orders) == 1:
            order = np.asarray(orders.pop())
            same_order = True
    if not same_order:
        order = values[present.any(axis=0)]
    idx = np.searchsorted(values, order)
    freq = np.where(present[:, idx], counts[:, idx] / B, np.nan)
    return order, freq


def _write_freqs(path, index, regimes):
    cols, freq = _freq_table(regimes)
    B = regimes.shape[1]
    text = {k: repr(k / B) for k in range(B + 1)}
    cells = np.full(freq.shape, "", dtype=object)
    hit = ~np.isnan(freq)
    cells[hit] = [text[int(round(f * B))] if f == int(round(f * B)) / B else repr(float(f))
                  for f in freq[hit]]
    lines = ["pos\t" + "\t".join(str(c) for c in cols)]
    lines += [f"{p}\t" + "\t".join(row) for p, row in zip(index.tolist(), cells.tolist())]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def aggregate_chromosome(
    results_dir,
    output_dir,
    chrom,
    *,
    seeds,
    num_particles,
    num_batches,
    compute_freqs=False,
    skip_missing=False,
):
    """skip_missing=False reproduces the reference: it stops at the first
    absent batch directory. skip_missing=True keeps going, so that one INFER
    unit that failed after all retries does not drop every later batch;
    completion is then keyed on the trajectory archives (a unit that died
    mid-compute leaves its early input CSVs without them). A zero-site batch
    (the trailing one when the length is a multiple of the segment size) is
    skipped in both modes. Raises FileNotFoundError when no batch was read.
    Returns the number of batches read."""
    os.makedirs(output_dir, exist_ok=True)
    N = num_particles
    parts = {k: [] for k in ("positions", "merged", "ctrl", "case", "n_tot_ctrl", "n_tot_case",
                             "obs_ctrl", "obs_case")}
    processed = 0
    for batch in range(num_batches):
        data_dir = os.path.join(results_dir, f"chrom_{chrom}_{batch}")
        pos_file = os.path.join(data_dir, "positions.csv.gz")
        if not os.path.isfile(pos_file):
            if skip_missing:
                continue
            break
        if skip_missing and not all(os.path.isfile(_archive(data_dir, kind, N, s))
                                    for s in range(seeds) for kind in ("merged", "control", "case")):
            continue
        positions = hio.read_count_matrix(pos_file, np.int64)
        if positions.size == 0:
            continue
        parts["positions"].append(positions[:, 0])
        parts["merged"].append(np.concatenate(
            [_load(_archive(data_dir, "merged", N, s)) for s in range(seeds)], axis=-1))
        parts["ctrl"].append(np.concatenate(
            [_load(_archive(data_dir, "control", N, s)) for s in range(seeds)], axis=1))
        parts["case"].append(np.concatenate(
            [_load(_archive(data_dir, "case", N, s)) for s in range(seeds)], axis=1))
        for key, fname, _ in _COUNT_FILES:
            parts[key].append(hio.read_count_matrix(os.path.join(data_dir, fname), np.int16))
        processed += 1

    if processed == 0:
        raise FileNotFoundError(f"no batch outputs found under {results_dir} for chrom {chrom}")

    index = np.concatenate(parts["positions"]).astype(np.int32)
    merged = np.concatenate(parts["merged"]).astype(np.int8)
    ctrl, case = np.concatenate(parts["ctrl"]), np.concatenate(parts["case"])
    ctrl_regimes, case_regimes = ctrl[:, :, 1].astype(np.int8), case[:, :, 1].astype(np.int8)

    def _write(values, name):
        header = "pos\t" + "\t".join(str(c) for c in range(values.shape[1]))
        hio.write_int_table(os.path.join(output_dir, name), values, index=index, header=header)

    _write(ctrl_regimes, f"control_regimes_chrom_{chrom}.csv.gz")
    _write(case_regimes, f"case_regimes_chrom_{chrom}.csv.gz")
    _write(merged, f"merge_states_chrom_{chrom}.csv.gz")
    split = np.count_nonzero(merged == 0, axis=1) / merged.shape[1]
    lines = ["pos\t0"] + [f"{p}\t{v!r}" for p, v in zip(index.tolist(), split.tolist())]
    hio._write_text(os.path.join(output_dir, f"split_probs_{chrom}.csv.gz"), "\n".join(lines) + "\n")
    for key, _, out_name in _COUNT_FILES:
        _write(np.concatenate(parts[key]), out_name.format(chrom))
    _write(ctrl[:, :, 0].astype(np.int32), f"control_durations_chrom_{chrom}.csv.gz")
    _write(case[:, :, 0].astype(np.int32), f"case_durations_chrom_{chrom}.csv.gz")

    if compute_freqs:
        for regimes, name in ((case_regimes, f"case_regimes_freq_{chrom}.csv"),
                              (ctrl_regimes, f"control_regimes_freq_{chrom}.csv")):
            _write_freqs(os.path.join(output_dir, name), index, regimes)
    return processed
