"""Chromosome segmentation: split a chromosome's CpG positions into
fixed-size segments of work.

Counterpart of hygeia_tpu/pipeline/segments.py, in numpy and the csv
module: num_segments = 1 + n_positions // segment_size (the trailing
partial segment always exists, even when n_positions is an exact multiple;
a batch with an out-of-range index exits cleanly downstream). The CSV is
the one pandas' ``to_csv(index=False)`` writes."""

from __future__ import annotations

import csv
import os

from hygeia_tpu_torch.utils import io as hio


def chrom_segments(n_positions: int, chromosome: str, segment_size: int):
    """{"chrom": [...], "segment_index": [...]}: one row a segment."""
    num_segments = 1 + n_positions // segment_size
    return {"chrom": [chromosome] * num_segments, "segment_index": list(range(num_segments))}


def write_segments_csv(path, segments):
    """The segments table as pandas' to_csv(index=False) writes it."""
    out_dir = os.path.dirname(str(path))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(segments))
        w.writerows(zip(*segments.values()))


def write_chrom_segments(input_file, chromosome, segment_size, output_csv):
    n_positions = len(hio.read_positions(input_file))
    segments = chrom_segments(n_positions, chromosome, segment_size)
    write_segments_csv(output_csv, segments)
    return segments
