"""The INFER runner's shared input and output stages on the CPU: where the
count check applies on each entry point, and what the meshed path writes
through the shared writers (its flags files' keys, its archives' zlib
level) against the monolithic path.

Fixture: a 330-site chromosome "c" (R = 6), segment 100 + halo 20, M = 2
(N = 96), B = 2, one seed.
"""

import zipfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hygeia_tpu_torch.two_group import runner
from hygeia_tpu_torch.utils import io as hio

torch.set_num_threads(1)

T = 330
BAD_ROW = 10  # in batch 0's window [0, 120), outside batch 1's [80, 220)


def _dataset(root, bad_row=None):
    rng = np.random.default_rng(4)
    data, sg = root / "data", root / "sg"
    n = rng.poisson(20, size=(T, 2))
    hio.write_count_matrix(data / "positions_c.txt.gz", np.arange(1, T + 1) * 10)
    for g, p in (("control", 0.8), ("case", 0.3)):
        y = rng.binomial(n, p)
        if bad_row is not None and g == "case":
            y[bad_row, 0] = n[bad_row, 0] + 1
        hio.write_count_matrix(data / f"n_total_reads_{g}_c.txt.gz", n)
        hio.write_count_matrix(data / f"n_methylated_reads_{g}_c.txt.gz", y)
    hio.write_theta(sg / "theta_c.csv.gz", rng.normal(size=36))
    return dict(data_dir=str(data), single_group_dir=str(sg), chrom="c", device="cpu", segment_size=100,
                buffer_size=20, num_resampled_particles=(2,), num_samples_backward=2)


@pytest.fixture(scope="module")
def bad(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("bad"), bad_row=BAD_ROW)


def test_infer_segment_checks_the_counts_of_its_window_only(bad, tmp_path):
    with pytest.raises(ValueError, match="methylated read counts exceed total read counts"):
        runner.infer_segment(results_dir=str(tmp_path / "b0"), batch=0, seed=0, **bad)
    log_z = runner.infer_segment(results_dir=str(tmp_path / "b1"), batch=1, seed=0, **bad)
    assert np.isfinite(log_z[96])
    assert runner.infer_segment(results_dir=str(tmp_path / "b9"), batch=9, seed=0, **bad) is None


@pytest.mark.parametrize("entry", ["streamed", "meshed"])
def test_whole_chromosome_paths_check_every_count(bad, tmp_path, entry):
    with pytest.raises(ValueError, match="methylated read counts exceed total read counts"):
        if entry == "streamed":
            runner.infer_chromosome_streamed(results_dir=str(tmp_path), seed=(0,), streaming_blocks=32, **bad)
        else:
            runner.infer_chromosome_meshed(results_dir=str(tmp_path), mesh_shape=(1, 1), seed=(0,), **bad)
    assert not (tmp_path / "chrom_c_0").exists()


def _compression(path):
    with zipfile.ZipFile(path) as z:
        return [i.compress_type for i in z.infolist()]


@pytest.mark.parametrize("boundary", ["halo", "exchange"])
def test_meshed_files_keep_their_flags_and_zlib_levels(tmp_path, boundary):
    """On a world of one gloo rank: every flags file lists the meshed
    path's keys in their order, with the batch and seed last; the
    trajectory archives are deflated (the JAX meshed path's level 1) where
    the monolithic path stores them; the split and regime archives are
    deflated on both."""
    kw = _dataset(tmp_path)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1, rank=0)
    try:
        runner.infer_chromosome_meshed(results_dir=str(tmp_path / "mesh"), mesh_shape=(2, 1), boundary=boundary,
                                       seed=(0,), **kw)
    finally:
        dist.destroy_process_group()
    runner.infer_segment(results_dir=str(tmp_path / "mono"), batch=1, seed=0, **kw)

    keys = ["chrom", "segment_size", "buffer_size", "mu", "sigma", "minimum_duration", "omega_case",
            "merge_log_prob", "split_prob", "num_resampled_particles", "num_samples_backward", "robust", "mesh",
            "boundary", "batch", "seed"]
    for batch in range(4):
        lines = (tmp_path / "mesh" / f"chrom_c_{batch}" / "flags0.txt").read_text().splitlines()
        assert [line[2:].split("=", 1)[0] for line in lines] == keys
        assert lines[-3:] == [f"--boundary={boundary}", f"--batch={batch}", "--seed=0"]
    for name in ("merged_state", "control_state", "case_state"):
        archive = f"optimal_backward_particles_{name}_96_0.npz"
        assert _compression(tmp_path / "mesh" / "chrom_c_1" / archive) == [zipfile.ZIP_DEFLATED]
        assert _compression(tmp_path / "mono" / "chrom_c_1" / archive) == [zipfile.ZIP_STORED]
    for name in ("split", "regime"):
        for run in ("mesh", "mono"):
            assert _compression(tmp_path / run / "chrom_c_1" / f"optimal_{name}_probs_96_0.npz") == [
                zipfile.ZIP_DEFLATED]
