"""The port's work-dir mirror (hygeia_tpu_torch.utils.staging) against the
JAX package's, and ``run --bucket_dir`` on the CPU: the two-group run and
the single-group run from a sample sheet, each wiped and resumed from its
bucket; plain paths with the ``fsspec`` import blocked."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from hygeia_tpu.utils import io as hio
from hygeia_tpu.utils.staging import WorkdirMirror as JaxMirror
from hygeia_tpu_torch import cli as torch_cli
from hygeia_tpu_torch.utils.staging import WorkdirMirror

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _tree(root):
    """A run tree: two finished stages (markers, a per-chromosome marker),
    one unfinished, a file at the root."""
    root = Path(root)
    for rel, data in (("1_PREPROCESS/3/a.txt", b"alpha"), ("1_PREPROCESS/3/.done", b"{}"),
                      ("2_STAGE/3/b.txt", b"bravo!"), ("2_STAGE/3/sub/c.bin", bytes(range(50))),
                      ("4_OUT/s0/.done_3", b"{}"), ("4_OUT/s0/x.bed.gz", b"xray"),
                      ("3_UNFINISHED/3/d.txt", b"delta"), ("trace.tsv", b"t\n")):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
    return root


@pytest.mark.parametrize("url_form", ["plain", "file"])
def test_mirror_matches_the_jax_mirror(tmp_path, url_form):
    """Both mirrors upload the same files and bytes, upload nothing on a
    second sync and only the changed file on a third, and restore a tree
    the same way: a stale file of equal size in a stage without a local
    marker is fetched again, one in a marked stage is kept, a missing one
    is fetched."""
    def url(p):
        return str(p) if url_form == "plain" else f"file://{p}"

    out = {}
    for name, cls in (("jax", JaxMirror), ("torch", WorkdirMirror)):
        root = _tree(tmp_path / name / "run")
        m = cls(url(tmp_path / name / "bucket"))
        assert m.sync_up(root) == 8 and m.sync_up(root) == 0
        (root / "2_STAGE/3/b.txt").write_bytes(b"BRAVO!!")  # changed: uploaded again
        assert m.sync_up(root) == 1
        bucket = _files(tmp_path / name / "bucket")
        # Stale equal-size files in a finished and an unfinished stage, one file gone.
        (root / "1_PREPROCESS/3/a.txt").write_bytes(b"ALPHA")  # finished stage: kept
        (root / "3_UNFINISHED/3/d.txt").write_bytes(b"DELTA")  # no marker: fetched
        (root / "2_STAGE/3/sub/c.bin").unlink()
        fetched = cls(url(tmp_path / name / "bucket")).restore(root)
        out[name] = (bucket, fetched, _files(root))
    assert out["jax"] == out["torch"]
    bucket, fetched, restored = out["torch"]
    assert bucket["2_STAGE/3/b.txt"] == b"BRAVO!!" and fetched == 4
    assert restored["1_PREPROCESS/3/a.txt"] == b"ALPHA" and restored["3_UNFINISHED/3/d.txt"] == b"delta"


def test_restore_from_a_missing_bucket_fetches_nothing(tmp_path):
    assert WorkdirMirror(tmp_path / "nowhere").restore(tmp_path / "run") == 0
    assert not (tmp_path / "run").exists()


def test_plain_paths_need_no_fsspec_and_other_schemes_raise(tmp_path):
    """With ``import fsspec`` failing, a plain path and file:// mirror and
    restore; an s3:// URL raises and names its scheme."""
    root = _tree(tmp_path / "run")
    code = (
        "import sys; sys.modules['fsspec'] = None\n"
        "from hygeia_tpu_torch.utils.staging import WorkdirMirror\n"
        f"root = {str(root)!r}\n"
        f"assert WorkdirMirror({str(tmp_path / 'b1')!r}).sync_up(root) == 8\n"
        f"assert WorkdirMirror('file://' + {str(tmp_path / 'b2')!r}).sync_up(root) == 8\n"
        f"assert WorkdirMirror({str(tmp_path / 'b1')!r}).restore({str(tmp_path / 'new')!r}) == 8\n"
        "try:\n"
        "    WorkdirMirror('s3://bucket/run')\n"
        "except RuntimeError as e:\n"
        "    assert 's3://' in str(e) and 'fsspec' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('s3:// did not raise')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _files(tmp_path / "new") == _files(root)


def _resume_from_bucket(argv, out, bucket):
    """Run, wipe the output tree, run again: returns (first files, second
    files, second trace rows) without the run-report files."""
    keep = lambda files: {k: v for k, v in files.items() if not k.endswith((".tsv", ".html", ".yml", ".dot"))}
    torch_cli.main(argv)
    first = keep(_files(out))
    assert keep(_files(bucket)) == first  # every stage's outputs and markers
    shutil.rmtree(out)
    torch_cli.main(argv)
    rows = [r.split("\t") for r in (out / "trace.tsv").read_text().splitlines()[1:]]
    return first, keep(_files(out)), rows


def test_run_two_group_bucket_dir_restores_and_skips(tmp_path):
    """The JAX package's test_run_two_group_bucket_dir_staging on the port:
    a wiped tree is restored from the bucket, a BUCKET_RESTORE row counts
    the files, every stage is skipped and the DMP files are the first
    run's."""
    rng = np.random.default_rng(3)
    T, S = 100, 1
    n = rng.poisson(25, size=(T, S)).astype(float)
    y = np.minimum(rng.poisson(8, size=(T, S)), n)
    pre = tmp_path / "pre"
    pre.mkdir()
    hio.write_count_matrix(pre / "positions_cb.txt.gz", np.arange(1, T + 1) * 13)
    hio.write_count_matrix(pre / "n_total_reads_control_cb.txt.gz", n)
    hio.write_count_matrix(pre / "n_total_reads_case_cb.txt.gz", n)
    hio.write_count_matrix(pre / "n_methylated_reads_control_cb.txt.gz", y)
    hio.write_count_matrix(pre / "n_methylated_reads_case_cb.txt.gz", np.minimum(y + 4, n))
    out, bucket = tmp_path / "out", tmp_path / "bucket"
    argv = ["run", "--two_group", "--output_dir", str(out), "--chroms", "cb", "--preprocessed_dir", str(pre),
            "--batch_size", "100", "--buffer_size", "10", "--num_of_inference_seeds", "1",
            "--num_resampled_particles", "6", "--num_samples_backward", "8", "--n_particles", "30",
            "--bucket_dir", f"file://{bucket}", "--device", "cpu"]
    first, second, rows = _resume_from_bucket(argv, out, bucket)
    assert (bucket / "6_GET_DMPS" / "cb" / "dmp_0.05.csv").exists()
    assert (bucket / "6_GET_DMPS" / "cb" / ".done").exists()
    assert rows[0][0] == "BUCKET_RESTORE" and rows[0][5] == f"{len(first)} files"
    assert len(rows) > 1 and all(r[3] == "True" for r in rows[1:]), rows
    assert second == first


def test_run_single_group_bucket_dir_restores_and_skips(tmp_path):
    """The single-group run from a sample sheet: its last stage (the BED
    files, marked per chromosome) is mirrored too, so a wiped tree is
    restored and every stage skipped."""
    cpg, controls, _cases, _dmr, _pos = chip_smoke.make_bed_dataset(str(tmp_path / "bed"), 200, seed=2, chrom="3",
                                                                    n_dmr=1, dmr_len=40)
    sheet = tmp_path / "samples.csv"
    sheet.write_text("id,file\n" + "".join(f"s{i},{p}\n" for i, p in enumerate(controls)))
    out, bucket = tmp_path / "out", tmp_path / "bucket"
    argv = ["run", "--chroms", "3", "--cpg_file_path", cpg, "--sample_sheet", str(sheet), "--n_particles", "30",
            "--output_dir", str(out), "--bucket_dir", str(bucket), "--device", "cpu"]
    first, second, rows = _resume_from_bucket(argv, out, bucket)
    assert "4_SINGLE_GROUP_OUTPUT/s1/s1_regimes_3.bed.gz.tbi" in first
    assert rows[0][0] == "BUCKET_RESTORE" and rows[0][5] == f"{len(first)} files"
    assert len(rows) == 1 + 2 * 4 and all(r[3] == "True" for r in rows[1:]), rows
    assert second == first
    assert json.loads((out / "4_SINGLE_GROUP_OUTPUT/s0/.done_3").read_text())["t"] > 0
    assert os.path.getsize(out / "4_SINGLE_GROUP_OUTPUT/s0/s0_regimes_3.bed.gz") > 0
