"""The port's pipeline stages (hygeia_tpu_torch.pipeline: preprocess_bed,
segments, multiple_testing, aggregate, dmps), numpy ports of the JAX
package's pandas stages, against them on the same inputs: every file they
write equal byte for byte after decompression.

Inputs are made with numpy from a seed; the preprocess property test draws
BED records with hypothesis over strands, duplicated records (a key that
pandas' outer merge expands as a product), records off the CpG list, zero
coverage, missing sample files and products cov * pct / 100 that land on .5.
"""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from hygeia_tpu.pipeline import aggregate as j_aggregate
from hygeia_tpu.pipeline import dmps as j_dmps
from hygeia_tpu.pipeline import multiple_testing as j_mt
from hygeia_tpu.pipeline import preprocess_bed as j_pre
from hygeia_tpu.pipeline import segments as j_seg
from hygeia_tpu_torch.pipeline import aggregate as t_aggregate
from hygeia_tpu_torch.pipeline import dmps as t_dmps
from hygeia_tpu_torch.pipeline import multiple_testing as t_mt
from hygeia_tpu_torch.pipeline import preprocess_bed as t_pre
from hygeia_tpu_torch.pipeline import segments as t_seg
from tests.test_preprocess_property import _HEADER, _random_rows, _write_bed

REPO = Path(__file__).resolve().parent.parent


def _content(path):
    data = Path(path).read_bytes()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


def _assert_same_tree(a, b):
    """The same file names under a and b, each file's bytes equal after
    decompression."""
    names_a = sorted(p.relative_to(a) for p in Path(a).rglob("*") if p.is_file())
    names_b = sorted(p.relative_to(b) for p in Path(b).rglob("*") if p.is_file())
    assert names_a == names_b
    for name in names_a:
        assert _content(Path(a) / name) == _content(Path(b) / name), name


# -------------------------------------------------------------- preprocess ----

def _process_both(tmp_path, cpg, chromosome, groups):
    outs = []
    for mod in (j_pre, t_pre):
        out = tmp_path / mod.__name__.split(".")[0]
        mod.process_bed(cpg, out, chromosome, **groups)
        outs.append(out)
    _assert_same_tree(*outs)
    return outs


@pytest.mark.parametrize("trial", range(3))
def test_process_bed_byte_identical_on_the_property_fixtures(tmp_path, trial):
    """tests/test_preprocess_property.py's random fixtures: both strands,
    minus-only, zero coverage, .5 products, a site off the CpG list, noise
    on other chromosomes and genotypes; 2 control and 2 case samples."""
    rng = np.random.default_rng(100 + trial)
    cpg_starts = np.sort(rng.choice(np.arange(100, 5000), 40, replace=False))
    cpg = tmp_path / "cpg.tsv"
    pd.DataFrame({"seqID": "22", "start": cpg_starts}).to_csv(cpg, sep="\t", index=False)
    paths = []
    for i in range(4):
        p = tmp_path / f"s{i}.bed"
        _write_bed(p, _random_rows(rng, cpg_starts, "22"))
        paths.append(str(p))
    _process_both(tmp_path, cpg, "22", dict(
        control_data_paths=paths[:2], control_id_names=["c0", "c1"],
        case_data_paths=paths[2:], case_id_names=["k0", "k1"]))


def test_process_bed_byte_identical_on_the_cli_fixture(tmp_path):
    """tests/test_preprocess.py's fixture: a missing file in the middle of
    the control group keeps its slot."""
    cpg = tmp_path / "cpg.tsv"
    pd.DataFrame({"seqID": ["22", "22", "22", "21"], "start": [101, 201, 301, 50]}).to_csv(
        cpg, sep="\t", index=False)
    bed = tmp_path / "s1.bed"
    with open(bed, "w") as f:
        f.write("\t".join(_HEADER) + "\n")
        for r in (["22", 100, 101, "n", 0, "+", 0, 0, ".", 10, 50.0, "CG", "CG", 30],
                  ["22", 101, 102, "n", 0, "-", 0, 0, ".", 6, 100.0, "CG", "CG", 30],
                  ["22", 201, 202, "n", 0, "-", 0, 0, ".", 8, 25.0, "CG", "CG", 30],
                  ["21", 100, 101, "n", 0, "+", 0, 0, ".", 9, 10.0, "CG", "CG", 30],
                  ["22", 400, 401, "n", 0, "+", 0, 0, ".", 9, 10.0, "CA", "CA", 30]):
            f.write("\t".join(str(x) for x in r) + "\n")
    _process_both(tmp_path, cpg, "22", dict(
        control_data_paths=[str(bed), str(tmp_path / "missing.bed"), str(bed)],
        control_id_names=["a", "b", "c"], case_data_paths=[str(bed)], case_id_names=["d"]))


_record = st.tuples(
    st.integers(0, 12),  # 0-based position
    st.sampled_from(["+", "-", "+", "-", "."]),
    st.integers(1, 3),  # end - start: 1, or 2 and 3 (a + record whose end is not start + 1)
    st.sampled_from([0, 1, 2, 3, 6, 10]),
    st.sampled_from([0.0, 25.0, 50.0, 75.0, 100.0, 12.5, 33.3]),
    st.sampled_from(["CG", "CG", "CG", "CA"]),
    st.sampled_from(["7", "7", "7", "8"]),
)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(
    cpg=st.lists(st.integers(1, 14), min_size=1, max_size=10),
    samples=st.lists(st.one_of(st.none(), st.lists(_record, max_size=14)), min_size=1, max_size=4),
    n_control=st.integers(0, 4),
)
def test_process_bed_byte_identical_property(tmp_path_factory, cpg, samples, n_control):
    """Random records on a 15-site window, so keys repeat: duplicated CpG
    list entries and duplicated records on one strand (pandas' merges give
    the product of their rows, and its unstable sort orders the ties),
    records of both strands that overlap, missing samples (None)."""
    tmp = tmp_path_factory.mktemp("prop")
    (tmp / "cpg.tsv").write_text("seqID\tstart\n" + "".join(f"7\t{s}\n" for s in cpg))
    paths = []
    for i, recs in enumerate(samples):
        p = tmp / f"s{i}.bed"
        paths.append(str(p))
        if recs is None:
            continue
        with open(p, "w") as f:
            f.write("track\n")
            for pos, strand, span, cov, pct, geno, chrom in recs:
                f.write("\t".join(map(str, [chrom, pos, pos + span, "n", 0, strand, pos, pos + span, ".",
                                            cov, pct, geno, geno, 30])) + "\n")
    k = min(n_control, len(paths))
    names = [f"s{i}" for i in range(len(paths))]
    _process_both(tmp, tmp / "cpg.tsv", "7", dict(
        control_data_paths=paths[:k], control_id_names=names[:k],
        case_data_paths=paths[k:], case_id_names=names[k:]))


# ------------------------------------------------- segments and FDR rules ----

@pytest.mark.parametrize("n_positions,segment_size", [(13000, 6000), (12000, 6000), (5, 100000)])
def test_chrom_segments_identical(tmp_path, n_positions, segment_size):
    from hygeia_tpu.utils import io as hio

    hio.write_count_matrix(tmp_path / "pos.txt.gz", np.arange(n_positions))
    j_seg.write_chrom_segments(tmp_path / "pos.txt.gz", "chr3", segment_size, tmp_path / "j.csv")
    t_seg.write_chrom_segments(tmp_path / "pos.txt.gz", "chr3", segment_size, tmp_path / "t.csv")
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()


def test_fdr_procedures_identical():
    rng = np.random.default_rng(3)
    for trial in range(20):
        n = int(rng.integers(1, 300))
        stats = np.where(rng.random(n) < 0.3, rng.random(n) * 0.05, rng.random(n))
        w_fn = rng.uniform(1e-4, 1.0, n)
        for thr in (0.0, 0.01, 0.05, 0.5, 1.0):
            assert repr(j_mt.fdr_procedure(stats, thr)) == repr(t_mt.fdr_procedure(stats, thr))
            a, b = j_mt.weighted_fdr_procedure(stats, thr, np.ones(n), w_fn), \
                t_mt.weighted_fdr_procedure(stats, thr, np.ones(n), w_fn)
            np.testing.assert_array_equal(a[0], b[0])
            assert repr(a[1]) == repr(b[1])


# --------------------------------------------------------------- aggregate ----

N_PART, B = 24, 4  # the archives' particle count in their names; trajectories per seed


def _write_units(root, chrom, lengths, seeds, rng, R=6, constant_case=False, skip=()):
    """Seeded INFER unit archives and trimmed inputs, as infer_segment
    writes them, for batches of the given lengths (0: an empty batch)."""
    from hygeia_tpu.utils import io as hio

    start = 1000
    for batch, T in enumerate(lengths):
        d = root / f"chrom_{chrom}_{batch}"
        d.mkdir(parents=True)
        pos = start + np.cumsum(rng.integers(1, 300, size=T))
        start = int(pos[-1]) if T else start
        hio.write_count_matrix(d / "positions.csv.gz", pos)
        for name in ("n_total_reads_control", "n_total_reads_case", "observations_control", "observations_case"):
            hio.write_count_matrix(d / f"{name}.csv.gz", rng.integers(0, 40, size=(T, 2)).astype(np.int16))
        if batch in skip:
            continue  # a unit that failed: inputs written, no archives
        for s in range(seeds):
            np.savez_compressed(d / f"optimal_backward_particles_merged_state_{N_PART}_{s}.npz",
                                rng.integers(0, 2, size=(T, B)).astype(np.int16))
            for kind in ("control", "case"):
                reg = rng.integers(0, R, size=(T, B))
                if constant_case and kind == "case":
                    reg[:] = 2
                traj = np.stack([rng.integers(1, 500, size=(T, B)), reg], axis=-1).astype(np.int32)
                np.savez_compressed(d / f"optimal_backward_particles_{kind}_state_{N_PART}_{s}.npz", traj)


def _aggregate_both(tmp_path, res, **kw):
    outs = []
    for mod in (j_aggregate, t_aggregate):
        out = tmp_path / f"agg_{mod.__name__.split('.')[0]}"
        n = mod.aggregate_chromosome(str(res), str(out), "c", num_particles=N_PART, **kw)
        outs.append((out, n))
    assert outs[0][1] == outs[1][1]
    _assert_same_tree(outs[0][0], outs[1][0])
    return outs[1][0]


@pytest.mark.parametrize("case", ["freqs", "constant_case_freqs", "empty_trailing_batch"])
def test_aggregate_byte_identical(tmp_path, case):
    rng = np.random.default_rng(7)
    res = tmp_path / "res"
    lengths = (37, 41, 0) if case == "empty_trailing_batch" else (37, 41, 12)
    _write_units(res, "c", lengths, 2, rng, constant_case=case == "constant_case_freqs")
    out = _aggregate_both(tmp_path, res, seeds=2, num_batches=3, compute_freqs=case != "empty_trailing_batch")
    rows = gzip.decompress((out / "merge_states_chrom_c.csv.gz").read_bytes()).decode().splitlines()
    assert rows[0] == "pos\t" + "\t".join(str(i) for i in range(2 * B))
    assert len(rows) == 1 + sum(lengths)


def test_aggregate_skip_missing_byte_identical(tmp_path):
    """A unit with inputs but no archives (failed after its retries) and an
    absent batch directory: skipped with skip_missing; without it the
    reference stops at the absent directory."""
    rng = np.random.default_rng(8)
    res = tmp_path / "res"
    _write_units(res, "c", (30, 25, 20, 18), 2, rng, skip=(1,))
    import shutil

    shutil.rmtree(res / "chrom_c_2")
    _aggregate_both(tmp_path / "skip", res, seeds=2, num_batches=4, skip_missing=True, compute_freqs=True)
    _aggregate_both(tmp_path / "stop", res / ".." / "res", seeds=2, num_batches=1)


def test_aggregate_no_batch_raises_like_jax(tmp_path):
    rng = np.random.default_rng(9)
    res = tmp_path / "res"
    _write_units(res, "c", (20,), 1, rng, skip=(0,))
    for mod in (j_aggregate, t_aggregate):
        with pytest.raises(FileNotFoundError, match="no batch outputs"):
            mod.aggregate_chromosome(str(res), str(tmp_path / "o"), "c", seeds=1, num_particles=N_PART,
                                     num_batches=1, skip_missing=True)
        with pytest.raises(FileNotFoundError, match="no batch outputs"):
            mod.aggregate_chromosome(str(tmp_path / "none"), str(tmp_path / "o"), "c", seeds=1,
                                     num_particles=N_PART, num_batches=2)


# -------------------------------------------------------------------- DMPs ----

@pytest.mark.parametrize("combinations", [False, True])
def test_call_dmps_byte_identical(tmp_path, combinations):
    """On aggregate tables whose case regimes depart from the control's in
    planted windows (so both FDR rules select sites), at the default and
    a loose threshold."""
    rng = np.random.default_rng(11)
    res = tmp_path / "res"
    _write_units(res, "c", (60, 50), 2, rng, R=3)
    agg = tmp_path / "agg"
    t_aggregate.aggregate_chromosome(str(res), str(agg), "c", seeds=2, num_particles=N_PART, num_batches=2)
    # Rewrite the case regimes: equal to the control's outside two windows.
    from hygeia_tpu_torch.utils import io as tio

    header, index, ctrl = tio.read_int_table(agg / "control_regimes_chrom_c.csv.gz")
    case = ctrl.copy()
    case[10:25] = (ctrl[10:25] + 1) % 3
    case[70:80, : B] = (ctrl[70:80, : B] + 2) % 3
    tio.write_int_table(agg / "case_regimes_chrom_c.csv.gz", case, index=index, header="\t".join(header))
    outs = []
    for mod in (j_dmps, t_dmps):
        out = tmp_path / f"dmp_{mod.__name__.split('.')[0]}"
        mod.call_dmps(str(agg), str(out), "c", n_regimes=3, fdr_thresholds=(0.01, 0.05, 0.3),
                      test_regime_combinations=combinations)
        outs.append(out)
    _assert_same_tree(*outs)
    assert len(pd.read_csv(outs[1] / "weighted_dmp_0.05.csv")) > 0


def test_jax_aggregate_reads_the_port_infer_outputs(tmp_path):
    """The port's infer_segment writes a chromosome's three batches (two
    seeds); the JAX package's aggregate reads them and writes what the
    port's aggregate writes, frequency tables included."""
    from hygeia_tpu_torch.two_group.runner import infer_segment
    from tests.test_torch_streaming import BB, MM, MU, NN, SIGMA, _write_chromosome

    data, sg = _write_chromosome(tmp_path, "c", 200, 4)
    res = tmp_path / "res"
    for batch in range(3):
        infer_segment(data_dir=str(data), single_group_dir=str(sg), results_dir=str(res), chrom="c",
                      device="cpu", batch=batch, seed=[0, 1], segment_size=70, buffer_size=10, mu=MU,
                      sigma=SIGMA, num_resampled_particles=(MM,), num_samples_backward=BB)
    outs = []
    for mod in (j_aggregate, t_aggregate):
        out = tmp_path / mod.__name__.split(".")[0]
        mod.aggregate_chromosome(str(res), str(out), "c", seeds=2, num_particles=NN, num_batches=3,
                                 compute_freqs=True)
        outs.append(out)
    _assert_same_tree(*outs)
    rows = gzip.decompress((outs[1] / "control_regimes_chrom_c.csv.gz").read_bytes()).decode().splitlines()
    assert len(rows) == 1 + 200 and rows[0].count("\t") == 2 * BB


def test_new_verbs_import_neither_jax_nor_pandas(tmp_path):
    """preprocess, get_chrom_segments, aggregate, get_dmps and a stub run
    through the port's CLI in a fresh interpreter, with the modules of
    this slice imported; then sys.modules holds no jax, pandas or
    hygeia_tpu."""
    import chip_smoke

    cpg, c, k, _, _ = chip_smoke.make_bed_dataset(str(tmp_path / "bed"), 300, n_dmr=1, dmr_len=60)
    rng = np.random.default_rng(1)
    _write_units(tmp_path / "res", "c", (40,), 1, rng, R=3)
    pre, agg = tmp_path / "pre", tmp_path / "agg"
    calls = [
        ["preprocess", "--cpg_file_path", cpg, "--output_path", str(pre), "--chromosome", "3",
         "--control_data_path", c[0], "--case_data_path", k[0]],
        ["get_chrom_segments", "--input_file", str(pre / "positions_3.txt.gz"), "--chromosome", "3",
         "--segment_size", "100", "--output_csv", str(tmp_path / "seg.csv")],
        ["aggregate", "--results_dir", str(tmp_path / "res"), "--output_dir", str(agg), "--chrom", "c",
         "--seeds", "1", "--num_batches", "1", "--num_particles", str(N_PART), "--compute_freqs"],
        ["get_dmps", "--results_dir", str(agg), "--output_dir", str(tmp_path / "dmp"), "--chrom", "c",
         "--n_regimes", "3", "--test_regime_combinations"],
        ["run", "--two_group", "--stub_run", "--output_dir", str(tmp_path / "stub"), "--chroms", "3"],
    ]
    code = (
        "import sys\n"
        "import hygeia_tpu_torch.cli as c\n"
        "import hygeia_tpu_torch.pipeline.orchestrator, hygeia_tpu_torch.single_group.blocked\n"
        "import hygeia_tpu_torch.single_group.theta_config, hygeia_tpu_torch.ops.emissions\n"
        f"for argv in {calls!r}:\n"
        "    c.main(argv)\n"
        "bad = [m for m in ('jax', 'pandas', 'hygeia_tpu') if m in sys.modules]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "dmp" / "dmp_0_1_0.05.csv").exists() and (pre / "positions_3.txt.gz").exists()
