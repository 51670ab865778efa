"""The port's single-group pipeline against the JAX package's on the CPU:
bgzf and tabix, ``make_bed`` (``make_bed_file``), ``process_gembs``
(``preprocess --format gembs``), and ``run`` without ``--two_group``
(``run_single_group``: its stub tree, its stage tree and resume, its
batched passes).

Files written by both packages must be equal byte for byte (after
decompression for the gzipped count tables). The engine passes are
sampled, so the port's regime probabilities are compared with the JAX
package's from the same theta file within a Monte Carlo bound: mean
absolute difference below 0.05, and the most probable regime the same on
at least 90% of the sites where both packages give it more than 0.9
(N = 250 particles, 2 x 30 reads a site).
"""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from hygeia_tpu.cli import main as jax_cli
from hygeia_tpu.pipeline import bed as jbed
from hygeia_tpu.pipeline import orchestrator as jorch
from hygeia_tpu.pipeline.preprocess_gembs import process_gembs as j_gembs
from hygeia_tpu.utils import bgzf as jbgzf
from hygeia_tpu.utils import io as jio
from hygeia_tpu.utils import tabix as jtabix
from hygeia_tpu_torch import cli as torch_cli
from hygeia_tpu_torch.pipeline import bed as tbed
from hygeia_tpu_torch.pipeline import orchestrator as torch_orch
from hygeia_tpu_torch.pipeline.preprocess_gembs import process_gembs as t_gembs
from hygeia_tpu_torch.utils import bgzf as tbgzf
from hygeia_tpu_torch.utils import io as tio
from hygeia_tpu_torch.utils import tabix as ttabix

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SG_MU = [0.99, 0.01, 0.80, 0.20, 0.50, 0.50]
SG_SIGMA = [0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751]


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def _same_bytes(a, b):
    assert Path(a).read_bytes() == Path(b).read_bytes(), (a, b)


# ------------------------------------------------------------ bgzf, tabix ----

@pytest.mark.parametrize("payload", ["multiblock", "boundary", "empty"])
def test_bgzf_bytes_equal_jax(tmp_path, payload):
    """compress_file and BgzfWriter write the JAX module's bytes; the port's
    reader reads back the lines (the cases of tests/test_bgzf_tabix.py)."""
    rng = np.random.default_rng(0)
    if payload == "multiblock":
        lines = [f"line{i}\t{rng.integers(1 << 30)}\t{'x' * int(rng.integers(5, 80))}" for i in range(5000)]
        data = ("\n".join(lines) + "\n").encode()
    elif payload == "boundary":
        data = b"a" * 100_000
    else:
        data = b""
    out = {}
    for name, mod in (("jax", jbgzf), ("torch", tbgzf)):
        src = tmp_path / f"{name}.txt"
        src.write_bytes(data)
        out[name] = mod.compress_file(str(src))
        with mod.BgzfWriter(str(tmp_path / f"{name}_w.gz")) as w:
            w.write(data)
            out[name + "_v"] = w.tell_virtual()
    _same_bytes(out["jax"], out["torch"])
    _same_bytes(tmp_path / "jax_w.gz", tmp_path / "torch_w.gz")
    assert out["jax_v"] == out["torch_v"]
    assert gzip.open(out["torch"], "rb").read() == data
    if payload == "multiblock":
        with tbgzf.BgzfReader(out["torch"]) as r:
            assert list(r.read_from(0)) == [ln.encode() for ln in lines]


def test_tabix_index_bytes_equal_jax_and_query(tmp_path):
    """build_index writes the JAX module's .tbi; the port's query of many
    regions returns the JAX query's records, which are a plain scan's."""
    rng = np.random.default_rng(7)
    recs = []
    for chrom in ("chr1", "chr2"):
        for s in np.sort(rng.choice(2_000_000, size=3000, replace=False)):
            recs.append((chrom, int(s), int(s) + int(rng.choice([2, 150, 20_000])), f"{chrom}_{s}"))
    gz = {}
    for name, (bg, tb) in (("jax", (jbgzf, jtabix)), ("torch", (tbgzf, ttabix))):
        bed = tmp_path / f"{name}.bed"
        bed.write_text("".join("\t".join(map(str, r)) + "\n" for r in recs))
        gz[name] = bg.compress_file(str(bed))
        tb.build_index(gz[name])
    _same_bytes(gz["jax"], gz["torch"])
    _same_bytes(gz["jax"] + ".tbi", gz["torch"] + ".tbi")
    jf, tf = jtabix.TabixFile(gz["jax"]), ttabix.TabixFile(gz["torch"])
    for _ in range(40):
        chrom = ["chr1", "chr2"][int(rng.integers(2))]
        lo = int(rng.integers(0, 2_000_000))
        hi = lo + int(rng.choice([1, 500, 50_000, 400_000]))
        got = list(tf.query(chrom, lo, hi))
        assert got == list(jf.query(chrom, lo, hi))
        scan = [r for r in recs if r[0] == chrom and r[1] < hi and r[2] > lo]
        assert len(got) == len(scan)


# ---------------------------------------------------------------- make_bed ----

def _regimes_file(path, T, R, rng, ties, writer):
    p = rng.random((T, R))
    p /= p.sum(1, keepdims=True)
    if ties:
        p[::7, :2], p[::7, 2:] = 0.5, 0.0
    pos = np.sort(rng.choice(10**7, T, replace=False)) + 1
    if writer == "pandas":  # shortest repr, up to 17 digits
        pd.DataFrame({"genomic_position": pos, **{f"regime_{i + 1}": p[:, i] for i in range(R)}}).to_csv(
            path, index=False)
    else:  # the pipeline's writer, %.9g, gzipped
        tio.write_float_table(path, p.astype(np.float32), index=pos,
                              header="genomic_position," + ",".join(f"regime_{i + 1}" for i in range(R)))


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "bgzip"])
@pytest.mark.parametrize("R,ties,writer", [(6, True, "pipeline"), (7, True, "pandas"), (3, False, "pandas")])
def test_make_bed_bytes_equal_jax(tmp_path, R, ties, writer, compress):
    """BED9 (and with --bgzip its .bed.gz and .tbi) byte for byte: ties
    named "equiprobable" in grey, the palette cycled for R = 7, scores as
    pandas reads and writes them."""
    rng = np.random.default_rng(R)
    f = tmp_path / ("reg.csv.gz" if writer == "pipeline" else "reg.csv")
    _regimes_file(f, 2500, R, rng, ties, writer)
    jbed.make_bed("chr3", str(f), str(tmp_path / "j" / "x.bed"), compress=compress)
    tbed.make_bed("chr3", str(f), str(tmp_path / "t" / "x.bed"), compress=compress)
    assert _tree(tmp_path / "j") == _tree(tmp_path / "t")
    for name in _tree(tmp_path / "j"):
        _same_bytes(tmp_path / "j" / name, tmp_path / "t" / name)
    if not compress:
        text = (tmp_path / "t" / "x.bed").read_text()
        assert ("equiprobable\t" in text) == ties and text.count("\n") == 2500


def test_make_bed_file_verb_equals_jax(tmp_path):
    f = tmp_path / "reg.csv"
    _regimes_file(f, 300, 6, np.random.default_rng(1), True, "pandas")
    args = ["make_bed_file", "--chr", "5", "--regimes_file", str(f), "--bgzip"]
    jax_cli(args + ["--output_file", str(tmp_path / "j.bed")])
    torch_cli.main(args + ["--output_file", str(tmp_path / "t.bed")])
    for ext in (".bed.gz", ".bed.gz.tbi"):
        _same_bytes(tmp_path / f"j{ext}", tmp_path / f"t{ext}")
    assert not (tmp_path / "t.bed").exists()


# ----------------------------------------------------------- process_gembs ----

def _write_gembs(path, sample_id, rows):
    """rows: (contig, pos0, ref, non_conv, conv); written as the JAX
    property test writes them (pandas, gzipped, an extra column)."""
    pd.DataFrame({
        "Contig": [r[0] for r in rows], "Pos0": [r[1] for r in rows], "Ref": [r[2] for r in rows],
        f"{sample_id}:non_conv": [r[3] for r in rows], f"{sample_id}:conv": [r[4] for r in rows],
        f"{sample_id}:meth": [0.5 for _ in rows],
    }).to_csv(path, sep="\t", index=False, compression="gzip")


def _gembs_both(tmp, cpg, chromosome, kw):
    outs = []
    for name, fn in (("j", j_gembs), ("t", t_gembs)):
        out = tmp / name
        n = fn(cpg, out, chromosome, **kw)
        outs.append((out, n))
    (a, na), (b, nb) = outs
    assert na == nb
    assert _tree(a) == _tree(b)
    for name in _tree(a):
        assert gzip.decompress((a / name).read_bytes()) == gzip.decompress((b / name).read_bytes()), name


_g_record = st.tuples(
    st.integers(0, 12),  # Pos0
    st.sampled_from(["chr7", "chr7", "chr7", "chr8"]),
    st.sampled_from(["CG", "CG", "CG", "CA"]),
    st.integers(0, 40),
    st.integers(0, 40),
)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(
    cpg=st.lists(st.integers(1, 14), min_size=1, max_size=10),
    samples=st.lists(st.one_of(st.none(), st.just("badcols"), st.lists(_g_record, max_size=14)),
                     min_size=1, max_size=4),
    n_control=st.integers(0, 4),
    repeat_name=st.booleans(),
)
def test_process_gembs_byte_identical_property(tmp_path_factory, cpg, samples, n_control, repeat_name):
    """Random gemBS rows on a 15-site window (keys repeat: pandas' merge
    products and unstable sort), wrong-contig and non-CG rows, samples
    whose file is missing (None: no column slot) or whose columns carry
    another id (a NaN slot), empty slices, a sample id used twice (pandas'
    _x/_y suffixes)."""
    tmp = tmp_path_factory.mktemp("gembs")
    (tmp / "cpg.tsv").write_text("seqID\tstart\n" + "".join(f"chr7\t{s}\n" for s in cpg))
    paths, names = [], []
    for i, recs in enumerate(samples):
        sid = "s0" if (repeat_name and i == len(samples) - 1 and i > 0) else f"s{i}"
        p = tmp / f"f{i}.tsv.gz"
        paths.append(str(p))
        names.append(sid)
        if recs is None:
            continue
        if recs == "badcols":
            _write_gembs(p, "other", [("chr7", 3, "CG", 1, 2)])
            continue
        _write_gembs(p, sid, [(c, pos, ref, nc, cv) for pos, c, ref, nc, cv in recs])
    k = min(n_control, len(paths))
    _gembs_both(tmp, tmp / "cpg.tsv", 7, dict(
        control_data_paths=paths[:k], control_id_names=names[:k],
        case_data_paths=paths[k:], case_id_names=names[k:]))


def test_process_gembs_degenerate_samples_equal_jax(tmp_path):
    """The JAX property test's degenerate case: an empty-chromosome sample
    and a missing-columns sample keep NaN slots, a missing file keeps none,
    a sample repeated in both groups."""
    rng = np.random.default_rng(11)
    chromosome = 8
    cpg_starts = np.sort(rng.choice(np.arange(100, 2000), 15, replace=False))
    cpg = tmp_path / "cpg.tsv"
    cpg.write_text("seqID\tstart\n" + "".join(f"chr{chromosome}\t{s}\n" for s in cpg_starts))

    def rows():
        out = [(f"chr{chromosome}", int(s) - 1, "CG", int(rng.integers(0, 40)), int(rng.integers(0, 40)))
               for s in cpg_starts if rng.integers(0, 4)]
        out += [(f"chr{chromosome + 1}", 10_000, "CG", 9, 9), (f"chr{chromosome}", 10_001, "CA", 9, 9),
                (f"chr{chromosome}", int(cpg_starts.max()) + 500, "CG", 7, 3)]
        rng.shuffle(out)
        return out

    _write_gembs(tmp_path / "good.tsv.gz", "good", rows())
    _write_gembs(tmp_path / "empty.tsv.gz", "empty", [(f"chr{chromosome + 1}", 500, "CG", 3, 4)])
    _write_gembs(tmp_path / "badcols.tsv.gz", "otherid", rows())
    p = lambda n: str(tmp_path / n)
    _gembs_both(tmp_path, cpg, chromosome, dict(
        control_data_paths=[p("empty.tsv.gz"), p("good.tsv.gz")], control_id_names=["empty", "good"],
        case_data_paths=[p("gone.tsv.gz"), p("badcols.tsv.gz"), p("good.tsv.gz")],
        case_id_names=["gone", "badcols", "good"]))


def test_preprocess_format_gembs_verb_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    starts = np.sort(rng.choice(np.arange(100, 3000), 40, replace=False))
    cpg = tmp_path / "cpg.tsv"
    cpg.write_text("seqID\tstart\n" + "".join(f"chr21\t{s}\n" for s in starts))
    args = ["preprocess", "--cpg_file_path", str(cpg), "--chromosome", "21", "--format", "gembs"]
    for i, group in enumerate(("control", "case")):
        f = tmp_path / f"{group}.tsv.gz"
        _write_gembs(f, f"x{i}", [("chr21", int(s) - 1, "CG", int(rng.integers(0, 30)), int(rng.integers(0, 30)))
                                  for s in starts[::2]])
        args += [f"--{group}_data_path", str(f), f"--{group}_id_names", f"x{i}"]
    jax_cli(args + ["--output_path", str(tmp_path / "j")])
    torch_cli.main(args + ["--output_path", str(tmp_path / "t")])
    assert _tree(tmp_path / "j") == _tree(tmp_path / "t") and len(_tree(tmp_path / "t")) == 6
    for name in _tree(tmp_path / "j"):
        assert gzip.decompress((tmp_path / "j" / name).read_bytes()) == gzip.decompress(
            (tmp_path / "t" / name).read_bytes()), name


# ---------------------------------------------------------- run_single_group ----

def test_stub_run_tree_equals_jax(tmp_path):
    sheet = tmp_path / "samples.csv"
    sheet.write_text("id,file\ns1,/nonexistent.bed\ns2,/nonexistent2.bed\n")
    args = ["run", "--stub_run", "--chroms", "c3,c4", "--sample_sheet", str(sheet)]
    jax_cli(args + ["--output_dir", str(tmp_path / "j")])
    torch_cli.main(args + ["--output_dir", str(tmp_path / "t")])
    assert _tree(tmp_path / "j") == _tree(tmp_path / "t")
    assert "4_SINGLE_GROUP_OUTPUT/s2/s2_regimes_c4.bed.gz.tbi" in _tree(tmp_path / "t")


@pytest.fixture(scope="module")
def sheet_run(tmp_path_factory):
    """Two BED samples of one 400-CpG chromosome (make_bed_dataset) through
    both packages' ``run`` (N=30 particles), and the port's run again."""
    root = tmp_path_factory.mktemp("sg_run")
    cpg, controls, _cases, _dmr, pos0 = chip_smoke.make_bed_dataset(str(root / "bed"), 400, seed=2, chrom="3",
                                                                   n_dmr=1, dmr_len=60)
    sheet = root / "samples.csv"
    sheet.write_text("id,file\n" + "".join(f"s{i},{p}\n" for i, p in enumerate(controls)))
    args = ["run", "--chroms", "3", "--cpg_file_path", cpg, "--sample_sheet", str(sheet), "--n_particles", "30"]
    jax_cli(args + ["--output_dir", str(root / "j")])
    torch_cli.main(args + ["--output_dir", str(root / "t"), "--device", "cpu"])
    trace1 = (root / "t" / "trace.tsv").read_text()
    files1 = {n: (root / "t" / n).read_bytes() for n in _tree(root / "t") if not n.endswith((".tsv", ".html",
                                                                                           ".yml", ".dot"))}
    torch_cli.main(args + ["--output_dir", str(root / "t"), "--device", "cpu"])
    return root, trace1, files1, pos0


def test_run_single_group_tree_equals_jax(sheet_run):
    """The port's tree has the JAX run's file names; the preprocess stage's
    files are its bytes (after decompression); the BED track has a record a
    site, the tabix query over it equals a plain scan; the first run's
    trace names both batched passes and every BED stage."""
    root, trace1, _files1, pos0 = sheet_run
    assert _tree(root / "t") == _tree(root / "j")
    for name in _tree(root / "j"):
        if name.startswith("1_PREPROCESS") and name.endswith(".gz"):
            assert gzip.decompress((root / "j" / name).read_bytes()) == gzip.decompress(
                (root / "t" / name).read_bytes()), name
    stages = [r.split("\t")[0] for r in trace1.splitlines()[1:]]
    assert stages.count("SINGLE_GRP_PREPROCESS") == 2
    assert "ESTIMATE_PARAMETERS[batched]" in stages and "ESTIMATE_REGIMES[batched]" in stages
    assert stages.count("GENERATE_SINGLE_GROUP_BED_FILES") == 2
    bed_gz = root / "t" / "4_SINGLE_GROUP_OUTPUT" / "s0" / "s0_regimes_3.bed.gz"
    lines = gzip.decompress(bed_gz.read_bytes()).decode().splitlines()
    assert len(lines) == len(pos0)
    recs = [(int(ln.split("\t")[1]), int(ln.split("\t")[2])) for ln in lines]
    lo, hi = recs[100][0], recs[140][1]
    hits = list(ttabix.TabixFile(str(bed_gz)).query("3", lo, hi))
    assert len(hits) == sum(1 for s, e in recs if s < hi and e > lo)


def test_run_single_group_resume_skips_every_stage(sheet_run):
    root, _trace1, files1, _pos0 = sheet_run
    rows = [r.split("\t") for r in (root / "t" / "trace.tsv").read_text().splitlines()[1:]]
    assert len(rows) == 2 * 4 and all(r[3] == "True" for r in rows), rows
    for name, data in files1.items():
        assert (root / "t" / name).read_bytes() == data, name


def _sg_kw(**extra):
    return dict(mu=SG_MU, sigma=SG_SIGMA, u=2, n_particles=40, epsilon=0.01, steps_per_update=40,
                learning_rate_exponent=0.1, learning_rate_factor=0.01, rng_seed=0, **extra)


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    """Preprocessed 'case' counts of two chromosomes of 140 and 100 sites."""
    pre = tmp_path_factory.mktemp("pre")
    rng = np.random.default_rng(9)
    for chrom, T in (("c1", 140), ("c2", 100)):
        n = np.full((T, 2), 25.0)
        y = np.minimum(rng.poisson(8, size=(T, 2)), n)
        jio.write_count_matrix(pre / f"positions_{chrom}.txt.gz", np.arange(1, T + 1) * 19)
        jio.write_count_matrix(pre / f"n_total_reads_case_{chrom}.txt.gz", n)
        jio.write_count_matrix(pre / f"n_methylated_reads_case_{chrom}.txt.gz", y)
    return pre


@pytest.mark.parametrize("pass_", ["parameters", "regimes"])
def test_batched_pass_equals_per_unit_runs(tmp_path, counts, pass_):
    """One engine call over both chromosomes (per-unit lengths, shared
    draws; in the regime pass a theta a unit) writes each chromosome's
    per-unit files bit for bit; the parameter pass writes no regime file."""
    kw = _sg_kw(device="cpu")
    if pass_ == "parameters":
        flags, theta = dict(estimate_parameters=True, estimate_regimes=False), {"c1": None, "c2": None}
    else:
        rng = np.random.default_rng(4)
        theta = {c: rng.normal(size=36) * 0.3 for c in ("c1", "c2")}
        flags = dict(estimate_parameters=False, estimate_regimes=True)
    units = [(counts, tmp_path / "b" / c, c, "case") for c in ("c1", "c2")]
    torch_orch._single_group_on_counts_batched(
        units, theta_fixed=None if theta["c1"] is None else [theta["c1"], theta["c2"]], **flags, **kw)
    for c in ("c1", "c2"):
        torch_orch._single_group_on_counts(counts, tmp_path / "u" / c, c, group="case", theta_fixed=theta[c],
                                           **flags, **kw)
        names = _tree(tmp_path / "u" / c)
        assert names == _tree(tmp_path / "b" / c)
        assert (f"regime_probabilities_{c}.csv.gz" in names) == (pass_ == "regimes")
        for name in names:
            assert tio._read_text(tmp_path / "u" / c / name) == tio._read_text(tmp_path / "b" / c / name), name


def test_run_single_group_without_estimation_starts_from_the_default_theta(tmp_path, counts):
    """Neither theta given nor estimated: the engine starts from the default
    P and omega (runner.default_p, DEFAULT_OMEGA), and the trace keeps it."""
    from hygeia_tpu_torch.single_group.model import parameters_to_theta
    from hygeia_tpu_torch.single_group.runner import DEFAULT_OMEGA, default_p

    torch_orch._single_group_on_counts(counts, tmp_path, "c2", group="case", estimate_parameters=False,
                                       estimate_regimes=True, **_sg_kw(device="cpu"))
    want = parameters_to_theta(default_p(6), np.asarray(DEFAULT_OMEGA), np.full(6, 2.0))
    np.testing.assert_allclose(tio.read_theta(tmp_path / "theta_c2.csv.gz"), want.astype(np.float32), rtol=1e-7)


def test_estimate_regimes_from_one_theta_file_agrees_with_jax(tmp_path):
    """The regime pass of both packages from the same theta file on the same
    counts (a 600-site simulated chromosome, N=250): regime probabilities
    within the Monte Carlo bound of the module docstring."""
    from hygeia_tpu.single_group.model import parameters_to_theta

    rng = np.random.default_rng(5)
    T, R = 600, 6
    regime = np.repeat(rng.integers(0, R, size=12), 50)
    mu, sd = np.asarray(SG_MU), np.asarray(SG_SIGMA)
    nu = mu * (1 - mu) / sd**2 - 1
    level = rng.beta(mu[regime] * nu[regime], (1 - mu[regime]) * nu[regime])
    n = np.full((T, 2), 30.0)
    y = rng.binomial(30, np.broadcast_to(level[:, None], (T, 2))).astype(np.float64)
    pre = tmp_path / "pre"
    pre.mkdir()
    jio.write_count_matrix(pre / "positions_c.txt.gz", np.arange(1, T + 1) * 11)
    jio.write_count_matrix(pre / "n_total_reads_case_c.txt.gz", n)
    jio.write_count_matrix(pre / "n_methylated_reads_case_c.txt.gz", y)
    P = np.full((R, R), 0.2)
    np.fill_diagonal(P, 0.0)
    theta = np.asarray(parameters_to_theta(P, np.full(R, 0.98), np.full(R, 2.0)))
    kw = dict(mu=SG_MU, sigma=SG_SIGMA, u=3, n_particles=250, epsilon=0.01, steps_per_update=200,
              learning_rate_exponent=0.1, learning_rate_factor=0.01, rng_seed=0, estimate_regimes=True,
              estimate_parameters=False, theta_fixed=theta)
    (tmp_path / "j").mkdir()
    jorch._single_group_on_counts(pre, tmp_path / "j", "c", group="case", **kw)
    torch_orch._single_group_on_counts(pre, tmp_path / "t", "c", group="case", device="cpu", **kw)
    pj = pd.read_csv(tmp_path / "j" / "regime_probabilities_c.csv.gz").to_numpy(float)
    pt = pd.read_csv(tmp_path / "t" / "regime_probabilities_c.csv.gz").to_numpy(float)
    np.testing.assert_array_equal(pj[:, 0], pt[:, 0])
    pj, pt = pj[:, 1:], pt[:, 1:]
    assert float(np.abs(pj - pt).mean()) < 0.05
    sure = (pj.max(1) > 0.9) & (pt.max(1) > 0.9)
    assert sure.sum() > T // 2
    assert float((pj.argmax(1) == pt.argmax(1))[sure].mean()) >= 0.9
    assert float((pt.argmax(1) == regime).mean()) > 0.6


CLI_MU = [0.95, 0.05, 0.80, 0.20, 0.50, 0.50]
CLI_SIGMA = [0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751]


def _recovered(path, regime):
    probs = pd.read_csv(path).to_numpy(float)[:, 1:]
    planted = regime <= 1
    return probs, float((probs.argmax(1)[planted] == regime[planted]).mean())


def test_both_passes_from_the_ports_start_agree_with_jax(tmp_path):
    """chip_smoke.py phase 13's first sample (5,000 CpGs, seed 4) at the run
    verb's defaults: the port's ESTIMATE_PARAMETERS and ESTIMATE_REGIMES,
    and the JAX package's from the port's start theta, learn the same theta
    and the same regime modes. From that start both settle in one regime
    by site 100 for the rest of the chromosome: its float32 hazard has no
    exit latch and is exactly 0 past a sojourn below 100, in both packages'
    tables. From the JAX package's own start draw (float32, as it runs
    outside these tests) the same passes recover the planted stretches."""
    from hygeia_tpu.ops.hazard import hazard_table as j_hazard
    from hygeia_tpu_torch.ops.hazard import hazard_table as t_hazard
    from hygeia_tpu_torch.single_group.model import theta_to_parameters

    _cpg, controls, _c, _d, _pos0, regime = chip_smoke.make_bed_dataset(
        tmp_path / "bed", 5000, seed=4, chrom="4", with_regime=True)
    out = tmp_path / "port"
    torch_orch.run_single_group(output_dir=out, chroms=["4"], raw_samples=[("s0", controls[0])],
                                cpg_file_path=_cpg, mu=CLI_MU, sigma=CLI_SIGMA, u=3, n_particles=250,
                                device="cpu")
    pre = out / "1_PREPROCESS/s0/4"
    kw = dict(group="case", mu=CLI_MU, sigma=CLI_SIGMA, u=3, n_particles=250, epsilon=0.01, steps_per_update=200,
              learning_rate_exponent=0.1, learning_rate_factor=0.01, rng_seed=0)
    start = torch_orch._sg_setup([(pre, "4", "case")], device="cpu",
                                 **{k: v for k, v in kw.items() if k != "group"})[2]

    def jax_passes(name, theta0):
        p_dir, r_dir = tmp_path / name / "p", tmp_path / name / "r"
        p_dir.mkdir(parents=True)
        r_dir.mkdir()
        jorch._single_group_on_counts(pre, p_dir, "4", estimate_parameters=True, estimate_regimes=False,
                                      theta_fixed=theta0, **kw)
        theta = jio.read_theta(p_dir / "theta_4.csv.gz")
        jorch._single_group_on_counts(pre, r_dir, "4", estimate_parameters=False, estimate_regimes=True,
                                      theta_fixed=theta, **kw)
        return theta, *_recovered(r_dir / "regime_probabilities_4.csv.gz", regime)

    theta_j, pj, rec_j = jax_passes("jax_from_port_start", start.numpy())
    theta_t = tio.read_theta(out / "2_ESTIMATE_PARAMETERS/s0/4/theta_4.csv.gz")
    pt, rec_t = _recovered(out / "3_ESTIMATE_REGIMES/s0/4/regime_probabilities_4.csv.gz", regime)
    np.testing.assert_allclose(theta_t, theta_j, atol=1e-3)
    assert float(np.abs(pj - pt).mean()) < 0.05
    assert float((pj.argmax(1) == pt.argmax(1)).mean()) >= 0.99
    assert abs(rec_t - rec_j) <= 0.01

    mode = pt.argmax(1)
    stuck = int(mode[-1])
    assert (mode[100:] == stuck).all()
    omega = theta_to_parameters(theta_t, 6)["omega"]
    rho_t, exit_t = t_hazard(torch.full((6,), 2.0), torch.tensor(omega, dtype=torch.float32), 3, 4096)
    rho_j, exit_j = j_hazard(np.full(6, 2.0, np.float32), np.asarray(omega, np.float32), 3, 4096)
    for rho, ex in ((rho_t.numpy(), exit_t.numpy()), (np.asarray(rho_j), np.asarray(exit_j))):
        assert not ex[stuck].any()
        assert (rho[stuck, 100:] == 0).all()

    import jax
    import jax.numpy as jnp

    own_start = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (start.numel(),), dtype=jnp.float32))
    _, _, rec_own = jax_passes("jax_from_its_start", own_start)
    assert rec_own > 0.6 > max(rec_t, rec_j)


def test_single_group_verbs_import_neither_jax_nor_pandas(tmp_path):
    """make_bed_file, preprocess --format gembs and a single-group stub run
    through the port's CLI in a fresh interpreter; then sys.modules holds no
    jax, pandas or hygeia_tpu."""
    rng = np.random.default_rng(3)
    reg = tmp_path / "reg.csv.gz"
    _regimes_file(reg, 50, 6, rng, True, "pipeline")
    cpg = tmp_path / "cpg.tsv"
    cpg.write_text("seqID\tstart\nchr2\t5\nchr2\t9\n")
    g = tmp_path / "g.tsv"
    g.write_text("Contig\tPos0\tRef\ta:non_conv\ta:conv\nchr2\t4\tCG\t3\t1\n")
    sheet = tmp_path / "s.csv"
    sheet.write_text("id,file\na,/none.bed\n")
    calls = [
        ["make_bed_file", "--chr", "2", "--regimes_file", str(reg), "--output_file", str(tmp_path / "o.bed"),
         "--bgzip"],
        ["preprocess", "--cpg_file_path", str(cpg), "--output_path", str(tmp_path / "pre"), "--chromosome", "2",
         "--format", "gembs", "--case_data_path", str(g), "--case_id_names", "a"],
        ["run", "--stub_run", "--output_dir", str(tmp_path / "stub"), "--chroms", "2", "--sample_sheet",
         str(sheet)],
    ]
    code = (
        "import sys\n"
        "import hygeia_tpu_torch.cli as c\n"
        "import hygeia_tpu_torch.two_group.marginal, hygeia_tpu_torch.pipeline.bed\n"
        f"for argv in {calls!r}:\n"
        "    c.main(argv)\n"
        "bad = [m for m in ('jax', 'pandas', 'hygeia_tpu') if m in sys.modules]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "o.bed.gz.tbi").exists() and (tmp_path / "pre" / "positions_2.txt.gz").exists()
