"""The port's simulators and their verbs against the JAX package's.

* The two-group and single-group chains, fed the draws the JAX simulators
  derive from their threefry keys (the key schedule rebuilt here), give
  the JAX states exactly (R = 6, and R = 5 of the reference's preset 10).
* The port's own draws: sampled transitions against the port's
  ``transition_log_prob`` and BetaBinomial counts against
  ``beta_binomial_log_pmf`` (chi-square, p > 1e-4).
* ``simulate_two_groups``: P, the depths and the file names are the JAX
  verb's; the files equal the JAX verb's after decompression when written
  from the same arrays; ``--run_inference --device cpu`` writes the JAX
  verb's file set and shapes and recovers the control regimes as well as
  the JAX verb (run with x64 off in a subprocess, as its CLI runs).
* ``simulate_data`` files read by the JAX package's reader.
* ``make_realistic_fixture``: positions, island mask and coverage.
* ``approximate_log_normalizing_constant``: the batched replicates equal
  one-unit runs bit for bit, and their mean lies within Monte-Carlo
  tolerance of the JAX package's replicates.
"""

import argparse
import gzip
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from hygeia_tpu.single_group import runner as jsg_runner
from hygeia_tpu.single_group import simulate as jsg_sim
from hygeia_tpu.single_group.model import build_tables as j_build_tables
from hygeia_tpu.single_group.model import make_model as j_make_model
from hygeia_tpu.single_group.model import parameters_to_theta
from hygeia_tpu.two_group import realistic as jrealistic
from hygeia_tpu.two_group import simulate as j2_sim
from hygeia_tpu.two_group import simulate_runner as jsim_runner
from hygeia_tpu.two_group.model import make_params as j_make_params
from hygeia_tpu.utils import io as hio
from hygeia_tpu_torch import cli as torch_cli
from hygeia_tpu_torch.ops.distributions import beta_binomial_log_pmf
from hygeia_tpu_torch.single_group import engine as t_engine
from hygeia_tpu_torch.single_group import runner as tsg_runner
from hygeia_tpu_torch.single_group import simulate as tsg_sim
from hygeia_tpu_torch.single_group.model import model_from_numpy
from hygeia_tpu_torch.two_group import realistic as trealistic
from hygeia_tpu_torch.two_group import simulate as t2_sim
from hygeia_tpu_torch.two_group import simulate_runner as tsim_runner
from hygeia_tpu_torch.two_group.model import State, params_from_numpy, transition_log_prob

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
MU6 = (0.95, 0.05, 0.80, 0.20, 0.50, 0.50)
SIGMA6 = (0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751)
SG_MU = np.array([0.99, 0.01, 0.80, 0.20, 0.50, 0.50])
SG_SIGMA = np.array([0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751])
SG_OMEGA = np.array([0.995, 0.975, 0.950, 0.925, 0.900, 0.900])


def _offdiag_log_p(rng, R):
    P = rng.dirichlet(np.ones(R - 1), size=R)
    full = np.zeros((R, R))
    for r in range(R):
        full[r, [c for c in range(R) if c != r]] = P[r]
    with np.errstate(divide="ignore"):
        return np.log(full)


def _jax_params(mu, sigma, T, seed=1, omega_logit=1.2):
    R = len(mu)
    return j_make_params(mu=mu, sigma=sigma, p_softmax_control=_offdiag_log_p(np.random.default_rng(seed), R),
                         omega_logit_control=np.full(R, omega_logit), omega_case=0.8,
                         kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
                         split_prob=0.01, minimum_duration=3, d_max=T + 2)


def _torch_params(jp):
    return params_from_numpy({k: np.array(v) for k, v in jp._asdict().items()}, device="cpu")


def _jax_two_group_noise(key, T, params):
    """The draws of hygeia_tpu.two_group.simulate.simulate(key, ...): its key
    schedule (split(key, 3) for the phantom regime and site 0, split(key,
    T - 1) for the rest, split(k, 6) a site) and jax.random.categorical's
    Gumbel noise in the logits' dtype (the case-regime logits are weakly
    typed: float64 under x64)."""
    R = params.n_regimes
    key, k_phantom, k0 = jax.random.split(key, 3)
    keys = jnp.concatenate([k0[None], jax.random.split(key, T - 1)])
    ks = jax.vmap(lambda k: jax.random.split(k, 6))(keys)
    case_dtype = jnp.where(jnp.arange(R) != 0, 0.0, -jnp.inf).dtype
    draw = lambda i, f: np.array(jax.vmap(f)(ks[:, i]))
    return t2_sim.ChainNoise(
        phantom_r=np.array(jax.random.randint(k_phantom, (), 0, R)),
        g_m=draw(0, lambda k: jax.random.gumbel(k, (2,), params.log_p_merged.dtype)),
        u_c=draw(1, jax.random.uniform),
        g_cr=draw(2, lambda k: jax.random.gumbel(k, (R,), params.log_p_control.dtype)),
        u_k=draw(3, jax.random.uniform),
        g_kr=draw(4, lambda k: jax.random.gumbel(k, (R,), case_dtype)),
        g_kr2=draw(5, lambda k: jax.random.gumbel(k, (R,), case_dtype)),
    )


@pytest.mark.parametrize("cfg", [None, 10], ids=["R6", "R5-preset10"])
def test_two_group_chain_equals_jax_given_its_draws(cfg):
    mu, sigma = jsim_runner.REGIME_CONFIGS[cfg] if cfg else (MU6, SIGMA6)
    T = 300
    jp = _jax_params(mu, sigma, T)
    key = jax.random.PRNGKey(5)
    n = np.full((T, 2), 20.0)
    want = np.asarray(j2_sim.simulate(key, jp, n, n).states)
    got = t2_sim.simulate_chain(_torch_params(jp), _jax_two_group_noise(key, T, jp)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # The chain visits every branch: splits, merges and both jump kinds.
    assert 0 < np.mean(want[:, 0] == 0) < 1 and len(np.unique(want[:, 2])) == len(mu)


def test_single_group_chain_equals_jax_given_its_draws():
    R, T = 6, 400
    jm = j_make_model(SG_MU, SG_SIGMA, 2, np.full(R, 2.0), d_max=4096)
    theta = jnp.asarray(parameters_to_theta(jsg_runner.default_p(R), SG_OMEGA, np.full(R, 2.0)), jnp.float32)
    key = jax.random.PRNGKey(3)
    want = jsg_sim.simulate(key, jm, theta, np.full((T, 2), 20.0))
    # simulate.py's schedule: split(key) for r0, split(key, T - 1), split(k) a step.
    key2, k0 = jax.random.split(key)
    ks = jax.vmap(jax.random.split)(jax.random.split(key2, T - 1))
    log_p_dtype = j_build_tables(jm, theta).log_P.dtype
    noise = tsg_sim.ChainNoise(
        r0=np.array(jax.random.randint(k0, (), 0, R)),
        u=np.array(jax.vmap(jax.random.uniform)(ks[:, 0])),
        g=np.array(jax.vmap(lambda k: jax.random.gumbel(k, (R,), log_p_dtype))(ks[:, 1])),
    )
    tm, tth = model_from_numpy({k: np.array(v) for k, v in jm._asdict().items()}, np.array(theta), device="cpu",
                               dtype=torch.float32)
    d, r = tsg_sim.simulate_chain(tm, tth, noise)
    assert np.array_equal(d.numpy(), np.asarray(want.d)) and np.array_equal(r.numpy(), np.asarray(want.r))
    assert d.dtype == torch.int32 and len(np.unique(r.numpy())) >= 4


def _chi2_pvalue(counts, prob):
    """Chi-square p-value of counts against probabilities, the cells with an
    expected count below 5 pooled; 1.0 when the support is one cell and
    every draw lies in it."""
    expected = prob * counts.sum()
    big = expected >= 5
    obs, exp = counts[big], expected[big]
    if (~big).any() and expected[~big].sum() > 0:
        obs, exp = np.append(obs, counts[~big].sum()), np.append(exp, expected[~big].sum())
    if len(obs) == 1:
        return 1.0 if obs[0] == counts.sum() else 0.0
    return scipy.stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue


# Previous states (m, d_c, r_c, d_k, r_k): merged and split, sojourns below,
# at and past the minimum duration, the case regime equal to the control's
# and not.
# (1, 1, 0, 1, 0) has one successor: merged below the minimum duration,
# with a hazard of 0 at sojourn 1.
_PREV = [(1, 5, 2, 5, 2), (1, 1, 0, 1, 0), (0, 4, 1, 7, 3), (0, 2, 4, 9, 4), (0, 30, 5, 2, 1), (1, 3, 3, 3, 3)]


@pytest.mark.parametrize("prev", _PREV)
def test_sampled_transitions_follow_transition_log_prob(prev):
    """K draws from one previous state through the port's sampler, against
    exp(transition_log_prob) over every state reachable from it."""
    R, K = 6, 40_000
    tp = _torch_params(_jax_params(MU6, SIGMA6, 64, omega_logit=-0.5))
    gen = torch.Generator().manual_seed(7)
    noise = t2_sim.draw_chain_noise(K, R, generator=gen, device="cpu")
    p = State(*(torch.full((K,), v, dtype=torch.int32) for v in prev))
    nxt = t2_sim.sample_transition(tp, p, tuple(noise[1:]))
    m, dc, rc, dk, rk = prev
    cand = np.array(list(itertools.product((0, 1), (1, dc + 1), range(R), sorted({1, dk + 1, 2, dc + 1}), range(R))))
    lp = transition_log_prob(tp, State(*(torch.tensor(v, dtype=torch.int32) for v in prev)),
                             State(*(torch.as_tensor(cand[:, i], dtype=torch.int32) for i in range(5)))).double()
    prob = torch.exp(lp).numpy()
    assert abs(prob.sum() - 1.0) < 1e-5
    drawn = torch.stack(nxt, dim=-1).numpy()
    index = {tuple(c): i for i, c in enumerate(cand)}
    counts = np.bincount([index[tuple(x)] for x in drawn], minlength=len(cand))
    assert counts[prob == 0].sum() == 0  # nothing outside the support
    p_value = _chi2_pvalue(counts, prob)
    assert p_value > 1e-4, (prev, p_value)


@pytest.mark.parametrize("regime", [0, 3, 5])
def test_beta_binomial_counts_follow_the_log_pmf(regime):
    tp = _torch_params(_jax_params(MU6, SIGMA6, 64))
    n, K = 20, 50_000
    gen = torch.Generator().manual_seed(regime)
    a, b = tp.alpha[regime].reshape(1, 1), tp.beta[regime].reshape(1, 1)
    y = t2_sim.sample_beta_binomial(torch.full((K, 1), float(n)), a, b, generator=gen)
    assert y.dtype == torch.int32
    counts = np.bincount(y.numpy().ravel(), minlength=n + 1)
    x = torch.arange(n + 1, dtype=torch.float64)
    prob = torch.exp(beta_binomial_log_pmf(x, torch.full_like(x, n), a[0].double(), b[0].double())).numpy()
    assert _chi2_pvalue(counts, prob) > 1e-4


def _args(results_dir, **kw):
    d = dict(mu=list(MU6), sigma=list(SIGMA6), minimum_duration=3, omega_case=0.8, omega_control=0.8,
             regimes_config=None, merge_log_prob=float(np.log(0.1)), split_prob=0.01, n_observations=300,
             n_samples=2, lambda_reads=20.0, missing_prob=0.2, seed=4, results_dir=str(results_dir),
             num_resampled_particles=6, num_samples_backward=8, run_inference=False)
    d.update(kw)
    return argparse.Namespace(**d)


@pytest.mark.parametrize("cfg", [None, 10], ids=["R6", "R5-preset10"])
def test_simulate_two_groups_inputs_and_files_equal_jax(tmp_path, monkeypatch, cfg):
    """The JAX verb (x64 on, as the tests run it): its P (as make_params
    receives it) and depths are the port's bit for bit, its file names the
    port's, and its files the port's writer's output from its own arrays."""
    seen = {}
    real = jsim_runner.make_params
    monkeypatch.setattr(jsim_runner, "make_params", lambda **kw: seen.update(kw) or real(**kw))
    jsim_runner.simulate_two_groups(_args(tmp_path / "jax", regimes_config=cfg))
    mu, sigma, log_p, n_c, n_k = tsim_runner.simulation_inputs(_args(tmp_path, regimes_config=cfg))
    assert list(mu) == list(seen["mu"]) and list(sigma) == list(seen["sigma"])
    assert np.array_equal(log_p, seen["p_softmax_control"])  # -inf diagonal included
    read = lambda name: np.loadtxt(tmp_path / "jax" / f"{name}.csv.gz", delimiter=",")
    assert np.array_equal(read("n_total_reads_control"), n_c) and np.array_equal(read("n_total_reads_case"), n_k)
    assert (n_c == 0).any()  # the missing-data mask

    load = lambda name: np.load(tmp_path / "jax" / f"{name}.npz")["arr_0"]
    states = np.concatenate([load("true_merged_states")[:, None], load("true_control_states"),
                             load("true_case_states")], axis=1)
    obs = {g: np.loadtxt(tmp_path / "jax" / f"observations_{g}.csv.gz", delimiter=",").astype(np.int32)
           for g in ("control", "case")}
    os.makedirs(tmp_path / "torch")
    tsim_runner.write_simulation(tmp_path / "torch", states, obs["control"], obs["case"], n_c, n_k)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) and len(names) == 7
    for name in names:
        if name.endswith(".gz"):
            assert gzip.decompress((tmp_path / "jax" / name).read_bytes()) == gzip.decompress(
                (tmp_path / "torch" / name).read_bytes()), name
        else:
            a, b = np.load(tmp_path / "jax" / name)["arr_0"], np.load(tmp_path / "torch" / name)["arr_0"]
            assert a.dtype == b.dtype and np.array_equal(a, b), name


_JAX_SELF_TEST = """
import sys, numpy as np, jax.numpy as jnp
from hygeia_tpu.cli import main
from hygeia_tpu.ops.distributions import logit
main(sys.argv[1:])
print("LOGIT", np.asarray(logit(jnp.full((6,), 0.8))).tobytes().hex())
"""


def test_simulate_two_groups_self_test_matches_jax(tmp_path):
    """``--run_inference --device cpu`` against the JAX verb with x64 off (its
    CLI's setting) at T = 800, M = 10: the same file set and shapes, the
    omega logit the JAX CLI computes, recovery of the control regimes
    within 0.05 of the JAX verb's (both above 0.85; at the verb's defaults
    the port's CPU runs read 0.981-0.994 over seeds 0-5, the JAX verb's
    0.974-0.989 over seeds 0-2) and a finite logZ."""
    common = ["--n_observations", "800", "--num_resampled_particles", "10", "--num_samples_backward", "10",
              "--run_inference"]
    jax_rec, torch_rec = [], []
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0", "HYGEIA_PLATFORM": "cpu"}
    for seed in (0,):
        jd, td = tmp_path / f"jax{seed}", tmp_path / f"torch{seed}"
        proc = subprocess.run([sys.executable, "-c", _JAX_SELF_TEST, "simulate_two_groups", "--results_dir", str(jd),
                               "--seed", str(seed), *common], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("self-test")][0]
        jax_rec.append(float(line.rsplit(" ", 1)[1]))
        logit_hex = [ln for ln in proc.stdout.splitlines() if ln.startswith("LOGIT")][0].split()[1]
        assert tsim_runner.logit_f32(0.8, 6).tobytes().hex() == logit_hex
        out = torch_cli.main(["simulate_two_groups", "--results_dir", str(td), "--seed", str(seed), "--device", "cpu",
                              *common])
        torch_rec.append(out["recovery"])
        assert np.isfinite(out["log_z"]) and out["degenerate_steps"] == 0
        names = sorted(os.listdir(jd))
        assert names == sorted(os.listdir(td)) and len(names) == 12
        for name in names:
            if name.endswith(".npz"):
                a, b = np.load(jd / name)["arr_0"], np.load(td / name)["arr_0"]
                assert (a.shape, a.dtype) == (b.shape, b.dtype), name
    assert min(jax_rec + torch_rec) > 0.85, (jax_rec, torch_rec)
    assert abs(np.mean(jax_rec) - np.mean(torch_rec)) < 0.05, (jax_rec, torch_rec)


def test_simulate_two_groups_cuda_raises_before_writing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main(["simulate_two_groups", "--results_dir", str(tmp_path / "o"), "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main(["simulate_data", "--regimes_csv_file", str(tmp_path / "o" / "r.csv"),
                        "--n_methylated_reads_csv_file", "m.csv", "--genomic_positions_csv_file", "p.csv",
                        "--n_total_reads_csv_file", "n.csv", "--device", "cuda"])
    assert not (tmp_path / "o").exists()


def test_simulate_data_files_read_by_the_jax_reader(tmp_path):
    """The port's verb and the JAX function write the same four headed
    files; the JAX reader reads the port's, the depths are the JAX verb's,
    the counts lie within the depths and the regimes are the simulated
    chain's."""
    files = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        d.mkdir()
        files[name] = {k: str(d / f"{k}.csv") for k in ("regimes", "meth", "pos", "total")}
    kw = dict(n_cpg_sites=500, n_samples=3, rng_seed=2)
    jsg_runner.simulate_data(regimes_csv_file=files["jax"]["regimes"], n_methylated_reads_csv_file=files["jax"]["meth"],
                             genomic_positions_csv_file=files["jax"]["pos"], n_total_reads_csv_file=files["jax"]["total"],
                             **kw)
    f = files["torch"]
    sim = torch_cli.main(["simulate_data", "--regimes_csv_file", f["regimes"], "--n_methylated_reads_csv_file", f["meth"],
                          "--genomic_positions_csv_file", f["pos"], "--n_total_reads_csv_file", f["total"],
                          "--n_cpg_sites", "500", "--n_samples", "3", "--rng_seed", "2", "--device", "cpu"])
    for k in ("regimes", "meth", "pos", "total"):
        assert Path(f[k]).read_text().splitlines()[0] == Path(files["jax"][k]).read_text().splitlines()[0], k
    total = hio.read_headed_matrix(f["total"])
    assert np.array_equal(total, hio.read_headed_matrix(files["jax"]["total"]))
    assert np.array_equal(hio.read_headed_column(f["pos"]), hio.read_headed_column(files["jax"]["pos"]))
    meth = hio.read_headed_matrix(f["meth"])
    assert meth.shape == (3, 500) and np.all((meth >= 0) & (meth <= total))
    assert np.array_equal(hio.read_headed_column(f["regimes"]), sim.r.numpy())


def test_realistic_fixture_positions_and_coverage_equal_jax(tmp_path):
    kw = dict(n_samples=2, seed=6)
    j = jrealistic.make_realistic_fixture(tmp_path / "jax", "7", 400, **kw)
    t = trealistic.make_realistic_fixture(tmp_path / "torch", "7", 400, device="cpu", **kw)
    assert np.array_equal(j.positions, t.positions) and np.array_equal(j.island_mask, t.island_mask)
    assert np.array_equal(j.n_total_control, t.n_total_control) and np.array_equal(j.n_total_case, t.n_total_case)
    assert t.states.shape == (400, 5) and t.states.dtype == np.int32
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "torch"))
    for name in ("positions_7", "n_total_reads_control_7", "n_total_reads_case_7"):
        assert gzip.decompress((tmp_path / "jax" / f"{name}.txt.gz").read_bytes()) == gzip.decompress(
            (tmp_path / "torch" / f"{name}.txt.gz").read_bytes()), name
    meth = hio.read_count_matrix(tmp_path / "torch" / "n_methylated_reads_case_7.txt.gz")
    assert np.all(meth <= t.n_total_case)


def test_replicate_log_normalizing_constants(tmp_path):
    """The port's replicates as units of one engine call equal one-unit runs
    on each replicate's generator bit for bit; their mean lies within 4
    standard errors (plus 1 nat) of the JAX package's replicates'."""
    rng = np.random.default_rng(11)
    T, S, U = 150, 2, 4
    n = rng.poisson(20, size=(T, S)).astype(np.float64)
    y = rng.binomial(n.astype(int), np.where(np.arange(T)[:, None] < 70, 0.9, 0.15)).astype(np.float64)
    kw = dict(n_methylated_reads=y, n_total_reads=n, n_particles=40, rng_seed=3)
    batched = tsg_runner.approximate_log_normalizing_constant(n_replicates=U, device="cpu", **kw)
    assert batched.shape == (U,) and np.all(np.isfinite(batched)) and len(np.unique(batched)) == U

    model = tsg_runner.make_model(np.asarray(tsg_runner.DEFAULT_MU), tsg_runner.DEFAULT_SIGMA, 2, np.full(6, 2.0),
                                  d_max=4096, device="cpu")
    theta = tsg_runner.parameters_to_theta(tsg_runner.default_p(6), np.asarray(tsg_runner.DEFAULT_OMEGA), np.full(6, 2.0))
    E = tsg_runner.emission_log_prob_table(y, n, model.alpha, model.beta)
    cfg = t_engine.EngineConfig(n_particles_max=40, estimate_regimes=False, estimate_parameters=False)
    for u, g in enumerate(tsg_runner.replicate_generators("cpu", 3, U)):
        alone = t_engine.run_online_combined_inference(model, theta, E, cfg, n_units=1, generator=g)
        assert alone.log_normalizing_constant.numpy()[0] == batched[u], u

    jax_reps = jsg_runner.approximate_log_normalizing_constant(n_replicates=8, **kw)
    more = tsg_runner.approximate_log_normalizing_constant(n_replicates=8, device="cpu",
                                                           **{**kw, "rng_seed": 4})
    se = np.sqrt(jax_reps.var(ddof=1) / 8 + more.var(ddof=1) / 8)
    assert abs(jax_reps.mean() - more.mean()) <= 4 * se + 1.0, (jax_reps, more)


def test_port_cli_has_every_jax_verb_and_flag():
    """The port's parser against the JAX package's: the same verbs (but the
    XLA cache's ``warmup``) with the same flags and defaults, plus
    ``--device`` on the verbs that run the model or a simulator."""
    from hygeia_tpu.cli import build_parser as jax_parser

    def verbs(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {name: {a.dest: (str(a.default), a.option_strings) for a in sp._actions if a.dest != "help"}
                for name, sp in sub.choices.items()}

    j, t = verbs(jax_parser()), verbs(torch_cli.build_parser())
    assert set(j) - set(t) == {"warmup"} and set(t) <= set(j)
    with_device = {"estimate_parameters_and_regimes", "infer", "run", "simulate_data", "simulate_two_groups"}
    for verb in t:
        extra = {"device"} if verb in with_device else set()
        assert set(t[verb]) == set(j[verb]) | extra, verb
        assert all(t[verb][k] == j[verb][k] for k in j[verb]), verb
        if extra:
            assert t[verb]["device"][0] == "cuda"
