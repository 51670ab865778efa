"""The ``estimate_parameters_and_regimes`` and ``simulate_data`` verbs, and
replicate estimates of the log-normalising constant.

Counterpart of hygeia_tpu/single_group/runner.py (``default_p``,
``estimate_parameters_and_regimes``, ``simulate_data``,
``approximate_log_normalizing_constant``): the same flags, input files,
output files, headers and column names, driving the port's engine and
simulator on one device.

``estimate_parameters_and_regimes``'s phases are spans (utils/spans.py):
``theta.call`` (the root) over ``theta.read``, ``theta.tables`` (the model
and the emission table), ``theta.engine`` (the online engine) and
``theta.write``; the tables and the engine wait for the device at their
ends while the recorder is on.
"""

from __future__ import annotations

import numpy as np
import torch

from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
from hygeia_tpu_torch.ops.site_graphs import SITES_PER_GRAPH
from hygeia_tpu_torch.single_group.engine import EngineConfig, run_online_combined_inference
from hygeia_tpu_torch.single_group import simulate as sg_simulate
from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta, theta_to_parameters
from hygeia_tpu_torch.utils import io as hio
from hygeia_tpu_torch.utils import spans

DEFAULT_MU = (0.99, 0.01, 0.80, 0.20, 0.50, 0.50)
DEFAULT_SIGMA = (0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751)
DEFAULT_OMEGA = (0.995, 0.975, 0.950, 0.925, 0.900, 0.900)


def default_p(n_regimes):
    """Uniform off-diagonal initial transition matrix."""
    p = np.full((n_regimes, n_regimes), 1.0 / (n_regimes - 1))
    np.fill_diagonal(p, 0.0)
    return p


def estimate_parameters_and_regimes(
    *,
    n_methylated_reads_csv_file,
    genomic_positions_csv_file,
    n_total_reads_csv_file,
    device,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    u=2,
    kappa=(2.0,) * 6,
    omega=DEFAULT_OMEGA,
    p=None,
    is_kappa_fixed=True,
    n_particles=250,
    estimate_regime_probabilities=False,
    estimate_parameters=False,
    epsilon=0.01,
    normalise_gradients=False,
    use_adam=True,
    n_steps_without_parameter_update=200,
    learning_rate_exponent=0.1,
    learning_rate_factor=0.01,
    rng_seed=0,
    regime_probabilities_csv_file=None,
    theta_trace_csv_file=None,
    p_csv_file="p.csv",
    omega_csv_file="omega.csv",
    kappa_csv_file="kappa.csv",
    theta_file="theta.csv",
    smoothing_window=128,
    weight_dtype=torch.float32,
    progress_every=0,
    sites_per_graph=SITES_PER_GRAPH,
):
    """Run the single-group engine on one chromosome's headed count files
    on ``device`` and write the requested outputs. Returns the
    EngineResult (one unit).

    With ``estimate_parameters`` the initial theta is drawn from N(0, I) by
    a CPU ``torch.Generator`` seeded with ``rng_seed`` (the JAX package
    draws it with ``jax.random.normal``, so the two start from different
    theta); the resampler's uniforms come from a generator on ``device``
    seeded with ``rng_seed``. ``sites_per_graph``: the engine's steady
    sites a CUDA graph on the card (0: eagerly, only to compare the two;
    the same files either way)."""
    device = torch.device(device)
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    kappa = np.asarray(kappa, np.float64)
    with spans.span("theta.call", units=1):
        with spans.span("theta.read"):
            positions = hio.read_headed_column(genomic_positions_csv_file).astype(np.int64)
            # Headed matrices come back (n_samples, n_sites); the engine takes (T, S).
            n_total = hio.read_headed_matrix(n_total_reads_csv_file).T
            n_meth = hio.read_headed_matrix(n_methylated_reads_csv_file).T
        T = n_total.shape[0]
        spans.annotate(sites=T)

        with spans.span("theta.tables", sync=device):
            model = make_model(mu, sigma, u, kappa, kappa_fixed=is_kappa_fixed, d_max=4096,
                               dtype=weight_dtype, device=device)
            E = emission_log_prob_table(n_meth, n_total, model.alpha, model.beta, dtype=weight_dtype)
        if estimate_parameters:
            gen = torch.Generator().manual_seed(int(rng_seed))
            theta_init = torch.randn((model.dim_theta,), generator=gen, dtype=torch.float64).numpy()
        else:
            p_mat = default_p(R) if p is None else np.asarray(p, np.float64)
            theta_init = parameters_to_theta(p_mat, np.asarray(omega), kappa, kappa_fixed=is_kappa_fixed)

        cfg = EngineConfig(
            n_particles_max=n_particles,
            epsilon=epsilon,
            smoothing_window=smoothing_window,
            estimate_regimes=estimate_regime_probabilities,
            estimate_parameters=estimate_parameters,
            steps_per_update=n_steps_without_parameter_update,
            learning_rate_exponent=learning_rate_exponent,
            learning_rate_factor=learning_rate_factor,
            use_adam=use_adam,
            normalise_gradients=normalise_gradients,
            progress_every=progress_every,
        )
        with spans.span("theta.engine", sync=device):
            res = run_online_combined_inference(
                model, theta_init, E, cfg, n_units=1,
                generator=torch.Generator(device=device).manual_seed(int(rng_seed)),
                weight_dtype=weight_dtype, sites_per_graph=sites_per_graph,
            )

        with spans.span("theta.write"):
            if estimate_regime_probabilities and regime_probabilities_csv_file:
                hio.write_headed_table(
                    regime_probabilities_csv_file, res.regime_probs[0].cpu().numpy(),
                    [f"regime_{i + 1}" for i in range(R)], first=("genomic_position", positions[:T]),
                )
            if estimate_parameters:
                trace = res.theta_trace[0].cpu().numpy()
                if theta_trace_csv_file:
                    hio.write_headed_table(
                        theta_trace_csv_file, trace, [f"theta_{i + 1}" for i in range(trace.shape[1])]
                    )
                final = theta_to_parameters(trace[-1], R, kappa_fixed=is_kappa_fixed)
                hio.write_headed_table(p_csv_file, final["p"], [f"regime_{i + 1}" for i in range(R)])
                hio.write_headed_column(omega_csv_file, final["omega"], "omega")
                hio.write_headed_column(kappa_csv_file, final.get("kappa", kappa), "kappa")
                hio.write_theta(theta_file, trace[-1])
    return res


def simulate_data(
    *,
    regimes_csv_file,
    n_methylated_reads_csv_file,
    genomic_positions_csv_file,
    n_total_reads_csv_file,
    device,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    p=None,
    omega=DEFAULT_OMEGA,
    kappa=(2.0,) * 6,
    u=2,
    n_samples=2,
    n_cpg_sites=1000,
    lambda_reads=20.0,
    rng_seed=0,
):
    """Simulate a single-group chromosome on ``device`` and write the JAX
    verb's headed CSVs (regimes, positions 1..T, total and methylated
    reads, samples as rows). The depths are the JAX verb's bit for bit
    (``np.random.default_rng(rng_seed).poisson``); the chain and the counts
    come from a ``torch.Generator`` on ``device`` seeded with ``rng_seed``,
    with float32 tables, as the JAX CLI builds them. Returns the
    SingleGroupSimulation (tensors on ``device``)."""
    device = torch.device(device)
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    model = make_model(mu, sigma, u, np.asarray(kappa), d_max=4096, device=device)
    p_mat = default_p(R) if p is None else np.asarray(p, np.float64)
    theta = parameters_to_theta(p_mat, np.asarray(omega), np.asarray(kappa))

    rng = np.random.default_rng(rng_seed)
    n_total = rng.poisson(lambda_reads, size=(n_cpg_sites, n_samples)).astype(np.float64)
    sim = sg_simulate.simulate(
        model, torch.as_tensor(theta, dtype=torch.float32, device=device), n_total,
        generator=torch.Generator(device=device).manual_seed(int(rng_seed)),
    )
    positions = np.arange(1, n_cpg_sites + 1)

    hio.write_headed_column(regimes_csv_file, sim.r.cpu().numpy(), "regime")
    hio.write_headed_column(genomic_positions_csv_file, positions, "genomic_positions")
    hio.write_headed_matrix(n_total_reads_csv_file, n_total.T, "sample")
    hio.write_headed_matrix(n_methylated_reads_csv_file, sim.n_methylated.cpu().numpy().T, "sample")
    return sim


def replicate_generators(device, rng_seed, n_replicates):
    """One generator a replicate on ``device``, seeded from
    ``np.random.SeedSequence(rng_seed)``'s independent children."""
    children = np.random.SeedSequence(int(rng_seed)).spawn(int(n_replicates))
    return [torch.Generator(device=device).manual_seed(int(c.generate_state(1, np.uint32)[0]))
            for c in children]


def approximate_log_normalizing_constant(
    *,
    n_replicates,
    n_methylated_reads,
    n_total_reads,
    device,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    u=2,
    kappa=(2.0,) * 6,
    omega=DEFAULT_OMEGA,
    p=None,
    n_particles=250,
    rng_seed=0,
    weight_dtype=torch.float32,
):
    """Independent replicate estimates (n_replicates,) of the
    log-normalising constant of (T, S) counts at fixed theta.

    The JAX package vmaps one engine run over replicate keys; here the
    replicates are the U units of one engine call on ``device``, with both
    estimates off: one resampler launch a site serves all of them. Replicate
    i draws from its own generator (``replicate_generators``), so its
    estimate is that of a one-unit run on that generator."""
    device = torch.device(device)
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    model = make_model(mu, sigma, u, np.asarray(kappa), d_max=4096, dtype=weight_dtype, device=device)
    p_mat = default_p(R) if p is None else np.asarray(p, np.float64)
    theta = parameters_to_theta(p_mat, np.asarray(omega), np.asarray(kappa))
    E = emission_log_prob_table(np.asarray(n_methylated_reads), np.asarray(n_total_reads),
                                model.alpha, model.beta, dtype=weight_dtype)
    cfg = EngineConfig(n_particles_max=n_particles, estimate_regimes=False, estimate_parameters=False)
    res = run_online_combined_inference(
        model, theta, E, cfg, n_units=int(n_replicates),
        generator=replicate_generators(device, rng_seed, n_replicates), weight_dtype=weight_dtype,
    )
    return res.log_normalizing_constant.cpu().numpy()
