"""The ``estimate_parameters_and_regimes`` verb.

Counterpart of hygeia_tpu/single_group/runner.py (``default_p``,
``estimate_parameters_and_regimes``): the same flags, input files, output
files, headers and column names, driving the port's engine on one device
with one unit. ``simulate_data`` and ``approximate_log_normalizing_constant``
are not ported yet (ROADMAP.md, items 13 and 15).
"""

from __future__ import annotations

import numpy as np
import torch

from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
from hygeia_tpu_torch.single_group.engine import EngineConfig, run_online_combined_inference
from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta, theta_to_parameters
from hygeia_tpu_torch.utils import io as hio

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
):
    """Run the single-group engine on one chromosome's headed count files
    on ``device`` and write the requested outputs. Returns the
    EngineResult (one unit).

    With ``estimate_parameters`` the initial theta is drawn from N(0, I) by
    a CPU ``torch.Generator`` seeded with ``rng_seed`` (the JAX package
    draws it with ``jax.random.normal``, so the two start from different
    theta); the resampler's uniforms come from a generator on ``device``
    seeded with ``rng_seed``."""
    device = torch.device(device)
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    kappa = np.asarray(kappa, np.float64)
    model = make_model(mu, sigma, u, kappa, kappa_fixed=is_kappa_fixed, d_max=4096,
                       dtype=weight_dtype, device=device)

    positions = hio.read_headed_column(genomic_positions_csv_file).astype(np.int64)
    # Headed matrices come back (n_samples, n_sites); the engine takes (T, S).
    n_total = hio.read_headed_matrix(n_total_reads_csv_file).T
    n_meth = hio.read_headed_matrix(n_methylated_reads_csv_file).T
    T = n_total.shape[0]

    if estimate_parameters:
        gen = torch.Generator().manual_seed(int(rng_seed))
        theta_init = torch.randn((model.dim_theta,), generator=gen, dtype=torch.float64).numpy()
    else:
        p_mat = default_p(R) if p is None else np.asarray(p, np.float64)
        theta_init = parameters_to_theta(p_mat, np.asarray(omega), kappa, kappa_fixed=is_kappa_fixed)

    E = emission_log_prob_table(n_meth, n_total, model.alpha, model.beta, dtype=weight_dtype)
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
    res = run_online_combined_inference(
        model, theta_init, E, cfg, n_units=1,
        generator=torch.Generator(device=device).manual_seed(int(rng_seed)),
        weight_dtype=weight_dtype,
    )

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
