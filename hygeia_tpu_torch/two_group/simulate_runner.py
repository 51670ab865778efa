"""The ``simulate_two_groups`` verb: generative simulation and the optional
self-test inference (the reference's own integration test).

Counterpart of hygeia_tpu/two_group/simulate_runner.py, with the same flags,
files and printed lines:

* ``REGIME_CONFIGS``: a copy of the reference's 10 (mu, sigma) presets
  (config 10 has 5 regimes);
* the random off-diagonal transition matrix and the Poisson read depths
  come from ``np.random.default_rng(seed)`` exactly as the JAX verb draws
  them, so P, ``n_total_reads_*`` and the missing-data mask are the JAX
  verb's bit for bit (``simulation_inputs``);
* the chain and the counts come from two_group/simulate.py on ``device``
  with a ``torch.Generator``, so the states and counts are another
  realisation than the JAX verb's (threefry);
* ``--run_inference`` runs the port's ``run_filter`` (the CUDA resampler
  on the card), ``backward_simulation`` and ``smoothing_functionals`` and
  writes the five ``optimal_*_{N}_{seed}.npz`` files.

The control omega logit. The JAX verb computes ``logit(jnp.full((R,),
omega_control))`` in float32 when JAX runs without x64, which is how its
CLI runs (in float64 under the tests' x64 setting). The port takes the
CLI's float32 value: XLA's CPU float32 ``log`` and ``log1p``, replayed in
ops/xla_f32.py, then the float32 difference.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from hygeia_tpu_torch.ops import xla_f32
from hygeia_tpu_torch.ops.site_graphs import _sync
from hygeia_tpu_torch.two_group.backward import backward_simulation, smoothing_functionals
from hygeia_tpu_torch.two_group.filter import run_filter
from hygeia_tpu_torch.two_group.model import make_params
from hygeia_tpu_torch.two_group.runner import _emission_tables, _generator
from hygeia_tpu_torch.two_group.simulate import simulate
from hygeia_tpu_torch.utils import io as hio

REGIME_CONFIGS = {
    1: ([0.95, 0.05, 0.85, 0.15, 0.50, 0.50],
        [0.10, 0.10, 0.08, 0.08, 0.15, 1 / np.sqrt(12)]),
    2: ([0.95, 0.05, 0.85, 0.15, 0.50, 0.50],
        [0.10, 0.10, 0.04, 0.04, 0.15, 1 / np.sqrt(12)]),
    3: ([0.95, 0.05, 0.85, 0.15, 0.50, 0.50],
        [0.15, 0.15, 0.08, 0.08, 0.15, 1 / np.sqrt(12)]),
    4: ([0.95, 0.05, 0.85, 0.15, 0.50, 0.50],
        [0.15, 0.15, 0.04, 0.04, 0.15, 1 / np.sqrt(12)]),
    5: ([0.99, 0.01, 0.80, 0.20, 0.50, 0.50],
        [0.05, 0.05, 0.05, 0.05, 0.10, 1 / np.sqrt(6)]),
    6: ([0.99, 0.01, 0.80, 0.20, 0.50, 0.50],
        [0.05, 0.05, 0.10, 0.10, 0.10, 1 / np.sqrt(6)]),
    7: ([0.95, 0.05, 0.85, 0.15, 0.50, 0.50],
        [0.05, 0.05, 0.05, 0.05, 0.05, 1 / np.sqrt(12)]),
    8: ([0.95, 0.05, 0.80, 0.20, 0.50, 0.50],
        [0.05, 0.05, 0.10, 0.10, 0.10, 1 / np.sqrt(12)]),
    9: ([0.95, 0.05, 0.75, 0.25, 0.50, 0.50],
        [0.10, 0.10, 0.10, 0.10, 0.10, 1 / np.sqrt(12)]),
    10: ([0.95, 0.05, 0.80, 0.20, 0.50],
         [0.05, 0.05, 0.10, 0.10, 0.10]),
}

# The simulation's generator stream; runner._generator's streams 0 and 1
# are the filter's and the backward pass's.
_SIMULATION_STREAM = 2


def logit_f32(omega, n_regimes):
    """logit(omega) of an (R,) float32 vector as the JAX CLI computes it:
    log(x) - log1p(-x), each XLA's CPU float32 function."""
    x = torch.full((n_regimes,), float(omega), dtype=torch.float32)
    return (xla_f32.log(x) - xla_f32.log1p(-x)).numpy()


def simulation_inputs(args):
    """(mu, sigma, log_p, n_total_control, n_total_case): the regime
    parameters, the log of the random off-diagonal transition matrix and
    the (T, S) float64 Poisson depths (0 where masked as missing), drawn
    from ``np.random.default_rng(args.seed)`` in the JAX verb's order."""
    mu, sigma = args.mu, args.sigma
    cfg = getattr(args, "regimes_config", None)
    if cfg:
        mu, sigma = REGIME_CONFIGS[cfg]
    R = len(mu)
    rng = np.random.default_rng(args.seed)
    logits = rng.normal(size=(R, R))
    np.fill_diagonal(logits, -np.inf)
    with np.errstate(over="ignore"):
        p = np.exp(logits - np.nanmax(np.where(np.isfinite(logits), logits, np.nan)))
    p = np.where(np.isfinite(logits), p, 0.0)
    p = p / p.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        log_p = np.log(p)

    T, S = args.n_observations, args.n_samples
    n_c = rng.poisson(args.lambda_reads, size=(T, S)).astype(np.float64)
    n_k = rng.poisson(args.lambda_reads, size=(T, S)).astype(np.float64)
    if args.missing_prob > 0:
        n_c *= rng.random((T, S)) > args.missing_prob
        n_k *= rng.random((T, S)) > args.missing_prob
    return mu, sigma, log_p, n_c, n_k


def write_simulation(results_dir, states, obs_control, obs_case, n_c, n_k):
    """The JAX verb's simulation files: true_{merged,control,case}_states.npz
    and the gzipped observation and depth tables (``np.savetxt``, "%s")."""
    hio.savez_fast(os.path.join(results_dir, "true_merged_states"), states[:, 0])
    hio.savez_fast(os.path.join(results_dir, "true_control_states"), states[:, 1:3])
    hio.savez_fast(os.path.join(results_dir, "true_case_states"), states[:, 3:5])
    for name, arr in (("observations_control", obs_control), ("observations_case", obs_case),
                      ("n_total_reads_control", n_c), ("n_total_reads_case", n_k)):
        np.savetxt(os.path.join(results_dir, f"{name}.csv.gz"), np.asarray(arr), delimiter=",", fmt="%s")


def write_inference(results_dir, N, seed, traj, split, regime):
    """The five self-test archives, the JAX verb's names and dtypes; traj
    (T, B, 5) int32."""
    for name, arr in (("backward_particles_merged_state", traj[:, :, 0].astype(np.int16)),
                      ("backward_particles_control_state", traj[:, :, 1:3].astype(np.int32)),
                      ("backward_particles_case_state", traj[:, :, 3:5].astype(np.int32)),
                      ("split_probs", split), ("regime_probs", regime)):
        hio.savez_fast(os.path.join(results_dir, f"optimal_{name}_{N}_{seed}"), arr)


def simulation_params(args, device):
    """(params on ``device``, n_total_control, n_total_case): the verb's
    model parameters and (T, S) depths (``simulation_inputs``)."""
    mu, sigma, log_p, n_c, n_k = simulation_inputs(args)
    R = len(mu)
    params = make_params(
        mu=mu,
        sigma=sigma,
        p_softmax_control=log_p,
        omega_logit_control=logit_f32(args.omega_control, R),
        omega_case=args.omega_case,
        kappa_control=np.full(R, 2.0),
        kappa_case=np.full(R, 2.0),
        merge_log_prob=args.merge_log_prob,
        split_prob=args.split_prob,
        minimum_duration=args.minimum_duration,
        d_max=max(64, args.n_observations + 1),
        device=device,
    )
    return params, n_c, n_k


def simulate_two_groups(args, device):
    """Simulate on ``device`` and write the JAX verb's files under
    ``args.results_dir``; with ``args.run_inference`` also run the filter
    and the backward pass there. Returns a dict: the states, the wall
    seconds of the simulation (``simulate_s``), and with inference
    ``log_z``, ``recovery`` (control-regime recovery), ``degenerate_steps``,
    ``filter_s`` and ``backward_s``."""
    device = torch.device(device)
    os.makedirs(args.results_dir, exist_ok=True)
    params, n_c, n_k = simulation_params(args, device)
    R = params.n_regimes
    T = args.n_observations
    _sync(device)
    t0 = time.perf_counter()
    sim = simulate(params, n_c, n_k, generator=_generator(device, [args.seed], _SIMULATION_STREAM))
    states = sim.states.cpu().numpy()
    obs_c, obs_k = sim.obs_control.cpu().numpy(), sim.obs_case.cpu().numpy()
    out = {"states": states, "simulate_s": time.perf_counter() - t0}
    write_simulation(args.results_dir, states, obs_c, obs_k, n_c, n_k)
    print(f"Simulated {T} sites; split fraction {float(np.mean(states[:, 0] == 0)):.3f}")
    if not args.run_inference:
        return out

    M = args.num_resampled_particles
    N = M * (2 * R + R * R)
    E_c, E_k = _emission_tables(obs_c, n_c, obs_k, n_k, params, False, None)
    _sync(device)
    t0 = time.perf_counter()
    res = run_filter(params, E_c, E_k, M, n_units=1, generator=_generator(device, [args.seed], 0))
    _sync(device)
    t1 = time.perf_counter()
    traj = backward_simulation(params, res.log_weights, res.particles, args.num_samples_backward,
                               generator=_generator(device, [args.seed], 1))
    split, regime = smoothing_functionals(traj, R)
    _sync(device)
    t2 = time.perf_counter()
    log_z = float(res.log_normalizing_constant[0])
    traj, split, regime = traj[0].cpu().numpy(), split[0].cpu().numpy(), regime[0].cpu().numpy()
    write_inference(args.results_dir, N, args.seed, traj, split, regime)
    acc = float(np.mean(regime[:, :R].argmax(-1) == states[:, 2]))
    print(f"self-test: logZ={log_z:.2f}, control-regime recovery {acc:.3f}")
    out.update(log_z=log_z, recovery=acc, degenerate_steps=int(res.degenerate_steps[0]),
               filter_s=t1 - t0, backward_s=t2 - t1, N=N)
    return out
