"""The port's command-line interface: the ``estimate_parameters_and_regimes``
and ``infer`` verbs.

    python -m hygeia_tpu_torch.cli estimate_parameters_and_regimes ... --device cuda
    python -m hygeia_tpu_torch.cli infer --data_dir ... --device cuda

Same flags as the verbs of ``hygeia_tpu.cli``, plus ``--device`` (default
``cuda``). There is no fallback: when the device asked for is not there,
the command raises; it never carries on on the CPU. The CPU path exists for
the tests, which pass ``--device cpu`` themselves.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _csv_floats(s):
    return [float(x) for x in s.split(",")]


def build_parser():
    p = argparse.ArgumentParser(prog="hygeia_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="verb", required=True)

    sp = sub.add_parser("infer", help="two-group inference on one segment")
    sp.add_argument("--mu", type=_csv_floats, default=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50])
    sp.add_argument("--sigma", type=_csv_floats, default=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751])
    sp.add_argument("--minimum_duration", type=int, default=3)
    sp.add_argument("--omega_case", type=float, default=0.8)
    sp.add_argument("--merge_log_prob", type=float, default=float(np.log(0.1)))
    sp.add_argument("--split_prob", type=float, default=0.01)
    sp.add_argument("--num_resampled_particles", type=int, action="append", default=None)
    sp.add_argument("--num_samples_backward", type=int, default=25)
    sp.add_argument("--multinomial", action="store_true",
                    help="recorded in the flags files; as in hygeia_tpu the optimal "
                         "resampler is always used (its fallback is multinomial)")
    sp.add_argument("--robust", action="store_true",
                    help="robust (beta-divergence) emissions: not ported yet, raises")
    sp.add_argument("--robust_beta", type=float, default=0.05)
    sp.add_argument("--marginal", action="store_true",
                    help="adaptive-lag marginal filter: not ported yet, raises")
    sp.add_argument("--marginal_epsilon", type=float, default=0.01)
    sp.add_argument("--marginal_window", type=int, default=64)
    sp.add_argument("--streaming_blocks", type=int, default=None,
                    help="checkpointed streamed filter and backward pass in blocks of this "
                         "many sites: one block of history on the device; the same outputs "
                         "as without it")
    sp.add_argument("--trace_dir", default=None,
                    help="profiler trace of the device computation: not ported yet, raises")
    sp.add_argument("--chrom", default="22")
    sp.add_argument("--results_dir", default="test")
    sp.add_argument("--data_dir", default="data")
    sp.add_argument("--single_group_dir", default="single_group_results")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--batch", type=int, default=0)
    sp.add_argument("--segment_size", type=int, default=100000)
    sp.add_argument("--buffer_size", type=int, default=5000)
    _add_device(sp)

    sp = sub.add_parser("estimate_parameters_and_regimes",
                        help="single-group engine: regime probabilities and theta")
    sp.add_argument("--mu", type=_csv_floats, default=[0.99, 0.01, 0.80, 0.20, 0.50, 0.50])
    sp.add_argument("--sigma", type=_csv_floats, default=[0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751])
    sp.add_argument("--u", type=int, default=2)
    sp.add_argument("--kappa", type=_csv_floats, default=[2.0] * 6)
    sp.add_argument("--omega", type=_csv_floats, default=[0.995, 0.975, 0.950, 0.925, 0.900, 0.900])
    sp.add_argument("--p_input_csv_file", default=None)
    sp.add_argument("--kappa_input_csv_file", default=None)
    sp.add_argument("--omega_input_csv_file", default=None)
    sp.add_argument("--n_methylated_reads_csv_file", required=True)
    sp.add_argument("--genomic_positions_csv_file", required=True)
    sp.add_argument("--n_total_reads_csv_file", required=True)
    sp.add_argument("--regime_probabilities_csv_file", default=None)
    sp.add_argument("--theta_trace_csv_file", default=None)
    sp.add_argument("--omega_csv_file", default="omega.csv")
    sp.add_argument("--kappa_csv_file", default="kappa.csv")
    sp.add_argument("--p_csv_file", default="p.csv")
    sp.add_argument("--theta_file", default="theta.csv")
    sp.add_argument("--is_kappa_fixed", type=lambda s: s.lower() != "false", default=True)
    sp.add_argument("--n_particles", type=int, default=250)
    sp.add_argument("--estimate_regime_probabilities", action="store_true")
    sp.add_argument("--estimate_parameters", action="store_true")
    sp.add_argument("--epsilon", type=float, default=0.01)
    sp.add_argument("--normalise_gradients", type=lambda s: s.lower() == "true", default=False)
    sp.add_argument("--use_adam", type=lambda s: s.lower() != "false", default=True)
    sp.add_argument("--n_steps_without_parameter_update", type=int, default=200)
    sp.add_argument("--learning_rate_exponent", type=float, default=0.1)
    sp.add_argument("--learning_rate_factor", type=float, default=0.01)
    sp.add_argument("--rng_seed", type=int, default=0)
    sp.add_argument("--progress_every", type=int, default=1000,
                    help="print engine progress every N sites, 0 = off")
    _add_device(sp)
    return p


def _add_device(sp):
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda); raises if it is not available")


def resolve_device(name) -> torch.device:
    """The torch.device asked for; raises when it is a CUDA device and CUDA
    is not available (no silent move to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: CUDA is not available on this host "
                "(pass --device cpu to run the plain PyTorch path)"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"--device {name}: only {torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise RuntimeError(f"--device {name}: only cuda and cpu are supported")
    return dev


def _estimate_parameters_and_regimes(args):
    from hygeia_tpu_torch.single_group.runner import estimate_parameters_and_regimes
    from hygeia_tpu_torch.utils import io as hio

    device = resolve_device(args.device)
    p = None
    if args.p_input_csv_file:
        p = hio.read_headed_table(args.p_input_csv_file)[1]
    omega = args.omega
    if args.omega_input_csv_file:
        omega = hio.read_headed_column(args.omega_input_csv_file)
    kappa = args.kappa
    if args.kappa_input_csv_file:
        kappa = hio.read_headed_column(args.kappa_input_csv_file)
    return estimate_parameters_and_regimes(
        n_methylated_reads_csv_file=args.n_methylated_reads_csv_file,
        genomic_positions_csv_file=args.genomic_positions_csv_file,
        n_total_reads_csv_file=args.n_total_reads_csv_file,
        device=device,
        mu=args.mu,
        sigma=args.sigma,
        u=args.u,
        kappa=kappa,
        omega=omega,
        p=p,
        is_kappa_fixed=args.is_kappa_fixed,
        n_particles=args.n_particles,
        estimate_regime_probabilities=args.estimate_regime_probabilities,
        estimate_parameters=args.estimate_parameters,
        epsilon=args.epsilon,
        normalise_gradients=args.normalise_gradients,
        use_adam=args.use_adam,
        n_steps_without_parameter_update=args.n_steps_without_parameter_update,
        learning_rate_exponent=args.learning_rate_exponent,
        learning_rate_factor=args.learning_rate_factor,
        rng_seed=args.rng_seed,
        regime_probabilities_csv_file=args.regime_probabilities_csv_file,
        theta_trace_csv_file=args.theta_trace_csv_file,
        p_csv_file=args.p_csv_file,
        omega_csv_file=args.omega_csv_file,
        kappa_csv_file=args.kappa_csv_file,
        theta_file=args.theta_file,
        progress_every=args.progress_every,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.verb == "estimate_parameters_and_regimes":
        return _estimate_parameters_and_regimes(args)
    if args.verb == "infer":
        from hygeia_tpu_torch.two_group.runner import infer_segment

        return infer_segment(
            data_dir=args.data_dir,
            single_group_dir=args.single_group_dir,
            results_dir=args.results_dir,
            chrom=args.chrom,
            device=resolve_device(args.device),
            batch=args.batch,
            seed=args.seed,
            segment_size=args.segment_size,
            buffer_size=args.buffer_size,
            mu=args.mu,
            sigma=args.sigma,
            minimum_duration=args.minimum_duration,
            omega_case=args.omega_case,
            merge_log_prob=args.merge_log_prob,
            split_prob=args.split_prob,
            num_resampled_particles=tuple(args.num_resampled_particles or [50]),
            num_samples_backward=args.num_samples_backward,
            multinomial=args.multinomial,
            robust=args.robust,
            trace_dir=args.trace_dir,
            marginal=args.marginal,
            streaming_blocks=args.streaming_blocks,
        )


if __name__ == "__main__":
    main()
