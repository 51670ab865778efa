"""The port's command-line interface: the ``infer`` verb.

    python -m hygeia_tpu_torch.cli infer --data_dir ... --device cuda

Same flags as ``hygeia_tpu.cli infer``, plus ``--device`` (default
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
                    help="checkpointed streaming backward: not ported yet, raises")
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
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda); raises if it is not available")
    return p


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


def main(argv=None):
    args = build_parser().parse_args(argv)
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
