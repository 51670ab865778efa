"""The port's command-line interface:

  preprocess                        BED or gemBS -> per-chromosome count matrices
  get_chrom_segments                positions -> (chrom, segment_index) csv
  infer                             two-group filter + backward simulation
                                    (or the adaptive-lag marginal filter)
  aggregate                         merge per-(batch, seed) outputs
  get_dmps                          FDR-controlled DMP calling
  estimate_parameters_and_regimes   single-group online engine
  simulate_data                     single-group generative simulation
  simulate_two_groups               two-group generative simulation + self-test
  make_bed_file                     regime probabilities -> BED9 (+ bgzip, tabix)
  run --two_group                   the two-group pipeline, resumable
  run                               the single-group pipeline, resumable

    python -m hygeia_tpu_torch.cli run --two_group --output_dir out --chroms 22 \\
        --cpg_file_path cpg.tsv --control_data_path c.bed ... --device cuda
    python -m hygeia_tpu_torch.cli run --output_dir out --chroms 22 \\
        --cpg_file_path cpg.tsv --sample_sheet samples.csv --device cuda

Same flags and defaults as the verbs of ``hygeia_tpu.cli``; the verbs that
run the model or a simulator (``infer``, ``estimate_parameters_and_regimes``,
``run``, ``simulate_data``, ``simulate_two_groups``) take ``--device``
(default ``cuda``). There is no fallback: when the device asked for is not
there, the command raises; it never carries on on the CPU.
The CPU path exists for the tests, which pass ``--device cpu`` themselves.
The other verbs are host numpy work, as in the JAX package.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _csv_floats(s):
    return [float(x) for x in s.split(",")]


def build_parser():
    p = argparse.ArgumentParser(prog="hygeia_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="verb", required=True)

    sp = sub.add_parser("preprocess", help="BED -> count matrices")
    sp.add_argument("--cpg_file_path", required=True)
    sp.add_argument("--output_path", default="test")
    sp.add_argument("--case_data_path", action="append", default=[])
    sp.add_argument("--case_id_names", action="append", default=[])
    sp.add_argument("--control_data_path", action="append", default=[])
    sp.add_argument("--control_id_names", action="append", default=[])
    sp.add_argument("--chromosome", default="22")
    sp.add_argument("--format", choices=["bed", "gembs"], default="bed",
                    help="input flavour: bismark BED or gemBS tab files")

    sp = sub.add_parser("get_chrom_segments")
    sp.add_argument("--input_file", required=True)
    sp.add_argument("--chromosome", default="22")
    sp.add_argument("--segment_size", type=int, default=100000)
    sp.add_argument("--output_csv", default="chrom_segments.csv")

    sp = sub.add_parser("aggregate")
    sp.add_argument("--results_dir", required=True)
    sp.add_argument("--output_dir", required=True)
    sp.add_argument("--seeds", type=int, default=10)
    sp.add_argument("--chrom", default="22")
    sp.add_argument("--num_batches", type=int, default=30)
    sp.add_argument("--num_particles", type=int, default=2400)
    sp.add_argument("--compute_freqs", action="store_true")

    sp = sub.add_parser("get_dmps")
    sp.add_argument("--fdr_thresholds", type=float, action="append", default=None)
    sp.add_argument("--results_dir", required=True)
    sp.add_argument("--output_dir", required=True)
    sp.add_argument("--n_regimes", type=int, default=6)
    sp.add_argument("--chrom", default="21")
    sp.add_argument("--test_regime_combinations", action="store_true")

    sp = sub.add_parser("make_bed_file", help="regime probabilities -> BED9 track")
    sp.add_argument("--chr", required=True)
    sp.add_argument("--regimes_file", required=True)
    sp.add_argument("--output_file", required=True)
    sp.add_argument("--bgzip", action="store_true",
                    help="also bgzip-compress and tabix-index the BED")

    sp = sub.add_parser("run", help="the pipeline; resumable")
    sp.add_argument("--two_group", action="store_true")
    sp.add_argument("--output_dir", required=True)
    sp.add_argument("--chroms", type=lambda s: s.split(","), default=["chr21", "chr22"])
    sp.add_argument("--cpg_file_path", default=None)
    sp.add_argument("--preprocessed_dir", default=None)
    sp.add_argument("--sample_sheet", default=None,
                    help="CSV with id,file columns (single-group mode)")
    sp.add_argument("--max_retries", type=int, default=5, help="per-unit retries before ignore")
    sp.add_argument("--control_data_path", action="append", default=[])
    sp.add_argument("--control_id_names", action="append", default=[])
    sp.add_argument("--case_data_path", action="append", default=[])
    sp.add_argument("--case_id_names", action="append", default=[])
    sp.add_argument("--mu", type=_csv_floats, default=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50])
    sp.add_argument("--sigma", type=_csv_floats, default=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751])
    sp.add_argument("--min_cpg_sites_between_change_points", type=int, default=3)
    sp.add_argument("--batch_size", type=int, default=100000, help="segment size in CpG sites")
    sp.add_argument("--buffer_size", type=int, default=5000)
    sp.add_argument("--num_of_inference_seeds", type=int, default=2)
    sp.add_argument("--num_resampled_particles", type=int, default=50)
    sp.add_argument("--num_samples_backward", type=int, default=25)
    sp.add_argument("--n_particles", type=int, default=250)
    sp.add_argument("--run_streaming_blocks", type=int, default=None,
                    help="INFER units take the checkpointed streamed path in W-site blocks "
                         "(see infer --streaming_blocks)")
    sp.add_argument("--run_stream_batched", action="store_true",
                    help="with --run_streaming_blocks: the whole chromosome's (batch x seed) units in "
                         "shared streamed site loops (runner.infer_chromosome_streamed)")
    sp.add_argument("--no_resume", action="store_true")
    sp.add_argument("--bucket_dir", default=None,
                    help="mirror the output tree to a plain path or file:// URL (other schemes "
                         "through fsspec) after every completed stage, and restore it before a "
                         "resumed run")
    sp.add_argument("--stub_run", action="store_true", help="wire the stage tree with empty outputs")
    sp.add_argument("--mesh", default=None, metavar="GxS",
                    help="run INFER on a (genome x seed) mesh, e.g. 4x2: the chromosome's "
                         "(batch x seed) units in one batched site loop a rank (torchrun for "
                         "several ranks)")
    sp.add_argument("--boundary", default="halo", choices=["halo", "exchange"],
                    help="meshed-INFER block-join scheme (with --mesh): halo buffers, or "
                         "boundary messages between neighbouring windows")
    _add_device(sp)

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
                    help="use the robust (beta-divergence) emission score")
    sp.add_argument("--robust_beta", type=float, default=0.05)
    sp.add_argument("--marginal", action="store_true",
                    help="adaptive-lag marginal filter in place of the filter and backward "
                         "simulation (split and regime probabilities only; takes precedence "
                         "over --streaming_blocks)")
    sp.add_argument("--marginal_epsilon", type=float, default=0.01)
    sp.add_argument("--marginal_window", type=int, default=64)
    sp.add_argument("--streaming_blocks", type=int, default=None,
                    help="checkpointed streamed filter and backward pass in blocks of this "
                         "many sites: one block of history on the device; the same outputs "
                         "as without it")
    sp.add_argument("--trace_dir", default=None,
                    help="write a torch.profiler trace of the call here, its phases as named ranges")
    sp.add_argument("--chrom", default="22")
    sp.add_argument("--results_dir", default="test")
    sp.add_argument("--data_dir", default="data")
    sp.add_argument("--single_group_dir", default="single_group_results")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--batch", type=int, default=0)
    sp.add_argument("--segment_size", type=int, default=100000)
    sp.add_argument("--buffer_size", type=int, default=5000)
    _add_device(sp)

    sp = sub.add_parser("simulate_data", help="single-group generative simulation")
    sp.add_argument("--mu", type=_csv_floats, default=[0.99, 0.01, 0.80, 0.20, 0.50, 0.50])
    sp.add_argument("--sigma", type=_csv_floats, default=[0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751])
    sp.add_argument("--omega", type=_csv_floats, default=[0.995, 0.975, 0.950, 0.925, 0.900, 0.900])
    sp.add_argument("--kappa", type=_csv_floats, default=[2.0] * 6)
    sp.add_argument("--u", type=int, default=2)
    sp.add_argument("--n_samples", type=int, default=2)
    sp.add_argument("--n_cpg_sites", type=int, default=1000)
    sp.add_argument("--lambda_reads", type=float, default=20.0)
    sp.add_argument("--rng_seed", type=int, default=0)
    sp.add_argument("--regimes_csv_file", required=True)
    sp.add_argument("--n_methylated_reads_csv_file", required=True)
    sp.add_argument("--genomic_positions_csv_file", required=True)
    sp.add_argument("--n_total_reads_csv_file", required=True)
    _add_device(sp)

    sp = sub.add_parser("simulate_two_groups", help="two-group generative simulation + self-test")
    sp.add_argument("--mu", type=_csv_floats, default=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50])
    sp.add_argument("--sigma", type=_csv_floats, default=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751])
    sp.add_argument("--minimum_duration", type=int, default=3)
    sp.add_argument("--omega_case", type=float, default=0.8)
    sp.add_argument("--omega_control", type=float, default=0.8)
    sp.add_argument("--regimes_config", type=int, default=None, choices=range(1, 11),
                    help="use one of the reference's 10 fixed (mu, sigma) scenario presets")
    sp.add_argument("--merge_log_prob", type=float, default=float(np.log(0.1)))
    sp.add_argument("--split_prob", type=float, default=0.01)
    sp.add_argument("--n_observations", type=int, default=2000)
    sp.add_argument("--n_samples", type=int, default=2)
    sp.add_argument("--lambda_reads", type=float, default=20.0)
    sp.add_argument("--missing_prob", type=float, default=0.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--results_dir", required=True)
    sp.add_argument("--num_resampled_particles", type=int, default=50)
    sp.add_argument("--num_samples_backward", type=int, default=25)
    sp.add_argument("--run_inference", action="store_true",
                    help="also run the filter on the simulated data (self-test)")
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


def _preprocess(args):
    if args.format == "gembs":
        from hygeia_tpu_torch.pipeline.preprocess_gembs import process_gembs as process
    else:
        from hygeia_tpu_torch.pipeline.preprocess_bed import process_bed as process

    n = process(
        args.cpg_file_path, args.output_path, args.chromosome,
        control_data_paths=args.control_data_path,
        control_id_names=args.control_id_names or [f"control_{i}" for i in range(len(args.control_data_path))],
        case_data_paths=args.case_data_path,
        case_id_names=args.case_id_names or [f"case_{i}" for i in range(len(args.case_data_path))],
    )
    print(f"Successfully processed {n} CpG sites for chromosome {args.chromosome}")
    return n


def _run(args):
    if not args.two_group:
        return _run_single_group(args)
    from hygeia_tpu_torch.pipeline.orchestrator import run_two_group

    out = run_two_group(
        output_dir=args.output_dir,
        chroms=args.chroms,
        device=None if args.stub_run else resolve_device(args.device),
        cpg_file_path=args.cpg_file_path,
        preprocessed_dir=args.preprocessed_dir,
        control_data_paths=args.control_data_path,
        control_id_names=args.control_id_names,
        case_data_paths=args.case_data_path,
        case_id_names=args.case_id_names,
        mu=args.mu,
        sigma=args.sigma,
        u=args.min_cpg_sites_between_change_points,
        segment_size=args.batch_size,
        buffer_size=args.buffer_size,
        inference_seeds=tuple(range(args.num_of_inference_seeds)),
        num_resampled_particles=args.num_resampled_particles,
        num_samples_backward=args.num_samples_backward,
        n_particles_single_group=args.n_particles,
        resume=not args.no_resume,
        stub_run=args.stub_run,
        max_retries=args.max_retries,
        mesh_shape=tuple(int(x) for x in args.mesh.lower().split("x")) if args.mesh else None,
        boundary=args.boundary,
        streaming_blocks=args.run_streaming_blocks,
        stream_batched=args.run_stream_batched,
        bucket_dir=args.bucket_dir,
    )
    print(f"pipeline complete: {args.output_dir}")
    return out


def _run_single_group(args):
    """``run`` without ``--two_group``: the sample sheet's BED files through
    the single-group pipeline, with the run verb's own defaults (mu, sigma,
    u = --min_cpg_sites_between_change_points, N), as the JAX CLI passes
    them."""
    from hygeia_tpu_torch.pipeline.orchestrator import run_single_group

    if not args.sample_sheet:
        raise SystemExit("single-group `run` needs --sample_sheet (CSV with id,file columns) "
                         "plus --cpg_file_path")
    out = run_single_group(
        output_dir=args.output_dir,
        chroms=args.chroms,
        device=None if args.stub_run else resolve_device(args.device),
        sample_sheet=args.sample_sheet,
        cpg_file_path=args.cpg_file_path,
        mu=args.mu,
        sigma=args.sigma,
        u=args.min_cpg_sites_between_change_points,
        n_particles=args.n_particles,
        resume=not args.no_resume,
        stub_run=args.stub_run,
        max_retries=args.max_retries,
        bucket_dir=args.bucket_dir,
    )
    print(f"pipeline complete: {args.output_dir}")
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.verb == "estimate_parameters_and_regimes":
        return _estimate_parameters_and_regimes(args)
    if args.verb == "preprocess":
        return _preprocess(args)
    if args.verb == "get_chrom_segments":
        from hygeia_tpu_torch.pipeline.segments import write_chrom_segments

        write_chrom_segments(args.input_file, args.chromosome, args.segment_size, args.output_csv)
        print(f"Segment information saved to {args.output_csv}")
        return None
    if args.verb == "aggregate":
        from hygeia_tpu_torch.pipeline.aggregate import aggregate_chromosome

        return aggregate_chromosome(args.results_dir, args.output_dir, args.chrom, seeds=args.seeds,
                                    num_particles=args.num_particles, num_batches=args.num_batches,
                                    compute_freqs=args.compute_freqs)
    if args.verb == "get_dmps":
        from hygeia_tpu_torch.pipeline.dmps import call_dmps

        return call_dmps(args.results_dir, args.output_dir, args.chrom, n_regimes=args.n_regimes,
                         fdr_thresholds=tuple(args.fdr_thresholds or [0.01, 0.05]),
                         test_regime_combinations=args.test_regime_combinations)
    if args.verb == "make_bed_file":
        from hygeia_tpu_torch.pipeline.bed import make_bed

        make_bed(args.chr, args.regimes_file, args.output_file, compress=args.bgzip)
        print(f"Completed processing for chromosome {args.chr}")
        return None
    if args.verb == "run":
        return _run(args)
    if args.verb == "simulate_data":
        from hygeia_tpu_torch.single_group.runner import simulate_data

        sim = simulate_data(
            regimes_csv_file=args.regimes_csv_file,
            n_methylated_reads_csv_file=args.n_methylated_reads_csv_file,
            genomic_positions_csv_file=args.genomic_positions_csv_file,
            n_total_reads_csv_file=args.n_total_reads_csv_file,
            device=resolve_device(args.device),
            mu=args.mu,
            sigma=args.sigma,
            omega=args.omega,
            kappa=args.kappa,
            u=args.u,
            n_samples=args.n_samples,
            n_cpg_sites=args.n_cpg_sites,
            lambda_reads=args.lambda_reads,
            rng_seed=args.rng_seed,
        )
        print(f"Simulated {args.n_cpg_sites} CpG sites")
        return sim
    if args.verb == "simulate_two_groups":
        from hygeia_tpu_torch.two_group.simulate_runner import simulate_two_groups

        return simulate_two_groups(args, resolve_device(args.device))
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
            robust_beta=args.robust_beta,
            trace_dir=args.trace_dir,
            marginal=args.marginal,
            marginal_epsilon=args.marginal_epsilon,
            marginal_window=args.marginal_window,
            streaming_blocks=args.streaming_blocks,
        )


if __name__ == "__main__":
    main()
