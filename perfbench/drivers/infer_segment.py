"""Driver: two-group INFER, one ``infer_segment`` call a batch of seeds.

The window drives ``hygeia_tpu_torch.two_group.runner.infer_segment`` as
the upstream pipeline's INFER task runs it: call k takes batch
``batches[k % len(batches)]`` of the seeded chromosome (the interior
batches, each a segment with a halo on both sides) and seeds
``U k .. U k + U - 1`` as one call of U units. Set-up writes the
chromosome and the theta file, and runs one warm-up call at the cell's
widths (U, N, M, B, R) on the chromosome's first ``warmup_sites`` sites.

What the comparison reads, of every call of the window:
- the filter's state at site 0 and at ``check.sites_per_unit`` sites a
  unit drawn from the seed and the call's index inside the returned
  range (weights and particles at t - 1 and t), its per-site
  log-normaliser shifts and its degenerate-step count, taken from the
  ``run_filter`` result the call makes, copied to the host at the call
  (the copy is timed and taken out of the call's wall and of its filter
  span: ``untimed_s``);
- the emission tables the call built (its hazard tables are judged
  through the weights: alone they part float32 from bfloat16 by ~2x only,
  float32's lgamma of ~1e3 losing ~0.2% of the pmf);
- the files the call wrote: each unit's logZ, backward trajectories and
  split and regime probabilities.
The plain reference (``perfbench/reference/two_group.py``, float64, on the
CPU) works out the tables and the weights from the counts and the theta
file, and judges them (``judge``): the weights at each sampled site, the
resampling between t - 1 and t (K1: as many survivors as optimal
resampling keeps, and every particle it must keep kept), and the backward
draws into t and into t - 1, whose randomised probability integral
transform under the reference's kernel is uniform (``backward_pit_ks``).
"""

from __future__ import annotations

import ast
import contextlib
import io
import math
import os
import shutil
import time

import numpy as np
import torch

from perfbench import inputs
from perfbench.reference import two_group as ref

CHROM = "1"
WARM_CHROM = "w"


class Outputs:
    """What one call produced, for one unit: site 0's and the sampled
    sites' filter state, the shifts, logZ, degenerate steps, the
    trajectories over the returned range and the functionals; the call's
    tables."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        self.R = len(cfg["mu"])
        self.M = int(cfg["num_resampled_particles"])
        self.N = self.M * (2 * self.R + self.R * self.R)
        self.B = int(cfg["num_samples_backward"])
        self.seg, self.buf = int(cfg["segment_size"]), int(cfg["buffer_size"])
        self.U = int(tr["seeds_per_call"])
        n = int(tr["chromosome_sites"])
        self.batches = [b for b in range(1, n // self.seg) if (b + 1) * self.seg + self.buf <= n]
        if not self.batches:
            raise ValueError("the chromosome holds no interior batch")
        self.T = self.seg + 2 * self.buf
        self.ret = slice(self.buf, self.buf + self.seg)
        self.S = int(ctx.cell["check"]["sites_per_unit"])
        self.captured = {}
        self.untimed = {}
        self.current = None
        self.shapes = {"k1": {"units": self.U, "n": self.N, "m": self.M}}

    # ---- set-up ---------------------------------------------------------

    def setup(self):
        from hygeia_tpu_torch.two_group import runner

        ctx, cfg, tr = self.ctx, self.ctx.config, self.ctx.traffic
        self.runner = runner
        t0 = time.perf_counter()
        self.arrays = getattr(inputs, tr["generator"])(tr, cfg, ctx.seed)
        self.data_dir = str(ctx.workdir / "data")
        self.sg_dir = str(ctx.workdir / "single_group")
        inputs.write_chromosome(self.data_dir, CHROM, self.arrays)
        warm = int(tr["warmup_sites"])
        inputs.write_chromosome(self.data_dir, WARM_CHROM, {k: v[:warm] for k, v in self.arrays.items()})
        self.theta = inputs.theta_vector(cfg)
        for c in (CHROM, WARM_CHROM):
            inputs.write_theta(os.path.join(self.sg_dir, f"theta_{c}.csv.gz"), self.theta)
        self._install()
        t1 = time.perf_counter()
        self._infer(WARM_CHROM, 0, list(range(self.U)), str(ctx.workdir / "warmup"),
                    segment_size=warm, buffer_size=0)
        shutil.rmtree(ctx.workdir / "warmup", ignore_errors=True)
        ctx.log(f"set-up: inputs {t1 - t0:.3f} s, warm-up call {time.perf_counter() - t1:.3f} s")

    def _install(self):
        """Wrap the runner's filter and table builders so that each call's
        state and tables are kept for the check."""
        rn = self.runner
        run_filter, emission_tables = rn.run_filter, rn._emission_tables
        drv = self

        def filt(*a, **kw):
            res = run_filter(*a, **kw)
            if drv.current is not None:
                drv._timed("filter", drv._capture, res)
            return res

        def tables(*a, **kw):
            e = emission_tables(*a, **kw)
            if drv.current is not None:
                drv._timed("tables", lambda: drv.captured[drv.current].update(E=tuple(x.cpu() for x in e)))
            return e

        rn.run_filter, rn._emission_tables = filt, tables

    def _timed(self, where, fn, *a):
        """Run the check's copy ``fn`` once the program's queued work is done,
        and add its seconds to the call's untimed seconds at ``where``."""
        dev = self.ctx.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn(*a)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        u = self.untimed[self.current]
        u[where] = u.get(where, 0.0) + time.perf_counter() - t0

    def _sites(self, k):
        """Call k's sampled sites, drawn from the seed and k."""
        rng = np.random.default_rng([int(self.ctx.seed), 1, int(k)])
        lo, hi = max(1, self.buf), self.buf + self.seg - 1
        return np.sort(rng.choice(np.arange(lo, hi), min(self.S, hi - lo), replace=False))

    def _capture(self, res):
        k = self.current
        t = torch.as_tensor(self.captured[k]["sites"], device=res.log_weights.device)
        rows = torch.cat([t - 1, t])
        parts = torch.stack([p.index_select(1, rows).to(torch.int32) for p in res.particles], -1)
        parts0 = torch.stack([p[:, 0].to(torch.int32) for p in res.particles], -1)
        self.captured[k].update(
            lw=res.log_weights.index_select(1, rows).cpu(), parts=parts.cpu(),
            lw0=res.log_weights[:, 0].cpu(), parts0=parts0.cpu(), shifts=res.shifts.cpu(),
            init_shift=res.init_shift.cpu(), degen=res.degenerate_steps.cpu())

    def _infer(self, chrom, batch, seeds, results_dir, **kw):
        cfg = self.ctx.config
        with contextlib.redirect_stdout(io.StringIO()):
            self.runner.infer_segment(
                data_dir=self.data_dir, single_group_dir=self.sg_dir, results_dir=results_dir,
                chrom=chrom, device=self.ctx.device, batch=batch, seed=seeds,
                mu=cfg["mu"], sigma=cfg["sigma"], minimum_duration=cfg["minimum_duration"],
                omega_case=cfg["omega_case"], merge_log_prob=cfg["merge_log_prob"],
                split_prob=cfg["split_prob"], num_resampled_particles=(self.M,),
                num_samples_backward=self.B, **kw)

    # ---- the window -----------------------------------------------------

    def _call_args(self, k):
        return self.batches[k % len(self.batches)], [self.U * k + i for i in range(self.U)]

    def call(self, k):
        """One call of the window; its work, and ``untimed_s``: the seconds
        of the check's copies inside it, which the harness takes out of
        the call's wall."""
        batch, seeds = self._call_args(k)
        self.current = k
        self.captured[k] = {"sites": self._sites(k)}
        self.untimed[k] = {}
        try:
            self._infer(CHROM, batch, seeds, str(self.ctx.workdir / "results" / str(k)),
                        segment_size=self.seg, buffer_size=self.buf)
        finally:
            self.current = None
        return {"unit_sites": self.T * self.U, "sites": self.T, "units": self.U,
                "untimed_s": sum(self.untimed[k].values())}

    def _path(self, k):
        batch, _ = self._call_args(k)
        return os.path.join(str(self.ctx.workdir / "results" / str(k)), f"chrom_{CHROM}_{batch}")

    def spans(self, k):
        """The runner's own synced timers of call k: filter and backward
        seconds of the call (its files hold them a seed), the filter's less
        the check's copy of its state."""
        path, (_, seeds) = self._path(k), self._call_args(k)
        read = lambda name, s: ast.literal_eval(open(os.path.join(path, f"{name}_{s}.txt")).read())[self.N]
        return {"filter_s": sum(read("optimal_time", s) for s in seeds) - self.untimed[k].get("filter", 0.0),
                "backward_s": sum(read("optimal_time_backward", s) for s in seeds)}

    # ---- the check ------------------------------------------------------

    def collect(self, k):
        """[Outputs] of call k, one a unit, from what it kept and wrote."""
        batch, seeds = self._call_args(k)
        path, cap = self._path(k), self.captured[k]
        sites = cap["sites"]
        S = len(sites)
        v = np.random.default_rng([int(self.ctx.seed), 2, int(k)]).random((len(seeds), S, 2, self.B))
        j = torch.as_tensor(sites - self.buf)
        jp = (j - 1).clamp(min=0)
        outs = []
        for u, s in enumerate(seeds):
            load = lambda name: np.load(os.path.join(path, f"{name}_{self.N}_{s}.npz"))["arr_0"]
            pre = "optimal_backward_particles_"
            m = load(pre + "merged_state").astype(np.int64)
            c = load(pre + "control_state").astype(np.int64)
            kk = load(pre + "case_state").astype(np.int64)
            traj = torch.from_numpy(np.concatenate([m[..., None], c, kk], -1))
            with open(os.path.join(path, f"log_normalizing_constants_optimal_{s}.txt")) as f:
                log_z = ast.literal_eval(f.read())[self.N]
            outs.append(Outputs(
                batch=batch, sites=sites, has_prev=j >= 1, v=torch.from_numpy(v[u]),
                chosen=torch.stack([traj[jp], traj[j]], 1), nxt=torch.stack([traj[j], traj[j + 1]], 1),
                lw_prev=cap["lw"][u, :S], lw=cap["lw"][u, S:],
                parts_prev=cap["parts"][u, :S].long(), parts=cap["parts"][u, S:].long(),
                lw0=cap["lw0"][u], parts0=cap["parts0"][u].long(),
                shifts=cap["shifts"][u], init_shift=float(cap["init_shift"][u]),
                degen=int(cap["degen"][u]), log_z=float(log_z), traj=traj,
                split=torch.from_numpy(load("optimal_split_probs")),
                regime=torch.from_numpy(load("optimal_regime_probs")),
                E=cap["E"]))
        return outs

    def window_counts(self, batch):
        lo = batch * self.seg - self.buf
        sl = slice(lo, lo + self.T)
        a = self.arrays
        return (a["n_methylated_reads_control"][sl], a["n_total_reads_control"][sl],
                a["n_methylated_reads_case"][sl], a["n_total_reads_case"][sl])

    def model(self, batch, dtype=torch.float64):
        cfg = self.ctx.config
        log_p, omega = inputs.log_p_of_theta(self.theta, self.R)
        return ref.Model(mu=cfg["mu"], sigma=cfg["sigma"], log_p=log_p, omega_control=omega,
                         omega_case=cfg["omega_case"], kappa=cfg["kappa"],
                         merge_log_prob=cfg["merge_log_prob"], split_prob=cfg["split_prob"],
                         min_duration=cfg["minimum_duration"], d_max=max(64, self.T + 1),
                         counts=self.window_counts(batch), dtype=dtype)

    def judge(self, outs, models):
        """The numbers compared, from each call's [Outputs] and its
        float64 reference model."""
        n = dict(weights_tv=0.0, shift_gap=0.0, states=0, logz_gap=0.0, degenerate=0,
                 functionals_gap=0.0, paths=0, emission_gap=0.0, k1_survivors=0, k1_heavy_dropped=0,
                 k1_systematic_mismatch=0)
        R, M = self.R, self.M
        pit = []
        for call_outs, model in zip(outs, models):
            for o in call_outs:
                raw, bad = ref.first_weights(model, o.parts0, o.lw0, o.init_shift)
                tv, gap = ref.judge_site(raw, o.lw0, o.init_shift)
                n["weights_tv"], n["shift_gap"] = max(n["weights_tv"], tv), max(n["shift_gap"], gap)
                n["states"] += bad
                for i, t in enumerate(o.sites):
                    raw, bad = ref.step_weights(model, int(t), o.lw_prev[i], o.parts_prev[i], o.parts[i],
                                                o.lw[i], o.shifts[t - 1], M)
                    tv, gap = ref.judge_site(raw, o.lw[i], o.shifts[t - 1])
                    n["weights_tv"], n["shift_gap"] = max(n["weights_tv"], tv), max(n["shift_gap"], gap)
                    n["states"] += bad
                    gap, dropped = ref.resampling_faults(o.lw_prev[i], o.parts_prev[i], o.parts[i], o.lw[i], M, R)
                    n["k1_survivors"] += gap
                    n["k1_heavy_dropped"] += dropped
                    n["k1_systematic_mismatch"] = max(n["k1_systematic_mismatch"], ref.systematic_mismatch(
                        o.lw_prev[i], o.parts_prev[i], o.parts[i], o.lw[i], M, R))
                    for r, (lw, parts) in enumerate(((o.lw_prev[i], o.parts_prev[i]), (o.lw[i], o.parts[i]))):
                        if r == 1 or o.has_prev[i]:
                            u, impossible = ref.backward_pit(model, lw, parts, o.nxt[i, r], o.chosen[i, r], o.v[i, r])
                            pit.append(u)
                            n["paths"] += impossible
                total = o.init_shift + float(o.shifts.double().sum())
                n["logz_gap"] = max(n["logz_gap"], abs(o.log_z - total))
                n["degenerate"] += o.degen
                n["paths"] += ref.impossible_transitions(model, o.traj)
                n["paths"] += self._not_in_history(o)
                split, regime = ref.functionals(o.traj, R)
                gap = max(float((o.split[self.ret].double() - split).abs().max()),
                          float((o.regime[self.ret].double() - regime).abs().max()))
                n["functionals_gap"] = max(n["functionals_gap"], gap)
                for prog, want in zip(o.E, (model.E_c, model.E_k)):
                    err = (prog.double() - want.double()).abs() / want.double().abs().clamp(min=1.0)
                    n["emission_gap"] = max(n["emission_gap"], float(err.max()))
        n["backward_pit_ks"] = ref.ks_sqrt_n(torch.cat(pit)) if pit else math.inf
        return n

    def control(self, dtype=torch.bfloat16):
        """The numbers that the control reads: the reference computed in
        ``dtype`` put in the program's place, following the program's
        state at each sampled site, judged against the float64 reference."""
        calls = sorted(self.captured)
        outs = [self.collect(k) for k in calls]
        models = [self.model(o[0].batch) for o in outs]
        low = [self.model(o[0].batch, dtype) for o in outs]
        ctrl = [[self._control_outputs(o, lm, dtype) for o in call] for call, lm in zip(outs, low)]
        return self.judge(ctrl, models)

    def _control_outputs(self, o, model, dtype):
        raw, _ = ref.first_weights(model, o.parts0, o.lw0, o.init_shift)
        lw0, init_shift = ref.normalise(raw, dtype)
        shifts = o.shifts.clone().to(dtype)
        lw, chosen = [], o.chosen.clone()
        gen = torch.Generator().manual_seed(int(self.ctx.seed) % 2**63)
        for i, t in enumerate(o.sites):
            for r, (lw_r, parts_r) in enumerate(((o.lw_prev[i], o.parts_prev[i]), (o.lw[i], o.parts[i]))):
                if r == 1 or o.has_prev[i]:
                    chosen[i, r] = ref.backward_draw(model, lw_r, parts_r, o.nxt[i, r], gen)
            raw, _ = ref.step_weights(model, int(t), o.lw_prev[i], o.parts_prev[i], o.parts[i], o.lw[i],
                                      o.shifts[t - 1], self.M)
            w, shift = ref.normalise(raw, dtype)
            lw.append(w)
            shifts[t - 1] = shift
        split, regime = ref.functionals(o.traj, self.R, dtype)
        pad = lambda x: torch.cat([torch.zeros_like(x[:1]).expand(self.buf, *x.shape[1:]), x,
                                   torch.zeros_like(x[:1]).expand(self.buf, *x.shape[1:])])
        return Outputs(**{**o.__dict__, "chosen": chosen, "lw0": lw0, "init_shift": init_shift, "lw": torch.stack(lw),
                          "shifts": shifts, "log_z": float(init_shift + shifts.sum()), "degen": 0,
                          "split": pad(split), "regime": pad(regime), "E": (model.E_c, model.E_k)})

    def _not_in_history(self, o):
        """Sampled sites where a trajectory's state is no live particle of
        the filter's history (count of trajectory-sites)."""
        bad = 0
        for i, t in enumerate(o.sites):
            x = o.chosen[i, 1]  # (B, 5), the trajectories at t
            live = torch.isfinite(o.lw[i])
            hit = ((o.parts[i][None, :, :] == x[:, None, :]).all(-1) & live[None]).any(1)
            bad += int((~hit).sum())
        return bad

    def check(self, n_calls):
        limits = self.ctx.cell["limits"]
        calls = [k for k in range(n_calls) if k in self.captured]
        outs = [self.collect(k) for k in calls]
        models = [self.model(o[0].batch) for o in outs]
        numbers = self.judge(outs, models)
        for k in range(n_calls):
            shutil.rmtree(os.path.dirname(self._path(k)), ignore_errors=True)
        if not calls:
            numbers = {name: float("inf") for name in limits}
        return [{"name": name, "value": numbers[name], "limit": limits[name]} for name in limits]
