"""Driver: the θ stage, one ``estimate_parameters_and_regimes`` call a
chromosome.

The window drives ``hygeia_tpu_torch.single_group.runner.
estimate_parameters_and_regimes`` as the upstream pipeline's
ESTIMATE_PARAMETERS_AND_REGIMES task runs it, with both estimates on: call
k reads the count files of slice k mod (chromosome_sites / sites_per_call)
of the seeded chromosome's control group, as one chromosome's files, runs
one chain from θ ~ N(0, I) (its rng seed drawn from the seed and k), and
writes the regime, θ-trace, P, ω, κ and θ files. Set-up writes the slices'
files and runs one warm-up call on the first ``warmup_sites`` sites. The
span recorder (``hygeia_tpu_torch.utils.spans``) is on during each call;
``spans(k)`` gives its totals.

What the comparison reads, of every call of the window: the engine's
state before and after ``check.steady_sites`` steady sites and
``check.update_sites`` update sites drawn from the seed and k, with the
tables in force; the final log-normaliser shifts and logZ; the files the
call wrote. No hook in the program gives the state: the driver wraps the
engine's ``_run_sites`` for the engine and its site loop, and splits the
loop's runs on the graph grid around each drawn site, so the same graphs
replay in the same order (a drawn steady site is one a run replays as a
one-site graph: its first, eager site, or one of the sites past its last
whole graph of K; an update site is a run of its own). The copies are
timed and taken out of the call's wall and its spans (``untimed_s``).

The plain reference (``perfbench/reference/single_group.py``, float64, on
the CPU) builds the emission table from the counts and the tables from the
program's θ, and from the program's state at t - 1 recomputes the weights
and the shift at t, K1's resampling (through the two-group reference's
checks), at update sites the score, the ADAM step and the rebuilt tables,
and the regime rows that the site finalised, which it compares with the
files as written.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import math
import os
import shutil
import time

import numpy as np
import torch

from perfbench import inputs
from perfbench.reference import single_group as ref
from perfbench.reference import two_group as tg

WARM = "warm"
STATE = ("d", "r", "w", "psi", "psi_time", "psi_valid", "theta", "spill")
UPDATE_STATE = ("phi", "score", "grad_prev", "adam_m", "adam_v", "adam_iter")
NUMBERS = dict(weights_tv=0.0, shift_gap=0.0, states=0, logz_gap=0.0, k1_survivors=0, k1_heavy_dropped=0,
               k1_systematic_mismatch=0, theta_gap=0.0, hazard_gap=0.0, regime_gap=0.0, regime_sum_gap=0.0,
               params_gap=0.0)


def write_headed_gz(path, columns):
    """A headed CSV (gzip level 1) of {name: 1-D integer array}."""
    names = list(columns)
    rows = np.stack([np.asarray(v, np.int64) for v in columns.values()], 1)
    body = "\n".join(",".join(map(str, r)) for r in rows.tolist()) + "\n"
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write((",".join(names) + "\n" + body).encode())


def read_headed(path):
    """(column names, float64 rows) of a headed CSV, gzipped or not."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.read().splitlines()
    rows = [ln.split(",") for ln in lines[1:] if ln.strip()]
    return lines[0].split(","), np.array(rows, dtype=np.float64).reshape(len(rows), -1)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        self.R = len(cfg["mu"])
        self.N = int(cfg["num_particles"])
        self.M = self.N - self.R
        self.T = int(tr["sites_per_call"])
        self.slices = int(tr["chromosome_sites"]) // self.T
        if self.slices < 1:
            raise ValueError("the chromosome holds no whole call")
        if int(tr["units_per_call"]) != 1:
            raise ValueError("the θ stage runs one chain a call")
        self.settings = ref.Settings(
            n_regimes=self.R, u=int(cfg["minimum_duration"]), kappa=float(cfg["kappa"]), d_max=int(cfg["d_max"]),
            n_particles=self.N, epsilon=float(cfg["epsilon"]), smoothing_window=int(cfg["smoothing_window"]),
            steps_per_update=int(cfg["n_steps_without_parameter_update"]),
            learning_rate_factor=float(cfg["learning_rate_factor"]),
            learning_rate_exponent=float(cfg["learning_rate_exponent"]))
        self.captured, self.untimed, self.totals = {}, {}, {}
        self.current = None
        self.shapes = {"k1": {"units": 1, "n": self.N, "m": self.M}}

    # ---- set-up ---------------------------------------------------------

    def setup(self):
        from hygeia_tpu_torch.single_group import engine, runner
        from hygeia_tpu_torch.utils import spans

        ctx, tr = self.ctx, self.ctx.traffic
        self.runner, self.engine, self.spans_mod = runner, engine, spans
        t0 = time.perf_counter()
        self.arrays = getattr(inputs, tr["generator"])(tr, ctx.config, ctx.seed)
        self.data_dir = ctx.workdir / "data"
        self.data_dir.mkdir(parents=True, exist_ok=True)
        for j in range(self.slices):
            self._write_slice(str(j), slice(j * self.T, (j + 1) * self.T))
        self._write_slice(WARM, slice(0, int(tr["warmup_sites"])))
        t1 = time.perf_counter()
        self._estimate(WARM, 0, ctx.workdir / "warmup")
        shutil.rmtree(ctx.workdir / "warmup", ignore_errors=True)
        ctx.log(f"set-up: inputs {t1 - t0:.3f} s, warm-up call {time.perf_counter() - t1:.3f} s")

    def _write_slice(self, name, sl):
        a = self.arrays
        cols = lambda x: {f"sample_{i + 1}": x[sl, i] for i in range(x.shape[1])}
        write_headed_gz(self.data_dir / f"n_methylated_reads_{name}.csv.gz", cols(a["n_methylated_reads_control"]))
        write_headed_gz(self.data_dir / f"n_total_reads_{name}.csv.gz", cols(a["n_total_reads_control"]))
        write_headed_gz(self.data_dir / f"genomic_positions_{name}.csv.gz", {"genomic_positions": a["positions"][sl]})

    @contextlib.contextmanager
    def _copying(self):
        """Within: the engine's ``_run_sites`` wrapped to keep the engine,
        draw the sites to copy and shadow its loop's ``run`` with one that
        splits the runs around them."""
        eng_mod = self.engine
        run_sites = eng_mod._run_sites
        drv = self

        def wrapped(eng, loop, start, stop, draws):
            drv.eng = eng
            runs = drv._schedule(eng, start, stop, loop.K)
            drv._draw(runs)
            base, pending = type(loop).run, iter(runs)

            def run(step, n, kind="site"):
                first, m, k, _ = next(pending)
                if (m, k) != (int(n), kind):
                    raise RuntimeError(f"the engine ran {n} sites of {kind!r}, the schedule says {m} of {k!r}")
                done = 0
                for t in sorted(drv.chosen & set(range(first, first + m))):
                    if t - first > done:
                        base(loop, step, t - first - done, kind)
                    drv._timed(drv._copy, t, "before", kind)
                    base(loop, step, 1, kind)
                    drv._timed(drv._copy, t, "after", kind)
                    done = t - first + 1
                if done < m:
                    base(loop, step, m - done, kind)

            loop.run = run
            try:
                return run_sites(eng, loop, start, stop, draws)
            finally:
                del loop.run

        eng_mod._run_sites = wrapped
        try:
            yield
        finally:
            eng_mod._run_sites = run_sites

    @staticmethod
    def _schedule(eng, start, stop, K):
        """The loop's runs over sites start..stop-1, as ``_run_sites`` groups
        them: [(first site, sites, kind, the sites a one-site unit holds)],
        the eager sites left out."""
        runs, seen, t = [], set(), start
        while t < stop:
            kind, end = eng.kind(t), t + 1
            while end < stop and eng.kind(end) == kind:
                end += 1
            if kind is not None:
                head = 0 if kind in seen else 1
                seen.add(kind)
                rest = (end - t - head) % K if K else end - t - head
                single = list(range(t, t + head)) + list(range(end - rest, end))
                runs.append((t, end - t, kind, single))
            t = end
        return runs

    def _draw(self, runs):
        """The sites whose state call k copies: ``check.steady_sites`` of the
        steady runs' one-site units and ``check.update_sites`` update sites,
        drawn from the seed and k."""
        k, chk = self.current, self.ctx.cell["check"]
        rng = np.random.default_rng([int(self.ctx.seed), 1, int(k)])
        steady = [t for _, _, kind, one in runs if kind == "steady" for t in one]
        update = [t for _, _, kind, one in runs if kind == "update" for t in one]
        pick = lambda xs, n: set(rng.choice(xs, min(n, len(xs)), replace=False).tolist()) if xs else set()
        self.chosen = pick(steady, int(chk["steady_sites"])) | pick(update, int(chk["update_sites"]))

    def _timed(self, fn, *a):
        """Run the check's copy ``fn`` once the program's queued work is done;
        add its seconds to the call's untimed seconds."""
        dev = self.ctx.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn(*a)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.untimed[self.current] += time.perf_counter() - t0

    def _copy(self, t, when, kind):
        eng = self.eng
        st = eng.state
        names = STATE + (UPDATE_STATE if kind == "update" else ())
        got = {n: (st[n][0].to("cpu", copy=True) if torch.is_tensor(st[n]) else st[n]) for n in names}
        if when == "before" or kind == "update":
            haz = eng.haz[0].reshape(eng.n_haz, self.R, -1).to("cpu", copy=True)
            got.update(rho=haz[0], exit=haz[1] > 0.5, grad=haz[2])
        self.captured[self.current]["sites"].setdefault(t, {"kind": kind})[when] = got

    def _estimate(self, name, rng_seed, out_dir):
        cfg = self.ctx.config
        os.makedirs(out_dir, exist_ok=True)
        f = lambda stem: str(out_dir / f"{stem}_{name}.csv.gz")
        d = lambda stem: str(self.data_dir / f"{stem}_{name}.csv.gz")
        with contextlib.redirect_stdout(io.StringIO()):
            return self.runner.estimate_parameters_and_regimes(
                n_methylated_reads_csv_file=d("n_methylated_reads"),
                genomic_positions_csv_file=d("genomic_positions"), n_total_reads_csv_file=d("n_total_reads"),
                device=self.ctx.device, mu=cfg["mu"], sigma=cfg["sigma"], u=cfg["minimum_duration"],
                kappa=(cfg["kappa"],) * self.R, is_kappa_fixed=True, n_particles=self.N,
                estimate_regime_probabilities=True, estimate_parameters=True, epsilon=cfg["epsilon"],
                use_adam=True, n_steps_without_parameter_update=cfg["n_steps_without_parameter_update"],
                learning_rate_exponent=cfg["learning_rate_exponent"],
                learning_rate_factor=cfg["learning_rate_factor"], rng_seed=rng_seed,
                regime_probabilities_csv_file=f("regime_probabilities"), theta_trace_csv_file=f("theta_trace"),
                p_csv_file=f("p"), omega_csv_file=f("omega"), kappa_csv_file=f("kappa"), theta_file=f("theta"),
                smoothing_window=cfg["smoothing_window"])

    # ---- the window -----------------------------------------------------

    def _rng_seed(self, k):
        return int(np.random.default_rng([int(self.ctx.seed), 3, int(k)]).integers(2**31))

    def _dir(self, k):
        return self.ctx.workdir / "results" / str(k)

    def call(self, k):
        """One call of the window; its work, and ``untimed_s``: the seconds
        of the check's copies inside it."""
        spans = self.spans_mod
        self.current = k
        self.captured[k] = {"sites": {}}
        self.untimed[k] = 0.0
        spans.drain()
        spans.enable()
        try:
            with self._copying():
                res = self._estimate(str(k % self.slices), self._rng_seed(k), self._dir(k))
        finally:
            spans.disable()
            got, counters = spans.drain()
        self.totals[k] = self._totals(got, counters, self.untimed[k])
        try:
            self._timed(lambda: self.captured[k].update(
                log_z=float(res.log_normalizing_constant[0]), shifts=self.eng.state["shifts"][0].to("cpu", copy=True)))
        finally:
            self.current = None
        return {"unit_sites": self.T, "sites": self.T, "units": 1, "untimed_s": self.untimed[k]}

    @staticmethod
    def _totals(got, counters, untimed):
        """Seconds of the call's spans (the root and the engine less the
        check's copies), the update runs' seconds and the site counters."""
        out = {}
        for s in got:
            key = s.name.replace(".", "_") + "_s"
            out[key] = out.get(key, 0.0) + s.seconds
            if s.name == "site_loop.run" and s.attrs.get("kind") == "update":
                out["update_runs_s"] = out.get("update_runs_s", 0.0) + s.seconds
        for key in ("theta_call_s", "theta_engine_s"):
            if key in out:
                out[key] -= untimed
        out.update({k.replace(".", "_"): v for k, v in counters.items()})
        return out

    def spans(self, k):
        return dict(self.totals.get(k, {}))

    # ---- the check ------------------------------------------------------

    def emissions(self, k):
        j = k % self.slices
        sl = slice(j * self.T, (j + 1) * self.T)
        cfg = self.ctx.config
        a, b = ref.alpha_beta(torch.tensor(cfg["mu"], dtype=torch.float64),
                              torch.tensor(cfg["sigma"], dtype=torch.float64))
        return ref.emission_table(self.arrays["n_methylated_reads_control"][sl],
                                  self.arrays["n_total_reads_control"][sl], a, b)

    def _files(self, k):
        """Call k's files. The θ trace and the θ file hold float32 values by
        their shortest repr, read back as those float32 values."""
        name = str(k % self.slices)
        read = lambda stem: read_headed(self._dir(k) / f"{stem}_{name}.csv.gz")[1]
        got = {stem: read(stem) for stem in ("regime_probabilities", "theta_trace", "p", "omega", "kappa", "theta")}
        for stem in ("theta_trace", "theta"):
            got[stem] = got[stem].astype(np.float32).astype(np.float64)
        return got

    def judge(self, k, n, dtype=None):
        """Fold call k's numbers into ``n``. ``dtype``: None judges the
        program; a dtype judges the control, the reference computed in that
        dtype put in the program's place."""
        s, R, M = self.settings, self.R, self.M
        n_dead = self.N - M - R
        cap = self.captured[k]
        E = self.emissions(k)
        files = self._files(k)
        rows = files["regime_probabilities"][:, 1:]
        tables = {}

        def tables_of(theta):
            key = theta.numpy().tobytes()
            if key not in tables:
                tables[key] = ref.Tables.of(theta, s)
            return tables[key]

        low = (lambda x: torch.as_tensor(x).to(dtype).to(torch.float64)) if dtype else None
        for t, rec in sorted(cap["sites"].items()):
            prev, cur = rec["before"], rec["after"]
            mine = tables_of(prev["theta"])
            n["hazard_gap"] = max(n["hazard_gap"], self._hazard_gap(mine, prev, dtype))
            tabs = mine.latched(prev["rho"], prev["exit"], prev["grad"])
            # Each ancestor's weight after resampling, and the one the
            # program's weight at t implies (its own less the continuation).
            factor = ref.reference_ancestor_weights(prev["w"], torch.arange(self.N), M)
            rho_c, exit_c, _ = tabs.lookup(cur["d"][:M] - 1, cur["r"][:M])
            cont = torch.where(exit_c | (rho_c > 1.0), ref.NEG, torch.log1p(-rho_c))
            implied = cur["w"][:M].double() + float(cap["shifts"][t]) - cont - E[t][cur["r"][:M].clamp(0, R - 1)]
            anc, bad = ref.read_ancestors(prev, cur, M, R, factor, implied)
            n["states"] += 0 if dtype else bad
            a = anc.clamp(min=0)
            anc_w = torch.where(anc >= 0, ref.reference_ancestor_weights(prev["w"], anc, M, implied), ref.NEG)
            raw, _, _, B, at_anc, at_prev = ref.propagate(tabs, E[t], prev["d"], prev["r"], prev["w"].double(),
                                                          a, anc_w, s)
            if dtype:
                w_t, shift_t = tg.normalise(raw, dtype)
            else:
                w_t, shift_t = cur["w"], float(cap["shifts"][t])
            tv, gap = tg.judge_site(raw, w_t, shift_t)
            n["weights_tv"], n["shift_gap"] = max(n["weights_tv"], tv), max(n["shift_gap"], gap)
            if not dtype:
                gap, dropped, mismatch = ref.k1_faults(prev, anc, M, R)
                n["k1_survivors"] += gap
                n["k1_heavy_dropped"] += dropped
                n["k1_systematic_mismatch"] = max(n["k1_systematic_mismatch"], mismatch)
            W = torch.exp(cur["w"].double())
            if rec["kind"] == "update":
                phi = ref.phi_step(tabs, prev["r"], prev["phi"], a, B, at_anc, at_prev, s)
                score = W @ phi
                args = prev["theta"], prev["adam_m"], prev["adam_v"], int(prev["adam_iter"])
                want, _, _ = ref.adam(*args, score - prev["grad_prev"].double(), s)
                if dtype:
                    got, _, _ = ref.adam(*args, (W.to(dtype) @ phi.to(dtype)) - prev["grad_prev"].to(dtype), s, dtype)
                else:
                    got = cur["theta"]
                n["theta_gap"] = max(n["theta_gap"], float((got.double() - want).abs().max()))
                n["hazard_gap"] = max(n["hazard_gap"], self._hazard_gap(tables_of(cur["theta"]), cur, dtype))
            # The regime rows this site finalised, against the files.
            psi = torch.where(prev["psi_valid"][:, None, None], ref.mix(prev["psi"].double(), a, B, n_dead, -1), 0.0)
            gone = prev["psi_valid"] & (~cur["psi_valid"] | (cur["psi_time"] != prev["psi_time"]))
            done = [(int(prev["psi_time"][e]), psi[e]) for e in torch.nonzero(gone)[:, 0].tolist()]
            new = torch.nonzero((cur["psi_time"] == t) & ~cur["psi_valid"])[:, 0].tolist()
            alive = torch.arange(self.N) < M + R
            done += [(t, ((cur["r"][None, :] == torch.arange(R)[:, None]) & alive).double()) for _ in new]
            for time_, p in done:
                mean = (p.to(dtype) @ W.to(dtype)).double() if dtype else p @ W
                got = mean if dtype else torch.as_tensor(rows[time_])
                n["regime_gap"] = max(n["regime_gap"], float((got - (p @ W)).abs().max()))
            if not dtype:
                row = torch.as_tensor(files["theta_trace"][t])
                n["params_gap"] = max(n["params_gap"], float((row - cur["theta"].double()).abs().max()))
        # The whole call: logZ, the rows' sums, and the parameter files.
        shifts = cap["shifts"]
        total = float(shifts.double().sum())
        log_z = float(shifts.to(dtype).sum()) if dtype else cap["log_z"]
        n["logz_gap"] = max(n["logz_gap"], abs(log_z - total))
        if dtype:
            rows = low(rows)
        n["regime_sum_gap"] = max(n["regime_sum_gap"], float(np.abs(np.asarray(rows).sum(1) - 1.0).max()))
        last = torch.as_tensor(files["theta_trace"][-1])
        if dtype:
            prog = (ref.transition_matrix(last, R, dtype).double(), ref.omega_of(last, R, dtype).double(), low(last))
        else:
            prog = (torch.as_tensor(files["p"]), torch.as_tensor(files["omega"][:, 0]),
                    torch.as_tensor(files["theta"][:, 0]))
        gaps = [prog[0] - ref.transition_matrix(last, R), prog[1] - ref.omega_of(last, R), prog[2] - last,
                torch.as_tensor(files["kappa"][:, 0]) - self.settings.kappa]
        n["params_gap"] = max([n["params_gap"]] + [float(g.abs().max()) for g in gaps])
        return n

    def _hazard_gap(self, tabs, st, dtype):
        """The program's ρ table (or the control's: the reference's computed
        in ``dtype``) against the reference's from the same θ."""
        if dtype:
            s = self.settings
            rho = ref.hazard(s.kappa, ref.omega_of(st["theta"], self.R), s.u, s.d_max, dtype=dtype)[0]
            return ref.hazard_gap(tabs, rho, torch.zeros_like(tabs.exit))
        return ref.hazard_gap(tabs, st["rho"], st["exit"])

    def control(self, dtype=torch.bfloat16):
        """The numbers that the control reads: the reference computed in
        ``dtype`` put in the program's place, following the program's state
        at each copied site, judged against the float64 reference."""
        n = dict(NUMBERS)
        for k in sorted(self.captured):
            self.judge(k, n, dtype)
        return n

    def check(self, n_calls):
        limits = self.ctx.cell["limits"]
        calls = [k for k in range(n_calls) if k in self.captured]
        n = dict(NUMBERS)
        for k in calls:
            self.judge(k, n)
        for k in range(n_calls):
            shutil.rmtree(self._dir(k), ignore_errors=True)
        if not calls or not any(self.captured[k]["sites"] for k in calls):
            n = {name: math.inf for name in limits}
        return [{"name": name, "value": n[name], "limit": limits[name]} for name in limits]
