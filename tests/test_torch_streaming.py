"""The port's streamed INFER (hygeia_tpu_torch.two_group.streaming and the
runner's streamed paths) against its monolithic path, exact enumeration and
the JAX package.

Exactness:
- the warm step and the conditioned backward against the JAX functions
  with the JAX draws (uniforms from the warm key, Gumbel noise from the
  per-site keys): particles and trajectories equal, weights rtol 1e-13 with
  equal -inf masks (XLA's and libm's f64 log/exp differ in the last bit);
- per-unit emission rows: each unit equal to its shared-row result;
- streamed against monolithic for the same generators: trajectories,
  split and regime probabilities, logZ and degenerate counts equal bit for
  bit, for every block layout;
- streamed against exact enumeration: logZ and marginals atol 0.05, the
  tolerance of tests/test_streaming.py.
"""

import gzip
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hygeia_tpu.ops.emissions import emission_log_prob_table as j_emission
from hygeia_tpu.single_group.model import parameters_to_theta
from hygeia_tpu.two_group import model as jm
from hygeia_tpu.two_group.backward import backward_simulation_conditioned as j_conditioned
from hygeia_tpu.two_group.filter import run_filter as j_run_filter
from hygeia_tpu.two_group.runner import infer_segment as jax_infer_segment
from hygeia_tpu.utils import io as hio
from hygeia_tpu_torch import cli as torch_cli
from hygeia_tpu_torch.two_group import filter as tf
from hygeia_tpu_torch.two_group import model as tm
from hygeia_tpu_torch.two_group.backward import (
    backward_simulation,
    backward_simulation_conditioned,
    smoothing_functionals,
)
from hygeia_tpu_torch.two_group.runner import infer_chromosome_streamed, infer_segment
from hygeia_tpu_torch.two_group.streaming import launches_per_call, streamed_inference
from tests.test_torch_two_group import _assert_close_masked, _exact_forward_backward, _port_params
from tests.test_two_group_model import default_params

# The tensors here are small: one intra-op thread per test worker keeps the
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

F64 = torch.float64


def _emissions(params, T, seed, per_unit=0):
    """(E_c, E_k) numpy f64 tables (T, R), or (U, T, R) for per_unit=U."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(max(per_unit, 1)):
        n = rng.poisson(25, size=(T, 2)).astype(np.float64)
        y = np.minimum(rng.poisson(10, size=(T, 2)), n)
        out.append((np.asarray(j_emission(y, n, params.alpha, params.beta, dtype=jnp.float64)),
                    np.asarray(j_emission(np.minimum(y + 2, n), n, params.alpha, params.beta,
                                          dtype=jnp.float64))))
    if not per_unit:
        return out[0]
    return np.stack([e[0] for e in out]), np.stack([e[1] for e in out])


@pytest.fixture(scope="module")
def jax_history():
    """A JAX filter history (R=4, T=31, M=5) at f64, from which blocks,
    warm starts and terminals are taken."""
    R, T, M = 4, 31, 5
    params = default_params(R=R, min_duration=2, d_max=128)
    E_c, E_k = _emissions(params, T, 3)
    res = j_run_filter(jax.random.PRNGKey(0), params, jnp.asarray(E_c), jnp.asarray(E_k), M,
                       weight_dtype=jnp.float64, unroll=1)
    return params, E_c, E_k, res


# ------------------------------------------------------------ warm start ----

def test_warm_step_matches_jax_with_injected_uniforms(jax_history):
    """Site 0 of a warm block for two units, warm-started from two history
    rows, with the uniforms JAX's run_filter draws from its warm key: the
    JAX history row 0 (and its shift, the logZ of a one-site block)."""
    params, E_c, E_k, res = jax_history
    tp = _port_params(params)
    M, t0 = 5, 20
    rows = (7, 19)
    prev_lw = np.stack([np.asarray(res.log_weights[r]) for r in rows])
    prev = np.stack([np.stack([np.asarray(f[r]) for f in res.particles]) for r in rows]).astype(np.int32)
    us, ums = [], []
    warm = jax.jit(lambda key, lw, parts: j_run_filter(
        key, params, jnp.asarray(E_c[t0 : t0 + 1]), jnp.asarray(E_k[t0 : t0 + 1]), M,
        weight_dtype=jnp.float64, unroll=1, init_state=(lw, jm.State(*parts)),
    ))
    for u, r in enumerate(rows):
        key = jax.random.PRNGKey(50 + u)
        want = warm(key, jnp.asarray(prev_lw[u]), tuple(jnp.asarray(f) for f in prev[u]))
        key, _ = jax.random.split(key)
        _, k_warm = jax.random.split(key)
        k_sys, k_mult = jax.random.split(k_warm)
        us.append(float(jax.random.uniform(k_sys, (), dtype=jnp.float32)))
        ums.append(np.asarray(jax.random.uniform(k_mult, (M,), dtype=jnp.float32)))
        us_t, ums_t = torch.tensor([us[-1]]), torch.from_numpy(ums[-1][None])
        lw, parts, shift, degen = tf.warm_step(
            tp, torch.from_numpy(E_c[t0:]), torch.from_numpy(E_k[t0:]),
            torch.from_numpy(prev_lw[u : u + 1]), torch.from_numpy(prev[u : u + 1]), M, us_t, ums_t,
        )
        _assert_close_masked(lw[0].numpy(), np.asarray(want.log_weights[0]), f"unit {u}")
        for i, a in enumerate(want.particles):
            np.testing.assert_array_equal(parts[0, i].numpy(), np.asarray(a[0]))
        np.testing.assert_allclose(float(shift[0]), float(want.log_normalizing_constant), rtol=1e-13)
        assert not bool(degen[0])

    # Both units in one call, and per-unit rows (U, T, R): the same numbers.
    lw2, parts2, _, _ = tf.warm_step(
        tp, torch.from_numpy(np.stack([E_c[t0:]] * 2)), torch.from_numpy(np.stack([E_k[t0:]] * 2)),
        torch.from_numpy(prev_lw), torch.from_numpy(prev), M, torch.tensor(us),
        torch.from_numpy(np.stack(ums)),
    )
    for u in range(2):
        lw1, parts1, _, _ = tf.warm_step(
            tp, torch.from_numpy(E_c[t0:]), torch.from_numpy(E_k[t0:]),
            torch.from_numpy(prev_lw[u : u + 1]), torch.from_numpy(prev[u : u + 1]), M,
            torch.tensor(us[u : u + 1]), torch.from_numpy(ums[u][None]),
        )
        assert torch.equal(lw2[u], lw1[0]) and torch.equal(parts2[u], parts1[0])


def test_run_filter_use_init_picks_warm_or_cold_per_unit(jax_history):
    """use_init (U,): unit 0 warm, unit 1 cold. The warm unit draws site 0's
    uniforms first, so it equals a warm-only call; the cold unit (phantom
    regime fixed) equals a cold call; a degenerate warm step is counted."""
    params, E_c, E_k, res = jax_history
    tp = _port_params(params)
    M = 5
    init = (torch.from_numpy(np.stack([np.asarray(res.log_weights[9])] * 2)),
            torch.from_numpy(np.stack([np.stack([np.asarray(f[9]) for f in res.particles])] * 2)
                             .astype(np.int32)))
    E1 = (torch.from_numpy(E_c[10:11]), torch.from_numpy(E_k[10:11]))

    def run(**kw):
        return tf.run_filter(tp, *E1, M, n_units=2, generator=torch.Generator().manual_seed(3),
                             weight_dtype=F64, phantom_regime=1, **kw)

    mixed = run(init_state=init, use_init=torch.tensor([True, False]))
    warm, cold = run(init_state=init), run()
    assert torch.equal(mixed.log_weights[0], warm.log_weights[0])
    assert torch.equal(mixed.log_weights[1], cold.log_weights[1])
    for a, w, c in zip(mixed.particles, warm.particles, cold.particles):
        assert torch.equal(a[0], w[0]) and torch.equal(a[1], c[1])
    assert torch.equal(mixed.log_normalizing_constant,
                       torch.stack([warm.log_normalizing_constant[0], cold.log_normalizing_constant[1]]))

    dead = (torch.full_like(init[0], float("-inf")), init[1])  # every ancestor dead
    res_dead = run(init_state=dead)
    assert res_dead.degenerate_steps.tolist() == [1, 1]
    assert torch.all(res_dead.log_weights[:, 0] == -np.log(res_dead.log_weights.shape[-1]))


# --------------------------------------------------- conditioned backward ----

@pytest.mark.parametrize("use_terminal", [True, False, "per_unit"])
def test_conditioned_backward_matches_jax(jax_history, use_terminal):
    """backward_simulation_conditioned on the history's first 30 rows, with
    a terminal drawn from row 30's live particles, fed the Gumbel noise JAX
    draws from its per-site keys: the JAX trajectories, for each unit."""
    params, E_c, E_k, res = jax_history
    tp = _port_params(params)
    T, B = 30, 7
    lw = np.asarray(res.log_weights)[:T]
    hist = [np.asarray(f)[:T] for f in res.particles]
    N = lw.shape[1]
    rng = np.random.default_rng(4)
    live = np.flatnonzero(np.isfinite(np.asarray(res.log_weights)[T]))
    terms = [np.stack([np.asarray(f)[T][rng.choice(live, B)] for f in res.particles], -1).astype(np.int32)
             for _ in range(2)]
    flags = {True: [True, True], False: [False, False], "per_unit": [True, False]}[use_terminal]
    noises, wants = [], []
    for u in range(2):
        key = jax.random.PRNGKey(10 + u)
        wants.append(np.asarray(j_conditioned(key, params, jnp.asarray(lw),
                                              jm.State(*(jnp.asarray(f) for f in hist)),
                                              jnp.asarray(terms[u]), jnp.asarray(flags[u]))))
        keys = jax.random.split(key, T)
        noises.append(np.stack([np.asarray(jax.random.gumbel(keys[t], (B, N), jnp.float64))
                                for t in range(T)]))
    noise = np.stack(noises)  # (U, T, B, N)
    got = backward_simulation_conditioned(
        tp, torch.from_numpy(np.stack([lw] * 2)),
        tm.State(*(torch.from_numpy(np.stack([f] * 2)) for f in hist)),
        torch.from_numpy(np.stack(terms)),
        torch.tensor(flags) if use_terminal == "per_unit" else use_terminal,
        noise=lambda t: torch.from_numpy(noise[:, t]),
    )
    assert got.shape == (2, T, B, 5) and got.dtype == torch.int32
    for u in range(2):
        np.testing.assert_array_equal(got[u].numpy(), wants[u])


# ----------------------------------------------------- per-unit emissions ----

def test_per_unit_emission_rows_equal_shared_rows(jax_history):
    """_first_step and _one_step with (U, T, R) tables: unit u equals the
    shared-table call on unit u's table, with the same uniforms."""
    params, _, _, res = jax_history
    tp = _port_params(params)
    R, M, N, U = params.n_regimes, 5, res.log_weights.shape[1], 3
    E_c, E_k = (torch.from_numpy(e) for e in _emissions(params, 4, 8, per_unit=U))
    prev_lw = torch.from_numpy(np.stack([np.asarray(res.log_weights[r]) for r in (5, 12, 25)]))
    prev = torch.from_numpy(np.stack([np.stack([np.asarray(f[r]) for f in res.particles])
                                      for r in (5, 12, 25)]).astype(np.int32))
    gen = torch.Generator().manual_seed(2)
    us, um = torch.rand((U,), generator=gen), torch.rand((U, M), generator=gen)
    phantom = torch.tensor([0, 2, 3], dtype=torch.int32)
    lw0, p0 = tf._first_step(tp, E_c, E_k, N, F64, phantom)
    lw1, p1 = tf._one_step(tp, E_c[:, 2], E_k[:, 2], prev_lw, prev, M, us, um)
    for u in range(U):
        a, b = tf._first_step(tp, E_c[u], E_k[u], N, F64, phantom[u : u + 1])
        assert torch.equal(lw0[u], a[0]) and torch.equal(p0[u], b[0])
        a, b = tf._one_step(tp, E_c[u, 2], E_k[u, 2], prev_lw[u : u + 1], prev[u : u + 1], M,
                            us[u : u + 1], um[u : u + 1])
        assert torch.equal(lw1[u], a[0]) and torch.equal(p1[u], b[0])
        assert R == E_c.shape[-1]


# ------------------------------------------------- streamed vs monolithic ----

def _monolithic(tp, E_c, E_k, M, B, U, dtype, seeds=(1, 2)):
    res = tf.run_filter(tp, E_c, E_k, M, n_units=U, generator=torch.Generator().manual_seed(seeds[0]),
                        weight_dtype=dtype)
    traj = backward_simulation(tp, res.log_weights, res.particles, B,
                               generator=torch.Generator().manual_seed(seeds[1]))
    return res, traj


@pytest.mark.parametrize("W, per_unit, dtype", [
    (8, False, F64),   # W divides T
    (12, False, F64),  # W does not divide T
    (40, False, F64),  # one block
    (13, True, F64),   # one segment per unit
    (7, False, torch.float32),
])
def test_streamed_equals_monolithic_bit_for_bit(W, per_unit, dtype, monkeypatch):
    """The same generators give the monolithic trajectories, split and
    regime probabilities, logZ and degenerate counts, bit for bit; every
    block's re-run equals its checkpoint; the resampler runs
    2T - len_last - 2 times (T - 1 with one block)."""
    R, T, M, B, U = 3, 40, 4, 6, 3
    params = default_params(R=R, min_duration=2, d_max=64)
    tp = _port_params(params)
    if dtype == torch.float32:
        tp = tm.params_from_numpy({k: np.array(v) for k, v in params._asdict().items()}, dtype=dtype,
                                  device="cpu")
    E_c, E_k = (torch.from_numpy(e).to(dtype) for e in _emissions(params, T, 5, per_unit=U if per_unit else 0))
    res, traj = _monolithic(tp, E_c, E_k, M, B, U, dtype)

    calls = []
    real = tf.optimal_resampling
    monkeypatch.setattr(tf, "optimal_resampling", lambda *a, **k: calls.append(1) or real(*a, **k))
    timings = {}
    got, log_z, degen = streamed_inference(
        tp, E_c, E_k, M, B, n_units=U, generator=torch.Generator().manual_seed(1),
        backward_generator=torch.Generator().manual_seed(2), block_size=W, weight_dtype=dtype,
        timings=timings,
    )
    np.testing.assert_array_equal(got, traj.numpy())
    assert torch.equal(log_z, res.log_normalizing_constant)
    assert torch.equal(degen, res.degenerate_steps)
    n_blocks = -(-T // W)
    assert timings["rerun_equals_checkpoint"] == [True] * (n_blocks - 1)
    assert len(timings["fwd"]) == n_blocks - 1 and len(timings["rev"]) == len(timings["pull"]) == n_blocks
    assert len(calls) == launches_per_call(T, W) == (T - 1 if n_blocks == 1 else 2 * T - (T - (n_blocks - 1) * W) - 2)
    for a, b in zip(smoothing_functionals(torch.from_numpy(got), R), smoothing_functionals(traj, R)):
        assert torch.equal(a, b)


def test_streamed_matches_exact_inference():
    """Two 5-site blocks: logZ and the split/regime marginals against exact
    forward-backward enumeration (tests/test_streaming.py's oracle and
    tolerances), with the resampler in the loop (M=60, T=10, B=4000); and
    every consecutive pair of the sampled paths, across the block join too,
    has a finite transition density."""
    T, R = 10, 3
    params = default_params(R=R, min_duration=2, d_max=32)
    tp = _port_params(params)
    rng = np.random.default_rng(11)
    n_c = rng.poisson(25, size=(T, 1)).astype(np.float64)
    n_k = rng.poisson(25, size=(T, 1)).astype(np.float64)
    y_c = np.minimum(rng.poisson(10, size=(T, 1)), n_c)
    y_k = np.minimum(rng.poisson(10, size=(T, 1)), n_k)
    E_c = j_emission(y_c, n_c, params.alpha, params.beta, dtype=jnp.float64)
    E_k = j_emission(y_k, n_k, params.alpha, params.beta, dtype=jnp.float64)
    log_z, split, ctrl, case = _exact_forward_backward(params, E_c, E_k, 1, T)

    traj, lz, degen = streamed_inference(
        tp, torch.from_numpy(np.asarray(E_c)), torch.from_numpy(np.asarray(E_k)), 60, 4000,
        n_units=1, generator=torch.Generator().manual_seed(0),
        backward_generator=torch.Generator().manual_seed(1), block_size=5, weight_dtype=F64,
        phantom_regime=1,
    )
    assert int(degen[0]) == 0
    np.testing.assert_allclose(float(lz[0]), log_z, rtol=0, atol=0.05)
    split_pf, regime_pf = smoothing_functionals(torch.from_numpy(traj), R)
    np.testing.assert_allclose(split_pf[0].numpy(), split, atol=0.05)
    np.testing.assert_allclose(regime_pf[0, :, :R].numpy(), ctrl, atol=0.05)
    np.testing.assert_allclose(regime_pf[0, :, R:].numpy(), case, atol=0.05)
    tr = torch.from_numpy(traj[0])
    for t in range(T - 1):
        lp = tm.transition_log_prob(tp, tm.State(*tr[t].unbind(-1)), tm.State(*tr[t + 1].unbind(-1)))
        assert torch.isfinite(lp).all(), t


# ------------------------------------------------------------- the runner ----

RR = 3
MU, SIGMA = [0.1, 0.5, 0.9], [0.08, 0.08, 0.08]
MM, BB, W = 4, 8, 32
# JAX's streamed run in one block: its warm-start block programs take over a
# minute to compile on a CPU, one block about 25 s.
JAX_W = 128
NN = MM * (2 * RR + RR * RR)


def _write_chromosome(root, chrom, T, seed):
    data, sg = root / "data", root / "sg"
    data.mkdir(exist_ok=True)
    sg.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    P = np.full((RR, RR), 1.0 / (RR - 1))
    np.fill_diagonal(P, 0.0)
    hio.write_theta(sg / f"theta_{chrom}.csv.gz", parameters_to_theta(P, np.full(RR, 0.9)))
    n = rng.poisson(30, size=(T, 2)).astype(np.float32)
    y = np.minimum(rng.poisson(9, size=(T, 2)), n).astype(np.float32)
    hio.write_count_matrix(data / f"positions_{chrom}.txt.gz", np.arange(1, T + 1) * 7)
    hio.write_count_matrix(data / f"n_total_reads_control_{chrom}.txt.gz", n)
    hio.write_count_matrix(data / f"n_total_reads_case_{chrom}.txt.gz", n)
    hio.write_count_matrix(data / f"n_methylated_reads_control_{chrom}.txt.gz", y)
    hio.write_count_matrix(data / f"n_methylated_reads_case_{chrom}.txt.gz", np.minimum(y + 3, n))
    return data, sg


def _same_files(a, b, skip=("optimal_time",)):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        if name.startswith(skip):
            continue
        if name.endswith(".npz"):
            np.testing.assert_array_equal(np.load(a / name)["arr_0"], np.load(b / name)["arr_0"], err_msg=name)
        elif name.endswith(".gz"):
            assert gzip.decompress((a / name).read_bytes()) == gzip.decompress((b / name).read_bytes()), name
        else:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.fixture(scope="module")
def segment_runs(tmp_path_factory):
    """One 90-site segment (80 + halo 10), seeds (0, 1): the port
    monolithic, the port streamed (W=32, three blocks) through the API and
    seed 0 through the CLI, and JAX's streamed infer_segment (one block)."""
    root = tmp_path_factory.mktemp("torch_streaming")
    data, sg = _write_chromosome(root, "s", 90, 0)
    common = dict(data_dir=str(data), single_group_dir=str(sg), chrom="s", batch=0, segment_size=80,
                  buffer_size=10, mu=MU, sigma=SIGMA, num_resampled_particles=(MM,),
                  num_samples_backward=BB)
    infer_segment(results_dir=str(root / "mono"), seed=[0, 1], device="cpu", **common)
    timings = {}
    infer_segment(results_dir=str(root / "stream"), seed=[0, 1], device="cpu", streaming_blocks=W,
                  timings=timings, **common)
    torch_cli.main(["infer", "--data_dir", str(data), "--single_group_dir", str(sg), "--chrom", "s",
                    "--segment_size", "80", "--buffer_size", "10", "--mu", ",".join(map(str, MU)),
                    "--sigma", ",".join(map(str, SIGMA)), "--num_resampled_particles", str(MM),
                    "--num_samples_backward", str(BB), "--streaming_blocks", str(W), "--seed", "0",
                    "--results_dir", str(root / "cli"), "--device", "cpu"])
    infer_segment(results_dir=str(root / "mono0"), seed=0, device="cpu", **common)
    jax_infer_segment(results_dir=str(root / "jax"), seed=[0, 1], streaming_blocks=JAX_W, **common)
    return {k: root / k / "chrom_s_0" for k in ("mono", "stream", "cli", "mono0", "jax")} | {"timings": timings}


def test_infer_segment_streamed_writes_the_monolithic_files(segment_runs):
    """Every npz array, the logZ and flag files (but the streaming flag) and
    the trimmed inputs equal the monolithic run's."""
    mono, stream = segment_runs["mono"], segment_runs["stream"]
    names = sorted(os.listdir(mono))
    assert names == sorted(os.listdir(stream)) and len(names) == 5 + 9 * 2
    for s in (0, 1):
        m = (mono / f"flags{s}.txt").read_text().replace("--streaming_blocks=None", f"--streaming_blocks={W}")
        assert m == (stream / f"flags{s}.txt").read_text()
    _same_files(mono, stream, skip=("optimal_time", "flags"))
    assert segment_runs["timings"]["rerun_equals_checkpoint"] == [[True, True]]
    assert len(segment_runs["timings"]["pull"][0]) == 3


def test_infer_segment_streamed_file_set_is_jax(segment_runs):
    """The JAX package's streamed infer_segment writes the same file names,
    array shapes and dtypes, and the same flags (but the block size)."""
    jx, stream = segment_runs["jax"], segment_runs["stream"]
    assert sorted(os.listdir(jx)) == sorted(os.listdir(stream))
    for name in os.listdir(jx):
        if name.endswith(".npz"):
            a, b = np.load(jx / name)["arr_0"], np.load(stream / name)["arr_0"]
            assert (a.shape, a.dtype) == (b.shape, b.dtype), name
        if name.startswith("flags"):
            want = (jx / name).read_text().replace(f"--streaming_blocks={JAX_W}", f"--streaming_blocks={W}")
            assert want == (stream / name).read_text()


def test_cli_streaming_blocks_runs(segment_runs):
    """infer --streaming_blocks through the CLI: seed 0's files are the
    monolithic seed-0 run's."""
    _same_files(segment_runs["mono0"], segment_runs["cli"], skip=("optimal_time", "flags"))
    assert f"--streaming_blocks={W}" in (segment_runs["cli"] / "flags0.txt").read_text()


def test_infer_chromosome_streamed_matches_per_batch(tmp_path):
    """200 sites, segment 70, halo 10: three batches with windows of 80,
    90 and 70 sites, seeds (0, 1). With max_units_per_call=1 every file
    but the timings is infer_segment(streaming_blocks=W)'s per (batch,
    seed); batched (all units of a window length in one call) the file set,
    shapes and dtypes are the same and logZ is finite."""
    data, sg = _write_chromosome(tmp_path, "c", 200, 5)
    common = dict(data_dir=str(data), single_group_dir=str(sg), chrom="c", segment_size=70,
                  buffer_size=10, mu=MU, sigma=SIGMA, num_resampled_particles=(MM,),
                  num_samples_backward=BB, streaming_blocks=W, device="cpu")
    one = infer_chromosome_streamed(results_dir=str(tmp_path / "one"), seed=[0, 1],
                                    max_units_per_call=1, **common)
    timings = {}
    batched = infer_chromosome_streamed(results_dir=str(tmp_path / "batched"), seed=[0, 1],
                                        timings=timings, **common)
    assert sorted((t_w, u) for t_w, u, _, _ in timings["chunks"]) == [(70, 2), (80, 2), (90, 2)]
    for batch in range(3):
        for s in (0, 1):
            infer_segment(results_dir=str(tmp_path / f"seg{s}"), batch=batch, seed=s, **common)
        a = tmp_path / "one" / f"chrom_c_{batch}"
        for s in (0, 1):
            b = tmp_path / f"seg{s}" / f"chrom_c_{batch}"
            for name in os.listdir(b):
                if name.startswith("optimal_time") or not (name.endswith(f"_{s}.npz") or name.endswith(f"{s}.txt")
                                                           or name.endswith(".csv.gz")):
                    continue
                if name.endswith(".npz"):
                    np.testing.assert_array_equal(np.load(a / name)["arr_0"], np.load(b / name)["arr_0"])
                elif name.endswith(".gz"):
                    assert gzip.decompress((a / name).read_bytes()) == gzip.decompress((b / name).read_bytes())
                else:
                    assert (a / name).read_text() == (b / name).read_text(), name
        c = tmp_path / "batched" / f"chrom_c_{batch}"
        assert sorted(os.listdir(a)) == sorted(os.listdir(c))
        for name in os.listdir(a):
            if name.endswith(".npz"):
                x, y = np.load(a / name)["arr_0"], np.load(c / name)["arr_0"]
                assert (x.shape, x.dtype) == (y.shape, y.dtype)
        for s in (0, 1):
            assert np.isfinite(one[batch][s][NN]) and np.isfinite(batched[batch][s][NN])


def test_infer_chromosome_streamed_robust_raises(tmp_path):
    """Robust mode is ported (it raised until then): robust=True runs, on
    the beta-divergence rows (another logZ than the BetaBinomial run's with
    the same draws), and the flags record it. tests/test_torch_robust.py
    holds it against per-segment runs."""
    data, sg = _write_chromosome(tmp_path, "c", 120, 6)
    common = dict(data_dir=str(data), single_group_dir=str(sg), chrom="c", segment_size=70,
                  buffer_size=10, mu=MU, sigma=SIGMA, num_resampled_particles=(MM,),
                  num_samples_backward=BB, streaming_blocks=W, device="cpu", seed=[0])
    robust = infer_chromosome_streamed(results_dir=str(tmp_path / "r"), robust=True, **common)
    plain = infer_chromosome_streamed(results_dir=str(tmp_path / "p"), **common)
    for b in (0, 1):
        assert np.isfinite(robust[b][0][NN]) and robust[b][0][NN] != plain[b][0][NN]
        assert "--robust=True" in (tmp_path / "r" / f"chrom_c_{b}" / "flags0.txt").read_text()
