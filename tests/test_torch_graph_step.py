"""The port's replayable site steps against the loops they replace.

The filter, the backward pass and the single-group engine run their sites
as steps that read the site from a device index they advance and write
their carry in place, so that on a CUDA device a captured graph of K sites
replays them (ops/site_graphs.py; the counterpart of JAX's ``lax.scan``
with ``unroll``, tests/test_two_group_filter.py::
test_filter_unroll_invariance). On the CPU the same steps run eagerly.
Here, on the CPU, each is held bit for bit against the host-indexed loop
it replaces, written out below as it stood, for K in {0, 1, 3, 8} over
lengths that leave a remainder of a group of K:

- the filter: one generator and a list of per-unit generators, the cold
  start, the warm start and ``use_init``, with and without history;
- the backward pass: ``backward_simulation`` and
  ``backward_simulation_conditioned``, both kinds of generator;
- the engine: the growth phase, update sites, ``t_limit`` (sites past the
  first limit run under a graph of their own on the card), injected
  uniforms, per-unit generators and the chunked form's checkpoint resume.
  The steady sites of a run go through one step called with the first
  site's host t, as a graph captured there replays them.

Every comparison is exact: the steps do the same operations in the same
order as the loops.
"""

import numpy as np
import pytest
import torch

from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
from hygeia_tpu_torch.ops.site_graphs import SiteLoop
from hygeia_tpu_torch.single_group import engine as eng_mod
from hygeia_tpu_torch.single_group.engine import (
    EngineConfig,
    run_online_combined_inference,
    run_online_combined_inference_chunked,
)
from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta
from hygeia_tpu_torch.two_group.backward import (
    _backward_logits,
    _categorical_rows,
    backward_simulation,
    backward_simulation_conditioned,
    gumbel,
)
from hygeia_tpu_torch.two_group.filter import _draw_uniforms, _one_step, _renormalise, run_filter
from hygeia_tpu_torch.two_group.model import State, make_params

torch.set_num_threads(1)

R = 6
KS = [0, 1, 3, 8]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _params(T):
    return make_params(
        mu=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50], sigma=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751],
        p_softmax_control=np.zeros((R, R)), omega_logit_control=np.full(R, 4.0), omega_case=0.8,
        kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
        split_prob=0.01, minimum_duration=3, d_max=T + 1, device="cpu",
    )


def _tables(params, T, U, seed=3):
    """(U, T, R) control and case emission tables from numpy draws."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(20, size=(U, T, 2))
    tab = lambda p: torch.stack([
        emission_log_prob_table(rng.binomial(n[u], p), n[u], params.alpha, params.beta) for u in range(U)
    ])
    return tab(0.7), tab(0.3)


def _generators(kind, U, base):
    return _gen(base) if kind == "one" else [_gen(base + u) for u in range(U)]


# ---- the filter -------------------------------------------------------------

def _reference_filter_loop(params, E_c, E_k, M, U, generator, lw, parts):
    """run_filter's site loop as it stood: Python t, rebinding carry.
    Returns (history weights (U, T-1, N), particles (U, T-1, 5, N), shifts,
    degenerate flags) of sites 1..T-1."""
    T = E_c.shape[-2]
    rows_lw, rows_p, shifts, degen = [], [], [], []
    for t in range(1, T):
        u_sys, u_mult = _draw_uniforms(generator, U, M, lw.device)
        lw, parts = _one_step(params, E_c[..., t, :], E_k[..., t, :], lw, parts, M, u_sys, u_mult)
        lw, shift, dg = _renormalise(lw)
        rows_lw.append(lw)
        rows_p.append(parts)
        shifts.append(shift)
        degen.append(dg)
    return torch.stack(rows_lw, 1), torch.stack(rows_p, 1), torch.stack(shifts, 1), torch.stack(degen, 1)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("gens", ["one", "per_unit"])
@pytest.mark.parametrize("start", ["cold", "warm", "use_init"])
def test_filter_step_equals_the_loop(K, gens, start):
    """T = 20: 19 sites, a remainder for K = 3 and 8. The start (cold,
    warm or per-unit use_init) runs through run_filter on site 0 alone;
    the reference loop then continues from its state on the same
    generators, and the whole run_filter call must give its rows, shifts,
    logZ and degenerate count bit for bit."""
    T, U, M = 20, 3, 4
    params = _params(T)
    E_c, E_k = _tables(params, T, U)
    kw = {}
    if start != "cold":
        warm = run_filter(params, E_c, E_k, M, n_units=U, generator=_generators(gens, U, 40))
        kw["init_state"] = (warm.log_weights[:, -1], torch.stack(warm.particles, 1)[:, :, -1].to(torch.int32))
        if start == "use_init":
            kw["use_init"] = [True, False, True]

    got = run_filter(params, E_c, E_k, M, n_units=U, generator=_generators(gens, U, 7), sites_per_graph=K, **kw)

    g = _generators(gens, U, 7)
    first = run_filter(params, E_c[:, :1], E_k[:, :1], M, n_units=U, generator=g, **kw)
    lw0, parts0 = first.log_weights[:, 0], torch.stack(first.particles, 1)[:, :, 0].to(torch.int32)
    want_lw, want_p, want_shifts, want_degen = _reference_filter_loop(params, E_c, E_k, M, U, g, lw0, parts0)

    assert torch.equal(got.log_weights[:, 0], lw0)
    assert torch.equal(got.log_weights[:, 1:], want_lw)
    for i, f in enumerate(got.particles):
        assert torch.equal(f[:, 0].to(torch.int32), parts0[:, i])
        assert torch.equal(f[:, 1:], want_p[:, :, i].to(f.dtype)), i
    assert torch.equal(got.shifts, want_shifts)
    assert torch.equal(got.init_shift, first.init_shift)
    assert torch.equal(got.log_normalizing_constant, first.init_shift + want_shifts.sum(-1))
    assert torch.equal(got.degenerate_steps, first.degenerate_steps + want_degen.sum(-1))

    final = run_filter(params, E_c, E_k, M, n_units=U, generator=_generators(gens, U, 7),
                       return_history=False, sites_per_graph=K, **kw)
    assert torch.equal(final.log_weights, want_lw[:, -1])
    assert torch.equal(torch.stack(final.particles, 1), want_p[:, -1])
    assert torch.equal(final.log_normalizing_constant, got.log_normalizing_constant)


# ---- the backward pass ------------------------------------------------------

def _reference_backward(params, log_weights, particles, terminal_state, use_terminal, B, generator):
    """backward_simulation_conditioned as it stood: Python t, views of the
    history rows, rebinding carry."""
    U, T, N = log_weights.shape
    noise = lambda: gumbel((U, B, N), generator=generator, dtype=log_weights.dtype)
    traj = torch.empty((U, T, B, 5), dtype=torch.int32)
    last = State(*(f[:, T - 1] for f in particles))
    last_lw = log_weights[:, T - 1]
    eps = noise()
    if use_terminal is False:
        idx = _categorical_rows(last_lw[:, None, :], eps)
    else:
        term = State(*(terminal_state[..., i].to(torch.int32) for i in range(5)))
        idx = _categorical_rows(_backward_logits(params, last, term, last_lw, history_layout=True), eps)
        if use_terminal is not True:
            idx = torch.where(use_terminal[:, None], idx, _categorical_rows(last_lw[:, None, :], eps))
    nxt = State(*(f.gather(1, idx).to(torch.int32) for f in last))
    traj[:, T - 1] = torch.stack(nxt, dim=-1)
    for t in range(T - 2, -1, -1):
        cur = State(*(f[:, t] for f in particles))
        logits = _backward_logits(params, cur, nxt, log_weights[:, t], history_layout=True)
        sel = _categorical_rows(logits, noise())
        nxt = State(*(f.gather(1, sel).to(torch.int32) for f in cur))
        traj[:, t] = torch.stack(nxt, dim=-1)
    return traj


@pytest.fixture(scope="module")
def history():
    T, U, M = 21, 3, 4
    params = _params(T)
    E_c, E_k = _tables(params, T, U, seed=5)
    res = run_filter(params, E_c, E_k, M, n_units=U, generator=[_gen(1), _gen(2), _gen(3)])
    return params, res


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("gens", ["one", "per_unit"])
@pytest.mark.parametrize("form", ["plain", "all", "some"])
def test_backward_step_equals_the_loop(history, K, gens, form):
    """20 reverse sites after the terminal draw (a remainder for K = 3 and
    8); unconditioned, conditioned for every unit, and per unit."""
    params, res = history
    U, B = 3, 5
    if form == "plain":
        got = backward_simulation(params, res.log_weights, res.particles, B,
                                  generator=_generators(gens, U, 11), sites_per_graph=K)
        want = _reference_backward(params, res.log_weights, res.particles, None, False, B,
                                   _generators(gens, U, 11))
    else:
        term = backward_simulation(params, res.log_weights, res.particles, B, generator=_gen(4))[:, 0]
        use = True if form == "all" else torch.tensor([True, False, True])
        got = backward_simulation_conditioned(params, res.log_weights, res.particles, term, use,
                                              generator=_generators(gens, U, 11), sites_per_graph=K)
        want = _reference_backward(params, res.log_weights, res.particles, term, use, B,
                                   _generators(gens, U, 11))
    assert torch.equal(got, want)


def test_backward_injected_noise_is_a_cpu_route(history):
    """Injected noise is read at a host t, which a replay cannot advance:
    off the CPU it is refused."""
    params, res = history
    meta = lambda x: x.to("meta")
    with pytest.raises(ValueError, match="CPU-only"):
        backward_simulation(params, meta(res.log_weights), State(*map(meta, res.particles)), 5,
                            noise=lambda t: None)


# ---- the single-group engine ------------------------------------------------

@pytest.fixture(scope="module")
def sg_problem():
    T = 100
    rng = np.random.default_rng(2)
    model = make_model([0.99, 0.01, 0.8, 0.2, 0.5, 0.5], [0.05, 0.05, 0.2, 0.2, 0.2, 0.2886751],
                       2, np.full(R, 2.0), device="cpu")
    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    theta = parameters_to_theta(p, [0.995, 0.975, 0.95, 0.925, 0.9, 0.9])
    n = rng.poisson(20, size=(T, 2))
    y = rng.binomial(n, np.repeat(rng.uniform(0, 1, T // 20), 20)[:, None])
    return model, theta, emission_log_prob_table(y, n, model.alpha, model.beta)


def _reference_engine(model, theta, E, cfg, U, generator=None, u_sys=None, u_mult=None, shared=False,
                      t_limit=None):
    """The engine's loop as it stood: every site stepped with its own host
    t and the device index set from the host, the draws indexed by t."""
    eng = eng_mod._Engine(model, theta, E, cfg, U, torch.float32, None, t_limit)
    for t in range(1, eng.T):
        eng.t_dev.fill_(t)
        if u_sys is not None:
            draws = (u_sys[t - 1], u_mult[t - 1])
        else:
            draws = eng_mod._site_uniforms(U, eng.M, generator, eng.device, shared)
        eng.step(t, *draws)
    return eng.result()


def _assert_results_equal(got, want):
    for name, a, b in zip(got._fields, got, want):
        for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
            assert torch.equal(x, y), name


# Growth to t = 6 at N = 40, R = 6; updates every 11 sites; S = 16.
_SG_CFG = EngineConfig(n_particles_max=40, smoothing_window=16, estimate_parameters=True, steps_per_update=11)
_LIMITS = [45, 100, 71]


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("case", ["one", "per_unit", "t_limit", "injected", "regimes_only"])
def test_engine_step_equals_the_loop(sg_problem, K, case):
    """99 sites: the growth phase, 9 update sites, runs of 10 steady sites
    (a remainder for K = 3 and 8), the last site; with t_limit (45, 100,
    71) the units freeze at sites past 45, and sites 44 and 70 finalise a
    unit's entries."""
    model, theta, E = sg_problem
    T, U, cfg, limit, shared = E.shape[0], 2, _SG_CFG, None, False
    if case == "t_limit":
        U, limit, shared = 3, _LIMITS, True
    if case == "regimes_only":
        cfg = cfg._replace(estimate_parameters=False)

    def draws():  # fresh generators, or the injected uniforms
        if case == "per_unit":
            return dict(generator=[_gen(3), _gen(4)])
        if case == "injected":
            M = cfg.n_particles_max - R
            return dict(u_sys=torch.rand((T - 1, U), generator=_gen(5)),
                        u_mult=torch.rand((T - 1, U, M), generator=_gen(6)))
        return dict(generator=_gen(0))

    want = _reference_engine(model, theta, E, cfg, U, shared=shared, t_limit=limit, **draws())
    got = run_online_combined_inference(model, theta, E, cfg, n_units=U, shared_draws=shared, t_limit=limit,
                                        sites_per_graph=K, **draws())
    _assert_results_equal(got, want)


@pytest.mark.parametrize("K", [0, 3])
def test_chunked_engine_resumes_onto_the_same_step(sg_problem, tmp_path, K):
    """A chunked run stopped after its second checkpoint and resumed gives
    the uninterrupted run's result: the resumed state, device index and
    generator state are loaded in place, where the step reads them."""
    model, theta, E = sg_problem
    path = str(tmp_path / "ck.npz")
    want = run_online_combined_inference(model, theta, E, _SG_CFG, n_units=2, generator=_gen(0))

    class Stop(Exception):
        pass

    saves = []
    save = eng_mod._Engine.save

    def save_then_stop(self, p, generator=None):
        save(self, p, generator)
        saves.append(self.state["next_t"])
        if len(saves) == 2:
            raise Stop

    eng_mod._Engine.save = save_then_stop
    try:
        with pytest.raises(Stop):
            run_online_combined_inference_chunked(model, theta, E, _SG_CFG, chunk_size=45, checkpoint_path=path,
                                                  n_units=2, generator=_gen(0), sites_per_graph=K)
    finally:
        eng_mod._Engine.save = save
    assert saves == [46, 91]
    got = run_online_combined_inference_chunked(model, theta, E, _SG_CFG, chunk_size=45, checkpoint_path=path,
                                                n_units=2, generator=_gen(123), sites_per_graph=K)
    _assert_results_equal(got, want)


def test_engine_kinds(sg_problem):
    """Which sites a graph replays on the card: none in the growth phase
    (t < 6 at N = 40, R = 6), at update sites, where entries finalise or
    at the last site; "frozen" past the first t_limit."""
    model, theta, E = sg_problem
    eng = eng_mod._Engine(model, theta, E, _SG_CFG, 3, torch.float32, None, _LIMITS)
    kinds = {t: eng.kind(t) for t in range(1, 100)}
    eager = {1, 2, 3, 4, 5, 44, 70, 99, *range(11, 100, 11)}
    assert {t for t, k in kinds.items() if k is None} == eager
    assert {kinds[t] for t in range(6, 45) if t not in eager} == {"steady"}
    assert {kinds[t] for t in range(45, 99) if t not in eager} == {"frozen"}


# ---- the loop itself ----------------------------------------------------------

@pytest.mark.parametrize("K", KS)
def test_site_loop_calls_the_step_once_a_site_on_the_cpu(K):
    calls = []
    with SiteLoop("cpu", K) as loop:
        loop.run(lambda: calls.append(1), 11)
        loop.run(lambda: calls.append(2), 0, kind="other")
    assert calls == [1] * 11
    assert not loop.graphed


@pytest.mark.parametrize("bad", [-1, 2.5])
def test_site_loop_refuses_a_bad_group_size(bad):
    with pytest.raises(ValueError, match="sites_per_graph"):
        SiteLoop("cpu", bad)
