"""The port's replayable site steps against the loops they replace.

The filter, the backward pass, the single-group engine, the marginal
filter and the simulators' chains run their sites as steps that read the site from a device index they advance and write
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
- the engine: the growth phase, update sites (a graph of their own on
  the card), ``t_limit`` (sites past the first limit run under graphs of
  their own), injected uniforms, per-unit generators and the chunked
  form's checkpoint resume. The steady sites of a run go through one step
  called with the first site's host t, as a graph captured there replays
  them;
- the marginal filter: one generator, per-unit generators and injected
  uniforms, a window that spills, and the last site (eager);
- the two simulators' chains (site 0 of the two-group chain eager).

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
from hygeia_tpu_torch.single_group import simulate as sg_sim
from hygeia_tpu_torch.single_group.model import build_tables, make_model, parameters_to_theta
from hygeia_tpu_torch.two_group.backward import (
    _backward_logits,
    _categorical_rows,
    backward_simulation,
    backward_simulation_conditioned,
    gumbel,
)
from hygeia_tpu_torch.two_group import simulate as tg_sim
from hygeia_tpu_torch.two_group.filter import _draw_uniforms, _first_step, _one_step, _renormalise, run_filter
from hygeia_tpu_torch.two_group.marginal import (
    _compact_rep,
    _compact_sum,
    _structured_psi_update_compact,
    _test_functions,
    num_compact_columns,
    run_marginal_filter,
)
from hygeia_tpu_torch.two_group.model import State, make_params
from hygeia_tpu_torch.two_group.proposal import num_children

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


@pytest.mark.parametrize("estimate_parameters", [True, False])
def test_engine_kinds(sg_problem, estimate_parameters):
    """Which sites a graph replays on the card: none in the growth phase
    (t < 6 at N = 40, R = 6), where entries finalise or at the last site;
    "update" at the update sites (every 11th, when parameters are
    estimated), "steady" at the others; "frozen" and "frozen update" past
    the first t_limit."""
    model, theta, E = sg_problem
    cfg = _SG_CFG._replace(estimate_parameters=estimate_parameters)
    eng = eng_mod._Engine(model, theta, E, cfg, 3, torch.float32, None, _LIMITS)
    kinds = {t: eng.kind(t) for t in range(1, 100)}
    eager = {1, 2, 3, 4, 5, 44, 70, 99}
    updates = set(range(11, 99, 11)) - eager if estimate_parameters else set()
    assert {t for t, k in kinds.items() if k is None} == eager
    assert {t for t, k in kinds.items() if k is not None and k.endswith("update")} == updates
    assert {kinds[t] for t in updates if t < 45} == ({"update"} if estimate_parameters else set())
    assert {kinds[t] for t in updates if t >= 45} == ({"frozen update"} if estimate_parameters else set())
    assert {kinds[t] for t in range(6, 45) if t not in eager | updates} == {"steady"}
    assert {kinds[t] for t in range(45, 99) if t not in eager | updates} == {"frozen"}


# ---- the marginal filter -----------------------------------------------------

def _reference_marginal(params, E_c, E_k, M, U, generator, uniforms, epsilon, S):
    """run_marginal_filter as it stood: Python t, the emission rows, the
    uniforms and the insertion time read at the host's t, the carry
    rebound every site. Returns (functionals, valid, logZ, spill count,
    degenerate steps)."""
    R = params.n_regimes
    N = M * num_children(R)
    T = E_c.shape[-2]
    F = 1 + 2 * R
    C = num_compact_columns(R, M)
    f32 = torch.float32
    if isinstance(generator, list):
        phantom_r = torch.cat([torch.randint(0, R, (1,), generator=g) for g in generator])
    elif generator is not None:
        phantom_r = torch.randint(0, R, (U,), generator=generator)
    else:
        phantom_r = torch.zeros((U,), dtype=torch.int64)
    lw, parts = _first_step(params, E_c, E_k, N, torch.float32, phantom_r.to(torch.int32))
    shift0 = torch.logsumexp(lw, dim=-1)
    lw = lw - shift0[:, None]
    units = torch.arange(U)
    state0 = State(*(_compact_rep(f, R, M) for f in parts.unbind(1)))
    psi = torch.zeros((U, S, F, C), dtype=f32)
    psi[:, 0] = _test_functions(state0, R)
    psi_time = torch.full((U, S), T, dtype=torch.int64)
    psi_time[:, 0] = 0
    psi_valid = torch.zeros((U, S), dtype=torch.bool)
    psi_valid[:, 0] = True
    out = torch.zeros((U, T + 1, F), dtype=f32)
    out_valid = torch.zeros((U, T + 1), dtype=torch.bool)
    spill = torch.zeros((U,), dtype=torch.int64)
    shifts = torch.zeros((U, max(T - 1, 0)))
    degen = torch.zeros((U, max(T - 1, 0)), dtype=torch.bool)
    for t in range(1, T):
        if uniforms is None:
            u_sys, u_mult = _draw_uniforms(generator, U, M, lw.device)
        else:
            u_sys, u_mult = uniforms[0][:, t - 1].contiguous(), uniforms[1][:, t - 1].contiguous()
        new_lw, new_parts, parents = _one_step(params, E_c[..., t, :], E_k[..., t, :], lw, parts, M, u_sys, u_mult,
                                               return_parents=True)
        new_lw, shifts[:, t - 1], degen[:, t - 1] = _renormalise(new_lw)
        w_self = _compact_sum(torch.where(torch.isfinite(new_lw), torch.exp(new_lw), 0.0).to(f32), R, M)
        new_cols = State(*(_compact_rep(f, R, M) for f in new_parts.unbind(1)))
        prev = State(*parts.unbind(1))
        anc = State(*(f.gather(1, parents) for f in prev))
        psi_in = torch.where(psi_valid[:, :, None, None], psi, 0.0)
        w_prev = torch.where(torch.isfinite(lw), torch.exp(lw), 0.0).to(f32)
        psi = _structured_psi_update_compact(params, prev, w_prev, anc, psi_in)
        has_free = (~psi_valid).any(dim=1)
        ins = torch.where(has_free, (~psi_valid).to(torch.int8).argmax(dim=1),
                          torch.where(psi_valid, psi_time, T + 1).argmin(dim=1))
        means_ins = torch.einsum("ufn,un->uf", psi[units, ins], w_self)
        spill = spill + (~has_free).to(torch.int64)
        victim = psi_time[units, ins]
        out[units, victim] = torch.where(has_free[:, None], out[units, victim], means_ins)
        out_valid[units, victim] = out_valid[units, victim] | ~has_free
        psi[units, ins] = _test_functions(new_cols, R)
        psi_time[units, ins] = t
        psi_valid[units, ins] = True
        means = torch.einsum("usfn,un->usf", psi, w_self)
        sumsq = torch.einsum("usfn,un->usf", psi * psi, w_self)
        var = sumsq - means * means
        fin = psi_valid & ((var < epsilon).all(dim=2) | (t == T - 1))
        rows = units[:, None].expand(U, S)
        out[rows, psi_time] = torch.where(fin[..., None], means, out[rows, psi_time])
        out_valid[rows, psi_time] = out_valid[rows, psi_time] | fin
        psi_valid = psi_valid & ~fin
        lw, parts = new_lw, new_parts
    return out[:, :T], out_valid[:, :T], shift0 + shifts.sum(dim=-1), spill, degen.sum(dim=-1)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("draws", ["one", "per_unit", "injected"])
@pytest.mark.parametrize("window", [3, 64])
def test_marginal_step_equals_the_loop(K, draws, window):
    """T = 21: site 0, 19 sites of the step (a remainder for K = 3 and 8)
    and the last site, eager. A window of 3 pending times spills; 64 does
    not. Functionals, valid flags, logZ, spill counts and degenerate steps
    bit for bit."""
    T, U, M = 21, 3, 4
    params = _params(T)
    E_c, E_k = _tables(params, T, U, seed=8)
    kw = {}
    if draws == "injected":
        g = _gen(9)
        kw = dict(uniforms=(torch.rand((U, T - 1), generator=g), torch.rand((U, T - 1, M), generator=g)),
                  phantom_regime=0)
    gens = lambda: None if draws == "injected" else _generators(draws, U, 21)

    got = run_marginal_filter(params, E_c, E_k, M, n_units=U, generator=gens(), smoothing_window=window,
                              sites_per_graph=K, **kw)
    want = _reference_marginal(params, E_c, E_k, M, U, gens(), kw.get("uniforms"), 0.01, window)
    for name, a, b in zip(("functionals", "valid", "logZ", "spill_count", "degenerate_steps"), got, want):
        assert torch.equal(a, b), name
    assert bool(got.valid.all())
    assert (int(got.spill_count.sum()) > 0) == (window == 3)


@pytest.mark.parametrize("phantom_regime", [None, 0])
def test_marginal_filter_rejects_a_generator_list_of_another_length(phantom_regime):
    """As run_filter does: a list of per-unit generators must hold one a
    unit, whether or not the phantom regimes are drawn."""
    T, U, M = 5, 3, 4
    params = _params(T)
    E_c, E_k = _tables(params, T, U, seed=8)
    with pytest.raises(ValueError, match="2 generators for 3 units"):
        run_marginal_filter(params, E_c, E_k, M, n_units=U, generator=[_gen(1), _gen(2)],
                            phantom_regime=phantom_regime)


# ---- the simulators' chains ---------------------------------------------------

def _reference_two_group_chain(params, noise):
    """two_group.simulate.simulate_chain as it stood: a 0-dim state, the
    noise's row t read at the host's t."""
    T = noise.u_c.shape[0]
    r = torch.as_tensor(noise.phantom_r).to(torch.int32)
    z = torch.zeros_like(r)
    prev = State(m=torch.ones_like(r), d_c=z, r_c=r, d_k=z, r_k=r)
    states = torch.empty((T, 5), dtype=torch.int32)
    for t in range(T):
        prev = tg_sim.sample_transition(params, prev, tuple(x[t] for x in noise[1:]), step0=t == 0)
        states[t] = torch.stack(prev)
    return states


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("R_", [6, 5])
def test_two_group_chain_step_equals_the_loop(K, R_):
    """A 50-site chain (site 0 eager, 49 steps: a remainder for K = 3 and
    8) on a random transition matrix, from generator noise: the states bit
    for bit, merged and split sites both present."""
    T = 50
    params = make_params(
        mu=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50][:R_], sigma=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751][:R_],
        p_softmax_control=np.random.default_rng(R_).normal(size=(R_, R_)), omega_logit_control=np.full(R_, 1.2),
        omega_case=0.8, kappa_control=np.full(R_, 2.0), kappa_case=np.full(R_, 2.0), merge_log_prob=np.log(0.3),
        split_prob=0.2, minimum_duration=3, d_max=T + 1, device="cpu",
    )
    noise = tg_sim.draw_chain_noise(T, R_, generator=_gen(R_ + K), device="cpu")
    got = tg_sim.simulate_chain(params, noise, sites_per_graph=K)
    assert torch.equal(got, _reference_two_group_chain(params, noise))
    assert 0 < int((got[:, 0] == 0).sum()) < T


def _reference_single_group_chain(model, theta, noise):
    """single_group.simulate.simulate_chain as it stood: a 0-dim state, the
    noise's row t - 1 read at the host's t."""
    tables = build_tables(model, theta)
    T = noise.u.shape[0] + 1
    R = model.n_regimes
    d = torch.ones((), dtype=torch.int32)
    r = noise.r0.to(torch.int32)
    ds, rs = torch.empty((T,), dtype=torch.int32), torch.empty((T,), dtype=torch.int32)
    ds[0], rs[0] = d, r
    for t in range(1, T):
        r_idx = torch.clamp(r.long(), 0, R - 1)
        rho = tables.rho[r_idx, torch.clamp(d.long() - 1, 0, model.d_max - 1)]
        jump = noise.u[t - 1] <= rho
        new_r = torch.argmax(noise.g[t - 1] + tables.log_P[r_idx]).to(torch.int32)
        d = torch.where(jump, torch.ones_like(d), d + 1)
        r = torch.where(jump, new_r, r)
        ds[t], rs[t] = d, r
    return ds, rs


@pytest.mark.parametrize("K", KS)
def test_single_group_chain_step_equals_the_loop(K):
    """A 300-site chain (299 steps: a remainder for K = 3 and 8) at the
    verb's model with short sojourns (omega 0.9): d and r bit for bit,
    several change points."""
    T, R = 300, 6
    model = make_model([0.99, 0.01, 0.8, 0.2, 0.5, 0.5], [0.05, 0.05, 0.2, 0.2, 0.2, 0.2886751],
                       2, np.full(R, 2.0), device="cpu", d_max=512)
    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    theta = torch.as_tensor(parameters_to_theta(p, np.full(R, 0.9)), dtype=torch.float32)
    noise = sg_sim.draw_chain_noise(T, R, generator=_gen(K), device="cpu")
    d, r = sg_sim.simulate_chain(model, theta, noise, sites_per_graph=K)
    want_d, want_r = _reference_single_group_chain(model, theta, noise)
    assert torch.equal(d, want_d) and torch.equal(r, want_r)
    assert int((d == 1).sum()) > 5


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
