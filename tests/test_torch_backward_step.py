"""The backward pass's site step, ``two_group/backward.py::backward_site``, on
the CPU, and what of the CUDA backward step K3 (ops/cuda_backward_step.py)
can be checked without a card.

K3's arithmetic is restated here as its source orders it
(``_k3_restated``: the hazards staged once a row with the one log the row
uses, the structured lookup, the terms in the plain version's order, the
-inf rules, the noise of the uniforms and the argmax taking the first
maximum) and held bit for bit against ``_backward_logits`` +
``_categorical_rows`` on JAX filter histories, at a small width and at the
benchmark's (B, N, R) = (25, 2,400, 6). On the CPU ``backward_site`` is the
plain version, held bit for bit against the site step it replaced, and the
uniforms drawn into one buffer give the noise ``gumbel`` draws. K3's launch
checks, its shape bound and its argument struct need no card; the kernel
itself is held against the plain version in tests/test_torch_cuda.py.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygeia_tpu.ops.emissions import emission_log_prob_table as j_emission
from hygeia_tpu.two_group.filter import run_filter as j_run_filter
from hygeia_tpu_torch.ops import cuda_backward_step as k3
from hygeia_tpu_torch.ops.cuda_filter_step import HISTORY_DTYPES
from hygeia_tpu_torch.two_group import backward as bw
from hygeia_tpu_torch.two_group.model import State, params_from_numpy
from hygeia_tpu_torch.two_group.proposal import num_children
from tests.test_two_group_model import default_params

torch.set_num_threads(1)

SOURCE = Path(k3.__file__).resolve().parent.parent / "csrc" / "backward_step.cu"
NEG_INF = float("-inf")


def _k3_restated(params, lw_t, cur, nxt, u):
    """K3's arithmetic at one site, as csrc/backward_step.cu orders it: lw_t
    (U, N), cur the history row's five fields (U, N), nxt (U, B, 5), u
    (U, B, N). Returns the noisy logits (U, B, N) it compares and the
    particle (U, B) it draws."""
    R = params.n_regimes
    U, N = lw_t.shape
    B = nxt.shape[1]
    M = N // num_children(R)
    st = params.step_tables()
    rho, W, dt = st.rho_both, st.rho_both.shape[2], lw_t.dtype
    zero, neg = torch.zeros((), dtype=dt), torch.full((), NEG_INF, dtype=dt)
    ind = lambda c: torch.where(c, zero, neg)
    n = torch.arange(N)
    i, m = n // M, (n % M).expand(U, B, N)

    # The row's next state and what depends on it alone.
    nm, ndc, nrc, ndk, nrk = (x[..., None] for x in nxt.long().unbind(-1))  # (U, B, 1)
    dc1, dk1 = ndc == 1, ndk == 1
    log_rm1, log_rm2 = (torch.log(torch.tensor(float(v), dtype=dt)) for v in (R - 1, R - 2))
    ne_kc = nrk != nrc
    lp_a = ind((nrk == nrc) & (ndk == ndc))
    lp_b = (ind(ne_kc) - log_rm1) + ind(dk1)

    # Staged: of each hazard the one log the row uses.
    pick = lambda use_log, x: torch.where(use_log, torch.log(x), torch.log1p(-x))
    cm, cdc, crc, cdk, crk = (f.long()[:, None, :] for f in cur)  # (U, 1, N)
    dc0, dk0 = ((d[..., :M] - 1).clamp(0, W - 1) for d in (cdc, cdk))
    rc0, rk0 = (r[..., :M].clamp(0, R - 1) for r in (crc, crk))
    fc_anc = pick(dc1, rho[0, rc0, dc0])  # (U, B, M)
    fk_cont = pick(dk1, rho[1, rk0, dk0])
    fk_merge = pick(dk1, rho[1, rc0, dc0])
    fc1 = pick(dc1, rho[0, :, 0])  # (U, B, R)
    fk1 = pick(dk1, rho[1, :, 0])
    nrc_col = torch.where(nrc < 0, nrc + R, nrc).clamp(0, R - 1)[..., 0]
    lpc = params.log_p_control.T[nrc_col]  # (U, B, R): log_p_control[r, next r_c]

    # A particle's logit and noise.
    take = lambda table, index: table.gather(-1, index.expand(U, B, N))
    rcc, rkc = crc.clamp(0, R - 1), crk.clamp(0, R - 1)
    fc = torch.where(cdc <= 1, take(fc1, rcc), take(fc_anc, m))
    fk = torch.where(cdk <= 1, take(fk1, rkc), torch.where(i == 2 * R - 1, take(fk_merge, m), take(fk_cont, m)))
    gate = torch.minimum(cdk, cdc) >= params.min_duration
    mc = cm.clamp(0, 1)
    lpm = params.log_p_merged
    lp_m = torch.where(gate, torch.where(nm == 0, lpm[mc, 0], lpm[mc, 1]), ind(nm == cm))
    lp_c = torch.where(dc1, fc + take(lpc, rcc), (fc + ind(cdc == ndc - 1)) + ind(crc == nrc))
    rc_is_crk = nrc == crk
    lp_unif2 = (ind(ne_kc) + ind(nrk != crk)) - torch.where(rc_is_crk, log_rm1, log_rm2)
    lp_d = torch.where(dk1, fk + lp_unif2, (fk + ind(cdk + 1 == ndk)) + ind(crk == nrk))
    lp_k = torch.where(nm == 1, lp_a, torch.where((cm == 1) & ~dc1, lp_b,
                                                  torch.where(rc_is_crk & (cm == 0), ind(dk1) + lp_unif2, lp_d)))
    trans = (lp_m + lp_c) + lp_k
    lw = lw_t[:, None, :]
    noise = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dt).tiny)))
    v = torch.where((lw > NEG_INF) & torch.isfinite(trans), noise + (lw + trans), neg)
    # The largest value, the first index among equal ones.
    return v, torch.where(v == v.amax(-1, keepdim=True), n, N).amin(-1)


def _jax_history(R, M, T, min_duration, seed):
    """A JAX filter history in float32 and the port's float32 parameters:
    (params, lw (1, T, N), the five fields (1, T, N) in HISTORY_DTYPES)."""
    jparams = default_params(R=R, min_duration=min_duration, d_max=4 * T)
    rng = np.random.default_rng(seed)
    n = rng.poisson(25, size=(T, 2)).astype(np.float64)
    y = np.minimum(rng.poisson(10, size=(T, 2)), n).astype(np.float64)
    E_c = j_emission(y, n, jparams.alpha, jparams.beta, dtype=jnp.float64)
    E_k = j_emission(np.minimum(y + 2, n), n, jparams.alpha, jparams.beta, dtype=jnp.float64)
    res = j_run_filter(jax.random.PRNGKey(seed), jparams, E_c, E_k, M, weight_dtype=jnp.float64, unroll=1)
    params = params_from_numpy({k: np.array(v) for k, v in jparams._asdict().items()}, device="cpu",
                               dtype=torch.float32)
    hist = [torch.from_numpy(np.array(x))[None].to(dt) for x, dt in zip((res.log_weights, *res.particles),
                                                                          HISTORY_DTYPES)]
    return params, hist[0], State(*hist[1:])


def _next_states(params, lw, parts, B, seed):
    """Next states for every site: the plain backward pass's draws on the
    history (feasible rows) and as many random states (most rows
    infeasible, some with a next duration of 1): (1, T, 2B, 5)."""
    R = params.n_regimes
    T = lw.shape[1]
    drawn = bw.backward_simulation(params, lw, parts, B, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    rand = lambda hi, lo=0: torch.randint(lo, hi, (1, T, B), generator=g, dtype=torch.int32)
    m, d_c, r_c, d_k, r_k = rand(2), rand(6, 1), rand(R, -1), rand(6, 1), rand(R)
    random = torch.stack([m, d_c, r_c, torch.where(m == 1, d_c, d_k), torch.where(m == 1, r_c, r_k)], dim=-1)
    return torch.cat([drawn, random], dim=2)


@pytest.mark.parametrize("R,M,T,B,min_duration", [(4, 5, 30, 9, 2), (6, 50, 10, 25, 3)])
def test_k3_restated_is_the_plain_composition_on_jax_histories(R, M, T, B, min_duration):
    """Every row of a JAX filter history (R = 4, M = 5; and the benchmark's
    R = 6, M = 50, N = 2,400 with B = 25 draws from the plain backward pass
    and 25 random next states): K3's noisy logits equal noise +
    _backward_logits(history_layout=True) bit for bit, -inf where they are,
    and its draws equal _categorical_rows'."""
    params, lw, parts = _jax_history(R, M, T, min_duration, seed=R)
    nxt_all = _next_states(params, lw, parts, B, seed=R)
    g = torch.Generator().manual_seed(7)
    finite_rows = dead_rows = 0
    for t in range(T - 1):
        cur = State(*(f[:, t] for f in parts))
        nxt = nxt_all[:, t + 1].contiguous()
        u = torch.rand(nxt.shape[:2] + lw.shape[-1:], generator=g)
        logits = bw._backward_logits(params, cur, State(*nxt.unbind(-1)), lw[:, t], history_layout=True)
        noise = bw._noise(u)
        v, sel = _k3_restated(params, lw[:, t], cur, nxt, u)
        assert torch.equal(v, noise + logits), f"site {t}"
        assert torch.equal(sel, bw._categorical_rows(logits, noise)), f"site {t}"
        finite = torch.isfinite(v).any(-1)
        finite_rows += int(finite.sum())
        dead_rows += int((~finite).sum())
    assert finite_rows >= (T - 1) * B and dead_rows > 0  # every drawn row feasible, some random ones not


def _old_site_step(params, log_weights, particles, t_dev, nxt, traj, draw):
    """The backward pass's site step before K3, as it was written."""
    cur = State(*(f.index_select(1, t_dev).squeeze(1) for f in particles))
    lw_t = log_weights.index_select(1, t_dev).squeeze(1)
    logits = bw._backward_logits(params, cur, State(*nxt.unbind(-1)), lw_t, history_layout=True)
    sel = bw._categorical_rows(logits, draw())
    new = torch.stack([f.gather(1, sel).to(torch.int32) for f in cur], dim=-1)
    traj.index_copy_(1, t_dev, new[:, None])
    nxt.copy_(new)
    t_dev.sub_(1)


def _port_history(U=3, M=6, T=24, dtype=torch.float32):
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.two_group.filter import run_filter
    from hygeia_tpu_torch.two_group.model import make_params

    R = 6
    params = make_params(
        mu=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50], sigma=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751],
        p_softmax_control=np.zeros((R, R)), omega_logit_control=np.full(R, 4.0), omega_case=0.8,
        kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
        split_prob=0.01, minimum_duration=3, d_max=T + 1, device="cpu",
    )
    rng = np.random.default_rng(2)
    n = rng.poisson(20, size=(U, T, 2))
    tab = lambda p: torch.stack([emission_log_prob_table(rng.binomial(n[u], p), n[u], params.alpha, params.beta)
                                 for u in range(U)])
    res = run_filter(params, tab(0.7), tab(0.3), M, n_units=U, generator=torch.Generator().manual_seed(1),
                     weight_dtype=dtype)
    return params, res.log_weights, res.particles


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("per_unit", [False, True])
def test_backward_site_on_the_cpu_is_the_old_site_step(dtype, per_unit):
    """From the same carry, site after site: the draws, the carry, the
    trajectories and the index equal the old step's bit for bit, the old
    step drawing ``gumbel`` noise and backward_site the uniforms of the
    same generators into one buffer."""
    params, lw, parts = _port_history(dtype=dtype)
    U, T, N = lw.shape
    B = 7
    gens = lambda: ([torch.Generator().manual_seed(30 + k) for k in range(U)] if per_unit
                    else torch.Generator().manual_seed(30))
    g_old, g_new = gens(), gens()
    start = torch.stack([f[:, T - 1, :B].to(torch.int32) for f in parts], dim=-1)
    old = (torch.zeros((U, T, B, 5), dtype=torch.int32), start.clone(), torch.tensor([T - 2]))
    new = (torch.zeros((U, T, B, 5), dtype=torch.int32), start.clone(), torch.tensor([T - 2, 0]))
    u = torch.empty((U, B, N), dtype=dtype)
    for _ in range(T - 1):
        _old_site_step(params, lw, parts, old[2], old[1], old[0],
                       lambda: bw.gumbel((U, B, N), generator=g_old, dtype=dtype))
        bw.backward_site(params, lw, parts, new[2], new[1], new[0], uniforms=bw._draw_uniforms(u, g_new))
        assert torch.equal(old[0], new[0]) and torch.equal(old[1], new[1])
        assert int(new[2][0]) == int(old[2][0]) and int(new[2][1]) == 0
    assert int(new[2][0]) == -1 and bool((new[0][:, :T - 1] >= 0).any())


@pytest.mark.parametrize("use_terminal", ["none", "all", "some"])
@pytest.mark.parametrize("per_unit", [False, True])
def test_backward_simulation_draws_what_gumbel_draws(use_terminal, per_unit):
    """The generator route (uniforms into one buffer) against the injected
    route fed ``gumbel`` from generators of the same seeds, site T - 1
    first: the same trajectories for each terminal mode."""
    params, lw, parts = _port_history()
    U, T, N = lw.shape
    B = 5
    gens = lambda: ([torch.Generator().manual_seed(50 + k) for k in range(U)] if per_unit
                    else torch.Generator().manual_seed(50))
    term = torch.stack([f[:, 0, :B].to(torch.int32) for f in parts], dim=-1)  # feasible states at T - 1 + 1
    use = {"none": False, "all": True, "some": torch.tensor([True, False, True])}[use_terminal]
    got = bw.backward_simulation_conditioned(params, lw, parts, term, use, num_simulations=B, generator=gens())
    g = gens()
    want = bw.backward_simulation_conditioned(params, lw, parts, term, use, num_simulations=B,
                                              noise=lambda t: bw.gumbel((U, B, N), generator=g))
    assert torch.equal(got, want)
    if use_terminal == "none":
        assert torch.equal(got, bw.backward_simulation(params, lw, parts, B, generator=gens()))


def test_backward_site_refuses_injected_noise_off_the_cpu():
    params, lw, parts = _port_history()
    with pytest.raises(ValueError, match="CPU-only"):
        bw.backward_simulation(params, lw.to("meta"), State(*(f.to("meta") for f in parts)), 3,
                               noise=lambda t: None)


def _launch_inputs(U=2, T=5, B=3, M=4, R=6):
    """check_inputs' arguments at a small shape, every one as the kernel
    takes it (CPU tensors)."""
    params = default_params(R=R, d_max=16)
    tp = params_from_numpy({k: np.array(v) for k, v in params._asdict().items()}, device="cpu",
                           dtype=torch.float32)
    N = M * num_children(R)
    st = tp.step_tables()
    return dict(idx=torch.tensor([T - 1, 0]), hist=tuple(torch.zeros((U, T, N), dtype=dt) for dt in HISTORY_DTYPES),
                uniforms=torch.zeros((U, B, N)), nxt=torch.zeros((U, B, 5), dtype=torch.int32),
                traj=torch.zeros((U, T, B, 5), dtype=torch.int32), rho_both=st.rho_both,
                log_p_control=tp.log_p_control, log_p_merged=tp.log_p_merged)


def test_check_inputs_takes_the_backward_tensors():
    assert k3.check_inputs(**_launch_inputs()) == (2, 5, 3, 4 * 48, 4, 6, 16)


@pytest.mark.parametrize("name,change,error,match", [
    ("hist", lambda h: (h[0].double(), *h[1:]), TypeError, r"hist\[0\] has dtype"),
    ("hist", lambda h: (h[0], h[1].int(), *h[2:]), TypeError, r"hist\[1\] has dtype"),
    ("hist", lambda h: h[:5], ValueError, "six"),
    ("hist", lambda h: tuple(x[..., :-1] for x in h), ValueError, "N = M"),
    ("uniforms", lambda x: x.double(), TypeError, "uniforms has dtype"),
    ("uniforms", lambda x: x[..., :-1].contiguous(), ValueError, "uniforms has shape"),
    ("uniforms", lambda x: x[0], ValueError, "uniforms must be"),
    ("uniforms", lambda x: x.transpose(0, 1).contiguous().transpose(0, 1), ValueError, "contiguous"),
    ("idx", lambda x: x.int(), TypeError, "idx has dtype"),
    ("idx", lambda x: x[:1], ValueError, "idx has shape"),
    ("nxt", lambda x: x.long(), TypeError, "nxt has dtype"),
    ("traj", lambda x: x[:, :-1], ValueError, "traj has shape"),
    ("rho_both", lambda x: x.double(), TypeError, "rho_both has dtype"),
    ("log_p_merged", lambda x: x.double(), TypeError, "log_p_merged has dtype"),
])
def test_check_inputs_refuses_what_the_kernel_cannot_take(name, change, error, match):
    kw = _launch_inputs()
    kw[name] = change(kw[name])
    with pytest.raises(error, match=match):
        k3.check_inputs(**kw)


def test_check_inputs_refuses_a_tensor_on_another_device():
    kw = _launch_inputs()
    kw["nxt"] = kw["nxt"].to("meta")
    with pytest.raises(ValueError, match="nxt is on meta"):
        k3.check_inputs(**kw)


def test_backward_step_cuda_refuses_cpu_tensors(monkeypatch):
    """The refusal comes before the library is loaded and counts no launch."""

    def load():
        raise AssertionError("the library was loaded for CPU tensors")

    monkeypatch.setattr(k3.KERNEL, "load", load)
    before = (k3.KERNEL.launches, k3.KERNEL.captured)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k3.backward_step_cuda(min_duration=3, **_launch_inputs())
    assert (k3.KERNEL.launches, k3.KERNEL.captured) == before


def test_supports_the_main_shapes_and_states_its_bounds():
    for M, B, R in ((50, 25, 6), (50, 1, 5), (150, 25, 6), (1, 1, 1), (244, 25, 6)):
        assert k3.supports(M * num_children(R), B, R) is None
    assert k3.smem_bytes(50, 6) == 4 * (3 * 50 + 3 * 6 + 4)
    assert "N = M" in k3.supports(2401, 25, 6)
    assert "N = M" in k3.supports(47, 25, 6)
    assert "R must be <= 127" in k3.supports(num_children(128), 25, 128)
    assert "shared memory" in k3.supports(20_000 * num_children(6), 25, 6)
    assert "B >= 1" in k3.supports(2400, 0, 6)


def test_argument_struct_matches_the_kernel_source():
    """_Args lists BackwardStepArgs' fields in the kernel's order with the
    kernel's C types."""
    src = SOURCE.read_text()
    body = re.search(r"struct BackwardStepArgs \{(.*?)\n\};", src, re.S).group(1)
    c_fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        ctype, names = re.match(
            r"((?:const )?(?:unsigned |signed )?(?:long long|int|float|char)\*?)\s+(.*)", decl).groups()
        for name in names.split(","):
            c_fields.append((ctype.strip(), name.strip()))
    kinds = {ctypes.c_void_p: "*", ctypes.c_int64: "long long", ctypes.c_int: "int", ctypes.c_float: "float"}
    py_fields = [(kinds[t], n) for n, t in k3._Args._fields_]
    assert [n for _, n in c_fields] == [n for _, n in py_fields]
    for (ct, n), (pt, _) in zip(c_fields, py_fields):
        assert ct.endswith("*") if pt == "*" else ct == pt, n
