"""The single-group engine's site step and what of the CUDA engine step K4
(ops/cuda_engine_step.py) can be checked without a card.

On the CPU every site takes the plain composition (``_Engine._step_plain``)
and K4 is never called. K4's decomposition of the step, restated here in
PyTorch as its three stages compute it (WEIGHTS a unit at a time, SMOOTH an
entry at a time with its insertion slot and finalisation rules, GRADIENT a
column of φ at a time with the column's owner regime), is held against the
plain composition in float64. K4's launch checks (``check_inputs``), its
bounds (``supports``), the route (``takes``, which refuses a CUDA engine
K4 cannot take, and ``_Engine.takes_k4``) and its argument struct, which
must match the kernel's source field for field, need no card; the kernel
itself is held against the plain composition in tests/test_torch_cuda.py.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hygeia_tpu_torch.ops import cuda_engine_step as k4
from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
from hygeia_tpu_torch.single_group import engine as sg_engine
from hygeia_tpu_torch.single_group.engine import EngineConfig, _Engine, _site_uniforms
from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta

torch.set_num_threads(1)

SOURCE = Path(k4.__file__).resolve().parent.parent / "csrc" / "engine_step.cu"
R = 6


def _engine(case, T=120, N=60, S=16, dtype=torch.float64, device="cpu"):
    """A small engine: R = 6, u = 3, updates every 50 sites. Cases: "cell"
    (U = 1, one table), "per_unit" (U = 3, a table a unit), "no_regimes",
    "kappa_free" (D = 42), "t_limit" (U = 3, t_limit (T, 70, 90))."""
    U = 3 if case in ("per_unit", "t_limit") else 1
    kappa_fixed = case != "kappa_free"
    model = make_model([0.95, 0.05, 0.8, 0.2, 0.5, 0.5], [0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751], 3,
                       np.full(R, 2.0), device=device, kappa_fixed=kappa_fixed, dtype=dtype)
    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    theta = parameters_to_theta(p, [0.995, 0.975, 0.95, 0.925, 0.9, 0.9], np.full(R, 2.0), kappa_fixed)
    rng = np.random.default_rng(len(case))
    tables = []
    for _ in range(U):
        n = rng.poisson(20, size=(T, 2))
        y = rng.binomial(n, np.repeat(rng.uniform(0, 1, T // 20), 20)[:, None])
        tables.append(emission_log_prob_table(y, n, model.alpha, model.beta).to(dtype))
    E = torch.stack(tables) if U > 1 else tables[0]
    cfg = EngineConfig(n_particles_max=N, smoothing_window=S, estimate_regimes=case != "no_regimes",
                       estimate_parameters=True, steps_per_update=50)
    t_limit = [T, 70, 90] if case == "t_limit" else None
    return _Engine(model, theta, E, cfg, U, dtype, t_limit=t_limit)


# ---- K4's three stages restated -------------------------------------------

def _weights(eng, res, t, ws):
    """WEIGHTS: a unit at a time in the kernel, all units at once here."""
    st, U, N, M, W = eng.state, eng.U, eng.N, eng.M, eng.model.d_max
    dp, rp, wp = st["d"].clone(), st["r"].clone(), st["w"].clone()
    ri = rp.clamp(0, R - 1)
    k = ri * W + (dp - 1).clamp(0, W - 1)
    hz = eng.haz
    rho, ex, gom = (hz[:, j].gather(1, k) for j in range(3))
    gka = hz[:, 3].gather(1, k) if eng.n_haz > 3 else torch.zeros_like(rho)
    ex = ex > 0.5
    lrt = torch.where(ex, 0.0, torch.log(rho))
    dok = dp >= eng.model.u
    ws["prev_code"] = torch.where(dok, ri, -1)
    ws["g_prev"] = (gom, gka)
    sw = torch.where(torch.isfinite(wp), wp, -torch.inf)
    q = torch.arange(R)[None, :, None]
    lp = eng.log_P.gather(1, ri[:, :, None].expand(-1, -1, R)).transpose(1, 2)  # (U, q, n)
    lb = torch.where(dok[:, None] & (q != rp[:, None]), (lrt[:, None] + lp) + sw[:, None], -torch.inf)
    mx = lb.amax(-1)
    mq = torch.where(mx.abs() == torch.inf, 0.0, mx)
    lbz = torch.log(torch.exp(lb - mq[..., None]).sum(-1)) + mq
    use_opt = (torch.isfinite(wp).sum(-1) > M) & ~res.use_unbiased
    p = torch.where(use_opt[:, None], res.parent_indices.long(), res.top_m_indices.long())
    aw = torch.where(use_opt[:, None], res.new_log_weights.to(wp.dtype), wp.gather(1, p))
    rho_a, ex_a, ra = rho.gather(1, p), ex.gather(1, p), rp.gather(1, p)
    obs = eng.emissions[:, t]
    wc = aw + (torch.where(ex_a | (rho_a > 1), -torch.inf, torch.log1p(-rho_a)) + obs.gather(1, ra))
    coef = torch.where(ex_a | (rho_a >= 1), 0.0, -rho_a / (1 - rho_a))
    ws["anc"], ws["g_anc"] = p, (coef * gom.gather(1, p), coef * gka.gather(1, p))
    wf = lbz + obs
    wn = torch.cat([wc, wf], 1)
    ms = wn.amax(-1)
    ms = torch.where(ms.abs() == torch.inf, 0.0, ms)
    shift = torch.log(torch.exp(wn - ms[:, None]).sum(-1)) + ms
    ws["b"] = torch.where(torch.isfinite(lbz)[..., None], torch.exp(lb - lbz[..., None]), 0.0)
    wn = wn - shift[:, None]
    ws["w_self"] = torch.where(torch.isfinite(wn), torch.exp(wn), 0.0)
    st["d"][:] = torch.cat([dp.gather(1, p) + 1, torch.ones((U, R), dtype=dp.dtype)], 1)
    st["r"][:] = torch.cat([ra, torch.arange(R).expand(U, R)], 1)
    st["w"][:] = wn
    st["shifts"][:, t] = shift
    if eng.config.estimate_regimes:
        valid, times = st["psi_valid"], st["psi_time"]
        free = [int(np.flatnonzero(~v.numpy())[0]) if not bool(v.all()) else None for v in valid]
        old = [int(torch.where(v, tm, eng.T + 1).argmin()) for v, tm in zip(valid, times)]
        ws["slot"] = [(f if f is not None else o, f is not None) for f, o in zip(free, old)]
        for u, (_, was_free) in enumerate(ws["slot"]):
            st["spill"][u] += 0 if was_free else 1


def _smooth(eng, t, ws, final, live):
    """SMOOTH: an entry at a time, as a block of the kernel takes it; a
    unit past its t_limit writes nothing."""
    st, S = eng.state, eng.S
    for u in range(eng.U):
        if live is not None and not bool(live[u]):
            continue
        ins, has_free = ws["slot"][u]
        b, w_self, anc = ws["b"][u], ws["w_self"][u], ws["anc"][u]
        for s in range(S):
            valid_old, time_old = bool(st["psi_valid"][u, s]), int(st["psi_time"][u, s])
            P = st["psi"][u, s].clone()
            if valid_old:
                Q = torch.cat([P[:, anc], P @ b.T], 1)
            else:
                Q = torch.zeros_like(P)
            if s == ins:
                if not has_free:
                    st["out"][u, time_old] = (Q @ w_self).float()
                    st["out_valid"][u, time_old] = True
                Q = (st["r"][u][None, :] == torch.arange(R)[:, None]).to(Q.dtype)
            valid_new = valid_old or s == ins
            time_new = t if s == ins else time_old
            mean = Q @ w_self if valid_new else torch.zeros(R, dtype=Q.dtype)
            sec = ((Q - mean[:, None]) ** 2) @ w_self if valid_new else torch.zeros(R, dtype=Q.dtype)
            all_below = bool((sec < eng.config.epsilon).all())
            forced = False
            if final is True:
                fin = valid_new
            else:
                aged = time_new <= t - S
                forced = aged and not all_below
                if final is not False and bool(final[u]):
                    forced, all_below = False, True
                fin = valid_new and (all_below or aged)
            if valid_new and forced:
                st["spill"][u] += 1
            if fin:
                st["out"][u, time_new] = mean.float()
                st["out_valid"][u, time_new] = True
            st["psi_time"][u, s] = time_new
            st["psi_valid"][u, s] = valid_new and not fin
            st["psi"][u, s] = Q


def _gradient(eng, ws):
    """GRADIENT: a column of φ at a time, through the column's owner."""
    st, M, D = eng.state, eng.M, eng.D
    om_col, ka_col = R * (R - 1), R * R
    for u in range(eng.U):
        b, w_self, anc, code = ws["b"][u], ws["w_self"][u], ws["anc"][u], ws["prev_code"][u]
        phi = st["phi"][u].clone()
        for d in range(D):
            if d < om_col:
                owner, kind = d // (R - 1), 0
                k = d - owner * (R - 1)
                jd = k if k < owner else k + 1
            else:
                owner, kind = (d - om_col, 1) if d < ka_col else (d - ka_col, 2)
            col = phi[:, d]
            fr = b @ col
            own = code == owner
            gr = torch.zeros(R, dtype=col.dtype)
            for q in range(R):
                allowed = own & (code != q)
                if kind == 0:
                    g = ((1.0 if q == jd else 0.0) - eng.P[u, owner, jd]) * allowed
                else:
                    g = torch.where(allowed, ws["g_prev"][kind - 1][u], 0.0)
                gr[q] = (b[q] * g).sum()
            ra = st["r"][u, :M]
            gc = torch.where(ra + om_col == d, ws["g_anc"][0][u],
                             torch.where(ra + ka_col == d, ws["g_anc"][1][u], 0.0))
            st["phi"][u, :, d] = torch.cat([col[anc] + gc, fr + gr])
        st["score"][u] = w_self @ st["phi"][u]


def _k4_restated(eng, t, u_sys, u_mult):
    """Site t as K4 steps it (the plain ADAM step and rebuild at an update,
    as on the card)."""
    st, cfg = eng.state, eng.config
    res = sg_engine.optimal_resampling(st["w"].to(torch.float32).contiguous(), eng.M, u_sys, u_mult)
    live = None if t < eng.t_freeze else eng.live[t]
    keep = {k: st[k].clone() for k in sg_engine._FROZEN} if live is not None else {}
    ws = {}
    _weights(eng, res, t, ws)
    if cfg.estimate_regimes:
        _smooth(eng, t, ws, eng._final(t), live)
    updated = eng._estimate(t, lambda: _gradient(eng, ws))
    for k, v in keep.items():  # K4 leaves a unit past its t_limit alone
        st[k].copy_(torch.where(live.view(-1, *([1] * (v.dim() - 1))), st[k], v))
    if live is not None:
        st["shifts"][:, t] = torch.where(live, st["shifts"][:, t], 0.0)
    if updated:
        eng._set_tables(sg_engine.build_tables(eng.model, st["theta"]))
    st["trace"][:, t] = st["theta"]
    eng.t_dev.add_(1)


def _snapshot(eng):
    snap = {k: v.clone() for k, v in eng.state.items() if torch.is_tensor(v)}
    snap.update(haz=eng.haz.clone(), log_P=eng.log_P.clone(), P=eng.P.clone(), t_dev=eng.t_dev.clone())
    return snap


def _restore(eng, snap):
    for k, v in snap.items():
        (eng.state[k] if k in eng.state else getattr(eng, k)).copy_(v)


@pytest.mark.parametrize("case,t0", [("cell", 57), ("cell", 100), ("per_unit", 77), ("no_regimes", 63),
                                     ("kappa_free", 50), ("t_limit", 69), ("t_limit", 95), ("t_limit", 100),
                                     ("cell", 119)])
def test_k4_restated_is_the_plain_composition(case, t0):
    """K4's decomposition of a site at capacity, in float64 from the same
    state and uniforms, gives the plain composition's particles, weights,
    shift, smoothing buffer, finalised rows, spills, φ, score and θ to
    1e-10: at steady sites, an update site (t = 50, 100), with a table a
    unit, the regime pass off, κ estimated, the site where a unit's
    t_limit ends (69) and past it (95; 100, an update), and the last site
    (119)."""
    eng = _engine(case)
    g = torch.Generator().manual_seed(3)
    for t in range(1, t0):
        eng.step(t, *_site_uniforms(eng.U, eng.M, g, "cpu"))
    assert not eng.takes_k4(t0)  # the CPU takes the plain composition
    eng.k4 = True
    assert eng.takes_k4(t0) and not eng.takes_k4(eng.M // R)
    eng.k4 = False
    draws = _site_uniforms(eng.U, eng.M, g, "cpu")
    snap = _snapshot(eng)
    eng.step(t0, *draws)
    want = _snapshot(eng)
    _restore(eng, snap)
    _k4_restated(eng, t0, *draws)
    got = _snapshot(eng)
    T = eng.T
    for k in ("d", "r", "psi_time", "psi_valid", "spill", "adam_iter", "t_dev"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["out_valid"][:, :T], want["out_valid"][:, :T])
    torch.testing.assert_close(got["out"][:, :T], want["out"][:, :T], rtol=0, atol=1e-6)  # float32 rows
    for k in ("w", "shifts", "psi", "phi", "score", "theta", "adam_m", "adam_v", "trace", "haz"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-10, atol=1e-10, equal_nan=True, msg=k)


# ---- the route -------------------------------------------------------------

@pytest.mark.parametrize("device,dtype,shape,taken", [
    ("cuda", torch.float32, (250, 128, 6, 36), True),  # the θ cell
    ("cuda", torch.float32, (250, 128, 6, 42), True),  # κ estimated
    ("cuda", torch.float32, (2400, 512, 8, 72), True),
    ("cuda", torch.float32, (30, 4, 1, 1), True),
    ("cuda", torch.float64, (250, 128, 6, 36), (TypeError, "float32 weights, got torch.float64")),
    ("cuda", torch.bfloat16, (250, 128, 6, 36), (TypeError, "float32 weights, got torch.bfloat16")),
    ("cpu", torch.float32, (250, 128, 6, 36), False),
    ("cpu", torch.float64, (250, 128, 6, 36), False),
    ("cpu", torch.float32, (250, 128, 9, 81), False),  # the CPU takes any shape
    ("cuda", torch.float32, (250, 128, 9, 81), (ValueError, "R must be in")),  # R beyond 8
    ("cuda", torch.float32, (250, 128, 6, 30), (ValueError, "D = R")),  # D neither R^2 nor R(R + 1)
    ("cuda", torch.float32, (6, 128, 6, 36), (ValueError, "N > R")),  # N = R
    ("cuda", torch.float32, (3300, 128, 6, 36), (ValueError, "shared memory")),  # beyond shared memory
])
def test_the_route_takes_k4_only_for_cuda_f32_within_bounds(device, dtype, shape, taken):
    """The CPU takes the plain composition; a CUDA engine takes K4, or is
    refused with the bound it breaks: nothing on the card falls back."""
    if isinstance(taken, tuple):
        error, match = taken
        with pytest.raises(error, match=match):
            k4.takes(torch.device(device), dtype, *shape)
    else:
        assert k4.takes(torch.device(device), dtype, *shape) is taken


@pytest.mark.parametrize("N", [60, 250, 2400])
def test_the_engine_takes_k4_only_at_sites_at_capacity(N):
    """With K4 in reach, exactly the sites at capacity take it: t from
    (N - R) // R + 1 on (41 at N = 250); the growth phase does not."""
    eng = _engine("cell", T=600, N=N, dtype=torch.float32)
    assert not eng.k4 and eng.k4_ws is None
    assert not any(eng.takes_k4(t) for t in range(1, eng.T))
    eng.k4 = True
    first = (N - R) // R + 1
    assert [t for t in range(1, eng.T) if eng.takes_k4(t)] == list(range(first, eng.T))
    if N == 250:
        assert first == 41


@pytest.mark.parametrize("case", ["cell", "per_unit", "no_regimes", "kappa_free", "t_limit"])
def test_the_cpu_engine_never_calls_k4(case, monkeypatch):
    """The CPU engine takes the plain composition at every site, growth
    and capacity alike: K4 is never called, and a rerun gives the same
    bits."""
    def refuse(*a, **kw):
        raise AssertionError("K4 was called on the CPU")

    monkeypatch.setattr(k4, "engine_step_cuda", refuse)
    out = []
    for _ in range(2):
        eng = _engine(case, dtype=torch.float32)
        g = torch.Generator().manual_seed(9)
        with sg_engine.SiteLoop(eng.device, 8, g) as loop:
            sg_engine._run_sites(eng, loop, 1, eng.T, sg_engine._site_draws(eng, None, None, g))
        out.append(eng.result())
    for a, b in zip(*out):
        for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
            assert torch.equal(x, y)
    lim = [120, 70, 90] if case == "t_limit" else [120] * len(out[0].regime_valid)
    valid = [bool(v[:n].all()) for v, n in zip(out[0].regime_valid, lim)]
    assert all(valid) or case == "no_regimes"


# ---- the launch's checks -------------------------------------------------

def _launch_inputs(case="cell", live=False, final=False):
    """check_inputs' arguments from a small f32 engine on the CPU, as the
    kernel takes them."""
    eng = _engine(case, dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    res = sg_engine.optimal_resampling(eng.state["w"], eng.M, *_site_uniforms(eng.U, eng.M, g, "cpu"))
    ws = k4.workspace(eng.U, eng.N, R, "cpu")
    return eng, dict(state=eng.state, resampled=res, tables=(eng.haz, eng.log_P, eng.P), emissions=eng.emissions,
                     ws=ws, t_dev=eng.t_dev, live=eng.live if live else None,
                     final=torch.zeros(eng.U, dtype=torch.bool) if final else False)


@pytest.mark.parametrize("case,live,final", [("cell", False, False), ("per_unit", False, True),
                                             ("kappa_free", False, False), ("t_limit", True, True)])
def test_check_inputs_takes_the_engines_tensors(case, live, final):
    eng, kw = _launch_inputs(case, live, final)
    U, N, M, R_, W, S, D, n_haz, T, strides = k4.check_inputs(**kw)
    assert (U, N, M, R_, S, D, T) == (eng.U, 60, 54, R, 16, eng.D, 120)
    assert W == eng.model.d_max and n_haz == (4 if case == "kappa_free" else 3)
    assert strides == (eng.emissions.stride(0), R) and (U == 1 or strides[0] == 120 * R)


def _swap_state(key, change):
    return lambda kw: {**kw, "state": {**kw["state"], key: change(kw["state"][key])}}


def _swap(key, change):
    return lambda kw: {**kw, key: change(kw[key])}


@pytest.mark.parametrize("change,error,match", [
    (_swap_state("w", lambda x: x.double()), TypeError, r"state\['w'\] has dtype"),
    (_swap_state("d", lambda x: x.int()), TypeError, r"state\['d'\] has dtype"),
    (_swap_state("r", lambda x: x[:, :-1]), ValueError, r"state\['r'\] has shape"),
    (_swap_state("psi", lambda x: x[:, :, :5]), ValueError, r"state\['psi'\] has shape"),
    (_swap_state("psi_valid", lambda x: x.to(torch.uint8)), TypeError, r"state\['psi_valid'\] has dtype"),
    (_swap_state("out", lambda x: x[:, :-1]), ValueError, r"state\['out'\] has shape"),
    (_swap_state("spill", lambda x: x.int()), TypeError, r"state\['spill'\] has dtype"),
    (_swap_state("phi", lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)), ValueError,
     r"state\['phi'\] must be contiguous"),
    (_swap_state("score", lambda x: x[:, :-1]), ValueError, r"state\['score'\] has shape"),
    (_swap_state("phi", lambda x: x[:, :, :30]), ValueError, "D = R"),
    (_swap("resampled", lambda r: r._replace(parent_indices=r.parent_indices.long())), TypeError,
     "parent_indices has dtype"),
    (_swap("resampled", lambda r: r._replace(top_m_indices=r.top_m_indices[:, :-1])), ValueError,
     "top_m_indices has shape"),
    (_swap("tables", lambda t: (t[0].double(), *t[1:])), TypeError, "haz has dtype"),
    (_swap("tables", lambda t: (t[0][:, :2], *t[1:])), ValueError, "haz must be"),
    (_swap("tables", lambda t: (t[0], t[1], t[2].double())), TypeError, "p has dtype"),
    (_swap("emissions", lambda e: e.double()), TypeError, "emissions has dtype"),
    (_swap("emissions", lambda e: e.transpose(-1, -2).contiguous().transpose(-1, -2)), ValueError,
     "contiguous regimes"),
    (_swap("ws", lambda w: w._replace(anc=w.anc.long())), TypeError, r"ws\.anc has dtype"),
    (_swap("ws", lambda w: w._replace(b=w.b[:, :, :-1])), ValueError, r"ws\.b has shape"),
    (_swap("t_dev", lambda x: x.int()), TypeError, "t_dev has dtype"),
    (_swap("live", lambda x: torch.ones((3, 1), dtype=torch.bool)), ValueError, "live has shape"),
    (_swap("final", lambda x: torch.zeros((1,), dtype=torch.int64)), TypeError, "final has dtype"),
    (_swap("final", lambda x: 1), TypeError, "final must be"),
])
def test_check_inputs_refuses_what_the_kernel_cannot_take(change, error, match):
    _, kw = _launch_inputs()
    with pytest.raises(error, match=match):
        k4.check_inputs(**change(kw))


def test_check_inputs_refuses_a_tensor_on_another_device():
    _, kw = _launch_inputs()
    kw["state"] = {**kw["state"], "psi": kw["state"]["psi"].to("meta")}
    with pytest.raises(ValueError, match=r"state\['psi'\] is on meta"):
        k4.check_inputs(**kw)


@pytest.mark.parametrize("stage", [k4.WEIGHTS, k4.SMOOTH, k4.GRADIENT])
def test_engine_step_cuda_refuses_cpu_tensors(stage, monkeypatch):
    """The refusal comes before the library is loaded and counts no launch."""
    _, kw = _launch_inputs()

    def load():
        raise AssertionError("the library was loaded for CPU tensors")

    monkeypatch.setattr(k4.KERNEL, "load", load)
    before = (k4.KERNEL.launches, k4.KERNEL.captured)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k4.engine_step_cuda(stage, min_duration=3, epsilon=0.01, **kw)
    assert (k4.KERNEL.launches, k4.KERNEL.captured) == before


@pytest.mark.parametrize("shape,refusal", [
    ((250, 128, 6, 36), None),
    ((250, 128, 6, 42), None),
    ((1029, 128, 6, 36), None),  # the widest N that K1 takes at R = 6
    ((2400, 512, 8, 72), None),
    ((3000, 128, 6, 36), None),
    ((2500, 128, 8, 64), "shared memory"),
    ((250, 128, 0, 0), "R must be in"),
    ((250, 128, 9, 81), "R must be in"),
    ((6, 128, 6, 36), "N > R"),
    ((250, 0, 6, 36), "S >= 1"),
    ((250, 128, 6, 37), "D = R"),
])
def test_supports_the_main_shapes_and_states_its_bounds(shape, refusal):
    got = k4.supports(*shape)
    assert got is None if refusal is None else refusal in got


def test_smem_bytes_are_the_kernels_layout():
    src = SOURCE.read_text()
    assert "return (size_t)N * (7 * sizeof(float) + 4 * sizeof(int) + 1);" in src
    assert "return 3 * sizeof(float) * (size_t)R * N;" in src
    assert "return sizeof(float) * (size_t)N;" in src
    assert k4.smem_bytes(250, 6) == (45 * 250, 12 * 6 * 250, 4 * 250)


def test_argument_struct_matches_the_kernel_source():
    """_Args lists EngineStepArgs' fields in the kernel's order with the
    kernel's C types, and the Python constants are the kernel's."""
    src = SOURCE.read_text()
    body = re.search(r"struct EngineStepArgs \{(.*?)\n\};", src, re.S).group(1)
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
    py_fields = [(kinds[t], n) for n, t in k4._Args._fields_]
    assert [n for _, n in c_fields] == [n for _, n in py_fields]
    for (ct, n), (pt, _) in zip(c_fields, py_fields):
        assert ct.endswith("*") if pt == "*" else ct == pt, n
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kMaxR") == k4.MAX_REGIMES
    stages = re.search(r"enum \{ kWeights = (\d), kSmooth = (\d), kGradient = (\d) \};", src).groups()
    assert tuple(map(int, stages)) == (k4.WEIGHTS, k4.SMOOTH, k4.GRADIENT)
    assert list(k4.Workspace._fields) == ["b", "w_self", "anc", "prev_code", "g_prev", "g_anc", "slot"]
    assert [n for n, _ in k4._Args._fields_][-21:-14] == list(k4.Workspace._fields)
