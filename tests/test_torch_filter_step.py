"""The filter's site step, ``two_group/filter.py::filter_site``, on the CPU,
and what of the CUDA filter step K2 (ops/cuda_filter_step.py) can be
checked without a card.

On the CPU ``filter_site`` is the plain version: ``_one_step`` +
``_renormalise`` and the writes of the carry, the shifts, the degenerate
flags, the history and the parents. It is held bit for bit against that
composition written out here, for (T, R) and (U, T, R) emission tables,
f32 and f64 weights, in place and into other tensors, and for the warm
step. K2's launch checks (``check_inputs``), its shape bound
(``supports``) and its argument struct, which must match the kernel's
source field for field, need no card; the kernel itself is held against
the plain version in tests/test_torch_cuda.py.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hygeia_tpu_torch.ops import cuda_filter_step as k2
from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
from hygeia_tpu_torch.ops.resampling import optimal_finite_state_resampling
from hygeia_tpu_torch.two_group import filter as flt
from hygeia_tpu_torch.two_group.model import make_params
from hygeia_tpu_torch.two_group.proposal import num_children

torch.set_num_threads(1)

SOURCE = Path(k2.__file__).resolve().parent.parent / "csrc" / "filter_step.cu"


def _params(R, T):
    mu = [0.95, 0.05, 0.80, 0.20, 0.50, 0.50][:R]
    sigma = [0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751][:R]
    return make_params(
        mu=mu, sigma=sigma, p_softmax_control=np.zeros((R, R)), omega_logit_control=np.full(R, 4.0),
        omega_case=0.8, kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0),
        merge_log_prob=np.log(0.1), split_prob=0.01, minimum_duration=3, d_max=T + 1, device="cpu",
    )


def _tables(params, T, U, per_unit, seed=3):
    rng = np.random.default_rng(seed)
    n = rng.poisson(20, size=(U, T, 2))
    tab = lambda p: torch.stack([
        emission_log_prob_table(rng.binomial(n[u], p), n[u], params.alpha, params.beta) for u in range(U)
    ])
    E_c, E_k = tab(0.7), tab(0.3)
    return (E_c, E_k) if per_unit else (E_c[0], E_k[0])


def _carry(params, E_c, E_k, M, U, sites, dtype):
    """The filter's carry after ``sites`` sites: (lw (U, N), parts (U, 5, N))."""
    res = flt.run_filter(params, E_c[..., :sites, :], E_k[..., :sites, :], M, n_units=U,
                         generator=torch.Generator().manual_seed(11), weight_dtype=dtype,
                         return_history=False)
    return res.log_weights.contiguous(), torch.stack(res.particles, 1).contiguous()


def _composition(params, E_c, E_k, t, lw, parts, M, u_sys, u_mult):
    """_one_step + _renormalise at site t, with host indexing."""
    new_lw, new_parts, parents = flt._one_step(params, E_c[..., t, :], E_k[..., t, :], lw, parts, M,
                                               u_sys, u_mult, return_parents=True)
    new_lw, shift, degen = flt._renormalise(new_lw)
    return new_lw, new_parts, shift, degen, parents


@pytest.mark.parametrize("per_unit", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sites", [1, 6])
def test_filter_site_on_the_cpu_is_the_plain_composition(per_unit, dtype, sites):
    """sites=1: the site after a cold start (R^2 live weights, the
    no-resample branch); 6: a resampling site. In place, with the history,
    the shifts and flags at column t - 1, and the parents; bit for bit."""
    R, T, U, M = 6, 12, 3, 8
    N = M * num_children(R)
    params = _params(R, T)
    E_c, E_k = _tables(params, T, U, per_unit)
    lw, parts = _carry(params, E_c, E_k, M, U, sites, dtype)
    g = torch.Generator().manual_seed(5)
    u_sys, u_mult = torch.rand((U,), generator=g), torch.rand((U, M), generator=g)
    t = sites
    want = _composition(params, E_c, E_k, t, lw, parts, M, u_sys, u_mult)

    hist = (torch.zeros((U, T, N), dtype=dtype),
            *(torch.zeros((U, T, N), dtype=dt) for dt in flt._HISTORY_DTYPES))
    shifts = torch.zeros((U, T - 1), dtype=dtype)
    degen = torch.ones((U, T - 1), dtype=torch.bool)
    idx = torch.tensor([t - 1, t])
    got_lw, got_parts = lw.clone(), parts.clone()
    parents = flt.filter_site(params, E_c, E_k, idx, got_lw, got_parts, M, u_sys, u_mult, shifts, degen,
                              hist, return_parents=True)
    assert torch.equal(got_lw, want[0]) and torch.equal(got_parts, want[1])
    assert torch.equal(shifts[:, t - 1], want[2]) and torch.equal(degen[:, t - 1], want[3])
    assert torch.equal(parents, want[4]) and parents.dtype == torch.int64
    assert torch.equal(hist[0][:, t], want[0])
    for h, f in zip(hist[1:], want[1].unbind(1)):
        assert h.dtype in (torch.int8, torch.int32) and torch.equal(h[:, t], f.to(h.dtype))
    others = [c for c in range(T - 1) if c != t - 1]
    assert not shifts[:, others].any() and degen[:, others].all()
    assert not hist[0][:, [s for s in range(T) if s != t]].any()


def test_filter_site_into_other_tensors_leaves_the_carry():
    """out=(weights, particles), as the marginal filter calls it: the carry
    is read, not written; no parents unless asked for."""
    R, T, U, M = 5, 10, 2, 6
    params = _params(R, T)
    E_c, E_k = _tables(params, T, U, False)
    lw, parts = _carry(params, E_c, E_k, M, U, 4, torch.float32)
    g = torch.Generator().manual_seed(2)
    u_sys, u_mult = torch.rand((U,), generator=g), torch.rand((U, M), generator=g)
    want = _composition(params, E_c, E_k, 4, lw, parts, M, u_sys, u_mult)
    before = (lw.clone(), parts.clone())
    out = (torch.empty_like(lw), torch.empty_like(parts))
    shifts, degen = torch.zeros((U, T - 1)), torch.zeros((U, T - 1), dtype=torch.bool)
    got = flt.filter_site(params, E_c, E_k, torch.tensor([3, 4]), lw, parts, M, u_sys, u_mult, shifts, degen,
                          out=out)
    assert got is None
    assert torch.equal(lw, before[0]) and torch.equal(parts, before[1])
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    assert torch.equal(shifts[:, 3], want[2])


def test_filter_site_resets_an_all_dead_site():
    """Every previous weight -inf: the site is degenerate, its shift 0 and
    its weights uniform, as _renormalise leaves them."""
    R, T, U, M = 6, 8, 2, 4
    N = M * num_children(R)
    params = _params(R, T)
    E_c, E_k = _tables(params, T, U, True)
    _, parts = _carry(params, E_c, E_k, M, U, 3, torch.float32)
    lw = torch.full((U, N), float("-inf"))
    lw[1] = _carry(params, E_c, E_k, M, U, 3, torch.float32)[0][1]
    g = torch.Generator().manual_seed(4)
    u_sys, u_mult = torch.rand((U,), generator=g), torch.rand((U, M), generator=g)
    shifts, degen = torch.zeros((U, T - 1)), torch.zeros((U, T - 1), dtype=torch.bool)
    flt.filter_site(params, E_c, E_k, torch.tensor([2, 3]), lw, parts, M, u_sys, u_mult, shifts, degen)
    assert degen[:, 2].tolist() == [True, False]
    assert float(shifts[0, 2]) == 0.0
    assert torch.equal(lw[0], torch.full((N,), -float(np.log(N)), dtype=torch.float32))
    assert torch.isfinite(lw[1]).any()


@pytest.mark.parametrize("per_unit", [False, True])
def test_warm_step_is_the_plain_composition_at_site_0(per_unit):
    R, T, U, M = 6, 10, 2, 5
    params = _params(R, T)
    E_c, E_k = _tables(params, T, U, per_unit)
    lw, parts = _carry(params, E_c, E_k, M, U, 5, torch.float32)
    g = torch.Generator().manual_seed(8)
    u_sys, u_mult = torch.rand((U,), generator=g), torch.rand((U, M), generator=g)
    want = _composition(params, E_c, E_k, 0, lw, parts, M, u_sys, u_mult)
    got = flt.warm_step(params, E_c, E_k, lw, parts, M, u_sys, u_mult)
    for a, b in zip(got, want[:4]):
        assert a.shape == b.shape and torch.equal(a, b)


def _launch_inputs(R=6, U=2, M=5, T=7, per_unit=False):
    """check_inputs' arguments at a small shape, every one as the kernel
    takes it (CPU tensors)."""
    N = M * num_children(R)
    params = _params(R, T)
    E_c, E_k = _tables(params, T, U, per_unit)
    lw, parts = _carry(params, E_c, E_k, M, U, 3, torch.float32)
    g = torch.Generator().manual_seed(1)
    res = optimal_finite_state_resampling(lw, M, torch.rand((U,), generator=g), torch.rand((U, M), generator=g))
    hist = tuple(torch.zeros((U, T, N), dtype=dt) for dt in k2.HISTORY_DTYPES)
    st = params.step_tables()
    return dict(emission_control=E_c, emission_case=E_k, idx=torch.tensor([2, 3]), prev_lw=lw,
                prev_parts=parts, resampled=res, M=M, rho_both=st.rho_both,
                log_p_control=params.log_p_control, log_p_merged=params.log_p_merged,
                out_lw=lw, out_parts=parts, shifts=torch.zeros((U, T - 1)),
                degen=torch.zeros((U, T - 1), dtype=torch.bool), hist=hist,
                parents=torch.zeros((U, M), dtype=torch.int64))


@pytest.mark.parametrize("per_unit", [False, True])
def test_check_inputs_takes_the_filters_tensors(per_unit):
    kw = _launch_inputs(per_unit=per_unit)
    U, N, R, W, strides, h_T = k2.check_inputs(**kw)
    assert (U, N, R, h_T) == (2, 5 * num_children(6), 6, 7)
    assert W == kw["rho_both"].shape[2]
    E = kw["emission_control"]
    assert strides == ((E.shape[1] * 6 if per_unit else 0), 6) * 2
    # A window of a longer table, as the streamed and meshed paths pass it.
    wide = torch.cat([E, E], dim=-2)
    kw.update(emission_control=wide[..., 2:9, :], emission_case=wide[..., 2:9, :])
    assert k2.check_inputs(**kw)[4][:2] == ((2 * E.shape[-2] * 6 if per_unit else 0), 6)


@pytest.mark.parametrize("name,change,error,match", [
    ("prev_lw", lambda x: x.double(), TypeError, "prev_lw has dtype"),
    ("prev_parts", lambda x: x.long(), TypeError, "prev_parts has dtype"),
    ("prev_parts", lambda x: x.transpose(1, 2).contiguous().transpose(1, 2), ValueError, "contiguous"),
    ("out_lw", lambda x: x[:, :-1], ValueError, "out_lw has shape"),
    ("emission_control", lambda x: x.double(), TypeError, "emission_control has dtype"),
    ("emission_case", lambda x: x[..., :5], ValueError, "emission_case must be"),
    ("emission_control", lambda x: x.transpose(-1, -2).contiguous().transpose(-1, -2), ValueError,
     "regime axis"),
    ("idx", lambda x: x.int(), TypeError, "idx has dtype"),
    ("shifts", lambda x: x[:1], ValueError, "shifts must be"),
    ("degen", lambda x: x.float(), TypeError, "degen has dtype"),
    ("hist", lambda h: (h[0].double(), *h[1:]), TypeError, r"hist\[0\] has dtype"),
    ("hist", lambda h: h[:5], ValueError, "six"),
    ("parents", lambda x: x.int(), TypeError, "parents has dtype"),
    ("rho_both", lambda x: x.double(), TypeError, "rho_both has dtype"),
    ("M", lambda m: m + 1, ValueError, "N = M"),
])
def test_check_inputs_refuses_what_the_kernel_cannot_take(name, change, error, match):
    kw = _launch_inputs()
    kw[name] = change(kw[name])
    with pytest.raises(error, match=match):
        k2.check_inputs(**kw)


def test_check_inputs_refuses_a_tensor_on_another_device():
    kw = _launch_inputs()
    kw["prev_parts"] = kw["prev_parts"].to("meta")
    with pytest.raises(ValueError, match="prev_parts is on meta"):
        k2.check_inputs(**kw)


def test_filter_step_cuda_refuses_cpu_tensors(monkeypatch):
    """The refusal comes before the library is loaded and counts no launch."""
    kw = _launch_inputs()
    kw.pop("hist"), kw.pop("parents")

    def load():
        raise AssertionError("the library was loaded for CPU tensors")

    monkeypatch.setattr(k2.KERNEL, "load", load)
    before = (k2.KERNEL.launches, k2.KERNEL.captured)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k2.filter_step_cuda(min_duration=3, **kw)
    assert (k2.KERNEL.launches, k2.KERNEL.captured) == before


def test_supports_the_main_shapes_and_states_its_bounds():
    for M, R in ((50, 6), (50, 5), (150, 6), (1, 1), (244, 6)):
        assert k2.supports(M * num_children(R), M, R) is None
    assert k2.smem_bytes(2400, 50, 6) == 4 * (2400 + 36 + 12 + 14 * 50) + 4 * 7 * 50
    assert "N = M" in k2.supports(2401, 50, 6)
    assert "R must be <= 127" in k2.supports(128 * num_children(128), 128, 128)
    assert "shared memory" in k2.supports(1200 * num_children(6), 1200, 6)
    assert "M >= 1" in k2.supports(0, 0, 6)


def test_argument_struct_matches_the_kernel_source():
    """_Args lists FilterStepArgs' fields in the kernel's order with the
    kernel's C types, and the Python constants are the kernel's."""
    src = SOURCE.read_text()
    body = re.search(r"struct FilterStepArgs \{(.*?)\n\};", src, re.S).group(1)
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
    py_fields = [(kinds[t], n) for n, t in k2._Args._fields_]
    assert [n for _, n in c_fields] == [n for _, n in py_fields]
    for (ct, n), (pt, _) in zip(c_fields, py_fields):
        assert ct.endswith("*") if pt == "*" else ct == pt, n
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("kAncF"), const("kAncI")) == (k2.ANC_FLOATS, k2.ANC_INTS)
