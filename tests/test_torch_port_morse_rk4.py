# coding: utf-8
"""The RK4 trajectory step of a separable Morse PES: K7's plain version
(`ops.morse_rk4.morse_rk4_step_plain`) and wrapper, the path `eom.rk4_step`
takes to it, the argument checks and the layout rule.

The plain version is held bit for bit against the stages as `rk4_step`
ran them before K7 existed (`stages_before`, kept here as the reference:
four `MorsePotential.local_expansion` calls, the kinetic energies and the
RK4 sums), at d = 5, 60 and 61 in float64 and float32; `rk4_step` goes
through the wrapper once a step on the engaged path and never on the
others, and its whole step there equals the PyTorch stages' step bit for
bit. The layout tests walk the kernel's warp-to-row, lane-to-mode map
(`_kernel_elements`, csrc/morse_rk4.cu's index arithmetic). The tests
marked `cuda` hold K7 against the plain version on the card (q, p and
h1..h4 bit for bit, S and e1 up to the order of the mode sums) and the
time loop's graphs against eager runs; they skip without a card. No JAX:
the step's agreement with the JAX package is held by
test_torch_port_separable.py.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch.ops import diag_mono, morse_rk4
from semiclassical_tpu_torch.potentials import (MorsePotential,
                                                NonHarmonicPotential)
from semiclassical_tpu_torch.propagation import eom
from semiclassical_tpu_torch.propagation.state import TrajState

DTYPES = (torch.float64, torch.float32)
DT = 0.005 / 0.02418884326585747     # 0.005 fs in atomic units


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stages_before(state, potential, dt):
    """`rk4_step`'s trajectory stages as they ran before K7, for a Morse
    potential at "stage": (new q, new p, new S, e1, (h1, h2, h3, h4))."""
    inv_m = 1.0 / potential.masses()
    q, p, S = state.q, state.p, state.S
    tdt = eom._at(dt, q.dtype)
    half = float(eom._NP_DTYPE[q.dtype](0.5) * tdt)
    full = float(tdt)
    sixth = float(tdt / eom._NP_DTYPE[q.dtype](6.0))
    inv_m_t = inv_m.to(q.dtype)

    def stage(qs, ps):
        vpot, grad, hess = potential.local_expansion(qs)
        tkin = 0.5 * torch.sum(ps**2 * inv_m_t[None, :], dim=1)
        vpot = vpot.to(tkin.dtype)
        return ((ps * inv_m_t[None, :], -grad.to(p.dtype),
                 (tkin - vpot).to(S.dtype)), tkin + vpot, hess.diag)

    k1, e1, h1 = stage(q, p)
    k2, _, h2 = stage(q + half * k1[0], p + half * k1[1])
    k3, _, h3 = stage(q + half * k2[0], p + half * k2[1])
    k4, _, h4 = stage(q + full * k3[0], p + full * k3[1])
    new_q = q + sixth * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0])
    new_p = p + sixth * (k1[1] + 2.0 * (k2[1] + k3[1]) + k4[1])
    new_S = S + sixth * (k1[2] + 2.0 * (k2[2] + k3[2]) + k4[2])
    return new_q, new_p, new_S, e1, (h1, h2, h3, h4)


def _potential(d, dtype=torch.float64, seed=0, harmonic=False,
               hessian_eval="stage", device="cpu"):
    """A random separable Morse model of d modes (chi 0.02, or 0 for the
    harmonic branch) at `dtype`."""
    rng = np.random.default_rng(seed)
    omega = rng.uniform(300.0, 2800.0, size=d) / 219474.63
    chi = np.zeros(d) if harmonic else np.full(d, 0.02)
    pot = MorsePotential.create(omega, chi, rng.uniform(-1, 1, d),
                                device=device, hessian_eval=hessian_eval)
    return pot.to_dtype(dtype)


def _state(pot, n, dtype=torch.float64, seed=1, device="cpu", rows=None):
    """A diagonal-monodromy state of n rows (of `rows`, a larger batch,
    when given) at the model's classical scales, with a nonzero S."""
    rng = np.random.default_rng(seed)
    rows = n if rows is None else rows
    omega = pot.omega.double().cpu().numpy()
    q = rng.standard_normal((rows, omega.size)) * 2.0 / np.sqrt(omega)
    p = rng.standard_normal((rows, omega.size)) * np.sqrt(omega)
    to = lambda x: torch.from_numpy(x).to(device=device, dtype=dtype)
    state = TrajState.initial(to(q), to(p), diag_monodromy=True)
    return TrajState(q=state.q, p=state.p, Z=state.Z,
                     S=to(rng.standard_normal(rows) * 1e-2))


def _weights(dtype):
    return eom._stage_weights(DT, dtype)


def _same_bits(x, y):
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("d", [5, 60, 61])
def test_plain_equals_the_stages_before(d, dtype):
    pot = _potential(d, dtype, seed=d)
    state = _state(pot, 33, dtype, seed=d + 1)
    ref = stages_before(state, pot, DT)
    got = morse_rk4.morse_rk4_step_plain(
        state.q, state.p, state.S, morse_rk4.pack_of(pot), _weights(dtype))
    for g, r in zip(got[:4], ref[:4]):
        assert _same_bits(g, r)
    assert _same_bits(got[4], torch.stack(ref[4]))


def _count_calls(monkeypatch):
    calls = []
    wrapper = morse_rk4.morse_rk4_step

    def counted(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(morse_rk4, "morse_rk4_step", counted)
    return calls


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_rk4_step_goes_through_the_wrapper(monkeypatch, dtype):
    """A non-harmonic Morse state at "stage" steps its trajectories with
    one call of the wrapper (the plain path on the CPU, no launch); the
    whole step, monodromy and energy included, equals the step through
    the PyTorch stages bit for bit."""
    pot = _potential(6, dtype)
    state = _state(pot, 9, dtype)
    calls = _count_calls(monkeypatch)
    launches = morse_rk4.LAUNCHES, dict(morse_rk4.LAUNCHES_BY_DTYPE)
    new, energy = eom.rk4_step(state, pot, DT)
    assert len(calls) == 1
    assert (morse_rk4.LAUNCHES, morse_rk4.LAUNCHES_BY_DTYPE) == launches
    q, p, S, pack, w = calls[0]
    assert q is state.q and p is state.p and S is state.S
    assert pack is morse_rk4.pack_of(pot) and w == _weights(dtype)
    monkeypatch.setattr(eom, "_k7_engages", lambda state, potential: False)
    ref, ref_energy = eom.rk4_step(state, pot, DT)
    assert len(calls) == 1
    for name in ("q", "p", "S", "Z"):
        assert _same_bits(getattr(new, name), getattr(ref, name))
    assert new.qc is None and new.pc is None
    assert _same_bits(energy, ref_energy)


def _bypass(case):
    """(state, potential) of a path that keeps the PyTorch stages."""
    if case == "NonHarmonic":
        pot = NonHarmonicPotential.create(dim=4, device="cpu")
        return _state(_potential(4), 7), pot
    if case == "harmonic Morse":
        pot = _potential(4, harmonic=True)
        return _state(_potential(4), 7), pot
    if case in ("step", "taylor"):
        pot = _potential(4, hessian_eval=case)
        return _state(pot, 7), pot
    pot = _potential(4)
    state = _state(pot, 7)
    if case == "compensated":
        return TrajState.initial(state.q, state.p, diag_monodromy=True,
                                 compensated=True), pot
    if case == "mixed":
        return state, pot.to_dtype(torch.float32)
    if case == "S at float64":
        state32 = _state(pot, 7, torch.float32)
        return TrajState(q=state32.q, p=state32.p, Z=state32.Z,
                         S=state.S), pot.to_dtype(torch.float32)
    if case == "taylor window":
        pot = _potential(4, hessian_eval="taylor")
        carry0, _ = eom.make_taylor_window(pot, DT, 4)
        return state, carry0(state)[0]
    raise ValueError(case)


BYPASS = ("NonHarmonic", "harmonic Morse", "step", "taylor", "compensated",
          "mixed", "S at float64", "taylor window")


@pytest.mark.parametrize("case", BYPASS)
def test_rk4_step_keeps_the_stages_elsewhere(monkeypatch, case):
    state, pot = _bypass(case)
    calls = _count_calls(monkeypatch)
    assert not eom._k7_engages(state, pot)
    new, _ = eom.rk4_step(state, pot, DT)
    assert calls == [] and torch.isfinite(new.q).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_wrapper_on_the_cpu_launches_nothing(dtype):
    pot = _potential(5, dtype)
    state = _state(pot, 17, dtype)
    args = (state.q, state.p, state.S, morse_rk4.pack_of(pot),
            _weights(dtype))
    before = morse_rk4.LAUNCHES, dict(morse_rk4.LAUNCHES_BY_DTYPE)
    got = morse_rk4.morse_rk4_step(*args)
    assert (morse_rk4.LAUNCHES, morse_rk4.LAUNCHES_BY_DTYPE) == before
    for g, r in zip(got, morse_rk4.morse_rk4_step_plain(*args)):
        assert _same_bits(g, r)


def test_pack_rows_and_lifetime():
    """The pack's rows are the expressions of `local_expansion` and
    `rk4_step` ([-a, D, 2 a D, 2 a^2 D, 1/m]); it is made once per
    potential object and dropped with it."""
    pot = _potential(7)
    pack = morse_rk4.pack_of(pot)
    a, D = pot.a[None, :], pot.D[None, :]
    for row, ref in zip(pack, (-a, D, 2 * a * D, 2 * a**2 * D,
                               (1.0 / pot.masses())[None, :])):
        assert _same_bits(row, ref[0])
    assert morse_rk4.pack_of(pot) is pack
    assert morse_rk4.pack_of(pot.to_dtype(torch.float32)).dtype == (
        torch.float32)
    key = id(pot)
    assert key in morse_rk4._PACKS
    del pot
    gc.collect()
    assert key not in morse_rk4._PACKS


def _args(n=12, d=6, dtype=torch.float64):
    pot = _potential(d, dtype)
    state = _state(pot, n, dtype)
    return state.q, state.p, state.S, morse_rk4.pack_of(pot)


def _bad(case):
    """(q, p, S, pack) that K7 does not take, by name."""
    q, p, S, pack = _args()
    if case == "mixed dtypes":
        return q, p.float(), S, pack
    if case == "float16":
        return q.half(), p.half(), S.half(), pack.half()
    if case == "q rows not contiguous":
        return q.t().contiguous().t(), p, S, pack
    if case == "p rows apart":
        return q, torch.zeros(12, 8, dtype=q.dtype)[:, :6], S, pack
    if case == "S strided":
        return q, p, torch.zeros(24, dtype=q.dtype)[::2], pack
    if case == "q shape":
        return q[:, None], p, S, pack
    if case == "p shape":
        return q, p[:11], S, pack
    if case == "S shape":
        return q, p, S[:11], pack
    if case == "pack shape":
        return q, p, S, pack[:4]
    if case == "pack not contiguous":
        return q, p, S, pack.t().contiguous().t()
    raise ValueError(case)


BAD = ("mixed dtypes", "float16", "q rows not contiguous", "p rows apart",
       "S strided", "q shape", "p shape", "S shape", "pack shape",
       "pack not contiguous")


@pytest.mark.parametrize("case", BAD)
def test_checks_refuse(case):
    with pytest.raises(ValueError):
        morse_rk4.check_args(*_bad(case))


@pytest.mark.parametrize("case", ["whole", "row view", "n = 1", "d = 1",
                                  "n = 0"])
def test_checks_take(case):
    q, p, S, pack = _args(dtype=torch.float32)
    if case == "row view":
        q, p, S, pack = _args(40, 6, torch.float32)
        q, p, S = q[7:19], p[7:19], S[7:19]
    elif case == "n = 1":
        q, p, S, pack = _args(1, 6, torch.float32)
    elif case == "d = 1":
        q, p, S, pack = _args(12, 1, torch.float32)
    elif case == "n = 0":
        q, p, S, pack = _args(0, 6, torch.float32)
    morse_rk4.check_args(q, p, S, pack)


def _kernel_elements(lay, n, d):
    """The (row, mode) pairs the kernel's lanes handle, as its index
    arithmetic walks them: warp w of the grid takes row w below n, lane l
    modes l vec + 32 vec c .. + vec - 1 below d."""
    out = []
    warps = lay.blocks * morse_rk4._THREADS // morse_rk4._WARP
    for row in range(min(warps, n)):
        for lane in range(morse_rk4._WARP):
            for j in range(lane * lay.vec, d, morse_rk4._WARP * lay.vec):
                out += [(row, j + e) for e in range(lay.vec)]
    return sorted(out)


# (aligned, n, d): the vector variant where d is even and q, p aligned
WALKS = [(True, n, d) for n, d in ((1, 2), (3, 60), (17, 64), (33, 66),
                                   (257, 130))] + [
         (False, n, d) for n, d in ((1, 1), (5, 61), (9, 60), (40, 33))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("aligned, n, d", WALKS)
def test_lanes_cover_every_element_once(dtype, aligned, n, d):
    lay = morse_rk4.layout(n, d, dtype, aligned)
    assert lay.variant == ("vector" if aligned and d % 2 == 0 else "scalar")
    assert _kernel_elements(lay, n, d) == [(r, j) for r in range(n)
                                           for j in range(d)]
    warps = morse_rk4._THREADS // morse_rk4._WARP
    assert (lay.blocks - 1) * warps < n <= lay.blocks * warps


def test_flagship_layout():
    assert morse_rk4.layout(98304, 60, torch.float64, True) == (
        "vector", 2, 12288)
    assert morse_rk4.layout(98304, 60, torch.float32, True) == (
        "vector", 2, 12288)
    assert morse_rk4.layout(32768, 60, torch.float64, True).blocks == 4096
    assert morse_rk4.layout(1001, 61, torch.float64, True) == (
        "scalar", 1, 126)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_layout_of_views(dtype):
    """The vector variant needs d even and q, p on a pair's boundary: a
    sub-batch's rows of an even d keep it; odd d or an odd element offset
    take the scalar variant."""
    q, p, _, _ = _args(64, 6, dtype)
    assert morse_rk4.layout_of(q, p).variant == "vector"
    assert morse_rk4.layout_of(q[5:40], p[5:40]).variant == "vector"
    flat = torch.zeros(64 * 6 + 1, dtype=dtype)
    shifted = flat[1:].view(64, 6)
    assert morse_rk4.layout_of(shifted, p).variant == "scalar"
    assert morse_rk4.layout_of(q, shifted).variant == "scalar"
    q, p, _, _ = _args(64, 7, dtype)
    assert morse_rk4.layout_of(q, p).variant == "scalar"


def test_layout_refuses():
    with pytest.raises(ValueError):
        morse_rk4.layout(60, 4, torch.float16, True)
    with pytest.raises(ValueError):
        morse_rk4.layout(-1, 4, torch.float64, True)
    with pytest.raises(ValueError):
        morse_rk4.layout(8, 0, torch.float64, True)


# --- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# S and e1 differ from the plain version only by the order of the mode sums
_SUM_RTOL = {torch.float64: 1e-14, torch.float32: 1e-5}


def _kernel_check(q, p, S, pack, variant):
    """One K7 launch in `variant` against the plain version: q, p and h
    bit for bit, S and e1 within the sums' order of their largest
    entry."""
    w = _weights(q.dtype)
    assert morse_rk4.layout_of(q, p).variant == variant
    before = morse_rk4.LAUNCHES
    got = morse_rk4.morse_rk4_step(q, p, S, pack, w)
    torch.cuda.synchronize()
    assert morse_rk4.LAUNCHES == before + 1
    ref = morse_rk4.morse_rk4_step_plain(q, p, S, pack, w)
    for g, r in (got[0], ref[0]), (got[1], ref[1]), (got[4], ref[4]):
        assert g.is_contiguous() and _same_bits(g, r)
    for g, r in (got[2], ref[2]), (got[3], ref[3]):
        assert g.shape == r.shape and g.dtype == r.dtype
        err = float((g - r).abs().max() / r.abs().max())
        assert err <= _SUM_RTOL[q.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("n, d, case, variant", [
    (98304, 60, "whole", "vector"), (8192, 60, "view", "vector"),
    (1001, 61, "view odd", "scalar"), (1001, 61, "whole", "scalar"),
    (1, 60, "whole", "vector"), (4097, 130, "whole", "vector")])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_kernel_matches_plain_on_the_card(dtype, n, d, case, variant):
    """K7 against its plain version at the AS model's shape, on a
    sub-batch's rows of a (98304, d) state (at an odd row of an odd d:
    the scalar variant), at odd d, n = 1 and a row longer than one
    pass."""
    card = _card()
    pot = _potential(d, dtype, seed=d, device=card)
    rows = 98304 if case.startswith("view") else n
    state = _state(pot, n, dtype, seed=n, device=card, rows=rows)
    q, p, S = state.q, state.p, state.S
    if case == "view":
        q, p, S = q[8192:8192 + n], p[8192:8192 + n], S[8192:8192 + n]
    elif case == "view odd":
        q, p, S = q[1:1 + n], p[1:1 + n], S[1:1 + n]
    _kernel_check(q, p, S, morse_rk4.pack_of(pot), variant)


@pytest.mark.cuda
def test_empty_batch_launches_nothing_on_the_card():
    card = _card()
    pot = _potential(60, device=card)
    state = _state(pot, 0, device=card)
    before = morse_rk4.LAUNCHES
    got = morse_rk4.morse_rk4_step(state.q, state.p, state.S,
                                   morse_rk4.pack_of(pot),
                                   _weights(torch.float64))
    assert morse_rk4.LAUNCHES == before and got[4].shape == (4, 0, 60)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed dtypes", "rows apart", "cpu pack"])
def test_wrapper_raises_on_the_card(case):
    card = _card()
    pot = _potential(6, device=card)
    state = _state(pot, 16, device=card)
    q, p, S, pack = state.q, state.p, state.S, morse_rk4.pack_of(pot)
    if case == "mixed dtypes":
        p = p.float()
    elif case == "rows apart":
        q = torch.zeros(16, 8, dtype=q.dtype, device=card)[:, :6]
    elif case == "cpu pack":
        pack = pack.cpu()
    before = morse_rk4.LAUNCHES
    with pytest.raises(ValueError):
        morse_rk4.morse_rk4_step(q, p, S, pack, _weights(torch.float64))
    assert morse_rk4.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["HK", "WM"])
def test_graphs_equal_eager_on_the_card(name):
    """HK and WM RK4 on a 60-mode Morse model at 1024 x 50 in segments of
    20: graph replays against `graph.eager()` on the same draws give C(t),
    k~ic(t) and the final q, p, S and monodromy planes bit for bit, and
    K7 launches once a step in both."""
    _card()
    from test_torch_port_graph import _morse, _propagator

    from semiclassical_tpu_torch.propagation import graph

    pot, q0, G = _morse(d=60, device="cuda")
    k7 = ("semiclassical_tpu_torch.ops.morse_rk4", "LAUNCHES")
    runs = []
    for eager in (False, True):
        prop = _propagator(name, pot, q0, G, ntraj=1024, device="cuda")
        before, stats = graph.read_launches(), dict(graph.STATS)
        with graph.eager() if eager else contextlib.nullcontext():
            out = prop.propagate(pot, 2.0, 50, chunk=20)
        torch.cuda.synchronize()
        after = graph.read_launches()
        runs.append((out, [getattr(prop.state, k).cpu()
                           for k in ("q", "p", "S", "Z")],
                     after.get(k7, 0) - before.get(k7, 0),
                     graph.STATS["replays"] - stats["replays"]))
    (got, fields, launches, replays), (ref, fields_ref, launches_eager,
                                       _) = runs
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    for g, r in zip(fields, fields_ref):
        assert torch.equal(g, r)
    assert launches == launches_eager == 50
    assert replays > 0
    assert diag_mono.LAUNCHES > 0
