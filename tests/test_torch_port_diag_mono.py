# coding: utf-8
"""The diagonal monodromy's RK4 step on the CPU: K6's plain version
(`ops.diag_mono.diag_mono_step_plain`) and wrapper, its argument checks
and its layout rule.

The plain version is held bit for bit against the step as the time loop
ran it before K6 existed (`diag_step_before`, kept here as the reference,
with its seeds made from host values), on plane-strided views, aliased and
broadcast stage diagonals too; `eom._diag_step` and `eom.rk4_step` go
through the wrapper, which takes the plain path for CPU tensors and
launches nothing. The layout tests walk the kernel's thread-to-element map
(`_kernel_elements`, csrc/diag_mono.cu's index arithmetic) for the rule's
layouts. The kernel itself is held against the plain version on the card
(tests/test_torch_port_cuda.py). No JAX counterpart is needed: the step's
agreement with the JAX package is held by test_torch_port_separable.py.
"""

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch.ops import diag_mono
from semiclassical_tpu_torch.potentials import MorsePotential
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


def diag_step_before(Z, inv_m, hs, dt):
    """`eom._diag_step` as it was before K6: the stage recurrence on the
    seeds (1, 0) and (0, 1) as a leading axis of 2, then the row map."""
    u = inv_m[None, None, :]
    h6, h3, h2, dt = eom._rk4_weights(dt, Z.dtype)
    a = torch.tensor([1.0, 0.0], dtype=Z.dtype).view(2, 1, 1)
    b = torch.tensor([0.0, 1.0], dtype=Z.dtype).view(2, 1, 1)
    ka = u * b
    kb = -hs[0] * a
    acc_a = a + h6 * ka
    acc_b = b + h6 * kb
    sa = a + h2 * ka
    sb = b + h2 * kb
    ka = u * sb
    kb = -hs[1] * sa
    acc_a = acc_a + h3 * ka
    acc_b = acc_b + h3 * kb
    sa = a + h2 * ka
    sb = b + h2 * kb
    ka = u * sb
    kb = -hs[2] * sa
    acc_a = acc_a + h3 * ka
    acc_b = acc_b + h3 * kb
    sa = a + dt * ka
    sb = b + dt * kb
    ka = u * sb
    kb = -hs[3] * sa
    raa, rab = acc_a + h6 * ka
    rba, rbb = acc_b + h6 * kb
    top, bottom = Z[:2], Z[2:]
    return torch.cat([raa * top + rab * bottom, rba * top + rbb * bottom])


def _inputs(n, d, dtype, seed=0, aliased=False):
    """Z (4, n, d) identity plus noise, 1/m of d modes and four Morse-like
    stage diagonals of both signs (one tensor four times if `aliased`)."""
    rng = np.random.default_rng(seed)
    Z = 0.3 * rng.standard_normal((4, n, d))
    Z[0::3] += 1.0
    inv_m = 1.0 / rng.uniform(0.5, 2.0, d)
    hs = [rng.uniform(-0.2, 1.0, (n, d)) * rng.uniform(1e-6, 1e-3, d)
          for _ in range(4)]
    t = lambda x: torch.from_numpy(x).to(dtype)
    hs = [t(hs[0])] * 4 if aliased else [t(h) for h in hs]
    return t(Z), t(inv_m), tuple(hs)


def _same_bits(x, y):
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("aliased", [False, True],
                         ids=["distinct", "aliased"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, 33])
@pytest.mark.parametrize("d", [1, 5, 60])
def test_plain_equals_the_step_before(d, n, dtype, aliased):
    Z, inv_m, hs = _inputs(n, d, dtype, seed=d + n, aliased=aliased)
    ref = diag_step_before(Z, inv_m, hs, DT)
    w = eom._rk4_weights(DT, dtype)
    assert _same_bits(diag_mono.diag_mono_step_plain(Z, inv_m, hs, w), ref)
    assert _same_bits(eom._diag_step(Z, inv_m, hs, DT), ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_plain_on_views_and_broadcast_rows(dtype):
    """A sub-batch's view Z[:, a:b] of a larger state and a stage diagonal
    that is one row expanded over the batch (the harmonic Morse model's)
    step as their contiguous copies do."""
    Z, inv_m, hs = _inputs(41, 7, dtype, seed=3)
    view = Z[:, 5:26]
    hs_view = tuple(h[5:26] for h in hs)
    hs_view = (hs_view[0][:1].expand(21, 7), *hs_view[1:])
    got = eom._diag_step(view, inv_m, hs_view, DT)
    ref = diag_step_before(view.contiguous(), inv_m,
                           tuple(h.contiguous() for h in hs_view), DT)
    assert _same_bits(got, ref)


def test_rk4_step_goes_through_the_wrapper(monkeypatch):
    """`rk4_step` on a diagonal state steps Z with one call of the wrapper,
    which takes the plain path on the CPU and launches nothing."""
    pot = MorsePotential.create(np.linspace(0.002, 0.01, 6),
                                np.full(6, 0.02), np.zeros(6), device="cpu")
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((9, 6)))
    p = torch.from_numpy(rng.standard_normal((9, 6)) * 0.01)
    state = TrajState.initial(q, p, diag_monodromy=True)
    calls = []
    wrapper = diag_mono.diag_mono_step

    def counted(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(diag_mono, "diag_mono_step", counted)
    launches = diag_mono.LAUNCHES, dict(diag_mono.LAUNCHES_BY_DTYPE)
    new, _ = eom.rk4_step(state, pot, DT)
    assert len(calls) == 1
    assert (diag_mono.LAUNCHES, diag_mono.LAUNCHES_BY_DTYPE) == launches
    Z, inv_m, hs, w = calls[0]
    assert Z is state.Z and w == eom._rk4_weights(DT, torch.float64)
    assert _same_bits(new.Z, diag_step_before(Z, inv_m, hs, DT))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_wrapper_on_the_cpu_launches_nothing(dtype):
    Z, inv_m, hs = _inputs(17, 5, dtype)
    before = diag_mono.LAUNCHES, dict(diag_mono.LAUNCHES_BY_DTYPE)
    w = eom._rk4_weights(DT, dtype)
    got = diag_mono.diag_mono_step(Z, inv_m, hs, w)
    assert (diag_mono.LAUNCHES, diag_mono.LAUNCHES_BY_DTYPE) == before
    assert _same_bits(got, diag_mono.diag_mono_step_plain(Z, inv_m, hs, w))


def _bad(case):
    """(Z, inv_m, hs) that K6 does not take, by name."""
    Z, inv_m, hs = _inputs(12, 6, torch.float64)
    if case == "mixed dtypes":
        return Z, inv_m, (hs[0].float(), *hs[1:])
    if case == "float16":
        return Z.half(), inv_m.half(), tuple(h.half() for h in hs)
    if case == "Z rows not contiguous":
        return Z.transpose(1, 2).contiguous().transpose(1, 2), inv_m, hs
    if case == "Z rows apart":
        return torch.zeros(4, 12, 8, dtype=Z.dtype)[:, :, :6], inv_m, hs
    if case == "h rows not contiguous":
        return Z, inv_m, (hs[0].t().contiguous().t(), *hs[1:])
    if case == "h columns broadcast":
        return Z, inv_m, (hs[0][:, :1].expand(12, 6), *hs[1:])
    if case == "inv_m strided":
        return Z, torch.zeros(12, dtype=Z.dtype)[::2], hs
    if case == "Z shape":
        return Z[:3], inv_m, hs
    if case == "h shape":
        return Z, inv_m, (hs[0][:11], *hs[1:])
    if case == "inv_m shape":
        return Z, inv_m[:5], hs
    if case == "three stages":
        return Z, inv_m, hs[:3]
    raise ValueError(case)


BAD = ("mixed dtypes", "float16", "Z rows not contiguous", "Z rows apart",
       "h rows not contiguous", "h columns broadcast", "inv_m strided",
       "Z shape", "h shape", "inv_m shape", "three stages")


@pytest.mark.parametrize("case", BAD)
def test_checks_refuse(case):
    with pytest.raises(ValueError):
        diag_mono.check_args(*_bad(case))


@pytest.mark.parametrize("case", ["whole", "plane view", "aliased",
                                  "broadcast", "n = 1", "d = 1", "n = 0"])
def test_checks_take(case):
    Z, inv_m, hs = _inputs(12, 6, torch.float32)
    if case == "plane view":
        Z = _inputs(40, 6, torch.float32)[0][:, 7:19]
    elif case == "aliased":
        hs = (hs[2],) * 4
    elif case == "broadcast":
        hs = (hs[0], hs[1][:1].expand(12, 6), hs[2], hs[3])
    elif case == "n = 1":
        Z, inv_m, hs = _inputs(1, 6, torch.float32)
    elif case == "d = 1":
        Z, inv_m, hs = _inputs(12, 1, torch.float32)
    elif case == "n = 0":
        Z, inv_m, hs = _inputs(0, 6, torch.float32)    # strides all 0
    diag_mono.check_args(Z, inv_m, hs)


def _kernel_elements(lay, total, d):
    """The (element, mode) pairs the kernel's threads handle, as its index
    arithmetic walks them: thread t takes elements t vec .. t vec + vec - 1,
    the first one's mode by remainder, the next by wrapping at d."""
    out = []
    for t in range(lay.blocks * diag_mono._THREADS):
        i0 = t * lay.vec
        if i0 >= total:
            break
        j = i0 % d
        for i in range(i0, i0 + lay.vec):
            out.append((i, j))
            j = 0 if j + 1 == d else j + 1
    return out


# (aligned, n, d): aligned shapes have n d a multiple of 4, as the new
# planes' alignment makes it in both types
WALKS = [(True, n, d) for n, d in ((8, 1), (1, 4), (1, 60), (3, 12),
                                   (257, 4), (1024, 60))] + [
         (False, n, d) for n, d in ((1, 1), (3, 3), (33, 5), (97, 61),
                                    (1024, 60))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("aligned, n, d", WALKS)
def test_threads_cover_every_element_once(dtype, aligned, n, d):
    lay = diag_mono.layout(n * d, dtype, aligned)
    assert lay.variant == ("vector" if aligned else "scalar")
    got = _kernel_elements(lay, n * d, d)
    assert got == [(i, i % d) for i in range(n * d)]
    assert (lay.blocks - 1) * diag_mono._THREADS * lay.vec < n * d


def test_flagship_layout():
    assert diag_mono.layout(98304 * 60, torch.float64, True) == (
        "vector", 2, 11520)
    assert diag_mono.layout(98304 * 60, torch.float32, True) == (
        "vector", 4, 5760)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_layout_of_views(dtype):
    """The vector variant needs Z's planes, the new planes (n d apart) and
    every stage diagonal not broadcast on 16-byte boundaries."""
    Z, inv_m, hs = _inputs(64, 5, dtype)
    assert diag_mono.layout_of(Z, hs).variant == "vector"
    assert diag_mono.layout_of(Z[:, 16:48], tuple(h[16:48] for h in hs)
                               ).variant == "vector"
    assert diag_mono.layout_of(Z[:, 1:33], tuple(h[:32] for h in hs)
                               ).variant == "scalar"
    assert diag_mono.layout_of(Z[:, :32], (hs[0][1:33], *(
        h[:32] for h in hs[1:]))).variant == "scalar"
    odd = _inputs(7, 9, dtype)
    assert diag_mono.layout_of(odd[0], odd[2]).variant == "scalar"
    # a broadcast row is read by mode, not as vectors
    assert diag_mono.layout_of(Z, (hs[0][5:6].expand(64, 5), *hs[1:])
                               ).variant == "vector"


def test_layout_refuses_other_types():
    with pytest.raises(ValueError):
        diag_mono.layout(60, torch.float16, True)
    with pytest.raises(ValueError):
        diag_mono.layout(-1, torch.float64, True)
