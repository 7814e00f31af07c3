# coding: utf-8
"""The separable step's observe: K8's wrapper (`ops.observe`), the rule by
which the propagators' `_observe` takes it, the argument checks and the
layout rule.

K8 runs on the card only; every path it does not take, and every path on
the CPU, runs the propagators' PyTorch chain (`hk.hk_observe`,
`hk_prefactor_det` and `SignTracker`). On the CPU: the engage rule (on
for the AS model (Morse) and NonHarmonic, off for comp32, dense widths and
a potential whose coupling is not constant), `_observe` never calling the
wrappers, the time loop's constant NAC vector against the one
`_nac_factor` forms, the wrappers refusing CPU tensors and `check_args`
what K8 does not take; the layout tests walk the kernel's warp-to-row and
lane-to-mode map and its thread-to-row tail (`_kernel_rows`,
csrc/observe.cu's index arithmetic). On the card (marker `cuda`): K8
against the chain on rows whose C^2 crosses the branch cut of sqrt
between two steps; sub-batches under `micro_batch`, each through the
wrapper once a step, whose sums add up to the whole batch's; a kept loop
that replays its graphs for a second batch with another Gamma_0 gives
that batch's results; `_observe` calling the wrappers by the engage rule.
K8 is also held against the chain in test_torch_port_cuda.py. No JAX: the
observables' agreement with the JAX package is held by
test_torch_port_separable.py and test_torch_port_stats.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch import ops
from semiclassical_tpu_torch.ops import observe as ob
from semiclassical_tpu_torch.potentials import NonHarmonicPotential
from semiclassical_tpu_torch.propagation import graph, hk
from semiclassical_tpu_torch.propagation.state import SignTracker
from semiclassical_tpu_torch.units import hbar

from test_torch_port_graph import _morse, _normals, _propagator

# K8 against the chain: C^2 and c within 1e-14 of their largest modulus,
# the sums within 1e-14 of their modulus, the moments twice that (see
# test_torch_port_cuda.py)
_RTOL = 1e-14


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_live_loop():
    """Each test starts and ends with no time loop held by the process."""
    graph.clear()
    yield
    graph.clear()


def _device(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(device)


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _moved(name, d=6, ntraj=32, method="pseudo", steps=12, device="cpu"):
    """(potential, propagator) of a Morse model of d modes, its batch moved
    `steps` steps on (so the monodromy and the tracker are not the
    initial ones)."""
    pot, q0, G = _morse(d=d, device=device)
    prop = _propagator(name, pot, q0, G, ntraj=ntraj, method=method,
                       device=device)
    if steps:
        prop.propagate(pot, 2.0, steps, check_energy=False)
    return pot, prop


def _hk_args(prop, pot, state=None, tracker=None):
    """The HK wrapper's arguments for `prop`'s batch (or `state` and
    `tracker`), on the time loop's pack."""
    st = prop.state if state is None else state
    tr = prop.tracker if tracker is None else tracker
    bc = prop.bc
    params = prop._loop_params(pot)
    return (st.q, st.p, st.Z, st.S, bc.obs_re, bc.obs_im, bc.nacq,
            tr.previous, tr.signs, params.diag_k, hk._k8_consts(params, st))


def _rel(got, ref):
    got, ref = (torch.view_as_real(x) if x.is_complex() else x
                for x in (got, ref))
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
def test_the_tracker_flips_where_c2_crosses_the_cut():
    """Rows whose C^2 crossed the negative real axis since the previous
    step flip their sign, the others keep theirs, in K8 (both modes) as in
    `SignTracker`, and c follows the sign. This step's C^2 is moved left of
    the axis by negating the first mode's term (its four planes), and the
    previous value is its mirror image across the axis on the even rows,
    the value itself on the odd ones."""
    card = _device("cuda")
    pot, prop = _moved("HK", d=6, ntraj=64, device=card)
    params, st = prop._loop_params(pot), prop.state
    Z = st.Z.clone()
    Z[:, :, 0] = -Z[:, :, 0]
    st = dataclasses.replace(st, Z=Z)
    z = hk.hk_prefactor_det(params, st)
    even = torch.arange(z.shape[0], device=card) % 2 == 0
    previous = torch.where(even, z.conj(), z)
    signs = torch.where(torch.arange(z.shape[0], device=card) % 3 == 0,
                        -1.0, 1.0).to(torch.float64)
    tracker = SignTracker(previous, signs)
    ref = tracker.update(z)
    flipped = ref.signs != signs
    assert bool(flipped.any()) and not bool(flipped.all())
    assert not bool(flipped[~even].any())
    got = ob.prefactor(Z, previous, signs, params.diag_k)
    assert torch.equal(got[1], ref.signs)
    assert _rel(got[0], ref.previous) <= _RTOL
    assert _rel(got[2], ref.sqrt()) <= _RTOL
    assert _rel(got[2][flipped], -(torch.sqrt(z) * signs)[flipped]) <= _RTOL
    before, *sums = hk.hk_observe(params, st, tracker, pot, prop.bc, True)
    got_hk = ob.observe(*_hk_args(prop, pot, st, tracker), True)
    assert torch.equal(got_hk[1], before.signs)
    assert _rel(got_hk[0], before.previous) <= _RTOL
    for g, r, m in zip(got_hk[2:], sums, (1, 1, 2, 2)):
        assert _rel(g, r) <= m * _RTOL


def _count_calls(monkeypatch):
    """Count the calls of the wrapper by mode."""
    calls = {"observe": 0, "prefactor": 0}
    for name in calls:
        fn = getattr(ob, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(ob, name, counted)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["HK", "WM"])
def test_sub_batches_add_up(monkeypatch, name):
    """Under `micro_batch` every sub-batch goes through the wrapper once a
    step (eagerly, so that each call is seen), and the sub-batches' sums
    and moments add up to the whole batch's to rounding (the
    per-trajectory terms are the same; only the order of the sums
    differs)."""
    card = _device("cuda")
    pot, q0, G = _morse(d=6, device=card)
    runs = []
    for micro in (None, 8):
        calls = _count_calls(monkeypatch)
        prop = _propagator(name, pot, q0, G, ntraj=32, device=card)
        with graph.eager():
            out = prop.propagate(pot, 2.0, 10, error_bars=True,
                                 micro_batch=micro)
        graph.clear()
        monkeypatch.undo()
        mode = "observe" if name == "HK" else "prefactor"
        assert calls[mode] == 10 * (4 if micro else 1)
        runs.append(out)
    for got, ref in zip(*runs):
        assert np.allclose(got, ref, rtol=1e-12, atol=1e-13 * np.abs(ref)
                           .max())


@pytest.mark.cuda
def test_kept_loop_reads_the_batch_it_runs(monkeypatch):
    """A kept loop runs a second propagator's batch, with another q0 and
    another Gamma_0, by replaying the CUDA graphs the first batch
    captured: its C(t), k~ic(t) and moments equal a fresh loop's, since
    the constants K8 was captured reading are the loop's buffers, which
    then hold the second batch's pack, never the first batch's."""
    card = _device("cuda")
    monkeypatch.setattr(graph, "BLOCK_STEPS", 4)
    pot, q0, G = _morse(d=6, device=card)
    seen = []
    wrapper = ob.observe

    def spy(*args):
        seen.append(args[10])
        return wrapper(*args)

    monkeypatch.setattr(ob, "observe", spy)

    def run(center, G0, seed):
        prop = _propagator("HK", pot, q0, G, device=card)
        prop.initial_conditions(center, 0 * center, G0, pot, ntraj=32,
                                normals=_normals(q0, G, 32, seed).to(card))
        out = prop.propagate(pot, 2.0, 18, chunk=9, error_bars=True,
                             check_energy=False)
        return prop, out

    run(q0, G, 1)
    loop = graph.live(card)
    assert all(b.graph is not None for b in loop.blocks.values())
    replays = graph.STATS["replays"]
    buffers = loop.static[3]
    assert seen and all(c.q0 is buffers.q0 and c.n1 is buffers.nac_n1
                        for c in seen)
    seen.clear()
    second, kept = run(q0 + 0.03, 1.05 * G, 2)
    assert graph.live(card) is loop
    assert graph.STATS["replays"] > replays
    assert all(c.q0 is buffers.q0 for c in seen)
    assert torch.equal(buffers.q0, second.params.q0)
    graph.clear()
    _, fresh = run(q0 + 0.03, 1.05 * G, 2)
    for got, ref in zip(kept, fresh, strict=True):
        assert np.array_equal(got, ref)


class _VaryingCoupling:
    """A separable potential whose coupling changes with q (as an sGDML
    model's may): it has no `constant_coupling`."""

    def __init__(self, pot):
        self._pot = pot

    def __getattr__(self, name):
        if name == "constant_coupling":
            raise AttributeError(name)
        return getattr(self._pot, name)

    def derivative_coupling_1st(self, q):
        return self._pot.nac[None, :] * (1.0 + 0.1 * q)


def _kind(name, precision="f64", widths="diag", coupling="const",
          potential="morse", device="cpu"):
    """(potential, propagator) of the given kind: HK or WM, f64 or comp32,
    diagonal or dense widths, a constant or a varying coupling, Morse or
    NonHarmonic."""
    pot, q0, G = _morse(d=6, device=device)
    if potential == "nonharmonic":
        pot = NonHarmonicPotential.create(dim=6, device=device)
    if coupling == "varying":
        pot = _VaryingCoupling(pot)
    if widths == "dense":
        rng = np.random.default_rng(3)
        A = rng.standard_normal((6, 6)) * 0.1
        G = G + (A @ A.T) * np.diag(G).min()
    return pot, _propagator(name, pot, q0, G, precision=precision,
                            device=device)


ENGAGE = [
    (("HK",), (True, True)),
    (("WM",), (False, True)),
    (("HK", "f64", "diag", "const", "nonharmonic"), (True, True)),
    (("HK", "comp32"), (False, False)),
    (("WM", "comp32"), (False, False)),
    (("HK", "f64", "dense"), (False, False)),
    (("WM", "f64", "dense"), (False, False)),
    (("HK", "f64", "diag", "varying"), (False, True)),
]


@pytest.mark.parametrize("kind, expected", ENGAGE,
                         ids=["-".join(k) for k, _ in ENGAGE])
def test_engage_rule(kind, expected):
    """(K8 takes HK's whole observe, K8 takes the prefactor) by kind, on
    the time loop's pack (WM's holds no constant NAC vector: its
    observables stay in PyTorch)."""
    pot, prop = _kind(*kind)
    params = prop._loop_params(pot)
    params = params if kind[0] == "HK" else params.hk
    assert (hk._k8_consts(params, prop.state) is not None,
            hk._k8_prefactor_engages(params, prop.state)) == expected


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("kind, expected", ENGAGE,
                         ids=["-".join(k) for k, _ in ENGAGE])
def test_observe_goes_through_the_wrapper_where_it_engages(monkeypatch, kind,
                                                           expected, device):
    """On the card `_observe` calls the wrapper once a step where the rule
    engages it (HK: the whole observe, WM: the prefactor) and never
    elsewhere; a run elsewhere, and every run on the CPU, keeps the
    PyTorch chain."""
    device = _device(device)
    name = kind[0]
    observe_on, prefactor_on = expected if device.type == "cuda" else (
        False, False)
    pot, prop = _kind(*kind, device=device)
    calls = _count_calls(monkeypatch)
    with graph.eager():
        prop.propagate(pot, 2.0, 5, check_energy=False)
    assert calls == {"observe": 5 * (name == "HK" and observe_on),
                     "prefactor": 5 * (name == "WM" and prefactor_on)}


@pytest.mark.parametrize("potential", ["morse", "nonharmonic", "varying"])
def test_the_loop_pack_holds_the_nac_factors_n1(potential):
    """The time loop's pack holds n1 = -hbar^2 tau1/m of a potential with
    constant couplings, equal bit for bit to the n1 `_nac_factor` forms at
    every row of a batch, and None where the coupling varies; the host
    pack holds none."""
    pot, prop = _kind("HK", potential="nonharmonic" if potential ==
                      "nonharmonic" else "morse",
                      coupling="varying" if potential == "varying" else
                      "const")
    n1 = prop._loop_params(pot).nac_n1
    assert prop.params.nac_n1 is None
    if potential == "varying":
        assert n1 is None
        return
    q = prop.state.q
    inv_m = 1.0 / pot.masses()
    rows = (-(hbar**2) * pot.derivative_coupling_1st(q) * inv_m[None, :])
    assert n1.dtype == torch.float64 and n1.shape == (q.shape[1],)
    assert torch.equal(rows, n1.expand_as(rows))
    assert not bool(pot.derivative_coupling_2nd(q).any())


def _hk_case(n=12, d=6, m2_mode=True):
    pot, prop = _moved("HK", d=d, ntraj=n, steps=0)
    return _hk_args(prop, pot), m2_mode


def _bad(case):
    """Arguments of `check_args` that K8 does not take."""
    (q, p, Z, S, obs_re, obs_im, nacq, prev, signs, k, consts), m2 = \
        _hk_case()
    if case == "Z rank":
        Z = Z[0]
    elif case == "d too large":
        Z = torch.zeros(4, 12, ob.MAX_D + 1, dtype=torch.float64)
    elif case == "float32 plane":
        q = q.float()
    elif case == "q shape":
        q = q[:, :5]
    elif case == "modes apart":
        q = torch.zeros(12, 12, dtype=torch.float64)[:, ::2]
    elif case == "signs apart":
        signs = torch.ones(24, dtype=torch.float64)[::2]
    elif case == "previous real":
        prev = prev.real.contiguous()
    elif case == "host facs":
        consts = consts._replace(fac_t=complex(consts.fac_t))
    elif case == "nacq shape":
        nacq = nacq[:-1]
    elif case == "odd pairs":
        q, p, Z, S = q[:11], p[:11], Z[:, :11], S[:11]
        obs_re, obs_im, nacq = obs_re[:11], obs_im[:11], nacq[:11]
        prev, signs, m2 = prev[:11], signs[:11], "pairs"
    elif case == "bad m2_mode":
        m2 = "rows"
    return Z, prev, signs, k, (q, p, S, obs_re, obs_im, nacq, consts, m2)


BAD = ["Z rank", "d too large", "float32 plane", "q shape", "modes apart",
       "signs apart", "previous real", "host facs", "nacq shape",
       "odd pairs", "bad m2_mode"]


@pytest.mark.parametrize("case", BAD)
def test_checks_refuse(case):
    with pytest.raises(ValueError):
        ob.check_args(*_bad(case))


@pytest.mark.parametrize("mode", ["HK", "WM"])
def test_checks_refuse_another_hbar(monkeypatch, mode):
    """K8 drops hbar from its formulas: a call under hbar != 1 raises."""
    Z, prev, signs, k, hk_args = _bad(None)
    ob.check_args(Z, prev, signs, k, hk_args if mode == "HK" else None)
    monkeypatch.setattr(ob, "hbar", 0.5)
    with pytest.raises(ValueError, match="hbar"):
        ob.check_args(Z, prev, signs, k, hk_args if mode == "HK" else None)


@pytest.mark.parametrize("case", ["whole", "row view", "pairs", "n = 1",
                                  "prefactor"])
def test_checks_take(case):
    (q, p, Z, S, obs_re, obs_im, nacq, prev, signs, k, consts), m2 = \
        _hk_case(n=12)
    hk_args = (q, p, S, obs_re, obs_im, nacq, consts, m2)
    if case == "row view":
        big, _ = _hk_case(n=24)
        q, p = big[0][3:15], big[1][3:15]
        Z = big[2][:, 3:15]
        hk_args = (q, p, *hk_args[2:])
    elif case == "pairs":
        hk_args = (*hk_args[:-1], "pairs")
    elif case == "n = 1":
        (q, p, Z, S, obs_re, obs_im, nacq, prev, signs, k, consts), m2 = \
            _hk_case(n=1)
        hk_args = (q, p, S, obs_re, obs_im, nacq, consts, m2)
    ob.check_args(Z, prev, signs, k, None if case == "prefactor" else hk_args)


@pytest.mark.parametrize("mode", ["HK", "WM"])
def test_wrappers_refuse_the_cpu(mode):
    """K8 has no CPU version: the wrappers raise on CPU tensors and count
    no launch (the CPU runs the chain, `_observe`)."""
    args, m2 = _hk_case()
    before = dict(ops.launch_counts()["K8"])
    with pytest.raises(ValueError, match="card"):
        if mode == "HK":
            ob.observe(*args, m2)
        else:
            ob.prefactor(args[2], args[7], args[8], args[9])
    assert ops.launch_counts()["K8"] == before


def test_second_moment_folds_pairs():
    x = torch.tensor([1 + 2j, -1 + 1j, 3 - 1j, 1j], dtype=torch.complex128)
    assert float(hk.second_moment(x)) == 1 + 4 + 1 + 1 + 9 + 1 + 1
    assert float(hk.second_moment(x, "pairs")) == 9 + 9 + 0


# --- the layout rule and the kernel's walk ----------------------------------

def _kernel_rows(lay, n, d):
    """The (row, mode) elements each warp's lanes read in phase 1 and the
    row each lane finishes in phase 2, by csrc/observe.cu's index
    arithmetic: block b's warp w takes rows (8 b + w) R + i, i < R; lane l
    reads modes l V + 32 V k of a row and finishes the warp's row l, l <
    R."""
    reads, tails = [], []
    R = lay.rows_per_warp
    for b in range(lay.blocks):
        for w in range(8):
            row0 = (8 * b + w) * R
            for i in range(R):
                row = row0 + i
                if row >= n:
                    break
                for lane in range(32):
                    for j in range(lane * lay.vec, d, 32 * lay.vec):
                        reads += [(row, j + e) for e in range(lay.vec)]
            tails += [row0 + lane for lane in range(32)
                      if lane < R and row0 + lane < n]
    return reads, tails


WALKS = [(True, 37, 60), (True, 1, 60), (False, 37, 61), (True, 50000, 2),
         (True, 100000, 2), (True, 300, 130), (False, 5, 1), (True, 0, 60)]


@pytest.mark.parametrize("aligned, n, d", WALKS)
def test_every_element_read_once_and_every_row_finished_once(aligned, n, d):
    lay = ob.layout(n, d, aligned)
    reads, tails = _kernel_rows(lay, n, d)
    assert sorted(reads) == [(r, j) for r in range(n) for j in range(d)]
    assert sorted(tails) == list(range(n))
    assert lay.blocks * lay.rows_per_warp * 8 >= n
    # a warp's first row is even: the pairs of "pairs" share a warp
    assert lay.rows_per_warp % 2 == 0 and lay.rows_per_warp <= 32


def test_flagship_layouts():
    assert ob.layout(98304, 60, True) == ob.Layout("vector", 2, 32, 384)
    assert ob.layout(65536, 60, True) == ob.Layout("vector", 2, 16, 512)
    assert ob.layout(32768, 60, True) == ob.Layout("vector", 2, 8, 512)
    assert ob.layout(1000, 60, True) == ob.Layout("vector", 2, 8, 16)
    assert ob.layout(98304, 61, True).variant == "scalar"
    assert ob.layout(98304, 60, False).variant == "scalar"


def test_layout_of_views():
    (q, p, Z, *_), _ = _hk_case(n=24)
    assert ob.layout_of(Z, q, p).variant == "vector"
    assert ob.layout_of(Z[:, 2:10], q[2:10], p[2:10]).variant == "vector"
    assert ob.layout_of(Z[:, 1:9], q[1:9], p[1:9]).variant == "vector"
    zo = torch.zeros(4 * 24 * 6 + 1, dtype=torch.float64)[1:].view(4, 24, 6)
    assert ob.layout_of(zo).variant == "scalar"
    (q7, p7, Z7, *_), _ = _hk_case(n=24, d=7)
    assert ob.layout_of(Z7, q7, p7).variant == "scalar"


def test_layout_refuses():
    with pytest.raises(ValueError):
        ob.layout(-1, 6, True)
    with pytest.raises(ValueError):
        ob.layout(8, 0, True)
    with pytest.raises(ValueError):
        ob.layout(8, ob.MAX_D + 1, True)
