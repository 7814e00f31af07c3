# coding: utf-8
"""The port's compiled time loop (`propagation.graph`) on the CPU, where
every block runs eagerly through the body that the card captures, and on
the card (marker `cuda`).

* The capturability guard: one block body of each path (HK and WM on the
  dense, diagonal and sGDML taylor paths, the exact harmonic and Morse
  maps, float64 and comp32) runs under a guard that makes every host read
  and every tensor made from host values raise — what a CUDA graph cannot
  hold. The guard catches the host-to-device copy the diagonal RK4 step
  made every step before its seeds were made once.
* Block boundaries: the block loop against the step loop it replaced (the
  reference below, step by step) bit for bit — the same operations on the
  same values, so the same rounding — with nt and `chunk` that are no
  multiple of the block length, `taylor_every` windows of 8, `micro_batch`,
  error bars (plain and antithetic), comp32 and the exact Morse map with
  routed rows; and against the JAX package's jitted scans (`_hk_scan_jit`,
  `_wm_scan_jit`, `_hk_scan_micro_jit` through its `propagate`) at float64
  to the parity tests' tolerances: C(t) and k~ic(t) 1e-8 of their largest
  modulus, the stderr 1e-10 (tests/test_torch_port_stats.py).
* The launch table on a stub graph (a block that bumps it, and one that
  launches through stubbed entry points of `ops._build`), the cache's
  context and its drops.
* On the card: graph against eager at 1e-13 of the largest modulus with
  equal launch counts, and a capture that reads the host raises.

The JAX package is imported inside the tests that compare with it, so the
card tests run on a machine without it (`--noconftest`).
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch import ops
from semiclassical_tpu_torch.ops import _build, diag_mono
from semiclassical_tpu_torch.potentials import MorsePotential
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator,
                                                 graph, hk)
from semiclassical_tpu_torch.propagation.state import TrajState

NTRAJ = 32
CELL = 500.0


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


# --- the step loop the blocks replaced --------------------------------------

def _cat_batches(parts):
    """The inverse of `hk._batch_rows` over consecutive sub-batches."""
    first = parts[0]
    if isinstance(first, TrajState):
        dim = 1 if first.diag_monodromy else 0
        cat = lambda name: (None if getattr(first, name) is None else
                            torch.cat([getattr(x, name) for x in parts]))
        return TrajState(q=cat("q"), p=cat("p"),
                         Z=torch.cat([x.Z for x in parts], dim=dim),
                         S=cat("S"), qc=cat("qc"), pc=cat("pc"))
    fields = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if isinstance(v, torch.Tensor):
            v = torch.cat([getattr(x, f.name) for x in parts])
        elif dataclasses.is_dataclass(v):
            v = _cat_batches([getattr(x, f.name) for x in parts])
        fields[f.name] = v
    return dataclasses.replace(first, **fields)


def step_loop(prop, potential, dt, nt, chunk=None, progress=None,
              m2_mode=False):
    """`_run` as the port ran it before its blocks: every segment
    sub-batch by sub-batch, step by step, each result written into its
    column, the sub-batches concatenated at the segment's end."""
    fresh, advance, _ = prop._stepper(potential, dt)
    pack, carry = prop._morse_map(potential, dt)
    if chunk is None or chunk >= nt:
        segments = [nt]
    else:
        segments = [chunk] * (nt // chunk) + ([nt % chunk]
                                               if nt % chunk else [])
    k, n = prop._micro_k(m2_mode), prop.n_local
    rows = [(s * n // k, (s + 1) * n // k) for s in range(k)]
    bcs = ([prop.bc] if k == 1
           else [hk._batch_rows(prop.bc, a, b) for a, b in rows])
    cauto = torch.empty(k, nt, dtype=prop.cdtype)
    kic = torch.empty(k, nt, dtype=prop.cdtype)
    energies = torch.empty(k, nt, dtype=prop.state.q.dtype)
    m2 = torch.empty(2, k, nt, dtype=torch.float64) if m2_mode else None
    state, tracker = prop.state, prop.tracker
    carries = [carry] * k
    done = 0
    for seg in segments:
        parts = []
        for s, (a, b) in enumerate(rows):
            st, tr = ((state, tracker) if k == 1 else
                      (hk._batch_rows(state, a, b),
                       hk._batch_rows(tracker, a, b)))
            st, carries[s] = fresh(st, carries[s], pack)
            for i in range(done, done + seg):
                tr, cauto[s, i], kic[s, i], m2c, m2k = prop._observe(
                    prop.params, st, tr, potential, bcs[s], m2_mode)
                if m2_mode:
                    m2[0, s, i], m2[1, s, i] = m2c, m2k
                st, energies[s, i], carries[s] = advance(st, carries[s],
                                                         pack)
            parts.append((st, tr))
        state, tracker = (parts[0] if k == 1 else
                          tuple(_cat_batches(list(x)) for x in zip(*parts)))
        done += seg
    prop.state, prop.tracker = state, tracker
    if prop._morse is not None:
        prop._morse.state, prop._morse.carry = state, carries[0]
    prop.t += nt * float(dt)
    if k == 1:
        return cauto[0], kic[0], energies[0], (None if m2 is None
                                               else m2[:, 0])
    return (cauto.sum(dim=0), kic.sum(dim=0), energies.mean(dim=0),
            None if m2 is None else m2.sum(dim=1))


# --- models (synthetic, and the fixtures' where a path needs them) ----------

def _morse(d=5, seed=0, chi=0.02, device="cpu"):
    """A random separable Morse model: (potential, q0, Gamma)."""
    rng = np.random.default_rng(seed)
    omega = rng.uniform(300.0, 2800.0, size=d) / 219474.63
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.02, 0.3, size=d)
    return (MorsePotential.create(omega, np.full(d, chi), nac, device=device),
            np.sqrt(2 * S / omega), np.diag(omega))


def _methylium(ref_data):
    from test_torch_port_stats import _methylium as stats_methylium
    s = stats_methylium(ref_data)
    return s["pot"], s["q0"], s["G"], s["dt"]


def _coumarin(ref_data, every=8):
    """The coumarin sGDML potential with hessian_eval "taylor" and
    `taylor_every` `every`, its center and widths."""
    from semiclassical_tpu_torch.io.fchk import FormattedCheckpointFile
    from semiclassical_tpu_torch.potentials import (MolecularGDMLPotential,
                                                    minimize)
    from test_torch_port_gdml import MODEL

    model_path = ref_data / "GDML" / MODEL
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    x0, G0, _ = exc.vibrational_groundstate()
    pot = minimize(MolecularGDMLPotential.create(
        dict(np.load(model_path, allow_pickle=True)), exc, "cpu"), x0)
    pot = dataclasses.replace(pot, hessian_eval="taylor", taylor_every=every)
    return pot, x0, G0, 2.0


def _propagator(name, pot, q0, G, ntraj=NTRAJ, seed=5, method="pseudo",
                integrator="rk4", precision="f64", device="cpu"):
    """A propagator of the model with a batch drawn from numpy normals
    (the same batch for the same arguments)."""
    from semiclassical_tpu_torch.sampling import SamplingParams

    dtype, traj = {"f64": (torch.float64, torch.float64),
                   "comp32": (torch.float32, "comp32")}[precision]
    args = (CELL, CELL) if name == "WM" else ()
    prop = (WaltonManolopoulosPropagator if name == "WM"
            else HermanKlukPropagator)(G, G, *args, device=device,
                                       integrator=integrator, dtype=dtype,
                                       traj_dtype=traj)
    rank = SamplingParams.create(q0, 0 * q0, G, G, "cpu").rank
    rng = np.random.default_rng(seed)
    if method == "antithetic":
        half = rng.standard_normal((ntraj // 2, 2 * rank))
        normals = np.stack([half, -half], 1).reshape(ntraj, 2 * rank)
    else:
        normals = rng.standard_normal((ntraj, 2 * rank))
    prop.initial_conditions(q0, 0 * q0, G, pot, ntraj=ntraj,
                            normals=torch.from_numpy(normals).to(device),
                            sampling_method=method)
    return prop


def _hot(prop, pot):
    """Push two rows over EPS_EXACT (one unbound, one near the
    separatrix): the exact Morse map routes them to its RK4
    side-channel."""
    D = pot.D.numpy()
    p = prop.state.p.clone()
    p[3, 0] = float(np.sqrt(2.1 * D[0]))
    p[11, 2] = float(np.sqrt(1.9 * D[2] * 0.95))
    prop.state = dataclasses.replace(prop.state, p=p)


def _model(case, ref_data):
    """(potential, q0, Gamma, dt, integrator) of a path."""
    if case in ("dense", "harmonic"):
        pot, q0, G, dt = _methylium(ref_data)
        return pot, q0, G, dt, "exact" if case == "harmonic" else "rk4"
    if case == "taylor":
        return (*_coumarin(ref_data), "rk4")
    pot, q0, G = _morse()
    return pot, q0, G, 2.0, "exact" if case == "morse" else "rk4"


# --- the capturability guard ------------------------------------------------

class HostRead(RuntimeError):
    """What the guard raises."""


_TORCH_FUNCTIONS = ("tensor", "as_tensor")
_TENSOR_METHODS = ("item", "cpu", "numpy", "tolist", "__bool__", "__float__",
                   "__int__", "__complex__")


@contextlib.contextmanager
def host_guard():
    """Make torch.tensor, torch.as_tensor, Tensor.item / .cpu / .numpy /
    .tolist and the Python conversions __bool__ / __float__ / __int__ /
    __complex__ raise HostRead: a host read, or a tensor made from host
    values, inside a CUDA graph capture fails or freezes a value."""
    def refuse(name):
        def raise_(*args, **kwargs):
            raise HostRead(f"{name} inside a captured block")
        return raise_

    saved = [(torch, name, torch.__dict__[name]) for name in _TORCH_FUNCTIONS]
    saved += [(torch.Tensor, name, torch.Tensor.__dict__.get(name))
              for name in _TENSOR_METHODS]
    for owner, name, _ in saved:
        setattr(owner, name, refuse(name))
    try:
        yield
    finally:
        for owner, name, value in saved:
            if value is None:
                delattr(owner, name)
            else:
                setattr(owner, name, value)


@pytest.fixture
def guarded(monkeypatch):
    """Every block body of the time loop runs under `host_guard`; returns
    the number of bodies run."""
    count = [0]
    run = graph.SegmentGraph.run

    def guarded_run(self, name, make):
        def make_guarded():
            body, slots = make()

            def guarded_body():
                count[0] += 1
                with host_guard():
                    body()
            return guarded_body, slots
        return run(self, name, make_guarded)

    monkeypatch.setattr(graph.SegmentGraph, "run", guarded_run)
    return count


def test_guard_refuses_host_reads():
    x = torch.ones(3)
    for read in (lambda: torch.tensor([1.0, 0.0]), lambda: x.sum().item(),
                 lambda: bool(x[0] > 0), lambda: float(x[0]),
                 lambda: x.tolist(), lambda: x.numpy(), lambda: x.cpu(),
                 lambda: torch.as_tensor(np.ones(2))):
        with host_guard(), pytest.raises(HostRead):
            read()
    assert x.sum().item() == 3.0 and bool(x[0] > 0)   # restored


def test_guard_catches_the_old_diagonal_seeds(monkeypatch, guarded):
    """The diagonal RK4 step made its seeds (1, 0) and (0, 1) from host
    values every step: the guard refuses that step."""
    pot, q0, G = _morse()
    prop = _propagator("HK", pot, q0, G)

    def seeds_from_host(dtype, device):
        return (torch.tensor([1.0, 0.0], dtype=dtype,
                             device=device).view(2, 1, 1),
                torch.tensor([0.0, 1.0], dtype=dtype,
                             device=device).view(2, 1, 1))

    monkeypatch.setattr(diag_mono, "_seeds", seeds_from_host)
    with pytest.raises(HostRead, match="tensor"):
        prop.propagate(pot, 2.0, 3)


GUARD_CASES = [(name, case, precision)
               for name in ("HK", "WM")
               for case, precision in (("dense", "f64"), ("diag", "f64"),
                                       ("taylor", "f64"), ("harmonic", "f64"),
                                       ("morse", "f64"), ("diag", "comp32"),
                                       ("dense", "comp32"),
                                       ("morse", "comp32"))]


@pytest.mark.parametrize("name, case, precision", GUARD_CASES,
                         ids=["-".join(c) for c in GUARD_CASES])
def test_block_bodies_read_nothing_from_the_host(ref_data, monkeypatch,
                                                 guarded, name, case,
                                                 precision):
    """Two segments of two blocks each (one block each of a taylor_every
    8 window), with error bars, under the guard (the exact Morse map with
    two routed rows)."""
    monkeypatch.setattr(graph, "BLOCK_STEPS", 4)
    pot, q0, G, dt, integrator = _model(case, ref_data)
    prop = _propagator(name, pot, q0, G, ntraj=16, integrator=integrator,
                       precision=precision)
    if case == "morse":
        _hot(prop, pot)
    prop.propagate(pot, dt, 16, chunk=8, error_bars=True,
                   check_energy=case != "morse")
    every = int(getattr(pot, "taylor_every", 1) or 1)
    assert guarded[0] == 2 * len(graph.block_lengths(8, every))


# --- block boundaries: the block loop against the step loop -----------------

def _same_run(make, run, block=None, monkeypatch=None):
    """Run `run(prop)` on two propagators made by `make()`, one through the
    block loop (blocks of `block` steps if given), one through
    `step_loop`; both results, states and trackers must be equal bit for
    bit (the same operations on the same values)."""
    if block is not None:
        monkeypatch.setattr(graph, "BLOCK_STEPS", block)
    blocks, steps = make(), make()
    steps._run = lambda *a, **kw: step_loop(steps, *a, **kw)
    got, ref = run(blocks), run(steps)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r, equal_nan=True)
    np.testing.assert_array_equal(blocks.last_energies, steps.last_energies)
    for a, b in ((blocks.state, steps.state), (blocks.tracker, steps.tracker)):
        for x, y in zip(graph._leaves(a), graph._leaves(b)):
            assert torch.equal(x, y)
    assert blocks.t == steps.t
    return blocks, steps


BOUNDARY_CASES = [
    # (path, propagator, nt, chunk, block, micro_batch, error bars, method,
    #  precision)
    ("dense", "HK", 47, 30, 7, 0, False, "pseudo", "f64"),
    ("dense", "WM", 23, None, 5, 0, True, "pseudo", "f64"),
    ("dense", "WM", 29, 10, 4, 16, True, "antithetic", "f64"),
    ("diag", "HK", 47, 30, 7, 0, True, "antithetic", "f64"),
    ("diag", "WM", 41, 13, None, 8, True, "pseudo", "f64"),
    ("diag", "HK", 33, 20, 6, 16, False, "pseudo", "comp32"),
    ("diag", "WM", 33, 20, 6, 0, True, "pseudo", "comp32"),
    ("dense", "HK", 21, 8, 5, 0, True, "pseudo", "comp32"),
    ("harmonic", "WM", 27, 11, 4, 0, True, "pseudo", "f64"),
    ("morse", "HK", 37, 15, 4, 0, True, "pseudo", "f64"),
    ("morse", "WM", 37, 15, 4, 0, True, "antithetic", "f64"),
    ("morse", "HK", 25, 10, 3, 0, False, "pseudo", "comp32"),
    ("taylor", "HK", 26, 20, 5, 0, False, "pseudo", "f64"),
    ("taylor", "WM", 19, None, 3, 0, True, "pseudo", "f64"),
]


@pytest.mark.parametrize(
    "case, name, nt, chunk, block, micro, error_bars, method, precision",
    BOUNDARY_CASES, ids=["-".join(map(str, c)) for c in BOUNDARY_CASES])
def test_blocks_equal_the_step_loop(ref_data, monkeypatch, case, name, nt,
                                    chunk, block, micro, error_bars, method,
                                    precision):
    """nt, chunk and the block length chosen so that segments end inside
    blocks and blocks have tails; under taylor_every 8 the block is the
    least multiple of 8 not below the given length, so windows restart at
    block heads; the propagator is called twice (the loop's graphs and
    the Morse map's carry persist across calls)."""
    pot, q0, G, dt, integrator = _model(case, ref_data)
    ntraj = 16 if case == "taylor" else NTRAJ

    def make():
        prop = _propagator(name, pot, q0, G, ntraj=ntraj, method=method,
                           integrator=integrator, precision=precision)
        if case == "morse":
            _hot(prop, pot)
        return prop

    def run(prop):
        outs = [prop.propagate(pot, dt, n, chunk=chunk, micro_batch=micro,
                               error_bars=error_bars,
                               check_energy=case != "morse")
                for n in (nt, nt // 3)]
        return [np.concatenate(x) for x in zip(*outs)]

    blocks, _ = _same_run(make, run, block, monkeypatch)
    if case == "morse":
        assert blocks._morse.pack.sub_idx.tolist() == [3, 11]
        assert blocks._morse.state is blocks.state


def test_step_between_blocks_equals_the_step_loop(ref_data, monkeypatch):
    """`step` (a block of one step) between `propagate` calls."""
    pot, q0, G = _morse()

    def run(prop):
        out = [prop.propagate(pot, 2.0, 9, chunk=4)]
        prop.step(pot, 2.0)
        prop.step(pot, 2.0)
        out.append(prop.propagate(pot, 2.0, 9, chunk=4))
        return [np.concatenate(x) for x in zip(*out)]

    _same_run(lambda: _propagator("WM", pot, q0, G), run, 3, monkeypatch)


def test_block_lengths():
    assert graph.block_lengths(100) == [graph.BLOCK_STEPS] * (
        100 // graph.BLOCK_STEPS)
    assert graph.block_lengths(0) == []
    b = graph.block_lengths(500, 8)
    assert b[0] % 8 == 0 and b[0] >= graph.BLOCK_STEPS
    assert sum(b) == 500 and all(x == b[0] for x in b[:-1])
    assert graph.block_lengths(5, 32) == [5]


# --- against the JAX package's jitted scans ---------------------------------

JAX_CASES = [("as5", "HK", "pseudo", 0), ("as5", "WM", "antithetic", 0),
             ("methylium", "HK", "pseudo", 0),
             ("methylium", "WM", "pseudo", 0),
             ("as5", "HK", "pseudo", 16), ("methylium", "WM", "pseudo", 16)]


@pytest.mark.parametrize("model, name, method, micro", JAX_CASES,
                         ids=["-".join(map(str, c)) for c in JAX_CASES])
def test_blocks_match_the_jax_scans(ref_data, monkeypatch, model, name,
                                    method, micro):
    """The port's block loop (blocks of 4 steps, segments of 10, 23 steps:
    blocks of 4, 4, 2 and a last segment of 3) against the JAX package's
    `propagate` over `_hk_scan_jit` / `_wm_scan_jit` (and its
    `_hk_scan_micro_jit` with micro_batch 16 of 64) from the same draws:
    C(t) and k~ic(t) 1e-8 of their largest modulus, the stderr 1e-10."""
    from test_torch_port_stats import (NTRAJ as STATS_NTRAJ, _as5,
                                       _assert_stderr_close, _pair)
    from test_torch_port_stats import _methylium as stats_methylium

    monkeypatch.setattr(graph, "BLOCK_STEPS", 4)
    s = _as5(ref_data) if model == "as5" else stats_methylium(ref_data)
    prop, prop_j = _pair(s, name, method, monkeypatch)
    assert prop.n_local == STATS_NTRAJ
    kw = dict(energy0_es=s["en0"], chunk=10, error_bars=True,
              micro_batch=micro or None)
    got = prop.propagate(s["pot"], s["dt"], 23, **kw)
    ref = prop_j.propagate(s["pot_j"], s["dt"], 23, **kw)
    for g, r in zip(got[:2], ref[:2]):
        assert g.shape == r.shape == (23,)
        assert np.abs(g - r).max() <= 1e-8 * np.abs(r).max()
    for g, r in zip(got[2:], ref[2:]):
        _assert_stderr_close(g, r, 1e-10)
    np.testing.assert_allclose(prop.state.q.numpy(),
                               np.asarray(prop_j.state.q), rtol=0, atol=1e-9)


# --- launch counters and the cache ------------------------------------------

class StubGraph(graph.SegmentGraph):
    """A SegmentGraph whose capture runs the body's Python (as a capture
    does: the wrappers count) and whose replays run nothing."""

    replays = 0

    def _record(self, body):
        body()
        return types.SimpleNamespace(replay=self._count_replay)

    def _count_replay(self):
        self.replays += 1


def _stub_entries(monkeypatch):
    """Entry points of K1 and K2 at complex64 that record their calls, and
    a current device and stream for a CUDA device the CPU does not have:
    `_build.launch` then runs as on the card, the ctypes call aside."""
    calls = []
    for kernel in ("det_lu", "gj_det_solve"):
        monkeypatch.setitem(_build._bound, (kernel, torch.complex64), (
            lambda *args, kernel=kernel: calls.append(kernel) or 0,
            (kernel, "complex64")))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("how", ["table", "launch"])
def test_counters_count_replays(monkeypatch, how):
    """One step's launches, K1 once and K2 three times, counted once for
    every run of a block: the eager warm-up and each replay, never a
    capture. The block bumps the table itself, or launches through
    `_build.launch` with stubbed entry points (which a capture calls, as
    it records the launches)."""
    ops.reset_launch_counts()
    entries = _stub_entries(monkeypatch) if how == "launch" else None
    card = torch.device("cuda", 0)
    ran = []

    def body():
        ran.append(1)
        if how == "table":
            ops.LAUNCHES["det_lu", "complex64"] += 1
            ops.LAUNCHES["gj_det_solve", "complex64"] += 3
            return
        _build.launch("det_lu", torch.complex64, card, 0, 0, 1, 6, 1)
        for _ in range(3):
            _build.launch("gj_det_solve", torch.complex64, card, 0)

    def counts():
        return {k: sum(n.values()) for k, n in ops.launch_counts().items()}

    stats = dict(graph.STATS)
    loop = StubGraph((), (), "cpu", capture=True)
    for calls in range(1, 6):
        assert loop.run("b", lambda: (body, None)) is None
        # the warm-up, the capture and its twin's capture ran the body;
        # every call counts once
        assert len(ran) == min(2 * calls - 1, 3)
        by_dtype = ops.launch_counts()
        assert by_dtype["K1"] == {"complex128": 0, "complex64": calls}
        assert by_dtype["K2"] == {"complex128": 0, "complex64": 3 * calls}
        assert counts() == {**dict.fromkeys(_build.KERNELS, 0),
                            "K1": calls, "K2": 3 * calls}
    assert loop.replays == 4
    assert graph.STATS["replays"] - stats["replays"] == 4
    assert graph.STATS["captures"] - stats["captures"] == 1
    assert graph.STATS["trace_captures"] - stats["trace_captures"] == 1
    assert graph.STATS["eager_blocks"] - stats["eager_blocks"] == 1

    eager = StubGraph((), (), "cpu", capture=False)
    for _ in range(3):
        eager.run("b", lambda: (body, None))
    assert len(ran) == 6 and counts()["K1"] == 8 and eager.replays == 0
    if how == "launch":
        # the entry points ran at every run of the body's Python
        assert entries == ["det_lu", *["gj_det_solve"] * 3] * 6
        # each label reads a kernel of the entry-point table, at the
        # types it is built for
        assert _build.KERNELS == {
            "K1": "det_lu", "K2": "gj_det_solve", "K3": "gj_det_inv",
            "K4": "det_lu_block", "K5": "wm_diag", "K6": "diag_mono",
            "K7": "morse_rk4", "K8": "observe"}
        for label, types_ in ops.launch_counts().items():
            kernel = _build.KERNELS[label]
            assert kernel in _build._ENTRY_POINTS
            assert len(types_) == len(_build._ENTRY_POINTS[kernel][1])
            assert set(types_) <= set(map(_build.dtype_name, _build._SUFFIX))


def test_eager_context_and_capture_choice():
    assert not graph.captures("cpu")
    assert graph.captures("cuda")
    with graph.eager():
        assert not graph.captures("cuda")
        with graph.eager():
            assert not graph.captures("cuda")
        assert not graph.captures("cuda")
    assert graph.captures("cuda")


def test_cache_holds_its_context_and_is_dropped(ref_data, tmp_path):
    """The device's loop is the process's, kept by its key: across calls,
    `initial_conditions`, a checkpoint restore, `_invalidate_map` and a new
    propagator of the same key; dropped for another dt, potential,
    error-bar mode, precision, batch shape or sub-batch layout, and by
    `graph.clear`."""
    from semiclassical_tpu_torch.checkpoint import (load_propagator_state,
                                                    save_propagator_state)

    pot, q0, G = _morse()
    prop = _propagator("HK", pot, q0, G)
    prop.propagate(pot, 2.0, 5)
    loop = prop._loop
    assert loop is graph.live("cpu") and loop.key[0] is pot
    prop.propagate(pot, 2.0, 7, chunk=3)
    assert prop._loop is loop and len(loop.blocks) == 3
    save_propagator_state(str(tmp_path / "ck.npz"), prop)
    prop.initial_conditions(q0, 0 * q0, G, pot, ntraj=NTRAJ,
                            generator=torch.Generator().manual_seed(1))
    prop.propagate(pot, 2.0, 5)
    load_propagator_state(str(tmp_path / "ck.npz"), prop)
    prop.propagate(pot, 2.0, 5)
    prop._invalidate_map()
    prop.propagate(pot, 2.0, 5)
    other = _propagator("HK", pot, 1.1 * q0, G, seed=9)
    other.propagate(pot, 2.0, 5)
    assert prop._loop is loop and other._loop is loop
    assert len(loop.blocks) == 3

    def dropped(run):
        before = graph.live("cpu")
        run()
        assert graph.live("cpu") is not before
        return graph.live("cpu")

    dropped(lambda: prop.propagate(pot, 2.0, 5, error_bars=True))
    dropped(lambda: prop.propagate(pot, 1.0, 5, error_bars=True))
    moved = dataclasses.replace(pot)
    assert dropped(lambda: prop.propagate(moved, 1.0, 5)).key[0] is moved
    dropped(lambda: _propagator("WM", pot, q0, G).propagate(pot, 2.0, 5))
    dropped(lambda: _propagator("HK", pot, q0, G, precision="comp32")
            .propagate(pot, 2.0, 5))
    dropped(lambda: _propagator("HK", pot, q0, G, ntraj=16)
            .propagate(pot, 2.0, 5))
    dropped(lambda: prop.propagate(pot, 2.0, 5, micro_batch=8))
    dropped(lambda: prop.propagate(pot, 2.0, 5, micro_batch=16))
    graph.clear()
    assert graph.live("cpu") is None and prop._loop is None


class ReplayGraph(graph.SegmentGraph):
    """A SegmentGraph that captures on the CPU: the capture records the
    body's closure and runs nothing, a replay runs what was recorded, as a
    CUDA graph replays what it captured (the addresses and the Python
    values of its capture, whatever the caller holds now)."""

    def __init__(self, key, static, device, capture=True):
        super().__init__(key, static, device, capture)

    def _record(self, body):
        return types.SimpleNamespace(replay=body)


@pytest.fixture
def replays(monkeypatch):
    """The process's loops made as ReplayGraphs."""
    monkeypatch.setattr(graph, "SegmentGraph", ReplayGraph)
    graph.clear()
    yield
    graph.clear()


def _outputs(prop, pot, dt, nt, **kw):
    """Everything a run gives: its curves (and stderr), the energies, the
    state, the trackers."""
    out = prop.propagate(pot, dt, nt, chunk=9, error_bars=True,
                         check_energy=False, **kw)
    return (*out, prop.last_energies,
            *graph._leaves((prop.state, prop.tracker)))


def _assert_equal(got, ref):
    for g, r in zip(got, ref, strict=True):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g, r)
        else:
            assert np.array_equal(g, r)


def _normals(q0, G, ntraj, seed):
    """(ntraj, 2 rank) standard normals from numpy at `seed`."""
    from semiclassical_tpu_torch.sampling import SamplingParams

    rank = SamplingParams.create(q0, 0 * q0, G, G, "cpu").rank
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((ntraj, 2 * rank)))


KEPT_CASES = [("dense", "HK"), ("dense", "WM"), ("diag", "HK"),
              ("diag", "WM"), ("taylor", "HK"), ("harmonic", "WM")]


@pytest.mark.parametrize("case, name", KEPT_CASES,
                         ids=["-".join(c) for c in KEPT_CASES])
def test_kept_loop_equals_a_fresh_loop(ref_data, monkeypatch, tmp_path,
                                       replays, case, name):
    """On loops that capture and replay (ReplayGraph, blocks of 4): a
    later batch of the same propagator, a second propagator with another
    q0 (and, for HK, another Gamma_0) of the same shapes, and a restored
    checkpoint each run through the loop and the recorded blocks of an
    earlier batch, and give C(t), k~ic(t), their stderr (the second
    moments), the energies, the state and the trackers equal to those of
    a fresh loop. A block that read the earlier batch's values through
    its closure would differ. (WM's pack bakes in host scalars of
    Gamma_0, its `auto_pref` and `m_scale`: another Gamma_0 is another
    loop there.)"""
    from semiclassical_tpu_torch.checkpoint import (load_propagator_state,
                                                    save_propagator_state)

    monkeypatch.setattr(graph, "BLOCK_STEPS", 4)
    pot, q0, G, dt, integrator = _model(case, ref_data)
    # segments of 9 in blocks of 4 (taylor_every 8: of 8) and 1: every
    # block runs at least twice, so every one is recorded by the first run
    nt, ntraj = 18, 16 if case == "taylor" else NTRAJ

    def draw(prop, center, G0, seed):
        prop.initial_conditions(center, 0 * center, G0, pot, ntraj=ntraj,
                                normals=_normals(q0, G, ntraj, seed))
        return prop

    def new(center=q0, G0=G, seed=1):
        return draw(_propagator(name, pot, q0, G, ntraj=ntraj,
                                integrator=integrator), center, G0, seed)

    def earlier_loop():
        """A fresh loop that has run one batch, every block recorded."""
        graph.clear()
        _outputs(new(seed=1), pot, dt, nt)
        loop = graph.live("cpu")
        assert all(b.graph is not None for b in loop.blocks.values())
        return loop, dict(loop.blocks)

    first = new()
    cases = {
        "later batch": lambda: draw(first, q0, G, 2),
        "second propagator": lambda: new(q0 + 0.03,
                                         1.05 * G if name == "HK" else G, 3),
    }
    for label, make in cases.items():
        loop, blocks = earlier_loop()
        kept = _outputs(make(), pot, dt, nt)
        assert graph.live("cpu") is loop and loop.blocks == blocks, label
        graph.clear()
        _assert_equal(kept, _outputs(make(), pot, dt, nt))

    # the first propagator's batch after nt steps, checkpointed; its next
    # nt steps through a fresh loop, and again from the checkpoint restored
    # into a propagator whose batch ran through that loop since
    ck = str(tmp_path / "ck.npz")
    save_propagator_state(ck, first)
    graph.clear()
    tail = _outputs(first, pot, dt, nt)
    loop, blocks = graph.live("cpu"), dict(graph.live("cpu").blocks)
    other = new(seed=4)
    _outputs(other, pot, dt, nt)
    load_propagator_state(ck, other)
    _assert_equal(_outputs(other, pot, dt, nt), tail)
    assert graph.live("cpu") is loop and loop.blocks == blocks


def _routed(prop, pot, rows):
    """Push `rows` over EPS_EXACT: the exact Morse map routes them to its
    RK4 side-channel."""
    D = pot.D.cpu().numpy()
    p = prop.state.p.clone()
    for row in rows:
        p[row, row % 5] = float(np.sqrt(2.1 * D[row % 5]))
    prop.state = dataclasses.replace(prop.state, p=p)
    return prop


def test_exact_morse_batches_through_the_loop(replays, monkeypatch):
    """The exact Morse map's pack and carry load into the kept loop: a
    second batch with as many routed rows (other rows, other values) runs
    through it, one with another count captures anew (its side-channel's
    shapes are in the key, as a new shape recompiles a JAX scan); each
    equal to a fresh loop's run."""
    monkeypatch.setattr(graph, "BLOCK_STEPS", 4)
    pot, q0, G = _morse()

    def batch(seed, rows):
        prop = _propagator("HK", pot, q0, G, seed=seed, integrator="exact")
        return _routed(prop, pot, rows)

    def outputs(prop, rows):
        out = _outputs(prop, pot, 2.0, 18)
        assert prop._morse.pack.sub_idx.tolist() == sorted(rows)
        return out

    outputs(batch(5, (3, 11)), (3, 11))
    loop = graph.live("cpu")
    blocks = dict(loop.blocks)
    for seed, rows, kept in ((6, (5, 20), True), (7, (8,), False)):
        got = outputs(batch(seed, rows), rows)
        assert (graph.live("cpu") is loop) == kept
        assert (graph.live("cpu").blocks == blocks) == kept
        graph.clear()
        _assert_equal(got, outputs(batch(seed, rows), rows))


def test_sub_batches_share_one_block_per_length(monkeypatch, replays):
    """Under micro_batch the k sub-batches run through one staging tree and
    one recorded block per distinct length; the run equals the step loop
    bit for bit (the reference that blocks named per (sub-batch, length)
    equalled too, test_blocks_equal_the_step_loop), and a second batch
    reuses every block."""
    pot, q0, G = _morse()

    def run(prop):
        return prop.propagate(pot, 2.0, 23, chunk=10, micro_batch=8,
                              error_bars=True)

    make = lambda: _propagator("WM", pot, q0, G)
    _same_run(make, run, 4, monkeypatch)
    loop = graph.live("cpu")
    lengths = {4, 2, 3}     # segments 10, 10, 3 in blocks of 4
    assert set(loop.blocks) == lengths
    assert loop.static[0].q.shape[0] == 8
    blocks = dict(loop.blocks)
    run(make())
    assert graph.live("cpu") is loop and loop.blocks == blocks


def test_state_is_materialised_per_segment():
    """`progress` sees the state of its segment's end in `self.state`, a
    copy that later blocks leave alone."""
    pot, q0, G = _morse()
    prop = _propagator("HK", pot, q0, G)
    seen = []
    prop.propagate(pot, 2.0, 9, chunk=4,
                   progress=lambda done, nt, c: seen.append(
                       (done, prop.state, prop.state.q.clone())))
    assert [d for d, _, _ in seen] == [4, 8, 9]
    for _, state, q in seen:
        assert torch.equal(state.q, q)
        assert state.q.data_ptr() != prop._loop.static[0].q.data_ptr()
    assert seen[-1][1] is prop.state


def test_morse_time_is_a_device_scalar():
    from semiclassical_tpu_torch.propagation import exact_morse as em

    pot, q0, G = _morse()
    prop = _propagator("HK", pot, q0, G, integrator="exact")
    prop.propagate(pot, 2.0, 7, chunk=3)
    t_rel = prop._morse.carry.t_rel
    assert isinstance(t_rel, torch.Tensor) and t_rel.dtype == torch.float64
    assert float(t_rel) == sum([2.0] * 7)
    pack, carry = em.build_morse_map(prop.state, pot, 2.0)
    assert float(carry.t_rel) == 0.0 and carry.t_rel.shape == ()


# --- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _launches_since(before):
    """Each kernel's launches by label and dtype since `before`, an
    `ops.launch_counts()`."""
    return {k: {t: n - before[k][t] for t, n in by_dtype.items()}
            for k, by_dtype in ops.launch_counts().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name, integrator, micro", [
    ("HK", "rk4", 0), ("WM", "rk4", 0), ("WM", "rk4", 64),
    ("HK", "exact", 0), ("WM", "exact", 0)])
def test_graphs_equal_eager_on_the_card(name, integrator, micro):
    """The separable path (WM through K5) at 256 x 50 in segments of 20:
    graph replays against `graph.eager()` on the same draws, C(t) and
    k~ic(t) within 1e-13 of their largest modulus, the launch counts
    equal, and the graphs replayed."""
    _card()
    pot, q0, G = _morse(d=6, device="cuda")
    runs = []
    for eager in (False, True):
        prop = _propagator(name, pot, q0, G, ntraj=256, device="cuda",
                           integrator=integrator)
        before, stats = ops.launch_counts(), dict(graph.STATS)
        with graph.eager() if eager else contextlib.nullcontext():
            out = prop.propagate(pot, 2.0, 50, chunk=20, micro_batch=micro,
                                 error_bars=True)
        torch.cuda.synchronize()
        runs.append((out, _launches_since(before),
                     graph.STATS["replays"] - stats["replays"]))
    (got, launches, replays), (ref, launches_eager, replays_eager) = runs
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= 1e-13 * np.abs(r).max()
    assert launches == launches_eager
    assert replays > 0 and replays_eager == 0
    if name == "WM":
        assert launches["K5"]["float64"] >= 50


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "comp32"])
def test_diag_monodromy_graphs_equal_eager_on_the_card(precision):
    """HK RK4 on a 60-mode Morse model (the AS model's step) at 1024 x 50
    in segments of 20, with error bars: graph replays against
    `graph.eager()` on the same draws give C(t), k~ic(t), their errors and
    the final monodromy planes bit for bit, and K6 launches once a step in
    both (float64 Z, and float32 under comp32)."""
    _card()
    pot, q0, G = _morse(d=60, device="cuda")

    def k6():
        return sum(ops.launch_counts()["K6"].values())

    runs = []
    for eager in (False, True):
        prop = _propagator("HK", pot, q0, G, ntraj=1024, device="cuda",
                           precision=precision)
        before, stats = k6(), dict(graph.STATS)
        with graph.eager() if eager else contextlib.nullcontext():
            out = prop.propagate(pot, 2.0, 50, chunk=20, error_bars=True)
        torch.cuda.synchronize()
        runs.append((out, prop.state.Z.cpu(), k6() - before,
                     graph.STATS["replays"] - stats["replays"]))
    (got, Z, launches, replays), (ref, Z_ref, launches_eager, _) = runs
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    assert torch.equal(Z, Z_ref)
    assert launches == launches_eager == 50
    assert replays > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name, integrator", [("WM", "rk4"),
                                              ("HK", "exact")])
def test_kept_loop_replays_a_later_batch_on_the_card(name, integrator):
    """A second propagator's batch (another draw, the same potential)
    through the first batch's graphs: no capture and no eager block, and
    C(t), k~ic(t) within 1e-13 of the same batch run eagerly on a fresh
    loop, the launch counts equal (the exact Morse map with the routed
    rows of `_routed` in both batches, so the kept loop fits them)."""
    _card()
    pot, q0, G = _morse(d=6, device="cuda")

    def batch(seed):
        prop = _propagator(name, pot, q0, G, ntraj=256, device="cuda",
                           seed=seed, integrator=integrator)
        if integrator == "exact":
            prop = _routed(prop, pot, (3, 11) if seed == 1 else (5, 20))
        return prop

    def run(prop):
        before, stats = ops.launch_counts(), dict(graph.STATS)
        out = prop.propagate(pot, 2.0, 50, chunk=20, error_bars=True,
                             check_energy=integrator != "exact")
        torch.cuda.synchronize()
        return (out, _launches_since(before),
                {k: graph.STATS[k] - stats[k] for k in stats})

    run(batch(1))
    loop = graph.live("cuda")
    got, launches, stats = run(batch(2))
    assert graph.live("cuda") is loop
    assert stats["captures"] == stats["eager_blocks"] == 0
    assert stats["replays"] > 0
    graph.clear()
    with graph.eager():
        ref, launches_eager, _ = run(batch(2))
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= 1e-13 * np.abs(r).max()
    assert launches == launches_eager


@pytest.mark.cuda
def test_a_capture_that_reads_the_host_raises():
    _card()
    x = torch.ones(4, device="cuda")
    loop = graph.SegmentGraph((), (), "cuda")
    loop.run("b", lambda: (lambda: x.sum().item(), None))   # the warm-up
    with pytest.raises(RuntimeError):
        loop.run("b", lambda: None)
