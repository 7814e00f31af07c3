# coding: utf-8
"""The RK4 trajectory step of a separable Morse PES: the CUDA kernel K7,
its plain version and its wrapper.

One RK4 step of (q, p, S) under `MorsePotential` (non-harmonic,
hessian_eval "stage") evaluates the PES at four stages; each stage is, per
(trajectory, mode), ex = exp(-a q_s), the gradient 2 a D ex (1 - ex) and
the Hessian diagonal 2 a^2 D ex (2 ex - 1), and per trajectory the sums
V_s = sum D (1 - ex)^2 and T_s = 1/2 sum p_s^2 / m. The step writes the
new q, p and S = S + dt/6 (k1 + 2 (k2 + k3) + k4) of the stage
derivatives, the stage-1 energy e1 = T_1 + V_1, and the four stage
Hessian diagonals h1..h4 as one (4, n, d) tensor, which the diagonal
monodromy's step (K6, `ops.diag_mono`) reads next.

The plain version is `eom.rk4_step`'s PyTorch stages for this potential,
the same expressions in the same order; the CPU path and the tests use it.
K7 (`csrc/morse_rk4.cu`) runs the same operations in one pass, each
multiply and add rounded on its own and exp the CUDA math library's, so
on the card q, p and h1..h4 agree with the plain version bit for bit, S
and e1 up to the order of the mode sums. The per-mode constants -a, D,
2 a D, 2 a^2 D and 1/m come as one (5, d) pack (`pack_of`), made once per
potential by the expressions `MorsePotential.local_expansion` uses. The
wrapper launches K7 for tensors on the card (float64 on the main path,
float32 in the "f32" mode) and raises on what it does not take; it runs
the plain version only for tensors on the CPU. `layout` is the rule that
picks K7's variant for a call (`layout_of` for the tensors as they lie in
memory).
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import torch

from semiclassical_tpu_torch.ops.det import dtype_name
from semiclassical_tpu_torch.ops.diag_mono import _row_stride

__all__ = ["morse_rk4_step", "morse_rk4_step_plain", "pack_of", "check_args",
           "layout", "layout_of", "Layout", "LAUNCHES", "LAUNCHES_BY_DTYPE"]

# threads of a block and lanes of a warp (csrc/morse_rk4.cu kThreads,
# kWarp); a warp takes a row
_THREADS = 256
_WARP = 32
# the pack's rows
PACK_ROWS = 5

# kernel launches made by the wrapper (one per launch), and the same
# launches by q's dtype name
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float64": 0, "float32": 0}

# id(potential) -> (weak reference to it, its pack)
_PACKS = {}


def _make_pack(potential):
    a, D = potential.a[None, :], potential.D[None, :]
    inv_m = 1.0 / potential.masses()
    return torch.cat([-a, D, 2 * a * D, 2 * a**2 * D, inv_m[None, :]])


def pack_of(potential):
    """The (5, d) pack [-a, D, 2 a D, 2 a^2 D, 1/m] of a `MorsePotential`
    at its parameters' dtype, each row formed by the expression
    `local_expansion` and `eom.rk4_step` form it. Made once per potential
    object (by the first step, which the time loop runs eagerly) and kept
    while the potential lives; a pack made while a CUDA graph is being
    captured is not kept (its values exist only when the graph replays)."""
    key = id(potential)
    hit = _PACKS.get(key)
    if hit is not None and hit[0]() is potential:
        return hit[1]
    pack = _make_pack(potential)
    if not (pack.is_cuda and torch.cuda.is_current_stream_capturing()):
        ref = weakref.ref(potential, lambda _, key=key: _PACKS.pop(key, None))
        _PACKS[key] = (ref, pack)
    return pack


def morse_rk4_step_plain(q, p, S, pack, weights):
    """K7's function in plain PyTorch: (new q, new p, new S, e1, h) after
    one RK4 step of q, p (n, d) and S (n,) under the Morse pack (5, d),
    with `weights` = (dt/2, dt, dt/6) rounded at q's dtype; h (4, n, d)
    holds the stage Hessian diagonals h1..h4. Everything runs at q's
    dtype, in the order of `eom.rk4_step`'s stages."""
    half, full, sixth = weights
    na, D, cg, ch, u = (x[None, :] for x in pack)

    def stage(qs, ps):
        ex = torch.exp(na * qs)
        vpot = torch.sum(D * (1.0 - ex) ** 2, dim=1)
        grad = cg * ex * (1.0 - ex)
        hdiag = ch * ex * (2 * ex - 1.0)
        tkin = 0.5 * torch.sum(ps**2 * u, dim=1)
        return (ps * u, -grad, tkin - vpot), tkin + vpot, hdiag

    k1, e1, h1 = stage(q, p)
    k2, _, h2 = stage(q + half * k1[0], p + half * k1[1])
    k3, _, h3 = stage(q + half * k2[0], p + half * k2[1])
    k4, _, h4 = stage(q + full * k3[0], p + full * k3[1])
    new = [y + sixth * (k1[i] + 2.0 * (k2[i] + k3[i]) + k4[i])
           for i, y in enumerate((q, p, S))]
    return (*new, e1, torch.stack([h1, h2, h3, h4]))


def check_args(q, p, S, pack):
    """Raise ValueError unless K7 takes q, p (n, d), S (n,) and the pack
    (5, d): one float type (float64 or float32), one device; q and p rows
    of d contiguous numbers one after another, S and the pack
    contiguous."""
    name = "morse_rk4_step"
    dtype = q.dtype
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"{name} takes float64 or float32, got {dtype}")
    if q.dim() != 2:
        raise ValueError(f"{name} takes q as (n, d), got shape "
                         f"{tuple(q.shape)}")
    n, d = q.shape
    if p.shape != (n, d) or S.shape != (n,) or pack.shape != (PACK_ROWS, d):
        raise ValueError(f"{name} takes p ({n}, {d}), S ({n},) and the pack "
                         f"({PACK_ROWS}, {d}), got {tuple(p.shape)}, "
                         f"{tuple(S.shape)} and {tuple(pack.shape)}")
    for x in (p, S, pack):
        if x.dtype != dtype:
            raise ValueError(f"{name} takes tensors of one type, got "
                             f"{x.dtype} and {dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} takes tensors on one device, got "
                             f"{x.device} and {q.device}")
    if not (_row_stride(q) == d and _row_stride(p) == d
            and (n <= 1 or S.stride(0) == 1) and pack.is_contiguous()):
        raise ValueError(f"{name} takes q and p as contiguous rows one after "
                         f"another, S and the pack contiguous, got strides "
                         f"{q.stride()}, {p.stride()}, {S.stride()} and "
                         f"{pack.stride()}")


class Layout(NamedTuple):
    """How K7 runs a call: `variant` "vector" (a lane reads `vec` = 2
    consecutive modes of a row as one access) or "scalar" (`vec` 1: odd d,
    or q or p off a pair's boundary); `blocks` blocks of 256 threads (8
    warps, a row each) cover the n rows."""
    variant: str
    vec: int
    blocks: int


@functools.lru_cache(maxsize=64)
def layout(n: int, d: int, dtype: torch.dtype, aligned: bool) -> Layout:
    """The layout rule of K7 for n rows of d modes of `dtype` (float64 or
    float32); `aligned`: q and p start on a pair's boundary. The vector
    variant needs d even too. Cached: a run asks for the same call every
    step."""
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"K7 takes float64 or float32, got {dtype}")
    if n < 0 or d < 1:
        raise ValueError(f"K7 takes n >= 0 rows of d >= 1 modes, got "
                         f"({n}, {d})")
    vec = 2 if aligned and d % 2 == 0 else 1
    return Layout("vector" if vec > 1 else "scalar", vec,
                  -(-n // (_THREADS // _WARP)))


def layout_of(q, p) -> Layout:
    """K7's layout for q and p as they lie in memory (the outputs and the
    pack are allocated contiguous, so their pairs are aligned where d is
    even)."""
    n, d = q.shape
    pair = 2 * q.element_size()
    aligned = not (q.data_ptr() % pair or p.data_ptr() % pair)
    return layout(n, d, q.dtype, aligned)


def _launch(q, p, S, pack, weights):
    from semiclassical_tpu_torch.ops import _build

    global LAUNCHES
    n, d = q.shape
    new = functools.partial(torch.empty, dtype=q.dtype, device=q.device)
    new_q, new_p, new_S, e1, h = (new(n, d), new(n, d), new(n), new(n),
                                  new(4, n, d))
    if n == 0:
        return new_q, new_p, new_S, e1, h
    lay = layout_of(q, p)
    err = _build.launch(
        _build.entry("morse_rk4", q.dtype), q.device, q.data_ptr(),
        p.data_ptr(), S.data_ptr(), pack.data_ptr(), new_q.data_ptr(),
        new_p.data_ptr(), new_S.data_ptr(), e1.data_ptr(), h.data_ptr(), n,
        d, *weights, lay.vec, lay.blocks)
    if err != 0:
        raise RuntimeError(f"morse_rk4 kernel launch failed: CUDA error "
                           f"{err} (n = {n}, d = {d}, {q.dtype})")
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[dtype_name(q.dtype)] += 1
    return new_q, new_p, new_S, e1, h


def morse_rk4_step(q, p, S, pack, weights):
    """(new q, new p, new S, e1, h) after one RK4 step of a separable Morse
    PES (`morse_rk4_step_plain` says what is computed).

    Tensors on the card go to K7 (or raise if it does not take them);
    tensors on the CPU go to the plain version."""
    kinds = {x.device.type for x in (q, p, S, pack)}
    if kinds == {"cpu"}:
        return morse_rk4_step_plain(q, p, S, pack, weights)
    if kinds != {"cuda"}:
        raise ValueError("morse_rk4_step runs on cuda or cpu tensors (all "
                         f"on one), got {sorted(kinds)}")
    check_args(q, p, S, pack)
    return _launch(q, p, S, pack, weights)
