# coding: utf-8
"""The RK4 step of the diagonal monodromy: the CUDA kernel K6, its plain
version and its wrapper.

On a separable potential the monodromy of each trajectory is held as four
(n, d) planes Z = [Mqq, Mqp, Mpq, Mpp] (the diagonal representation), and
one RK4 step under the four stage Hessian diagonals h1..h4 is, per
(trajectory, mode), the 2x2 row map of the stage recurrence run on the
seeds (1, 0) and (0, 1), applied to the (q-row, p-row) pairs (Mqq, Mpq)
and (Mqp, Mpp). The step reads only the Hessian diagonals, so it is the
same for every separable potential (Morse, NonHarmonic, the harmonic
Morse model, the frozen diagonal H of the "step" and "taylor" modes).

The plain version runs the recurrence in PyTorch on both seeds at once (a
leading axis of 2); the CPU path and the tests use it. K6
(`csrc/diag_mono.cu`) runs the same operations in the same order in one
pass over the planes, each multiply and add rounded on its own, so on the
card the two agree bit for bit. The wrapper launches K6 for tensors on the
card (float64 on the main path, float32 in the reduced-precision modes)
and raises on what it does not take; it runs the plain version only for
tensors on the CPU. `layout` is the rule that picks K6's variant for a
call (`layout_of` for the tensors as they lie in memory).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from semiclassical_tpu_torch.ops.det import dtype_name

__all__ = ["diag_mono_step", "diag_mono_step_plain", "check_args", "layout",
           "layout_of", "Layout", "LAUNCHES", "LAUNCHES_BY_DTYPE"]

# threads of a block (csrc/diag_mono.cu kThreads)
_THREADS = 256
# bytes of one vector access of the kernel
_VEC_BYTES = 16

# kernel launches made by the wrapper (one per launch), and the same
# launches by Z's dtype name
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float64": 0, "float32": 0}


@functools.lru_cache(maxsize=None)
def _seeds(dtype, device):
    """The seeds (1, 0) and (0, 1) of the plain version, each (2, 1, 1),
    made once per dtype and device (by the first step, which the time loop
    runs eagerly): a step makes no tensor from host values, so a captured
    step holds no host-to-device copy."""
    eye = torch.eye(2, dtype=dtype, device=device)
    return eye[:, 0].view(2, 1, 1), eye[:, 1].view(2, 1, 1)


def diag_mono_step_plain(Z, inv_m, hs, weights):
    """K6's function in plain PyTorch: the new (4, n, d) planes of Z (4, n,
    d) after one RK4 step under the stage Hessian diagonals `hs` (four (n,
    d) tensors), with 1/m `inv_m` (d,) and `weights` = (dt/6, dt/3, dt/2,
    dt) rounded at Z's dtype. Everything runs at Z's dtype."""
    u = inv_m[None, None, :]
    h6, h3, h2, dt = weights
    a, b = _seeds(Z.dtype, Z.device)
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
    raa, rab = acc_a + h6 * ka                  # each (n, d)
    rba, rbb = acc_b + h6 * kb
    top, bottom = Z[:2], Z[2:]                  # [Mqq, Mqp], [Mpq, Mpp]
    return torch.cat([raa * top + rab * bottom, rba * top + rbb * bottom])


def _row_stride(x):
    """d where element (r, j) of the (n, d) tensor x lies r d + j numbers
    past its start (rows of d contiguous numbers, one after another), 0
    where every row is the same row of d contiguous numbers (a broadcast),
    None for any other layout. An empty x has every layout."""
    n, d = x.shape
    if x.numel() == 0:
        return d
    if d > 1 and x.stride(1) != 1:
        return None
    if n == 1 or x.stride(0) == d:
        return d
    return 0 if x.stride(0) == 0 else None


def check_args(Z, inv_m, hs):
    """Raise ValueError unless K6 takes Z (4, n, d), inv_m (d,) and the four
    (n, d) stage diagonals `hs`: one float type (float64 or float32), one
    device; each plane of Z and each of `hs` rows of d contiguous numbers
    one after another (Z's planes may lie apart, a stage diagonal may be
    one row broadcast over the batch); inv_m contiguous."""
    name = "diag_mono_step"
    dtype = Z.dtype
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"{name} takes float64 or float32, got {dtype}")
    if Z.dim() != 3 or Z.shape[0] != 4:
        raise ValueError(f"{name} takes Z as (4, n, d), got shape "
                         f"{tuple(Z.shape)}")
    if len(hs) != 4:
        raise ValueError(f"{name} takes four stage diagonals, got {len(hs)}")
    _, n, d = Z.shape
    for x in (inv_m, *hs):
        if x.dtype != dtype:
            raise ValueError(f"{name} takes tensors of one type, got "
                             f"{x.dtype} and {dtype}")
        if x.device != Z.device:
            raise ValueError(f"{name} takes tensors on one device, got "
                             f"{x.device} and {Z.device}")
    if inv_m.shape != (d,) or any(h.shape != (n, d) for h in hs):
        raise ValueError(f"{name} takes inv_m ({d},) and four ({n}, {d}) "
                         f"stage diagonals, got {tuple(inv_m.shape)} and "
                         f"{[tuple(h.shape) for h in hs]}")
    if d > 1 and inv_m.stride(0) != 1:
        raise ValueError(f"{name} takes a contiguous inv_m")
    if _row_stride(Z[0]) != d or any(_row_stride(h) is None for h in hs):
        raise ValueError(f"{name} takes planes of contiguous rows, one after "
                         f"another (a stage diagonal may be one row "
                         f"broadcast), got strides {Z.stride()} and "
                         f"{[h.stride() for h in hs]}")


class Layout(NamedTuple):
    """How K6 runs a call: `variant` "vector" (each thread reads `vec`
    consecutive elements of a plane as one 16-byte access: 2 in float64, 4
    in float32) or "scalar" (`vec` 1: a plane that does not start on a
    16-byte boundary); `blocks` blocks of 256 threads cover the n d
    elements."""
    variant: str
    vec: int
    blocks: int


@functools.lru_cache(maxsize=64)
def layout(total: int, dtype: torch.dtype, aligned: bool) -> Layout:
    """The layout rule of K6 for `total` = n d elements of `dtype`
    (float64 or float32); `aligned`: every plane read or written as
    vectors starts on a 16-byte boundary. Cached: a run asks for the same
    call every step."""
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"K6 takes float64 or float32, got {dtype}")
    if total < 0:
        raise ValueError(f"K6 takes n d >= 0 elements, got {total}")
    vec = 8 * _VEC_BYTES // torch.finfo(dtype).bits if aligned else 1
    threads = -(-total // vec)
    return Layout("vector" if vec > 1 else "scalar", vec,
                  -(-threads // _THREADS))


def _broadcast_mask(hs):
    """Bit s set where stage diagonal s is one row broadcast over more
    than one row."""
    return sum(1 << s for s, h in enumerate(hs) if _row_stride(h) == 0)


def layout_of(Z, hs) -> Layout:
    """K6's layout for Z and the stage diagonals as they lie in memory: the
    vector variant only when Z's four planes, the new planes (allocated
    contiguous: n d elements apart) and every stage diagonal not
    broadcast start on a 16-byte boundary."""
    _, n, d = Z.shape
    size = Z.element_size()
    bcast = _broadcast_mask(hs)
    aligned = not (Z.data_ptr() % _VEC_BYTES
                   or Z.stride(0) * size % _VEC_BYTES
                   or n * d * size % _VEC_BYTES
                   or any(h.data_ptr() % _VEC_BYTES
                          for s, h in enumerate(hs) if not bcast >> s & 1))
    return layout(n * d, Z.dtype, aligned)


def _launch(Z, inv_m, hs, weights):
    from semiclassical_tpu_torch.ops import _build

    global LAUNCHES
    _, n, d = Z.shape
    out = torch.empty((4, n, d), dtype=Z.dtype, device=Z.device)
    if n * d == 0:
        return out
    lay = layout_of(Z, hs)
    err = _build.launch(
        _build.entry("diag_mono", Z.dtype), Z.device, Z.data_ptr(),
        Z.stride(0), *(h.data_ptr() for h in hs), _broadcast_mask(hs),
        inv_m.data_ptr(), out.data_ptr(), n * d, d, *weights, lay.vec,
        lay.blocks)
    if err != 0:
        raise RuntimeError(f"diag_mono kernel launch failed: CUDA error "
                           f"{err} (n = {n}, d = {d}, {Z.dtype})")
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[dtype_name(Z.dtype)] += 1
    return out


def diag_mono_step(Z, inv_m, hs, weights):
    """The new (4, n, d) planes of the diagonal monodromy Z after one RK4
    step (`diag_mono_step_plain` says what is computed).

    Tensors on the card go to K6 (or raise if it does not take them);
    tensors on the CPU go to the plain version."""
    hs = tuple(hs)
    kinds = {x.device.type for x in (Z, inv_m, *hs)}
    if kinds == {"cpu"}:
        return diag_mono_step_plain(Z, inv_m, hs, weights)
    if kinds != {"cuda"}:
        raise ValueError("diag_mono_step runs on cuda or cpu tensors (all "
                         f"on one), got {sorted(kinds)}")
    check_args(Z, inv_m, hs)
    return _launch(Z, inv_m, hs, weights)
