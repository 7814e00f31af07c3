# coding: utf-8
"""The separable step's observe: the CUDA kernel K8 and its wrapper.

On the separable path (a diagonal monodromy held as four (n, d) planes,
diagonal widths) every per-step quantity of the HK observe is a per-row
reduction over the modes:

* the prefactor C^2 = prod_k z_k, z_k = 1/2 (Mqq ka + Mpp kc) + i/2 (Mpq
  ke / hbar - hbar Mqp kb) with the factor diagonals `diag_k` = (ka, kb,
  kc, ke) (`hk_prefactor_det`'s diagonal branch);
* the sign tracker advanced to C^2 (`SignTracker.update`) and c = sqrt(C^2)
  * sign on the principal branch;
* the weighted overlap exponent of <q, p, Gt | q0, p0, G0> (the diagonal
  weights w1, w2, w3 of `csot0`), fused with the batch's `obs_re`,
  `obs_im` and the action into one exponent, and the NAC factor of the
  current point, whose couplings are constant (n1 = -hbar^2 tau1/m, with
  tau2 = 0): the contributions C_i and k_i = nacQ_i nacq_i C_i of
  `hk_observables_qp`;
* their batch sums and, with error bars, sum |x_i|^2 of each
  (`second_moment`; of each interleaved +- pair's sum under "pairs").

`observe` does all of it (HK); `prefactor` the prefactor and its tracker
alone, writing c (WM, whose observables follow in PyTorch). K8
(`csrc/observe.cu`) does it in one pass over the rows on the card; every
path it does not take, and every path on the CPU, runs the propagators'
PyTorch chain (`propagation.hk.hk_observe`, `hk_prefactor_det` and
`SignTracker`), which the card's tests hold K8 against. Its one change of
method: it multiplies the mode terms of C^2 as complex numbers, scaled by
powers of two (exactly) to stay in range, where the chain sums their logs
and angles (`linalg.logspace_mode_product`; that made a kernel bound by
its FP64 arithmetic on the H100). Every other operation is the chain's,
each multiply and add rounded on its own, the mode sums and the batch
sums in another (fixed) order: the two agree to rounding. K8 is written
in atomic units, hbar = 1 (`units.hbar`): it drops hbar from every
formula, and `check_args` refuses a call under another hbar.
Its per-mode constants are read from the tensors given on every call, the
time loop's parameter buffers: a kept CUDA graph reads the constants of
the batch it replays for. The wrappers take float64 tensors on the card
and raise on what K8 does not take. `layout` is the rule that picks K8's
variant for a call (`layout_of` for the tensors as they lie in memory).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from semiclassical_tpu_torch.ops import _build
from semiclassical_tpu_torch.units import hbar

__all__ = ["HkConsts", "observe", "prefactor", "check_args", "entry_args",
           "layout", "layout_of", "Layout", "MAX_D"]

# warps of a block (csrc/observe.cu kWarps); a lane finishes a row in the
# kernel's second phase, so a warp takes at most 32 rows
_WARPS = 8
# The layout rule's aim: the most rows a warp (8, 16 or 32; more rows a
# warp share a block's constants and its partial, fewer blocks fill the
# card) that still gives this many blocks, about three an SM of the
# H100's 132. Measured there (float64, d = 60, the entry point called
# directly; HK / WM share of the byte bound): at 98,304 rows 8, 16, 32
# rows a warp read 73.9 / 80.1%, 69.9 / 78.4%, 78.3 / 81.1%; at 32,768
# rows 64.6 / 70.1%, 59.5 / 65.7%, 43.2 / 49.4% (128 blocks).
_MIN_BLOCKS = 384
# the most modes K8 takes (csrc/observe.cu kMaxD: its shared memory holds
# the per-mode constants)
MAX_D = 256
# the step's sums K8 writes: C (re, im), k~ic (re, im), sum |C_i|^2,
# sum |k_i|^2
_OUT = 6
# m2_mode -> the kernel's `moments`
_MOMENTS = {False: 0, True: 1, "pairs": 2}


class HkConsts(NamedTuple):
    """The per-mode constants of the HK observe beyond the prefactor's
    factor diagonals, each a tensor the caller holds (the time loop's
    parameter buffers): `diag_w` (3, d) the diagonal weights of csot0,
    `r_diag` and `shift_diag` (d,) the diagonals of the NAC factor's R and
    of the momentum shift, q0 and p0 (d,), `n1` (d,) = -hbar^2 tau1/m of
    the constant first-order coupling tau1 (tau2 = 0); `fac_t` and `fac_i`
    the overlap prefactors of csot0 and csoi0 (0-d complex128 tensors)."""
    diag_w: torch.Tensor
    r_diag: torch.Tensor
    shift_diag: torch.Tensor
    q0: torch.Tensor
    p0: torch.Tensor
    n1: torch.Tensor
    fac_t: torch.Tensor
    fac_i: torch.Tensor


def check_args(Z, previous, signs, diag_k, hk=None):
    """Raise ValueError unless K8 takes the prefactor's arguments Z (4, n,
    d), previous (n,) complex128, signs (n,) and diag_k (4, d), and with
    `hk` = (q, p, S, obs_re, obs_im, nacq, consts, m2_mode) the HK
    observe's: float64 (complex128) tensors on one device, d <= MAX_D,
    every plane with rows of d contiguous numbers, the per-row vectors and
    the constants contiguous, the overlap prefactors 0-d complex128
    tensors, and an even n under "pairs"; and hbar = 1, the units K8 is
    written in."""
    name = "observe"
    if hbar != 1.0:
        raise ValueError(f"{name} is written for hbar = 1, got {hbar}")
    if Z.dim() != 3 or Z.shape[0] != 4:
        raise ValueError(f"{name} takes Z as (4, n, d), got shape "
                         f"{tuple(Z.shape)}")
    _, n, d = Z.shape
    if d > MAX_D:
        raise ValueError(f"{name} takes d <= {MAX_D} modes, got {d}")
    planes = [Z]
    vectors = [(previous, torch.complex128, (n,)), (signs, None, (n,)),
               (diag_k, None, (4, d))]
    if hk is not None:
        q, p, S, obs_re, obs_im, nacq, consts, m2_mode = hk
        planes += [q, p]
        for x in (q, p):
            if x.shape != (n, d):
                raise ValueError(f"{name} takes q and p ({n}, {d}), got "
                                 f"{tuple(x.shape)}")
        vectors += [(S, None, (n,)), (obs_re, None, (n,)),
                    (obs_im, None, (n,)), (nacq, torch.complex128, (n,)),
                    (consts.diag_w, None, (3, d))]
        vectors += [(x, None, (d,)) for x in consts[1:6]]
        vectors += [(x, torch.complex128, ()) for x in consts[6:]]
        if m2_mode not in _MOMENTS:
            raise ValueError(f"{name} takes m2_mode False, True or 'pairs', "
                             f"got {m2_mode!r}")
        if m2_mode == "pairs" and n % 2:
            raise ValueError(f"{name} takes an even n under 'pairs', got {n}")
    for x, dtype, shape in vectors:
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{name} takes tensors, got {type(x).__name__}")
        if x.shape != shape:
            raise ValueError(f"{name} takes a {shape} tensor here, got "
                             f"{tuple(x.shape)}")
        if x.dtype != (dtype or torch.float64):
            raise ValueError(f"{name} takes {dtype or torch.float64}, got "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} takes the per-row vectors and the "
                             f"constants contiguous, got strides "
                             f"{x.stride()}")
    for x in planes:
        if x.dtype != torch.float64:
            raise ValueError(f"{name} takes float64 planes, got {x.dtype}")
        if d > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name} takes planes with rows of d contiguous "
                             f"numbers, got strides {x.stride()}")
    for x in (*planes, *(v[0] for v in vectors)):
        if x.device != Z.device:
            raise ValueError(f"{name} takes tensors on one device, got "
                             f"{x.device} and {Z.device}")


class Layout(NamedTuple):
    """How K8 runs a call: `variant` "vector" (a lane reads `vec` = 2
    consecutive modes of a row as one access) or "scalar" (`vec` 1: odd d,
    or a plane off a pair's boundary); `blocks` blocks of 8 warps, each
    warp taking `rows_per_warp` rows."""
    variant: str
    vec: int
    rows_per_warp: int
    blocks: int


@functools.lru_cache(maxsize=64)
def layout(n: int, d: int, aligned: bool) -> Layout:
    """The layout rule of K8 for n rows of d float64 modes; `aligned`:
    every plane starts, and every row of it, on a pair's boundary. The
    vector variant needs d even too. A warp takes 8, 16 or 32 rows: the
    most that still make `_MIN_BLOCKS` blocks (8 below that). Cached: a
    run asks for the same call every step."""
    if n < 0 or not 1 <= d <= MAX_D:
        raise ValueError(f"K8 takes n >= 0 rows of 1 <= d <= {MAX_D} modes, "
                         f"got ({n}, {d})")
    vec = 2 if aligned and d % 2 == 0 else 1
    rows_per_warp = 8
    while rows_per_warp < 32 and 2 * rows_per_warp * _WARPS * _MIN_BLOCKS <= n:
        rows_per_warp *= 2
    return Layout("vector" if vec > 1 else "scalar", vec, rows_per_warp,
                  max(1, _build.ceil_div(n, rows_per_warp * _WARPS)))


def layout_of(Z, q=None, p=None) -> Layout:
    """K8's layout for the planes as they lie in memory (q and p too in
    HK mode); the per-mode constants are copied number by number into the
    kernel's shared memory, where their rows lie d apart."""
    _, n, d = Z.shape
    aligned = all(x.data_ptr() % 16 == 0 and x.stride(-2) % 2 == 0
                  for x in (Z, q, p) if x is not None)
    return layout(n, d, aligned and Z.stride(0) % 2 == 0)


# device index -> the blocks' ticket counter of K8's last-block sum (one
# int32, 0 between launches: the last block resets it)
_COUNTERS = {}


def _counter(device):
    """The blocks' ticket counter of HK-mode launches on `device`, made at
    the first one. One a device, shared by every stream: it assumes that
    no two HK-mode launches on a device are in flight at once, as in the
    time loop, which launches them one after another on one stream. Two
    launches on concurrent streams would interleave their tickets, and
    the wrong block would sum the partials: such a caller needs a counter
    a stream."""
    counter = _COUNTERS.get(device.index)
    if counter is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K8's first launch on a device must run "
                               "outside a CUDA graph capture (it allocates "
                               "the blocks' counter)")
        counter = _COUNTERS[device.index] = torch.zeros(
            1, dtype=torch.int32, device=device)
    return counter


def _ptr(x, complex_=False):
    if x is None:
        return 0
    return (torch.view_as_real(x) if complex_ else x).data_ptr()


def entry_args(Z, previous, signs, diag_k, hk=None):
    """(the arguments of K8's entry point but the stream, the outputs) of
    one launch on arguments `check_args` takes, the outputs and the
    blocks' partials allocated here: (C^2, signs, c) in WM mode (`hk`
    None), (C^2, signs, the six sums) in HK mode; the partials last, to be
    held while the arguments are used."""
    _, n, d = Z.shape
    new = functools.partial(torch.empty, device=Z.device)
    prev_out, signs_out = torch.empty_like(previous), torch.empty_like(signs)
    if hk is None:
        q = p = S = obs_re = obs_im = nacq = None
        consts, moments = HkConsts(*(None,) * 8), 0
        last, partial, counter = torch.empty_like(previous), None, None
        lay = layout_of(Z)
    else:
        q, p, S, obs_re, obs_im, nacq, consts, m2_mode = hk
        moments = _MOMENTS[m2_mode]
        lay = layout_of(Z, q, p)
        # the last block writes every sum; no block runs on no rows
        last = (new if n else torch.zeros)(_OUT, dtype=torch.float64,
                                           device=Z.device)
        partial = new(lay.blocks, _OUT, dtype=torch.float64)
        counter = _counter(Z.device) if n else None
    args = (_ptr(q), _ptr(p), Z.data_ptr(), _ptr(S), _ptr(obs_re),
            _ptr(obs_im), _ptr(nacq, True), _ptr(previous, True),
            signs.data_ptr(), diag_k.data_ptr(),
            *(_ptr(x) for x in consts[:6]),
            *(_ptr(x, True) for x in consts[6:]), _ptr(prev_out, True),
            signs_out.data_ptr(), _ptr(None if hk else last, True),
            _ptr(partial), _ptr(counter), _ptr(last if hk else None), n, d,
            0 if q is None else q.stride(0), 0 if p is None else p.stride(0),
            Z.stride(0), Z.stride(1), int(hk is not None), moments, lay.vec,
            lay.rows_per_warp, lay.blocks)
    return args, (prev_out, signs_out, last, partial)


def _launch(Z, previous, signs, diag_k, hk=None):
    """One K8 launch: (C^2, signs, c) in WM mode (`hk` None), (C^2, signs,
    the six sums) in HK mode."""
    args, outputs = entry_args(Z, previous, signs, diag_k, hk)
    if Z.shape[1]:
        _build.launch("observe", torch.float64, Z.device, *args)
    return outputs[:3]


def _on_card(*tensors):
    if _build.route("observe", *tensors) != "cuda":
        raise ValueError("observe runs K8, on tensors on the card; the CPU "
                         "runs the propagators' PyTorch chain")


def prefactor(Z, previous, signs, diag_k):
    """(C^2, the new signs, c) of the separable prefactor and its tracker:
    `hk_prefactor_det`'s diagonal branch, `SignTracker.update` and
    `.sqrt()`, in one K8 launch on the card (raises on what it does not
    take)."""
    _on_card(Z, previous, signs, diag_k)
    check_args(Z, previous, signs, diag_k)
    return _launch(Z, previous, signs, diag_k)


def observe(q, p, Z, S, obs_re, obs_im, nacq, previous, signs, diag_k,
            consts: HkConsts, m2_mode=False):
    """(C^2, the new signs, sum C_i, sum k_i, sum |C_i|^2, sum |k_i|^2) of
    the HK step's observe, `propagation.hk.hk_observe` on the separable
    path with a constant coupling, in one K8 launch on the card (raises on
    what it does not take): the sums as 0-d tensors, the moments None
    unless `m2_mode`."""
    _on_card(*(x for x in (q, p, Z, S, obs_re, obs_im, nacq, previous,
                           signs, diag_k, *consts)
               if isinstance(x, torch.Tensor)))
    hk = (q, p, S, obs_re, obs_im, nacq, consts, m2_mode)
    check_args(Z, previous, signs, diag_k, hk)
    z, signs, out = _launch(Z, previous, signs, diag_k, hk)
    sums = torch.view_as_complex(out[:4].view(2, 2))
    moments = (out[4], out[5]) if m2_mode else (None, None)
    return z, signs, sums[0], sums[1], *moments
