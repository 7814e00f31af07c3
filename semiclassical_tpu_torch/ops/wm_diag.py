# coding: utf-8
"""The fused separable WM chain: the CUDA kernel K5, its plain version and
its wrapper.

K5 replaces `semiclassical_tpu/ops/wm_kernel.py::pallas_wm_diag_derived`.
On the separable WM path (all widths diagonal at full rank) the A- and
M-matrices of every trajectory decouple into per-mode 2x2 complex systems,
and every time-dependent observable of a step is a sum over modes. From
ten (n, d) real planes — the diagonal monodromy blocks Mqq, Mqp, Mpq, Mpp,
the displacements dQ = q0 - q(t), dp = p(t) - p0, dq = q0 - q(0), the NAC
vectors n1q, n1Q and v0c = [Gi+G0]^{-1} (p0 - pi) — and the (17, d) pack of
per-mode constants (`build_const_pack`), it computes per trajectory:

* the 2x2 A/M algebra of `wm._wm_diag_core` per mode: the balanced,
  transposed A-blocks, det_i = det At, y = At^{-1} P, M' and its
  reciprocal, with the conj/|z|^2 reciprocals;
* the 13 complex Gram sums  sum_mode s_k s_l / M'  over `GRAM_PAIRS` of the
  five observable vectors s_0..s_4, and 4 real sums g_DD, g_Dn, p0_dQ,
  p0_n: `scal`, (n, 30) — columns 2i, 2i+1 the (re, im) of GRAM_PAIRS[i],
  then the four real sums (`scal_col`);
* the per-mode planes [det_i re, det_i im, M'/m_scale re, M'/m_scale im]:
  `det_planes`, (4, n, d). Their log-space products over modes (detA,
  detM) stay outside, in `linalg.logspace_mode_product`.

The plain version is the same chain in PyTorch, in the same operation
order, on complex tensors; the CPU path and the tests use it. The wrapper
launches the kernel for tensors on the card (float64 on the main path, or
float32) and raises on anything it does not take; it uses the plain
version only for tensors on the CPU. hbar = 1 (atomic units) is assumed
by the kernel, as by the TPU kernel, and asserted here.

How the kernel is laid out for Hopper is described at the top of
`csrc/wm_diag.cu`.
"""

from __future__ import annotations

import torch

from semiclassical_tpu_torch.units import hbar

__all__ = ["wm_diag_derived", "wm_diag_derived_plain", "wm_diag_core_plain",
           "build_const_pack", "scal_col", "check_args", "CONSTS",
           "GRAM_PAIRS", "N_SCAL", "MAX_D", "LAUNCHES"]

# rows of the per-mode constant pack (csrc/wm_diag.cu reads them in this
# order)
CONSTS = ("u1", "u2", "gt", "cb11", "cb12_im", "cb22",
          "c2_11", "c2_12_im", "c2_22", "m0", "inv_m_scale",
          "fq1", "fq2_im", "bq1", "bq2_im", "g0", "p0")
# the Gram entries s_k^T iM s_l the observables need
GRAM_PAIRS = ((0, 0), (0, 1), (0, 2), (0, 3), (0, 4),
              (1, 2), (1, 3), (1, 4),
              (2, 2), (2, 3), (2, 4),
              (3, 4), (4, 4))
_EXTRA = ("g_DD", "g_Dn", "p0_dQ", "p0_n")
N_SCAL = 2 * len(GRAM_PAIRS) + len(_EXTRA)  # 30
MAX_D = 256

# kernel launches made by the wrapper (one per launch)
LAUNCHES = 0


def scal_col(name: str) -> int:
    """Column of a named real sum in `scal`."""
    return 2 * len(GRAM_PAIRS) + _EXTRA.index(name)


def build_const_pack(dg, p0, m_scale):
    """(17, d) row stack of the per-mode constants: the fields of
    `wm.WMDiagConsts`, the reciprocal detM scale and the wavepacket
    momentum center p0, in `CONSTS` order."""
    rows = {name: getattr(dg, name) for name in CONSTS
            if name not in ("inv_m_scale", "p0")}
    rows["inv_m_scale"] = torch.full_like(p0, 1.0 / m_scale)
    rows["p0"] = p0
    return torch.stack([rows[name] for name in CONSTS]).contiguous()


def _mul_i(x):
    """i * x for a complex tensor."""
    return torch.complex(-x.imag, x.real)


def wm_diag_core_plain(Mqq, Mqp, Mpq, Mpp, pack):
    """The per-mode 2x2 A/M algebra (`wm._wm_diag_core`): returns (det_i,
    Mps, y1, y2, iM), complex (n, d) each, with det_i = det At, Mps =
    M' / m_scale and iM = 1 / M'."""
    c = dict(zip(CONSTS, pack[:, None, :]))       # (1, d) rows
    ih = 1.0 / hbar
    X1 = Mqq * c["u1"]
    X2 = Mqp * c["u2"]
    Z1 = Mpq * c["u1"]
    Z2 = Mpp * c["u2"]
    gt = c["gt"]

    # balanced transposed-A blocks, per mode (real planes)
    G11, G12, G22 = gt * X1 * X1, gt * X1 * X2, gt * X2 * X2
    B11, B12 = X1 * Z1, X1 * Z2
    B21, B22 = X2 * Z1, X2 * Z2
    TR1, TR2 = Z1 * X2, Z2 * X2
    At11 = torch.complex(c["cb11"] + G11, B11 * ih)
    At12 = torch.complex(G12, c["cb12_im"] + (2.0 * B12 - TR1) * ih)
    At21 = torch.complex(G12, B21 * ih)
    At22 = torch.complex(c["cb22"] + G22, (2.0 * B22 - TR2) * ih)
    P1 = torch.complex(gt * X1, Z1 * ih)
    P2 = torch.complex(gt * X2, Z2 * ih)

    det_i = At11 * At22 - At12 * At21
    # closed-form 2x2 solve; the balanced dets are O(1), so the plain
    # conj/|z|^2 reciprocal is safe
    inv_det = det_i.conj() * (1.0 / (det_i.real**2 + det_i.imag**2))
    y1 = (At22 * P1 - At12 * P2) * inv_det
    y2 = (At11 * P2 - At21 * P1) * inv_det

    # M' = M0 - Y^T (P + C2b Y), scalar per mode
    c2y1 = c["c2_11"] * y1 + c["c2_12_im"] * _mul_i(y2)
    c2y2 = c["c2_12_im"] * _mul_i(y1) + c["c2_22"] * y2
    Mp = c["m0"] - (y1 * (P1 + c2y1) + y2 * (P2 + c2y2))
    Mps = Mp * c["inv_m_scale"]
    iM = Mp.conj() * (1.0 / (Mp.real**2 + Mp.imag**2))
    return det_i, Mps, y1, y2, iM


def wm_diag_derived_plain(Mqq, Mqp, Mpq, Mpp, dQ, dp, dq, n1q, n1Q, v0c,
                          pack):
    """K5's function in plain PyTorch: (scal (n, 30), det_planes
    (4, n, d)) at the dtype of the inputs."""
    det_i, Mps, y1, y2, iM = wm_diag_core_plain(Mqq, Mqp, Mpq, Mpp, pack)
    c = dict(zip(CONSTS, pack[:, None, :]))
    yf = c["fq1"] * y1 + c["fq2_im"] * _mul_i(y2)
    yb = c["bq1"] * y1 + c["bq2_im"] * _mul_i(y2)
    g0 = c["g0"]
    sv = (yf * dq, yf * n1q, g0 * dQ, g0 * n1Q, dp + yb * v0c)
    wv = tuple(s * iM for s in sv)
    gram = [torch.sum(sv[k] * wv[l], dim=1) for k, l in GRAM_PAIRS]
    cols = [part for g in gram for part in (g.real, g.imag)]
    cols += [torch.sum(dQ * g0 * dQ, dim=1), torch.sum(dQ * g0 * n1Q, dim=1),
             torch.sum(c["p0"] * dQ, dim=1), torch.sum(c["p0"] * n1Q, dim=1)]
    scal = torch.stack(cols, dim=1)
    det_planes = torch.stack([det_i.real, det_i.imag, Mps.real, Mps.imag])
    return scal, det_planes


def check_args(planes, pack):
    """Raise ValueError unless K5 takes the ten (n, d) planes and the
    (17, d) pack: one float type (float64 or float32), 1 <= d <= MAX_D,
    contiguous, on one device."""
    name = "wm_diag_derived"
    dtype = pack.dtype
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"{name} takes float64 or float32, got {dtype}")
    if pack.dim() != 2 or pack.shape[0] != len(CONSTS):
        raise ValueError(f"{name} takes a ({len(CONSTS)}, d) constant pack, "
                         f"got shape {tuple(pack.shape)}")
    d = pack.shape[1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{name}'s kernel takes 1 <= d <= {MAX_D}, got "
                         f"d = {d}")
    shape = planes[0].shape
    for x in (*planes, pack):
        if x.dtype != dtype:
            raise ValueError(f"{name} takes tensors of one type, got "
                             f"{x.dtype} and {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if x.device != pack.device:
            raise ValueError(f"{name} takes tensors on one device, got "
                             f"{x.device} and {pack.device}")
    if len(shape) != 2 or shape[1] != d or any(x.shape != shape
                                               for x in planes):
        raise ValueError(f"{name} takes ten (n, {d}) planes, got shapes "
                         f"{[tuple(x.shape) for x in planes]}")


def _launch(planes, pack):
    from semiclassical_tpu_torch.ops import _build

    global LAUNCHES
    n, d = planes[0].shape
    scal = torch.empty((n, N_SCAL), dtype=pack.dtype, device=pack.device)
    det_planes = torch.empty((4, n, d), dtype=pack.dtype, device=pack.device)
    if n == 0:
        return scal, det_planes
    err = _build.launch(
        _build.entry("wm_diag", pack.dtype), pack.device,
        *(x.data_ptr() for x in planes), pack.data_ptr(), scal.data_ptr(),
        det_planes.data_ptr(), n, d)
    if err != 0:
        raise RuntimeError(f"wm_diag kernel launch failed: CUDA error {err} "
                           f"(n = {n}, d = {d}, {pack.dtype})")
    LAUNCHES += 1
    return scal, det_planes


def wm_diag_derived(Mqq, Mqp, Mpq, Mpp, dQ, dp, dq, n1q, n1Q, v0c, pack):
    """(scal (n, 30), det_planes (4, n, d)) of the separable WM step.

    Tensors on the card go to K5 (or raise if it does not take them);
    tensors on the CPU go to the plain version."""
    planes = (Mqq, Mqp, Mpq, Mpp, dQ, dp, dq, n1q, n1Q, v0c)
    kinds = {x.device.type for x in (*planes, pack)}
    if kinds == {"cpu"}:
        return wm_diag_derived_plain(*planes, pack)
    if kinds != {"cuda"}:
        raise ValueError("wm_diag_derived runs on cuda or cpu tensors (all "
                         f"on one), got {sorted(kinds)}")
    if hbar != 1.0:
        raise ValueError("the wm_diag kernel assumes hbar = 1 (atomic units)")
    check_args(planes, pack)
    return _launch(planes, pack)
