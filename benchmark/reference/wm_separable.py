"""Plain Walton-Manolopoulos (Filinov-filtered) propagation of a separable
model with diagonal widths (the AS model): Walton and Manolopoulos'
eqns. 50-84 and the observables of eqns. 85, 89-100, as `wm_dense` has
them, written per mode.

With every width matrix diagonal at full rank (Gamma_0 = Gamma_i =
Gamma_t = diag(omega) here, the projection U the identity) and the
monodromy's four blocks diagonal, every matrix of the WM step is diagonal
in the modes: the 2d x 2d A-matrix is, up to a permutation, d independent
2 x 2 complex blocks

    A_k = A_const,k - (i/hbar) H_k + gt x_k x_k^T + (2i/hbar) z_k x_k^T,
    x_k = (Mqq, Mqp)_k,  z_k = (Mpq, Mpp)_k,
    A_const,k = [[2 alpha g0 + gi, 0], [-2i/hbar, 2 beta / g0]],
    H_k = [[Mpq Mqq, Mpq Mqp], [Mqp Mpq, Mqp Mpp]]_k,

and M, Gt(t), Gti, CQQ, CqQ, Rqq, RQQ, RqQ are scalars per mode. Each
block is inverted by the closed 2 x 2 formula; detA = prod_k det A_k / s^2
(s = 2 sqrt(alpha beta)) and detM = prod_k M'_k / m_scale are taken as
products over the modes in log space, as the HK prefactor's C^2 =
prod_k 1/2 (sqrt(gt/gi) Mqq + sqrt(gi/gt) Mpp + i (Mpq / (hbar
sqrt(gi gt)) - hbar sqrt(gi gt) Mqp)). The three square roots are followed
across the negative real axis (`hk_dense.SignedRoot`).

The trajectories are the Morse RK4 of `hk_separable` with the Hessian at
every stage and the diagonal monodromy's two columns stepped beside them
(that reference steps them inside its `propagate`, so the step is stated
here again, in its order). The batch is drawn whole (`common.draw`), its
Monte-Carlo weights normalised over the whole batch, and then run in
blocks of `BLOCK` trajectories, whose sums add up.

Departures from the published equations: none in the algebra. As in
`wm_dense` and the program, the determinants carry the scale factors
1 / s^2 (A) and 1 / m_scale (M), m_scale = 2 pi exp(sum log(g0 / pi) /
d), which `auto_pref` = exp(sum (log(gt/pi) + log(gi/pi)) / 4 - sum
log((g0 + gi) / 2 pi) / 2) compensates; the AS model's coupling is a
constant vector, so its second-derivative terms (n2) are zero and the
masses one."""

import math

import numpy as np
import torch

from reference.common import AUTIME_TO_FS, HBAR, MorseModel, draw
from reference.hk_dense import SignedRoot, run_plain
from reference.hk_separable import rank

__all__ = ["repetition", "rank"]

# trajectories a block: three blocks at the AS cells' 98,304
BLOCK = 32768


def _mode_product(z):
    """prod over the modes (dim 1) of the complex z (b, d), in log space:
    magnitudes as a sum of logs, phases as a sum of angles."""
    log_mag = 0.5 * torch.sum(torch.log(z.real ** 2 + z.imag ** 2), 1)
    return torch.polar(torch.exp(log_mag), torch.sum(torch.atan2(z.imag,
                                                                 z.real), 1))


def _trajectories(model, qi, pi, h, nt):
    """(q, p, S, (Mqq, Mqp, Mpq, Mpp)) before each of `nt` RK4 steps of
    length h of the separable Morse model from (qi, pi)."""
    q, p = qi.clone(), pi.clone()
    S = torch.zeros(q.shape[0], device=q.device, dtype=q.dtype)
    one, zero = torch.ones_like(q), torch.zeros_like(q)
    mqq, mqp, mpq, mpp = one, zero, zero, one

    def deriv(qs, ps):
        v, grad, hess = model.expand(qs)
        return ps, -grad, 0.5 * torch.sum(ps * ps, 1) - v, hess

    for _ in range(nt):
        yield q, p, S, (mqq, mqp, mpq, mpp)
        dq1, dp1, dS1, h1 = deriv(q, p)
        dq2, dp2, dS2, h2 = deriv(q + 0.5 * h * dq1, p + 0.5 * h * dp1)
        dq3, dp3, dS3, h3 = deriv(q + 0.5 * h * dq2, p + 0.5 * h * dp2)
        dq4, dp4, dS4, h4 = deriv(q + h * dq3, p + h * dp3)
        mono = []
        for mq, mp in ((mqq, mpq), (mqp, mpp)):
            a1, b1 = mp, -h1 * mq
            a2, b2 = mp + 0.5 * h * b1, -h2 * (mq + 0.5 * h * a1)
            a3, b3 = mp + 0.5 * h * b2, -h3 * (mq + 0.5 * h * a2)
            a4, b4 = mp + h * b3, -h4 * (mq + h * a3)
            mono.append((mq + h / 6.0 * (a1 + 2.0 * a2 + 2.0 * a3 + a4),
                         mp + h / 6.0 * (b1 + 2.0 * b2 + 2.0 * b3 + b4)))
        (mqq, mpq), (mqp, mpp) = mono
        q = q + h / 6.0 * (dq1 + 2.0 * dq2 + 2.0 * dq3 + dq4)
        p = p + h / 6.0 * (dp1 + 2.0 * dp2 + 2.0 * dp3 + dp4)
        S = S + h / 6.0 * (dS1 + 2.0 * dS2 + 2.0 * dS3 + dS4)


class Widths:
    """The per-mode constants of the cell widths alpha = beta and the
    diagonal widths g0 (Gamma_0), gi (Gamma_i), gt (Gamma_t), as (d,)
    tensors, and the prefactor's scalars."""

    def __init__(self, g0, gi, gt, alpha, beta, device, dtype):
        t = lambda x: torch.tensor(np.broadcast_to(x, g0.shape), device=device,
                                   dtype=dtype)
        self.g0, self.gi, self.gt = t(g0), t(gi), t(gt)
        self.s = 2.0 * math.sqrt(alpha * beta)
        self.a_q, self.a_p = t(2.0 * alpha * g0 + gi), t(2.0 * beta / g0)
        self.i_gi0 = t(1.0 / (g0 + gi))              # [Gi + G0]^-1
        self.cqq = t(g0 - g0 * g0 / (g0 + gi))       # eqn. 69
        ld0 = np.sum(np.log(g0 / math.pi))
        self.m_scale = 2.0 * math.pi * math.exp(ld0 / len(g0))
        self.auto_pref = math.exp(0.25 * np.sum(np.log(gt / math.pi))
                                  + 0.25 * np.sum(np.log(gi / math.pi))
                                  - 0.5 * np.sum(np.log((g0 + gi)
                                                        / (2.0 * math.pi))))
        self.c2_s = t(np.sqrt(gt / gi))
        self.c2_i = t(np.sqrt(gi / gt))
        self.c2_g = t(np.sqrt(gi * gt))


def _wm_terms(w, Z, p, p0, dp0):
    """The per-mode WM quantities of one step (eqns. 50-84) from the
    diagonal monodromy Z = (Mqq, Mqp, Mpq, Mpp) (b, d) each, the momenta p
    and dp0 = p0 - pi: (detA / s^2, M' / m_scale) per mode and Rqq, RQQ,
    RqQ, Pq, PQ and gamma's mode terms, complex (b, d)."""
    ih = 1j / HBAR
    x = (Z[0], Z[1])
    z = (Z[2], Z[3])
    hess = ((z[0] * x[0], z[0] * x[1]), (x[1] * z[0], x[1] * z[1]))
    const = ((w.a_q, 0.0), (-2.0 * ih, w.a_p))
    A = [[const[a][b] + w.gt * x[a] * x[b]
          + ih * (2.0 * z[a] * x[b] - hess[a][b]) for b in range(2)]
         for a in range(2)]
    det = A[0][0] * A[1][1] - A[0][1] * A[1][0]
    iA = ((A[1][1] / det, -A[0][1] / det), (-A[1][0] / det, A[0][0] / det))
    bQ = tuple(w.gt * x[a] + ih * z[a] for a in range(2))   # eqn. 54 at t
    bq = (w.gi, -ih)                                        # eqn. 54 at 0
    bQ_iA = tuple(bQ[0] * iA[0][b] + bQ[1] * iA[1][b] for b in range(2))
    gt_t = w.gt - (bQ_iA[0] * bQ[0] + bQ_iA[1] * bQ[1])     # Gt(t)
    gti = bQ_iA[0] * bq[0] + bQ_iA[1] * bq[1]               # Gti
    CQQ = gt_t - gti * w.i_gi0 * gti                        # eqn. 70
    CqQ = w.g0 * w.i_gi0 * gti                              # eqn. 71
    PIQ = p + gti * w.i_gi0 * dp0                           # eqn. 73
    Mp = w.g0 + CQQ                                         # eqn. 78
    iM = 1.0 / Mp
    dPIQ = PIQ - p0
    PIq = p0 - w.g0 * w.i_gi0 * dp0                         # eqn. 72
    return {"detA": det / w.s ** 2, "detM": Mp / w.m_scale,
            "Rqq": w.cqq - CqQ * iM * CqQ,                  # eqn. 79
            "RQQ": w.g0 - w.g0 * iM * w.g0,                 # eqn. 80
            "RqQ": CqQ * iM * w.g0,                         # eqn. 81
            "Pq": PIq - CqQ * iM * dPIQ,                    # eqn. 82
            "PQ": p0 + w.g0 * iM * dPIQ,                    # eqn. 83
            "gamma": -(0.5 / HBAR ** 2) * (dp0 * w.i_gi0 * dp0
                                           + dPIQ * iM * dPIQ)}  # 74, 84


def _block_sums(model, w, q0, p0, qi, pi, logw_norm, h, nt, cdtype):
    """(2, nt) complex: the block's sums of the C(t) and k~ic(t) terms
    (eqns. 85, 89-100), before the weight scale and the energy phase."""
    ih = 1j / HBAR
    n1 = -HBAR ** 2 * model.nac                  # unit masses, n2 = 0
    dq = q0[None] - qi
    dp0 = p0[None] - pi
    roots = [SignedRoot() for _ in range(3)]
    sums = torch.zeros(2, nt, device=qi.device, dtype=cdtype)
    for step, (q, p, S, Z) in enumerate(_trajectories(model, qi, pi, h, nt)):
        mqq, mqp, mpq, mpp = Z
        c2 = _mode_product(torch.complex(
            0.5 * (w.c2_s * mqq + w.c2_i * mpp),
            0.5 * (mpq / (HBAR * w.c2_g) - HBAR * w.c2_g * mqp)))
        r = _wm_terms(w, Z, p, p0[None], dp0)
        detA, detM = _mode_product(r["detA"]), _mode_product(r["detM"])
        signs = [root.signs(v) for root, v in zip(roots, (c2, detA, detM))]
        dQ = q0[None] - q
        sq = lambda x, R, y: torch.sum(x * R * y, 1)
        expo = (torch.sum(r["gamma"], 1) + logw_norm
                - 0.5 * sq(dq, r["Rqq"], dq) - 0.5 * sq(dQ, r["RQQ"], dQ)
                + sq(dq, r["RqQ"], dQ)
                + ih * (torch.sum(r["PQ"] * dQ, 1)
                        - torch.sum(r["Pq"] * dq, 1)))
        pref = (w.auto_pref * torch.sqrt(c2) * signs[0]
                * torch.polar(torch.ones_like(S), S / HBAR)
                * signs[1] / torch.sqrt(detA) * signs[2] / torch.sqrt(detM))
        x_c = pref * torch.exp(expo)
        nacqQ = sq(n1, r["RqQ"], n1)
        nacQ = (sq(dQ, r["RQQ"], n1) - sq(dq, r["RqQ"], n1)
                - ih * torch.sum(r["PQ"] * n1, 1))
        nacq = (sq(dq, r["Rqq"], n1) - sq(n1, r["RqQ"], dQ)
                + ih * torch.sum(r["Pq"] * n1, 1))
        x_k = (nacqQ + nacQ * nacq) * x_c / HBAR ** 2
        sums[0, step], sums[1, step] = x_c.sum(), x_k.sum()
    return sums


def propagate(table, normals, dt, nt, alpha, beta, dtype=torch.float64):
    """One repetition of WM dynamics with cell widths alpha, beta on the AS
    model `table` (rows omega/cm^-1, S, nac, chi) from the standard normals
    (n, 2 d): {"cauto", "kic", "ntraj"} (complex (nt,) numpy, the weight
    scale and the energy phase exp(i E0 t / hbar) applied)."""
    dev = normals.device
    model = MorseModel(table, dev, dtype)
    q0n, p0n, G0, e0 = model.wavepacket()
    g = np.diag(G0)                       # Gamma_i = Gamma_t = Gamma_0
    d, n = len(g), normals.shape[0]
    w = Widths(g, g, g, alpha, beta, dev, dtype)
    t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64), device=dev,
                               dtype=dtype)
    q0, p0 = t(q0n), t(p0n)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64

    qi, pi, log_prob = draw(q0n, p0n, G0, G0, normals, dtype)
    logw = -(math.log(n) + log_prob + d * math.log(2.0 * math.pi * HBAR))
    log_scale = float(torch.mean(logw))
    logw_norm = logw - log_scale
    sums = torch.zeros(2, nt, device=dev, dtype=cdtype)
    for a in range(0, n, BLOCK):
        b = slice(a, min(a + BLOCK, n))
        sums += _block_sums(model, w, q0, p0, qi[b], pi[b], logw_norm[b],
                            float(dt), nt, cdtype)

    phase = np.exp(1j / HBAR * e0 * dt * np.arange(nt))
    raw = sums.cpu().numpy().astype(np.complex128) * math.exp(log_scale)
    return {"cauto": raw[0] * phase, "kic": raw[1] * phase, "ntraj": n}


def repetition(task, table, normals, dtype=torch.float64):
    """One repetition of the dynamics task `task` (WM on an AS model, RK4
    with the Hessian at every stage, f64 trajectories, pseudo sampling, no
    error bars): see `propagate`."""
    pot = task["potential"]
    if (task.get("propagator", "HK") != "WM"
            or pot.get("hessian_eval", "stage") != "stage"
            or task.get("integrator", "rk4") != "rk4"
            or task.get("precision", "f64") != "f64"
            or task.get("sampling", "pseudo") != "pseudo"
            or task.get("error_bars", False)):
        raise ValueError("the separable WM reference covers WM, RK4 with the "
                         "Hessian at every stage, f64, pseudo sampling, no "
                         "error bars")
    width = float(task.get("cell_width", 10000.0))
    dt = task["time_step_fs"] / AUTIME_TO_FS
    return run_plain(propagate, table, normals, dt, int(task["num_steps"]),
                     width, width, dtype)
