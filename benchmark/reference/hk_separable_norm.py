"""Plain Herman-Kluk propagation of a separable model with diagonal widths
(the AS model), as `hk_separable` does it, with the norm of the HK
wavefunction taken every `calc_norm_every` steps, before the step:

    psi(t)  = sum_i v_i |g_t(q_i(t), p_i(t))>,
    v_i     = C_i(t) exp(i S_i / hbar) <g_i(0)|phi0> w_i,
    |psi|^2 = sum_ij conj(v_i) <g_i|g_j> v_j,

a plain sum over every ordered pair (i, j) of the whole batch, in blocks of
rows. Each term is one exponential, its exponent the sum of the two
log-coefficients and of the pair overlap's exponent; for diagonal widths
that exponent is a row term, a column term and two mode sums over the
2 d phase-space numbers of the pair, taken here as two matrix products a
block pair:

    re_ij = -(A_i + A_j) / 2 + [q_i, p_i] . [w1 q_j, w2 p_j / hbar^2]
    im_ij = (B_i + B'_j + [q_i, p_i] . [(1 - w3) p_j, -w3 q_j]) / hbar

with (w1, w2, w3) the diagonals of Gt [2 Gt]^-1 Gt, [2 Gt]^-1 and
Gt [2 Gt]^-1, A = q w1 q + p w2 p / hbar^2, B = q w3 p, B' = q (w3 - 1) p.
Nothing of the port is imported; the trajectories, the prefactor and its
sign are propagated here as in `hk_separable`."""

import math

import numpy as np
import torch

from reference.common import AUTIME_TO_FS, HBAR, MorseModel, draw
from reference.hk_separable import _exponent, _overlap_constants

# rows of a block of the pair sum: (BLOCK, BLOCK) float64 planes of 134 MB
BLOCK = 4096


def pair_norm(q, p, log_mag, phase, g, block=BLOCK):
    """|psi| = sqrt(sum_ij Re conj(v_i) <g_i|g_j> v_j) over every ordered
    pair of the rows of q, p (n, d), with log |v| = `log_mag` and arg v =
    `phase` (n,), the Gaussians of diagonal width `g` (d,). Each block
    pair's sum is taken at the tensors' dtype and added at float64."""
    dtype = q.dtype
    w1, w2, w3, fac = _overlap_constants(g, g)
    t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64),
                               device=q.device, dtype=dtype)
    w1, w2, w3 = t(w1), t(w2), t(w3)
    x = torch.cat([q, p], dim=1)
    y_re = torch.cat([w1 * q, w2 * p / HBAR ** 2], dim=1)
    y_im = torch.cat([(1.0 - w3) * p, -w3 * q], dim=1)
    a = torch.sum(q * w1 * q, 1) + torch.sum(p * w2 * p, 1) / HBAR ** 2
    row_re = log_mag - 0.5 * a + math.log(fac)
    col_re = log_mag - 0.5 * a
    row_im = -phase + torch.sum(q * w3 * p, 1) / HBAR
    col_im = phase + torch.sum(q * (w3 - 1.0) * p, 1) / HBAR
    n = q.shape[0]
    total = torch.zeros((), device=q.device, dtype=torch.float64)
    for i in range(0, n, block):
        xi = x[i:i + block]
        for j in range(0, n, block):
            re = (row_re[i:i + block, None] + col_re[None, j:j + block]
                  + xi @ y_re[j:j + block].T)
            im = (row_im[i:i + block, None] + col_im[None, j:j + block]
                  + (xi @ y_im[j:j + block].T) / HBAR)
            total += torch.sum(torch.exp(re) * torch.cos(im)).double()
    return math.sqrt(float(total))


def propagate(table, normals, dt, nt, norm_every, dtype=torch.float64):
    """One repetition of the HK dynamics task on the AS model `table` from
    the standard normals (n, 2 d): {"cauto", "kic", "ntraj"} as
    `hk_separable.propagate` gives them (no error bars), and "norms" at
    "norm_steps" (0, norm_every, ... below nt)."""
    dev = normals.device
    model = MorseModel(table, dev, dtype)
    q0n, p0n, G0, e0 = model.wavepacket()
    g = np.diag(G0)                       # Gamma_i = Gamma_t = Gamma_0
    d, n = len(g), normals.shape[0]
    t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64), device=dev,
                               dtype=dtype)
    q0, p0 = t(q0n), t(p0n)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64

    qi, pi, log_prob = draw(q0n, p0n, G0, G0, normals, dtype)
    w1, w2, w3, fac = _overlap_constants(g, g)
    w = (t(w1), t(w2), t(w3))
    kb, ke = t(g), t(1.0 / g)
    R = t(g * g / (g + g))
    shift = t(g / (g + g))
    n1 = -HBAR ** 2 * model.nac

    def nac_factor(x, pvec, sign):
        return torch.complex(torch.sum((q0 - x) * R * n1, dim=1),
                             sign / HBAR * torch.sum(pvec * n1, dim=1))

    logw = -(math.log(n) + log_prob + d * math.log(2.0 * math.pi * HBAR))
    log_scale = float(torch.mean(logw))
    re_i, im_i = _exponent(w, q0[None] - qi, p0[None] - pi, p0)
    obs_re = re_i + (logw - log_scale)
    obs_im = im_i
    # log |v_i| and arg v_i without the prefactor and the action
    coef_re = re_i + logw + math.log(fac)
    nacq = nac_factor(qi, p0 + (pi - p0) * shift, +1.0)

    q, p = qi.clone(), pi.clone()
    S = torch.zeros(n, device=dev, dtype=dtype)
    one, zero = torch.ones_like(q), torch.zeros_like(q)
    mqq, mqp, mpq, mpp = one, zero, zero, one
    prev, sign = None, torch.ones(n, device=dev, dtype=dtype)
    sums = torch.zeros(2, nt, device=dev, dtype=cdtype)
    norms, norm_steps = [], []
    h = float(dt)

    for step in range(nt):
        zr = 0.5 * (mqq + mpp)
        zi = 0.5 * (mpq * ke / HBAR - HBAR * mqp * kb)
        c2 = torch.polar(torch.exp(0.5 * torch.sum(torch.log(zr ** 2
                                                             + zi ** 2), 1)),
                         torch.sum(torch.atan2(zi, zr), 1))
        if prev is not None:
            flip = ((prev.real < 0) & (c2.real < 0)
                    & (prev.imag * c2.imag < 0))
            sign = torch.where(flip, -sign, sign)
        prev = c2
        c = torch.sqrt(c2) * sign
        if norm_every and step % norm_every == 0:
            norms.append(pair_norm(
                q, p, torch.log(torch.abs(c)) + coef_re,
                torch.angle(c) + S / HBAR + im_i, g))
            norm_steps.append(step)
        re_t, im_t = _exponent(w, q0[None] - q, p0[None] - p, p0)
        x_c = fac * fac * c * torch.polar(torch.exp(re_t + obs_re),
                                          obs_im - im_t + S / HBAR)
        x_k = nac_factor(q, p0 + (p - p0) * shift, -1.0) * nacq * x_c \
            / HBAR ** 2
        sums[0, step], sums[1, step] = x_c.sum(), x_k.sum()

        # one RK4 step of q, p, S and of the per-mode monodromy
        def deriv(qs, ps):
            v, grad, hess = model.expand(qs)
            return ps, -grad, 0.5 * torch.sum(ps * ps, 1) - v, hess

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

    scale = math.exp(log_scale)
    phase = np.exp(1j / HBAR * e0 * h * np.arange(nt))
    raw = sums.cpu().numpy().astype(np.complex128)
    return {"cauto": raw[0] * scale * phase, "kic": raw[1] * scale * phase,
            "ntraj": n, "norms": norms, "norm_steps": norm_steps}


def rank(task, table):
    """The sampled modes: every mode of the model."""
    return len(table)


def repetition(task, table, normals, dtype=torch.float64):
    """One repetition of the dynamics task `task` (HK on an AS model at
    float64, every stage's Hessian, no error bars) with its norms: see
    `propagate`."""
    pot = task["potential"]
    if (task.get("propagator", "HK") != "HK"
            or pot.get("hessian_eval", "stage") != "stage"
            or task.get("integrator", "rk4") != "rk4"
            or task.get("precision", "f64") != "f64"
            or task.get("sampling", "pseudo") != "pseudo"
            or task.get("error_bars", False)):
        raise ValueError("the separable HK norm reference covers HK, RK4 "
                         "with the Hessian at every stage, f64, pseudo "
                         "sampling, no error bars")
    dt = task["time_step_fs"] / AUTIME_TO_FS
    return propagate(table, normals, dt, int(task["num_steps"]),
                     int(task.get("calc_norm_every", 0)), dtype)
