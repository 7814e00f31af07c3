"""Plain Herman-Kluk propagation of a separable model with diagonal widths
(the AS model): every mode is a one-dimensional Morse oscillator, so the
monodromy is a 2x2 matrix per trajectory and mode and the HK prefactor's
determinant a product over modes.

    C^2(t) = prod_k 1/2 ( Mqq + Mpp sqrt(gi/gt) ... )_k   (diagonal widths)
    C(t)   = sum_i w_i C_i(t) <g_t(t)|phi0> <phi0|g_i(0)> exp(i S_i / hbar)
    k~ic   = sum_i (the same) nac(Q_t) nac(q_i) / hbar^2

RK4 on q, p, S and the monodromy with the Hessian at every stage, the sign
of sqrt(C^2) tracked across the negative real axis, the sums taken over the
whole batch with the Monte-Carlo weights factored as exp(mean log w)."""

import math

import numpy as np
import torch

from reference.common import AUTIME_TO_FS, HBAR, MorseModel, draw


def _overlap_constants(gi, gj):
    """Diagonal constants of <q, p, gi | q', p', gj>: the three quadratic
    forms' diagonals and the normalisation factor."""
    s = gi + gj
    log_fac = 0.5 * (len(gi) * math.log(2.0) + 0.5 * np.sum(np.log(gi))
                     + 0.5 * np.sum(np.log(gj)) - np.sum(np.log(s)))
    return gi * gj / s, 1.0 / s, gj / s, math.exp(log_fac)


def _exponent(w, dq, dp, pj):
    """(re, im) of the overlap exponent for displacements dq = qj - qi,
    dp = pj - pi and ket momentum pj."""
    w1, w2, w3 = w
    re = (-0.5 * torch.sum(dq * w1 * dq, dim=1)
          - 0.5 / HBAR ** 2 * torch.sum(dp * w2 * dp, dim=1))
    im = (torch.sum(dq * w3 * dp, dim=1) - dq @ pj) / HBAR
    return re, im


def propagate(table, normals, dt, nt, error_bars, dtype=torch.float64):
    """One repetition of the HK dynamics task on the AS model `table`
    (rows omega/cm^-1, S, nac, chi) from the standard normals (n, 2 d):
    returns {"cauto", "kic", "ntraj"} (complex (nt,) numpy, the dynamical
    phase exp(i E0 t / hbar) and the weight scale applied) and, with
    `error_bars`, the per-step standard errors "err_c", "err_k"."""
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
    # <g_t|phi0> and <phi0|g_i> have the same widths here: fac each
    w1, w2, w3, fac = _overlap_constants(g, g)
    w = (t(w1), t(w2), t(w3))
    # prefactor factors for Gamma_i = Gamma_t = g: ka = kc = 1, kb = g,
    # ke = 1/g
    kb, ke = t(g), t(1.0 / g)
    R = t(g * g / (g + g))               # G0 [Gi + G0]^-1 Gi
    shift = t(g / (g + g))               # G0 [Gi + G0]^-1
    n1 = -HBAR ** 2 * model.nac          # unit masses, tau2 = 0

    def nac_factor(x, pvec, sign):
        return torch.complex(torch.sum((q0 - x) * R * n1, dim=1),
                             sign / HBAR * torch.sum(pvec * n1, dim=1))

    logw = -(math.log(n) + log_prob + d * math.log(2.0 * math.pi * HBAR))
    log_scale = float(torch.mean(logw))
    re_i, im_i = _exponent(w, q0[None] - qi, p0[None] - pi, p0)
    obs_re = re_i + (logw - log_scale)
    obs_im = im_i
    nacq = nac_factor(qi, p0 + (pi - p0) * shift, +1.0)

    q, p = qi.clone(), pi.clone()
    S = torch.zeros(n, device=dev, dtype=dtype)
    one, zero = torch.ones_like(q), torch.zeros_like(q)
    mqq, mqp, mpq, mpp = one, zero, zero, one
    prev, sign = None, torch.ones(n, device=dev, dtype=dtype)
    sums = torch.zeros(2, nt, device=dev, dtype=cdtype)
    moments = torch.zeros(2, nt, device=dev, dtype=torch.float64)
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
        re_t, im_t = _exponent(w, q0[None] - q, p0[None] - p, p0)
        x_c = fac * fac * c * torch.polar(torch.exp(re_t + obs_re),
                                    obs_im - im_t + S / HBAR)
        x_k = nac_factor(q, p0 + (p - p0) * shift, -1.0) * nacq * x_c \
            / HBAR ** 2
        sums[0, step], sums[1, step] = x_c.sum(), x_k.sum()
        if error_bars:
            for j, x in enumerate((x_c, x_k)):
                x = x.to(torch.complex128)
                moments[j, step] = torch.sum(x.real ** 2 + x.imag ** 2)

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
    ts = h * np.arange(nt)
    phase = np.exp(1j / HBAR * e0 * ts)
    raw = sums.cpu().numpy().astype(np.complex128)
    out = {"cauto": raw[0] * scale * phase, "kic": raw[1] * scale * phase,
           "ntraj": n}
    if error_bars:
        m2 = moments.cpu().numpy()
        out["err_c"], out["err_k"] = (
            scale * np.sqrt(np.maximum(m2[j] - np.abs(raw[j]) ** 2 / n, 0.0))
            for j in range(2))
    return out


def rank(task, table):
    """The sampled modes: every mode of the model."""
    return len(table)


def repetition(task, table, normals, dtype=torch.float64):
    """One repetition of the dynamics task `task` (HK on an AS model at
    float64 trajectories, every stage's Hessian): see `propagate`."""
    pot = task["potential"]
    if (task.get("propagator", "HK") != "HK"
            or pot.get("hessian_eval", "stage") != "stage"
            or task.get("integrator", "rk4") != "rk4"
            or task.get("precision", "f64") != "f64"
            or task.get("sampling", "pseudo") != "pseudo"):
        raise ValueError("the separable HK reference covers HK, RK4 with "
                         "the Hessian at every stage, f64, pseudo sampling")
    dt = task["time_step_fs"] / AUTIME_TO_FS
    return propagate(table, normals, dt, int(task["num_steps"]),
                     bool(task.get("error_bars", False)), dtype)
