"""Plain Herman-Kluk propagation of a molecule on an sGDML force field
with the `taylor_every` window: dense monodromy matrices, widths of any
rank (the rigid-body null space projected out of the prefactor), the
determinant of each (r, r) prefactor matrix by the library's LU.

Time loop, as the configuration states it: scan segments of `scan_chunk`
steps; inside a segment, windows of `taylor_every` steps, each expanding
the force field (energy and gradient at float64, Hessian at `hess_dtype`)
once at the free-flight midpoint q + (every dt / 2) p / m of its first
state; every step of the window one order-2 re-expansion of that
quadratic at the step's free-flight midpoint, whose four RK4 stage forces
come from the quadratic there (its corrections at the Hessian's type),
and the monodromy advanced by the window's degree-4 truncated exponential
of its Hessian."""

import math

import numpy as np
import torch

from reference.common import AUTIME_TO_FS, HBAR, ROOT_DIR, ZERO, draw
from reference.molecular import (GDML, masses, minimum_energy, read_fchk,
                                 vibrational_groundstate)


def pinv_eigh(G):
    """(pseudo-inverse, eigenvalues, non-zero mask) of a symmetric G."""
    e, V = np.linalg.eigh(G)
    nz = np.abs(e) > ZERO
    return np.einsum("ij,j,kj->ik", V[:, nz], 1.0 / e[nz], V[:, nz]), e, nz


def _overlap(Gi, Gj):
    """(A, B, C, fac) of <q, p, Gi | q', p', Gj>: exponent
    -1/2 dq A dq - 1/(2 hbar^2) dp B dp + i/hbar (dq C dp - dq . p'),
    A = Gi [Gi+Gj]^+ Gj, B = [Gi+Gj]^+, C = Gj [Gi+Gj]^+."""
    iGij, e, nz = pinv_eigh(Gi + Gj)
    ei, ej = np.linalg.eigvalsh(Gi), np.linalg.eigvalsh(Gj)
    keep_i, keep_j = np.abs(ei) > ZERO, np.abs(ej) > ZERO
    log_fac = 0.5 * (np.count_nonzero(keep_i) * math.log(2.0)
                     + 0.5 * np.sum(np.log(ei[keep_i]))
                     + 0.5 * np.sum(np.log(ej[keep_j]))
                     - np.sum(np.log(e[nz])))
    return Gi @ iGij @ Gj, iGij, Gj @ iGij, math.exp(log_fac)


def _sqrtm(G):
    """(G^1/2, G^+(-1/2)) of a symmetric PSD matrix, complex."""
    e, V = np.linalg.eigh(G)
    nz = np.abs(e) > ZERO
    ec, Vc = e.astype(complex), V.astype(complex)
    return (np.einsum("ij,j,kj->ik", Vc, np.sqrt(ec), Vc),
            np.einsum("ij,j,kj->ik", Vc[:, nz], 1.0 / np.sqrt(ec[nz]),
                      Vc[:, nz]))


def _quad(x, A, y):
    return torch.sum((x @ A) * y, dim=-1)


def _exponent(ov, dq, dp, pj):
    A, B, C = ov
    re = -0.5 * _quad(dq, A, dq) - 0.5 / HBAR ** 2 * _quad(dp, B, dp)
    im = (_quad(dq, C, dp) - dq @ pj) / HBAR
    return re, im


class Molecule:
    """The configuration's molecule: force field, masses, NAC, wavepacket
    and energy origin, from its files."""

    def __init__(self, potential, device):
        fchk = read_fchk(ROOT_DIR / potential["excited"])
        coupling = read_fchk(ROOT_DIR / potential["coupling"])
        stated = getattr(torch, potential.get("hess_dtype", "float64"))
        self.model = GDML(ROOT_DIR / potential["ground"], device, stated)
        if not np.array_equal(self.model.z, coupling["Atomic numbers"]):
            raise ValueError("the force field and the NAC file describe "
                             "different molecules")
        self.mass = masses(coupling)
        self.nac = coupling["Nonadiabatic coupling"]
        self.q0, self.G0, self.e0 = vibrational_groundstate(fchk)
        self.origin = minimum_energy(self.model, self.q0)


class Batch:
    """What one repetition shares between the HK and WM observables: the
    draw, the widths' factors and the Monte-Carlo weights."""

    def __init__(self, mol, normals, dtype):
        dev = normals.device
        self.dtype = dtype
        self.cdt = (torch.complex128 if dtype == torch.float64
                    else torch.complex64)
        self.t = lambda x, d=dtype: torch.tensor(np.asarray(x), device=dev,
                                                 dtype=d)
        t, G = self.t, mol.G0
        self.d, self.n = len(mol.q0), normals.shape[0]
        p0n = np.zeros(self.d)
        self.qi, self.pi, log_prob = draw(mol.q0, p0n, G, G, normals, dtype)
        self.iGi0, _, nz = pinv_eigh(G + G)
        self.U = np.linalg.eigh(G + G)[1][:, nz]
        self.q0, self.p0 = t(mol.q0), t(p0n)
        self.inv_m = t(1.0 / mol.mass)
        logw = -(math.log(self.n) + log_prob
                 + self.d * math.log(2.0 * math.pi * HBAR))
        self.log_scale = float(torch.mean(logw))
        self.logw_norm = logw - self.log_scale

    def finish(self, mol, task, sums):
        """{"cauto", "kic", "ntraj"}: the batch sums with the weight scale
        and the dynamical phase exp(i E0 t / hbar) applied."""
        dt = task["time_step_fs"] / AUTIME_TO_FS
        scale = math.exp(self.log_scale)
        phase = np.exp(1j / HBAR * mol.e0 * dt * np.arange(sums.shape[1]))
        raw = sums.cpu().numpy().astype(np.complex128)
        return {"cauto": raw[0] * scale * phase,
                "kic": raw[1] * scale * phase, "ntraj": self.n}


def trajectories(mol, task, batch):
    """The states (q, p, S, Z) of the batch at every step, each before the
    step that follows it (see the module's docstring)."""
    dtype, n, d, inv_m = batch.dtype, batch.n, batch.d, batch.inv_m
    dev = batch.qi.device
    dt = task["time_step_fs"] / AUTIME_TO_FS
    nt, chunk = int(task["num_steps"]), int(task["scan_chunk"])
    every = int(task["potential"]["taylor_every"])
    eye = torch.eye(2 * d, device=dev, dtype=dtype)

    def window(q, p):
        """The window's quadratic (midpoint, v, g, H) and its monodromy
        map T (n, 2d, 2d)."""
        qm = q + 0.5 * every * dt * (p * inv_m)
        v, g, H = mol.model.forward(qm)
        v, g = (v - mol.origin).to(dtype), g.to(dtype)
        Hm = H.to(dtype)
        Yq, Yp = eye[:d].expand(n, d, 2 * d), eye[d:].expand(n, d, 2 * d)
        for c in (dt / 4, dt / 3, dt / 2, dt):
            Yq, Yp = (eye[:d] + c * (Yp * inv_m[None, :, None]),
                      eye[d:] - c * torch.matmul(Hm, Yq))
        return (qm, v, g, H), torch.cat([Yq, Yp], dim=1)

    def quadratic(quad, x):
        """Value and gradient of a quadratic (center, v, g, H) at x, its
        corrections at the Hessian's type."""
        xm, v, g, H = quad
        delta = x - xm
        hd = torch.matmul(H, delta.to(H.dtype)[:, :, None])[:, :, 0]
        return (v + torch.sum(g * delta, 1)
                + 0.5 * torch.sum(hd * delta.to(H.dtype), 1).to(v.dtype),
                g + hd.to(g.dtype))

    q, p = batch.qi.clone(), batch.pi.clone()
    S = torch.zeros(n, device=dev, dtype=dtype)
    Z = eye.expand(n, 2 * d, 2 * d).clone()
    step = 0
    while step < nt:
        seg_end = min(step + chunk, nt)
        while step < seg_end:
            quad, T = window(q, p)
            for _ in range(min(every, seg_end - step)):
                yield q, p, S, Z
                # RK4 on the quadratic re-expanded at the step's midpoint,
                # the stage corrections at the Hessian's type
                mid = q + 0.5 * dt * (p * inv_m)
                v_m, g_m = quadratic(quad, mid)
                H = quad[3]
                g_mc = g_m.to(H.dtype)

                def deriv(qs, ps):
                    delta = (qs - mid).to(H.dtype)
                    hd = torch.matmul(H, delta[:, :, None])[:, :, 0]
                    v = v_m + torch.sum((g_mc + 0.5 * hd) * delta,
                                        1).to(v_m.dtype)
                    g = g_m + hd.to(g_m.dtype)
                    return (ps * inv_m, -g,
                            0.5 * torch.sum(ps * ps * inv_m, 1) - v)

                k1 = deriv(q, p)
                k2 = deriv(q + 0.5 * dt * k1[0], p + 0.5 * dt * k1[1])
                k3 = deriv(q + 0.5 * dt * k2[0], p + 0.5 * dt * k2[1])
                k4 = deriv(q + dt * k3[0], p + dt * k3[1])
                q, p, S = (x + dt / 6.0 * (a + 2.0 * b + 2.0 * c_ + e_)
                           for x, a, b, c_, e_ in zip((q, p, S), k1, k2, k3,
                                                      k4))
                Z = torch.matmul(T, Z)
                step += 1


class SignedRoot:
    """sqrt(z(t)) kept continuous along the steps: its sign flips where z
    crosses the negative real axis between two steps."""

    def __init__(self):
        self.prev = self.sign = None

    def signs(self, z):
        if self.prev is None:
            self.sign = torch.ones_like(z.real)
        else:
            flip = ((self.prev.real < 0) & (z.real < 0)
                    & (self.prev.imag * z.imag < 0))
            self.sign = torch.where(flip, -self.sign, self.sign)
        self.prev = z
        return self.sign


def hk_prefactor2(batch, G):
    """C^2(Z) of the HK prefactor: det of the (r, r) projected matrix
    1/2 (Lt_s (Mqq Ri_i - i hbar Mqp Ri_s) + Lt_i (Mpp Ri_s + i/hbar Mpq
    Ri_i)), with Lt = U^T Gt^(+-1/2), Ri = Gi^(+-1/2) U."""
    d, cdt, t = batch.d, batch.cdt, batch.t
    sq, isq = _sqrtm(G)
    Uc = batch.U.astype(complex)
    Lt_s, Lt_i = t(Uc.T @ sq, cdt), t(Uc.T @ isq, cdt)
    Ri_s, Ri_i = t(sq @ Uc, cdt), t(isq @ Uc, cdt)

    def c2(Z):
        Mqq, Mqp = Z[:, :d, :d].to(cdt), Z[:, :d, d:].to(cdt)
        Mpq, Mpp = Z[:, d:, :d].to(cdt), Z[:, d:, d:].to(cdt)
        mat = 0.5 * (Lt_s @ (Mqq @ Ri_i - 1j * HBAR * (Mqp @ Ri_s))
                     + Lt_i @ (Mpp @ Ri_s + 1j / HBAR * (Mpq @ Ri_i)))
        return torch.linalg.det(mat)

    return c2


def propagate(mol, task, normals, dtype=torch.float64):
    """One repetition of HK dynamics (see the module's docstring)."""
    b = Batch(mol, normals, dtype)
    t, G, q0, p0 = b.t, mol.G0, b.q0, b.p0
    *ov, fac = _overlap(G, G)
    ov = [t(m) for m in ov]
    R = t(G @ b.iGi0 @ G)
    shift = t((G @ b.iGi0).T)
    n1 = -HBAR ** 2 * t(mol.nac) * b.inv_m

    def nac_factor(x, pvec, sign):
        return torch.complex(_quad(q0[None] - x, R, n1[None].expand_as(x)),
                             sign / HBAR * torch.sum(pvec * n1, dim=1))

    re_i, im_i = _exponent(ov, q0[None] - b.qi, p0[None] - b.pi, p0)
    obs_re, obs_im = re_i + b.logw_norm, im_i
    nacq = nac_factor(b.qi, p0 + (b.pi - p0) @ shift, +1.0)
    c2_of, root = hk_prefactor2(b, G), SignedRoot()
    nt = int(task["num_steps"])
    sums = torch.zeros(2, nt, device=normals.device, dtype=b.cdt)
    for step, (q, p, S, Z) in enumerate(trajectories(mol, task, b)):
        c2 = c2_of(Z)
        c = torch.sqrt(c2) * root.signs(c2)
        re_t, im_t = _exponent(ov, q0[None] - q, p0[None] - p, p0)
        x_c = fac * fac * c * torch.polar(torch.exp(re_t + obs_re),
                                          obs_im - im_t + S / HBAR)
        x_k = (nac_factor(q, p0 + (p - p0) @ shift, -1.0) * nacq * x_c
               / HBAR ** 2)
        sums[0, step], sums[1, step] = x_c.sum(), x_k.sum()
    return b.finish(mol, task, sums)


_MOLECULES = {}


def molecule(pot, device):
    """The molecule of the potential block, built once per process and
    device."""
    key = (str(device), pot["ground"], pot["excited"], pot["coupling"])
    if key not in _MOLECULES:
        _MOLECULES[key] = Molecule(pot, device)
    return _MOLECULES[key]


def rank(task, table):
    """The sampled modes of the molecule (the normals have 2 rank
    columns): the non-zero widths."""
    G = vibrational_groundstate(read_fchk(ROOT_DIR
                                          / task["potential"]["excited"]))[1]
    return int(np.count_nonzero(np.abs(np.linalg.eigvalsh(G + G)) > ZERO))


def checked(task, propagator):
    """The task's potential block, after the checks that it is one this
    reference covers: `propagator` on an sGDML force field, hessian_eval
    taylor, f64 trajectories, no error bars."""
    pot = task["potential"]
    if (task.get("propagator", "HK") != propagator or pot["type"] != "gdml"
            or pot.get("hessian_eval") != "taylor"
            or task.get("precision", "f64") != "f64"
            or task.get("error_bars", False)):
        raise ValueError(f"the dense {propagator} reference covers "
                         f"{propagator} on an sGDML force field, "
                         "hessian_eval taylor, f64")
    return pot


def run_plain(fn, *args):
    """fn(*args) with float32 products at float32, not TF32."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return fn(*args)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def repetition(task, table, normals, dtype=torch.float64):
    """One repetition of the dynamics task `task` (see `checked`); `table`
    is unused: the molecule comes from the task's files."""
    pot = checked(task, "HK")
    return run_plain(propagate, molecule(pot, normals.device), task,
                     normals, dtype)
