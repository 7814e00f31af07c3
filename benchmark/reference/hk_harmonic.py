"""Plain Herman-Kluk propagation of a molecule on its harmonic potential
energy surface: the second-order Taylor expansion of the ground state's
frequency checkpoint,

    V(q) = E0 + g . (q - x0) + 1/2 (q - x0)^T H (q - x0),

with E0, g, H and x0 the checkpoint's total energy, Cartesian gradient,
Cartesian force constants and geometry, a constant non-adiabatic coupling
vector, dense monodromy matrices and widths of any rank (the rigid-body
null space projected out of the prefactor), the determinant of each
(r, r) prefactor matrix by the library's LU.

Time loop: classic RK4 on (q, p, S) with dS/dt = p^2 / 2m - V, and the
same four stages on the monodromy Z (2d, 2d), dZ/dt = [[0, 1/m], [-H, 0]]
Z. Scan segments change nothing on this PES (there is no window), so the
loop runs the task's steps in one pass.

Departures from the reference package's formulas: the energy origin is
the closed-form minimum of the quadratic, E0 - 1/2 g^T H^+ g over the
Hessian's eigenvalues above 1e-8 of the largest (the reference package
finds it by Newton steps on the same pseudo-inverse, which land on it
in one step); the monodromy's RK4 stages are written out, where the
reference package applies their product, the degree-4 truncated
exponential of the step, as one matrix."""

import numpy as np
import torch

from reference.common import AUTIME_TO_FS, HBAR, ROOT_DIR
from reference.hk_dense import (Batch, SignedRoot, _exponent, _overlap,
                                _quad, hk_prefactor2, rank, run_plain)
from reference.molecular import masses, read_fchk, vibrational_groundstate


def hessian(fchk):
    """The checkpoint's Cartesian force constants, symmetric (3N, 3N)."""
    nat = int(fchk["Number of atoms"])
    H = np.zeros((3 * nat, 3 * nat))
    row, col = np.tril_indices(3 * nat)
    H[row, col] = fchk["Cartesian Force Constants"]
    H[col, row] = H[row, col]
    return H


class Molecule:
    """The configuration's molecule: the harmonic PES of the ground
    checkpoint, masses and NAC of the coupling checkpoint, wavepacket of
    the excited one, and the energy origin at the PES's minimum."""

    def __init__(self, potential):
        ground = read_fchk(ROOT_DIR / potential["ground"])
        excited = read_fchk(ROOT_DIR / potential["excited"])
        coupling = read_fchk(ROOT_DIR / potential["coupling"])
        for other in (excited, coupling):
            if not np.array_equal(ground["Atomic numbers"],
                                  other["Atomic numbers"]):
                raise ValueError("the checkpoints describe different "
                                 "molecules")
        self.mass = masses(coupling)
        if not np.array_equal(masses(ground), self.mass):
            raise ValueError("the checkpoints give different masses")
        self.nac = coupling["Nonadiabatic coupling"]
        self.q0, self.G0, self.e0 = vibrational_groundstate(excited)
        self.x0 = ground["Current cartesian coordinates"]
        self.E0 = float(ground["Total Energy"])
        self.g = ground["Cartesian Gradient"]
        self.H = hessian(ground)
        e, V = np.linalg.eigh(self.H)
        keep = np.abs(e) > 1.0e-8 * np.abs(e).max()
        gk = V[:, keep].T @ self.g
        self.origin = self.E0 - 0.5 * float(np.sum(gk * gk / e[keep]))


def trajectories(mol, task, batch):
    """The states (q, p, S, Z) of the batch at every step, each before the
    step that follows it (see the module's docstring)."""
    dtype, n, d, inv_m, t = batch.dtype, batch.n, batch.d, batch.inv_m, \
        batch.t
    dt = task["time_step_fs"] / AUTIME_TO_FS
    nt = int(task["num_steps"])
    x0, g, H = t(mol.x0), t(mol.g), t(mol.H)
    v0 = mol.E0 - mol.origin

    def deriv(q, p, S, Z):
        dx = q - x0
        hdx = dx @ H
        v = v0 + dx @ g + 0.5 * torch.sum(hdx * dx, dim=1)
        dZ = torch.cat([Z[:, d:, :] * inv_m[None, :, None],
                        -torch.matmul(H, Z[:, :d, :])], dim=1)
        return (p * inv_m, -(g + hdx),
                0.5 * torch.sum(p * p * inv_m, dim=1) - v, dZ)

    q, p = batch.qi.clone(), batch.pi.clone()
    S = torch.zeros(n, device=q.device, dtype=dtype)
    Z = torch.eye(2 * d, device=q.device, dtype=dtype).expand(
        n, 2 * d, 2 * d).clone()
    for _ in range(nt):
        yield q, p, S, Z
        y = (q, p, S, Z)
        k1 = deriv(*y)
        k2 = deriv(*(x + 0.5 * dt * k for x, k in zip(y, k1)))
        k3 = deriv(*(x + 0.5 * dt * k for x, k in zip(y, k2)))
        k4 = deriv(*(x + dt * k for x, k in zip(y, k3)))
        q, p, S, Z = (x + dt / 6.0 * (a + 2.0 * b + 2.0 * c + e)
                      for x, a, b, c, e in zip(y, k1, k2, k3, k4))


def propagate(mol, task, normals, dtype=torch.float64):
    """One repetition of HK dynamics (see the module's docstring): the
    observables of `hk_dense.propagate` on the harmonic trajectories."""
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


def molecule(pot):
    """The molecule of the potential block, built once per process."""
    key = (pot["ground"], pot["excited"], pot["coupling"])
    if key not in _MOLECULES:
        _MOLECULES[key] = Molecule(pot)
    return _MOLECULES[key]


def checked(task):
    """The task's potential block, after the checks that it is one this
    reference covers: HK on the harmonic PES, f64 trajectories, RK4, no
    error bars."""
    pot = task["potential"]
    if (task.get("propagator", "HK") != "HK" or pot["type"] != "harmonic"
            or task.get("precision", "f64") != "f64"
            or task.get("integrator", "rk4") != "rk4"
            or task.get("error_bars", False)):
        raise ValueError("the harmonic HK reference covers HK on the "
                         "harmonic PES, RK4, f64, without error bars")
    return pot


def repetition(task, table, normals, dtype=torch.float64):
    """One repetition of the dynamics task `task` (see `checked`); `table`
    is unused: the molecule comes from the task's files."""
    return run_plain(propagate, molecule(checked(task)), task, normals,
                     dtype)
