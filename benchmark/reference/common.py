"""Pieces of the plain reference that every propagator shares: the AS
model's potential, the coherent-state draw and the merge of repetitions
into the results file. Plain NumPy and PyTorch; hbar = 1 (atomic units)."""

import math
import pathlib

import numpy as np
import torch

HBAR = 1.0
# eigenvalues at or below this count as zero (the widths' null space)
ZERO = 1.0e-8
HARTREE_TO_WAVENUMBERS = 219474.63
AUTIME_TO_FS = 0.02418884326505
# the checkout: the configurations name their data files from it
ROOT_DIR = pathlib.Path(__file__).resolve().parents[2]


class MorseModel:
    """N separable Morse modes of unit mass (DOI 10.1063/1.5143212 eqn. 6):
    V = sum_k D_k (1 - exp(-a_k q_k))^2, a = sqrt(2 omega chi),
    D = omega / (4 chi); a mode with chi = 0 gets chi = 1e-4. The
    non-adiabatic coupling is the constant vector `nac`."""

    def __init__(self, table, device, dtype):
        table = np.asarray(table, dtype=np.float64).reshape(-1, 4)
        omega = table[:, 0] / HARTREE_TO_WAVENUMBERS
        chi = np.where(table[:, 3] == 0.0, 1.0e-4, table[:, 3])
        self.omega = omega
        self.huang_rhys = table[:, 1]
        t = lambda x: torch.tensor(x, device=device, dtype=dtype)
        self.a = t(np.sqrt(2.0 * omega * chi))
        self.D = t(0.25 * omega / chi)
        self.nac = t(table[:, 2])

    def wavepacket(self):
        """(q0, p0, Gamma_0, zero-point energy) of the excited state's
        ground vibrational state, displaced by dQ = sqrt(2 |S| / omega)
        sign(S)."""
        om, S = self.omega, self.huang_rhys
        dQ = np.sqrt(2.0 * np.abs(S) / om) * np.sign(S)
        return dQ, np.zeros_like(dQ), np.diag(om), float(np.sum(0.5 * om))

    def expand(self, q):
        """(V (n,), grad (n, d), Hessian diagonal (n, d)) at q (n, d)."""
        ex = torch.exp(-self.a * q)
        v = torch.sum(self.D * (1.0 - ex) ** 2, dim=1)
        grad = 2.0 * self.a * self.D * ex * (1.0 - ex)
        hess = 2.0 * self.a ** 2 * self.D * ex * (2.0 * ex - 1.0)
        return v, grad, hess


def draw(q0, p0, G0, Gi, normals, dtype):
    """The coherent-state draw: phase-space points (qi, pi) distributed as
    |<qi, pi, Gi | q0, p0, G0>|^2 and their log densities, from standard
    normals x (n, 2 r): z = z0 + x L^+, with L L^T the inverse covariance
    factored through the eigendecompositions of Gi + G0 (momenta) and
    Gi [Gi + G0]^+ G0 (positions), the zero modes left out."""
    G0 = np.asarray(G0, dtype=np.float64)
    Gi = np.asarray(Gi, dtype=np.float64)
    d = G0.shape[0]
    wp, Vp = np.linalg.eigh(G0 + Gi)
    nzp = wp > ZERO
    iGi0 = np.einsum("ij,j,kj->ik", Vp[:, nzp], 1.0 / wp[nzp], Vp[:, nzp])
    iLp = np.einsum("i,ji->ij", np.sqrt(wp[nzp] / 2.0), Vp[:, nzp])
    wq, Vq = np.linalg.eigh(Gi @ iGi0 @ G0)
    nzq = wq > ZERO
    iLq = np.einsum("i,ji->ij", 1.0 / np.sqrt(2.0 * wq[nzq]), Vq[:, nzq])
    r = int(np.count_nonzero(nzp))
    iLz = np.zeros((2 * r, 2 * d))
    iLz[:r, :d] = iLq
    iLz[r:, d:] = iLp
    log_det = float(np.sum(np.log(2.0)
                           + 0.5 * (np.log(wq[nzq]) - np.log(wp[nzp]))))
    x = normals.to(dtype)
    dev = x.device
    z = (torch.tensor(np.concatenate([q0, p0]), device=dev, dtype=dtype)[None]
         + x @ torch.tensor(iLz, device=dev, dtype=dtype))
    log_prob = log_det - d * math.log(2.0 * math.pi) - 0.5 * torch.sum(
        x * x, dim=1)
    return z[:, :d], z[:, d:], log_prob


def merge(results, stderr):
    """The results file's contents after the repetitions `results` (a list
    of dicts with "cauto", "kic", "ntraj" and, with `stderr`, "err_c" and
    "err_k"): trajectory-weighted means of C(t) and k~ic(t), and standard
    errors merged in quadrature with the same weights."""
    n = np.array([r["ntraj"] for r in results], dtype=np.float64)
    total = n.sum()
    out = {key: sum(w * np.asarray(r[key]) for w, r in zip(n, results))
           / total for key in ("cauto", "kic")}
    if stderr:
        for key in ("err_c", "err_k"):
            out[key] = np.sqrt(sum(w ** 2 * np.asarray(r[key]) ** 2
                                   for w, r in zip(n, results)) / total ** 2)
    out["trajectories"] = int(total)
    return out
