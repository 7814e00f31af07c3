# coding: utf-8
"""Reader for Gaussian 16 / QChem formatted checkpoint files (*.fchk).

Capability parity with reference readers.py:29-396 (field parsing, harmonic
approximation, vibrational ground state with projection of translations and
rotations, masses, NAC extraction). Host-side numpy throughout — this runs
once per job; the resulting arrays (Gamma_0, Hessian, NAC vector) are the
constants that are moved to the device for the propagation. The same reader
as `semiclassical_tpu.io.fchk`, carried over as a file of its own because
that package imports jax when it is imported.

Unlike the reference this does not depend on ASE: the center of mass and the
principal axes of the inertia tensor are computed directly (~15 lines).
"""

__all__ = ["FormattedCheckpointFile"]

import re
import logging
from collections import OrderedDict

import numpy as np

from semiclassical_tpu_torch import units
from semiclassical_tpu_torch.units import hbar

logger = logging.getLogger(__name__)


class FormattedCheckpointFile:
    """Reads all fields from a formatted checkpoint file.

    Parameters
    ----------
    f : file object
        handle opened for reading; the caller manages open/close

    Array fields are stored as 1D numpy arrays of float (R) or integer (I)
    type and can be accessed by name, e.g. ``fchk["Number of atoms"]``.
    """

    def __init__(self, f):
        self.filename = getattr(f, "name", "<stream>")
        self.data = OrderedDict()
        self.bad_fields = set()  # fields that failed to parse
        acc = ""           # accumulates continuation lines of the current field
        field = None
        dtype = None
        count = 0

        def flush():
            if field is None or dtype is None or len(acc) == 0:
                return
            if dtype is str:
                self.data[field] = acc
                return
            try:
                tokens = acc.split()
                array = np.fromiter((dtype(t) for t in tokens), dtype=dtype,
                                    count=len(tokens))
                if len(array) != count:
                    raise ValueError(f"expected {count} values, found "
                                     f"{len(array)}")
                self.data[field] = array
            except ValueError as err:
                # remember the failure: accessing a corrupt field later must
                # be an error, not a silently-zero Hessian
                logger.warning(
                    f"problem reading field `{field}` in {self.filename}: {err}"
                )
                self.bad_fields.add(field)
                self.data[field] = np.zeros(count, dtype=dtype)

        for line_number, line in enumerate(f.readlines(), start=1):
            # A field name starts in the first column with a capital letter.
            if re.match(r"^[A-Z].*", line):
                flush()
                acc = ""
                field, dtype = None, None
                if len(line) < 43:
                    # title / method lines
                    continue
                try:
                    name = line[0:43].strip()
                    type_char = line[43]
                    if type_char == "I":
                        dt = int
                    elif type_char == "R":
                        dt = float
                    elif type_char == "C":
                        dt = str
                    else:
                        continue
                    if line[47:49] == "N=":
                        # array field: element count follows
                        field, dtype = name, dt
                        count = int(line[49:])
                    else:
                        self.data[name] = dt(line[49:])
                except Exception as err:
                    logger.error(
                        f"error reading line {line_number} in {self.filename}"
                    )
                    raise err
            else:
                acc += " " + line
        flush()

    def __getitem__(self, key):
        if key in self.bad_fields:
            raise ValueError(
                f"field `{key}` in {self.filename} failed to parse "
                "(see warning above); refusing to return zero-filled data"
            )
        return self.data[key]

    def __contains__(self, key):
        return key in self.data

    def keys(self):
        return self.data.keys()

    # ------------------------------------------------------------------
    # derived quantities
    # ------------------------------------------------------------------

    def harmonic_approximation(self):
        """Position, energy, gradient and (symmetrised) Hessian in cartesians.

        The checkpoint stores only the lower triangle of the force-constant
        matrix (reference readers.py:181-186).

        Returns
        -------
        pos : ndarray (3 nat,)
        energy : ndarray (1,)
        grad : ndarray (3 nat,)
        hess : ndarray (3 nat, 3 nat)
        """
        try:
            nat = self.data["Number of atoms"]
            energy = np.array(self.data["Total Energy"])
            pos = self.data["Current cartesian coordinates"]
            grad = self.data["Cartesian Gradient"]
            hess = np.zeros((3 * nat, 3 * nat))
            row, col = np.tril_indices(3 * nat)
            hess[row, col] = self.data["Cartesian Force Constants"]
            hess[col, row] = hess[row, col]
        except KeyError as err:
            logger.error(
                f"required field missing in checkpoint file {self.filename}"
            )
            raise err
        return pos, energy, grad, hess

    def nonadiabatic_coupling(self):
        """First-order derivative coupling vector <0|d/dx|I> (3 nat,)."""
        try:
            nac = self.data["Nonadiabatic coupling"]
        except KeyError as err:
            logger.error(
                f"field `Nonadiabatic coupling` missing in {self.filename}"
            )
            raise err
        if (nac == 0.0).all():
            logger.warning(
                f"all components of the NAC vector in {self.filename} are zero"
            )
        return nac

    def masses(self):
        """Atomic masses per cartesian coordinate in multiples of m_e (3 nat,)."""
        mass = self.data["Real atomic weights"] * units.amu_to_aumass
        return np.repeat(mass, 3)

    def atomic_numbers(self):
        return self.data["Atomic numbers"]

    def total_energy(self):
        return self.data["Total Energy"]

    def vibrational_groundstate(self, zero_threshold=100.0):
        """Width matrix Gamma_0 of the vibrational ground state.

        The ground state of the harmonic potential around the minimum x0 is

            psi0(x) = (det(Gamma0)/pi^N)^{1/4}
                      exp(-1/2 (x-x0)^T Gamma0 (x-x0))

        Translational and rotational modes are projected out before building
        Gamma_0 = L L^T with L = hbar^{-1/2} M^{1/2} D Vi w^{1/2}
        (reference readers.py:210-363).

        Returns
        -------
        x0 : ndarray (3 nat,)       center (bohr)
        Gamma0 : ndarray (3 nat, 3 nat)  positive semi-definite (bohr^-2)
        en_zpt : float              zero-point energy (Hartree)
        """
        x0, energy, grad, hess = self.harmonic_approximation()
        mass = self.masses()
        msq = np.sqrt(mass)
        imsq = 1.0 / msq

        # mass-weighted Hessian
        hess_mwc = np.einsum("i,ij,j->ij", imsq, hess, imsq)
        w2, V = np.linalg.eigh(hess_mwc)
        w = np.sqrt(w2 + 0j)
        logger.info(
            "normal mode frequencies (cm-1) before eliminating "
            f"translation/rotation: {w * units.hartree_to_wavenumbers}"
        )

        # --- construct rigid-body modes (translations + rotations) ---------
        pos = x0.reshape(-1, 3)
        atom_masses = mass[::3]
        total_mass = atom_masses.sum()
        center = (atom_masses[:, None] * pos).sum(axis=0) / total_mass
        logger.info(f"center of mass (Ang): {center * units.bohr_to_angs}")
        r = pos - center

        # inertia tensor and its principal axes
        inertia = np.zeros((3, 3))
        for m_a, r_a in zip(atom_masses, r):
            inertia += m_a * (np.dot(r_a, r_a) * np.eye(3) - np.outer(r_a, r_a))
        principal_moments, Xrot_cols = np.linalg.eigh(inertia)
        # rows of Xrot are the principal axes (matching ASE's convention in
        # the reference, readers.py:269-270)
        Xrot = Xrot_cols.T

        dim = hess_mwc.shape[0]
        nat = dim // 3
        D = np.zeros_like(hess_mwc)
        mwc = msq.reshape((-1, 3)) * r

        # translations: rigid shifts along x, y, z weighted by sqrt(m)
        for i in (0, 1, 2):
            D[i::3, i] = msq[i::3]

        # rotations about principal axes with non-zero moment
        nz = 3
        moment_scale = np.max(np.abs(principal_moments)) if nat > 1 else 0.0
        for i in (0, 1, 2):
            if principal_moments[i] > 1e-12 * max(moment_scale, 1.0):
                D[:, nz] = np.cross(Xrot[i, :], mwc).reshape(-1)
                nz += 1

        for i in range(nz):
            D[:, i] /= np.linalg.norm(D[:, i])

        # modified Gram-Schmidt for the remaining (internal) directions
        for n in range(nz, dim):
            D[:, n] = V[:, n]
            for m in range(n):
                D[:, n] -= np.dot(D[:, m], D[:, n]) * D[:, m]
            D[:, n] /= np.linalg.norm(D[:, n])

        err = np.linalg.norm(D.T @ D - np.eye(dim))
        if not err < 1.0e-10:
            raise RuntimeError(
                f"Gram-Schmidt orthogonalization failed, |D^T.D - Id| = {err}")

        logger.info(f"rotational/translational modes: {nz}")
        if nz == 3:
            logger.error(
                "all principal moments of inertia are zero — single atom?"
            )
        elif nz == 5:
            logger.info("found a linear molecule")
        elif nz == 6:
            logger.info("found a non-linear molecule")
        else:
            logger.error(
                f"unexpected number of rigid-body modes: {nz} "
                "(expected 3, 5 or 6)"
            )

        # transform mass-weighted Hessian to internal coordinates
        hess_internal = D.T @ hess_mwc @ D

        # external zero modes (logged only)
        wz2, _ = np.linalg.eigh(hess_internal[:nz, :nz])
        wz = np.sqrt(wz2 + 0j)
        logger.info(
            "frequencies (cm-1) of translations and rotations: "
            f"{wz * units.hartree_to_wavenumbers}"
        )

        # internal vibrational modes
        wi2, Vi = np.linalg.eigh(hess_internal[nz:, nz:])
        wi = np.sqrt(wi2)
        logger.info(
            "vibrational frequencies (cm-1) after eliminating "
            f"translation/rotation: {wi * units.hartree_to_wavenumbers}"
        )
        if not (wi * units.hartree_to_wavenumbers > 0.0).all():
            logger.error(
                "at a minimum all vibrational frequencies should be positive, "
                "found imaginary ones"
            )

        en_zpt = 0.5 * hbar * np.sum(wi)
        logger.info(
            f"zero point energy (cm-1): {en_zpt * units.hartree_to_wavenumbers}"
        )

        # normal modes back in mass-weighted cartesians
        Vmw = D[:, nz:] @ Vi
        L = hbar ** (-0.5) * np.einsum("i,ij,j->ij", msq, Vmw, np.sqrt(wi))
        Gamma_0 = L @ L.T

        return x0, Gamma_0, float(en_zpt)
