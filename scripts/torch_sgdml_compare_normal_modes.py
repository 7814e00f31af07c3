#!/usr/bin/env python
# coding: utf-8
"""Compare normal modes and frequencies of an sGDML force field with the
quantum-chemistry reference, on the PyTorch port (semiclassical_tpu_torch);
the twin of scripts/sgdml_compare_normal_modes.py, with the same arguments,
table and exit codes.

The sGDML PES is minimised starting from the QM geometry, its analytic
Hessian is mass-weighted and diagonalised, and the resulting vibrational
frequencies are tabulated against the frequencies recomputed from the QM
checkpoint's force constants.

Usage:
    python torch_sgdml_compare_normal_modes.py model.npz freq.fchk [out.dat]
        [--device cuda|cpu]
"""

import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from semiclassical_tpu_torch import units  # noqa: E402
from semiclassical_tpu_torch.gdml import gdml_forward  # noqa: E402
from semiclassical_tpu_torch.io import FormattedCheckpointFile  # noqa: E402
from semiclassical_tpu_torch.potentials import (  # noqa: E402
    MolecularGDMLPotential, minimize)


def split_device(argv, default="cuda"):
    """(argv without `--device NAME`, NAME or `default`)."""
    argv = list(argv)
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a name (cuda or cpu)")
        device = argv[i + 1]
        del argv[i:i + 2]
        return argv, device
    return argv, default


def vibrational_frequencies(hess, masses):
    """Frequencies (Hartree) and mass-weighted modes from a cartesian
    Hessian; the 6 lowest (rigid-body) modes are included."""
    imsq = 1.0 / np.sqrt(masses)
    mwh = np.einsum("i,ij,j->ij", imsq, hess, imsq)
    w2, modes = np.linalg.eigh(mwh)
    freqs = np.sign(w2) * np.sqrt(np.abs(w2))
    return freqs, modes


def main(argv):
    argv, device = split_device(argv)
    if len(argv) < 3:
        print(__doc__)
        return 1
    model_file, fchk_file = argv[1], argv[2]
    out_file = argv[3] if len(argv) > 3 else "normal_mode_comparison.dat"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")

    model = np.load(model_file, allow_pickle=True)
    with open(fchk_file) as f:
        fchk = FormattedCheckpointFile(f)

    masses = fchk.masses()
    pos_qm, _, _, hess_qm = fchk.harmonic_approximation()

    potential = MolecularGDMLPotential.create(model, fchk, device)
    potential = minimize(potential, np.asarray(pos_qm))

    # the minimisation returns only the origin; the optimised geometry
    # comes from a short Newton walk through the same expansion
    r = torch.as_tensor(np.asarray(pos_qm), dtype=torch.float64,
                        device=device)
    for _ in range(100):
        _, g, h = potential.local_expansion(r[None, :])
        r = r + torch.linalg.solve(h.dense()[0], -g[0])
        if float(torch.linalg.norm(g[0])) < 1e-8:
            break

    hess_ml = gdml_forward(potential.gdml, r[None, :],
                           order=2)[2][0].cpu().numpy()

    freqs_qm, modes_qm = vibrational_frequencies(hess_qm, masses)
    freqs_ml, modes_ml = vibrational_frequencies(hess_ml, masses)

    # mode overlap matrix |<qm_i|ml_j>| for assignment
    overlap = np.abs(modes_qm.T @ modes_ml)

    with open(out_file, "w") as f:
        f.write("# Normal-mode comparison: sGDML vs QM reference\n")
        f.write(f"# model: {model_file}\n# fchk:  {fchk_file}\n")
        f.write("# mode   freq_QM/cm-1   freq_sGDML/cm-1   diff/cm-1   "
                "best-overlap\n")
        cm = units.hartree_to_wavenumbers
        for i in range(len(freqs_qm)):
            j = int(np.argmax(overlap[i]))
            f.write(f"{i:5d} {freqs_qm[i] * cm:14.2f} "
                    f"{freqs_ml[j] * cm:16.2f} "
                    f"{(freqs_ml[j] - freqs_qm[i]) * cm:10.2f} "
                    f"{overlap[i, j]:12.4f}\n")
    print(f"wrote {out_file}")

    rms = np.sqrt(np.mean(((freqs_ml[6:] - freqs_qm[6:])
                           * units.hartree_to_wavenumbers) ** 2))
    print(f"RMS frequency deviation (internal modes): {rms:.2f} cm-1")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
