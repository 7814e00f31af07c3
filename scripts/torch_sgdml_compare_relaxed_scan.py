#!/usr/bin/env python
# coding: utf-8
"""Compare sGDML energies along a sequence of geometries (e.g. a relaxed
scan) with reference QM energies, on the PyTorch port
(semiclassical_tpu_torch); the twin of
scripts/sgdml_compare_relaxed_scan.py, with the same arguments, table and
exit codes.

Input: an (extended) XYZ trajectory whose comment lines carry the QM energy
as `energy=<value>` (Hartree), or a plain XYZ plus a separate energy table.

Usage:
    python torch_sgdml_compare_relaxed_scan.py model.npz scan.xyz [out.dat]
        [--device cuda|cpu]
"""

import pathlib
import re
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from semiclassical_tpu_torch import units  # noqa: E402
from semiclassical_tpu_torch.gdml import GDMLParams, gdml_forward  # noqa: E402
from torch_sgdml_compare_normal_modes import split_device  # noqa: E402


def read_xyz_frames(path):
    """Yield (symbols, coords_angstrom, comment) frames from an XYZ file."""
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        nat = int(lines[i].split()[0])
        comment = lines[i + 1].rstrip("\n")
        block = lines[i + 2:i + 2 + nat]
        symbols = [ln.split()[0] for ln in block]
        coords = np.array([[float(v) for v in ln.split()[1:4]]
                           for ln in block])
        yield symbols, coords, comment
        i += 2 + nat


def main(argv):
    argv, device = split_device(argv)
    if len(argv) < 3:
        print(__doc__)
        return 1
    model_file, xyz_file = argv[1], argv[2]
    out_file = argv[3] if len(argv) > 3 else "relaxed_scan_comparison.dat"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")

    model = np.load(model_file, allow_pickle=True)
    params = GDMLParams.from_npz(model, device)

    geometries = []
    energies_qm = []
    for _, coords, comment in read_xyz_frames(xyz_file):
        geometries.append((coords / units.bohr_to_angs).reshape(-1))
        m = re.search(r"energy\s*=\s*([-+0-9.eEdD]+)", comment)
        energies_qm.append(float(m.group(1).replace("D", "E"))
                           if m else np.nan)

    r = torch.as_tensor(np.stack(geometries), dtype=torch.float64,
                        device=device)
    energies_ml = gdml_forward(params, r, order=0).cpu().numpy()
    energies_qm = np.asarray(energies_qm)

    # align by mean over frames with available QM energies
    have_qm = np.isfinite(energies_qm)
    shift = (np.mean(energies_ml[have_qm] - energies_qm[have_qm])
             if have_qm.any() else 0.0)

    with open(out_file, "w") as f:
        f.write("# sGDML vs QM energies along the scan\n")
        f.write(f"# model: {model_file}\n# scan:  {xyz_file}\n")
        f.write(f"# constant shift applied to sGDML: {shift} Hartree\n")
        f.write("# frame   E_QM/Hartree        E_sGDML/Hartree     "
                "diff/(kcal/mol)\n")
        for i, (eq, em) in enumerate(zip(energies_qm, energies_ml - shift)):
            diff_kcal = (em - eq) * 627.509474 if np.isfinite(eq) else np.nan
            f.write(f"{i:7d} {eq:19.8f} {em:19.8f} {diff_kcal:16.4f}\n")
    print(f"wrote {out_file}")
    if have_qm.any():
        rms = np.sqrt(np.mean(
            ((energies_ml - shift - energies_qm)[have_qm] * 627.509474) ** 2))
        print(f"RMS deviation: {rms:.4f} kcal/mol")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
