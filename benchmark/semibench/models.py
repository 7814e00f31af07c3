"""The configurations' model files, made from their formulas at run time
(nothing is downloaded) or taken from the repository's data."""

import os

import numpy as np

from semibench.cell import ROOT


def as_model_text(spec):
    """The AS model table of `examples/as_model/make_model.py`: modes with
    omega ~ U(omega_cm), S ~ U(huang_rhys), NAC ~ U(nac) drawn in that
    order from numpy's default_rng(rng_seed), one chi for all, written
    with the script's rounding."""
    rng = np.random.default_rng(spec["rng_seed"])
    n = spec["num_modes"]
    omega = rng.uniform(*spec["omega_cm"], size=n)
    S = rng.uniform(*spec["huang_rhys"], size=n)
    nac = rng.uniform(*spec["nac"], size=n)
    lines = ["# AS model: frequency/cm-1, Huang-Rhys S, NAC, chi"]
    lines += [f"{w:12.4f} {s:12.6f} {c:12.6f} {spec['chi']:8.4f}"
              for w, s, c in zip(omega, S, nac)]
    return "\n".join(lines) + "\n"


# the potential block's keys that name files, from the checkout's root
FILE_KEYS = ("model_file", "ground", "excited", "coupling")


def resolve(potential, directory):
    """The potential block as the port reads it: its files as absolute
    paths, and an AS model's `model` written into `directory` as
    `model_file`."""
    out = {k: str(ROOT / v) if k in FILE_KEYS else v
           for k, v in potential.items() if k != "model"}
    if "model" in potential:
        out["model_file"] = os.path.join(directory, "AS_model.dat")
        with open(out["model_file"], "w") as f:
            f.write(as_model_text(potential["model"]))
    return out


def table(path):
    """The model table (modes, 4) of a model file (None without one)."""
    return None if path is None else np.loadtxt(path, ndmin=2)
