# coding: utf-8
"""Typed validation of the JSON task schema.

The input document format is the compatibility contract
{"semi": [task, ...]} with the keywords documented in the reference README
(reference README.rst:140-302); the reference resolves them with bare
`task.get(key, default)` and silently ignores unknown keys
(SURVEY §5 config). Here every task is validated against a typed schema
before running: wrong types fail fast with a clear message and unknown keys
produce a warning naming the closest valid keyword.
"""

from __future__ import annotations

import difflib
import logging

logger = logging.getLogger(__name__)

__all__ = ["validate_task", "ConfigurationError"]


class ConfigurationError(Exception):
    pass


_POTENTIAL_KEYS = {
    "harmonic": {"type": str, "ground": str, "excited": str, "coupling": str},
    "gdml": {"type": str, "ground": str, "excited": str, "coupling": str,
             "hess_dtype": str, "hessian_eval": str, "taylor_every": int,
             "eg_mode": str},
    "anharmonic AS": {"type": str, "model_file": str,
                      "hessian_eval": str, "taylor_every": int},
}

# Keys that are resolved with a default at the use site (reference resolves
# *every* potential keyword with `.get`, reference cli.py:210-216) — they
# are type-checked when present but never demanded.
_POTENTIAL_OPTIONAL = {
    "harmonic": set(),
    "gdml": {"hess_dtype", "hessian_eval", "taylor_every", "eg_mode"},
    "anharmonic AS": {"hessian_eval", "taylor_every"},
}

_DYNAMICS_SCHEMA = {
    "task": str,
    "potential": dict,
    "propagator": str,            # "HK" | "WM"
    "batch_size": int,
    "num_trajectories": int,
    "num_steps": int,
    "time_step_fs": (int, float),
    "cell_width": (int, float),   # WM alpha = beta
    "integrator": str,            # "rk4" | "exact" (closed-form Morse map)
    "results": dict,
    "manual_seed": int,
    "calc_norm_every": int,
    "norm_samples": int,          # >0: subsampled norm estimate +- stderr
    "scan_chunk": int,
    "micro_batch": int,           # device-side sub-batch size (0 = off)
    "checkpoint": str,            # mid-batch checkpoint file ("" = off)
    "checkpoint_every": int,      # steps between checkpoint snapshots
    "error_bars": bool,           # per-step MC standard errors in the npz
    "sampling": str,              # "pseudo" | "antithetic" | "sobol"
    "export_initial": str,
    "export_final": str,
}

_RATES_SCHEMA = {
    "task": str,
    "broadening": str,            # gaussian | lorentzian | voigtian
    "hwhmG_ev": (int, float),
    "hwhmL_ev": (int, float),
    "correlations": str,
    "rates": str,
}

_SPECTRUM_SCHEMA = {
    "task": str,
    "broadening": str,            # gaussian | lorentzian | voigtian
    "hwhmG_ev": (int, float),
    "hwhmL_ev": (int, float),
    "correlations": str,
    "spectra": str,
    # alias for `spectra` matching the task's name (the rates task's output
    # key is likewise its own name) — `spectra` wins when both are given
    "spectrum": str,
}

_RESULTS_SCHEMA = {
    "correlations": str,
    "overwrite": bool,
}

_REQUIRED = {
    "dynamics": ("potential", "num_steps", "time_step_fs", "results"),
    "rates": (),
    "spectrum": (),
}


def _check_keys(section, data, schema):
    for key, value in data.items():
        if key not in schema:
            close = difflib.get_close_matches(key, schema.keys(), n=1)
            hint = f" — did you mean '{close[0]}'?" if close else ""
            logger.warning(
                f"unknown keyword '{key}' in {section} section{hint}")
            continue
        expected = schema[key]
        if not isinstance(value, expected):
            raise ConfigurationError(
                f"{section}: keyword '{key}' should be of type "
                f"{expected}, got {type(value).__name__} ({value!r})")


def validate_task(task):
    """Validate one task dict; raises ConfigurationError on hard errors."""
    kind = task.get("task")
    if kind not in ("dynamics", "rates", "spectrum"):
        raise ConfigurationError(
            f"task type should be 'dynamics', 'rates' or 'spectrum', "
            f"got {kind!r}")

    schema = {"dynamics": _DYNAMICS_SCHEMA, "rates": _RATES_SCHEMA,
              "spectrum": _SPECTRUM_SCHEMA}[kind]
    _check_keys(f"'{kind}' task", task, schema)

    for key in _REQUIRED[kind]:
        if key not in task:
            raise ConfigurationError(
                f"'{kind}' task is missing the required keyword '{key}'")

    if kind == "dynamics":
        pot = task["potential"]
        ptype = pot.get("type")
        if ptype not in _POTENTIAL_KEYS:
            raise ConfigurationError(
                f"potential type should be one of {list(_POTENTIAL_KEYS)}, "
                f"got {ptype!r}")
        _check_keys(f"potential ({ptype})", pot, _POTENTIAL_KEYS[ptype])
        for key in _POTENTIAL_KEYS[ptype]:
            if key not in pot and key not in _POTENTIAL_OPTIONAL[ptype]:
                raise ConfigurationError(
                    f"potential ({ptype}) is missing the required keyword "
                    f"'{key}'")
        _check_keys("results", task["results"], _RESULTS_SCHEMA)
        if task.get("propagator", "HK") not in ("HK", "WM"):
            raise ConfigurationError(
                f"propagator should be 'HK' or 'WM', "
                f"got {task['propagator']!r}")
    else:
        if task.get("broadening", "gaussian") not in (
                "gaussian", "lorentzian", "voigtian"):
            raise ConfigurationError(
                "'broadening' should be one of 'gaussian', 'lorentzian' or "
                f"'voigtian', got {task['broadening']!r}")
    return task
