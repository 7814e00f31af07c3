# coding: utf-8
"""The `.npz` correlation-results protocol.

This file format is a compatibility contract with the reference
implementation (reference cli.py:344-476): results produced by either code
validate against the other, and the accumulate-on-restart semantics
(`overwrite: false`) double as the coarse-grained fault-tolerance/recovery
mechanism — a killed job loses at most one repetition batch.

Schema (dynamics): propagator, times, autocorrelation, ic_correlation,
adiabatic_gap, zero_point_energy, trajectories — plus, with the
`error_bars` task keyword, autocorrelation_stderr / ic_correlation_stderr
(per-step Monte-Carlo standard errors; beyond-reference keys that readers
of the reference format simply ignore).
Rates adds: broadening, hwhmG, hwhmL, energies (>= 0 slice), ic_rate.
"""

from __future__ import annotations

import contextlib
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["init_results", "accumulate_results", "load_results"]


@contextlib.contextmanager
def _results_lock(filename):
    """Inter-process advisory lock serialising read-modify-write cycles.

    The accumulation protocol is the multi-process scale-out path (SURVEY
    §2.2 P2: independent ensemble batches per process, weighted npz merge
    on the shared filesystem — the reference runs the same protocol across
    sequential invocations, reference cli.py:344-364). Concurrent
    processes MUST NOT interleave load/merge/replace, or a batch is lost;
    flock on a sidecar keeps the merge linearisable while the atomic
    os.replace in accumulate_results keeps crashes harmless. On
    filesystems without flock support the lock degrades to a no-op —
    the reference-compatible sequential semantics are unaffected.
    """
    lockfile = filename + ".lock"
    try:
        import fcntl
    except ImportError:                      # non-POSIX: sequential-only
        yield
        return
    fd = os.open(lockfile, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
        except OSError as exc:               # e.g. NFS without lockd
            logger.warning(f"results lock unavailable ({exc}); "
                           "concurrent accumulation is not protected")
        yield
    finally:
        os.close(fd)


def init_results(filename, propagator_name, times, adiabatic_gap,
                 zero_point_energy, overwrite=True):
    """Create (or validate an existing) results file.

    With overwrite=False and an existing file, the time grid and propagator
    are checked to be compatible so that new batches can be averaged in
    (reference cli.py:344-364).
    """
    times = np.asarray(times)
    with _results_lock(filename):
        if overwrite or not os.path.exists(filename):
            np.savez(
                filename,
                propagator=propagator_name,
                times=times,
                autocorrelation=np.zeros(times.shape, dtype=complex),
                ic_correlation=np.zeros(times.shape, dtype=complex),
                adiabatic_gap=adiabatic_gap,
                zero_point_energy=zero_point_energy,
                trajectories=0,
            )
        else:
            data = np.load(filename)
            if not np.array_equal(data["times"], times):
                raise ValueError(
                    f"Time steps in {filename} differ. Delete the old file "
                    "or change the grid for time propagation.")
            if str(data["propagator"]) != propagator_name:
                raise ValueError(
                    "Data produced with different propagators cannot be "
                    "added.")


def accumulate_results(filename, autocorrelation, ic_correlation, ntraj_new,
                       autocorrelation_stderr=None,
                       ic_correlation_stderr=None):
    """Merge one repetition into the running trajectory-weighted average

        F(1:n+m) = (n F(1:n) + m F(n:n+m)) / (n + m)

    and invalidate stale derived rates (reference cli.py:442-476).
    Returns the updated total trajectory count.

    Optional Monte-Carlo standard errors of the batch means merge in
    quadrature with the same trajectory weights,
    sigma^2 = sum_k (n_k / N)^2 sigma_k^2 (batches are independent). The
    stderr keys survive only while *every* contributing batch supplies
    them — accumulating a batch without error bars into a file that has
    them (or vice versa) drops the keys rather than storing a wrong value.
    """
    with _results_lock(filename):
        data = dict(np.load(filename))
        ntraj_old = int(data["trajectories"])
        ntraj_tot = ntraj_old + ntraj_new
        data["autocorrelation"] = (
            ntraj_new * np.asarray(autocorrelation)
            + ntraj_old * data["autocorrelation"]
        ) / ntraj_tot
        data["ic_correlation"] = (
            ntraj_new * np.asarray(ic_correlation)
            + ntraj_old * data["ic_correlation"]
        ) / ntraj_tot

        have_old = "autocorrelation_stderr" in data
        have_new = autocorrelation_stderr is not None
        if have_new and (have_old or ntraj_old == 0):
            old_e2_auto = (data["autocorrelation_stderr"] ** 2
                           if have_old else 0.0)
            old_e2_ic = (data["ic_correlation_stderr"] ** 2
                         if have_old else 0.0)
            data["autocorrelation_stderr"] = np.sqrt(
                (ntraj_new**2 * np.asarray(autocorrelation_stderr) ** 2
                 + ntraj_old**2 * old_e2_auto) / ntraj_tot**2)
            data["ic_correlation_stderr"] = np.sqrt(
                (ntraj_new**2 * np.asarray(ic_correlation_stderr) ** 2
                 + ntraj_old**2 * old_e2_ic) / ntraj_tot**2)
        elif have_old or have_new:
            logger.warning("error bars present for only part of the "
                           "accumulated batches — dropping the stderr keys")
            data.pop("autocorrelation_stderr", None)
            data.pop("ic_correlation_stderr", None)

        # C(0) = <phi(0)|phi(0)> must be 1: the initial conditions are
        # sampled from the normalised density |<qi,pi|q0,p0>|^2
        # (reference cli.py:460-467)
        logger.info(f"<phi(0)|phi(0)>= {data['autocorrelation'][0]}")
        c0 = data["autocorrelation"][0]
        if not abs(c0 - 1.0) < 1.0e-3:
            raise RuntimeError(f"<phi(0)|phi(0)> = {c0} is not 1 "
                               "(|C(0) - 1| >= 1e-3)")

        data["trajectories"] = ntraj_tot
        # derived spectra/rates are no longer up to date
        data.pop("ic_rate", None)
        data.pop("ic_rate_stderr", None)
        data.pop("spectrum", None)
        data.pop("spectrum_energies", None)
        data.pop("spectrum_stderr", None)
        # atomic replace: this file is the coarse-grained recovery unit — a
        # crash mid-write must not corrupt the accumulator
        tmp = filename + ".tmp.npz"
        np.savez(tmp, **data)
        os.replace(tmp, filename)
    return ntraj_tot


def load_results(filename):
    return dict(np.load(filename))
