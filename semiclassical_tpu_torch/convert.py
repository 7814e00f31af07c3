# coding: utf-8
"""Carry the JAX package's objects across to the port.

Each function takes the fields of one `semiclassical_tpu` object as plain
numpy arrays (a dict, `np.asarray` of each field; nested packs as nested
dicts) and returns the port's counterpart on `device`, so that both
packages can start from identical state. The caller does the unpacking on
the JAX side; this module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from semiclassical_tpu_torch.coherent import OverlapParams, WavefunctionParams
from semiclassical_tpu_torch.gdml import GDMLParams
from semiclassical_tpu_torch.potentials.model import (MorsePotential,
                                                      NonHarmonicPotential)
from semiclassical_tpu_torch.potentials.molecular import (
    MolecularGDMLPotential, MolecularHarmonicPotential)
from semiclassical_tpu_torch.propagation.eom import LocalQuadratic
from semiclassical_tpu_torch.propagation.hk import BatchConstants, HKParams
from semiclassical_tpu_torch.propagation.state import TrajState
from semiclassical_tpu_torch.propagation.wm import WMBatchConstants, WMParams
from semiclassical_tpu_torch.sampling import SamplingParams

__all__ = ["molecular_harmonic_potential", "gdml_params",
           "molecular_gdml_potential", "local_quadratic", "morse_potential",
           "nonharmonic_potential", "sampling_params", "hk_params",
           "batch_constants", "wm_params", "wm_batch_constants",
           "traj_state"]


def _t(x, device):
    return torch.tensor(np.asarray(x), device=device)


def molecular_harmonic_potential(f, device):
    """From the fields of `MolecularHarmonicPotential` (f64 contractions)."""
    if f.get("contract_dtype", ""):
        raise ValueError("reduced-precision contractions are not ported")
    return MolecularHarmonicPotential.from_arrays(
        pos0=f["pos0"], energy0=float(f["energy0"]), grad0=f["grad0"],
        hess0=f["hess0"], nac0=f["nac0"], mass=f["mass"],
        origin=float(f["origin"]), device=device)


def gdml_params(f, device):
    """From the fields of `GDMLParams` (the f64 pack; the sliced operands
    of eg_mode "ozaki" are not carried: the port runs f64)."""
    t = lambda name: _t(f[name], device)
    return GDMLParams(
        xs_train=t("xs_train"), Jx_alphas=t("Jx_alphas"),
        pair_k=t("pair_k").long(), pair_l=t("pair_l").long(),
        incidence=t("incidence"), pair_outer=t("pair_outer"),
        sig=float(f["sig"]), c=float(f["c"]), std=float(f["std"]),
        n_atoms=int(f["n_atoms"]))


def molecular_gdml_potential(f, device):
    """From the fields of `MolecularGDMLPotential` (its `hess_dtype` name,
    "" for the pack's own)."""
    hess_dtype = f.get("hess_dtype", "")
    return MolecularGDMLPotential(
        gdml=gdml_params(f["gdml"], device), nac0=_t(f["nac0"], device),
        mass=_t(f["mass"], device), origin=float(f["origin"]),
        hess_dtype=(getattr(torch, hess_dtype)
                    if hess_dtype and hess_dtype != "float64" else None),
        hessian_eval=f.get("hessian_eval", "stage"),
        taylor_every=int(f.get("taylor_every", 1)))


def local_quadratic(f, device):
    """From the fields of the JAX package's `eom.LocalQuadratic`."""
    t = lambda name: None if f.get(name) is None else _t(f[name], device)
    return LocalQuadratic(q_mid=t("q_mid"), v0=t("v0"), g0=t("g0"), H=t("H"),
                          mass=t("mass"), nac0=t("nac0"), Tmono=t("Tmono"),
                          hessian_eval=f.get("hessian_eval", "taylor"))


def morse_potential(f, device):
    """From the fields of `MorsePotential` (the 4-stage Hessian mode)."""
    if f.get("hessian_eval", "stage") != "stage" or f.get("taylor_every",
                                                           1) != 1:
        raise ValueError("reduced-cost Hessian evaluation is not ported")
    return MorsePotential.from_arrays(f["omega"], f["a"], f["D"], f["nac"],
                                      f["harmonic"], device)


def nonharmonic_potential(f, device):
    """From the fields of `NonHarmonicPotential`."""
    return NonHarmonicPotential(eps=_t(f["eps"], device),
                                b=_t(f["b"], device))


def sampling_params(f, device):
    """From the fields of `SamplingParams`."""
    return SamplingParams.from_arrays(
        z0=f["z0"], iLz=f["iLz"], log_detLz=float(f["log_detLz"]), U=f["U"],
        iGi0=f["iGi0"], dim=int(f["dim"]), rank=int(f["rank"]),
        device=device)


def _overlap_params(f, device):
    return OverlapParams.from_arrays(
        f["Gi_iGij_Gj"], f["iGij"], f["Gj_iGij"], complex(f["fac"]),
        int(f["rank"]), device, diag_w=f.get("diag_w"))


def _wavefunction_params(f, device):
    return WavefunctionParams.from_arrays(f["G"], float(f["fac"]),
                                          int(f["rank"]), device)


def hk_params(f, device):
    """From the fields of `HKParams` (the f64 mode: no comp32 residuals);
    the re/im planes of the factors are joined into complex factors, the
    separable-path scales diag_ka .. diag_ke are stacked, and the norm's
    csott and the wavefunction's wf are carried when present."""
    if f.get("q0c") is not None:
        raise ValueError("comp32 parameter packs are not ported")
    plane = lambda name: (np.asarray(f[name + "_re"])
                          + 1j * np.asarray(f[name + "_im"]))
    scales = [f.get(f"diag_k{x}") for x in "abce"]
    diag = {"diag_k": None if scales[0] is None else np.stack(scales),
            "R_diag": f.get("R_diag"), "shift_diag": f.get("shift_diag")}
    return HKParams.from_factors(
        Lt_s=plane("Lt_s"), Lt_i=plane("Lt_i"), Ri_s=plane("Ri_s"),
        Ri_i=plane("Ri_i"), q0=f["q0"], p0=f["p0"], G0=f["G0"],
        iGi0=f["iGi0"], R=f["R"],
        csoi0=_overlap_params(f["csoi0"], device),
        csot0=_overlap_params(f["csot0"], device), device=device,
        diag=diag,
        csott=(None if f.get("csott") is None
               else _overlap_params(f["csott"], device)),
        wf=None if f.get("wf") is None else _wavefunction_params(f["wf"],
                                                                  device))


def batch_constants(f, device):
    """From the fields of `BatchConstants`."""
    t = lambda name: _t(f[name], device)
    return BatchConstants(
        qi=t("qi"), pi=t("pi"), log_prob=t("log_prob"), weight=t("weight"),
        logw_norm=t("logw_norm"),
        log_weight_scale=float(f["log_weight_scale"]), vi=t("vi"),
        obs_re=t("obs_re"), obs_im=t("obs_im"), nacq=t("nacq"))


_WM_ARRAYS = ("Gt", "A_const", "BqU", "G0U", "UtG0U", "Cqq", "G0iGi0", "Dbal",
              "U1", "U2", "A_const_b", "BqUb", "Fq", "C2b", "M0")


def wm_params(f, device):
    """From the fields of `WMParams` (the f64 pack; the HK pack is nested
    under "hk", whose U, iGi0 and G0 the port keeps in the WM pack, and the
    separable path's WMDiagConsts under "diag")."""
    hk = f["hk"]
    return WMParams.from_arrays(
        hk_params(hk, device), device, U=hk["U"], iGi0=hk["iGi0"],
        G0=hk["G0"], **{name: f[name] for name in _WM_ARRAYS},
        alpha=f["alpha"], beta=f["beta"], auto_pref=f["auto_pref"],
        m_scale=f["m_scale"], m_log_det=f["m_log_det"],
        log_coef_pref=f["log_coef_pref"], dim=f["dim"],
        rank=f["rank"], scan_diag=f["scan_diag"], diag=f.get("diag"))


def wm_batch_constants(f, device):
    """From the fields of `WMBatchConstants` (the HK constants nested
    under "base")."""
    t = lambda name: _t(f[name], device)
    return WMBatchConstants(base=batch_constants(f["base"], device),
                            eps=t("eps"), PIq=t("PIq"), n1q=t("n1q"),
                            n2q=t("n2q"), z0=t("z0"))


def traj_state(f, device):
    """From the fields of an f64 `TrajState`: the four dense monodromy
    blocks are stacked into Z (n, 2d, 2d), the (n, d) diagonal ones into
    the planes Z (4, n, d)."""
    if f.get("qc") is not None:
        raise ValueError("comp32 trajectory states are not ported")
    blocks = [np.asarray(f[k]) for k in ("Mqq", "Mqp", "Mpq", "Mpp")]
    if blocks[0].ndim == 2:
        Z = np.stack(blocks)
    else:
        Z = np.concatenate([np.concatenate(blocks[:2], axis=2),
                            np.concatenate(blocks[2:], axis=2)], axis=1)
    return TrajState(q=_t(f["q"], device), p=_t(f["p"], device),
                     Z=_t(Z, device), S=_t(f["S"], device))
