# coding: utf-8
"""Carry the JAX package's objects across to the port.

Each function takes the fields of one `semiclassical_tpu` object as plain
numpy arrays (a dict, `np.asarray` of each field; nested packs as nested
dicts) and returns the port's counterpart on `device`, so that both
packages can start from identical state. Tensors keep the dtypes of the
arrays given, so the reduced-precision packs, potentials and comp32 states
cross over as they are. The caller does the unpacking on the JAX side;
this module imports no jax.
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
    return None if x is None else torch.tensor(np.asarray(x), device=device)


def _torch_dtype(x):
    """The torch dtype of a numpy array's dtype."""
    return torch.from_numpy(np.zeros(0, dtype=np.asarray(x).dtype)).dtype


def molecular_harmonic_potential(f, device):
    """From the fields of `MolecularHarmonicPotential`, its
    `contract_dtype` name included ("" for the trajectory's)."""
    contract = f.get("contract_dtype", "")
    return MolecularHarmonicPotential.from_arrays(
        pos0=f["pos0"], energy0=float(f["energy0"]), grad0=f["grad0"],
        hess0=f["hess0"], nac0=f["nac0"], mass=f["mass"],
        origin=float(f["origin"]), device=device,
        contract_dtype=getattr(torch, contract) if contract else None)


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
    """From the fields of `MorsePotential`, at the dtype of its arrays,
    with its `hessian_eval` and `taylor_every`."""
    return MorsePotential.from_arrays(
        f["omega"], f["a"], f["D"], f["nac"], f["harmonic"], device,
        _torch_dtype(f["omega"]), f.get("hessian_eval", "stage"),
        f.get("taylor_every", 1))


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
        int(f["rank"]), device, diag_w=f.get("diag_w"),
        dtype=_torch_dtype(f["Gi_iGij_Gj"]))


def _wavefunction_params(f, device):
    return WavefunctionParams.from_arrays(f["G"], float(f["fac"]),
                                          int(f["rank"]), device,
                                          _torch_dtype(f["G"]))


def hk_params(f, device):
    """From the fields of `HKParams` at its dtypes (the factors' and the
    geometry constants'; the comp32 residuals q0c, p0c when present); the
    re/im planes of the factors are joined into complex factors, the
    separable-path scales diag_ka .. diag_ke are stacked, and the norm's
    csott and the wavefunction's wf are carried when present."""
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
                                                                  device),
        dtype=_torch_dtype(f["Lt_s_re"]), traj_dtype=_torch_dtype(f["q0"]),
        q0c=f.get("q0c"), p0c=f.get("p0c"))


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
    """From the fields of `WMParams` at its dtype (the HK pack is nested
    under "hk", whose U, iGi0 and G0 the port keeps in the WM pack at the
    WM dtype, and the separable path's WMDiagConsts under "diag")."""
    hk = f["hk"]
    return WMParams.from_arrays(
        hk_params(hk, device), device, U=hk["U"], iGi0=hk["iGi0"],
        G0=hk["G0"], **{name: f[name] for name in _WM_ARRAYS},
        alpha=f["alpha"], beta=f["beta"], auto_pref=f["auto_pref"],
        m_scale=f["m_scale"], m_log_det=f["m_log_det"],
        log_coef_pref=f["log_coef_pref"], dim=f["dim"],
        rank=f["rank"], scan_diag=f["scan_diag"], diag=f.get("diag"),
        dtype=_torch_dtype(f["Gt"]))


def wm_batch_constants(f, device):
    """From the fields of `WMBatchConstants` (the HK constants nested
    under "base")."""
    t = lambda name: _t(f[name], device)
    return WMBatchConstants(base=batch_constants(f["base"], device),
                            eps=t("eps"), PIq=t("PIq"), n1q=t("n1q"),
                            n2q=t("n2q"), z0=t("z0"))


def traj_state(f, device):
    """From the fields of a `TrajState` at its dtypes (the comp32 residuals
    qc, pc when present): the four dense monodromy blocks are stacked into
    Z (n, 2d, 2d), the (n, d) diagonal ones into the planes Z (4, n, d)."""
    blocks = [np.asarray(f[k]) for k in ("Mqq", "Mqp", "Mpq", "Mpp")]
    if blocks[0].ndim == 2:
        Z = np.stack(blocks)
    else:
        Z = np.concatenate([np.concatenate(blocks[:2], axis=2),
                            np.concatenate(blocks[2:], axis=2)], axis=1)
    return TrajState(q=_t(f["q"], device), p=_t(f["p"], device),
                     Z=_t(Z, device), S=_t(f["S"], device),
                     qc=_t(f.get("qc"), device), pc=_t(f.get("pc"), device))
