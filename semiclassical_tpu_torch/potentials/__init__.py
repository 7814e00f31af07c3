# coding: utf-8
"""Potential energy surfaces and their Hessian operators."""

from semiclassical_tpu_torch.potentials.base import (ConstHessian,
                                                     DenseHessian, DiagHessian)
from semiclassical_tpu_torch.potentials.model import (MorsePotential,
                                                      NonHarmonicPotential)
from semiclassical_tpu_torch.potentials.molecular import (
    MolecularHarmonicPotential, minimize)

__all__ = ["ConstHessian", "DenseHessian", "DiagHessian",
           "MolecularHarmonicPotential", "MorsePotential",
           "NonHarmonicPotential", "minimize"]
