# coding: utf-8
"""Potential energy surfaces and their Hessian operators."""

from semiclassical_tpu_torch.potentials.base import (ConstHessian,
                                                     DenseHessian, DiagHessian)
from semiclassical_tpu_torch.potentials.model import (MorsePotential,
                                                      NonHarmonicPotential)
from semiclassical_tpu_torch.potentials.molecular import (
    MolecularGDMLPotential, MolecularHarmonicPotential, minimize)

__all__ = ["ConstHessian", "DenseHessian", "DiagHessian",
           "MolecularGDMLPotential", "MolecularHarmonicPotential",
           "MorsePotential",
           "NonHarmonicPotential", "minimize"]
