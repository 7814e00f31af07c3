# coding: utf-8
"""Units and conversion factors (atomic units throughout).

Same constants as `semiclassical_tpu.units`.
Atomic units: hbar = h/(2 pi) = 1, mass_electron = 1.
"""

hbar = 1.0

# conversion factors
hartree_to_wavenumbers = 219474.63   # E(cm^-1) = E(Hartree) * hartree_to_wavenumbers
hartree_to_ev = 27.211396132
bohr_to_angs = 0.529177249
autime_to_fs = 0.02418884326505

# converts masses from amu (multiples of 1/12 x mass of C-12)
# to atomic units (multiples of electron mass)
amu_to_aumass = 1822.888486192
