"""Least work of one WM step of coumarin on its sGDML force field: the
counts of `work/coumarin_sgdml.py`, whose `step` adds WM's three
Gauss-Jordan eliminations for a WM task."""

from work.coumarin_sgdml import k2, k4, step  # noqa: F401
