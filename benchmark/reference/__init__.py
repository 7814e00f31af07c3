"""The benchmark's plain reference: straightforward PyTorch and NumPy that
recomputes what a cell's timed path produced, from the same inputs (the
model table, the width matrices, the standard normals) and from nothing the
program made. It imports no module of the program under test, and no JAX.

One module per propagator family; `for_cell(cell)` picks it by the name the
workload file gives under "reference".
"""

import importlib


def for_cell(cell):
    """The reference module named by the cell's workload file."""
    return importlib.import_module(f"reference.{cell.workload['reference']}")
