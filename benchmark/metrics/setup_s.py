"""Process start (the first line of run.py) to the window's start:
imports, the CUDA context, the kernels from their build cache, the
potential, the warm-up of each block length. Host clock."""


def read(run):
    return run.setup_s
