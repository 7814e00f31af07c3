# coding: utf-8
"""Build and load the port's CUDA kernels.

The sources under `csrc/*.cu` are compiled by `nvcc` for Hopper (sm_90a)
into one shared library with a plain C interface, at first use, into
`build/kernels/` at the root of the checkout. The library's name carries a
hash of the sources and of the compiler command, so an edited source is
rebuilt and an unchanged one is loaded as it is. The library is bound with
ctypes: every pointer and the stream pass as `c_void_p`, and every entry
point returns `cudaGetLastError()` after its launch.

Nothing here runs when the package is imported; `load()` is called by the
wrappers the first time a tensor on the card reaches them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["load", "build_log", "CSRC", "BUILD_DIR"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

# entry point -> argtypes (all return int: the cudaError_t of the launch)
_ENTRY_POINTS = {
    "semi_det_lu_c128": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_void_p),
    "semi_det_lu_c64": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_void_p),
}

_lib = None
_log = ""


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin): the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def load():
    """Build the kernel library if needed and return the loaded ctypes
    handle with its entry points declared."""
    global _lib, _log
    if _lib is not None:
        return _lib
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    target = BUILD_DIR / f"libsemi_kernels_{digest.hexdigest()[:16]}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name and rename: concurrent first uses never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{_log}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return _lib


def build_log():
    """The compiler's output of the build this process made ("" when the
    library was already built): nvcc's -Xptxas=-v register and
    shared-memory report per kernel."""
    return _log
