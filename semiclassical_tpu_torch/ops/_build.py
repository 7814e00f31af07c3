# coding: utf-8
"""Build, load and launch the port's CUDA kernels.

The sources under `csrc/*.cu` are compiled by `nvcc` for Hopper (sm_90a)
into one shared library with a plain C interface, at first use, into
`build/kernels/` at the root of the checkout: one `nvcc -c` per source, all
started together, then one link. The library's name carries a
hash of the sources, of the headers they share (`csrc/*.cuh`) and of the
compiler command, so an edited source is rebuilt and an unchanged one is
loaded as it is. The library is bound with ctypes: every pointer and the
stream pass as `c_void_p`, and every entry point returns
`cudaGetLastError()` after its launch.

Nothing here runs when the package is imported; `load()` is called by the
wrappers the first time a tensor on the card reaches them. A wrapper's
launch is `launch(entry(kernel, dtype), device, *args)`: the entry point is
looked up once per kernel and type, and the device context is entered only
for a tensor that is not on the current device, so that a call costs the
host little more than the ctypes call itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["load", "entry", "launch", "build_log", "CSRC", "BUILD_DIR"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC")
LINK_FLAGS = (*ARCH, "-shared")

# entry point -> argtypes (all return int: the cudaError_t of the launch)
_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ENTRY_POINTS = {
    # csrc/det_lu.cu (K1): a, det, n, r, layout, stream
    "semi_det_lu_c128": (_P, _P, _N, _I, _I, _P),
    "semi_det_lu_c64": (_P, _P, _N, _I, _I, _P),
    # csrc/det_lu_block.cu (K4): a, det, n, r, stream
    "semi_det_lu_block_c128": (_P, _P, _N, _I, _P),
    "semi_det_lu_block_c64": (_P, _P, _N, _I, _P),
    # csrc/gj_det.cu (K2): a, b, sol, det, n, m, k, warps, tile_rows,
    # tile_cols, chunks, stream
    "semi_gj_det_solve_c128": (_P, _P, _P, _P, _N, *(_I,) * 6, _P),
    "semi_gj_det_solve_c64": (_P, _P, _P, _P, _N, *(_I,) * 6, _P),
    # csrc/gj_det.cu (K3): a, inv, det, n, m, warps, tile_rows, tile_cols,
    # stream
    "semi_gj_det_inv_c128": (_P, _P, _P, _N, *(_I,) * 4, _P),
    "semi_gj_det_inv_c64": (_P, _P, _P, _N, *(_I,) * 4, _P),
    # csrc/wm_diag.cu (K5): ten planes, pack, scal, det_planes, n, d, stream
    "semi_wm_diag_f64": (*(_P,) * 13, _N, _I, _P),
    "semi_wm_diag_f32": (*(_P,) * 13, _N, _I, _P),
}

_SUFFIX = {torch.complex128: "c128", torch.complex64: "c64",
           torch.float64: "f64", torch.float32: "f32"}

_lib = None
_log = ""
_entries = {}


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


def _run_all(cmds):
    """Run the commands in parallel and wait for every one; return their
    (returncode, output) in order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    return [(proc.returncode, out) for proc, out in zip(procs, outs)]


def _compile(srcs, target):
    """Compile each source to an object in parallel, link them into
    `target`. The objects and the library are written under private names
    first: concurrent first uses never load a half-written library."""
    global _log
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
        lib = os.path.join(tmp, target.name)
        steps = [
            [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
             for src, obj in zip(srcs, objs)],
            [[nvcc, *LINK_FLAGS, "-o", lib, *objs]],
        ]
        _log = ""
        for cmds in steps:
            results = _run_all(cmds)
            _log += "".join(out for _, out in results)
            for cmd, (rc, out) in zip(cmds, results):
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n"
                                       f"{' '.join(cmd)}\n{out}")
        os.replace(lib, target)


def load():
    """Build the kernel library if needed and return the loaded ctypes
    handle with its entry points declared."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    digest = hashlib.sha256(" ".join((*NVCC_FLAGS, *LINK_FLAGS)).encode())
    for src in (*srcs, *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    target = BUILD_DIR / f"libsemi_kernels_{digest.hexdigest()[:16]}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _compile(srcs, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return _lib


def entry(kernel, dtype):
    """The entry point `semi_<kernel>_<type>` of the loaded library for a
    tensor type (complex128: c128, complex64: c64, float64: f64, float32:
    f32), looked up once per (kernel, dtype)."""
    fn = _entries.get((kernel, dtype))
    if fn is None:
        fn = _entries[kernel, dtype] = getattr(
            load(), f"semi_{kernel}_{_SUFFIX[dtype]}")
    return fn


def launch(fn, device, *args):
    """`fn(*args, stream)` with `device`'s current stream; returns the
    entry point's cudaError_t. The device context is entered only when
    `device` (of the tensors in `args`) is not the current device."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def build_log():
    """The compiler's output of the build this process made ("" when the
    library was already built): nvcc's -Xptxas=-v register and
    shared-memory report per kernel."""
    return _log
