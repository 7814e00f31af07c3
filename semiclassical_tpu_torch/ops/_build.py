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
first launch. Every launch of the port goes through `launch(kernel, dtype,
device, *args)`: the entry point is looked up once per kernel and type,
the device context is entered only for a tensor that is not on the
current device, a non-zero CUDA error raises, and the launch is counted in
the one table `LAUNCHES`, so that a call costs the host one lookup and
one increment beside the ctypes call. `launch_counts()` reads the table by
each kernel's label (K1..K7, beside its entry points in `_ENTRY_POINTS`)
and `reset_launch_counts()` empties it; the time loop's graphs credit
their replays to it (`propagation.graph`). The wrappers also share the
device rule (`route`) and the layout helpers here, so that no kernel
module needs another's helpers.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["load", "launch", "launch_counts", "reset_launch_counts", "route",
           "dtype_name", "row_stride", "ceil_div", "build_log", "KERNELS",
           "LAUNCHES", "CSRC", "BUILD_DIR"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC")
LINK_FLAGS = (*ARCH, "-shared")

# kernel -> (label, types, argtypes): the entry points semi_<kernel>_<type>
# of the library, each returning int, the cudaError_t of its launch. A
# kernel's label is the name the port's documents and `launch_counts` give
# it; the section clock's stamp has none.
_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_D = ctypes.c_double
_ENTRY_POINTS = {
    # csrc/det_lu.cu: a, det, n, r, layout, stream
    "det_lu": ("K1", ("c128", "c64"), (_P, _P, _N, _I, _I, _P)),
    # csrc/gj_det.cu: a, b, sol, det, n, m, k, warps, tile_rows, tile_cols,
    # chunks, stream
    "gj_det_solve": ("K2", ("c128", "c64"), (*(_P,) * 4, _N, *(_I,) * 6, _P)),
    # csrc/gj_det.cu: a, inv, det, n, m, warps, tile_rows, tile_cols, stream
    "gj_det_inv": ("K3", ("c128", "c64"), (*(_P,) * 3, _N, *(_I,) * 4, _P)),
    # csrc/det_lu_block.cu: a, det, n, r, stream
    "det_lu_block": ("K4", ("c128", "c64"), (_P, _P, _N, _I, _P)),
    # csrc/wm_diag.cu: ten planes, pack, scal, det_planes, n, d, vec, lanes,
    # blocks, stream
    "wm_diag": ("K5", ("f64", "f32"), (*(_P,) * 13, _N, *(_I,) * 4, _P)),
    # csrc/diag_mono.cu: z, plane stride, h1..h4, broadcast mask, inv_m,
    # out, n d, d, the weights dt/6, dt/3, dt/2, dt, vec, blocks, stream
    "diag_mono": ("K6", ("f64", "f32"), (_P, _N, *(_P,) * 4, _I, _P, _P, _N,
                                         _I, *(_D,) * 4, _I, _I, _P)),
    # csrc/morse_rk4.cu: q, p, S, pack, new q, new p, new S, e1, h, n, d,
    # the weights dt/2, dt, dt/6, vec, blocks, stream
    "morse_rk4": ("K7", ("f64", "f32"), (*(_P,) * 9, _N, _I, *(_D,) * 3, _I,
                                         _I, _P)),
    # csrc/stamp.cu (the time loop's section clock): slots, section, last,
    # stream
    "stamp": (None, ("i64",), (_P, _I, _I, _P)),
}
# label -> kernel
KERNELS = {label: kernel for kernel, (label, _, _) in _ENTRY_POINTS.items()
           if label}

_SUFFIX = {torch.complex128: "c128", torch.complex64: "c64",
           torch.float64: "f64", torch.float32: "f32", torch.int64: "i64"}


def dtype_name(dtype: torch.dtype) -> str:
    """"complex128", "float64", ...: a type as the launch counts name it."""
    return str(dtype).removeprefix("torch.")


_TYPE_NAMES = {suffix: dtype_name(dtype) for dtype, suffix in _SUFFIX.items()}

# the launches `launch` made: (kernel, dtype name) -> count
LAUNCHES = collections.Counter()

_lib = None
_log = ""
_bound = {}   # (kernel, dtype) -> (entry point, its key in LAUNCHES)


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
    for kernel, (_, types, argtypes) in _ENTRY_POINTS.items():
        for suffix in types:
            fn = getattr(lib, f"semi_{kernel}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _lib = lib
    return _lib


def _bind(kernel, dtype):
    fn = getattr(load(), f"semi_{kernel}_{_SUFFIX[dtype]}")
    hit = _bound[kernel, dtype] = (fn, (kernel, dtype_name(dtype)))
    return hit


def launch(kernel, dtype, device, *args):
    """Launch the entry point `semi_<kernel>_<type>` for tensors of `dtype`
    (complex128: c128, complex64: c64, float64: f64, float32: f32, int64:
    i64) as `fn(*args, stream)` on `device`'s current stream; raise
    RuntimeError on a non-zero CUDA error, and count the launch in
    LAUNCHES. The entry point is looked up once per (kernel, dtype), and
    the device context is entered only when `device` (of the tensors in
    `args`) is not the current device."""
    fn, key = _bound.get((kernel, dtype)) or _bind(kernel, dtype)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} "
                           f"({key[1]})")
    LAUNCHES[key] += 1


def launch_counts():
    """{label: {dtype name: launches}} of K1..K7 since the last
    `reset_launch_counts`, each with every type it is built for."""
    return {label: {_TYPE_NAMES[t]: LAUNCHES[kernel, _TYPE_NAMES[t]]
                    for t in _ENTRY_POINTS[kernel][1]}
            for label, kernel in KERNELS.items()}


def reset_launch_counts():
    """Set every launch count to 0."""
    LAUNCHES.clear()


def route(name, *tensors):
    """Where a wrapper runs: "cpu" (the plain version) when every tensor is
    on the CPU, "cuda" (the kernel) when every one is on the card;
    anything else raises ValueError."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"cuda"}:
        return kinds.pop()
    raise ValueError(f"{name} runs on cuda or cpu tensors (all on one), got "
                     f"{', '.join(str(t.device) for t in tensors)}")


def row_stride(x):
    """d where element (r, j) of the (n, d) tensor x lies r d + j numbers
    past its start (rows of d contiguous numbers, one after another), 0
    where every row is the same row of d contiguous numbers (a broadcast),
    None for any other layout. An empty x has every layout."""
    n, d = x.shape
    if x.numel() == 0:
        return d
    if d > 1 and x.stride(1) != 1:
        return None
    if n == 1 or x.stride(0) == d:
        return d
    return 0 if x.stride(0) == 0 else None


def ceil_div(a, b):
    return -(-a // b)


def build_log():
    """The compiler's output of the build this process made ("" when the
    library was already built): nvcc's -Xptxas=-v register and
    shared-memory report per kernel."""
    return _log
