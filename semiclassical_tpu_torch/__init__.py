# coding: utf-8
"""semiclassical_tpu_torch — the PyTorch/CUDA port of semiclassical_tpu.

Herman-Kluk and Walton-Manolopoulos semiclassical dynamics for
internal-conversion rates, written for PyTorch on an NVIDIA GPU (Hopper,
sm_90a). The JAX package
`semiclassical_tpu` beside it is the reference the port is held against;
the module names match, so each counterpart is found at once:

  units          atomic units and conversion factors
  config         typed validation of the JSON task schema
  io/            fchk reader, npz accumulation protocol
  analysis/      lineshapes and the FFT rate pipeline
  linalg         host-side symmetric sqrtm/pseudo-inverse + batched det,
                 det + solve and det + inverse
  ops/           hand-written CUDA kernels, their plain versions, the build
  coherent       coherent-state overlaps
  sampling       Monte-Carlo initial conditions (torch.Generator)
  potentials/    Hessian operators and the molecular harmonic PES
  propagation/   state, RK4 with monodromy, the HK and WM propagators
  profiling      phase timers and per-run metrics
  cli            `dynamics` and `rates` task runner
  convert        JAX parameter packs (as numpy) -> port objects

Everything runs at float64/complex128; the device is always passed
explicitly (`device=`), and no module changes torch's global defaults.
Importing the package imports neither jax nor semiclassical_tpu.
"""

__version__ = "0.1.0"
