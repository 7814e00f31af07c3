"""The modules a run of the port may not hold: JAX and the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's)."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "semiclassical_tpu")


def forbidden_modules():
    """The forbidden top-level names that this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
