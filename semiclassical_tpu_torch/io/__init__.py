# coding: utf-8
"""Host-side input/output: fchk reader and the npz results protocol."""

from semiclassical_tpu_torch.io.fchk import FormattedCheckpointFile

__all__ = ["FormattedCheckpointFile"]
