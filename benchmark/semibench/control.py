"""The control of the check: the plain reference put in the program's
place with what the configuration states at float64 (the trajectories,
the monodromy, the observables) computed at float32, the nearest
precision below, and its repetitions merged at complex64; a float32
Hessian that the configuration states stays float32 (at bfloat16 the
sGDML prefactor overflows and the control gives no number). A sound check
reads it as not correct. Used by the control test and `calibrate.py`,
never by the benchmark's own runs."""

import numpy as np
import torch

from reference import for_cell


class Control:
    """The `Program` interface over the reference at `dtype`."""

    def __init__(self, cell, dtype=torch.float32):
        self.cell, self.dtype = cell, dtype

    def __call__(self, task, potential, results_file, device):
        from semibench import models

        self.task, self.device = task, torch.device(device)
        self.table = models.table(potential.get("model_file"))
        self.merged, self.normals = None, None
        return self

    @property
    def rank(self):
        return for_cell(self.cell).rank(self.task, self.table)

    def sample(self, normals):
        self.normals = normals

    def scan(self, nt=None):
        return for_cell(self.cell).repetition(self.task, self.table,
                                              self.normals, self.dtype)

    def reduce(self, res):
        """The results file's merge (`io.results.accumulate_results`) at
        complex64 and float32."""
        if self.merged is None:
            self.merged = {k: np.zeros(len(v), dtype=np.complex64
                                       if k in ("cauto", "kic")
                                       else np.float32)
                           for k, v in res.items() if k != "ntraj"}
            self.merged["trajectories"] = 0
        m = self.merged
        old, new = m["trajectories"], res["ntraj"]
        tot = np.float32(old + new)
        for k in ("cauto", "kic"):
            m[k] = (np.float32(new) * res[k].astype(np.complex64)
                    + np.float32(old) * m[k]) / tot
        for k in ("err_c", "err_k"):
            if k in m:
                m[k] = np.sqrt((np.float32(new) ** 2
                                * res[k].astype(np.float32) ** 2
                                + np.float32(old) ** 2 * m[k] ** 2)
                               / tot ** 2)
        m["trajectories"] = old + new

    def results(self):
        return dict(self.merged)

    def counters(self):
        return {}

    def release(self):
        pass
