"""The system under test: the port's `dynamics` task, driven one
repetition at a time as `semiclassical_tpu_torch.cli.run_semiclassical_
dynamics` drives it (a new propagator, `initial_conditions`, `propagate`
in `scan_chunk` segments, or with `calc_norm_every` in segments of that
many steps with the norm before each, `accumulate_results`), with the
normals handed in. The potential is built once, by the port's own
`cli._build_potential`. Under a process group (`parallel.Group`) every
rank runs each call with the whole batch's normals and keeps its own
rows; rank 0 alone writes the results file."""

import contextlib
import importlib.util
import pathlib

import numpy as np


def load(spec):
    """The Program in the port's place that `spec` names ("<file>:<name>",
    the tests' faults), or None for the port itself. A name, not the
    object, so that every rank of a group loads the same one."""
    if spec is None:
        return None
    path, name = spec.rsplit(":", 1)
    loader = importlib.util.spec_from_file_location(
        f"bench_system_{pathlib.Path(path).stem}", path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return getattr(module, name)


class Program:
    """One cell's task on the port. `sample`, `scan` and `reduce` are the
    three phases of a repetition the harness times apart."""

    def __init__(self, task, potential, results_file, device, group=None):
        import torch

        from semiclassical_tpu_torch import cli, units
        from semiclassical_tpu_torch.io.results import init_results

        self.torch = torch
        self.task = task
        self.device = torch.device(device)
        (potential, self.q0, self.p0, self.G0, self.e0, gap,
         _) = cli._build_potential(dict(task, potential=potential),
                                   self.device)
        self.dtype, self.traj_dtype = cli._precision_dtypes(
            task.get("precision", "f64"))
        self.potential = cli._reduced_potential(potential, self.dtype)
        self.dt = task["time_step_fs"] / units.autime_to_fs
        self.nt = int(task["num_steps"])
        self.chunk = int(task["scan_chunk"])
        self.error_bars = bool(task.get("error_bars", False))
        self.norm_every = int(task.get("calc_norm_every", 0))
        self.group = group
        self.leader = group is None or group.rank == 0
        self.results_file = results_file
        init_results(results_file, task.get("propagator", "HK"),
                     np.linspace(0.0, self.nt * self.dt, self.nt), gap,
                     self.e0)
        self.propagator = None

    @property
    def rank(self):
        """The number of sampled modes: the normals have 2 rank columns."""
        w = np.linalg.eigvalsh(2.0 * np.asarray(self.G0, dtype=np.float64))
        return int(np.count_nonzero(w > 1.0e-8))

    def sample(self, normals):
        from semiclassical_tpu_torch.propagation import (
            HermanKlukPropagator, WaltonManolopoulosPropagator)

        task, G = self.task, self.G0
        if task.get("propagator", "HK") == "WM":
            width = task.get("cell_width", 10000.0)
            prop = WaltonManolopoulosPropagator(
                G, G, width, width, device=self.device, dtype=self.dtype,
                traj_dtype=self.traj_dtype)
        else:
            prop = HermanKlukPropagator(G, G, device=self.device,
                                        dtype=self.dtype,
                                        traj_dtype=self.traj_dtype)
        prop.micro_batch = task.get("micro_batch", 0)
        prop.initial_conditions(self.q0, self.p0, G, self.potential,
                                ntraj=normals.shape[0], normals=normals,
                                sampling_method=task.get("sampling",
                                                         "pseudo"),
                                group=self.group)
        self.propagator = prop

    def norm(self):
        """|psi| of the current state (`propagator.norm()`: the ring over
        every ordered pair under a group, a collective)."""
        return self.propagator.norm()

    def scan(self, nt=None, norm_span=contextlib.nullcontext):
        """`propagate` over the task's steps (or `nt`): a dict of the
        repetition's C(t), k~ic(t) and, with error bars, their standard
        errors, as numpy. With `calc_norm_every` (and no `nt`) the steps
        run in segments of that many, the norm before each, each norm
        inside `norm_span()`; the norms and their steps come back as
        "norms" and "norm_steps"."""
        if nt is not None or not self.norm_every:
            out = self._propagate(self.nt if nt is None else nt, self.chunk)
            res = {"cauto": out[0], "kic": out[1]}
            if self.error_bars:
                res["err_c"], res["err_k"] = out[2], out[3]
        else:
            nt = self.nt
            res = {key: np.zeros(nt, dtype=complex) for key in ("cauto",
                                                               "kic")}
            if self.error_bars:
                res["err_c"], res["err_k"] = np.zeros(nt), np.zeros(nt)
            res["norms"], res["norm_steps"] = [], []
            for done in range(0, nt, self.norm_every):
                seg = min(self.norm_every, nt - done)
                with norm_span():
                    res["norms"].append(self.norm())
                res["norm_steps"].append(done)
                # the CLI's norm segments: one `propagate` each, no chunk
                out = self._propagate(seg, None)
                for key, part in zip(("cauto", "kic", "err_c", "err_k"),
                                     out):
                    res[key][done:done + seg] = part
        res["ntraj"] = self.propagator.ntraj
        if np.isnan(res["cauto"]).any() or np.isnan(res["kic"]).any():
            raise RuntimeError("encountered NaN's in correlations")
        return res

    def _propagate(self, nt, chunk):
        return self.propagator.propagate(
            self.potential, self.dt, nt, energy0_es=self.e0, chunk=chunk,
            error_bars=self.error_bars)

    def reduce(self, res):
        """Accumulate the repetition into the results file (rank 0 of a
        group alone, as the CLI's rank 0 writes its npz)."""
        from semiclassical_tpu_torch.io.results import accumulate_results

        if not self.leader:
            return
        accumulate_results(self.results_file, res["cauto"], res["kic"],
                           res["ntraj"],
                           autocorrelation_stderr=res.get("err_c"),
                           ic_correlation_stderr=res.get("err_k"))

    def results(self):
        """The results file as the task left it."""
        with np.load(self.results_file) as data:
            out = {"cauto": data["autocorrelation"],
                   "kic": data["ic_correlation"],
                   "trajectories": int(data["trajectories"])}
            if "autocorrelation_stderr" in data:
                out["err_c"] = data["autocorrelation_stderr"]
                out["err_k"] = data["ic_correlation_stderr"]
        return out

    def counters(self):
        """The time loop's counters (`propagation.graph.STATS`)."""
        from semiclassical_tpu_torch.propagation import graph

        return dict(graph.STATS)

    def release(self):
        """Free the program's device state: the propagator and the time
        loop the process keeps."""
        from semiclassical_tpu_torch.propagation import graph

        self.propagator = None
        graph.clear()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def block_lengths(program):
    """The lengths of the time loop's blocks that the task's segments run
    (the port's `graph.block_lengths` of each `scan_chunk` segment, or of
    each `calc_norm_every` segment)."""
    from semiclassical_tpu_torch.propagation import graph

    nt = program.nt
    chunk = program.norm_every or program.chunk
    window = int(getattr(program.potential, "taylor_every", 1) or 1)
    segments = [chunk] * (nt // chunk) + ([nt % chunk] if nt % chunk else [])
    return sorted({b for s in segments for b in graph.block_lengths(s,
                                                                    window)})
