"""The four-card cell `as60_hk_norm_ring4` at a test's size on the CPU: a
gloo group of `world` ranks, one process a rank as on the cards, on the
5-mode AS model with 64 trajectories, 20 steps and a norm every 10.

    python benchmark/tests/group_tiny.py <world> <seed> [<fault>]

runs it through `run.emit` (rank 0 is this process) and exits with its
code; with GROUP_TINY_TRACE=1 in the environment, as `--trace 1`.
`<fault>` names one of the Programs below, which break the port
underneath on every rank."""

import os
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from semibench.program import Program  # noqa: E402

AS5 = "tests/data/refdata/AnharmonicAS/5modes/AS_model_chi0.02.dat"
CELL = "as60_hk_norm_ring4"


def tiny(world=2):
    """The cell at the tests' size, on `world` ranks."""
    from semibench import cell as cells

    c = cells.load(CELL)
    c.entry = dict(c.entry, chips=world)
    c.task["potential"] = {"type": "anharmonic AS", "model_file": AS5}
    c.task.update(batch_size=64, num_steps=20, scan_chunk=10,
                  calc_norm_every=10)
    return c


class NormOff(Program):
    """The port's norm times (1 + 1e-6)."""

    def norm(self):
        return super().norm() * (1.0 + 1.0e-6)


class ExitEarly(Program):
    """Rank EXIT_RANK (rank 1, or the environment's GROUP_TINY_EXIT_RANK)
    ends its process in the window's second repetition."""

    scans = 0

    def scan(self, nt=None, norm_span=None):
        ExitEarly.scans += 1
        rank = int(os.environ.get("GROUP_TINY_EXIT_RANK", "1"))
        if ExitEarly.scans == 2 and self.group.rank == rank:
            os._exit(9)
        return super().scan(nt, norm_span)


class _Patched(Program):
    """The port with `patch()` applied in this rank's process."""

    def __init__(self, *args, **kwargs):
        self.patch()
        super().__init__(*args, **kwargs)


class StateUnchanged(_Patched):
    """Every RK4 step returns its state unchanged."""

    @staticmethod
    def patch():
        from semiclassical_tpu_torch.propagation import eom, hk

        real = eom.rk4_step
        for module in (eom, hk):
            module.rk4_step = lambda state, *a, **k: (
                state, real(state, *a, **k)[1])


class HalfBatch(_Patched):
    """The observables of half the rows left out, the other half doubled:
    the mean taken over the rest."""

    @staticmethod
    def patch():
        import torch

        from semiclassical_tpu_torch.propagation import hk

        real = hk.hk_observables_qp

        def half(*args):
            out = []
            for x in real(*args):
                keep = torch.zeros_like(x)
                keep[: x.shape[0] // 2] = 2.0
                out.append(x * keep)
            return tuple(out)

        hk.hk_observables_qp = half


class NoExchange(_Patched):
    """The exchange between ranks left out: `group_sum` returns each
    rank's own sums, `ring_shift` its own rows."""

    @staticmethod
    def patch():
        from semiclassical_tpu_torch.parallel import group
        from semiclassical_tpu_torch.propagation import hk

        for module in (group, hk):
            module.group_sum = lambda tensors, grp: list(tensors)
            module.ring_shift = lambda tensors, grp: list(tensors)


class RingOff(_Patched):
    """The ring alone left out: `ring_shift` returns each rank's own rows,
    so the norm pairs each rank's rows with its own `world` times;
    `group_sum` is kept."""

    @staticmethod
    def patch():
        from semiclassical_tpu_torch.parallel import group
        from semiclassical_tpu_torch.propagation import hk

        for module in (group, hk):
            module.ring_shift = lambda tensors, grp: list(tensors)


class JaxOnRankOne(Program):
    """The port as it is, but rank 1 holds a module named `jax` once its
    window has closed (a branch that only a rank other than 0 takes)."""

    def release(self):
        import types

        super().release()
        if self.group.rank == 1:
            sys.modules.setdefault("jax", types.ModuleType("jax"))


class AnswerAltered(_Patched):
    """One step of C(t) altered where `propagate` returns it."""

    @staticmethod
    def patch():
        from semiclassical_tpu_torch.propagation import HermanKlukPropagator

        real = HermanKlukPropagator.propagate

        def altered(self, *args, **kwargs):
            out = list(real(self, *args, **kwargs))
            out[0] = out[0].copy()
            out[0][len(out[0]) // 2] = out[0][len(out[0]) // 2 - 1]
            return tuple(out)

        HermanKlukPropagator.propagate = altered


def main(argv):
    import torch

    import run

    torch.set_num_threads(1)
    world, seed = int(argv[0]), int(argv[1])
    system = f"{__file__}:{argv[2]}" if len(argv) > 2 else None
    trace = os.environ.get("GROUP_TINY_TRACE") == "1"
    return run.emit(tiny(world), seed, 0.3, trace, torch.device("cpu"),
                    system=system)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
