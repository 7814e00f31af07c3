"""The harness's repetition loop and check on the CPU at a tiny size: the
port and the plain reference agree; the control (the reference at
float32 in the port's place) and the port broken underneath each come out
not correct; a run loads no JAX; the traffic and the trace reduction. The
card-only test runs the control at the cell's own size."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import run as bench_run
from semibench import cell as cells, check, control, trace, traffic, window
from reference import for_cell as cells_reference
from semibench.cell import BENCH_DIR, ROOT

AS5 = "tests/data/refdata/AnharmonicAS/5modes/AS_model_chi0.02.dat"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CELLS = ["as60_hk_f64", "coumarin_hk_taylor8", "coumarin_wm_taylor8"]


def tiny(name="as60_hk_f64", batch=None, steps=None):
    """The cell at a test's size: AS cells on the 5-mode AS model with 64
    trajectories and 30 steps in segments of 10, molecular ones with 8
    trajectories and 40 steps in segments of 20 (two taylor windows and a
    part one each)."""
    c = cells.load(name)
    if c.task["potential"]["type"] == "anharmonic AS":
        c.task["potential"] = {"type": "anharmonic AS", "model_file": AS5}
        c.task.update(batch_size=batch or 64, num_steps=steps or 30,
                      scan_chunk=10)
    else:
        c.task.update(batch_size=batch or 8, num_steps=steps or 40,
                      scan_chunk=20)
    return c


def measure(c, seed=987654321, seconds=0.3, trace=False):
    return bench_run.measure(c, seed, seconds, trace, torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_port_and_reference_agree_on_the_cpu(name):
    res = measure(tiny(name))
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for key, num in res["check"].items():
        if key.endswith("_gap"):
            assert num["value"] < 1e-12, key
    assert list(res["check"])[-1] == "c0_dev"
    assert set(res["metrics"]) == {"traj_steps_per_s", "setup_s"}


def test_traced_run_on_the_cpu():
    res = measure(tiny(), trace=True)
    assert res["correct"]
    assert {"sample_ms", "reduce_ms", "scan_ms_per_step",
            "graph_captures"} <= set(res["metrics"])
    # no card: nothing ran on a device, so no idle share and no roofline
    assert "device_idle_pct" not in res["metrics"]
    assert res["device"]["window_s"] > 0


def test_the_traced_repetition_follows_the_window():
    from metrics import reduce_ms, sample_ms, scan_ms_per_step

    run = window.execute(tiny(), 11, 0.3, True, "cpu", 0.0)
    assert [r["traced"] for r in run.reps] == [False] * (len(run.reps) - 1) \
        + [True]
    assert run.trace is not None and len(run.timed) == len(run.reps) - 1
    untraced = run.reps[:-1]
    assert sample_ms.read(run) == pytest.approx(
        1e3 * np.mean([r["sample_s"] for r in untraced]))
    assert reduce_ms.read(run) == pytest.approx(
        1e3 * np.mean([r["reduce_s"] for r in untraced]))
    assert scan_ms_per_step.read(run) == pytest.approx(
        1e3 * sum(r["scan_s"] for r in untraced)
        / sum(r["steps"] for r in untraced))
    assert run.traj_steps == sum(r["ntraj"] * r["steps"] for r in untraced)


def test_the_configurations_precision_reaches_the_port(tmp_path):
    from semiclassical_tpu_torch import cli

    from semibench import models
    from semibench.program import Program

    c = tiny()
    config = dict(c.config, precision="comp32")
    task = cells.make_task(config, c.workload["task"])
    assert task["precision"] == "comp32"
    task.update({k: c.task[k] for k in ("potential", "batch_size",
                                        "num_steps", "scan_chunk")})
    potential = models.resolve(task["potential"], str(tmp_path))
    prog = Program(task, potential, str(tmp_path / "c.npz"), "cpu")
    assert (prog.dtype, prog.traj_dtype) == cli._precision_dtypes("comp32")
    # the float64 reference refuses a precision it does not cover
    with pytest.raises(ValueError):
        cells_reference(c).repetition(task, None, None)


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_fails(name):
    c = tiny(name, batch=256 if "as60" in name else None)
    run = window.execute(c, 5, 1e9, False, "cpu", 0.0,
                         system=control.Control(c), max_reps=2)
    nums = check.numbers(run)
    assert not check.correct(nums)
    gaps = {n: v for n, v, _ in nums}
    assert gaps["c_gap"] > c.workload["limits"]["c_gap"]
    assert gaps["npz_gap"] > c.workload["limits"]["npz_gap"]


def _state_unchanged(monkeypatch):
    from semiclassical_tpu_torch.propagation import eom, hk

    real = eom.rk4_step
    for module in (eom, hk):
        monkeypatch.setattr(module, "rk4_step", lambda state, *a, **k: (
            state, real(state, *a, **k)[1]))


def _half_batch(monkeypatch):
    from semiclassical_tpu_torch.propagation import hk, wm

    def halved(real):
        def half(*args):
            out = []
            for x in real(*args):
                keep = torch.zeros_like(x)
                keep[: x.shape[0] // 2] = 2.0
                out.append(x * keep)
            return tuple(out)
        return half

    for module, name in ((hk, "hk_observables_qp"),
                         (wm, "wm_scan_observables_qp")):
        monkeypatch.setattr(module, name, halved(getattr(module, name)))


def _answer_altered(monkeypatch):
    from semiclassical_tpu_torch.propagation import HermanKlukPropagator

    real = HermanKlukPropagator.propagate

    def altered(self, *args, **kwargs):
        out = list(real(self, *args, **kwargs))
        out[0] = out[0].copy()
        out[0][len(out[0]) // 2] = out[0][len(out[0]) // 2 - 1]
        return tuple(out)

    monkeypatch.setattr(HermanKlukPropagator, "propagate", altered)


# the faults a single-card HK cell can have (it has no exchange between
# cards to leave out)
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_port_is_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    res = measure(tiny(name))
    assert res["correct"] is False


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]\n"
        "import torch, run\n"
        "from semibench import cell, check, control, trace, window\n"
        "import reference.hk_separable, metrics.step_roofline, work.as60\n"
        "c = cell.load('as60_hk_f64')\n"
        "c.task.update(batch_size=16, num_steps=10, scan_chunk=10)\n"
        f"c.task['potential'] = {{'type': 'anharmonic AS', "
        f"'model_file': {AS5!r}}}\n"
        "res = run.measure(c, 3, 0.05, False, torch.device('cpu'))\n"
        "assert isinstance(res, dict), res\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert bench_run.forbidden_modules() == ["jax"]


def test_traffic_same_sizes_and_large_seeds():
    task = {"batch_size": 8, "sampling": "pseudo"}
    a = traffic.normals(task, 2 ** 31 + 7, traffic.WINDOW, 3, 5, "cpu")
    b = traffic.normals(task, 2 ** 31 + 7, traffic.WINDOW, 3, 5, "cpu")
    c = traffic.normals(task, 2 ** 40 + 1, traffic.WINDOW, 3, 5, "cpu")
    assert a.shape == c.shape == (8, 10)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        traffic.normals(dict(task, sampling="sobol"), 1, traffic.WINDOW, 0,
                        2, "cpu")


def test_trace_reduction():
    ms = 1_000_000
    events = [("span", "bench.traced", 0, 100 * ms),
              ("span", "bench.sample", 0, 20 * ms),
              ("span", "bench.scan", 20 * ms, 100 * ms),
              ("host", "aten::mm", 5 * ms, 15 * ms),
              ("device", "k1", 10 * ms, 20 * ms),
              ("device", "k2", 15 * ms, 30 * ms),
              ("device", "k2", 30 * ms + 5000, 90 * ms),
              ("device", "k3", 95 * ms, 120 * ms)]
    s = trace.reduce_events(events)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx((20 + 60 - 0.005 + 5) / 1e3)
    assert s.op_s["k2"] == pytest.approx((15 + 60 - 0.005) / 1e3)
    assert s.op_s["k3"] == pytest.approx(5e-3)
    assert s.idle_s["sample: aten::mm"] == pytest.approx(10e-3)
    assert s.idle_s["scan: gaps under 10 us"] == pytest.approx(5e-6)
    assert s.idle_s["scan: no host op"] == pytest.approx(5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's size")
    c = cells.load(name)
    limits = c.workload["limits"]
    for seed in (101, 102, 103):
        ctl = window.execute(c, seed, 1e9, False, "cuda", 0.0,
                             system=control.Control(c), max_reps=1)
        assert not check.correct(check.numbers(ctl))
        prog = window.execute(c, seed, 1e9, False, "cuda", 0.0, max_reps=1)
        nums = check.numbers(prog)
        assert check.correct(nums), nums
        assert np.all([v <= limits.get(n, np.inf) for n, v, _ in nums])
