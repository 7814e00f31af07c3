"""The cell `methylium_hk` on the CPU at the harness tests' tiny size: the
port's dense HK path on methylium's harmonic PES and the plain reference
`hk_harmonic` agree through `run.measure`; the control (the reference at
float32 in the port's place) and a port broken underneath each read not
correct; a run loads no JAX. The least work of the step and of K1, the
reader of K1's share of its roofline and the reader of launches a step on
hand-built traces. The card-only test runs the control and the port at
the cell's own size."""

import math
import subprocess
import sys
import types

import pytest
import torch

from metrics import k1_roofline, kernels_per_step
from reference import hk_harmonic
from semibench import cell as cells, check, control, peaks, trace, window
from semibench.cell import BENCH_DIR, ROOT
# one_thread: the autouse fixture of one intra-op thread
from test_bench_reference import (_answer_altered, _half_batch,  # noqa: F401
                                  _state_unchanged, measure, one_thread,
                                  tiny)

NAME = "methylium_hk"
K1 = ("void (anonymous namespace)::det_lu_rows_kernel<double, 6>("
      "double2 const*, double*, long long)")
K1_WARP = ("void (anonymous namespace)::det_lu_kernel<double>("
           "double2 const*, double*, long long, int)")
K4 = ("void (anonymous namespace)::det_lu_block_kernel<double, 45>("
      "double2 const*, double*, int)")
STAMP = "void (anonymous namespace)::stamp_kernel(long long*, int, int)"
PEAK = {"bytes_per_s": 3.35e12,
        "flops_per_s": {"float64": 34e12, "float64_tensor": 67e12}}


def test_port_and_reference_agree_on_the_cpu():
    res = measure(tiny(NAME))
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["check"]) == {"failed", "c_gap", "k_gap", "npz_gap",
                                 "c0_dev"}
    for key, num in res["check"].items():
        if key.endswith("_gap"):
            assert num["value"] < 1e-12, key
    assert set(res["metrics"]) == {"traj_steps_per_s", "setup_s"}


def test_traced_run_reads_the_sections():
    res = measure(tiny(NAME), trace=True)
    assert res["correct"]
    metrics = res["metrics"]
    for section in ("prefactor", "observables", "integrator", "monodromy"):
        assert metrics[f"loop_{section}_ms_per_step"]["value"] > 0, section
    # no card: no K1 launch and no device kernel to read
    assert "k1_roofline" not in metrics
    assert "kernels_per_step" not in metrics


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_port_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert measure(tiny(NAME))["correct"] is False


def test_lower_precision_fails():
    c = tiny(NAME)
    run = window.execute(c, 5, 1e9, False, "cpu", 0.0,
                         system=control.Control(c), max_reps=2)
    nums = check.numbers(run)
    assert not check.correct(nums)
    gaps = {n: v for n, v, _ in nums}
    for key in ("c_gap", "k_gap", "npz_gap"):
        assert gaps[key] > c.workload["limits"][key], key


def test_the_reference_refuses_what_it_does_not_cover():
    task = cells.load(NAME).task
    for change in ({"propagator": "WM"}, {"precision": "comp32"},
                   {"integrator": "exact"}, {"error_bars": True},
                   {"potential": dict(task["potential"], type="gdml")}):
        with pytest.raises(ValueError):
            hk_harmonic.checked(dict(task, **change))
    assert hk_harmonic.checked(task) is task["potential"]


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]\n"
        "import torch, run\n"
        "from semibench import cell\n"
        "import metrics.k1_roofline, metrics.kernels_per_step\n"
        "import work.methylium_harmonic\n"
        f"c = cell.load({NAME!r})\n"
        "c.task.update(batch_size=8, num_steps=20, scan_chunk=10)\n"
        "res = run.measure(c, 3, 0.05, False, torch.device('cpu'))\n"
        "assert isinstance(res, dict) and res['correct'], res\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_step_and_k1_least_work():
    """At (100,000, 6, 6): K1 reads 37 complex numbers a matrix and writes
    one; the step moves its state twice and is bound by bytes."""
    c = cells.load(NAME)
    work, task = c.work(), c.task
    n = 100000
    k1 = work.k1(task)
    assert k1["bytes"] == 16 * n * 37
    assert k1["flops"]["float64"] == n * 602
    assert math.isclose(1e3 * peaks.least_seconds(k1, PEAK),
                        16 * n * 37 / 3.35e9)
    step = work.step(task)
    state = n * (24 + 4 * 144 + 4)
    assert step["bytes"] == 8 * (2 * state + 4 * n + 144 + 576)
    assert step["flops"]["float64_tensor"] == 2 * n * (24 ** 3 + 6 * 24 * 48
                                                       + 6 * 48 * 12)
    assert step["bytes"] / 3.35e12 > sum(
        f / PEAK["flops_per_s"][t] for t, f in step["flops"].items())


def _run(op_s, op_n, steps=2000, traced=True):
    summary = trace.Summary(busy_s=4.0, window_s=4.1,
                            device_ops=sum(op_n.values()), op_s=op_s,
                            op_n=op_n, idle_s={})
    reps = [{"failed": False, "traced": False, "steps": steps},
            {"failed": False, "traced": traced, "steps": steps}]
    return types.SimpleNamespace(
        trace=summary, device=None, world=1, cell=cells.load(NAME),
        done=reps)


def test_k1_roofline_reader(monkeypatch):
    monkeypatch.setattr(peaks, "of", lambda device: PEAK)
    least = 16 * 100000 * 37 / 3.35e12
    run = _run({K1: 2001 * least / 0.4, K4: 1.0, "other_kernel": 1.0},
               {K1: 2001, K4: 2001, "other_kernel": 3})
    assert k1_roofline.read(run) == pytest.approx(40.0)
    # the warp kernel counts as K1; K4's block kernel does not
    both = _run({K1: 1000 * least / 0.5, K1_WARP: 1001 * least / 0.5},
                {K1: 1000, K1_WARP: 1001})
    assert k1_roofline.read(both) == pytest.approx(50.0)
    # nothing to read: no K1 launch, no trace, a card not in the table
    assert k1_roofline.read(_run({K4: 1.0}, {K4: 3})) is None
    assert k1_roofline.read(types.SimpleNamespace(trace=None,
                                                  device=None)) is None
    monkeypatch.setattr(peaks, "of", lambda device: None)
    assert k1_roofline.read(run) is None


def test_kernels_per_step_reader():
    run = _run({K1: 1.0, STAMP: 0.1, "gemm": 2.0,
                "Memcpy DtoH (Device -> Pageable)": 0.01,
                "Memset (Device)": 0.01},
               {K1: 2001, STAMP: 20000, "gemm": 8000,
                "Memcpy DtoH (Device -> Pageable)": 25,
                "Memset (Device)": 4}, steps=2000)
    assert kernels_per_step.read(run) == pytest.approx(10001 / 2000)
    # nothing to read: no trace, no device operation, no traced repetition
    assert kernels_per_step.read(types.SimpleNamespace(
        trace=None, done=[])) is None
    assert kernels_per_step.read(_run({}, {})) is None
    assert kernels_per_step.read(_run({K1: 1.0}, {K1: 1},
                                      traced=False)) is None


@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's size")
    c = cells.load(NAME)
    limits = c.workload["limits"]
    for seed in (101, 102, 103):
        ctl = window.execute(c, seed, 1e9, False, "cuda", 0.0,
                             system=control.Control(c), max_reps=1)
        assert not check.correct(check.numbers(ctl))
        prog = window.execute(c, seed, 1e9, False, "cuda", 0.0, max_reps=1)
        nums = check.numbers(prog)
        assert check.correct(nums), nums
        assert all(v <= limits.get(n, math.inf) for n, v, _ in nums)
