"""The cell `as60_wm_f64` on the CPU at the harness tests' tiny size: the
port's separable WM path and the plain reference `wm_separable` agree
through `run.measure`; the control (the reference at float32 in the
port's place) and a port broken underneath each read not correct; a
traced run reads the `wm_inputs` section. The least work of K5 against
its bound in PERF.md's kernel table, and the reader of K5's share of its
roofline on a synthetic trace. The card-only test runs the control and
the port at the cell's own size."""

import math
import types

import pytest
import torch

from metrics import k5_roofline
from semibench import cell as cells, check, control, peaks, trace, window
# one_thread: the autouse fixture of one intra-op thread
from test_bench_reference import (_answer_altered, _half_batch,  # noqa: F401
                                  _state_unchanged, measure, one_thread,
                                  tiny)

NAME = "as60_wm_f64"
KERNEL = ("void (anonymous namespace)::wm_diag_kernel<double, 2, 16>("
          "(anonymous namespace)::Planes<double>, double const*, double*, "
          "double*, int, int)")
PEAK = {"bytes_per_s": 3.35e12, "flops_per_s": {"float64": 34e12}}


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


def test_traced_run_reads_the_wm_sections():
    res = measure(tiny(NAME), trace=True)
    assert res["correct"]
    metrics = res["metrics"]
    assert metrics["loop_wm_inputs_ms_per_step"]["value"] > 0
    assert metrics["loop_wm_derived_ms_per_step"]["value"] > 0
    # no card: no K5 launch to read
    assert "k5_roofline" not in metrics


def _k5_planes_altered(monkeypatch):
    """K5's per-mode M' / m_scale planes one part in 10^6 off (detM by
    ~d parts in 10^6)."""
    from semiclassical_tpu_torch.ops import wm_diag

    real = wm_diag.wm_diag_derived

    def altered(*args):
        scal, planes = real(*args)
        planes = planes.clone()
        planes[2:] *= 1.0 + 1e-6
        return scal, planes

    monkeypatch.setattr(wm_diag, "wm_diag_derived", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered, _k5_planes_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_port_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert measure(tiny(NAME))["correct"] is False


def test_lower_precision_fails():
    c = tiny(NAME, batch=256)
    run = window.execute(c, 5, 1e9, False, "cpu", 0.0,
                         system=control.Control(c), max_reps=2)
    nums = check.numbers(run)
    assert not check.correct(nums)
    gaps = {n: v for n, v, _ in nums}
    for key in ("c_gap", "k_gap", "npz_gap"):
        assert gaps[key] > c.workload["limits"][key], key


def test_k5_least_work_is_the_kernel_tables_bound():
    """PERF.md's K5 row at (98,304, 60) float64: 0.2042 ms, by bytes."""
    c = cells.load(NAME)
    work, task = c.work(), c.task
    k5 = work.k5(task)
    assert k5["bytes"] == 8 * (14 * 98304 * 60 + 30 * 98304 + 17 * 60)
    assert math.isclose(1e3 * peaks.least_seconds(k5, PEAK), 0.2042,
                        abs_tol=5e-5)
    assert k5["bytes"] / 3.35e12 > k5["flops"]["float64"] / 34e12
    step = work.step(task)
    assert step["bytes"] > k5["bytes"]
    assert work.k5(dict(task, precision="comp32"))["bytes"] == k5["bytes"] / 2


def _run(op_s, op_n):
    summary = trace.Summary(busy_s=4.0, window_s=4.1, device_ops=1000,
                            op_s=op_s, op_n=op_n, idle_s={})
    return types.SimpleNamespace(trace=summary, device=None, world=1,
                                 cell=cells.load(NAME))


def test_k5_roofline_reader(monkeypatch):
    monkeypatch.setattr(peaks, "of", lambda device: PEAK)
    least = 8 * (14 * 98304 * 60 + 30 * 98304 + 17 * 60) / 3.35e12
    run = _run({KERNEL: 500 * least / 0.75, "other_kernel": 1.0},
               {KERNEL: 500, "other_kernel": 3})
    assert k5_roofline.read(run) == pytest.approx(75.0)
    # nothing to read: no K5 launch, no trace, a card not in the table
    assert k5_roofline.read(_run({"other_kernel": 1.0},
                                 {"other_kernel": 3})) is None
    assert k5_roofline.read(types.SimpleNamespace(trace=None,
                                                  device=None)) is None
    monkeypatch.setattr(peaks, "of", lambda device: None)
    assert k5_roofline.read(run) is None


@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's size")
    c = cells.load(NAME)
    for seed in (101, 102, 103):
        ctl = window.execute(c, seed, 1e9, False, "cuda", 0.0,
                             system=control.Control(c), max_reps=1)
        assert not check.correct(check.numbers(ctl))
        prog = window.execute(c, seed, 1e9, False, "cuda", 0.0, max_reps=1)
        nums = check.numbers(prog)
        assert check.correct(nums), nums
