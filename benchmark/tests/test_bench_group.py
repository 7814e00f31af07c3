"""The group harness on the CPU: the four-card cell at a test's size on a
gloo group of two ranks, one process a rank (`group_tiny.py`, run as its
own process, since a lost rank ends rank 0's process): the ring norm
against the reference's plain pair sum, one result line from rank 0, the
planted faults read `correct` false, a rank that ends early ends the run
within its deadline, and a one-card cell still runs in one process."""

import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import run as bench_run
from reference import hk_separable_norm
from reference.hk_separable import _overlap_constants
from semibench import cell as cells, check, control, group, window

TINY = pathlib.Path(__file__).resolve().parent / "group_tiny.py"
SEED = 20260418
# a lost rank ends the run within a poll of rank 0's watchdog; the rest is
# the processes' start and their set-up
LOST_RANK_S = 60.0


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_run(tmp_path, *args, env=None):
    """`group_tiny.py` on two ranks: (completed process, seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(TINY), "2", str(SEED), *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, TMPDIR=str(tmp_path), **(env or {})))
    return out, time.perf_counter() - t0


def result_of(out):
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines, out.stderr[-3000:]
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    return tiny_run(tmp_path_factory.mktemp("sound"))[0]


def test_ring_norm_matches_the_plain_pair_sum(sound):
    res = result_of(sound)
    assert res["correct"] and res["failed"] == 0, res["check"]
    assert res["device"]["count"] == 2
    assert res["check"]["norm_gap"]["value"] < 1e-12
    for key in ("c_gap", "k_gap", "npz_gap"):
        assert res["check"][key]["value"] < 1e-12, key
    assert set(res["metrics"]) == {"traj_steps_per_s", "setup_s"}


def test_only_rank_zero_prints_a_result(sound):
    result_of(sound)
    lines = [ln for ln in sound.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1 and lines[0].startswith("{")
    # rank 0's check lines end standard error
    assert sound.stderr.strip().splitlines()[-1].startswith("check c0_dev")


@pytest.mark.parametrize("fault", ["NormOff", "StateUnchanged", "HalfBatch",
                                   "NoExchange", "AnswerAltered"])
def test_a_broken_group_is_not_correct(tmp_path, fault):
    res = result_of(tiny_run(tmp_path, fault)[0])
    assert res["correct"] is False
    if fault == "NormOff":
        gaps = {k: v["value"] for k, v in res["check"].items()}
        assert gaps["norm_gap"] > res["check"]["norm_gap"]["limit"]
        assert gaps["norm_gap"] == pytest.approx(1e-6, rel=1e-3)
        assert gaps["c_gap"] < 1e-12


def test_the_ring_alone_left_out_fails_the_norm(tmp_path):
    """With `group_sum` kept, C(t) and k~ic(t) stay right: the norm's
    every-pair check alone has to see the cross-rank blocks go."""
    res = result_of(tiny_run(tmp_path, "RingOff")[0])
    assert res["correct"] is False
    check_ = res["check"]
    assert check_["norm_gap"]["value"] > check_["norm_gap"]["limit"]
    for key in ("c_gap", "k_gap", "npz_gap"):
        assert check_[key]["value"] <= check_[key]["limit"], key


def test_a_traced_group_run_reads_the_cells_layers(tmp_path):
    """`--trace 1` on the group reads every per-layer metric the cell
    lists that the CPU can give: the harness's spans (the time loop's
    less the norms), the port's counters and its section clock; no device
    trace and no card in the peaks table here."""
    res = result_of(tiny_run(tmp_path, env={"GROUP_TINY_TRACE": "1"})[0])
    assert res["correct"], res["check"]
    listed = cells.load("as60_hk_norm_ring4").metrics["per_layer"]
    on_cpu = {m["name"] for m in listed if m["source"] != "device_trace"
              and not m["name"].endswith("_roofline")}
    assert on_cpu <= set(res["metrics"]) <= {m["name"] for m in listed}
    assert {"scan_ms_per_step", "norm_ms", "loop_monodromy_ms_per_step",
            "host_reads_per_rep"} <= on_cpu


def test_a_rank_holding_jax_gives_no_result(tmp_path):
    """A forbidden module on a rank other than 0, as its window closes,
    ends rank 0's run with no result line."""
    out, _ = tiny_run(tmp_path, "JaxOnRankOne")
    assert out.returncode == 3, out.stderr[-3000:]
    assert not out.stdout.strip()
    assert "the run loaded jax" in out.stderr


@pytest.mark.parametrize("rank", [1, 0])
def test_a_lost_rank_ends_the_run(tmp_path, rank):
    out, seconds = tiny_run(tmp_path, "ExitEarly",
                            env={"GROUP_TINY_EXIT_RANK": str(rank)})
    assert out.returncode != 0
    assert seconds < LOST_RANK_S
    assert not out.stdout.strip()
    if rank:
        assert out.returncode == group.EXIT_RANK_LOST
        assert "rank 1 ended with code 9" in out.stderr
    # no rank of the group outlives the run
    deadline = time.monotonic() + 10 * group.POLL_S + 5.0
    while _ranks_of(tmp_path) and time.monotonic() < deadline:
        time.sleep(group.POLL_S)
    assert not _ranks_of(tmp_path)


def _ranks_of(tmp_path):
    """The processes whose command line names a job under `tmp_path`."""
    found = []
    for proc in pathlib.Path("/proc").iterdir():
        try:
            cmd = (proc / "cmdline").read_bytes().decode(errors="replace")
        except OSError:
            continue
        if "--job" in cmd and str(tmp_path) in cmd:
            found.append(proc.name)
    return found


def test_a_one_card_cell_runs_in_one_process(monkeypatch):
    real = subprocess.Popen

    def no_rank(cmd, *args, **kwargs):
        assert "--job" not in cmd, "a one-card cell started a rank"
        return real(cmd, *args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("a one-card cell went to the group harness")

    monkeypatch.setattr(subprocess, "Popen", no_rank)
    monkeypatch.setattr(group, "execute", refuse)
    c = cells.load("as60_hk_f64")
    c.task["potential"] = {"type": "anharmonic AS",
                           "model_file": "tests/data/refdata/AnharmonicAS/"
                                         "5modes/AS_model_chi0.02.dat"}
    c.task.update(batch_size=16, num_steps=10, scan_chunk=10)
    res = bench_run.measure(c, 3, 0.05, False, torch.device("cpu"))
    assert res["correct"] and res["device"]["count"] == 1


def test_the_control_is_not_correct():
    """The reference at float32 in the port's place, in one process."""
    c = group_tiny_cell()
    c.task["batch_size"] = 256
    run = window.execute(c, 5, 1e9, False, "cpu", 0.0,
                         system=control.Control(c), max_reps=2)
    gaps = {n: (v, lim) for n, v, lim in check.numbers(run)}
    assert gaps["norm_gap"][0] > gaps["norm_gap"][1]
    assert gaps["c_gap"][0] > gaps["c_gap"][1]


def test_the_blocked_pair_sum_is_the_sum_over_every_pair():
    """`pair_norm`'s expanded exponent against the pair overlap's own
    formula (`hk_separable._exponent` on each pair's displacements), every
    ordered pair, with blocks that do not divide n."""
    gen = torch.Generator().manual_seed(3)
    n, d = 37, 4
    g = np.array([0.5, 1.0, 2.0, 3.5])
    q = torch.randn(n, d, generator=gen, dtype=torch.float64)
    p = torch.randn(n, d, generator=gen, dtype=torch.float64)
    log_mag = -0.1 * torch.rand(n, generator=gen, dtype=torch.float64)
    phase = 6.0 * torch.rand(n, generator=gen, dtype=torch.float64)
    w1, w2, w3, fac = (torch.tensor(x) for x in _overlap_constants(g, g))
    total = 0.0
    for i in range(n):
        # <g_i|g_j> for every ket j: dq = q_j - q_i, dp = p_j - p_i
        dq, dp = q - q[i], p - p[i]
        re = -0.5 * (dq * w1 * dq).sum(1) - 0.5 * (dp * w2 * dp).sum(1)
        im = (dq * w3 * dp).sum(1) - (dq * p).sum(1)
        term = (fac * torch.exp(log_mag[i] + log_mag + re)
                * torch.cos(-phase[i] + phase + im))
        total += float(term.sum())
    want = math.sqrt(total)
    for block in (5, 37, 64):
        got = hk_separable_norm.pair_norm(q, p, log_mag, phase, g,
                                          block=block)
        assert got == pytest.approx(want, rel=1e-13)


def test_the_norm_readers():
    from metrics import collective_ms, norm_ms, norm_roofline
    from semibench import trace as tracing

    c = group_tiny_cell()
    run = window.Run(cell=c, seed=1, device=torch.device("cpu"), world=4)
    run.reps = [{"index": i, "failed": False, "traced": False,
                 "ntraj": 64, "steps": 20, "norm_s": 0.3 + 0.1 * i,
                 "norm_n": 2} for i in range(2)]
    assert norm_ms.read(run) == pytest.approx(1e3 * 0.7 / 4)
    # the time loop's span less the norms inside it
    from metrics import scan_ms_per_step
    for i, rec in enumerate(run.reps):
        rec["scan_s"] = 1.0 + i
    assert scan_ms_per_step.read(run) == pytest.approx(
        1e3 * (3.0 - 0.7) / 40)
    # no card in the peaks table, no roofline
    assert norm_roofline.read(run) is None
    assert collective_ms.read(run) is None
    run.trace = tracing.Summary(
        busy_s=1.0, window_s=2.0, device_ops=3,
        op_s={"ncclDevKernel_AllReduce_Sum_f64_RING_LL": 0.004,
              "ncclKernel_SendRecv": 0.002, "void_at::native::x": 1.0},
        op_n={}, idle_s={})
    assert collective_ms.read(run) == pytest.approx(6.0)


def test_the_norms_least_work():
    from semibench import peaks
    from work import pair_norm

    n, d, world = 131072, 60, 4
    w = pair_norm.norm(n, d, world)
    pairs = n * (n + 1) / 2 / world
    assert w["flops"]["float64_tensor"] == 8 * d * pairs
    h100 = cells.load_json(peaks.TABLE)["cards"]["NVIDIA H100 80GB HBM3"]
    # the mode sums bound it: ~16 ms a rank on the H100
    least = peaks.least_seconds(w, h100)
    assert least == pytest.approx(8 * d * pairs / 67e12 + 8 * pairs / 34e12)
    assert 0.015 < least < 0.017


def group_tiny_cell():
    sys.path.insert(0, str(TINY.parent))
    import group_tiny

    return group_tiny.tiny()


@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_the_card():
    """The control at the cell's own size on one card, three seeds; the
    port on the cell's four cards where the machine has them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's size")
    c = cells.load("as60_hk_norm_ring4")
    for seed in (101, 102, 103):
        ctl = window.execute(c, seed, 1e9, False, "cuda", 0.0,
                             system=control.Control(c), max_reps=1)
        nums = check.numbers(ctl)
        assert not check.correct(nums), nums
        if torch.cuda.device_count() >= c.chips:
            prog = group.execute(c, seed, 1e9, False, "cuda",
                                 time.perf_counter(), max_reps=1)
            nums = check.numbers(prog)
            assert check.correct(nums), nums
