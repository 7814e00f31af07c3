# coding: utf-8
"""The port's tracing (`profiling`) on the CPU, at test scale.

* Tracing off records nothing, and the time loop makes no section clock.
* Under a CPU `torch.profiler` session each path's sections appear, with
  the steps run: HK on the diagonal (AS) path, HK taylor on the vendored
  sGDML coumarin fixture, WM on the diagonal path (with the assembly of
  K5's input planes as a section of its own) and WM taylor on the dense
  path; every `semi.` range is a `cpu_op` and none a `user_annotation`.
* The record starts anew with each session; `host_reads` counts a
  repetition's device-to-host reads.
* On a loop that captures (the graph tests' `ReplayGraph`), each block's
  twin is captured beside its graph and replayed only while tracing is
  on, with the same results.
* The CLI's `--trace FILE` writes a Chrome trace and logs the sections.
"""

import json
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from semiclassical_tpu_torch import cli, profiling
from semiclassical_tpu_torch.io.results import (accumulate_results,
                                                init_results)
from semiclassical_tpu_torch.propagation import graph
from test_torch_port_graph import ReplayGraph, _coumarin, _morse, _propagator

AS5 = "AnharmonicAS/5modes/AS_model_chi0.02.dat"
LOOP = {"prefactor", "observables", "integrator", "monodromy", "slots"}
SAMPLE = {"sample.propagator", "sample.params", "sample.draw",
          "sample.stats", "sample.state", "sample.batch_constants",
          "sample.trackers"}
SCAN = {"scan.load", "scan.block", "scan.read"}
REDUCE = {"reduce.load", "reduce.save"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_live_loop():
    """No time loop and no tracing at each test's start and end; a record
    call with tracing off there ends the last session's record."""
    def reset():
        graph.clear()
        profiling.enable(False)
        profiling.count("host_reads")

    reset()
    yield
    reset()


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _repetition(tmp_path, name="HK", model=None, nt=12, dt=2.0, ntraj=16,
                **kw):
    """One repetition as the CLI runs it: a propagator and its draw,
    `propagate`, the accumulation into a results file; returns
    (the propagator, its outputs)."""
    pot, q0, G = _morse() if model is None else model
    prop = _propagator(name, pot, q0, G, ntraj=ntraj)
    out = prop.propagate(pot, dt, nt, **kw)
    results = tmp_path / f"c{nt}.npz"
    if not results.exists():
        init_results(str(results), name, np.arange(nt), 0.0, 0.0)
    accumulate_results(str(results), out[0], out[1], prop.ntraj)
    return prop, out


def test_tracing_off_records_nothing(tmp_path):
    with _session():
        _repetition(tmp_path)
    before = profiling.records()
    assert before["steps"] == 12
    graph.clear()
    assert not profiling.tracing()
    _repetition(tmp_path)
    assert profiling.records() == before
    assert graph.live("cpu").sections is None


# WM's separable path (AS) times the assembly of K5's input planes apart;
# the dense path (taylor) has no such section
PATHS = [("HK", "as", 12, LOOP),
         ("HK", "taylor", 16, LOOP | {"window"}),
         ("WM", "as", 12, LOOP | {"wm_inputs", "wm_derived"}),
         ("WM", "taylor", 16, LOOP | {"window", "wm_derived"})]


@pytest.mark.parametrize("name, model, nt, sections", PATHS,
                         ids=[f"{p[0]}-{p[1]}" for p in PATHS])
def test_each_paths_sections_appear(ref_data, tmp_path, name, model, nt,
                                    sections):
    kw = {}
    if model == "taylor":
        pot, x0, G, dt = _coumarin(ref_data)
        kw = dict(model=(pot, x0, G), dt=dt, ntraj=8, chunk=nt)
    with _session():
        _repetition(tmp_path, name, nt=nt, **kw)
    rec = profiling.records()
    assert rec["steps"] == nt
    assert set(rec["sections"]) == sections
    assert all(s > 0 for s in rec["sections"].values())
    assert SAMPLE | SCAN | REDUCE <= set(rec["spans"])
    assert rec["spans"]["scan.read"]["n"] == 1
    assert rec["spans"]["sample.draw"]["n"] == 1


def test_semi_ranges_are_cpu_ops(tmp_path):
    with _session() as prof:
        _repetition(tmp_path, nt=4)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    semi = [e for e in events if str(e.get("name", "")).startswith("semi.")]
    assert {e["name"].removeprefix("semi.") for e in semi} == \
        SAMPLE | SCAN | REDUCE
    assert {e.get("cat") for e in semi} == {"cpu_op"}


def test_the_record_starts_anew_with_each_session(tmp_path):
    with _session():
        _repetition(tmp_path, nt=8)
    first = profiling.records()
    # an untraced call between the sessions
    _repetition(tmp_path, nt=4)
    assert profiling.records() == first
    with _session():
        _repetition(tmp_path, nt=4)
    second = profiling.records()
    assert (first["steps"], second["steps"]) == (8, 4)
    assert second["spans"]["sample.draw"]["n"] == 1
    assert second["counters"] == first["counters"]
    # a session's record holds every call of the session
    profiling.enable()
    _repetition(tmp_path, nt=4)
    _repetition(tmp_path, nt=4)
    assert profiling.records()["steps"] == 8
    assert profiling.records()["spans"]["scan.read"]["n"] == 2


@pytest.mark.parametrize("error_bars, chunk, reads", [
    (False, None, 5), (True, 4, 9)], ids=["plain", "error-bars-progress"])
def test_host_reads_count_the_repetitions_reads(tmp_path, error_bars, chunk,
                                                reads):
    """The sampling statistics and the weight scale, then C(t), k~ic(t),
    the energies (and the second moments) at the end of `propagate`, and
    one read a segment for `progress`."""
    seen = []
    with _session():
        _repetition(tmp_path, nt=12, error_bars=error_bars, chunk=chunk,
                    progress=(lambda *a: seen.append(a)) if chunk else None)
    assert len(seen) == (3 if chunk else 0)
    assert profiling.records()["counters"] == {"host_reads": reads}


def test_twins_replay_only_while_tracing(monkeypatch, tmp_path):
    monkeypatch.setattr(graph, "SegmentGraph", ReplayGraph)
    monkeypatch.setattr(graph, "BLOCK_STEPS", 4)
    stats = dict(graph.STATS)
    model = _morse()
    # the first call warms up each block length, the second captures
    for _ in range(2):
        _repetition(tmp_path, model=model, nt=10)
    lengths = len(set(graph.block_lengths(10)))
    delta = {k: graph.STATS[k] - stats[k] for k in stats}
    assert delta["captures"] == delta["trace_captures"] == lengths == 2
    loop = graph.live("cpu")
    assert all(b.twin is not None for b in loop.blocks.values())
    _, plain = _repetition(tmp_path, model=model, nt=10)
    with _session():
        _, traced = _repetition(tmp_path, model=model, nt=10)
    rec = profiling.records()
    assert rec["steps"] == 10 and set(rec["sections"]) == LOOP
    for a, b in zip(plain, traced):
        assert np.array_equal(a, b)
    delta = {k: graph.STATS[k] - stats[k] for k in stats}
    assert delta["captures"] == delta["trace_captures"] == 2
    assert delta["eager_blocks"] == 2


def test_cli_trace_writes_a_chrome_trace(ref_data, tmp_path, caplog):
    task = {"task": "dynamics",
            "potential": {"type": "anharmonic AS",
                          "model_file": str(ref_data / AS5)},
            "batch_size": 16, "num_trajectories": 16, "num_steps": 10,
            "time_step_fs": 0.05, "manual_seed": 3,
            "results": {"correlations": str(tmp_path / "c.npz")}}
    (tmp_path / "semi.json").write_text(json.dumps({"semi": [task]}))
    trace = tmp_path / "trace.json"
    with caplog.at_level(logging.INFO, logger="semiclassical_tpu_torch"):
        cli.main(["dynamics", str(tmp_path / "semi.json"), "--device", "cpu",
                  "--trace", str(trace)])
    assert not profiling.tracing()
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"semi.sample", "semi.scan", "semi.reduce",
            "semi.scan.block"} <= names
    log = caplog.text
    for name in LOOP:
        assert f"section {name}" in log
    assert "host reads: 6 (10 steps traced)" in log
