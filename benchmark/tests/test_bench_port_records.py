"""The readers of the port's own tracing record on a synthetic record: the
time loop's sections in ms a step, the host reads, and the idle time no
host range names; each gives nothing where the run holds no trace, where
the control ran in the port's place, or where the port keeps no record
(a checkout older than its tracing)."""

import importlib
import types

import pytest

from semibench import trace

SECTIONS = ("prefactor", "wm_derived", "observables", "window",
            "integrator", "monodromy")
RECORD = {"spans": {"sample.draw": {"s": 0.002, "n": 1}},
          "counters": {"host_reads": 6},
          "sections": {"prefactor": 0.5, "wm_derived": 1.25,
                       "observables": 0.75, "window": 0.125,
                       "integrator": 2.0, "monodromy": 1.5, "slots": 0.01},
          "steps": 500}


def _summary(idle):
    return trace.Summary(busy_s=4.0, window_s=4.1, device_ops=1000, op_s={},
                         op_n={}, idle_s=idle)


def _run(counters=None, summary=None):
    return types.SimpleNamespace(
        counters={"captures": 0, "eager_blocks": 0} if counters is None
        else counters,
        trace=_summary({}) if summary is None else summary)


@pytest.fixture
def record(monkeypatch):
    from semiclassical_tpu_torch import profiling

    monkeypatch.setattr(profiling, "records", lambda: RECORD)
    return RECORD


def _reader(name):
    return importlib.import_module(f"metrics.{name}").read


@pytest.mark.parametrize("section", SECTIONS)
def test_section_readers(record, section):
    read = _reader(f"loop_{section}_ms_per_step")
    assert read(_run()) == pytest.approx(
        1e3 * record["sections"][section] / record["steps"])
    # the control in the port's place, a run with no trace
    assert read(_run(counters={})) is None
    assert read(types.SimpleNamespace(counters={"captures": 0},
                                      trace=None)) is None


def test_a_section_that_did_not_run_reads_nothing(monkeypatch):
    from semiclassical_tpu_torch import profiling

    hk = dict(RECORD, sections={"prefactor": 0.5})
    monkeypatch.setattr(profiling, "records", lambda: hk)
    assert _reader("loop_wm_derived_ms_per_step")(_run()) is None
    monkeypatch.setattr(profiling, "records", lambda: dict(hk, steps=0))
    assert _reader("loop_prefactor_ms_per_step")(_run()) is None


def test_host_reads_reader(record):
    read = _reader("host_reads_per_rep")
    assert read(_run()) == 6
    assert read(_run(counters={})) is None


@pytest.mark.parametrize("name", [f"loop_{s}_ms_per_step" for s in SECTIONS]
                         + ["host_reads_per_rep"])
def test_readers_of_a_port_without_records(monkeypatch, name):
    from semiclassical_tpu_torch import profiling

    monkeypatch.delattr(profiling, "records")
    assert _reader(name)(_run()) is None
    monkeypatch.undo()
    monkeypatch.setattr(profiling, "records", lambda: None)
    assert _reader(name)(_run()) is None


def test_idle_unnamed_reader():
    read = _reader("idle_unnamed_ms")
    idle = {"sample: no host op": 0.0115, "reduce: no host op": 0.0052,
            "scan: semi.scan.read": 0.004, "sample: aten::mm": 0.001,
            "outside spans: no host op": 0.0003}
    assert read(_run(summary=_summary(idle))) == pytest.approx(17.0)
    assert read(_run(summary=_summary({"scan: cudaGraphLaunch": 0.01}))) \
        == 0.0
    no_device = trace.Summary(busy_s=0.0, window_s=1.0, device_ops=0,
                              op_s={}, op_n={}, idle_s=idle)
    assert read(_run(summary=no_device)) is None
    assert read(types.SimpleNamespace(counters={}, trace=None)) is None
