"""The reader of K6's share of its roofline on a synthetic trace: 12
planes of the cell's (n, d) at Z's width, times the launches by kernel
name, over their device time; nothing where the trace holds no K6 launch
(the dense-monodromy cells, a port without K6) or the card has no peaks."""

import types

import pytest

from metrics import k6_roofline
from semibench import cell, peaks, trace

BENCH = cell.load_json(cell.ROOT / "BENCHMARK.json")
KERNEL = ("void (anonymous namespace)::diag_mono_kernel<double, 2>("
          "(anonymous namespace)::Args<double>)")
PEAK = {"bytes_per_s": 3.35e12, "flops_per_s": {"float64": 34e12}}


def _run(op_s, op_n, name="as60_hk_f64", world=1):
    summary = trace.Summary(busy_s=4.0, window_s=4.1, device_ops=1000,
                            op_s=op_s, op_n=op_n, idle_s={})
    return types.SimpleNamespace(trace=summary, device=None, world=world,
                                 cell=cell.load(name, BENCH))


def test_as60_bytes():
    task = cell.load("as60_hk_f64", BENCH).task
    assert k6_roofline.least_bytes(task) == 12 * 98304 * 60 * 8
    assert k6_roofline.least_bytes(dict(task, precision="comp32")) == (
        12 * 98304 * 60 * 4)


def test_share_of_the_launches(monkeypatch):
    monkeypatch.setattr(peaks, "of", lambda device: PEAK)
    least = 12 * 98304 * 60 * 8 / 3.35e12
    run = _run({KERNEL: 500 * least / 0.8, "other_kernel": 1.0},
               {KERNEL: 500, "other_kernel": 7})
    assert k6_roofline.read(run) == pytest.approx(80.0)


def test_nothing_to_read(monkeypatch):
    monkeypatch.setattr(peaks, "of", lambda device: PEAK)
    assert k6_roofline.read(_run({"other_kernel": 1.0},
                                 {"other_kernel": 7})) is None
    assert k6_roofline.read(types.SimpleNamespace(trace=None,
                                                  device=None)) is None
    monkeypatch.setattr(peaks, "of", lambda device: None)
    assert k6_roofline.read(_run({KERNEL: 1.0}, {KERNEL: 5})) is None


def test_a_rank_counts_its_share_of_the_batch(monkeypatch):
    """In the four-card cell a rank's K6 steps 131,072 / 4 rows."""
    monkeypatch.setattr(peaks, "of", lambda device: PEAK)
    least = 12 * 32768 * 60 * 8 / 3.35e12
    run = _run({KERNEL: 2000 * least / 0.9}, {KERNEL: 2000},
               name="as60_hk_norm_ring4", world=4)
    assert k6_roofline.read(run) == pytest.approx(90.0)
