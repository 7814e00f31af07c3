"""The reader of K8's share of its roofline on a synthetic trace: in HK
mode 6 planes of the cell's (n, d) and 11 numbers a row, in WM mode 4
planes and 8 numbers a row, at float64, times the launches of each
instantiation by kernel name, over their device time; nothing where the
trace holds no K8 launch (the sGDML cells, a port without K8) or the card
has no peaks."""

import types

import pytest

from metrics import k8_roofline
from semibench import cell, peaks, trace

BENCH = cell.load_json(cell.ROOT / "BENCHMARK.json")
HK = ("void (anonymous namespace)::observe_kernel<(anonymous namespace)::"
      "HkStep, 2>((anonymous namespace)::Args)")
WM = ("void (anonymous namespace)::observe_kernel<(anonymous namespace)::"
      "WmPrefactor, 2>((anonymous namespace)::Args)")
PEAK = {"bytes_per_s": 3.35e12, "flops_per_s": {"float64": 34e12}}


def _run(op_s, op_n, name="as60_hk_f64", world=1):
    summary = trace.Summary(busy_s=4.0, window_s=4.1, device_ops=1000,
                            op_s=op_s, op_n=op_n, idle_s={})
    return types.SimpleNamespace(trace=summary, device=None, world=world,
                                 cell=cell.load(name, BENCH))


def test_as60_bytes():
    task = cell.load("as60_hk_f64", BENCH).task
    assert k8_roofline.least_bytes(task, "HkStep") == (
        (6 * 98304 * 60 + 11 * 98304) * 8)
    wm = cell.load("as60_wm_f64", BENCH).task
    assert k8_roofline.least_bytes(wm, "WmPrefactor") == (
        (4 * 98304 * 60 + 8 * 98304) * 8)


def test_share_of_the_launches(monkeypatch):
    monkeypatch.setattr(peaks, "of", lambda device: PEAK)
    least = (6 * 98304 * 60 + 11 * 98304) * 8 / 3.35e12
    run = _run({HK: 500 * least / 0.8, "other_kernel": 1.0},
               {HK: 500, "other_kernel": 7})
    assert k8_roofline.read(run) == pytest.approx(80.0)


def test_wm_mode(monkeypatch):
    monkeypatch.setattr(peaks, "of", lambda device: PEAK)
    least = (4 * 98304 * 60 + 8 * 98304) * 8 / 3.35e12
    run = _run({WM: 500 * least / 0.75}, {WM: 500}, name="as60_wm_f64")
    assert k8_roofline.read(run) == pytest.approx(75.0)


def test_nothing_to_read(monkeypatch):
    monkeypatch.setattr(peaks, "of", lambda device: PEAK)
    assert k8_roofline.read(_run({"other_kernel": 1.0},
                                 {"other_kernel": 7})) is None
    assert k8_roofline.read(types.SimpleNamespace(trace=None,
                                                  device=None)) is None
    monkeypatch.setattr(peaks, "of", lambda device: None)
    assert k8_roofline.read(_run({HK: 1.0}, {HK: 5})) is None


def test_a_rank_counts_its_share_of_the_batch(monkeypatch):
    """In the four-card cell a rank's K8 observes 131,072 / 4 rows."""
    monkeypatch.setattr(peaks, "of", lambda device: PEAK)
    least = (6 * 32768 * 60 + 11 * 32768) * 8 / 3.35e12
    run = _run({HK: 2000 * least / 0.7}, {HK: 2000},
               name="as60_hk_norm_ring4", world=4)
    assert k8_roofline.read(run) == pytest.approx(70.0)
