"""The benchmark's files as its readers need them: BENCHMARK.json's shape,
every cell's and configuration's file, a reader for every metric, and the
least-work counts against the kernels' bounds of PERF.md's kernel table."""

import ast
import importlib
import json
import math
import re

import pytest

from semibench.cell import BENCH_DIR, ROOT, load, load_json

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
# widths, which a configuration's `reduced` may never name
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per|num_modes")


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fit_the_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_metric_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("host_clock", "device_trace",
                               "program_span", "program_counter")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        layers.add(m["layer"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    c = load(cell, BENCH)
    entry = c.entry
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and _line(entry["why"])
    assert NAME.match(entry["traffic"])
    reported = {m["name"] for m in c.metrics["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.metrics["per_layer"]
    for m in c.metrics["per_layer"]:
        assert m["moves"] in reported
    # the traffic changes no value the configuration states: every cut
    # of the configuration is in its `reduced`
    for key, value in c.workload["task"].items():
        assert c.config.get(key, value) == value, key
    assert c.task["precision"] == c.config["precision"]
    ref = importlib.import_module(f"reference.{c.workload['reference']}")
    assert callable(ref.repetition)
    assert set(c.workload["limits"]) >= {"c_gap", "k_gap", "npz_gap"}
    assert all(0 < v < 1e-3 for v in c.workload["limits"].values())


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("benchmark/configs/")
    data = load_json(ROOT / config["file"])
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert _line(config["source"]) and _line(config["why"])
    for key in config["reduced"]:
        assert NAME.match(key) and key in data and not WIDTH.search(key)
        assert key in data["source_values"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert callable(importlib.import_module(f"work.{config['name']}").step)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    path = BENCH_DIR / "metrics" / f"{metric['name']}.py"
    tree = ast.parse(path.read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
               for n in tree.body)


def test_as60_step_work():
    from work import as60

    c = load("as60_hk_f64", BENCH)
    w = as60.step(c.task)
    # 98,304 x (6 x 60 + 4) numbers read and written, 4 constants read
    assert w["bytes"] == 8 * 98304 * (2 * 364 + 4)
    assert w["bytes"] / 3.35e12 > w["flops"]["float64"] / 34e12


def _bound_ms(work):
    peaks = load_json(BENCH_DIR / "peaks.json")["cards"][
        "NVIDIA H100 80GB HBM3"]
    return 1e3 * max(work["bytes"] / peaks["bytes_per_s"],
                     sum(f / peaks["flops_per_s"][t]
                         for t, f in work["flops"].items()))


def test_kernel_bounds_match_the_kernel_table():
    from work import kernels

    assert math.isclose(_bound_ms(kernels.lu_det(2048, 45)), 0.0198,
                        abs_tol=5e-5)
    for k, want in ((90, 0.1087), (45, 0.0650), (5, 0.0262)):
        assert math.isclose(_bound_ms(kernels.gj_solve(2048, 45, k)), want,
                            abs_tol=5e-5)
