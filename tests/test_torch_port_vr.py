# coding: utf-8
"""`scripts/torch_vr_flagship_bench.py`, the port's twin of the JAX
package's `scripts/vr_flagship_bench.py`, on the CPU at 64 trajectories x
12 steps and 2 keys, every sampling method:

* each line has the JAX script's keys (read from its source) and "graph";
* the variances are finite, |C(0) - 1| is small on every batch;
* every batch of the study runs through one time loop held by the
  process: the same `SegmentGraph` from the first batch on, and no block
  made after the first batch;
* `main` prints one JSON line per method.
"""

import ast
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch.propagation import graph

REPO = pathlib.Path(__file__).resolve().parents[1]
NTRAJ, NT, KEYS = 64, 12, 2
METHODS = ("pseudo", "sobol", "antithetic")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vr():
    spec = importlib.util.spec_from_file_location(
        "torch_vr_flagship_bench",
        REPO / "scripts" / "torch_vr_flagship_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_line_keys():
    """The keys of the JSON line of the JAX script, from its source."""
    tree = ast.parse((REPO / "scripts" / "vr_flagship_bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in vr_flagship_bench.py")


def test_study_runs_every_batch_through_one_loop(vr):
    graph.clear()
    seen = []

    def on_batch(method, key, prop):
        loop = graph.live("cpu")
        seen.append((method, key, loop, dict(loop.blocks)))

    out = vr.run(NTRAJ, NT, KEYS, METHODS, "cpu", on_batch)
    keys = jax_line_keys()
    assert "var_C" in keys and "device" in keys
    assert [line["method"] for line, _ in out] == list(METHODS)
    for line, (cs, ks) in out:
        assert set(line) == keys | {"graph"}
        assert line["bench"] == "vr_flagship" and line["device"] == "cpu"
        assert (line["ntraj"], line["nt"], line["keys"]) == (NTRAJ, NT, KEYS)
        assert cs.shape == ks.shape == (KEYS, NT)
        for name in ("var_C", "var_kic", "mean_absC_final"):
            assert np.isfinite(line[name]) and line[name] > 0, name
        assert np.abs(cs[:, 0] - 1).max() < 5e-2
        # the CPU runs each block eagerly: 12 steps are blocks of 10 and 2
        assert line["graph"]["eager_blocks"] == 2 * KEYS
        assert line["graph"]["captures"] == line["graph"]["replays"] == 0
    # one loop and one block per length for all 6 batches
    loop, blocks = seen[0][2], seen[0][3]
    assert set(blocks) == {10, 2}
    for method, key, live, now in seen:
        assert live is loop and now == blocks, (method, key)
    graph.clear()


def test_main_prints_a_line_per_method(vr, capsys):
    graph.clear()
    assert vr.main(["--device", "cpu", "--ntraj", "32", "--nt", "3",
                    "--keys", "1", "--methods", "pseudo,antithetic"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["method"] for x in lines] == ["pseudo", "antithetic"]
    assert all(x["ntraj"] == 32 and x["keys"] == 1 for x in lines)
    graph.clear()


def test_draws_follow_the_keys(vr):
    """Key k draws from a generator seeded 1000 + k: two runs of one
    key give one curve, two keys two."""
    graph.clear()
    (_, (a, _)), = vr.run(32, 3, 2, ("pseudo",), "cpu")
    (_, (b, _)), = vr.run(32, 3, 1, ("pseudo",), "cpu")
    assert np.array_equal(a[0], b[0]) and not np.array_equal(a[0], a[1])
    graph.clear()
