# coding: utf-8
"""The port's accumulation mode: the twins of tests/test_multiprocess.py
with port workers.

Independent processes, each with its rank in SEMI_PROCESS_ID and no
coordinator, merge their own batches into one npz through the file lock
of `semiclassical_tpu_torch/io/results.py`. Each rank forces
`results.overwrite` to false (with the JAX package's warning) and folds
its rank into the seed of every repetition, so two ranks that share a
`manual_seed` draw different batches, each reproducible alone.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch import cli
from semiclassical_tpu_torch.io.results import init_results

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the lock under concurrent accumulation (no lost updates)
# ---------------------------------------------------------------------------

_WORKER = r"""
import importlib.util
import sys

# the port's io/results.py alone (numpy only)
spec = importlib.util.spec_from_file_location("results", sys.argv[1])
results = importlib.util.module_from_spec(spec)
spec.loader.exec_module(results)

import numpy as np

filename, value, reps = sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
nt = 4
for _ in range(reps):
    results.accumulate_results(filename, np.ones(nt, dtype=complex),
                               np.full(nt, value, dtype=complex), 1)
print("worker done")
"""


def test_concurrent_accumulation_no_lost_update(tmp_path):
    """Two interpreters accumulate 25 single-trajectory batches each into
    one npz at full speed: every batch survives and the mean is exact."""
    filename = str(tmp_path / "correlations.npz")
    init_results(filename, "HK", np.linspace(0.0, 1.0, 4), 0.0, 0.0)
    results_py = str(REPO / "semiclassical_tpu_torch" / "io" / "results.py")
    reps = 25
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, results_py, filename, str(value),
         str(reps)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for value in (1.0, 3.0)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()
    data = np.load(filename)
    assert int(data["trajectories"]) == 2 * reps, (
        f"lost updates: {int(data['trajectories'])} of {2 * reps} batches")
    assert np.allclose(data["ic_correlation"], 2.0, atol=1e-12)
    assert np.allclose(data["autocorrelation"], 1.0, atol=1e-12)


# ---------------------------------------------------------------------------
# two CLI ranks against their batches run alone
# ---------------------------------------------------------------------------

_RANK_RUNNER = r"""
import sys

sys.path.insert(0, sys.argv[1])
import torch

torch.set_num_threads(1)
from semiclassical_tpu_torch import cli

sys.exit(cli.main(["dynamics", sys.argv[2], "--device", "cpu"]))
"""


def _as_task(model_file, npz, seed=7, ntraj=256, overwrite=True):
    return {"task": "dynamics",
            "potential": {"type": "anharmonic AS",
                          "model_file": str(model_file)},
            "propagator": "HK", "batch_size": ntraj,
            "num_trajectories": ntraj, "num_steps": 6, "time_step_fs": 0.1,
            "manual_seed": seed,
            "results": {"correlations": str(npz), "overwrite": overwrite}}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two concurrent CLI processes with SEMI_PROCESS_ID 0 and 1, one
    manual_seed and `overwrite: true`, sharing one npz; and each rank's
    batch run alone in this process."""
    tmp = tmp_path_factory.mktemp("accumulate")
    model = tmp / "AS_model.dat"
    # one 1500 cm^-1 mode, Huang-Rhys 0.1, chi = 0.02
    model.write_text("1500.0  0.1  0.5  0.02\n")
    shared = tmp / "shared.npz"
    procs = []
    for rank in (0, 1):
        cfg = tmp / f"task{rank}.json"
        cfg.write_text(json.dumps({"semi": [_as_task(model, shared)]}))
        env = dict(os.environ, SEMI_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_RUNNER, str(REPO), str(cfg)],
            env=env, cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        logs.append(out.decode())
        assert p.returncode == 0, logs[-1]
    own = []
    mp = pytest.MonkeyPatch()
    try:
        for rank in (0, 1):
            mp.setenv("SEMI_PROCESS_ID", str(rank))
            npz = tmp / f"own{rank}.npz"
            cli.run_semiclassical_dynamics(_as_task(model, npz), device="cpu")
            own.append(dict(np.load(npz)))
    finally:
        mp.undo()
    return dict(shared=dict(np.load(shared)), own=own, logs=logs)


def test_two_process_cli_accumulation(two_ranks):
    """No lost batch, and the npz is the equal-weight merge of the two
    ranks' batches, whatever their order."""
    data, own = two_ranks["shared"], two_ranks["own"]
    assert int(data["trajectories"]) == 512
    for key in ("autocorrelation", "ic_correlation"):
        merged = 0.5 * (own[0][key] + own[1][key])
        assert np.allclose(data[key], merged, rtol=0, atol=1e-12)


def test_rank_folded_into_the_seed(two_ranks):
    """One manual_seed, two ranks: different batches."""
    own = two_ranks["own"]
    assert not np.allclose(own[0]["ic_correlation"],
                           own[1]["ic_correlation"], atol=1e-12)
    assert cli._repetition_seed(7, 0, 0) != cli._repetition_seed(7, 0, 1)
    assert cli._repetition_seed(7, 2, 1) == int(
        np.random.SeedSequence([7, 1, 2]).generate_state(1)[0])
    # a single process keeps its seeds
    assert cli._repetition_seed(7, 2) == int(
        np.random.SeedSequence([7, 2]).generate_state(1)[0])


def test_overwrite_forced_off_with_a_warning(two_ranks):
    for log in two_ranks["logs"]:
        assert "results.overwrite forced to false" in log
        assert "multi-process accumulation: rank" in log


def test_multiprocess_rank_helper(monkeypatch):
    monkeypatch.delenv("SEMI_PROCESS_ID", raising=False)
    assert cli._multiprocess_rank() == (False, 0)
    monkeypatch.setenv("SEMI_PROCESS_ID", "3")
    assert cli._multiprocess_rank() == (True, 3)
