"""A cell as the files describe it: its entry in BENCHMARK.json, its
workload file and its configuration file, merged into one dynamics task in
the port's JSON schema."""

import dataclasses
import importlib
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict       # the cell's entry in BENCHMARK.json
    workload: dict    # workloads/<cell>.json
    config: dict      # configs/<config>.json
    task: dict        # the dynamics task: the config's keys, the traffic's
    metrics: dict     # {"end_to_end": [...], "per_layer": [...]} of the cell

    @property
    def chips(self):
        return int(self.entry["chips"])

    def work(self):
        """The configuration's least-work model, `work/<config>.py`."""
        return importlib.import_module(f"work.{self.config['name']}")


# the configuration file's keys that are not keys of the dynamics task
CONFIG_ONLY = ("name", "source", "example", "reduced", "source_values",
               "assumed")


def make_task(config, traffic):
    """The dynamics task: the configuration's task keys, then the traffic's
    keys over them."""
    task = {k: v for k, v in config.items() if k not in CONFIG_ONLY}
    task.update(traffic)
    return task


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load(name, bench=None):
    """The cell `name` of BENCHMARK.json (or of the dict `bench`)."""
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(entries)})")
    entry = entries[name]
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = load_json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise SystemExit(f"workloads/{name}.json says {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    metrics = {kind: [m for m in bench[kind] if _applies(m, name)]
               for kind in ("end_to_end", "per_layer")}
    return Cell(name=name, entry=entry, workload=workload, config=config,
                task=make_task(config, workload["task"]), metrics=metrics)
