"""Find a cell's files by the names ``BENCHMARK.json`` gives.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own:

- ``configs/<config>.json`` (the path in the config's ``file`` entry):
  the model configuration as it is run, field by field, and the
  published training recipe;
- ``traffic/<traffic>.json``: the generator's parameters;
- ``workloads/<cell>.json``: the entry the window drives and the limits
  of the comparison that decides ``correct``;
- ``metrics/<metric>.py``: a ``read(summary)`` for one per-layer metric.

A new cell, configuration or metric is a new file and a new entry;
nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    workload: dict      # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def entry(self) -> str:
        return self.workload["entry"]


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_metrics(bench: dict, name: str):
    """(end-to-end, per-layer) metric entries the cell reports: those that
    list it under ``workloads``, or list no cells; a per-layer metric
    without a list goes wherever its ``moves`` metric is reported."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    e2e, per = cell_metrics(bench, name)
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=load_json(root / cfgs[w["config"]]["file"]),
        traffic=load_json(root / "portbench" / "traffic"
                          / f"{w['traffic']}.json"),
        workload=load_json(root / "portbench" / "workloads" / f"{name}.json"),
        end_to_end=e2e, per_layer=per)


def metric_reader(name: str, root: Path = ROOT
                  ) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_fields(config: dict) -> Dict:
    """The ``ModelConfig`` keyword arguments of a config file's ``model``
    (JSON lists back to tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in config["model"].items()}
