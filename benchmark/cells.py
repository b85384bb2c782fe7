"""A cell's parts, found by name: its entry in ``BENCHMARK.json``, its
configuration file, ``traffic/<cell>.json`` and the readers of its
per-layer metrics, ``metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass
from typing import Callable, Dict, List

HERE = pathlib.Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]     # BENCHMARK.json entries this cell reports
    per_layer: List[Dict]
    here: pathlib.Path         # the folder its files were found in


def load(root: pathlib.Path, workload: str, here: pathlib.Path = HERE
         ) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; its traffic mix is
    ``here/traffic/<workload>.json``. Raises ``KeyError`` for a cell the
    file does not name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer,
                here)


def reader(name: str, here: pathlib.Path = HERE) -> Callable:
    """``read`` of ``here/metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
