"""Finding a cell's parts by name.

`BENCHMARK.json` (at the root of the checkout) names each cell's
configuration and traffic mix. Everything else is found from those names,
so that a later change adds a cell, a configuration, a traffic mix or a
per-layer metric by adding files, without editing one:

- a configuration: the `file` its entry in `BENCHMARK.json` names (under
  `configs/`), whose `family` names the port's adapter in `families/` and
  the plain reference in `reference/`;
- a traffic mix: `workloads/<traffic>.json`, whose `driver` names the
  code in `drivers/` that runs it;
- the limits of a cell's output check: `limits/<cell>.json`;
- a per-layer metric: its reader, `metrics/<metric name>.py`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, root: Path, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return config_file(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def config_file(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / "workloads" / f"{name}.json") as f:
        return json.load(f)


def limits(cell_name: str) -> dict:
    with open(HERE / "limits" / f"{cell_name}.json") as f:
        return json.load(f)["limits"]


def metrics_for(bench: dict, cell_name: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that this cell reports:
    those that list it under `workloads`, or list no cells at all."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def family(name: str):
    return importlib.import_module(f"portbench.families.{name}")


def reference(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(metric: str):
    """The `read(ctx)` of `metrics/<metric>.py` (metric names hold dots,
    so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "portbench_metric_" + metric.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
