"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells.  Everything that
belongs to one configuration, traffic mix, metric or model family sits in a
file of its own under ``perfbench/``, which this module finds by the name
the cell gives:

    configs/<file named by the configuration's "file">   sizes and sources
    traffic/<traffic>.json                                the generator's parameters
    limits/<workload>.json                                the correctness limits
    metrics/<metric>.py                                   one reader per metric
    reference/<family>.py                                 the plain model
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    root: Path
    bench: dict  # BENCHMARK.json
    workload: dict  # its entry in "workloads"
    config: dict  # its entry in "configs"
    conf: dict  # the configuration's file
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<workload>.json

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def model(self) -> dict:
        return self.conf["model"]

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: its end-to-end ones, or with
        ``trace`` its per-layer ones (those naming the cell, or naming none)."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(by_name)}")
    workload = by_name[name]
    config = {c["name"]: c for c in bench["configs"]}[workload["config"]]
    return Cell(
        root=root, bench=bench, workload=workload, config=config,
        conf=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((root / "perfbench" / "traffic" / f"{workload['traffic']}.json")
                           .read_text()),
        limits=json.loads((root / "perfbench" / "limits" / f"{name}.json").read_text()),
    )


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """``metrics/<name>.py`` loaded as a module; its ``read(run)`` returns
    the metric's value, or None where the run has nothing to read."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(family: str) -> ModuleType:
    """``reference/<family>.py``: ``leaves(model)``, ``float32_leaf(name)``
    and ``logits(model, weights, tokens, n_last, ...)``."""
    return importlib.import_module(f"perfbench.reference.{family}")


def read_metrics(cell: Cell, run, trace: bool) -> Dict[str, dict]:
    """Each of the cell's metrics that its reader finds, with its unit."""
    out = {}
    for m in cell.metrics(trace):
        value = metric_reader(m["name"], cell.root).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
