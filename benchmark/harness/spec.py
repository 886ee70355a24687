"""The cell a run measures, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file and its per-layer readers."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file, as run
    traffic: dict  # the traffic file: generator, its parameters, limits
    end_to_end: list  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list  # BENCHMARK.json's per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: Path | None = None) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its files. Raises
    KeyError for a name the file does not hold."""
    spec = json.loads((spec_path or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (BENCH_DIR / "workloads" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def load_reader(metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
