"""A cell of ``BENCHMARK.json``, with its configuration, traffic and limits
files, and the metrics it reports."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# Layouts a later cell may use; traffic files name one under "unit".
UNIT_KINDS = ("analysis", "closure", "refit")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def unit(self) -> str:
        return self.traffic["unit"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    if traffic.get("unit") not in UNIT_KINDS:
        raise SystemExit(f"traffic {w['traffic']!r}: unit {traffic.get('unit')!r} is not one of {UNIT_KINDS}")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=layer)


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark's own files, by path (their names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.parent.name}_{path.stem.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")


def roofline(kernel: str) -> ModuleType:
    return load_module(BENCH_DIR / "roofline" / f"{kernel}.py")
