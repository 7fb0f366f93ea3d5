"""`BENCHMARK.json` and the files it names: a cell's configuration
(`configs/<config>.json`), traffic (`traffic/<traffic>.json`), limits
(`limits/<workload>.json`), per-layer metric readers
(`metrics/<metric>.py`), the driver of the traffic's kind
(`harness/<kind>.py`), and the configuration's training recipe
(`recipes/<recipe>.py`) and plain reference (`reference/<name>.py`).
Everything is found by name, so a new cell, mix, kind, recipe,
configuration or metric is new files and entries only."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _from_file(path: Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_module(package: str, name: str, bench_dir: Path = BENCH_DIR):
    """`<package>/<name>.py` of the benchmark at `bench_dir`: imported by
    name from this checkout's benchmark, else loaded from its file."""
    if bench_dir.resolve() == BENCH_DIR:
        return importlib.import_module(f"{package}.{name}")
    return _from_file(bench_dir / package / f"{name}.py",
                      f"{package}_{name}_{abs(hash(str(bench_dir)))}")


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """The `read(ctx)` of `metrics/<name>.py`."""
    return _from_file(bench_dir / "metrics" / f"{name}.py",
                      "metric_" + name.replace(".", "_").replace("-", "_")
                      ).read


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)
    driver: type = None     # harness/<kind>.py's `Cell`
    recipe: object = None   # recipes/<recipe>.py, where the config names one
    reference: object = None    # reference/<reference>.py


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    """A per-layer metric is read in the cells it lists, or else in every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def find_cell(name: str, bench: dict, root: Path = ROOT) -> Cell:
    """The workload `name` with its files, under the checkout `root`."""
    bench_dir = root / "benchmark"
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(root / cfg_entry["file"])
    traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _json(bench_dir / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    cell = Cell(name, w, config, traffic, limits, e2e, per_layer)
    cell.readers = {m["name"]: load_reader(m["name"], bench_dir)
                    for m in per_layer}
    cell.driver = load_module("harness", traffic["kind"], bench_dir).Cell
    cell.reference = load_module("reference", config["reference"], bench_dir)
    if "recipe" in config:
        cell.recipe = load_module("recipes", config["recipe"], bench_dir)
    return cell
