"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file is the one its ``configs`` entry names; the
mix is ``hnswbench/traffic/<traffic>.json``, whose ``kind`` names the loop
that drives it, ``hnswbench/kinds/<kind>.py``; the cell's own settings
are ``hnswbench/workloads/<cell>.json``; a per-layer metric is read by
``hnswbench/metrics/<metric>.py``.  Adding any of these is adding a file:
no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "hnswbench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    root: Path
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _read(Path(root) / "BENCHMARK.json")


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = benchmark(root)
    w = _entry(bench["workloads"], name, "workload")
    cfg = _entry(bench["configs"], w["config"], "configuration")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name=name, chips=int(w["chips"]), root=root,
                config=_read(root / cfg["file"]),
                traffic=_read(root / PKG / "traffic" / f"{w['traffic']}.json"),
                settings=_read(root / PKG / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def _module(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"{PKG}._{tag}_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(cell: Cell):
    """The module that drives the cell's traffic kind."""
    return _module(cell.root / PKG / "kinds" / f"{cell.traffic['kind']}.py",
                   "kind")


def metric_reader(cell: Cell, name: str):
    """``read(ctx)`` of the per-layer metric ``name``."""
    return _module(cell.root / PKG / "metrics" / f"{name}.py", "metric").read
