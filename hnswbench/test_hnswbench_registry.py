"""BENCHMARK.json against the benchmark's contract, and every piece of it
found by its name; a cell added as files is taken up with no harness file
edited."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from hnswbench import registry
from hnswbench.conftest import HERE, ROOT, TINY_CELLS

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hnswbench"]
    assert BENCH["command"] == ["python3", "hnswbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hnswbench/")
        assert 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_and_reports_enough(cell):
    c = registry.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)
    assert registry.kind(c).request
    for m in c.per_layer:
        assert callable(registry.metric_reader(c, m["name"]))
    assert c.settings["limits"]["dist_err"] > 0
    assert 0 < c.settings["limits"]["recall_miss"] < 1


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_file_holds_its_sizes(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert data["metric"] in ("sq_euclid", "cosine")
    for key in ("rows", "dim", "index", "data", "guarantees", "assumed"):
        assert key in data


def test_files_under_paths_are_named_from_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_new_cell_taken_up_from_files_alone(tiny_root: Path):
    """The tiny checkout adds configurations, mixes and cells as files
    only; the harness's own files are the repository's, byte for byte."""
    for p in HERE.rglob("*.py"):
        if "__pycache__" in p.parts:
            continue
        copy = tiny_root / "hnswbench" / p.relative_to(HERE)
        assert copy.read_bytes() == p.read_bytes(), p.name
    for name, cfg, traffic in TINY_CELLS:
        c = registry.load_cell(name, tiny_root)
        assert c.config["name"] == cfg
        assert c.traffic == json.loads(
            (tiny_root / "hnswbench" / "traffic" / f"{traffic}.json")
            .read_text())
        with pytest.raises(KeyError):
            registry.load_cell(name)
