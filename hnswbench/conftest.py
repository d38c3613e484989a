"""Fixtures of the benchmark's own tests: a checkout in a temporary
directory that holds the harness as it is and a benchmark of tiny cells
that runs on the CPU in seconds.  Nothing here imports jax."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

TINY_INDEX = {"max_edges": 16, "max_candidates": 100, "max_wave_size": 64,
              "min_nn": 32, "pack_min_count": 0}

TINY_CONFIGS = {
    "tiny-l2": {"rows": 2400, "dim": 32, "metric": "sq_euclid",
                "data": {"generator": "clustered", "rows_per_cluster": 300,
                         "noise": 0.03, "normalize": False}},
    "tiny-cos": {"rows": 2400, "dim": 24, "metric": "cosine",
                 "data": {"generator": "clustered", "rows_per_cluster": 300,
                          "noise": 0.03, "normalize": True}},
}

TINY_TRAFFIC = {
    "tiny-batch": {"kind": "knn", "request_queries": 64, "pool": 4096,
                   "k": 10, "warmup_requests": 1, "check_queries": 200,
                   "sample_from": 1024},
    "tiny-online": {"kind": "knn", "request_queries": 1, "pool": 300,
                    "k": 10, "warmup_requests": 3, "check_queries": 100,
                    "sample_from": 100},
}

TINY_CELLS = [("tiny-l2.batch", "tiny-l2", "tiny-batch"),
              ("tiny-cos.online", "tiny-cos", "tiny-online")]


def _dump(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_tiny_root(tmp: Path) -> Path:
    """A checkout with the harness copied as it is, tiny configurations,
    mixes and cells added as files, and a BENCHMARK.json naming them with
    the real benchmark's metrics."""
    shutil.copytree(HERE, tmp / "hnswbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in TINY_CONFIGS.items():
        _dump(tmp / "hnswbench" / "configs" / f"{name}.json",
              dict(cfg, name=name, index=TINY_INDEX, reduced=[]))
    for name, mix in TINY_TRAFFIC.items():
        _dump(tmp / "hnswbench" / "traffic" / f"{name}.json", mix)
    for name, _, _ in TINY_CELLS:
        _dump(tmp / "hnswbench" / "workloads" / f"{name}.json",
              {"limits": {"dist_err": 1e-5, "recall_miss": 0.10}})

    def cells_of(m):
        if "workloads" not in m:
            return m
        return dict(m, workloads=[c for c, _, _ in TINY_CELLS])

    bench = dict(real,
                 configs=[dict(name=n, source="tiny", reduced=[], why="test",
                               file=f"hnswbench/configs/{n}.json")
                          for n in TINY_CONFIGS],
                 workloads=[dict(name=c, config=cfg, traffic=t, chips=1,
                                 why="test") for c, cfg, t in TINY_CELLS],
                 end_to_end=[cells_of(m) for m in real["end_to_end"]],
                 per_layer=[cells_of(m) for m in real["per_layer"]])
    _dump(tmp / "BENCHMARK.json", bench)
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))
