"""The churn kind on the CPU: a tiny streaming cell added to the tiny
checkout as files only, run whole (untraced, traced, the control) and
with two planted faults that must come out not correct: a removal whose
repair is skipped, and a search that returns one removed id.  The tiny
cell lists the metrics that the real churn cell lists."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from hnswbench import harness, registry, sut
from hnswbench.conftest import ROOT, TINY_INDEX, _dump, make_tiny_root

SEED = 2 ** 31 + 977
CELL = "tiny-stream.churn"
REAL_CELL = "msturing-stream-1m.knn-churn"
METRICS = ("churn.remove_host_ms_per_krow", "churn.candidates_ms_per_krow",
           "churn.repair_ms_per_krow", "churn.affected_per_removed",
           "churn.step_search_s")


@pytest.fixture(scope="module")
def churn_root(tmp_path_factory):
    """The tiny checkout with a churn configuration, mix and cell added as
    files: 2,400 rows of 24 clusters, 3 rounds of deleting 2 clusters each
    (about 8% of the live set, so "auto" repairs as "fast")."""
    root = make_tiny_root(tmp_path_factory.mktemp("churn"))
    hb = root / "hnswbench"
    _dump(hb / "configs" / "tiny-stream.json", dict(
        name="tiny-stream", rows=2400, dim=32, metric="sq_euclid",
        index=dict(TINY_INDEX, allow_removals=True, remove_quality="auto"),
        data=dict(generator="clustered", rows_per_cluster=100, noise=0.03,
                  normalize=False), reduced=[]))
    _dump(hb / "traffic" / "tiny-churn.json", dict(
        kind="churn", request_queries=64, pool=4096, k=10, warmup_requests=1,
        check_queries=200, sample_from=1024, rounds=3, clusters_per_round=2,
        step_queries=64))
    _dump(hb / "workloads" / f"{CELL}.json",
          {"limits": {"dist_err": 1e-5, "recall_miss": 0.10}})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny-stream", source="tiny",
                                 reduced=[], why="test",
                                 file="hnswbench/configs/tiny-stream.json"))
    bench["workloads"].append(dict(name=CELL, config="tiny-stream",
                                   traffic="tiny-churn", chips=1, why="test"))
    for m in bench["per_layer"]:
        if REAL_CELL in _real_cells(m["name"]):
            m["workloads"].append(CELL)
    _dump(root / "BENCHMARK.json", bench)
    return root


def _real_cells(metric: str) -> list:
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next(m for m in real["per_layer"]
                if m["name"] == metric).get("workloads", [])


def _run(root, trace=False, system="program", seconds=1.0, **kw):
    torch.set_num_threads(2)
    return harness.run_cell(registry.load_cell(CELL, root), SEED, seconds,
                            trace, "cpu", system=system, **kw)


def test_untraced_run_is_correct(churn_root):
    res = _run(churn_root)
    assert res["correct"], res["checks"]
    assert res["checks"]["malformed"]["value"] == 0
    assert set(res["metrics"]) == {"setup_s", "recall_at_10"}


def test_traced_run_reports_the_churn_metrics(churn_root, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.5)
    res = _run(churn_root, trace=True, seconds=1.5)
    assert res["correct"], res["checks"]
    listed = {m["name"] for m in registry.load_cell(CELL, churn_root).per_layer}
    assert set(METRICS) <= listed and len(listed) > len(METRICS)
    assert set(res["metrics"]) == listed
    for name in listed:
        assert isinstance(res["metrics"][name]["value"], (int, float)), name
    for name in METRICS:
        assert res["metrics"][name]["value"] > 0, name


def test_control_is_not_correct(churn_root):
    res = _run(churn_root, system="control", max_requests=20)
    assert not res["correct"]
    assert res["checks"]["dist_err"]["value"] > \
        res["checks"]["dist_err"]["limit"]


def test_repair_skipped_is_not_correct(churn_root, monkeypatch):
    """Removed rows marked and cleared, the affected rows not re-pruned:
    their edges into freed slots reach the fresh rows put there."""
    from hnswindex_torch.core import remove
    monkeypatch.setattr(remove, "_repair_rows", lambda *a, **k: None)
    res = _run(churn_root)
    assert not res["correct"], res["checks"]


class _ReturnsRemoved(sut.Program):
    """The program answering one removed id in place of its first answer
    while the free list holds removed slots."""

    def knn_query(self, q, k):
        ids, d = super().knn_query(q, k)
        if self.index._free:
            ids = ids.copy()
            ids[0, 0] = self.index._free[-1]
        return ids, d


def test_a_removed_id_returned_is_not_correct(churn_root, monkeypatch):
    monkeypatch.setitem(sut.SYSTEMS, "returns_removed", _ReturnsRemoved)
    res = _run(churn_root, system="returns_removed")
    assert not res["correct"]
    assert res["checks"]["malformed"]["value"] > 0


def test_the_kind_keeps_the_live_set(churn_root):
    """After the rounds the live count is the configuration's rows, every
    refill took a freed slot, and each id maps to one stream row."""
    cell = registry.load_cell(CELL, churn_root)
    kind = registry.kind(cell)
    from hnswbench import datagen
    torch.set_num_threads(2)
    data = datagen.Clustered(cell.config, SEED, "cpu")
    st = kind.setup(sut.SYSTEMS["program"], cell, data, "cpu")
    rows = st.row_of_id
    assert (rows >= 0).all() and np.unique(rows).size == rows.size
    assert st.bad_adds == 0 and st.used == 2400 + st.setup["removed"]
    assert st.sut.index.count == 2400 and st.sut.index._length == 2400
    assert len(st.setup["rounds"]) == 3
    assert all(r["removed"] > 0 for r in st.setup["rounds"])
    rp = st.setup["round_phases"]
    assert rp["remove.ids"] == st.setup["removed"]
    assert rp["add.reused"] == st.setup["removed"]
    assert rp["pack.builds"] == 3
    # the index's own timer holds what it holds in a knn cell: the one
    # build from empty and the warm-ups' pack
    ph = st.sut.phase_seconds()
    assert "remove" not in ph and ph.get("add.reused", 0) == 0
    assert ph["pack.builds"] == 1 and ph["wave"] > 0
    assert st.setup["rows"] == 2400
    assert st.setup["add_s"] > 0 and st.setup["first_query_s"] > 0
    st.sut.close()
