"""Whole runs of tiny cells on the CPU: the last line's shape, the control
and the faults that must come out not correct, and the refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hnswbench import faults, harness, registry, run, sut
from hnswbench.conftest import ROOT, TINY_CELLS

SEED = 2 ** 31 + 977


def _run(root, cell, trace=False, system="program", seconds=1.0, **kw):
    torch.set_num_threads(2)
    return harness.run_cell(registry.load_cell(cell, root), SEED, seconds,
                            trace, "cpu", system=system, **kw)


def _check_shape(res, cell):
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for m in res["metrics"].values():
        assert set(m) >= {"value", "unit"}
        assert isinstance(m["value"], float)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_untraced_run(tiny_root, cell, capsys):
    res = _run(tiny_root, cell)
    _check_shape(res, cell)
    assert res["correct"], res["checks"]
    want = {m["name"] for m in registry.load_cell(cell, tiny_root).end_to_end}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    harness.emit(res)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(res))
    assert err.strip().splitlines()[-1].startswith("check recall_miss ")


@pytest.mark.parametrize("cell", ["tiny-l2.batch", "tiny-cos.online"])
def test_traced_run(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.5)
    res = _run(tiny_root, cell, trace=True, seconds=1.5)
    _check_shape(res, cell)
    assert res["correct"], res["checks"]
    assert 0 < res["device"]["busy_s"] and 0 < res["device"]["window_s"]
    bd = res["breakdown"]
    assert 0 < len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    c = registry.load_cell(cell, tiny_root)
    assert set(res["metrics"]) == {m["name"] for m in c.per_layer}
    for name, m in res["metrics"].items():
        if name.endswith("roofline") or "idle_share" in name:
            assert 0 < m["value"] <= 100


@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_control_is_not_correct(tiny_root, cell):
    """The reference in TF32 in the program's place fails a check."""
    res = _run(tiny_root, cell, system="control", max_requests=20)
    assert not res["correct"]
    assert res["checks"]["dist_err"]["value"] > \
        res["checks"]["dist_err"]["limit"]


class _Fault(sut.Program):
    """The program with its timed path, every ``knn_query``, broken."""
    fault = ""

    def knn_query(self, q, k):
        if self.fault == "half":           # half of the queries left out
            h = q.shape[0] // 2
            if h == 0:
                return np.empty((0, k), np.int32), np.empty((0, k), np.float32)
            return super().knn_query(q[:h], k)
        ids, d = super().knn_query(q, k)
        if self.fault == "unchanged":      # the last answer, not this one
            last = getattr(self, "_last", (ids, d))
            self._last = (ids, d)
            return last
        ids = ids.copy()
        ids[0, 0] = (ids[0, 0] + 1) % self.index.count   # an answer altered
        return ids, d


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_faults_come_out_not_correct(tiny_root, cell, fault, monkeypatch):
    """Each fault a one-card cell can have (no exchange between cards):
    the run skips the look for a card and drives everything else."""
    broken = type("Broken", (_Fault,), {"fault": fault})
    monkeypatch.setitem(sut.SYSTEMS, "broken", broken)
    res = _run(tiny_root, cell, system="broken")
    assert not res["correct"], res["checks"]


def test_a_window_answers_the_whole_recall_span(tiny_root):
    """A window shorter than the recall sample's span runs on until the
    span is answered, rather than drawing the sample from fewer."""
    cell = registry.load_cell("tiny-cos.online", tiny_root)
    res = _run(tiny_root, "tiny-cos.online", seconds=0.0)
    assert res["attempted"] >= cell.traffic["sample_from"]
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_planted_search_fault_readings(tiny_root, cell):
    """``faults.py`` reads the program at its own efSearch and lower ones
    on one built index; the program's own reading is a sound run's."""
    torch.set_num_threads(2)
    c = registry.load_cell(cell, tiny_root)
    rows = faults.read_seed(c, SEED, [32, 10], 3, device="cpu")
    assert [r["ef"] for r in rows] == [32, 10]
    lim = harness.limits(c)
    assert all(rows[0][n] <= lim[n] for n in lim), rows[0]
    assert rows[1]["malformed"] == 0
    assert rows[1]["recall_miss"] >= rows[0]["recall_miss"]


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "sift1m-m16.knn-batch", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_paths_alone_give_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the files under
    ``paths`` exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "hnswbench", tmp_path / "hnswbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "hnswbench/run.py", "--workload",
                        "sift1m-m16.knn-batch", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
