"""hnswindex_torch.utils.profiling on the CPU: the phase timer sums its
regions, and ``trace`` counts nested events once in the busy time."""

import time

import torch

from hnswindex_torch.utils.profiling import PhaseTimer, trace

torch.set_num_threads(1)


def test_phase_timer_sums_regions_per_name():
    timer = PhaseTimer("cpu")
    for _ in range(3):
        with timer.phase("a"):
            time.sleep(0.01)
    with timer.phase("b"):
        pass
    got = timer.seconds()
    assert set(got) == {"a", "b"}
    assert got["a"] >= 0.03 and got["b"] < got["a"]


def test_trace_counts_nested_events_once():
    a = torch.randn(256, 256)
    res = trace(lambda: [a @ a for _ in range(10)], "cpu")
    rows = {name: (sec, count) for name, sec, count in res["rows"]}
    assert rows["aten::mm"][1] == 10
    # aten::matmul encloses aten::mm: the union is below the rows' sum
    assert res["busy_s"] < sum(sec for _, sec, _ in res["rows"])
    assert 0.0 < res["busy_s"] <= res["wall_s"]
    assert res["busy_share"] == res["busy_s"] / res["wall_s"]
