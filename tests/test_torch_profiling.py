"""hnswindex_torch.utils.profiling on the CPU: the phase timer sums its
regions, takes a nested region's host time off its parent's, keeps a
bounded ring of spans on the profiler's clock, and the device's idle gaps
join those spans; the refine opens its profiler range only while a
profiler records; the accept scan counts its column steps; the upper
connect tallies its prunes and their layers; and every
per-layer metric reader of the build's regions reads a number from a tiny
build."""

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hnswindex_torch as T
from hnswindex_torch.core import heuristic
from hnswindex_torch.utils import profiling, refine
from hnswindex_torch.utils.profiling import PhaseTimer, Tally, idle_by_region

torch.set_num_threads(1)

METRICS = Path(__file__).resolve().parents[1] / "hnswbench" / "metrics"


def test_phase_timer_sums_regions_per_name():
    timer = PhaseTimer("cpu")
    for _ in range(3):
        with timer.phase("a"):
            time.sleep(0.01)
    with timer.phase("b"):
        pass
    got = timer.seconds()
    assert set(got) == {"a", "b", "a.host", "b.host"}
    assert got["a"] >= 0.03 and got["b"] < got["a"]


def test_nested_region_comes_off_the_parents_host_time():
    timer = PhaseTimer("cpu")
    with timer.phase("outer"):
        time.sleep(0.01)
        with timer.phase("inner"):
            time.sleep(0.03)
    got = timer.seconds()
    # the stream names count each region in full
    assert got["outer"] >= got["inner"] >= 0.03
    assert got["inner.host"] == pytest.approx(got["inner"], abs=1e-6)
    assert 0.01 <= got["outer.host"] < 0.03
    assert got["outer.host"] + got["inner.host"] == pytest.approx(
        got["outer"], abs=1e-6)
    (n1, s1, e1, p1), (n0, s0, e0, p0) = timer.spans()
    assert (n1, p1) == ("inner", "outer") and (n0, p0) == ("outer", None)
    assert s0 <= s1 <= e1 <= e0


def test_span_ring_keeps_the_last_regions():
    timer = PhaseTimer("cpu")
    for i in range(10_000):
        with timer.phase(f"r{i % 3}"):
            pass
    spans = timer.spans()
    assert len(spans) == profiling.SPANS == 4096
    assert [s[0] for s in spans] == [f"r{i % 3}"
                                     for i in range(10_000 - 4096, 10_000)]
    assert all(s[1] <= s[2] for s in spans)


def test_tally_sums_host_and_device_counts():
    t = Tally()
    t.add(3)
    t.add(torch.tensor(4, dtype=torch.int32))
    t.add(torch.count_nonzero(torch.tensor([0, 2, 5])))
    assert int(t) == 9
    timer = PhaseTimer("cpu")
    with timer.phase("a"):
        timer.count("a.items", 5)
        timer.count("a.items", torch.tensor(2))
    got = timer.seconds()
    assert set(got) == {"a", "a.host", "a.items"}
    assert got["a.items"] == 7 and isinstance(got["a.items"], int)


def test_region_shares_the_profilers_clock():
    timer = PhaseTimer("cpu")
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("mm"):
            a @ a
    (_, s, e, _), = timer.spans()
    mm = [ev for ev in prof.profiler.kineto_results.events()
          if ev.name() == "aten::mm"]
    assert mm
    for ev in mm:
        assert s <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= e


def test_idle_gaps_go_to_the_innermost_open_region():
    spans = [("child", 20, 40, "wave"), ("wave", 10, 60, None),
             ("wave", 100, 120, None)]
    busy = [(0, 5), (25, 30), (35, 50), (55, 110), (130, 140)]
    got = idle_by_region(busy, spans)
    # gaps 5-25 (mid 15: wave), 30-35 (child), 50-55 (wave), 110-130
    # (mid 120: wave's end)
    assert got == pytest.approx({"wave": 45e-9, "child": 5e-9})
    assert idle_by_region([(60, 65), (90, 95)], spans) == pytest.approx(
        {profiling.OUTSIDE: 25e-9})


def _refine_args():
    rng = np.random.default_rng(3)
    q = rng.random((4, 8)).astype(np.float32)
    ids = rng.integers(-1, 50, (4, 12))
    return q, ids, rng.random((4, 12, 8)).astype(np.float32)


@pytest.mark.parametrize("recording", [False, True],
                         ids=["off", "under_profiler"])
def test_refine_opens_its_range_only_while_recording(recording,
                                                     monkeypatch):
    q, ids, cv = _refine_args()
    want = refine._refine_pairs("sq_euclid", q, ids, cv, 5)
    opened = []
    real = refine._profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(refine._profiler, "record_function", spy)
    if recording:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = refine.refine_pairs("sq_euclid", q, ids, cv, 5)
        names = {ev.name() for ev in prof.profiler.kineto_results.events()}
        assert "hnsw/refine" in names
        assert opened == ["hnsw/refine"]
    else:
        got = refine.refine_pairs("sq_euclid", q, ids, cv, 5)
        assert opened == []
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _corpus(n=600, dim=16, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.random((n // 200, dim)).astype(np.float32)
    return (centers[rng.integers(0, n // 200, n)]
            + 0.03 * rng.standard_normal((n, dim)).astype(np.float32))


def test_accept_steps_count_every_prune_column(monkeypatch):
    widths = []
    real = heuristic.prune

    def spy(metric, cand_ids, *args, **kw):
        widths.append(cand_ids.shape[1])
        return real(metric, cand_ids, *args, **kw)

    monkeypatch.setattr(heuristic, "prune", spy)
    vecs = _corpus()
    idx = T.HNSWIndex(16, "sq_euclid", T.HNSWParameters(
        collection_size=600, max_wave_size=64), device="cpu")
    before = heuristic._accept_cols.steps
    idx.add(vecs)
    assert len(widths) > 10
    assert heuristic._accept_cols.steps - before == sum(widths)


@pytest.fixture(scope="module")
def tiny_ctx():
    """The ``ctx`` a traced benchmark run hands its readers, from a tiny
    build and its first query (which builds the pack)."""
    vecs = _corpus()
    idx = T.HNSWIndex(16, "sq_euclid", T.HNSWParameters(
        collection_size=600, max_wave_size=64, pack_queries="on",
        pack_min_count=0), device="cpu")
    t0 = time.perf_counter()
    idx.add(vecs)
    add_s = time.perf_counter() - t0
    idx.knn_query(vecs[:8], 5)
    return dict(setup=dict(rows=600, add_s=add_s, first_query_s=0.0),
                phases=idx.timer.seconds(), config={}, card="")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", [
    "build.wave_host_ms_per_krow", "build.upper_host_ms_per_krow",
    "build.scan_host_ms_per_krow", "build.prune_host_ms_per_krow",
    "build.reverse_host_ms_per_krow", "build.accept_steps_per_krow",
    "setup.pack_build_s"])
def test_metric_reader_reads_a_tiny_build(tiny_ctx, name):
    v = _reader(name)(tiny_ctx)
    assert isinstance(v, float) and v > 0, v
    # an index without the regions (the parent program) reads nothing
    if name != "build.accept_steps_per_krow":
        assert _reader(name)(dict(tiny_ctx, phases={})) is None


def test_accept_kernel_reader_counts_launches(tiny_ctx, monkeypatch):
    """The K3 launch count over the set-up's rows: 0.0 after a CPU build
    (the CPU path runs the plain twin), the counter's value per 1,000 rows
    otherwise, and nothing for a program without the kernel."""
    from hnswindex_torch import ops
    from hnswindex_torch.ops import accept_scan as TA
    read = _reader("build.accept_kernel_calls_per_krow")
    assert read(tiny_ctx) == pytest.approx(TA.accept_scan.calls / 0.6)
    monkeypatch.setattr(TA.accept_scan, "calls", 12)
    assert read(tiny_ctx) == pytest.approx(20.0)
    monkeypatch.delattr(ops, "accept_scan")
    monkeypatch.setitem(sys.modules, "hnswindex_torch.ops.accept_scan", None)
    assert read(tiny_ctx) is None


def test_upper_layers_reader_reads_layers_per_prune(tiny_ctx):
    """The upper connect's layers over its prunes: one prune a wave in a
    tiny build, covering its wave's layers, so at least 1; the tallies'
    own quotient otherwise, and nothing for a program without them."""
    read = _reader("build.upper_layers_per_prune")
    ph = tiny_ctx["phases"]
    assert ph["upper.prunes"] > 0
    assert read(tiny_ctx) == pytest.approx(ph["upper.layers"]
                                           / ph["upper.prunes"])
    assert read(tiny_ctx) >= 1.0
    fake = dict(tiny_ctx, phases={"upper.prunes": 50, "upper.layers": 99})
    assert read(fake) == pytest.approx(1.98)
    assert read(dict(tiny_ctx, phases={})) is None
    assert read(dict(tiny_ctx, phases={"upper.host": 1.0})) is None


def test_host_times_tile_the_add(tiny_ctx):
    ph = tiny_ctx["phases"]
    parts = sum(ph[f"{n}.host"]
                for n in ("wave", "upper", "scan", "prune", "reverse"))
    assert parts == pytest.approx(ph["wave"], rel=1e-6)
    assert parts <= tiny_ctx["setup"]["add_s"]


@pytest.fixture(scope="module")
def fallback_ctx():
    """The ``ctx`` of a tiny index served by its block fallback (the pack
    past a zero budget) in its first query."""
    vecs = _corpus()
    idx = T.HNSWIndex(16, "sq_euclid", T.HNSWParameters(
        collection_size=600, max_wave_size=64, pack_min_count=0,
        pack_max_bytes=0), device="cpu")
    t0 = time.perf_counter()
    idx.add(vecs)
    add_s = time.perf_counter() - t0
    idx.knn_query(vecs[:40], 5)
    assert idx._block_fb is not None
    return dict(setup=dict(rows=600, add_s=add_s, first_query_s=1.0),
                phases=idx.timer.seconds(),
                config=dict(dim=16, index=dict(max_wave_size=64)), card="")


@pytest.mark.parametrize("name,reads", [
    ("setup.build_ms_per_krow", True), ("build.upper_ms_per_krow", True),
    ("build.prune_ms_per_krow", True), ("build.reverse_ms_per_krow", True),
    ("build.scan_roofline", True), ("build.wave_host_ms_per_krow", True),
    ("build.upper_host_ms_per_krow", True),
    ("build.scan_host_ms_per_krow", True),
    ("build.prune_host_ms_per_krow", True),
    ("build.reverse_host_ms_per_krow", True),
    ("build.accept_steps_per_krow", True),
    ("build.accept_kernel_calls_per_krow", True),
    ("build.upper_layers_per_prune", True),
    ("setup.pack_build_s", False)])
def test_build_readers_read_an_index_served_by_its_fallback(
        fallback_ctx, name, reads):
    """The build's metrics read an index whose queries the block fallback
    serves, as they read a packed one; the pack's build reads nothing
    there, since no pack is built."""
    v = _reader(name)(fallback_ctx)
    assert (v is not None) == reads, v
