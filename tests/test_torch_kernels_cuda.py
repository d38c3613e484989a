"""The CUDA kernels and the main path on the card, against their plain
PyTorch versions.

Every test needs an NVIDIA card (and nvcc for the first build) and skips
without one.  The file imports no jax, so it also runs where jax is not
installed; there the suite's conftest (which configures jax) is left out:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Bars: block scores (K2) against its plain version at rtol=atol=1e-4 for
float32 and bfloat16 tiles alike (both widen the same stored values and sum
in float32; only the order of the sums differs), also at skewed probe
tables, tiles past the shared-memory budget and the gist1m-960 cell's
shape (2,000 bf16 tiles of 128 x 960, 1,024 queries x 10 probes), and
bit-identical panels from repeated calls; each launch counts itself, and
in a timer's tallies its B*P pairs and its distinct probed blocks; a
3,000-row BlockIndex on the card scores through K2 and is exact when every
block is probed.  Lane-min scan vals at rtol=atol=1e-4, ids equal on
>= 0.999 of live lanes, dead lanes -1, also at the D=960 build's deep
shape (2^18 rows, 512 queries, query chunks streamed); exact_knn2 on the
card against the same call on the CPU: ids equal on >= 0.99 of entries,
distances at rtol=atol=1e-5 where ids agree, and as the exact query calls
it at k=10 (the kernel) and k=300 (the panel branch), there at atol 1e-4
(small distances of large norms); a 2,000-row build on the card through the
kernel keeps the row invariants and self-recall > 0.85; a 3,000-row
beam-path build on the card matches the same build on the CPU at per-layer
edge overlap >= 0.98.
The sharded front ends on two shards of the one card: the exact query
launches the lane-min kernel on each shard, its scan gives the plain
version's ids on >= 0.999 of entries and its answers recall@10 >= 0.99; a
sharded build through the kernel (gate lowered to 0) overlaps the CPU
build's layer-0 edges at >= 0.99 on each shard; ShardedBlockIndex
launches K2 on each shard, each shard's panel selects the plain
_score_blocks top-10 up to float64 near-ties, and full probing is exact.
Under the profiler no device event bears a program range's name, and the
phase timer holds few CUDA events over 10,000 regions.
The accept scan (K3) equals its plain twin bit for bit, ties, NaN and
invalid columns included; a 20,000-row build and a removal repair on the
card give the same tables with K3 as with the twin, and each prune on the
card is one launch and no column step.  The one-pass upper connect builds
the per-layer loop's tables bit for bit on the card at 20,000 rows, with
one K3 launch a wave for its prune and one for its overflow re-prune.
The repair scan (K4) against its twin (``exact_knn`` in query chunks) at
the churn cell's shape (32,768 queries, 1M rows, D=100, k=100) and with
its level >= 1 mask (scanned as a gathered copy of those rows), at D=128,
960 and 37, at k=256 and 512, with fewer allowed rows than k and on a
bfloat16 table, for sq_euclid, cosine and ucosine: the same +inf /
-1 padding, sorted distances within 1e-5 relative plus 1e-6 of the norms'
scale (qn + cn for sq_euclid, 1 for the cosines: float32 sums in another
order), each differing id a float64 near-tie within twice that, at most
0.1% of ids differing, one launch counted a call, and repeat calls
bit-identical; its split plan at the old rule's cases; the removal's
scan below 2^20 rows is one launch for all of a layer's scan ids, tallied
on the timer, for a float32 and a bfloat16 table, and a removal asking
for more candidates than K4 keeps raises before it touches the index."""

import functools

import numpy as np
import pytest
import torch

import hnswindex_torch as T
from hnswindex_torch.core import construct as TC
from hnswindex_torch.core import heuristic as TH
from hnswindex_torch.ops import accept_scan as TA
from hnswindex_torch.ops import block_scores as TBS
from hnswindex_torch.ops import bruteforce as TB
from hnswindex_torch.ops import distance as tdst
from hnswindex_torch.ops import fused_scan as TF
from torch_cases import (accept_inputs, clustered, upper_connect_per_layer,
                         upper_overflows)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _scan_case(metric, C, D, B, dev, seed=7):
    rng = np.random.default_rng(seed)
    vecs = rng.random((C, D)).astype(np.float32)
    vecs[5] = 0.0                               # zero-norm guard row
    active = rng.random(C) < 0.9
    active[-(C // 10):] = False                 # an inactive tail
    excl = rng.integers(-1, C, B).astype(np.int32)
    x = torch.from_numpy(vecs).to(dev)
    mult, bias = TF.rank_transform(metric, tdst.norm_data(metric, x),
                                   torch.from_numpy(active).to(dev))
    q = torch.from_numpy(rng.random((B, D)).astype(np.float32)).to(dev)
    return (x.to(torch.bfloat16), mult, bias, q,
            torch.from_numpy(excl).to(dev))


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
@pytest.mark.parametrize("C,D,B", [
    (8192, 128, 100),
    (8192 * 3 + 77, 128, 512),      # ragged corpus, full build wave
    (700, 50, 7),                   # C < BS (dead lanes), D not a multiple of 32
    (3000, 128, 64),                # fewer groups than one split: no merge
    (20000, 128, 512),              # a short prefix: 4 splits of 5 groups
    (40000, 100, 300),              # D = 100 (plain-load tiles), ragged wave
    (30000, 72, 300),               # D = 72: a second chunk of 8 values by TMA
    (9000, 1024, 130),              # D > 384: query chunks stream too
    (1 << 18, 960, 512),            # the D=960 build's deep shape: streamed
])
def test_lane_min_scan_matches_ref_on_card(dev, metric, C, D, B):
    args = _scan_case(metric, C, D, B, dev)
    n0 = TF.lane_min_scan.launches
    kv, ki = TF.lane_min_scan(*args, BS=1024)
    torch.cuda.synchronize()
    assert TF.lane_min_scan.launches == n0 + 1
    rv, ri = TF.lane_min_scan_ref(*args, BS=1024)
    _assert_scan_close(kv, ki, rv, ri)


def _assert_scan_close(kv, ki, rv, ri):
    live = rv < TF.DEAD
    assert torch.equal(kv < TF.DEAD, live)
    torch.testing.assert_close(kv[live], rv[live], rtol=1e-4, atol=1e-4)
    assert (ki[live] == ri[live]).float().mean().item() >= 0.999
    assert (ki[~live] == -1).all()


@pytest.mark.parametrize("BS", [192, 1024])
def test_lane_min_scan_duplicate_rows_keep_lowest_column_on_card(dev, BS):
    """Five distinct rows repeated through the corpus: every lane ties
    exactly across its groups and across the splits of the corpus walk
    (4 splits at BS=1024, more at BS=192), and the ids must be exactly the
    lowest columns, as the plain version gives them."""
    C, D, B = 16 * 1024 + 300, 128, 100
    rng = np.random.default_rng(5)
    base = rng.random((5, D)).astype(np.float32)
    x = torch.from_numpy(base[np.arange(C) % 5]).to(dev)
    active = torch.from_numpy(rng.random(C) < 0.8).to(dev)
    mult, bias = TF.rank_transform("sq_euclid",
                                   tdst.norm_data("sq_euclid", x), active)
    q = torch.from_numpy(rng.random((B, D)).astype(np.float32)).to(dev)
    excl = torch.from_numpy(rng.integers(-1, C, B).astype(np.int32)).to(dev)
    assert TF._split_count(B, BS, C, torch.cuda.get_device_properties(
        dev).multi_processor_count) > 1
    args = (x.to(torch.bfloat16), mult, bias, q, excl)
    kv, ki = TF.lane_min_scan(*args, BS=BS)
    rv, ri = TF.lane_min_scan_ref(*args, BS=BS)
    _assert_scan_close(kv, ki, rv, ri)
    assert torch.equal(ki, ri)


@pytest.mark.parametrize("D", [128, 100])
def test_lane_min_scan_exclude_surfaces_runner_up_on_card(dev, D):
    """Each query excludes the column that wins one of its lanes: the
    runner-up of that lane must come out, in whichever split it lies."""
    C, B, BS = 24000, 300, 1024
    coarse, mult, bias, q, _ = _scan_case("sq_euclid", C, D, B, dev)
    none = torch.full((B,), -1, dtype=torch.int32, device=dev)
    _, wi = TF.lane_min_scan_ref(coarse, mult, bias, q, none, BS=BS)
    rows = torch.arange(B, device=dev)
    lanes = (rows * 37) % BS
    excl = wi[rows, lanes].contiguous()
    assert (excl >= 0).all()
    kv, ki = TF.lane_min_scan(coarse, mult, bias, q, excl, BS=BS)
    rv, ri = TF.lane_min_scan_ref(coarse, mult, bias, q, excl, BS=BS)
    _assert_scan_close(kv, ki, rv, ri)
    got = ki[rows, lanes]
    assert (got != excl).all() and (got >= 0).all()
    assert (got % BS == lanes).all()
    assert (got == ri[rows, lanes]).float().mean().item() >= 0.99


def test_lane_min_scan_checks_its_inputs_on_card(dev):
    coarse, mult, bias, q, excl = _scan_case("sq_euclid", 4096, 64, 16, dev)
    with pytest.raises(TypeError):
        TF.lane_min_scan(coarse.float(), mult, bias, q, excl)
    with pytest.raises(ValueError):
        TF.lane_min_scan(coarse, mult, bias, q, excl, BS=1000)
    with pytest.raises(ValueError):
        TF.lane_min_scan(coarse[:, ::2], mult, bias, q[:, ::2], excl)
    with pytest.raises(ValueError):
        TF.lane_min_scan(coarse, mult.cpu(), bias, q, excl)


def test_exact_knn2_on_card_matches_cpu(dev):
    rng = np.random.default_rng(3)
    C, D, B, K = 20000, 128, 64, 100
    vecs = torch.from_numpy(rng.random((C, D)).astype(np.float32))
    active = torch.from_numpy(rng.random(C) < 0.95)
    q = vecs[:B] + 0.01
    out = {}
    for where in ("cpu", dev):
        v = vecs.to(where)
        out[str(where)] = [t.cpu() for t in TB.exact_knn2(
            "sq_euclid", v, v.to(torch.bfloat16),
            tdst.norm_data("sq_euclid", v), active.to(where), q.to(where),
            K, exclude=torch.arange(B).to(where))]
    (cd, ci), (gd, gi) = out["cpu"], out[str(dev)]
    same = ci == gi
    assert same.float().mean().item() >= 0.99
    torch.testing.assert_close(gd[same], cd[same], rtol=1e-5, atol=1e-5)
    assert not (gi == torch.arange(B)[:, None]).any()


@pytest.mark.parametrize("K", [10, 300])
def test_exact_query_scan_on_card_matches_cpu(dev, K):
    """exact_knn2 as the exact query calls it (no exclude, the whole
    capacity, 4,096 lanes): k=10 runs the lane-min kernel on the card (one
    launch), k=300 (survivor width 1,200) the panel branch (no launch).
    Ids equal on >= 0.99 of entries; where they agree the distances match
    at rtol 1e-5 and atol 1e-4: the rescore is dot-decomposed at norms ~43
    (||q||^2 + ||x||^2 ~ 86), where card and CPU sum in other orders
    (measured up to 5.3e-5, on the queries' own rows at distance ~0.01)."""
    rng = np.random.default_rng(4)
    C, D, B = 16384, 128, 100
    vecs = torch.from_numpy(rng.random((C, D)).astype(np.float32))
    active = torch.from_numpy(rng.random(C) < 0.95)
    q = vecs[:B] + 0.01
    out = {}
    for where in ("cpu", dev):
        v = vecs.to(where)
        n0 = TF.lane_min_scan.launches
        out[str(where)] = [t.cpu() for t in TB.exact_knn2(
            "sq_euclid", v, v.to(torch.bfloat16),
            tdst.norm_data("sq_euclid", v), active.to(where), q.to(where),
            K, lanes=4096)]
        if where == dev:
            assert TF.lane_min_scan.launches - n0 == (1 if K == 10 else 0)
    (cd, ci), (gd, gi) = out["cpu"], out[str(dev)]
    same = ci == gi
    assert same.float().mean().item() >= 0.99
    torch.testing.assert_close(gd[same], cd[same], rtol=1e-5, atol=1e-4)
    assert (gi >= 0).all() and active[gi].all()


def _edge_overlap(a, b):
    """Per-layer |A & B| / |A | B| of two indexes' directed edge sets."""
    from hnswindex_torch.core.graph import dense_tables
    (na, da), (nb, db) = dense_tables(a._state), dense_tables(b._state)
    out = []
    for layer in range(na.shape[0]):
        ea = {(u, int(v)) for u in range(na.shape[1])
              for v in na[layer, u, :da[layer, u]]}
        eb = {(u, int(v)) for u in range(nb.shape[1])
              for v in nb[layer, u, :db[layer, u]]}
        if ea or eb:
            out.append(len(ea & eb) / len(ea | eb))
    return out


def test_beam_build_on_card_matches_cpu(dev):
    """A 3,000 x 32 build whose waves past 100 rows take the beam path, on
    the card and on the CPU: per-layer edge overlap >= 0.98 (the CPU
    build's bar against the reference, test_torch_construct)."""
    n, dim = 3000, 32
    rng = np.random.default_rng(93)
    centers = rng.random((8, dim)).astype(np.float32)
    vecs = (centers[rng.integers(0, 8, n)]
            + 0.05 * rng.standard_normal((n, dim)).astype(np.float32))
    built = {}
    for where in ("cpu", dev):
        ix = T.HNSWIndex(dim, "sq_euclid", T.HNSWParameters(
            collection_size=n, exact_build_threshold=100), device=where)
        ix.add(vecs)
        assert ix.wave_counts["beam"] > 0
        built[str(where)] = ix
    overlap = _edge_overlap(built["cpu"], built[str(dev)])
    assert len(overlap) >= 2 and min(overlap) >= 0.98, overlap
    ids, _ = built[str(dev)].knn_query(vecs[:500], 1)
    assert (ids[:, 0] == np.arange(500)).mean() > 0.85


def test_build_on_card_runs_the_kernel(dev, monkeypatch):
    n, dim = 2000, 128
    rng = np.random.default_rng(65537)
    centers = rng.random((n // 500, dim)).astype(np.float32)
    vecs = (centers[rng.integers(0, n // 500, n)]
            + 0.03 * rng.standard_normal((n, dim)).astype(np.float32))
    monkeypatch.setattr(TC, "BUILD_SCAN2_MIN", 0)
    idx = T.HNSWIndex(dim, "sq_euclid", T.HNSWParameters(
        collection_size=n, pack_queries="on"), device=dev)
    n0 = TF.lane_min_scan.launches
    idx.add(vecs)
    assert TF.lane_min_scan.launches > n0
    assert idx.count == n
    deg0 = idx._state.deg0.cpu().numpy()
    nbr0 = idx._state.nbr0.cpu().numpy()
    assert (deg0 <= nbr0.shape[1]).all()
    for u in range(n):
        row = nbr0[u, :deg0[u]]
        assert (row >= 0).all() and u not in row
        assert len(set(row.tolist())) == row.size
    ids, _ = idx.knn_query(vecs, 1)
    assert (ids[:, 0] == np.arange(n)).mean() > 0.85


@functools.lru_cache(maxsize=1)
def _accept_host(B, N):
    # kept for the next case: the cases of one (B, N) run in a row
    return accept_inputs(29, B, N)


def _accept_case(B, N, dev):
    """``torch_cases.accept_inputs`` on the card."""
    return tuple(torch.from_numpy(a).to(dev) for a in _accept_host(B, N))


@pytest.mark.parametrize("max_edges", [16, 32])
@pytest.mark.parametrize("N", [1, 40, 100, 124, 136, 424])
@pytest.mark.parametrize("B", [1, 512, 8192])
def test_accept_scan_matches_twin_on_card(dev, B, N, max_edges):
    pd, sd, valid = _accept_case(B, N, dev)
    n0 = TA.accept_scan.calls
    got = TA.accept_scan(pd, sd, valid, max_edges)
    torch.cuda.synchronize()
    assert TA.accept_scan.calls == n0 + 1
    want = TH._accept_capped(pd, sd, valid, max_edges)
    assert torch.equal(got, want)
    assert (got.sum(dim=1) <= max_edges).all()
    if B >= 3:
        assert not got[0].any()
        if N > 3:
            assert torch.equal(got[1], valid[1])
        assert int(got[2].sum()) == min(max_edges, int(valid[2].sum()))


def test_accept_scan_checks_its_inputs_on_card(dev):
    pd, sd, valid = _accept_case(4, 10, dev)
    with pytest.raises(TypeError):
        TA.accept_scan(pd.double(), sd, valid, 4)
    with pytest.raises(TypeError):
        TA.accept_scan(pd, sd, valid.int(), 4)
    with pytest.raises(ValueError):
        TA.accept_scan(pd[:, :, :9], sd, valid, 4)
    with pytest.raises(ValueError):
        TA.accept_scan(pd.transpose(1, 2), sd, valid, 4)
    assert torch.equal(TA.accept_scan(pd, sd, valid, 0),
                       torch.zeros_like(valid))


def _twin(pd, sd, svalid, max_edges):
    return TH._accept_capped(pd, sd, svalid, max_edges)


def _tables(ix):
    st = ix._state
    return [t.clone() for t in (st.nbr0, st.deg0, st.nbru, st.degu, st.ep)]


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
def test_build_with_accept_kernel_equals_twin_on_card(dev, metric,
                                                      monkeypatch):
    """A seeded 20,000-row build on the card through K3, and the same build
    with the plain twin as the accept: identical tables and entry point."""
    n, dim = 20000, 64
    vecs = clustered(n, dim, n // 500, np.random.default_rng(31), 0.03)
    built = []
    for accept in ("kernel", "twin"):
        if accept == "twin":
            monkeypatch.setattr(TH, "accept_scan", _twin)
        idx = T.HNSWIndex(dim, metric, T.HNSWParameters(
            collection_size=n), device=dev)
        calls = TA.accept_scan.calls
        idx.add(vecs)
        assert (TA.accept_scan.calls > calls) == (accept == "kernel")
        built.append(_tables(idx))
    for name, a, b in zip(("nbr0", "deg0", "nbru", "degu", "ep"), *built):
        assert torch.equal(a, b), name


def test_removal_repair_with_accept_kernel_equals_twin_on_card(dev,
                                                               monkeypatch):
    """One 20,000-row graph, copied twice on the card, through the same
    removal of 2,000 ids (the repair prunes with ``fill_to`` at its widths):
    K3 and the twin leave identical tables."""
    n, dim = 20000, 64
    vecs = clustered(n, dim, n // 500, np.random.default_rng(37), 0.03)
    base = T.HNSWIndex(dim, "sq_euclid", T.HNSWParameters(
        collection_size=n), device=dev)
    base.add(vecs)
    rem = np.random.default_rng(37).choice(n, 2000, replace=False)
    out = []
    for accept in ("kernel", "twin"):
        if accept == "twin":
            monkeypatch.setattr(TH, "accept_scan", _twin)
        ix = _moved_to(base, dev)
        calls = TA.accept_scan.calls
        ix.remove(rem)
        assert (TA.accept_scan.calls > calls) == (accept == "kernel")
        out.append(_tables(ix))
    for name, a, b in zip(("nbr0", "deg0", "nbru", "degu", "ep"), *out):
        assert torch.equal(a, b), name


def test_prune_on_card_is_one_launch_and_no_step(dev, monkeypatch):
    """Every prune of a build on the card launches K3 once and takes no
    column step of the host loop."""
    prunes = []
    real = TH.prune

    def spy(*args, **kw):
        prunes.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(TH, "prune", spy)
    n, dim = 3000, 32
    idx = T.HNSWIndex(dim, "sq_euclid", T.HNSWParameters(
        collection_size=n, max_wave_size=128), device=dev)
    calls, steps = TA.accept_scan.calls, TH._accept_cols.steps
    idx.add(clustered(n, dim, n // 500, np.random.default_rng(41), 0.03))
    assert len(prunes) > 20
    assert TA.accept_scan.calls - calls == len(prunes)
    assert TH._accept_cols.steps == steps


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
def test_stacked_upper_connect_on_card_builds_the_per_layer_graph(
        dev, metric, monkeypatch):
    """A seeded 20,000-row build on the card with the one-pass upper
    connect, and the same build with the per-layer loop
    (``torch_cases.upper_connect_per_layer``): identical tables.  In the
    one-pass build each wave's upper connect launches K3 once for its
    prune and once more where upper rows overflow, whatever its layer
    count, and tallies one prune covering its layers."""
    n, dim = 20000, 64
    vecs = clustered(n, dim, n // 500, np.random.default_rng(43), 0.03)
    M = T.HNSWParameters().max_edges
    real = TC.upper_connect_exact
    waves = []

    def spy(cfg, state, ids, lvls, panel_ids, max_lvl=0, timer=None):
        over.clear()
        before = (TA.accept_scan.calls, timer.seconds())
        real(cfg, state, ids, lvls, panel_ids, max_lvl, timer)
        after = (TA.accept_scan.calls, timer.seconds())
        waves.append(dict(
            layers=min(state.num_levels - 1, max_lvl),
            calls=after[0] - before[0], overflowed=sum(over) > 0,
            prunes=after[1]["upper.prunes"]
            - before[1].get("upper.prunes", 0),
            tallied=after[1]["upper.layers"]
            - before[1].get("upper.layers", 0)))

    built = []
    for how in ("stacked", "per_layer"):
        with monkeypatch.context() as mp:
            over = upper_overflows(mp, M)
            mp.setattr(TC, "upper_connect_exact",
                       spy if how == "stacked" else upper_connect_per_layer)
            idx = T.HNSWIndex(dim, metric, T.HNSWParameters(
                collection_size=n), device=dev)
            idx.add(vecs)
        built.append(_tables(idx))
    assert len(waves) > 20
    assert max(w["layers"] for w in waves) >= 2
    assert any(w["overflowed"] for w in waves)
    for w in waves:
        assert w["calls"] == 1 + w["overflowed"] <= 2, w
        assert w["prunes"] == 1 and w["tallied"] == w["layers"], w
    for name, a, b in zip(("nbr0", "deg0", "nbru", "degu", "ep"), *built):
        assert torch.equal(a, b), name


def _traced(fn, dev):
    """(summary, device events, host events) of ``fn()`` run in the
    benchmark's traced window."""
    from hnswbench import trace as tracing
    w = tracing.Window(dev)
    w.start()
    fn()
    w.stop()
    dev_ev, host_ev = tracing._events(w._prof, True)
    return tracing.summarize(dev_ev, host_ev, w.window_s), dev_ev, host_ev


def test_trace_sees_the_kernel_on_card(dev):
    args = _scan_case("sq_euclid", 8192 * 4, 128, 512, dev)
    TF.lane_min_scan(*args)                         # build and warm up
    res, dev_ev, _ = _traced(lambda: TF.lane_min_scan(*args), dev)
    names = [e[2] for e in dev_ev]
    assert any("lane_min_scan" in n for n in names), names
    assert 0.0 < res["busy_s"] <= res["window_s"]


def test_profiler_sees_no_program_range_on_card(dev):
    """A mirrored ``knn_query`` (the float64 host refine) under the
    profiler: the refine's range is a host event, and no device event
    carries the name of a program range or region."""
    n, dim = 2000, 32
    rng = np.random.default_rng(8)
    vecs = rng.random((n, dim)).astype(np.float32)
    idx = T.HNSWIndex(dim, "sq_euclid", T.HNSWParameters(
        collection_size=n, pack_queries="on", pack_min_count=0), device=dev)
    idx.add(vecs)
    idx.knn_query(vecs[:64], 10)                    # pack and host mirror
    assert idx._mirror.mirrorable()
    _, dev_ev, host_ev = _traced(lambda: idx.knn_query(vecs[:256], 10), dev)
    assert dev_ev
    assert "hnsw/refine" in {e[2] for e in host_ev}
    regions = {name for name, *_ in idx.timer.spans()}
    bad = {e[2] for e in dev_ev
           if e[2].startswith("hnsw/") or e[2] in regions}
    assert not bad, bad


def test_phase_timer_holds_few_events_on_card(dev):
    """Event pairs fold into their totals as regions close: 10,000 regions
    leave few CUDA events held, and the totals agree with the host's."""
    from hnswindex_torch.utils.profiling import SPANS, PhaseTimer
    timer = PhaseTimer(dev)
    x = torch.zeros(1024, device=dev)
    held = 0
    for i in range(10_000):
        with timer.phase("outer"):
            with timer.phase("inner"):
                x.add_(1.0)
        held = max(held, timer.held_events())
    assert held <= 512, held
    got = timer.seconds()
    assert timer.held_events() <= 512
    assert float(x[0]) == 10_000.0
    assert 0.0 < got["inner"] <= got["outer"]
    assert 0.0 < got["inner.host"] and 0.0 < got["outer.host"]
    assert len(timer.spans()) == SPANS


def _blocks_case(metric, NB, BS, D, B, P, dtype, dev, seed=11):
    rng = np.random.default_rng(seed)
    blk = rng.random((NB, BS, D)).astype(np.float32)
    q = rng.random((B, D)).astype(np.float32)
    if metric == "ucosine":
        blk /= np.linalg.norm(blk, axis=-1, keepdims=True)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    blk[:, BS - BS // 4:] = 0.0                 # partly filled blocks
    if B > 1:
        q[1] = 0.0                              # a zero query
    bids = rng.integers(0, NB, (B, P)).astype(np.int32)
    bids[rng.random((B, P)) < 0.1] = -1         # routing pads
    return (torch.from_numpy(blk).to(dev).to(dtype),
            torch.from_numpy(bids).to(dev), torch.from_numpy(q).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("metric", ["sq_euclid", "cosine", "ucosine"])
@pytest.mark.parametrize("NB,BS,D,B,P", [
    (64, 128, 128, 100, 8),         # the serving geometry, 16-byte loads
    (33, 192, 50, 13, 5),           # D the vector width does not divide
    (200, 64, 36, 257, 7),          # vector loads for f32, scalar for bf16
])
def test_block_scores_matches_ref_on_card(dev, metric, dtype, NB, BS, D, B,
                                          P):
    blk, bids, q = _blocks_case(metric, NB, BS, D, B, P, dtype, dev)
    n0 = TBS.block_scores.launches
    got = TBS.block_scores(metric, blk, bids, q)
    torch.cuda.synchronize()
    assert TBS.block_scores.launches == n0 + 1
    want = TBS.block_scores_ref(metric, blk, bids, q)
    assert got.shape == (B, P * BS) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if metric == "cosine":
        assert (got[1] == 1.0).all()            # zero query: exactly 1
        assert (got.reshape(B, P, BS)[:, :, -1] == 1.0).all()   # zero rows


def test_block_scores_checks_its_inputs_on_card(dev):
    blk, bids, q = _blocks_case("sq_euclid", 8, 64, 32, 4, 2, torch.float32,
                                dev)
    with pytest.raises(ValueError):
        TBS.block_scores("sq_euclid", blk, bids.cpu(), q)
    with pytest.raises(ValueError):
        TBS.block_scores("sq_euclid", blk[:, :, ::2], bids, q[:, ::2])
    with pytest.raises(TypeError):
        TBS.block_scores("sq_euclid", blk, bids.long(), q)
    # a row wider than any shared-memory budget: streamed a row at a time
    wide, wbids, wq = _blocks_case("sq_euclid", 2, 64, 12288, 4, 1,
                                   torch.float32, dev)
    torch.testing.assert_close(
        TBS.block_scores("sq_euclid", wide, wbids, wq),
        TBS.block_scores_ref("sq_euclid", wide, wbids, wq),
        rtol=1e-4, atol=1e-4)


def _skewed_bids(table, NB, B, P, rng):
    if table == "one_block":            # a single segment of B*P pairs
        return np.full((B, P), NB // 2, np.int32)
    if table == "all_pads":             # every probe a routing pad
        return np.full((B, P), -1, np.int32)
    bids = rng.integers(0, NB, (B, P)).astype(np.int32)
    if table == "repeat_in_query":      # a query probes one block twice
        bids[:, 1] = bids[:, 0]
        bids[3, :] = bids[3, 0]
    return bids


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
@pytest.mark.parametrize("name,NB,BS,D,B,P,dtype,table", [
    ("one_block", 40, 128, 128, 300, 11, torch.float32, "one_block"),
    ("all_pads", 40, 128, 128, 100, 9, torch.float32, "all_pads"),
    ("repeat_in_query", 50, 128, 128, 70, 6, torch.bfloat16,
     "repeat_in_query"),
    ("sparse_probes", 5_000, 128, 128, 20, 4, torch.float32, "random"),
    ("bs192_96KB", 300, 192, 128, 200, 8, torch.float32, "random"),
    ("d1024_chunked", 120, 128, 1024, 60, 7, torch.float32, "random"),
    ("d100_bf16_plain_loads", 150, 128, 100, 90, 6, torch.bfloat16,
     "random"),
    ("one_pair", 30, 128, 128, 1, 1, torch.float32, "random"),
    ("gist_cell_bf16", 2000, 128, 960, 1024, 10, torch.bfloat16, "random"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_block_scores_grouping_edges_on_card(dev, metric, name, NB, BS, D, B,
                                             P, dtype, table):
    """Probe tables and shapes that stress the kernel's grouping of pairs
    by block (segments split into many work items, all pads on block 0, a
    block twice in one query, most blocks unprobed, one pair) and its
    staging (a 96 KB tile, a tile streamed in row chunks, rows that are
    not a multiple of 16 bytes)."""
    blk, _, q = _blocks_case(metric, NB, BS, D, B, P, dtype, dev)
    bids = torch.from_numpy(_skewed_bids(
        table, NB, B, P, np.random.default_rng(3))).to(dev)
    got = TBS.block_scores(metric, blk, bids, q)
    torch.cuda.synchronize()
    want = TBS.block_scores_ref(metric, blk, bids, q)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("table", ["random", "one_block", "all_pads",
                                   "repeat_in_query"])
def test_block_scores_counts_pairs_and_tiles_on_card(dev, table):
    """Each launch counts itself in ``block_scores.launches``, and with a
    timer adds B*P to its tally ``block_scores.pairs`` and its distinct
    probed blocks (a pad counts as block 0, which it scores) to
    ``block_scores.tiles``; a launch without a timer adds to no tally."""
    from hnswindex_torch.utils.profiling import PhaseTimer
    NB, B, P = 300, 200, 9
    blk, _, q = _blocks_case("sq_euclid", NB, 128, 64, B, P, torch.bfloat16,
                             dev)
    bids = torch.from_numpy(_skewed_bids(table, NB, B, P,
                                         np.random.default_rng(5))).to(dev)
    distinct = torch.unique(bids.clamp(0, NB - 1)).numel()
    timer = PhaseTimer(dev)
    n0 = TBS.block_scores.launches
    for _ in range(2):
        TBS.block_scores("sq_euclid", blk, bids, q, timer=timer)
    TBS.block_scores("sq_euclid", blk, bids, q)
    assert TBS.block_scores.launches - n0 == 3
    got = timer.seconds()
    assert got["block_scores.pairs"] == 2 * B * P
    assert got["block_scores.tiles"] == 2 * distinct


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_block_scores_repeat_calls_bit_identical_on_card(dev, dtype):
    """The order of pairs inside a block's segment comes from atomics and
    changes between calls; the panel must not."""
    blk, bids, q = _blocks_case("cosine", 30, 128, 128, 500, 16, dtype, dev)
    bids[:, :4] = 7                             # one hot block, many items
    first = TBS.block_scores("cosine", blk, bids, q)
    for _ in range(3):
        assert torch.equal(TBS.block_scores("cosine", blk, bids, q), first)


def test_block_index_on_card_runs_the_kernel(dev):
    rng = np.random.default_rng(65537)
    n, dim = 3000, 32
    centers = rng.random((40, dim)).astype(np.float32)
    vecs = (centers[rng.integers(0, 40, n)]
            + 0.05 * rng.standard_normal((n, dim)).astype(np.float32))
    ix = T.BlockIndex(dim, block_size=64, device=dev)
    ix.build(vecs)
    n0 = TBS.block_scores.launches
    q = vecs[:200]
    ids, dists = ix.knn_query(q, 10, n_probe=ix.n_blocks)
    assert TBS.block_scores.launches > n0
    d = ((q[:, None, :].astype(np.float64)
          - vecs[None].astype(np.float64)) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])
    assert rec > 0.999, rec
    assert (np.diff(dists, axis=1) >= 0).all()
    new = ix.add(vecs[:50] + 5.0)
    ix.remove(np.arange(100))
    got, _ = ix.knn_query(vecs[:50] + 5.0, 1, n_probe=8)
    assert (got[:, 0] == new).mean() > 0.9
    back, _ = ix.knn_query(vecs[:100], 10, n_probe=8)
    assert not np.isin(back, np.arange(100)).any()


def _moved_to(ix, where):
    """A copy of the CPU index ``ix`` on ``where``: the same graph and host
    state (free list, scan mark, level RNG, panel)."""
    import copy
    import dataclasses
    out = T.HNSWIndex(ix.dim, ix.metric, dataclasses.replace(ix.params),
                      device=where)
    for f in dataclasses.fields(ix._state):
        setattr(out._state, f.name,
                getattr(ix._state, f.name).to(where, copy=True))
    out._count_host, out._length = ix._count_host, ix._length
    out._free, out._scan_hwm = list(ix._free), ix._scan_hwm
    out._rng = copy.deepcopy(ix._rng)
    out._upper_np = ix._upper_np.copy()
    out._upper_pos = dict(ix._upper_pos)
    out._upper_cnt, out._upper_holes = ix._upper_cnt, ix._upper_holes
    out._panel_push()
    return out


def test_remove_add_update_on_card_match_cpu(dev):
    """A 3,000 x 32 graph on the CPU and the same graph on the card, through
    the same remove (300 ids, the entry point among them: "high"), add
    (they reuse the freed slots) and update (100 rows: "fast"): identical
    active, entry point, free list and levels after each step, per-layer
    edge overlap >= 0.99."""
    n, dim = 3000, 32
    rng = np.random.default_rng(17)
    centers = rng.random((8, dim)).astype(np.float32)
    vecs = (centers[rng.integers(0, 8, n)]
            + 0.05 * rng.standard_normal((n, dim)).astype(np.float32))
    cpu = T.HNSWIndex(dim, "sq_euclid", T.HNSWParameters(collection_size=n),
                      device="cpu")
    cpu.add(vecs)
    card = _moved_to(cpu, dev)
    rem = rng.choice(n, 300, replace=False)
    rem[0] = int(cpu._state.ep)
    upd = rng.choice(np.setdiff1d(np.arange(n), rem), 100, replace=False)
    steps = [lambda ix: ix.remove(rem),
             lambda ix: ix.add(vecs[:100] + 0.01),
             lambda ix: ix.update(upd, vecs[upd] + 0.02)]
    for step in steps:
        outs = [step(ix) for ix in (cpu, card)]
        if outs[0] is not None:
            np.testing.assert_array_equal(outs[0], outs[1])
        for name in ("active", "level", "ep", "count"):
            assert torch.equal(getattr(cpu._state, name),
                               getattr(card._state, name).cpu()), name
        assert cpu._free == card._free
        overlap = _edge_overlap(cpu, card)
        assert min(overlap) >= 0.99, overlap
    ids, _ = card.knn_query(vecs[upd] + 0.02, 1)
    assert (ids[:, 0] == upd).mean() > 0.9


def test_filtered_exact_on_card_matches_cpu(dev):
    """A 50% id mask on exact=True: the card runs the lane-min kernel, and
    its ids equal the CPU's on >= 0.99 of entries; every id is allowed."""
    n, dim = 20000, 128
    rng = np.random.default_rng(19)
    vecs = rng.random((n, dim)).astype(np.float32)
    mask = rng.random(n) < 0.5
    got = {}
    for where in ("cpu", dev):
        ix = T.HNSWIndex(dim, "sq_euclid", T.HNSWParameters(
            collection_size=n), device=where)
        ix._alloc_slots(n)
        ids = torch.arange(n, device=ix.device)
        from hnswindex_torch.core.graph import write_rows
        write_rows(ix._state, ix._cfg, ids, torch.from_numpy(vecs).to(where),
                   torch.zeros(n, dtype=torch.int32, device=ix.device))
        ix._count_host = n
        fm = np.zeros(ix._state.capacity, bool)
        fm[:n] = mask
        n0 = TF.lane_min_scan.launches
        got[str(where)] = ix.knn_query(vecs[:300] + 0.01, 10, filter_fnc=fm,
                                       exact=True)
        launched = TF.lane_min_scan.launches > n0
        assert launched == (where != "cpu")
    (ci, cd), (gi, gd) = got["cpu"], got[str(dev)]
    assert mask[gi].all()
    same = ci == gi
    assert same.mean() >= 0.99
    np.testing.assert_allclose(gd[same], cd[same], rtol=1e-5, atol=1e-4)


def test_exact_repair_candidates_through_the_kernel_on_card(dev,
                                                            monkeypatch):
    """At 2^20 x 128 rows the removal's candidate scan is exact_knn2 with
    oversample=2, survivor_floor=64 (S = 200 at the default 100 candidates),
    through the lane-min kernel; its ids equal the plain version's on
    >= 0.999 of entries."""
    from hnswindex_torch.core import graph as G
    from hnswindex_torch.core import remove as TR
    C, D = 1 << 20, 128
    g = torch.Generator(device=dev).manual_seed(23)
    cfg = G.GraphConfig(dim=D)
    st = G.empty_state(cfg, C, dev)
    G.write_rows(st, cfg, torch.arange(C, device=dev),
                 torch.rand((C, D), generator=g, device=dev),
                 torch.zeros(C, dtype=torch.int32, device=dev))
    scan = torch.randperm(C, generator=g, device=dev)[:512]
    st.active[scan] = False
    n0 = TF.lane_min_scan.launches
    got = TR.exact_repair_candidates(cfg, st, scan, 0, 100)
    torch.cuda.synchronize()
    assert TF.lane_min_scan.launches > n0
    monkeypatch.setattr(TF, "lane_min_scan", TF.lane_min_scan_ref)
    want = TR.exact_repair_candidates(cfg, st, scan, 0, 100)
    assert got.shape == want.shape == (512, 100)
    assert (got == want).float().mean().item() >= 0.999
    assert not torch.isin(got, scan).any()


def _repair_case(metric, S, ns, D, dev, seed, upper=False, n_allowed=None):
    """Rows (unit rows for ucosine; row 5 zero), their norms, the allowed
    mask of a repair scan (about 95% active; with ``upper`` also the ~6%
    of level >= 1; or exactly ``n_allowed`` rows) and S queries: rows
    taken out of the mask, as a wave is, moved slightly."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((ns, D), generator=g, device=dev)
    if metric == "ucosine":
        x = x / x.norm(dim=1, keepdim=True)
    x[5] = 0.0
    allowed = torch.rand((ns,), generator=g, device=dev) < 0.95
    if upper:
        allowed &= torch.rand((ns,), generator=g, device=dev) < 0.06
    if n_allowed is not None:
        allowed[:] = False
        allowed[torch.randperm(ns, generator=g, device=dev)[:n_allowed]] = True
    rows = torch.randint(0, ns, (S,), generator=g, device=dev)
    allowed[rows] = False
    q = x[rows] + 0.01 * torch.rand((S, D), generator=g, device=dev)
    return x, tdst.norm_data(metric, x), allowed, q.contiguous()


def _dist64(metric, q, v, qn=None, vn=None):
    """Float64 distances of rows ``q (B, D)`` to ``v (B, D)``, with the
    norm data ``qn``, ``vn`` where given (the float32 rows' norms, which
    a bfloat16 table's distances keep)."""
    q, v = q.double(), v.double()
    qn = tdst.norm_data(metric, q) if qn is None else qn.double()
    vn = tdst.norm_data(metric, v) if vn is None else vn.double()
    return tdst.from_dot(metric, (q * v).sum(-1), qn, vn)


def _assert_repair_close(metric, x, norms, q, kd, ki, td, ti,
                         cap="positions"):
    """K4's (kd, ki) against the twin's (td, ti): the same padding; sorted
    distances within 1e-5 relative plus 1e-6 of the norms' scale (qn + cn
    for sq_euclid, 1 for the cosines: the rounding of float32 sums taken
    in another order); every differing id a near-tie, its float64 distance
    within twice that of the twin's id's; at most 0.1% of ids differ
    (``cap="positions"``), or, with ``cap="set"``, at most 0.1% of K4's
    ids are missing from the twin's list: past k = 256 the cosine's
    float32 rounding (1.6e-7 here, the twin divides by the norms, K4
    multiplies by their reciprocals) reorders near-ties inside the list
    on about 0.12% of its positions at k = 512, while the lists hold the
    same rows.  A bfloat16 table ``x`` is held to the products of the
    rounded queries and the float32 norms."""
    fin = torch.isfinite(td)
    assert torch.equal(torch.isfinite(kd), fin)
    assert bool((ki[~fin] == -1).all()) and bool((ti[~fin] == -1).all())
    assert bool((kd[:, 1:] >= kd[:, :-1])[fin[:, 1:]].all())
    if metric == "sq_euclid":
        scale = tdst.norm_data(metric, q)[:, None] + norms[ti.clamp(min=0)]
    else:
        scale = torch.ones_like(td)
    tol = 1e-5 * td.abs() + 1e-6 * scale
    assert bool(((kd - td).abs() <= tol)[fin].all())
    diff = (ki != ti) & fin
    r, c = diff.nonzero(as_tuple=True)
    if r.numel() and x.dtype == torch.bfloat16:
        qr, qn = q[r].to(x.dtype), tdst.norm_data(metric, q[r])
        dk = _dist64(metric, qr, x[ki[r, c]], qn, norms[ki[r, c]])
        dt = _dist64(metric, qr, x[ti[r, c]], qn, norms[ti[r, c]])
        assert bool(((dk - dt).abs() <= 2 * tol[r, c]).all())
    elif r.numel():
        dk = _dist64(metric, q[r], x[ki[r, c]])
        dt = _dist64(metric, q[r], x[ti[r, c]])
        assert bool(((dk - dt).abs() <= 2 * tol[r, c]).all())
    if cap == "set":
        missing = ~(ki[:, :, None] == ti[:, None, :]).any(-1)
        assert missing.float().mean().item() <= 1e-3
    else:
        assert diff.float().mean().item() <= 1e-3


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine", "ucosine"])
@pytest.mark.parametrize("S,ns,D,k,case", [
    (32768, 1_000_000, 100, 100, "all"),    # the churn cell's full wave
    (2048, 1_000_000, 100, 100, "upper"),   # its level >= 1 members: splits
    (4096, 300_007, 128, 100, "all"),
    (1024, 100_003, 960, 100, "all"),
    (333, 5_003, 37, 256, "all"),           # element loads, k past 128
    (300, 20_000, 100, 100, "few"),         # 60 allowed rows: -1 tails
    (4096, 300_007, 100, 100, "bf16"),      # a bf16 table, 8-byte loads
    (1000, 200_003, 37, 100, "bf16"),       # bf16 element loads
    (700, 20_003, 100, 512, "all"),         # the widest top-k
    (257, 100_003, 64, 400, "upper"),       # gathered rows, k past 256
])
def test_repair_scan_matches_twin_on_card(dev, metric, S, ns, D, k, case):
    from hnswindex_torch.ops import repair_scan as RS
    x, norms, allowed, q = _repair_case(
        metric, S, ns, D, dev, seed=S + D, upper=case == "upper",
        n_allowed=60 if case == "few" else None)
    if case == "bf16":
        x = x.to(torch.bfloat16)
    n0 = RS.repair_scan.calls
    kd, ki = RS.repair_scan(metric, x, norms, allowed, q, k)
    torch.cuda.synchronize()
    assert RS.repair_scan.calls == n0 + 1
    assert kd.shape == ki.shape == (S, k) and ki.dtype == torch.int64
    assert bool(allowed[ki[ki >= 0]].all())
    td, ti = RS.repair_scan_ref(metric, x, norms, allowed, q, k)
    _assert_repair_close(metric, x, norms, q, kd, ki, td, ti,
                         cap="set" if k > 256 else "positions")
    again = RS.repair_scan(metric, x, norms, allowed, q, k)
    assert torch.equal(again[0], kd) and torch.equal(again[1], ki)


def test_repair_scan_checks_its_inputs_on_card(dev):
    from hnswindex_torch.ops import repair_scan as RS
    x, norms, allowed, q = _repair_case("sq_euclid", 64, 4096, 32, dev, 3)
    cases = [
        (ValueError, (x, norms, allowed.cpu(), q, 10)),
        (ValueError, (x, norms, allowed, q.T.contiguous().T, 10)),
        (ValueError, (x, norms, allowed, q, RS.KMAX + 1)),
        (TypeError, (x, norms, allowed, q.half(), 10)),
    ]
    for exc, args in cases:
        with pytest.raises(exc):
            RS.repair_scan("sq_euclid", *args)


@pytest.mark.parametrize("S,ns,k,want_p", [
    (32768, 1_007_616, 100, 1),     # the churn cell's first wave
    (2_000, 1_007_616, 100, 15),    # its layer-1 members, ungathered
    (20_000, 1_007_616, 100, 5),    # a wave's ragged rest
    (5, 3_000, 256, 1),             # too few tiles to split
    (1, 1_000_000, 256, 8),         # k caps the union the sort takes
    (1, 1_000_000, 512, 4),
])
def test_repair_scan_plan_fills_the_card_in_whole_tiles(dev, S, ns, k,
                                                         want_p):
    """The kernel's split plan: whole 128-row tiles, none empty, at most
    16 splits and 2,048 entries for the sort; on a 132-SM card the counts
    the rule gives."""
    import ctypes
    from hnswindex_torch.ops import _cuda
    P, rows = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(dev):
        err = _cuda.library("repair_scan").hnsw_repair_scan_plan(
            S, ns, k, ctypes.byref(P), ctypes.byref(rows))
    assert err == 0
    P, rows = P.value, rows.value
    assert rows % 128 == 0 and (P - 1) * rows < ns <= P * rows
    assert 1 <= P <= 16 and P * k <= 2048
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert P == want_p


def test_removal_scan_below_the_gate_is_one_launch_on_card(dev):
    """At 2^20 - 4,096 rows of capacity the removal's candidate scan is
    one K4 launch for all 4,100 scan ids (-1 among them), tallied on the
    timer, with the twin's ids on >= 0.999 of entries."""
    from hnswindex_torch.core import graph as G
    from hnswindex_torch.core import remove as TR
    from hnswindex_torch.ops import repair_scan as RS
    from hnswindex_torch.utils.profiling import PhaseTimer
    C, D = (1 << 20) - 4096, 100
    g = torch.Generator(device=dev).manual_seed(29)
    cfg = G.GraphConfig(dim=D)
    st = G.empty_state(cfg, C, dev)
    G.write_rows(st, cfg, torch.arange(C, device=dev),
                 torch.rand((C, D), generator=g, device=dev),
                 torch.zeros(C, dtype=torch.int32, device=dev))
    scan = torch.randperm(C, generator=g, device=dev)[:4099]
    st.active[scan] = False
    scan = torch.cat([scan, scan.new_full((1,), -1)])
    timer = PhaseTimer(dev)
    n0 = RS.repair_scan.calls
    got = TR.exact_repair_candidates(cfg, st, scan, 0, 100, timer=timer)
    torch.cuda.synchronize()
    assert RS.repair_scan.calls == n0 + 1
    assert timer.seconds()["remove.scan_calls"] == 1
    assert bool((got[-1] == -1).all())
    _, want = RS.repair_scan_ref(cfg.metric, st.vectors, st.norms, st.active,
                                 st.vectors[scan[:-1]], 100)
    assert (got[:-1] == want).float().mean().item() >= 0.999
    assert not torch.isin(got, scan[:-1]).any()


@pytest.mark.parametrize("layer", [0, 1])
def test_removal_scan_of_a_bf16_table_is_one_launch_on_card(dev, layer):
    """A bfloat16 ranking table below the gate: one K4 launch a layer
    (the level >= 1 rows as a gathered copy), tallied on the timer, with
    the twin's ids on that table on >= 0.999 of entries."""
    from hnswindex_torch.core import graph as G
    from hnswindex_torch.core import remove as TR
    from hnswindex_torch.ops import repair_scan as RS
    from hnswindex_torch.utils.profiling import PhaseTimer
    C, D = 200_000, 100
    g = torch.Generator(device=dev).manual_seed(31 + layer)
    cfg = G.GraphConfig(dim=D, rank_dtype="bfloat16")
    st = G.empty_state(cfg, C, dev)
    lvl = (torch.rand((C,), generator=g, device=dev) < 0.06).to(torch.int32)
    G.write_rows(st, cfg, torch.arange(C, device=dev),
                 torch.rand((C, D), generator=g, device=dev), lvl)
    assert st.vlo.dtype == torch.bfloat16
    scan = (lvl >= layer).nonzero()[:, 0][:2000]
    st.active[scan] = False
    timer = PhaseTimer(dev)
    n0 = RS.repair_scan.calls
    got = TR.exact_repair_candidates(cfg, st, scan, layer, 100, timer=timer)
    torch.cuda.synchronize()
    assert RS.repair_scan.calls == n0 + 1
    assert timer.seconds()["remove.scan_calls"] == 1
    allowed = st.active & (st.level >= layer)
    _, want = RS.repair_scan_ref(cfg.metric, st.vlo, st.norms, allowed,
                                 st.vectors[scan], 100)
    assert bool(allowed[got[got >= 0]].all())
    assert (got == want).float().mean().item() >= 0.999


def test_removal_past_the_kernels_width_raises_on_card(dev):
    """Below the gate a removal asking for more than K4's 512 candidates
    a removed row raises before it marks anything."""
    from hnswindex_torch.core import graph as G
    from hnswindex_torch.core import remove as TR
    from hnswindex_torch.ops import repair_scan as RS
    C, D = 5_000, 16
    cfg = G.GraphConfig(dim=D)
    st = G.empty_state(cfg, C, dev)
    G.write_rows(st, cfg, torch.arange(C, device=dev),
                 torch.rand((C, D), device=dev),
                 torch.zeros(C, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="at most 512"):
        TR.remove_from_state(cfg, st, np.arange(10), RS.KMAX + 1)
    assert bool(st.active.all())


def _sharded_corpus(n, dim, seed):
    rng = np.random.default_rng(seed)
    centers = rng.random((max(2, n // 250), dim)).astype(np.float32)
    return (centers[rng.integers(0, centers.shape[0], n)]
            + 0.03 * rng.standard_normal((n, dim)).astype(np.float32))


def test_sharded_exact_query_runs_the_kernel_on_card(dev, monkeypatch):
    """A 6,000 x 128 ShardedIndex on two shards of the one card:
    ``knn_query(exact=True)`` launches the lane-min kernel on each shard,
    and one shard's scan (its 8,192-row prefix, 4,096 lanes, as the exact
    path calls exact_knn2) gives the plain version's ids on >= 0.999 of
    entries; the answers are the brute-force top-10 (recall >= 0.99)."""
    from hnswindex_torch.index import EXACT_LANES
    from hnswindex_torch.parallel.sharded import ShardedIndex
    n, dim = 6000, 128
    vecs = _sharded_corpus(n, dim, 31)
    ix = ShardedIndex(dim, parameters=T.HNSWParameters(collection_size=n),
                      devices=[dev, dev])
    gids = ix.add(vecs)
    q = vecs[:300] + 0.01
    n0 = TF.lane_min_scan.launches
    ids, _ = ix.knn_query(q, 10, exact=True)
    assert TF.lane_min_scan.launches - n0 == 2
    d = ((q[:, None, :].astype(np.float64) - vecs[None]) ** 2).sum(-1)
    gt = gids[np.argsort(d, axis=1)[:, :10]]
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])
    assert rec >= 0.99, rec
    st = ix._states[1]
    ns = ix._exact_nscan()
    args = ("sq_euclid", st.vectors, st.coarse_table[:ns], st.norms[:ns],
            st.active[:ns], torch.as_tensor(q).to(dev), 10)
    _, got = TB.exact_knn2(*args, lanes=EXACT_LANES)
    monkeypatch.setattr(TF, "lane_min_scan", TF.lane_min_scan_ref)
    _, want = TB.exact_knn2(*args, lanes=EXACT_LANES)
    assert (got == want).float().mean().item() >= 0.999


def _shard_edges(ix):
    out = []
    for st in ix._states:
        nbr, deg = st.nbr0.cpu().numpy(), st.deg0.cpu().numpy()
        out.append({(u, int(v)) for u in range(nbr.shape[0])
                    for v in nbr[u, :deg[u]]})
    return out


def test_sharded_build_through_the_kernel_on_card(dev, monkeypatch):
    """A 3,000 x 128 sharded build on ``[card] * 2`` with the two-stage scan
    gate lowered to 0, so every full-width wave scans through the kernel,
    against the same build on ``["cpu"] * 2`` (the plain scan): kernel
    launches > 0 and each shard's layer-0 edges overlap >= 0.99."""
    from hnswindex_torch.parallel.sharded import ShardedIndex
    monkeypatch.setattr(TC, "BUILD_SCAN2_MIN", 0)
    n, dim = 3000, 128
    vecs = _sharded_corpus(n, dim, 37)
    built = {}
    for where in ("cpu", dev):
        ix = ShardedIndex(dim, parameters=T.HNSWParameters(collection_size=n),
                          devices=[where, where])
        n0 = TF.lane_min_scan.launches
        ix.add(vecs)
        launched = TF.lane_min_scan.launches - n0
        assert (launched > 0) == (where != "cpu")
        built[str(where)] = ix
    for a, b in zip(_shard_edges(built["cpu"]), _shard_edges(built[str(dev)])):
        assert len(a & b) / len(a | b) >= 0.99
    ids, _ = built[str(dev)].knn_query(vecs[:500], 1)
    gids = np.arange(n)            # round-robin from an empty index
    assert (ids[:, 0] == gids[:500]).mean() > 0.85


def test_sharded_block_index_runs_the_kernel_on_card(dev):
    """A 3,000 x 32 ShardedBlockIndex (64-row blocks) on two shards of the
    card: ``knn_query`` launches K2 on both shards; each shard's K2 panel
    selects the plain ``_score_blocks`` top-10 on the same local probes (up
    to float64 near-ties); every block probed gives the brute-force
    top-10."""
    from hnswindex_torch import block as TBL
    n, dim = 3000, 32
    vecs = _sharded_corpus(n, dim, 41)
    ix = T.ShardedBlockIndex(dim, block_size=64, devices=[dev, dev])
    ix.build(vecs)
    q = vecs[:200] + 0.01
    n0 = TBS.block_scores.launches
    ids, _ = ix.knn_query(q, 10, n_probe=8)
    assert TBS.block_scores.launches - n0 == 2
    qt = torch.as_tensor(q).to(dev)
    gb = TBL._route_exact(ix.metric, ix._cents, ix._cent_norms, qt, 8,
                          ix._cent_valid)
    d64 = ((q[:, None, :].astype(np.float64) - vecs[None]) ** 2).sum(-1)
    for s in range(2):
        local = ix._shard_probes(gb, s)
        bv = ix._blk_vecs[s]
        _, pid = TBL._score_blocks_panel(ix.metric, bv, ix._blk_ids[s],
                                         ix._blk_fill[s], qt, local, 10)
        norms = tdst.norm_data(ix.metric, bv.reshape(-1, dim)) \
            .reshape(bv.shape[:2])
        _, rid = TBL._score_blocks(ix.metric, bv, ix._blk_ids[s], norms, qt,
                                   local, 10)
        pid, rid = pid[:, :10].cpu().numpy(), rid.cpu().numpy()
        for r, c in zip(*np.nonzero(pid != rid)):
            a, b = pid[r, c], rid[r, c]
            assert a >= 0 and b >= 0 and abs(d64[r, a] - d64[r, b]) <= 1e-5
    full, _ = ix.knn_query(q, 10, n_probe=ix.n_blocks)
    gt = np.argsort(d64, axis=1)[:, :10]
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(full, gt)])
    assert rec > 0.999, rec
