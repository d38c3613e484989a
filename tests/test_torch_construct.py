"""Build parity: the same 2,000 x 128 clustered corpus, seed and parameters
(M=16, efConstruction=100, max_wave_size=512) built through both
packages' facades.

Edge overlap is |A & B| / |A | B| of one layer's directed edge sets.
Measured on this corpus: 0.998 at layer 0 and 1.0 on the upper layers;
the bar is 0.98 per layer.  A second port build takes the two-stage scan
(the lane-min kernel's plain version) on every full-width wave, which the
reference takes only from 2^19 rows; its layer-0 overlap with the
reference build measured 0.973 and is held to 0.93."""

import functools

import numpy as np
import pytest
import torch

import hnswindex_torch as T
import hnswindex_tpu as J
from hnswindex_torch.core import construct as TC
from hnswindex_torch.core.graph import dense_tables as t_dense
from hnswindex_torch.ops import fused_scan as TF
from hnswindex_tpu.core.graph import dense_tables as j_dense

torch.set_num_threads(1)

N, DIM, M = 2000, 128, 16
EDGE_BAR = 0.98
EDGE_BAR_SCAN2 = 0.93


def corpus():
    rng = np.random.default_rng(65537)
    centers = rng.random((max(2, N // 500), DIM)).astype(np.float32)
    return (centers[rng.integers(0, centers.shape[0], N)]
            + 0.03 * rng.standard_normal((N, DIM)).astype(np.float32))


def _params(mod):
    return mod.HNSWParameters(collection_size=N, max_edges=M,
                              max_candidates=100, max_wave_size=512,
                              pack_queries="on")


@functools.lru_cache(maxsize=1)
def jax_build():
    """The reference build of ``corpus()`` through its drop-in ``Index``
    (the same parameters as ``_params``); cached per process because
    test_torch_pack and test_torch_index use the same graph (a CPU build of
    the reference takes ~10 s)."""
    ji = J.Index(DIM, "sq_euclid")
    ji.set_collection_size(N)
    ji._params.pack_queries = "on"
    ji.add(corpus())
    assert ji._params == _params(J)
    return ji


@pytest.fixture(scope="module")
def builds():
    vecs = corpus()
    ji = jax_build()._impl
    ti = T.HNSWIndex(DIM, "sq_euclid", _params(T), device="cpu")
    ti.add(vecs)
    calls = [0]
    ref = TF.lane_min_scan_ref

    def counting(*a, **k):
        calls[0] += 1
        return ref(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TC, "BUILD_SCAN2_MIN", 0)
        mp.setattr(TF, "lane_min_scan_ref", counting)
        t2 = T.HNSWIndex(DIM, "sq_euclid", _params(T), device="cpu")
        t2.add(vecs)
    return vecs, ji, ti, t2, calls[0]


def _edges(nbr, deg, layer):
    C = nbr.shape[1]
    return {(u, int(v)) for u in range(C)
            for v in nbr[layer, u, :deg[layer, u]]}


def _overlap(jstate, tstate):
    jn, jd = j_dense(jstate)
    tn, td = t_dense(tstate)
    out = []
    for layer in range(jn.shape[0]):
        je, te = _edges(jn, jd, layer), _edges(tn, td, layer)
        if je or te:
            out.append(len(je & te) / max(1, len(je | te)))
    return out


def _check_invariants(index):
    st = index._state
    nbr, deg = t_dense(st)
    lvl = st.level.numpy()
    act = st.active.numpy()
    K0 = st.nbr0.shape[1]
    assert K0 == 2 * M + min(8, M // 2)
    for layer in range(nbr.shape[0]):
        cap = K0 if layer == 0 else M
        assert (deg[layer] <= cap).all()
        cols = np.arange(nbr.shape[2])[None, :]
        assert (nbr[layer][cols >= deg[layer][:, None]] == -1).all()
        for u in np.flatnonzero(deg[layer]):
            row = nbr[layer, u, :deg[layer, u]]
            assert (row >= 0).all() and act[row].all()
            assert u not in row, (layer, u)
            assert len(set(row.tolist())) == row.size, (layer, u)
            assert (lvl[row] >= layer).all(), (layer, u)
            assert lvl[u] >= layer


def _self_recall(index, vecs):
    ids, _ = index.knn_query(vecs, 1)
    return (ids[:, 0] == np.arange(len(vecs))).mean()


def test_levels_identical(builds):
    _, ji, ti, t2, _ = builds
    want = np.asarray(ji._state.level)
    np.testing.assert_array_equal(ti._state.level.numpy(), want)
    np.testing.assert_array_equal(t2._state.level.numpy(), want)
    assert int(ti._state.ep) == int(np.asarray(ji._state.ep))


def test_edge_sets_match_reference(builds):
    _, ji, ti, _, _ = builds
    overlap = _overlap(ji._state, ti._state)
    assert len(overlap) >= 2
    assert min(overlap) >= EDGE_BAR, overlap


@pytest.mark.parametrize("which", ["default", "scan2"])
def test_invariants_and_self_recall(builds, which):
    vecs, _, ti, t2, _ = builds
    index = ti if which == "default" else t2
    assert index.count == N
    _check_invariants(index)
    assert _self_recall(index, vecs) > 0.85        # GraphTests.cs:28


def test_scan2_build_goes_through_lane_min_scan(builds):
    _, ji, _, t2, calls = builds
    assert calls > 0
    overlap = _overlap(ji._state, t2._state)
    assert overlap[0] >= EDGE_BAR_SCAN2, overlap


def _small_corpus(n, dim, seed):
    rng = np.random.default_rng(seed)
    centers = rng.random((8, dim)).astype(np.float32)
    return (centers[rng.integers(0, 8, n)]
            + 0.05 * rng.standard_normal((n, dim)).astype(np.float32))


def _recall10(index, vecs, nq=200):
    q64, v64 = vecs[:nq].astype(np.float64), vecs.astype(np.float64)
    d = ((q64 * q64).sum(1)[:, None] + (v64 * v64).sum(1)[None]
         - 2.0 * q64 @ v64.T)
    gt = np.argsort(d, axis=1)[:, :10]
    ids, _ = index.knn_query(vecs[:nq], 10)
    return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])


BEAM_N, BEAM_DIM, BEAM_THRESHOLD = 1000, 32, 100


def beam_params(mod):
    return mod.HNSWParameters(collection_size=BEAM_N,
                              exact_build_threshold=BEAM_THRESHOLD)


@functools.lru_cache(maxsize=1)
def jax_beam_build():
    """The reference's beam-path build of a 1,000 x 32 clustered corpus
    (exact_build_threshold=100), cached per process (test_torch_index's
    threshold case compares against it).  Returns (vecs, HNSWIndex)."""
    vecs = _small_corpus(BEAM_N, BEAM_DIM, 91)
    ji = J.HNSWIndex(BEAM_DIM, "sq_euclid", beam_params(J))
    ji.add(vecs)
    return vecs, ji


def test_beam_path_build_matches_reference():
    """1,000 x 32 with exact_build_threshold=100: the waves from 128 built
    rows on (872 rows) take the beam path in both packages.  Per-layer
    edge overlap >= BEAM_EDGE_BAR; recall@10 of the unpacked query (200
    corpus rows) within 0.01 of the reference's."""
    vecs, ji = jax_beam_build()
    ti = T.HNSWIndex(BEAM_DIM, "sq_euclid", beam_params(T), device="cpu")
    ti.add(vecs)
    assert ti.wave_counts == {"exact": 7, "beam": 3}
    overlap = _overlap(ji._state, ti._state)
    assert len(overlap) >= 2
    assert min(overlap) >= BEAM_EDGE_BAR, overlap
    _check_invariants(ti)
    rec = {"torch": _recall10(ti, vecs), "jax": _recall10(ji, vecs)}
    assert abs(rec["torch"] - rec["jax"]) <= 0.01, rec


#: measured per-layer edge overlap of the beam-path build above with the
#: reference's: 1.0 at every layer (recall@10 0.993 in both); held to the
#: default build's bar
BEAM_EDGE_BAR = EDGE_BAR


def test_efc300_build_takes_panel_branch_in_both_packages():
    """efConstruction=300 with BUILD_SCAN2_MIN patched to 0 in both
    construct modules: every full-width wave (more than 8 rows at
    max_wave_size=64) scans through exact_knn2 with survivor width
    S = min(prefix, 1,200), which past 1,024 prefix rows is the panel
    branch in both packages (the reference's on the CPU always is).  All
    rows sit at level 0 (distribution_rate=0), which keeps the reference's
    compiles few; the layer-0 edge sets match at EDGE_BAR (measured
    0.9998)."""
    from hnswindex_torch.ops import bruteforce as TB
    from hnswindex_tpu.core import construct as JC
    from hnswindex_tpu.ops import bruteforce as JB

    n, dim = 1100, 16
    vecs = _small_corpus(n, dim, 92)
    traced, panels = [0], [0]
    jref, tref = JB.exact_knn2, TB._panel_survivors

    def jcount(*a, **k):
        traced[0] += 1
        return jref(*a, **k)

    def tcount(*a, **k):
        panels[0] += 1
        return tref(*a, **k)

    built = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TC, "BUILD_SCAN2_MIN", 0)
        mp.setattr(JC, "BUILD_SCAN2_MIN", 0)
        mp.setattr(JB, "exact_knn2", jcount)
        mp.setattr(TB, "_panel_survivors", tcount)
        for name, mod, extra in (("torch", T, dict(device="cpu")),
                                 ("jax", J, {})):
            p = mod.HNSWParameters(collection_size=n, max_candidates=300,
                                   distribution_rate=0.0, max_wave_size=64)
            ix = mod.HNSWIndex(dim, "sq_euclid", p, **extra)
            ix.add(vecs)
            built[name] = ix
    assert traced[0] > 0, "the reference never traced exact_knn2"
    assert panels[0] > 0, "the port never took the panel branch"
    overlap = _overlap(built["jax"]._state, built["torch"]._state)
    assert overlap and min(overlap) >= EDGE_BAR, overlap


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
def test_stacked_upper_connect_builds_the_per_layer_graph(metric,
                                                          monkeypatch):
    """1,500 x 16 rows with distribution_rate=1.0, so waves reach level 3
    and upper rows overflow their M columns: the one-pass upper connect
    over the stacked upper table builds the tables of the per-layer loop
    (``torch_cases.upper_connect_per_layer``) bit for bit, and tallies
    one prune per wave covering its layers."""
    from torch_cases import upper_connect_per_layer, upper_overflows

    n, dim = 1500, 16
    vecs = _small_corpus(n, dim, 94)
    tops = []
    real = TC.upper_connect_exact

    def spy(cfg, state, ids, lvls, panel_ids, max_lvl=0, timer=None):
        tops.append(min(state.num_levels - 1, max_lvl))
        return real(cfg, state, ids, lvls, panel_ids, max_lvl, timer)

    built = {}
    for how in ("stacked", "per_layer"):
        with monkeypatch.context() as mp:
            over = upper_overflows(mp, M)
            mp.setattr(TC, "upper_connect_exact",
                       spy if how == "stacked" else upper_connect_per_layer)
            ix = T.HNSWIndex(dim, metric, T.HNSWParameters(
                collection_size=n, distribution_rate=1.0), device="cpu")
            ix.add(vecs)
        st = ix._state
        built[how] = (st.nbru, st.degu, st.nbr0, st.deg0, st.ep)
        if how == "stacked":
            assert max(tops) >= 3, tops
            assert sum(over) > 0, over
            ph = ix.timer.seconds()
            assert ph["upper.prunes"] == len(tops)
            assert ph["upper.layers"] == sum(tops)
    for name, a, b in zip(("nbru", "degu", "nbr0", "deg0", "ep"),
                          built["stacked"], built["per_layer"]):
        assert torch.equal(a, b), name
