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
