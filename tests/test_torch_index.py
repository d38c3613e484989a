"""Facade parity: hnswindex_torch.Index / HNSWIndex against hnswindex_tpu's
on the main path (add, then unfiltered layer-0 knn_query through the
pack), on the unpacked engine's calls (knn_query without the pack, at
layer > 0 and exact, range_query, multi_layer_knn_query), remove, update,
filters, statistics, ``.npz`` snapshots and a registered metric on the
reference's graph.

Bars: the reference quickstart's shape (2,000 x 128, sq_euclid, M=16, k=1,
on the bench's clustered corpus) has self-recall > 0.85 (on its first
1,000 items) in both packages (GraphTests.cs:28); recall@10 on a
5,000-row clustered corpus is within 0.01 of the reference's."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

import hnswindex_torch as T
import hnswindex_tpu as J
import test_torch_construct as TCT
import test_torch_search as TTS
from hnswindex_torch import index as TI

torch.set_num_threads(1)


def _self_recall(index, vecs, n=1000):
    """Self-recall@1 over the first ``n`` items."""
    ids, dists = index.knn_query(vecs[:n], 1)
    assert ids.dtype == np.int32 and dists.dtype == np.float32
    return (ids[:, 0] == np.arange(n)).mean()


def test_quickstart_self_recall_both_packages():
    """The quickstart's shape (2,000 x 128, sq_euclid, k=1) on the bench's
    clustered corpus; the reference side is test_torch_construct's build,
    made through hnswindex_tpu.Index with the same settings."""
    vecs = TCT.corpus()
    idx = T.Index(128, device="cpu")
    idx.set_collection_size(2000)
    idx._params.pack_queries = "on"
    ids = idx.add(vecs)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, np.arange(2000))
    got = {"torch": _self_recall(idx, vecs),
           "jax": _self_recall(TCT.jax_build(), vecs)}
    assert got["torch"] > 0.85 and got["jax"] > 0.85, got


def test_recall_at_10_matches_reference():
    n, dim, k = 5000, 128, 10
    rng = np.random.default_rng(65537)
    centers = rng.random((n // 500, dim)).astype(np.float32)
    vecs = (centers[rng.integers(0, n // 500, n)]
            + 0.03 * rng.standard_normal((n, dim)).astype(np.float32))
    q = vecs[:500]
    q64, v64 = q.astype(np.float64), vecs.astype(np.float64)
    d = ((q64 * q64).sum(1)[:, None] + (v64 * v64).sum(1)[None]
         - 2.0 * q64 @ v64.T)
    gt = np.argsort(d, axis=1)[:, :k]
    rec = {}
    for name, mod, extra in (("torch", T, dict(device="cpu")),
                             ("jax", J, {})):
        idx = mod.HNSWIndex(dim, "sq_euclid", mod.HNSWParameters(
            collection_size=n, pack_queries="on"), **extra)
        idx.add(vecs)
        ids, dists = idx.knn_query(q, k)
        assert (np.diff(dists, axis=1) >= 0).all()
        rec[name] = np.mean([len(set(a) & set(b)) / k
                             for a, b in zip(ids, gt)])
    assert abs(rec["torch"] - rec["jax"]) <= 0.01, rec
    assert rec["torch"] > 0.9, rec


@pytest.fixture(scope="module")
def small():
    vecs = np.random.default_rng(1).random((300, 16), np.float32)
    idx = T.Index(16, device="cpu")
    idx._params.pack_queries = "on"
    idx.add(vecs)
    return idx, vecs


def test_introspection_and_padding(small):
    idx, vecs = small
    assert idx.count == 300
    np.testing.assert_array_equal(idx.ids(), np.arange(300))
    np.testing.assert_array_equal(idx.items(), vecs)
    ids, dists = idx.knn_query(vecs[:3], 0)
    assert ids.shape == (3, 0)
    with pytest.raises(RuntimeError):
        idx.set_max_edges(8)


@pytest.fixture(scope="module")
def pair():
    """The reference's 2,000 x 128 build (test_torch_construct) and a port
    index holding the same graph; queries are perturbed corpus rows."""
    ji = TCT.jax_build()._impl
    vecs = TCT.corpus()
    rng = np.random.default_rng(12)
    q = (vecs[:100] + 0.02 * rng.standard_normal((100, TCT.DIM))).astype(
        np.float32)
    return ji, TTS.installed(ji), vecs, q


def _same_knn(ti, ji, vecs, q, k, **kw):
    """knn_query through both packages: the same ids up to near-tie swaps
    (test_torch_search's bar), float32 distances at rtol=atol=1e-5 where
    the ids agree.  Returns the port's ids."""
    tids, td = ti.knn_query(q, k, **kw)
    jids, jd = ji.knn_query(q, k, **kw)
    assert TTS.near_tie_rows("sq_euclid", q, vecs, tids, jids).all()
    same = tids == jids
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-5)
    assert (np.diff(td, axis=1) >= 0).all()
    return tids


def _layer_matches(pair):
    ji, ti, vecs, q = pair
    tids = _same_knn(ti, ji, vecs, q, 10, layer=1)
    assert (ti._state.level.numpy()[tids] >= 1).all()


def _exact_matches(pair):
    """exact=True at k=10: the port's stage 1 is the lane-min scan at
    4,096 lanes, which on these 2,048 rows holds at most one row a lane,
    so it keeps every true neighbour as the reference's panel branch on
    the CPU does: the same ids up to near-tie swaps."""
    ji, ti, vecs, q = pair
    _same_knn(ti, ji, vecs, q, 10, exact=True)


def _range_matches(pair):
    """range_query at the median distance of the 10th neighbour: the same
    id sets up to near-radius ids, ascending distances <= radius."""
    ji, ti, vecs, q = pair
    q = q[:32]
    d = TTS.d64("sq_euclid", q, vecs,
                np.broadcast_to(np.arange(len(vecs)), (len(q), len(vecs))))
    radius = float(np.float32(np.median(np.sort(d, axis=1)[:, 9])))
    tids, tds = ti.range_query(q, radius)
    jids, _ = ji.range_query(q, radius)
    assert len(tids) == len(q)
    for r in range(len(q)):
        assert (np.diff(tds[r]) >= 0).all() and (tds[r] <= radius).all()
        assert len(set(tids[r].tolist())) == tids[r].size
        odd = np.asarray(sorted(set(tids[r]) ^ set(jids[r])), np.int64)
        if odd.size:
            dd = TTS.d64("sq_euclid", q[r:r + 1], vecs, odd[None])
            sc = TTS.noise_scale("sq_euclid", q[r:r + 1], vecs, odd[None])
            assert (np.abs(dd - radius) <= TTS.GAP * sc).all()


def _churned(pair, call):
    """``call`` applied to a copy of the reference index and to a port
    index holding the same graph; the port's ``active``, ``ep``, count,
    free list and levels equal the reference's after it, and each layer's
    directed edges overlap at >= 0.99."""
    import test_torch_remove as TTR
    ji0, _, vecs, _ = pair
    ji, ti = TTR.jax_clone(ji0), TTS.installed(ji0)
    call(ji, vecs)
    call(ti, vecs)
    t = TTR._snap(ti, TTR.t_dense)
    j = TTR._snap(ji, TTR.j_dense)
    TTR._same_host_state(t, j)
    rows = np.flatnonzero(t["active"])
    for layer in range(t["nbr"].shape[0]):
        assert TTR._overlap(t["nbr"], t["deg"], j["nbr"], j["deg"], layer,
                            rows) >= 0.99
    return ti


def _remove_matches(pair):
    ti = _churned(pair, lambda i, v: i.remove([0]))
    assert ti._free == [0] and not bool(ti._state.active[0])


def _update_matches(pair):
    ti = _churned(pair, lambda i, v: i.update([0], v[:1] + 0.01))
    assert ti._free == [] and bool(ti._state.active[0])
    np.testing.assert_array_equal(ti._rows([0])[0], pair[2][0] + 0.01)


def _filter_matches(pair):
    """An id-list filter of two ids at k=3 (the packed walk from row 0
    meets id 2 only): the reference's ids and distances, padded."""
    ji, ti, vecs, q = pair
    tids, td = ti.knn_query(vecs[:1], 3, filter_fnc=[1, 2])
    jids, jd = ji.knn_query(vecs[:1], 3, filter_fnc=[1, 2])
    np.testing.assert_array_equal(tids, jids)
    assert set(tids[0].tolist()) <= {1, 2, -1} and tids[0, 0] >= 0
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


def _multi_layer_matches(pair):
    """multi_layer_knn_query: indexed by layer, the ids of layer l have
    level >= l and equal the reference's up to near-tie swaps."""
    ji, ti, vecs, q = pair
    lvl = ti._state.level.numpy()
    for r in range(4):
        got = ti.multi_layer_knn_query(q[r], 10)
        want = ji.multi_layer_knn_query(q[r], 10)
        assert len(got) == len(want) >= 2
        for layer, ((ti_, td_), (ji_, _)) in enumerate(zip(got, want)):
            assert ti_.shape == ji_.shape
            assert (lvl[ti_] >= layer).all()
            assert (np.diff(td_) >= 0).all()
            assert TTS.near_tie_rows("sq_euclid", q[r:r + 1], vecs,
                                     ti_[None], ji_[None]).all()


def _get_info_matches(pair):
    ji, ti, _, _ = pair
    got = [dataclasses.asdict(x) for x in ti.get_info().layers]
    assert got == [dataclasses.asdict(x) for x in ji.get_info().layers]
    assert got[0]["nodes_count"] == TCT.N


def _components_match(pair):
    ji, ti, _, _ = pair
    assert ti.get_connected_component_counts() == \
        ji.get_connected_component_counts()


def _serialize_matches(pair):
    """The port's file, read by the reference, answers as the reference's
    own index does."""
    ji, ti, vecs, q = pair
    with tempfile.TemporaryDirectory() as d:
        ti.serialize(os.path.join(d, "port"))
        jl = J.HNSWIndex.deserialize(os.path.join(d, "port.npz"))
    for a, b in zip(jl.knn_query(q, 10), ji.knn_query(q, 10)):
        np.testing.assert_array_equal(a, b)


def _deserialize_matches(pair):
    """The reference's file, read by the port's drop-in ``Index``, answers
    as the port's index holding the same graph does."""
    ji, ti, vecs, q = pair
    with tempfile.TemporaryDirectory() as d:
        ji.serialize(os.path.join(d, "ref.npz"))
        tl = T.Index.deserialize(os.path.join(d, "ref.npz"), device="cpu")
    assert isinstance(tl, T.Index) and tl.count == ti.count
    for a, b in zip(tl.knn_query(q, 10), ti.knn_query(q, 10)):
        np.testing.assert_array_equal(a, b)


def _register_metric_matches(pair):
    """Squared L2 registered as a torch callable and served on the
    reference's graph by the custom branches (the pack's elementwise entry
    scan and expansion) against the reference's sq_euclid answers: the
    same ids up to near-tie swaps on >= 0.98 of the rows (measured 0.99:
    one walk of 100 ends on another tenth neighbour), the same recall@10
    within 0.01 (measured equal, 0.931), distances ascending and equal to
    the reference's where the ids agree."""
    ji, _, vecs, q = pair
    T.register_metric("sq_callable",
                      lambda a, b: torch.sum((a - b) ** 2, dim=-1))
    ti = TTS.installed(ji)
    ti.metric = "sq_callable"
    ti._cfg = dataclasses.replace(ti._cfg, metric="sq_callable")
    assert T.ops.distance.is_custom(ti.metric)
    tids, td = ti.knn_query(q, 10)
    jids, jd = ji.knn_query(q, 10)
    assert ti._pack is not None
    assert TTS.near_tie_rows("sq_euclid", q, vecs, tids, jids).mean() >= 0.98
    same = tids == jids
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-5)
    assert (np.diff(td, axis=1) >= 0).all()
    gt = TTS.d64("sq_euclid", q, vecs, np.broadcast_to(
        np.arange(len(vecs)), (len(q), len(vecs)))).argsort(1)[:, :10]
    rec = [np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])
           for ids in (tids, jids)]
    assert abs(rec[0] - rec[1]) <= 0.01, rec


#: calls the later slices ported: their cases now check the answer against
#: the reference's
_PORTED = {"range_query": _range_matches, "multi_layer": _multi_layer_matches,
           "layer": _layer_matches, "exact": _exact_matches,
           "remove": _remove_matches, "update": _update_matches,
           "filter": _filter_matches, "get_info": _get_info_matches,
           "components": _components_match, "serialize": _serialize_matches,
           "deserialize": _deserialize_matches,
           "register_metric": _register_metric_matches}


@pytest.mark.parametrize("call", [
    "remove", "update", "range_query", "multi_layer", "get_info",
    "components", "serialize", "deserialize", "filter", "layer", "exact",
    "register_metric"])
def test_out_of_slice_calls_raise(pair, call):
    """The calls that were outside the ported slices keep their cases: each
    now holds the port's answer against the reference's on the reference's
    graph (none raises any more)."""
    _PORTED[call](pair)


@pytest.mark.parametrize("setting", ["auto", "off", "budget", "threshold"])
def test_out_of_slice_configurations_raise(request, setting, monkeypatch):
    """Configurations that needed the unpacked engine now answer as the
    reference does.  auto (below pack_min_count), off, and a pack refused
    for its budget (pack_max_bytes=1,024) with no block fallback (under
    pack_min_count) serve through the unpacked beam on the reference's
    graph, in both packages; threshold builds past exact_build_threshold
    through the beam path (test_torch_construct's 1,000 x 32 build) and
    answers as the reference's build does, up to near-tie swaps and the
    build's edge differences (recall@10 within 0.01)."""
    if setting == "threshold":
        vecs, ji = TCT.jax_beam_build()
        ti = T.HNSWIndex(TCT.BEAM_DIM, parameters=TCT.beam_params(T),
                         device="cpu")
        ti.add(vecs)
        assert ti.wave_counts["beam"] > 0 and ti._get_pack() is None
        rec = {"torch": TCT._recall10(ti, vecs),
               "jax": TCT._recall10(ji, vecs)}
        assert abs(rec["torch"] - rec["jax"]) <= 0.01, rec
        return
    ji, ti, vecs, q = request.getfixturevalue("pair")
    over = dict(pack_queries="on", pack_max_bytes=1024) \
        if setting == "budget" else dict(pack_queries=setting)
    ti = TTS.installed(ji, **over)
    for name, value in over.items():
        monkeypatch.setattr(ji.params, name, value)
    monkeypatch.setattr(ji, "_pack", None)
    _same_knn(ti, ji, vecs, q, 10)
    assert ti._pack is None and ti._block_fb is None
    assert ti._pack_refusal == {"auto": "too_small", "off": "disabled",
                                "budget": "budget"}[setting]


@pytest.mark.parametrize("k,layer", [(300, 0), (10, 1)])
def test_exact_query_matches_reference(pair, k, layer):
    """exact=True at k=300 (survivor width 1,200: the panel branch in both
    packages) and at layer 1 (only rows of level >= 1 are candidates): the
    same ids as the reference's up to near-tie swaps."""
    ji, ti, vecs, q = pair
    tids = _same_knn(ti, ji, vecs, q[:20], k, exact=True, layer=layer)
    assert (tids >= 0).all()
    assert (ti._state.level.numpy()[tids] >= layer).all()


def test_cuda_index_refuses_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32|full-precision"):
            TI._check_full_f32(torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    TI._check_full_f32(torch.device("cpu"))


def test_pre_init_calls_raise_cleanly():
    idx = T.Index(8, device="cpu")
    assert idx.count == 0 and idx.ids().size == 0
    with pytest.raises(RuntimeError):
        idx.knn_query(np.zeros((1, 8), np.float32), 1)
    with pytest.raises(ValueError):
        T.Index(8, metric="manhattan", device="cpu")
