"""Sharded index parity: hnswindex_torch's ``ShardedIndex`` on
``["cpu"] * S`` against hnswindex_tpu's on ``jax.devices()[:S]``, for S = 2
and 3, from the same seeded numpy corpus (1,500 x 16 clustered, M=8,
efConstruction=40, max_wave_size=64, added in two batches) and parameters.

Bars:

* the build: gids equal, the wave trace (each wave's width on every shard)
  equal, every shard's levels and host mirrors (lengths, counts, seeded
  flags, upper sets, the shared scan mark) equal, and each shard's
  directed edges overlapping the reference's at >= 0.99 (|A & B| / |A | B|)
  at layer 0 and above (the single-chip build matched at 0.998 and 1.0;
  measured 1.0 here);
* queries on the reference's own graph, carried across with
  ``convert.sharded_states_from_numpy``: packed, unpacked, ``exact=True``,
  ``layer=1``, an id list and a bool mask, a callable, ``range_query`` and
  ``multi_layer_knn_query``; ids equal wherever the float64 gap exceeds
  float noise (``test_torch_search``'s rule), distances within 1e-5
  where ids agree; the filtered pools against the reference's rows without
  their repeats (``first_unique``, ``tail_rows``);
* the refine above the mirror budget (``MIRROR_MAX_BYTES`` patched to 0
  in the port) gives the same ids as the float64 mirror refine;
* churn on the installed graph: ``remove`` (out-of-range ids ignored,
  one removal quality for all shards, resolved on the whole batch) with
  equal free lists, counts and upper sets, the post/pre self-recall
  ratio of the survivors within 0.01 of the reference's; an add after it
  takes the same gids; ``update`` leaves equal free lists and counts;
* ``get_info`` and the component counts equal (S components at layer 0);
* a ``.npz`` written by either package is read by the other and answers
  alike; a snapshot without ``gid_scheme`` is refused.

Port-only: growth keeps every gid, ``devices=None`` without a card raises,
a snapshot with more shards than devices raises, a wrong-length bool mask
raises, and a registered metric with ``exact=True`` raises (also with a
callable filter, which the reference silently serves by beams)."""

import copy
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import hnswindex_torch as T
import test_torch_search as TTS
from hnswindex_torch import convert
from hnswindex_torch.core import remove as TR
from hnswindex_torch.parallel import sharded as TSH
from hnswindex_torch.utils import refine
from hnswindex_tpu.params import HNSWParameters as JParams
from hnswindex_tpu.parallel.sharded import ShardedIndex as JSharded

torch.set_num_threads(1)

N, DIM = 1500, 16
KW = dict(collection_size=N, max_edges=8, max_candidates=40,
          max_wave_size=64)
NQ = 60
K = 5


def corpus():
    rng = np.random.default_rng(5)
    centers = rng.random((30, DIM)).astype(np.float32)
    return (centers[rng.integers(0, 30, N)]
            + 0.05 * rng.standard_normal((N, DIM))).astype(np.float32)


def queries(vecs):
    rng = np.random.default_rng(17)
    return (vecs[:NQ] + 0.02 * rng.standard_normal((NQ, DIM))) \
        .astype(np.float32)


def port_params(ji, **overrides):
    return T.HNSWParameters(**{**dataclasses.asdict(ji.params),
                               **overrides})


def installed(ji, **overrides):
    """A port ``ShardedIndex`` on ``["cpu"] * S`` holding the reference
    index ``ji``'s graph (every shard's state through
    ``convert.sharded_states_from_numpy``) and a copy of its host mirrors
    and level RNG; ``overrides`` apply to a copy of its parameters."""
    ti = TSH.ShardedIndex(ji.dim, ji.metric, port_params(ji, **overrides),
                          devices=["cpu"] * ji.n_shards)
    assert dataclasses.asdict(ti._cfg) == dataclasses.asdict(ji._cfg)
    leaves = {f: np.asarray(getattr(ji._state, f)) for f in convert.FIELDS}
    ti._states = convert.sharded_states_from_numpy(leaves, ti._cfg,
                                                   ti.devices)
    ti.shard_capacity = ji.shard_capacity
    ti._lengths, ti._counts = ji._lengths.copy(), ji._counts.copy()
    ti._free = copy.deepcopy(ji._free)
    ti._seeded = ji._seeded.copy()
    ti._upper_set = copy.deepcopy(ji._upper_set)
    ti._shwm = ji._shwm
    ti._rng = copy.deepcopy(ji._rng)
    return ti


def jax_clone(ji):
    """A second reference index holding a copy of ``ji``'s state and host
    mirrors (mutations of one leave the other alone)."""
    jc = JSharded(ji.dim, ji.metric, ji.params,
                  devices=list(ji.mesh.devices))
    jc._state = jax.tree.map(lambda x: x.copy(), ji._state)
    jc.shard_capacity = ji.shard_capacity
    for name in ("_lengths", "_counts", "_seeded"):
        setattr(jc, name, getattr(ji, name).copy())
    jc._free = copy.deepcopy(ji._free)
    jc._upper_set = copy.deepcopy(ji._upper_set)
    jc._shwm = ji._shwm
    jc._rng = copy.deepcopy(ji._rng)
    return jc


@pytest.fixture(scope="module", params=[2, 3], ids=["S2", "S3"])
def built(request):
    """The same two-batch build in both packages, with wave traces."""
    S = request.param
    vecs = corpus()
    ji = JSharded(DIM, parameters=JParams(**KW),
                  devices=jax.devices()[:S])
    ti = TSH.ShardedIndex(DIM, parameters=T.HNSWParameters(**KW),
                          devices=["cpu"] * S)
    ji._wave_trace, ti._wave_trace = [], []
    gids = []
    for part in (vecs[:1000], vecs[1000:]):
        gids.append((ji.add(part), ti.add(part)))
    return vecs, ji, ti, gids


def _edges(nbr, deg):
    return {(u, int(v)) for u in range(nbr.shape[0])
            for v in nbr[u, :deg[u]]}


def test_build_matches_reference(built):
    vecs, ji, ti, gids = built
    S = ji.n_shards
    for jg, tg in gids:
        np.testing.assert_array_equal(jg, tg)
    assert len(ji._wave_trace) == len(ti._wave_trace)
    for a, b in zip(ji._wave_trace, ti._wave_trace):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ji._lengths, ti._lengths)
    np.testing.assert_array_equal(ji._counts, ti._counts)
    np.testing.assert_array_equal(ji._seeded, ti._seeded)
    assert ji._upper_set == ti._upper_set
    assert ji._shwm == ti._shwm
    assert ti.shard_capacity == ji.shard_capacity
    jl = np.asarray(ji._state.level)
    jn0, jd0 = np.asarray(ji._state.nbr0), np.asarray(ji._state.deg0)
    jnu, jdu = np.asarray(ji._state.nbru), np.asarray(ji._state.degu)
    for s, st in enumerate(ti._states):
        np.testing.assert_array_equal(jl[s], st.level.numpy())
        assert int(np.asarray(ji._state.ep)[s]) == int(st.ep)
        pairs = [(_edges(jn0[s], jd0[s]),
                  _edges(st.nbr0.numpy(), st.deg0.numpy()))]
        for layer in range(jnu.shape[1]):
            pairs.append((_edges(jnu[s, layer], jdu[s, layer]),
                          _edges(st.nbru[layer].numpy(),
                                 st.degu[layer].numpy())))
        for layer, (ej, et) in enumerate(pairs):
            if ej or et:
                ov = len(ej & et) / len(ej | et)
                assert ov >= 0.99, (s, layer, ov)
    # the build's own answers: every row finds itself
    ids, _ = ti.knn_query(vecs, 1)
    assert (ids[:, 0] == np.concatenate([g for _, g in gids])).mean() > 0.95


@pytest.fixture(scope="module")
def carried(built):
    vecs, ji, _, _ = built
    return vecs, ji, installed(ji)


def _check_rows(metric, q, vecs, tids, tdists, jids, jdists):
    tids, jids = np.asarray(tids), np.asarray(jids)
    TTS.assert_same_ids(metric, q, vecs, tids, jids)
    same = tids == jids
    np.testing.assert_allclose(tdists[same], jdists[same], rtol=1e-5,
                               atol=1e-5)


def _check_filtered(metric, q, vecs, tids, jids, allowed):
    ju = TTS.first_unique(jids)
    width = min(ju.shape[1], tids.shape[1])
    filled = (ju >= 0).sum(axis=1)
    cols = np.arange(width)[None, :] < filled[:, None]
    head = np.where(cols, tids[:, :width], -1)
    TTS.assert_same_ids(metric, q, vecs, head, ju[:, :width])
    assert TTS.tail_rows(metric, q, vecs, tids, ju).all()
    got = tids[tids >= 0]
    assert allowed[got].all()
    for row in tids:
        row = row[row >= 0]
        assert len(set(row.tolist())) == row.size


PATHS = ["packed", "unpacked", "exact", "layer1", "ids", "mask",
         "callable"]


@pytest.mark.parametrize("path", PATHS)
def test_queries_match_reference(carried, path):
    vecs, ji, ti = carried
    q = queries(vecs)
    S, C = ji.n_shards, ji.shard_capacity
    mode = "on" if path == "packed" else "off"
    ji.params = dataclasses.replace(ji.params, pack_queries=mode,
                                    pack_min_count=0)
    ji._pack = None
    ti.params = dataclasses.replace(ti.params, pack_queries=mode,
                                    pack_min_count=0)
    ti._invalidate_caches()
    rng = np.random.default_rng(3)
    allowed = rng.random(S * C) < 0.5
    kw = {"exact": dict(exact=True), "layer1": dict(layer=1),
          "ids": dict(filter_fnc=np.flatnonzero(allowed)),
          "mask": dict(filter_fnc=allowed),
          "callable": dict(filter_fnc=lambda v: v[..., 0] > 0.5)}.get(
              path, {})
    jids, jd = ji.knn_query(q, K, **kw)
    tids, td = ti.knn_query(q, K, **kw)
    if path == "packed":
        assert ti._pack is not None and len(ti._pack) == S
    if path in ("ids", "mask"):
        _check_filtered("sq_euclid", q, vecs, tids, jids, allowed)
        return
    if path == "callable":
        assert (vecs_of(ti, tids)[..., 0] > 0.5)[tids >= 0].all()
    if path == "layer1":
        lv = np.concatenate([st.level.numpy() for st in ti._states])
        gl = lv.reshape(S, C).T.reshape(-1)           # level by gid
        assert (gl[tids[tids >= 0]] >= 1).all()
    _check_rows("sq_euclid", q, vecs_of(ti, None), tids, td, jids, jd)


def vecs_of(ti, ids):
    """The stored vectors by gid (all of them when ``ids`` is None)."""
    S, C = ti.n_shards, ti.shard_capacity
    allv = np.stack([st.vectors.numpy() for st in ti._states])
    flat = allv.transpose(1, 0, 2).reshape(S * C, -1)
    return flat if ids is None else flat[np.clip(ids, 0, None)]


def test_range_and_multi_layer_match_reference(carried):
    vecs, ji, ti = carried
    q = queries(vecs)[:20]
    d = ((q[:, None, :].astype(np.float64) - vecs[None]) ** 2).sum(-1)
    radius = float(np.median(np.sort(d, axis=1)[:, 8]))
    for kw in ({}, {"layer": 1}):
        jids, jd = ji.range_query(q, radius, **kw)
        tids, td = ti.range_query(q, radius, **kw)
        allv = vecs_of(ti, None)
        for r in range(q.shape[0]):
            dt = ((allv[tids[r]].astype(np.float64) - q[r]) ** 2).sum(-1)
            assert (dt <= radius * (1 + 1e-6)).all()
            assert (np.diff(td[r]) >= 0).all()
            np.testing.assert_allclose(td[r], dt, rtol=1e-5, atol=1e-6)
            # the id sets agree up to rows within float noise of the radius
            for g in set(jids[r].tolist()) ^ set(tids[r].tolist()):
                dg = ((allv[g].astype(np.float64) - q[r]) ** 2).sum()
                sg = (q[r].astype(np.float64) ** 2).sum() + \
                    (allv[g].astype(np.float64) ** 2).sum()
                assert abs(dg - radius) <= TTS.GAP * sg, (r, g)
    for r in range(4):
        jm = ji.multi_layer_knn_query(q[r], 4)
        tm = ti.multi_layer_knn_query(q[r], 4)
        assert len(jm) == len(tm)
        for a, b in zip(jm, tm):
            assert (a is None) == (b is None)
            if a is None:
                continue
            assert a[0].size == b[0].size
            TTS.assert_same_ids("sq_euclid", q[r:r + 1], vecs_of(ti, None),
                                b[0][None], a[0][None])


def test_refine_above_mirror_budget(carried, monkeypatch):
    vecs, _, ti = carried
    q = queries(vecs)
    ti.params = dataclasses.replace(ti.params, pack_queries="off")
    want_ids, want_d = ti.knn_query(q, K)
    want_ex, _ = ti.knn_query(q, K, exact=True)
    monkeypatch.setattr(refine, "MIRROR_MAX_BYTES", 0)
    ti._invalidate_caches()
    assert not ti._mirror.mirrorable()
    got_ids, got_d = ti.knn_query(q, K)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    got_ex, _ = ti.knn_query(q, K, exact=True)
    np.testing.assert_array_equal(got_ex, want_ex)
    rows = ti._mirror.rows(got_ids[:, 0])
    np.testing.assert_array_equal(rows, vecs_of(ti, got_ids[:, 0]))
    np.testing.assert_array_equal(ti.items(), vecs_of(ti, ti.ids()))


def _self_recall(ix, vecs, gids):
    ids, _ = ix.knn_query(vecs, 1)
    return float((ids[:, 0] == gids).mean())


def test_churn_matches_reference(built):
    vecs, ji0, _, gids = built
    ji = jax_clone(ji0)
    ti = installed(ji)
    all_g = np.concatenate([t for _, t in gids])
    S, C = ji.n_shards, ji.shard_capacity
    rng = np.random.default_rng(9)
    # skewed over the shards: "auto" resolves to "fast" on the whole batch
    # (120 of 1,500 rows) and would resolve to "high" on shard 0 alone
    rem = np.concatenate([rng.choice(all_g[all_g % S == s], m, replace=False)
                          for s, m in ((0, 100), (1, 20))])
    keep = np.flatnonzero(~np.isin(all_g, rem))
    pre_j = _self_recall(ji, vecs[keep], all_g[keep])
    pre_t = _self_recall(ti, vecs[keep], all_g[keep])
    junk = np.asarray([-5, S * C + 3])
    ji.remove(np.concatenate([rem, junk]))
    ti._rm_trace = []
    ti.remove(np.concatenate([rem, junk]))
    # one quality for every shard, resolved on the whole batch
    quality = TR.resolve_quality(ti.params.remove_quality, rem.size, N)
    assert quality == "fast"
    assert [t[:2] for t in ti._rm_trace] == [("shard", 0), ("shard", 1)]
    assert {t[3] for t in ti._rm_trace} == {quality}
    assert sum(t[2] for t in ti._rm_trace) == rem.size
    assert ti._free == ji._free
    np.testing.assert_array_equal(ti._counts, ji._counts)
    assert ti.count == ji.count == N - rem.size
    assert ti._upper_set == ji._upper_set
    np.testing.assert_array_equal(ti.ids(), ji.ids())
    post_j = _self_recall(ji, vecs[keep], all_g[keep])
    post_t = _self_recall(ti, vecs[keep], all_g[keep])
    assert abs(post_t / pre_t - post_j / pre_j) <= 0.01, \
        (pre_j, post_j, pre_t, post_t)
    back, _ = ti.knn_query(vecs[:200], 10)
    assert not np.isin(back, rem).any()
    fresh = (vecs[:40] + 0.01).astype(np.float32)
    np.testing.assert_array_equal(ti.add(fresh), ji.add(fresh))
    assert ti._free == ji._free
    upd = all_g[keep[:30]]
    moved = (vecs[keep[:30]] + 0.02).astype(np.float32)
    ji.update(upd, moved)
    ti.update(upd, moved)
    assert ti._free == ji._free
    np.testing.assert_array_equal(ti._counts, ji._counts)
    np.testing.assert_array_equal(ti.ids(), ji.ids())
    np.testing.assert_array_equal(vecs_of(ti, upd), moved)
    got, _ = ti.knn_query(moved, 1)
    want, _ = ji.knn_query(moved, 1)
    assert abs((got[:, 0] == upd).sum() - (want[:, 0] == upd).sum()) <= 1


def test_stats_match_reference(carried):
    _, ji, ti = carried
    ji_info, ti_info = ji.get_info(), ti.get_info()
    assert len(ji_info.layers) == len(ti_info.layers)
    for a, b in zip(ji_info.layers, ti_info.layers):
        assert dataclasses.asdict(a) == pytest.approx(dataclasses.asdict(b))
    jc = ji.get_connected_component_counts()
    tc = ti.get_connected_component_counts()
    assert jc == tc and tc[0] == ji.n_shards


def test_snapshots_cross_packages(carried, tmp_path):
    vecs, ji, ti = carried
    q = queries(vecs)
    for ix in (ji, ti):
        ix.params = dataclasses.replace(ix.params, pack_queries="off")
    ji.serialize(str(tmp_path / "ref"))
    ti.serialize(str(tmp_path / "port"))
    devs = ["cpu"] * ji.n_shards
    t_from_ref = TSH.ShardedIndex.deserialize(str(tmp_path / "ref"), devs)
    j_from_port = JSharded.deserialize(str(tmp_path / "port.npz"),
                                       devices=list(ji.mesh.devices))
    for a, b in ((t_from_ref, ji), (j_from_port, ti)):
        np.testing.assert_array_equal(a._lengths, b._lengths)
        np.testing.assert_array_equal(a._counts, b._counts)
        assert a._free == b._free and a._upper_set == b._upper_set
    want = ti.knn_query(q, K)
    got = t_from_ref.knn_query(q, K)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    jw, _ = ji.knn_query(q, K)
    jg, _ = j_from_port.knn_query(q, K)
    np.testing.assert_array_equal(jg, jw)
    # a file without the gid-scheme marker is refused
    with np.load(str(tmp_path / "port.npz")) as z:
        header = json.loads(bytes(z["header"]).decode())
        arrays = {f: z[f] for f in z.files if f != "header"}
    del header["gid_scheme"]
    np.savez(str(tmp_path / "legacy"),
             header=np.frombuffer(json.dumps(header).encode(), np.uint8),
             **arrays)
    with pytest.raises(ValueError, match="gid scheme"):
        TSH.ShardedIndex.deserialize(str(tmp_path / "legacy"), devs)
    with pytest.raises(RuntimeError, match="devices"):
        TSH.ShardedIndex.deserialize(str(tmp_path / "port"),
                                     devs[:ji.n_shards - 1])


def test_growth_keeps_every_gid():
    vecs = corpus()[:600]
    ti = TSH.ShardedIndex(DIM, parameters=T.HNSWParameters(
        **{**KW, "collection_size": 64}), devices=["cpu"] * 3)
    cap0 = ti.shard_capacity
    got = [ti.add(vecs[i:i + 100]) for i in range(0, 600, 100)]
    assert ti.shard_capacity > cap0
    gids = np.concatenate(got)
    np.testing.assert_array_equal(np.sort(gids), np.arange(600))
    np.testing.assert_array_equal(ti._mirror.rows(gids), vecs)
    np.testing.assert_array_equal(ti.ids(), np.arange(600))
    assert _self_recall(ti, vecs, gids) > 0.95


def test_devices_and_masks_are_checked():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSH.ShardedIndex(DIM)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.ShardedBlockIndex(DIM)
    ti = TSH.ShardedIndex(DIM, parameters=T.HNSWParameters(**KW),
                          devices=["cpu", "cpu"])
    ti.add(corpus()[:200])
    with pytest.raises(ValueError, match="bool filter mask"):
        ti.knn_query(corpus()[:2], 3, filter_fnc=np.ones(200, bool))
    with pytest.raises(ValueError, match="dim"):
        ti.add(np.zeros((2, DIM + 1), np.float32))


def test_custom_metric_exact_is_refused():
    name = "l1_sharded_test"
    T.register_metric(name, lambda a, b: torch.sum(torch.abs(a - b), dim=-1))
    vecs = corpus()[:300]
    ti = TSH.ShardedIndex(DIM, name, T.HNSWParameters(**KW),
                          devices=["cpu", "cpu"])
    ti.add(vecs)
    assert ti.wave_counts["exact"] == 0 and ti.wave_counts["beam"] > 0
    with pytest.raises(ValueError, match="exact=True"):
        ti.knn_query(vecs[:4], 3, exact=True)
    with pytest.raises(ValueError, match="exact=True"):
        ti.knn_query(vecs[:4], 3, exact=True,
                     filter_fnc=lambda v: v[..., 0] > 0.5)
    ids, _ = ti.knn_query(vecs[:50], 3, filter_fnc=lambda v: v[..., 0] > 0.5)
    assert (vecs_of(ti, ids)[..., 0] > 0.5)[ids >= 0].all()
    ids, _ = ti.knn_query(vecs, 1)
    assert (ids[:, 0] == np.arange(300)).mean() > 0.9
