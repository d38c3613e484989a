"""Unpacked graph search parity: a graph built by hnswindex_tpu is loaded
into the port with convert.state_from_numpy, and the same queries (numpy,
seeded) go through both packages' greedy_descent, beam_search, knn_search
and range_search.

Bars: greedy descent gives the same entries.  Beam and k-NN pools give the
same ids wherever the float64 distance gap exceeds 1e-5 relative: at a
position where the ids differ, the two ids' float64 distances differ by at
most 1e-5 of the distance's scale (a swap of near-tied neighbours; a walk
that went elsewhere fails).  Both packages rank in float32 by the dot
decomposition ||q||^2 + ||x||^2 - 2 q.x, whose rounding error scales with
||q||^2 + ||x||^2 (~80 on the sq_euclid corpus, where distances are ~0.2:
swapped pairs there measured float64 gaps up to 4.0e-5), so that sum is the
scale for sq_euclid and 1 for cosine.  Range search gives the same id sets
up to ids within that gap of the radius, and the same ``saturated`` flags,
including at a pool small enough to saturate.  Where ids agree, the
float32 distances agree within rtol 1e-5 and atol 1e-4 (measured up to
3.8e-5 on the sq_euclid corpus, for the same reason)."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnswindex_torch as T
import test_torch_construct as TCT
import test_torch_pack as TTP
from hnswindex_torch import convert
from hnswindex_torch.core import graph as TG
from hnswindex_torch.core import search as TS
from hnswindex_torch.ops import distance as tdst
from hnswindex_tpu.core import search as JS
from hnswindex_tpu.ops import distance as jdst

torch.set_num_threads(1)

NQ = 64
EF = 16
GAP = 1e-5


@pytest.fixture(scope="module", params=["sq_euclid", "cosine"])
def loaded(request):
    """sq_euclid: the 2,000 x 128 graph of test_torch_construct; cosine:
    test_torch_pack's 600 x 32 graph.  Queries are perturbed corpus rows."""
    metric = request.param
    if metric == "sq_euclid":
        vecs, ji = TCT.corpus(), TCT.jax_build()._impl
    else:
        vecs, ji = TTP.cosine_build()
    leaves = {f: np.asarray(getattr(ji._state, f)) for f in convert.FIELDS}
    tcfg = TG.GraphConfig(**dataclasses.asdict(ji._cfg))
    tstate = convert.state_from_numpy(leaves, tcfg, "cpu")
    rng = np.random.default_rng(11)
    q = (vecs[:NQ] + 0.02 * rng.standard_normal(
        (NQ, vecs.shape[1]))).astype(np.float32)
    return metric, vecs, ji, tcfg, tstate, q


def installed(ji, **overrides):
    """A port ``HNSWIndex`` (CPU) holding the reference index ``ji``'s
    graph, loaded through convert, with a copy of ``ji``'s parameters
    (``overrides`` applied to the copy) and of its host state: counts,
    free list, scan mark, level RNG and upper-node panel."""
    tp = T.HNSWParameters(**{**dataclasses.asdict(ji.params), **overrides})
    ti = T.HNSWIndex(ji.dim, ji.metric, tp, device="cpu")
    assert dataclasses.asdict(ti._cfg) == dataclasses.asdict(ji._cfg)
    leaves = {f: np.asarray(getattr(ji._state, f)) for f in convert.FIELDS}
    ti._state = convert.state_from_numpy(leaves, ti._cfg, "cpu")
    ti._count_host, ti._length = ji._count_host, ji._length
    ti._free, ti._scan_hwm = list(ji._free), ji._scan_hwm
    ti._rng = copy.deepcopy(ji._rng)
    if ji._upper_ids is not None:
        ti._upper_np = np.array(ji._upper_ids, dtype=np.int32)
        ti._upper_pos = dict(ji._upper_pos)
        ti._upper_cnt, ti._upper_holes = ji._upper_cnt, ji._upper_holes
        ti._panel_push()
    return ti


def d64(metric, q, vecs, ids):
    """Float64 distances of each query to its ids (inf where id < 0)."""
    v = vecs.astype(np.float64)[np.clip(ids, 0, None)]
    qq = q.astype(np.float64)[:, None, :]
    if metric == "sq_euclid":
        d = ((v - qq) ** 2).sum(-1)
    else:
        d = 1.0 - (v * qq).sum(-1) / (np.linalg.norm(v, axis=-1)
                                      * np.linalg.norm(qq, axis=-1))
    return np.where(ids >= 0, d, np.inf)


def noise_scale(metric, q, vecs, ids):
    """The float32 ranking's error scale of each (query, id) distance:
    ||q||^2 + ||x||^2 for sq_euclid, 1 for cosine (module docstring)."""
    if metric != "sq_euclid":
        return np.ones(ids.shape)
    v = vecs.astype(np.float64)[np.clip(ids, 0, None)]
    qq = q.astype(np.float64)
    return (qq * qq).sum(-1)[:, None] + (v * v).sum(-1)


def near_tie_rows(metric, q, vecs, tids, jids):
    """Per row: True where the two pools differ only at positions whose
    ids' float64 distances are within GAP of the noise scale."""
    tids, jids = np.asarray(tids), np.asarray(jids)
    dt = d64(metric, q, vecs, tids)
    dj = d64(metric, q, vecs, jids)
    scale = np.maximum(noise_scale(metric, q, vecs, tids),
                       noise_scale(metric, q, vecs, jids))
    ok = (tids == jids) | (np.isfinite(dt) & np.isfinite(dj)
                          & (np.abs(dt - dj) <= GAP * scale))
    return ok.all(axis=1)


def first_unique(ids):
    """Each row's ids with repeats dropped (first occurrence kept), -1
    padded to the same width.  The reference's filtered result pools can
    list an id twice (a node evicted from the walk's pool and met again is
    added again); the port's never do, and the reference's pool without
    its repeats is a prefix of the port's."""
    ids = np.asarray(ids)
    out = np.full_like(ids, -1)
    for r, row in enumerate(ids):
        seen = list(dict.fromkeys(int(x) for x in row if x >= 0))
        out[r, :len(seen)] = seen
    return out


def tail_rows(metric, q, vecs, tids, ju):
    """Per row: True where the port's ids past the positions that the
    reference's pool without repeats ``ju`` (``first_unique``) fills lie
    at or beyond that pool's last float64 distance, less GAP of the noise
    scale.  This holds the part of the port's filtered pool that the
    reference has no counterpart for."""
    tids, ju = np.asarray(tids), np.asarray(ju)
    filled = (ju >= 0).sum(axis=1)
    last = np.where(ju >= 0, d64(metric, q, vecs, ju), -np.inf).max(axis=1)
    tail = np.arange(tids.shape[1])[None, :] >= filled[:, None]
    dt = d64(metric, q, vecs, tids)
    scale = noise_scale(metric, q, vecs, tids)
    ok = ~tail | (tids < 0) | (dt >= last[:, None] - GAP * scale)
    return ok.all(axis=1)


def assert_same_ids(metric, q, vecs, tids, jids):
    """Ids equal wherever the float64 gap exceeds GAP of the noise scale
    (module docstring), in every row."""
    rows = near_tie_rows(metric, q, vecs, tids, jids)
    assert rows.all(), np.flatnonzero(~rows)


def _both(loaded):
    metric, vecs, ji, tcfg, tstate, q = loaded
    tq, jq = torch.from_numpy(q), jnp.asarray(q)
    return (tq, tdst.norm_data(metric, tq), jq, jdst.norm_data(metric, jq))


def _entries(loaded):
    """Layer-0 entries (the reference's descent from the entry point)."""
    metric, vecs, ji, tcfg, tstate, q = loaded
    _, _, jq, jqn = _both(loaded)
    ep = int(np.asarray(ji._state.ep))
    top = int(np.asarray(ji._state.level)[ep])
    entry, _ = JS.greedy_descent(
        ji._cfg, ji._state, jq, jqn, jnp.full((NQ,), ep, jnp.int32),
        jnp.full((NQ,), top, jnp.int32), jnp.zeros((NQ,), jnp.int32))
    return np.array(entry)


def test_greedy_descent_same_entries(loaded):
    """Per-query stop layers: half the queries stop at layer 1."""
    metric, vecs, ji, tcfg, tstate, q = loaded
    tq, tqn, jq, jqn = _both(loaded)
    ep = int(np.asarray(ji._state.ep))
    top = int(np.asarray(ji._state.level)[ep])
    assert top >= 1
    stop = (np.arange(NQ) % 2).astype(np.int32)
    je, jd = JS.greedy_descent(
        ji._cfg, ji._state, jq, jqn, jnp.full((NQ,), ep, jnp.int32),
        jnp.full((NQ,), top, jnp.int32), jnp.asarray(stop))
    te, td = TS.greedy_descent(
        tcfg, tstate, tq, tqn, torch.full((NQ,), ep),
        torch.full((NQ,), top), torch.from_numpy(stop))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    lvl = tstate.level.numpy()
    assert (lvl[te.numpy()] >= stop).all()


@pytest.mark.parametrize("expand", [1, 4])
def test_beam_search_matches_reference(loaded, expand):
    metric, vecs, ji, tcfg, tstate, q = loaded
    tq, tqn, jq, jqn = _both(loaded)
    entry = _entries(loaded)
    ok = np.ones(NQ, bool)
    ok[-1] = False                      # a query without an entry
    max_iters = (8 * EF) // expand + 16
    jd, jids = JS.beam_search(ji._cfg, ji._state, jq, jqn,
                              jnp.asarray(entry), jnp.asarray(ok), 0, EF,
                              max_iters, expand=expand)
    td, tids = TS.beam_search(tcfg, tstate, tq, tqn,
                              torch.from_numpy(entry), torch.from_numpy(ok),
                              0, EF, max_iters, expand=expand)
    assert (tids.numpy()[-1] == -1).all()
    assert_same_ids(metric, q, vecs, tids.numpy(), np.asarray(jids))
    same = tids.numpy() == np.asarray(jids)
    np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same],
                               rtol=1e-5, atol=1e-4)


def test_filtered_beam_search_matches_reference(loaded):
    """A fixed mask (every third id allowed): the result pool holds allowed
    ids only, each once, and its prefix equals the reference's pool
    without its repeated ids (``first_unique``) up to near-tie swaps, with
    the rest of the pool at or beyond that prefix's last distance
    (``tail_rows``), in all but two of the 64 rows.  The result pool collects every allowed
    node the walk visits, so a near-tie swap at the main pool's boundary
    that sends one walk elsewhere changes that row's result pool
    (measured: 1 row)."""
    metric, vecs, ji, tcfg, tstate, q = loaded
    tq, tqn, jq, jqn = _both(loaded)
    entry = _entries(loaded)
    C = tstate.capacity
    mask = np.arange(C) % 3 == 0
    ok = np.ones(NQ, bool)
    _, jids = JS.beam_search(ji._cfg, ji._state, jq, jqn, jnp.asarray(entry),
                             jnp.asarray(ok), 0, EF, 8 * EF + 16,
                             filtered=True, filter_mask=jnp.asarray(mask))
    _, tids = TS.beam_search(tcfg, tstate, tq, tqn, torch.from_numpy(entry),
                             torch.from_numpy(ok), 0, EF, 8 * EF + 16,
                             filtered=True,
                             filter_mask=torch.from_numpy(mask))
    tids = tids.numpy()
    assert mask[tids[tids >= 0]].all() and (tids >= 0).any()
    np.testing.assert_array_equal(first_unique(tids), tids)
    ju = first_unique(jids)
    rows = near_tie_rows(metric, q, vecs, np.where(ju >= 0, tids, -1), ju)
    assert (~(rows & tail_rows(metric, q, vecs, tids, ju))).sum() <= 2


@pytest.mark.parametrize("layer,expand", [(0, 4), (1, 1)])
def test_knn_search_matches_reference(loaded, layer, expand):
    metric, vecs, ji, tcfg, tstate, q = loaded
    max_iters = (8 * EF) // expand + 16
    _, jids = JS.knn_search(ji._cfg, ji._state, jnp.asarray(q), layer, EF,
                            max_iters, expand=expand)
    _, tids = TS.knn_search(tcfg, tstate, torch.from_numpy(q), layer, EF,
                            max_iters, expand=expand)
    tids = tids.numpy()
    assert_same_ids(metric, q, vecs, tids, np.asarray(jids))
    if layer:
        lvl = tstate.level.numpy()
        assert (lvl[tids[tids >= 0]] >= layer).all()


@pytest.mark.parametrize("seeds,pool", [("single", 64), ("multi", 64),
                                        ("single", 8)])
def test_range_search_matches_reference(loaded, seeds, pool):
    """Radius: the median float64 distance of each query's 10th neighbour.
    Multi-seeds are the port's own k-NN pool at ef=16, given to both."""
    metric, vecs, ji, tcfg, tstate, q = loaded
    tq, tqn, jq, jqn = _both(loaded)
    allq = d64(metric, q, vecs, np.broadcast_to(np.arange(len(vecs)),
                                                (NQ, len(vecs))))
    radius = float(np.float32(np.median(np.sort(allq, axis=1)[:, 9])))
    if seeds == "single":
        ep = _entries(loaded)
    else:
        _, s = TS.knn_search(tcfg, tstate, tq, 0, 16, 8 * 16 + 16)
        ep = s.numpy().astype(np.int32)
    ok = np.ones(ep.shape, bool)
    max_iters = pool * 4 + 16
    _, jids, jsat = JS.range_search(ji._cfg, ji._state, jq, jqn,
                                    jnp.asarray(ep), jnp.asarray(ok), 0,
                                    jnp.float32(radius), pool, max_iters)
    _, tids, tsat = TS.range_search(tcfg, tstate, tq, tqn,
                                    torch.from_numpy(ep),
                                    torch.from_numpy(ok), 0, radius, pool,
                                    max_iters)
    jids, tids = np.asarray(jids), tids.numpy()
    np.testing.assert_array_equal(tsat.numpy(), np.asarray(jsat))
    if pool == 8:
        assert tsat.numpy().any() and not tsat.numpy().all()
    for r in range(NQ):
        a, b = set(tids[r][tids[r] >= 0]), set(jids[r][jids[r] >= 0])
        odd = np.asarray(sorted(a ^ b), np.int64)
        if odd.size:
            dd = d64(metric, q[r:r + 1], vecs, odd[None])[0]
            scale = noise_scale(metric, q[r:r + 1], vecs, odd[None])[0]
            assert (np.abs(dd - radius) <= GAP * scale).all()
        got = tids[r][tids[r] >= 0][None]
        assert (d64(metric, q[r:r + 1], vecs, got)
                <= radius + GAP * noise_scale(metric, q[r:r + 1], vecs,
                                              got)).all()
