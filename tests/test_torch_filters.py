"""Filter parity: mask and callable filters on every query path of
hnswindex_torch against hnswindex_tpu's, on the reference's 2,000 x 128
build (test_torch_construct) installed into the port.

An id list and the (C,) bool mask of the same ids give the port identical
answers; the mask goes through both packages on the packed, unpacked,
``layer=1``, ``exact=True`` and range paths.  Bars (test_torch_search's
float64 near-tie rule): every returned id is allowed and appears once; the
ids equal the reference's up to near-tie swaps.  The reference's graph
paths can return an id twice (its filtered result pool adds again a node
that the walk's pool evicted and met again); the port's never do, so its
rows are held against the reference's rows without their repeats
(``first_unique``) on the positions those fill, and the port's ids past
them are allowed and lie at or beyond the last of them
(``test_torch_search.tail_rows``).  Range results: the same id
sets up to ids within the near-tie gap of the radius.

Callable filters: every returned id passes, and the ids equal the
reference's up to near-tie swaps; a predicate that passes 8 rows gets its
exact top-8 through the exact escalation (the reference's
test_filters_and_range.py:198 case, held to its known answer).
``BatchedPredicate`` takes the vectorized path only for a predicate that
acts row-wise on a matrix; ``knn_query_results`` gives the records of
``knn_query``'s first row."""

import numpy as np
import pytest
import torch

import hnswindex_torch as T
import test_torch_construct as TCT
import test_torch_search as TTS
from hnswindex_torch.utils.predicates import BatchedPredicate

torch.set_num_threads(1)

NQ = 40
K = 10


@pytest.fixture(scope="module")
def setup():
    """The reference index, the port holding its graph, queries (perturbed
    corpus rows) and a seeded 50% mask."""
    ji = TCT.jax_build()._impl
    vecs = TCT.corpus()
    rng = np.random.default_rng(21)
    q = (vecs[:NQ] + 0.02 * rng.standard_normal((NQ, TCT.DIM))).astype(
        np.float32)
    mask = np.zeros(ji._state.capacity, bool)
    mask[:TCT.N] = rng.random(TCT.N) < 0.5
    return ji, vecs, q, mask


def _check_rows(tids, jids, q, vecs, mask):
    tids, jids = np.asarray(tids), np.asarray(jids)
    assert mask[tids[tids >= 0]].all() and (tids >= 0).all()
    np.testing.assert_array_equal(TTS.first_unique(tids), tids)
    ju = TTS.first_unique(jids)
    assert TTS.near_tie_rows("sq_euclid", q, vecs,
                             np.where(ju >= 0, tids, -1), ju).all()
    assert TTS.tail_rows("sq_euclid", q, vecs, tids, ju).all()


@pytest.mark.parametrize("path", ["packed", "unpacked", "layer1", "exact"])
def test_mask_filter_matches_reference(setup, monkeypatch, path):
    ji, vecs, q, mask = setup
    over = {"unpacked": dict(pack_queries="off"),
            "layer1": dict(pack_queries="off")}.get(path, {})
    ti = TTS.installed(ji, **over)
    for name, value in over.items():
        monkeypatch.setattr(ji.params, name, value)
    monkeypatch.setattr(ji, "_pack", None)
    kw = dict(layer=1) if path == "layer1" else \
        dict(exact=True) if path == "exact" else {}
    tids, td = ti.knn_query(q, K, filter_fnc=mask, **kw)
    lids, ld = ti.knn_query(q, K, filter_fnc=np.flatnonzero(mask), **kw)
    np.testing.assert_array_equal(tids, lids)
    np.testing.assert_array_equal(td, ld)
    assert (np.diff(td, axis=1) >= 0).all()
    jids, _ = ji.knn_query(q, K, filter_fnc=mask, **kw)
    _check_rows(tids, jids, q, vecs, mask)
    assert (ti._pack is not None) == (path == "packed")


def test_range_mask_filter_matches_reference(setup):
    """Radius: the median float64 distance of the 10th neighbour."""
    ji, vecs, q, mask = setup
    ti = TTS.installed(ji)
    d = TTS.d64("sq_euclid", q, vecs,
                np.broadcast_to(np.arange(len(vecs)), (NQ, len(vecs))))
    radius = float(np.float32(np.median(np.sort(d, axis=1)[:, 9])))
    tids, tds = ti.range_query(q, radius, filter_fnc=mask)
    lids, _ = ti.range_query(q, radius, filter_fnc=np.flatnonzero(mask))
    jids, _ = ji.range_query(q, radius, filter_fnc=mask)
    for r in range(NQ):
        np.testing.assert_array_equal(tids[r], lids[r])
        assert mask[tids[r]].all() and (tds[r] <= radius).all()
        assert (np.diff(tds[r]) >= 0).all()
        odd = np.asarray(sorted(set(tids[r]) ^ set(jids[r])), np.int64)
        if odd.size:
            dd = TTS.d64("sq_euclid", q[r:r + 1], vecs, odd[None])
            sc = TTS.noise_scale("sq_euclid", q[r:r + 1], vecs, odd[None])
            assert (np.abs(dd - radius) <= TTS.GAP * sc).all()
    assert sum(x.size for x in tids) > NQ


def test_callable_filter_matches_reference(setup):
    """Column 0 above its median, written to act row-wise on a matrix too
    (the vectorized path)."""
    ji, vecs, q, _ = setup
    ti = TTS.installed(ji)
    med = float(np.median(vecs[:, 0]))
    pred = BatchedPredicate(lambda v: np.asarray(v)[..., 0] > med)
    tids, td = ti.knn_query(q, K, filter_fnc=pred)
    jids, _ = ji.knn_query(q, K, filter_fnc=lambda v: v[0] > med)
    assert (tids >= 0).all() and (vecs[tids][..., 0] > med).all()
    assert (np.diff(td, axis=1) >= 0).all()
    assert TTS.near_tie_rows("sq_euclid", q, vecs, tids, jids).all()
    assert pred._vectorized and pred.calls < 200


def test_callable_exact_escape_fills_k():
    """Eight passing rows in 512: the widening beams saturate short of k,
    and the one exact scan finds all eight."""
    rng = np.random.default_rng(89)
    n, dim = 512, 24
    vecs = rng.random((n, dim), dtype=np.float32)
    ix = T.HNSWIndex(dim, parameters=T.HNSWParameters(collection_size=n),
                     device="cpu")
    ids = ix.add(vecs)
    chosen = set(ids[::64].tolist())

    def pred(v):
        row = np.asarray(v)
        d = np.abs(vecs[sorted(chosen)] - row[..., None, :]).sum(-1)
        return (d < 1e-9).any(-1)

    rid, _ = ix.knn_query(vecs[:4], k=8, filter_fnc=pred)
    for r in range(4):
        assert set(rid[r][rid[r] >= 0].tolist()) == chosen


def test_callable_range_and_exact_mode(setup):
    """range_query keeps the unfiltered answer's passing rows;
    ``exact=True`` with a callable gives the exact filtered top-k."""
    ji, vecs, q, _ = setup
    ti = TTS.installed(ji)
    pred = lambda v: v[1] > 0.5              # noqa: E731  (row-wise only)
    allr, alld = ti.range_query(q[:8], 0.3)
    got, gotd = ti.range_query(q[:8], 0.3, filter_fnc=pred)
    for r in range(8):
        keep = vecs[allr[r]][:, 1] > 0.5
        np.testing.assert_array_equal(got[r], allr[r][keep])
        np.testing.assert_array_equal(gotd[r], alld[r][keep])
    eids, _ = ti.knn_query(q, K, filter_fnc=pred, exact=True)
    want = np.argsort(TTS.d64("sq_euclid", q, vecs, np.where(
        vecs[:, 1] > 0.5, np.arange(TCT.N), -1)[None].repeat(NQ, 0)),
        axis=1, kind="stable")[:, :K]
    assert TTS.near_tie_rows("sq_euclid", q, vecs, eids, want).all()


def test_batched_predicate_paths():
    rows = np.random.default_rng(3).random((200, 8), dtype=np.float32)
    truth = rows[:, 0] > 0.5
    vec = BatchedPredicate(lambda v: np.asarray(v)[..., 0] > 0.5)
    np.testing.assert_array_equal(vec(rows), truth)
    np.testing.assert_array_equal(vec(rows[:50]), truth[:50])
    assert vec._vectorized and vec.calls == 64 + 1 + 1 + 1
    # on a matrix, v[0] is the first row: the probe catches it
    row = BatchedPredicate(lambda v: v[0] > 0.5)
    np.testing.assert_array_equal(row(rows), truth)
    assert row._vectorized is False and row.calls == 64 + 1 + 136
    assert row(rows[:0]).shape == (0,)


def test_knn_query_results(setup):
    """Records of knn_query's first row: id, distance, stored vector."""
    ji, vecs, q, mask = setup
    ti = TTS.installed(ji)
    recs = ti.knn_query_results(q[0], 5, filter_fnc=mask)
    ids, d = ti.knn_query(q[:1], 5, filter_fnc=mask)
    assert [r.id for r in recs] == ids[0].tolist()
    np.testing.assert_array_equal([r.distance for r in recs], d[0])
    for r in recs:
        np.testing.assert_array_equal(r.label, vecs[r.id])
