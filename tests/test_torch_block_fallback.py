"""The facade's at-scale block fallback, forced at small scale (analogs of
the reference's tests/test_large_corpus_paths.py block-fallback tests).

The pack budget is shrunk to zero, so plain layer-0 ``knn_query`` must be
served from the device-built block tables (bf16 tiles off the coarse
table, or int8 tiles when the assumed device memory is too small) instead
of the unpacked beam.  Bars: self-recall@1 > 0.85 (the reference's own
bar), distances ascending, a mutation drops the tables,
``block_fallback="off"`` serves through the unpacked beam as the reference
does.  The tables' parity with the reference's is in
tests/test_torch_block.py."""

import numpy as np
import pytest
import torch

import hnswindex_torch as T
from hnswindex_torch.ops import block_scores as TBS

torch.set_num_threads(1)

N, DIM = 2000, 24


def _params(**kw):
    return T.HNSWParameters(collection_size=N, pack_queries="on",
                            pack_max_bytes=0, pack_min_count=0, **kw)


@pytest.fixture(scope="module")
def built():
    vecs = np.random.default_rng(4242).random((N, DIM), dtype=np.float32)
    ix = T.HNSWIndex(DIM, parameters=_params(), device="cpu")
    return ix, ix.add(vecs), vecs


def _check(ix, ids, vecs):
    rid, rd = ix.knn_query(vecs, k=1)
    assert rid.dtype == np.int32 and rd.dtype == np.float32
    assert float((rid[:, 0] == ids).mean()) > 0.85
    r5, d5 = ix.knn_query(vecs[:200], k=5)
    assert np.all(np.diff(np.nan_to_num(d5, nan=np.inf), axis=1) >= -1e-6)
    direct = ((vecs[r5].astype(np.float64)
               - vecs[:200, None, :].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(d5, direct, rtol=1e-5, atol=1e-6)


def test_block_fallback_engages_when_pack_cannot_fit(built, monkeypatch):
    monkeypatch.delenv("HNSW_HBM_BYTES", raising=False)
    ix, ids, vecs = built
    ix._invalidate_caches()
    assert ix._get_pack() is None and ix._pack_refusal == "budget"
    n0 = TBS.block_scores.launches
    _check(ix, ids, vecs)
    fb = ix._block_fb
    assert fb is not None, "block fallback did not engage"
    # tiles come off the bf16 coarse table; a CPU index never quantizes
    assert fb.blk_vecs.dtype == torch.bfloat16
    assert int(fb.blk_fill.sum()) == N
    assert TBS.block_scores.launches == n0        # CPU: no kernel launch


def test_block_fallback_int8_tiles(built, monkeypatch):
    """Forced by shrinking the assumed device memory."""
    monkeypatch.setenv("HNSW_HBM_BYTES", "1")
    ix, ids, vecs = built
    ix._invalidate_caches()
    _check(ix, ids, vecs)
    assert ix._block_fb.blk_vecs.dtype == torch.int8
    ix._invalidate_caches()


def test_block_fallback_unmirrored_refine(built, monkeypatch):
    """Past the host-mirror budget the panel is refined on the device."""
    from hnswindex_torch.utils import refine
    monkeypatch.delenv("HNSW_HBM_BYTES", raising=False)
    ix, ids, vecs = built
    base = ix.knn_query(vecs[:64], k=3)
    monkeypatch.setattr(refine, "MIRROR_MAX_BYTES", 0)
    assert not ix._mirror.mirrorable()
    got = ix.knn_query(vecs[:64], k=3)
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_allclose(got[1], base[1], rtol=1e-4, atol=1e-5)


def test_block_fallback_invalidated_by_add(monkeypatch):
    monkeypatch.delenv("HNSW_HBM_BYTES", raising=False)
    vecs = np.random.default_rng(4245).random((900, 16), dtype=np.float32)
    ix = T.HNSWIndex(16, parameters=_params(), device="cpu")
    ids = ix.add(vecs[:600])
    ix.knn_query(vecs[:10], k=1)
    assert ix._block_fb is not None
    more = ix.add(vecs[600:])
    assert ix._block_fb is None                    # dropped with the pack
    rid, _ = ix.knn_query(vecs[600:], k=1)
    assert ix._block_fb is not None
    assert int(ix._block_fb.blk_fill.sum()) == 900
    assert float((rid[:, 0] == more).mean()) > 0.85


@pytest.mark.parametrize("why", ["off", "below_pack_min_count"])
def test_block_fallback_off_keeps_its_error(why, monkeypatch):
    """With block_fallback="off", or below pack_min_count, a pack refused
    for its budget no longer raises: knn_query serves through the unpacked
    beam and builds no block tables.  Held on the reference's 2,000 x 128
    graph (test_torch_construct) against the reference with the same
    parameters: the same ids up to near-tie swaps (test_torch_search's
    bar)."""
    import test_torch_construct as TCT
    import test_torch_search as TTS
    ji = TCT.jax_build()._impl
    over = dict(pack_queries="on", pack_max_bytes=0, pack_min_count=0)
    if why == "off":
        over["block_fallback"] = "off"
    else:
        over["pack_min_count"] = 32768
    ix = TTS.installed(ji, **over)
    for name, value in over.items():
        monkeypatch.setattr(ji.params, name, value)
    monkeypatch.setattr(ji, "_pack", None)
    monkeypatch.setattr(ji, "_block_fb", None)
    vecs = TCT.corpus()
    q = vecs[:64]
    rid, rd = ix.knn_query(q, k=5)
    jid, _ = ji.knn_query(q, k=5)
    assert ix._block_fb is None and ji._block_fb is None
    assert ix._pack_refusal == "budget"
    assert TTS.near_tie_rows("sq_euclid", q, vecs, rid, jid).all()
    assert (rid[:, 0] == np.arange(64)).mean() > 0.85
    assert np.all(np.diff(rd, axis=1) >= 0)


# -- at the published width of gist-960-euclidean ---------------------------

GIST_DIM, GIST_N, GIST_Q = 960, 3000, 32
#: the five regions of the fallback path
FALLBACK_REGIONS = ("block_tables", "block_query", "block_route",
                    "block_score", "block_refine")


@pytest.fixture(scope="module")
def gist_built():
    """3,000 clustered rows at D=960 (500 a cluster, noise 0.03, as the
    gist1m-960 configuration makes them) and 32 held-out queries."""
    from torch_cases import clustered
    rng = np.random.default_rng(960)
    rows = clustered(GIST_N + GIST_Q, GIST_DIM, GIST_N // 500, rng,
                     spread=0.03)
    vecs, q = rows[:GIST_N], rows[GIST_N:]
    ix = T.HNSWIndex(GIST_DIM, parameters=T.HNSWParameters(
        collection_size=GIST_N, pack_max_bytes=0, pack_min_count=0),
        device="cpu")
    return ix, ix.add(vecs), vecs, q


def test_block_fallback_at_gist_width_matches_the_plain_reference(
        gist_built, monkeypatch):
    """Past the pack and host-mirror budgets, as a 1M x 960 index is on one
    card: the ids against the benchmark's plain exact search at a recall
    bar, every distance against its float64 direct formula to 1e-5
    relative (the float32 refine on the device)."""
    from hnswbench import reference
    from hnswindex_torch.utils import refine
    monkeypatch.delenv("HNSW_HBM_BYTES", raising=False)
    monkeypatch.setattr(refine, "MIRROR_MAX_BYTES", 0)
    called = []
    on_device = refine.refine_on_device
    monkeypatch.setattr(refine, "refine_on_device",
                        lambda *a: called.append(1) or on_device(*a))
    ix, ids, vecs, q = gist_built
    ix._invalidate_caches()
    got, gd = ix.knn_query(q, k=10)
    assert ix._pack_refusal == "budget"
    assert ix._block_fb.blk_vecs.dtype == torch.bfloat16 and called
    row_of = np.empty(GIST_N, np.int64)
    row_of[ids] = np.arange(GIST_N)
    base, qt = torch.from_numpy(vecs), torch.from_numpy(q)
    truth, _ = reference.topk("sq_euclid", base, qt, 10)
    rows = row_of[got]
    hits = sum(np.intersect1d(a, b).size
               for a, b in zip(rows, truth.numpy()))
    assert hits / got.size >= 0.95, hits / got.size
    want = reference.direct("sq_euclid", qt, base[torch.from_numpy(rows)])
    np.testing.assert_allclose(gd, want.numpy(), rtol=1e-5)
    assert np.all(np.diff(gd, axis=1) >= 0)


@pytest.mark.parametrize("path", ["fallback", "packed"])
def test_block_fallback_regions(gist_built, monkeypatch, path):
    """The fallback's five regions appear in the index's timer after a
    fallback query, and none after a packed one."""
    from hnswindex_torch.utils.profiling import PhaseTimer
    monkeypatch.delenv("HNSW_HBM_BYTES", raising=False)
    ix, _, _, q = gist_built
    if path == "packed":
        monkeypatch.setattr(ix.params, "pack_max_bytes", 1 << 40)
    ix._invalidate_caches()
    monkeypatch.setattr(ix, "timer", PhaseTimer("cpu"))
    ix.knn_query(q[:8], k=10)
    got = ix.timer.seconds()
    if path == "fallback":
        assert set(FALLBACK_REGIONS) <= set(got)
        assert got["block_query"] >= got["block_route"] + got["block_score"]
    else:
        assert "pack" in got
        assert not set(FALLBACK_REGIONS) & set(got)
    ix._invalidate_caches()
