"""Graph tables and result refinement against hnswindex_tpu.

Bars: after seeding the first node and after capacity growth every state
table equals the reference's bit for bit (bfloat16 mirrors compared as
bits).  ``refine_pairs`` (float64 on the host) returns the reference's ids
and its float32 distances exactly; ``refine_on_device`` (direct float32)
returns the same ids and distances at rtol 1e-5.  A facade build that
outgrows its collection size doubles its capacity as the reference does
and keeps the row invariants and self-recall > 0.85."""

import dataclasses

import numpy as np
import pytest
import torch

import hnswindex_torch as T
import test_torch_construct as TCT
from hnswindex_torch import convert
from hnswindex_torch.core import graph as TG
from hnswindex_torch.utils import refine as TR
from hnswindex_tpu.core import graph as JG
from hnswindex_tpu.utils import refine as JR

torch.set_num_threads(1)

METRICS = ["sq_euclid", "cosine", "ucosine"]


def _assert_state_equal(jstate, tstate):
    got = convert.state_to_numpy(tstate)
    for f in convert.FIELDS:
        want = np.asarray(getattr(jstate, f))
        assert got[f].dtype == want.dtype, f
        assert got[f].shape == want.shape, f
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got[f].view(np.int16),
                                          want.view(np.int16), err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)


@pytest.mark.parametrize("rank_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_tables_match_after_seed_and_growth(metric, rank_dtype):
    jcfg = JG.GraphConfig(dim=16, metric=metric, max_edges=4, max_levels=4,
                          rank_dtype=rank_dtype, slack0=2)
    tcfg = TG.GraphConfig(**dataclasses.asdict(jcfg))
    v = np.random.default_rng(5).standard_normal(16).astype(np.float32)
    js = JG.seed_first_node(jcfg, JG.empty_state(jcfg, 64), 5, v, 2)
    ts = TG.empty_state(tcfg, 64, "cpu")
    TG.seed_first_node(tcfg, ts, 5, v, 2)
    _assert_state_equal(js, ts)
    _assert_state_equal(JG.grow_state(js, 256), TG.grow_state(ts, 256))


@pytest.mark.parametrize("k", [5, 15])
@pytest.mark.parametrize("metric", METRICS)
def test_refine_matches_reference(metric, k):
    rng = np.random.default_rng(11)
    C, D, B, W = 200, 32, 8, 12
    vectors = rng.standard_normal((C, D)).astype(np.float32)
    vectors[3] = 0.0                       # cosine's zero-norm guard
    if metric == "ucosine":
        vectors /= np.maximum(np.linalg.norm(vectors, axis=1,
                                             keepdims=True), 1e-30)
    q = rng.standard_normal((B, D)).astype(np.float32)
    ids = rng.integers(0, C, (B, W)).astype(np.int32)
    ids[:, 0] = 3
    ids[::2, -3:] = -1                     # padded candidate slots
    cand = vectors[np.clip(ids, 0, C - 1)]

    ji, jd = JR.refine_pairs(metric, q, ids, cand, k)
    ti, td = TR.refine_pairs(metric, q, ids, cand, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    assert ti.shape == (B, k) and ti.dtype == np.int32

    ji, jd = JR.refine_on_device(metric, vectors, q, ids, k)
    ti, td = TR.refine_on_device(metric, torch.from_numpy(vectors), q,
                                 ids, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    assert np.isnan(td[ti < 0]).all()


def test_facade_growth_doubles_capacity():
    vecs = np.random.default_rng(9).random((300, 16), np.float32)
    p = T.HNSWParameters(collection_size=64, pack_queries="on")
    idx = T.HNSWIndex(16, parameters=p, device="cpu")
    assert idx._state.capacity == 64
    np.testing.assert_array_equal(idx.add(vecs[:40]), np.arange(40))
    np.testing.assert_array_equal(idx.add(vecs[40:]), np.arange(40, 300))
    assert idx._state.capacity == 512              # 64 -> 128 -> 256 -> 512
    assert idx.count == 300
    TCT._check_invariants(idx)
    ids, _ = idx.knn_query(vecs, 1)
    assert (ids[:, 0] == np.arange(300)).mean() > 0.85
