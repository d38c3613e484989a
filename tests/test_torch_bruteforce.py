"""Port parity: exact_knn / exact_knn2 against hnswindex_tpu's, with the
reference's fused stage 1 (Pallas lane-min scan) run in interpret mode.

Bars (the reference's own, test_pallas_kernels.py): recall@10 against the
f64 oracle > 0.98; ids agree with the reference on >= 0.95 of entries;
where ids agree, distances match at rtol=atol=1e-5; no inactive id is ever
returned."""

import unittest.mock as um

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnswindex_torch.ops import bruteforce as TB
from hnswindex_torch.ops import distance as tdst
from hnswindex_tpu.ops import bruteforce as JB
from hnswindex_tpu.ops import distance as jdst
from hnswindex_tpu.ops import fused_scan as JF

torch.set_num_threads(1)

C, D, B, K = 8192, 32, 16, 10


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    vecs = rng.random((C, D)).astype(np.float32)
    active = np.ones(C, bool)
    active[::7] = False
    q = vecs[:B] + 0.01 * rng.standard_normal((B, D)).astype(np.float32)
    d64 = ((q.astype(np.float64)[:, None, :]
            - vecs.astype(np.float64)[None, :, :]) ** 2).sum(-1)
    d64[:, ~active] = np.inf
    return vecs, active, q, np.argsort(d64, axis=1)[:, :K]


def _recall(ids, want):
    return np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, want)])


def _torch_args(vecs, active, q):
    tv = torch.from_numpy(vecs)
    return (tv, tdst.norm_data("sq_euclid", tv), torch.from_numpy(active),
            torch.from_numpy(q))


def test_exact_knn2_matches_reference(case):
    vecs, active, q, want = case
    vj = jnp.asarray(vecs)
    orig = JF.lane_min_scan

    def interp(coarse, mult, bias, qq, ex, BS=1024, interpret=False):
        return orig(coarse, mult, bias, qq, ex, BS=BS, interpret=True)

    with um.patch.object(JF, "lane_min_scan", interp):
        jd, ji = JB.exact_knn2("sq_euclid", vj, vj.astype(jnp.bfloat16),
                               jdst.norm_data("sq_euclid", vj),
                               jnp.asarray(active), jnp.asarray(q), K,
                               fused=True)
    jd, ji = np.asarray(jd), np.asarray(ji)
    tv, tn, ta, tq = _torch_args(vecs, active, q)
    td, ti = TB.exact_knn2("sq_euclid", tv, tv.to(torch.bfloat16), tn, ta,
                           tq, K)
    td, ti = td.numpy(), ti.numpy()
    assert _recall(ti, want) > 0.98
    assert (ti == ji).mean() >= 0.95
    same = ti == ji
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-5)
    assert not np.isin(ti, np.flatnonzero(~active)).any()


def test_exact_knn_matches_reference(case):
    vecs, active, q, want = case
    excl = np.arange(B, dtype=np.int32)        # each query's source row
    vj = jnp.asarray(vecs)
    jd, ji = JB.exact_knn("sq_euclid", vj, jdst.norm_data("sq_euclid", vj),
                          jnp.asarray(active), jnp.asarray(q), K,
                          block=2048, exclude=jnp.asarray(excl))
    tv, tn, ta, tq = _torch_args(vecs, active, q)
    td, ti = TB.exact_knn("sq_euclid", tv, tn, ta, tq, K, block=2048,
                          exclude=torch.from_numpy(excl))
    ji, ti = np.asarray(ji), ti.numpy()
    assert (ti == ji).mean() >= 0.95
    same = ti == ji
    np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same],
                               rtol=1e-5, atol=1e-5)
    assert not (ti == excl[:, None]).any()
    assert not np.isin(ti, np.flatnonzero(~active)).any()


def test_narrow_prefix_pads_to_k():
    """A scan prefix with fewer live rows than k pads with -1 / inf."""
    rng = np.random.default_rng(0)
    vecs = rng.random((6, 8)).astype(np.float32)
    tv = torch.from_numpy(vecs)
    d, i = TB.exact_knn("sq_euclid", tv, tdst.norm_data("sq_euclid", tv),
                        torch.ones(6, dtype=torch.bool), tv[:2], 10,
                        exclude=torch.tensor([0, 1]))
    assert i.shape == (2, 10)
    assert (i[:, 5:] == -1).all() and torch.isinf(d[:, 5:]).all()
    assert (i[:, :5] >= 0).all()


def test_wide_survivor_set_raises():
    """Survivor widths past the lane count no longer raise: they take the
    panel branch, whose survivors on this all-zero corpus (every distance
    ties) are the lowest active columns minus the excluded one, so the
    answer is exact here."""
    tv = torch.zeros((4096, 8))
    active = torch.ones(4096, dtype=torch.bool)
    active[:3] = False
    d, i = TB.exact_knn2("sq_euclid", tv, tv.to(torch.bfloat16),
                         torch.zeros(4096), active, tv[:2], 800,
                         exclude=torch.tensor([3, 5]))
    assert i.shape == (2, 800) and bool((d == 0).all())
    assert not np.isin(i.numpy(), [0, 1, 2]).any()
    assert not (i[0] == 3).any() and not (i[1] == 5).any()
    assert len(set(i[0].tolist())) == 800


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
def test_exact_knn2_panel_branch_matches_reference(case, metric):
    """k=300: S = 1,200 > 1,024 lanes, the panel branch in both packages
    (the reference takes it on the CPU at any S).  Ids equal the
    reference's wherever the float64 gap exceeds 1e-6 of the distance
    scale (||q||^2 + ||x||^2 for sq_euclid, 1 for cosine: the float32
    rescore's rounding error scales with it); each query's exclude id and
    the inactive rows never come back."""
    vecs, active, q, _ = case
    k = 300
    excl = np.arange(B, dtype=np.int32)
    vj = jnp.asarray(vecs)
    jd, ji = JB.exact_knn2(metric, vj, vj.astype(jnp.bfloat16),
                           jdst.norm_data(metric, vj), jnp.asarray(active),
                           jnp.asarray(q), k, exclude=jnp.asarray(excl))
    tv = torch.from_numpy(vecs)
    calls = []
    orig = TB._panel_survivors

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    with um.patch.object(TB, "_panel_survivors", spy):
        td, ti = TB.exact_knn2(metric, tv, tv.to(torch.bfloat16),
                               tdst.norm_data(metric, tv),
                               torch.from_numpy(active), torch.from_numpy(q),
                               k, exclude=torch.from_numpy(excl))
    assert calls
    ti, ji = ti.numpy(), np.asarray(ji)
    assert (ti >= 0).all()
    assert not np.isin(ti, np.flatnonzero(~active)).any()
    assert not (ti == excl[:, None]).any()
    v64, q64 = vecs.astype(np.float64), q.astype(np.float64)
    if metric == "sq_euclid":
        d64 = lambda ids: ((v64[ids] - q64[:, None]) ** 2).sum(-1)  # noqa
        scale = (q64 * q64).sum(1)[:, None] + (v64[ti] ** 2).sum(-1)
    else:
        def d64(ids):
            v = v64[ids]
            return 1.0 - (v * q64[:, None]).sum(-1) / (
                np.linalg.norm(v, axis=-1)
                * np.linalg.norm(q64, axis=-1)[:, None])
        scale = np.ones(ti.shape)
    diff = ti != ji
    assert (np.abs(d64(ti) - d64(ji))[diff] <= 1e-6 * scale[diff]).all()
    same = ~diff
    np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
def test_range_scans_match_reference(case, metric):
    """range_count and range_distances against the reference's at a
    radius between the 20th and 21st neighbours of query 0: the counts are
    equal, and the in-radius sets of range_distances are equal with
    distances at rtol=atol=1e-5."""
    vecs, active, q, _ = case
    vj, tv = jnp.asarray(vecs), torch.from_numpy(vecs)
    jn, tn = jdst.norm_data(metric, vj), tdst.norm_data(metric, tv)
    ja, ta = jnp.asarray(active), torch.from_numpy(active)
    d = np.asarray(tdst.pairwise(metric, torch.from_numpy(q), tv))
    d[:, ~active] = np.inf
    d0 = np.sort(d[0])
    radius = float(np.float32(0.5 * (d0[19] + d0[20])))
    jc = np.asarray(JB.range_count(metric, vj, jn, ja, jnp.asarray(q),
                                   jnp.float32(radius), block=2048))
    tc = TB.range_count(metric, tv, tn, ta, torch.from_numpy(q), radius,
                        block=2048).numpy()
    np.testing.assert_array_equal(tc, jc)
    assert (tc > 0).all() and tc.min() < tc.max()
    for r in (0, 7):
        jd = np.asarray(JB.range_distances(metric, vj, jn, ja,
                                           jnp.asarray(q[r]),
                                           jnp.float32(radius), block=2048))
        td = TB.range_distances(metric, tv, tn, ta, torch.from_numpy(q[r]),
                                radius, block=2048).numpy()
        assert td.shape == (C,)
        np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
        fin = np.isfinite(td)
        assert fin.sum() == tc[r]
        np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-5)


def test_exact_query_lanes_keep_cluster_mates():
    """Why the exact query scans at 4,096 lanes: on chip_smoke.py's
    clustered generator (clusters of ~500 rows), 6,000 rows in 8,192
    slots, 500 corpus rows as queries, k=10, the lane-min scan at the
    reference's 1,024 lanes loses true neighbours to cluster mates that
    share their lane and rank below them on the bf16 products (measured
    recall@10 0.9832 against the float64 truth): a lane keeps only its
    minimum, so no wider survivor set brings them back.  At 4,096 lanes it
    measured 0.9934.
    Held: 4,096 lanes >= 0.99 and above 1,024 lanes."""
    from hnswindex_torch import index as TI
    n, d, C = 6000, 128, 8192
    rng = np.random.default_rng(65537)
    centers = rng.random((n // 500, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, n // 500, n)]
            + 0.03 * rng.standard_normal((n, d)).astype(np.float32))
    x = torch.zeros((C, d))
    x[:n] = torch.from_numpy(vecs)
    active = torch.zeros(C, dtype=torch.bool)
    active[:n] = True
    q = torch.from_numpy(vecs[:500])
    v64 = vecs.astype(np.float64)
    d64 = ((v64[:500] ** 2).sum(1)[:, None] + (v64 ** 2).sum(1)[None]
           - 2.0 * v64[:500] @ v64.T)
    want = np.argsort(d64, axis=1)[:, :10]
    rec = {}
    for lanes in (TB.FUSED_BS, TI.EXACT_LANES):
        _, ids = TB.exact_knn2("sq_euclid", x, x.to(torch.bfloat16),
                               tdst.norm_data("sq_euclid", x), active, q, 10,
                               lanes=lanes)
        rec[lanes] = _recall(ids.numpy(), want)
    assert rec[TI.EXACT_LANES] >= 0.99 and \
        rec[TI.EXACT_LANES] > rec[TB.FUSED_BS], rec
