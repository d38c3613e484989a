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
    tv = torch.zeros((4096, 8))
    with pytest.raises(ValueError, match="panel branch"):
        TB.exact_knn2("sq_euclid", tv, tv.to(torch.bfloat16),
                      torch.zeros(4096), torch.ones(4096, dtype=torch.bool),
                      tv[:2], 800)
