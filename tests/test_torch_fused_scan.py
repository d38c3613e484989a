"""Kernel K1 (lane-min scan): the plain PyTorch version against the
reference Pallas kernel in interpret mode and against an f64 oracle.  The
CUDA kernel against the plain version is test_torch_kernels_cuda.py.

Tolerances: vals rtol=atol=1e-4 (f32 products summed in another order);
ids agree on >= 0.999 of live lanes; dead lanes are -1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hnswindex_torch.ops import fused_scan as TF
from hnswindex_tpu.ops import distance as jdst
from hnswindex_tpu.ops import fused_scan as JF

torch.set_num_threads(1)


def _case(metric, C, D, B, seed):
    rng = np.random.default_rng(seed)
    vecs = rng.random((C, D)).astype(np.float32)
    if metric == "ucosine":
        vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    vecs[5] = 0.0                               # zero-norm guard row
    q = rng.random((B, D)).astype(np.float32)
    active = rng.random(C) < 0.9
    excl = np.full(B, -1, np.int32)
    excl[0] = 17
    return vecs, q, active, excl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["sq_euclid", "cosine", "ucosine"])
def test_ref_matches_pallas_interpret(metric, dtype):
    C, D, B, BS = 1024, 32, 8, 128
    vecs, q, active, excl = _case(metric, C, D, B, 2)
    norms = np.array(jdst.norm_data(metric, jnp.asarray(vecs)))
    jm, jb = JF.rank_transform(metric, jnp.asarray(norms),
                               jnp.asarray(active))
    tm, tb = TF.rank_transform(metric, torch.from_numpy(norms),
                               torch.from_numpy(active))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))

    jv, ji = JF.lane_min_scan(jnp.asarray(vecs, dtype), jm, jb,
                              jnp.asarray(q), jnp.asarray(excl), BS=BS,
                              interpret=True)
    launches = TF.lane_min_scan.launches
    tv, ti = TF.lane_min_scan(torch.from_numpy(vecs).to(getattr(torch,
                                                                dtype)),
                              tm, tb, torch.from_numpy(q),
                              torch.from_numpy(excl), BS=BS)
    assert TF.lane_min_scan.launches == launches   # CPU: no kernel launch
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = tv.numpy(), ti.numpy()
    live = jv < TF.DEAD
    np.testing.assert_array_equal(tv < TF.DEAD, live)
    np.testing.assert_allclose(tv[live], jv[live], rtol=1e-4, atol=1e-4)
    assert (ti[live] == ji[live]).mean() >= 0.999
    assert (ti[~live] == -1).all()


def _oracle(vecs, q, mult, bias, excl, BS):
    C = vecs.shape[0]
    key = (q.astype(np.float64) @ vecs.astype(np.float64).T) \
        * mult.astype(np.float64)[None] + bias.astype(np.float64)[None]
    for b, e in enumerate(excl):
        if e >= 0:
            key[b, e] = 3.0e38
    G = -(-C // BS)
    key = np.pad(key, ((0, 0), (0, G * BS - C)), constant_values=3.0e38)
    key = key.reshape(q.shape[0], G, BS)
    vals = key.min(axis=1)
    ids = key.argmin(axis=1) * BS + np.arange(BS)[None]
    return vals, np.where(vals < 1e37, ids, -1)


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
def test_ref_ragged_corpus_matches_f64_oracle(metric):
    """C not a multiple of BS: the tail group is masked, nothing needs
    alignment."""
    C, D, B, BS = 1000, 24, 5, 128
    vecs, q, active, excl = _case(metric, C, D, B, 4)
    active[C - BS:] = False                    # a lane range with no rows
    active[C - 40:] = True
    norms = torch.from_numpy(np.linalg.norm(vecs, axis=1) ** (
        2 if metric == "sq_euclid" else 1)).float()
    mult, bias = TF.rank_transform(metric, norms, torch.from_numpy(active))
    tv, ti = TF.lane_min_scan_ref(torch.from_numpy(vecs), mult, bias,
                                  torch.from_numpy(q),
                                  torch.from_numpy(excl), BS=BS)
    wv, wi = _oracle(vecs, q, mult.numpy(), bias.numpy(), excl, BS)
    live = wv < 1e37
    np.testing.assert_allclose(tv.numpy()[live], wv[live], rtol=1e-4,
                               atol=1e-4)
    assert (ti.numpy()[live] == wi[live]).mean() >= 0.999
    assert (ti.numpy()[~live] == -1).all()


def test_ref_lowest_column_wins_ties():
    """Duplicate rows tie exactly: the lowest column keeps the lane."""
    BS, D = 64, 8
    row = np.arange(D, dtype=np.float32)
    vecs = np.tile(row, (4 * BS, 1))
    q = np.ones((2, D), np.float32)
    norms = torch.from_numpy((vecs ** 2).sum(1))
    mult, bias = TF.rank_transform("sq_euclid", norms,
                                   torch.ones(4 * BS, dtype=torch.bool))
    _, ids = TF.lane_min_scan_ref(torch.from_numpy(vecs), mult, bias,
                                  torch.from_numpy(q),
                                  torch.tensor([-1, 3], dtype=torch.int32),
                                  BS=BS)
    want = np.arange(BS)
    np.testing.assert_array_equal(ids[0].numpy(), want)
    want[3] = 3 + BS                          # column 3 excluded for query 1
    np.testing.assert_array_equal(ids[1].numpy(), want)
