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


def _split_scan(coarse, mult, bias, q, excl, BS, bounds):
    """lane_min_scan_ref over contiguous corpus splits (whole lane groups),
    each with global column ids, as the kernel's blocks produce them."""
    pv, pi = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        local = torch.where((excl >= lo) & (excl < hi), excl - lo,
                            torch.full_like(excl, -1))
        v, i = TF.lane_min_scan_ref(coarse[lo:hi], mult[lo:hi], bias[lo:hi],
                                    q, local, BS=BS)
        pv.append(v)
        pi.append(torch.where(i >= 0, i + lo, i))
    return torch.stack(pv), torch.stack(pi)


@pytest.mark.parametrize("splits", [2, 3, 5])
@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
def test_merged_splits_equal_whole_scan_bit_for_bit(metric, splits):
    """The merge pass of the kernel: partial scans of contiguous splits,
    merged in split order with a strict '<', equal one scan of the whole
    corpus exactly, with duplicate rows of one lane lying in different
    splits (exact ties) and a ragged tail."""
    C, D, B, BS = 2000, 24, 6, 128
    vecs, q, active, excl = _case(metric, C, D, B, 11)
    G = -(-C // BS)
    for g in (1, 5, 9, 14):                    # lane 7 ties across groups
        vecs[g * BS + 7] = vecs[7]
        active[g * BS + 7] = True
    active[7] = True
    q[0] = q[1] = vecs[7]                      # the copies win lane 7
    excl[1] = 7                                # query 1 loses the first copy
    norms = torch.from_numpy(np.linalg.norm(vecs, axis=1) ** (
        2 if metric == "sq_euclid" else 1)).float()
    mult, bias = TF.rank_transform(metric, norms, torch.from_numpy(active))
    coarse = torch.from_numpy(vecs).to(torch.bfloat16)
    tq, te = torch.from_numpy(q), torch.from_numpy(excl)
    wv, wi = TF.lane_min_scan_ref(coarse, mult, bias, tq, te, BS=BS)
    bounds = [min(C, (s * G // splits) * BS) for s in range(splits)] + [C]
    pv, pi = _split_scan(coarse, mult, bias, tq, te, BS, bounds)
    mv, mi = TF.merge_lane_min_partials(pv, pi)
    assert torch.equal(mv, wv)
    assert torch.equal(mi, wi)
    assert wi[0, 7].item() == 7 and wi[1, 7].item() == BS + 7


@pytest.mark.parametrize("B,BS,C,want", [
    (512, 1024, 1_007_616, 4),      # a full build wave: 32 tiles x 4 splits
    (512, 1024, 20_000, 4),         # 20 lane groups: 5 a split
    (512, 1024, 9_000, 2),          # 9 lane groups: no split under 4 groups
    (300, 1024, 1_000_000, 5),      # 3 x 8 tiles
    (7, 1024, 700, 1),              # one group: no split, no merge
    (64, 64, 4_000_000, 132),       # one tile: every SM takes a split
    (2048, 1024, 1_000_000, 1),     # more tiles than SMs
])
def test_split_count_follows_the_shape(B, BS, C, want):
    S = TF._split_count(B, BS, C, 132)
    assert S == want
    assert 1 <= S <= max(1, -(-C // BS))


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
def test_ref_exclude_surfaces_the_runner_up(metric):
    """Excluding the column that wins a lane must surface that lane's
    runner-up, not a dead lane."""
    C, D, B, BS = 1536, 20, 4, 128
    vecs, q, active, _ = _case(metric, C, D, B, 6)
    active[:] = True
    norms = torch.from_numpy(np.linalg.norm(vecs, axis=1) ** (
        2 if metric == "sq_euclid" else 1)).float()
    mult, bias = TF.rank_transform(metric, norms, torch.from_numpy(active))
    none = np.full(B, -1, np.int32)
    _, wi0 = _oracle(vecs, q, mult.numpy(), bias.numpy(), none, BS)
    lanes = np.array([3, 64, 127, 0])
    excl = wi0[np.arange(B), lanes].astype(np.int32)   # each query's winner
    tv, ti = TF.lane_min_scan_ref(torch.from_numpy(vecs), mult, bias,
                                  torch.from_numpy(q),
                                  torch.from_numpy(excl), BS=BS)
    wv, wi = _oracle(vecs, q, mult.numpy(), bias.numpy(), excl, BS)
    got = ti.numpy()[np.arange(B), lanes]
    assert (got != excl).all() and (got >= 0).all()
    assert (got % BS == lanes).all()
    np.testing.assert_array_equal(got, wi[np.arange(B), lanes])
    np.testing.assert_allclose(tv.numpy(), wv, rtol=1e-4, atol=1e-4)
    assert (ti.numpy() == wi).mean() >= 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_pallas_interpret_odd_depth_ragged_wave(dtype):
    """D = 100 (no multiple of 16 or 64) and a wave of 13 queries."""
    C, D, B, BS = 1024, 100, 13, 128
    vecs, q, active, excl = _case("sq_euclid", C, D, B, 8)
    excl[5] = 300
    norms = np.array(jdst.norm_data("sq_euclid", jnp.asarray(vecs)))
    jm, jb = JF.rank_transform("sq_euclid", jnp.asarray(norms),
                               jnp.asarray(active))
    tm, tb = TF.rank_transform("sq_euclid", torch.from_numpy(norms),
                               torch.from_numpy(active))
    jv, ji = JF.lane_min_scan(jnp.asarray(vecs, dtype), jm, jb,
                              jnp.asarray(q), jnp.asarray(excl), BS=BS,
                              interpret=True)
    tv, ti = TF.lane_min_scan(torch.from_numpy(vecs).to(getattr(torch,
                                                                dtype)),
                              tm, tb, torch.from_numpy(q),
                              torch.from_numpy(excl), BS=BS)
    jv, ji = np.asarray(jv), np.asarray(ji)
    live = jv < TF.DEAD
    np.testing.assert_array_equal(tv.numpy() < TF.DEAD, live)
    np.testing.assert_allclose(tv.numpy()[live], jv[live], rtol=1e-4,
                               atol=1e-4)
    assert (ti.numpy()[live] == ji[live]).mean() >= 0.999
    assert (ti.numpy()[~live] == -1).all()
    assert ti.numpy()[5, 300 % BS] != 300
