"""Kernel K2's plain version (hnswindex_torch.ops.block_scores) against the
reference's Pallas kernel in interpret mode and against a float64 oracle,
on numpy inputs from a seed.

Bars and their reasons:

* float32 tiles: plain version vs the Pallas kernel and vs the f64 oracle
  at atol 1e-4 (float32 sums of <= 128 terms of magnitude <= 1 in another
  order).
* bfloat16 tiles vs the f64 oracle over the bf16-ROUNDED operands: atol
  1e-4.  The port widens the bf16 values and takes dots and both norms in
  float32, so against that oracle it is as exact as with float32 tiles.
* bfloat16 tiles vs the Pallas kernel: loose.  The reference squares q and
  the rows in bf16 and sums q*q to a bf16 (8 significant bits), so its
  norms carry a relative error of up to 2^-8 each: sq_euclid within
  2^-6 * (|q|^2 + |v|^2), cosine within 0.03, ucosine (no norms) within
  1e-4.  The port is the more exact of the two.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hnswindex_torch.convert import _to_tensor
from hnswindex_torch.ops import block_scores as TBS
from hnswindex_tpu.ops.pallas_block import block_scores as jax_block_scores

torch.set_num_threads(1)

METRICS = ["sq_euclid", "cosine", "ucosine"]
# (NB, BS, D, B, P): the reference test's shape, then B % 8 != 0 with
# P % 4 != 0 at the two block sizes the repo's tests use
SHAPES = [(16, 8, 32, 8, 4), (20, 128, 16, 5, 3), (9, 192, 40, 13, 6)]


def _case(metric, shape, seed=0):
    NB, BS, D, B, P = shape
    rng = np.random.default_rng(seed)
    blk = rng.random((NB, BS, D)).astype(np.float32)
    q = rng.random((B, D)).astype(np.float32)
    if metric == "ucosine":
        blk /= np.linalg.norm(blk, axis=-1, keepdims=True)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    bids = rng.integers(0, NB, (B, P)).astype(np.int32)
    bids[0, P - 1] = -1                    # a routing pad: scored as block 0
    bids[B - 1, 0] = -1
    blk[bids[0, 0], 3] = 0.0               # a zero row (block padding)
    blk[0, BS - 1] = 0.0
    q[1] = 0.0                             # a zero query
    return blk, bids, q


def _oracle(metric, blk, bids, q):
    """float64 direct formula over the given (already rounded) operands."""
    B, P = bids.shape
    g = blk[np.maximum(bids, 0)].reshape(B, -1, blk.shape[-1]) \
        .astype(np.float64)
    qq = q.astype(np.float64)[:, None, :]
    if metric == "sq_euclid":
        return ((g - qq) ** 2).sum(-1)
    dot = (g * qq).sum(-1)
    if metric == "ucosine":
        return 1 - dot
    den = np.linalg.norm(g, axis=-1) * np.linalg.norm(qq, axis=-1)
    return np.where(den > 0, 1 - dot / np.where(den > 0, den, 1), 1)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("metric", METRICS)
def test_f32_tiles_match_pallas_and_oracle(metric, shape):
    blk, bids, q = _case(metric, shape)
    got = TBS.block_scores(metric, torch.from_numpy(blk),
                           torch.from_numpy(bids), torch.from_numpy(q))
    assert got.dtype == torch.float32
    assert got.shape == (shape[3], shape[4] * shape[1])
    got = got.numpy()
    want = _oracle(metric, blk, bids, q)
    assert np.abs(got - want).max() <= 1e-4
    ref = np.asarray(jax_block_scores(metric, jnp.asarray(blk),
                                      jnp.asarray(bids), jnp.asarray(q),
                                      interpret=True))
    assert np.abs(got - ref).max() <= 1e-4
    if metric == "cosine":
        # the zero-norm guard is exact: zero query, zero row
        assert (got[1] == 1.0).all()
        assert got[0, 3] == 1.0 and ref[0, 3] == 1.0


@pytest.mark.parametrize("shape", SHAPES[:2],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("metric", METRICS)
def test_bf16_tiles_match_oracle_tightly_and_pallas_loosely(metric, shape):
    blk, bids, q = _case(metric, shape, seed=1)
    blk16 = jnp.asarray(blk).astype(jnp.bfloat16)
    blk_t = _to_tensor(np.asarray(blk16), "cpu")
    got = TBS.block_scores(metric, blk_t, torch.from_numpy(bids),
                           torch.from_numpy(q)).numpy()
    blk_r = blk_t.float().numpy()
    q_r = torch.from_numpy(q).bfloat16().float().numpy()
    want = _oracle(metric, blk_r, bids, q_r)
    assert np.abs(got - want).max() <= 1e-4
    ref = np.asarray(jax_block_scores(metric, blk16, jnp.asarray(bids),
                                      jnp.asarray(q), interpret=True))
    if metric == "sq_euclid":
        g = blk_r[np.maximum(bids, 0)].reshape(got.shape[0], -1,
                                               blk.shape[-1])
        bound = 2.0 ** -6 * ((q_r * q_r).sum(-1)[:, None]
                             + (g * g).sum(-1))
        assert (np.abs(got - ref) <= bound + 1e-4).all()
    else:
        atol = 0.03 if metric == "cosine" else 1e-4
        assert np.abs(got - ref).max() <= atol


def test_ref_chunks_over_probes(monkeypatch):
    """The plain version's probe chunking changes its result by float32
    rounding only (the matmul sums in a shape-dependent order)."""
    blk, bids, q = _case("sq_euclid", SHAPES[2])
    args = (torch.from_numpy(blk), torch.from_numpy(bids),
            torch.from_numpy(q))
    whole = TBS.block_scores_ref("sq_euclid", *args)
    monkeypatch.setattr(TBS, "_REF_ELEMS", 1)          # one probe per chunk
    torch.testing.assert_close(TBS.block_scores_ref("sq_euclid", *args),
                               whole, rtol=0, atol=1e-4)


@pytest.mark.parametrize("what,exc", [
    ("metric", ValueError), ("bids_dtype", TypeError),
    ("tile_dtype", TypeError), ("q_shape", ValueError),
    ("q_dtype", TypeError), ("rank", ValueError),
    ("contiguous", ValueError), ("device", ValueError),
    ("no_kernel", ValueError)])
def test_wrapper_checks_its_inputs(what, exc):
    blk, bids, q = map(torch.from_numpy, _case("sq_euclid", SHAPES[0]))
    metric = "sq_euclid"
    if what == "metric":
        metric = "l1"
    elif what == "bids_dtype":
        bids = bids.long()
    elif what == "tile_dtype":
        blk = blk.to(torch.int8)
    elif what == "q_shape":
        q = q[:, :-1].contiguous()
    elif what == "q_dtype":
        q = q.to(torch.int32)
    elif what == "rank":
        blk = blk[0]
    elif what == "contiguous":
        blk = blk.transpose(0, 1)
    elif what == "device":
        q = q.to("meta")
    elif what == "no_kernel":
        blk, bids, q = blk.to("meta"), bids.to("meta"), q.to("meta")
    n0 = TBS.block_scores.launches
    with pytest.raises(exc):
        TBS.block_scores(metric, blk, bids, q)
    assert TBS.block_scores.launches == n0


def _skewed(table, metric, shape, seed=2):
    """``_case`` with a probe table that piles pairs onto few blocks."""
    blk, bids, q = _case(metric, shape, seed)
    B, P = bids.shape
    if table == "one_block":                # every pair on one block
        bids[:] = shape[0] // 2
    elif table == "all_pads":               # every probe a routing pad
        bids[:] = -1
    elif table == "repeat_in_query":        # a block twice in one query
        bids[:, 1] = bids[:, 0]
        bids[B - 1, :] = bids[B - 1, 0]
    return blk, bids, q


@pytest.mark.parametrize("table", ["one_block", "all_pads", "repeat_in_query"])
@pytest.mark.parametrize("metric", METRICS)
def test_skewed_probe_tables_match_pallas_and_oracle(metric, table):
    """The probe tables that make one block's segment hold many (or all)
    pairs in the kernel's grouping; the plain version defines the panel."""
    blk, bids, q = _skewed(table, metric, SHAPES[1])
    got = TBS.block_scores(metric, torch.from_numpy(blk),
                           torch.from_numpy(bids), torch.from_numpy(q))
    got = got.numpy()
    assert np.abs(got - _oracle(metric, blk, bids, q)).max() <= 1e-4
    ref = np.asarray(jax_block_scores(metric, jnp.asarray(blk),
                                      jnp.asarray(bids), jnp.asarray(q),
                                      interpret=True))
    assert np.abs(got - ref).max() <= 1e-4
    BS = SHAPES[1][1]
    if table == "repeat_in_query":          # the same block, the same scores
        np.testing.assert_array_equal(got[:, :BS], got[:, BS:2 * BS])


# (BS, D, element bytes): the block path's tiles in float32 and bfloat16,
# 192-row blocks, a row past the tile budget, rows that are not a multiple
# of 16 bytes, and a row wider than half the budget
SIZES = [(128, 128, 4), (128, 128, 2), (192, 128, 4), (128, 1024, 4),
         (128, 100, 2), (64, 50, 4), (64, 12288, 4), (7, 3, 4)]


@pytest.mark.parametrize("BS,D,elem", SIZES,
                         ids=lambda v: str(v))
def test_rows_per_chunk_fit_the_budget_and_cover_the_tile(BS, D, elem):
    rb = TBS._rows_per_chunk(BS, D, elem)
    assert 1 <= rb <= BS
    if rb == BS:                            # the whole tile in one buffer
        assert BS * D * elem <= TBS._TILE_BUDGET or BS == 1
    else:                                   # two alternating chunk buffers
        assert 2 * rb * D * elem <= TBS._TILE_BUDGET or rb == 1
        assert 2 * (rb + 1) * D * elem > TBS._TILE_BUDGET
    chunks = -(-BS // rb)
    starts = [c * rb for c in range(chunks)]
    rows = [min(rb, BS - s) for s in starts]
    assert sum(rows) == BS and min(rows) >= 1
    qt = TBS._queries_per_item(D)
    assert 1 <= qt <= TBS.QT
    assert qt * 4 * (-(-D // 4) * 4) <= TBS._QUERY_BUDGET or qt == 1
    assert TBS._smem_bytes(BS, D, elem, rb, qt) <= TBS._SMEM_LIMIT


def _true_items(bids, NB, qt):
    counts = np.bincount(np.clip(bids.ravel(), 0, NB - 1), minlength=NB)
    return int((-(-counts // qt)).sum())


@pytest.mark.parametrize("qt", [1, 16, 32])
@pytest.mark.parametrize("table", ["random", "one_block", "all_pads",
                                   "clustered", "few_blocks_many_queries"])
def test_max_work_items_bounds_every_probe_table(table, qt):
    """The grid is launched at ``_max_work_items`` without reading the
    real item count back, so the bound must hold for any probe table."""
    rng = np.random.default_rng(qt)
    for NB, B, P in [(13_568, 1_024, 32), (50, 300, 11), (5_000, 20, 4),
                     (30, 1, 1), (3, 1_001, 13)]:
        if table == "random":
            bids = rng.integers(-1, NB, (B, P))
        elif table == "one_block":
            bids = np.full((B, P), NB // 2)
        elif table == "all_pads":
            bids = np.full((B, P), -1)
        elif table == "clustered":          # a few hot blocks per query
            hot = rng.integers(0, NB, 8)
            bids = hot[rng.integers(0, 8, (B, P))]
        else:                               # each block takes qt + 1 pairs
            bids = np.arange(B * P).reshape(B, P) // (qt + 1) % NB
        true = _true_items(bids, NB, qt)
        bound = TBS._max_work_items(NB, B, P, qt)
        assert true <= bound <= min(NB, B * P) + B * P // qt + 1
