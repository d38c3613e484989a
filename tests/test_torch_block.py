"""Block-serving parity: hnswindex_torch.block against hnswindex_tpu.block on
the same inputs, and the port's own BlockIndex behaviour on the CPU.

The reference index is built once per module (3,000 x 32 clustered rows,
64-row blocks) and its layout is installed into the port through
``_install``, so routing and scoring are compared apart from k-means.

Bars:

* k-means from the same seed: labels agree on >= 0.99 of rows (the sums
  are taken in another order, so rows at a near-tie between two centroids
  may flip); the fraction is part of the assertion message.
* ``_route_exact``, the scoring step and ``knn_query`` on the installed
  layout: ids equal wherever the float64 distance gap exceeds 1e-5, i.e.
  at every position the two ids are equal or their float64 distances are
  within 1e-5; panel values within 1e-4 (float32 sums in another order).
* the reference's kernel path (``_score_blocks_pallas``) runs on the CPU by
  patching ``hnswindex_tpu.ops.pallas_block.block_scores`` to interpret
  mode from here.
* int8 tables from the same rows: codes equal on >= 0.995 of entries and
  never more than one step apart (XLA and torch round the scaled divide
  differently in the last bit, which moves a value across a .5 boundary),
  scales within 1e-6 relative, norms within one such step.
* ``.npz`` snapshots load in the other package and answer identically.
"""

import unittest.mock as um

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hnswindex_torch as T
from hnswindex_torch import block as TB
from hnswindex_torch.convert import _to_tensor
from hnswindex_tpu import block as JB
from hnswindex_tpu.ops import pallas_block as JPB
from torch_cases import clustered

torch.set_num_threads(1)

DIM = 32
N = 3000
K = 10


def overlap(ids, gt):
    k = gt.shape[1]
    return np.mean([len(set(ids[r].tolist()) & set(gt[r].tolist())) / k
                    for r in range(gt.shape[0])])


def sq64(q, x):
    return ((q[:, None, :].astype(np.float64)
             - x[None, :, :].astype(np.float64)) ** 2).sum(-1)


def same_up_to_ties(ids_a, ids_b, dist_of):
    """At each position the ids are equal, or their float64 distances
    (``dist_of(row, id)``) differ by at most 1e-5."""
    bad = 0
    for r, c in zip(*np.nonzero(ids_a != ids_b)):
        a, b = int(ids_a[r, c]), int(ids_b[r, c])
        if a < 0 or b < 0 or abs(dist_of(r, a) - dist_of(r, b)) > 1e-5:
            bad += 1
    return bad == 0


@pytest.fixture(scope="module")
def data():
    vecs = clustered(N, DIM, 40, np.random.default_rng(65537))
    q = clustered(100, DIM, 40, np.random.default_rng(7))
    d = sq64(q, vecs)
    return vecs, q, d, np.argsort(d, axis=1)[:, :K]


@pytest.fixture(scope="module")
def pair(data):
    """(reference index, port index holding the reference's layout)."""
    vecs = data[0]
    jx = JB.BlockIndex(DIM, block_size=64)
    jx.build(vecs)
    tx = T.BlockIndex(DIM, block_size=64, device="cpu")
    tx._install(jx._h_ids.copy(), jx._h_vecs.copy(), next_id=N)
    return jx, tx


@pytest.fixture(scope="module")
def built(data):
    ix = T.BlockIndex(DIM, block_size=64, device="cpu")
    ix.build(data[0])
    return ix


# -- parity with the reference -------------------------------------------

def test_kmeans_labels_agree_from_one_seed(data):
    vecs = data[0]
    nc = int(np.ceil(N / (0.75 * 64)))
    lj = JB._kmeans(vecs, nc, 6, np.random.default_rng(31337))
    lt = TB._kmeans(vecs, nc, 6, np.random.default_rng(31337), "cpu")
    agree = float((np.asarray(lj) == lt).mean())
    assert agree >= 0.99, f"k-means labels agree on {agree:.4f} of rows"


def test_installed_layout_matches(pair):
    jx, tx = pair
    assert tx.n_blocks == jx.n_blocks and tx.count == jx.count == N
    np.testing.assert_array_equal(tx._h_fill, jx._h_fill)
    np.testing.assert_allclose(tx._h_cents, jx._h_cents, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tx._h_r2, jx._h_r2, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tx._id_to_pos, jx._id_to_pos)
    np.testing.assert_allclose(tx._cent_norms.numpy(),
                               np.asarray(jx._cent_norms), rtol=1e-6)


def test_route_exact_matches(pair, data):
    jx, tx = pair
    q = data[1]
    bj = np.asarray(JB._route_exact("sq_euclid", jx._cents, jx._cent_norms,
                                    jnp.asarray(q), 8, jx._cent_valid))
    bt = TB._route_exact("sq_euclid", tx._cents, tx._cent_norms,
                         torch.from_numpy(q), 8, tx._cent_valid)
    assert bt.dtype == torch.int32 and bt.shape == (100, 8)
    dc = sq64(q, jx._h_cents)
    assert same_up_to_ties(bt.numpy(), bj, lambda r, b: dc[r, b])


@pytest.fixture(scope="module")
def routed(pair, data):
    """(queries, their float64 distances, probe table) for the scoring
    tests, with the two cases only the masks keep right."""
    jx, _ = pair
    q = data[1].copy()
    q[5] = 0.0          # nearer to a block's zero padding rows than to any
    #                     member: only the fill mask keeps those rows out
    q[3] = jx._h_vecs[0, 0] + 1e-3       # routes to block 0 first
    bids = np.asarray(JB._route_exact(
        "sq_euclid", jx._cents, jx._cent_norms, jnp.asarray(q), 7,
        jx._cent_valid)).copy()
    assert bids[3, 0] == 0
    # a routing pad: scored unmasked, the pad (clamped to block 0) would
    # repeat that block's ids in row 3
    bids[3, 6] = -1
    return q, sq64(q, data[0]), bids


def test_scoring_step_matches_reference_kernel_path(pair, routed):
    """Port: block_scores' plain version + mask + top-k2.  Reference:
    _score_blocks_pallas with the Pallas kernel in interpret mode."""
    jx, tx = pair
    q, d, bids = routed
    orig = JPB.block_scores

    def interp(metric, blk_vecs, bids, qq, interpret=False):
        return orig(metric, blk_vecs, bids, qq, interpret=True)

    with um.patch.object(JPB, "block_scores", interp):
        vj, ij = JB._score_blocks_pallas(
            "sq_euclid", jx._blk_vecs, jx._blk_ids, jx._blk_fill,
            jnp.asarray(q), jnp.asarray(bids), K)
    vt, it = TB._score_blocks_panel(
        "sq_euclid", tx._blk_vecs, tx._blk_ids, tx._blk_fill,
        torch.from_numpy(q), torch.from_numpy(bids), K)
    assert vt.shape == (100, 32) and it.dtype == torch.int32
    assert (it.numpy() >= 0).all()
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-4)
    assert same_up_to_ties(it.numpy(), np.asarray(ij), lambda r, i: d[r, i])


@pytest.mark.parametrize("tiles", ["f32", "bf16"])
def test_plain_scoring_matches_reference(pair, routed, tiles):
    """_score_blocks (gather + running top-k) against the reference's."""
    jx, tx = pair
    q, d, bids = routed
    bvj = jx._blk_vecs if tiles == "f32" \
        else jx._blk_vecs.astype(jnp.bfloat16)
    bvt = tx._blk_vecs if tiles == "f32" else _to_tensor(np.asarray(bvj),
                                                         "cpu")
    norms_t = torch.where(tx._blk_ids >= 0,
                          (tx._blk_vecs * tx._blk_vecs).sum(-1), 0.0)
    dj, ij = JB._score_blocks("sq_euclid", bvj, jx._blk_ids, jx._blk_norms,
                              jnp.asarray(q), jnp.asarray(bids), K)
    dt, it = TB._score_blocks("sq_euclid", bvt, tx._blk_ids, norms_t,
                              torch.from_numpy(q), torch.from_numpy(bids),
                              K)
    # bf16 tiles: both widen the same bf16 values and sum in float32
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-4)
    if tiles == "f32":
        assert same_up_to_ties(it.numpy(), np.asarray(ij),
                               lambda r, i: d[r, i])
    else:
        assert (it.numpy() == np.asarray(ij)).mean() > 0.99


def test_knn_query_ids_match_reference(pair, data):
    jx, tx = pair
    vecs, q, d, gt = data
    ij, dj = jx.knn_query(q, K, n_probe=8)
    it, dt = tx.knn_query(q, K, n_probe=8)
    assert it.dtype == np.int32 and dt.dtype == np.float32
    assert same_up_to_ties(it, ij, lambda r, i: d[r, i])
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)
    assert abs(overlap(it, gt) - overlap(ij, gt)) < 1e-9


@pytest.fixture(scope="module")
def ref_tables(data):
    """The reference's query-only tables from a bf16 table, both tiers."""
    vecs = data[0]
    src = jnp.asarray(vecs).astype(jnp.bfloat16)
    active = np.ones(N, bool)
    active[::11] = False
    return src, active, {
        quant: JB.build_device_block_tables(
            "sq_euclid", src, active, block_size=64, seed=5, quantize=quant)
        for quant in (False, True)}


def _tables_to_torch(tbl):
    leaves = [_to_tensor(np.asarray(x), "cpu") for x in tbl[:-1]]
    return TB.DeviceBlockTables(*leaves, n_blocks=tbl.n_blocks)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_device_block_query_matches_reference(ref_tables, data, quant):
    """The facade fallback's query on the reference's own tables."""
    src, active, tables = ref_tables
    vecs, q, d, _ = data
    tj = tables[quant]
    dj, ij = JB.device_block_query("sq_euclid", tj, jnp.asarray(q), K, 8,
                                   use_pallas=False)
    dt, it = TB.device_block_query("sq_euclid", _tables_to_torch(tj),
                                   torch.from_numpy(q), K, 8)
    ij, it = np.asarray(ij), it.numpy()
    assert not np.isin(it[it >= 0], np.flatnonzero(~active)).any()
    # the port's panel is wider (top max(2kk, 32) against the reference's
    # running top-kk): the reference's finite candidates are its prefix
    kk = ij.shape[1]
    assert it.shape[1] >= kk
    # bf16 tiles: the reference stores its tile norms in bf16 (8 significant
    # bits of |v|^2 ~ 11, one ulp = 0.0625), the port takes them in float32
    np.testing.assert_allclose(dt.numpy()[:, :kk], np.asarray(dj), rtol=0,
                               atol=0.1 if not quant else 1e-4)
    agree = np.mean([len(set(a[a >= 0]) & set(b[b >= 0]))
                     / max(1, (b >= 0).sum()) for a, b in zip(it, ij)])
    assert agree > 0.97, agree


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_build_device_block_tables_matches_reference(ref_tables, data,
                                                     quant):
    src, active, tables = ref_tables
    vecs, q, d, _ = data
    tj = tables[quant]
    tt = TB.build_device_block_tables(
        "sq_euclid", _to_tensor(np.asarray(src), "cpu"), active,
        block_size=64, seed=5, quantize=quant)
    assert tt.blk_vecs.dtype == (torch.int8 if quant else torch.bfloat16)
    fill_t = tt.blk_fill.numpy()
    assert int(fill_t.sum()) == int(active.sum())
    ids_t = tt.blk_ids.numpy()
    assert sorted(ids_t[ids_t >= 0].tolist()) \
        == np.flatnonzero(active).tolist()
    # same seed, same sample: the layouts agree up to k-means near-ties
    fill_j = np.asarray(tj.blk_fill)
    live_j = int((fill_j > 0).sum())
    assert abs(int((fill_t > 0).sum()) - live_j) <= max(2, live_j // 50)
    # and answer alike: recall@10 after the float64 refine within 0.02
    dlive = np.where(active[None, :], d, np.inf)
    gt = np.argsort(dlive, axis=1)[:, :K]

    def recall(ids):
        ids = np.asarray(ids)
        dd = np.take_along_axis(dlive, np.clip(ids, 0, N - 1), axis=1)
        dd = np.where(ids >= 0, dd, np.inf)
        top = np.take_along_axis(ids, np.argsort(dd, axis=1)[:, :K], axis=1)
        return overlap(top, gt)

    rt = recall(TB.device_block_query("sq_euclid", tt, torch.from_numpy(q),
                                      K, 8)[1].numpy())
    rj = recall(JB.device_block_query("sq_euclid", tj, jnp.asarray(q), K, 8,
                                      use_pallas=False)[1])
    assert rt > 0.9 and abs(rt - rj) <= 0.02, (rt, rj)


def test_quantized_gather_matches_reference(data):
    vecs = data[0]
    src = jnp.asarray(vecs).astype(jnp.bfloat16)
    slots = np.full(16 * 64, -1, np.int32)
    slots[:900] = np.random.default_rng(3).permutation(N)[:900]
    for metric in ("sq_euclid", "cosine"):
        qj, sj, mj, nj = JB._gather_quant_blocks(
            metric, src, jnp.asarray(slots), 64, chunk_blocks=8)
        qt, st, mt, nt = TB._gather_quant_blocks(
            metric, _to_tensor(np.asarray(src), "cpu"),
            torch.from_numpy(slots).long(), 64, chunk_blocks=8)
        step = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj))
        assert step.max() <= 1 and (step == 0).mean() >= 0.995
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5,
                                   atol=1e-5)
        # one code step of 127 moves |v|^2 by at most 2 * 127 / 127^2
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0.02,
                                   atol=1e-7)


def test_bounded_gather_and_assignment_match_reference(data):
    vecs = data[0]
    src = jnp.asarray(vecs).astype(jnp.bfloat16)
    src_t = _to_tensor(np.asarray(src), "cpu")
    idx = np.random.default_rng(4).integers(-1, N, 700)
    gj = JB._gather_rows_bounded(src, jnp.asarray(idx), chunk=256)
    gt = TB._gather_rows_bounded(src_t, torch.from_numpy(idx), chunk=256)
    np.testing.assert_array_equal(gt.float().numpy(),
                                  np.asarray(gj.astype(jnp.float32)))
    cents = vecs[:50]
    live = np.flatnonzero(idx >= 0)
    lj = np.asarray(JB._assign_rows_chunked(
        src, jnp.asarray(idx[live]), jnp.asarray(cents), chunk=128))
    lt = TB._assign_rows_chunked(src_t, torch.from_numpy(idx[live]),
                                 torch.from_numpy(cents), chunk=128).numpy()
    assert (lj == lt).mean() >= 0.99


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_npz_snapshots_cross_load(pair, data, tmp_path, direction):
    jx, tx = pair
    q = data[1]
    path = str(tmp_path / "block")            # no extension: both add it
    if direction == "torch_to_jax":
        tx.serialize(path)
        other = JB.BlockIndex.deserialize(path)
        want = tx.knn_query(q, K, n_probe=8)
    else:
        jx.serialize(path)
        other = T.BlockIndex.deserialize(path, device="cpu")
        want = jx.knn_query(q, K, n_probe=8)
    got = other.knn_query(q, K, n_probe=8)
    assert other.count == N and other.n_blocks == jx.n_blocks
    assert other._next_id == N and other.block_size == 64
    d = data[2]
    assert same_up_to_ties(np.asarray(got[0]), np.asarray(want[0]),
                           lambda r, i: d[r, i])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


# -- the port's own behaviour (analogs of tests/test_block.py) -------------

def test_block_recall_sweep(built, data):
    _, q, _, gt = data
    assert built.count == N
    r8 = overlap(built.knn_query(q, K, n_probe=8)[0], gt)
    r32 = overlap(built.knn_query(q, K, n_probe=32)[0], gt)
    assert r32 >= r8
    assert r32 > 0.9, (r8, r32)


def test_block_all_probes_is_exact(built, data):
    _, q, _, gt = data
    ids, dists = built.knn_query(q, K, n_probe=built.n_blocks)
    assert overlap(ids, gt) > 0.999
    assert np.all(np.diff(dists, axis=1) >= -1e-6)


@pytest.mark.parametrize("metric", ["cosine", "ucosine"])
def test_block_other_metrics_exact_when_all_probed(metric):
    rng = np.random.default_rng(8)
    vecs = rng.standard_normal((600, 16)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ix = T.BlockIndex(16, metric, block_size=32, device="cpu")
    ix.build(vecs)
    ids, dists = ix.knn_query(vecs[:50], 5, n_probe=ix.n_blocks)
    want = np.argsort(1.0 - vecs[:50].astype(np.float64)
                      @ vecs.astype(np.float64).T, axis=1)[:, :5]
    assert overlap(ids, want) > 0.999
    assert np.abs(dists[:, 0]).max() < 1e-5         # self-distance


def test_block_padding_and_validation():
    rng = np.random.default_rng(3)
    vecs = rng.random((150, DIM), dtype=np.float32)
    ix = T.BlockIndex(DIM, block_size=64, device="cpu")
    ix.build(vecs)
    ids, dists = ix.knn_query(vecs[:5], k=200, n_probe=ix.n_blocks)
    assert ids.shape == (5, 200)
    assert np.all(ids[:, :150] >= 0)
    assert np.all(ids[:, 150:] == -1)
    assert np.all(np.isnan(dists[:, 150:]))
    with pytest.raises(RuntimeError):
        T.BlockIndex(DIM, device="cpu").knn_query(vecs[:1], 1)
    with pytest.raises(RuntimeError):
        T.BlockIndex(DIM, device="cpu").add(vecs[:1])
    with pytest.raises(RuntimeError):
        T.BlockIndex(DIM, device="cpu").serialize("unused")
    with pytest.raises(ValueError):
        T.BlockIndex(DIM, router="bogus", device="cpu")
    with pytest.raises(ValueError):
        T.BlockIndex(DIM, metric="l1", device="cpu")
    with pytest.raises(ValueError):
        ix.build(vecs[:, :5])
    with pytest.raises(ValueError):
        ix.add(vecs[:2, :5])
    with pytest.raises(ValueError):
        ix.update([0, 1], vecs[:1])
    with pytest.raises(ValueError):
        ix.update([100000], vecs[:1])


def cos64(q, x):
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    return 1.0 - (q64 @ x64.T) / (np.linalg.norm(q64, axis=1)[:, None]
                                  * np.linalg.norm(x64, axis=1)[None, :])


#: the hnsw router's layout: 600 blocks of 5 rows, so that the centroid
#: graph of either package is a 600 x 32 cosine index, the shapes of
#: test_torch_pack.cosine_build, whose compiled programs it shares
ROUTER_NB, ROUTER_BS = 600, 5


def test_block_hnsw_router_raises(pair, data):
    """router="hnsw" (it raised until the centroid graph's upkeep had
    remove): on an installed cosine layout (the reference's blocks cut into
    600 blocks of 5 rows), both packages build the centroid graph and
    route each query to the same blocks up to near-tie swaps of centroid
    distance, and knn_query answers the same ids up to near-tie swaps.
    After an add and a remove the port rebuilds the graph over the live
    blocks before the next query."""
    jx0, _ = pair
    vecs, q, _, _ = data
    order = jx0._h_ids[jx0._h_ids >= 0]
    layout = (order.reshape(ROUTER_NB, ROUTER_BS).astype(np.int32),
              vecs[order].reshape(ROUTER_NB, ROUTER_BS, DIM))
    jx = JB.BlockIndex(DIM, "cosine", block_size=ROUTER_BS, router="hnsw")
    jx._install(*layout, next_id=N)
    tx = T.BlockIndex(DIM, "cosine", block_size=ROUTER_BS, router="hnsw",
                      device="cpu")
    tx._install(*layout, next_id=N)
    assert tx._router_index.count == jx._router_index.count == ROUTER_NB
    bj = np.asarray(jx._route(jnp.asarray(q), 8))
    bt = tx._route(torch.from_numpy(q), 8)
    assert bt.dtype == torch.int32 and bt.shape == (100, 8)
    dc = cos64(q, jx._h_cents)
    assert same_up_to_ties(bt.numpy(), bj, lambda r, b: dc[r, b])
    tids, _ = tx.knn_query(q, K, n_probe=8)
    jids, _ = jx.knn_query(q, K, n_probe=8)
    d = cos64(q, vecs)
    assert same_up_to_ties(tids, jids, lambda r, i: d[r, i])

    new = tx.add(vecs[:200] + 0.001)
    tx.remove(np.arange(0, N, 2))
    assert tx._router_dirty
    ids, _ = tx.knn_query(vecs[1:400:2], 1, n_probe=32)
    assert not tx._router_dirty
    assert tx._router_index.count == int((tx._h_fill > 0).sum())
    assert (ids[:, 0] == np.arange(1, 400, 2)).mean() > 0.95
    got, _ = tx.knn_query(vecs[:200] + 0.001, 1, n_probe=32)
    assert (got[:, 0] == new).mean() > 0.95


def test_block_tiny_shapes():
    rng = np.random.default_rng(5)
    vecs = rng.random((64, 16), dtype=np.float32)
    ix = T.BlockIndex(16, block_size=4, device="cpu")
    ix.build(vecs)
    ids, dists = ix.knn_query(vecs[:3], k=2, n_probe=ix.n_blocks)
    assert np.array_equal(ids[:, 0], np.arange(3))
    one, _ = ix.knn_query(vecs[0], k=1, n_probe=2)      # a 1-D query
    assert one.shape == (1, 1) and one[0, 0] == 0


def test_block_dynamic_add_remove_update(data):
    vecs, q, _, gt = data
    rng = np.random.default_rng(99)
    ix = T.BlockIndex(DIM, parameters=T.HNSWParameters(random_seed=5),
                      block_size=64, device="cpu")
    ix.build(vecs[:2000])
    assert ix.count == 2000
    new_ids = ix.add(vecs[2000:])
    assert ix.count == N
    assert np.array_equal(new_ids, np.arange(2000, N))
    ids, _ = ix.knn_query(q, k=K, n_probe=16)
    assert overlap(ids, gt) > 0.9

    # the running moments equal a direct recompute, and the append did not
    # shatter into singleton blocks
    for b in range(ix.n_blocks):
        f = int(ix._h_fill[b])
        if f:
            c = ix._h_vecs[b, :f].mean(axis=0)
            r2 = ((ix._h_vecs[b, :f] - c) ** 2).sum(1).mean()
            assert np.abs(ix._h_cents[b] - c).max() < 1e-4
            assert abs(float(ix._h_r2[b]) - r2) < 1e-3
    assert (ix._h_fill == 1).sum() < 50
    # device tables follow the host mirrors
    np.testing.assert_array_equal(ix._blk_ids.numpy(), ix._h_ids)
    np.testing.assert_array_equal(ix._blk_vecs.numpy(), ix._h_vecs)
    np.testing.assert_array_equal(ix._blk_fill.numpy(), ix._h_fill)

    drop = rng.choice(N, 1000, replace=False)
    ix.remove(drop)
    assert ix.count == 2000
    ids2, _ = ix.knn_query(q, k=K, n_probe=16)
    assert not np.isin(ids2[ids2 >= 0], drop).any()
    keep = np.setdiff1d(np.arange(N), drop)
    gt2 = keep[np.argsort(sq64(q, vecs[keep]), axis=1)[:, :K]]
    assert overlap(ids2, gt2) > 0.9

    upd = keep[:50]
    moved = vecs[upd] + 10.0            # far away from everything else
    ix.update(upd, moved)
    assert ix.count == 2000
    ui, ud = ix.knn_query(moved[:8], k=1, n_probe=16)
    assert (ui[:, 0] == upd[:8]).mean() > 0.85
    assert np.nanmax(ud[:, 0]) < 1e-3

    more = ix.add(vecs[:10])
    assert more.min() >= N              # ids are never recycled
    ix.remove([])                       # no-ops
    assert ix.add(np.empty((0, DIM), np.float32)).size == 0


def test_block_dynamic_growth_and_rebuild():
    rng = np.random.default_rng(3)
    base = rng.random((200, DIM), dtype=np.float32)
    ix = T.BlockIndex(DIM, parameters=T.HNSWParameters(random_seed=5),
                      block_size=16, device="cpu")
    ix.build(base)
    nb0 = ix.n_blocks
    extra = rng.random((400, DIM), dtype=np.float32) + 2.0  # far cluster
    eids = ix.add(extra)
    assert ix.count == 600
    assert ix.n_blocks > nb0          # fresh blocks were opened
    assert ix._blk_vecs.shape[0] == ix.n_blocks == ix._cents.shape[0]
    ids, _ = ix.knn_query(extra[:32], k=1, n_probe=16)
    assert (ids[:, 0] == eids[:32]).mean() > 0.9
    assert ix.needs_rebuild()         # count tripled since layout
    ix.rebuild()
    assert ix.count == 600
    assert not ix.needs_rebuild()
    ids2, _ = ix.knn_query(extra[:32], k=1, n_probe=16)
    assert (ids2[:, 0] == eids[:32]).mean() > 0.9


def test_block_size_192(data):
    vecs, q, _, gt = data
    ix = T.BlockIndex(DIM, block_size=192, device="cpu")
    ix.build(vecs)
    ids, _ = ix.knn_query(q, K, n_probe=8)
    assert overlap(ids, gt) > 0.9
    ids2, _ = ix.knn_query(q, K, n_probe=ix.n_blocks)
    assert overlap(ids2, gt) > 0.99


def test_block_serialize_roundtrip(built, data, tmp_path):
    q = data[1]
    path = str(tmp_path / "block.npz")
    built.serialize(path)
    r = T.BlockIndex.deserialize(path, device="cpu")
    a = built.knn_query(q, K, n_probe=32)
    b = r.knn_query(q, K, n_probe=32)
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(a[1], b[1], equal_nan=True)
    assert r.params.random_seed == built.params.random_seed
