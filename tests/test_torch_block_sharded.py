"""Sharded block index parity: hnswindex_torch's ``ShardedBlockIndex`` on
``["cpu"] * S`` against hnswindex_tpu's on ``jax.devices()[:S]`` and the
port's single-chip ``BlockIndex``, for S = 2 and 3.

The reference is built on the 1,500 x 16 clustered corpus of
``test_torch_sharded`` at 32-row blocks, and its global layout is installed
into the port's two classes (``_install``), so routing, dealing and scoring
are compared apart from k-means.

Bars:

* each shard's device tables hold global blocks s, s + S, ...; the local
  probe tables give each shard exactly the probes it owns;
* ``knn_query(k=10, n_probe=8)``: ids equal the reference's and the
  single-chip ``BlockIndex``'s wherever the float64 distance gap exceeds
  1e-5 (``test_torch_block.same_up_to_ties``), distances within 1e-5; at
  ``n_probe = n_blocks`` the ids are the brute-force top-10;
* one shard's K2 panel (here its plain version) selects the same top-10 as
  the plain ``block._score_blocks`` on the same local probes;
* add, remove (unknown ids ignored) and update on copies of both:
  identical ids, block tables, fills and counts, and answers equal as
  above; ``rebuild`` keeps every live id and the count, and full-probe
  answers stay exact;
* a ``.npz`` written by either package is read by the other: the same
  layout and the same answers."""

import copy

import jax
import numpy as np
import pytest
import torch

import test_torch_block as TTB
import test_torch_sharded as TTSH
from hnswindex_torch import block as TB
from hnswindex_torch.ops import distance as tdst
from hnswindex_torch.parallel.block_sharded import ShardedBlockIndex as TSB
from hnswindex_tpu.parallel.block_sharded import ShardedBlockIndex as JSB

torch.set_num_threads(1)

BS = 32
K = 10
N_PROBE = 8


def _port_pair(ji, vecs):
    S = ji.n_shards
    ti = TSB(ji.dim, block_size=BS, devices=["cpu"] * S)
    ti._install(ji._h_ids.copy(), ji._h_vecs.copy(), next_id=vecs.shape[0])
    bi = TB.BlockIndex(ji.dim, block_size=BS, device="cpu")
    bi._install(ji._h_ids.copy(), ji._h_vecs.copy(), next_id=vecs.shape[0])
    return ti, bi


@pytest.fixture(scope="module", params=[2, 3], ids=["S2", "S3"])
def layout(request):
    S = request.param
    vecs = TTSH.corpus()
    ji = JSB(TTSH.DIM, block_size=BS, devices=jax.devices()[:S])
    ji.build(vecs)
    ti, bi = _port_pair(ji, vecs)
    return vecs, TTSH.queries(vecs), ji, ti, bi


def _d64(q, x):
    return lambda r, g: float(((q[r].astype(np.float64)
                                - x[g].astype(np.float64)) ** 2).sum())


def _same(q, x, got, want):
    (gi, gd), (wi, wd) = got, want
    assert TTB.same_up_to_ties(gi, wi, _d64(q, x))
    same = gi == wi
    np.testing.assert_allclose(gd[same], wd[same], rtol=1e-5, atol=1e-5)


def test_tables_are_dealt_round_robin(layout):
    _, q, ji, ti, _ = layout
    S = ji.n_shards
    assert ti.n_blocks == ji.n_blocks and ti.n_blocks % S == 0
    for s in range(S):
        np.testing.assert_array_equal(ti._blk_ids[s].numpy(),
                                      ji._h_ids[s::S])
        np.testing.assert_array_equal(np.asarray(ji._blk_ids)[s],
                                      ti._blk_ids[s].numpy())
    gb = TB._route_exact(ti.metric, ti._cents, ti._cent_norms,
                         torch.as_tensor(q), N_PROBE, ti._cent_valid)
    owned = []
    for s in range(S):
        local = ti._shard_probes(gb, s).numpy()
        for r in range(q.shape[0]):
            want = sorted(int(g) // S for g in gb[r].tolist() if g % S == s)
            got = sorted(int(x) for x in local[r] if x >= 0)
            assert got == want
            owned.append(len(got))
    assert sum(owned) == q.shape[0] * N_PROBE


def test_knn_query_matches_reference_and_block_index(layout):
    vecs, q, ji, ti, bi = layout
    want = ji.knn_query(q, K, n_probe=N_PROBE)
    got = ti.knn_query(q, K, n_probe=N_PROBE)
    _same(q, vecs, got, want)
    _same(q, vecs, got, bi.knn_query(q, K, n_probe=N_PROBE))
    full, _ = ti.knn_query(q, K, n_probe=ti.n_blocks)
    gt = np.argsort(TTB.sq64(q, vecs), axis=1)[:, :K]
    assert TTB.same_up_to_ties(full, gt, _d64(q, vecs))


def test_shard_panel_matches_plain_scoring(layout):
    vecs, q, ji, ti, _ = layout
    S = ji.n_shards
    qt = torch.as_tensor(q)
    gb = TB._route_exact(ti.metric, ti._cents, ti._cent_norms, qt, N_PROBE,
                         ti._cent_valid)
    for s in range(S):
        local = ti._shard_probes(gb, s)
        bv = ti._blk_vecs[s]
        _, pid = TB._score_blocks_panel(ti.metric, bv, ti._blk_ids[s],
                                        ti._blk_fill[s], qt, local, K)
        norms = tdst.norm_data(ti.metric, bv.reshape(-1, bv.shape[-1])) \
            .reshape(bv.shape[:2])
        _, rid = TB._score_blocks(ti.metric, bv, ti._blk_ids[s], norms, qt,
                                  local, K)
        x = vecs
        # the panel is oversampled (2k wide): its first k are the plain top-k
        assert TTB.same_up_to_ties(pid[:, :K].numpy(), rid.numpy(),
                                   _d64(q, x))


def _clone_ref(ji):
    jc = JSB(ji.dim, block_size=BS, devices=list(ji.mesh.devices))
    jc._install(ji._h_ids.copy(), ji._h_vecs.copy(), ji._host_vecs.copy())
    return jc


def _same_tables(ti, ji):
    np.testing.assert_array_equal(ti._h_ids, ji._h_ids)
    np.testing.assert_array_equal(ti._h_fill, ji._h_fill)
    np.testing.assert_array_equal(ti._id_to_pos, ji._id_to_blk)
    assert ti.count == ji.count and ti.n_blocks == ji.n_blocks
    S = ji.n_shards
    for s in range(S):
        np.testing.assert_array_equal(ti._blk_ids[s].numpy(),
                                      ti._h_ids[s::S])
        np.testing.assert_array_equal(ti._blk_fill[s].numpy(),
                                      ti._h_fill[s::S])


def test_dynamics_match_reference(layout):
    vecs, q, ji0, _, _ = layout
    ji = _clone_ref(ji0)
    ti, _ = _port_pair(ji, vecs)
    rng = np.random.default_rng(21)
    new = (vecs[:120] + 3.0).astype(np.float32)      # a new cluster
    np.testing.assert_array_equal(ti.add(new), ji.add(new))
    _same_tables(ti, ji)
    rem = np.concatenate([rng.choice(vecs.shape[0], 100, replace=False),
                          [-3, 10 ** 6]])
    ji.remove(rem)
    ti.remove(rem)
    _same_tables(ti, ji)
    upd = rng.choice(np.flatnonzero(ji._live), 40, replace=False)
    moved = (vecs[upd % vecs.shape[0]] + 0.01).astype(np.float32)
    ji.update(upd, moved)
    ti.update(upd, moved)
    _same_tables(ti, ji)
    assert ti.needs_rebuild() == ji.needs_rebuild()
    qq = np.concatenate([q, new[:20], moved[:20]])
    x = ji._host_vecs                 # the reference's corpus, updated
    _same(qq, x, ti.knn_query(qq, K, n_probe=N_PROBE),
          ji.knn_query(qq, K, n_probe=N_PROBE))
    back, _ = ti.knn_query(vecs[rem[:50]], K, n_probe=N_PROBE)
    assert not np.isin(back, rem[:100]).any()
    live = ti._id_to_pos >= 0
    np.testing.assert_array_equal(live, ji._live)
    count = ti.count
    ti.rebuild()
    assert ti.count == count
    np.testing.assert_array_equal(ti._id_to_pos >= 0, live)
    got, _ = ti.knn_query(qq, K, n_probe=ti.n_blocks)
    d = np.where(live[None, :], TTB.sq64(qq, x), np.inf)
    assert TTB.same_up_to_ties(got, np.argsort(d, axis=1)[:, :K],
                               _d64(qq, x))


def test_snapshots_cross_packages(layout, tmp_path):
    vecs, q, ji, ti, _ = layout
    devs = ["cpu"] * ji.n_shards
    ji.serialize(str(tmp_path / "ref"))
    ti.serialize(str(tmp_path / "port"))
    t_from_ref = TSB.deserialize(str(tmp_path / "ref"), devices=devs)
    j_from_port = JSB.deserialize(str(tmp_path / "port.npz"),
                                  devices=list(ji.mesh.devices))
    _same_tables(t_from_ref, ji)
    _same_tables(ti, j_from_port)
    want = ti.knn_query(q, K, n_probe=N_PROBE)
    for got in (t_from_ref.knn_query(q, K, n_probe=N_PROBE),):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    _same(q, vecs, ti.knn_query(q, K, n_probe=N_PROBE),
          j_from_port.knn_query(q, K, n_probe=N_PROBE))


def test_custom_metric_and_unbuilt_are_refused():
    name = "l1_block_sharded_test"
    from hnswindex_torch import register_metric
    register_metric(name, lambda a, b: torch.sum(torch.abs(a - b), dim=-1))
    with pytest.raises(ValueError, match="dot-decomposable"):
        TSB(8, name, devices=["cpu"])
    ix = TSB(8, devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="build"):
        ix.knn_query(np.zeros((1, 8), np.float32), 1)
    copy.copy(ix)
