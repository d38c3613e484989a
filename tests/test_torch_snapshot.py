"""Snapshots: hnswindex_torch's three formats against hnswindex_tpu's.

* ``.npz`` (``serialize``/``deserialize``): a file written by either
  package loads in the other with equal state arrays and free list, and the
  loaded index answers ``knn_query`` with identical ids and distances to
  the index that wrote it; a path given without the extension round-trips;
  a metric that is not registered fails at load; an ``add`` after a load
  gives the same ids and levels in both packages (the level RNG is
  re-seeded, the upper-node panel rebuilt).
* The reference's protobuf-net stream (``to_reference_snapshot``): the
  port's bytes equal the reference's on the same graph, after a removal
  too; reading them back and writing again gives the same bytes.  The
  export re-prunes layer-0 rows over the 2M cap, and that prune meets the
  same float32 near-ties as the build's (test_torch_construct: edge
  overlap 0.998), so the byte test runs on the graph with those rows
  re-pruned by the reference, and the re-prune is held to the reference's
  on its own (the same edge sets on >= 0.95 of the rows).  The
  golden fixture loads as ``test_reference_snapshot`` expects.  The
  port's codec encodes a synthetic snapshot (negative ints, empty lists,
  removed nodes) to the reference's bytes, and parses packed encodings
  and the golden stream as the reference does.
* The native host engine's file (``from_host_snapshot``): the same state
  through both packages (norms, which each package computes, at rtol
  1e-6), and the same answers up to near-tie swaps.

The graphs are the reference's 2,000 x 128 build (test_torch_construct)
installed into the port, and a 400-row host-engine build."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnswindex_torch as T
import hnswindex_tpu as J
import test_torch_construct as TCT
import test_torch_remove as TTR
import test_torch_search as TTS
from hnswindex_torch import convert
from hnswindex_torch.core import refsnap as TRS
from hnswindex_torch.core import snapshot as TSN
from hnswindex_tpu.core import refsnap as JRS

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def pair():
    ji = TCT.jax_build()._impl
    q = TCT.corpus()[:64] + 0.02 * np.random.default_rng(3).standard_normal(
        (64, TCT.DIM)).astype(np.float32)
    return ji, TTS.installed(ji), q


def _leaves(ix):
    st = ix._state
    if isinstance(st.vectors, torch.Tensor):
        return convert.state_to_numpy(st)
    return {f: np.asarray(getattr(st, f)) for f in convert.FIELDS}


def _same_state(a, b, norms_rtol=0.0):
    """Equal state arrays and host mirrors; ``norms_rtol`` for norms that
    each package computed itself (their float sums differ in order)."""
    la, lb = _leaves(a), _leaves(b)
    for f in convert.FIELDS:
        x, y = (np.asarray(v[f], np.float32) if v[f].dtype.name == "bfloat16"
                else v[f] for v in (la, lb))
        if f == "norms" and norms_rtol:
            np.testing.assert_allclose(x, y, rtol=norms_rtol)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert list(a._free) == list(b._free)
    assert (a._length, a._count_host) == (b._length, b._count_host)


def _same_answers(a, b, q):
    ia, da = a.knn_query(q, 10)
    ib, db = b.knn_query(q, 10)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da, db)


def test_port_npz_loads_in_reference(pair, tmp_path):
    ji, ti, q = pair
    path = str(tmp_path / "port.npz")
    ti.serialize(path)
    jl = J.HNSWIndex.deserialize(path)
    _same_state(jl, ji)
    _same_answers(jl, ji, q)


def test_reference_npz_loads_in_port(pair, tmp_path):
    ji, ti, q = pair
    path = str(tmp_path / "ref")
    ji.serialize(path)                      # no extension: ".npz" added
    assert os.path.exists(path + ".npz")
    tl = T.HNSWIndex.deserialize(path, device="cpu")
    _same_state(tl, ti)
    assert tl._cfg == ti._cfg and tl.params == ti.params
    _same_answers(tl, ti, q)
    idx = T.Index.deserialize(path, device="cpu")
    assert idx.count == TCT.N and idx._impl._cfg == ti._cfg


def test_npz_after_removal_round_trips(pair, tmp_path):
    """Removed rows, the free list and the repaired edges are in the file;
    an add after the load takes the freed slots in both packages, with the
    same levels."""
    ji0, _, q = pair
    ti = TTS.installed(ji0)
    ti.remove(np.arange(0, 400, 7))
    path = str(tmp_path / "churned.npz")
    ti.serialize(path)
    tl = T.HNSWIndex.deserialize(path, device="cpu")
    jl = J.HNSWIndex.deserialize(path)
    _same_state(tl, ti)
    _same_state(jl, ti)
    _same_answers(tl, ti, q)
    fresh = TCT.corpus()[:8] + 0.01
    tid, jid = tl.add(fresh), jl.add(fresh)
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_array_equal(tid, np.arange(0, 400, 7)[::-1][:8])
    np.testing.assert_array_equal(tl._state.level.numpy(),
                                  np.asarray(jl._state.level))
    assert sorted(tl._upper_pos) == sorted(jl._upper_pos)


def test_add_after_load_matches_reference(pair, tmp_path):
    ji, ti, _ = pair
    path = str(tmp_path / "fresh.npz")
    ji.serialize(path)
    tl = T.HNSWIndex.deserialize(path, device="cpu")
    jl = J.HNSWIndex.deserialize(path)
    assert tl._upper_cnt == -1
    fresh = TCT.corpus()[:8] + 0.01
    tid, jid = tl.add(fresh), jl.add(fresh)
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_array_equal(tl._state.level.numpy(),
                                  np.asarray(jl._state.level))
    np.testing.assert_array_equal(tl._upper_np[:tl._upper_cnt],
                                  np.asarray(jl._upper_ids)[:jl._upper_cnt])


def test_unregistered_metric_fails_at_load(tmp_path):
    name = "l1_snapshot_only"
    T.register_metric(name, lambda a, b: torch.sum(torch.abs(a - b), dim=-1))
    vecs = np.random.default_rng(2).random((64, 8), dtype=np.float32)
    ti = T.HNSWIndex(8, name, T.HNSWParameters(collection_size=64),
                     device="cpu")
    ti.add(vecs)
    path = str(tmp_path / "custom.npz")
    ti.serialize(path)
    tl = T.HNSWIndex.deserialize(path, device="cpu")
    _same_answers(tl, ti, vecs[:8])
    T.ops.distance._CUSTOM_METRICS.pop(name)
    with pytest.raises(ValueError, match="unknown metric"):
        T.HNSWIndex.deserialize(path, device="cpu")


def _ref_bytes(ix, path):
    ix.to_reference_snapshot(path)
    with open(path, "rb") as f:
        return f.read()


def _with_state(ji0, ti):
    """A copy of the reference index ``ji0`` holding ``ti``'s tables and
    host mirrors."""
    ji = TTR.jax_clone(ji0)
    leaves = convert.state_to_numpy(ti._state)
    ji._state = ji._state._replace(
        **{f: jnp.asarray(leaves[f]) for f in convert.FIELDS})
    ji._count_host, ji._free = ti._count_host, list(ti._free)
    return ji


@pytest.fixture(scope="module")
def capped(pair):
    """The pair's graph with its layer-0 rows over the 2M cap (the
    ``reverse_slack`` columns) re-pruned by the reference, in both
    packages, so that neither export re-prunes; and the over-cap rows."""
    from hnswindex_tpu.core.construct import normalize_base_rows
    ji0, _, _ = pair
    st = ji0._state
    over = np.flatnonzero(np.asarray(st.deg0) > 2 * ji0.params.max_edges
                          ).astype(np.int32)
    assert over.size
    nbr0, deg0 = normalize_base_rows(ji0._cfg, st.vlo, st.norms,
                                     st.nbr0 + 0, st.deg0 + 0, over)
    ji = TTR.jax_clone(ji0)
    ji._state = ji._state._replace(nbr0=nbr0, deg0=deg0)
    return ji, TTS.installed(ji), over


def test_reference_snapshot_bytes_equal(capped, pair, tmp_path):
    ji, ti, _ = capped
    tb = _ref_bytes(ti, str(tmp_path / "t.bin"))
    assert tb == _ref_bytes(ji, str(tmp_path / "j.bin"))
    tl = T.HNSWIndex.from_reference_snapshot(str(tmp_path / "t.bin"),
                                             device="cpu")
    assert _ref_bytes(tl, str(tmp_path / "t2.bin")) == tb
    assert tl.count == ti.count
    np.testing.assert_array_equal(tl._state.level.numpy(),
                                  ti._state.level.numpy())
    q = pair[2]
    ids, _ = tl.knn_query(q, 10)
    gt = TTS.d64("sq_euclid", q, TCT.corpus(), np.broadcast_to(
        np.arange(TCT.N), (len(q), TCT.N))).argsort(1)[:, :10]
    assert np.mean([len(set(a) & set(b)) / 10
                    for a, b in zip(ids, gt)]) > 0.9


def test_reference_snapshot_bytes_equal_after_removal(capped, tmp_path):
    ji0, ti0, _ = capped
    ti = TTS.installed(ji0)
    ti.remove(np.arange(5, 300, 11))
    assert int(ti._state.deg0.max()) <= 2 * ti.params.max_edges
    assert _ref_bytes(ti, str(tmp_path / "t.bin")) == \
        _ref_bytes(_with_state(ji0, ti), str(tmp_path / "j.bin"))


def test_export_reprune_matches_reference(pair, capped):
    """``normalize_base_rows`` on the over-cap rows of the uncapped graph,
    against the reference's: every row at most 2M edges drawn from its own
    row, the same edge sets on >= 0.95 of the rows and directed-edge
    overlap >= 0.99 (measured: 91 of 93 rows the same set, 80 in the same
    order, overlap 0.9991; each difference a float32 near-tie of the
    prune, as in the build)."""
    from hnswindex_torch.core import construct as TC
    _, ti0, _ = pair
    _, ti_ref, over = capped
    st = ti0._state
    nbr0, deg0 = st.nbr0.clone(), st.deg0.clone()
    TC.normalize_base_rows(ti0._cfg, st.vlo, st.norms, nbr0, deg0, over)
    assert int(deg0.max()) <= 2 * ti0.params.max_edges
    got = [set(nbr0[r, :deg0[r]].tolist()) for r in over]
    want = [set(ti_ref._state.nbr0[r, :ti_ref._state.deg0[r]].tolist())
            for r in over]
    for r, g in zip(over, got):
        assert g <= set(st.nbr0[r, :st.deg0[r]].tolist())
    assert np.mean([a == b for a, b in zip(got, want)]) >= 0.95
    both = sum(len(a & b) for a, b in zip(got, want))
    assert both / sum(len(a | b) for a, b in zip(got, want)) >= 0.99


def test_golden_fixture_loads():
    """The golden stream (an independent protobuf codec's bytes) loads as
    test_reference_snapshot.test_golden_fixture_bytes expects."""
    blob = os.path.join(FIXTURES, "refsnap_golden.bin")
    exp = np.load(os.path.join(FIXTURES, "refsnap_golden_expected.npz"))
    with open(blob, "rb") as f:
        snap = TRS.parse_snapshot(f.read())
    assert snap.count == int(exp["count"])
    assert sorted(snap.removed) == exp["free"].tolist()
    assert snap.entry_point == int(exp["ep"])
    idx = T.HNSWIndex.from_reference_snapshot(blob, device="cpu")
    assert idx.count == int(exp["count"])
    gi, gd = idx.knn_query(exp["queries"], k=5)
    np.testing.assert_array_equal(gi, exp["ids"])
    np.testing.assert_allclose(gd, exp["dists"], rtol=1e-6, equal_nan=True)


def _synthetic(mod):
    rng = np.random.default_rng(9)
    nodes = []
    for i in range(50):
        outs = [rng.integers(-3, 1 << 20, rng.integers(0, 9)).astype(
            np.int32) for _ in range(1 + (i % 3 == 0))]
        ins = [rng.integers(0, 2 ** 31 - 1, rng.integers(0, 5)).astype(
            np.int32) for _ in outs]
        nodes.append(mod.RefNode(id=i - 2, is_removed=i % 7 == 0,
                                 out_edges=outs, in_edges=ins))
    items = [rng.standard_normal(6).astype(np.float32) for _ in range(50)]
    params = (T if mod is TRS else J).HNSWParameters(random_seed=-5)
    return mod.RefSnapshot(params=params, nodes=nodes, items=items,
                           active=np.arange(-1, 40, dtype=np.int32),
                           removed=[3, -1, 0], entry_point=-1,
                           capacity=64, length=50, count=41)


@pytest.mark.parametrize("ragged", [False, True])
def test_codec_bytes_and_parse_equal_reference(ragged):
    """Same bytes as the reference's writer (items of one width go through
    the port's array path, ragged ones through its per-item path), and the
    same parse."""
    ts, js = _synthetic(TRS), _synthetic(JRS)
    if ragged:
        ts.items[3] = js.items[3] = np.zeros(2, np.float32)
    data = TRS.encode_snapshot(ts)
    assert data == JRS.encode_snapshot(js)
    got, want = TRS.parse_snapshot(data), JRS.parse_snapshot(data)
    for a, b in zip(got.nodes, want.nodes):
        assert (a.id, a.is_removed) == (b.id, b.is_removed)
        for x, y in zip(a.out_edges + a.in_edges, b.out_edges + b.in_edges):
            assert x.dtype == np.int32
            np.testing.assert_array_equal(x, y)
    for x, y in zip(got.items, want.items):
        np.testing.assert_array_equal(x, y)
    assert got.removed == want.removed and got.entry_point == -1
    np.testing.assert_array_equal(got.active, want.active)
    assert vars(got.params) == vars(want.params)


def test_codec_reads_packed_and_slack_encodings():
    """Packed repeated fields and a buffer longer than its count take the
    field-by-field parser and read as the reference reads them."""
    import struct
    edge = JRS._enc_msg(1, b"".join(JRS._varint(v) for v in (5, 9, 7))) \
        + JRS._enc_int(2, 2)
    node = JRS._enc_int(1, 4) + JRS._enc_msg(3, edge) \
        + JRS._enc_msg(3, JRS._enc_rep_int(1, [1, 2, 3]) + JRS._enc_int(2, 1))
    item = JRS._enc_msg(1, b"".join(struct.pack("<f", v)
                                    for v in (1.5, -2.0)))
    gd = JRS._enc_msg(1, node) + JRS._enc_msg(3, item) \
        + JRS._enc_msg(2, b"".join(JRS._varint(v) for v in (4, 6)))
    data = JRS._enc_msg(1, b"") + JRS._enc_msg(2, gd)
    got, want = TRS.parse_snapshot(data), JRS.parse_snapshot(data)
    assert [e.tolist() for e in got.nodes[0].out_edges] == [[5, 9], [1]]
    assert [e.tolist() for e in got.nodes[0].out_edges] == \
        [e.tolist() for e in want.nodes[0].out_edges]
    assert got.items[0].tolist() == [1.5, -2.0]
    assert got.active.tolist() == want.active.tolist() == [4, 6]


def test_host_snapshot_same_state_in_both_packages(tmp_path):
    from hnswindex_tpu.native.host_engine import HostIndex
    vecs = np.random.default_rng(8).random((400, 16), dtype=np.float32)
    host = HostIndex(16)
    host.set_collection_size(512)
    host.add(vecs)
    host.remove(np.arange(10, 40))
    path = str(tmp_path / "host.bin")
    host.serialize(path)
    tl = T.HNSWIndex.from_host_snapshot(path, device="cpu")
    jl = J.HNSWIndex.from_host_snapshot(path)
    _same_state(tl, jl, norms_rtol=1e-6)
    assert tl._cfg == T.HNSWIndex(16, "sq_euclid", tl.params,
                                  device="cpu")._cfg
    np.testing.assert_array_equal(tl._upper_np[:tl._upper_cnt],
                                  np.asarray(jl._upper_ids)[:jl._upper_cnt])
    # the host engine builds with threads, so its graph varies from run to
    # run: the two imports are held to each other, not to a recall bar
    q = vecs[40:140]
    tids, _ = tl.knn_query(q, 5)
    jids, _ = jl.knn_query(q, 5)
    TTS.assert_same_ids("sq_euclid", q, vecs, tids, jids)
    assert TSN.npz_path("x") == "x.npz" and TSN.npz_path("x.npz") == "x.npz"
