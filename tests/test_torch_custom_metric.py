"""Custom metrics: hnswindex_torch against hnswindex_tpu with the same L1
distance registered under one name in both packages (a ``jnp`` callable in
the reference, a torch callable in the port).

Bars:

* the custom branches of ``pairwise``, ``gathered`` (float32 and bfloat16
  candidates) and ``exact``: rtol 1e-6;
* ``heuristic.prune``: the same selections on the same candidates, with
  and without ``fill_to``, also when the port evaluates its (B, N, N) table
  a column at a time;
* the entry scan and ``packed_knn_search`` on the reference's L1 graph
  installed into the port, over the reference's pack entry set: the ids
  equal wherever the float32 rank distances differ by more than 1e-5
  relative (both packages rank by the same bf16-residual points and differ
  only in the order of their float sums), and those distances equal at
  rtol 1e-5;
* a whole build at 600 x 24 (``test_custom_metric.py``'s size) in both
  packages: the same levels, every wave on the beam path, recall@10 within
  0.01 of the reference's, per-layer edge overlap |A & B| / |A | B| >= 0.95
  (measured 1.0 at every layer);
* returned distances equal the callable's at rtol 1e-4; removal on the L1
  graph repairs with beam candidates;
* the guards: ``exact=True``, ``BlockIndex``, the brute-force scans and
  ``register_metric``'s validation raise, an unknown metric raises."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnswindex_torch as T
import hnswindex_tpu as J
import test_torch_heuristic as TTH
from hnswindex_torch import convert
from hnswindex_torch.core import graph as TG
from hnswindex_torch.core import heuristic as TH
from hnswindex_torch.core import pack as TP
from hnswindex_torch.core.graph import dense_tables as t_dense
from hnswindex_torch.ops import bruteforce as TBF
from hnswindex_torch.ops import distance as tdst
from hnswindex_tpu.core import heuristic as JH
from hnswindex_tpu.core import pack as JP
from hnswindex_tpu.core.graph import dense_tables as j_dense
from hnswindex_tpu.ops import distance as jdst

torch.set_num_threads(1)

NAME = "l1_parity"
N, DIM = 600, 24
GAP = 1e-5


def l1_torch(a, b):
    return torch.sum(torch.abs(a - b), dim=-1)


def l1_jax(a, b):
    return jnp.sum(jnp.abs(a - b), axis=-1)


T.register_metric(NAME, l1_torch)
J.register_metric(NAME, l1_jax)


def _params(mod):
    return mod.HNSWParameters(collection_size=N, max_candidates=60,
                              pack_queries="on", random_seed=11)


def corpus():
    return np.random.default_rng(5).random((N, DIM), dtype=np.float32)


def l1_64(q, vecs, ids):
    v = vecs.astype(np.float64)[np.clip(ids, 0, None)]
    d = np.abs(v - q.astype(np.float64)[:, None, :]).sum(-1)
    return np.where(ids >= 0, d, np.inf)


def recall10(ids, q, vecs):
    gt = np.argsort(l1_64(q, vecs, np.broadcast_to(
        np.arange(len(vecs)), (len(q), len(vecs)))), axis=1)[:, :10]
    return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])


@pytest.fixture(scope="module")
def ref():
    """The reference's L1 build of ``corpus()`` and perturbed queries."""
    vecs = corpus()
    ji = J.HNSWIndex(DIM, NAME, _params(J))
    ji.add(vecs)
    rng = np.random.default_rng(6)
    q = (vecs[:64] + 0.02 * rng.standard_normal((64, DIM))).astype(
        np.float32)
    return ji, vecs, q


@pytest.fixture(scope="module")
def port_build():
    ti = T.HNSWIndex(DIM, NAME, _params(T), device="cpu")
    ti.add(corpus())
    return ti


def test_distance_custom_branches():
    rng = np.random.default_rng(3)
    q = rng.random((5, DIM), dtype=np.float32)
    x = rng.random((7, DIM), dtype=np.float32)
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    jq, jx = jnp.asarray(q), jnp.asarray(x)
    tol = dict(rtol=1e-6, atol=0)
    np.testing.assert_allclose(tdst.pairwise(NAME, tq, tx).numpy(),
                               np.asarray(jdst.pairwise(NAME, jq, jx)), **tol)
    np.testing.assert_allclose(tdst.exact(NAME, tq[:, None], tx[None]).numpy(),
                               np.asarray(jdst.exact(NAME, jq[:, None],
                                                     jx[None])), **tol)
    cv = np.broadcast_to(x[None], (5,) + x.shape).copy()
    zero = np.zeros((5,), np.float32)
    got = tdst.gathered(NAME, tq, torch.from_numpy(zero),
                        torch.from_numpy(cv), torch.zeros((5, 7)))
    want = jdst.gathered(NAME, jq, jnp.asarray(zero), jnp.asarray(cv),
                         jnp.zeros((5, 7)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # a bf16 ranking table gives the callable bf16 operands
    got = tdst.gathered(NAME, tq, torch.from_numpy(zero),
                        torch.from_numpy(cv).to(torch.bfloat16),
                        torch.zeros((5, 7)))
    want = jdst.gathered(NAME, jq, jnp.asarray(zero),
                         jnp.asarray(cv, jnp.bfloat16), jnp.zeros((5, 7)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7)
    assert tdst.is_custom(NAME) and not tdst.is_custom("cosine")


@pytest.mark.parametrize("chunk_bytes", [TH.CUSTOM_CHUNK_BYTES, 1])
@pytest.mark.parametrize("fill_to", [0, 6])
def test_prune_custom_selects_reference_ids(fill_to, chunk_bytes,
                                            monkeypatch):
    """``chunk_bytes=1`` evaluates one candidate column at a time."""
    monkeypatch.setattr(TH, "CUSTOM_CHUNK_BYTES", chunk_bytes)
    cand, _, cvecs, _, force = TTH._inputs("sq_euclid", seed=13)
    rng = np.random.default_rng(13)
    targets = rng.random((cand.shape[0], cvecs.shape[2]), dtype=np.float32)
    cd = np.abs(cvecs - targets[:, None]).sum(-1, dtype=np.float32)
    cd = np.where(cand >= 0, cd, np.inf).astype(np.float32)
    cn = np.zeros(cand.shape, np.float32)
    js, jc = JH.prune(NAME, jnp.asarray(cand), jnp.asarray(cd),
                      jnp.asarray(cvecs), jnp.asarray(cn), 8,
                      force_mask=jnp.asarray(force), fill_to=fill_to)
    ts, tc = TH.prune(NAME, torch.from_numpy(cand), torch.from_numpy(cd),
                      torch.from_numpy(cvecs), torch.from_numpy(cn), 8,
                      force_mask=torch.from_numpy(force), fill_to=fill_to)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _agree(tids, td, jids, jd):
    """Ids equal except where the two rank distances are within GAP
    relative of each other; distances equal at rtol GAP."""
    same = tids == jids
    tie = np.isclose(td, jd, rtol=GAP, atol=0) | (~np.isfinite(td)
                                                  & ~np.isfinite(jd))
    assert (same | tie).all()
    assert same.mean() >= 0.99
    np.testing.assert_allclose(td, jd, rtol=GAP, atol=1e-6)


@pytest.fixture(scope="module")
def packs(ref):
    ji, vecs, q = ref
    jp = ji._get_pack()
    assert jp is not None
    leaves = {f: np.asarray(getattr(ji._state, f)) for f in convert.FIELDS}
    tcfg = TG.GraphConfig(**dataclasses.asdict(ji._cfg))
    tstate = convert.state_from_numpy(leaves, tcfg, "cpu")
    tp = TP.make_query_pack(tcfg, tstate,
                            torch.from_numpy(np.array(jp.entry_ids)))
    return ji, jp, tcfg, tp, q


def test_entry_scan_custom_matches_reference(packs):
    ji, jp, tcfg, tp, q = packs
    R = min(8, tp.entry_ids.shape[0])
    td, ti = TP._entry_scan_custom(NAME, tp, torch.from_numpy(q), R)
    jd, jids = JP._entry_scan_custom(NAME, jp, jnp.asarray(q), R)
    _agree(ti.numpy(), td.numpy(), np.asarray(jids), np.asarray(jd))


@pytest.mark.parametrize("ef", [10, 32])
def test_packed_search_custom_matches_reference(packs, ef):
    ji, jp, tcfg, tp, q = packs
    td, ti = TP.packed_knn_search(tcfg, tp, torch.from_numpy(q), ef,
                                  8 * ef + 16, expand=4, n_entry=8)
    jd, jids = JP.packed_knn_search(ji._cfg, jp, jnp.asarray(q), ef,
                                    8 * ef + 16, expand=4, n_entry=8)
    _agree(ti.numpy(), td.numpy(), np.asarray(jids), np.asarray(jd))


def _overlap(tn, tdg, jn, jdg, layer, rows):
    ea = {(u, int(v)) for u in rows for v in tn[layer, u, :tdg[layer, u]]}
    eb = {(u, int(v)) for u in rows for v in jn[layer, u, :jdg[layer, u]]}
    return len(ea & eb) / len(ea | eb) if ea | eb else 1.0


def test_build_matches_reference(ref, port_build):
    """Every wave after the seed takes the beam path; the same levels,
    recall@10 within 0.01, per-layer edge overlap >= 0.95."""
    ji, vecs, q = ref
    ti = port_build
    assert ti.wave_counts["exact"] == 0 and ti.wave_counts["beam"] > 0
    assert ti._state.coarse.shape[0] == 0 and ti._state.coarse_table is None
    assert ti._upper_cnt == 0                   # no upper-node panel
    np.testing.assert_array_equal(ti._state.level.numpy(),
                                  np.asarray(ji._state.level))
    tn, tdg = t_dense(ti._state)
    jn, jdg = j_dense(ji._state)
    rows = np.arange(N)
    for layer in range(tn.shape[0]):
        assert _overlap(tn, tdg, jn, jdg, layer, rows) >= 0.95, layer
    rec = {"torch": recall10(ti.knn_query(q, 10)[0], q, vecs),
           "jax": recall10(ji.knn_query(q, 10)[0], q, vecs)}
    assert ti._pack is not None
    assert abs(rec["torch"] - rec["jax"]) <= 0.01, rec
    assert rec["torch"] > 0.9, rec


def test_returned_distances_are_the_callables(ref, port_build):
    _, vecs, q = ref
    ids, d = port_build.knn_query(q[:20], 5)
    np.testing.assert_allclose(d, l1_64(q[:20], vecs, ids), rtol=1e-4)
    assert (np.diff(d, axis=1) >= 0).all()


def test_range_query_custom(ref, port_build):
    """Without a count the pools climb the ladder; the answer is the
    brute-force in-radius set, and the exact overflow scan agrees."""
    _, vecs, q = ref
    ti = port_build
    d = l1_64(q[:8], vecs, np.broadcast_to(np.arange(N), (8, N)))
    radius = float(np.median(np.sort(d, axis=1)[:, 9]))
    ids, dists = ti.range_query(q[:8], radius)
    for r in range(8):
        truth = set(np.flatnonzero(d[r] <= radius).tolist())
        assert set(ids[r].tolist()) <= truth
        assert len(ids[r]) >= 0.9 * len(truth)
        assert (np.diff(dists[r]) >= 0).all()
        eid, ed = ti._range_exact_host(q[r], radius)
        assert set(eid.tolist()) == truth
        np.testing.assert_allclose(ed, d[r][eid], rtol=1e-5)


def test_callable_filter_makes_no_exact_escalation(ref, port_build):
    _, vecs, q = ref
    ids, _ = port_build.knn_query(q[:16], 5, exact=True,
                                  filter_fnc=lambda v: v[..., 0] > 0.5)
    assert (vecs[ids[ids >= 0], 0] > 0.5).all()


def test_removal_on_custom_graph_repairs_with_beam_candidates(port_build):
    """50 ids ("fast" repair) removed from a copy of the port's L1 index:
    no live edge into them, the rest found as well as before."""
    vecs = corpus()
    ti = copy.deepcopy(port_build)
    rem = np.arange(0, N, 12)
    keep = np.setdiff1d(np.arange(N), rem)
    pre = (ti.knn_query(vecs[keep], 1)[0][:, 0] == keep).mean()
    ti.remove(rem)
    st = ti._state
    assert ti.count == N - rem.size and not st.active[rem].any()
    nbr, deg = t_dense(st)
    live = np.flatnonzero(st.active.numpy())
    for layer in range(nbr.shape[0]):
        e = nbr[layer, live]
        assert not np.isin(e[e >= 0], rem).any()
    post = (ti.knn_query(vecs[keep], 1)[0][:, 0] == keep).mean()
    assert post >= 0.98 * pre, (pre, post)


def test_guards():
    vecs = corpus()[:64]
    ti = T.HNSWIndex(DIM, NAME, T.HNSWParameters(collection_size=64),
                     device="cpu")
    ti.add(vecs)
    with pytest.raises(ValueError):
        ti.knn_query(vecs[:2], 2, exact=True)
    with pytest.raises(ValueError):
        T.BlockIndex(DIM, NAME, device="cpu")
    st = ti._state
    qt = torch.from_numpy(vecs[:2])
    for call in (
            lambda: TBF.exact_knn(NAME, st.vectors, st.norms, st.active, qt,
                                  2),
            lambda: TBF.exact_knn2(NAME, st.vectors, st.vectors, st.norms,
                                   st.active, qt, 2),
            lambda: TBF.range_count(NAME, st.vectors, st.norms, st.active,
                                    qt, 1.0),
            lambda: TBF.range_distances(NAME, st.vectors, st.norms,
                                        st.active, qt[0], 1.0)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError):
        T.register_metric("cosine", l1_torch)
    with pytest.raises(TypeError):
        T.register_metric("not_callable", 42)
    with pytest.raises(ValueError):
        T.HNSWIndex(DIM, "never_registered", device="cpu")
    with pytest.raises(ValueError):
        T.Index(DIM, "never_registered", device="cpu")
    assert TP.entry_scan_cap(NAME) == TP.ENTRY_SCAN_MAX_CUSTOM
