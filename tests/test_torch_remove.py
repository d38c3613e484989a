"""Removal parity: hnswindex_torch's ``remove``, slot reuse and ``update``
against hnswindex_tpu's, on the reference's 2,000 x 128 build
(test_torch_construct) installed into both packages.

The churn fixture removes the same 200 ids (10% of the index: "auto"
resolves to "high"; the entry point among them) from both, adds 8 fresh
rows (they take the freed slots, last freed first) and updates 8
surviving rows (its inner removal resolves to "fast").  Bars:

* ``active``, ``count``, ``ep``, the free list and every level identical
  after each step; the ids of the add identical;
* the repaired rows (active rows that had an out-edge into the removed
  set): their directed edges overlap the reference's at >= 0.99
  (|A & B| / |A | B|, per layer; measured 0.9988 at layer 0, 1.0 above),
  and their edge sets are equal row for row on >= 0.99 of the rows at
  every layer (measured 0.9914 at layer 0, 1.0 above).  Row equality sits
  close to the float noise: a row differs when the heuristic's accept
  test meets a float32 near-tie among its ~400 candidates, so a change to
  the order of the prune's float sums moves it first;
* the post/pre self-recall ratio of the surviving rows within 0.01 of the
  reference's;
* after the update, per-layer edge overlap >= 0.99 over the whole graph,
  the upper-node panel equal to the reference's, position for position,
  and the updated rows found by their new vectors (recall@1 at the
  default ef) as often as in the reference, within one of the 8 rows.

The engine pieces: ``mark_removed``'s three entry-point cases give the same
``ep``, ``count`` and ``active``; ``affected_masks_all`` gives the same
masks; ``exact_repair_candidates`` and the beam form ``repair_candidates``
give the same ids up to near-tie swaps (test_torch_search's float64 rule).

Port-only (no jax): the reference's bulk-delete drift bar at its own sizes
(post >= 0.98 x pre, test_removal.py:274-342), removing every row then
adding, removing the entry point, repeated ids, disabled removals, update
validation, the pack's ``no_entry`` refusal, a beam repair's invariants,
and the panel's membership after add, remove and update."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnswindex_torch as T
import test_torch_construct as TCT
import test_torch_search as TTS
from hnswindex_torch.core import remove as TR
from hnswindex_torch.core.graph import dense_tables as t_dense
from hnswindex_tpu.core import remove as JR
from hnswindex_tpu.core.graph import dense_tables as j_dense

torch.set_num_threads(1)

N = TCT.N
N_REM = 200
#: 8 rows take the reference's smallest wave and removal buckets, whose
#: programs test_torch_index's remove and update cases compile too
N_ADD = 8
N_UPD = 8
#: the reference pads a 200-id wave to this bucket; the direct engine
#: calls below use the same shape, so they share its compiled programs
REM_BUCKET = 512


def jax_clone(ji):
    """An independent copy of the reference index ``ji`` (its state
    arrays, free list, RNG and panel map copied)."""
    c = copy.copy(ji)
    c._state = jax.tree_util.tree_map(jnp.array, ji._state)
    c._rng = copy.deepcopy(ji._rng)
    c._free = list(ji._free)
    c._upper_pos = dict(ji._upper_pos)
    c._pack = c._block_fb = c._host_vectors = None
    return c


def _self_recall(ix, vecs, ids):
    return float((ix.knn_query(vecs[ids], 1)[0][:, 0] == ids).mean())


def _snap(ix, dense):
    st = ix._state
    nbr, deg = dense(st)
    return dict(active=np.asarray(st.active).copy(), ep=int(st.ep),
                count=int(st.count), level=np.asarray(st.level).copy(),
                free=list(ix._free), nbr=nbr, deg=deg)


def _padded(ids, size):
    out = np.full(size, -1, np.int32)
    out[:len(ids)] = ids
    return out


@pytest.fixture(scope="module")
def ref():
    return TCT.jax_build()._impl, TCT.corpus()


@pytest.fixture(scope="module")
def churn(ref):
    """Both packages through remove, add and update of the same ids; the
    state after each step."""
    ji0, vecs = ref
    ji, ti = jax_clone(ji0), TTS.installed(ji0)
    rng = np.random.default_rng(5)
    ep = int(np.asarray(ji._state.ep))
    others = np.setdiff1d(np.arange(N), [ep])
    rem = np.sort(np.concatenate([[ep], rng.choice(others, N_REM - 1,
                                                   replace=False)]))
    surv = np.setdiff1d(np.arange(N), rem)
    out = dict(rem=rem, surv=surv, before=_snap(ti, t_dense),
               pre={"torch": _self_recall(ti, vecs, surv),
                    "jax": _self_recall(ji, vecs, surv)})
    ji.remove(rem)
    ti.remove(rem)
    out["removed"] = {"torch": _snap(ti, t_dense), "jax": _snap(ji, j_dense)}
    out["post"] = {"torch": _self_recall(ti, vecs, surv),
                   "jax": _self_recall(ji, vecs, surv)}
    fresh = (vecs[rng.choice(N, N_ADD, replace=False)]
             + 0.01 * rng.standard_normal((N_ADD, TCT.DIM))
             ).astype(np.float32)
    out["added"] = {"torch": ti.add(fresh), "jax": ji.add(fresh)}
    upd = np.sort(rng.choice(surv, N_UPD, replace=False))
    moved = (vecs[upd] + 0.03 * rng.standard_normal((N_UPD, TCT.DIM))
             ).astype(np.float32)
    ti.update(upd, moved)
    ji.update(upd, moved)
    out["updated"] = {"torch": _snap(ti, t_dense), "jax": _snap(ji, j_dense)}
    out["upd"], out["moved"] = upd, moved
    out["ti"], out["ji"] = ti, ji
    return out


def _same_host_state(a, b):
    np.testing.assert_array_equal(a["active"], b["active"])
    np.testing.assert_array_equal(a["level"], b["level"])
    assert (a["ep"], a["count"], a["free"]) == (b["ep"], b["count"],
                                                b["free"])


def _overlap(na, da, nb, db, layer, rows):
    ea = {(u, int(v)) for u in rows for v in na[layer, u, :da[layer, u]]}
    eb = {(u, int(v)) for u in rows for v in nb[layer, u, :db[layer, u]]}
    return len(ea & eb) / len(ea | eb) if ea | eb else 1.0


def test_remove_matches_reference(churn):
    t, j = churn["removed"]["torch"], churn["removed"]["jax"]
    _same_host_state(t, j)
    assert t["count"] == N - N_REM and t["ep"] not in churn["rem"]
    assert t["free"] == [int(x) for x in churn["rem"]]
    before = churn["before"]
    rmask = np.zeros(before["nbr"].shape[1], bool)
    rmask[churn["rem"]] = True
    layers = 0
    for layer in range(before["nbr"].shape[0]):
        nb = before["nbr"][layer]
        rows = np.flatnonzero(((nb >= 0) & rmask[np.clip(nb, 0, None)])
                              .any(axis=1) & t["active"])
        if rows.size == 0:
            continue
        layers += 1
        ov = _overlap(t["nbr"], t["deg"], j["nbr"], j["deg"], layer, rows)
        eq = np.mean([set(t["nbr"][layer, u, :t["deg"][layer, u]])
                      == set(j["nbr"][layer, u, :j["deg"][layer, u]])
                      for u in rows])
        assert ov >= 0.99, (layer, ov)
        assert eq >= 0.99, (layer, eq)
        # the repaired rows hold no removed id
        nr = t["nbr"][layer, rows]
        assert not (rmask[np.clip(nr, 0, None)] & (nr >= 0)).any()
    assert layers >= 2
    ratio = {p: churn["post"][p] / churn["pre"][p] for p in ("torch", "jax")}
    assert abs(ratio["torch"] - ratio["jax"]) <= 0.01, ratio


def test_add_after_remove_reuses_slots_lifo(churn):
    t, j = churn["added"]["torch"], churn["added"]["jax"]
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, churn["rem"][::-1][:N_ADD])


def test_update_matches_reference(churn):
    t, j = churn["updated"]["torch"], churn["updated"]["jax"]
    _same_host_state(t, j)
    for layer in range(t["nbr"].shape[0]):
        rows = np.flatnonzero(t["active"])
        ov = _overlap(t["nbr"], t["deg"], j["nbr"], j["deg"], layer, rows)
        assert ov >= 0.99, (layer, ov)
    ti, ji = churn["ti"], churn["ji"]
    np.testing.assert_array_equal(ti._upper_np, np.asarray(ji._upper_ids))
    np.testing.assert_array_equal(ti._state.vectors.numpy()[churn["upd"]],
                                  churn["moved"])
    found = {name: (ix.knn_query(churn["moved"], 1)[0][:, 0]
                    == churn["upd"]).mean() for name, ix in (("torch", ti),
                                                             ("jax", ji))}
    assert abs(found["torch"] - found["jax"]) <= 1 / N_UPD, found


def _ep_cases(ji):
    """The three entry-point cases of mark_removed: the entry point alone
    (a neighbour at its top layer takes over), the entry point and every
    neighbour at its top layer (the highest-level active node takes over),
    and every row (-1)."""
    st = ji._state
    ep = int(np.asarray(st.ep))
    top = int(np.asarray(st.level)[ep])
    nbr, deg = j_dense(st)
    nbs = nbr[top, ep, :deg[top, ep]]
    return nbs, {"neighbour": [ep], "highest_level": [ep, *nbs.tolist()],
                 "empty": list(range(N))}


@pytest.mark.parametrize("case", ["neighbour", "highest_level", "empty"])
def test_mark_removed_matches_reference(ref, case):
    ji, _ = ref
    nbs, cases = _ep_cases(ji)
    rem = cases[case]
    remp = _padded(rem, 2048)
    jst = JR.mark_removed(ji._cfg, jax_clone(ji)._state, jnp.asarray(remp))
    ti = TTS.installed(ji)
    TR.mark_removed(ti._cfg, ti._state, TR.removed_mask(
        ti._state, torch.from_numpy(remp)))
    st = ti._state
    np.testing.assert_array_equal(st.active.numpy(), np.asarray(jst.active))
    assert int(st.count) == int(np.asarray(jst.count)) == N - len(set(rem))
    assert int(st.ep) == int(np.asarray(jst.ep))
    if case == "empty":
        assert int(st.ep) == -1
    else:
        assert int(st.ep) not in rem and bool(st.active[int(st.ep)])
    if case == "neighbour":
        assert nbs.size and int(st.ep) in nbs
    if case == "highest_level":
        lvl = st.level.numpy()
        assert lvl[int(st.ep)] == lvl[st.active.numpy()].max()


def _marked(ji, rem):
    """Both packages' states after mark_removed of ``rem``."""
    remp = _padded(rem, REM_BUCKET)
    jst = JR.mark_removed(ji._cfg, jax_clone(ji)._state, jnp.asarray(remp))
    ti = TTS.installed(ji)
    rmask = TR.removed_mask(ti._state, torch.from_numpy(remp))
    TR.mark_removed(ti._cfg, ti._state, rmask)
    return jst, jnp.asarray(remp), ti, rmask


def test_affected_masks_all_matches_reference(ref, churn):
    ji, _ = ref
    jst, remj, ti, rmask = _marked(ji, churn["rem"])
    ja, jm = JR.affected_masks_all(ji._cfg, jst, remj)
    C = ti._state.capacity
    ja = np.unpackbits(np.asarray(ja), axis=-1)[:, :C].astype(bool)
    jm = np.unpackbits(np.asarray(jm), axis=-1)[:, :C].astype(bool)
    ta, tm = TR.affected_masks_all(ti._cfg, ti._state, rmask)
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert ja[0].sum() > jm[0].sum() > 0


@pytest.mark.parametrize("layer", [0, 1])
def test_exact_repair_candidates_match_reference(ref, churn, layer):
    """At layer 1 only the wave members of level >= 1 are scanned, padded
    as the reference pads them."""
    ji, vecs = ref
    rem = churn["rem"]
    jst, remj, ti, _ = _marked(ji, rem)
    scan = rem if layer == 0 else rem[np.asarray(ji._state.level)[rem] >= 1]
    spad = _padded(scan, REM_BUCKET if layer == 0 else 64)
    jc = np.asarray(JR.exact_repair_candidates(
        ji._cfg, jst, jnp.asarray(spad), jnp.asarray(layer, jnp.int32), 100,
        N))[:scan.size]
    tc = TR.exact_repair_candidates(ti._cfg, ti._state,
                                    torch.from_numpy(scan), layer, 100,
                                    N).numpy()
    assert tc.shape == jc.shape == (scan.size, 100)
    TTS.assert_same_ids("sq_euclid", vecs[scan], vecs, tc, jc)
    lvl = ti._state.level.numpy()
    assert (lvl[tc[tc >= 0]] >= layer).all()
    assert not np.isin(tc, rem).any()


def test_beam_repair_candidates_match_reference(ref, churn):
    """The beam form (exact_candidates=False) at layer 0 on the first 64
    removed ids: a prefix of each row equals the reference's row without
    its repeated ids (test_torch_search.first_unique) up to near-tie swaps,
    and the rest of the row lies at or beyond that prefix's last distance
    (test_torch_search.tail_rows), in all but two rows (its result pool
    collects every allowed node the walk visits, as test_torch_search's
    filtered beam)."""
    ji, vecs = ref
    rem = churn["rem"]
    jst, remj, ti, rmask = _marked(ji, rem)
    scan = rem[:64]
    jc = np.asarray(JR.repair_candidates(ji._cfg, jst, jnp.asarray(scan),
                                         remj, 0, 32, 8 * 32 + 16))
    tc = TR.repair_candidates(ti._cfg, ti._state, torch.from_numpy(scan),
                              rmask, 0, 32, 8 * 32 + 16).numpy()
    assert not np.isin(tc, rem).any() and (tc >= 0).any()
    np.testing.assert_array_equal(TTS.first_unique(tc), tc)
    ju = TTS.first_unique(jc)
    rows = TTS.near_tie_rows("sq_euclid", vecs[scan], vecs,
                             np.where(ju >= 0, tc, -1), ju)
    rows &= TTS.tail_rows("sq_euclid", vecs[scan], vecs, tc, ju)
    assert (~rows).sum() <= 2, np.flatnonzero(~rows)


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------

def _uniform(n, dim, seed):
    return np.random.default_rng(seed).random((n, dim), dtype=np.float32)


@pytest.mark.parametrize("n,quality,seed", [(4000, "high", 2026),
                                            (2000, "auto", 1337)])
def test_bulk_removal_meets_reference_drift_bar(n, quality, seed):
    """Half the index in one call: post >= 0.98 x pre self-recall of the
    surviving half, with "high" at 4,000 x 32 and the defaults ("auto"
    resolves to "high") at 2,000 x 32 (test_removal.py:274-342)."""
    vecs = _uniform(n, 32, seed)
    ix = T.HNSWIndex(32, parameters=T.HNSWParameters(
        collection_size=n, remove_quality=quality), device="cpu")
    ids = ix.add(vecs)
    pre = _self_recall(ix, vecs, ids[n // 2:])
    ix.remove(ids[:n // 2])
    post = _self_recall(ix, vecs, ids[n // 2:])
    assert post >= 0.98 * pre, (pre, post)
    assert ix.count == n // 2 and int(ix._state.count) == n // 2


@pytest.fixture
def small():
    vecs = _uniform(300, 16, 3)
    ix = T.HNSWIndex(16, parameters=T.HNSWParameters(collection_size=300),
                     device="cpu")
    ix.add(vecs)
    return ix, vecs


def _panel_ok(ix):
    """The panel lists exactly the live rows of level >= 1, once each."""
    p = ix._upper_np[ix._upper_np >= 0]
    st = ix._state
    live = np.flatnonzero(st.active.numpy() & (st.level.numpy() >= 1))
    assert p.size == np.unique(p).size
    np.testing.assert_array_equal(np.sort(p), live)
    np.testing.assert_array_equal(ix._upper_ids.numpy(), ix._upper_np)


def test_panel_membership_after_add_remove_update(small):
    ix, vecs = small
    _panel_ok(ix)
    lvl = ix._state.level.numpy()
    up = np.flatnonzero(lvl >= 1)
    ix.remove(up[:5])
    _panel_ok(ix)
    ix.add(vecs[:5] + 0.5)
    _panel_ok(ix)
    live_up = np.flatnonzero(ix._state.active.numpy()
                             & (ix._state.level.numpy() >= 1))
    ix.update(live_up[:4], vecs[:4] + 0.25)
    _panel_ok(ix)


def test_remove_everything_then_add(small):
    ix, vecs = small
    ix.remove(ix.ids())
    assert ix.count == 0 and int(ix._state.ep) == -1
    assert ix.knn_query(vecs[:2], 3)[0].tolist() == [[-1] * 3] * 2
    ids = ix.add(vecs[:20])
    np.testing.assert_array_equal(ids, np.arange(299, 279, -1))
    assert int(ix._state.ep) == 299 and ix.count == 20
    got, _ = ix.knn_query(vecs[:20], 1)
    assert (got[:, 0] == ids).all()
    _panel_ok(ix)


def test_remove_entry_point(small):
    ix, vecs = small
    ep = int(ix._state.ep)
    ix.remove([ep])
    new = int(ix._state.ep)
    assert new != ep and bool(ix._state.active[new])
    live = ix.ids()
    got, _ = ix.knn_query(vecs[live], 1)
    assert (got[:, 0] == live).mean() > 0.95 and ep not in got


def test_repeated_ids_are_freed_once(small):
    ix, _ = small
    ix.remove([7, 7, 3, 7, -1, 10 ** 6])
    assert ix._free == [3, 7] and ix.count == 298
    ix.remove([3])                     # inactive already: ignored
    assert ix._free == [3, 7] and ix.count == 298


def test_disabled_removals_raise(small):
    ix, vecs = small
    ix.params.allow_removals = False
    with pytest.raises(RuntimeError):
        ix.remove([1])
    with pytest.raises(RuntimeError):
        ix.update([1], vecs[:1])
    assert ix.count == 300


@pytest.mark.parametrize("ids,rows,err", [
    ([1, 2], 1, ValueError),           # length mismatch
    ([4, 4], 2, ValueError),           # repeated id
    ([5, 400], 2, ValueError),         # out of range
    ([6], 1, ValueError),              # inactive (removed first)
])
def test_update_validation(small, ids, rows, err):
    ix, vecs = small
    ix.remove([6])
    before = ix._state.nbr0.clone()
    with pytest.raises(err):
        ix.update(ids, vecs[:rows])
    assert ix.count == 299 and torch.equal(ix._state.nbr0, before)


def test_no_entry_refusal():
    vecs = _uniform(40, 8, 4)
    ix = T.HNSWIndex(8, parameters=T.HNSWParameters(
        collection_size=40, pack_queries="on"), device="cpu")
    ix.add(vecs)
    assert ix._get_pack() is not None
    ix.remove(ix.ids())
    assert ix._get_pack() is None and ix._pack_refusal == "no_entry"
    assert ix._get_block_fallback() is None


def test_beam_repair_keeps_the_graph(small):
    """A removal with beam candidates: no edge into a removed row, and the
    survivors still find themselves."""
    ix, vecs = small
    gone = np.arange(0, 300, 3)
    TR.remove_from_state(ix._cfg, ix._state, gone, 32,
                         exact_candidates=False, quality="fast")
    st = ix._state
    act = st.active.numpy()
    nbr, deg = t_dense(st)
    for layer in range(nbr.shape[0]):
        for u in np.flatnonzero(act):
            row = nbr[layer, u, :deg[layer, u]]
            assert act[row].all() and u not in row
    ix._count_host -= gone.size
    live = np.flatnonzero(act)
    got, _ = ix.knn_query(vecs[live], 1)
    assert (got[:, 0] == live).mean() > 0.95
