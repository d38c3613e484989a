"""Streaming churn on the port alone (no jax): whole clusters deleted and
re-filled in rounds, against the plain reference, exact top-k over the
live rows in float64.

A 2,400 x 32 L2 index of 24 clusters (100 rows each, noise 0.03) goes
through 3 rounds: ``remove`` every live row of 2 clusters (about 8% of
the live set: "auto" repairs as "fast"), a search step, and an ``add`` of
as many fresh rows, which take the freed slots.  Bars:

* no answer holds an id that is not live when it is asked;
* each returned distance is the float64 direct distance rounded to
  float32: within half a float32 ulp of it (relative 2^-24), since the
  refine computes in float64 and rounds once;
* recall@10 of each search step >= 0.93 (0.939-0.967 measured over four
  seeds at ef 32: within a cluster of 100 rows at D=32 the distances
  crowd, so a fresh build of these rows reads 0.966-0.976, and a query
  of a cluster deleted that round has its neighbours in other clusters,
  0.75-0.93);
* recall@10 of the final index within 0.02 of a fresh build of the same
  live rows (measured -0.0035 to +0.0035 over four seeds): the repaired
  graph, with fresh rows in freed slots, serves as well as a new one;
* after each removal no live row keeps an edge into a removed slot, at
  any layer, and every live row keeps an edge at layer 0;
* every freed slot is reused (the live count and the high-water mark stay
  at 2,400), and the index's tallies read what was done: ``remove.ids``
  the ids removed, ``add.reused`` the refilled slots, ``pack.builds`` one
  a search after a mutation;
* the benchmark's churn readers (``hnswbench/metrics/churn.*``) over that
  timer, handed over as the churn kind hands its rounds' timer.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import hnswindex_torch as T
from hnswindex_torch.core.graph import dense_tables

torch.set_num_threads(1)

N, DIM, PER, ROUNDS, DROP, K = 2400, 32, 100, 3, 2, 10
STEP_BAR = 0.93
FRESH_GAP = 0.02
METRICS = Path(__file__).resolve().parents[1] / "hnswbench" / "metrics"


def _rows(rng, centres, n):
    lab = rng.integers(0, centres.shape[0], n)
    x = centres[lab] + 0.03 * rng.standard_normal((n, DIM))
    return x.astype(np.float32), lab


def _exact(base, ids, q):
    """Exact top-K ids of ``q`` over the live rows ``base`` (ids ``ids``),
    in float64."""
    d = ((q[:, None, :].astype(np.float64) - base[None].astype(np.float64))
         ** 2).sum(-1)
    return ids[np.argsort(d, axis=1, kind="stable")[:, :K]]


def _check_answers(got, dist, q, vec_of, live, truth):
    """Every id live, distances the f64 ones rounded to f32; the recall."""
    assert (got >= 0).all()
    assert live[got].all(), "a removed id was returned"
    d64 = ((q[:, None, :].astype(np.float64)
            - vec_of[got].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_less(np.abs(dist - d64),
                                 d64 * 2.0 ** -24 + 1e-30)
    return np.mean([np.intersect1d(a, b).size / K
                    for a, b in zip(got, truth)])


@pytest.fixture(scope="module")
def churned():
    rng = np.random.default_rng(7)
    centres = rng.random((N // PER, DIM))
    x, lab = _rows(rng, centres, N)
    ix = T.HNSWIndex(DIM, parameters=T.HNSWParameters(
        collection_size=N, max_wave_size=64, pack_min_count=0,
        remove_quality="auto"), device="cpu")
    ids = ix.add(x)
    vec_of = np.empty((N, DIM), np.float32)
    lab_of = np.empty(N, np.int64)
    vec_of[ids], lab_of[ids] = x, lab
    live = np.zeros(N, bool)
    live[ids] = True
    order = rng.permutation(centres.shape[0])
    log = dict(removed=0, reused=0, recalls=[], edges_ok=[], steps=0)
    for r in range(ROUNDS):
        gone = np.flatnonzero(live & np.isin(lab_of, order[r * DROP:
                                                            (r + 1) * DROP]))
        ix.remove(gone)
        live[gone] = False
        log["removed"] += gone.size
        nbr, deg = dense_tables(ix._state)
        act = ix._state.active.numpy()
        assert (act[:N] == live).all() and not act[N:].any()
        ok = True
        for layer in range(nbr.shape[0]):
            for u in np.flatnonzero(act):
                row = nbr[layer, u, :deg[layer, u]]
                ok &= bool(act[row].all()) and u not in row
        ok &= bool((deg[0][act] > 0).all())
        log["edges_ok"].append(ok)
        q, _ = _rows(rng, centres, 64)
        got, dist = ix.knn_query(q, K)
        log["steps"] += 1
        truth = _exact(vec_of[live], np.flatnonzero(live), q)
        log["recalls"].append(_check_answers(got, dist, q, vec_of, live,
                                             truth))
        fresh, flab = _rows(rng, centres, gone.size)
        new = ix.add(fresh)
        assert set(new.tolist()) == set(gone.tolist())
        log["reused"] += new.size
        vec_of[new], lab_of[new] = fresh, flab
        live[new] = True
    q, _ = _rows(rng, centres, 200)
    got, dist = ix.knn_query(q, K)
    truth = _exact(vec_of, np.arange(N), q)
    log["final_recall"] = _check_answers(got, dist, q, vec_of, live, truth)
    fresh = T.HNSWIndex(DIM, parameters=T.HNSWParameters(
        collection_size=N, max_wave_size=64, pack_min_count=0), device="cpu")
    fresh.add(vec_of)                  # ids 0..N-1: the churned ids' rows
    got, dist = fresh.knn_query(q, K)
    log["fresh_recall"] = _check_answers(got, dist, q, vec_of, live, truth)
    return ix, log


def test_steps_and_final_answers_hold_to_the_reference(churned):
    _, log = churned
    assert min(log["recalls"]) >= STEP_BAR, log["recalls"]
    assert log["final_recall"] >= log["fresh_recall"] - FRESH_GAP, log


def test_no_live_row_keeps_an_edge_into_a_removed_slot(churned):
    assert all(churned[1]["edges_ok"])


def test_freed_slots_are_reused_and_the_count_kept(churned):
    ix, log = churned
    assert ix.count == N and ix._length == N and not ix._free
    assert ix._state.capacity == T.index._alloc_capacity(N)
    assert log["removed"] > ROUNDS * DROP * PER * 0.8


def test_tallies_read_what_was_done(churned):
    ix, log = churned
    ph = ix.timer.seconds()
    assert ph["remove.ids"] == log["removed"]
    assert ph["add.reused"] == log["reused"] == log["removed"]
    assert ph["remove.waves"] == ROUNDS
    assert ph["pack.builds"] == log["steps"] + 1
    assert 0 < ph["remove.affected_one"] + ph["remove.affected_multi"]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", [
    "churn.remove_host_ms_per_krow", "churn.candidates_ms_per_krow",
    "churn.repair_ms_per_krow", "churn.affected_per_removed",
    "churn.step_search_s"])
def test_churn_readers(churned, name):
    """A number over the churned index's timer, handed over as the kind's
    ``round_phases``; 0.0 where the set-up removed nothing.  Over a timer
    without the removal tallies (the regions alone) the span readers still
    read, the tally's reader reads nothing; over one without the removal's
    regions only the kind's own step clock reads."""
    ix, log = churned
    read = _reader(name)
    ph = ix.timer.seconds()
    setup = dict(rows=N, removed=log["removed"],
                 rounds=[dict(step_s=0.25)] * ROUNDS, round_phases=ph)
    assert read(dict(setup=setup, phases={})) > 0
    assert read(dict(setup=dict(rows=N), phases=ph)) == 0.0
    untallied = {k: v for k, v in ph.items() if not isinstance(v, int)}
    got = read(dict(setup=dict(setup, round_phases=untallied), phases={}))
    if name == "churn.affected_per_removed":
        assert got is None
    else:
        assert got > 0
    regions = ("remove", "mark", "affected", "candidates", "repair")
    bare = {k: v for k, v in ph.items() if k.split(".")[0] not in regions}
    got = read(dict(setup=dict(setup, round_phases=bare), phases={}))
    assert got is None if name != "churn.step_search_s" else got == 0.25
