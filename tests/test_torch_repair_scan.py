"""The removal's repair-candidate scan (``ops/repair_scan``, kernel K4 on
the card) on the CPU, where it runs its plain twin.

* The twin equals ``exact_knn`` (the blocked scan the removal ran before
  K4) bit for bit for sq_euclid, cosine and ucosine, at D = 100 and at a
  depth that is not a multiple of 4, across the twin's query chunks.
* ``affine_terms``, the kernel's epilogue, gives ``distance.from_dot``'s
  distance for allowed rows (a zero-norm cosine row exactly 1) and +inf
  for the others.
* A bfloat16 ranking table takes the wrapper too: on the CPU it equals
  ``exact_knn`` on that table bit for bit.
* Where few rows are allowed the scan runs on a gathered copy of them and
  maps the ids back: the twin's answer up to float32 near-ties.
* On the CPU a top-k wider than the kernel's runs the twin.
* ``core/remove.exact_repair_candidates`` through it: a ragged scan prefix,
  an upper layer's level mask, fewer allowed rows than k (-1 padding) and
  -1 scan ids, against a float64 brute force; the timer's tally of K4
  launches reads 0 on the CPU; with a bfloat16 ranking table, the blocked
  ``exact_knn`` on that table (the scan it replaced).
* The wrapper's input checks raise.

The kernel itself is held to the twin on the card in
``test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from hnswindex_torch.core import graph as G
from hnswindex_torch.core import remove as TR
from hnswindex_torch.ops import bruteforce as TB
from hnswindex_torch.ops import distance as tdst
from hnswindex_torch.ops import repair_scan as RS
from hnswindex_torch.utils.profiling import PhaseTimer

METRICS = ("sq_euclid", "cosine", "ucosine")


def _inputs(metric, ns, D, S, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((ns, D)).astype(np.float32))
    if metric == "ucosine":
        x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    x[3] = 0.0                                  # a zero-norm row
    allowed = torch.from_numpy(rng.random(ns) < 0.9)
    q = x[torch.from_numpy(rng.integers(0, ns, S))] + 0.01
    return x, tdst.norm_data(metric, x), allowed, q.contiguous()


@pytest.mark.parametrize("D", [100, 37])
@pytest.mark.parametrize("metric", METRICS)
def test_twin_equals_exact_knn(metric, D, monkeypatch):
    x, norms, allowed, q = _inputs(metric, 1500, D, 70, seed=D)
    want = TB.exact_knn(metric, x, norms, allowed, q, 40)
    monkeypatch.setattr(RS, "SCAN_CHUNK", 32)   # three chunks, one ragged
    got = RS.repair_scan(metric, x, norms, allowed, q, 40)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(allowed[got[1]].all())


@pytest.mark.parametrize("metric", METRICS)
def test_affine_terms_give_the_dot_formula(metric):
    x, norms, allowed, q = _inputs(metric, 400, 24, 30, seed=5)
    q[0] = 0.0                                  # a zero-norm query
    qn = tdst.norm_data(metric, q)
    qa, qm, cb, cm = RS.affine_terms(metric, qn, norms, allowed)
    dots = q @ x.T
    got = (qa[:, None] + cb[None, :]) + dots * (qm[:, None] * cm[None, :])
    want = tdst.from_dot(metric, dots, qn[:, None], norms[None, :])
    ok = allowed[None, :].expand_as(got)
    assert bool(torch.isinf(got[~ok]).all()) and bool((got[~ok] > 0).all())
    scale = (qn[:, None] + norms[None, :]).expand_as(got)[ok] \
        if metric == "sq_euclid" else 1.0
    err = (got[ok] - want[ok]).abs()
    assert bool((err <= 1e-5 * want[ok].abs() + 1e-6 * scale).all())
    if metric == "cosine":
        assert bool((got[0][allowed] == 1.0).all())       # zero query
        assert bool((got[1:, 3] == 1.0).all()) == bool(allowed[3])


@pytest.mark.parametrize("metric", METRICS)
def test_bf16_table_equals_exact_knn(metric):
    x, norms, allowed, q = _inputs(metric, 1500, 100, 70, seed=9)
    xb = x.to(torch.bfloat16)
    want = TB.exact_knn(metric, xb, norms, allowed, q, 40)
    got = RS.repair_scan(metric, xb, norms, allowed, q, 40)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _assert_near_ties(metric, x, q, got, want):
    """``got`` and ``want`` (dists, ids) hold the same padding and
    distances within 1e-5 relative plus 1e-6, and differ in ids only
    between rows whose float64 distances lie within twice that."""
    fin = torch.isfinite(want[0])
    assert torch.equal(torch.isfinite(got[0]), fin)
    assert bool((got[1][~fin] == -1).all())
    tol = 1e-5 * want[0].abs() + 1e-6
    assert bool(((got[0] - want[0]).abs() <= tol)[fin].all())
    r, c = ((got[1] != want[1]) & fin).nonzero(as_tuple=True)
    for a, b, s, t in zip(got[1][r, c], want[1][r, c], r, tol[r, c]):
        qd = q[s:s + 1].double()
        da = tdst.from_dot(metric, qd @ x[a].double()[:, None],
                           tdst.norm_data(metric, qd)[:, None],
                           tdst.norm_data(metric, x[a:a + 1].double()))
        db = tdst.from_dot(metric, qd @ x[b].double()[:, None],
                           tdst.norm_data(metric, qd)[:, None],
                           tdst.norm_data(metric, x[b:b + 1].double()))
        assert abs(float(da) - float(db)) <= 2 * float(t)


@pytest.mark.parametrize("metric", METRICS)
def test_few_allowed_rows_scan_a_gathered_copy(metric):
    """20% of the rows allowed: the scan runs on the gathered rows (the
    ids map back to allowed rows of the full table) and gives the twin's
    answer on the full table."""
    x, norms, _, q = _inputs(metric, 2000, 37, 60, seed=13)
    allowed = torch.from_numpy(np.random.default_rng(4).random(2000) < 0.2)
    got = RS.repair_scan(metric, x, norms, allowed, q, 50)
    want = RS.repair_scan_ref(metric, x, norms, allowed, q, 50)
    assert bool(allowed[got[1][got[1] >= 0]].all())
    _assert_near_ties(metric, x, q, got, want)


def test_k_past_the_kernels_width_runs_the_twin_on_cpu():
    x, norms, allowed, q = _inputs("sq_euclid", 900, 16, 9, seed=6)
    k = RS.KMAX + 40
    got = RS.repair_scan("sq_euclid", x, norms, allowed, q, k)
    want = TB.exact_knn("sq_euclid", x, norms, allowed, q, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[1][:, int(allowed.sum()):] == -1).all())


def _state(n, D, seed, rank_dtype="float32"):
    """A CPU graph state of ``n`` written rows (15% of level >= 1, 5% of
    level 2) in a capacity of ``n + 37``; callers scan the ragged prefix
    of ``n`` rows."""
    rng = np.random.default_rng(seed)
    cfg = G.GraphConfig(dim=D, rank_dtype=rank_dtype)
    st = G.empty_state(cfg, n + 37, "cpu")
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    r = rng.random(n)
    lvl = (r < 0.15).astype(np.int32) + (r < 0.05)
    G.write_rows(st, cfg, torch.arange(n), torch.from_numpy(vecs),
                 torch.from_numpy(lvl))
    return cfg, st, vecs, lvl


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_exact_repair_candidates_edges(layer):
    """Layer 2 holds fewer allowed rows than k: its lists end in -1."""
    n, D, k = 900, 100, 40
    cfg, st, vecs, lvl = _state(n, D, seed=11)
    scan = np.flatnonzero(lvl >= layer)[:25]
    st.active[torch.from_numpy(scan)] = False
    sid = torch.from_numpy(np.concatenate([scan, [-1]]))
    timer = PhaseTimer("cpu")
    got = TR.exact_repair_candidates(cfg, st, sid, layer, k, n,
                                     timer).numpy()
    assert got.shape == (scan.size + 1, k)
    assert (got[-1] == -1).all()
    assert timer.seconds()["remove.scan_calls"] == 0
    allowed = np.flatnonzero((lvl >= layer) & ~np.isin(np.arange(n), scan))
    for row, s in zip(got, scan):
        d = ((vecs[allowed].astype(np.float64) - vecs[s]) ** 2).sum(1)
        order = np.argsort(d, kind="stable")[:k]
        want = np.full(k, -1)
        want[:order.size] = allowed[order]
        if layer == 2:
            assert order.size < k
        diff = row != want
        assert (row[order.size:] == -1).all()
        # a differing id is a float32 near-tie of the float64 order
        dd = {int(i): v for i, v in zip(allowed, d)}
        for a, b in zip(row[diff], want[diff]):
            assert abs(dd[int(a)] - dd[int(b)]) <= 1e-5 * dd[int(b)]


@pytest.mark.parametrize("layer", [0, 1])
def test_exact_repair_candidates_bf16_table(layer):
    """A bfloat16 ranking table is scanned by the wrapper too, and gives
    the blocked ``exact_knn`` on that table up to float32 near-ties."""
    n, D, k = 700, 48, 30
    cfg, st, vecs, lvl = _state(n, D, seed=17, rank_dtype="bfloat16")
    assert st.vlo.dtype == torch.bfloat16
    scan = np.flatnonzero(lvl >= layer)[:20]
    st.active[torch.from_numpy(scan)] = False
    sid = torch.from_numpy(scan)
    timer = PhaseTimer("cpu")
    got = TR.exact_repair_candidates(cfg, st, sid, layer, k, n, timer)
    assert timer.seconds()["remove.scan_calls"] == 0
    allowed = (st.active & (st.level >= layer))[:n]
    full_d, full_i = TB.exact_knn(cfg.metric, st.vlo[:n], st.norms[:n],
                                  allowed, st.vectors[sid], n)
    for r in range(sid.shape[0]):
        d = dict(zip(full_i[r].tolist(), full_d[r].tolist()))
        for a, b in zip(got[r].tolist(), full_i[r, :k].tolist()):
            if a != b:
                assert a >= 0 and abs(d[a] - d[b]) <= 1e-5 * abs(d[b]) + 1e-6


def test_wrapper_checks_its_inputs(monkeypatch):
    x, norms, allowed, q = _inputs("sq_euclid", 300, 16, 8, seed=3)
    call = RS.repair_scan
    monkeypatch.setitem(tdst._CUSTOM_METRICS, "l1_repair_scan_test",
                        lambda a, b: (a - b).abs().sum(-1))
    cases = [
        (ValueError, ("l1_repair_scan_test", x, norms, allowed, q, 5)),
        (ValueError, ("euclid", x, norms, allowed, q, 5)),
        (ValueError, ("sq_euclid", x, norms, allowed, q[:, :15], 5)),
        (ValueError, ("sq_euclid", x, norms[:-1], allowed, q, 5)),
        (TypeError, ("sq_euclid", x.double(), norms, allowed, q, 5)),
        (TypeError, ("sq_euclid", x, norms, allowed.int(), q, 5)),
        (ValueError, ("sq_euclid", x, norms, allowed, q.T.contiguous().T,
                      5)),
        (ValueError, ("sq_euclid", x, norms, allowed, q, 0)),
        (TypeError, ("sq_euclid", x.half(), norms, allowed, q, 5)),
        (TypeError, ("sq_euclid", x, norms, allowed, q.to(torch.bfloat16),
                     5)),
        (ValueError, ("sq_euclid", x, norms, allowed, q.to("meta"), 5)),
        (ValueError, ("sq_euclid", x.to("meta"), norms.to("meta"),
                      allowed.to("meta"), q.to("meta"), 5)),
    ]
    for exc, args in cases:
        with pytest.raises(exc):
            call(*args)
