"""Port parity: heuristic.prune selects exactly the reference's ids on
identical candidate inputs, for every metric, with and without
``fill_to`` and ``force_mask``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnswindex_torch.core import heuristic as TH
from hnswindex_torch.ops import distance as tdst
from hnswindex_tpu.core import heuristic as JH
from hnswindex_tpu.ops import distance as jdst
from torch_cases import accept_inputs

torch.set_num_threads(1)


def _inputs(metric, seed=11):
    rng = np.random.default_rng(seed)
    B, N, D, pool = 24, 40, 16, 200
    vecs = rng.random((pool, D)).astype(np.float32)
    if metric == "ucosine":
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    cand = np.stack([rng.choice(pool, N, replace=False)
                     for _ in range(B)]).astype(np.int32)
    cand[:, -5:] = -1                          # invalid tail
    cand[3, 4:] = -1                           # fewer than max_edges: keep all
    targets = rng.random((B, D)).astype(np.float32)
    if metric == "ucosine":
        targets /= np.linalg.norm(targets, axis=1, keepdims=True)
    cvecs = vecs[np.clip(cand, 0, None)]
    cn = np.asarray(jdst.norm_data(metric, jnp.asarray(cvecs)))
    cd = np.asarray(jdst.exact(metric, jnp.asarray(targets)[:, None, :],
                               jnp.asarray(cvecs)))
    cd = np.where(cand >= 0, cd, np.inf).astype(np.float32)
    force = rng.random(B) < 0.8
    return cand, cd, cvecs, np.array(cn), force


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fill_to", [0, 6])
@pytest.mark.parametrize("metric", ["sq_euclid", "cosine", "ucosine"])
def test_prune_selects_reference_ids(metric, fill_to, masked):
    cand, cd, cvecs, cn, force = _inputs(metric)
    M = 8
    js, jc = JH.prune(metric, jnp.asarray(cand), jnp.asarray(cd),
                      jnp.asarray(cvecs), jnp.asarray(cn), M,
                      force_mask=jnp.asarray(force) if masked else None,
                      fill_to=fill_to)
    ts, tc = TH.prune(metric, torch.from_numpy(cand), torch.from_numpy(cd),
                      torch.from_numpy(cvecs), torch.from_numpy(cn), M,
                      force_mask=torch.from_numpy(force) if masked else None,
                      fill_to=fill_to)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc[3] == 4 or (masked and not force[3])


def test_accept_scan_is_sequential_rule():
    """The column scan equals the plain sequential loop of Heuristic.cs."""
    rng = np.random.default_rng(5)
    B, N = 16, 12
    conf = rng.random((B, N, N)) < 0.3
    conf &= np.triu(np.ones((N, N), bool), 1)[None]
    got = TH._accept_cols(
        torch.from_numpy(conf).transpose(1, 2).contiguous()).numpy()
    for b in range(B):
        acc = []
        for c in range(N):
            acc.append(not any(conf[b, s, c] and acc[s] for s in range(c)))
        assert got[b].tolist() == acc
    assert tdst.VALID_METRICS == jdst.VALID_METRICS


def _heuristic_cs_row(pd, sd, valid, max_edges):
    """Heuristic.cs:11-41 for one row, transcribed: fewer valid candidates
    than ``max_edges`` keep all; else walk the sorted candidates and accept
    c iff no accepted s has d(s, c) = pd[c, s] < d(c, target) = sd[c],
    stopping at ``max_edges`` accepts."""
    cols = [c for c in range(len(sd)) if valid[c]]
    if len(cols) < max_edges:
        return cols
    acc = []
    for c in cols:
        if len(acc) == max_edges:
            break
        if not any(pd[c, s] < sd[c] for s in acc):
            acc.append(c)
    return acc


@pytest.mark.parametrize("max_edges", [4, 16])
@pytest.mark.parametrize("N", [1, 12, 40, 100])
def test_accept_capped_is_heuristic_cs(N, max_edges):
    """The accept's plain twin (kernel K3's contract) against a per-row
    transcription of the reference's loop."""
    pd, sd, valid = accept_inputs(100 + N + max_edges, 24, N)
    got = TH._accept_capped(torch.from_numpy(pd), torch.from_numpy(sd),
                            torch.from_numpy(valid), max_edges).numpy()
    for b in range(pd.shape[0]):
        want = _heuristic_cs_row(pd[b], sd[b], valid[b], max_edges)
        assert np.flatnonzero(got[b]).tolist() == want, b
    assert not got[0].any()
    if N > 3:
        assert got[1].tolist() == valid[1].tolist()


def test_prune_on_cpu_never_launches_the_kernel():
    """On the CPU, prune takes the plain twin: K3's launch count stays
    put while the column loop counts its steps."""
    from hnswindex_torch.ops import accept_scan as TA
    cand, cd, cvecs, cn, _ = _inputs("sq_euclid")
    calls, steps = TA.accept_scan.calls, TH._accept_cols.steps
    TH.prune("sq_euclid", torch.from_numpy(cand), torch.from_numpy(cd),
             torch.from_numpy(cvecs), torch.from_numpy(cn), 8)
    assert TA.accept_scan.calls == calls
    assert TH._accept_cols.steps == steps + cand.shape[1]
    with pytest.raises(ValueError, match="no kernel"):
        TA.accept_scan(torch.zeros((1, 2, 2)), torch.zeros((1, 2)),
                       torch.ones((1, 2), dtype=torch.bool), 1)
