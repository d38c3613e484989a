"""The CUDA kernels and the main path on the card, against their plain
PyTorch versions.

Every test needs an NVIDIA card (and nvcc for the first build) and skips
without one.  The file imports no jax, so it also runs where jax is not
installed; there the suite's conftest (which configures jax) is left out:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Bars: lane-min scan vals at rtol=atol=1e-4, ids equal on >= 0.999 of live
lanes, dead lanes -1; exact_knn2 on the card against the same call on the
CPU: ids equal on >= 0.99 of entries, distances at rtol=atol=1e-5 where
ids agree; a 2,000-row build on the card through the kernel keeps the row
invariants and self-recall > 0.85."""

import numpy as np
import pytest
import torch

import hnswindex_torch as T
from hnswindex_torch.core import construct as TC
from hnswindex_torch.ops import bruteforce as TB
from hnswindex_torch.ops import distance as tdst
from hnswindex_torch.ops import fused_scan as TF

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _scan_case(metric, C, D, B, dev, seed=7):
    rng = np.random.default_rng(seed)
    vecs = rng.random((C, D)).astype(np.float32)
    vecs[5] = 0.0                               # zero-norm guard row
    active = rng.random(C) < 0.9
    active[-(C // 10):] = False                 # an inactive tail
    excl = rng.integers(-1, C, B).astype(np.int32)
    x = torch.from_numpy(vecs).to(dev)
    mult, bias = TF.rank_transform(metric, tdst.norm_data(metric, x),
                                   torch.from_numpy(active).to(dev))
    q = torch.from_numpy(rng.random((B, D)).astype(np.float32)).to(dev)
    return (x.to(torch.bfloat16), mult, bias, q,
            torch.from_numpy(excl).to(dev))


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
@pytest.mark.parametrize("C,D,B", [
    (8192, 128, 100),
    (8192 * 3 + 77, 128, 512),      # ragged corpus, full build wave
    (700, 50, 7),                   # C < BS (dead lanes), D not a multiple of 32
])
def test_lane_min_scan_matches_ref_on_card(dev, metric, C, D, B):
    args = _scan_case(metric, C, D, B, dev)
    n0 = TF.lane_min_scan.launches
    kv, ki = TF.lane_min_scan(*args, BS=1024)
    torch.cuda.synchronize()
    assert TF.lane_min_scan.launches == n0 + 1
    rv, ri = TF.lane_min_scan_ref(*args, BS=1024)
    live = rv < TF.DEAD
    assert torch.equal(kv < TF.DEAD, live)
    torch.testing.assert_close(kv[live], rv[live], rtol=1e-4, atol=1e-4)
    assert (ki[live] == ri[live]).float().mean().item() >= 0.999
    assert (ki[~live] == -1).all()


def test_lane_min_scan_checks_its_inputs_on_card(dev):
    coarse, mult, bias, q, excl = _scan_case("sq_euclid", 4096, 64, 16, dev)
    with pytest.raises(TypeError):
        TF.lane_min_scan(coarse.float(), mult, bias, q, excl)
    with pytest.raises(ValueError):
        TF.lane_min_scan(coarse, mult, bias, q, excl, BS=1000)
    with pytest.raises(ValueError):
        TF.lane_min_scan(coarse[:, ::2], mult, bias, q[:, ::2], excl)
    with pytest.raises(ValueError):
        TF.lane_min_scan(coarse, mult.cpu(), bias, q, excl)


def test_exact_knn2_on_card_matches_cpu(dev):
    rng = np.random.default_rng(3)
    C, D, B, K = 20000, 128, 64, 100
    vecs = torch.from_numpy(rng.random((C, D)).astype(np.float32))
    active = torch.from_numpy(rng.random(C) < 0.95)
    q = vecs[:B] + 0.01
    out = {}
    for where in ("cpu", dev):
        v = vecs.to(where)
        out[str(where)] = [t.cpu() for t in TB.exact_knn2(
            "sq_euclid", v, v.to(torch.bfloat16),
            tdst.norm_data("sq_euclid", v), active.to(where), q.to(where),
            K, exclude=torch.arange(B).to(where))]
    (cd, ci), (gd, gi) = out["cpu"], out[str(dev)]
    same = ci == gi
    assert same.float().mean().item() >= 0.99
    torch.testing.assert_close(gd[same], cd[same], rtol=1e-5, atol=1e-5)
    assert not (gi == torch.arange(B)[:, None]).any()


def test_build_on_card_runs_the_kernel(dev, monkeypatch):
    n, dim = 2000, 128
    rng = np.random.default_rng(65537)
    centers = rng.random((n // 500, dim)).astype(np.float32)
    vecs = (centers[rng.integers(0, n // 500, n)]
            + 0.03 * rng.standard_normal((n, dim)).astype(np.float32))
    monkeypatch.setattr(TC, "BUILD_SCAN2_MIN", 0)
    idx = T.HNSWIndex(dim, "sq_euclid", T.HNSWParameters(
        collection_size=n, pack_queries="on"), device=dev)
    n0 = TF.lane_min_scan.launches
    idx.add(vecs)
    assert TF.lane_min_scan.launches > n0
    assert idx.count == n
    deg0 = idx._state.deg0.cpu().numpy()
    nbr0 = idx._state.nbr0.cpu().numpy()
    assert (deg0 <= nbr0.shape[1]).all()
    for u in range(n):
        row = nbr0[u, :deg0[u]]
        assert (row >= 0).all() and u not in row
        assert len(set(row.tolist())) == row.size
    ids, _ = idx.knn_query(vecs, 1)
    assert (ids[:, 0] == np.arange(n)).mean() > 0.85


def test_trace_sees_the_kernel_on_card(dev):
    from hnswindex_torch.utils.profiling import trace
    args = _scan_case("sq_euclid", 8192 * 4, 128, 512, dev)
    TF.lane_min_scan(*args)                         # build and warm up
    res = trace(lambda: TF.lane_min_scan(*args), dev)
    names = [r[0] for r in res["rows"]]
    assert any("lane_min_scan" in n for n in names), names
    assert 0.0 < res["busy_s"] <= res["wall_s"]
