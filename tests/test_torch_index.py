"""Facade parity: hnswindex_torch.Index / HNSWIndex against hnswindex_tpu's
on the main path (add, then unfiltered layer-0 knn_query through the
pack), and the contract that every call outside the slice raises.

Bars: the reference quickstart's shape (2,000 x 128, sq_euclid, M=16, k=1,
on the bench's clustered corpus) has self-recall > 0.85 (on its first
1,000 items) in both packages (GraphTests.cs:28); recall@10 on a
5,000-row clustered corpus is within 0.01 of the reference's."""

import numpy as np
import pytest
import torch

import hnswindex_torch as T
import hnswindex_tpu as J
import test_torch_construct as TCT
from hnswindex_torch import index as TI

torch.set_num_threads(1)


def _self_recall(index, vecs, n=1000):
    """Self-recall@1 over the first ``n`` items."""
    ids, dists = index.knn_query(vecs[:n], 1)
    assert ids.dtype == np.int32 and dists.dtype == np.float32
    return (ids[:, 0] == np.arange(n)).mean()


def test_quickstart_self_recall_both_packages():
    """The quickstart's shape (2,000 x 128, sq_euclid, k=1) on the bench's
    clustered corpus; the reference side is test_torch_construct's build,
    made through hnswindex_tpu.Index with the same settings."""
    vecs = TCT.corpus()
    idx = T.Index(128, device="cpu")
    idx.set_collection_size(2000)
    idx._params.pack_queries = "on"
    ids = idx.add(vecs)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, np.arange(2000))
    got = {"torch": _self_recall(idx, vecs),
           "jax": _self_recall(TCT.jax_build(), vecs)}
    assert got["torch"] > 0.85 and got["jax"] > 0.85, got


def test_recall_at_10_matches_reference():
    n, dim, k = 5000, 128, 10
    rng = np.random.default_rng(65537)
    centers = rng.random((n // 500, dim)).astype(np.float32)
    vecs = (centers[rng.integers(0, n // 500, n)]
            + 0.03 * rng.standard_normal((n, dim)).astype(np.float32))
    q = vecs[:500]
    q64, v64 = q.astype(np.float64), vecs.astype(np.float64)
    d = ((q64 * q64).sum(1)[:, None] + (v64 * v64).sum(1)[None]
         - 2.0 * q64 @ v64.T)
    gt = np.argsort(d, axis=1)[:, :k]
    rec = {}
    for name, mod, extra in (("torch", T, dict(device="cpu")),
                             ("jax", J, {})):
        idx = mod.HNSWIndex(dim, "sq_euclid", mod.HNSWParameters(
            collection_size=n, pack_queries="on"), **extra)
        idx.add(vecs)
        ids, dists = idx.knn_query(q, k)
        assert (np.diff(dists, axis=1) >= 0).all()
        rec[name] = np.mean([len(set(a) & set(b)) / k
                             for a, b in zip(ids, gt)])
    assert abs(rec["torch"] - rec["jax"]) <= 0.01, rec
    assert rec["torch"] > 0.9, rec


@pytest.fixture(scope="module")
def small():
    vecs = np.random.default_rng(1).random((300, 16), np.float32)
    idx = T.Index(16, device="cpu")
    idx._params.pack_queries = "on"
    idx.add(vecs)
    return idx, vecs


def test_introspection_and_padding(small):
    idx, vecs = small
    assert idx.count == 300
    np.testing.assert_array_equal(idx.ids(), np.arange(300))
    np.testing.assert_array_equal(idx.items(), vecs)
    ids, dists = idx.knn_query(vecs[:3], 0)
    assert ids.shape == (3, 0)
    with pytest.raises(RuntimeError):
        idx.set_max_edges(8)


@pytest.mark.parametrize("call", [
    lambda i, v: i.remove([0]),
    lambda i, v: i._impl.update([0], v[:1]),
    lambda i, v: i.range_query(v[:1], 0.5),
    lambda i, v: i.multi_layer_knn_query(v[0], 3),
    lambda i, v: i.get_info(),
    lambda i, v: i.get_connected_component_counts(),
    lambda i, v: i.serialize("unused.bin"),
    lambda i, v: T.Index.deserialize("unused.bin"),
    lambda i, v: i.knn_query(v[:1], 3, filter_fnc=[1, 2]),
    lambda i, v: i.knn_query(v[:1], 3, layer=1),
    lambda i, v: i.knn_query(v[:1], 3, exact=True),
    lambda i, v: T.ops.distance.register_metric("l1", lambda a, b: a),
], ids=["remove", "update", "range_query", "multi_layer", "get_info",
        "components", "serialize", "deserialize", "filter", "layer",
        "exact", "register_metric"])
def test_out_of_slice_calls_raise(small, call):
    idx, vecs = small
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(idx, vecs)


@pytest.mark.parametrize("setting", ["auto", "off", "budget", "threshold"])
def test_out_of_slice_configurations_raise(setting):
    vecs = np.random.default_rng(2).random((64, 8), np.float32)
    p = T.HNSWParameters(collection_size=64, pack_queries=setting
                         if setting in ("auto", "off") else "on")
    if setting == "budget":
        p.pack_max_bytes = 1024
    if setting == "threshold":
        p.exact_build_threshold = 32
    idx = T.HNSWIndex(8, parameters=p, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        idx.add(vecs)
        idx.knn_query(vecs[:2], 3)


def test_cuda_index_refuses_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32|full-precision"):
            TI._check_full_f32(torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    TI._check_full_f32(torch.device("cpu"))


def test_pre_init_calls_raise_cleanly():
    idx = T.Index(8, device="cpu")
    assert idx.count == 0 and idx.ids().size == 0
    with pytest.raises(RuntimeError):
        idx.knn_query(np.zeros((1, 8), np.float32), 1)
    with pytest.raises(ValueError):
        T.Index(8, metric="manhattan", device="cpu")
