"""Search parity apart from build parity: a graph built by hnswindex_tpu is
loaded into the port with convert.state_from_numpy, and both packages
build the query pack and run packed_knn_search on it.

Bars: ``aux``/``base`` at rtol 1e-6; ``res`` equal in bf16 bit for bit
for sq_euclid, whose base is the stored vectors.  Cosine normalizes the
base first, and the two packages' norms differ in the last float32 bit
(reduction order), which moves a few residuals across a bf16 rounding
boundary: there ``res`` must agree on >= 99.9% of elements and within one
bf16 step (rtol 2^-7, atol 1e-6 for residuals near zero) everywhere.
Search ids agree on >= 0.99 of entries; the rank-distance identity holds
on the port's tables."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnswindex_tpu as J
import test_torch_construct as TCT
from hnswindex_torch import convert
from hnswindex_torch.core import graph as TG
from hnswindex_torch.core import pack as TP
from hnswindex_tpu.core import pack as JP

torch.set_num_threads(1)

EF = 10


def _cosine_corpus(rng):
    centers = rng.random((6, 32)).astype(np.float32)
    return (centers[rng.integers(0, 6, 600)]
            + 0.05 * rng.standard_normal((600, 32)).astype(np.float32))


@functools.lru_cache(maxsize=1)
def cosine_build():
    """The reference's 600 x 32 clustered cosine graph, cached per process
    (test_torch_search loads it too).  Returns (vecs, HNSWIndex)."""
    vecs = _cosine_corpus(np.random.default_rng(7))
    ji = J.HNSWIndex(32, "cosine", J.HNSWParameters(collection_size=600,
                                                    pack_queries="on"))
    ji.add(vecs)
    return vecs, ji


@pytest.fixture(scope="module", params=["sq_euclid", "cosine"])
def loaded(request):
    """sq_euclid: the 2,000 x 128 graph of test_torch_construct; cosine: a
    600 x 32 clustered graph."""
    metric = request.param
    rng = np.random.default_rng(7)
    if metric == "sq_euclid":
        vecs = TCT.corpus()
        ji = TCT.jax_build()._impl
    else:
        vecs = _cosine_corpus(rng)
        ji = cosine_build()[1]
    leaves = {f: np.asarray(getattr(ji._state, f)) for f in convert.FIELDS}
    tcfg = TG.GraphConfig(**dataclasses.asdict(ji._cfg))
    tstate = convert.state_from_numpy(leaves, tcfg, "cpu")
    jp = ji._get_pack()
    tp = TP.make_query_pack(tcfg, tstate,
                            torch.from_numpy(np.array(jp.entry_ids)))
    q = vecs[:300] + 0.02 * rng.standard_normal(
        (300, vecs.shape[1])).astype(np.float32)
    return metric, ji, jp, leaves, tcfg, tstate, tp, q


def test_state_round_trip(loaded):
    _, _, _, leaves, _, tstate, _, _ = loaded
    back = convert.state_to_numpy(tstate)
    for f in convert.FIELDS:
        assert back[f].dtype == leaves[f].dtype, f
        np.testing.assert_array_equal(back[f], leaves[f], err_msg=f)


def test_pack_tables_match_reference(loaded):
    metric, _, jp, _, _, _, tp, _ = loaded
    np.testing.assert_array_equal(tp.nbr0.numpy(), np.asarray(jp.nbr0))
    jres = np.asarray(jp.res).view(np.int16).astype(np.int32)
    tres = tp.res.view(torch.int16).numpy().astype(np.int32)
    if metric == "sq_euclid":
        np.testing.assert_array_equal(tres, jres)
    else:
        assert (tres == jres).mean() >= 0.999
        np.testing.assert_allclose(tp.res.float().numpy(),
                                   np.asarray(jp.res, np.float32),
                                   rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(tp.aux.numpy(), np.asarray(jp.aux),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp.base.numpy(), np.asarray(jp.base),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tp.entry_ids.numpy(),
                                  np.asarray(jp.entry_ids))


def test_packed_search_ids_match_reference(loaded):
    metric, ji, jp, _, tcfg, _, tp, q = loaded
    max_iters = (8 * EF) // 4 + 16
    _, jids = JP.packed_knn_search(ji._cfg, jp, jnp.asarray(q), EF,
                                   max_iters, expand=4, n_entry=8)
    _, tids = TP.packed_knn_search(tcfg, tp, torch.from_numpy(q), EF,
                                   max_iters, expand=4, n_entry=8)
    agree = (tids.numpy() == np.asarray(jids)).mean()
    assert agree >= 0.99, agree


def test_rank_distance_identity_on_port_tables(loaded):
    """The pack's rank distance is the exact distance from q to the
    bf16-rounded neighbour u + r: ||q-u||^2 - 2(q-u).r + aux for sq_euclid
    (aux = ||r||^2 after rounding), (1 - q.u) - q.r for cosine (unit q
    and base)."""
    metric, _, _, _, _, _, tp, q = loaded
    rng = np.random.default_rng(3)
    res = tp.res.float().numpy().astype(np.float64)
    base = tp.base.numpy().astype(np.float64)
    aux = tp.aux.numpy().astype(np.float64)
    nbr = tp.nbr0.numpy()
    for _ in range(50):
        u = int(rng.integers(0, nbr.shape[0]))
        j = int(rng.integers(0, max(1, (nbr[u] >= 0).sum())))
        r = res[u, j]
        qq = q[int(rng.integers(0, len(q)))].astype(np.float64)
        if metric == "sq_euclid":
            rank_d = ((qq - base[u]) ** 2).sum() \
                - 2.0 * ((qq - base[u]) * r).sum() + aux[u, j]
            exact_d = ((qq - (base[u] + r)) ** 2).sum()
            assert abs(aux[u, j] - (r * r).sum()) \
                <= 1e-6 * (r * r).sum() + 1e-12
        else:
            qq /= np.linalg.norm(qq)
            rank_d = (1.0 - qq @ base[u]) - qq @ r
            exact_d = 1.0 - qq @ (base[u] + r)
            assert aux[u, j] == 0.0
        assert abs(rank_d - exact_d) <= 1e-6 * (1.0 + abs(exact_d))
