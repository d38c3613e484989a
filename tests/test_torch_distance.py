"""Port parity: hnswindex_torch.ops.distance against hnswindex_tpu's.

Same numpy inputs through both packages; tolerance rtol=atol=1e-5 (both
sides compute in float32 with products summed in a different order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnswindex_torch.ops import distance as tdst
from hnswindex_tpu.ops import distance as jdst

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(metric, D):
    rng = np.random.default_rng(D)
    q = rng.random((6, D)).astype(np.float32)
    x = rng.random((20, D)).astype(np.float32)
    x[3] = 0.0                                   # zero-norm guard row
    if metric == "ucosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        nz = np.linalg.norm(x, axis=1, keepdims=True)
        x = np.where(nz > 0, x / np.where(nz > 0, nz, 1), 0).astype(
            np.float32)
    return q, x


@pytest.mark.parametrize("D", [127, 128])
@pytest.mark.parametrize("metric", ["sq_euclid", "cosine", "ucosine"])
def test_metric_functions_match_reference(metric, D):
    q, x = _inputs(metric, D)
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    jq, jx = jnp.asarray(q), jnp.asarray(x)

    np.testing.assert_allclose(tdst.norm_data(metric, tx).numpy(),
                               np.asarray(jdst.norm_data(metric, jx)), **TOL)
    np.testing.assert_allclose(tdst.pairwise(metric, tq, tx).numpy(),
                               np.asarray(jdst.pairwise(metric, jq, jx)),
                               **TOL)
    cv = np.broadcast_to(x[None], (6,) + x.shape).copy()
    tn = tdst.norm_data(metric, tx)
    jn = jdst.norm_data(metric, jx)
    got = tdst.gathered(metric, tq, tdst.norm_data(metric, tq),
                        torch.from_numpy(cv), tn[None].expand(6, -1))
    want = jdst.gathered(metric, jq, jdst.norm_data(metric, jq),
                         jnp.asarray(cv), jnp.broadcast_to(jn[None], (6, 20)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tdst.exact(metric, tq[:, None, :], tx[None]).numpy(),
        np.asarray(jdst.exact(metric, jq[:, None, :], jx[None])), **TOL)


def test_bf16_candidates_multiply_in_f32():
    """A bf16 candidate table takes bf16-rounded queries and accumulates
    in f32, like the reference's preferred_element_type=f32."""
    q, x = _inputs("sq_euclid", 128)
    cv = np.broadcast_to(x[None], (6,) + x.shape).copy()
    tq = torch.from_numpy(q)
    tcv = torch.from_numpy(cv).to(torch.bfloat16)
    qn = tdst.norm_data("sq_euclid", tq)
    cn = tdst.norm_data("sq_euclid", tcv.float())
    got = tdst.gathered("sq_euclid", tq, qn, tcv, cn)
    want = jdst.gathered("sq_euclid", jnp.asarray(q),
                         jnp.asarray(qn.numpy()),
                         jnp.asarray(cv, jnp.bfloat16),
                         jnp.asarray(cn.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_metric_validation():
    """Names and registration behave as in the reference: a registered L1
    (torch in the port, jnp in the reference) passes ``check_metric`` and
    gives the reference's pairwise distances; a built-in name and a value
    that cannot be called are refused alike."""
    tdst.check_metric("cosine")
    with pytest.raises(ValueError):
        tdst.check_metric("manhattan")
    tdst.register_metric("l1_validation",
                         lambda a, b: torch.sum(torch.abs(a - b), dim=-1))
    jdst.register_metric("l1_validation",
                         lambda a, b: jnp.sum(jnp.abs(a - b), axis=-1))
    tdst.check_metric("l1_validation")
    q, x = _inputs("sq_euclid", 16)
    np.testing.assert_allclose(
        tdst.pairwise("l1_validation", torch.from_numpy(q),
                      torch.from_numpy(x)).numpy(),
        np.asarray(jdst.pairwise("l1_validation", jnp.asarray(q),
                                 jnp.asarray(x))), **TOL)
    for mod, err, name, fn in ((tdst, ValueError, "cosine", abs),
                               (jdst, ValueError, "cosine", abs),
                               (tdst, TypeError, "not_callable", 3),
                               (jdst, TypeError, "not_callable", 3)):
        with pytest.raises(err):
            mod.register_metric(name, fn)
