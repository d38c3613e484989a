"""Distance metrics as tensor functions.

Counterpart of ``hnswindex_tpu/ops/distance.py``.  Every built-in metric is
one batched dot product plus per-vector norm data cached beside the stored
vectors:

* ``sq_euclid``:  ||a-b||^2   = ||a||^2 + ||b||^2 - 2 a.b
* ``cosine``:     1 - a.b / (||a|| ||b||), with the reference's zero-norm
  guard returning exactly 1 (CosineMetric.cs:88-91).
* ``ucosine``:    1 - a.b (pre-normalized vectors, CosineMetric.cs:95).

Float32 products must run in full float32: TF32 keeps ~3 decimal digits,
which scrambles near-tie neighbour rankings.  ``HNSWIndex`` checks the
PyTorch matmul precision settings on a CUDA device and refuses TF32.
bfloat16 operands are products of bf16 values accumulated in float32 (the
reference's ``preferred_element_type=f32``): they are widened to float32
before the product, because a bf16 ``torch.matmul`` also rounds its output
to bf16.
"""

from __future__ import annotations

import torch

VALID_METRICS = ("sq_euclid", "cosine", "ucosine")


def register_metric(name: str, fn) -> None:
    """Custom metrics run the beam-path build and the custom pack branch,
    neither of which is ported yet."""
    raise NotImplementedError(
        "custom metrics are not ported yet (ROADMAP queue 1 item 9)")


def is_custom(metric: str) -> bool:
    """True for a registered metric; the built-ins are dot-decomposable."""
    return metric not in VALID_METRICS


def check_metric(metric: str) -> None:
    if metric not in VALID_METRICS:
        raise ValueError(
            f"unknown metric {metric!r}; expected one of {VALID_METRICS}")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def norm_data(metric: str, v: torch.Tensor) -> torch.Tensor:
    """Per-vector norm data: squared L2 (sq_euclid), L2 (cosine) or zeros
    (ucosine).  Shape ``v[..., D] -> v[...]``."""
    if metric == "sq_euclid":
        return torch.sum(v * v, dim=-1)
    if metric == "cosine":
        return torch.sqrt(torch.sum(v * v, dim=-1))
    return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)


def from_dot(metric: str, dot, qn, cn):
    """Distance from a dot product plus both vectors' norm data
    (broadcasting)."""
    if metric == "sq_euclid":
        # (qn + cn) - 2 dot in one pass over the product: 2 dot is exact,
        # so this rounds as the three-pass form does
        return torch.sub(qn + cn, dot, alpha=2.0)
    if metric == "cosine":
        denom = qn * cn
        return torch.where(denom > 0.0, 1.0 - dot / denom,
                           torch.ones_like(dot))
    return 1.0 - dot


def pairwise(metric: str, q: torch.Tensor, x: torch.Tensor,
             qn=None, xn=None) -> torch.Tensor:
    """All-pairs distances ``(B, D) x (N, D) -> (B, N)``."""
    dots = _f32(q) @ _f32(x).T
    if qn is None:
        qn = norm_data(metric, q)
    if xn is None:
        xn = norm_data(metric, x)
    return from_dot(metric, dots, qn[:, None], xn[None, :])


def gathered(metric: str, q: torch.Tensor, qn: torch.Tensor,
             cvecs: torch.Tensor, cn: torch.Tensor) -> torch.Tensor:
    """Distances from each query to its own candidates:
    ``q (B, D)``, ``cvecs (B, K, D)`` -> ``(B, K)``.  A bf16 candidate table
    takes the query at bf16 too (reference ``gathered``)."""
    qc = q.to(cvecs.dtype)
    dots = torch.bmm(_f32(cvecs), _f32(qc)[:, :, None])[:, :, 0]
    return from_dot(metric, dots, qn[:, None], cn)


def exact(metric: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct-formula distance, broadcasting over leading dims (oracles and
    result refinement)."""
    if metric == "sq_euclid":
        d = a - b
        return torch.sum(d * d, dim=-1)
    dot = torch.sum(a * b, dim=-1)
    if metric == "cosine":
        na = torch.sqrt(torch.sum(a * a, dim=-1))
        nb = torch.sqrt(torch.sum(b * b, dim=-1))
        denom = na * nb
        return torch.where(denom > 0.0, 1.0 - dot / denom,
                           torch.ones_like(dot))
    return 1.0 - dot
