"""Plain exact k-NN search: the answers the index is held to.

Plain PyTorch over the vectors the benchmark made; it imports nothing of
the program and takes nothing the program computed.  The two metrics of
the configurations:

* ``sq_euclid``: ||q - x||^2
* ``cosine``:    1 - q.x / (||q|| ||x||)

``topk`` ranks a block of queries against the whole base in float32
matrix products with TF32 off, keeps ``k + MARGIN`` candidates a query, and
ranks those again by the direct formula in float64, so its top-k is the
exact one unless a true neighbour ranks past ``k + MARGIN`` in float32.
With ``precision="tf32"`` it is the control: the same search with the
products in TF32, as the tensor cores make them (operands rounded to
TF32's 10 mantissa bits, products summed in float32; rounded here, so that
the precision does not hang on which kernel the library picks for a shape:
a one-query product runs without the tensor cores), and no float64 pass,
so it returns the TF32 distances.
"""

from __future__ import annotations

import contextlib

import torch

METRICS = ("sq_euclid", "cosine")
MARGIN = 22
Q_BLOCK = 1024
ROW_BLOCK = 1 << 18


def direct(metric: str, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Distances in float64 by the direct formula: ``q (B, D)`` and
    ``x (B, K, D)`` -> ``(B, K)``."""
    q = q.double()[:, None, :]
    x = x.double()
    if metric == "sq_euclid":
        return ((q - x) ** 2).sum(-1)
    if metric == "cosine":
        denom = q.norm(dim=-1) * x.norm(dim=-1)
        return 1.0 - (q * x).sum(-1) / denom
    raise ValueError(f"unknown metric {metric!r}")


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10 explicit mantissa bits, to the
    nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _full_f32(device: torch.device):
    """TF32 off for the products made inside, on a card."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def pairwise(metric: str, q: torch.Tensor, x: torch.Tensor,
             tf32: bool = False) -> torch.Tensor:
    """All-pairs float32 distances ``(B, D) x (N, D) -> (B, N)`` through one
    matrix product."""
    if metric == "cosine":
        q = q / q.norm(dim=-1, keepdim=True)
        x = x / x.norm(dim=-1, keepdim=True)
    if tf32:
        q, x = _tf32_round(q), _tf32_round(x)
    with _full_f32(q.device):
        dots = q @ x.T
    if metric == "sq_euclid":
        return (q * q).sum(-1)[:, None] + (x * x).sum(-1)[None, :] - 2 * dots
    if metric == "cosine":
        return 1.0 - dots
    raise ValueError(f"unknown metric {metric!r}")


def topk(metric: str, base: torch.Tensor, queries: torch.Tensor, k: int,
         precision: str = "exact"):
    """Exact top-``k`` rows of ``base (N, D)`` for ``queries (B, D)``.

    Returns (rows (B, k) int64, distances (B, k)) ascending: float64 for
    ``precision="exact"``, the TF32 float32 distances for ``"tf32"``."""
    if precision not in ("exact", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    tf32 = precision == "tf32"
    keep = min(base.shape[0], k if tf32 else k + MARGIN)
    out_r, out_d = [], []
    for i in range(0, queries.shape[0], Q_BLOCK):
        q = queries[i:i + Q_BLOCK]
        best_d = best_r = None
        for j in range(0, base.shape[0], ROW_BLOCK):
            d = pairwise(metric, q, base[j:j + ROW_BLOCK], tf32)
            dv, dr = torch.topk(d, min(keep, d.shape[1]), dim=1,
                                largest=False)
            dr = dr + j
            if best_d is not None:
                dv = torch.cat([best_d, dv], 1)
                dr = torch.cat([best_r, dr], 1)
                dv, sel = torch.topk(dv, keep, dim=1, largest=False)
                dr = torch.gather(dr, 1, sel)
            best_d, best_r = dv, dr
        if not tf32:
            best_d = direct(metric, q, base[best_r])
            best_d, order = torch.sort(best_d, dim=1, stable=True)
            best_r = torch.gather(best_r, 1, order)
        out_r.append(best_r[:, :k])
        out_d.append(best_d[:, :k])
    return torch.cat(out_r), torch.cat(out_d)
