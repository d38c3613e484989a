"""Result refinement for every index front end.

Counterpart of ``hnswindex_tpu/utils/refine.py``.  Search ranks with f32
or bf16-residual distances; the returned (id, distance) pairs are then
recomputed with the direct metric formula and re-sorted (the reference's
metric_test.py oracle tolerance is 1e-5):

* ``refine_pairs`` — float64 on the host against a host mirror of the
  stored vectors, while the corpus is small enough to mirror (a registered
  metric's callable runs in float32 on CPU tensors, as in the reference);
* ``refine_on_device`` — direct-formula float32 on the device, moving only
  the final (B, k) pairs to the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import distance as dst


def refine_pairs(metric: str, q: np.ndarray, ids: np.ndarray,
                 cand_vecs: np.ndarray, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Re-rank candidate rows in float64.

    ``q (B, D)``, ``ids (B, W)`` int (-1 pad), ``cand_vecs (B, W, D)`` the
    stored vectors of those ids (rows for -1 entries may be garbage).
    Returns (ids (B, k) int32, dists (B, k) f32) ascending with -1/NaN
    padding (HNSWIndexExports.cs:144)."""
    B = q.shape[0]
    ids = np.asarray(ids)
    if ids.shape[1] < k:
        pad = k - ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        cand_vecs = np.pad(cand_vecs, ((0, 0), (0, pad), (0, 0)))
    vecs = cand_vecs.astype(np.float64)
    qq = q.astype(np.float64)[:, None, :]
    if dst.is_custom(metric):
        # a registered callable runs in float32 on CPU tensors, as the
        # reference evaluates it in float32
        d = dst.exact(metric,
                      torch.from_numpy(np.asarray(q, np.float32)[:, None]),
                      torch.from_numpy(np.asarray(cand_vecs, np.float32)))
        d = d.numpy().astype(np.float64)
    elif metric == "sq_euclid":
        d = np.sum((qq - vecs) ** 2, axis=-1)
    else:
        dot = np.sum(qq * vecs, axis=-1)
        if metric == "cosine":
            qn = np.linalg.norm(qq, axis=-1)
            cn = np.linalg.norm(vecs, axis=-1)
            denom = qn * cn
            d = np.where(denom > 0, 1.0 - dot / np.where(denom > 0,
                                                         denom, 1.0), 1.0)
        else:
            d = 1.0 - dot
    d = np.where(ids >= 0, d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    rows = np.arange(B)[:, None]
    out_ids = np.take_along_axis(ids, order, axis=1)
    out_d = d[rows, order].astype(np.float32)
    out_d = np.where(out_ids >= 0, out_d, np.nan)
    return out_ids.astype(np.int32), out_d


def refine_on_device(metric: str, vectors: torch.Tensor, q: np.ndarray,
                     ids: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather + direct-formula f32 distances + re-sort on the device, then
    move only the (B, k) results.  Same contract as :func:`refine_pairs`."""
    ids = np.asarray(ids)
    if ids.shape[1] < k:
        ids = np.pad(ids, ((0, 0), (0, k - ids.shape[1])),
                     constant_values=-1)
    dev = vectors.device
    C = vectors.shape[0]
    it = torch.as_tensor(ids.astype(np.int64), device=dev)
    qt = torch.as_tensor(np.asarray(q, np.float32), device=dev)
    vv = vectors[it.clamp(0, C - 1)]                     # (B, W, D)
    d = dst.exact(metric, qt[:, None, :], vv).float()
    d = torch.where(it >= 0, d, float("inf"))
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    out_ids = torch.gather(it, 1, order).cpu().numpy().astype(np.int32)
    out_d = torch.gather(d, 1, order).cpu().numpy()
    return out_ids, np.where(out_ids >= 0, out_d, np.nan)
