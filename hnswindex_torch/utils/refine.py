"""Result refinement for every index front end.

Counterpart of ``hnswindex_tpu/utils/refine.py``.  Search ranks with f32
or bf16-residual distances; the returned (id, distance) pairs are then
recomputed with the direct metric formula and re-sorted (the reference's
metric_test.py oracle tolerance is 1e-5):

* ``refine_pairs`` — float64 on the host against a host mirror of the
  stored vectors, while the corpus is small enough to mirror (a registered
  metric's callable runs in float32 on CPU tensors, as in the reference);
* ``refine_on_device`` — direct-formula float32 on the devices that hold
  the vectors, moving only the final (B, k) pairs to the host.

``HostMirror`` chooses between them for a facade, by ``MIRROR_MAX_BYTES``.
``in_batches`` is the query-batch loop of the front ends.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from ..ops import distance as dst

#: queries per search launch and per refine call
QUERY_BATCH = 1024
#: host-mirror budget: while the stored vectors (S tables of (C, D) float32)
#: take at most this many bytes, results refine in float64 on the host
MIRROR_MAX_BYTES = 1 << 31


def in_batches(n: int, k: int,
               step: Callable[[int, int], Tuple[np.ndarray, np.ndarray]]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Run ``step(i, j)`` (the (ids, dists) of queries ``i:j``, each
    ``(j - i, k)``) over ``n`` queries in slices of QUERY_BATCH, and stack
    the results as (ids (n, k) int32, dists (n, k) f32)."""
    out_ids = np.empty((n, k), np.int32)
    out_d = np.empty((n, k), np.float32)
    for i in range(0, n, QUERY_BATCH):
        j = min(n, i + QUERY_BATCH)
        out_ids[i:j], out_d[i:j] = step(i, j)
    return out_ids, out_d


def direct64(metric: str, qq: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """A built-in metric's direct formula in float64 over the last axis of
    ``qq`` and ``vecs`` (broadcast against each other; a zero norm gives
    cosine distance 1)."""
    if metric == "sq_euclid":
        return np.sum((qq - vecs) ** 2, axis=-1)
    dot = np.sum(qq * vecs, axis=-1)
    if metric == "cosine":
        denom = np.linalg.norm(qq, axis=-1) * np.linalg.norm(vecs, axis=-1)
        return np.where(denom > 0, 1.0 - dot / np.where(denom > 0, denom,
                                                        1.0), 1.0)
    return 1.0 - dot


def refine_pairs(metric: str, q: np.ndarray, ids: np.ndarray,
                 cand_vecs: np.ndarray, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Re-rank candidate rows in float64.

    ``q (B, D)``, ``ids (B, W)`` int (-1 pad), ``cand_vecs (B, W, D)`` the
    stored vectors of those ids (rows for -1 entries may be garbage).
    Returns (ids (B, k) int32, dists (B, k) f32) ascending with -1/NaN
    padding (HNSWIndexExports.cs:144).

    While ``torch.profiler`` records, the call is the range
    ``hnsw/refine``: host work only, so the range leaves no device event."""
    if _profiler._is_profiler_enabled:
        with _profiler.record_function("hnsw/refine"):
            return _refine_pairs(metric, q, ids, cand_vecs, k)
    return _refine_pairs(metric, q, ids, cand_vecs, k)


def _refine_pairs(metric: str, q: np.ndarray, ids: np.ndarray,
                  cand_vecs: np.ndarray, k: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    B = q.shape[0]
    ids = np.asarray(ids)
    if ids.shape[1] < k:
        pad = k - ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        cand_vecs = np.pad(cand_vecs, ((0, 0), (0, pad), (0, 0)))
    if dst.is_custom(metric):
        # a registered callable runs in float32 on CPU tensors, as the
        # reference evaluates it in float32
        d = dst.exact(metric,
                      torch.from_numpy(np.asarray(q, np.float32)[:, None]),
                      torch.from_numpy(np.asarray(cand_vecs, np.float32)))
        d = d.numpy().astype(np.float64)
    else:
        d = direct64(metric, q.astype(np.float64)[:, None, :],
                     cand_vecs.astype(np.float64))
    d = np.where(ids >= 0, d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    rows = np.arange(B)[:, None]
    out_ids = np.take_along_axis(ids, order, axis=1)
    out_d = d[rows, order].astype(np.float32)
    out_d = np.where(out_ids >= 0, out_d, np.nan)
    return out_ids.astype(np.int32), out_d


def refine_on_device(metric: str,
                     vectors: torch.Tensor | Sequence[torch.Tensor],
                     q: np.ndarray, ids: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather + direct-formula f32 distances + re-sort on the devices, then
    move only the (B, k) results.  Same contract as :func:`refine_pairs`,
    except that a non-finite distance is returned as -1/NaN.

    ``vectors`` is one ``(C, D)`` table, or S tables whose ids interleave
    (id g is row ``g // S`` of table ``g % S``).  Each table scores the
    lanes it owns on its own device; only the (B, W) distances move to the
    first table's device, which sums them and sorts."""
    tables = [vectors] if isinstance(vectors, torch.Tensor) else vectors
    ids = np.asarray(ids)
    if ids.shape[1] < k:
        ids = np.pad(ids, ((0, 0), (0, k - ids.shape[1])),
                     constant_values=-1)
    S = len(tables)
    d0 = tables[0].device
    gt = torch.as_tensor(ids.astype(np.int64))
    parts = []
    for s, vv in enumerate(tables):
        g = gt.to(vv.device)
        qt = torch.as_tensor(np.asarray(q, np.float32), device=vv.device)
        rows = vv[(g // S).clamp(0, vv.shape[0] - 1)]          # (B, W, D)
        d = dst.exact(metric, qt[:, None, :], rows).float()
        parts.append(torch.where((g >= 0) & (g % S == s), d, 0.0).to(d0))
    total = torch.where(gt.to(d0) >= 0, sum(parts[1:], parts[0]),
                        float("inf"))
    order = torch.argsort(total, dim=1, stable=True)[:, :k]
    out_ids = torch.gather(gt.to(d0), 1, order).cpu().numpy()
    out_d = torch.gather(total, 1, order).cpu().numpy()
    out_ids = np.where(np.isfinite(out_d), out_ids, -1).astype(np.int32)
    return out_ids, np.where(out_ids >= 0, out_d, np.nan).astype(np.float32)


class HostMirror:
    """Where a facade's full-precision answer is computed.

    ``tables()`` returns the facade's current per-shard ``(C, D)`` vector
    tables (one for ``HNSWIndex``; ids interleave across several, as in
    :func:`refine_on_device`), read at each call because growth replaces
    them.  While they fit ``MIRROR_MAX_BYTES`` together, row fetches read a
    host copy, built on first use and kept until ``clear()`` (every
    mutation), and refinement runs on it in float64; beyond, both run on
    the devices."""

    def __init__(self, metric: str,
                 tables: Callable[[], Sequence[torch.Tensor]]):
        self.metric = metric
        self._tables = tables
        self._host: Optional[np.ndarray] = None

    def clear(self) -> None:
        self._host = None

    def mirrorable(self) -> bool:
        t = self._tables()
        return len(t) * t[0].shape[0] * t[0].shape[1] * 4 <= MIRROR_MAX_BYTES

    def host(self) -> np.ndarray:
        """``(S*C, D)`` host copy of the stored vectors, row g holding id g
        (built whatever the budget; callers check ``mirrorable``)."""
        if self._host is None:
            hv = [v.cpu().numpy() for v in self._tables()]
            self._host = hv[0] if len(hv) == 1 else np.stack(
                hv, axis=1).reshape(-1, hv[0].shape[1])
        return self._host

    def rows(self, ids) -> np.ndarray:
        """Stored vectors of a (small) id set, ``ids.shape + (D,)``: the
        host copy under the budget, a gather on each table's device above
        it."""
        t = self._tables()
        S = len(t)
        g = np.clip(np.asarray(ids, np.int64), 0, S * t[0].shape[0] - 1)
        if self.mirrorable():
            return self.host()[g]
        out = np.zeros(g.shape + (t[0].shape[1],), np.float32)
        for s, vv in enumerate(t):
            own = g % S == s
            if own.any():
                out[own] = vv[torch.as_tensor(g[own] // S).to(
                    vv.device)].cpu().numpy()
        return out

    def refine(self, q: np.ndarray, ids: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Recompute returned distances with the direct formula and
        re-sort: float64 on the host copy under the budget, float32 on the
        devices above it."""
        if self.mirrorable():
            return refine_pairs(self.metric, q, ids, self.rows(ids), k)
        return refine_on_device(self.metric, self._tables(), q, ids, k)

    def refine_batched(self, q: np.ndarray, ids: np.ndarray, k: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        return in_batches(q.shape[0], k,
                          lambda i, j: self.refine(q[i:j], ids[i:j], k))
