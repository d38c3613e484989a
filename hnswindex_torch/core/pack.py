"""Packed-neighbourhood serving engine for layer-0 k-NN queries.

Counterpart of ``hnswindex_tpu/core/pack.py``.  The pack lays each node's
layer-0 neighbourhood out contiguously so one expansion is one tile fetch:

* ``res (C, K, D) bf16`` — residuals ``r = v - u`` of u's neighbours v.
  A bf16 residual perturbs a neighbour by ~0.4% of its distance to its
  parent, where an absolute bf16 vector would carry ~0.4% of the global
  magnitude as noise.
* ``aux (C, K) f32`` — ``||r||^2`` after rounding (sq_euclid; zeros for the
  cosine family), so the rank distance
  ``||q-u||^2 - 2(q-u).r + ||r||^2`` is the exact distance to the rounded
  neighbour; cosine ranks by ``(1 - q.u) - q.r``.
* ``base (C, D) f32`` — parent vectors (normalized for cosine).
* an entry set: every node of the lowest upper level whose population is at
  most ``ENTRY_SCAN_MAX``, scored exactly against each query in place of
  the upper-layer greedy descent.

``packed_knn_search`` serves unfiltered and mask-filtered queries.  A
registered metric scores the entry set elementwise (``_entry_scan_custom``)
and each expansion on neighbours rebuilt as ``u + r`` from their residuals.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import distance as dst
from .graph import GraphConfig, GraphState
from .search import _dedupe_new, _merge_pool

_INF = float("inf")

#: Largest compacted entry set the flat entry scan takes on.
ENTRY_SCAN_MAX = 131072

#: Entry-set cap for custom metrics, whose entry scan is elementwise (no
#: matmul): the pack enters one level higher up the hierarchy.
ENTRY_SCAN_MAX_CUSTOM = 8192


def entry_scan_cap(metric: str) -> int:
    return ENTRY_SCAN_MAX_CUSTOM if dst.is_custom(metric) \
        else ENTRY_SCAN_MAX

#: Row chunk for the pack build (bounds the f32 gather intermediate).
_BUILD_CHUNK = 1 << 16


class QueryPack(NamedTuple):
    """Device tables for packed layer-0 serving (see module docstring)."""
    nbr0: torch.Tensor         # (C, K) i32  layer-0 adjacency
    res: torch.Tensor          # (C, K, D) bf16 neighbour residuals v - u
    aux: torch.Tensor          # (C, K) f32  ||r||^2 (sq_euclid) / zeros
    base: torch.Tensor         # (C, D) f32  parent vectors (normed: cosine)
    entry_ids: torch.Tensor    # (S,)  i32   high-level node ids, -1 pad
    entry_vecs: torch.Tensor   # (S, D) f32  their (normed) vectors
    entry_norms: torch.Tensor  # (S,)  f32


def pack_bytes(capacity: int, k: int, dim: int,
               res_dtype=torch.bfloat16) -> int:
    """Device footprint of a pack: residuals + f32 aux / i32 ids + f32
    base table."""
    rb = torch.empty((), dtype=res_dtype).element_size()
    return capacity * k * (dim * rb + 4 + 4) + capacity * dim * 4


def make_query_pack(cfg: GraphConfig, state: GraphState,
                    entry_ids: torch.Tensor,
                    res_dtype=torch.bfloat16) -> QueryPack:
    """Build the pack from the graph state.  ``entry_ids (S,)`` is the
    host-compacted entry set (-1 padded).  Residuals are computed in f32 and
    rounded to ``res_dtype`` chunk by chunk."""
    C = state.capacity
    # tiles stop at the 2M degree cap: slack columns hold recent arrivals
    # that the next overflow prune may discard
    K = min(state.nbr0.shape[1], 2 * cfg.max_edges)
    D = cfg.dim
    nbr0 = state.nbr0[:, :K].contiguous()
    dev = state.device

    base = state.vectors
    if cfg.metric == "cosine":
        n = torch.linalg.norm(base, dim=1, keepdim=True)
        base = torch.where(n > 0, base / torch.where(n > 0, n, 1.0), 0.0)

    res = torch.empty((C, K, D), dtype=res_dtype, device=dev)
    aux = torch.empty((C, K), dtype=torch.float32, device=dev)
    for r0 in range(0, C, _BUILD_CHUNK):
        r1 = min(C, r0 + _BUILD_CHUNK)
        idx = nbr0[r0:r1].long().clamp(0, C - 1)
        r = (base[idx] - base[r0:r1, None, :]).to(res_dtype)
        rf = r.float()
        res[r0:r1] = r
        aux[r0:r1] = torch.sum(rf * rf, dim=-1)
    if cfg.metric != "sq_euclid":
        aux.zero_()

    esafe = entry_ids.long().clamp(0, C - 1)
    evecs = base[esafe]
    return QueryPack(nbr0=nbr0, res=res, aux=aux, base=base,
                     entry_ids=entry_ids.to(torch.int32),
                     entry_vecs=evecs,
                     entry_norms=dst.norm_data(cfg.metric, evecs))


def _entry_scan(cfg: GraphConfig, pack: QueryPack, q, qn, n_entry: int):
    """Exact top-``n_entry`` of the entry set per query.  Returns
    (dists (B, R), ids (B, R)) ascending."""
    dots = q @ pack.entry_vecs.T
    d = dst.from_dot(cfg.metric, dots, qn[:, None], pack.entry_norms[None, :])
    d = torch.where(pack.entry_ids[None, :] >= 0, d, _INF)
    R = min(n_entry, d.shape[1])
    ed, ei = torch.topk(d, R, dim=1, largest=False)
    ids = pack.entry_ids.long()[ei]
    fin = torch.isfinite(ed)
    return torch.where(fin, ed, _INF), torch.where(fin, ids, -1)


def _entry_scan_custom(metric: str, pack: QueryPack, q, n_entry: int):
    """_entry_scan for a registered metric, which has no dot decomposition:
    the entry set is scored elementwise in chunks of 2,048 entries, which
    bound the (B, chunk, D) broadcast.  Same contract as _entry_scan."""
    S = pack.entry_vecs.shape[0]
    chunk = min(S, 2048)
    d = torch.cat([dst.exact(metric, q[:, None, :],
                             pack.entry_vecs[None, r0:r0 + chunk]).float()
                   for r0 in range(0, S, chunk)], dim=1)
    d = torch.where(pack.entry_ids[None, :] >= 0, d, _INF)
    R = min(n_entry, S)
    ei = torch.argsort(d, dim=1, stable=True)[:, :R]
    ed = torch.gather(d, 1, ei)
    ids = pack.entry_ids.long()[ei]
    fin = torch.isfinite(ed)
    return torch.where(fin, ed, _INF), torch.where(fin, ids, -1)


def packed_knn_search(cfg: GraphConfig, pack: QueryPack, q: torch.Tensor,
                      ef: int, max_iters: int, filtered: bool = False,
                      filter_mask=None, expand: int = 4, n_entry: int = 8):
    """Layer-0 k-NN over the packed layout (KnnQuery semantics,
    HNSWIndex.cs:107-123, with the entry descent replaced by the flat
    scan).  Each step expands each query's ``expand`` closest unexpanded
    pool entries.  ``filtered`` with a (C,) bool ``filter_mask`` returns a
    second pool that keeps only allowed ids (filtered-out nodes still steer
    the walk).  Returns (dists (B, ef), ids (B, ef)) ascending, -1/inf
    padded; distances are rank distances that callers refine."""
    B = q.shape[0]
    C, K = pack.nbr0.shape
    dev = q.device
    P = min(expand, ef)
    R = min(n_entry, ef, pack.entry_ids.shape[0])
    sq = cfg.metric == "sq_euclid"

    if cfg.metric == "cosine":
        qmag = torch.linalg.norm(q, dim=1, keepdim=True)
        qh = torch.where(qmag > 0, q / torch.where(qmag > 0, qmag, 1.0), 0.0)
    else:
        qh = q
    qn = dst.norm_data(cfg.metric, qh)
    custom = dst.is_custom(cfg.metric)
    if custom:
        ed, eid = _entry_scan_custom(cfg.metric, pack, qh, R)
    else:
        ed, eid = _entry_scan(cfg, pack, qh, qn, R)

    bd = torch.full((B, ef), _INF, dtype=torch.float32, device=dev)
    bi = torch.full((B, ef), -1, dtype=torch.int64, device=dev)
    bd[:, :R] = ed[:, :R]
    bi[:, :R] = eid[:, :R]
    bx = torch.zeros((B, ef), dtype=torch.int32, device=dev)
    if filtered:
        allow0 = filter_mask[eid.clamp(0, C - 1)] & (eid >= 0)
        rd = torch.full((B, ef), _INF, dtype=torch.float32, device=dev)
        ri = torch.full((B, ef), -1, dtype=torch.int64, device=dev)
        rd[:, :R] = torch.where(allow0, ed, _INF)[:, :R]
        ri[:, :R] = torch.where(allow0, eid, -1)[:, :R]

    # the query at the residual precision, widened for an f32 product
    qh16 = qh.to(pack.res.dtype).float()
    colpos = torch.arange(ef, device=dev)[None, :]
    for _ in range(max_iters):
        unexp = (bx == 0) & (bi >= 0)
        if not bool(unexp.any()):
            break
        poskey = torch.where(unexp, colpos, ef + 1)
        pos = torch.sort(poskey, dim=1).values[:, :P]
        has = pos < ef
        posc = pos.clamp(max=ef - 1)
        eidc = torch.gather(bi, 1, posc).clamp(0, C - 1)
        bx = bx.scatter_reduce(1, posc, has.to(torch.int32), reduce="amax")

        nb = pack.nbr0[eidc].long()                      # (B, P, K)
        rt = pack.res[eidc].float()                      # (B, P, K, D)
        at = pack.aux[eidc]                              # (B, P, K)
        uv = pack.base[eidc]                             # (B, P, D)
        if custom:
            # no dot decomposition: rebuild each neighbour as u + r from
            # its residual tile (the residual-rounded point, the pack's
            # usual perturbation) and evaluate the metric elementwise
            nv = uv[:, :, None, :] + rt
            nd = dst.exact(cfg.metric, qh[:, None, None, :], nv).float()
        elif sq:
            qres = qh[:, None, :] - uv                   # (B, P, D) f32
            du = torch.sum(qres * qres, dim=-1)          # exact ||q-u||^2
            qr = qres.to(pack.res.dtype).float()
            dots = torch.einsum("bpkd,bpd->bpk", rt, qr)
            nd = du[:, :, None] - 2.0 * dots + at
        else:
            du = 1.0 - torch.einsum("bpd,bd->bp", uv, qh)
            dots = torch.einsum("bpkd,bd->bpk", rt, qh16)
            nd = du[:, :, None] - dots

        nb = nb.reshape(B, P * K)
        nd = nd.reshape(B, P * K)
        nbv = (nb >= 0) & has.repeat_interleave(K, dim=1)
        fresh = _dedupe_new(torch.where(nbv, nb, -1), nbv, bi)
        nd = torch.where(fresh, nd, _INF)
        nid = torch.where(fresh, nb, -1)

        zeros = torch.zeros_like(nid, dtype=torch.int32)
        bd, bi, bx = _merge_pool(torch.cat([bd, nd], dim=1),
                                 torch.cat([bi, nid], dim=1),
                                 torch.cat([bx, zeros], dim=1), ef)
        if filtered:
            # a node evicted from the walk's pool and met again is fresh
            # there, but may still be in the result pool
            in_res = torch.any(nid[:, :, None] == ri[:, None, :], dim=2)
            allow = filter_mask[nid.clamp(0, C - 1)] & fresh & ~in_res
            rd, ri, _ = _merge_pool(
                torch.cat([rd, torch.where(allow, nd, _INF)], dim=1),
                torch.cat([ri, torch.where(allow, nid, -1)], dim=1),
                torch.cat([torch.zeros_like(ri, dtype=torch.int32), zeros],
                          dim=1), ef)
    if filtered:
        return rd, ri
    return bd, bi
