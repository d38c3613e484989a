"""Batched graph traversal: greedy descent, beam search and range search.

Counterpart of ``hnswindex_tpu/core/search.py`` (the reference's
GraphNavigator.cs:27-325), with the same names and contracts:

* ``greedy_descent`` — the upper-layer entry walk (FindEntryPoint): each
  step moves every active query to its closest closer neighbour, or one
  layer down when none is closer.
* ``beam_search`` — SearchLayer: a sorted (dist, id, expanded) pool of
  width ``ef`` per query; each step expands the ``expand`` closest
  unexpanded entries and merges their fresh neighbours.  A query is done
  when its pool holds no unexpanded entry.  ``filtered`` keeps a second
  pool of the allowed ids only (filtered-out nodes still steer the walk).
* ``range_search`` — SearchLayerRange: only in-radius neighbours join the
  pool, every pool entry is expanded, and ``saturated`` flags a pool too
  small for the answer so that the caller retries wider.
* ``knn_search`` — greedy descent from the global entry point to
  ``layer``, then the beam.

Each ``lax.while_loop`` of the reference is a Python loop over tensor
steps.  A step leaves a finished query unchanged (it has no entry to
expand, so nothing is gathered or merged), so the loops ask the device
whether any query is still running only every ``CHECK_EVERY`` steps; the
step count stays within ``max_iters`` as in the reference, and the results
are those of a loop that checks every step.  ``lax.approx_min_k`` does not
occur here: every selection is an exact sort.
"""

from __future__ import annotations

import torch

from ..ops import distance as dst
from .graph import GraphConfig, GraphState, nbr_slice, upper_rows

_INF = float("inf")
#: steps between two host checks of the loops' termination
CHECK_EVERY = 4


def _dist_to_nodes(metric: str, q, qn, vectors, norms, ids):
    """Distances from each query ``q (B, D)`` to its own node ids: ``ids``
    is (B,) or (B, K).  ``vectors`` is the ranking table (float32 or
    bfloat16; a bfloat16 table takes the query at bfloat16 too, with
    float32 sums)."""
    C = vectors.shape[0]
    idc = ids.long().clamp(0, C - 1)
    if ids.dim() == 1:
        qc = q.to(vectors.dtype).float()
        dots = torch.sum(qc * vectors[idc].float(), dim=1)
        return dst.from_dot(metric, dots, qn, norms[idc])
    return dst.gathered(metric, q, qn, vectors[idc], norms[idc])


def _merge_pool(keys, ids, flags, width: int):
    """Keep the ``width`` closest (dist, id, flag) triples, ascending; a
    stable sort keeps the earlier entry on equal keys."""
    order = torch.argsort(keys, dim=1, stable=True)[:, :width]
    return (torch.gather(keys, 1, order), torch.gather(ids, 1, order),
            torch.gather(flags, 1, order))


def _dedupe_new(nid, fresh, pool_ids):
    """Drop candidates already in the pool or duplicated within the
    expansion batch (first occurrence wins); replaces the reference's
    VisitedList (VisitedListPool.cs) without per-query visited storage."""
    B, PK = nid.shape
    in_pool = torch.any(nid[:, :, None] == pool_ids[:, None, :], dim=2)
    if PK <= 128:
        eq = nid[:, :, None] == nid[:, None, :]
        ar = torch.arange(PK, device=nid.device)
        earlier = ar[None, :, None] > ar[None, None, :]
        dup_self = torch.any(eq & earlier, dim=2)
    else:
        order = torch.argsort(nid, dim=1, stable=True)
        snid = torch.gather(nid, 1, order)
        sdup = torch.cat([torch.zeros((B, 1), dtype=torch.bool,
                                      device=nid.device),
                          snid[:, 1:] == snid[:, :-1]], dim=1)
        dup_self = torch.zeros_like(sdup).scatter_(1, order, sdup)
    return fresh & ~in_pool & ~dup_self


def _running(it: int, pending: torch.Tensor) -> bool:
    """False once no query has work left; asks the device only every
    CHECK_EVERY steps (``pending`` is computed on the device)."""
    return it % CHECK_EVERY != 0 or bool(pending.any())


def greedy_descent(cfg: GraphConfig, state: GraphState, q, qn, start,
                   start_layer, stop_layer, max_iters: int = 4096):
    """Walk layers start_layer .. stop_layer+1 per query, moving to the
    closest closer neighbour within a layer before stepping down; layers
    <= stop_layer are not walked (FindEntryPoint, GraphNavigator.cs:27-45).

    ``start``, ``start_layer``, ``stop_layer`` are (B,).  Returns the (B,)
    entry node for layer ``stop_layer`` (int64) and its distance."""
    B = q.shape[0]
    C = state.capacity
    rows = torch.arange(B, device=q.device)
    cur = start.long()
    lay = start_layer.long()
    stop = stop_layer.long()
    curd = _dist_to_nodes(cfg.metric, q, qn, state.vlo, state.norms, cur)
    for it in range(max_iters):
        act = (lay > stop) & (cur >= 0)
        if not _running(it, act):
            break
        nb = upper_rows(state, lay, cur.clamp(0, C - 1)).long()
        nbv = (nb >= 0) & act[:, None]
        nd = _dist_to_nodes(cfg.metric, q, qn, state.vlo, state.norms,
                            torch.where(nbv, nb, 0))
        nd = torch.where(nbv, nd, _INF)
        best = torch.argmin(nd, dim=1)
        bd = nd[rows, best]
        improved = (bd < curd) & act
        cur = torch.where(improved, nb[rows, best], cur)
        curd = torch.where(improved, bd, curd)
        # no closer neighbour at this layer: descend, same node
        lay = torch.where(act & ~improved, lay - 1, lay)
    return cur, curd


def beam_search(cfg: GraphConfig, state: GraphState, q, qn, ep, ep_ok,
                layer: int, ef: int, max_iters: int, filtered: bool = False,
                filter_mask=None, expand: int = 1):
    """Best-first beam search at one layer (SearchLayer,
    GraphNavigator.cs:123-256).

    ``q (B, D)``, ``qn (B,)``; ``ep (B,)`` entry nodes, ``ep_ok (B,)``
    masks queries with a valid entry (the others return empty pools).
    ``ef`` is the pool width, ``expand`` the entries expanded per step
    (1 = the reference's one pop per step).  ``filtered`` with a (C,) bool
    ``filter_mask`` returns the pool of allowed ids instead.  Returns
    (dists (B, ef) f32, ids (B, ef) int64) ascending, inf/-1 padded."""
    B = q.shape[0]
    C = state.capacity
    dev = q.device
    P = min(expand, ef)
    nbr_l, _ = nbr_slice(state, layer)
    K = nbr_l.shape[1]

    epc = ep.long().clamp(0, C - 1)
    d0 = _dist_to_nodes(cfg.metric, q, qn, state.vlo, state.norms, epc)
    d0 = torch.where(ep_ok, d0, _INF)
    bd = torch.full((B, ef), _INF, dtype=torch.float32, device=dev)
    bi = torch.full((B, ef), -1, dtype=torch.int64, device=dev)
    bd[:, 0] = d0
    bi[:, 0] = torch.where(ep_ok, ep.long(), -1)
    bx = torch.zeros((B, ef), dtype=torch.int32, device=dev)
    if filtered:
        allow0 = filter_mask[epc] & ep_ok
        rd = torch.full((B, ef), _INF, dtype=torch.float32, device=dev)
        ri = torch.full((B, ef), -1, dtype=torch.int64, device=dev)
        rd[:, 0] = torch.where(allow0, d0, _INF)
        ri[:, 0] = torch.where(allow0, ep.long(), -1)

    colpos = torch.arange(ef, device=dev)[None, :]
    for it in range(max_iters):
        unexp = (bx == 0) & (bi >= 0)
        if not _running(it, unexp):
            break
        # pool positions of the P closest unexpanded entries
        poskey = torch.where(unexp, colpos, ef + 1)
        pos = torch.sort(poskey, dim=1).values[:, :P]
        has = pos < ef
        posc = pos.clamp(max=ef - 1)
        eidc = torch.gather(bi, 1, posc).clamp(0, C - 1)
        bx = bx.scatter_reduce(1, posc, has.to(torch.int32), reduce="amax")

        nb = nbr_l[eidc].reshape(B, P * K).long()
        nbv = (nb >= 0) & has.repeat_interleave(K, dim=1)
        fresh = _dedupe_new(torch.where(nbv, nb, -1), nbv, bi)
        nd = _dist_to_nodes(cfg.metric, q, qn, state.vlo, state.norms,
                            torch.where(fresh, nb, 0))
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
                torch.zeros((B, ef + P * K), dtype=torch.int32,
                            device=dev), ef)
    if filtered:
        return rd, ri
    return bd, bi


def range_search(cfg: GraphConfig, state: GraphState, q, qn, ep, ep_ok,
                 layer: int, radius: float, pool: int, max_iters: int,
                 filtered: bool = False, filter_mask=None):
    """All nodes within ``radius`` reachable through in-radius nodes
    (SearchLayerRange, GraphNavigator.cs:262-325): only neighbours with
    d <= radius join the pool (:303), and every pool entry is expanded,
    the entries too even when out of range (:277).

    ``ep``/``ep_ok`` are (B,) single seeds or (B, E) multi-seeds (a k-NN
    beam's pool: in-range pockets not linked to one entry through in-range
    nodes are reached too).  Returns (dists (B, pool), ids (B, pool),
    saturated (B,) bool); ``saturated`` is ``n_occ + E >= pool``: the pool
    could have evicted an unexpanded seed, so the caller retries wider.
    ``filtered`` with a (C,) bool ``filter_mask`` drops disallowed ids from
    the result after the walk (they still steer it and still count towards
    ``saturated``)."""
    B = q.shape[0]
    C = state.capacity
    dev = q.device
    rows = torch.arange(B, device=dev)
    nbr_l, _ = nbr_slice(state, layer)
    r = torch.tensor(radius, dtype=torch.float32, device=dev)

    if ep.dim() == 1:
        ep, ep_ok = ep[:, None], ep_ok[:, None]
    E = min(ep.shape[1], pool)
    ep = ep[:, :E].long()
    ep_ok = ep_ok[:, :E] & (ep >= 0)
    epc = ep.clamp(0, C - 1)
    d0 = dst.gathered(cfg.metric, q, qn, state.vlo[epc], state.norms[epc])
    bd = torch.full((B, pool), _INF, dtype=torch.float32, device=dev)
    bi = torch.full((B, pool), -1, dtype=torch.int64, device=dev)
    bd[:, :E] = torch.where(ep_ok, d0, _INF)
    bi[:, :E] = torch.where(ep_ok, ep, -1)
    bx = torch.zeros((B, pool), dtype=torch.int32, device=dev)

    for it in range(max_iters):
        unexp = (bx == 0) & (bi >= 0)
        if not _running(it, unexp):
            break
        has = unexp.any(dim=1)
        pos = torch.argmax(unexp.to(torch.int32), dim=1)
        eidc = bi[rows, pos].clamp(0, C - 1)
        bx[rows, pos] = 1

        nb = nbr_l[eidc].long()
        nbv = (nb >= 0) & has[:, None]
        fresh = _dedupe_new(torch.where(nbv, nb, -1), nbv, bi)
        nd = _dist_to_nodes(cfg.metric, q, qn, state.vlo, state.norms,
                            torch.where(fresh, nb, 0))
        keep = fresh & (nd <= r)                 # GraphNavigator.cs:303
        nd = torch.where(keep, nd, _INF)
        nid = torch.where(keep, nb, -1)
        zeros = torch.zeros_like(nid, dtype=torch.int32)
        bd, bi, bx = _merge_pool(torch.cat([bd, nd], dim=1),
                                 torch.cat([bi, nid], dim=1),
                                 torch.cat([bx, zeros], dim=1), pool)

    ok = (bi >= 0) & (bd <= r)
    # the E seed slots count too: an out-of-range seed evicted before its
    # expansion would have lost its in-range pocket
    saturated = ok.sum(dim=1) + E >= pool
    if filtered:
        ok = ok & filter_mask[bi.clamp(0, C - 1)]
    return torch.where(ok, bd, _INF), torch.where(ok, bi, -1), saturated


def knn_search(cfg: GraphConfig, state: GraphState, q, layer: int, ef: int,
               max_iters: int, filtered: bool = False, filter_mask=None,
               expand: int = 1):
    """KnnQuery (HNSWIndex.cs:107-123): greedy descent from the global
    entry point to ``layer``, then a beam of width ``ef`` there.  Returns
    (dists (B, ef), ids (B, ef) int64) ascending."""
    B = q.shape[0]
    C = state.capacity
    qn = dst.norm_data(cfg.metric, q)
    ep = state.ep.long().expand(B)
    ep_ok = ep >= 0
    ep_layer = torch.where(ep_ok, state.level[ep.clamp(0, C - 1)].long(), -1)
    stop = torch.full((B,), layer, dtype=torch.int64, device=q.device)
    entry, _ = greedy_descent(cfg, state, q, qn, ep, ep_layer, stop)
    return beam_search(cfg, state, q, qn, entry, ep_ok, layer, ef, max_iters,
                       filtered, filter_mask, expand)
