"""Wave-batched graph construction.

Counterpart of ``hnswindex_tpu/core/construct.py`` (the reference's insert
path, GraphConnector.cs:24-262).  Inserts are batched into *waves*: every
member connects against the frozen pre-wave graph, edges are selected with
the batched heuristic, and the wave's mutations are applied as row
scatters.  A wave takes one of two paths, as the facade chooses:

* exact (while the corpus is at most ``exact_build_threshold`` rows):
  ``scatter_wave`` stores the members; ``upper_connect_exact`` connects
  members with level >= 1 at layers top..1 from exact candidates over the
  upper-node panel; ``base_connect_exact`` connects every member at layer 0
  from the exact efConstruction nearest neighbours of a corpus scan, then
  promotes the entry point (GraphConnector.cs:36-41).
* beam (past the threshold): ``scatter_wave``; ``upper_connect`` descends
  greedily to each upper member's top connect layer and connects it at
  layers L-1..1 by beam search (``_connect_at_layer``), chaining the
  closest accepted neighbour down; ``base_connect`` connects every member
  at layer 0 by beam search from its chained entry (upper members) or from
  a greedy descent (the rest), then promotes the entry point.

Connecting is ``_apply_connections``: heuristic prune, forward-row write,
then ``_add_reverse`` appends the back edges and re-prunes rows that
overflow their storage width (PruneOverflow, GraphConnector.cs:209-262).
``normalize_base_rows`` re-prunes layer-0 rows past the 2M cap for the
reference-format export.  A registered metric builds on the beam path
only.

The host slices each wave (index.HNSWIndex._insert_batch), so a wave holds
exactly its members and carries no lane padding.  The tables are updated in
place.  Masked row writes select their rows with a boolean mask (which
synchronises with the device) instead of the reference's dropped writes to
slot C.  Not ported: the device-side wave cursor and grouping
(``wave_head``, ``upper_compact``, ``insert_wave_fused``,
``insert_wave_beam_fused``), which served relay latency and XLA compiles.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import distance as dst
from ..ops.bruteforce import exact_knn, exact_knn2
from . import heuristic
from .graph import GraphConfig, GraphState, nbr_slice, write_rows
from .search import beam_search, greedy_descent

_INF = float("inf")
_PRUNE_CHUNK = 1024

#: Scan-prefix size from which full-width waves run the two-stage scan
#: (exact_knn2, through the lane-min kernel) instead of exact_knn.  The
#: value is the reference's TPU compile gate, kept so that both packages
#: build the same graph; re-measuring it on the H100 is ROADMAP work.
BUILD_SCAN2_MIN = 1 << 19
#: Scan prefix from which every wave takes the two-stage scan.
SCAN2_ALWAYS = 1 << 21


def _phase(timer, name: str):
    return timer.phase(name) if timer is not None \
        else contextlib.nullcontext()


def _prune_rows(cfg: GraphConfig, vectors, norms, target_ids, cand_ids,
                mask, max_deg: int, fill_to: int = 0):
    """Heuristic-prune candidate lists against their target nodes, with
    candidate->target distances (PruneOverflow's orientation,
    GraphConnector.cs:233).  ``target_ids (P,)``, ``cand_ids (P, NC)``
    (-1 invalid), ``mask (P,)`` gates rows.  Chunked over rows to bound the
    (chunk, NC, D) gather.  ``fill_to`` tops under-connected rows up from
    their rejected candidates (removal repair only; heuristic.prune).
    Returns (sel (P, max_deg), count (P,))."""
    P, NC = cand_ids.shape
    C, D = vectors.shape
    row_bytes = NC * D * vectors.element_size()
    chunk = max(1, min(P, 8192,
                       max(_PRUNE_CHUNK, (128 << 20) // max(1, row_bytes))))
    sels, cnts = [], []
    for p0 in range(0, P, chunk):
        tc = target_ids[p0:p0 + chunk].long().clamp(0, C - 1)
        cic = cand_ids[p0:p0 + chunk].long()
        mkc = mask[p0:p0 + chunk]
        ccc = cic.clamp(0, C - 1)
        cvecs = vectors[ccc]
        cn = norms[ccc]
        cd = dst.gathered(cfg.metric, vectors[tc], norms[tc], cvecs, cn)
        cd = torch.where((cic >= 0) & mkc[:, None], cd, _INF)
        sel, cnt = heuristic.prune(cfg.metric,
                                   torch.where(mkc[:, None], cic, -1),
                                   cd, cvecs, cn, max_deg, fill_to=fill_to)
        sels.append(sel)
        cnts.append(cnt)
    return torch.cat(sels, dim=0), torch.cat(cnts, dim=0)


def _prune_rows_compact(cfg: GraphConfig, vlo, norms, target_ids, cand_ids,
                        mask, max_deg: int):
    """_prune_rows on the ``mask`` rows only, scattered back to full width;
    other rows return (-1 row, 0).  The overflow re-prune needs only the
    few rows that overflowed, so this runs the prune chain on those."""
    P = mask.shape[0]
    sel = torch.full((P, max_deg), -1, dtype=torch.int64,
                     device=mask.device)
    cnt = torch.zeros((P,), dtype=torch.int64, device=mask.device)
    take = torch.nonzero(mask).flatten()
    if take.numel():
        selc, cntc = _prune_rows(cfg, vlo, norms, target_ids[take],
                                 cand_ids[take], mask[take], max_deg)
        sel[take] = selc
        cnt[take] = cntc
    return sel, cnt


def normalize_base_rows(cfg: GraphConfig, vlo, norms, nbr0, deg0,
                        rows) -> None:
    """Re-prune ``rows`` (host ints) of the layer-0 table back to the 2M
    degree cap with the heuristic, in PruneOverflow's orientation, 4,096
    rows at a time.  Writes ``nbr0``/``deg0`` in place: callers that export
    a live graph pass copies.  The slack columns (``cfg.slack0``) let rows
    hold up to 2M + slack0 edges between re-prunes; exports in the
    reference's wire format (``to_reference_snapshot``) need rows at the
    cap."""
    K = nbr0.shape[1]
    max_deg = 2 * cfg.max_edges
    for i in range(0, len(rows), 4096):
        r = torch.as_tensor(rows[i:i + 4096], dtype=torch.int64,
                            device=nbr0.device)
        sel, cnt = _prune_rows(cfg, vlo, norms, r, nbr0[r],
                               torch.ones_like(r, dtype=torch.bool), max_deg)
        row = torch.full((r.shape[0], K), -1, dtype=nbr0.dtype,
                         device=nbr0.device)
        row[:, :max_deg] = sel.to(nbr0.dtype)
        nbr0[r] = row
        deg0[r] = cnt.to(deg0.dtype)


def _add_reverse(cfg: GraphConfig, vlo, norms, nbr_l, deg_l, src_ids, sel,
                 mask, max_deg: int):
    """Add back-edges v -> u for every forward edge u -> v of the wave,
    writing into ``nbr_l``/``deg_l`` in place.

    The (u, v) pairs are sorted by (target, distance) and ranked within each
    target; each target's new row (existing edges, then its arrivals
    nearest-first) is assembled and written with one row scatter.  Targets
    whose row would exceed the storage width K are re-pruned over existing
    edges plus their first A=8 arrivals (GraphConnector.cs:209-211,
    222-262)."""
    W, Ms = sel.shape
    P = W * Ms
    C, K = nbr_l.shape
    dev = nbr_l.device

    u = src_ids.long().repeat_interleave(Ms)
    v = sel.reshape(P).long()
    pv = (v >= 0) & mask.repeat_interleave(Ms)
    vcl = v.clamp(0, C - 1)
    # drop arrivals already in the target's row (mutual selections within
    # the wave were stored by the forward writes)
    already = torch.any(nbr_l[vcl] == u[:, None], dim=1)
    pv = pv & ~already
    ucl = u.clamp(0, C - 1)
    du = dst.gathered(cfg.metric, vlo[ucl], norms[ucl],
                      vlo[vcl][:, None, :], norms[vcl][:, None])[:, 0]
    key = torch.where(pv, v, C)                    # invalid -> sort to tail
    o1 = torch.argsort(torch.where(pv, du, _INF), stable=True)
    order = o1[torch.argsort(key[o1], stable=True)]
    sv = key[order]
    su = u[order]
    spv = pv[order]
    ar = torch.arange(P, device=dev)
    isstart = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         sv[1:] != sv[:-1]])
    svc = sv.clamp(0, C - 1)

    # group sizes: the next start's position bounds each group
    sp = torch.where(isstart, ar, P)
    nxt = torch.cat([torch.cummin(sp.flip(0), dim=0).values.flip(0)[1:],
                     torch.full((1,), P, dtype=sp.dtype, device=dev)])
    gcnt = torch.where(isstart, nxt - ar, 0)

    olddeg = torch.where(spv, deg_l[svc].long(), 0)
    total = olddeg + gcnt
    start_ok = spv & isstart
    # overflow fires on the storage width K (2M + slack0 at layer 0)
    over_row = start_ok & (total > K)

    colk = torch.arange(K, device=dev)[None, :]
    ex = nbr_l[svc].long()
    ex = torch.where(colk < olddeg[:, None], ex, -1)

    src = ar[:, None] + (colk - olddeg[:, None])   # arrival index per col
    arrv = su[src.clamp(0, P - 1)]
    is_arr = (colk >= olddeg[:, None]) & \
        (colk < torch.clamp(total, max=K)[:, None])
    newrow = torch.where(colk < olddeg[:, None], ex,
                         torch.where(is_arr, arrv, -1))

    A = min(8, Ms)
    ara = torch.arange(A, device=dev)
    win = torch.clamp(ar[:, None] + ara[None, :], max=P - 1)
    wu = su[win]
    w_ok = (ara[None, :] < torch.clamp(gcnt, max=A)[:, None]) \
        & over_row[:, None]
    cand = torch.cat([ex, torch.where(w_ok, wu, -1)], dim=1)   # (P, K+A)
    sel2, cnt2 = _prune_rows_compact(cfg, vlo, norms, sv, cand, over_row,
                                     max_deg)
    sel2pad = torch.full((P, K), -1, dtype=torch.int64, device=dev)
    sel2pad[:, :max_deg] = sel2

    final_row = torch.where(over_row[:, None], sel2pad, newrow)
    final_cnt = torch.where(over_row, cnt2, torch.clamp(total, max=K))
    rows = torch.nonzero(start_ok).flatten()
    tgt = sv[rows]
    nbr_l[tgt] = final_row[rows].to(nbr_l.dtype)
    deg_l[tgt] = final_cnt[rows].to(deg_l.dtype)


def _apply_connections(cfg: GraphConfig, state: GraphState, layer: int, ids,
                       cd, ci, conn, max_deg: int, timer=None):
    """Heuristic prune, forward-row write, back edges + overflow prune
    (GraphConnector.cs:190-214) for one layer, in place.  Returns sel."""
    W = ids.shape[0]
    C = state.capacity
    nbr_l, deg_l = nbr_slice(state, layer)
    K = nbr_l.shape[1]
    with _phase(timer, "prune"):
        cic = ci.clamp(0, C - 1)
        cvecs = state.vlo[cic]
        cnorms = state.norms[cic]
        sel, cnt = heuristic.prune(cfg.metric,
                                   torch.where(conn[:, None], ci, -1),
                                   cd, cvecs, cnorms, max_deg)
        selpad = torch.full((W, K), -1, dtype=torch.int64, device=ids.device)
        selpad[:, :max_deg] = sel
        rows = torch.nonzero(conn).flatten()
        nbr_l[ids[rows]] = selpad[rows].to(nbr_l.dtype)
        deg_l[ids[rows]] = cnt[rows].to(deg_l.dtype)
    with _phase(timer, "reverse"):
        _add_reverse(cfg, state.vlo, state.norms, nbr_l, deg_l, ids, sel,
                     conn, max_deg)
    return sel


def _connect_at_layer(cfg: GraphConfig, state: GraphState, layer: int, ids,
                      vecs, qn, entry, conn, max_deg: int, timer=None):
    """One layer of the beam-path insert (ConnectAtLayer,
    GraphConnector.cs:187-217): a beam of width efConstruction from
    ``entry``, then ``_apply_connections``.  Returns the next layer's
    entries: the closest accepted neighbour where one was accepted
    (GraphConnector.cs:216), else the old entry."""
    efc = cfg.ef_construction
    p = cfg.build_expand
    max_iters = (cfg.search_iter_factor * efc) // p + 16
    with _phase(timer, "beam"):
        cd, ci = beam_search(cfg, state, vecs, qn, entry, conn, layer, efc,
                             max_iters, expand=p)
    sel = _apply_connections(cfg, state, layer, ids, cd, ci, conn, max_deg,
                             timer)
    nxt = sel[:, 0]
    return torch.where(conn & (nxt >= 0), nxt, entry)


def _old_top(state: GraphState):
    """(has_graph, top level of the entry point or -1) as 0-d tensors."""
    C = state.capacity
    ep0 = state.ep.long()
    has_graph = ep0 >= 0
    old_top = torch.where(has_graph, state.level[ep0.clamp(0, C - 1)], -1)
    return has_graph, old_top


def scatter_wave(cfg: GraphConfig, state: GraphState, ids, vecs, lvls):
    """Phase 1: store a wave's vectors, levels and active bits
    (GraphData.AddItem's storage half, GraphData.cs:79-117)."""
    write_rows(state, cfg, ids.long(), vecs, lvls)


def upper_connect_exact(cfg: GraphConfig, state: GraphState, ids, lvls,
                        panel_ids, max_lvl: int = 0, timer=None):
    """Phase 2: connect the wave's level>=1 members (``ids``, ``lvls``) at
    layers ``max_lvl``..1 from exact candidates over the upper-node panel.

    ``panel_ids (Cu,)`` holds every node with level >= 1 (-1 padded).  One
    distance panel, ranked on the bf16 mirror when present, replaces the
    reference HNSW's greedy descent and beams; per layer the candidates are
    masked to panel rows with level >= layer, the nearest ef_construction
    are rescored in f32 and connected.  ``max_lvl`` (0 = all layers) may be
    the wave's top level: layers above it connect nobody."""
    C = state.capacity
    L = state.num_levels
    top = L - 1 if max_lvl <= 0 else min(L - 1, max_lvl)
    Cu = panel_ids.shape[0]
    ids = ids.long()
    lvls = lvls.long()
    has_graph, old_top = _old_top(state)
    conn_top = torch.minimum(lvls, old_top)

    pc = panel_ids.long().clamp(0, C - 1)
    pok = (panel_ids >= 0) & state.active[pc]
    plvl = torch.where(pok, state.level[pc], -1)

    store = state.coarse_table
    store = state.vlo if store is None else store
    qn = state.norms[ids]
    dots = store[ids].float() @ store[pc].float().T
    dall = dst.from_dot(cfg.metric, dots, qn[:, None], state.norms[pc][None])
    # self-exclusion: the wave's own members are already in the panel
    dall = torch.where(panel_ids[None, :].long() == ids[:, None], _INF, dall)

    qvf = state.vlo[ids]
    NC = min(cfg.ef_construction, Cu)
    for layer in range(top, 0, -1):
        conn = has_graph & (layer <= conn_top) & (lvls >= layer)
        d_l = torch.where((pok & (plvl >= layer))[None, :], dall, _INF)
        vals, idx = torch.topk(d_l, NC, dim=1, largest=False)
        ci = torch.where(torch.isfinite(vals), panel_ids.long()[idx], -1)
        # f32 rescore of the survivors: bf16 noise must not reach the
        # heuristic's accept test
        cic = ci.clamp(0, C - 1)
        cd = dst.gathered(cfg.metric, qvf, qn, state.vlo[cic],
                          state.norms[cic])
        cd = torch.where(ci >= 0, cd, _INF)
        _apply_connections(cfg, state, layer, ids, cd, ci, conn,
                           cfg.max_edges, timer)


def base_connect_exact(cfg: GraphConfig, state: GraphState, ids, lvls,
                       nscan: int, scan2: bool, prefix: int | None = None,
                       timer=None):
    """Phase 3: layer-0 connections from the exact efConstruction nearest
    neighbours of a corpus scan, entry-point promotion and count update.

    The scan path follows the reference's gate: two-stage (lane-min scan +
    f32 rescore, ops/bruteforce.exact_knn2) once ``nscan`` — the reference
    host's bucketed scan prefix — reaches SCAN2_ALWAYS, or for full-width
    waves (``scan2``) from BUILD_SCAN2_MIN up; exact_knn otherwise.  The
    scan itself covers only ``prefix`` rows (the high-water slot mark):
    rows past it are inactive and can never be candidates."""
    C = state.capacity
    ids = ids.long()
    lvls = lvls.long()
    vecs = state.vectors[ids]
    has_graph, old_top = _old_top(state)
    ns = min(nscan, C)
    pre = ns if prefix is None else min(prefix, C)
    ct = state.coarse_table
    with _phase(timer, "scan"):
        if ct is not None and (ns >= SCAN2_ALWAYS
                               or (scan2 and ns >= BUILD_SCAN2_MIN)):
            cd, ci = exact_knn2(cfg.metric, state.vectors, ct[:pre],
                                state.norms[:pre], state.active[:pre], vecs,
                                cfg.ef_construction, exclude=ids)
        else:
            cd, ci = exact_knn(cfg.metric, state.vlo[:pre],
                               state.norms[:pre], state.active[:pre], vecs,
                               cfg.ef_construction, exclude=ids)
    conn0 = has_graph.expand(ids.shape[0])
    _apply_connections(cfg, state, 0, ids, cd, ci, conn0,
                       2 * cfg.max_edges, timer)

    # entry-point promotion: the highest-level member (first on ties)
    # replaces the entry point if it tops the old hierarchy
    best_i = torch.argmax(lvls)
    new_ep = torch.where(lvls[best_i] > old_top, ids[best_i], state.ep.long())
    state.ep.copy_(new_ep)
    state.count += ids.shape[0]


def upper_connect(cfg: GraphConfig, state: GraphState, ids, lvls,
                  max_lvl: int = 0, timer=None):
    """Phase 2, beam path: connect the wave's level>=1 members (``ids``,
    ``lvls``) at layers L-1..1.  Each descends greedily from the entry
    point to its top connect layer min(level, old top)
    (GraphConnector.cs:172-181), then connects layer by layer, chaining
    each layer's closest accepted neighbour as the next entry.
    ``max_lvl`` (0 = all layers) may be the wave's top level: the layers
    above it connect nobody and leave the entries as they are.  Returns
    each member's entry for layer 0."""
    Wu = ids.shape[0]
    L = state.num_levels
    top = L - 1 if max_lvl <= 0 else min(L - 1, max_lvl)
    ids = ids.long()
    lvls = lvls.long()
    vecs = state.vectors[ids]
    vn = state.norms[ids]
    has_graph, old_top = _old_top(state)
    conn_top = torch.minimum(lvls, old_top)
    ep_b = torch.where(has_graph, state.ep.long(), -1).expand(Wu)
    with _phase(timer, "descent"):
        entry, _ = greedy_descent(cfg, state, vecs, vn, ep_b,
                                  old_top.expand(Wu), conn_top)
    for layer in range(top, 0, -1):
        conn = has_graph & (layer <= conn_top) & (lvls >= layer)
        entry = _connect_at_layer(cfg, state, layer, ids, vecs, vn, entry,
                                  conn, cfg.max_edges, timer)
    return entry


def base_connect(cfg: GraphConfig, state: GraphState, ids, lvls,
                 up_lanes=None, up_entry=None, timer=None):
    """Phase 3, beam path: layer-0 connections for the whole wave,
    entry-point promotion and count update.

    ``up_lanes`` (wave positions of the upper members) and ``up_entry``
    carry the entries ``upper_connect`` chained down; every other member
    descends greedily from the global entry point (FindEntryPoint,
    GraphNavigator.cs:27).  The descent reads this wave's upper edges, so
    it can land on a member that has no layer-0 edges yet: an entry of
    out-degree zero falls back to the pre-wave entry point."""
    W = ids.shape[0]
    C = state.capacity
    dev = ids.device
    ids = ids.long()
    lvls = lvls.long()
    hint = torch.full((W,), -1, dtype=torch.int64, device=dev)
    if up_lanes is not None:
        hint[up_lanes.long()] = up_entry.long()
    hint_ok = hint >= 0
    vecs = state.vectors[ids]
    vn = state.norms[ids]
    has_graph, old_top = _old_top(state)
    ep_b = torch.where(has_graph, state.ep.long(), -1).expand(W)
    start = torch.where(hint_ok, hint, ep_b)
    start_layer = torch.where(hint_ok, 0, old_top.expand(W))
    with _phase(timer, "descent"):
        entry, _ = greedy_descent(cfg, state, vecs, vn, start, start_layer,
                                  torch.zeros((W,), dtype=torch.int64,
                                              device=dev))
    entry_ok = state.deg0[entry.clamp(0, C - 1)] > 0
    entry = torch.where(entry_ok, entry, ep_b)
    _connect_at_layer(cfg, state, 0, ids, vecs, vn, entry,
                      has_graph.expand(W), 2 * cfg.max_edges, timer)

    best_i = torch.argmax(lvls)
    new_ep = torch.where(lvls[best_i] > old_top, ids[best_i], state.ep.long())
    state.ep.copy_(new_ep)
    state.count += W
