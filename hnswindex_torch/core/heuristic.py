"""Batched relative-neighbour pruning.

Counterpart of ``hnswindex_tpu/core/heuristic.py``: the reference's
``Heuristic.RelativeNeighborPruning`` (Heuristic.cs:11-46) per row,

* fewer valid candidates than ``max_edges`` -> keep all (Heuristic.cs:13-18);
* otherwise sort by distance to the target and accept candidate c iff no
  already-accepted s has d(s, c) < d(c, target), stopping at ``max_edges``
  accepts (Heuristic.cs:22-41).

The O(N^2) candidate distances are one batched product; the sequential
accept is one launch of kernel K3 (``ops/accept_scan``) on the card, and on
the CPU its plain twin ``_accept_capped``, a scan over the sorted candidate
columns.  The reference permutes its conflict tensor with one-hot bf16
products because TPU gathers are slow; here the candidates are gathered in
sorted order before the product, which gives the same products in sorted
positions.  A registered metric evaluates its callable on the sorted
candidates, a few columns at a time.
"""

from __future__ import annotations

import torch

from ..ops import distance as dst
from ..ops.accept_scan import accept_scan


def _accept_cols(by_col: torch.Tensor) -> torch.Tensor:
    """Exact sequential accept over sorted candidate columns:
    ``by_col[b, c, s]`` says earlier candidate s blocks c if s is
    accepted.  Column c is accepted iff no accepted s < c conflicts."""
    B, N, _ = by_col.shape
    acc = torch.zeros((B, N), dtype=torch.bool, device=by_col.device)
    for c in range(N):
        acc[:, c] = ~torch.any(by_col[:, c, :c] & acc[:, :c], dim=1)
    _accept_cols.steps += N
    return acc


#: column steps ``_accept_cols`` has taken, summed over its calls in this
#: process: each step is a handful of small launches (the CPU path's; a
#: prune on the card takes kernel K3 and no step)
_accept_cols.steps = 0


def _accept_capped(pd: torch.Tensor, sd: torch.Tensor, svalid: torch.Tensor,
                   max_edges: int) -> torch.Tensor:
    """Accepted sorted columns ``(B, N)`` bool, at most ``max_edges`` a row,
    from the pairwise distances ``pd[b, c, s] = d(s, c)`` and the distances
    ``sd`` to the target: the plain twin of kernel K3 (``ops/accept_scan``),
    which the CPU path runs."""
    keep_all = svalid.sum(dim=1) < max_edges
    # by_col[b, c, s]: earlier candidate s conflicts with c, i.e.
    # d(s, c) < d(c, target).  _accept_cols reads only s < c, and an
    # invalid column c is dropped by the mask below, so only invalid
    # earlier candidates s need masking
    by_col = (pd < sd[:, :, None]) & svalid[:, None, :]
    accepted = _accept_cols(by_col) & svalid
    accepted = torch.where(keep_all[:, None], svalid, accepted)
    return accepted & (torch.cumsum(accepted, dim=1) <= max_edges)


#: Bytes of the (B, cols, N, D) broadcast a registered metric's pairwise
#: table is evaluated in: a few candidate columns at a time, never the
#: whole (B, N, N, D).
CUSTOM_CHUNK_BYTES = 256 << 20


def _custom_by_col(fn, cv: torch.Tensor) -> torch.Tensor:
    """(B, N, N) float32 table ``t[b, c, s] = fn(cv[b, s], cv[b, c])`` of a
    registered metric over sorted candidates ``cv (B, N, D)``, evaluated
    a group of columns c at a time (the reference maps one column at a
    time; the values are the same elementwise evaluations)."""
    B, N, D = cv.shape
    step = max(1, CUSTOM_CHUNK_BYTES // max(1, B * N * D * 4))
    out = torch.empty((B, N, N), dtype=torch.float32, device=cv.device)
    for c0 in range(0, N, step):
        c1 = min(N, c0 + step)
        out[:, c0:c1] = fn(cv[:, None, :, :], cv[:, c0:c1, None, :]).float()
    return out


def prune(metric: str,
          cand_ids: torch.Tensor,     # (B, N) int, -1 = invalid
          cand_d: torch.Tensor,       # (B, N) f32 distance to target
          cand_vecs: torch.Tensor,    # (B, N, D) gathered candidate vectors
          cand_norms: torch.Tensor,   # (B, N) gathered norm data
          max_edges: int,
          force_mask: torch.Tensor | None = None,
          fill_to: int = 0):
    """Select up to ``max_edges`` diverse neighbours per row.

    Returns ``(sel_ids (B, max_edges) i64 padded -1, sel_count (B,) i64)``;
    selected ids come in ascending-distance order.  ``force_mask (B,)``
    disables masked-out rows.  ``fill_to`` tops rows whose accept set came
    out smaller than this up with their nearest rejected candidates (the
    removal repair uses it; construction leaves it 0)."""
    B, N = cand_ids.shape
    dev = cand_ids.device
    cand_ids = cand_ids.long()
    valid = cand_ids >= 0
    if force_mask is not None:
        valid = valid & force_mask[:, None]

    d = torch.where(valid, cand_d, float("inf"))
    order = torch.argsort(d, dim=1, stable=True)
    sid = torch.gather(cand_ids, 1, order)
    svalid = torch.gather(valid, 1, order)
    sd = torch.gather(d, 1, order)

    if dst.is_custom(metric):
        cv = torch.gather(cand_vecs, 1,
                          order[:, :, None].expand(B, N, cand_vecs.shape[2]))
        pd = _custom_by_col(dst._CUSTOM_METRICS[metric], cv)
    else:
        # pairwise distances among the candidates, taken in sorted order:
        # each product is the same dot of the same two rows as in the
        # unsorted order, and the table is symmetric, so d(s, c) = pd[c, s]
        cv = torch.gather(cand_vecs.float(), 1,
                          order[:, :, None].expand(B, N, cand_vecs.shape[2]))
        sn = torch.gather(cand_norms, 1, order)
        dots = torch.bmm(cv, cv.transpose(1, 2))
        pd = dst.from_dot(metric, dots, sn[:, :, None], sn[:, None, :])
    if pd.is_cuda:
        accepted = accept_scan(pd, sd, svalid, max_edges)
    else:
        accepted = _accept_capped(pd, sd, svalid, max_edges)
    count = accepted.sum(dim=1)

    pos = torch.cumsum(accepted, dim=1) - 1
    pos = torch.where(accepted, pos, max_edges)       # dropped -> spare col
    out = torch.full((B, max_edges + 1), -1, dtype=torch.int64, device=dev)
    out.scatter_(1, pos, torch.where(accepted, sid, -1))
    if fill_to:
        rej = svalid & ~accepted
        rrank = torch.cumsum(rej, dim=1) - 1
        take = rej & (rrank < (fill_to - count)[:, None])
        fpos = torch.where(take, count[:, None] + rrank, max_edges)
        out.scatter_(1, fpos, torch.where(take, sid, -1))
        count = count + take.sum(dim=1)
    return out[:, :max_edges], count
