"""Pool helpers of the batched graph search.

Counterpart of the two helpers of ``hnswindex_tpu/core/search.py`` that the
packed query engine (core/pack.py) needs.  ``greedy_descent``,
``beam_search``, ``knn_search`` and ``range_search`` — the unpacked engine —
are not ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import torch


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
