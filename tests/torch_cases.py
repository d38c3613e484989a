"""Inputs and oracles shared by the port's CPU tests and its card tests.

The module imports no jax, so ``tests/test_torch_kernels_cuda.py`` can
import it where jax is not installed.  pytest collects no test here.
"""

import numpy as np
import torch

from hnswindex_torch.core import construct as TC
from hnswindex_torch.ops import distance as dst


def clustered(n, dim, n_centers, rng, spread=0.05):
    """``n`` float32 rows of width ``dim`` around ``n_centers`` uniform
    centres, Gaussian noise of ``spread``."""
    centers = rng.random((n_centers, dim)).astype(np.float32)
    who = rng.integers(0, n_centers, n)
    return (centers[who]
            + spread * rng.standard_normal((n, dim)).astype(np.float32))


def accept_inputs(seed, B, N, chunk=128):
    """Sorted candidates of B random targets in 3-d (many conflicts), as the
    heuristic's accept takes them: ``pd (B, N, N)`` float32 with ``pd[b, c,
    s] = d(s, c)``, ``sd (B, N)`` float32 ascending, ``valid (B, N)`` bool.
    They hold exact ties pd == sd, NaN pairwise distances and invalid
    columns in the middle; with B >= 3 also an all-invalid row (0), a row of
    three valid columns (1, keep all) and a row with no conflicts (2, it
    reaches the cap first).  Rows are drawn ``chunk`` at a time, so large B
    stays within a few hundred MB of temporaries."""
    rng = np.random.default_rng(seed)
    pd = np.empty((B, N, N), np.float32)
    sd = np.empty((B, N), np.float32)
    valid = np.empty((B, N), bool)
    for lo in range(0, B, chunk):
        b = min(chunk, B - lo)
        pts = rng.random((b, N, 3)).astype(np.float32)
        tgt = rng.random((b, 1, 3)).astype(np.float32)
        d = ((pts - tgt) ** 2).sum(-1)
        order = np.argsort(d, axis=1, kind="stable")
        d = np.take_along_axis(d, order, 1)
        pts = np.take_along_axis(pts, order[:, :, None], 1)
        p = sum((pts[:, :, None, k] - pts[:, None, :, k]) ** 2
                for k in range(3))
        u = rng.random((b, N, N), dtype=np.float32)
        p = np.where(u < 0.05, d[:, :, None], p)
        p[(u >= 0.05) & (u < 0.07)] = np.nan
        pd[lo:lo + b], sd[lo:lo + b] = p, d
        valid[lo:lo + b] = rng.random((b, N)) < 0.85
    if B >= 3:
        valid[0] = False
        valid[1, 3:] = False
        pd[2] = np.inf
    return pd, sd, valid


def upper_connect_per_layer(cfg, state, ids, lvls, panel_ids, max_lvl=0,
                            timer=None):
    """``construct.upper_connect_exact`` one layer at a time, top first:
    per layer the masked top-k over the panel, the f32 rescore and
    ``_apply_connections`` on that layer's own table.  The oracle of the
    stacked one-pass connect, which must build the same tables bit for
    bit.  Records no tally."""
    C = state.capacity
    L = state.num_levels
    top = L - 1 if max_lvl <= 0 else min(L - 1, max_lvl)
    Cu = panel_ids.shape[0]
    ids = ids.long()
    lvls = lvls.long()
    has_graph, old_top = TC._old_top(state)
    conn_top = torch.minimum(lvls, old_top)
    pc = panel_ids.long().clamp(0, C - 1)
    pok = (panel_ids >= 0) & state.active[pc]
    plvl = torch.where(pok, state.level[pc], -1)
    store = state.coarse_table
    store = state.vlo if store is None else store
    qn = state.norms[ids]
    dots = store[ids].float() @ store[pc].float().T
    dall = dst.from_dot(cfg.metric, dots, qn[:, None], state.norms[pc][None])
    dall = torch.where(panel_ids[None, :].long() == ids[:, None],
                       float("inf"), dall)
    qvf = state.vlo[ids]
    NC = min(cfg.ef_construction, Cu)
    for layer in range(top, 0, -1):
        conn = has_graph & (layer <= conn_top) & (lvls >= layer)
        d_l = torch.where((pok & (plvl >= layer))[None, :], dall,
                          float("inf"))
        vals, idx = torch.topk(d_l, NC, dim=1, largest=False)
        ci = torch.where(torch.isfinite(vals), panel_ids.long()[idx], -1)
        cic = ci.clamp(0, C - 1)
        cd = dst.gathered(cfg.metric, qvf, qn, state.vlo[cic],
                          state.norms[cic])
        cd = torch.where(ci >= 0, cd, float("inf"))
        TC._apply_connections(cfg, state, layer, ids, cd, ci, conn,
                              cfg.max_edges)


def upper_overflows(monkeypatch, max_edges):
    """A list that collects, per overflow re-prune of an upper-layer row
    set (the re-prunes at width ``max_edges``; layer 0's run at twice it),
    the number of rows re-pruned, while ``monkeypatch`` holds."""
    seen = []
    real = TC._prune_rows_compact

    def spy(cfg, vlo, norms, target_ids, cand_ids, mask, max_deg):
        if max_deg == max_edges:
            seen.append(int(mask.sum()))
        return real(cfg, vlo, norms, target_ids, cand_ids, mask, max_deg)

    monkeypatch.setattr(TC, "_prune_rows_compact", spy)
    return seen
