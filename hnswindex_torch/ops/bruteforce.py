"""Exact brute-force k-NN and range scans.

Counterpart of ``hnswindex_tpu/ops/bruteforce.py``:

* ``exact_knn`` — blocked float32 product + top-k per block, then an exact
  merge.  The reference selects per block with ``lax.approx_min_k``; here
  ``torch.topk`` is exact, so the port is never less exact.
* ``exact_knn2`` — two-stage: stage 1 keeps S survivors per query from the
  bf16 corpus mirror, ``_rescore_topk`` rescores them in float32.  Stage 1
  is the lane-min scan (ops/fused_scan, kernel K1) while S fits its 1,024
  lanes, and a chunked bf16-operand product with an exact top-S (the
  reference's panel branch) above that.
* ``range_distances`` / ``range_count`` — blocked float32 scans that give
  one query's in-radius distances and each query's in-radius count (the
  facade's exact range path and its pool sizing).
"""

from __future__ import annotations

import torch

from . import distance as dst

_BLOCK = 65536

#: Lane count of the lane-min scan; also the upper bound on its survivor
#: width.
FUSED_BS = 1024
#: Survivor width S = max(OVERSAMPLE * k, k + SURVIVOR_FLOOR): the wide
#: floor keeps small k deep inside the lane-collision miss zone, and the
#: f32 rescore restores exact order among survivors.
OVERSAMPLE = 4
SURVIVOR_FLOOR = 256


def _pad_cols(d: torch.Tensor, i: torch.Tensor, k: int):
    """Pad (B, n) results to k columns with inf / -1."""
    n = d.shape[1]
    if n >= k:
        return d, i
    B = d.shape[0]
    d = torch.cat([d, d.new_full((B, k - n), float("inf"))], dim=1)
    i = torch.cat([i, i.new_full((B, k - n), -1)], dim=1)
    return d, i


def exact_knn(metric: str, vectors: torch.Tensor, norms: torch.Tensor,
              active: torch.Tensor, q: torch.Tensor, k: int,
              block: int = _BLOCK, exclude=None):
    """Exact top-k over the active corpus.

    ``vectors (C, D)``, ``norms (C,)``, ``active (C,) bool``, ``q (B, D)``.
    Optional ``exclude (B,)`` masks one id per query.  Returns
    (dists (B, k) f32, ids (B, k) i64) ascending, -1/inf padded."""
    C = vectors.shape[0]
    B = q.shape[0]
    qn = dst.norm_data(metric, q)
    block = max(1, min(block, C))
    k2 = min(block, max(4 * k, k + 16))
    bds, bis = [], []
    for c0 in range(0, C, block):
        c1 = min(C, c0 + block)
        vblk = vectors[c0:c1]
        qq = q.to(vblk.dtype).float()
        dots = qq @ vblk.float().T
        d = dst.from_dot(metric, dots, qn[:, None], norms[None, c0:c1])
        d = torch.where(active[None, c0:c1], d, float("inf"))
        if exclude is not None:
            col = torch.arange(c0, c1, device=d.device)
            d = torch.where(col[None, :] == exclude[:, None].long(),
                            float("inf"), d)
        vals, idx = torch.topk(d, min(k2, c1 - c0), dim=1, largest=False)
        bds.append(vals)
        bis.append(idx + c0)
    bd = torch.cat(bds, dim=1)
    bi = torch.cat(bis, dim=1)
    order = torch.argsort(bd, dim=1, stable=True)[:, :k]
    bd = torch.gather(bd, 1, order)
    bi = torch.gather(bi, 1, order)
    bi = torch.where(torch.isfinite(bd), bi, -1)
    return _pad_cols(bd, bi, k)


def exact_knn2(metric: str, vectors: torch.Tensor, coarse: torch.Tensor,
               norms: torch.Tensor, active: torch.Tensor, q: torch.Tensor,
               k: int, exclude=None, lanes: int = FUSED_BS,
               oversample: int = OVERSAMPLE,
               survivor_floor: int = SURVIVOR_FLOOR):
    """Two-stage exact top-k: S survivors of the bf16 mirror + exact f32
    rescore, ``S = max(oversample * k, k + survivor_floor)`` (callers that
    consume only a prefix of the k results, as the removal's candidate
    scan does, narrow it).  ``coarse/norms/active`` may be a prefix of the
    store (the build scans the high-water prefix); survivor ids are global
    ids and the rescore gathers from the full ``vectors``.  Same contract
    as :func:`exact_knn`.

    ``lanes`` is the lane-min scan's lane count (a multiple of 64, at least
    ``FUSED_BS``).  A true neighbour is lost when a row of its lane ranks
    below it on the bf16 products, so more lanes lose fewer; the build
    keeps the reference's 1,024, the exact query takes more."""
    from .fused_scan import lane_min_scan, rank_transform

    Cs = coarse.shape[0]
    B = q.shape[0]
    S = min(Cs, max(oversample * k, k + survivor_floor))
    qn = dst.norm_data(metric, q)
    if S > FUSED_BS:
        si = _panel_survivors(metric, coarse, norms, active, q, qn, S,
                              exclude)
        return _rescore_topk(metric, vectors, norms, q, qn, si, k)
    mult, bias = rank_transform(metric, norms, active)
    exc = (exclude.to(torch.int32) if exclude is not None
           else torch.full((B,), -1, dtype=torch.int32, device=q.device))
    QC = 1024
    sis = []
    for b0 in range(0, B, QC):
        vals, ids = lane_min_scan(coarse, mult, bias,
                                  q[b0:b0 + QC].contiguous(),
                                  exc[b0:b0 + QC].contiguous(), BS=lanes)
        sv, sx = torch.topk(vals, S, dim=1, largest=False)
        sid = torch.gather(ids, 1, sx).long()
        sis.append(torch.where(sv < 1.0e37, sid, -1))
    si = torch.cat(sis, dim=0)
    return _rescore_topk(metric, vectors, norms, q, qn, si, k)


def _panel_survivors(metric: str, coarse, norms, active, q, qn, S: int,
                     exclude=None):
    """Stage 1 for survivor widths past the lane count (the reference's
    panel branch): query chunks against the whole prefix, bf16 operands
    with float32 sums, masked, exact top-S.  Chunks of
    ``max(16, 2^31 // (4 Cs))`` queries bound the (chunk, Cs) float32
    panel to ~2 GB.  Survivors whose coarse distance is infinite are
    masked rows and come back as -1."""
    Cs = coarse.shape[0]
    B = q.shape[0]
    QC = min(B, max(16, (1 << 31) // (4 * Cs)))
    cf = coarse.float()
    qlo = q.to(torch.bfloat16).float()
    col = torch.arange(Cs, device=q.device)
    sis = []
    for b0 in range(0, B, QC):
        dots = qlo[b0:b0 + QC] @ cf.T
        d = dst.from_dot(metric, dots, qn[b0:b0 + QC, None], norms[None, :])
        d = torch.where(active[None, :], d, float("inf"))
        if exclude is not None:
            d = torch.where(col[None, :] == exclude[b0:b0 + QC, None].long(),
                            float("inf"), d)
        vals, idx = torch.topk(d, S, dim=1, largest=False)
        sis.append(torch.where(torch.isfinite(vals), idx, -1))
    return torch.cat(sis, dim=0)


def _rescore_topk(metric: str, vectors, norms, q, qn, si, k: int):
    """Stage 2: gather the (B, S) survivor rows, rescore in f32 and take
    the exact top-k among them (-1 survivor slots stay masked)."""
    C = vectors.shape[0]
    B = si.shape[0]
    chunk = 2048
    sds = []
    for b0 in range(0, B, chunk):
        sic = si[b0:b0 + chunk]
        g = sic.clamp(0, C - 1)
        d = dst.gathered(metric, q[b0:b0 + chunk], qn[b0:b0 + chunk],
                         vectors[g], norms[g])
        sds.append(torch.where(sic >= 0, d, float("inf")))
    sd = torch.cat(sds, dim=0)
    order2 = torch.argsort(sd, dim=1, stable=True)[:, :k]
    fd = torch.gather(sd, 1, order2)
    fi = torch.gather(si, 1, order2)
    fi = torch.where(torch.isfinite(fd), fi, -1)
    return _pad_cols(fd, fi, k)


def range_distances(metric: str, vectors: torch.Tensor, norms: torch.Tensor,
                    active: torch.Tensor, q1: torch.Tensor, radius: float,
                    block: int = _BLOCK) -> torch.Tensor:
    """(C,) float32 distances of one query ``q1 (D,)`` to every active row
    within ``radius``, inf elsewhere (the exact range path for corpora too
    large to mirror on the host)."""
    C = vectors.shape[0]
    r = torch.tensor(radius, dtype=torch.float32, device=vectors.device)
    qn = dst.norm_data(metric, q1[None])[0]
    out = []
    for c0 in range(0, C, max(1, block)):
        c1 = min(C, c0 + block)
        dots = vectors[c0:c1].float() @ q1.float()
        d = dst.from_dot(metric, dots, qn, norms[c0:c1])
        out.append(torch.where(active[c0:c1] & (d <= r), d, float("inf")))
    return torch.cat(out)


def range_count(metric: str, vectors: torch.Tensor, norms: torch.Tensor,
                active: torch.Tensor, q: torch.Tensor, radius: float,
                block: int = _BLOCK) -> torch.Tensor:
    """(B,) int64 count of active rows within ``radius`` of each query,
    one blocked scan (sizes the range-search pool up front)."""
    C = vectors.shape[0]
    r = torch.tensor(radius, dtype=torch.float32, device=vectors.device)
    qn = dst.norm_data(metric, q)
    cnt = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
    for c0 in range(0, C, max(1, block)):
        c1 = min(C, c0 + block)
        vblk = vectors[c0:c1]
        dots = q.to(vblk.dtype).float() @ vblk.float().T
        d = dst.from_dot(metric, dots, qn[:, None], norms[None, c0:c1])
        cnt += ((d <= r) & active[None, c0:c1]).sum(dim=1)
    return cnt
