"""Streaming corpus scan with a running top-1 per lane (kernel K1).

Counterpart of ``hnswindex_tpu/ops/fused_scan.py``.  Stage 1 of the
two-stage exact scan (ops/bruteforce.exact_knn2): instead of writing a
(B, C) coarse distance panel, the corpus is streamed once and each query
keeps the minimum rank key per *lane residue class* — column j competes
only within lane ``j % BS``.  The true top-t of a query all survive unless
two of them collide in one lane, and callers oversample and rescore in f32.

Ranking is metric-agnostic: ``rank_transform`` gives per-row
``mult``/``bias`` so that ``key = dot * mult + bias`` orders rows by
distance, with inactive rows folded to +3e38:

* sq_euclid: mult = -2,       bias = ||c||^2   (key = d - ||q||^2)
* cosine:    mult = -1/||c||, bias = 0         (zero-norm rows: mult = 0,
  key = 0 = d - 1, the reference's zero-norm guard)
* ucosine:   mult = -1,       bias = 0         (key = d - 1)

``lane_min_scan`` launches the CUDA kernel in ``csrc/fused_scan.cu`` for a
CUDA tensor and runs the plain ``lane_min_scan_ref`` for a CPU tensor.  The
kernel multiplies on the tensor cores; to fill the card it cuts the corpus
walk into contiguous splits of whole lane groups (``_split_count``), each
split writes a partial result, and a second small kernel merges them in
split order.  ``merge_lane_min_partials`` is that merge's plain version.
"""

from __future__ import annotations

import torch

BIG = 3.0e38
#: keys at or above this mark a lane that saw no live column
DEAD = 1.0e37
#: rows of the plain version's key panel per chunk (bounds its memory)
_REF_CHUNK = 1 << 17
#: output tile of one thread block of the kernel (TQ and TL in the source)
_TILE_Q, _TILE_L = 128, 128
#: fewest lane groups worth a split of their own
_MIN_GROUPS_PER_SPLIT = 4


def rank_transform(metric: str, norms: torch.Tensor, active: torch.Tensor):
    """Per-row (mult, bias) so that ``dot * mult + bias`` orders rows by
    distance for one query (see module docstring)."""
    if metric == "sq_euclid":
        mult = torch.full_like(norms, -2.0)
        bias = norms
    elif metric == "cosine":
        mult = torch.where(norms > 0.0, -1.0 / torch.clamp(norms, min=1e-30),
                           torch.zeros_like(norms))
        bias = torch.zeros_like(norms)
    elif metric == "ucosine":
        mult = torch.full_like(norms, -1.0)
        bias = torch.zeros_like(norms)
    else:
        raise ValueError(f"lane_min_scan requires a dot-decomposable "
                         f"metric, got {metric!r}")
    mult = torch.where(active, mult, torch.zeros_like(mult)).float()
    bias = torch.where(active, bias, torch.full_like(bias, BIG)).float()
    return mult.contiguous(), bias.contiguous()


def lane_min_scan_ref(coarse: torch.Tensor, mult: torch.Tensor,
                      bias: torch.Tensor, q: torch.Tensor,
                      exclude: torch.Tensor, BS: int = 1024):
    """Plain PyTorch version of K1: same contract as :func:`lane_min_scan`.

    Works through the corpus in chunks of whole lane groups; a later chunk
    replaces a lane's minimum only when strictly smaller, and ``argmin``
    returns the first minimum inside a chunk, so the lowest column wins a
    tie exactly as in the kernel."""
    C, D = coarse.shape
    B = q.shape[0]
    dev = coarse.device
    qf = q.to(coarse.dtype).float()
    excl = exclude.long()
    vals = torch.full((B, BS), BIG, dtype=torch.float32, device=dev)
    ids = torch.full((B, BS), -1, dtype=torch.int64, device=dev)
    lane = torch.arange(BS, device=dev)
    step = max(BS, (_REF_CHUNK // BS) * BS)
    for c0 in range(0, C, step):
        c1 = min(C, c0 + step)
        keys = (qf @ coarse[c0:c1].float().T) * mult[None, c0:c1] \
            + bias[None, c0:c1]
        col = torch.arange(c0, c1, device=dev)
        keys = torch.where(col[None, :] == excl[:, None], BIG, keys)
        n = c1 - c0
        G = -(-n // BS)
        if G * BS != n:
            keys = torch.nn.functional.pad(keys, (0, G * BS - n), value=BIG)
        keys = keys.reshape(B, G, BS)
        arg = torch.argmin(keys, dim=1)                      # (B, BS)
        kmin = torch.gather(keys, 1, arg[:, None, :])[:, 0, :]
        better = kmin < vals
        vals = torch.where(better, kmin, vals)
        ids = torch.where(better, c0 + arg * BS + lane[None, :], ids)
    ids = torch.where(vals < DEAD, ids, -1)
    return vals, ids.to(torch.int32)


def merge_lane_min_partials(pvals: torch.Tensor, pids: torch.Tensor):
    """Plain version of the kernel's merge pass: ``pvals/pids (S, B, BS)``
    are the results of scanning S contiguous corpus splits, in corpus
    order, with global column ids.  A later split replaces a lane only when
    strictly smaller, so the lowest column keeps an exact tie."""
    vals, ids = pvals[0], pids[0]
    for s in range(1, pvals.shape[0]):
        better = pvals[s] < vals
        vals = torch.where(better, pvals[s], vals)
        ids = torch.where(better, pids[s], ids)
    return vals, ids


def _split_count(B: int, BS: int, C: int, n_sm: int) -> int:
    """Splits of the corpus walk for one launch: as many as give every SM a
    block, but none shorter than ``_MIN_GROUPS_PER_SPLIT`` lane groups, so
    a short prefix launches no empty block and no useless merge."""
    tiles = -(-B // _TILE_Q) * -(-BS // _TILE_L)
    groups = -(-C // BS)
    return max(1, min(n_sm // max(1, tiles),
                      groups // _MIN_GROUPS_PER_SPLIT))


def _launch(coarse, mult, bias, q, exclude, BS: int):
    from . import _cuda

    C, D = coarse.shape
    B = q.shape[0]
    if coarse.dtype != torch.bfloat16:
        raise TypeError("the CUDA lane-min scan takes a bfloat16 corpus")
    if BS % 64 != 0:
        raise ValueError(f"BS must be a multiple of 64, got {BS}")
    if q.shape[1] != D or mult.shape != (C,) or bias.shape != (C,) \
            or exclude.shape != (B,):
        raise ValueError("lane_min_scan: inconsistent shapes")
    for name, t in (("coarse", coarse), ("mult", mult), ("bias", bias),
                    ("q", q), ("exclude", exclude)):
        if t.device != coarse.device:
            raise ValueError(f"lane_min_scan: {name} is on {t.device}, "
                             f"corpus on {coarse.device}")
        if not t.is_contiguous():
            raise ValueError(f"lane_min_scan: {name} must be contiguous")
    if mult.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("lane_min_scan: mult and bias must be float32")
    if exclude.dtype != torch.int32:
        raise TypeError("lane_min_scan: exclude must be int32")
    fn = _cuda.library("fused_scan").hnsw_lane_min_scan
    dev = coarse.device
    S = _split_count(
        B, BS, C, torch.cuda.get_device_properties(dev).multi_processor_count)
    # the C entry point launches on the runtime's current device
    with torch.cuda.device(dev):
        qb = q.to(torch.bfloat16).contiguous()
        # each split's partial result; with one split it is the result,
        # else the second kernel merges them
        pvals = torch.empty((S, B, BS), dtype=torch.float32, device=dev)
        pids = torch.empty((S, B, BS), dtype=torch.int32, device=dev)
        if S == 1:
            vals, ids = pvals[0], pids[0]
        else:
            vals = torch.empty((B, BS), dtype=torch.float32, device=dev)
            ids = torch.empty((B, BS), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(coarse.data_ptr(), mult.data_ptr(), bias.data_ptr(),
                 qb.data_ptr(), exclude.data_ptr(), vals.data_ptr(),
                 ids.data_ptr(), pvals.data_ptr(), pids.data_ptr(), C, D, B,
                 BS, S, stream)
    if err < 0:
        raise RuntimeError(
            "lane_min_scan: no TMA tensor map for the corpus ("
            + ("libcuda has no cuTensorMapEncodeTiled" if err == -1
               else "cuTensorMapEncodeTiled refused the matrix") + ")")
    _cuda.check(err, "lane_min_scan")
    lane_min_scan.launches += 1
    return vals, ids


def lane_min_scan(coarse: torch.Tensor, mult: torch.Tensor,
                  bias: torch.Tensor, q: torch.Tensor,
                  exclude: torch.Tensor, BS: int = 1024):
    """Running per-lane min of ``key = q.coarse_row * mult + bias``.

    ``coarse (C, D)``, ``mult/bias (C,) f32``, ``q (B, D)``, ``exclude (B,)
    i32`` (-1 = none).  Returns ``(vals (B, BS) f32, ids (B, BS) i32)``:
    lane s holds the min key among columns with ``col % BS == s`` (ids -1 /
    vals >= 1e37 if the lane never saw a live column).  C needs no
    alignment.  A CUDA corpus launches the kernel (and counts one launch
    per call in ``lane_min_scan.launches``, merge pass included); a CPU
    corpus runs the plain version."""
    if coarse.is_cuda:
        return _launch(coarse, mult, bias, q, exclude, BS)
    if coarse.device.type != "cpu":
        raise ValueError(f"lane_min_scan: no kernel for {coarse.device}")
    return lane_min_scan_ref(coarse, mult, bias, q, exclude, BS)


lane_min_scan.launches = 0
