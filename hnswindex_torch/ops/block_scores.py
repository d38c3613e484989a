"""Probed-block scoring: the block index's hot op (kernel K2).

Counterpart of ``hnswindex_tpu/ops/pallas_block.py``.  The corpus is laid
out as contiguous blocks ``blk_vecs (NB, BS, D)``; a query is routed to P
blocks and every row of those blocks is scored exactly.  The result is the
``(B, P*BS)`` float32 distance panel (column ``p*BS + r`` is row r of the
query's p-th probed block); the caller masks padding and takes the top-k.

* Tiles are float32 or bfloat16.  ``q`` is cast to the tile dtype, every
  product is widened to float32 and accumulated in float32, and both norms
  are taken in float32 from the stored values.
* ``bids < 0`` (a routing pad) is clamped to block 0 and scored like any
  other block; callers mask those columns.
* cosine keeps the zero-norm guard: a zero row or a zero query scores
  exactly 1 (padding rows of a partly filled block are zeros).

``block_scores`` launches the CUDA kernel in ``csrc/block_scores.cu`` for
CUDA tensors and runs the plain ``block_scores_ref`` for CPU tensors.  The
kernel groups the (query, probe) pairs by block on the device and reads
each probed tile once for every query that probes it; the small functions
below size its shared memory and its grid.

Every launch is counted in ``block_scores.launches``.  A caller that passes
a ``utils.profiling.PhaseTimer`` gets the launch's work in its tallies:
``block_scores.pairs`` (B*P, known on the host) and ``block_scores.tiles``
(the distinct tiles the launch probed, summed on the device from the
kernel's segment offsets, with no host synchronisation).
"""

from __future__ import annotations

import torch

from . import distance as dst

_METRIC_CODE = {"sq_euclid": 0, "cosine": 1, "ucosine": 2}
#: float32 elements of gathered tiles the plain version holds at once
_REF_ELEMS = 1 << 27
#: most (query, probe) pairs one work item of the kernel scores
QT = 16
#: bytes of shared memory for a staged tile (one chunk, or two that
#: alternate); with it two or more scoring blocks reside on an SM (three
#: at the block path's 64 KB float32 tiles)
_TILE_BUDGET = 96 * 1024
#: bytes of shared memory for a work item's float32 query rows
_QUERY_BUDGET = 32 * 1024
#: shared memory one block of the card may opt in to (H100)
_SMEM_LIMIT = 232_448


def _check(metric: str, blk_vecs: torch.Tensor, bids: torch.Tensor,
           q: torch.Tensor) -> None:
    if metric not in _METRIC_CODE:
        raise ValueError(f"block_scores requires a dot-decomposable metric, "
                         f"got {metric!r}")
    if blk_vecs.dim() != 3 or bids.dim() != 2 or q.dim() != 2:
        raise ValueError("block_scores: expected blk_vecs (NB, BS, D), "
                         "bids (B, P) and q (B, D)")
    NB, BS, D = blk_vecs.shape
    if NB < 1 or BS < 1 or D < 1:
        raise ValueError("block_scores: empty block table")
    if q.shape != (bids.shape[0], D):
        raise ValueError(f"block_scores: q is {tuple(q.shape)}, expected "
                         f"({bids.shape[0]}, {D})")
    if blk_vecs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("block_scores: tiles must be float32 or bfloat16, "
                        f"got {blk_vecs.dtype}")
    if bids.dtype != torch.int32:
        raise TypeError("block_scores: bids must be int32")
    if not q.dtype.is_floating_point:
        raise TypeError("block_scores: q must be a floating-point tensor")
    for name, t in (("blk_vecs", blk_vecs), ("bids", bids), ("q", q)):
        if t.device != blk_vecs.device:
            raise ValueError(f"block_scores: {name} is on {t.device}, tiles "
                             f"on {blk_vecs.device}")
        if not t.is_contiguous():
            raise ValueError(f"block_scores: {name} must be contiguous")


def block_scores_ref(metric: str, blk_vecs: torch.Tensor, bids: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: same contract as :func:`block_scores`.

    Gathers the probed tiles a few probes at a time (at most ``_REF_ELEMS``
    float32 elements live), takes the dots with one ``einsum`` and applies
    the metric with ``distance.from_dot``."""
    _check(metric, blk_vecs, bids, q)
    NB, BS, D = blk_vecs.shape
    B, P = bids.shape
    qc = q.to(blk_vecs.dtype).float()
    qn = dst.norm_data(metric, qc)[:, None, None]
    idc = bids.long().clamp(0, NB - 1)
    out = torch.empty((B, P, BS), dtype=torch.float32, device=q.device)
    pg = max(1, _REF_ELEMS // max(1, B * BS * D))
    for p0 in range(0, P, pg):
        tiles = blk_vecs[idc[:, p0:p0 + pg]].float()        # (B, pg, BS, D)
        dots = torch.einsum("bpsd,bd->bps", tiles, qc)
        out[:, p0:p0 + pg] = dst.from_dot(metric, dots, qn,
                                          dst.norm_data(metric, tiles))
    return out.reshape(B, P * BS)


def _rows_per_chunk(BS: int, D: int, elem: int) -> int:
    """Tile rows the kernel stages at once: the whole tile when it fits
    ``_TILE_BUDGET``, else as many rows as two alternating buffers can hold
    in it (at least one)."""
    row = D * elem
    if BS * row <= _TILE_BUDGET:
        return BS
    return max(1, min(BS, _TILE_BUDGET // (2 * row)))


def _queries_per_item(D: int) -> int:
    """Pairs a work item holds: ``QT``, fewer when their float32 query
    rows would pass ``_QUERY_BUDGET`` (at least one)."""
    return max(1, min(QT, _QUERY_BUDGET // (4 * (-(-D // 4) * 4))))


def _max_work_items(NB: int, B: int, P: int, qt: int) -> int:
    """Upper bound on the kernel's work items (one per ``qt`` pairs of a
    block's segment): each of at most ``min(NB, B*P)`` probed blocks has at
    most one item that its pairs do not fill, so the grid is launched at
    this size without reading the real count back."""
    n = B * P
    return min(NB, n) + -(-n // qt)


def _smem_bytes(BS: int, D: int, elem: int, rb: int, qt: int) -> int:
    """Shared memory of one scoring block (``layout`` in the .cu): the tile
    buffers (one, or two when the tile is chunked), two mbarriers, the
    float32 query rows, their norms and pair ids, and the chunk's row
    norms."""
    buf = -(-rb * D * elem // 16) * 16
    return ((1 if rb >= BS else 2) * buf + 16 + 4 * qt * (-(-D // 4) * 4 + 2)
            + 4 * rb)


def _launch(metric, blk_vecs, bids, q, timer):
    from . import _cuda

    NB, BS, D = blk_vecs.shape
    B, P = bids.shape
    elem = blk_vecs.element_size()
    rb, qt = _rows_per_chunk(BS, D, elem), _queries_per_item(D)
    max_items = _max_work_items(NB, B, P, qt)
    if B * P >= 1 << 31 or max_items >= 1 << 31:
        raise ValueError("block_scores: B * P must stay below 2^31")
    if _smem_bytes(BS, D, elem, rb, qt) > _SMEM_LIMIT:
        raise ValueError(f"block_scores: D={D} needs more shared memory than "
                         f"a block of the card has")
    fn = _cuda.library("block_scores").hnsw_block_scores
    dev = blk_vecs.device
    # the C entry point launches on the runtime's current device
    with torch.cuda.device(dev):
        qc = q.to(blk_vecs.dtype).contiguous()
        out = torch.empty((B, P * BS), dtype=torch.float32, device=dev)
        counts = torch.zeros(NB + 1, dtype=torch.int32, device=dev)
        offsets = torch.empty(NB + 1, dtype=torch.int32, device=dev)
        order = torch.empty(B * P, dtype=torch.int32, device=dev)
        items = torch.empty((max_items, 3), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(blk_vecs.data_ptr(), bids.data_ptr(), qc.data_ptr(),
                 out.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
                 order.data_ptr(), items.data_ptr(), NB, BS, D, B, P, rb, qt,
                 max_items, _METRIC_CODE[metric],
                 int(blk_vecs.dtype == torch.bfloat16), stream)
    _cuda.check(err, "block_scores")
    block_scores.launches += 1
    if timer is not None:
        timer.count("block_scores.pairs", B * P)
        # a block's segment of the sorted pairs is empty unless it was probed
        timer.count("block_scores.tiles",
                    torch.count_nonzero(torch.diff(offsets)))
    return out


def block_scores(metric: str, blk_vecs: torch.Tensor, bids: torch.Tensor,
                 q: torch.Tensor, timer=None) -> torch.Tensor:
    """Distance panel ``(B, P*BS)`` of each query against its probed blocks.

    ``blk_vecs (NB, BS, D)`` f32 or bf16, ``bids (B, P)`` i32 (-1 pads are
    clamped to block 0; callers mask them), ``q (B, D)``.  CUDA tensors
    launch the kernel (and count the launch in ``block_scores.launches``;
    with ``timer`` its pairs and distinct tiles in the timer's tallies);
    CPU tensors run the plain version."""
    _check(metric, blk_vecs, bids, q)
    if blk_vecs.is_cuda:
        return _launch(metric, blk_vecs, bids, q, timer)
    if blk_vecs.device.type != "cpu":
        raise ValueError(f"block_scores: no kernel for {blk_vecs.device}")
    return block_scores_ref(metric, blk_vecs, bids, q)


block_scores.launches = 0
