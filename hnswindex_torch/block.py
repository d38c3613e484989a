"""BlockIndex — the two-level block-serving index.

Counterpart of ``hnswindex_tpu/block.py``, with the same names.  A graph
beam chases pointers: every expansion is a scattered row fetch.  For
large-corpus serving the unit of traversal becomes a *block* of vectors
laid out contiguously:

* the corpus is clustered (balanced mini k-means) into blocks of
  ``block_size`` rows stored contiguously as a ``(NB, BS, D)`` table;
* a query is *routed* to its ``n_probe`` closest blocks by centroid
  distance (one small matmul and an exact top-k; centroids number ~N/100);
* the probed blocks are scored *exactly*: fetching a block is one
  contiguous read instead of BS scattered row reads.  float32 and bfloat16
  tiles are scored by kernel K2 (``ops/block_scores.py``) on a CUDA device
  and by its plain version on the CPU.

Recall is controlled by ``n_probe`` the way efSearch controls the graph
beam.  The index is dynamic: ``add``/``remove``/``update`` mutate blocks in
place and ``rebuild`` re-lays the live members out.

``DeviceBlockTables`` is the query-only form the ``HNSWIndex`` facade
builds straight from its device-resident ranking table when the query pack
does not fit its budget (bfloat16 tiles, or per-block-scaled int8 tiles
when memory is short).

``router="hnsw"`` routes through an ``HNSWIndex`` over the centroids (slot
id = block number; empty blocks removed), rebuilt before the next query
whenever a mutation touched the centroids.
"""

from __future__ import annotations

import json
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .core.snapshot import npz_path
from .ops import distance as dst
from .ops.block_scores import block_scores
from .params import HNSWParameters

_ASSIGN_CHUNK = 8192
#: queries scored per launch by ``BlockIndex.knn_query`` (bounds the panel)
QUERY_BATCH = 1024


def _kmeans_device(vecs: torch.Tensor, cents0: torch.Tensor, iters: int,
                   chunk: int):
    """Mini k-means on the device: chunked Lloyd assignments (bounded
    (chunk, NC) score transients) and ``index_add_`` centroid updates,
    accumulated in float32 whatever the corpus dtype.  Returns
    ``(labels (N,) int64, cents (NC, D) f32)``; the labels are the last
    iteration's assignment, taken before its centroid update."""
    N, D = vecs.shape
    NC = cents0.shape[0]
    dev = vecs.device
    cents = cents0.float()
    labels = torch.zeros((N,), dtype=torch.int64, device=dev)
    for _ in range(iters):
        cn = torch.sum(cents * cents, dim=1)
        sums = torch.zeros((NC, D), dtype=torch.float32, device=dev)
        counts = torch.zeros((NC,), dtype=torch.float32, device=dev)
        for s in range(0, N, chunk):
            vc = vecs[s:s + chunk].float()
            vn = torch.sum(vc * vc, dim=1)
            d = vn[:, None] + cn[None, :] - 2.0 * (vc @ cents.T)
            lab = torch.argmin(d, dim=1)
            labels[s:s + chunk] = lab
            sums.index_add_(0, lab, vc)
            counts.index_add_(0, lab, torch.ones_like(vn))
        cents = torch.where(counts[:, None] > 0,
                            sums / counts.clamp(min=1.0)[:, None], cents)
    return labels, cents


def _kmeans(vecs: np.ndarray, n_clusters: int, iters: int,
            rng: np.random.Generator, device) -> np.ndarray:
    """Mini k-means; returns (N,) labels.  The initial centroids are drawn
    with the reference's ``rng.choice`` call, so one seed starts both
    packages from the same rows."""
    N = vecs.shape[0]
    idx0 = rng.choice(N, n_clusters, replace=False)
    vt = torch.as_tensor(vecs).to(device)
    labels, _ = _kmeans_device(vt, vt[torch.as_tensor(idx0).to(device)],
                               iters, min(_ASSIGN_CHUNK, max(N, 8)))
    return labels.cpu().numpy()


def _blocks_from_labels(labels: np.ndarray, BS: int) -> list:
    """Member lists of the blocks: each cluster, in stable label order, cut
    into runs of at most BS members."""
    order = np.argsort(labels, kind="stable")
    boundaries = np.flatnonzero(np.diff(labels[order])) + 1
    return [seg[s:s + BS]
            for seg in np.split(order, boundaries)
            for s in range(0, seg.size, BS)]


def _layout_blocks(vecs: np.ndarray, BS: int, kmeans_iters: int,
                   rng: np.random.Generator, device="cpu"):
    """Cluster + chunk the corpus into contiguous blocks of <= BS members.

    Returns ``(blk_ids (NB, BS) i32 -1-padded, blk_vecs (NB, BS, D) f32)``.
    Targets ~75% average block fill so cluster-size jitter rarely splits
    blocks."""
    N, D = vecs.shape
    n_clusters = max(1, int(np.ceil(N / (0.75 * BS))))
    labels = _kmeans(vecs, n_clusters, kmeans_iters, rng, device) \
        if n_clusters > 1 else np.zeros(N, np.int32)
    blocks = _blocks_from_labels(labels, BS)
    NB = len(blocks)
    blk_ids = np.full((NB, BS), -1, np.int32)
    blk_vecs = np.zeros((NB, BS, D), np.float32)
    for b, members in enumerate(blocks):
        blk_ids[b, :members.size] = members
        blk_vecs[b, :members.size] = vecs[members]
    return blk_ids, blk_vecs


class DeviceBlockTables(NamedTuple):
    """Query-only block tables living entirely on the device — the at-scale
    serving fallback the HNSWIndex facade builds when the packed graph
    engine does not fit its memory budget.  No host mirrors: built FROM the
    device-resident ranking table.

    Tiles are bf16 (or whatever dtype the source table has), or — when the
    graph state plus the tiles would exceed the device's memory —
    per-block-scaled int8.  Quantized distances are exact FOR THE QUANTIZED
    VALUES (dot(q, s*v8) = s*dot(q, v8) with stored s^2*|v8|^2 norms), so
    the only ranking error is the quantization itself, absorbed by the
    oversampled panel + float64 refine."""
    blk_vecs: torch.Tensor     # (NB, BS, D) bf16/f32, or int8 (quantized)
    blk_scale: torch.Tensor    # (NB,) f32 dequant scale (ones unquantized)
    blk_ids: torch.Tensor      # (NB, BS) i32 corpus slot ids, -1 pad
    blk_fill: torch.Tensor     # (NB,) i32 live members per block
    blk_norms: torch.Tensor    # (NB, BS) f32 member norms (of the
    #                            dequantized values in int8 mode)
    cents: torch.Tensor        # (NB, D) f32 centroids
    cent_norms: torch.Tensor   # (NB,) f32
    cent_valid: torch.Tensor   # (NB,) bool
    n_blocks: int


def _gather_rows_bounded(table: torch.Tensor, idx: torch.Tensor,
                         chunk: int = 4096 * 128) -> torch.Tensor:
    """Row gather in bounded steps (the index transient is capped at
    ``chunk`` rows).  Negative indices yield zero rows."""
    n = idx.shape[0]
    out = torch.zeros((n, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for s in range(0, n, chunk):
        sl = idx[s:s + chunk]
        rows = table[sl.clamp(0, table.shape[0] - 1)]
        out[s:s + chunk] = torch.where((sl >= 0)[:, None], rows,
                                       torch.zeros_like(rows))
    return out


def _assign_rows_chunked(table: torch.Tensor, idx: torch.Tensor,
                         cents: torch.Tensor, chunk: int = 4096
                         ) -> torch.Tensor:
    """Nearest-centroid label per gathered row, in bounded chunks (the
    (chunk, NC) score panel is the binding transient)."""
    n = idx.shape[0]
    cn = torch.sum(cents * cents, dim=1)
    out = torch.zeros((n,), dtype=torch.int64, device=table.device)
    for s in range(0, n, chunk):
        rows = table[idx[s:s + chunk].clamp(0, table.shape[0] - 1)].float()
        out[s:s + chunk] = torch.argmin(
            cn[None, :] - 2.0 * (rows @ cents.T), dim=1)
    return out


def _gather_quant_blocks(metric: str, table: torch.Tensor,
                         slots: torch.Tensor, BS: int,
                         chunk_blocks: int = 4096):
    """Chunked gather + per-block int8 quantization.

    ``slots (NB*BS,)`` (-1 pad) -> ``(q8 (NB*BS, D) int8, scale (NB,) f32,
    sums (NB, D) f32, norms (NB*BS,) f32)``.  Every transient is bounded by
    the chunk: the float32 intermediate exists only per chunk, never at
    table size."""
    n = slots.shape[0]
    D = table.shape[1]
    dev = table.device
    q8 = torch.zeros((n, D), dtype=torch.int8, device=dev)
    sc = torch.zeros((n // BS,), dtype=torch.float32, device=dev)
    sm = torch.zeros((n // BS, D), dtype=torch.float32, device=dev)
    nm = torch.zeros((n,), dtype=torch.float32, device=dev)
    for b0 in range(0, n // BS, chunk_blocks):
        b1 = min(n // BS, b0 + chunk_blocks)
        sl = slots[b0 * BS:b1 * BS]
        rows = table[sl.clamp(0, table.shape[0] - 1)].float()
        rows = torch.where((sl >= 0)[:, None], rows, torch.zeros_like(rows))
        r3 = rows.reshape(b1 - b0, BS, D)
        s = r3.abs().amax(dim=(1, 2)).clamp(min=1e-30) / 127.0
        q = torch.clamp(torch.round(r3 / s[:, None, None]), -127, 127)
        # norms of the DEQUANTIZED values: |q8|^2 is exact in float32
        # (<= D * 127^2), then rescales per metric — sq_euclid's |v|^2 by
        # s^2, cosine's |v| by s, ucosine's zeros untouched
        nq2 = torch.sum(q * q, dim=2)
        if metric == "sq_euclid":
            norms = nq2 * (s * s)[:, None]
        elif metric == "cosine":
            norms = torch.sqrt(nq2) * s[:, None]
        else:
            norms = torch.zeros_like(nq2)
        q8[b0 * BS:b1 * BS] = q.to(torch.int8).reshape(-1, D)
        sc[b0:b1] = s
        sm[b0:b1] = r3.sum(dim=1)
        nm[b0 * BS:b1 * BS] = norms.reshape(-1)
    return q8, sc, sm, nm


def build_device_block_tables(metric: str, rank_vecs: torch.Tensor,
                              active_np: np.ndarray, block_size: int = 128,
                              kmeans_iters: int = 4, seed=None,
                              quantize: bool = False
                              ) -> Optional[DeviceBlockTables]:
    """Build DeviceBlockTables straight from a device-resident corpus.

    ``rank_vecs`` is the engine's (C, D) ranking table (the bf16 coarse
    table where there is one, which also halves the tiles' memory);
    ``active_np`` the host (C,) bool live mask.  Everything heavy stays on
    the device: centroids are trained on a bounded SAMPLE of the live rows,
    every live row is labelled with one chunked assignment pass straight
    off the source table, only the (N,) labels come back to lay the blocks
    out, and the block gather re-reads the live table on the device.

    Unlike the reference, the quantized tables are not padded to the
    gather's chunk granularity: shapes are dynamic here."""
    live = np.flatnonzero(active_np).astype(np.int64)
    N = live.size
    if N == 0:
        return None
    BS = int(block_size)
    D = int(rank_vecs.shape[1])
    dev = rank_vecs.device
    rng = np.random.default_rng(seed)

    n_clusters = max(1, int(np.ceil(N / (0.75 * BS))))
    if n_clusters > 1:
        sample = min(N, max(2 * n_clusters, 1 << 21))
        sub = np.sort(rng.choice(N, sample, replace=False)) \
            if sample < N else np.arange(N)
        vs = _gather_rows_bounded(rank_vecs,
                                  torch.as_tensor(live[sub]).to(dev))
        idx0 = rng.choice(sample, n_clusters, replace=False)
        _, cents_d = _kmeans_device(
            vs, vs[torch.as_tensor(idx0).to(dev)], kmeans_iters,
            min(_ASSIGN_CHUNK, max(sample, 8)))
        del vs
        labels = _assign_rows_chunked(
            rank_vecs, torch.as_tensor(live).to(dev), cents_d).cpu().numpy()
        del cents_d
    else:
        labels = np.zeros(N, np.int32)

    # host layout from the (N,) labels (the only full readback)
    blocks = _blocks_from_labels(labels, BS)
    NB = len(blocks)
    blk_slots = np.full((NB, BS), -1, np.int32)
    for b, members in enumerate(blocks):
        blk_slots[b, :members.size] = live[members]
    fill = (blk_slots >= 0).sum(axis=1).astype(np.int32)

    fill_t = torch.as_tensor(fill).to(dev)
    slots_t = torch.as_tensor(blk_slots).to(dev)
    denom = fill_t.clamp(min=1)[:, None].float()
    if quantize:
        q8, scale, sm, nm = _gather_quant_blocks(
            metric, rank_vecs, slots_t.reshape(-1).long(), BS)
        bv = q8.reshape(NB, BS, D)
        cents = sm / denom
        bnorms = torch.where(slots_t >= 0, nm.reshape(NB, BS),
                             torch.zeros_like(nm.reshape(NB, BS)))
    else:
        bv = _gather_rows_bounded(
            rank_vecs, slots_t.reshape(-1).long()).reshape(NB, BS, D)
        scale = torch.ones((NB,), dtype=torch.float32, device=dev)
        cents = torch.zeros((NB, D), dtype=torch.float32, device=dev)
        bnorms = torch.zeros((NB, BS), dtype=torch.float32, device=dev)
        for b0 in range(0, NB, 4096):       # f32 transients per chunk only
            t = bv[b0:b0 + 4096].float()
            cents[b0:b0 + 4096] = t.sum(dim=1)
            bnorms[b0:b0 + 4096] = dst.norm_data(metric, t)
        cents = cents / denom
        bnorms = torch.where(slots_t >= 0, bnorms, torch.zeros_like(bnorms))
    return DeviceBlockTables(
        blk_vecs=bv, blk_scale=scale, blk_ids=slots_t, blk_fill=fill_t,
        blk_norms=bnorms, cents=cents,
        cent_norms=dst.norm_data(metric, cents),
        cent_valid=fill_t > 0, n_blocks=NB)


def device_block_query(metric: str, tbl: DeviceBlockTables, q: torch.Tensor,
                       k: int, n_probe: int, oversample: int = 4):
    """Route + exact-score against DeviceBlockTables; returns device
    (dists, ids) with width >= k (callers refine + truncate).

    ``oversample`` widens the candidate panel the caller's float64 refine
    re-ranks: with bf16 tiles the panel's own top-k ordering is noise-bound
    inside tight clusters, so recall is bought by panel width, not probe
    count.  bf16 and f32 tiles are scored by kernel K2, int8 tiles by the
    plain scaled scoring."""
    bids = _route_exact(metric, tbl.cents, tbl.cent_norms, q,
                        min(n_probe, tbl.n_blocks), tbl.cent_valid)
    kk = max(k, min(oversample * k, 128))
    if tbl.blk_vecs.dtype == torch.int8:
        return _score_blocks(metric, tbl.blk_vecs, tbl.blk_ids,
                             tbl.blk_norms, q, bids, kk,
                             blk_scale=tbl.blk_scale)
    return _score_blocks_panel(metric, tbl.blk_vecs, tbl.blk_ids,
                               tbl.blk_fill, q, bids, kk)


def place_batch(ix, id_map: np.ndarray, gids: np.ndarray, a: np.ndarray,
                pref: np.ndarray) -> list:
    """Insert a batch of (gid, vec) rows into their nearest blocks with
    space (fresh blocks when the neighborhood is full); returns the
    touched block list.  ``ix`` duck-types the host tables; ``id_map`` is
    the caller's id -> flat-position array.  Host numpy, kept as in the
    reference.

    Placement rules:

    * membership consistency — a block accepts only vectors within ~2x
      its member radius.  Without this, out-of-distribution vectors (a
      new cluster) get stuffed into whatever old block has a free slot,
      and once enough pure new-cluster blocks exist those polluted homes
      rank below n_probe — the stored vector becomes unroutable;
    * open-block sharing — vectors with no consistent routed block join
      the nearest block opened earlier in the batch (unless it is a
      clearly worse fit than their full natural neighborhood), keeping
      distinct new clusters in distinct blocks.

    Per vector, candidate distances are ONE vectorized (npb, D) pass
    against the LIVE centroids (centroids drift toward the batch
    mid-placement, so a pre-batch precompute fragments the layout), and
    centroids/radii are maintained incrementally in O(dim) per placement
    via running sum / sum-of-squares (E|x-c|^2 = E|x|^2 - |c|^2)."""
    BS = ix.block_size
    m = a.shape[0]
    touched: set = set()
    bsum: dict = {}             # lazily-initialized running moments
    bss: dict = {}

    def moments(b):
        mo = bsum.get(b)
        if mo is None:
            f = int(ix._h_fill[b])
            mv = ix._h_vecs[b, :f].astype(np.float64)
            mo = bsum[b] = mv.sum(axis=0)
            bss[b] = float((mv * mv).sum())
        return mo

    for j in range(m):
        vec = a[j]
        b = -1
        row = pref[j]
        rowc = row[row >= 0]
        diffs = ix._h_cents[rowc] - vec
        dr = np.einsum("td,td->t", diffs, diffs)
        d0 = float(dr.min()) if dr.size else np.inf
        fill = ix._h_fill
        r2 = ix._h_r2
        for t in range(rowc.size):
            c = int(rowc[t])
            if fill[c] < BS and dr[t] <= 4.0 * r2[c] + 1e-12:
                b = c
                break
        if b < 0:
            ix._open_dyn = [ob for ob in ix._open_dyn
                            if ix._h_fill[ob] < BS]
            if ix._open_dyn:
                od = ix._h_cents[ix._open_dyn] - vec
                jj = int(np.argmin(np.einsum("bd,bd->b", od, od)))
                d_open = float(np.dot(od[jj], od[jj]))
                if d_open <= 4.0 * d0 + 1e-12:
                    b = int(ix._open_dyn[jj])
        if b < 0:                          # open a fresh block
            empty = np.flatnonzero(ix._h_fill == 0)
            if empty.size == 0:
                ix._grow_blocks(1)
                empty = np.flatnonzero(ix._h_fill == 0)
            b = int(empty[0])
            ix._open_dyn.append(b)
        s = int(ix._h_fill[b])
        gid = int(gids[j])
        sm = moments(b)         # BEFORE the writes: must see the old
        #                         fill prefix, or vec double-counts
        ix._h_ids[b, s] = gid
        ix._h_vecs[b, s] = vec
        ix._h_fill[b] = s + 1
        id_map[gid] = b * BS + s
        sm += vec
        bss[b] += float(np.dot(vec, vec))
        cn = sm / (s + 1)
        ix._h_cents[b] = cn
        ix._h_r2[b] = max(0.0, bss[b] / (s + 1) - float(cn @ cn))
        touched.add(b)
    return list(touched)


class BlockIndex:
    """Two-level block-scored index (see module docstring)."""

    def __init__(self, dim: int, metric: str = "sq_euclid",
                 parameters: Optional[HNSWParameters] = None,
                 block_size: int = 128, router: str = "exact",
                 kmeans_iters: int = 6,
                 device: torch.device | str = "cuda"):
        from .index import _check_full_f32
        dst.check_metric(metric)
        if dst.is_custom(metric):
            raise ValueError(
                "BlockIndex requires a dot-decomposable built-in metric")
        if router not in ("exact", "hnsw"):
            raise ValueError("router must be 'exact' or 'hnsw'")
        self.device = torch.device(device)
        _check_full_f32(self.device)
        self.dim = int(dim)
        self.metric = metric
        self.params = parameters or HNSWParameters()
        self.block_size = int(block_size)
        self.router = router
        self.kmeans_iters = int(kmeans_iters)
        self._built = False

    def _rng(self) -> np.random.Generator:
        seed = self.params.random_seed
        return np.random.default_rng(seed if seed >= 0 else None)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # -- build -----------------------------------------------------------

    def build(self, vectors) -> None:
        """Bulk build: cluster, lay out contiguous blocks."""
        vecs = np.ascontiguousarray(np.asarray(vectors, np.float32))
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) vectors")
        blk_ids, blk_vecs = _layout_blocks(
            vecs, self.block_size, self.kmeans_iters, self._rng(),
            self.device)
        self._install(blk_ids, blk_vecs, next_id=vecs.shape[0])

    def _install(self, blk_ids: np.ndarray, blk_vecs: np.ndarray,
                 next_id: int) -> None:
        """Set host mirrors + device tables from a block layout.  Shared
        by build/rebuild/deserialize.  Each block's live members must be a
        prefix of its row (scoring masks by fill count)."""
        NB, BS = blk_ids.shape
        self._h_ids = np.ascontiguousarray(blk_ids, np.int32)
        self._h_vecs = np.ascontiguousarray(blk_vecs, np.float32)
        fill_mask = self._h_ids >= 0
        self._h_fill = fill_mask.sum(axis=1).astype(np.int32)
        self._h_cents = (self._h_vecs.sum(axis=1)
                         / np.maximum(self._h_fill, 1)[:, None]
                         ).astype(np.float32)
        id_to_pos = np.full(max(next_id, 1), -1, np.int64)
        flat_ids = self._h_ids.reshape(-1)
        id_to_pos[flat_ids[flat_ids >= 0]] = np.flatnonzero(flat_ids >= 0)
        self._id_to_pos = id_to_pos
        self._next_id = int(next_id)
        # mean squared member->centroid distance per block: the dynamic
        # add path's membership-consistency radius (see place_batch)
        sq = ((self._h_vecs - self._h_cents[:, None, :]) ** 2).sum(axis=2)
        self._h_r2 = (np.where(fill_mask, sq, 0.0).sum(axis=1)
                      / np.maximum(self._h_fill, 1)).astype(np.float32)

        self._blk_vecs = self._to_dev(self._h_vecs)
        self._blk_ids = self._to_dev(self._h_ids)
        self._blk_fill = self._to_dev(self._h_fill)
        self._cents = self._to_dev(self._h_cents)
        self._cent_norms = dst.norm_data(self.metric, self._cents)
        self._cent_valid = self._blk_fill > 0
        self.n_blocks = NB
        self.count = int(fill_mask.sum())
        self._built_count = max(1, self.count)
        self._open_dyn: list = []       # blocks opened by dynamic overflow
        self._router_dirty = False
        if self.router == "hnsw":
            self._build_router()
        self._built = True

    def _build_router(self) -> None:
        """The centroid graph of ``router="hnsw"``: centroids are added in
        block order, so slot id == block number; empty blocks get a far,
        finite dummy (1e15 keeps float32 squared norms finite) and are
        removed at once, so they are never routed to."""
        from .index import HNSWIndex
        p = HNSWParameters(collection_size=self.n_blocks,
                           random_seed=self.params.random_seed)
        self._router_index = HNSWIndex(self.dim, self.metric, p,
                                       device=self.device)
        cents = self._h_cents.copy()
        cents[self._h_fill == 0] = np.float32(1e15)
        self._router_index.add(cents)
        dead = np.flatnonzero(self._h_fill == 0)
        if dead.size:
            self._router_index.remove(dead)
        self._router_dirty = False

    # -- dynamics ---------------------------------------------------------
    #
    # The reference index is fully dynamic (HNSWIndex.cs:55-100); the block
    # tier accepts incremental mutation so at-scale serving survives churn
    # without a full rebuild: adds append into the nearest block with space
    # (else open a fresh block), removals swap-compact within the block
    # (each block is an unordered set, so the fill-prefix invariant that
    # scoring relies on is preserved), updates evict and re-place.  Only
    # touched blocks are re-uploaded.  Centroids drift from their members
    # as churn accumulates — needs_rebuild() flags when rebuild() (same
    # layout pipeline as build(), ids preserved) should be scheduled.

    def _grow_blocks(self, n_new: int) -> None:
        """Extend the block tables by >= n_new empty blocks (with slack so
        the tables are reallocated rarely)."""
        NB, BS = self._h_ids.shape
        extra = max(n_new, 16, NB // 4)
        self._h_ids = np.concatenate(
            [self._h_ids, np.full((extra, BS), -1, np.int32)])
        self._h_vecs = np.concatenate(
            [self._h_vecs, np.zeros((extra, BS, self.dim), np.float32)])
        self._h_fill = np.concatenate(
            [self._h_fill, np.zeros(extra, np.int32)])
        self._h_cents = np.concatenate(
            [self._h_cents, np.zeros((extra, self.dim), np.float32)])
        self._h_r2 = np.concatenate(
            [self._h_r2, np.zeros(extra, np.float32)])
        self._blk_ids = torch.cat(
            [self._blk_ids, self._blk_ids.new_full((extra, BS), -1)])
        self._blk_vecs = torch.cat(
            [self._blk_vecs, self._blk_vecs.new_zeros((extra, BS, self.dim))])
        self._blk_fill = torch.cat(
            [self._blk_fill, self._blk_fill.new_zeros(extra)])
        self._cents = torch.cat(
            [self._cents, self._cents.new_zeros((extra, self.dim))])
        self._cent_norms = dst.norm_data(self.metric, self._cents)
        self._cent_valid = self._blk_fill > 0
        self.n_blocks = self._h_ids.shape[0]
        self._router_dirty = True

    def _touch_device(self, blocks) -> None:
        """Push the host rows of the touched blocks to the device tables,
        in place (bounded upload — never the whole table)."""
        tb = np.unique(np.asarray(blocks, np.int64))
        if tb.size == 0:
            return
        tbt = self._to_dev(tb)
        self._blk_vecs[tbt] = self._to_dev(self._h_vecs[tb])
        self._blk_ids[tbt] = self._to_dev(self._h_ids[tb])
        self._blk_fill[tbt] = self._to_dev(self._h_fill[tb])
        self._cents[tbt] = self._to_dev(self._h_cents[tb])
        self._cent_norms = dst.norm_data(self.metric, self._cents)
        self._cent_valid = self._blk_fill > 0
        self._router_dirty = True

    def _refresh_cent(self, b: int) -> None:
        f = int(self._h_fill[b])
        if f:
            c = self._h_vecs[b, :f].mean(axis=0)
            self._h_cents[b] = c
            self._h_r2[b] = ((self._h_vecs[b, :f] - c) ** 2).sum(1).mean()
        else:
            self._h_cents[b] = 0.0
            self._h_r2[b] = 0.0

    def _route_pref(self, a: np.ndarray) -> np.ndarray:
        """(m, npb) preferred-block table for a batch of vectors."""
        npb = min(8, self.n_blocks)
        out = np.empty((a.shape[0], npb), np.int32)
        for i in range(0, a.shape[0], _ASSIGN_CHUNK):
            out[i:i + _ASSIGN_CHUNK] = _route_exact(
                self.metric, self._cents, self._cent_norms,
                self._to_dev(a[i:i + _ASSIGN_CHUNK]), npb,
                self._cent_valid).cpu().numpy()
        return out

    def _place_batch(self, gids: np.ndarray, a: np.ndarray,
                     pref: np.ndarray) -> list:
        return place_batch(self, self._id_to_pos, gids, a, pref)

    def _evict_one(self, gid: int) -> int:
        """Swap-compact one id out of its block (live members stay a
        prefix); returns the block it left."""
        BS = self.block_size
        pos = self._id_to_pos[gid]
        b, s = int(pos // BS), int(pos % BS)
        last = int(self._h_fill[b]) - 1
        if s != last:                      # swap the tail member in
            mv = int(self._h_ids[b, last])
            self._h_ids[b, s] = mv
            self._h_vecs[b, s] = self._h_vecs[b, last]
            self._id_to_pos[mv] = b * BS + s
        self._h_ids[b, last] = -1
        self._h_vecs[b, last] = 0.0
        self._h_fill[b] = last
        self._id_to_pos[gid] = -1
        self._refresh_cent(b)
        return b

    def _require_built(self) -> None:
        if not self._built:
            raise RuntimeError("BlockIndex.build() must be called first")

    def _as_rows(self, vectors) -> np.ndarray:
        a = np.ascontiguousarray(np.asarray(vectors, np.float32))
        if a.ndim == 1:
            a = a[None]
        if a.shape[1] != self.dim:
            raise ValueError(f"expected dim={self.dim}, got {a.shape[1]}")
        return a

    def add(self, vectors) -> np.ndarray:
        """Append vectors into their nearest blocks (new blocks when the
        neighborhood is full).  Returns new int32 ids — ids are allocated
        monotonically and never reused by the block tier."""
        self._require_built()
        a = self._as_rows(vectors)
        m = a.shape[0]
        if m == 0:
            return np.empty(0, np.int32)
        pref = self._route_pref(a)
        new_ids = self._next_id + np.arange(m, dtype=np.int64)
        self._next_id += m
        self._id_to_pos = np.concatenate(
            [self._id_to_pos, np.full(m, -1, np.int64)])
        touched = self._place_batch(new_ids, a, pref)
        self._touch_device(touched)
        self.count += m
        return new_ids.astype(np.int32)

    def remove(self, ids) -> None:
        """Remove by id: swap-compact each block so live members stay a
        prefix."""
        self._require_built()
        arr = np.unique(np.asarray(ids, np.int64).ravel())
        arr = arr[(arr >= 0) & (arr < self._id_to_pos.size)]
        arr = arr[self._id_to_pos[arr] >= 0]
        if arr.size == 0:
            return
        touched = [self._evict_one(int(g)) for g in arr]
        self._touch_device(touched)
        self.count -= arr.size

    def update(self, ids, vectors) -> None:
        """Replace stored vectors keeping their ids.  Updated vectors are
        RE-ROUTED to their new nearest block (evict + place, reference
        update = remove + reinsert, HNSWIndex.cs:90-100): an in-place
        rewrite leaves a far-moved vector in a block whose centroid no
        longer represents it, and routed queries miss it."""
        self._require_built()
        arr = np.asarray(ids, np.int64).ravel()
        a = self._as_rows(vectors)
        if arr.size != a.shape[0]:
            raise ValueError("ids and vectors must have matching length")
        bad = ((arr < 0) | (arr >= self._id_to_pos.size))
        if bad.any() or (self._id_to_pos[arr] < 0).any():
            raise ValueError("update ids must all be active")
        pref = self._route_pref(a)
        touched = [self._evict_one(g) for g in arr.tolist()]
        touched += self._place_batch(arr, a, pref)
        self._touch_device(touched)

    def needs_rebuild(self) -> bool:
        """True when churn has degraded the layout enough that routing
        recall may suffer: live count drifted past 2x/0.5x of the last
        full layout, or average live-block fill fell under 40%."""
        live_blocks = int((self._h_fill > 0).sum())
        avg_fill = self.count / max(1, live_blocks * self.block_size)
        drift = self.count / self._built_count
        return drift > 2.0 or drift < 0.5 or avg_fill < 0.4

    def rebuild(self) -> None:
        """Full re-layout of the live members (ids preserved): the remedy
        needs_rebuild() asks for."""
        live = np.flatnonzero(self._id_to_pos >= 0)
        pos = self._id_to_pos[live]
        vecs = self._h_vecs.reshape(-1, self.dim)[pos]
        bi, bv = _layout_blocks(vecs, self.block_size, self.kmeans_iters,
                                self._rng(), self.device)
        keep = bi >= 0
        bi = np.where(keep, live[np.clip(bi, 0, live.size - 1)].astype(
            np.int64), -1).astype(np.int32)
        self._install(bi, bv, next_id=self._next_id)

    # -- persistence ------------------------------------------------------

    def serialize(self, path: str) -> None:
        """Snapshot the block layout to one .npz (the reference's format:
        either package loads the other's file)."""
        if not self._built:
            raise RuntimeError("nothing to serialize: build() first")
        header = {
            "dim": self.dim, "metric": self.metric,
            "block_size": self.block_size, "router": self.router,
            "count": int(self.count), "n_blocks": int(self.n_blocks),
            "random_seed": int(self.params.random_seed),
            "next_id": int(self._next_id),
        }
        np.savez_compressed(
            path,
            header=np.frombuffer(json.dumps(header).encode(), np.uint8),
            blk_vecs=self._h_vecs,
            blk_ids=self._h_ids,
            cents=self._h_cents)

    @classmethod
    def deserialize(cls, path: str,
                    device: torch.device | str = "cuda") -> "BlockIndex":
        with np.load(npz_path(path)) as z:
            header = json.loads(bytes(z["header"]).decode())
            params = HNSWParameters(
                random_seed=int(header.get("random_seed", 31337)))
            ix = cls(header["dim"], header["metric"], parameters=params,
                     block_size=header["block_size"],
                     router=header["router"], device=device)
            blk_vecs = z["blk_vecs"]
            blk_ids = z["blk_ids"]
        next_id = int(header.get(
            "next_id", blk_ids.max(initial=-1) + 1))
        ix._install(blk_ids, blk_vecs, next_id=max(1, next_id))
        return ix

    # -- query -----------------------------------------------------------

    def _route(self, q: torch.Tensor, n_probe: int) -> torch.Tensor:
        """(B, n_probe) int32 block ids, nearest first (-1 pads): the exact
        centroid scan, or a beam over the centroid graph (rebuilt first if a
        mutation touched the centroids)."""
        if self.router == "hnsw":
            from .core.search import knn_search
            if self._router_dirty:
                self._build_router()
            ri = self._router_index
            expand = max(1, ri.params.query_expand)
            ef = max(n_probe, ri.params.min_nn)
            mi = (ri._cfg.search_iter_factor * ef) // expand + 16
            _, bids = knn_search(ri._cfg, ri._state, q, 0, ef, mi,
                                 expand=expand)
            return bids[:, :n_probe].to(torch.int32).contiguous()
        return _route_exact(self.metric, self._cents, self._cent_norms, q,
                            n_probe, self._cent_valid)

    def query_device(self, q: torch.Tensor, k: int, n_probe: int = 32):
        """Device-level query: returns (dists, ids) device tensors without
        host-side refinement — the form benchmark loops want.  ``knn_query``
        wraps this with float64 refinement."""
        n_probe = min(n_probe, self.n_blocks)
        bids = self._route(q, n_probe)
        return _score_blocks_panel(self.metric, self._blk_vecs,
                                   self._blk_ids, self._blk_fill, q, bids, k)

    def knn_query(self, queries, k: int, n_probe: int = 32
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched k-NN: route to ``n_probe`` blocks, exact-score them.
        Returns (ids (n, k) int32, dists (n, k) f32), -1/NaN padded."""
        self._require_built()
        q = np.ascontiguousarray(np.asarray(queries, np.float32))
        if q.ndim == 1:
            q = q[None]
        out_ids = np.empty((q.shape[0], k), np.int32)
        out_d = np.empty((q.shape[0], k), np.float32)
        for i in range(0, q.shape[0], QUERY_BATCH):
            qb = q[i:i + QUERY_BATCH]
            _, ids = self.query_device(self._to_dev(qb), k, n_probe)
            out_ids[i:i + QUERY_BATCH], out_d[i:i + QUERY_BATCH] = \
                self._refine(qb, ids.cpu().numpy(), k)
        return out_ids, out_d

    def _refine(self, q: np.ndarray, ids: np.ndarray, k: int):
        """Recompute returned distances in float64 and re-sort (the
        ranking panel may be computed at reduced precision)."""
        from .utils.refine import refine_pairs
        pos = self._id_to_pos
        rows = pos[np.clip(ids, 0, pos.size - 1)]
        rows = np.clip(rows, 0, self._h_vecs.size // self.dim - 1)
        return refine_pairs(self.metric, q, ids,
                            self._h_vecs.reshape(-1, self.dim)[rows], k)


def _route_exact(metric: str, cents: torch.Tensor, cent_norms: torch.Tensor,
                 q: torch.Tensor, n_probe: int,
                 cent_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-``n_probe`` blocks by centroid distance, nearest first (an exact
    top-k where the reference takes an approximate one).  ``cent_valid``
    masks out empty blocks (growth headroom allocated by dynamic adds)."""
    d = dst.pairwise(metric, q, cents, dst.norm_data(metric, q), cent_norms)
    if cent_valid is not None:
        d = torch.where(cent_valid[None, :], d, float("inf"))
    k2 = min(cents.shape[0], n_probe)
    return torch.topk(d, k2, dim=1, largest=False).indices.to(torch.int32)


def _score_blocks_panel(metric: str, blk_vecs: torch.Tensor,
                        blk_ids: torch.Tensor, blk_fill: torch.Tensor,
                        q: torch.Tensor, bids: torch.Tensor, k: int):
    """Score probed blocks with kernel K2 (ops/block_scores.py) and select
    the top of the distance panel (the reference's
    ``_score_blocks_pallas``).  Partly filled blocks are masked with their
    fill counts (no per-row id gather needed).  Returns ``(vals, ids)`` of
    width ``min(max(2k, 32), P*BS)``: the selection is oversampled and the
    caller re-ranks in float64."""
    B, P = bids.shape
    NB, BS, D = blk_vecs.shape
    panel = block_scores(metric, blk_vecs, bids.contiguous(),
                         q.contiguous())                      # (B, P*BS)
    bidc = bids.long().clamp(0, NB - 1)
    fillp = blk_fill[bidc]                                    # (B, P)
    ok = (torch.arange(BS, device=q.device)[None, None, :]
          < fillp[:, :, None]) & (bids >= 0)[:, :, None]
    panel = torch.where(ok.reshape(B, P * BS), panel, float("inf"))
    k2 = min(max(2 * k, 32), P * BS)
    vals, pos = torch.topk(panel, k2, dim=1, largest=False)
    blk_of = torch.gather(bidc, 1, pos // BS)
    ids = blk_ids[blk_of, pos % BS]
    ids = torch.where(torch.isfinite(vals), ids, -1)
    return vals, ids


def _score_blocks(metric: str, blk_vecs: torch.Tensor, blk_ids: torch.Tensor,
                  blk_norms: torch.Tensor, q: torch.Tensor,
                  bids: torch.Tensor, k: int,
                  blk_scale: Optional[torch.Tensor] = None):
    """Exact scoring of each query's probed blocks in plain torch, with a
    running top-k (the reference's ``_score_blocks`` and, with
    ``blk_scale``, its ``_score_blocks_q8``).

    Blocks are fetched four probes at a time so transient memory stays
    bounded.  The operands are cast to bf16 for int8 tiles and to the tile
    dtype otherwise, widened to float32 and accumulated in float32;
    ``blk_scale (NB,)`` rescales each block's dots:
    dot(q, s*v8) = s * dot(q, v8), and the stored norms are of the
    dequantized values, so distances are exact for the quantized points.
    Returns ``(dists (B, k), ids (B, k))``, ascending, +inf/-1 padded."""
    B, P = bids.shape
    NB = blk_vecs.shape[0]
    dev = q.device
    qn = dst.norm_data(metric, q)[:, None, None]
    op = torch.bfloat16 if blk_scale is not None else blk_vecs.dtype
    qc = q.to(op).float()
    bd = torch.full((B, k), float("inf"), dtype=torch.float32, device=dev)
    bi = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    PG = 4
    for p0 in range(0, P, PG):
        ids_g = bids[:, p0:p0 + PG]                          # (B, <=PG)
        idc = ids_g.long().clamp(0, NB - 1)
        ig = blk_ids[idc]                                    # (B, PG, BS)
        dots = torch.einsum("bpsd,bd->bps", blk_vecs[idc].to(op).float(), qc)
        if blk_scale is not None:
            dots = dots * blk_scale[idc][:, :, None]
        dd = dst.from_dot(metric, dots, qn, blk_norms[idc])
        valid = (ig >= 0) & (ids_g >= 0)[:, :, None]
        md = torch.cat([bd, torch.where(valid, dd, float("inf"))
                        .reshape(B, -1)], dim=1)
        mi = torch.cat([bi, torch.where(valid, ig, -1).reshape(B, -1)],
                       dim=1)
        order = torch.argsort(md, dim=1, stable=True)[:, :k]
        bd = torch.gather(md, 1, order)
        bi = torch.gather(mi, 1, order)
    bi = torch.where(torch.isfinite(bd), bi, -1)
    return bd, bi

