"""`HNSWIndex` — the index facade.

Counterpart of ``hnswindex_tpu/index.py``: ``add`` builds with
wave-batched inserts (core/construct.py), from exact candidates while the
corpus is at most ``exact_build_threshold`` rows and by beam search past
it.  Unfiltered layer-0 ``knn_query`` is served by the packed engine
(core/pack.py) once the corpus reaches ``pack_min_count``, by block tables
built on the device when the pack does not fit ``pack_max_bytes``
(block.py, the at-scale fallback), and by the unpacked graph search
(core/search.py) otherwise; ``layer > 0``, ``range_query`` and
``multi_layer_knn_query`` use the unpacked search, ``exact=True`` the
two-stage brute-force scan (ops/bruteforce.py).  Returned pairs are
refined in full precision.

The device owns the graph state; the host owns slot allocation, level
sampling (numpy RNG, seeded exactly like the reference), capacity growth
and the wave schedule.  What is not ported yet (filters, removal, update,
stats, snapshots) raises ``NotImplementedError`` naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core import construct as CS
from .core import graph as G
from .core import pack as PK
from .core import search as SR
from .ops import bruteforce as BF
from .ops import distance as dst
from .params import HNSWParameters
from .utils.profiling import PhaseTimer
from .utils.refine import refine_on_device, refine_pairs


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to hnswindex_torch yet (ROADMAP {item})")


def resolve_rank_dtype(pref: str) -> str:
    """"auto" resolves to float32 (reference ``resolve_rank_dtype``)."""
    canon = {"float32": "float32", "f32": "float32",
             "bfloat16": "bfloat16", "bf16": "bfloat16",
             "auto": "float32"}
    if pref not in canon:
        raise ValueError(
            "rank_dtype must be 'auto', 'float32'/'f32' or "
            f"'bfloat16'/'bf16' (got {pref!r})")
    return canon[pref]


def resolve_pack_dtype(params, capacity: int, k: int, dim: int):
    """Residual dtype of the query pack per params.pack_dtype, or None when
    the pack would not fit params.pack_max_bytes."""
    if params.pack_dtype == "auto":
        for cand in (torch.float32, torch.bfloat16):
            if PK.pack_bytes(capacity, k, dim, cand) <= params.pack_max_bytes:
                return cand
        return None
    cand = torch.float32 if params.pack_dtype == "f32" else torch.bfloat16
    if PK.pack_bytes(capacity, k, dim, cand) > params.pack_max_bytes:
        return None
    return cand


#: The reference's wave-bucket ladder.  The port runs waves at their exact
#: width; the ladder only decides which waves count as full width for the
#: two-stage scan gate (``scan2``), as in the reference.
WAVE_BUCKETS = (8, 64, 512, 4096)
#: most level>=1 members in one wave (the reference's upper-lane ladder top)
MAX_UPPER = 512
#: queries per search launch
QUERY_BATCH = 1024
#: lane count of the exact query's lane-min scan.  At the reference's
#: 1,024 lanes a clustered corpus (clusters of ~500 rows) loses ~1.7% of
#: its true top-10 to a cluster mate that shares the lane and ranks below
#: it on the bf16 products (recall@10 0.983, the reference's exact bar
#: 0.9825); 4,096 lanes hold four times fewer mates a lane (0.996).  The
#: build keeps 1,024, so that both packages build the same graph.
EXACT_LANES = 4096
#: range-search result pool ladder (the reference's)
RANGE_POOLS = (64, 512, 4096)
#: k-NN seeds injected into the range pool (_range_once)
RANGE_SEED_EF = 16
#: floor of the reference's scan-prefix bucket ladder (the scan gate reads
#: it; the port's scan itself covers the exact high-water prefix)
SCAN_FLOOR = 1 << 20
#: minimum capacity of the upper-node panel
_PANEL_MIN_CAP = 1 << 16
#: host-mirror budget: below it results refine in float64 on the host
MIRROR_MAX_BYTES = 1 << 31
#: capacity alignment above which capacity grows in 8192-row steps
_CAP_ALIGN = 8192


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _alloc_capacity(n: int) -> int:
    """Allocated rows for a requested collection size: a power of 2 up to
    8192, the next 8192-row multiple above (reference rule)."""
    if n <= _CAP_ALIGN:
        return _next_pow2(max(n, 2))
    return -(-n // _CAP_ALIGN) * _CAP_ALIGN


def _as_2d_f32(x, dim: int) -> np.ndarray:
    a = np.asarray(x, dtype=np.float32)
    if a.ndim == 1:
        a = a.reshape(1, -1)
    if a.ndim != 2:
        raise ValueError("expected a 2D array of shape (n, dim) or a 1D "
                         "vector")
    if a.shape[1] != dim:
        raise ValueError(f"expected dim={dim}, got {a.shape[1]}")
    return np.ascontiguousarray(a)


def _check_full_f32(device: torch.device) -> None:
    """Distance products in float32 must not run in TF32."""
    if device.type != "cuda":
        return
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "hnswindex_torch needs full-precision float32 matmuls on CUDA: "
            "set torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


class HNSWIndex:
    """HNSW index on one torch device (see module docstring)."""

    def __init__(self, dim: int, metric: str = "sq_euclid",
                 parameters: Optional[HNSWParameters] = None,
                 device: torch.device | str = "cuda"):
        dst.check_metric(metric)
        self.device = torch.device(device)
        _check_full_f32(self.device)
        self.dim = int(dim)
        self.metric = metric
        self.params = parameters or HNSWParameters()
        self.params.validate()

        p = self.params
        capacity = _alloc_capacity(p.collection_size)
        self._cfg = G.GraphConfig(
            dim=self.dim, metric=metric, max_edges=p.max_edges,
            max_levels=G.default_max_levels(capacity, p.distribution_rate),
            ef_construction=p.max_candidates,
            search_iter_factor=p.search_iter_factor,
            build_expand=p.build_expand,
            rank_dtype=resolve_rank_dtype(p.rank_dtype),
            slack0=min(p.reverse_slack, p.max_edges // 2))
        self._state = G.empty_state(self._cfg, capacity, self.device)
        seed = p.random_seed if p.random_seed >= 0 else None
        self._rng = np.random.default_rng(seed)
        self._length = 0             # high-water slot mark (GraphData.cs:25)
        self._count_host = 0         # host mirror of state.count
        self._pack = None            # lazily built QueryPack
        self._pack_refusal = ""      # why _get_pack last returned None
        self._block_fb = None        # lazily built DeviceBlockTables
        self._host_vectors: Optional[np.ndarray] = None
        # upper-node panel: ids of every node with level >= 1
        self._upper_np = np.empty(0, np.int32)
        self._upper_ids: Optional[torch.Tensor] = None
        self._scan_hwm = 0           # 1 + highest slot ever activated
        #: per-phase build times (scan, prune, reverse, upper, ...)
        self.timer = PhaseTimer(self.device)
        #: waves inserted on each build path
        self.wave_counts = {"exact": 0, "beam": 0}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def _invalidate_caches(self) -> None:
        self._pack = None
        self._block_fb = None
        self._host_vectors = None

    def _grow_to(self, needed: int) -> None:
        C = self._state.capacity
        if needed <= C:
            return
        newC = C
        while newC < needed:
            newC *= 2                      # GraphData.cs:100
        self._state = G.grow_state(self._state, newC)

    def _alloc_slots(self, n: int) -> np.ndarray:
        """Fresh slots at the high-water mark (no removals: no free list)."""
        self._grow_to(self._length + n)
        slots = np.arange(self._length, self._length + n, dtype=np.int32)
        self._length += n
        return slots

    def add(self, vecs) -> np.ndarray:
        """Insert a batch; returns the assigned int32 ids
        (HNSWIndex.cs:55-78)."""
        a = _as_2d_f32(vecs, self.dim)
        n = a.shape[0]
        if n == 0:
            return np.empty(0, dtype=np.int32)
        self._invalidate_caches()
        lvls = G.sample_levels(self._rng, n, self.params.distribution_rate,
                               self._cfg.max_levels)
        ids = self._alloc_slots(n)
        self._insert_batch(ids, a, lvls)
        return ids

    def _insert_batch(self, ids: np.ndarray, a: np.ndarray,
                      lvls: np.ndarray) -> None:
        """Seed the first node as the edgeless entry point
        (GraphConnector.cs:27-33), then insert waves under the reference's
        schedule: ``w = min(max_wave, 4096, max(1, built), remaining)``,
        cut so that at most MAX_UPPER level>=1 members share a wave."""
        n = ids.shape[0]
        i = 0
        if self._count_host == 0:
            G.seed_first_node(self._cfg, self._state, int(ids[0]), a[0],
                              int(lvls[0]))
            self._scan_hwm = max(self._scan_hwm, int(ids[0]) + 1)
            if lvls[0] >= 1:
                self._panel_append(ids[:1])
            self._count_host = 1
            i = 1
        if i >= n:
            return
        # batch-wide: the panel may hold future-wave ids, which
        # upper_connect_exact masks out through `active`
        self._panel_append(ids[i:][lvls[i:] >= 1])
        hwm = np.maximum.accumulate(ids[i:]) + 1
        dev = self.device
        ids_d = torch.as_tensor(ids.astype(np.int64)).to(dev)
        lvls_d = torch.as_tensor(lvls.astype(np.int64)).to(dev)
        vecs_d = torch.as_tensor(a).to(dev)
        mw = min(self.params.max_wave_size, WAVE_BUCKETS[-1])
        k = i
        while k < n:
            w = min(mw, max(1, self._count_host), n - k)
            upc = np.cumsum(lvls[k:k + w] >= 1)
            if w > MAX_UPPER and upc[-1] > MAX_UPPER:
                w = int(np.searchsorted(upc, MAX_UPPER, side="right"))
            self._scan_hwm = max(self._scan_hwm, int(hwm[k - i + w - 1]))
            wl = lvls[k:k + w]
            up = np.flatnonzero(wl >= 1)
            self._insert_wave(ids_d[k:k + w], vecs_d[k:k + w],
                              lvls_d[k:k + w], up,
                              int(wl.max()) if up.size else 0,
                              full=_bucket(w, WAVE_BUCKETS) >= mw)
            self._count_host += w
            k += w

    def _insert_wave(self, wid, wvec, wlvl, up: np.ndarray, max_lvl: int,
                     full: bool) -> None:
        """One wave: store, connect upper members, connect layer 0; on the
        exact path while the corpus is at most ``exact_build_threshold``
        rows, on the beam path past it (reference ``_insert_wave_dev``)."""
        cfg, st = self._cfg, self._state
        upt = torch.as_tensor(up).to(self.device) if up.size else None
        if self._count_host > self.params.exact_build_threshold:
            self.wave_counts["beam"] += 1
            with self.timer.phase("beam_wave"):
                CS.scatter_wave(cfg, st, wid, wvec, wlvl)
                ue = None
                if upt is not None:
                    with self.timer.phase("upper"):
                        ue = CS.upper_connect(cfg, st, wid[upt], wlvl[upt],
                                              max_lvl, self.timer)
                CS.base_connect(cfg, st, wid, wlvl, upt, ue, self.timer)
            return
        self.wave_counts["exact"] += 1
        CS.scatter_wave(cfg, st, wid, wvec, wlvl)
        if upt is not None:
            with self.timer.phase("upper"):
                CS.upper_connect_exact(cfg, st, wid[upt], wlvl[upt],
                                       self._upper_ids, max_lvl)
        nscan = min(st.capacity, max(SCAN_FLOOR, _next_pow2(self._scan_hwm)))
        CS.base_connect_exact(cfg, st, wid, wlvl, nscan=nscan, scan2=full,
                              prefix=self._scan_hwm, timer=self.timer)

    def _panel_append(self, ids: np.ndarray) -> None:
        """Record newly inserted level>=1 node ids in the upper panel."""
        if ids.size == 0 and self._upper_ids is not None:
            return
        self._upper_np = np.concatenate([self._upper_np,
                                         ids.astype(np.int32)])
        cap = max(_PANEL_MIN_CAP, _next_pow2(max(1, self._upper_np.size)))
        arr = np.full(cap, -1, np.int32)
        arr[:self._upper_np.size] = self._upper_np
        self._upper_ids = torch.as_tensor(arr).to(self.device)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _mirrorable(self) -> bool:
        return self._state.capacity * self.dim * 4 <= MIRROR_MAX_BYTES

    def _host_vecs(self) -> np.ndarray:
        """Host mirror of the stored vectors (cached until a mutation)."""
        if self._host_vectors is None:
            self._host_vectors = self._state.vectors.cpu().numpy()
        return self._host_vectors

    def _get_pack(self) -> Optional[PK.QueryPack]:
        """The packed-neighbourhood tables, built on first use.  None means
        "serve unpacked", and ``_pack_refusal`` says why: "disabled"
        (``pack_queries="off"``), "too_small" (under ``pack_min_count`` in
        "auto") or "budget" (past ``pack_max_bytes``, which the block
        fallback gates on)."""
        p = self.params
        if p.pack_queries == "off":
            self._pack_refusal = "disabled"
            return None
        if p.pack_queries == "auto" and self._count_host < p.pack_min_count:
            self._pack_refusal = "too_small"
            return None
        if self._pack is not None:
            return self._pack
        C = self._state.capacity
        K = min(self._state.nbr0.shape[1], 2 * p.max_edges)
        res_dtype = resolve_pack_dtype(p, C, K, self.dim)
        if res_dtype is None:
            self._pack_refusal = "budget"
            return None
        # entry set: the lowest upper level whose population fits the scan
        lvl = self._state.level.cpu().numpy()
        act = self._state.active.cpu().numpy()
        eids = None
        for layer in range(1, self._state.num_levels):
            members = np.flatnonzero((lvl >= layer) & act)
            if members.size <= PK.ENTRY_SCAN_MAX:
                eids = members
                break
        if eids is None or eids.size == 0:
            eids = np.asarray([int(self._state.ep)])
        S = 1 << max(0, int(eids.size - 1).bit_length())
        padded = np.full(S, -1, np.int32)
        padded[:eids.size] = eids
        self._pack = PK.make_query_pack(
            self._cfg, self._state, torch.as_tensor(padded).to(self.device),
            res_dtype)
        return self._pack

    def _get_block_fallback(self):
        """At-scale serving fallback: when the query pack does not fit its
        budget, plain layer-0 ``knn_query`` is served from query-only block
        tables built ON THE DEVICE from the bf16 coarse table
        (block.build_device_block_tables: no host mirror) by routed block
        scoring, instead of the unpacked beam.

        Engages only when ALL hold: params.block_fallback == "auto", the
        pack path is enabled and would have been used (count >=
        pack_min_count) but was refused for its budget.  Invalidated on
        every mutation like the pack."""
        if self._block_fb is not None:
            return self._block_fb
        p = self.params
        if (p.block_fallback != "auto" or p.pack_queries == "off"
                or self._count_host < p.pack_min_count):
            return None
        if self._get_pack() is not None or self._pack_refusal != "budget":
            return None
        from .block import build_device_block_tables
        # prefer the bf16 coarse table over a float32 ranking table: half
        # the tile memory and scoring bandwidth, and the f64 refine re-ranks
        # the oversampled panel exactly
        src = self._state.coarse_table
        if src is None:
            src = self._state.vlo
        # int8 tiles when the graph state plus the tiles (at src's dtype)
        # and 1 GiB of transients would pass 80% of the device's memory.
        # The budget is the card's total memory (HNSW_HBM_BYTES overrides
        # it); on the CPU, without the override, tiles are never quantized.
        budget = os.environ.get("HNSW_HBM_BYTES")
        if budget is not None:
            budget = int(budget)
        elif self.device.type == "cuda":
            budget = torch.cuda.mem_get_info(self.device)[1]
        quantize = False
        if budget is not None:
            state_bytes = sum(
                getattr(self._state, f.name).nbytes
                for f in dataclasses.fields(self._state))
            tile_rows = -(-self._count_host // 96) * 128   # ~75% target fill
            quantize = (state_bytes
                        + tile_rows * self.dim * src.element_size()
                        + (1 << 30) > int(0.80 * budget))
        self._block_fb = build_device_block_tables(
            self.metric, src, self._state.active.cpu().numpy(),
            seed=(p.random_seed if p.random_seed >= 0 else None),
            quantize=quantize)
        return self._block_fb

    def _block_fallback_query(self, fb, q: np.ndarray, k: int
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """Serve a batch through the device block tables + refine."""
        from .block import device_block_query
        n = q.shape[0]
        # the probe count scales with the table so the probed corpus
        # fraction (hence recall) holds as blocks multiply
        n_probe = max(8, fb.n_blocks // 1024)
        out_ids = np.empty((n, k), np.int32)
        out_d = np.empty((n, k), np.float32)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            qt = torch.as_tensor(q[i:j]).to(self.device)
            _, ids = device_block_query(self.metric, fb, qt, k, n_probe)
            out_ids[i:j], out_d[i:j] = self._refine(q[i:j],
                                                    ids.cpu().numpy(), k)
        return out_ids, out_d

    def _refine(self, q: np.ndarray, ids: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Recompute returned distances with the direct formula and re-sort:
        float64 on the host while the corpus mirror is affordable,
        direct-f32 on the device beyond."""
        if self._mirrorable():
            idc = np.clip(ids, 0, self._state.capacity - 1)
            return refine_pairs(self.metric, q, ids, self._host_vecs()[idc],
                                k)
        return refine_on_device(self.metric, self._state.vectors, q, ids, k)

    def knn_query(self, queries, k: int, filter_fnc=None, layer: int = 0,
                  exact: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Batched k-NN at ``layer`` (HNSWIndex.cs:107-137).  Returns
        (ids (n, k) int32, dists (n, k) float32), -1/NaN padded.
        ``exact=True`` scans the whole corpus (ops/bruteforce.exact_knn2);
        at ``layer > 0`` only rows of level >= layer are candidates."""
        if filter_fnc is not None:
            raise _todo("filtered knn_query", "queue 1 item 9")
        q = _as_2d_f32(queries, self.dim)
        n = q.shape[0]
        if self._count_host <= 0 or k < 1:
            return (np.full((n, k), -1, np.int32),
                    np.full((n, k), np.nan, np.float32))
        if exact:
            return self._exact_query(q, k, layer)
        ef = max(self.params.min_nn, k)          # HNSWIndex.cs:115
        if layer == 0:
            fb = self._get_block_fallback()
            if fb is not None:
                return self._block_fallback_query(fb, q, k)
        ids = self._search_ids(q, ef, layer)
        out_ids = np.empty((n, k), np.int32)
        out_d = np.empty((n, k), np.float32)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            out_ids[i:j], out_d[i:j] = self._refine(q[i:j], ids[i:j], k)
        return out_ids, out_d

    def _search_ids(self, q: np.ndarray, ef: int, layer: int = 0
                    ) -> np.ndarray:
        """Graph search in batches: the pack at layer 0 when there is one,
        the unpacked descent + beam otherwise.  Returns (n, ef) candidate
        ids."""
        expand = max(1, self.params.query_expand)
        max_iters = (self._cfg.search_iter_factor * ef) // expand + 16
        pk = self._get_pack() if layer == 0 else None
        n = q.shape[0]
        out = np.empty((n, ef), np.int32)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            qt = torch.as_tensor(q[i:j]).to(self.device)
            if pk is not None:
                _, ids = PK.packed_knn_search(self._cfg, pk, qt, ef,
                                              max_iters, expand=expand,
                                              n_entry=min(8, ef))
            else:
                _, ids = SR.knn_search(self._cfg, self._state, qt, layer,
                                       ef, max_iters, expand=expand)
            out[i:j] = ids.cpu().numpy()
        return out

    def _exact_query(self, q: np.ndarray, k: int, layer: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Brute-force k-NN over the allowed rows (active, and of level >=
        ``layer``): the two-stage scan over the coarse table at EXACT_LANES
        lanes (reference ``_exact_query``), refined like the graph path."""
        st = self._state
        allowed = st.active
        if layer > 0:
            allowed = allowed & (st.level >= layer)
        ct = st.coarse_table
        n = q.shape[0]
        out_ids = np.empty((n, k), np.int32)
        out_d = np.empty((n, k), np.float32)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            qt = torch.as_tensor(q[i:j]).to(self.device)
            if ct is not None:
                _, ids = BF.exact_knn2(self.metric, st.vectors, ct, st.norms,
                                       allowed, qt, k, lanes=EXACT_LANES)
            else:
                _, ids = BF.exact_knn(self.metric, st.vectors, st.norms,
                                      allowed, qt, k)
            out_ids[i:j], out_d[i:j] = self._refine(q[i:j],
                                                    ids.cpu().numpy(), k)
        return out_ids, out_d

    def range_query(self, queries, radius: float, filter_fnc=None,
                    layer: int = 0) -> Tuple[List[np.ndarray],
                                             List[np.ndarray]]:
        """Batched radius search (HNSWIndex.cs:144-168).  Returns ragged
        per-query (ids, dists) lists, ascending by distance.

        One exact count of in-radius rows (ops/bruteforce.range_count)
        sizes each batch's result pool from RANGE_POOLS; queries whose
        count (plus the RANGE_SEED_EF seeds) reaches the top pool, and
        queries still saturated at it, are answered by an exact scan."""
        if filter_fnc is not None:
            raise _todo("filtered range_query", "queue 1 item 9")
        q = _as_2d_f32(queries, self.dim)
        n = q.shape[0]
        if self._count_host <= 0:
            return ([np.empty(0, np.int32) for _ in range(n)],
                    [np.empty(0, np.float32) for _ in range(n)])
        st = self._state
        r32 = float(np.float32(radius))
        counts = np.empty(n, np.int64)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            counts[i:j] = BF.range_count(
                self.metric, st.vlo, st.norms, st.active,
                torch.as_tensor(q[i:j]).to(self.device), r32).cpu().numpy()

        ids_out: List[Optional[np.ndarray]] = [None] * n
        d_out: List[Optional[np.ndarray]] = [None] * n
        # the pool holds the in-range rows and the (possibly out-of-range)
        # seeds, which are expanded once to reach disconnected pockets
        is_exact = counts + RANGE_SEED_EF >= RANGE_POOLS[-1]
        for i in np.flatnonzero(is_exact):
            ids_out[i], d_out[i] = self._range_exact_host(q[i], radius)
        graph_rows = np.flatnonzero(~is_exact)
        for i in range(0, graph_rows.size, QUERY_BATCH):
            take = graph_rows[i:i + QUERY_BATCH]
            qt = torch.as_tensor(q[take]).to(self.device)
            need = int(counts[take].max())
            start = next((p for p in RANGE_POOLS
                          if p >= need + RANGE_SEED_EF + 1),
                         RANGE_POOLS[-1])
            for pool in [p for p in RANGE_POOLS if p >= start]:
                _, ids, sat = self._range_once(qt, r32, layer, pool)
                sat_np = sat.cpu().numpy()
                if not sat_np.any():
                    break
            ids_np = ids.cpu().numpy()
            for r, t in enumerate(take):
                if sat_np[r]:
                    ids_out[t], d_out[t] = self._range_exact_host(q[t],
                                                                  radius)
                    continue
                row = ids_np[r]
                row = row[row >= 0]
                rid, rd = self._refine(q[t:t + 1],
                                       row[None, :] if row.size else
                                       np.full((1, 1), -1, np.int32),
                                       max(row.size, 1))
                keep = (rid[0] >= 0) & (rd[0] <= radius)
                ids_out[t], d_out[t] = rid[0][keep], rd[0][keep]
        return ids_out, d_out

    def _range_exact_host(self, q1: np.ndarray, radius: float
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact single-query range scan: float64 against the host mirror
        while it is affordable, the device's blocked float32 scan
        (ops/bruteforce.range_distances) and one (C,) transfer beyond."""
        st = self._state
        if not self._mirrorable():
            d = BF.range_distances(
                self.metric, st.vectors, st.norms, st.active,
                torch.as_tensor(q1).to(self.device),
                float(np.float32(radius))).cpu().numpy()
            hit = np.flatnonzero(np.isfinite(d))
            order = np.argsort(d[hit], kind="stable")
            return (hit[order].astype(np.int32),
                    d[hit][order].astype(np.float32))
        hv = self._host_vecs().astype(np.float64)
        qq = q1.astype(np.float64)
        if self.metric == "sq_euclid":
            d = ((hv - qq) ** 2).sum(1)
        else:
            dot = hv @ qq
            if self.metric == "cosine":
                denom = np.linalg.norm(qq) * np.linalg.norm(hv, axis=1)
                d = np.where(denom > 0, 1.0 - dot / np.where(
                    denom > 0, denom, 1.0), 1.0)
            else:
                d = 1.0 - dot
        d = np.where(st.active.cpu().numpy(), d, np.inf)
        hit = np.flatnonzero(d <= radius)
        order = np.argsort(d[hit], kind="stable")
        return (hit[order].astype(np.int32),
                d[hit][order].astype(np.float32))

    def _range_once(self, qt: torch.Tensor, radius: float, layer: int,
                    pool: int):
        """One graph range pass: seeds from a k-NN beam of width
        RANGE_SEED_EF (in-range pockets not linked to the greedy entry
        through in-range nodes), then ``range_search`` at ``pool``."""
        st = self._state
        qn = dst.norm_data(self.metric, qt)
        _, seeds = SR.knn_search(
            self._cfg, st, qt, layer, RANGE_SEED_EF,
            self._cfg.search_iter_factor * RANGE_SEED_EF + 16)
        ep_ok = (st.ep >= 0).expand(seeds.shape)
        return SR.range_search(self._cfg, st, qt, qn, seeds, ep_ok, layer,
                               radius, pool, pool * 4 + 16)

    def multi_layer_knn_query(self, query, k: int,
                              max_layer: int = 2 ** 30, min_layer: int = 0
                              ) -> List[Optional[Tuple[np.ndarray,
                                                       np.ndarray]]]:
        """Per-layer k-NN chain (MultiLayerKnnQuery, HNSWIndex.cs:173-187):
        descend greedily to ``max_layer``, then search each layer from the
        top with a beam of width ``k``, chain the best refined hit as the
        next layer's entry, and report the other hits of each layer (the
        reference drops the closest, HNSWIndex.cs:184).  Returns a list
        indexed by layer; entries below ``min_layer`` are None."""
        if self._count_host <= 0 or k < 1:
            return []
        q = _as_2d_f32(query, self.dim)[:1]
        st = self._state
        dev = self.device
        qt = torch.as_tensor(q).to(dev)
        qn = dst.norm_data(self.metric, qt)
        ep = int(st.ep)
        ep_level = int(st.level[ep])
        if ep_level >= max_layer:
            entry, _ = SR.greedy_descent(
                self._cfg, st, qt, qn, torch.tensor([ep], device=dev),
                torch.tensor([ep_level], device=dev),
                torch.tensor([max_layer], device=dev))
            ep = int(entry[0])
            ep_level = max_layer if ep_level > max_layer else ep_level
        top = min(ep_level, max_layer)
        result: List[Optional[Tuple[np.ndarray, np.ndarray]]] = \
            [None] * (top + 1)
        max_iters = self._cfg.search_iter_factor * k + 16
        ok = torch.ones((1,), dtype=torch.bool, device=dev)
        for layer in range(top, min_layer - 1, -1):
            _, ids = SR.beam_search(self._cfg, st, qt, qn,
                                    torch.tensor([ep], device=dev), ok,
                                    layer, k, max_iters)
            rid, rd = self._refine(q, ids.cpu().numpy(), k)
            valid = rid[0] >= 0
            ep = int(rid[0][0]) if valid.any() else ep
            result[layer] = (rid[0][valid][1:], rd[0][valid][1:])
        return result

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def ids(self) -> np.ndarray:
        """Active ids (HNSWIndex.cs:242-245)."""
        return np.flatnonzero(self._state.active.cpu().numpy()).astype(
            np.int32)

    def items(self) -> np.ndarray:
        """Active stored vectors (HNSWIndex.cs:234-237)."""
        ids = torch.as_tensor(self.ids().astype(np.int64)).to(self.device)
        return self._state.vectors[ids].cpu().numpy()

    @property
    def count(self) -> int:
        """Number of active items (HNSWIndex.cs:250)."""
        return self._count_host

    # ------------------------------------------------------------------
    # outside the slice
    # ------------------------------------------------------------------

    def remove(self, ids) -> None:
        raise _todo("remove", "queue 1 item 10")

    def update(self, ids, vecs) -> None:
        raise _todo("update", "queue 1 item 9")

    def get_info(self):
        raise _todo("get_info", "queue 1 item 11")

    def get_connected_component_counts(self):
        raise _todo("get_connected_component_counts", "queue 1 item 11")

    def serialize(self, path: str) -> None:
        raise _todo("serialize", "queue 1 item 11")

    @classmethod
    def deserialize(cls, path: str) -> "HNSWIndex":
        raise _todo("deserialize", "queue 1 item 11")
