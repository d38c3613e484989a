"""`HNSWIndex` — the index facade, main-path slice.

Counterpart of ``hnswindex_tpu/index.py``: ``add`` builds with
wave-batched exact-candidate inserts (core/construct.py) and ``knn_query``
serves unfiltered layer-0 k-NN through the packed engine (core/pack.py),
or, when the pack does not fit ``pack_max_bytes``, through block tables
built on the device (block.py, the at-scale fallback), then refines the
returned pairs in full precision.

The device owns the graph state; the host owns slot allocation, level
sampling (numpy RNG, seeded exactly like the reference), capacity growth
and the wave schedule.  Everything outside the slice raises
``NotImplementedError`` naming the ROADMAP item that ports it.
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
#: queries per packed-search launch
QUERY_BATCH = 1024
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
        if self._count_host + n > self.params.exact_build_threshold:
            raise _todo("building past exact_build_threshold (the beam "
                        "path)", "queue 1 item 8")
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
        """One wave: store, connect upper members, connect layer 0."""
        cfg, st = self._cfg, self._state
        CS.scatter_wave(cfg, st, wid, wvec, wlvl)
        if up.size:
            upt = torch.as_tensor(up).to(self.device)
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
        """The packed-neighbourhood tables, built on first use.  None when
        the pack does not fit ``pack_max_bytes`` (``_pack_refusal`` is then
        "budget", which the block fallback gates on)."""
        p = self.params
        if p.pack_queries == "off" or (p.pack_queries == "auto"
                                       and self._count_host
                                       < p.pack_min_count):
            raise _todo("layer-0 search without the query pack (the "
                        "unpacked beam; use pack_queries='on' below "
                        "pack_min_count)", "queue 1 item 8")
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
        """Batched layer-0 k-NN (HNSWIndex.cs:107-137).  Returns
        (ids (n, k) int32, dists (n, k) float32), -1/NaN padded."""
        if filter_fnc is not None:
            raise _todo("filtered knn_query", "queue 1 item 9")
        if layer != 0:
            raise _todo("knn_query at layer > 0", "queue 1 item 8")
        if exact:
            raise _todo("knn_query(exact=True)", "queue 1 item 9")
        q = _as_2d_f32(queries, self.dim)
        n = q.shape[0]
        if self._count_host <= 0 or k < 1:
            return (np.full((n, k), -1, np.int32),
                    np.full((n, k), np.nan, np.float32))
        ef = max(self.params.min_nn, k)          # HNSWIndex.cs:115
        fb = self._get_block_fallback()
        if fb is not None:
            return self._block_fallback_query(fb, q, k)
        ids = self._search_ids(q, ef)
        out_ids = np.empty((n, k), np.int32)
        out_d = np.empty((n, k), np.float32)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            out_ids[i:j], out_d[i:j] = self._refine(q[i:j], ids[i:j], k)
        return out_ids, out_d

    def _search_ids(self, q: np.ndarray, ef: int) -> np.ndarray:
        """Packed layer-0 search in batches; returns (n, ef) candidate ids."""
        expand = max(1, self.params.query_expand)
        max_iters = (self._cfg.search_iter_factor * ef) // expand + 16
        pk = self._get_pack()
        if pk is None:
            raise _todo("layer-0 search past pack_max_bytes without the "
                        "block fallback (the unpacked beam; the fallback "
                        "needs block_fallback='auto' and count >= "
                        "pack_min_count)", "queue 1 item 8")
        n = q.shape[0]
        out = np.empty((n, ef), np.int32)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            qt = torch.as_tensor(q[i:j]).to(self.device)
            _, ids = PK.packed_knn_search(self._cfg, pk, qt, ef, max_iters,
                                          expand=expand,
                                          n_entry=min(8, ef))
            out[i:j] = ids.cpu().numpy()
        return out

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

    def range_query(self, queries, radius: float, filter_fnc=None,
                    layer: int = 0) -> Tuple[List[np.ndarray],
                                             List[np.ndarray]]:
        raise _todo("range_query", "queue 1 item 9")

    def multi_layer_knn_query(self, query, k: int,
                              max_layer: int = 2 ** 30, min_layer: int = 0):
        raise _todo("multi_layer_knn_query", "queue 1 item 9")

    def get_info(self):
        raise _todo("get_info", "queue 1 item 11")

    def get_connected_component_counts(self):
        raise _todo("get_connected_component_counts", "queue 1 item 11")

    def serialize(self, path: str) -> None:
        raise _todo("serialize", "queue 1 item 11")

    @classmethod
    def deserialize(cls, path: str) -> "HNSWIndex":
        raise _todo("deserialize", "queue 1 item 11")
