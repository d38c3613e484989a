"""``ShardedIndex`` — a corpus sharded by row over several torch devices.

Counterpart of ``hnswindex_tpu/parallel/sharded.py``, with the same public
methods and host mirrors:

* each shard is an independent HNSW graph (a ``GraphState`` on its own
  device) over its rows; there are no cross-shard edges, so construction
  needs no communication;
* global ids interleave: ``gid = slot * S + shard``.  Round-robin inserts
  keep ids dense from 0, and the mapping does not depend on capacity, so
  growing every shard (doubling, as the reference's arrays do) keeps every
  id ever returned;
* inserts are assigned round-robin, starting from the least-filled shard,
  and drained in waves: each wave takes up to ``max_wave_size // S`` rows
  of every shard's queue and runs the port's wave code
  (``index.insert_wave``) on each shard;
* a query batch goes to every shard; each returns its candidates with
  their ranking distances, the lists move to the first device, where one
  stable sort merges them (the reference's all-gather over ICI), and the
  merged ids are refined in full precision.

A device may repeat: ``devices=["cuda:0", "cuda:0"]`` holds two shards on
one card.  ``devices=None`` takes every visible CUDA device and raises
without one; the CPU runs only when the caller names it.

The wave schedule is the reference's and fixes the graph: levels are drawn
for the whole batch first; a shard's wave is ``min(max_wave_size // S,
max(1, built), remaining)`` rows, cut at 512 level>=1 members; the
two-stage scan gate (``full``) is one flag for all shards (the widest
shard wave reaches the full bucket); every shard leaves the exact path on
the same wave (decided on the largest shard); the scan prefix is the
high-water mark shared by all shards.  Not ported: the reference's upload
slabs (``max(512, 2^29 / (S * D * 4))`` rows a shard), which served the TPU
upload and never cut a wave at the sizes this port runs, and its
device-side wave cursors.  The shared high-water mark advances on every
wave (the reference advances it on exact-path waves only, so a removal
after beam-path waves scanned a stale prefix).

Removal resolves its quality once, on the whole batch against the whole
live count, then repairs each shard with ``core/remove.remove_from_state``
(the reference's phase order: mark, affected rows, then candidates and
repair per layer from the top) over the shared scan prefix.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import graph as G
from ..core import pack as PK
from ..core import remove as RM
from ..core import search as SR
from ..core import stats as ST
from ..core.snapshot import npz_path
from ..index import (EXACT_LANES, MAX_UPPER, RANGE_POOLS, WAVE_BUCKETS,
                     _alloc_capacity, _as_2d_f32, _bucket, _check_full_f32,
                     _next_pow2, callable_knn, insert_wave, range_pass,
                     resolve_pack_dtype, resolve_rank_dtype)
from ..ops import bruteforce as BF
from ..ops import distance as dst
from ..params import HNSWParameters
from ..utils.profiling import PhaseTimer
from ..utils.refine import QUERY_BATCH, HostMirror

#: floor of the per-shard upper-panel width (the reference's)
_SPANEL_MIN = 1024


def resolve_devices(devices) -> List[torch.device]:
    """Shard devices: the given sequence (repeats allowed; a CUDA device
    without an index is the current one), or every visible CUDA device;
    without a CUDA device ``None`` raises instead of falling back to the
    CPU."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "no CUDA device: pass devices=['cpu', ...] to shard on the "
                "CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("devices must name at least one device")
    for d in set(out):
        _check_full_f32(d)
    return out


def merge_sorted(parts, width: int, n_shards: int, device) -> np.ndarray:
    """All-shard merge: ``parts[s] = (dists (B, w), local ids (B, w))`` of
    shard s, local ids become gids, the lists are concatenated in shard
    order on ``device`` and a stable sort keeps the ``width`` nearest.
    Returns (B, width) int64 gids on the host, -1 padded."""
    dd, ii = [], []
    for s, (d, i) in enumerate(parts):
        i = i.long()
        dd.append(d.float().to(device))
        ii.append(torch.where(i >= 0, i * n_shards + s, -1).to(device))
    dd = torch.cat(dd, dim=1)
    ii = torch.cat(ii, dim=1)
    order = torch.argsort(dd, dim=1, stable=True)[:, :width]
    out = torch.gather(ii, 1, order).cpu().numpy()
    if out.shape[1] < width:
        out = np.pad(out, ((0, 0), (0, width - out.shape[1])),
                     constant_values=-1)
    return out


class ShardedIndex:
    """Corpus sharded across ``devices`` (see module docstring)."""

    def __init__(self, dim: int, metric: str = "sq_euclid",
                 parameters: Optional[HNSWParameters] = None,
                 devices: Optional[Sequence] = None):
        dst.check_metric(metric)
        p = parameters or HNSWParameters()
        p.validate()
        self.dim = int(dim)
        self.metric = metric
        self.params = p
        self.devices = resolve_devices(devices)
        S = self.n_shards = len(self.devices)
        local_cap = _alloc_capacity(max(2, -(-p.collection_size // S)))
        self.shard_capacity = local_cap
        self._cfg = G.GraphConfig(
            dim=self.dim, metric=metric, max_edges=p.max_edges,
            max_levels=G.default_max_levels(local_cap, p.distribution_rate),
            ef_construction=p.max_candidates,
            search_iter_factor=p.search_iter_factor,
            build_expand=p.build_expand,
            rank_dtype=resolve_rank_dtype(p.rank_dtype),
            slack0=min(p.reverse_slack, p.max_edges // 2))
        self._states = [G.empty_state(self._cfg, local_cap, d)
                        for d in self.devices]
        seed = p.random_seed if p.random_seed >= 0 else None
        self._rng = np.random.default_rng(seed)
        self._lengths = np.zeros(S, dtype=np.int64)  # slot high-water marks
        self._counts = np.zeros(S, dtype=np.int64)   # live rows a shard
        self._free: List[List[int]] = [[] for _ in range(S)]
        self._seeded = np.zeros(S, dtype=bool)
        self._mirror = HostMirror(metric, self._vector_tables)
        self._pack = None               # per-shard QueryPacks
        #: per shard, the live level>=1 slots (the exact path's upper panel)
        self._upper_set: List[set] = [set() for _ in range(S)]
        self._shwm = 0                  # shared scan prefix (slot mark)
        self._wave_trace: Optional[list] = None   # test hook: wave widths
        self._rm_trace: Optional[list] = None     # test hook: removals
        #: per-shard phase times (scan, prune, reverse, upper, remove, ...)
        self.timers = [PhaseTimer(d) for d in self.devices]
        #: sharded waves run on each build path
        self.wave_counts = {"exact": 0, "beam": 0}

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _vector_tables(self) -> List[torch.Tensor]:
        # a bound method, so that a deep copy's mirror reads the copy
        return [st.vectors for st in self._states]

    def _invalidate_caches(self) -> None:
        self._mirror.clear()
        self._pack = None

    def _global_filter_mask(self, filter_fnc) -> Optional[List[torch.Tensor]]:
        """Per-shard (C,) bool masks from gids or an (S*C,) bool mask
        (callables never come here: they are judged on candidates only).
        A bool mask of another length is refused, not read as ids."""
        if filter_fnc is None:
            return None
        S, C = self.n_shards, self.shard_capacity
        arr = np.asarray(filter_fnc)
        if arr.dtype == bool and arr.shape != (S * C,):
            raise ValueError(
                f"bool filter mask must have shape ({S * C},) — the "
                f"current total capacity — got {arr.shape}; pass ids "
                "for a sparse filter")
        if arr.dtype != bool:
            mask = np.zeros(S * C, dtype=bool)
            mask[np.asarray(filter_fnc, dtype=np.int64)] = True
            arr = mask
        # gid = slot * S + shard: a (C, S) view puts shard s in column s
        view = arr.reshape(C, S)
        return [torch.as_tensor(np.ascontiguousarray(view[:, s])).to(d)
                for s, d in enumerate(self.devices)]

    def _ep_tops(self) -> List[int]:
        """Each shard's entry-point level (-1 for an empty shard)."""
        tops = []
        for st in self._states:
            ep = int(st.ep)
            tops.append(int(st.level[ep]) if ep >= 0 else -1)
        return tops

    def _grow_shards(self, new_local_cap: int) -> None:
        """Grow every shard to ``new_local_cap`` rows (the reference's
        doubling, GraphData.cs:95-115).  Gids do not depend on capacity, so
        every id ever returned stays valid."""
        if new_local_cap <= self.shard_capacity:
            return
        self._states = [G.grow_state(st, new_local_cap)
                        for st in self._states]
        self.shard_capacity = new_local_cap
        self._invalidate_caches()

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def add(self, vecs) -> np.ndarray:
        """Round-robin shard assignment and per-shard insert waves.
        Returns int32 gids."""
        a = _as_2d_f32(vecs, self.dim)
        n = a.shape[0]
        if n == 0:
            return np.empty(0, np.int32)
        self._invalidate_caches()
        S = self.n_shards
        C = self.shard_capacity
        lvls_all = G.sample_levels(self._rng, n, self.params.distribution_rate,
                                   self._cfg.max_levels)
        # round-robin assignment, starting from the least-filled shard
        order = np.argsort(self._counts, kind="stable")
        shard_of = order[np.arange(n) % S]
        # grow every shard before allocating slots; the demand per shard is
        # known up front
        demand = np.bincount(shard_of, minlength=S)
        if self.params.allow_removals:
            demand = demand - np.minimum(
                demand, np.asarray([len(f) for f in self._free]))
        need = int((self._lengths + demand).max())
        if need > C:
            newC = C
            while newC < need:
                newC *= 2                  # GraphData.cs:100
            self._grow_shards(newC)
        # freed slots first, last freed first (GraphData.cs:85-91), then
        # fresh ones
        slots = np.empty(n, dtype=np.int64)
        for s in range(S):
            mine = np.flatnonzero(shard_of == s)
            m = mine.size
            reuse = 0
            if self.params.allow_removals and self._free[s]:
                reuse = min(m, len(self._free[s]))
                slots[mine[:reuse]] = self._free[s][-reuse:][::-1]
                del self._free[s][-reuse:]
            fresh = m - reuse
            slots[mine[reuse:]] = self._lengths[s] + np.arange(fresh)
            self._lengths[s] += fresh
            self._counts[s] += m
        gids = (slots * S + shard_of).astype(np.int32)

        # an unseeded shard takes its first item as its entry point
        shard_of = shard_of.copy()
        for s in range(S):
            if self._seeded[s]:
                continue
            mine = np.flatnonzero(shard_of == s)
            if mine.size == 0:
                continue
            j = mine[0]
            self._seed(s, int(slots[j]), a[j], int(lvls_all[j]))
            shard_of[j] = -1               # consumed
        queues = [np.flatnonzero(shard_of == s) for s in range(S)]
        self._drain_waves(queues, slots, a, lvls_all)
        return gids

    def _seed(self, s: int, slot: int, vec: np.ndarray, lvl: int) -> None:
        G.seed_first_node(self._cfg, self._states[s], slot, vec, lvl)
        self._seeded[s] = True
        if lvl >= 1:
            self._upper_set[s].add(slot)

    def _panels(self) -> List[torch.Tensor]:
        """Per-shard upper-node panels: the live level>=1 slots, -1 padded
        to a common power-of-2 width of at least 1,024; rows not inserted
        yet or removed are masked on the device through ``active``."""
        width = max(_SPANEL_MIN, _next_pow2(
            max(1, max(len(u) for u in self._upper_set))))
        out = []
        for ups, d in zip(self._upper_set, self.devices):
            arr = np.full(width, -1, np.int32)
            if ups:
                arr[:len(ups)] = np.fromiter(ups, np.int32, len(ups))
            out.append(torch.as_tensor(arr).to(d))
        return out

    def _drain_waves(self, queues, slot_of, vecs, lvls) -> None:
        """Insert every shard's queue (``queues[s]`` indexes ``slot_of``,
        ``vecs`` and ``lvls``) in waves under the schedule of the module
        docstring: a shard of b rows takes at most b more in a wave, so
        early waves stay small and the graph quality holds."""
        S = self.n_shards
        queues = [np.asarray(q, dtype=np.int64) for q in queues]
        nq = np.array([q.size for q in queues], dtype=np.int64)
        if nq.sum() == 0:
            return
        exactable = not dst.is_custom(self.metric)
        panels = [None] * S
        if exactable:
            for s in range(S):
                ups = slot_of[queues[s]][lvls[queues[s]] >= 1]
                self._upper_set[s].update(int(x) for x in ups)
            panels = self._panels()
        mw = min(max(1, self.params.max_wave_size // S), WAVE_BUCKETS[-1])
        thresh = self.params.exact_build_threshold
        built = self._counts - nq          # live rows a shard before the waves
        # each shard's queue crosses to its device once
        dev_q = []
        for s, d in enumerate(self.devices):
            q = queues[s]
            dev_q.append((torch.as_tensor(slot_of[q]).to(d),
                          torch.as_tensor(vecs[q]).to(d),
                          torch.as_tensor(lvls[q].astype(np.int64)).to(d)))
        k = np.zeros(S, dtype=np.int64)
        srem = nq.copy()
        while srem.any():
            w = np.minimum(np.minimum(mw, np.maximum(1, built)), srem)
            for s in range(S):
                if w[s] == 0:
                    continue
                upc = np.cumsum(lvls[queues[s][k[s]:k[s] + w[s]]] >= 1)
                if w[s] > MAX_UPPER and upc[-1] > MAX_UPPER:
                    w[s] = int(np.searchsorted(upc, MAX_UPPER, side="right"))
            full = _bucket(int(w.max()), WAVE_BUCKETS) >= mw
            exact = exactable and int(built.max()) <= thresh
            self._shwm = max(self._shwm, max(
                int(slot_of[queues[s][k[s]:k[s] + w[s]]].max()) + 1
                for s in range(S) if w[s]))
            if self._wave_trace is not None:
                self._wave_trace.append(w.copy())
            self.wave_counts["exact" if exact else "beam"] += 1
            for s in range(S):
                if w[s] == 0:
                    continue
                sl = slice(int(k[s]), int(k[s] + w[s]))
                wl = lvls[queues[s][sl]]
                up = np.flatnonzero(wl >= 1)
                wid, wvec, wlvl = (t[sl] for t in dev_q[s])
                insert_wave(self._cfg, self._states[s], wid, wvec, wlvl, up,
                            int(wl.max()) if up.size else 0, exact=exact,
                            scan_hwm=self._shwm, full=full, panel=panels[s],
                            timer=self.timers[s])
            built += w
            srem -= w
            k += w

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _get_pack(self):
        """Per-shard packed-neighbourhood tables, built on first use, or
        None ("serve unpacked").  ``pack_max_bytes`` is a budget per shard,
        and each shard's entry set is its lowest upper level whose
        population fits the entry scan (a shard with none takes one live
        row; an empty shard's entries are all -1)."""
        p = self.params
        if p.pack_queries == "off":
            return None
        if p.pack_queries == "auto" and self.count < p.pack_min_count:
            return None
        if self._pack is not None:
            return self._pack
        C = self.shard_capacity
        K = min(self._states[0].nbr0.shape[1], 2 * p.max_edges)
        res_dtype = resolve_pack_dtype(p, C, K, self.dim)
        if res_dtype is None:
            return None
        cap = PK.entry_scan_cap(self.metric)
        ents = []
        for st in self._states:
            lvl = st.level.cpu().numpy()
            act = st.active.cpu().numpy()
            eids = None
            for layer in range(1, int(self._cfg.max_levels)):
                members = np.flatnonzero((lvl >= layer) & act)
                if members.size <= cap:
                    eids = members
                    break
            if eids is None or eids.size == 0:
                eids = np.flatnonzero(act)[:1]
            ents.append(eids)
        E = _next_pow2(max(1, max(e.size for e in ents)))
        packs = []
        for st, e in zip(self._states, ents):
            table = np.full(E, -1, np.int32)
            table[:e.size] = e
            packs.append(PK.make_query_pack(
                self._cfg, st, torch.as_tensor(table).to(st.device),
                res_dtype))
        self._pack = packs
        return packs

    def _search_ids(self, q: np.ndarray, ef: int, layer: int = 0,
                    fmask: Optional[List[torch.Tensor]] = None
                    ) -> np.ndarray:
        """(n, ef) merged gids of the per-shard graph searches: the packs
        at layer 0 when there are some, the unpacked descent + beam
        otherwise; with ``fmask`` each shard's pool of allowed rows."""
        expand = max(1, self.params.query_expand)
        max_iters = (self._cfg.search_iter_factor * ef) // expand + 16
        pks = self._get_pack() if layer == 0 else None
        n = q.shape[0]
        out = np.empty((n, ef), np.int64)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            parts = []
            for s, st in enumerate(self._states):
                qt = torch.as_tensor(q[i:j]).to(st.device)
                fm = None if fmask is None else fmask[s]
                if pks is not None:
                    parts.append(PK.packed_knn_search(
                        self._cfg, pks[s], qt, ef, max_iters,
                        filtered=fm is not None, filter_mask=fm,
                        expand=expand, n_entry=min(8, ef)))
                else:
                    parts.append(SR.knn_search(
                        self._cfg, st, qt, layer, ef, max_iters,
                        filtered=fm is not None, filter_mask=fm,
                        expand=expand))
            out[i:j] = merge_sorted(parts, ef, self.n_shards,
                                    self.devices[0])
        return out

    def _exact_nscan(self) -> int:
        """Power-of-2 scan prefix (from 8,192) covering every shard's
        filled slots, capped at the capacity."""
        p = 8192
        while p < int(self._lengths.max()):
            p <<= 1
        return min(p, self.shard_capacity)

    def _exact_ids(self, q: np.ndarray, k: int, layer: int,
                   fmask: Optional[List[torch.Tensor]],
                   scan2_max: Optional[int] = None) -> np.ndarray:
        """(n, k) merged gids of each shard's brute-force top-k over its
        allowed rows (active, of level >= ``layer``, in ``fmask``) in the
        shared scan prefix: the two-stage scan at EXACT_LANES lanes (K1)
        while there is a coarse table (and ``k <= scan2_max``), the blocked
        float32 scan otherwise."""
        ns = self._exact_nscan()
        allowed = []
        for s, st in enumerate(self._states):
            a = (st.active & (st.level >= layer))[:ns]
            if fmask is not None:
                a = a & fmask[s][:ns]
            allowed.append(a)
        n = q.shape[0]
        out = np.empty((n, k), np.int64)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            parts = []
            for s, st in enumerate(self._states):
                qt = torch.as_tensor(q[i:j]).to(st.device)
                ct = st.coarse_table
                if ct is not None and (scan2_max is None or k <= scan2_max):
                    parts.append(BF.exact_knn2(
                        self.metric, st.vectors, ct[:ns], st.norms[:ns],
                        allowed[s], qt, k, lanes=EXACT_LANES))
                else:
                    parts.append(BF.exact_knn(
                        self.metric, st.vlo[:ns], st.norms[:ns], allowed[s],
                        qt, k))
            out[i:j] = merge_sorted(parts, k, self.n_shards, self.devices[0])
        return out

    def knn_query(self, queries, k: int, filter_fnc=None, layer: int = 0,
                  exact: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Fan-out batched k-NN: per-shard searches (or per-shard exact
        scans with ``exact=True``), a global merge and a full-precision
        refine.  Returns (ids (n, k) int32, dists (n, k) float32), -1/NaN
        padded.  ``filter_fnc`` is a gid list, an (S*C,) bool mask or a
        callable on a stored vector."""
        q = _as_2d_f32(queries, self.dim)
        n = q.shape[0]
        if self.count == 0 or k < 1:
            return (np.full((n, k), -1, np.int32),
                    np.full((n, k), np.nan, np.float32))
        if exact and dst.is_custom(self.metric):
            raise ValueError(
                "exact=True requires a dot-decomposable built-in metric; "
                f"custom metric {self.metric!r} is served by the graph path")
        if callable(filter_fnc):
            return self._knn_query_callable(q, k, filter_fnc, int(layer),
                                            exact)
        fmask = self._global_filter_mask(filter_fnc)
        if exact:
            ids = self._exact_ids(q, k, int(layer), fmask)
        else:
            ids = self._search_ids(q, max(self.params.min_nn, k), int(layer),
                                   fmask)
        return self._mirror.refine_batched(q, ids, k)

    def _knn_query_callable(self, q: np.ndarray, k: int, pred, layer: int,
                            exact: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Callable filters (``index.callable_knn``) over the gids: merged
        beams or exact scans of every shard, rows and refine by gid."""
        return callable_knn(
            q, k, pred, exact=exact, custom=dst.is_custom(self.metric),
            min_nn=self.params.min_nn, count=self.count,
            id_space=self.n_shards * self.shard_capacity,
            search=lambda sub, ef: self._search_ids(sub, ef, layer),
            exact_scan=lambda sub, kk: self._exact_ids(
                sub, kk, layer, None, scan2_max=256),
            rows=self._mirror.rows, refine=self._mirror.refine)

    def range_query(self, queries, radius: float, filter_fnc=None,
                    layer: int = 0) -> Tuple[List[np.ndarray],
                                             List[np.ndarray]]:
        """Batched radius search over every shard (HNSWIndex.cs:144-168):
        per-shard range passes whose pool climbs RANGE_POOLS while any
        (shard, query) pair is saturated, an exact scan of the shards
        still saturated at the top pool, a global merge and a refine.
        Returns ragged (ids, dists) lists, ascending by distance."""
        q = _as_2d_f32(queries, self.dim)
        n = q.shape[0]
        if self.count == 0:
            return ([np.empty(0, np.int32) for _ in range(n)],
                    [np.empty(0, np.float32) for _ in range(n)])
        pred = filter_fnc if callable(filter_fnc) else None
        fmask = None if pred else self._global_filter_mask(filter_fnc)
        r32 = float(np.float32(radius))
        S = self.n_shards
        ids_out: List[np.ndarray] = []
        d_out: List[np.ndarray] = []
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            qts = [torch.as_tensor(q[i:j]).to(d) for d in self.devices]
            for pool in RANGE_POOLS:
                res = [range_pass(self._cfg, self.metric, st, qts[s], r32,
                                  layer, pool,
                                  None if fmask is None else fmask[s])
                       for s, st in enumerate(self._states)]
                sat = np.stack([r[2].cpu().numpy() for r in res])  # (S, B)
                if not sat.any():
                    break
            gi = np.concatenate(
                [np.where(r[1].cpu().numpy() >= 0,
                          r[1].cpu().numpy() * S + s, -1)
                 for s, r in enumerate(res)], axis=1)
            for r in range(j - i):
                qi = i + r
                row = gi[r][gi[r] >= 0]
                if sat[:, r].any():
                    extra = [row] + [
                        self._range_exact_shard(int(s), q[qi], radius,
                                                fmask, layer)
                        for s in np.flatnonzero(sat[:, r])]
                    row = np.unique(np.concatenate(extra))
                if row.size == 0:
                    ids_out.append(np.empty(0, np.int32))
                    d_out.append(np.empty(0, np.float32))
                    continue
                rid, rd = self._mirror.refine(q[qi:qi + 1], row[None, :],
                                              row.size)
                keep = (rid[0] >= 0) & (rd[0] <= radius)
                if pred is not None:
                    rows_v = self._mirror.rows(rid[0])
                    keep &= np.asarray([bool(pred(v)) for v in rows_v],
                                       dtype=bool)
                ids_out.append(rid[0][keep])
                d_out.append(rd[0][keep])
        return ids_out, d_out

    def _range_exact_shard(self, s: int, q1: np.ndarray, radius: float,
                           fmask, layer: int) -> np.ndarray:
        """Exact in-range gids of one shard for one query (the overflow
        path for radii denser than the top pool)."""
        st = self._states[s]
        allowed = st.active
        if layer > 0:
            allowed = allowed & (st.level >= layer)
        if fmask is not None:
            allowed = allowed & fmask[s]
        qt = torch.as_tensor(q1).to(st.device)
        if dst.is_custom(self.metric):
            d = torch.cat([
                dst.exact(self.metric, qt[None],
                          st.vectors[c0:c0 + (1 << 16)]).float()
                for c0 in range(0, st.capacity, 1 << 16)])
            d = np.where(allowed.cpu().numpy(),
                         d.cpu().numpy().astype(np.float64), np.inf)
            hit = np.flatnonzero(d <= radius)
        else:
            d = BF.range_distances(self.metric, st.vectors, st.norms,
                                   allowed, qt, float(np.float32(radius)))
            hit = np.flatnonzero(np.isfinite(d.cpu().numpy()))
        return (hit * self.n_shards + s).astype(np.int64)

    def multi_layer_knn_query(self, query, k: int,
                              max_layer: int = 2 ** 30, min_layer: int = 0):
        """Per-layer k-NN chain (MultiLayerKnnQuery, HNSWIndex.cs:173-187)
        over every shard: each shard beams each layer from its own entry
        and chains its own best hit down; the shards' hits merge per layer,
        dropping the closest (HNSWIndex.cs:184)."""
        if self.count == 0 or k < 1:
            return []
        q = _as_2d_f32(query, self.dim)[:1]
        S = self.n_shards
        eps = [int(st.ep) for st in self._states]
        tops = self._ep_tops()
        top = int(min(max(tops), max_layer))
        if top < 0:
            return []
        result = [None] * (top + 1)
        max_iters = self._cfg.search_iter_factor * k + 16
        entry = list(eps)
        for layer in range(top, min_layer - 1, -1):
            parts = []
            for s, st in enumerate(self._states):
                dev = st.device
                qt = torch.as_tensor(q).to(dev)
                on = tops[s] >= layer and eps[s] >= 0
                parts.append(SR.beam_search(
                    self._cfg, st, qt, dst.norm_data(self.metric, qt),
                    torch.tensor([entry[s]], device=dev),
                    torch.tensor([on], device=dev), layer, k, max_iters))
            gi = np.concatenate(
                [np.where(i.cpu().numpy() >= 0, i.cpu().numpy() * S + s, -1)
                 for s, (_, i) in enumerate(parts)], axis=1)
            rid, rd = self._mirror.refine(q, gi, k)
            valid = rid[0] >= 0
            result[layer] = (rid[0][valid][1:], rd[0][valid][1:])
            # each shard chains its own best as its next entry
            for s, (_, i) in enumerate(parts):
                best = int(i[0, 0])
                if best >= 0:
                    entry[s] = best
        return result

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def remove(self, gids) -> None:
        """Remove by gid with graph repair and slot recycling (freed slots
        are handed out again by ``add``).  Out-of-range and inactive gids
        are ignored."""
        if not self.params.allow_removals:
            raise RuntimeError("Removals are disabled in this index "
                               "instance.")
        S, C = self.n_shards, self.shard_capacity
        arr = np.unique(np.asarray(gids, dtype=np.int64).ravel())
        arr = arr[(arr >= 0) & (arr < S * C)]
        if arr.size == 0:
            return
        self._invalidate_caches()
        # bulk/churn escalation decided once on the whole batch against the
        # whole live count
        quality = RM.resolve_quality(self.params.remove_quality, arr.size,
                                     int(self._counts.sum()))
        mine_s = []
        for s, st in enumerate(self._states):
            mine = arr[arr % S == s] // S
            mine_s.append(mine[st.active.cpu().numpy()[mine]]
                          .astype(np.int32))
        if not any(m.size for m in mine_s):
            return
        self._remove_spmd(mine_s, quality)
        for s in range(S):
            self._free[s].extend(int(x) for x in mine_s[s])
            self._counts[s] -= mine_s[s].size
            self._upper_set[s].difference_update(int(x) for x in mine_s[s])

    def _remove_spmd(self, mine_s, quality: str) -> None:
        """Repair every shard that loses rows: ``remove_from_state`` on its
        local slots, with the batch's quality and the shared scan prefix."""
        for s, mine in enumerate(mine_s):
            if mine.size == 0:
                continue
            if self._rm_trace is not None:
                self._rm_trace.append(("shard", s, int(mine.size), quality))
            timer = self.timers[s]
            with timer.phase("remove"):
                RM.remove_from_state(
                    self._cfg, self._states[s], mine,
                    self.params.remove_max_candidates, scan_hwm=self._shwm,
                    quality=quality, timer=timer)

    def update(self, gids, vecs) -> None:
        """Replace stored vectors keeping their gids: remove, then reinsert
        into the same slots with fresh levels and edges
        (GraphData.UpdateItem, GraphData.cs:133-140)."""
        arr = np.asarray(gids, dtype=np.int64).ravel()
        a = _as_2d_f32(vecs, self.dim)
        if arr.size != a.shape[0]:
            raise ValueError("ids and vectors must have matching length")
        if arr.size == 0:
            return
        if not self.params.allow_removals:
            raise RuntimeError("update requires allow_removals=True")
        if np.unique(arr).size != arr.size:
            raise ValueError("update ids must be unique")
        S, C = self.n_shards, self.shard_capacity
        if ((arr < 0) | (arr >= S * C)).any():
            raise ValueError("update ids must all be active")
        active = np.stack([st.active.cpu().numpy() for st in self._states])
        if not active[arr % S, arr // S].all():
            raise ValueError("update ids must all be active")
        self.remove(arr)
        self._invalidate_caches()
        lvls = G.sample_levels(self._rng, arr.size,
                               self.params.distribution_rate,
                               self._cfg.max_levels)
        shard_of = arr % S
        slot_of = arr // S
        for s in range(S):
            freed = {int(x) for x in slot_of[shard_of == s]}
            self._free[s] = [x for x in self._free[s] if x not in freed]
        queues = [list(np.flatnonzero(shard_of == s)) for s in range(S)]
        for s in range(S):
            self._counts[s] += len(queues[s])
            if queues[s] and not self._seeded[s]:
                j = queues[s].pop(0)
                self._seed(s, int(slot_of[j]), a[j], int(lvls[j]))
        self._drain_waves(queues, slot_of, a, lvls)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def count(self) -> int:
        """Active items over all shards (host mirror)."""
        return int(self._counts.sum())

    def _active_gids(self):
        """(shard, slot) of every active row, ordered by gid."""
        sh, sl = [], []
        for s, st in enumerate(self._states):
            slots = np.flatnonzero(st.active.cpu().numpy())
            sh.append(np.full(slots.size, s, np.int64))
            sl.append(slots.astype(np.int64))
        sh, sl = np.concatenate(sh), np.concatenate(sl)
        order = np.argsort(sl * self.n_shards + sh, kind="stable")
        return sh[order], sl[order]

    def ids(self) -> np.ndarray:
        """Active gids, ascending."""
        sh, sl = self._active_gids()
        return (sl * self.n_shards + sh).astype(np.int32)

    def items(self) -> np.ndarray:
        """Active stored vectors, ordered like ``ids()``, fetched in chunks
        of 65,536 rows (on the devices above the mirror budget)."""
        g = self.ids()
        out = np.empty((g.size, self.dim), np.float32)
        for i in range(0, g.size, 1 << 16):
            out[i:i + (1 << 16)] = self._mirror.rows(g[i:i + (1 << 16)])
        return out

    def get_info(self) -> ST.HNSWInfo:
        """Per-layer degree statistics over the union of the shards'
        graphs (HNSWIndex.cs:192-196); shards are edge-disjoint, so each
        layer's figures come from the shards' degrees side by side."""
        tops = self._ep_tops()
        if max(tops) < 0:
            return ST.HNSWInfo(layers=[])
        layers = []
        for layer in range(max(tops) + 1):
            fig = self._full_readback_layer_stats(layer, tops)
            if fig is not None:
                layers.append(ST.layer_info(layer, fig,
                                            self.params.allow_removals))
        return ST.HNSWInfo(layers=layers)

    def _full_readback_layer_stats(self, layer: int, tops: List[int]):
        """Exact figures of one layer (``stats.degree_figures``) from every
        shard's degrees, gathered on the first device; None when the layer
        is empty."""
        d0 = self.devices[0]
        od, idg = [], []
        for s, st in enumerate(self._states):
            if tops[s] < 0:
                continue
            o, i = ST.layer_degrees(st, layer)
            od.append(o.to(d0))
            idg.append(i.to(d0))
        if not od:
            return None
        return ST.degree_figures(torch.cat(od), torch.cat(idg))

    def get_connected_component_counts(self) -> List[int]:
        """Per-layer weak-component counts: the shards' graphs are
        disjoint, so a layer's count is the sum of theirs (layer 0 has at
        least one component a non-empty shard)."""
        tops = self._ep_tops()
        if max(tops) < 0:
            return []
        bound = ST.components_iter_bound(self.shard_capacity)
        out = []
        for layer in range(max(tops) + 1):
            total = 0
            for st in self._states:
                c, nonempty, _ = ST.components_at_layer(st, layer, bound)
                total += c if nonempty else 0
            out.append(total)
        return out

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def serialize(self, path: str) -> None:
        """Snapshot every shard to one ``.npz`` in the reference's layout
        (each state field stacked on a leading shard axis), so that either
        package reads the other's files."""
        header = {
            "dim": self.dim, "metric": self.metric,
            # gid = slot * S + shard; files without this marker are refused
            "gid_scheme": "interleaved",
            "n_shards": self.n_shards,
            "shard_capacity": self.shard_capacity,
            "max_levels": int(self._cfg.max_levels),
            "parameters": dataclasses.asdict(self.params),
            "lengths": [int(x) for x in self._lengths],
            "counts": [int(x) for x in self._counts],
            "free": [[int(x) for x in f] for f in self._free],
            "seeded": [bool(x) for x in self._seeded],
        }
        arrays = {f.name: np.stack([getattr(st, f.name).cpu().numpy()
                                    for st in self._states])
                  for f in dataclasses.fields(G.GraphState)
                  if f.name not in ("vlo_store", "coarse")}
        np.savez_compressed(
            path,
            header=np.frombuffer(json.dumps(header).encode(), np.uint8),
            **arrays)

    @classmethod
    def deserialize(cls, path: str, devices: Optional[Sequence] = None
                    ) -> "ShardedIndex":
        """Load a snapshot of either package onto ``devices`` (every
        visible CUDA device by default; fewer devices than the snapshot's
        shards raise).  The ranking and coarse mirrors are rebuilt."""
        with np.load(npz_path(path)) as z:
            header = json.loads(bytes(z["header"]).decode())
            arrays = {f: z[f] for f in z.files if f != "header"}
        scheme = header.get("gid_scheme")
        if scheme != "interleaved":
            raise ValueError(
                "snapshot predates the interleaved gid scheme "
                f"(gid_scheme={scheme!r}); its gids (slot-major) would "
                "silently remap under the current slot*S+shard mapping — "
                "rebuild the index or re-serialize with the writing "
                "version")
        devices = resolve_devices(devices)
        S = header["n_shards"]
        if len(devices) < S:
            raise RuntimeError(
                f"snapshot uses {S} shards but only {len(devices)} devices "
                "are available")
        params = HNSWParameters(**header["parameters"])
        idx = cls(header["dim"], header["metric"], params,
                  devices=devices[:S])
        saved_cap = int(header["shard_capacity"])
        if saved_cap < idx.shard_capacity:
            raise ValueError("snapshot shard capacity is below the one its "
                             "collection_size allocates")
        if idx._cfg.max_levels != int(header["max_levels"]):
            raise ValueError("snapshot max_levels mismatch")
        idx.shard_capacity = saved_cap
        states = []
        for s, d in enumerate(idx.devices):
            def t(name):
                return torch.from_numpy(np.array(arrays[name][s])).to(d)
            v = t("vectors")
            states.append(G.GraphState(
                vectors=v, vlo_store=G.make_vlo(idx._cfg.rank_dtype, v),
                coarse=G.make_coarse(idx._cfg, v), norms=t("norms"),
                level=t("level"), nbr0=t("nbr0"), deg0=t("deg0"),
                nbru=t("nbru"), degu=t("degu"), active=t("active"),
                ep=t("ep"), count=t("count")))
        idx._states = states
        idx._lengths = np.asarray(header["lengths"], np.int64)
        counts = header.get("counts")
        if counts is None:
            counts = np.asarray(arrays["count"], np.int64)
        idx._counts = np.asarray(counts, np.int64)
        idx._free = [list(f) for f in header.get(
            "free", [[] for _ in range(S)])]
        idx._seeded = np.asarray(header["seeded"], bool)
        idx._shwm = int(idx._lengths.max()) if S else 0
        live_up = np.asarray(arrays["active"]) & \
            (np.asarray(arrays["level"]) >= 1)
        idx._upper_set = [set(np.flatnonzero(live_up[s]).tolist())
                          for s in range(S)]
        return idx
