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
two-stage brute-force scan (ops/bruteforce.py).  A filter is an id list or
a (C,) bool mask, applied on every path, or a callable evaluated on
candidates only.  Returned pairs are refined in full precision.  ``remove``
repairs the graph (core/remove.py) and frees the slots for reuse;
``update`` is a remove and a reinsert into the same slots.

A metric registered with ``ops.distance.register_metric`` builds every
wave on the beam path and is served by the graph engines only: it has no
exact scan (``exact=True`` raises, a callable filter makes no exact
escalation, range pools climb their whole ladder) and no block fallback.
``get_info`` and ``get_connected_component_counts`` come from
core/stats.py; ``serialize``/``deserialize`` read and write the reference's
``.npz`` (core/snapshot.py), ``to_reference_snapshot``/
``from_reference_snapshot`` the .NET library's protobuf-net stream
(core/refsnap.py), and ``from_host_snapshot`` the native host engine's
file.

The device owns the graph state; the host owns slot allocation and the free
list, level sampling (numpy RNG, seeded exactly like the reference),
capacity growth and the wave schedule.
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
from .core import refsnap as RS
from .core import remove as RM
from .core import search as SR
from .core import snapshot as SN
from .core import stats as ST
from .ops import bruteforce as BF
from .ops import distance as dst
from .params import HNSWParameters
from .utils.profiling import PhaseTimer
from .utils.refine import QUERY_BATCH, HostMirror, direct64, in_batches


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
#: lane count of the exact query's lane-min scan.  At the reference's
#: 1,024 lanes a clustered corpus (clusters of ~500 rows) loses ~1.7% of
#: its true top-10 to a cluster mate that shares the lane and ranks below
#: it on the bf16 products (recall@10 0.983, the reference's exact bar
#: 0.9825); 4,096 lanes hold four times fewer mates a lane (0.996).  The
#: build keeps 1,024, so that both packages build the same graph.
EXACT_LANES = 4096
#: range-search result pool ladder (the reference's)
RANGE_POOLS = (64, 512, 4096)
#: k-NN seeds injected into the range pool (range_pass)
RANGE_SEED_EF = 16
#: floor of the reference's scan-prefix bucket ladder (the scan gate reads
#: it; the port's scan itself covers the exact high-water prefix)
SCAN_FLOOR = 1 << 20
#: minimum capacity of the upper-node panel
_PANEL_MIN_CAP = 1 << 16
#: capacity alignment above which capacity grows in 8192-row steps
_CAP_ALIGN = 8192


def fallback_probes(n_blocks: int) -> int:
    """Blocks the block fallback probes a query: it scales with the table,
    so that the probed share of the corpus (hence recall) holds as blocks
    multiply."""
    return max(8, n_blocks // 1024)


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


def _host_split_tables(st: G.GraphState):
    """Host (nbr0, deg0, nbru, degu) arrays shaped like ``st``'s split
    layer tables, empty (snapshot-import scaffolding)."""
    C = st.capacity
    return (np.full((C, st.nbr0.shape[1]), -1, np.int32),
            np.zeros(C, np.int32),
            np.full(tuple(st.nbru.shape), -1, np.int32),
            np.zeros((st.nbru.shape[0], C), np.int32))


def _write_node_edges(nbr0, deg0, nbru, degu, node: int, per_layer) -> None:
    """Write one node's per-layer edge lists into the split host tables,
    each cut at its layer's table width."""
    for layer, e in enumerate(per_layer):
        if layer == 0:
            e = np.asarray(e, np.int32)[:nbr0.shape[1]]
            nbr0[node, :e.size] = e
            deg0[node] = e.size
        elif layer - 1 < nbru.shape[0]:
            e = np.asarray(e, np.int32)[:nbru.shape[2]]
            nbru[layer - 1, node, :e.size] = e
            degu[layer - 1, node] = e.size


def _read_node_edges(nbr0, deg0, nbru, degu, node: int, top: int):
    """One node's out-edge lists of layers 0..top from the host tables."""
    outs = [nbr0[node, :deg0[node]].astype(np.int32)]
    for layer in range(1, top + 1):
        outs.append(nbru[layer - 1, node, :degu[layer - 1, node]]
                    .astype(np.int32))
    return outs


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


def insert_wave(cfg: G.GraphConfig, st: G.GraphState, wid, wvec, wlvl,
                up: np.ndarray, max_lvl: int, *, exact: bool, scan_hwm: int,
                full: bool, panel: Optional[torch.Tensor], timer) -> None:
    """One wave into ``st``: store, connect upper members (wave positions
    ``up``, top level ``max_lvl``), connect layer 0.  The exact path
    connects the upper members over the upper-node ``panel`` and scans the
    ``scan_hwm`` prefix for layer 0, through the two-stage scan once the
    bucketed prefix reaches the gate (``full``: a full-width wave); the
    beam path descends and searches the graph."""
    upt = torch.as_tensor(up).to(st.device) if up.size else None
    if not exact:
        with timer.phase("beam_wave"):
            CS.scatter_wave(cfg, st, wid, wvec, wlvl)
            ue = None
            if upt is not None:
                with timer.phase("upper"):
                    ue = CS.upper_connect(cfg, st, wid[upt], wlvl[upt],
                                          max_lvl, timer)
            CS.base_connect(cfg, st, wid, wlvl, upt, ue, timer)
        return
    CS.scatter_wave(cfg, st, wid, wvec, wlvl)
    if upt is not None:
        with timer.phase("upper"):
            CS.upper_connect_exact(cfg, st, wid[upt], wlvl[upt], panel,
                                   max_lvl, timer)
    nscan = min(st.capacity, max(SCAN_FLOOR, _next_pow2(scan_hwm)))
    CS.base_connect_exact(cfg, st, wid, wlvl, nscan=nscan, scan2=full,
                          prefix=scan_hwm, timer=timer)


def callable_knn(q: np.ndarray, k: int, pred, *, exact: bool, custom: bool,
                 min_nn: int, count: int, id_space: int, search, exact_scan,
                 rows, refine) -> Tuple[np.ndarray, np.ndarray]:
    """Callable filters (HNSWIndex.cs:111-117), for the single-device and
    the sharded facade: search unfiltered with a widening beam and evaluate
    the predicate on returned candidates only (the reference evaluates it
    on visited nodes, GraphNavigator.cs:235-239; never a sweep of the
    corpus).  A query short of k passing results widens ``ef`` x4 up to
    ``min(4096, next_pow2(count))``; once the beams are saturated there,
    the queries still short get one exact top-``ef`` scan before they are
    finalized (not for a registered metric, ``custom``, which has no exact
    scan).  ``exact=True`` runs exact rounds from the start.  Each round's
    finished queries are refined in one batch.  Verdicts live in a table
    over the ``id_space`` ids, so each id is judged once a call.

    ``search(q, ef)`` and ``exact_scan(q, k)`` return (n, w) candidate
    ids, ``rows(ids)`` their stored vectors and ``refine(q, ids, k)`` the
    final (ids, dists)."""
    from .utils.predicates import BatchedPredicate

    n = q.shape[0]
    out_ids = np.full((n, k), -1, np.int32)
    out_d = np.full((n, k), np.nan, np.float32)
    judged = np.zeros(id_space, dtype=bool)
    passes = np.zeros(id_space, dtype=bool)
    bpred = pred if isinstance(pred, BatchedPredicate) \
        else BatchedPredicate(pred)

    pending = np.arange(n)
    ef = max(min_nn, 2 * k, 16)
    cap = min(4096, _next_pow2(max(count, 1)))
    mode_exact = exact and not custom
    can_escalate = not mode_exact and not custom
    while pending.size:
        sub = q[pending]
        if mode_exact:
            ids = exact_scan(sub, min(ef, max(count, 1)))
        else:
            ids = search(sub, ef)
        flat = np.unique(ids[ids >= 0])
        fresh = flat[~judged[flat]]
        if fresh.size:
            passes[fresh] = bpred(rows(fresh))
            judged[fresh] = True
        saturated = ef >= cap
        done, got, still = [], [], []
        for r, qi in enumerate(pending):
            row = ids[r]
            keep = row[(row >= 0) & passes[np.clip(row, 0, id_space - 1)]]
            starved = (row >= 0).sum() < ids.shape[1]
            if keep.size >= k or starved or \
                    (saturated and not can_escalate):
                done.append(qi)
                got.append(keep[:k])
            else:
                still.append(qi)
        if done:
            sel = np.full((len(done), k), -1, np.int64)
            for r, keep in enumerate(got):
                sel[r, :keep.size] = keep
            qs = np.asarray(done, np.int64)
            out_ids[qs], out_d[qs] = refine(q[qs], sel, k)
        pending = np.asarray(still, dtype=np.int64)
        if saturated and can_escalate and pending.size:
            mode_exact, can_escalate = True, False
        else:
            ef = min(cap, ef * 4)
    return out_ids, out_d


def range_pass(cfg: G.GraphConfig, metric: str, st: G.GraphState,
               qt: torch.Tensor, radius: float, layer: int, pool: int,
               fmask: Optional[torch.Tensor] = None):
    """One graph range pass over ``st``: seeds from a k-NN beam of width
    RANGE_SEED_EF (in-range pockets not linked to the greedy entry through
    in-range nodes), then ``range_search`` at ``pool``, keeping the ids in
    ``fmask``.  Returns ``range_search``'s (dists, ids, saturated)."""
    qn = dst.norm_data(metric, qt)
    _, seeds = SR.knn_search(cfg, st, qt, layer, RANGE_SEED_EF,
                             cfg.search_iter_factor * RANGE_SEED_EF + 16)
    ep_ok = (st.ep >= 0).expand(seeds.shape)
    return SR.range_search(cfg, st, qt, qn, seeds, ep_ok, layer, radius,
                           pool, pool * 4 + 16, filtered=fmask is not None,
                           filter_mask=fmask)


class HNSWIndex:
    """HNSW index on one torch device (see module docstring)."""

    def __init__(self, dim: int, metric: str = "sq_euclid",
                 parameters: Optional[HNSWParameters] = None,
                 device: torch.device | str = "cuda"):
        dst.check_metric(metric)
        p = parameters or HNSWParameters()
        p.validate()
        capacity = _alloc_capacity(p.collection_size)
        self._setup(dim, metric, p, device, G.GraphConfig(
            dim=int(dim), metric=metric, max_edges=p.max_edges,
            max_levels=G.default_max_levels(capacity, p.distribution_rate),
            ef_construction=p.max_candidates,
            search_iter_factor=p.search_iter_factor,
            build_expand=p.build_expand,
            rank_dtype=resolve_rank_dtype(p.rank_dtype),
            slack0=min(p.reverse_slack, p.max_edges // 2)))
        self._state = G.empty_state(self._cfg, capacity, self.device)

    def _setup(self, dim: int, metric: str, params: HNSWParameters,
               device, cfg: G.GraphConfig) -> None:
        """Everything but the graph state: shared by ``__init__`` and the
        snapshot loaders."""
        self.device = torch.device(device)
        _check_full_f32(self.device)
        self.dim = int(dim)
        self.metric = metric
        self.params = params
        self._cfg = cfg
        seed = params.random_seed if params.random_seed >= 0 else None
        self._rng = np.random.default_rng(seed)
        self._length = 0             # high-water slot mark (GraphData.cs:25)
        self._free: List[int] = []   # freed slots, reused last-in first-out
        self._count_host = 0         # host mirror of state.count
        self._pack = None            # lazily built QueryPack
        self._pack_refusal = ""      # why _get_pack last returned None
        self._block_fb = None        # lazily built DeviceBlockTables
        self._mirror = HostMirror(metric, self._vector_tables)
        # upper-node panel: ids of every live node with level >= 1, in
        # insertion order, with -1 holes where removed ids were; a count
        # of -1 marks a panel to rebuild from the state (after a load)
        self._upper_np = np.empty(0, np.int32)
        self._upper_pos: dict = {}   # id -> position in the panel
        self._upper_cnt = 0          # positions used (holes included)
        self._upper_holes = 0
        self._upper_ids: Optional[torch.Tensor] = None
        self._scan_hwm = 0           # 1 + highest slot ever activated
        #: per-phase build times (wave, scan, prune, reverse, upper, pack,
        #: remove, ...), their host self times, and the tallies of the work
        #: (``add.reused`` slots taken from the free list, ``pack.builds``,
        #: ``remove.ids`` and ``core/remove``'s removal tallies)
        self.timer = PhaseTimer(self.device)
        #: waves inserted on each build path
        self.wave_counts = {"exact": 0, "beam": 0}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def _vector_tables(self) -> List[torch.Tensor]:
        # a bound method, so that a deep copy's mirror reads the copy
        return [self._state.vectors]

    def _invalidate_caches(self) -> None:
        self._pack = None
        self._block_fb = None
        self._mirror.clear()

    def _grow_to(self, needed: int) -> None:
        C = self._state.capacity
        if needed <= C:
            return
        newC = C
        while newC < needed:
            newC *= 2                      # GraphData.cs:100
        self._state = G.grow_state(self._state, newC)

    def _alloc_slots(self, n: int) -> np.ndarray:
        """Freed slots first (last freed, first reused; only while removals
        are enabled, GraphData.cs:85-91), then fresh ones at the high-water
        mark."""
        slots: List[int] = []
        if self.params.allow_removals:
            while self._free and len(slots) < n:
                slots.append(self._free.pop())
        self.timer.count("add.reused", len(slots))
        fresh = n - len(slots)
        if fresh:
            self._grow_to(self._length + fresh)
            slots.extend(range(self._length, self._length + fresh))
            self._length += fresh
        return np.asarray(slots, dtype=np.int32)

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
        """Shared by ``add`` and ``update``.  Seed the first node as the
        edgeless entry point (GraphConnector.cs:27-33; also after every row
        was removed), then insert waves under the reference's
        schedule: ``w = min(max_wave, 4096, max(1, built), remaining)``,
        cut so that at most MAX_UPPER level>=1 members share a wave."""
        n = ids.shape[0]
        i = 0
        # a registered metric builds every wave on the beam path, which
        # does not read the upper-node panel
        custom = dst.is_custom(self.metric)
        if self._count_host == 0:
            G.seed_first_node(self._cfg, self._state, int(ids[0]), a[0],
                              int(lvls[0]))
            self._scan_hwm = max(self._scan_hwm, int(ids[0]) + 1)
            if lvls[0] >= 1 and not custom:
                self._panel_append(ids[:1])
            self._count_host = 1
            i = 1
        if i >= n:
            return
        # batch-wide: the panel may hold future-wave ids, which
        # upper_connect_exact masks out through `active`
        if not custom:
            self._panel_append(ids[i:][lvls[i:] >= 1])
        hwm = np.maximum.accumulate(ids[i:]) + 1
        dev = self.device
        ids_d = torch.as_tensor(ids.astype(np.int64)).to(dev)
        lvls_d = torch.as_tensor(lvls.astype(np.int64)).to(dev)
        vecs_d = torch.as_tensor(a).to(dev)
        mw = min(self.params.max_wave_size, WAVE_BUCKETS[-1])
        k = i
        while k < n:
            # the wave's own host work is the region's self time
            with self.timer.phase("wave"):
                w = min(mw, max(1, self._count_host), n - k)
                upc = np.cumsum(lvls[k:k + w] >= 1)
                if w > MAX_UPPER and upc[-1] > MAX_UPPER:
                    w = int(np.searchsorted(upc, MAX_UPPER, side="right"))
                self._scan_hwm = max(self._scan_hwm,
                                     int(hwm[k - i + w - 1]))
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
        """One wave, on the exact path while the corpus is at most
        ``exact_build_threshold`` rows, on the beam path past it and always
        for a registered metric (reference ``_insert_wave_dev``)."""
        exact = self._count_host <= self.params.exact_build_threshold and \
            not dst.is_custom(self.metric)
        self.wave_counts["exact" if exact else "beam"] += 1
        insert_wave(self._cfg, self._state, wid, wvec, wlvl, up, max_lvl,
                    exact=exact, scan_hwm=self._scan_hwm, full=full,
                    panel=self._upper_ids, timer=self.timer)

    # -- upper-node panel: the reference's layout (positions in insertion
    # order, holes where ids were removed, compaction once holes pass half
    # the panel), so both packages scan the same panel.  The host owns
    # membership; the device holds a copy.

    def _panel_push(self) -> None:
        self._upper_ids = torch.tensor(self._upper_np, device=self.device)

    def _panel_rebuild(self) -> None:
        """The panel of a loaded index: its live level >= 1 rows in id
        order."""
        st = self._state
        ids = torch.nonzero(st.active & (st.level >= 1)).flatten()
        self._panel_fill(ids.cpu().numpy().astype(np.int32))

    def _panel_compact(self) -> None:
        self._panel_fill(np.fromiter(self._upper_pos.keys(), np.int32,
                                     len(self._upper_pos)))

    def _panel_fill(self, ids: np.ndarray) -> None:
        self._upper_pos = {int(x): i for i, x in enumerate(ids)}
        self._upper_cnt = int(ids.size)
        self._upper_holes = 0
        self._upper_np = np.full(
            max(_PANEL_MIN_CAP, _next_pow2(max(1, ids.size))), -1, np.int32)
        self._upper_np[:ids.size] = ids

    def _panel_append(self, ids: np.ndarray) -> None:
        """Record newly inserted level>=1 node ids; an id already listed is
        not listed twice."""
        if self._upper_cnt < 0:
            # rebuilt before the batch's waves: this batch's ids are not
            # active yet, except a seeded first node, which is dropped below
            self._panel_rebuild()
            self._panel_push()
        if ids.size and self._upper_pos:
            ids = ids[[int(x) not in self._upper_pos for x in ids]]
        n = int(ids.size)
        if n == 0:
            return
        if self._upper_holes > max(1024, self._upper_cnt // 2):
            self._panel_compact()
        need = self._upper_cnt + n
        if need > self._upper_np.size:
            arr = np.full(max(_PANEL_MIN_CAP, _next_pow2(need)), -1,
                          np.int32)
            arr[:self._upper_cnt] = self._upper_np[:self._upper_cnt]
            self._upper_np = arr
        self._upper_np[self._upper_cnt:need] = ids
        for p, x in enumerate(ids.tolist(), start=self._upper_cnt):
            self._upper_pos[int(x)] = p
        self._upper_cnt = need
        self._panel_push()

    def _panel_remove(self, ids: np.ndarray) -> None:
        dead = [self._upper_pos.pop(int(x)) for x in ids
                if int(x) in self._upper_pos]
        if not dead or self._upper_cnt < 0:
            # a panel still to rebuild reads the state after this removal
            return
        self._upper_np[dead] = -1
        self._upper_holes += len(dead)
        self._panel_push()

    # ------------------------------------------------------------------
    # removal
    # ------------------------------------------------------------------

    def remove(self, ids) -> None:
        """Remove a batch by id with graph repair (HNSWIndex.cs:83-100).
        Out-of-range and inactive ids are ignored, repeated ids count once;
        the freed slots are reused by later adds, last freed first."""
        if not self.params.allow_removals:
            raise RuntimeError("Removals are disabled in this index "
                               "instance.")
        arr = np.asarray(ids, dtype=np.int64).ravel()
        if arr.size == 0:
            return
        active = self._state.active.cpu().numpy()
        arr = arr[(arr >= 0) & (arr < active.shape[0])]
        arr = np.unique(arr[active[arr]]).astype(np.int32)
        if arr.size == 0:
            return
        self._invalidate_caches()
        self.timer.count("remove.ids", arr.size)
        with self.timer.phase("remove"):
            RM.remove_from_state(
                self._cfg, self._state, arr,
                self.params.remove_max_candidates, scan_hwm=self._scan_hwm,
                quality=RM.resolve_quality(self.params.remove_quality,
                                           arr.size, self._count_host),
                timer=self.timer)
        self._free.extend(int(x) for x in arr)
        self._count_host -= int(arr.size)
        self._panel_remove(arr)

    def update(self, ids, vecs) -> None:
        """Replace stored vectors in place, keeping their ids (the reference's
        GraphData.UpdateItem, GraphData.cs:133-140): remove, then reinsert
        into the same slots with fresh levels and edges."""
        arr = np.asarray(ids, dtype=np.int64).ravel()
        a = _as_2d_f32(vecs, self.dim)
        if arr.size != a.shape[0]:
            raise ValueError("ids and vectors must have matching length")
        if arr.size == 0:
            return
        if not self.params.allow_removals:
            raise RuntimeError("update requires allow_removals=True")
        if np.unique(arr).size != arr.size:
            raise ValueError("update ids must be unique")
        active = self._state.active.cpu().numpy()
        bad = (arr < 0) | (arr >= active.shape[0])
        if bad.any() or not active[arr].all():
            raise ValueError("update ids must all be active")
        arr = arr.astype(np.int32)
        self.remove(arr)
        self._invalidate_caches()
        freed = {int(x) for x in arr}
        self._free = [x for x in self._free if x not in freed]
        lvls = G.sample_levels(self._rng, arr.size,
                               self.params.distribution_rate,
                               self._cfg.max_levels)
        self._insert_batch(arr, a, lvls)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _get_pack(self) -> Optional[PK.QueryPack]:
        """The packed-neighbourhood tables, built on first use.  None means
        "serve unpacked", and ``_pack_refusal`` says why: "disabled"
        (``pack_queries="off"``), "too_small" (under ``pack_min_count`` in
        "auto"), "budget" (past ``pack_max_bytes``, which the block
        fallback gates on) or "no_entry" (no entry point: every row was
        removed)."""
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
        with self.timer.phase("pack"):
            # entry set: the lowest upper level whose population fits the
            # scan
            lvl = self._state.level.cpu().numpy()
            act = self._state.active.cpu().numpy()
            eids = None
            cap = PK.entry_scan_cap(self.metric)
            for layer in range(1, self._state.num_levels):
                members = np.flatnonzero((lvl >= layer) & act)
                if members.size <= cap:
                    eids = members
                    break
            if eids is None or eids.size == 0:
                ep = int(self._state.ep)
                if ep < 0:
                    self._pack_refusal = "no_entry"
                    return None
                eids = np.asarray([ep])
            S = 1 << max(0, int(eids.size - 1).bit_length())
            padded = np.full(S, -1, np.int32)
            padded[:eids.size] = eids
            self._pack = PK.make_query_pack(
                self._cfg, self._state,
                torch.as_tensor(padded).to(self.device), res_dtype)
            self.timer.count("pack.builds", 1)
        return self._pack

    def _get_block_fallback(self):
        """At-scale serving fallback: when the query pack does not fit its
        budget, plain layer-0 ``knn_query`` is served from query-only block
        tables built ON THE DEVICE from the bf16 coarse table
        (block.build_device_block_tables: no host mirror) by routed block
        scoring, instead of the unpacked beam.

        Engages only when ALL hold: params.block_fallback == "auto", a
        built-in metric, the pack path is enabled and would have been used
        (count >= pack_min_count) but was refused for its budget.
        Invalidated on every mutation like the pack."""
        if self._block_fb is not None:
            return self._block_fb
        p = self.params
        if (p.block_fallback != "auto" or p.pack_queries == "off"
                or dst.is_custom(self.metric)
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
        with self.timer.phase("block_tables"):
            if self.device.type == "cuda" and not quantize:
                # K2's library: a fresh checkout compiles it here, not
                # inside the first scoring region
                from .ops import _cuda
                _cuda.library("block_scores")
            self._block_fb = build_device_block_tables(
                self.metric, src, self._state.active.cpu().numpy(),
                seed=(p.random_seed if p.random_seed >= 0 else None),
                quantize=quantize)
        return self._block_fb

    def _block_fallback_query(self, fb, q: np.ndarray, k: int
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """Serve a batch through the device block tables + refine.  Each
        batch is the region ``block_query`` (route and score), then
        ``block_refine``."""
        from .block import device_block_query
        n_probe = fallback_probes(fb.n_blocks)

        def step(i, j):
            with self.timer.phase("block_query"):
                qt = torch.as_tensor(q[i:j]).to(self.device)
                _, ids = device_block_query(self.metric, fb, qt, k, n_probe,
                                            timer=self.timer)
            with self.timer.phase("block_refine"):
                return self._mirror.refine(q[i:j], ids.cpu().numpy(), k)

        return in_batches(q.shape[0], k, step)

    def _build_filter_mask(self, filter_fnc) -> Optional[torch.Tensor]:
        """(C,) bool device mask from an id list or a (C,) bool array
        (callables never come here: they are evaluated on candidates
        only)."""
        if filter_fnc is None:
            return None
        C = self._state.capacity
        mask = np.asarray(filter_fnc, dtype=bool)
        if mask.shape != (C,):
            mask = np.zeros(C, dtype=bool)
            mask[np.asarray(filter_fnc, dtype=np.int64)] = True
        return torch.as_tensor(mask).to(self.device)

    def knn_query(self, queries, k: int, filter_fnc=None, layer: int = 0,
                  exact: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Batched k-NN at ``layer`` (HNSWIndex.cs:107-137).  Returns
        (ids (n, k) int32, dists (n, k) float32), -1/NaN padded.
        ``exact=True`` scans the whole corpus (ops/bruteforce.exact_knn2);
        at ``layer > 0`` only rows of level >= layer are candidates.
        ``filter_fnc`` is an id list or (C,) bool mask of the allowed ids,
        or a callable on a stored vector (``_knn_query_callable``)."""
        q = _as_2d_f32(queries, self.dim)
        n = q.shape[0]
        if self._count_host <= 0 or k < 1:
            return (np.full((n, k), -1, np.int32),
                    np.full((n, k), np.nan, np.float32))
        if callable(filter_fnc):
            return self._knn_query_callable(q, k, filter_fnc, layer, exact)
        fmask = self._build_filter_mask(filter_fnc)
        if exact:
            if dst.is_custom(self.metric):
                raise ValueError(
                    "exact=True requires a dot-decomposable built-in "
                    f"metric; custom metric {self.metric!r} is served by "
                    "the graph path")
            return self._mirror.refine_batched(
                q, self._exact_ids(q, k, layer, fmask), k)
        ef = max(self.params.min_nn, k)          # HNSWIndex.cs:115
        if layer == 0 and fmask is None:
            fb = self._get_block_fallback()
            if fb is not None:
                return self._block_fallback_query(fb, q, k)
        return self._mirror.refine_batched(
            q, self._search_ids(q, ef, layer, fmask), k)

    def _search_ids(self, q: np.ndarray, ef: int, layer: int = 0,
                    fmask: Optional[torch.Tensor] = None) -> np.ndarray:
        """Graph search in batches: the pack at layer 0 when there is one,
        the unpacked descent + beam otherwise; with ``fmask`` the pool of
        allowed ids.  Returns (n, ef) candidate ids."""
        expand = max(1, self.params.query_expand)
        max_iters = (self._cfg.search_iter_factor * ef) // expand + 16
        pk = self._get_pack() if layer == 0 else None
        n = q.shape[0]
        out = np.empty((n, ef), np.int32)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            qt = torch.as_tensor(q[i:j]).to(self.device)
            if pk is not None:
                _, ids = PK.packed_knn_search(
                    self._cfg, pk, qt, ef, max_iters,
                    filtered=fmask is not None, filter_mask=fmask,
                    expand=expand, n_entry=min(8, ef))
            else:
                _, ids = SR.knn_search(
                    self._cfg, self._state, qt, layer, ef, max_iters,
                    filtered=fmask is not None, filter_mask=fmask,
                    expand=expand)
            out[i:j] = ids.cpu().numpy()
        return out

    def _knn_query_callable(self, q: np.ndarray, k: int, pred, layer: int,
                            exact: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Callable filters (``callable_knn``) over the slots."""
        return callable_knn(
            q, k, pred, exact=exact, custom=dst.is_custom(self.metric),
            min_nn=self.params.min_nn, count=self._count_host,
            id_space=self._state.capacity,
            search=lambda sub, ef: self._search_ids(sub, ef, layer),
            exact_scan=lambda sub, kk: self._exact_ids(
                sub, kk, layer, None, scan2_max=256),
            rows=self._mirror.rows, refine=self._mirror.refine)

    def _exact_ids(self, q: np.ndarray, k: int, layer: int,
                   fmask: Optional[torch.Tensor],
                   scan2_max: Optional[int] = None) -> np.ndarray:
        """(n, k) ids of the brute-force top-k over the allowed rows
        (active, of level >= ``layer``, in ``fmask``; reference
        ``_exact_query``): the two-stage scan over the coarse table at
        EXACT_LANES lanes while there is one (and ``k <= scan2_max``), the
        blocked float32 scan otherwise."""
        st = self._state
        allowed = st.active
        if layer > 0:
            allowed = allowed & (st.level >= layer)
        if fmask is not None:
            allowed = allowed & fmask
        ct = st.coarse_table
        two_stage = ct is not None and (scan2_max is None or k <= scan2_max)
        n = q.shape[0]
        out = np.empty((n, k), np.int32)
        for i in range(0, n, QUERY_BATCH):
            j = min(n, i + QUERY_BATCH)
            qt = torch.as_tensor(q[i:j]).to(self.device)
            if two_stage:
                _, ids = BF.exact_knn2(self.metric, st.vectors, ct, st.norms,
                                       allowed, qt, k, lanes=EXACT_LANES)
            else:
                _, ids = BF.exact_knn(self.metric, st.vlo, st.norms,
                                      allowed, qt, k)
            out[i:j] = ids.cpu().numpy()
        return out

    def knn_query_results(self, query, k: int, filter_fnc=None,
                          layer: int = 0):
        """Single-query k-NN as ``KNNResult`` records (id, stored vector,
        distance; the reference's List<KNNResult>, HNSWIndex.cs:107-123)."""
        from .results import KNNResult
        ids, dists = self.knn_query(query, k, filter_fnc=filter_fnc,
                                    layer=layer)
        labels = self._mirror.rows(np.clip(ids[0], 0, None))
        out = []
        for j, (i, d) in enumerate(zip(ids[0], dists[0])):
            if i < 0:
                break
            out.append(KNNResult(id=int(i), label=labels[j].copy(),
                                 distance=float(d)))
        return out

    def range_query(self, queries, radius: float, filter_fnc=None,
                    layer: int = 0) -> Tuple[List[np.ndarray],
                                             List[np.ndarray]]:
        """Batched radius search (HNSWIndex.cs:144-168).  Returns ragged
        per-query (ids, dists) lists, ascending by distance.

        One exact count of in-radius rows (ops/bruteforce.range_count)
        sizes each batch's result pool from RANGE_POOLS (a registered
        metric has no count and climbs the whole ladder); queries whose
        count (plus the RANGE_SEED_EF seeds) reaches the top pool, and
        queries still saturated at it, are answered by an exact scan.  An
        id-list or mask filter applies on both paths; a callable is
        evaluated once per distinct result row."""
        q = _as_2d_f32(queries, self.dim)
        n = q.shape[0]
        if self._count_host <= 0:
            return ([np.empty(0, np.int32) for _ in range(n)],
                    [np.empty(0, np.float32) for _ in range(n)])
        pred = filter_fnc if callable(filter_fnc) else None
        fmask = None if pred else self._build_filter_mask(filter_fnc)
        st = self._state
        r32 = float(np.float32(radius))
        # a registered metric has no count: its pools climb the ladder
        counts = np.full(n, -1, np.int64)
        if not dst.is_custom(self.metric):
            for i in range(0, n, QUERY_BATCH):
                j = min(n, i + QUERY_BATCH)
                counts[i:j] = BF.range_count(
                    self.metric, st.vlo, st.norms, st.active,
                    torch.as_tensor(q[i:j]).to(self.device),
                    r32).cpu().numpy()

        ids_out: List[Optional[np.ndarray]] = [None] * n
        d_out: List[Optional[np.ndarray]] = [None] * n
        # the pool holds the in-range rows and the (possibly out-of-range)
        # seeds, which are expanded once to reach disconnected pockets
        is_exact = counts + RANGE_SEED_EF >= RANGE_POOLS[-1]
        for i in np.flatnonzero(is_exact):
            ids_out[i], d_out[i] = self._range_exact_host(q[i], radius,
                                                          fmask)
        graph_rows = np.flatnonzero(~is_exact)
        for i in range(0, graph_rows.size, QUERY_BATCH):
            take = graph_rows[i:i + QUERY_BATCH]
            qt = torch.as_tensor(q[take]).to(self.device)
            need = int(counts[take].max())
            start = next((p for p in RANGE_POOLS
                          if p >= need + RANGE_SEED_EF + 1),
                         RANGE_POOLS[-1])
            for pool in [p for p in RANGE_POOLS if p >= start]:
                _, ids, sat = range_pass(self._cfg, self.metric, st, qt, r32,
                                         layer, pool, fmask)
                sat_np = sat.cpu().numpy()
                if not sat_np.any():
                    break
            ids_np = ids.cpu().numpy()
            for r, t in enumerate(take):
                if sat_np[r]:
                    ids_out[t], d_out[t] = self._range_exact_host(
                        q[t], radius, fmask)
                    continue
                row = ids_np[r]
                row = row[row >= 0]
                rid, rd = self._mirror.refine(
                    q[t:t + 1],
                    row[None, :] if row.size else
                    np.full((1, 1), -1, np.int32), max(row.size, 1))
                keep = (rid[0] >= 0) & (rd[0] <= radius)
                ids_out[t], d_out[t] = rid[0][keep], rd[0][keep]
        if pred is not None:
            all_ids = np.unique(np.concatenate(
                [x for x in ids_out if len(x)] or [np.empty(0, np.int32)]))
            rows = self._mirror.rows(all_ids) if all_ids.size else \
                np.empty((0, self.dim), np.float32)
            ok = {int(x): bool(pred(v)) for x, v in zip(all_ids, rows)}
            for i in range(n):
                keep = np.asarray([ok[int(x)] for x in ids_out[i]], bool)
                ids_out[i], d_out[i] = ids_out[i][keep], d_out[i][keep]
        return ids_out, d_out

    def _range_exact_host(self, q1: np.ndarray, radius: float,
                          fmask: Optional[torch.Tensor] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact single-query range scan over the active rows in ``fmask``:
        float64 against the host mirror while it is affordable, the
        device's blocked float32 scan (ops/bruteforce.range_distances) and
        one (C,) transfer beyond."""
        st = self._state
        allowed = st.active if fmask is None else st.active & fmask
        if dst.is_custom(self.metric):
            # the float32 callable over the stored rows, on the device
            qt = torch.as_tensor(q1).to(self.device)[None]
            d = torch.cat([
                dst.exact(self.metric, qt, st.vectors[c0:c0 + (1 << 16)])
                .float() for c0 in range(0, st.capacity, 1 << 16)])
            d = np.where(allowed.cpu().numpy(),
                         d.cpu().numpy().astype(np.float64), np.inf)
            hit = np.flatnonzero(d <= radius)
            order = np.argsort(d[hit], kind="stable")
            return (hit[order].astype(np.int32),
                    d[hit][order].astype(np.float32))
        if not self._mirror.mirrorable():
            d = BF.range_distances(
                self.metric, st.vectors, st.norms, allowed,
                torch.as_tensor(q1).to(self.device),
                float(np.float32(radius))).cpu().numpy()
            hit = np.flatnonzero(np.isfinite(d))
            order = np.argsort(d[hit], kind="stable")
            return (hit[order].astype(np.int32),
                    d[hit][order].astype(np.float32))
        d = direct64(self.metric, q1.astype(np.float64)[None],
                     self._mirror.host().astype(np.float64))
        d = np.where(allowed.cpu().numpy(), d, np.inf)
        hit = np.flatnonzero(d <= radius)
        order = np.argsort(d[hit], kind="stable")
        return (hit[order].astype(np.int32),
                d[hit][order].astype(np.float32))

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
            rid, rd = self._mirror.refine(q, ids.cpu().numpy(), k)
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
    # statistics and persistence
    # ------------------------------------------------------------------

    def get_info(self) -> ST.HNSWInfo:
        """Per-layer degree statistics (HNSWIndex.cs:192-196)."""
        return ST.graph_info(self._cfg, self._state,
                             report_in_edges=self.params.allow_removals)

    def get_connected_component_counts(self) -> List[int]:
        """Weak components per layer (HNSWIndex.cs:202-205)."""
        return ST.connected_component_counts(self._cfg, self._state)

    def serialize(self, path: str) -> None:
        """Snapshot to ``path`` (".npz" appended when missing;
        HNSWIndex.cs:210-217), in the reference's format."""
        SN.save(path, self._cfg, self.params, self._state, self._length,
                self._free, self.dim)

    @classmethod
    def deserialize(cls, path: str,
                    device: torch.device | str = "cuda") -> "HNSWIndex":
        """Restore a snapshot of either package (HNSWIndex.cs:222-229): the
        ranking and coarse mirrors are rebuilt for the stored rank dtype,
        the level RNG is re-seeded from ``random_seed`` and the upper-node
        panel is rebuilt before the next add."""
        header, params, state, free = SN.load(path, device)
        idx = cls.__new__(cls)
        idx._setup(header["dim"], header["metric"], params, device,
                   G.GraphConfig(
                       dim=header["dim"], metric=header["metric"],
                       max_edges=params.max_edges,
                       max_levels=header["max_levels"],
                       ef_construction=params.max_candidates,
                       search_iter_factor=params.search_iter_factor,
                       build_expand=params.build_expand,
                       rank_dtype=resolve_rank_dtype(params.rank_dtype),
                       # the stored table's width is authoritative
                       slack0=state.nbr0.shape[1] - 2 * params.max_edges))
        state.vlo_store = G.make_vlo(idx._cfg.rank_dtype, state.vectors)
        state.coarse = G.make_coarse(idx._cfg, state.vectors)
        idx._state = state
        idx._free = free
        idx._length = idx._scan_hwm = header["length"]
        idx._count_host = header["count"]
        idx._upper_cnt = -1
        return idx

    @classmethod
    def _at_capacity(cls, dim: int, metric: str, params: HNSWParameters,
                     capacity: int, device) -> "HNSWIndex":
        """An empty index allocated at a snapshot's ``capacity``.  Its
        parameters keep the snapshot's ``collection_size`` (the reference
        overwrites it with the capacity, so that a second export of a
        loaded index differs from the first)."""
        idx = cls(dim, metric, dataclasses.replace(
            params, collection_size=max(capacity, 2)), device)
        idx.params = params
        return idx

    def _install(self, vec: np.ndarray, lvl: np.ndarray, act: np.ndarray,
                 tables, entry: int, count: int, length: int,
                 free) -> None:
        """Load host arrays (``tables`` = the split layer tables) into the
        state of an index made at their capacity, and the host mirrors."""
        dev = self.device
        vj = torch.as_tensor(vec).to(dev)
        nbr0, deg0, nbru, degu = (torch.as_tensor(t).to(dev) for t in tables)
        i32 = dict(dtype=torch.int32, device=dev)
        self._state = G.GraphState(
            vectors=vj, vlo_store=G.make_vlo(self._cfg.rank_dtype, vj),
            coarse=G.make_coarse(self._cfg, vj),
            norms=dst.norm_data(self.metric, vj),
            level=torch.as_tensor(lvl).to(dev), nbr0=nbr0, deg0=deg0,
            nbru=nbru, degu=degu, active=torch.as_tensor(act).to(dev),
            ep=torch.tensor(entry, **i32), count=torch.tensor(count, **i32))
        self._length = self._scan_hwm = int(length)
        self._free = [int(x) for x in free]
        self._count_host = int(count)
        self._panel_append(np.flatnonzero(act & (lvl >= 1)).astype(np.int32))

    @classmethod
    def from_host_snapshot(cls, path: str,
                           device: torch.device | str = "cuda"
                           ) -> "HNSWIndex":
        """Import a snapshot of the native C++ host engine
        (``hnswindex_tpu/native/hnsw_host.cpp``): built on a CPU, served
        here.  The graph semantics are the same, so queries work at once
        and the index stays mutable."""
        (params, metric, dim, capacity, length, entry, count, free,
         levels, removed, vectors, edges) = SN.load_host_snapshot(path)
        idx = cls._at_capacity(dim, metric, params, capacity, device)
        idx._grow_to(length)
        C, L = idx._state.capacity, idx._state.num_levels
        tables = _host_split_tables(idx._state)
        lvl = np.full(C, -1, np.int32)
        act = np.zeros(C, bool)
        vec = np.zeros((C, dim), np.float32)
        for i in range(length):
            if levels[i] < 0:
                continue
            vec[i] = vectors[i]
            lvl[i] = min(int(levels[i]), L - 1)
            act[i] = not removed[i]
            _write_node_edges(*tables, i, edges[i][:L])
        idx._install(vec, lvl, act, tables, entry, count, length, free)
        return idx

    def to_reference_snapshot(self, path: str) -> None:
        """Write a snapshot in the reference's protobuf-net wire format
        (HNSWIndexSnapshot.cs + GraphDataSnapshot.cs), loadable by the .NET
        library's ``HNSWIndex<float[], float>.Deserialize``.  Layer-0 rows
        over the 2M cap (the ``reverse_slack`` columns) are re-pruned on a
        copy; freed slots are written as removed nodes; in-edge lists
        (with removals allowed) come from transposing the out-edges."""
        st = self._state
        cap0 = 2 * self.params.max_edges
        deg0 = st.deg0.cpu().numpy()
        over = np.flatnonzero(deg0[:self._length] > cap0)
        if over.size:
            nbr0_t, deg0_t = st.nbr0.clone(), st.deg0.clone()
            CS.normalize_base_rows(self._cfg, st.vlo, st.norms, nbr0_t,
                                   deg0_t, over)
            nbr0, deg0 = nbr0_t.cpu().numpy(), deg0_t.cpu().numpy()
        else:
            nbr0 = st.nbr0.cpu().numpy()
        nbr0 = nbr0[:, :cap0]
        nbru = st.nbru.cpu().numpy()
        degu = st.degu.cpu().numpy()
        lvl = st.level.cpu().numpy()
        act = st.active.cpu().numpy()
        vec = self._mirror.host()
        length = self._length
        freed = set(self._free)
        with_in = self.params.allow_removals

        in_lists: List[dict] = [{} for _ in range(st.num_levels)]
        for layer in range(st.num_levels if with_in else 0):
            nbr_l, deg_l = (nbr0, deg0) if layer == 0 else \
                (nbru[layer - 1], degu[layer - 1])
            on = np.flatnonzero(act & (lvl >= layer))
            d = deg_l[on]
            if on.size == 0 or d.sum() == 0:
                continue
            srcs = np.repeat(on, d).astype(np.int32)
            cols = np.concatenate([nbr_l[u, :deg_l[u]] for u in on])
            order = np.argsort(cols, kind="stable")
            cols_s, srcs_s = cols[order], srcs[order]
            bounds = np.searchsorted(cols_s, np.arange(st.capacity + 1))
            in_lists[layer] = {v: srcs_s[bounds[v]:bounds[v + 1]]
                               for v in np.unique(cols_s)}

        empty = np.empty(0, np.int32)
        nodes = []
        for s in range(length):
            if s in freed or not act[s]:
                # the reference keeps a freed slot's Node with IsRemoved
                # set and empty edge lists
                top = max(int(lvl[s]), 0)
                nodes.append(RS.RefNode(
                    id=s, is_removed=True, out_edges=[empty] * (top + 1),
                    in_edges=[empty] * (top + 1) if with_in else []))
                continue
            top = int(lvl[s])
            ins = [np.asarray(in_lists[layer].get(s, empty), np.int32)
                   for layer in range(top + 1)] if with_in else []
            nodes.append(RS.RefNode(
                id=s, is_removed=False, in_edges=ins,
                out_edges=_read_node_edges(nbr0, deg0, nbru, degu, s, top)))

        RS.write_snapshot(path, RS.RefSnapshot(
            params=self.params, nodes=nodes,
            items=[vec[s] for s in range(length)],
            active=np.flatnonzero(act[:length]).astype(np.int32),
            removed=list(self._free), entry_point=int(st.ep),
            capacity=st.capacity, length=length, count=self._count_host))

    @classmethod
    def from_reference_snapshot(cls, path: str, metric: str = "sq_euclid",
                                device: torch.device | str = "cuda"
                                ) -> "HNSWIndex":
        """Load a snapshot written by the reference .NET library
        (``index.Serialize(path)``, HNSWIndex.cs:210-217) or by
        ``to_reference_snapshot``.  The distance function is code, not
        data, in the reference (re-supplied at Deserialize,
        HNSWIndex.cs:222), so ``metric`` is an argument."""
        snap = RS.read_snapshot(path)
        if not snap.items:
            raise ValueError("reference snapshot holds no items")
        dim = int(snap.items[0].size)
        idx = cls._at_capacity(dim, metric, snap.params, snap.capacity,
                               device)
        idx._grow_to(max(snap.length, 1))
        C, L = idx._state.capacity, idx._state.num_levels
        tables = _host_split_tables(idx._state)
        lvl = np.full(C, -1, np.int32)
        act = np.zeros(C, bool)
        vec = np.zeros((C, dim), np.float32)
        active_set = set(int(x) for x in snap.active)
        for i, node in enumerate(snap.nodes):
            s = node.id
            if s < 0 or s >= C:
                continue
            if i < len(snap.items):
                vec[s] = snap.items[i]
            lvl[s] = min(node.max_layer, L - 1)
            act[s] = (not node.is_removed) and (s in active_set)
            _write_node_edges(*tables, s, node.out_edges[:L])
        idx._install(vec, lvl, act, tables, snap.entry_point, snap.count,
                     snap.length, snap.removed)
        return idx
