#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py            # 1,000,000 x 128 clustered corpus

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the four CUDA kernels (hnswindex_torch/csrc/fused_scan.cu,
   block_scores.cu, accept_scan.cu and repair_scan.cu) from source, one
   nvcc each, started together, and prints the build time.  From then on every heuristic
   prune of the run passes its accept through a probe (``K3Probe``) that
   keeps the inputs of the first prune at each (width, max_edges) of a
   phase and of the last of its largest.  Where a phase below says "K3
   checked", K3's launches in that phase are counted from 0 (> 0
   required) and each kept input is run through K3 and its plain twin
   (``core/heuristic._accept_capped``), which must be equal; "K3 timed"
   adds, at each width's largest inputs, K3's device time a launch from a
   profiler trace of 200 launches, CUDA events around 200 launches, the
   twin's time and K3's bound by bytes.
3. Kernel phase, lane-min scan (K1): runs the kernel and its plain PyTorch
   version on the same inputs at the build's shapes (B=512 queries, D=128,
   BS=1024 lanes, C=1,007,616 rows, and a ragged C) and checks vals at
   rtol=atol=1e-4, identical dead lanes and >= 0.999 id agreement on live
   lanes; times both with CUDA events and prints the achieved TFLOP/s and
   the share of the bound.  The same bars hold for cosine at the full shape
   (per-column mult, a zero-norm row), a short prefix (C=20,000: few lane
   groups per split of the corpus walk), a ragged wave (B=300), an odd
   depth (D=100, tiles filled by plain loads) and a corpus of duplicate
   rows, where the ids must be exactly the lowest columns.
   Kernel phase, block scores (K2): kernel against plain version at the
   block path's shapes (13,568 blocks of 128 x 128, 1,024 queries x 32
   probes; float32 tiles for the three metrics, bfloat16 tiles for
   sq_euclid; -1 pads in the probe table and partly zero blocks), at a
   ragged shape (192-row blocks, 1,001 queries x 13 probes), with 192-row
   blocks (a 96 KB tile) and with D=1,024 (a tile streamed in row chunks)
   at the same query and probe counts.  Fails above
   1e-4 + 1e-4*|ref| for float32 and for bfloat16 tiles alike: both
   versions widen the same stored values and sum in float32, so only the
   order of the sums differs.  Times kernel, plain version and a gather +
   ``torch.bmm`` (the dots alone; printed as ``library_ms``, used nowhere
   in the package) with CUDA events, and computes each kernel's bound from
   this run's inputs and the H100's published peaks (K2's from the
   distinct probed tiles).  At the main float32 and bfloat16 shapes K2 is
   also timed at 32 pairs a work item instead of 16.
   Kernel phase, repair scan (K4): the churn cell's removal scan, a wave
   of 32,768 removed rows (whole clusters of 1,007,616 clustered rows of
   D=100, the rest allowed) at k=100, and the wave's ~6% of level >= 1
   against that level's rows (gathered, then cut into splits); K4 against its
   plain twin (``exact_knn`` in 4,096-query chunks, the path it replaced)
   with the card tests' bars (the same padding, sorted distances within
   1e-5 relative plus 1e-6 of qn + cn, every differing id a float64
   near-tie, at most 0.1% differing), timed beside the twin, a library
   yardstick (``torch.addmm`` distance panel + ``torch.topk``, 2,048
   queries a call, on the same rows; ``library_ms``, used nowhere in the
   package) and its bound (2 S n D operations at the f32 peak, n the rows
   scanned).
4. Main path: ``hnswindex_torch.Index(128, "sq_euclid", device="cuda")``
   with ``set_collection_size`` and ``add`` on the bench's clustered corpus
   (seed 65537, M=16, efConstruction=100, max_wave_size=512); prints
   inserts/s, per-phase seconds and the lane-min kernel's launch count
   (must be > 0); K3 checked and timed (its forward prune, B=512 at
   N=100, is the one the kernels line reports).
5. Queries: ``knn_query(k=10)`` on the first 10,000 corpus rows; prints
   q/s and checks recall@10 >= 0.90 on 1,000 of them against an exact f32
   brute force on the card.
   The unpacked engine on the same index: layer 0 without the pack
   (``pack_queries="off"``, ``min_nn=64``: ef 64 at ``query_expand=4``),
   recall@10 >= 0.87; ``knn_query(layer=1)`` on 1,000 rows (ids of level
   >= 1, distances ascending and equal to the direct formula, recall
   against the exact top-10 over the level >= 1 rows printed);
   ``knn_query(exact=True)`` on the 10,000 rows, recall@10 >= 0.99, with
   the lane-min kernel's launches on that path counted (> 0) and the
   kernel held against its plain version and timed on that path's own
   inputs (B=1,024, the whole capacity, 4,096 lanes); 100 queries at
   k=300 (the panel branch: no launch), recall@300 >= 0.999 against the
   exact top-300 on the card; ``range_query`` on 1,000 rows at the median
   exact 10th-neighbour distance (distances <= radius, ascending, no
   duplicate ids; recall of the in-radius sets printed); and
   ``multi_layer_knn_query`` on 8 rows (a list by layer, ids of level >=
   the layer).
6. Beam-path build: an ``Index`` of the first 200,000 rows with
   ``exact_build_threshold=20,000`` (the default is 2^24), so every wave
   past 20,000 built rows takes the beam path; prints inserts/s, the waves
   on each path and the phase split (K3 checked); packed
   ``knn_query(k=10)`` on 10,000 rows must reach recall@10 >= 0.90
   against the exact top-10 within those rows; the unpacked ef=64 recall
   is printed.
7. Block path: ``hnswindex_torch.BlockIndex(128, "sq_euclid",
   block_size=128, device="cuda")`` built on the same corpus;
   ``knn_query(k=10, n_probe=32)`` on the same 10,000 rows; recall@10 >=
   0.90 against the same ground truth; then 10,000 fresh rows are added
   (they must find themselves) and 10,000 ids removed (they must never come
   back).  The block-scores launch count must be > 0.  Then K2 on the
   path's own traffic: the first 1,024 rows routed to 32 blocks each, as
   ``query_device`` routes them, against its plain version, timed beside
   gather + ``bmm``, with its distinct tiles and its bound.
8. Facade fallback: a second ``Index`` of the first 200,000 rows with
   ``pack_queries="on"`` and ``pack_max_bytes=0``; ``knn_query(k=10)``
   must be served from bf16 block tables through K2 with
   ``n_probe = max(8, NB // 1024)``; recall@10 >= 0.90.
9. Filters on the main index, which stays on the card through 6-8 so
   that those paths run as they did before phases 9 and 10 existed; 1,000
   rows, recall@10 against the exact top-10 over the allowed rows on the
   card: a seeded 50% id mask on the
   packed path (ef 10) and the unpacked one (ef 64), bar 0.80 each, and on
   ``exact=True`` (the lane-min kernel's launches counted, > 0), bar 0.99;
   a vectorizable callable (column 0 above its median) on the packed path
   from ef 64, bar 0.97 (column 0 follows the cluster centres, so half the
   rows' passing neighbours lie past their own cluster; its recall at the
   default ef and at 1,024 printed), and with ``exact=True`` (the exact
   scan the widening escalates to, lane-min launches > 0), bar 0.99.
   Every id must pass its filter, distances ascending and equal to the
   direct formula.
   Churn on the main index: ``remove`` of 100,000 seeded ids, the entry
   point among them ("auto" resolves to "high"), with removals/s and the
   phase split (mark, affected, candidates, repair): count 900,000, the
   entry point active, no live row's edge into a removed row at any layer
   (checked on the card), no removed id among 10,000 queries' answers, and
   post/pre recall@10 of 1,000 surviving rows >= 0.98; K3 checked and
   timed at the repair's widths; K4 launched (> 0: the capacity is under
   2^20, so the candidate scan is K4).  Then 10,000 fresh
   rows are added (ids = the freed slots, last freed first; recall@1 on
   themselves >= 0.90; lane-min launches > 0; K3 checked) and 10,000
   surviving rows
   updated by the generator's noise (sigma 0.03; ids and count unchanged,
   ``items()`` shows the new vectors, recall@1 by the new vectors >= 0.85
   at ef 64 and printed at the default ef and at 256: the moved rows sit
   on their clusters' rims; lane-min and K4 launches > 0; K3 checked), and
   packed recall@10 of the live rows must stay >= 0.90.
10. ``BlockIndex(router="hnsw")`` on the same corpus: routed by a graph
    over the centroids, ``knn_query(k=10, n_probe=32)`` on the 10,000 rows
    (q/s beside the exact router's), recall@10 >= 0.90; after adding and
    removing 10,000 rows the router is rebuilt before the next query,
    recall@10 >= 0.90 against the live rows; block-scores launches > 0.

11. Statistics on the 1M index, right after its build and again after
    the churn: ``get_info()`` and ``get_connected_component_counts()``,
    each equal to a recomputation from the tables read to the host (numpy
    ``bincount`` degrees with the reference's median rule; scipy's weak
    components over the active rows of each layer); seconds printed.
12. Snapshot of the churned 1M index (free list, removed rows and repaired
    edges in the file): ``serialize`` to a temporary directory and
    ``HNSWIndex.deserialize(path, device="cuda")``; 1,000 queries must
    return identical ids and distances from both; the same 1,000 new rows
    added to both (the original's level RNG re-seeded from
    ``random_seed``, as the load re-seeds it) must take the same freed
    slots with the same levels.  Write and read seconds and bytes printed.
13. Reference snapshot of the 200k beam-path index (kept from phase 6):
    ``to_reference_snapshot`` and ``from_reference_snapshot`` on the card;
    packed recall@10 of 1,000 queries no more than 0.005 below the live
    index's (the export re-prunes layer-0 rows over the 2M cap, which the
    live pack cuts unpruned); a second export of the loaded index equal
    byte for byte; the golden stream ``tests/fixtures/refsnap_golden.bin``
    loads to ``refsnap_golden_expected.npz``'s ids and distances.  K3
    checked over the two exports and the import: launched where layer-0
    rows lie over the 2M cap, and not where none do.
14. Custom metric: L1 registered as a torch callable, the first 200,000
    rows built under it (every wave after the seed on the beam path),
    packed ``knn_query(k=10)`` of 1,000 rows at ef 16 and ef 32 against an
    exact L1 top-10 on the card (``torch.cdist``), recall@10 >= 0.90 at ef
    32; distances equal to the callable's; ``exact=True`` must raise; K3
    checked in the build.  Apart from K3, these phases launch no kernel: a
    registered metric has no exact scan and no block path, and statistics
    and snapshots are reductions and host I/O.
15. The sharded front ends, run after every earlier phase, on the same
    corpus with ``devices=["cuda:0", "cuda:0"]`` (two shards on the one
    card).  ``ShardedIndex`` build of the 1M rows (M=16, efConstruction=100,
    max_wave_size=512, so 256-row waves a shard): inserts/s, the waves,
    each shard's phase split and K1's launches in the build (0 expected:
    a shard's scan prefix, 507,904 rows, stays under BUILD_SCAN2_MIN); K3
    checked.
    Packed ``knn_query(k=10)`` on 10,000 rows: q/s, recall@10 >= 0.90, the
    per-shard packs built; unpacked at ef 64, recall@10 >= 0.87;
    ``exact=True``: recall@10 >= 0.99, K1 launched on that path, and K1
    held against its plain version on shard 0's own inputs (B=1,024, 4,096
    lanes, its 507,904-row prefix) with the exact phase's bars; a seeded
    50% id mask on the packed path, recall@10 >= 0.80 against the exact
    top-10 over the allowed rows; ``range_query`` on 1,000 rows (phase 5's
    checks).  ``remove`` of 50,000 seeded gids: removals/s, no live edge
    into a removed slot on either shard, no removed gid returned, post/pre
    recall@10 of 1,000 surviving rows >= 0.98; ``update`` of 5,000 rows
    (gids and count unchanged, the stored vectors the new ones, recall@1
    by the new vectors >= 0.85 at ef 64); K3 checked and K4 launched in
    both.  ``get_info``
    (layer 0 holds
    every live row) and component counts (two at layer 0, one a shard),
    then a ``.npz`` round trip onto the same devices whose 1,000 answers
    are identical.
16. ``ShardedBlockIndex`` of the 1M rows at 128-row blocks on the same two
    shards: ``knn_query(k=10, n_probe=32)`` on 10,000 rows, q/s, recall@10
    >= 0.90 and within 0.005 of phase 7's ``BlockIndex``, K2 launched
    (> 0); K2 held against its plain version on shard 0's own local
    probe table for the first 1,024 queries (the panel with the bars of
    K2's kernel phase in 3., and its top-10 against the plain
    ``_score_blocks``: values within the same bars, and every id that
    differs a near-tie, float64 distances within the same bars), timed
    beside its bound; then 10,000 rows added (they
    find themselves) and 10,000 removed (they never come back).

The ``kernels`` line reports K1, K2, K3 and K4 (K3's and K4's launches by
phase).
The last line is ``{"ok": true, "device": {...}}``; any failed check exits
non-zero before it.  Without a CUDA device the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 65537
D = 128
BS = 1024
WAVE = 512
FULL_C = 1_007_616          # capacity the index allocates for 1M rows
RAGGED_C = 1_000_003
N = 1_000_000               # corpus rows
NQ = 10_000                 # knn_query rows (the first NQ corpus rows)
# block path (K2): blocks the 1M corpus lays out, block rows, queries per
# launch, probes per query
K2_NB, K2_BS, K2_B, K2_P = 13_568, 128, 1_024, 32
K2_RAGGED = dict(NB=2_000, BS=192, B=1_001, P=13)
K2_D1024_NB = 2_000         # blocks of the D=1024 comparison (1 GB of tiles)
N_FALLBACK = 200_000        # rows of the facade-fallback index
N_CHURN = 10_000            # rows added to / removed from the BlockIndex
N_REMOVE = 100_000          # rows the bulk removal takes from the 1M index
N_BEAM = 200_000            # rows of the beam-path build
N_CUSTOM = 200_000          # rows of the custom-metric (L1) build
BEAM_THRESHOLD = 20_000     # its exact_build_threshold (default 2^24)
NQ_SMALL = 1_000            # queries of the layer-1, range and k=300 phases
N_SHARD_REMOVE = 50_000     # gids the sharded removal takes
N_SHARD_UPDATE = 5_000      # rows the sharded update moves
K3_REPS = 200               # launches a timing of K3 averages over
# the removal's repair scan (K4) at the churn cell's shape: a wave of
# removed rows, the scan prefix of 1M rows' capacity, D, remove_ef
K4_S, K4_NS, K4_D, K4_K = 32_768, FULL_C, 100, 100
# published peaks of one H100 SXM: bf16 tensor cores, f32 CUDA cores, HBM
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def clustered(n: int) -> np.ndarray:
    """bench.py's clustered generator (SIFT-like cluster structure)."""
    rng = np.random.default_rng(SEED)
    centers = rng.random((max(2, n // 500), D)).astype(np.float32)
    return (centers[rng.integers(0, centers.shape[0], n)]
            + 0.03 * rng.standard_normal((n, D)).astype(np.float32))


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, peak: float, nbytes: float) -> dict:
    """Least time the card could take: the larger of operations over the
    peak rate and bytes over the memory rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def k3_measure(pd, sd, svalid, max_edges: int) -> dict:
    """K3 (``ops/accept_scan``) on one prune's inputs against its plain
    twin (``core/heuristic._accept_capped``); fails unless the two are
    equal.  ``ms`` is K3's device time a launch, from a profiler trace of
    K3_REPS launches (so the host's pace of the launches is left out), and
    ``event_ms`` CUDA events around the same number of launches; the twin
    is timed by CUDA events.  K3's bound is by bytes: sd, svalid and the
    output once, and each pd entry the walk compares (for a column decided
    before the cap, one per earlier accept)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hnswbench.trace import _events
    from hnswindex_torch.core import heuristic as H
    from hnswindex_torch.ops.accept_scan import accept_scan

    def run():
        return accept_scan(pd, sd, svalid, max_edges)

    B, N = sd.shape
    got = run()
    want = H._accept_capped(pd, sd, svalid, max_edges)
    name = f"B={B} N={N} max_edges={max_edges}"
    if not torch.equal(got, want):
        fail(f"K3 differs from its twin at {name}")
    err = float((got.int() - want.int()).abs().max()) if B * N else 0.0
    event_ms = time_ms(run, K3_REPS)
    plain_ms = time_ms(lambda: H._accept_capped(pd, sd, svalid, max_edges),
                       3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(K3_REPS):
            run()
        torch.cuda.synchronize()
    # the trace may miss a few of the launches: the mean is of those seen
    spans = [e - s for s, e, n in _events(prof, True)[0]
             if "accept_scan_kernel" in n]
    if not spans:
        fail(f"K3 at {name}: the trace holds no accept_scan_kernel")
    ms = sum(spans) / len(spans) / 1e6
    keep_all = svalid.sum(dim=1) < max_edges
    before = torch.cumsum(got, dim=1) - got.long()      # accepts before c
    walked = svalid & (before < max_edges) & ~keep_all[:, None]
    nbytes = 4 * int((before * walked).sum()) + B * N * (4 + 1 + 1)
    res = dict(B=B, N=N, max_edges=max_edges, max_abs_err=err, ms=ms,
               traced_launches=len(spans), event_ms=event_ms,
               plain_ms=plain_ms, bytes=nbytes, library_ms=None,
               **bound(0.0, PEAK_F32, nbytes))
    res["bound_share"] = res["bound_ms"] / ms
    print(f"K3 {name}: identical to the twin; kernel {ms:.4f} ms a launch "
          f"(device time of the {len(spans)} of {K3_REPS} launches a trace "
          f"holds; CUDA events "
          f"{event_ms:.4f} ms), twin {plain_ms:.3f} ms, bound "
          f"{res['bound_ms']:.5f} ms ({nbytes:,} B), "
          f"{res['bound_share']:.3f} of the bound", flush=True)
    return res


class K3Probe:
    """Stands in for K3 where ``core/heuristic.prune`` calls it, for the
    whole run.  ``start`` sets K3's launch counter to 0; meanwhile the probe
    keeps the inputs of the first prune at each (width, max_edges) and of
    the last of its largest (most rows); ``finish`` reads the counter, then
    holds every kept input against the plain twin and, with ``timed``,
    measures K3 at each width's largest inputs (``k3_measure``)."""

    def __init__(self):
        self.seen: dict = {}

    def install(self) -> None:
        from hnswindex_torch.core import heuristic as H
        self.real = H.accept_scan
        H.accept_scan = self

    def __call__(self, pd, sd, svalid, max_edges):
        key = (sd.shape[1], int(max_edges))
        kept = self.seen.get(key)
        if kept is None:
            self.seen[key] = [(pd, sd, svalid)]
        elif sd.shape[0] >= kept[-1][1].shape[0]:
            self.seen[key] = [kept[0], (pd, sd, svalid)]
        return self.real(pd, sd, svalid, max_edges)

    def start(self) -> None:
        self.seen = {}
        self.real.calls = 0

    def finish(self, what: str, timed: bool = False) -> dict:
        import torch
        from hnswindex_torch.core import heuristic as H

        torch.cuda.synchronize()
        launches, seen = self.real.calls, self.seen
        self.seen = {}
        out = dict(launches=launches, widths=[], checked=0, timed=[])
        for (n, me), kept in sorted(seen.items()):
            out["widths"].append([n, me])
            for pd, sd, svalid in kept:
                if not torch.equal(self.real(pd, sd, svalid, me),
                                   H._accept_capped(pd, sd, svalid, me)):
                    fail(f"K3 differs from its twin in {what} at "
                         f"B={sd.shape[0]} N={n} max_edges={me}")
                out["checked"] += 1
            if timed:
                out["timed"].append(k3_measure(*kept[-1], me))
        del seen
        torch.cuda.empty_cache()
        print(f"K3 in {what}: {launches} launches; {out['checked']} "
              f"prunes' inputs at (width, max_edges) {out['widths']} "
              f"identical to the twin", flush=True)
        return out


#: the probe every prune of the run goes through (installed by ``main``)
K3 = K3Probe()


def kernel_phase(C: int, B: int = WAVE, d: int = D,
                 metric: str = "sq_euclid", dup: bool = False,
                 timed: bool = True) -> dict:
    """K1 against its plain version on the card at one shape.  ``dup``
    builds the corpus from seven distinct rows, so every lane ties exactly
    across its groups and across the kernel's splits of the corpus walk;
    the ids must then be exactly the plain version's (the lowest columns)."""
    import torch
    from hnswindex_torch.ops import distance as dst
    from hnswindex_torch.ops import fused_scan as FS

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + C + B + d)
    x = torch.rand((C, d), generator=g, device=dev)
    if dup:
        x = x[:7].repeat(-(-C // 7), 1)[:C].contiguous()
    x[5] = 0.0                                   # a zero-norm row
    coarse = x.to(torch.bfloat16)
    active = torch.rand((C,), generator=g, device=dev) < 0.9
    active[5] = True
    mult, bias = FS.rank_transform(metric, dst.norm_data(metric, x), active)
    q = torch.rand((B, d), generator=g, device=dev)
    excl = torch.randint(0, C, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    name = (f"{metric} C={C} B={B} D={d} BS={BS}"
            + (" duplicate rows" if dup else ""))

    kv, ki = FS.lane_min_scan(coarse, mult, bias, q, excl, BS=BS)
    torch.cuda.synchronize()
    rv, ri = FS.lane_min_scan_ref(coarse, mult, bias, q, excl, BS=BS)
    torch.cuda.synchronize()
    live = rv < FS.DEAD
    if not torch.equal(kv < FS.DEAD, live):
        fail(f"K1 dead lanes differ from the plain version at {name}")
    if not torch.equal(ki[~live], torch.full_like(ki[~live], -1)):
        fail(f"K1 dead lanes carry ids at {name}")
    err = (kv[live] - rv[live]).abs()
    tol = 1e-4 + 1e-4 * rv[live].abs()
    if bool((err > tol).any()):
        fail(f"K1 vals off at {name}: max abs err {err.max().item()}")
    agree = (ki[live] == ri[live]).float().mean().item()
    if agree < 0.999:
        fail(f"K1 ids agree on {agree} of live lanes at {name}")
    if dup and not torch.equal(ki, ri):
        fail(f"K1 ids are not exactly the lowest columns at {name}")
    res = dict(C=C, B=B, D=d, metric=metric, max_abs_err=err.max().item(),
               id_agree=agree, library_ms=None)
    line = (f"kernel phase K1 {name}: max_abs_err={res['max_abs_err']:.3e} "
            f"id_agree={agree:.6f}")
    if timed:
        ms = time_ms(lambda: FS.lane_min_scan(coarse, mult, bias, q, excl,
                                              BS=BS), 10)
        plain_ms = time_ms(lambda: FS.lane_min_scan_ref(coarse, mult, bias,
                                                        q, excl, BS=BS), 3)
        # bound: bf16 products on the tensor cores; every input read once
        # (corpus, mult, bias, q, exclude), both outputs written once
        nbytes = sum(t.numel() * t.element_size()
                     for t in (coarse, mult, bias, q, excl, kv, ki))
        flops = 2.0 * B * C * d
        res.update(ms=ms, plain_ms=plain_ms, tflops=flops / ms / 1e9,
                   **bound(flops, PEAK_BF16, nbytes))
        res["bound_share"] = res["bound_ms"] / ms
        line += (f" kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound "
                 f"{res['bound_ms']:.4f} ms ({res['bound_by']}); achieved "
                 f"{res['tflops']:.1f} TFLOP/s, {res['bound_share']:.3f} of "
                 f"the bound")
    print(line, flush=True)
    return res


def kernel_phases() -> dict:
    """Every K1 comparison; ``full`` is the build wave's shape (the one the
    kernels line reports)."""
    out = dict(full=kernel_phase(FULL_C), ragged=kernel_phase(RAGGED_C))
    out["cosine"] = kernel_phase(FULL_C, metric="cosine")
    out["short_prefix"] = kernel_phase(20_000)
    out["ragged_wave"] = kernel_phase(RAGGED_C, B=300)
    out["odd_depth"] = kernel_phase(200_003, d=100)
    out["duplicate_rows"] = kernel_phase(200_003, dup=True, timed=False)
    return out


def k4_case(upper: bool):
    """The churn cell's removal scan: K4_NS clustered rows of K4_D (500 a
    cluster, noise 0.03), whole clusters taken out until K4_S rows are
    (the wave: inactive, and the queries), the rest allowed; with
    ``upper`` only the ~6% of level >= 1 of the rest, and the wave's
    members at that level as the queries."""
    import torch
    from hnswindex_torch.ops import distance as dst

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    n_c = K4_NS // 500
    centres = torch.rand((n_c, K4_D), generator=g, device=dev)
    lab = torch.randint(0, n_c, (K4_NS,), generator=g, device=dev)
    x = centres[lab] + 0.03 * torch.randn((K4_NS, K4_D), generator=g,
                                          device=dev)
    size = torch.bincount(lab, minlength=n_c)
    order = torch.randperm(n_c, generator=g, device=dev)
    take = order[:int((torch.cumsum(size[order], 0) < K4_S).sum()) + 1]
    wave = torch.isin(lab, take).nonzero()[:, 0][:K4_S]
    allowed = torch.ones(K4_NS, dtype=torch.bool, device=dev)
    allowed[wave] = False
    if upper:
        high = torch.rand((K4_NS,), generator=g, device=dev) < 0.06
        allowed &= high
        wave = wave[high[wave]]
    return x, dst.norm_data("sq_euclid", x), allowed, x[wave].contiguous()


def k4_compare(name: str, x, norms, allowed, q, kd, ki, td, ti) -> dict:
    """K4 against its twin with the card tests' bars: the same -1 / +inf
    padding, sorted distances within 1e-5 relative plus 1e-6 of qn + cn,
    each differing id a float64 near-tie (within twice that) of the twin's,
    and at most 0.1% of ids differing."""
    import torch
    from hnswindex_torch.ops import distance as dst

    fin = torch.isfinite(td)
    if not torch.equal(torch.isfinite(kd), fin) or \
            not bool((ki[~fin] == -1).all()):
        fail(f"K4 pads differ from the twin's at {name}")
    scale = dst.norm_data("sq_euclid", q)[:, None] + norms[ti.clamp(min=0)]
    tol = 1e-5 * td.abs() + 1e-6 * scale
    err = (kd - td).abs()
    if bool((err > tol)[fin].any()):
        fail(f"K4 distances off at {name}: max abs err "
             f"{err[fin].max().item()}")
    diff = (ki != ti) & fin
    r, c = diff.nonzero(as_tuple=True)
    if r.numel():
        qd = q[r].double()
        dk = ((qd - x[ki[r, c]].double()) ** 2).sum(-1)
        dt = ((qd - x[ti[r, c]].double()) ** 2).sum(-1)
        if bool(((dk - dt).abs() > 2 * tol[r, c]).any()):
            fail(f"K4 picks an id the twin's order does not tie at {name}")
    agree = 1.0 - diff.float().mean().item()
    if agree < 0.999:
        fail(f"K4 ids agree on {agree} of entries at {name}")
    return dict(max_abs_err=err[fin].max().item() if bool(fin.any())
                else 0.0, id_agree=agree, ids_differing=int(r.numel()))


def k4_phase() -> dict:
    """K4 (``ops/repair_scan``) at the churn cell's removal shape (layer 0
    and its level >= 1 members), against the twin (``repair_scan_ref``:
    ``exact_knn`` in 4,096-query chunks, the path it replaced), timed with
    CUDA events beside the twin, a library yardstick (``torch.addmm`` of
    the distance panel and ``torch.topk``, 2,048 queries a call; used
    nowhere in the package, on the same rows) and its bound (2 S n D
    operations at the f32 peak, n the rows scanned: the whole prefix at
    layer 0, the gathered allowed rows above it; each input read once, the
    ids and distances written once)."""
    import ctypes

    import torch
    from hnswindex_torch.ops import _cuda
    from hnswindex_torch.ops import repair_scan as RS

    out = {}
    for upper in (False, True):
        x, norms, allowed, q = k4_case(upper)
        S = q.shape[0]
        name = (f"S={S} ns={K4_NS} D={K4_D} k={K4_K}"
                + (" level >= 1" if upper else ""))
        n0 = RS.repair_scan.calls
        kd, ki = RS.repair_scan("sq_euclid", x, norms, allowed, q, K4_K)
        torch.cuda.synchronize()
        if RS.repair_scan.calls != n0 + 1:
            fail(f"K4 did not count its launch at {name}")
        td, ti = RS.repair_scan_ref("sq_euclid", x, norms, allowed, q, K4_K)
        res = k4_compare(name, x, norms, allowed, q, kd, ki, td, ti)
        del td, ti
        ms = time_ms(lambda: RS.repair_scan("sq_euclid", x, norms, allowed,
                                            q, K4_K), 3)
        plain_ms = time_ms(lambda: RS.repair_scan_ref(
            "sq_euclid", x, norms, allowed, q, K4_K), 1)
        # the yardstick scans the same rows: the gathered ones above layer 0
        xl, cb = ((x[allowed], norms[allowed]) if upper else
                  (x, torch.where(allowed, norms, float("inf"))))

        def library():
            for s0 in range(0, S, 2048):
                torch.topk(torch.addmm(cb, q[s0:s0 + 2048], xl.T,
                                       alpha=-2.0),
                           K4_K, dim=1, largest=False)

        library_ms = time_ms(library, 1)
        # the rows the scan needs: all of the prefix at layer 0, the
        # gathered allowed rows above it
        n_rows = int(allowed.sum()) if upper else K4_NS
        flops = 2.0 * S * n_rows * K4_D
        nbytes = (n_rows + q.numel() // K4_D) * K4_D * 4 + n_rows * 5 \
            + S * K4_K * (4 + 8)
        P, rows = ctypes.c_int(), ctypes.c_int()
        _cuda.check(_cuda.library("repair_scan").hnsw_repair_scan_plan(
            S, n_rows, K4_K, ctypes.byref(P), ctypes.byref(rows)), "plan")
        P = P.value
        res.update(S=S, ns=K4_NS, rows_scanned=n_rows, D=K4_D, k=K4_K,
                   splits=P, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   tflops=flops / ms / 1e9, **bound(flops, PEAK_F32, nbytes))
        res["bound_share"] = res["bound_ms"] / ms
        print(f"kernel phase K4 {name}: {n_rows} rows scanned, {P} "
              f"split(s), max_abs_err="
              f"{res['max_abs_err']:.3e} id_agree={res['id_agree']:.6f}; "
              f"kernel {ms:.2f} ms plain {plain_ms:.2f} ms library "
              f"{library_ms:.2f} ms bound {res['bound_ms']:.2f} ms "
              f"({res['bound_by']}); achieved {res['tflops']:.1f} TFLOP/s, "
              f"{res['bound_share']:.3f} of the bound", flush=True)
        out["upper" if upper else "wave"] = res
        del x, norms, allowed, q, kd, ki, cb, xl
        torch.cuda.empty_cache()
    return out


def block_tiles(NB: int, BS_: int, dtype, d: int = D):
    """A (NB, BS, d) tile table whose blocks are partly filled (zero rows
    past a random fill count, as in a laid-out index)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + NB + BS_ + d)
    blk = torch.rand((NB, BS_, d), generator=g, device=dev)
    fill = torch.randint(BS_ // 2, BS_ + 1, (NB,), generator=g, device=dev)
    blk *= (torch.arange(BS_, device=dev)[None, :] < fill[:, None])[:, :, None]
    return blk.to(dtype)


def k2_time_at_qt(fn, qt: int) -> float:
    """K2's time with at most ``qt`` pairs a work item (``QT`` is read at
    each call)."""
    from hnswindex_torch.ops import block_scores as TBS
    keep, TBS.QT = TBS.QT, qt
    try:
        return time_ms(fn, 10)
    finally:
        TBS.QT = keep


def k2_compare(name: str, metric: str, blk, bids, q, timed: bool,
               qt_alt: int = 0) -> dict:
    """K2 against its plain version on the card on one input; when
    ``timed``, also its time, the plain version's, a gather + ``bmm``'s
    and the bound from this input's distinct probed tiles (with
    ``qt_alt``, also K2's time at that many pairs a work item)."""
    import torch
    from hnswindex_torch.ops import block_scores as TBS

    NB, BS_, d = blk.shape
    B, P = bids.shape
    got = TBS.block_scores(metric, blk, bids, q)
    torch.cuda.synchronize()
    ref = TBS.block_scores_ref(metric, blk, bids, q)
    torch.cuda.synchronize()
    if got.shape != (B, P * BS_) or not bool(torch.isfinite(got).all()):
        fail(f"K2 {name}: wrong shape or non-finite distances")
    err = (got - ref).abs()
    if bool((err > 1e-4 + 1e-4 * ref.abs()).any()):
        fail(f"K2 {name}: max abs err {err.max().item()}")
    res = dict(name=name, max_abs_err=err.max().item())
    del got, ref, err
    if not timed:
        print(f"kernel phase K2 {name}: max_abs_err={res['max_abs_err']:.3e}",
              flush=True)
        return res
    idc = bids.long().clamp(0, NB - 1)
    qc = q.to(blk.dtype)[:, :, None]
    run = lambda: TBS.block_scores(metric, blk, bids, q)    # noqa: E731
    res["ms"] = time_ms(run, 10)
    res["plain_ms"] = time_ms(
        lambda: TBS.block_scores_ref(metric, blk, bids, q), 3)
    # yardstick only: one gather and one batched product give the dots
    # (not the norms or the metric)
    res["library_ms"] = time_ms(
        lambda: torch.bmm(blk[idc].view(B, P * BS_, d), qc), 3)
    # bound: each distinct probed tile read once, plus q, the probe table
    # and the panel; two flops per tile element per probe
    distinct = int(torch.unique(idc).numel())
    nbytes = (distinct * BS_ * d * blk.element_size()
              + q.numel() * 4 + bids.numel() * 4 + B * P * BS_ * 4)
    res.update(bound(2.0 * B * P * BS_ * d,
                     PEAK_BF16 if blk.dtype == torch.bfloat16 else PEAK_F32,
                     nbytes))
    res["distinct_tiles"] = distinct
    line = (f"kernel phase K2 {name}: max_abs_err={res['max_abs_err']:.3e}"
            f" kernel {res['ms']:.3f} ms plain {res['plain_ms']:.3f} ms "
            f"gather+bmm {res['library_ms']:.3f} ms bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}, {distinct} "
            f"distinct tiles of {NB})")
    if qt_alt:
        res[f"ms_qt{qt_alt}"] = k2_time_at_qt(run, qt_alt)
        line += f"; at {qt_alt} pairs a work item {res[f'ms_qt{qt_alt}']:.3f} ms"
    print(line, flush=True)
    return res


def block_phase(metric: str, blk, B: int, P: int, timed: bool,
                qt_alt: int = 0) -> dict:
    """K2 against its plain version at one shape, on uniform random probes
    with 5% routing pads and a zero query."""
    import torch

    dev = blk.device
    NB, BS_, d = blk.shape
    g = torch.Generator(device=dev).manual_seed(SEED + B + P)
    q = torch.rand((B, d), generator=g, device=dev)
    if metric == "ucosine":
        q /= q.norm(dim=1, keepdim=True)
    q[1] = 0.0                                   # a zero query
    bids = torch.randint(0, NB, (B, P), generator=g, device=dev,
                         dtype=torch.int32)
    bids[torch.rand((B, P), generator=g, device=dev) < 0.05] = -1   # pads
    tiles = "bf16" if blk.dtype == torch.bfloat16 else "f32"
    name = f"{metric}/{tiles} NB={NB} BS={BS_} D={d} B={B} P={P}"
    return k2_compare(name, metric, blk, bids, q, timed, qt_alt)


def block_phases() -> dict:
    """Every K2 comparison; returns the float32 sq_euclid result at the
    block path's shape (the one the kernels line reports)."""
    import torch
    blk = block_tiles(K2_NB, K2_BS, torch.float32)
    out = dict(sq_euclid=block_phase("sq_euclid", blk, K2_B, K2_P,
                                     timed=True, qt_alt=32))
    out["cosine"] = block_phase("cosine", blk, K2_B, K2_P, timed=True)
    blk /= blk.norm(dim=2, keepdim=True).clamp(min=1e-30)
    out["ucosine"] = block_phase("ucosine", blk, K2_B, K2_P, timed=True)
    del blk
    out["bf16"] = block_phase(
        "sq_euclid", block_tiles(K2_NB, K2_BS, torch.bfloat16), K2_B, K2_P,
        timed=True, qt_alt=32)
    r = K2_RAGGED
    out["ragged"] = block_phase(
        "sq_euclid", block_tiles(r["NB"], r["BS"], torch.float32), r["B"],
        r["P"], timed=False)
    # a 96 KB tile (the same rows in 192-row blocks) and a tile streamed in
    # row chunks (D=1024)
    out["bs192"] = block_phase(
        "sq_euclid", block_tiles(K2_NB * K2_BS // 192, 192, torch.float32),
        K2_B, K2_P, timed=True)
    out["d1024"] = block_phase(
        "sq_euclid", block_tiles(K2_D1024_NB, K2_BS, torch.float32, 1024),
        K2_B, K2_P, timed=True)
    torch.cuda.empty_cache()
    return out


def recall_at_10(ids, gt) -> float:
    """Recall of each row of ``ids`` against the same row of ``gt`` (at
    gt's width: 10 unless the caller asks for more)."""
    return float(np.mean([len(set(a) & set(b)) / len(b)
                          for a, b in zip(ids, gt)]))


def check_answers(what: str, qi, qd, nq: int, n: int) -> None:
    if qi.shape != (nq, 10) or not np.isfinite(qd).all():
        fail(f"{what}: knn_query returned padding or non-finite distances")
    if (qi < 0).any() or (qi >= n).any() or (np.diff(qd, axis=1) < 0).any():
        fail(f"{what}: ids out of range or distances not ascending")


def block_path(vecs: np.ndarray, gt: np.ndarray) -> dict:
    """BlockIndex at full width: build, query, add, remove."""
    import torch
    import hnswindex_torch
    from hnswindex_torch.block import _route_exact
    from hnswindex_torch.ops import block_scores as TBS

    n = vecs.shape[0]
    bix = hnswindex_torch.BlockIndex(D, "sq_euclid", block_size=K2_BS,
                                     device="cuda")
    TBS.block_scores.launches = 0
    t0 = time.perf_counter()
    bix.build(vecs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if bix.count != n:
        fail("BlockIndex.build did not lay out every row")
    bix.knn_query(vecs[:K2_B], 10, n_probe=K2_P)             # warm up
    t0 = time.perf_counter()
    qi, qd = bix.knn_query(vecs[:NQ], 10, n_probe=K2_P)
    qs = NQ / (time.perf_counter() - t0)
    check_answers("block path", qi, qd, NQ, n)
    recall = recall_at_10(qi[:1000], gt)
    n_blocks = bix.n_blocks
    print(f"block path: {n} rows in {n_blocks} blocks of {K2_BS}, build "
          f"{build_s:.2f} s; {NQ} x k=10 n_probe={K2_P} {qs:.1f} q/s; "
          f"recall@10 {recall:.4f}", flush=True)
    if recall < 0.90:
        fail(f"block path recall@10 {recall} < 0.90")

    rng = np.random.default_rng(SEED + 1)
    fresh = (vecs[rng.choice(n, N_CHURN, replace=False)]
             + 0.01 * rng.standard_normal((N_CHURN, D)).astype(np.float32))
    t0 = time.perf_counter()
    new_ids = bix.add(fresh)
    add_s = time.perf_counter() - t0
    drop = rng.choice(np.arange(NQ, n), N_CHURN, replace=False)
    t0 = time.perf_counter()
    bix.remove(drop)
    remove_s = time.perf_counter() - t0
    if bix.count != n or new_ids.min() < n:
        fail("block path: add/remove lost count or reused an id")
    found = bix.knn_query(fresh[:1000], 1, n_probe=K2_P)[0][:, 0]
    self_found = float((found == new_ids[:1000]).mean())
    back = bix.knn_query(vecs[drop[:1000]], 10, n_probe=K2_P)[0]
    launches = TBS.block_scores.launches
    print(f"block path churn: add {N_CHURN} rows {add_s:.2f} s, remove "
          f"{N_CHURN} ids {remove_s:.2f} s; added rows find themselves "
          f"{self_found:.4f}; block_scores launches {launches}", flush=True)
    if np.isin(back, drop).any():
        fail("block path: a removed id came back")
    if self_found < 0.90:
        fail(f"block path: only {self_found} of the added rows found")
    if launches <= 0:
        fail("the block path never launched the block-scores kernel")

    # K2 on the block path's own traffic: the first K2_B corpus rows routed
    # as query_device routes them (after the launch count was read)
    qd = torch.as_tensor(vecs[:K2_B], device="cuda")
    bids = _route_exact(bix.metric, bix._cents, bix._cent_norms, qd,
                        min(K2_P, bix.n_blocks), bix._cent_valid)
    real = k2_compare(f"real traffic sq_euclid/f32 NB={bix._blk_vecs.shape[0]}"
                      f" BS={K2_BS} D={D} B={K2_B} P={K2_P}", "sq_euclid",
                      bix._blk_vecs, bids, qd, timed=True, qt_alt=32)
    return dict(build_s=build_s, n_blocks=n_blocks, queries_per_s=qs,
                recall_at_10=recall, add_s=add_s, remove_s=remove_s,
                self_found=self_found, launches=launches, k2_real=real)


def fallback_path(vecs: np.ndarray) -> dict:
    """The facade past its pack budget: served from bf16 block tables."""
    import torch
    import hnswindex_torch
    from hnswindex_torch.index import fallback_probes
    from hnswindex_torch.ops import block_scores as TBS

    sub = vecs[:N_FALLBACK]
    index = hnswindex_torch.Index(D, "sq_euclid", device="cuda")
    index.set_collection_size(N_FALLBACK)
    index._params.pack_queries = "on"
    index._params.pack_max_bytes = 0
    t0 = time.perf_counter()
    index.add(sub)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    TBS.block_scores.launches = 0
    t0 = time.perf_counter()
    index.knn_query(sub[:K2_B], 10)              # builds the block tables
    first_s = time.perf_counter() - t0
    fb = index._impl._block_fb
    if fb is None or fb.blk_vecs.dtype != torch.bfloat16:
        fail("the facade fallback did not engage with bf16 tiles")
    t0 = time.perf_counter()
    qi, qd = index.knn_query(sub[:NQ], 10)
    qs = NQ / (time.perf_counter() - t0)
    launches = TBS.block_scores.launches
    check_answers("facade fallback", qi, qd, NQ, N_FALLBACK)
    gt = exact_top10(torch.as_tensor(sub, device="cuda"), sub[:1000])
    recall = recall_at_10(qi[:1000], gt)
    n_probe = fallback_probes(fb.n_blocks)
    print(f"facade fallback: {N_FALLBACK} rows built in {build_s:.2f} s; "
          f"{fb.n_blocks} bf16 blocks, n_probe={n_probe}, tables + first "
          f"batch {first_s:.2f} s; {NQ} x k=10 {qs:.1f} q/s; recall@10 "
          f"{recall:.4f}; block_scores launches {launches}", flush=True)
    if recall < 0.90:
        fail(f"facade fallback recall@10 {recall} < 0.90")
    if launches <= 0:
        fail("the facade fallback never launched the block-scores kernel")
    return dict(build_s=build_s, n_blocks=fb.n_blocks, n_probe=n_probe,
                queries_per_s=qs, recall_at_10=recall, launches=launches)


def exact_top10(xd, q: np.ndarray):
    """Exact f32 top-10 ids of each query over the corpus on the card."""
    return exact_topk(xd, q, 10)[1]


def exact_topk(xd, q: np.ndarray, k: int, allowed=None):
    """Exact f32 top-k (dists, ids) of each query over the allowed rows of
    the corpus ``xd`` on the card."""
    import torch
    xn = (xd * xd).sum(1)
    ds, ids = [], []
    for i in range(0, q.shape[0], 250):
        qd = torch.as_tensor(q[i:i + 250], device=xd.device)
        d = (qd * qd).sum(1)[:, None] + xn[None] - 2.0 * (qd @ xd.T)
        if allowed is not None:
            d = torch.where(allowed[None], d, float("inf"))
        v, j = torch.topk(d, k, dim=1, largest=False)
        ds.append(v.cpu())
        ids.append(j.cpu())
    return torch.cat(ds).numpy(), torch.cat(ids).numpy()


def timed_query(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def unpacked_phase(index, vecs, gt) -> dict:
    """Layer 0 without the pack: ef 64 (min_nn=64) at query_expand=4, the
    bench's graph(ef=64) setting, through knn_search."""
    p = index._params
    keep = (p.pack_queries, p.min_nn)
    p.pack_queries, p.min_nn = "off", 64
    try:
        _, first_s = timed_query(lambda: index.knn_query(vecs[:NQ], 10))
        (qi, qd), s = timed_query(lambda: index.knn_query(vecs[:NQ], 10))
        # the graph search alone (ids back on the host), without the
        # float64 refine of its 64 candidates a query
        _, search_s = timed_query(
            lambda: index._impl._search_ids(vecs[:NQ], 64, 0))
    finally:
        p.pack_queries, p.min_nn = keep
    check_answers("unpacked layer 0", qi, qd, NQ, vecs.shape[0])
    recall = recall_at_10(qi[:1000], gt)
    print(f"unpacked layer 0: {NQ} x k=10 ef=64 first call {first_s:.2f} s; "
          f"steady {NQ / s:.1f} q/s ({s:.3f} s, of which the search "
          f"{search_s:.3f} s); recall@10 {recall:.4f}", flush=True)
    if recall < 0.87:
        fail(f"unpacked layer-0 recall@10 {recall} < 0.87")
    return dict(first_s=first_s, queries_per_s=NQ / s, seconds=s,
                search_s=search_s, recall_at_10=recall)


def layer1_phase(index, vecs, xd) -> dict:
    """knn_query at layer 1: every id has level >= 1, distances ascending
    and equal to the direct formula; recall against the exact top-10 over
    the level >= 1 rows, on the card."""
    impl = index._impl
    q = vecs[:NQ_SMALL]
    (qi, qd), s = timed_query(lambda: index.knn_query(q, 10, layer=1))
    lvl = impl._state.level.cpu().numpy()
    if (qi < 0).any() or (lvl[qi] < 1).any():
        fail("layer 1: an id of level 0 (or padding) came back")
    direct = ((vecs[qi].astype(np.float64)
               - q[:, None, :].astype(np.float64)) ** 2).sum(-1)
    if (np.diff(qd, axis=1) < 0).any() or \
            not np.allclose(qd, direct, rtol=1e-5, atol=1e-5):
        fail("layer 1: distances not ascending or not the direct formula")
    allowed = impl._state.level[:vecs.shape[0]] >= 1
    _, gt1 = exact_topk(xd, q, 10, allowed)
    recall = recall_at_10(qi, gt1)
    n1 = int(allowed.sum())
    print(f"layer 1: {NQ_SMALL} x k=10 over {n1} rows of level >= 1, "
          f"{NQ_SMALL / s:.1f} q/s; recall@10 {recall:.4f}", flush=True)
    return dict(rows=n1, queries_per_s=NQ_SMALL / s, recall_at_10=recall)


def k1_exact_shape(what: str, ct, norms, active, qrows: np.ndarray) -> dict:
    """K1 as the exact query launches it (B=1,024 queries, EXACT_LANES
    lanes, no exclusion) on a coarse table ``ct`` and its norms and live
    mask, held against its plain version with the kernel phase's bars and
    timed beside it."""
    import torch
    from hnswindex_torch.index import EXACT_LANES
    from hnswindex_torch.ops import fused_scan as FS

    mult, bias = FS.rank_transform("sq_euclid", norms, active)
    q = torch.as_tensor(qrows, device="cuda")
    B = q.shape[0]
    excl = torch.full((B,), -1, dtype=torch.int32, device="cuda")
    kv, ki = FS.lane_min_scan(ct, mult, bias, q, excl, BS=EXACT_LANES)
    rv, ri = FS.lane_min_scan_ref(ct, mult, bias, q, excl, BS=EXACT_LANES)
    live = rv < FS.DEAD
    err = (kv[live] - rv[live]).abs()
    agree = (ki[live] == ri[live]).float().mean().item()
    if not torch.equal(kv < FS.DEAD, live) or agree < 0.999 or \
            bool((err > 1e-4 + 1e-4 * rv[live].abs()).any()):
        fail(f"K1 at the {what}: max abs err {err.max().item()}, id "
             f"agreement {agree}")
    ms = time_ms(lambda: FS.lane_min_scan(ct, mult, bias, q, excl,
                                          BS=EXACT_LANES), 10)
    plain_ms = time_ms(lambda: FS.lane_min_scan_ref(ct, mult, bias, q, excl,
                                                    BS=EXACT_LANES), 3)
    C = ct.shape[0]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (ct, mult, bias, q, excl, kv, ki))
    k1 = dict(C=C, B=B, BS=EXACT_LANES, max_abs_err=err.max().item(),
              id_agree=agree, ms=ms, plain_ms=plain_ms, library_ms=None,
              **bound(2.0 * B * C * D, PEAK_BF16, nbytes))
    print(f"kernel phase K1 {what} C={C} B={B} D={D} BS={EXACT_LANES}: "
          f"max_abs_err={k1['max_abs_err']:.3e} id_agree={agree:.6f} kernel "
          f"{ms:.3f} ms ({ms / B * 1e3:.2f} us a query) plain "
          f"{plain_ms:.3f} ms bound {k1['bound_ms']:.4f} ms "
          f"({k1['bound_by']})", flush=True)
    return k1


def exact_phase(index, vecs, gt, xd) -> dict:
    """knn_query(exact=True): k=10 through the lane-min kernel (counted),
    then K1 held against its plain version on this path's own inputs and
    timed; k=300 through the panel branch (no launch)."""
    import torch
    from hnswindex_torch.index import EXACT_LANES
    from hnswindex_torch.ops import bruteforce as BF
    from hnswindex_torch.ops import fused_scan as FS

    FS.lane_min_scan.launches = 0
    (qi, qd), s = timed_query(
        lambda: index.knn_query(vecs[:NQ], 10, exact=True))
    launches = FS.lane_min_scan.launches
    check_answers("exact", qi, qd, NQ, vecs.shape[0])
    recall = recall_at_10(qi[:1000], gt)
    print(f"exact: {NQ} x k=10 {NQ / s:.1f} q/s; lane_min_scan launches "
          f"{launches}; recall@10 {recall:.4f}", flush=True)
    if launches <= 0:
        fail("the exact query never launched the lane-min kernel")
    if recall < 0.99:
        fail(f"exact recall@10 {recall} < 0.99")

    # the same 1,000 queries at the reference's 1,024 lanes, for the record
    # (after the count was read)
    st = index._impl._state
    _, ids1024 = BF.exact_knn2("sq_euclid", st.vectors, st.coarse_table,
                               st.norms, st.active,
                               torch.as_tensor(vecs[:1000], device="cuda"),
                               10, lanes=BF.FUSED_BS)
    recall1024 = recall_at_10(ids1024.cpu().numpy(), gt)
    print(f"exact: recall@10 of the same scan at {BF.FUSED_BS} lanes "
          f"{recall1024:.4f}, at {EXACT_LANES} lanes {recall:.4f}",
          flush=True)

    k1 = k1_exact_shape("exact-query shape", st.coarse_table, st.norms,
                        st.active, vecs[:1024])

    n0 = FS.lane_min_scan.launches
    q300 = vecs[:100]
    (pi, pd), s300 = timed_query(
        lambda: index.knn_query(q300, 300, exact=True))
    if FS.lane_min_scan.launches != n0:
        fail("k=300 (the panel branch) launched the lane-min kernel")
    if (pi < 0).any() or (np.diff(pd, axis=1) < 0).any():
        fail("exact k=300: padding or distances not ascending")
    _, gt300 = exact_topk(xd, q300, 300)
    recall300 = recall_at_10(pi, gt300)
    print(f"exact k=300 (panel branch): 100 queries {100 / s300:.1f} q/s; "
          f"recall@300 {recall300:.5f}", flush=True)
    if recall300 < 0.999:
        fail(f"exact recall@300 {recall300} < 0.999")
    return dict(queries_per_s=NQ / s, recall_at_10=recall, launches=launches,
                recall_at_10_1024_lanes=recall1024, k1_exact_shape=k1,
                k300_queries_per_s=100 / s300, recall_at_300=recall300)


def range_phase(index, vecs, xd) -> dict:
    """range_query at the median exact 10th-neighbour distance: distances
    <= radius and ascending, no duplicate ids; recall of the in-radius
    sets against an exact in-radius scan on the card."""
    import torch
    q = vecs[:NQ_SMALL]
    d10, _ = exact_topk(xd, q, 10)
    radius = float(np.median(d10[:, 9]))
    (ri, rd), s = timed_query(lambda: index.range_query(q, radius))
    if len(ri) != NQ_SMALL:
        fail("range_query returned the wrong number of rows")
    xn = (xd * xd).sum(1)
    hit = tot = 0
    for r in range(NQ_SMALL):
        if (rd[r] > radius).any() or (np.diff(rd[r]) < 0).any() or \
                len(set(ri[r].tolist())) != ri[r].size:
            fail(f"range_query row {r}: distance past the radius, not "
                 "ascending, or a duplicate id")
        qd = torch.as_tensor(q[r], device="cuda")
        d = (qd * qd).sum() + xn - 2.0 * (xd @ qd)
        want = set(torch.nonzero(d <= radius).flatten().cpu().tolist())
        hit += len(want & set(ri[r].tolist()))
        tot += len(want)
    recall = hit / max(1, tot)
    sizes = [x.size for x in ri]
    print(f"range: {NQ_SMALL} queries at radius {radius:.5f} (median exact "
          f"10th-neighbour distance), {NQ_SMALL / s:.1f} q/s; result sizes "
          f"mean {np.mean(sizes):.1f} max {max(sizes)}; recall of the "
          f"in-radius sets {recall:.4f}", flush=True)
    return dict(radius=radius, queries_per_s=NQ_SMALL / s,
                mean_size=float(np.mean(sizes)), max_size=int(max(sizes)),
                recall=recall)


def multi_layer_phase(index, vecs) -> dict:
    """multi_layer_knn_query on 8 single queries: a list indexed by layer
    whose ids at layer l have level >= l."""
    lvl = index._impl._state.level.cpu().numpy()
    t0 = time.perf_counter()
    tops = []
    for r in range(8):
        res = index.multi_layer_knn_query(vecs[r], 10)
        if not res or any(x is None for x in res):
            fail("multi_layer_knn_query: empty or a layer without a result")
        for layer, (ids, ds) in enumerate(res):
            if (lvl[ids] < layer).any() or (np.diff(ds) < 0).any():
                fail(f"multi_layer_knn_query: layer {layer} returned a "
                     "lower-level id or unsorted distances")
        tops.append(len(res) - 1)
    s = time.perf_counter() - t0
    print(f"multi-layer: 8 queries, top layers {tops}, {8 / s:.1f} q/s",
          flush=True)
    return dict(top_layers=tops, queries_per_s=8 / s)


def check_filtered(what: str, qi, qd, q: np.ndarray, vecs: np.ndarray,
                   allowed: np.ndarray) -> None:
    """Every id passes the filter, distances ascending and equal to the
    direct formula."""
    if (qi < 0).any() or not allowed[qi].all():
        fail(f"{what}: padding or an id the filter does not allow")
    direct = ((vecs[qi].astype(np.float64)
               - q[:, None, :].astype(np.float64)) ** 2).sum(-1)
    if (np.diff(qd, axis=1) < 0).any() or \
            not np.allclose(qd, direct, rtol=1e-5, atol=1e-5):
        fail(f"{what}: distances not ascending or not the direct formula")


def filter_phase(index, vecs, xd) -> dict:
    """Filters on the 1M index: a seeded 50% id mask on the packed,
    unpacked (ef 64) and exact paths, and a vectorizable callable (column 0
    above its median) on the packed path; recall@10 against the exact
    top-10 over the allowed rows on the card."""
    import torch
    from hnswindex_torch.ops import fused_scan as FS

    impl = index._impl
    n = vecs.shape[0]
    q = vecs[:NQ_SMALL]
    allowed = np.random.default_rng(SEED + 7).random(n) < 0.5
    fmask = np.zeros(impl._state.capacity, bool)
    fmask[:n] = allowed
    _, gt = exact_topk(xd, q, 10, torch.as_tensor(allowed, device="cuda"))
    out = {}

    def run(name, fn, bar):
        (qi, qd), s = timed_query(fn)
        check_filtered(f"filtered {name}", qi, qd, q, vecs, allowed)
        rec = recall_at_10(qi, gt)
        out[name] = dict(queries_per_s=NQ_SMALL / s, recall_at_10=rec)
        print(f"filtered {name}: {NQ_SMALL} x k=10, {NQ_SMALL / s:.1f} q/s; "
              f"recall@10 {rec:.4f}", flush=True)
        if rec < bar:
            fail(f"filtered {name} recall@10 {rec} < {bar}")

    print(f"filters: a seeded 50% id mask ({int(allowed.sum())} rows "
          f"allowed), then a callable", flush=True)
    run("packed", lambda: index.knn_query(q, 10, filter_fnc=fmask), 0.80)
    p = index._params
    keep = (p.pack_queries, p.min_nn)
    p.pack_queries, p.min_nn = "off", 64
    try:
        run("unpacked ef=64",
            lambda: index.knn_query(q, 10, filter_fnc=fmask), 0.80)
    finally:
        p.pack_queries, p.min_nn = keep
    FS.lane_min_scan.launches = 0
    run("exact", lambda: index.knn_query(q, 10, filter_fnc=fmask,
                                         exact=True), 0.99)
    out["exact"]["launches"] = FS.lane_min_scan.launches
    print(f"filtered exact: lane_min_scan launches "
          f"{out['exact']['launches']}", flush=True)
    if out["exact"]["launches"] <= 0:
        fail("the filtered exact query never launched the lane-min kernel")

    # a callable on a stored vector, vectorizable over rows: column 0 above
    # its median.  Column 0 follows the cluster centres, so half the query
    # rows sit in a cluster that fails it and their passing neighbours lie
    # past their own cluster, deep in the unfiltered order, where widening
    # beams keep missing a few (the reference reads 0.9868 from ef 64 at
    # 10,000 rows on the CPU, tests/torch_recall_study.py): the packed path
    # (ef from 64) is held to 0.97 and its recall at other widths printed;
    # with
    # exact=True the same callable runs the exact scan that the widening
    # escalates to (K1, counted), held to 0.99
    med = float(np.median(vecs[:, 0]))
    allowed = vecs[:, 0] > med
    _, gt = exact_topk(xd, q, 10, torch.as_tensor(allowed, device="cuda"))

    def pred(v):
        return np.asarray(v)[..., 0] > med

    p.min_nn = 64
    try:
        run("callable", lambda: index.knn_query(q, 10, filter_fnc=pred),
            0.97)
        for mn in (keep[1], 1024):
            p.min_nn = mn
            qi, _ = index.knn_query(q, 10, filter_fnc=pred)
            rec = recall_at_10(qi, gt)
            out["callable"][f"recall_at_10_min_nn_{mn}"] = rec
            print(f"filtered callable at min_nn={mn}: recall@10 {rec:.4f}",
                  flush=True)
    finally:
        p.min_nn = keep[1]
    FS.lane_min_scan.launches = 0
    run("callable exact", lambda: index.knn_query(q, 10, filter_fnc=pred,
                                                  exact=True), 0.99)
    out["callable exact"]["launches"] = FS.lane_min_scan.launches
    print(f"filtered callable exact: lane_min_scan launches "
          f"{out['callable exact']['launches']}", flush=True)
    if out["callable exact"]["launches"] <= 0:
        fail("the callable's exact scan never launched the lane-min kernel")
    return out


def live_recall(index, q: np.ndarray, k: int = 10) -> float:
    """Packed recall@k of ``q`` against the exact top-k over the index's
    live rows, on the card."""
    st = index._impl._state
    ids, _ = index.knn_query(q, k)
    _, gt = exact_topk(st.vectors, q, k, st.active)
    return recall_at_10(ids, gt)


def edges_into_removed(st) -> int:
    """Edges of live rows that point to inactive rows, over every layer."""
    bad = 0
    C = st.capacity
    for layer in range(st.num_levels):
        nbr = st.nbr0 if layer == 0 else st.nbru[layer - 1]
        ok = nbr >= 0
        tgt_live = st.active[nbr.long().clamp(0, C - 1)]
        bad += int((ok & ~tgt_live & st.active[:, None]).sum())
    return bad


def churn_phases(index, vecs) -> dict:
    """On the 1M index after its query phases: a bulk removal of 100,000
    seeded ids (the entry point among them), a re-add of 10,000 fresh rows
    into the freed slots, an update of 10,000 surviving rows, and packed
    recall after the churn."""
    import torch
    from hnswindex_torch.core.remove import resolve_quality
    from hnswindex_torch.ops import fused_scan as FS
    from hnswindex_torch.ops import repair_scan as RS

    impl = index._impl
    n = vecs.shape[0]
    rng = np.random.default_rng(SEED + 8)
    drop = rng.choice(n, N_REMOVE, replace=False)
    ep = int(impl._state.ep)
    if ep not in drop:
        drop[0] = ep
    dropped = np.zeros(n, bool)
    dropped[drop] = True
    probe = rng.permutation(np.flatnonzero(~dropped))[:NQ_SMALL]
    pre = live_recall(index, vecs[probe])

    before = impl.timer.seconds()
    K3.start()
    k4_0 = RS.repair_scan.calls
    (_, s) = timed_query(lambda: index.remove(drop))
    k4 = RS.repair_scan.calls - k4_0
    after = impl.timer.seconds()
    split = {k: after.get(k, 0.0) - before.get(k, 0.0)
             for k in ("mark", "affected", "candidates", "repair")}
    st = impl._state
    print(f"removal: {N_REMOVE} ids (the entry point {ep} among them) in "
          f"{s:.2f} s = {N_REMOVE / s:.1f} removals/s; phases "
          + " ".join(f"{k}={v:.2f}s" for k, v in split.items())
          + f"; K4 launches {k4}", flush=True)
    k3 = K3.finish("the removal", timed=True)
    if k3["launches"] <= 0:
        fail("removal: the repair never launched K3")
    if k4 <= 0:
        fail("removal: the candidate scan never launched K4 (capacity "
             f"{st.capacity} is below 2^20)")
    if index.count != n - N_REMOVE or int(st.count) != n - N_REMOVE:
        fail(f"removal: count {index.count} != {n - N_REMOVE}")
    new_ep = int(st.ep)
    if new_ep < 0 or not bool(st.active[new_ep]):
        fail("removal: the entry point is not an active row")
    bad = edges_into_removed(st)
    if bad:
        fail(f"removal: {bad} edges of live rows point to removed rows")
    (qi, _), qs = timed_query(lambda: index.knn_query(vecs[:NQ], 10))
    if np.isin(qi, drop).any():
        fail("removal: a removed id came back from knn_query")
    post = live_recall(index, vecs[probe])
    ratio = post / pre
    print(f"removal: recall@10 of {NQ_SMALL} surviving rows {pre:.4f} -> "
          f"{post:.4f} (ratio {ratio:.4f}); {NQ} queries after it (pack "
          f"rebuilt) {qs:.2f} s, no removed id returned", flush=True)
    if ratio < 0.98:
        fail(f"removal: post/pre recall ratio {ratio} < 0.98")
    out = dict(removed=N_REMOVE, seconds=s, removals_per_s=N_REMOVE / s,
               phases_s=split, recall_pre=pre, recall_post=post,
               ratio=ratio, entry_point=new_ep, k3=k3, k4_launches=k4)

    # re-add: fresh rows take the freed slots, last freed first
    fresh = (vecs[rng.choice(n, N_CHURN, replace=False)]
             + 0.01 * rng.standard_normal((N_CHURN, D)).astype(np.float32))
    expect = np.asarray(impl._free[::-1][:N_CHURN], np.int32)
    FS.lane_min_scan.launches = 0
    K3.start()
    new_ids, s = timed_query(lambda: index.add(fresh))
    launches = FS.lane_min_scan.launches
    k3 = K3.finish("the re-add")
    if not np.array_equal(new_ids, expect):
        fail("re-add: the ids are not the freed slots in LIFO order")
    found = index.knn_query(fresh, 1)[0][:, 0]
    self_rec = float((found == new_ids).mean())
    print(f"re-add: {N_CHURN} rows into freed slots in {s:.2f} s = "
          f"{N_CHURN / s:.1f} inserts/s; recall@1 on themselves "
          f"{self_rec:.4f}; lane_min_scan launches {launches}", flush=True)
    if self_rec < 0.90 or launches <= 0 or k3["launches"] <= 0:
        fail(f"re-add: recall@1 {self_rec} or no lane-min or K3 launch")
    out["readd"] = dict(inserts_per_s=N_CHURN / s, recall_at_1=self_rec,
                        launches=launches, k3=k3)

    # update: surviving rows move by the generator's own noise
    live = np.flatnonzero(st.active.cpu().numpy())
    upd = np.sort(rng.choice(live, N_CHURN, replace=False)).astype(np.int32)
    moved = (impl._mirror.rows(upd)
             + 0.03 * rng.standard_normal((N_CHURN, D)).astype(np.float32))
    ids_before = index.ids()
    inner = resolve_quality(impl.params.remove_quality, N_CHURN, index.count)
    FS.lane_min_scan.launches = 0
    K3.start()
    k4_0 = RS.repair_scan.calls
    _, s = timed_query(lambda: impl.update(upd, moved))
    launches = FS.lane_min_scan.launches
    k4 = RS.repair_scan.calls - k4_0
    k3 = K3.finish("the update")
    if not np.array_equal(index.ids(), ids_before) or \
            index.count != n - N_REMOVE + N_CHURN:
        fail("update: the ids or the count changed")
    items = index.items()
    if not np.array_equal(items[np.searchsorted(ids_before, upd)], moved):
        fail("update: items() does not show the new vectors")
    # the moved rows sit on their clusters' rims (twice the generator's
    # variance about the centre), where a beam as narrow as the default
    # ef misses many, in the reference alike (0.748 at ef 5 at 10,000 rows
    # on the CPU, tests/torch_recall_study.py): recall@1 is held to 0.85 at
    # ef 64 (the unpacked phase's width) and printed at the other widths
    rec1 = {}
    keep = impl.params.min_nn
    try:
        for mn in (keep, 64, 256):
            impl.params.min_nn = mn
            found = index.knn_query(moved, 1)[0][:, 0]
            rec1[mn] = float((found == upd).mean())
    finally:
        impl.params.min_nn = keep
    print(f"update: {N_CHURN} rows in {s:.2f} s = {N_CHURN / s:.1f} rows/s "
          f"(inner removal \"{inner}\"); recall@1 by the new vectors "
          + ", ".join(f"{v:.4f} at min_nn={k}" for k, v in rec1.items())
          + f"; lane_min_scan launches {launches}, K4 launches {k4}",
          flush=True)
    if rec1[64] < 0.85 or launches <= 0 or k3["launches"] <= 0 or k4 <= 0:
        fail(f"update: recall@1 {rec1[64]} at min_nn=64 or no lane-min, "
             "K3 or K4 launch")
    out["update"] = dict(rows_per_s=N_CHURN / s, recall_at_1=rec1,
                         launches=launches, inner_quality=inner, k3=k3,
                         k4_launches=k4)

    rec = live_recall(index, vecs[probe])
    print(f"after the churn: packed recall@10 of {NQ_SMALL} live rows "
          f"{rec:.4f}", flush=True)
    if rec < 0.90:
        fail(f"after the churn: recall@10 {rec} < 0.90")
    out["recall_after_churn"] = rec
    torch.cuda.empty_cache()
    return out


def block_router_phase(vecs: np.ndarray, gt: np.ndarray,
                       exact_qs: float) -> dict:
    """BlockIndex(router="hnsw") on the 1M corpus: routed by a graph over
    the centroids; then 10,000 rows added and 10,000 removed, after which
    the router is rebuilt before the next query."""
    import torch
    import hnswindex_torch
    from hnswindex_torch.ops import block_scores as TBS

    n = vecs.shape[0]
    bix = hnswindex_torch.BlockIndex(D, "sq_euclid", block_size=K2_BS,
                                     router="hnsw", device="cuda")
    TBS.block_scores.launches = 0
    _, build_s = timed_query(lambda: bix.build(vecs))
    bix.knn_query(vecs[:K2_B], 10, n_probe=K2_P)             # warm up
    (qi, qd), s = timed_query(lambda: bix.knn_query(vecs[:NQ], 10,
                                                    n_probe=K2_P))
    check_answers("hnsw router", qi, qd, NQ, n)
    recall = recall_at_10(qi[:1000], gt)
    print(f"hnsw router: {n} rows in {bix.n_blocks} blocks, build (layout "
          f"+ centroid graph of {bix._router_index.count}) {build_s:.2f} s; "
          f"{NQ} x k=10 n_probe={K2_P} {NQ / s:.1f} q/s (exact router "
          f"{exact_qs:.1f}); recall@10 {recall:.4f}", flush=True)
    if recall < 0.90:
        fail(f"hnsw router recall@10 {recall} < 0.90")

    rng = np.random.default_rng(SEED + 9)
    fresh = (vecs[rng.choice(n, N_CHURN, replace=False)]
             + 0.01 * rng.standard_normal((N_CHURN, D)).astype(np.float32))
    new_ids = bix.add(fresh)
    drop = rng.choice(np.arange(NQ, n), N_CHURN, replace=False)
    bix.remove(drop)
    if not bix._router_dirty:
        fail("hnsw router: churn did not mark the router for a rebuild")
    (qi2, _), s2 = timed_query(lambda: bix.knn_query(vecs[:1000], 10,
                                                     n_probe=K2_P))
    live_blocks = int((bix._h_fill > 0).sum())
    if bix._router_dirty or bix._router_index.count != live_blocks:
        fail("hnsw router: not rebuilt over the live blocks")
    alive = np.ones(n + N_CHURN, bool)
    alive[drop] = False
    both = torch.as_tensor(np.concatenate([vecs, fresh]), device="cuda")
    _, gt2 = exact_topk(both, vecs[:1000], 10,
                        torch.as_tensor(alive, device="cuda"))
    recall2 = recall_at_10(qi2, gt2)
    launches = TBS.block_scores.launches
    print(f"hnsw router churn: add {N_CHURN} (ids from {new_ids.min()}), "
          f"remove {N_CHURN}; router rebuilt over {live_blocks} live blocks "
          f"with the next query ({s2:.2f} s for 1000 queries); recall@10 "
          f"{recall2:.4f}; block_scores launches {launches}", flush=True)
    if recall2 < 0.90:
        fail(f"hnsw router recall@10 after churn {recall2} < 0.90")
    if launches <= 0:
        fail("the hnsw router path never launched the block-scores kernel")
    return dict(build_s=build_s, queries_per_s=NQ / s, recall_at_10=recall,
                recall_after_churn=recall2, launches=launches)


def beam_build(vecs: np.ndarray) -> dict:
    """A 200,000-row build whose waves past 20,000 rows take the beam
    path; packed and unpacked k=10 recall against the exact top-10 within
    those rows."""
    import torch
    import hnswindex_torch

    sub = vecs[:N_BEAM]
    index = hnswindex_torch.Index(D, "sq_euclid", device="cuda")
    index.set_collection_size(N_BEAM)
    index._params.exact_build_threshold = BEAM_THRESHOLD
    K3.start()
    _, build_s = timed_query(lambda: index.add(sub))
    impl = index._impl
    waves = dict(impl.wave_counts)
    phases = impl.timer.seconds()
    if index.count != N_BEAM or waves["beam"] <= 0:
        fail("beam-path build: rows missing or no wave took the beam path")
    split = " ".join(f"{k}={v:.2f}s" for k, v in sorted(phases.items()))
    print(f"beam-path build: {N_BEAM} rows in {build_s:.2f} s = "
          f"{N_BEAM / build_s:.1f} inserts/s; waves exact {waves['exact']} "
          f"beam {waves['beam']}; phases {split}", flush=True)
    k3 = K3.finish("the beam-path build")
    if k3["launches"] <= 0:
        fail("beam-path build: no K3 launch")
    xd = torch.as_tensor(sub, device="cuda")
    _, gt = exact_topk(xd, sub[:1000], 10)
    (qi, qd), s = timed_query(lambda: index.knn_query(sub[:NQ], 10))
    check_answers("beam-path build", qi, qd, NQ, N_BEAM)
    recall = recall_at_10(qi[:1000], gt)
    p = index._params
    p.pack_queries, p.min_nn = "off", 64
    (ui, _), us = timed_query(lambda: index.knn_query(sub[:1000], 10))
    urecall = recall_at_10(ui, gt)
    print(f"beam-path build queries: packed {NQ} x k=10 {NQ / s:.1f} q/s "
          f"(with pack build) recall@10 {recall:.4f}; unpacked ef=64 "
          f"recall@10 {urecall:.4f}", flush=True)
    if recall < 0.90:
        fail(f"beam-path build recall@10 {recall} < 0.90")
    impl._pack = None                       # kept for the last phases
    return dict(build_s=build_s, inserts_per_s=N_BEAM / build_s,
                waves=waves, phases_s=phases, recall_at_10=recall,
                unpacked_recall_at_10=urecall, k3=k3), index, gt


def median_rule(v: np.ndarray) -> int:
    """The reference's median of integer degrees (HNSWInfo.cs:45-51)."""
    s = np.sort(v)
    n = s.size
    return int(s[n // 2]) if n % 2 else int((s[n // 2 - 1] + s[n // 2]) // 2)


def stats_phase(index, what: str) -> dict:
    """``get_info()`` and ``get_connected_component_counts()`` on the 1M
    index, each held against a recomputation from its tables read to the
    host: numpy ``bincount`` for the degrees, scipy's weak components over
    the active rows of each layer."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    impl = index._impl
    info, info_s = timed_query(index.get_info)
    comps, comp_s = timed_query(index.get_connected_component_counts)
    st = impl._state
    C = st.capacity
    act = st.active.cpu().numpy()
    lvl = st.level.cpu().numpy()
    top = int(lvl[int(st.ep)])
    if len(comps) != top + 1 or len(info.layers) != top + 1:
        fail(f"stats {what}: {len(info.layers)} info layers and "
             f"{len(comps)} component counts for top layer {top}")
    for layer in range(top + 1):
        nbr = (st.nbr0 if layer == 0 else st.nbru[layer - 1]).cpu().numpy()
        deg = (st.deg0 if layer == 0 else st.degu[layer - 1]).cpu().numpy()
        on = act & (lvl >= layer)
        rows = np.flatnonzero(on)
        e = nbr[rows]
        src = np.repeat(rows, (e >= 0).sum(1))
        dst_ = e[e >= 0].astype(np.int64)
        indeg = np.bincount(dst_, minlength=C)[rows]
        od = deg[rows].astype(np.int64)
        want = dict(layer_id=layer, nodes_count=int(rows.size),
                    max_out_edges=int(od.max()), min_out_edges=int(od.min()),
                    max_in_edges=int(indeg.max()),
                    min_in_edges=int(indeg.min()),
                    avg_out_edges=int(od.sum()) / rows.size,
                    avg_in_edges=int(indeg.sum()) / rows.size,
                    out_edges_median=median_rule(od),
                    in_edges_median=median_rule(indeg))
        got = vars(info.layers[layer])
        if got != want:
            fail(f"stats {what}: layer {layer} get_info {got} != {want}")
        both = on[dst_]
        g = csr_matrix((np.ones(int(both.sum()), np.int8),
                        (src[both], dst_[both])), shape=(C, C))
        n_comp = connected_components(g[rows][:, rows], directed=True,
                                      connection="weak")[0]
        if comps[layer] != n_comp:
            fail(f"stats {what}: layer {layer} has {comps[layer]} "
                 f"components, scipy finds {n_comp}")
    print(f"stats {what}: get_info {info_s:.3f} s, connected components "
          f"{comp_s:.3f} s ({top + 1} layers; nodes "
          f"{[x.nodes_count for x in info.layers]}; components {comps}); "
          f"equal to numpy bincount and scipy weak components", flush=True)
    return dict(info_s=info_s, components_s=comp_s, components=comps,
                nodes=[x.nodes_count for x in info.layers])


def snapshot_phase(index, vecs: np.ndarray) -> dict:
    """``serialize`` of the churned 1M index and ``deserialize`` on the
    card: identical answers to 1,000 queries; then the same 1,000 new rows
    added to both take the same freed slots with the same levels (the load
    re-seeds the level RNG from ``random_seed``, as the reference's does,
    so the original is re-seeded alike before its add)."""
    import os
    import tempfile
    import torch
    import hnswindex_torch

    impl = index._impl
    q = vecs[:NQ_SMALL] + 0.01
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "index.npz")
        _, write_s = timed_query(lambda: impl.serialize(path))
        nbytes = os.path.getsize(path)
        loaded, read_s = timed_query(
            lambda: hnswindex_torch.HNSWIndex.deserialize(
                path, device=impl.device))
    a, b = impl.knn_query(q, 10), loaded.knn_query(q, 10)
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        fail("snapshot: the loaded index answers differently")
    rng = np.random.default_rng(SEED + 10)
    fresh = (vecs[rng.choice(vecs.shape[0], NQ_SMALL, replace=False)]
             + 0.01 * rng.standard_normal((NQ_SMALL, D)).astype(np.float32))
    impl._rng = np.random.default_rng(impl.params.random_seed)
    ids_a, ids_b = impl.add(fresh), loaded.add(fresh)
    ta = torch.as_tensor(ids_a.astype(np.int64), device=impl.device)
    same_levels = bool((impl._state.level[ta]
                        == loaded._state.level[ta]).all())
    if not np.array_equal(ids_a, ids_b) or not same_levels:
        fail("snapshot: an add after the load took other ids or levels")
    found = loaded.knn_query(fresh, 1)[0][:, 0]
    self_rec = float((found == ids_b).mean())
    print(f"snapshot: {impl.count - NQ_SMALL} rows and {len(impl._free)} "
          f"free slots left after the add; write {write_s:.2f} s, read {read_s:.2f} "
          f"s, {nbytes} bytes; {NQ_SMALL} queries answered identically; "
          f"{NQ_SMALL} rows added to both took the same ids and levels "
          f"(recall@1 on themselves {self_rec:.4f})", flush=True)
    if self_rec < 0.90:
        fail(f"snapshot: recall@1 of the added rows {self_rec} < 0.90")
    del loaded
    torch.cuda.empty_cache()
    return dict(write_s=write_s, read_s=read_s, bytes=nbytes,
                recall_at_1_added=self_rec)


def refsnap_phase(index, gt: np.ndarray) -> dict:
    """``to_reference_snapshot`` of the 200k beam-path index and
    ``from_reference_snapshot`` on the card: packed recall@10 of 1,000
    queries no more than 0.005 below the live index's, a second export of
    the loaded index byte for byte the first; then the golden stream of
    the repo's tests."""
    import os
    import tempfile
    import hnswindex_torch

    impl = index._impl
    sub_q = impl._mirror.rows(np.arange(NQ_SMALL))
    p = impl.params
    p.pack_queries, p.min_nn = "auto", hnswindex_torch.HNSWParameters().min_nn
    live = recall_at_10(impl.knn_query(sub_q, 10)[0], gt)
    over = int((impl._state.deg0[:impl._length]
                > 2 * impl.params.max_edges).sum())
    K3.start()
    with tempfile.TemporaryDirectory() as d:
        p1, p2 = os.path.join(d, "a.bin"), os.path.join(d, "b.bin")
        _, out_s = timed_query(lambda: impl.to_reference_snapshot(p1))
        loaded, in_s = timed_query(
            lambda: hnswindex_torch.HNSWIndex.from_reference_snapshot(
                p1, device=impl.device))
        loaded.to_reference_snapshot(p2)
        with open(p1, "rb") as f1, open(p2, "rb") as f2:
            same = f1.read() == f2.read()
        nbytes = os.path.getsize(p1)
    k3 = K3.finish(f"the reference export ({over} layer-0 rows over the "
                   "2M cap)")
    if (k3["launches"] > 0) != (over > 0):
        fail(f"reference snapshot: {k3['launches']} K3 launches for {over} "
             "rows over the cap")
    rec = recall_at_10(loaded.knn_query(sub_q, 10)[0], gt)
    print(f"reference snapshot: {impl.count} rows, {nbytes} bytes; export "
          f"{out_s:.2f} s, import {in_s:.2f} s; recall@10 live {live:.4f} "
          f"loaded {rec:.4f}; second export identical: {same}", flush=True)
    # the export re-prunes layer-0 rows over the 2M cap, where the live
    # pack cuts them at 2M unpruned: recall may rise, and must not fall
    if rec < live - 0.005 or not same:
        fail("reference snapshot: recall fell or the second export "
             "differs")
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures")
    exp = np.load(os.path.join(here, "refsnap_golden_expected.npz"))
    gold = hnswindex_torch.HNSWIndex.from_reference_snapshot(
        os.path.join(here, "refsnap_golden.bin"), device=impl.device)
    gi, gd = gold.knn_query(exp["queries"], k=5)
    if gold.count != int(exp["count"]) or not np.array_equal(
            gi, exp["ids"]) or not np.allclose(gd, exp["dists"], rtol=1e-6,
                                               atol=0, equal_nan=True):
        fail("reference snapshot: the golden stream loads differently")
    print("reference snapshot: the golden stream loads as its expected "
          "ids and distances", flush=True)
    return dict(export_s=out_s, import_s=in_s, bytes=nbytes,
                recall_live=live, recall_loaded=rec, over_cap=over, k3=k3)


def custom_metric_phase(vecs: np.ndarray, device: str = "cuda") -> dict:
    """L1 registered as a torch callable; the first 200,000 rows built
    under it (every wave after the seed on the beam path) and served
    through the packed engine at ef 16 and 32, recall@10 against an exact
    L1 scan on the card; ``exact=True`` must raise."""
    import torch
    import hnswindex_torch

    hnswindex_torch.register_metric(
        "l1", lambda a, b: torch.sum(torch.abs(a - b), dim=-1))
    sub = vecs[:N_CUSTOM]
    index = hnswindex_torch.Index(D, "l1", device=device)
    index.set_collection_size(N_CUSTOM)
    K3.start()
    _, build_s = timed_query(lambda: index.add(sub))
    impl = index._impl
    waves = dict(impl.wave_counts)
    if index.count != N_CUSTOM or waves["exact"] != 0:
        fail(f"custom metric: count {index.count}, waves {waves}")
    phases = impl.timer.seconds()
    split = " ".join(f"{k}={v:.2f}s" for k, v in sorted(phases.items()))
    print(f"custom metric (L1): {N_CUSTOM} rows in {build_s:.2f} s = "
          f"{N_CUSTOM / build_s:.1f} inserts/s; waves {waves}; phases "
          f"{split}", flush=True)
    k3 = K3.finish("the L1 build")
    if k3["launches"] <= 0:
        fail("custom metric: no K3 launch")
    xd = torch.as_tensor(sub, device=device)
    q = sub[:NQ_SMALL]
    gt = torch.cat([torch.topk(torch.cdist(
        torch.as_tensor(q[i:i + 250], device=device), xd, p=1), 10,
        dim=1, largest=False).indices.cpu()
        for i in range(0, NQ_SMALL, 250)]).numpy()
    out = dict(build_s=build_s, inserts_per_s=N_CUSTOM / build_s,
               waves=waves, phases_s=phases, k3=k3)
    for ef in (16, 32):
        impl.params.min_nn = ef
        (qi, qd), s = timed_query(lambda: index.knn_query(q, 10))
        check_answers(f"custom metric ef {ef}", qi, qd, NQ_SMALL, N_CUSTOM)
        direct = np.abs(sub[qi[:50]] - q[:50, None]).sum(-1)
        if not np.allclose(qd[:50], direct, rtol=1e-4):
            fail("custom metric: distances differ from the callable's")
        out[f"recall_at_10_ef{ef}"] = recall_at_10(qi, gt)
        out[f"seconds_ef{ef}"] = s
        print(f"custom metric: {NQ_SMALL} x k=10 at ef {ef} (packed: "
              f"{impl._pack is not None}) {s:.2f} s = {NQ_SMALL / s:.1f} "
              f"q/s, recall@10 {out[f'recall_at_10_ef{ef}']:.4f}",
              flush=True)
    if impl._pack is None:
        fail("custom metric: the pack did not engage")
    if out["recall_at_10_ef32"] < 0.90:
        fail(f"custom metric: recall@10 {out['recall_at_10_ef32']} < 0.90 "
             "at ef 32")
    try:
        index.knn_query(q[:2], 10, exact=True)
        fail("custom metric: exact=True did not raise")
    except ValueError:
        pass
    return out


def sharded_live(six, n: int):
    """The live mask of a sharded index by gid, over gids 0..n-1 (gid =
    corpus row for this build), on the card: gid = slot * S + shard is
    position [slot, shard] of the (C, S) view."""
    import torch
    act = torch.stack([st.active for st in six._states])      # (S, C)
    return act.T.reshape(-1)[:n]


def sharded_build(vecs: np.ndarray, devices) -> tuple:
    """``ShardedIndex`` build of the whole corpus on ``devices``: inserts/s,
    the waves, each shard's phase split and K1's launches in the build."""
    import torch
    from hnswindex_torch import HNSWParameters
    from hnswindex_torch.ops import fused_scan as FS
    from hnswindex_torch.parallel import ShardedIndex

    n = vecs.shape[0]
    six = ShardedIndex(D, "sq_euclid", HNSWParameters(collection_size=n),
                       devices=devices)
    FS.lane_min_scan.launches = 0
    K3.start()
    gids, s = timed_query(lambda: six.add(vecs))
    launches = FS.lane_min_scan.launches
    k3 = K3.finish("the sharded build")
    if k3["launches"] <= 0:
        fail("sharded build: no K3 launch")
    if six.count != n or not np.array_equal(gids, np.arange(n)):
        fail("sharded build: the gids are not the corpus rows")
    phases = [t.seconds() for t in six.timers]
    split = "; ".join(
        f"shard {i}: " + " ".join(f"{k}={ph.get(k, 0.0):.2f}s"
                                  for k in ("scan", "prune", "reverse",
                                            "upper"))
        for i, ph in enumerate(phases))
    print(f"sharded build: {n} rows on {six.n_shards} shards ({devices}), "
          f"capacity {six.shard_capacity} a shard, in {s:.2f} s = "
          f"{n / s:.1f} inserts/s; waves {six.wave_counts}; {split}; "
          f"lane_min_scan launches {launches} (the scan prefix "
          f"{six.shard_capacity} stays under BUILD_SCAN2_MIN)", flush=True)
    torch.cuda.synchronize()
    return six, dict(seconds=s, inserts_per_s=n / s,
                     waves=dict(six.wave_counts),
                     phases_s=phases, launches=launches, k3=k3,
                     shard_capacity=six.shard_capacity)


def sharded_queries(six, vecs: np.ndarray, gt: np.ndarray, xd) -> dict:
    """Packed, unpacked (ef 64), exact (K1 counted and held against its
    plain version on one shard's own inputs), a 50% id mask on the packed
    path and ``range_query`` on the sharded index."""
    import torch
    from hnswindex_torch.ops import fused_scan as FS

    n = vecs.shape[0]
    out = {}
    _, first_s = timed_query(lambda: six.knn_query(vecs[:NQ], 10))
    (qi, qd), qs_s = timed_query(lambda: six.knn_query(vecs[:NQ], 10))
    if six._pack is None or len(six._pack) != six.n_shards:
        fail("sharded packed: the per-shard packs were not built")
    check_answers("sharded packed", qi, qd, NQ, n)
    rec = recall_at_10(qi[:1000], gt)
    out["packed"] = dict(first_s=first_s, queries_per_s=NQ / qs_s,
                         recall_at_10=rec)
    print(f"sharded packed: {NQ} x k=10 first call (with the packs) "
          f"{first_s:.2f} s; steady {NQ / qs_s:.1f} q/s; recall@10 "
          f"{rec:.4f}", flush=True)
    if rec < 0.90:
        fail(f"sharded packed recall@10 {rec} < 0.90")

    p = six.params
    keep = (p.pack_queries, p.min_nn)
    p.pack_queries, p.min_nn = "off", 64
    try:
        (qi, qd), s = timed_query(lambda: six.knn_query(vecs[:NQ], 10))
    finally:
        p.pack_queries, p.min_nn = keep
    check_answers("sharded unpacked", qi, qd, NQ, n)
    rec = recall_at_10(qi[:1000], gt)
    out["unpacked"] = dict(queries_per_s=NQ / s, recall_at_10=rec)
    print(f"sharded unpacked: {NQ} x k=10 ef=64 {NQ / s:.1f} q/s; "
          f"recall@10 {rec:.4f}", flush=True)
    if rec < 0.87:
        fail(f"sharded unpacked recall@10 {rec} < 0.87")

    FS.lane_min_scan.launches = 0
    (qi, qd), s = timed_query(
        lambda: six.knn_query(vecs[:NQ], 10, exact=True))
    launches = FS.lane_min_scan.launches
    check_answers("sharded exact", qi, qd, NQ, n)
    rec = recall_at_10(qi[:1000], gt)
    print(f"sharded exact: {NQ} x k=10 {NQ / s:.1f} q/s; lane_min_scan "
          f"launches {launches}; recall@10 {rec:.4f}", flush=True)
    if launches <= 0:
        fail("the sharded exact query never launched the lane-min kernel")
    if rec < 0.99:
        fail(f"sharded exact recall@10 {rec} < 0.99")
    st = six._states[0]
    ns = six._exact_nscan()
    k1 = k1_exact_shape(f"sharded exact shape (shard 0, prefix {ns})",
                        st.coarse_table[:ns], st.norms[:ns], st.active[:ns],
                        vecs[:1024])
    out["exact"] = dict(queries_per_s=NQ / s, recall_at_10=rec,
                        launches=launches, k1_shard_shape=k1)

    q = vecs[:NQ_SMALL]
    allowed = np.random.default_rng(SEED + 7).random(n) < 0.5
    fmask = np.zeros(six.n_shards * six.shard_capacity, bool)
    fmask[:n] = allowed
    _, gtf = exact_topk(xd, q, 10, torch.as_tensor(allowed, device="cuda"))
    (qi, qd), s = timed_query(lambda: six.knn_query(q, 10, filter_fnc=fmask))
    check_filtered("sharded filtered packed", qi, qd, q, vecs, allowed)
    rec = recall_at_10(qi, gtf)
    out["filtered_packed"] = dict(queries_per_s=NQ_SMALL / s,
                                  recall_at_10=rec)
    print(f"sharded filtered packed (50% id mask): {NQ_SMALL} x k=10 "
          f"{NQ_SMALL / s:.1f} q/s; recall@10 {rec:.4f}", flush=True)
    if rec < 0.80:
        fail(f"sharded filtered packed recall@10 {rec} < 0.80")
    out["range"] = range_phase(six, vecs, xd)
    return out


def sharded_churn(six, vecs: np.ndarray, xd) -> dict:
    """``remove`` of N_SHARD_REMOVE seeded gids (removals/s, no live edge
    into a removed slot, post/pre recall ratio >= 0.98), then ``update`` of
    N_SHARD_UPDATE surviving rows."""
    import torch
    from hnswindex_torch.ops import repair_scan as RS

    n = vecs.shape[0]
    rng = np.random.default_rng(SEED + 11)
    drop = rng.choice(n, N_SHARD_REMOVE, replace=False)
    dropped = np.zeros(n, bool)
    dropped[drop] = True
    probe = rng.permutation(np.flatnonzero(~dropped))[:NQ_SMALL]

    def live_rec():
        ids, _ = six.knn_query(vecs[probe], 10)
        _, gtl = exact_topk(xd, vecs[probe], 10, sharded_live(six, n))
        return recall_at_10(ids, gtl)

    pre = live_rec()
    before = [t.seconds() for t in six.timers]
    K3.start()
    k4_0 = RS.repair_scan.calls
    _, s = timed_query(lambda: six.remove(drop))
    k4 = RS.repair_scan.calls - k4_0
    k3 = K3.finish("the sharded removal")
    split = {k: sum(t.seconds().get(k, 0.0) - b.get(k, 0.0)
                    for t, b in zip(six.timers, before))
             for k in ("mark", "affected", "candidates", "repair")}
    if six.count != n - N_SHARD_REMOVE:
        fail(f"sharded removal: count {six.count}")
    bad = sum(edges_into_removed(st) for st in six._states)
    if bad:
        fail(f"sharded removal: {bad} edges of live rows point to removed "
             "rows")
    qi, _ = six.knn_query(vecs[:NQ], 10)
    if np.isin(qi, drop).any():
        fail("sharded removal: a removed gid came back")
    post = live_rec()
    ratio = post / pre
    print(f"sharded removal: {N_SHARD_REMOVE} gids in {s:.2f} s = "
          f"{N_SHARD_REMOVE / s:.1f} removals/s (summed shard phases "
          + " ".join(f"{k}={v:.2f}s" for k, v in split.items())
          + f"); recall@10 of {NQ_SMALL} surviving rows {pre:.4f} -> "
          f"{post:.4f} (ratio {ratio:.4f}); K4 launches {k4}", flush=True)
    if ratio < 0.98 or k3["launches"] <= 0 or k4 <= 0:
        fail(f"sharded removal: post/pre recall ratio {ratio} < 0.98 or "
             "no K3 or K4 launch")
    out = dict(removals_per_s=N_SHARD_REMOVE / s, seconds=s, phases_s=split,
               recall_pre=pre, recall_post=post, ratio=ratio, k3=k3,
               k4_launches=k4)

    live = np.flatnonzero(~dropped)
    upd = np.sort(rng.choice(live, N_SHARD_UPDATE, replace=False))
    moved = (vecs[upd] + 0.03 * rng.standard_normal(
        (N_SHARD_UPDATE, D)).astype(np.float32))
    ids_before = six.ids()
    K3.start()
    k4_0 = RS.repair_scan.calls
    _, s = timed_query(lambda: six.update(upd, moved))
    k4 = RS.repair_scan.calls - k4_0
    k3 = K3.finish("the sharded update")
    if not np.array_equal(six.ids(), ids_before) or \
            six.count != n - N_SHARD_REMOVE:
        fail("sharded update: the gids or the count changed")
    if not np.array_equal(six._mirror.rows(upd), moved):
        fail("sharded update: the stored vectors are not the new ones")
    keep = six.params.min_nn
    six.params.min_nn = 64
    try:
        found = six.knn_query(moved, 1)[0][:, 0]
    finally:
        six.params.min_nn = keep
    rec1 = float((found == upd).mean())
    print(f"sharded update: {N_SHARD_UPDATE} rows in {s:.2f} s = "
          f"{N_SHARD_UPDATE / s:.1f} rows/s; recall@1 by the new vectors "
          f"at ef 64 {rec1:.4f}; K4 launches {k4}", flush=True)
    if rec1 < 0.85 or k3["launches"] <= 0 or k4 <= 0:
        fail(f"sharded update: recall@1 {rec1} < 0.85 at ef 64 or no K3 "
             "or K4 launch")
    out["update"] = dict(rows_per_s=N_SHARD_UPDATE / s, recall_at_1=rec1,
                         k3=k3, k4_launches=k4)
    return out


def sharded_stats_snapshot(six, vecs: np.ndarray) -> dict:
    """``get_info`` and component counts (S components at layer 0), then a
    ``.npz`` round trip whose answers are identical."""
    import os
    import tempfile
    import torch
    from hnswindex_torch.parallel import ShardedIndex

    info, info_s = timed_query(six.get_info)
    comps, comp_s = timed_query(six.get_connected_component_counts)
    if info.layers[0].nodes_count != six.count or \
            comps[0] != six.n_shards:
        fail(f"sharded stats: layer 0 holds {info.layers[0].nodes_count} "
             f"nodes and {comps[0]} components")
    print(f"sharded stats: get_info {info_s:.3f} s ({len(info.layers)} "
          f"layers, layer 0 avg out {info.layers[0].avg_out_edges:.3f}); "
          f"components {comps} in {comp_s:.3f} s", flush=True)
    q = vecs[:NQ_SMALL] + 0.01
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sharded.npz")
        _, write_s = timed_query(lambda: six.serialize(path))
        nbytes = os.path.getsize(path)
        loaded, read_s = timed_query(
            lambda: ShardedIndex.deserialize(path, devices=six.devices))
    a, b = six.knn_query(q, 10), loaded.knn_query(q, 10)
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        fail("sharded snapshot: the loaded index answers differently")
    print(f"sharded snapshot: write {write_s:.2f} s, read {read_s:.2f} s, "
          f"{nbytes} bytes; {NQ_SMALL} queries answered identically",
          flush=True)
    del loaded
    torch.cuda.empty_cache()
    return dict(get_info_s=info_s, components_s=comp_s, components=comps,
                write_s=write_s, read_s=read_s, bytes=nbytes)


def k2_selection(what: str, ix, s: int, q, bids, k: int = 10) -> dict:
    """Shard ``s``'s top-k through K2 (``block._score_blocks_panel``)
    against the plain ``block._score_blocks`` on the same probes: the
    values within K2's bars, and where the ids differ, the two ids at that
    place are a near-tie (float64 distances within the same bars); both
    timed."""
    import torch
    from hnswindex_torch.block import _score_blocks, _score_blocks_panel
    from hnswindex_torch.ops import distance as dst

    blk, ids, fill = ix._blk_vecs[s], ix._blk_ids[s], ix._blk_fill[s]
    norms = dst.norm_data(ix.metric, blk.reshape(-1, blk.shape[-1])) \
        .reshape(blk.shape[:2])
    panel = lambda: _score_blocks_panel(ix.metric, blk, ids, fill, q,  # noqa
                                        bids, k)
    plain = lambda: _score_blocks(ix.metric, blk, ids, norms, q,  # noqa
                                  bids, k)
    pv, pid = panel()
    rv, rid = plain()
    pv, pid = pv[:, :k], pid[:, :k]
    fin = torch.isfinite(rv)
    err = (pv[fin] - rv[fin]).abs()
    if not torch.equal(torch.isfinite(pv), fin) or \
            bool((err > 1e-4 + 1e-4 * rv[fin].abs()).any()):
        fail(f"K2 top-{k} values at the {what}: max abs err "
             f"{err.max().item()}")
    pid, rid = pid.cpu().numpy(), rid.cpu().numpy()
    rows, cols = np.nonzero(pid != rid)
    gap = 0.0
    if rows.size:
        a, b = pid[rows, cols], rid[rows, cols]
        if (a < 0).any() or (b < 0).any():
            fail(f"K2 top-{k} at the {what}: a padded id differs")
        x = ix._h_vecs.reshape(-1, ix.dim)
        qq = q.cpu().numpy().astype(np.float64)[rows]
        da = ((qq - x[ix._id_to_pos[a]]) ** 2).sum(1)
        db = ((qq - x[ix._id_to_pos[b]]) ** 2).sum(1)
        gap = float(np.abs(da - db).max())
        if (np.abs(da - db) > 1e-4 + 1e-4 * db).any():
            fail(f"K2 top-{k} at the {what}: ids differ beyond a near-tie "
                 f"(float64 gap {gap})")
    agree = 1.0 - rows.size / pid.size
    res = dict(select_max_abs_err=err.max().item(), select_id_agree=agree,
               select_tie_gap=gap, select_ms=time_ms(panel, 10),
               select_plain_ms=time_ms(plain, 3))
    print(f"kernel phase K2 top-{k} at the {what}: max_abs_err="
          f"{res['select_max_abs_err']:.3e} id_agree={agree:.6f} ({rows.size}"
          f" ids differ, all near-ties, float64 gap <= {gap:.3e}); K2 + "
          f"top-k {res['select_ms']:.3f} ms, plain _score_blocks "
          f"{res['select_plain_ms']:.3f} ms", flush=True)
    return res


def sharded_block(vecs: np.ndarray, gt: np.ndarray, devices,
                  single_recall: float) -> dict:
    """``ShardedBlockIndex`` of the corpus at 128-row blocks: q/s,
    recall@10 >= 0.90 and within 0.005 of the single-card BlockIndex's,
    K2 launched; then add and remove N_CHURN rows."""
    import torch
    from hnswindex_torch import ShardedBlockIndex
    from hnswindex_torch.ops import block_scores as TBS

    n = vecs.shape[0]
    sbx = ShardedBlockIndex(D, "sq_euclid", block_size=K2_BS,
                            devices=devices)
    _, build_s = timed_query(lambda: sbx.build(vecs))
    sbx.knn_query(vecs[:K2_B], 10, n_probe=K2_P)             # warm up
    TBS.block_scores.launches = 0
    (qi, qd), s = timed_query(lambda: sbx.knn_query(vecs[:NQ], 10,
                                                    n_probe=K2_P))
    launches = TBS.block_scores.launches
    check_answers("sharded block", qi, qd, NQ, n)
    rec = recall_at_10(qi[:1000], gt)
    print(f"sharded block: {n} rows in {sbx.n_blocks} blocks on "
          f"{sbx.n_shards} shards, build {build_s:.2f} s; {NQ} x k=10 "
          f"n_probe={K2_P} {NQ / s:.1f} q/s; recall@10 {rec:.4f} (BlockIndex "
          f"{single_recall:.4f}); block_scores launches {launches}",
          flush=True)
    if rec < 0.90 or abs(rec - single_recall) > 0.005:
        fail(f"sharded block recall@10 {rec} (BlockIndex {single_recall})")
    if launches <= 0:
        fail("the sharded block path never launched the block-scores kernel")
    # K2 on shard 0's own traffic: the first K2_B queries routed and
    # compacted as query_device does (after the launch count was read)
    qt = torch.as_tensor(vecs[:K2_B], device="cuda")
    local = sbx._shard_probes(sbx._route(qt, K2_P), 0)
    bv = sbx._blk_vecs[0]
    name = (f"sharded block shape (shard 0) sq_euclid/f32 NB={bv.shape[0]} "
            f"BS={K2_BS} D={D} B={K2_B} P={local.shape[1]}")
    k2 = k2_compare(name, "sq_euclid", bv, local, qt, timed=True)
    k2.update(k2_selection(name, sbx, 0, qt, local))
    del qt, local, bv
    rng = np.random.default_rng(SEED + 12)
    fresh = (vecs[rng.choice(n, N_CHURN, replace=False)]
             + 0.01 * rng.standard_normal((N_CHURN, D)).astype(np.float32))
    new_ids, add_s = timed_query(lambda: sbx.add(fresh))
    drop = rng.choice(np.arange(NQ, n), N_CHURN, replace=False)
    _, remove_s = timed_query(lambda: sbx.remove(drop))
    if sbx.count != n or new_ids.min() < n:
        fail("sharded block: add/remove lost count or reused an id")
    found = sbx.knn_query(fresh[:1000], 1, n_probe=K2_P)[0][:, 0]
    self_found = float((found == new_ids[:1000]).mean())
    back = sbx.knn_query(vecs[drop[:1000]], 10, n_probe=K2_P)[0]
    print(f"sharded block churn: add {N_CHURN} rows {add_s:.2f} s, remove "
          f"{N_CHURN} ids {remove_s:.2f} s; added rows find themselves "
          f"{self_found:.4f}", flush=True)
    if np.isin(back, drop).any() or self_found < 0.90:
        fail("sharded block: a removed id came back or added rows are lost")
    del sbx
    torch.cuda.empty_cache()
    return dict(build_s=build_s, queries_per_s=NQ / s, recall_at_10=rec,
                launches=launches, add_s=add_s, remove_s=remove_s,
                self_found=self_found, k2_shard_shape=k2)


def sharded_phases(vecs: np.ndarray, gt: np.ndarray,
                   block_recall: float) -> dict:
    """The sharded front ends on the corpus, two shards on the one card."""
    import torch
    devices = ["cuda:0", "cuda:0"]
    xd = torch.as_tensor(vecs, device="cuda")
    six, build = sharded_build(vecs, devices)
    out = dict(build=build, queries=sharded_queries(six, vecs, gt, xd))
    out["churn"] = sharded_churn(six, vecs, xd)
    out["stats_snapshot"] = sharded_stats_snapshot(six, vecs)
    del six, xd
    torch.cuda.empty_cache()
    out["block"] = sharded_block(vecs, gt, devices, block_recall)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    import hnswindex_torch
    from hnswindex_torch.ops import _cuda
    from hnswindex_torch.ops import fused_scan as FS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)

    t0 = time.perf_counter()
    _cuda.prebuild(["fused_scan", "block_scores", "accept_scan",
                    "repair_scan"])
    K3.install()
    print(f"kernel build: fused_scan.cu, block_scores.cu, accept_scan.cu "
          f"and repair_scan.cu together {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_cuda.build_seconds['fused_scan']:.2f} s, "
          f"{_cuda.build_seconds['block_scores']:.2f} s, "
          f"{_cuda.build_seconds['accept_scan']:.2f} s and "
          f"{_cuda.build_seconds['repair_scan']:.2f} s)", flush=True)

    k1 = kernel_phases()
    k_full = k1["full"]
    k2 = block_phases()
    k4 = k4_phase()

    # -- main path ------------------------------------------------------
    n = N
    t0 = time.perf_counter()
    vecs = clustered(n)
    print(f"corpus: {n} x {D} clustered (seed {SEED}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    index = hnswindex_torch.Index(D, "sq_euclid", device="cuda")
    index.set_collection_size(n)
    FS.lane_min_scan.launches = 0
    K3.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = index.add(vecs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if ids.shape != (n,) or index.count != n:
        fail("add did not insert every row")
    phases = index._impl.timer.seconds()
    split = " ".join(f"{k}={phases.get(k, 0.0):.2f}s"
                     for k in ("scan", "prune", "reverse", "upper"))
    print(f"build: {n} rows in {build_s:.2f} s = {n / build_s:.1f} "
          f"inserts/s; phases {split}", flush=True)
    k3_build = K3.finish("the 1M build", timed=True)
    k3_main = [m for m in k3_build["timed"] if m["N"] == 100]
    if k3_build["launches"] <= 0 or not k3_main:
        fail("the build never launched K3 at efConstruction's width")
    stats_built = stats_phase(index, "after the build")

    nq = NQ
    t0 = time.perf_counter()
    qi, qd = index.knn_query(vecs[:nq], 10)       # includes the pack build
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qi, qd = index.knn_query(vecs[:nq], 10)
    qs = nq / (time.perf_counter() - t0)
    launches = FS.lane_min_scan.launches
    print(f"queries: {nq} x k=10 first call (with pack build) "
          f"{first_s:.2f} s; steady {qs:.1f} q/s", flush=True)
    print(f"lane_min_scan launches in the main path: {launches}",
          flush=True)
    if launches <= 0:
        fail("the build never launched the lane-min kernel")

    check_answers("main path", qi, qd, nq, n)
    direct = ((vecs[qi[:100]].astype(np.float64)
               - vecs[:100, None, :].astype(np.float64)) ** 2).sum(-1)
    if not np.allclose(qd[:100], direct, rtol=1e-5, atol=1e-5):
        fail("returned distances differ from the direct formula")
    xd = torch.as_tensor(vecs, device="cuda")
    gt = exact_top10(xd, vecs[:1000])
    recall = recall_at_10(qi[:1000], gt)
    print(f"recall@10 (1000 queries vs exact f32 on the card): "
          f"{recall:.4f}", flush=True)
    if recall < 0.90:
        fail(f"recall@10 {recall} < 0.90")

    # the unpacked engine on the same index: layer 0 without the pack,
    # layer 1, exact, range and multi-layer queries
    graph = dict(unpacked=unpacked_phase(index, vecs, gt),
                 layer1=layer1_phase(index, vecs, xd),
                 exact=exact_phase(index, vecs, gt, xd),
                 range=range_phase(index, vecs, xd),
                 multi_layer=multi_layer_phase(index, vecs))
    # the earlier paths run before the filters and the churn, as they did
    # before those phases existed; the main index (with its ~9 GB pack)
    # stays on the card meanwhile
    torch.cuda.empty_cache()
    beam, beam_index, beam_gt = beam_build(vecs)
    torch.cuda.empty_cache()
    blockp = block_path(vecs, gt)
    torch.cuda.empty_cache()
    fallb = fallback_path(vecs)
    torch.cuda.empty_cache()
    # filters, then removal, re-add and update on the main index
    filters = filter_phase(index, vecs, xd)
    churn = churn_phases(index, vecs)
    stats_churned = stats_phase(index, "after the churn")
    snap = snapshot_phase(index, vecs)
    del index, xd
    torch.cuda.empty_cache()
    router = block_router_phase(vecs, gt, blockp["queries_per_s"])
    torch.cuda.empty_cache()
    refsnap = refsnap_phase(beam_index, beam_gt)
    del beam_index
    torch.cuda.empty_cache()
    custom = custom_metric_phase(vecs)
    torch.cuda.empty_cache()
    sharded = sharded_phases(vecs, gt, blockp["recall_at_10"])

    print(json.dumps({"summary": {
        "n": n, "build_s": build_s, "build_inserts_per_s": n / build_s,
        "phases_s": phases, "queries_per_s": qs, "recall_at_10": recall,
        "lane_min_scan_phases": k1, "graph_path": graph,
        "filters": filters, "churn": churn, "hnsw_router": router,
        "stats": {"after_build": stats_built, "after_churn": stats_churned},
        "snapshot": snap, "reference_snapshot": refsnap,
        "custom_metric": custom, "sharded": sharded,
        "beam_build": beam, "block_path": blockp, "fallback": fallb,
        "block_scores_phases": k2, "accept_scan_build": k3_build,
        "repair_scan_phases": k4}}),
        flush=True)
    print(card, flush=True)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    k2m = k2["sq_euclid"]
    print(json.dumps({"kernels": [
        {"name": "lane_min_scan", "route": "cuda",
         "source": "hnswindex_torch/csrc/fused_scan.cu",
         "replaces": "hnswindex_tpu/ops/fused_scan.py:85",
         "launches": launches,
         "launches_exact": graph["exact"]["launches"],
         "launches_filtered_exact": filters["exact"]["launches"],
         "launches_callable_exact": filters["callable exact"]["launches"],
         "launches_readd": churn["readd"]["launches"],
         "launches_update": churn["update"]["launches"],
         "launches_sharded_build": sharded["build"]["launches"],
         "launches_sharded_exact": sharded["queries"]["exact"]["launches"],
         **{k: k_full[k] for k in keys}},
        {"name": "block_scores", "route": "cuda",
         "source": "hnswindex_torch/csrc/block_scores.cu",
         "replaces": "hnswindex_tpu/ops/pallas_block.py:84",
         "launches": blockp["launches"],
         "launches_fallback": fallb["launches"],
         "launches_hnsw_router": router["launches"],
         "launches_sharded_block": sharded["block"]["launches"],
         **{k: k2m[k] for k in keys}},
        {"name": "accept_scan", "route": "cuda",
         "source": "hnswindex_torch/csrc/accept_scan.cu",
         "replaces": "hnswindex_tpu/core/heuristic.py:37",
         "launches": k3_build["launches"],
         "launches_beam_build": beam["k3"]["launches"],
         "launches_remove": churn["k3"]["launches"],
         "launches_readd": churn["readd"]["k3"]["launches"],
         "launches_update": churn["update"]["k3"]["launches"],
         "launches_reference_export": refsnap["k3"]["launches"],
         "launches_custom_metric": custom["k3"]["launches"],
         "launches_sharded_build": sharded["build"]["k3"]["launches"],
         "launches_sharded_remove": sharded["churn"]["k3"]["launches"],
         "launches_sharded_update":
             sharded["churn"]["update"]["k3"]["launches"],
         **{k: k3_main[-1][k] for k in keys}},
        {"name": "repair_scan", "route": "cuda",
         "source": "hnswindex_torch/csrc/repair_scan.cu",
         "replaces": "none (ops/bruteforce.exact_knn on the removal's scan)",
         "launches_remove": churn["k4_launches"],
         "launches_update": churn["update"]["k4_launches"],
         "launches_sharded_remove": sharded["churn"]["k4_launches"],
         "launches_sharded_update": sharded["churn"]["update"]["k4_launches"],
         **{k: k4["wave"][k] for k in keys}}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
