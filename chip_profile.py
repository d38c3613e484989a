#!/usr/bin/env python3
"""Device profile of the PyTorch port's build waves and queries on one card.

    python3 chip_profile.py

Uses ``chip_smoke.py``'s corpus (1,000,000 x 128 clustered, seed 65537,
M=16, efConstruction=100, max_wave_size=512).  Builds the first 990,000
rows untraced, then traces with ``torch.profiler``:

1. the last 10,000 inserts (about 20 full-width waves at ~990k rows, every
   one scanning through the lane-min kernel);
2. one ``knn_query(k=10)`` of 2,048 corpus rows (after a warm-up call that
   builds the query pack);
3. one ``BlockIndex.knn_query(k=10, n_probe=32)`` of the same 2,048 rows
   against a 128-row-block index of the whole corpus (built untraced,
   after a warm-up call), every batch scoring through the block-scores
   kernel.

For each it prints the window's host time, the device's busy time and
share (``hnswbench/trace.py``: the union of the traced device events'
intervals over the window), the device operations that took most time and
the idle gaps by what the host was doing; for the build also the idle
seconds by the innermost ``PhaseTimer`` region open at each gap's middle
(``hnswindex_torch.utils.profiling.idle_by_region``), the per-phase split
with host self times and the kernel's launches, for the block query the
block-scores kernel's launches.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

from hnswbench import trace as tracing

N = 1_000_000
PREFIX = 990_000
NQ = 2_048


def traced(fn, device):
    """Run ``fn()`` in a traced window; returns the window's summary and
    the device's merged busy intervals."""
    w = tracing.Window(device)
    w.start()
    fn()
    w.stop()
    dev, host = tracing._events(w._prof, True)
    merged, _ = tracing.union(dev)
    return tracing.summarize(dev, host, w.window_s), merged


def report(name: str, summ: dict) -> None:
    print(f"== {name}: window {summ['window_s']:.4f} s, device busy "
          f"{summ['busy_s']:.4f} s, busy share "
          f"{summ['busy_s'] / summ['window_s']:.4f}", flush=True)
    for key, sec in summ["device_ops"]:
        print(f"   {sec * 1e3:10.3f} ms  {key[:90]}", flush=True)
    for key, sec in summ["idle_gaps"]:
        print(f"   {sec * 1e3:10.3f} ms idle  {key[:90]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    import chip_smoke as S
    from hnswindex_torch import BlockIndex, HNSWIndex, HNSWParameters
    from hnswindex_torch.ops import block_scores as BSC
    from hnswindex_torch.ops import fused_scan as FS
    from hnswindex_torch.utils.profiling import PhaseTimer, idle_by_region

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(S.card_line(), flush=True)

    vecs = S.clustered(N)
    idx = HNSWIndex(S.D, "sq_euclid", HNSWParameters(
        collection_size=N, max_wave_size=S.WAVE), device="cuda")
    t0 = time.perf_counter()
    idx.add(vecs[:PREFIX])
    torch.cuda.synchronize()
    print(f"untraced prefix build: {PREFIX} rows in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    idx.timer = PhaseTimer(idx.device)
    FS.lane_min_scan.launches = 0
    summ, busy = traced(lambda: idx.add(vecs[PREFIX:]), idx.device)
    report(f"build {N - PREFIX} rows (waves at ~{PREFIX} rows)", summ)
    for key, sec in idle_by_region(busy, idx.timer.spans()).items():
        print(f"   {sec * 1e3:10.3f} ms idle in region {key}", flush=True)
    print(f"phases {json.dumps(idx.timer.seconds())}; lane_min_scan "
          f"launches {FS.lane_min_scan.launches}", flush=True)
    if FS.lane_min_scan.launches <= 0:
        print("FAIL: the traced waves never launched the lane-min kernel")
        return 1

    q = vecs[:NQ]
    idx.knn_query(q[:8], 10)
    report(f"knn_query {NQ} x k=10",
           traced(lambda: idx.knn_query(q, 10), idx.device)[0])

    dev = idx.device
    del idx
    torch.cuda.empty_cache()
    bix = BlockIndex(S.D, "sq_euclid", block_size=S.K2_BS, device=dev)
    t0 = time.perf_counter()
    bix.build(vecs)
    torch.cuda.synchronize()
    print(f"untraced BlockIndex build: {N} rows, {bix.n_blocks} blocks in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    bix.knn_query(q[:8], 10, n_probe=S.K2_P)
    BSC.block_scores.launches = 0
    report(f"BlockIndex.knn_query {NQ} x k=10 n_probe={S.K2_P}",
           traced(lambda: bix.knn_query(q, 10, n_probe=S.K2_P), dev)[0])
    print(f"block_scores launches {BSC.block_scores.launches}", flush=True)
    if BSC.block_scores.launches <= 0:
        print("FAIL: the traced block query never launched block_scores")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
