#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py            # 1,000,000 x 128 clustered corpus

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA lane-min kernel (hnswindex_torch/csrc/fused_scan.cu)
   from source and prints the build time.
3. Kernel phase: runs the kernel and its plain PyTorch version on the same
   inputs at the build's shapes (B=512 queries, D=128, BS=1024 lanes,
   C=1,007,616 rows, and a ragged C) and checks vals at rtol=atol=1e-4,
   identical dead lanes and >= 0.999 id agreement on live lanes; times both
   with CUDA events.
4. Main path: ``hnswindex_torch.Index(128, "sq_euclid", device="cuda")``
   with ``set_collection_size`` and ``add`` on the bench's clustered corpus
   (seed 65537, M=16, efConstruction=100, max_wave_size=512); prints
   inserts/s, per-phase seconds and the kernel's launch count (must be
   > 0).
5. Queries: ``knn_query(k=10)`` on the first 10,000 corpus rows; prints
   q/s and checks recall@10 >= 0.90 on 1,000 of them against an exact f32
   brute force on the card.

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


def kernel_phase(C: int) -> dict:
    """K1 against its plain version on the card at one corpus size."""
    import torch
    from hnswindex_torch.ops import fused_scan as FS

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + C)
    x = torch.rand((C, D), generator=g, device=dev)
    coarse = x.to(torch.bfloat16)
    active = torch.rand((C,), generator=g, device=dev) < 0.9
    mult, bias = FS.rank_transform("sq_euclid", (x * x).sum(1), active)
    q = torch.rand((WAVE, D), generator=g, device=dev)
    excl = torch.randint(0, C, (WAVE,), generator=g, device=dev,
                         dtype=torch.int32)

    kv, ki = FS.lane_min_scan(coarse, mult, bias, q, excl, BS=BS)
    torch.cuda.synchronize()
    rv, ri = FS.lane_min_scan_ref(coarse, mult, bias, q, excl, BS=BS)
    torch.cuda.synchronize()
    live = rv < FS.DEAD
    if not torch.equal(kv < FS.DEAD, live):
        fail(f"K1 dead lanes differ from the plain version at C={C}")
    if not torch.equal(ki[~live], torch.full_like(ki[~live], -1)):
        fail(f"K1 dead lanes carry ids at C={C}")
    err = (kv[live] - rv[live]).abs()
    tol = 1e-4 + 1e-4 * rv[live].abs()
    if bool((err > tol).any()):
        fail(f"K1 vals off at C={C}: max abs err {err.max().item()}")
    agree = (ki[live] == ri[live]).float().mean().item()
    if agree < 0.999:
        fail(f"K1 ids agree on {agree} of live lanes at C={C}")
    ms = time_ms(lambda: FS.lane_min_scan(coarse, mult, bias, q, excl,
                                          BS=BS), 10)
    plain_ms = time_ms(lambda: FS.lane_min_scan_ref(coarse, mult, bias, q,
                                                    excl, BS=BS), 3)
    res = dict(C=C, max_abs_err=err.max().item(), id_agree=agree, ms=ms,
               plain_ms=plain_ms)
    print(f"kernel phase C={C} B={WAVE} D={D} BS={BS}: max_abs_err="
          f"{res['max_abs_err']:.3e} id_agree={agree:.6f} kernel {ms:.3f} ms"
          f" plain {plain_ms:.3f} ms", flush=True)
    return res


def exact_top10(xd, q: np.ndarray):
    """Exact f32 top-10 of each query over the corpus on the card."""
    import torch
    xn = (xd * xd).sum(1)
    out = []
    for i in range(0, q.shape[0], 250):
        qd = torch.as_tensor(q[i:i + 250], device=xd.device)
        d = (qd * qd).sum(1)[:, None] + xn[None] - 2.0 * (qd @ xd.T)
        out.append(torch.topk(d, 10, dim=1, largest=False).indices.cpu())
    return torch.cat(out).numpy()


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
    _cuda.library("fused_scan")
    print(f"kernel build: fused_scan.cu {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_cuda.build_seconds['fused_scan']:.2f} s)", flush=True)

    k_full = kernel_phase(FULL_C)
    k_rag = kernel_phase(RAGGED_C)

    # -- main path ------------------------------------------------------
    n = N
    t0 = time.perf_counter()
    vecs = clustered(n)
    print(f"corpus: {n} x {D} clustered (seed {SEED}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    index = hnswindex_torch.Index(D, "sq_euclid", device="cuda")
    index.set_collection_size(n)
    FS.lane_min_scan.launches = 0
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

    if qi.shape != (nq, 10) or not np.isfinite(qd).all():
        fail("knn_query returned padding or non-finite distances")
    if (qi < 0).any() or (qi >= n).any() or (np.diff(qd, axis=1) < 0).any():
        fail("knn_query ids out of range or distances not ascending")
    direct = ((vecs[qi[:100]].astype(np.float64)
               - vecs[:100, None, :].astype(np.float64)) ** 2).sum(-1)
    if not np.allclose(qd[:100], direct, rtol=1e-5, atol=1e-5):
        fail("returned distances differ from the direct formula")
    xd = torch.as_tensor(vecs, device="cuda")
    gt = exact_top10(xd, vecs[:1000])
    recall = float(np.mean([len(set(a) & set(b)) / 10.0
                            for a, b in zip(qi[:1000], gt)]))
    print(f"recall@10 (1000 queries vs exact f32 on the card): "
          f"{recall:.4f}", flush=True)
    if recall < 0.90:
        fail(f"recall@10 {recall} < 0.90")

    print(json.dumps({"summary": {
        "n": n, "build_s": build_s, "build_inserts_per_s": n / build_s,
        "phases_s": phases, "queries_per_s": qs, "recall_at_10": recall,
        "kernel_ragged": k_rag}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "lane_min_scan", "route": "cuda",
        "source": "hnswindex_torch/csrc/fused_scan.cu",
        "replaces": "hnswindex_tpu/ops/fused_scan.py:85",
        "launches": launches, "max_abs_err": k_full["max_abs_err"],
        "ms": k_full["ms"], "plain_ms": k_full["plain_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
