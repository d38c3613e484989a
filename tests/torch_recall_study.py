"""Recall of updated rows and of a callable filter, in both packages.

    JAX_PLATFORMS=cpu python tests/torch_recall_study.py [--n 10000] [--upd 500]

Not a test: a measurement on the CPU that holds the port's recall against
the reference's where a card run of the port alone cannot say whether a
low figure is the algorithm's or the port's.  bench.py's clustered corpus
(clusters of 500 rows, sigma 0.03 about uniform centres, seed 65537) is
built by hnswindex_tpu's ``Index`` at M=16, efConstruction=100, wave 512;
its graph is installed into a CPU ``hnswindex_torch.HNSWIndex``
(test_torch_search.installed: the same state, free list, RNG and panel).
Then, on both alike:

1. a callable filter, column 0 above its median, at min_nn 64 and at the
   default: recall@10 of 500 corpus rows against the exact top-10 over the
   rows that pass;
2. ``update`` of ``--upd`` seeded rows to their vector plus seeded sigma
   0.03 noise (the generator's own; the inner removal resolves to "fast"
   below 10% of the index): recall@1 of the updated rows by their new
   vectors at the default min_nn (5), at 64 and at 256, and the same read
   for ``--upd`` untouched rows by their own vectors;
3. ``update`` of another ``--upd`` rows to a fresh draw of their own
   cluster (centre plus sigma 0.03 noise): recall@1 as in 2.

Prints one JSON object with each figure for "jax" and "torch".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

SEED = 65537
D = 128
WIDTHS = (5, 64, 256)


def corpus(n: int):
    rng = np.random.default_rng(SEED)
    centers = rng.random((max(2, n // 500), D)).astype(np.float32)
    which = rng.integers(0, centers.shape[0], n)
    vecs = (centers[which]
            + 0.03 * rng.standard_normal((n, D)).astype(np.float32))
    return vecs, centers, which


def exact_top(vecs, q, k, allowed):
    q, v = q.astype(np.float64), vecs.astype(np.float64)
    d = (q * q).sum(1)[:, None] + (v * v).sum(1)[None] - 2.0 * q @ v.T
    d[:, ~allowed] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


def self_recall(ix, q, ids):
    out = {}
    keep = ix.params.min_nn
    for mn in WIDTHS:
        ix.params.min_nn = mn
        out[mn] = float((ix.knn_query(q, 1)[0][:, 0] == ids).mean())
    ix.params.min_nn = keep
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--upd", type=int, default=500)
    args = ap.parse_args()

    import torch
    import hnswindex_tpu as J
    import test_torch_search as TTS

    torch.set_num_threads(4)
    n, u = args.n, args.upd
    vecs, centers, which = corpus(n)
    t0 = time.perf_counter()
    ref = J.Index(D, "sq_euclid")
    ref.set_collection_size(n)
    ref.add(vecs)
    ji = ref._impl
    ti = TTS.installed(ji)
    out = dict(n=n, upd=u, build_s=time.perf_counter() - t0)
    both = (("jax", ji), ("torch", ti))

    # 1. the callable filter on the unchanged graph
    q = vecs[:500]
    med = float(np.median(vecs[:, 0]))
    gt = exact_top(vecs, q, 10, vecs[:, 0] > med)

    def pred(v):
        return np.asarray(v)[..., 0] > med

    for name, ix in both:
        keep = ix.params.min_nn
        for mn in (64, keep):
            ix.params.min_nn = mn
            ids = ix.knn_query(q, 10, filter_fnc=pred)[0]
            out[f"callable_recall10_min_nn_{mn}_{name}"] = recall(ids, gt)
        ix.params.min_nn = keep

    rng = np.random.default_rng(SEED + 8)
    rows = rng.permutation(n)
    noisy, fresh, still = rows[:u], rows[u:2 * u], rows[2 * u:3 * u]
    moved = vecs[noisy] + 0.03 * rng.standard_normal((u, D)).astype(
        np.float32)
    redrawn = (centers[which[fresh]]
               + 0.03 * rng.standard_normal((u, D)).astype(np.float32))
    for name, ix in both:
        out[f"untouched_recall1_{name}"] = self_recall(ix, vecs[still],
                                                       still)
    # 2. and 3. the two updates, the same rows and vectors in each package
    for what, ids, new in (("noise", noisy, moved), ("redraw", fresh,
                                                     redrawn)):
        order = np.argsort(ids)
        ids, new = ids[order], new[order]
        for name, ix in both:
            ix.update(ids, new)
            out[f"update_{what}_recall1_{name}"] = self_recall(ix, new, ids)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
