#!/usr/bin/env python3
"""The heuristic prune of this checkout against another tree's, on one card.

    python3 chip_prune_ab.py OTHER_TREE

Loads ``hnswindex_torch.core.heuristic`` from this checkout and from
OTHER_TREE (a second unpacked copy of the repository, e.g. the parent
commit from ``git archive``) in one process, and runs both ``prune``
functions on the same inputs on the card: 512 target rows of
``chip_smoke.py``'s clustered corpus (first 200,000 rows, seed 65537,
128-d, float32), each with its N nearest rows as candidates (exact,
itself excluded), at the widths the build and the removal prune at:
N = 40 (the overflow re-prune: 32 stored edges + 8 arrivals), 100 (the
forward prune at efConstruction=100), 136 and 424 (the removal repair's
two tiers), each keeping 32 edges.  The two versions alternate, A B A B,
for 7 rounds after a warm-up of each; each call is timed on the host
clock around ``torch.cuda.synchronize()``.  Prints, per width, the median
ms of each and whether their selections and counts are identical.  Then
it times the accept kernel (K3, ``ops/accept_scan``) alone on the inputs
this checkout's ``prune`` hands it at each width, with
``chip_smoke.k3_measure``: K3's device time a launch from a profiler trace
of 200 launches, CUDA events around 200 launches, the plain twin
(``heuristic._accept_capped``) and K3's bound by bytes; it fails if K3 and
its twin differ.  Last, one JSON line.  Exits non-zero without a CUDA
device, or if the two versions select differently, or K3 and its twin
differ.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

WIDTHS = (40, 100, 136, 424)
ROWS = 512
MAX_EDGES = 32
ROUNDS = 7
N_CORPUS = 200_000


def load_other(tree: str):
    """The other tree's heuristic module, under a package name of its
    own so that both versions live in one process."""
    pkg = os.path.join(os.path.abspath(tree), "hnswindex_torch")
    spec = importlib.util.spec_from_file_location(
        "other_hnswindex_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_hnswindex_torch"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("other_hnswindex_torch.core.heuristic")


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_prune_ab: no CUDA device; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    import chip_smoke as S
    from hnswindex_torch.core import heuristic as mine
    from hnswindex_torch.ops import distance as dst
    other = load_other(sys.argv[1])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = S.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    vecs = torch.as_tensor(S.clustered(S.N)[:N_CORPUS], device=dev)
    norms = dst.norm_data("sq_euclid", vecs)
    tgt = vecs[:ROWS]
    d_all = dst.from_dot("sq_euclid", tgt @ vecs.T, norms[:ROWS, None],
                         norms[None, :])
    d_all[torch.arange(ROWS), torch.arange(ROWS)] = float("inf")

    def timed(fn, args) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, MAX_EDGES)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = []
    same_all = True
    for n in WIDTHS:
        cd, ci = torch.topk(d_all, n, dim=1, largest=False)
        args = ("sq_euclid", ci, cd, vecs[ci], norms[ci])
        sa, ca = mine.prune(*args, MAX_EDGES)
        sb, cb = other.prune(*args, MAX_EDGES)
        same = bool(torch.equal(sa, sb) and torch.equal(ca, cb))
        same_all &= same
        ta, tb = [], []
        for _ in range(ROUNDS):
            ta.append(timed(mine.prune, args))
            tb.append(timed(other.prune, args))
        row = dict(width=n, rows=ROWS, this_ms=float(np.median(ta)),
                   other_ms=float(np.median(tb)), identical=same,
                   this_all_ms=ta, other_all_ms=tb)
        out.append(row)
        print(f"prune B={ROWS} N={n}: this {row['this_ms']:.3f} ms, other "
              f"{row['other_ms']:.3f} ms (medians of {ROUNDS}); selections "
              f"identical: {same}", flush=True)
    k3 = []
    S.K3.install()
    for n in WIDTHS:
        cd, ci = torch.topk(d_all, n, dim=1, largest=False)
        S.K3.start()
        mine.prune("sq_euclid", ci, cd, vecs[ci], norms[ci], MAX_EDGES)
        k3 += S.K3.finish(f"prune B={ROWS} N={n}", timed=True)["timed"]
    print(json.dumps({"prune_ab": out, "k3": k3, "card": card}), flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
