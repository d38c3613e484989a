#!/usr/bin/env python3
"""A routing fault planted in the block fallback: fewer probed blocks.

    python3 chip_probe_fault.py --workload gist1m-960.knn-batch \
        --seeds 1,2,3 --probes 2,4 --requests 40

For a cell whose index serves plain k-NN from its block fallback (the query
pack past its budget), and for each seed: runs the cell's own set-up with
the program (``hnswbench/faults.read_seed``: the index built through
``add``, the warm-up requests), then, on that one index, replaces the
fallback's probe rule (``hnswindex_torch.index.fallback_probes``) by each
count of ``--probes`` in turn, sends ``--requests`` requests at the cell's
request size from the start of the pool and judges the answers as a run
does; last the program as it is (its own rule).  Fewer probes answer
faster and worse: the fault that ``recall_miss`` has to catch, which the
efSearch fault of ``faults.py`` cannot plant here (the fallback reads no
efSearch).  Prints one JSON line per seed and probe count, and a line of
what the set-up showed of the path: why the pack was refused, the tiles'
dtype, the blocks and the rule's probes, K2's launches, and its pairs and
distinct tiles as the index's timer tallied them, and the float32 refine's
calls on the device.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from hnswbench import faults, harness, registry  # noqa: E402


def read_seed(cell, seed: int, probes, requests: int, device="cuda") -> list:
    """The compared numbers of one seed's index with each planted probe
    count, then with its own rule (``probes`` None), and the path the
    set-up took."""
    from hnswindex_torch import index as TI
    from hnswindex_torch.ops import block_scores as TBS
    from hnswindex_torch.utils import refine

    rule = TI.fallback_probes
    refined = []
    on_device = refine.refine_on_device
    refine.refine_on_device = lambda *a: refined.append(1) or on_device(*a)
    out = []

    def planted(kind, st):
        ix = st.sut.index
        fb = ix._block_fb
        ph = ix.timer.seconds()
        out.append(dict(
            pack_refusal=ix._pack_refusal,
            tiles=str(fb.blk_vecs.dtype) if fb is not None else None,
            blocks=fb.n_blocks if fb is not None else 0,
            rule_probes=rule(fb.n_blocks) if fb is not None else 0,
            launches=TBS.block_scores.launches,
            pairs=ph.get("block_scores.pairs", 0),
            distinct_tiles=ph.get("block_scores.tiles", 0),
            refine_on_device_calls=len(refined)))
        lim = harness.limits(cell)
        try:
            for p in probes:
                TI.fallback_probes = lambda n_blocks, p=p: p
                kind.reset(st)
                harness.window(kind, st, math.inf, max_requests=requests)
                res = kind.judge(st)
                out.append(dict(probes=p, requests=len(st.answers),
                                **{n: res[n] for n in lim}))
        finally:
            TI.fallback_probes = rule

    try:
        rows = faults.read_seed(cell, seed, [cell.config["index"]["min_nn"]],
                                requests, device=device,
                                after_setup=planted)
    finally:
        refine.refine_on_device = on_device
    own = rows[0]
    own.pop("ef")
    return out + [dict(probes=None, **own)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--probes", default="2,4")
    ap.add_argument("--requests", type=int, default=40)
    args = ap.parse_args(argv)
    cell = registry.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    probes = [int(p) for p in args.probes.split(",")]
    for seed in (int(s) for s in args.seeds.split(",")):
        for r in read_seed(cell, seed, probes, args.requests):
            print(json.dumps(dict(fault=cell.name, seed=seed, **r)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
