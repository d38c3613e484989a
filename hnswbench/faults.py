#!/usr/bin/env python3
"""A search fault planted in the program: a smaller efSearch.

    python3 hnswbench/faults.py --workload <cell> --seeds 1,2,3 \
        --efs 32,16,10 --requests <n>

For each seed, runs the cell's own set-up with the program (the index
built through ``add`` as in a run), then, for each efSearch of ``--efs``
in turn, sets the index's ``min_nn`` to it (efSearch is max(min_nn, k)),
sends ``--requests`` requests at the cell's request size from the start
of the pool (more where the recall sample needs them), and judges the
answers as a run does.  The configuration's own efSearch is the program
as it is; a smaller one is a search that answers faster and worse, the
fault that ``recall_miss`` has to catch (the TF32 control moves
distances, not recall).  Prints one JSON line per seed and efSearch.
Needs a CUDA card; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hnswbench import datagen, harness, registry, sut  # noqa: E402


def read_seed(cell: registry.Cell, seed: int, efs, requests: int,
              device="cuda", after_setup=None) -> list:
    """The compared numbers of one seed's index at each efSearch;
    ``after_setup(kind, st)`` runs once the index is built."""
    kind = registry.kind(cell)
    data = datagen.Clustered(cell.config, seed, device)
    st = kind.setup(sut.SYSTEMS["program"], cell, data, device)
    if after_setup is not None:
        after_setup(kind, st)
    lim = harness.limits(cell)
    out = []
    for ef in efs:
        kind.reset(st)
        st.sut.index.params.min_nn = int(ef)
        harness.window(kind, st, float("inf"), max_requests=requests)
        res = kind.judge(st)
        out.append(dict(ef=int(ef), requests=len(st.answers),
                        **{n: res[n] for n in lim}))
    st.sut.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--efs", default="32,16,10")
    ap.add_argument("--requests", type=int, default=1)
    args = ap.parse_args(argv)
    cell = registry.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    efs = [int(e) for e in args.efs.split(",")]
    for seed in (int(s) for s in args.seeds.split(",")):
        for r in read_seed(cell, seed, efs, args.requests):
            print(json.dumps(dict(fault=cell.name, seed=seed, **r)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
