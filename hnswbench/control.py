#!/usr/bin/env python3
"""The control of a cell: the plain reference in TF32 in the program's place.

    python3 hnswbench/control.py --workload <cell> --seeds 1,2,3 --requests <n>

Runs the cell's own set-up, window (``--requests`` requests at the cell's
request size, or ``--seconds``) and check with ``sut.Control`` answering
instead of the program, once a seed, and prints each run's compared
numbers as a JSON line.  Exits 0 only when every seed comes out not
correct, as a control must.  Needs a CUDA card; the benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hnswbench import harness, registry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=60.0)
    args = ap.parse_args(argv)
    cell = registry.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                               system="control", max_requests=args.requests)
        caught &= not res["correct"]
        print(json.dumps(dict(control=cell.name, seed=seed,
                              correct=res["correct"],
                              attempted=res["attempted"],
                              checks=res["checks"])), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
