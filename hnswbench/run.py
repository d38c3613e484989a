#!/usr/bin/env python3
r"""Run one cell of the benchmark once on the card and print its result.

    python3 hnswbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each compared number beside its
limit, which are also the last lines on standard error).  Exits non-zero
and prints no result without a CUDA card, with fewer cards than the cell
asks for, or when the run loaded jax or the JAX package.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hnswbench import harness, registry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = registry.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card: this benchmark runs on an NVIDIA card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} found")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda")
    found = harness.foreign_modules()
    if found:
        harness.log(f"the run loaded {', '.join(found)}: no result")
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
