#!/usr/bin/env python3
"""Planted faults in a churn cell: a smaller efSearch, and two removals
whose repair is cut short.

    python3 chip_probe_churn.py --workload msturing-stream-1m.knn-churn \
        --seeds 1,2,3 --efs 16 --requests 40

For each seed, runs the cell's own set-up three times with the program
(``hnswbench/faults.read_seed``: the index built through ``add``, the
rounds of removal, search step and refill, the warm-ups):

1. the program as it is, read at its own efSearch and then at each of
   ``--efs`` on the one churned index (``faults.py``'s fault).  Its line
   also says what the set-up's removals did: the rounds' removal tallies,
   the ``candidates`` region's stream seconds, and the exact repair scan's
   float32 operations (2 x removed rows x scan prefix x D, tallied around
   ``core/remove.exact_repair_candidates``) with their share of the
   card's float32 peak (67 TFLOP/s) over that time;
2. the same set-up with ``core/remove._repair_rows`` replaced by
   ``drop_dead_edges``: the affected rows lose their edges into removed
   rows and get nothing in their place (no candidates, no re-prune);
3. the same set-up with ``_repair_rows`` doing nothing: the affected rows
   keep their edges into the removed rows, which the refill then points
   at fresh rows.

The faults are read at the program's own efSearch.  Every line gives the
compared numbers (``recall_miss`` the larger of the window's and the
search steps') and the search steps' own ``malformed`` and
``recall_miss``.  Prints one JSON line per seed and reading.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from hnswbench import faults, harness, registry  # noqa: E402

#: the card's float32 peak (FMA pipes, not the tensor cores), FLOP/s
F32_PEAK = 67e12
TALLIES = ("remove.ids", "remove.waves", "remove.affected_one",
           "remove.affected_multi", "remove.scan_calls", "add.reused",
           "pack.builds")


def _scan_flops(rm, dim: int) -> list:
    """Wrap ``rm.exact_repair_candidates`` to tally its products' float32
    operations into the returned one-element list."""
    flops = [0]
    scan = rm.exact_repair_candidates

    def counted(cfg, state, scan_ids, layer, remove_ef, nscan=None,
                timer=None):
        ns = state.capacity if nscan is None else min(nscan, state.capacity)
        flops[0] += 2 * int(scan_ids.shape[0]) * ns * dim
        return scan(cfg, state, scan_ids, layer, remove_ef, nscan, timer)

    rm.exact_repair_candidates = counted
    return flops


def drop_dead_edges(cfg, state, nbr_l, deg_l, rows, rmask, *args,
                    **kw) -> None:
    """A repair that only drops: each affected row keeps its surviving
    neighbours, in order, and gets no new candidates and no re-prune
    (``core/remove._repair_rows``'s signature)."""
    if rows.size == 0:
        return
    r = torch.as_tensor(rows).to(nbr_l.device).long()
    old = nbr_l[r].long()
    keep = (old >= 0) & ~rmask[old.clamp(0, nbr_l.shape[0] - 1)]
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    nbr_l[r] = torch.gather(torch.where(keep, old, -1), 1,
                            order).to(nbr_l.dtype)
    deg_l[r] = keep.sum(1).to(deg_l.dtype)


def read_seed(cell, seed: int, efs, requests: int, device="cuda") -> list:
    from hnswindex_torch.core import remove as rm

    own = int(cell.config["index"]["min_nn"])
    out = []
    scan, repair = rm.exact_repair_candidates, rm._repair_rows

    def run(fault, efs, record=None):
        held = []

        def keep(kind, st):
            held.append(st)
            if record is not None:
                record(st)

        rows = faults.read_seed(cell, seed, efs, requests, device=device,
                                after_setup=keep)
        steps = held[0].step_numbers
        out.extend(dict(fault=fault if r["ef"] == own else "efSearch",
                        steps=dict(malformed=steps["malformed"],
                                   recall_miss=steps["recall_miss"]), **r)
                   for r in rows)

    try:
        flops = _scan_flops(rm, int(cell.config["dim"]))

        def record(st):
            ph = st.setup.get("round_phases", {})
            cand = ph.get("candidates", 0.0)
            out.append(dict(
                setup=st.setup.get("rounds"),
                tallies={n: ph.get(n) for n in TALLIES},
                candidates_s=cand, scan_flops=flops[0],
                scan_f32_share=(flops[0] / F32_PEAK / cand if cand else None)))

        run(None, [own, *efs], record)
        rm.exact_repair_candidates = scan
        rm._repair_rows = drop_dead_edges
        run("repair_drop_only", [own])
        rm._repair_rows = lambda *a, **k: None
        run("repair_skipped", [own])
    finally:
        rm.exact_repair_candidates, rm._repair_rows = scan, repair
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--efs", default="16")
    ap.add_argument("--requests", type=int, default=40)
    args = ap.parse_args(argv)
    cell = registry.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    efs = [int(e) for e in args.efs.split(",")]
    for seed in (int(s) for s in args.seeds.split(",")):
        for r in read_seed(cell, seed, efs, args.requests):
            print(json.dumps(dict(probe=cell.name, seed=seed, **r)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
