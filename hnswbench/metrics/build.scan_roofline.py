"""Share of its roofline that the set-up build's candidate scan reaches,
in %.

The work is the algorithm's, whatever implements the scan
(``roofline.build_scan_work``): an exact distance from each row to every
row inserted before it, and the bfloat16 prefix read once a wave.  The
least time for it is the larger of its operations at the bfloat16 dense
peak and its bytes at the memory rate; the share is that time over the
index's ``scan`` phase of the build (``ops/bruteforce``, and kernel K1 once
the prefix passes its gate; from the index's ``PhaseTimer``).  The entry
says which of the two bounds it, and the card's name and power limit."""

from hnswbench import roofline


def read(ctx):
    rows = ctx["setup"].get("rows")
    spent = ctx["phases"].get("scan", 0.0)
    if not rows or spent <= 0:
        return None
    cfg = ctx["config"]
    flops, nbytes = roofline.build_scan_work(
        rows, int(cfg["dim"]), int(cfg["index"]["max_wave_size"]))
    b = roofline.bound(flops, roofline.PEAK_BF16, nbytes)
    return dict(value=100.0 * b["bound_ms"] / 1e3 / spent,
                bound_by=b["bound_by"], card=ctx["card"])
