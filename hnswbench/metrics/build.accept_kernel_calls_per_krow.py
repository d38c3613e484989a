"""Launches of the heuristic's accept kernel (K3, ``ops/accept_scan``) per
1,000 rows of the set-up's build: each prune on the card decides its whole
sequential accept in one launch, where the host loop that
``build.accept_steps_per_krow`` counts takes a handful of small launches a
column.

The counter (``accept_scan.calls``) is process-wide.  A run builds one
index in its process, and the query cells prune nothing after set-up, so
after the run it holds the set-up build's launches.  A program without
the kernel reads nothing."""


def read(ctx):
    rows = ctx["setup"].get("rows")
    if not rows:
        return None
    try:
        from hnswindex_torch.ops import accept_scan
    except ImportError:
        return None
    calls = getattr(accept_scan.accept_scan, "calls", None)
    if calls is None:
        return None
    return calls / (rows / 1e3)
