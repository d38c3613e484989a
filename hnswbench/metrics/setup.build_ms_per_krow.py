"""Milliseconds per 1,000 rows of the set-up's one ``add`` of the whole
corpus into an empty index, on the host's clock with the device
synchronised at the end: ``HNSWIndex.add``'s wave scheduler with
``core/construct``, ``core/heuristic`` and kernel K1 over a build from
empty, the largest part of a query cell's set-up."""


def read(ctx):
    s = ctx["setup"]
    if not s.get("rows"):
        return None
    return s["add_s"] * 1e3 / (s["rows"] / 1e3)
