"""Host milliseconds per 1,000 rows of the set-up's build in the layer-0
candidate scan (``ops/bruteforce``, and kernel K1 once the prefix passes
its gate; the ``scan`` region).

Read from the index's own ``PhaseTimer`` once set-up has ended: its
``scan.host`` entry (host self seconds of the region: its host interval less
those of the regions inside it) over the rows the set-up inserted.  An
index without the entry reads nothing."""


def read(ctx):
    rows = ctx["setup"].get("rows")
    if not rows or "scan.host" not in ctx["phases"]:
        return None
    return ctx["phases"]["scan.host"] * 1e3 / (rows / 1e3)
