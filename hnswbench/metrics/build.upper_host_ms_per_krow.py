"""Host milliseconds per 1,000 rows of the set-up's build in the upper-layer
connect of ``core/construct`` (``upper_connect_exact`` with its accept
scan; the ``upper`` region), beside its stream time in
``build.upper_ms_per_krow``: the two agree where the host paces the
device.

Read from the index's own ``PhaseTimer`` once set-up has ended: its
``upper.host`` entry (host self seconds of the region: its host interval less
those of the regions inside it) over the rows the set-up inserted.  An
index without the entry reads nothing."""


def read(ctx):
    rows = ctx["setup"].get("rows")
    if not rows or "upper.host" not in ctx["phases"]:
        return None
    return ctx["phases"]["upper.host"] * 1e3 / (rows / 1e3)
