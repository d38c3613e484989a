"""Host milliseconds per 1,000 rows of the set-up's build that the facade's
wave scheduler spends itself: each wave's loop iteration in
``HNSWIndex._insert_batch`` (the ``wave`` region), less the host time of
the ``upper``, ``scan``, ``prune`` and ``reverse`` regions inside it.

Read from the index's own ``PhaseTimer`` once set-up has ended: its
``wave.host`` entry (host self seconds of the region: its host interval less
those of the regions inside it) over the rows the set-up inserted.  An
index without the entry reads nothing."""


def read(ctx):
    rows = ctx["setup"].get("rows")
    if not rows or "wave.host" not in ctx["phases"]:
        return None
    return ctx["phases"]["wave.host"] * 1e3 / (rows / 1e3)
