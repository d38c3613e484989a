"""Host milliseconds of the set-up's removals per 1,000 removed ids:
``HNSWIndex.remove`` with graph repair (``core/remove``), the host self
times of the ``remove`` region and of its four children (``mark``,
``affected``, ``candidates``, ``repair``), which add up to the removals'
host time.

Read from the rounds' own ``PhaseTimer`` (the kind's ``round_phases``)
over the ids the rounds removed.  0.0 where the set-up removed nothing;
nothing where the rounds' timer holds no ``remove`` region."""

REGIONS = ("remove", "mark", "affected", "candidates", "repair")


def read(ctx):
    removed = ctx["setup"].get("removed")
    if not removed:
        return 0.0
    ph = ctx["setup"].get("round_phases") or {}
    if "remove.host" not in ph:
        return None
    host = sum(ph.get(f"{r}.host", 0.0) for r in REGIONS)
    return host * 1e3 / (removed / 1e3)
