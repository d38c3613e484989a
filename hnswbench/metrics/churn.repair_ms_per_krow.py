"""Milliseconds of the removals' re-prunes per 1,000 removed ids:
``core/remove._repair_rows`` (each affected row's candidate union pruned
through ``core/heuristic.prune``, kernel K3 on the card), the ``repair``
region in stream time.

Read from the rounds' own ``PhaseTimer`` (the kind's ``round_phases``)
over the ids the rounds removed.  0.0 where the set-up removed nothing;
nothing where the rounds' timer holds no ``remove`` region."""


def read(ctx):
    removed = ctx["setup"].get("removed")
    if not removed:
        return 0.0
    ph = ctx["setup"].get("round_phases") or {}
    if "remove" not in ph:
        return None
    return ph.get("repair", 0.0) * 1e3 / (removed / 1e3)
