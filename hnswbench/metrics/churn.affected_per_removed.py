"""Rows re-pruned per removed id in the set-up's removals: the index's
tallies ``remove.affected_one`` (rows that lost one neighbour, repaired at
fan-in 1) and ``remove.affected_multi`` (two or more, at the wider
fan-in), summed over layers, over ``remove.ids``.

Read from the rounds' own ``PhaseTimer`` (the kind's ``round_phases``).
0.0 where the set-up removed nothing; nothing where the program keeps no
``remove.ids`` tally."""


def read(ctx):
    if not ctx["setup"].get("removed"):
        return 0.0
    ph = ctx["setup"].get("round_phases") or {}
    if not ph.get("remove.ids"):
        return None
    aff = ph.get("remove.affected_one", 0) + ph.get("remove.affected_multi", 0)
    return aff / ph["remove.ids"]
