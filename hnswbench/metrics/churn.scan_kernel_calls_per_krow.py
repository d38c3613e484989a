"""K4 launches per 1,000 removed ids in the set-up's removals: the
rounds' tally ``remove.scan_calls`` (``core/remove.exact_repair_candidates``
counts one for each launch of ``ops/repair_scan``, the fused repair scan)
over ``remove.ids``.  Above 0 only where the removal's candidate scan ran
through K4; 0 where it took another scan.

Read from the rounds' own ``PhaseTimer`` (the kind's ``round_phases``).
0.0 where the set-up removed nothing; nothing where the program keeps no
``remove.scan_calls`` tally."""


def read(ctx):
    if not ctx["setup"].get("removed"):
        return 0.0
    ph = ctx["setup"].get("round_phases") or {}
    if not ph.get("remove.ids") or "remove.scan_calls" not in ph:
        return None
    return ph["remove.scan_calls"] / (ph["remove.ids"] / 1e3)
