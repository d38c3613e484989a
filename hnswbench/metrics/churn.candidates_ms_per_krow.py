"""Milliseconds of the removals' repair-candidate scan per 1,000 removed
ids: ``core/remove.exact_repair_candidates`` (``ops/bruteforce.exact_knn``
below 2^20 rows of capacity: one f32 GEMM and top-k a chunk of removed
rows), the ``candidates`` region in stream time.

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
    return ph.get("candidates", 0.0) * 1e3 / (removed / 1e3)
