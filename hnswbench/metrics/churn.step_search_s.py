"""Mean host seconds of the set-up's search steps: the one request of
1,024 queries sent after each round's removal.  Its ``knn_query`` rebuilds
the query pack (``index._get_pack``) and the refine's host mirror, runs
the packed search (``core/pack``) and refines the answers in float64 on
the host (``utils/refine``).

Read from the kind's set-up record (``rounds``).  0.0 where the set-up
removed nothing."""


def read(ctx):
    rounds = ctx["setup"].get("rounds")
    if not ctx["setup"].get("removed") or not rounds:
        return 0.0
    return sum(r["step_s"] for r in rounds) / len(rounds)
