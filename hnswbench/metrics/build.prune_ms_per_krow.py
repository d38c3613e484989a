"""Milliseconds of the index's ``prune`` phase per 1,000 rows of the
set-up's build: ``core/heuristic.prune`` at layer 0 (the span
also counts the device waiting for the host).

Read from the index's own ``PhaseTimer`` (CUDA events) once set-up has
ended, its ``prune`` total over the rows the set-up inserted."""


def read(ctx):
    rows = ctx["setup"].get("rows")
    if not rows or "prune" not in ctx["phases"]:
        return None
    return ctx["phases"]["prune"] * 1e3 / (rows / 1e3)
