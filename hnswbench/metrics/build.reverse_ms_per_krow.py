"""Milliseconds of the index's ``reverse`` phase per 1,000 rows of the
set-up's build: the reverse edges of
``core/construct._add_reverse``, with the overflow re-prune.

Read from the index's own ``PhaseTimer`` (CUDA events) once set-up has
ended, its ``reverse`` total over the rows the set-up inserted."""


def read(ctx):
    rows = ctx["setup"].get("rows")
    if not rows or "reverse" not in ctx["phases"]:
        return None
    return ctx["phases"]["reverse"] * 1e3 / (rows / 1e3)
