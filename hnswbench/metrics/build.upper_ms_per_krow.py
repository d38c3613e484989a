"""Milliseconds of the index's ``upper`` phase per 1,000 rows of the
set-up's build: the upper-layer connect of ``core/construct``
(``upper_connect_exact``, with its accept scan).

Read from the index's own ``PhaseTimer`` (CUDA events) once set-up has
ended, its ``upper`` total over the rows the set-up inserted."""


def read(ctx):
    rows = ctx["setup"].get("rows")
    if not rows or "upper" not in ctx["phases"]:
        return None
    return ctx["phases"]["upper"] * 1e3 / (rows / 1e3)
