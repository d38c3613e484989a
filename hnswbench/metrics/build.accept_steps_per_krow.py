"""Column steps of the heuristic's accept scan per 1,000 rows of the
set-up's build: ``core/heuristic._accept_cols`` walks the sorted candidate
columns of every prune one step at a time, a handful of small launches a
step, so the count says how much launch-bound work the build does.

The counter (``_accept_cols.steps``) is process-wide.  A run builds one
index in its process, and the query cells prune nothing after set-up, so
after the run it holds the set-up build's steps.  A program without the
counter reads nothing."""


def read(ctx):
    rows = ctx["setup"].get("rows")
    if not rows:
        return None
    from hnswindex_torch.core import heuristic
    steps = getattr(heuristic._accept_cols, "steps", None)
    if steps is None:
        return None
    return steps / (rows / 1e3)
