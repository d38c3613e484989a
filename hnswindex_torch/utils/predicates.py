"""Batched evaluation of user filter predicates.

A callable filter is evaluated on candidates only (the reference evaluates
it on visited nodes, GraphNavigator.cs:235-239), but one Python call per
candidate row makes selective predicates over large query batches
host-bound.  ``BatchedPredicate`` wraps the user callable and tries one
vectorized call per candidate batch.

A row predicate applied to an (F, D) matrix does not in general act row by
row (``lambda v: v[0] > 0.5`` means "first component" on a row and "first
row" on a matrix), so the vectorized form is checked, not assumed: on the
first batch the wrapper evaluates up to ``PROBE_ROWS`` rows both ways and
trusts the vectorized call only if it returns a boolean vector of the right
shape that agrees with the row-by-row answers.  Otherwise every batch is
evaluated row by row.
"""

from __future__ import annotations

import numpy as np

#: rows of the first batch cross-checked row by row
PROBE_ROWS = 64


class BatchedPredicate:
    """``__call__(rows (F, D)) -> (F,) bool``.  ``calls`` counts calls of
    the user predicate."""

    def __init__(self, pred):
        self._pred = pred
        self._vectorized: bool | None = None   # None: not decided yet
        self.calls = 0

    def _rowwise(self, rows: np.ndarray) -> np.ndarray:
        self.calls += rows.shape[0]
        return np.fromiter((bool(self._pred(v)) for v in rows), bool,
                           rows.shape[0])

    def _try_vector(self, rows: np.ndarray):
        try:
            self.calls += 1
            out = np.asarray(self._pred(rows))
        except Exception:
            return None
        if out.shape != (rows.shape[0],) or out.dtype != np.bool_:
            return None
        return out

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows)
        if rows.shape[0] == 0:
            return np.zeros((0,), bool)
        if self._vectorized is None:
            probe = rows[:PROBE_ROWS]
            ref = self._rowwise(probe)
            vec = self._try_vector(probe)
            self._vectorized = vec is not None and bool(np.all(vec == ref))
            rest = rows[PROBE_ROWS:]
            if rest.shape[0] == 0:
                return ref
            return np.concatenate([ref, self(rest)])
        if self._vectorized:
            out = self._try_vector(rows)
            if out is not None:
                return out
            self._vectorized = False      # the predicate changed behaviour
        return self._rowwise(rows)
