"""The comparison that decides ``correct``.

Every answer of the window is a row of ``k`` ids with their distances.  Three
numbers, each with a limit:

* ``malformed``: answer rows with an id that no ``add`` returned, an id
  twice, a missing distance, or distances that do not ascend; and ``add``
  calls whose ids were out of range or handed out twice.  Limit 0.
* ``dist_err``: the largest relative gap between a returned distance and
  the reference's float64 distance of the same query and row, over every
  id of every answer.  The configuration promises the exact float32
  distance of each returned id; its limit is the cell's.
* ``recall_miss``: the share of the reference's exact top-``k`` that a
  seeded sample of the answers leaves out, 1 - recall@k.  Its limit is the
  cell's, set between the program's readings and those of a search with a
  smaller efSearch (``faults.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

#: queries whose distances are checked at once
DIST_BLOCK = 1 << 14


def fit(ids, dists, n: int, k: int) -> tuple:
    """The answers as (n, k) int64 ids and float64 distances; rows or
    columns the program did not return are -1 / NaN (malformed)."""
    ids, dists = np.asarray(ids), np.asarray(dists)
    out_i = np.full((n, k), -1, np.int64)
    out_d = np.full((n, k), np.nan)
    if ids.ndim == 2 and dists.shape == ids.shape:
        r, c = min(n, ids.shape[0]), min(k, ids.shape[1])
        out_i[:r, :c] = ids[:r, :c]
        out_d[:r, :c] = dists[:r, :c]
    return out_i, out_d


def malformed_rows(ids: np.ndarray, dists: np.ndarray,
                   row_of_id: np.ndarray) -> np.ndarray:
    """(n,) bool: answer rows that break the answer's form."""
    bad = (ids < 0) | (ids >= row_of_id.shape[0])
    rows = row_of_id[np.clip(ids, 0, row_of_id.shape[0] - 1)]
    bad |= rows < 0
    srt = np.sort(ids, axis=1)
    out = bad.any(1) | (srt[:, 1:] == srt[:, :-1]).any(1)
    out |= np.isnan(dists).any(1)
    with np.errstate(invalid="ignore"):
        out |= (dists[:, 1:] < dists[:, :-1]).any(1)
    return out


def dist_err(metric: str, queries: torch.Tensor, base: torch.Tensor,
             rows: np.ndarray, dists: np.ndarray) -> float:
    """Largest |d - ref| / ref over the answers, ``rows`` in base's row
    space (well-formed answers only)."""
    worst = 0.0
    dev = base.device
    for i in range(0, rows.shape[0], DIST_BLOCK):
        r = torch.as_tensor(rows[i:i + DIST_BLOCK], device=dev)
        ref = reference.direct(metric, queries[i:i + DIST_BLOCK], base[r])
        got = torch.as_tensor(dists[i:i + DIST_BLOCK], device=dev).double()
        err = (got - ref).abs() / ref.abs().clamp_min(1e-300)
        if err.numel():
            worst = max(worst, float(err.max()))
    return worst


def recall_miss(metric: str, queries: torch.Tensor, base: torch.Tensor,
                rows: np.ndarray, k: int) -> float:
    """1 - recall@k of ``rows`` against the reference's exact top-k."""
    if rows.shape[0] == 0:
        return 1.0
    truth, _ = reference.topk(metric, base, queries, k)
    truth = truth.cpu().numpy()
    hits = sum(np.intersect1d(a, b).size for a, b in zip(rows, truth))
    return 1.0 - hits / (k * rows.shape[0])


def judge(metric: str, k: int, queries: torch.Tensor, base: torch.Tensor,
          row_of_id: np.ndarray, ids: np.ndarray, dists: np.ndarray,
          sample: np.ndarray, bad_adds: int = 0) -> dict:
    """The three numbers for answers ``ids``/``dists`` (n, k) to
    ``queries`` (n, D) over ``base`` (rows in stream order, on the device);
    ``sample`` indexes the answers whose recall is measured.  Returns the
    numbers and the per-answer ``bad`` mask."""
    bad = malformed_rows(ids, dists, row_of_id)
    good = np.flatnonzero(~bad)
    rows = row_of_id[np.clip(ids, 0, row_of_id.shape[0] - 1)]
    sel = torch.as_tensor(good, device=base.device)
    err = dist_err(metric, queries[sel], base, rows[good], dists[good])
    # malformed answers fail ``malformed``; recall is of the rest
    sample = sample[~bad[sample]]
    miss = recall_miss(metric,
                       queries[torch.as_tensor(sample, device=base.device)],
                       base, rows[sample], k)
    return dict(malformed=int(bad.sum()) + int(bad_adds),
                dist_err=err, recall_miss=miss, bad=bad)
