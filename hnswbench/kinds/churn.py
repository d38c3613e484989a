"""Streaming churn, then k-NN serving of the churned index: the
runbook of a streaming deployment, whose topics are deleted whole and
filled again, with searches between the steps.

Set-up builds the index of the configuration's ``rows`` corpus rows in one
``add``, then runs ``rounds`` rounds.  Each round deletes every live row of
``clusters_per_round`` clusters drawn from the seed, without replacement,
among the clusters not deleted yet (``index.remove``), sends one search
step of ``step_queries`` queries of the ``warmup`` stream (the first query
after a mutation rebuilds the query pack and the host mirror), and inserts
as many fresh corpus rows as the round removed, taken from the corpus
stream after the last row used: they take the freed slots, so the live
count stays at ``rows`` and the capacity does not grow.  Then
``warmup_requests`` warm-up requests, and the window of ``kinds/knn.py``:
a request is one ``knn_query`` of the pool's next ``request_queries``
held-out queries.

A row's cluster is its nearest centre of the data (``Clustered.centres``),
the centre that made it while the noise is small against the gaps between
centres.  The kind keeps its own record of the live set (``row_of_id``:
each live id's row of the corpus stream, from the ids ``add`` returned and
the ids it removed), so the answers are judged without reading the
program: every window answer against exact search over the final live rows
(``checks.judge``: ``malformed``, ``dist_err``, and ``recall_miss`` of the
seeded sample), and every search step's answers against that round's live
set, whose malformed rows (a removed id among them) and distances count
toward ``malformed`` and ``dist_err``.  The steps' recall, over all their
well-formed answers, reads the graph straight after each repair, before
the refill reaches the holes: ``recall_miss`` is the larger of the
window's and the steps'.  An ``add`` whose ids are out of
range, repeated or still live is malformed too.

``setup`` keeps in ``st.setup`` what ``kinds/knn.py`` keeps there (the
build's ``rows`` and ``add_s``, the first warm-up request's
``first_query_s``), the host seconds of each round's delete, search step
and insert, the rows the rounds removed, and ``round_phases``: the
rounds run on a ``PhaseTimer`` of their own, handed to the index after the
build and taken back before the warm-ups, so that the index's timer holds
what it holds in every other cell (the one build from empty, the warm-ups'
pack) and the rounds' regions and tallies are read apart.  The control
(``sut.Control``, which cannot remove) runs the cell as ``ChurnControl``,
which frees and reuses slots.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hnswbench import checks, datagen, harness, reference, sut
from hnswbench.kinds import knn

#: stream tag of the rounds' cluster draws
ROUND_TAG = 11
#: rows whose nearest centre is found at once
CLUSTER_BLOCK = 1 << 14

min_units = knn.min_units
reset = knn.reset
request = knn.request
end_to_end = knn.end_to_end


class ChurnControl(sut.Control):
    """The TF32 control with removal: a removed id's slot is freed and
    handed out again, last freed first, and searches rank live rows
    only."""

    def __init__(self, config: dict, capacity: int, device):
        super().__init__(config, capacity, device)
        self.live = torch.zeros(int(capacity), dtype=torch.bool,
                                device=self.device)
        self.free: list = []

    def add(self, vecs: np.ndarray) -> np.ndarray:
        n = vecs.shape[0]
        take = min(n, len(self.free))
        ids = np.asarray(self.free[len(self.free) - take:][::-1] +
                         list(range(self.count, self.count + n - take)),
                         dtype=np.int32)
        del self.free[len(self.free) - take:]
        self.count += n - take
        dev_ids = torch.as_tensor(ids.astype(np.int64), device=self.device)
        self.base[dev_ids] = torch.as_tensor(vecs).to(self.device)
        self.live[dev_ids] = True
        return ids

    def remove(self, ids) -> None:
        ids = np.unique(np.asarray(ids, dtype=np.int64))
        self.live[torch.as_tensor(ids, device=self.device)] = False
        self.free.extend(int(x) for x in ids)

    def knn_query(self, q: np.ndarray, k: int):
        slots = torch.nonzero(self.live).flatten()
        rows, d = reference.topk(self.metric, self.base[slots],
                                 torch.as_tensor(q).to(self.device), k,
                                 precision="tf32")
        return (slots[rows].cpu().numpy().astype(np.int32),
                d.float().cpu().numpy())


class State(knn.State):
    def __init__(self, system, cell, data, device):
        if isinstance(system, type) and issubclass(system, sut.Control):
            system = ChurnControl
        super().__init__(system, cell, data, device)
        #: rows of the corpus stream handed to ``add`` so far
        self.used = 0
        #: the cluster of each corpus row used, in stream order
        self.cluster = np.empty(0, np.int64)
        #: per search step: (warmup row offset, ids, distances, the live
        #: set's row_of_id when it was answered)
        self.steps = []
        self.step_numbers = None

    def remove(self, ids: np.ndarray) -> None:
        index = getattr(self.sut, "index", None)
        (index.remove if index is not None else self.sut.remove)(ids)


def _nearest_centre(data: datagen.Clustered, x: torch.Tensor) -> np.ndarray:
    c = data.centres
    cn = (c * c).sum(1)
    out = []
    for i in range(0, x.shape[0], CLUSTER_BLOCK):
        d = cn[None, :] - 2.0 * (x[i:i + CLUSTER_BLOCK] @ c.T)
        out.append(torch.argmin(d, dim=1))
    return torch.cat(out).cpu().numpy()


def _next_rows(st: State, n: int) -> np.ndarray:
    """The corpus stream's next ``n`` rows as a host array; their clusters
    are appended to ``st.cluster``."""
    out = np.empty((n, st.data.dim), np.float32)
    clusters = []
    for i in range(0, n, datagen.CHUNK):
        j = min(n, i + datagen.CHUNK)
        x = st.data.rows("corpus", st.used + i, j - i)
        clusters.append(_nearest_centre(st.data, x))
        out[i:j] = x.cpu().numpy()
    st.cluster = np.concatenate([st.cluster, *clusters])
    st.used += n
    return out


def _add(st: State, n: int) -> float:
    """Insert the stream's next ``n`` rows and record the ids ``add``
    returned; returns its host seconds."""
    first = st.used
    vecs = _next_rows(st, n)
    t0 = time.perf_counter()
    ids = np.asarray(st.sut.add(vecs))
    st.sut.sync()
    add_s = time.perf_counter() - t0
    cap = st.row_of_id.shape[0]
    ok = ids.shape == (n,) and bool(((ids >= 0) & (ids < cap)).all()) \
        and np.unique(ids).size == n
    if ok and not (st.row_of_id[ids] >= 0).any():
        st.row_of_id[ids] = np.arange(first, first + n)
    else:
        st.bad_adds += 1
    return add_s


def setup(system, cell, data, device) -> State:
    st = State(system, cell, data, device)
    t = st.t
    n = st.row_of_id.shape[0]
    b, k = int(t["request_queries"]), int(t["k"])
    sb = int(t["step_queries"])
    rng = np.random.default_rng(datagen.sub_seed(st.seed, ROUND_TAG))
    alive = np.ones(data.centres.shape[0], bool)
    rounds = []
    add_s = _add(st, n)
    harness.log(f"build of {n} rows {add_s:.3f} s")
    index = getattr(st.sut, "index", None)
    if index is not None:
        build_timer = index.timer
        index.timer = type(build_timer)(index.device)
    for r in range(int(t["rounds"])):
        draw = rng.choice(np.flatnonzero(alive), int(t["clusters_per_round"]),
                          replace=False)
        alive[draw] = False
        live = np.flatnonzero(st.row_of_id >= 0)
        gone = live[np.isin(st.cluster[st.row_of_id[live]], draw)]
        t0 = time.perf_counter()
        st.remove(gone.astype(np.int32))
        st.sut.sync()
        delete_s = time.perf_counter() - t0
        st.row_of_id[gone] = -1
        warm = data.host_rows("warmup", r * sb, sb)
        t0 = time.perf_counter()
        ids, d = st.sut.knn_query(warm, k)
        step_s = time.perf_counter() - t0
        st.steps.append((r * sb, *checks.fit(ids, d, sb, k),
                         st.row_of_id.copy()))
        insert_s = _add(st, gone.size)
        rounds.append(dict(removed=int(gone.size), delete_s=delete_s,
                           step_s=step_s, insert_s=insert_s))
        harness.log(f"round {r}: removed {gone.size} rows of "
                    f"{draw.size} clusters, delete {delete_s:.3f} s, "
                    f"search step {step_s:.3f} s, insert {insert_s:.3f} s")
    round_phases = {}
    if index is not None:
        round_phases = index.timer.seconds()
        index.timer = build_timer
    warm = data.host_rows("warmup", 0, b)
    t0 = time.perf_counter()
    first_s = 0.0
    for i in range(int(t["warmup_requests"])):
        st.sut.knn_query(warm, k)
        if i == 0:
            first_s = time.perf_counter() - t0
    warmup_s = time.perf_counter() - t0
    harness.log(f"warm-ups {warmup_s:.3f} s")
    st.setup = dict(rows=n, add_s=add_s, first_query_s=first_s,
                    rounds=rounds, removed=sum(x["removed"] for x in rounds),
                    round_phases=round_phases, warmup_s=warmup_s)
    return st


def finish(st: State) -> dict:
    """Free the program, then judge the search steps and every answer of
    the window."""
    st.sut.close()
    return judge(st)


def _corpus(st: State) -> torch.Tensor:
    return st.data.rows("corpus", 0, st.used)


def _judge_steps(st: State, corpus: torch.Tensor) -> dict:
    """``malformed``, ``dist_err`` and ``recall_miss`` of the search steps'
    answers, each against the live set it was answered on (computed once).
    The recall is of every well-formed answer of every step."""
    if st.step_numbers is not None:
        return st.step_numbers
    bad, err, missed, judged = 0, 0.0, 0.0, 0
    metric, k = st.cfg["metric"], int(st.t["k"])
    for r, (off, ids, d, row_of_id) in enumerate(st.steps):
        q = st.data.rows("warmup", off, ids.shape[0])
        rows_bad = checks.malformed_rows(ids, d, row_of_id)
        good = np.flatnonzero(~rows_bad)
        rows = row_of_id[np.clip(ids, 0, row_of_id.shape[0] - 1)]
        sel = torch.as_tensor(good, device=corpus.device)
        err = max(err, checks.dist_err(metric, q[sel], corpus, rows[good],
                                       d[good]))
        bad += int(rows_bad.sum())
        live = np.flatnonzero(row_of_id >= 0)
        base = corpus[torch.as_tensor(row_of_id[live], device=corpus.device)]
        pos = np.full(row_of_id.shape[0], -1, np.int64)
        pos[live] = np.arange(live.size)
        miss = checks.recall_miss(metric, q[sel], base,
                                  pos[np.clip(ids[good], 0, None)], k)
        missed += miss * good.size
        judged += good.size
        harness.log(f"search step {r}: malformed {int(rows_bad.sum())}, "
                    f"recall@{k} {1.0 - miss:.5f}")
    miss = missed / judged if judged else (1.0 if st.steps else 0.0)
    harness.log(f"search steps: recall@{k} {1.0 - miss:.5f}")
    st.step_numbers = dict(malformed=bad, dist_err=err, recall_miss=miss)
    return st.step_numbers


def judge(st: State) -> dict:
    """The compared numbers: the window's answers against exact search
    over the final live rows (``knn.judge``'s check, on a base of those
    rows alone), with the search steps' ``malformed`` and ``dist_err``,
    and the larger of the window's and the steps' ``recall_miss``."""
    k, b = int(st.t["k"]), int(st.t["request_queries"])
    n = st.pos
    ids = np.concatenate([a[0] for a in st.answers]) if st.answers else \
        np.empty((0, k), np.int64)
    d = np.concatenate([a[1] for a in st.answers]) if st.answers else \
        np.empty((0, k))
    P = st.pool.shape[0]
    pos = torch.as_tensor(np.arange(n) % P, device=st.device)
    queries = torch.as_tensor(st.pool).to(st.device)[pos]
    rng = np.random.default_rng(datagen.sub_seed(st.seed, knn.SAMPLE_TAG))
    first = min_units(st)
    if n < first or P < first:
        raise RuntimeError(f"the recall sample is drawn from the first "
                           f"{first} queries: {n} answered, pool {P}")
    sample = np.sort(rng.choice(first, int(st.t["check_queries"]),
                                replace=False))
    corpus = _corpus(st)
    live = np.flatnonzero(st.row_of_id >= 0)
    base = corpus[torch.as_tensor(st.row_of_id[live], device=st.device)]
    base_row = np.full(st.row_of_id.shape[0], -1, np.int64)
    base_row[live] = np.arange(live.size)
    res = checks.judge(st.cfg["metric"], k, queries, base, base_row, ids, d,
                       sample, bad_adds=st.bad_adds)
    res["failed_requests"] = int(res["bad"].reshape(-1, b).any(1).sum()) \
        if n else 0
    steps = _judge_steps(st, corpus)
    res["malformed"] += steps["malformed"]
    res["dist_err"] = max(res["dist_err"], steps["dist_err"])
    res["recall_miss"] = max(res["recall_miss"], steps["recall_miss"])
    return res
