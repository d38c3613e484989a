"""k-NN serving of a built index, one closed-loop client.

Set-up builds the index of the configuration's ``rows`` corpus rows in one
``add``, makes the mix's pool of ``pool`` held-out queries, and sends
``warmup_requests`` requests of warm-up queries (the first builds the
query pack).  A request is one ``knn_query`` of the pool's next
``request_queries`` queries, cycling the pool.  After the window every
answer's ids and distances are judged, and the recall of
``check_queries`` of them drawn from the seed among the window's first
``sample_from`` answers (no query of which comes twice).  The window runs
on until ``sample_from`` queries are answered, so that the sample never
hangs on the run's speed; a window that ends short of it (a request that
answers nothing) raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hnswbench import checks, datagen

#: stream tag of the recall sample's draw
SAMPLE_TAG = 9


class State:
    def __init__(self, system, cell, data, device):
        self.t = cell.traffic
        self.cfg = cell.config
        self.data = data
        self.device = device
        self.seed = data.seed
        n = int(cell.config["rows"])
        self.sut = system(cell.config, n, device)
        self.row_of_id = np.full(n, -1, np.int64)
        self.bad_adds = 0
        self.pool = data.host_rows("query", 0, int(self.t["pool"]))
        self.pos = 0
        self.answers = []
        self.ctx = dict(queries=0)
        #: the set-up build: rows and host seconds of its one ``add``, and
        #: of the first warm-up request (which builds the query pack)
        self.setup = {}


def setup(system, cell, data, device) -> State:
    """Build the index in one ``add`` and warm the query path up; the
    times of the two are kept for the set-up's per-layer metrics."""
    st = State(system, cell, data, device)
    n = st.row_of_id.shape[0]
    vecs = data.host_rows("corpus", 0, n)
    t0 = time.perf_counter()
    ids = np.asarray(st.sut.add(vecs))
    st.sut.sync()
    add_s = time.perf_counter() - t0
    if (ids.shape == (n,) and bool(((ids >= 0) & (ids < n)).all())
            and np.unique(ids).size == n):
        st.row_of_id[ids] = np.arange(n)
    else:
        st.bad_adds = 1
    b, k = int(st.t["request_queries"]), int(st.t["k"])
    warm = data.host_rows("warmup", 0, b)
    first_s = 0.0
    for i in range(int(st.t["warmup_requests"])):
        t0 = time.perf_counter()
        st.sut.knn_query(warm, k)
        if i == 0:
            first_s = time.perf_counter() - t0
    st.setup = dict(rows=n, add_s=add_s, first_query_s=first_s)
    return st


def request(st: State) -> int:
    b, P = int(st.t["request_queries"]), st.pool.shape[0]
    i = st.pos % P
    q = st.pool[i:i + b] if i + b <= P else \
        st.pool[(st.pos + np.arange(b)) % P]
    k = int(st.t["k"])
    st.answers.append(checks.fit(*st.sut.knn_query(q, k), b, k))
    st.pos += b
    st.ctx["queries"] += b
    return b


def min_units(st: State) -> int:
    """Queries the window answers at the least: the recall sample's span."""
    return int(st.t["sample_from"])


def reset(st: State) -> None:
    """Forget the window's answers: the next one starts the pool again."""
    st.answers, st.pos, st.ctx = [], 0, dict(queries=0)


def finish(st: State) -> dict:
    """Free the program, then judge every answer of the window."""
    st.sut.close()
    return judge(st)


def judge(st: State) -> dict:
    """The compared numbers of every answer of the window."""
    k, b = int(st.t["k"]), int(st.t["request_queries"])
    n = st.pos
    ids = np.concatenate([a[0] for a in st.answers]) if st.answers else \
        np.empty((0, k), np.int64)
    d = np.concatenate([a[1] for a in st.answers]) if st.answers else \
        np.empty((0, k))
    P = st.pool.shape[0]
    pos = torch.as_tensor(np.arange(n) % P, device=st.device)
    queries = torch.as_tensor(st.pool).to(st.device)[pos]
    rng = np.random.default_rng(datagen.sub_seed(st.seed, SAMPLE_TAG))
    first = min_units(st)
    if n < first or P < first:
        raise RuntimeError(f"the recall sample is drawn from the first "
                           f"{first} queries: {n} answered, pool {P}")
    sample = np.sort(rng.choice(first, int(st.t["check_queries"]),
                                replace=False))
    base = st.data.rows("corpus", 0, int(st.cfg["rows"]))
    res = checks.judge(st.cfg["metric"], k, queries, base, st.row_of_id,
                       ids, d, sample, bad_adds=st.bad_adds)
    res["failed_requests"] = int(res["bad"].reshape(-1, b).any(1).sum()) \
        if n else 0
    return res


def end_to_end(st: State, span_s: float, latencies: list,
               res: dict) -> dict:
    return dict(query_rate=st.ctx["queries"] / span_s,
                query_p95_ms=(float(np.percentile(latencies, 95)) * 1e3
                              if latencies else float("nan")),
                recall_at_10=1.0 - res["recall_miss"])
