"""Graph statistics: hnswindex_torch's ``get_info`` and
``get_connected_component_counts`` against hnswindex_tpu's, on the
reference's 2,000 x 128 build (test_torch_construct) installed into the
port, and on the same graph after a removal.

Bars: every ``LayerInfo`` record equal field for field (counts, extremes,
means and the integer medians), and the component counts equal.  The
removal runs in the port only; its state is installed back into a copy of
the reference index (test_torch_remove's ``jax_clone``), so that both
packages read the same churned tables.  Also: an empty graph gives no
layers and no components, ``allow_removals=False`` reports zero in-edge
figures as the reference does, the component counts equal scipy's weak
components on a graph of several pieces, and a chain of 4,096 rows per
component (diameter C/2) converges in O(log C) rounds."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

import hnswindex_torch as T
import test_torch_construct as TCT
import test_torch_remove as TTR
import test_torch_search as TTS
from hnswindex_torch import convert
from hnswindex_torch.core import graph as TG
from hnswindex_torch.core import stats as TST
from hnswindex_tpu.core import stats as JST

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    ji = TCT.jax_build()._impl
    return ji, TTS.installed(ji)


def _records(info):
    return [dataclasses.asdict(x) for x in info.layers]


def _same_stats(ti, ji):
    got, want = _records(ti.get_info()), _records(ji.get_info())
    assert len(got) >= 2
    assert got == want
    assert ti.get_connected_component_counts() == \
        ji.get_connected_component_counts()


def test_stats_equal_reference(pair):
    ji, ti = pair
    _same_stats(ti, ji)
    info = ti.get_info()
    assert isinstance(info, T.HNSWInfo)
    assert isinstance(info.layers[0], T.LayerInfo)
    assert info.layers[0].nodes_count == TCT.N


def test_stats_equal_reference_after_removal(pair):
    """300 ids, the entry point among them, removed in the port; the
    reference reads the port's tables."""
    ji0, _ = pair
    ti = TTS.installed(ji0)
    rng = np.random.default_rng(21)
    ep = int(ti._state.ep)
    rem = np.unique(np.concatenate([[ep], rng.choice(TCT.N, 299,
                                                     replace=False)]))
    ti.remove(rem)
    ji = TTR.jax_clone(ji0)
    leaves = convert.state_to_numpy(ti._state)
    ji._state = ji._state._replace(
        **{f: jnp.asarray(leaves[f]) for f in convert.FIELDS})
    ji._count_host = ti._count_host
    _same_stats(ti, ji)
    assert ti.get_info().layers[0].nodes_count == TCT.N - rem.size


def test_in_edge_figures_zero_without_removals(pair):
    ji, _ = pair
    ti = TTS.installed(ji, allow_removals=False)
    got = _records(ti.get_info())
    want = [dataclasses.asdict(x) for x in JST.graph_info(
        ji._cfg, ji._state, report_in_edges=False).layers]
    assert got == want
    assert all(r["max_in_edges"] == 0 and r["avg_in_edges"] == 0.0
               for r in got)


def test_empty_graph():
    ix = T.HNSWIndex(8, device="cpu")
    assert ix.get_info().layers == []
    assert ix.get_connected_component_counts() == []
    assert T.Index(8, device="cpu").get_connected_component_counts() == []
    with pytest.raises(RuntimeError):
        T.Index(8, device="cpu").get_info()


def _state_with_layer0(nbr0):
    C = nbr0.shape[0]
    cfg = TG.GraphConfig(dim=4, max_edges=4, max_levels=4)
    st = TG.empty_state(cfg, C, "cpu")
    st.nbr0[:, :nbr0.shape[1]] = torch.from_numpy(nbr0)
    st.deg0[:] = torch.from_numpy((nbr0 >= 0).sum(1).astype(np.int32))
    st.active[:] = True
    st.level[:] = 0
    st.ep.fill_(0)
    st.count.fill_(C)
    return cfg, st


def test_components_equal_scipy_weak_components():
    """A random sparse directed graph of several weak pieces, some rows
    inactive: the count equals scipy's over the active rows."""
    rng = np.random.default_rng(4)
    C, K = 3000, 3
    nbr0 = np.full((C, 8), -1, np.int32)
    piece = rng.integers(0, 40, C)
    for u in range(C):
        mates = np.flatnonzero(piece == piece[u])
        nbr0[u, :K] = rng.choice(mates, K) if rng.random() < 0.7 else -1
    cfg, st = _state_with_layer0(nbr0)
    st.active[rng.random(C) < 0.1] = False
    act = st.active.numpy()
    e = [(u, int(v)) for u in np.flatnonzero(act) for v in nbr0[u]
         if v >= 0 and act[v]]
    u, v = np.asarray(e).T
    keep = np.flatnonzero(act)
    m = csr_matrix((np.ones(u.size), (u, v)), shape=(C, C))[keep][:, keep]
    want = connected_components(m, directed=True, connection="weak")[0]
    assert TST.connected_component_counts(cfg, st) == [want]


def test_components_chain_graph_converges_fast():
    """Two chains of C/2 rows (diameter C/2): plain label propagation
    needs O(C) rounds; with pointer jumping it converges in O(log C)."""
    C = 8192
    half = C // 2
    nbr0 = np.full((C, 8), -1, np.int32)
    nbr0[:half - 1, 0] = np.arange(1, half)
    nbr0[half:C - 1, 0] = np.arange(half + 1, C)
    cfg, st = _state_with_layer0(nbr0)
    bound = TST.components_iter_bound(C)
    cnt, nonempty, rounds = TST.components_at_layer(st, 0, bound)
    assert nonempty and cnt == 2
    assert rounds <= 2 * C.bit_length(), rounds
    st2 = copy.deepcopy(st)
    st2.active[:] = False
    assert TST.components_at_layer(st2, 0, bound)[:2] == (0, False)
