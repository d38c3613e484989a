"""Graph storage: dense, fixed-shape tensors on one device.

Counterpart of ``hnswindex_tpu/core/graph.py``, with the same fields and
shapes (C = capacity, D = dim, L = max levels, M = max_edges):

* ``vectors  (C, D) f32`` — stored items;
* ``vlo_store`` — bf16 ranking copy, or a 0-row sentinel when ranking runs
  on ``vectors`` (read through ``vlo``);
* ``coarse (C, D) bf16`` — mirror for the two-stage exact scan, or a 0-row
  sentinel when ``vlo_store`` is already bf16 or the metric is a
  registered one (no exact path);
* ``norms (C,) f32``, ``level (C,) i32`` (-1 = never used);
* ``nbr0 (C, 2M+slack0) i32`` / ``deg0 (C,) i32`` — layer-0 out-edges,
  slots >= deg are -1;
* ``nbru (L-1, C, M) i32`` / ``degu (L-1, C) i32`` — layers 1..L-1;
* ``active (C,) bool``; ``ep () i32`` entry point (-1 when empty);
  ``count () i32``.

Unlike the reference's immutable pytree, the tables are updated in place
(a wave's scatters write straight into the state's tensors).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import distance as dst

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Static configuration of the graph tables and their kernels."""

    dim: int
    metric: str = "sq_euclid"
    max_edges: int = 16        # M
    max_levels: int = 8        # L: level-table height
    ef_construction: int = 100
    search_iter_factor: int = 8
    build_expand: int = 8
    #: dtype of the ranking table ("float32" or "bfloat16")
    rank_dtype: str = "float32"
    #: extra layer-0 columns beyond the 2M cap that absorb reverse
    #: arrivals between overflow re-prunes (reference GraphConfig.slack0)
    slack0: int = 0


@dataclasses.dataclass
class GraphState:
    """The whole index as tensors on one device (see module docstring)."""

    vectors: torch.Tensor
    vlo_store: torch.Tensor
    coarse: torch.Tensor
    norms: torch.Tensor
    level: torch.Tensor
    nbr0: torch.Tensor
    deg0: torch.Tensor
    nbru: torch.Tensor
    degu: torch.Tensor
    active: torch.Tensor
    ep: torch.Tensor
    count: torch.Tensor

    @property
    def vlo(self) -> torch.Tensor:
        """The ranking vector table (falls back to the exact store)."""
        return self.vectors if self.vlo_store.shape[0] == 0 \
            else self.vlo_store

    @property
    def coarse_table(self) -> torch.Tensor | None:
        """bf16 table for the two-stage exact scan."""
        if self.coarse.shape[0]:
            return self.coarse
        if self.vlo_store.shape[0] and self.vlo_store.dtype == torch.bfloat16:
            return self.vlo_store
        return None

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def num_levels(self) -> int:
        return self.nbru.shape[0] + 1

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def nbr_slice(state: GraphState, layer: int):
    """(nbr_l (C, K_l), deg_l (C,)) views of one layer's tables; writes to
    them update the state."""
    if layer == 0:
        return state.nbr0, state.deg0
    return state.nbru[layer - 1], state.degu[layer - 1]


def upper_rows(state: GraphState, lay: torch.Tensor, ids: torch.Tensor):
    """Upper-layer neighbour rows of ``ids`` at per-lane layers ``lay``
    (both (B,)).  Only the greedy descent reads them, and it walks layers
    >= 1 only: a lane whose ``lay`` is out of range gathers a clamped row
    that the caller must mask."""
    Lu = state.nbru.shape[0]
    layu = (lay.long() - 1).clamp(0, Lu - 1)
    return state.nbru[layu, ids.long()]


def dense_tables(state: GraphState):
    """Host (L, C, K0) nbr / (L, C) deg view of the split tables (tests)."""
    nbr0 = state.nbr0.cpu().numpy()
    C, K0 = nbr0.shape
    L = state.num_levels
    Ku = state.nbru.shape[2]
    nbr = np.full((L, C, K0), -1, np.int32)
    nbr[0] = nbr0
    nbr[1:, :, :Ku] = state.nbru.cpu().numpy()
    deg = np.concatenate([state.deg0.cpu().numpy()[None],
                          state.degu.cpu().numpy()], axis=0)
    return nbr, deg


def default_max_levels(capacity: int, distribution_rate: float) -> int:
    """Level-table height: expected max level + 2 slack (reference
    ``default_max_levels``)."""
    exp_max = math.log(max(capacity, 2)) * max(distribution_rate, 1e-6)
    return max(4, int(exp_max) + 2)


def make_vlo(rank_dtype: str, vectors: torch.Tensor) -> torch.Tensor:
    """The ``vlo_store`` for ``vectors``: a cast copy for a bf16 ranking
    table, or the 0-row sentinel when ranking reads ``vectors``."""
    lo = _DTYPES[rank_dtype]
    if lo == vectors.dtype:
        return vectors.new_zeros((0,) + tuple(vectors.shape[1:]))
    return vectors.to(lo)


def make_coarse(cfg: GraphConfig, vectors: torch.Tensor) -> torch.Tensor:
    """The ``coarse`` bf16 mirror of ``vectors``, or the 0-row sentinel when
    no exact path exists (a registered metric) or ``vlo`` is bf16 already."""
    if dst.is_custom(cfg.metric) or _DTYPES[cfg.rank_dtype] == torch.bfloat16:
        return torch.zeros((0,) + tuple(vectors.shape[1:]),
                           dtype=torch.bfloat16, device=vectors.device)
    return vectors.to(torch.bfloat16)


def empty_state(cfg: GraphConfig, capacity: int,
                device: torch.device | str) -> GraphState:
    C, D, L = capacity, cfg.dim, cfg.max_levels
    i32 = dict(dtype=torch.int32, device=device)
    vectors = torch.zeros((C, D), dtype=torch.float32, device=device)
    return GraphState(
        vectors=vectors,
        vlo_store=make_vlo(cfg.rank_dtype, vectors),
        coarse=make_coarse(cfg, vectors),
        norms=torch.zeros((C,), dtype=torch.float32, device=device),
        level=torch.full((C,), -1, **i32),
        nbr0=torch.full((C, 2 * cfg.max_edges + cfg.slack0), -1, **i32),
        deg0=torch.zeros((C,), **i32),
        nbru=torch.full((L - 1, C, cfg.max_edges), -1, **i32),
        degu=torch.zeros((L - 1, C), **i32),
        active=torch.zeros((C,), dtype=torch.bool, device=device),
        ep=torch.tensor(-1, **i32),
        count=torch.tensor(0, **i32),
    )


def _pad_rows(t: torch.Tensor, pad: int, dim: int, value) -> torch.Tensor:
    if t.shape[dim] == 0 and dim == 0:
        return t                              # 0-row sentinel stays empty
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_full(shape, value)], dim=dim)


def grow_state(state: GraphState, new_capacity: int) -> GraphState:
    """Capacity growth by padding (reference doubling, GraphData.cs:95-115).
    """
    pad = new_capacity - state.capacity
    if pad <= 0:
        return state
    return GraphState(
        vectors=_pad_rows(state.vectors, pad, 0, 0.0),
        vlo_store=_pad_rows(state.vlo_store, pad, 0, 0.0),
        coarse=_pad_rows(state.coarse, pad, 0, 0.0),
        norms=_pad_rows(state.norms, pad, 0, 0.0),
        level=_pad_rows(state.level, pad, 0, -1),
        nbr0=_pad_rows(state.nbr0, pad, 0, -1),
        deg0=_pad_rows(state.deg0, pad, 0, 0),
        nbru=_pad_rows(state.nbru, pad, 1, -1),
        degu=_pad_rows(state.degu, pad, 1, 0),
        active=_pad_rows(state.active, pad, 0, False),
        ep=state.ep,
        count=state.count,
    )


def sample_levels(rng: np.random.Generator, n: int,
                  distribution_rate: float, max_levels: int) -> np.ndarray:
    """Vectorized exponential level sampling, copied verbatim from the
    reference so one seed gives the same levels in both packages.

    level = floor(-ln(U) * mL), U ~ Uniform(0,1) — GraphData.cs:211-219.
    The host-side RNG is consumed sequentially so that seeded builds are
    reproducible (parameters_test.py:60-81)."""
    u = rng.random(n)
    u = np.clip(u, 1e-30, None)
    lv = np.floor(-np.log(u) * distribution_rate).astype(np.int32)
    return np.clip(lv, 0, max_levels - 1)


def write_rows(state: GraphState, cfg: GraphConfig, rows: torch.Tensor,
               vecs: torch.Tensor, lvls: torch.Tensor) -> None:
    """Store vectors, their mirrors, norms and levels at ``rows`` and mark
    them active (GraphData.AddItem's storage half)."""
    state.vectors[rows] = vecs
    if state.vlo_store.shape[0]:
        state.vlo_store[rows] = vecs.to(state.vlo_store.dtype)
    if state.coarse.shape[0]:
        state.coarse[rows] = vecs.to(torch.bfloat16)
    state.norms[rows] = dst.norm_data(cfg.metric, vecs)
    state.level[rows] = lvls.to(torch.int32)
    state.active[rows] = True


def seed_first_node(cfg: GraphConfig, state: GraphState, slot: int,
                    vec: np.ndarray, lvl: int) -> None:
    """Insert the very first node: it becomes the entry point with no edges
    (GraphConnector.cs:27-33)."""
    dev = state.device
    rows = torch.tensor([slot], dtype=torch.int64, device=dev)
    write_rows(state, cfg, rows,
               torch.as_tensor(np.asarray(vec, np.float32)[None], device=dev),
               torch.tensor([lvl], dtype=torch.int32, device=dev))
    state.ep.fill_(slot)
    state.count += 1
