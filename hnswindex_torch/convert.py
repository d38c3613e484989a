"""Graph state to and from plain numpy arrays.

``state_from_numpy`` builds a :class:`~hnswindex_torch.core.graph.GraphState`
from a dict of the reference package's ``GraphState`` leaves after
``np.asarray`` (the caller converts; nothing here imports jax), so a graph
built by one package can be searched by the other;
``sharded_states_from_numpy`` does it for each shard of a sharded index's
stacked leaves.  bfloat16 leaves arrive
as ``ml_dtypes.bfloat16`` arrays and are carried bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.graph import GraphConfig, GraphState

FIELDS = tuple(f.name for f in dataclasses.fields(GraphState))


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def state_from_numpy(leaves: dict, cfg: GraphConfig,
                     device: torch.device | str = "cuda") -> GraphState:
    """Port state from ``{field: np.ndarray}`` (every GraphState field)."""
    missing = [f for f in FIELDS if f not in leaves]
    if missing:
        raise KeyError(f"state_from_numpy: missing fields {missing}")
    st = GraphState(**{f: _to_tensor(leaves[f], device) for f in FIELDS})
    if st.nbr0.shape[1] != 2 * cfg.max_edges + cfg.slack0:
        raise ValueError("state_from_numpy: nbr0 width does not match cfg")
    return st


def sharded_states_from_numpy(leaves: dict, cfg: GraphConfig,
                              devices) -> list:
    """Per-shard port states from the sharded reference's stacked leaves
    (every field with a leading shard axis, ``(S, C, ...)``): shard ``s``
    goes to ``devices[s]``."""
    devices = list(devices)
    S = leaves["vectors"].shape[0]
    if len(devices) != S:
        raise ValueError(f"sharded_states_from_numpy: {S} shards but "
                         f"{len(devices)} devices")
    return [state_from_numpy({f: v[s] for f, v in leaves.items()}, cfg,
                             devices[s]) for s in range(S)]


def state_to_numpy(state: GraphState) -> dict:
    """``{field: np.ndarray}``; bfloat16 leaves come back as
    ``ml_dtypes.bfloat16`` arrays."""
    out = {}
    for f in FIELDS:
        t = getattr(state, f).detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            out[f] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[f] = t.numpy()
    return out
