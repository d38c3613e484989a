"""Index persistence: the ``.npz`` snapshot and the host engine's format.

Counterpart of ``hnswindex_tpu/core/snapshot.py``, and the same file
format, so that either package loads the other's files:

* a single ``.npz`` (``np.savez_compressed``) holding a JSON ``header``
  (format version 2, dim, metric name, length, capacity, level-table
  height, entry point, count and ``parameters`` =
  ``dataclasses.asdict(params)``) and the state arrays ``vectors``,
  ``norms``, ``level``, ``nbr0``, ``deg0``, ``nbru``, ``degu``, ``active``
  compacted to ``length`` rows, plus the free list;
* the distance function is code, not data: the metric's name is stored and
  checked at load, so a registered metric must be registered again before
  a load (the reference re-supplies its delegate, HNSWIndex.cs:222);
* the ranking and coarse mirrors are not stored: the loader rebuilds them
  for its own ``rank_dtype``.

``load_host_snapshot`` parses the native C++ host engine's ``HNSWHST1``
files (``hnswindex_tpu/native/hnsw_host.cpp``); this package never builds or
loads that engine.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import torch

from ..ops import distance as dst
from ..params import HNSWParameters
from .graph import GraphConfig, GraphState

FORMAT_VERSION = 2   # v2: layer-0 and upper-layer tables stored split

#: magic of the native host engine's snapshot
_HOST_MAGIC = b"HNSWHST1"


def npz_path(path) -> str:
    """``np.savez_compressed`` appends ".npz" when it is missing; loaders
    do the same, so that ``serialize("x")`` / ``deserialize("x")``
    round-trips."""
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


def load_host_snapshot(path: str):
    """Parse a native host-engine snapshot into (params, metric, dim,
    capacity, length, entry point, count, free list, levels, removed
    flags, vectors, per-node edge lists)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _HOST_MAGIC:
        raise ValueError("not a host-engine snapshot")
    off = 8

    def r32():
        nonlocal off
        v = struct.unpack_from("<i", data, off)[0]
        off += 4
        return v

    dim = r32()
    metric = ("sq_euclid", "cosine", "ucosine")[r32()]
    p = HNSWParameters()
    p.max_edges = r32()
    p.min_nn = r32()
    p.max_candidates = r32()
    p.remove_max_candidates = r32()
    p.collection_size = r32()
    p.random_seed = r32()
    p.allow_removals = bool(r32())
    p.distribution_rate = struct.unpack_from("<d", data, off)[0]
    off += 8
    capacity = r32()
    length = r32()
    entry = r32()
    count = r32()
    free = [r32() for _ in range(r32())]

    levels = np.full(length, -1, np.int32)
    removed = np.zeros(length, bool)
    vectors = np.zeros((length, dim), np.float32)
    edges = [None] * length
    for i in range(length):
        levels[i] = r32()
        removed[i] = bool(r32())
        if levels[i] < 0:
            continue
        vectors[i] = np.frombuffer(data, np.float32, dim, off)
        off += 4 * dim
        node_edges = []
        for _ in range(levels[i] + 1):
            deg = r32()
            node_edges.append(np.frombuffer(data, np.int32, deg, off).copy())
            off += 4 * deg
        edges[i] = node_edges
    return (p, metric, dim, capacity, length, entry, count, free, levels,
            removed, vectors, edges)


def save(path: str, cfg: GraphConfig, params: HNSWParameters,
         state: GraphState, length: int, free: list, dim: int) -> None:
    """Write the snapshot (the rows past ``length`` are not stored)."""
    n = int(length)
    header = {
        "format_version": FORMAT_VERSION,
        "dim": dim,
        "metric": cfg.metric,
        "length": n,
        "capacity": int(state.capacity),
        "max_levels": int(state.num_levels),
        "ep": int(state.ep),
        "count": int(state.count),
        "parameters": dataclasses.asdict(params),
    }

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    np.savez_compressed(
        path,
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        vectors=host(state.vectors[:n]),
        norms=host(state.norms[:n]),
        level=host(state.level[:n]),
        nbr0=host(state.nbr0[:n]),
        deg0=host(state.deg0[:n]),
        nbru=host(state.nbru[:, :n]),
        degu=host(state.degu[:, :n]),
        active=host(state.active[:n]),
        free=np.asarray(free, dtype=np.int32),
    )


def load(path: str, device: torch.device | str):
    """Returns (header dict, params, state with its arrays re-padded to
    capacity on ``device``, free list).  The state's ``vlo_store`` and
    ``coarse`` are empty: the caller rebuilds them for its rank dtype."""
    with np.load(npz_path(path)) as z:
        header = json.loads(bytes(z["header"]).decode())
        if header["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"unsupported snapshot version {header['format_version']}")
        # a registered metric must be registered again before a load
        dst.check_metric(header["metric"])
        pad = header["capacity"] - header["length"]

        def dev(a: np.ndarray, axis: int = 0, value=0) -> torch.Tensor:
            width = [(0, 0)] * a.ndim
            width[axis] = (0, pad)
            return torch.from_numpy(np.pad(a, width, constant_values=value)
                                    ).to(device)

        vectors = dev(z["vectors"])
        state = GraphState(
            vectors=vectors,
            vlo_store=vectors[:0],
            coarse=vectors[:0].to(torch.bfloat16),
            norms=dev(z["norms"]),
            level=dev(z["level"], value=-1),
            nbr0=dev(z["nbr0"], value=-1),
            deg0=dev(z["deg0"]),
            nbru=dev(z["nbru"], axis=1, value=-1),
            degu=dev(z["degu"], axis=1),
            active=dev(z["active"]),
            ep=torch.tensor(header["ep"], dtype=torch.int32, device=device),
            count=torch.tensor(header["count"], dtype=torch.int32,
                               device=device),
        )
        if tuple(state.vectors.shape) != (header["capacity"], header["dim"]) \
                or state.num_levels != header["max_levels"]:
            raise ValueError("snapshot arrays do not match their header")
        params = HNSWParameters(**header["parameters"])
        free = [int(x) for x in z["free"]]
    return header, params, state, free
