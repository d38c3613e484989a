"""`Index` — drop-in for the reference's Python bindings.

Counterpart of ``hnswindex_tpu/bindings_api.py``: same constructor (plus
the torch ``device``), same metric strings, lazy initialization on the
first ``add``, setters that raise once the index is initialized, and the
same array shapes and dtypes (``add`` -> int32 ids; ``knn_query`` -> (n, k)
int32 ids and float32 distances, -1/NaN padded).  Entry points not ported
yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from .index import HNSWIndex
from .ops import distance as dst
from .params import HNSWParameters


class Index:
    """Python-bindings-compatible facade (bindings.py:142-171)."""

    def __init__(self, dim: int, metric: str = "sq_euclid",
                 device: torch.device | str = "cuda"):
        dst.check_metric(metric)
        self.dim = int(dim)
        self.metric = metric
        self.device = torch.device(device)
        self._initialized = False
        self._params = HNSWParameters()
        self._impl: HNSWIndex | None = None

    def _require_uninitialized(self):
        if self._initialized:
            raise RuntimeError(
                "configuration setters must be called before the index is "
                "initialized (before the first add)")

    def _require_initialized(self) -> HNSWIndex:
        if self._impl is None:
            raise RuntimeError("index is not initialized; add items first")
        return self._impl

    # -- setters (bindings.py:200-398) ----------------------------------

    def set_collection_size(self, init_size: int):
        self._require_uninitialized()
        if init_size < 1:
            raise RuntimeError("collection_size must be >= 1")
        self._params.collection_size = int(init_size)

    def set_max_edges(self, max_conn: int):
        self._require_uninitialized()
        if max_conn < 1:
            raise RuntimeError("max_edges must be >= 1")
        self._params.max_edges = int(max_conn)

    def set_max_candidates(self, max_candidates: int):
        self._require_uninitialized()
        if max_candidates < 1:
            raise RuntimeError("max_candidates must be >= 1")
        self._params.max_candidates = int(max_candidates)

    def set_remove_max_candidates(self, rem_max_candidates: int):
        self._require_uninitialized()
        if rem_max_candidates < 1:
            raise RuntimeError("remove_max_candidates must be >= 1")
        self._params.remove_max_candidates = int(rem_max_candidates)

    def set_distribution_rate(self, dist_rate: float):
        self._require_uninitialized()
        if dist_rate < 0:
            raise RuntimeError("distribution_rate must be >= 0")
        self._params.distribution_rate = float(dist_rate)

    def set_random_seed(self, random_seed: int):
        self._require_uninitialized()
        self._params.random_seed = int(random_seed)

    def set_min_nn(self, min_nn: int):
        self._require_uninitialized()
        if min_nn < 1:
            raise RuntimeError("min_nn must be >= 1")
        self._params.min_nn = int(min_nn)

    def set_allow_removals(self, allow_removals: bool):
        self._require_uninitialized()
        self._params.allow_removals = bool(allow_removals)

    # -- data ops -------------------------------------------------------

    def add(self, vecs) -> np.ndarray:
        if not self._initialized:
            self._impl = HNSWIndex(self.dim, self.metric, self._params,
                                   self.device)
            self._initialized = True
        return self._impl.add(vecs)

    def remove(self, ids) -> None:
        self._require_initialized().remove(ids)

    def knn_query(self, queries, k: int, filter_fnc=None, layer: int = 0,
                  exact: bool = False):
        return self._require_initialized().knn_query(
            queries, k, filter_fnc=filter_fnc, layer=layer, exact=exact)

    def range_query(self, queries, radius: float, filter_fnc=None,
                    layer: int = 0):
        return self._require_initialized().range_query(
            queries, radius, filter_fnc=filter_fnc, layer=layer)

    def multi_layer_knn_query(self, query, k: int, max_layer: int = 2 ** 30,
                              min_layer: int = 0):
        return self._require_initialized().multi_layer_knn_query(
            query, k, max_layer, min_layer)

    @property
    def count(self) -> int:
        return 0 if self._impl is None else self._impl.count

    def ids(self) -> np.ndarray:
        if self._impl is None:
            return np.empty(0, np.int32)
        return self._impl.ids()

    def items(self) -> np.ndarray:
        if self._impl is None:
            return np.empty((0, self.dim), np.float32)
        return self._impl.items()

    def get_info(self):
        return self._require_initialized().get_info()

    def get_connected_component_counts(self):
        return self._require_initialized().get_connected_component_counts()

    def serialize(self, path: str) -> None:
        self._require_initialized().serialize(path)

    @classmethod
    def deserialize(cls, path: str) -> "Index":
        return HNSWIndex.deserialize(path)
