"""hnswindex_torch — the HNSW engine on PyTorch, for one CUDA device.

A port of ``hnswindex_tpu`` (the JAX reference, which stays beside it and
is what this package is tested against).  It imports torch and numpy and
never jax.  The graph path: ``add`` builds with wave-batched inserts, whose
exact corpus scan runs the hand-written CUDA lane-min kernel
(``csrc/fused_scan.cu``) on a CUDA device, and ``knn_query`` serves layer-0
k-NN through the packed engine; the unpacked engine serves the other query
paths, filters apply on every one, ``remove``/``update`` repair the graph
and reuse the slots, and a distance registered with ``register_metric``
(a torch callable) runs on every graph path.  ``get_info`` and
``get_connected_component_counts`` report on the graph; ``serialize`` /
``deserialize`` write and read the reference's ``.npz`` snapshots, and
``to_reference_snapshot`` / ``from_reference_snapshot`` /
``from_host_snapshot`` the .NET library's and the native host engine's
formats.  The block-serving path: :class:`BlockIndex` and the facade's
at-scale fallback route a query to its nearest blocks (exactly, or through
a graph over the centroids) and score them with the hand-written CUDA
block-scoring kernel (``csrc/block_scores.cu``).  The sharded front ends,
:class:`~hnswindex_torch.parallel.sharded.ShardedIndex` and
:class:`ShardedBlockIndex` (``parallel/``), split a corpus by row over
several devices (a device may repeat) and merge the shards' answers.

Public API: :class:`Index` (drop-in for the reference bindings),
:class:`HNSWIndex`, :class:`BlockIndex`, :class:`ShardedBlockIndex`,
:class:`HNSWParameters`,
:class:`HNSWInfo` / :class:`LayerInfo`, :class:`KNNResult` and
:func:`register_metric`.
"""

from .bindings_api import Index
from .block import BlockIndex
from .core.stats import HNSWInfo, LayerInfo
from .index import HNSWIndex
from .ops.distance import register_metric
from .params import HNSWParameters
from .parallel.block_sharded import ShardedBlockIndex
from .results import KNNResult

__version__ = "0.1.0"

__all__ = ["Index", "HNSWIndex", "HNSWParameters", "HNSWInfo", "LayerInfo",
           "KNNResult", "BlockIndex", "ShardedBlockIndex", "register_metric",
           "__version__"]
