"""hnswindex_torch — the HNSW engine on PyTorch, for one CUDA device.

A port of ``hnswindex_tpu`` (the JAX reference, which stays beside it and
is what this package is tested against).  It imports torch and numpy and
never jax.  Two paths are ported.  The main path: ``add`` builds with
wave-batched exact-candidate inserts, whose corpus scan runs the
hand-written CUDA lane-min kernel (``csrc/fused_scan.cu``) on a CUDA
device, and ``knn_query`` serves layer-0 k-NN through the packed engine;
the unpacked engine serves the other query paths, filters apply on every
one, and ``remove``/``update`` repair the graph and reuse the slots.  The
block-serving path: :class:`BlockIndex` and the facade's at-scale fallback
route a query to its nearest blocks (exactly, or through a graph over the
centroids) and score them with the hand-written CUDA block-scoring kernel
(``csrc/block_scores.cu``).  Calls outside those slices raise
``NotImplementedError`` naming the ROADMAP item that ports them.

Public API: :class:`Index` (drop-in for the reference bindings),
:class:`HNSWIndex`, :class:`BlockIndex` and :class:`HNSWParameters`.
"""

from .bindings_api import Index
from .block import BlockIndex
from .index import HNSWIndex
from .params import HNSWParameters

__version__ = "0.1.0"

__all__ = ["Index", "HNSWIndex", "BlockIndex", "HNSWParameters",
           "__version__"]
