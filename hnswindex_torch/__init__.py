"""hnswindex_torch — the HNSW engine on PyTorch, for one CUDA device.

A port of ``hnswindex_tpu`` (the JAX reference, which stays beside it and
is what this package is tested against).  It imports torch and numpy and
never jax.  The main path is ported: ``add`` builds with wave-batched
exact-candidate inserts, whose corpus scan runs the hand-written CUDA
lane-min kernel (``csrc/fused_scan.cu``) on a CUDA device, and
``knn_query`` serves unfiltered layer-0 k-NN through the packed engine.
Calls outside that slice raise ``NotImplementedError`` naming the ROADMAP
item that ports them.

Public API: :class:`Index` (drop-in for the reference bindings),
:class:`HNSWIndex` and :class:`HNSWParameters`.
"""

from .bindings_api import Index
from .index import HNSWIndex
from .params import HNSWParameters

__version__ = "0.1.0"

__all__ = ["Index", "HNSWIndex", "HNSWParameters", "__version__"]
