"""Rich result records: the reference's ``KNNResult<TVector, TDistance>``
(src/HNSWIndex/KNNResult.cs:3-16: Id, Label (the stored vector) and
Distance), as ``HNSWIndex.knn_query_results`` returns them."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class KNNResult:
    id: int
    label: np.ndarray   # the stored vector (KNNResult.cs "Label")
    distance: float
