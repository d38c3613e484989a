"""The system under test, and the control that takes its place.

``Program`` is ``hnswindex_torch.HNSWIndex`` built from a configuration's
``index`` group, the only part of the program the benchmark drives; its
``phase_seconds`` are the index's own ``PhaseTimer`` spans.  ``Control``
answers the same calls with the plain reference in TF32 (``reference.py``):
it stores the rows it is given and serves exact TF32 k-NN over them.  A run
with the control in the program's place must come out not correct.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from . import reference


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class Program:
    def __init__(self, config: dict, capacity: int, device):
        from hnswindex_torch import HNSWIndex, HNSWParameters
        self.device = torch.device(device)
        params = HNSWParameters(**config["index"],
                                collection_size=int(capacity))
        self.index = HNSWIndex(int(config["dim"]), config["metric"], params,
                               self.device)

    def add(self, vecs: np.ndarray) -> np.ndarray:
        return self.index.add(vecs)

    def knn_query(self, q: np.ndarray, k: int):
        return self.index.knn_query(q, k)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def phase_seconds(self) -> dict:
        return self.index.timer.seconds()

    def close(self) -> None:
        self.index = None
        _free(self.device)


class Control:
    def __init__(self, config: dict, capacity: int, device):
        self.device = torch.device(device)
        self.metric = config["metric"]
        self.base = torch.empty((int(capacity), int(config["dim"])),
                                device=self.device)
        self.count = 0

    def add(self, vecs: np.ndarray) -> np.ndarray:
        n = vecs.shape[0]
        self.base[self.count:self.count + n] = torch.as_tensor(vecs).to(
            self.device)
        ids = np.arange(self.count, self.count + n, dtype=np.int32)
        self.count += n
        return ids

    def knn_query(self, q: np.ndarray, k: int):
        rows, d = reference.topk(self.metric, self.base[:self.count],
                                 torch.as_tensor(q).to(self.device), k,
                                 precision="tf32")
        return (rows.cpu().numpy().astype(np.int32),
                d.float().cpu().numpy())

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def phase_seconds(self) -> dict:
        return {}

    def close(self) -> None:
        self.base = None
        _free(self.device)


SYSTEMS = {"program": Program, "control": Control}
