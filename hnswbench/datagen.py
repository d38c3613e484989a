"""Seeded vectors of a configuration, made on the device.

The clustered generator of ``chip_smoke.clustered`` (SIFT-like cluster
structure: uniform centres in [0, 1)^D, each row a random centre plus
Gaussian noise), rewritten in torch and seeded by the run's ``--seed``:
``rows // rows_per_cluster`` centres, noise ``noise``, and for angular
data each row divided by its norm, as ANN-Benchmarks stores angular sets.

Rows come in named streams that share the centres: ``corpus`` (what is
inserted), ``query`` (held-out queries, never corpus rows) and ``warmup``.
Row ``i`` of a stream depends only on the seed, the stream and ``i``: a
stream is made in chunks of ``CHUNK`` rows, each from a generator of its
own, so any stretch of it can be made again after the program is gone.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 16
STREAMS = {"centres": 0, "corpus": 1, "query": 2, "warmup": 3}


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one generator, from the run's seed and tags."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


class Clustered:
    """The vectors of one configuration (its ``data`` group) for one
    seed."""

    def __init__(self, config: dict, seed: int, device):
        data = config["data"]
        self.dim = int(config["dim"])
        self.noise = float(data["noise"])
        self.normalize = bool(data["normalize"])
        self.seed = int(seed)
        self.device = torch.device(device)
        n_centres = max(2, int(config["rows"])
                        // int(data["rows_per_cluster"]))
        g = _generator(self.device, sub_seed(seed, STREAMS["centres"]))
        self.centres = torch.rand((n_centres, self.dim), generator=g,
                                  device=self.device)
        self._cached = (None, None)

    def _chunk(self, stream: str, c: int) -> torch.Tensor:
        key = (stream, c)
        if self._cached[0] == key:
            return self._cached[1]
        g = _generator(self.device, sub_seed(self.seed, STREAMS[stream], c))
        pick = torch.randint(0, self.centres.shape[0], (CHUNK,), generator=g,
                             device=self.device)
        x = self.centres[pick] + self.noise * torch.randn(
            (CHUNK, self.dim), generator=g, device=self.device)
        if self.normalize:
            x = x / x.norm(dim=1, keepdim=True)
        self._cached = (key, x)
        return x

    def rows(self, stream: str, start: int, n: int) -> torch.Tensor:
        """Rows ``start .. start + n - 1`` of ``stream``, (n, dim) float32 on
        the device."""
        parts = []
        i = start
        while i < start + n:
            c, off = divmod(i, CHUNK)
            take = min(CHUNK - off, start + n - i)
            parts.append(self._chunk(stream, c)[off:off + take])
            i += take
        if not parts:
            return torch.empty((0, self.dim), device=self.device)
        return torch.cat(parts) if len(parts) > 1 else parts[0].clone()

    def host_rows(self, stream: str, start: int, n: int) -> np.ndarray:
        """The same rows as a host array, made chunk by chunk."""
        out = np.empty((n, self.dim), np.float32)
        for i in range(0, n, CHUNK):
            j = min(n, i + CHUNK)
            out[i:j] = self.rows(stream, start + i, j - i).cpu().numpy()
        return out
