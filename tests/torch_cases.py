"""Inputs shared by the port's CPU tests and its card tests.

The module imports no jax, so ``tests/test_torch_kernels_cuda.py`` can
import it where jax is not installed.  pytest collects no test here.
"""

import numpy as np


def clustered(n, dim, n_centers, rng, spread=0.05):
    """``n`` float32 rows of width ``dim`` around ``n_centers`` uniform
    centres, Gaussian noise of ``spread``."""
    centers = rng.random((n_centers, dim)).astype(np.float32)
    who = rng.integers(0, n_centers, n)
    return (centers[who]
            + spread * rng.standard_normal((n, dim)).astype(np.float32))


def accept_inputs(seed, B, N, chunk=128):
    """Sorted candidates of B random targets in 3-d (many conflicts), as the
    heuristic's accept takes them: ``pd (B, N, N)`` float32 with ``pd[b, c,
    s] = d(s, c)``, ``sd (B, N)`` float32 ascending, ``valid (B, N)`` bool.
    They hold exact ties pd == sd, NaN pairwise distances and invalid
    columns in the middle; with B >= 3 also an all-invalid row (0), a row of
    three valid columns (1, keep all) and a row with no conflicts (2, it
    reaches the cap first).  Rows are drawn ``chunk`` at a time, so large B
    stays within a few hundred MB of temporaries."""
    rng = np.random.default_rng(seed)
    pd = np.empty((B, N, N), np.float32)
    sd = np.empty((B, N), np.float32)
    valid = np.empty((B, N), bool)
    for lo in range(0, B, chunk):
        b = min(chunk, B - lo)
        pts = rng.random((b, N, 3)).astype(np.float32)
        tgt = rng.random((b, 1, 3)).astype(np.float32)
        d = ((pts - tgt) ** 2).sum(-1)
        order = np.argsort(d, axis=1, kind="stable")
        d = np.take_along_axis(d, order, 1)
        pts = np.take_along_axis(pts, order[:, :, None], 1)
        p = sum((pts[:, :, None, k] - pts[:, None, :, k]) ** 2
                for k in range(3))
        u = rng.random((b, N, N), dtype=np.float32)
        p = np.where(u < 0.05, d[:, :, None], p)
        p[(u >= 0.05) & (u < 0.07)] = np.nan
        pd[lo:lo + b], sd[lo:lo + b] = p, d
        valid[lo:lo + b] = rng.random((b, N)) < 0.85
    if B >= 3:
        valid[0] = False
        valid[1, 3:] = False
        pd[2] = np.inf
    return pd, sd, valid
