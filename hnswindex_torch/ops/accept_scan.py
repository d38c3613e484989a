"""The heuristic prune's sequential accept in one launch (kernel K3).

``accept_scan(pd, sd, svalid, max_edges)`` takes a prune's sorted
candidates, ``pd (B, N, N)`` float32 pairwise distances (``pd[b, c, s] =
d(s, c)``), ``sd (B, N)`` float32 distances to the target (ascending) and
``svalid (B, N)`` bool, and returns the accepted columns ``(B, N)`` bool,
at most ``max_edges`` a row (see ``csrc/accept_scan.cu`` for the rule and
the design).  It launches the CUDA kernel for a CUDA tensor and raises for
any other: its plain twin, which the CPU path runs, is
``core/heuristic._accept_capped``, and the two agree bit for bit.
"""

from __future__ import annotations

import torch


def accept_scan(pd: torch.Tensor, sd: torch.Tensor, svalid: torch.Tensor,
                max_edges: int) -> torch.Tensor:
    """Accepted columns of each row (see module docstring).  Counts one
    launch per call in ``accept_scan.calls``."""
    from . import _cuda

    if not pd.is_cuda:
        raise ValueError(f"accept_scan: no kernel for {pd.device}; the CPU "
                         "path is core.heuristic._accept_capped")
    B, N = sd.shape
    if pd.shape != (B, N, N) or svalid.shape != (B, N):
        raise ValueError("accept_scan: inconsistent shapes")
    for name, t in (("sd", sd), ("svalid", svalid)):
        if t.device != pd.device:
            raise ValueError(f"accept_scan: {name} is on {t.device}, pd on "
                             f"{pd.device}")
    for name, t in (("pd", pd), ("sd", sd), ("svalid", svalid)):
        if not t.is_contiguous():
            raise ValueError(f"accept_scan: {name} must be contiguous")
    if pd.dtype != torch.float32 or sd.dtype != torch.float32:
        raise TypeError("accept_scan: pd and sd must be float32")
    if svalid.dtype != torch.bool:
        raise TypeError("accept_scan: svalid must be bool")
    fn = _cuda.library("accept_scan").hnsw_accept_scan
    # the C entry point launches on the runtime's current device
    with torch.cuda.device(pd.device):
        out = torch.empty((B, N), dtype=torch.bool, device=pd.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pd.data_ptr(), sd.data_ptr(), svalid.data_ptr(),
                 out.data_ptr(), B, N, int(max_edges), stream)
    _cuda.check(err, "accept_scan")
    accept_scan.calls += 1
    return out


#: launches of K3 in this process, one per call
accept_scan.calls = 0
