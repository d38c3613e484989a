"""Exact top-k over an allowed slot prefix in one fused float32 scan
(kernel K4): the removal's repair-candidate scan.

``repair_scan(metric, vectors, norms, allowed, q, k)`` returns the ``k``
nearest allowed rows of ``vectors (ns, D)`` to each query ``q (S, D)`` as
``(dists (S, k) float32, ids (S, k) int64)``, ascending, +inf / -1 padded:
the contract of ``ops/bruteforce.exact_knn``, whose blocked form, in
chunks of ``SCAN_CHUNK`` queries, is the plain twin ``repair_scan_ref``.
A CUDA tensor launches the kernel in ``csrc/repair_scan.cu`` (one call is
one launch of the scan and one of its sort, counted in
``repair_scan.calls``); a CPU tensor runs the twin; any other device
raises.  The two agree on ids up to float32 near-ties: the kernel sums the
dot products in another order and folds the metric in through
``affine_terms``.  Where at most ``COMPACT_SHARE`` of the rows are
allowed (an upper layer's members), both scan a gathered copy of the
allowed rows and map the ids back, so no work goes to masked rows.

Distances are full float32 on both: the kernel multiplies on the CUDA
cores (no TF32).  ``vectors`` may be a bfloat16 ranking table: both then
round the queries to bfloat16 and take the float32 products of the
rounded operands, as ``exact_knn`` does.  The kernel keeps a top-k of at
most ``KMAX``; the twin takes any ``k``.
"""

from __future__ import annotations

import ctypes

import torch

from . import distance as dst
from .bruteforce import exact_knn

#: queries a call of the plain twin takes at once (bounds its panel)
SCAN_CHUNK = 4096
#: widest top-k the kernel keeps (KMAX in the source)
KMAX = 512
#: allowed share of the rows at or below which the scan runs on a
#: gathered copy of the allowed rows
COMPACT_SHARE = 0.5


def affine_terms(metric: str, qn: torch.Tensor, norms: torch.Tensor,
                 allowed: torch.Tensor):
    """Per-query ``(qa, qm)`` and per-row ``(cb, cm)`` float32 terms such
    that ``(qa + cb) + dot * (qm * cm)`` is ``distance.from_dot``'s distance
    for an allowed row and +inf for any other (``cb`` = +inf, ``cm`` = 0):
    the kernel's epilogue.

    * sq_euclid: ``qn + cn - 2 dot``;
    * cosine: ``1 - dot (1/qn) (1/cn)``, a zero norm giving exactly 1 (the
      reference's guard), as its reciprocal is taken as 0;
    * ucosine: ``1 - dot``."""
    qn = qn.float()
    cn = norms.float()
    if metric == "sq_euclid":
        qa, qm = qn, torch.full_like(qn, -2.0)
        cb, cm = cn, torch.ones_like(cn)
    elif metric == "cosine":
        qa = torch.ones_like(qn)
        qm = -torch.where(qn > 0.0, 1.0 / qn, torch.zeros_like(qn))
        cb = torch.zeros_like(cn)
        cm = torch.where(cn > 0.0, 1.0 / cn, torch.zeros_like(cn))
    elif metric == "ucosine":
        qa, qm = torch.ones_like(qn), torch.full_like(qn, -1.0)
        cb, cm = torch.zeros_like(cn), torch.ones_like(cn)
    else:
        raise ValueError(f"repair_scan requires a built-in metric, got "
                         f"{metric!r}")
    cb = torch.where(allowed, cb, float("inf"))
    cm = torch.where(allowed, cm, torch.zeros_like(cm))
    return qa, qm, cb, cm


def repair_scan_ref(metric: str, vectors: torch.Tensor, norms: torch.Tensor,
                    allowed: torch.Tensor, q: torch.Tensor, k: int):
    """Plain twin of K4: ``exact_knn`` on chunks of ``SCAN_CHUNK``
    queries."""
    ds, ids = [], []
    for s0 in range(0, q.shape[0], SCAN_CHUNK):
        d, i = exact_knn(metric, vectors, norms, allowed,
                         q[s0:s0 + SCAN_CHUNK], k)
        ds.append(d)
        ids.append(i)
    return torch.cat(ds, dim=0), torch.cat(ids, dim=0)


def _check(metric, vectors, norms, allowed, q, k) -> None:
    if dst.is_custom(metric) or metric not in dst.VALID_METRICS:
        raise ValueError(f"repair_scan requires a built-in metric, got "
                         f"{metric!r}")
    if vectors.dim() != 2 or q.dim() != 2 or q.shape[1] != vectors.shape[1]:
        raise ValueError("repair_scan: vectors and q must be (ns, D) and "
                         "(S, D)")
    ns = vectors.shape[0]
    if norms.shape != (ns,) or allowed.shape != (ns,):
        raise ValueError("repair_scan: norms and allowed must be (ns,)")
    if vectors.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("repair_scan: vectors must be float32 or bfloat16")
    for name, t in (("norms", norms), ("q", q)):
        if t.dtype != torch.float32:
            raise TypeError(f"repair_scan: {name} must be float32")
    if allowed.dtype != torch.bool:
        raise TypeError("repair_scan: allowed must be bool")
    for name, t in (("norms", norms), ("allowed", allowed), ("q", q)):
        if t.device != vectors.device:
            raise ValueError(f"repair_scan: {name} is on {t.device}, vectors "
                             f"on {vectors.device}")
    for name, t in (("vectors", vectors), ("norms", norms),
                    ("allowed", allowed), ("q", q)):
        if not t.is_contiguous():
            raise ValueError(f"repair_scan: {name} must be contiguous")
    if k < 1:
        raise ValueError(f"repair_scan: k must be at least 1, got {k}")
    if vectors.device.type == "cuda" and k > KMAX:
        raise ValueError(f"repair_scan: the kernel keeps at most {KMAX} "
                         f"candidates a query, got k={k}")
    if vectors.device.type not in ("cuda", "cpu"):
        raise ValueError(f"repair_scan: no kernel for {vectors.device}")


def _launch(metric, vectors, norms, allowed, q, k: int):
    from . import _cuda

    dev = vectors.device
    ns, D = vectors.shape
    S = q.shape[0]
    lib = _cuda.library("repair_scan")
    P, rows = ctypes.c_int(), ctypes.c_int()
    # the C entry points plan and launch on the runtime's current device
    with torch.cuda.device(dev):
        err = lib.hnsw_repair_scan_plan(S, ns, k, ctypes.byref(P),
                                        ctypes.byref(rows))
        if err == -1:
            raise ValueError(f"repair_scan: the kernel refused S={S} "
                             f"ns={ns} k={k}")
        _cuda.check(err, "repair_scan")
        qa, qm, cb, cm = affine_terms(metric, dst.norm_data(metric, q),
                                      norms, allowed)
        # the twin's operands: the queries rounded to the table's type
        qk = q.to(vectors.dtype)
        pd = torch.empty((P.value, S, k), dtype=torch.float32, device=dev)
        pi = torch.empty((P.value, S, k), dtype=torch.int32, device=dev)
        out_d = torch.empty((S, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((S, k), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hnsw_repair_scan(
            qk.data_ptr(), vectors.data_ptr(), qa.data_ptr(), qm.data_ptr(),
            cb.data_ptr(), cm.data_ptr(), pd.data_ptr(), pi.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), S, ns, D, k, P.value,
            rows.value, int(vectors.dtype == torch.bfloat16), stream)
    if err == -1:
        raise ValueError(f"repair_scan: the kernel refused S={S} ns={ns} "
                         f"D={D} k={k} splits={P.value}")
    _cuda.check(err, "repair_scan")
    repair_scan.calls += 1
    return out_d, out_i


def repair_scan(metric: str, vectors: torch.Tensor, norms: torch.Tensor,
                allowed: torch.Tensor, q: torch.Tensor, k: int):
    """The ``k`` nearest allowed rows of ``vectors`` to each query (see the
    module docstring).  ``vectors (ns, D)`` float32 or bfloat16, ``norms
    (ns,)`` (the metric's norm data) and ``q (S, D)`` float32, ``allowed
    (ns,)`` bool, all contiguous on one device; ``1 <= k``, and
    ``k <= KMAX`` on the card."""
    _check(metric, vectors, norms, allowed, q, k)
    S, ns = q.shape[0], vectors.shape[0]
    rows = None
    n_allowed = int(allowed.sum()) if S else 0
    if S and n_allowed <= COMPACT_SHARE * ns:
        rows = allowed.nonzero().squeeze(1)
        vectors, norms = vectors[rows], norms[rows]
        allowed = torch.ones_like(rows, dtype=torch.bool)
    if S == 0 or n_allowed == 0:
        return (torch.full((S, k), float("inf"), device=q.device),
                torch.full((S, k), -1, dtype=torch.int64, device=q.device))
    if vectors.is_cuda:
        d, i = _launch(metric, vectors, norms, allowed, q, k)
    else:
        d, i = repair_scan_ref(metric, vectors, norms, allowed, q, k)
    if rows is not None:
        i = torch.where(i >= 0, rows[i.clamp(min=0)], -1)
    return d, i


#: launches of K4 in this process, one per call (scan and sort together)
repair_scan.calls = 0
