"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain C entry points and is compiled with
``nvcc`` into its own shared library at first use, then loaded with
``ctypes``, which gets the entry points' signatures (``SIGNATURES``) once,
at load.  Nothing is compiled when a module is imported: the CPU paths
never need ``nvcc``.  Libraries land in ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), named by a hash of the source and
flags so an edited kernel is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
#: name -> {C entry point: its argument types}; every entry point returns
#: an ``int`` error code
SIGNATURES = {
    "fused_scan": {"hnsw_lane_min_scan": [_P] * 9 + [_I] * 5 + [_P]},
    "block_scores": {"hnsw_block_scores": [_P] * 8 + [_I] * 10 + [_P]},
    "accept_scan": {"hnsw_accept_scan": [_P] * 4 + [_I] * 3 + [_P]},
    "repair_scan": {"hnsw_repair_scan_plan": [_I] * 3 + [_IP] * 2,
                    "hnsw_repair_scan": [_P] * 10 + [_I] * 7 + [_P]},
}
#: name -> loaded ctypes library, per process
_LIBS: dict = {}
#: name -> seconds its last build took (0.0 when the library was cached)
build_seconds: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "hnswindex_torch/csrc at first use and need the CUDA "
                       "toolkit")


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiled if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{res.stderr}")
        os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _LIBS[name] = lib
    return lib


def prebuild(names) -> None:
    """Compile and load several kernels at once (one ``nvcc`` process per
    source, all started together) instead of one after another at first
    use."""
    from concurrent.futures import ThreadPoolExecutor
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(library, names))


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
