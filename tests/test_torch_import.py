"""The port stands without jax, triton or a CUDA toolchain at import."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

import hnswindex_torch

PKG = pathlib.Path(hnswindex_torch.__file__).resolve().parent
ROOT = PKG.parent


# One subprocess for both import checks (starting one costs seconds): no
# nvcc on PATH and no card, so the kernel wrapper must import and run its
# CPU path without compiling anything.
_PROBE = """
import json, sys, torch
import hnswindex_torch, hnswindex_torch.convert, hnswindex_torch.block
from hnswindex_torch.ops import block_scores, fused_scan, _cuda
c = torch.zeros((256, 8), dtype=torch.bfloat16)
m, b = fused_scan.rank_transform('sq_euclid', torch.zeros(256),
                                 torch.ones(256, dtype=torch.bool))
v, i = fused_scan.lane_min_scan(c, m, b, torch.zeros((2, 8)),
                                torch.full((2,), -1, dtype=torch.int32), BS=64)
ix = hnswindex_torch.BlockIndex(8, block_size=16, device="cpu")
ix.build(torch.rand((100, 8), generator=torch.Generator().manual_seed(0))
         .numpy())
bi, _ = ix.knn_query(ix._h_vecs[0, :2], 1, n_probe=2)
print(json.dumps({"jax": "jax" in sys.modules,
                  "block_ids": bi[:, 0].tolist(),
                  "block_want": ix._h_ids[0, :2].tolist(),
                  "block_launches": block_scores.block_scores.launches,
                  "triton": "triton" in sys.modules,
                  "shape": list(i.shape),
                  "launches": fused_scan.lane_min_scan.launches,
                  "libs": sorted(_cuda._LIBS)}))
"""


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PATH=str(tmp_path_factory.mktemp("empty_path")),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_import_leaves_jax_out(probe):
    assert not probe["jax"], "jax imported"


def test_kernel_module_imports_without_toolchain(probe):
    assert not probe["triton"]
    assert probe["shape"] == [2, 64] and probe["launches"] == 0
    assert probe["libs"] == []


def test_block_module_runs_without_jax_or_toolchain(probe):
    """hnswindex_torch.block builds and answers on the CPU in a process
    that has neither jax nor nvcc, through the kernel's plain version."""
    assert not probe["jax"] and not probe["triton"]
    assert probe["block_ids"] == probe["block_want"]
    assert probe["block_launches"] == 0 and probe["libs"] == []


def test_no_forbidden_imports_in_port():
    bad = re.compile(r"^\s*(import jax|from jax|import triton|from triton)"
                     r"|torch\.compile", re.M)
    hits = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
            if bad.search(p.read_text())]
    assert not hits, hits
    for script in ("chip_smoke.py", "chip_profile.py"):
        text = (ROOT / script).read_text()
        assert not bad.search(text), script
        assert not re.search(r"^\s*(import|from) hnswindex_tpu", text,
                             re.M), script
