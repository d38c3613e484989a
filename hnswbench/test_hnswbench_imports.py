"""No run loads jax or the JAX package, and the reference loads nothing of
the program.  Each check is a fresh process, so that nothing imported by
the test session counts."""

from __future__ import annotations

import json
import subprocess
import sys

from hnswbench.conftest import ROOT
from hnswbench.harness import FORBIDDEN

_RUN = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from hnswbench import harness, registry, run
from hnswbench.conftest import make_tiny_root
root = make_tiny_root(Path(tempfile.mkdtemp()))
device = "cuda" if torch.cuda.is_available() else "cpu"
for cell in ("tiny-l2.batch", "tiny-cos.online"):
    for trace in (False, True):
        harness.run_cell(registry.load_cell(cell, root), 5, 0.5, trace,
                         device)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import hnswbench.reference, hnswbench.checks, hnswbench.datagen
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(_RUN)
    assert "hnswindex_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _top_level(_REFERENCE)
    assert "hnswindex_torch" not in names
    assert not names & set(FORBIDDEN)
