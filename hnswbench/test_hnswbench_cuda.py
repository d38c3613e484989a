"""The tiny cells on the card: the program's runs come out correct, traced
runs see device work, and the control (real TF32 products) comes out not
correct.  Run on the card with ``python -m pytest hnswbench -q``."""

from __future__ import annotations

import pytest
import torch

from hnswbench import harness, registry
from hnswbench.conftest import TINY_CELLS

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_program_on_the_card(tiny_root, cell):
    _card()
    c = registry.load_cell(cell, tiny_root)
    res = harness.run_cell(c, 41, 1.0, False, "cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    traced = harness.run_cell(c, 42, 1.0, True, "cuda")
    assert traced["correct"], traced["checks"]
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    assert traced["breakdown"]["device_ops"]


@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_control_on_the_card(tiny_root, cell):
    _card()
    res = harness.run_cell(registry.load_cell(cell, tiny_root), 43, 1.0,
                           False, "cuda", system="control", max_requests=20)
    assert not res["correct"]
    assert res["checks"]["dist_err"]["value"] > \
        res["checks"]["dist_err"]["limit"]
