"""Peaks of one NVIDIA H100 and the least time a piece of work can take.

``bound`` and the peaks are a frozen copy of ``chip_smoke.py``'s (NVIDIA's
data sheet for the SXM part, dense rates, at the full 700 W): later changes
to the program cannot move the yardstick.  ``build_scan_work`` counts the
work of the build's candidate scan from the shapes alone, so that the
scan's roofline share reads the same whatever implements the scan.
"""

from __future__ import annotations

import subprocess

PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def bound(flops: float, peak: float, nbytes: float) -> dict:
    """Least time the card could take: the larger of operations over the
    peak rate and bytes over the memory rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def build_scan_work(rows: int, dim: int, wave: int) -> tuple:
    """Operations and bytes of the exact candidate scan of a build of
    ``rows`` rows from empty.

    Each row needs an exact distance to every row inserted before it, at
    ``2 * dim`` operations a distance (a multiply and an add a value); the
    scan reads the bfloat16 copy of the rows already in the index once per
    wave of ``wave`` rows, and each row once in float32::

        flops = rows * (rows - 1) * dim
        bytes = sum over waves j < ceil(rows / wave) of j * wave * dim * 2
                + rows * dim * 4

    The count is the algorithm's, whatever implements the scan.  It also
    counts the pairs inside a wave, which the scan does not compute (about
    ``wave / rows`` of the total, 0.05% at 1M rows); the bytes take every
    wave as full, though the first are narrower."""
    waves = -(-rows // wave)
    flops = float(rows) * (rows - 1) * dim
    nbytes = float(wave) * dim * 2 * waves * (waves - 1) / 2 \
        + float(rows) * dim * 4
    return flops, nbytes


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them, or ""
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else ""
