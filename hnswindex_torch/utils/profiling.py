"""Per-phase timing of the build.

``PhaseTimer.phase(name)`` brackets a region.  On a CUDA device it records
a pair of CUDA events on the current stream, so timing adds no host
synchronisation; ``seconds()`` synchronises once and sums the event pairs.
On the CPU it sums host wall time.  Nested regions are each counted in full
(a region's time includes the regions inside it).

``trace(fn, device)`` runs ``fn`` once under ``torch.profiler`` and reports
how busy the device was: the union of the intervals of the events that ran
on it, over the host wall time of the call.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict

import torch


class PhaseTimer:
    def __init__(self, device: torch.device | str):
        self.cuda = torch.device(device).type == "cuda"
        self._events: dict = defaultdict(list)
        self._host: dict = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._events[name].append((start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._host[name] += time.perf_counter() - t0

    def seconds(self) -> dict:
        """Summed seconds per phase name."""
        out = dict(self._host)
        if self._events:
            torch.cuda.synchronize()
            for name, pairs in self._events.items():
                out[name] = out.get(name, 0.0) + sum(
                    s.elapsed_time(e) for s, e in pairs) / 1e3
        return out


def trace(fn, device: torch.device | str) -> dict:
    """Run ``fn()`` once under ``torch.profiler``.

    Returns ``wall_s`` (host seconds, device synchronised at both ends),
    ``busy_s`` (union of the intervals of the events that ran on
    ``device``: kernels, copies and fills on a card, operators on the CPU,
    so overlapping or nested events count once), ``busy_share`` =
    busy_s / wall_s, and ``rows``: (name, seconds, count) per event name on
    ``device``, largest first."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    want = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    if cuda:
        torch.cuda.synchronize(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    spans = []
    by_name: dict = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type != want:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        by_name[ev.name][0] += (e - s) / 1e6
        by_name[ev.name][1] += 1
    busy, hi = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > hi:
            busy += e - max(s, hi)
            hi = e
    busy /= 1e6
    rows = sorted(((k, v[0], v[1]) for k, v in by_name.items()),
                  key=lambda r: -r[1])
    return dict(wall_s=wall, busy_s=busy, busy_share=busy / wall,
                rows=rows)
