"""What the device did in a traced window, from ``torch.profiler``.

``busy_s`` is the union of the intervals of the events that ran on the
device (kernels, copies, fills; overlapping or nested events count once),
the arithmetic of ``hnswindex_torch.utils.profiling.trace`` copied here so
that the program cannot change it.  ``window_s`` is the host's wall time
of the window, the device synchronised at both ends.  ``device_ops`` are
the device operations that took most time, and ``idle_gaps`` the device's
idle time grouped by what the host was doing in each gap: the innermost
host operation running at the gap's middle, or, where none was, the host
operation that ended the gap.  On the CPU (tests) the host's operators
stand for the device's.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

#: gaps shorter than this are counted together, unlabelled
SHORT_GAP_NS = 20_000
#: host events looked at, back from a gap's middle, to find the one that
#: covers it
_LOOK_BACK = 32
TOP = 10


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """One traced window: ``start()``, the work, ``stop()``, then
    ``summary()``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.active = False
        self.window_s = 0.0
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        _sync(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.active = False

    def summary(self) -> dict:
        dev, host = _events(self._prof, self.device.type == "cuda")
        return summarize(dev, host, self.window_s)


def _events(prof, cuda: bool):
    """(device events, host events), each a list of (start_ns, end_ns,
    name)."""
    want = torch.autograd.DeviceType.CUDA if cuda \
        else torch.autograd.DeviceType.CPU
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        if hasattr(ev, "start_ns"):
            s, d = ev.start_ns(), ev.duration_ns()
        else:
            s, d = ev.start_us() * 1000, ev.duration_us() * 1000
        item = (s, s + d, ev.name())
        if ev.device_type() == want:
            dev.append(item)
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            host.append(item)
    return dev, host


def union(spans) -> tuple:
    """(merged intervals, their total length) of (start, end, ...) spans."""
    merged = []
    busy, hi = 0, None
    for s, e, *_ in sorted(spans):
        if hi is None or s > hi:
            merged.append([s, e])
            busy += e - s
            hi = e
        elif e > hi:
            busy += e - hi
            merged[-1][1] = e
            hi = e
    return merged, busy


def _label(starts, ends, name_at, gs: int, ge: int) -> str:
    mid = (gs + ge) // 2
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(-1, i - _LOOK_BACK), -1):
        if ends[j] >= mid:
            return name_at[j]
    k = bisect.bisect_right(starts, ge) - 1
    return f"host, then {name_at[k]}" if k >= 0 else "host"


def summarize(dev, host, window_s: float) -> dict:
    merged, busy_ns = union(dev)
    by_op: dict = defaultdict(float)
    for s, e, name in dev:
        by_op[name] += (e - s) / 1e9
    # the runtime's own calls (cudaLaunchKernel, ...) say less than the
    # operator that made them
    host = sorted(h for h in host if not h[2].startswith("cu"))
    starts = [h[0] for h in host]
    ends = [h[1] for h in host]
    names = [h[2] for h in host]
    gaps: dict = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        if s1 - e0 < SHORT_GAP_NS:
            gaps["gaps under 20 us"] += (s1 - e0) / 1e9
        else:
            gaps[_label(starts, ends, names, e0, s1)] += \
                (s1 - e0) / 1e9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy_ns / 1e9, window_s=window_s,
                device_ops=[[n[:160], s] for n, s in top],
                idle_gaps=[[n[:160], s] for n, s in idle])
