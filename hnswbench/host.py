"""What the host gave a run's window: the CPUs the process may use, the
clock they report, the share of all CPUs' time that the hypervisor took
(steal), and the process's own CPU time and involuntary switches.  Read
from ``/proc`` and ``getrusage``; where ``/proc`` is missing those
readings are left out.  Printed on standard error beside the window's
readings, so that a run's speed can be set beside what its host did."""

from __future__ import annotations

import os
import resource
import time

#: columns of /proc/stat's ``cpu`` line: user nice system idle iowait irq
#: softirq steal
_STEAL = 7


def _cpu_ticks():
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:_STEAL + 2]]
    except (OSError, ValueError):
        return None


def _mean_mhz():
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(ln.split(":")[1]) for ln in f
                   if ln.startswith("cpu MHz")]
    except (OSError, ValueError):
        return None
    return sum(mhz) / len(mhz) if mhz else None


class Sample:
    """The host's counters at one moment."""

    def __init__(self):
        self.t = time.perf_counter()
        self.ticks = _cpu_ticks()
        self.usage = resource.getrusage(resource.RUSAGE_SELF)


def between(a: Sample, b: Sample) -> dict:
    """What the host gave the process from ``a`` to ``b``."""
    wall = max(b.t - a.t, 1e-9)
    cpu = (b.usage.ru_utime + b.usage.ru_stime
           - a.usage.ru_utime - a.usage.ru_stime)
    out = dict(cpus=sorted(os.sched_getaffinity(0)),
               process_cpu_per_wall=cpu / wall,
               involuntary_switches=b.usage.ru_nivcsw - a.usage.ru_nivcsw)
    if a.ticks and b.ticks:
        d = [y - x for x, y in zip(a.ticks, b.ticks)]
        out["steal_share"] = d[_STEAL] / max(sum(d), 1)
    mhz = _mean_mhz()
    if mhz is not None:
        out["mean_mhz"] = mhz
    return out
