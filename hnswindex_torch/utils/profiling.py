"""Per-phase timing of the build, and the regions it leaves behind.

``PhaseTimer.phase(name)`` brackets a region, and records it three ways:

* stream time: on a CUDA device a pair of CUDA events on the current
  stream, so timing adds no host synchronisation (on the CPU, host wall
  time).  Once ``FOLD_AT`` closed pairs are held, those whose end event
  has completed (looked at without a synchronisation) are folded into
  their names' totals and their events are reused; ``seconds()`` waits
  for the rest.  Nested regions are each counted in full (a region's time
  includes the regions inside it).  Stream time runs from a region's
  first marker to its last on the stream, whether the device worked or
  waited for the host's next launch in between.
* host self time: the region's host interval, stamped with
  ``time.time_ns()``, less the host intervals of the regions opened inside
  it.  ``seconds()`` gives it as ``<name>.host``.  The self times of a
  region and of everything inside it add up to the region's host time.
* the last ``SPANS`` closed regions as ``(name, start_ns, end_ns,
  parent)``, ``parent`` being the innermost region open on the same timer
  (None at the top), from ``spans()``.  ``time.time_ns()`` is the clock
  ``torch.profiler`` stamps its events with, so ``idle_by_region`` can join
  a device trace with them.

``PhaseTimer.count(name, n)`` adds to a ``Tally`` of the work done inside
the regions (``n`` a host integer, or a device scalar summed on the device
without a host synchronisation); ``seconds()`` gives each tally as an
integer under its own name.

No region becomes a ``torch.profiler`` range: a range that launches
kernels also leaves a device-side event of its name in the trace, which a
reader of the device's busy time would count as device work.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict, deque

import torch

#: closed regions kept for ``spans()``
SPANS = 4096
#: closed regions' event pairs held before the completed ones are folded
FOLD_AT = 64
#: ``idle_by_region``'s name for a gap that no region covers
OUTSIDE = "outside any region"


class Tally:
    """A count that grows by host integers, or by device scalars summed on
    their device without a host synchronisation; ``int()`` reads it (and
    waits for the device where it holds device scalars)."""

    def __init__(self):
        self._host = 0
        self._dev: dict = {}         # device -> int64 scalar on it

    def add(self, n) -> None:
        if isinstance(n, torch.Tensor):
            held = self._dev.get(n.device)
            n = n.to(torch.int64)
            self._dev[n.device] = n if held is None else held + n
        else:
            self._host += int(n)

    def __int__(self) -> int:
        return self._host + sum(int(t) for t in self._dev.values())


def phase(timer, name: str):
    """``timer.phase(name)``, or no region where ``timer`` is None."""
    return timer.phase(name) if timer is not None \
        else contextlib.nullcontext()


class PhaseTimer:
    def __init__(self, device: torch.device | str):
        self.cuda = torch.device(device).type == "cuda"
        # stream seconds per name: folded event pairs, or host wall time
        self._total: dict = defaultdict(float)
        self._self_ns: dict = defaultdict(int)
        # (name, start event, end event) of closed regions, oldest first
        self._pending: deque = deque()
        self._free: list = []        # folded event pairs, to reuse
        # [name, host ns of the regions inside it] per open region
        self._open: list = []
        self._spans: deque = deque(maxlen=SPANS)
        self._counts: dict = defaultdict(Tally)

    @contextlib.contextmanager
    def phase(self, name: str):
        parent = self._open[-1][0] if self._open else None
        frame = [name, 0]
        self._open.append(frame)
        if self.cuda:
            start, end = self._free.pop() if self._free else (
                torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        t0 = time.time_ns()
        if self.cuda:
            start.record()
        try:
            yield
        finally:
            if self.cuda:
                end.record()
            t1 = time.time_ns()
            self._open.pop()
            dt = t1 - t0
            self._self_ns[name] += dt - frame[1]
            if self._open:
                self._open[-1][1] += dt
            self._spans.append((name, t0, t1, parent))
            if self.cuda:
                self._pending.append((name, start, end))
                if len(self._pending) >= FOLD_AT:
                    self._fold()
            else:
                self._total[name] += dt / 1e9

    def _fold(self, wait: bool = False) -> None:
        """Fold the oldest pairs whose end event has completed (all of
        them, waiting for each, with ``wait``)."""
        q = self._pending
        while q:
            name, s, e = q[0]
            if wait:
                e.synchronize()
            elif not e.query():
                break
            q.popleft()
            self._total[name] += s.elapsed_time(e) / 1e3
            self._free.append((s, e))

    def count(self, name: str, n) -> None:
        """Add ``n`` (an integer or a device scalar) to the tally
        ``name``."""
        self._counts[name].add(n)

    def held_events(self) -> int:
        """CUDA events the timer holds: pairs not folded yet, and folded
        ones kept for reuse."""
        return 2 * (len(self._pending) + len(self._free))

    def seconds(self) -> dict:
        """Summed stream seconds per phase name, host self seconds per name
        under ``<name>.host``, and each tally of ``count`` as an integer
        under its name."""
        self._fold(wait=True)
        out = dict(self._total)
        out.update((f"{n}.host", ns / 1e9) for n, ns in self._self_ns.items())
        out.update((n, int(t)) for n, t in self._counts.items())
        return out

    def spans(self) -> list:
        """The last ``SPANS`` closed regions, ``(name, start_ns, end_ns,
        parent)``, in the order they closed."""
        return list(self._spans)


def idle_by_region(busy, spans) -> dict:
    """Seconds of the device's idle gaps by the innermost region open at
    each gap's middle (``OUTSIDE`` where none was).

    ``busy`` are the device's merged busy intervals ``(start_ns, end_ns)``,
    sorted, from a ``torch.profiler`` trace; ``spans`` are
    ``PhaseTimer.spans()`` of the same process, on the same clock.  Only
    the gaps between busy intervals count.  Largest first."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out: dict = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        name = OUTSIDE
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[j][2] >= mid:
                name = spans[j][0]
                break
            if spans[j][3] is None:
                # regions at the top close before the next opens: none
                # earlier covers the gap
                break
        out[name] += (s1 - e0) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
