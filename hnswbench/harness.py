"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` drives the cell's kind (``kinds/<kind>.py``): ``setup``
(counted in ``setup_s``), then ``request`` in a closed loop until
``seconds`` have passed since the window opened and the kind's
``min_units`` are done (the last request may overrun; rates are over the
time to its return), then ``finish``, which
frees the program and judges its answers against the reference.  With
``trace`` the first ``TRACE_SECONDS`` of the window run under
``torch.profiler``, and the cell's per-layer metrics are read instead of
its end-to-end ones: the index's spans and host times of the set-up build
and the profile of the traced part of the window.
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

from . import datagen, host, registry, roofline, sut
from . import trace as tracing

#: seconds of the window traced in a ``trace`` run
TRACE_SECONDS = 3.0
#: top-level module names that no run may load: jax and the JAX package
#: (``hnswindex`` re-exports ``hnswindex_tpu``)
FORBIDDEN = ("jax", "jaxlib", "flax", "hnswindex_tpu", "hnswindex")


def log(msg: str) -> None:
    print(f"hnswbench: {msg}", file=sys.stderr, flush=True)


def foreign_modules() -> list:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def limits(cell: registry.Cell) -> dict:
    """Each compared number's limit: ``malformed`` 0, the others the
    cell's own (``workloads/<cell>.json``)."""
    lim = cell.settings["limits"]
    return dict(malformed=0, dist_err=float(lim["dist_err"]),
                recall_miss=float(lim["recall_miss"]))


def window(kind, st, seconds: float, tracer=None, max_requests=None):
    """The closed loop, until ``seconds`` have passed (or ``max_requests``
    are sent) and the kind's ``min_units`` are done; in a traced run the
    profiler stops after ``TRACE_SECONDS``."""
    lat, units = [], 0
    least = kind.min_units(st)
    if tracer is not None:
        tracer.start()
    start = last = time.perf_counter()
    while units < least or (last - start < seconds and (
            max_requests is None or len(lat) < max_requests)):
        t0 = time.perf_counter()
        n = kind.request(st)
        if n == 0:
            break
        last = time.perf_counter()
        lat.append(last - t0)
        units += n
        if tracer is not None and tracer.active and \
                last - start >= TRACE_SECONDS:
            tracer.stop()
    if tracer is not None and tracer.active:
        tracer.stop()
    return lat, units, last - start


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             device, system: str = "program", max_requests=None) -> dict:
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        torch.cuda.reset_peak_memory_stats(device)
    kind = registry.kind(cell)
    t0 = time.perf_counter()
    data = datagen.Clustered(cell.config, seed, device)
    st = kind.setup(sut.SYSTEMS[system], cell, data, device)
    st.sut.sync()
    setup_s = time.perf_counter() - t0
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s")

    # the index's spans over the set-up build, read outside set-up
    setup_phases = st.sut.phase_seconds() if trace else None
    tracer = tracing.Window(device) if trace else None
    before = host.Sample()
    lat, units, span = window(kind, st, seconds, tracer, max_requests)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window {span:.3f} s, {len(lat)} requests, {units} units")
    log(f"host in the window: {host.between(before, host.Sample())}")

    res = kind.finish(st)
    lim = limits(cell)
    numbers = {n: res[n] for n in lim}
    correct = all(not math.isnan(numbers[n]) and numbers[n] <= lim[n]
                  for n in lim)
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=cell.chips, memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=len(lat),
               failed=int(res["failed_requests"]))
    values = dict(setup_s=setup_s, **kind.end_to_end(st, span, lat, res))
    log("window's readings: " + ", ".join(f"{k} {v!r}"
                                           for k, v in values.items()))
    if not trace:
        out["metrics"] = {m["name"]: dict(value=values[m["name"]],
                                          unit=m["unit"])
                          for m in cell.end_to_end}
    else:
        summ = tracer.summary()
        dev.update(busy_s=summ["busy_s"], window_s=summ["window_s"])
        ctx = dict(setup=st.setup, phases=setup_phases, config=cell.config,
                   card=roofline.card() if cuda else "")
        metrics = {}
        for m in cell.per_layer:
            v = registry.metric_reader(cell, m["name"])(ctx)
            if v is None:
                continue
            extra = v if isinstance(v, dict) else dict(value=v)
            metrics[m["name"]] = dict(value=extra.pop("value"),
                                      unit=m["unit"], **extra)
        out["metrics"] = metrics
        out["breakdown"] = dict(device_ops=summ["device_ops"],
                                idle_gaps=summ["idle_gaps"])
    out["device"] = dev
    out["checks"] = {n: dict(value=numbers[n], limit=lim[n]) for n in lim}
    return out


def emit(result: dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output."""
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
