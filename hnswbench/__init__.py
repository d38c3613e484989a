r"""The benchmark of ``hnswindex_torch``: ingest and k-NN serving on one card.

One run measures one cell of ``BENCHMARK.json`` (a deployment from
``configs/`` under a traffic mix from ``traffic/``) and prints one JSON
line::

    python3 hnswbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json`` (read by the kind of
loop it names, ``kinds/<kind>.py``), ``workloads/<cell>.json`` and
``metrics/<metric>.py``.  The yardstick lives here too: the seeded data
(``datagen.py``), the plain exact search (``reference.py``), the checks
that decide ``correct`` (``checks.py``), the peaks and work counts
(``roofline.py``) and the profiler arithmetic (``trace.py``).  Nothing here
imports jax or the JAX package.
"""
