"""Index configuration.

A field-for-field copy of ``hnswindex_tpu/params.py``: importing that
module runs ``hnswindex_tpu/__init__``, which imports jax, and this
package never imports jax.  Some docstrings below describe TPU-side
measurements; they are the reference package's history, kept verbatim so
the two copies stay easy to diff.

Analog of the reference's ``HNSWParameters<TDistance>``
(src/HNSWIndex/HNSWParameters.cs:7-56).  Field names mirror the reference's
parameters one to one (snake_cased); defaults are identical.

Two extra knobs exist only because the TPU build is wave-batched and
fixed-shape where the reference is pointer-chasing:

* ``max_wave_size`` — upper bound on how many inserts are batched into one
  device "wave" (the TPU replacement for the reference's ``Parallel.For``
  over individual ``Add`` calls, src/HNSWIndex/HNSWIndex.cs:70-78).
* ``search_iter_factor`` — hard bound multiplier on beam-search iterations
  (the reference's while-loops at GraphNavigator.cs:143,214 are unbounded;
  XLA needs a bound for ``lax.while_loop`` cost modelling; the loop still
  terminates early exactly like the reference).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class HNSWParameters:
    """Mirror of HNSWParameters.cs:7-56 (defaults identical)."""

    #: Max outgoing edges per node per layer (``M``).  Layer 0 allows 2*M.
    #: (HNSWParameters.cs:13; layer-0 doubling at GraphData.cs:247-250.)
    max_edges: int = 16

    #: Rate for the exponential level distribution (``mL``);
    #: level = floor(-ln(U) * distribution_rate).  (HNSWParameters.cs:19,
    #: GraphData.cs:211-219.)
    distribution_rate: float = 1.0 / math.log(16)

    #: Floor on the internal search width (``efSearch`` = max(min_nn, k)).
    #: (HNSWParameters.cs:25, HNSWIndex.cs:115.)
    min_nn: int = 5

    #: Beam width during construction (``efConstruction``).
    #: (HNSWParameters.cs:31.)
    max_candidates: int = 100

    #: Beam width for the repair search during removals.
    #: (HNSWParameters.cs:37.)
    remove_max_candidates: int = 100

    #: Expected number of elements; initial capacity.  The index grows by
    #: doubling, like the reference (GraphData.cs:98-111).
    collection_size: int = 65536

    #: RNG seed for level sampling; negative means unseeded.
    #: (HNSWParameters.cs:49, GraphData.cs:42.)
    random_seed: int = 31337

    #: Whether removals are permitted (HNSWParameters.cs:55).  Unlike the
    #: reference, the TPU build keeps no in-edge tables (in-neighbors are
    #: recovered by a vectorized scan of the out-edge table), so disabling
    #: removals changes no data layout — only the API contract
    #: (HNSWIndex.cs:85-86 throws when disabled; we match).
    allow_removals: bool = True

    # ---- TPU-build-only knobs -------------------------------------------
    #: Max number of inserts batched into a single device wave.
    max_wave_size: int = 512

    #: Beam-search iteration bound = search_iter_factor * ef + 16.
    search_iter_factor: int = 8

    #: Beam nodes expanded per search step at query time (1 = exact
    #: reference frontier semantics; >1 trades a little extra distance work
    #: for far fewer sequential device steps).
    query_expand: int = 4

    #: Beam nodes expanded per search step during construction waves.
    build_expand: int = 8

    #: Corpus-size ceiling for exact (MXU brute-force) candidate
    #: generation during construction.  Below this, every wave's layer-0
    #: candidates come from one blocked matmul over the corpus — faster
    #: than graph beams on matmul hardware and exactly the true
    #: efConstruction nearest neighbors (measured: ~300k inserts/s at 1M,
    #: ~37k/s at 8M on v5e; cost is O(count) per wave).  The default
    #: covers everything a single chip's HBM can store at 128-d — the
    #: designed scale-out past HBM is the sharded index, whose per-shard
    #: waves use this same exact path at shard-local cost.  Above the
    #: threshold, wave beam search takes over (O(log N) per insert).
    exact_build_threshold: int = 1 << 24

    #: Packed-neighborhood serving for layer-0 graph queries
    #: (core/pack.py): "auto" builds the pack lazily once the corpus is
    #: large enough for the build to amortize; "on" forces it; "off"
    #: disables it.  The pack trades HBM (K neighbor vectors per node) for
    #: expansion fetches that ride at HBM bandwidth instead of the
    #: row-gather issue ceiling.
    pack_queries: str = "auto"

    #: HBM budget for the query pack; when the pack cannot fit (at its
    #: configured pack_dtype), packed serving is skipped.
    pack_max_bytes: int = 9 << 30

    #: Residual-tile dtype for the query pack: "bf16" (default — residual
    #: bf16 error is ~0.4% of the neighbor's distance TO ITS PARENT, a
    #: second-order ranking perturbation, and tiles are half the HBM
    #: traffic of f32), "f32" (exact tiles, 2x fetch bytes), or "auto"
    #: (widest of float32/bfloat16 whose pack fits pack_max_bytes).
    pack_dtype: str = "bf16"

    #: Corpus size at which "auto" packed serving switches on.
    pack_min_count: int = 32768

    #: Ranking-table dtype for graph traversal: "float32" (default; exact
    #: at search precision) or "bfloat16" (halves traversal gather bytes,
    #: but its ~0.4% dot noise caps recall on corpora with tight clusters
    #: — opt in only when distance margins are wide).  Returned distances
    #: are always refined in full precision either way.  "f32"/"bf16"
    #: aliases (the adjacent pack_dtype vocabulary) are accepted; any
    #: other string is rejected by validate().
    rank_dtype: str = "auto"

    #: Extra layer-0 row columns beyond the 2M degree cap (GraphConfig
    #: slack0).  Full rows absorb up to this many reverse arrivals into
    #: the spare columns before the overflow re-prune fires, amortizing
    #: the single largest steady-state wave cost ~(slack0+1)x per row.
    #: Node degrees may transiently reach 2M+slack0 (the reference caps
    #: at exactly 2M and re-prunes on every overflow; snapshot exports in
    #: reference formats re-prune over-cap rows first).  Searches read a
    #: few extra row lanes, which is ~free: TPU row gathers are
    #: row-count-bound, not byte-bound.  0 restores the reference
    #: trigger exactly.  The effective slack is clamped to max_edges//2
    #: so degenerate-M configs keep the reference's parameter bands
    #: (e.g. M=1's deliberately-poor recall, parameters_test.py:24-33).
    reverse_slack: int = 8

    #: Repair width for removals: "fast" repairs affected rows against
    #: the spans in core/remove.py's REPAIR_* constants; "high" doubles
    #: the candidate spans and widens the multi-loss fan-in union.
    #: Measured at 100k x 50% uniform bulk deletes
    #: (benchmarks/remove_quality_sweep.py): "fast" holds post/pre
    #: recall ratio ~0.96 at full speed, "high" ~0.995 — above the
    #: reference's own 0.98x drift bar (GraphTests.cs:138-148) — at
    #: ~0.57x the removals/s.  Incremental (small-wave) removals are
    #: near-driftless under either setting.  "auto" (default) escalates
    #: to "high" when one remove() call covers >= 10% of the live corpus
    #: and stays on "fast" for incremental churn, so the reference's
    #: drift bar holds with out-of-the-box parameters
    #: (core/remove.resolve_quality).
    remove_quality: str = "auto"

    #: At-scale serving fallback: when the packed graph engine cannot fit
    #: the device's HBM budget (pack_max_bytes) — the 8M-rows-on-one-chip
    #: regime — "auto" routes plain layer-0 unfiltered knn_query calls
    #: through device-built block tables (block.DeviceBlockTables: routed
    #: MXU block scoring, no host mirrors) instead of the unpacked beam,
    #: which at that scale is gather-bound to ~150 q/s.  Filtered /
    #: layered / custom-metric / exact queries are unaffected.  "off"
    #: restores the always-graph behavior.
    block_fallback: str = "auto"

    def validate(self) -> None:
        if self.max_edges < 1:
            raise ValueError("max_edges must be >= 1")
        if self.max_candidates < 1:
            raise ValueError("max_candidates must be >= 1")
        if self.min_nn < 1:
            raise ValueError("min_nn must be >= 1")
        if self.collection_size < 1:
            raise ValueError("collection_size must be >= 1")
        if self.distribution_rate < 0:
            raise ValueError("distribution_rate must be >= 0")
        if self.max_wave_size < 1:
            raise ValueError("max_wave_size must be >= 1")
        if self.pack_dtype not in ("bf16", "f32", "auto"):
            raise ValueError("pack_dtype must be 'bf16', 'f32' or 'auto'")
        if self.pack_queries not in ("auto", "on", "off"):
            raise ValueError("pack_queries must be 'auto', 'on' or 'off'")
        if self.rank_dtype not in ("auto", "float32", "bfloat16",
                                   "f32", "bf16"):
            raise ValueError(
                "rank_dtype must be 'auto', 'float32'/'f32' or "
                "'bfloat16'/'bf16'")
        if self.reverse_slack < 0:
            raise ValueError("reverse_slack must be >= 0")
        if self.remove_quality not in ("auto", "fast", "high"):
            raise ValueError(
                "remove_quality must be 'auto', 'fast' or 'high'")
        if self.block_fallback not in ("auto", "off"):
            raise ValueError("block_fallback must be 'auto' or 'off'")
