"""Column statistics subsystem: zone maps + mergeable sketches.

The port's own copy of ``ydb_tpu/stats/__init__.py`` (device-free; imports
pointed at the port, knob ``YDB_TPU_TORCH_STATS``).

The reference keeps two statistics planes — per-portion column min/max
in TPortionInfo metadata consumed by scan planning, and a
StatisticsAggregator tablet merging count-min sketches across shards
for the cost-based optimizer (ydb/core/statistics; SURVEY.md §2.7).
This package is that layer for the TPU build:

  * ``zonemap``   — per-chunk and per-portion min/max/null-count zones
                    for every scan column, plus the predicate algebra
                    that turns a program's conjunctive filters into
                    skip / read / all-match decisions per chunk;
  * ``sketch``    — mergeable count-min sketch and an HLL-style NDV
                    estimator (pure numpy, associative ``merge``);
  * ``aggregator``— the StatisticsAggregator service: folds per-portion
                    sketches into per-shard then table-level stats,
                    snapshot/restore through the tablet WAL machinery;
  * ``cost``      — selectivity + cardinality estimation consumed by
                    scan planning, SSA group-by tier choice and DQ join
                    sizing.

Gating: ``YDB_TPU_TORCH_STATS=0`` disables every stats CONSUMER (pruning,
planner hints) for A/B runs; zone maps are still written so the flag
can flip per scan. ``STATS_FORCE`` is the in-process test override.
Every pruned plan stays bit-identical to the unpruned one — pruning
only ever removes rows the program's own filters would discard.
"""

from __future__ import annotations

import os

#: test/bench override: True/False forces stats consumption regardless
#: of the environment (same contract as kernels.FUSED_FORCE).
STATS_FORCE: bool | None = None


def stats_enabled() -> bool:
    """Whether scan pruning / planner hints consume column statistics.
    Default on; ``YDB_TPU_TORCH_STATS=0`` restores the stat-less paths."""
    if STATS_FORCE is not None:
        return STATS_FORCE
    return os.environ.get("YDB_TPU_TORCH_STATS", "1") not in ("0", "", "off")


from ydb_tpu_torch.stats.sketch import (  # noqa: E402
    ColumnSketch,
    CountMinSketch,
    HyperLogLog,
)
from ydb_tpu_torch.stats.zonemap import (  # noqa: E402
    Pred,
    column_zones,
    extract_predicates,
    match_zone,
    zone_of,
)
from ydb_tpu_torch.stats.cost import ColumnStats, TableStats  # noqa: E402
from ydb_tpu_torch.stats.aggregator import StatisticsAggregator  # noqa: E402

__all__ = [
    "ColumnSketch",
    "ColumnStats",
    "CountMinSketch",
    "HyperLogLog",
    "Pred",
    "StatisticsAggregator",
    "TableStats",
    "column_zones",
    "extract_predicates",
    "match_zone",
    "stats_enabled",
    "zone_of",
    "STATS_FORCE",
]
