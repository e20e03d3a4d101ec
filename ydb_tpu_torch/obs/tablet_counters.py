"""Tablet counters collection + cluster-wide aggregation.

Mirror of the reference's per-tablet counters plane
(ydb/core/tablet/tablet_counters.cpp + the counters aggregator
tablet_counters_aggregator.cpp merging per-tablet counters by tablet
type for monitoring; SURVEY.md §2.4 row "tablet plumbing"): every
TabletExecutor keeps simple commit/redo/checkpoint counters; this
module walks a Cluster's live tablets, tags each with its type
(derived from the tablet-id prefix: ds/, pq/, kesus/, console, ...)
and folds them into per-type aggregates for the viewer and sys views.

The port's own copy of ``ydb_tpu/obs/tablet_counters.py``, over the
port's ``Cluster`` (``kqp/session.py``): column shards, row shards
(``ds/``; a secondary index's shards are not walked, as in the
reference), topic partitions (``pq/``), the scheme tablet and the
coordinator.
"""

from __future__ import annotations


def _walk_executors(cluster):
    """Yield (tablet_id, executor) for every live tablet."""
    scheme = getattr(cluster, "scheme", None)
    if scheme is not None and hasattr(scheme, "executor"):
        yield scheme.executor.tablet_id, scheme.executor
    for t in getattr(cluster, "tables", {}).values():
        for shard in t.shards:
            ex = getattr(shard, "executor", None)
            if ex is not None:
                yield ex.tablet_id, ex
    for topic in getattr(cluster, "topics", {}).values():
        for part in topic.partitions:
            yield part.executor.tablet_id, part.executor
    coord = getattr(cluster, "coordinator", None)
    ex = getattr(coord, "executor", None)
    if ex is not None:
        yield ex.tablet_id, ex


def tablet_type(tablet_id: str) -> str:
    """First path segment of the tablet id is its type."""
    return tablet_id.split("/", 1)[0] if "/" in tablet_id else tablet_id


def collect(cluster) -> list[dict]:
    """Per-tablet counter rows."""
    out = []
    for tablet_id, ex in _walk_executors(cluster):
        out.append(dict(ex.counters, tablet_id=tablet_id,
                        type=tablet_type(tablet_id),
                        generation=ex.generation,
                        version=ex.version))
    return out


def aggregate(cluster, rows: list[dict] | None = None) -> dict[str, dict]:
    """Per-tablet-type sums (the counters-aggregator merge). Pass
    already-collected ``rows`` to aggregate a consistent snapshot."""
    agg: dict[str, dict] = {}
    for row in (rows if rows is not None else collect(cluster)):
        t = agg.setdefault(row["type"], {
            "tablets": 0, "tx_executed": 0, "tx_committed": 0,
            "redo_bytes": 0, "checkpoints": 0,
        })
        t["tablets"] += 1
        for k in ("tx_executed", "tx_committed", "redo_bytes",
                  "checkpoints"):
            t[k] += row[k]
    return agg
