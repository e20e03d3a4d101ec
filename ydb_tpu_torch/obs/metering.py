"""Usage metering: request-unit records + periodic aggregation.

Mirror of the reference's metering plane (ydb/core/metering/
metering.h:57 — billing records emitted per consumed resource as JSON
lines, aggregated per interval per cloud/folder/resource): each served
request books request units (reads by rows returned, writes/DDL a
flat unit), records append to a bounded in-memory log with optional
JSONL sink, and ``aggregate`` folds them into per-(tenant, resource,
interval) totals — the shape a billing pipeline consumes.

The port's own copy of ``ydb_tpu/obs/metering.py``.
"""

from __future__ import annotations

import json
import time
from collections import deque


# request-unit schedule (the RU model): reads bill per 128 rows
# returned (min 1), mutations and DDL a flat unit
READ_ROWS_PER_UNIT = 128


def request_units(kind: str, rows: int) -> int:
    if kind in ("select", "explain"):
        return max(1, (rows + READ_ROWS_PER_UNIT - 1)
                   // READ_ROWS_PER_UNIT)
    return 1


class Metering:
    """Bounded usage-record log with JSONL sink + aggregation."""

    def __init__(self, tenant: str = "/Root", sink=None,
                 max_records: int = 4096, now=time.time):
        self.tenant = tenant
        self.sink = sink      # file-like; one JSON per line when set
        self.now = now
        self.records: deque = deque(maxlen=max_records)

    def record(self, resource: str, units: int,
               tenant: str | None = None) -> dict:
        rec = {
            "tenant": tenant or self.tenant,
            "resource": resource,
            "units": int(units),
            "ts": self.now(),
        }
        self.records.append(rec)
        if self.sink is not None:
            self.sink.write(json.dumps(rec) + "\n")
        return rec

    def aggregate(self, interval_s: float = 3600.0) -> list[dict]:
        """Fold records into per-(tenant, resource, interval) sums,
        sorted by interval start."""
        out: dict[tuple, int] = {}
        for r in self.records:
            start = int(r["ts"] // interval_s) * interval_s
            key = (r["tenant"], r["resource"], start)
            out[key] = out.get(key, 0) + r["units"]
        return [
            {"tenant": t, "resource": res, "interval_start": start,
             "units": units}
            for (t, res, start), units in sorted(out.items(),
                                                 key=lambda kv: kv[0][2])
        ]

    def total_units(self, resource: str | None = None) -> int:
        return sum(r["units"] for r in self.records
                   if resource is None or r["resource"] == resource)
