"""Embedded load-test service: config-driven synthetic load actors.

Mirror of the reference's load-test plane (ydb/core/load_test/
service_actor.cpp + per-kind actors: kqp.cpp select/upsert load,
group_write.cpp storage load, ut_ycsb.cpp YCSB-style keyed workload):
a service that runs a named load against the live cluster and returns
a latency/throughput report. Loads run inline in bounded iterations
(the test-friendly shape of the reference's actor loops); the report
carries exact nearest-rank p50/p90/p99 over the recorded latencies
(finer-grained than the counters plane's bucketed histograms, which
track the same requests via the session path).

Kinds:
  * "kv_upsert"  — YCSB-ish keyed upserts through SQL
  * "select"     — point/range selects through SQL
  * "storage_put" — raw blob-store put/get roundtrips

The port's own copy of ``ydb_tpu/obs/loadtest.py``, over the port's
``Cluster``: for a given seed it draws the same keys, values and
payload bytes as the reference (numpy ``default_rng``, in the same
order).
"""

from __future__ import annotations

import time

import numpy as np


def _report(kind: str, latencies_s: list[float],
            errors: int) -> dict:
    lat = np.asarray(sorted(latencies_s), dtype=np.float64)
    n = len(lat)

    def pct(q):
        if n == 0:
            return 0.0
        return float(lat[min(n - 1, int(q * n))]) * 1e3

    total = float(lat.sum())
    return dict(
        kind=kind, requests=n, errors=errors,
        seconds=round(total, 6),
        rps=round(n / total, 1) if total > 0 else 0.0,
        p50_ms=round(pct(0.50), 3), p90_ms=round(pct(0.90), 3),
        p99_ms=round(pct(0.99), 3),
    )


class LoadService:
    """Runs synthetic loads against a Cluster."""

    def __init__(self, cluster, seed: int = 7):
        self.cluster = cluster
        self.rng = np.random.default_rng(seed)
        self.history: list[dict] = []

    def run(self, kind: str, requests: int = 100, **params) -> dict:
        fn = {
            "kv_upsert": self._kv_upsert,
            "select": self._select,
            "storage_put": self._storage_put,
        }.get(kind)
        if fn is None:
            raise KeyError(f"unknown load kind {kind}")
        report = fn(requests, **params)
        self.history.append(report)
        return report

    def _ensure_table(self, session, table: str) -> None:
        if table not in self.cluster.tables:
            session.execute(
                f"CREATE TABLE {table} (k int64, v int64, "
                f"PRIMARY KEY (k)) WITH (store = row)")

    def _kv_upsert(self, requests: int, table: str = "load_kv",
                   key_space: int = 1000) -> dict:
        s = self.cluster.session()
        self._ensure_table(s, table)
        lats, errors = [], 0
        for _ in range(requests):
            k = int(self.rng.integers(0, key_space))
            v = int(self.rng.integers(0, 1 << 31))
            t0 = time.perf_counter()
            try:
                s.execute(f"UPSERT INTO {table} (k, v) "
                          f"VALUES ({k}, {v})")
            except Exception:  # noqa: BLE001 - load keeps going
                errors += 1
            lats.append(time.perf_counter() - t0)
        return _report("kv_upsert", lats, errors)

    def _select(self, requests: int, table: str = "load_kv",
                key_space: int = 1000) -> dict:
        s = self.cluster.session()
        self._ensure_table(s, table)
        lats, errors = [], 0
        for _ in range(requests):
            k = int(self.rng.integers(0, key_space))
            t0 = time.perf_counter()
            try:
                s.execute(f"SELECT v FROM {table} WHERE k = {k}")
            except Exception:  # noqa: BLE001
                errors += 1
            lats.append(time.perf_counter() - t0)
        return _report("select", lats, errors)

    def _storage_put(self, requests: int,
                     blob_bytes: int = 4096) -> dict:
        store = self.cluster.store
        payload = bytes(self.rng.integers(
            0, 256, blob_bytes, dtype=np.uint8))
        lats, errors = [], 0
        for i in range(requests):
            key = f"loadtest/blob/{i}"
            t0 = time.perf_counter()
            try:
                store.put(key, payload)
                if store.get(key) != payload:
                    errors += 1
                store.delete(key)
            except Exception:  # noqa: BLE001
                errors += 1
            lats.append(time.perf_counter() - t0)
        return _report("storage_put", lats, errors)
