"""The port's load-test service (``ydb_tpu_torch/obs/loadtest.py``) and
metering against the reference's: the five cases of
``tests/test_loadtest_metering.py``, each through both packages.

For one seed both services send the same keys and values (numpy
``default_rng``, drawn in the same order), so the ``load_kv`` tables
after the loads are equal row for row, and the storage load puts the
same payload bytes. Reports: the same kind, requests and errors (the
latencies are each package's own, checked ordered and positive).
Metering: the same records, aggregates and request units. Tolerance:
none."""

import io
import json
import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.obs.loadtest import LoadService as RLoadService
from ydb_tpu.obs.metering import Metering as RMetering
from ydb_tpu.obs.metering import request_units as r_request_units

from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.obs.loadtest import LoadService
from ydb_tpu_torch.obs.metering import Metering, request_units


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C), as in the other port tests."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def _services(seed=7):
    ref, port = RCluster(), Cluster(device="cpu")
    return (ref, RLoadService(ref, seed=seed)), \
        (port, LoadService(port, seed=seed))


def _table(c):
    out = c.session().execute("SELECT k, v FROM load_kv ORDER BY k")
    return [np.asarray(out.cols[n][0]).tolist() for n in ("k", "v")]


def _same_report(got, want):
    for k in ("kind", "requests", "errors"):
        assert got[k] == want[k], k
    assert got["rps"] > 0
    assert got["p99_ms"] >= got["p90_ms"] >= got["p50_ms"] > 0


def test_kv_upsert_and_select_load():
    (ref, rsvc), (port, svc) = _services()
    want = rsvc.run("kv_upsert", requests=20, key_space=10)
    r = svc.run("kv_upsert", requests=20, key_space=10)
    _same_report(r, want)
    assert r["kind"] == "kv_upsert" and r["requests"] == 20
    assert r["errors"] == 0

    want2 = rsvc.run("select", requests=10, key_space=10)
    r2 = svc.run("select", requests=10, key_space=10)
    _same_report(r2, want2)
    assert r2["errors"] == 0 and r2["requests"] == 10
    assert len(svc.history) == 2

    # the load landed, the same keys and values on both sides
    assert _table(port) == _table(ref)
    keys = _table(port)[0]
    assert 1 <= len(keys) <= 10
    # the generators stand at the same place after the loads
    assert svc.rng.integers(0, 1 << 31) == rsvc.rng.integers(0, 1 << 31)


def test_storage_put_load_and_unknown_kind():
    (ref, rsvc), (port, svc) = _services(seed=3)
    puts = []
    real = port.store.put
    port.store.put = lambda b, d: (puts.append(bytes(d)), real(b, d))[1]
    want = rsvc.run("storage_put", requests=5, blob_bytes=128)
    r = svc.run("storage_put", requests=5, blob_bytes=128)
    _same_report(r, want)
    assert r["errors"] == 0 and r["requests"] == 5
    payload = bytes(np.random.default_rng(3).integers(
        0, 256, 128, dtype=np.uint8))
    assert puts == [payload] * 5
    assert not port.store.list("loadtest/")  # each blob deleted after
    for s in (rsvc, svc):
        with pytest.raises(KeyError):
            s.run("nope")


def test_request_units_schedule():
    for kind, rows in (("select", 0), ("select", 128), ("select", 129),
                       ("upsert", 10_000), ("insert", 1 << 20)):
        assert request_units(kind, rows) == r_request_units(kind, rows)
    assert request_units("select", 129) == 2


def test_metering_records_and_aggregates():
    outs = []
    for make in (RMetering, Metering):
        sink = io.StringIO()
        clock = [1000.0]
        m = make(tenant="/Root/a", sink=sink, now=lambda: clock[0])
        m.record("kqp.select", 2)
        clock[0] += 10
        m.record("kqp.upsert", 1)
        clock[0] += 3600
        m.record("kqp.select", 3)
        outs.append((m.aggregate(interval_s=3600),
                     [json.loads(x) for x in sink.getvalue().splitlines()],
                     m.total_units(), m.total_units("kqp.select")))
    assert outs[1] == outs[0]
    agg, lines, total, selects = outs[1]
    assert agg[0] == {"tenant": "/Root/a", "resource": "kqp.select",
                      "interval_start": 0.0, "units": 2}
    assert len(lines) == 3 and total == 6 and selects == 5


def test_session_books_request_units():
    got = []
    for c in (RCluster(), Cluster(device="cpu")):
        s = c.session()
        s.execute("CREATE TABLE t (id int64, PRIMARY KEY (id))")
        s.execute("INSERT INTO t VALUES (1), (2)")
        s.execute("SELECT id FROM t")
        got.append(([(r["resource"], r["units"])
                     for r in c.metering.records],
                    c.metering.total_units()))
    assert got[1] == got[0]
    assert {"kqp.createtable", "kqp.insert", "kqp.select"} <= {
        r for r, _ in got[1][0]}
