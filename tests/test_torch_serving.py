"""The port's multi-tenant front door (``ydb_tpu_torch/serving``) against
the reference's: a mirror of ``tests/test_serving.py:62-278`` on a port
``Cluster(device="cpu")``: tenant resolution and weighted shares (equal
to the reference's), ``is_read_statement`` (equal to the reference's),
per-pool admission seats with typed shedding that names the pool,
earliest-deadline-first queues, the tenant on the profile and its
latency gauges, the ``tenant`` startup parameter over pgwire, and
cross-connection batching over pgwire.

Tolerance: none (admission counts, shares and results exact).

Deferred, each with its ROADMAP.md queue A item: the gRPC front
(``api/server.py``), the leak-sanitizer drain of serving handles, the
noisy-neighbor chaos scenario (chaos) and the tenant columns of the
sys views (sys views)."""

import threading
import time

import pytest

from ydb_tpu import serving as rserving

from ydb_tpu_torch import serving
from ydb_tpu_torch.api.pgwire import PgWireServer
from ydb_tpu_torch.kqp.rm import OverloadedError
from ydb_tpu_torch.kqp.session import Cluster

from test_pgwire import MiniPgClient
from test_sql import Q1_SQL, Q6_SQL
from test_torch_batching import _armed, _lineitem_cluster


@pytest.fixture(scope="module")
def front():
    """One lineitem cluster behind a front door with every tenant the
    module's tests use, plus a live pgwire listener."""
    c = _lineitem_cluster()
    c.max_inflight_statements = max(c.max_inflight_statements, 1024)
    reg = serving.TenantRegistry()
    reg.register("gold", weight=3.0, max_inflight=32)
    reg.register("bronze", weight=1.0, max_inflight=16)
    reg.register("small", weight=0.5, max_inflight=1, queue_size=0)
    reg.bind_principal("gold-token", "gold")
    serving.install(c, reg)
    s = c.session()
    for sql in (Q1_SQL, Q6_SQL):  # warm plan + compile caches
        s.execute(sql)
    srv = PgWireServer(c).start()
    yield c, srv
    srv.stop()
    c.stop()


# ---------------- registry + statement classification ----------------

def test_registry_resolution_order():
    reg = serving.TenantRegistry()
    reg.register("gold", weight=3.0)
    reg.bind_principal("alice", "gold")
    assert reg.resolve(tenant="gold", principal="bob") == "gold"
    assert reg.resolve(principal="alice") == "gold"
    assert reg.resolve(tenant="typo") == serving.DEFAULT_TENANT
    assert reg.resolve() == serving.DEFAULT_TENANT
    assert reg.get("typo").name == serving.DEFAULT_TENANT


@pytest.mark.parametrize("weights,total", [
    ({"big": 30.0, "tiny": 0.01}, 16),
    ({"gold": 3.0, "bronze": 1.0}, 16),
    ({"a": 1.0, "b": 1.0, "c": 1.0}, 4),
    ({"gold": 3.0, "bronze": 1.0}, 1 << 32),
])
def test_weighted_shares_match_reference(weights, total):
    regs = []
    for mod in (serving, rserving):
        reg = mod.TenantRegistry()
        for name, w in weights.items():
            reg.register(name, weight=w)
        regs.append(reg.shares(total))
    assert regs[0] == regs[1]
    if "tiny" in weights:
        assert regs[0]["big"] > regs[0]["tiny"] == 1
        assert regs[0][serving.DEFAULT_TENANT] >= 1


@pytest.mark.parametrize("sql", [
    "SELECT 1 FROM t", "  explain select k from t",
    "-- note\nSELECT k FROM t", "/* hint */ SELECT k FROM t",
    "INSERT INTO t VALUES (1)", "CREATE TABLE t (k int64)", "BEGIN",
    "-- dangling comment", "/* open", "values (1)", "show tables",
    "UPSERT INTO t VALUES (1)",
])
def test_is_read_statement_matches_reference(sql):
    assert serving.is_read_statement(sql) == rserving.is_read_statement(sql)


# ---------------- the admission plane itself ----------------

def test_front_door_shed_names_pool():
    c = Cluster(device="cpu")
    try:
        reg = serving.TenantRegistry()
        reg.register("small", max_inflight=1, queue_size=0)
        fd = serving.install(c, reg)
        seat = fd.admit("small")
        with pytest.raises(OverloadedError, match="small"):
            fd.admit("small")
        snap = fd.snapshot()["small"]
        assert snap["inflight"] == 1 and snap["shed"] == 1
        fd.admit("other").release()
        seat.release()
        fd.admit("small").release()
        snap = fd.snapshot()["small"]
        assert snap["inflight"] == 0 and snap["admitted"] == 2
        keys = [k for k in c.counters.snapshot()
                if "component=serving" in k and "tenant=small" in k]
        assert any(k.startswith("admitted") for k in keys)
        assert any(k.startswith("shed") for k in keys)
    finally:
        c.stop()


def test_edf_orders_queued_admissions():
    c = Cluster(device="cpu")
    try:
        reg = serving.TenantRegistry()
        reg.register("edf", max_inflight=1, queue_size=8)
        fd = serving.install(c, reg)
        seat = fd.admit("edf")
        order = []
        rec = threading.Lock()
        now = time.monotonic()

        def waiter(tag, dl):
            s = fd.admit("edf", deadline_at=dl, timeout=10.0)
            with rec:
                order.append(tag)
            s.release()

        far = threading.Thread(target=waiter, args=("far", now + 60))
        far.start()
        while fd.snapshot()["edf"]["queued"] < 1:
            time.sleep(0.001)
        near = threading.Thread(target=waiter, args=("near", now + 30))
        near.start()
        while fd.snapshot()["edf"]["queued"] < 2:
            time.sleep(0.001)
        seat.release()
        far.join(10.0)
        near.join(10.0)
        assert order == ["near", "far"]
        seat = fd.admit("edf")
        with pytest.raises(OverloadedError):
            fd.admit("edf", deadline_at=time.monotonic() - 1.0)
        seat.release()
    finally:
        c.stop()


def test_session_overload_is_typed_and_named(front):
    c, _ = front
    fd = c.front_door
    blocker = fd.admit("small")
    try:
        s = c.session()
        s.tenant = "small"
        with pytest.raises(OverloadedError, match="small"):
            s.execute(Q6_SQL)
        assert getattr(s.last_profile, "error_reason", None) \
            == "overloaded"
    finally:
        blocker.release()
    s2 = c.session()
    s2.tenant = "small"
    assert s2.execute(Q6_SQL).num_rows > 0
    assert fd.snapshot()["small"]["inflight"] == 0


# ---------------- observability surface ----------------

def test_tenant_rides_profile_and_gauges(front):
    c, _ = front
    s = c.session()
    s.tenant = "gold"
    assert s.execute(Q1_SQL).num_rows > 0
    assert s.last_profile.tenant == "gold"
    snap = c.front_door.snapshot()
    assert {"default", "gold", "bronze", "small"} <= set(snap)
    c.run_background()
    prom = c.counters.encode_prometheus()
    assert 'tenant="gold"' in prom
    assert "query_latency_p99" in prom


# ---------------- protocol fronts ----------------

def test_pgwire_tenant_startup_param(front):
    c, srv = front
    fd = c.front_door
    base = fd.snapshot()["bronze"]["admitted"]
    cl = MiniPgClient(srv.port, startup={"tenant": "bronze"})
    rows, _, tags, errors = cl.query(Q6_SQL)
    cl.close()
    assert not errors and rows
    assert fd.snapshot()["bronze"]["admitted"] > base


def test_pgwire_unknown_tenant_lands_in_default(front):
    c, srv = front
    base = c.front_door.snapshot()["default"]["admitted"]
    cl = MiniPgClient(srv.port, startup={"tenant": "no-such-pool"})
    _, _, _, errors = cl.query(Q6_SQL)
    cl.close()
    assert not errors
    assert c.front_door.snapshot()["default"]["admitted"] > base


def test_pgwire_over_cap_tenant_is_shed_with_pool_named(front):
    c, srv = front
    blocker = c.front_door.admit("small")
    try:
        cl = MiniPgClient(srv.port, startup={"tenant": "small"})
        _, _, _, errors = cl.query(Q6_SQL)
        cl.close()
    finally:
        blocker.release()
    assert errors and "small" in errors[0]


def test_cross_connection_pgwire_batching(front):
    """The same warm SELECT from two different connections joins ONE
    batch group: pgwire reads run outside the server's lock."""
    c, srv = front
    bt0 = c.batcher.snapshot()
    clients = [MiniPgClient(srv.port) for _ in range(2)]
    results = [None, None]
    errors = [None, None]
    barrier = threading.Barrier(2)

    def work(i):
        try:
            barrier.wait()
            results[i] = clients[i].query(Q1_SQL)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors[i] = e

    with _armed(c, window_ms=500, max_batch=2):
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    for cl in clients:
        cl.close()
    assert errors == [None, None]
    rows0, _, _, errs0 = results[0]
    rows1, _, _, errs1 = results[1]
    assert not errs0 and not errs1
    assert rows0 and rows0 == rows1
    snap = c.batcher.snapshot()
    assert snap["batches"] >= bt0["batches"] + 1
    assert snap["batched_statements"] >= bt0["batched_statements"] + 2
    assert snap["max_batch_size"] >= 2
