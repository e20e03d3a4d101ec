"""The port's DQ data plane on the wire against the JAX package, on the CPU.

The three cases of ``tests/test_dq_wire.py``, with the port's processes:
a TPC-H join planned from SQL with its scan stages in this process and
its join and final stages in a worker process; three nodes with a
worker-to-worker shuffle; and a worker killed mid-query. Each worker is
``python -m ydb_tpu_torch.dq.node_service --device cpu``. Answers are
held against the reference's in-process ``execute_plan`` on the same
numpy data: ints exact, floats within rtol 1e-9. The workers start once
for the module; every wait is bounded, and no worker outlives the
module.

As in the other port tests, the reference's unimportable Pallas module is
replaced for each test by a stand-in whose ``enabled()`` is False.
"""

import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdtypes
from ydb_tpu.engine.scan import ColumnSource as RSource
from ydb_tpu.plan import Database as RDatabase
from ydb_tpu.plan import execute_plan as r_execute_plan
from ydb_tpu.plan import to_host as r_to_host
from ydb_tpu.sql.parser import parse as rparse
from ydb_tpu.sql.planner import Catalog as RCatalog
from ydb_tpu.sql.planner import plan_select_full as r_plan_select_full
from ydb_tpu.workload import tpch as rtpch
from ydb_tpu.workload.queries import TPCH as RTPCH

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.dq.graph import SourceInput
from ydb_tpu_torch.dq.node_service import DistExecuter, ship_partitions
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.kqp.dq_lower import partition_source, plan_to_stages
from ydb_tpu_torch.runtime.actors import ActorId, ActorSystem
from ydb_tpu_torch.runtime.interconnect import Interconnect
from ydb_tpu_torch.sql.parser import parse
from ydb_tpu_torch.sql.planner import Catalog, plan_select_full
from ydb_tpu_torch.workload import tpch
from ydb_tpu_torch.workload.queries import TPCH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JOIN_SQL = ("SELECT b.w AS w, SUM(a.v) AS s FROM ta a JOIN tb b "
            "ON a.k = b.k GROUP BY b.w ORDER BY w")


@pytest.fixture(autouse=True)
def reference_scatter_tier(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def _spawn(tmp_path, *nodes):
    """Start port worker nodes on the CPU, all at once; returns
    [(proc, port)] in the order of ``nodes``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    started = []
    for node in nodes:
        port_file = tmp_path / f"port{node}"
        started.append((subprocess.Popen(
            [sys.executable, "-m", "ydb_tpu_torch.dq.node_service",
             "--node", str(node), "--port-file", str(port_file),
             "--device", "cpu"], env=env, cwd=REPO), port_file))
    deadline = time.monotonic() + 60
    try:
        for proc, port_file in started:
            while not port_file.exists():
                if proc.poll() is not None:
                    raise RuntimeError("worker died during startup")
                if time.monotonic() > deadline:
                    raise TimeoutError("worker did not report a port")
                time.sleep(0.02)
    except BaseException:
        for proc, _ in started:
            _reap(proc)
        raise
    return [(proc, int(f.read_text())) for proc, f in started]


def _reap(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=10)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Worker nodes 2 and 3, and node 4 for the test that kills it, all
    started once for the module; reaped at its end."""
    started = _spawn(tmp_path_factory.mktemp("ports"), 2, 3, 4)
    yield dict(zip((2, 3, 4), started))
    for proc, _ in started:
        _reap(proc)
    assert all(proc.poll() is not None for proc, _ in started)


@pytest.fixture
def parent_node():
    system = ActorSystem(node=1)
    ic = Interconnect(system, listen_port=0)
    yield system, ic
    ic.close()


def _equal(got, want, cols):
    assert got.num_rows == want.num_rows
    for c in cols:
        g, w = np.asarray(got.cols[c][0]), np.asarray(want.cols[c][0])
        np.testing.assert_array_equal(got.cols[c][1], want.cols[c][1],
                                      err_msg=f"validity {c}")
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-9, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _remote_placement(stages, node=2):
    """Join stages and the final transform run on the worker; scans stay
    with the data in the parent — so every shuffle crosses the wire."""
    placement = {}
    for si, s in enumerate(stages):
        if s.join is not None or si == len(stages) - 1:
            placement[si] = node
    return placement


def _join_tables(n, keys, seed):
    rng = np.random.default_rng(seed)
    ta = {"k": rng.integers(0, keys, n).astype(np.int64),
          "v": rng.integers(0, 100, n).astype(np.int64)}
    tb = {"k": np.arange(keys, dtype=np.int64),
          "w": rng.integers(0, 10, keys).astype(np.int64)}
    return ta, tb


def _join_plan(side_dtypes, side_catalog, side_plan, side_parse):
    sa = side_dtypes.Schema((side_dtypes.Field("k", side_dtypes.INT64),
                             side_dtypes.Field("v", side_dtypes.INT64)))
    sb = side_dtypes.Schema((side_dtypes.Field("k", side_dtypes.INT64),
                             side_dtypes.Field("w", side_dtypes.INT64)))
    catalog = side_catalog(schemas={"ta": sa, "tb": sb}, primary_keys={})
    return side_plan(side_parse(JOIN_SQL), catalog).plan, sa, sb


def _reference_join(ta, tb):
    plan, sa, sb = _join_plan(rdtypes, RCatalog, r_plan_select_full, rparse)
    return r_to_host(r_execute_plan(plan, RDatabase(
        sources={"ta": RSource(ta, sa), "tb": RSource(tb, sb)}),
        use_dq=False))


def test_tpch_join_shuffles_across_processes(workers, parent_node):
    system, ic = parent_node
    proc, port = workers[2]
    ic.add_peer(2, "127.0.0.1", port)
    data = tpch.TpchData(sf=0.004, seed=23)
    catalog = Catalog(
        schemas={t: data.schema(t) for t in data.tables},
        primary_keys=dict(tpch.PRIMARY_KEYS), dicts=data.dicts)
    plan = plan_select_full(parse(TPCH["q3"]), catalog).plan
    stages = plan_to_stages(plan, n_tasks=2)
    placement = _remote_placement(stages)
    assert placement, "q3 must have remote-placed join stages"
    sources = {
        t: partition_source(
            ColumnSource(cols, data.schema(t), data.dicts), 2)
        for t, cols in data.tables.items()
    }
    ex = DistExecuter(system, services={2: ActorId(2, 1)},
                      pump=lambda: ic.pump(0.05), device="cpu")
    res = ex.run(stages, sources, placement, dicts=data.dicts,
                 block_rows=1 << 12, timeout=120.0)

    rdata = rtpch.TpchData(sf=0.004, seed=23)
    rcat = RCatalog(
        schemas={t: rdata.schema(t) for t in rdata.tables},
        primary_keys=dict(rtpch.PRIMARY_KEYS), dicts=rdata.dicts)
    rplan = r_plan_select_full(rparse(RTPCH["q3"]), rcat).plan
    ref = r_to_host(r_execute_plan(rplan, RDatabase(
        sources={t: RSource(cols, rdata.schema(t), rdata.dicts)
                 for t, cols in rdata.tables.items()},
        dicts=rdata.dicts), use_dq=False))
    assert res.num_rows > 0
    _equal(res, ref, ("l_orderkey", "revenue", "o_orderdate",
                      "o_shippriority"))


def test_three_nodes_worker_to_worker_shuffle(workers, parent_node):
    """Scan stages SHIPPED to worker 3 (host partitions travel in
    StartTasks), join stages on worker 2 — the shuffle flows worker-to-
    worker on routes the executer's address book taught."""
    system, ic = parent_node
    (p2, port2), (p3, port3) = workers[2], workers[3]
    ic.add_peer(2, "127.0.0.1", port2)
    ic.add_peer(3, "127.0.0.1", port3)
    ta, tb = _join_tables(30_000, 1_000, 3)
    plan, sa, sb = _join_plan(dtypes, Catalog, plan_select_full, parse)
    stages = plan_to_stages(plan, n_tasks=3)
    placement = {}
    for si, s in enumerate(stages):
        if any(isinstance(i, SourceInput) for i in s.inputs):
            placement[si] = 3
        elif s.join is not None:
            placement[si] = 2
    assert 3 in placement.values() and 2 in placement.values()
    sources = {"ta": partition_source(ColumnSource(ta, sa), 3),
               "tb": partition_source(ColumnSource(tb, sb), 3)}
    ex = DistExecuter(system,
                      services={2: ActorId(2, 1), 3: ActorId(3, 1)},
                      pump=lambda: ic.pump(0.05),
                      peers=dict(ic.peers), device="cpu")
    res = ex.run(stages, sources, placement, block_rows=1024,
                 timeout=120.0)
    _equal(res, _reference_join(ta, tb), ("w", "s"))


def test_worker_death_mid_query_aborts_cleanly(workers, parent_node):
    system, ic = parent_node
    proc, port = workers[4]
    try:
        ic.add_peer(4, "127.0.0.1", port)
        ta, tb = _join_tables(50_000, 5_000, 7)
        plan, sa, sb = _join_plan(dtypes, Catalog, plan_select_full, parse)
        stages = plan_to_stages(plan, n_tasks=2)
        placement = _remote_placement(stages, node=4)
        sources = {"ta": partition_source(ColumnSource(ta, sa), 2),
                   "tb": partition_source(ColumnSource(tb, sb), 2)}
        pumps = [0]
        killed = []

        def pump():
            pumps[0] += 1
            if pumps[0] == 8 and proc.poll() is None:
                proc.send_signal(signal.SIGKILL)  # mid-query worker death
                proc.wait(timeout=10)
                killed.append(time.monotonic())
            ic.pump(0.05)

        ex = DistExecuter(system, services={4: ActorId(4, 1)}, pump=pump,
                          device="cpu")
        with pytest.raises(RuntimeError, match="aborted|unreachable"):
            ex.run(stages, sources, placement, block_rows=256,
                   timeout=120.0)
        # a clean FAST failure (liveness ping / undelivered channel
        # data), not a run to the deadline
        assert killed and time.monotonic() - killed[0] < 10
    finally:
        _reap(proc)
    assert proc.poll() is not None


def test_shipped_partitions_are_host_arrays_of_the_read_columns():
    src = ColumnSource(
        {"a": np.arange(6, dtype=np.int64),
         "b": np.arange(6, dtype=np.int64) * 2},
        dtypes.Schema((dtypes.Field("a", dtypes.INT64),
                       dtypes.Field("b", dtypes.INT64)))).to_device("cpu")
    (part,) = ship_partitions(partition_source(src, 2)[1:], ("b",))
    assert set(part.columns) == {"b"}
    assert isinstance(part.columns["b"], np.ndarray)
    np.testing.assert_array_equal(part.columns["b"], [2, 6, 10])
    assert part.schema.names == ("a", "b")
