"""SQL through the port's DQ stage graph, on the CPU.

* All 22 TPC-H queries at sf 0.01, seed 11 through the port's default
  ``execute_plan`` against ``tests/golden_tpch.json``: every join-bearing
  plan must be answered by the DQ stage graph, q1 and q6 by the walk
  (whole-plan fusion, which would answer them by default, is pinned off
  here in both packages; ``tests/test_torch_plan_fuse.py`` tests it).
* The port's ``plan_to_stages`` equal to the reference's, field by field,
  for all 22 plans.
* Routing: the default sends joins to DQ, ``use_dq=False`` and
  ``DQ_ON = False`` walk, a plan that does not lower falls back to the
  walk; an expired statement deadline cancels a DQ graph.

Parity with the reference's ``execute_plan_dq`` is in
``tests/test_torch_sql_dq_parity.py``.

As in the other port tests, the reference's unimportable Pallas module is
replaced for each test by a stand-in whose ``enabled()`` is False.
"""

import dataclasses
import enum
import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu.engine.scan import ColumnSource as RSource
from ydb_tpu.kqp import dq_lower as rdq_lower
from ydb_tpu.plan import Database as RDatabase
from ydb_tpu.plan import execute_plan as rexecute
from ydb_tpu.plan import to_host as rto_host
from ydb_tpu.sql.parser import parse as rparse
from ydb_tpu.sql.planner import Catalog as RCatalog
from ydb_tpu.sql.planner import plan_select_full as rplan
from ydb_tpu.workload import tpch as rtpch

from test_torch_sql import GOLDEN, assert_tables_equal, digest
from ydb_tpu_torch.chaos import deadline
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.kqp import dq_lower
from ydb_tpu_torch.plan import Database, execute_plan, executor, to_host
from ydb_tpu_torch.plan.nodes import (
    ExpandJoin,
    LookupJoin,
    TableScan,
    Transform,
)
from ydb_tpu_torch.sql.parser import parse
from ydb_tpu_torch.sql.planner import Catalog, plan_select_full
from ydb_tpu_torch.ssa import plan_fuse as port_plan_fuse
from ydb_tpu_torch.ssa.program import Program, ProjectStep
from ydb_tpu_torch.workload import tpch
from ydb_tpu_torch.workload.queries import TPCH

QUERIES = sorted(TPCH, key=lambda q: int(q[1:]))
#: tests/test_sql_dq.py's tasks per stage
N_TASKS = 3


def _stub_reference(mp):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    mp.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    mp.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)
    from ydb_tpu.ssa import plan_fuse

    mp.setattr(plan_fuse, "FUSE_FORCE", False)
    # the port too: the routing tested here is DQ or the walk
    # (whole-plan fusion has its own tests)
    mp.setattr(port_plan_fuse, "FUSE_FORCE", False)


@pytest.fixture(autouse=True)
def reference_walk(monkeypatch):
    _stub_reference(monkeypatch)


def _port(sf, seed):
    data = tpch.TpchData(sf=sf, seed=seed)
    db = Database(
        sources={t: ColumnSource(c, data.schema(t), data.dicts)
                 for t, c in data.tables.items()},
        dicts=data.dicts, device="cpu")
    catalog = Catalog(schemas={t: data.schema(t) for t in data.tables},
                      primary_keys=dict(tpch.PRIMARY_KEYS), dicts=data.dicts)
    return data, db, catalog


def _ref(sf, seed):
    data = rtpch.TpchData(sf=sf, seed=seed)
    db = RDatabase(
        sources={t: RSource(c, data.schema(t), data.dicts)
                 for t, c in data.tables.items()},
        dicts=data.dicts)
    catalog = RCatalog(schemas={t: data.schema(t) for t in data.tables},
                       primary_keys=dict(rtpch.PRIMARY_KEYS),
                       dicts=data.dicts)
    return data, db, catalog


@pytest.fixture(scope="module")
def golden_port():
    return _port(GOLDEN["sf"], GOLDEN["seed"])


@pytest.fixture
def answered(monkeypatch):
    """Which executor answered each plan the default routing sent to DQ:
    True for the DQ stage graph, False when it fell back to the walk."""
    seen = []
    real = executor._execute_plan_dq

    def spy(plan, db):
        out = real(plan, db)
        seen.append(out is not None)
        return out

    monkeypatch.setattr(executor, "_execute_plan_dq", spy)
    return seen


def _has_join(plan):
    return any(isinstance(n, (LookupJoin, ExpandJoin))
               for n in executor._plan_nodes(plan))


def _plan_port(sql, port, scalars=None):
    """Plan ``sql`` with the port's planner; scalar subqueries run through
    the port, or take the values in ``scalars`` (in order) when given."""
    _, db, catalog = port
    given = list(scalars) if scalars is not None else None

    def scalar_exec(plan, t):
        if given is not None:
            return given.pop(0)
        out = to_host(execute_plan(plan, db))
        v, ok = out.cols[out.schema.names[0]]
        assert len(v) == 1, f"scalar subquery returned {len(v)} rows"
        return v[0].item(), bool(ok[0])

    return plan_select_full(parse(sql), catalog, scalar_exec)


def _plan_ref(sql, ref):
    """The reference's plan, and the values its scalar subqueries took."""
    _, db, catalog = ref
    scalars = []

    def scalar_exec(plan, t):
        out = rto_host(rexecute(plan, db, use_dq=False))
        v, ok = out.cols[out.schema.names[0]]
        scalars.append((v[0].item(), bool(ok[0])))
        return scalars[-1]

    return rplan(rparse(sql), catalog, scalar_exec), scalars


@pytest.mark.parametrize("name", QUERIES)
def test_tpch_query_through_default_routing_matches_golden(
        name, golden_port, answered):
    pq = _plan_port(TPCH[name], golden_port)
    answered.clear()  # scalar subqueries ran while planning
    res = to_host(execute_plan(pq.plan, golden_port[1]))
    res.dict_aliases = pq.dict_aliases
    want = GOLDEN["queries"][name]
    assert res.num_rows == want["rows"], name
    assert digest(res, golden_port[0].dicts) == want["sha"], name
    assert answered == ([True] if _has_join(pq.plan) else [])
    assert _has_join(pq.plan) == (name not in ("q1", "q6"))


def _norm(obj):
    """A plain-value form of a stage, program or plan: class name and
    fields of every dataclass, enums by name, numpy scalars as Python
    values, so the two packages' objects compare field by field."""
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # the port's JoinSpec has no fanout_hint: its join stages size
        # expand-join output exactly, with no first guess to carry
        return (type(obj).__name__, tuple(
            (f.name, _norm(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)
            if (type(obj).__name__, f.name) != ("JoinSpec", "fanout_hint")))
    if isinstance(obj, (tuple, list)):
        return tuple(_norm(v) for v in obj)
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


@pytest.fixture(scope="module")
def both_plans(golden_port):
    """The 22 plans by both planners (the reference's scalar-subquery
    values are replayed into the port's planner)."""
    ref = _ref(GOLDEN["sf"], GOLDEN["seed"])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _stub_reference(mp)
        for name in QUERIES:
            rpq, scalars = _plan_ref(TPCH[name], ref)
            out[name] = (_plan_port(TPCH[name], golden_port, scalars), rpq)
    return out


def _rows_estimate(node):
    """A stand-in row estimator (the same for both packages' nodes):
    scans by table size, joins and transforms 1e5 rows."""
    return {"lineitem": 6e4, "orders": 1.5e4, "partsupp": 8e3,
            "part": 2e3, "customer": 1.5e3}.get(
                getattr(node, "table", None), 1e5)


@pytest.mark.parametrize("n_tasks,estimated", [(2, False), (N_TASKS, False),
                                               (2, True)])
def test_plan_to_stages_matches_reference(n_tasks, estimated, both_plans):
    """All 22 plans lower to the reference's stages, field by field; also
    with a row estimator and build-side swaps allowed (the reference's
    statistics hooks, which neither package's executor enables)."""
    kw = ({"estimator": _rows_estimate, "allow_swap": True} if estimated
          else {})
    changed = 0
    for name, (pq, rpq) in both_plans.items():
        assert _norm(pq.plan) == _norm(rpq.plan), name
        got = dq_lower.plan_to_stages(pq.plan, n_tasks=n_tasks, **kw)
        want = rdq_lower.plan_to_stages(rpq.plan, n_tasks=n_tasks, **kw)
        if estimated:
            plain = dq_lower.plan_to_stages(pq.plan, n_tasks=n_tasks)
            changed += _norm(got) != _norm(plain)
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert _norm(g) == _norm(w), (name, i)
    # the estimator swapped build sides somewhere
    assert changed > 0 or not estimated


def test_default_routing_sends_joins_to_dq(golden_port, answered,
                                           monkeypatch):
    """The default executor answers a join plan through the DQ stage
    graph; ``use_dq=False`` and ``DQ_ON = False`` walk; all three agree."""
    db = golden_port[1]
    plan = _plan_port(TPCH["q3"], golden_port).plan
    answered.clear()
    dq = to_host(execute_plan(plan, db))
    assert answered == [True]
    walk = to_host(execute_plan(plan, db, use_dq=False))
    assert answered == [True]
    monkeypatch.setattr(executor, "DQ_ON", False)
    off = to_host(execute_plan(plan, db))
    assert answered == [True]
    assert_tables_equal(dq, walk, "q3")
    assert_tables_equal(off, walk, "q3")
    # join-free plans never reach the DQ executor, even when asked
    q6 = _plan_port(TPCH["q6"], golden_port).plan
    answered.clear()
    execute_plan(q6, db, use_dq=True)
    assert answered == []


def test_shared_subtree_falls_back_to_walk(golden_port, answered):
    """A plan whose join reads one scan node twice does not lower (the
    reference's rule: DQ would run the shared subtree once per consumer);
    the walk answers it."""
    db = golden_port[1]
    scan = TableScan("nation", columns=("n_nationkey", "n_regionkey"))
    plan = Transform(
        LookupJoin(scan, scan, ("n_nationkey",), ("n_nationkey",),
                   payload=("n_regionkey",), suffix="_b"),
        Program((ProjectStep(("n_nationkey", "n_regionkey_b")),)))
    got = to_host(execute_plan(plan, db))
    assert answered == [False]
    assert got.num_rows == 25
    np.testing.assert_array_equal(
        got.cols["n_regionkey_b"][0],
        golden_port[0].tables["nation"]["n_regionkey"])


@pytest.mark.parametrize("name", ["q3", "q9", "q18"])
def test_tables_held_as_tensors_through_dq(name, golden_port, answered,
                                           monkeypatch):
    """Tables moved to the device with ``ColumnSource.to_device`` (the CPU
    here, the card in chip_smoke.py): DQ partitions are then strided views
    of the resident tensors. With 3 tasks and 5000-row blocks (padded
    tails), every block a stage program receives is contiguous, and the
    results are the goldens."""
    import torch

    from ydb_tpu_torch.dq import compute

    monkeypatch.setattr(executor, "DQ_TASKS", 3)
    monkeypatch.setattr(executor, "DQ_BLOCK_ROWS", 5000)
    data, db, catalog = golden_port
    resident = Database(
        sources={t: s.to_device("cpu") for t, s in db.sources.items()},
        dicts=db.dicts, device="cpu")
    strided = []
    real_part = executor._partition_for_dq

    def part_spy(src):
        parts = real_part(src)
        strided.extend(not v.is_contiguous() for p in parts
                       for v in p.columns.values()
                       if isinstance(v, torch.Tensor))
        return parts

    monkeypatch.setattr(executor, "_partition_for_dq", part_spy)
    seen = []
    real_block = compute._CompiledStage.run_block

    def block_spy(self, block):
        seen.extend(c.data.is_contiguous() and c.validity.is_contiguous()
                    for c in block.columns.values())
        return real_block(self, block)

    monkeypatch.setattr(compute._CompiledStage, "run_block", block_spy)
    pq = _plan_port(TPCH[name], (data, resident, catalog))
    answered.clear()
    res = to_host(execute_plan(pq.plan, resident))
    res.dict_aliases = pq.dict_aliases
    assert answered == [True]
    assert any(strided) and seen and all(seen)
    want = GOLDEN["queries"][name]
    assert res.num_rows == want["rows"]
    assert digest(res, data.dicts) == want["sha"], name


def test_expired_deadline_cancels_dq_graph(golden_port, monkeypatch):
    """A source task past the statement deadline stops pumping and aborts
    the graph at its abort target (wired by ``WireTask``, as a multi-node
    executer wires it): the executor raises ``StatementCancelled``.
    Without an abort target (the local graph as built) the graph stalls;
    the executor reports that stall as the cancellation it is, also a
    ``StatementCancelled`` (the reference reports it incomplete with a
    ``RuntimeError``, ROADMAP.md queue C)."""
    from ydb_tpu_torch.dq import compute

    db = golden_port[1]
    plan = _plan_port(TPCH["q3"], golden_port).plan
    expired = deadline.Deadline(seconds=0.0)
    with deadline.activate(expired):
        with pytest.raises(deadline.StatementCancelled,
                           match="DQ stage graph: deadline exceeded"):
            execute_plan(plan, db)
    real = compute.build_stage_graph

    def wired(*a, **k):
        handle = real(*a, **k)
        for aid in handle.actor_of_task.values():
            handle.systems[0].send(aid, compute.WireTask(
                {}, abort_target=handle.collector_id))
        return handle

    monkeypatch.setattr(compute, "build_stage_graph", wired)
    with deadline.activate(expired):
        with pytest.raises(deadline.StatementCancelled, match="deadline"):
            execute_plan(plan, db)
    # the same plan still runs once the deadline is gone
    assert to_host(execute_plan(plan, db)).num_rows == 10
