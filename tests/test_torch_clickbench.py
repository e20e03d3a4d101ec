"""The 43 ClickBench queries through the port, on the CPU.

All of ``ydb_tpu_torch/workload/clickbench.py:QUERIES`` at 20,000 hits
rows, seed 3, planned by the port's planner and run through its default
routing (``execute_plan``): whole-plan fusion answers the 41 join-free
plans, the DQ stage graph the two whose COUNT(DISTINCT) plans join
(q9, q22), as in the reference. Each result is held against
``reference_answers``, the independent numpy canondata, by ``_verify``
(the checks of ``tests/test_clickbench.py``). A handful are also held
against the JAX package's results column for column, and the port's
copies of the generator, the SQL texts and the canondata against the
reference's.

As in the other port tests, the reference's unimportable Pallas module is
replaced for each test by a stand-in whose ``enabled()`` is False.
"""

import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu.engine.scan import ColumnSource as RSource
from ydb_tpu.plan import Database as RDatabase
from ydb_tpu.plan import execute_plan as rexecute
from ydb_tpu.plan import to_host as rto_host
from ydb_tpu.sql.parser import parse as rparse
from ydb_tpu.sql.planner import Catalog as RCatalog
from ydb_tpu.sql.planner import plan_select_full as rplan
from ydb_tpu.workload import clickbench as rclickbench

from test_torch_sql import assert_tables_equal
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.plan import Database, execute_plan, executor, to_host
from ydb_tpu_torch.sql.parser import parse
from ydb_tpu_torch.sql.planner import Catalog, plan_select_full
from ydb_tpu_torch.ssa import plan_fuse
from ydb_tpu_torch.workload import clickbench

ROWS, SEED = 20_000, 3
NAMES = sorted(clickbench.QUERIES, key=lambda q: int(q[1:]))
#: the plans whose COUNT(DISTINCT) lowers to a self-join: DQ answers them
JOINED = ("q9", "q22")


@pytest.fixture(autouse=True)
def reference_stub(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", None)


@pytest.fixture(scope="module")
def port():
    data = clickbench.ClickBenchData(rows=ROWS, seed=SEED)
    db = Database(
        sources={"hits": ColumnSource(data.hits, clickbench.HITS_SCHEMA,
                                      data.dicts)},
        dicts=data.dicts, device="cpu")
    catalog = Catalog(schemas={"hits": clickbench.HITS_SCHEMA},
                      primary_keys={"hits": ("WatchID",)}, dicts=data.dicts)
    return data, db, catalog, clickbench.reference_answers(data)


@pytest.fixture
def routed(monkeypatch):
    """Which executor answered each statement: "fused", "dq" or "walk"."""
    seen = []
    for name in ("_execute_plan_fused", "_execute_plan_dq"):
        real = getattr(executor, name)

        def spy(plan, db, _real=real, _kind=name.rsplit("_", 1)[-1]):
            out = _real(plan, db)
            if out is not None:
                seen.append(_kind)
            return out

        monkeypatch.setattr(executor, name, spy)
    return seen


def run_port(name, port):
    data, db, catalog, _ = port
    pq = plan_select_full(parse(clickbench.QUERIES[name]), catalog)
    return to_host(execute_plan(pq.plan, db)), pq


@pytest.mark.parametrize("name", NAMES)
def test_query_through_default_routing_matches_canondata(name, port, routed):
    data, _, _, want = port
    out, pq = run_port(name, port)
    assert routed == ["dq" if name in JOINED else "fused"], routed
    clickbench._verify(name, out, want[name], data, pq)
    # q19 filters on a spec UserID the synthetic data never holds
    assert out.num_rows >= 1 or name == "q19"


@pytest.mark.parametrize("name", ["q7", "q14", "q28", "q33", "q35", "q39"])
def test_query_matches_reference(name, port, monkeypatch):
    """The port's default routing against the reference's (fusion there
    too) on the same table: columns, rows and order, ints and dictionary
    ids exact, floats at rtol 1e-12."""
    rdata = rclickbench.ClickBenchData(rows=ROWS, seed=SEED)
    rdb = RDatabase(
        sources={"hits": RSource(rdata.hits, rclickbench.HITS_SCHEMA,
                                 rdata.dicts)},
        dicts=rdata.dicts)
    rcat = RCatalog(schemas={"hits": rclickbench.HITS_SCHEMA},
                    primary_keys={"hits": ("WatchID",)}, dicts=rdata.dicts)
    want = rto_host(rexecute(
        rplan(rparse(rclickbench.QUERIES[name]), rcat).plan, rdb))
    got, _ = run_port(name, port)
    assert got.num_rows > 0
    assert_tables_equal(got, want, name)


def test_workload_copies_match_reference(port):
    """The generator gives the reference's table, the 43 SQL texts are the
    reference's, and so is the canondata."""
    data, _, _, want = port
    assert clickbench.QUERIES == rclickbench.QUERIES
    assert len(clickbench.QUERIES) == 43
    rdata = rclickbench.ClickBenchData(rows=ROWS, seed=SEED)
    assert data.hits.keys() == rdata.hits.keys()
    for col, a in data.hits.items():
        np.testing.assert_array_equal(a, rdata.hits[col], err_msg=col)
    assert want == rclickbench.reference_answers(rdata)


def test_run_clickbench_verifies_a_subset():
    """``run_clickbench``, the suite's runner, plans, runs and verifies."""
    res = clickbench.run_clickbench(rows=5000, seed=SEED, device="cpu",
                                    queries=["q0", "q7", "q33"])
    assert [r[0] for r in res] == ["q0", "q7", "q33"]
    assert all(r[2] >= 1 for r in res)


def test_clickbench_cli_verb(capsys):
    """``tests/test_clickbench.py::test_clickbench_cli_verb`` through the
    port's ``cli.py`` with ``--platform cpu``: ``run_clickbench`` verifies
    each query against the numpy ``reference_answers`` (a mismatch
    raises), and the verb prints one line per query."""
    from ydb_tpu_torch.cli import main

    main(["workload", "clickbench", "--rows", "5000", "--queries",
          "q0,q1,q7", "--platform", "cpu"])
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == \
        ["q0", "q1", "q7"]
    assert all(line.endswith("rows") for line in out.splitlines())
