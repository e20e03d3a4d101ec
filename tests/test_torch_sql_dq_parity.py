"""The port's ``execute_plan_dq`` against the reference's, on the CPU.

The cases of ``tests/test_sql_dq.py``: TPC-H q1, q3, q5, q12 and a
group-less ``ORDER BY ... LIMIT`` over a join, planned by both packages
(the reference's scalar-subquery values replayed into the port's
planner) and run through each package's ``execute_plan_dq`` on
``SimRuntime(2)`` with 3 tasks per stage and 4096-row blocks, on the
same data (sf 0.004, seed 17). Integers, dictionary ids and validity bit
for bit, float64 at rtol 1e-12, rows in the same order. Most of the time
here is the reference's XLA compiles of its per-stage programs.

As in the other port tests, the reference's unimportable Pallas module is
replaced for each test by a stand-in whose ``enabled()`` is False.
"""

import pytest

from ydb_tpu.engine.scan import ColumnSource as RSource
from ydb_tpu.kqp import dq_lower as rdq_lower
from ydb_tpu.runtime.test_runtime import SimRuntime as RSimRuntime

from test_torch_sql import assert_tables_equal
from test_torch_sql_dq import (  # noqa: F401  (reference_walk: autouse)
    N_TASKS,
    _plan_port,
    _plan_ref,
    _port,
    _ref,
    reference_walk,
)
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.kqp import dq_lower
from ydb_tpu_torch.runtime.test_runtime import SimRuntime
from ydb_tpu_torch.workload.queries import TPCH

BLOCK_ROWS = 1 << 12
SF, SEED = 0.004, 17
ORDER_BY_SQL = ("SELECT l.l_orderkey AS k, l.l_extendedprice AS p "
                "FROM lineitem l JOIN orders o ON l.l_orderkey = o.o_orderkey "
                "ORDER BY p DESC, k LIMIT 50")


@pytest.fixture(scope="module")
def parity_port():
    return _port(SF, SEED)


@pytest.fixture(scope="module")
def parity_ref():
    return _ref(SF, SEED)


def _dq_sources_port(port, n):
    data = port[0]
    return {t: dq_lower.partition_source(
        ColumnSource(c, data.schema(t), data.dicts), n)
        for t, c in data.tables.items()}


def _dq_sources_ref(ref, n):
    data = ref[0]
    return {t: rdq_lower.partition_source(
        RSource(c, data.schema(t), data.dicts), n)
        for t, c in data.tables.items()}


@pytest.mark.parametrize("name", ["q1", "q3", "q5", "q12", "order_by"])
def test_execute_plan_dq_matches_reference(name, parity_port, parity_ref):
    """The same plan through both packages' ``execute_plan_dq`` on
    ``SimRuntime(2)``, 3 tasks per stage, 4096-row blocks (1024 for the
    group-less ORDER BY ... LIMIT, whose sort must run once over the
    merged inputs)."""
    sql = ORDER_BY_SQL if name == "order_by" else TPCH[name]
    rows = 1 << 10 if name == "order_by" else BLOCK_ROWS
    rpq, scalars = _plan_ref(sql, parity_ref)
    pq = _plan_port(sql, parity_port, scalars)
    want = rdq_lower.execute_plan_dq(
        rpq.plan, _dq_sources_ref(parity_ref, N_TASKS), RSimRuntime(2),
        dicts=parity_ref[0].dicts, n_tasks=N_TASKS, block_rows=rows)
    got = dq_lower.execute_plan_dq(
        pq.plan, _dq_sources_port(parity_port, N_TASKS), SimRuntime(2),
        dicts=parity_port[0].dicts, n_tasks=N_TASKS, block_rows=rows,
        device="cpu")
    assert_tables_equal(got, want, name)
    assert got.num_rows > 0


