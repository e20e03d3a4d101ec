"""Embedded workload runner (the `ydb workload tpch` analog,
public/lib/ydb_cli benchmark_utils.cpp; SURVEY.md layer 9).

The port's own copy of ``ydb_tpu/workload/runner.py``; every entry point
takes the ``device`` its statements run on (CUDA when None)."""

from __future__ import annotations

import time

from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.plan import Database, execute_plan, to_host
from ydb_tpu_torch.sql.parser import parse
from ydb_tpu_torch.sql.planner import Catalog, plan_select_full
from ydb_tpu_torch.workload import tpch
from ydb_tpu_torch.workload.queries import TPCH


def tpch_database(data: tpch.TpchData,
                  device=None) -> tuple[Database, Catalog]:
    db = Database(
        sources={
            t: ColumnSource(cols, data.schema(t), data.dicts)
            for t, cols in data.tables.items()
        },
        dicts=data.dicts, device=device,
    )
    catalog = Catalog(
        schemas={t: data.schema(t) for t in data.tables},
        primary_keys=dict(tpch.PRIMARY_KEYS),
        dicts=data.dicts,
    )
    return db, catalog


def scalar_exec_for(db: Database):
    """Uncorrelated-scalar-subquery executor bound to a Database."""
    def scalar_exec(plan_node, t):
        out = to_host(execute_plan(plan_node, db))
        col = out.schema.names[0]
        v, ok = out.cols[col]
        if len(v) != 1:
            raise ValueError(f"scalar subquery returned {len(v)} rows")
        return v[0].item(), bool(ok[0])

    return scalar_exec


def run_tpch(sf: float = 0.01, queries: list[str] | None = None,
             iterations: int = 1, seed: int = 42, device=None):
    """Returns [(name, best_seconds, result_rows)]. The first run of a
    query includes its one-off costs (kernel builds, staging); timing
    takes the best of ``iterations`` post-warmup runs."""
    data = tpch.TpchData(sf=sf, seed=seed)
    db, catalog = tpch_database(data, device)
    names = queries or sorted(TPCH)
    results = []
    for name in names:
        sql = TPCH[name]
        plan = plan_select_full(parse(sql), catalog,
                                scalar_exec_for(db)).plan
        out = to_host(execute_plan(plan, db))  # warmup/compile
        best = float("inf")
        for _ in range(max(1, iterations)):
            t0 = time.monotonic()
            out = to_host(execute_plan(plan, db))
            best = min(best, time.monotonic() - t0)
        results.append((name, best, out.num_rows))
    return results
