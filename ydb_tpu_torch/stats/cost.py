"""Selectivity + cardinality estimation over table statistics.

The port's own copy of ``ydb_tpu/stats/cost.py`` (device-free).

The CBO feed (ydb/library/yql/core/cbo shape): table-level row counts,
per-column NDV/null-fraction/value bounds (stats.aggregator) turned
into

  * conjunctive filter selectivity (equality via 1/NDV, ranges via
    value-span fractions, IN via k/NDV) — plan sizing for scans;
  * group-count estimates (capped NDV products) — the SSA compiler's
    group-by tier choice and group-capacity sizing;
  * plan-node row estimates — DQ join build-side selection and expand
    fanout sizing (kqp/dq_lower).

Estimates are advisory ONLY: every consumer treats them as performance
hints and keeps exactness through its own mechanisms (zone-derived
bounds are exact; estimated tiers all compute identical results).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ColumnStats:
    """Table-level statistics for one column (physical value domain)."""

    ndv: int = 0
    nulls: int = 0
    rows: int = 0
    vmin: object = None
    vmax: object = None
    # heaviest-hitter frequency bound (CountMinSketch.max_freq): the
    # most common value occurs at most this many times. Sizes shuffle
    # buckets under skew (parallel/shuffle.size_buckets); 0 = unknown.
    heavy: int = 0

    @property
    def null_fraction(self) -> float:
        return self.nulls / self.rows if self.rows else 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "ColumnStats":
        return ColumnStats(**d)


@dataclasses.dataclass
class TableStats:
    rows: int = 0
    columns: dict = dataclasses.field(default_factory=dict)

    def column(self, name: str) -> ColumnStats | None:
        return self.columns.get(name)

    def to_json(self) -> dict:
        return {"rows": self.rows,
                "columns": {n: c.to_json()
                            for n, c in self.columns.items()}}

    @staticmethod
    def from_json(d: dict) -> "TableStats":
        return TableStats(
            rows=d["rows"],
            columns={n: ColumnStats.from_json(c)
                     for n, c in d["columns"].items()})


def _span_fraction(cs: ColumnStats, lo, hi) -> float:
    """Fraction of the value span [vmin, vmax] covered by [lo, hi],
    assuming uniformity (the classic System-R guess)."""
    if cs.vmin is None or cs.vmax is None:
        return 0.33
    try:
        span = float(cs.vmax) - float(cs.vmin)
        if span <= 0:
            return 1.0
        lo_c = max(float(lo), float(cs.vmin))
        hi_c = min(float(hi), float(cs.vmax))
        return max(0.0, min(1.0, (hi_c - lo_c) / span))
    except (TypeError, ValueError):
        return 0.33


def pred_selectivity(pred, stats: TableStats) -> float:
    """Selectivity of one zone-style conjunct (stats.zonemap.Pred)."""
    cs = stats.column(pred.column)
    if pred.op == "never":
        return 0.0
    if cs is None or cs.rows == 0:
        return 0.33
    notnull = 1.0 - cs.null_fraction
    ndv = max(cs.ndv, 1)
    if pred.op == "eq":
        return notnull / ndv
    if pred.op == "ne":
        return notnull * (1.0 - 1.0 / ndv)
    if pred.op == "in":
        return min(1.0, notnull * len(pred.value) / ndv)
    v = pred.value
    if pred.op in ("lt", "le"):
        return notnull * _span_fraction(cs, cs.vmin, v)
    if pred.op in ("gt", "ge"):
        return notnull * _span_fraction(cs, v, cs.vmax)
    return 0.33


def conj_selectivity(preds, stats: TableStats) -> float:
    """Independence-model selectivity of a conjunction, with per-column
    range conjuncts (lo <= c AND c < hi) intersected exactly instead of
    multiplied — the common band predicate would otherwise square its
    own selectivity."""
    sel = 1.0
    by_col: dict[str, list] = {}
    for p in preds:
        by_col.setdefault(p.column, []).append(p)
    for col, ps in by_col.items():
        cs = stats.column(col)
        ranged = [p for p in ps if p.op in ("lt", "le", "gt", "ge")]
        rest = [p for p in ps if p.op not in ("lt", "le", "gt", "ge")]
        if len(ranged) >= 2 and cs is not None and cs.rows:
            lo = max((p.value for p in ranged
                      if p.op in ("gt", "ge")), default=cs.vmin)
            hi = min((p.value for p in ranged
                      if p.op in ("lt", "le")), default=cs.vmax)
            sel *= (1.0 - cs.null_fraction) * _span_fraction(cs, lo, hi)
        else:
            for p in ranged:
                sel *= pred_selectivity(p, stats)
        for p in rest:
            sel *= pred_selectivity(p, stats)
    return max(0.0, min(1.0, sel))


def estimate_filter_rows(program, schema, stats: TableStats) -> float:
    """Estimated output rows of a program's leading filters over a
    table with ``stats``."""
    from ydb_tpu_torch.stats.zonemap import extract_predicates

    preds, _full = extract_predicates(program, schema)
    return stats.rows * conj_selectivity(preds, stats)


def estimate_group_count(keys, stats: TableStats) -> float | None:
    """Estimated distinct group count of GROUP BY ``keys``: NDV product
    capped by the row count. None when no key has statistics."""
    est = 1.0
    known = False
    for k in keys:
        cs = stats.column(k)
        if cs is None or cs.ndv <= 0:
            continue
        known = True
        est *= cs.ndv + (1 if cs.nulls else 0)  # NULL forms its own group
    if not known:
        return None
    return min(est, float(max(stats.rows, 1)))


def choose_group_tier(n_groups: float) -> str:
    """The group-by execution tier a given group count lands in (the
    acceptance oracle: the tier chosen from the NDV estimate must match
    the tier the TRUE group count picks)."""
    from ydb_tpu_torch.ssa import kernels

    if n_groups <= kernels.ONEHOT_GROUP_LIMIT:
        return "onehot"
    return "large"


def estimate_plan_rows(node, stats_by_table: dict,
                       schemas: dict | None = None) -> float | None:
    """Row estimate for a logical plan subtree (plan.nodes shapes).
    None = unknown (consumers keep their defaults). ``schemas`` (table
    -> dtypes.Schema) types predicate literals correctly — without the
    real schema a decimal column's scaled physical bounds would be
    compared against a descaled literal, skewing band selectivities by
    orders of magnitude; stat-known columns then fall back to INT64."""
    from ydb_tpu_torch.plan.nodes import ExpandJoin, LookupJoin, TableScan, Transform

    if isinstance(node, TableScan):
        st = stats_by_table.get(node.table)
        if st is None:
            return None
        if node.program is None:
            return float(st.rows)
        from ydb_tpu_torch.ssa.program import GroupByStep

        gb = next((s for s in node.program.steps
                   if isinstance(s, GroupByStep)), None)
        schema = (schemas or {}).get(node.table) or _scan_schema(st)
        try:
            rows = estimate_filter_rows(node.program, schema, st)
        except KeyError:
            rows = float(st.rows)
        if gb is not None:
            g = estimate_group_count(gb.keys, st)
            rows = min(rows, g) if g is not None else rows
        return rows
    if isinstance(node, LookupJoin):
        return estimate_plan_rows(node.probe, stats_by_table, schemas)
    if isinstance(node, ExpandJoin):
        p = estimate_plan_rows(node.probe, stats_by_table, schemas)
        b = estimate_plan_rows(node.build, stats_by_table, schemas)
        if p is None or b is None:
            return None
        # equi-join: |P||B| / max(ndv) with unknown key NDV -> assume
        # a modest 4x fanout bound
        return p * min(4.0, max(b, 1.0) ** 0.5)
    if isinstance(node, Transform):
        return estimate_plan_rows(node.input, stats_by_table, schemas)
    return None


def _scan_schema(stats: TableStats):
    """Fallback synthetic schema naming the stat-known columns as
    INT64 (selectivity needs names + a numeric type); callers with the
    real catalog pass ``schemas`` instead."""
    from ydb_tpu_torch import dtypes

    return dtypes.Schema(tuple(
        dtypes.Field(n, dtypes.INT64) for n in stats.columns))
