"""Zone maps: per-chunk / per-portion column min-max-null statistics
and the predicate algebra that consumes them.

The port's own copy of ``ydb_tpu/stats/zonemap.py`` (device-free).

Reference shape: TPortionInfo column metadata (min/max per column blob,
engines/portion_info.h) consumed by the scan planner's range
intersection (SURVEY.md §2.7). Here a *zone* is ``[vmin, vmax,
null_count]`` per column per row-group chunk, serialized into the
portion blob header (v1 headers, engine/portion.py) and — at portion
granularity — into ``PortionMeta.zones`` so planning never touches blob
storage.

Value domain: zones hold PHYSICAL column values (scaled-decimal int64s,
dict-encoded string ids, float64s), and predicates are converted into
the same domain before matching (``physical_const``). Matching is a
trichotomy — ``none`` (no row can satisfy the predicate: skip the
chunk), ``some`` (must read), ``all`` (every row provably satisfies it:
the filter kernel can be skipped for this data). NULL rows never match
a comparison predicate, so ``none`` ignores nulls while ``all``
additionally requires ``null_count == 0``.

All decisions are conservative: an unknown zone, an undecomposable
expression or a dtype surprise degrades to "read the chunk", never to a
wrong skip — pruned scans stay bit-identical to unpruned ones.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.ssa.ops import Op
from ydb_tpu_torch.ssa.program import (
    AssignStep,
    Call,
    Col,
    Const,
    DictPredicate,
    FilterStep,
    Program,
    ProjectStep,
)

# ---------------- zone construction (write path) ----------------


def zone_of(arr: np.ndarray, validity: np.ndarray | None = None):
    """(vmin, vmax, null_count) of one column slice, dtype-aware.

    Typed values: ints (incl. dict ids, scaled decimals, dates) stay
    ints; floats stay floats (NaN bounds are legal and match nothing,
    which is conservative both ways); bools report 0/1. ``(None, None,
    nulls)`` when no valid value exists.
    """
    n = int(arr.size)
    if validity is not None:
        nulls = n - int(np.count_nonzero(validity))
        vals = arr[validity] if nulls else arr
    else:
        nulls = 0
        vals = arr
    if vals.size == 0:
        return None, None, nulls
    vmin, vmax = vals.min(), vals.max()
    if arr.dtype.kind in ("i", "u", "b"):
        return int(vmin), int(vmax), nulls
    if arr.dtype.kind == "f":
        return float(vmin), float(vmax), nulls
    return None, None, nulls  # unknown physical dtype: no stats


def column_zones(
    columns: dict[str, np.ndarray],
    validity: dict[str, np.ndarray] | None = None,
    lo: int = 0,
    hi: int | None = None,
) -> dict[str, list]:
    """JSON-ready zones for every column of a row slice ``[lo, hi)``.

    This is the vectorized write-path entry: one min/max/count pass per
    column slice, no python-per-row work."""
    out: dict[str, list] = {}
    for name, arr in columns.items():
        end = len(arr) if hi is None else hi
        v = None
        if validity and name in validity:
            v = validity[name][lo:end]
        vmin, vmax, nulls = zone_of(arr[lo:end], v)
        if vmin is None and nulls == 0 and end > lo:
            continue  # unstatable dtype: omit rather than lie
        out[name] = [vmin, vmax, nulls]
    return out


# ---------------- predicates (read path) ----------------

#: comparison flip for ``const OP col`` spellings
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
         "eq": "eq", "ne": "ne"}

_CMP_OPS = {Op.EQ: "eq", Op.NE: "ne", Op.LT: "lt", Op.LE: "le",
            Op.GT: "gt", Op.GE: "ge"}


@dataclasses.dataclass(frozen=True)
class Pred:
    """One zone-checkable conjunct: ``column OP value`` in the column's
    physical domain. ``op`` is eq|ne|lt|le|gt|ge|in|never ("never" =
    provably constant-false, e.g. equality with an absent dictionary
    value: the whole scan may be emptied)."""

    column: str
    op: str
    value: object = None  # scalar, or sorted tuple for "in"
    step: int = -1        # FilterStep index this conjunct came from

    def fingerprint(self) -> tuple:
        """Hashable identity for cache keys (a pruned block stream is
        only reusable under the same predicate set)."""
        return (self.column, self.op, self.value)


def physical_const(col_type: dtypes.LogicalType, value, value_type):
    """Convert a literal into the column's physical value domain.
    Returns an int/float, or None when not convertible (skip the
    conjunct)."""
    if value is None or isinstance(value, (bytes, str)):
        return None
    if isinstance(value, bool):
        value = int(value)
    if not isinstance(value, (int, float)):
        return None
    vscale = value_type.scale if value_type is not None and \
        value_type.is_decimal else 0
    if col_type.is_decimal:
        shift = col_type.scale - vscale
        if isinstance(value, int) and shift >= 0:
            return value * 10 ** shift
        return float(value) * 10.0 ** shift
    # non-decimal column: descale a decimal literal into plain value
    if vscale:
        return float(value) / 10.0 ** vscale
    if col_type.is_floating:
        return float(value)
    return value


def _decompose(expr, step_idx: int, schema: dtypes.Schema,
               shadowed: set, dicts) -> tuple[list, bool]:
    """(preds, full): conjuncts extracted from one filter expression and
    whether the WHOLE tree decomposed (required for the filter-skip
    fast path; partial extraction still prunes)."""
    if isinstance(expr, Call) and expr.op is Op.AND and len(expr.args) == 2:
        pa, fa = _decompose(expr.args[0], step_idx, schema, shadowed, dicts)
        pb, fb = _decompose(expr.args[1], step_idx, schema, shadowed, dicts)
        return pa + pb, fa and fb

    def col_of(e):
        if isinstance(e, Col) and e.name not in shadowed \
                and e.name in schema:
            return e.name
        return None

    if isinstance(expr, Call) and expr.op in _CMP_OPS \
            and len(expr.args) == 2:
        a, b = expr.args
        name, const, op = None, None, _CMP_OPS[expr.op]
        if col_of(a) is not None and isinstance(b, Const):
            name, const = col_of(a), b
        elif col_of(b) is not None and isinstance(a, Const):
            name, const, op = col_of(b), a, _FLIP[_CMP_OPS[expr.op]]
        if name is not None:
            t = schema.field(name).type
            v = physical_const(t, const.value, const.type)
            if v is not None:
                if op == "eq" and t.is_integer and \
                        isinstance(v, float) and not v.is_integer():
                    return [Pred(name, "never", step=step_idx)], True
                return [Pred(name, op, v, step_idx)], True
        return [], False
    if isinstance(expr, Call) and expr.op is Op.IN_SET and expr.args:
        name = col_of(expr.args[0])
        if name is not None and all(
                isinstance(a, Const) for a in expr.args[1:]):
            t = schema.field(name).type
            vals = []
            for a in expr.args[1:]:
                v = physical_const(t, a.value, a.type)
                if v is None:
                    return [], False
                vals.append(v)
            if not vals:
                return [Pred(name, "never", step=step_idx)], True
            return [Pred(name, "in", tuple(sorted(set(vals))),
                         step_idx)], True
        return [], False
    if isinstance(expr, DictPredicate) and dicts is not None \
            and expr.column in schema and expr.column not in shadowed:
        d = dicts[expr.column] if expr.column in dicts else None
        if d is None:
            return [], False
        if expr.kind == "eq":
            i = d.eq_id(expr.pattern)
            if i < 0:
                return [Pred(expr.column, "never", step=step_idx)], True
            return [Pred(expr.column, "eq", int(i), step_idx)], True
        if expr.kind == "in_set":
            ids = sorted({int(d.eq_id(v)) for v in expr.pattern
                          if d.eq_id(v) >= 0})
            if not ids:
                return [Pred(expr.column, "never", step=step_idx)], True
            return [Pred(expr.column, "in", tuple(ids), step_idx)], True
        return [], False
    return [], False


def extract_predicates(
    program: Program, schema: dtypes.Schema, dicts=None,
) -> tuple[list[Pred], set[int]]:
    """Zone-checkable conjuncts of a program's leading filters.

    Walks steps in order and stops at the first step that changes row
    identity (group-by/sort/window): a filter after such a step gates
    groups or post-limit rows, not source rows, and must never prune
    chunks. Columns shadowed by a prior AssignStep are skipped — their
    values are no longer the stored bytes the zones describe.

    Returns ``(preds, full_steps)``: ``full_steps`` are the FilterStep
    indices whose entire expression decomposed — candidates for the
    skip-the-filter-kernel fast path when every surviving zone reports
    "all".
    """
    preds: list[Pred] = []
    full: set[int] = set()
    shadowed: set = set()
    for i, step in enumerate(program.steps):
        if isinstance(step, AssignStep):
            shadowed.add(step.name)
        elif isinstance(step, FilterStep):
            got, whole = _decompose(step.expr, i, schema, shadowed, dicts)
            preds.extend(got)
            if whole and got:
                full.add(i)
        elif isinstance(step, ProjectStep):
            continue
        else:
            break  # group-by / sort / window: later filters don't prune
    return preds, full


# ---------------- zone matching ----------------


def match_zone(zone, pred: Pred, rows: int | None = None) -> str:
    """Trichotomy of one predicate against one zone: 'none' | 'some' |
    'all'. ``zone`` is ``[vmin, vmax, null_count]`` (or None for
    stat-less data)."""
    if pred.op == "never":
        return "none"
    if zone is None:
        return "some"
    vmin, vmax, nulls = zone[0], zone[1], zone[2]
    if vmin is None:
        # zero valid values: NULL rows match no comparison predicate
        return "none"
    try:
        if isinstance(vmin, float) and (math.isnan(vmin)
                                        or math.isnan(vmax)):
            return "some"  # NaN bounds prove nothing either way
        no_nulls = nulls == 0
        v = pred.value
        if pred.op == "eq":
            if v < vmin or v > vmax:
                return "none"
            return "all" if (vmin == vmax == v and no_nulls) else "some"
        if pred.op == "ne":
            if vmin == vmax == v:
                return "none"
            return "all" if no_nulls and (v < vmin or v > vmax) \
                else "some"
        if pred.op == "lt":
            if vmin >= v:
                return "none"
            return "all" if no_nulls and vmax < v else "some"
        if pred.op == "le":
            if vmin > v:
                return "none"
            return "all" if no_nulls and vmax <= v else "some"
        if pred.op == "gt":
            if vmax <= v:
                return "none"
            return "all" if no_nulls and vmin > v else "some"
        if pred.op == "ge":
            if vmax < v:
                return "none"
            return "all" if no_nulls and vmin >= v else "some"
        if pred.op == "in":
            inside = [s for s in v if vmin <= s <= vmax]
            if not inside:
                return "none"
            return "all" if (no_nulls and vmin == vmax
                             and vmin in v) else "some"
    except TypeError:
        return "some"  # incomparable domains: never skip on a surprise
    return "some"


def zones_decide(zones: dict | None, preds: list[Pred]) -> tuple[bool, set]:
    """Evaluate conjuncts against one zone dict (a chunk's or a
    portion's). Returns ``(skip, all_steps)``: skip is True when ANY
    conjunct proves no row matches; ``all_steps`` is the set of step
    indices whose every conjunct (on zone-known columns) reported
    'all' **for this zone dict** — callers intersect across data units
    before dropping a filter."""
    all_by_step: dict[int, bool] = {}
    for p in preds:
        zone = None if zones is None else zones.get(p.column)
        m = match_zone(zone, p)
        if m == "none":
            return True, set()
        all_by_step[p.step] = all_by_step.get(p.step, True) and m == "all"
    return False, {s for s, ok in all_by_step.items() if ok}


def drop_filter_steps(program: Program, steps: set[int]) -> Program:
    """Program with the given FilterStep indices removed (the fast path
    for zone-proven all-match filters — every row passes them, so the
    compiled program need not evaluate them)."""
    if not steps:
        return program
    kept = tuple(s for i, s in enumerate(program.steps) if i not in steps)
    return Program(kept)


def preds_fingerprint(preds: list[Pred]) -> tuple:
    """Canonical hashable identity of a predicate set — block-cache keys
    must include it: a pruned block stream only equals another stream
    pruned under the SAME predicates."""
    return tuple(sorted(p.fingerprint() for p in preds))
