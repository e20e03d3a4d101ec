"""SQL AST → logical plan (binding, pushdown, join + subquery planning).

The compact analog of the reference's KQP compile pipeline (SURVEY.md
§3.2): name binding and type derivation (kqp_type_ann), predicate
pushdown into table scans (the OLAP pushdown shape,
opt/physical/kqp_opt_phy_olap_filter.cpp), join planning over FK->PK
lookup joins vs N:M expansion (CBO-lite: keyed on catalog primary keys),
subquery planning — EXISTS/IN lower to semi/anti joins, correlated
scalar subqueries decorrelate into aggregate joins, uncorrelated ones
execute eagerly as a prior phase (the kqp "precompute" phase shape,
kqp_opt_phy_precompute.cpp) — derived tables / CTEs compose as plan
subtrees, aggregate/HAVING/ORDER BY lowering into SSA programs.

Output is a ydb_tpu_torch.plan tree, walked by plan/executor.py.

The port's copy of ``ydb_tpu/sql/planner.py``: device-free, unchanged
apart from its imports, so both packages plan a statement into the same
tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.blocks.dictionary import _as_bytes as _as_b
from ydb_tpu_torch.plan.nodes import (
    Concat, ExpandJoin, LookupJoin, TableScan, Transform,
)
from ydb_tpu_torch.sql import ast
from ydb_tpu_torch.ssa.ops import Agg, Op
from ydb_tpu_torch.ssa.program import (
    AggSpec,
    AssignStep,
    Call,
    Col,
    Const,
    DictMap,
    DictPredicate,
    FilterStep,
    GroupByStep,
    Program,
    ProjectStep,
    SortStep,
    WindowStep,
    infer_type,
)

_AGG_FUNCS = {
    "sum": Agg.SUM, "avg": Agg.AVG, "min": Agg.MIN, "max": Agg.MAX,
    "count": Agg.COUNT, "some": Agg.SOME,
    "stddev_samp": Agg.STDDEV_SAMP, "stddev": Agg.STDDEV_SAMP,
    "var_samp": Agg.VAR_SAMP, "variance": Agg.VAR_SAMP,
}

_CMP = {"eq": Op.EQ, "ne": Op.NE, "lt": Op.LT, "le": Op.LE, "gt": Op.GT,
        "ge": Op.GE}
_ARITH = {"add": Op.ADD, "sub": Op.SUB, "mul": Op.MUL, "div": Op.DIV,
          "mod": Op.MOD}


@dataclasses.dataclass
class Catalog:
    schemas: dict[str, dtypes.Schema]
    primary_keys: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    dicts: DictionarySet | None = None
    # table -> estimated row count (statistics service feed,
    # obs/sysview.table_stats): drives CBO-lite join ordering — among
    # connectable candidates, smaller estimated sides join first
    row_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # table -> stats.cost.TableStats from the StatisticsAggregator:
    # per-column NDV / null fractions / value bounds. Fills row-count
    # gaps for join ordering and feeds downstream estimators.
    table_stats: dict = dataclasses.field(default_factory=dict)
    # registered scalar UDFs: name -> (vectorized fn, result LogicalType)
    udfs: dict[str, tuple] = dataclasses.field(default_factory=dict)


# PlanError now lives with the static-analysis diagnostics (the
# verifier raises VerificationError, a PlanError subclass, so the SQL
# surface reports one error family); re-exported here for compatibility.
from ydb_tpu_torch.analysis.diagnostics import PlanError  # noqa: E402,F401


@dataclasses.dataclass
class PlannedQuery:
    """A planned SELECT with its statically-derived output description."""

    plan: object
    out_names: tuple[str, ...]
    out_types: dict[str, dtypes.LogicalType]
    dict_aliases: dict[str, str]  # out column -> dictionary source column
    unique_key: tuple[str, ...] | None  # cols the output is unique on
    # True when an uncorrelated scalar subquery was executed eagerly and
    # its RESULT baked into the plan as a constant: such plans are bound
    # to the planning-time snapshot and must not be cached across writes
    used_scalar_exec: bool = False


# ---------------- helpers ----------------


def _conjuncts(e: ast.Expr | None) -> list[ast.Expr]:
    if e is None:
        return []
    if isinstance(e, ast.BinOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _days(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int32))


def _walk_names(e):
    if isinstance(e, ast.Name):
        yield e
    elif isinstance(e, ast.BinOp):
        yield from _walk_names(e.left)
        yield from _walk_names(e.right)
    elif isinstance(e, ast.UnOp):
        yield from _walk_names(e.operand)
    elif isinstance(e, ast.FuncCall):
        for a in e.args:
            yield from _walk_names(a)
    elif isinstance(e, ast.Between):
        yield from _walk_names(e.expr)
        yield from _walk_names(e.low)
        yield from _walk_names(e.high)
    elif isinstance(e, (ast.Like, ast.IsNull)):
        yield from _walk_names(e.expr)
    elif isinstance(e, ast.InList):
        yield from _walk_names(e.expr)
        for i in e.items:
            yield from _walk_names(i)
    elif isinstance(e, ast.Case):
        for c, v in e.whens:
            yield from _walk_names(c)
            yield from _walk_names(v)
        if e.else_ is not None:
            yield from _walk_names(e.else_)
    elif isinstance(e, ast.WindowCall):
        for p in e.partition:
            yield from _walk_names(p)
        for o in e.order:
            yield from _walk_names(o.expr)


def _contains_agg(e) -> bool:
    if isinstance(e, ast.FuncCall):
        if e.name in _AGG_FUNCS or (e.name == "count" and e.star):
            return True
        return any(_contains_agg(a) for a in e.args)
    if isinstance(e, ast.BinOp):
        return _contains_agg(e.left) or _contains_agg(e.right)
    if isinstance(e, ast.UnOp):
        return _contains_agg(e.operand)
    if isinstance(e, ast.Between):
        return any(_contains_agg(x) for x in (e.expr, e.low, e.high))
    if isinstance(e, (ast.Like, ast.IsNull)):
        return _contains_agg(e.expr)
    if isinstance(e, ast.InList):
        return _contains_agg(e.expr)
    if isinstance(e, ast.Case):
        return any(
            _contains_agg(c) or _contains_agg(v) for c, v in e.whens
        ) or (e.else_ is not None and _contains_agg(e.else_))
    return False


def _contains_window(e) -> bool:
    """A WindowCall anywhere in the expression tree (not descending into
    subqueries — those plan themselves and run their own check)."""
    if isinstance(e, ast.WindowCall):
        return True
    if isinstance(e, ast.BinOp):
        return _contains_window(e.left) or _contains_window(e.right)
    if isinstance(e, ast.UnOp):
        return _contains_window(e.operand)
    if isinstance(e, ast.FuncCall):
        return any(_contains_window(a) for a in e.args)
    if isinstance(e, ast.Between):
        return any(_contains_window(x) for x in (e.expr, e.low, e.high))
    if isinstance(e, (ast.Like, ast.IsNull)):
        return _contains_window(e.expr)
    if isinstance(e, ast.InList):
        return _contains_window(e.expr) or any(
            _contains_window(i) for i in e.items)
    if isinstance(e, ast.Case):
        return any(
            _contains_window(c) or _contains_window(v) for c, v in e.whens
        ) or (e.else_ is not None and _contains_window(e.else_))
    return False


def _reject_nested_windows(sel: ast.Select) -> None:
    """Window functions are supported only as whole top-level select
    items; anything else (rank() + 1, windows in WHERE/HAVING/GROUP
    BY/ORDER BY) must fail with a targeted message, not a late generic
    'cannot lower' (ADVICE round 5, planner has_window)."""
    for item in sel.items:
        if isinstance(item.expr, ast.Star) or isinstance(
                item.expr, ast.WindowCall):
            continue
        if _contains_window(item.expr):
            raise PlanError(
                "window functions are only allowed as top-level select"
                " items; compute rank() in a subquery and transform it"
                " in the outer SELECT")
    for clause, e in (("WHERE", sel.where), ("HAVING", sel.having)):
        if e is not None and _contains_window(e):
            raise PlanError(
                f"window functions are not allowed in {clause}; rank in"
                " a subquery and filter the outer SELECT")
    for e in sel.group_by:
        if _contains_window(e):
            raise PlanError(
                "window functions are not allowed in GROUP BY")
    for o in sel.order_by:
        if _contains_window(o.expr):
            raise PlanError(
                "window functions are not allowed in ORDER BY; ORDER BY"
                " the aliased select item instead")


def _contains_subquery(e) -> bool:
    if isinstance(e, (ast.ScalarSubquery, ast.InSubquery, ast.Exists)):
        return True
    if isinstance(e, ast.BinOp):
        return _contains_subquery(e.left) or _contains_subquery(e.right)
    if isinstance(e, ast.UnOp):
        return _contains_subquery(e.operand)
    if isinstance(e, ast.FuncCall):
        return any(_contains_subquery(a) for a in e.args)
    if isinstance(e, ast.Between):
        return any(_contains_subquery(x) for x in (e.expr, e.low, e.high))
    if isinstance(e, (ast.Like, ast.IsNull)):
        return _contains_subquery(e.expr)
    if isinstance(e, ast.InList):
        return _contains_subquery(e.expr)
    if isinstance(e, ast.Case):
        return any(
            _contains_subquery(c) or _contains_subquery(v)
            for c, v in e.whens
        ) or (e.else_ is not None and _contains_subquery(e.else_))
    return False


def _item_name(item: ast.SelectItem, idx: int) -> str:
    if item.alias:
        return item.alias
    if isinstance(item.expr, ast.Name):
        return item.expr.column
    return f"column{idx}"


def _try_const_date(e) -> int | None:
    """Fold date '...' ± interval '...' unit chains to an int day count
    at plan time (month/year intervals only exist inside such folds —
    days-since-epoch columns cannot shift by calendar units at runtime)."""
    if isinstance(e, ast.FuncCall) and e.name == "date":
        return _days(e.args[0].value)
    if isinstance(e, ast.BinOp) and e.op in ("add", "sub"):
        base = _try_const_date(e.left)
        if base is None:
            return None
        iv = e.right
        if not (isinstance(iv, ast.FuncCall) and iv.name == "interval"):
            return None
        n = int(iv.args[0].value)
        unit = iv.args[1].value
        if e.op == "sub":
            n = -n
        d = np.datetime64("1970-01-01", "D") + base
        if unit in ("day", "week"):
            out = d + n * (7 if unit == "week" else 1)
        elif unit == "month":
            m = d.astype("datetime64[M]")
            day_in_month = (d - m.astype("datetime64[D]")).astype(int)
            out = (m + n).astype("datetime64[D]") + int(day_in_month)
        elif unit == "year":
            y = d.astype("datetime64[Y]")
            day_in_year = (d - y.astype("datetime64[D]")).astype(int)
            out = (y + n).astype("datetime64[D]") + int(day_in_year)
        else:
            return None
        return int(out.astype("datetime64[D]").astype(np.int32))
    return None


def _strip_decimal_zeros(value: int, scale: int) -> tuple[int, int]:
    while scale > 0 and value % 10 == 0:
        value //= 10
        scale -= 1
    return value, scale


# ---------------- scopes & binding ----------------


@dataclasses.dataclass
class _Scope:
    """One FROM source: a base table or a planned derived query."""

    alias: str
    names: tuple[str, ...]
    types: dict[str, dtypes.LogicalType]
    dict_src: dict[str, str]       # col -> dictionary source column
    table: str | None = None       # base table name
    sub: PlannedQuery | None = None
    pk: tuple[str, ...] | None = None


@dataclasses.dataclass
class _Binding:
    scopes: list[_Scope]
    col_owner: dict[str, str]
    ambiguous: set[str]

    def scope(self, alias: str) -> _Scope:
        for s in self.scopes:
            if s.alias == alias:
                return s
        raise PlanError(f"unknown table alias {alias}")

    def resolve(self, name: ast.Name) -> tuple[str, str]:
        """-> (alias, column)"""
        if len(name.parts) == 2:
            alias, col = name.parts
            s = self.scope(alias)
            if col not in s.types:
                raise PlanError(f"no column {col} in {alias}")
            return alias, col
        col = name.parts[0]
        if col in self.ambiguous:
            raise PlanError(f"ambiguous column {col}")
        if col not in self.col_owner:
            raise PlanError(f"unknown column {col}")
        return self.col_owner[col], col

    def try_resolve(self, name: ast.Name):
        try:
            return self.resolve(name)
        except PlanError:
            return None


def _flatten_from(f: ast.FromItem):
    """-> ([TableRef|SubquerySource in order], [(right_idx, on, kind)])"""
    if isinstance(f, (ast.TableRef, ast.SubquerySource)):
        return [f], []
    tables, joins = _flatten_from(f.left)
    tables.append(f.right)
    joins.append((len(tables) - 1, f.on, f.kind))
    return tables, joins


# ---------------- expression lowering ----------------


class _Lower:
    """AST expr -> SSA expr against a named-column environment.

    ``resolve``  maps an ast.Name to the in-scope SSA column name.
    ``dict_src`` maps in-scope string columns to the column whose
                 dictionary carries their values (rename tracking).
    ``emit``     appends auxiliary AssignSteps (hidden columns for
                 string transforms like substring)."""

    def __init__(self, types: dict[str, dtypes.LogicalType],
                 dicts: DictionarySet | None,
                 dict_src: dict[str, str] | None = None,
                 resolve=None, emit=None, udfs=None):
        self.types = types
        self.dicts = dicts
        self.dict_src = dict_src if dict_src is not None else {}
        self._resolve = resolve
        self._emit = emit
        self.udfs = udfs or {}

    def name_of(self, e: ast.Name) -> str:
        if self._resolve is not None:
            return self._resolve(e)
        col = e.column
        if col not in self.types:
            raise PlanError(f"column {col} not in scope")
        return col

    def dictionary_of(self, col: str):
        src = self.dict_src.get(col, col)
        if self.dicts is not None and src in self.dicts:
            return self.dicts[src]
        return None

    def emit_assign(self, name: str, expr, t: dtypes.LogicalType):
        if self._emit is None:
            raise PlanError(
                "string transform needs an assignment context")
        self._emit(AssignStep(name, expr))
        self.types[name] = t

    def type_of(self, e) -> dtypes.LogicalType | None:
        try:
            return infer_type(e, None, self.types)
        except Exception:
            return None

    # -- string-column helpers --

    # FuncCalls producing a (dictionary-encoded) string column
    _STRING_FUNCS = frozenset({
        "substring", "upper", "lower", "trim", "ltrim", "rtrim",
        "replace", "concat", "gethost", "cutwww",
    })

    def _as_string_col(self, e, what: str) -> str:
        """Column name of a string-valued operand; lowers string
        transforms (substring/upper/...) to hidden DictMap columns on
        the fly."""
        if isinstance(e, ast.Name):
            col = self.name_of(e)
            if not self.types.get(col, dtypes.INT64).is_string:
                raise PlanError(f"{what} needs a string column operand")
            return col
        if isinstance(e, ast.FuncCall) and e.name in self._STRING_FUNCS:
            lowered = self.lower(e)  # DictMap assign via emit
            assert isinstance(lowered, Col)
            return lowered.name
        raise PlanError(f"{what} needs a string column operand")

    def _is_string_operand(self, e) -> bool:
        if isinstance(e, ast.Name):
            try:
                col = self.name_of(e)
            except PlanError:
                return False
            return self.types.get(col, dtypes.INT64).is_string
        return isinstance(e, ast.FuncCall) and \
            e.name in self._STRING_FUNCS

    def _dict_map(self, col: str, kind: str, args: tuple,
                  out_type=dtypes.STRING) -> Col:
        """Hidden column holding a plan-time dictionary transform of
        ``col`` (substr/upper/replace/strlen/... — every string op is
        an id-indexed table built once over the dictionary)."""
        if args:
            # collision-free tag: short args stay readable, anything
            # long/exotic goes through a stable digest
            import hashlib

            rep = repr(args)
            tag = (rep if len(rep) <= 32 else
                   hashlib.blake2b(rep.encode(),
                                   digest_size=6).hexdigest())
            tag = "".join(c if c.isalnum() else "_" for c in tag)
            hidden = f"__{kind}_{col}_{tag}"
        else:
            hidden = f"__{kind}_{col}"
        if hidden not in self.types:
            self.emit_assign(
                hidden, DictMap(col, kind, args, hidden), out_type)
            if out_type.is_string:
                # the output dictionary populates at compile time;
                # register it now so downstream plan steps (xrank
                # comparisons, nested transforms) see it exists
                self.dict_src[hidden] = hidden
                if self.dicts is not None:
                    self.dicts.for_column(hidden)
        return Col(hidden)

    def _xrank(self, e, peer) -> Col:
        """Hidden int column: e's dictionary ids translated to ranks in
        the union of e's and peer's dictionaries (see "xrank" in
        ssa/compiler.dict_map_table)."""
        col = self._as_string_col(e, "string comparison")
        peer_col = self._as_string_col(peer, "string comparison")
        p_src = self.dict_src.get(peer_col, peer_col)
        if self.dictionary_of(col) is None \
                or self.dictionary_of(peer_col) is None:
            raise PlanError(
                "string column comparison needs dictionaries")
        # keyed on the operand COLUMNS (not dictionary sources): a
        # self-join compares two columns that share one dictionary
        hidden = f"__xrank_{col}_{peer_col}"
        if hidden not in self.types:
            self.emit_assign(
                hidden, DictMap(col, "xrank", (), p_src), dtypes.INT32)
        return Col(hidden)

    def _string_case(self, e: ast.Case) -> Col:
        """CASE whose branches are string columns / string literals:
        lowers to an IF over dictionary ids in ONE shared dictionary
        (all column branches must share a dictionary source; literal
        branches encode into it), emitted as a hidden string column so
        downstream group-bys/projections see a normal dict-encoded
        column (ClickBench q39's IF(..., Referer, '') AS Src shape)."""
        import hashlib

        branches = [v for _c, v in e.whens]
        if e.else_ is not None:
            branches.append(e.else_)
        src = None
        for b in branches:
            if self._is_string_operand(b):
                col = self._as_string_col(b, "CASE")
                s = self.dict_src.get(col, col)
                if src is None:
                    src = s
                elif s != src:
                    raise PlanError(
                        f"string CASE branches must share one dictionary"
                        f" ({src} vs {s})")
        if src is None:
            raise PlanError(
                "string CASE needs at least one string column branch")
        d = self.dicts[src] if (self.dicts is not None
                                and src in self.dicts) else None
        if d is None:
            raise PlanError(f"string CASE needs a dictionary for {src}")

        def enc(b):
            if isinstance(b, ast.Literal) and b.kind == "string":
                val = b.value.encode() if isinstance(b.value, str) \
                    else b.value
                return Const(int(d.add(val)), dtypes.STRING)
            return Col(self._as_string_col(b, "CASE"))

        out = enc(e.else_) if e.else_ is not None \
            else Const(None, dtypes.STRING)
        for cond, val in reversed(e.whens):
            out = Call(Op.IF, self.lower(cond), enc(val), out)
        tag = hashlib.blake2b(repr(e).encode(),
                              digest_size=6).hexdigest()
        hidden = f"__strcase_{tag}"
        if hidden not in self.types:
            self.emit_assign(hidden, out, dtypes.STRING)
            self.dict_src[hidden] = src
        return Col(hidden)

    def lower(self, e: ast.Expr):
        if isinstance(e, ast.Name):
            return Col(self.name_of(e))
        if isinstance(e, ast.Literal):
            return self._literal(e)
        if isinstance(e, ast.UnOp):
            if e.op == "not":
                return Call(Op.NOT, self.lower(e.operand))
            if e.op == "neg":
                return Call(Op.NEG, self.lower(e.operand))
            raise PlanError(f"unary {e.op}")
        if isinstance(e, ast.BinOp):
            return self._binop(e)
        if isinstance(e, ast.Between):
            lo = ast.BinOp("ge", e.expr, e.low)
            hi = ast.BinOp("le", e.expr, e.high)
            both = Call(Op.AND, self._binop(lo), self._binop(hi))
            return Call(Op.NOT, both) if e.negated else both
        if isinstance(e, ast.InList):
            return self._in_list(e)
        if isinstance(e, ast.Like):
            col = self._as_string_col(e.expr, "LIKE")
            p = DictPredicate(col, "like", e.pattern)
            return Call(Op.NOT, p) if e.negated else p
        if isinstance(e, ast.IsNull):
            inner = self.lower(e.expr)
            return Call(Op.IS_NOT_NULL if e.negated else Op.IS_NULL, inner)
        if isinstance(e, ast.Case):
            branches = [v for _c, v in e.whens]
            if e.else_ is not None:
                branches.append(e.else_)
            if any(self._is_string_operand(b)
                   or (isinstance(b, ast.Literal) and b.kind == "string")
                   for b in branches):
                return self._string_case(e)
            if e.else_ is None:
                first = self.lower(e.whens[0][1])
                t = infer_type(first, None, self.types)
                out = Const(None, t)  # CASE without ELSE -> typed NULL
            else:
                out = self.lower(e.else_)
            for cond, val in reversed(e.whens):
                out = Call(Op.IF, self.lower(cond), self.lower(val), out)
            return out
        if isinstance(e, ast.FuncCall):
            return self._func(e)
        if isinstance(e, (ast.ScalarSubquery, ast.InSubquery, ast.Exists)):
            raise PlanError(
                "subquery in an unsupported position (must be a WHERE/"
                "HAVING conjunct or a comparison operand)")
        raise PlanError(f"cannot lower {e}")

    def _literal(self, e: ast.Literal):
        if e.kind == "int":
            return Const(e.value, dtypes.INT64)
        if e.kind == "typed":  # planner-internal: pre-typed constant
            value, t = e.value
            return Const(value, t)
        if e.kind == "decimal":
            from ydb_tpu_torch.ssa.program import decimal_lit

            scale = len(e.value.split(".")[1]) if "." in e.value else 0
            return decimal_lit(e.value, scale)
        if e.kind == "bool":
            return Const(e.value, dtypes.BOOL)
        if e.kind == "string":
            raise PlanError(
                f"string literal {e.value!r} outside a string comparison"
            )
        raise PlanError(f"literal {e.kind}")

    def _binop(self, e: ast.BinOp):
        if e.op in ("and", "or"):
            return Call(Op.AND if e.op == "and" else Op.OR,
                        self.lower(e.left), self.lower(e.right))
        if e.op in _CMP:
            # string column vs string literal -> dictionary predicate
            lit_side = col_side = None
            if isinstance(e.right, ast.Literal) and e.right.kind == "string":
                col_side, lit_side, op = e.left, e.right, e.op
            elif isinstance(e.left, ast.Literal) and e.left.kind == "string":
                col_side, lit_side = e.right, e.left
                op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(
                    e.op, e.op)
            if lit_side is not None:
                col = self._as_string_col(col_side, "string comparison")
                if op == "eq":
                    return DictPredicate(col, "eq", lit_side.value)
                if op == "ne":
                    return DictPredicate(col, "ne", lit_side.value)
                # ordered string compare: lowered by the compiler via a
                # plan-time dictionary mask (_custom_dict_mask)
                if self.dictionary_of(col) is None:
                    raise PlanError(
                        f"ordered string compare on {col} needs dictionary")
                val = lit_side.value.encode() if isinstance(
                    lit_side.value, str) else lit_side.value
                return DictPredicate(col, "custom", ("ord", op, val))
            # string column vs string column: translate both sides into
            # the rank space of their dictionaries' union (plan-time
            # "xrank" DictMap), then integer-compare — correct across
            # different per-column dictionaries (TPC-DS q19 zip compare)
            if self._is_string_operand(e.left) \
                    and self._is_string_operand(e.right):
                return Call(_CMP[e.op],
                            self._xrank(e.left, e.right),
                            self._xrank(e.right, e.left))
            return Call(_CMP[e.op], self.lower(e.left), self.lower(e.right))
        if e.op in _ARITH:
            folded = _try_const_date(e)
            if folded is not None:
                return Const(folded, dtypes.DATE)
            return Call(_ARITH[e.op], self.lower(e.left),
                        self.lower(e.right))
        raise PlanError(f"binop {e.op}")

    def _in_list(self, e: ast.InList):
        if all(isinstance(i, ast.Literal) and i.kind == "string"
               for i in e.items):
            col = self._as_string_col(e.expr, "IN")
            kind = "not_in_set" if e.negated else "in_set"
            return DictPredicate(col, kind,
                                 tuple(i.value for i in e.items))
        inner = self.lower(e.expr)
        consts = []
        for i in e.items:
            c = self.lower(i)
            if isinstance(c, Call) and c.op is Op.NEG and \
                    isinstance(c.args[0], Const):
                # fold negated literals: IN (-1, 6)
                c = Const(-c.args[0].value, c.args[0].type)
            if not isinstance(c, Const):
                raise PlanError("IN items must be literals")
            consts.append(c)
        call = Call(Op.IN_SET, inner, *consts)
        return Call(Op.NOT, call) if e.negated else call

    def _func(self, e: ast.FuncCall):
        if e.name in _AGG_FUNCS or (e.name == "count" and e.star):
            raise PlanError(f"aggregate {e.name} in scalar context")
        if e.name == "date":
            return Const(_days(e.args[0].value), dtypes.DATE)
        if e.name == "interval":
            n = int(e.args[0].value)
            unit = e.args[1].value
            days = {"day": 1, "week": 7}.get(unit)
            if days is None:
                raise PlanError(
                    f"interval unit {unit} only folds against constant"
                    " dates")
            return Const(n * days, dtypes.INT32)
        if e.name in ("year", "month", "day", "hour", "minute",
                      "second", "dayofweek", "dayofyear", "week",
                      "quarter"):
            op = {"year": Op.YEAR, "month": Op.MONTH, "day": Op.DAY,
                  "hour": Op.HOUR, "minute": Op.MINUTE,
                  "second": Op.SECOND, "dayofweek": Op.DAY_OF_WEEK,
                  "dayofyear": Op.DAY_OF_YEAR, "week": Op.WEEK,
                  "quarter": Op.QUARTER}[e.name]
            return Call(op, self.lower(e.args[0]))
        if e.name in ("greatest", "least"):
            if any(self._is_string_operand(a) for a in e.args):
                # dictionary ids carry no order; a string greatest
                # would need a union-dict gather-back, not an int max
                raise PlanError(
                    f"{e.name} on string columns is not supported")
            op = Op.GREATEST if e.name == "greatest" else Op.LEAST
            out = self.lower(e.args[0])
            for arg in e.args[1:]:  # n-ary folds into binary chains
                out = Call(op, out, self.lower(arg))
            return out
        if e.name == "substring":
            col = self._as_string_col(e.args[0], "substring")
            if not (isinstance(e.args[1], ast.Literal)
                    and isinstance(e.args[2], ast.Literal)):
                raise PlanError("substring bounds must be literals")
            start, length = int(e.args[1].value), int(e.args[2].value)
            return self._dict_map(col, "substr", (start, length))
        if e.name in ("upper", "lower", "trim", "ltrim", "rtrim",
                      "gethost", "cutwww"):
            col = self._as_string_col(e.args[0], e.name)
            return self._dict_map(col, e.name, ())
        if e.name == "replace":
            col = self._as_string_col(e.args[0], "replace")
            old, new = e.args[1], e.args[2]
            if not (isinstance(old, ast.Literal)
                    and isinstance(new, ast.Literal)):
                raise PlanError("replace patterns must be literals")
            return self._dict_map(
                col, "replace",
                (_as_b(old.value), _as_b(new.value)))
        if e.name == "concat":
            # string column ++ literal (either order): a plan-time
            # dictionary transform, like every string op here
            a, b = e.args[0], e.args[1]
            if isinstance(b, ast.Literal) and b.kind == "string":
                col = self._as_string_col(a, "concat")
                return self._dict_map(col, "concat_suffix",
                                      (_as_b(b.value),))
            if isinstance(a, ast.Literal) and a.kind == "string":
                col = self._as_string_col(b, "concat")
                return self._dict_map(col, "concat_prefix",
                                      (_as_b(a.value),))
            raise PlanError("concat needs one string literal operand")
        if e.name in ("length", "strlen"):  # byte length (String type)
            col = self._as_string_col(e.args[0], "length")
            hidden = self._dict_map(col, "strlen", (),
                                    out_type=dtypes.INT32)
            return hidden
        if e.name in ("starts_with", "ends_with"):
            col = self._as_string_col(e.args[0], e.name)
            lit = e.args[1]
            if not (isinstance(lit, ast.Literal)
                    and lit.kind == "string"):
                raise PlanError(f"{e.name} needs a string literal")
            if e.name == "starts_with":
                return DictPredicate(col, "prefix", lit.value)
            return DictPredicate(col, "custom",
                                 ("suffix", _as_b(lit.value)))
        if e.name.startswith("cast_"):
            target = e.name[5:]
            op = {"int32": Op.CAST_INT32, "int64": Op.CAST_INT64,
                  "bigint": Op.CAST_INT64, "float": Op.CAST_FLOAT,
                  "double": Op.CAST_DOUBLE, "int8": Op.CAST_INT8,
                  "int16": Op.CAST_INT16, "uint64": Op.CAST_UINT64,
                  "bool": Op.CAST_BOOL}.get(target)
            if op is None:
                raise PlanError(f"cast to {target}")
            return Call(op, self.lower(e.args[0]))
        simple = {"abs": Op.ABS, "sqrt": Op.SQRT, "exp": Op.EXP,
                  "ln": Op.LN, "log10": Op.LOG10, "floor": Op.FLOOR,
                  "ceil": Op.CEIL, "round": Op.ROUND,
                  "sign": Op.SIGN, "power": Op.POW, "pow": Op.POW,
                  "coalesce": Op.COALESCE, "sin": Op.SIN,
                  "cos": Op.COS, "tan": Op.TAN, "asin": Op.ASIN,
                  "acos": Op.ACOS, "atan": Op.ATAN, "sinh": Op.SINH,
                  "cosh": Op.COSH, "tanh": Op.TANH,
                  "asinh": Op.ASINH, "acosh": Op.ACOSH,
                  "atanh": Op.ATANH, "atan2": Op.ATAN2,
                  "hypot": Op.HYPOT, "cbrt": Op.CBRT, "erf": Op.ERF,
                  "log2": Op.LOG2, "exp2": Op.EXP2,
                  "trunc": Op.TRUNC, "rint": Op.RINT,
                  "radians": Op.RADIANS,
                  "degrees": Op.DEGREES, "nullif": Op.NULLIF,
                  "bit_and": Op.BIT_AND, "bit_or": Op.BIT_OR,
                  "bit_xor": Op.BIT_XOR, "bit_not": Op.BIT_NOT,
                  "shift_left": Op.SHIFT_LEFT,
                  "shift_right": Op.SHIFT_RIGHT,
                  "div": Op.DIV_INT}
        if e.name in simple:
            if e.name == "nullif" and any(
                    self._is_string_operand(a) for a in e.args):
                # dictionary ids from unrelated dictionaries carry no
                # cross-column equality (same reason greatest refuses)
                raise PlanError("nullif on string columns is not"
                                " supported")
            return Call(simple[e.name], *[self.lower(a) for a in e.args])
        if e.name in self.udfs:
            from ydb_tpu_torch.ssa.program import UdfCall

            fn, out_type = self.udfs[e.name]
            if not e.args:
                raise PlanError(
                    f"UDF {e.name} needs at least one argument")
            if out_type.is_string:
                raise PlanError(
                    "UDFs cannot return strings (dictionary ids are"
                    " plan-time state)")
            lowered = tuple(self.lower(a) for a in e.args)
            for a in lowered:
                t = infer_type(a, None, self.types)
                if t.is_string:
                    raise PlanError(
                        f"UDF {e.name}: string-column arguments are not"
                        " supported (the UDF would see dictionary ids)")
            return UdfCall(e.name, lowered, out_type, fn)
        raise PlanError(f"unknown function {e.name}")


# ---------------- the planner ----------------


def plan_select(sel: ast.Select, catalog: Catalog, scalar_exec=None):
    """Plan a SELECT; returns the plan tree (back-compat surface)."""
    return plan_select_full(sel, catalog, scalar_exec).plan


def plan_select_full(
    sel: ast.Select,
    catalog: Catalog,
    scalar_exec=None,
    ctes: dict[str, PlannedQuery] | None = None,
) -> PlannedQuery:
    """Plan a SELECT fully: plan tree + output names/types/dict-aliases.

    ``scalar_exec(plan_node, out_type) -> (value, valid)`` executes an
    uncorrelated scalar subquery eagerly (the KQP precompute-phase
    analog); without it such subqueries raise PlanError.
    """
    planner = _SelectPlanner(catalog, scalar_exec, dict(ctes or {}))
    if isinstance(sel, ast.UnionAll):
        return planner.plan_union(sel)
    return planner.plan(sel)


class _SelectPlanner:
    def __init__(self, catalog: Catalog, scalar_exec, ctes):
        self.catalog = catalog
        self.scalar_exec = scalar_exec
        self.ctes: dict[str, PlannedQuery] = ctes
        self._sq_n = 0
        self.used_scalar_exec = False

    # -- recursion helper --

    def _sub(self, sel: "ast.Select | ast.UnionAll") -> PlannedQuery:
        child = _SelectPlanner(
            self.catalog, self.scalar_exec, dict(self.ctes))
        sub = (child.plan_union(sel) if isinstance(sel, ast.UnionAll)
               else child.plan(sel))
        self.used_scalar_exec |= sub.used_scalar_exec
        return sub

    # -- FROM binding --

    def _bind(self, sel: ast.Select) -> tuple[_Binding, list]:
        if sel.from_ is None:
            raise PlanError("SELECT without FROM is not supported")
        refs, join_specs = _flatten_from(sel.from_)
        scopes: list[_Scope] = []
        for r in refs:
            if isinstance(r, ast.SubquerySource):
                sub = self._sub(r.select)
                scopes.append(_Scope(
                    alias=r.alias, names=sub.out_names,
                    types=dict(sub.out_types),
                    dict_src=dict(sub.dict_aliases),
                    sub=sub, pk=sub.unique_key,
                ))
                continue
            name, alias = r.name, (r.alias or r.name)
            if name in self.ctes:
                sub = self.ctes[name]
                scopes.append(_Scope(
                    alias=alias, names=sub.out_names,
                    types=dict(sub.out_types),
                    dict_src=dict(sub.dict_aliases),
                    sub=sub, pk=sub.unique_key,
                ))
                continue
            if name not in self.catalog.schemas:
                raise PlanError(f"unknown table {name}")
            sch = self.catalog.schemas[name]
            scopes.append(_Scope(
                alias=alias, names=sch.names,
                types={f.name: f.type for f in sch.fields},
                dict_src={f.name: f.name for f in sch.fields
                          if f.type.is_string},
                table=name, pk=self.catalog.primary_keys.get(name),
            ))
        seen: dict[str, str] = {}
        ambiguous: set[str] = set()
        for s in scopes:
            for n in s.names:
                if n in seen and seen[n] != s.alias:
                    ambiguous.add(n)
                else:
                    seen[n] = s.alias
        return _Binding(scopes, seen, ambiguous), join_specs

    # -- subquery rewrites --

    def _correlations(self, sub: ast.Select, outer: _Binding,
                      allow_ne: bool = False):
        """Split inner WHERE into correlated pairs and local conjuncts.

        Correlated conjunct shape: outer_col = inner_col (either order);
        with ``allow_ne``, outer_col <> inner_col is also collected (the
        q21 shape, decorrelated via the counting rewrite).
        Returns ([(outer Name, inner col)] eq pairs,
                 [(outer Name, inner col)] ne pairs,
                 local_where_conjuncts).
        """
        inner_binding, _ = self._bind(sub)
        corr: list[tuple[ast.Name, str]] = []
        ne_corr: list[tuple[ast.Name, str]] = []
        local: list[ast.Expr] = []
        for c in _conjuncts(sub.where):
            names = list(_walk_names(c))
            outer_names = [
                n for n in names
                if inner_binding.try_resolve(n) is None
                and outer.try_resolve(n) is not None
            ]
            if not outer_names:
                local.append(c)
                continue
            ops = ("eq", "ne") if allow_ne else ("eq",)
            if not (isinstance(c, ast.BinOp) and c.op in ops
                    and isinstance(c.left, ast.Name)
                    and isinstance(c.right, ast.Name)):
                raise PlanError(
                    "correlated subquery conditions must be equality"
                    f" (got {c})")
            left_outer = inner_binding.try_resolve(c.left) is None
            o, i = (c.left, c.right) if left_outer else (c.right, c.left)
            if inner_binding.try_resolve(i) is None:
                raise PlanError(
                    "correlated condition does not reference the"
                    " subquery's tables")
            (corr if c.op == "eq" else ne_corr).append((o, i.column))
        return corr, ne_corr, local

    @staticmethod
    def _check_plain_exists(sub: ast.Select) -> None:
        """The EXISTS rewrites rebuild the inner SELECT from its FROM and
        WHERE only; refuse shapes whose dropped clauses would change the
        result instead of silently mis-evaluating them."""
        if sub.group_by or sub.having is not None or sub.limit is not None:
            raise PlanError(
                "EXISTS subqueries with GROUP BY/HAVING/LIMIT are not"
                " supported")

    def _plan_exists_like(self, sub: ast.Select, corr, local):
        """Plan an EXISTS/IN subquery body projecting its correlation
        columns. ``corr``/``local`` come from the caller's
        ``_correlations`` pass (binding the inner FROM is not repeated)."""
        self._check_plain_exists(sub)
        where = None
        for c in local:
            where = c if where is None else ast.BinOp("and", where, c)
        items = tuple(
            ast.SelectItem(ast.Name((col,)), None)
            for col in dict.fromkeys(c for _, c in corr)
        )
        rewritten = ast.Select(
            items=items, from_=sub.from_, where=where, group_by=(),
            having=None, order_by=(), limit=None, ctes=sub.ctes,
        )
        return self._sub(rewritten)

    def _rewrite_or_exists(self, c, binding, scalar_joins, synthetic,
                           new_sq_name):
        """EXISTS leaves inside an OR disjunction -> COUNT scalar joins
        compared against zero. Returns the rebuilt OR expression, or
        None when the shape doesn't qualify (some leaf is an
        unsupported subquery form — the caller then reports the usual
        unsupported-position error)."""
        leaves: list = []

        def collect(e):
            if isinstance(e, ast.BinOp) and e.op == "or":
                return collect(e.left) and collect(e.right)
            negated = False
            while isinstance(e, ast.UnOp) and e.op == "not" \
                    and isinstance(e.operand, ast.Exists):
                negated = not negated
                e = e.operand
            if isinstance(e, ast.Exists):
                leaves.append(("exists", negated != e.negated, e))
                return True
            if _contains_subquery(e):
                return False  # nested non-EXISTS subquery in the OR
            leaves.append(("plain", False, e))
            return True

        if not collect(c) or not any(
                k == "exists" for k, _n, _e in leaves):
            return None
        parts: list = []
        for kind, negated, e in leaves:
            if kind == "plain":
                parts.append(e)
                continue
            try:
                eq, ne_pairs, local = self._correlations(
                    e.select, binding)
            except PlanError:
                return None  # non-equality correlation: fall through
            if not eq or ne_pairs:
                return None
            name = new_sq_name()
            sub = self._plan_count_sub(
                e.select, local, [i for _, i in eq], name)
            scalar_joins.append((name, eq, sub))
            synthetic[name] = dtypes.INT64
            cnt = ast.FuncCall(
                "coalesce", (ast.Name((name,)), ast.Literal(0, "int")))
            parts.append(ast.BinOp("eq" if negated else "gt", cnt,
                                   ast.Literal(0, "int")))
        out = parts[0]
        for p in parts[1:]:
            out = ast.BinOp("or", out, p)
        return out

    def _plan_count_sub(self, sub: ast.Select, local, group_cols,
                        name: str) -> PlannedQuery:
        """COUNT(*) of the subquery's rows grouped by correlation columns
        (the counting decorrelation of non-equi EXISTS, q21)."""
        self._check_plain_exists(sub)
        where = None
        for c in local:
            where = c if where is None else ast.BinOp("and", where, c)
        cols = tuple(dict.fromkeys(group_cols))
        items = (
            ast.SelectItem(ast.FuncCall("count", (), star=True), name),
        ) + tuple(ast.SelectItem(ast.Name((c,)), None) for c in cols)
        rewritten = ast.Select(
            items=items, from_=sub.from_, where=where,
            group_by=tuple(ast.Name((c,)) for c in cols),
            having=None, order_by=(), limit=None, ctes=sub.ctes,
        )
        return self._sub(rewritten)

    # ---------------- main planning ----------------

    def plan_union(self, u: ast.UnionAll) -> PlannedQuery:
        """UNION [ALL] chain -> Concat node (+ dedup / sort / limit).

        Branch outputs align by POSITION to the first branch's names;
        each later branch gets a rename Transform when its names differ.
        Logical types must match exactly per position, and string
        columns must share one dictionary source across branches (the
        concatenated codes decode through a single dictionary)."""
        # a statement-level WITH parses into the FIRST branch; its CTEs
        # scope over every branch. A later branch's own WITH (non-
        # standard but parseable) stays local to that branch: _sub plans
        # it in a child planner whose cte dict is a copy, so it shadows
        # without leaking into sibling branches.
        for name, csub in u.selects[0].ctes:
            self.ctes[name] = self._sub(csub)
        subs = [self._sub(
            dataclasses.replace(b, ctes=()) if i == 0 else b)
            for i, b in enumerate(u.selects)]
        first = subs[0]
        names = first.out_names
        out_types = dict(first.out_types)
        dict_aliases = dict(first.dict_aliases)
        inputs: list = []
        for bi, sub in enumerate(subs):
            if len(sub.out_names) != len(names):
                raise PlanError(
                    f"UNION branch {bi + 1} yields "
                    f"{len(sub.out_names)} columns, expected "
                    f"{len(names)}")
            renames: list[tuple[str, str]] = []
            aliases: dict[str, str] = {}
            for src, dst in zip(sub.out_names, names):
                t_src, t_dst = sub.out_types[src], out_types[dst]
                if t_src != t_dst:
                    raise PlanError(
                        f"UNION branch {bi + 1} column {src}: type "
                        f"{t_src} does not match {dst}: {t_dst}")
                d_src = sub.dict_aliases.get(src, src)
                if t_dst.is_string:
                    d_dst = dict_aliases.get(dst, dst)
                    if bi == 0:
                        dict_aliases[dst] = d_src
                    elif d_src != d_dst:
                        raise PlanError(
                            f"UNION branches disagree on the "
                            f"dictionary for {dst}: {d_src} vs {d_dst}")
                if src != dst:
                    renames.append((src, dst))
                    if t_dst.is_string:
                        aliases[dst] = d_src
                if t_src.is_string and d_src != src:
                    aliases[src] = d_src
            if renames:
                # two-phase rename through fresh temp names: a direct
                # Assign(dst, Col(src)) sequence corrupts permuted
                # column lists (Assign a=b overwrites a before
                # Assign b=a reads it — assignments share one env)
                steps: list = []
                for t, (src, _dst) in enumerate(renames):
                    steps.append(AssignStep(f"__union_{t}", Col(src)))
                for t, (_src, dst) in enumerate(renames):
                    steps.append(AssignStep(dst, Col(f"__union_{t}")))
                steps.append(ProjectStep(names))
                inputs.append(Transform(
                    sub.plan, Program(tuple(steps)),
                    tuple(sorted(aliases.items()))))
            else:
                inputs.append(sub.plan)
        plan: object = Concat(tuple(inputs))

        post: list = []
        if u.distinct:
            post.append(GroupByStep(names, ()))
        if u.order_by:
            keys, desc = [], []
            for o in u.order_by:
                if not (isinstance(o.expr, ast.Name)
                        and o.expr.parts[-1] in names):
                    raise PlanError(
                        "UNION ORDER BY must reference output columns")
                keys.append(o.expr.parts[-1])
                desc.append(o.descending)
            post.append(SortStep(tuple(keys), tuple(desc), u.limit))
        elif u.limit is not None:
            post.append(SortStep((), (), u.limit))
        if post:
            aliases = tuple(sorted(
                (k, v) for k, v in dict_aliases.items() if k != v))
            plan = Transform(plan, Program(tuple(post)), aliases)
        return PlannedQuery(
            plan=plan,
            out_names=names,
            out_types=out_types,
            dict_aliases=dict_aliases,
            unique_key=names if u.distinct else None,
            used_scalar_exec=self.used_scalar_exec,
        )

    def plan(self, sel: ast.Select) -> PlannedQuery:
        # every SELECT — top-level, CTE, derived table, union branch —
        # funnels through here, so nested windows fail with the
        # targeted message wherever they hide
        _reject_nested_windows(sel)
        for name, sub in sel.ctes:
            self.ctes[name] = self._sub(sub)

        mixed = _rewrite_mixed_distinct(sel, self)
        if mixed is not None:
            sel = mixed

        binding, join_specs = self._bind(sel)
        scopes = binding.scopes

        # SELECT * expands to every in-scope column in FROM order
        # (ClickBench q23 shape); duplicate names across scopes surface
        # as the usual ambiguity errors downstream
        if any(isinstance(it.expr, ast.Star) for it in sel.items):
            items = []
            for it in sel.items:
                if not isinstance(it.expr, ast.Star):
                    items.append(it)
                    continue
                for s in scopes:
                    for col in s.names:
                        items.append(
                            ast.SelectItem(ast.Name((s.alias, col)), col))
            sel = dataclasses.replace(sel, items=tuple(items))

        # right sides of LEFT JOINs: WHERE on them filters AFTER the join
        left_right_aliases = {
            scopes[idx].alias for idx, _, kind in join_specs
            if kind == "left"
        }

        # --- subquery rewrites over WHERE conjuncts + HAVING ---
        semi_joins: list = []    # (kind, [(outer Name, build col)], sub)
        scalar_joins: list = []  # (name, [(outer Name, build col)], sub)
        synthetic: dict[str, dtypes.LogicalType] = {}
        syn_dict_src: dict[str, str] = {}

        def new_sq_name() -> str:
            self._sq_n += 1
            return f"__sq{self._sq_n - 1}"

        def rewrite_scalars(e):
            """Replace ScalarSubquery nodes inside an expression."""
            if isinstance(e, ast.ScalarSubquery):
                return self._rewrite_scalar(
                    e.select, binding, scalar_joins, synthetic,
                    syn_dict_src, new_sq_name)
            if isinstance(e, ast.BinOp):
                return ast.BinOp(e.op, rewrite_scalars(e.left),
                                 rewrite_scalars(e.right))
            if isinstance(e, ast.UnOp):
                return ast.UnOp(e.op, rewrite_scalars(e.operand))
            if isinstance(e, ast.FuncCall):
                return ast.FuncCall(
                    e.name, tuple(rewrite_scalars(a) for a in e.args),
                    e.star, e.distinct)
            if isinstance(e, ast.Between):
                return ast.Between(
                    rewrite_scalars(e.expr), rewrite_scalars(e.low),
                    rewrite_scalars(e.high), e.negated)
            if isinstance(e, ast.Case):
                return ast.Case(
                    tuple((rewrite_scalars(c), rewrite_scalars(v))
                          for c, v in e.whens),
                    rewrite_scalars(e.else_)
                    if e.else_ is not None else None)
            return e

        where_conjuncts: list[ast.Expr] = []
        for c in _conjuncts(sel.where):
            neg = False
            while isinstance(c, ast.UnOp) and c.op == "not" and isinstance(
                    c.operand, (ast.Exists, ast.InSubquery)):
                neg = not neg
                c = c.operand
            if isinstance(c, ast.Exists):
                negated = neg != c.negated
                eq, ne_pairs, local = self._correlations(
                    c.select, binding, allow_ne=True)
                if not eq:
                    raise PlanError(
                        "uncorrelated EXISTS is not supported (constant)")
                if ne_pairs:
                    # counting decorrelation (q21):
                    #   EXISTS(k = o.k AND j <> o.j AND f)
                    #   <=> cnt_f(k) > cnt_f(k, j=o.j)
                    name_a, name_b = new_sq_name(), new_sq_name()
                    sub_a = self._plan_count_sub(
                        c.select, local, [i for _, i in eq], name_a)
                    sub_b = self._plan_count_sub(
                        c.select, local,
                        [i for _, i in eq] + [i for _, i in ne_pairs],
                        name_b)
                    scalar_joins.append((name_a, eq, sub_a))
                    scalar_joins.append((name_b, eq + ne_pairs, sub_b))
                    synthetic[name_a] = dtypes.INT64
                    synthetic[name_b] = dtypes.INT64
                    zero = ast.Literal(0, "int")
                    ca = ast.FuncCall(
                        "coalesce", (ast.Name((name_a,)), zero))
                    cb = ast.FuncCall(
                        "coalesce", (ast.Name((name_b,)), zero))
                    where_conjuncts.append(
                        ast.BinOp("eq" if negated else "gt", ca, cb))
                    continue
                sub = self._plan_exists_like(c.select, eq, local)
                semi_joins.append(
                    ("anti" if negated else "semi", eq, sub))
                continue
            if isinstance(c, ast.InSubquery):
                negated = neg != c.negated
                if not isinstance(c.expr, ast.Name):
                    raise PlanError("IN (subquery) needs a column operand")
                sub_sel = c.select
                if len(sub_sel.items) != 1 or isinstance(
                        sub_sel.items[0].expr, ast.Star):
                    raise PlanError(
                        "IN subquery must select exactly one column")
                sub = self._plan_in_subquery(sub_sel, binding)
                build_col = sub.out_names[0]
                semi_joins.append((
                    "anti" if negated else "semi",
                    [(c.expr, build_col)], sub,
                ))
                continue
            if not neg and isinstance(c, ast.BinOp) and c.op == "or" \
                    and _contains_subquery(c):
                # EXISTS(A) OR EXISTS(B) (the q10/q35 shape): each
                # EXISTS leaf decorrelates to a per-key COUNT scalar
                # join (the q21 counting machinery), and the OR
                # rebuilds over count>0 / count==0 markers
                rewritten = self._rewrite_or_exists(
                    c, binding, scalar_joins, synthetic, new_sq_name)
                if rewritten is not None:
                    where_conjuncts.append(rewritten)
                    continue
            if neg:
                c = ast.UnOp("not", c)
            if _contains_subquery(c):
                c = rewrite_scalars(c)
            where_conjuncts.append(c)

        having = sel.having
        if having is not None and _contains_subquery(having):
            having = rewrite_scalars(having)

        # scalar subqueries may appear in SELECT items too (the
        # mixed-COUNT(DISTINCT) rewrite produces them); their synthetic
        # result columns are functions of the correlation keys, so under
        # aggregation they ride along as extra GROUP BY keys
        if any(_contains_subquery(i.expr) for i in sel.items
               if not isinstance(i.expr, ast.Star)):
            new_items = tuple(
                dataclasses.replace(i, expr=rewrite_scalars(i.expr))
                if _contains_subquery(i.expr) else i
                for i in sel.items
            )
            sel = dataclasses.replace(sel, items=new_items)
        if synthetic and (sel.group_by or any(
                _contains_agg(i.expr) for i in sel.items)):
            used = {
                n.parts[0]
                for i in sel.items
                for n in _walk_names(i.expr)
                if len(n.parts) == 1 and n.parts[0] in synthetic
            }
            if having is not None:
                used |= {
                    n.parts[0] for n in _walk_names(having)
                    if len(n.parts) == 1 and n.parts[0] in synthetic
                }
            extra = tuple(
                ast.Name((n,)) for n in sorted(used)
                if ast.Name((n,)) not in sel.group_by
            )
            if extra:
                sel = dataclasses.replace(
                    sel, group_by=tuple(sel.group_by) + extra)

        # --- classify WHERE conjuncts ---
        pushdown: dict[str, list[ast.Expr]] = {s.alias: [] for s in scopes}
        join_conds: list[tuple[str, str, str, str]] = []
        residual: list[ast.Expr] = []

        def expr_aliases(e) -> tuple[set, bool]:
            """(aliases referenced, uses_synthetic)"""
            out, syn = set(), False
            for x in _walk_names(e):
                if len(x.parts) == 1 and x.parts[0] in synthetic:
                    syn = True
                    continue
                out.add(binding.resolve(x)[0])
            return out, syn

        for c in where_conjuncts:
            aliases, syn = expr_aliases(c)
            if syn:
                residual.append(c)
                continue
            if len(aliases) <= 1:
                target = next(iter(aliases)) if aliases else scopes[0].alias
                if target in left_right_aliases:
                    residual.append(c)
                    continue
                pushdown[target].append(c)
            elif (
                len(aliases) == 2
                and isinstance(c, ast.BinOp) and c.op == "eq"
                and isinstance(c.left, ast.Name)
                and isinstance(c.right, ast.Name)
            ):
                la, lc = binding.resolve(c.left)
                ra, rc = binding.resolve(c.right)
                if la in left_right_aliases or ra in left_right_aliases:
                    residual.append(c)
                else:
                    join_conds.append((la, lc, ra, rc))
            else:
                hoisted = self._hoist_or_equi(c, binding)
                join_conds.extend(hoisted)
                residual.append(c)

        # explicit ON conditions
        on_conds: dict[int, list[tuple[str, str, str, str]]] = {}
        for idx, on, kind in join_specs:
            conds = []
            for c in _conjuncts(on):
                if (isinstance(c, ast.BinOp) and c.op == "eq"
                        and isinstance(c.left, ast.Name)
                        and isinstance(c.right, ast.Name)):
                    la, lc = binding.resolve(c.left)
                    ra, rc = binding.resolve(c.right)
                    conds.append((la, lc, ra, rc))
                    continue
                aliases, syn = expr_aliases(c)
                if syn or len(aliases) > 1:
                    raise PlanError(
                        "JOIN ON supports equi-conditions plus"
                        " single-table filters only")
                target = next(iter(aliases)) if aliases else None
                if target == scopes[idx].alias:
                    # build-side ON filter: restricts matches, which for
                    # LEFT keeps the probe row with NULLs — push into the
                    # build scan
                    pushdown[target].append(c)
                elif kind == "left":
                    raise PlanError(
                        "probe-side ON filters in LEFT JOIN are not"
                        " supported")
                elif target is not None:
                    pushdown[target].append(c)
            on_conds[idx] = conds

        # --- demand per scope ---
        demand: dict[str, set[str]] = {s.alias: set() for s in scopes}
        out_aliases = {
            _item_name(item, i) for i, item in enumerate(sel.items)
        }

        def demand_expr(e):
            for x in _walk_names(e):
                if len(x.parts) == 1 and x.parts[0] in synthetic:
                    continue
                try:
                    a, c = binding.resolve(x)
                except PlanError:
                    # select aliases (GROUP BY initial) demand nothing:
                    # the aliased expression is walked via its item
                    if len(x.parts) == 1 and x.parts[0] in out_aliases:
                        continue
                    raise
                demand[a].add(c)
        for item in sel.items:
            if isinstance(item.expr, ast.Star):
                raise PlanError("SELECT * is only allowed inside EXISTS")
            demand_expr(item.expr)
        for e in sel.group_by:
            demand_expr(e)
        for o in sel.order_by:
            if isinstance(o.expr, ast.Name) and o.expr.parts[-1] in out_aliases:
                continue
            demand_expr(o.expr)
        if having is not None:
            demand_expr(having)
        for e in residual:
            demand_expr(e)
        for la, lc, ra, rc in join_conds:
            demand[la].add(lc)
            demand[ra].add(rc)
        for conds in on_conds.values():
            for la, lc, ra, rc in conds:
                demand[la].add(lc)
                demand[ra].add(rc)
        for _, corr, _sub in semi_joins:
            for o, _ in corr:
                a, c = binding.resolve(o)
                demand[a].add(c)
        for _, corr, _sub in scalar_joins:
            for o, _ in corr:
                a, c = binding.resolve(o)
                demand[a].add(c)

        # --- per-scope scan plans (pushdown + projection) ---
        def scan_for(scope: _Scope):
            types = dict(scope.types)
            dict_src = dict(scope.dict_src)
            steps: list = []
            low = _Lower(types, self.catalog.dicts, dict_src,
                         emit=steps.append, udfs=self.catalog.udfs)
            for c in pushdown[scope.alias]:
                steps.append(FilterStep(low.lower(c)))
            cols = tuple(
                n for n in scope.names if n in demand[scope.alias]
            ) or scope.names[:1]
            steps.append(ProjectStep(cols))
            prog = Program(tuple(steps))
            if scope.table is not None:
                return TableScan(scope.table, prog)
            aliases = tuple(sorted(
                (k, v) for k, v in scope.dict_src.items() if k != v
            ))
            return Transform(scope.sub.plan, prog, aliases)

        # --- left-deep join tree with (alias, col) -> out-name map ---
        colmap: dict[tuple[str, str], str] = {}
        types: dict[str, dtypes.LogicalType] = {}
        dict_src: dict[str, str] = {}

        s0 = scopes[0]
        plan = scan_for(s0)
        first_cols = tuple(
            n for n in s0.names if n in demand[s0.alias]
        ) or s0.names[:1]
        for n in first_cols:
            colmap[(s0.alias, n)] = n
            types[n] = s0.types[n]
            if n in s0.dict_src:
                dict_src[n] = s0.dict_src[n]
        joined_aliases = [s0.alias]

        # greedy connectivity ordering (CBO-lite): FROM order may list a
        # table before the one that connects it (q2 lists supplier before
        # partsupp); always join the next FROM-ordered scope that has an
        # equi-condition into the already-joined set
        pending = join_conds[:]
        remaining = list(range(1, len(scopes)))

        def connects(i: int, joined: list[str]) -> bool:
            alias = scopes[i].alias
            on = on_conds.get(i, [])
            if on:
                # an explicit ON clause must be placeable WHOLE: every
                # conjunct's other side already joined (a partial pick
                # would raise 'ON condition does not connect' later)
                return all(
                    (la in joined) if ra == alias else
                    (ra in joined) if la == alias else False
                    for la, lc, ra, rc in on
                )
            for la, lc, ra, rc in pending:
                if (ra == alias and la in joined) or (
                        la == alias and ra in joined):
                    return True
            return False

        def est_rows(i: int) -> float:
            t = scopes[i].table
            if t is not None and t in self.catalog.row_counts:
                return float(self.catalog.row_counts[t])
            if t is not None and t in self.catalog.table_stats:
                # aggregator statistics fill row-count gaps (a table
                # whose cheap metadata count is unknown may still have
                # a sketched row count)
                return float(self.catalog.table_stats[t].rows)
            return float("inf")

        # CBO-lite: with table statistics available (and no LEFT JOINs,
        # which do not commute freely), prefer the SMALLEST connectable
        # side next — dimension tables join before fact expansions
        # (ydb/library/yql/core/cbo greedy ordering shape)
        use_stats = bool(self.catalog.row_counts
                         or self.catalog.table_stats) and not any(
            kind == "left" for _, _, kind in join_specs)

        join_order: list[int] = []
        while remaining:
            joined_now = joined_aliases + [
                scopes[j].alias for j in join_order
            ]
            connectable = [i for i in remaining
                           if connects(i, joined_now)]
            if not connectable:
                pick = remaining[0]  # will raise "no equi-join" below
            elif use_stats:
                pick = min(connectable, key=est_rows)
            else:
                pick = connectable[0]
            join_order.append(pick)
            remaining.remove(pick)

        for i in join_order:
            scope = scopes[i]
            alias = scope.alias
            conds = []
            for la, lc, ra, rc in on_conds.get(i, []):
                if ra == alias and la in joined_aliases:
                    conds.append((la, lc, ra, rc))
                elif la == alias and ra in joined_aliases:
                    conds.append((ra, rc, la, lc))
                else:
                    raise PlanError(
                        f"ON condition does not connect {alias} to the"
                        f" joined tables: {la}.{lc} = {ra}.{rc}"
                    )
            still = []
            for la, lc, ra, rc in pending:
                if ra == alias and la in joined_aliases:
                    conds.append((la, lc, ra, rc))
                elif la == alias and ra in joined_aliases:
                    conds.append((ra, rc, la, lc))
                else:
                    still.append((la, lc, ra, rc))
            pending = still
            # the same equi-cond can arrive twice (hoisted from an OR
            # plus explicit): dedupe
            conds = list(dict.fromkeys(conds))
            if not conds:
                raise PlanError(
                    f"no equi-join condition connects {alias}; cross"
                    " joins are not supported"
                )
            kind0 = dict(
                (j[0], j[2]) for j in join_specs).get(i, "inner")
            if len(conds) > 2:
                # the join kernel packs at most two key columns into one
                # int64 (ssa/join.py _key_i64); further equalities lower
                # as post-join filters on the carried build columns —
                # exact for inner joins (a NULL key fails both ways).
                # LEFT JOIN ON semantics (conditions gate the MATCH, not
                # the result row) would change, so those keep erroring.
                if kind0 == "left":
                    raise PlanError(
                        "LEFT JOIN with more than two equality"
                        " conditions is not supported")
                for la, lc, ra, rc in conds[2:]:
                    residual.append(ast.BinOp(
                        "eq", ast.Name((la, lc)), ast.Name((ra, rc))))
                conds = conds[:2]
            probe_keys = tuple(colmap[(la, lc)] for la, lc, ra, rc in conds)
            build_keys = tuple(rc for la, lc, ra, rc in conds)
            kind = kind0
            demanded = [
                n for n in scope.names
                if n in demand[alias] and n not in build_keys
            ]
            # keep build-side join keys if referenced downstream and not
            # already carried under the same name from the probe side
            demanded += [
                n for n in build_keys
                if n in demand[alias] and n not in demanded
                and n not in types
            ]
            taken = set(types)
            suffix = ""
            if any(n in taken for n in demanded):
                suffix = f"_{alias}"
            payload = tuple(demanded)
            for n in payload:
                out_n = n + suffix
                if out_n in taken:
                    raise PlanError(
                        f"cannot disambiguate column {n} from {alias}")
            unique_build = scope.pk is not None and set(scope.pk) <= set(
                build_keys)
            build_plan = scan_for(scope)
            if not payload and kind == "inner" and unique_build:
                plan = LookupJoin(plan, build_plan, probe_keys, build_keys,
                                  (), "semi")
            elif unique_build:
                plan = LookupJoin(plan, build_plan, probe_keys, build_keys,
                                  payload, kind, suffix)
            elif kind == "left":
                probe_payload = tuple(types.keys())
                plan = ExpandJoin(plan, build_plan, probe_keys, build_keys,
                                  probe_payload, payload,
                                  build_suffix=suffix, kind="left")
            else:
                probe_payload = tuple(types.keys())
                plan = ExpandJoin(plan, build_plan, probe_keys, build_keys,
                                  probe_payload, payload,
                                  build_suffix=suffix)
            for n in payload:
                out_n = n + suffix
                colmap[(alias, n)] = out_n
                types[out_n] = scope.types[n]
                if n in scope.dict_src:
                    dict_src[out_n] = scope.dict_src[n]
            # build keys equal probe keys on matched rows: make them
            # resolvable under the build alias too (inner joins only —
            # left-join NULL-extended rows diverge)
            for (la, lc, ra, rc), pk_name in zip(conds, probe_keys):
                if kind != "left" and (alias, rc) not in colmap:
                    colmap[(alias, rc)] = pk_name
            joined_aliases.append(alias)
        if pending:
            raise PlanError(f"unplaced join conditions {pending}")

        # --- scalar-subquery aggregate joins (decorrelated) ---
        for name, corr, sub in scalar_joins:
            probe_keys = tuple(
                colmap[binding.resolve(o)] for o, _ in corr
            )
            build_keys = tuple(c for _, c in corr)
            plan = LookupJoin(
                plan, sub.plan, probe_keys, build_keys,
                (name,), "left",
            )
            types[name] = synthetic[name]
            colmap[(None, name)] = name

        # --- semi/anti joins from EXISTS / IN subqueries ---
        for kind, corr, sub in semi_joins:
            probe_keys = tuple(
                colmap[binding.resolve(o)] for o, _ in corr
            )
            build_keys = tuple(c for _, c in corr)
            plan = LookupJoin(plan, sub.plan, probe_keys, build_keys,
                              (), kind)

        # --- final transform ---
        def resolve_out(x: ast.Name) -> str:
            if len(x.parts) == 1 and x.parts[0] in synthetic:
                return x.parts[0]
            a, c = binding.resolve(x)
            key = (a, c)
            if key not in colmap:
                raise PlanError(
                    f"column {a}.{c} is not carried through the joins")
            return colmap[key]

        if len(scopes) == 1:
            # single-table: everything references scan output names
            for n in first_cols:
                dict_src.setdefault(n, s0.dict_src.get(n, n))

        steps: list = []
        low = _Lower(types, self.catalog.dicts, dict_src,
                     resolve=resolve_out, emit=steps.append,
                     udfs=self.catalog.udfs)
        for c in residual:
            steps.append(FilterStep(low.lower(c)))

        has_agg = any(
            _contains_agg(i.expr) for i in sel.items
        ) or (having is not None and _contains_agg(having)) or bool(
            sel.group_by)

        out_names: list[str] = []
        out_types: dict[str, dtypes.LogicalType] = {}
        out_dict_aliases: dict[str, str] = {}
        unique_key: tuple[str, ...] | None = None
        project = None  # deferred final projection (non-agg path)
        has_window = any(
            isinstance(i.expr, ast.WindowCall) for i in sel.items)
        if has_agg and has_window:
            raise PlanError(
                "window functions cannot mix with aggregation in one"
                " SELECT; rank over a subquery of the aggregates")
        if has_agg:
            if sel.distinct:
                raise PlanError(
                    "SELECT DISTINCT with aggregates is redundant"
                    " or unsupported; drop DISTINCT")
            steps, out_names, out_types, key_outs = _plan_aggregate(
                sel, low, steps, having)
            unique_key = (
                tuple(key_outs) if key_outs and all(key_outs) else None
            )
        else:
            for idx, item in enumerate(sel.items):
                name = _item_name(item, idx)
                if isinstance(item.expr, ast.WindowCall):
                    wc = item.expr
                    if wc.func not in ("rank", "dense_rank",
                                       "row_number"):
                        raise PlanError(
                            f"unsupported window function {wc.func}")

                    def wcol(e):
                        if isinstance(e, ast.Name):
                            return resolve_out(e)
                        lowered = low.lower(e)
                        tmp = f"__w{len(steps)}"
                        steps.append(AssignStep(tmp, lowered))
                        low.types[tmp] = infer_type(
                            lowered, None, low.types)
                        return tmp

                    pcols = tuple(wcol(p) for p in wc.partition)
                    ocols, descs = [], []
                    for oi in wc.order:
                        ocols.append(wcol(oi.expr))
                        descs.append(oi.descending)
                    steps.append(WindowStep(
                        wc.func, pcols, tuple(ocols), tuple(descs),
                        name))
                    low.types[name] = dtypes.INT64
                    out_names.append(name)
                    out_types[name] = dtypes.INT64
                    continue
                if isinstance(item.expr, ast.Name):
                    src = resolve_out(item.expr)
                    if src == name:
                        out_names.append(src)
                        out_types[src] = types[src]
                        continue
                    steps.append(AssignStep(name, Col(src)))
                    low.types[name] = types[src]
                    if src in dict_src:
                        low.dict_src[name] = dict_src[src]
                    out_names.append(name)
                    out_types[name] = types[src]
                    continue
                lowered = low.lower(item.expr)
                t = infer_type(lowered, None, low.types)
                steps.append(AssignStep(name, lowered))
                low.types[name] = t
                if isinstance(lowered, Col) and lowered.name in low.dict_src:
                    low.dict_src[name] = low.dict_src[lowered.name]
                elif isinstance(lowered, DictMap):
                    low.dict_src[name] = lowered.out_column
                out_names.append(name)
                out_types[name] = t
            project = ProjectStep(tuple(out_names))
            if sel.distinct:
                steps.append(project)
                steps.append(GroupByStep(tuple(out_names), ()))
                unique_key = tuple(out_names)
                project = None

        # the aggregate path builds its own sort/limit/projection inside
        # _plan_aggregate (hidden post-agg sort columns)
        if has_agg:
            pass
        elif sel.order_by:
            keys = []
            desc = []
            hidden_sort = False
            for o in sel.order_by:
                if isinstance(o.expr, ast.Name) and \
                        o.expr.parts[-1] in out_names:
                    keys.append(o.expr.parts[-1])
                elif isinstance(o.expr, ast.Name):
                    # plain SELECT may order by a non-projected column:
                    # sort first, project after
                    keys.append(resolve_out(o.expr))
                    hidden_sort = True
                else:
                    raise PlanError(
                        "ORDER BY must reference output columns/aliases")
                desc.append(o.descending)
            sort = SortStep(tuple(keys), tuple(desc), sel.limit)
            if not sel.distinct:
                if hidden_sort:
                    steps.extend([sort, project])
                else:
                    steps.extend([project, sort])
            else:
                steps.append(sort)
        else:
            if not sel.distinct and project is not None:
                steps.append(project)
            if sel.limit is not None:
                steps.append(SortStep((), (), sel.limit))

        for n in out_names:
            if n in low.dict_src and low.dict_src[n] != n:
                out_dict_aliases[n] = low.dict_src[n]

        aliases = tuple(sorted(
            (k, v) for k, v in low.dict_src.items() if k != v
        ))
        out_plan = Transform(plan, Program(tuple(steps)), aliases)
        return PlannedQuery(
            plan=out_plan,
            out_names=tuple(out_names),
            out_types=out_types,
            dict_aliases=out_dict_aliases,
            unique_key=unique_key,
            used_scalar_exec=self.used_scalar_exec,
        )

    # -- helpers used by plan() --

    def _plan_in_subquery(self, sub_sel: ast.Select,
                          outer: _Binding) -> PlannedQuery:
        """Plan the body of IN (SELECT col ...). Correlated conjuncts are
        not supported here (TPC-H IN-subqueries are uncorrelated)."""
        return self._sub(sub_sel)

    def _rewrite_scalar(self, sub: ast.Select, binding: _Binding,
                        scalar_joins, synthetic, syn_dict_src,
                        new_sq_name):
        """ScalarSubquery -> Literal (uncorrelated, eager exec) or
        Name(__sqN) backed by a decorrelated aggregate join."""
        corr, ne_corr, local = self._correlations(sub, binding)
        if ne_corr:
            raise PlanError(
                "non-equi correlation in a scalar subquery")
        if not corr:
            if self.scalar_exec is None:
                raise PlanError(
                    "uncorrelated scalar subquery needs an executor"
                    " (scalar_exec)")
            if len(sub.items) != 1:
                raise PlanError("scalar subquery must select one value")
            self.used_scalar_exec = True
            planned = self._sub(sub)
            t = planned.out_types[planned.out_names[0]]
            value, valid = self.scalar_exec(planned.plan, t)
            if not valid:
                value = None
            elif t.is_decimal:
                value, scale = _strip_decimal_zeros(int(value), t.scale)
                t = dtypes.decimal(scale)
            return ast.Literal((value, t), "typed")
        # correlated: rewrite into GROUP BY over the correlation columns
        if len(sub.items) != 1:
            raise PlanError("scalar subquery must select one value")
        if not _contains_agg(sub.items[0].expr):
            raise PlanError(
                "correlated scalar subquery must be an aggregate")
        name = new_sq_name()
        where = None
        for c in local:
            where = c if where is None else ast.BinOp("and", where, c)
        corr_cols = list(dict.fromkeys(c for _, c in corr))
        items = (ast.SelectItem(sub.items[0].expr, name),) + tuple(
            ast.SelectItem(ast.Name((c,)), None) for c in corr_cols
        )
        rewritten = ast.Select(
            items=items, from_=sub.from_, where=where,
            group_by=tuple(ast.Name((c,)) for c in corr_cols),
            having=None, order_by=(), limit=None, ctes=sub.ctes,
        )
        planned = self._sub(rewritten)
        scalar_joins.append((name, corr, planned))
        synthetic[name] = planned.out_types[name]
        return ast.Name((name,))

    def _hoist_or_equi(self, c, binding) -> list[tuple[str, str, str, str]]:
        """For an OR-of-conjunctions where EVERY branch contains the same
        two-table equality (q19's (p=l and ...) or (p=l and ...) shape),
        hoist that equality as a join condition; the OR stays residual."""
        def branches(e):
            if isinstance(e, ast.BinOp) and e.op == "or":
                return branches(e.left) + branches(e.right)
            return [e]

        brs = branches(c)
        if len(brs) < 2:
            return []
        common: set | None = None
        for b in brs:
            eqs = set()
            for cj in _conjuncts(b):
                if (isinstance(cj, ast.BinOp) and cj.op == "eq"
                        and isinstance(cj.left, ast.Name)
                        and isinstance(cj.right, ast.Name)):
                    la = binding.try_resolve(cj.left)
                    ra = binding.try_resolve(cj.right)
                    if la and ra and la[0] != ra[0]:
                        eqs.add((la + ra))
                        eqs.add((ra + la))
            common = eqs if common is None else (common & eqs)
            if not common:
                return []
        out = []
        seen = set()
        for la, lc, ra, rc in common:
            if (ra, rc, la, lc) in seen:
                continue
            seen.add((la, lc, ra, rc))
            out.append((la, lc, ra, rc))
        return out


def _collect_aggs(e, out: list) -> None:
    if isinstance(e, ast.FuncCall):
        if e.name in _AGG_FUNCS or (e.name == "count" and e.star):
            out.append(e)
            return
        for a in e.args:
            _collect_aggs(a, out)
    elif isinstance(e, ast.BinOp):
        _collect_aggs(e.left, out)
        _collect_aggs(e.right, out)
    elif isinstance(e, ast.UnOp):
        _collect_aggs(e.operand, out)
    elif isinstance(e, ast.Case):
        for c, v in e.whens:
            _collect_aggs(c, out)
            _collect_aggs(v, out)
        if e.else_ is not None:
            _collect_aggs(e.else_, out)


def _remap_alias_names(e, mapping: dict):
    """Rewrite qualified Names whose alias is in ``mapping``."""
    if isinstance(e, ast.Name):
        if len(e.parts) == 2 and e.parts[0] in mapping:
            return ast.Name((mapping[e.parts[0]], e.parts[1]))
        return e
    if isinstance(e, ast.BinOp):
        return ast.BinOp(e.op, _remap_alias_names(e.left, mapping),
                         _remap_alias_names(e.right, mapping))
    if isinstance(e, ast.UnOp):
        return ast.UnOp(e.op, _remap_alias_names(e.operand, mapping))
    if isinstance(e, ast.FuncCall):
        return ast.FuncCall(
            e.name,
            tuple(_remap_alias_names(a, mapping) for a in e.args),
            e.star, e.distinct)
    if isinstance(e, ast.Between):
        return ast.Between(_remap_alias_names(e.expr, mapping),
                           _remap_alias_names(e.low, mapping),
                           _remap_alias_names(e.high, mapping), e.negated)
    if isinstance(e, ast.InList):
        return ast.InList(_remap_alias_names(e.expr, mapping),
                          tuple(_remap_alias_names(i, mapping)
                                for i in e.items), e.negated)
    if isinstance(e, (ast.Like, ast.IsNull)):
        return dataclasses.replace(
            e, expr=_remap_alias_names(e.expr, mapping))
    if isinstance(e, ast.Case):
        return ast.Case(
            tuple((_remap_alias_names(c, mapping),
                   _remap_alias_names(v, mapping)) for c, v in e.whens),
            _remap_alias_names(e.else_, mapping)
            if e.else_ is not None else None)
    return e


def _rename_from(f, pre: str, mapping: dict):
    if isinstance(f, ast.TableRef):
        alias = f.alias or f.name
        mapping[alias] = pre + alias
        return ast.TableRef(f.name, pre + alias)
    if isinstance(f, ast.SubquerySource):
        mapping[f.alias] = pre + f.alias
        return ast.SubquerySource(f.select, pre + f.alias)
    left = _rename_from(f.left, pre, mapping)
    right = _rename_from(f.right, pre, mapping)
    on = _remap_alias_names(f.on, mapping) if f.on is not None else None
    return ast.Join(left, right, on, f.kind)


def _rewrite_mixed_distinct(sel: ast.Select, planner):
    """COUNT(DISTINCT x) mixed with other aggregates (ClickBench Q9
    shape): each distinct aggregate becomes a correlated scalar subquery
    over a renamed copy of the FROM, correlated on the GROUP BY keys —
    the existing decorrelation machinery then turns it into a
    dedup-aggregate join. Returns the rewritten Select or None when the
    query is not the mixed shape (the single-distinct fast path and the
    'cannot mix' error stay as they were for unsupported forms)."""
    aggs: list[ast.FuncCall] = []
    for i in sel.items:
        if not isinstance(i.expr, ast.Star):
            _collect_aggs(i.expr, aggs)
    if sel.having is not None:
        _collect_aggs(sel.having, aggs)
    distinct = [a for a in aggs if a.distinct]
    plain = [a for a in aggs if not a.distinct]
    d_cols = {a.args[0].column for a in distinct
              if a.args and isinstance(a.args[0], ast.Name)}
    if not distinct or not (plain or len(d_cols) > 1):
        return None
    if any(a.name != "count" or not a.args
           or not isinstance(a.args[0], ast.Name) for a in distinct):
        return None
    if not all(isinstance(g, ast.Name) for g in sel.group_by):
        return None
    if sel.from_ is None:
        return None
    if any(_contains_subquery(c) for c in _conjuncts(sel.where)):
        # the WHERE would be copied into the dedup subqueries, and
        # nested-subquery scopes do not survive the alias renaming
        return None
    try:
        binding, _ = planner._bind(sel)
    except PlanError:
        return None

    counter = [0]

    def subquery_for(fc: ast.FuncCall) -> ast.ScalarSubquery:
        pre = f"__dd{counter[0]}_"
        counter[0] += 1
        mapping: dict = {}
        inner_from = _rename_from(sel.from_, pre, mapping)
        conjs = [
            _remap_alias_names(c, mapping)
            for c in _conjuncts(sel.where)
        ]
        # correlate on every group key: outer side stays qualified with
        # the OUTER alias (unresolvable inside -> correlation), inner
        # side uses the renamed alias
        for g in sel.group_by:
            alias, col = binding.resolve(g)
            conjs.append(ast.BinOp(
                "eq", ast.Name((alias, col)),
                ast.Name((mapping[alias], col))))
        where = None
        for c in conjs:
            where = c if where is None else ast.BinOp("and", where, c)
        inner = ast.Select(
            items=(ast.SelectItem(
                ast.FuncCall(
                    "count",
                    tuple(_remap_alias_names(a, mapping)
                          for a in fc.args),
                    distinct=True), None),),
            from_=inner_from, where=where, group_by=(), having=None,
            order_by=(), limit=None,
        )
        return ast.ScalarSubquery(inner)

    # one distinct aggregate stays INLINE (the single-distinct fast
    # path handles it) so the outer query remains an aggregation and
    # emits its mandatory row even over empty input; the rest become
    # scalar subqueries
    inline_key = repr(distinct[0]) if not plain else None
    replaced: dict = {}

    def rw(e):
        if isinstance(e, ast.FuncCall) and e.distinct:
            key = repr(e)
            if key == inline_key:
                return e
            if key not in replaced:
                replaced[key] = subquery_for(e)
            return replaced[key]
        if isinstance(e, ast.FuncCall):
            return ast.FuncCall(e.name, tuple(rw(a) for a in e.args),
                                e.star, e.distinct)
        if isinstance(e, ast.BinOp):
            return ast.BinOp(e.op, rw(e.left), rw(e.right))
        if isinstance(e, ast.UnOp):
            return ast.UnOp(e.op, rw(e.operand))
        if isinstance(e, ast.Case):
            return ast.Case(
                tuple((rw(c), rw(v)) for c, v in e.whens),
                rw(e.else_) if e.else_ is not None else None)
        return e

    new_items = tuple(
        i if isinstance(i.expr, ast.Star)
        else dataclasses.replace(i, expr=rw(i.expr))
        for i in sel.items
    )
    new_having = rw(sel.having) if sel.having is not None else None
    return dataclasses.replace(sel, items=new_items, having=new_having)


def _plan_aggregate(sel: ast.Select, low: _Lower, steps: list, having):
    """Lower GROUP BY + aggregates + HAVING into SSA steps.

    Returns (steps, out_names, out_types, group_key_out_names)."""
    # group keys may be select aliases of computed exprs (q7's l_year
    # aliases extract(...)) — resolve through the alias map
    alias_exprs = {
        item.alias: item.expr for item in sel.items if item.alias
    }

    def assign_key(name: str, expr) -> None:
        lowered = low.lower(expr)
        steps.append(AssignStep(name, lowered))
        low.types[name] = infer_type(lowered, None, low.types)
        if isinstance(lowered, Col) and lowered.name in low.dict_src:
            low.dict_src[name] = low.dict_src[lowered.name]
        elif isinstance(lowered, DictMap):
            low.dict_src[name] = lowered.out_column

    key_names: list[str] = []
    key_exprs: dict = {}
    for i, g in enumerate(sel.group_by):
        if isinstance(g, ast.Name):
            nm = g.parts[-1]
            try:
                name = low.name_of(g)
            except PlanError:
                if len(g.parts) == 1 and nm in alias_exprs:
                    expr = alias_exprs[nm]
                    if isinstance(expr, ast.Name):
                        name = low.name_of(expr)
                    else:
                        assign_key(nm, expr)
                        name = nm
                    # the aliased expression itself is this key too
                    key_exprs[expr] = name
                else:
                    raise
            key_names.append(name)
            key_exprs[g] = name
        else:
            name = f"__key{i}"
            assign_key(name, g)
            key_names.append(name)
            key_exprs[g] = name

    agg_specs: list[AggSpec] = []
    agg_map: dict = {}
    distinct_cols: list[str] = []

    def register_agg(fc: ast.FuncCall) -> str:
        key = repr(fc)
        if key in agg_map:
            return agg_map[key]
        name = f"__agg{len(agg_specs)}"
        if fc.name == "count" and fc.star:
            agg_specs.append(AggSpec(Agg.COUNT_ALL, None, name))
        else:
            func = _AGG_FUNCS[fc.name]
            arg = fc.args[0]
            if isinstance(arg, ast.Name):
                col = low.name_of(arg)
            else:
                col = f"__arg{len(agg_specs)}"
                lowered = low.lower(arg)
                steps.append(AssignStep(col, lowered))
                low.types[col] = infer_type(lowered, None, low.types)
            if fc.distinct:
                if fc.name != "count":
                    raise PlanError(
                        "DISTINCT is supported for COUNT only")
                distinct_cols.append(col)
            agg_specs.append(AggSpec(func, col, name))
        agg_map[key] = name
        return name

    def key_of_name(e: ast.Name) -> str | None:
        if len(e.parts) == 1 and e.parts[0] in key_names:
            return e.parts[0]
        try:
            nm = low.name_of(e)
        except PlanError:
            return None
        return nm if nm in key_names else None

    def rewrite(e):
        if e in key_exprs:
            return ast.Name((key_exprs[e],))
        if isinstance(e, ast.Name):
            nm = key_of_name(e)
            return ast.Name((nm,)) if nm is not None else e
        if isinstance(e, ast.FuncCall) and (
                e.name in _AGG_FUNCS or (e.name == "count" and e.star)):
            return ast.Name((register_agg(e),))
        if isinstance(e, ast.BinOp):
            return ast.BinOp(e.op, rewrite(e.left), rewrite(e.right))
        if isinstance(e, ast.UnOp):
            return ast.UnOp(e.op, rewrite(e.operand))
        if isinstance(e, ast.FuncCall):
            return ast.FuncCall(e.name, tuple(rewrite(a) for a in e.args),
                                e.star, e.distinct)
        return e

    post_items: list[tuple[str, ast.Expr]] = []
    out_names: list[str] = []
    key_out: dict[str, str] = {}  # group key -> its projected out name
    for idx, item in enumerate(sel.items):
        name = _item_name(item, idx)
        if isinstance(item.expr, ast.Name):
            col = key_of_name(item.expr)
            if col is None:
                raise PlanError(
                    f"column {item.expr.column} is neither aggregated nor"
                    " a group key")
            out_names.append(col if item.alias in (None, col) else name)
            key_out[col] = out_names[-1]
            post_items.append((out_names[-1], ast.Name((col,))))
            continue
        out_names.append(name)
        post_items.append((name, rewrite(item.expr)))
    having_rw = rewrite(having) if having is not None else None

    if distinct_cols:
        if any(s.func is not Agg.COUNT or s.column not in distinct_cols
               for s in agg_specs):
            raise PlanError(
                "COUNT(DISTINCT) cannot mix with other aggregates yet")
        if len(set(distinct_cols)) > 1:
            # one dedup pass over (keys + ALL distinct cols) would count
            # PAIRS, silently wrong per column; the mixed-distinct
            # rewrite handles the supported shapes before reaching here
            raise PlanError(
                "multiple COUNT(DISTINCT ...) columns need plain column"
                " arguments (unsupported distinct-aggregate shape)")
        # dedup pass: group by (keys + distinct cols) with no aggregates,
        # then COUNT over the deduplicated rows
        steps.append(GroupByStep(
            tuple(key_names) + tuple(dict.fromkeys(distinct_cols)), ()))
    steps.append(GroupByStep(tuple(key_names), tuple(agg_specs)))

    from ydb_tpu_torch.ssa.program import agg_result_type

    post_types = {k: low.types[k] for k in key_names}
    post_dict_src = dict(low.dict_src)
    for spec in agg_specs:
        post_types[spec.out_name] = agg_result_type(spec, None, low.types)
    post_low = _Lower(post_types, low.dicts, post_dict_src,
                      udfs=low.udfs)
    for spec in agg_specs:
        # MIN/MAX/SOME over a string column: the output carries the
        # source column's dictionary
        if spec.column is not None and post_types[
                spec.out_name].is_string:
            post_dict_src[spec.out_name] = low.dict_src.get(
                spec.column, spec.column)

    if having_rw is not None:
        steps.append(FilterStep(post_low.lower(having_rw)))
    for name, e in post_items:
        if isinstance(e, ast.Name) and e.parts[-1] == name:
            continue
        lowered = post_low.lower(e)
        steps.append(AssignStep(name, lowered))
        post_low.types[name] = infer_type(lowered, None, post_low.types)
        if isinstance(lowered, Col) and lowered.name in post_low.dict_src:
            post_low.dict_src[name] = post_low.dict_src[lowered.name]

    # ORDER BY: output aliases directly; aggregate EXPRESSIONS (ClickBench
    # 'ORDER BY COUNT(*) DESC') lower into hidden post-agg columns sorted
    # before the final projection drops them
    if sel.order_by:
        keys, desc = [], []
        n_aggs_final = len(agg_specs)
        for i, o in enumerate(sel.order_by):
            if isinstance(o.expr, ast.Name) and \
                    o.expr.parts[-1] in out_names:
                keys.append(o.expr.parts[-1])
            else:
                if isinstance(o.expr, ast.Literal):
                    raise PlanError(
                        "ORDER BY must reference output columns/aliases"
                        " or aggregate expressions")
                rw = rewrite(o.expr)
                if len(agg_specs) != n_aggs_final:
                    # the GroupByStep (and post scope) snapshotted the
                    # aggregate list already — a NEW aggregate here would
                    # reference states that were never computed
                    raise PlanError(
                        "ORDER BY aggregate must also appear in the"
                        " SELECT list")
                if isinstance(rw, ast.Name) and rw.parts[-1] in out_names:
                    keys.append(rw.parts[-1])
                else:
                    name = f"__ord{i}"
                    lowered = post_low.lower(rw)
                    steps.append(AssignStep(name, lowered))
                    post_low.types[name] = infer_type(
                        lowered, None, post_low.types)
                    keys.append(name)
            desc.append(o.descending)
        steps.append(SortStep(tuple(keys), tuple(desc), sel.limit))
    elif sel.limit is not None:
        steps.append(SortStep((), (), sel.limit))
    steps.append(ProjectStep(tuple(out_names)))

    out_types = {n: post_low.types[n] for n in out_names}
    # propagate dictionary renames for downstream consumers
    low.dict_src.update(post_low.dict_src)
    # the output names the group keys survive under (None if projected out)
    key_outs = [key_out.get(k) for k in key_names]
    return steps, out_names, out_types, key_outs
