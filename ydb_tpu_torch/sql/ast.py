"""SQL AST nodes (unresolved names; the planner binds them).

The reference parses SQL into an expression graph via NSQLTranslation →
TExprNode (SURVEY.md §2 layer 7a). This is a lean analog: a
typed AST for the supported dialect subset, produced by
ydb_tpu_torch.sql.parser and consumed by ydb_tpu_torch.sql.planner.

The port's copy of ``ydb_tpu/sql/ast.py``, unchanged apart from this
docstring.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union


@dataclasses.dataclass(frozen=True)
class Name:
    """Possibly qualified column reference (t.col or col)."""

    parts: tuple[str, ...]

    @property
    def column(self) -> str:
        return self.parts[-1]


@dataclasses.dataclass(frozen=True)
class Literal:
    value: Any
    kind: str  # int | float | string | null | bool | decimal


@dataclasses.dataclass(frozen=True)
class BinOp:
    op: str
    left: "Expr"
    right: "Expr"


@dataclasses.dataclass(frozen=True)
class UnOp:
    op: str
    operand: "Expr"


@dataclasses.dataclass(frozen=True)
class FuncCall:
    name: str
    args: tuple["Expr", ...]
    star: bool = False  # count(*)
    distinct: bool = False  # count(distinct x)


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """fn() OVER (PARTITION BY ... ORDER BY ...) — the ranking window
    subset (rank / dense_rank / row_number)."""

    func: str
    partition: tuple["Expr", ...]
    order: tuple["OrderItem", ...]


@dataclasses.dataclass(frozen=True)
class Between:
    expr: "Expr"
    low: "Expr"
    high: "Expr"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InList:
    expr: "Expr"
    items: tuple["Expr", ...]
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Like:
    expr: "Expr"
    pattern: str
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class IsNull:
    expr: "Expr"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Case:
    whens: tuple[tuple["Expr", "Expr"], ...]
    else_: "Expr | None"


@dataclasses.dataclass(frozen=True)
class ScalarSubquery:
    """(SELECT single-expr ...) used as a value. Uncorrelated ones execute
    eagerly at plan time; correlated ones decorrelate into aggregate
    joins (the DqBuildJoin-style subquery rewrites, kqp_opt_phy)."""

    select: "Select"


@dataclasses.dataclass(frozen=True)
class InSubquery:
    expr: "Expr"
    select: "Select"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Exists:
    select: "Select"
    negated: bool = False


Expr = Union[Name, Literal, BinOp, UnOp, FuncCall, Between, InList, Like,
             IsNull, Case, ScalarSubquery, InSubquery, Exists]


@dataclasses.dataclass(frozen=True)
class Star:
    """SELECT * (allowed in EXISTS subqueries and plain selects)."""


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: "Expr | Star"
    alias: str | None


@dataclasses.dataclass(frozen=True)
class TableRef:
    name: str
    alias: str | None = None


@dataclasses.dataclass(frozen=True)
class SubquerySource:
    """Derived table: (SELECT ...) AS alias in FROM."""

    select: "Select | UnionAll"
    alias: str


@dataclasses.dataclass(frozen=True)
class Join:
    left: "FromItem"
    right: "TableRef | SubquerySource"
    on: Expr | None
    kind: str = "inner"  # inner | left


FromItem = Union[TableRef, SubquerySource, Join]


@dataclasses.dataclass(frozen=True)
class OrderItem:
    expr: Expr
    descending: bool = False


@dataclasses.dataclass(frozen=True)
class Select:
    items: tuple[SelectItem, ...]
    from_: FromItem | None
    where: Expr | None
    group_by: tuple[Expr, ...]
    having: Expr | None
    order_by: tuple[OrderItem, ...]
    limit: int | None
    distinct: bool = False
    # WITH name AS (select), ...: CTEs usable as FROM sources downstream
    ctes: tuple[tuple[str, "Select"], ...] = ()


@dataclasses.dataclass(frozen=True)
class UnionAll:
    """SELECT ... UNION ALL SELECT ... [ORDER BY ...] [LIMIT n].

    Branch outputs align by POSITION; names come from the first branch
    (SQL standard set-operation semantics). ``distinct`` True models
    plain UNION (duplicate rows collapse). The reference compiles set
    operations into an Extend/UnionAll expression node
    (yql/essentials/core/type_ann/type_ann_list.cpp UnionAll); here the
    planner lowers them to a Concat plan node.
    """

    selects: tuple["Select", ...]
    order_by: tuple[OrderItem, ...] = ()
    limit: int | None = None
    distinct: bool = False


@dataclasses.dataclass(frozen=True)
class Insert:
    table: str
    columns: tuple[str, ...]
    rows: tuple[tuple[Expr, ...], ...]


@dataclasses.dataclass(frozen=True)
class CreateTable:
    table: str
    columns: tuple[tuple[str, str, bool], ...]  # (name, type, not_null)
    primary_key: tuple[str, ...]
    # WITH (store = column|row, shards = N, ttl_column = name)
    options: tuple[tuple[str, str], ...] = ()


@dataclasses.dataclass(frozen=True)
class DropTable:
    table: str


@dataclasses.dataclass(frozen=True)
class Update:
    table: str
    sets: tuple[tuple[str, Expr], ...]
    where: Expr | None


@dataclasses.dataclass(frozen=True)
class Delete:
    table: str
    where: Expr | None


@dataclasses.dataclass(frozen=True)
class AlterTable:
    table: str
    add_columns: tuple[tuple[str, str], ...] = ()  # (name, type)
    drop_columns: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Explain:
    """EXPLAIN [ANALYZE] <select>: return the physical plan. With
    ANALYZE the query actually runs and the plan is annotated with
    measured actuals (per-stage seconds, rows, cache hits)."""

    select: Select
    analyze: bool = False


@dataclasses.dataclass(frozen=True)
class CreateSequence:
    """CREATE SEQUENCE name [START n] [INCREMENT n] [CACHE n]."""

    name: str
    start: int = 1
    increment: int = 1
    cache: int = 100


@dataclasses.dataclass(frozen=True)
class DropSequence:
    name: str


@dataclasses.dataclass(frozen=True)
class Begin:
    """BEGIN: open an interactive transaction on the session."""


@dataclasses.dataclass(frozen=True)
class Commit:
    """COMMIT: apply the transaction's buffered effects atomically."""


@dataclasses.dataclass(frozen=True)
class Rollback:
    """ROLLBACK: discard the transaction's buffered effects."""


Statement = Union[Select, UnionAll, Insert, CreateTable, DropTable,
                  AlterTable, Update, Delete, Explain, Begin, Commit,
                  Rollback, CreateSequence, DropSequence]
