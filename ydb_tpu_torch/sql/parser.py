"""Hand-rolled SQL lexer + recursive-descent parser.

Dialect: the YQL/PostgreSQL-flavored subset the engine executes — SELECT
with expressions/aggregates, multi-way JOIN ... ON, WHERE with
AND/OR/NOT/BETWEEN/IN/LIKE/IS NULL/CASE, GROUP BY, HAVING, ORDER BY ...
[ASC|DESC], LIMIT; INSERT INTO ... VALUES; CREATE TABLE with PRIMARY KEY.
Grammar is layered by precedence (or > and > not > cmp > add > mul >
unary > primary), one function per layer — the shape of the reference's
SQL grammar without the generated-parser machinery (yql/sql/v1).

The port's copy of ``ydb_tpu/sql/parser.py``, unchanged apart from its
imports.
"""

from __future__ import annotations

import dataclasses
import re

from ydb_tpu_torch.sql import ast

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<number>\d+\.\d+|\.\d+|\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=|>=|<>|!=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "between", "in", "like", "is", "null",
    "asc", "desc", "join", "inner", "left", "on", "insert", "upsert",
    "into",
    "values", "create", "table", "primary", "key", "case", "when", "then",
    "else", "end", "date", "interval", "true", "false", "distinct",
    "outer", "exists", "cast", "drop", "alter", "add", "column", "with",
    "update", "set", "delete", "extract", "substring", "for", "explain",
    "begin", "commit", "rollback", "transaction", "union", "all",
    "partition",
}


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind, value, pos):
        self.kind = kind
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.value!r}"


def tokenize(sql: str) -> list[Token]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"bad character {sql[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group()
        if kind == "name":
            low = text.lower()
            if low in _KEYWORDS:
                out.append(Token("kw", low, m.start()))
            else:
                out.append(Token("name", text, m.start()))
        elif kind == "string":
            out.append(Token("string", text[1:-1].replace("''", "'"),
                             m.start()))
        else:
            out.append(Token(kind, text, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers --

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, value=None):
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind, value=None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek()
            want = value or kind
            raise SyntaxError(f"expected {want!r}, got {got.value!r} at "
                              f"position {got.pos}")
        return t

    def kw(self, word) -> bool:
        return self.accept("kw", word) is not None

    # -- statements --

    def parse_statement(self) -> ast.Statement:
        if self.peek().value == "explain":
            self.next()
            # ANALYZE is a soft keyword (stays usable as a column name)
            analyze = False
            t = self.peek()
            if t.kind == "name" and t.value.lower() == "analyze":
                self.next()
                analyze = True
            stmt = ast.Explain(self.parse_select_or_union(),
                               analyze=analyze)
        elif self.peek().value in ("select", "with"):
            stmt = self.parse_select_or_union()
        elif self.peek().value in ("insert", "upsert"):
            stmt = self.parse_insert()
        elif self.peek().value == "begin":
            self.next()
            self.accept("kw", "transaction")
            stmt = ast.Begin()
        elif self.peek().value == "commit":
            self.next()
            stmt = ast.Commit()
        elif self.peek().value == "rollback":
            self.next()
            stmt = ast.Rollback()
        elif self.peek().value == "create":
            stmt = self.parse_create()
        elif self.peek().value == "drop":
            stmt = self.parse_drop()
        elif self.peek().value == "alter":
            stmt = self.parse_alter()
        elif self.peek().value == "update":
            stmt = self.parse_update()
        elif self.peek().value == "delete":
            stmt = self.parse_delete()
        else:
            raise SyntaxError(f"unsupported statement {self.peek().value!r}")
        self.expect("eof")
        return stmt

    def parse_select_or_union(self) -> "ast.Select | ast.UnionAll":
        """A SELECT, or a UNION [ALL] chain of them.

        A trailing ORDER BY / LIMIT parses into the LAST branch; per the
        SQL standard they bind to the whole set operation, so they hoist
        onto the UnionAll node. Mixing UNION and UNION ALL in one chain
        is rejected (the subset keeps one distinct flag per chain).
        """
        first = self.parse_select()
        if self.peek().value != "union":
            return first
        branches = [first]
        kinds = set()
        while self.kw("union"):
            kinds.add("all" if self.kw("all") else "distinct")
            branches.append(self.parse_select())
        if len(kinds) > 1:
            raise SyntaxError(
                "mixed UNION / UNION ALL in one chain is not supported")
        for b in branches[:-1]:
            # standard SQL only allows ORDER BY/LIMIT on the WHOLE set
            # operation (or parenthesized branches, which this subset
            # does not parse); an interior one would otherwise silently
            # stay branch-local
            if b.order_by or b.limit is not None:
                raise SyntaxError(
                    "ORDER BY/LIMIT inside a non-final UNION branch is"
                    " not supported")
        last = branches[-1]
        order, limit = last.order_by, last.limit
        if order or limit is not None:
            branches[-1] = dataclasses.replace(
                last, order_by=(), limit=None)
        return ast.UnionAll(tuple(branches), order, limit,
                            distinct=kinds == {"distinct"})

    def parse_select(self) -> ast.Select:
        ctes: list[tuple[str, ast.Select]] = []
        if self.kw("with"):
            while True:
                name = self.expect("name").value
                self.expect("kw", "as")
                self.expect("op", "(")
                ctes.append((name, self.parse_select_or_union()))
                self.expect("op", ")")
                if not self.accept("op", ","):
                    break
        self.expect("kw", "select")
        distinct = self.kw("distinct")
        items = [self.parse_select_item()]
        while self.accept("op", ","):
            items.append(self.parse_select_item())
        from_ = None
        if self.kw("from"):
            from_ = self.parse_from()
        where = self.parse_expr() if self.kw("where") else None
        group_by: tuple = ()
        if self.kw("group"):
            self.expect("kw", "by")
            gb = [self.parse_expr()]
            while self.accept("op", ","):
                gb.append(self.parse_expr())
            group_by = tuple(gb)
        having = self.parse_expr() if self.kw("having") else None
        order_by: tuple = ()
        if self.kw("order"):
            self.expect("kw", "by")
            ob = [self.parse_order_item()]
            while self.accept("op", ","):
                ob.append(self.parse_order_item())
            order_by = tuple(ob)
        limit = None
        if self.kw("limit"):
            limit = int(self.expect("number").value)
        return ast.Select(tuple(items), from_, where, group_by, having,
                          order_by, limit, distinct, tuple(ctes))

    def parse_select_item(self) -> ast.SelectItem:
        if self.peek().kind == "op" and self.peek().value == "*":
            self.next()
            return ast.SelectItem(ast.Star(), None)
        expr = self.parse_expr()
        alias = None
        if self.kw("as"):
            alias = self.expect("name").value
        elif self.peek().kind == "name":
            alias = self.next().value
        return ast.SelectItem(expr, alias)

    def parse_from(self) -> ast.FromItem:
        left: ast.FromItem = self.parse_table_ref()
        while True:
            kind = None
            if self.kw("join") or self.kw("inner") and self.kw("join"):
                kind = "inner"
            elif self.peek().value == "left":
                self.next()
                self.kw("outer")
                self.expect("kw", "join")
                kind = "left"
            elif self.accept("op", ","):
                # comma join: cross product restricted by WHERE; planner
                # requires equi-conditions there
                right = self.parse_table_ref()
                left = ast.Join(left, right, None, "inner")
                continue
            if kind is None:
                return left
            right = self.parse_table_ref()
            on = None
            if self.kw("on"):
                on = self.parse_expr()
            left = ast.Join(left, right, on, kind)

    def parse_table_ref(self) -> "ast.TableRef | ast.SubquerySource":
        if self.accept("op", "("):
            # derived table: ( SELECT ... ) [AS] alias
            sub = self.parse_select_or_union()
            self.expect("op", ")")
            self.kw("as")
            alias = self.expect("name").value
            return ast.SubquerySource(sub, alias)
        name = self.expect("name").value
        alias = None
        if self.kw("as"):
            alias = self.expect("name").value
        elif self.peek().kind == "name":
            alias = self.next().value
        return ast.TableRef(name, alias)

    def parse_order_item(self) -> ast.OrderItem:
        e = self.parse_expr()
        desc = False
        if self.kw("desc"):
            desc = True
        else:
            self.kw("asc")
        return ast.OrderItem(e, desc)

    def parse_insert(self) -> ast.Insert:
        # UPSERT INTO parses to the same node: the row stores' write
        # path is newest-wins (blind upsert), matching YQL UPSERT
        if not self.accept("kw", "upsert"):
            self.expect("kw", "insert")
        self.expect("kw", "into")
        table = self.expect("name").value
        cols = []
        if self.accept("op", "("):
            cols.append(self.expect("name").value)
            while self.accept("op", ","):
                cols.append(self.expect("name").value)
            self.expect("op", ")")
        self.expect("kw", "values")
        rows = []
        while True:
            self.expect("op", "(")
            row = [self.parse_expr()]
            while self.accept("op", ","):
                row.append(self.parse_expr())
            self.expect("op", ")")
            rows.append(tuple(row))
            if not self.accept("op", ","):
                break
        return ast.Insert(table, tuple(cols), tuple(rows))

    def parse_create(self):
        self.expect("kw", "create")
        if self.peek().kind == "name" and \
                self.peek().value.lower() == "sequence":
            self.next()
            name = self.expect("name").value
            opts = {"start": 1, "increment": 1, "cache": 100}
            while self.peek().kind == "name" and \
                    self.peek().value.lower() in ("start", "increment",
                                                  "cache"):
                key = self.next().value.lower()
                self.accept("kw", "with")
                neg = (self.peek().kind == "op"
                       and self.peek().value == "-"
                       and bool(self.next()))
                val = int(self.expect("number").value)
                opts[key] = -val if neg else val
            return ast.CreateSequence(name, opts["start"],
                                      opts["increment"], opts["cache"])
        self.expect("kw", "table")
        table = self.expect("name").value
        self.expect("op", "(")
        columns = []
        pk: tuple = ()
        while True:
            if self.kw("primary"):
                self.expect("kw", "key")
                self.expect("op", "(")
                names = [self.expect("name").value]
                while self.accept("op", ","):
                    names.append(self.expect("name").value)
                self.expect("op", ")")
                pk = tuple(names)
            else:
                name = self.expect("name").value
                t = self.next()
                if t.kind not in ("name", "kw"):
                    raise SyntaxError(f"expected type after {name}")
                typ = t.value
                if self.accept("op", "("):  # decimal(p, s)
                    p = self.expect("number").value
                    s = "0"
                    if self.accept("op", ","):
                        s = self.expect("number").value
                    self.expect("op", ")")
                    typ = f"{typ}({p},{s})"
                not_null = False
                if self.kw("not"):
                    self.expect("kw", "null")
                    not_null = True
                columns.append((name, typ, not_null))
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        options: list[tuple[str, str]] = []
        if self.kw("with"):
            self.expect("op", "(")
            while True:
                k = self.next()
                if k.kind not in ("name", "kw"):
                    raise SyntaxError("expected option name in WITH")
                self.expect("op", "=")
                v = self.next()
                if v.kind not in ("name", "kw", "number", "string"):
                    raise SyntaxError(f"bad option value for {k.value}")
                options.append((k.value.lower(), str(v.value)))
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        return ast.CreateTable(table, tuple(columns), pk, tuple(options))

    def parse_drop(self):
        self.expect("kw", "drop")
        if self.peek().kind == "name" and \
                self.peek().value.lower() == "sequence":
            self.next()
            return ast.DropSequence(self.expect("name").value)
        self.expect("kw", "table")
        return ast.DropTable(self.expect("name").value)

    def parse_update(self) -> ast.Update:
        self.expect("kw", "update")
        table = self.expect("name").value
        self.expect("kw", "set")
        sets = []
        while True:
            name = self.expect("name").value
            self.expect("op", "=")
            sets.append((name, self.parse_expr()))
            if not self.accept("op", ","):
                break
        where = self.parse_expr() if self.kw("where") else None
        return ast.Update(table, tuple(sets), where)

    def parse_delete(self) -> ast.Delete:
        self.expect("kw", "delete")
        self.expect("kw", "from")
        table = self.expect("name").value
        where = self.parse_expr() if self.kw("where") else None
        return ast.Delete(table, where)

    def parse_alter(self) -> ast.AlterTable:
        self.expect("kw", "alter")
        self.expect("kw", "table")
        table = self.expect("name").value
        add: list[tuple[str, str]] = []
        drop: list[str] = []
        while True:
            if self.kw("add"):
                self.kw("column")
                name = self.expect("name").value
                t = self.next()
                if t.kind not in ("name", "kw"):
                    raise SyntaxError(f"expected type after {name}")
                typ = t.value
                if self.accept("op", "("):
                    p = self.expect("number").value
                    s = "0"
                    if self.accept("op", ","):
                        s = self.expect("number").value
                    self.expect("op", ")")
                    typ = f"{typ}({p},{s})"
                add.append((name, typ))
            elif self.kw("drop"):
                self.kw("column")
                drop.append(self.expect("name").value)
            else:
                raise SyntaxError("expected ADD or DROP in ALTER TABLE")
            if not self.accept("op", ","):
                break
        return ast.AlterTable(table, tuple(add), tuple(drop))

    # -- expressions by precedence --

    def parse_expr(self) -> ast.Expr:
        return self.parse_or()

    def parse_or(self) -> ast.Expr:
        e = self.parse_and()
        while self.kw("or"):
            e = ast.BinOp("or", e, self.parse_and())
        return e

    def parse_and(self) -> ast.Expr:
        e = self.parse_not()
        while self.kw("and"):
            e = ast.BinOp("and", e, self.parse_not())
        return e

    def parse_not(self) -> ast.Expr:
        if self.kw("not"):
            return ast.UnOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ast.Expr:
        e = self.parse_additive()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">",
                                          ">="):
            self.next()
            op = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le",
                  ">": "gt", ">=": "ge"}[t.value]
            return ast.BinOp(op, e, self.parse_additive())
        negated = False
        if t.kind == "kw" and t.value == "not":
            # NOT BETWEEN / NOT IN / NOT LIKE
            nxt = self.toks[self.i + 1]
            if nxt.kind == "kw" and nxt.value in ("between", "in", "like"):
                self.next()
                negated = True
                t = self.peek()
        if t.kind == "kw" and t.value == "between":
            self.next()
            low = self.parse_additive()
            self.expect("kw", "and")
            high = self.parse_additive()
            return ast.Between(e, low, high, negated)
        if t.kind == "kw" and t.value == "in":
            self.next()
            self.expect("op", "(")
            if self.peek().value in ("select", "with"):
                sub = self.parse_select()
                self.expect("op", ")")
                return ast.InSubquery(e, sub, negated)
            items = [self.parse_expr()]
            while self.accept("op", ","):
                items.append(self.parse_expr())
            self.expect("op", ")")
            return ast.InList(e, tuple(items), negated)
        if t.kind == "kw" and t.value == "like":
            self.next()
            pat = self.expect("string").value
            return ast.Like(e, pat, negated)
        if t.kind == "kw" and t.value == "is":
            self.next()
            neg = self.kw("not")
            self.expect("kw", "null")
            return ast.IsNull(e, neg)
        return e

    def parse_additive(self) -> ast.Expr:
        e = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                op = "add" if t.value == "+" else "sub"
                e = ast.BinOp(op, e, self.parse_multiplicative())
            else:
                return e

    def parse_multiplicative(self) -> ast.Expr:
        e = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                op = {"*": "mul", "/": "div", "%": "mod"}[t.value]
                e = ast.BinOp(op, e, self.parse_unary())
            else:
                return e

    def parse_unary(self) -> ast.Expr:
        if self.accept("op", "-"):
            return ast.UnOp("neg", self.parse_unary())
        if self.accept("op", "+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.peek().value in ("select", "with"):
                sub = self.parse_select()
                self.expect("op", ")")
                return ast.ScalarSubquery(sub)
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "number":
            self.next()
            if "." in t.value:
                return ast.Literal(t.value, "decimal")
            return ast.Literal(int(t.value), "int")
        if t.kind == "string":
            self.next()
            return ast.Literal(t.value, "string")
        if t.kind == "kw":
            if t.value == "null":
                self.next()
                return ast.Literal(None, "null")
            if t.value in ("true", "false"):
                self.next()
                return ast.Literal(t.value == "true", "bool")
            if t.value == "date":
                self.next()
                s = self.expect("string").value
                return ast.FuncCall("date", (ast.Literal(s, "string"),))
            if t.value == "interval":
                self.next()
                s = self.expect("string").value
                unit = self.expect("name").value.lower()
                return ast.FuncCall(
                    "interval",
                    (ast.Literal(s, "string"), ast.Literal(unit, "string")),
                )
            if t.value == "exists":
                self.next()
                self.expect("op", "(")
                sub = self.parse_select()
                self.expect("op", ")")
                return ast.Exists(sub)
            if t.value == "extract":
                # extract(year|month from expr)
                self.next()
                self.expect("op", "(")
                part = self.next().value.lower()
                self.expect("kw", "from")
                e = self.parse_expr()
                self.expect("op", ")")
                return ast.FuncCall(part, (e,))
            if t.value == "substring":
                # substring(x, start, len) | substring(x from start for len)
                self.next()
                self.expect("op", "(")
                e = self.parse_expr()
                if self.kw("from"):
                    start = self.parse_expr()
                    self.expect("kw", "for")
                    length = self.parse_expr()
                else:
                    self.expect("op", ",")
                    start = self.parse_expr()
                    self.expect("op", ",")
                    length = self.parse_expr()
                self.expect("op", ")")
                return ast.FuncCall("substring", (e, start, length))
            if t.value == "case":
                return self.parse_case()
            if t.value == "cast":
                self.next()
                self.expect("op", "(")
                e = self.parse_expr()
                self.expect("kw", "as")
                typ = self.next().value
                self.expect("op", ")")
                return ast.FuncCall(f"cast_{typ.lower()}", (e,))
        if t.kind == "name":
            self.next()
            if self.peek().kind == "op" and self.peek().value == "(":
                self.next()
                if self.accept("op", "*"):
                    self.expect("op", ")")
                    return ast.FuncCall(t.value.lower(), (), star=True)
                distinct = self.kw("distinct")
                args = []
                if not (self.peek().kind == "op" and self.peek().value == ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                self.expect("op", ")")
                fc = ast.FuncCall(t.value.lower(), tuple(args),
                                  distinct=distinct)
                if str(self.peek().value).lower() == "over":
                    if fc.name in ("rank", "dense_rank", "row_number") \
                            and (fc.args or fc.distinct or fc.star):
                        # the reference rejects these at translation
                        # time too; silently dropping the argument list
                        # would rewrite the query's meaning
                        found = ("DISTINCT" if fc.distinct else
                                 "*" if fc.star else
                                 f"{len(fc.args)} argument(s)")
                        raise SyntaxError(
                            f"window function {fc.name}() takes no"
                            f" arguments and no DISTINCT/*; found"
                            f" {found} at {t.pos}")
                    self.next()
                    self.expect("op", "(")
                    partition: list = []
                    if self.kw("partition"):
                        self.expect("kw", "by")
                        partition.append(self.parse_expr())
                        while self.accept("op", ","):
                            partition.append(self.parse_expr())
                    order: list = []
                    if self.kw("order"):
                        self.expect("kw", "by")
                        order.append(self.parse_order_item())
                        while self.accept("op", ","):
                            order.append(self.parse_order_item())
                    self.expect("op", ")")
                    return ast.WindowCall(fc.name, tuple(partition),
                                          tuple(order))
                return fc
            parts = [t.value]
            while self.accept("op", "."):
                parts.append(self.expect("name").value)
            return ast.Name(tuple(parts))
        raise SyntaxError(f"unexpected token {t.value!r} at {t.pos}")

    def parse_case(self) -> ast.Case:
        self.expect("kw", "case")
        whens = []
        while self.kw("when"):
            cond = self.parse_expr()
            self.expect("kw", "then")
            val = self.parse_expr()
            whens.append((cond, val))
        else_ = None
        if self.kw("else"):
            else_ = self.parse_expr()
        self.expect("kw", "end")
        return ast.Case(tuple(whens), else_)


def parse(sql: str) -> ast.Statement:
    return Parser(sql).parse_statement()
