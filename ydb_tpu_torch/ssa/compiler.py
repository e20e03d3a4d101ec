"""SSA program -> one eager torch function over a TableBlock.

The counterpart of ``ydb_tpu/ssa/compiler.py`` (the analog of the
reference's program parse + apply pipeline,
ydb/core/tx/program/program.cpp:553 and TProgramStep::Apply
formats/arrow/program.h:394). Compilation resolves string predicates
against host dictionaries into small lookup tables ("aux inputs"), picks
dense vs sort-based group-id assignment from key cardinalities, and
fixes the output schema — identically to the JAX package, so both give
the same ``group_layout`` and output schema for a program. The result is
``run(block, aux) -> block``: plain torch operations on the block's
device, run eagerly (there is no trace), none of which waits for the
device — except a ``UdfCall``, whose user function runs on the host
between two device operations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.block import Column, TableBlock, device_aux
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.ssa import kernels
from ydb_tpu_torch.ssa.kernels import floordiv
from ydb_tpu_torch.ssa.ops import Agg, Op
from ydb_tpu_torch.ssa.program import (
    AggSpec,
    AssignStep,
    Call,
    Col,
    Const,
    DictMap,
    DictPredicate,
    Expr,
    FilterStep,
    GroupByStep,
    ProjectStep,
    Program,
    SortStep,
    UdfCall,
    WindowStep,
    agg_result_type,
    infer_type,
)

@dataclasses.dataclass
class CompiledProgram:
    """A lowered program plus its plan-time inputs.

    ``group_layout`` describes the group-by output layout:
      ("keyless", 1)      — single-row global aggregate
      ("dense", n)        — dense ids, compacted but shape-stable (n slots)
      ("compact", None)   — compacted rows
      (None, None)        — no group-by in the program
    """

    run: Callable  # (TableBlock, dict[str, torch.Tensor]) -> TableBlock
    aux: dict[str, np.ndarray]  # plan-time tables (dict masks etc.)
    out_schema: dtypes.Schema
    in_schema: dtypes.Schema
    group_layout: tuple = (None, None)
    # aux staged once per device, on first call
    _staged: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    def __call__(self, block: TableBlock) -> TableBlock:
        dev = block.device
        if dev not in self._staged:
            self._staged[dev] = device_aux(self.aux, dev)
        return self.run(block, self._staged[dev])


class _Lowering:
    """Single-pass lowering context (types + aux tables)."""

    def __init__(self, schema: dtypes.Schema, dicts: DictionarySet | None,
                 key_spaces: dict[str, int] | None,
                 dict_aliases: dict[str, str] | None = None):
        self.schema = schema
        self.dicts = dicts
        self.key_spaces = dict(key_spaces or {})
        # column -> source column whose dictionary it carries (aggregate
        # outputs like MIN(s) AS lo keep s's dictionary)
        self.dict_aliases = dict(dict_aliases or {})
        self.group_layout: tuple = (None, None)
        self.types: dict[str, dtypes.LogicalType] = {
            f.name: f.type for f in schema.fields
        }
        self.aux: dict[str, np.ndarray] = {}
        self._aux_n = 0

    def add_aux(self, prefix: str, table: np.ndarray) -> str:
        key = f"{prefix}#{self._aux_n}"
        self._aux_n += 1
        self.aux[key] = table
        return key

    def dictionary(self, name: str):
        """Dictionary for a (possibly renamed) string column, or None."""
        if self.dicts is None:
            return None
        src = self.dict_aliases.get(name, name)
        return self.dicts[src] if src in self.dicts else None

    def key_bound(self, name: str, t: dtypes.LogicalType) -> int | None:
        """Static cardinality bound for a group-by key column, if known."""
        if t.kind == dtypes.Kind.BOOL:
            return 2
        if t.is_string:
            d = self.dictionary(name)
            if d is not None:
                return len(d)
        return self.key_spaces.get(name)


def _compile_program(
    program: Program,
    schema: dtypes.Schema,
    dicts: DictionarySet | None = None,
    key_spaces: dict[str, int] | None = None,
    partial_slots: bool = False,
    dict_aliases: dict[str, str] | None = None,
) -> CompiledProgram:
    """The span-free lowering entry point that whole-plan fusion
    (``ssa/plan_fuse.py``) calls for every fragment, with the reference's
    signature. The port has no tracing spans yet, so it is
    ``compile_program``; the ``partial_slots`` layout (dense group-by
    states kept in their slots) comes with the mesh executor."""
    if partial_slots:
        raise NotImplementedError(
            "partial_slots (the dense_slots group-by layout) is not in the "
            "port yet")
    return compile_program(program, schema, dicts, key_spaces,
                           dict_aliases=dict_aliases)


def compile_program(
    program: Program,
    schema: dtypes.Schema,
    dicts: DictionarySet | None = None,
    key_spaces: dict[str, int] | None = None,
    dict_aliases: dict[str, str] | None = None,
) -> CompiledProgram:
    # mandatory precondition: no program reaches the lowering unverified
    # (lazy import: the verifier's program imports would re-enter
    # ydb_tpu_torch.ssa mid-init)
    from ydb_tpu_torch.analysis import verify as _verify

    out_nullable = _verify.check_program(program, schema).out_nullable
    ctx = _Lowering(schema, dicts, key_spaces, dict_aliases)

    # ---- static pass: resolve plan, types, aux tables, output schema ----
    plan: list = []
    cur_types = dict(ctx.types)
    cur_names = list(schema.names)
    cur_nullable = {f.name: f.nullable for f in schema.fields}

    def resolve_expr(expr: Expr):
        """Return (lower_fn(env, aux) -> Column, LogicalType)."""
        if isinstance(expr, Col):
            t = cur_types[expr.name]
            name = expr.name
            return (lambda env, aux: env[name]), t
        if isinstance(expr, Const):
            t = expr.type
            val = expr.value

            def lower_const(env, aux, _t=t, _v=val):
                any_col = next(iter(env.values()))
                n = any_col.data.shape[0]
                dev = any_col.data.device
                tdt = dtypes.torch_dtype(_t)
                if _v is None:  # typed NULL (CASE without ELSE)
                    return Column(torch.zeros((n,), dtype=tdt, device=dev),
                                  torch.zeros((n,), dtype=torch.bool,
                                              device=dev))
                return Column(torch.full((n,), _v, dtype=tdt, device=dev),
                              torch.ones((n,), dtype=torch.bool, device=dev))

            return lower_const, t
        if isinstance(expr, DictPredicate):
            return _resolve_dict_predicate(ctx, expr, cur_types)
        if isinstance(expr, DictMap):
            return _resolve_dict_map(ctx, expr, cur_types)
        if isinstance(expr, UdfCall):
            return _resolve_udf(expr, resolve_expr)
        assert isinstance(expr, Call)
        return _resolve_call(ctx, expr, cur_types, resolve_expr)

    for step in program.steps:
        if isinstance(step, AssignStep):
            fn, t = resolve_expr(step.expr)
            cur_types[step.name] = t
            cur_nullable[step.name] = _verify.infer_nullable(
                step.expr, cur_nullable)
            if step.name not in cur_names:
                cur_names.append(step.name)
            plan.append(("assign", (step.name, fn)))
        elif isinstance(step, FilterStep):
            fn, t = resolve_expr(step.expr)
            if t.kind != dtypes.Kind.BOOL:
                raise TypeError(f"filter predicate must be bool, got {t}")
            plan.append(("filter", fn))
        elif isinstance(step, GroupByStep):
            lowered = _resolve_group_by(ctx, step, cur_types, cur_nullable)
            plan.append(("group_by", lowered))
            cur_names = list(lowered.out_names)
            cur_types = dict(lowered.out_types)
            cur_nullable = {n: True for n in cur_names}
        elif isinstance(step, ProjectStep):
            missing = [n for n in step.names if n not in cur_types]
            if missing:
                raise KeyError(f"projection of unknown columns {missing}")
            cur_names = list(step.names)
            plan.append(("project", tuple(step.names)))
        elif isinstance(step, SortStep):
            desc = step.descending or (False,) * len(step.keys)
            # string keys order by dictionary *rank*, not id
            ranks = []
            for k in step.keys:
                t = cur_types[k]
                if t.is_string:
                    d = ctx.dictionary(k)
                    if d is None:
                        raise ValueError(
                            f"ORDER BY on string column {k} needs its"
                            " dictionary")
                    ranks.append(ctx.add_aux(f"rank.{k}", d.sort_rank()))
                else:
                    ranks.append(None)
            plan.append(
                ("sort", (tuple(step.keys), tuple(desc), step.limit,
                          tuple(ranks))))
        elif isinstance(step, WindowStep):
            if step.func not in ("rank", "dense_rank", "row_number"):
                raise NotImplementedError(
                    f"window function {step.func}")
            # string keys compare by dictionary RANK (partition needs
            # only equality, but ranks are equality-preserving too, so
            # one treatment covers both roles)
            wranks = []
            for k in step.partition + step.order_keys:
                t = cur_types[k]
                if t.is_string:
                    d = ctx.dictionary(k)
                    if d is None:
                        raise ValueError(
                            f"window key on string column {k} needs"
                            " its dictionary")
                    wranks.append(
                        ctx.add_aux(f"wrank.{k}", d.sort_rank()))
                else:
                    wranks.append(None)
            desc = step.descending or (False,) * len(step.order_keys)
            cur_types[step.out_name] = dtypes.INT64
            if step.out_name not in cur_names:
                cur_names.append(step.out_name)
            plan.append(("window", (
                step.func, tuple(step.partition),
                tuple(step.order_keys), tuple(desc), tuple(wranks),
                step.out_name)))
        else:
            raise NotImplementedError(f"step {step}")

    out_schema = dtypes.Schema(
        tuple(dtypes.Field(n, cur_types[n], out_nullable.get(n, True))
              for n in cur_names)
    )

    # ---- run-time pass ----
    def run(block: TableBlock, aux: dict[str, torch.Tensor]) -> TableBlock:
        env: dict[str, Column] = dict(block.columns)
        mask = block.row_mask()
        length = block.length
        names = list(block.columns.keys())

        for kind, payload in plan:
            if kind == "assign":
                name, fn = payload
                env[name] = fn(env, aux)
                if name not in names:
                    names.append(name)
            elif kind == "filter":
                # mask-only (late materialization); `length` keeps the live
                # range until a compaction point (group_by/sort/output)
                mask = mask & kernels.pred_mask(payload(env, aux))
            elif kind == "project":
                names = list(payload)
                env = {n: env[n] for n in names}
            elif kind == "group_by":
                gb = payload
                env, length = gb.lower(env, aux, mask)
                names = list(gb.out_names)
                cap = next(iter(env.values())).data.shape[0]
                mask = torch.arange(cap, dtype=torch.int32,
                                    device=length.device) < length
            elif kind == "sort":
                keys, desc, limit, ranks = payload
                cols = {n: env[n] for n in names}
                sort_cols = []
                for k, rk in zip(keys, ranks):
                    c = cols[k] if k in cols else env[k]
                    if rk is not None:
                        c = kernels.dict_gather(aux[rk], c)
                    sort_cols.append(c)
                tmp_names = list(names)
                for i, c in enumerate(sort_cols):
                    cols[f"__sort{i}"] = c
                    tmp_names.append(f"__sort{i}")
                blk = TableBlock(
                    cols, length,
                    dtypes.Schema(tuple(
                        dtypes.Field(n, cur_types.get(n, dtypes.INT64))
                        for n in tmp_names)),
                )
                # one sort pass: the filter mask rides in as `live`
                # (non-selected rows sink past the length cut)
                blk = kernels.sort_block(
                    blk, [f"__sort{i}" for i in range(len(keys))],
                    list(desc), limit, live=mask)
                env = {n: blk.columns[n] for n in names}
                length = blk.length
                mask = blk.row_mask()
            elif kind == "window":
                out_name = payload[-1]
                env[out_name] = _window(env, aux, mask, length, payload)
                if out_name not in names:
                    names.append(out_name)
        out_cols = {n: env[n] for n in out_schema.names}
        blk = TableBlock(out_cols, length, out_schema)
        return kernels.compact(blk, mask)

    return CompiledProgram(run=run, aux=ctx.aux, out_schema=out_schema,
                           in_schema=schema, group_layout=ctx.group_layout)


def _window(env, aux, mask, length, payload) -> Column:
    """rank / dense_rank / row_number over (partition, order keys): one
    lexsort (liveness, then partition, then order keys), segment starts
    by a running max, and a scatter back through the sort permutation.
    Rows masked by an earlier filter sort last and take no rank."""
    func, pkeys, okeys, desc, wranks, _ = payload
    cap = next(iter(env.values())).data.shape[0]
    dev = mask.device
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    live = mask & (idx < length)
    vals = []
    for k, rk in zip(pkeys + okeys, wranks):
        c = env[k]
        if rk is not None:
            c = kernels.dict_gather(aux[rk], c)
        d = c.data
        if d.dtype == torch.bool:
            d = d.to(torch.int32)
        vals.append(d)
    pvals = vals[:len(pkeys)]
    ovals = [-d if dsc else d for d, dsc in zip(vals[len(pkeys):], desc)]
    # _lexsort: LAST key is primary — liveness first, then partition,
    # then order keys
    perm = kernels._lexsort(list(reversed(
        [(~live).to(torch.int32)] + pvals + ovals)))

    def changed(cols_sorted):
        ch = idx == 0
        for c in cols_sorted:
            ch = ch | (c != torch.roll(c, 1))
        return ch

    new_part = changed([c[perm] for c in pvals])
    new_order = new_part | changed([c[perm] for c in ovals])
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    seg_start = torch.cummax(torch.where(new_part, idx, zero), 0).values
    if func == "row_number":
        out_sorted = idx - seg_start + 1
    elif func == "rank":
        peer_start = torch.cummax(
            torch.where(new_order, idx, zero), 0).values
        out_sorted = peer_start - seg_start + 1
    else:  # dense_rank
        dense = torch.cumsum(new_order.to(torch.int64), 0)
        out_sorted = dense - dense[seg_start] + 1
    out = torch.zeros(cap, dtype=torch.int64, device=dev)
    out[perm] = out_sorted
    return Column(out, live)


def _resolve_udf(expr: UdfCall, resolve_expr):
    """A scalar UDF: the argument columns go to the host, the user
    function runs over numpy arrays there, and its result comes back to
    the block's device. Valid where every argument is valid."""
    arg_fns = tuple(resolve_expr(a)[0] for a in expr.args)
    out_dtype = expr.out_type.physical
    user_fn = expr.fn

    def lower_udf(env, aux):
        cols = [f(env, aux) for f in arg_fns]
        valid = cols[0].validity
        for c in cols[1:]:
            valid = valid & c.validity
        host = [c.data.cpu().numpy() for c in cols]
        res = np.asarray(user_fn(*host), dtype=out_dtype)
        return Column(torch.as_tensor(res, device=valid.device), valid)

    return lower_udf, expr.out_type


# ---------------- expression lowering helpers ----------------


def _resolve_dict_predicate(ctx: _Lowering, p: DictPredicate, cur_types):
    t = cur_types[p.column]
    if not t.is_string:
        raise TypeError(f"dict predicate on non-string column {p.column}")
    d = ctx.dictionary(p.column)
    if d is None:
        raise ValueError(f"no dictionary for column {p.column}")
    if p.kind in ("eq", "ne"):
        want = d.eq_id(p.pattern)
        table = np.zeros(max(len(d), 1), dtype=np.bool_)
        if want >= 0:
            table[want] = True
        if p.kind == "ne":
            table = ~table
    elif p.kind == "like":
        table = d.like_mask(p.pattern)
    elif p.kind == "prefix":
        table = d.prefix_mask(p.pattern)
    elif p.kind in ("in_set", "not_in_set"):
        table = np.zeros(max(len(d), 1), dtype=np.bool_)
        for v in p.pattern:
            i = d.eq_id(v)
            if i >= 0:
                table[i] = True
        if p.kind == "not_in_set":
            table = ~table
    elif p.kind == "custom":
        table = _custom_dict_mask(d, p.pattern)
    else:
        raise NotImplementedError(f"dict predicate kind {p.kind}")
    if table.size == 0:
        table = np.zeros(1, dtype=np.bool_)
    key = ctx.add_aux(f"dict.{p.column}.{p.kind}", table)
    col = p.column

    def lower(env, aux, _key=key, _col=col):
        return kernels.dict_gather(aux[_key], env[_col])

    return lower, dtypes.BOOL


def dict_map_table(d, out_d, kind: str, args: tuple) -> np.ndarray:
    """id->id gather table for a string transform: apply the transform to
    every dictionary value, register results in the output dictionary.
    Shared by the lowering and the CPU oracle (identical id assignment:
    first-seen order over the source dictionary)."""
    if kind == "substr":
        start, length = args  # SQL 1-based start
        lo = start - 1
        out = [out_d.add(v[lo:lo + length]) for v in d.values]
    elif kind == "upper":
        out = [out_d.add(v.upper()) for v in d.values]
    elif kind == "lower":
        out = [out_d.add(v.lower()) for v in d.values]
    elif kind == "trim":
        out = [out_d.add(v.strip()) for v in d.values]
    elif kind == "ltrim":
        out = [out_d.add(v.lstrip()) for v in d.values]
    elif kind == "rtrim":
        out = [out_d.add(v.rstrip()) for v in d.values]
    elif kind == "replace":
        old, new = args
        out = [out_d.add(v.replace(old, new)) for v in d.values]
    elif kind == "concat_suffix":
        (lit,) = args
        out = [out_d.add(v + lit) for v in d.values]
    elif kind == "concat_prefix":
        (lit,) = args
        out = [out_d.add(lit + v) for v in d.values]
    elif kind == "gethost":
        # URL -> host part (Url::GetHost): strip scheme, path, query
        def _host(v: bytes) -> bytes:
            s = v.split(b"://", 1)[-1]
            return s.split(b"/", 1)[0].split(b"?", 1)[0]

        out = [out_d.add(_host(v)) for v in d.values]
    elif kind == "cutwww":
        # Url::CutWWW: drop one leading "www." if present
        out = [out_d.add(v[4:] if v.startswith(b"www.") else v)
               for v in d.values]
    elif kind == "strlen":
        # int output: byte length per dictionary value (no out dict)
        out = [len(v) for v in d.values]
    elif kind == "xrank":
        # cross-dictionary compare: rank each value within the sorted
        # union of this column's and the peer column's dictionaries
        # (out_d here is the PEER dictionary, not an output dict)
        ranks = {v: i for i, v in enumerate(
            sorted(set(d.values) | set(out_d.values)))}
        out = [ranks[v] for v in d.values]
    else:
        raise NotImplementedError(f"dict map kind {kind}")
    return np.asarray(out or [0], dtype=np.int32)


def _resolve_dict_map(ctx: _Lowering, m: DictMap, cur_types):
    t = cur_types[m.column]
    if not t.is_string:
        raise TypeError(f"dict map on non-string column {m.column}")
    d = ctx.dictionary(m.column)
    if d is None:
        raise ValueError(f"no dictionary for column {m.column}")
    if ctx.dicts is None:
        raise ValueError("dict map needs a shared DictionarySet")
    # for "xrank" out_column names the PEER dictionary (already
    # registered) and the result is an int rank, not a string
    out_d = ctx.dicts.for_column(m.out_column)
    table = dict_map_table(d, out_d, m.kind, m.args)
    key = ctx.add_aux(f"map.{m.column}.{m.kind}", table)
    col = m.column

    def lower(env, aux, _key=key, _col=col):
        return kernels.dict_gather(aux[_key], env[_col])

    return lower, (dtypes.INT32 if m.kind in ("xrank", "strlen")
                   else dtypes.STRING)


def _custom_dict_mask(d, pattern) -> np.ndarray:
    """Plan-time masks beyond the fixed kinds. ("ord", op, val) = ordered
    byte-string comparison evaluated over the dictionary values."""
    from ydb_tpu_torch.blocks.dictionary import _as_bytes

    tag = pattern[0]
    if tag == "ord":
        _, op, val = pattern
        val = _as_bytes(val)
        cmp = {
            "lt": lambda v: v < val,
            "le": lambda v: v <= val,
            "gt": lambda v: v > val,
            "ge": lambda v: v >= val,
        }[op]
        return d.match_mask(cmp)
    if tag == "suffix":
        _, val = pattern
        val = _as_bytes(val)
        return d.match_mask(lambda v: v.endswith(val))
    raise NotImplementedError(f"custom dict predicate {tag}")


def _inexact(x: torch.Tensor) -> torch.Tensor:
    """The float type the reference's math ops compute an input in: floats
    stay, 64-bit ints widen to float64, narrower ints/bools to float32."""
    if x.is_floating_point():
        return x
    if x.dtype in (torch.int64, torch.uint64):
        return x.to(torch.float64)
    return x.to(torch.float32)


def _float_op(f):
    """Float-domain math over any numeric input, in the reference's types."""
    return lambda *xs: f(*(_inexact(x) for x in xs))


def _as_f64(f):
    """Float-domain math over any numeric input: cast to f64 first."""
    return lambda *xs: f(*(x.to(torch.float64) for x in xs))


def _int_noop(f):
    """Rounding ops return integer inputs unchanged (as the reference)."""
    return lambda a: f(a) if a.is_floating_point() else a.clone()


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_SIMPLE_BINOPS = {
    Op.EQ: lambda a, b: a == b,
    Op.NE: lambda a, b: a != b,
    Op.LT: lambda a, b: a < b,
    Op.LE: lambda a, b: a <= b,
    Op.GT: lambda a, b: a > b,
    Op.GE: lambda a, b: a >= b,
    Op.ADD: lambda a, b: a + b,
    Op.SUB: lambda a, b: a - b,
    Op.MUL: lambda a, b: a * b,
    Op.XOR: lambda a, b: a ^ b,
    Op.GREATEST: torch.maximum,
    Op.LEAST: torch.minimum,
    Op.ATAN2: _as_f64(torch.atan2),
    Op.HYPOT: _as_f64(torch.hypot),
    Op.BIT_AND: lambda a, b: a & b,
    Op.BIT_OR: lambda a, b: a | b,
    Op.BIT_XOR: lambda a, b: a ^ b,
    Op.SHIFT_LEFT: lambda a, b: a << b,
    Op.SHIFT_RIGHT: lambda a, b: a >> b,
}

_SIMPLE_UNOPS = {
    Op.NOT: lambda a: ~a,
    Op.NEG: lambda a: -a,
    Op.ABS: torch.abs,
    Op.SQRT: _float_op(torch.sqrt),
    Op.EXP: _float_op(torch.exp),
    Op.LN: _float_op(torch.log),
    Op.LOG10: _float_op(lambda a: torch.log(a) / np.log(10.0)),
    Op.FLOOR: _int_noop(torch.floor),
    Op.CEIL: _int_noop(torch.ceil),
    Op.ROUND: _int_noop(torch.round),
    Op.SIGN: torch.sign,
    Op.SIN: _as_f64(torch.sin),
    Op.COS: _as_f64(torch.cos),
    Op.TAN: _as_f64(torch.tan),
    Op.ASIN: _as_f64(torch.asin),
    Op.ACOS: _as_f64(torch.acos),
    Op.ATAN: _as_f64(torch.atan),
    Op.SINH: _as_f64(torch.sinh),
    Op.COSH: _as_f64(torch.cosh),
    Op.TANH: _as_f64(torch.tanh),
    Op.ASINH: _as_f64(torch.asinh),
    Op.ACOSH: _as_f64(torch.acosh),
    Op.ATANH: _as_f64(torch.atanh),
    Op.CBRT: _as_f64(_cbrt),
    Op.ERF: _as_f64(torch.special.erf),
    Op.LOG2: _as_f64(torch.log2),
    Op.EXP2: _as_f64(torch.exp2),
    Op.TRUNC: _as_f64(torch.trunc),
    Op.RINT: _as_f64(torch.round),
    Op.RADIANS: _as_f64(torch.deg2rad),
    Op.DEGREES: _as_f64(torch.rad2deg),
    Op.BIT_NOT: lambda a: ~a,
}


def _resolve_call(ctx: _Lowering, call: Call, cur_types, resolve_expr):
    op = call.op
    resolved = [resolve_expr(a) for a in call.args]
    fns = [r[0] for r in resolved]
    ts = [r[1] for r in resolved]
    out_t = infer_type(call, ctx.schema, cur_types)

    # mixed decimal x float: descale the decimal side to float
    if op in (Op.ADD, Op.SUB, Op.MUL, Op.EQ, Op.NE, Op.LT, Op.LE, Op.GT,
              Op.GE, Op.DIV, Op.GREATEST, Op.LEAST):
        fns, ts = _descale_mixed(fns, ts)
    # rescale decimal operands to a common scale for add/sub/compare
    if op in (Op.ADD, Op.SUB, Op.EQ, Op.NE, Op.LT, Op.LE, Op.GT, Op.GE,
              Op.MOD, Op.GREATEST, Op.LEAST):
        fns, ts = _align_decimals(op, call, fns, ts)

    if op in _SIMPLE_BINOPS and len(fns) == 2:
        f = _SIMPLE_BINOPS[op]
        fa, fb = fns

        def lower(env, aux, _f=f, _fa=fa, _fb=fb):
            return kernels.binop(_f, _fa(env, aux), _fb(env, aux))

        return lower, out_t
    if op in _SIMPLE_UNOPS and len(fns) == 1:
        f = _SIMPLE_UNOPS[op]
        fa = fns[0]

        def lower(env, aux, _f=f, _fa=fa):
            return kernels.unop(_f, _fa(env, aux))

        return lower, out_t
    if op is Op.AND:
        fa, fb = fns

        def lower(env, aux, _fa=fa, _fb=fb):
            return kernels.kleene_and(_fa(env, aux), _fb(env, aux))

        return lower, out_t
    if op is Op.OR:
        fa, fb = fns

        def lower(env, aux, _fa=fa, _fb=fb):
            return kernels.kleene_or(_fa(env, aux), _fb(env, aux))

        return lower, out_t
    if op is Op.DIV:
        fa, fb = fns
        ta, tb = ts[0], ts[1]
        as_float = out_t.is_floating
        sa = 10.0 ** ta.scale if ta.is_decimal else 1.0
        sb = 10.0 ** tb.scale if tb.is_decimal else 1.0

        def lower(env, aux, _fa=fa, _fb=fb, _sa=sa, _sb=sb, _ff=as_float):
            a, b = _fa(env, aux), _fb(env, aux)
            if _ff and (_sa != 1.0 or _sb != 1.0):
                a = Column(a.data.to(torch.float64) / _sa, a.validity)
                b = Column(b.data.to(torch.float64) / _sb, b.validity)
            elif _ff:
                a = Column(a.data.to(torch.float64), a.validity)
            return kernels.safe_div(a, b, _ff)

        return lower, out_t
    if op is Op.MOD:
        fa, fb = fns

        def lower(env, aux, _fa=fa, _fb=fb):
            a, b = _fa(env, aux), _fb(env, aux)
            zero = b.data == 0
            denom = torch.where(zero, torch.ones_like(b.data), b.data)
            return Column(
                kernels.trunc_mod(a.data, denom),
                a.validity & b.validity & ~zero,
            )

        return lower, out_t
    if op is Op.POW:
        fa, fb = fns

        def lower(env, aux, _fa=fa, _fb=fb):
            a, b = _fa(env, aux), _fb(env, aux)
            return Column(
                torch.pow(a.data.to(torch.float64), b.data.to(torch.float64)),
                a.validity & b.validity,
            )

        return lower, out_t
    if op is Op.IS_NULL:
        fa = fns[0]

        def lower(env, aux, _fa=fa):
            a = _fa(env, aux)
            return Column(~a.validity, torch.ones_like(a.validity))

        return lower, out_t
    if op is Op.IS_NOT_NULL:
        fa = fns[0]

        def lower(env, aux, _fa=fa):
            a = _fa(env, aux)
            return Column(a.validity, torch.ones_like(a.validity))

        return lower, out_t
    if op is Op.COALESCE:
        def lower(env, aux, _fns=tuple(fns)):
            cols = [f(env, aux) for f in _fns]
            data = cols[-1].data
            valid = cols[-1].validity
            for c in reversed(cols[:-1]):
                data = torch.where(c.validity, c.data, data)
                valid = c.validity | valid
            return Column(data, valid)

        return lower, out_t
    if op is Op.IF:
        fc, fa, fb = fns

        def lower(env, aux, _fc=fc, _fa=fa, _fb=fb):
            c, a, b = _fc(env, aux), _fa(env, aux), _fb(env, aux)
            take_a = kernels.pred_mask(c)
            return Column(
                torch.where(take_a, a.data, b.data),
                c.validity & torch.where(take_a, a.validity, b.validity),
            )

        return lower, out_t
    if op in (Op.CAST_INT32, Op.CAST_INT64, Op.CAST_FLOAT,
              Op.CAST_DOUBLE, Op.CAST_INT8, Op.CAST_INT16,
              Op.CAST_UINT64, Op.CAST_BOOL):
        fa = fns[0]
        ta = ts[0]
        scale = 10.0 ** ta.scale if ta.is_decimal else None
        target = dtypes.torch_dtype(out_t)

        def lower(env, aux, _fa=fa, _sc=scale, _tp=target):
            a = _fa(env, aux)
            d = a.data
            if _sc is not None:
                if _tp.is_floating_point:
                    d = d.to(torch.float64) / _sc
                else:
                    d = floordiv(d, int(_sc))
            return Column(d.to(_tp), a.validity)

        return lower, out_t
    if op in (Op.YEAR, Op.MONTH, Op.DAY):
        fa = fns[0]
        is_ts = ts[0].kind == dtypes.Kind.TIMESTAMP
        part = {Op.YEAR: 0, Op.MONTH: 1, Op.DAY: 2}[op]

        def lower(env, aux, _fa=fa, _ts=is_ts, _p=part):
            a = _fa(env, aux)
            days = floordiv(a.data, 86_400_000_000) if _ts else a.data
            return Column(kernels.civil_from_days(days)[_p], a.validity)

        return lower, out_t
    if op in (Op.HOUR, Op.MINUTE, Op.SECOND):
        fa = fns[0]
        if ts[0].kind != dtypes.Kind.TIMESTAMP:
            raise TypeError(f"{op} needs a timestamp operand")
        div = {Op.HOUR: 3_600_000_000, Op.MINUTE: 60_000_000,
               Op.SECOND: 1_000_000}[op]
        mod = 24 if op is Op.HOUR else 60

        def lower(env, aux, _fa=fa, _d=div, _m=mod):
            a = _fa(env, aux)
            return Column(
                torch.remainder(floordiv(a.data, _d), _m).to(torch.int32),
                a.validity)

        return lower, out_t
    if op in (Op.DAY_OF_WEEK, Op.DAY_OF_YEAR, Op.WEEK, Op.QUARTER):
        fa = fns[0]
        is_ts = ts[0].kind == dtypes.Kind.TIMESTAMP

        def lower(env, aux, _fa=fa, _ts=is_ts, _op=op):
            a = _fa(env, aux)
            days = floordiv(a.data, 86_400_000_000) if _ts else a.data
            days = days.to(torch.int64)
            if _op is Op.DAY_OF_WEEK:
                out = torch.remainder(days + 4, 7)  # 1970-01-01 = Thursday
            elif _op is Op.QUARTER:
                _y, m, _d = kernels.civil_from_days(days)
                out = floordiv(m - 1, 3) + 1
            else:
                y, _m, _d = kernels.civil_from_days(days)
                doy = days - kernels.days_from_civil(
                    y, torch.ones_like(y), torch.ones_like(y)) + 1
                out = doy if _op is Op.DAY_OF_YEAR else floordiv(doy - 1, 7) + 1
            return Column(out.to(torch.int32), a.validity)

        return lower, out_t
    if op is Op.DIV_INT:
        fa, fb = fns
        ta, tb = ts[0], ts[1]
        sa = 10.0 ** ta.scale if ta.is_decimal else 1.0
        sb = 10.0 ** tb.scale if tb.is_decimal else 1.0
        descale = (ta.is_decimal or tb.is_decimal or ta.is_floating
                   or tb.is_floating)

        def lower(env, aux, _fa=fa, _fb=fb, _sa=sa, _sb=sb,
                  _ds=descale):
            a, b = _fa(env, aux), _fb(env, aux)
            if _ds:
                # integer division of the VALUES: descale, divide,
                # truncate toward zero -> int64
                zero = b.data == 0
                av = a.data.to(torch.float64) / _sa
                bv = torch.where(zero, 1.0, b.data.to(torch.float64) / _sb)
                q = torch.trunc(av / bv).to(torch.int64)
                return Column(q, a.validity & b.validity & ~zero)
            return kernels.safe_div(a, b, False)

        return lower, out_t
    if op is Op.NULLIF:
        fa, fb = fns
        ta, tb = ts[0], ts[1]
        # compare in VALUE space (scale-aligned decimals / descaled
        # floats) but return a's ORIGINAL data + type
        sa = ta.scale if ta.is_decimal else 0
        sb = tb.scale if tb.is_decimal else 0
        use_float = ta.is_floating or tb.is_floating
        m = max(sa, sb)

        def lower(env, aux, _fa=fa, _fb=fb, _sa=sa, _sb=sb, _m=m,
                  _ff=use_float):
            a, b = _fa(env, aux), _fb(env, aux)
            if _ff:
                av = a.data.to(torch.float64) / (10.0 ** _sa)
                bv = b.data.to(torch.float64) / (10.0 ** _sb)
            else:
                av = a.data * (10 ** (_m - _sa))
                bv = b.data * (10 ** (_m - _sb))
            equal = (av == bv) & b.validity
            return Column(a.data, a.validity & ~equal)

        return lower, out_t
    if op is Op.IN_SET:
        # IN over numeric literals: OR of equalities
        fa = fns[0]
        consts = call.args[1:]

        def lower(env, aux, _fa=fa, _cs=tuple(c.value for c in consts)):
            a = _fa(env, aux)
            hit = torch.zeros_like(a.validity)
            for v in _cs:
                hit = hit | (a.data == v)
            return Column(hit, a.validity)

        return lower, out_t
    raise NotImplementedError(f"lowering for op {op}")


def _descale_mixed(fns, ts):
    """decimal op float -> both float (scaled-int decimals descale)."""
    if len(ts) != 2:
        return fns, ts
    a, b = ts
    if not ((a.is_decimal and b.is_floating)
            or (b.is_decimal and a.is_floating)):
        return fns, ts

    def descaled(fn, scale):
        div = 10.0 ** scale

        def lower(env, aux, _fn=fn, _d=div):
            c = _fn(env, aux)
            return Column(c.data.to(torch.float64) / _d, c.validity)

        return lower

    out = list(fns)
    t_out = list(ts)
    for i, t in enumerate(ts):
        if t.is_decimal:
            out[i] = descaled(fns[i], t.scale)
            t_out[i] = dtypes.DOUBLE
    return out, t_out


def _align_decimals(op, call, fns, ts):
    """Rescale decimal operands to a common scale (exact, compile-time)."""
    if len(ts) != 2:
        return fns, ts
    a, b = ts
    if not (a.is_decimal or b.is_decimal):
        return fns, ts
    sa = a.scale if a.is_decimal else 0
    sb = b.scale if b.is_decimal else 0
    if sa == sb:
        return fns, ts
    target = max(sa, sb)

    def rescaled(fn, frm, to):
        mult = 10 ** (to - frm)

        def lower(env, aux, _fn=fn, _m=mult):
            c = _fn(env, aux)
            if c.data.is_floating_point():
                # float operand meeting a decimal: scale FIRST, then round
                # to the integer grid (casting first would truncate to 0)
                d = torch.round(c.data * _m).to(torch.int64)
            else:
                d = c.data.to(torch.int64) * _m
            return Column(d, c.validity)

        return lower

    out = list(fns)
    t_out = [dtypes.decimal(target), dtypes.decimal(target)]
    if sa < target:
        out[0] = rescaled(fns[0], sa, target)
    if sb < target:
        out[1] = rescaled(fns[1], sb, target)
    return out, t_out


# ---------------- group-by lowering ----------------


@dataclasses.dataclass
class _GroupByLowered:
    lower: Callable  # (env, aux, live_mask) -> (env, length)
    out_names: tuple[str, ...]
    out_types: dict[str, dtypes.LogicalType]


#: Dense group-id path cap: above this many key combinations the sorted
#: path wins (scatter target arrays stay small).
_DENSE_GROUP_LIMIT = 65536


def _is_int(dt: torch.dtype) -> bool:
    return not dt.is_floating_point and dt != torch.bool


def _resolve_group_by(ctx: _Lowering, step: GroupByStep, cur_types,
                      cur_nullable: dict | None = None):
    keys = step.keys
    bounds = []
    for k in keys:
        if k not in cur_types:
            raise KeyError(f"group-by key {k} not in scope")
        bounds.append(ctx.key_bound(k, cur_types[k]))
    # exact distinct-combination bound: the product of per-key
    # cardinality bounds (+1 for the NULL slot each)
    bound_product: int | None = None
    if keys and all(b is not None for b in bounds):
        bound_product = 1
        for b in bounds:
            bound_product *= b + 1
    num_groups = bound_product or 0
    dense = bound_product is not None and \
        bound_product <= _DENSE_GROUP_LIMIT

    out_types: dict[str, dtypes.LogicalType] = {}
    for k in keys:
        out_types[k] = cur_types[k]
    specs: list[tuple[AggSpec, dtypes.LogicalType]] = []
    # MIN/MAX over a string column must order by dictionary *rank*; ship
    # the rank table and reduce over (rank << 32 | id) packed keys.
    str_rank_aux: dict[str, str] = {}
    for spec in step.aggs:
        t = agg_result_type(spec, ctx.schema, cur_types)
        out_types[spec.out_name] = t
        specs.append((spec, t))
        if (
            spec.func in (Agg.MIN, Agg.MAX)
            and cur_types[spec.column].is_string
        ):
            d = ctx.dictionary(spec.column)
            if d is None:
                raise ValueError(
                    f"MIN/MAX over string column {spec.column} needs its"
                    " dictionary"
                )
            if spec.column not in str_rank_aux:
                str_rank_aux[spec.column] = ctx.add_aux(
                    f"rank.{spec.column}", d.sort_rank()
                )
    out_names = tuple(keys) + tuple(s.out_name for s, _ in specs)

    key_names = tuple(keys)
    use_dense = dense
    b_tuple = tuple(bounds) if dense else ()
    explicit_cap = step.max_groups
    group_bound = bound_product  # exact cap for the sorted tier
    if not keys:
        ctx.group_layout = ("keyless", 1)
    elif dense:
        # dense group-ids, compacted output: shape is num_groups whatever
        # the input capacity, so partial states fold incrementally
        ctx.group_layout = ("dense", num_groups)
    else:
        ctx.group_layout = ("compact", None)

    src_types = {
        s.column: cur_types[s.column] for s, _ in specs
        if s.column is not None
    }
    # statically NULL-free aggregate inputs: their valid-count is the
    # live count and their values need no validity masking
    nonnull_cols = {
        s.column for s, _ in specs
        if s.column is not None
        and not (cur_nullable or {}).get(s.column, True)
    }
    # integer SUM states double as AVG numerators
    int_sum_cols = {
        s.column: dtypes.torch_dtype(t) for s, t in specs
        if s.func is Agg.SUM and _is_int(dtypes.torch_dtype(t))
    }

    def trace_fused(env, aux, live, gid, ng, kcols, capacity):
        """Fused lowering: ONE shared hit expansion per GroupByStep.

        All linear aggregates (COUNT/SUM/AVG/VAR/STDDEV states) stack
        into per-accumulator-dtype banks and reduce with one contraction
        each (kernels.fused_group_reduce_banks); MIN/MAX and the key
        columns reuse the same bool hit matrix.
        """
        dev = gid.device
        onehot = ng <= kernels.ONEHOT_GROUP_LIMIT
        # counts ride the f64 bank in the one-hot tier; the large-group
        # tier keeps them int32 so they stay kernel-eligible
        count_dt = torch.float64 if onehot else torch.int32

        bank_vecs: dict = {}   # accumulator dtype -> list of row vectors
        slot_ix: dict = {}     # state key -> (dtype, slot index)

        def slot(key, dtype, make_vec):
            if key not in slot_ix:
                vecs = bank_vecs.setdefault(dtype, [])
                slot_ix[key] = (dtype, len(vecs))
                vecs.append(make_vec().to(dtype))

        def cnt_key(col):
            # NULL-free column: its valid count IS the live count
            return ("live",) if col in nonnull_cols else ("cnt", col)

        def masked(c, col):
            return (c.data if col in nonnull_cols
                    else torch.where(c.validity, c.data,
                                     torch.zeros_like(c.data)))

        slot(("live",), count_dt,
             lambda: torch.ones((capacity,), dtype=torch.int32, device=dev))
        for spec, t in specs:
            if spec.func is Agg.COUNT_ALL:
                continue
            c = env[spec.column]
            # per-column valid count: COUNT's value, everyone's validity
            slot(cnt_key(spec.column), count_dt,
                 lambda _c=c: _c.validity.to(torch.int32))
            if spec.func is Agg.SUM:
                acc = dtypes.torch_dtype(t)
                slot(("sum", spec.column, str(acc)), acc,
                     lambda _c=c, _col=spec.column: masked(_c, _col))
            elif spec.func is Agg.AVG:
                if spec.column in int_sum_cols:
                    # share the exact integer SUM state
                    acc = int_sum_cols[spec.column]
                    slot(("sum", spec.column, str(acc)), acc,
                         lambda _c=c, _col=spec.column: masked(_c, _col))
                else:
                    slot(("sum", spec.column, str(torch.float64)),
                         torch.float64,
                         lambda _c=c, _col=spec.column:
                         masked(_c, _col).to(torch.float64))
            elif spec.func in (Agg.VAR_SAMP, Agg.STDDEV_SAMP):
                scale = (10.0 ** src_types[spec.column].scale
                         if src_types[spec.column].is_decimal else 1.0)

                def mk_vals(_c=c, _col=spec.column, _s=scale):
                    v = masked(_c, _col).to(torch.float64)
                    if _s != 1.0:
                        v = v / _s
                    return v

                slot(("vsum", spec.column), torch.float64, mk_vals)
                slot(("vsq", spec.column), torch.float64,
                     lambda _mk=mk_vals: _mk() ** 2)

        results = kernels.fused_group_reduce_banks(
            {dtype: (vecs[0][:, None] if len(vecs) == 1
                     else torch.stack(vecs, dim=1))
             for dtype, vecs in bank_vecs.items()},
            gid, ng)

        def state(key):
            dtype, i = slot_ix[key]
            return results[dtype][:, i]

        def count_of(key):
            return state(key).to(torch.int64)

        live_count = count_of(("live",))
        group_live = live_count > 0

        hits = kernels.group_hits(gid, ng) if onehot else None
        new_env: dict[str, Column] = {}
        if key_names and use_dense:
            # dense slot ids ARE the keys: decode each key value from
            # the slot index arithmetically (enc = value + 1, 0 = NULL,
            # group_ids_dense's mixed-radix encoding) — zero row passes
            strides = []
            acc = 1
            for b in reversed(b_tuple):
                strides.append(acc)
                acc *= b + 1
            strides.reverse()
            slot_ids = torch.arange(ng, dtype=torch.int32, device=dev)
            for k, c, b, stride in zip(key_names, kcols, b_tuple, strides):
                enc = torch.remainder(floordiv(slot_ids, stride), b + 1)
                kd = torch.clamp(enc - 1, min=0).to(c.data.dtype)
                kv = (enc > 0) & group_live
                new_env[k] = Column(kd, kv)
        elif key_names and onehot:
            # one first-row expansion shared by EVERY key column
            first, found = kernels.first_live_index(hits)
            for k, c in zip(key_names, kcols):
                kd = torch.where(found, c.data[first],
                                 torch.zeros_like(c.data[first]))
                kv = c.validity[first] & found
                new_env[k] = Column(kd, kv & group_live)
        else:
            for k, c in zip(key_names, kcols):
                kd = kernels.scatter_first(c.data, live, gid, ng)
                kv = kernels.scatter_first(c.validity, live, gid, ng)
                new_env[k] = Column(kd, kv & group_live)

        for spec, t in specs:
            if spec.func is Agg.COUNT_ALL:
                data = live_count
                valid = (torch.ones_like(group_live) if not key_names
                         else group_live)
                new_env[spec.out_name] = Column(data, valid)
                continue
            c = env[spec.column]
            nn = count_of(cnt_key(spec.column))
            if spec.func is Agg.COUNT:
                data = nn
                valid = (torch.ones_like(group_live) if not key_names
                         else group_live)
            elif spec.func is Agg.SUM:
                data = state(("sum", spec.column,
                              str(dtypes.torch_dtype(t))))
                valid = nn > 0
            elif spec.func in (Agg.MIN, Agg.MAX):
                vals = c.data
                packed = spec.column in str_rank_aux
                if packed:
                    rank = kernels.dict_gather(
                        aux[str_rank_aux[spec.column]], c).data
                    vals = (rank.to(torch.int64) << 32) \
                        | c.data.to(torch.int64)
                if onehot:
                    fill = kernels._extreme(
                        vals.dtype, maximum=spec.func is Agg.MIN)
                    hv = (hits if spec.column in nonnull_cols
                          else hits & c.validity[:, None])
                    expanded = torch.where(hv, vals[:, None], fill)
                    reduce_fn = (torch.amin if spec.func is Agg.MIN
                                 else torch.amax)
                    data = reduce_fn(expanded, dim=0)
                elif spec.func is Agg.MIN:
                    data = kernels.scatter_min(
                        vals, live & c.validity, gid, ng)
                else:
                    data = kernels.scatter_max(
                        vals, live & c.validity, gid, ng)
                if packed:
                    data = (data & 0xFFFFFFFF).to(torch.int32)
                valid = nn > 0
            elif spec.func is Agg.AVG:
                src_t = src_types[spec.column]
                if spec.column in int_sum_cols:
                    s = state(("sum", spec.column,
                               str(int_sum_cols[spec.column]))
                              ).to(torch.float64)
                else:
                    s = state(("sum", spec.column, str(torch.float64)))
                if src_t.is_decimal:
                    s = s / (10.0 ** src_t.scale)
                data = s / torch.clamp(nn, min=1)
                valid = nn > 0
            elif spec.func is Agg.SOME:
                data = kernels.scatter_first(
                    c.data, live & c.validity, gid, ng)
                valid = nn > 0
            elif spec.func in (Agg.VAR_SAMP, Agg.STDDEV_SAMP):
                s = state(("vsum", spec.column))
                q = state(("vsq", spec.column))
                nf = nn.to(torch.float64)
                var = (q - s * s / torch.clamp(nf, min=1.0)) \
                    / torch.clamp(nf - 1.0, min=1.0)
                var = torch.clamp(var, min=0.0)  # fp cancellation
                data = (torch.sqrt(var)
                        if spec.func is Agg.STDDEV_SAMP else var)
                valid = nn > 1
            else:
                raise NotImplementedError(spec.func)
            new_env[spec.out_name] = Column(data, valid)
        return new_env, group_live

    def trace_peragg(env, aux, live, gid, ng, kcols):
        """Reference lowering: one independent scatter/one-hot reduction
        per aggregate (the pre-fusion path, kept as the A/B baseline —
        kernels.fused_group_by_enabled() selects when the program runs)."""
        # counts accumulate in int32 per block (a block holds < 2^31
        # rows) and widen after: int32 keeps COUNT kernel-eligible
        live_count = kernels.scatter_sum(
            torch.ones_like(gid, dtype=torch.int32), live, gid, ng,
            dtype=torch.int32,
        ).to(torch.int64)
        group_live = live_count > 0

        new_env: dict[str, Column] = {}
        for k, c in zip(key_names, kcols):
            kd = kernels.scatter_first(c.data, live, gid, ng)
            kv = kernels.scatter_first(c.validity, live, gid, ng)
            new_env[k] = Column(kd, kv & group_live)

        for spec, t in specs:
            if spec.func is Agg.COUNT_ALL:
                data = live_count
                # keyless COUNT over zero rows is 0, not NULL
                valid = (torch.ones_like(group_live) if not key_names
                         else group_live)
            else:
                c = env[spec.column]
                vrow = live & c.validity
                nn = kernels.scatter_sum(
                    torch.ones_like(gid, dtype=torch.int32), vrow, gid, ng,
                    dtype=torch.int32,
                ).to(torch.int64)
                if spec.func is Agg.COUNT:
                    data = nn
                    valid = (torch.ones_like(group_live) if not key_names
                             else group_live)
                elif spec.func is Agg.SUM:
                    data = kernels.scatter_sum(
                        c.data, vrow, gid, ng, dtype=dtypes.torch_dtype(t))
                    valid = nn > 0
                elif spec.func in (Agg.MIN, Agg.MAX):
                    vals = c.data
                    packed = spec.column in str_rank_aux
                    if packed:
                        rank = kernels.dict_gather(
                            aux[str_rank_aux[spec.column]], c).data
                        vals = (rank.to(torch.int64) << 32) \
                            | c.data.to(torch.int64)
                    if spec.func is Agg.MIN:
                        data = kernels.scatter_min(vals, vrow, gid, ng)
                    else:
                        data = kernels.scatter_max(vals, vrow, gid, ng)
                    if packed:
                        data = (data & 0xFFFFFFFF).to(torch.int32)
                    valid = nn > 0
                elif spec.func is Agg.AVG:
                    src_t = cur_types[spec.column]
                    s = kernels.scatter_sum(
                        c.data, vrow, gid, ng, dtype=torch.float64)
                    if src_t.is_decimal:
                        s = s / (10.0 ** src_t.scale)
                    data = s / torch.clamp(nn, min=1)
                    valid = nn > 0
                elif spec.func is Agg.SOME:
                    data = kernels.scatter_first(c.data, vrow, gid, ng)
                    valid = nn > 0
                elif spec.func in (Agg.VAR_SAMP, Agg.STDDEV_SAMP):
                    src_t = cur_types[spec.column]
                    vals = c.data.to(torch.float64)
                    if src_t.is_decimal:
                        vals = vals / (10.0 ** src_t.scale)
                    s = kernels.scatter_sum(
                        vals, vrow, gid, ng, dtype=torch.float64)
                    q = kernels.scatter_sum(
                        vals * vals, vrow, gid, ng, dtype=torch.float64)
                    nf = nn.to(torch.float64)
                    var = (q - s * s / torch.clamp(nf, min=1.0)) \
                        / torch.clamp(nf - 1.0, min=1.0)
                    var = torch.clamp(var, min=0.0)  # fp cancellation
                    data = (torch.sqrt(var)
                            if spec.func is Agg.STDDEV_SAMP else var)
                    valid = nn > 1
                else:
                    raise NotImplementedError(spec.func)
            new_env[spec.out_name] = Column(data, valid)
        return new_env, group_live

    def lower(env, aux, live):
        kcols = [env[k] for k in key_names]
        capacity = next(iter(env.values())).data.shape[0]
        dev = live.device
        ng_scalar = None
        if key_names:
            if use_dense:
                gid, ng = kernels.group_ids_dense(kcols, list(b_tuple), live)
            else:
                # a block of N rows has at most N groups: default the group
                # capacity to the block capacity so nothing is dropped; an
                # explicit max_groups or an exact bound product caps it
                caps = [capacity]
                if explicit_cap is not None:
                    caps.append(explicit_cap)
                if group_bound is not None:
                    caps.append(group_bound)
                ng = max(1, min(caps))
                gid, ng_scalar = kernels.group_ids_sorted(kcols, live, ng)
                ng_scalar = torch.clamp(ng_scalar, max=ng)
        else:
            # global aggregate: one group
            gid = torch.where(live, 0, 1).to(torch.int32)
            ng = 1

        if kernels.fused_group_by_enabled():
            new_env, group_live = trace_fused(
                env, aux, live, gid, ng, kcols, capacity)
        else:
            new_env, group_live = trace_peragg(
                env, aux, live, gid, ng, kcols)

        if key_names and not use_dense:
            # sorted path: groups already dense [0, n)
            length = ng_scalar
        elif not key_names:
            # keyless aggregate always yields exactly one row (SQL:
            # SELECT COUNT(*) ... WHERE false => one row with 0)
            length = torch.full((), 1, dtype=torch.int32, device=dev)
        else:
            # dense path: compact scattered group slots to the front
            blk = TableBlock(
                new_env, torch.full((), ng, dtype=torch.int32, device=dev),
                dtypes.Schema(tuple(
                    dtypes.Field(n, out_types[n]) for n in out_names)),
            )
            blk = kernels.compact(blk, group_live)
            new_env = dict(blk.columns)
            length = blk.length
        return new_env, length

    return _GroupByLowered(lower=lower, out_names=out_names,
                           out_types=out_types)
