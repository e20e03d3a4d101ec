"""Single-shard scan execution: stream column blocks through a compiled
SSA program with partial/final aggregation.

The counterpart of ``ydb_tpu/engine/scan.py`` (the minimum end-to-end
slice of the reference's ColumnShard scan, SURVEY.md §3.3): a host column
source is tiled into fixed-capacity device blocks; the *partial* program
(filters + assigns + partial group-by) runs per block; the small partial
results are merged by the *final* program. Programs without a GROUP BY
concatenate block outputs directly. Everything runs eagerly in torch on
the executor's device; the per-block loop waits for the device only to
bound the number of blocks in flight.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis import budget_ok, memsan
from ydb_tpu_torch.blocks.block import (
    Column,
    TableBlock,
    concat_blocks,
    device_aux,
)
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.chaos import deadline as statement_deadline
from ydb_tpu_torch.device import resolve_device
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.ssa import kernels, twophase
from ydb_tpu_torch.ssa.compiler import compile_program
from ydb_tpu_torch.ssa.program import Program

DEFAULT_BLOCK_ROWS = 1 << 20


@dataclasses.dataclass
class ColumnSource:
    """A columnar table (one shard's worth of data): host numpy arrays,
    or tensors on a device after ``to_device``."""

    columns: dict[str, np.ndarray]
    schema: dtypes.Schema
    dicts: DictionarySet | None = None
    validity: dict[str, np.ndarray] | None = None

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def n_blocks(self, block_rows: int = DEFAULT_BLOCK_ROWS) -> int:
        n = self.num_rows
        cap = min(block_rows, max(n, 1))
        return len(range(0, max(n, 1), cap))

    def blocks(
        self, block_rows: int = DEFAULT_BLOCK_ROWS,
        columns: tuple[str, ...] | None = None,
        device: "str | torch.device | None" = None,
        start_block: int = 0,
    ) -> Iterator[TableBlock]:
        """Tile into equal-capacity blocks on ``device`` (last one
        padded). ``start_block`` seeks without materializing skipped
        blocks (checkpoint-resume path)."""
        names = columns if columns is not None else self.schema.names
        sch = self.schema.select(names)
        n = self.num_rows
        cap = min(block_rows, max(n, 1))
        for off in range(start_block * cap, max(n, 1), cap):
            hi = min(off + cap, n)
            arrays = {m: self.columns[m][off:hi] for m in names}
            validity = None
            if self.validity:
                validity = {
                    m: self.validity[m][off:hi]
                    for m in names if m in self.validity
                }
            yield TableBlock.from_numpy(arrays, sch, validity, capacity=cap,
                                        device=device)

    @budget_ok("a whole table copied to the device once, on the caller's"
               " request: the caller holds it as a tensor-held source")
    def to_device(self, device: "str | torch.device | None" = None
                  ) -> "ColumnSource":
        """This table with every column held as a tensor on ``device``
        (CUDA unless the caller names another). Its blocks on that device
        are then slices of the resident columns: a scan copies nothing
        from the host."""
        dev = resolve_device(device)

        def put(a, typ):
            return torch.from_numpy(np.ascontiguousarray(
                a, dtype=typ.physical)).to(dev)

        cols = {n: put(a, self.schema.field(n).type)
                for n, a in self.columns.items()}
        validity = ({n: put(v, dtypes.BOOL) for n, v in self.validity.items()}
                    if self.validity else None)
        return ColumnSource(cols, self.schema, self.dicts, validity)


def merge_blocks_device(blocks: list[TableBlock]) -> TableBlock:
    """Device-side concat of blocks (live rows compacted to the front):
    the device twin of ``concat_blocks``, with no host round trip."""
    if len(blocks) == 1:
        return blocks[0]
    schema = blocks[0].schema
    # the merged partials are the dispatch's working set
    with memsan.seam():
        live = torch.cat([b.row_mask() for b in blocks])
        cols = {}
        for n in schema.names:
            data = torch.cat([b.columns[n].data for b in blocks])
            val = torch.cat([b.columns[n].validity for b in blocks])
            cols[n] = Column(data, val)
        # live rows sit at each segment's start, not in one prefix: give
        # the concat full-capacity length so compact's row_mask covers
        # them all
        length = torch.full((), live.shape[0], dtype=torch.int32,
                            device=live.device)
        return kernels.compact(TableBlock(cols, length, schema), live)


def required_columns(program: Program, schema: dtypes.Schema) -> tuple[str, ...]:
    """Input columns the program actually reads (scan projection pushdown)."""
    from ydb_tpu_torch.ssa.program import (
        AssignStep, Call, Col, DictMap, DictPredicate, FilterStep,
        GroupByStep, ProjectStep, SortStep, UdfCall,
    )

    used: set[str] = set()
    assigned: set[str] = set()

    def walk(e):
        if isinstance(e, Col):
            if e.name not in assigned:
                used.add(e.name)
        elif isinstance(e, (Call, UdfCall)):
            for a in e.args:
                walk(a)
        elif isinstance(e, (DictPredicate, DictMap)):
            if e.column not in assigned:
                used.add(e.column)

    for s in program.steps:
        if isinstance(s, AssignStep):
            walk(s.expr)
            assigned.add(s.name)
        elif isinstance(s, FilterStep):
            walk(s.expr)
        elif isinstance(s, GroupByStep):
            for k in s.keys:
                if k not in assigned:
                    used.add(k)
            for a in s.aggs:
                if a.column is not None and a.column not in assigned:
                    used.add(a.column)
        elif isinstance(s, SortStep):
            for k in s.keys:
                if k not in assigned:
                    used.add(k)
        elif isinstance(s, ProjectStep):
            for nm in s.names:
                if nm not in assigned:
                    used.add(nm)
    if not used:
        # pure COUNT(*)-style programs still need one column for the row
        # count; read the narrowest physical column
        if not schema.fields:
            return ()
        cheapest = min(
            schema.fields, key=lambda f: f.type.physical.itemsize
        )
        return (cheapest.name,)
    return tuple(n for n in schema.names if n in used)


class ScanExecutor:
    """Compiles a program against a source and executes block-streamed on
    ``device`` (CUDA unless the caller passes another).

    Memory discipline (the TChunksLimiter credit idea,
    ydb/library/chunks_limiter/chunks_limiter.h:7): the block loop keeps
    at most ``INFLIGHT_BLOCKS`` launched-but-unfinished blocks — each
    pins its input block's tensors, so an unbounded launch queue would
    retain the whole table. A CUDA event recorded after each block's
    partial program marks its completion. Aggregation partials fold
    every ``COMBINE_EVERY`` blocks through the associative combine
    program (twophase.combine_of) whenever the group layout is
    shape-stable, so the partials list never grows with the table.
    """

    INFLIGHT_BLOCKS = 4
    COMBINE_EVERY = 8

    def __init__(
        self,
        program: Program,
        source: ColumnSource,
        block_rows: int = DEFAULT_BLOCK_ROWS,
        device: "str | torch.device | None" = None,
        key_spaces: dict[str, int] | None = None,
        group_est: float | None = None,
    ):
        self.device = resolve_device(device)
        self.source = source
        self.block_rows = block_rows
        # advisory NDV-based group-count estimate (stats.cost): steers
        # the PARTIAL program's group-by tier choice; the final/combine
        # programs run over small partial blocks and keep their own
        # sizing
        self.group_est = group_est
        # first run of each program (partial / combine / final) includes
        # its one-off costs (aux staging, kernel build and load, CUDA
        # module loading); timed once per program with a device sync and
        # summed here so callers can separate cold from warm
        self.first_trace_seconds: float | None = None
        self._partial_traced = False
        self._combine_traced = False
        self._finalize_traced = False
        self.read_cols = required_columns(program, source.schema)
        in_schema = source.schema.select(self.read_cols)
        # verify the ORIGINAL program before the two-phase rewrite; its
        # nullability also types the RESULT schema (see _stamp_nullability)
        from ydb_tpu_torch.analysis.verify import check_program

        self._out_nullable = check_program(program, in_schema).out_nullable
        self.partial_prog, self.final_prog = twophase.split(program)
        self.partial = compile_program(
            self.partial_prog, in_schema, source.dicts, key_spaces,
            group_est=group_est)
        self._partial_aux = device_aux(self.partial.aux, self.device)
        self._combine = None
        self._combine_aux = {}
        if self.final_prog is not None and self.partial.group_layout[0] in (
            "keyless", "dense"
        ):
            comb = compile_program(
                twophase.combine_of(program), self.partial.out_schema,
                source.dicts, key_spaces,
                dict_aliases=twophase.dict_aliases(self.partial_prog),
            )
            self._combine = comb.run
            self._combine_aux = device_aux(comb.aux, self.device)
        if self.final_prog is not None:
            self.final = compile_program(
                self.final_prog, self.partial.out_schema, source.dicts,
                key_spaces, dict_aliases=twophase.dict_aliases(self.partial_prog),
            )
            self._final_aux = device_aux(self.final.aux, self.device)
            self.out_schema = self._stamp_nullability(self.final.out_schema)
        else:
            self.final = None
            self.out_schema = self._stamp_nullability(
                self.partial.out_schema)
            self._final_aux = {}

    def detach(self) -> "ScanExecutor":
        """Drop the source reference, keeping the compiled state only:
        an executor cached across statements must not pin a table."""
        self.source = None
        return self

    def _sync(self) -> None:
        if self.device.type == "cuda":
            # one-off sync: times a program's first run (``_timed_first``;
            # the warm arm stays async)
            # ydb-lint: disable=H001
            torch.cuda.synchronize(self.device)

    def _timed_first(self, flag: str, fn, *args):
        """Time a program's first run (with a device sync), once,
        accumulating into ``first_trace_seconds``; later runs stay
        asynchronous."""
        if getattr(self, flag):
            return fn(*args)
        self._sync()
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        setattr(self, flag, True)
        self.first_trace_seconds = (
            (self.first_trace_seconds or 0.0) + time.perf_counter() - t0)
        return out

    def run_block(self, block: TableBlock) -> TableBlock:
        return self._timed_first("_partial_traced", self.partial.run,
                                 block, self._partial_aux)

    def _combine_parts(self, parts: list[TableBlock]) -> TableBlock:
        return self._combine(merge_blocks_device(parts), self._combine_aux)

    def _finalize_parts(self, parts: list[TableBlock]) -> TableBlock:
        merged = merge_blocks_device(parts)
        if self.final is None:
            return merged
        return self.final.run(merged, self._final_aux)

    def finalize(self, partials: list[TableBlock]) -> TableBlock:
        """Merge per-block partial results and run the final program."""
        if self.final is None and len(partials) == 1:
            return partials[0]
        return self._timed_first("_finalize_traced", self._finalize_parts,
                                 list(partials))

    def run_stream(self, blocks, timer=None,
                   consumed_cb=None) -> TableBlock:
        """Drive a block stream with bounded in-flight work; returns the
        result block (merged partials finalized, or concatenated rows).

        The stream contract admits out-of-order-READY production: a
        morsel pipeline (engine.stream_sched) may complete blocks in
        any order underneath, as long as the iterator delivers them in
        order — this loop consumes strictly in order and, via
        ``consumed_cb`` (called once per admitted block), returns the
        in-order consumption credit that lets the producer account its
        double-buffered slabs.

        ``timer`` (obs.probes.StageTimer) charges block launches and
        backpressure waits to the "compute" stage; time spent PULLING
        from ``blocks`` (the staging pipeline) is charged by the
        producer side, so the two stages expose their overlap. Each
        block boundary is a statement-deadline cancellation point."""
        window: collections.deque = collections.deque()
        partials: list[TableBlock] = []

        def computing():
            return (timer.stage("compute") if timer is not None
                    else contextlib.nullcontext())

        def admit(out):
            partials.append(out)
            if self.device.type != "cuda":
                return
            done = torch.cuda.Event()
            done.record()
            window.append(done)
            if len(window) > self.INFLIGHT_BLOCKS:
                # deliberate backpressure: wait for the OLDEST in-flight
                # block only once the window fills — bounded by
                # INFLIGHT_BLOCKS, not rows
                # ydb-lint: disable=H001
                window.popleft().synchronize()

        # the morsel loop: iterations are bounded by block
        # count (capacity-quantized morsels), never by rows; each
        # iteration is one async device dispatch
        # ydb-lint: disable=H006
        for b in blocks:
            statement_deadline.check_current("scan")
            with computing():
                admit(self.run_block(b))
                if self._combine is not None and \
                        len(partials) >= self.COMBINE_EVERY:
                    merged = self._timed_first(
                        "_combine_traced", self._combine_parts, partials)
                    partials = []
                    admit(merged)
            if consumed_cb is not None:
                consumed_cb()
        with computing():
            if self.final is None:
                # pure filter/project program: block outputs concatenate
                out = (partials[0] if len(partials) == 1
                       else concat_blocks(partials))
            else:
                out = self.finalize(partials)
            return self._retype(out)

    def _stamp_nullability(self, sch: dtypes.Schema) -> dtypes.Schema:
        """Original-program nullability over a rewritten-program schema
        (the two-phase rewrite's fixups would widen it: AVG restated as
        a division fixup loses never-NULL knowledge)."""
        return dtypes.Schema(tuple(
            dtypes.Field(f.name, f.type,
                         self._out_nullable.get(f.name, f.nullable))
            for f in sch.fields))

    def _retype(self, blk: TableBlock) -> TableBlock:
        sch = self._stamp_nullability(blk.schema)
        if sch == blk.schema:
            return blk
        return TableBlock(blk.columns, blk.length, sch)

    def execute(self) -> OracleTable:
        return OracleTable.from_block(self.run_stream(
            self.source.blocks(self.block_rows, self.read_cols,
                               device=self.device)))

