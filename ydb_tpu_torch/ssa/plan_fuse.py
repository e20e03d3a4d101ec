"""Whole-plan fusion: one CUDA graph replay per plan.

The counterpart of ``ydb_tpu/ssa/plan_fuse.py``. The plan walk runs
every fragment (scan program, join, transform, concat) as its own
sequence of eager torch calls, each a few device launches issued from
host Python. Fusion walks the plan tree once at build time, compiles
every SSA program up front (``compiler._compile_program``), and emits
one function

    run_all(inputs, aux) -> (result TableBlock, expand totals)

over a dict of staged input blocks, one per scanned table. Where the
reference hands ``run_all`` to ``jax.jit``, the port captures it into a
``torch.cuda.CUDAGraph`` on CUDA: a statement is then one graph replay,
every kernel of every fragment launched by the device from the recorded
graph with no host Python between them. On the CPU (only when the
caller asks for it, as the tests do) ``run_all`` runs eagerly: the plain
path the tests compare, not a fallback.

Shape classes: every scanned table stages into a block whose capacity is
its row count rounded up to a size class (the capacity quantum for small
tables, quarter-of-power-of-two steps beyond: at most 25% padding), as
in the reference. One FusedPlan is cached per (plan fingerprint,
shape-class vector) in ``Database._compile_cache``; re-running the plan
over other data of the same classes replays the same graph. Capacities
only move dead padding around: the kernels mask padding by liveness.

The CUDA graph, as ``FusedPlan`` builds it on its first run:

  1. static input blocks, one per scan site at its shape-class capacity,
     allocated outside the graph (they survive ``grow``);
  2. a warm-up: ``run_all`` once, eagerly, on the device's fusion stream
     under ``torch.cuda.set_sync_debug_mode("error")`` — any operation
     that waits on the device fails there, before capture; it also
     allocates the CUDA kernels' ticket slab and measures their launch
     geometry outside the graph;
  3. the capture of ``run_all`` on that stream into a graph with its own
     private memory pool (``pool_bytes``), with Python's garbage
     collector off for its length, in ``thread_local`` capture mode.
  ``first_trace_seconds`` is warm-up plus capture (``capture_seconds``).
  Warm-up and capture hold ``device.work_lock`` exclusively, so no other
  statement thread issues device work meanwhile (a dispatch that finds
  it held raises ``CaptureNeedsExclusive`` and the executor retries the
  statement's dispatch under the lock: ``with_capture_retry``), and
  ``device.capture_lock``, which worker threads hold around theirs.
  ``release`` frees a plan's graphs when it leaves its cache.

A statement copies each site's rows into the static inputs (a host
table is a copy from the host, a table already on the card a copy on
the card: this takes the place of the reference's donation), replays
the graph, clones the static output block (a later replay overwrites
it) and reads the expand totals with one host sync. Replays of every
graph on a device are serialized by one lock per device and issued on
one fusion stream per device: the CUDA kernels' tickets are per stream,
and a graph keeps those of the stream it was captured on, so no two
replays may overlap. Nothing falls back: a capture or replay error
raises. ``Unfusible`` and ``plan_signature() is None`` send the plan to
the walk, as in the reference: that is plan shape, not failure.

Fusibility (``plan_signature`` returns None otherwise):

  * every scanned table present in ``db.sources`` with
    ``num_rows <= FUSE_MAX_ROWS`` (beyond that the walk's block
    streaming and two-phase partials bound memory; a fused run stages
    the whole table);
  * no ``UdfCall`` in any program (a UDF is a host round trip, the
    boundary fusion exists to remove, and cannot be captured);
  * join shapes the kernels support (<= 2 key columns, lookup
    inner/left/semi/anti, expand inner/left).

Expand joins get a static output capacity (probe bound * fanout_hint);
the total match count comes back with the result, and on overflow the
executor grows the capacity (``FusedPlan.grow``), which frees the graph
and its pool; the next run captures anew at the grown capacity, and the
cached plan keeps it for later statements.

Env gates: ``YDB_TPU_TORCH_FUSE_PLAN=0`` disables fusion (``FUSE_FORCE``
overrides it in-process); ``YDB_TPU_TORCH_FUSE_MAX_ROWS`` moves the
cutoff. A build is one ``ssa.compile`` span; while the data-movement
timeline is on, each replay's host enqueue is one ``plan.dispatch``
interval (no sync is added). Not in the port yet: the mesh lowering
that subclasses ``PlanLowering`` (ROADMAP.md queue A item 13b, over the
shard mesh of ``parallel/``).

Sanitizer hooks: a capture reports itself to the sync sanitizer
(``syncsan.count(captures=1)``); memsan charges each dispatch's output
clone (``dispatch``), the eager path's member stacking (``stack``) and a
plan's graph state — the serial static inputs, a batch size's stacked
static inputs and each graph's private pool (``graph_pool``, released
when ``release``/``grow`` drop the graphs). ``run_all`` itself runs under
``memsan.seam()``: its tensors are the dispatch's working set.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import os
import threading
import time
from typing import Callable

import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis import host_ok, memsan, syncsan
from ydb_tpu_torch.blocks.block import (
    DEFAULT_CAPACITY_QUANTUM,
    Column,
    TableBlock,
    device_aux,
)
from ydb_tpu_torch.device import capture_lock, resolve_device, work_lock
from ydb_tpu_torch.engine.scan import merge_blocks_device, required_columns
from ydb_tpu_torch.obs import timeline
from ydb_tpu_torch.plan.nodes import (
    Concat,
    ExpandJoin,
    LookupJoin,
    PlanNode,
    TableScan,
    Transform,
)
from ydb_tpu_torch.ssa import join as join_kernels
from ydb_tpu_torch.ssa.compiler import _compile_program
from ydb_tpu_torch.ssa.program import (
    AssignStep,
    Call,
    FilterStep,
    Program,
    UdfCall,
)

#: in-process override: True/False forces fusion on/off regardless of the
#: environment; None defers to YDB_TPU_TORCH_FUSE_PLAN
FUSE_FORCE: bool | None = None

#: tables above this row count keep the streaming walk (the reference's
#: cutoff, set on a TPU; ``chip_smoke.py`` sweeps it on the H100). Well
#: under the walk's scan block size (1 << 22), so a fusible table is a
#: single block on the walk too.
FUSE_MAX_ROWS = int(os.environ.get("YDB_TPU_TORCH_FUSE_MAX_ROWS",
                                   str(1 << 17)))


def fusion_enabled() -> bool:
    if FUSE_FORCE is not None:
        return FUSE_FORCE
    return os.environ.get("YDB_TPU_TORCH_FUSE_PLAN", "1") not in (
        "0", "", "off")


def shape_class(n: int) -> int:
    """Static staging capacity for an n-row table (the reference's size
    classes): small tables round to the capacity quantum; beyond 8
    quanta, to quarter-of-power-of-two steps (..., 5*2^k, 6*2^k, 7*2^k,
    2^(k+3), ...), so the class count stays logarithmic in table size
    while dead padding stays under 25%."""
    q = DEFAULT_CAPACITY_QUANTUM
    n = max(int(n), 1)
    if n <= 8 * q:
        return -(-n // q) * q
    step = 1 << ((n - 1).bit_length() - 3)
    return -(-n // step) * step


class CaptureNeedsExclusive(Exception):
    """A capture was due while another statement thread held
    ``device.work_lock``: the caller lets go of the plan's lock and
    retries under ``work_lock.exclusive()`` (``with_capture_retry``)."""


def with_capture_retry(fn):
    """Run ``fn`` (a dispatch that may capture a graph); when a capture
    could not take ``device.work_lock`` at once, run it again holding
    the lock exclusively."""
    try:
        return fn()
    except CaptureNeedsExclusive:
        with work_lock.exclusive():
            return fn()


class Unfusible(Exception):
    """Raised at build time when a plan that looked fusible is not (the
    executor falls back to the walk)."""


def fit_blocks(blocks, capacity: int) -> TableBlock:
    """Merge a scan's streamed blocks and fit them to the shape-class
    capacity: live rows compact to the front (``merge_blocks_device``),
    columns slice or zero-pad to ``capacity``. Live rows never exceed
    ``capacity`` (the class derives from the source's row count), so the
    slice drops only padding."""
    b = merge_blocks_device(list(blocks))
    cols = {}
    # fitting belongs to the fused site's staging working set (its
    # blocks were charged when staged)
    with memsan.seam():
        for n in b.schema.names:
            c = b.columns[n]
            d, v = c.data, c.validity
            if d.shape[0] > capacity:
                d, v = d[:capacity], v[:capacity]
            elif d.shape[0] < capacity:
                pad = capacity - d.shape[0]
                d = torch.cat([d, d.new_zeros(pad)])
                v = torch.cat([v, v.new_zeros(pad)])
            cols[n] = Column(d, v)
    return TableBlock(cols, b.length, b.schema)


def _program_has_udf(program: Program | None) -> bool:
    if program is None:
        return False

    def expr_has(e) -> bool:
        if isinstance(e, UdfCall):
            return True
        if isinstance(e, Call):
            return any(expr_has(a) for a in e.args)
        return False

    for s in program.steps:
        if isinstance(s, (AssignStep, FilterStep)) and expr_has(s.expr):
            return True
    return False


@dataclasses.dataclass(frozen=True)
class ScanSite:
    """One distinct TableScan node's staging contract: which columns to
    stage, under which schema, at which shape-class capacity."""

    key: str                      # input-dict key ("t0", "t1", ...)
    table: str
    node: TableScan
    read_cols: tuple[str, ...]
    in_schema: dtypes.Schema
    capacity: int


@dataclasses.dataclass
class PlanSignature:
    """A fusible plan's shape: scan sites + fragment count. The cache
    key (plan fingerprint + shape-class vector) derives from this."""

    plan: PlanNode
    sites: list[ScanSite]
    fused_stages: int  # plan fragments folded into the one graph

    def cache_key(self, db) -> tuple:
        return (
            "plan_fuse",
            self.plan,
            tuple((s.table, s.capacity, s.read_cols, s.in_schema)
                  for s in self.sites),
            id(db.dicts),
            tuple(sorted(db.key_spaces.items())) if db.key_spaces
            else None,
        )


def plan_signature(plan: PlanNode, db) -> PlanSignature | None:
    """Classify a plan: its scan sites and shape classes when the whole
    tree is fusible, None otherwise. Cheap (no compilation)."""
    sites: list[ScanSite] = []
    by_node: dict[int, ScanSite] = {}
    stages = 0

    def visit(node) -> bool:
        nonlocal stages
        if id(node) in by_node:
            return True  # shared subtree: one site, run once
        if isinstance(node, TableScan):
            src = db.sources.get(node.table)
            if src is None or not hasattr(src, "num_rows"):
                return False
            n = int(src.num_rows)
            if n > FUSE_MAX_ROWS:
                return False
            if _program_has_udf(node.program):
                return False
            if node.program is not None:
                read_cols = required_columns(node.program, src.schema)
            else:
                read_cols = tuple(node.columns if node.columns is not None
                                  else src.schema.names)
            site = ScanSite(
                key=f"t{len(sites)}", table=node.table, node=node,
                read_cols=read_cols,
                in_schema=src.schema.select(read_cols),
                capacity=shape_class(n),
            )
            by_node[id(node)] = site
            sites.append(site)
            stages += 1
            return True
        if isinstance(node, LookupJoin):
            if node.kind not in ("inner", "left", "semi", "anti"):
                return False
            if len(node.probe_keys) > 2:
                return False
            stages += 1
            return visit(node.probe) and visit(node.build)
        if isinstance(node, ExpandJoin):
            if node.kind not in ("inner", "left"):
                return False
            if len(node.probe_keys) > 2:
                return False
            stages += 1
            return visit(node.probe) and visit(node.build)
        if isinstance(node, Transform):
            if _program_has_udf(node.program):
                return False
            stages += 1
            return visit(node.input)
        if isinstance(node, Concat):
            stages += 1
            return all(visit(i) for i in node.inputs)
        return False

    if not visit(plan):
        return None
    return PlanSignature(plan=plan, sites=sites, fused_stages=stages)


# plan_signature memo, keyed by id(plan): plans reused across statements
# keep their identity, and the value holds sig.plan (a strong ref), so
# the id cannot be recycled while the entry lives; an ``is`` check
# guards the lookup anyway. Validators re-check the db-dependent inputs
# (source identity, row count, schema identity) in O(sites). Only
# fusible results memoize.
_SIG_CACHE_ENTRIES = 256
_sig_cache: "collections.OrderedDict" = collections.OrderedDict()
_sig_lock = threading.Lock()


def plan_signature_cached(plan: PlanNode, db) -> PlanSignature | None:
    """``plan_signature`` behind an identity-keyed memo with O(sites)
    revalidation: the per-statement entry point."""
    key = id(plan)
    with _sig_lock:
        hit = _sig_cache.get(key)
        if hit is not None:
            sig, validators = hit
            if sig.plan is plan and _sig_valid(validators, db):
                _sig_cache.move_to_end(key)
                return sig
            del _sig_cache[key]
    # signature-cache miss: one classification walk, then memoized
    # ydb-lint: disable=H004
    sig = plan_signature(plan, db)
    if sig is None:
        return None
    validators = tuple(
        (s.table, id(src), int(src.num_rows), id(src.schema))
        for s in sig.sites
        for src in (db.sources.get(s.table),))
    with _sig_lock:
        _sig_cache[key] = (sig, validators)
        _sig_cache.move_to_end(key)
        while len(_sig_cache) > _SIG_CACHE_ENTRIES:
            _sig_cache.popitem(last=False)
    return sig


def _sig_valid(validators, db) -> bool:
    for table, src_id, n, sch_id in validators:
        src = db.sources.get(table)
        if src is None or id(src) != src_id:
            return False
        if int(src.num_rows) != n or id(src.schema) != sch_id:
            return False
    return True


def _union_nullability(schemas: list[dtypes.Schema]) -> dtypes.Schema:
    """Concat's output schema: a column is nullable as soon as ANY
    branch's is (mirrors blocks.concat_blocks)."""
    base = schemas[0]
    return dtypes.Schema(tuple(
        dtypes.Field(f.name, f.type,
                     any(s.field(f.name).nullable for s in schemas))
        for f in base.fields))


def lookup_schema(node: LookupJoin, p_sch: dtypes.Schema,
                  b_sch: dtypes.Schema) -> dtypes.Schema:
    """run_equi_join's output schema for a lookup join node."""
    if node.kind in ("semi", "anti"):
        return p_sch
    fields = list(p_sch.fields)
    for n in node.payload:
        f = b_sch.field(n)
        fields.append(dtypes.Field(
            n + node.suffix, f.type,
            f.nullable or node.kind == "left"))
    return dtypes.Schema(tuple(fields))


def expand_schema(node: ExpandJoin, p_sch: dtypes.Schema,
                  b_sch: dtypes.Schema) -> dtypes.Schema:
    """expand_join's output schema for an expand join node."""
    fields = [p_sch.field(n) for n in node.probe_payload]
    for n in node.build_payload:
        f = b_sch.field(n)
        fields.append(dtypes.Field(
            n + node.build_suffix, f.type,
            f.nullable or node.kind == "left"))
    return dtypes.Schema(tuple(fields))


# ---------------- CUDA graphs ----------------

#: device index -> (lock, fusion stream): every capture and replay on a
#: device holds its lock and runs on its stream (see the module docstring)
_devices: dict = {}
_devices_lock = threading.Lock()


def _device_state(dev: torch.device):
    with _devices_lock:
        st = _devices.get(dev.index)
        if st is None:
            st = _devices[dev.index] = (threading.RLock(),
                                        torch.cuda.Stream(dev))
        return st


def _empty_block(schema: dtypes.Schema, capacity: int,
                 dev: torch.device) -> TableBlock:
    """A zeroed block of ``capacity`` rows, length 0: a static input."""
    cols = {
        f.name: Column(
            torch.zeros(capacity, dtype=dtypes.torch_dtype(f.type),
                        device=dev),
            torch.zeros(capacity, dtype=torch.bool, device=dev))
        for f in schema.fields}
    return TableBlock(cols, torch.zeros((), dtype=torch.int32, device=dev),
                      schema)


def _copy_block(dst: TableBlock, src: TableBlock) -> None:
    """Copy ``src``'s rows, validity and length into ``dst`` (same
    schema, same capacity)."""
    if src.capacity != dst.capacity:
        raise ValueError(
            f"staged block of capacity {src.capacity}, expected "
            f"{dst.capacity}")
    for n, c in dst.columns.items():
        s = src.columns[n]
        c.data.copy_(s.data)
        c.validity.copy_(s.validity)
    dst.length.copy_(src.length)


def _clone_block(b: TableBlock) -> TableBlock:
    return TableBlock(
        {n: Column(c.data.clone(), c.validity.clone())
         for n, c in b.columns.items()},
        b.length.clone(), b.schema)


def _pool_bytes(graph) -> int | None:
    """Bytes of the segments the caching allocator holds for ``graph``'s
    private pool (None where this torch's snapshot does not say)."""
    pool = tuple(graph.pool())
    segs = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in s for s in segs):
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == pool)


class _Captured:
    """One captured CUDA graph: its static inputs (one dict of blocks per
    member; views of one stacked block per site for ``run_stacked``), its
    static outputs, and the CUDA kernel launches it holds."""

    def __init__(self, graph, inputs, out, totals, launches, pool_bytes,
                 ticket=None):
        self.graph = graph
        self.inputs = inputs      # list[dict[key, TableBlock]]
        self.out = out            # TableBlock (stacked when batch > 1)
        self.totals = totals      # int64 (batch, slots) tensor or None
        self.launches = launches  # kernel -> launches per replay
        self.pool_bytes = pool_bytes
        self.ticket = ticket      # memsan charge of the graph's state

    def reset(self) -> None:
        """Free the graph with its private pool (and its memsan charge)."""
        self.graph.reset()
        memsan.release(self.ticket)


class FusedPlan:
    """A whole-plan computation + its staging contract.

    Cached per (plan fingerprint, shape-class vector). ``run`` is one
    dispatch (one graph replay on CUDA); ``grow`` widens an expand join's
    static capacity after an overflow and drops every graph, which bakes
    the old capacity in, with its pool."""

    def __init__(self, sites, out_schema, aux, run_all, expand_caps,
                 fused_stages, device):
        self.sites = sites
        self.out_schema = out_schema
        self.aux = aux                  # on the device, prefixed
        self._run_all = run_all
        self.expand_caps = expand_caps  # mutable: grows on overflow
        self.fused_stages = fused_stages
        self.device = device
        self.first_trace_seconds: float | None = None
        #: of which capture (warm-up excluded), CUDA only
        self.capture_seconds: float | None = None
        self.replays = 0
        self.captures = 0
        self.grows = 0
        self._cuda = device.type == "cuda"
        if self._cuda:
            self.lock, self._stream = _device_state(device)
        else:
            self.lock, self._stream = threading.RLock(), None
        self._inputs: dict | None = None  # the serial graph's static inputs
        self._inputs_ticket = None  # their memsan charge
        # "serial" (run) or a batch size (run_stacked) -> _Captured
        self._graphs: dict = {}

    # ---- staging ----

    def input_block(self, key: str) -> TableBlock:
        """The serial graph's static input block for site ``key`` (CUDA
        only), allocated at first use; ``stage_into`` fills it."""
        if self._inputs is None:
            with memsan.seam():
                self._inputs = {s.key: _empty_block(s.in_schema,
                                                    s.capacity, self.device)
                                for s in self.sites}
            if memsan.armed():
                self._inputs_ticket = memsan.charge(
                    memsan.nbytes_of(self._inputs), "graph_pool",
                    owner="input_block")
        return self._inputs[key]

    def stage_into(self, key: str, arrays: dict, validity: dict | None,
                   n: int) -> TableBlock:
        """Copy a table's ``n`` rows (host arrays or tensors) into site
        ``key``'s static input block and return that block: padding gets
        zeros and False validity. Ordered after any replay still reading
        the block."""
        blk = self.input_block(key)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        for name, c in blk.columns.items():
            a = arrays[name]
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(a)
            c.data[:n].copy_(a)
            c.data[n:].zero_()
            v = None if validity is None else validity.get(name)
            if v is None:
                c.validity[:n].fill_(True)
            else:
                if not isinstance(v, torch.Tensor):
                    v = torch.from_numpy(v)
                c.validity[:n].copy_(v)
            c.validity[n:].fill_(False)
        blk.length.fill_(n)
        return blk

    # ---- dispatch ----

    def run(self, inputs: dict) -> tuple[TableBlock, list[int]]:
        """One dispatch: (result block, expand totals). On CUDA, inputs
        that are not already this plan's static input blocks are copied
        into them, the graph replays (captured at the first run), and the
        result is a clone of its output; the totals are read with one
        host sync (none when the plan has no expand join). The caller's
        blocks are never written."""
        if not self._cuda:
            return self._run_eager([inputs], stacked=False)
        with self.lock:
            cap = self._graphs.get("serial")
            static = [{s.key: self.input_block(s.key) for s in self.sites}]
            self._load(static, [inputs])
            if cap is None:
                cap = self._capture(static)
                self._graphs["serial"] = cap
            return self._replay(cap, stacked=False)

    def run_shared(self, inputs: dict) -> tuple[TableBlock, list[int]]:
        """Dispatch over staged blocks that other statements may still
        read (the batched serving tier's shared-scan path). The port never
        donates: this is :meth:`run`, which copies them into the graph's
        static inputs and leaves them untouched."""
        return self.run(inputs)

    def run_stacked(self, inputs_list: list[dict]) \
            -> tuple[TableBlock, list[int]]:
        """One dispatch over B members' staged inputs: on CUDA, one
        replay of a graph captured per batch size that runs ``run_all``
        over B static input sets. Returns the batched result (leading dim
        B on every column and on the length) plus per-expand-slot totals
        MAXed over members (the widest member governs the grow protocol,
        as in the reference). ``slice_member`` takes member i's block."""
        batch = len(inputs_list)
        if not self._cuda:
            with memsan.seam():
                stacked = _stack_members(inputs_list)
            # the stack copy is transient: its bytes release once the
            # batched result exists
            ticket = memsan.charge(
                memsan.nbytes_of(stacked), "stack",
                owner="run_stacked") if memsan.armed() else None
            try:
                return self._run_eager(_members(stacked, batch),
                                       stacked=True)
            finally:
                memsan.release(ticket)
        with self.lock:
            cap = self._graphs.get(batch)
            if cap is None:
                # one stacked static block per site; each member runs on
                # its slice (charged with the graph's pool at capture)
                with memsan.seam():
                    static = _members(_stack_members([
                        {s.key: _empty_block(s.in_schema, s.capacity,
                                             self.device)
                         for s in self.sites}] * batch), batch)
            else:
                static = cap.inputs
            self._load(static, inputs_list)
            if cap is None:
                cap = self._capture(static, stacked=True)
                self._graphs[batch] = cap
            return self._replay(cap, stacked=True)

    def _run_eager(self, inputs_list, stacked: bool):
        t0 = time.perf_counter()
        outs, totals = [], []
        with memsan.seam():
            for inputs in inputs_list:
                out, tot = self._run_all(inputs, self.aux)
                outs.append(out)
                totals.append([int(t) for t in tot])
            out = _stack_blocks(outs) if stacked else outs[0]
        if self.first_trace_seconds is None:
            # the eager path runs only off CUDA, where nothing captures:
            # capture_lock's writers never meet this one
            # ydb-lint: disable=C001
            self.first_trace_seconds = time.perf_counter() - t0
        worst = [max(ts) for ts in zip(*totals)]
        if memsan.armed():
            memsan.charge(memsan.nbytes_of(out), "dispatch",
                          owner="run_stacked" if stacked else "run")
        return out, worst

    def _load(self, static: list, inputs_list: list) -> None:
        """Copy each member's blocks into its static input set, on the
        fusion stream, after the caller's stream has produced them."""
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            for dst, src in zip(static, inputs_list):
                for k, blk in src.items():
                    if blk is not dst[k]:
                        _copy_block(dst[k], blk)

    def _run_members(self, static: list, stacked: bool):
        outs, totals = [], []
        for inputs in static:
            out, tot = self._run_all(inputs, self.aux)
            outs.append(out)
            totals.append(torch.stack(tot) if tot else None)
        out = _stack_blocks(outs) if stacked else outs[0]
        tot = (torch.stack(totals) if totals[0] is not None else None)
        return out, tot

    @host_ok("graph capture: reached only on a plan's first run (or a"
             " batch size's, or after grow); the captured graph is cached"
             " on the plan and every later run replays it")
    def _capture(self, static: list, stacked: bool = False) -> _Captured:
        """Warm up, then capture ``run_all`` over ``static`` (one replay
        then serves every member) on the fusion stream, holding
        ``device.work_lock`` exclusively (no other statement thread does
        device work meanwhile) and ``capture_lock`` (nor does a worker
        thread). Raises ``CaptureNeedsExclusive`` when another thread
        holds ``work_lock``: waiting for it here, under the plan's lock,
        could deadlock."""
        if not work_lock.try_exclusive():
            raise CaptureNeedsExclusive()
        try:
            with capture_lock:
                return self._capture_locked(static, stacked)
        finally:
            work_lock.release_exclusive()

    def _capture_locked(self, static: list, stacked: bool) -> _Captured:
        from ydb_tpu_torch.ssa import cuda_kernels

        s = self._stream
        t0 = time.perf_counter()
        syncsan.count(captures=1)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(s), memsan.seam():
                self._run_members(static, stacked)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        s.synchronize()
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = dict(cuda_kernels.CAPTURED)
        # no garbage collection inside the capture: collecting an earlier
        # plan's graph or tensors there would call the CUDA API (graph
        # destroy, event record) and invalidate the capture
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=s,
                                  capture_error_mode="thread_local"), \
                    memsan.seam():
                out, totals = self._run_members(static, stacked)
        finally:
            if gc_was_on:
                gc.enable()
        launches = {k: cuda_kernels.CAPTURED[k] - before[k] for k in before}
        t2 = time.perf_counter()
        self.captures += 1
        self.capture_seconds = (self.capture_seconds or 0.0) + t2 - t1
        self.first_trace_seconds = (
            (self.first_trace_seconds or 0.0) + t2 - t0)
        pool = _pool_bytes(graph)
        ticket = None
        if memsan.armed():
            # the graph's private pool, plus a batch size's own stacked
            # static inputs (the serial ones are charged at first use)
            own = memsan.nbytes_of(static) if stacked else 0
            ticket = memsan.charge((pool or 0) + own, "graph_pool",
                                   owner="capture")
        return _Captured(graph, static, out, totals, launches, pool,
                         ticket)

    def _replay(self, cap: _Captured, stacked: bool):
        from ydb_tpu_torch.ssa import cuda_kernels

        cur = torch.cuda.current_stream(self.device)
        # the replay's host enqueue lands on the timeline (no sync: the
        # block boundary shows where results landed)
        t0 = time.perf_counter() if timeline.timeline_enabled() else None
        with torch.cuda.stream(self._stream):
            cap.graph.replay()
        if t0 is not None:
            timeline.RING.record("plan.dispatch", "dispatch", t0,
                                 time.perf_counter(),
                                 timeline.current_trace_id())
        self.replays += 1
        cuda_kernels.count_replay(cap.launches)
        # the clone runs on the caller's stream after the replay, and the
        # next replay waits for it (a block handed out is never
        # overwritten)
        cur.wait_stream(self._stream)
        out = _clone_block(cap.out)
        if memsan.armed():
            memsan.charge(memsan.nbytes_of(out), "dispatch",
                          owner="run_stacked" if stacked else "run")
        # the dispatch's one host sync (none without an expand join):
        # the expand totals decide the grow protocol
        # ydb-lint: disable=H001
        host = cap.totals.cpu() if cap.totals is not None else None
        self._stream.wait_stream(cur)
        if host is None:
            return out, []
        worst = host.amax(dim=0) if stacked else host[0]
        return out, [int(t) for t in worst]

    @property
    def pool_bytes(self) -> int | None:
        """Bytes held by the private pools of this plan's graphs."""
        sizes = [c.pool_bytes for c in self._graphs.values()]
        if any(b is None for b in sizes):
            return None
        return sum(sizes)

    def release(self) -> None:
        """Free every graph with its private pool and the serial static
        inputs (the plan left its cache); a later run captures anew."""
        with self.lock:
            for cap in self._graphs.values():
                cap.reset()
            self._graphs.clear()
            self._inputs = None
            memsan.release(self._inputs_ticket)
            self._inputs_ticket = None

    def overflowed(self, totals: list[int]) -> list[int]:
        """Expand-join indexes whose match total exceeded capacity."""
        return [i for i, t in enumerate(totals)
                if t > self.expand_caps[i]]

    def grow(self, idx: int, total: int) -> None:
        """Widen expand join ``idx`` to hold ``total`` rows (rounded to
        the capacity quantum, run_equi_join's exact-retry step) and free
        every graph with its pool: each bakes the old capacity in, and
        the next run captures anew. The serial static inputs stay, with
        their staged rows."""
        q = DEFAULT_CAPACITY_QUANTUM
        self.expand_caps[idx] = (total + q - 1) // q * q
        self.grows += 1
        with self.lock:
            for cap in self._graphs.values():
                cap.reset()
            self._graphs.clear()


def _stack_blocks(blocks: list[TableBlock]) -> TableBlock:
    """Blocks of one schema and capacity stacked along a new leading
    axis (every column and the length): a batched block."""
    first = blocks[0]
    cols = {n: Column(torch.stack([b.columns[n].data for b in blocks]),
                      torch.stack([b.columns[n].validity for b in blocks]))
            for n in first.columns}
    return TableBlock(cols, torch.stack([b.length for b in blocks]),
                      first.schema)


def _stack_members(inputs_list: list[dict]) -> dict:
    """B members' staged inputs stacked along a new leading axis, site by
    site (fresh tensors: the members' blocks are not touched)."""
    return {k: _stack_blocks([m[k] for m in inputs_list])
            for k in inputs_list[0]}


def _members(stacked: dict, batch: int) -> list[dict]:
    """Each member's inputs as views of the stacked blocks."""
    return [{k: slice_member(b, i) for k, b in stacked.items()}
            for i in range(batch)]


def slice_member(out: TableBlock, i: int) -> TableBlock:
    """Member ``i``'s result out of a :meth:`FusedPlan.run_stacked`
    batched block: the leading batch axis indexed off every column and
    the length, a plain TableBlock like a serial run's."""
    return TableBlock(
        {n: Column(c.data[i], c.validity[i]) for n, c in out.columns.items()},
        out.length[i], out.schema)


def build(sig: PlanSignature, db) -> FusedPlan:
    """Compile a fusible plan into one FusedPlan: every node's SSA
    program is verified and lowered up front, so the whole pipeline is
    typed end to end before the first run. One ``ssa.compile`` span
    covers the full build (the walk would emit one per fragment)."""
    from ydb_tpu_torch.obs import tracing

    with tracing.span("ssa.compile") as sp:
        fused = _build(sig, db)
        sp.set(fused_stages=fused.fused_stages,
               cols=sum(len(s.read_cols) for s in sig.sites))
    return fused


class PlanLowering:
    """Whole-plan lowering: one walk over the plan tree emitting closures
    per node (the reference's base class, which its mesh lowering
    subclasses)."""

    def __init__(self, sig: PlanSignature, db):
        self.sig = sig
        self.db = db
        self.site_by_node = {id(s.node): s for s in sig.sites}
        self.aux_np: dict = {}
        # grow-protocol capacity slots (FusedPlan.grow): one static
        # capacity per expand join
        self.caps: list[int] = []
        self._lowered: dict[int, tuple] = {}  # id -> (emit, schema, cap)
        self._n_nodes = 0

    def compiled(self, program, schema, dicts, dict_aliases=None,
                 partial_slots: bool = False):
        """Lower one fragment's program; its aux tables merge into the
        plan-wide dict under a per-fragment prefix. Returns (run, cp)."""
        cp = _compile_program(program, schema, dicts, self.db.key_spaces,
                              partial_slots=partial_slots,
                              dict_aliases=dict_aliases)
        pfx = f"n{self._n_nodes}."
        self._n_nodes += 1
        self.aux_np.update({pfx + k: v for k, v in cp.aux.items()})
        keys = tuple(cp.aux.keys())

        def run(block, aux):
            return cp.run(block, {k: aux[pfx + k] for k in keys})

        return run, cp

    def lower(self, node) -> tuple[Callable, dtypes.Schema, int]:
        hit = self._lowered.get(id(node))
        if hit is not None:
            return hit
        emit, sch, cap = self._lower(node)
        nid = id(node)

        # run-time memo: a shared subtree (CTE referenced twice) runs
        # ONCE per run_all, exactly like the walk's _memo
        def memo_emit(inputs, aux, memo, totals, _e=emit, _nid=nid):
            h = memo.get(_nid)
            if h is None:
                h = _e(inputs, aux, memo, totals)
                memo[_nid] = h
            return h

        out = (memo_emit, sch, cap)
        self._lowered[nid] = out
        return out

    def _lower(self, node):
        if isinstance(node, TableScan):
            return self.lower_scan(node)
        if isinstance(node, LookupJoin):
            return self.lower_lookup(node)
        if isinstance(node, ExpandJoin):
            return self.lower_expand(node)
        if isinstance(node, Transform):
            return self.lower_transform(node)
        if isinstance(node, Concat):
            return self.lower_concat(node)
        raise Unfusible(f"node does not lower: {node!r}")

    def lower_scan(self, node: TableScan):
        site = self.site_by_node[id(node)]
        src = self.db.sources[node.table]
        if node.program is None:
            sch = site.in_schema

            def emit(inputs, aux, memo, totals, _k=site.key,
                     _cols=site.read_cols):
                return inputs[_k].select(_cols)

            return emit, sch, site.capacity
        run, cp = self.compiled(
            node.program, site.in_schema,
            getattr(src, "dicts", None) or self.db.dicts)

        def emit(inputs, aux, memo, totals, _k=site.key,
                 _cols=site.read_cols, _run=run):
            return _run(inputs[_k].select(_cols), aux)

        return emit, cp.out_schema, site.capacity

    def lower_lookup(self, node: LookupJoin):
        p_emit, p_sch, p_cap = self.lower(node.probe)
        b_emit, b_sch, _ = self.lower(node.build)
        sch = lookup_schema(node, p_sch, b_sch)

        def emit(inputs, aux, memo, totals, _n=node, _pe=p_emit,
                 _be=b_emit):
            return join_kernels.run_equi_join(
                _pe(inputs, aux, memo, totals),
                _be(inputs, aux, memo, totals),
                _n.probe_keys, _n.build_keys, kind=_n.kind,
                suffix=_n.suffix, payload=_n.payload)

        return emit, sch, p_cap

    def expand_slot(self, probe_cap: int, fanout_hint: float) -> int:
        """Register one expand join's static output capacity; returns the
        slot index (totals[i] carries the match count)."""
        # probe_cap bounds the probe subtree's live rows (group-bys only
        # shrink), sized like run_equi_join's first round; overflow grows
        # it exactly (FusedPlan.grow)
        self.caps.append(max(
            int(probe_cap * fanout_hint), DEFAULT_CAPACITY_QUANTUM))
        return len(self.caps) - 1

    def lower_expand(self, node: ExpandJoin):
        p_emit, p_sch, p_cap = self.lower(node.probe)
        b_emit, b_sch, _ = self.lower(node.build)
        sch = expand_schema(node, p_sch, b_sch)
        ei = self.expand_slot(p_cap, node.fanout_hint)
        caps = self.caps

        def emit(inputs, aux, memo, totals, _n=node, _pe=p_emit,
                 _be=b_emit, _ei=ei):
            out, total = join_kernels.expand_join(
                _pe(inputs, aux, memo, totals),
                _be(inputs, aux, memo, totals),
                list(_n.probe_keys), list(_n.build_keys),
                list(_n.probe_payload), list(_n.build_payload),
                out_capacity=caps[_ei],
                build_suffix=_n.build_suffix, kind=_n.kind)
            totals[_ei] = total
            return out

        # report the initial bound so parents (nested expands) can size
        # their own caps; if this cap later grows the parent under-sizes
        # at worst, and its own overflow check grows it the same way
        return emit, sch, self.caps[ei]

    def lower_transform(self, node: Transform):
        i_emit, i_sch, i_cap = self.lower(node.input)
        run, cp = self.compiled(node.program, i_sch, self.db.dicts,
                                dict_aliases=dict(node.dict_aliases))

        def emit(inputs, aux, memo, totals, _ie=i_emit, _run=run):
            return _run(_ie(inputs, aux, memo, totals), aux)

        return emit, cp.out_schema, i_cap

    def lower_concat(self, node: Concat):
        parts = [self.lower(i) for i in node.inputs]
        sch = _union_nullability([p[1] for p in parts])
        caps = [p[2] for p in parts]
        cap = (sum(caps) if all(c is not None for c in caps)
               else None)

        def emit(inputs, aux, memo, totals, _parts=parts, _sch=sch):
            blocks = [
                # restamp to the union schema so the merged block types
                # like concat_blocks' output
                TableBlock(b.columns, b.length, _sch)
                for b in (p[0](inputs, aux, memo, totals)
                          for p in _parts)
            ]
            return merge_blocks_device(blocks)

        return emit, sch, cap


@host_ok("fused-plan compile: reached only on a compile-cache miss;"
         " the built FusedPlan is cached by plan fingerprint")
def _build(sig: PlanSignature, db) -> FusedPlan:
    lo = PlanLowering(sig, db)
    root, out_schema, _ = lo.lower(sig.plan)
    caps = lo.caps
    dev = resolve_device(db.device)

    def run_all(inputs, aux):
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        totals: list = [zero] * len(caps)
        out = root(inputs, aux, {}, totals)
        return out, tuple(totals)

    return FusedPlan(sig.sites, out_schema, device_aux(lo.aux_np, dev),
                     run_all, caps, sig.fused_stages, dev)
