"""DQ compute actors: task execution with credit-based channel flow.

The port's own copy of ``ydb_tpu/dq/compute.py``. Mirror of the
reference's compute-actor framework (SURVEY.md §2.10): a generic actor
hosts one task's program, drives its input/output channels with a
credit protocol (TEvChannelData / TEvChannelDataAck,
dq_compute_actor_channels.h:15), spills backlog beyond the memory quota
(spilling service), and streams the result channel to the executer.

Device work happens inside the task: each arriving block lifts to a
TableBlock on the graph's device (CUDA unless the caller names another),
runs the stage's compiled SSA program there, and the result travels the
channels host-side as a numpy payload, as in the reference: the spiller,
checkpoints and the wire transport (``dq/node_service.py``) stay
byte-compatible with it. A hash fan-out groups a block's rows by
destination on the device before the one fetch (``_split_block``), so
the host cuts the payload into slices instead of gathering each column
once a destination; the parts are the reference's.
Where the reference jits the per-block program and the fused
merge-plus-final, the port calls them eagerly on the stage's device.
Under an active trace each task is a ``dq.task`` span carrying its
dispatch seconds (host clock around the eager calls).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np
import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis import host_ok, memsan
from ydb_tpu_torch.blocks.block import (Column, TableBlock, concat_blocks,
                                        device_aux)
from ydb_tpu_torch.device import resolve_device
from ydb_tpu_torch.dq.graph import (
    ChannelSpec,
    HashPartition,
    ResultOutput,
    SourceInput,
    StageSpec,
    TaskSpec,
    build_tasks,
)
from ydb_tpu_torch.dq.spilling import Spiller
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.engine.scan import ColumnSource, merge_blocks_device
from ydb_tpu_torch.runtime.actors import Actor, ActorId
from ydb_tpu_torch.ssa.compiler import compile_program

DEFAULT_WINDOW = 4  # unacked blocks per channel before spilling


# ---- channel protocol messages ----


@dataclasses.dataclass
class ChannelData:
    channel_id: int
    seq: int
    payload: dict | None
    finished: bool


@dataclasses.dataclass
class ChannelAck:
    channel_id: int
    seq: int


@dataclasses.dataclass
class StartTask:
    pass


@dataclasses.dataclass
class WireTask:
    """Late channel wiring: consumer ActorIds for this task's output
    channels (possibly on other NODES — the targets ride the
    interconnect transparently), plus where results and aborts go.
    Sent by the executer after every task everywhere has registered
    (the two-phase start the reference's executer does when it wires
    TEvChannelData routes across compute nodes)."""

    channel_targets: dict[int, ActorId]
    result_target: ActorId | None = None
    abort_target: ActorId | None = None


@dataclasses.dataclass
class QueryAborted:
    """Fatal query error: propagated to the collector so a dead peer
    (Undelivered channel data) fails the query cleanly instead of
    hanging it (TEvAbortExecution shape, dq_compute_actor.h:41)."""

    reason: str


@dataclasses.dataclass
class _PumpSource:
    """Self-message: consume ONE source block, then re-arm. Keeps the
    mailbox responsive between blocks so checkpoint barriers (and any
    control traffic) interleave with streaming reads."""


@dataclasses.dataclass
class ResultData:
    payload: dict | None
    finished: bool


# ---- payload <-> block ----


def block_to_payload(block: TableBlock) -> dict:
    # one batched device fetch serves data and validity together
    data, valid = block.host_columns()
    out = {}
    for k, v in data.items():
        out[k] = v
        out[f"__v_{k}"] = valid[k]
    return out


def payload_to_block(payload: dict, schema: dtypes.Schema,
                     device: "str | torch.device | None" = None
                     ) -> TableBlock:
    cols = {f.name: payload[f.name] for f in schema.fields}
    validity = {f.name: payload[f"__v_{f.name}"] for f in schema.fields}
    return TableBlock.from_numpy(cols, schema, validity, device=device)


def _hash_rows(payload: dict, schema, keys) -> np.ndarray:
    """Row hash for partition routing (the vectorized block hash
    partitioner, dq_output_consumer.cpp:338); computed once per block and
    reduced mod the channel count per consumer group. Host numpy, bit
    for bit the reference's hash (ydb_tpu_torch.native)."""
    from ydb_tpu_torch import native

    return native.hash_rows(
        [payload[k] for k in keys],
        [payload[f"__v_{k}"] for k in keys],
    )


def _route_block(block: TableBlock, keys, n: int) -> TableBlock:
    """The block's rows grouped by destination on its device, rows in
    order within each group (a stable sort by ``hash % n``; dead rows
    last): the device hash of ``parallel.shuffle`` gives
    ``_hash_rows``'s bits."""
    from ydb_tpu_torch.parallel.shuffle import dest_shard, hash_rows

    # the routing's tensors are the dispatch's working set
    with memsan.seam():
        dest = dest_shard(hash_rows([block.columns[k] for k in keys]), n)
        order = torch.argsort(torch.where(block.row_mask(), dest, n),
                              stable=True)
        cols = {k: Column(c.data[order], c.validity[order])
                for k, c in block.columns.items()}
        return TableBlock(cols, block.length, block.schema)


def _split_block(block: TableBlock, schema, keys, n: int) -> list[dict]:
    """The parts ``_split_by_hash`` gives for this block's payload: rows
    grouped by destination on the device (``_route_block``), fetched
    once, and cut into slices where the host hash of the fetched keys
    says each destination starts; no host gather."""
    payload = block_to_payload(_route_block(block, keys, n))
    dest = (_hash_rows(payload, schema, keys) % np.uint64(n)).astype(
        np.int64)
    if len(dest) and (dest[1:] < dest[:-1]).any():
        raise AssertionError("device and host row hashes disagree")
    bounds = np.r_[0, np.cumsum(np.bincount(dest, minlength=n))].tolist()
    return [{k: v[bounds[d]:bounds[d + 1]] for k, v in payload.items()}
            for d in range(n)]


def _split_by_hash(payload: dict, h: np.ndarray, n: int) -> list[dict]:
    """Host routing of a fetched payload (the reference's; the tests
    hold ``_split_block`` against it)."""
    if n == 1:
        return [payload]
    dest = (h % np.uint64(n)).astype(np.int64)
    out = []
    for d in range(n):
        # the reference masks every column with ``dest == d``; gathering
        # by the mask's row indices gives the same parts, rows in the
        # same order, at a fifth of the host time
        idx = np.flatnonzero(dest == d)
        out.append({k: v.take(idx) for k, v in payload.items()})
    return out


class _CompiledStage:
    """Per-stage compiled programs + schemas (shared by its tasks).

    ``in_schemas`` has one schema per stage input; join stages have two
    (probe, build) and every other stage exactly one shared schema.
    Programs run eagerly on ``device``, where their aux tables are
    staged once."""

    def __init__(self, spec: StageSpec, in_schemas, dicts, key_spaces,
                 device: torch.device):
        self.device = device
        self.in_schemas = list(in_schemas)
        in_schema = in_schemas[0]
        self.in_schema = in_schema
        if spec.join is not None:
            self.per_block = None
            self.final = None
            self.join = spec.join
            self.out_schema = _join_out_schema(
                spec.join, in_schemas[0], in_schemas[1])
            self.mid_schema = self.out_schema
            return
        self.join = None
        if spec.program is not None:
            self.per_block = compile_program(
                spec.program, in_schema, dicts, key_spaces,
                dict_aliases=dict(spec.dict_aliases),
            )
            mid = self.per_block.out_schema
            self._pb_aux = device_aux(self.per_block.aux, device)
        else:
            self.per_block = None
            mid = in_schema
        self.mid_schema = mid
        if spec.final_program is not None:
            from ydb_tpu_torch.ssa import twophase

            aliases = dict(spec.dict_aliases)
            if spec.program is not None:
                aliases.update(twophase.dict_aliases(spec.program))
            self.final = compile_program(
                spec.final_program, mid, dicts, key_spaces,
                dict_aliases=aliases,
            )
            self._f_aux = device_aux(self.final.aux, device)
            self.out_schema = self.final.out_schema
        else:
            self.final = None
            self.out_schema = mid
            self._f_aux = {}

    def run_block(self, block: TableBlock) -> TableBlock:
        if self.per_block is None:
            return block
        return self.per_block.run(block, self._pb_aux)

    def run_join(self, probe: TableBlock, build: TableBlock) -> TableBlock:
        """Device-local join of this task's hash bucket (grace bucket
        join, mkql_grace_join_imp.cpp bucket processing). Shares the
        exact dispatch with the single-chip executor (run_equi_join)."""
        from ydb_tpu_torch.ssa import join as join_kernels

        j = self.join
        return join_kernels.run_equi_join(
            probe, build, j.probe_keys, j.build_keys, kind=j.kind,
            suffix=j.suffix, expand=j.expand, payload=j.payload,
            probe_payload=j.probe_payload, build_payload=j.build_payload,
        )

    def run_final(self, blocks: list[TableBlock]) -> TableBlock:
        """The stage's whole final phase: merge the accumulated partials
        on the device (the fused finalize of the single-chip
        ScanExecutor), then the final program; partials never
        round-trip through the host between merge and final."""
        if self.final is None and len(blocks) == 1:
            return blocks[0]
        merged = merge_blocks_device(list(blocks))
        if self.final is None:
            return merged
        return self.final.run(merged, self._f_aux)


class ComputeActor(Actor):
    """Hosts one task (sync compute actor variant,
    dq_compute_actor_impl.h:95)."""

    def __init__(
        self,
        task: TaskSpec,
        compiled: _CompiledStage,
        channel_targets: dict[int, ActorId],  # my out channel -> consumer
        channel_specs: dict[int, ChannelSpec],
        sources: list[ColumnSource],
        result_target: ActorId | None,
        spiller: Spiller | None = None,
        window: int = DEFAULT_WINDOW,
        block_rows: int = 1 << 16,
        checkpoint_storage=None,
        restore_checkpoint: int | None = None,
    ):
        super().__init__()
        self.task = task
        self.compiled = compiled
        self.channel_targets = channel_targets
        self.channel_specs = channel_specs
        self.sources = sources
        self.result_target = result_target
        self.window = window
        self.block_rows = block_rows
        self.spiller = spiller or Spiller()
        self.abort_target: ActorId | None = None
        self._aborted = False
        # profile span for this task (opened at StartTask when a query
        # trace is active on the executer thread; finished with the
        # task's accumulated device-compute seconds)
        self._span = None
        self._compute_s = 0.0

        self._in_finished: set[int] = set()
        # agg stages accumulate partial states THROUGH the spiller
        # (operator spilling: beyond the memory quota the partials live
        # in blobs, not RAM — dq_spilling + combiner spill analog)
        self._acc_ids: list[int] = []
        # join stages accumulate their hash bucket per side (payloads
        # stay host-side until the single device-local bucket join)
        self._join_acc: dict[int, list] = {0: [], 1: []}
        self._unacked: dict[int, int] = {c: 0 for c in task.output_channels}
        self._parked: dict[int, collections.deque] = {
            c: collections.deque() for c in task.output_channels
        }
        self._next_seq: dict[int, int] = {c: 0 for c in task.output_channels}
        self._fin_pending: set[int] = set()
        self._done = False
        groups: dict[tuple[int, int], list[int]] = {}
        for c in task.output_channels:
            spec = channel_specs[c]
            groups.setdefault((spec.dst_stage, spec.input_index),
                              []).append(c)
        # hash slot p must land on the consumer task with dst_index p
        self._consumer_groups: list[list[int]] = [
            sorted(chs, key=lambda c: channel_specs[c].dst_index)
            for chs in groups.values()
        ]

        # ---- checkpoint state (IDqTaskRunner Save/Load analog) ----
        self.checkpoint_storage = checkpoint_storage
        self.coordinator_target: ActorId | None = None
        self._source_iter = None
        self._source_pos = 0          # blocks consumed from sources
        self._source_done = not sources
        self._aligned: dict[int, set] = {}   # ckpt id -> aligned channels
        self._barrier_of: dict[int, int] = {}  # channel -> pending ckpt
        # channel -> post-barrier msgs (FIFO; drained with popleft)
        self._held: dict[int, collections.deque] = {}
        if restore_checkpoint is not None and checkpoint_storage:
            state = checkpoint_storage.load_task(
                restore_checkpoint, task.task_id)
            if state is not None:
                self._acc_ids = [
                    self.spiller.put(p) for p in state["acc"]
                ]
                self._join_acc = {
                    int(k): list(v)
                    for k, v in state.get("join_acc", {}).items()
                } or {0: [], 1: []}
                self._source_pos = state["source_pos"]
                self.block_rows = state["block_rows"]
                self._in_finished = set(state["in_finished"])

    # ---- input side ----

    def receive(self, message, sender):
        from ydb_tpu_torch.dq.checkpoint import InjectCheckpoint
        from ydb_tpu_torch.runtime.interconnect import Undelivered

        if isinstance(message, StartTask):
            from ydb_tpu_torch.obs import tracing

            parent = tracing.current_span()
            if parent is not None and self._span is None:
                self._span = parent.child("dq.task").set(
                    stage=self.task.stage, task=self.task.task_id,
                    thread=threading.get_ident())
            self._start_source()
        elif isinstance(message, _PumpSource):
            if not self._aborted:
                self._pump_source()
        elif isinstance(message, WireTask):
            self.channel_targets.update(message.channel_targets)
            if message.result_target is not None:
                self.result_target = message.result_target
            if message.abort_target is not None:
                self.abort_target = message.abort_target
        elif isinstance(message, InjectCheckpoint):
            # source-side barrier injection: snapshot between blocks
            self._take_checkpoint(message.checkpoint_id)
        elif isinstance(message, ChannelData):
            self.send(sender, ChannelAck(message.channel_id, message.seq))
            if not self._aborted:
                self._on_channel_data(message)
        elif isinstance(message, ChannelAck):
            self._on_ack(message)
        elif isinstance(message, Undelivered):
            # a peer died with our channel data in flight: the query
            # cannot complete — abort it at the collector and stop
            # feeding the graph from this task
            self._aborted = True
            if self.abort_target is not None:
                self.send(self.abort_target, QueryAborted(
                    f"task {self.task.task_id}: channel data undelivered "
                    f"({message.reason})"))
        elif isinstance(message, QueryAborted):
            self._aborted = True
        else:
            raise TypeError(message)

    def _on_channel_data(self, message: ChannelData):
        from ydb_tpu_torch.dq.checkpoint import BARRIER_KEY

        ch = message.channel_id
        # anything arriving on a channel that already delivered a
        # barrier for a pending checkpoint belongs to a later epoch:
        # hold it, in arrival order, until that checkpoint is taken.
        # Per-channel FIFO keeps multiple in-flight checkpoints
        # consistent — each release stops at the channel's next barrier.
        if ch in self._barrier_of:
            self._held.setdefault(ch, collections.deque()).append(message)
            return
        payload = message.payload
        if payload is not None and BARRIER_KEY in payload:
            self._register_barrier(int(payload[BARRIER_KEY]), ch)
            return
        self._apply_channel_data(message)

    def _apply_channel_data(self, message: ChannelData):
        if message.payload is not None:
            if self.compiled.join is not None:
                idx = self.channel_specs[message.channel_id].input_index
                self._join_acc[idx].append(message.payload)
            else:
                blk = payload_to_block(message.payload,
                                       self.compiled.in_schema,
                                       self.compiled.device)
                self._ingest(blk)
        if message.finished:
            self._in_finished.add(message.channel_id)
            self._check_alignment()  # finished counts as aligned
            if self._in_finished >= set(self.task.input_channels):
                self._finish_input()

    # ---- checkpoint protocol ----

    def _register_barrier(self, checkpoint_id: int, channel_id: int):
        self._barrier_of[channel_id] = checkpoint_id
        self._aligned.setdefault(checkpoint_id, set()).add(channel_id)
        self._check_alignment()

    def _check_alignment(self):
        need = set(self.task.input_channels)
        while self._aligned:
            # checkpoints must be taken in id order; per-channel FIFO
            # guarantees the smallest pending id aligns first
            cid = min(self._aligned)
            if not (self._aligned[cid] | self._in_finished) >= need:
                return
            self._take_checkpoint(cid)

    def _take_checkpoint(self, checkpoint_id: int):
        from ydb_tpu_torch.dq.checkpoint import BARRIER_KEY, TaskCheckpointed

        if self.checkpoint_storage is not None:
            self.checkpoint_storage.save_task(checkpoint_id,
                                              self.task.task_id, {
                "acc": [self.spiller.peek(sid)
                        for sid in self._acc_ids],
                # join stages: both sides' accumulated bucket payloads
                "join_acc": {k: list(v)
                             for k, v in self._join_acc.items()},
                # position is counted in BLOCKS of this block size; the
                # restore pins block_rows so the count stays meaningful
                "source_pos": self._source_pos,
                "block_rows": self.block_rows,
                "in_finished": sorted(self._in_finished),
            })
        # forward the barrier in band on EVERY output channel (parks
        # behind pending data, so it cannot overtake blocks)
        if not isinstance(self.task.stage_spec.output, ResultOutput):
            # numpy value so the credit queue/spiller treat the barrier
            # exactly like a (tiny) data payload
            barrier = {BARRIER_KEY: np.asarray(checkpoint_id)}
            for ch in self.task.output_channels:
                self._send_channel(ch, barrier)
        if self.coordinator_target is not None:
            self.send(self.coordinator_target,
                      TaskCheckpointed(self.task.task_id, checkpoint_id))
        # release each aligned channel's held messages up to (and
        # registering) that channel's next barrier, in arrival order
        chans = self._aligned.pop(checkpoint_id, set())
        for ch in sorted(chans):
            if self._barrier_of.get(ch) == checkpoint_id:
                del self._barrier_of[ch]
            q = self._held.get(ch, collections.deque())
            while q:
                msg = q.popleft()
                payload = msg.payload
                if payload is not None and BARRIER_KEY in payload:
                    self._register_barrier(int(payload[BARRIER_KEY]), ch)
                    break
                self._apply_channel_data(msg)
            if not q:
                self._held.pop(ch, None)

    # ---- source streaming ----

    def _start_source(self):
        # scan stages stream only the program's required columns (the
        # scan-executor projection, ScanExecutor.read_cols): stream
        # sources then skip unread chunks entirely
        names = None
        if self.compiled.per_block is not None:
            names = self.compiled.in_schema.names

        def blocks(skip: int):
            # checkpoint resume: seek in O(1) per source rather than
            # materializing and discarding consumed blocks (n_blocks is
            # only required of sources that actually resume)
            for source in self.sources:
                if skip:
                    nb = source.n_blocks(self.block_rows)
                    if skip >= nb:
                        skip -= nb
                        continue
                yield from source.blocks(self.block_rows, columns=names,
                                         start_block=skip,
                                         device=self.compiled.device)
                skip = 0

        self._source_iter = blocks(self._source_pos)
        if self.sources:
            self.send(self.self_id, _PumpSource())
        elif not self.task.input_channels:
            self._finish_input()

    def _pump_source(self):
        # block-boundary cancellation: a statement past its deadline
        # stops pumping and aborts the whole graph (the collector turns
        # this into a typed StatementCancelled at the executor)
        from ydb_tpu_torch.chaos import deadline as statement_deadline

        dl = statement_deadline.current()
        if dl is not None and dl.expired():
            self._aborted = True
            if self.abort_target is not None:
                self.send(self.abort_target, QueryAborted(
                    f"task {self.task.task_id}: statement deadline "
                    "exceeded"))
            return
        blk = next(self._source_iter, None)
        if blk is None:
            if not self.task.input_channels:
                self._finish_input()
            return
        self._source_pos += 1
        self._ingest(blk)
        self.send(self.self_id, _PumpSource())

    def _timed(self, fn, *args):
        """Charge a stage-program dispatch to the task's profile span
        (pass-through when no trace is active)."""
        if self._span is None:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        self._compute_s += time.perf_counter() - t0
        return out

    def _ingest(self, block: TableBlock):
        spec = self.task.stage_spec
        if spec.final_program is not None:
            # aggregate stage: per-block partial, accumulated via the
            # spiller (blocks beyond the quota go to blobs)
            self._acc_ids.append(self.spiller.put(block_to_payload(
                self._timed(self.compiled.run_block, block))))
        else:
            self._emit(self._timed(self.compiled.run_block, block))

    def _finish_input(self):
        spec = self.task.stage_spec
        if self.compiled.join is not None:
            dev = self.compiled.device
            probe = _assemble(self._join_acc[0],
                              self.compiled.in_schemas[0], dev)
            build = _assemble(self._join_acc[1],
                              self.compiled.in_schemas[1], dev)
            self._join_acc = {0: [], 1: []}
            self._emit(self._timed(self.compiled.run_join, probe, build))
            self._finish_output()
            return
        if spec.final_program is not None:
            if self._acc_ids:
                blocks = [
                    payload_to_block(self.spiller.get(sid),
                                     self.compiled.mid_schema,
                                     self.compiled.device)
                    for sid in self._acc_ids
                ]
                self._emit(self._timed(self.compiled.run_final, blocks))
            else:
                # empty input still finalizes (COUNT over nothing etc.)
                empty = _empty_block(self.compiled.mid_schema,
                                     self.compiled.device)
                self._emit(self._timed(self.compiled.run_final, [empty]))
            self._acc_ids = []
        self._finish_output()

    # ---- output side ----

    def _emit(self, block: TableBlock):
        if int(block.capacity) == 0:
            return
        out = self.task.stage_spec.output
        if isinstance(out, ResultOutput):
            self.send(self.result_target,
                      ResultData(block_to_payload(block), False))
            return
        # each consumer edge gets the full routed stream independently:
        # an edge that fans out to n tasks gets the block routed by row
        # hash (once per n), the others the whole payload (fetched once)
        payload = None
        routed: dict[int, list[dict]] = {}
        for chans in self._consumer_groups:
            n = len(chans)
            if isinstance(out, HashPartition) and n > 1:
                if n not in routed:
                    routed[n] = _split_block(
                        block, self.compiled.out_schema, out.keys, n)
                for ch, part in zip(chans, routed[n]):
                    if len(next(iter(part.values()))) == 0:
                        continue
                    self._send_channel(ch, part)
            else:  # Broadcast/UnionAll, or a single-task hash consumer
                if payload is None:
                    payload = block_to_payload(block)
                for ch in chans:
                    self._send_channel(ch, payload)

    def _send_channel(self, ch: int, payload: dict):
        if self._unacked[ch] >= self.window:
            self._parked[ch].append(self.spiller.put(payload))
            return
        self._dispatch(ch, payload, finished=False)

    def _dispatch(self, ch: int, payload: dict | None, finished: bool):
        seq = self._next_seq[ch]
        self._next_seq[ch] += 1
        if payload is not None:
            self._unacked[ch] += 1
        self.send(self.channel_targets[ch],
                  ChannelData(ch, seq, payload, finished))

    def _finish_output(self):
        self._done = True
        if self._span is not None:
            self._span.set(compute_seconds=round(self._compute_s, 6))
            self._span.finish()
            self._span = None
        if isinstance(self.task.stage_spec.output, ResultOutput):
            self.send(self.result_target, ResultData(None, True))
            return
        for ch in self.task.output_channels:
            if self._parked[ch] or self._unacked[ch] > 0:
                self._fin_pending.add(ch)
            else:
                self._dispatch(ch, None, finished=True)

    def _on_ack(self, ack: ChannelAck):
        ch = ack.channel_id
        self._unacked[ch] -= 1
        while self._parked[ch] and self._unacked[ch] < self.window:
            sid = self._parked[ch].popleft()
            self._dispatch(ch, self.spiller.get(sid), finished=False)
        if (
            ch in self._fin_pending
            and not self._parked[ch]
            and self._unacked[ch] == 0
        ):
            self._fin_pending.discard(ch)
            self._dispatch(ch, None, finished=True)


def _assemble(payloads: list[dict], schema: dtypes.Schema,
              device: torch.device) -> TableBlock:
    """Concat channel payloads into one block (capacity >= 1 so the join
    kernels' searchsorted shapes stay valid on empty sides)."""
    cols = {}
    validity = {}
    for f in schema.fields:
        parts = [p[f.name] for p in payloads]
        vparts = [p[f"__v_{f.name}"] for p in payloads]
        cols[f.name] = (np.concatenate(parts) if parts
                        else np.empty(0, dtype=f.type.physical))
        validity[f.name] = (np.concatenate(vparts) if vparts
                            else np.empty(0, dtype=bool))
    n = len(next(iter(cols.values()))) if cols else 0
    return TableBlock.from_numpy(cols, schema, validity,
                                 capacity=max(n, 1), device=device)


def _join_out_schema(j, probe_schema: dtypes.Schema,
                     build_schema: dtypes.Schema) -> dtypes.Schema:
    """Static output schema of a join stage."""
    left = j.kind == "left"  # NULL-extended build payload is nullable
    if not j.expand:
        if j.kind in ("semi", "anti"):
            return probe_schema
        fields = list(probe_schema.fields)
        for n in j.payload:
            f = build_schema.field(n)
            fields.append(dtypes.Field(n + j.suffix, f.type,
                                       f.nullable or left))
        return dtypes.Schema(tuple(fields))
    fields = [probe_schema.field(n) for n in j.probe_payload]
    for n in j.build_payload:
        f = build_schema.field(n)
        fields.append(dtypes.Field(n + j.suffix, f.type,
                                   f.nullable or left))
    return dtypes.Schema(tuple(fields))


@host_ok("zero-row result block: one bounded 0-byte alloc per column,"
         " only when a stage produced no rows")
def _empty_block(schema: dtypes.Schema, device: torch.device) -> TableBlock:
    cols = {
        f.name: np.empty(0, dtype=f.type.physical) for f in schema.fields
    }
    return TableBlock.from_numpy(cols, schema, capacity=1, device=device)


class ResultCollector(Actor):
    def __init__(self, schema: dtypes.Schema, device: torch.device):
        super().__init__()
        self.schema = schema
        self.device = device
        self.payloads: list[dict] = []
        self.done = False
        self.error: str | None = None

    def receive(self, message, sender):
        from ydb_tpu_torch.runtime.interconnect import Undelivered

        if isinstance(message, QueryAborted):
            if self.error is None:
                self.error = message.reason
            return
        if isinstance(message, Undelivered):
            # a liveness ping (or any collector-sent envelope) bounced:
            # the peer node is gone — fail the query
            if self.error is None:
                self.error = f"peer unreachable: {message.reason}"
            return
        assert isinstance(message, ResultData)
        if message.payload is not None:
            self.payloads.append(message.payload)
        if message.finished:
            self.done = True

    def result_block(self) -> TableBlock:
        if not self.payloads:
            return _empty_block(self.schema, self.device)
        blocks = [payload_to_block(p, self.schema, self.device)
                  for p in self.payloads]
        return blocks[0] if len(blocks) == 1 else concat_blocks(blocks)

    def table(self) -> OracleTable:
        return OracleTable.from_block(self.result_block())


def task_partitions(sources: dict[str, list], task: TaskSpec) -> list:
    """Source partitions assigned to one task: task p of an N-task stage
    reads partitions p, p+N, p+2N, … so every partition is read exactly
    once for any task-count / partition-count ratio. The ONE assignment
    rule — local build, remote task start, and the executer all share it
    (changing it anywhere else would silently double-read or drop data)."""
    out: list = []
    for inp in task.stage_spec.inputs:
        if isinstance(inp, SourceInput):
            parts = sources.get(inp.source_id, [])
            out.extend(parts[task.partition::task.stage_spec.tasks])
    return out


def compile_stages(
    stages: list[StageSpec],
    source_schemas: dict[str, dtypes.Schema],
    dicts=None,
    key_spaces=None,
    compile_cache: dict | None = None,
    device: "str | torch.device | None" = None,
) -> list[_CompiledStage]:
    """Compile every stage, flowing schemas source -> downstream. Needs
    only the SOURCE SCHEMAS, not the data — a remote node re-derives the
    whole compiled chain from the shipped stage specs (the task-start
    path, kqp_node_service.cpp:121). Aux tables are staged on
    ``device`` (CUDA unless the caller names another)."""
    from ydb_tpu_torch.engine.scan import required_columns

    dev = resolve_device(device)
    compiled: list[_CompiledStage] = []
    for si, spec in enumerate(stages):
        in_schemas = []
        for inp in spec.inputs:
            if isinstance(inp, SourceInput):
                sch = source_schemas[inp.source_id]
                if spec.program is not None:
                    # scan projection: compile (and later stream) only
                    # the program's required columns
                    sch = sch.select(required_columns(spec.program, sch))
                in_schemas.append(sch)
            else:
                in_schemas.append(compiled[inp.from_stage].out_schema)
        if not in_schemas:
            raise ValueError("stage with no inputs")
        if spec.join is not None:
            if len(in_schemas) != 2:
                raise ValueError(
                    f"join stage {si} needs exactly (probe, build) inputs")
        elif any(s != in_schemas[0] for s in in_schemas[1:]):
            # every channel payload decodes with one schema; unequal
            # upstream schemas would silently mislabel columns
            raise ValueError(
                f"stage {si}: all inputs must share one schema, got "
                f"{[s.names for s in in_schemas]}"
            )
        ck = None
        if compile_cache is not None:
            # dicts participate by identity (aux tables bake dictionary
            # contents); key_spaces by value — mixing either across one
            # cache dict must miss, not alias; the device too, where the
            # aux tables are staged
            ck = ("dq_stage", spec.program, spec.final_program, spec.join,
                  spec.dict_aliases, tuple(in_schemas), id(dicts),
                  tuple(sorted(key_spaces.items()))
                  if key_spaces else None, str(dev))
            hit = compile_cache.get(ck)
            if hit is not None:
                compiled.append(hit)
                continue
        stage = _CompiledStage(spec, in_schemas, dicts, key_spaces, dev)
        if ck is not None:
            compile_cache[ck] = stage
        compiled.append(stage)
    return compiled


@dataclasses.dataclass
class GraphHandle:
    """A built-but-not-finished dataflow: the executer's live view."""

    actors: list
    actor_of_task: dict
    collector: "ResultCollector"
    collector_id: ActorId
    systems: list
    tasks: list
    result_stage: int
    coordinator: object = None
    coordinator_id: ActorId | None = None

    def start(self):
        sys_by_node = {s.node: s for s in self.systems}
        for t in self.tasks:
            aid = self.actor_of_task[t.task_id]
            sys_by_node[aid.node].send(aid, StartTask())

    def close(self):
        """Release per-task resources once the graph is finished or
        abandoned. Spillers hold blobs that only ``get`` deletes, so a
        graph torn down with parked/accumulated ids (abort, deadline
        cancellation) must close them here or the blobs leak for the
        store's lifetime. Idempotent."""
        for a in self.actors:
            a.spiller.close()


def build_stage_graph(
    stages: list[StageSpec],
    sources: dict[str, list[ColumnSource]],
    runtime,
    dicts=None,
    key_spaces=None,
    spill_quota_bytes: int = 64 << 20,
    window: int = DEFAULT_WINDOW,
    checkpoint_storage=None,
    restore_checkpoint: int | None = None,
    block_rows: int = 1 << 16,
    compile_cache: dict | None = None,
    device: "str | torch.device | None" = None,
) -> GraphHandle:
    """Compile stages, place tasks round-robin over the runtime's nodes,
    wire channels (the executer-actor shape, kqp_executer_impl.h:120 +
    planner kqp_planner.cpp:116). With ``checkpoint_storage``, a
    CheckpointCoordinator is attached; with ``restore_checkpoint``,
    every task loads its saved state and sources resume mid-stream.
    ``compile_cache`` memoizes compiled stages across graphs (the
    computation-pattern-cache seam the single-chip executor has). Every
    task's blocks live on ``device`` (CUDA unless the caller names
    another)."""
    dev = resolve_device(device)
    # unreferenced sources may have zero partitions; referenced ones
    # must not (compile_stages then raises KeyError, as before)
    source_schemas = {sid: parts[0].schema
                      for sid, parts in sources.items() if parts}
    compiled = compile_stages(stages, source_schemas, dicts, key_spaces,
                              compile_cache, dev)

    tasks, channels, result_stage = build_tasks(stages)
    systems = list(runtime.nodes.values()) if hasattr(runtime, "nodes") \
        else [runtime]
    collector = ResultCollector(compiled[result_stage].out_schema, dev)
    collector_id = systems[0].register(collector)

    # place tasks, then wire channel targets
    actor_of_task: dict[int, ActorId] = {}
    actors: list[ComputeActor] = []
    chan_by_id = {c.channel_id: c for c in channels}
    for i, t in enumerate(tasks):
        srcs = task_partitions(sources, t)
        a = ComputeActor(
            t, compiled[t.stage], {}, chan_by_id, srcs,
            collector_id,
            spiller=Spiller(mem_quota_bytes=spill_quota_bytes,
                            prefix=f"spill/task{t.task_id}"),
            window=window,
            block_rows=block_rows,
            checkpoint_storage=checkpoint_storage,
            restore_checkpoint=restore_checkpoint,
        )
        sys_i = systems[i % len(systems)]
        actor_of_task[t.task_id] = sys_i.register(a)
        actors.append(a)
    for a in actors:
        for ch in a.task.output_channels:
            a.channel_targets[ch] = actor_of_task[chan_by_id[ch].dst_task]

    handle = GraphHandle(actors, actor_of_task, collector, collector_id,
                         systems, tasks, result_stage)
    if checkpoint_storage is not None:
        from ydb_tpu_torch.dq.checkpoint import CheckpointCoordinator

        source_task_ids = [
            actor_of_task[t.task_id] for t in tasks
            if any(isinstance(i, SourceInput) for i in t.stage_spec.inputs)
        ]
        coord = CheckpointCoordinator(
            checkpoint_storage, source_task_ids, n_tasks=len(tasks),
            start_id=restore_checkpoint or 0)
        coord_id = systems[0].register(coord)
        for a in actors:
            a.coordinator_target = coord_id
        handle.coordinator = coord
        handle.coordinator_id = coord_id
    return handle


def run_stage_graph(
    stages: list[StageSpec],
    sources: dict[str, list[ColumnSource]],
    runtime,
    dicts=None,
    key_spaces=None,
    spill_quota_bytes: int = 64 << 20,
    window: int = DEFAULT_WINDOW,
    checkpoint_storage=None,
    restore_checkpoint: int | None = None,
    block_rows: int = 1 << 16,
    compile_cache: dict | None = None,
    device: "str | torch.device | None" = None,
) -> OracleTable:
    """Build + run to completion, return the result table."""
    handle = build_stage_graph(
        stages, sources, runtime, dicts, key_spaces, spill_quota_bytes,
        window, checkpoint_storage, restore_checkpoint, block_rows,
        compile_cache, device)
    try:
        handle.start()
        if hasattr(runtime, "dispatch"):
            runtime.dispatch()
        else:
            runtime.run()
        err = handle.collector.error
        if err is not None and "deadline" in err:
            from ydb_tpu_torch.chaos.deadline import StatementCancelled

            raise StatementCancelled(err)
        if not handle.collector.done:
            raise RuntimeError("stage graph did not complete")
        return handle.collector.table()
    finally:
        handle.close()
