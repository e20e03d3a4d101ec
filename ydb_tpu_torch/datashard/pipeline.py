"""DataShard execution-unit pipeline: dependency-ordered wait/restart.

The reference drives every datashard operation through an ordered list
of ~60 execution units (execution_unit_kind.h:7; pipeline in
datashard_pipeline.cpp): each unit returns Executed / Wait / Restart,
and an operation whose dependencies are still in flight PARKS at its
current unit, restarting there when the blocker completes. This module
is that state machine at this build's scale — the essential
semantics (unit trace, key-conflict dependency build, wait, restart,
completion notification) over the existing propose/prepare/commit
primitives of ``DataShard``:

    CHECK            validate the operation (schema, lock liveness)
    BUILD_DEPS       key-overlap scan against in-flight operations
    WAIT_DEPS        park until every dependency completes (restart
                     here on each completion)
    BUILD_TX         stage writes durably (DataShard.propose)
    PREPARE          lock validation point (DataShard.prepare)
    WAIT_PLAN        park until the plan step arrives (auto_plan
                     pipelines self-assign the next step)
    EXECUTE          commit at the planned step (DataShard.commit_at)
    COMPLETE         release waiters, record the result

Single-shard operations only: multi-shard transactions keep riding the
coordinator's volatile 2PC (tx/coordinator.py), exactly as the
reference splits direct vs. distributed paths.

The port's own copy of ``ydb_tpu/datashard/pipeline.py`` over the port's
``DataShard``; it leaves nothing out.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable

from ydb_tpu_torch.datashard.shard import DataShard, RowOp, TxRejected


class Unit(enum.Enum):
    CHECK = "check"
    BUILD_DEPS = "build_deps"
    WAIT_DEPS = "wait_deps"
    BUILD_TX = "build_tx"
    PREPARE = "prepare"
    WAIT_PLAN = "wait_plan"
    EXECUTE = "execute"
    COMPLETE = "complete"


UNIT_ORDER = list(Unit)


class Status(enum.Enum):
    ACTIVE = "active"
    WAITING = "waiting"
    DONE = "done"
    ABORTED = "aborted"


@dataclasses.dataclass
class Operation:
    op_id: int
    ops: list
    lock_id: int | None
    unit: Unit = Unit.CHECK
    status: Status = Status.ACTIVE
    deps: set = dataclasses.field(default_factory=set)
    write_ids: list = dataclasses.field(default_factory=list)
    step: int | None = None
    error: str | None = None
    # every unit entry is recorded; a restarted WAIT_DEPS appears once
    # per wake-up — the observable trace of wait/restart semantics
    trace: list = dataclasses.field(default_factory=list)

    @property
    def keys(self) -> set:
        return {op.key for op in self.ops}


class ExecutionPipeline:
    """Per-shard operation runner (datashard_pipeline.cpp shape)."""

    def __init__(self, shard: DataShard, step_source=None,
                 auto_plan: bool = True):
        self.shard = shard
        # auto_plan=False models the coordinator-driven path: an op
        # parks at WAIT_PLAN until plan() delivers its step, so
        # conflicting ops genuinely overlap in flight
        self.auto_plan = auto_plan
        self._next_id = 1
        self._active: dict[int, Operation] = {}
        # bounded result history: completed ops shed their payloads
        # (rows/trace) and the oldest entries evict — a long-lived
        # pipeline must not grow with every write it ever served
        from collections import OrderedDict

        self._done: "OrderedDict[int, Operation]" = OrderedDict()
        self.done_history = 1024
        # blocker op_id -> ops parked on it
        self._waiters: dict[int, list[Operation]] = {}
        self._step = step_source or self._local_steps

    def _local_steps(self) -> int:
        return self.shard.last_step + 1

    # ---- public surface ----

    def submit(self, ops: Iterable[RowOp],
               lock_id: int | None = None) -> Operation:
        op = Operation(self._next_id, list(ops), lock_id)
        self._next_id += 1
        self._active[op.op_id] = op
        self._advance(op)
        return op

    def operation(self, op_id: int) -> Operation | None:
        return self._active.get(op_id) or self._done.get(op_id)

    @property
    def in_flight(self) -> int:
        return len(self._active)

    # ---- the unit machine ----

    def _advance(self, op: Operation) -> None:
        while op.status is Status.ACTIVE:
            op.trace.append(op.unit.value)
            handler = getattr(self, f"_unit_{op.unit.value}")
            try:
                outcome = handler(op)
            except TxRejected as e:
                self._abort(op, str(e))
                return
            if outcome == "wait":
                op.status = Status.WAITING
                return
            # executed: move to the next unit (COMPLETE finishes)
            if op.unit is Unit.COMPLETE:
                return
            op.unit = UNIT_ORDER[UNIT_ORDER.index(op.unit) + 1]

    def _unit_check(self, op: Operation) -> str:
        if not op.ops:
            raise TxRejected("empty operation")
        for row_op in op.ops:
            if row_op.row is not None:
                for col in row_op.row:
                    if col not in self.shard.schema:
                        raise TxRejected(f"unknown column {col}")
        if op.lock_id is not None and self.shard.lock_broken(op.lock_id):
            raise TxRejected(f"lock {op.lock_id} broken")
        return "executed"

    def _unit_build_deps(self, op: Operation) -> str:
        """Key-overlap scan: depend on every EARLIER in-flight
        operation touching a shared key (the reference's dependency
        graph build; conflicts with later ops are their problem)."""
        mine = op.keys
        for other in self._active.values():
            # everything in _active is in flight by construction
            if other.op_id < op.op_id and mine & other.keys:
                op.deps.add(other.op_id)
                self._waiters.setdefault(other.op_id, []).append(op)
        return "executed"

    def _unit_wait_deps(self, op: Operation) -> str:
        live = {d for d in op.deps if d in self._active}
        op.deps = live
        return "wait" if live else "executed"

    def _unit_build_tx(self, op: Operation) -> str:
        op.write_ids = [self.shard.propose(op.ops, lock_id=op.lock_id)]
        return "executed"

    def _unit_prepare(self, op: Operation) -> str:
        try:
            self.shard.prepare(op.write_ids)
        except TxRejected:
            self.shard.abort(op.write_ids)
            raise
        return "executed"

    def _unit_wait_plan(self, op: Operation) -> str:
        if op.step is not None:
            return "executed"
        if self.auto_plan:
            op.step = self._step()
            return "executed"
        return "wait"

    def plan(self, op_id: int, step: int | None = None) -> None:
        """Deliver the plan step to an op parked at WAIT_PLAN (the
        coordinator's TEvPlanStep arrival)."""
        op = self._active.get(op_id)
        if op is None or op.unit is not Unit.WAIT_PLAN:
            raise ValueError(f"op {op_id} is not awaiting a plan step")
        if step is not None and step <= self.shard.last_step:
            # a regressed step would write BENEATH already-committed
            # versions, inverting the order WAIT_DEPS just enforced
            raise ValueError(
                f"plan step {step} <= shard last step "
                f"{self.shard.last_step}")
        op.step = step if step is not None else self._step()
        op.status = Status.ACTIVE
        self._advance(op)

    def _unit_execute(self, op: Operation) -> str:
        # locks validate AT EXECUTION too: a break that lands between
        # prepare and the plan step must still abort (the reference
        # re-checks in the execute unit)
        if op.lock_id is not None and \
                self.shard.lock_broken(op.lock_id):
            self.shard.abort(op.write_ids)
            raise TxRejected(f"lock {op.lock_id} broken")
        self.shard.commit_at(op.write_ids, op.step)
        return "executed"

    def _unit_complete(self, op: Operation) -> str:
        op.status = Status.DONE
        self._retire(op)
        return "executed"

    # ---- completion / abort plumbing ----

    def _retire(self, op: Operation) -> None:
        self._active.pop(op.op_id, None)
        self._done[op.op_id] = op
        while len(self._done) > self.done_history:
            self._done.popitem(last=False)
        # wake waiters: each RESTARTS at its current unit (WAIT_DEPS),
        # re-evaluating its remaining dependencies
        for waiter in self._waiters.pop(op.op_id, []):
            if waiter.status is Status.WAITING:
                waiter.status = Status.ACTIVE
                self._advance(waiter)

    def _abort(self, op: Operation, reason: str) -> None:
        op.status = Status.ABORTED
        op.error = reason
        self._retire(op)
