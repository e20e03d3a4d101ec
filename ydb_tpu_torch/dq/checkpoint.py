"""Distributed checkpoints for streaming dataflows.

The port's own copy of ``ydb_tpu/dq/checkpoint.py``. Mirror of the reference's checkpoint machinery (SURVEY.md §5.4):
``IDqTaskRunner::Save/Load`` serialize a running task's operator state
(dq_tasks_runner.h:406-408); a checkpoint coordinator injects barriers
at the sources (fq/libs/checkpointing/checkpoint_coordinator.h:25,
InjectCheckpoint :106); compute actors align barriers across their
input channels, persist state to checkpoint storage
(fq/libs/checkpoint_storage), forward the barrier downstream, and ack.

The protocol here is the aligned-barrier snapshot: barriers ride the
data channels IN BAND (they park behind data in the credit queue, so
they can never overtake a block), a task snapshots only once barriers
arrived on every input channel — buffering post-barrier blocks from
already-aligned channels — and a checkpoint completes when every task
acked. Recovery rebuilds the graph with each task's saved state and
sources resuming from their saved positions.

State serialization is pickle over numpy payloads — the internal
storage format of OUR checkpoint store (the reference uses its own
protobuf mini-format for the same purpose).
"""

from __future__ import annotations

import dataclasses
import pickle

from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.runtime.actors import Actor, ActorId


# ---- protocol messages ----

@dataclasses.dataclass
class InjectCheckpoint:
    checkpoint_id: int


@dataclasses.dataclass
class TaskCheckpointed:
    task_id: int
    checkpoint_id: int


@dataclasses.dataclass
class TriggerCheckpoint:
    pass


BARRIER_KEY = "__ckpt__"


class CheckpointStorage:
    """Task-state persistence + completion markers on a blob store."""

    def __init__(self, store: BlobStore, graph_id: str = "g"):
        self.store = store
        self.graph_id = graph_id

    def _prefix(self, checkpoint_id: int) -> str:
        return f"ckpt/{self.graph_id}/{checkpoint_id:08d}/"

    def save_task(self, checkpoint_id: int, task_id: int,
                  state: dict) -> None:
        self.store.put(self._prefix(checkpoint_id) + f"task{task_id}",
                       pickle.dumps(state))

    def load_task(self, checkpoint_id: int, task_id: int) -> dict | None:
        blob = self._prefix(checkpoint_id) + f"task{task_id}"
        if not self.store.exists(blob):
            return None
        return pickle.loads(self.store.get(blob))

    def mark_complete(self, checkpoint_id: int) -> None:
        self.store.put(self._prefix(checkpoint_id) + "COMPLETE", b"1")

    def latest_complete(self) -> int | None:
        best = None
        for blob in self.store.list(f"ckpt/{self.graph_id}/"):
            if blob.endswith("/COMPLETE"):
                cid = int(blob.split("/")[-2])
                best = cid if best is None else max(best, cid)
        return best

    def drop_incomplete(self) -> None:
        """GC checkpoints that never completed (crash mid-snapshot)."""
        complete = set()
        for blob in self.store.list(f"ckpt/{self.graph_id}/"):
            if blob.endswith("/COMPLETE"):
                complete.add(blob.rsplit("/", 1)[0])
        for blob in list(self.store.list(f"ckpt/{self.graph_id}/")):
            if blob.rsplit("/", 1)[0] not in complete:
                self.store.delete(blob)


class CheckpointCoordinator(Actor):
    """Injects barriers at source tasks, collects acks, marks complete
    (checkpoint_coordinator.h shape)."""

    def __init__(self, storage: CheckpointStorage,
                 source_tasks: list[ActorId], n_tasks: int,
                 start_id: int = 0):
        super().__init__()
        self.storage = storage
        self.source_tasks = list(source_tasks)
        self.n_tasks = n_tasks
        self.next_id = start_id + 1
        self.pending: dict[int, set] = {}   # ckpt id -> acked task ids
        self.completed: list[int] = []

    def receive(self, message, sender):
        if isinstance(message, TriggerCheckpoint):
            cid = self.next_id
            self.next_id += 1
            self.pending[cid] = set()
            for aid in self.source_tasks:
                self.send(aid, InjectCheckpoint(cid))
        elif isinstance(message, TaskCheckpointed):
            acked = self.pending.get(message.checkpoint_id)
            if acked is None:
                return
            acked.add(message.task_id)
            if len(acked) >= self.n_tasks:
                del self.pending[message.checkpoint_id]
                self.storage.mark_complete(message.checkpoint_id)
                self.completed.append(message.checkpoint_id)
