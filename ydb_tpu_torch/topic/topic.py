"""Topic: partitioned message stream + read sessions.

Mirror of the reference's topic surface (gRPC topic write/read session
actors, services/persqueue_v1; read balancer read_balancer.cpp;
SURVEY.md §2.13): writes route by message key hash (ordering per key)
or round-robin; a ReadSession drains all partitions for one consumer
with explicit commit.

The port's own copy of ``ydb_tpu/topic/topic.py``: the same key hash
(``common.fnv1a_64``) and partition ids.
"""

from __future__ import annotations

import itertools

from ydb_tpu_torch.common import fnv1a_64 as _key_hash
from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.topic.pq import Partition


class Topic:
    def __init__(self, name: str, store: BlobStore, n_partitions: int = 2,
                 now=None):
        self.name = name
        kwargs = {"now": now} if now is not None else {}
        self.partitions = [
            Partition(f"{name}/{i}", store, **kwargs)
            for i in range(n_partitions)
        ]
        self._rr = itertools.count()

    def storage_prefixes(self) -> list[str]:
        return [f"tablet/pq/{p.partition_id}/" for p in self.partitions]

    def partition_for(self, key: str | None) -> int:
        if key is None:
            return next(self._rr) % len(self.partitions)
        return _key_hash(key) % len(self.partitions)

    def write(self, data: str, key: str | None = None,
              producer: str | None = None,
              seqno: int | None = None) -> tuple[int, int]:
        """Returns (partition, offset)."""
        p = self.partition_for(key)
        offs = self.partitions[p].write(
            [{"data": data}], producer=producer, first_seqno=seqno)
        return p, offs[0]

    def reader(self, consumer: str) -> "ReadSession":
        return ReadSession(self, consumer)


class ReadSession:
    """One consumer over all partitions (explicit commit)."""

    def __init__(self, topic: Topic, consumer: str):
        self.topic = topic
        self.consumer = consumer

    def read_batch(self, limit_per_partition: int = 100) -> list[dict]:
        """Uncommitted messages across partitions, each dict carrying
        (partition, offset, data)."""
        out = []
        for pi, part in enumerate(self.topic.partitions):
            start = part.committed(self.consumer)
            for msg in part.read(start, limit_per_partition):
                out.append(dict(msg, partition=pi))
        return out

    def commit(self, partition: int, offset: int) -> None:
        """Commit offsets UP TO AND INCLUDING offset."""
        self.topic.partitions[partition].commit(
            self.consumer, offset + 1)

    def commit_batch(self, batch: list[dict]) -> None:
        tops: dict[int, int] = {}
        for msg in batch:
            tops[msg["partition"]] = max(
                tops.get(msg["partition"], -1), msg["offset"])
        for p, off in tops.items():
            self.commit(p, off)
