"""Async table replication over CDC changefeeds.

The reference's async replication service tails a source table's
changefeed and applies the change stream to a target table, tracking
progress durably so a restarted worker resumes where it left off
(ydb/core/tx/replication/; SURVEY §2.14 async-replication row).

TPU-era shape: the changefeed already lands in a PersQueue topic
(datashard change exchange -> topic, exactly-once via producer seqnos).
The ``Replicator`` is a topic consumer per partition:

    read batch -> apply upsert/erase to the target row table
               -> commit the consumer offset

Apply is idempotent (upsert-by-key / delete-by-key), so the
at-least-once redelivery window between apply and offset commit is
harmless — the same guarantee the reference's replication worker gives.
The target stays a consistent-prefix replica: changes apply in source
commit order per key (per-shard queues are ordered; one key always maps
to one shard and one topic partition).

The port's own copy of ``ydb_tpu/replication.py``, over the port's
``RowTable`` and topics.
"""

from __future__ import annotations

import json


class Replicator:
    """Tails one changefeed topic into a target RowTable."""

    def __init__(self, topic, target, consumer: str = "replicator",
                 batch: int = 256):
        self.topic = topic
        self.target = target
        self.consumer = consumer
        self.batch = batch

    def poll(self) -> int:
        """One replication pass: apply every new change. Returns the
        number of changes applied."""
        applied = 0
        for pid, part in enumerate(self.topic.partitions):
            while True:
                offset = part.committed(self.consumer)
                msgs = part.read(offset, limit=self.batch)
                if not msgs:
                    break
                # apply in order: a delete after an upsert of the same
                # key must win, so apply in message order, batched by
                # consecutive runs of the same kind
                self._apply_in_order(msgs)
                applied += len(msgs)
                part.commit(self.consumer, offset + len(msgs))
        return applied

    def _apply_in_order(self, msgs) -> None:
        run_kind = None
        run: list = []

        def flush():
            nonlocal run
            if not run:
                return
            if run_kind == "del":
                self.target.delete_keys(run)
            else:
                self.target.upsert_rows(run)
            run = []

        for m in msgs:
            ch = json.loads(m["data"])
            kind = "del" if ch["new"] is None else "up"
            if kind != run_kind:
                flush()
                run_kind = kind
            if kind == "del":
                run.append(tuple(ch["key"]))
            else:
                run.append(dict(ch["new"]))
        flush()


def replicate_once(source_table, topic, target_table,
                   consumer: str = "replicator") -> int:
    """Drain the source's pending changes into the topic, then apply
    them to the target (one synchronous replication cycle)."""
    source_table.drain_changes_to(topic)
    return Replicator(topic, target_table, consumer).poll()
