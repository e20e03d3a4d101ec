"""PersQueue partition: a durable ordered message log.

Mirror of the reference's PQ tablet (TPersQueue persqueue/pq_impl.h:32,
per-partition actors partition.cpp; SURVEY.md §2.13): each partition is
an offset-ordered log with producer deduplication (producer id +
sequence numbers), per-consumer committed offsets, and retention. Built
on the tablet executor, so a partition reboots anywhere from the blob
store like every other tablet.

The port's own copy of ``ydb_tpu/topic/pq.py`` over the port's tablet
executor: the same tablet id (``pq/<partition>``), tables and rows, so a
partition written by either package boots in the other. Host-side by
design, as in the reference. ``Partition.write`` also takes one producer
seqno per message (``seqnos``; a port addition), so the change sender
ships a shard's changes for one partition in one transaction with the
dedup the reference applies to one write per change.
"""

from __future__ import annotations

import time

from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.tablet.executor import TabletExecutor, Transaction


class _WriteTx(Transaction):
    def __init__(self, partition: "Partition", messages: list[dict],
                 producer: str | None, first_seqno: int | None,
                 seqnos: list[int] | None = None):
        self.p = partition
        self.messages = messages
        self.producer = producer
        self.first_seqno = first_seqno
        self.seqnos = seqnos
        self.offsets: list[int] = []

    def execute(self, txc, tablet):
        db = self.p.executor.db
        head = db.table("meta").get(("head",)) or {"offset": 0}
        offset = head["offset"]
        max_seen = None
        if self.producer is not None:
            row = db.table("producers").get((self.producer,))
            max_seen = row["seqno"] if row else -1
        for i, msg in enumerate(self.messages):
            if self.seqnos is not None:
                seqno = self.seqnos[i]
            else:
                seqno = (self.first_seqno + i
                         if self.first_seqno is not None else None)
            if max_seen is not None and seqno is not None and \
                    seqno <= max_seen:
                self.offsets.append(-1)  # deduplicated retry
                continue
            txc.put("msgs", (offset,), {
                "data": msg["data"],
                "key": msg.get("key"),
                "ts": msg.get("ts", self.p.now()),
                "seqno": seqno,
                "producer": self.producer,
            })
            self.offsets.append(offset)
            offset += 1
            if seqno is not None:
                max_seen = seqno
        txc.put("meta", ("head",), {"offset": offset})
        if self.producer is not None and max_seen is not None and \
                max_seen >= 0:
            txc.put("producers", (self.producer,), {"seqno": max_seen})


class _CommitTx(Transaction):
    def __init__(self, consumer: str, offset: int,
                 allow_rewind: bool = False):
        self.consumer = consumer
        self.offset = offset
        self.allow_rewind = allow_rewind

    def execute(self, txc, tablet):
        cur = txc.get("consumers", (self.consumer,))
        if cur is not None and cur["offset"] >= self.offset \
                and not self.allow_rewind:
            return  # stale/out-of-order ack: keep the monotonic offset
        txc.put("consumers", (self.consumer,), {"offset": self.offset})


class _VacuumTx(Transaction):
    def __init__(self, up_to: int):
        self.up_to = up_to

    def execute(self, txc, tablet):
        tail = txc.get("meta", ("tail",)) or {"offset": 0}
        for off in range(tail["offset"], self.up_to):
            txc.erase("msgs", (off,))
        txc.put("meta", ("tail",), {"offset": self.up_to})


class Partition:
    def __init__(self, partition_id: str, store: BlobStore,
                 now=time.time):
        self.partition_id = partition_id
        self.executor = TabletExecutor.boot(f"pq/{partition_id}", store)
        self.now = now

    # ---- write path ----

    def write(self, messages: list[dict], producer: str | None = None,
              first_seqno: int | None = None,
              seqnos: list[int] | None = None) -> list[int]:
        """Append messages ({data: str|bytes-as-str, ts}); returns the
        assigned offsets (-1 for producer-seqno duplicates). A producer's
        seqnos are ``first_seqno``, ``first_seqno + 1``, ... or, given,
        ``seqnos`` (one a message, increasing)."""
        if seqnos is not None and len(seqnos) != len(messages):
            raise ValueError("one seqno per message")
        tx = _WriteTx(self, messages, producer, first_seqno, seqnos)
        self.executor.execute(tx)
        return tx.offsets

    # ---- read path ----

    @property
    def head_offset(self) -> int:
        row = self.executor.db.table("meta").get(("head",))
        return row["offset"] if row else 0

    @property
    def tail_offset(self) -> int:
        row = self.executor.db.table("meta").get(("tail",))
        return row["offset"] if row else 0

    def read(self, offset: int, limit: int = 100) -> list[dict]:
        """Messages from offset (inclusive), each dict +'offset'."""
        out = []
        start = max(offset, self.tail_offset)
        for key, row in self.executor.db.table("msgs").range(
                lo=(start,), hi=(start + limit,)):
            out.append(dict(row, offset=key[0]))
        return out

    # ---- consumers ----

    def commit(self, consumer: str, offset: int,
               allow_rewind: bool = False) -> None:
        """Set the consumer's committed (next-to-read) offset. Stale
        acks are ignored unless ``allow_rewind`` (an explicit seek-back,
        e.g. a Kafka consumer reprocessing)."""
        self.executor.execute(_CommitTx(consumer, offset, allow_rewind))

    def committed(self, consumer: str) -> int:
        row = self.executor.db.table("consumers").get((consumer,))
        return row["offset"] if row else 0

    # ---- retention ----

    def vacuum(self, older_than_ts: float | None = None,
               keep_offsets: int | None = None) -> int:
        """Retention: drop the log tail. With no arguments, drops below
        the slowest consumer's commit point; an age or count policy
        expires messages regardless of consumers (the reference's
        retention semantics — unread data still ages out)."""
        cuts = []
        if older_than_ts is None and keep_offsets is None:
            rows = list(self.executor.db.table("consumers").range())
            cuts.append(min((r["offset"] for _k, r in rows),
                            default=self.tail_offset))
        if keep_offsets is not None:
            cuts.append(max(0, self.head_offset - keep_offsets))
        if older_than_ts is not None:
            cut = self.tail_offset
            for key, row in self.executor.db.table("msgs").range():
                if row["ts"] < older_than_ts:
                    cut = key[0] + 1
                else:
                    break
            cuts.append(cut)
        up_to = min(max(cuts), self.head_offset)
        removed = max(0, up_to - self.tail_offset)
        if removed:
            self.executor.execute(_VacuumTx(up_to))
        return removed
