"""Streaming MVCC read sessions with credit flow + continuation.

Mirror of the reference's read-iterator protocol (TEvRead /
TEvReadResult / TEvReadAck, ydb/core/tx/datashard/
datashard__read_iterator.cpp; client side kqp_read_actor.cpp:46;
SURVEY.md §2.6 row "Read iterator"): the OLTP streaming read path.

Contract mirrored:
  * a session pins one snapshot; rows stream in quota-bounded pages
    and later commits never appear mid-stream (repeatable read);
  * credit flow: the server sends at most the granted row quota and
    then stalls until the client acks more (TEvReadAck) — the
    slow-consumer backpressure that keeps server memory bounded;
  * every page carries a continuation token (the last delivered PK);
    a session can be re-opened from a token against the SAME shard or
    a REBOOTED incarnation of it and resumes exactly after the last
    delivered row — the retry contract the reference's client actor
    leans on for shard restarts/splits.

The port's own copy of ``ydb_tpu/datashard/read_iterator.py`` over the
port's ``DataShard``; it leaves nothing out.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReadPage:
    rows: list          # [(key, row)]
    continuation: tuple | None   # last delivered PK (resume token)
    finished: bool


class ReadIterator:
    """One streaming read session over a DataShard."""

    def __init__(self, shard, snapshot: int,
                 lo: tuple | None = None, hi: tuple | None = None,
                 columns: tuple | None = None,
                 quota_rows: int = 1024,
                 continuation: tuple | None = None):
        self.shard = shard
        self.snapshot = snapshot
        self.lo = lo
        self.hi = hi
        self.columns = columns
        self.credit = quota_rows
        self.continuation = continuation
        self.finished = False

    def ack(self, quota_rows: int) -> None:
        """Grant more row quota (TEvReadAck)."""
        self.credit += quota_rows

    def next_page(self, page_rows: int = 256) -> ReadPage | None:
        """Next quota-bounded page, or None when stalled on credit.
        Raises VolatileUndecided if the range hits an undecided
        volatile tx (the reference blocks the iterator there)."""
        if self.finished:
            return ReadPage([], self.continuation, True)
        if self.credit <= 0:
            return None  # out of quota: wait for ack()
        take = min(page_rows, self.credit)
        start = self.continuation if self.continuation is not None \
            else self.lo
        rows: list = []
        for page in self.shard.read(self.snapshot, lo=start,
                                    hi=self.hi, columns=self.columns,
                                    page_rows=take + 1):
            for key, row in page:
                # lo is inclusive; a continuation resumes AFTER it
                if self.continuation is not None \
                        and key <= self.continuation:
                    continue
                rows.append((key, row))
                if len(rows) > take:
                    break
            if len(rows) > take:
                break
        more = len(rows) > take
        rows = rows[:take]
        self.credit -= len(rows)
        if rows:
            self.continuation = rows[-1][0]
        if not more:
            self.finished = True
        return ReadPage(rows, self.continuation, self.finished)

    def resume_token(self) -> dict:
        """Serializable session state for reopening elsewhere/later."""
        return {
            "snapshot": self.snapshot,
            "lo": self.lo, "hi": self.hi,
            "columns": self.columns,
            "continuation": self.continuation,
        }

    @classmethod
    def from_token(cls, shard, token: dict,
                   quota_rows: int = 1024) -> "ReadIterator":
        return cls(shard, token["snapshot"], lo=token["lo"],
                   hi=token["hi"], columns=token["columns"],
                   quota_rows=quota_rows,
                   continuation=token["continuation"])
