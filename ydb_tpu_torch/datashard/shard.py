"""DataShard: the row-store OLTP tablet.

Mirror of the reference's DataShard (tx/datashard, SURVEY.md §2.6) on the
tablet executor: rows live in the MVCC local DB versioned by *global plan
steps* (not the tablet's own commit counter), so cross-shard reads at a
coordinator snapshot are consistent — exactly the reference's
planned-step execution (datashard_pipeline.h) without the 60-unit state
machine: the executor's single-writer discipline plus the coordinator's
step order give the same serialization.

Write path (the 2PC participant contract shared with ColumnShard, so one
Coordinator drives either):
  * ``propose(ops)``    -> write_id: durably stage the tx's effects
                           (upsert/erase rows) — the pipeline's
                           check/store units
  * ``prepare([ids])``  -> validates locks, returns the ids (2PC vote)
  * ``commit_at(ids, step)`` applies effects at version=step
  * ``abort(ids)``      drops staged effects

Read path: ``read(...)`` — MVCC range/point reads at a snapshot step with
paging (TEvRead / read-iterator analog, datashard__read_iterator.cpp).

Optimistic locks (datashard locks analog): ``acquire_lock`` records the
read ranges; any committed write intersecting them breaks the lock;
``prepare`` fails for a tx that declares a broken lock, aborting the 2PC.
Locks are in-memory only — a shard restart breaks them all, as in the
reference.

The port's own copy of ``ydb_tpu/datashard/shard.py``, over the port's
``tablet/executor.py``: the same tablet ids (``ds/<shard>``), local-DB
tables (``data``, ``pending``, ``meta``, ``changes``) and JSON redo
records, so a shard written by either package boots in the other. It
leaves nothing out; ``RowTable.drain_changes_to`` ships its change
records (``cdc_enabled``) to the table's changefeed topic.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterator

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.tablet.executor import TabletExecutor, Transaction


class VolatileUndecided(Exception):
    """A read hit the key range of a volatile tx whose cross-shard
    decision is still outstanding; the reader must wait for the
    readset exchange to settle (the reference blocks the read iterator
    on TVolatileTxManager, datashard__read_iterator.cpp)."""


class TxRejected(Exception):
    pass


class LockBroken(TxRejected):
    pass


@dataclasses.dataclass
class RowOp:
    """One effect: row upsert (row != None) or erase (row == None)."""

    key: tuple
    row: dict | None


@dataclasses.dataclass
class _Lock:
    lock_id: int
    ranges: list[tuple[tuple | None, tuple | None]]
    points: set[tuple]
    broken: bool = False

    def covers(self, key: tuple) -> bool:
        if key in self.points:
            return True
        for lo, hi in self.ranges:
            if (lo is None or key >= lo) and (hi is None or key < hi):
                return True
        return False


class _ProposeTx(Transaction):
    def __init__(self, write_id: int, ops: list[RowOp], lock_id, expect):
        self.write_id = write_id
        self.ops = ops
        self.lock_id = lock_id
        self.expect = expect

    def execute(self, txc, tablet):
        txc.put("pending", (self.write_id,), {
            "ops": [[list(o.key), o.row] for o in self.ops],
            "lock_id": self.lock_id,
            "expect": self.expect,
        })
        # same commit as the staged tx: a crash can never reuse a write
        # id that a durable pending entry already owns
        txc.put("meta", ("next_write",), {"v": self.write_id + 1})


class _CommitTx(Transaction):
    def __init__(self, shard: "DataShard", write_ids: list[int], step: int):
        self.shard = shard
        self.write_ids = write_ids
        self.step = step

    def execute(self, txc, tablet):
        cdc = self.shard.cdc_enabled
        seq_row = txc.get("meta", ("next_change",)) if cdc else None
        change_seq = seq_row["v"] if seq_row else 0
        staged: dict[tuple, dict | None] = {}  # writes within THIS commit
        for wid in self.write_ids:
            pend = txc.get("pending", (wid,))
            if pend is None:
                raise TxRejected(f"no staged tx {wid}")
            for key_list, row in pend["ops"]:
                key = tuple(key_list)
                if cdc:
                    # change collector (change_collector.h analog): the
                    # record commits IN the data transaction, so the
                    # stream never misses or invents a change; a second
                    # write to the same key in this commit must see the
                    # first as its old image, not the committed state
                    old = (staged[key] if key in staged
                           else txc.get("data", key))
                    txc.put("changes", (change_seq,), {
                        "key": list(key), "old": old, "new": row,
                        "step": self.step,
                    })
                    change_seq += 1
                    staged[key] = row
                txc.put_at("data", key, row, self.step)
                self.shard._break_locks(key)
            txc.erase("pending", (wid,))
        if cdc:
            txc.put("meta", ("next_change",), {"v": change_seq})
        txc.put("meta", ("last_step",), {"v": self.step})


class _AbortTx(Transaction):
    def __init__(self, write_ids: list[int]):
        self.write_ids = write_ids

    def execute(self, txc, tablet):
        for wid in self.write_ids:
            txc.erase("pending", (wid,))


@dataclasses.dataclass
class _VolatileTx:
    """An optimistically-applied distributed tx awaiting peer readsets
    (TVolatileTxManager analog, volatile_tx.h:91). Effects live only
    in this in-memory record until the decision — a shard restart
    forgets undecided volatile txs, which is exactly the reference's
    contract (volatile = not yet persistent)."""

    txid: int
    step: int
    write_ids: list
    keys: set
    expected: set   # peer participant ids whose readsets are awaited
    received: dict  # peer id -> bool


class DataShard:
    def __init__(self, shard_id: str, schema: dtypes.Schema,
                 store: BlobStore, pk_columns: tuple[str, ...]):
        self.shard_id = shard_id
        self.schema = schema
        self.pk_columns = tuple(pk_columns)
        self.executor = TabletExecutor.boot(f"ds/{shard_id}", store)
        row = self.executor.db.table("meta").get(("next_write",))
        self._write_ids = itertools.count(row["v"] if row else 1)
        self._locks: dict[int, _Lock] = {}
        self._next_lock = itertools.count(1)
        self.cdc_enabled = False
        self._volatile: dict[int, _VolatileTx] = {}

    # ---- MVCC state ----

    @property
    def last_step(self) -> int:
        row = self.executor.db.table("meta").get(("last_step",))
        return row["v"] if row else 0

    # interface parity with ColumnShard (cluster boot resumes the
    # coordinator clock from max shard snapshot)
    @property
    def snap(self) -> int:
        return self.last_step

    # ---- write path (2PC participant) ----

    def propose(self, ops: list[RowOp], lock_id: int | None = None,
                expect: dict | None = None) -> int:
        """Durably stage effects; returns the write id (2PC token).

        ``expect``: optional per-key preconditions, {key: row_or_None}
        checked under the executor at prepare time — the
        read-your-locks validation for interactive INSERT (fail if
        exists) semantics.
        """
        wid = next(self._write_ids)
        exp = (
            [[list(k), v] for k, v in expect.items()]
            if expect is not None else None
        )
        self.executor.execute(_ProposeTx(wid, ops, lock_id, exp))
        return wid

    def prepare(self, write_ids: list[int]) -> list[int]:
        for wid in write_ids:
            pend = self.executor.db.table("pending").get((wid,))
            if pend is None:
                raise TxRejected(f"unknown write id {wid}")
            lock_id = pend.get("lock_id")
            if lock_id is not None:
                lock = self._locks.get(lock_id)
                if lock is None or lock.broken:
                    raise LockBroken(f"lock {lock_id} is broken")
            # an undecided volatile write to any of this tx's keys is
            # ordered BEFORE it but not yet in the data table: both
            # expect-preconditions and blind writes must wait for (or
            # conservatively reject on) the outstanding decision, like
            # the read-path fence — otherwise fail-if-exists could pass
            # against a key a decided-later volatile insert owns
            for key_list, _row in pend["ops"]:
                key = tuple(key_list)
                for vt in list(self._volatile.values()):
                    if key in vt.keys:
                        raise TxRejected(
                            f"key {key} has an undecided volatile "
                            f"write (tx {vt.txid})")
            for key_list, want in pend.get("expect") or []:
                key = tuple(key_list)
                have = self.executor.db.table("data").get(key)
                if (have is None) != (want is None):
                    raise TxRejected(
                        f"precondition failed for key {key}")
        return list(write_ids)

    def commit_at(self, write_ids: list[int], step: int) -> int:
        self.executor.execute(_CommitTx(self, write_ids, step))
        return step

    def abort(self, write_ids: list[int]) -> None:
        self.executor.execute(_AbortTx(write_ids))

    # ---- volatile distributed commit (volatile_tx.h:91 analog) ----

    def apply_volatile(self, write_ids: list[int], txid: int,
                       step: int, expected_peers) -> bool:
        """Validate + optimistically accept a planned volatile tx
        WITHOUT waiting for peers' outcomes (no prepare round-trip):
        on success the tx is recorded undecided and its keys are
        fenced from snapshot readers until the readset exchange
        settles. Local failure aborts the staged writes immediately
        and returns False (the readset this shard sends its peers)."""
        try:
            self.prepare(write_ids)
        except TxRejected:
            self.abort(write_ids)
            return False
        keys = set()
        for wid in write_ids:
            pend = self.executor.db.table("pending").get((wid,))
            for key_list, _row in pend["ops"]:
                keys.add(tuple(key_list))
        self._volatile[txid] = _VolatileTx(
            txid, step, list(write_ids), keys,
            set(expected_peers), {})
        # conflicting optimistic readers must learn NOW, not at the
        # decision: the write is already ordered at `step`
        for key in keys:
            self._break_locks(key)
        return True

    def deliver_readset(self, txid: int, from_peer,
                        ok: bool) -> bool | None:
        """Record a peer's outcome (TEvReadSet analog). Returns the
        decision once it settles: True committed, False rolled back,
        None still undecided / unknown tx."""
        vt = self._volatile.get(txid)
        if vt is None:
            return None
        if not ok:
            self.executor.execute(_AbortTx(vt.write_ids))
            del self._volatile[txid]
            return False
        vt.received[from_peer] = True
        if set(vt.received) >= vt.expected:
            # decision: effects become durable at the planned step
            self.executor.execute(
                _CommitTx(self, vt.write_ids, vt.step))
            del self._volatile[txid]
            return True
        return None

    def abort_volatile(self, txid: int) -> None:
        """Locally roll back an undecided volatile tx (restart/timeout
        path: volatile effects are never durable before the decision)."""
        vt = self._volatile.pop(txid, None)
        if vt is not None:
            self.executor.execute(_AbortTx(vt.write_ids))

    def _volatile_fence(self, snapshot: int, lo, hi, keys) -> None:
        """Raise VolatileUndecided when the request intersects an
        undecided volatile tx ordered at or before the snapshot."""
        for vt in list(self._volatile.values()):
            if vt.step > snapshot:
                continue
            if keys is not None:
                if vt.keys.intersection(tuple(k) for k in keys):
                    raise VolatileUndecided(
                        f"tx {vt.txid} at step {vt.step} undecided")
            else:
                for k in vt.keys:
                    if (lo is None or k >= lo) and \
                            (hi is None or k < hi):
                        raise VolatileUndecided(
                            f"tx {vt.txid} at step {vt.step} undecided")

    # ---- read path (read iterator) ----

    def read(
        self,
        snapshot: int,
        lo: tuple | None = None,
        hi: tuple | None = None,
        keys: list[tuple] | None = None,
        columns: tuple[str, ...] | None = None,
        page_rows: int = 1024,
        lock_id: int | None = None,
    ) -> Iterator[list[tuple[tuple, dict]]]:
        """Stream pages of (key, row) visible at the snapshot step.

        With ``lock_id``, the scanned range/points are recorded on the
        lock so later conflicting commits break it (optimistic tx).
        Registration happens HERE, eagerly — not when the returned
        iterator is first consumed — so a conflict in the gap between
        opening and draining the read still breaks the lock.
        """
        if lock_id is not None:
            lock = self._locks.setdefault(
                lock_id, _Lock(lock_id, [], set()))
            if keys is not None:
                lock.points.update(tuple(k) for k in keys)
            else:
                lock.ranges.append((lo, hi))
        self._volatile_fence(snapshot, lo, hi, keys)
        return self._read_pages(snapshot, lo, hi, keys, columns,
                                page_rows)

    def _read_pages(self, snapshot, lo, hi, keys, columns, page_rows):
        table = self.executor.db.table("data")
        page: list[tuple[tuple, dict]] = []
        if keys is not None:
            for key in keys:
                row = table.get(tuple(key), version=snapshot)
                if row is not None:
                    page.append((tuple(key), _project(row, columns)))
                if len(page) >= page_rows:
                    yield page
                    page = []
        else:
            for key, row in table.range(lo, hi, version=snapshot):
                page.append((key, _project(row, columns)))
                if len(page) >= page_rows:
                    yield page
                    page = []
        if page:
            yield page

    # ---- locks ----

    def acquire_lock(self) -> int:
        lock_id = next(self._next_lock)
        self._locks[lock_id] = _Lock(lock_id, [], set())
        return lock_id

    def lock_broken(self, lock_id: int) -> bool:
        lock = self._locks.get(lock_id)
        return lock is None or lock.broken

    def release_lock(self, lock_id: int) -> None:
        self._locks.pop(lock_id, None)

    def _break_locks(self, key: tuple) -> None:
        # a snapshot: sessions on other threads acquire and release locks
        # while a write breaks them
        for lock in list(self._locks.values()):
            if not lock.broken and lock.covers(key):
                lock.broken = True

    # ---- CDC change queue (change sender source) ----

    def pending_changes(self, limit: int = 1000) -> list[dict]:
        """Durable change records not yet shipped (seq-ordered)."""
        out = []
        for key, row in self.executor.db.table("changes").range():
            out.append(dict(row, seq=key[0]))
            if len(out) >= limit:
                break
        return out

    def ack_changes(self, up_to_seq: int) -> None:
        """Forget shipped change records (<= up_to_seq)."""
        shard = self

        class Tx(Transaction):
            def execute(self, txc, tablet):
                for key, _row in shard.executor.db.table(
                        "changes").range(hi=(up_to_seq + 1,)):
                    txc.erase("changes", key)

        self.executor.execute(Tx())

    # ---- maintenance ----

    def compact(self, keep_after: int) -> None:
        """Collapse row version chains invisible below keep_after."""
        self.executor.db.table("data").compact(keep_after)

    def checkpoint(self) -> None:
        self.executor.checkpoint()


def _project(row: dict, columns: tuple[str, ...] | None) -> dict:
    if columns is None:
        return row
    return {c: row.get(c) for c in columns}
