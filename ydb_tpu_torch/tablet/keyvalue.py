"""KeyValue tablet: durable KV storage over the tablet executor.

Mirror of the reference's keyvalue tablet (ydb/core/keyvalue/
keyvalue_impl.h; SURVEY §2.3 BlobDepot/keyvalue row): a tablet exposing
write/read/range/rename/delete-range/copy-range over its local DB, with
large values spilled to the blob store and referenced from rows (the
reference likewise keeps big values in BlobStorage and metadata in the
tablet). All mutations are executor transactions — WAL'd, replayed on
boot, fenced by generations — so the tablet survives crashes and moves
(Hive can reboot it on another node).

Blob lifecycle: spilled value blobs are written BEFORE the owning tx
commits (an orphan on crash is garbage, never a dangling ref — the same
write-then-commit order portions use) and deleted only AFTER the tx that
dropped the last reference commits (side-effect phase).

The port's own copy of ``ydb_tpu/tablet/keyvalue.py``: the same table
(``kv``), keys, latin-1 inline encoding and blob ids (``<tablet>/kvblob/``
from ``generation << 32``), so a volume written by either package boots
in the other.
"""

from __future__ import annotations

import dataclasses
import itertools

from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.tablet.executor import TabletExecutor, Transaction, TxContext
from ydb_tpu_torch.tablet.hive import TabletActor

INLINE_LIMIT = 4096  # values beyond this spill to their own blob


@dataclasses.dataclass
class KvWrite:
    key: str
    value: bytes


@dataclasses.dataclass
class KvRead:
    key: str


@dataclasses.dataclass
class KvRange:
    lo: str | None = None
    hi: str | None = None
    limit: int = 1000


@dataclasses.dataclass
class KvRename:
    old: str
    new: str


@dataclasses.dataclass
class KvDeleteRange:
    lo: str | None = None
    hi: str | None = None


@dataclasses.dataclass
class KvCopyRange:
    lo: str | None
    hi: str | None
    prefix_to: str = ""


class _KvTx(Transaction):
    def __init__(self, fn):
        self._fn = fn
        self.side_effects: list = []  # blob ids to delete post-commit

    def execute(self, txc: TxContext, tablet) -> None:
        self._fn(txc, self)


class KeyValueTablet:
    """Core state machine (actor-free surface; KeyValueActor wraps it)."""

    def __init__(self, tablet_id: str, store: BlobStore,
                 executor: TabletExecutor | None = None):
        self.tablet_id = tablet_id
        self.store = store
        self.executor = (executor if executor is not None
                         else TabletExecutor.boot(tablet_id, store))
        self._blob_seq = itertools.count(
            self.executor.generation << 32)

    # -- helpers --

    def _row_value(self, row: dict) -> bytes:
        if row.get("blob") is not None:
            return self.store.get(row["blob"])
        return row["v"].encode("latin1")

    def _run(self, fn) -> list:
        tx = _KvTx(fn)
        self.executor.execute(tx)
        # post-commit side effects: now-unreferenced blobs
        for bid in tx.side_effects:
            self.store.delete(bid)
        return tx.side_effects

    # -- commands --

    def write(self, key: str, value: bytes) -> None:
        blob_id = None
        if len(value) > INLINE_LIMIT:
            blob_id = (f"{self.tablet_id}/kvblob/"
                       f"{next(self._blob_seq):016x}")
            self.store.put(blob_id, value)  # before commit: orphan-safe

        def fn(txc: TxContext, tx: _KvTx):
            old = txc.get("kv", (key,))
            if old is not None and old.get("blob"):
                tx.side_effects.append(old["blob"])
            if blob_id is not None:
                txc.put("kv", (key,), {"v": None, "blob": blob_id,
                                       "size": len(value)})
            else:
                txc.put("kv", (key,), {"v": value.decode("latin1"),
                                       "blob": None,
                                       "size": len(value)})

        self._run(fn)

    def read(self, key: str) -> bytes | None:
        row = self.executor.db.table("kv").get((key,))
        return None if row is None else self._row_value(row)

    def read_range(self, lo=None, hi=None, limit: int = 1000):
        out = []
        for (k,), row in self.executor.db.table("kv").range(
                (lo,) if lo is not None else None,
                (hi,) if hi is not None else None):
            out.append((k, self._row_value(row)))
            if len(out) >= limit:
                break
        return out

    def rename(self, old: str, new: str) -> bool:
        if old == new:
            # no-op rename must NOT release the row's own blob
            return self.executor.db.table("kv").get((old,)) is not None
        ok = [False]

        def fn(txc: TxContext, tx: _KvTx):
            row = txc.get("kv", (old,))
            if row is None:
                return
            dst = txc.get("kv", (new,))
            if dst is not None and dst.get("blob"):
                tx.side_effects.append(dst["blob"])
            txc.erase("kv", (old,))
            txc.put("kv", (new,), dict(row))
            ok[0] = True

        self._run(fn)
        return ok[0]

    def delete_range(self, lo=None, hi=None) -> int:
        n = [0]

        def fn(txc: TxContext, tx: _KvTx):
            for (k,), row in list(txc.range(
                    "kv",
                    (lo,) if lo is not None else None,
                    (hi,) if hi is not None else None)):
                if row.get("blob"):
                    tx.side_effects.append(row["blob"])
                txc.erase("kv", (k,))
                n[0] += 1

        self._run(fn)
        return n[0]

    def copy_range(self, lo=None, hi=None, prefix_to: str = "") -> int:
        """Copy [lo, hi) under a new key prefix (spilled blobs are
        duplicated — refs stay single-owner so deletes never dangle)."""
        n = [0]

        def fn(txc: TxContext, tx: _KvTx):
            for (k,), row in list(txc.range(
                    "kv",
                    (lo,) if lo is not None else None,
                    (hi,) if hi is not None else None)):
                dst_key = prefix_to + k
                dst = txc.get("kv", (dst_key,))
                if dst is not None and dst.get("blob"):
                    # overwrite releases the destination's spilled blob
                    # (self-copy included: the new row references a
                    # fresh duplicate, so the old blob is unreferenced)
                    tx.side_effects.append(dst["blob"])
                new_row = dict(row)
                if row.get("blob"):
                    new_blob = (f"{self.tablet_id}/kvblob/"
                                f"{next(self._blob_seq):016x}")
                    self.store.put(new_blob, self.store.get(row["blob"]))
                    new_row["blob"] = new_blob
                txc.put("kv", (dst_key,), new_row)
                n[0] += 1

        self._run(fn)
        return n[0]

    @staticmethod
    def boot(tablet_id: str, store: BlobStore) -> "KeyValueTablet":
        return KeyValueTablet(tablet_id, store)


class KeyValueActor(TabletActor):
    """Actor wrapper: KV commands over tablet pipes (keyvalue API)."""

    def __init__(self, tablet_id: str, executor: TabletExecutor):
        super().__init__(tablet_id, executor)
        self.kv = KeyValueTablet(tablet_id, executor.store,
                                 executor=executor)

    def handle(self, message, reply_to):
        if isinstance(message, KvWrite):
            self.kv.write(message.key, message.value)
            self.send(reply_to, ("ok", message.key))
        elif isinstance(message, KvRead):
            self.send(reply_to, ("value", self.kv.read(message.key)))
        elif isinstance(message, KvRange):
            self.send(reply_to, ("range", self.kv.read_range(
                message.lo, message.hi, message.limit)))
        elif isinstance(message, KvRename):
            self.send(reply_to, ("renamed", self.kv.rename(
                message.old, message.new)))
        elif isinstance(message, KvDeleteRange):
            self.send(reply_to, ("deleted", self.kv.delete_range(
                message.lo, message.hi)))
        elif isinstance(message, KvCopyRange):
            self.send(reply_to, ("copied", self.kv.copy_range(
                message.lo, message.hi, message.prefix_to)))
        else:
            self.send(reply_to, ("error", f"unknown command {message}"))
