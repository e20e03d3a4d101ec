"""Tablet executor: the universal persistence primitive.

Mirror of the reference's tablet_flat executor (ITransaction
Execute/Complete tablet_flat_executor.h:281,297; TExecutor
flat_executor.h:320; boot stages flat_boot_*.h; SURVEY.md §3.5): a
per-tablet single-writer transaction machine whose only durable state is
a snapshot plus a redo log in the blob store. ``execute`` runs the
transaction against the local DB, persists the change set as a redo
record, applies it, then runs ``complete`` for side effects. ``boot``
replays snapshot + redo — any node can resurrect the tablet from the
store alone, which is what lets Hive restart dead tablets elsewhere
(mind/hive; SURVEY.md §5.3).

Generations fence zombie writers: each boot bumps the generation, and
log records carry it. Replay follows the highest-generation chain, so a
stale leader's appends after a takeover are ignored by the next boot
(the blob-store analog of BlobStorage's barrier/block mechanism).

The port's own copy of ``ydb_tpu/tablet/executor.py``: the same blob
keys and encodings, so a tablet written by either package boots in the
other.
"""

from __future__ import annotations

import json
import threading

from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.tablet.localdb import LocalDb


class TxContext:
    """Change-staging handle passed to Transaction.execute."""

    def __init__(self, db: LocalDb, version: int):
        self.db = db
        self.version = version  # version this commit will get
        self.changes: list[tuple] = []

    # reads see committed state only (single-writer: no dirty reads needed)
    def get(self, table: str, key: tuple):
        return self.db.table(table).get(tuple(key))

    def range(self, table: str, lo=None, hi=None):
        return self.db.table(table).range(lo, hi)

    def put(self, table: str, key: tuple, row: dict) -> None:
        self.changes.append((table, tuple(key), dict(row)))

    def put_at(self, table: str, key: tuple, row: dict | None,
               version: int) -> None:
        """Write with an explicit MVCC version (global plan step) instead
        of this commit's version — the DataShard visibility clock."""
        self.changes.append((table, tuple(key),
                             dict(row) if row is not None else None,
                             version))

    def erase(self, table: str, key: tuple) -> None:
        self.changes.append((table, tuple(key), None))


class Transaction:
    def execute(self, txc: TxContext, tablet) -> None:
        raise NotImplementedError

    def complete(self, tablet) -> None:
        pass


class _ApplyTx(Transaction):
    """Single-closure transaction (the lambda-ITransaction idiom used
    by the small coordination tablets: kesus, console, nodebroker)."""

    def __init__(self, fn):
        self.fn = fn
        self.result = None

    def execute(self, txc, tablet):
        self.result = self.fn(txc)


class FencedError(Exception):
    """A higher generation has taken over this tablet; the caller is a
    zombie leader and must stop (blob-barrier analog)."""


class TabletExecutor:
    SNAP_EVERY = 64  # commits between automatic checkpoints

    def __init__(self, tablet_id: str, store: BlobStore, *,
                 generation: int = 1, db: LocalDb | None = None,
                 version: int = 0, log_index: int = 0):
        self.tablet_id = tablet_id
        self.store = store
        self.generation = generation
        self.db = db or LocalDb()
        self.version = version  # last committed version
        self.log_index = log_index  # next redo record index
        self._since_snap = 0
        # one tablet = one writer: commit paths that bypass a global
        # commit lock (volatile readset exchange) still serialize
        # per-tablet here, so version/log_index never collide. Reentrant
        # because execute() checkpoints under it and checkpoint() is
        # also a public entry point that must take it itself.
        self._exec_lock = threading.RLock()
        # per-tablet counters (tablet_counters*.cpp analog), merged
        # cluster-wide by obs.tablet_counters.aggregate
        self.counters = {
            "tx_executed": 0, "tx_committed": 0, "redo_bytes": 0,
            "checkpoints": 0,
        }

    # ---- commit path ----

    def _prefix(self) -> str:
        return f"tablet/{self.tablet_id}/"

    def run(self, fn):
        """Execute a single-closure transaction; returns fn's result."""
        tx = _ApplyTx(fn)
        self.execute(tx)
        return tx.result

    def execute(self, tx: Transaction):
        with self._exec_lock:
            txc = TxContext(self.db, self.version + 1)
            tx.execute(txc, self)
            self.counters["tx_executed"] += 1
            if txc.changes:
                record = {
                    "gen": self.generation,
                    "version": txc.version,
                    "changes": [
                        [ch[0], list(ch[1])] + list(ch[2:])
                        for ch in txc.changes
                    ],
                }
                blob_id = (f"{self._prefix()}log/"
                           f"{self.generation:08d}."
                           f"{self.log_index:010d}")
                payload = json.dumps(record).encode()
                self.store.put(blob_id, payload)
                self.counters["tx_committed"] += 1
                self.counters["redo_bytes"] += len(payload)
                self.log_index += 1
                self.db.apply(txc.changes, txc.version)
                self.version = txc.version
                self._since_snap += 1
                if self._since_snap >= self.SNAP_EVERY:
                    self.checkpoint()
            tx.complete(self)
            return tx

    def _superseded(self) -> bool:
        """True when the store shows a higher generation has booted —
        this executor is a fenced-out zombie. Both log and snapshot keys
        encode the generation, so this is a listing, not blob reads."""
        for kind in ("log", "snap"):
            for blob_id in self.store.list(f"{self._prefix()}{kind}/"):
                g = int(blob_id.rsplit("/", 1)[1].split(".")[0])
                if g > self.generation:
                    return True
        return False

    def checkpoint(self) -> None:
        # serialized against execute(): an external checkpoint racing a
        # commit could snapshot a half-applied version and truncate the
        # redo records that covered it (reentrant from execute itself)
        with self._exec_lock:
            self._checkpoint_locked()

    def _checkpoint_locked(self) -> None:
        # A stale leader must never snapshot: its snapshot would bake in
        # zombie writes past the successor's fence and boot would then
        # skip the successor's redo records (version <= snapshot
        # version). Verify we are still the highest generation before
        # writing or truncating anything.
        if self._superseded():
            raise FencedError(
                f"tablet {self.tablet_id} gen {self.generation} "
                "superseded; refusing checkpoint")
        snap = {
            "gen": self.generation,
            "version": self.version,
            "log_index": self.log_index,
            "db": self.db.dump(),
        }
        # key carries (gen, version): two generations snapshotting at the
        # same version must not collide on one blob id
        self.store.put(
            f"{self._prefix()}snap/{self.generation:08d}.{self.version:012d}",
            json.dumps(snap).encode())
        # truncate redo records covered by the snapshot
        for blob_id in self.store.list(f"{self._prefix()}log/"):
            gen, idx = blob_id.rsplit("/", 1)[1].split(".")
            if (int(gen), int(idx)) < (self.generation, self.log_index):
                self.store.delete(blob_id)
        # prune superseded snapshots (this one covers them)
        for blob_id in self.store.list(f"{self._prefix()}snap/"):
            gen, ver = blob_id.rsplit("/", 1)[1].split(".")
            if (int(gen), int(ver)) < (self.generation, self.version):
                self.store.delete(blob_id)
        self._since_snap = 0
        self.counters["checkpoints"] += 1

    # ---- boot path ----

    @classmethod
    def boot(cls, tablet_id: str, store: BlobStore) -> "TabletExecutor":
        prefix = f"tablet/{tablet_id}/"
        db, version, log_index, gen = LocalDb(), 0, 0, 0
        by_gen: dict[int, list] = {}
        for blob_id in store.list(f"{prefix}log/"):
            rec = json.loads(store.get(blob_id).decode())
            g, idx = blob_id.rsplit("/", 1)[1].split(".")
            by_gen.setdefault(int(g), []).append((int(idx), rec))
        first_version = {
            g: min(rec["version"] for _, rec in recs)
            for g, recs in by_gen.items()
        }
        # Snapshot selection applies the same fence as replay: a
        # snapshot written by generation g whose version reaches at or
        # past the first version a higher generation wrote was taken by
        # a fenced-out zombie and has its writes baked in — skip it.
        best_snap, best_key = None, (-1, -1)
        for blob_id in store.list(f"{prefix}snap/"):
            snap = json.loads(store.get(blob_id).decode())
            fence = min((fv for h, fv in first_version.items()
                         if h > snap["gen"]), default=None)
            if fence is not None and snap["version"] >= fence:
                continue  # zombie-tainted snapshot
            key = (snap["gen"], snap["version"])
            if key > best_key:
                best_snap, best_key = snap, key
        if best_snap is not None:
            db = LocalDb.load(best_snap["db"])
            version = best_snap["version"]
            log_index = best_snap["log_index"]
            gen = best_snap["gen"]
        # Replay redo records after the snapshot with zombie fencing: a
        # generation g record is only valid below the first version any
        # higher generation wrote — the successor booted without seeing
        # anything past that point, so later g-writes are a fenced-out
        # leader's and must be discarded (the blob-barrier analog).
        for g in sorted(by_gen):
            if g < gen:
                continue  # pre-snapshot stale generation
            limit = min((first_version[h] for h in by_gen if h > g),
                        default=None)
            for idx, rec in sorted(by_gen[g]):
                if rec["version"] <= version:
                    continue
                if limit is not None and rec["version"] >= limit:
                    continue  # fenced zombie write
                changes = [(ch[0], tuple(ch[1]), *ch[2:])
                           for ch in rec["changes"]]
                db.apply(changes, rec["version"])
                version = rec["version"]
                gen = max(gen, g)
                log_index = max(log_index, idx + 1)
        gen = max(gen, max(by_gen, default=0))
        return cls(tablet_id, store, generation=gen + 1, db=db,
                   version=version, log_index=log_index)
