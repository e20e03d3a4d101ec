"""BlobDepot: blob virtualization tablet + transparent store adapter.

Mirror of the reference's blob-virtualization layer (ydb/core/
blob_depot: a tablet that owns the mapping from client blob names to
physically stored blobs, reference-counts shared payloads, garbage-
collects unreferenced data, and absorbs ("decommits") blobs from
groups being drained; SURVEY.md §2.3 row "BlobDepot / incrhuge /
keyvalue"). Built as an ordinary tablet over the executor, fronting
any BlobStore backend:

  * payloads dedup by content hash: N logical names for one payload
    store it once with refcount N (the incrhuge space-efficiency
    motivation);
  * deletes decrement; the physical blob is deleted only at zero
    references (with a durable trash mark first, so a crash between
    the index commit and the physical delete leaves garbage, never a
    dangling reference — collect_garbage() sweeps);
  * ``DepotBlobStore`` exposes the standard Put/Get/Delete/List
    surface, so any tablet (executor WAL, PQ partition, ColumnShard)
    runs over a depot transparently;
  * ``decommit(prefix)`` absorbs existing direct blobs of the backend
    into the depot index and rewrites them into depot-owned keys —
    the group-draining flow of the reference's decommission path.

The port's own copy of ``ydb_tpu/blobstorage/blob_depot.py`` over the
port's tablet executor: the same tablet id, tables and payload keys, so
a depot written by either package boots in the other.
"""

from __future__ import annotations

import hashlib

from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.tablet.executor import TabletExecutor


def _digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


class BlobDepot:
    """Name -> payload indirection with dedup + refcounted GC."""

    def __init__(self, depot_id: str, backend: BlobStore):
        self.backend = backend
        self.depot_id = depot_id
        self.executor = TabletExecutor.boot(f"blobdepot/{depot_id}",
                                            backend)
        self._prefix = f"depot/{depot_id}/data/"
        # sweep trash a crash may have left between index commit and
        # physical delete (the crash-recovery half of the GC contract)
        self.collect_garbage()

    # -- write path --

    def put(self, name: str, data: bytes) -> None:
        digest = _digest(data)
        phys = self._prefix + digest
        # write payload BEFORE the index commit: a crash leaves
        # unreferenced garbage (swept later), never a broken reference
        if not self.backend.exists(phys):
            self.backend.put(phys, data)

        def fn(txc):
            old = txc.get("names", (name,))
            ref = txc.get("refs", (digest,))
            if old is not None and old["digest"] == digest:
                return False  # same content re-put: nothing changes
            txc.put("names", (name,), {"digest": digest,
                                       "size": len(data)})
            txc.put("refs", (digest,),
                    {"n": (ref["n"] if ref else 0) + 1,
                     "size": len(data)})
            if old is not None:
                self._dec_locked(txc, old["digest"])
                return True  # the displaced payload may now be trash
            return False
        if self.executor.run(fn):
            self.collect_garbage()

    def _dec_locked(self, txc, digest: str) -> None:
        ref = txc.get("refs", (digest,))
        n = (ref["n"] if ref else 1) - 1
        if n <= 0:
            txc.erase("refs", (digest,))
            # durable trash mark first; physical delete may crash
            txc.put("trash", (digest,), {})
        else:
            txc.put("refs", (digest,), dict(ref or {}, n=n))

    def delete(self, name: str) -> None:
        def fn(txc):
            row = txc.get("names", (name,))
            if row is None:
                return
            txc.erase("names", (name,))
            self._dec_locked(txc, row["digest"])
        self.executor.run(fn)
        self.collect_garbage()

    # -- read path --

    def get(self, name: str) -> bytes:
        row = self.executor.db.table("names").get((name,))
        if row is None:
            raise KeyError(name)
        return self.backend.get(self._prefix + row["digest"])

    def exists(self, name: str) -> bool:
        return self.executor.db.table("names").get((name,)) is not None

    def names(self, prefix: str = "") -> list[str]:
        # range-bounded like MemBlobStore.list: DepotBlobStore.list
        # sits on tablet boot/checkpoint hot paths
        lo = (prefix,) if prefix else None
        hi = (prefix + "￿",) if prefix else None
        return [n for (n,), _row in
                self.executor.db.table("names").range(lo=lo, hi=hi)]

    # -- maintenance --

    def collect_garbage(self) -> int:
        """Physically delete trash-marked payloads; returns count.
        Re-put of identical content between mark and sweep is handled:
        a digest with a live refcount is unmarked, not deleted."""
        swept = 0
        for (digest,), _row in list(
                self.executor.db.table("trash").range()):
            ref = self.executor.db.table("refs").get((digest,))
            if ref is not None:  # resurrected by a concurrent put
                self.executor.run(
                    lambda txc, d=digest: txc.erase("trash", (d,)))
                continue
            phys = self._prefix + digest
            if self.backend.exists(phys):
                self.backend.delete(phys)
            self.executor.run(
                lambda txc, d=digest: txc.erase("trash", (d,)))
            swept += 1
        return swept

    def stats(self) -> dict:
        names = logical = 0
        for (_n,), row in self.executor.db.table("names").range():
            names += 1
            logical += row["size"]
        payloads = physical = 0
        # sizes come from the refs index — a metadata query must not
        # fetch payload bytes from the backend
        for (_d,), row in self.executor.db.table("refs").range():
            payloads += 1
            physical += row.get("size", 0)
        return {"names": names, "payloads": payloads,
                "logical_bytes": logical, "physical_bytes": physical}

    def decommit(self, prefix: str) -> int:
        """Absorb direct backend blobs under ``prefix`` into the depot
        (decommission flow): each becomes a depot name; the original
        direct blob is removed once indexed. Returns blobs absorbed."""
        absorbed = 0
        for blob_id in list(self.backend.list(prefix)):
            # never absorb ANY depot's payloads or ANY tablet's state
            # (a shared backend hosts several depots + their tablets;
            # draining a sibling would dangle its references)
            if blob_id.startswith("depot/") or \
                    blob_id.startswith("tablet/"):
                continue
            data = self.backend.get(blob_id)
            self.put(blob_id, data)
            self.backend.delete(blob_id)
            absorbed += 1
        return absorbed


class DepotBlobStore(BlobStore):
    """Standard BlobStore surface over a BlobDepot (virtual group)."""

    def __init__(self, depot: BlobDepot):
        self.depot = depot

    def put(self, blob_id: str, data: bytes) -> None:
        self.depot.put(blob_id, data)

    def get(self, blob_id: str) -> bytes:
        return self.depot.get(blob_id)

    def delete(self, blob_id: str) -> None:
        self.depot.delete(blob_id)

    def exists(self, blob_id: str) -> bool:
        return self.depot.exists(blob_id)

    def list(self, prefix: str = "") -> list[str]:
        return self.depot.names(prefix)
