"""GroupBlobStore: the narrow BlobStore interface over a DSProxy.

The integration seam: every durable consumer in the system — tablet
executors, ColumnShard portions/WAL, SchemeShard, the cluster dict
journal — talks BlobStore (SURVEY.md §2.3 header: tablets never see
disks, only blob ids). Pointing a Cluster at a GroupBlobStore puts the
ENTIRE database on erasure-coded storage: kill any max_lost disks of
the group and every table still reads and writes.

The port's own copy of ``ydb_tpu/blobstorage/proxy_store.py``. Like the
reference it has no ``get_range``: a ranged read falls to
``BlobStore.get_range``, which decodes the whole blob and slices it
(copied on purpose; ROADMAP.md queue C).
"""

from __future__ import annotations

from ydb_tpu_torch.blobstorage.group import DSProxy
from ydb_tpu_torch.engine.blobs import BlobStore


class GroupBlobStore(BlobStore):
    def __init__(self, proxy: DSProxy):
        self.proxy = proxy

    def put(self, blob_id: str, data: bytes) -> None:
        self.proxy.put(blob_id, bytes(data))

    def get(self, blob_id: str) -> bytes:
        return self.proxy.get(blob_id)

    def delete(self, blob_id: str) -> None:
        self.proxy.delete(blob_id)

    def exists(self, blob_id: str) -> bool:
        return self.proxy.exists(blob_id)

    def list(self, prefix: str = "") -> list[str]:
        return self.proxy.list(prefix)
