"""Blob storage behind a narrow Put/Get/Delete interface.

The port's own copy of ``BlobStore``, ``MemBlobStore`` and
``DirBlobStore`` from ``ydb_tpu/engine/blobs.py``, with its chaos sites
``blob.put`` / ``blob.get`` / ``blob.get_range`` (``_chaos_io``). Column
shards keep their portions here, the DQ spiller parks channel and
partial-aggregate payloads here, and checkpoint storage keeps task state
here. Backends:

  * ``MemBlobStore``  — in-process store (the spiller's default)
  * ``DirBlobStore``  — local filesystem directory (one file per blob),
    crash-safe via write-to-temp + atomic rename
"""

from __future__ import annotations

import bisect
import os
import tempfile
import threading

from ydb_tpu_torch import chaos


def _chaos_io(op: str, blob_id: str,
              data: bytes | None = None) -> bytes | None:
    """Chaos injection on the real IO surface (sites ``blob.put`` /
    ``blob.get`` / ``blob.get_range``): latency spikes sleep here,
    ``io_error`` raises :class:`chaos.InjectedIOError` (an OSError, so
    the retry plane treats it as the real thing), ``torn`` returns a
    short read whose decode failure exercises the re-fetch path.
    Disarmed cost: one bool check inside ``chaos.hit``."""
    f = chaos.hit(op, blob=blob_id)
    if f is None:
        return data
    f.sleep()
    if f.kind == "io_error":
        raise chaos.InjectedIOError(
            f"injected {op} failure on {blob_id!r}")
    if f.kind == "torn" and data is not None:
        return data[:len(data) // 2]
    return data


class BlobStore:
    def put(self, blob_id: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, blob_id: str) -> bytes:
        raise NotImplementedError

    def get_range(self, blob_id: str, off: int, length: int) -> bytes:
        """Ranged read (the DSProxy TEvGet shift/size analog). Backends
        that can seek override this; the default slices a full get."""
        return self.get(blob_id)[off:off + length]

    def delete(self, blob_id: str) -> None:
        raise NotImplementedError

    def exists(self, blob_id: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def size(self, blob_id: str) -> int:
        """Stored byte size; default reads the blob (backends with a
        cheap stat override this)."""
        return len(self.get(blob_id))


class MemBlobStore(BlobStore):
    """In-memory store with a sorted key index: ``list(prefix)`` is
    O(log n + matches), not a full scan. Thread-safe."""

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._keys: list[str] = []  # sorted key index
        self._lock = threading.Lock()

    def size(self, blob_id: str) -> int:
        with self._lock:
            return len(self._data[blob_id])

    def put(self, blob_id, data):
        _chaos_io("blob.put", blob_id)
        with self._lock:
            if blob_id not in self._data:
                bisect.insort(self._keys, blob_id)
            self._data[blob_id] = bytes(data)

    def get(self, blob_id):
        return _chaos_io("blob.get", blob_id, self._data[blob_id])

    def get_range(self, blob_id, off, length):
        return _chaos_io("blob.get_range", blob_id,
                         self._data[blob_id][off:off + length])

    def delete(self, blob_id):
        with self._lock:
            if blob_id in self._data:
                del self._data[blob_id]
                i = bisect.bisect_left(self._keys, blob_id)
                if i < len(self._keys) and self._keys[i] == blob_id:
                    self._keys.pop(i)

    def exists(self, blob_id):
        return blob_id in self._data

    def list(self, prefix=""):
        with self._lock:
            if not prefix:
                return list(self._keys)
            lo = bisect.bisect_left(self._keys, prefix)
            hi = bisect.bisect_left(self._keys, prefix + "￿")
            return self._keys[lo:hi]


class DirBlobStore(BlobStore):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def size(self, blob_id: str) -> int:
        return os.path.getsize(self._path(blob_id))

    def _path(self, blob_id: str) -> str:
        from urllib.parse import quote

        return os.path.join(self.root, quote(blob_id, safe=""))

    def put(self, blob_id, data):
        _chaos_io("blob.put", blob_id)
        # temp + rename: a crash mid-write never leaves a torn blob
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp.")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(blob_id))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, blob_id):
        with open(self._path(blob_id), "rb") as f:
            return _chaos_io("blob.get", blob_id, f.read())

    def get_range(self, blob_id, off, length):
        with open(self._path(blob_id), "rb") as f:
            f.seek(off)
            return _chaos_io("blob.get_range", blob_id, f.read(length))

    def delete(self, blob_id):
        try:
            os.unlink(self._path(blob_id))
        except FileNotFoundError:
            pass

    def exists(self, blob_id):
        return os.path.exists(self._path(blob_id))

    def list(self, prefix=""):
        from urllib.parse import quote, unquote

        enc_prefix = quote(prefix, safe="")
        out = []
        for name in os.listdir(self.root):
            if name.startswith(".tmp."):
                continue
            if name.startswith(enc_prefix):
                out.append(unquote(name))
        return sorted(out)
