"""Blob storage behind a narrow Put/Get/Delete interface.

The port's own copy of ``ydb_tpu/engine/blobs.py``, with its chaos sites
``blob.put`` / ``blob.get`` / ``blob.get_range`` (``_chaos_io``). Column
shards keep their portions here, the DQ spiller parks channel and
partial-aggregate payloads here, and checkpoint storage keeps task state
here. Backends:

  * ``MemBlobStore``  — in-process store (the spiller's default)
  * ``DirBlobStore``  — local filesystem directory (one file per blob),
    crash-safe via write-to-temp + atomic rename
  * ``CachedBlobStore`` — a byte-budget LRU page cache over any backend
  * ``TieredBlobStore`` — hot/cold tiers behind the flat surface

The two wrappers delegate every read and write to the stores they wrap,
so the chaos sites fire there, as in the reference.
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


class CachedBlobStore(BlobStore):
    """Shared page cache over any backend (SURVEY §2.4 row 'shared page
    cache'; reference ydb/core/tablet_flat shared_cache.cpp): a node-wide
    byte-budget LRU over blob reads, shared by every shard on the node so
    hot portions/chunks are fetched once. Writes/deletes invalidate
    (write-through); ranged reads cache per (blob, off, len) page — the
    chunk-granular scan reader hits exactly these.

    Thread-safe: conveyor background jobs and foreground scans share it.
    """

    def __init__(self, base: BlobStore, capacity_bytes: int = 256 << 20):
        from collections import OrderedDict

        self.base = base
        self.capacity_bytes = capacity_bytes
        # the operator-configured budget: the grow ceiling for
        # pressure recovery; explicit resize() re-bases it
        self._configured_capacity = capacity_bytes
        self._lru: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._by_blob: dict[str, set] = {}  # blob_id -> cached keys
        self._bytes = 0
        self._lock = threading.Lock()
        # GLOBAL invalidation generation, bumped by every put/delete: a
        # fill whose read STARTED before any invalidation is rejected,
        # closing the read-miss / write / stale-fill TOCTOU race. One
        # counter (not per-blob) keeps memory O(1); the cost is a
        # conservatively-skipped fill when an unrelated blob was
        # rewritten during the read — a missed optimization, never a
        # stale result.
        self._gen = 0
        self.hits = 0
        self.misses = 0

    # -- cache core --

    def _cache_get(self, key):
        with self._lock:
            data = self._lru.get(key)
            if data is not None:
                self._lru.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return data, self._gen

    def _cache_put(self, key, data: bytes, gen: int):
        if len(data) > self.capacity_bytes:
            return  # larger than the whole budget: never cache
        with self._lock:
            if self._gen != gen:
                return  # an invalidation raced the fill: maybe stale
            old = self._lru.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._lru[key] = data
            self._by_blob.setdefault(key[0], set()).add(key)
            self._bytes += len(data)
            self._evict_to_fit()

    def _evict_to_fit(self) -> None:
        """LRU eviction to the budget (caller holds the lock)."""
        while self._bytes > self.capacity_bytes and self._lru:
            k, evicted = self._lru.popitem(last=False)
            self._bytes -= len(evicted)
            keys = self._by_blob.get(k[0])
            if keys is not None:
                keys.discard(k)
                if not keys:
                    del self._by_blob[k[0]]

    def resize(self, capacity_bytes: int,
               rebase: bool = True) -> None:
        """Shrink/grow the byte budget, evicting LRU pages to fit.
        ``rebase`` (an explicit operator resize) moves the configured
        grow ceiling too; pressure reactions pass rebase=False."""
        with self._lock:
            self.capacity_bytes = max(0, capacity_bytes)
            if rebase:
                self._configured_capacity = self.capacity_bytes
            self._evict_to_fit()

    def react_to_pressure(self, used_fraction: float,
                          high: float = 0.85,
                          low: float = 0.6) -> str:
        """Memory-pressure integration (the shared_sausagecache +
        memory-controller contract, shared_sausagecache.cpp:194):
        above the ``high`` watermark the budget HALVES (floor 4 KiB);
        below ``low`` it doubles back toward the configured maximum.
        Returns "shrink" | "grow" | "steady" for observability."""
        if used_fraction > high:
            self.resize(max(self.capacity_bytes // 2, 4096),
                        rebase=False)
            return "shrink"
        if used_fraction < low and \
                self.capacity_bytes < self._configured_capacity:
            self.resize(min(self.capacity_bytes * 2,
                            self._configured_capacity),
                        rebase=False)
            return "grow"
        return "steady"

    def _invalidate(self, blob_id: str):
        with self._lock:
            self._gen += 1
            for key in self._by_blob.pop(blob_id, ()):
                data = self._lru.pop(key, None)
                if data is not None:
                    self._bytes -= len(data)

    # -- BlobStore surface --

    def put(self, blob_id, data):
        self.base.put(blob_id, data)
        self._invalidate(blob_id)

    def get(self, blob_id):
        key = (blob_id, None, None)
        data, gen = self._cache_get(key)
        if data is None:
            data = self.base.get(blob_id)
            self._cache_put(key, data, gen)
        return data

    def get_range(self, blob_id, off, length):
        key = (blob_id, off, length)
        data, gen = self._cache_get(key)
        if data is None:
            data = self.base.get_range(blob_id, off, length)
            self._cache_put(key, data, gen)
        return data

    def delete(self, blob_id):
        self.base.delete(blob_id)
        self._invalidate(blob_id)

    def exists(self, blob_id):
        return self.base.exists(blob_id)

    def list(self, prefix=""):
        return self.base.list(prefix)

    def stats(self) -> dict:
        with self._lock:
            return {"bytes": self._bytes, "entries": len(self._lru),
                    "hits": self.hits, "misses": self.misses}


class TieredBlobStore(BlobStore):
    """Hot/cold tiering behind the flat BlobStore surface (SURVEY §2.7
    blob-abstraction-and-tiering row; reference ydb/core/tx/tiering +
    S3 external storage): writes land in the hot tier; ``evict``
    migrates blobs matching a predicate to the cold tier (an object
    store in a real deployment — any BlobStore here); reads fall
    through hot -> cold transparently, so portion metadata never
    changes when data changes temperature. ``promote`` moves a hot-read
    candidate back.
    """

    def __init__(self, hot: BlobStore, cold: BlobStore):
        self.hot = hot
        self.cold = cold

    def put(self, blob_id, data):
        self.hot.put(blob_id, data)
        # a rewrite supersedes any cold copy (stale tier shadowing)
        if self.cold.exists(blob_id):
            self.cold.delete(blob_id)

    def get(self, blob_id):
        if self.hot.exists(blob_id):
            return self.hot.get(blob_id)
        return self.cold.get(blob_id)

    def get_range(self, blob_id, off, length):
        if self.hot.exists(blob_id):
            return self.hot.get_range(blob_id, off, length)
        return self.cold.get_range(blob_id, off, length)

    def delete(self, blob_id):
        self.hot.delete(blob_id)
        self.cold.delete(blob_id)

    def exists(self, blob_id):
        return self.hot.exists(blob_id) or self.cold.exists(blob_id)

    def list(self, prefix=""):
        merged = set(self.hot.list(prefix)) | set(self.cold.list(prefix))
        return sorted(merged)

    # -- tier management --

    def evict(self, predicate) -> int:
        """Move hot blobs with predicate(blob_id)=True to the cold tier
        (the TTL-driven tier eviction shape, tx/tiering). Copy-then-
        delete: a crash in between leaves a harmless duplicate (reads
        prefer hot; the next evict pass re-deletes)."""
        moved = 0
        for bid in self.hot.list(""):
            if not predicate(bid):
                continue
            self.cold.put(bid, self.hot.get(bid))
            self.hot.delete(bid)
            moved += 1
        return moved

    def promote(self, blob_id) -> bool:
        """Bring a cold blob back to the hot tier (read-heat feedback)."""
        if self.hot.exists(blob_id) or not self.cold.exists(blob_id):
            return False
        self.hot.put(blob_id, self.cold.get(blob_id))
        self.cold.delete(blob_id)
        return True

    def tier_of(self, blob_id) -> str | None:
        if self.hot.exists(blob_id):
            return "hot"
        if self.cold.exists(blob_id):
            return "cold"
        return None
