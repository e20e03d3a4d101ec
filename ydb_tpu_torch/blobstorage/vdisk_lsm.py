"""VDisk hull: an LSM-structured BlobStore over PDisk chunks.

Mirror of the reference VDisk's hull database (ydb/core/blobstorage/
vdisk/hulldb; SURVEY §2.3 VDisk row): writes land in a WAL (log chunks)
plus a memtable; flushes seal the memtable into an immutable sorted run
(SST) written append-only into reserved chunks; a MANIFEST (the PDisk
superblock metadata) lists live runs newest-first; size-tiered
compaction merges runs and releases their chunks. Recovery = manifest
+ WAL replay — the same two-structure design as the reference's
fresh-segment + levels with sync-log recovery.

Exposes the standard BlobStore surface, so a ``VDisk(backing=...)`` in
a blob group runs its part store on real chunked storage.

The port's own copy of ``ydb_tpu/blobstorage/vdisk_lsm.py``: the same
WAL frames, run layout and manifest, so a hull written by either
package recovers in the other. As in the reference, a WAL record must
fit one PDisk chunk (``ValueError("record larger than a chunk")``):
the chunk size bounds the largest part a VDisk takes (copied on
purpose; ROADMAP.md queue C).
"""

from __future__ import annotations

import struct
import zlib

from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.blobstorage.pdisk import PDisk

_REC = struct.Struct("!II")  # key_len, value_len (value 0xFFFFFFFF = del)
_TOMB = 0xFFFFFFFF


class LsmBlobStore(BlobStore):
    def __init__(self, pdisk: PDisk, memtable_bytes: int = 1 << 20,
                 max_runs: int = 6):
        self.pdisk = pdisk
        self.memtable_bytes = memtable_bytes
        self.max_runs = max_runs
        self.mem: dict[str, bytes | None] = {}
        self._mem_size = 0
        # manifest state
        self.runs: list[dict] = []   # newest first: {chunks, index}
        self._log_chunks: list[int] = []
        self._log_pos = 0
        self._boot()

    # ---- boot / manifest ----

    def _boot(self) -> None:
        meta = self.pdisk.meta
        self.runs = list(meta.get("runs", []))
        for cid in meta.get("log", []):
            self._replay_log_chunk(cid)
            self._log_chunks.append(cid)
        if not self._log_chunks:
            self._new_log_chunk(commit=True)

    def _commit_manifest(self) -> None:
        self.pdisk.commit_meta({
            "runs": self.runs,
            "log": self._log_chunks,
        })

    # ---- WAL ----

    def _new_log_chunk(self, commit: bool) -> None:
        cid = self.pdisk.alloc()
        # zero the header region so replay of a recycled chunk stops
        self.pdisk.write(cid, 0, b"\x00" * _REC.size)
        self._log_chunks.append(cid)
        self._log_pos = 0
        if commit:
            self._commit_manifest()

    def _log_append(self, key: str, value: bytes | None) -> None:
        kb = key.encode()
        vb = b"" if value is None else value
        rec = _REC.pack(len(kb), _TOMB if value is None else len(vb))
        frame = rec + kb + vb + struct.pack("!I", zlib.crc32(kb + vb))
        if self._log_pos + len(frame) + _REC.size > self.pdisk.chunk_size:
            self._new_log_chunk(commit=True)
        if len(frame) + _REC.size > self.pdisk.chunk_size:
            raise ValueError("record larger than a chunk")
        cid = self._log_chunks[-1]
        self.pdisk.write(cid, self._log_pos, frame)
        # pre-zero the NEXT header so replay terminates cleanly
        self.pdisk.write(cid, self._log_pos + len(frame),
                         b"\x00" * _REC.size)
        self.pdisk.sync()
        self._log_pos += len(frame)

    def _replay_log_chunk(self, cid: int) -> None:
        pos = 0
        while pos + _REC.size <= self.pdisk.chunk_size:
            klen, vlen = _REC.unpack(
                self.pdisk.read(cid, pos, _REC.size))
            if klen == 0:
                break
            is_del = vlen == _TOMB
            dlen = 0 if is_del else vlen
            body = self.pdisk.read(cid, pos + _REC.size, klen + dlen + 4)
            kb, vb = body[:klen], body[klen:klen + dlen]
            (crc,) = struct.unpack("!I", body[klen + dlen:])
            if zlib.crc32(kb + vb) != crc:
                break  # torn tail record: stop replay here
            self._mem_put(kb.decode(), None if is_del else vb)
            pos += _REC.size + klen + dlen + 4
        self._log_pos = pos

    # ---- memtable ----

    def _mem_put(self, key: str, value: bytes | None) -> None:
        old = self.mem.get(key)
        if old:
            self._mem_size -= len(old)
        self.mem[key] = value
        self._mem_size += len(value) if value else 0

    # ---- SST runs ----

    def _flush(self) -> None:
        if not self.mem:
            return
        entries = sorted(self.mem.items())
        chunks: list[int] = []
        index: list[tuple[str, int, int, int, bool]] = []
        cid = self.pdisk.alloc()
        chunks.append(cid)
        pos = 0
        for key, value in entries:
            vb = b"" if value is None else value
            if pos + len(vb) > self.pdisk.chunk_size:
                cid = self.pdisk.alloc()
                chunks.append(cid)
                pos = 0
            if len(vb) > self.pdisk.chunk_size:
                raise ValueError("value larger than a chunk")
            self.pdisk.write(cid, pos, vb)
            index.append((key, len(chunks) - 1, pos, len(vb),
                          value is None))
            pos += len(vb)
        self.pdisk.sync()
        self.runs.insert(0, {"chunks": chunks, "index": index})
        # the flush supersedes the WAL: recycle log chunks
        old_logs = self._log_chunks
        self._log_chunks = []
        self.mem = {}
        self._mem_size = 0
        self._new_log_chunk(commit=False)
        for cid in old_logs:
            self.pdisk.release(cid)
        if len(self.runs) > self.max_runs:
            self._compact()
        else:
            self._commit_manifest()

    def _compact(self) -> None:
        """Merge every run newest-wins into one; drop tombstones (full
        compaction = no older data can resurrect under them)."""
        merged: dict[str, tuple] = {}
        for run in self.runs:  # newest first: first occurrence wins
            for key, ci, off, ln, is_del in run["index"]:
                if key not in merged:
                    merged[key] = (run, ci, off, ln, is_del)
        entries = []
        for key in sorted(merged):
            run, ci, off, ln, is_del = merged[key]
            if is_del:
                continue
            entries.append(
                (key, self.pdisk.read(run["chunks"][ci], off, ln)))
        old_runs = self.runs
        chunks: list[int] = []
        index: list[tuple] = []
        cid = self.pdisk.alloc()
        chunks.append(cid)
        pos = 0
        for key, vb in entries:
            if pos + len(vb) > self.pdisk.chunk_size:
                cid = self.pdisk.alloc()
                chunks.append(cid)
                pos = 0
            self.pdisk.write(cid, pos, vb)
            index.append((key, len(chunks) - 1, pos, len(vb), False))
            pos += len(vb)
        self.pdisk.sync()
        self.runs = [{"chunks": chunks, "index": index}]
        self._commit_manifest()
        for run in old_runs:
            for c in run["chunks"]:
                self.pdisk.release(c)

    def _find(self, key: str):
        """(value bytes | None-as-tombstone | 'absent' sentinel)."""
        if key in self.mem:
            return self.mem[key]
        for run in self.runs:
            for k, ci, off, ln, is_del in run["index"]:
                if k == key:
                    if is_del:
                        return None
                    return self.pdisk.read(run["chunks"][ci], off, ln)
        return _ABSENT

    # ---- BlobStore surface ----

    def put(self, blob_id, data):
        data = bytes(data)
        self._log_append(blob_id, data)
        self._mem_put(blob_id, data)
        if self._mem_size >= self.memtable_bytes:
            self._flush()

    def get(self, blob_id):
        v = self._find(blob_id)
        if v is _ABSENT or v is None:
            raise KeyError(blob_id)
        return v

    def delete(self, blob_id):
        self._log_append(blob_id, None)
        self._mem_put(blob_id, None)

    def exists(self, blob_id):
        v = self._find(blob_id)
        return v is not _ABSENT and v is not None

    def list(self, prefix=""):
        seen: dict[str, bool] = {}
        for key, v in self.mem.items():
            if key.startswith(prefix):
                seen[key] = v is not None
        for run in self.runs:
            for k, ci, off, ln, is_del in run["index"]:
                if k.startswith(prefix) and k not in seen:
                    seen[k] = not is_del
        return sorted(k for k, live in seen.items() if live)

    def flush(self) -> None:
        """Public flush (tests / graceful shutdown)."""
        self._flush()


class _Absent:
    __slots__ = ()


_ABSENT = _Absent()
