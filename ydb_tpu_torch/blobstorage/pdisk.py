"""PDisk: the raw-device chunk layer under VDisks.

Mirror of the reference's PDisk (ydb/core/blobstorage/pdisk/
blobstorage_pdisk_impl.h:46; SURVEY §2.3 PDisk row): one big device
(here: one file) divided into fixed-size CHUNKS, allocated/released to
owners, with a double-buffered superblock carrying the allocation state
and the owner's metadata — a crash between superblock commits falls
back to the previous consistent generation (the reference's format
record + sys log serve the same role).

Layout: chunks 0 and 1 are the superblock slots (alternating writes,
highest valid sequence wins); data chunks start at 2. Chunk writes are
in-place (the LSM above writes chunks append-only before committing
them to the manifest, so torn data chunks are unreachable garbage).

The port's own copy of ``ydb_tpu/blobstorage/pdisk.py``: the same file
layout and superblock encoding, so a PDisk file written by either
package opens in the other.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

_SB_HDR = struct.Struct("!QII")  # seq, payload_len, crc32


class PDisk:
    DATA_START = 2

    def __init__(self, path: str, chunk_size: int = 256 << 10):
        self.path = path
        self.chunk_size = chunk_size
        exists = os.path.exists(path)
        self._f = open(path, "r+b" if exists else "w+b")
        self._seq = 0
        self._free: set[int] = set()
        self._next_chunk = self.DATA_START
        self.meta: dict = {}
        if exists:
            self._load_superblock()

    # ---- superblock (allocation state + owner metadata) ----

    def _sb_read(self, slot: int):
        self._f.seek(slot * self.chunk_size)
        hdr = self._f.read(_SB_HDR.size)
        if len(hdr) < _SB_HDR.size:
            return None
        seq, n, crc = _SB_HDR.unpack(hdr)
        if n == 0 or n > self.chunk_size - _SB_HDR.size:
            return None
        payload = self._f.read(n)
        if len(payload) < n or zlib.crc32(payload) != crc:
            return None  # torn superblock write: slot invalid
        return seq, json.loads(payload.decode())

    def _load_superblock(self) -> None:
        best = None
        for slot in (0, 1):
            got = self._sb_read(slot)
            if got and (best is None or got[0] > best[0]):
                best = got
        if best is None:
            return  # fresh/unformatted device
        self._seq, state = best
        self._free = set(state["free"])
        self._next_chunk = state["next_chunk"]
        self.meta = state["meta"]

    def commit_meta(self, meta: dict) -> None:
        """Atomically persist allocation state + owner metadata (the
        next boot sees exactly this generation or the previous one)."""
        self.meta = dict(meta)
        self._seq += 1
        payload = json.dumps({
            "free": sorted(self._free),
            "next_chunk": self._next_chunk,
            "meta": self.meta,
        }).encode()
        if len(payload) + _SB_HDR.size > self.chunk_size:
            raise ValueError("superblock payload exceeds chunk size")
        slot = self._seq % 2
        self._f.seek(slot * self.chunk_size)
        self._f.write(_SB_HDR.pack(self._seq, len(payload),
                                   zlib.crc32(payload)))
        self._f.write(payload)
        self._f.flush()
        os.fsync(self._f.fileno())

    # ---- chunk allocation ----

    def alloc(self) -> int:
        """Reserve a chunk (volatile until commit_meta persists it as
        owned; an uncommitted allocation is reclaimed on reboot)."""
        if self._free:
            return self._free.pop()
        cid = self._next_chunk
        self._next_chunk += 1
        return cid

    def release(self, chunk_id: int) -> None:
        if chunk_id < self.DATA_START:
            raise ValueError("cannot release a superblock chunk")
        self._free.add(chunk_id)

    @property
    def allocated_chunks(self) -> int:
        return self._next_chunk - self.DATA_START - len(self._free)

    # ---- chunk IO ----

    def _off(self, chunk_id: int, offset: int, length: int) -> int:
        if offset + length > self.chunk_size:
            raise ValueError("IO crosses a chunk boundary")
        return chunk_id * self.chunk_size + offset

    def write(self, chunk_id: int, offset: int, data: bytes) -> None:
        self._f.seek(self._off(chunk_id, offset, len(data)))
        self._f.write(data)

    def read(self, chunk_id: int, offset: int, length: int) -> bytes:
        self._f.seek(self._off(chunk_id, offset, length))
        out = self._f.read(length)
        return out + b"\x00" * (length - len(out))

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()
