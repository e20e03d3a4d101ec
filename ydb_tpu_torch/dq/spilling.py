"""Channel spilling: bounded in-memory buffers overflow to blob storage.

The port's own copy of ``ydb_tpu/dq/spilling.py``, with its
leak-sanitizer handle per spilled blob. Payloads are host numpy dicts, encoded with
``np.savez`` exactly as the reference encodes them.

Reference: a per-node spilling service writes channel/compute blobs to
local files under quotas (dq/actors/spilling/spilling_file.cpp,
channel_storage.cpp; SURVEY.md §2.10). Here the spiller parks serialized
blocks in the blob store when a producer's unacked backlog exceeds its
memory quota, reloading lazily when credit returns — out-of-core
operation for skewed/slow consumers (SURVEY.md §5.7).
"""

from __future__ import annotations

import io
import itertools

import numpy as np

from ydb_tpu_torch.analysis import leaksan
from ydb_tpu_torch.engine.blobs import BlobStore, MemBlobStore


def _encode(payload: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def _decode(raw: bytes) -> dict[str, np.ndarray]:
    with np.load(io.BytesIO(raw)) as z:
        return {k: z[k] for k in z.files}


class Spiller:
    """Byte-budgeted FIFO of block payloads; excess spills to blobs."""

    def __init__(self, store: BlobStore | None = None,
                 mem_quota_bytes: int = 64 << 20,
                 prefix: str = "spill"):
        self.store = store if store is not None else MemBlobStore()
        self.quota = mem_quota_bytes
        self.prefix = prefix
        self._seq = itertools.count()
        self._mem: dict[int, dict] = {}
        self._spilled: set[int] = set()
        self._mem_bytes = 0
        self.spill_count = 0
        # leak-sanitizer handle per live spilled blob; empty when off
        self._leaks: dict[int, object] = {}

    @staticmethod
    def _size(payload: dict[str, np.ndarray]) -> int:
        return sum(a.nbytes for a in payload.values())

    def put(self, payload: dict[str, np.ndarray]) -> int:
        sid = next(self._seq)
        size = self._size(payload)
        if self._mem_bytes + size > self.quota:
            self.store.put(f"{self.prefix}/{sid}", _encode(payload))
            self._spilled.add(sid)
            self.spill_count += 1
            lk = leaksan.track("dq.spill", f"{self.prefix}/{sid}")
            if lk is not None:
                self._leaks[sid] = lk
        else:
            self._mem[sid] = payload
            self._mem_bytes += size
        return sid

    def peek(self, sid: int) -> dict[str, np.ndarray]:
        """Read WITHOUT consuming (checkpoint snapshots of accumulated
        state read the same ids again at finalize)."""
        if sid in self._mem:
            return self._mem[sid]
        if sid in self._spilled:
            return _decode(self.store.get(f"{self.prefix}/{sid}"))
        raise KeyError(sid)

    def get(self, sid: int) -> dict[str, np.ndarray]:
        if sid in self._mem:
            payload = self._mem.pop(sid)
            self._mem_bytes -= self._size(payload)
            return payload
        if sid in self._spilled:
            self._spilled.discard(sid)
            raw = self.store.get(f"{self.prefix}/{sid}")
            self.store.delete(f"{self.prefix}/{sid}")
            if self._leaks:
                leaksan.close(self._leaks.pop(sid, None))
            return _decode(raw)
        raise KeyError(sid)

    def close(self) -> None:
        """Delete every blob still spilled and drop buffered payloads: a
        query aborted (peer death, deadline cancellation) with parked or
        accumulated block ids would otherwise leave its spill blobs in
        the store, since only ``get`` deletes them. Idempotent; the
        spiller is unusable for those ids afterwards, which is fine — it
        is per-task and the task is gone."""
        for sid in self._spilled:
            self.store.delete(f"{self.prefix}/{sid}")
            if self._leaks:
                leaksan.close(self._leaks.pop(sid, None))
        self._spilled.clear()
        self._mem.clear()
        self._mem_bytes = 0
