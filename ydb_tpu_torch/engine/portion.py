"""Portions: immutable columnar data units with PK stats.

The port's own copy of ``ydb_tpu/engine/portion.py``, with its
data-movement timeline hooks: a ``blob.read`` event and a ``decode``
interval per chunk, and the ``blob_read_bytes`` / ``decoded_bytes``
counters (``obs/timeline.py``).

Reference: a ColumnShard's data is a set of *portions* — per-column blobs
plus metadata (row count, PK min/max, snapshot) grouped into granules
(TPortionInfo, engines/portion_info.h; SURVEY.md §2.7). Scans plan by
intersecting portion PK ranges with the query range at a snapshot.

Here a portion serializes into one blob of PK-consecutive row-group
*chunks* (each chunk an npz of the column slices + validity masks), with
a JSON header indexing {offset, rows, pk_min, pk_max} per chunk so
readers can fetch one chunk at a time via ranged gets — the streaming
K-way merge (ydb_tpu_torch.engine.reader) keeps at most a few chunks per
portion resident, never a whole portion. Metadata lives in the shard's
WAL/snapshot (not in the blob), so planning never touches blob storage.
Column data is the *physical* encoding (dict ids, scaled decimals) —
dictionaries are table-level state owned by the shard.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
import time
import zipfile

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.chaos.retry import RetryPolicy
from ydb_tpu_torch.engine.blobs import BlobStore

#: One policy for every portion-blob read. Each retry re-fetches AND
#: re-decodes, so torn/short reads (decode blows up, not the get) heal
#: the same way IO errors do. Backoff respects the statement deadline.
READ_RETRY = RetryPolicy(max_attempts=4, base_delay=0.002)
#: What a transient blob read looks like: IO failure, or the decode
#: errors a truncated payload produces (npz blobs are zip containers).
_TRANSIENT_READ = (OSError, EOFError, ValueError, zipfile.BadZipFile,
                   struct.error)


@dataclasses.dataclass
class PortionMeta:
    portion_id: int
    blob_id: str
    num_rows: int
    # MVCC window: visible when commit_snap <= snap < removed_snap
    commit_snap: int
    removed_snap: int | None = None
    # PK range stats for scan pruning (min/max of the first PK column)
    pk_min: int | None = None
    pk_max: int | None = None
    # min/max of the TTL column, for eviction planning
    ttl_min: int | None = None
    ttl_max: int | None = None
    # per-column zone map: {column: [vmin, vmax, null_count]} over the
    # WHOLE portion (union of its chunk zones; ydb_tpu_torch.stats.zonemap) —
    # scan planning prunes portions against filter predicates without
    # touching blob storage. None on pre-stats portions (v0 metadata).
    zones: dict | None = None
    # table schema version this portion was written under: a column only
    # reads from portions at least as new as the version that (re)added
    # it — DROP then ADD of the same name must not resurrect old bytes
    schema_version: int = 1

    def visible_at(self, snap: int) -> bool:
        if self.commit_snap > snap:
            return False
        return self.removed_snap is None or snap < self.removed_snap

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "PortionMeta":
        return PortionMeta(**d)


PORTION_MAGIC = b"YDBP0001"
DEFAULT_CHUNK_ROWS = 1 << 16
#: blob header format version: v1 adds per-chunk column zone maps
#: ("zones" per chunk entry). v0 headers (no "version" key) read fine —
#: they simply carry no zones, so scans fall back to unpruned reads.
HEADER_VERSION = 1


def _pack_chunk(columns, validity, lo, hi) -> bytes:
    buf = io.BytesIO()
    payload = {n: a[lo:hi] for n, a in columns.items()}
    if validity:
        for name, v in validity.items():
            payload[f"__valid__{name}"] = v[lo:hi]
    np.savez(buf, **payload)
    return buf.getvalue()


def _unpack_chunk(data: bytes) -> tuple[dict, dict]:
    with np.load(io.BytesIO(data)) as z:
        cols, valid = {}, {}
        for name in z.files:
            if name.startswith("__valid__"):
                valid[name[len("__valid__"):]] = z[name]
            else:
                cols[name] = z[name]
    return cols, valid


#: npy header readers by format version: numpy's public ones (the
#: reference calls the private ``_read_array_header``, which numpy 2.x
#: releases do not all have); other versions decode through ``np.load``
_NPY_HEADER_READERS = {
    (1, 0): np.lib.format.read_array_header_1_0,
    (2, 0): np.lib.format.read_array_header_2_0,
}


def _unpack_chunk_view(data: bytes) -> tuple[dict, dict]:
    """Zero-copy chunk decode: read-only array VIEWS into ``data``.

    ``np.savez`` stores members uncompressed (ZIP_STORED), so every
    npy's payload is a contiguous slice of the blob bytes already in
    hand — ``np.load`` still pays a ZipExtFile + CRC + copy per member,
    which measures ~10x the cost of the underlying memcpy and holds the
    GIL throughout (it is what serializes the morsel pipeline's decode
    stage). Here we walk the zip directory, parse each npy header, and
    ``np.frombuffer`` straight into the fetched buffer: no copy, no
    CRC pass, a few microseconds per member. Torn payloads still fail
    (zip directory/npy header parses raise ``_TRANSIENT_READ`` kinds),
    so the fetch+decode retry contract is unchanged; anything this fast
    path cannot prove safe (compressed member, object dtype, truncated
    payload) falls back to ``np.load``. Callers get READ-ONLY arrays —
    every downstream consumer (rechunk, block build, merge cursors)
    copies rather than mutates."""
    buf = io.BytesIO(data)
    cols, valid = {}, {}
    with zipfile.ZipFile(buf) as z:
        for zi in z.infolist():
            if zi.compress_type != zipfile.ZIP_STORED:
                return _unpack_chunk(data)
            # local header: 26..30 hold filename/extra lengths; the
            # member payload follows both
            ho = zi.header_offset
            fn_len, ex_len = struct.unpack_from("<HH", data, ho + 26)
            start = ho + 30 + fn_len + ex_len
            end = start + zi.file_size
            if end > len(data):
                raise ValueError("torn npz member")
            m = io.BytesIO(data[start:min(end, start + 256)])
            version = np.lib.format.read_magic(m)
            read_header = _NPY_HEADER_READERS.get(version)
            if read_header is None:
                return _unpack_chunk(data)
            shape, fortran, dtype = read_header(m)
            if dtype.hasobject or fortran:
                return _unpack_chunk(data)
            n = int(np.prod(shape, dtype=np.int64))
            if m.tell() + n * dtype.itemsize > zi.file_size:
                raise ValueError("torn npz member payload")
            a = np.frombuffer(data, dtype, n,
                              offset=start + m.tell()).reshape(shape)
            name = zi.filename
            if name.endswith(".npy"):
                name = name[:-4]
            if name.startswith("__valid__"):
                valid[name[len("__valid__"):]] = a
            else:
                cols[name] = a
    return cols, valid


def write_portion_blob(
    store: BlobStore,
    blob_id: str,
    columns: dict[str, np.ndarray],
    validity: dict[str, np.ndarray] | None = None,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    pk_column: str | None = None,
    stats: bool = True,
) -> None:
    """Serialize columns as a chunk-indexed blob.

    Layout: MAGIC | u64 header_len | header JSON | chunk payloads.
    Chunks are consecutive row slices; when ``pk_column`` is given (and
    rows are PK-sorted, which the shard guarantees) each chunk's header
    entry carries PK bounds so ranged scans can skip whole chunks
    (reader._chunk_in_range) without fetching them.

    With ``stats`` (v1 headers, the default) each chunk entry also
    carries per-column zone maps — ``{"zones": {col: [vmin, vmax,
    null_count]}}``, dtype-aware (ints, floats, scaled decimals,
    dict-encoded string ids) — computed vectorized at write time so
    scans can skip chunks that no conjunctive filter predicate can
    match (ydb_tpu_torch.stats.zonemap). ``stats=False`` writes v0 headers
    (the pre-stats format, still fully readable).
    """
    from ydb_tpu_torch.stats.zonemap import column_zones

    n = len(next(iter(columns.values()))) if columns else 0
    chunks = []
    payloads = []
    off = 0
    for lo in range(0, max(n, 1), chunk_rows):
        hi = min(lo + chunk_rows, n)
        if hi <= lo and n > 0:
            break
        data = _pack_chunk(columns, validity, lo, hi)
        entry = {"off": off, "len": len(data), "rows": hi - lo}
        if pk_column is not None and pk_column in columns and hi > lo:
            pk = columns[pk_column]
            if np.issubdtype(pk.dtype, np.integer):
                entry["pk_min"] = int(pk[lo])
                entry["pk_max"] = int(pk[hi - 1])
        if stats and hi > lo:
            entry["zones"] = column_zones(columns, validity, lo, hi)
        chunks.append(entry)
        payloads.append(data)
        off += len(data)
        if n == 0:
            break
    head: dict = {"chunks": chunks}
    if stats:
        head["version"] = HEADER_VERSION
    header = json.dumps(head).encode()
    blob = b"".join([PORTION_MAGIC, struct.pack("<Q", len(header)),
                     header] + payloads)
    store.put(blob_id, blob)


class PortionChunkReader:
    """Chunk-granular reader over one portion blob (ranged gets)."""

    def __init__(self, store: BlobStore, blob_id: str):
        self.store = store
        self.blob_id = blob_id
        def _head():
            h = store.get_range(blob_id, 0, 16)
            if h[:8] == PORTION_MAGIC and len(h) < 16:
                raise EOFError(f"short header read on {blob_id!r}")
            return h

        head = READ_RETRY.call(_head, site="blob.get_range",
                               retry_on=_TRANSIENT_READ)
        if head[:8] != PORTION_MAGIC:
            # legacy single-npz blob: treat as one chunk
            self._legacy = READ_RETRY.call(
                lambda: store.get(blob_id),
                site="blob.get", retry_on=_TRANSIENT_READ)
            self.chunks = [None]
            self._base = 0
            self.version = 0
            return
        self._legacy = None
        (hlen,) = struct.unpack("<Q", head[8:16])
        header = READ_RETRY.call(
            lambda: json.loads(
                store.get_range(blob_id, 16, hlen).decode()),
            site="blob.get_range", retry_on=_TRANSIENT_READ)
        self.chunks = header["chunks"]
        # v0 headers predate zone maps: absent "version" reads as 0 and
        # chunk entries simply have no "zones" (scans stay unpruned)
        self.version = header.get("version", 0)
        self._base = 16 + hlen

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def chunk_meta(self, i: int) -> dict:
        c = self.chunks[i]
        return {"rows": None, "pk_min": None, "pk_max": None} \
            if c is None else c

    def read_chunk(self, i: int, *,
                   zero_copy: bool = False) -> tuple[dict, dict]:
        """One chunk's (columns, validity). ``zero_copy`` decodes to
        read-only views into the fetched buffer (the morsel pipeline's
        decode discipline — see ``_unpack_chunk_view``); the default
        copies via ``np.load`` (the legacy serialized-path decode,
        kept bit-for-bit as the ``YDB_TPU_TORCH_STREAM_PIPELINE=0``
        reference)."""
        from ydb_tpu_torch.obs import timeline

        unpack = _unpack_chunk_view if zero_copy else _unpack_chunk

        # fetch + decode retried as ONE unit: a torn/short read fails in
        # the decode, and only re-fetching can heal it. A legacy blob was
        # fetched whole at open: a retry re-fetches it (the reference
        # decodes the same torn bytes again, so its retry cannot heal)
        retry = False

        def _fetch_decode():
            nonlocal retry
            if self._legacy is not None:
                if retry:
                    self._legacy = self.store.get(self.blob_id)
                retry = True
                data = self._legacy
            else:
                c = self.chunks[i]
                with timeline.event("blob.read", "blob.read",
                                    timeline.current_trace_id(),
                                    bytes=c["len"]):
                    data = self.store.get_range(
                        self.blob_id, self._base + c["off"], c["len"])
            timeline.add_bytes("blob_read_bytes", len(data))
            t0 = time.perf_counter()
            cols, valid = unpack(data)
            decoded = sum(a.nbytes for a in cols.values()) + sum(
                v.nbytes for v in valid.values())
            timeline.add_bytes("decoded_bytes", decoded)
            timeline.record("decode", "decode", t0, time.perf_counter(),
                            timeline.current_trace_id(), bytes=decoded)
            return cols, valid

        return READ_RETRY.call(_fetch_decode, site="blob.get_range",
                               retry_on=_TRANSIENT_READ)


def read_portion_blob(
    store: BlobStore, blob_id: str
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Whole-portion read: all chunks concatenated."""
    rd = PortionChunkReader(store, blob_id)
    parts = [rd.read_chunk(i) for i in range(rd.n_chunks)]
    if len(parts) == 1:
        return parts[0]
    cols = {n: np.concatenate([p[0][n] for p in parts])
            for n in parts[0][0]}
    valid_names = set()
    for p in parts:
        valid_names.update(p[1])
    valid = {}
    for n in valid_names:
        valid[n] = np.concatenate([
            p[1].get(n, np.ones(len(next(iter(p[0].values()))), dtype=bool))
            for p in parts
        ])
    return cols, valid


def column_stats(
    arr: np.ndarray, validity: np.ndarray | None = None,
) -> tuple:
    """Typed (min, max) of a column, dtype-aware.

    Ints (incl. dict ids, scaled decimals, dates) return ints; floats
    return floats (no silent ``int()`` truncation); NULL rows are
    excluded when ``validity`` is given. ``(None, None)`` for empty or
    unstatable input. Zone maps reuse this for every scan column —
    ydb_tpu_torch.stats.zonemap.zone_of carries the shared implementation.
    """
    from ydb_tpu_torch.stats.zonemap import zone_of

    vmin, vmax, _nulls = zone_of(arr, validity)
    return vmin, vmax


def project_chunk(
    schema,
    column_added: dict[str, int],
    meta: PortionMeta,
    names,
    cols_raw: dict[str, np.ndarray],
    valid_raw: dict[str, np.ndarray],
) -> tuple[dict, dict]:
    """Project raw chunk columns to ``names`` with schema-evolution nulls.

    The single home of the rule: a column only reads from portions at
    least as new as the schema version that (re)added it — DROP then ADD
    of the same name must not resurrect old bytes; older portions read
    the column as NULL.
    """
    n_rows = len(next(iter(cols_raw.values()))) if cols_raw else 0
    cols, valid = {}, {}
    for n in names:
        if n in cols_raw and meta.schema_version >= column_added.get(n, 1):
            cols[n] = cols_raw[n]
            valid[n] = valid_raw.get(
                n, np.ones(len(cols_raw[n]), dtype=bool))
        else:
            cols[n] = np.zeros(n_rows, dtype=schema.field(n).type.physical)
            valid[n] = np.zeros(n_rows, dtype=bool)
    return cols, valid
