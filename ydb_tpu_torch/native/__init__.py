"""Native host kernels with exact numpy twins: the row hash of DQ
shuffle routing, the K-way merge of the ColumnShard reader, and bloom
filters over u64 hashes.

The port's own copy of ``ydb_tpu/native/__init__.py``. Each entry point
runs the C++ library (``src/ydbtpu_native.cpp``, built with ``g++`` at
first use by ``build.py`` and loaded with ctypes) and falls back to its
numpy twin, which gives the same bits, when the library cannot be built;
``YDB_TPU_TORCH_NO_NATIVE=1`` forces the twins (the tests compare both).
The hash decides which join task receives which rows, and with that the
row order of results without ``ORDER BY`` and the summation order of
float aggregates, so neither path may drift from the reference's.

Everything here stays on the host, where the channel payloads are. The
device twin of ``hash_rows`` for the mesh shuffle is
``ydb_tpu_torch.parallel.shuffle.hash_rows``: the same bits again.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ydb_tpu_torch.native.build import ensure_built

_lib = None
_load_lock = threading.Lock()

_I64P = ctypes.POINTER(ctypes.c_int64)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _declare(lib) -> None:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.ydbtpu_hash_rows.argtypes = [ctypes.POINTER(_I64P),
                                     ctypes.POINTER(_U8P), i32, i64, _U64P]
    lib.ydbtpu_hash_rows.restype = None
    lib.ydbtpu_kway_merge.argtypes = [ctypes.POINTER(_I64P), _I64P, i32,
                                      i32, _I32P, _I64P]
    lib.ydbtpu_kway_merge.restype = i64
    lib.ydbtpu_bloom_build.argtypes = [_U64P, i64, _U8P, i64, i32]
    lib.ydbtpu_bloom_build.restype = None
    lib.ydbtpu_bloom_query.argtypes = [_U64P, i64, _U8P, i64, i32, _U8P]
    lib.ydbtpu_bloom_query.restype = None


def _load():
    # the first call can come from any conveyor worker (shuffle hashing,
    # the reader's K-way merge): double-checked so concurrent first uses
    # build and dlopen once
    global _lib
    if _lib is not None:
        return _lib if _lib is not False else None
    with _load_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        path = ensure_built()
        if path is None:
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(path)
            _declare(lib)
        except (OSError, AttributeError):
            _lib = False
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ library is built and loaded."""
    return _load() is not None


def _pp(arrs, ptype):
    """List of contiguous arrays -> C array of pointers (the arrays must
    outlive the call: the caller keeps them in a local)."""
    ptrs = (ptype * len(arrs))()
    for i, a in enumerate(arrs):
        ptrs[i] = a.ctypes.data_as(ptype)
    return ptrs


# ---- row hashing ----


def hash_rows(keys: list[np.ndarray],
              valids: list[np.ndarray]) -> np.ndarray:
    """Shuffle-routing row hash over int64 key columns (+ validity bit):
    a splitmix64 finalizer folded over the key columns, the same bits
    from the C++ and the numpy path (partition routing must agree across
    processes with and without the toolchain)."""
    n = len(keys[0]) if keys else 0
    lib = _load()
    if lib is not None and n > 0:
        ks = [np.ascontiguousarray(k, dtype=np.int64) for k in keys]
        vs = [np.ascontiguousarray(v, dtype=np.uint8) for v in valids]
        out = np.empty(n, dtype=np.uint64)
        lib.ydbtpu_hash_rows(_pp(ks, _I64P), _pp(vs, _U8P), len(ks), n,
                             out.ctypes.data_as(_U64P))
        return out
    # the numpy twin: ``h ^ (key ^ valid << 63)`` then three shift-xor /
    # multiply rounds per column, computed in place in two buffers
    h = np.full(n, 0x9E3779B97F4A7C15, dtype=np.uint64)
    t = np.empty(n, dtype=np.uint64)
    for kv, ok in zip(keys, valids):
        np.bitwise_xor(h, np.asarray(kv, dtype=np.int64).view(np.uint64),
                       out=h)
        np.left_shift(np.asarray(ok, dtype=np.uint64), np.uint64(63),
                      out=t)
        np.bitwise_xor(h, t, out=h)
        for shift, mult in ((30, 0xBF58476D1CE4E5B9),
                            (27, 0x94D049BB133111EB)):
            np.right_shift(h, np.uint64(shift), out=t)
            np.bitwise_xor(h, t, out=h)
            np.multiply(h, np.uint64(mult), out=h)
        np.right_shift(h, np.uint64(31), out=t)
        np.bitwise_xor(h, t, out=h)
    return h


# ---- K-way merge ----


def kway_merge(runs: list[np.ndarray], dedup: bool = False):
    """Merge sorted int64 runs into global key order.

    Returns (run_idx int32[n], row_idx int64[n]). Stable across runs;
    with dedup=True equal keys collapse to the highest run index
    (runs ordered oldest -> newest = newest-wins MVCC dedup,
    merge.cpp/NArrow::NMerger analog).
    """
    total = int(sum(len(r) for r in runs))
    lib = _load()
    if lib is not None:
        rs = [np.ascontiguousarray(r, dtype=np.int64) for r in runs]
        lens = np.asarray([len(r) for r in rs], dtype=np.int64)
        out_run = np.empty(total, dtype=np.int32)
        out_idx = np.empty(total, dtype=np.int64)
        n = lib.ydbtpu_kway_merge(
            _pp(rs, _I64P), lens.ctypes.data_as(_I64P), len(rs),
            1 if dedup else 0, out_run.ctypes.data_as(_I32P),
            out_idx.ctypes.data_as(_I64P))
        return out_run[:n], out_idx[:n]
    keys = np.concatenate([np.asarray(r, dtype=np.int64) for r in runs]) \
        if runs else np.empty(0, dtype=np.int64)
    run_of = np.concatenate([
        np.full(len(r), i, dtype=np.int32) for i, r in enumerate(runs)
    ]) if runs else np.empty(0, dtype=np.int32)
    idx_of = np.concatenate([
        np.arange(len(r), dtype=np.int64) for r in runs
    ]) if runs else np.empty(0, dtype=np.int64)
    # stable sort of (key, run), then optional last-duplicate keep
    order = np.lexsort((run_of, keys))
    keys, run_of, idx_of = keys[order], run_of[order], idx_of[order]
    if dedup and len(keys):
        # keep the LAST of each equal-key group
        last = np.r_[keys[1:] != keys[:-1], True]
        run_of, idx_of = run_of[last], idx_of[last]
    return run_of, idx_of


# ---- bloom filter ----


class BloomFilter:
    """Bloom filter over u64 hashes (part/portion pruning analog):
    ``nprobes`` probes by double hashing, the same bits from both
    paths."""

    def __init__(self, nbits: int, nprobes: int = 4,
                 bits: np.ndarray | None = None):
        self.nbits = int(nbits)
        self.nprobes = int(nprobes)
        self.bits = (bits if bits is not None else
                     np.zeros((self.nbits + 7) // 8, dtype=np.uint8))

    @staticmethod
    def for_items(n_items: int, bits_per_item: int = 10) -> "BloomFilter":
        return BloomFilter(max(64, n_items * bits_per_item))

    def add(self, hashes: np.ndarray) -> None:
        h = np.ascontiguousarray(hashes, dtype=np.uint64)
        lib = _load()
        if lib is not None:
            lib.ydbtpu_bloom_build(h.ctypes.data_as(_U64P), len(h),
                                   self.bits.ctypes.data_as(_U8P),
                                   self.nbits, self.nprobes)
            return
        h2 = _mix64(h) | np.uint64(1)
        for p in range(self.nprobes):
            bit = (h + np.uint64(p) * h2) % np.uint64(self.nbits)
            np.bitwise_or.at(
                self.bits, (bit >> np.uint64(3)).astype(np.int64),
                (np.uint8(1) << (bit & np.uint64(7)).astype(np.uint8)))

    def query(self, hashes: np.ndarray) -> np.ndarray:
        h = np.ascontiguousarray(hashes, dtype=np.uint64)
        lib = _load()
        if lib is not None:
            out = np.empty(len(h), dtype=np.uint8)
            lib.ydbtpu_bloom_query(h.ctypes.data_as(_U64P), len(h),
                                   self.bits.ctypes.data_as(_U8P),
                                   self.nbits, self.nprobes,
                                   out.ctypes.data_as(_U8P))
            return out.astype(bool)
        h2 = _mix64(h) | np.uint64(1)
        hit = np.ones(len(h), dtype=bool)
        for p in range(self.nprobes):
            bit = (h + np.uint64(p) * h2) % np.uint64(self.nbits)
            byte = self.bits[(bit >> np.uint64(3)).astype(np.int64)]
            hit &= ((byte >> (bit & np.uint64(7)).astype(np.uint8))
                    & np.uint8(1)).astype(bool)
        return hit


def _mix64(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xC4CEB9FE1A85EC53)
    return x ^ (x >> np.uint64(33))
