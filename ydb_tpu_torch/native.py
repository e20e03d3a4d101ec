"""Host-side row hashing for DQ shuffle routing, and the K-way merge of
the ColumnShard reader.

The port's own copy of the numpy ``hash_rows`` and ``kway_merge`` of
``ydb_tpu/native/__init__.py``. The reference promises identical bits
from its C++ and numpy paths; this copy gives those bits too. The hash
decides which join task receives which rows, and with that the row
order of results without ``ORDER BY`` and the summation order of float
aggregates, so it must not drift.

It stays on the host, where the channel payloads are: torch's ``>>`` on
int64 is arithmetic, not logical, and uint64 shifts and multiplies are
only partly supported on CUDA. ``kway_merge`` is the reference's numpy
twin of its C++ merge, which the reference promises gives the same
``(run_idx, row_idx)``. The reference's C++ host library is not ported.
"""

from __future__ import annotations

import numpy as np


def hash_rows(keys: list[np.ndarray],
              valids: list[np.ndarray]) -> np.ndarray:
    """Shuffle-routing row hash over int64 key columns (+ validity bit):
    a splitmix64 finalizer folded over the key columns. The same bits as
    the reference's ``h ^ (key ^ valid << 63)`` then three shift-xor /
    multiply rounds per column, computed in place in two buffers."""
    n = len(keys[0]) if keys else 0
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


def kway_merge(runs: list[np.ndarray], dedup: bool = False):
    """Merge sorted int64 runs into global key order.

    Returns (run_idx int32[n], row_idx int64[n]). Stable across runs;
    with dedup=True equal keys collapse to the highest run index
    (runs ordered oldest -> newest = newest-wins MVCC dedup,
    merge.cpp/NArrow::NMerger analog).
    """
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
