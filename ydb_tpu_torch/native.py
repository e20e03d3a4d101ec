"""Host-side row hashing for DQ shuffle routing.

The port's own copy of the numpy ``hash_rows`` of
``ydb_tpu/native/__init__.py``. The reference promises identical bits
from its C++ and numpy paths; this copy gives those bits too. The hash
decides which join task receives which rows, and with that the row
order of results without ``ORDER BY`` and the summation order of float
aggregates, so it must not drift.

It stays on the host, where the channel payloads are: torch's ``>>`` on
int64 is arithmetic, not logical, and uint64 shifts and multiplies are
only partly supported on CUDA. The reference's C++ host library is not
ported.
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
