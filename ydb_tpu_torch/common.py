"""Small shared helpers used across planes.

The port's own copy of ``ydb_tpu/common.py``: the same bits, so a key
routes to the same topic partition in either package.
"""

from __future__ import annotations


def fnv1a_64(s: str | bytes) -> int:
    """FNV-1a 64-bit — the shared string hash for blob->disk rotation
    and topic key->partition routing (one implementation so conventions
    never diverge)."""
    h = 1469598103934665603
    for b in (s.encode() if isinstance(s, str) else s):
        h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h
