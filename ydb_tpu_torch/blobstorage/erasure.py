"""Erasure codecs for blob groups.

Mirror of the reference's erasure species (TErasureType
ydb/core/erasure/erasure.h:252-275; SURVEY.md §2.3): a blob is split
into parts placed on the disks of a group; reads reconstruct from any
quorum of surviving parts.

  * ``none``      — 1 part, no redundancy
  * ``mirror3``   — 3 full replicas (mirror-3dc shape without the DC
                    topology; any 1 of 3 parts restores)
  * ``block42``   — 4 data + 2 parity (the reference's default
                    block-4-2): parity P = XOR of data parts, parity Q =
                    GF(256) weighted sum (RAID-6 construction), so ANY
                    two lost parts are recoverable

Parts carry the original length so padding strips on decode. All the
math is vectorized numpy over uint8 — host-side storage plane, never
the device.

The port's own copy of ``ydb_tpu/blobstorage/erasure.py``: the same
GF(256) field and part layout, so parts are byte for byte the
reference's for every species. Some steps take another road to the
same bytes: a GF(256) product by a constant is a table lookup, two bytes
at a time (the reference masks the zero bytes and goes through the log
and exp tables), a decode reads the surviving parts in place, and a
block-4-2 decode whose four data parts all survived joins them.
"""

from __future__ import annotations

import threading

import numpy as np

# ---- GF(256) tables (polynomial 0x11D, generator 2) ----

_EXP = np.zeros(512, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
_EXP[255:510] = _EXP[:255]
#: _MUL[c, a] = c * a in GF(256)
_MUL = np.zeros((256, 256), dtype=np.uint8)
_MUL[1:, 1:] = _EXP[_LOG[1:, None] + _LOG[None, 1:]]
#: c -> the products of c with both bytes of every uint16, built at a
#: constant's first use (128 KiB each; a codec uses a few constants)
_MUL16: dict[int, np.ndarray] = {}
_MUL16_LOCK = threading.Lock()
_PAIRS = np.arange(1 << 16)


def _gf_mul_vec(a: np.ndarray, c: int) -> np.ndarray:
    """Multiply a uint8 vector by constant c in GF(256)."""
    table = _MUL16.get(c)
    if table is None:
        row = _MUL[c].astype(np.uint16)
        with _MUL16_LOCK:
            table = _MUL16.setdefault(c, row[_PAIRS & 255]
                                      | (row[_PAIRS >> 8] << 8))
    even = len(a) & ~1
    out = np.empty_like(a)
    out[:even].view(np.uint16)[:] = table.take(a[:even].view(np.uint16))
    out[even:] = _MUL[c].take(a[even:])
    return out


def _gf_div(a: int, b: int) -> int:
    if a == 0:
        return 0
    return int(_EXP[(int(_LOG[a]) - int(_LOG[b])) % 255])


class ErasureCodec:
    SPECIES = ("none", "mirror3", "block42")

    def __init__(self, species: str = "block42"):
        if species not in self.SPECIES:
            raise ValueError(f"unknown erasure species {species}")
        self.species = species

    @property
    def total_parts(self) -> int:
        return {"none": 1, "mirror3": 3, "block42": 6}[self.species]

    @property
    def data_parts(self) -> int:
        return {"none": 1, "mirror3": 1, "block42": 4}[self.species]

    @property
    def max_lost(self) -> int:
        """Parts that may be lost with full recovery still possible."""
        return {"none": 0, "mirror3": 2, "block42": 2}[self.species]

    # ---- encode ----

    def encode(self, data: bytes) -> list[bytes]:
        if self.species == "none":
            return [data]
        if self.species == "mirror3":
            return [data, data, data]
        # block42
        n = len(data)
        k = self.data_parts
        plen = (n + k - 1) // k if n else 1
        buf = np.zeros(k * plen, dtype=np.uint8)
        buf[:n] = np.frombuffer(data, dtype=np.uint8)
        d = buf.reshape(k, plen)
        p = d[0] ^ d[1] ^ d[2] ^ d[3]
        q = np.zeros(plen, dtype=np.uint8)
        for i in range(k):
            q ^= _gf_mul_vec(d[i], int(_EXP[i]))  # weights g^i
        return [d[i].tobytes() for i in range(k)] + [p.tobytes(),
                                                     q.tobytes()]

    # ---- decode ----

    def decode(self, parts: dict[int, bytes], orig_len: int) -> bytes:
        """parts: part index -> bytes for the SURVIVING parts."""
        if self.species == "none":
            return parts[0][:orig_len]
        if self.species == "mirror3":
            return next(iter(parts.values()))[:orig_len]
        return self._decode_block42(parts, orig_len)

    def _decode_block42(self, parts: dict[int, bytes],
                        orig_len: int) -> bytes:
        k = self.data_parts
        missing = [i for i in range(k) if i not in parts]
        if len([i for i in range(6) if i in parts]) < k:
            raise ValueError("too many parts lost to reconstruct")
        if not missing:
            return b"".join(parts[i] for i in range(k))[:orig_len]
        plen = len(next(iter(parts.values())))
        d = {i: np.frombuffer(parts[i], dtype=np.uint8) for i in parts}
        if len(missing) == 1:
            m = missing[0]
            if 4 in d:  # rebuild from P (XOR)
                acc = d[4].copy()
                for i in range(k):
                    if i != m:
                        acc ^= d[i]
                d[m] = acc
            else:       # rebuild from Q
                acc = d[5].copy()
                for i in range(k):
                    if i != m:
                        acc ^= _gf_mul_vec(d[i], int(_EXP[i]))
                d[m] = _gf_mul_vec(acc, _gf_inv(int(_EXP[m])))
        elif len(missing) == 2:
            a, b = missing  # need both P and Q
            p_acc = d[4].copy()
            q_acc = d[5].copy()
            for i in range(k):
                if i not in missing:
                    p_acc ^= d[i]
                    q_acc ^= _gf_mul_vec(d[i], int(_EXP[i]))
            # p_acc = Da ^ Db ; q_acc = ga*Da ^ gb*Db  (RAID-6 solve)
            ga, gb = int(_EXP[a]), int(_EXP[b])
            denom = ga ^ gb
            da = _gf_mul_vec(q_acc ^ _gf_mul_vec(p_acc, gb),
                             _gf_inv(denom))
            d[a] = da
            d[b] = p_acc ^ da
        return b"".join(memoryview(d[i])[:max(0, orig_len - i * plen)]
                        for i in range(k))

    def reconstruct_part(self, parts: dict[int, bytes], idx: int,
                         orig_len: int) -> bytes:
        """Rebuild one part (self-heal/replication path)."""
        if self.species == "none":
            raise ValueError("no redundancy to rebuild from")
        if self.species == "mirror3":
            return next(iter(parts.values()))
        data = self.decode(parts, orig_len)
        return self.encode(data)[idx]


def _gf_inv(c: int) -> int:
    return _gf_div(1, c)
