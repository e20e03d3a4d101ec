"""Host-side string dictionaries (the port's copy of
``ydb_tpu/blocks/dictionary.py``).

Devices have no varlen byte strings; string columns live on device as int32
dictionary ids (SURVEY.md §7.2 hard part #1). The dictionary — id -> bytes —
stays on host and is consulted at *plan time*: string predicates (==, LIKE,
prefix) are evaluated once over the dictionary values producing a small
per-id mask/array that ships to the device as a kernel input, turning string
compute into an int gather. This mirrors how the reference's columnar engine
keeps Arrow dictionary arrays and evaluates kernels over them
(ydb/core/formats/arrow/custom_registry.cpp) — redesigned for the host/device split.

Id conventions:
  * ids are dense [0, len(values))
  * NULL is carried by the validity mask, not by a sentinel id
"""

from __future__ import annotations

import fnmatch
import re

import numpy as np


class Dictionary:
    """Append-only bytes <-> dense int32 id mapping for one column."""

    __slots__ = ("values", "_index")

    def __init__(self, values=()):
        self.values: list[bytes] = []
        self._index: dict[bytes, int] = {}
        for v in values:
            self.add(_as_bytes(v))

    def __len__(self) -> int:
        return len(self.values)

    def add(self, value) -> int:
        value = _as_bytes(value)
        idx = self._index.get(value)
        if idx is None:
            idx = len(self.values)
            self.values.append(value)
            self._index[value] = idx
        return idx

    def extend(self, values: list[bytes]) -> np.ndarray:
        """Append distinct byte strings none of which is present yet and
        return their ids: the ids ``add`` would give them one at a time,
        with one dict update instead of a probe each. Raises ValueError
        (and appends nothing) when a value repeats or is present."""
        start = len(self.values)
        new = dict(zip(values, range(start, start + len(values))))
        if len(new) != len(values) or not self._index.keys().isdisjoint(new):
            raise ValueError("extend takes distinct values not yet present")
        self.values.extend(values)
        self._index.update(new)
        return np.arange(start, start + len(values), dtype=np.int32)

    def get(self, value) -> int | None:
        return self._index.get(_as_bytes(value))

    def encode(self, values) -> np.ndarray:
        """Encode an iterable of str/bytes to int32 ids, adding new entries."""
        return np.fromiter(
            (self.add(v) for v in values), dtype=np.int32, count=len(values)
        )

    def decode(self, ids: np.ndarray) -> list[bytes]:
        vals = self.values
        return [vals[i] for i in np.asarray(ids)]

    # -- plan-time predicate evaluation (produces device-shippable arrays) --

    def eq_id(self, literal) -> int:
        """Id of literal, or -1 if absent (predicate is constant-false)."""
        idx = self.get(literal)
        return -1 if idx is None else idx

    def match_mask(self, predicate) -> np.ndarray:
        """bool[len(dict)] mask of ids whose value satisfies predicate(bytes)."""
        return np.fromiter(
            (bool(predicate(v)) for v in self.values),
            dtype=np.bool_, count=len(self.values),
        )

    def like_mask(self, pattern: str | bytes) -> np.ndarray:
        """SQL LIKE (%, _) evaluated over the dictionary."""
        pat = _as_bytes(pattern).decode("utf-8", "surrogateescape")
        rx = re.compile(
            "^" + re.escape(pat).replace("%", ".*").replace("_", ".") + "$",
            re.S,
        )
        return self.match_mask(
            lambda v: rx.match(v.decode("utf-8", "surrogateescape")) is not None
        )

    def prefix_mask(self, prefix) -> np.ndarray:
        p = _as_bytes(prefix)
        return self.match_mask(lambda v: v.startswith(p))

    def sort_rank(self) -> np.ndarray:
        """int32[len(dict)]: lexicographic rank of each id.

        Lets ORDER BY / min / max on a string column run on device as an int
        op over rank[id].
        """
        order = sorted(range(len(self.values)), key=lambda i: self.values[i])
        rank = np.empty(len(self.values), dtype=np.int32)
        for r, i in enumerate(order):
            rank[i] = r
        return rank

    def glob_mask(self, pattern: str) -> np.ndarray:
        return self.match_mask(
            lambda v: fnmatch.fnmatchcase(
                v.decode("utf-8", "surrogateescape"), pattern
            )
        )


def _as_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode("utf-8")
    return bytes(v)


class DictionarySet:
    """Dictionaries for all string columns of a table, keyed by column name."""

    def __init__(self):
        self._dicts: dict[str, Dictionary] = {}

    def for_column(self, name: str) -> Dictionary:
        d = self._dicts.get(name)
        if d is None:
            d = self._dicts[name] = Dictionary()
        return d

    def __contains__(self, name: str) -> bool:
        return name in self._dicts

    def __getitem__(self, name: str) -> Dictionary:
        return self._dicts[name]

    def columns(self):
        return self._dicts.keys()
