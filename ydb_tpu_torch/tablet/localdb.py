"""In-tablet sorted KV store with MVCC row versions.

Mirror of the reference's NTable local database (flat_database.h:41;
SURVEY.md §2.4): every tablet persists its state through one of these —
named tables of sorted rows, where each key holds a list of versioned
values so reads at an older snapshot still see the old row. The reference
keeps a memtable plus immutable B-tree parts; at the scale of host
control-plane state (schemas, tx queues, offsets — not user data) a
single sorted dict per table with explicit version chains carries the
same semantics, and ``freeze_part``/``compact`` keep the memtable/part
shape for the OLTP datashard built on top.

Rows are dict[str, value]; keys are tuples (the primary key columns).
Versions are monotonically increasing integers supplied by the executor
(the tablet's commit counter — the analog of the redo-log step).

The port's own copy of ``ydb_tpu/tablet/localdb.py`` (no device code).
Its scans tag each frozen part's stream with that part's own priority;
the reference's generator expressions all read the last part's, so with
two or more parts a key's older chain can merge ahead of its newer one
and an erased or overwritten row comes back (ROADMAP.md queue C).
"""

from __future__ import annotations

import bisect
import heapq
from typing import Any, Iterator


TOMBSTONE = object()


class _Part:
    """Immutable sorted run (the flat_part shape, flat_part_*.h): keys
    split into fixed-size PAGES with a first-key page index searched
    like a two-level B-tree, plus a BLOOM FILTER over key hashes so
    point reads skip parts that cannot hold the key. Built by
    TableStore.freeze_part from the memtable; merged away by
    compact()."""

    PAGE_ROWS = 64

    def __init__(self, items: list):
        # items: [(key, chain)] in key order; chains newest-first
        self.pages = [items[i:i + self.PAGE_ROWS]
                      for i in range(0, len(items), self.PAGE_ROWS)]
        self.index = [page[0][0] for page in self.pages]
        # bloom: ~10 bits/key, 3 hash probes (classic FP ~1%); a
        # bytearray keeps each probe O(1) (a Python big-int shift
        # would copy the whole filter per probe)
        self._m = max(64, len(items) * 10)
        bits = bytearray((self._m + 7) // 8)
        for key, _chain in items:
            for probe in self._probes(key):
                bits[probe >> 3] |= 1 << (probe & 7)
        self._bits = bits
        self.bloom_negatives = 0  # observability: point reads skipped

    def _probes(self, key: tuple):
        h = hash(key)
        for salt in (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
                     0x165667B19E3779F9):
            yield (h ^ salt) % self._m

    def may_contain(self, key: tuple) -> bool:
        return all(self._bits[p >> 3] & (1 << (p & 7))
                   for p in self._probes(key))

    def get_chain(self, key: tuple) -> list | None:
        if not self.pages:
            return None
        if not self.may_contain(key):
            self.bloom_negatives += 1
            return None
        pi = bisect.bisect_right(self.index, key) - 1
        if pi < 0:
            return None
        for k, chain in self.pages[pi]:
            if k == key:
                return chain
            if k > key:
                break
        return None

    def iter_items(self, lo: tuple | None, hi: tuple | None):
        start = 0
        if lo is not None:
            start = max(bisect.bisect_right(self.index, lo) - 1, 0)
        for page in self.pages[start:]:
            for k, chain in page:
                if lo is not None and k < lo:
                    continue
                if hi is not None and k >= hi:
                    return
                yield k, chain


class TableStore:
    """One table: a MEMTABLE of sorted keys with version chains plus
    immutable frozen PARTS (page-indexed, bloom-filtered — the
    memtable/flat-part split of the reference's NTable). Writes land in
    the memtable; ``memtable_limit`` keys auto-freeze it into a part
    (the compaction strategy trigger); ``compact`` merges parts away
    under the version horizon. Version order across sources is
    guaranteed by the monotonic commit counter: memtable versions are
    newer than any part's, parts are newest-first."""

    def __init__(self, name: str, memtable_limit: int = 4096):
        self.name = name
        self.memtable_limit = memtable_limit
        self._keys: list[tuple] = []  # sorted (memtable)
        self._chains: dict[tuple, list[tuple[int, Any]]] = {}
        self._parts: list[_Part] = []  # newest first

    def put(self, key: tuple, row: dict | None, version: int) -> None:
        """row=None erases (writes a tombstone version)."""
        chain = self._chains.get(key)
        if chain is None:
            idx = bisect.bisect_left(self._keys, key)
            self._keys.insert(idx, key)
            chain = []
            self._chains[key] = chain
        value = TOMBSTONE if row is None else dict(row)
        chain.insert(0, (version, value))
        if len(self._keys) >= self.memtable_limit:
            self.freeze_part()

    def freeze_part(self) -> None:
        """Memtable -> immutable part (newest). No-op when empty."""
        if not self._keys:
            return
        items = [(k, self._chains[k]) for k in self._keys]
        self._parts.insert(0, _Part(items))
        self._keys = []
        self._chains = {}

    def _full_chain(self, key: tuple) -> list:
        """Version chain across memtable + parts, newest first."""
        chain = list(self._chains.get(key) or ())
        for part in self._parts:
            pc = part.get_chain(key)
            if pc:
                chain.extend(pc)
        return chain

    def get(self, key: tuple, version: int | None = None) -> dict | None:
        for ver, value in self._full_chain(key):
            if version is None or ver <= version:
                return None if value is TOMBSTONE else value
        return None

    def _iter_merged(self, lo: tuple | None, hi: tuple | None):
        """(key, merged chain) in key order across memtable + parts:
        ONE heap pass that carries the chains (no per-key re-probing
        of every part — scans stay O(keys) regardless of part count).
        Stream priority (memtable=0, parts newest-first) preserves
        version-descending chain order on concat."""
        def mem():
            start = (0 if lo is None
                     else bisect.bisect_left(self._keys, lo))
            for i in range(start, len(self._keys)):
                k = self._keys[i]
                if hi is not None and k >= hi:
                    return
                yield k, 0, self._chains[k]

        def part(p, pri):
            for k, c in p.iter_items(lo, hi):
                yield k, pri, c

        streams = [mem()] + [part(p, pi + 1)
                             for pi, p in enumerate(self._parts)]
        cur_key = None
        cur_chain: list = []
        for k, _pri, chain in heapq.merge(*streams):
            if k != cur_key:
                if cur_key is not None:
                    yield cur_key, cur_chain
                cur_key, cur_chain = k, list(chain)
            else:
                cur_chain.extend(chain)
        if cur_key is not None:
            yield cur_key, cur_chain

    @staticmethod
    def _visible(chain: list, version: int | None):
        for ver, value in chain:
            if version is None or ver <= version:
                return None if value is TOMBSTONE else value
        return None

    def range(self, lo: tuple | None = None, hi: tuple | None = None,
              version: int | None = None,
              ) -> Iterator[tuple[tuple, dict]]:
        """Yield (key, row) in key order for lo <= key < hi at version."""
        for key, chain in self._iter_merged(lo, hi):
            row = self._visible(chain, version)
            if row is not None:
                yield key, row

    @property
    def n_parts(self) -> int:
        return len(self._parts)

    def bloom_negatives(self) -> int:
        return sum(p.bloom_negatives for p in self._parts)

    def compact(self, keep_after: int) -> None:
        """Merge every part back through the memtable and drop versions
        shadowed by a newer one at or below keep_after (no snapshot
        older than keep_after can still read them)."""
        # fold parts into merged chains (memtable newest, parts next)
        if self._parts:
            merged = {k: c for k, c in self._iter_merged(None, None)}
            self._keys = sorted(merged)
            self._chains = merged
            self._parts = []
        dead_keys = []
        for key, chain in self._chains.items():
            kept = []
            shadowed = False
            for ver, value in chain:
                if shadowed:
                    break
                kept.append((ver, value))
                if ver <= keep_after:
                    shadowed = True  # everything older is invisible
            # a sole tombstone older than the horizon is gone entirely
            if len(kept) == 1 and kept[0][1] is TOMBSTONE and \
                    kept[0][0] <= keep_after:
                dead_keys.append(key)
            else:
                self._chains[key] = kept
        for key in dead_keys:
            del self._chains[key]
            idx = bisect.bisect_left(self._keys, key)
            if idx < len(self._keys) and self._keys[idx] == key:
                self._keys.pop(idx)

    # ---- snapshot (de)serialization ----

    def dump(self) -> list:
        out = []
        for key, full in self._iter_merged(None, None):
            chain = [[ver, None if v is TOMBSTONE else v]
                     for ver, v in full]
            out.append([list(key), chain])
        return out

    @classmethod
    def load(cls, name: str, data: list,
             memtable_limit: int = 4096) -> "TableStore":
        t = cls(name, memtable_limit=memtable_limit)
        for key_list, chain in data:
            key = tuple(key_list)
            t._keys.append(key)
            t._chains[key] = [
                (ver, TOMBSTONE if v is None else v) for ver, v in chain
            ]
        if len(t._keys) >= t.memtable_limit:
            t.freeze_part()  # keep the freeze cadence across reloads
        return t


class LocalDb:
    def __init__(self):
        self.tables: dict[str, TableStore] = {}

    def table(self, name: str) -> TableStore:
        t = self.tables.get(name)
        if t is None:
            t = self.tables[name] = TableStore(name)
        return t

    def apply(self, changes: list[tuple], version: int) -> None:
        """changes: [(table, key, row_or_None[, explicit_version]), ...]

        The optional 4th element overrides the commit version — used by
        tablets whose row visibility follows the global plan-step clock
        (DataShard MVCC) rather than the tablet's own commit counter.
        """
        for ch in changes:
            table, key, row = ch[0], ch[1], ch[2]
            ver = ch[3] if len(ch) > 3 else version
            self.table(table).put(tuple(key), row, ver)

    def dump(self) -> dict:
        return {name: t.dump() for name, t in self.tables.items()}

    @classmethod
    def load(cls, data: dict) -> "LocalDb":
        db = cls()
        for name, tdata in data.items():
            db.tables[name] = TableStore.load(name, tdata)
        return db
