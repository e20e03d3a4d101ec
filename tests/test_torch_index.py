"""The port's global secondary indexes (``RowTable.add_index`` and its
maintenance in the same commit as the data) against the reference's:
the 4 cases of ``tests/test_index.py``.

Each case runs through both packages and makes the reference test's
assertions on each; the index lookups, the index shards' rows and the
errors must be equal between the two. Tolerance: none."""

import types

import numpy as np
import pytest

from ydb_tpu import dtypes as rdt
from ydb_tpu.datashard.table import RowTable as RRowTable
from ydb_tpu.engine.blobs import MemBlobStore as RStore
from ydb_tpu.tx.coordinator import Coordinator as RCoord

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch.datashard.table import RowTable as TRowTable
from ydb_tpu_torch.engine.blobs import MemBlobStore as TStore
from ydb_tpu_torch.tx.coordinator import Coordinator as TCoord


def _ns(dt, RowTable, Store, Coord):
    return types.SimpleNamespace(
        RowTable=RowTable, MemBlobStore=Store, Coordinator=Coord,
        SCHEMA=dt.schema(("id", dt.INT64, False), ("city", dt.STRING),
                         ("v", dt.INT64)))


PORT = _ns(tdt, TRowTable, TStore, TCoord)
REF = _ns(rdt, RRowTable, RStore, RCoord)


def both(case):
    got = case(PORT)
    assert got == case(REF)


def _table(P):
    t = P.RowTable("users", P.SCHEMA, P.MemBlobStore(),
                   P.Coordinator(P.MemBlobStore()), n_shards=3,
                   pk_columns=("id",))
    t.insert({"id": np.arange(6, dtype=np.int64),
              "city": [b"ams", b"ber", b"ams", b"cdg", b"ber", b"ams"],
              "v": np.arange(6, dtype=np.int64) * 10})
    return t


def index_rows(t, name):
    snap = t.coordinator.read_snapshot()
    return [[r for page in s.read(snap) for r in page]
            for s in t.indexes[name][1]]


def test_backfill_and_lookup():
    def case(P):
        t = _table(P)
        t.add_index("by_city", "city")
        got = [sorted(t.lookup_index("by_city", c))
               for c in (b"ams", b"ber", b"nope")]
        assert got == [[(0,), (2,), (5,)], [(1,), (4,)], []]
        return got + [index_rows(t, "by_city"), t.storage_prefixes()]
    both(case)


def test_index_maintained_by_writes():
    def case(P):
        t = _table(P)
        t.add_index("by_city", "city")
        t.insert({"id": np.array([9], dtype=np.int64), "city": [b"cdg"],
                  "v": np.array([90], dtype=np.int64)})
        obs = [sorted(t.lookup_index("by_city", b"cdg"))]
        assert obs[-1] == [(3,), (9,)]
        t.insert({"id": np.array([0], dtype=np.int64), "city": [b"cdg"],
                  "v": np.array([0], dtype=np.int64)})
        obs += [sorted(t.lookup_index("by_city", b"ams")),
                sorted(t.lookup_index("by_city", b"cdg"))]
        assert obs[-2:] == [[(2,), (5,)], [(0,), (3,), (9,)]]
        t.delete_keys([(9,)])
        obs.append(sorted(t.lookup_index("by_city", b"cdg")))
        assert obs[-1] == [(0,), (3,)]
        return obs + [index_rows(t, "by_city")]
    both(case)


def test_same_key_twice_in_one_batch_keeps_index_consistent():
    def case(P):
        t = _table(P)
        t.add_index("by_city", "city")
        t.upsert_rows([
            {"id": 0, "city": t.dicts.for_column("city").add(b"ber"),
             "v": 1},
            {"id": 0, "city": t.dicts.for_column("city").add(b"cdg"),
             "v": 2},
        ])
        got = [t.lookup_index("by_city", c)
               for c in (b"ams", b"ber", b"cdg")]
        assert (0,) not in got[0] and (0,) not in got[1]
        assert (0,) in got[2]
        return [sorted(g) for g in got] + [index_rows(t, "by_city")]
    both(case)


def test_index_guards():
    def case(P):
        t = _table(P)
        errs = []
        with pytest.raises(ValueError) as e:
            t.add_index("bad", "id")  # already the PK
        errs.append(str(e.value))
        t.add_index("by_city", "city")
        with pytest.raises(ValueError) as e:
            t.add_index("by_city", "v")  # duplicate name
        errs.append(str(e.value))
        return errs
    both(case)
