"""The port's Arrow bridge (``ydb_tpu_torch/blocks/arrow_bridge.py``) and
Arrow IPC result sets (``ydb_tpu_torch/api/arrow_io.py``) against the
reference's.

Mirrors the two Arrow cases of ``tests/test_blocks.py``, each through
both packages on the same batches: the same schema, the same physical
values, validity and dictionary ids, and the same batch back. More
cases: ``oracle_to_ipc`` writes the same IPC bytes as the reference's for
one ``OracleTable`` with every result type (ints, float, bool, string,
decimal, date, timestamp, with NULLs), and ``ipc_to_table`` reads them
back; a block is staged on the device the caller names, and without one
on CUDA (which raises here, where there is none); the BulkUpsert
conversion (``server._arrow_to_insert``) gives the reference's columns.
Tolerance: none."""

import datetime
import decimal as pydec

import numpy as np
import pyarrow as pa
import pytest
import torch

from ydb_tpu import dtypes as rdt
from ydb_tpu.blocks import DictionarySet as RDictionarySet
from ydb_tpu.blocks import arrow_bridge as rbridge
from ydb_tpu.engine.oracle import OracleTable as ROracleTable
from ydb_tpu.api import arrow_io as rarrow_io

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks import DictionarySet
from ydb_tpu_torch.blocks import arrow_bridge
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.api import arrow_io

#: (label, bridge module, DictionarySet, device kwargs)
KITS = (("ref", rbridge, RDictionarySet, {}),
        ("port", arrow_bridge, DictionarySet, {"device": "cpu"}))


def _mixed_batch():
    return pa.record_batch({
        "k": pa.array([1, 2, None, 4], type=pa.int64()),
        "s": pa.array(["x", None, "y", "x"], type=pa.string()),
        "d": pa.array(
            [pydec.Decimal("1.25"), pydec.Decimal("-2.50"), None,
             pydec.Decimal("0.01")],
            type=pa.decimal128(12, 2),
        ),
    })


def _fields(schema):
    return [(f.name, f.type.kind.value, f.type.scale, f.nullable)
            for f in schema.fields]


def test_arrow_roundtrip_with_nulls_strings_decimals():
    batch = _mixed_batch()
    got = {}
    for label, br, dset, kw in KITS:
        sch = br.schema_from_arrow(batch.schema)
        assert sch.field("s").type.is_string
        assert sch.field("d").type.scale == 2
        dicts = dset()
        blk = br.record_batch_to_block(batch, dicts, **kw)
        data = blk.to_numpy()
        valid = blk.validity_numpy()
        np.testing.assert_array_equal(valid["k"], [True, True, False, True])
        np.testing.assert_array_equal(data["d"], [125, -250, 0, 1])
        # same string -> same id
        assert data["s"][0] == data["s"][3]
        back = br.block_to_record_batch(blk, dicts)
        assert back.column("k").to_pylist() == [1, 2, None, 4]
        assert back.column("s").to_pylist() == [b"x", None, b"y", b"x"]
        assert [str(x) if x is not None else None
                for x in back.column("d").to_pylist()] == [
            "1.25", "-2.50", None, "0.01"]
        got[label] = (_fields(sch),
                      {k: (np.asarray(v).tolist(), valid[k].tolist())
                       for k, v in data.items()},
                      list(dicts["s"].values), back)
    ref, port = got["ref"], got["port"]
    assert ref[:3] == port[:3]
    assert ref[3].equals(port[3])


def test_arrow_dictionary_array_remap():
    b1 = pa.record_batch({"s": pa.array(["b", "a"]).dictionary_encode()})
    b2 = pa.record_batch({"s": pa.array(["a", "c"]).dictionary_encode()})
    got = {}
    for label, br, dset, kw in KITS:
        dicts = dset()
        sch = br.schema_from_arrow(b1.schema)
        blk1 = br.record_batch_to_block(b1, dicts, sch, **kw)
        blk2 = br.record_batch_to_block(b2, dicts, sch, **kw)
        d = dicts["s"]
        assert d.decode(blk1.to_numpy()["s"]) == [b"b", b"a"]
        assert d.decode(blk2.to_numpy()["s"]) == [b"a", b"c"]
        got[label] = (blk1.to_numpy()["s"].tolist(),
                      blk2.to_numpy()["s"].tolist(), list(d.values))
    assert got["ref"] == got["port"]


def _oracle(kit):
    """One OracleTable per package with every result type."""
    dt, table_cls, dset = kit
    schema = dt.Schema((
        dt.Field("i", dt.LogicalType(dt.Kind.INT64), True),
        dt.Field("i32", dt.LogicalType(dt.Kind.INT32), True),
        dt.Field("f", dt.LogicalType(dt.Kind.DOUBLE), True),
        dt.Field("b", dt.LogicalType(dt.Kind.BOOL), True),
        dt.Field("s", dt.STRING, True),
        dt.Field("m", dt.decimal(3), True),
        dt.Field("d", dt.LogicalType(dt.Kind.DATE), True),
        dt.Field("ts", dt.TIMESTAMP, True),
    ))
    valid = np.array([True, False, True, True])
    cols = {
        "i": np.array([1, 0, -3, 1 << 40], dtype=np.int64),
        "i32": np.array([7, 0, -7, 2], dtype=np.int32),
        "f": np.array([0.5, 0.0, -2.25, 1e300]),
        "b": np.array([True, False, False, True]),
        "s": np.array([0, 0, 1, 2], dtype=np.int32),
        "m": np.array([1125, 0, -1, 123456789], dtype=np.int64),
        "d": np.array([18321, 0, 0, -1], dtype=np.int32),
        "ts": np.array([0, 0, 1_600_000_000_000_000, -1], dtype=np.int64),
    }
    out = table_cls({k: (v, valid.copy()) for k, v in cols.items()}, schema)
    dicts = dset()
    dicts.for_column("s").encode([b"x", b"yy", "é".encode()])
    out.dicts = dicts
    return out


def test_oracle_to_ipc_bytes_equal_reference():
    ref = rarrow_io.oracle_to_ipc(_oracle((rdt, ROracleTable,
                                           RDictionarySet)))
    port = arrow_io.oracle_to_ipc(_oracle((dtypes, OracleTable,
                                           DictionarySet)))
    assert port == ref
    t = arrow_io.ipc_to_table(port)
    assert t.equals(rarrow_io.ipc_to_table(ref))
    assert t.to_pydict() == {
        "i": [1, None, -3, 1 << 40], "i32": [7, None, -7, 2],
        "f": [0.5, None, -2.25, 1e300], "b": [True, None, False, True],
        "s": ["x", None, "yy", "é"],
        "m": [pydec.Decimal("1.125"), None, pydec.Decimal("-0.001"),
              pydec.Decimal("123456.789")],
        "d": [datetime.date(2020, 2, 29), None, datetime.date(1970, 1, 1),
              datetime.date(1969, 12, 31)],
        "ts": [datetime.datetime(1970, 1, 1), None,
               datetime.datetime(2020, 9, 13, 12, 26, 40),
               datetime.datetime(1969, 12, 31, 23, 59, 59, 999999)],
    }
    # an unbound string column with values is refused, as in the reference
    bare = _oracle((dtypes, OracleTable, DictionarySet))
    bare.dicts = None
    with pytest.raises(ValueError, match="no dictionary bound"):
        arrow_io.oracle_to_ipc(bare)


def test_record_batch_to_block_stages_on_the_named_device():
    batch = _mixed_batch()
    blk = arrow_bridge.record_batch_to_block(batch, DictionarySet(),
                                             device="cpu")
    assert {c.data.device.type for c in blk.columns.values()} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            arrow_bridge.record_batch_to_block(batch, DictionarySet())


def test_bulk_upsert_conversion_matches_reference():
    """The server's Arrow -> insert columns (``_arrow_to_insert``): raw
    strings, scaled decimals, days, validity — the reference's."""
    from ydb_tpu.api import server as rserver

    from ydb_tpu_torch.api import server

    at = pa.table({
        "id": pa.array([1, 2, 3], pa.int64()),
        "s": pa.array(["a", None, "c"]),
        "m": pa.array([pydec.Decimal("1.50"), None,
                       pydec.Decimal("-0.25")], pa.decimal128(10, 2)),
        "d": pa.array([datetime.date(2024, 1, 2), None,
                       datetime.date(1999, 12, 31)], pa.date32()),
        "ok": pa.array([True, None, False]),
    })
    got = []
    for dt, mod in ((rdt, rserver), (dtypes, server)):
        schema = dt.Schema((
            dt.Field("id", dt.LogicalType(dt.Kind.INT64), False),
            dt.Field("s", dt.STRING, True),
            dt.Field("m", dt.decimal(2), True),
            dt.Field("d", dt.LogicalType(dt.Kind.DATE), True),
            dt.Field("ok", dt.LogicalType(dt.Kind.BOOL), True),
        ))
        cols, val = mod._arrow_to_insert(at, schema)
        got.append(({k: (list(v) if isinstance(v, list) else v.tolist())
                     for k, v in cols.items()},
                    {k: v.tolist() for k, v in val.items()}))
        with pytest.raises(ValueError, match="missing"):
            mod._arrow_to_insert(at.drop_columns(["m"]), schema)
    assert got[0] == got[1]
    assert got[1][0]["m"] == [150, 0, -25]
    assert got[1][1]["s"] == [True, False, True]
