"""Result-set wire format: OracleTable <-> Arrow IPC.

The reference streams scan results as Arrow batches (TEvScanData); the
API layer keeps that columnar shape on the wire: strings decode from
dictionary ids, decimals become decimal128, dates become date32.

The port's own copy of ``ydb_tpu/api/arrow_io.py``: for the same
``OracleTable`` it writes the same IPC bytes.
"""

from __future__ import annotations

import decimal as pydec
import io

import numpy as np
import pyarrow as pa

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.engine.oracle import OracleTable


def oracle_to_ipc(table: OracleTable, dicts=None) -> bytes:
    dicts = dicts if dicts is not None else table.dicts
    arrays = []
    fields = []
    n = table.num_rows
    for f in table.schema.fields:
        vals, valid = table.cols[f.name]
        mask = ~np.asarray(valid, dtype=bool)
        t = f.type
        if t.is_string:
            if not (dicts and f.name in dicts):
                if mask.all():
                    arr = pa.nulls(n, type=pa.string())
                else:
                    # silent all-NULL output would corrupt results —
                    # fail loudly like OracleTable.strings does
                    raise ValueError(
                        f"no dictionary bound for string column "
                        f"{f.name!r}")
            else:
                d = dicts[f.name]
                values = pa.array(
                    [v.decode("utf-8", "surrogateescape")
                     for v in d.values],
                    type=pa.string())
                idx = pa.array(np.asarray(vals, dtype=np.int32),
                               mask=mask if mask.any() else None)
                arr = pa.DictionaryArray.from_arrays(
                    idx, values).dictionary_decode()
            fields.append(pa.field(f.name, pa.string(), f.nullable))
        elif t.is_decimal:
            ints = np.asarray(vals, dtype=np.int64)
            py = [None if mask[i] else
                  pydec.Decimal(int(ints[i])).scaleb(-t.scale)
                  for i in range(n)]
            typ = pa.decimal128(38, t.scale)
            arr = pa.array(py, type=typ)
            fields.append(pa.field(f.name, typ, f.nullable))
        elif t.kind == dtypes.Kind.DATE:
            arr = pa.array(np.asarray(vals, dtype=np.int32),
                           type=pa.date32(),
                           mask=mask if mask.any() else None)
            fields.append(pa.field(f.name, pa.date32(), f.nullable))
        elif t.kind == dtypes.Kind.TIMESTAMP:
            arr = pa.array(np.asarray(vals, dtype=np.int64),
                           type=pa.timestamp("us"),
                           mask=mask if mask.any() else None)
            fields.append(pa.field(f.name, pa.timestamp("us"),
                                   f.nullable))
        else:
            arr = pa.array(np.asarray(vals),
                           mask=mask if mask.any() else None)
            fields.append(pa.field(f.name, arr.type, f.nullable))
        arrays.append(arr)
    batch = pa.record_batch(arrays, schema=pa.schema(fields))
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, batch.schema) as writer:
        writer.write_batch(batch)
    return sink.getvalue()


def ipc_to_table(data: bytes) -> pa.Table:
    with pa.ipc.open_stream(io.BytesIO(data)) as reader:
        return reader.read_all()
