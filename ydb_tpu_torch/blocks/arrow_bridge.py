"""Arrow RecordBatch ⇄ TableBlock bridge.

The analog of the reference's Arrow glue (ydb/core/formats/arrow): the
ColumnShard stores and ships Arrow batches; the device executes
fixed-shape blocks. Encoding rules follow ``ydb_tpu_torch.dtypes``:

  * string/binary columns dictionary-encode against a table-level
    ``DictionarySet`` (host), shipping int32 ids;
  * decimal128(p, s) → int64 unscaled (values must fit 64 bits — TPC-H/DS do);
  * date32 → int32 days, timestamp[us] → int64;
  * nulls → validity masks (null slots get 0, masked out by kernels).

The port's own copy of ``ydb_tpu/blocks/arrow_bridge.py``: the same
physical values, validity and dictionary ids, over the port's
``TableBlock``. ``record_batch_to_block`` stages the block on ``device``
(CUDA unless the caller names another, as ``TableBlock.from_numpy``).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.block import TableBlock
from ydb_tpu_torch.blocks.dictionary import DictionarySet

_ARROW_TO_KIND = {
    pa.int8(): dtypes.Kind.INT8,
    pa.int16(): dtypes.Kind.INT16,
    pa.int32(): dtypes.Kind.INT32,
    pa.int64(): dtypes.Kind.INT64,
    pa.uint8(): dtypes.Kind.UINT8,
    pa.uint16(): dtypes.Kind.UINT16,
    pa.uint32(): dtypes.Kind.UINT32,
    pa.uint64(): dtypes.Kind.UINT64,
    pa.float32(): dtypes.Kind.FLOAT,
    pa.float64(): dtypes.Kind.DOUBLE,
    pa.bool_(): dtypes.Kind.BOOL,
    pa.date32(): dtypes.Kind.DATE,
}


def schema_from_arrow(asch: pa.Schema) -> dtypes.Schema:
    fields = []
    for f in asch:
        t = f.type
        if t in _ARROW_TO_KIND:
            lt = dtypes.LogicalType(_ARROW_TO_KIND[t])
        elif pa.types.is_timestamp(t):
            lt = dtypes.TIMESTAMP
        elif pa.types.is_decimal(t):
            lt = dtypes.decimal(t.scale)
        elif (
            pa.types.is_string(t)
            or pa.types.is_large_string(t)
            or pa.types.is_binary(t)
            or pa.types.is_large_binary(t)
            or pa.types.is_dictionary(t)
        ):
            lt = dtypes.STRING
        else:
            raise NotImplementedError(f"arrow type {t} for column {f.name}")
        fields.append(dtypes.Field(f.name, lt, f.nullable))
    return dtypes.Schema(tuple(fields))


def _column_to_numpy(
    arr: pa.ChunkedArray | pa.Array,
    field: dtypes.Field,
    dicts: DictionarySet,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (physical values, validity) for one column."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    validity = np.ones(n, dtype=np.bool_) if arr.null_count == 0 else np.asarray(
        arr.is_valid()
    )
    t = field.type
    if t.is_string:
        d = dicts.for_column(field.name)
        if pa.types.is_dictionary(arr.type):
            # Remap the batch-local dictionary into the table-level one.
            local = arr.dictionary.to_pylist()
            remap = np.fromiter(
                (d.add(v if v is not None else b"") for v in local),
                dtype=np.int32, count=len(local),
            )
            idx = np.asarray(arr.indices.fill_null(0), dtype=np.int32)
            vals = remap[idx] if len(local) else np.zeros(n, np.int32)
        else:
            py = arr.to_pylist()
            vals = np.fromiter(
                (d.add(v) if v is not None else 0 for v in py),
                dtype=np.int32, count=n,
            )
        return vals, validity
    if t.is_decimal:
        # decimal128 → scaled int64; arrow gives Decimal objects host-side.
        py = arr.to_pylist()
        vals = np.fromiter(
            (
                int(v.scaleb(t.scale).to_integral_value()) if v is not None else 0
                for v in py
            ),
            dtype=np.int64, count=n,
        )
        return vals, validity
    if pa.types.is_timestamp(arr.type):
        arr = arr.cast(pa.timestamp("us"))
        vals = np.asarray(arr.fill_null(0), dtype="datetime64[us]").astype(np.int64)
        return vals, validity
    if pa.types.is_date32(arr.type):
        vals = np.asarray(arr.fill_null(0), dtype="datetime64[D]").astype(np.int32)
        return vals, validity
    fill = False if pa.types.is_boolean(arr.type) else 0
    # a copy: Arrow's zero-copy buffer is read-only, and a CPU block of a
    # whole quantum of rows would alias it as a writable tensor
    vals = np.array(arr.fill_null(fill), dtype=t.physical)
    return vals, validity


def record_batch_to_block(
    batch: pa.RecordBatch | pa.Table,
    dicts: DictionarySet,
    schema: dtypes.Schema | None = None,
    capacity: int | None = None,
    device=None,
) -> TableBlock:
    if schema is None:
        schema = schema_from_arrow(batch.schema)
    arrays: dict[str, np.ndarray] = {}
    validity: dict[str, np.ndarray] = {}
    for f in schema.fields:
        col = batch.column(f.name)
        arrays[f.name], validity[f.name] = _column_to_numpy(col, f, dicts)
    return TableBlock.from_numpy(arrays, schema, validity, capacity=capacity,
                                 device=device)


def block_to_record_batch(
    block: TableBlock, dicts: DictionarySet | None = None
) -> pa.RecordBatch:
    """Materialize live rows back into an Arrow RecordBatch (host)."""
    import decimal as pydec

    data = block.to_numpy()
    valid = block.validity_numpy()
    out = []
    names = []
    for f in block.schema.fields:
        v = data[f.name]
        mask = ~valid[f.name]
        t = f.type
        if t.is_string:
            if dicts is not None and f.name in dicts:
                vals = dicts[f.name].decode(v)
                arr = pa.array(
                    [None if m else s for s, m in zip(vals, mask)],
                    type=pa.binary(),
                )
            else:
                arr = pa.array(v, mask=mask, type=pa.int32())
        elif t.is_decimal:
            q = pydec.Decimal(1).scaleb(-t.scale)
            arr = pa.array(
                [
                    None if m else pydec.Decimal(int(x)).scaleb(-t.scale).quantize(q)
                    for x, m in zip(v, mask)
                ],
                type=pa.decimal128(38, t.scale),
            )
        elif t.kind == dtypes.Kind.DATE:
            arr = pa.array(v.astype("datetime64[D]"), mask=mask)
        elif t.kind == dtypes.Kind.TIMESTAMP:
            arr = pa.array(v.astype("datetime64[us]"), mask=mask)
        else:
            arr = pa.array(v, mask=mask)
        out.append(arr)
        names.append(f.name)
    return pa.RecordBatch.from_arrays(out, names=names)
