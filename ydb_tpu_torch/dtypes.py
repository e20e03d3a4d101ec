"""Logical column types and their device representations.

The port's own copy of ``ydb_tpu/dtypes.py`` (the port imports nothing
of ``ydb_tpu``), plus the map from each logical kind to the
``torch.dtype`` its device tensors use. Each logical type maps to a
*physical* dtype plus optional side metadata (decimal scale, string
dictionary):

  INT8/16/32/64, UINT8/16/32  -> same-width ints
  UINT64                      -> no usable torch dtype: torch_dtype raises
  FLOAT, DOUBLE               -> float32 / float64
  BOOL                        -> bool
  DATE                        -> int32 (days since epoch)
  TIMESTAMP                   -> int64 (microseconds since epoch)
  DECIMAL(p, s)               -> int64 scaled by 10**s   (exact arithmetic)
  STRING / UTF8               -> int32 dictionary ids; the dictionary itself
                                 stays on host (ydb_tpu_torch.blocks.dictionary)

Physical dtypes match the reference bit for bit (int64 decimals and
timestamps, int32 dates and dictionary ids, bool validity), so host
columns of the two packages compare exactly.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class Kind(enum.Enum):
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT = "float32"
    DOUBLE = "float64"
    BOOL = "bool"
    DATE = "date"            # int32 days
    TIMESTAMP = "timestamp"  # int64 micros
    DECIMAL = "decimal"      # int64 scaled
    STRING = "string"        # int32 dict id


_PHYSICAL = {
    Kind.INT8: np.int8,
    Kind.INT16: np.int16,
    Kind.INT32: np.int32,
    Kind.INT64: np.int64,
    Kind.UINT8: np.uint8,
    Kind.UINT16: np.uint16,
    Kind.UINT32: np.uint32,
    Kind.UINT64: np.uint64,
    Kind.FLOAT: np.float32,
    Kind.DOUBLE: np.float64,
    Kind.BOOL: np.bool_,
    Kind.DATE: np.int32,
    Kind.TIMESTAMP: np.int64,
    Kind.DECIMAL: np.int64,
    Kind.STRING: np.int32,
}


@dataclasses.dataclass(frozen=True)
class LogicalType:
    """A logical column type. Hashable; used as static compile metadata."""

    kind: Kind
    # DECIMAL scale: value = unscaled / 10**scale. Ignored otherwise.
    scale: int = 0

    @property
    def physical(self) -> np.dtype:
        return np.dtype(_PHYSICAL[self.kind])

    @property
    def is_string(self) -> bool:
        return self.kind == Kind.STRING

    @property
    def is_decimal(self) -> bool:
        return self.kind == Kind.DECIMAL

    @property
    def is_floating(self) -> bool:
        return self.kind in (Kind.FLOAT, Kind.DOUBLE)

    @property
    def is_integer(self) -> bool:
        return self.kind in (
            Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64,
            Kind.UINT8, Kind.UINT16, Kind.UINT32, Kind.UINT64,
            Kind.DATE, Kind.TIMESTAMP,
        )

    def __repr__(self) -> str:
        if self.kind == Kind.DECIMAL:
            return f"decimal(s={self.scale})"
        return self.kind.value


INT8 = LogicalType(Kind.INT8)
INT16 = LogicalType(Kind.INT16)
INT32 = LogicalType(Kind.INT32)
INT64 = LogicalType(Kind.INT64)
UINT8 = LogicalType(Kind.UINT8)
UINT16 = LogicalType(Kind.UINT16)
UINT32 = LogicalType(Kind.UINT32)
UINT64 = LogicalType(Kind.UINT64)
FLOAT = LogicalType(Kind.FLOAT)
DOUBLE = LogicalType(Kind.DOUBLE)
BOOL = LogicalType(Kind.BOOL)
DATE = LogicalType(Kind.DATE)
TIMESTAMP = LogicalType(Kind.TIMESTAMP)
STRING = LogicalType(Kind.STRING)


_TORCH = {
    Kind.INT8: torch.int8,
    Kind.INT16: torch.int16,
    Kind.INT32: torch.int32,
    Kind.INT64: torch.int64,
    Kind.UINT8: torch.uint8,
    Kind.UINT16: torch.uint16,
    Kind.UINT32: torch.uint32,
    Kind.FLOAT: torch.float32,
    Kind.DOUBLE: torch.float64,
    Kind.BOOL: torch.bool,
    Kind.DATE: torch.int32,
    Kind.TIMESTAMP: torch.int64,
    Kind.DECIMAL: torch.int64,
    Kind.STRING: torch.int32,
}

def torch_dtype(t: LogicalType) -> torch.dtype:
    """Device dtype of a logical type.

    UINT64 raises: torch has no uint64 tensor arithmetic worth the
    name, and nothing on the scan path produces one."""
    if t.kind not in _TORCH:
        raise TypeError(f"{t} has no torch device dtype")
    return _TORCH[t.kind]


def decimal(scale: int) -> LogicalType:
    return LogicalType(Kind.DECIMAL, scale=scale)


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    type: LogicalType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class Schema:
    """Ordered, hashable column schema."""

    fields: tuple[Field, ...]

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"no column {name!r} in schema {self.names}")

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def select(self, names) -> "Schema":
        return Schema(tuple(self.field(n) for n in names))

    def with_field(self, f: Field) -> "Schema":
        return Schema(self.fields + (f,))


def schema(*cols: tuple) -> Schema:
    """schema(("a", INT32), ("b", STRING, False), ...)"""
    fields = []
    for c in cols:
        if len(c) == 2:
            fields.append(Field(c[0], c[1]))
        else:
            fields.append(Field(c[0], c[1], c[2]))
    return Schema(tuple(fields))
