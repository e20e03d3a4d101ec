"""State carried across from the JAX package, by plain values only.

``source_from_numpy`` builds the port's ``ColumnSource`` (with its
``DictionarySet``) from numpy arrays, ``(name, kind, scale, nullable)``
tuples and per-column dictionary values. ``program_from_reference``
converts a reference ``Program`` (or any expression, step, type or
schema) into the port's classes by duck typing: class name +
``dataclasses.fields``, enums by member name. Nothing here imports the
reference package; the tests use it to move the reference's programs,
tables and dictionaries into the port.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.ssa import ops, program


def classes_of(*modules) -> dict:
    """Dataclasses and enums defined in ``modules``, by class name."""
    out = {}
    for m in modules:
        for name, obj in vars(m).items():
            if isinstance(obj, type) and (
                    dataclasses.is_dataclass(obj) or issubclass(obj, enum.Enum)):
                out[name] = obj
    return out


#: the port's value classes by name (programs, expressions, types, enums)
PORT_CLASSES = classes_of(program, ops, dtypes)


def convert(obj, classes: Mapping[str, type]):
    """Rebuild ``obj`` with the same-named classes of ``classes``:
    dataclasses field by field, enums by member name, tuples and lists
    element-wise; plain values (numbers, bytes, strings, numpy scalars,
    callables) pass through."""
    if isinstance(obj, enum.Enum):
        return classes[type(obj).__name__][obj.name]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = classes[type(obj).__name__]
        new = object.__new__(cls)
        for f in dataclasses.fields(obj):
            object.__setattr__(new, f.name, convert(getattr(obj, f.name),
                                                    classes))
        return new
    if isinstance(obj, tuple):
        return tuple(convert(v, classes) for v in obj)
    if isinstance(obj, list):
        return [convert(v, classes) for v in obj]
    return obj


def program_from_reference(obj):
    """A reference ``Program`` (or expression, step, type, schema) as the
    port's classes."""
    return convert(obj, PORT_CLASSES)


def schema_from_spec(spec: Sequence[tuple]) -> dtypes.Schema:
    """Schema from ``(name, kind, scale, nullable)`` tuples; ``kind`` is a
    ``dtypes.Kind`` member name such as ``"INT64"`` or ``"DECIMAL"``."""
    return dtypes.Schema(tuple(
        dtypes.Field(name, dtypes.LogicalType(dtypes.Kind[kind], scale),
                     nullable)
        for name, kind, scale, nullable in spec))


def source_from_numpy(
    columns: Mapping[str, np.ndarray],
    validity: Mapping[str, np.ndarray] | None,
    schema_spec: Sequence[tuple],
    dict_values: Mapping[str, Sequence[bytes]] | None = None,
) -> ColumnSource:
    """The port's ``ColumnSource`` over plain numpy columns, with a
    ``DictionarySet`` holding ``dict_values[col]`` in id order."""
    dicts = DictionarySet()
    for col, values in (dict_values or {}).items():
        d = dicts.for_column(col)
        for v in values:
            d.add(v)
        if len(d) != len(values):
            raise ValueError(f"dictionary of {col} repeats a value")
    return ColumnSource(dict(columns), schema_from_spec(schema_spec), dicts,
                        dict(validity) if validity else None)
