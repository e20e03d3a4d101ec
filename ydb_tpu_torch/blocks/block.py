"""Fixed-shape device column blocks — the unit of columnar execution.

The torch counterpart of ``ydb_tpu/blocks/block.py``. The reference's
execution unit is an Arrow RecordBatch flowing through block operators
(ydb/library/yql/minikql/comp_nodes/mkql_blocks.cpp); here it is a
``TableBlock``: every column is a tensor padded to a common
``capacity`` on one device, with a 0-d int32 ``length`` tensor giving the
live row count. Rows in [length, capacity) are padding; kernels mask them
out via ``row_mask``. The layout matches the JAX package slot for slot
(same 1024-row capacity quantum, tail-only padding, int32 length), so
host columns of the two packages compare exactly.

NULLs: each column carries a validity mask (bool tensor). Kernels follow
Arrow/Kleene semantics where the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.device import resolve_device


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


#: capacity quantum of a block built without an explicit capacity (the
#: reference's DEFAULT_CAPACITY_QUANTUM)
DEFAULT_CAPACITY_QUANTUM = 1024


@dataclasses.dataclass
class Column:
    """One device column: physical values + validity mask.

    ``data`` is the physical representation per ydb_tpu_torch.dtypes
    (strings are int32 dictionary ids, decimals scaled int64).
    ``validity`` is True for non-null rows; padding rows are False.
    """

    data: torch.Tensor
    validity: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class TableBlock:
    """A batch of rows as named device columns, padded to ``capacity``."""

    columns: dict[str, Column]
    length: torch.Tensor  # 0-d int32: live rows
    schema: dtypes.Schema

    # ---- construction ----

    @staticmethod
    def from_numpy(
        arrays: Mapping[str, np.ndarray],
        schema: dtypes.Schema,
        validity: Mapping[str, np.ndarray] | None = None,
        capacity: int | None = None,
        device: "str | torch.device | None" = None,
    ) -> "TableBlock":
        """Build a block from host numpy arrays (already physically
        encoded) on ``device`` (CUDA unless the caller names another).

        Only a short tail is ever padded. On the CPU a capacity-aligned
        array is shared with the block, not copied, so callers must not
        mutate ``arrays``/``validity`` after handing them over.
        """
        dev = resolve_device(device)
        n = len(next(iter(arrays.values()))) if arrays else 0
        cap = capacity if capacity is not None else _round_up(
            max(n, 1), DEFAULT_CAPACITY_QUANTUM)
        if cap < n:
            raise ValueError(f"capacity {cap} < rows {n}")
        cols = {}
        for name in schema.names:
            f = schema.field(name)
            tdt = dtypes.torch_dtype(f.type)
            a = np.ascontiguousarray(arrays[name], dtype=f.type.physical)
            v = None if validity is None else validity.get(name)
            v = (np.ones(n, dtype=np.bool_) if v is None
                 else np.ascontiguousarray(v, dtype=np.bool_))
            if cap != n:
                # tail-only padding; padding validity stays False so it
                # can never leak live rows
                a = np.concatenate([a, np.zeros(cap - n, dtype=a.dtype)])
                v = np.concatenate([v, np.zeros(cap - n, dtype=np.bool_)])
            cols[name] = Column(
                torch.from_numpy(a).to(device=dev, dtype=tdt),
                torch.from_numpy(v).to(device=dev))
        length = torch.tensor(n, dtype=torch.int32, device=dev)
        return TableBlock(cols, length, schema)

    # ---- views ----

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.length.device

    def row_mask(self) -> torch.Tensor:
        """bool[capacity]: True for live (non-padding) rows."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.length

    def select(self, names) -> "TableBlock":
        return TableBlock(
            {n: self.columns[n] for n in names},
            self.length,
            self.schema.select(names),
        )

    def with_column(
        self, name: str, col: Column, typ: dtypes.LogicalType
    ) -> "TableBlock":
        cols = dict(self.columns)
        cols[name] = col
        sch = self.schema
        if name not in sch:
            sch = sch.with_field(dtypes.Field(name, typ))
        return TableBlock(cols, self.length, sch)

    # ---- host materialization (tests / result delivery) ----

    def host_columns(
        self, validity: bool = True
    ) -> "tuple[dict[str, np.ndarray], dict[str, np.ndarray]]":
        """(data, validity) of the live rows as numpy arrays."""
        n = int(self.length)
        data = {k: c.data[:n].cpu().numpy() for k, c in self.columns.items()}
        valid = ({k: c.validity[:n].cpu().numpy()
                  for k, c in self.columns.items()} if validity else {})
        return data, valid


def device_aux(aux: Mapping[str, object],
               device: "str | torch.device") -> dict:
    """Stage a compiled program's aux tables (dict masks, gather tables)
    on ``device`` once, passing tensors already there through."""
    dev = torch.device(device)
    out = {}
    for k, v in aux.items():
        if isinstance(v, torch.Tensor) and v.device == dev:
            out[k] = v
        else:
            out[k] = torch.as_tensor(np.asarray(v), device=dev)
    return out


def concat_blocks(blocks: list[TableBlock],
                  capacity: int | None = None) -> TableBlock:
    """Host-side concat of live rows into one block on the first block's
    device (filter-only scan results)."""
    if not blocks:
        raise ValueError("concat of no blocks")
    schema = blocks[0].schema
    if len(blocks) > 1:
        # a row may come from any branch, so a column is nullable as
        # soon as ANY branch's is (branch schemas share names/types)
        schema = dtypes.Schema(tuple(
            dtypes.Field(
                f.name, f.type,
                any(b.schema.field(f.name).nullable for b in blocks))
            for f in schema.fields))
    host = [b.host_columns() for b in blocks]
    arrays = {name: np.concatenate([d[name] for d, _ in host])
              for name in schema.names}
    validity = {name: np.concatenate([v[name] for _, v in host])
                for name in schema.names}
    return TableBlock.from_numpy(arrays, schema, validity, capacity=capacity,
                                 device=blocks[0].device)
