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
        An array may also be a tensor (a device-resident source's slice):
        it moves to ``device``, made contiguous (a strided slice of a DQ
        partition is copied once, here).

        Only a short tail is ever padded. A capacity-aligned array or
        tensor already on ``device`` is shared with the block, not copied,
        so callers must not mutate ``arrays``/``validity`` after handing
        them over.
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
            v = None if validity is None else validity.get(name)
            if isinstance(arrays[name], torch.Tensor):
                cols[name] = _tensor_column(arrays[name], v, n, cap, dev, tdt)
                continue
            a = np.ascontiguousarray(arrays[name], dtype=f.type.physical)
            v = (np.ones(n, dtype=np.bool_) if v is None
                 else np.ascontiguousarray(v, dtype=np.bool_))
            cols[name] = Column(_padded(a, cap, dev, tdt),
                                _padded(v, cap, dev, torch.bool))
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
        """(data, validity) of the live rows as numpy arrays: one batched
        device fetch for all of them."""
        n = int(self.length)
        names = list(self.columns)
        parts = [self.columns[k].data[:n] for k in names]
        if validity:
            parts += [self.columns[k].validity[:n] for k in names]
        got = _fetch(parts)
        data = dict(zip(names, got[:len(names)]))
        valid = dict(zip(names, got[len(names):]))
        return data, valid

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Live rows only, as physical numpy arrays (nulls not decoded)."""
        return self.host_columns(validity=False)[0]

    def validity_numpy(self) -> dict[str, np.ndarray]:
        n = int(self.length)
        names = list(self.columns)
        return dict(zip(names, _fetch(
            [self.columns[k].validity[:n] for k in names])))


def _fetch(tensors: list) -> list:
    """Host numpy copies of ``tensors``. On the CPU they are views; on a
    device every tensor's bytes are packed into one device buffer (widest
    items first, so each host view stays aligned) and read back in one
    copy: one wait for the device instead of one per tensor."""
    if not tensors or tensors[0].device.type == "cpu":
        return [t.cpu().numpy() for t in tensors]
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    packed = torch.cat([tensors[i].contiguous().view(torch.uint8)
                        for i in order]).cpu().numpy()
    out = [None] * len(tensors)
    off = 0
    for i in order:
        t = tensors[i]
        nbytes = t.numel() * t.element_size()
        dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[i] = packed[off:off + nbytes].view(dt)
        off += nbytes
    return out


def _padded(a: np.ndarray, cap: int, dev: torch.device,
            tdt: torch.dtype) -> torch.Tensor:
    """``a`` on ``dev`` with a zero tail up to ``cap`` rows (tail-only
    padding; padding validity stays False so it can never leak live
    rows). The tail is filled on ``dev``: the host copies nothing."""
    t = torch.from_numpy(a)
    if cap == len(a):
        return t.to(device=dev, dtype=tdt)
    out = torch.empty(cap, dtype=tdt, device=dev)
    out[:len(a)].copy_(t)
    out[len(a):].zero_()
    return out


def _tensor_column(a: torch.Tensor, v, n: int, cap: int,
                   dev: torch.device, tdt: torch.dtype) -> Column:
    """A column from a tensor slice: contiguous, tail-padded like host
    arrays."""
    a = a.to(device=dev, dtype=tdt).contiguous()
    v = (torch.ones(n, dtype=torch.bool, device=dev) if v is None
         else v.to(device=dev, dtype=torch.bool).contiguous())
    if cap != n:
        a = torch.cat([a, a.new_zeros(cap - n)])
        v = torch.cat([v, v.new_zeros(cap - n)])
    return Column(a, v)


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
    """Concat of the live rows of ``blocks``, in order, into one block on
    the first block's device. The result equals the reference's host-side
    concat (the live rows, padded at the tail to ``capacity`` or to the
    1024-row quantum), but the rows stay on the device; only the lengths
    are read back."""
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
    dev = blocks[0].device
    lens = [int(b.length) for b in blocks]
    n = sum(lens)
    cap = capacity if capacity is not None else _round_up(
        max(n, 1), DEFAULT_CAPACITY_QUANTUM)
    if cap < n:
        raise ValueError(f"capacity {cap} < rows {n}")
    cols = {}
    for name in schema.names:
        tdt = dtypes.torch_dtype(schema.field(name).type)
        data = torch.zeros(cap, dtype=tdt, device=dev)
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        off = 0
        for b, m in zip(blocks, lens):
            c = b.columns[name]
            data[off:off + m] = c.data[:m].to(dev)
            valid[off:off + m] = c.validity[:m].to(dev)
            off += m
        cols[name] = Column(data, valid)
    length = torch.tensor(n, dtype=torch.int32, device=dev)
    return TableBlock(cols, length, schema)
