"""Mesh-parallel scan execution: per-shard partial aggregation + merge.

The counterpart of ``ydb_tpu/parallel/dist.py``: the reference's
distributed aggregate pipeline (SURVEY.md §2.11) — per-tablet partial
states + inter-node shuffle/merge over DQ channels — as one SPMD step
over the shard mesh (``parallel/mesh.py``):

  shard-local partial SSA program (filters/assigns/group-by states)
    → state merge over the ``shard`` axis:
        dense/keyless group layouts: elementwise psum / pmin / pmax of
          slot-aligned states
        generic layouts: all_gather of compacted partial rows + local
          re-aggregation (the DQ UnionAll-then-final-agg shape)
    → final SSA program (AVG fixups, HAVING, ORDER BY).

The reference compiles the whole step into one XLA executable under
``shard_map``; the port runs it eagerly as per-shard functions split at
their collectives. The merged state and the step's output are
replicated (the reference's ``out_specs=P()``): every shard would
compute the same final block, so the final program runs once, on shard
0's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis import budget_ok, memsan
from ydb_tpu_torch.blocks.block import Column, TableBlock, device_aux
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.engine.scan import ColumnSource, required_columns
from ydb_tpu_torch.parallel import mesh as meshlib
from ydb_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh
from ydb_tpu_torch.ssa import kernels, twophase
from ydb_tpu_torch.ssa.compiler import compile_program
from ydb_tpu_torch.ssa.ops import Agg
from ydb_tpu_torch.ssa.program import Program


def stack_blocks(blocks: list[TableBlock]) -> TableBlock:
    """Stack per-shard blocks (one device, one capacity) along a leading
    shard axis."""
    sch = blocks[0].schema
    cols = {}
    with memsan.seam():
        for n in sch.names:
            cols[n] = Column(
                torch.stack([b.columns[n].data for b in blocks]),
                torch.stack([b.columns[n].validity for b in blocks]),
            )
        length = torch.stack([b.length for b in blocks])
    out = TableBlock(cols, length, sch)
    if memsan.armed():
        memsan.charge(memsan.nbytes_of(out), "stack",
                      owner="stack_blocks")
    return out


def _local(stacked: TableBlock, shard: int) -> TableBlock:
    """Shard ``shard``'s block of a stacked block (views, no copy)."""
    cols = {
        n: Column(c.data[shard], c.validity[shard])
        for n, c in stacked.columns.items()
    }
    return TableBlock(cols, stacked.length[shard], stacked.schema)


def _relocal(block: TableBlock) -> TableBlock:
    """Re-add a singleton shard axis, so per-shard outputs stack along
    it (``torch.cat``) as the reference's ``out_specs=P(shard)``
    concatenates them."""
    cols = {
        n: Column(c.data[None], c.validity[None])
        for n, c in block.columns.items()
    }
    return TableBlock(cols, block.length[None], block.schema)


def _neutral(dtype: torch.dtype, maximum: bool):
    """The identity of a max (``maximum=False``) or min reduction."""
    if dtype.is_floating_point:
        return float("inf") if maximum else float("-inf")
    if dtype == torch.bool:
        return maximum
    info = torch.iinfo(dtype)
    return info.max if maximum else info.min


def _merge_states(cols_in, merge_kinds, rank_tables, red_max, red_min,
                  red_sum, red_any):
    """Shared state-merge core: per-column masked reduction by aggregate
    kind, with string MIN/MAX ids re-packed as (lexicographic rank << 32
    | id) around the reduction (ids do not order like the strings;
    ``rank_tables`` ships the plan-time rank arrays). ``cols_in`` maps a
    column to (data list, validity list), one entry a member; the
    reductions take and return such lists. They are injected: mesh
    collectives for the cross-shard merge (_merge_slots), elementwise
    folds for the streaming pairwise merge (_merge_pair) — one logic, two
    execution shapes. Returns column -> list of Columns."""
    cols = {}
    for name, (ds, vs) in cols_in.items():
        kind = merge_kinds[name]
        packed = kind in (Agg.MIN, Agg.MAX) and name in rank_tables
        if packed:
            rt = rank_tables[name]
            ds = [(rt.to(d.device)[torch.clamp(d.long(), 0, rt.shape[0] - 1)]
                   .to(torch.int64) << 32) | d.to(torch.int64) for d in ds]
        if kind in ("key", Agg.SOME, Agg.MAX):
            ds = red_max([torch.where(v, d, _neutral(d.dtype, False))
                          for d, v in zip(ds, vs)])
        elif kind is Agg.MIN:
            ds = red_min([torch.where(v, d, _neutral(d.dtype, True))
                          for d, v in zip(ds, vs)])
        else:  # SUM / COUNT / COUNT_ALL states
            ds = red_sum([torch.where(v, d, torch.zeros_like(d))
                          for d, v in zip(ds, vs)])
        vs = red_any(vs)
        if packed:
            ds = [(d & 0xFFFFFFFF).to(torch.int32) for d in ds]
        cols[name] = [Column(d, v) for d, v in zip(ds, vs)]
    return cols


def _merge_slots(mesh, blocks: list[TableBlock],
                 merge_kinds: dict[str, Agg | str],
                 rank_tables: dict[str, torch.Tensor]) -> TableBlock:
    """Elementwise merge of slot-aligned partial states across the mesh;
    the merged state is replicated, and shard 0's replica returned."""
    head = blocks[0]
    cols = _merge_states(
        {n: ([b.columns[n].data for b in blocks],
             [b.columns[n].validity for b in blocks])
         for n in head.columns},
        merge_kinds, rank_tables,
        red_max=lambda xs: meshlib.pmax(mesh, xs),
        red_min=lambda xs: meshlib.pmin(mesh, xs),
        red_sum=lambda xs: meshlib.psum(mesh, xs),
        red_any=lambda vs: meshlib.pmax(mesh, vs),
    )
    return TableBlock({n: c[0] for n, c in cols.items()}, head.length,
                      head.schema)


def _live_prefix_host(block: TableBlock):
    """(host arrays dict, host validity dict, schema) of the live rows."""
    data, valid = block.host_columns()
    n = int(block.length)
    return ({m: a[:n] for m, a in data.items()},
            {m: v[:n] for m, v in valid.items()}, block.schema)


def _concat_states(parts: list, device) -> TableBlock:
    """Concatenate host live-prefix states (from _live_prefix_host) into
    one block on ``device``."""
    sch = parts[0][2]
    arrays = {
        n: np.concatenate([p[0][n] for p in parts]) for n in sch.names
    }
    validity = {
        n: np.concatenate([p[1][n] for p in parts]) for n in sch.names
    }
    return TableBlock.from_numpy(arrays, sch, validity, device=device)


@budget_ok("transient pad-to-capacity copy: every call site feeds the"
           " result straight into the charging mesh_place seam, which"
           " accounts the placed footprint")
def _pad_state(block: TableBlock, capacity: int) -> TableBlock:
    if block.capacity == capacity:
        return block
    cols = {}
    for n, c in block.columns.items():
        pad = capacity - c.data.shape[0]
        cols[n] = Column(
            torch.cat([c.data, torch.zeros((pad,), dtype=c.data.dtype,
                                           device=c.data.device)]),
            torch.cat([c.validity, torch.zeros((pad,), dtype=torch.bool,
                                               device=c.data.device)]),
        )
    return TableBlock(cols, block.length, block.schema)


def _merge_pair(a: TableBlock, b: TableBlock, merge_kinds, rank_tables):
    """Pairwise (device-local) twin of _merge_slots: fold two slot-aligned
    partial-state blocks into one. Drives the streaming per-shard state
    accumulation — each shard folds its block stream into ONE bounded
    state before the mesh-wide collective merge."""

    def fold(op):
        return lambda xs: [op(xs[0], xs[1])]

    cols = _merge_states(
        {n: ([ca.data, b.columns[n].data],
             [ca.validity, b.columns[n].validity])
         for n, ca in a.columns.items()},
        merge_kinds, rank_tables,
        red_max=fold(lambda x, y: (x | y) if x.dtype == torch.bool
                     else torch.maximum(x, y)),
        red_min=fold(torch.minimum),
        red_sum=fold(torch.add),
        red_any=fold(torch.logical_or),
    )
    return TableBlock({n: c[0] for n, c in cols.items()},
                      torch.maximum(a.length, b.length), a.schema)


def merge_spec(partial_prog: Program, partial_out_schema, dicts, device):
    """(merge_kinds, rank_tables) for cross-shard partial-state merges:
    per-column reduction kind from the partial program's group-by, plus
    lexicographic rank tables for string MIN/MAX (dictionary ids do not
    order like the strings they intern), staged on ``device``."""
    merge_kinds: dict[str, Agg | str] = {}
    rank_tables: dict[str, torch.Tensor] = {}
    gb = partial_prog.group_by
    if gb is not None:
        for k in gb.keys:
            merge_kinds[k] = "key"
        for spec in gb.aggs:
            merge_kinds[spec.out_name] = spec.func
            if (
                spec.func in (Agg.MIN, Agg.MAX)
                and spec.column is not None
                and partial_out_schema.field(spec.out_name).type.is_string
            ):
                with memsan.seam():
                    rt = torch.from_numpy(np.ascontiguousarray(
                        dicts[spec.column].sort_rank())).to(device)
                if memsan.armed():
                    memsan.charge(memsan.nbytes_of(rt), "staging",
                                  owner="rank_tables")
                rank_tables[spec.out_name] = rt
    return merge_kinds, rank_tables


def _gather_rows(mesh, blocks: list[TableBlock]) -> TableBlock:
    """all_gather compacted partial rows from every shard into one block
    (shard 0's replica)."""
    head = blocks[0]
    cap = head.capacity
    cols = {}
    for n in head.columns:
        d = meshlib.all_gather(mesh, [b.columns[n].data for b in blocks])[0]
        v = meshlib.all_gather(
            mesh, [b.columns[n].validity for b in blocks])[0]
        cols[n] = Column(d.reshape(-1), v.reshape(-1))
    lens = meshlib.all_gather(mesh, [b.length for b in blocks])[0]
    ndev = lens.shape[0]
    row = torch.arange(cap, dtype=torch.int32, device=lens.device)
    mask = (row[None, :] < lens[:, None]).reshape(-1)
    big = TableBlock(cols, torch.full((), ndev * cap, dtype=torch.int32,
                                      device=lens.device), head.schema)
    return kernels.compact(big, mask)


class MeshScan:
    """A distributed scan+aggregate program over a shard mesh."""

    def __init__(
        self,
        program: Program,
        schema: dtypes.Schema,
        dicts: DictionarySet | None = None,
        key_spaces: dict[str, int] | None = None,
        mesh=None,
        dict_aliases: dict[str, str] | None = None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.read_cols = required_columns(program, schema)
        in_schema = schema.select(self.read_cols)
        partial_prog, final_prog = twophase.split(
            program, with_row_counts=True
        )
        aliases = dict(dict_aliases or {})
        self.partial = compile_program(
            partial_prog, in_schema, dicts, key_spaces, partial_slots=True,
            dict_aliases=aliases,
        )
        self.final = (
            compile_program(final_prog, self.partial.out_schema, dicts,
                            key_spaces,
                            dict_aliases={
                                **aliases,
                                **twophase.dict_aliases(partial_prog),
                            })
            if final_prog is not None
            else None
        )
        self.out_schema = (
            self.final.out_schema if self.final else self.partial.out_schema
        )
        layout = self.partial.group_layout[0]
        self._use_slots = layout in ("dense_slots", "keyless")
        self.root = self.mesh.device_of(0)

        merge_kinds, rank_tables = merge_spec(
            partial_prog, self.partial.out_schema, dicts, self.root)
        self._merge_kinds = merge_kinds
        self._rank_tables = rank_tables

        with memsan.seam():
            # the partial program's aux on every shard device, the final
            # program's on shard 0's
            self._paux = {d: device_aux(self.partial.aux, d)
                          for d in dict.fromkeys(self.mesh.shard_devices)}
            self._faux = (device_aux(self.final.aux, self.root)
                          if self.final else {})
        if memsan.armed():
            memsan.charge(memsan.nbytes_of(
                (list(self._paux.values()), self._faux)), "staging",
                owner="mesh_aux")

    @property
    def merge_path(self) -> str:
        """How partial states meet: ``psum`` (slot-aligned states reduced
        elementwise) or ``gather`` (compacted rows all-gathered and
        re-aggregated)."""
        return "psum" if self.final is not None and self._use_slots \
            else "gather"

    # ---- the step, split at its collectives ----

    def _partial(self, block: TableBlock) -> TableBlock:
        return self.partial.run(block, self._paux[block.device])

    def _merge_final(self, parts: list[TableBlock]) -> TableBlock:
        # the collectives' buffers are the step's working set
        with memsan.seam():
            if self.final is None:
                return _gather_rows(self.mesh, parts)
            if self._use_slots:
                merged = _merge_slots(self.mesh, parts, self._merge_kinds,
                                      self._rank_tables)
                # drop dead group slots (keyless keeps its single row:
                # COUNT()=0 over empty input is still one output row)
                if (
                    self.partial.group_layout[0] == "dense_slots"
                    and "__rows" in merged.columns
                ):
                    live = merged.columns["__rows"].data > 0
                    merged = kernels.compact(merged,
                                             live & merged.row_mask())
            else:
                merged = _gather_rows(self.mesh, parts)
            return self.final.run(merged, self._faux)

    def run_blocks(self, blocks: list[TableBlock]) -> TableBlock:
        """One step over per-shard blocks, block ``i`` on shard ``i``'s
        device."""
        if len(blocks) != self.mesh.n_shards:
            raise ValueError(f"{len(blocks)} blocks for a "
                             f"{self.mesh.n_shards}-shard mesh")
        return self._merge_final([self._partial(b) for b in blocks])

    # ---- host-side drivers ----

    def run_stacked(self, stacked: TableBlock) -> TableBlock:
        """stacked: leading shard axis == mesh shard count."""
        with memsan.seam():
            blocks = [self._place(_local(stacked, i), i)
                      for i in range(self.mesh.n_shards)]
        if memsan.armed():
            memsan.charge(memsan.nbytes_of(blocks), "staging",
                          owner="mesh_place")
        return self.run_blocks(blocks)

    def _place(self, block: TableBlock, shard: int) -> TableBlock:
        dev = self.mesh.device_of(shard)
        if block.device == dev:
            return block
        cols = {n: Column(c.data.to(dev), c.validity.to(dev))
                for n, c in block.columns.items()}
        return TableBlock(cols, block.length.to(dev), block.schema)

    def execute_sources(self, sources, block_rows: int = 1 << 20
                        ) -> OracleTable:
        """Streaming scan over per-shard block-stream sources (the
        portion store feeding the mesh).

        Each shard's stream folds block-by-block into ONE bounded
        partial state on its device (slot layouts: pairwise merge;
        compact layouts: concatenated partial rows), then a single
        collective step merges states across the mesh and finalizes.
        Host memory per shard stays bounded by the stream's working
        set."""
        n_shards = self.mesh.shape[SHARD_AXIS]
        if len(sources) != n_shards:
            raise ValueError(
                f"{len(sources)} sources for a {n_shards}-shard mesh")
        layout = self.partial.group_layout[0]
        foldable = layout in ("keyless", "dense_slots")
        states = []
        for i, sub in enumerate(sources):
            dev = self.mesh.device_of(i)
            st = None
            parts = []
            for blk in sub.blocks(block_rows, self.read_cols, device=dev):
                part = self._partial(blk)
                if not foldable:
                    # keep only the live prefix ON HOST: holding every
                    # full-capacity device block would grow device memory
                    # linearly with the stream
                    parts.append(_live_prefix_host(part))
                elif st is None:
                    st = part
                else:
                    st = _merge_pair(st, part, self._merge_kinds,
                                     self._rank_tables)
            states.append(st if foldable else _concat_states(parts, dev))
        if not foldable:
            # compact states vary in size shard-to-shard: pad to common
            cap = max(s.capacity for s in states)
            states = [_pad_state(s, cap) for s in states]
        if memsan.armed():
            memsan.charge(memsan.nbytes_of(states), "staging",
                          owner="mesh_place")
        out = self._merge_final(states)
        return OracleTable.from_block(out)

    def execute(self, source: ColumnSource) -> OracleTable:
        """Partition a host table across the mesh (contiguous row ranges,
        shard ``i``'s block on its device) and run one step."""
        n_shards = self.mesh.shape[SHARD_AXIS]
        n = source.num_rows
        per = max(-(-n // n_shards), 1)
        blocks = []
        sch = source.schema.select(self.read_cols)
        for s in range(n_shards):
            lo, hi = min(s * per, n), min((s + 1) * per, n)
            arrays = {m: source.columns[m][lo:hi] for m in self.read_cols}
            validity = None
            if source.validity:
                validity = {
                    m: source.validity[m][lo:hi]
                    for m in self.read_cols
                    if m in source.validity
                }
            blocks.append(TableBlock.from_numpy(
                arrays, sch, validity, capacity=per,
                device=self.mesh.device_of(s)))
        return OracleTable.from_block(self.run_blocks(blocks))
