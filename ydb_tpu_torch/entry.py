"""Entry point: the TPC-H Q1 partial SSA program over one lineitem block.

The counterpart of ``__graft_entry__.py:entry`` — the flagship kernel of
the columnar engine (scan + filter + group-by states) as a callable plus
its inputs, on ``device`` (CUDA unless the caller passes another).
"""

from __future__ import annotations

import torch

from ydb_tpu_torch.blocks.block import device_aux
from ydb_tpu_torch.device import resolve_device
from ydb_tpu_torch.engine.scan import ColumnSource, ScanExecutor
from ydb_tpu_torch.workload import tpch


def entry(device: "str | torch.device | None" = None):
    """Return ``(partial_run, (block, aux))``: ``partial_run(block, aux)``
    runs Q1's partial program over the first 4096-row block of a tiny
    (SF-0.001, seed 5) lineitem table."""
    dev = resolve_device(device)
    data = tpch.TpchData(sf=0.001, seed=5)
    src = ColumnSource(
        columns=data.tables["lineitem"],
        schema=tpch.LINEITEM_SCHEMA,
        dicts=data.dicts,
    )
    ex = ScanExecutor(tpch.q1_program(), src, block_rows=1 << 12, device=dev)
    block = next(iter(src.blocks(1 << 12, ex.read_cols, device=dev)))
    return ex.partial.run, (block, device_aux(ex.partial.aux, dev))
