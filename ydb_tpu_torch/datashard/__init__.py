"""The row store (the port's own copy of ``ydb_tpu/datashard/``):
``DataShard`` tablets, the read iterator, the execution-unit pipeline and
``RowTable``. Host-side by design, as in the reference: a row table
reaches the device through ``RowTable.source_at``."""

from ydb_tpu_torch.datashard.shard import DataShard, LockBroken, TxRejected
from ydb_tpu_torch.datashard.table import RowTable

__all__ = ["DataShard", "RowTable", "LockBroken", "TxRejected"]
