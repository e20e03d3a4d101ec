from ydb_tpu_torch.tx.coordinator import Coordinator, TxResult  # noqa: F401
from ydb_tpu_torch.tx.sharded import ShardedTable  # noqa: F401
