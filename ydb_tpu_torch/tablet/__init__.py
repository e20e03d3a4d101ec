from ydb_tpu_torch.tablet.executor import TabletExecutor, Transaction
from ydb_tpu_torch.tablet.localdb import LocalDb

__all__ = ["TabletExecutor", "Transaction", "LocalDb"]
