"""Topics (the port's own copy of ``ydb_tpu/topic/``): PersQueue
partitions on the tablet executor, and the partitioned ``Topic`` with its
read sessions. Host-side by design, as in the reference."""

from ydb_tpu_torch.topic.pq import Partition
from ydb_tpu_torch.topic.topic import ReadSession, Topic

__all__ = ["Partition", "ReadSession", "Topic"]
