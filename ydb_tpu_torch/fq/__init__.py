"""The streaming query service (the port's own copy of ``ydb_tpu/fq/``):
continuous SQL over topics, each micro-batch on the device."""

from ydb_tpu_torch.fq.service import FederatedQueryService, StreamingQuery

__all__ = ["FederatedQueryService", "StreamingQuery"]
