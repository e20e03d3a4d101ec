from ydb_tpu_torch.scheme.model import (
    TableDescription, schema_from_json, schema_to_json,
)
from ydb_tpu_torch.scheme.shard import SchemeError, SchemeShardCore

__all__ = [
    "TableDescription", "schema_from_json", "schema_to_json",
    "SchemeError", "SchemeShardCore",
]
