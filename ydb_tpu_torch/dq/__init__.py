from ydb_tpu_torch.dq.graph import (  # noqa: F401
    HashPartition,
    ResultOutput,
    SourceInput,
    StageSpec,
    UnionAllInput,
    build_tasks,
)
from ydb_tpu_torch.dq.compute import run_stage_graph  # noqa: F401
