from ydb_tpu_torch.plan.nodes import (  # noqa: F401
    ExpandJoin,
    LookupJoin,
    PlanNode,
    TableScan,
    Transform,
)
from ydb_tpu_torch.plan.executor import Database, execute_plan, to_host  # noqa: F401
