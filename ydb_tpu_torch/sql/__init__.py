from ydb_tpu_torch.sql.parser import parse  # noqa: F401
from ydb_tpu_torch.sql.planner import plan_select  # noqa: F401
