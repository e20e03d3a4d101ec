from ydb_tpu_torch.ssa.ops import Op, Agg  # noqa: F401
from ydb_tpu_torch.ssa.program import (  # noqa: F401
    AggSpec,
    AssignStep,
    Call,
    Col,
    Const,
    DictPredicate,
    FilterStep,
    GroupByStep,
    ProjectStep,
    Program,
    SortStep,
)
from ydb_tpu_torch.ssa.compiler import compile_program  # noqa: F401
