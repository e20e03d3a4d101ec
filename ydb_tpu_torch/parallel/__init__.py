from ydb_tpu_torch.parallel.mesh import make_mesh, shard_axis  # noqa: F401
from ydb_tpu_torch.parallel.dist import MeshScan  # noqa: F401
