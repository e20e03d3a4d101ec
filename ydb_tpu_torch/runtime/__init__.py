from ydb_tpu_torch.runtime.actors import Actor, ActorSystem, ActorId  # noqa: F401
