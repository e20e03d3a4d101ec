"""api/ — the port's protocol fronts: the PostgreSQL wire server
(``pgwire.py``) and the gRPC front (``server.py``, the client SDK in
``client.py``, Arrow IPC result sets in ``arrow_io.py``). The Kafka and
SQS fronts of the reference's ``ydb_tpu/api`` wait for ROADMAP.md queue
A item 11.

The gRPC pieces need ``grpc``, ``google.protobuf`` and ``pyarrow``;
``pgwire`` does not. Import them lazily so ``ydb_tpu_torch.api.pgwire``
works without those libraries.
"""


def __getattr__(name):
    if name in ("Driver", "ApiError"):
        from ydb_tpu_torch.api import client

        return getattr(client, name)
    if name == "make_server":
        from ydb_tpu_torch.api.server import make_server

        return make_server
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Driver", "ApiError", "make_server"]
