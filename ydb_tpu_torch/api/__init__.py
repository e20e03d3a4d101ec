"""api/ — the port's protocol fronts: the PostgreSQL wire server
(``pgwire.py``) and the gRPC front (``server.py``, the client SDK in
``client.py``, Arrow IPC result sets in ``arrow_io.py``), and the Kafka
(``kafka.py``) and SQS (``sqs.py``) fronts over the cluster's topics.

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
