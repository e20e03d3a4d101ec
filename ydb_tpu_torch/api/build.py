"""The gRPC front's protobuf messages.

The reference generates ``ydb_tpu/api/_gen`` with ``protoc`` when its
server or client is first imported (``ydb_tpu/api/build.py``), so it
fails on a host without ``protoc``. The port keeps its generated module
in the repo instead: ``_gen/ydb_tpu_api_pb2.py`` is ``protoc``'s output
for ``protos/ydb_tpu_api.proto`` (a byte-for-byte copy of the
reference's, same file name, same ``package ydb_tpu``), and nothing here
runs ``protoc``. Regenerate it after editing the ``.proto``:

    cd ydb_tpu_torch/api && protoc --python_out=_gen \\
        --proto_path=protos ydb_tpu_api.proto

The two packages register the same serialized file in protobuf's
default descriptor pool, which accepts an identical file twice, so both
share one set of message classes and talk to each other over the wire
(the method paths ``/ydb_tpu.<Service>/<Rpc>`` are the reference's).
"""

from __future__ import annotations

import importlib
import os

_DIR = os.path.dirname(os.path.abspath(__file__))
PROTO = os.path.join(_DIR, "protos", "ydb_tpu_api.proto")
GEN = os.path.join(_DIR, "_gen", "ydb_tpu_api_pb2.py")


def ensure_protos():
    """The generated message module (imported, never generated)."""
    return importlib.import_module("ydb_tpu_torch.api._gen.ydb_tpu_api_pb2")
