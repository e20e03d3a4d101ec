"""Failpoint plane: the typed error an injected fault raises.

The port's own copy of ``InjectedFault`` from
``ydb_tpu/runtime/failpoints.py``; the chaos plane's errors
(``ydb_tpu_torch/chaos``) subclass it. The rest of that module — the
``Failpoints`` registry with its always / nth / times / prob policies
and the ``FailpointBlobStore`` wrapper — waits for ROADMAP.md queue A
item 12, with the cluster plane that arms it.
"""

from __future__ import annotations


class InjectedFault(Exception):
    """The armed failpoint fired."""
