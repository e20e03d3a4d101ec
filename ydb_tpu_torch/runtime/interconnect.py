"""The interconnect's undelivered-envelope notice.

Only ``Undelivered`` of ``ydb_tpu/runtime/interconnect.py`` is ported:
the DQ compute actors and the result collector react to it (a peer that
died with channel data in flight aborts the query). The TCP transport
between processes is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Undelivered:
    """Returned to the sender when a cross-node envelope could not be
    handed to the peer (connection refused / lost before flush)."""

    target: object  # ActorId
    message: Any
    reason: str
