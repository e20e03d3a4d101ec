"""Query processing: sessions and the cluster (``session.py``), the
cross-query batching dispatcher (``batch.py``), admission planes
(``rm.py``) and plan lowering to the DQ stage graph (``dq_lower.py``).

``Cluster`` and ``Session`` load on first use: the submodules import
the plan executor, and ``kqp.dq_lower`` must stay importable without
it."""


def __getattr__(name):
    if name in ("Cluster", "Session"):
        from ydb_tpu_torch.kqp import session

        return getattr(session, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Cluster", "Session"]
