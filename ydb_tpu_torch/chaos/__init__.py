"""Statement deadlines (``deadline.py``); the fault-injection plane of
``ydb_tpu/chaos`` is not ported."""
