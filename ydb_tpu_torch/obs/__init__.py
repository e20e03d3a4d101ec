"""Observability: counters, tracing spans, query profiles, metering, the
probe registry with the scan's per-stage timer, the data-movement
timeline, tablet counters, the kernel bench, the sys views and health
check (``sysview.py``), the monitoring HTTP viewer (``viewer.py``,
``viewer_html.py``) and the load-test service (``loadtest.py``)."""
