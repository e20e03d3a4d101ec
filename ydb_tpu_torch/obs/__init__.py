"""Observability: counters, tracing spans, query profiles, metering and
the scan's per-stage timer. The timeline ring, the probes beyond
``StageTimer``, the kernel bench and the viewer wait for ROADMAP.md
queue A items 7 and 9."""
