"""Observability: counters, tracing spans, query profiles, metering, the
probe registry with the scan's per-stage timer, the data-movement
timeline, tablet counters and the kernel bench. The viewer and the sys
views wait for ROADMAP.md queue A item 9."""
