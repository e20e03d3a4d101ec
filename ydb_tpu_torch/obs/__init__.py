"""Observability: the scan's per-stage timer (the rest of the reference's
``obs/`` waits for ROADMAP.md queue A item 7)."""
