"""Structured plan-time diagnostics (the port's copy of
``ydb_tpu/analysis/diagnostics.py``).

The reference rejects malformed scan programs at parse time with typed
statuses (TProgramContainer::Init, ydb/core/tx/program/program.cpp:553);
trace-time failure is too late for a production front end — the user
gets an opaque shape error instead of "step 3 filters on a non-bool
expression". This module is the shared vocabulary: a ``Diagnostic`` is
one finding (error code, step index, expression path, message, fix
hint), and ``VerificationError`` carries a batch of them as a
``PlanError`` so every existing SQL-surface error handler keeps working.

``PlanError`` itself lives here so the analysis layer does not depend on the SQL
layer. This module has no imports of the package at all — it sits below
everything.
"""

from __future__ import annotations

import dataclasses


class PlanError(Exception):
    """A statement that can never execute: planning/verification reject.

    Defined here so the static analysis layer can raise it without
    importing a SQL planner.
    """


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One static-analysis finding against a program or source tree.

    ``step`` is the index into ``Program.steps`` (None for
    program-level findings); ``path`` locates the offending expression
    within the step (e.g. ``steps[2].expr.args[1]``).
    """

    code: str            # stable machine code, e.g. "V001"
    name: str            # kebab-case rule name, e.g. "unknown-column"
    message: str
    step: int | None = None
    path: str = ""
    hint: str = ""
    severity: str = "error"  # error | warning

    def render(self) -> str:
        loc = f"step {self.step}" if self.step is not None else "program"
        if self.path:
            loc += f" ({self.path})"
        out = f"{self.code} {self.name} @ {loc}: {self.message}"
        if self.hint:
            out += f" [hint: {self.hint}]"
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class VerificationError(PlanError):
    """A program failed static verification. Carries every error-level
    ``Diagnostic`` so callers (and tests) can assert on step index and
    code rather than parsing the message."""

    def __init__(self, diagnostics):
        self.diagnostics = tuple(diagnostics)
        super().__init__(
            "program verification failed:\n"
            + "\n".join("  " + d.render() for d in self.diagnostics)
        )
