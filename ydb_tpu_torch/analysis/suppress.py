"""Shared suppression machinery for the AST linters (lint + concurrency).

One syntax across every rule family:

  * ``# ydb-lint: disable=L001`` (or the rule name; comma-separate
    several; ``all`` kills every rule) on the offending line, or alone
    on the line above it
  * ``# ydb-lint: skip-file`` within the first ten lines skips the file

Both ``analysis/lint.py`` (L-rules) and ``analysis/concurrency.py``
(C-rules) filter their findings through :func:`filter_suppressed`
with their own rule tables, so a suppression names exactly the rule it
silences regardless of which checker emitted it.
"""

from __future__ import annotations

import re

_SUPPRESS_RE = re.compile(r"#\s*ydb-lint:\s*disable=([\w\-,]+)")
_SKIP_FILE_RE = re.compile(r"#\s*ydb-lint:\s*skip-file")


def suppressed_codes(line: str, rules: dict, name_to_code: dict) -> set:
    """Rule codes disabled by the trailing comment on ``line``."""
    m = _SUPPRESS_RE.search(line)
    if not m:
        return set()
    out: set = set()
    for tok in m.group(1).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok.lower() == "all":
            out.update(rules)
        elif tok.upper() in rules:
            out.add(tok.upper())
        elif tok.lower() in name_to_code:
            out.add(name_to_code[tok.lower()])
    return out


def file_skipped(lines: list) -> bool:
    """True when a skip-file pragma sits in the first ten lines."""
    return any(_SKIP_FILE_RE.search(ln) for ln in lines[:10])


def filter_suppressed(findings: list, lines: list, rules: dict) -> list:
    """Drop findings whose line (or the comment line above) carries a
    matching disable pragma. Findings must expose .line and .code and
    sort stably by position."""
    name_to_code = {v: k for k, v in rules.items()}
    kept = []
    for f in sorted(findings, key=lambda f: (f.line, f.col, f.code)):
        here = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        above = lines[f.line - 2] if 1 < f.line <= len(lines) + 1 else ""
        sup = suppressed_codes(here, rules, name_to_code)
        if above.strip().startswith("#"):
            sup |= suppressed_codes(above, rules, name_to_code)
        if f.code not in sup:
            kept.append(f)
    return kept
