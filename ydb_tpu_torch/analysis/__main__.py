"""Unified analyzer entrypoint: every pillar, one command.

    python -m ydb_tpu_torch.analysis [path ...] [--json] [--changed]

The port's own copy of ``ydb_tpu/analysis/__main__.py``, over the
``ydb_tpu_torch`` tree by default.

Runs the six static pillars in order over a single shared CLI surface
(``paths.py`` collection + ``suppress.py`` pragmas):

  verify       SSA program checker self-test — the one pillar that
               checks programs, not files, so here it proves the
               checker itself is alive: a clean program must produce
               zero diagnostics and a known-bad one must be rejected
  lint         L-rules (capture hazards)        — lint.py
  concurrency  C-rules (lock/guard discipline)  — concurrency.py
  lifecycle    R-rules (acquire/release pairing) — lifecycle.py
  hotpath      H-rules (dispatch purity)        — hotpath.py
  devmem       M-rules (device-memory budget)   — devmem.py

Exit status 1 when ANY stage reports findings, so CI and developers
invoke exactly one command. Per-tool runs stay available
(``python -m ydb_tpu_torch.analysis.lint`` etc.) for focused iteration.
"""

from __future__ import annotations

import json
import sys

from ydb_tpu_torch.analysis import (concurrency, devmem, hotpath, lifecycle,
                              lint)
from ydb_tpu_torch.analysis.paths import collect_files, parse_cli


def _verify_selftest() -> list:
    """Prove the SSA verifier accepts a clean program and rejects a
    defective one. Returns findings-shaped dicts (file/line/col/code/
    name/message) so the JSON surface matches the AST checkers."""
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.analysis.verify import verify_program
    from ydb_tpu_torch.ssa import AssignStep, Call, Col, Op, Program
    from ydb_tpu_torch.ssa.program import lit

    sch = dtypes.schema(("a", dtypes.INT64, False))
    clean = Program((
        AssignStep("c", Call(Op.ADD, Col("a"), lit(1))),
    ))
    bad = Program((
        AssignStep("c", Call(Op.ADD, Col("nope"), lit(1))),
    ))
    out = []
    diags = verify_program(clean, sch)
    if diags:
        out.append({
            "file": "<verify-selftest>", "line": 0, "col": 0,
            "code": "V900", "name": "verify-selftest",
            "message": "clean program rejected: "
                       + "; ".join(d.code for d in diags),
        })
    if not verify_program(bad, sch):
        out.append({
            "file": "<verify-selftest>", "line": 0, "col": 0,
            "code": "V901", "name": "verify-selftest",
            "message": "defective program (unknown column) accepted",
        })
    return out


def run_all(paths=(), changed: bool = False) -> dict:
    """All six pillars over one collected file list. Returns
    ``{stage: [finding dict, ...]}`` in run order."""
    files = collect_files(list(paths), changed=changed)
    lint_findings: list = []
    for p in files:
        lint_findings.extend(
            lint.lint_source(p.read_text(encoding="utf-8"), str(p)))
    # the hotpath walker is path-scoped: its call-graph index must
    # always cover the full roots — under --changed it only narrows
    # which files findings are REPORTED for, else a file subset makes
    # ambiguous methods look unique and the walk enters cold code
    hot_files = files
    hot_report = None
    if changed:
        hot_files = collect_files(list(paths))
        hot_report = {str(f) for f in files}
    return {
        "verify": _verify_selftest(),
        "lint": [f.to_dict() for f in lint_findings],
        "concurrency": [f.to_dict()
                        for f in concurrency.check_paths(files)],
        "lifecycle": [f.to_dict()
                      for f in lifecycle.check_paths(files)],
        "hotpath": [f.to_dict() for f in hotpath.check_paths(
            hot_files, report_files=hot_report)],
        # devmem is interprocedural like hotpath: same full-index /
        # narrowed-reporting split under --changed, else a charging
        # caller outside the changed set can't cover its helper
        "devmem": [f.to_dict() for f in devmem.check_paths(
            hot_files, report_files=hot_report)],
    }


def format_findings(stages: dict) -> str:
    """Readable multi-finding summary for clean-tree assertions: every
    finding on its own ``file:line:col: CODE [name] message`` line,
    grouped by stage, instead of one opaque repr of the whole dict."""
    out = []
    for stage, findings in stages.items():
        if not findings:
            continue
        out.append(f"{stage}: {len(findings)} finding(s)")
        for f in findings:
            out.append(f"  {f['file']}:{f['line']}:{f['col']}: "
                       f"{f['code']} [{f['name']}] {f['message']}")
    return "\n".join(out) if out else "no findings"


def main(argv=None) -> int:
    paths, as_json, changed = parse_cli(argv)
    stages = run_all(paths, changed=changed)
    total = sum(len(v) for v in stages.values())
    if as_json:
        print(json.dumps(stages, indent=2))
        return 1 if total else 0
    for stage, findings in stages.items():
        for f in findings:
            print(f"{f['file']}:{f['line']}:{f['col']}: "
                  f"{f['code']} [{f['name']}] {f['message']}")
        print(f"{stage}: {len(findings)} finding(s)")
    print(f"total: {total} finding(s)")
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
