"""Shared CLI path collection for the analysis checkers.

Both ``python -m ydb_tpu_torch.analysis.lint`` and
``python -m ydb_tpu_torch.analysis.concurrency`` accept the same shape:

    python -m ydb_tpu_torch.analysis.<tool> [path ...] [--json] [--changed]

``--changed`` scopes the run to .py files touched in the working tree
(staged, unstaged, and untracked — what a pre-commit hook cares about),
intersected with the requested roots. When git is unavailable or the
tree is not a repository, the full requested roots are scanned instead:
a pre-commit fast path must degrade to the safe superset, never to a
silent no-op.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def default_root() -> Path:
    """The ydb_tpu_torch package directory (the default scan target)."""
    return Path(__file__).resolve().parents[1]


def expand_roots(paths) -> list:
    """Files/dirs -> sorted .py file list (dirs recurse)."""
    files: list = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    return files


def changed_py_files(repo_dir: Path) -> "list | None":
    """.py paths touched in the working tree per git, or None when git
    cannot answer (not a repo, git missing, command failure)."""
    out = []
    for args in (("diff", "--name-only", "HEAD"),
                 ("ls-files", "--others", "--exclude-standard")):
        try:
            proc = subprocess.run(
                ("git", "-C", str(repo_dir)) + args,
                capture_output=True, text=True, timeout=30, check=True)
        except (OSError, subprocess.SubprocessError):
            return None
        out.extend(proc.stdout.splitlines())
    root = _git_toplevel(repo_dir)
    if root is None:
        return None
    return [root / ln for ln in dict.fromkeys(out)
            if ln.endswith(".py")]


def _git_toplevel(repo_dir: Path) -> "Path | None":
    try:
        proc = subprocess.run(
            ("git", "-C", str(repo_dir), "rev-parse", "--show-toplevel"),
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    top = proc.stdout.strip()
    return Path(top) if top else None


def collect_files(argv_paths, changed: bool = False) -> list:
    """Resolve CLI path args (+ optional --changed scoping) to the .py
    file list a checker should scan."""
    roots = [Path(p) for p in argv_paths] or [default_root()]
    files = expand_roots(roots)
    if not changed:
        return files
    touched = changed_py_files(roots[0] if roots[0].is_dir()
                               else roots[0].parent)
    if touched is None:
        return files  # git unavailable: degrade to the full scan
    touched_set = {p.resolve() for p in touched}
    return [f for f in files if f.resolve() in touched_set]


def parse_cli(argv) -> tuple:
    """Split argv into (paths, as_json, changed); shared by both CLIs."""
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    changed = "--changed" in argv
    paths = [a for a in argv if not a.startswith("--")]
    return paths, as_json, changed
