"""The five tree analyzers of ``ydb_tpu_torch/analysis`` run clean over
the port's own tree (``ydb_tpu_torch/``), as the reference's
``tests/test_lint_clean.py``, ``test_concurrency_clean.py``,
``test_lifecycle_clean.py``, ``test_hotpath_clean.py`` and
``test_devmem_clean.py`` hold ``ydb_tpu/`` clean; every declared hot
root resolves (``tests/test_hotpath_clean.py:22-42``); and the unified
CLI, ``python -m ydb_tpu_torch.analysis``, exits 0.

A finding here means a change put a hazard into the port: fix the code,
or mark a deliberate site ``@analysis.host_ok("reason")`` /
``@analysis.budget_ok("reason")`` or with a ``# ydb-lint: disable=X00n``
pragma whose comment says why."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from ydb_tpu_torch.analysis import (concurrency, devmem, hotpath,
                                    lifecycle, lint)
from ydb_tpu_torch.analysis.paths import collect_files, default_root

PKG = Path(__file__).resolve().parents[1] / "ydb_tpu_torch"
REPO = PKG.parent

CHECKERS = {
    "lint": lambda files: [f for p in files for f in lint.lint_source(
        p.read_text(encoding="utf-8"), str(p))],
    "concurrency": concurrency.check_paths,
    "lifecycle": lifecycle.check_paths,
    "hotpath": hotpath.check_paths,
    "devmem": devmem.check_paths,
}


def test_default_root_is_the_port():
    assert default_root() == PKG


@pytest.mark.parametrize("stage", sorted(CHECKERS))
def test_port_tree_runs_clean(stage):
    findings = CHECKERS[stage](collect_files([PKG]))
    msg = "\n".join(f.render() for f in findings)
    assert findings == [], f"{len(findings)} {stage} finding(s):\n{msg}"


def test_every_declared_root_resolves():
    """Each HOT_ROOT names a real function of the port — a rename would
    otherwise shrink the corridor and the hotpath run above would pass
    vacuously."""
    modules = []
    for f in collect_files([PKG]):
        tree = ast.parse(f.read_text(encoding="utf-8"), filename=str(f))
        modules.append(hotpath._Module(
            hotpath._modname_for(str(f)), str(f), tree))
    index = hotpath._Index(modules)
    for suffix, qual in hotpath.HOT_ROOTS:
        m = index.by_suffix(suffix)
        assert m is not None, f"root module {suffix!r} not found"
        assert qual in m.fns, \
            f"root {qual!r} missing from {suffix!r} — renamed?"


def test_unified_cli_exits_zero_and_one(tmp_path):
    out = subprocess.run([sys.executable, "-m", "ydb_tpu_torch.analysis"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "total: 0 finding(s)" in out.stdout
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n"
                   "def build():\n"
                   "    def run_all(x):\n"
                   "        return torch.sum(x).item()\n"
                   "    return run_all\n")
    out = subprocess.run([sys.executable, "-m", "ydb_tpu_torch.analysis",
                          str(bad), "--json"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    assert '"L001"' in out.stdout
