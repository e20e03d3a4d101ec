"""Parity of the port's static analyzers (``ydb_tpu_torch/analysis``)
with the reference's (``ydb_tpu/analysis``).

- C-rules (``concurrency``), R-rules (``lifecycle``) and the
  backend-free L-rules L004-L006 (``lint``): every code snippet of the
  reference's own tests (``tests/test_concurrency_clean.py``,
  ``tests/test_lifecycle.py``, ``tests/test_lint_clean.py``) goes
  through both analyzers, which must report the same (rule, line) set.
- The rules the port restates for torch — L001-L003 and L007 (CUDA graph
  capture), H001 and H003 (torch syncs; captures, kernel builds,
  ``compile_program``), M001-M008 (torch creators; graph outputs, graph
  pools, capture shapes) — get torch snippets: one that fires and one
  that stays clean for each rule. H002 and H004-H006 are unchanged and
  get one pair each too.

Tolerance: none (sets compare exactly)."""

import ast
import textwrap
from pathlib import Path

import pytest

from ydb_tpu.analysis import concurrency as r_conc
from ydb_tpu.analysis import lifecycle as r_life
from ydb_tpu.analysis import lint as r_lint

from ydb_tpu_torch.analysis import concurrency as t_conc
from ydb_tpu_torch.analysis import devmem as t_devmem
from ydb_tpu_torch.analysis import hotpath as t_hot
from ydb_tpu_torch.analysis import lifecycle as t_life
from ydb_tpu_torch.analysis import lint as t_lint

TESTS = Path(__file__).resolve().parent


def _snippets(test_file: str) -> list:
    """Every string literal of a reference test file that parses as a
    module with a def, a class or an assignment: the test's snippets."""
    tree = ast.parse((TESTS / test_file).read_text(encoding="utf-8"))
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and "\n" in node.value):
            continue
        src = textwrap.dedent(node.value)
        try:
            mod = ast.parse(src)
        except SyntaxError:
            continue
        if any(isinstance(n, (ast.FunctionDef, ast.ClassDef, ast.Assign))
               for n in ast.walk(mod)) and src not in out:
            out.append(src)
    return out


CONC = _snippets("test_concurrency_clean.py")
LIFE = _snippets("test_lifecycle.py")
LINT = _snippets("test_lint_clean.py")


def _rule_lines(findings, codes=None) -> set:
    return {(f.code, f.line) for f in findings
            if codes is None or f.code in codes}


def test_snippets_were_found():
    assert len(CONC) >= 30 and len(LIFE) >= 20 and len(LINT) >= 10


@pytest.mark.parametrize("i", range(len(CONC)))
def test_concurrency_parity(i):
    src = CONC[i]
    ref = _rule_lines(r_conc.check_source(src, "t.py"))
    port = _rule_lines(t_conc.check_source(src, "t.py"))
    assert ref == port, src


@pytest.mark.parametrize("i", range(len(LIFE)))
def test_lifecycle_parity(i):
    src = LIFE[i]
    ref = _rule_lines(r_life.check_source(src, "t.py"))
    port = _rule_lines(t_life.check_source(src, "t.py"))
    assert ref == port, src


@pytest.mark.parametrize("i", range(len(LINT)))
def test_lint_backend_free_rules_parity(i):
    src = LINT[i]
    keep = {"L004", "L005", "L006"}
    ref = _rule_lines(r_lint.lint_source(src, "t.py"), keep)
    port = _rule_lines(t_lint.lint_source(src, "t.py"), keep)
    assert ref == port, src


# ---------------- the port's additions to C002 ----------------


def test_device_locks_join_the_lock_order_graph():
    """A module that takes ``device.work_lock`` then a class lock, and a
    class that takes them the other way round, form a cycle."""
    device = ("import threading\n"
              "class DeviceWorkLock:\n"
              "    pass\n"
              "work_lock = DeviceWorkLock()\n"
              "capture_lock = threading.RLock()\n")
    user = ("import threading\n"
            "from ydb_tpu_torch import device\n"
            "class Cache:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def fill(self):\n"
            "        with self._lock:\n"
            "            with device.work_lock.shared():\n"
            "                pass\n"
            "def dispatch(cache):\n"
            "    with device.work_lock.exclusive():\n"
            "        with device.capture_lock:\n"
            "            pass\n")
    other = ("from ydb_tpu_torch.device import capture_lock\n"
             "from ydb_tpu_torch import device\n"
             "def stage():\n"
             "    with capture_lock:\n"
             "        with device.work_lock.shared():\n"
             "            pass\n")
    got = t_conc.check_sources([(device, "device.py", "device"),
                                (user, "user.py", "user"),
                                (other, "other.py", "other")])
    cycles = [f for f in got if f.code == "C002"]
    assert cycles, got
    assert "device.capture_lock" in cycles[0].message and \
        "device.work_lock" in cycles[0].message
    # one order only: clean
    clean = t_conc.check_sources([(device, "device.py", "device"),
                                  (user, "user.py", "user")])
    assert not [f for f in clean if f.code == "C002"], clean


# ---------------- torch-restated lint rules ----------------


def _lint(src):
    return {f.code for f in t_lint.lint_source(textwrap.dedent(src))}


_CAPTURED = """\
import torch
def build(dev):
    def run_all(inputs, aux):
        x = torch.zeros(4, device=dev)
        {body}
        return x
    return run_all
"""
_HOST = """\
import torch
def fetch(x):
    y = torch.sum(x)
    {body}
    return y
"""

LINT_CASES = {
    "L001_item": ("y = x.sum().item()", "L001"),
    "L001_cpu": ("y = x.cpu()", "L001"),
    "L001_tolist": ("y = x.tolist()", "L001"),
    "L001_numpy": ("y = x.numpy()", "L001"),
    "L001_int_of_torch": ("n = int(torch.sum(x))", "L001"),
    "L001_nonzero": ("i = torch.nonzero(x)", "L001"),
    "L001_mask_index": ("y = x[x > 0]", "L001"),
    "L002_branch": ("if torch.any(x > 0):\n            x = x + 1", "L002"),
    "L002_any_method": ("while (x > 0).any():\n            x = x - 1",
                        "L002"),
    "L003_clock": ("import time\n        t = time.time()", "L003"),
    "L007_synchronize": ("torch.cuda.synchronize()", "L007"),
    "L007_event": ("ev = torch.cuda.Event()\n        ev.synchronize()",
                   "L007"),
}


@pytest.mark.parametrize("name", sorted(LINT_CASES))
def test_lint_torch_rule_fires_in_capture_and_not_on_host(name):
    body, code = LINT_CASES[name]
    assert code in _lint(_CAPTURED.format(body=body)), name
    host = _HOST.format(body=body.replace("        ", "    "))
    assert code not in _lint(host), name


def test_lint_static_torch_predicates_are_clean():
    assert _lint(_CAPTURED.format(
        body="if torch.is_floating_point(x):\n            x = x + 1")) \
        == set()
    assert _lint(_CAPTURED.format(body="x = torch.where(x > 0, x, 0)")) \
        == set()


def test_lint_capture_module_pragma():
    src = ("# ydb-lint: capture-module\n"
           "import torch\n"
           "def kernel(x):\n"
           "    return torch.sum(x).item()\n")
    assert _lint(src) == {"L001"}
    assert _lint(src.replace("# ydb-lint: capture-module\n", "")) == set()


def test_lint_returned_and_passed_closures_are_captured():
    returned = ("import torch\n"
                "def lower():\n"
                "    def emit(x):\n"
                "        return torch.sum(x).item()\n"
                "    return emit\n")
    passed = ("import torch\n"
              "def compile_it(make):\n"
              "    def run(x):\n"
              "        return torch.sum(x).item()\n"
              "    return make(run=run)\n")
    plain = ("import torch\n"
             "def outer(x):\n"
             "    def helper(y):\n"
             "        return torch.sum(y).item()\n"
             "    return helper(x)\n")
    assert _lint(returned) == {"L001"}
    assert _lint(passed) == {"L001"}
    assert _lint(plain) == set()


# ---------------- hotpath (H-rules) with torch roots ----------------

_SESSION = """\
import numpy as np
import torch
from ydb_tpu_torch.analysis import host_ok
class Session:
    def _execute_admitted(self, sql, x, cache):
        {body}
    @host_ok("deliberate")
    def _ok(self, x, cache):
        {body}
"""

HOT_CASES = {
    "H001_item": ("return x.sum().item()", "H001"),
    "H001_cpu": ("return x.cpu()", "H001"),
    "H001_to_cpu": ("return x.to('cpu')", "H001"),
    "H001_synchronize": ("torch.cuda.synchronize()", "H001"),
    "H001_event_sync": ("x.synchronize()", "H001"),
    "H002_fstring_key": ("return cache[f'k{sql}']", "H002"),
    "H003_capture": ("g = torch.cuda.CUDAGraph()", "H003"),
    "H003_graph_ctx": ("with torch.cuda.graph(x):\n            pass",
                       "H003"),
    "H003_compile_program": ("return compile_program(x)", "H003"),
    "H004_parse": ("return parse(sql)", "H004"),
    "H005_host_alloc": ("return np.zeros(8)", "H005"),
    "H006_row_loop": ("for row in x.rows:\n            pass", "H006"),
}


def _hot(body):
    return t_hot.check_source(_SESSION.format(body=body), "session.py",
                              modname="kqp.session")


@pytest.mark.parametrize("name", sorted(HOT_CASES))
def test_hotpath_rule_fires_on_the_warm_path_only(name):
    body, code = HOT_CASES[name]
    got = _hot(body)
    fired = [f for f in got if f.code == code]
    assert fired, (name, got)
    # the @host_ok twin of the same body is neither reported nor walked
    assert all("_ok" not in f.message.split("[warm path:")[1]
               for f in fired)
    assert all(f.line in (6, 7) for f in fired), fired


def test_hotpath_cuda_kernels_build_resolves_as_compile():
    src = ("from ydb_tpu_torch.ssa import cuda_kernels\n"
           "class Session:\n"
           "    def _execute_admitted(self, sql):\n"
           "        cuda_kernels.build()\n")
    got = t_hot.check_source(src, "session.py", modname="kqp.session")
    assert [f.code for f in got] == ["H003"]


def test_hotpath_clean_warm_corridor():
    src = ("import torch\n"
           "class Session:\n"
           "    def _execute_admitted(self, sql, x):\n"
           "        return torch.where(x > 0, x, 0)\n")
    assert t_hot.check_source(src, "session.py",
                              modname="kqp.session") == []


# ---------------- devmem (M-rules) with torch creators ----------------

DEVMEM_CASES = {
    "M001": ("""
        import torch
        def make(n, dev):
            return torch.zeros(64, device=dev)
        """, """
        import torch
        from ydb_tpu_torch.analysis import memsan
        def make(n, dev):
            with memsan.seam():
                t = torch.zeros(64, device=dev)
            memsan.charge(512, "staging")
            return t
        """),
    "M002": ("""
        def replay(cap):
            cap.graph.replay()
            return cap.out
        """, """
        def replay(cap):
            cap.graph.replay()
            return _clone_block(cap.out)
        """),
    "M003": ("""
        class Plan:
            def grow(self):
                self._graphs.clear()
        """, """
        class Plan:
            def grow(self):
                for cap in self._graphs.values():
                    cap.graph.reset()
                self._graphs.clear()
        """),
    "M004": ("""
        import torch
        from ydb_tpu_torch.analysis import memsan
        def stage(rows, dev):
            with memsan.seam():
                return torch.zeros(len(rows), device=dev)
        """, """
        import torch
        from ydb_tpu_torch.analysis import memsan
        def stage(rows, dev):
            with memsan.seam():
                return torch.zeros(shape_class(len(rows)), device=dev)
        """),
    "M005": ("""
        import torch
        from ydb_tpu_torch.analysis import memsan
        def go(pool, dev):
            with memsan.seam():
                t = torch.zeros(8, device=dev)
            pool.submit(lambda: t.sum())
        """, """
        import torch
        from ydb_tpu_torch.analysis import memsan
        def go(pool, dev):
            with memsan.seam():
                t = torch.zeros(8, device=dev)
            pool.submit(lambda: 1)
            return t
        """),
    "M006": ("""
        import torch
        from ydb_tpu_torch.analysis import memsan
        class Keep:
            def __init__(self):
                self._held = {}
            def put(self, k, dev):
                with memsan.seam():
                    self._held[k] = torch.zeros(8, device=dev)
        """, """
        import torch
        from ydb_tpu_torch.analysis import memsan
        class Keep:
            def __init__(self):
                self._held = {}
            def put(self, k, dev):
                with memsan.seam():
                    self._held[k] = torch.zeros(8, device=dev)
            def evict(self, k):
                self._held.pop(k, None)
        """),
    "M007": ("""
        import torch
        from ydb_tpu_torch.analysis import memsan
        def dispatch(aux, dev):
            with memsan.seam():
                return torch.as_tensor(aux["mask"], device=dev)
        """, """
        import torch
        from ydb_tpu_torch.analysis import memsan
        def device_aux(aux, dev):
            with memsan.seam():
                return torch.as_tensor(aux["mask"], device=dev)
        """),
    "M008": ("""
        import torch
        from ydb_tpu_torch.analysis import memsan
        def stream(n, dev):
            with memsan.seam():
                t = torch.zeros(8, device=dev)
            yield 1
            yield t.sum()
        """, """
        import torch
        from ydb_tpu_torch.analysis import memsan
        def stream(n, dev):
            yield 1
            with memsan.seam():
                t = torch.zeros(8, device=dev)
            yield t.sum()
        """),
}


def _devmem(src):
    return {f.code for f in t_devmem.check_source(textwrap.dedent(src))}


@pytest.mark.parametrize("code", sorted(DEVMEM_CASES))
def test_devmem_rule_fires_and_clean_twin_does_not(code):
    fires, clean = DEVMEM_CASES[code]
    assert code in _devmem(fires), _devmem(fires)
    assert code not in _devmem(clean), _devmem(clean)


def test_devmem_captured_closure_is_exempt():
    src = ("import torch\n"
           "def build(dev):\n"
           "    def run_all(inputs, aux):\n"
           "        return torch.zeros(len(inputs), device=dev)\n"
           "    return run_all\n")
    assert _devmem(src) == set()


def test_devmem_dtype_to_is_not_a_creator():
    src = ("import torch\n"
           "def f(x):\n"
           "    return x.to(torch.int64), x.to(x.dtype), x.to('cpu')\n")
    assert _devmem(src) == set()
    moved = ("def f(x, dev):\n"
             "    return x.to(dev)\n")
    assert _devmem(moved) == {"M001"}
