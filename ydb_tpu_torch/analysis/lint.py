"""Capture-safety lint: AST checks for CUDA-graph-capture hazards.

The port's own copy of ``ydb_tpu/analysis/lint.py``, with "trace" read
as "CUDA graph capture". ``ssa/plan_fuse.py`` captures ``run_all`` (and
every lowering closure it calls) into a graph that replays without
Python; code that is harmless eagerly breaks the capture or the replay.
The hazards (each is a rule below):

  L001 host-sync-in-trace      ``.item()`` / ``.cpu()`` / ``.tolist()`` /
                               ``.numpy()``, ``int()``/``float()``/
                               ``bool()`` of a torch expression,
                               ``torch.nonzero`` / ``.nonzero()``, or
                               boolean-mask indexing (``t[t > 0]``)
                               inside a captured function: a device sync
                               (illegal while capturing; a stale host
                               value baked in at replay)
  L002 python-branch-on-traced ``if``/``while`` on a torch expression
                               (``torch.*`` or ``.any()``/``.all()``):
                               the branch is taken once, at capture, and
                               replays forever (static metadata
                               predicates like ``torch.is_floating_point``
                               are exempt)
  L003 wall-clock-in-trace     ``time.time()`` etc. inside captured code
                               bakes the clock of the capture into every
                               replay
  L004 unseeded-randomness     legacy ``np.random.*`` global RNG /
                               argless ``default_rng()`` / stdlib
                               ``random.*``: irreproducible plans
  L005 mutable-default-arg     ``def f(x=[])``: one shared list across
                               every call — a classic cache poisoner
  L006 set-iteration-order     iterating a set literal / ``set(...)``
                               feeds hash order into plan order; two
                               processes build different programs
  L007 block-in-trace          ``torch.cuda.synchronize()`` / the
                               ``.synchronize()`` method inside a
                               captured function: a capture cannot wait
                               on the device, and an eager run splits
                               the single dispatch into synchronized
                               fragments

"Captured" (trace-suspect) means a function whose own body calls
``torch.*`` and that is handed to the capture: named ``run_all``, a
nested def returned by its enclosing function (the plan-lowering emit
idiom), or a nested def passed as a call argument
(``CompiledProgram(run=run)``,
``FusedPlan(..., run_all, ...)``) — plus every function of a module
whose first ten lines carry ``# ydb-lint: capture-module``. L004-L006
apply everywhere.

Suppression: append ``# ydb-lint: disable=L001`` (or the rule name;
comma-separate several; ``all`` kills every rule) to the offending
line, or place it alone on the line above. ``# ydb-lint: skip-file``
within the first ten lines skips the file. (Shared machinery:
``analysis/suppress.py``.)

Run: ``python -m ydb_tpu_torch.analysis.lint [path ...] [--json]
[--changed]`` (default path: the ydb_tpu_torch package). Exit code 1 on
any unsuppressed finding.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import sys

from ydb_tpu_torch.analysis.paths import collect_files, parse_cli
from ydb_tpu_torch.analysis.suppress import file_skipped, filter_suppressed

RULES = {
    "L001": "host-sync-in-trace",
    "L002": "python-branch-on-traced",
    "L003": "wall-clock-in-trace",
    "L004": "unseeded-randomness",
    "L005": "mutable-default-arg",
    "L006": "set-iteration-order",
    "L007": "block-in-trace",
}
_TRACE_ROOTS = ("torch.",)
_CLOCK_CALLS = {
    "time.time", "time.monotonic", "time.perf_counter",
    "time.process_time", "time.time_ns", "time.monotonic_ns",
}
_STDLIB_RANDOM = {
    "random.random", "random.randint", "random.randrange",
    "random.choice", "random.choices", "random.shuffle",
    "random.sample", "random.uniform", "random.gauss",
}
#: host materializers: a torch call wrapped in one of these is an
#: EXPLICIT device->host transfer, not an accidental capture hazard
_MATERIALIZERS = {"int", "float", "bool", "len", "str", "repr"}
_MATERIALIZER_ROOTS = {"np.asarray", "np.array"}
#: tensor -> host methods (L001)
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
#: static METADATA predicates: they return plain Python values without
#: touching tensor data (dtype algebra, device queries) — branching on
#: them is fine
_STATIC_TORCH = {
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.iinfo", "torch.finfo", "torch.dtype", "torch.device",
    "torch.get_default_dtype", "torch.promote_types",
    "torch.result_type", "torch.cuda.is_available",
    "torch.cuda.current_stream", "torch.cuda.current_device",
    "torch.cuda.is_current_stream_capturing", "torch.Size",
}
#: tensor reductions whose truth value branches on data (L002)
_REDUCE_METHODS = {"any", "all"}
#: the module pragma that puts every function under capture
_CAPTURE_MODULE = "ydb-lint: capture-module"

@dataclasses.dataclass(frozen=True)
class Finding:
    file: str
    line: int
    col: int
    code: str
    name: str
    message: str

    def render(self) -> str:
        return (f"{self.file}:{self.line}:{self.col}: "
                f"{self.code} [{self.name}] {self.message}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _dotted(node) -> str:
    """Dotted name of an attribute/name chain ('' if not a plain one)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_trace_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    root = _dotted(node.func)
    if root in _STATIC_TORCH:
        return False
    return any(root.startswith(p) for p in _TRACE_ROOTS)


def _has_trace_call(node, *, through_materializers: bool) -> bool:
    """Does the subtree contain a torch call? With
    ``through_materializers`` False, subtrees under an explicit host
    materializer (int(...), np.asarray(...)) do not count."""
    if _is_trace_call(node):
        return True
    if not through_materializers and isinstance(node, ast.Call):
        fn = node.func
        if (isinstance(fn, ast.Name) and fn.id in _MATERIALIZERS) or \
                _dotted(fn) in _MATERIALIZER_ROOTS:
            return False
    return any(
        _has_trace_call(c, through_materializers=through_materializers)
        for c in ast.iter_child_nodes(node))


def _branches_on_tensor(test) -> bool:
    """A torch call (not under a materializer) or a data-dependent
    ``.any()``/``.all()`` in an if/while test."""
    if _has_trace_call(test, through_materializers=False):
        return True
    for sub in ast.walk(test):
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr in _REDUCE_METHODS and not sub.args:
            return True
    return False


def _is_mask_index(sl) -> bool:
    """A subscript whose index is a boolean mask expression (a
    comparison, its negation or a conjunction of them)."""
    if isinstance(sl, ast.Compare):
        return True
    if isinstance(sl, ast.UnaryOp) and isinstance(sl.op, ast.Invert):
        return _is_mask_index(sl.operand) or isinstance(
            sl.operand, (ast.Name, ast.Attribute, ast.Call))
    if isinstance(sl, ast.BinOp) and isinstance(
            sl.op, (ast.BitAnd, ast.BitOr)):
        return _is_mask_index(sl.left) or _is_mask_index(sl.right)
    return False


def _captured_names(tree) -> set:
    """Nested defs handed to the capture in their enclosing function: returned
    (bare or in a tuple) or passed as a call argument."""
    out: set = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        nested = {n.name for n in ast.walk(fn)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n is not fn}
        if not nested:
            continue
        for node in ast.walk(fn):
            vals = []
            if isinstance(node, ast.Return) and node.value is not None:
                vals = node.value.elts if isinstance(
                    node.value, (ast.Tuple, ast.List)) else [node.value]
            elif isinstance(node, ast.Call):
                vals = list(node.args) + [k.value for k in node.keywords]
            out.update(v.id for v in vals
                       if isinstance(v, ast.Name) and v.id in nested)
    return out


class _FunctionChecker(ast.NodeVisitor):
    """Per-function trace-hazard rules (L001-L003). Nested functions are
    handled by their own checker instance (a nested def is its own
    trace unit — lowering closures)."""

    def __init__(self, out: list, filename: str, fn: ast.AST):
        self.out = out
        self.filename = filename
        self.fn = fn

    def run(self):
        for stmt in self.fn.body:
            self.visit(stmt)

    def visit_FunctionDef(self, node):  # do not descend: own unit
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def _emit(self, node, code, message):
        self.out.append(Finding(
            self.filename, node.lineno, node.col_offset, code,
            RULES[code], message))

    def visit_Call(self, node: ast.Call):
        fn = node.func
        root = _dotted(fn)
        if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS \
                and not node.args and root not in _MATERIALIZER_ROOTS:
            self._emit(node, "L001",
                       f".{fn.attr}() forces a device sync inside captured"
                       " code (illegal while capturing; a stale value at"
                       " replay); keep values on device or materialize"
                       " once outside the capture")
        elif root == "torch.nonzero" or (
                isinstance(fn, ast.Attribute) and fn.attr == "nonzero"):
            self._emit(node, "L001",
                       "nonzero() sizes its output from the data: a"
                       " device sync inside captured code; use a"
                       " fixed-capacity compaction")
        if root == "torch.cuda.synchronize" or (
                isinstance(fn, ast.Attribute)
                and fn.attr == "synchronize"):
            self._emit(node, "L007",
                       "synchronize inside captured code: a capture"
                       " cannot wait on the device, and eagerly it splits"
                       " the single dispatch into synchronized fragments;"
                       " sync once outside (after the replay) instead")
        if (isinstance(fn, ast.Name) and fn.id in ("int", "float", "bool")
                or root in _MATERIALIZER_ROOTS):
            if any(_has_trace_call(a, through_materializers=True)
                   for a in node.args):
                what = root or fn.id
                self._emit(node, "L001",
                           f"{what}(...) over a torch expression"
                           " materializes a device value; hoist the"
                           " host conversion out of the captured"
                           " function")
        if root in _CLOCK_CALLS:
            self._emit(node, "L003",
                       f"{root}() inside captured code bakes the clock of"
                       " the capture into every replay; pass timestamps"
                       " in as arguments")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript):
        if isinstance(node.ctx, ast.Load) and _is_mask_index(node.slice):
            self._emit(node, "L001",
                       "boolean-mask indexing sizes its output from the"
                       " data: a device sync inside captured code; use"
                       " torch.where or a fixed-capacity compaction")
        self.generic_visit(node)

    def _check_branch(self, node, kind: str):
        if _branches_on_tensor(node.test):
            self._emit(node, "L002",
                       f"Python `{kind}` on a torch expression: the"
                       " branch is taken once, at capture, and replays"
                       " forever (and syncs eagerly); use torch.where /"
                       " masks instead")

    def visit_If(self, node):
        self._check_branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node):
        self._check_branch(node, "while")
        self.generic_visit(node)


class _ModuleChecker(ast.NodeVisitor):
    """Whole-file rules (L004-L006) + dispatch of trace-suspect
    functions to _FunctionChecker."""

    def __init__(self, filename: str, captured=(),
                 capture_module: bool = False):
        self.filename = filename
        self.out: list = []
        self.captured = set(captured)
        self.capture_module = capture_module

    def _emit(self, node, code, message):
        self.out.append(Finding(
            self.filename, node.lineno, node.col_offset, code,
            RULES[code], message))

    # ---- L005: mutable default arguments ----

    def _check_defaults(self, node):
        args = node.args
        for d in list(args.defaults) + [
                d for d in args.kw_defaults if d is not None]:
            bad = None
            if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                bad = type(d).__name__.lower()
            elif isinstance(d, ast.Call) and isinstance(d.func, ast.Name) \
                    and d.func.id in ("list", "dict", "set", "bytearray"):
                bad = f"{d.func.id}()"
            if bad is not None:
                self._emit(d, "L005",
                           f"mutable default argument {bad} is shared"
                           " across calls; default to None and build"
                           " inside the function")

    def visit_FunctionDef(self, node):
        self._check_defaults(node)
        handed = self.capture_module or node.name == "run_all" or \
            node.name in self.captured
        if handed and _has_trace_call(node, through_materializers=True):
            _FunctionChecker(self.out, self.filename, node).run()
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._check_defaults(node)
        self.generic_visit(node)

    # ---- L004: nondeterministic randomness ----

    def visit_Call(self, node):
        root = _dotted(node.func)
        if root.startswith("np.random.") or \
                root.startswith("numpy.random."):
            tail = root.split("random.", 1)[1]
            if tail == "default_rng":
                if not node.args and not node.keywords:
                    self._emit(node, "L004",
                               "default_rng() without a seed is"
                               " irreproducible; pass an explicit seed")
            elif tail not in ("Generator", "SeedSequence"):
                self._emit(node, "L004",
                           f"legacy global RNG np.random.{tail}(...) is"
                           " process-global state; use a seeded"
                           " np.random.default_rng(seed)")
        elif root in _STDLIB_RANDOM:
            self._emit(node, "L004",
                       f"{root}() uses the process-global stdlib RNG;"
                       " use a seeded random.Random(seed) instance")
        self.generic_visit(node)

    # ---- L006: set iteration order ----

    def _check_iter(self, node, it):
        bad = isinstance(it, ast.Set) or (
            isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
            and it.func.id in ("set", "frozenset"))
        if bad:
            self._emit(node, "L006",
                       "iterating a set: hash order is process-dependent"
                       " and would feed nondeterminism into trace/plan"
                       " order; iterate sorted(...) or a tuple")

    def visit_For(self, node):
        self._check_iter(node, node.iter)
        self.generic_visit(node)

    def visit_comprehension_generators(self, node):
        for gen in node.generators:
            self._check_iter(gen.iter, gen.iter)

    def visit_ListComp(self, node):
        self.visit_comprehension_generators(node)
        self.generic_visit(node)

    visit_SetComp = visit_ListComp
    visit_DictComp = visit_ListComp
    visit_GeneratorExp = visit_ListComp


def lint_source(src: str, filename: str = "<string>") -> list:
    """Lint one source text; returns unsuppressed findings sorted by
    position."""
    lines = src.splitlines()
    if file_skipped(lines):
        return []
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        return [Finding(filename, e.lineno or 0, e.offset or 0, "L000",
                        "syntax-error", str(e.msg))]
    checker = _ModuleChecker(
        filename, _captured_names(tree),
        any(_CAPTURE_MODULE in ln for ln in lines[:10]))
    checker.visit(tree)
    return filter_suppressed(checker.out, lines, RULES)


def lint_paths(paths, changed: bool = False) -> list:
    findings: list = []
    for f in collect_files(paths, changed=changed):
        findings.extend(
            lint_source(f.read_text(encoding="utf-8"), str(f)))
    return findings


def main(argv=None) -> int:
    paths, as_json, changed = parse_cli(argv)
    findings = lint_paths(paths, changed=changed)
    if as_json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
