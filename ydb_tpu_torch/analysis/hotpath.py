"""Dispatch-purity static analyzer: warm-path host-work rules H001-H006.

The port's own copy of ``ydb_tpu/analysis/hotpath.py``, with torch's
host boundary. The warm statement path — plan-cache hit, compile-cache
hit, resident inputs — should be a thin corridor from SQL text to one
device dispatch (a CUDA graph replay for a fused plan); every
``.item()``, numpy allocation or stray capture on that corridor is a
host round trip multiplied by QPS. This pass walks the corridor
statically; the runtime half (``analysis/syncsan.py``) counts what
actually crossed the boundary per statement.

Unlike the whole-tree linters (lint/concurrency/lifecycle), this
analyzer is PATH-SCOPED: it builds an interprocedural call graph from
the declared hot-path roots and only judges code reachable from them.
Cold paths (boot, DDL, compaction, the compile itself) may do all the
host work they like.

Roots (the warm statement corridor, one per layer):

  kqp.session   Session._execute_admitted   warm execute
  kqp.batch     BatchDispatcher.execute     micro-batched dispatch
  ssa.compiler  CompiledProgram.__call__    cached-program call
  engine.scan   ScanExecutor.run_stream     block-streamed fast path
  engine.resident  ResidentStore.lookup     device-resident lookup

Rules:

  H001 device-sync-in-dispatch  ``.item()`` / ``.cpu()`` / ``.tolist()`` /
                                ``.numpy()`` / ``.to("cpu")``,
                                ``torch.cuda.synchronize``,
                                ``Event.synchronize`` /
                                ``Stream.synchronize``, ``np.asarray`` /
                                ``.to_numpy()`` on the warm path — a
                                blocking device->host round trip per
                                statement
  H002 unstable-cache-key       a cache subscript/get keyed by a
                                runtime-formatted string (f-string,
                                ``.format``, ``%``) or ``id(...)``
  H003 per-dispatch-compile     a CUDA graph capture
                                (``torch.cuda.CUDAGraph``,
                                ``torch.cuda.graph``), a kernel build
                                (``cuda_kernels.build``) or
                                ``compile_program`` reachable on the warm
                                path — each must hide behind a cache,
                                never run per dispatch
  H004 per-dispatch-plan        ``parse`` / ``plan_select*`` /
                                ``plan_signature`` on the warm path
  H005 host-alloc-in-dispatch   ``np.zeros``/``np.empty``/
                                ``np.concatenate``/... — host array
                                allocation inside the dispatch loop
  H006 python-row-loop          a Python ``for`` over rows/blocks
                                (``range(len(...))``, ``.tolist()``,
                                any name containing row/block)

Escape hatch: decorate a function with ``@analysis.host_ok("reason")``
(or bare ``@host_ok``) to declare its host work deliberate — the lazy
result fetch, a cache-miss compile helper. The function is neither
reported nor descended into. Line-level ``# ydb-lint: disable=H001``
pragmas (shared suppress machinery) silence individual sites; for
those the walker still stops at compile/plan boundary calls (their
bodies are cold by definition).

Run: ``python -m ydb_tpu_torch.analysis.hotpath [path ...] [--json]
[--changed]``. Default path: the ydb_tpu_torch package. Exit 1 on any
unsuppressed finding.
"""

from __future__ import annotations

import ast
import json
import sys

from ydb_tpu_torch.analysis.lint import Finding, _dotted, _has_trace_call
from ydb_tpu_torch.analysis.paths import collect_files, parse_cli
from ydb_tpu_torch.analysis.suppress import file_skipped, filter_suppressed

RULES = {
    "H001": "device-sync-in-dispatch",
    "H002": "unstable-cache-key",
    "H003": "per-dispatch-compile",
    "H004": "per-dispatch-plan",
    "H005": "host-alloc-in-dispatch",
    "H006": "python-row-loop",
}

#: (module-path suffix, ClassName.method) — the declared warm roots
HOT_ROOTS = (
    ("kqp.session", "Session._execute_admitted"),
    ("kqp.batch", "BatchDispatcher.execute"),
    ("ssa.compiler", "CompiledProgram.__call__"),
    ("engine.scan", "ScanExecutor.run_stream"),
    ("engine.resident", "ResidentStore.lookup"),
)

#: device->host sync call roots (H001)
_SYNC_ROOTS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
               "torch.cuda.synchronize"}
#: method names that fetch to the host or wait on the device (H001)
_FETCH_METHODS = {"to_numpy", "host_columns", "validity_numpy",
                  "cpu", "tolist", "numpy", "synchronize"}
#: compile-family (H003): the call is the finding, the body is cold
_COMPILE_ROOTS = {"torch.cuda.CUDAGraph", "torch.cuda.graph",
                  "cuda_kernels.build", "torch.cuda.make_graphed_callables"}
_COMPILE_NAMES = {"compile_program"}
#: planning-family (H004)
_PLAN_NAMES = {"parse", "plan_select", "plan_select_full",
               "plan_signature"}
#: host allocators + per-dispatch device staging (H005)
_ALLOC_ROOTS = {"np.zeros", "np.empty", "np.ones", "np.full",
                "np.arange", "np.concatenate", "np.stack", "np.copy",
                "numpy.zeros", "numpy.empty", "numpy.concatenate",
                "jnp.asarray", "jnp.array", "jax.numpy.asarray"}

#: method names too generic for the unique-method fallback — they
#: collide with dict/list/str/stdlib methods and would wire unrelated
#: classes into the call graph (``self.aux.items()`` is not
#: ``StreamScheduler.items``)
_GENERIC_METHODS = {
    "items", "keys", "values", "get", "set", "pop", "add", "append",
    "extend", "update", "clear", "copy", "close", "open", "read",
    "write", "run", "start", "stop", "put", "join", "split", "strip",
    "format", "encode", "decode", "sort", "index", "count", "remove",
    "insert", "send", "result", "done", "wait", "acquire", "release",
    "submit", "shutdown", "flush", "seek", "tell", "name",
}


def _to_host(call: ast.Call) -> bool:
    """``t.to("cpu")`` / ``t.to(device="cpu")``: a device->host copy."""
    vals = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
        if isinstance(v, ast.Call) and _dotted(v.func) == "torch.device" \
                and v.args and isinstance(v.args[0], ast.Constant) and \
                v.args[0].value == "cpu":
            return True
    return False


def _host_ok_reason(node) -> "str | None":
    """The reason string of an ``@analysis.host_ok("...")`` decorator
    (or bare ``@host_ok``); None when the function carries none."""
    for dec in getattr(node, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        # match host_ok, analysis.host_ok and underscore-aliased
        # imports (_host_ok) alike
        last = _dotted(target).rsplit(".", 1)[-1].lstrip("_")
        if last == "host_ok":
            if isinstance(dec, ast.Call) and dec.args and \
                    isinstance(dec.args[0], ast.Constant):
                return str(dec.args[0].value)
            return "unspecified"
    return None


class _FnInfo:
    """One indexed function/method: AST + location + host_ok status."""

    __slots__ = ("modname", "qualname", "cls", "node", "filename",
                 "host_ok")

    def __init__(self, modname, qualname, cls, node, filename):
        self.modname = modname
        self.qualname = qualname
        self.cls = cls              # enclosing class name or None
        self.node = node
        self.filename = filename
        self.host_ok = _host_ok_reason(node)


class _Module:
    """Per-module symbol table: functions, classes and import aliases."""

    def __init__(self, modname: str, filename: str, tree):
        self.modname = modname
        self.filename = filename
        self.fns: dict[str, _FnInfo] = {}     # qualname -> info
        self.classes: set[str] = set()
        self.imports: dict[str, str] = {}     # alias -> dotted origin
        for st in tree.body:
            self._top(st)
        # imports inside function bodies count too (the repo defers
        # heavy imports into the statement path deliberately)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._imp(node)

    def _top(self, st) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.fns[st.name] = _FnInfo(
                self.modname, st.name, None, st, self.filename)
        elif isinstance(st, ast.ClassDef):
            self.classes.add(st.name)
            for sub in st.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    q = f"{st.name}.{sub.name}"
                    self.fns[q] = _FnInfo(
                        self.modname, q, st.name, sub, self.filename)

    def _imp(self, node) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                self.imports[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                self.imports[a.asname or a.name] = \
                    f"{node.module}.{a.name}"


class _Index:
    """Cross-module function index for call resolution."""

    def __init__(self, modules: list[_Module]):
        self.modules = {m.modname: m for m in modules}
        # method name -> [infos] for the unique-method fallback
        self.methods: dict[str, list] = {}
        for m in modules:
            for info in m.fns.values():
                if info.cls is not None:
                    self.methods.setdefault(
                        info.node.name, []).append(info)

    def by_suffix(self, suffix: str) -> "_Module | None":
        for name, m in self.modules.items():
            if name == suffix or name.endswith("." + suffix):
                return m
        return None

    def resolve_from(self, origin: str) -> "_FnInfo | None":
        """Resolve an import origin ``pkg.mod.func`` to an indexed
        module-level function."""
        mod, _, name = origin.rpartition(".")
        m = self.modules.get(mod)
        if m is None:
            # the index stores short module paths ("kqp.session") when
            # scanning a package subtree; try suffix-matching
            for k, cand in self.modules.items():
                if mod == k or mod.endswith("." + k) or \
                        k.endswith("." + mod):
                    m = cand
                    break
        if m is None:
            return None
        info = m.fns.get(name)
        if info is not None and info.cls is None:
            return info
        return None

    def unique_method(self, name: str) -> "_FnInfo | None":
        """The one scanned class method with this name (None when the
        name is ambiguous — each layer then needs its own root — or
        generic enough to collide with stdlib container methods)."""
        if name in _GENERIC_METHODS or name.startswith("__"):
            return None
        infos = self.methods.get(name, ())
        return infos[0] if len(infos) == 1 else None


class _WarmVisitor(ast.NodeVisitor):
    """Hazard rules over ONE warm function body. Nested defs are
    visited too: a closure defined on the dispatch path (staging
    thunks, distribution callbacks) runs on the dispatch path."""

    def __init__(self, out: list, info: _FnInfo, chain: str,
                 callees: list):
        self.out = out
        self.info = info
        self.chain = chain
        self.callees = callees  # raw call nodes for the walker

    def run(self) -> None:
        for stmt in self.info.node.body:
            self.visit(stmt)

    def _emit(self, node, code: str, message: str) -> None:
        self.out.append(Finding(
            self.info.filename, node.lineno, node.col_offset, code,
            RULES[code], f"{message} [warm path: {self.chain}]"))

    # ---- calls: H001 / H003 / H004 / H005 + callee collection ----

    def visit_Call(self, node: ast.Call):
        fn = node.func
        root = _dotted(fn)
        attr = fn.attr if isinstance(fn, ast.Attribute) else ""
        if attr == "item" and not node.args:
            self._emit(node, "H001",
                       ".item() blocks on the device per statement;"
                       " keep the value device-resident or fetch once"
                       " at the result boundary")
        elif root in _SYNC_ROOTS or (
                attr in _FETCH_METHODS and not (
                    attr == "synchronize" and node.args)) or (
                attr == "to" and _to_host(node)):
            what = root or f".{attr}()"
            self._emit(node, "H001",
                       f"{what} forces a device->host transfer on the"
                       " warm path; results should stay on device"
                       " until the deliberate fetch (mark that site"
                       " @analysis.host_ok)")
        elif isinstance(fn, ast.Name) and \
                fn.id in ("int", "float", "bool") and any(
                    _has_trace_call(a, through_materializers=True)
                    for a in node.args):
            self._emit(node, "H001",
                       f"{fn.id}(...) over a device expression"
                       " materializes per statement; hoist the"
                       " conversion out of the dispatch loop")
        # ``.capture_begin`` starts a CUDA graph capture by hand
        compile_method = attr == "capture_begin"
        if root in _COMPILE_ROOTS or root in _COMPILE_NAMES or \
                compile_method:
            self._emit(node, "H003",
                       f"compile call {root or attr}(...) reachable on"
                       " the warm path: compilation must hide behind"
                       " the compile cache (mark the guarded miss-path"
                       " helper @analysis.host_ok)")
            return  # the compile body is cold; do not descend
        if (isinstance(fn, ast.Name) and fn.id in _PLAN_NAMES) or \
                attr in _PLAN_NAMES:
            self._emit(node, "H004",
                       f"planning call {root or attr}(...) reachable"
                       " on the warm path: parse/plan must hide behind"
                       " the plan cache")
            return  # the planner body is cold; do not descend
        if root in _ALLOC_ROOTS:
            self._emit(node, "H005",
                       f"{root}(...) allocates a host array per"
                       " statement; stage once at plan/compile time or"
                       " keep the buffer device-resident")
        self.callees.append(node)
        self.generic_visit(node)

    # ---- H002: string-formatted cache keys ----

    @staticmethod
    def _formats_at_runtime(expr) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.JoinedStr):
                return True
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Attribute) and f.attr == "format":
                    return True
                if isinstance(f, ast.Name) and f.id == "id":
                    return True
            if isinstance(sub, ast.BinOp) and \
                    isinstance(sub.op, ast.Mod) and \
                    isinstance(sub.left, ast.Constant) and \
                    isinstance(sub.left.value, str):
                return True
        return False

    def _check_cache_key(self, node, recv, key_expr) -> None:
        name = _dotted(recv)
        if "cache" not in name.lower():
            return
        if self._formats_at_runtime(key_expr):
            self._emit(node, "H002",
                       f"cache {name} keyed by a runtime-formatted"
                       " string / id(): text keys embed shapes and"
                       " identities unstably (retrace or permanent"
                       " miss per shape); key on a structured tuple of"
                       " hashable plan-time values")

    def visit_Subscript(self, node: ast.Subscript):
        self._check_cache_key(node, node.value, node.slice)
        self.generic_visit(node)

    # ---- H006: row/block loops ----

    @staticmethod
    def _rowish(it) -> "str | None":
        for sub in ast.walk(it):
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Attribute) and f.attr == "tolist":
                    return ".tolist()"
                if isinstance(f, ast.Name) and f.id == "range" and \
                        sub.args and isinstance(sub.args[0], ast.Call) \
                        and isinstance(sub.args[0].func, ast.Name) \
                        and sub.args[0].func.id == "len":
                    return "range(len(...))"
            name = ""
            if isinstance(sub, ast.Name):
                name = sub.id
            elif isinstance(sub, ast.Attribute):
                name = sub.attr
            low = name.lower()
            if "row" in low or "block" in low:
                return name
        return None

    def visit_For(self, node: ast.For):
        why = self._rowish(node.iter)
        if why is not None:
            self._emit(node, "H006",
                       f"Python for-loop over {why} on the warm path:"
                       " per-row/per-block interpreter work multiplies"
                       " by statement rate; vectorize on device or"
                       " bound and justify it with a pragma")
        self.generic_visit(node)

    visit_AsyncFor = visit_For

    # cache .get/.setdefault calls are Calls — hook them off the same
    # visit_Call traffic via generic inspection
    def generic_visit(self, node):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("get", "setdefault") and node.args:
            self._check_cache_key(node, node.func.value, node.args[0])
        super().generic_visit(node)


class _Walker:
    """Interprocedural BFS from the declared roots."""

    def __init__(self, index: _Index, roots):
        self.index = index
        self.roots = roots
        self.findings: list = []
        self.seen: set = set()

    def run(self) -> list:
        queue: list = []
        for suffix, qual in self.roots:
            m = self.index.by_suffix(suffix)
            if m is None:
                continue
            info = m.fns.get(qual)
            if info is not None:
                queue.append((info, qual))
        while queue:
            info, chain = queue.pop(0)
            key = (info.modname, info.qualname)
            if key in self.seen:
                continue
            self.seen.add(key)
            if info.host_ok is not None:
                continue  # declared deliberate: no report, no descent
            callees: list = []
            _WarmVisitor(self.findings, info, chain, callees).run()
            for call in callees:
                target = self._resolve(info, call)
                if target is None or target.host_ok is not None:
                    continue
                tkey = (target.modname, target.qualname)
                if tkey not in self.seen:
                    queue.append(
                        (target, f"{chain} -> {target.qualname}"))
        return self.findings

    def _resolve(self, info: _FnInfo, call: ast.Call) -> "_FnInfo | None":
        fn = call.func
        mod = self.index.modules[info.modname]
        if isinstance(fn, ast.Name):
            name = fn.id
            if name in mod.classes:
                return None  # constructors are setup, not dispatch
            local = mod.fns.get(name)
            if local is not None and local.cls is None:
                return local
            origin = mod.imports.get(name)
            if origin is not None:
                return self.index.resolve_from(origin)
            return None
        if not isinstance(fn, ast.Attribute):
            return None
        # self.m(...) -> same-class method first
        recv = fn.value
        if isinstance(recv, ast.Name) and recv.id == "self" and \
                info.cls is not None:
            local = mod.fns.get(f"{info.cls}.{fn.attr}")
            if local is not None:
                return local
        # module_alias.f(...)
        if isinstance(recv, ast.Name):
            origin = mod.imports.get(recv.id)
            if origin is not None:
                return self.index.resolve_from(f"{origin}.{fn.attr}")
        # anything else: follow only when the method name is unique
        # across every scanned class (each layer's entry is otherwise
        # its own declared root)
        return self.index.unique_method(fn.attr)


# ---------------- entry points ----------------


def _modname_for(filename: str) -> str:
    """Dotted module path relative to the ydb_tpu_torch package
    ("kqp.session" for .../ydb_tpu_torch/kqp/session.py); the bare stem
    otherwise."""
    from pathlib import PurePath

    parts = list(PurePath(filename).parts)
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    for anchor in range(len(parts) - 1, -1, -1):
        if parts[anchor] == "ydb_tpu_torch":
            return ".".join(parts[anchor + 1:])
    return parts[-1] if parts else filename


def check_sources(sources, roots=HOT_ROOTS,
                  report_files=None) -> list:
    """Analyze (src, filename, modname) triples as one program; modname
    None derives the dotted path from the filename. Returns
    unsuppressed findings sorted by position. ``report_files`` (a set
    of filenames) restricts REPORTING without shrinking the call-graph
    index — a path-scoped analyzer must always resolve against the
    whole program, or a file subset makes ambiguous methods look
    unique and the walker wanders into cold code."""
    findings: list = []
    modules: list = []
    lines_by_file: dict = {}
    for src, filename, modname in sources:
        lines = src.splitlines()
        lines_by_file[filename] = lines
        if file_skipped(lines):
            continue
        try:
            tree = ast.parse(src, filename=filename)
        except SyntaxError as e:
            findings.append(Finding(
                filename, e.lineno or 0, e.offset or 0, "H000",
                "syntax-error", str(e.msg)))
            continue
        modules.append(_Module(
            modname if modname is not None else _modname_for(filename),
            filename, tree))
    index = _Index(modules)
    findings.extend(_Walker(index, roots).run())
    kept: list = []
    for filename, lines in lines_by_file.items():
        if report_files is not None and filename not in report_files:
            continue
        here = [f for f in findings if f.file == filename]
        kept.extend(filter_suppressed(here, lines, RULES))
    return sorted(kept, key=lambda f: (f.file, f.line, f.col, f.code))


def check_source(src: str, filename: str = "<string>",
                 modname: "str | None" = None,
                 roots=HOT_ROOTS) -> list:
    """Analyze one source text (tests)."""
    return check_sources([(src, filename, modname)], roots=roots)


def check_paths(paths, roots=HOT_ROOTS, report_files=None) -> list:
    sources = []
    for f in paths:
        sources.append((f.read_text(encoding="utf-8"), str(f), None))
    return check_sources(sources, roots=roots,
                         report_files=report_files)


def main(argv=None) -> int:
    paths, as_json, changed = parse_cli(argv)
    # index the FULL requested roots always; --changed only narrows
    # which files findings are reported for (see check_sources)
    files = collect_files(paths)
    report = None
    if changed:
        report = {str(f) for f in collect_files(paths, changed=True)}
    findings = check_paths(files, report_files=report)
    if as_json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
