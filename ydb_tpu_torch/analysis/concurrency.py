"""Concurrency-discipline static analyzer: lock/guard rules C001-C008.

The runtime replaced the reference's actors with real threads — the
shared conveyor pool, interconnect sender/reader loops, DQ services, and
a dozen lock-guarded caches — and the races that creep in (the scan
cache's touch/evict) are exactly the ones an AST pass can catch
before they cost a debugging session. SURVEY §5.2 prescribes race
detection as a first-class auxiliary subsystem; this is the static
half (``analysis/sanitizer.py`` is the dynamic half).

Rules (each interprocedural where it matters — held-lock sets
propagate through private-method calls, and lock acquisition graphs
resolve attribute types across classes):

  C001 guard-inconsistency    an attribute written both under its
                              inferred guard (``with self._lock:``)
                              and outside it — the scan cache's
                              touch/evict race shape
  C002 lock-order-cycle       the cross-class lock acquisition-order
                              graph has a cycle (potential deadlock),
                              or a non-reentrant lock is re-acquired
                              on the same path
  C003 blocking-under-lock    a blocking call (untimed Condition/Event
                              wait, queue.get, Future.result, socket
                              recv/accept/sendall, time.sleep, device
                              syncs) while holding a lock
  C004 orphan-daemon-thread   daemon thread with no stop/join path
                              (class has none of stop/close/shutdown/
                              ..., or the Thread is started unbound)
  C005 unlocked-module-global module-global state written from
                              functions without a module lock held
  C006 per-call-lock          lock created inside a function and used
                              there — a fresh lock per call guards
                              nothing
  C007 notify-without-lock    Condition.notify/notify_all outside
                              ``with cond:``
  C008 late-binding-closure   a lambda capturing a loop variable handed
                              to an executor/Thread — every task sees
                              the LAST iteration's value

The port's own copy of ``ydb_tpu/analysis/concurrency.py``. What the
port adds: the process's device locks (``ydb_tpu_torch/device.py``) take
part in the lock-order graph wherever a module reaches them —
``with device.capture_lock:``, ``with work_lock.shared():`` /
``.exclusive()``, ``work_lock.try_exclusive()`` — through module
imports (``import``/``from ... import``, aliases included), and module
functions add their lock-order edges as class methods do (the port
takes the device locks from module functions: ``plan.executor``, the
staging producer). ``DeviceWorkLock`` is re-entrant in both modes.

Suppression shares the lint machinery (``# ydb-lint: disable=C001`` on
the line or alone above it; ``skip-file``). Run:

    python -m ydb_tpu_torch.analysis.concurrency [path ...] [--json] [--changed]

Default path: the ydb_tpu_torch package. Exit 1 on unsuppressed findings.
``tests/test_concurrency_clean.py`` enforces a clean tree as a tier-1
test.
"""

from __future__ import annotations

import ast
import json
import sys
import threading

from ydb_tpu_torch.analysis.lint import Finding, _dotted
from ydb_tpu_torch.analysis.paths import collect_files, parse_cli
from ydb_tpu_torch.analysis.suppress import file_skipped, filter_suppressed

RULES = {
    "C001": "guard-inconsistency",
    "C002": "lock-order-cycle",
    "C003": "blocking-under-lock",
    "C004": "orphan-daemon-thread",
    "C005": "unlocked-module-global",
    "C006": "per-call-lock",
    "C007": "notify-without-lock",
    "C008": "late-binding-closure",
}

#: self.attr method calls that mutate the receiver container
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "move_to_end", "sort", "reverse",
}
#: ctor name (last dotted part) -> lock kind; covers both threading
#: primitives and the sanitizer's tracked factories
_LOCK_CTORS = {
    "Lock": "lock", "RLock": "rlock", "Condition": "condition",
    "Semaphore": "semaphore", "BoundedSemaphore": "semaphore",
    "make_lock": "lock", "make_rlock": "rlock",
    "make_condition": "condition",
    "TrackedLock": "lock", "TrackedRLock": "rlock",
    # the port's reader-writer device lock: re-entrant in both modes
    "DeviceWorkLock": "rlock",
}
#: context-manager / acquire methods of a reader-writer lock
_RW_ENTER = {"shared", "exclusive"}
_RW_ACQUIRE = {"try_exclusive"}
#: ctor name -> non-lock attr type tag
_TYPE_CTORS = {
    "Queue": "queue", "SimpleQueue": "queue", "LifoQueue": "queue",
    "PriorityQueue": "queue", "Thread": "thread", "Timer": "thread",
    "Event": "event", "socket": "socket",
    "create_connection": "socket",
}
_INIT_NAMES = {"__init__", "__new__", "__post_init__",
               "__init_subclass__", "__set_name__"}
_STOP_NAMES = {"stop", "close", "shutdown", "join", "terminate",
               "cancel", "quit", "stop_all", "drain_and_stop",
               "__exit__", "__del__"}
_SUBMITTERS = {"submit", "submit_if_free", "apply_async", "map_async",
               "run_in_executor", "call_soon", "call_later",
               "call_soon_threadsafe", "add_done_callback", "spawn",
               "start_soon", "defer", "Thread", "Timer"}
#: receiver-insensitive blocking calls (attr name on any object)
_BLOCKING_ATTRS = {"recv", "accept", "sendall", "block_until_ready"}
_BLOCKING_DOTTED = {"time.sleep", "jax.block_until_ready",
                    "socket.create_connection"}


def _ctor_in(expr) -> "ast.Call | None":
    """The first constructor-looking Call in expr, looking through
    BoolOp/IfExp (``lock or threading.Lock()`` / ``a if c else B()``)."""
    if isinstance(expr, ast.Call):
        return expr
    if isinstance(expr, ast.BoolOp):
        for v in expr.values:
            c = _ctor_in(v)
            if c is not None:
                return c
    if isinstance(expr, ast.IfExp):
        for v in (expr.body, expr.orelse):
            c = _ctor_in(v)
            if c is not None:
                return c
    return None


def _lock_kind(call: "ast.Call | None") -> "str | None":
    if call is None:
        return None
    name = _dotted(call.func).rsplit(".", 1)[-1]
    return _LOCK_CTORS.get(name)


def _type_tag(call: "ast.Call | None") -> "str | None":
    if call is None:
        return None
    name = _dotted(call.func).rsplit(".", 1)[-1]
    if name in _TYPE_CTORS:
        return _TYPE_CTORS[name]
    if name[:1].isupper():
        return f"class:{name}"
    return None


class _Method:
    """Summary of one function/method body."""

    def __init__(self, name: str, node, klass: "str | None"):
        self.name = name
        self.node = node
        self.klass = klass
        # (attr, lexical_held frozenset, node, in_closure)
        self.writes: list = []
        # (lock_key, lexical_held, node)
        self.acquires: list = []
        # (method_name, lexical_held, node)
        self.self_calls: list = []
        # (attr, method_name, lexical_held, node)
        self.attr_calls: list = []
        # (func_name, lexical_held, node)  — module-function calls
        self.fn_calls: list = []
        # (description, lexical_held, node, exempt_key)
        self.blocking: list = []
        # (lock_key, lexical_held, node)
        self.notifies: list = []
        self.daemon_spawns: list = []
        # (global_name, lexical_held, node)
        self.global_writes: list = []
        self.entry_held: frozenset = frozenset()
        # distinct held-at-entry contexts across call paths (C001: a
        # helper called both locked and unlocked writes both ways)
        self.entry_contexts: set = {frozenset()}


class _Class:
    def __init__(self, name: str, module: str, node):
        self.name = name
        self.module = module
        self.node = node
        self.locks: dict = {}       # attr -> kind
        self.lock_alias: dict = {}  # condition attr -> wrapped lock attr
        self.attr_types: dict = {}  # attr -> type tag
        self.methods: dict = {}
        self.escaping: set = set()  # methods passed as values (targets)

    @property
    def key(self) -> str:
        return f"{self.module}.{self.name}"

    def canon(self, attr: str) -> str:
        return self.lock_alias.get(attr, attr)

    def has_stop_path(self) -> bool:
        return bool(_STOP_NAMES & set(self.methods))


class _Module:
    def __init__(self, modname: str, filename: str):
        self.name = modname
        self.filename = filename
        self.imports: dict = {}    # alias -> dotted origin
        self.locks: dict = {}      # name -> kind
        self.mutables: set = set()  # module-level container globals
        self.classes: list = []
        self.functions: dict = {}  # top-level function summaries


def _call_has_timeout(call: ast.Call) -> bool:
    return bool(call.args) or any(
        k.arg in ("timeout", "block") for k in call.keywords)


class _BodyWalker:
    """Walk one function body tracking the lexical held-lock set."""

    def __init__(self, info: _Method, mod: _Module,
                 cls: "_Class | None", self_name: "str | None",
                 findings: list):
        self.info = info
        self.mod = mod
        self.cls = cls
        self.self_name = self_name
        self.findings = findings
        self.local_types: dict = {}  # local name -> type tag
        self.local_locks: dict = {}  # local name -> ctor node
        self.local_lock_used: set = set()
        self.returned: set = set()
        self.loop_vars: list = []

    # -- lock expression resolution --

    def lock_key(self, expr) -> "tuple | None":
        if isinstance(expr, ast.Name):
            if expr.id in self.mod.locks:
                return ("M", self.mod.name,
                        _canon_module(self.mod, expr.id))
            # ``from pkg.device import capture_lock``
            return _imported_lock(self.mod.imports.get(expr.id, ""))
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id in self.mod.imports and \
                expr.value.id != self.self_name:
            # ``device.capture_lock`` through a module import
            key = _imported_lock(
                f"{self.mod.imports[expr.value.id]}.{expr.attr}")
            if key is not None:
                return key
        if isinstance(expr, ast.Attribute) and self.cls is not None:
            base = expr.value
            if isinstance(base, ast.Name) and base.id == self.self_name:
                if expr.attr in self.cls.locks:
                    return ("C", self.cls.key, self.cls.canon(expr.attr))
                return None
            # self.X.Y — lock on a typed member object
            if (isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == self.self_name):
                tag = self.cls.attr_types.get(base.attr, "")
                if tag.startswith("class:"):
                    other = _CLASSES.get(tag[6:])
                    if other is not None and expr.attr in other.locks:
                        return ("C", other.key, other.canon(expr.attr))
        return None

    # -- the walk --

    def walk_body(self, stmts, held: frozenset, closure: bool = False):
        for st in stmts:
            self.walk(st, held, closure)

    def walk(self, node, held: frozenset, closure: bool):
        meth = getattr(self, f"w_{type(node).__name__}", None)
        if meth is not None:
            meth(node, held, closure)
            return
        for child in ast.iter_child_nodes(node):
            self.walk(child, held, closure)

    def w_With(self, node, held, closure):
        inner = set(held)
        for item in node.items:
            ce = item.context_expr
            if isinstance(ce, ast.Call) and \
                    isinstance(ce.func, ast.Attribute) and \
                    ce.func.attr in _RW_ENTER:
                # ``with work_lock.shared():`` / ``.exclusive()``
                ce = ce.func.value
            key = self.lock_key(ce)
            if key is not None:
                self.info.acquires.append((key, frozenset(inner), node))
                inner.add(key)
            elif isinstance(item.context_expr, ast.Name) and \
                    item.context_expr.id in self.local_locks:
                self.local_lock_used.add(item.context_expr.id)
            self.walk(item.context_expr, held, closure)
        self.walk_body(node.body, frozenset(inner), closure)

    w_AsyncWith = w_With

    def w_FunctionDef(self, node, held, closure):
        # a nested def runs later, possibly on another thread: its body
        # sees NO lexically-held locks
        self.walk_body(node.body, frozenset(), True)

    w_AsyncFunctionDef = w_FunctionDef

    def w_Lambda(self, node, held, closure):
        self.walk(node.body, frozenset(), True)

    def w_For(self, node, held, closure):
        self.walk(node.iter, held, closure)
        names = [n.id for n in ast.walk(node.target)
                 if isinstance(n, ast.Name)]
        self.loop_vars.append(set(names))
        self.walk_body(node.body, held, closure)
        self.loop_vars.pop()
        self.walk_body(node.orelse, held, closure)

    w_AsyncFor = w_For

    def w_Return(self, node, held, closure):
        if isinstance(node.value, ast.Name):
            self.returned.add(node.value.id)
        if node.value is not None:
            self.walk(node.value, held, closure)

    def w_Global(self, node, held, closure):
        for name in node.names:
            self.local_types.setdefault(f"global:{name}", "global")

    def _record_write(self, attr, held, node, closure):
        self.info.writes.append((attr, held, node, closure))

    def _write_target(self, tgt, held, node, closure):
        if isinstance(tgt, ast.Tuple) or isinstance(tgt, ast.List):
            for el in tgt.elts:
                self._write_target(el, held, node, closure)
            return
        base = tgt
        while isinstance(base, ast.Subscript):
            base = base.value
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and \
                base.value.id == self.self_name and self.cls is not None:
            self._record_write(base.attr, held, node, closure)
        elif isinstance(base, ast.Name):
            name = base.id
            if f"global:{name}" in self.local_types or (
                    isinstance(tgt, ast.Subscript)
                    and name in self.mod.mutables):
                self.info.global_writes.append((name, held, node))

    def w_Assign(self, node, held, closure):
        ctor = _ctor_in(node.value)
        kind = _lock_kind(ctor)
        tag = _type_tag(ctor)
        for tgt in node.targets:
            self._write_target(tgt, held, node, closure)
            if isinstance(tgt, ast.Name):
                if kind is not None:
                    self.local_locks[tgt.id] = node
                if tag is not None:
                    self.local_types[tgt.id] = tag
            if isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == self.self_name and \
                    self.cls is not None:
                if kind is not None:
                    self.cls.locks.setdefault(tgt.attr, kind)
                    if kind == "condition" and ctor.args and \
                            isinstance(ctor.args[0], ast.Attribute):
                        wrapped = ctor.args[0]
                        if isinstance(wrapped.value, ast.Name) and \
                                wrapped.value.id == self.self_name:
                            self.cls.lock_alias[tgt.attr] = wrapped.attr
                    if kind is not None and \
                            self.info.name not in _INIT_NAMES:
                        self._flag_lazy_lock(node)
                elif tag is not None:
                    self.cls.attr_types.setdefault(tgt.attr, tag)
        self.walk(node.value, held, closure)

    def w_AnnAssign(self, node, held, closure):
        if node.value is None:
            return
        fake = ast.Assign(targets=[node.target], value=node.value)
        ast.copy_location(fake, node)
        self.w_Assign(fake, held, closure)

    def w_AugAssign(self, node, held, closure):
        self._write_target(node.target, held, node, closure)
        self.walk(node.value, held, closure)

    def w_Delete(self, node, held, closure):
        for tgt in node.targets:
            self._write_target(tgt, held, node, closure)

    def _flag_lazy_lock(self, node):
        self.findings.append(Finding(
            self.mod.filename, node.lineno, node.col_offset, "C006",
            RULES["C006"],
            "lock created outside __init__: a lock minted per call (or"
            " lazily, racing its own creation) guards nothing — create"
            " it once in __init__"))

    def w_Call(self, node, held, closure):
        fn = node.func
        dotted = _dotted(fn)
        # mutator method on self.attr -> write
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
            recv = fn.value
            if isinstance(recv, ast.Attribute) and \
                    isinstance(recv.value, ast.Name) and \
                    recv.value.id == self.self_name and \
                    self.cls is not None:
                self._record_write(recv.attr, held, node, closure)
            elif isinstance(recv, ast.Name) and \
                    recv.id in self.mod.mutables:
                self.info.global_writes.append((recv.id, held, node))
        # lock ops
        if isinstance(fn, ast.Attribute) and fn.attr in (
                "acquire", "release", "notify", "notify_all", "wait",
                "wait_for") + tuple(_RW_ACQUIRE):
            key = self.lock_key(fn.value)
            if key is not None:
                if fn.attr == "acquire" or fn.attr in _RW_ACQUIRE:
                    self.info.acquires.append((key, held, node))
                elif fn.attr in ("notify", "notify_all"):
                    self.info.notifies.append((key, held, node))
                elif fn.attr in ("wait", "wait_for"):
                    if not _call_has_timeout(node):
                        self.info.blocking.append((
                            f"{_dotted(fn.value) or 'condition'}"
                            f".{fn.attr}() without timeout",
                            held, node, key))
            elif isinstance(fn.value, ast.Name) and \
                    fn.value.id in self.local_locks and \
                    fn.attr == "acquire":
                self.local_lock_used.add(fn.value.id)
        # blocking calls
        self._check_blocking(node, fn, dotted, held)
        # call-graph edges
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            if isinstance(recv, ast.Name) and recv.id == self.self_name:
                self.info.self_calls.append((fn.attr, held, node))
            elif isinstance(recv, ast.Attribute) and \
                    isinstance(recv.value, ast.Name) and \
                    recv.value.id == self.self_name:
                self.info.attr_calls.append(
                    (recv.attr, fn.attr, held, node))
        elif isinstance(fn, ast.Name):
            self.info.fn_calls.append((fn.id, held, node))
        # thread lifecycle
        self._check_threads(node, fn, dotted)
        # C008
        self._check_late_binding(node, fn)
        for child in ast.iter_child_nodes(node):
            self.walk(child, held, closure)

    def _check_blocking(self, node, fn, dotted, held):
        desc = None
        if dotted in _BLOCKING_DOTTED:
            desc = f"{dotted}()"
        elif isinstance(fn, ast.Attribute):
            if fn.attr in _BLOCKING_ATTRS:
                desc = f".{fn.attr}()"
            elif fn.attr == "item" and not node.args:
                desc = ".item() (device sync)"
            elif fn.attr == "result" and not node.args and not any(
                    k.arg == "timeout" for k in node.keywords):
                desc = ".result() without timeout"
            elif fn.attr == "join" and not node.args and not any(
                    k.arg == "timeout" for k in node.keywords):
                desc = ".join() without timeout"
            elif fn.attr in ("get", "put") and \
                    not _call_has_timeout(node):
                recv_tag = None
                if isinstance(fn.value, ast.Name):
                    recv_tag = self.local_types.get(fn.value.id)
                elif isinstance(fn.value, ast.Attribute) and \
                        isinstance(fn.value.value, ast.Name) and \
                        fn.value.value.id == self.self_name and \
                        self.cls is not None:
                    recv_tag = self.cls.attr_types.get(fn.value.attr)
                if recv_tag == "queue":
                    desc = f"queue.{fn.attr}() without timeout"
            elif fn.attr == "wait" and not _call_has_timeout(node):
                recv_tag = None
                if isinstance(fn.value, ast.Attribute) and \
                        isinstance(fn.value.value, ast.Name) and \
                        fn.value.value.id == self.self_name and \
                        self.cls is not None:
                    recv_tag = self.cls.attr_types.get(fn.value.attr)
                if recv_tag == "event":
                    desc = ".wait() on an Event without timeout"
        if desc is not None:
            self.info.blocking.append((desc, held, node, None))

    def _check_threads(self, node, fn, dotted):
        name = dotted.rsplit(".", 1)[-1]
        if name in ("Thread", "Timer"):
            daemon = any(k.arg == "daemon" and
                         isinstance(k.value, ast.Constant) and
                         k.value.value is True
                         for k in node.keywords)
            if daemon:
                self.info.daemon_spawns.append(node)
        if isinstance(fn, ast.Attribute) and fn.attr == "start" and \
                isinstance(fn.value, ast.Call):
            ctor = _dotted(fn.value.func).rsplit(".", 1)[-1]
            if ctor in ("Thread", "Timer"):
                self.findings.append(Finding(
                    self.mod.filename, node.lineno, node.col_offset,
                    "C004", RULES["C004"],
                    "fire-and-forget Thread(...).start(): the thread"
                    " can never be joined or stopped — bind it and"
                    " give its owner a stop/join path"))

    def _check_late_binding(self, node, fn):
        if not self.loop_vars:
            return
        name = _dotted(fn).rsplit(".", 1)[-1]
        if name not in _SUBMITTERS:
            return
        live = set().union(*self.loop_vars)
        for arg in list(node.args) + [k.value for k in node.keywords]:
            if not isinstance(arg, ast.Lambda):
                continue
            params = {a.arg for a in (
                arg.args.args + arg.args.kwonlyargs
                + arg.args.posonlyargs)}
            free = {n.id for n in ast.walk(arg.body)
                    if isinstance(n, ast.Name)} - params
            captured = sorted(free & live)
            if captured:
                self.findings.append(Finding(
                    self.mod.filename, arg.lineno, arg.col_offset,
                    "C008", RULES["C008"],
                    f"lambda captures loop variable(s)"
                    f" {', '.join(captured)} by reference: every"
                    " submitted task sees the LAST iteration's value —"
                    " bind eagerly (lambda x=x: ...) or pass args"))

    def finish(self):
        for name, node in self.local_locks.items():
            if name in self.local_lock_used and \
                    name not in self.returned:
                self._flag_lazy_lock(node)


def _canon_module(mod: _Module, name: str) -> str:
    return name  # module locks have no aliasing today


def _imported_lock(origin: str) -> "tuple | None":
    """The lock key of a dotted origin ``pkg.mod.name`` when ``mod`` is a
    scanned module whose module-level ``name`` is a lock."""
    parts = origin.rsplit(".", 2)
    if len(parts) < 2:
        return None
    stem, name = parts[-2], parts[-1]
    if name in _MODLOCKS.get(stem, ()):
        return ("M", stem, name)
    return None


_CLASSES: dict = {}  # bare class name -> _Class (unique across run)
#: module stem -> {module-level lock name: kind}, filled before any body
#: is walked so imported locks resolve across modules
_MODLOCKS: dict = {}
# serializes whole-analysis runs: the class registry is process-global
# so concurrent check_sources() calls (e.g. pytest workers in one
# process) must not interleave clear/registration. Reentrant because
# registration happens inside a run that already holds it.
_REG_LOCK = threading.RLock()


def _scan_module(src: str, filename: str, modname: str,
                 findings: list) -> "_Module | None":
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        findings.append(Finding(filename, e.lineno or 0, e.offset or 0,
                                "C000", "syntax-error", str(e.msg)))
        return None
    mod = _Module(modname, filename)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    mod.imports[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                mod.imports[a.asname or a.name] = \
                    f"{node.module}.{a.name}"
    # pass 1: module-level locks + mutable globals
    for st in tree.body:
        if isinstance(st, (ast.Assign, ast.AnnAssign)):
            tgts = st.targets if isinstance(st, ast.Assign) \
                else [st.target]
            value = st.value
            ctor = _ctor_in(value) if value is not None else None
            kind = _lock_kind(ctor)
            for t in tgts:
                if not isinstance(t, ast.Name):
                    continue
                if kind is not None:
                    mod.locks[t.id] = kind
                elif isinstance(value, (ast.Dict, ast.List, ast.Set)) \
                        or (ctor is not None and _dotted(
                            ctor.func).rsplit(".", 1)[-1] in (
                            "dict", "list", "set", "OrderedDict",
                            "defaultdict", "deque", "Counter")):
                    mod.mutables.add(t.id)
    # pass 2: classes + functions
    for st in tree.body:
        if isinstance(st, ast.ClassDef):
            mod.classes.append(_scan_class(st, mod, findings))
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[st.name] = _scan_function(
                st, mod, None, None, findings)
    return mod


def _module_locks(tree) -> dict:
    """Module-level lock names of one parsed module -> kind."""
    out: dict = {}
    for st in tree.body:
        if isinstance(st, (ast.Assign, ast.AnnAssign)):
            tgts = st.targets if isinstance(st, ast.Assign) \
                else [st.target]
            kind = _lock_kind(_ctor_in(st.value)) \
                if st.value is not None else None
            if kind is not None:
                for t in tgts:
                    if isinstance(t, ast.Name):
                        out[t.id] = kind
    return out


def _is_static(node) -> bool:
    return any(isinstance(d, ast.Name) and
               d.id in ("staticmethod", "classmethod")
               for d in node.decorator_list)


def _scan_class(node: ast.ClassDef, mod: _Module,
                findings: list) -> _Class:
    cls = _Class(node.name, mod.name, node)
    method_nodes = [st for st in node.body if isinstance(
        st, (ast.FunctionDef, ast.AsyncFunctionDef))]
    # pre-pass: __init__ first so lock attrs exist before other
    # methods' with-statements resolve them
    method_nodes.sort(key=lambda m: 0 if m.name in _INIT_NAMES else 1)
    for m in method_nodes:
        self_name = None
        if not _is_static(m) and m.args.args:
            self_name = m.args.args[0].arg
        cls.methods[m.name] = _scan_function(
            m, mod, cls, self_name, findings)
    # escaping methods: self.m referenced as a value (thread targets,
    # callbacks) — their entry held-set must stay empty
    names = set(cls.methods)
    for m in method_nodes:
        for n in ast.walk(m):
            if isinstance(n, ast.Attribute) and \
                    isinstance(n.value, ast.Name) and \
                    n.value.id in ("self",) and n.attr in names:
                cls.escaping.add(n.attr)
    # references as Call funcs are not escapes; subtract direct calls
    called = set()
    for mi in cls.methods.values():
        for name, _h, _n in mi.self_calls:
            called.add(name)
    cls.escaping -= called
    with _REG_LOCK:
        _CLASSES.setdefault(cls.name, cls)
    return cls


def _scan_function(node, mod: _Module, cls: "_Class | None",
                   self_name: "str | None", findings: list) -> _Method:
    info = _Method(node.name, node, cls.key if cls else None)
    walker = _BodyWalker(info, mod, cls, self_name, findings)
    walker.walk_body(node.body, frozenset())
    walker.finish()
    return info


# ---------------- global analysis passes ----------------


def _entry_fixpoint(cls: _Class) -> None:
    """Held-at-entry sets for private methods: the intersection of the
    held sets at every intra-class call site (a private helper called
    only under ``with self._lock:`` effectively runs guarded)."""
    for _ in range(8):
        changed = False
        for name, mi in cls.methods.items():
            if not name.startswith("_") or name.startswith("__") or \
                    name in cls.escaping:
                continue
            sites = []
            for caller in cls.methods.values():
                for callee, held, _node in caller.self_calls:
                    if callee == name:
                        sites.append(caller.entry_held | held)
            if not sites:
                continue
            new = frozenset.intersection(*sites)
            if new != mi.entry_held:
                mi.entry_held = new
                changed = True
        if not changed:
            break
    _context_fixpoint(cls)


def _context_fixpoint(cls: _Class) -> None:
    """Per-call-path entry contexts (C001): unlike the intersection
    above, a private helper reached both under a lock and without it
    keeps BOTH contexts, so its writes count as guarded AND unguarded.
    Call sites inside __init__ are construction-time and excluded."""
    for _ in range(8):
        changed = False
        for name, mi in cls.methods.items():
            if not name.startswith("_") or name.startswith("__") or \
                    name in cls.escaping:
                continue
            ctxs: set = set()
            called = False
            for cname, caller in cls.methods.items():
                if cname in _INIT_NAMES:
                    continue
                for callee, held, _node in caller.self_calls:
                    if callee == name:
                        called = True
                        for c in caller.entry_contexts:
                            ctxs.add(c | held)
            if called and len(ctxs) <= 16 and \
                    ctxs != mi.entry_contexts:
                mi.entry_contexts = ctxs
                changed = True
        if not changed:
            return


def _resolve_attr_call(cls: _Class, attr: str,
                       meth: str) -> "_Method | None":
    tag = cls.attr_types.get(attr, "")
    if tag.startswith("class:"):
        other = _CLASSES.get(tag[6:])
        if other is not None:
            return other.methods.get(meth)
    return None


def _acquire_fixpoint(classes: list) -> dict:
    """Transitive may-acquire set per method (for the lock-order
    graph): direct acquires plus everything resolved callees acquire."""
    acq: dict = {}
    for cls in classes:
        for mi in cls.methods.values():
            acq[id(mi)] = {key for key, _h, _n in mi.acquires}
    for _ in range(8):
        changed = False
        for cls in classes:
            for mi in cls.methods.values():
                cur = acq[id(mi)]
                for name, _h, _n in mi.self_calls:
                    callee = cls.methods.get(name)
                    if callee is not None and \
                            not acq[id(callee)] <= cur:
                        cur |= acq[id(callee)]
                        changed = True
                for attr, meth, _h, _n in mi.attr_calls:
                    callee = _resolve_attr_call(cls, attr, meth)
                    if callee is not None and \
                            not acq[id(callee)] <= cur:
                        cur |= acq[id(callee)]
                        changed = True
        if not changed:
            break
    return acq


def _lock_kind_of(key: tuple, modlocks: "dict | None" = None) -> str:
    if key[0] == "C":
        clsname = key[1].rsplit(".", 1)[-1]
        cls = _CLASSES.get(clsname)
        if cls is not None:
            return cls.locks.get(key[2], "lock")
    elif key[0] == "M" and modlocks is not None:
        return modlocks.get((key[1], key[2]), "lock")
    return "lock"


def _fmt_key(key: tuple) -> str:
    return f"{key[1].rsplit('.', 1)[-1]}.{key[2]}" if key[0] == "C" \
        else f"{key[1]}.{key[2]}"


def _check_classes(mods: list, findings: list) -> None:
    classes = [c for m in mods for c in m.classes]
    for cls in classes:
        _entry_fixpoint(cls)
    acq = _acquire_fixpoint(classes)
    modlocks = {(m.name, lname): kind
                for m in mods for lname, kind in m.locks.items()}

    # ---- C002: lock acquisition-order graph + cycles ----
    edges: dict = {}
    for mod in mods:
        # module functions take locks too (the port's device locks)
        for fi in mod.functions.values():
            for key, held, node in fi.acquires:
                for l1 in held:
                    if l1 != key:
                        edges.setdefault((l1, key), (mod, node))
                    elif _lock_kind_of(key, modlocks) != "rlock":
                        findings.append(Finding(
                            mod.filename, node.lineno, node.col_offset,
                            "C002", RULES["C002"],
                            f"non-reentrant lock {_fmt_key(key)}"
                            " re-acquired while already held on this"
                            " path: instant self-deadlock (use an"
                            " RLock or split the critical section)"))
    for cls in classes:
        cmod = _mod_of(mods, cls)
        for mi in cls.methods.values():
            eff = mi.entry_held
            for key, held, node in mi.acquires:
                for l1 in (eff | held):
                    if l1 != key:
                        edges.setdefault((l1, key), (cmod, node))
                    elif _lock_kind_of(key, modlocks) != "rlock":
                        findings.append(Finding(
                            _mod_of(mods, cls).filename, node.lineno,
                            node.col_offset, "C002", RULES["C002"],
                            f"non-reentrant lock {_fmt_key(key)}"
                            " re-acquired while already held on this"
                            " path: instant self-deadlock (use an"
                            " RLock or split the critical section)"))
            for name, held, node in mi.self_calls:
                callee = cls.methods.get(name)
                if callee is None:
                    continue
                for l1 in (eff | held):
                    for l2 in acq[id(callee)]:
                        if l1 != l2:
                            edges.setdefault((l1, l2), (cmod, node))
            for attr, meth, held, node in mi.attr_calls:
                callee = _resolve_attr_call(cls, attr, meth)
                if callee is None:
                    continue
                for l1 in (eff | held):
                    for l2 in acq[id(callee)]:
                        if l1 != l2:
                            edges.setdefault((l1, l2), (cmod, node))
    _report_cycles(edges, mods, findings)

    # ---- per-class rules ----
    for cls in classes:
        mod = _mod_of(mods, cls)
        _check_c001(cls, mod, findings)
        _check_c003(cls, mod, findings)
        _check_c004(cls, mod, findings)
        _check_c007(cls, mod, findings)
    # ---- module functions: C003 + C005 + C007 ----
    for mod in mods:
        for fi in mod.functions.values():
            _check_fn_blocking(fi, mod, findings)
            _check_c005(fi, mod, findings)
        for cls in mod.classes:
            for mi in cls.methods.values():
                _check_c005(mi, mod, findings)


def _mod_of(mods: list, cls: _Class) -> _Module:
    for m in mods:
        if cls in m.classes:
            return m
    return mods[0]


def _report_cycles(edges: dict, mods: list, findings: list) -> None:
    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    # iterative DFS cycle detection with path recovery
    seen: set = set()
    for start in sorted(graph):
        if start in seen:
            continue
        stack = [(start, iter(sorted(graph.get(start, ()))))]
        on_path = {start}
        path = [start]
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if nxt in on_path:
                    cycle = path[path.index(nxt):] + [nxt]
                    mod, site = edges[(node, nxt)]
                    order = " -> ".join(_fmt_key(k) for k in cycle)
                    findings.append(Finding(
                        mod.filename, site.lineno, site.col_offset,
                        "C002", RULES["C002"],
                        f"lock acquisition-order cycle: {order} —"
                        " two threads taking these locks in opposite"
                        " order deadlock; impose one global order"))
                    continue
                if nxt in seen:
                    continue
                stack.append((nxt, iter(sorted(graph.get(nxt, ())))))
                on_path.add(nxt)
                path.append(nxt)
                advanced = True
                break
            if not advanced:
                seen.add(node)
                on_path.discard(node)
                path.pop()
                stack.pop()


def _check_c001(cls: _Class, mod: _Module, findings: list) -> None:
    skip_attrs = set(cls.locks) | {
        a for a, t in cls.attr_types.items()
        if t in ("thread", "event", "socket")}
    by_attr: dict = {}
    for name, mi in cls.methods.items():
        if name in _INIT_NAMES:
            continue
        for attr, held, node, closure in mi.writes:
            if attr in skip_attrs:
                continue
            ctxs = {frozenset()} if closure else mi.entry_contexts
            for ctx in ctxs:
                by_attr.setdefault(attr, []).append(
                    (held | ctx, node, name))
    for attr, writes in sorted(by_attr.items()):
        guarded = [w for w in writes if w[0]]
        unguarded = [w for w in writes if not w[0]]
        if not guarded or not unguarded:
            continue
        guard = sorted({_fmt_key(k) for eff, _n, _m in guarded
                       for k in eff})
        for _eff, node, meth in unguarded:
            findings.append(Finding(
                mod.filename, node.lineno, node.col_offset, "C001",
                RULES["C001"],
                f"self.{attr} is guarded by {'/'.join(guard)} elsewhere"
                f" but mutated without it in {cls.name}.{meth}(): a"
                " concurrent guarded writer races this write (the"
                " scan-cache touch/evict shape)"))


def _blocking_findings(mi: _Method, eff_entry: frozenset):
    for desc, held, node, exempt in mi.blocking:
        eff = held | eff_entry
        if exempt is not None:
            eff = eff - {exempt}
        if eff:
            yield desc, eff, node


def _check_c003(cls: _Class, mod: _Module, findings: list) -> None:
    for mi in cls.methods.values():
        for desc, eff, node in _blocking_findings(mi, mi.entry_held):
            _flag_blocking(mod, node, desc, eff, findings)
    # one-level propagation: calling a may-block callee while held.
    # The callee's own-condition exemption carries over — a helper
    # waiting on a condition the CALLER holds still releases it.
    for mi in cls.methods.values():
        for name, held, node in mi.self_calls:
            eff = held | mi.entry_held
            if not eff:
                continue
            callee = cls.methods.get(name)
            if callee is None:
                continue
            for desc, bheld, _bn, exempt in callee.blocking:
                if bheld:
                    continue  # flagged at its own site if locked there
                if eff - ({exempt} if exempt else set()):
                    _flag_blocking(
                        mod, node, f"{name}() -> {desc}", eff, findings)
                    break
        for attr, meth, held, node in mi.attr_calls:
            eff = held | mi.entry_held
            if not eff:
                continue
            callee = _resolve_attr_call(cls, attr, meth)
            if callee is None:
                continue
            for desc, bheld, _bn, exempt in callee.blocking:
                if bheld:
                    continue
                if eff - ({exempt} if exempt else set()):
                    _flag_blocking(
                        mod, node, f"{attr}.{meth}() -> {desc}", eff,
                        findings)
                    break


def _check_fn_blocking(fi: _Method, mod: _Module,
                       findings: list) -> None:
    for desc, eff, node in _blocking_findings(fi, frozenset()):
        _flag_blocking(mod, node, desc, eff, findings)


def _flag_blocking(mod, node, desc, eff, findings):
    locks = ", ".join(sorted(_fmt_key(k) for k in eff))
    findings.append(Finding(
        mod.filename, node.lineno, node.col_offset, "C003",
        RULES["C003"],
        f"blocking call {desc} while holding {locks}: every other"
        " thread needing the lock stalls behind this wait (and a"
        " cyclic wait deadlocks) — move the wait outside the critical"
        " section or bound it with a timeout"))


def _check_c004(cls: _Class, mod: _Module, findings: list) -> None:
    if cls.has_stop_path():
        return
    for mi in cls.methods.values():
        for node in mi.daemon_spawns:
            findings.append(Finding(
                mod.filename, node.lineno, node.col_offset, "C004",
                RULES["C004"],
                f"{cls.name} starts a daemon thread but has no"
                " stop/close/shutdown/join method: the thread runs"
                " until process exit with no orderly stop path"))


def _check_c005(fi: _Method, mod: _Module, findings: list) -> None:
    for name, held, node in fi.global_writes:
        if name in mod.locks:
            continue
        module_locked = any(k[0] == "M" and k[1] == mod.name
                            for k in held)
        if not module_locked:
            findings.append(Finding(
                mod.filename, node.lineno, node.col_offset, "C005",
                RULES["C005"],
                f"module-global {name} written without a module lock:"
                " conveyor/pool workers sharing this module race the"
                " write — guard it with a module-level Lock"))


def _check_c007(cls: _Class, mod: _Module, findings: list) -> None:
    for mi in cls.methods.values():
        for key, held, node in mi.notifies:
            if key not in (held | mi.entry_held):
                findings.append(Finding(
                    mod.filename, node.lineno, node.col_offset, "C007",
                    RULES["C007"],
                    f"{_fmt_key(key)}.notify called without holding"
                    " the condition's lock: RuntimeError at best, a"
                    " lost wakeup at worst — notify inside ``with"
                    " cond:``"))


# ---------------- entry points ----------------


def check_source(src: str, filename: str = "<string>",
                 modname: "str | None" = None) -> list:
    """Analyze one source text (tests); returns unsuppressed findings."""
    return check_sources([(src, filename, modname or "m")])


def check_sources(sources) -> list:
    """Analyze (src, filename, modname) triples as ONE program (cross-
    module lock-order edges resolve across them)."""
    with _REG_LOCK:
        return _check_sources_locked(sources)


def _check_sources_locked(sources) -> list:
    with _REG_LOCK:
        _CLASSES.clear()
        _MODLOCKS.clear()
        for src, filename, modname in sources:
            try:
                _MODLOCKS.setdefault(modname, {}).update(
                    _module_locks(ast.parse(src, filename=filename)))
            except SyntaxError:
                pass  # reported by the scan below
    findings: list = []
    mods = []
    lines_by_file: dict = {}
    for src, filename, modname in sources:
        lines = src.splitlines()
        lines_by_file[filename] = lines
        if file_skipped(lines):
            continue
        mod = _scan_module(src, filename, modname, findings)
        if mod is not None:
            mods.append(mod)
    if mods:
        _check_classes(mods, findings)
    kept = []
    for filename, lines in lines_by_file.items():
        here = [f for f in findings if f.file == filename]
        kept.extend(filter_suppressed(here, lines, RULES))
    return sorted(kept, key=lambda f: (f.file, f.line, f.col, f.code))


def check_paths(paths) -> list:
    sources = []
    for f in paths:
        sources.append((f.read_text(encoding="utf-8"), str(f), f.stem))
    return check_sources(sources)


def main(argv=None) -> int:
    paths, as_json, changed = parse_cli(argv)
    files = collect_files(paths, changed=changed)
    findings = check_paths(files)
    if as_json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
