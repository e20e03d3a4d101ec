"""Resource-lifecycle static analyzer: acquire/release rules R001-R008.

Deadlines, cooperative cancellation and load shedding run through
every layer — exactly the error paths where a leaked conveyor
slot, a stranded resident flight or an orphaned session-registry row
turns "degrade gracefully" into "wedge after an hour of traffic". This
pass proves acquire/release PAIRING statically; the runtime half
(``analysis/leaksan.py``) catches what static analysis cannot see.

The analyzer learns pairs from a resource map — broker/lock
``acquire``/``release``, leaksan ``track``/``close``, session registry
``_register_active``/``_unregister_active``, workload
``admit``/``finish``, generic ``register``/``unregister`` and
``begin``/``end`` — plus "flight" containers (any ``self`` attribute
whose name contains ``flight``: ``_flights``, ``_inflight``).

Rules:

  R001 release-not-on-all-paths  an owned acquire whose matching
                                 release exists in the same function
                                 but never inside a ``finally`` — an
                                 exception or early return strands the
                                 resource
  R002 generator-holds-resource  a generator registers a flight / owns
                                 an acquire before a ``yield`` without
                                 a ``finally`` releasing it — an
                                 abandoned (never-closed) stream runs
                                 no ``finally`` late, and none at all
                                 protects a stranded registration
  R003 gauge-decrement-skipped   a ``self.x += 1`` / ``-= 1`` gauge
                                 pair in one method whose decrement is
                                 not ``finally``-protected — the
                                 exception path leaks the count
  R004 cancellation-swallowed    an ``except`` clause naming
                                 StatementCancelled / ConveyorTimeout /
                                 _Cancelled that neither re-raises nor
                                 records the error — cancellation must
                                 propagate so slots release
  R005 stoppable-not-stopped     a class holds (constructs in
                                 ``__init__``) a thread-owning object
                                 with a stop method, but no stop path
                                 of the holder ever reaches it
  R006 deadline-ignored-wait     a broker ``acquire`` without a
                                 ``deadline=`` — the deadline discipline:
                                 admission waits on the statement path
                                 must observe the active Deadline
  R007 unbounded-growth          inserts into a container attribute
                                 with no removal, rebuild or bound
                                 check anywhere in the class
  R008 cross-thread-unowned      a flight registered before a conveyor
                                 ``submit`` whose closure has no
                                 ``finally`` releasing it — the
                                 resource crossed threads with no owner
                                 responsible for release

Suppression shares the lint machinery (``# ydb-lint: disable=R001`` on
the line or alone above it; ``skip-file``). Run:

    python -m ydb_tpu_torch.analysis.lifecycle [path ...] [--json] [--changed]

Default path: the ydb_tpu_torch package. Exit 1 on unsuppressed findings.
``tests/test_lifecycle_clean.py`` enforces a clean tree as a tier-1
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
    "R001": "release-not-on-all-paths",
    "R002": "generator-holds-resource",
    "R003": "gauge-decrement-skipped",
    "R004": "cancellation-swallowed",
    "R005": "stoppable-not-stopped",
    "R006": "deadline-ignored-wait",
    "R007": "unbounded-growth",
    "R008": "cross-thread-unowned",
}

#: acquire method name -> matching release method names (same receiver)
_PAIRS = {
    "acquire": ("release",),
    "track": ("close",),
    "_register_active": ("_unregister_active",),
    "register": ("unregister",),
    "admit": ("finish",),
    "begin": ("end",),
}
_RELEASES = {r for rs in _PAIRS.values() for r in rs}
#: container mutation names that GROW the receiver
_INSERTS = {"add", "append", "appendleft", "setdefault"}
#: ...and the ones that SHRINK it
_REMOVALS = {"pop", "popitem", "popleft", "discard", "remove", "clear"}
#: cancellation types that must propagate (or be recorded as the
#: statement's error) so the layers above release their resources
_CANCEL_EXCS = {"StatementCancelled", "ConveyorTimeout", "_Cancelled",
                "CancelledError", "DeadlineExceeded"}
_INIT_NAMES = {"__init__", "__new__", "__post_init__",
               "__init_subclass__", "__set_name__"}
_STOP_NAMES = {"stop", "close", "shutdown", "join", "terminate",
               "cancel", "quit", "stop_all", "drain_and_stop",
               "__exit__", "__del__"}
_SUBMITTERS = {"submit", "submit_if_free"}
_EMPTY_CTORS = {"dict", "list", "set", "OrderedDict", "defaultdict",
                "deque", "Counter"}


def _is_flight(attr: str) -> bool:
    return "flight" in attr


class _Fn:
    """Lifecycle summary of one function body (nested defs included —
    a closure's ``finally`` release counts as the function's, because
    the closure IS the ownership continuation across threads)."""

    def __init__(self, name: str, node):
        self.name = name
        self.node = node
        self.is_gen = False
        self.last_yield_line = 0
        # (recv_dotted, pair_name, node, owned, in_finally)
        self.acquires: list = []
        # (recv_dotted, release_name, node, in_finally)
        self.releases: list = []
        # (attr, node, in_finally) — self.attr += 1 / -= 1
        self.incs: list = []
        self.decs: list = []
        # (attr, node, in_finally, in_nested)
        self.inserts: list = []
        self.removals: list = []
        # self.attr = ... reassignments (attr, node)
        self.reassigns: list = []
        # attrs referenced as len(self.attr) / in a comparison bound
        self.len_refs: set = set()
        # (node, arg_names, has_lambda) — conveyor submit sites
        self.submits: list = []
        self.nested: dict = {}  # name -> FunctionDef node
        self.handlers: list = []  # ExceptHandler nodes
        # broker acquire calls missing a deadline (R006)
        self.broker_no_deadline: list = []


class _Class:
    def __init__(self, name: str, module: str, node):
        self.name = name
        self.module = module
        self.node = node
        self.methods: dict = {}      # name -> _Fn
        self.method_nodes: dict = {}  # name -> ast node
        self.attr_ctors: dict = {}   # attr -> ctor class name (init)
        self.containers: dict = {}   # attr -> init assign node
        self.spawns_thread = False
        self.self_name = "self"


class _Walk:
    """One pass over a function body, tracking the enclosing
    ``finally`` and nested-def depth."""

    def __init__(self, fn: _Fn, self_name: "str | None"):
        self.fn = fn
        self.self_name = self_name

    # -- receiver helpers --

    def _self_attr(self, expr) -> "str | None":
        """attr when ``expr`` is self.<attr> (or self.<attr>[...])."""
        base = expr
        while isinstance(base, ast.Subscript):
            base = base.value
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and \
                base.value.id == self.self_name:
            return base.attr
        return None

    # -- statements --

    def body(self, stmts, fin: bool, depth: int) -> None:
        for st in stmts:
            self.stmt(st, fin, depth)

    def stmt(self, st, fin: bool, depth: int) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if depth == 0:
                self.fn.nested[st.name] = st
            # a nested def has its own finally scoping
            self.body(st.body, False, depth + 1)
        elif isinstance(st, ast.Lambda):
            pass
        elif isinstance(st, ast.Try):
            self.body(st.body, fin, depth)
            for h in st.handlers:
                self.fn.handlers.append(h)
                self.body(h.body, fin, depth)
            self.body(st.orelse, fin, depth)
            self.body(st.finalbody, True, depth)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self.expr(item.context_expr, fin, depth)
            self.body(st.body, fin, depth)
        elif isinstance(st, ast.Expr):
            if isinstance(st.value, ast.Call):
                self.call(st.value, fin, depth, owned=True)
            else:
                self.expr(st.value, fin, depth)
        elif isinstance(st, ast.Assign):
            for tgt in st.targets:
                self.target(tgt, st, fin, depth)
            if isinstance(st.value, ast.Call):
                owned = any(isinstance(t, ast.Name)
                            for t in st.targets)
                self.call(st.value, fin, depth, owned=owned)
            else:
                self.expr(st.value, fin, depth)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self.target(st.target, st, fin, depth)
                self.expr(st.value, fin, depth)
        elif isinstance(st, ast.AugAssign):
            attr = self._self_attr(st.target)
            if attr is not None and \
                    isinstance(st.value, ast.Constant) and \
                    st.value.value == 1:
                if isinstance(st.op, ast.Add):
                    self.fn.incs.append((attr, st, fin))
                elif isinstance(st.op, ast.Sub):
                    self.fn.decs.append((attr, st, fin))
            self.expr(st.value, fin, depth)
        elif isinstance(st, ast.Delete):
            for tgt in st.targets:
                if isinstance(tgt, ast.Subscript):
                    attr = self._self_attr(tgt)
                    if attr is not None:
                        self.fn.removals.append(
                            (attr, st, fin, depth > 0))
        elif isinstance(st, (ast.If, ast.While)):
            self.expr(st.test, fin, depth)
            self.body(st.body, fin, depth)
            self.body(st.orelse, fin, depth)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self.expr(st.iter, fin, depth)
            self.body(st.body, fin, depth)
            self.body(st.orelse, fin, depth)
        elif isinstance(st, ast.Return):
            if st.value is not None:
                self.expr(st.value, fin, depth)
        else:
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.stmt):
                    self.stmt(child, fin, depth)
                elif isinstance(child, ast.expr):
                    self.expr(child, fin, depth)

    def target(self, tgt, st, fin: bool, depth: int) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self.target(el, st, fin, depth)
            return
        if isinstance(tgt, ast.Subscript):
            attr = self._self_attr(tgt)
            if attr is not None:
                self.fn.inserts.append((attr, st, fin, depth > 0))
            return
        if isinstance(tgt, ast.Attribute) and \
                isinstance(tgt.value, ast.Name) and \
                tgt.value.id == self.self_name:
            self.fn.reassigns.append((tgt.attr, st))

    # -- expressions --

    def expr(self, e, fin: bool, depth: int) -> None:
        if e is None:
            return
        if isinstance(e, ast.Call):
            self.call(e, fin, depth, owned=False)
            return
        if isinstance(e, (ast.Yield, ast.YieldFrom)):
            if depth == 0:
                self.fn.is_gen = True
                self.fn.last_yield_line = max(
                    self.fn.last_yield_line, e.lineno)
            if getattr(e, "value", None) is not None:
                self.expr(e.value, fin, depth)
            return
        if isinstance(e, ast.Lambda):
            return  # runs later; bodies checked at the submit site
        if isinstance(e, ast.Compare):
            # an ORDERING comparison involving the attr (len() or set
            # >=) is a bound/alignment check; membership (in/not in)
            # is not — a dedup test against a grow-only cache is the
            # leak, not its bound
            ordered = any(not isinstance(op, (ast.In, ast.NotIn))
                          for op in e.ops)
            for sub in [e.left] + list(e.comparators):
                if isinstance(sub, ast.Call) and \
                        _dotted(sub.func) == "len" and sub.args:
                    attr = self._self_attr(sub.args[0])
                    if attr is not None:
                        self.fn.len_refs.add(attr)
                elif ordered:
                    attr = self._self_attr(sub)
                    if attr is not None:
                        self.fn.len_refs.add(attr)
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self.expr(child, fin, depth)

    def call(self, node: ast.Call, fin: bool, depth: int,
             owned: bool) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            recv = _dotted(f.value)
            name = f.attr
            if name in _PAIRS:
                self.fn.acquires.append((recv, name, node, owned, fin))
            if name in _RELEASES:
                self.fn.releases.append((recv, name, node, fin))
            attr = self._self_attr(f.value)
            if attr is not None:
                if name in _INSERTS:
                    self.fn.inserts.append((attr, node, fin, depth > 0))
                elif name in _REMOVALS:
                    self.fn.removals.append(
                        (attr, node, fin, depth > 0))
            if name == "acquire" and "broker" in recv.lower():
                has_deadline = len(node.args) >= 3 or any(
                    k.arg == "deadline" for k in node.keywords)
                if not has_deadline:
                    self.fn.broker_no_deadline.append(node)
            if name in _SUBMITTERS:
                arg_names = [a.id for a in node.args
                             if isinstance(a, ast.Name)]
                has_lambda = any(isinstance(a, ast.Lambda)
                                 for a in node.args)
                self.fn.submits.append((node, arg_names, has_lambda))
        elif isinstance(f, ast.Name):
            if f.id == "len" and node.args:
                attr = self._self_attr(node.args[0])
                if attr is not None:
                    self.fn.len_refs.add(attr)
        for a in node.args:
            self.expr(a, fin, depth)
        for k in node.keywords:
            self.expr(k.value, fin, depth)
        if isinstance(f, ast.Attribute):
            self.expr(f.value, fin, depth)
        elif not isinstance(f, ast.Name):
            self.expr(f, fin, depth)


def _scan_fn(node, self_name: "str | None") -> _Fn:
    fn = _Fn(node.name, node)
    _Walk(fn, self_name).body(node.body, False, 0)
    return fn


_CLASSES: dict = {}  # bare class name -> _Class (unique across run)
# serializes whole-analysis runs: the registry is process-global, so
# concurrent check_sources() calls must not interleave clear/register
_REG_LOCK = threading.RLock()


def _ctor_name(value) -> "str | None":
    if isinstance(value, ast.Call):
        name = _dotted(value.func).rsplit(".", 1)[-1]
        return name or None
    return None


def _scan_class(node: ast.ClassDef, modname: str) -> _Class:
    cls = _Class(node.name, modname, node)
    for st in node.body:
        if not isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        self_name = st.args.args[0].arg if st.args.args else None
        cls.method_nodes[st.name] = st
        cls.methods[st.name] = _scan_fn(st, self_name)
        if st.name in _INIT_NAMES and self_name is not None:
            _scan_init(st, self_name, cls)
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            ctor = _dotted(n.func).rsplit(".", 1)[-1]
            if ctor in ("Thread", "Timer"):
                cls.spawns_thread = True
    with _REG_LOCK:
        _CLASSES.setdefault(cls.name, cls)
    return cls


def _scan_init(node, self_name: str, cls: _Class) -> None:
    for st in ast.walk(node):
        if not isinstance(st, ast.Assign):
            continue
        for tgt in st.targets:
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == self_name):
                continue
            ctor = _ctor_name(st.value)
            if ctor is not None and ctor[:1].isupper() and \
                    ctor not in _EMPTY_CTORS:
                cls.attr_ctors.setdefault(tgt.attr, ctor)
            if isinstance(st.value, (ast.Dict, ast.List, ast.Set)) \
                    or ctor in _EMPTY_CTORS:
                cls.containers.setdefault(tgt.attr, st)


# ---------------- rules ----------------


def _release_in_finally(fn: _Fn, recv: str, names) -> bool:
    return any(r_fin for r_recv, r_name, _n, r_fin in fn.releases
               if r_recv == recv and r_name in names and r_fin)


def _has_release(fn: _Fn, recv: str, names) -> bool:
    return any(r_recv == recv and r_name in names
               for r_recv, r_name, _n, _f in fn.releases)


def _check_r001(fn: _Fn, filename: str, findings: list) -> None:
    for recv, name, node, owned, fin in fn.acquires:
        if not owned or fin:
            continue
        names = _PAIRS[name]
        if not _has_release(fn, recv, names):
            continue  # cross-function protocol — leaksan's beat
        if not _release_in_finally(fn, recv, names):
            findings.append(Finding(
                filename, node.lineno, node.col_offset, "R001",
                RULES["R001"],
                f"{recv}.{name}() has a matching"
                f" {'/'.join(names)}() in this function but never"
                " inside a finally: an exception (or early return)"
                " between them strands the resource — release in a"
                " finally or use a with-block"))


def _removal_in_finally(fn: _Fn, attr: str) -> bool:
    return any(r_fin for r_attr, _n, r_fin, _nested in fn.removals
               if r_attr == attr and r_fin)


def _check_r002(fn: _Fn, filename: str, findings: list) -> None:
    if not fn.is_gen:
        return
    for attr, node, fin, nested in fn.inserts:
        if nested or fin or not _is_flight(attr):
            continue
        if node.lineno >= fn.last_yield_line:
            continue  # registered after the last yield: no suspension
        if not _removal_in_finally(fn, attr):
            findings.append(Finding(
                filename, node.lineno, node.col_offset, "R002",
                RULES["R002"],
                f"generator registers self.{attr} before a yield with"
                " no finally removing it: a consumer abandoning the"
                " stream strands the flight and wedges every waiter —"
                " pop it in a finally around the yields"))
    for recv, name, node, owned, fin in fn.acquires:
        if not owned or fin or node.lineno >= fn.last_yield_line:
            continue
        names = _PAIRS[name]
        if not _release_in_finally(fn, recv, names):
            findings.append(Finding(
                filename, node.lineno, node.col_offset, "R002",
                RULES["R002"],
                f"generator owns {recv}.{name}() across a yield with"
                f" no finally {'/'.join(names)}(): an abandoned"
                " stream never releases it"))


def _check_r003(fn: _Fn, filename: str, findings: list) -> None:
    dec_attrs: dict = {}
    for attr, _node, fin in fn.decs:
        dec_attrs[attr] = dec_attrs.get(attr, False) or fin
    for attr, node, _fin in fn.incs:
        if attr not in dec_attrs:
            continue  # paired in another method: the pair-table's beat
        dec_lines = [d.lineno for a, d, _f in fn.decs if a == attr]
        if not any(ln > node.lineno for ln in dec_lines):
            continue  # decrement precedes: accounting, not a gauge
        if not dec_attrs[attr]:
            findings.append(Finding(
                filename, node.lineno, node.col_offset, "R003",
                RULES["R003"],
                f"self.{attr} += 1 has a later -= 1 in this method"
                " but not in a finally: an exception between them"
                " leaks the gauge — decrement in a finally"))


def _handler_names(h) -> set:
    t = h.type
    names = set()
    for e in ([t] if not isinstance(t, ast.Tuple) else t.elts) \
            if t is not None else []:
        d = _dotted(e)
        if d:
            names.add(d.rsplit(".", 1)[-1])
    return names


def _handler_propagates(h) -> bool:
    for n in ast.walk(h):
        if isinstance(n, ast.Raise):
            return True
    if h.name:
        for n in ast.walk(h):
            if isinstance(n, ast.Name) and n.id == h.name and \
                    isinstance(n.ctx, ast.Load):
                return True
    for n in ast.walk(h):
        if isinstance(n, ast.Assign):
            for tgt in n.targets:
                if isinstance(tgt, ast.Attribute) and \
                        tgt.attr in ("error", "errors"):
                    return True
        if isinstance(n, ast.Call):
            d = _dotted(n.func).lower()
            if any(w in d for w in ("error", "record", "reject",
                                    "fail", "note")):
                return True
    return False


def _check_r004(fn: _Fn, filename: str, findings: list) -> None:
    for h in fn.handlers:
        caught = _handler_names(h) & _CANCEL_EXCS
        if not caught or _handler_propagates(h):
            continue
        findings.append(Finding(
            filename, h.lineno, h.col_offset, "R004", RULES["R004"],
            f"except {'/'.join(sorted(caught))} neither re-raises nor"
            " records the error: swallowed cancellation never reaches"
            " the layers holding slots for this statement — re-raise,"
            " or store it as the task's error"))


def _stop_reachable_attrs(cls: _Class) -> set:
    """Attrs referenced from the class's stop-path methods (one level
    of self-calls deep)."""
    nodes = [n for name, n in cls.method_nodes.items()
             if name in _STOP_NAMES]
    extra = set()
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    isinstance(sub.func.value, ast.Name) and \
                    sub.func.value.id == cls.self_name:
                extra.add(sub.func.attr)
    nodes += [cls.method_nodes[m] for m in extra
              if m in cls.method_nodes]
    refs = set()
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Attribute) and \
                    isinstance(sub.value, ast.Name) and \
                    sub.value.id == cls.self_name:
                refs.add(sub.attr)
    return refs


def _check_r005(cls: _Class, filename: str, findings: list) -> None:
    stoppable = {}
    for attr, ctor in cls.attr_ctors.items():
        target = _CLASSES.get(ctor)
        if target is None or target is cls:
            continue
        if target.spawns_thread and \
                set(target.method_nodes) & {"stop", "close",
                                            "shutdown"}:
            stoppable[attr] = ctor
    if not stoppable:
        return
    reachable = _stop_reachable_attrs(cls)
    init = cls.method_nodes.get("__init__")
    for attr, ctor in sorted(stoppable.items()):
        if attr in reachable:
            continue
        node = cls.containers.get(attr) or init or cls.node
        findings.append(Finding(
            filename, _attr_assign_line(init, attr, cls.self_name,
                                        node), 0, "R005",
            RULES["R005"],
            f"{cls.name}.{attr} holds a {ctor} (thread-owning, has a"
            " stop method) but no stop/close/shutdown path of"
            f" {cls.name} reaches it: its thread runs until process"
            " exit — add a stop path that stops the member"))


def _attr_assign_line(init, attr: str, self_name: str,
                      fallback) -> int:
    if init is not None:
        for st in ast.walk(init):
            if isinstance(st, ast.Assign):
                for tgt in st.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == self_name and \
                            tgt.attr == attr:
                        return st.lineno
    return fallback.lineno


def _check_r006(fn: _Fn, filename: str, findings: list) -> None:
    for node in fn.broker_no_deadline:
        findings.append(Finding(
            filename, node.lineno, node.col_offset, "R006",
            RULES["R006"],
            "broker acquire without deadline=: an admission wait on"
            " the statement path must observe the active Deadline"
            " (the deadline discipline) or a cancelled statement keeps"
            " queueing for slots it will never use"))


def _check_r007(cls: _Class, filename: str, findings: list) -> None:
    inserted: dict = {}
    removed: set = set()
    bounded: set = set()
    for name, fn in cls.methods.items():
        for attr, node, _fin, _nested in fn.inserts:
            if name not in _INIT_NAMES:
                inserted.setdefault(attr, []).append(node)
        for attr, _node, _fin, _nested in fn.removals:
            removed.add(attr)
        bounded |= fn.len_refs
        if name not in _INIT_NAMES:
            for attr, _node in fn.reassigns:
                # a rebuild/reset outside __init__ bounds the growth
                removed.add(attr)
    for attr in sorted(inserted):
        if attr not in cls.containers:
            continue
        if attr in removed or attr in bounded:
            continue
        node = inserted[attr][0]
        findings.append(Finding(
            filename, node.lineno, node.col_offset, "R007",
            RULES["R007"],
            f"{cls.name}.{attr} only ever grows: inserts with no"
            " removal, rebuild or len() bound anywhere in the class —"
            " a hot path feeding it leaks without limit; cap it, evict"
            " from it, or remove entries when their owner finishes"))


def _check_r008(fn: _Fn, filename: str, findings: list) -> None:
    if not fn.submits:
        return
    for attr, node, fin, nested in fn.inserts:
        if nested or not _is_flight(attr):
            continue
        after = [s for s, _a, _l in fn.submits
                 if s.lineno >= node.lineno]
        if not after:
            continue
        if not _removal_in_finally(fn, attr):
            findings.append(Finding(
                filename, node.lineno, node.col_offset, "R008",
                RULES["R008"],
                f"self.{attr} registered before a conveyor submit with"
                " no finally releasing it (in the closure or here):"
                " the flight crossed threads with no owner responsible"
                " for its release — discard it in the task's finally"))


# ---------------- entry points ----------------


def _check_module(tree, filename: str, modname: str,
                  findings: list) -> None:
    fns: list = []
    for st in tree.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns.append((_scan_fn(st, None), None))
        elif isinstance(st, ast.ClassDef):
            cls = _scan_class(st, modname)
            for fn in cls.methods.values():
                fns.append((fn, cls))
    for fn, _cls in fns:
        _check_r001(fn, filename, findings)
        _check_r002(fn, filename, findings)
        _check_r003(fn, filename, findings)
        _check_r004(fn, filename, findings)
        _check_r006(fn, filename, findings)
        _check_r008(fn, filename, findings)
        # nested defs get the per-function rules too (their facts also
        # fold into the parent for R001/R008 ownership)
        for sub in fn.nested.values():
            sub_fn = _scan_fn(sub, None)
            _check_r002(sub_fn, filename, findings)
            _check_r004(sub_fn, filename, findings)


def check_source(src: str, filename: str = "<string>",
                 modname: "str | None" = None) -> list:
    """Analyze one source text (tests); returns unsuppressed findings."""
    return check_sources([(src, filename, modname or "m")])


def check_sources(sources) -> list:
    """Analyze (src, filename, modname) triples as ONE program (R005
    resolves member classes across modules)."""
    with _REG_LOCK:
        return _check_sources_locked(sources)


def _check_sources_locked(sources) -> list:
    with _REG_LOCK:
        _CLASSES.clear()
    findings: list = []
    trees = []
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
                filename, e.lineno or 0, e.offset or 0, "R000",
                "syntax-error", str(e.msg)))
            continue
        trees.append((tree, filename, modname))
    # pass 1: register every class (R005 needs the full registry
    # before any holder is judged)
    for tree, _filename, modname in trees:
        for st in tree.body:
            if isinstance(st, ast.ClassDef):
                _scan_class(st, modname)
    # pass 2: per-module rules
    for tree, filename, modname in trees:
        _check_module(tree, filename, modname, findings)
        for st in tree.body:
            if isinstance(st, ast.ClassDef):
                cls = _CLASSES.get(st.name)
                if cls is not None and cls.node is st:
                    _check_r005(cls, filename, findings)
                    _check_r007(cls, filename, findings)
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
