"""Device-memory static analyzer: provenance rules M001-M008.

The port's own copy of ``ydb_tpu/analysis/devmem.py``, with torch
creators. Warm statements are (cached program or CUDA graph, resident
input set) pairs, which makes every stray device-tensor copy a leak of
device memory and every unrounded shape a fresh capture. This pass walks
the runtime packages — engine, ssa, kqp, blocks, serving — and proves
the discipline statically; the runtime half (``analysis/memsan.py``)
measures the bytes those seams actually allocate per statement.

Rules:

  M001 unbudgeted-device-alloc   device-tensor creation (``torch.zeros/
                                 ones/full/empty/stack/cat/as_tensor/
                                 tensor``, ``.to(device)``, ``.cuda()``,
                                 ``TableBlock.from_numpy``) outside a
                                 budget-charging seam (a ``memsan.seam/
                                 charge`` site, transitively via callers)
  M002 use-after-replay          a fused plan's static output
                                 (``cap.out`` / ``<captured>.out``) read
                                 after the next ``replay()`` without a
                                 clone — the replay overwrote it in place
                                 (the torch analog of use-after-donation:
                                 the buffer belongs to the graph)
  M003 graph-not-reset-on-grow   a ``grow``/``rebuild``/``resize`` path
                                 that drops a plan's graphs without
                                 ``.reset()`` — the graph keeps its
                                 private pool, holding the old
                                 capacity's memory (the grow hazard of the
                                 reference: a stale capture reused after
                                 grow)
  M004 unrounded-capture-shape   a block/tensor built with a
                                 data-dependent size (``len(...)``,
                                 ``.shape``) that never passes through
                                 ``shape_class``/``_round_up``/
                                 ``size_buckets`` — every distinct length
                                 becomes its own capture
  M005 device-closure-in-pool    a device tensor captured by a closure
                                 submitted to a conveyor/stream pool —
                                 the task handle pins the buffer for the
                                 statement's lifetime
  M006 grow-only-device-container  a container attribute accumulating
                                 device tensors with no eviction/budget
                                 valve anywhere in the class
  M007 per-dispatch-aux-staging  host->device staging of constant aux
                                 outside the cached ``device_aux`` idiom
                                 — re-ships the same tables every
                                 dispatch
  M008 device-across-yield       a device buffer bound before a
                                 ``yield`` and used after it — the
                                 buffer stays pinned while the consumer
                                 parks the generator

Capture-context exemptions (M001/M004/M007): tensors made inside a
captured function live in the graph's private pool (charged as the
``graph_pool`` component when the capture lands), and an eager run of
the same function is the dispatch's working set, so the scan skips
nested defs that their enclosing function hands to a capture or a
compiled program (returned, or passed as a call argument:
``CompiledProgram(run=run)``,
``FusedPlan(..., run_all, ...)``). A module whose first lines carry
``# ydb-devmem: device-module`` declares itself capture-context
wholesale (pure kernel modules); provenance rules still apply there.

Escape hatch: decorate a function ``@analysis.budget_ok("reason")`` to
declare its device allocations budgeted or bounded — it is neither
reported nor counted against callees. Line-level ``# ydb-lint:
disable=M001`` pragmas (shared suppress machinery) silence individual
sites.

Interprocedural: the analyzer reuses hotpath's module index and call
resolution. A function whose every indexed caller is (transitively)
budget-charging inherits the charge — staging helpers called only from
charging seams need no annotation of their own.

Run: ``python -m ydb_tpu_torch.analysis.devmem [path ...] [--json]
[--changed]``. Default scope: the runtime packages of ydb_tpu_torch.
Exit 1 on any unsuppressed finding.
"""

from __future__ import annotations

import ast
import json
import sys

from ydb_tpu_torch.analysis.hotpath import _Index, _Module, _modname_for
from ydb_tpu_torch.analysis.lint import Finding, _dotted
from ydb_tpu_torch.analysis.paths import collect_files, parse_cli
from ydb_tpu_torch.analysis.suppress import file_skipped, filter_suppressed

RULES = {
    "M001": "unbudgeted-device-alloc",
    "M002": "use-after-replay",
    "M003": "graph-not-reset-on-grow",
    "M004": "unrounded-capture-shape",
    "M005": "device-closure-in-pool",
    "M006": "grow-only-device-container",
    "M007": "per-dispatch-aux-staging",
    "M008": "device-across-yield",
}

#: the runtime packages the device-memory discipline governs
RUNTIME_PACKAGES = ("engine", "ssa", "kqp", "parallel", "blocks",
                    "serving")

#: device-tensor creators (M001/M007 subjects; M004 size checks)
_CREATOR_ROOTS = {
    "torch.zeros", "torch.ones", "torch.full", "torch.empty",
    "torch.stack", "torch.cat", "torch.as_tensor", "torch.tensor",
}
#: creator methods: ``TableBlock.from_numpy`` (``torch.from_numpy`` is a
#: host view, not a device allocation), ``.cuda()``
_CREATOR_METHODS = {"from_numpy", "cuda"}
#: size-rounding seams that legitimize a data-dependent capacity (M004)
_ROUNDERS = {"shape_class", "_round_up", "round_up", "size_buckets"}
#: wrappers that put a callee into trace context
_TRACE_WRAPPERS = ("make_graphed_callables",)
#: pool-submission entry points (M005)
_SUBMIT_NAMES = {"submit", "spawn", "defer", "map_async",
                 "apply_async"}


def _device_module(lines) -> bool:
    """``# ydb-devmem: device-module`` within the first 10 lines: the
    module is trace-context wholesale (pure kernel code)."""
    for ln in lines[:10]:
        if "ydb-devmem:" in ln and "device-module" in ln:
            return True
    return False


def _budget_ok_reason(node) -> "str | None":
    """The reason of an ``@analysis.budget_ok("...")`` decorator (or
    bare ``@budget_ok``); None when the function carries none."""
    for dec in getattr(node, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        last = _dotted(target).rsplit(".", 1)[-1].lstrip("_")
        if last == "budget_ok":
            if isinstance(dec, ast.Call) and dec.args and \
                    isinstance(dec.args[0], ast.Constant):
                return str(dec.args[0].value)
            return "unspecified"
    return None


def _is_jit_decorated(node) -> bool:
    """Any decorator mentioning a capture wrapper puts the body under
    capture."""
    for dec in getattr(node, "decorator_list", ()):
        for sub in ast.walk(dec):
            if isinstance(sub, (ast.Name, ast.Attribute)):
                last = _dotted(sub).rsplit(".", 1)[-1]
                if last in _TRACE_WRAPPERS:
                    return True
    return False


def _is_creator(call: ast.Call) -> "str | None":
    """The creator name when ``call`` builds a device tensor."""
    root = _dotted(call.func)
    if root in _CREATOR_ROOTS:
        return root
    attr = call.func.attr if isinstance(call.func, ast.Attribute) \
        else ""
    if attr in _CREATOR_METHODS and root != "torch.from_numpy" and \
            root != "np.from_numpy":
        return f".{attr}"
    if attr == "to" and _moves_to_device(call):
        return ".to"
    return None


def _moves_to_device(call: ast.Call) -> bool:
    """``t.to(dev)`` / ``t.to(device=dev)``: a copy onto a device (a
    dtype-only ``.to`` and ``.to("cpu")`` are not)."""
    vals = [k.value for k in call.keywords if k.arg == "device"]
    if call.args:
        vals.append(call.args[0])
    for v in vals:
        if isinstance(v, ast.Constant):
            if v.value == "cpu" or not isinstance(v.value, str):
                continue
            return True
        if isinstance(v, ast.Attribute) and (
                _dotted(v).startswith("torch.") or v.attr == "dtype"):
            continue  # torch.int64, x.dtype: a dtype conversion
        if isinstance(v, (ast.Name, ast.Attribute, ast.Call)):
            name = _dotted(v.func if isinstance(v, ast.Call) else v)
            low = name.rsplit(".", 1)[-1].lower()
            if "dev" in low or low in ("device", "torch.device"):
                return True
    return False


def _charging_call(call: ast.Call, imports: dict) -> bool:
    """Does this call charge a byte budget? ``memsan.seam/charge`` (by
    any alias; a seam also holds a dispatch's working set, the
    capture-context analog) and ``timeline.add_bytes`` qualify."""
    fn = call.func
    root = _dotted(fn)
    last = root.rsplit(".", 1)[-1]
    if last == "add_bytes":
        return True
    if last in ("seam", "charge"):
        if "memsan" in root:
            return True
        if isinstance(fn, ast.Name):
            origin = imports.get(fn.id, "")
            return "memsan" in origin
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name):
            origin = imports.get(fn.value.id, "")
            return "memsan" in origin
    return False


def _contains(expr, pred) -> bool:
    for sub in ast.walk(expr):
        if pred(sub):
            return True
    return False


def _data_dependent_size(expr) -> bool:
    """Does a size expression embed a raw data length (len()/.shape)
    without passing through a rounding seam?"""
    dependent = _contains(expr, lambda s: (
        isinstance(s, ast.Call) and isinstance(s.func, ast.Name)
        and s.func.id == "len")
        or (isinstance(s, ast.Attribute) and s.attr == "shape"))
    if not dependent:
        return False
    rounded = _contains(expr, lambda s: isinstance(s, ast.Call) and
                        _dotted(s.func).rsplit(".", 1)[-1] in _ROUNDERS)
    return not rounded


def _local_device_names(fn_node) -> dict:
    """name -> assignment lineno for locals bound directly to a device
    array (creator call / from_numpy / device_aux result) in this
    function's own body (nested defs excluded — their locals are their
    own scope)."""
    out: dict = {}

    def walk(stmts):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(st, ast.Assign) and \
                    isinstance(st.value, ast.Call):
                name = _is_creator(st.value)
                if name is None:
                    last = _dotted(st.value.func).rsplit(".", 1)[-1]
                    if last in ("device_aux",):
                        name = last
                if name is not None:
                    for t in st.targets:
                        if isinstance(t, ast.Name):
                            out[t.id] = st.lineno
            # recurse into compound-statement bodies (with/for/if/try)
            # but never nested scopes
            for part in ("body", "orelse", "finalbody"):
                sub = getattr(st, part, None)
                if isinstance(sub, list):
                    walk(sub)
            for h in getattr(st, "handlers", None) or ():
                walk(h.body)
    walk(fn_node.body)
    return out


class _ClassLedger:
    """Per-class evidence for M006: container attrs, device stores,
    removal/budget valves."""

    def __init__(self):
        self.containers: set = set()        # attr names init'd {} / []
        self.stores: list = []              # (attr, node, creator)
        self.removals: set = set()          # attrs with pop/del/clear
        self.has_valve = False              # evict/budget-family method


class _FnScan:
    """All M-rule checks over ONE indexed function (nested defs scanned
    in scope context)."""

    def __init__(self, info, mod: _Module, budget_ok: "str | None",
                 device_mod: bool, ledger: "_ClassLedger | None",
                 index: "_Index | None" = None):
        self.info = info
        self.mod = mod
        self.budget_ok = budget_ok
        self.device_mod = device_mod
        self.ledger = ledger
        self._index = index
        self.findings: list = []            # direct findings
        self.deferred: list = []            # coverage-gated findings
        self.calls: list = []               # (Call, traced) for edges
        self.charging = False
        self.device_locals = _local_device_names(info.node)
        # names put under trace in THIS body: jit(f)/vmap(f) args,
        # returned nested defs (the emit idiom), nested defs escaping
        # as call arguments (CompiledProgram(run=run)), nested defs
        # invoked from a traced scope (fixpoint in run())
        self.traced_names: set = set()
        self.nested_defs: dict = {}
        self._prepass(info.node)
        # findings muted during trace-propagation passes
        self._mute = False
        # Lambda nodes that are arguments of a trace wrapper
        self._traced_lambdas: set = set()

    # ---- pre-pass: trace context + charging evidence ----

    def _prepass(self, fn_node) -> None:
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Call):
                if _charging_call(node, self.mod.imports):
                    self.charging = True
                last = _dotted(node.func).rsplit(".", 1)[-1]
                if last in _TRACE_WRAPPERS:
                    for a in list(node.args) + \
                            [k.value for k in node.keywords]:
                        if isinstance(a, ast.Name):
                            self.traced_names.add(a.id)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) and \
                    node is not fn_node:
                self.nested_defs[node.name] = node
            elif isinstance(node, ast.Return) and \
                    node.value is not None:
                # a returned nested def is deferred computation the
                # enclosing function wires into a traced dispatch (the
                # lowering emit idiom) — bare or inside a returned tuple
                vals = node.value.elts if isinstance(
                    node.value, (ast.Tuple, ast.List)) else [node.value]
                for v in vals:
                    if isinstance(v, ast.Name):
                        self.traced_names.add(v.id)

    # ---- the passes ----

    def run(self) -> None:
        traced0 = self.device_mod or _is_jit_decorated(self.info.node)
        # trace propagation to fixpoint (a nested def called from a
        # traced scope is itself traced), muted; then one emit pass
        self._mute = True
        for _ in range(6):
            before = len(self.traced_names)
            self.calls = []
            self._walk(self.info.node.body, traced=traced0)
            if len(self.traced_names) == before:
                break
        self._mute = False
        self.calls = []
        self._walk(self.info.node.body, traced=traced0)
        self._check_donation_uses(self.info.node)
        self._grow_site()
        if any(isinstance(n, (ast.Yield, ast.YieldFrom))
               for n in self._own_exprs(self.info.node)):
            self._check_yield_pins(self.info.node)

    def _emit(self, node, code: str, message: str) -> None:
        if self._mute:
            return
        self.findings.append(Finding(
            self.info.filename, node.lineno, node.col_offset, code,
            RULES[code], message))

    # ---- scoped walk: M001/M003/M004/M005/M007 ----

    def _walk(self, stmts, traced: bool) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # the nested def's OWN trace context; its children are
                # walked here only (never through _node)
                sub_traced = traced or \
                    st.name in self.traced_names or \
                    _is_jit_decorated(st)
                self._walk(st.body, traced=sub_traced)
                continue
            for node in ast.iter_child_nodes(st):
                self._node(node, st, traced)

    def _node(self, node, stmt, traced: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def inside a compound statement: walk its body in
            # its own trace context
            self._walk(node.body, traced=traced or
                       node.name in self.traced_names or
                       _is_jit_decorated(node))
            return
        if isinstance(node, ast.Call):
            self._call(node, stmt, traced)
        if isinstance(node, ast.Lambda):
            # lambdas handed to a trace wrapper run under XLA; any
            # other lambda body (tree_map stackers, sort keys) runs in
            # the enclosing context
            self._node(node.body, stmt,
                       traced or node in self._traced_lambdas)
            return
        for sub in ast.iter_child_nodes(node):
            self._node(sub, stmt, traced)

    def _call(self, call: ast.Call, stmt, traced: bool) -> None:
        self.calls.append((call, traced))
        root = _dotted(call.func)
        attr = call.func.attr if isinstance(call.func, ast.Attribute) \
            else ""
        creator = _is_creator(call)
        last = root.rsplit(".", 1)[-1]

        # ---- trace propagation (consumed by run()'s fixpoint) ----
        if isinstance(call.func, ast.Name) and traced and \
                call.func.id in self.nested_defs:
            # a nested def invoked from a traced scope is traced
            self.traced_names.add(call.func.id)
        if attr not in _SUBMIT_NAMES:
            # a nested def escaping as a call argument is deferred
            # computation wired into a traced dispatch
            # (CompiledProgram(run=run), _GroupByLowered(lower=lower));
            # pool submits stay host context (M005 territory)
            for a in list(call.args) + [k.value for k in call.keywords]:
                if isinstance(a, ast.Name) and \
                        a.id in self.nested_defs:
                    self.traced_names.add(a.id)
                elif isinstance(a, ast.Lambda) and \
                        last in _TRACE_WRAPPERS:
                    self._traced_lambdas.add(a)

        if creator is not None and not traced and not self._mute:
            fnkey = (self.info.modname, self.info.qualname)
            # ---- M004: data-dependent size (trace-coverage-gated:
            # shapes inside a trace are static by construction) ----
            size_args = [kw.value for kw in call.keywords
                         if kw.arg == "capacity"]
            if not size_args and call.args and creator != ".from_numpy":
                size_args = [call.args[0]]
            for sa in size_args:
                if _data_dependent_size(sa):
                    self.deferred.append((Finding(
                        self.info.filename, call.lineno,
                        call.col_offset, "M004", RULES["M004"],
                        f"{creator}(...) sized by a raw data length:"
                        " every distinct length is a fresh capture;"
                        " round through shape_class()/_round_up() so"
                        " same-class re-runs replay one graph"),
                        fnkey, None))
            # ---- M007: aux staged outside device_aux ----
            if self._touches_aux(call) and \
                    self.info.node.name != "device_aux":
                self.deferred.append((Finding(
                    self.info.filename, call.lineno, call.col_offset,
                    "M007", RULES["M007"],
                    f"{creator}(...) stages constant aux per dispatch;"
                    " route it through the cached device_aux idiom so"
                    " repeated dispatches reuse the staged tables"),
                    fnkey, None))
            # ---- M001: deferred until coverage is known. A creator
            # METHOD whose callee charges its own budget (the
            # instrumented from_numpy) budgets the call site too ----
            elif not (self.charging or self.budget_ok):
                callee = None
                if creator.startswith(".") and self._index is not None:
                    tgt = _resolve_call(self._index, self.mod,
                                        self.info, call)
                    if tgt is not None:
                        callee = ((tgt.modname, tgt.qualname),)
                    else:
                        # an ambiguous method name (TableBlock.from_numpy
                        # and Stager.from_numpy): budgeted when every
                        # candidate charges
                        callee = tuple(
                            (c.modname, c.qualname) for c in
                            self._index.methods.get(creator[1:], ()))
                        callee = callee or None
                self.deferred.append((Finding(
                    self.info.filename, call.lineno, call.col_offset,
                    "M001", RULES["M001"],
                    f"{creator}(...) creates a device tensor outside"
                    " any budget-charging seam: charge it via"
                    " memsan.seam()/charge() or annotate the function"
                    " @analysis.budget_ok"),
                    fnkey, callee))

        # ---- M005: device capture into a pool submit ----
        if attr in _SUBMIT_NAMES and call.args:
            self._submit_site(call)

        # ---- M006 evidence: stores handled at statement level ----
        if self.ledger is not None and not self._mute:
            self._ledger_call(call, attr)

    # ---- M003 / M002 ----

    def _grow_site(self) -> None:
        """M003: a grow/rebuild path that drops a plan's graphs
        (``<graphs>.clear()`` / ``= {}`` on an attribute naming graphs)
        without calling ``.reset()`` on them in the same function."""
        name = self.info.node.name.lower()
        if not any(k in name for k in ("grow", "rebuild", "resize",
                                       "release")):
            return
        drops = []
        resets = False
        for node in ast.walk(self.info.node):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                if node.func.attr == "reset":
                    resets = True
                elif node.func.attr == "clear" and \
                        "graph" in _dotted(node.func.value).lower():
                    drops.append(node)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            "graph" in t.attr.lower():
                        drops.append(node)
        if drops and not resets:
            for node in drops:
                self._emit(node, "M003",
                           "graphs dropped on a grow/rebuild path without"
                           " .reset(): each CUDA graph keeps its private"
                           " pool (the old capacity's memory) until it"
                           " is collected; reset every graph before"
                           " dropping it")

    def _check_donation_uses(self, fn_node) -> None:
        """M002: a captured graph's static output (``X.out``, where
        ``X.graph.replay()`` runs in this function) read after the
        replay other than as the argument of a clone — whoever holds it
        sees the next replay rewrite it in place."""
        replays: dict = {}  # owner dotted -> first replay line
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "replay":
                recv = node.func.value
                if isinstance(recv, ast.Attribute) and \
                        recv.attr == "graph":
                    owner = _dotted(recv.value)
                    replays[owner] = min(replays.get(owner, node.lineno),
                                         node.lineno)
        if not replays:
            return
        cloned: set = set()
        for node in ast.walk(fn_node):
            if not isinstance(node, ast.Call):
                continue
            last = _dotted(node.func).rsplit(".", 1)[-1].lower()
            if "clone" not in last:
                continue
            for a in list(node.args) + [node.func]:
                for sub in ast.walk(a):
                    if isinstance(sub, ast.Attribute) and sub.attr == "out":
                        cloned.add(id(sub))
        for node in ast.walk(fn_node):
            if not (isinstance(node, ast.Attribute) and node.attr == "out"
                    and isinstance(node.ctx, ast.Load)):
                continue
            owner = _dotted(node.value)
            first = replays.get(owner)
            if first is None or node.lineno <= first or \
                    id(node) in cloned:
                continue
            self._emit(
                node, "M002",
                f"{owner}.out, a CUDA graph's static output, used after"
                " replay() without a clone: the next replay rewrites it"
                " in place under whoever holds it — hand out a clone")

    # ---- M005 ----

    def _submit_site(self, call: ast.Call) -> None:
        task = call.args[0]
        captured: "list[str]" = []
        if isinstance(task, ast.Lambda):
            params = {a.arg for a in task.args.args}
            for sub in ast.walk(task.body):
                if isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, ast.Load) and \
                        sub.id in self.device_locals and \
                        sub.id not in params:
                    captured.append(sub.id)
        elif isinstance(task, ast.Name) and \
                task.id in self.nested_defs:
            nd = self.nested_defs[task.id]
            params = {a.arg for a in nd.args.args}
            locals_ = {t.id for n in ast.walk(nd)
                       for t in ([n] if isinstance(n, ast.Name) and
                                 isinstance(n.ctx, ast.Store) else [])}
            for sub in ast.walk(nd):
                if isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, ast.Load) and \
                        sub.id in self.device_locals and \
                        sub.id not in params and sub.id not in locals_:
                    captured.append(sub.id)
        if captured:
            names = ", ".join(sorted(set(captured)))
            self._emit(
                call, "M005",
                f"closure submitted to a pool captures device"
                f" array(s) {names}: the task handle pins the HBM"
                " buffer until the pool runs and drops it — pass host"
                " data / a loader and stage inside the task, or hand"
                " over an owning reference the task releases")

    # ---- M006 evidence ----

    def _ledger_call(self, call: ast.Call, attr: str) -> None:
        led = self.ledger
        f = call.func
        if not (isinstance(f, ast.Attribute) and
                isinstance(f.value, ast.Attribute) and
                isinstance(f.value.value, ast.Name) and
                f.value.value.id == "self"):
            if attr in ("pop", "clear") and \
                    isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Attribute) and \
                    isinstance(f.value.value, ast.Name):
                pass
            return
        target_attr = f.value.attr
        if attr in ("pop", "clear", "popitem"):
            led.removals.add(target_attr)
        elif attr in ("append", "add", "setdefault") and call.args:
            arg = call.args[-1]
            creator = isinstance(arg, ast.Call) and \
                _is_creator(arg) is not None
            tracked = isinstance(arg, ast.Name) and \
                arg.id in self.device_locals
            if creator or tracked:
                led.stores.append((target_attr, call))

    def scan_statements_for_ledger(self) -> None:
        """Subscript stores + dels feeding the class M006 ledger."""
        led = self.ledger
        if led is None:
            return
        name = self.info.node.name
        for node in ast.walk(self.info.node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            self._self_attr(t.value):
                        a = self._self_attr(t.value)
                        v = node.value
                        creator = isinstance(v, ast.Call) and \
                            _is_creator(v) is not None
                        tracked = isinstance(v, ast.Name) and \
                            v.id in self.device_locals
                        if creator or tracked:
                            led.stores.append((a, node))
                    elif isinstance(t, ast.Attribute) and \
                            name == "__init__" and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        if self._container_init(node.value):
                            led.containers.add(t.attr)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            self._self_attr(t.value):
                        led.removals.add(self._self_attr(t.value))
        low = name.lower()
        if any(k in low for k in ("evict", "budget", "trim", "sweep",
                                  "invalidate", "drop", "clear",
                                  "release")):
            led.has_valve = True

    @staticmethod
    def _self_attr(node) -> "str | None":
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self":
            return node.attr
        return None

    @staticmethod
    def _container_init(value) -> bool:
        if isinstance(value, (ast.Dict, ast.List)):
            return True
        if isinstance(value, ast.Call):
            last = _dotted(value.func).rsplit(".", 1)[-1]
            if last == "share" and value.args and \
                    isinstance(value.args[0], (ast.Dict, ast.List)):
                return True
            if last in ("dict", "list", "OrderedDict", "defaultdict"):
                return True
        return False

    # ---- M007 helper ----

    @staticmethod
    def _touches_aux(call: ast.Call) -> bool:
        for a in call.args:
            for sub in ast.walk(a):
                n = ""
                if isinstance(sub, ast.Name):
                    n = sub.id
                elif isinstance(sub, ast.Attribute):
                    n = sub.attr
                if "aux" in n.lower():
                    return True
        return False

    # ---- M008 ----

    def _own_exprs(self, fn_node):
        """AST nodes of this function excluding nested defs/lambdas."""
        stack = list(fn_node.body)
        while stack:
            st = stack.pop()
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
                continue
            yield st
            stack.extend(ast.iter_child_nodes(st))

    def _check_yield_pins(self, fn_node) -> None:
        yields = [n.lineno for n in self._own_exprs(fn_node)
                  if isinstance(n, (ast.Yield, ast.YieldFrom))]
        if not yields or not self.device_locals:
            return
        for node in self._own_exprs(fn_node):
            if not (isinstance(node, ast.Name) and
                    isinstance(node.ctx, ast.Load)):
                continue
            bound = self.device_locals.get(node.id)
            if bound is None:
                continue
            if any(bound < y < node.lineno for y in yields):
                self._emit(
                    node, "M008",
                    f"device buffer {node.id!r} (bound at line"
                    f" {bound}) is held across a yield: the slab"
                    " stays pinned in HBM while the consumer parks"
                    " the generator — stage per iteration or release"
                    " before yielding")


# ---------------- program-level analysis ----------------


def _resolve_call(index: _Index, mod: _Module, info, call: ast.Call):
    """hotpath's call resolution, reused for coverage edges."""
    fn = call.func
    if isinstance(fn, ast.Name):
        name = fn.id
        if name in mod.classes:
            return None
        local = mod.fns.get(name)
        if local is not None and local.cls is None:
            return local
        origin = mod.imports.get(name)
        if origin is not None:
            return index.resolve_from(origin)
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    recv = fn.value
    if isinstance(recv, ast.Name) and recv.id == "self" and \
            info.cls is not None:
        local = mod.fns.get(f"{info.cls}.{fn.attr}")
        if local is not None:
            return local
    if isinstance(recv, ast.Name):
        origin = mod.imports.get(recv.id)
        if origin is not None:
            tgt = index.resolve_from(f"{origin}.{fn.attr}")
            if tgt is not None:
                return tgt
            # origin may be an imported CLASS (TableBlock.from_numpy):
            # fall through to the unique-method map
    return index.unique_method(fn.attr)


def check_sources(sources, report_files=None) -> list:
    """Analyze (src, filename, modname) triples as one program;
    ``report_files`` narrows REPORTING without shrinking the coverage
    index (the hotpath rule — a charging caller outside the changed
    set must still cover its staging helper)."""
    findings: list = []
    modules: list = []
    lines_by_file: dict = {}
    device_mods: set = set()
    for src, filename, modname in sources:
        lines = src.splitlines()
        lines_by_file[filename] = lines
        if file_skipped(lines):
            continue
        try:
            tree = ast.parse(src, filename=filename)
        except SyntaxError as e:
            findings.append(Finding(
                filename, e.lineno or 0, e.offset or 0, "M000",
                "syntax-error", str(e.msg)))
            continue
        m = _Module(
            modname if modname is not None else _modname_for(filename),
            filename, tree)
        modules.append(m)
        if _device_module(lines):
            device_mods.add(m.modname)
    index = _Index(modules)

    scans: dict = {}
    ledgers: dict = {}
    deferred: list = []
    charging: set = set()
    edges: dict = {}  # (mod, qual) -> set of (caller key, traced)
    for m in modules:
        for info in m.fns.values():
            reason = _budget_ok_reason(info.node)
            led = None
            if info.cls is not None:
                led = ledgers.setdefault((m.modname, info.cls),
                                         _ClassLedger())
            scan = _FnScan(info, m, reason, m.modname in device_mods,
                           led, index)
            scan.run()
            scan.scan_statements_for_ledger()
            key = (info.modname, info.qualname)
            scans[key] = scan
            findings.extend(scan.findings)
            deferred.extend(scan.deferred)
            if scan.charging or reason is not None:
                charging.add(key)
            for call, traced in scan.calls:
                tgt = _resolve_call(index, m, info, call)
                if tgt is not None:
                    edges.setdefault(
                        (tgt.modname, tgt.qualname),
                        set()).add((key, traced))

    # discharge fixpoint for M001: a function is discharged when it
    # charges a budget itself (or is budget_ok), or when every indexed
    # call site reaching it is either under trace (XLA temporaries) or
    # inside a discharged function (allocations land in the caller's
    # charged seam)
    covered = set(charging)
    changed = True
    while changed:
        changed = False
        for key, callers in edges.items():
            if key in covered or not callers:
                continue
            if all(t or c in covered for c, t in callers):
                covered.add(key)
                changed = True

    # trace fixpoint for M004/M007: reached ONLY from trace-context
    # call sites — shapes are static by construction there, and aux is
    # a traced operand, so the retrace/re-staging rules do not apply.
    # Charging is NOT enough here: a charged seam still retraces on
    # unrounded shapes.
    trace_covered: set = set()
    changed = True
    while changed:
        changed = False
        for key, callers in edges.items():
            if key in trace_covered:
                continue
            if key in charging:
                continue  # a charging seam is a host boundary
            if callers and all(t or c in trace_covered
                               for c, t in callers):
                trace_covered.add(key)
                changed = True

    for f, fnkey, callee in deferred:
        if fnkey in trace_covered:
            continue
        if f.code == "M001" and (fnkey in covered or (
                callee is not None and all(c in covered
                                           for c in callee))):
            continue
        findings.append(f)

    # M006: stores into grow-only containers with no valve
    for (modname, cls), led in ledgers.items():
        if led.has_valve:
            continue
        for attr, node in led.stores:
            if attr in led.containers and attr not in led.removals:
                findings.append(Finding(
                    next(m.filename for m in modules
                         if m.modname == modname),
                    node.lineno, node.col_offset, "M006",
                    RULES["M006"],
                    f"device arrays accumulate in self.{attr} and"
                    f" {cls} never evicts from it (no pop/del/clear,"
                    " no evict/budget valve): a grow-only device"
                    " container pins HBM for the process lifetime"))

    kept: list = []
    for filename, lines in lines_by_file.items():
        if report_files is not None and filename not in report_files:
            continue
        here = [f for f in findings if f.file == filename]
        kept.extend(filter_suppressed(here, lines, RULES))
    return sorted(kept, key=lambda f: (f.file, f.line, f.col, f.code))


def check_source(src: str, filename: str = "<string>",
                 modname: "str | None" = None) -> list:
    """Analyze one source text (tests)."""
    return check_sources([(src, filename, modname)])


def runtime_scope(files) -> list:
    """Restrict collected files to the runtime packages (paths outside
    a ydb_tpu_torch tree — fixtures — pass through untouched)."""
    kept = []
    for f in files:
        parts = str(f).split("/")
        if "ydb_tpu_torch" in parts:
            i = len(parts) - 1 - parts[::-1].index("ydb_tpu_torch")
            if i + 1 >= len(parts) or \
                    parts[i + 1] not in RUNTIME_PACKAGES:
                continue
        kept.append(f)
    return kept


def check_paths(paths, report_files=None) -> list:
    sources = []
    for f in runtime_scope(paths):
        sources.append((f.read_text(encoding="utf-8"), str(f), None))
    return check_sources(sources, report_files=report_files)


def main(argv=None) -> int:
    paths, as_json, changed = parse_cli(argv)
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
