"""Cross-query micro-batching dispatcher (the serving tier's core).

Fused plans are keyed by (plan fingerprint, shape-class vector) —
compatible queued statements are *literally the same executable*
(``plan_fuse.PlanSignature.cache_key``). Under concurrency this
dispatcher holds admitted SELECT statements for a bounded window
(``YDB_TPU_TORCH_BATCH_WINDOW_MS``, default 0 → disarmed, the serial path is
untouched), groups arrivals by that cache key, and serves the whole
group with ONE device dispatch instead of N:

* **Dedup (the common serving case).** N statements over the same
  snapshot stage the same input blocks — the batch stages each distinct
  scan identity once (attaching to in-flight stagings via
  ``engine.scanshare.ScanShare``) and, when every member's staged
  inputs are identical, runs the plan ONCE via
  ``FusedPlan.run_shared``; every member's result is the same block.
  This is where the >=2x QPS win lives: the window turns N identical
  dispatches into 1.
* **Stacked (distinct inputs).** Members whose staged inputs differ
  (different snapshots / tables mutated between arrivals) stack along a
  leading batch axis into one batched dispatch
  (``FusedPlan.run_stacked``), each member slicing its own row off the
  batched result (``plan_fuse.slice_member``). One trace per batch
  size; the per-member staged blocks (possibly shared with concurrent
  statements) are copied into the graph's inputs and never written.

Protocol: the first arrival for a key becomes the **leader** — it waits
out the window (early close when ``YDB_TPU_TORCH_BATCH_MAX`` members gather,
capped by its own deadline budget), closes the group, stages, dispatches
and distributes. Later arrivals are **followers**: they enqueue and wait
on a per-member event with deadline-capped timed waits. Fairness is
inherited, not reinvented: batching sits AFTER workload-pool admission
and resource-manager slot acquisition, so a statement only ever waits in
a batch it was already admitted to run.

Isolation: the leader executes under a cleared deadline
(``deadline.activate(None)``) and re-checks its OWN budget only after
distributing — a deadline cancel of one member (leader included) never
cancels or corrupts its batchmates. Real execution errors (staging
faults, compile failures) are genuinely shared — one dispatch served
everyone — and propagate to every member.

A group of one is not a batch: the leader returns the statement to the
caller's serial path unchanged (same spans, same walk fallbacks), so an
idle server pays only the window wait.

The port's own copy of ``ydb_tpu/kqp/batch.py``. On CUDA each dispatch
is a CUDA graph replay: ``run_shared`` replays the plan's serial graph,
``run_stacked`` the graph captured for that batch size over B static
input sets. Each member's scan sites stage into FRESH blocks
(``executor._stage_fused_site(site, db)`` without a plan): the serial
path's staging writes the plan's single static input block, which
stacked members over different sources would all share. The leader
dispatches holding ``device.work_lock`` shared (a capture retries it
exclusively); members waiting on their leader hold none of it.
"""

from __future__ import annotations

import os
import threading
import time

from ydb_tpu_torch.analysis import leaksan, sanitizer
from ydb_tpu_torch.chaos import deadline as statement_deadline
from ydb_tpu_torch.device import work_lock
from ydb_tpu_torch.engine.scanshare import ScanShare
from ydb_tpu_torch.obs import tracing
from ydb_tpu_torch.plan.nodes import TableScan

#: follower safety re-check period — bounds every event wait (the
#: concurrency analyzer's C003 discipline) and lets a deadline that
#: fires mid-batch cancel the waiter promptly
MEMBER_WAIT_TICK_SECONDS = 1.0


def _env_window_ms() -> float:
    try:
        return float(os.environ.get("YDB_TPU_TORCH_BATCH_WINDOW_MS", "0") or 0)
    except ValueError:
        return 0.0


def _env_max_batch() -> int:
    try:
        return max(2, int(os.environ.get("YDB_TPU_TORCH_BATCH_MAX", "32")))
    except ValueError:
        return 32


class _Member:
    """One queued statement's seat in a batch group."""

    __slots__ = ("db", "identity", "uindex", "event", "result", "error",
                 "shared_scan", "t_enq", "tok")

    def __init__(self, db, identity, tok):
        self.db = db
        self.identity = identity   # per-site staging identity vector
        self.uindex = 0            # index into the group's unique inputs
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.shared_scan = 0       # sites served by a shared staging
        self.t_enq = time.perf_counter()
        self.tok = tok


class _Group:
    """An open batch: members gather until the window closes."""

    __slots__ = ("key", "sig", "members", "closed", "full", "batch_id",
                 "t_closed", "execute_seconds")

    def __init__(self, key, sig):
        self.key = key
        self.sig = sig
        self.members: list[_Member] = []
        self.closed = False
        self.full = False
        self.batch_id = 0
        self.t_closed = 0.0
        self.execute_seconds = 0.0


class BatchDispatcher:
    """Window-batched fused dispatch across concurrent sessions.

    ``execute`` returns the member's device result block, or ``None``
    when the statement should run the ordinary serial path (dispatcher
    disarmed, plan not batchable, or the group closed with one member).
    """

    def __init__(self, window_ms: float | None = None,
                 max_batch: int | None = None):
        self.window_ms = (_env_window_ms() if window_ms is None
                          else float(window_ms))
        self.max_batch = (_env_max_batch() if max_batch is None
                          else max(2, int(max_batch)))
        self._cv = sanitizer.make_condition(f"batch.{id(self):x}")
        self._open = sanitizer.share(
            {}, f"batch.{id(self):x}.open")  # key -> _Group
        self.share = ScanShare()
        self._batch_seq = 0
        # counters (mutated under _cv's lock; read by run_background)
        self.batches = 0             # closed groups with >= 2 members
        self.solo = 0                # groups that closed with 1 member
        self.batched_statements = 0  # members served by a batch
        self.dedup_dispatches = 0    # batches served by ONE run_shared
        self.stacked_dispatches = 0  # batches served by run_stacked
        self.max_batch_size = 0
        # CUDA graph captures paid by batched dispatches, per batch size
        # (1 = a dedup run_shared), and the seconds of those dispatches
        self.graph_captures: dict[int, int] = {}
        self.capture_seconds = 0.0

    def armed(self) -> bool:
        return self.window_ms > 0

    # -- admission ----------------------------------------------------

    def execute(self, plan, db, cluster=None, active_tok=None):
        """Batch-execute ``plan`` if a compatible group forms; ``None``
        sends the caller down the unchanged serial path."""
        if not self.armed():
            return None
        if getattr(db, "mesh_executor", None) is not None:
            # mesh dispatch already amortizes across devices; batching
            # targets the single-chip fused path
            return None
        from ydb_tpu_torch.ssa import plan_fuse

        if not plan_fuse.fusion_enabled() or isinstance(plan, TableScan):
            return None
        sig = plan_fuse.plan_signature_cached(plan, db)
        if sig is None or not sig.sites:
            return None
        key = sig.cache_key(db)
        member = _Member(db, self._identity_vector(sig, db), active_tok)
        lk = leaksan.track("batch.member", f"m{id(member):x}",
                           owner=active_tok)
        try:
            with tracing.span("dispatch.batch") as sp:
                with self._cv:
                    g = self._open.get(key)
                    leader = g is None or g.closed or g.full
                    if leader:
                        g = _Group(key, sig)
                        self._open[key] = g
                    g.members.append(member)
                    if len(g.members) >= self.max_batch:
                        g.full = True
                        self._cv.notify_all()
                if leader:
                    out = self._lead(g, cluster)
                else:
                    out = self._follow(g, member)
                if sp.recording:
                    sp.set(batch_id=g.batch_id,
                           batch_size=len(g.members),
                           shared_scan=member.shared_scan,
                           wait_seconds=round(
                               max(0.0, g.t_closed - member.t_enq), 6),
                           execute_seconds=round(g.execute_seconds, 6))
                if cluster is not None and active_tok is not None:
                    cluster._update_active(
                        active_tok, batch_id=g.batch_id,
                        batch_size=len(g.members),
                        shared_scan=member.shared_scan)
            return out
        finally:
            leaksan.close(lk)

    # -- staging identity ---------------------------------------------

    @staticmethod
    def _identity_vector(sig, db) -> tuple:
        """Per-site identity of the block this member would stage.

        Two members with equal vectors stage byte-identical inputs, so
        the batch stages once and dispatches once (run_shared). The
        pushdown program is part of the identity — pruning derives from
        it — alongside the shape-class capacity and the source's device
        cache key (per-shard visible portion ids: commits mint new keys,
        so identity never aliases across snapshots). Host ColumnSources
        have no content key; object identity stands in — members hold
        their db (hence source) refs for the batch's whole lifetime, so
        ids are stable and unique among live members, but such entries
        are marked unshareable across batches (ids recycle after GC).
        """
        vec = []
        for site in sig.sites:
            src = db.sources.get(site.table)
            key_of = getattr(src, "device_cache_key", None)
            if key_of is not None:
                vec.append(("dev", site.table, site.node.program,
                            site.read_cols, site.capacity,
                            key_of(site.read_cols, 1 << 22)))
            else:
                vec.append(("src", site.table, site.node.program,
                            site.read_cols, site.capacity, id(src)))
        return tuple(vec)

    # -- leader -------------------------------------------------------

    def _lead(self, g: _Group, cluster):
        window = self.window_ms / 1000.0
        dl = statement_deadline.current()
        if dl is not None:
            window = max(0.0, min(window, dl.remaining()))
        end = time.monotonic() + window
        with self._cv:
            while not g.full:
                rem = end - time.monotonic()
                if rem <= 0:
                    break
                self._cv.wait(rem)
            g.closed = True
            if self._open.get(g.key) is g:
                del self._open[g.key]
            self._batch_seq += 1
            g.batch_id = self._batch_seq
            g.t_closed = time.perf_counter()
            members = list(g.members)
            if len(members) == 1:
                self.solo += 1
            else:
                self.batches += 1
                self.batched_statements += len(members)
                self.max_batch_size = max(self.max_batch_size,
                                          len(members))
        if len(members) == 1:
            # not a batch — the caller runs the ordinary serial path
            # (same spans, walk fallbacks); the window wait is
            # the only cost, and it is attributed on the batch span
            return None
        try:
            # the leader executes on behalf of the whole group: its OWN
            # deadline must not cancel batchmates mid-dispatch, so it
            # runs with the deadline cleared and settles its budget
            # after distributing (below)
            with statement_deadline.activate(None), work_lock.shared():
                self._run_batch(g, members, cluster)
        except BaseException as e:
            for m in members:
                m.error = e
                m.event.set()
            raise
        leader = members[0]
        for m in members[1:]:
            m.event.set()
        statement_deadline.check_current("batched dispatch")
        return leader.result

    def _run_batch(self, g: _Group, members: list[_Member], cluster):
        from ydb_tpu_torch.plan.executor import _stage_fused_site
        from ydb_tpu_torch.ssa import plan_fuse

        db = members[0].db
        fused = db._compile_cache.get(g.key)
        fresh = fused is None
        with tracing.span("plan.fuse") as fsp:
            if fresh:
                try:
                    fused = plan_fuse.build(g.sig, db)
                except plan_fuse.Unfusible:
                    # fusibility was probed before enqueue; build-time
                    # rejection means an unfusible detail surfaced late.
                    # Serve each member by the serial executor instead.
                    self._run_unbatched(g, members)
                    return
                db._compile_cache[g.key] = fused
            ft0 = fused.first_trace_seconds or 0.0

            # stage each distinct scan identity ONCE; concurrent
            # batches/statements staging the same identity attach to the
            # in-flight staging through the ScanShare
            staged: dict[tuple, object] = {}
            attached0 = self.share.attached
            ident_users: dict[tuple, int] = {}
            for m in members:
                for ident in m.identity:
                    ident_users[ident] = ident_users.get(ident, 0) + 1
            for m in members:
                # sites whose staged block serves >1 member — the
                # stager counts too; sharing is symmetric
                m.shared_scan = sum(1 for ident in m.identity
                                    if ident_users[ident] > 1)
                for site, ident in zip(g.sig.sites, m.identity):
                    if ident in staged:
                        continue
                    share_key = ident if ident[0] == "dev" else None
                    mdb = m.db

                    def stage(site=site, mdb=mdb):
                        with tracing.span("scan") as sp:
                            # a fresh block per identity: never the
                            # plan's one static input (see module doc)
                            blk = _stage_fused_site(site, mdb)
                            if sp.recording:
                                sp.set(table=site.table,
                                       rows=int(blk.length))
                        return blk

                    staged[ident] = self.share.get_or_stage(share_key,
                                                            stage)

            # unique input vectors, in first-appearance order
            uniq: dict[tuple, int] = {}
            inputs_list: list[dict] = []
            for m in members:
                u = uniq.get(m.identity)
                if u is None:
                    u = len(inputs_list)
                    uniq[m.identity] = u
                    inputs_list.append(
                        {site.key: staged[ident]
                         for site, ident in zip(g.sig.sites, m.identity)})
                m.uindex = u

            t0 = time.perf_counter()
            def dispatch():
                while True:
                    # neither path writes the per-member staged blocks
                    # (both copy them into the graph's static inputs),
                    # so an expand-join overflow grows and re-dispatches
                    # over the SAME staged inputs
                    if len(inputs_list) == 1:
                        out, totals = fused.run_shared(inputs_list[0])
                    else:
                        out, totals = fused.run_stacked(inputs_list)
                    over = fused.overflowed(totals)
                    if not over:
                        return out
                    for j in over:
                        fused.grow(j, totals[j])

            cap0 = fused.captures
            out = plan_fuse.with_capture_retry(dispatch)
            g.execute_seconds = time.perf_counter() - t0
            with self._cv:
                captured = fused.captures - cap0
                if captured:
                    # first dispatch per batch size pays a capture: kept
                    # apart from warm latency
                    size = len(inputs_list)
                    self.graph_captures[size] = \
                        self.graph_captures.get(size, 0) + captured
                    self.capture_seconds += g.execute_seconds

            if len(inputs_list) == 1:
                for m in members:
                    m.result = out
            else:
                for m in members:
                    m.result = plan_fuse.slice_member(out, m.uindex)

            with self._cv:
                if len(inputs_list) == 1:
                    self.dedup_dispatches += 1
                else:
                    self.stacked_dispatches += 1

            if fsp.recording:
                fsp.set(fused_stages=fused.fused_stages,
                        fragments_elided=fused.fused_stages - 1,
                        compile_cache=("miss" if fresh else "hit"),
                        batch_size=len(members),
                        scan_attached=self.share.attached - attached0)
                ft = (fused.first_trace_seconds or 0.0) - ft0
                if ft:
                    fsp.set(first_trace_seconds=round(ft, 6))

    def _run_unbatched(self, g: _Group, members: list[_Member]) -> None:
        # late Unfusible: fall back to one serial execution per member
        # (each against its own snapshot db) so the group still answers
        from ydb_tpu_torch.plan.executor import execute_plan

        t0 = time.perf_counter()
        for m in members:
            m.result = execute_plan(g.sig.plan, m.db)
        g.execute_seconds = time.perf_counter() - t0

    # -- follower -----------------------------------------------------

    @staticmethod
    def _follow(g: _Group, member: _Member):
        while not member.event.wait(MEMBER_WAIT_TICK_SECONDS):
            # a deadline firing mid-batch cancels THIS waiter only; the
            # leader later completes the abandoned seat harmlessly
            statement_deadline.check_current("batched dispatch wait")
        if member.error is not None:
            raise member.error
        statement_deadline.check_current("batched dispatch")
        return member.result

    # -- telemetry ----------------------------------------------------

    def snapshot(self) -> dict:
        with self._cv:
            snap = {
                "batches": self.batches,
                "solo": self.solo,
                "batched_statements": self.batched_statements,
                "dedup_dispatches": self.dedup_dispatches,
                "stacked_dispatches": self.stacked_dispatches,
                "max_batch_size": self.max_batch_size,
                "open_groups": len(self._open),
                "graph_captures": sum(self.graph_captures.values()),
            }
        snap.update({f"scan_{k}": v for k, v in
                     self.share.snapshot().items()})
        return snap
