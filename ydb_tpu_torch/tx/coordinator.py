"""Deterministic distributed commit: the coordinator/mediator plane.

Reference (SURVEY.md §2.5, §3.2-commit): a Coordinator tablet assigns
monotonically increasing *plan steps* to proposed transactions, batches
them, and Mediators fan the planned tx ids to participant tablets, which
execute planned txs in step order; MVCC snapshots read at (step, tx) time.
Volatile txs skip the coordinator round for single-step commits.

Here transactions are host-side metadata operations (the device
never participates in commit). This module keeps the same contract in one
process — the coordinator is the single source of global time:

  * ``propose(participants)`` assigns the next plan step
  * every participant shard commits *at that step* (ColumnShard.commit
    with an explicit snapshot), all-or-nothing per the prepare checks
  * a read snapshot is just a plan step: readers at step S see exactly
    the transactions planned <= S on every shard — the same guarantee
    the reference's mediator time barrier provides

The multi-node version replaces direct calls with the runtime actor shim
(ydb_tpu_torch.runtime) carrying the same messages.

Durability: the reference coordinator persists planned steps before
handing them out (tx/coordinator/coordinator__plan_step.cpp); here a
``Coordinator(store)`` write-ahead-reserves step ranges in the blob store
(hi-lo allocation: one put per ``reserve`` steps, not per tx), so a
rebooted coordinator resumes strictly after every step it might ever have
assigned — shard snapshots stay monotonic across coordinator crashes.

The port's own copy of ``ydb_tpu/tx/coordinator.py`` (the same durable
plan-step blobs).
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class TxResult:
    txid: int
    step: int
    committed: bool
    error: str | None = None


class Coordinator:
    """Global plan-step clock + two-phase commit driver.

    Commits serialize on a commit lock (the reference coordinator also
    plans steps through one tablet), which keeps per-shard steps monotonic
    under concurrency. ``read_snapshot`` returns the last *fully
    committed* step — the mediator-time barrier: a step becomes readable
    only after every participant of every tx planned at or before it has
    committed, so readers never see a torn cross-shard transaction.
    """

    STEP_KEY = "coordinator/plan_step"

    def __init__(self, store=None, start_step: int = 0, reserve: int = 64):
        self._lock = threading.Lock()
        self._commit_lock = threading.Lock()
        self._store = store
        self._reserve = max(1, int(reserve))
        if store is not None and store.exists(self.STEP_KEY):
            start_step = max(start_step,
                             int(store.get(self.STEP_KEY).decode()))
        self._step = start_step
        self._completed = start_step
        # persisted ceiling: every handed-out step is <= _reserved before
        # it leaves plan(), so recovery never re-assigns a used step
        self._reserved = start_step
        self._next_txid = start_step + 1
        # mediator fan-out: callbacks invoked (outside locks) whenever
        # the completed-step barrier advances (tx/mediator.py)
        self._on_complete: list = []
        # volatile steps planned but not yet decided: the completed
        # barrier may never pass an undecided step, or a snapshot read
        # repeated after the late decision would change result
        # (non-monotonic reads)
        self._outstanding: set[int] = set()
        # high-water of steps whose effects are applied
        self._applied = start_step

    @property
    def last_step(self) -> int:
        return self._step

    def read_snapshot(self) -> int:
        """Last fully-committed plan step (mediator time barrier)."""
        with self._lock:
            return self._completed

    def _plan_locked(self, register: bool) -> tuple[int, int]:
        """Step allocation body (callers hold no lock). ``register``
        adds the step to the outstanding set: the completed barrier
        cannot pass it until ``_resolve`` — EVERY multi-effect commit
        path registers its step so no path's barrier advance can
        expose another path's mid-apply step (torn read)."""
        with self._lock:
            self._step += 1
            if self._store is not None and self._step > self._reserved:
                self._reserved = self._step + self._reserve - 1
                self._store.put(self.STEP_KEY,
                                str(self._reserved).encode())
            txid = self._next_txid
            self._next_txid += 1
            if register:
                self._outstanding.add(self._step)
            return txid, self._step

    def _resolve(self, step: int) -> None:
        with self._lock:
            self._outstanding.discard(step)

    def plan(self) -> tuple[int, int]:
        """Assign (txid, step) for a new transaction."""
        return self._plan_locked(register=False)

    def subscribe_completed(self, fn) -> None:
        """Register a mediator callback: fn(step) fires on every barrier
        advance (after the step is fully applied)."""
        self._on_complete.append(fn)

    def _mark_completed(self, step: int) -> None:
        with self._lock:
            self._applied = max(self._applied, step)
            bound = (min(self._outstanding) - 1 if self._outstanding
                     else self._applied)
            new = min(self._applied, bound)
            advanced = new > self._completed
            if advanced:
                self._completed = new
            completed = self._completed
        if advanced:
            for fn in self._on_complete:
                fn(completed)

    def background_plan(self) -> int:
        """Plan step for a single-shard background op (compaction/TTL).

        Marked completed immediately: shard-local metadata swaps cannot
        tear a cross-shard read, and background results should become
        visible without waiting for the next distributed commit. Takes the
        commit lock so it cannot interleave with an in-flight distributed
        commit and advance the barrier past its not-yet-applied step."""
        with self._commit_lock:
            _, step = self.plan()
            self._mark_completed(step)
            return step

    def commit(self, participants: list, prepare_args: list) -> TxResult:
        """Two-phase commit: prepare on every participant, then commit all
        at one plan step.

        Prepare failure aborts EVERY participant (prepared or not) and
        returns committed=False. Once all prepares succeed the decision is
        commit: commit_at is applied to every participant even if one
        errors (textbook 2PC — post-decision failures need repair/retry,
        not rollback), and any such error surfaces as RuntimeError after
        all attempts.

        Single-participant commits take the VOLATILE fast path
        (datashard volatile_tx.h analog): no cross-shard atomicity is at
        stake, so the decision collapses to one prepare+apply and the
        read barrier advances immediately — the common single-shard
        write skips the 2PC decision bookkeeping.
        """
        if len(participants) == 1:
            with self._commit_lock:
                txid, step = self._plan_locked(register=True)
                try:
                    p, args = participants[0], prepare_args[0]
                    try:
                        token = p.prepare(args)
                    except Exception as e:
                        try:
                            p.abort(args)
                        except Exception:
                            pass
                        return TxResult(txid, step, False,
                                        f"prepare: {e}")
                    p.commit_at(token, step)
                finally:
                    self._resolve(step)
                self._mark_completed(step)
                return TxResult(txid, step, True)
        with self._commit_lock:
            txid, step = self._plan_locked(register=True)
            try:
                tokens = []
                failed = None
                for p, args in zip(participants, prepare_args):
                    try:
                        tokens.append(p.prepare(args))
                    except Exception as e:
                        failed = e
                        break
                if failed is not None:
                    # abort cleanup, bounded by participant SHARDS
                    # ydb-lint: disable=H006
                    for p, args, i in zip(participants, prepare_args,
                                          range(len(participants))):
                        try:
                            p.abort(tokens[i] if i < len(tokens)
                                    else args)
                        except Exception:
                            pass
                    return TxResult(txid, step, False,
                                    f"prepare: {failed}")
                errors = []
                for p, t in zip(participants, tokens):
                    try:
                        p.commit_at(t, step)
                    except Exception as e:  # post-decision: keep going
                        errors.append((p, e))
            finally:
                self._resolve(step)
            self._mark_completed(step)
            if errors:
                raise RuntimeError(
                    f"commit decided at step {step} but participants "
                    f"failed to apply: {errors}; shard repair required"
                )
            return TxResult(txid, step, True)

    def commit_volatile(self, participants: list,
                        prepare_args: list) -> TxResult:
        """Volatile distributed commit (volatile_tx.h:91 +
        datashard_outreadset.h): NO prepare round-trip under the commit
        lock — the step is planned and registered outstanding, each
        participant validates + optimistically accepts independently,
        and outcomes propagate as readsets; every participant finalizes
        (or rolls back) on its own once its expected readsets arrive.
        The completed barrier cannot pass the step until the decision,
        so snapshot reads stay monotonic; concurrent classic commits at
        later steps proceed without waiting (no _commit_lock hold
        across the apply phase, which would serialize them).
        """
        if len(participants) == 1:
            return self.commit(participants, prepare_args)
        txid, step = self._plan_locked(register=True)
        ids = list(range(len(participants)))
        outcomes = []
        try:
            for p, args, pid in zip(participants, prepare_args, ids):
                peers = [q for q in ids if q != pid]
                outcomes.append(
                    p.apply_volatile(args, txid, step, peers))
            # readset exchange: every outcome reaches every peer;
            # participants decide locally (commit on all-ok, rollback
            # on the first negative readset)
            for qid, q in zip(ids, participants):
                for pid in ids:
                    if pid != qid:
                        q.deliver_readset(txid, pid, outcomes[pid])
        except Exception:
            # an escaped error (storage failure mid-exchange, ...)
            # must not leave accepted participants wedged undecided:
            # roll their volatile state back before surfacing
            for p in participants:
                try:
                    p.abort_volatile(txid)
                except Exception:
                    pass
            raise
        finally:
            self._resolve(step)
        if all(outcomes):
            self._mark_completed(step)
            return TxResult(txid, step, True)
        # unblock the barrier for later steps: the aborted step holds
        # no effects, so completing it is safe
        self._mark_completed(step)
        bad = [i for i, ok in zip(ids, outcomes) if not ok]
        return TxResult(txid, step, False,
                        f"volatile abort: participants {bad} rejected")
