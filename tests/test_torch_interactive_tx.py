"""Interactive transactions through the port's SQL sessions (BEGIN /
COMMIT / ROLLBACK with buffered row-table writes) against the
reference's: the 9 cases of ``tests/test_interactive_tx.py``.

Each case runs through a reference ``Cluster()`` and a port
``Cluster(device="cpu")`` and makes the reference test's assertions on
each; every statement's outcome (``TxResult`` committed / step / error
class, the rows read, the error text) must be equal between the two.
The port side runs with its thread sanitizer armed (``YDB_TPU_TORCH_TSAN``
through ``sanitizer.activate``, before the Cluster is built) and must
leave no report. Tolerance: none.

Besides: four sessions on threads run interleaved transfers between
row-table accounts under the port's sanitizer; the sum of balances never
changes, and the final balances equal a serial replay of the committed
transfers."""

import random
import sys
import threading
import types

import pytest

import ydb_tpu.ssa
from ydb_tpu.kqp.session import Cluster as RCluster
from ydb_tpu.sql.planner import PlanError as RPlanError
from ydb_tpu.tx.coordinator import TxResult as RTxResult

from ydb_tpu_torch.analysis import sanitizer
from ydb_tpu_torch.kqp.session import Cluster as TCluster
from ydb_tpu_torch.sql.planner import PlanError as TPlanError
from ydb_tpu_torch.tx.coordinator import TxResult as TTxResult

PORT = types.SimpleNamespace(Cluster=lambda: TCluster(device="cpu"),
                             PlanError=TPlanError, TxResult=TTxResult,
                             port=True)
REF = types.SimpleNamespace(Cluster=RCluster, PlanError=RPlanError,
                            TxResult=RTxResult, port=False)


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C): its GROUP BYs take the scatter tier."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def both(case):
    with sanitizer.activate():
        got = case(PORT)
        assert sanitizer.reports() == []
    assert got == case(REF)


def tx(res):
    return None if res is None else (bool(res.committed), res.step,
                                     (res.error or "")[:7])


def make(P):
    c = P.Cluster()
    s = c.session()
    s.execute("CREATE TABLE acct (id int64, bal int64, "
              "PRIMARY KEY (id)) WITH (store = row, shards = 2)")
    s.execute("CREATE TABLE log (seq int64, note int64, "
              "PRIMARY KEY (seq)) WITH (store = row)")
    s.execute("INSERT INTO acct VALUES (1, 100), (2, 50)")
    return c


def val(s, sql, col):
    return [int(x) for x in s.execute(sql).column(col)]


def test_commit_applies_atomically_across_tables():
    def case(P):
        c = make(P)
        s = c.session()
        assert s.execute("BEGIN") is None
        obs = [tx(s.execute("UPDATE acct SET bal = bal - 30 WHERE id = 1")),
               tx(s.execute("UPDATE acct SET bal = bal + 30 WHERE id = 2")),
               tx(s.execute("INSERT INTO log VALUES (1, 30)"))]
        other = c.session()
        assert val(other, "SELECT bal FROM acct ORDER BY id", "bal") == \
            [100, 50]
        assert val(other, "SELECT seq FROM log", "seq") == []
        res = s.execute("COMMIT")
        assert isinstance(res, P.TxResult) and res.committed
        assert val(other, "SELECT bal FROM acct ORDER BY id", "bal") == \
            [70, 80]
        assert val(other, "SELECT note FROM log", "note") == [30]
        # all three effects land at ONE step
        steps = {sh.last_step for t in ("acct", "log")
                 for sh in c.tables[t].shards}
        return obs + [tx(res), sorted(steps)]
    both(case)


def test_rollback_discards_and_releases():
    def case(P):
        c = make(P)
        s = c.session()
        s.execute("BEGIN")
        s.execute("UPDATE acct SET bal = 0 WHERE id = 1")
        assert s.execute("ROLLBACK") is None
        assert val(s, "SELECT bal FROM acct WHERE id = 1", "bal") == [100]
        other = c.session()
        res = other.execute("UPDATE acct SET bal = 7 WHERE id = 2")
        assert val(s, "SELECT bal FROM acct WHERE id = 2", "bal") == [7]
        return [tx(res), [sh._locks for sh in c.tables["acct"].shards]]
    both(case)


def test_conflicting_commit_aborts_transaction():
    def case(P):
        c = make(P)
        a = c.session()
        a.execute("BEGIN")
        a.execute("UPDATE acct SET bal = bal - 10 WHERE id = 1")
        b = c.session()
        rb = b.execute("UPDATE acct SET bal = 999 WHERE id = 1")
        res = a.execute("COMMIT")
        assert isinstance(res, P.TxResult) and not res.committed
        assert val(b, "SELECT bal FROM acct WHERE id = 1", "bal") == [999]
        return [tx(rb), tx(res), res.error]
    both(case)


def test_repeatable_reads_at_begin_snapshot():
    def case(P):
        c = make(P)
        a = c.session()
        a.execute("BEGIN")
        assert val(a, "SELECT bal FROM acct WHERE id = 1", "bal") == [100]
        b = c.session()
        b.execute("UPDATE acct SET bal = 5 WHERE id = 1")
        assert val(a, "SELECT bal FROM acct WHERE id = 1", "bal") == [100]
        a.execute("ROLLBACK")
        assert val(a, "SELECT bal FROM acct WHERE id = 1", "bal") == [5]
        return [c.coordinator.read_snapshot()]
    both(case)


def test_insert_then_read_own_write_not_visible_until_commit():
    """Deferred-effect model: the transaction does NOT see its own
    buffered writes (documented semantics)."""
    def case(P):
        c = make(P)
        s = c.session()
        s.execute("BEGIN")
        s.execute("INSERT INTO log VALUES (9, 1)")
        assert val(s, "SELECT seq FROM log", "seq") == []
        res = s.execute("COMMIT")
        assert val(s, "SELECT seq FROM log", "seq") == [9]
        return [tx(res)]
    both(case)


def test_tx_statement_errors():
    def case(P):
        s = make(P).session()
        errs = []
        with pytest.raises(P.PlanError) as e:
            s.execute("COMMIT")  # no open tx
        errs.append(str(e.value))
        s.execute("BEGIN")
        with pytest.raises(P.PlanError) as e:
            s.execute("BEGIN")  # nested
        errs.append(str(e.value))
        s.execute("ROLLBACK")
        s.execute("BEGIN")
        with pytest.raises(P.PlanError, match="DDL") as e:
            s.execute("CREATE TABLE t2 (id int64, PRIMARY KEY (id))")
        errs.append(str(e.value))
        s.execute("BEGIN")
        s.execute("ROLLBACK")
        return errs
    both(case)


def test_no_lost_update_between_begin_and_first_touch():
    """A commit landing between BEGIN and the tx's first touch of a table
    must abort the tx, not be clobbered by stale full-row writes."""
    def case(P):
        c = make(P)
        s = c.session()
        s.execute("ALTER TABLE acct ADD COLUMN x int64")
        s.execute("UPDATE acct SET x = 0 WHERE id = 1")
        a = c.session()
        a.execute("BEGIN")
        b = c.session()
        b.execute("UPDATE acct SET x = 777 WHERE id = 1")  # after BEGIN
        with pytest.raises(P.PlanError, match="changed after BEGIN") as e:
            a.execute("UPDATE acct SET bal = bal - 10 WHERE id = 1")
        out = b.execute("SELECT x, bal FROM acct WHERE id = 1")
        assert int(out.column("x")[0]) == 777
        assert int(out.column("bal")[0]) == 100
        assert a._tx is None
        return [str(e.value), [sh._locks for sh in c.tables["acct"].shards]]
    both(case)


def test_scalar_subquery_reads_tx_snapshot():
    """Subqueries inside a tx see the BEGIN snapshot, matching the outer
    statement."""
    def case(P):
        c = make(P)
        a = c.session()
        a.execute("BEGIN")
        b = c.session()
        b.execute("UPDATE acct SET bal = 999 WHERE id = 2")
        out = a.execute(
            "SELECT id FROM acct WHERE bal = (SELECT max(bal) FROM acct)")
        got = [int(x) for x in out.column("id")]
        assert got == [1]
        a.execute("ROLLBACK")
        return got
    both(case)


def test_empty_commit_is_trivially_true():
    def case(P):
        s = make(P).session()
        s.execute("BEGIN")
        res = s.execute("COMMIT")
        assert res.committed
        return [tx(res)]
    both(case)


# ---------------- threads under the sanitizer ----------------

def transfers(c, n_sessions, per_session, n_accounts, seed):
    """``n_sessions`` threads each commit ``per_session`` transfers
    (BEGIN; two UPDATEs; COMMIT), retrying on abort. Returns the log of
    committed (step, a, b, x) and the abort count."""
    committed, aborts = [], [0]
    lock = threading.Lock()
    errors = []

    def worker(wid):
        rng = random.Random(seed + wid)
        s = c.session()
        done = 0
        try:
            while done < per_session:
                a, b = rng.sample(range(n_accounts), 2)
                x = rng.randrange(1, 20)
                try:
                    s.execute("BEGIN")
                    s.execute(f"UPDATE acct SET bal = bal - {x} "
                              f"WHERE id = {a}")
                    s.execute(f"UPDATE acct SET bal = bal + {x} "
                              f"WHERE id = {b}")
                    res = s.execute("COMMIT")
                except TPlanError:  # changed after BEGIN: tx already gone
                    res = None
                with lock:
                    if res is not None and res.committed:
                        committed.append((res.step, a, b, x))
                        done += 1
                    else:
                        aborts[0] += 1
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return committed, aborts[0]


def test_threaded_transfers_conserve_and_replay_serially():
    n_accounts, start = 12, 100
    with sanitizer.activate():
        c = TCluster(device="cpu")
        s = c.session()
        s.execute("CREATE TABLE acct (id int64, bal int64, "
                  "PRIMARY KEY (id)) WITH (store = row, shards = 4)")
        s.execute("INSERT INTO acct VALUES " + ", ".join(
            f"({i}, {start})" for i in range(n_accounts)))
        committed, aborts = transfers(c, 4, 5, n_accounts, seed=3)
        assert sanitizer.reports() == []
    assert len(committed) == 20
    out = s.execute("SELECT id, bal FROM acct ORDER BY id")
    got = [int(x) for x in out.column("bal")]
    assert sum(got) == n_accounts * start
    want = [start] * n_accounts
    for _step, a, b, x in sorted(committed):
        want[a] -= x
        want[b] += x
    assert got == want
    assert len({st for st, *_ in committed}) == len(committed)
