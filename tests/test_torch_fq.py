"""The port's streaming query service (``ydb_tpu_torch/fq/service.py``)
against the reference's.

Each of the 9 cases of ``tests/test_fq.py`` runs through both packages
(the port's ``StreamingQuery`` on ``device="cpu"``): the same counts,
``results()``, ``watermark_info()`` and sink records. Added: the same
ClickBench-shaped events (numpy seed) through both packages' plain and
windowed queries, with ``results()``, ``watermark_info()`` and the sink
records equal and the totals equal to a numpy group-by; and micro-batches
of more than 512 groups, so that the port's plain versions of both CUDA
kernels run (the fused lowering and the per-aggregate one), judged
against numpy. Tolerance: integers and strings exact."""

import json
import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdtypes
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.fq import FederatedQueryService as RFQS
from ydb_tpu.fq import StreamingQuery as RSQ
from ydb_tpu.topic.topic import Topic as RTopic

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.fq import FederatedQueryService, StreamingQuery
from ydb_tpu_torch.ssa import cuda_kernels, kernels, plan_fuse
from ydb_tpu_torch.topic.topic import Topic


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C); the stand-in keeps its GROUP BYs over more
    than 512 groups on the scatter tier, as the other port tests do."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


class Kit:
    """One package's streaming pieces."""

    def __init__(self, dt, mem, fqs, sq, topic, **qkw):
        self.dtypes, self.mem, self.topic = dt, mem, topic
        self._fqs, self._sq, self.qkw = fqs, sq, qkw

    def service(self, store):
        return self._fqs(store, **self.qkw)

    def query(self, *args, **kw):
        return self._sq(*args, **kw, **self.qkw)

    def env(self):
        store = self.mem()
        return (store, self.topic("events", store, n_partitions=2),
                self.topic("results", store, n_partitions=1),
                self.service(store))


KITS = (Kit(rdtypes, RMemBlobStore, RFQS, RSQ, RTopic),
        Kit(dtypes, MemBlobStore, FederatedQueryService, StreamingQuery,
            Topic, device="cpu"))

SQL = ("select region, count(*) as n, sum(amount) as total "
       "from stream group by region")


def events(k):
    return k.dtypes.schema(("region", k.dtypes.STRING, False),
                           ("amount", k.dtypes.INT64, False))


def wevents(k):
    return k.dtypes.schema(("region", k.dtypes.STRING, False),
                           ("amount", k.dtypes.INT64, False),
                           ("ts", k.dtypes.INT64, False))


def send(topic, **row):
    topic.write(json.dumps(row))


def sink_records(sink):
    return [json.loads(m["data"]) for m in sink.partitions[0].read(0, 1000)]


def _both(case):
    out = [case(k) for k in KITS]
    assert out[0] == out[1]
    return out[1]


def test_incremental_group_aggregation():
    def case(k):
        _store, source, sink, svc = k.env()
        q = svc.create_query("agg", SQL, events(k), source, sink)
        send(source, region="eu", amount=10)
        send(source, region="us", amount=5)
        got = [q.poll(), q.results()]
        send(source, region="eu", amount=7)
        got += [q.poll(), q.results(), sink_records(sink), q.poll()]
        return got

    n1, r1, n2, r2, recs, n3 = _both(case)
    assert n1 == 2 and r1 == [{"region": "eu", "n": 1, "total": 10},
                              {"region": "us", "n": 1, "total": 5}]
    assert n2 == 1 and r2[0] == {"region": "eu", "n": 2, "total": 17}
    assert recs[-1] == {"region": "eu", "n": 2, "total": 17} and n3 == 0


def test_filter_and_min_max():
    def case(k):
        _store, source, _sink, svc = k.env()
        q = svc.create_query(
            "mm", "select region, min(amount) as lo, max(amount) as hi "
            "from stream where amount > 0 group by region", events(k),
            source)
        for a in (3, -99, 8):
            send(source, region="eu", amount=a)
        q.poll()
        send(source, region="eu", amount=1)
        q.poll()
        return q.results()

    assert _both(case) == [{"region": "eu", "lo": 1, "hi": 8}]


def test_crash_replay_is_exactly_once():
    def case(k):
        store, source, sink, svc = k.env()
        q = svc.create_query("eo", SQL, events(k), source, sink)
        send(source, region="eu", amount=10)
        first = [q.poll(), len(sink_records(sink))]
        send(source, region="eu", amount=5)
        _offsets, state, seq, _meta = q._state()
        changed = q._fold(state, q._run_batch([{"region": "eu",
                                                "amount": 5}]))
        q.sink.partitions[0].write(
            [{"data": json.dumps(dict(zip(("region",), json.loads(c)))
                                 | state[c])} for c in changed],
            producer="fq/eo", first_seqno=seq + 1)
        q2 = k.query("eo", SQL, events(k), source, sink, store)
        return first, q2.poll(), sink_records(sink), q2.results()

    first, n, recs, res = _both(case)
    assert first == [1, 1] and n == 1 and len(recs) == 2
    assert recs[-1] == {"region": "eu", "n": 2, "total": 15}
    assert res == [{"region": "eu", "n": 2, "total": 15}]


def test_state_survives_reboot():
    def case(k):
        store, source, sink, svc = k.env()
        q = svc.create_query("rb", SQL, events(k), source, sink)
        send(source, region="eu", amount=4)
        q.poll()
        q2 = k.query("rb", SQL, events(k), source, sink, store)
        got = [q2.results()]
        send(source, region="eu", amount=6)
        return got + [q2.poll(), q2.results()]

    r1, n, r2 = _both(case)
    assert r1 == [{"region": "eu", "n": 1, "total": 4}] and n == 1
    assert r2 == [{"region": "eu", "n": 2, "total": 10}]


def test_poison_messages_skipped():
    def case(k):
        _store, source, _sink, svc = k.env()
        q = svc.create_query("ps", SQL, events(k), source, sink=None)
        source.write("not json at all")
        send(source, region="eu", amount=2)
        return q.poll(), q.results()

    assert _both(case) == (1, [{"region": "eu", "n": 1, "total": 2}])


def test_tumbling_windows_with_watermark():
    def case(k):
        _store, source, sink, svc = k.env()
        q = svc.create_query("win", SQL, wevents(k), source, sink,
                             window=("ts", 100, 20))
        for region, amount, ts in (("eu", 1, 10), ("eu", 2, 50),
                                   ("us", 5, 110)):
            send(source, region=region, amount=amount, ts=ts)
        q.poll()
        got = [sink_records(sink), q.results()]
        send(source, region="eu", amount=4, ts=95)
        send(source, region="eu", amount=9, ts=230)
        q.poll()
        got.append(sink_records(sink))
        send(source, region="eu", amount=100, ts=5)
        send(source, region="us", amount=1, ts=320)
        q.poll()
        return got + [q.watermark_info(), sink_records(sink), q.results()]

    recs0, open0, recs1, wm, recs2, open2 = _both(case)
    assert recs0 == [] and {w["window_start"] for w in open0} == {0, 100}
    assert recs1 == [{"window_start": 0, "window_end": 100, "region": "eu",
                      "n": 3, "total": 7},
                     {"window_start": 100, "window_end": 200,
                      "region": "us", "n": 1, "total": 5}]
    assert wm["late_dropped"] == 1
    assert recs2[-1] == {"window_start": 200, "window_end": 300,
                         "region": "eu", "n": 1, "total": 9}
    assert all(w["window_start"] >= 300 for w in open2)


def test_below_watermark_rows_fold_into_open_windows():
    def case(k):
        _store, source, sink, svc = k.env()
        q = svc.create_query("open", SQL, wevents(k), source, sink,
                             window=("ts", 100, 20))
        send(source, region="eu", amount=1, ts=150)
        q.poll()
        send(source, region="eu", amount=2, ts=120)
        q.poll()
        late = q.watermark_info()["late_dropped"]
        send(source, region="eu", amount=0, ts=500)
        q.poll()
        return late, sink_records(sink)[0]

    assert _both(case) == (0, {"window_start": 100, "window_end": 200,
                               "region": "eu", "n": 2, "total": 3})


def test_windowed_state_survives_reboot():
    def case(k):
        store, source, sink, svc = k.env()
        q = svc.create_query("winrb", SQL, wevents(k), source, sink,
                             window=("ts", 100, 0))
        send(source, region="eu", amount=3, ts=10)
        q.poll()
        q2 = k.query("winrb", SQL, wevents(k), source, sink, store,
                     window=("ts", 100, 0))
        send(source, region="eu", amount=4, ts=60)
        send(source, region="eu", amount=1, ts=150)
        q2.poll()
        return sink_records(sink)[-1]

    assert _both(case) == {"window_start": 0, "window_end": 100,
                           "region": "eu", "n": 2, "total": 7}


def test_rejects_non_foldable_aggregates():
    for k in KITS:
        store, source, _sink, _svc = k.env()
        with pytest.raises(ValueError, match="fold-combinable"):
            k.query("bad", "select region, avg(amount) as a from stream "
                    "group by region", events(k), source, None, store)


# ---------------- the same events through both packages ----------------

def _click_events(n, n_urls, seed, skewed=True):
    """ClickBench-shaped events in event-time order: a URL pool (zipf,
    or uniform), ResolutionWidth, EventTime (one day of microseconds a
    window)."""
    rng = np.random.default_rng(seed)
    url = (np.minimum(rng.zipf(1.5, n) - 1, n_urls - 1) if skewed
           else rng.integers(0, n_urls, n))
    width = rng.choice([1024, 1280, 1366, 1440, 1920], n)
    t = np.sort(rng.integers(0, 5 * 86_400, n)) * 1_000_000
    return [{"URL": f"http://h{u % 7}/p/{u}", "ResolutionWidth": int(w),
             "EventTime": int(x)} for u, w, x in zip(url, width, t)]


CSQL = ("select URL, count(*) as n, sum(ResolutionWidth) as s "
        "from stream group by URL")


def click_schema(k):
    return k.dtypes.schema(("URL", k.dtypes.STRING, False),
                           ("ResolutionWidth", k.dtypes.INT32, False),
                           ("EventTime", k.dtypes.TIMESTAMP, False))


def _write_round_robin(topic, evs, batch=100):
    """Event i to partition i % n, in batches with producer seqnos."""
    n = len(topic.partitions)
    for p in range(n):
        mine = evs[p::n]
        for lo in range(0, len(mine), batch):
            topic.partitions[p].write(
                [{"data": json.dumps(e)} for e in mine[lo:lo + batch]],
                producer=f"gen/{p}", first_seqno=lo + 1)


def _numpy_groups(evs, key=lambda e: e["URL"]):
    out: dict = {}
    for e in evs:
        n, s = out.get(key(e), (0, 0))
        out[key(e)] = (n + 1, s + e["ResolutionWidth"])
    return out


def test_clickbench_stream_same_in_both_packages():
    evs = _click_events(3_000, 200, seed=5)
    late = [dict(evs[10], EventTime=7), dict(evs[11], EventTime=9)]
    day = 86_400_000_000

    def case(k):
        store = k.mem()
        src = k.topic("clicks", store, n_partitions=4)
        sink = k.topic("out", store, n_partitions=1)
        wsink = k.topic("wout", store, n_partitions=1)
        _write_round_robin(src, evs)
        src.partitions[0].write([{"data": json.dumps(e)} for e in late])
        svc = k.service(store)
        q = svc.create_query("plain", CSQL, click_schema(k), src, sink,
                             batch_limit=256)
        w = svc.create_query("win", CSQL, click_schema(k), src, wsink,
                             batch_limit=256,
                             window=("EventTime", day, day // 24))
        polls = [(q.poll(), w.poll()) for _ in range(5)]
        return (polls, q.results(), sink_records(sink), w.results(),
                w.watermark_info(), sink_records(wsink))

    polls, res, recs, wres, wm, wrecs = _both(case)
    assert sum(p for p, _ in polls) == len(evs) + 2 and polls[-1] == (0, 0)
    want = _numpy_groups(evs + late)
    assert {r["URL"]: (r["n"], r["s"]) for r in res} == want
    last = {}
    for r in recs:  # the sink's last emission of a group is its total
        last[r["URL"]] = (r["n"], r["s"])
    assert last == want
    assert wm["late_dropped"] == 2
    windows = [(r["window_start"], r["URL"], r["n"], r["s"])
               for r in wrecs + wres]
    assert len(windows) == len({w[:2] for w in windows})  # each once
    want_w = _numpy_groups(evs, key=lambda e: (
        e["EventTime"] // day * day, e["URL"]))
    assert {(a, b): (c, d) for a, b, c, d in windows} == want_w
    assert all(r["window_end"] <= wm["finalized_before"] for r in wrecs)


@pytest.mark.parametrize("lowering", ["fused", "peragg"])
def test_batches_over_512_groups_run_the_plain_kernels(monkeypatch,
                                                       lowering):
    """Every micro-batch groups more than ``ONEHOT_GROUP_LIMIT`` URLs:
    the fused lowering calls ``cuda_kernels.grouped_sum_multi`` and the
    per-aggregate one (fusion off) ``cuda_kernels.grouped_sum``, on CPU
    tensors their plain versions; the totals equal numpy."""
    calls = {"grouped_sum": 0, "grouped_sum_multi": 0}
    for name in calls:
        real = getattr(cuda_kernels, name)

        def spy(values, gid, num_groups, _real=real, _name=name):
            assert values.device.type == "cpu"
            calls[_name] += 1
            return _real(values, gid, num_groups)
        monkeypatch.setattr(cuda_kernels, name, spy)
    if lowering == "peragg":
        monkeypatch.setattr(kernels, "FUSED_FORCE", False)
        monkeypatch.setattr(plan_fuse, "FUSE_FORCE", False)
    evs = _click_events(8_000, 1_500, seed=9, skewed=False)
    store = MemBlobStore()
    src = Topic("clicks", store, n_partitions=2)
    _write_round_robin(src, evs, batch=500)
    q = StreamingQuery("big", CSQL, click_schema(KITS[1]), src, None, store,
                       batch_limit=2_000, device="cpu")
    groups = []
    real_run = q._run_batch

    def run(rows):
        out = real_run(rows)
        groups.append(len(out))
        return out
    q._run_batch = run
    while q.poll():
        pass
    assert len(groups) == 2 and min(groups) > kernels.ONEHOT_GROUP_LIMIT
    want = "grouped_sum_multi" if lowering == "fused" else "grouped_sum"
    assert calls[want] > 0, calls
    assert {r["URL"]: (r["n"], r["s"]) for r in q.results()} == \
        _numpy_groups(evs)
    assert q.stats["polls"] == q.stats["batches"] == 2
    assert q.stats["rows"] == len(evs)
