"""The port's morsel-driven streaming pipeline (engine.stream_sched) on
the CPU: bit-identity against the serialized path for plain and
upsert-merge scans, blob faults healing without a consumer stall,
mid-scan deadline and abandoned-stream drain to zero, and consumer work
stealing when the dedicated stream pool is saturated — the cases of
``tests/test_stream_pipeline.py`` against ``ydb_tpu_torch``. The
reference injects its blob faults through its chaos subsystem (ROADMAP.md
queue A item 7); here a faulty blob store injects them, and the
scheduler's own flight ledger is read, and the leak sanitizer's
``stream.morsel`` handles must drain too."""

import threading
import time

import numpy as np
import pytest

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis import leaksan
from ydb_tpu_torch.chaos.deadline import Deadline, StatementCancelled, activate
from ydb_tpu_torch.engine import stream_sched
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.engine.reader import PortionStreamSource
from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
from ydb_tpu_torch.runtime.conveyor import shared_conveyor, stream_conveyor
from ydb_tpu_torch.ssa.ops import Agg
from ydb_tpu_torch.ssa.program import (AggSpec, GroupByStep, Program,
                                       SortStep)

SCHEMA = dtypes.schema(
    ("id", dtypes.INT64, False),
    ("v", dtypes.INT64),
)

@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The port's entry points default to CUDA; these tests ask for the
    CPU."""
    from ydb_tpu_torch import device

    monkeypatch.setattr(device, "DEFAULT_DEVICE", "cpu")


@pytest.fixture(autouse=True)
def _clean():
    """Every test leaves the pipeline gate on the environment."""
    yield
    stream_sched.PIPELINE_FORCE = None


def _shard(upsert=True):
    return ColumnShard(
        "s1", SCHEMA, MemBlobStore(), pk_column="id", upsert=upsert,
        config=ShardConfig(compact_portion_threshold=1_000_000),
    )


def _put(shard, ids, vals):
    wid = shard.write({"id": np.asarray(list(ids), dtype=np.int64),
                       "v": np.asarray(list(vals), dtype=np.int64)})
    return shard.commit([wid])


def _scan(shard, cap=64):
    """Full scan; returns (source, per-block (ids, vals) lists) so
    identity checks cover block boundaries, not just totals."""
    src = PortionStreamSource(shard, shard.visible_portions(None))
    blocks = []
    for blk in src.blocks(cap):
        data = blk.to_numpy()
        n = int(blk.length)
        blocks.append((data["id"][:n].tolist(), data["v"][:n].tolist()))
    return src, blocks


class FaultyStore(MemBlobStore):
    """Blob reads that fail (``io_error``), stall (``delay``) or come
    back cut in half (``torn``) while ``budget`` lasts."""

    def __init__(self, kind, budget=10 ** 9, latency=0.0, p=1.0, seed=0):
        super().__init__()
        self.kind, self.budget, self.latency = kind, budget, latency
        self.p, self.rng = p, np.random.default_rng(seed)
        self.armed = False
        self.fired = 0
        self._fl = threading.Lock()

    def get_range(self, blob_id, off, length):
        data = super().get_range(blob_id, off, length)
        with self._fl:
            fire = (self.armed and self.budget > 0
                    and self.rng.random() < self.p)
            if fire:
                self.budget -= 1
                self.fired += 1
        if not fire:
            return data
        if self.kind == "delay":
            time.sleep(self.latency)
            return data
        if self.kind == "io_error":
            raise OSError(f"injected blob.get_range failure on {blob_id}")
        return data[:len(data) // 2]


AGG = Program((GroupByStep(("g",), (AggSpec(Agg.SUM, "v", "sv"),
                                    AggSpec(Agg.COUNT_ALL, None, "n"))),
               SortStep(("g",), (False,))))


def _kv_shard(store, n=300):
    """Several portions of (k, v = 7k, g = k % 5)."""
    sch = dtypes.schema(("k", dtypes.INT64, False), ("v", dtypes.INT64),
                        ("g", dtypes.INT64))
    shard = ColumnShard("kv", sch, store, pk_column="k",
                        config=ShardConfig(portion_chunk_rows=32))
    for off in range(0, n, n // 3):
        ks = np.arange(off, min(n, off + n // 3), dtype=np.int64)
        shard.commit([shard.write({"k": ks, "v": ks * 7, "g": ks % 5})])
    return shard


def _flights_drained(src) -> bool:
    sched = src._finished_pipeline
    return sched is not None and sched._inflight_io == 0 \
        and sched._inflight_bytes == 0


def _same_result(a, b):
    assert a.schema.names == b.schema.names
    assert a.num_rows == b.num_rows
    for name in a.schema.names:
        av, aok = a.cols[name]
        bv, bok = b.cols[name]
        np.testing.assert_array_equal(np.asarray(av), np.asarray(bv),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(aok), np.asarray(bok),
                                      err_msg=f"{name} validity")


# ---------------- bit-identity: pipeline on == pipeline off ----------


def test_bit_identity_plain_scan():
    shard = _shard(upsert=False)
    for off in range(6):
        base = off * 100
        _put(shard, range(base, base + 100),
             (i * 3 for i in range(base, base + 100)))

    stream_sched.PIPELINE_FORCE = False
    _, serialized = _scan(shard)
    stream_sched.PIPELINE_FORCE = True
    src, pipelined = _scan(shard)

    assert pipelined == serialized  # same blocks, same order, same rows
    stats = src.last_pipeline
    assert stats is not None and stats["morsels_io"] > 0  # it DID fly


def test_bit_identity_upsert_merge():
    # overlapping PK ranges force merge clusters (inline K-way merge
    # morsels) interleaved with cold single-portion IO morsels
    shard = _shard(upsert=True)
    _put(shard, range(0, 200), (i * 2 for i in range(0, 200)))
    _put(shard, range(100, 300), (i * 5 for i in range(100, 300)))
    _put(shard, range(50, 150), (i * 9 for i in range(50, 150)))
    _put(shard, range(1000, 1200), (i for i in range(1000, 1200)))

    stream_sched.PIPELINE_FORCE = False
    _, serialized = _scan(shard)
    stream_sched.PIPELINE_FORCE = True
    src, pipelined = _scan(shard)

    assert pipelined == serialized
    stats = src.last_pipeline
    assert stats is not None
    assert stats["morsels_merge"] > 0 and stats["morsels_io"] > 0


# ---------------- chaos: blob faults heal, consumer never stalls -----


def test_chaos_blob_io_error_heals_under_pipeline():
    stream_sched.PIPELINE_FORCE = True
    store = FaultyStore("io_error", budget=6, p=0.6, seed=33)
    shard = _kv_shard(store)
    want = shard.scan(AGG)
    store.armed = True
    t0 = time.monotonic()
    got = shard.scan(AGG)
    assert time.monotonic() - t0 < 30.0  # healed, not stalled
    assert store.fired > 0
    _same_result(got, want)


def test_chaos_blob_latency_does_not_stall_consumer():
    # pure-delay faults on every blob read: flights just take longer,
    # the consumer keeps draining in order and the result is identical
    stream_sched.PIPELINE_FORCE = True
    store = FaultyStore("delay", latency=0.005)
    shard = _kv_shard(store)
    want = shard.scan(AGG)
    store.armed = True
    t0 = time.monotonic()
    got = shard.scan(AGG)
    assert time.monotonic() - t0 < 30.0
    assert store.fired > 0
    _same_result(got, want)


def test_chaos_torn_read_heals_under_pipeline():
    # a torn read truncates the payload mid-chunk: the zero-copy
    # decode raises a transient kind and the flight re-fetches
    stream_sched.PIPELINE_FORCE = True
    store = FaultyStore("torn", budget=2)
    shard = _kv_shard(store)
    want = shard.scan(AGG)
    store.armed = True
    got = shard.scan(AGG)
    assert store.fired == 2
    _same_result(got, want)


# ---------------- cancellation / abandonment: drain to zero ----------


def test_mid_scan_deadline_drains_morsel_flights():
    stream_sched.PIPELINE_FORCE = True
    shard = _shard(upsert=False)
    for off in range(8):
        base = off * 200
        _put(shard, range(base, base + 200),
             (i * 3 for i in range(base, base + 200)))

    src = PortionStreamSource(shard, shard.visible_portions(None))
    with activate(Deadline(seconds=0.0)):
        with pytest.raises(StatementCancelled):
            for _ in src.blocks(64):
                pass
    stream_conveyor().wait_idle(timeout=10.0)
    shared_conveyor().wait_idle(timeout=10.0)
    assert _flights_drained(src)
    # flights WERE admitted before the cancellation landed
    stats = src.last_pipeline
    assert stats is not None and stats["morsels_io"] > 0


def test_abandoned_stream_drains_morsel_flights():
    stream_sched.PIPELINE_FORCE = True
    shard = _shard(upsert=False)
    for off in range(8):
        base = off * 200
        _put(shard, range(base, base + 200),
             (i * 3 for i in range(base, base + 200)))

    src = PortionStreamSource(shard, shard.visible_portions(None))
    it = src.blocks(64)
    next(it)
    it.close()  # consumer walks away mid-stream
    stream_conveyor().wait_idle(timeout=10.0)
    shared_conveyor().wait_idle(timeout=10.0)
    assert _flights_drained(src)
    assert src.last_pipeline is not None


# ---------------- work stealing: saturated pool never blocks ---------


def test_consumer_steals_when_stream_pool_saturated():
    stream_sched.PIPELINE_FORCE = True
    shard = _shard(upsert=False)
    for off in range(6):
        base = off * 100
        _put(shard, range(base, base + 100),
             (i * 3 for i in range(base, base + 100)))
    stream_sched.PIPELINE_FORCE = False
    _, serialized = _scan(shard)
    stream_sched.PIPELINE_FORCE = True

    gate = threading.Event()
    cv = stream_conveyor()
    try:
        for _ in range(16):  # park every stream worker behind the gate
            cv.submit("test_gate", gate.wait)
        src, pipelined = _scan(shard)
    finally:
        gate.set()
    cv.wait_idle(timeout=10.0)

    assert pipelined == serialized  # stolen flights, identical stream
    stats = src.last_pipeline
    assert stats is not None and stats["stolen"] > 0


def test_abandoned_stream_drains_under_leaksan():
    """Every morsel flight's leak handle closes when the consumer walks
    away mid-stream (the reference's ``tests/test_stream_pipeline.py:
    226-236``)."""
    stream_sched.PIPELINE_FORCE = True
    shard = _shard(upsert=False)
    for off in range(8):
        base = off * 200
        _put(shard, range(base, base + 200),
             (i * 3 for i in range(base, base + 200)))
    with leaksan.activate():
        src = PortionStreamSource(shard, shard.visible_portions(None))
        it = src.blocks(64)
        next(it)
        it.close()
        deadline = time.monotonic() + 10.0
        while leaksan.live("stream.morsel") and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert leaksan.live("stream.morsel") == []
        stream_conveyor().wait_idle(timeout=10.0)
        shared_conveyor().wait_idle(timeout=10.0)
        while leaksan.counts() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert leaksan.counts() == {}
