"""The port's background-task plane on the CPU: conveyor workers +
resource-broker quotas + the stall/step test seam; compaction runs off
the commit path while scans proceed (reference tx/conveyor/service.h:73,
resource_broker.h, ICSController hooks/abstract.h:49) — the cases of
``tests/test_conveyor.py`` against ``ydb_tpu_torch``, with shards
compacted through the conveyor directly (the reference's
``ShardedTable`` comes with the session plane)."""

import threading
import time

import numpy as np
import pytest

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.runtime.conveyor import (
    Conveyor,
    ConveyorController,
    ResourceBroker,
)
from ydb_tpu_torch.ssa.ops import Agg
from ydb_tpu_torch.ssa.program import AggSpec, GroupByStep, Program

@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The port's entry points default to CUDA; these tests ask for the
    CPU."""
    from ydb_tpu_torch import device

    monkeypatch.setattr(device, "DEFAULT_DEVICE", "cpu")


SCHEMA = dtypes.schema(("id", dtypes.INT64, False), ("v", dtypes.INT64))
COUNT = Program((GroupByStep(keys=(), aggs=(
    AggSpec(Agg.COUNT_ALL, None, "n"),
    AggSpec(Agg.SUM, "v", "s"),
)),))


def test_broker_quota_limits_concurrency():
    broker = ResourceBroker(quotas={"compaction": 2})
    conv = Conveyor(workers=4, broker=broker)
    peak = [0]
    cur = [0]
    lock = threading.Lock()

    def job():
        with lock:
            cur[0] += 1
            peak[0] = max(peak[0], cur[0])
        time.sleep(0.05)
        with lock:
            cur[0] -= 1

    hs = [conv.submit("compaction", job) for _ in range(6)]
    for h in hs:
        h.wait(10)
    conv.shutdown()
    assert peak[0] <= 2


def test_stall_step_resume():
    ctl = ConveyorController()
    conv = Conveyor(workers=2, controller=ctl)
    ctl.stall()
    ran = []
    hs = [conv.submit("q", ran.append, i) for i in range(3)]
    time.sleep(0.1)
    assert ran == []  # stalled: nothing executes
    ctl.step(1)
    # either queued task may take the single step token
    deadline = time.time() + 10
    while not ran and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    assert len(ran) == 1  # exactly one stepped through
    ctl.resume()
    for h in hs:
        h.wait(10)
    assert sorted(ran) == [0, 1, 2]
    conv.shutdown()


def test_task_error_surfaces_via_handle():
    conv = Conveyor(workers=1)

    def boom():
        raise RuntimeError("background failure")

    h = conv.submit("q", boom)
    with pytest.raises(RuntimeError, match="background failure"):
        h.wait(10)
    conv.shutdown()


def test_scans_proceed_while_compaction_stalled():
    """The ICSController-style contract: with background compaction
    STALLED on the conveyor, foreground scans and inserts keep working;
    after resume the compaction applies without changing results."""
    from ydb_tpu_torch.blocks.dictionary import DictionarySet
    from ydb_tpu_torch.engine.reader import MultiShardStreamSource
    from ydb_tpu_torch.engine.scan import ScanExecutor
    from ydb_tpu_torch.engine.oracle import OracleTable
    from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig

    dicts = DictionarySet()
    shards = [ColumnShard(f"t/{i}", SCHEMA, MemBlobStore(),
                          pk_column="id", upsert=True, dicts=dicts,
                          config=ShardConfig(compact_portion_threshold=4))
              for i in range(2)]

    class T:
        def insert(self, cols):
            for i, sh in enumerate(shards):
                m = cols["id"] % 2 == i
                sh.commit([sh.write({k: v[m] for k, v in cols.items()})])

        def scan(self, prog):
            src = MultiShardStreamSource(shards, SCHEMA, dicts)
            ex = ScanExecutor(prog, src, 1 << 10)
            return OracleTable.from_block(ex.run_stream(
                src.blocks(1 << 10, ex.read_cols)))

        def run_background(self, conveyor):
            return [conveyor.submit("compaction", sh.maybe_compact)
                    for sh in shards]

    t = T()
    t.shards = shards
    for i in range(6):
        t.insert({"id": np.arange(i * 50, i * 50 + 50, dtype=np.int64),
                  "v": np.full(50, i, dtype=np.int64)})
    portions_before = sum(len(s.visible_portions()) for s in t.shards)
    assert portions_before >= 6

    ctl = ConveyorController()
    conv = Conveyor(workers=2, controller=ctl)
    ctl.stall()
    handles = t.run_background(conveyor=conv)
    time.sleep(0.05)

    # compaction is queued but stalled: scans and inserts proceed
    res = t.scan(COUNT)
    assert int(res.cols["n"][0][0]) == 300
    t.insert({"id": np.arange(300, 350, dtype=np.int64),
              "v": np.full(50, 9, dtype=np.int64)})
    res = t.scan(COUNT)
    assert int(res.cols["n"][0][0]) == 350
    assert sum(len(s.visible_portions()) for s in t.shards) > \
        portions_before  # nothing compacted yet

    ctl.resume()
    for h in handles:
        h.wait(30)
    conv.wait_idle()
    conv.shutdown()

    # compaction applied off-path; results unchanged, fewer portions
    res = t.scan(COUNT)
    assert int(res.cols["n"][0][0]) == 350
    assert sum(len(s.visible_portions()) for s in t.shards) < \
        portions_before
