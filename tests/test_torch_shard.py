"""The port's ColumnShard state plane on the CPU: MVCC, compaction, TTL,
WAL recovery and the device block cache.

The cases of ``tests/test_shard.py`` run against ``ydb_tpu_torch``
(which mirror the reference's columnshard ut_rw / engine change tests,
tx/columnshard/ut_rw and engines/changes/*, at the capability level).
Parity with the reference's shard is in ``tests/test_torch_storage.py``.
"""

import numpy as np
import pytest

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.engine.blobs import DirBlobStore, MemBlobStore
from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
from ydb_tpu_torch.ssa import Agg, AggSpec, Call, Col, FilterStep, GroupByStep, Op
from ydb_tpu_torch.ssa.program import Program, lit

@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The port's entry points default to CUDA; these tests ask for the
    CPU."""
    from ydb_tpu_torch import device

    monkeypatch.setattr(device, "DEFAULT_DEVICE", "cpu")


SCHEMA = dtypes.schema(
    ("id", dtypes.INT64, False),
    ("ts", dtypes.DATE, False),
    ("tag", dtypes.STRING),
    ("val", dtypes.INT64),
)


def _shard(store=None, **cfg):
    return ColumnShard(
        "shard1", SCHEMA, store or MemBlobStore(),
        pk_column="id", ttl_column="ts",
        config=ShardConfig(**cfg) if cfg else None,
    )


def _write(shard, ids, ts=None, tags=None, vals=None):
    n = len(ids)
    cols = shard.encode_strings({
        "id": np.asarray(ids, dtype=np.int64),
        "ts": np.asarray(ts if ts is not None else [100] * n, dtype=np.int32),
        "tag": tags if tags is not None else [b"x"] * n,
        "val": np.asarray(vals if vals is not None else ids, dtype=np.int64),
    })
    return shard.write(cols)


def _count(shard, snap=None):
    prog = Program((
        GroupByStep(keys=(), aggs=(AggSpec(Agg.COUNT_ALL, None, "n"),)),
    ))
    return int(shard.scan(prog, snap).cols["n"][0][0])


def test_write_commit_scan_mvcc():
    shard = _shard()
    w1 = _write(shard, [1, 2, 3])
    assert _count(shard) == 0  # uncommitted writes invisible
    s1 = shard.commit([w1])
    assert _count(shard) == 3
    w2 = _write(shard, [4, 5])
    s2 = shard.commit([w2])
    assert _count(shard) == 5
    # reads at the older snapshot still see the old state
    assert _count(shard, s1) == 3
    assert _count(shard, s2) == 5
    assert _count(shard, 0) == 0


def test_scan_with_program_and_strings():
    shard = _shard()
    shard.commit([_write(shard, [1, 2, 3, 4],
                         tags=[b"a", b"b", b"a", b"c"],
                         vals=[10, 20, 30, 40])])
    from ydb_tpu_torch.ssa.program import DictPredicate

    prog = Program((
        FilterStep(DictPredicate("tag", "eq", b"a")),
        GroupByStep(keys=(), aggs=(AggSpec(Agg.SUM, "val", "s"),)),
    ))
    assert int(shard.scan(prog).cols["s"][0][0]) == 40


def test_compaction_preserves_snapshots_and_sorts_pk():
    shard = _shard()
    s_old = None
    for batch in ([5, 3], [9, 1], [7, 2]):
        s_old = shard.commit([_write(shard, batch)])
    assert len(shard.visible_portions()) == 3
    shard.compact()
    vis = shard.visible_portions()
    assert len(vis) == 1
    # merged portion is PK-sorted with correct stats
    assert (vis[0].pk_min, vis[0].pk_max) == (1, 9)
    assert _count(shard) == 6
    # reader at the pre-compaction snapshot sees the old portions
    assert _count(shard, s_old) == 6
    metas_old = shard.visible_portions(s_old)
    assert len(metas_old) == 3


def test_pk_range_pruning():
    shard = _shard()
    shard.commit([_write(shard, [1, 2, 3])])
    shard.commit([_write(shard, [100, 200])])
    pruned = shard.visible_portions(pk_range=(150, None))
    assert len(pruned) == 1
    assert pruned[0].pk_min == 100


def test_ttl_eviction():
    shard = _shard()
    shard.commit([_write(shard, [1, 2, 3], ts=[10, 20, 30])])
    shard.commit([_write(shard, [4], ts=[50])])
    evicted = shard.evict_ttl(cutoff=25)
    assert evicted == 2
    assert _count(shard) == 2
    prog = Program((FilterStep(Call(Op.GE, Col("id"), lit(0))),))
    res = shard.scan(prog)
    assert sorted(res.cols["id"][0].tolist()) == [3, 4]


def test_gc_blobs():
    shard = _shard()
    shard.commit([_write(shard, [1])])
    shard.commit([_write(shard, [2])])
    shard.compact()
    n_before = len(shard.store.list("shard1/portion/"))
    assert shard.gc_blobs(keep_snap=shard.snap) == 2
    assert len(shard.store.list("shard1/portion/")) == n_before - 2
    assert _count(shard) == 2  # live data untouched


def test_boot_replays_wal(tmp_path):
    store = DirBlobStore(str(tmp_path))
    shard = ColumnShard("s", SCHEMA, store, pk_column="id",
                        ttl_column="ts")
    shard.commit([_write(shard, [1, 2], tags=[b"x", b"y"])])
    shard.commit([_write(shard, [3], tags=[b"z"])])
    snap = shard.snap

    # new process: recover purely from storage
    shard2 = ColumnShard.boot("s", SCHEMA, store, pk_column="id",
                              ttl_column="ts")
    assert shard2.snap == snap
    assert _count(shard2) == 3
    # dictionaries recovered (ids in portions must decode)
    assert shard2.dicts["tag"].values == [b"x", b"y", b"z"]
    # and the recovered shard continues writing correctly
    shard2.commit([_write(shard2, [4], tags=[b"w"])])
    assert _count(shard2) == 4


def test_boot_from_checkpoint_plus_tail(tmp_path):
    store = DirBlobStore(str(tmp_path))
    cfg = ShardConfig(checkpoint_interval=2)
    shard = ColumnShard("s", SCHEMA, store, pk_column="id", config=cfg)
    for i in range(5):
        shard.commit([_write(shard, [i * 10 + 1, i * 10 + 2])])
    shard2 = ColumnShard.boot("s", SCHEMA, store, pk_column="id", config=cfg)
    assert _count(shard2) == 10
    assert shard2.snap == shard.snap
    assert shard2.next_portion_id == shard.next_portion_id


def test_auto_compaction_trigger():
    shard = _shard(compact_portion_threshold=3)
    shard.commit([_write(shard, [1])])
    shard.commit([_write(shard, [2])])
    assert not shard.maybe_compact()
    shard.commit([_write(shard, [3])])
    assert shard.maybe_compact()
    assert len(shard.visible_portions()) == 1


def test_crash_mid_compaction_replays_to_precompaction_state():
    """Compaction outputs are WAL-staged and only activate at the
    compact_commit record: a crash anywhere mid-compaction (here: on the
    commit record itself, after every staged add) must boot back to the
    exact pre-compaction state — no lost rows, no duplicates."""

    class CrashingStore(MemBlobStore):
        armed = False

        def put(self, blob_id, data):
            if self.armed and b'"compact_commit"' in data:
                raise RuntimeError("injected crash before commit record")
            super().put(blob_id, data)

    store = CrashingStore()
    shard = ColumnShard(
        "s", SCHEMA, store, pk_column="id", upsert=True,
        config=ShardConfig(compact_portion_threshold=10**9,
                           max_portion_rows=64, checkpoint_interval=4),
    )
    # overlapping upserts: compaction will merge + dedup
    for i in range(5):
        wid = shard.write({
            "id": np.arange(0, 200, 2, dtype=np.int64),
            "ts": np.full(100, 100, dtype=np.int32),
            "tag": np.zeros(100, dtype=np.int64),
            "val": np.full(100, i, dtype=np.int64),
        })
        shard.commit([wid])
    pre = _count(shard)
    store.armed = True
    with pytest.raises(RuntimeError):
        shard.compact()
    store.armed = False
    booted = ColumnShard.boot(
        "s", SCHEMA, store, pk_column="id",
        config=ShardConfig(compact_portion_threshold=10**9,
                           max_portion_rows=64, checkpoint_interval=4),
    )
    booted.upsert = True
    assert _count(booted) == pre
    # staged blobs were orphan-collected; a fresh compaction completes
    booted.compact()
    assert _count(booted) == pre


# ---------------- device block cache (HBM page-cache analog) ----------------


def _sum_val(shard, snap=None):
    prog = Program((
        GroupByStep(keys=(), aggs=(AggSpec(Agg.SUM, "val", "s"),)),
    ))
    return int(shard.scan(prog, snap).cols["s"][0][0])


def test_block_cache_hits_and_invalidates_on_commit():
    """Warm scans reuse device-resident blocks; a commit changes the
    visible portion set, so the next scan must see the new rows (the
    shared_sausagecache analog keyed by immutable portion ids)."""
    shard = _shard(scan_cache_bytes=64 << 20)
    shard.commit([_write(shard, [1, 2, 3], vals=[10, 20, 30])])
    snap1 = shard.snap
    assert _sum_val(shard) == 60
    assert len(shard.block_cache) == 1
    # warm scan: same result, served from the cached blocks
    assert _sum_val(shard) == 60
    # new commit -> new key -> fresh read sees the extra rows
    shard.commit([_write(shard, [4], vals=[40])])
    assert _sum_val(shard) == 100
    # a warm scan AT THE OLD SNAPSHOT must keep resolving through its
    # own entry (same portion set as the first scan), never the newer
    # commit's blocks — and vice versa
    assert _sum_val(shard, snap1) == 60
    assert _sum_val(shard, snap1) == 60
    assert _sum_val(shard) == 100
    assert len(shard.block_cache) == 2
    # GC of superseded portions frees their now-unreachable entries
    shard.compact()
    shard.gc_blobs(keep_snap=shard.snap)
    assert _sum_val(shard) == 100
    live = set(shard.portions)
    assert all(set(k[0]) <= live for k in shard.block_cache)


def test_block_cache_correct_after_compaction_and_ttl():
    shard = _shard(scan_cache_bytes=64 << 20,
                   compact_portion_threshold=10 ** 9)
    for i in range(4):
        shard.commit([_write(shard, [i * 10 + 1, i * 10 + 2],
                             ts=[50 + i, 50 + i])])
    before = _count(shard)
    assert _sum_val(shard) > 0
    shard.compact()
    assert _count(shard) == before  # post-compaction portions re-read
    evicted = shard.evict_ttl(52)
    assert evicted > 0
    assert _count(shard) < before


def test_block_cache_respects_budget():
    """Entries beyond the byte budget evict LRU; an over-budget scan
    is never pinned at all."""
    shard = _shard(scan_cache_bytes=1)  # nothing fits
    shard.commit([_write(shard, list(range(100)))])
    assert _count(shard) == 100
    assert len(shard.block_cache) == 0
    assert shard.block_cache.nbytes == 0


def test_block_cache_off_by_default_on_cpu():
    shard = _shard()
    shard.commit([_write(shard, [1, 2])])
    assert _count(shard) == 2
    assert len(shard.block_cache) == 0
