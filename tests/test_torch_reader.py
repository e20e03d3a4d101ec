"""The port's streaming scan reader on the CPU: PK merge + newest-wins
dedup, cluster planning, fixed-capacity block stream, bounded-memory
out-of-core scan (SURVEY.md §2.7 scan reader;
plain_reader/iterator/merge.cpp dedup) — the cases of
``tests/test_reader.py`` against ``ydb_tpu_torch``."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.engine.reader import PortionStreamSource, plan_clusters
from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
from ydb_tpu_torch.ssa.ops import Agg
from ydb_tpu_torch.ssa.program import AggSpec, GroupByStep, Program

@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The port's entry points default to CUDA; these tests ask for the
    CPU."""
    from ydb_tpu_torch import device

    monkeypatch.setattr(device, "DEFAULT_DEVICE", "cpu")


SCHEMA = dtypes.schema(
    ("id", dtypes.INT64, False),
    ("v", dtypes.INT64),
)

COUNT = Program((GroupByStep(keys=(), aggs=(
    AggSpec(Agg.COUNT_ALL, None, "n"),
    AggSpec(Agg.SUM, "v", "s"),
)),))


def _shard(upsert=True, **cfg):
    store = MemBlobStore()
    return ColumnShard(
        "s1", SCHEMA, store, pk_column="id", upsert=upsert,
        config=ShardConfig(compact_portion_threshold=1000, **cfg),
    )


def _put(shard, ids, vals):
    wid = shard.write({"id": np.asarray(ids, dtype=np.int64),
                       "v": np.asarray(vals, dtype=np.int64)})
    return shard.commit([wid])


def _rows(shard, snap=None):
    src = PortionStreamSource(shard, shard.visible_portions(snap))
    out_i, out_v = [], []
    for blk in src.blocks(1 << 10):
        data = blk.to_numpy()
        n = int(blk.length)
        out_i += data["id"][:n].tolist()
        out_v += data["v"][:n].tolist()
    return dict(zip(out_i, out_v)), out_i


def test_upsert_same_pk_twice_sees_one_row():
    shard = _shard()
    _put(shard, [1, 2, 3], [10, 20, 30])
    snap1 = shard.snap
    _put(shard, [2], [99])
    rows, ids = _rows(shard)
    assert rows == {1: 10, 2: 99, 3: 30}
    assert len(ids) == 3  # the old row 2 is shadowed, not duplicated
    # older snapshot still sees the original value
    rows_old, _ = _rows(shard, snap=snap1)
    assert rows_old == {1: 10, 2: 20, 3: 30}


def test_upsert_within_batch_last_wins():
    shard = _shard()
    _put(shard, [7, 7, 7], [1, 2, 3])
    rows, ids = _rows(shard)
    assert rows == {7: 3}
    assert ids == [7]


def test_dedup_across_three_overlapping_portions():
    shard = _shard()
    _put(shard, [1, 2, 3, 4], [1, 1, 1, 1])
    _put(shard, [2, 3], [2, 2])
    _put(shard, [3, 5], [3, 3])
    rows, ids = _rows(shard)
    assert rows == {1: 1, 2: 2, 3: 3, 4: 1, 5: 3}
    assert sorted(ids) == [1, 2, 3, 4, 5]


def test_scan_program_respects_dedup():
    shard = _shard()
    _put(shard, list(range(100)), [1] * 100)
    _put(shard, list(range(50)), [2] * 50)   # overwrite half
    res = shard.scan(COUNT)
    assert int(res.cols["n"][0][0]) == 100
    assert int(res.cols["s"][0][0]) == 50 * 1 + 50 * 2


def test_append_mode_keeps_duplicates():
    shard = _shard(upsert=False)
    _put(shard, [1, 2], [1, 1])
    _put(shard, [2, 3], [2, 2])
    rows, ids = _rows(shard)
    assert sorted(ids) == [1, 2, 2, 3]
    res = shard.scan(COUNT)
    assert int(res.cols["n"][0][0]) == 4


def test_cluster_planning_overlap():
    from ydb_tpu_torch.engine.portion import PortionMeta

    def m(pid, lo, hi, snap=1):
        return PortionMeta(pid, f"b{pid}", 10, snap, pk_min=lo, pk_max=hi)

    # [0,5] [3,8] overlap; [20,30] apart; statless joins everything
    c = plan_clusters([m(1, 0, 5), m(2, 3, 8), m(3, 20, 30)], dedup=True)
    assert [[p.portion_id for p in cl] for cl in c] == [[1, 2], [3]]
    c = plan_clusters([m(1, 0, 5), m(2, 3, 8), m(3, 20, 30)], dedup=False)
    assert len(c) == 3
    statless = PortionMeta(9, "b9", 10, 1)
    c = plan_clusters([m(1, 0, 5), m(3, 20, 30), statless], dedup=True)
    assert len(c) == 1 and len(c[0]) == 3


def test_block_capacities_stay_fixed():
    shard = _shard(upsert=False)
    for i in range(5):
        _put(shard, list(range(i * 100, i * 100 + 100)), [i] * 100)
    src = PortionStreamSource(shard, shard.visible_portions())
    caps = [b.capacity for b in src.blocks(128)]
    assert len(set(caps)) == 1  # one compiled program serves all blocks
    total = sum(int(b.length) for b in src.blocks(128))
    assert total == 500


def test_compaction_bounds_portion_size_and_dedups():
    shard = _shard(max_portion_rows=64)
    for i in range(6):
        _put(shard, list(range(0, 200, 2)), [i] * 100)  # same 100 keys
    shard.compact()
    live = shard.visible_portions()
    assert all(m.num_rows <= 64 for m in live)
    rows, ids = _rows(shard)
    assert len(ids) == 100
    assert set(rows.values()) == {5}  # newest write wins everywhere
    # clusters after compaction are all singletons (disjoint PK ranges)
    assert all(
        len(c) == 1 for c in plan_clusters(live, dedup=True)
    )


def test_sharded_table_upsert_across_shards():
    """Three upsert shards of one table (rows routed by id % 3, as a
    hash-sharded table routes them; the reference's ``ShardedTable`` and
    its coordinator come with the session plane), scanned as one
    ``MultiShardStreamSource``."""
    from ydb_tpu_torch.blocks.dictionary import DictionarySet
    from ydb_tpu_torch.engine.reader import MultiShardStreamSource
    from ydb_tpu_torch.engine.scan import ScanExecutor

    dicts = DictionarySet()
    shards = [ColumnShard(f"t/{i}", SCHEMA, MemBlobStore(), pk_column="id",
                          upsert=True, dicts=dicts) for i in range(3)]

    def insert(ids, vals):
        for i, sh in enumerate(shards):
            m = ids % 3 == i
            sh.commit([sh.write({"id": ids[m], "v": vals[m]})])

    def scan():
        src = MultiShardStreamSource(shards, SCHEMA, dicts)
        ex = ScanExecutor(COUNT, src, 1 << 10)
        from ydb_tpu_torch.engine.oracle import OracleTable

        return OracleTable.from_block(ex.run_stream(
            src.blocks(1 << 10, ex.read_cols)))

    insert(np.arange(100, dtype=np.int64), np.ones(100, dtype=np.int64))
    insert(np.arange(0, 100, 2, dtype=np.int64),
           np.full(50, 7, dtype=np.int64))
    res = scan()
    assert int(res.cols["n"][0][0]) == 100
    assert int(res.cols["s"][0][0]) == 50 * 1 + 50 * 7
    # compaction keeps the dedup'd state
    for s in shards:
        s.compact()
    res = scan()
    assert int(res.cols["n"][0][0]) == 100
    assert int(res.cols["s"][0][0]) == 50 * 1 + 50 * 7


PEAK_MB_HELPER = '''
def peak_mb() -> float:
    """True peak RSS of THIS process image, from /proc VmHWM.

    NOT resource.getrusage: on Linux ru_maxrss lives in the signal
    struct and SURVIVES execve, so a child forked from a fat parent
    (pytest with 200 tests of JAX buffers resident) inherits the
    parent's peak and reports ~1.4 GB before allocating a byte. VmHWM
    belongs to the mm, which execve replaces.
    """
    for line in open("/proc/self/status"):
        if line.startswith("VmHWM"):
            return float(line.split()[1]) / 1024.0
    raise RuntimeError("no VmHWM")
'''


def _run_rss_script(script: str, tmp_path) -> None:
    # a fixed mmap threshold: glibc otherwise raises it after the first
    # large frees and keeps later blocks of the same size in its arenas,
    # so the peak would count the allocator's cache, not the scan's
    # working set (the reference's copy of these tests peaks at 855 MB
    # on this host for that reason)
    env = dict(os.environ, MALLOC_MMAP_THRESHOLD_=str(256 << 10))
    proc = subprocess.run(
        [sys.executable, "-c",
         PEAK_MB_HELPER + textwrap.dedent(script), str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert proc.returncode == 0, \
        (proc.stderr[-2000:] or "") + (proc.stdout[-500:] or "")


@pytest.mark.slow
def test_out_of_core_scan_bounded_rss(tmp_path):
    """Scan ~2.4 GB of disjoint-range portions while the process grows
    by under 320 MB above its footprint after imports (the reference's
    480 MB cap less its ~160 MB import footprint; torch's is larger): the
    streaming reader must never materialize the table."""
    _run_rss_script("""
        import sys
        import numpy as np
        from ydb_tpu_torch import device
        device.DEFAULT_DEVICE = "cpu"
        from ydb_tpu_torch import dtypes
        from ydb_tpu_torch.engine.blobs import DirBlobStore
        from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig

        root = sys.argv[1]
        mb0 = peak_mb()
        schema = dtypes.schema(("id", dtypes.INT64, False),
                               ("a", dtypes.INT64), ("b", dtypes.INT64))
        store = DirBlobStore(root)
        shard = ColumnShard(
            "big", schema, store, pk_column="id", upsert=True,
            config=ShardConfig(compact_portion_threshold=10**9,
                               scan_block_rows=1 << 18))
        rows_per_portion = 1 << 18      # 3 cols x 8B x 262k = ~6 MB
        n_portions = 400                # ~2.4 GB total, disjoint PK ranges
        for p in range(n_portions):
            base = p * rows_per_portion
            ids = np.arange(base, base + rows_per_portion, dtype=np.int64)
            wid = shard.write({"id": ids, "a": ids * 2, "b": ids % 7})
            shard.commit([wid])
        from ydb_tpu_torch.ssa.ops import Agg
        from ydb_tpu_torch.ssa.program import AggSpec, GroupByStep, Program
        prog = Program((GroupByStep(keys=(), aggs=(
            AggSpec(Agg.COUNT_ALL, None, "n"),
            AggSpec(Agg.SUM, "b", "s"),
        )),))
        res = shard.scan(prog)
        n = int(res.cols["n"][0][0])
        assert n == n_portions * rows_per_portion, n
        mb = peak_mb()
        print("peak_mb", mb)
        assert mb - mb0 < 320, f"streaming scan grew RSS by {mb - mb0}"
    """, tmp_path)


@pytest.mark.slow
def test_overlapping_upsert_scan_bounded_rss(tmp_path):
    """The adversarial workload: uniform-random upserts across the whole
    PK space make EVERY portion overlap every other — one giant cluster.
    The incremental K-way merge must still scan ~2 GB while the process
    grows by under 240 MB above its footprint after imports (the
    reference's 400 MB cap less its import footprint), with correct
    newest-wins dedup (no compaction to rescue it)."""
    _run_rss_script("""
        import sys
        import numpy as np
        from ydb_tpu_torch import device
        device.DEFAULT_DEVICE = "cpu"
        from ydb_tpu_torch import dtypes
        from ydb_tpu_torch.engine.blobs import DirBlobStore
        from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig

        root = sys.argv[1]
        mb0 = peak_mb()
        schema = dtypes.schema(("id", dtypes.INT64, False),
                               ("a", dtypes.INT64), ("b", dtypes.INT64))
        store = DirBlobStore(root)
        shard = ColumnShard(
            "hot", schema, store, pk_column="id", upsert=True,
            config=ShardConfig(compact_portion_threshold=10**9,
                               scan_block_rows=1 << 18,
                               portion_chunk_rows=1 << 12))
        rng = np.random.default_rng(7)
        key_space = 1 << 23             # 8.4M keys
        rows_per_portion = 1 << 18
        n_portions = 320                # ~2 GB raw, all-overlapping
        latest = np.full(key_space, -1, dtype=np.int32)  # oracle (32 MB)
        for p in range(n_portions):
            ids = rng.integers(0, key_space, rows_per_portion,
                               dtype=np.int64)
            wid = shard.write({"id": ids, "a": np.full(
                rows_per_portion, p, dtype=np.int64), "b": ids % 7})
            shard.commit([wid])
            latest[ids] = p
        seen = latest >= 0
        want_n = int(seen.sum())
        want_s = int(latest[seen].astype(np.int64).sum())
        del seen
        from ydb_tpu_torch.ssa.ops import Agg
        from ydb_tpu_torch.ssa.program import AggSpec, GroupByStep, Program
        prog = Program((GroupByStep(keys=(), aggs=(
            AggSpec(Agg.COUNT_ALL, None, "n"),
            AggSpec(Agg.SUM, "a", "s"),
        )),))
        res = shard.scan(prog)
        n = int(res.cols["n"][0][0])
        s = int(res.cols["s"][0][0])
        assert n == want_n, (n, want_n)
        assert s == want_s, (s, want_s)
        mb = peak_mb()
        print("peak_mb", mb)
        assert mb - mb0 < 240, f"overlap merge grew RSS by {mb - mb0}"
    """, tmp_path)
