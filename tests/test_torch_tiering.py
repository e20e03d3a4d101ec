"""The port's page cache and hot/cold tiers (``CachedBlobStore`` and
``TieredBlobStore`` in ``ydb_tpu_torch/engine/blobs.py``) and
``ColumnShard.evict_to_cold`` against the reference's.

``evict_to_cold`` imported ``TieredBlobStore`` from the port's blob
module, which lacked it, so every call raised ``ImportError``; the first
test shows the repair: 0 on a plain store, and on a tiered store the
same blobs moved as the reference moves, with scans still correct.
Mirrors ``tests/test_tiering.py`` (2 cases) and
``tests/test_backup_cache.py::test_page_cache_hits_and_invalidation``
and its memory-pressure cases (``CachedBlobStore.react_to_pressure`` and
the port ``Cluster.run_background``'s reaction), each through both
packages. Tolerance: none."""

import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdt
from ydb_tpu.engine import blobs as rblobs
from ydb_tpu.engine.shard import ColumnShard as RColumnShard
from ydb_tpu.engine.shard import ShardConfig as RShardConfig
from ydb_tpu.ssa.ops import Agg as RAgg
from ydb_tpu.ssa.program import AggSpec as RAggSpec
from ydb_tpu.ssa.program import GroupByStep as RGroupByStep
from ydb_tpu.ssa.program import Program as RProgram

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch.engine import blobs
from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
from ydb_tpu_torch.ssa.ops import Agg
from ydb_tpu_torch.ssa.program import AggSpec, GroupByStep, Program


@pytest.fixture(autouse=True)
def reference_pallas_stub(monkeypatch):
    """The reference's Pallas module does not import with this jax
    (ROADMAP.md queue C), as in the other port tests."""
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


def _count(prog, gb, spec, agg):
    return prog((gb(keys=(), aggs=(spec(agg.COUNT_ALL, None, "n"),
                                   spec(agg.SUM, "v", "s"))),))


#: (blob module, ColumnShard, ShardConfig, dtypes, COUNT program, kwargs)
KITS = ((rblobs, RColumnShard, RShardConfig, rdt,
         _count(RProgram, RGroupByStep, RAggSpec, RAgg), {}),
        (blobs, ColumnShard, ShardConfig, tdt,
         _count(Program, GroupByStep, AggSpec, Agg), {"device": "cpu"}))


def _shard(kit, store):
    """A shard with three old portions at the returned snap, then one
    newer portion."""
    b, shard_cls, cfg, dt, _count_p, kw = kit
    schema = dt.schema(("id", dt.INT64, False), ("v", dt.INT64))
    shard = shard_cls("t", schema, store, pk_column="id", upsert=True,
                      config=cfg(compact_portion_threshold=10 ** 9), **kw)
    for i in range(3):
        shard.commit([shard.write({
            "id": np.arange(i * 100, i * 100 + 100, dtype=np.int64),
            "v": np.full(100, i, dtype=np.int64)})])
    old_snap = shard.snap
    shard.commit([shard.write({"id": np.arange(300, 400, dtype=np.int64),
                               "v": np.full(100, 9, dtype=np.int64)})])
    return shard, old_snap


def test_evict_to_cold_returns_what_the_reference_returns():
    """Raised ImportError before the repair. A plain store moves
    nothing; a tiered store (bare or behind a page cache) moves the old
    portions' blobs, the same ids as the reference's."""
    got = []
    for kit in KITS:
        b = kit[0]
        plain, snap = _shard(kit, b.MemBlobStore())
        seen = [plain.evict_to_cold(snap)]
        for wrap in (lambda t: t, lambda t: b.CachedBlobStore(t)):
            tiered = b.TieredBlobStore(b.MemBlobStore(), b.MemBlobStore())
            shard, snap = _shard(kit, wrap(tiered))
            moved = shard.evict_to_cold(snap)
            seen.append((moved, sorted(tiered.cold.list("")),
                         sorted(tiered.hot.list(""))))
        got.append(seen)
    assert got[1] == got[0]
    assert got[1][0] == 0
    assert got[1][1][0] == got[1][2][0] == 3


# ---------------- tests/test_tiering.py ----------------

def test_tier_basics():
    for b in (rblobs, blobs):
        hot, cold = b.MemBlobStore(), b.MemBlobStore()
        t = b.TieredBlobStore(hot, cold)
        t.put("a", b"1")
        assert t.tier_of("a") == "hot"
        assert t.evict(lambda bid: True) == 1
        assert t.tier_of("a") == "cold"
        assert t.get("a") == b"1"          # transparent read-through
        assert t.get_range("a", 0, 1) == b"1"
        assert t.exists("a") and "a" in t.list("")
        assert t.promote("a") and not t.promote("a")
        assert t.tier_of("a") == "hot"
        # rewrite supersedes a cold copy
        t.evict(lambda bid: True)
        t.put("a", b"2")
        assert t.tier_of("a") == "hot" and t.get("a") == b"2"
        assert not cold.exists("a")
        t.delete("a")
        assert t.tier_of("a") is None


def test_shard_cold_eviction_keeps_scans_correct():
    got = []
    for kit in KITS:
        b, count = kit[0], kit[4]
        store = b.TieredBlobStore(b.MemBlobStore(), b.MemBlobStore())
        shard, old_snap = _shard(kit, store)
        moved = shard.evict_to_cold(old_snap)
        tiers = sorted(store.tier_of(m.blob_id)
                       for m in shard.visible_portions())
        res = shard.scan(count)
        got.append((moved, tiers, int(res.cols["n"][0][0]),
                    int(res.cols["s"][0][0])))
    assert got[1] == got[0]
    assert got[1] == (3, ["cold", "cold", "cold", "hot"], 400,
                      100 * (0 + 1 + 2 + 9))


# ---------------- tests/test_backup_cache.py ----------------

def test_page_cache_hits_and_invalidation(tmp_path):
    got = []
    for b in (rblobs, blobs):
        base = b.DirBlobStore(str(tmp_path / b.__name__ / "blobs"))
        cache = b.CachedBlobStore(base, capacity_bytes=1 << 20)
        cache.put("a", b"x" * 100)
        seen = [cache.get("a"), cache.get("a"), cache.stats()]
        cache.put("a", b"y" * 50)             # write-through invalidates
        seen += [cache.get("a"), cache.get_range("a", 10, 5)]
        cache.delete("a")
        seen += [cache.exists("a"), cache.stats()]
        small = b.CachedBlobStore(base, capacity_bytes=250)
        for i in range(5):
            small.put(f"b{i}", bytes([i]) * 100)
            small.get(f"b{i}")
        seen.append(small.stats())
        got.append(seen)
    assert got[1] == got[0]
    seen = got[1]
    assert seen[0] == seen[1] == b"x" * 100
    assert seen[2]["hits"] == 1 and seen[2]["misses"] == 1
    assert seen[3] == b"y" * 50 and seen[4] == b"y" * 5
    assert seen[5] is False and seen[6]["entries"] == 0
    assert seen[7]["bytes"] <= 250


def test_page_cache_memory_pressure():
    got = []
    for b in (rblobs, blobs):
        base = b.MemBlobStore()
        cache = b.CachedBlobStore(base, capacity_bytes=10_000)
        for i in range(20):
            base.put(f"b{i}", bytes([i]) * 400)
        assert all(cache.get(f"b{i}") == bytes([i]) * 400
                   for i in range(20))
        seen = [cache._bytes]
        for used in (0.9, 0.9, 0.5, 0.5, 0.5, 0.7):
            seen.append((cache.react_to_pressure(used),
                         cache.capacity_bytes, cache._bytes))
        assert all(cache.get(f"b{i}") == bytes([i]) * 400
                   for i in range(20))
        got.append(seen)
    assert got[1] == got[0]
    assert [s[:2] for s in got[1][1:]] == [
        ("shrink", 5_000), ("shrink", 4_096), ("grow", 8_192),
        ("grow", 10_000), ("steady", 10_000), ("steady", 10_000)]


def test_cluster_background_reacts_to_memory_pressure():
    """``Cluster.run_background`` shrinks a page cache's budget when the
    process's RSS is past ``memory_soft_limit_bytes``, as the
    reference's does."""
    from ydb_tpu_torch.config import AppConfig
    from ydb_tpu_torch.kqp.session import Cluster

    cache = blobs.CachedBlobStore(blobs.MemBlobStore(),
                                  capacity_bytes=1 << 20)
    c = Cluster(store=cache, device="cpu",
                config=AppConfig(memory_soft_limit_bytes=1))  # ~inf RSS
    st = c.run_background()
    assert st["cache_pressure"] == "shrink"
    assert cache.capacity_bytes < (1 << 20)
    # behind a tier, the cache is found through the wrapper
    tiered = blobs.TieredBlobStore(
        blobs.CachedBlobStore(blobs.MemBlobStore(), 1 << 20),
        blobs.MemBlobStore())
    c = Cluster(store=tiered, device="cpu",
                config=AppConfig(memory_soft_limit_bytes=1))
    assert c.run_background()["cache_pressure"] == "shrink"
    assert "cache_pressure" not in Cluster(device="cpu").run_background()
