"""The port's low-copy block staging pipeline on the CPU — the cases of
``tests/test_staging.py`` against ``ydb_tpu_torch``.

Covers: rechunk's aligned pass-through / single-buffer fast paths,
TableBlock.from_numpy tail-only padding (padding validity never leaks),
the shared-pool depth-k prefetch in stream_blocks (incl. abandoned
generators not leaking producer tasks), per-scan stage timers and the
scan-executor LRU cap. The side-stream staging of
``engine/staging.py`` (pinned slabs, an event per block) runs on the
card: its ``cuda``-marked test is at the end.
"""

import gc
import time

import numpy as np
import pytest

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.block import TableBlock
from ydb_tpu_torch.engine.blobs import DirBlobStore
from ydb_tpu_torch.engine.reader import rechunk, stream_blocks
from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
from ydb_tpu_torch.runtime.conveyor import shared_conveyor
from ydb_tpu_torch.ssa import Agg, AggSpec, GroupByStep, Program
from ydb_tpu_torch.ssa.program import Call, Col, FilterStep, Op, lit

@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The port's entry points default to CUDA; these tests ask for the
    CPU."""
    from ydb_tpu_torch import device

    monkeypatch.setattr(device, "DEFAULT_DEVICE", "cpu")


SCHEMA = dtypes.schema(("a", dtypes.INT64), ("b", dtypes.DOUBLE))


def _payload(n, seed=0):
    rng = np.random.default_rng(seed)
    return ({"a": rng.integers(0, 100, n).astype(np.int64),
             "b": rng.random(n)},
            {"a": np.ones(n, dtype=bool),
             "b": rng.random(n) > 0.2})


def test_rechunk_aligned_payload_passes_arrays_through():
    p = _payload(64)
    out = list(rechunk(iter([p]), ("a", "b"), 64))
    assert len(out) == 1
    cols, valid = out[0]
    # identity, not a copy: the aligned fast path
    assert cols["a"] is p[0]["a"]
    assert valid["b"] is p[1]["b"]


def test_rechunk_single_buffered_piece_skips_concat():
    p = _payload(40)
    out = list(rechunk(iter([p]), ("a", "b"), 64))
    assert len(out) == 1
    # whole-payload piece: original arrays flush through unconcatenated
    assert out[0][0]["a"] is p[0]["a"]


def test_rechunk_recut_matches_naive_concat():
    pieces = [_payload(n, seed=i) for i, n in enumerate([10, 64, 3, 57,
                                                         128, 1])]
    cap = 48
    got = list(rechunk(iter(pieces), ("a", "b"), cap))
    cat_a = np.concatenate([p[0]["a"] for p in pieces])
    cat_vb = np.concatenate([p[1]["b"] for p in pieces])
    assert sum(len(c["a"]) for c, _ in got) == len(cat_a)
    assert all(len(c["a"]) == cap for c, _ in got[:-1])
    np.testing.assert_array_equal(
        np.concatenate([c["a"] for c, _ in got]), cat_a)
    np.testing.assert_array_equal(
        np.concatenate([v["b"] for _, v in got]), cat_vb)


def test_from_numpy_tail_padding_never_leaks_validity():
    cols, valid = _payload(70)
    blk = TableBlock.from_numpy(cols, SCHEMA, valid, capacity=128)
    assert int(blk.length) == 70
    for name in ("a", "b"):
        v = np.asarray(blk.columns[name].validity)
        assert not v[70:].any(), f"padding validity leaked in {name}"
    np.testing.assert_array_equal(blk.to_numpy()["a"], cols["a"])
    # default validity (None) must also stay False in the tail
    blk2 = TableBlock.from_numpy(cols, SCHEMA, None, capacity=96)
    for name in ("a", "b"):
        v = np.asarray(blk2.columns[name].validity)
        assert v[:70].all() and not v[70:].any()


def test_from_numpy_aligned_no_padding():
    cols, valid = _payload(128)
    blk = TableBlock.from_numpy(cols, SCHEMA, valid, capacity=128)
    assert blk.capacity == 128 and int(blk.length) == 128
    np.testing.assert_array_equal(
        np.asarray(blk.columns["b"].validity), valid["b"])


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_stream_blocks_prefetch_depths_agree(depth):
    pieces = [_payload(n, seed=i) for i, n in enumerate([100, 30, 250])]
    base = list(stream_blocks(iter(pieces), ("a", "b"), SCHEMA, 64,
                              prefetch=False))
    got = list(stream_blocks(iter(pieces), ("a", "b"), SCHEMA, 64,
                             depth=depth))
    assert len(got) == len(base)
    for g, b in zip(got, base):
        assert int(g.length) == int(b.length)
        np.testing.assert_array_equal(np.asarray(g.columns["a"].data),
                                      np.asarray(b.columns["a"].data))


def test_stream_blocks_empty_stream_emits_one_block():
    out = list(stream_blocks(iter([]), ("a", "b"), SCHEMA, 16))
    assert len(out) == 1 and int(out[0].length) == 0


def test_abandoned_stream_releases_shared_pool_producer():
    def slow_payloads():
        for i in range(50):
            time.sleep(0.01)
            yield _payload(64, seed=i)

    gen = stream_blocks(slow_payloads(), ("a", "b"), SCHEMA, 64, depth=2)
    next(gen)  # producer is now parked on the bounded queue
    gen.close()  # GeneratorExit -> stop flag + drain
    del gen
    gc.collect()
    # the producer task must exit promptly instead of leaking a worker
    shared_conveyor().wait_idle(timeout=10.0)


def _mk_shard(tmp_path, rows=500):
    shard = ColumnShard(
        "t", SCHEMA, DirBlobStore(str(tmp_path)),
        config=ShardConfig(compact_portion_threshold=10 ** 9,
                           scan_block_rows=128,
                           scan_cache_entries=2))
    rng = np.random.default_rng(1)
    shard.commit([shard.write({
        "a": rng.integers(0, 10, rows).astype(np.int64),
        "b": rng.random(rows)})])
    return shard


def _prog(threshold):
    return Program((
        FilterStep(Call(Op.GE, Col("a"), lit(threshold))),
        GroupByStep(("a",), (AggSpec(Agg.COUNT_ALL, None, "n"),)),
    ))


def test_scan_reports_stage_timers(tmp_path):
    shard = _mk_shard(tmp_path)
    out = shard.scan(_prog(0))
    assert out.num_rows > 0
    stages = shard.last_scan_stages
    for key in ("read", "merge", "stage", "compute"):
        assert key in stages, stages
    assert stages["read"] > 0.0
    assert stages["compute"] > 0.0


def test_scan_cache_lru_bounded(tmp_path):
    shard = _mk_shard(tmp_path)
    for t in range(4):
        shard.scan(_prog(t))
    assert len(shard._scan_cache) <= 2
    # most-recent program stays cached (LRU keeps the tail)
    key3 = (_prog(3), ())
    assert any(k[0] == _prog(3) for k in shard._scan_cache)
    # re-scanning a cached program must not grow the cache
    shard.scan(_prog(3))
    assert len(shard._scan_cache) <= 2
    assert key3  # silence lint: structural key shape documented above


def test_scan_results_unchanged_by_staging_pipeline(tmp_path):
    # end-to-end: the low-copy + prefetch path produces the same result
    # as the synchronous path
    shard = _mk_shard(tmp_path, rows=700)
    out = shard.scan(_prog(2))
    a = shard.source_at().columns["a"]
    expect = {int(v): int((a[a >= 2] == v).sum())
              for v in np.unique(a[a >= 2])}
    got = {int(k): int(n) for k, n in zip(out.column("a"),
                                          out.column("n"))}
    assert got == expect


@pytest.mark.cuda
@pytest.mark.skipif(not __import__("torch").cuda.is_available(),
                    reason="side-stream staging needs an NVIDIA GPU")
def test_side_stream_staging_matches_from_numpy():
    """On the card: blocks staged through pinned slabs on a side stream
    (more blocks than slabs, so each slab is reused) equal
    ``TableBlock.from_numpy`` of the same payloads, consumed on the
    default stream after ``accept``."""
    import torch

    from ydb_tpu_torch.engine import staging

    st = staging.Stager("cuda")
    for i in range(5):
        cols, valid = _payload(1000 + i, seed=i)
        got = staging.accept(st.from_numpy(cols, valid, SCHEMA, 1024 + 64))
        want = TableBlock.from_numpy(cols, SCHEMA, valid,
                                     capacity=1024 + 64, device="cuda")
        assert int(got.length) == int(want.length)
        for n in ("a", "b"):
            assert torch.equal(got.columns[n].data, want.columns[n].data)
            assert torch.equal(got.columns[n].validity,
                               want.columns[n].validity)


@pytest.mark.cuda
def test_graph_capture_under_concurrent_prefetch(monkeypatch):
    """On the card: whole-plan fusion captures CUDA graphs while a shard
    scan's producer thread stages blocks ahead of its consumer and heat
    promotions copy portions to the device on conveyor threads. Those
    worker threads take ``device.capture_lock`` around their CUDA work,
    so every capture succeeds and every staged block is exact."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from ydb_tpu_torch.engine import resident as resident_mod
    from ydb_tpu_torch.engine import stream_sched
    from ydb_tpu_torch.engine.blobs import MemBlobStore
    from ydb_tpu_torch.engine.reader import PortionStreamSource
    from ydb_tpu_torch.plan import execute_plan, to_host
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import plan_select_full
    from ydb_tpu_torch.ssa import plan_fuse
    from ydb_tpu_torch.workload import tpch
    from ydb_tpu_torch.workload.queries import TPCH
    from ydb_tpu_torch.workload.runner import tpch_database

    monkeypatch.setattr(resident_mod, "RESIDENT_FORCE", True)
    monkeypatch.setattr(stream_sched, "PIPELINE_FORCE", True)
    shard = ColumnShard("bg", SCHEMA, MemBlobStore(), device="cuda",
                        config=ShardConfig(compact_portion_threshold=10 ** 9,
                                           portion_chunk_rows=1024))
    rng = np.random.default_rng(3)
    total = 0
    for _ in range(24):
        a = rng.integers(0, 10, 8192).astype(np.int64)
        total += int(a.sum())
        shard.commit([shard.write({"a": a, "b": rng.random(8192)})])
    shard.resident.drain()
    shard.resident.clear()
    shard.scan(_prog(0))  # every portion misses once: the next promotes

    data = tpch.TpchData(sf=0.01, seed=11)
    db, catalog = tpch_database(data, device="cuda")
    plans = {q: plan_select_full(parse(TPCH[q]), catalog).plan
             for q in ("q1", "q6", "q12")}
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", False)
    walked = {q: to_host(execute_plan(p, db, use_dq=False))
              for q, p in plans.items()}
    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", True)

    src = PortionStreamSource(shard, shard.visible_portions())
    blocks = src.blocks(2048, ("a",))
    got_sum = 0
    for _ in range(3):
        db.invalidate_compile_cache()  # every statement captures anew
        for q, p in plans.items():
            blk = next(blocks)  # frees a slot: the producer stages on
            n = int(blk.length)
            got_sum += int(blk.columns["a"].data[:n].sum())
            got = to_host(execute_plan(p, db, use_dq=False))
            for name in walked[q].schema.names:
                g = np.asarray(got.cols[name][0])
                w = np.asarray(walked[q].cols[name][0])
                if np.issubdtype(w.dtype, np.floating):
                    np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=q)
                else:
                    np.testing.assert_array_equal(g, w, err_msg=q)
    for blk in blocks:
        n = int(blk.length)
        got_sum += int(blk.columns["a"].data[:n].sum())
    assert got_sum == total
    shard.resident.drain()
    assert shard.resident.snapshot()["promotions"] > 0
    assert shard.resident.snapshot()["errors"] == 0
