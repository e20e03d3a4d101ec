"""The port's DQ layer against the JAX package's, on the CPU.

The cases of ``tests/test_dq.py`` (actors, the simulated multi-node
runtime, the spiller and stage graphs) and one checkpoint-and-resume case
of ``tests/test_checkpoint.py``, each run twice on the same numpy inputs
made from a seed: through ``ydb_tpu_torch`` (``device="cpu"``) and through
``ydb_tpu``. Results must be equal (int64 columns exact), and where the
graph spills, both must spill the same number of payloads. Plus the shuffle
row hash: the port's ``hash_rows`` against the reference's, bit for bit.

As in the other port tests, the reference's unimportable Pallas module is
replaced for each test by a stand-in whose ``enabled()`` is False.
"""

import os
import sys
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdtypes
from ydb_tpu import native as rnative
from ydb_tpu.dq import checkpoint as rckpt
from ydb_tpu.dq import compute as rcompute
from ydb_tpu.dq import graph as rgraph
from ydb_tpu.dq import spilling as rspilling
from ydb_tpu.engine import blobs as rblobs
from ydb_tpu.engine.scan import ColumnSource as RSource
from ydb_tpu.runtime import actors as ractors
from ydb_tpu.runtime import test_runtime as rsim
from ydb_tpu.ssa import Agg, AggSpec, Call, Col, FilterStep, GroupByStep, Op
from ydb_tpu.ssa import twophase as rtwophase
from ydb_tpu.ssa.program import Program, ProjectStep, SortStep, lit

from ydb_tpu_torch import dtypes as tdtypes
from ydb_tpu_torch import native as tnative
from ydb_tpu_torch.dq import checkpoint as tckpt
from ydb_tpu_torch.dq import compute as tcompute
from ydb_tpu_torch.dq import graph as tgraph
from ydb_tpu_torch.dq import spilling as tspilling
from ydb_tpu_torch.engine import blobs as tblobs
from ydb_tpu_torch.engine.oracle import OracleTable, run_oracle
from ydb_tpu_torch.engine.scan import ColumnSource as TSource
from ydb_tpu_torch.interop import program_from_reference
from ydb_tpu_torch.runtime import actors as tactors
from ydb_tpu_torch.runtime import test_runtime as tsim
from ydb_tpu_torch.ssa import twophase as ttwophase


@pytest.fixture(autouse=True)
def reference_scatter_tier(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


#: one side of a comparison: the package's modules under common names
PORT = types.SimpleNamespace(
    name="port", actors=tactors, sim=tsim, graph=tgraph, compute=tcompute,
    spilling=tspilling, ckpt=tckpt, blobs=tblobs, twophase=ttwophase,
    Source=TSource, dtypes=tdtypes, prog=program_from_reference,
    kw={"device": "cpu"})
REF = types.SimpleNamespace(
    name="ref", actors=ractors, sim=rsim, graph=rgraph, compute=rcompute,
    spilling=rspilling, ckpt=rckpt, blobs=rblobs, twophase=rtwophase,
    Source=RSource, dtypes=rdtypes, prog=lambda p: p, kw={})
SIDES = (PORT, REF)


class _Echo:
    """An actor class per package: records messages, optionally replies
    with message + 1."""

    @staticmethod
    def make(side, reply=False):
        class Echo(side.actors.Actor):
            def __init__(self):
                super().__init__()
                self.got = []

            def receive(self, message, sender):
                self.got.append(message)
                if reply and isinstance(message, int) and sender is not None:
                    self.send(sender, message + 1)

        return Echo()


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_actor_system_basics(side):
    sys_ = side.actors.ActorSystem()
    a, b = _Echo.make(side), _Echo.make(side, reply=True)
    ida, idb = sys_.register(a), sys_.register(b)
    sys_.send(idb, 41, sender=ida)
    sys_.run()
    assert b.got == [41]
    assert a.got == [42]
    assert (ida.node, ida.local, idb.local) == (1, 1, 2)


def _sim_trace(side):
    """The tests/test_dq.py virtual-time scenario; returns what each
    actor got at each checkpoint and the delivery log's messages."""
    rt = side.sim.SimRuntime(n_nodes=2)
    a, b = _Echo.make(side), _Echo.make(side, reply=True)
    ida = rt.system(1).register(a)
    idb = rt.system(2).register(b)
    trace = []
    rt.system(1).send(idb, 1, sender=ida)
    rt.dispatch()
    trace.append((list(a.got), list(b.got)))
    rt.system(2).schedule(5.0, idb, "tick")
    rt.dispatch()
    trace.append(list(b.got))
    rt.advance_time(5.0)
    rt.dispatch()
    trace.append(list(b.got))
    rt.observer = lambda env: "drop" if env.message == "lost" else "pass"
    rt.system(1).send(idb, "lost")
    rt.system(1).send(idb, "kept")
    rt.dispatch()
    trace.append(list(b.got))
    # run_until advances the clock to the next timer
    rt.system(1).schedule(2.5, ida, "later")
    assert rt.run_until(lambda: "later" in a.got)
    trace.append((rt.now, list(a.got)))
    return trace, [e.message for e in rt.delivery_log]


def test_sim_runtime_virtual_time_and_interception():
    got, log = _sim_trace(PORT)
    assert (got, log) == _sim_trace(REF)
    assert got[0] == ([2], [1])
    assert "tick" not in got[1] and "tick" in got[2]
    assert "lost" not in got[3] and "kept" in got[3]
    assert got[4][0] == 7.5


# ---------------- stage graphs ----------------


def _make_sources(side, n_parts=4, rows=3000, seed=5):
    rng = np.random.default_rng(seed)
    sch = side.dtypes.schema(("k", side.dtypes.INT64),
                             ("v", side.dtypes.INT64))
    parts, merged = [], {"k": [], "v": []}
    for _ in range(n_parts):
        cols = {"k": rng.integers(0, 50, rows // n_parts),
                "v": rng.integers(0, 1000, rows // n_parts)}
        parts.append(side.Source(
            {k: np.asarray(v) for k, v in cols.items()}, sch))
        for k in merged:
            merged[k].append(cols[k])
    return sch, parts, {k: np.concatenate(v) for k, v in merged.items()}


AGG = Program((
    FilterStep(Call(Op.GE, Col("v"), lit(100))),
    GroupByStep(keys=("k",), aggs=(
        AggSpec(Agg.SUM, "v", "total"),
        AggSpec(Agg.COUNT_ALL, None, "n"),
    )),
    SortStep(keys=("k",)),
))
KEYLESS = Program((GroupByStep(keys=(), aggs=(
    AggSpec(Agg.SUM, "v", "total"),)),))


def _two_stage(side, n_parts):
    """scan(partial agg) -> HashPartition(k) -> final agg -> result."""
    g = side.graph
    partial, final = side.twophase.split(side.prog(AGG))
    return [
        g.StageSpec(program=partial, inputs=(g.SourceInput("t"),),
                    output=g.HashPartition(("k",)), tasks=n_parts),
        g.StageSpec(program=None, inputs=(g.UnionAllInput(0),),
                    output=g.HashPartition(("k",)), tasks=2,
                    final_program=final),
        g.StageSpec(program=None, inputs=(g.UnionAllInput(1),),
                    output=g.ResultOutput(), tasks=1,
                    final_program=side.prog(Program((SortStep(keys=("k",)),)))),
    ]


def _run(side, stages, parts, n_nodes, **kw):
    """Run a graph to completion; (result table, spill count of each
    task)."""
    rt = side.sim.SimRuntime(n_nodes=n_nodes)
    handle = side.compute.build_stage_graph(
        stages, {"t": parts}, rt, **kw, **side.kw)
    try:
        handle.start()
        rt.dispatch()
        assert handle.collector.done and handle.collector.error is None
        return handle.collector.table(), [a.spiller.spill_count
                                          for a in handle.actors]
    finally:
        handle.close()


def _both(make_stages, n_nodes=2, src_kw=None, **kw):
    """The same graph through the port and the reference: the port's
    (table, spills), the reference's, and the merged input columns."""
    out = []
    for side in SIDES:
        _, parts, merged = _make_sources(side, **(src_kw or {}))
        out.append(_run(side, make_stages(side, len(parts)), parts,
                        n_nodes, **kw))
    return out[0], out[1], merged


def _assert_same(port_table, ref_table, cols=None):
    names = cols or ref_table.schema.names
    assert list(port_table.schema.names) == list(ref_table.schema.names)
    assert port_table.num_rows == ref_table.num_rows
    for c in names:
        pv, pok = port_table.cols[c]
        rv, rok = (np.asarray(x) for x in ref_table.cols[c])
        np.testing.assert_array_equal(pok, rok, err_msg=c)
        np.testing.assert_array_equal(pv, rv, err_msg=c)


def _oracle(program, merged):
    sch = tdtypes.schema(("k", tdtypes.INT64), ("v", tdtypes.INT64))
    return run_oracle(program_from_reference(program), OracleTable(
        {k: (v, np.ones(len(v), dtype=bool)) for k, v in merged.items()},
        sch))


@pytest.mark.parametrize("n_nodes,src_kw,window,quota", [
    (3, {}, 4, 64 << 20),
    # credit window of 1 + zero memory quota: every parked block spills
    (2, {"n_parts": 3, "rows": 1500}, 1, 0),
    # aggregate accumulation through the spiller beyond a zero quota
    (1, {"n_parts": 3, "rows": 900}, 4, 0),
], ids=["distributed_agg", "tiny_window_spilling", "agg_accumulation_spills"])
def test_two_stage_aggregate_matches_reference_and_oracle(
        n_nodes, src_kw, window, quota):
    (pt, pspill), (rt, rspill), merged = _both(
        _two_stage, n_nodes, src_kw, window=window, spill_quota_bytes=quota)
    _assert_same(pt, rt)
    assert pspill == rspill
    if quota == 0:
        assert sum(pspill) > 0
    ora = _oracle(AGG, merged)
    for c in ("k", "total", "n"):
        np.testing.assert_array_equal(pt.cols[c][0], ora.cols[c][0])


def test_filter_map_stage_without_agg():
    prog = Program((
        FilterStep(Call(Op.GE, Col("v"), lit(900))),
        ProjectStep(("k", "v")),
    ))

    def stages(side, n_parts):
        g = side.graph
        # single-task result stage reading the source directly
        return [g.StageSpec(program=side.prog(prog),
                            inputs=(g.SourceInput("t"),),
                            output=g.ResultOutput(), tasks=1)]

    out = []
    for side in SIDES:
        _, parts, merged = _make_sources(side, n_parts=2, rows=400)
        out.append(_run(side, stages(side, 1), parts[:1], 2)[0])
    _assert_same(*out)
    ora = _oracle(prog, {k: v[:200] for k, v in merged.items()})
    assert out[0].num_rows == ora.num_rows > 0
    np.testing.assert_array_equal(out[0].cols["v"][0], ora.cols["v"][0])


@pytest.mark.parametrize("tasks", [2, 3, 4, 6])
def test_source_partitions_differ_from_task_count(tasks):
    """Strided partition assignment: every partition is read exactly once
    whether tasks < partitions or tasks > partitions."""

    def stages(side, n_parts):
        g = side.graph
        partial, final = side.twophase.split(side.prog(KEYLESS))
        return [
            g.StageSpec(program=partial, inputs=(g.SourceInput("t"),),
                        output=g.HashPartition(()), tasks=tasks),
            g.StageSpec(program=None, inputs=(g.UnionAllInput(0),),
                        output=g.ResultOutput(), tasks=1,
                        final_program=final),
        ]

    (pt, _), (rt, _), merged = _both(stages, 2, {"n_parts": 4, "rows": 2000})
    _assert_same(pt, rt)
    assert int(pt.cols["total"][0][0]) == int(merged["v"].sum())


def test_multi_consumer_stage_gets_full_stream():
    """A producer feeding two consumer stages must route the FULL stream
    to each (per-consumer channel groups), not split it across them."""

    def stages(side, n_parts):
        g = side.graph
        keyless = side.prog(KEYLESS)
        _, final = side.twophase.split(keyless)
        return [
            g.StageSpec(program=None, inputs=(g.SourceInput("t"),),
                        output=g.HashPartition(("k",)), tasks=2),
            g.StageSpec(program=None, inputs=(g.UnionAllInput(0),),
                        output=g.HashPartition(()), tasks=2,
                        final_program=keyless),
            g.StageSpec(program=None, inputs=(g.UnionAllInput(0),),
                        output=g.HashPartition(()), tasks=1,
                        final_program=keyless),
            g.StageSpec(program=None,
                        inputs=(g.UnionAllInput(1), g.UnionAllInput(2)),
                        output=g.ResultOutput(), tasks=1,
                        final_program=final),
        ]

    (pt, _), (rt, _), merged = _both(stages, 2, {"n_parts": 2, "rows": 1000})
    _assert_same(pt, rt)
    assert int(pt.cols["total"][0][0]) == 2 * int(merged["v"].sum())


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_multi_input_schema_mismatch_raises(side):
    g = side.graph
    _, parts, _ = _make_sources(side, n_parts=2, rows=200)
    stages = [
        g.StageSpec(program=side.prog(Program((ProjectStep(("k",)),))),
                    inputs=(g.SourceInput("t"),),
                    output=g.HashPartition(("k",)), tasks=1),
        g.StageSpec(program=side.prog(Program((ProjectStep(("v",)),))),
                    inputs=(g.SourceInput("t"),),
                    output=g.HashPartition(("v",)), tasks=1),
        g.StageSpec(program=None,
                    inputs=(g.UnionAllInput(0), g.UnionAllInput(1)),
                    output=g.ResultOutput(), tasks=1),
    ]
    with pytest.raises(ValueError, match="share one schema"):
        side.compute.run_stage_graph(stages, {"t": parts},
                                     side.sim.SimRuntime(n_nodes=1),
                                     **side.kw)


def test_build_tasks_matches_reference():
    """Tasks and channels of a three-stage graph, field by field."""
    out = []
    for side in SIDES:
        tasks, chans, result = side.graph.build_tasks(_two_stage(side, 3))
        out.append(([(t.task_id, t.stage, t.partition, t.input_channels,
                      t.output_channels) for t in tasks],
                    [tuple(vars(c).values()) for c in chans], result))
    assert out[0] == out[1]


@pytest.mark.parametrize("block_rows,start", [(128, 0), (128, 3), (500, 1),
                                              (5000, 0)])
def test_source_seek_and_block_fetch_match_reference(block_rows, start):
    """``ColumnSource.n_blocks`` and ``blocks(start_block=...)`` (the
    checkpoint-resume seek), and ``TableBlock.to_numpy`` /
    ``validity_numpy`` (a payload's two halves), against the
    reference's."""
    rng = np.random.default_rng(6)
    k = rng.integers(-50, 50, 1234)
    ok = rng.random(1234) > 0.2
    out = []
    for side in SIDES:
        sch = side.dtypes.schema(("k", side.dtypes.INT64))
        src = side.Source({"k": k}, sch, None, {"k": ok})
        blocks = list(src.blocks(block_rows, start_block=start, **side.kw))
        out.append((src.n_blocks(block_rows),
                    [(b.capacity, b.to_numpy()["k"], b.validity_numpy()["k"])
                     for b in blocks]))
    (pn, pb), (rn, rb) = out
    assert pn == rn and len(pb) == len(rb) == max(rn - start, 0)
    for (pc, pk, pv), (rc, rk, rv) in zip(pb, rb):
        assert pc == int(rc)
        np.testing.assert_array_equal(pk, np.asarray(rk))
        np.testing.assert_array_equal(pv, np.asarray(rv))


# ---------------- spiller ----------------


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_spiller_quota_and_roundtrip(side):
    sp = side.spilling.Spiller(mem_quota_bytes=100, prefix="s")
    small = {"a": np.arange(4, dtype=np.int64)}       # 32 bytes
    big = {"a": np.arange(100, dtype=np.int64)}       # 800 bytes -> spill
    s1 = sp.put(small)
    s2 = sp.put(big)
    assert sp.spill_count == 1
    assert sp.store.list() == ["s/1"]
    np.testing.assert_array_equal(sp.get(s2)["a"], big["a"])
    np.testing.assert_array_equal(sp.get(s1)["a"], small["a"])
    assert sp.store.list() == []
    with pytest.raises(KeyError):
        sp.get(s2)


def test_spiller_encoding_decodes_across_packages():
    """A payload the port spilled decodes with the reference's decoder and
    the other way round (the byte format is np.savez in both)."""
    payload = {"a": np.arange(8, dtype=np.int64),
               "__v_a": np.arange(8) % 3 > 0,
               "f": np.linspace(0, 1, 8)}
    for enc, dec in ((tspilling._encode, rspilling._decode),
                     (rspilling._encode, tspilling._decode)):
        got = dec(enc(payload))
        assert sorted(got) == sorted(payload)
        for k in payload:
            assert got[k].dtype == payload[k].dtype
            np.testing.assert_array_equal(got[k], payload[k])


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_spiller_peek_does_not_consume(side):
    sp = side.spilling.Spiller(mem_quota_bytes=0, prefix="s")
    sid = sp.put({"a": np.arange(8, dtype=np.int64)})
    np.testing.assert_array_equal(sp.peek(sid)["a"], np.arange(8))
    np.testing.assert_array_equal(sp.peek(sid)["a"], np.arange(8))
    np.testing.assert_array_equal(sp.get(sid)["a"], np.arange(8))
    with pytest.raises(KeyError):
        sp.peek(sid)
    # close() deletes what is still spilled
    sp.put({"a": np.arange(3)})
    assert sp.store.list()
    sp.close()
    assert sp.store.list() == []


def test_dir_blob_store_roundtrip(tmp_path):
    st = tblobs.DirBlobStore(str(tmp_path / "blobs"))
    st.put("spill/task0/1", b"abc")
    st.put("spill/task0/2", b"defg")
    st.put("ckpt/x", b"1")
    assert st.list("spill/") == ["spill/task0/1", "spill/task0/2"]
    assert st.get_range("spill/task0/2", 1, 2) == b"ef"
    assert st.size("spill/task0/2") == 4
    st.delete("spill/task0/1")
    assert not st.exists("spill/task0/1") and st.exists("ckpt/x")


# ---------------- the shuffle row hash ----------------


def _hash_inputs(case, rng):
    i64 = np.iinfo(np.int64)
    if case == "zero_rows":
        return [np.empty(0, np.int64)], [np.empty(0, bool)]
    if case == "null_keys":
        k = rng.integers(-50, 50, 999)
        return [k], [rng.random(999) > 0.3]
    if case == "extremes":
        k = np.array([i64.min, i64.min + 1, -1, 0, 1, i64.max - 1, i64.max]
                     * 3, dtype=np.int64)
        return [k], [np.arange(len(k)) % 4 != 3]
    # two key columns, negatives, an int32 column widened as _hash_rows
    # widens it, and a NULL in each
    a = rng.integers(i64.min, i64.max, 4096, dtype=np.int64)
    b = rng.integers(-(1 << 31), 1 << 31, 4096).astype(np.int32)
    return ([a, b.astype(np.int64)],
            [rng.random(4096) > 0.1, rng.random(4096) > 0.1])


@pytest.mark.parametrize("path", ["cpp", "numpy"])
@pytest.mark.parametrize("case", ["zero_rows", "null_keys", "extremes",
                                  "two_columns"])
def test_hash_rows_bit_identical_to_reference(case, path, monkeypatch):
    """The port's hash equals the reference's C++ library (``cpp``; the
    numpy twin when the library cannot build, YDB_TPU_NO_NATIVE set) and
    the reference's numpy twin (``numpy``), bit for bit."""
    keys, valids = _hash_inputs(case, np.random.default_rng(3))
    if path == "numpy":
        monkeypatch.setattr(rnative, "_lib", False)
    elif not os.environ.get("YDB_TPU_NO_NATIVE"):
        assert rnative.available(), "reference's C++ hash library missing"
    want = rnative.hash_rows(keys, valids)
    got = tnative.hash_rows(keys, valids)
    assert got.dtype == np.uint64 and want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def test_split_by_hash_matches_reference():
    rng = np.random.default_rng(4)
    payload = {"k": rng.integers(-9, 9, 500),
               "__v_k": rng.random(500) > 0.2,
               "x": rng.random(500)}
    h = tcompute._hash_rows(payload, None, ("k",))
    np.testing.assert_array_equal(h, rcompute._hash_rows(payload, None,
                                                         ("k",)))
    for n in (1, 2, 3):
        got = tcompute._split_by_hash(payload, h, n)
        want = rcompute._split_by_hash(payload, h, n)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            for k in payload:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("n", [2, 3])
def test_split_block_routes_on_the_device_as_the_reference_splits(n):
    """A hash fan-out groups a block's rows by destination on the device
    and cuts the one fetched payload: the parts (rows, order, nulls) are
    the reference's ``_split_by_hash`` of the same payload; padding rows
    stay out."""
    rng = np.random.default_rng(n)
    k = rng.integers(-(1 << 40), 1 << 40, 700)
    k[::5] = rng.integers(-3, 3, len(k[::5]))
    valid = rng.random(700) > 0.2
    x = rng.integers(0, 1000, 700)
    sch = tdtypes.schema(("k", tdtypes.INT64), ("x", tdtypes.INT64))
    blk = tcompute.TableBlock.from_numpy({"k": k, "x": x}, sch,
                                         {"k": valid}, capacity=1024,
                                         device="cpu")
    got = tcompute._split_block(blk, sch, ("k",), n)
    payload = {"k": k, "__v_k": valid, "x": x,
               "__v_x": np.ones(700, dtype=bool)}
    want = rcompute._split_by_hash(
        payload, rcompute._hash_rows(payload, None, ("k",)), n)
    assert sum(len(p["k"]) for p in got) == 700
    for g, w in zip(got, want):
        for c in payload:
            np.testing.assert_array_equal(g[c], w[c], err_msg=c)


# ---------------- checkpoint and resume ----------------


CKPT_AGG = Program((GroupByStep(keys=("k",), aggs=(
    AggSpec(Agg.SUM, "v", "total"),
    AggSpec(Agg.COUNT_ALL, None, "n"),
)),))


def _ckpt_stages(side, n_parts):
    g = side.graph
    partial, final = side.twophase.split(side.prog(CKPT_AGG))
    return [
        g.StageSpec(program=partial, inputs=(g.SourceInput("t"),),
                    output=g.HashPartition(("k",)), tasks=n_parts),
        g.StageSpec(program=None, inputs=(g.UnionAllInput(0),),
                    output=g.HashPartition(("k",)), tasks=2,
                    final_program=final),
        g.StageSpec(program=None, inputs=(g.UnionAllInput(1),),
                    output=g.ResultOutput(), tasks=1,
                    final_program=side.prog(Program((SortStep(keys=("k",)),)))),
    ]


def _crash_and_resume(side):
    """tests/test_checkpoint.py's crash-and-resume: checkpoint mid-stream,
    abandon the runtime, restore a fresh graph from the checkpoint.
    Returns the saved task states and the resumed result."""
    rng = np.random.default_rng(9)
    sch = side.dtypes.schema(("k", side.dtypes.INT64),
                             ("v", side.dtypes.INT64))
    parts = [side.Source({"k": rng.integers(0, 7, 20000).astype(np.int64),
                          "v": rng.integers(0, 100, 20000).astype(np.int64)},
                         sch, None) for _ in range(2)]
    storage = side.ckpt.CheckpointStorage(side.blobs.MemBlobStore(), "g2")
    rt = side.sim.SimRuntime(n_nodes=2)
    handle = side.compute.build_stage_graph(
        _ckpt_stages(side, 2), {"t": parts}, rt, checkpoint_storage=storage,
        **side.kw)
    for a in handle.actors:  # small blocks: many pump steps
        a.block_rows = 128
    handle.start()
    for _ in range(40):
        for s in rt.nodes.values():
            s.step()
    rt.system(1).send(handle.coordinator_id, side.ckpt.TriggerCheckpoint())
    for _ in range(20000):
        progressed = any(s.step() for s in rt.nodes.values())
        if storage.latest_complete() == 1 or not progressed:
            break
    assert storage.latest_complete() == 1
    assert not handle.collector.done  # crashed mid-flight
    saved = []
    for t in handle.tasks:
        st = storage.load_task(1, t.task_id)
        saved.append((st["source_pos"], st["block_rows"],
                      st["in_finished"], len(st["acc"]),
                      {k: len(v) for k, v in st["join_acc"].items()}))
    storage.drop_incomplete()
    out = side.compute.run_stage_graph(
        _ckpt_stages(side, 2), {"t": parts}, side.sim.SimRuntime(n_nodes=2),
        checkpoint_storage=storage,
        restore_checkpoint=storage.latest_complete(), **side.kw)
    merged = {c: np.concatenate([p.columns[c] for p in parts])
              for c in ("k", "v")}
    return saved, out, merged


def test_crash_and_resume_from_checkpoint_matches_reference():
    psaved, pout, merged = _crash_and_resume(PORT)
    rsaved, rout, _ = _crash_and_resume(REF)
    assert psaved == rsaved
    assert any(pos > 0 for pos, *_ in psaved)
    _assert_same(pout, rout)
    ora = _oracle(Program((*CKPT_AGG.steps, SortStep(keys=("k",)))), merged)
    for c in ("k", "total", "n"):
        np.testing.assert_array_equal(pout.cols[c][0], ora.cols[c][0])
