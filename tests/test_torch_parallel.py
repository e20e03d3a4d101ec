"""The port's shard mesh against the JAX package's device mesh, on the CPU.

The six cases of ``tests/test_parallel.py`` (Q1's psum merge, Q6
keyless, the generic all-gather path, no group-by, uneven shards, string
MIN/MAX), each run through ``ydb_tpu_torch.parallel.MeshScan`` on a port
mesh of N logical CPU shards and through the reference's ``MeshScan`` on
N of the 8 virtual CPU devices (``tests/conftest.py``), with the same
row partitioning: ints, dictionary ids and validity exact, floats within
the reference's rtol 1e-9. Plus the streaming ``execute_sources`` fold,
the device ``hash_rows`` and ``repartition`` against the reference's
under its ``shard_map`` (negative keys, nulls, a non-power-of-two shard
count, an undersized bucket and its grown re-exchange), the
``partial_slots`` layout against the reference's, and a small
``kernelbench --shuffle`` run.

As in the other port tests, the reference's unimportable Pallas module is
replaced for each test by a stand-in whose ``enabled()`` is False.
"""

import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdtypes
from ydb_tpu.blocks import DictionarySet as RDicts
from ydb_tpu.blocks.block import TableBlock as RBlock
from ydb_tpu.engine.scan import ColumnSource as RSource
from ydb_tpu.parallel import MeshScan as RMeshScan
from ydb_tpu.parallel import make_mesh as rmake_mesh
from ydb_tpu.parallel import shuffle as rshuffle
from ydb_tpu.parallel.dist import _local as r_local
from ydb_tpu.parallel.dist import _relocal as r_relocal
from ydb_tpu.parallel.dist import stack_blocks as rstack
from ydb_tpu.parallel.mesh import SHARD_AXIS as RSHARD
from ydb_tpu.parallel.mesh import shard_map as rshard_map
from ydb_tpu.ssa import Agg as RAgg
from ydb_tpu.ssa import AggSpec as RAggSpec
from ydb_tpu.ssa import Call as RCall
from ydb_tpu.ssa import Col as RCol
from ydb_tpu.ssa import FilterStep as RFilterStep
from ydb_tpu.ssa import GroupByStep as RGroupByStep
from ydb_tpu.ssa import Op as ROp
from ydb_tpu.ssa import Program as RProgram
from ydb_tpu.ssa import ProjectStep as RProjectStep
from ydb_tpu.ssa import SortStep as RSortStep
from ydb_tpu.ssa import twophase as rtwophase
from ydb_tpu.ssa.compiler import compile_program as r_compile_program
from ydb_tpu.ssa.program import decimal_lit as r_decimal_lit
from ydb_tpu.workload import tpch as rtpch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks import DictionarySet
from ydb_tpu_torch.blocks.block import Column, TableBlock
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.interop import program_from_reference
from ydb_tpu_torch.obs import kernelbench
from ydb_tpu_torch.parallel import MeshScan, make_mesh, shuffle
from ydb_tpu_torch.parallel import mesh as meshlib
from ydb_tpu_torch.ssa import twophase
from ydb_tpu_torch.ssa.compiler import compile_program
from ydb_tpu_torch.workload import tpch


@pytest.fixture(autouse=True)
def reference_scatter_tier(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


@pytest.fixture(scope="module")
def data():
    port = tpch.TpchData(sf=0.002, seed=11)
    ref = rtpch.TpchData(sf=0.002, seed=11)
    for name, col in ref.tables["lineitem"].items():
        np.testing.assert_array_equal(port.tables["lineitem"][name], col)
    return port, ref


def _sources(data, n=None):
    port, ref = data
    li_p, li_r = port.tables["lineitem"], ref.tables["lineitem"]
    if n is not None:
        li_p = {k: v[:n] for k, v in li_p.items()}
        li_r = {k: v[:n] for k, v in li_r.items()}
    return (ColumnSource(li_p, tpch.LINEITEM_SCHEMA, port.dicts),
            RSource(li_r, rtpch.LINEITEM_SCHEMA, ref.dicts))


def _equal(got, want):
    assert got.num_rows == want.num_rows
    # (jax returns a block's columns in sorted order)
    assert sorted(got.cols) == sorted(want.cols)
    for name in want.cols:
        gv, go = (np.asarray(a) for a in got.cols[name])
        wv, wo = (np.asarray(a) for a in want.cols[name])
        np.testing.assert_array_equal(go, wo, err_msg=f"validity {name}")
        if np.issubdtype(wv.dtype, np.floating):
            np.testing.assert_allclose(gv[go], wv[wo], rtol=1e-9,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(gv[go], wv[wo], err_msg=name)


def _both(prog_ref, n_shards, schema_p, schema_r, dicts_p, dicts_r,
          **kw):
    port = MeshScan(program_from_reference(prog_ref), schema_p, dicts_p,
                    mesh=make_mesh(n_shards, devices=["cpu"]), **kw)
    ref = RMeshScan(prog_ref, schema_r, dicts_r, mesh=rmake_mesh(n_shards),
                    **kw)
    return port, ref


def test_q1_mesh_psum_path(data):
    """Q1: dense slot states merged with psum/pmax over 8 shards."""
    port, ref = _both(rtpch.q1_program(), 8, tpch.LINEITEM_SCHEMA,
                      rtpch.LINEITEM_SCHEMA, data[0].dicts, data[1].dicts)
    assert port.partial.group_layout == ref.partial.group_layout
    assert port.partial.group_layout[0] == "dense_slots"
    assert port.merge_path == "psum"
    sp, sr = _sources(data)
    _equal(port.execute(sp), ref.execute(sr))


def test_q6_mesh_keyless_psum(data):
    port, ref = _both(rtpch.q6_program(), 8, tpch.LINEITEM_SCHEMA,
                      rtpch.LINEITEM_SCHEMA, data[0].dicts, data[1].dicts)
    assert port.partial.group_layout[0] == "keyless"
    sp, sr = _sources(data)
    _equal(port.execute(sp), ref.execute(sr))


def _orderkey_totals():
    return RProgram((
        RGroupByStep(
            keys=("l_orderkey",),
            aggs=(
                RAggSpec(RAgg.SUM, "l_extendedprice", "total"),
                RAggSpec(RAgg.COUNT_ALL, None, "n"),
            ),
        ),
        RSortStep(keys=("l_orderkey",)),
    ))


def test_generic_groupby_gather_path(data):
    """High-cardinality keys: compacted partials merged via all_gather."""
    port, ref = _both(_orderkey_totals(), 4, tpch.LINEITEM_SCHEMA,
                      rtpch.LINEITEM_SCHEMA, data[0].dicts, data[1].dicts)
    assert port.partial.group_layout[0] == "compact"
    assert port.merge_path == "gather"
    sp, sr = _sources(data)
    _equal(port.execute(sp), ref.execute(sr))


def test_no_groupby_gather_concat(data):
    prog = RProgram((
        RFilterStep(RCall(ROp.GT, RCol("l_quantity"),
                          r_decimal_lit("49", 2))),
        RProjectStep(("l_orderkey",)),
    ))
    port, ref = _both(prog, 8, tpch.LINEITEM_SCHEMA, rtpch.LINEITEM_SCHEMA,
                      data[0].dicts, data[1].dicts)
    sp, sr = _sources(data)
    got, want = port.execute(sp), ref.execute(sr)
    assert got.num_rows == want.num_rows > 0
    # shard by shard, in shard order, as the reference gathers them
    np.testing.assert_array_equal(got.cols["l_orderkey"][0],
                                  np.asarray(want.cols["l_orderkey"][0]))


def test_run_stacked_equals_execute(data):
    """The stacked entry point (one block a shard along a leading axis,
    ``stack_blocks``) gives ``execute``'s answer."""
    from ydb_tpu_torch.parallel.dist import stack_blocks

    port, _ = _both(rtpch.q6_program(), 4, tpch.LINEITEM_SCHEMA,
                    rtpch.LINEITEM_SCHEMA, data[0].dicts, data[1].dicts)
    sp, _ = _sources(data)
    n = sp.num_rows
    per = -(-n // 4)
    sch = sp.schema.select(port.read_cols)
    blocks = [TableBlock.from_numpy(
        {c: sp.columns[c][i * per:(i + 1) * per] for c in port.read_cols},
        sch, capacity=per, device="cpu") for i in range(4)]
    got = OracleTable.from_block(port.run_stacked(stack_blocks(blocks)))
    _equal(got, port.execute(sp))


def test_uneven_shard_sizes(data):
    """Row count not divisible by mesh size: padding must not leak."""
    port, ref = _both(rtpch.q6_program(), 8, tpch.LINEITEM_SCHEMA,
                      rtpch.LINEITEM_SCHEMA, data[0].dicts, data[1].dicts)
    n = len(data[0].tables["lineitem"]["l_orderkey"]) - 13
    sp, sr = _sources(data, n)
    _equal(port.execute(sp), ref.execute(sr))


def test_string_min_max_across_mesh():
    """Dictionary insertion order != lexicographic order: the cross-shard
    MIN/MAX merge must re-pack ids by rank."""
    values = [b"zebra", b"apple", b"middle", b"banana"]
    rd, td = RDicts(), DictionarySet()
    rids = rd.for_column("s").encode(values)
    tids = td.for_column("s").encode(values)
    np.testing.assert_array_equal(rids, tids)
    prog = RProgram((
        RGroupByStep(keys=("g",), aggs=(
            RAggSpec(RAgg.MIN, "s", "lo"),
            RAggSpec(RAgg.MAX, "s", "hi"),
        )),
    ))
    sr = rdtypes.schema(("s", rdtypes.STRING), ("g", rdtypes.INT64))
    sp = dtypes.schema(("s", dtypes.STRING), ("g", dtypes.INT64))
    cols = {"s": tids, "g": np.zeros(4, dtype=np.int64)}
    # one row per shard: every shard has a different local min
    port, ref = _both(prog, 4, sp, sr, td, rd, key_spaces={"g": 1})
    assert port.partial.group_layout[0] == "dense_slots"
    got = port.execute(ColumnSource(cols, sp, td))
    want = ref.execute(RSource(dict(cols), sr, rd))
    _equal(got, want)
    d = td["s"]
    assert d.values[int(got.cols["lo"][0][0])] == b"apple"
    assert d.values[int(got.cols["hi"][0][0])] == b"zebra"


@pytest.mark.parametrize("prog", ["q1", "orderkey_totals"])
def test_execute_sources_folds_each_shard_stream(data, prog):
    """The streaming driver: each shard folds its block stream into one
    state (pairwise merge for slots, host live prefixes for compact
    layouts), then one merge: equal to the reference's."""
    ref_prog = (rtpch.q1_program() if prog == "q1"
                else _orderkey_totals())
    port, ref = _both(ref_prog, 4, tpch.LINEITEM_SCHEMA,
                      rtpch.LINEITEM_SCHEMA, data[0].dicts, data[1].dicts)
    sp, sr = _sources(data)
    n = sp.num_rows
    cuts = [0, n // 7, n // 2, n // 2 + 5, n]  # uneven shard streams
    parts_p = [ColumnSource({k: v[a:b] for k, v in sp.columns.items()},
                            sp.schema, sp.dicts)
               for a, b in zip(cuts, cuts[1:])]
    parts_r = [RSource({k: v[a:b] for k, v in sr.columns.items()},
                       sr.schema, sr.dicts)
               for a, b in zip(cuts, cuts[1:])]
    _equal(port.execute_sources(parts_p, block_rows=1 << 10),
           ref.execute_sources(parts_r, block_rows=1 << 10))


def test_partial_slots_states_equal_the_reference():
    """``compile_program(..., partial_slots=True)``: the same layout,
    length, validity and live states as the reference's, dead slots
    included."""
    port_data = tpch.TpchData(sf=0.001, seed=4)
    ref_data = rtpch.TpchData(sf=0.001, seed=4)
    partial_r, _ = rtwophase.split(rtpch.q1_program(), with_row_counts=True)
    partial_p, _ = twophase.split(tpch.q1_program(), with_row_counts=True)
    cp = compile_program(partial_p, tpch.LINEITEM_SCHEMA, port_data.dicts,
                         partial_slots=True)
    cr = r_compile_program(partial_r, rtpch.LINEITEM_SCHEMA,
                           ref_data.dicts, partial_slots=True)
    assert cp.group_layout == cr.group_layout
    assert cp.group_layout[0] == "dense_slots"
    assert cp.out_schema.names == cr.out_schema.names
    assert all(f.nullable for f in cp.out_schema.fields)
    li = port_data.tables["lineitem"]
    got = cp(TableBlock.from_numpy(li, tpch.LINEITEM_SCHEMA, device="cpu"))
    want = cr(RBlock.from_numpy(ref_data.tables["lineitem"],
                                rtpch.LINEITEM_SCHEMA))
    assert int(got.length) == int(want.length) == cp.group_layout[1]
    gd, gv = got.host_columns()
    for name in cp.out_schema.names:
        wv = np.asarray(want.columns[name].validity)
        wd = np.asarray(want.columns[name].data)
        np.testing.assert_array_equal(gv[name], wv, err_msg=name)
        if np.issubdtype(wd.dtype, np.floating):
            np.testing.assert_allclose(gd[name][wv], wd[wv], rtol=1e-9)
        else:
            np.testing.assert_array_equal(gd[name][wv], wd[wv],
                                          err_msg=name)


# ---- the shuffle ----


def _key_shards(n_shards, per, seed):
    """Per-shard (k, v) with negative keys and nulls; shard d's v numbers
    its rows from d * per."""
    rng = np.random.default_rng(seed)
    out = []
    for d in range(n_shards):
        k = rng.integers(-(1 << 40), 1 << 40, per).astype(np.int64)
        k[::7] = rng.integers(-3, 3, len(k[::7]))  # repeats across shards
        valid = rng.random(per) > 0.1
        out.append(({"k": k, "v": np.arange(per, dtype=np.int64) + d * per},
                    {"k": valid, "v": np.ones(per, dtype=bool)}))
    return out


def _reference_exchange(shards, n_shards, per, B):
    sch = rdtypes.schema(("k", rdtypes.INT64), ("v", rdtypes.INT64))
    mesh = rmake_mesh(n_shards)
    blocks = [RBlock.from_numpy(c, sch, v, capacity=per) for c, v in shards]
    st = jax.device_put(rstack(blocks), NamedSharding(mesh, P(RSHARD)))

    def go(s):
        blk, worst = rshuffle.repartition(r_local(s), ["k"], n_shards,
                                          bucket_rows=B, with_counts=True)
        return r_relocal(blk), worst

    out, worst = jax.jit(rshard_map(
        go, mesh=mesh, in_specs=P(RSHARD), out_specs=(P(RSHARD), P()),
        check_vma=False))(st)
    lens = np.asarray(out.length)
    rows = []
    for i in range(n_shards):
        rows.append({n: (np.asarray(c.data)[i][:lens[i]],
                         np.asarray(c.validity)[i][:lens[i]])
                     for n, c in out.columns.items()})
    return rows, int(np.asarray(worst))


def _port_exchange(shards, n_shards, per, B):
    sch = dtypes.schema(("k", dtypes.INT64), ("v", dtypes.INT64))
    mesh = make_mesh(n_shards, devices=["cpu"])
    blocks = [TableBlock.from_numpy(c, sch, v, capacity=per, device="cpu")
              for c, v in shards]
    out, worst = shuffle.repartition(mesh, blocks, ["k"], bucket_rows=B,
                                     with_counts=True)
    rows = []
    for blk in out:
        data, valid = blk.host_columns()
        n = int(blk.length)
        rows.append({c: (data[c][:n], valid[c][:n]) for c in data})
    return rows, int(worst)


def test_device_hash_rows_is_the_reference_hash():
    from ydb_tpu.blocks.block import Column as RColumn
    from ydb_tpu_torch import native

    rng = np.random.default_rng(5)
    k1 = rng.integers(-(1 << 63), (1 << 63) - 1, 4096, dtype=np.int64)
    k2 = rng.integers(-4, 4, 4096).astype(np.int32)
    v1, v2 = rng.random(4096) < 0.8, rng.random(4096) < 0.5
    want = np.asarray(rshuffle.hash_rows(
        [RColumn(jax.numpy.asarray(k1), jax.numpy.asarray(v1)),
         RColumn(jax.numpy.asarray(k2), jax.numpy.asarray(v2))]))
    got = shuffle.hash_rows(
        [Column(torch.from_numpy(k1), torch.from_numpy(v1)),
         Column(torch.from_numpy(k2), torch.from_numpy(v2))])
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(
        native.hash_rows([k1, k2.astype(np.int64)], [v1, v2]), want)
    for n in (3, 6, 8):  # the unsigned modulus, top bit set or not
        np.testing.assert_array_equal(
            shuffle.dest_shard(got, n).numpy(),
            (want % np.uint64(n)).astype(np.int32))


@pytest.mark.parametrize("n_shards,B", [(6, None), (4, 64)])
def test_repartition_equals_the_reference(n_shards, B):
    """Row for row per shard, validity included, and the worst count; an
    undersized bucket (B=64) overflows, and the exchange grown to the
    worst count is lossless on both sides."""
    per = 300
    shards = _key_shards(n_shards, per, seed=n_shards)
    B = per if B is None else B
    got, worst = _port_exchange(shards, n_shards, per, B)
    want, rworst = _reference_exchange(shards, n_shards, per, B)
    assert worst == rworst
    if worst > B:
        B = worst
        got, _ = _port_exchange(shards, n_shards, per, B)
        want, _ = _reference_exchange(shards, n_shards, per, B)
    assert sum(len(r["v"][0]) for r in got) == n_shards * per
    for g, w in zip(got, want):
        for c in ("k", "v"):
            np.testing.assert_array_equal(g[c][1], w[c][1])
            np.testing.assert_array_equal(g[c][0][g[c][1]],
                                          w[c][0][w[c][1]])


def test_collectives_on_one_device():
    mesh = make_mesh(3, devices=["cpu"])
    xs = [torch.tensor([i, -i, 2 * i]) for i in range(3)]
    assert meshlib.psum(mesh, xs)[2].tolist() == [3, -3, 6]
    assert meshlib.pmin(mesh, xs)[0].tolist() == [0, -2, 0]
    assert meshlib.pmax(mesh, [x > 1 for x in xs])[1].tolist() == \
        [True, False, True]
    assert meshlib.all_gather(mesh, xs)[1].shape == (3, 3)
    sent = [torch.arange(6).reshape(3, 2) + 10 * j for j in range(3)]
    got = meshlib.all_to_all(mesh, sent)
    # bucket i of shard j lands on shard i, in shard order j
    assert got[1].tolist() == [[2, 3], [12, 13], [22, 23]]


def test_kernelbench_shuffle_smoke():
    out = kernelbench.bench_shuffle(
        8192, 1, with_skew=True, device="cpu",
        keys=np.random.default_rng(2).zipf(1.3, 6000) % 500, n_shards=4)
    assert out["identical"] and out["capacity_ratio"] >= 4
    assert out["keyed"]["identical"] and out["keyed"]["shards"] == 4
    assert out["skew"]["grows"] >= 1 and out["skew"]["identical"]
