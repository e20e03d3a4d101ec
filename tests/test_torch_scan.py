"""The ported scan path end to end against the JAX package: TPC-H Q1/Q6
and ClickBench q33/q36 through both ``ScanExecutor``s, the workload
generators, the entry point, and the port's import isolation.

Tolerances: integers, dictionary ids, lengths and validity bit-exact;
float64 outputs rtol 1e-12. As in test_torch_parity.py, the reference's
unimportable Pallas module is replaced for each test by a stand-in whose
``enabled()`` is False, so the reference's group-by tier above 512
groups takes its XLA scatter path.
"""

import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdt
from ydb_tpu.engine.scan import ColumnSource as RSource
from ydb_tpu.engine.scan import ScanExecutor as RExec
from ydb_tpu.ssa import kernels as rk
from ydb_tpu.ssa import ops as rops
from ydb_tpu.ssa import program as rprog
from ydb_tpu.workload import clickbench as rcb
from ydb_tpu.workload import tpch as rtpch

from ydb_tpu_torch import interop
from ydb_tpu_torch.engine.oracle import OracleTable, run_oracle
from ydb_tpu_torch.engine.scan import ColumnSource as TSource
from ydb_tpu_torch.engine.scan import ScanExecutor as TExec
from ydb_tpu_torch.ssa import cuda_kernels as ck
from ydb_tpu_torch.ssa import kernels as tk
from ydb_tpu_torch.workload import clickbench as tcb
from ydb_tpu_torch.workload import tpch as ttpch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CLASSES = interop.classes_of(rprog, rops, rdt)


@pytest.fixture(autouse=True)
def reference_scatter_tier(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)


@pytest.fixture(scope="module")
def tpch_pair():
    return rtpch.TpchData(sf=0.01, seed=42), ttpch.TpchData(sf=0.01, seed=42)


@pytest.fixture(scope="module")
def hits_pair():
    ref = rcb.ClickBenchData(rows=20_000, seed=42)
    return ref, tcb.ClickBenchData(rows=20_000, seed=42), \
        rcb.reference_answers(ref)


def assert_tables_equal(port: OracleTable, ref, what=""):
    """Same columns, rows, validity (bit-exact) and values: ints exact,
    float64 rtol 1e-12."""
    assert set(port.cols) == set(ref.cols), what
    assert port.num_rows == ref.num_rows, what
    for name, (rv, ro) in ref.cols.items():
        pv, po = port.cols[name]
        rv, ro = np.asarray(rv), np.asarray(ro)
        np.testing.assert_array_equal(po, ro, err_msg=f"{what} validity {name}")
        assert pv.dtype == rv.dtype, (what, name, pv.dtype, rv.dtype)
        if np.issubdtype(rv.dtype, np.floating):
            np.testing.assert_allclose(pv[ro], rv[ro], rtol=1e-12,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(pv[ro], rv[ro],
                                          err_msg=f"{what} {name}")


# ---------------- generators ----------------


def test_tpch_generator_matches_reference(tpch_pair):
    ref, port = tpch_pair
    assert ref.tables.keys() == port.tables.keys()
    assert len(port.tables) == 8
    for table in ref.tables:
        assert ref.tables[table].keys() == port.tables[table].keys()
        assert interop.program_from_reference(ref.schema(table)) == \
            port.schema(table)
        for k, v in ref.tables[table].items():
            assert port.tables[table][k].dtype == v.dtype, k
            np.testing.assert_array_equal(port.tables[table][k], v, err_msg=k)
    for col in port.dicts.columns():
        assert port.dicts[col].values == ref.dicts[col].values, col
    assert interop.program_from_reference(rtpch.LINEITEM_SCHEMA) == \
        ttpch.LINEITEM_SCHEMA
    assert interop.program_from_reference(rtpch.q1_program()) == \
        ttpch.q1_program()
    assert interop.program_from_reference(rtpch.q6_program()) == \
        ttpch.q6_program()
    assert ttpch.PRIMARY_KEYS == rtpch.PRIMARY_KEYS


def test_clickbench_generator_matches_reference(hits_pair):
    ref, port, _ = hits_pair
    for k, v in ref.hits.items():
        assert port.hits[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port.hits[k], v, err_msg=k)
    for col in ("URL", "SearchPhrase", "Title", "Referer", "MobilePhoneModel"):
        assert port.dicts[col].values == ref.dicts[col].values, col
    assert interop.program_from_reference(rcb.HITS_SCHEMA) == tcb.HITS_SCHEMA


def test_q33_q36_answers_match_reference_answers(hits_pair):
    _, port, want = hits_pair
    got = tcb.q33_q36_answers(port)
    assert got["q33"] == want["q33"]
    assert got["q36"] == want["q36"]


# ---------------- TPC-H Q1 / Q6 ----------------


@pytest.mark.parametrize("block_rows", [1024, 8192, 1 << 16])
@pytest.mark.parametrize("query", ["q1", "q6"])
def test_tpch_scan_matches_reference(tpch_pair, query, block_rows):
    ref, port = tpch_pair
    rp = getattr(rtpch, f"{query}_program")()
    tp = getattr(ttpch, f"{query}_program")()
    rex = RExec(rp, RSource(ref.tables["lineitem"], rtpch.LINEITEM_SCHEMA,
                            ref.dicts), block_rows=block_rows)
    tex = TExec(tp, TSource(port.tables["lineitem"], ttpch.LINEITEM_SCHEMA,
                            port.dicts), block_rows=block_rows, device="cpu")
    assert tex.partial.group_layout == rex.partial.group_layout
    assert tex.out_schema == interop.program_from_reference(rex.out_schema)
    got = tex.execute()
    assert_tables_equal(got, rex.execute(), f"{query}@{block_rows}")
    # and the port's own numpy oracle agrees
    table = OracleTable({n: (v, np.ones(len(v), bool))
                         for n, v in port.tables["lineitem"].items()},
                        ttpch.LINEITEM_SCHEMA)
    assert_tables_equal(got, run_oracle(tp, table, port.dicts), query)


# ---------------- ClickBench q33 / q36 (the CUDA kernels' tier) ----------------


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "peragg"])
@pytest.mark.parametrize("query", ["q33", "q36"])
def test_clickbench_url_groupby_matches_reference(hits_pair, query, fused,
                                                  monkeypatch):
    ref, port, want = hits_pair
    monkeypatch.setattr(rk, "FUSED_FORCE", fused)
    monkeypatch.setattr(tk, "FUSED_FORCE", fused)
    calls = {"grouped_sum": 0, "grouped_sum_multi": 0}
    for name in calls:  # count the kernel-tier calls (plain on CPU)
        real = getattr(ck, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(ck, name, spy)
    tp = getattr(tcb, f"{query}_program")()
    rp = interop.convert(tp, REF_CLASSES)
    rex = RExec(rp, RSource(ref.hits, rcb.HITS_SCHEMA, ref.dicts),
                block_rows=4096)
    tex = TExec(tp, TSource(port.hits, tcb.HITS_SCHEMA, port.dicts),
                block_rows=4096, device="cpu")
    ng = len(port.dicts["URL"]) + 1
    assert ng > tk.ONEHOT_GROUP_LIMIT
    assert tex.partial.group_layout == rex.partial.group_layout == ("dense", ng)
    got = tex.execute()
    assert_tables_equal(got, rex.execute(), f"{query} fused={fused}")
    count = "c" if query == "q33" else "pv"
    pairs = list(zip(port.dicts["URL"].decode(got.cols["URL"][0]),
                     (int(c) for c in got.cols[count][0])))
    assert pairs == want[query]
    kernel = "grouped_sum_multi" if fused else "grouped_sum"
    assert calls[kernel] > 0 and sum(calls.values()) == calls[kernel]


# ---------------- entry point and imports ----------------


def test_entry_matches_reference_entry():
    import __graft_entry__

    from ydb_tpu_torch.entry import entry

    rfn, (rblk, raux) = __graft_entry__.entry()
    tfn, (tblk, taux) = entry(device="cpu")
    r, t = rfn(rblk, raux), tfn(tblk, taux)
    assert int(t.length) == int(r.length)
    rd, rv = r.host_columns()
    td, tv = t.host_columns()
    assert sorted(td) == sorted(rd)
    for k in rd:
        np.testing.assert_array_equal(tv[k], rv[k], err_msg=k)
        if np.issubdtype(rd[k].dtype, np.floating):
            np.testing.assert_allclose(td[k][rv[k]], rd[k][rv[k]], rtol=1e-12)
        else:
            np.testing.assert_array_equal(td[k][rv[k]], rd[k][rv[k]])


#: the SQL path's modules, each of which the import check must reach
SQL_PATH_MODULES = (
    "ydb_tpu_torch.sql", "ydb_tpu_torch.sql.ast", "ydb_tpu_torch.sql.parser",
    "ydb_tpu_torch.sql.planner", "ydb_tpu_torch.plan",
    "ydb_tpu_torch.plan.nodes", "ydb_tpu_torch.plan.executor",
    "ydb_tpu_torch.ssa.join", "ydb_tpu_torch.workload.queries",
)
#: the DQ path's modules, likewise
DQ_PATH_MODULES = (
    "ydb_tpu_torch.runtime", "ydb_tpu_torch.runtime.actors",
    "ydb_tpu_torch.runtime.test_runtime", "ydb_tpu_torch.runtime.interconnect",
    "ydb_tpu_torch.chaos", "ydb_tpu_torch.chaos.deadline",
    "ydb_tpu_torch.engine.blobs", "ydb_tpu_torch.dq", "ydb_tpu_torch.dq.graph",
    "ydb_tpu_torch.dq.spilling", "ydb_tpu_torch.dq.checkpoint",
    "ydb_tpu_torch.dq.compute", "ydb_tpu_torch.native", "ydb_tpu_torch.kqp",
    "ydb_tpu_torch.kqp.dq_lower",
)
#: the fused path's modules, likewise
FUSION_PATH_MODULES = (
    "ydb_tpu_torch.ssa.plan_fuse", "ydb_tpu_torch.ssa.cuda_kernels",
    "ydb_tpu_torch.workload.clickbench",
)
#: the ColumnShard storage path's modules and TPC-DS, likewise
STORAGE_PATH_MODULES = (
    "ydb_tpu_torch.workload.tpcds", "ydb_tpu_torch.workload.runner",
    "ydb_tpu_torch.chaos.retry", "ydb_tpu_torch.stats",
    "ydb_tpu_torch.stats.sketch", "ydb_tpu_torch.stats.zonemap",
    "ydb_tpu_torch.stats.cost", "ydb_tpu_torch.stats.aggregator",
    "ydb_tpu_torch.engine.portion", "ydb_tpu_torch.runtime.conveyor",
    "ydb_tpu_torch.obs", "ydb_tpu_torch.obs.probes",
    "ydb_tpu_torch.engine.blockcache", "ydb_tpu_torch.engine.resident",
    "ydb_tpu_torch.engine.staging", "ydb_tpu_torch.engine.reader",
    "ydb_tpu_torch.engine.stream_sched", "ydb_tpu_torch.engine.shard",
)
#: the session and serving plane's modules, likewise
SERVING_PATH_MODULES = (
    "ydb_tpu_torch.config", "ydb_tpu_torch.obs.counters",
    "ydb_tpu_torch.obs.tracing", "ydb_tpu_torch.obs.metering",
    "ydb_tpu_torch.obs.profile", "ydb_tpu_torch.tablet",
    "ydb_tpu_torch.tablet.localdb", "ydb_tpu_torch.tablet.executor",
    "ydb_tpu_torch.scheme", "ydb_tpu_torch.scheme.model",
    "ydb_tpu_torch.scheme.shard", "ydb_tpu_torch.tx",
    "ydb_tpu_torch.tx.coordinator", "ydb_tpu_torch.tx.sharded",
    "ydb_tpu_torch.engine.scanshare", "ydb_tpu_torch.kqp",
    "ydb_tpu_torch.kqp.rm", "ydb_tpu_torch.kqp.batch",
    "ydb_tpu_torch.kqp.session", "ydb_tpu_torch.serving",
    "ydb_tpu_torch.serving.tenants", "ydb_tpu_torch.serving.admission",
    "ydb_tpu_torch.api", "ydb_tpu_torch.api.pgwire",
)
#: the sanitizers and analyzers (ROADMAP.md queue A item 6)
ANALYSIS_MODULES = (
    "ydb_tpu_torch.analysis", "ydb_tpu_torch.analysis.suppress",
    "ydb_tpu_torch.analysis.paths", "ydb_tpu_torch.analysis.sanitizer",
    "ydb_tpu_torch.analysis.leaksan", "ydb_tpu_torch.analysis.syncsan",
    "ydb_tpu_torch.analysis.memsan", "ydb_tpu_torch.analysis.lint",
    "ydb_tpu_torch.analysis.concurrency",
    "ydb_tpu_torch.analysis.lifecycle", "ydb_tpu_torch.analysis.hotpath",
    "ydb_tpu_torch.analysis.devmem", "ydb_tpu_torch.analysis.__main__",
)
#: the row store and interactive transactions (ROADMAP.md queue A item 8)
ROW_STORE_MODULES = (
    "ydb_tpu_torch.datashard", "ydb_tpu_torch.datashard.shard",
    "ydb_tpu_torch.datashard.read_iterator",
    "ydb_tpu_torch.datashard.pipeline", "ydb_tpu_torch.datashard.table",
    "ydb_tpu_torch.tx.mediator",
)
#: sys views, the viewer, the load service, Kesus and sequences, the
#: quoter, backup and the session pool (ROADMAP.md queue A items 9-10)
MONITORING_MODULES = (
    "ydb_tpu_torch.obs.sysview", "ydb_tpu_torch.obs.viewer",
    "ydb_tpu_torch.obs.viewer_html", "ydb_tpu_torch.obs.loadtest",
    "ydb_tpu_torch.tablet.kesus", "ydb_tpu_torch.runtime.quoter",
    "ydb_tpu_torch.engine.backup", "ydb_tpu_torch.kqp.proxy",
)
#: the gRPC front, less cli.py (ROADMAP.md queue A item 10)
GRPC_MODULES = (
    "ydb_tpu_torch.api.build", "ydb_tpu_torch.api._gen",
    "ydb_tpu_torch.api._gen.ydb_tpu_api_pb2", "ydb_tpu_torch.api.arrow_io",
    "ydb_tpu_torch.api.server", "ydb_tpu_torch.api.client",
    "ydb_tpu_torch.blocks.arrow_bridge", "ydb_tpu_torch.runtime.console",
)
#: streaming: topics, changefeeds' replication, the streaming query, the
#: Kafka and SQS fronts and the CLI (ROADMAP.md queue A item 11)
STREAMING_MODULES = (
    "ydb_tpu_torch.common", "ydb_tpu_torch.topic", "ydb_tpu_torch.topic.pq",
    "ydb_tpu_torch.topic.topic", "ydb_tpu_torch.replication",
    "ydb_tpu_torch.fq", "ydb_tpu_torch.fq.service",
    "ydb_tpu_torch.api.kafka", "ydb_tpu_torch.api.sqs", "ydb_tpu_torch.cli",
)

#: blob storage and the failpoint registry (ROADMAP.md queue A item 12a)
BLOBSTORAGE_MODULES = (
    "ydb_tpu_torch.blobstorage", "ydb_tpu_torch.blobstorage.erasure",
    "ydb_tpu_torch.blobstorage.group", "ydb_tpu_torch.blobstorage.proxy_store",
    "ydb_tpu_torch.blobstorage.pdisk", "ydb_tpu_torch.blobstorage.vdisk_lsm",
    "ydb_tpu_torch.blobstorage.controller",
    "ydb_tpu_torch.blobstorage.blob_depot", "ydb_tpu_torch.runtime.failpoints",
)

CLUSTER_PLANE_MODULES = (
    "ydb_tpu_torch.tablet.statestorage", "ydb_tpu_torch.tablet.hive",
    "ydb_tpu_torch.tablet.pipe", "ydb_tpu_torch.tablet.keyvalue",
    "ydb_tpu_torch.scheme.board", "ydb_tpu_torch.scheme.shard",
    "ydb_tpu_torch.runtime.pools", "ydb_tpu_torch.runtime.interconnect",
    "ydb_tpu_torch.runtime.nodebroker",
)

#: DQ across processes, the native host library and the shard mesh
#: (ROADMAP.md queue A items 13a and 13b's substrate)
WIRE_MESH_MODULES = (
    "ydb_tpu_torch.dq.node_service", "ydb_tpu_torch.native",
    "ydb_tpu_torch.native.build", "ydb_tpu_torch.parallel",
    "ydb_tpu_torch.parallel.mesh", "ydb_tpu_torch.parallel.dist",
    "ydb_tpu_torch.parallel.shuffle",
)


def test_port_imports_no_jax_and_nothing_of_ydb_tpu():
    """Every module of ydb_tpu_torch, and chip_smoke.py, imports with jax
    made unimportable, and leaves no ydb_tpu module behind."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import ydb_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            ydb_tpu_torch.__path__, "ydb_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "ydb_tpu" or m.startswith("ydb_tpu.")
                     or m == "jax" and sys.modules[m] is not None)
        assert not bad, bad
        missing = sorted(set(%r) - set(names))
        assert not missing, missing
        print(len(names))
    """ % (SQL_PATH_MODULES + DQ_PATH_MODULES + FUSION_PATH_MODULES
           + STORAGE_PATH_MODULES + SERVING_PATH_MODULES
           + ANALYSIS_MODULES + ROW_STORE_MODULES + MONITORING_MODULES
           + GRPC_MODULES + STREAMING_MODULES + BLOBSTORAGE_MODULES
           + CLUSTER_PLANE_MODULES + WIRE_MESH_MODULES,))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= (15 + len(SQL_PATH_MODULES)
                                           + len(DQ_PATH_MODULES) + 1
                                           + len(STORAGE_PATH_MODULES)
                                           + len(SERVING_PATH_MODULES)
                                           + len(ANALYSIS_MODULES)
                                           + len(ROW_STORE_MODULES))
