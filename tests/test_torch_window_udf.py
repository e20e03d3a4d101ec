"""Window steps and UDF calls in the port's compiler
(``ydb_tpu_torch/ssa/compiler.py``) against the JAX package.

* ``WindowStep`` (rank / dense_rank / row_number): the case of
  ``tests/test_ssa.py::test_window_rank_functions_match_oracle`` — a
  filter ahead of the window, ties in the order keys — through the
  reference compiler, the port's compiler and the port's numpy oracle,
  plus string partition and order keys (dictionary ranks).
* ``UdfCall``: scalar UDFs registered in ``Catalog.udfs``, in the select
  list, in WHERE and inside an aggregate, planned and executed by the
  port and by the reference's planner and walk.

Integers and validity must match bit for bit; float64 at rtol 1e-12.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdt
from ydb_tpu.blocks.block import TableBlock as RBlock
from ydb_tpu.engine.scan import ColumnSource as RSource
from ydb_tpu.plan import Database as RDatabase
from ydb_tpu.plan import execute_plan as rexecute
from ydb_tpu.plan import to_host as rto_host
from ydb_tpu.sql.parser import parse as rparse
from ydb_tpu.sql.planner import Catalog as RCatalog
from ydb_tpu.sql.planner import plan_select_full as rplan
from ydb_tpu.ssa import ops as rops
from ydb_tpu.ssa import program as rprog
from ydb_tpu.ssa.compiler import compile_program as rcompile

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch import interop
from ydb_tpu_torch.blocks.block import TableBlock as TBlock
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.engine.oracle import OracleTable, run_oracle
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.plan import Database, execute_plan, to_host
from ydb_tpu_torch.sql.parser import parse
from ydb_tpu_torch.sql.planner import Catalog, PlanError, plan_select_full
from ydb_tpu_torch.ssa.compiler import compile_program
from ydb_tpu_torch.ssa.ops import Op
from ydb_tpu_torch.ssa.program import (
    Call,
    Col,
    FilterStep,
    Program,
    WindowStep,
    lit,
)

REF_CLASSES = interop.classes_of(rprog, rops, rdt)


@pytest.fixture(autouse=True)
def reference_walk(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)
    from ydb_tpu.ssa import plan_fuse

    monkeypatch.setattr(plan_fuse, "FUSE_FORCE", False)


# ---------------- window steps ----------------


def _window_case(strings: bool):
    """(program, schema, arrays, dictionary values): the test_ssa.py
    window case; with ``strings`` the partition and one order key are
    dictionary-encoded strings whose ids are NOT in value order."""
    rng = np.random.default_rng(3)
    n = 4000
    g = rng.integers(0, 11, n).astype(np.int64)
    v = rng.integers(0, 25, n).astype(np.int64)  # many ties
    k = rng.permutation(n).astype(np.int64)
    fields = [("g", tdt.INT64), ("v", tdt.INT64), ("k", tdt.INT64)]
    arrays = {"g": g, "v": v, "k": k}
    dict_values = {}
    if strings:
        words = [b"pear", b"apple", b"fig", b"kiwi", b"date", b"plum"]
        fields += [("s", tdt.STRING), ("t", tdt.STRING)]
        arrays["s"] = rng.integers(0, len(words), n).astype(np.int32)
        arrays["t"] = rng.integers(0, len(words), n).astype(np.int32)
        dict_values = {"s": words, "t": words[::-1]}
        part, order = ("s",), ("t", "v")
    else:
        part, order = ("g",), ("v",)
    sch = tdt.schema(*((nm, t, False) for nm, t in fields))
    prog = Program((
        FilterStep(Call(Op.GT, Col("v"), lit(2))),
        WindowStep("rank", part, order, (True,) * len(order), "rnk"),
        WindowStep("dense_rank", part, order, (True,) * len(order), "dr"),
        WindowStep("row_number", part, order + ("k",),
                   (True,) * len(order) + (False,), "rn"),
    ))
    return prog, sch, arrays, dict_values


@pytest.mark.parametrize("strings", [False, True], ids=["ints", "strings"])
def test_window_rank_functions_match_reference_and_oracle(strings):
    prog, sch, arrays, dict_values = _window_case(strings)
    dicts = DictionarySet()
    for col, values in dict_values.items():
        for val in values:
            dicts.for_column(col).add(val)
    n = len(arrays["k"])

    cp = compile_program(prog, sch, dicts if dict_values else None)
    blk = TBlock.from_numpy(arrays, sch, device="cpu")
    got = cp(blk).host_columns(validity=False)[0]

    from ydb_tpu.blocks.dictionary import DictionarySet as RDicts

    rdicts = RDicts()
    for col, values in dict_values.items():
        for val in values:
            rdicts.for_column(col).add(val)
    rsch = interop.convert(sch, REF_CLASSES)
    rcp = rcompile(interop.convert(prog, REF_CLASSES), rsch,
                   rdicts if dict_values else None, None)
    rout = jax.jit(rcp.run)(RBlock.from_numpy(arrays, rsch),
                            {kk: jnp.asarray(vv) for kk, vv in rcp.aux.items()})
    want = rout.to_numpy()

    table = OracleTable({c: (a, np.ones(n, bool)) for c, a in arrays.items()},
                        sch)
    ora = run_oracle(prog, table, dicts if dict_values else None)
    assert cp.out_schema == interop.program_from_reference(rcp.out_schema)
    assert len(got["k"]) == len(want["k"]) == ora.num_rows
    # row order is the filter's (stable compaction) in both packages
    for name in ("k", "rnk", "dr", "rn"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the oracle orders rows differently: align by the unique key k
    go = np.argsort(got["k"])
    oo = np.argsort(np.asarray(ora.cols["k"][0]))
    for name in ("rnk", "dr", "rn"):
        np.testing.assert_array_equal(
            got[name][go], np.asarray(ora.cols[name][0])[oo], err_msg=name)


def test_window_on_device_rejects_unknown_function():
    prog, sch, arrays, _ = _window_case(False)
    bad = Program(prog.steps[:1] + (
        WindowStep("ntile", ("g",), ("v",), (False,), "x"),))
    with pytest.raises(Exception, match="ntile"):
        compile_program(bad, sch)


# ---------------- UDF calls ----------------


def _mix(a, b):
    return (a * 1000003 + b) % 97


def _halve(a):
    return a.astype(np.float64) / 2.0


def _udf_tables(seed=7, n=3000):
    rng = np.random.default_rng(seed)
    k = np.arange(1, n + 1, dtype=np.int64)
    v = rng.integers(-500, 500, n).astype(np.int64)
    g = rng.integers(0, 9, n).astype(np.int64)
    valid = {"v": rng.random(n) > 0.1}  # NULLs in v
    return {"k": k, "v": v, "g": g}, valid


def _port_db(arrays, valid):
    sch = tdt.schema(("k", tdt.INT64, False), ("v", tdt.INT64, True),
                     ("g", tdt.INT64, False))
    db = Database(sources={"kv": ColumnSource(arrays, sch, None, valid)},
                  device="cpu")
    catalog = Catalog(schemas={"kv": sch}, primary_keys={"kv": ("k",)},
                      udfs={"mix": (_mix, tdt.INT64),
                            "halve": (_halve, tdt.DOUBLE)})
    return db, catalog


def _ref_db(arrays, valid):
    sch = rdt.schema(("k", rdt.INT64, False), ("v", rdt.INT64, True),
                     ("g", rdt.INT64, False))
    db = RDatabase(sources={"kv": RSource(arrays, sch, None, valid)})
    catalog = RCatalog(schemas={"kv": sch}, primary_keys={"kv": ("k",)},
                       udfs={"mix": (_mix, rdt.INT64),
                             "halve": (_halve, rdt.DOUBLE)})
    return db, catalog


UDF_SQL = {
    "select": "select k, mix(k, v) as m, halve(v) as h from kv order by k",
    "where": "select k, v from kv where halve(v) > 9.0 order by k",
    "aggregate": "select g, sum(mix(k, v)) as t, count(*) as c from kv"
                 " group by g order by g",
    "keyless_aggregate": "select sum(mix(k, v)) as t, max(halve(v)) as h"
                         " from kv",
}


@pytest.mark.parametrize("case", sorted(UDF_SQL))
def test_udf_matches_reference(case):
    arrays, valid = _udf_tables()
    db, catalog = _port_db(arrays, valid)
    rdb, rcatalog = _ref_db(arrays, valid)
    sql = UDF_SQL[case]
    got = to_host(execute_plan(plan_select_full(parse(sql), catalog).plan,
                               db))
    want = rto_host(rexecute(rplan(rparse(sql), rcatalog).plan, rdb,
                             use_dq=False))
    assert list(got.schema.names) == list(want.schema.names)
    assert got.num_rows == want.num_rows > 0
    for name in want.schema.names:
        gv, go = got.cols[name]
        wv, wo = (np.asarray(x) for x in want.cols[name])
        np.testing.assert_array_equal(go, wo, err_msg=f"validity {name}")
        assert gv.dtype == wv.dtype, name
        if np.issubdtype(wv.dtype, np.floating):
            np.testing.assert_allclose(gv[wo], wv[wo], rtol=1e-12)
        else:
            np.testing.assert_array_equal(gv[wo], wv[wo], err_msg=name)
    if case == "select":
        m, ok = got.cols["m"]
        # NULL in v makes mix(k, v) NULL; the rest equal the function
        np.testing.assert_array_equal(ok, valid["v"])
        np.testing.assert_array_equal(
            m[ok], _mix(arrays["k"], arrays["v"])[valid["v"]])


def test_unknown_udf_still_errors():
    arrays, valid = _udf_tables()
    _, catalog = _port_db(arrays, valid)
    with pytest.raises(PlanError, match="unknown function"):
        plan_select_full(parse("select nosuch(k) from kv"), catalog)
