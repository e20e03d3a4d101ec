"""Parity of the torch port (``ydb_tpu_torch``) with the JAX package, module
by module: blocks, kernel primitives, the CUDA kernels' plain versions,
the program compiler and the interop helpers.

Each test feeds the same seeded numpy inputs through the JAX function (on
the CPU) and its port (``device="cpu"``). Tolerances: integers,
dictionary ids, lengths and validity are compared bit-exactly; float64
outputs with rtol 1e-12; float32 group sums with rtol 1e-5, because the
two packages add in a different order.

The reference's Pallas module cannot be imported with the installed jax
(``pallas_kernels.py:31`` imports ``jax.experimental.enable_x64``), and
its group-by tier imports it before asking ``enabled()``. The autouse
fixture puts a stand-in whose ``enabled()`` is False in its place for
the length of each test, so the reference takes its XLA scatter tier —
the plain reference for both CUDA kernels.
"""

import dataclasses
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ydb_tpu.ssa
from ydb_tpu import dtypes as rdt
from ydb_tpu.blocks import block as rblock
from ydb_tpu.blocks.dictionary import DictionarySet as RDicts
from ydb_tpu.ssa import kernels as rk
from ydb_tpu.ssa import ops as rops
from ydb_tpu.ssa import program as rprog
from ydb_tpu.ssa.compiler import compile_program as rcompile

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch import interop
from ydb_tpu_torch.blocks import block as tblock
from ydb_tpu_torch.blocks.dictionary import DictionarySet as TDicts
from ydb_tpu_torch.ssa import cuda_kernels as ck
from ydb_tpu_torch.ssa import kernels as tk
from ydb_tpu_torch.ssa.compiler import compile_program as tcompile

REF_CLASSES = interop.classes_of(rprog, rops, rdt)
CPU = "cpu"


@pytest.fixture(autouse=True)
def reference_scatter_tier(monkeypatch):
    stub = types.ModuleType("ydb_tpu.ssa.pallas_kernels")
    stub.FORCE = None
    stub.enabled = lambda: False
    monkeypatch.setitem(sys.modules, "ydb_tpu.ssa.pallas_kernels", stub)
    monkeypatch.delattr(ydb_tpu.ssa, "pallas_kernels", raising=False)
    return stub


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(got, want, rtol=None, what=""):
    """Bit-exact for ints/bools; rtol for floats (1e-12 unless given)."""
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if np.issubdtype(got.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol or 1e-12,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def both_cols(data, valid):
    return (rblock.Column(jnp.asarray(data), jnp.asarray(valid)),
            tblock.Column(torch.from_numpy(np.array(data)),
                          torch.from_numpy(np.array(valid))))


def rng_i64(rng, n, lo=-10**6, hi=10**6):
    v = rng.integers(lo, hi, n, dtype=np.int64)
    v[: n // 50] = np.iinfo(np.int64).max
    v[n // 50: n // 25] = np.iinfo(np.int64).min
    rng.shuffle(v)
    return v


# ---------------- blocks ----------------


@pytest.mark.parametrize("n", [1, 1000, 1024, 3000])
def test_block_host_columns_round_trip(n):
    rng = np.random.default_rng(n)
    sch_spec = (("a", rdt.INT32), ("b", rdt.DOUBLE), ("d", rdt.decimal(2)),
                ("s", rdt.STRING), ("t", rdt.DATE), ("f", rdt.BOOL))
    arrays = {
        "a": rng.integers(-5, 5, n).astype(np.int32),
        "b": rng.random(n),
        "d": rng_i64(rng, n),
        "s": rng.integers(0, 9, n).astype(np.int32),
        "t": rng.integers(-1000, 20000, n).astype(np.int32),
        "f": rng.random(n) < 0.5,
    }
    validity = {"a": rng.random(n) < 0.8, "d": rng.random(n) < 0.5}
    rsch = rdt.schema(*sch_spec)
    ref = rblock.TableBlock.from_numpy(arrays, rsch, validity)
    port = tblock.TableBlock.from_numpy(
        arrays, interop.program_from_reference(rsch), validity, device=CPU)
    assert port.capacity == ref.capacity  # same 1024-row quantum
    assert port.length.dtype == torch.int32 and port.length.ndim == 0
    rd, rv = ref.host_columns()
    pd, pv = port.host_columns()
    assert rd.keys() == pd.keys()
    for k in rd:
        assert_same(pd[k], rd[k], what=k)
        assert_same(pv[k], rv[k], what=k)
    # tail-only padding: padding rows are never valid
    for c in port.columns.values():
        assert not c.validity[n:].any()


def test_block_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    sch = tdt.schema(("a", tdt.INT64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tblock.TableBlock.from_numpy({"a": np.arange(3)}, sch)
    from ydb_tpu_torch.entry import entry
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_dtype_map():
    assert tdt.torch_dtype(tdt.decimal(2)) == torch.int64
    assert tdt.torch_dtype(tdt.TIMESTAMP) == torch.int64
    assert tdt.torch_dtype(tdt.DATE) == torch.int32
    assert tdt.torch_dtype(tdt.STRING) == torch.int32
    assert tdt.torch_dtype(tdt.BOOL) == torch.bool
    with pytest.raises(TypeError):
        tdt.torch_dtype(tdt.UINT64)
    for k in rdt.Kind:
        assert tdt.LogicalType(tdt.Kind[k.name]).physical == \
            rdt.LogicalType(k).physical


# ---------------- kernel primitives ----------------


def test_kleene_logic_with_nulls():
    rng = np.random.default_rng(1)
    n = 500
    (ra, ta) = both_cols(rng.random(n) < 0.5, rng.random(n) < 0.7)
    (rb, tb) = both_cols(rng.random(n) < 0.5, rng.random(n) < 0.7)
    for rf, tf in ((rk.kleene_and, tk.kleene_and), (rk.kleene_or, tk.kleene_or)):
        r, t = rf(ra, rb), tf(ta, tb)
        assert_same(t.validity, r.validity)
        v = np_of(r.validity)
        assert_same(np_of(t.data)[v], np_of(r.data)[v])


@pytest.mark.parametrize("float_result", [False, True])
def test_safe_div_trunc_div_mod(float_result):
    rng = np.random.default_rng(2)
    n = 2000
    a = rng_i64(rng, n)
    b = rng.integers(-50, 50, n).astype(np.int64)  # zeros -> NULL
    va, vb = rng.random(n) < 0.9, rng.random(n) < 0.9
    (ra, ta), (rb, tb) = both_cols(a, va), both_cols(b, vb)
    if float_result:
        ra = rblock.Column(ra.data.astype(jnp.float64), ra.validity)
        ta = tblock.Column(ta.data.to(torch.float64), ta.validity)
    r = rk.safe_div(ra, rb, float_result)
    t = tk.safe_div(ta, tb, float_result)
    assert_same(t.validity, r.validity)
    ok = np_of(r.validity)
    assert_same(np_of(t.data)[ok], np_of(r.data)[ok])
    den = np.where(b == 0, 1, b)
    assert_same(tk.trunc_mod(torch.from_numpy(a), torch.from_numpy(den)),
                rk.trunc_mod(jnp.asarray(a), jnp.asarray(den)))


def test_civil_calendar_round_trip():
    days = np.concatenate([np.arange(-800_000, 800_000, 997),
                           np.array([0, 59, 60, 365, 18262, 19723])]
                          ).astype(np.int32)
    r = rk.civil_from_days(jnp.asarray(days))
    t = tk.civil_from_days(torch.from_numpy(days))
    for x, y in zip(t, r):
        assert_same(x, y)
    assert_same(tk.days_from_civil(*t), rk.days_from_civil(*r))
    assert_same(tk.days_from_civil(*t), days.astype(np.int64))


def test_dict_gather_clamps_ids():
    table = np.array([True, False, True])
    ids = np.array([0, 1, 2, 5, -1], dtype=np.int32)
    valid = np.array([True, True, False, True, True])
    (rc, tc) = both_cols(ids, valid)
    r = rk.dict_gather(jnp.asarray(table), rc)
    t = tk.dict_gather(torch.from_numpy(table), tc)
    assert_same(t.data, r.data)
    assert_same(t.validity, r.validity)


def _both_blocks(arrays, rsch, validity=None, capacity=None):
    ref = rblock.TableBlock.from_numpy(arrays, rsch, validity, capacity)
    port = tblock.TableBlock.from_numpy(
        arrays, interop.program_from_reference(rsch), validity, capacity,
        device=CPU)
    return ref, port


def _assert_blocks(port, ref, rtol=None):
    pd, pv = port.host_columns()
    rd, rv = ref.host_columns()
    assert sorted(pd) == sorted(rd)  # jax.device_get sorts dict keys
    for k in rd:
        assert_same(pv[k], rv[k], what=f"validity {k}")
        assert_same(pd[k][rv[k]], rd[k][rv[k]], rtol=rtol, what=k)


def test_compact_is_stable():
    rng = np.random.default_rng(3)
    n = 3000
    arrays = {"a": rng_i64(rng, n), "b": rng.random(n)}
    rsch = rdt.schema(("a", rdt.INT64), ("b", rdt.DOUBLE))
    ref, port = _both_blocks(arrays, rsch, {"a": rng.random(n) < 0.8})
    sel = rng.random(ref.capacity) < 0.4
    r = rk.compact(ref, jnp.asarray(sel))
    t = tk.compact(port, torch.from_numpy(sel))
    assert int(t.length) == int(r.length)
    _assert_blocks(t, r)


def _keys(rng, n, nullable=True):
    k1 = rng.integers(0, 5, n).astype(np.int32)
    k2 = rng_i64(rng, n, -3, 3)
    v1 = rng.random(n) < (0.85 if nullable else 1.1)
    v2 = rng.random(n) < (0.9 if nullable else 1.1)
    return [both_cols(k1, v1), both_cols(k2, v2)]


def test_group_ids_dense_and_sorted():
    rng = np.random.default_rng(4)
    n = 2048
    keys = _keys(rng, n)
    live = rng.random(n) < 0.9
    rkeys, tkeys = [k[0] for k in keys], [k[1] for k in keys]
    rg, rn = rk.group_ids_dense(rkeys[:1], [5], jnp.asarray(live))
    tg, tn = tk.group_ids_dense(tkeys[:1], [5], torch.from_numpy(live))
    assert tn == rn
    assert_same(tg, rg)
    rg, rn = rk.group_ids_sorted(rkeys, jnp.asarray(live), 64)
    tg, tn = tk.group_ids_sorted(tkeys, torch.from_numpy(live), 64)
    assert_same(tn, rn)
    assert_same(tg, rg)


def test_group_hits_and_first_live_index():
    rng = np.random.default_rng(5)
    gid = rng.integers(0, 40, 700).astype(np.int32)  # 33..39 = dead
    rh = rk.group_hits(jnp.asarray(gid), 33)
    th = tk.group_hits(torch.from_numpy(gid), 33)
    assert_same(th, rh)
    rf, rfound = rk.first_live_index(rh)
    tf, tfound = tk.first_live_index(th)
    assert_same(tfound, rfound)
    assert_same(tf.to(torch.int32), rf)


BANK_DTYPES = [(np.int64, jnp.int64, torch.int64),
               (np.float64, jnp.float64, torch.float64),
               (np.int32, jnp.int32, torch.int32),
               (np.float32, jnp.float32, torch.float32)]


def _bank(rng, rows, slots, np_dt):
    if np_dt == np.int64:
        return np.stack([rng_i64(rng, rows) for _ in range(slots)], axis=1)
    if np_dt == np.int32:
        return rng.integers(-1000, 1000, (rows, slots)).astype(np.int32)
    return (rng.random((rows, slots)) * 100 - 50).astype(np_dt)


@pytest.mark.parametrize("ng", [7, 513, 1749, 2048])
@pytest.mark.parametrize("dts", BANK_DTYPES, ids=lambda d: d[0].__name__)
def test_fused_group_reduce(ng, dts):
    np_dt, j_dt, t_dt = dts
    rng = np.random.default_rng(ng)
    rows = 4096
    vals = _bank(rng, rows, 3, np_dt)
    gid = rng.integers(0, ng + 1, rows).astype(np.int32)  # ng = dead row
    r = rk.fused_group_reduce(jnp.asarray(vals), jnp.asarray(gid), ng, j_dt)
    t = tk.fused_group_reduce(torch.from_numpy(vals), torch.from_numpy(gid),
                              ng, t_dt)
    # float32 group sums: rtol 1e-5 (addition order differs)
    assert_same(t, r, rtol=1e-5 if np_dt == np.float32 else None)


@pytest.mark.parametrize("limb2_rows", [rk._INT_LIMB2_MAX_ROWS, 0],
                         ids=["32bit-limbs", "24bit-limbs"])
def test_fused_group_reduce_banks_limbs(monkeypatch, limb2_rows):
    """Mixed banks through the one-hot f64 contraction: integer banks are
    split into 32- or 24-bit limbs (the latter forced by lowering the
    row threshold on both sides) and must come back bit-exact."""
    monkeypatch.setattr(rk, "_INT_LIMB2_MAX_ROWS", limb2_rows)
    monkeypatch.setattr(tk, "_INT_LIMB2_MAX_ROWS", limb2_rows)
    rng = np.random.default_rng(6)
    rows, ng = 3000, 12
    banks = {dt: _bank(rng, rows, 2 + i, dt[0])
             for i, dt in enumerate(BANK_DTYPES)}
    gid = rng.integers(0, ng + 1, rows).astype(np.int32)
    r = rk.fused_group_reduce_banks(
        {d[1]: jnp.asarray(v) for d, v in banks.items()}, jnp.asarray(gid), ng)
    t = tk.fused_group_reduce_banks(
        {d[2]: torch.from_numpy(v) for d, v in banks.items()},
        torch.from_numpy(gid), ng)
    for d in banks:
        assert_same(t[d[2]], r[jnp.dtype(d[1])], what=str(d[0]))


@pytest.mark.parametrize("ng", [7, 513, 1749, 2048])
@pytest.mark.parametrize("dts", BANK_DTYPES, ids=lambda d: d[0].__name__)
def test_scatter_sum_min_max(ng, dts):
    np_dt, j_dt, t_dt = dts
    rng = np.random.default_rng(ng + 1)
    rows = 3000
    vals = _bank(rng, rows, 1, np_dt)[:, 0]
    gid = rng.integers(0, ng + 1, rows).astype(np.int32)
    valid = rng.random(rows) < 0.8
    rv, rg, rm = jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(valid)
    tv, tg, tm = (torch.from_numpy(vals), torch.from_numpy(gid),
                  torch.from_numpy(valid))
    rtol = 1e-5 if np_dt == np.float32 else None
    assert_same(tk.scatter_sum(tv, tm, tg, ng, t_dt),
                rk.scatter_sum(rv, rm, rg, ng, j_dt), rtol=rtol)
    assert_same(tk.scatter_min(tv, tm, tg, ng), rk.scatter_min(rv, rm, rg, ng))
    assert_same(tk.scatter_max(tv, tm, tg, ng), rk.scatter_max(rv, rm, rg, ng))


@pytest.mark.parametrize("ng", [7, 1749])
def test_scatter_first(ng):
    rng = np.random.default_rng(7)
    rows = 2000
    gid = rng.integers(0, ng + 1, rows).astype(np.int32)
    # per-group constant values: any row of a group is a valid answer
    # above the one-hot tier, so only the value, not the row, is compared
    vals = (gid.astype(np.int64) * 3 - 7) if ng > 512 else rng_i64(rng, rows)
    valid = rng.random(rows) < 0.8
    r = rk.scatter_first(jnp.asarray(vals), jnp.asarray(valid),
                         jnp.asarray(gid), ng)
    t = tk.scatter_first(torch.from_numpy(vals), torch.from_numpy(valid),
                         torch.from_numpy(gid), ng)
    assert_same(t, r)


def test_sort_block_multi_key_nulls_desc_limit():
    rng = np.random.default_rng(8)
    n = 3000
    arrays = {"a": rng.integers(0, 4, n).astype(np.int32),
              "b": rng_i64(rng, n, -5, 5),
              "c": rng.random(n).round(1),
              "f": rng.random(n) < 0.5}
    rsch = rdt.schema(("a", rdt.INT32), ("b", rdt.INT64), ("c", rdt.DOUBLE),
                      ("f", rdt.BOOL))
    validity = {"b": rng.random(n) < 0.8, "c": rng.random(n) < 0.9}
    ref, port = _both_blocks(arrays, rsch, validity)
    live = rng.random(ref.capacity) < 0.7
    for keys, desc, limit in ((["a", "b"], [False, True], None),
                              (["c", "f", "b"], [True, False, False], 100),
                              (["f"], [True], 10)):
        r = rk.sort_block(ref, keys, desc, limit, live=jnp.asarray(live))
        t = tk.sort_block(port, keys, desc, limit, live=torch.from_numpy(live))
        assert int(t.length) == int(r.length)
        pd, pv = t.host_columns()
        rd, rv = r.host_columns()
        for k in rd:  # stable sort: the same rows in the same order
            assert_same(pv[k], rv[k], what=k)
            assert_same(pd[k][rv[k]], rd[k][rv[k]], what=k)


# ---------------- the CUDA kernels' plain versions ----------------


@pytest.mark.parametrize("ng", [513, 1749, 2048])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("slots", [1, 6, 128])
def test_grouped_sum_multi_plain_matches_reference(ng, dtype, slots):
    """grouped_sum_multi's plain version (what the fused tier runs on CPU
    tensors) against the reference's fused_group_reduce scatter tier."""
    rng = np.random.default_rng(ng * slots)
    rows = 5000 if slots < 128 else 1500
    vals = _bank(rng, rows, slots, np.dtype(dtype).type)
    gid = rng.integers(0, ng + 2, rows).astype(np.int32)  # ng, ng+1 dead
    gid[:50] = ng
    r = rk.fused_group_reduce(jnp.asarray(vals), jnp.asarray(gid), ng)
    tv, tg = torch.from_numpy(vals), torch.from_numpy(gid)
    rtol = 1e-5 if dtype == "float32" else None  # addition order differs
    assert_same(ck.grouped_sum_multi_plain(tv, tg, ng), r, rtol=rtol)
    assert_same(ck.grouped_sum_multi(tv, tg, ng), r, rtol=rtol)
    assert_same(tk.fused_group_reduce(tv, tg, ng), r, rtol=rtol)


@pytest.mark.parametrize("ng", [513, 1749, 2048])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_grouped_sum_plain_matches_reference(ng, dtype):
    """grouped_sum's plain version (the per-aggregate tier on CPU tensors)
    against the reference's scatter_sum scatter tier."""
    rng = np.random.default_rng(ng)
    rows = 5000
    vals = _bank(rng, rows, 1, np.dtype(dtype).type)[:, 0]
    gid = rng.integers(0, ng + 1, rows).astype(np.int32)
    valid = rng.random(rows) < 0.75
    r = rk.scatter_sum(jnp.asarray(vals), jnp.asarray(valid),
                       jnp.asarray(gid), ng)
    tv, tg, tm = (torch.from_numpy(vals), torch.from_numpy(gid),
                  torch.from_numpy(valid))
    rtol = 1e-5 if dtype == "float32" else None
    assert_same(ck.scatter_sum_kernel(tv, tm, tg, ng), r, rtol=rtol)
    idx = torch.where(tm, tg, ng).to(torch.int32)
    assert_same(ck.grouped_sum_plain(tv, idx, ng), r, rtol=rtol)
    assert_same(tk.scatter_sum(tv, tm, tg, ng), r, rtol=rtol)


def test_plain_versions_drop_out_of_range_ids():
    vals = torch.arange(1, 9, dtype=torch.int32)
    gid = torch.tensor([0, 1, 2, 3, 4, -1, -7, 2], dtype=torch.int32)
    assert ck.grouped_sum_plain(vals, gid, 3).tolist() == [1, 2, 3 + 8]
    out = ck.grouped_sum_multi_plain(vals[:, None].repeat(1, 2), gid, 3)
    assert out.tolist() == [[1, 1], [2, 2], [11, 11]]
    assert ck.grouped_sum_plain(vals, torch.full((8,), 3, dtype=torch.int32),
                                3).tolist() == [0, 0, 0]


def test_kernel_gate_and_eligibility(monkeypatch):
    # eligibility is the reference's supported()/supported_fused()
    assert ck.supported(torch.float32, 2048)
    assert not ck.supported(torch.int64, 10)
    assert not ck.supported(torch.float32, 2049)
    assert not ck.supported_fused(torch.int32, 600, 129)
    with pytest.raises(TypeError):
        ck.grouped_sum(torch.ones(4, dtype=torch.int64),
                       torch.zeros(4, dtype=torch.int32), 600)
    calls = []
    monkeypatch.setattr(ck, "grouped_sum_multi",
                        lambda *a: calls.append(a) or ck.grouped_sum_multi_plain(*a))
    vals = torch.ones((10, 2), dtype=torch.int32)
    gid = torch.zeros(10, dtype=torch.int32)
    tk.fused_group_reduce(vals, gid, 600)
    assert len(calls) == 1
    monkeypatch.setattr(ck, "FORCE", False)
    tk.fused_group_reduce(vals, gid, 600)
    assert len(calls) == 1  # gate off: the plain scatter tier instead
    monkeypatch.setattr(ck, "FORCE", None)
    monkeypatch.setenv("YDB_TPU_TORCH_KERNELS", "0")
    assert not ck.enabled()
    monkeypatch.setenv("YDB_TPU_TORCH_KERNELS", "1")
    assert ck.enabled()


@pytest.mark.parametrize("slots", [1, 6, 16, 17, 128])
@pytest.mark.parametrize("rows", [0, 3, 4095, (1 << 20) + 3, 1 << 24])
@pytest.mark.parametrize("max_clusters", [1, 16, 66])
def test_launch_plan(slots, rows, max_clusters):
    """The grid and scratch of one kernel launch: 16-slot chunks, never
    more clusters than the card holds at once, scratch for every
    cluster's partial of every chunk."""
    ng = 1746
    plan = ck._launch_plan(rows, slots, ng, max_clusters)
    assert plan.chunks == -(-slots // 16)
    assert plan.chunk_width == min(slots, 16)
    assert (plan.chunks, plan.chunk_width) == {
        1: (1, 1), 6: (1, 6), 16: (1, 16), 17: (2, 16), 128: (8, 16)}[slots]
    assert 1 <= plan.clusters <= max_clusters
    # enough threads for every (row, slot) element of a chunk, unless the
    # card holds no more clusters
    assert (plan.clusters * ck.ELEMS_PER_CLUSTER >= rows * plan.chunk_width
            or plan.clusters == max_clusters)
    assert plan.clusters == 1 or ((plan.clusters - 1) * ck.ELEMS_PER_CLUSTER
                                  < rows * plan.chunk_width)
    # each cluster's partial padded to a multiple of 4 elements (16 B)
    assert plan.part_stride % 4 == 0
    assert 0 <= plan.part_stride - ng * plan.chunk_width < 4
    assert plan.scratch_elems == (plan.chunks * plan.clusters
                                  * plan.part_stride)
    if rows == 1 << 24 and max_clusters == 16:  # the 128 KB case: 16 MB
        assert plan.scratch_elems * 4 == {1: 1748, 6: 6 * ng, 16: 16 * ng,
                                          17: 32 * ng,
                                          128: 128 * ng}[slots] * 16 * 4


def test_ticket_rows(monkeypatch):
    """Each stream gets its own zeroed row of tickets, CLUSTER for each
    of the at most 8 chunks of 16 slots, from one slab per device."""
    monkeypatch.setattr(ck, "_ticket_slabs", {})
    monkeypatch.setattr(ck, "_ticket_rows", {})
    cpu = torch.device("cpu")
    a, b = ck._tickets(cpu, 11), ck._tickets(cpu, 22)
    assert a.shape == b.shape == (-(-ck.MAX_FUSED_SLOTS // 16) * ck.CLUSTER,)
    assert a.dtype == torch.int32 and not a.any() and not b.any()
    assert a.data_ptr() != b.data_ptr()
    assert ck._tickets(cpu, 11).data_ptr() == a.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [0, 1, 6, 17, 128])
def test_cuda_kernels_match_plain_on_gpu(slots):
    """On a GPU: each kernel against its plain version, on aligned and
    misaligned inputs and on replays of a captured CUDA graph
    (chip_smoke.py runs the full adversarial set)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(slots)

    def run(vals, gid, ng):
        if slots:
            return (ck.grouped_sum_multi(vals, gid, ng),
                    ck.grouped_sum_multi_plain(vals, gid, ng))
        return ck.grouped_sum(vals, gid, ng), ck.grouped_sum_plain(vals, gid, ng)

    for ng in (513, 1749, 2048):
        gid = torch.randint(-2, ng + 3, (100_004,), generator=gen,
                            device="cuda", dtype=torch.int32)
        shape = (100_004, slots) if slots else (100_004,)
        vals = torch.randint(-1000, 1000, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
        for lo in (0, 1):  # 1: pointers off 16-byte alignment
            got, want = run(vals[lo:100_003], gid[lo:100_003], ng)
            assert torch.equal(got, want), (ng, lo)
    # graph replays: the kernel's ticket must reset after every launch
    vals, gid = vals[1:], gid[1:]
    run(vals, gid, 1749)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = run(vals, gid, 1749)
    want = run(vals, gid, 1749)[1]
    for _ in range(3):
        got.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# ---------------- program compiler ----------------


def _ref_block(cols):
    """name -> (array, logical type[, validity]) for both packages."""
    sch, arrays, validity = [], {}, {}
    for name, spec in cols.items():
        sch.append((name, spec[1]))
        arrays[name] = np.asarray(spec[0])
        if len(spec) > 2:
            validity[name] = np.asarray(spec[2])
    return _both_blocks(arrays, rdt.schema(*sch), validity or None)


def _dicts(values_by_col):
    rd, td = RDicts(), TDicts()
    ids = {}
    for col, vals in values_by_col.items():
        ids[col] = rd.for_column(col).encode(vals)
        td.for_column(col).encode(vals)
    return rd, td, ids


def _ssa_cases():
    from ydb_tpu.ssa import (Agg, AggSpec, AssignStep, Call, Col,
                             DictPredicate, FilterStep, GroupByStep, Op,
                             ProjectStep, Program, SortStep)
    from ydb_tpu.ssa.program import decimal_lit, lit

    rd, td, ids = _dicts({"s": [b"AIR", b"MAIL", b"SHIP", b"AIR"],
                          "flag": [b"A", b"B", b"A", b"A", b"B"]})
    return [
        ("filter_and_arith",
         dict(a=([1, 2, 3, 4, 5], rdt.INT64), b=([10, 20, 30, 40, 50], rdt.INT64)),
         Program((AssignStep("c", Call(Op.ADD, Col("a"), Col("b"))),
                  FilterStep(Call(Op.GT, Col("c"), lit(33))),
                  ProjectStep(("a", "c")))), None),
        ("null_propagation_and_kleene",
         dict(a=([1, 2, 3], rdt.INT64, [True, False, True]),
              b=([5, 5, 0], rdt.INT64)),
         Program((AssignStep("gt", Call(Op.GT, Col("a"), lit(0))),
                  AssignStep("div", Call(Op.DIV, Col("b"), Col("a"))),
                  FilterStep(Col("gt")))), None),
        ("div_by_zero_is_null",
         dict(a=([10, 10, -7], rdt.INT64), b=([2, 0, 2], rdt.INT64)),
         Program((AssignStep("q", Call(Op.DIV, Col("a"), Col("b"))),
                  AssignStep("m", Call(Op.MOD, Col("a"), Col("b"))))), None),
        ("decimal_arith_and_rescale",
         dict(price=([100_00, 250_50], rdt.decimal(2)),
              disc=([5, 10], rdt.decimal(2))),
         Program((AssignStep("one_minus",
                             Call(Op.SUB, decimal_lit("1", 2), Col("disc"))),
                  AssignStep("dp", Call(Op.MUL, Col("price"),
                                        Col("one_minus"))),
                  AssignStep("avgish", Call(Op.DIV, Col("dp"), lit(3))))),
         None),
        ("dict_predicates",
         dict(s=(ids["s"], rdt.STRING)),
         Program((FilterStep(DictPredicate("s", "in_set",
                                           (b"MAIL", b"SHIP"))),)),
         (rd, td)),
        ("dict_eq",
         dict(s=(ids["s"], rdt.STRING)),
         Program((FilterStep(DictPredicate("s", "eq", b"AIR")),)), (rd, td)),
        ("group_by_dense_with_strings",
         dict(flag=(ids["flag"], rdt.STRING),
              qty=([1.0, 2.0, 3.0, 4.0, 100.0], rdt.DOUBLE)),
         Program((GroupByStep(keys=("flag",), aggs=(
             AggSpec(Agg.SUM, "qty", "sum_qty"),
             AggSpec(Agg.AVG, "qty", "avg_qty"),
             AggSpec(Agg.MIN, "flag", "lo"),
             AggSpec(Agg.COUNT_ALL, None, "n"))),)), (rd, td)),
        ("group_by_sorted_path_generic_keys",
         dict(k=([7, 3, 7, 3, 9, 7], rdt.INT64), v=([1, 2, 3, 4, 5, 6], rdt.INT64)),
         Program((GroupByStep(keys=("k",), aggs=(
             AggSpec(Agg.SUM, "v", "sv"), AggSpec(Agg.MIN, "v", "mn"),
             AggSpec(Agg.MAX, "v", "mx")), max_groups=16),)), None),
        ("group_by_null_key_and_null_values",
         dict(k=([1, 1, 2, 2], rdt.INT64, [True, False, True, True]),
              v=([10, 20, 30, 40], rdt.INT64, [True, True, False, True])),
         Program((GroupByStep(keys=("k",), aggs=(
             AggSpec(Agg.SUM, "v", "sv"), AggSpec(Agg.COUNT, "v", "cnt"),
             AggSpec(Agg.COUNT_ALL, None, "n")), max_groups=8),)), None),
        ("global_aggregate_no_keys",
         dict(v=([1.5, 2.5, 4.0], rdt.DOUBLE)),
         Program((GroupByStep(keys=(), aggs=(
             AggSpec(Agg.SUM, "v", "s"), AggSpec(Agg.COUNT_ALL, None, "n"))),)),
         None),
        ("sort_desc_with_limit",
         dict(a=([5, 1, 4, 2, 3], rdt.INT64), b=([50, 10, 40, 20, 30], rdt.INT64)),
         Program((SortStep(keys=("a",), descending=(True,), limit=3),)), None),
        ("sort_by_string_rank",
         dict(s=(ids["s"], rdt.STRING), b=([4, 3, 2, 1], rdt.INT64)),
         Program((SortStep(keys=("s", "b")),)), (rd, td)),
        ("date_parts",
         dict(d=([0, 18262, 19723, -400], rdt.DATE)),
         Program((AssignStep("y", Call(Op.YEAR, Col("d"))),
                  AssignStep("m", Call(Op.MONTH, Col("d"))),
                  AssignStep("dow", Call(Op.DAY_OF_WEEK, Col("d"))),
                  AssignStep("doy", Call(Op.DAY_OF_YEAR, Col("d"))),
                  AssignStep("q", Call(Op.QUARTER, Col("d"))))), None),
        ("math_and_casts",
         dict(a=([1, 4, 9, -2], rdt.INT64), f=([0.5, 2.25, -1.5, 7.0], rdt.DOUBLE),
              i=([1, 2, 3, 4], rdt.INT32)),
         Program((AssignStep("r", Call(Op.SQRT, Col("i"))),
                  AssignStep("e", Call(Op.CAST_DOUBLE, Col("a"))),
                  AssignStep("g", Call(Op.GREATEST, Col("a"), Col("i"))),
                  AssignStep("fl", Call(Op.FLOOR, Col("f"))),
                  AssignStep("c", Call(Op.COALESCE, Col("a"), lit(0))),
                  AssignStep("iff", Call(Op.IF, Call(Op.GT, Col("f"), lit(1.0)),
                                         Col("a"), Col("i"))),
                  AssignStep("ins", Call(Op.IN_SET, Col("a"), lit(4), lit(-2))),
                  AssignStep("nn", Call(Op.IS_NULL, Col("a"))))), None),
    ]


CASES = _ssa_cases()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "peragg"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compile_program_matches_reference(case, fused, monkeypatch):
    """The programs of tests/test_ssa.py (and a few more), converted with
    program_from_reference: same output schema, group layout, length,
    validity (bit-exact) and values."""
    name, cols, prog, dicts = case
    monkeypatch.setattr(rk, "FUSED_FORCE", fused)
    monkeypatch.setattr(tk, "FUSED_FORCE", fused)
    ref_blk, port_blk = _ref_block(cols)
    rd, td = dicts if dicts else (None, None)
    rcp = rcompile(prog, ref_blk.schema, rd)
    tcp = tcompile(interop.program_from_reference(prog), port_blk.schema, td)
    assert tcp.out_schema == interop.program_from_reference(rcp.out_schema)
    assert tcp.group_layout == rcp.group_layout
    r, t = rcp(ref_blk), tcp(port_blk)
    assert int(t.length) == int(r.length)
    _assert_blocks(t, r)


def test_var_stddev_through_compiler():
    rng = np.random.default_rng(11)
    n = 5000
    g = rng.integers(0, 7, n).astype(np.int64)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    prog = rprog.Program((rprog.GroupByStep(keys=("g",), aggs=(
        rprog.AggSpec(rops.Agg.VAR_SAMP, "v", "var"),
        rprog.AggSpec(rops.Agg.STDDEV_SAMP, "v", "sd"),
        rprog.AggSpec(rops.Agg.COUNT, "v", "n"))),))
    ref_blk, port_blk = _both_blocks(
        {"g": g, "v": v}, rdt.schema(("g", rdt.INT64, False), ("v", rdt.INT64)),
        {"v": valid})
    r = rcompile(prog, ref_blk.schema, key_spaces={"g": 7})(ref_blk)
    t = tcompile(interop.program_from_reference(prog), port_blk.schema,
                 key_spaces={"g": 7})(port_blk)
    _assert_blocks(t, r, rtol=1e-12)


def test_window_and_udf_are_not_ported_yet():
    sch = tdt.schema(("g", tdt.INT64, False), ("v", tdt.INT64, False))
    from ydb_tpu_torch.ssa.program import (Col, Program, UdfCall,
                                           AssignStep, WindowStep)
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        tcompile(Program((WindowStep("rank", ("g",), ("v",), (False,), "r"),)),
                 sch)
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        tcompile(Program((AssignStep(
            "u", UdfCall("f", (Col("v"),), tdt.INT64, lambda x: x)),)), sch)


# ---------------- interop ----------------


def test_program_from_reference_round_trip():
    from ydb_tpu.workload import tpch as rtpch

    for prog in (rtpch.q1_program(), rtpch.q6_program()):
        port = interop.program_from_reference(prog)
        assert type(port).__module__ == "ydb_tpu_torch.ssa.program"
        assert interop.convert(port, REF_CLASSES) == prog
        assert dataclasses.is_dataclass(port.steps[0])


def test_source_from_numpy_matches_reference_table():
    from ydb_tpu.workload import tpch as rtpch
    from ydb_tpu_torch.workload import tpch as ttpch

    data = rtpch.TpchData(sf=0.002, seed=3)
    cols = data.tables["lineitem"]
    spec = [(f.name, f.type.kind.name, f.type.scale, f.nullable)
            for f in rtpch.LINEITEM_SCHEMA.fields]
    dict_values = {c: data.dicts[c].values for c in data.dicts.columns()
                   if c.startswith("l_")}
    src = interop.source_from_numpy(cols, None, spec, dict_values)
    assert src.schema == ttpch.LINEITEM_SCHEMA
    assert src.num_rows == len(cols["l_orderkey"])
    assert src.dicts["l_shipmode"].values == data.dicts["l_shipmode"].values
