#!/usr/bin/env python3
"""On-device smoke test of the torch/CUDA port (``ydb_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--sf 10] [--sql-sf SF] [--hits-rows 10000000]
                          [--json-out PATH]
                          [--baseline-source OLD_grouped_sum.cu]

Phases, in order; any failure exits non-zero before the final line:

1. Device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Kernels: builds the CUDA kernels of ``ydb_tpu_torch/csrc`` with nvcc
   (into ``build/ydb_tpu_torch_kernels``) and holds each against its plain
   torch version on random and adversarial group ids, misaligned
   pointers, ragged row counts, slot counts at the 16-slot chunk edges,
   replays of a captured CUDA graph and back-to-back calls.
3. Main path: TPC-H Q1 and Q6 at scale factor ``--sf`` and ClickBench q33
   and q36 at ``--hits-rows`` rows, through the port's ``ScanExecutor``
   over device-resident blocks of 1<<20 rows; q33/q36 on the fused and on
   the per-aggregate group-by lowering. Launch counters are zeroed just
   before this run and read just after; each kernel must have launched.
   Results are checked against independent numpy computations.
4. Timings: warm rows/s per query; per-kernel device time at the main
   path's shape (CUDA-graph replay, so host launch overhead is out), hot
   and with inputs rotated through more than the L2 cache (cold), beside
   its plain version, ``index_add_`` and its memory bound, plus the
   host-inclusive time of one wrapper call and the device operations one
   call issues (``torch.profiler``: exactly one kernel). With
   ``--baseline-source``, an earlier kernel source is built and timed
   beside them. Then a sweep over slot counts and id mixes (one
   ``{"sweep": ...}`` line each).
5. SQL path: the 22 TPC-H queries through the port's parser, planner and
   plan walk (``execute_plan`` + ``to_host``) over all eight tables held
   on the card. First at sf 0.01, seed 11, against the rows and digests
   pinned in ``tests/golden_tpch.json``; then at ``--sql-sf`` (default:
   ``--sf``, whose seed-42 tables the scan phase already generated), where
   Q1, Q3, Q5, Q6, Q13 and Q18 are checked against independent numpy.
   One ``{"sql": ...}`` line per query: first-run seconds, the median and
   spread of three warm runs, result rows, peak device memory, the
   launches of each CUDA kernel, and for one more warm run the device's
   busy share (``torch.profiler``) and the seconds of each layer of the
   plan walk (scans, joins, transforms; synced host clock).

The last lines are a ``{"kernels": [...]}`` JSON line, the nvidia-smi line
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), for the memory bound
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
F32_OPS_PER_S = 67e12
BLOCK_ROWS = 1 << 20
#: inputs rotated through for a cold-cache time: more than the H100's
#: 50 MB L2 several times over
L2_COLD_BYTES = 200 << 20
KERNEL_SOURCE = "ydb_tpu_torch/csrc/grouped_sum.cu"
REPLACES = {
    "grouped_sum_multi": "ydb_tpu/ssa/pallas_kernels.py:138",
    "grouped_sum": "ydb_tpu/ssa/pallas_kernels.py:78",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, repeats: int = 5) -> float:
    """Host-inclusive time of one call: median over ``repeats`` of the
    mean CUDA-event time of ``iters`` back-to-back calls, after a warm-up
    (small kernels are then bound by the host's launch rate)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def device_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured into a CUDA
    graph, replayed ``repeats`` times under CUDA events; the median
    replay over ``iters``. Host launch overhead is not in it. ``fn`` may
    be a list of calls on different inputs: the graph then cycles
    through them (``iters`` is rounded up to a multiple of their count),
    so that the inputs, when they outgrow the L2 cache, are read cold."""
    fns = fn if isinstance(fn, list) else [fn]
    iters = -(-iters // len(fns)) * len(fns)
    fns[0]()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns[:3]:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def cold_sets(tensors, set_bytes: int) -> list:
    """Copies of ``tensors`` that together exceed the L2 cache (at least
    8 sets, and at least L2_COLD_BYTES in all)."""
    n = max(8, -(-L2_COLD_BYTES // set_bytes))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound(rows: int, slots: int, ng: int) -> tuple[float, str]:
    """Least device ms for one grouped sum: ids and values read once,
    the (groups x slots) output written once, at HBM rate; or one add
    per value at the float32 rate, whichever is larger."""
    bytes_ms = (rows * 4 + rows * slots * 4 + ng * slots * 4) \
        / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * slots / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def sweep(ck, baseline, url_ids, ng, dev) -> list:
    """Kernel device times at 1<<20 rows over slot counts and id mixes
    (zipf URL ids as on the main path, uniform ids, one hot id), hot
    (inputs in L2) and cold (inputs rotated through more than L2); int32
    values, and float32 at 1 and 6 slots."""
    rows = url_ids.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    mixes = {
        "zipf": url_ids,
        "uniform": torch.randint(0, ng, (rows,), generator=gen, device=dev,
                                 dtype=torch.int32),
        "hot": torch.full((rows,), 7, dtype=torch.int32, device=dev),
    }
    out = []
    for mix, g in mixes.items():
        for name, slots, dtype in (
                ("grouped_sum_multi", 1, torch.int32),
                ("grouped_sum_multi", 6, torch.int32),
                ("grouped_sum_multi", 17, torch.int32),
                ("grouped_sum_multi", 128, torch.int32),
                ("grouped_sum", 1, torch.int32),
                ("grouped_sum_multi", 1, torch.float32),
                ("grouped_sum_multi", 6, torch.float32)):
            shape = (rows, slots) if name == "grouped_sum_multi" else (rows,)
            v = torch.randint(-1000, 1000, shape, generator=gen, device=dev,
                              dtype=torch.int32).to(dtype)
            kfn = getattr(ck, name)
            sets = cold_sets((v, g), v.nbytes + g.nbytes)
            row = {"kernel": name, "slots": slots, "ids": mix,
                   "dtype": str(dtype).removeprefix("torch."), "rows": rows,
                   "groups": ng,
                   "ms": device_ms(lambda: kfn(v, g, ng)),
                   "cold_ms": device_ms([
                       (lambda vv=vv, gg=gg: kfn(vv, gg, ng))
                       for vv, gg in sets])}
            if baseline:
                bfn = baseline[name]
                row["baseline_ms"] = device_ms(lambda: bfn(v, g, ng))
                row["baseline_cold_ms"] = device_ms([
                    (lambda vv=vv, gg=gg: bfn(vv, gg, ng)) for vv, gg in sets])
            row["bound_ms"], row["bound_by"] = bound(rows, slots, ng)
            row["bound_share"] = row["bound_ms"] / row["cold_ms"]
            del sets
            out.append(row)
            log(json.dumps({"sweep": row}))
    return out


# ---------------- phase 2: kernels against their plain versions ----------------


def kernel_phase(ck, dev) -> dict:
    t0 = time.perf_counter()
    lib = ck.build(verbose=True)
    log(f"kernels built: {os.path.relpath(lib, HERE)} in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    err = {"grouped_sum": 0.0, "grouped_sum_multi": 0.0}
    n_cases = {"grouped_sum": 0, "grouped_sum_multi": 0}

    def values(rows, slots, dtype, kind):
        shape = (rows, slots) if slots else (rows,)
        if kind == "int_floats":  # exact in f32 whatever the order
            return torch.randint(0, 16, shape, generator=gen, device=dev
                                 ).to(dtype)
        if kind == "wrap":  # int32 sums that overflow and wrap
            return torch.full(shape, 1 << 30, dtype=dtype, device=dev)
        if dtype == torch.int32:
            return torch.randint(-1000, 1000, shape, generator=gen,
                                 device=dev, dtype=torch.int32)
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    def gids(rows, ng, kind):
        if kind == "all_dropped":
            return torch.full((rows,), ng, dtype=torch.int32, device=dev)
        if kind == "hot":
            return torch.full((rows,), 7 % ng, dtype=torch.int32, device=dev)
        if kind == "out_of_range":  # negatives, == ng and > ng mixed in
            return torch.randint(-3, ng + 6, (rows,), generator=gen,
                                 device=dev, dtype=torch.int32)
        return torch.randint(0, ng + 1, (rows,), generator=gen, device=dev,
                             dtype=torch.int32)

    def check(name, got, want, dtype, label):
        torch.cuda.synchronize()
        if dtype == torch.int32:
            if not torch.equal(got, want):
                bad = (got.long() - want.long()).abs().max().item()
                raise AssertionError(f"{name} {label}: int32 mismatch {bad}")
        else:
            # float32 sums differ only in summation order: rtol 1e-5
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                       msg=f"{name} {label}")
            err[name] = max(err[name], (got - want).abs().max().item())
        n_cases[name] += 1

    # (rows, groups, dtype, id kind, value kind, (id offset, value
    # offset)): an offset of 1 or 2 elements moves a pointer off 16-byte
    # alignment; unequal offsets put ids and values in different phases
    aligned = (0, 0)
    cases = []
    for ng in (513, 1749, 2048):
        for dtype in (torch.int32, torch.float32):
            cases.append((BLOCK_ROWS, ng, dtype, "random", "random", aligned))
    for dtype in (torch.int32, torch.float32):
        vk = "int_floats" if dtype == torch.float32 else "random"
        cases += [
            (BLOCK_ROWS, 1749, dtype, "all_dropped", "random", aligned),
            (BLOCK_ROWS, 1749, dtype, "hot", vk, aligned),
            (BLOCK_ROWS, 1749, dtype, "out_of_range", "random", aligned),
            (BLOCK_ROWS - 333, 1749, dtype, "random", "random", aligned),
            (1000, 513, dtype, "out_of_range", "random", aligned),
            (BLOCK_ROWS + 3, 1749, dtype, "random", "random", (1, 1)),
            (BLOCK_ROWS + 3, 1749, dtype, "out_of_range", "random", (1, 2)),
            (BLOCK_ROWS, 2048, dtype, "hot", vk, (3, 3)),
        ]
        for rows in (1, 3, 4095):
            for offs in (aligned, (1, 1), (2, 1)):
                cases.append((rows, 1749, dtype, "out_of_range", "random",
                              offs))
    # more rows than one cluster's share, all in one group: int32 wraps
    cases.append((BLOCK_ROWS, 1749, torch.int32, "hot", "wrap", aligned))
    cases.append((BLOCK_ROWS + 3, 1749, torch.int32, "hot", "wrap", (1, 1)))
    for rows, ng, dtype, gk, vk, (go, vo) in cases:
        g = gids(rows + go, ng, gk)[go:]
        for slots in (1, 6, 16, 17, 32, 128):
            v = values(rows + vo, slots, dtype, vk)[vo:]
            label = (f"rows={rows} groups={ng} slots={slots} {dtype} "
                     f"{gk}/{vk} offsets={go},{vo}")
            check("grouped_sum_multi", ck.grouped_sum_multi(v, g, ng),
                  ck.grouped_sum_multi_plain(v, g, ng), dtype, label)
        v = values(rows + vo, 0, dtype, vk)[vo:]
        check("grouped_sum", ck.grouped_sum(v, g, ng),
              ck.grouped_sum_plain(v, g, ng), dtype,
              f"rows={rows} groups={ng} {dtype} {gk}/{vk} offsets={go},{vo}")

    # one call captured into a CUDA graph and replayed three times: each
    # replay must equal the plain version (the launch's ticket resets);
    # then two calls back to back on one stream with other group counts
    g = gids(BLOCK_ROWS + 1, 2048, "random")[1:]
    for name, slots, kfn, pfn in (
            ("grouped_sum_multi", 17, ck.grouped_sum_multi,
             ck.grouped_sum_multi_plain),
            ("grouped_sum_multi", 1, ck.grouped_sum_multi,
             ck.grouped_sum_multi_plain),
            ("grouped_sum", 0, ck.grouped_sum, ck.grouped_sum_plain)):
        v = values(BLOCK_ROWS + 1, slots, torch.int32, "random")[1:]
        kfn(v, g, 1749)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = kfn(v, g, 1749)
        want = pfn(v, g, 1749)
        for i in range(3):
            got.fill_(-1)
            graph.replay()
            check(name, got, want, torch.int32,
                  f"CUDA graph replay {i} slots={slots}")
        a, b = kfn(v, g, 513), kfn(v, g, 2048)
        check(name, a, pfn(v, g, 513), torch.int32,
              f"back to back, 513 groups slots={slots}")
        check(name, b, pfn(v, g, 2048), torch.int32,
              f"back to back, 2048 groups slots={slots}")
    log(f"kernel phase: {n_cases} cases agree with the plain versions; "
        f"max |kernel - plain| (float32) {err}")
    return err


def profiled(fn, attempts: int = 3):
    """(profile, wall seconds) of one call of ``fn`` under
    ``torch.profiler``, the call ending in a device sync. A window that
    recorded no device event at all is a profiler miss (every caller's
    call launches device work): it is taken again, up to ``attempts``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            break
    return prof, wall


def device_kernels_of_one_call(fn) -> list:
    """Names of the device operations (kernels, memsets, copies) that
    one warm call of ``fn`` issues, from a ``torch.profiler`` window."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    prof, _ = profiled(fn)
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def load_baseline(ck, source: str):
    """An earlier grouped_sum.cu with the zero-filled-output interface
    (``ydb_grouped_sum_multi(values, gid, out, rows, slots, groups,
    dtype, stream)``, ``ydb_grouped_sum(values, gid, out, rows, groups,
    dtype, stream)``), built with the same nvcc flags and wrapped as its
    callers did: ``torch.zeros`` for the output, then the launch."""
    import ctypes
    import hashlib

    src = open(source, "rb").read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = ck.BUILD_DIR / f"libbaseline_{tag}.so"
    ck.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-o", str(so), source],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ydb_grouped_sum_multi.argtypes = [p, p, p, ll, i, i, i, p]
    lib.ydb_grouped_sum.argtypes = [p, p, p, ll, i, i, p]
    lib.ydb_grouped_sum_multi.restype = lib.ydb_grouped_sum.restype = i
    code = {torch.int32: 0, torch.float32: 1}

    def multi(values, gid, ng):
        out = torch.zeros((ng, values.shape[1]), dtype=values.dtype,
                          device=values.device)
        rc = lib.ydb_grouped_sum_multi(
            values.data_ptr(), gid.data_ptr(), out.data_ptr(),
            values.shape[0], values.shape[1], ng, code[values.dtype],
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    def single(values, gid, ng):
        out = torch.zeros((ng,), dtype=values.dtype, device=values.device)
        rc = lib.ydb_grouped_sum(
            values.data_ptr(), gid.data_ptr(), out.data_ptr(),
            values.shape[0], ng, code[values.dtype],
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    return {"grouped_sum_multi": multi, "grouped_sum": single}


# ---------------- phase 3: the main path ----------------


def numpy_q1(li, cutoff):
    """Q1 by plain numpy, exact in int64: {(rf, ls): (count, sums...)}."""
    m = li["l_shipdate"] <= cutoff
    rf = li["l_returnflag"][m].astype(np.int64)
    ls = li["l_linestatus"][m].astype(np.int64)
    qty, price = li["l_quantity"][m], li["l_extendedprice"][m]
    disc, tax = li["l_discount"][m], li["l_tax"][m]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    gid = rf * 8 + ls
    out = {}
    for g in np.unique(gid):
        sel = gid == g
        out[(int(g // 8), int(g % 8))] = {
            "count_order": int(sel.sum()),
            "sum_qty": int(qty[sel].sum()),
            "sum_base_price": int(price[sel].sum()),
            "sum_disc_price": int(disc_price[sel].sum()),
            "sum_charge": int(charge[sel].sum()),
            "sum_disc": int(disc[sel].sum()),
        }
    return out


def check_q1(res, want) -> None:
    c = res.cols
    n = res.num_rows
    assert n == len(want), (n, len(want))
    for i in range(n):
        key = (int(c["l_returnflag"][0][i]), int(c["l_linestatus"][0][i]))
        w = want[key]
        for col in ("count_order", "sum_qty", "sum_base_price",
                    "sum_disc_price", "sum_charge"):
            assert int(c[col][0][i]) == w[col], (key, col)
        cnt = w["count_order"]
        for col, num, scale in (("avg_qty", "sum_qty", 100),
                                ("avg_price", "sum_base_price", 100),
                                ("avg_disc", "sum_disc", 100)):
            np.testing.assert_allclose(  # f64 averages: rtol 1e-12
                float(c[col][0][i]), w[num] / scale / cnt, rtol=1e-12)


def numpy_q6(li, d0, d1) -> int:
    m = ((li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
         & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
         & (li["l_quantity"] < 2400))
    return int(np.sum(li["l_extendedprice"][m] * li["l_discount"][m]))


def stage(src, programs, dev):
    """Executors for ``programs`` plus ONE device-resident copy of the
    blocks holding every column any of them reads."""
    from ydb_tpu_torch.engine.scan import ScanExecutor

    exs = [ScanExecutor(p, src, block_rows=BLOCK_ROWS, device=dev)
           for p in programs]
    cols = tuple(dict.fromkeys(c for ex in exs for c in ex.read_cols))
    t0 = time.perf_counter()
    blocks = list(src.blocks(BLOCK_ROWS, cols, device=dev))
    torch.cuda.synchronize()
    return exs, blocks, time.perf_counter() - t0


# ---------------- phase 5: the SQL path ----------------


def sql_database(tp, dev):
    """A port Database over all eight tables of ``tp``, held on ``dev``,
    and the planner's catalog."""
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database
    from ydb_tpu_torch.sql.planner import Catalog
    from ydb_tpu_torch.workload import tpch

    db = Database(
        sources={t: ColumnSource(c, tp.schema(t), tp.dicts).to_device(dev)
                 for t, c in tp.tables.items()},
        dicts=tp.dicts, device=dev)
    catalog = Catalog(schemas={t: tp.schema(t) for t in tp.tables},
                      primary_keys=dict(tpch.PRIMARY_KEYS), dicts=tp.dicts)
    return db, catalog


def plan_sql(sql, db, catalog):
    """Plan one statement; uncorrelated scalar subqueries run on the
    device while it plans (the reference's precompute phase)."""
    from ydb_tpu_torch.plan import execute_plan, to_host
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import plan_select_full

    def scalar_exec(plan, t):
        out = to_host(execute_plan(plan, db))
        v, ok = out.cols[out.schema.names[0]]
        assert len(v) == 1, f"scalar subquery returned {len(v)} rows"
        return v[0].item(), bool(ok[0])

    return plan_select_full(parse(sql), catalog, scalar_exec)


def run_sql(pq, db):
    from ydb_tpu_torch.plan import execute_plan, to_host

    res = to_host(execute_plan(pq.plan, db))
    if db.device is not None and torch.device(db.device).type == "cuda":
        torch.cuda.synchronize()
    res.dict_aliases = pq.dict_aliases
    return res


def golden_digest(out, dicts, fields=None) -> str:
    """sha256 of a result as tests/test_tpch_sql.py pins it (floats
    rounded to 6 places); over ``fields`` only when given."""
    import hashlib

    h = hashlib.sha256()
    for f in out.schema.fields:
        if fields is not None and f.name not in fields:
            continue
        v, ok = out.cols[f.name]
        ok = np.asarray(ok, dtype=bool)
        h.update(f.name.encode())
        if f.type.is_string:
            src = out.dict_aliases.get(f.name, f.name)
            vals = [(x.decode("latin1") if okk else None) for x, okk in zip(
                dicts[src].decode(np.asarray(v, dtype=np.int32)), ok)]
        elif f.type.is_floating:
            vals = [(round(float(x), 6) if okk else None)
                    for x, okk in zip(np.asarray(v), ok)]
        else:
            vals = [(int(x) if okk else None)
                    for x, okk in zip(np.asarray(v), ok)]
        h.update(json.dumps(vals).encode())
    return h.hexdigest()


def golden_check(dev) -> list:
    """All 22 queries at the pinned (sf, seed) on the card against
    tests/golden_tpch.json. A digest that differs only through a float
    column is held against the port's CPU run of the same query (floats
    rtol 1e-12, everything else exact) and reported; any other
    difference fails. Returns those float-column exceptions."""
    from ydb_tpu_torch.workload import tpch
    from ydb_tpu_torch.workload.queries import TPCH

    golden = json.load(open(os.path.join(HERE, "tests", "golden_tpch.json")))
    tp = tpch.TpchData(sf=golden["sf"], seed=golden["seed"])
    db, catalog = sql_database(tp, dev)
    cpu = None
    exceptions = []
    for name, want in golden["queries"].items():
        res = run_sql(plan_sql(TPCH[name], db, catalog), db)
        assert res.num_rows == want["rows"], (name, res.num_rows, want)
        if golden_digest(res, tp.dicts) == want["sha"]:
            continue
        if cpu is None:
            cpu = sql_database(tp, "cpu")
        ref = run_sql(plan_sql(TPCH[name], *cpu), cpu[0])
        assert golden_digest(ref, tp.dicts) == want["sha"], name
        floats = [f.name for f in res.schema.fields if f.type.is_floating]
        others = [f.name for f in res.schema.fields
                  if not f.type.is_floating]
        assert golden_digest(res, tp.dicts, others) == \
            golden_digest(ref, tp.dicts, others), (name, "non-float columns")
        differ = []
        for col in floats:
            (gv, go), (cv, co) = res.cols[col], ref.cols[col]
            assert np.array_equal(go, co), (name, col, "validity")
            np.testing.assert_allclose(gv[go], cv[co], rtol=1e-12,
                                       err_msg=f"{name} {col}")
            if golden_digest(res, tp.dicts, [col]) != \
                    golden_digest(ref, tp.dicts, [col]):
                differ.append(col)
        exceptions.append({"query": name, "float_columns": differ})
        log(f"golden {name}: digest differs on the card only through float "
            f"column(s) {differ}; equal to the CPU run at rtol 1e-12")
    log(f"SQL golden check: {len(golden['queries'])} queries at sf "
        f"{golden['sf']}, seed {golden['seed']} match tests/golden_tpch.json"
        f" on the card ({len(exceptions)} float-column exceptions)")
    return exceptions


def _decoded(res, col, dicts):
    src = res.dict_aliases.get(col, col)
    return dicts[src].decode(np.asarray(res.cols[col][0], dtype=np.int32))


def _ints(res, col):
    return np.asarray(res.cols[col][0]).astype(np.int64)


def check_sql_q1(res, li, dicts):
    check_q1(res, numpy_q1(li, tpch_days("1998-12-01") - 90))
    keys = list(zip(_decoded(res, "l_returnflag", dicts),
                    _decoded(res, "l_linestatus", dicts)))
    assert keys == sorted(keys), keys


def check_sql_q3(res, t, dicts):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    d = tpch_days("1995-03-15")
    cust_ok = c["c_mktsegment"] == dicts["c_mktsegment"].eq_id(b"BUILDING")
    o_ok = (o["o_orderdate"] < d) & cust_ok[o["o_custkey"] - 1]
    oi = li["l_orderkey"] - 1
    m = (li["l_shipdate"] > d) & o_ok[oi]
    rev = np.zeros(len(o_ok), dtype=np.int64)
    np.add.at(rev, oi[m], li["l_extendedprice"][m]
              * (100 - li["l_discount"][m]))
    keys = np.unique(oi[m])
    top = keys[np.lexsort((keys, o["o_orderdate"][keys], -rev[keys]))[:10]]
    assert np.array_equal(_ints(res, "l_orderkey"), top + 1)
    assert np.array_equal(_ints(res, "revenue"), rev[top])
    assert np.array_equal(_ints(res, "o_orderdate"), o["o_orderdate"][top])
    assert np.array_equal(_ints(res, "o_shippriority"),
                          o["o_shippriority"][top])


def check_sql_q5(res, t, dicts):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    s, n, r = t["supplier"], t["nation"], t["region"]
    asia = r["r_regionkey"][r["r_name"] == dicts["r_name"].eq_id(b"ASIA")]
    nation_ok = np.isin(n["n_regionkey"], asia)
    o_ok = ((o["o_orderdate"] >= tpch_days("1994-01-01"))
            & (o["o_orderdate"] < tpch_days("1995-01-01")))
    oi = li["l_orderkey"] - 1
    supp_nat = s["s_nationkey"][li["l_suppkey"] - 1]
    cust_nat = c["c_nationkey"][o["o_custkey"][oi] - 1]
    m = o_ok[oi] & (cust_nat == supp_nat) & nation_ok[supp_nat]
    rev = np.zeros(len(n["n_nationkey"]), dtype=np.int64)
    np.add.at(rev, supp_nat[m], li["l_extendedprice"][m]
              * (100 - li["l_discount"][m]))
    present = np.flatnonzero(np.bincount(supp_nat[m], minlength=len(rev)))
    order = present[np.argsort(-rev[present], kind="stable")]
    assert np.array_equal(_ints(res, "revenue"), rev[order])
    assert _decoded(res, "n_name", dicts) == \
        dicts["n_name"].decode(n["n_name"][order])


def check_sql_q6(res, li):
    want = numpy_q6(li, tpch_days("1994-01-01"), tpch_days("1995-01-01"))
    assert res.num_rows == 1 and int(_ints(res, "revenue")[0]) == want


def check_sql_q13(res, t, dicts):
    import re

    o = t["orders"]
    special = np.array([re.search(b"special.*requests", v, re.S) is not None
                        for v in dicts["o_comment"].values])
    keep = ~special[o["o_comment"]]
    n_cust = len(t["customer"]["c_custkey"])
    per_cust = np.bincount(o["o_custkey"][keep] - 1, minlength=n_cust)
    dist = np.bincount(per_cust)
    counts = np.flatnonzero(dist)
    order = np.lexsort((-counts, -dist[counts]))
    assert np.array_equal(_ints(res, "c_count"), counts[order])
    assert np.array_equal(_ints(res, "custdist"), dist[counts][order])


def check_sql_q18(res, t, dicts):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    # per-order quantity sums stay far below 2^53: exact in float64
    qty = np.bincount(li["l_orderkey"] - 1, weights=li["l_quantity"],
                      minlength=len(o["o_orderkey"])).astype(np.int64)
    big = np.flatnonzero(qty > 300_00)
    top = big[np.lexsort((big, o["o_orderdate"][big],
                          -o["o_totalprice"][big]))[:100]]
    cust = o["o_custkey"][top]
    assert np.array_equal(_ints(res, "o_orderkey"), top + 1)
    assert np.array_equal(_ints(res, "c_custkey"), cust)
    assert np.array_equal(_ints(res, "o_orderdate"), o["o_orderdate"][top])
    assert np.array_equal(_ints(res, "o_totalprice"), o["o_totalprice"][top])
    assert np.array_equal(_ints(res, "total_qty"), qty[top])
    assert _decoded(res, "c_name", dicts) == \
        dicts["c_name"].decode(c["c_name"][cust - 1])


def layer_timers(cache):
    """Wrap the plan walk's layer entry points, and the compiled
    transforms in ``cache``, with host-clock timers, each call bracketed
    by ``torch.cuda.synchronize()``: table scans, joins, transforms and
    concats. Returns (seconds by layer, restore function)."""
    from ydb_tpu_torch.plan import executor
    from ydb_tpu_torch.ssa import join

    totals: dict = {}
    saved = {}

    def timed(layer, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            totals[layer] = totals.get(layer, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    for mod, name, layer in ((executor, "_scan_node", "scan"),
                             (executor, "_materialize", "scan"),
                             (join, "run_equi_join", "join"),
                             (executor, "concat_blocks", "concat")):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, timed(layer, getattr(mod, name)))
    # compiled transforms are cached as (run, aux) pairs
    transforms = {k: v for k, v in cache.items() if isinstance(v, tuple)}
    for k, (run, aux) in transforms.items():
        cache[k] = (timed("transform", run), aux)

    def restore():
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        cache.update(transforms)

    return totals, restore


def profile_sql(pq, db) -> dict:
    """Where one warm run of a planned query spends its time: one run
    under ``torch.profiler`` (device busy time as the union of device
    intervals, its share of the wall time, device operations, the top
    kernels), then one run with the walk's layers timed."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from profile_torch_scan import kernel_stats

    prof, wall = profiled(lambda: run_sql(pq, db))
    busy_us, ops, top = kernel_stats(prof, 3)
    totals, restore = layer_timers(db._compile_cache)
    try:
        t0 = time.perf_counter()
        run_sql(pq, db)
        synced = time.perf_counter() - t0
    finally:
        restore()
    return {"profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall, "device_ops": ops,
            "top_kernels": top, "synced_wall_s": synced,
            "layers_s": dict(sorted(totals.items()))}


def sql_phase(tp, dev, ck) -> list:
    """The 22 queries at the scale of ``tp`` on the card: per query the
    plan time, the first run, three warm runs, result rows, peak device
    memory (reset per query), the CUDA kernels' launches (counted from
    zero for the query's first run and read just after it), and where a
    warm run's time goes (``profile_sql``)."""
    from ydb_tpu_torch.workload.queries import TPCH

    t = tp.tables
    for table, key in (("orders", "o_orderkey"), ("customer", "c_custkey"),
                       ("supplier", "s_suppkey")):
        # the numpy checks index these tables by key - 1
        assert np.array_equal(t[table][key],
                              np.arange(1, len(t[table][key]) + 1)), table
    t0 = time.perf_counter()
    db, catalog = sql_database(tp, dev)
    torch.cuda.synchronize()
    log(f"SQL: {len(t)} tables ({sum(len(next(iter(c.values()))) for c in t.values())} rows) "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    checks = {
        "q1": lambda r: check_sql_q1(r, t["lineitem"], tp.dicts),
        "q3": lambda r: check_sql_q3(r, t, tp.dicts),
        "q5": lambda r: check_sql_q5(r, t, tp.dicts),
        "q6": lambda r: check_sql_q6(r, t["lineitem"]),
        "q13": lambda r: check_sql_q13(r, t, tp.dicts),
        "q18": lambda r: check_sql_q18(r, t, tp.dicts),
    }
    rows = []
    for name in sorted(TPCH, key=lambda q: int(q[1:])):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pq = plan_sql(TPCH[name], db, catalog)
        plan_s = time.perf_counter() - t0
        ck.reset_launches()
        t0 = time.perf_counter()
        res = run_sql(pq, db)
        first_s = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = run_sql(pq, db)
            warm.append(time.perf_counter() - t0)
        assert again.num_rows == res.num_rows, name
        peak = torch.cuda.max_memory_allocated(dev)
        prof = profile_sql(pq, db)
        checked = name in checks
        if checked:
            checks[name](res)
        row = {"query": name, "sf": tp.sf, "rows": res.num_rows,
               "plan_s": plan_s, "first_s": first_s,
               "warm_median_s": statistics.median(warm), "warm_s": warm,
               "warm_spread": max(warm) / min(warm),
               "peak_device_bytes": peak, "resident_bytes": base,
               "query_peak_bytes": peak - base, "launches": launches,
               "numpy_checked": checked, **prof}
        rows.append(row)
        log(json.dumps({"sql": row}))
    return rows


def tpch_days(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor (default 10)")
    ap.add_argument("--sql-sf", type=float, default=None,
                    help="TPC-H scale factor of the SQL phase (default: "
                    "--sf, reusing the scan phase's tables)")
    ap.add_argument("--hits-rows", type=int, default=10_000_000,
                    help="ClickBench hits rows (published: 99997497)")
    ap.add_argument("--json-out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--baseline-source", default=None,
                    help="an earlier grouped_sum.cu with the zero-filled-"
                    "output interface, timed beside the kernels in the "
                    "same run (see load_baseline)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.ssa import cuda_kernels as ck
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.workload import clickbench, tpch

    dev = torch.device("cuda", 0)
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; {smi}")
    report: dict = {"device": kind, "nvidia_smi": smi}

    # ---- phase 2 ----
    max_err = kernel_phase(ck, dev)

    # ---- phase 3: stage data ----
    t0 = time.perf_counter()
    tp = tpch.TpchData(sf=args.sf, seed=42)
    li = tp.tables["lineitem"]
    n_li = len(li["l_orderkey"])
    li_src = ColumnSource(li, tpch.LINEITEM_SCHEMA, tp.dicts)
    (ex1, ex6), li_blocks, li_stage_s = stage(
        li_src, (tpch.q1_program(), tpch.q6_program()), dev)
    log(f"TPC-H sf={args.sf}: {n_li} lineitem rows generated+staged in "
        f"{time.perf_counter() - t0:.1f} s ({len(li_blocks)} blocks; "
        f"staging {li_stage_s:.2f} s)")
    t0 = time.perf_counter()
    cb = clickbench.ClickBenchData(rows=args.hits_rows, seed=42)
    cb_src = ColumnSource(cb.hits, clickbench.HITS_SCHEMA, cb.dicts)
    (ex33, ex36), cb_blocks, cb_stage_s = stage(
        cb_src, (clickbench.q33_program(), clickbench.q36_program()), dev)
    log(f"ClickBench: {args.hits_rows} hits rows generated+staged in "
        f"{time.perf_counter() - t0:.1f} s ({len(cb_blocks)} blocks; "
        f"URL dictionary {len(cb.dicts['URL'])}; q33 layout "
        f"{ex33.partial.group_layout})")
    assert ex33.partial.group_layout == ("dense", len(cb.dicts["URL"]) + 1)

    runs = [
        ("q1", ex1, li_blocks, None),
        ("q6", ex6, li_blocks, None),
        ("q33_fused", ex33, cb_blocks, True),
        ("q36_fused", ex36, cb_blocks, True),
        ("q33_peragg", ex33, cb_blocks, False),
        ("q36_peragg", ex36, cb_blocks, False),
    ]

    def drive(ex, blocks, fused):
        kernels.FUSED_FORCE = fused
        try:
            out = ex.run_stream(blocks)
            torch.cuda.synchronize()
            return out
        finally:
            kernels.FUSED_FORCE = None

    # ---- phase 3: the main path, counted ----
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launches()
    outs, per_query = {}, {}
    for name, ex, blocks, fused in runs:
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        outs[name] = drive(ex, blocks, fused)
        per_query[name] = {
            "seconds": time.perf_counter() - t0,
            "launches": {k: ck.LAUNCHES[k] - before[k] for k in before}}
    launches = dict(ck.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    log(f"main path peak device memory: {peak_bytes} bytes (staged blocks "
        "included)")
    log(f"main path launches: {launches}; per query: "
        + json.dumps({k: v["launches"] for k, v in per_query.items()}))
    for name in ("q33_fused", "q36_fused"):
        assert per_query[name]["launches"]["grouped_sum_multi"] > 0, name
    for name in ("q33_peragg", "q36_peragg"):
        assert per_query[name]["launches"]["grouped_sum"] > 0, name
    assert all(v > 0 for v in launches.values()), launches

    # ---- phase 3: results ----
    from ydb_tpu_torch.engine.oracle import OracleTable

    res = {k: OracleTable.from_block(v) for k, v in outs.items()}
    check_q1(res["q1"], numpy_q1(li, tpch._days("1998-12-01") - 90))
    want6 = numpy_q6(li, tpch._days("1994-01-01"), tpch._days("1995-01-01"))
    assert res["q6"].num_rows == 1
    assert int(res["q6"].cols["revenue"][0][0]) == want6
    answers = clickbench.q33_q36_answers(cb)
    for name, col in (("q33_fused", "c"), ("q36_fused", "pv"),
                      ("q33_peragg", "c"), ("q36_peragg", "pv")):
        r = res[name]
        got = list(zip(cb.dicts["URL"].decode(r.cols["URL"][0]),
                       (int(x) for x in r.cols[col][0])))
        assert got == answers[name[:3]], (name, got[:3])
    log("main path results: Q1/Q6 equal numpy (ints exact, averages rtol "
        "1e-12); q33/q36 fused and per-aggregate equal the numpy answers")

    # ---- phase 4: warm timings ----
    metrics, warm_runs = {}, {}
    for name, ex, blocks, fused in runs:
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            drive(ex, blocks, fused)
            ts.append(time.perf_counter() - t0)
        n = n_li if name in ("q1", "q6") else args.hits_rows
        metrics[f"{name}_warm_rows_per_s"] = n / statistics.median(ts)
        metrics[f"{name}_warm_s"] = statistics.median(ts)
        warm_runs[name] = ts
    log("warm: " + json.dumps(metrics))
    log("warm runs, seconds each: " + json.dumps(warm_runs))

    # per-kernel time at the main path's shape: one 1<<20-row block of
    # q33, group ids = dense URL slots (zipf-skewed), int32 count values
    ng = len(cb.dicts["URL"]) + 1
    url = torch.from_numpy(cb.hits["URL"][:BLOCK_ROWS]).to(dev)
    g = (url + 1).to(torch.int32)
    rows = g.shape[0]
    idx64 = g.long()
    ones = torch.ones(rows, dtype=torch.int32, device=dev)
    ones2 = ones[:, None].contiguous()
    buf = torch.zeros(ng + 1, dtype=torch.int32, device=dev)
    buf2 = torch.zeros(ng + 1, 1, dtype=torch.int32, device=dev)
    baseline = (load_baseline(ck, args.baseline_source)
                if args.baseline_source else None)
    kernel_rows = []
    for name, kfn, pfn, lfn, vals in (
        ("grouped_sum_multi", ck.grouped_sum_multi, ck.grouped_sum_multi_plain,
         lambda: buf2.index_add_(0, idx64, ones2), ones2),
        ("grouped_sum", ck.grouped_sum, ck.grouped_sum_plain,
         lambda: buf.index_add_(0, idx64, ones), ones),
    ):
        slots = 1 if vals.ndim == 1 else vals.shape[1]
        bound_ms, bound_by = bound(rows, slots, ng)
        # one call, one device launch: no fill or memset beside the kernel
        issued = device_kernels_of_one_call(lambda: kfn(vals, g, ng))
        assert len(issued) == 1 and "grouped_sum_kernel" in issued[0], issued
        # plain, kernel, kernel, plain: compare within one call
        p1, k1, k2, p2 = (device_ms(f) for f in (
            lambda: pfn(vals, g, ng), lambda: kfn(vals, g, ng),
            lambda: kfn(vals, g, ng), lambda: pfn(vals, g, ng)))
        sets = cold_sets((vals, g), vals.nbytes + g.nbytes)
        cold = device_ms([(lambda vv=vv, gg=gg: kfn(vv, gg, ng))
                          for vv, gg in sets])
        lib = device_ms(lfn)
        call = time_ms(lambda: kfn(vals, g, ng))
        row = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": statistics.median([k1, k2]),
            "plain_ms": statistics.median([p1, p2]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib,
            "cold_ms": cold, "bound_share": bound_ms / cold,
            "call_ms": call, "device_ops_per_call": issued,
        }
        msg = (f"{name} @ rows={rows} groups={ng} slots={slots}: device time "
               f"kernel {k1:.5f}/{k2:.5f} ms, cold {cold:.5f} ms, plain "
               f"{p1:.5f}/{p2:.5f} ms, index_add_ {lib:.5f} ms, bound "
               f"{bound_ms:.5f} ms ({bound_ms / cold:.3f} of it cold); "
               f"host-inclusive kernel call {call:.5f} ms; one call issues "
               f"{issued}")
        if baseline:
            bfn = baseline[name]
            assert torch.equal(bfn(vals, g, ng), pfn(vals, g, ng)), name
            b1, b2 = (device_ms(lambda: bfn(vals, g, ng)) for _ in range(2))
            row["baseline_ms"] = statistics.median([b1, b2])
            row["baseline_cold_ms"] = device_ms(
                [(lambda vv=vv, gg=gg: bfn(vv, gg, ng)) for vv, gg in sets])
            row["baseline_device_ops_per_call"] = device_kernels_of_one_call(
                lambda: bfn(vals, g, ng))
            row["baseline_call_ms"] = time_ms(lambda: bfn(vals, g, ng))
            msg += (f"; baseline {b1:.5f}/{b2:.5f} ms, cold "
                    f"{row['baseline_cold_ms']:.5f} ms, host-inclusive call "
                    f"{row['baseline_call_ms']:.5f} ms, one call issues "
                    f"{row['baseline_device_ops_per_call']}")
        del sets
        kernel_rows.append(row)
        log(msg)
    sweep_rows = sweep(ck, baseline, g, ng, dev)
    metrics["q33_fused_launches_per_run"] = per_query["q33_fused"]["launches"]
    metrics["q33_peragg_launches_per_run"] = per_query["q33_peragg"]["launches"]

    # ---- phase 5: the SQL path ----
    del li_blocks, cb_blocks, outs, ex1, ex6, ex33, ex36, runs
    torch.cuda.empty_cache()
    exceptions = golden_check(dev)
    sql_tp = (tp if args.sql_sf in (None, args.sf)
              else tpch.TpchData(sf=args.sql_sf, seed=42))
    sql_rows = sql_phase(sql_tp, dev, ck)
    sql_launches = {k: sum(r["launches"][k] for r in sql_rows)
                    for k in ck.LAUNCHES}
    log(f"SQL path: 22 queries at sf {sql_tp.sf} on the card; Q1, Q3, Q5, "
        f"Q6, Q13, Q18 equal numpy; CUDA kernel launches over all first "
        f"runs {sql_launches}")
    for row in kernel_rows:
        row["sql_launches"] = sql_launches[row["name"]]

    report.update(metrics=metrics, warm_runs=warm_runs, per_query=per_query,
                  kernels=kernel_rows, sweep=sweep_rows,
                  peak_device_bytes=peak_bytes,
                  sf=args.sf, lineitem_rows=n_li, hits_rows=args.hits_rows,
                  sql=sql_rows, sql_sf=sql_tp.sf,
                  sql_golden_float_exceptions=exceptions)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
