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
   plan walk (scans, joins, transforms; synced host clock). This phase
   runs the walk (``execute_plan(..., use_dq=False)``).
6. DQ path: the 22 queries through the default routing, which sends the
   20 join-bearing plans through the DQ stage graph (``dq/compute.py``:
   credit-flow compute actors, hash-partitioned host channels, spilling).
   First at sf 0.01, seed 11 against the goldens, once at the reference's
   2 tasks and 1<<20-row blocks and once at 3 tasks and 1<<12-row blocks;
   then over phase 5's tables on the card, one ``{"sql_dq": ...}`` line
   per query: the executor that answered, stages and tasks, plan, first
   and warm seconds (eager torch: a first run compiles nothing), peak
   device memory above the tables, bytes through the channel payloads
   each way, rows hashed, parked payloads, ``spill_count``, the kernels'
   launches, the busy share and seconds per DQ layer of one more warm
   run (``dq_instruments``). Every query's first run is made, counted
   and checked: its result must equal phase 5's walk result, and Q3, Q5,
   Q13 and Q18 also equal numpy. The warm runs (three, one where the
   first run took over ``DQ_SLOW_FIRST_S``) and the profiled run are
   made while the script stays under ``DQ_EXTRAS_BUDGET_S``, so the run
   ends inside its time limit; ``--dq-warm N`` makes them for every
   query. Phases 5 and 6 pin whole-plan fusion off
   (``plan_fuse.FUSE_FORCE = False``): at sf 0.01 it would answer every
   ``use_dq=False`` statement, and it declines the SF-10 tables anyway.
7. Whole-plan fusion (``ssa/plan_fuse.py``: one CUDA graph replay per
   statement), at the largest size the reference routes to it: every
   table at most ``FUSE_MAX_ROWS`` (131,072) rows. It runs after the DQ
   phase, so ``DQ_EXTRAS_BUDGET_S`` (counted from the script's start)
   is untouched and the run grows by this phase's own time. First the
   goldens through ``execute_plan(..., use_dq=False)`` with fusion on
   (every statement fused, each equal to the walk); then TPC-H at sf
   0.02 (120,088 lineitem rows at seed 42, all eight tables on the
   card) and the 43 ClickBench queries at 131,072 hits rows, seed 42,
   each statement fused (``use_dq=False``) and walked: one
   ``{"fused": ...}`` or ``{"clickbench": ...}`` line per query with the
   executor, fused stages, first-run and capture seconds, the medians of
   ``FUSION_WARM`` warm runs of each path and their ratio, graph replays
   per warm statement (must be 1) and grows, the CUDA kernels' launches
   (a replay counts the kernels its graph holds), device operations and
   busy share of one more warm run (``torch.profiler``), peak memory
   and the graph pools' bytes. Every fused result equals the walk's; the
   TPC-H ones equal the goldens (above) and the ClickBench ones the
   numpy canondata (``reference_answers``), also through the default
   routing (fusion for 41 queries, DQ for the two self-joined
   COUNT(DISTINCT) plans). ``GROUP BY URL`` queries on the per-aggregate
   lowering put ``grouped_sum`` inside graphs too. Then ``run_shared``
   and ``run_stacked`` at B = 4 (TPC-H q1, q6, ClickBench q33: every
   member's slice equals its serial run), and a cutoff sweep (q1, q3,
   q6, ClickBench q33 fused and walked at 16K, 64K, 131K and 1M rows,
   ``FUSE_MAX_ROWS`` raised in-process for the last point only; one
   ``{"sweep_fusion": ...}`` line each).

The last lines are a ``{"kernels": [...]}`` JSON line, the nvidia-smi line
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
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


STARTED = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the script began."""
    print(f"[{time.perf_counter() - STARTED:7.1f} s] {msg}", flush=True)


def emit(obj: dict) -> None:
    """A JSON line of results (no stamp, so it parses as it stands)."""
    print(json.dumps(obj), flush=True)


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
            emit({"sweep": row})
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


def plan_sql(sql, db, catalog, use_dq=None):
    """Plan one statement; uncorrelated scalar subqueries run on the
    device while it plans (the reference's precompute phase), routed as
    ``use_dq`` says (None: the default routing, DQ for joins)."""
    from ydb_tpu_torch.plan import execute_plan, to_host
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import plan_select_full

    def scalar_exec(plan, t):
        out = to_host(execute_plan(plan, db, use_dq=use_dq))
        v, ok = out.cols[out.schema.names[0]]
        assert len(v) == 1, f"scalar subquery returned {len(v)} rows"
        return v[0].item(), bool(ok[0])

    return plan_select_full(parse(sql), catalog, scalar_exec)


def run_sql(pq, db, use_dq=None):
    from ydb_tpu_torch.plan import execute_plan, to_host

    res = to_host(execute_plan(pq.plan, db, use_dq=use_dq))
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


def golden_check(dev, use_dq=False, stats=None, fuse=False) -> list:
    """All 22 queries at the pinned (sf, seed) on the card against
    tests/golden_tpch.json, through the walk (``use_dq=False``) or the
    default routing (``use_dq=None``: the DQ stage graph for every
    join-bearing plan, which ``stats`` then checks and counts; see
    ``dq_instruments``), with whole-plan fusion pinned off; with ``fuse``,
    through ``use_dq=False`` with fusion on, every statement answered by
    a fused plan and each result also equal to the walk's. A digest that
    differs only through a float column is held against the port's CPU
    run of the same query by the same route (floats rtol 1e-12,
    everything else exact) and reported; any other difference fails.
    Returns those float-column exceptions."""
    with fusion_force(None if fuse else False):
        return _golden_check(dev, use_dq, stats, fuse)


def _golden_check(dev, use_dq, stats, fuse) -> list:
    from ydb_tpu_torch.workload import tpch
    from ydb_tpu_torch.workload.queries import TPCH

    golden = json.load(open(os.path.join(HERE, "tests", "golden_tpch.json")))
    tp = tpch.TpchData(sf=golden["sf"], seed=golden["seed"])
    db, catalog = sql_database(tp, dev)
    cpu = None
    exceptions = []
    for name, want in golden["queries"].items():
        pq = plan_sql(TPCH[name], db, catalog, use_dq)
        if fuse:
            with routed() as seen:
                res = run_sql(pq, db, use_dq)
            assert seen == ["fused"], (name, seen)
            with fusion_force(False):
                same_result(res, run_sql(pq, db, use_dq), name)
            drop_fused(db)
        elif stats is None:
            res = run_sql(pq, db, use_dq)
        else:
            with dq_instruments() as st:
                res = run_sql(pq, db, use_dq)
            assert st["executor"] == ("walk" if name in ("q1", "q6")
                                      else "dq"), (name, st["executor"])
            for k in ("hash_splits", "parked", "spill_count",
                      "multi_block_channels"):
                stats[k] = stats.get(k, 0) + st[k]
        assert res.num_rows == want["rows"], (name, res.num_rows, want)
        if golden_digest(res, tp.dicts) == want["sha"]:
            continue
        if cpu is None:
            cpu = sql_database(tp, "cpu")
        ref = run_sql(plan_sql(TPCH[name], *cpu, use_dq), cpu[0], use_dq)
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
    route = ("fused" if fuse else "walk" if use_dq is False
             else "default routing")
    log(f"SQL golden check ({route}): {len(golden['queries'])} queries at sf {golden['sf']}, seed "
        f"{golden['seed']} match tests/golden_tpch.json on the card "
        f"({len(exceptions)} float-column exceptions)")
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


def busy_share(run) -> dict:
    """One call of ``run`` under ``torch.profiler``: device busy time as
    the union of device intervals, its share of the wall time, device
    operations, the top kernels."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from profile_torch_scan import kernel_stats

    prof, wall = profiled(run)
    busy_us, ops, top = kernel_stats(prof, 3)
    return {"profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall, "device_ops": ops,
            "top_kernels": top}


def profile_sql(pq, db) -> dict:
    """Where one warm walk of a planned query spends its time: one run
    under ``torch.profiler`` (``busy_share``), then one run with the
    walk's layers timed."""
    busy = busy_share(lambda: run_sql(pq, db, False))
    totals, restore = layer_timers(db._compile_cache)
    try:
        t0 = time.perf_counter()
        run_sql(pq, db, False)
        synced = time.perf_counter() - t0
    finally:
        restore()
    return {**busy, "synced_wall_s": synced,
            "layers_s": dict(sorted(totals.items()))}


def sql_phase(tp, dev, ck):
    """The 22 queries at the scale of ``tp`` on the card through the
    walk: per query the plan time, the first run, three warm runs, result
    rows, peak device memory (reset per query), the CUDA kernels'
    launches (counted from zero for the query's first run and read just
    after it), and where a warm run's time goes (``profile_sql``).
    Returns the rows, the database and catalog, and each query's result
    (the DQ phase holds its results against them). Whole-plan fusion is
    pinned off (at sf 0.01 it would answer every ``use_dq=False``
    statement)."""
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
    with fusion_force(False):
        rows, results = _sql_phase_queries(tp, db, catalog, checks, dev, ck)
    return rows, db, catalog, checks, results


def _sql_phase_queries(tp, db, catalog, checks, dev, ck):
    from ydb_tpu_torch.workload.queries import TPCH

    rows, results = [], {}
    for name in sorted(TPCH, key=lambda q: int(q[1:])):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pq = plan_sql(TPCH[name], db, catalog, False)
        plan_s = time.perf_counter() - t0
        ck.reset_launches()
        t0 = time.perf_counter()
        res = run_sql(pq, db, False)
        first_s = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        results[name] = res
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = run_sql(pq, db, False)
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
        emit({"sql": row})
    return rows, results


# ---------------- phase 6: the DQ stage graph ----------------


#: a DQ query whose first run took longer than this gets one warm run,
#: not three, unless ``--dq-warm`` says otherwise
DQ_SLOW_FIRST_S = 2.0

#: the DQ phase's warm and profiled runs (beyond each query's first,
#: checked run) are made only while the script's clock, with them, stays
#: under this: the whole run then ends well inside its time limit
DQ_EXTRAS_BUDGET_S = 650.0

#: the DQ layers that ``dq_instruments(timed=True)`` times, by the port
#: function that does each layer's work (module or class, attribute)
DQ_LAYERS = (
    ("source_blocks", "ComputeActor", "_pump_source"),
    ("block_program", "_CompiledStage", "run_block"),
    ("payload_fetch", None, "block_to_payload"),
    ("hash", None, "_hash_rows"),
    ("split", None, "_split_by_hash"),
    ("payload_to_block", None, "payload_to_block"),
    ("payload_to_block", None, "_assemble"),
    ("join", "_CompiledStage", "run_join"),
    ("finalize", "_CompiledStage", "run_final"),
    ("spill", "Spiller", "put"),
    ("spill", "Spiller", "get"),
)


class dq_instruments:
    """Wrap the port's DQ functions for one statement, from outside the
    package: which executor answered (``_execute_plan_dq`` returned a
    block or fell back), the graph's stages and tasks, bytes fetched to
    the host (``block_to_payload``) and sent back (``payload_to_block``,
    ``_assemble``), rows hashed, channel payloads parked behind the
    credit window, channels that carried more than one block, and the
    spillers' ``spill_count``. With ``timed``, each layer of
    ``DQ_LAYERS`` is also timed on the host clock with a
    ``torch.cuda.synchronize()`` on both sides of every call; nested
    calls are charged to the inner layer only, so the layers and
    ``other`` add up to the statement's wall time."""

    def __init__(self, timed: bool = False):
        self.timed = timed

    def __enter__(self) -> dict:
        from ydb_tpu_torch.dq import compute, spilling
        from ydb_tpu_torch.plan import executor

        st = self.stats = {
            "executor": "walk", "stages": 0, "tasks": 0,
            "bytes_to_host": 0, "bytes_to_device": 0, "rows_hashed": 0,
            "hash_splits": 0, "parked": 0, "spill_count": 0,
            "multi_block_channels": 0, "layers_s": {}}
        self.handles = []
        owners = {None: compute, "ComputeActor": compute.ComputeActor,
                  "_CompiledStage": compute._CompiledStage,
                  "Spiller": spilling.Spiller}
        self.saved = []
        stack: list = []
        timed = self.timed

        def patch(owner, name, wrapper):
            real = getattr(owner, name)
            self.saved.append((owner, name, real))
            setattr(owner, name, wrapper(real))

        def layer(name, count=None):
            def wrapper(real):
                def call(*a, **k):
                    if timed:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        stack.append(0.0)
                    try:
                        out = real(*a, **k)
                    finally:
                        if timed:
                            torch.cuda.synchronize()
                            took = time.perf_counter() - t0
                            inner = stack.pop()
                            ls = st["layers_s"]
                            ls[name] = ls.get(name, 0.0) + took - inner
                            if stack:
                                stack[-1] += took
                    if count is not None:
                        count(a, out)
                    return out
                return call
            return wrapper

        def nbytes(payloads):
            return sum(v.nbytes for p in payloads for v in p.values())

        def add(key, n):
            st[key] += n

        counters = {
            "block_to_payload": lambda a, out: add("bytes_to_host",
                                                   nbytes([out])),
            "payload_to_block": lambda a, out: add("bytes_to_device",
                                                   nbytes([a[0]])),
            "_assemble": lambda a, out: add("bytes_to_device",
                                            nbytes(a[0])),
            "_hash_rows": lambda a, out: add("rows_hashed", len(out)),
            "_split_by_hash": lambda a, out: add("hash_splits",
                                                 int(a[2] > 1)),
        }
        for lname, owner, name in DQ_LAYERS:
            patch(owners[owner], name, layer(lname, counters.get(name)))

        def send(real):
            def call(actor, ch, payload):
                if actor._unacked[ch] >= actor.window:
                    st["parked"] += 1
                return real(actor, ch, payload)
            return call

        def build(real):
            def call(*a, **k):
                handle = real(*a, **k)
                self.handles.append(handle)
                return handle
            return call

        def answered(real):
            def call(plan, db):
                out = real(plan, db)
                if out is not None:
                    st["executor"] = "dq"
                return out
            return call

        patch(compute.ComputeActor, "_send_channel", send)
        patch(compute, "build_stage_graph", build)
        patch(executor, "_execute_plan_dq", answered)
        self.t0 = time.perf_counter()
        return st

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t0
        for owner, name, real in reversed(self.saved):
            setattr(owner, name, real)
        st = self.stats
        for h in self.handles:
            st["stages"] += len({t.stage for t in h.tasks})
            st["tasks"] += len(h.tasks)
            for a in h.actors:
                st["spill_count"] += a.spiller.spill_count
                # every channel's last seq is its finish message
                st["multi_block_channels"] += sum(
                    n > 2 for n in a._next_seq.values())
        if self.timed:
            st["layers_s"] = dict(sorted(st["layers_s"].items()))
            st["wall_s"] = wall
            st["layers_s"]["other"] = wall - sum(st["layers_s"].values())
        return False


def dq_golden_check(dev) -> dict:
    """The 22 queries at sf 0.01, seed 11 through the default routing
    against tests/golden_tpch.json: once with the reference's DQ defaults
    (2 tasks, 1<<20-row blocks), once with 3 tasks and 1<<12-row blocks
    (hash splits, parked channel payloads and multi-block channels then
    happen on the card, and are counted)."""
    from ydb_tpu_torch.plan import executor

    out = {}
    saved = executor.DQ_TASKS, executor.DQ_BLOCK_ROWS
    for tasks, rows in ((2, 1 << 20), (3, 1 << 12)):
        executor.DQ_TASKS, executor.DQ_BLOCK_ROWS = tasks, rows
        stats: dict = {}
        try:
            exc = golden_check(dev, use_dq=None, stats=stats)
        finally:
            executor.DQ_TASKS, executor.DQ_BLOCK_ROWS = saved
        key = f"tasks{tasks}_rows{rows}"
        out[key] = {"float_exceptions": exc, **stats}
        log(f"DQ golden check, {tasks} tasks, {rows}-row blocks: 20 "
            f"join-bearing queries answered by the DQ stage graph, q1/q6 "
            f"by the walk; {json.dumps(stats)}")
    return out


def same_result(got, want, name) -> None:
    """``got`` equals ``want``: the same columns and rows in the same
    order, validity, integers and dictionary ids exact, float64 within
    rtol 1e-12 (partial sums merge in another order)."""
    assert list(got.schema.names) == list(want.schema.names), name
    assert got.num_rows == want.num_rows, (name, got.num_rows, want.num_rows)
    for col in want.schema.names:
        (gv, go), (wv, wo) = got.cols[col], want.cols[col]
        assert np.array_equal(go, wo), (name, col, "validity")
        assert gv.dtype == wv.dtype, (name, col, gv.dtype, wv.dtype)
        if np.issubdtype(wv.dtype, np.floating):
            np.testing.assert_allclose(gv[wo], wv[wo], rtol=1e-12,
                                       err_msg=f"{name} {col}")
        else:
            assert np.array_equal(gv[wo], wv[wo]), (name, col)


def dq_phase(tp, db, catalog, dev, ck, walk, checks, n_warm=None) -> list:
    """The 22 queries at the scale of ``tp`` through the default routing
    (the DQ stage graph for the 20 join-bearing ones, at the reference's
    2 tasks and 1<<20-row blocks), over the tables ``db`` holds on the
    card. Per query, always: which executor answered, stages and tasks,
    plan seconds, the first run (CUDA kernel launches counted from zero
    for it and read just after; channel bytes, rows hashed, parked
    payloads and spills counted in it), peak device memory above the
    resident tables in it, and the checks: the result must equal the
    walk's (``walk``) and pass the numpy check of its query in
    ``checks``; a join-bearing query the walk answered fails the run.
    Then, while the script's clock stays under ``DQ_EXTRAS_BUDGET_S``:
    warm runs (three, or one where the first run took over
    ``DQ_SLOW_FIRST_S``) and one more warm run under ``torch.profiler``
    with the DQ layers timed (``dq_instruments``: the device busy share
    of its wall time, and the seconds per layer); their fields are null
    for a query past the budget. ``n_warm`` forces that many warm runs
    and the profiled run for every query, budget or not."""
    from ydb_tpu_torch.workload.queries import TPCH

    rows = []
    for name in sorted(TPCH, key=lambda q: int(q[1:])):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pq = plan_sql(TPCH[name], db, catalog)
        plan_s = time.perf_counter() - t0
        ck.reset_launches()
        with dq_instruments() as counts:
            t0 = time.perf_counter()
            res = run_sql(pq, db)
            first_s = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        assert counts["executor"] == ("walk" if name in ("q1", "q6")
                                      else "dq"), (name, counts)
        same_result(res, walk[name], name)
        if name in checks:
            checks[name](res)
        row = {"query": name, "sf": tp.sf, "executor": counts["executor"],
               "stages": counts["stages"], "tasks": counts["tasks"],
               "rows": res.num_rows, "plan_s": plan_s, "first_s": first_s,
               "warm_median_s": None, "warm_s": [], "warm_spread": None,
               "peak_device_bytes": peak, "resident_bytes": base,
               "query_peak_bytes": peak - base,
               "bytes_to_host": counts["bytes_to_host"],
               "bytes_to_device": counts["bytes_to_device"],
               "rows_hashed": counts["rows_hashed"],
               "hash_splits": counts["hash_splits"],
               "parked": counts["parked"],
               "spill_count": counts["spill_count"],
               "launches": launches, "equals_walk": True,
               "numpy_checked": name in checks, "device_busy_share": None,
               "layers_s": None}
        runs = n_warm or (1 if first_s > DQ_SLOW_FIRST_S else 3)
        if n_warm or (time.perf_counter() - STARTED + (runs + 1) * first_s
                      <= DQ_EXTRAS_BUDGET_S):
            warm = []
            for _ in range(runs):
                t0 = time.perf_counter()
                again = run_sql(pq, db)
                warm.append(time.perf_counter() - t0)
                assert again.num_rows == res.num_rows, name
            layered: dict = {}

            def timed_run():
                with dq_instruments(timed=True) as st:
                    run_sql(pq, db)
                layered.update(st)

            row.update(warm_median_s=statistics.median(warm), warm_s=warm,
                       warm_spread=max(warm) / min(warm),
                       **busy_share(timed_run),
                       synced_wall_s=layered["wall_s"],
                       layers_s=layered["layers_s"])
        rows.append(row)
        emit({"sql_dq": row})
    return rows


# ---------------- phase 7: whole-plan fusion ----------------


#: TPC-H scale of the fused measurement: lineitem then has 120,088 rows,
#: the largest scale whose tables all stay under plan_fuse.FUSE_MAX_ROWS
FUSION_SF = 0.02
#: ClickBench hits rows of the fused measurement: FUSE_MAX_ROWS itself
FUSION_HITS_ROWS = 1 << 17
#: warm runs per statement and path
FUSION_WARM = 10
#: the cutoff sweep: rows of lineitem / hits, and the TPC-H scale that
#: gives about that many lineitem rows (the 131K point reuses FUSION_SF)
SWEEP_POINTS = ((16384, 0.0027), (65536, 0.0109), (131072, FUSION_SF),
                (1 << 20, 0.1667))
SWEEP_QUERIES = ("q1", "q3", "q6", "cb_q33")


class fusion_force:
    """``plan_fuse.FUSE_FORCE = force`` for a block, restored after."""

    def __init__(self, force):
        self.force = force

    def __enter__(self):
        from ydb_tpu_torch.ssa import plan_fuse

        self.saved = plan_fuse.FUSE_FORCE
        plan_fuse.FUSE_FORCE = self.force

    def __exit__(self, *exc):
        from ydb_tpu_torch.ssa import plan_fuse

        plan_fuse.FUSE_FORCE = self.saved
        return False


class routed:
    """Record which executor answered each statement in the block
    ("fused", "dq"; "walk" when neither did), by wrapping the executor's
    two entry points from outside the package."""

    def __enter__(self) -> list:
        from ydb_tpu_torch.plan import executor

        self.seen: list = []
        self.saved = {}
        for name in ("_execute_plan_fused", "_execute_plan_dq"):
            real = self.saved[name] = getattr(executor, name)

            def call(plan, db, _real=real, _kind=name.rsplit("_", 1)[-1]):
                out = _real(plan, db)
                if out is not None:
                    self.seen.append(_kind)
                return out

            setattr(executor, name, call)
        return self.seen

    def __exit__(self, *exc):
        from ydb_tpu_torch.plan import executor

        for name, real in self.saved.items():
            setattr(executor, name, real)
        return False


def fused_plans(db) -> list:
    """The FusedPlans cached in ``db``."""
    return [v for k, v in db._compile_cache.items()
            if isinstance(k, tuple) and k and k[0] == "plan_fuse"]


def drop_fused(db) -> None:
    """Free every cached FusedPlan of ``db`` with its graphs and pools."""
    for k in [k for k in db._compile_cache
              if isinstance(k, tuple) and k and k[0] == "plan_fuse"]:
        for cap in db._compile_cache.pop(k)._graphs.values():
            cap.graph.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def timed_runs(fn, n: int) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def fused_statement(name, pq, db, ck, dev) -> tuple:
    """One statement (planned, ``pq``) through the fused path
    (``use_dq=False``, fusion on) and through the walk over ``db``: the
    fused first run (a capture) with the CUDA kernels' launches counted
    from zero, ``FUSION_WARM`` warm runs of each path, one more fused run
    under ``torch.profiler``. The fused result must equal the walk's.
    Returns (row, fused result, walk result)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = set(map(id, fused_plans(db)))
    with fusion_force(None), routed() as seen:
        ck.reset_launches()
        t0 = time.perf_counter()
        res = run_sql(pq, db, False)
        first_s = time.perf_counter() - t0
        first_launches = dict(ck.LAUNCHES)
        executor = seen[-1] if seen else "walk"
        plans = [p for p in fused_plans(db) if id(p) not in before]
        r0 = sum(p.replays for p in plans)
        c0 = sum(p.captures for p in plans)
        ck.reset_launches()
        seen.clear()
        warm = timed_runs(lambda: run_sql(pq, db, False), FUSION_WARM)
        warm_launches = {k: v / FUSION_WARM for k, v in ck.LAUNCHES.items()}
        assert seen == ["fused"] * FUSION_WARM, (name, seen)
        replays = (sum(p.replays for p in plans) - r0) / FUSION_WARM
        captures = sum(p.captures for p in plans) - c0
        prof = busy_share(lambda: run_sql(pq, db, False))
    peak = torch.cuda.max_memory_allocated(dev)
    with fusion_force(False):
        t0 = time.perf_counter()
        walk = run_sql(pq, db, False)
        walk_first_s = time.perf_counter() - t0
        walk_warm = timed_runs(lambda: run_sql(pq, db, False), FUSION_WARM)
    same_result(res, walk, name)
    fused_med = statistics.median(warm)
    walk_med = statistics.median(walk_warm)
    row = {"query": name, "executor": executor,
           "fused_stages": sum(p.fused_stages for p in plans),
           "plans": len(plans), "rows": res.num_rows,
           "first_s": first_s,
           "capture_s": sum(p.capture_seconds or 0.0 for p in plans),
           "first_trace_s": sum(p.first_trace_seconds or 0.0 for p in plans),
           "warm_median_s": fused_med, "warm_s": warm,
           "walk_first_s": walk_first_s, "walk_warm_median_s": walk_med,
           "walk_warm_s": walk_warm, "walk_over_fused": walk_med / fused_med,
           "replays_per_warm": replays, "captures_in_warm": captures,
           "grows": sum(p.grows for p in plans),
           "kernel_launches_first": first_launches,
           "kernel_launches_per_warm": warm_launches,
           "device_ops_per_warm": prof["device_ops"],
           "device_busy_share": prof["device_busy_share"],
           "profiled_wall_s": prof["profiled_wall_s"],
           "top_kernels": prof["top_kernels"],
           "peak_device_bytes": peak, "resident_bytes": base,
           "query_peak_bytes": peak - base,
           "pool_bytes": sum(p.pool_bytes or 0 for p in plans),
           "equals_walk": True}
    assert executor == "fused", (name, executor)
    assert replays == 1 and captures == 0, (name, replays, captures)
    return row, res, walk


def fusion_golden_check(dev) -> list:
    """The 22 queries at the goldens' (sf, seed) through
    ``execute_plan(..., use_dq=False)`` with fusion on: every statement
    answered by a fused plan, each equal to its golden and to the walk."""
    exceptions = golden_check(dev, use_dq=False, fuse=True)
    log(f"fusion golden check: 22 queries fused on the card, each equal to "
        f"the walk; {len(exceptions)} float-column exceptions")
    return exceptions


def clickbench_database(cb, dev):
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database
    from ydb_tpu_torch.sql.planner import Catalog
    from ydb_tpu_torch.workload import clickbench

    db = Database(
        sources={"hits": ColumnSource(cb.hits, clickbench.HITS_SCHEMA,
                                      cb.dicts).to_device(dev)},
        dicts=cb.dicts, device=dev)
    catalog = Catalog(schemas={"hits": clickbench.HITS_SCHEMA},
                      primary_keys={"hits": ("WatchID",)}, dicts=cb.dicts)
    return db, catalog


def member_inputs(sig, db, dev) -> dict:
    """A dispatch's staged inputs for ``sig`` from ``db``'s tables, as
    fresh blocks (the serving tier's staged members)."""
    from ydb_tpu_torch.blocks.block import TableBlock

    out = {}
    for s in sig.sites:
        src = db.sources[s.table]
        out[s.key] = TableBlock.from_numpy(
            {m: src.columns[m] for m in s.read_cols}, s.in_schema, None,
            capacity=s.capacity, device=dev)
    return out


def stacked_check(cases, dev) -> list:
    """``run_shared`` and ``run_stacked`` at B = 4 for each (name, plan,
    member databases): each member's slice of one stacked replay equals
    that member's serial run, and the members' answers differ."""
    from ydb_tpu_torch.plan import to_host
    from ydb_tpu_torch.ssa import plan_fuse

    rows = []
    for name, plan, dbs in cases:
        sig = plan_fuse.plan_signature(plan, dbs[0])
        fused = plan_fuse.build(sig, dbs[0])
        members = [member_inputs(sig, d, dev) for d in dbs]
        serial = [to_host(fused.run_shared(m)[0]) for m in members]
        out, _ = fused.run_stacked(members)
        again, _ = fused.run_stacked(members)
        for i, want in enumerate(serial):
            same_result(to_host(plan_fuse.slice_member(out, i)), want, name)
            same_result(to_host(plan_fuse.slice_member(again, i)), want,
                        name)
        distinct = len({json.dumps([np.asarray(v).tolist()
                                    for v, _ in r.cols.values()])
                        for r in serial})
        assert distinct > 1, name
        rows.append({"query": name, "batch": len(members),
                     "replays": fused.replays, "captures": fused.captures,
                     "pool_bytes": fused.pool_bytes,
                     "distinct_member_results": distinct})
        for cap in fused._graphs.values():
            cap.graph.reset()
    log("run_shared / run_stacked at B = 4: every member's slice equals its "
        f"serial run: {json.dumps(rows)}")
    return rows


def sweep_point(name, pq, db, label) -> dict:
    """Warm medians of one planned statement, fused and walked."""
    with fusion_force(None), routed() as seen:
        t0 = time.perf_counter()
        res = run_sql(pq, db, False)
        first_s = time.perf_counter() - t0
        assert seen == ["fused"], (label, seen)
        fused = statistics.median(timed_runs(
            lambda: run_sql(pq, db, False), FUSION_WARM))
    with fusion_force(False):
        walk_res = run_sql(pq, db, False)
        walk = statistics.median(timed_runs(
            lambda: run_sql(pq, db, False), FUSION_WARM))
    same_result(res, walk_res, label)
    drop_fused(db)
    return {"query": name, "fused_first_s": first_s,
            "fused_warm_median_s": fused, "walk_warm_median_s": walk,
            "walk_over_fused": walk / fused}


def fusion_phase(dev, ck, sweep=True) -> dict:
    """Phase 7: whole-plan fusion at the fused path's full size (see the
    module docstring). Returns the rows of each sub-phase."""
    from ydb_tpu_torch.plan.nodes import TableScan, Transform
    from ydb_tpu_torch.ssa import kernels, plan_fuse
    from ydb_tpu_torch.workload import clickbench, tpch
    from ydb_tpu_torch.workload.queries import TPCH

    t_phase = time.perf_counter()
    out: dict = {}
    out["golden_float_exceptions"] = fusion_golden_check(dev)

    # 2. TPC-H at FUSION_SF, tables on the card
    tp = tpch.TpchData(sf=FUSION_SF, seed=42)
    n_li = len(tp.tables["lineitem"]["l_orderkey"])
    assert n_li <= plan_fuse.FUSE_MAX_ROWS, n_li
    db, catalog = sql_database(tp, dev)
    ck.reset_launches()
    counted = {k: 0 for k in ck.LAUNCHES}

    def count(row):
        for k, v in row["kernel_launches_first"].items():
            counted[k] += v
        for k, v in row["kernel_launches_per_warm"].items():
            counted[k] += round(v * FUSION_WARM)

    tpch_rows = []
    for name in sorted(TPCH, key=lambda q: int(q[1:])):
        with fusion_force(None):
            pq = plan_sql(TPCH[name], db, catalog, False)
        row, _, _ = fused_statement(name, pq, db, ck, dev)
        row["sf"] = FUSION_SF
        count(row)
        tpch_rows.append(row)
        emit({"fused": row})
        drop_fused(db)
    out["tpch"] = tpch_rows
    log(f"fused TPC-H sf {FUSION_SF} ({n_li} lineitem rows): 22 queries, "
        f"one graph replay per warm statement, each equal to the walk; "
        f"warm medians fused / walk summed "
        f"{sum(r['warm_median_s'] for r in tpch_rows):.4f} / "
        f"{sum(r['walk_warm_median_s'] for r in tpch_rows):.4f} s")

    # 3. ClickBench at FUSION_HITS_ROWS: all 43 through the default routing
    cb = clickbench.ClickBenchData(rows=FUSION_HITS_ROWS, seed=42)
    cdb, ccat = clickbench_database(cb, dev)
    want = clickbench.reference_answers(cb)
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import plan_select_full

    cb_rows = []
    for name in sorted(clickbench.QUERIES, key=lambda q: int(q[1:])):
        pq = plan_select_full(parse(clickbench.QUERIES[name]), ccat)
        row, res, _ = fused_statement(f"cb_{name}", pq, cdb, ck, dev)
        clickbench._verify(name, res, want[name], cb, pq)
        with fusion_force(None), routed() as seen:
            routed_res = run_sql(pq, cdb)
        default = seen[-1]
        clickbench._verify(name, routed_res, want[name], cb, pq)
        same_result(routed_res, res, name)
        row.update(query=name, hits_rows=FUSION_HITS_ROWS,
                   default_executor=default, canondata_checked=True)
        count(row)
        cb_rows.append(row)
        emit({"clickbench": row})
        drop_fused(cdb)
    out["clickbench"] = cb_rows
    routes = collections.Counter(r["default_executor"] for r in cb_rows)
    log(f"fused ClickBench at {FUSION_HITS_ROWS} rows: 43 queries equal "
        f"reference_answers and the walk; default routing {dict(routes)}; "
        f"warm medians fused / walk summed "
        f"{sum(r['warm_median_s'] for r in cb_rows):.4f} / "
        f"{sum(r['walk_warm_median_s'] for r in cb_rows):.4f} s")

    # the per-aggregate group-by lowering (grouped_sum) inside graphs
    peragg = []
    kernels.FUSED_FORCE = False
    try:
        for name in ("q33", "q36"):
            pq = plan_select_full(parse(clickbench.QUERIES[name]), ccat)
            row, res, _ = fused_statement(f"cb_{name}_peragg", pq, cdb, ck,
                                          dev)
            clickbench._verify(name, res, want[name], cb, pq)
            count(row)
            peragg.append(row)
            emit({"clickbench_peragg": row})
            drop_fused(cdb)
    finally:
        kernels.FUSED_FORCE = None
    out["clickbench_peragg"] = peragg
    out["kernel_launches"] = counted
    log(f"CUDA kernel launches on the fused path (graph replays): {counted}")
    assert all(v > 0 for v in counted.values()), counted

    # 4. run_shared / run_stacked at B = 4
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database

    li = tp.tables["lineitem"]
    li_dbs = []
    for i in range(4):
        cols = dict(li)
        cols["l_quantity"] = li["l_quantity"] // (i + 1)
        cols["l_discount"] = np.roll(li["l_discount"], i)
        li_dbs.append(Database(
            sources={"lineitem": ColumnSource(cols, tpch.LINEITEM_SCHEMA,
                                              tp.dicts)},
            dicts=tp.dicts, device=dev))
    n_urls = len(cb.dicts["URL"])
    hits_dbs = []
    for i in range(4):
        # the same table with its URL ids shifted: other answers, the
        # same dictionary
        cols = dict(cb.hits)
        cols["URL"] = ((cb.hits["URL"] + 37 * i) % n_urls).astype(np.int32)
        hits_dbs.append(Database(
            sources={"hits": ColumnSource(cols, clickbench.HITS_SCHEMA,
                                          cb.dicts)},
            dicts=cb.dicts, device=dev))
    q33 = plan_select_full(parse(clickbench.QUERIES["q33"]), ccat).plan
    out["stacked"] = stacked_check([
        ("q1", Transform(TableScan("lineitem"), tpch.q1_program()), li_dbs),
        ("q6", Transform(TableScan("lineitem"), tpch.q6_program()), li_dbs),
        ("cb_q33", q33, hits_dbs)], dev)
    del hits_dbs, li_dbs

    # 5. the cutoff sweep (a measurement; the default does not change)
    if sweep:
        out["sweep"] = cutoff_sweep(dev, tp, cb)
    del db, cdb
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"fusion phase: {out['seconds']:.1f} s")
    return out


def cutoff_sweep(dev, tp, cb) -> list:
    """TPC-H q1, q3, q6 and ClickBench q33, fused and walked at each of
    SWEEP_POINTS (rows of lineitem / hits); above FUSE_MAX_ROWS with the
    cutoff raised in-process for that point only."""
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import plan_select_full
    from ydb_tpu_torch.ssa import plan_fuse
    from ydb_tpu_torch.workload import clickbench, tpch
    from ydb_tpu_torch.workload.queries import TPCH

    rows = []
    for hits_rows, sf in SWEEP_POINTS:
        t = tp if sf == FUSION_SF else tpch.TpchData(sf=sf, seed=42)
        c = (cb if hits_rows == FUSION_HITS_ROWS
             else clickbench.ClickBenchData(rows=hits_rows, seed=42))
        saved = plan_fuse.FUSE_MAX_ROWS
        plan_fuse.FUSE_MAX_ROWS = max(saved, 1 << 21)
        try:
            db, catalog = sql_database(t, dev)
            cdb, ccat = clickbench_database(c, dev)
            n_li = len(t.tables["lineitem"]["l_orderkey"])
            for q in SWEEP_QUERIES:
                if q.startswith("cb_"):
                    pq = plan_select_full(
                        parse(clickbench.QUERIES[q[3:]]), ccat)
                    r = sweep_point(q, pq, cdb, f"{q}@{hits_rows}")
                    r["rows"] = hits_rows
                else:
                    pq = plan_sql(TPCH[q], db, catalog, False)
                    r = sweep_point(q, pq, db, f"{q}@{sf}")
                    r.update(rows=n_li, sf=sf)
                r["above_cutoff"] = r["rows"] > saved
                rows.append(r)
                emit({"sweep_fusion": r})
            del db, cdb
            torch.cuda.empty_cache()
        finally:
            plan_fuse.FUSE_MAX_ROWS = saved
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
    ap.add_argument("--dq-warm", type=int, default=None,
                    help="warm runs per query in the DQ phase, each query "
                    "also profiled, whatever the time (default: 3, or 1 "
                    f"where the first run took over {DQ_SLOW_FIRST_S} s, "
                    f"while the run stays under {DQ_EXTRAS_BUDGET_S} s)")
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
    sql_rows, db, catalog, checks, walk = sql_phase(sql_tp, dev, ck)
    sql_launches = {k: sum(r["launches"][k] for r in sql_rows)
                    for k in ck.LAUNCHES}
    log(f"SQL path (walk): 22 queries at sf {sql_tp.sf} on the card; Q1, "
        f"Q3, Q5, Q6, Q13, Q18 equal numpy; CUDA kernel launches over all "
        f"first runs {sql_launches}")

    # ---- phase 6: the DQ stage graph ----
    dq_golden = dq_golden_check(dev)
    dq_rows = dq_phase(sql_tp, db, catalog, dev, ck, walk,
                       {k: checks[k] for k in ("q3", "q5", "q13", "q18")},
                       args.dq_warm)
    walk_median = {r["query"]: r["warm_median_s"] for r in sql_rows}
    timed = [r for r in dq_rows if r["warm_median_s"] is not None]
    for r in timed:
        r["walk_warm_median_s"] = walk_median[r["query"]]
        r["dq_over_walk"] = r["warm_median_s"] / walk_median[r["query"]]
    dq_launches = {k: sum(r["launches"][k] for r in dq_rows)
                   for k in ck.LAUNCHES}
    log(f"SQL path (DQ): 22 queries at sf {sql_tp.sf} on the card, 20 "
        f"through the DQ stage graph; every result equals the walk's; Q3, "
        f"Q5, Q13, Q18 equal numpy; CUDA kernel launches over all first "
        f"runs {dq_launches}; first runs summed "
        f"{sum(r['first_s'] for r in dq_rows):.4f} s; warm and profiled "
        f"runs made for {len(timed)} queries (DQ_EXTRAS_BUDGET_S), their "
        f"warm medians DQ / walk summed "
        f"{sum(r['warm_median_s'] for r in timed):.4f} / "
        f"{sum(walk_median[r['query']] for r in timed):.4f} s")
    del db, walk
    torch.cuda.empty_cache()

    # ---- phase 7: whole-plan fusion ----
    fusion = fusion_phase(dev, ck)
    for row in kernel_rows:
        row["sql_launches"] = sql_launches[row["name"]]
        row["dq_launches"] = dq_launches[row["name"]]
        row["fused_launches"] = fusion["kernel_launches"][row["name"]]

    report.update(metrics=metrics, warm_runs=warm_runs, per_query=per_query,
                  kernels=kernel_rows, sweep=sweep_rows,
                  peak_device_bytes=peak_bytes,
                  sf=args.sf, lineitem_rows=n_li, hits_rows=args.hits_rows,
                  sql=sql_rows, sql_sf=sql_tp.sf,
                  sql_golden_float_exceptions=exceptions,
                  sql_dq=dq_rows, sql_dq_golden=dq_golden, fusion=fusion)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    log("chip_smoke: all phases passed")
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
