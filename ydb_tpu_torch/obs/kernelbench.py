"""Micro-benchmark CLI for the scan/aggregate hot paths.

``python -m ydb_tpu_torch.obs.kernelbench`` measures, in-process, on
``--device`` (CUDA unless ``--device cpu`` asks for the CPU):

  * group-by — a synthetic multi-aggregate GROUP BY program compiled
    twice (fused single-contraction vs per-aggregate reductions,
    kernels.FUSED_FORCE) and cross-checked against the CPU oracle;
  * staging — payload stream -> rechunk -> TableBlock.from_numpy ->
    device block throughput (the low-copy block pipeline);
  * pruning (``--pruning``) — zone-map scan pruning on a selective
    non-PK filter over a time-correlated table: chunks skipped/s and
    the stats-on vs stats-off (YDB_TPU_TORCH_STATS=0 analog) speedup, with
    results asserted bit-identical between the two sides;
  * profile overhead (``--profile-overhead``) — warm TPC-H Q1 through
    ``ColumnShard.scan`` with query profiling active (a traced root
    span, the session's default-on state) vs inactive (the
    ``YDB_TPU_TORCH_PROFILE=0`` path): profiling must be within noise of off,
    or it cannot stay default-on;
  * fusion (``--fusion``) — warm TPC-H Q3 (joins + grouped top-k)
    executed as ONE whole-plan fused dispatch (ssa.plan_fuse) vs the
    per-node fragment walk, bit-identity asserted, with per-query
    dispatch counts;
  * streaming (``--streaming``) — morsel-driven scan pipeline
    (engine.stream_sched) vs the serialized path over a COLD
    DirBlobStore scan: rows/s both sides, the measured
    ``movement|compute`` overlap coefficient of one pipelined run, and
    results asserted bit-identical between the two sides;
  * shuffle (``--shuffle``) — all_to_all repartition over the shard
    mesh (``parallel/shuffle.py``) with stats-sized buckets (count-min
    bound, ``shuffle.size_buckets``) vs always-sufficient full-capacity
    buckets: row multisets equal, keys colocated, the uniform-key bucket
    >=4x smaller, and a 100%-skew overflow that grows the bucket and
    re-exchanges losslessly (the skew case with ``--shuffle`` only).

Flags: ``--rows`` ``--groups`` ``--aggs`` ``--iters`` ``--block-rows``
``--pruning`` ``--streaming`` ``--profile-overhead``
``--admission-overhead`` (multi-tenant front door absent vs installed
through the full session path) ``--memsan-overhead`` (memory
sanitizer disarmed vs armed warm Q1, zero unbudgeted allocations
asserted on the armed side) ``--fusion``
``--shuffle``
``--shuffle-rows`` (rows per shard) ``--sf`` (scale
factor for the overhead/fusion benches) ``--json`` (report on stdout) and
``--smoke`` (tiny sizes, correctness-only; wired into tier-1 as a
non-slow test with ``--device cpu``).

The port's own copy of ``ydb_tpu/obs/kernelbench.py``. Seconds are host
clock around work that ends in a device synchronize (a result fetched
to the host, or ``torch.cuda.synchronize``); each report names its
device. On CUDA the group-by bench's GROUP BY of more than 512 groups
runs the two hand-written kernels (``csrc/grouped_sum.cu``): the fused
lowering ``grouped_sum_multi``, the per-aggregate one ``grouped_sum``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import sys
import time

import numpy as np
import torch


def _sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _interleaved(sides: dict, iters: int) -> tuple[dict, dict]:
    """Run the named callables ``sides`` for ``iters`` rounds, each round
    every side once, back to back; the order turns by one side a round,
    so no side always runs first. Returns two maps of label -> list of
    per-round seconds, in round order: the host clock, and the process's
    CPU time (every thread)."""
    labels = list(sides)
    wall = {label: [] for label in labels}
    cpu = {label: [] for label in labels}
    for r in range(max(1, iters)):
        k = r % len(labels)
        for label in labels[k:] + labels[:k]:
            c0, t0 = time.process_time(), time.perf_counter()
            sides[label]()
            wall[label].append(time.perf_counter() - t0)
            cpu[label].append(time.process_time() - c0)
    return wall, cpu


def _rounded(times: dict) -> dict:
    """Per-round seconds of :func:`_interleaved` for a report."""
    return {label: [round(t, 6) for t in ts] for label, ts in times.items()}


def _overhead(times: dict, side: str, base: str) -> float:
    """``side``'s overhead over ``base`` as a fraction: the median over
    rounds of the ratio of the two sides' times in the same round. Two
    sides of one round run back to back under the same host load, while
    the load moves a warm scan's time 10-25% between rounds; a ratio of
    each side's own minimum compares two different rounds and carries
    that movement into the verdict."""
    return statistics.median(
        a / b for a, b in zip(times[side], times[base])) - 1


def _added(times: dict, side: str, base: str) -> float:
    """Seconds ``side`` adds to ``base``: the median over rounds of the
    difference of the two sides' times in the same round."""
    return statistics.median(
        a - b for a, b in zip(times[side], times[base]))


def _steady(shard) -> None:
    """Let the warm-up scans' heat-driven promotions land, so the timed
    rounds of both sides all read the same resident set (no-op with the
    resident tier off)."""
    shard.resident.drain(timeout=300.0)


def lineitem_shard(name: str, sf: float, block_rows: int, device,
                    data=None):
    """TPC-H lineitem at ``sf`` (seed 5, or the caller's ``data``) in one
    uncompacted ColumnShard on ``device``; returns (shard, rows)."""
    from ydb_tpu_torch.engine.blobs import MemBlobStore
    from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
    from ydb_tpu_torch.workload import tpch

    data = data if data is not None else tpch.TpchData(sf=sf, seed=5)
    li = data.tables["lineitem"]
    shard = ColumnShard(
        name, tpch.LINEITEM_SCHEMA, MemBlobStore(),
        dicts=data.dicts,
        config=ShardConfig(compact_portion_threshold=10 ** 9,
                           scan_block_rows=block_rows,
                           portion_chunk_rows=1 << 16),
        device=device)
    shard.commit([shard.write(dict(li))])
    return shard, len(li["l_orderkey"])


def _build_case(rows: int, groups: int, aggs: int, seed: int = 7):
    """Synthetic grouped-aggregation case: one bounded int key (dense
    tier when `groups` is small), `aggs` decimal SUM columns plus AVG /
    COUNT / MIN / MAX riders, ~6% NULLs."""
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.ssa import (
        Agg, AggSpec, Call, Col, FilterStep, GroupByStep, Op, Program,
    )
    from ydb_tpu_torch.ssa.program import lit

    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, groups, rows).astype(np.int64)}
    valid = {"k": np.ones(rows, dtype=bool)}
    fields = [("k", dtypes.INT64)]
    specs = [AggSpec(Agg.COUNT_ALL, None, "n")]
    for i in range(aggs):
        name = f"v{i}"
        cols[name] = rng.integers(0, 10 ** 6, rows).astype(np.int64)
        valid[name] = rng.random(rows) > 0.06
        fields.append((name, dtypes.decimal(2)))
        specs.append(AggSpec(Agg.SUM, name, f"sum_{name}"))
    specs.append(AggSpec(Agg.AVG, "v0", "avg_v0"))
    specs.append(AggSpec(Agg.COUNT, "v0", "cnt_v0"))
    specs.append(AggSpec(Agg.MIN, "v0", "min_v0"))
    specs.append(AggSpec(Agg.MAX, "v0", "max_v0"))
    prog = Program((
        FilterStep(Call(Op.GE, Col("v0"), lit(0))),
        GroupByStep(("k",), tuple(specs)),
    ))
    schema = dtypes.schema(*fields)
    return prog, schema, cols, valid


def bench_group_by(rows: int, groups: int, aggs: int, iters: int,
                   check: bool = True, device="cuda") -> dict:
    from ydb_tpu_torch.blocks.block import TableBlock, device_aux
    from ydb_tpu_torch.engine.oracle import OracleTable, run_oracle
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.ssa.compiler import compile_program

    prog, schema, cols, valid = _build_case(rows, groups, aggs)
    blk = TableBlock.from_numpy(cols, schema, valid, device=device)
    out: dict = {"rows": rows, "groups": groups, "aggs": aggs}
    results = {}
    for label, force in (("fused", True), ("peragg", False)):
        kernels.FUSED_FORCE = force
        try:
            cp = compile_program(prog, schema,
                                 key_spaces={"k": groups})
            run = cp.run
            aux = device_aux(cp.aux, blk.device)
            res = run(blk, aux)
            _sync(device)
            results[label] = res
            best = float("inf")
            for _ in range(iters):
                t0 = time.perf_counter()
                run(blk, aux)
                _sync(device)
                best = min(best, time.perf_counter() - t0)
            out[f"{label}_rows_per_sec"] = round(rows / best)
        finally:
            kernels.FUSED_FORCE = None
    if "fused_rows_per_sec" in out and "peragg_rows_per_sec" in out:
        out["fused_speedup"] = round(
            out["fused_rows_per_sec"] / out["peragg_rows_per_sec"], 2)
    if check:
        oracle = run_oracle(
            prog, OracleTable(
                {n: (cols[n], valid[n]) for n in cols}, schema))
        for label, res in results.items():
            got = OracleTable.from_block(res)
            o_order = np.argsort(oracle.column("k"))
            g_order = np.argsort(np.asarray(got.column("k")))
            for name in got.cols:
                g = np.asarray(got.column(name), dtype=np.float64)
                o = np.asarray(oracle.column(name), dtype=np.float64)
                np.testing.assert_allclose(
                    g[g_order], o[o_order], rtol=1e-9,
                    err_msg=f"{label} vs oracle on {name}")
        out["oracle_check"] = "ok"
    return out


def bench_staging(rows: int, block_rows: int, iters: int,
                  device="cuda") -> dict:
    """Block staging throughput: payloads -> rechunk -> from_numpy ->
    device blocks (the low-copy pipeline, prefetch on)."""
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.engine.reader import stream_blocks

    schema = dtypes.schema(("a", dtypes.INT64), ("b", dtypes.DOUBLE))
    rng = np.random.default_rng(3)
    chunk = 1 << 16
    payloads = []
    for off in range(0, rows, chunk):
        n = min(chunk, rows - off)
        payloads.append((
            {"a": rng.integers(0, 10 ** 9, n).astype(np.int64),
             "b": rng.random(n)},
            {"a": np.ones(n, dtype=bool), "b": np.ones(n, dtype=bool)},
        ))
    best = float("inf")
    n_blocks = 0
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        blocks = list(stream_blocks(iter(payloads), ("a", "b"), schema,
                                    min(block_rows, rows), device=device))
        _sync(device)
        best = min(best, time.perf_counter() - t0)
        n_blocks = len(blocks)
    return {"rows": rows, "block_rows": block_rows, "blocks": n_blocks,
            "staging_rows_per_sec": round(rows / best)}


def build_pruning_shard(rows: int, chunk_rows: int, commits: int = 4,
                        device="cuda"):
    """A ColumnShard holding a time-correlated events table: ``ts``
    increases with insertion order (the log/telemetry shape zone maps
    thrive on) while NOT being the PK, ``user`` is low-cardinality and
    ``val`` a decimal payload; ~3% NULL vals."""
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.engine.blobs import MemBlobStore
    from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig

    schema = dtypes.schema(
        ("event_id", dtypes.INT64, False),
        ("ts", dtypes.INT64, False),
        ("user", dtypes.INT32, False),
        ("val", dtypes.decimal(2)),
    )
    shard = ColumnShard(
        "prune", schema, MemBlobStore(), pk_column="event_id",
        config=ShardConfig(compact_portion_threshold=10 ** 9,
                           portion_chunk_rows=chunk_rows),
        device=device)
    rng = np.random.default_rng(11)
    per = rows // commits
    for c in range(commits):
        n = per if c < commits - 1 else rows - per * (commits - 1)
        base = c * per
        cols = {
            "event_id": (base + np.arange(n)).astype(np.int64),
            "ts": (base + np.arange(n)).astype(np.int64),
            "user": rng.integers(0, 64, n).astype(np.int32),
            "val": rng.integers(0, 10 ** 6, n).astype(np.int64),
        }
        validity = {"val": rng.random(n) > 0.03}
        shard.commit([shard.write(cols, validity)])
    return shard, rows


def bench_pruning(rows: int, chunk_rows: int, iters: int,
                  selectivity: float = 0.05, shard=None,
                  device="cuda") -> dict:
    """Selective non-PK filter A/B: stats-on (zone pruning) vs
    stats-off, bit-identical results required. ``shard`` reuses an
    already-built events shard (bench.py's NDV pass shares one)."""
    from ydb_tpu_torch import stats as stats_mod
    from ydb_tpu_torch.ssa import Agg, AggSpec, Call, Col, FilterStep, \
        GroupByStep, Op, Program
    from ydb_tpu_torch.ssa.program import lit

    if shard is None:
        shard, n = build_pruning_shard(rows, chunk_rows, device=device)
    else:
        shard, n = shard
    lo = int(n * 0.5)
    hi = int(n * (0.5 + selectivity))
    prog = Program((
        FilterStep(Call(Op.AND,
                        Call(Op.GE, Col("ts"), lit(lo)),
                        Call(Op.LT, Col("ts"), lit(hi)))),
        GroupByStep(("user",), (
            AggSpec(Agg.COUNT_ALL, None, "n"),
            AggSpec(Agg.SUM, "val", "s"),
        )),
    ))
    out: dict = {"rows": n, "chunk_rows": chunk_rows,
                 "selectivity": selectivity}
    results = {}
    for label, force in (("stats", True), ("nostats", False)):
        stats_mod.STATS_FORCE = force
        try:
            best = float("inf")
            res = None
            for _ in range(max(1, iters)):
                t0 = time.perf_counter()
                res = shard.scan(prog)
                best = min(best, time.perf_counter() - t0)
            results[label] = res
            p = dict(shard.last_scan_pruning)
            out[f"{label}_seconds"] = round(best, 4)
            out[f"{label}_chunks_read"] = p.get("chunks_read", 0)
            if force:
                out["chunks_skipped"] = p.get("chunks_skipped", 0)
                out["portions_skipped"] = p.get("portions_skipped", 0)
                out["chunks_skipped_per_sec"] = round(
                    p.get("chunks_skipped", 0) / max(best, 1e-9))
        finally:
            stats_mod.STATS_FORCE = None
    if out.get("nostats_seconds"):
        out["pruning_speedup"] = round(
            out["nostats_seconds"] / max(out["stats_seconds"], 1e-9), 2)
    ratio = out.get("nostats_chunks_read", 0) / max(
        out.get("stats_chunks_read", 1), 1)
    out["chunk_read_ratio"] = round(ratio, 2)
    # bit-identity between the two sides (group keys sort-aligned;
    # NULL slots compare by validity, not by their garbage payload)
    a, b = results["stats"], results["nostats"]
    oa = np.argsort(np.asarray(a.column("user")))
    ob = np.argsort(np.asarray(b.column("user")))
    for name in a.cols:
        av, aok = (np.asarray(x) for x in a.cols[name])
        bv, bok = (np.asarray(x) for x in b.cols[name])
        if not np.array_equal(aok[oa], bok[ob]) or not np.array_equal(
                np.where(aok, av, 0)[oa], np.where(bok, bv, 0)[ob]):
            raise AssertionError(f"stats on/off mismatch on {name}")
    out["identical"] = True
    return out


def bench_resident(rows: int, chunk_rows: int, iters: int,
                   shard=None, device="cuda") -> dict:
    """HBM-resident tier A/B (equality-asserted): the same shard
    scanned warm with the resident tier forced on (heat-promoted, then
    drained, so blocks assemble from pinned device arrays) vs forced
    off (every scan re-stages from host bytes). The gap is ROADMAP
    item 1's engine-vs-kernel distance at micro scale."""
    from ydb_tpu_torch.engine import resident as resident_mod
    from ydb_tpu_torch.ssa import Agg, AggSpec, GroupByStep, Program

    if shard is None:
        shard, n = build_pruning_shard(rows, chunk_rows, device=device)
    else:
        shard, n = shard
    prog = Program((
        GroupByStep(("user",), (
            AggSpec(Agg.COUNT_ALL, None, "n"),
            AggSpec(Agg.SUM, "val", "s"),
        )),
    ))
    out: dict = {"rows": n}
    results = {}
    for label, force in (("resident", True), ("staged", False)):
        resident_mod.RESIDENT_FORCE = force
        try:
            if force:
                # heat-driven promotion: two host-path scans cross the
                # threshold, drain pins every portion before timing
                for _ in range(2):
                    shard.scan(prog)
                shard.resident.drain()
            best = float("inf")
            res = None
            for _ in range(max(1, iters)):
                t0 = time.perf_counter()
                res = shard.scan(prog)
                best = min(best, time.perf_counter() - t0)
            results[label] = res
            out[f"{label}_seconds"] = round(best, 5)
            out[f"{label}_rows_per_sec"] = round(n / max(best, 1e-9))
            if force:
                snap = shard.resident.snapshot()
                out["resident_portions"] = snap["portions"]
                out["resident_bytes"] = snap["bytes"]
        finally:
            resident_mod.RESIDENT_FORCE = None
    out["resident_speedup"] = round(
        out["staged_seconds"] / max(out["resident_seconds"], 1e-9), 2)
    # bit-identity between the two sides (group keys sort-aligned)
    a, b = results["resident"], results["staged"]
    oa = np.argsort(np.asarray(a.column("user")))
    ob = np.argsort(np.asarray(b.column("user")))
    for name in a.cols:
        av, aok = (np.asarray(x) for x in a.cols[name])
        bv, bok = (np.asarray(x) for x in b.cols[name])
        if not np.array_equal(aok[oa], bok[ob]) or not np.array_equal(
                np.where(aok, av, 0)[oa], np.where(bok, bv, 0)[ob]):
            raise AssertionError(
                f"resident on/off mismatch on {name}")
    out["identical"] = True
    shard.resident.clear()
    return out


def bench_streaming(rows: int, chunk_rows: int, iters: int,
                    device="cuda") -> dict:
    """Morsel-pipeline A/B (equality-asserted): the same COLD
    DirBlobStore scan serialized (stream_sched.PIPELINE_FORCE=False,
    the YDB_TPU_TORCH_STREAM_PIPELINE=0 path) vs morsel-pipelined, rows/s
    both sides, plus ONE profiled pipelined run whose data-movement
    timeline yields the measured ``movement|compute`` overlap
    coefficient. The blob store is on disk and the OS page cache is the
    only warmth, so both sides pay real read+decode per scan — the
    pipeline's overlap is what separates them."""
    import tempfile

    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.engine import stream_sched
    from ydb_tpu_torch.engine.blobs import DirBlobStore
    from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
    from ydb_tpu_torch.obs import profile as profile_mod
    from ydb_tpu_torch.obs import timeline
    from ydb_tpu_torch.ssa import Agg, AggSpec, GroupByStep, Program

    schema = dtypes.schema(
        ("event_id", dtypes.INT64, False),
        ("user", dtypes.INT32, False),
        ("val", dtypes.decimal(2)),
    )
    prog = Program((
        GroupByStep(("user",), (
            AggSpec(Agg.COUNT_ALL, None, "n"),
            AggSpec(Agg.SUM, "val", "s"),
        )),
    ))
    out: dict = {"rows": rows, "chunk_rows": chunk_rows}
    rng = np.random.default_rng(23)
    with tempfile.TemporaryDirectory(prefix="ydbtpu_kb_stream_") as tmp:
        shard = ColumnShard(
            "stream", schema, DirBlobStore(tmp), pk_column="event_id",
            # several blocks per scan: compute on block k must have
            # movement for k+1.. to overlap with, or the coefficient is
            # structurally zero
            config=ShardConfig(compact_portion_threshold=10 ** 9,
                               portion_chunk_rows=chunk_rows,
                               scan_block_rows=max(1024, rows // 8)),
            device=device)
        commits = 6
        per = rows // commits
        for c in range(commits):
            n = per if c < commits - 1 else rows - per * (commits - 1)
            base = c * per
            cols = {
                "event_id": (base + np.arange(n)).astype(np.int64),
                "user": rng.integers(0, 64, n).astype(np.int32),
                "val": rng.integers(0, 10 ** 6, n).astype(np.int64),
            }
            validity = {"val": rng.random(n) > 0.03}
            shard.commit([shard.write(cols, validity)])
        shard.scan(prog)  # compile + page-cache warmup, both sides
        results = {}
        for label, force in (("serialized", False),
                             ("pipelined", True)):
            stream_sched.PIPELINE_FORCE = force
            try:
                best = float("inf")
                res = None
                for _ in range(max(1, iters)):
                    t0 = time.perf_counter()
                    res = shard.scan(prog)
                    best = min(best, time.perf_counter() - t0)
                results[label] = res
                out[f"{label}_seconds"] = round(best, 5)
                out[f"{label}_rows_per_sec"] = round(
                    rows / max(best, 1e-9))
            finally:
                stream_sched.PIPELINE_FORCE = None
        out["pipeline_speedup"] = round(
            out["serialized_seconds"]
            / max(out["pipelined_seconds"], 1e-9), 2)
        # overlap coefficient of ONE pipelined run, timeline forced on
        stream_sched.PIPELINE_FORCE = True
        prev = timeline.TIMELINE_FORCE
        timeline.TIMELINE_FORCE = True
        try:
            with profile_mod.profiled("kb_streaming") as ph:
                shard.scan(prog)
        finally:
            timeline.TIMELINE_FORCE = prev
            stream_sched.PIPELINE_FORCE = None
        occ = ph.profile.stage_occupancy or {}
        ov = (occ.get("overlap") or {}).get("movement|compute")
        if ov is not None:
            out["movement_compute_overlap"] = ov
        if shard.last_scan_pipeline:
            out["pipeline"] = dict(shard.last_scan_pipeline)
        # bit-identity between the two sides (group keys sort-aligned;
        # NULL slots compare by validity, not their garbage payload)
        a, b = results["serialized"], results["pipelined"]
        oa = np.argsort(np.asarray(a.column("user")))
        ob = np.argsort(np.asarray(b.column("user")))
        for name in a.cols:
            av, aok = (np.asarray(x) for x in a.cols[name])
            bv, bok = (np.asarray(x) for x in b.cols[name])
            if not np.array_equal(aok[oa], bok[ob]) \
                    or not np.array_equal(np.where(aok, av, 0)[oa],
                                          np.where(bok, bv, 0)[ob]):
                raise AssertionError(
                    f"streaming on/off mismatch on {name}")
        out["identical"] = True
    return out


#: timed repetitions of a profiled statement's trace work in
#: :func:`bench_profile_overhead`
TRACE_REPS = 2000

#: ``--smoke`` rounds of the verdicts that are still wall A/Bs (leaksan,
#: admission, memsan): at the smoke's size a warm scan takes tens of
#: milliseconds, and the median of 3 same-round ratios moved from -9% to
#: +64% against the 50% smoke budget on a loaded CPU
SMOKE_AB_ROUNDS = 9


def _trace_work(shard, prog) -> tuple[list, int]:
    """What profiling adds to one warm scan of ``prog``, counted: the
    spans a profiled scan records under its root (name and attributes,
    in order) and the conveyor tasks that carried its trace onto a
    worker (``tracing.wrap_current`` calls that bound a span)."""
    from ydb_tpu_torch.obs import profile as profile_mod
    from ydb_tpu_torch.obs import tracing

    wrap = tracing.wrap_current
    wraps = [0]

    def counting(fn):
        out = wrap(fn)
        wraps[0] += out is not fn
        return out

    tracer = tracing.Tracer()
    tracing.wrap_current = counting
    try:
        with profile_mod.profiled("q1", tracer=tracer) as h:
            shard.scan(prog)
    finally:
        tracing.wrap_current = wrap
    spans = [(s.name, dict(s.attrs))
             for s in tracer.spans_for(h.profile.trace_id)
             if s.parent_id is not None]
    return spans, wraps[0]


def _ring_work(shard, prog) -> tuple[list, list, int]:
    """What the timeline ring adds to one warm profiled scan of ``prog``,
    counted with the ring forced on: its records (name, category,
    seconds, whether it carried a trace id, attributes, in order: stage
    charges, spans, conveyor waits and runs, blob reads, decodes), the byte
    counters the scan added (always on, so both sides of the replay pay
    them), and the end-of-scan syncs (``engine/scan.py:_settle``)."""
    from ydb_tpu_torch.engine import scan as scan_mod
    from ydb_tpu_torch.obs import profile as profile_mod
    from ydb_tpu_torch.obs import timeline

    add_bytes, settle = timeline.add_bytes, scan_mod._settle
    byte_adds, settles = [], [0]

    def counting_bytes(key, n):
        byte_adds.append((key, int(n)))
        return add_bytes(key, n)

    def counting_settle(out):
        settles[0] += 1
        return settle(out)

    timeline.RING.clear()
    timeline.TIMELINE_FORCE = True
    timeline.add_bytes, scan_mod._settle = counting_bytes, counting_settle
    try:
        with profile_mod.profiled("q1"):
            shard.scan(prog)
    finally:
        timeline.add_bytes, scan_mod._settle = add_bytes, settle
        timeline.TIMELINE_FORCE = False
    events = [(e.name, e.cat, e.end - e.start, bool(e.trace_id),
               dict(e.args)) for e in timeline.RING.events()]
    timeline.RING.clear()
    return events, byte_adds, settles[0]


def _device_syncs(fn, device) -> int:
    """Host waits on the device (``torch.cuda.synchronize``, a stream's
    or an event's ``synchronize``) while ``fn`` runs; 0 on the CPU."""
    if torch.device(device).type != "cuda":
        fn()
        return 0
    n = [0]
    saved = (torch.cuda.synchronize, torch.cuda.Stream.synchronize,
             torch.cuda.Event.synchronize)

    def counted(orig):
        def wrapper(*a, **kw):
            n[0] += 1
            return orig(*a, **kw)
        return wrapper

    torch.cuda.synchronize = counted(saved[0])
    torch.cuda.Stream.synchronize = counted(saved[1])
    torch.cuda.Event.synchronize = counted(saved[2])
    try:
        fn()
    finally:
        (torch.cuda.synchronize, torch.cuda.Stream.synchronize,
         torch.cuda.Event.synchronize) = saved
    return n[0]


def _noop():
    return None


def bench_profile_overhead(sf: float, iters: int, block_rows: int,
                           assert_within: float | None = None,
                           device="cuda", data=None, shard=None) -> dict:
    """Warm TPC-H Q1 with query profiling ON (traced root span — the
    session's default-on state: spans, stage timers, probe attrs,
    profile assembly) vs OFF (no active trace, the YDB_TPU_TORCH_PROFILE=0
    path), plus a third side with the data-movement timeline ring
    enabled (YDB_TPU_TORCH_TIMELINE=1 state). ``assert_within`` fails the
    bench when profiling adds more than that fraction of the OFF scan
    (the default-on budget); it also asserts the timeline's contract:
    ZERO ring events on the disabled path, and the enabled ring within
    3% of the profiled run. ``shard`` is a ``(shard, rows)`` pair from
    :func:`lineitem_shard` to scan instead of building one.

    Profiling differs from OFF only in the trace machinery: the root
    span and profile assembly (``profile.profiled``), the child spans
    with their attributes, and the trace bound to each conveyor task.
    So what it adds is counted and timed: the spans and bound tasks of
    one profiled scan, replayed ``TRACE_REPS`` times under
    ``profiled`` and again with no trace active; the difference of the
    two sides' whole times over ``TRACE_REPS`` (a mean, so the garbage
    collections its allocations trigger are paid in), over the OFF
    scan's median time. A warm scan's host time moves 10% from round to
    round on a shared host (``scripts/overhead_noise.py``), so a wall
    A/B of the two scans resolves about 1% after 90 rounds; it is
    reported beside the verdict (``wall_ab_pct``, the median same-round
    ratio over the ``iters`` rounds). The ring's verdict is counted and
    timed the same way: the records the ring took in one warm profiled
    scan with it forced on (stage charges, spans, conveyor and blob
    events) and the scan's byte counters, replayed ``TRACE_REPS`` times
    under ``profiled`` with the ring on (profile assembly then computes
    the query's occupancy from them) and again with it off, plus every
    device sync the enabled ring adds to a scan: counted (the ring-on
    scan's host waits on the device less the ring-off scan's; none may
    be other than the end-of-scan ``_settle``) and timed where they
    happen, in the ring side's scans of the ``iters`` rounds (the
    median over rounds of their seconds). The wall A/B of the ring side
    against profiling on is reported beside it
    (``timeline_wall_ab_pct``)."""
    from ydb_tpu_torch.engine import scan as scan_mod
    from ydb_tpu_torch.obs import profile as profile_mod
    from ydb_tpu_torch.obs import timeline, tracing
    from ydb_tpu_torch.workload import tpch

    shard, n = shard or lineitem_shard("profov", sf, block_rows, device,
                                       data)
    prog = tpch.q1_program()
    settle = scan_mod._settle
    settle_s: list = []  # the ring side's sync seconds, one sum a round

    def timed_settle(out):
        t0 = time.perf_counter()
        try:
            return settle(out)
        finally:
            settle_s[-1] += time.perf_counter() - t0

    def run_off():
        return shard.scan(prog)

    def run_on():
        with profile_mod.profiled("q1") as h:
            shard.scan(prog)
        return h

    def run_tl():
        # clear between rounds: profile assembly computes occupancy by
        # scanning the ring, so letting events accumulate across bench
        # rounds would charge round k with O(k) scan cost and skew the
        # A/B (a real query's working set is one ring pass of ~70
        # events, which is what this measures)
        timeline.RING.clear()
        timeline.TIMELINE_FORCE = True
        settle_s.append(0.0)
        try:
            return run_on()
        finally:
            timeline.TIMELINE_FORCE = False

    def ring_reps(on: bool) -> float:
        """Seconds of ``TRACE_REPS`` profiled statements' ring work, the
        ring forced ``on`` or off (cleared each statement on both
        sides, as the ring side of the rounds does)."""
        timeline.TIMELINE_FORCE = on
        try:
            t0 = time.perf_counter()
            for _ in range(TRACE_REPS):
                timeline.RING.clear()
                with profile_mod.profiled("q1"):
                    for name, cat, dur, traced, args in ring_events:
                        if timeline.timeline_enabled():
                            end = time.perf_counter()
                            timeline.RING.record(
                                name, cat, end - dur, end,
                                timeline.current_trace_id() if traced
                                else 0, args or None)
                    for key, nbytes in byte_adds:
                        timeline.add_bytes(key, nbytes)
            return time.perf_counter() - t0
        finally:
            timeline.TIMELINE_FORCE = False
            timeline.RING.clear()

    def trace_reps(on: bool) -> float:
        """Seconds of ``TRACE_REPS`` statements' trace work."""
        t0 = time.perf_counter()
        for _ in range(TRACE_REPS):
            with (profile_mod.profiled("q1") if on
                  else contextlib.nullcontext()):
                for name, attrs in spans:
                    with tracing.span(name) as sp:
                        if sp.recording:
                            sp.set(**attrs)
                for _ in range(wraps):
                    tracing.wrap_current(_noop)()
        return time.perf_counter() - t0

    prev_force = timeline.TIMELINE_FORCE
    timeline.TIMELINE_FORCE = False  # pin the A/B regardless of env
    try:
        run_off()  # warm: compile + scan-cache fill, shared by all
        run_on()
        run_tl()
        _steady(shard)
        # disabled-path contract: a profiled query with the timeline
        # OFF must record nothing (the gate is the whole cost)
        rec0 = timeline.RING.recorded
        spans, wraps = _trace_work(shard, prog)
        disabled_events = timeline.RING.recorded - rec0
        ring_events, byte_adds, settles = _ring_work(shard, prog)
        # the syncs the enabled ring adds: none but the timed _settle
        syncs = {on: _device_syncs(run_tl if on else run_on, device)
                 for on in (False, True)}
        added_syncs = syncs[True] - syncs[False]
        if added_syncs > settles:
            raise AssertionError(
                f"the timeline ring adds {added_syncs} device syncs to a "
                f"scan, {settles} of them timed")
        settle_s.clear()
        scan_mod._settle = timed_settle
        try:
            times, _ = _interleaved({"off": run_off, "on": run_on,
                                     "tl": run_tl}, iters)
        finally:
            scan_mod._settle = settle
        trace_s = {on: trace_reps(on) for on in (False, True)}
        ring_s = {on: ring_reps(on) for on in (False, True)}
    finally:
        timeline.TIMELINE_FORCE = prev_force
    best = {k: min(v) for k, v in times.items()}
    median = {k: statistics.median(v) for k, v in times.items()}
    added = (trace_s[True] - trace_s[False]) / TRACE_REPS
    ring_added = (ring_s[True] - ring_s[False]) / TRACE_REPS
    sync_added = statistics.median(settle_s)
    tl_added = ring_added + sync_added
    over, tl_over = added / median["off"], tl_added / median["on"]
    out = {
        "rows": n, "sf": sf, "rounds": len(times["off"]),
        "trace_spans": len(spans), "trace_wraps": wraps,
        "profile_off_seconds": round(best["off"], 6),
        "profile_on_seconds": round(best["on"], 6),
        "profile_off_rows_per_sec": round(n / best["off"]),
        "profile_on_rows_per_sec": round(n / best["on"]),
        "profile_off_median_seconds": round(median["off"], 6),
        "profile_on_median_seconds": round(median["on"], 6),
        "profile_added_ms": round(1e3 * added, 4),
        "overhead_pct": round(100 * over, 3),
        "wall_ab_pct": round(100 * _overhead(times, "on", "off"), 2),
        "timeline_on_seconds": round(best["tl"], 6),
        "timeline_ring_events": len(ring_events),
        "timeline_byte_adds": len(byte_adds),
        "timeline_syncs": settles,
        "timeline_ring_ms": round(1e3 * ring_added, 4),
        "timeline_sync_ms": round(1e3 * sync_added, 4),
        "timeline_added_ms": round(1e3 * tl_added, 4),
        "timeline_overhead_pct": round(100 * tl_over, 2),
        "timeline_wall_ab_pct": round(100 * _overhead(times, "tl", "on"), 2),
        "timeline_disabled_events": disabled_events,
    }
    if assert_within is not None:
        # only claim a budget verdict when one was actually checked
        if over > assert_within:
            raise AssertionError(
                f"profiling overhead {out['overhead_pct']}% exceeds "
                f"the {assert_within * 100:g}% budget")
        out["within_budget"] = True
        if disabled_events:
            raise AssertionError(
                f"timeline ring recorded {disabled_events} events "
                f"while disabled (gate leak)")
        # 2ms absolute slack: at micro scale the 3% band is inside
        # timer jitter; at real scale the relative bound dominates.
        # The hard <3% acceptance bound is the DISABLED path, held by
        # the on/off budget above plus the zero-event gate check; this
        # enabled-ring bound is a regression tripwire. Like every
        # other bench here it widens to the caller's smoke fraction
        # (the 3% floor still binds any tighter caller).
        tl_frac = max(0.03, assert_within)
        if tl_added > tl_frac * median["on"] + 2e-3:
            raise AssertionError(
                f"timeline ring overhead "
                f"{out['timeline_overhead_pct']}% exceeds the "
                f"{tl_frac * 100:g}% budget")
        out["timeline_within_budget"] = True
    return out


#: timed repetitions of the armed sites' work in :func:`bench_chaos_overhead`
SITE_REPS = 2000


def bench_chaos_overhead(sf: float, iters: int, block_rows: int,
                         assert_within: float | None = None,
                         device="cuda", data=None, shard=None) -> dict:
    """Warm TPC-H Q1 with the chaos subsystem fully DISARMED (the
    production state: every injection site is one module-global bool
    check) vs ARMED with p=0.0 on the hot sites (the dormant-scenario
    state: per-site lookup + seeded roll, nothing ever fires). The
    disabled path is the acceptance bound — chaos must be free when
    off; ``assert_within`` fails the bench when the armed side exceeds
    disarmed by more than that fraction.

    With p=0 the two sides run the same code but inside ``chaos.hit``,
    so what arming adds is counted and timed: the most hits each site
    took in three armed scans, rolled ``SITE_REPS`` times between an
    ``install`` and a ``clear`` (the bench's armed side installs per
    statement), less the same hits disarmed, over the disarmed scan's
    median time. The ``iters`` rounds of the two sides on the card are
    reported beside it (``wall_ab_pct``, the median same-round ratio):
    a warm scan's host time moves 10% from round to round on a shared
    host, and arming adds tens of microseconds
    (``scripts/overhead_noise.py``). ``shard`` is a ``(shard, rows)``
    pair from :func:`lineitem_shard` to scan instead of building one."""
    from ydb_tpu_torch import chaos
    from ydb_tpu_torch.workload import tpch

    shard, n = shard or lineitem_shard("chaosov", sf, block_rows, device,
                                       data)
    prog = tpch.q1_program()

    # p=0.0 on every site the Q1 scan crosses: the armed side pays the
    # full lookup+roll machinery without a single fault firing (a
    # fired fault would change WHAT runs, not how fast the gate is)
    dormant = chaos.Scenario(seed=7, sites={
        "blob.get": {"kind": "io_error", "p": 0.0},
        "blob.get_range": {"kind": "io_error", "p": 0.0},
        "conveyor.task": {"kind": "delay", "p": 0.0},
    })

    def run_off():
        return shard.scan(prog)

    def run_armed():
        chaos.install(dormant)
        try:
            return shard.scan(prog)
        finally:
            chaos.clear()

    def armed_hits() -> dict:
        chaos.install(dormant)
        try:
            shard.scan(prog)
            return {site: st["hits"] for site, st in
                    chaos.counters_snapshot()["sites"].items()}
        finally:
            chaos.clear()

    def sites_once(arm: bool) -> float:
        """Seconds of one statement's site work, armed or not."""
        t0 = time.perf_counter()
        if arm:
            chaos.install(dormant)
        for site, k in hits.items():
            for _ in range(k):
                if chaos.hit(site) is not None:
                    raise AssertionError(f"a p=0 fault fired at {site}")
        if arm:
            chaos.clear()
        return time.perf_counter() - t0

    prev_force = chaos.CHAOS_FORCE
    try:
        chaos.CHAOS_FORCE = None
        chaos.clear()  # disarm + zero counters from any earlier run
        run_off()  # warm: compile + scan-cache fill, shared by both
        if chaos.counters_snapshot().get("sites"):
            raise AssertionError(
                "chaos sites counted hits on the disarmed path")
        chaos.CHAOS_FORCE = True  # open the gate for install()
        run_armed()
        _steady(shard)
        times, _ = _interleaved({"off": run_off, "armed": run_armed},
                                iters)
        # conveyor.task rolls where a pool worker, not the consumer
        # inline, runs a morsel, which depends on timing: take the most
        hits: dict = {}
        for _ in range(3):
            for site, k in armed_hits().items():
                hits[site] = max(hits.get(site, 0), k)
        site_s = {arm: statistics.median(
            sites_once(arm) for _ in range(SITE_REPS))
            for arm in (False, True)}
    finally:
        chaos.clear()
        chaos.CHAOS_FORCE = prev_force
    best = {k: min(v) for k, v in times.items()}
    median_off = statistics.median(times["off"])
    added = site_s[True] - site_s[False]
    over = added / median_off
    out = {
        "rows": n, "sf": sf, "rounds": len(times["off"]),
        "site_hits": hits,
        "chaos_off_seconds": round(best["off"], 6),
        "chaos_armed_seconds": round(best["armed"], 6),
        "chaos_off_rows_per_sec": round(n / best["off"]),
        "chaos_armed_rows_per_sec": round(n / best["armed"]),
        "chaos_off_median_seconds": round(median_off, 6),
        "chaos_added_ms": round(1e3 * added, 4),
        "overhead_pct": round(100 * over, 3),
        "wall_ab_pct": round(100 * _overhead(times, "armed", "off"), 2),
    }
    if assert_within is not None:
        if over > assert_within:
            raise AssertionError(
                f"chaos armed overhead {out['overhead_pct']}% exceeds "
                f"the {assert_within * 100:g}% budget")
        out["within_budget"] = True
    return out


def bench_leaksan_overhead(sf: float, iters: int, block_rows: int,
                           assert_within: float | None = None,
                           device="cuda", data=None) -> dict:
    """Warm TPC-H Q1 with the leak sanitizer DISABLED (the production
    state: every ``track()`` site is one module-global bool check
    returning None, every ``close()`` a None test) vs FORCED ON (every
    acquisition allocates a stack-bearing handle). Two invariants
    besides the timing: the disabled side must track ZERO handles, and
    the armed side must drain back to zero once the scan's conveyor
    work completes — a leak here is a bug in the resource layers, not a
    bench artifact. ``assert_within`` fails the bench when the armed
    side exceeds disabled by more than that fraction."""
    from ydb_tpu_torch.analysis import leaksan
    from ydb_tpu_torch.runtime.conveyor import shared_conveyor
    from ydb_tpu_torch.workload import tpch

    shard, n = lineitem_shard("leakov", sf, block_rows, device, data)
    prog = tpch.q1_program()

    def run_off():
        leaksan.set_force(False)
        return shard.scan(prog)

    def run_armed():
        leaksan.set_force(True)
        try:
            return shard.scan(prog)
        finally:
            leaksan.set_force(False)

    prev_force = leaksan.LEAKSAN_FORCE
    try:
        leaksan.reset()
        run_off()  # warm: compile + scan-cache fill, shared by both
        if leaksan.counts():
            raise AssertionError(
                "leaksan tracked handles on the disabled path: "
                f"{leaksan.counts()}")
        run_armed()  # warm the armed side (handle-alloc code paths)
        _steady(shard)
        shared_conveyor().wait_idle(timeout=30.0)
        if leaksan.counts():
            raise AssertionError(
                f"armed warm Q1 leaked handles: {leaksan.counts()}")
        times, _ = _interleaved({"off": run_off, "armed": run_armed}, iters)
    finally:
        leaksan.set_force(prev_force)
        leaksan.reset()
    best = {k: min(v) for k, v in times.items()}
    over = _overhead(times, "armed", "off")
    out = {
        "rows": n, "sf": sf, "round_seconds": _rounded(times),
        "leaksan_off_seconds": round(best["off"], 6),
        "leaksan_armed_seconds": round(best["armed"], 6),
        "leaksan_off_rows_per_sec": round(n / best["off"]),
        "leaksan_armed_rows_per_sec": round(n / best["armed"]),
        "overhead_pct": round(100 * over, 2),
        "drained": True,
    }
    if assert_within is not None:
        if over > assert_within:
            raise AssertionError(
                f"leaksan armed overhead {out['overhead_pct']}% "
                f"exceeds the {assert_within * 100:g}% budget")
        out["within_budget"] = True
    return out


def bench_memsan_overhead(sf: float, iters: int, block_rows: int,
                          assert_within: float | None = None,
                          device="cuda", data=None) -> dict:
    """Warm TPC-H Q1 with the memory sanitizer DISARMED (the
    production state: every ``armed()`` check is one module-global bool
    read, the raw allocators unpatched) vs FORCED ON (allocator
    wrappers installed, every charging seam walking ``nbytes_of`` over
    its pytree). Two invariants besides the timing: the armed warm
    statement must charge at least once (the seams are alive) and make
    ZERO unbudgeted device allocations — the runtime acceptance of
    devmem M001 on the engine tier. ``assert_within`` fails the bench
    when the armed side exceeds disarmed by more than that fraction
    (the <3% warm-Q1 tripwire)."""
    from ydb_tpu_torch.analysis import memsan
    from ydb_tpu_torch.workload import tpch

    shard, n = lineitem_shard("memov", sf, block_rows, device, data)
    prog = tpch.q1_program()

    def run_off():
        memsan.set_force(False)
        return shard.scan(prog)

    def run_armed():
        memsan.set_force(True)
        st = memsan.begin_statement("q1")
        try:
            return shard.scan(prog)
        finally:
            memsan.end_statement(st, enforce=False)
            memsan.set_force(False)

    warm_snap = None
    try:
        memsan.reset()
        run_off()  # warm: compile + scan-cache fill, shared by both
        run_armed()  # warm the armed side (wrapper + charge paths)
        _steady(shard)
        # one measured warm armed statement: the byte-ledger acceptance
        memsan.set_force(True)
        st = memsan.begin_statement("q1")
        try:
            shard.scan(prog)
        finally:
            warm_snap = memsan.end_statement(st, enforce=False)
            memsan.set_force(False)
        if warm_snap["unbudgeted"]:
            raise AssertionError(
                "armed warm Q1 made unbudgeted device allocations: "
                f"{warm_snap}")
        times, _ = _interleaved({"off": run_off, "armed": run_armed}, iters)
    finally:
        memsan.set_force(None)
        memsan.reset()
    best = {k: min(v) for k, v in times.items()}
    over = _overhead(times, "armed", "off")
    out = {
        "rows": n, "sf": sf, "round_seconds": _rounded(times),
        "memsan_off_seconds": round(best["off"], 6),
        "memsan_armed_seconds": round(best["armed"], 6),
        "memsan_off_rows_per_sec": round(n / best["off"]),
        "memsan_armed_rows_per_sec": round(n / best["armed"]),
        "warm_peak_bytes": warm_snap["peak"],
        "warm_charges": warm_snap["charges"],
        "warm_unbudgeted": 0,
        "overhead_pct": round(100 * over, 2),
    }
    if assert_within is not None:
        if over > assert_within:
            raise AssertionError(
                f"memsan armed overhead {out['overhead_pct']}% "
                f"exceeds the {assert_within * 100:g}% budget")
        out["within_budget"] = True
    return out


def bench_admission_overhead(sf: float, iters: int,
                             assert_within: float | None = None,
                             device="cuda") -> dict:
    """Warm TPC-H Q1 through the full ``Session.execute`` path with NO
    front door installed (the default state: one ``cluster.front_door
    is None`` attribute test per statement) vs the multi-tenant
    admission plane INSTALLED (``serving.install``) serving a single
    default-pool client — the uncontended fast path: tenant resolve,
    seat grant + release under the door lock, per-tenant SLO counters.
    The front door must be near-free for the single-tenant case or it
    cannot sit on every statement; ``assert_within`` fails the bench
    when the armed side exceeds the bare path by more than that
    fraction (the serving README's bar: <3% warm Q1)."""
    from ydb_tpu_torch import serving
    from ydb_tpu_torch.kqp.session import Cluster
    from ydb_tpu_torch.scheme.model import type_to_str
    from ydb_tpu_torch.workload import tpch
    from ydb_tpu_torch.workload.queries import TPCH

    data = tpch.TpchData(sf=sf, seed=5)
    n = len(data.tables["lineitem"]["l_orderkey"])
    q1 = TPCH["q1"]

    def boot(with_door):
        c = Cluster(device=device)
        if with_door:
            serving.install(c)
        s = c.session()
        schema = data.schema("lineitem")
        cols = ", ".join(f"{f.name} {type_to_str(f.type)}"
                         for f in schema.fields)
        s.execute(f"CREATE TABLE lineitem ({cols}, "
                  f"PRIMARY KEY (l_orderkey)) WITH (shards = 1)")
        src = data.tables["lineitem"]
        arrays = {}
        for f in schema.fields:
            v = src[f.name]
            if f.type.is_string:
                arrays[f.name] = [
                    bytes(x) for x in data.dicts[f.name].decode(
                        np.asarray(v, dtype=np.int32))]
            else:
                arrays[f.name] = v
        c.tables["lineitem"].insert(arrays)
        c._invalidate_plans()
        s.execute(q1)  # warm plan + compile caches
        return c, s

    sides = {"off": boot(False), "on": boot(True)}
    try:
        times, _ = _interleaved({label: functools.partial(sess.execute, q1)
                              for label, (_, sess) in sides.items()},
                             iters)
        snap = sides["on"][0].front_door.snapshot()
        pool = snap.get(serving.DEFAULT_TENANT, {})
        if not pool.get("admitted"):
            raise AssertionError(
                "front door counted no admissions on the armed side — "
                "the bench did not exercise the admission plane")
    finally:
        for c, _ in sides.values():
            c.stop()
    best = {k: min(v) for k, v in times.items()}
    over = _overhead(times, "on", "off")
    out = {
        "rows": n, "sf": sf, "round_seconds": _rounded(times),
        "admission_off_seconds": round(best["off"], 6),
        "admission_on_seconds": round(best["on"], 6),
        "admission_off_rows_per_sec": round(n / best["off"]),
        "admission_on_rows_per_sec": round(n / best["on"]),
        "overhead_pct": round(100 * over, 2),
        "admitted": pool.get("admitted"),
        "shed": pool.get("shed"),
    }
    if assert_within is not None:
        if over > assert_within:
            raise AssertionError(
                f"front-door admission overhead {out['overhead_pct']}% "
                f"exceeds the {assert_within * 100:g}% budget")
        out["within_budget"] = True
    return out


def bench_fusion(sf: float, iters: int, device="cuda") -> dict:
    """Whole-plan fusion A/B: TPC-H Q3 (semi + inner join feeding a
    grouped two-phase-aggregate top-k) executed fused — one
    donated-buffer dispatch per shape class (ssa.plan_fuse) — vs the
    per-node memo walk, same Database both sides, results asserted
    bit-identical (Q3's sort is fully tie-broken, so rows compare
    positionally)."""
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan.executor import Database, execute_plan
    from ydb_tpu_torch.ssa import plan_fuse
    from ydb_tpu_torch.workload import tpch

    data = tpch.TpchData(sf=sf, seed=5)
    db = Database(
        sources={t: ColumnSource(cols, data.schema(t), data.dicts)
                 for t, cols in data.tables.items()},
        dicts=data.dicts, device=device)
    plan = tpch.q3_plan()
    sig = plan_fuse.plan_signature(plan, db)
    if sig is None:
        raise AssertionError("q3 plan did not fuse")
    n = len(data.tables["lineitem"]["l_orderkey"])

    def run(force):
        old = plan_fuse.FUSE_FORCE
        plan_fuse.FUSE_FORCE = force
        try:
            out = execute_plan(plan, db, use_dq=False)
            _sync(device)
            return out
        finally:
            plan_fuse.FUSE_FORCE = old

    out: dict = {
        "rows": n, "sf": sf,
        # the walk dispatches (at least) one compiled fragment per plan
        # node; the fused path replaces all of them with one dispatch
        "fragment_dispatches": sig.fused_stages,
        "fused_dispatches": 1,
        "fragments_elided": sig.fused_stages - 1,
    }
    results = {}
    best = {"fused": float("inf"), "walk": float("inf")}
    for label, force in (("fused", True), ("walk", False)):
        results[label] = run(force)  # warm: trace + compile caches
    # interleave the sides so host drift hits both equally
    for _ in range(max(1, iters)):
        for label, force in (("fused", True), ("walk", False)):
            t0 = time.perf_counter()
            run(force)
            best[label] = min(best[label], time.perf_counter() - t0)
    for label in ("fused", "walk"):
        out[f"{label}_seconds"] = round(best[label], 6)
        out[f"{label}_rows_per_sec"] = round(n / best[label])
    out["fused_speedup"] = round(best["walk"] / best["fused"], 2)
    a, b = results["fused"], results["walk"]
    assert a.schema.names == b.schema.names
    av, aok = a.to_numpy(), a.validity_numpy()
    bv, bok = b.to_numpy(), b.validity_numpy()
    for name in a.schema.names:
        if not np.array_equal(aok[name], bok[name]) or not np.array_equal(
                np.where(aok[name], av[name], 0),
                np.where(bok[name], bv[name], 0)):
            raise AssertionError(f"fused/walk mismatch on {name}")
    out["identical"] = True
    return out


def bench_batching(sf: float, iters: int, batch: int = 4,
                   device="cuda") -> dict:
    """Micro-batched fused dispatch A/B (the kqp/batch.py serving
    tier's two device paths, measured bare):

    * serial — B back-to-back non-donating fused dispatches
      (``FusedPlan.run_shared``), one per statement, the batching-off
      baseline;
    * stacked — the SAME B statements' staged inputs stacked along a
      leading axis into ONE vmapped dispatch (``run_stacked``), each
      member sliced off the batched result (``slice_member``);
    * dedup — the identical-inputs fast path: ONE dispatch whose result
      every member shares (what the dispatcher runs when all members
      staged byte-identical blocks).

    Every stacked member and the dedup result are asserted bit-identical
    to the serial dispatch — the acceptance invariant the serving tier
    rides on."""
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan.executor import Database, _stage_fused_site
    from ydb_tpu_torch.ssa import plan_fuse
    from ydb_tpu_torch.workload import tpch

    data = tpch.TpchData(sf=sf, seed=5)
    db = Database(
        sources={t: ColumnSource(cols, data.schema(t), data.dicts)
                 for t, cols in data.tables.items()},
        dicts=data.dicts, device=device)
    plan = tpch.q3_plan()
    sig = plan_fuse.plan_signature(plan, db)
    if sig is None:
        raise AssertionError("q3 plan did not fuse")
    fused = plan_fuse.build(sig, db)
    inputs = {s.key: _stage_fused_site(s, db) for s in sig.sites}
    n = len(data.tables["lineitem"]["l_orderkey"])

    def run_serial():
        out = None
        for _ in range(batch):
            out, totals = fused.run_shared(inputs)
            assert not fused.overflowed(totals)
        _sync(device)
        return out

    def run_stack():
        out, totals = fused.run_stacked([inputs] * batch)
        assert not fused.overflowed(totals)
        _sync(device)
        return out

    def run_dedup():
        out, totals = fused.run_shared(inputs)
        assert not fused.overflowed(totals)
        _sync(device)
        return out

    sides = {"serial": run_serial, "stacked": run_stack,
             "dedup": run_dedup}
    results = {k: f() for k, f in sides.items()}  # warm (trace+compile)
    best = {k: float("inf") for k in sides}
    for _ in range(max(1, iters)):
        # interleaved so host drift hits every side equally
        for k, f in sides.items():
            t0 = time.perf_counter()
            f()
            best[k] = min(best[k], time.perf_counter() - t0)

    ser = results["serial"]
    sv, sok = ser.to_numpy(), ser.validity_numpy()

    def check(blk, label):
        bv, bok = blk.to_numpy(), blk.validity_numpy()
        for name in ser.schema.names:
            if not np.array_equal(sok[name], bok[name]) \
                    or not np.array_equal(
                        np.where(sok[name], sv[name], 0),
                        np.where(bok[name], bv[name], 0)):
                raise AssertionError(f"{label} mismatch on {name}")

    for i in range(batch):
        check(plan_fuse.slice_member(results["stacked"], i),
              f"stacked[{i}]")
    check(results["dedup"], "dedup")

    out = {"rows": n, "sf": sf, "batch": batch, "identical": True}
    for k in sides:
        out[f"{k}_seconds"] = round(best[k], 6)
        # every side serves all B statements: serial with B dispatches,
        # stacked/dedup with one
        out[f"{k}_seconds_per_statement"] = round(best[k] / batch, 6)
    out["stacked_speedup"] = round(best["serial"] / best["stacked"], 2)
    out["dedup_speedup"] = round(best["serial"] / best["dedup"], 2)
    return out


#: fan-out of the uniform-key case: the stats bucket is mean load x
#: ``SAFETY_MARGIN`` (1.5), so under 8 destinations it cannot come out
#: 4x smaller than the full bucket (4 shards: 0.375 of it at best)
SHUFFLE_UNIFORM_SHARDS = 8


def bench_shuffle(rows_per_shard: int, iters: int, with_skew: bool = True,
                  device=None, keys: "np.ndarray | None" = None,
                  n_shards: int = 4) -> dict:
    """Stats-sized vs full-capacity shuffle A/B on the shard mesh
    (``parallel/shuffle.py``), in the reference's three cases.

    Uniform random keys repartitioned over ``SHUFFLE_UNIFORM_SHARDS``
    shards with the send bucket sized two ways: full local capacity
    (always sufficient, ships n_shards x capacity rows) vs
    ``shuffle.size_buckets`` (mean load x safety margin + the count-min
    heavy-hitter bound from a real sketch over the keys). Row multisets
    asserted equal between the sides, every key on the shard its hash
    names (so colocated), and the stats bucket must be >=4x smaller. With ``keys`` (a caller's key
    column, e.g. ClickBench URL ids), the same A/B over those keys cut
    into ``n_shards`` contiguous shards, equal and colocated on both
    sides; an undersized stats bucket grows to the reported worst count
    and re-exchanges. A 100%-skew case (every key identical, no stats,
    ``n_shards`` shards) then exercises the overflow protocol: the
    undersized exchange reports its worst per-destination count, the
    bucket grows to that shape class, and the re-exchange is asserted
    lossless. Seconds are host clock around an exchange that ends in a
    device sync, the sides in turns."""
    from ydb_tpu_torch import dtypes, native
    from ydb_tpu_torch.blocks.block import TableBlock
    from ydb_tpu_torch.device import resolve_device
    from ydb_tpu_torch.parallel import shuffle
    from ydb_tpu_torch.parallel.mesh import make_mesh
    from ydb_tpu_torch.ssa.plan_fuse import shape_class
    from ydb_tpu_torch.stats.sketch import CountMinSketch

    dev = resolve_device(device)
    sch = dtypes.schema(("k", dtypes.INT64), ("v", dtypes.INT64))

    def stage(key_arrays, per):
        # v numbers every row across the mesh (shard by shard), so lost
        # or doubled rows show
        starts = np.cumsum([0] + [len(k) for k in key_arrays])
        return [TableBlock.from_numpy(
            {"k": k, "v": np.arange(len(k), dtype=np.int64) + starts[d]},
            sch, capacity=per, device=dev)
            for d, k in enumerate(key_arrays)]

    def check(out, keys_by_row, label):
        """Every row exactly once with its own key (``v`` numbers the
        rows), and on the shard its key hashes to (the host hash of
        ``ydb_tpu_torch.native``, which the device hash must equal):
        linear passes, no sort."""
        seen = np.zeros(len(keys_by_row), dtype=np.int64)
        for i, blk in enumerate(out):
            data, valid = blk.host_columns()
            k, v = data["k"], data["v"]
            assert np.array_equal(keys_by_row[v], k), \
                f"{label} exchange changed keys"
            seen += np.bincount(v, minlength=len(keys_by_row))
            dest = native.hash_rows([k], [valid["k"]]) % np.uint64(len(out))
            assert (dest == i).all(), f"{label}: a key on the wrong shard"
        assert (seen == 1).all(), f"{label} exchange lost or doubled rows"

    def exchange(mesh, blocks, B):
        """Repartition at bucket B, growing it to the worst count and
        exchanging again until nothing overflowed."""
        grows = 0
        while True:
            out, worst = shuffle.repartition(mesh, blocks, ["k"],
                                             bucket_rows=B,
                                             with_counts=True)
            w = int(worst)
            if w <= B:
                return out, B, grows
            B = shape_class(w)
            grows += 1

    def ab(key_arrays, per, label):
        t_case = time.perf_counter()
        mesh = make_mesh(len(key_arrays), devices=[dev])
        n = len(key_arrays)
        sk = CountMinSketch()
        for arr in key_arrays:
            sk.add_many(arr)
        old = shuffle.SHUFFLE_STATS_FORCE
        shuffle.SHUFFLE_STATS_FORCE = True
        try:
            stats_B = shuffle.size_buckets(per, n, heavy=sk.max_freq())
        finally:
            shuffle.SHUFFLE_STATS_FORCE = old
        want = np.concatenate(key_arrays)
        blocks = stage(key_arrays, per)
        _sync(dev)
        setup_s = time.perf_counter() - t_case
        out = {"rows": len(want), "shards": n, "rows_per_shard": per,
               "full_bucket_rows": per, "heavy_bound": sk.max_freq(),
               "stats_bucket_rows_sized": stats_B}
        results, buckets = {}, {}
        t0 = time.perf_counter()
        for side, B in (("stats", stats_B), ("full", per)):
            blk, B, grows = exchange(mesh, blocks, B)
            assert side == "stats" or grows == 0, (label, side, grows)
            results[side], buckets[side] = blk, B
            out[f"{side}_grows"] = grows
        out["stats_bucket_rows"] = buckets["stats"]
        out["capacity_ratio"] = round(per / buckets["stats"], 2)
        for side in ("stats", "full"):
            # every shard sends n buckets of B rows each exchange
            out[f"{side}_bytes_per_shard"] = \
                shuffle.exchange_bytes_per_device(sch, n, buckets[side])

        def run(B):
            def go():
                shuffle.repartition(mesh, blocks, ["k"], bucket_rows=B)
                _sync(dev)
            return go

        _sync(dev)
        first_s = time.perf_counter() - t0
        wall, _ = _interleaved({side: run(buckets[side])
                                for side in ("stats", "full")}, iters)
        for side, ts in wall.items():
            out[f"{side}_rows_per_sec"] = round(len(want) / min(ts))
        out["shuffle_speedup"] = round(min(wall["full"]) /
                                       min(wall["stats"]), 2)
        t0 = time.perf_counter()
        for side, blk in results.items():
            check(blk, want, f"{label} {side}")
        out["identical"] = True
        # host seconds of the case: staging with the sketch, the first
        # exchanges (grows included), the checks, and all of it
        out.update(setup_s=setup_s, first_exchanges_s=first_s,
                   check_s=time.perf_counter() - t0,
                   seconds=time.perf_counter() - t_case)
        return out

    rng = np.random.default_rng(11)
    n_uni = SHUFFLE_UNIFORM_SHARDS
    uniform = [rng.integers(0, 1 << 30, rows_per_shard).astype(np.int64)
               for _ in range(n_uni)]
    report: dict = {"device": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu")}
    report.update(ab(uniform, rows_per_shard, "uniform"))
    assert report["stats_grows"] == 0, report
    assert report["capacity_ratio"] >= 4, (
        f"uniform keys sized {report['stats_bucket_rows']} vs full "
        f"{rows_per_shard}: ratio {report['capacity_ratio']} < 4")

    if keys is not None:
        per = -(-len(keys) // n_shards)
        parts = [np.asarray(keys[i * per:(i + 1) * per], dtype=np.int64)
                 for i in range(n_shards)]
        report["keyed"] = ab(parts, per, "keyed")

    # 100% skew, no stats: every row routes to one destination, so the
    # mean-sized bucket must overflow, report its worst count, grow to
    # that shape class, and re-exchange losslessly
    if not with_skew:  # smoke keeps tier-1 cheap; --shuffle runs it
        return report
    per = rows_per_shard
    mesh = make_mesh(n_shards, devices=[dev])
    old = shuffle.SHUFFLE_STATS_FORCE
    shuffle.SHUFFLE_STATS_FORCE = True
    try:
        B = shuffle.size_buckets(per, n_shards, heavy=0)
    finally:
        shuffle.SHUFFLE_STATS_FORCE = old
    skewed = [np.full(per, 42, dtype=np.int64)] * n_shards
    blk, grown, grows = exchange(mesh, stage(skewed, per), B)
    skew = {"shards": n_shards, "initial_bucket_rows": B, "grows": grows,
            "grown_bucket_rows": grown}
    assert grows >= 1, "skew case never overflowed"
    check(blk, np.concatenate(skewed), "skew grow")
    skew["identical"] = True
    report["skew"] = skew
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ydb_tpu_torch.obs.kernelbench",
        description="group-by + block staging micro-benchmarks")
    ap.add_argument("--rows", type=int, default=1 << 21)
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--aggs", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--block-rows", type=int, default=1 << 18)
    ap.add_argument("--pruning", action="store_true",
                    help="zone-map scan-pruning A/B micro-bench")
    ap.add_argument("--chunk-rows", type=int, default=1 << 14,
                    help="portion chunk size for --pruning")
    ap.add_argument("--streaming", action="store_true",
                    help="morsel-pipeline vs serialized cold-scan A/B")
    ap.add_argument("--resident", action="store_true",
                    help="HBM-resident vs staged warm scan A/B")
    ap.add_argument("--profile-overhead", action="store_true",
                    help="profiling on-vs-off warm Q1 A/B micro-bench")
    ap.add_argument("--chaos-overhead", action="store_true",
                    help="chaos disarmed vs armed-dormant warm Q1 A/B")
    ap.add_argument("--leaksan-overhead", action="store_true",
                    help="leak sanitizer disabled vs armed warm Q1 A/B")
    ap.add_argument("--admission-overhead", action="store_true",
                    help="front door absent vs installed warm Q1 A/B")
    ap.add_argument("--memsan-overhead", action="store_true",
                    help="memory sanitizer disarmed vs armed warm Q1"
                         " A/B")
    ap.add_argument("--fusion", action="store_true",
                    help="whole-plan fused vs per-fragment warm Q3 A/B")
    ap.add_argument("--batching", action="store_true",
                    help="stacked/dedup vs serial fused dispatch A/B")
    ap.add_argument("--batch", type=int, default=4,
                    help="members per micro-batch for --batching")
    ap.add_argument("--shuffle", action="store_true",
                    help="stats-sized vs full-capacity shuffle A/B")
    ap.add_argument("--shuffle-rows", type=int, default=1 << 15,
                    help="rows per shard for --shuffle")
    ap.add_argument("--device", default="cuda",
                    help="device the benches run on (default cuda)")
    ap.add_argument("--sf", type=float, default=0.05,
                    help="TPC-H scale factor for --profile-overhead"
                         " and --fusion")
    ap.add_argument("--json", action="store_true",
                    help="one JSON object on stdout")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny correctness-only run (tier-1 wiring)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.rows, args.groups, args.aggs, args.iters = 5000, 7, 2, 1
        args.block_rows = 2048
        args.chunk_rows = 256
        args.sf = 0.01
        args.shuffle_rows = 8192

    from ydb_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    report = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "group_by": bench_group_by(args.rows, args.groups, args.aggs,
                                   args.iters, device=dev),
        "staging": bench_staging(args.rows, args.block_rows, args.iters,
                                 device=dev),
    }
    if args.pruning or args.smoke:
        report["pruning"] = bench_pruning(
            args.rows, args.chunk_rows, args.iters, device=dev)
    if args.resident or args.smoke:
        report["resident"] = bench_resident(
            args.rows, args.chunk_rows, args.iters, device=dev)
    if args.streaming or args.smoke:
        report["streaming"] = bench_streaming(
            args.rows, args.chunk_rows, args.iters, device=dev)
    if args.profile_overhead or args.smoke:
        # smoke: tiny run, lax bound (machinery + no-catastrophe
        # guard); real sizes measure the 2% default-on budget
        report["profile_overhead"] = bench_profile_overhead(
            args.sf, max(3, args.iters), args.block_rows,
            assert_within=(0.5 if args.smoke else None), device=dev)
    if args.chaos_overhead or args.smoke:
        # smoke: tiny run, lax bound (machinery + no-catastrophe
        # guard); real sizes hold the 1% disabled-path budget
        report["chaos_overhead"] = bench_chaos_overhead(
            args.sf, max(3, args.iters), args.block_rows,
            assert_within=(0.5 if args.smoke else 0.01), device=dev)
    ab_rounds = SMOKE_AB_ROUNDS if args.smoke else max(3, args.iters)
    if args.leaksan_overhead or args.smoke:
        # smoke: tiny run, lax bound (machinery + no-catastrophe
        # guard); real sizes hold the 1% disabled-path budget
        report["leaksan_overhead"] = bench_leaksan_overhead(
            args.sf, ab_rounds, args.block_rows,
            assert_within=(0.5 if args.smoke else 0.01), device=dev)
    if args.admission_overhead or args.smoke:
        # smoke: tiny run, lax bound (machinery + no-catastrophe
        # guard); real sizes hold the 3% front-door budget
        report["admission_overhead"] = bench_admission_overhead(
            args.sf, ab_rounds,
            assert_within=(0.5 if args.smoke else 0.03), device=dev)
    if args.memsan_overhead or args.smoke:
        # smoke: tiny run, lax bound (machinery + no-catastrophe
        # guard); real sizes hold the 3% warm-Q1 tripwire
        report["memsan_overhead"] = bench_memsan_overhead(
            args.sf, ab_rounds, args.block_rows,
            assert_within=(0.5 if args.smoke else 0.03), device=dev)
    if args.fusion or args.smoke:
        report["fusion"] = bench_fusion(args.sf, max(3, args.iters),
                                        device=dev)
    if args.batching or args.smoke:
        report["batching"] = bench_batching(
            args.sf, max(1, args.iters),
            batch=(3 if args.smoke else args.batch), device=dev)
    if args.shuffle or args.smoke:
        report["shuffle"] = bench_shuffle(
            args.shuffle_rows, args.iters, with_skew=args.shuffle,
            device=dev)
    if args.json:
        print(json.dumps(report))
    else:
        gb, st = report["group_by"], report["staging"]
        print(f"device={report['device']}")
        print(f"group-by rows={gb['rows']} groups={gb['groups']}: "
              f"fused {gb.get('fused_rows_per_sec'):,} rows/s, "
              f"per-agg {gb.get('peragg_rows_per_sec'):,} rows/s "
              f"(x{gb.get('fused_speedup')}), "
              f"oracle={gb.get('oracle_check', 'skipped')}")
        print(f"staging rows={st['rows']} blocks={st['blocks']}: "
              f"{st['staging_rows_per_sec']:,} rows/s")
        if "pruning" in report:
            pr = report["pruning"]
            print(f"pruning rows={pr['rows']}: chunks "
                  f"{pr.get('stats_chunks_read')} read vs "
                  f"{pr.get('nostats_chunks_read')} unpruned "
                  f"({pr.get('chunks_skipped_per_sec'):,} skipped/s, "
                  f"x{pr.get('pruning_speedup')} speedup, "
                  f"identical={pr.get('identical')})")
        if "resident" in report:
            rr = report["resident"]
            print(f"resident rows={rr['rows']}: "
                  f"{rr['resident_rows_per_sec']:,} rows/s vs staged "
                  f"{rr['staged_rows_per_sec']:,} rows/s "
                  f"(x{rr['resident_speedup']}, "
                  f"{rr['resident_portions']} portions / "
                  f"{rr['resident_bytes']:,} B pinned, "
                  f"identical={rr['identical']})")
        if "streaming" in report:
            sm = report["streaming"]
            pl = sm.get("pipeline") or {}
            print(f"streaming rows={sm['rows']}: pipelined "
                  f"{sm['pipelined_rows_per_sec']:,} rows/s vs "
                  f"serialized {sm['serialized_rows_per_sec']:,} "
                  f"rows/s (x{sm['pipeline_speedup']}, overlap="
                  f"{sm.get('movement_compute_overlap')}, "
                  f"{pl.get('morsels_io')} flights / "
                  f"{pl.get('stolen')} stolen, "
                  f"identical={sm['identical']})")
        if "profile_overhead" in report:
            po = report["profile_overhead"]
            print(f"profile overhead rows={po['rows']}: "
                  f"on {po['profile_on_rows_per_sec']:,} rows/s vs "
                  f"off {po['profile_off_rows_per_sec']:,} rows/s "
                  f"({po['overhead_pct']:+.2f}%); timeline ring "
                  f"{po['timeline_overhead_pct']:+.2f}% "
                  f"(disabled events="
                  f"{po['timeline_disabled_events']})")
        if "chaos_overhead" in report:
            co = report["chaos_overhead"]
            print(f"chaos overhead rows={co['rows']}: armed "
                  f"{co['chaos_armed_rows_per_sec']:,} rows/s vs off "
                  f"{co['chaos_off_rows_per_sec']:,} rows/s "
                  f"({co['overhead_pct']:+.2f}%)")
        if "leaksan_overhead" in report:
            lo = report["leaksan_overhead"]
            print(f"leaksan overhead rows={lo['rows']}: armed "
                  f"{lo['leaksan_armed_rows_per_sec']:,} rows/s vs off "
                  f"{lo['leaksan_off_rows_per_sec']:,} rows/s "
                  f"({lo['overhead_pct']:+.2f}%, "
                  f"drained={lo['drained']})")
        if "admission_overhead" in report:
            ao = report["admission_overhead"]
            print(f"admission overhead rows={ao['rows']}: door "
                  f"{ao['admission_on_rows_per_sec']:,} rows/s vs off "
                  f"{ao['admission_off_rows_per_sec']:,} rows/s "
                  f"({ao['overhead_pct']:+.2f}%, "
                  f"admitted={ao['admitted']})")
        if "memsan_overhead" in report:
            mo = report["memsan_overhead"]
            print(f"memsan overhead rows={mo['rows']}: armed "
                  f"{mo['memsan_armed_rows_per_sec']:,} rows/s vs off "
                  f"{mo['memsan_off_rows_per_sec']:,} rows/s "
                  f"({mo['overhead_pct']:+.2f}%, warm peak "
                  f"{mo['warm_peak_bytes']:,} bytes, "
                  f"unbudgeted={mo['warm_unbudgeted']})")
        if "fusion" in report:
            fu = report["fusion"]
            print(f"fusion rows={fu['rows']}: fused "
                  f"{fu['fused_rows_per_sec']:,} rows/s vs walk "
                  f"{fu['walk_rows_per_sec']:,} rows/s "
                  f"(x{fu['fused_speedup']}, "
                  f"{fu['fused_dispatches']} dispatch vs "
                  f"{fu['fragment_dispatches']} fragments, "
                  f"identical={fu['identical']})")
        if "batching" in report:
            ba = report["batching"]
            print(f"batching rows={ba['rows']} batch={ba['batch']}: "
                  f"serial {ba['serial_seconds_per_statement']}s/stmt "
                  f"vs stacked "
                  f"{ba['stacked_seconds_per_statement']}s/stmt "
                  f"(x{ba['stacked_speedup']}) vs dedup "
                  f"{ba['dedup_seconds_per_statement']}s/stmt "
                  f"(x{ba['dedup_speedup']}, "
                  f"identical={ba['identical']})")
        if "shuffle" in report:
            sh = report["shuffle"]
            print(f"shuffle rows={sh['rows']} shards={sh['shards']}: "
                  f"stats {sh['stats_rows_per_sec']} rows/s vs full "
                  f"{sh['full_rows_per_sec']} rows/s "
                  f"(x{sh['shuffle_speedup']}, bucket "
                  f"{sh['stats_bucket_rows']} vs {sh['full_bucket_rows']}"
                  f" rows, identical={sh['identical']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
