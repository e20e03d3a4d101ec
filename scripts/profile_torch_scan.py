#!/usr/bin/env python3
"""Where the time goes on the torch port's scan path, on one NVIDIA GPU.

Stages the same data as ``chip_smoke.py`` (TPC-H lineitem at ``--sf``,
ClickBench hits at ``--hits-rows``, device-resident blocks of 1<<20
rows), runs each query once to warm up, then once more under
``torch.profiler`` and prints, per query: wall time, summed device
kernel time, the device's busy share of the wall time, the number of
kernel launches, and the kernels that took the most device time.

    python3 scripts/profile_torch_scan.py [--sf 10] [--hits-rows 10000000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_stats(prof, top: int) -> tuple[float, int, list]:
    """(busy µs as the union of device intervals, launches, top kernels)
    from the device-side events of a profile."""
    from torch.autograd import DeviceType

    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name: dict = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    return busy, len(kern), [
        {"name": k[:80], "ms": t / 1e3, "count": n} for k, (t, n) in ranked[:top]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--hits-rows", type=int, default=10_000_000)
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_scan: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.workload import clickbench, tpch

    dev = torch.device("cuda", 0)
    print(chip_smoke.smi_line(), flush=True)
    tp = tpch.TpchData(sf=args.sf, seed=42)
    (ex1, ex6), li_blocks, _ = chip_smoke.stage(
        ColumnSource(tp.tables["lineitem"], tpch.LINEITEM_SCHEMA, tp.dicts),
        (tpch.q1_program(), tpch.q6_program()), dev)
    cb = clickbench.ClickBenchData(rows=args.hits_rows, seed=42)
    (ex33, ex36), cb_blocks, _ = chip_smoke.stage(
        ColumnSource(cb.hits, clickbench.HITS_SCHEMA, cb.dicts),
        (clickbench.q33_program(), clickbench.q36_program()), dev)
    runs = [("q1", ex1, li_blocks, None), ("q6", ex6, li_blocks, None),
            ("q33_fused", ex33, cb_blocks, True),
            ("q36_fused", ex36, cb_blocks, True),
            ("q33_peragg", ex33, cb_blocks, False),
            ("q36_peragg", ex36, cb_blocks, False)]
    report = {}
    for name, ex, blocks, fused in runs:
        kernels.FUSED_FORCE = fused
        try:
            ex.run_stream(blocks)  # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ex.run_stream(blocks)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            kernels.FUSED_FORCE = None
        busy_us, launches, top = kernel_stats(prof, args.top)
        report[name] = {
            "wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernel_launches": launches,
            "top_kernels": top,
        }
        print(json.dumps({name: report[name]}), flush=True)
    print(json.dumps({"profile": {k: {kk: v for kk, v in r.items()
                                      if kk != "top_kernels"}
                                  for k, r in report.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
