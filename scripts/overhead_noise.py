#!/usr/bin/env python3
"""How far the host-overhead verdicts of ``ydb_tpu_torch/obs/kernelbench.py``
move on noise alone, on one NVIDIA GPU.

Warm TPC-H Q1 from one ColumnShard (the shape ``chip_smoke.py`` phase 12
gates on), ``--repeats`` times:

  aa       the same scan on both sides (true overhead 0) over
           ``--gate-rounds`` interleaved rounds: the median of
           same-round ratios (``paired``, the wall A/B the benches
           report), the ratio of each side's minimum (``min``, the
           verdict the benches had before), both on the host clock and
           on the process's CPU time (``cpu_``); the same pair over
           ``--long-rounds`` rounds as the median same-round difference
           over the median (``long_pct``, the profiling verdict); and
           the same over ``--long-rounds`` on the layout twin (every
           256th row, in blocks and chunks of 1/256 the rows: the same
           blocks, chunks and spans), with the twin's own median time
  chaos    ``bench_chaos_overhead`` as phase 12 runs it (no budget held)
  profile  ``bench_profile_overhead`` likewise, ``--long-rounds`` rounds

    python3 scripts/overhead_noise.py [--sf 1] [--repeats 3]
                                      [--gate-rounds 9] [--long-rounds 90]
                                      [--out FILE]

One JSON object a line on stdout; ``--out`` also writes them all as one
JSON list.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

#: row divisor of the layout twin
SHRINK = 256


def ratios(times: dict) -> dict:
    """``b`` over ``a`` in %: the median of same-round ratios and the
    ratio of the two minima."""
    from ydb_tpu_torch.obs import kernelbench

    return {"paired_pct": round(100 * kernelbench._overhead(times, "b", "a"),
                                3),
            "min_pct": round(100 * (min(times["b"]) / min(times["a"]) - 1),
                             3)}


def twin_shard(data, block_rows: int, device):
    """Every ``SHRINK``-th lineitem row in blocks and chunks of
    1/``SHRINK`` the rows: the same portions, chunks and blocks."""
    from ydb_tpu_torch.engine.blobs import MemBlobStore
    from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
    from ydb_tpu_torch.workload import tpch

    li = {k: v[::SHRINK] for k, v in data.tables["lineitem"].items()}
    shard = ColumnShard(
        "aa-twin", tpch.LINEITEM_SCHEMA, MemBlobStore(), dicts=data.dicts,
        config=ShardConfig(compact_portion_threshold=10 ** 9,
                           scan_block_rows=block_rows // SHRINK,
                           portion_chunk_rows=(1 << 16) // SHRINK),
        device=device)
    shard.commit([shard.write(li)])
    return shard, len(li["l_orderkey"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--gate-rounds", type=int, default=9)
    ap.add_argument("--long-rounds", type=int, default=90)
    ap.add_argument("--block-rows", type=int, default=1 << 18)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from ydb_tpu_torch.device import resolve_device
    from ydb_tpu_torch.obs import kernelbench as kb
    from ydb_tpu_torch.workload import tpch

    dev = resolve_device(args.device)
    smi = ""
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    data = tpch.TpchData(sf=args.sf, seed=5)
    prog = tpch.q1_program()
    shard, n = kb.lineitem_shard("aa", args.sf, args.block_rows, dev, data)
    twin, n_twin = twin_shard(data, args.block_rows, dev)
    for sh in (shard, twin):
        sh.scan(prog)
        kb._steady(sh)
    lines = [{"card": smi or str(dev), "sf": args.sf, "rows": n,
              "twin_rows": n_twin, "gate_rounds": args.gate_rounds,
              "long_rounds": args.long_rounds, "pid": os.getpid(),
              "setup_s": round(time.perf_counter() - t0, 3),
              "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)

    def emit(row):
        lines.append(row)
        print(json.dumps(row), flush=True)

    def pair(sh):
        def scan():
            return sh.scan(prog)

        return {"a": scan, "b": scan}

    for rep in range(args.repeats):
        wall, cpu = kb._interleaved(pair(shard), args.gate_rounds)
        long, _ = kb._interleaved(pair(shard), args.long_rounds)
        tw, _ = kb._interleaved(pair(twin), args.long_rounds)
        base = statistics.median(long["a"])
        emit({"bench": "aa", "repeat": rep,
              "median_s": round(statistics.median(wall["a"]), 6),
              **ratios(wall),
              **{f"cpu_{k}": v for k, v in ratios(cpu).items()},
              "cpu_distinct_s": sorted({round(t, 4) for t in cpu["a"]})[:5],
              "long_median_s": round(base, 6),
              "long_pct": round(100 * kb._added(long, "b", "a") / base, 3),
              "twin_median_s": round(statistics.median(tw["a"]), 6),
              "twin_pct": round(
                  100 * kb._added(tw, "b", "a") / statistics.median(tw["a"]),
                  3),
              "round_seconds": kb._rounded(wall)})
        ch = kb.bench_chaos_overhead(args.sf, args.gate_rounds,
                                     args.block_rows, device=dev, data=data)
        emit({"bench": "chaos", "repeat": rep, **ch})
        pr = kb.bench_profile_overhead(args.sf, args.long_rounds,
                                       args.block_rows, device=dev,
                                       data=data)
        emit({"bench": "profile", "repeat": rep, **pr})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
