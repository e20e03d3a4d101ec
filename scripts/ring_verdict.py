#!/usr/bin/env python3
"""The timeline ring's overhead verdict of
``ydb_tpu_torch/obs/kernelbench.py:bench_profile_overhead`` as phase 12 of
``chip_smoke.py`` takes it, on one NVIDIA GPU, for the port in ``--tree``
(this checkout by default, or an unpacked older commit, so two versions
run in turns in one call):

    python3 scripts/ring_verdict.py [--tree DIR] [--sf 1] [--rounds 45]
                                    [--block-rows 262144]

Warm TPC-H Q1 from one ColumnShard at ``--sf`` (seed 5), profiling off,
on, and on with the ring, over ``--rounds`` interleaved rounds. Prints
the card's name and power limit, then one JSON object: the tree, the
rounds, the ring's verdict (``timeline_overhead_pct``), the band it is
held to (3% of the profiled scan's median + 2 ms), and every
``timeline_*`` key the tree's bench reports (a tree whose verdict counts
and times the ring's work also reports the wall A/B beside it). No
budget is asserted: a verdict outside its band is printed, not raised.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="root holding ydb_tpu_torch/")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=45)
    ap.add_argument("--block-rows", type=int, default=1 << 18)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("ring_verdict: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    print(smi, flush=True)

    from ydb_tpu_torch.obs import kernelbench
    from ydb_tpu_torch.workload import tpch

    assert kernelbench.__file__.startswith(os.path.abspath(args.tree))
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    shard = kernelbench.lineitem_shard(
        "ring", args.sf, args.block_rows, dev,
        tpch.TpchData(sf=args.sf, seed=5))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = kernelbench.bench_profile_overhead(
        args.sf, args.rounds, args.block_rows, device=dev, shard=shard)
    bench_s = time.perf_counter() - t0
    on_s = out.get("profile_on_median_seconds")  # older trees lack it
    band_ms = None if on_s is None else 1e3 * 0.03 * on_s + 2.0
    print(json.dumps({
        "ring_verdict": {
            "tree": os.path.abspath(args.tree), "rounds": out["rounds"],
            "rows": out["rows"], "load_s": load_s, "bench_s": bench_s,
            "profile_off_median_seconds": out["profile_off_median_seconds"],
            "band_ms": band_ms,
            **{k: v for k, v in out.items() if k.startswith("timeline")}},
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
