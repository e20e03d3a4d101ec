#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` (DQ across processes, the native host
library, the mesh scan and shuffle) on its own, on one NVIDIA GPU.

    python3 scripts/wire_mesh_alone.py [--sf 10] [--hits-rows 10000000]

It makes what the phase reuses of phases 3-4 first: TPC-H lineitem at
``--sf`` and ClickBench hits at ``--hits-rows`` (seed 42), their
single-shard ``ScanExecutor`` results for Q1, Q6, q33 and q36 (both
group-by lowerings) on the card, and the numpy answers. It prints the
host's Python, torch and CUDA versions and the card's name and power
limit, then the phase's lines as ``chip_smoke.py`` prints them; exits
non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale of the mesh's lineitem (default 10)")
    ap.add_argument("--hits-rows", type=int, default=10_000_000,
                    help="ClickBench hits rows (default 10000000)")
    args = ap.parse_args(argv)

    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("wire_mesh_alone: needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from ydb_tpu_torch.engine.scan import ColumnSource, ScanExecutor
    from ydb_tpu_torch.ssa import cuda_kernels as ck
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.workload import clickbench, tpch

    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    tp = tpch.TpchData(sf=args.sf, seed=42)
    cb = clickbench.ClickBenchData(rows=args.hits_rows, seed=42)
    li = tp.tables["lineitem"]
    li_src = ColumnSource(li, tpch.LINEITEM_SCHEMA, tp.dicts)
    cb_src = ColumnSource(cb.hits, clickbench.HITS_SCHEMA, cb.dicts)
    single = {}
    for name, prog, src, force in (
            ("q1", tpch.q1_program(), li_src, None),
            ("q6", tpch.q6_program(), li_src, None),
            ("q33_fused", clickbench.q33_program(), cb_src, True),
            ("q36_fused", clickbench.q36_program(), cb_src, True),
            ("q33_peragg", clickbench.q33_program(), cb_src, False),
            ("q36_peragg", clickbench.q36_program(), cb_src, False)):
        kernels.FUSED_FORCE = force
        try:
            single[name] = ScanExecutor(prog, src, device=dev).execute()
        finally:
            kernels.FUSED_FORCE = None
    inputs = cs.mesh_inputs(
        tp, cb, single, cs.numpy_q1(li, tpch._days("1998-12-01") - 90),
        cs.numpy_q6(li, tpch._days("1994-01-01"), tpch._days("1995-01-01")),
        clickbench.q33_q36_answers(cb))
    del tp, cb, li, li_src, cb_src
    cs.log(f"inputs (sf {args.sf}, {args.hits_rows} hits rows, single-shard "
           f"results, numpy answers) in {time.perf_counter() - t0:.1f} s")
    cs.wire_mesh_phase(dev, ck, inputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
