#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` (monitoring, coordination and load) on its
own, on one NVIDIA GPU: phase 10 builds its TPC-H store at ``--sf``, then
``monitor_phase`` runs on it; the store is removed after.

    python3 scripts/monitor_alone.py [--sf 1]

Before that it prints the host's Python, torch and CUDA versions and
whether the wire libraries of the gRPC front (grpc, google.protobuf,
pyarrow, yaml) import there. The phases print their JSON lines as
``chip_smoke.py`` does; exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale of phase 10's store (default 1)")
    args = ap.parse_args(argv)

    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    for mod in ("grpc", "google.protobuf", "pyarrow", "yaml"):
        try:
            m = importlib.import_module(mod)
            print(f"import {mod}: ok {getattr(m, '__version__', '')}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 - reported, not raised
            print(f"import {mod}: {type(e).__name__}: {e}", flush=True)
    if not torch.cuda.is_available():
        print("monitor_alone: needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from ydb_tpu_torch.ssa import cuda_kernels as ck

    dev = torch.device("cuda", 0)
    print(cs.smi_line(), flush=True)
    serving = cs.serving_phase(dev, ck, args.sf, keep_root=True)
    try:
        cs.monitor_phase(dev, ck, os.path.join(serving["root"], "main"),
                         serving["sanitize_want"],
                         serving["tpch_table_rows"])
    finally:
        shutil.rmtree(serving["root"], ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
