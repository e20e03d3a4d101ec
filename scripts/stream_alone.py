#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` (streaming) on its own, on one NVIDIA
GPU: phase 10 builds its TPC-H store at ``--sf``, phase 15 serves it on
a node (``grpc_boot``), and ``stream_phase`` goes on on that node; the
store is removed after. With ``--row-sf``, phase 13 (the row store) runs
after it at that scale.

    python3 scripts/stream_alone.py [--sf 1] [--row-sf 0.5]

It prints the host's Python, torch and CUDA versions and the card's name
and power limit first. The phases print their JSON lines as
``chip_smoke.py`` does; exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale of phase 10's store (default 1)")
    ap.add_argument("--row-sf", type=float, default=None,
                    help="also run phase 13 at this TPC-H scale")
    args = ap.parse_args(argv)

    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("stream_alone: needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from ydb_tpu_torch.ssa import cuda_kernels as ck

    dev = torch.device("cuda", 0)
    print(cs.smi_line(), flush=True)
    serving = cs.serving_phase(dev, ck, args.sf, keep_root=True)
    root = os.path.join(serving["root"], "main")
    try:
        node = cs.grpc_boot(root, dev)
        try:
            cs.grpc_phase(dev, ck, node, serving["sanitize_want"],
                          serving["tpch_table_rows"])
        except BaseException:
            cs.stop_node(node)
            raise
        cs.stream_phase(dev, ck, node, root)
    finally:
        shutil.rmtree(serving["root"], ignore_errors=True)
    if args.row_sf is not None:
        torch.cuda.empty_cache()
        cs.row_store_phase(dev, ck, args.row_sf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
