#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` (SQL on a degraded block-4-2 erasure
group) on its own, on one NVIDIA GPU. It builds the CUDA kernels at their
first launch, as the whole script does.

    python3 scripts/erasure_alone.py [--sf 0.1] [--hits-rows 524288]

It prints the host's Python, torch and CUDA versions and the card's name
and power limit first, then the phase's lines as ``chip_smoke.py`` prints
them; exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=cs.ERASURE_SF,
                    help=f"TPC-H scale (default {cs.ERASURE_SF})")
    ap.add_argument("--hits-rows", type=int, default=cs.ERASURE_HITS_ROWS,
                    help="ClickBench hits rows (default "
                    f"{cs.ERASURE_HITS_ROWS})")
    args = ap.parse_args(argv)

    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("erasure_alone: needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from ydb_tpu_torch.ssa import cuda_kernels as ck

    print(cs.smi_line(), flush=True)
    cs.erasure_phase(torch.device("cuda", 0), ck, args.sf, args.hits_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
