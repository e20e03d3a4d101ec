#!/usr/bin/env python3
"""Where the grouped-sum kernel's device time goes, on one NVIDIA GPU.

Builds variants of ``ydb_tpu_torch/csrc/grouped_sum.cu``, each made by a
text edit of the source (so each stays in step with the kernel as it
is), binds each through the port's own wrapper, and times it at the
main path's shape: one 1<<20-row block of ClickBench URL ids (zipf),
uniform ids over the same groups, and one hot id; int32 (or, with
``--dtype float32``, float32) values; CUDA
graph replay (``chip_smoke.device_ms``). Variants that return early
give wrong sums on purpose; they time a prefix of the kernel:

  kernel    the kernel as it is
  empty     returns at entry: the launch of the cluster grid
  rows      returns after the row phase (shared-memory histograms)
  partial   returns after the cluster partials are written (and the
            cluster barrier that keeps the histograms alive)
  no_hot    no per-warp hot id: every live row is a shared-memory add
  match_pick the warp's hot id picked with one __match_any_sync (the id
            most of its 32 lanes hold) instead of eight ballots
  sticky    per row: lanes on a warp candidate id (kept while two or
            more lanes hold it, else lane 0's id) summed with one
            warp reduction and one add
  match     per row: lanes on equal ids found with __match_any_sync and
            summed with shuffles, one add per distinct id
  plain_add shared-memory adds as plain loads and stores, not atomics:
            what the atomics cost (sums wrong where lanes collide)
  threads512  every CTA at 512 threads (the kernel gives int32 chunks
            of several slots 1024)
  threads1024 float32 chunks of several slots at 1024 threads too

With ``--clusters 16,30`` the kernel is also timed on those fixed grids;
with ``--timeline`` a copy that stamps ``%globaltimer`` at the end of
each phase in thread 0 of every CTA gives the min/median/max over CTAs
of each phase's end.

    python3 scripts/ablate_grouped_sum.py [--slots 1,6,128] [--clusters 16,30]
                                          [--timeline] [--variants kernel,rows]
                                          [--dtype int32|float32]

Prints one JSON object per (variant, slots, ids[, clusters]), with
whether its sums agree with the plain version's, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

EARLY_EXIT = "  if (rows >= 0) return;\n"


def variants(src: str) -> dict:
    def edit(text: str, old: str, new: str) -> str:
        if text.count(old) != 1:
            raise SystemExit(f"ablation anchor not found once: {old!r}")
        return text.replace(old, new)

    entry = "  cg::cluster_group cluster = cg::this_cluster();\n"
    rows_end = "  // ---- the cluster's partial"
    ticket = "  // ---- the slice's ticket"
    add_start = src.index(
        "template <typename T>\n__device__ __forceinline__ void add_row(")
    add_end = src.index("__device__ __forceinline__ int live_id")
    pick = "  int hot = warp_hot_id(cur.g[0]);\n"
    threads = "CW != 1 && std::is_same<T, int>::value ? 1024 : 512;"
    pick_start = src.index("__device__ __forceinline__ int warp_hot_id(")
    pick_end = src.index("// One row into the histogram:")
    match_pick = """__device__ __forceinline__ int warp_hot_id(int g) {
  const unsigned peers = __match_any_sync(kFull, g);
  const int n = g >= 0 ? __popc(peers) : 0;
  const int most = (int)__reduce_max_sync(kFull, (unsigned)n);
  const int hot = __shfl_sync(kFull, g, __ffs(__ballot_sync(kFull, n == most)) - 1);
  return most >= 2 ? hot : -1;
}

"""
    sticky = """template <typename T>
__device__ __forceinline__ void add_row(T* acc, int& hot, T& hot_sum, int g, T v) {
  const bool on = g >= 0 && g == hot;
  const unsigned m = __ballot_sync(kFull, on);
  if (m & (m - 1)) {
    const T sum = warp_sum(on ? v : T(0));
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) smem_add(&acc[g], sum);
    if (!on && g >= 0) smem_add(&acc[g], v);
  } else {
    if (g >= 0) smem_add(&acc[g], v);
    hot = __shfl_sync(kFull, g, 0);
  }
}

"""
    match = """template <typename T>
__device__ __forceinline__ void add_row(T* acc, int hot, T& hot_sum, int g, T v) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, g);
  if (__all_sync(kFull, g < 0 || peers == (1u << lane))) {
    if (g >= 0) smem_add(&acc[g], v);
    return;
  }
  const int n = (int)__reduce_max_sync(kFull, (unsigned)__popc(peers));
  T sum = T(0);
  unsigned m = peers;
  for (int i = 0; i < n; ++i) {
    const T x = __shfl_sync(kFull, v, m ? __ffs(m) - 1 : 0);
    if (m) sum += x;
    m &= m - 1;
  }
  if (g >= 0 && lane == (unsigned)(__ffs(peers) - 1)) smem_add(&acc[g], sum);
}

"""
    return {
        "kernel": src,
        "empty": edit(src, entry, entry + EARLY_EXIT),
        "rows": edit(src, rows_end, EARLY_EXIT + rows_end),
        # the wait keeps each CTA's shared memory alive until the
        # cluster's other CTAs have read it, as the kernel's own does
        "partial": edit(src, ticket, "  cluster_wait();\n" + EARLY_EXIT + ticket),
        "no_hot": edit(src, pick, "  int hot = -1;\n"),
        "match_pick": src[:pick_start] + match_pick + src[pick_end:],
        "sticky": src[:add_start] + sticky + src[add_end:],
        "match": src[:add_start] + match + src[add_end:],
        "plain_add": edit(edit(src, 'asm volatile("red.shared.add.s32 [%0], %1;"',
                               '*p += v; if (0) asm volatile("red.shared.add.s32 [%0], %1;"'),
                          'asm volatile("red.shared.add.f32 [%0], %1;"',
                          '*p += v; if (0) asm volatile("red.shared.add.f32 [%0], %1;"'),
        "threads512": edit(src, threads, "512;"),
        "threads1024": edit(src, threads, "CW != 1 ? 1024 : 512;"),
    }


#: per-CTA phase stamps (%globaltimer, ns) of the timeline variant
PHASES = ("entry", "rows", "cluster_sync", "partial", "ticket", "end")
TRACE_DECL = """__device__ unsigned long long g_trace[4096][7];
extern "C" int ydb_trace_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}

"""


def timeline_source(src: str) -> str:
    """The kernel with thread 0 of each CTA stamping %globaltimer at the
    end of each phase (and, with the last stamp, whether the CTA counted
    last for its slice)."""
    def stamp(i: int, extra: str = "") -> str:
        return ("  if (threadIdx.x == 0) { unsigned long long t_; "
                'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
                "unsigned long long* s_ = g_trace[(blockIdx.y * gridDim.x + "
                f"blockIdx.x) % 4096]; s_[{i}] = t_;{extra} }}\n")

    def put(text: str, anchor: str, add: str, after: bool) -> str:
        if text.count(anchor) != 1:
            raise SystemExit(f"timeline anchor not found once: {anchor!r}")
        return text.replace(anchor, anchor + add if after else add + anchor)

    src = put(src, "namespace {\n", TRACE_DECL, after=False)
    src = put(src, "  cg::cluster_group cluster = cg::this_cluster();\n",
              stamp(0), after=True)
    src = put(src, "  // ---- the cluster's partial", stamp(1), after=False)
    src = put(src, "  cluster.sync();\n", stamp(2), after=True)
    src = put(src, "  cluster_arrive();\n", stamp(3), after=False)
    src = put(src, "  if (last && n_e > 0) {", stamp(4), after=False)
    return put(src, "  cluster_wait();\n}", stamp(5, " s_[6] = last;"),
               after=False)


def same_sums(got, want) -> bool:
    """int32: bit-exact; float32: within 1e-5 of the largest sum (the
    order of the additions differs)."""
    if got.dtype == torch.int32:
        return bool(torch.equal(got, want))
    return bool((got - want).abs().max() <= 1e-5 * want.abs().max())


def fixed_plan(plan_of, clusters: int):
    """The wrapper's launch plan with the grid fixed at ``clusters``."""
    def plan(rows, slots, ng, max_clusters):
        p = plan_of(rows, slots, ng, max_clusters)
        return p._replace(clusters=clusters, scratch_elems=(
            p.chunks * clusters * p.part_stride))
    return plan


def timeline(ck, vals, g, ng) -> dict:
    """min/median/max over CTAs of each phase's end, in us after the
    first CTA's entry; 'end' over the CTAs that counted last."""
    import ctypes

    import numpy as np

    lib = ck._library()
    lib.ydb_trace_read.argtypes = [ctypes.c_void_p]
    for _ in range(3):
        ck.grouped_sum_multi(vals, g, ng)
    torch.cuda.synchronize()
    ck.grouped_sum_multi(vals, g, ng)
    torch.cuda.synchronize()
    buf = np.zeros((4096, 7), dtype=np.uint64)
    assert lib.ydb_trace_read(buf.ctypes.data) == 0
    rows, slots = vals.shape
    plan = ck._launch_plan(rows, slots, ng, ck._device_max_clusters(
        lib, vals.device, vals.dtype, slots, ng))
    t = buf[:plan.clusters * ck.CLUSTER * plan.chunks].astype(np.int64)
    rel = (t[:, :6] - t[:, 0].min()) / 1000.0
    out = {"ctas": len(t)}
    for i, name in enumerate(PHASES):
        col = rel[t[:, 6] == 1, i] if name == "end" else rel[:, i]
        out[name] = [round(float(f(col)), 3) for f in (np.min, np.median,
                                                       np.max)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", default="1,6,128")
    ap.add_argument("--clusters", default="",
                    help="comma-separated cluster counts to time besides "
                    "the wrapper's own choice")
    ap.add_argument("--timeline", action="store_true",
                    help="also print per-CTA phase times of the kernel")
    ap.add_argument("--variants", default="",
                    help="comma-separated variants to time (default: all)")
    ap.add_argument("--dtype", default="int32", choices=("int32", "float32"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_grouped_sum: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from ydb_tpu_torch.ssa import cuda_kernels as ck
    from ydb_tpu_torch.workload import clickbench

    dev = torch.device("cuda", 0)
    rows = chip_smoke.BLOCK_ROWS
    cb = clickbench.ClickBenchData(rows=rows, seed=42)
    ng = len(cb.dicts["URL"]) + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ids = {
        "zipf": (torch.from_numpy(cb.hits["URL"][:rows]).to(dev) + 1
                 ).to(torch.int32),
        "uniform": torch.randint(0, ng, (rows,), generator=gen, device=dev,
                                 dtype=torch.int32),
        "hot": torch.full((rows,), 7, dtype=torch.int32, device=dev),
    }
    out_dir = ROOT / "build" / "ablate_grouped_sum"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = ck.SOURCE.read_text()
    plan_of = ck._launch_plan
    runs = variants(src)
    if args.variants:
        runs = {k: v for k, v in runs.items() if k in args.variants.split(",")}
    if args.timeline:
        runs["timeline"] = timeline_source(src)
    all_slots = [int(s) for s in args.slots.split(",")]
    for name, text in runs.items():
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        ck.SOURCE, ck._lib = path, None
        ck._max_clusters.clear()
        for slots in all_slots:
            vals = torch.randint(-1000, 1000, (rows, slots), generator=gen,
                                 device=dev, dtype=torch.int32).to(
                                     getattr(torch, args.dtype))
            for mix, g in ids.items():
                if name == "timeline":
                    print(json.dumps({"timeline": timeline(ck, vals, g, ng),
                                      "slots": slots, "ids": mix}), flush=True)
                    continue
                forced = [int(c) for c in args.clusters.split(",") if c]
                for clusters in [None] + (forced if name == "kernel" else []):
                    if clusters is not None:
                        ck._launch_plan = fixed_plan(plan_of, clusters)
                    try:
                        got = ck.grouped_sum_multi(vals, g, ng)
                        agrees = same_sums(
                            got, ck.grouped_sum_multi_plain(vals, g, ng))
                        ms = chip_smoke.device_ms(
                            lambda: ck.grouped_sum_multi(vals, g, ng))
                    finally:
                        ck._launch_plan = plan_of
                    print(json.dumps({"variant": name, "slots": slots,
                                      "ids": mix, "clusters": clusters or "plan",
                                      "rows": rows, "groups": ng,
                                      "dtype": args.dtype, "ms": ms,
                                      "agrees": agrees}), flush=True)
    print(chip_smoke.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
