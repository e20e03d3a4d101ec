// Grouped sums by int32 group id — the scan path's large-group tier.
//
// Replaces the two Pallas TPU kernels of ydb_tpu/ssa/pallas_kernels.py:
//   grouped_sum        (pallas_kernels.py:78, pallas_call :114)  -> ydb_grouped_sum
//   grouped_sum_multi  (pallas_kernels.py:138, pallas_call :183) -> ydb_grouped_sum_multi
// Both entry points launch one kernel body; ydb_grouped_sum is the
// one-slot case of ydb_grouped_sum_multi.
//
// What it computes: out[g, s] = sum of values[r, s] over rows r with
// gid[r] == g. Rows with gid < 0 or gid >= num_groups are dropped (the
// callers route dead rows to gid == num_groups). num_groups <= 2048,
// slots <= 128, values int32 or float32, out (num_groups x slots) in the
// values' type. int32 sums wrap like the reference's int32 adds, so they
// are bit-exact; float32 sums differ from the reference only in the
// order of the additions.
//
// What bounds it on an H100: bytes. Each row is read once (4 B of gid +
// 4 B per slot) and there is one add per value, far below the card's
// 67 TFLOP/s of float32 at 3.35 TB/s of HBM. The TPU design expanded
// each 1024-row tile into a one-hot (rows x groups) matrix for the MXU;
// on Hopper that would multiply the work by the group count, so each
// CTA privatises the accumulator in shared memory instead. At the main
// path's shape (1<<20 rows, ~1750 groups, one slot: 8 MB in) the bound
// is 2.5 us, so a launch, a fill and a flush are each a large share of
// it. The design, one launch per call:
//
// - Grid sized to the card: thread-block clusters of kCluster CTAs, at
//   most as many clusters as the card holds at once (the wrapper asks
//   cudaOccupancyMaxActiveClusters), fewer when the rows would give a
//   thread only a few elements. Each CTA walks one contiguous range.
// - 16-byte loads: an int4 of four group ids and, where the values
//   share the ids' alignment, one 16-byte vector of four values (scalar
//   otherwise, and for the < 4 rows of an unaligned head and of the
//   tail). Several slots: 16-byte vectors of four slots where the slot
//   count allows, else one slot a lane, consecutive lanes on consecutive
//   addresses. The one-slot loop keeps the next batch of loads in flight
//   while it adds the current one, and issues its first batch before it
//   zeroes the histogram. The row loops have no division.
// - Hot ids (one slot): each warp picks its hot id once, from its
//   lanes' first rows: of the ids of eight sample lanes, the one that
//   most lanes hold (a ballot each). Every lane sums its rows on that id
//   in a register and adds nothing to shared memory for them; after the
//   row loop the warp sums those registers (__reduce_add_sync for int32,
//   shuffles for float32) and one lane adds the sum. The zipf-skewed URL
//   ids put about 38% of all rows on one id, which otherwise serialises
//   about 12 lanes of every warp's add on one address. (Combining the
//   repeats of every row with __match_any_sync, as first planned, made
//   the kernel more than 2x slower on an H100, and picking the hot id
//   with one such call costs more than the eight ballots: see
//   scripts/ablate_grouped_sum.py.) Chunks of several slots combine a
//   warp's lanes only when all hold one id. Accumulator rows are padded
//   to an odd stride, so that lanes on the same slot of different groups
//   fall into different banks.
// - No zero fill and no global atomics on the output: after
//   cluster.sync() the CTA of rank r sums slice r of the elements over
//   the cluster's histograms through distributed shared memory, in rank
//   order, and writes the cluster's partial of that slice to scratch.
//   It then takes the slice's ticket; the CTA that counts last for a
//   slice sums that slice over all cluster partials in cluster order
//   (16-byte loads, several threads per four elements, each over a run
//   of clusters), writes it to out, and resets the ticket to 0, so the
//   next launch on the stream (or a replay of a captured CUDA graph)
//   finds it at 0. No CTA waits for another cluster, so nothing depends
//   on which CTAs are resident; the only wait is the cluster barrier
//   that keeps each histogram alive until its cluster has read it.
// - More than 16 slots: the grid's second dimension is the 16-slot
//   chunk; each chunk re-reads the group ids and has its own tickets.
// No tensor cores: the reference's scatter path is the oracle, and TF32
// or int8 MMA would change the arithmetic.
//
// What holds it back (measured on an H100 with
// scripts/ablate_grouped_sum.py): at the main path's shape, latency, not
// bytes. The launch, the row phase and the cross-CTA chain (cluster
// barrier, partial, ticket, last read) each take a microsecond or more,
// so the kernel stays well short of the byte bound. int32 adds to
// shared memory cost next to nothing there (plain loads and stores in
// their place are no faster); float32 ones cost far more where lanes
// collide (4x the time on zipf ids).
//
// Interface: plain C functions (loaded with ctypes). Each returns a
// cudaError_t; the caller raises if it is not 0. The kernels launch on
// the stream they are given and allocate nothing: the caller passes
// out, the scratch of (chunks, clusters, part_stride_of(num_groups,
// slots)) and kCluster tickets per 16-slot chunk (zero before the first
// launch).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// Threads per CTA: 512 for one slot, whose small accumulator lets two
// CTAs share an SM; 1024 for int32 16-slot chunks, whose accumulator (up
// to 136 KB) leaves room for one, so that an SM keeps as many loads in
// flight either way. float32 chunks stay at 512: their shared-memory
// adds contend with every warp on the same histogram, and where two
// accumulators fit on an SM two CTAs of 512 halve that (on an H100, 6
// slots of zipf ids: 0.062 ms at 512, 0.096 ms at 1024; where only one
// fits, as at 17 slots, 1024 would be faster: 0.207 ms against 0.268;
// scripts/ablate_grouped_sum.py, threads1024).
template <typename T, int CW>
constexpr int kThreads = CW != 1 && std::is_same<T, int>::value ? 1024 : 512;
constexpr int kCluster = 8;
constexpr int kSlotChunk = 16;
constexpr int kMaxSlots = 128;
constexpr int kMaxGroups = 2048;
constexpr unsigned kFull = 0xffffffffu;

// shared-memory accumulator row stride: odd, so that lanes adding to
// the same slot of different groups fall into different banks
__host__ __device__ inline int acc_stride(int cw) { return cw == 1 ? 1 : (cw | 1); }

// elements between two cluster partials in scratch: the widest chunk's
// groups x slots, rounded up to 4 for 16-byte loads
__host__ __device__ inline int part_stride_of(int num_groups, int slots) {
  return (num_groups * (slots < kSlotChunk ? slots : kSlotChunk) + 3) & ~3;
}

template <typename T>
using Vec4 = typename std::conditional<std::is_same<T, int>::value, int4, float4>::type;

// One add to a shared-memory address, stated as such: through a plain
// pointer the compiler may emit a generic atomic, which is far slower.
__device__ __forceinline__ void smem_add(int* p, int v) {
  asm volatile("red.shared.add.s32 [%0], %1;" ::"r"((unsigned)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ void smem_add(float* p, float v) {
  asm volatile("red.shared.add.f32 [%0], %1;" ::"r"((unsigned)__cvta_generic_to_shared(p)),
               "f"(v)
               : "memory");
}

// Sum of v over the warp (every lane calls it; all lanes get the sum).
// int32 in one instruction; float32 by shuffles.
__device__ __forceinline__ int warp_sum(int v) { return __reduce_add_sync(kFull, v); }
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The warp's hot id: of the ids that lanes 0, 4, ..., 28 hold in g, the
// one that the most lanes hold (the first on a tie), or -1 if none is
// held by two or more lanes. Every lane of the warp calls it.
__device__ __forceinline__ int warp_hot_id(int g) {
  int hot = -1, most = 1;
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    const int c = __shfl_sync(kFull, g, k);
    const int n = __popc(__ballot_sync(kFull, g == c));
    if (c >= 0 && n > most) {
      hot = c;
      most = n;
    }
  }
  return hot;
}

// One row into the histogram: a row on the warp's hot id goes to the
// lane's register sum (added to acc once, after the row loop), any other
// live row (g >= 0) to acc[g].
template <typename T>
__device__ __forceinline__ void add_row(T* acc, int hot, T& hot_sum, int g, T v) {
  if (g >= 0 && g == hot) hot_sum += v;
  else if (g >= 0) smem_add(&acc[g], v);
}

__device__ __forceinline__ int live_id(int g, int num_groups) {
  return (unsigned)g < (unsigned)num_groups ? g : -1;
}

template <int NT, typename T>
__device__ __forceinline__ void zero_acc(T* acc, int n) {
  for (int i = threadIdx.x; i < n; i += NT) acc[i] = T(0);
  __syncthreads();
}

// U units of four rows per thread: ids (-1 where dropped) and values
template <typename T, int U>
struct Batch {
  int g[4 * U];
  T v[4 * U];
};

// Units base + threadIdx.x + k * kThreads<T, 1> (k < U) below u1, from
// an int4 of ids and, with `vec`, a 16-byte vector of values.
template <typename T, int U>
__device__ __forceinline__ void load_batch(Batch<T, U>& b, const int4* __restrict__ g4,
                                           const T* __restrict__ vals, bool vec,
                                           long long base, long long u1, int num_groups) {
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long u = base + threadIdx.x + (long long)k * kThreads<T, 1>;
    if (u < u1) {
      const int4 q = __ldg(g4 + u);
      int* g = b.g + 4 * k;
      T* v = b.v + 4 * k;
      g[0] = live_id(q.x, num_groups);
      g[1] = live_id(q.y, num_groups);
      g[2] = live_id(q.z, num_groups);
      g[3] = live_id(q.w, num_groups);
      const T* p = vals + 4 * u;
      if (vec) {
        const Vec4<T> w = __ldg(reinterpret_cast<const Vec4<T>*>(p));
        v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __ldg(p + j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) { b.g[4 * k + j] = -1; b.v[4 * k + j] = T(0); }
    }
  }
}

// The row phase of one slot, zeroing included: units of four rows, each
// an int4 of ids from a 16-byte aligned address. The CTA's first batch
// of loads is issued before the histogram is zeroed, and each next batch
// before the current one is added. Rows before the first aligned id and
// after the last whole unit (fewer than four each) go to warp 0 of the
// grid's first CTA.
template <typename T>
__device__ __forceinline__ void rows_one_slot(const T* __restrict__ values,
                                              const int32_t* __restrict__ gid,
                                              T* acc, long long rows, int num_groups) {
  constexpr int U = 2;
  constexpr long long step = (long long)kThreads<T, 1> * U;
  const uintptr_t ga = reinterpret_cast<uintptr_t>(gid);
  const long long head = min(rows, (long long)(((16 - (ga & 15)) & 15) >> 2));
  const long long units = (rows - head) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(values) & 15) == (ga & 15);
  const long long per = (units + gridDim.x - 1) / gridDim.x;
  const long long u0 = min(units, per * blockIdx.x);
  const long long u1 = min(units, u0 + per);
  const int4* g4 = reinterpret_cast<const int4*>(gid + head);
  const T* vals = values + head;

  Batch<T, U> cur;
  load_batch(cur, g4, vals, vec, u0, u1, num_groups);
  zero_acc<kThreads<T, 1>>(acc, num_groups);
  int hot = warp_hot_id(cur.g[0]);
  T hot_sum = T(0);
  for (long long base = u0; base < u1; base += step) {
    Batch<T, U> nxt;
    load_batch(nxt, g4, vals, vec, base + step, u1, num_groups);
#pragma unroll
    for (int i = 0; i < 4 * U; ++i) add_row(acc, hot, hot_sum, cur.g[i], cur.v[i]);
    cur = nxt;
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const long long tail0 = head + 4 * units;
    long long r = -1;
    if (threadIdx.x < head) r = threadIdx.x;
    else if (threadIdx.x >= 4 && threadIdx.x - 4 < rows - tail0) r = tail0 + threadIdx.x - 4;
    add_row(acc, hot, hot_sum, r >= 0 ? live_id(gid[r], num_groups) : -1,
            r >= 0 ? values[r] : T(0));
  }
  hot_sum = warp_sum(hot_sum);
  if ((threadIdx.x & 31) == 0 && hot >= 0) smem_add(&acc[hot], hot_sum);
}

// The row phase of one chunk of cw slots (values row-major, rows of
// `slots`). The CTA's rows are cut into items of W consecutive slots of
// one row (W = 4: one 16-byte vector), numbered row-major, so that the
// lanes of a warp read consecutive addresses; each lane keeps UNROLL
// items in flight and steps through its items with no division.
template <typename T, int W>
__device__ __forceinline__ void rows_chunk(const T* __restrict__ values,
                                           const int32_t* __restrict__ gid, T* acc,
                                           long long rows, int slots, int s0, int cw,
                                           int stride, int num_groups) {
  constexpr int NT = kThreads<T, kSlotChunk>;
  constexpr int UNROLL = W == 4 ? 4 : 8;
  using V = typename std::conditional<W == 4, Vec4<T>, T>::type;
  zero_acc<NT>(acc, num_groups * stride);
  const int nq = cw / W;  // items per row
  const int lane = threadIdx.x & 31;
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = min(rows, per * blockIdx.x);
  const long long n_items = (min(rows, r0 + per) - r0) * nq;
  // a lane's items are NT apart: (row, item) advances by (dr, dq)
  const int dr = NT / nq, dq = NT % nq;
  int r = threadIdx.x / nq, q = threadIdx.x % nq;
  // when every lane of a warp has the same id and nq divides 32, lanes
  // with equal lane % nq add to the same slots: combine them first
  const bool can_fold = (32 % nq) == 0;
  for (long long base = 0; base < n_items; base += (long long)NT * UNROLL) {
    int gg[UNROLL];
    T vv[UNROLL][W];
    int qq[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      qq[k] = q;
      if (base + threadIdx.x + (long long)k * NT < n_items) {
        const long long row = r0 + r;
        gg[k] = live_id(__ldg(gid + row), num_groups);
        const V w = __ldg(reinterpret_cast<const V*>(values + row * slots + s0 + q * W));
        if constexpr (W == 4) {
          vv[k][0] = w.x; vv[k][1] = w.y; vv[k][2] = w.z; vv[k][3] = w.w;
        } else {
          vv[k][0] = w;
        }
      } else {
        gg[k] = -1;
#pragma unroll
        for (int i = 0; i < W; ++i) vv[k][i] = T(0);
      }
      r += dr;
      q += dq;
      if (q >= nq) { q -= nq; ++r; }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int g = gg[k];
      const int g_lane0 = __shfl_sync(kFull, g, 0);
      const bool fold = can_fold && __all_sync(kFull, g >= 0 && g == g_lane0);
      if (fold) {
#pragma unroll
        for (int i = 0; i < W; ++i)
          for (int off = 16; off >= nq; off >>= 1)
            vv[k][i] += __shfl_xor_sync(kFull, vv[k][i], off);
      }
      if (g >= 0 && (!fold || lane < nq)) {
#pragma unroll
        for (int i = 0; i < W; ++i) smem_add(&acc[g * stride + qq[k] * W + i], vv[k][i]);
      }
    }
  }
}

// The cluster barrier split in two: arrive once this CTA has read its
// peers' histograms, wait before it exits (its own histogram must live
// until the cluster has read it).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <typename T>
__device__ __forceinline__ Vec4<T> add4(Vec4<T> a, Vec4<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
}

// Sum over clusters [c0, c1) of elements e..e+3 of the cluster partials
// (e and part_stride multiples of 4), in cluster order, eight 16-byte
// loads in flight.
template <typename T>
__device__ __forceinline__ Vec4<T> sum_partials(const T* parts, int part_stride, int e,
                                                int c0, int c1) {
  Vec4<T> sum = {T(0), T(0), T(0), T(0)};
  for (int c = c0; c < c1; c += 8) {
    Vec4<T> x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = c + i < c1 ? __ldcg(reinterpret_cast<const Vec4<T>*>(
                              parts + (size_t)(c + i) * part_stride + e))
                        : Vec4<T>{T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int i = 0; i < 8; ++i) sum = add4<T>(sum, x[i]);
  }
  return sum;
}

// CW: compile-time chunk width, 1 (one slot) or kSlotChunk.
template <typename T, int CW>
__global__ void __launch_bounds__((kThreads<T, CW>), 1024 / (kThreads<T, CW>))
grouped_sum_kernel(const T* __restrict__ values, const int32_t* __restrict__ gid,
                   T* __restrict__ out, T* __restrict__ scratch,
                   unsigned* __restrict__ ticket, long long rows, int slots,
                   int num_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = kThreads<T, CW>;
  __shared__ Vec4<T> sub_sums[NT];
  __shared__ int last;
  T* acc = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const int chunk = blockIdx.y;
  const int s0 = chunk * kSlotChunk;
  const int cw = CW == 1 ? 1 : min(kSlotChunk, slots - s0);
  const int stride = acc_stride(cw);

  if constexpr (CW == 1) {
    rows_one_slot(values, gid, acc, rows, num_groups);
  } else {
    // 16-byte vectors when every item starts 16-byte aligned
    if ((cw & 3) == 0 && (slots & 3) == 0 && (reinterpret_cast<uintptr_t>(values) & 15) == 0)
      rows_chunk<T, 4>(values, gid, acc, rows, slots, s0, cw, stride, num_groups);
    else
      rows_chunk<T, 1>(values, gid, acc, rows, slots, s0, cw, stride, num_groups);
  }

  // ---- the cluster's partial of this CTA's slice of the elements, summed
  // over the cluster's histograms in rank order (distributed shared memory)
  cluster.sync();
  const int n_acc = num_groups * cw;
  const int part_stride = part_stride_of(num_groups, slots);
  const int nclusters = gridDim.x / kCluster;
  const unsigned rank = cluster.block_rank();
  // slices of a multiple of 4 elements, for 16-byte loads of partials
  const int per_rank = ((n_acc + kCluster - 1) / kCluster + 3) & ~3;
  const int e0 = min(n_acc, (int)rank * per_rank);
  const int n_e = min(n_acc, e0 + per_rank) - e0;
  const T* parts = scratch + (size_t)chunk * nclusters * part_stride;
  {
    T* part = scratch + ((size_t)chunk * nclusters + blockIdx.x / kCluster) * part_stride;
    const T* peer[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) peer[r] = cluster.map_shared_rank(acc, r);
    for (int e = e0 + threadIdx.x; e < e0 + n_e; e += NT) {
      const int g = CW == 1 ? e : e / cw;
      const int i = g * stride + (e - g * cw);
      T sum = T(0);
#pragma unroll
      for (int r = 0; r < kCluster; ++r) sum += peer[r][i];
      part[e] = sum;
    }
  }
  cluster_arrive();

  // ---- the slice's ticket: each CTA of rank `rank` counts itself in
  // once its partial is written (release: the CTA barrier, then one
  // thread's gpu-scope acq_rel atomic); the one that counts last reads
  // every cluster's partial of the slice (acquire) and writes out
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* t = ticket + chunk * kCluster + rank;
    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;" : "=r"(prev) : "l"(t) : "memory");
    last = prev == (unsigned)nclusters - 1;
    if (last) *t = 0u;  // every cluster has counted: ready for the next launch
  }
  __syncthreads();
  if (last && n_e > 0) {
    // quads of 4 elements (the last may run into the partials' padding,
    // whose sums are not written); `nsub` threads per quad each sum a run
    // of clusters, then one thread adds the runs in cluster order and
    // writes out
    const int n_q = (n_e + 3) >> 2;
    const int nsub = max(1, min(nclusters, NT / n_q));
    const auto write = [&](int e, Vec4<T> s) {
      const T v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e + j < e0 + n_e) {
          const int g = CW == 1 ? e + j : (e + j) / cw;
          out[(size_t)g * slots + s0 + (e + j - g * cw)] = v[j];
        }
      }
    };
    if (nsub == 1) {
      for (int qi = threadIdx.x; qi < n_q; qi += NT)
        write(e0 + 4 * qi, sum_partials(parts, part_stride, e0 + 4 * qi, 0, nclusters));
    } else {
      const int w = threadIdx.x;
      if (w < n_q * nsub) {
        const int sub = w / n_q;
        sub_sums[w] = sum_partials(parts, part_stride, e0 + 4 * (w - sub * n_q),
                                   sub * nclusters / nsub, (sub + 1) * nclusters / nsub);
      }
      __syncthreads();
      if (w < n_q) {
        Vec4<T> sum = sub_sums[w];
        for (int sub = 1; sub < nsub; ++sub) sum = add4<T>(sum, sub_sums[sub * n_q + w]);
        write(e0 + 4 * w, sum);
      }
    }
  }
  cluster_wait();
}

template <typename T, int CW>
cudaLaunchConfig_t launch_config(int clusters, int slots, int num_groups,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  const int cw = slots < kSlotChunk ? slots : kSlotChunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster, (slots + kSlotChunk - 1) / kSlotChunk, 1);
  cfg.blockDim = dim3(kThreads<T, CW>, 1, 1);
  cfg.dynamicSmemBytes = (size_t)num_groups * acc_stride(cw) * sizeof(T);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int CW>
int max_clusters(int slots, int num_groups, int* count) {
  cudaLaunchAttribute attr;
  // a grid larger than any card holds, so that the grid is no limit
  const cudaLaunchConfig_t cfg =
      launch_config<T, CW>(1 << 16, slots, num_groups, 0, &attr);
  // the largest accumulator of this instantiation, so that no later
  // query lowers the limit below a launch already planned
  cudaError_t err = cudaFuncSetAttribute(
      grouped_sum_kernel<T, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kMaxGroups * acc_stride(CW) * sizeof(T)));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(count, grouped_sum_kernel<T, CW>, &cfg);
}

template <typename T, int CW>
int launch(const void* values, const void* gid, void* out, void* scratch,
           void* ticket, long long rows, int slots, int num_groups, int clusters,
           cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<T, CW>(clusters, slots, num_groups, stream, &attr);
  return (int)cudaLaunchKernelEx(
      &cfg, grouped_sum_kernel<T, CW>, static_cast<const T*>(values),
      static_cast<const int32_t*>(gid), static_cast<T*>(out), static_cast<T*>(scratch),
      static_cast<unsigned*>(ticket), rows, slots, num_groups);
}

bool bad_shape(long long rows, int slots, int num_groups) {
  return rows < 0 || slots < 1 || slots > kMaxSlots || num_groups < 1 ||
         num_groups > kMaxGroups;
}

}  // namespace

// dtype: 0 = int32, 1 = float32. Writes into *count how many clusters of
// the launch for (slots, num_groups, dtype) the device holds at once.
extern "C" int ydb_grouped_sum_max_clusters(int slots, int num_groups, int dtype,
                                            int* count) {
  if (bad_shape(0, slots, num_groups)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return slots == 1 ? max_clusters<int, 1>(slots, num_groups, count)
                      : max_clusters<int, kSlotChunk>(slots, num_groups, count);
  if (dtype == 1)
    return slots == 1 ? max_clusters<float, 1>(slots, num_groups, count)
                      : max_clusters<float, kSlotChunk>(slots, num_groups, count);
  return (int)cudaErrorInvalidValue;
}

// values (rows x slots), gid (rows), out (num_groups x slots), scratch
// of chunks * clusters * part_stride_of(num_groups, slots) elements
// (16-byte aligned), tickets:
// kCluster zeroed unsigned per 16-slot chunk. Returns a cudaError_t (0 =
// launched).
extern "C" int ydb_grouped_sum_multi(const void* values, const void* gid, void* out,
                                     void* scratch, void* ticket, long long rows,
                                     int slots, int num_groups, int clusters,
                                     int dtype, void* stream) {
  if (bad_shape(rows, slots, num_groups) || clusters < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return slots == 1 ? launch<int, 1>(values, gid, out, scratch, ticket, rows, slots,
                                       num_groups, clusters, st)
                      : launch<int, kSlotChunk>(values, gid, out, scratch, ticket, rows,
                                                slots, num_groups, clusters, st);
  if (dtype == 1)
    return slots == 1 ? launch<float, 1>(values, gid, out, scratch, ticket, rows, slots,
                                         num_groups, clusters, st)
                      : launch<float, kSlotChunk>(values, gid, out, scratch, ticket, rows,
                                                  slots, num_groups, clusters, st);
  return (int)cudaErrorInvalidValue;
}

// The one-column grouped sum: ydb_grouped_sum_multi with one slot.
extern "C" int ydb_grouped_sum(const void* values, const void* gid, void* out,
                               void* scratch, void* ticket, long long rows,
                               int num_groups, int clusters, int dtype, void* stream) {
  return ydb_grouped_sum_multi(values, gid, out, scratch, ticket, rows, 1, num_groups,
                               clusters, dtype, stream);
}
