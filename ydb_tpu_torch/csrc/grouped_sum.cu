// Grouped sums by int32 group id — the scan path's large-group tier.
//
// Replaces the two Pallas TPU kernels of ydb_tpu/ssa/pallas_kernels.py:
//   grouped_sum        (pallas_kernels.py:77-125)  -> ydb_grouped_sum
//   grouped_sum_multi  (pallas_kernels.py:137-194) -> ydb_grouped_sum_multi
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
// on Hopper that would multiply the work by the group count, so this
// design instead privatises the accumulator: each CTA keeps
// (num_groups x slot_chunk) partial sums in shared memory (2048 x 16 x
// 4 B = 128 KB at most, dynamic shared memory), walks its rows with a
// grid-stride loop and adds with shared-memory atomics, then adds each
// non-zero partial into the zeroed output with one global atomic. No
// tensor cores: the reference's scatter path is the oracle, and TF32 or
// int8 MMA would change the arithmetic.
//
// Interface: plain C functions (loaded with ctypes). Each returns the
// cudaError_t of its launch; the caller raises if it is not 0. The
// kernels launch on the stream they are given and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSlotChunk = 16;
constexpr int kMaxGroups = 2048;
constexpr long long kElemsPerCta = 4096;

template <typename T>
__global__ void grouped_sum_multi_kernel(const T* __restrict__ values,
                                         const int32_t* __restrict__ gid,
                                         T* __restrict__ out,
                                         long long rows, int slots,
                                         int num_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  const int s0 = blockIdx.y * kSlotChunk;
  const int cw = min(kSlotChunk, slots - s0);  // slots in this chunk
  const int n_acc = num_groups * cw;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = T(0);
  __syncthreads();

  // one element = one (row, slot-in-chunk) pair; neighbouring threads
  // take neighbouring slots of a row, then neighbouring rows
  const long long n_elem = rows * (long long)cw;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_elem; e += stride) {
    const long long r = e / cw;
    const int s = (int)(e - r * cw);
    const int g = gid[r];
    if (g >= 0 && g < num_groups) {
      atomicAdd(&acc[g * cw + s], values[r * slots + s0 + s]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const T v = acc[i];
    if (v != T(0)) {
      const int g = i / cw;
      const int s = i - g * cw;
      atomicAdd(&out[(long long)g * slots + s0 + s], v);
    }
  }
}

template <typename T>
__global__ void grouped_sum_kernel(const T* __restrict__ values,
                                   const int32_t* __restrict__ gid,
                                   T* __restrict__ out, long long rows,
                                   int num_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < num_groups; i += blockDim.x) acc[i] = T(0);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += stride) {
    const int g = gid[r];
    if (g >= 0 && g < num_groups) atomicAdd(&acc[g], values[r]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < num_groups; i += blockDim.x) {
    const T v = acc[i];
    if (v != T(0)) atomicAdd(&out[i], v);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess ||
        count <= 0) {
      count = 132;
    }
  }
  return count;
}

// CTAs along the row axis: about kElemsPerCta elements each, at most a
// few per SM (each CTA pays one flush of its accumulator)
int row_ctas(long long n_elem, int per_sm) {
  long long want = (n_elem + kElemsPerCta - 1) / kElemsPerCta;
  long long cap = (long long)sm_count() * per_sm;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

template <typename T>
int launch_multi(const void* values, const int32_t* gid, void* out,
                 long long rows, int slots, int num_groups,
                 cudaStream_t stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const int cw = slots < kSlotChunk ? slots : kSlotChunk;
  const size_t smem = (size_t)num_groups * cw * sizeof(T);
  // once per type, outside any stream work (so launches can be captured
  // into a CUDA graph)
  static bool smem_raised = false;
  if (!smem_raised) {
    cudaError_t err = cudaFuncSetAttribute(
        grouped_sum_multi_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((size_t)kMaxGroups * kSlotChunk * sizeof(T)));
    if (err != cudaSuccess) return (int)err;
    smem_raised = true;
  }
  const int chunks = (slots + kSlotChunk - 1) / kSlotChunk;
  // 128 KB accumulators fit one CTA per SM; small ones fit several
  const int per_sm = smem > 64 * 1024 ? 1 : (smem > 24 * 1024 ? 3 : 4);
  dim3 grid(row_ctas(rows * cw, per_sm), chunks);
  grouped_sum_multi_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(values), gid, static_cast<T*>(out), rows, slots,
      num_groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_single(const void* values, const int32_t* gid, void* out,
                  long long rows, int num_groups, cudaStream_t stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)num_groups * sizeof(T);
  grouped_sum_kernel<T><<<row_ctas(rows, 4), kThreads, smem, stream>>>(
      static_cast<const T*>(values), gid, static_cast<T*>(out), rows,
      num_groups);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = int32, 1 = float32. Returns a cudaError_t (0 = launched).
extern "C" int ydb_grouped_sum_multi(const void* values, const void* gid,
                                     void* out, long long rows, int slots,
                                     int num_groups, int dtype,
                                     void* stream) {
  if (slots < 1 || slots > 128 || num_groups < 1 ||
      num_groups > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  const int32_t* g = static_cast<const int32_t*>(gid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_multi<int>(values, g, out, rows, slots, num_groups, st);
  if (dtype == 1)
    return launch_multi<float>(values, g, out, rows, slots, num_groups, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ydb_grouped_sum(const void* values, const void* gid,
                               void* out, long long rows, int num_groups,
                               int dtype, void* stream) {
  if (num_groups < 1 || num_groups > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  const int32_t* g = static_cast<const int32_t*>(gid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_single<int>(values, g, out, rows, num_groups, st);
  if (dtype == 1)
    return launch_single<float>(values, g, out, rows, num_groups, st);
  return (int)cudaErrorInvalidValue;
}
