// grouped_hist: per-group DKW histogram of flat rows, for Hopper.
//
// Replaces the TPU kernel `grouped_hist` (src/repro/kernels/hist.py,
// `grouped_hist` and its tile body `tile_hist`):
//
//   hist[g, k] = sum_r m_r * 1[gid_r == g] * 1[bin(v_r) == k]
//
// with bin() the float32 rule of hist_bin.cuh over the LOGICAL bin count.
// The TPU version multiplies a group one-hot by a bin one-hot on the MXU,
// O(rows * G * nbins) work for O(rows) counts; on Hopper each row is one
// integer add instead. The engine calls it on the blocks it folds from the
// host: the per-block path, the exact sweep and the recovery pass (up to
// lookahead_blocks * block_rows = 1M rows a call at the defaults).
//
// Design: one thread per row (grid-stride), rows with m != 0 counted
// into uint32 counters, lanes of a warp that hit the same cell folded
// into one atomic (warp_count). Where G * nbins counters fit in shared
// memory (kSharedCells, 96 KB) each CTA counts into its own copy and adds
// its non-zero cells to the output at the end; otherwise every count goes
// to the output in device memory. A last pass turns the counts into
// float32 in place. Integer adds commute, so the result is the same on
// every run, and equal to the plain version's float32 sums of 0/1 masks.
// The mask must be 0 or 1 (the engine's predicate * valid masks are):
// a row with m != 0 counts once.
//
// What bounds it on an H100: bytes. Each row is read once (12 B: at 1M
// rows, 12.6 MB, about 3.8 us at 3.35 TB/s) and the histogram written once
// (4 B a cell). Atomics on a few hot cells of a skewed column could
// serialise; the warp aggregation and the shared-memory copies keep them
// off device memory where they can.

#include "hist_bin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedCells = 24576;  // 96 KB of uint32: two CTAs an SM

__device__ __forceinline__ unsigned row_cell(const float* values,
                                             const int* gids,
                                             const float* mask, long long row,
                                             long long n, int num_groups,
                                             int nbins, float a,
                                             float inv_width) {
  if (row >= n) return kNoCell;
  const int g = gids[row];
  if (mask[row] == 0.f || g < 0 || g >= num_groups) return kNoCell;
  return static_cast<unsigned>(g) * static_cast<unsigned>(nbins) +
         static_cast<unsigned>(hist_bin(values[row], a, inv_width, nbins));
}

// Counts straight into the output's uint32 counters. The loop bound is
// uniform across a block, so whole warps reach warp_count together.
__global__ void __launch_bounds__(kThreads)
hist_global_kernel(const float* __restrict__ values,
                   const int* __restrict__ gids,
                   const float* __restrict__ mask, long long n,
                   int num_groups, int nbins, float a, float inv_width,
                   unsigned* __restrict__ counts) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < n; base += stride) {
    warp_count(counts, row_cell(values, gids, mask, base + threadIdx.x, n,
                                num_groups, nbins, a, inv_width));
  }
}

// Counts into this CTA's shared copy of all G * nbins counters, then adds
// the non-zero ones to the output.
__global__ void __launch_bounds__(kThreads)
hist_shared_kernel(const float* __restrict__ values,
                   const int* __restrict__ gids,
                   const float* __restrict__ mask, long long n,
                   int num_groups, int nbins, float a, float inv_width,
                   unsigned* __restrict__ counts) {
  extern __shared__ unsigned s_counts[];
  const int cells = num_groups * nbins;
  for (int i = threadIdx.x; i < cells; i += kThreads) s_counts[i] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < n; base += stride) {
    warp_count(s_counts, row_cell(values, gids, mask, base + threadIdx.x, n,
                                  num_groups, nbins, a, inv_width));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const unsigned c = s_counts[i];
    if (c != 0u) atomicAdd(counts + i, c);
  }
}

}  // namespace

// Histogram of n flat rows on `stream` into `hist`, (G, nbins) float32
// row-major. `a` and `inv_width` are the grid's lower end and
// nbins / (b - a), both float32. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int repro_grouped_hist(const float* values, const int* gids,
                                  const float* mask, long long n,
                                  int num_groups, int nbins, float a,
                                  float inv_width, float* hist, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_groups < 1 || nbins < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(num_groups) * nbins;
  unsigned* counts = reinterpret_cast<unsigned*>(hist);
  err = cudaMemsetAsync(counts, 0, cells * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (cells <= kSharedCells) {
      const int smem = static_cast<int>(cells * sizeof(unsigned));
      err = cudaFuncSetAttribute(hist_shared_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int grid = static_cast<int>(blocks < 2LL * sms ? blocks
                                                           : 2LL * sms);
      hist_shared_kernel<<<grid, kThreads, smem, s>>>(
          values, gids, mask, n, num_groups, nbins, a, inv_width, counts);
    } else {
      const int grid = static_cast<int>(blocks < 16LL * sms ? blocks
                                                            : 16LL * sms);
      hist_global_kernel<<<grid, kThreads, 0, s>>>(
          values, gids, mask, n, num_groups, nbins, a, inv_width, counts);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_counts_to_float(counts, cells, s));
}
