// bitmap_active: the block-activity probe of active scanning, for Hopper.
//
// Replaces the TPU kernel `active_blocks` (src/repro/kernels/
// bitmap_active.py, `active_blocks` and its tile body `tile_hit_any`):
//
//   flag[i] = any_w(words[row_i, w] & active[w]) != 0
//
// over block-by-group bitmaps packed 32 groups to a word. Rows are either
// all blocks in order (the static prefilter) or the rows named by `win`
// (the fused round's cursor window), so the probe reads words[win]
// without a gather copy.
//
// What bounds it on an H100: bytes. Each probed row reads W words once
// (4 B each) and writes one int32 flag; there is no arithmetic to speak of
// (one AND and one OR per word). The design keeps the reads coalesced:
// for W < 32 one thread walks one row, neighbouring threads on
// neighbouring rows; for W >= 32 one warp walks one row, neighbouring
// lanes on neighbouring words, and the lanes OR their hits with one warp
// reduction. The active mask (at most a few hundred words) stays in L1.
//
// Words are uint32 bit patterns; the port carries them in int32 tensors,
// which this kernel reads as uint32. The result is exact: the same bits on
// every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
active_rows_by_thread(const unsigned* __restrict__ words,
                      const int* __restrict__ win, int n, int n_words,
                      const unsigned* __restrict__ active,
                      int* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long row = win != nullptr ? win[i] : i;
  const unsigned* w = words + row * n_words;
  unsigned acc = 0;
  for (int k = 0; k < n_words; ++k) acc |= w[k] & active[k];
  out[i] = acc != 0u;
}

__global__ void __launch_bounds__(kThreads)
active_rows_by_warp(const unsigned* __restrict__ words,
                    const int* __restrict__ win, int n, int n_words,
                    const unsigned* __restrict__ active,
                    int* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int i = static_cast<int>(t >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // uniform across the warp
  const long long row = win != nullptr ? win[i] : i;
  const unsigned* w = words + row * n_words;
  unsigned acc = 0;
  for (int k = lane; k < n_words; k += 32) acc |= w[k] & active[k];
  acc = __reduce_or_sync(0xffffffffu, acc);
  if (lane == 0) out[i] = acc != 0u;
}

}  // namespace

// Probes n rows on `stream`: row i is win[i] when win is not null, else i.
// words is (rows, n_words) row-major; out is (n,) int32. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_bitmap_active(const unsigned* words, const int* win,
                                   int n, int n_words,
                                   const unsigned* active, int* out,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_words >= 32) {
    const long long threads = static_cast<long long>(n) * 32;
    const int grid = static_cast<int>((threads + kThreads - 1) / kThreads);
    active_rows_by_warp<<<grid, kThreads, 0, s>>>(words, win, n, n_words,
                                                  active, out);
  } else {
    const int grid = (n + kThreads - 1) / kThreads;
    active_rows_by_thread<<<grid, kThreads, 0, s>>>(words, win, n, n_words,
                                                    active, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by the launch functions above.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
