// fused_fold: moments, extremes and DKW histogram of one scan round in one
// pass over its rows, for Hopper.
//
// Replaces the TPU kernel `fused_fold` (src/repro/kernels/fused_scan.py,
// `fused_fold` and its body `_fold_kernel`), which builds one group
// one-hot per tile and feeds it to two MXU matmuls: the moment sums of
// `block_agg` and the (G, nbins) histogram of `grouped_hist`. On Hopper
// neither is a matmul (block_agg.cuh says why), so the fused pass is the
// fold of block_agg.cuh with one more thing done while each row sits in
// registers: tile_sort<.., true> gathers the row, computes its fold
// terms and, when m != 0, its bin (hist_bin.cuh), and counts it into a
// uint32 (G, nbins) histogram with one warp-aggregated integer atomic.
// The group walk is block_agg's, so the moments are bit for bit those of
// block_agg; the histogram's integer adds commute, so it is the same on
// every run and equal to the plain version's.
//
// The histogram bins on the LOGICAL grid: inv_width = nbins / (b - a)
// over the nbins the caller asked for. (The TPU kernel is called with
// nbins padded to a multiple of 128 and computes inv_width from that, so
// where nbins is not such a multiple it bins on another grid and the
// caller's slice drops the top bins' rows; its `ref` path and
// grouped_hist use the logical count, which this kernel follows.)
//
// What bounds it on an H100: bytes. Per row 12 B are read once (value,
// group, mask) and the histogram is written once (4 B a cell: at the
// main path's G = 2800 and 1024 bins, 11.5 MB, about 3.4 us at
// 3.35 TB/s, against 0.8 MB of rows). The kernel writes that histogram
// three times (zeroing, atomics, the in-place pass to float32); at small
// G the fold's add chains dominate, as in block_agg.
//
// Counts are exact: a bin of one call holds at most budget * block_rows
// rows, far below 2^24.

#include "block_agg.cuh"
#include "hist_bin.cuh"

// As repro_block_agg, plus `hist`: (G, nbins) float32, written as uint32
// counts during the pass and turned into float32 in place at the end.
// `hist_a` and `inv_width` are the grid's lower end and nbins / (b - a),
// both float32. Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int repro_fused_fold(const float* values, const int* gids,
                                const float* mask, const int* blk,
                                const int* tvalid, int budget,
                                int block_rows, int num_groups, float center,
                                int chunk_lanes, int lane_mode, void* scratch,
                                float* sums, float* vmin, float* vmax,
                                float* hist, int nbins, float hist_a,
                                float inv_width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbins < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(num_groups) * nbins;
  unsigned* counts = reinterpret_cast<unsigned*>(hist);
  err = cudaMemsetAsync(counts, 0, cells * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_fold<true>(values, gids, mask, blk, tvalid, budget,
                                   block_rows, num_groups, center,
                                   chunk_lanes, lane_mode, scratch, sums,
                                   vmin, vmax, counts, nbins, hist_a,
                                   inv_width, device, stream);
  if (rc != 0) return rc;
  return static_cast<int>(launch_counts_to_float(counts, cells, s));
}
