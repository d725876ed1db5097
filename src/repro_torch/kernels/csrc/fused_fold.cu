// fused_fold: moments, extremes and DKW histogram of one scan round in one
// pass over its rows, for Hopper.
//
// Replaces the TPU kernel `fused_fold` (src/repro/kernels/fused_scan.py,
// `fused_fold` and its body `_fold_kernel`), which builds one group
// one-hot per tile and feeds it to two MXU matmuls: the moment sums of
// `block_agg` and the (G, nbins) histogram of `grouped_hist`. On Hopper
// neither is a matmul (block_agg.cuh says why), so the fused pass is the
// fold of block_agg.cuh with one more thing done in its group walk, which
// visits each group's rows with their values at hand: it computes each
// row's bin (hist_bin.cuh) and counts it into its group's row of counters
// in shared memory. The sort and the
// fold's arithmetic are block_agg's, so the moments are bit for bit those
// of block_agg; the histogram's integer adds commute, so it is the same
// on every run and equal to the plain version's.
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
// 3.35 TB/s, against 0.8 MB of rows). The walk owns the histogram
// (block_agg.cuh, group_walk_kernel<true>): each CTA counts its groups'
// rows in shared memory and writes its cells once, as float32, so the
// histogram is written once, with no memset before it and no pass after
// it: two launches a call, like block_agg. At small G the fold's add
// chains dominate, as in block_agg.
//
// Counts are exact: a bin of one call holds at most budget * block_rows
// rows, far below 2^24.

#include "block_agg.cuh"

// As repro_block_agg, plus the histogram: `hist` is (G, nbins) float32,
// every cell written by the call (added to when the lanes are folded in
// chunks: the first chunk writes). `hist_a` and `inv_width` are the
// grid's lower end and nbins / (b - a), both float32. A walk CTA counts
// a slice of the bins of its groups in shared memory, as hist_plan
// (block_agg.cuh) cuts them. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int repro_fused_fold(const float* values, const int* gids,
                                const float* mask, const int* blk,
                                const int* tvalid, int budget,
                                int block_rows, int num_groups, float center,
                                int chunk_lanes, int lane_mode, void* scratch,
                                float* sums, float* vmin, float* vmax,
                                float* hist, int nbins, float hist_a,
                                float inv_width, int device, void* stream) {
  return launch_fold<true>(values, gids, mask, blk, tvalid, budget,
                           block_rows, num_groups, center, chunk_lanes,
                           lane_mode, scratch, sums, vmin, vmax,
                           HistOut{hist, nbins, hist_a, inv_width, 0, 0},
                           device, stream);
}

// The walk's histogram plan at `nbins` bins in lane or warp mode, for
// tests: out = {slice_bins, slices, stride, counter bytes a CTA, the
// walk's static shared bytes, the shared bytes a CTA may take}.
extern "C" void repro_fused_fold_plan(int nbins, int lane_mode, int* out) {
  const HistPlan hp = hist_plan(nbins, lane_mode != 0);
  out[0] = hp.slice_bins;
  out[1] = hp.slices;
  out[2] = hp.stride;
  out[3] = hp.smem_bytes;
  out[4] = kWalkStaticSmem;
  out[5] = kSmemPerCta;
}
