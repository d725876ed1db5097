// block_agg: masked per-group moment fold of one scan round, for Hopper.
//
// Replaces the TPU kernel `block_agg` (src/repro/kernels/block_agg.py,
// `block_agg` and its tile body `tile_moments`): per group, the masked
// count, the sums of (v - c) and (v - c)^2 and the masked min / max over
// the rows of the selected blocks, each group's rows added in row order
// so the result equals the plain version on the CPU bit for bit.
//
// The kernels (a per-tile stable radix sort of the rows by bucket of
// groups, then a walk with one lane a group, or one warp a group where
// groups are large), the order of summation and what bounds them on an H100 are
// described in block_agg.cuh, which fused_fold.cu shares. This file is
// the fold without the histogram: the round of every bounder but
// Anderson/DKW.

#include "block_agg.cuh"

// sums is (3, G) row-major; vmin and vmax are (G,). `lane_mode` picks
// the walk (one lane, or one warp, a group). `scratch` is laid out as
// launch_fold in block_agg.cuh says. Returns cudaGetLastError() after
// the launches (0 on success).
extern "C" int repro_block_agg(const float* values, const int* gids,
                               const float* mask, const int* blk,
                               const int* tvalid, int budget,
                               int block_rows, int num_groups, float center,
                               int chunk_lanes, int lane_mode, void* scratch,
                               float* sums, float* vmin, float* vmax,
                               int device, void* stream) {
  return launch_fold<false>(values, gids, mask, blk, tvalid, budget,
                            block_rows, num_groups, center, chunk_lanes,
                            lane_mode, scratch, sums, vmin, vmax, HistOut{},
                            device, stream);
}
