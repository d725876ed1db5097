// hist_bin.cuh: the DKW histogram's binning rule, shared by
// grouped_hist.cu and fused_fold.cu (whose walk, in block_agg.cuh, counts
// in shared memory and writes float32 itself).
//
// A row with value v lands in bin
//
//   k = trunc(clip((v - a) * inv_width, 0, nbins - 1))
//
// computed in float32 with one rounding per operation (__fsub_rn,
// __fmul_rn), as the reference and the plain version compute it: a, the
// lower end of the grid, and inv_width = nbins / (b - a) over the LOGICAL
// bin count are float32. +inf goes to bin nbins - 1, -inf to bin 0 and
// NaN to bin 0 (the JAX package's float-to-int conversion on the CPU
// gives 0 for NaN; the plain version maps NaN to 0 explicitly).
//
// Counts are uint32 and every add is an integer add, so the result does
// not depend on the order of the adds: the same bits on every run, equal
// to the plain version's float32 sums of 0/1 masks (whole numbers, exact
// up to 2^24 per bin). No float atomics.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kNoCell = 0xffffffffu;  // a row that counts nowhere

__device__ __forceinline__ int hist_bin(float v, float a, float inv_width,
                                        int nbins) {
  const float t = __fmul_rn(__fsub_rn(v, a), inv_width);
  if (isnan(t)) return 0;
  const float c = fminf(fmaxf(t, 0.f), static_cast<float>(nbins - 1));
  return __float2int_rz(c);
}

}  // namespace
