// block_agg: masked per-group moment fold of one scan round, for Hopper.
//
// Replaces the TPU kernel `block_agg` (src/repro/kernels/block_agg.py,
// `block_agg` and its tile body `tile_moments`). For every group g over
// the rows of the selected blocks it computes
//
//   count[g] = sum m,  dsum[g] = sum (v - c) m,  dsq[g] = sum (v - c)^2 m,
//   vmin[g] / vmax[g] = min / max of v over rows with m > 0
//
// (+inf / -inf for an empty group), where m is the predicate mask times
// the lane's validity flag. The TPU version is a one-hot matmul on the
// MXU; on Hopper that would be O(rows * G) wasted tensor-core work, so it
// is not carried over.
//
// Interface: the kernel reads the device-resident (nb, block_rows) slabs
// directly and gathers the selected blocks itself (`blk`, with `tvalid`
// marking padding lanes), so the (budget, block_rows) gather of the fused
// round is never materialised in device memory.
//
// Order of summation, fixed on purpose: each group's sums are accumulated
// in row order, one add after the other, exactly as the plain version's
// `index_add_` does on the CPU (and the JAX package's scatter). So the
// kernel gives the same bits as the plain version on ALL data, not only
// where sums are exactly representable, and the same bits on every run
// (no float atomics, no data-dependent order). A fold that sums per-block
// partials instead keeps the scan decisions but moves the engine's
// intervals by up to ~1e-3 relative against the CPU run on FLIGHTS data.
//
// Design: a stable sort of the rows by group, then one walk per group.
//   1. tile_sort: one CTA per tile of 1024 rows. It gathers its rows,
//      computes the fold terms (m, (v-c)m, (v-c)^2 m, v) in the plain
//      version's arithmetic, and sorts the rows that change a sum or an
//      extreme by (group, row) with a bitonic sort in shared memory. It
//      writes the sorted terms and, per group present, where the group's
//      run starts and ends in the tile: a (G, tiles) table.
//   2. group_walk: one warp per group. It reads the group's runs of 32
//      tiles at a time, concatenated in tile order, and stages 256 of
//      their rows at a time in shared memory (the loads of the next 256
//      in flight while it folds). Lanes 0..4 each carry one accumulator
//      and fold the staged rows one after the other. Each row is visited
//      once, in row order for its group.
// A row whose terms are all zero (m == 0 and v - c finite) changes no
// accumulator's bits (adding +-0 to a sum that starts at +0 is the
// identity) and takes no part in the extremes, so the sort drops it; a
// masked row with an inf or NaN value is kept and poisons its group's
// sums exactly as in the plain version. When (G x tiles) would outgrow
// the scratch table, the wrapper folds the lanes in consecutive chunks
// and each walk continues the previous chunk's accumulators: the order
// of the adds is the same.
//
// What bounds it on an H100: the bytes are small (12 B a row: at the main
// path's 64 blocks of 1024 rows, 0.8 MB, about 0.25 us at 3.35 TB/s). The
// walk is bound by the dependent chain of each group's adds: a group
// with n rows takes n steps of (add or max, then a select) one after the
// other, so the round with the fewest groups is the slowest (G = 1: one
// chain over every live row). PERF.md has the measured times. The arithmetic is IEEE round-to-nearest with no FMA
// contraction (__fmul_rn / __fadd_rn / __fsub_rn).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 1024;        // rows sorted by one CTA
constexpr int kSortThreads = 512;  // one compare-exchange pair each
constexpr int kWalkWarps = 4;      // groups walked by one CTA
constexpr int kBatch = 256;        // rows staged by a warp per step
constexpr unsigned long long kDead = ~0ull;  // sort key of a dropped row

// NaN-propagating max (PTX max.NaN, sm_80+), as the plain version's
// scatter-min propagates NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Tile `blockIdx.x` of the chunk's rows (lane-major, then row in block).
// Writes the tile's kept rows, sorted by (group, row), to part[tile] and
// each group's run [first, end) in the tile to first/end[g * tiles + t].
// first/end are zeroed beforehand, so an absent group has an empty run.
__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(const float* __restrict__ values,
                 const int* __restrict__ gids,
                 const float* __restrict__ mask,
                 const int* __restrict__ blk,
                 const int* __restrict__ tvalid,
                 long long chunk_rows, int block_rows, int num_groups,
                 float center, int tiles, float4* __restrict__ part,
                 int* __restrict__ first, int* __restrict__ end) {
  __shared__ unsigned long long s_key[kTile];
  __shared__ float4 s_terms[kTile];
  const int t = blockIdx.x;
  const long long base = static_cast<long long>(t) * kTile;

  for (int r = threadIdx.x; r < kTile; r += kSortThreads) {
    unsigned long long key = kDead;
    if (base + r < chunk_rows) {
      const long long row = base + r;
      const int lane = static_cast<int>(row / block_rows);
      const long long src = static_cast<long long>(blk[lane]) * block_rows +
                            row % block_rows;
      const float x = values[src];
      const float m = __fmul_rn(mask[src], tvalid[lane] ? 1.f : 0.f);
      const float dv = __fsub_rn(x, center);
      const float a = m, b = __fmul_rn(dv, m);
      const float q = __fmul_rn(__fmul_rn(dv, dv), m);
      const int g = gids[src];
      // NaN != 0: a NaN term keeps its row
      const bool kept = !(a == 0.f && b == 0.f && q == 0.f);
      if (kept && g >= 0 && g < num_groups) {
        key = (static_cast<unsigned long long>(g) << 32) |
              static_cast<unsigned int>(r);
      }
      s_terms[r] = make_float4(a, b, q, x);
    }
    s_key[r] = key;
  }
  __syncthreads();

  // bitonic sort, ascending; keys are unique except kDead
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = 2 * j * (threadIdx.x / j) + threadIdx.x % j;
      const unsigned long long a = s_key[i], b = s_key[i + j];
      if ((a > b) == ((i & k) == 0)) {
        s_key[i] = b;
        s_key[i + j] = a;
      }
      __syncthreads();
    }
  }

  for (int k = threadIdx.x; k < kTile; k += kSortThreads) {
    const unsigned long long key = s_key[k];
    if (key == kDead) continue;
    const unsigned int g = static_cast<unsigned int>(key >> 32);
    part[base + k] = s_terms[key & 0xffffffffu];
    const size_t cell = static_cast<size_t>(g) * tiles + t;
    if (k == 0 || static_cast<unsigned int>(s_key[k - 1] >> 32) != g) {
      first[cell] = k;
    }
    if (k + 1 == kTile || s_key[k + 1] == kDead ||
        static_cast<unsigned int>(s_key[k + 1] >> 32) != g) {
      end[cell] = k + 1;
    }
  }
}

// The group's rows in one window of 32 tiles, concatenated in tile order
// (run of tile t0 + j = lane j's [f, f + len)): load rows o + u*32 + lane
// of that sequence into `cur`, zero rows past `total`. `incl` is the
// inclusive scan of the runs' lengths over the lanes.
__device__ __forceinline__ void load_batch(const float4* __restrict__ part,
                                           int t0, int f, int len, int incl,
                                           int total, int o,
                                           float4 (&cur)[kBatch / 32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kBatch / 32; ++u) {
    const int r = o + u * 32 + lane;
    int j = 0;  // the run holding row r: lanes whose incl <= r
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(0xffffffffu, incl, j + step - 1) <= r) j += step;
    }
    const int fj = __shfl_sync(0xffffffffu, f, j);
    const int excl = __shfl_sync(0xffffffffu, incl, j) -
                     __shfl_sync(0xffffffffu, len, j);
    cur[u] = r < total
                 ? part[static_cast<size_t>(t0 + j) * kTile + fj + (r - excl)]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One warp per group: fold the group's rows, tile after tile and each
// tile's run in order, into its accumulators (continued from the outputs
// when `accumulate`, else started at +0 / +inf / -inf). Lanes 0..4 carry
// one accumulator each (count, dsum, dsq, -vmin, vmax), so every lane
// runs the same instructions: an add and a NaN-propagating max, one of
// them kept. The minimum is the negated maximum of -v. The warp stages
// 256 rows at a time in shared memory, one plane per accumulator, and
// loads the next 256 while it folds.
__global__ void __launch_bounds__(kWalkWarps * 32)
group_walk_kernel(const float4* __restrict__ part,
                  const int* __restrict__ first,
                  const int* __restrict__ end, int tiles, int num_groups,
                  int accumulate, float* __restrict__ sums,
                  float* __restrict__ vmin_out,
                  float* __restrict__ vmax_out) {
  __shared__ float s_plane[kWalkWarps][5][kBatch];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = blockIdx.x * kWalkWarps + w;
  if (g >= num_groups) return;  // whole warp
  float (*plane)[kBatch] = s_plane[w];
  const int role = lane < 5 ? lane : 4;
  const bool is_add = role < 3;

  float acc = is_add ? 0.f : -INFINITY;
  if (accumulate) {
    acc = role < 3 ? sums[role * num_groups + g]
                   : role == 3 ? -vmin_out[g] : vmax_out[g];
  }
  const int* fg = first + static_cast<size_t>(g) * tiles;
  const int* eg = end + static_cast<size_t>(g) * tiles;
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const int f = t0 + lane < tiles ? fg[t0 + lane] : 0;
    const int len = t0 + lane < tiles ? eg[t0 + lane] - f : 0;
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    float4 cur[kBatch / 32];
    if (total > 0) load_batch(part, t0, f, len, incl, total, 0, cur);
    for (int o = 0; o < total; o += kBatch) {
#pragma unroll
      for (int u = 0; u < kBatch / 32; ++u) {
        const int i = u * 32 + lane;
        const bool live = cur[u].x > 0.f;  // a zero row: adds +0, no extreme
        plane[0][i] = cur[u].x;
        plane[1][i] = cur[u].y;
        plane[2][i] = cur[u].z;
        plane[3][i] = live ? -cur[u].w : -INFINITY;
        plane[4][i] = live ? cur[u].w : -INFINITY;
      }
      __syncwarp();
      if (o + kBatch < total) {  // in flight while the warp folds
        load_batch(part, t0, f, len, incl, total, o + kBatch, cur);
      }
      const int n8 = (min(kBatch, total - o) + 7) & ~7;
      for (int i = 0; i < n8; i += 8) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = plane[role][i + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float added = __fadd_rn(acc, x[u]);
          const float maxed = max_nan(acc, x[u]);
          acc = is_add ? added : maxed;
        }
      }
      __syncwarp();
    }
  }
  if (lane < 3) {
    sums[lane * num_groups + g] = acc;
  } else if (lane == 3) {
    vmin_out[g] = -acc;
  } else if (lane == 4) {
    vmax_out[g] = acc;
  }
}

}  // namespace

// Launches the fold on `stream`: for each chunk of `chunk_lanes` lanes, a
// zeroing of the run table, tile_sort and group_walk. sums is (3, G)
// row-major; vmin and vmax are (G,). Scratch: `part` holds
// ceil(chunk_lanes * block_rows / 1024) * 1024 float4 rows and `table`
// 2 * G * that many tiles ints. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int repro_block_agg(const float* values, const int* gids,
                               const float* mask, const int* blk,
                               const int* tvalid, int budget,
                               int block_rows, int num_groups, float center,
                               int chunk_lanes, void* part, int* table,
                               float* sums, float* vmin, float* vmax,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk_lanes < 1 || block_rows < 1 || num_groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int walk_grid = (num_groups + kWalkWarps - 1) / kWalkWarps;
  int l0 = 0;
  do {  // at least one walk, so an empty fold still writes its outputs
    const int lanes = budget - l0 < chunk_lanes ? budget - l0 : chunk_lanes;
    const long long rows = static_cast<long long>(lanes) * block_rows;
    const int tiles = static_cast<int>((rows + kTile - 1) / kTile);
    int* first = table;
    int* end = table + static_cast<size_t>(num_groups) * tiles;
    if (tiles > 0) {
      err = cudaMemsetAsync(table, 0,
                            2 * static_cast<size_t>(num_groups) * tiles *
                                sizeof(int), s);
      if (err != cudaSuccess) return static_cast<int>(err);
      tile_sort_kernel<<<tiles, kSortThreads, 0, s>>>(
          values, gids, mask, blk + l0, tvalid + l0, rows, block_rows,
          num_groups, center, tiles, static_cast<float4*>(part), first, end);
    }
    group_walk_kernel<<<walk_grid, kWalkWarps * 32, 0, s>>>(
        static_cast<const float4*>(part), first, end, tiles, num_groups,
        l0 > 0, sums, vmin, vmax);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    l0 += lanes;
  } while (l0 < budget);
  return static_cast<int>(cudaGetLastError());
}
