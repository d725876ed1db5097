// block_agg.cuh: the per-group moment fold shared by block_agg.cu and
// fused_fold.cu (which adds the histogram to the same pass).
//
// The fold replaces the TPU kernel `block_agg` (src/repro/kernels/block_agg.py,
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
// Interface: the kernels read the device-resident (nb, block_rows) slabs
// directly and gather the selected blocks themselves (`blk`, with
// `tvalid` marking padding lanes), so the (budget, block_rows) gather of
// the fused round is never materialised in device memory.
//
// Order of summation, fixed on purpose: each group's sums are accumulated
// in row order, one add after the other, exactly as the plain version's
// `index_add_` does on the CPU (and the JAX package's scatter). So the
// kernel gives the same bits as the plain version on ALL data, not only
// where sums are exactly representable, and the same bits on every run
// (no float atomics, no data-dependent order). A fold that sums per-block
// partials instead keeps the scan decisions but moves the engine's
// intervals by up to ~1e-3 relative against the CPU run on FLIGHTS data.
// The extremes are exact in any order (a NaN-propagating max is
// associative), so they are reduced in parallel.
//
// Design: two launches, no memset; scratch of 9 bytes a row plus a
// (tiles, buckets + 1) table of 16-bit offsets. A bucket is one group
// (warp mode) or 32 consecutive groups (lane mode); the wrapper picks the
// mode: lane mode when the rows average at most 64 a group.
//   1. tile_sort: one CTA of 256 threads per tile of 2,048 rows, 32 CTAs
//      at the main path's 64 blocks. It gathers its rows, decides
//      which change a sum or an extreme, and sorts them stably by bucket
//      with a block radix sort over only the bits the bucket count needs
//      (cub::BlockRadixSort, a block-level building block: at G 2,800 in
//      lane mode 89 buckets, 7 bits, 2 passes). It writes each row's slab
//      offset (with a padding-lane flag) in sorted order, and
//      start[t][k] = the first sorted position of a bucket >= k for every
//      k in 0..buckets, so bucket k's run in tile t is
//      [start[t][k], start[t][k + 1]). Every entry is written, so the
//      table needs no zeroing.
//   2. group_walk: one warp a CTA, one bucket a warp, over every SM. The
//      warp concatenates its bucket's runs of up to 32 tiles (a prefix
//      sum over lanes) and stages their rows in shared memory with
//      coalesced loads: three round trips to memory (table, entries,
//      rows) for a bucket's rows in a window of 32 tiles.
//      - Lane mode: lane l owns group 32 k + l. The warp sorts each
//        512 staged rows stably by group in shared memory (ranks from
//        __match_any_sync 32 rows at a time, offsets from a scan), and
//        each lane folds its own group's rows, in row order, into five
//        accumulators in its registers.
//      - Warp mode: two warps a group. Warp 1 stages 512 of the group's
//        rows at a time into one of two buffers of three planes (m,
//        (v - c) m, (v - c)^2 m), with the next batch's loads in flight,
//        and takes the extremes of the rows it staged (reduced across
//        the warp at the end); meanwhile lanes 0..2 of warp 0 each run
//        one sum's add chain over the other buffer, so a row costs the
//        chain one dependent add (~4 cycles) and no select.
//      - fused_fold's walk (kHist) also owns its groups' histogram rows:
//        the CTA has two or three more warps, which read the bucket's
//        rows from the scratch beside the fold and count each with
//        m != 0 into uint32 counters in shared memory (shared atomics),
//        and writes every cell of those rows once, as float32. Where the
//        32 rows of a lane-mode bucket do not fit in shared memory, the
//        bins are cut into slices, one CTA a (bucket, slice).
//   Each row is visited once (once a slice), in row order for its group.
// A row whose terms are all zero (m == 0 and v - c finite) changes no
// accumulator's bits (adding +-0 to a sum that starts at +0 is the
// identity) and takes no part in the extremes, so the sort drops it; a
// masked row with an inf or NaN value is kept and poisons its group's
// sums exactly as in the plain version. When (tiles x (buckets + 1))
// would outgrow the scratch table, the wrapper folds the lanes in
// consecutive chunks and each walk continues the previous chunk's
// accumulators: the order of the adds is the same.
//
// What bounds it on an H100: the bytes are small (12 B a row: at the main
// path's 64 blocks of 1024 rows, 0.8 MB, about 0.25 us at 3.35 TB/s), so
// a call is latency: two launches, the sort's passes and a few dependent
// round trips to memory. At G = 1 the walk is one chain of dependent adds
// over every live row (~52,000 x 4 cycles). PERF.md has the measured
// times. The arithmetic is IEEE round-to-nearest with no FMA contraction
// (__fmul_rn / __fadd_rn / __fsub_rn).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cub/block/block_radix_sort.cuh>

#include "hist_bin.cuh"

namespace {

constexpr int kItems = 8;             // rows a sorting thread holds
constexpr int kSortThreads = 256;
constexpr int kTile = kSortThreads * kItems;  // rows a sort CTA takes
constexpr int kLaneShift = 5;         // lane mode: 32 groups a bucket
constexpr int kBatch = 512;           // rows a warp stages per step
constexpr int kPer = kBatch / 32;     // ... per lane
constexpr int kPlane = kBatch + 1;    // plane stride: 3 planes, 3 banks

// NaN-propagating max (PTX max.NaN, sm_80+), as the plain version's
// scatter-min propagates NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Programmatic dependent launch (sm_90): the sort lets the walk's CTAs be
// scheduled early; the walk waits for the sort's writes before it reads.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The scratch of one chunk of `n` rows (a multiple of kTile): the sorted
// rows' (value, effective mask) pairs, their groups' low 5 bits (lane
// mode), then the (tiles, buckets + 1) start table.
struct Scratch {
  float2* xm;
  unsigned char* lg;
  unsigned short* start;
};

__host__ __device__ inline size_t start_offset(long long n) {
  return (static_cast<size_t>(n) * 9 + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline Scratch carve(void* base, long long n) {
  char* p = static_cast<char*>(base);
  return {reinterpret_cast<float2*>(p),
          reinterpret_cast<unsigned char*>(p + n * 8),
          reinterpret_cast<unsigned short*>(p + start_offset(n))};
}

// Tile `blockIdx.x` of the chunk's rows (lane-major, then row in block):
// thread i holds rows i * kItems .. + kItems - 1. Sorts the kept rows
// stably by bucket g >> shift (dropped rows and rows past the chunk take
// key `buckets`, last) and writes, in sorted order, each row's value and
// effective mask m = mask * valid and its group's low bits, and the
// tile's (buckets + 1)-entry start table (see the header). Every row with
// m != 0 is kept, so the walk sees every row the histogram counts.
__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(const float* __restrict__ values,
                 const int* __restrict__ gids,
                 const float* __restrict__ mask,
                 const int* __restrict__ blk,
                 const int* __restrict__ tvalid,
                 long long chunk_rows, int block_rows, int num_groups,
                 float center, int shift, int buckets, int key_bits,
                 Scratch out) {
  using Sort = cub::BlockRadixSort<unsigned, kSortThreads, kItems, unsigned>;
  __shared__ typename Sort::TempStorage s_sort;
  __shared__ float s_x[kTile], s_m[kTile];
  __shared__ unsigned char s_g[kTile];
  __shared__ unsigned s_last[kSortThreads];
  launch_dependents();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const unsigned dropped = static_cast<unsigned>(buckets);

  unsigned key[kItems], idx[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int local = threadIdx.x * kItems + u;
    const long long row = base + local;
    key[u] = dropped;
    idx[u] = static_cast<unsigned>(local);
    float x = 0.f, m = 0.f;
    int g = 0;
    if (row < chunk_rows) {
      const int r = static_cast<int>(row);
      const int lane = r / block_rows;
      const size_t src = static_cast<size_t>(blk[lane]) * block_rows +
                         (r - lane * block_rows);
      g = gids[src];
      x = values[src];
      m = __fmul_rn(mask[src], tvalid[lane] != 0 ? 1.f : 0.f);
      const float dv = __fsub_rn(x, center);
      const float b = __fmul_rn(dv, m), q = __fmul_rn(__fmul_rn(dv, dv), m);
      // NaN != 0: a NaN term keeps its row
      const bool kept = !(m == 0.f && b == 0.f && q == 0.f);
      if (kept && g >= 0 && g < num_groups) {
        key[u] = static_cast<unsigned>(g) >> shift;
      }
    }
    s_x[local] = x;
    s_m[local] = m;
    s_g[local] = static_cast<unsigned char>(g & 31);
  }

  Sort(s_sort).Sort(key, idx, 0, key_bits);  // blocked: stable, in place
  s_last[threadIdx.x] = key[kItems - 1];
  __syncthreads();  // s_x, s_m, s_g and s_last are written

  const int p0 = threadIdx.x * kItems;
  float4* xm = reinterpret_cast<float4*>(out.xm + base + p0);
#pragma unroll
  for (int u = 0; u < kItems; u += 2) {
    xm[u / 2] = make_float4(s_x[idx[u]], s_m[idx[u]], s_x[idx[u + 1]],
                            s_m[idx[u + 1]]);
  }
  unsigned lg[2] = {0u, 0u};  // the 8 groups' low bits, one byte each
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    lg[u / 4] |= static_cast<unsigned>(s_g[idx[u]]) << (8 * (u % 4));
  }
  *reinterpret_cast<uint2*>(out.lg + base + p0) = make_uint2(lg[0], lg[1]);

  unsigned short* st = out.start + static_cast<size_t>(blockIdx.x) *
                                       (static_cast<size_t>(buckets) + 1);
  // buckets (prev, key] start at this position; prev = -1 before the first
  long long prev = threadIdx.x == 0
                       ? -1LL
                       : static_cast<long long>(s_last[threadIdx.x - 1]);
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    for (long long k = prev + 1; k <= key[u]; ++k) {
      st[k] = static_cast<unsigned short>(p0 + u);
    }
    prev = key[u];
  }
  if (threadIdx.x == kSortThreads - 1) {
    for (long long k = prev + 1; k <= buckets; ++k) {
      st[k] = static_cast<unsigned short>(kTile);
    }
  }
}

// A window's runs: lane j describes the run [f, f + len) of tile t0 + j;
// `incl` is the inclusive sum of the lengths over the lanes and `total`
// the window's rows.
struct Runs {
  int t0, f, len, incl, total;
};

__device__ __forceinline__ Runs window_runs(
    const unsigned short* __restrict__ start, int tiles, int buckets, int t0,
    int k) {
  const int lane = threadIdx.x & 31;
  Runs w{t0, 0, 0, 0, 0};
  if (t0 + lane < tiles) {
    const unsigned short* st =
        start + static_cast<size_t>(t0 + lane) * (buckets + 1) + k;
    w.f = st[0];
    w.len = st[1] - w.f;
  }
  w.incl = w.len;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, w.incl, d);
    if (lane >= d) w.incl += y;
  }
  w.total = __shfl_sync(0xffffffffu, w.incl, 31);
  return w;
}

// Rows o + u*32 + lane (u < kPer) of a window's runs: their (value,
// effective mask), zeros past the total, and with kGroups their groups'
// low bits (32 past the total). Every lane must call it.
template <bool kGroups>
__device__ __forceinline__ void load_batch(const Scratch& sc, const Runs& w,
                                           int o, float2 (&xm)[kPer],
                                           int (&lg)[kPer]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int r = o + u * 32 + lane;
    int j = 0;  // the run holding row r: lanes whose incl <= r
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(0xffffffffu, w.incl, j + step - 1) <= r) j += step;
    }
    const int fj = __shfl_sync(0xffffffffu, w.f, j);
    const int excl = __shfl_sync(0xffffffffu, w.incl, j) -
                     __shfl_sync(0xffffffffu, w.len, j);
    const size_t at = static_cast<size_t>(w.t0 + j) * kTile + fj + (r - excl);
    const bool on = r < w.total;
    xm[u] = on ? sc.xm[at] : make_float2(0.f, 0.f);
    if constexpr (kGroups) lg[u] = on ? sc.lg[at] : 32;
  }
}

// Named barriers between the two warps of a warp-mode CTA (0 is
// __syncthreads'), one pair per plane buffer: buffer b is full (barrier
// 1 + b) or empty again (3 + b). The ids are immediates, so the kernel
// reserves only the barriers it uses.
template <int kId>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, 64;" ::"n"(kId) : "memory");
}
template <int kId>
__device__ __forceinline__ void named_arrive() {
  __threadfence_block();  // this warp's shared-memory accesses come first
  asm volatile("bar.arrive %0, 64;" ::"n"(kId) : "memory");
}
__device__ __forceinline__ void sync_full(int b) {
  if (b) named_sync<2>(); else named_sync<1>();
}
__device__ __forceinline__ void arrive_full(int b) {
  if (b) named_arrive<2>(); else named_arrive<1>();
}
__device__ __forceinline__ void sync_empty(int b) {
  if (b) named_sync<4>(); else named_sync<3>();
}
__device__ __forceinline__ void arrive_empty(int b) {
  if (b) named_arrive<4>(); else named_arrive<3>();
}

// The histogram a fused walk CTA owns: the counts of its bucket's groups
// (one group in warp mode, 32 in lane mode) over its slice of the bins,
// [s0, s0 + len), as uint32 counters in shared memory, `stride` counters
// a group (a multiple of 4: the write-back reads them as uint4).
struct HistSlice {
  unsigned* counts;  // shared memory
  int stride, s0, len;
  float a, inv_width;
  int nbins;
};

// The slice-local bin of a row with value x, or kNoCell when its bin is
// outside the slice.
__device__ __forceinline__ unsigned slice_bin(const HistSlice& hs, float x) {
  const unsigned k = static_cast<unsigned>(hist_bin(x, hs.a, hs.inv_width,
                                                    hs.nbins) - hs.s0);
  return k < static_cast<unsigned>(hs.len) ? k : kNoCell;
}

// Warp mode, two warps a group (bucket = group): warp 1 stages the
// group's rows kBatch at a time into one of two buffers of three planes
// (m, (v - c) m, (v - c)^2 m) and takes the extremes of the rows it
// staged; meanwhile warp 0's lanes 0..2 run the add chains of count,
// dsum and dsq over the other buffer, so a row costs the chain one
// dependent add. Folds continue from `acc`; writes the outputs when
// `out`.
__device__ void warp_fold(const Scratch& sc, float center, int tiles,
                          int buckets, int g, int num_groups,
                          float* __restrict__ planes, const float (&acc)[5],
                          bool out, float* __restrict__ sums,
                          float* __restrict__ vmin_out,
                          float* __restrict__ vmax_out) {
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x >= 32;
  const int role = lane < 3 ? lane : 2;
  float sum = acc[role];
  float nmin = acc[3], vmax = acc[4];  // over the rows this lane staged
  int unused[kPer];
  int i = 0;  // batches so far
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const Runs w = window_runs(sc.start, tiles, buckets, t0, g);
    if (w.total == 0) continue;
    if (producer) {
      float2 xm[kPer];
      load_batch<false>(sc, w, 0, xm, unused);
      for (int o = 0; o < w.total; o += kBatch, ++i) {
        float* pl = planes + (i & 1) * 3 * kPlane;
        if (i >= 2) sync_empty(i & 1);
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const float x = xm[u].x, m = xm[u].y;
          const float dv = __fsub_rn(x, center);
          const int r = u * 32 + lane;
          pl[0 * kPlane + r] = m;
          pl[1 * kPlane + r] = __fmul_rn(dv, m);
          pl[2 * kPlane + r] = __fmul_rn(__fmul_rn(dv, dv), m);
          const bool hit = m > 0.f;  // a zero row: adds +0, no extreme
          nmin = max_nan(nmin, hit ? -x : -INFINITY);
          vmax = max_nan(vmax, hit ? x : -INFINITY);
        }
        arrive_full(i & 1);
        if (o + kBatch < w.total) {
          load_batch<false>(sc, w, o + kBatch, xm, unused);
        }
      }
    } else {
      for (int o = 0; o < w.total; o += kBatch, ++i) {
        const float* mine = planes + (i & 1) * 3 * kPlane + role * kPlane;
        sync_full(i & 1);
        // 64 loads, then 64 dependent adds: one shared-memory latency
        // per 64 rows (loads software-pipelined into the adds measured
        // slower on an H100: the compiler waits on them as a group)
        const int n64 = (min(kBatch, w.total - o) + 63) & ~63;
        for (int r = 0; r < n64; r += 64) {
          float x[64];
#pragma unroll
          for (int u = 0; u < 64; ++u) x[u] = mine[r + u];
#pragma unroll
          for (int u = 0; u < 64; ++u) sum = __fadd_rn(sum, x[u]);
        }
        arrive_empty(i & 1);
      }
    }
  }
  if (producer) {
    for (int k = i < 2 ? 0 : i - 2; k < i; ++k) {
      sync_empty(k & 1);  // the last buffers' chains are done
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      nmin = max_nan(nmin, __shfl_xor_sync(0xffffffffu, nmin, d));
      vmax = max_nan(vmax, __shfl_xor_sync(0xffffffffu, vmax, d));
    }
    if (lane == 0 && out) {
      vmin_out[g] = -nmin;
      vmax_out[g] = vmax;
    }
  } else if (lane < 3 && out) {
    sums[lane * num_groups + g] = sum;
  }
}

// The fused walk's histogram: counting warp `part` of `parts` takes every
// parts-th batch of bucket k's rows from the scratch and counts each row
// with m != 0 into its group's row of the slice's counters (the group's
// low bits pick the row in lane mode) with a shared-memory atomic,
// beside the fold's warps and off their add chains.
template <bool kLane>
__device__ void count_rows(const Scratch& sc, int tiles, int buckets, int k,
                           const HistSlice& hs, int part, int parts) {
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const Runs w = window_runs(sc.start, tiles, buckets, t0, k);
    for (int o = part * kBatch; o < w.total; o += parts * kBatch) {
      float2 xm[kPer];
      int lg[kPer];
      load_batch<kLane>(sc, w, o, xm, lg);  // m = 0 past the rows
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const unsigned b = xm[u].y != 0.f ? slice_bin(hs, xm[u].x) : kNoCell;
        if (b != kNoCell) {
          atomicAdd(hs.counts + (kLane ? lg[u] * hs.stride : 0) + b, 1u);
        }
      }
    }
  }
}

// Lane mode: lane l folds group 32 k + l of bucket k. The warp loads
// the bucket's rows kBatch at a time and sorts them stably by group in
// shared memory (a counting sort: each row's rank among its group's rows,
// 32 rows at a time in row order with __match_any_sync, then the groups'
// offsets from a scan of their counts); then each lane folds its own
// group's rows, in row order, into five accumulators in its registers.
__device__ void lane_fold(const Scratch& sc, float center, int tiles,
                          int buckets, int k, float4* __restrict__ s_sorted,
                          int* __restrict__ s_cnt, float (&acc)[5]) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const Runs w = window_runs(sc.start, tiles, buckets, t0, k);
    for (int o = 0; o < w.total; o += kBatch) {
      float2 xm[kPer];
      int lg[kPer], pos[kPer];
      load_batch<true>(sc, w, o, xm, lg);  // lg 32 past the rows
      s_cnt[lane] = 0;
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kPer; ++u) {  // rows u*32 + lane, in row order
        const unsigned peers = __match_any_sync(0xffffffffu, lg[u]);
        const int base = lg[u] < 32 ? s_cnt[lg[u]] : 0;
        pos[u] = base + __popc(peers & below);
        __syncwarp();
        if (lg[u] < 32 && (peers & below) == 0) {
          s_cnt[lg[u]] = base + __popc(peers);
        }
        __syncwarp();
      }
      const int cnt = s_cnt[lane];
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      const int off = incl - cnt;
      __syncwarp();
      s_cnt[lane] = off;
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (lg[u] < 32) {
          const float x = xm[u].x, m = xm[u].y;
          const float dv = __fsub_rn(x, center);
          s_sorted[s_cnt[lg[u]] + pos[u]] = make_float4(
              m, __fmul_rn(dv, m), __fmul_rn(__fmul_rn(dv, dv), m), x);
        }
      }
      __syncwarp();
      for (int p = off; p < off + cnt; ++p) {  // this lane's group
        const float4 t = s_sorted[p];
        const bool hit = t.x > 0.f;  // a = m
        acc[0] = __fadd_rn(acc[0], t.x);
        acc[1] = __fadd_rn(acc[1], t.y);
        acc[2] = __fadd_rn(acc[2], t.z);
        acc[3] = max_nan(acc[3], hit ? -t.w : -INFINITY);
        acc[4] = max_nan(acc[4], hit ? t.w : -INFINITY);
      }
      __syncwarp();
    }
  }
}

// The fused walk's CTA: the fold's warps and two or three more that count
// the histogram slice, and all of them zero and write it.
constexpr int kHistWalkThreads = 128;
// The walk's static shared memory (s_terms, s_cnt) and the most a CTA may
// take in all (227 KB): the histogram's counters get the difference.
constexpr int kWalkStaticSmem = (6 * kPlane + 3) / 4 * 16 + 32 * 4;
constexpr int kSmemPerCta = 232448;

// How the fused walk's CTAs split the histogram: a bucket's rows of
// counters (32 groups in lane mode, one in warp mode), `stride` uint32
// counters each, in the shared memory the walk leaves (kSmemPerCta -
// kWalkStaticSmem). Where all nbins bins do not fit, they are cut into
// the fewest equal slices of a multiple of 4 bins, and each (bucket,
// slice) gets a CTA of its own. A stride is a whole number of 16-byte
// words (the write-back reads the counters 4 at a time).
struct HistPlan {
  int slice_bins, slices, stride, smem_bytes;
};

inline HistPlan hist_plan(int nbins, bool lane_mode) {
  const int rows = lane_mode ? 32 : 1;
  const int max_bins = (kSmemPerCta - kWalkStaticSmem) / (4 * rows) / 4 * 4;
  const int slices = (nbins + max_bins - 1) / max_bins;  // the fewest
  const int slice_bins =
      slices > 1 ? ((nbins + slices - 1) / slices + 3) / 4 * 4 : nbins;
  const int stride = (slice_bins + 3) / 4 * 4;
  return HistPlan{slice_bins, (nbins + slice_bins - 1) / slice_bins, stride,
                  rows * stride * 4};
}

// The histogram's place in the fused walk: the (G, nbins) float32 output
// and its grid; launch_fold fills in each CTA's slice width and counter
// stride from hist_plan.
struct HistOut {
  float* hist;
  int nbins;
  float a, inv_width;
  int slice_bins, stride;
};

// One bucket a CTA: bucket blockIdx.x. Warp mode folds group blockIdx.x
// with two warps; lane mode folds groups 32 * blockIdx.x + lane, one a
// lane of warp 0. Folds continue from the outputs when `accumulate`,
// else start at +0 / +inf / -inf.
// With kHist the CTA also owns bins [s0, s0 + slice_bins) of its groups'
// histogram rows, s0 = blockIdx.y * slice_bins: it zeroes its counters
// in shared memory while the sort still runs, counts while it folds
// (the warps past the fold's, count_rows; only slice 0's CTA writes the
// moments, the others walk the same rows for their bins), and at the
// end writes every cell of its slice of its groups' rows once, as
// float32, with coalesced stores (added to what an earlier chunk wrote
// when `accumulate`; counts are whole numbers below 2^24, so the float
// add is exact). Every cell of (G, nbins) is written by exactly one
// CTA, zeros included: no memset, no float pass.
template <bool kHist>
__global__ void __launch_bounds__(kHist ? kHistWalkThreads : 64)
group_walk_kernel(Scratch sc, float center, int tiles, int num_groups,
                  int buckets, int lane_mode, int accumulate,
                  float* __restrict__ sums, float* __restrict__ vmin_out,
                  float* __restrict__ vmax_out, HistOut ho) {
  // lane mode: kBatch staged rows' terms; warp mode: two buffers of planes
  __shared__ float4 s_terms[(6 * kPlane + 3) / 4];
  __shared__ int s_cnt[32];
  extern __shared__ uint4 s_counts[];  // kHist: rows x stride uint32
  static_assert(6 * kPlane >= 4 * kBatch, "the terms fit the buffer");
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x;
  const int g0 = lane_mode ? k << kLaneShift : k;
  const int g = lane_mode ? g0 + lane : k;
  const bool has = g < num_groups;
  const bool out = !kHist || blockIdx.y == 0;  // writes the moments
  HistSlice hs{};
  int rows = 0;
  if constexpr (kHist) {
    rows = lane_mode ? min(32, num_groups - g0) : 1;
    hs = HistSlice{reinterpret_cast<unsigned*>(s_counts), ho.stride,
                   static_cast<int>(blockIdx.y) * ho.slice_bins, 0, ho.a,
                   ho.inv_width, ho.nbins};
    hs.len = min(ho.slice_bins, ho.nbins - hs.s0);
    for (int i = threadIdx.x; i < rows * ho.stride / 4; i += blockDim.x) {
      s_counts[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
  }
  wait_for_primary();  // the sort's writes (and a previous chunk's sums)
  if (threadIdx.x < (lane_mode ? 32 : 64)) {  // the fold's warps
    float acc[5] = {0.f, 0.f, 0.f, -INFINITY, -INFINITY};
    if (accumulate && has && out) {
      acc[0] = sums[g];
      acc[1] = sums[num_groups + g];
      acc[2] = sums[2 * num_groups + g];
      acc[3] = -vmin_out[g];
      acc[4] = vmax_out[g];
    }
    if (!lane_mode) {
      warp_fold(sc, center, tiles, buckets, k, num_groups,
                reinterpret_cast<float*>(s_terms), acc, out, sums, vmin_out,
                vmax_out);
    } else {
      lane_fold(sc, center, tiles, buckets, k, s_terms, s_cnt, acc);
      if (has && out) {
        sums[g] = acc[0];
        sums[num_groups + g] = acc[1];
        sums[2 * num_groups + g] = acc[2];
        vmin_out[g] = -acc[3];
        vmax_out[g] = acc[4];
      }
    }
  }
  if constexpr (kHist) {
    const int fold_warps = lane_mode ? 1 : 2, warp = threadIdx.x >> 5;
    if (warp >= fold_warps) {
      const int parts = kHistWalkThreads / 32 - fold_warps;
      if (lane_mode) {
        count_rows<true>(sc, tiles, buckets, k, hs, warp - fold_warps, parts);
      } else {
        count_rows<false>(sc, tiles, buckets, k, hs, warp - fold_warps, parts);
      }
    }
    __syncthreads();  // every count is in
    for (int j = 0; j < rows; ++j) {
      const unsigned* src = hs.counts + j * ho.stride;
      float* dst = ho.hist + static_cast<size_t>(g0 + j) * ho.nbins + hs.s0;
      if ((ho.nbins & 3) == 0) {  // rows and slices are whole float4s
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        float4* d4 = reinterpret_cast<float4*>(dst);
        for (int c = threadIdx.x; c < hs.len / 4; c += blockDim.x) {
          const uint4 n = s4[c];
          float4 v = make_float4(__uint2float_rn(n.x), __uint2float_rn(n.y),
                                 __uint2float_rn(n.z), __uint2float_rn(n.w));
          if (accumulate) {
            const float4 o = d4[c];
            v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y),
                            __fadd_rn(o.z, v.z), __fadd_rn(o.w, v.w));
          }
          d4[c] = v;
        }
      } else {
        for (int c = threadIdx.x; c < hs.len; c += blockDim.x) {
          const float v = __uint2float_rn(src[c]);
          dst[c] = accumulate ? __fadd_rn(dst[c], v) : v;
        }
      }
    }
  }
}

inline int bits_for(int v) {  // bits of the largest key, v
  int bits = 0;
  while (bits < 31 && (v >> bits) != 0) ++bits;
  return bits;
}

// Lets the fused walk take `bytes` of dynamic shared memory on `device`
// (above 48 KB a kernel must ask; once per device and size).
inline cudaError_t allow_walk_smem(int device, int bytes) {
  constexpr int kMaxDevices = 64;
  static int allowed[kMaxDevices] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (device >= 0 && device < kMaxDevices && allowed[device] >= bytes) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      group_walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    allowed[device] = bytes;
  }
  return err;
}

// Launches the fold on `stream`: for each chunk of `chunk_lanes` lanes,
// tile_sort and group_walk (two launches a chunk, no memset; the walk is
// a programmatic dependent launch, so its CTAs are resident before the
// sort ends). sums is (3, G) row-major; vmin and vmax are (G,).
// `lane_mode` picks the bucket: 32 groups (lane mode) or one. `scratch`
// holds, for n = ceil(chunk_lanes * block_rows / kTile) * kTile rows,
// start_offset(n) bytes of rows then n / kTile * (buckets + 1) uint16
// offsets (buckets = ceil(G / 32) in lane mode, else G). With kHist,
// `ho` names the (G, nbins) float32 histogram the walk writes, in the
// slices of bins hist_plan gives, a CTA each. Returns
// cudaGetLastError() after the launches (0 on success).
template <bool kHist>
int launch_fold(const float* values, const int* gids, const float* mask,
                const int* blk, const int* tvalid, int budget, int block_rows,
                int num_groups, float center, int chunk_lanes, int lane_mode,
                void* scratch, float* sums, float* vmin, float* vmax,
                HistOut ho, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk_lanes < 1 || block_rows < 1 || num_groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shift = lane_mode ? kLaneShift : 0;
  const int buckets = ((num_groups - 1) >> shift) + 1;
  const int key_bits = bits_for(buckets);
  const long long chunk_n =
      (static_cast<long long>(chunk_lanes) * block_rows + kTile - 1) /
      kTile * kTile;
  const Scratch sc = carve(scratch, chunk_n);
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t walk{};
  walk.gridDim = dim3(static_cast<unsigned>(buckets));
  walk.blockDim = dim3(lane_mode ? 32 : 64);  // warp mode: two warps
  walk.stream = s;
  if constexpr (kHist) {
    if (ho.nbins < 1) return static_cast<int>(cudaErrorInvalidValue);
    const HistPlan hp = hist_plan(ho.nbins, lane_mode != 0);
    if (hp.smem_bytes + kWalkStaticSmem > kSmemPerCta) {  // never: the plan
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ho.slice_bins = hp.slice_bins;
    ho.stride = hp.stride;
    walk.gridDim.y = static_cast<unsigned>(hp.slices);
    walk.blockDim = dim3(kHistWalkThreads);
    walk.dynamicSmemBytes = static_cast<size_t>(hp.smem_bytes);
    err = allow_walk_smem(device, hp.smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int l0 = 0;
  do {  // at least one walk, so an empty fold still writes its outputs
    const int lanes = budget - l0 < chunk_lanes ? budget - l0 : chunk_lanes;
    const long long rows = static_cast<long long>(lanes) * block_rows;
    const int tiles = static_cast<int>((rows + kTile - 1) / kTile);
    if (tiles > 0) {
      tile_sort_kernel<<<tiles, kSortThreads, 0, s>>>(
          values, gids, mask, blk + l0, tvalid + l0, rows, block_rows,
          num_groups, center, shift, buckets, key_bits, sc);
    }
    walk.attrs = tiles > 0 ? pdl : nullptr;
    walk.numAttrs = tiles > 0 ? 1 : 0;
    err = cudaLaunchKernelEx(&walk, group_walk_kernel<kHist>, sc, center,
                             tiles, num_groups, buckets, lane_mode,
                             static_cast<int>(l0 > 0), sums, vmin, vmax, ho);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    l0 += lanes;
  } while (l0 < budget);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
