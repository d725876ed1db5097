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
// lookahead_blocks * block_rows = 1M rows a call at the defaults; the
// exact sweep of a GROUP BY airline is G = 14 at 1,024 bins).
//
// What bounds it on an H100: bytes. Each row is read once (12 B: at 1M
// rows, 12.6 MB, about 3.8 us at 3.35 TB/s) and each cell of the
// histogram written once (4 B). Every thread loads its rows 16 bytes at a
// time (value, group and mask of four rows; scalar loads for a ragged
// tail or an input that is not 16-byte aligned). Rows are counted with
// m != 0 as integers in shared memory, so the result is the same on every
// run and equal to the plain version's float32 sums of 0 / 1 masks; no
// float atomics. Every cell of the output is written once, as float32:
// no memset, no float pass.
//
// One regime per size of the cell space C = G * nbins (grouped_hist_plan,
// mirrored by `plan` in grouped_hist.py):
//
//   private (C <= kMaxCells, 224 KB of counters: G <= 56 at 1,024 bins;
//     one launch). One CTA of 1,024 threads an SM, in clusters of two,
//     each with its own copy of the C counters in shared memory, zeroed
//     while its first rows load; the CTAs split the rows in stages of
//     4,096, the next stage's loads in flight while a stage is counted.
//     The two CTAs of a cluster then pool their copies (each adds up
//     half the cells of both through distributed shared memory) and add
//     the non-zero sums to a uint32 copy in device memory (reductions,
//     one a cell that the cluster saw, not one a row); all CTAs wait at
//     a grid barrier and each turns its slice
//     of the device copy into float32 cells of the histogram, setting the
//     copy back to zero. The copy and the barrier's count live in a
//     buffer kept per (device, stream) and zeroed once; every call leaves
//     them as it found them, so it needs no memset and a captured CUDA
//     graph replays right.
//
//   bucketed (C > kMaxCells; two launches). The cells are cut into
//     ~kTargetBuckets buckets of consecutive cells (bucket_cells, at most
//     kMaxCells; a bucket is a run of whole or partial histogram rows).
//     1. hist_sort: a CTA a tile of 4,096 rows ranks each counted row
//        within its bucket (a shared atomic), scans the bucket counts,
//        groups the rows' 16-bit cells within their buckets by bucket in
//        shared memory and stores the tile with 16-byte stores, and
//        start[k][tile] = the tile's first row of bucket k.
//     2. hist_bucket (a programmatic dependent launch: its CTAs are
//        launched while the sort ends): a CTA of 512 threads a bucket
//        (two an SM) reads its runs of every tile 8 entries at a time (a
//        prefix sum over the tiles' 8-entry chunks, then a thread a
//        chunk, so a bucket that holds most rows costs one search per 8
//        of them), counts them in shared memory and writes its cells
//        once, with float4 stores.
//     The scratch (2 B a row and the start table) is written before it is
//     read in every call, so it needs no zeroing.
//
// PERF.md has the measured times. The grid barrier lets every CTA
// convert a slice of the cells: one CTA converting them all moves the
// whole histogram through one SM. The barrier needs every CTA of the
// grid resident at once, and the launch makes that a guarantee: it is
// cooperative (cudaLaunchAttributeCooperative beside the cluster
// dimension), so the runtime starts the grid only when all of its CTAs
// fit on the card together, whatever other kernels (another stream's
// call, a collective, an MPS share) hold, and refuses a grid that could
// never fit. The grid is sized from cudaOccupancyMaxActiveClusters of an
// idle card (one CTA an SM). There is no fallback path and no timeout.

#include <cooperative_groups.h>

#include "hist_bin.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;  // hist_private's and hist_sort's CTA
constexpr int kQuad = 4;        // rows a thread loads at once (16 B each)
constexpr int kStageRows = kThreads * kQuad;  // a stage, and a sort tile
constexpr int kMaxCells = 57344;  // 224 KB of uint32 counters a CTA
constexpr int kTargetBuckets = 256;
constexpr int kChunkTiles = 256;  // tiles a bucket CTA reads at a time
constexpr int kBucketThreads = 512;  // hist_bucket's CTA: two an SM
constexpr int kCluster = 2;  // private CTAs that pool their copies
constexpr int kPrivate = 0, kBucketed = 1;

// The launch plan of one call: `count` is the launch that counts in
// shared memory and writes the histogram (hist_private or hist_bucket),
// `sort` hist_sort (bucketed regime only; none for n = 0).
struct GroupedHistPlan {
  long long regime, launches, count_ctas, count_smem, sort_ctas, sort_smem,
      bucket_cells, scratch_bytes;
};

inline long long round4(long long v) { return (v + 3) / 4 * 4; }

// `resident`: the private kernel's CTAs that the card holds at once (its
// clusters' co-residency; one CTA an SM).
inline GroupedHistPlan grouped_hist_plan(long long n, int num_groups,
                                         int nbins, int resident) {
  const long long cells = static_cast<long long>(num_groups) * nbins;
  const long long stages = (n + kStageRows - 1) / kStageRows;
  GroupedHistPlan p{};
  if (cells <= kMaxCells) {
    p.regime = kPrivate;
    p.launches = 1;
    const long long most = resident / kCluster * kCluster;
    const long long want = ((stages > 0 ? stages : 1) + kCluster - 1) /
                           kCluster * kCluster;
    p.count_ctas = want < most ? want : most;
    p.count_smem = round4(cells) * 4;
    p.bucket_cells = cells;
    p.scratch_bytes = (kMaxCells + 4) * 4;  // counters, then the barrier
  } else {
    const long long per = round4((cells + kTargetBuckets - 1) /
                                 kTargetBuckets);
    p.regime = kBucketed;
    p.bucket_cells = per < kMaxCells ? per : kMaxCells;
    p.count_ctas = (cells + p.bucket_cells - 1) / p.bucket_cells;
    p.count_smem = round4(p.bucket_cells) * 4;
    p.sort_ctas = stages;
    p.sort_smem = p.count_ctas * 4;
    p.launches = stages > 0 ? 2 : 1;
    p.scratch_bytes = (stages * kStageRows * 2 +
                       (p.count_ctas + 1) * stages * 2 + 15) / 16 * 16;
  }
  return p;
}

// Programmatic dependent launch (sm_90): the bucket CTAs are launched
// while the sort ends and wait for its writes before they read. The sort
// does not trigger them earlier: resident bucket CTAs would take the
// slots its later CTAs need.
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

struct Rows {
  const float* values;
  const int* gids;
  const float* mask;
  long long n;
  int vec;  // all three 16-byte aligned: rows load as float4 / int4
  int num_groups, nbins;
  float a, inv_width;
};

// The value, group and mask of rows row0 .. row0 + 3 (row0 a multiple
// of 4); a row past n reads as masked, with no memory access.
struct Quad {
  float v[kQuad], m[kQuad];
  int g[kQuad];
};

__device__ __forceinline__ void load_quad(const Rows& in, long long row0,
                                          Quad& q) {
  if (in.vec && row0 + kQuad <= in.n) {
    const float4 v4 = __ldcs(reinterpret_cast<const float4*>(in.values +
                                                             row0));
    const int4 g4 = __ldcs(reinterpret_cast<const int4*>(in.gids + row0));
    const float4 m4 = __ldcs(reinterpret_cast<const float4*>(in.mask +
                                                             row0));
    q = Quad{{v4.x, v4.y, v4.z, v4.w}, {m4.x, m4.y, m4.z, m4.w},
             {g4.x, g4.y, g4.z, g4.w}};
    return;
  }
#pragma unroll
  for (int u = 0; u < kQuad; ++u) {
    const long long r = row0 + u;
    q.v[u] = 0.f;
    q.m[u] = 0.f;
    q.g[u] = 0;
    if (r < in.n) {
      q.v[u] = in.values[r];
      q.m[u] = in.mask[r];
      q.g[u] = in.gids[r];
    }
  }
}

// Each row's cell g * nbins + bin(v), or kNoCell for a row that counts
// nowhere: m == 0 or a group outside [0, G).
__device__ __forceinline__ void quad_cells(const Rows& in, const Quad& q,
                                           unsigned (&cell)[kQuad]) {
#pragma unroll
  for (int u = 0; u < kQuad; ++u) {
    cell[u] = q.m[u] == 0.f || q.g[u] < 0 || q.g[u] >= in.num_groups
                  ? kNoCell
                  : static_cast<unsigned>(q.g[u]) *
                            static_cast<unsigned>(in.nbins) +
                        static_cast<unsigned>(hist_bin(q.v[u], in.a,
                                                       in.inv_width,
                                                       in.nbins));
  }
}

// Writes `len` uint32 counts as float32 to dst (16-byte aligned).
__device__ __forceinline__ void write_floats(const uint4* counts, int len,
                                             float* dst) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < len / 4; i += blockDim.x) {
    const uint4 c = counts[i];
    d4[i] = make_float4(__uint2float_rn(c.x), __uint2float_rn(c.y),
                        __uint2float_rn(c.z), __uint2float_rn(c.w));
  }
  const unsigned* c1 = reinterpret_cast<const unsigned*>(counts);
  for (int i = len / 4 * 4 + threadIdx.x; i < len; i += blockDim.x) {
    dst[i] = __uint2float_rn(c1[i]);
  }
}

// In place: s[0 .. len) becomes its exclusive prefix sum; returns the
// total. Every thread of the CTA must call it; s_warp holds a word a
// warp.
__device__ unsigned block_exclusive_scan(unsigned* s, int len,
                                         unsigned* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int lo = min(len, static_cast<int>(threadIdx.x) * per);
  const int hi = min(len, lo + per);
  unsigned sum = 0;
  for (int i = lo; i < hi; ++i) sum += s[i];
  unsigned incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < warps ? s_warp[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < warps) s_warp[lane] = w;
  }
  __syncthreads();
  unsigned run = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0u);
  const unsigned total = s_warp[warps - 1];
  for (int i = lo; i < hi; ++i) {
    const unsigned c = s[i];
    s[i] = run;
    run += c;
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Every CTA of the grid waits here until all have arrived; their writes
// before it are visible to all after it. `count` is zero on entry: each
// CTA adds one, the last to arrive sets it back to zero, and the others
// wait for that. The grid's CTAs must be resident together: the private
// regime launches at most one CTA an SM, cooperatively (see the header).
__device__ void grid_barrier(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // the CTA's writes (ordered by the barrier) first
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(count),
                   "r"(0u) : "memory");
    } else {
      while (load_acquire(count) != 0u) {
      }
    }
  }
  __syncthreads();
}

// The private regime, one launch: see the header. `counters` holds
// kMaxCells uint32 counters, all zero on entry and on exit, then the
// grid barrier's count.
__global__ void __launch_bounds__(kThreads, 1)
hist_private_kernel(Rows in, int cells, unsigned* __restrict__ counters,
                    float* __restrict__ hist) {
  extern __shared__ uint4 s_counts4[];
  unsigned* s_counts = reinterpret_cast<unsigned*>(s_counts4);
  const long long stride = static_cast<long long>(gridDim.x) * kStageRows;
  const long long lane_row = static_cast<long long>(threadIdx.x) * kQuad;
  long long base = static_cast<long long>(blockIdx.x) * kStageRows;
  Quad q;
  load_quad(in, base + lane_row, q);  // in flight under the zeroing
  const int words = (cells + 3) / 4;
  for (int i = threadIdx.x; i < words; i += kThreads) {
    s_counts4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  while (base < in.n) {  // uniform across the CTA
    const long long next = base + stride;
    Quad ahead;
    load_quad(in, next + lane_row, ahead);  // in flight while q counts
    unsigned cell[kQuad];
    quad_cells(in, q, cell);
#pragma unroll
    for (int u = 0; u < kQuad; ++u) {
      if (cell[u] != kNoCell) atomicAdd(s_counts + cell[u], 1u);
    }
    q = ahead;
    base = next;
  }
  // the cluster's copies, pooled: CTA r adds up slice r of every copy in
  // the cluster (distributed shared memory) and adds the non-zero sums to
  // the device-memory copy. No CTA leaves before the grid barrier below,
  // which every CTA reaches after its reads, so no copy goes away early.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int slice = (words + kCluster - 1) / kCluster;
  const int s1 = min(words, (rank + 1) * slice);
  for (int i = rank * slice + threadIdx.x; i < s1; i += kThreads) {
    uint4 c = s_counts4[i];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) {
      const uint4 v = cluster.map_shared_rank(
          s_counts4, static_cast<unsigned>((rank + q) % kCluster))[i];
      c.x += v.x;
      c.y += v.y;
      c.z += v.z;
      c.w += v.w;
    }
    unsigned* d = counters + 4 * i;
    if (c.x != 0u) atomicAdd(d, c.x);
    if (c.y != 0u) atomicAdd(d + 1, c.y);
    if (c.z != 0u) atomicAdd(d + 2, c.z);
    if (c.w != 0u) atomicAdd(d + 3, c.w);
  }
  grid_barrier(counters + kMaxCells);  // every CTA's adds are in
  // this CTA's slice of the words: read, write as float32, set to zero
  const int per = (words + gridDim.x - 1) / gridDim.x;
  const int w1 = min(words, static_cast<int>(blockIdx.x + 1) * per);
  uint4* c4 = reinterpret_cast<uint4*>(counters);
  for (int i = blockIdx.x * per + threadIdx.x; i < w1; i += kThreads) {
    const uint4 c = __ldcg(c4 + i);
    __stcg(c4 + i, make_uint4(0u, 0u, 0u, 0u));
    const float f[4] = {__uint2float_rn(c.x), __uint2float_rn(c.y),
                        __uint2float_rn(c.z), __uint2float_rn(c.w)};
    if (4 * i + 4 <= cells) {
      reinterpret_cast<float4*>(hist)[i] = make_float4(f[0], f[1], f[2],
                                                       f[3]);
    } else {
      for (int e = 0; 4 * i + e < cells; ++e) hist[4 * i + e] = f[e];
    }
  }
}

// Bucketed regime, launch 1: tile blockIdx.x's counted rows, grouped by
// bucket (any order within a bucket: the counts do not depend on it).
__global__ void __launch_bounds__(kThreads, 2)
hist_sort_kernel(Rows in, unsigned bucket_cells, int buckets, int tiles,
                 unsigned short* __restrict__ sorted,
                 unsigned short* __restrict__ start) {
  extern __shared__ unsigned s_cnt[];  // buckets
  __shared__ uint4 s_out4[kStageRows / 8];  // the sorted tile, 2 B a row
  __shared__ unsigned s_warp[32];
  unsigned short* s_out = reinterpret_cast<unsigned short*>(s_out4);
  const int t = blockIdx.x;
  Quad q;
  load_quad(in, static_cast<long long>(t) * kStageRows +
                    static_cast<long long>(threadIdx.x) * kQuad, q);
  for (int i = threadIdx.x; i < buckets; i += kThreads) s_cnt[i] = 0u;
  __syncthreads();
  unsigned cell[kQuad], rank[kQuad];
  quad_cells(in, q, cell);
#pragma unroll
  for (int u = 0; u < kQuad; ++u) {
    if (cell[u] != kNoCell) rank[u] = atomicAdd(s_cnt + cell[u] /
                                                bucket_cells, 1u);
  }
  __syncthreads();
  const unsigned total = block_exclusive_scan(s_cnt, buckets, s_warp);
  for (int k = threadIdx.x; k <= buckets; k += kThreads) {
    start[static_cast<size_t>(k) * tiles + t] =
        static_cast<unsigned short>(k < buckets ? s_cnt[k] : total);
  }
#pragma unroll
  for (int u = 0; u < kQuad; ++u) {
    if (cell[u] != kNoCell) {
      const unsigned k = cell[u] / bucket_cells;
      s_out[s_cnt[k] + rank[u]] =
          static_cast<unsigned short>(cell[u] - k * bucket_cells);
    }
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(sorted +
                                        static_cast<size_t>(t) * kStageRows);
  for (int i = threadIdx.x; i < static_cast<int>(total + 7) / 8;
       i += kThreads) {
    out[i] = s_out4[i];  // coalesced; past `total` nothing is read
  }
}

// Bucketed regime, launch 2: bucket blockIdx.x's cells [c0, c0 + len).
__global__ void __launch_bounds__(kBucketThreads, 2)
hist_bucket_kernel(const unsigned short* __restrict__ sorted,
                   const unsigned short* __restrict__ start, int tiles,
                   int bucket_cells, long long cells,
                   float* __restrict__ hist) {
  extern __shared__ uint4 s_counts4[];
  __shared__ unsigned s_pref[kChunkTiles];
  __shared__ unsigned short s_first[kChunkTiles], s_end[kChunkTiles];
  __shared__ unsigned s_warp[kBucketThreads / 32];
  unsigned* s_counts = reinterpret_cast<unsigned*>(s_counts4);
  const int k = blockIdx.x;
  const long long c0 = static_cast<long long>(k) * bucket_cells;
  const int len = static_cast<int>(cells - c0 < bucket_cells ? cells - c0
                                                            : bucket_cells);
  for (int i = threadIdx.x; i < (len + 3) / 4; i += kBucketThreads) {
    s_counts4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  wait_for_primary();  // the sort's writes
  const size_t row0 = static_cast<size_t>(k) * tiles;
  const size_t row1 = row0 + tiles;
  for (int t0 = 0; t0 < tiles; t0 += kChunkTiles) {
    const int nt = min(kChunkTiles, tiles - t0);
    if (threadIdx.x < nt) {  // the 8-entry chunks that tile's run touches
      const unsigned s = start[row0 + t0 + threadIdx.x];
      const unsigned e = start[row1 + t0 + threadIdx.x];
      s_first[threadIdx.x] = s;
      s_end[threadIdx.x] = e;
      s_pref[threadIdx.x] = e > s ? (e + 7) / 8 - s / 8 : 0u;
    }
    __syncthreads();
    const unsigned total = block_exclusive_scan(s_pref, nt, s_warp);
    for (unsigned j0 = threadIdx.x; j0 < total;
         j0 += kQuad * kBucketThreads) {
      uint4 v[kQuad];
      int tile[kQuad];
      unsigned chunk[kQuad];
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {  // the loads of 4 chunks in flight
        const unsigned j = j0 + u * kBucketThreads;
        if (j < total) {
          int lo = 0, hi = nt - 1;  // the last tile whose chunks start <= j
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_pref[mid] <= j) lo = mid; else hi = mid - 1;
          }
          tile[u] = lo;
          chunk[u] = s_first[lo] / 8 + (j - s_pref[lo]);
          v[u] = reinterpret_cast<const uint4*>(
              sorted + static_cast<size_t>(t0 + lo) * kStageRows)[chunk[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {
        if (j0 + u * kBucketThreads < total) {
          const unsigned s = s_first[tile[u]], e = s_end[tile[u]];
          const unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int q = 0; q < 8; ++q) {  // the run's entries in the chunk
            const unsigned pos = chunk[u] * 8 + q;
            if (pos >= s && pos < e) {
              atomicAdd(s_counts + ((w[q / 2] >> (16 * (q % 2))) & 0xffffu),
                        1u);
            }
          }
        }
      }
    }
    __syncthreads();  // before the next chunk's table overwrites these
  }
  __syncthreads();  // every count is in (and, with no tiles, every zero)
  write_floats(s_counts4, len, hist + c0);
}

// Lets `kernel` take `bytes` of dynamic shared memory on `device` (above
// 48 KB a kernel must ask; once per kernel, device and size).
template <int kSlot>
cudaError_t allow_smem(const void* kernel, int device, long long bytes) {
  constexpr int kMaxDevices = 64;
  static long long allowed[kMaxDevices] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (device >= 0 && device < kMaxDevices && allowed[device] >= bytes) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    allowed[device] = bytes;
  }
  return err;
}

// The private kernel's launch: clusters of kCluster CTAs of kThreads,
// and with `cooperative` a cooperative launch, which the runtime starts
// only with every CTA of the grid resident (the grid barrier's premise).
// The occupancy query takes the cluster dimension alone.
cudaLaunchConfig_t private_config(long long smem, bool cooperative) {
  static cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kCluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attrs;
  cfg.numAttrs = cooperative ? 2 : 1;
  return cfg;
}

// The private kernel's CTAs that `device` holds at once (its grid barrier
// needs them all resident), with the most shared memory it may ask for;
// the kernel's attribute is set once per device.
cudaError_t private_resident(int device, int* resident) {
  constexpr int kMaxDevices = 64;
  static int known[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && known[device] > 0) {
    *resident = known[device];
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(hist_private_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxCells * 4);
  if (err != cudaSuccess) return err;
  const cudaLaunchConfig_t cfg = private_config(kMaxCells * 4, false);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(hist_private_kernel), &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  *resident = clusters * kCluster;
  if (device >= 0 && device < kMaxDevices) known[device] = *resident;
  return cudaSuccess;
}

}  // namespace

// Histogram of n flat rows on `stream` into `hist`, (G, nbins) float32
// row-major, every cell written. `a` and `inv_width` are the grid's lower
// end and nbins / (b - a), both float32. `scratch` holds at least the
// plan's scratch_bytes: in the private regime the per-(device, stream)
// counters, zero on entry (and left zero), in the bucketed regime any
// memory. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int repro_grouped_hist(const float* values, const int* gids,
                                  const float* mask, long long n,
                                  int num_groups, int nbins, float a,
                                  float inv_width, float* hist, void* scratch,
                                  long long scratch_bytes, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_groups < 1 || nbins < 1 || n < 0 ||
      static_cast<long long>(num_groups) * nbins >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long cells = static_cast<long long>(num_groups) * nbins;
  int resident = 0;
  if (cells <= kMaxCells) {
    err = private_resident(device, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const GroupedHistPlan p = grouped_hist_plan(n, num_groups, nbins,
                                              resident);
  if (scratch_bytes < p.scratch_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto addr = [](const void* q) {
    return reinterpret_cast<unsigned long long>(q);
  };
  const Rows in{values, gids, mask, n,
                ((addr(values) | addr(gids) | addr(mask)) & 15) == 0,
                num_groups, nbins, a, inv_width};
  if (p.regime == kPrivate) {
    cudaLaunchConfig_t cfg = private_config(p.count_smem, true);
    cfg.gridDim = dim3(static_cast<unsigned>(p.count_ctas));
    cfg.stream = s;
    err = cudaLaunchKernelEx(&cfg, hist_private_kernel, in,
                             static_cast<int>(cells),
                             static_cast<unsigned*>(scratch), hist);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = static_cast<int>(p.sort_ctas);
  const int buckets = static_cast<int>(p.count_ctas);
  unsigned short* sorted = static_cast<unsigned short*>(scratch);
  unsigned short* start = sorted + static_cast<size_t>(tiles) * kStageRows;
  if (tiles > 0) {
    err = allow_smem<1>(reinterpret_cast<const void*>(hist_sort_kernel),
                        device, p.sort_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    hist_sort_kernel<<<static_cast<unsigned>(tiles), kThreads,
                       static_cast<size_t>(p.sort_smem), s>>>(
        in, static_cast<unsigned>(p.bucket_cells), buckets, tiles, sorted,
        start);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = allow_smem<2>(reinterpret_cast<const void*>(hist_bucket_kernel),
                      device, p.count_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(buckets));
  cfg.blockDim = dim3(kBucketThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.count_smem);
  cfg.stream = s;
  cfg.attrs = tiles > 0 ? pdl : nullptr;
  cfg.numAttrs = tiles > 0 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, hist_bucket_kernel,
                           static_cast<const unsigned short*>(sorted),
                           static_cast<const unsigned short*>(start), tiles,
                           static_cast<int>(p.bucket_cells), cells, hist);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The plan of a call of n rows, G groups and nbins bins on a card that
// holds `resident` private CTAs at once, for tests: out = {regime (0
// private, 1 bucketed), launches, count_ctas, count_smem, sort_ctas,
// sort_smem, bucket_cells, scratch_bytes}.
extern "C" void repro_grouped_hist_plan(long long n, int num_groups,
                                        int nbins, int resident,
                                        long long* out) {
  const GroupedHistPlan p = grouped_hist_plan(n, num_groups, nbins,
                                              resident);
  const long long v[8] = {p.regime,    p.launches,  p.count_ctas,
                          p.count_smem, p.sort_ctas, p.sort_smem,
                          p.bucket_cells, p.scratch_bytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// The private kernel's CTAs that `device` holds at once (clusters of
// kCluster, one CTA an SM), or minus a CUDA error code.
extern "C" int repro_grouped_hist_resident(int device) {
  cudaError_t err = cudaSetDevice(device);
  int resident = 0;
  if (err == cudaSuccess) err = private_resident(device, &resident);
  return err == cudaSuccess ? resident : -static_cast<int>(err);
}
