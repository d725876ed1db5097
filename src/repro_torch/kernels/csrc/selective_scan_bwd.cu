// selective_scan_bwd: the Mamba1 selective-scan backward, for Hopper.
//
// Replaces the TPU kernel `_backward` (src/repro/kernels/selective_scan.py,
// body `_bwd_kernel`). Given the forward's inputs, the state at the start
// of every time chunk of `tc` steps (`hseg`, written by selective_scan.cu)
// and the cotangents ybar (of y) and houtbar (of the final state), it
// walks the chunks last first; in each it recomputes the chunk's states
// from hseg[:, k] and runs the reverse accumulation, per batch row and
// channel i, for t from the chunk's end down to its start:
//
//   hbar   += ybar_t[i] C_t                 dC_t += ybar_t[i] h_t[i, :]
//   g       = hbar * h_{t-1}[i, :] * exp(dt_t[i] A[i, :])
//   dA[i]  += g dt_t[i]                      dD[i] += ybar_t[i] x_t[i]
//   s       = sum_n hbar[n] B_t[n]           dB_t += hbar (dt_t[i] x_t[i])
//   ddt_t[i] = sum_n g[n] A[i, n] + s x_t[i]
//   dx_t[i]  = ybar_t[i] D[i] + s dt_t[i]
//   hbar   *= exp(dt_t[i] A[i, :])
//
// and emits dh0 = hbar after chunk 0. dB and dC sum over every channel;
// dA and dD over every batch row and step.
//
// What bounds it on an H100: not bytes. At the training shape (B 2, L
// 4096, d_inner 8192, n 16) the inputs and outputs are ~1.4 GB, ~0.4 ms
// at 3.35 TB/s, against ~1.07 G state-steps of three accurate
// exponentials (a first pass for checkpoints, the recompute, the reverse
// step) and ~55 other instructions each: instruction issue. The design
// keeps every SM's issue slots busy and the recomputed states on chip:
//   - two states a lane: a channel's n states sit on n / 2 consecutive
//     lanes (four channels a warp at n 16, eight at n 8), and a lane's two
//     independent state chains share its loads and shuffles. A CTA holds
//     64 channels (512 threads at n 16, 256 at n 8): at n 16 one CTA
//     fills an SM's registers, and a (2, 8192)-channel call is 256 CTAs,
//     two full waves on 132 SMs (CTAs of 32 channels, two an SM, would
//     take three: GPC boundaries leave room for 62 clusters of four, 248
//     CTAs, of the 512). The two sums over n a step (s
//     and ddt's sum of g A) share one xor-shuffle tree: half the lanes
//     sum one, half the other. dA accumulates in each state's own lane,
//     dD in the channel's first lane;
//   - a sub-chunk of kSub steps of x, dt, ybar (one float4 a step and
//     channel) and B, C (one float2 a step and state) is staged in shared
//     memory, the next one loaded into registers while the current one is
//     walked; dx and ddt are made from the step's two sums and leave as
//     whole lines;
//   - the history in shared memory and registers, by sub-chunk: a first
//     pass over the chunk from hseg (its inputs through a cp.async ring)
//     keeps the state every kSub steps (tc / kSub checkpoints a lane in
//     shared memory); then, for each sub-chunk, last first, the lane
//     recomputes its kSub states into registers and walks them back, one
//     basic block with no per-step branch. No global history scratch;
//   - dB_t and dC_t sum over channels with no float atomics: a warp adds
//     its channels with shuffles, the CTA adds its warps in warp order, and
//     the CTAs of a thread-block cluster (128 channels) add their partials
//     through distributed shared memory in rank order, one slice of the
//     entries per CTA, a sub-chunk behind: the cluster barrier is split
//     (arrive when a partial is written, wait just before reading the
//     others'), so its latency hides behind the next walk. A second
//     kernel adds the clusters' partials in cluster order, so the partials
//     stay (B, L, din / 128, 2n). dA and dD are written per (batch row,
//     chunk), as the reference writes them, and summed in that order by a
//     third pass.
// Every sum has a fixed order, so the bits are the same on every run. The
// recompute rounds every product and sum on its own (__fmul_rn, __fadd_rn,
// built with --fmad=false) and uses the accurate expf, exactly as
// selective_scan.cu does, so the recomputed states are the forward's own
// bits and dh0 is the plain version's; the other outputs differ from the
// plain version only in the order of the sums over n and over channels,
// batch rows and chunks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kStates = 2;          // states a lane carries
constexpr int kSub = 16;            // steps a sub-chunk
constexpr int kClusterChannels = 128;  // channels a cluster sums dB/dC over
constexpr int kMaxCheckpoints = 32;    // tc <= kSub * 32

// Shared memory of one CTA, in floats: two stage buffers (x, dt, ybar of
// the CTA's channels and B, C, for kSub steps), the step sums dx / ddt
// are made from, the warps' and the CTA's dB / dC partials, the
// checkpoints.
template <int N>
struct Layout {
  // one CTA an SM at n 16 (16 warps, 64 channels, clusters of two): the
  // grid of a (2, d_inner 8192) call is two full waves of 128 CTAs
  static constexpr int kThreads = N == 16 ? 512 : 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kLanes = N / kStates;           // lanes a channel
  static constexpr int kCh = kThreads / kLanes;        // channels a CTA
  static constexpr int kCluster = kClusterChannels / kCh;
  static_assert(kThreads % kCh == 0, "a thread writes one channel");
  // a stage: (x, dt, ybar, 0) of each (step, channel) as one float4 and
  // (B, C) of each (step, state) as one float2, so a step's inputs are two
  // shared-memory loads (a lane's two states' (B, C) are one float4)
  static constexpr int kStage = kSub * (4 * kCh + 2 * N);
  static constexpr int kOut = 2 * kSub * kCh;
  static constexpr int kRed = kSub * kWarps * 2 * N;
  static constexpr int kPart = kSub * 2 * N;
  static constexpr int kFixed = 2 * kStage + kOut + kRed + 2 * kPart;
  // pass 1 reads x, dt and B through a ring of kRing sub-chunks, in the
  // space the stages, outputs and warps' partials take in pass 2
  static constexpr int kRing = 4;
  static constexpr int kP1 = kSub * (2 * kCh + N);
  static_assert(kRing * kP1 <= 2 * kStage + kOut + kRed, "the ring fits");
  static int floats(int n_ckpt) {
    return kFixed + n_ckpt * kThreads * kStates;
  }
  // a thread's share of one stage: per channel array, per state array
  static constexpr int kPerCh = (kSub * kCh + kThreads - 1) / kThreads;
  static constexpr int kPerSt = (kSub * N + kThreads - 1) / kThreads;
};

// One thread's share of a sub-chunk's inputs, loaded ahead into registers
// and stored into a stage buffer later: x, dt, ybar of channels
// [ch0, ch0 + kCh) (zeros past din) and B, C, for steps [t0, t0 + len).
template <int N>
struct Prefetch {
  float x[Layout<N>::kPerCh], dt[Layout<N>::kPerCh], yb[Layout<N>::kPerCh];
  float b[Layout<N>::kPerSt], c[Layout<N>::kPerSt];

  __device__ __forceinline__ void load(
      const float* __restrict__ xs, const float* __restrict__ dts,
      const float* __restrict__ ybar, const float* __restrict__ bs,
      const float* __restrict__ cs, long long row0, int din, int ch0, int t0,
      int len) {
    using Lay = Layout<N>;
#pragma unroll
    for (int u = 0; u < Lay::kPerCh; ++u) {
      const int i = threadIdx.x + u * Layout<N>::kThreads;
      const int s = i / Lay::kCh, cl = i % Lay::kCh;
      const bool on = s < len && ch0 + cl < din;
      const long long off = (row0 + t0 + s) * din + ch0 + cl;
      x[u] = on ? xs[off] : 0.f;
      dt[u] = on ? dts[off] : 0.f;
      yb[u] = on ? ybar[off] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < Lay::kPerSt; ++u) {
      const int i = threadIdx.x + u * Layout<N>::kThreads;
      const bool on = i < len * N;
      const long long off = (row0 + t0) * N + i;
      b[u] = on ? bs[off] : 0.f;
      c[u] = on ? cs[off] : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ stage) const {
    using Lay = Layout<N>;
    float4* sxdy = reinterpret_cast<float4*>(stage);
    float2* sbc = reinterpret_cast<float2*>(stage + 4 * kSub * Lay::kCh);
#pragma unroll
    for (int u = 0; u < Lay::kPerCh; ++u) {
      const int i = threadIdx.x + u * Layout<N>::kThreads;
      if (i < kSub * Lay::kCh) sxdy[i] = make_float4(x[u], dt[u], yb[u], 0.f);
    }
#pragma unroll
    for (int u = 0; u < Lay::kPerSt; ++u) {
      const int i = threadIdx.x + u * Layout<N>::kThreads;
      if (i < kSub * N) sbc[i] = make_float2(b[u], c[u]);
    }
  }
};

// One step of the forward recurrence, the forward kernel's operations.
__device__ __forceinline__ float step_state(float h, float xv, float dtv,
                                            float av, float bv) {
  const float decay = expf(__fmul_rn(dtv, av));
  return __fadd_rn(__fmul_rn(decay, h), __fmul_rn(__fmul_rn(dtv, xv), bv));
}

// 4 bytes from global into shared memory, asynchronously (zeros if !on;
// `src` must point into the tensor either way).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(on ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The cluster barrier in two halves (PTX barrier.cluster): a CTA arrives
// when its partial is written and waits only when it is about to read the
// others', so the barrier's latency hides behind a sub-chunk's walk.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Grid (clusters * kCluster, batch), clusters of kCluster CTAs along x;
// CTA `blockIdx.x` holds channels [blockIdx.x * kCh, + kCh); thread
// threadIdx.x carries states 2 sl and 2 sl + 1 (sl = threadIdx.x % kLanes)
// of channel threadIdx.x / kLanes.
template <int N>
__global__ void __launch_bounds__(Layout<N>::kThreads, 1)
selective_scan_bwd_chunks(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ a, const float* __restrict__ d,
    const float* __restrict__ hseg, const float* __restrict__ ybar,
    const float* __restrict__ houtbar, int L, int din, int tc,
    float* __restrict__ bc_part, float* __restrict__ da_part,
    float* __restrict__ dd_part, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dh0) {
  using Lay = Layout<N>;
  constexpr int kThreads = Lay::kThreads;
  constexpr int kWarps = Lay::kWarps;
  constexpr int kLanes = Lay::kLanes;
  constexpr int kCh = Lay::kCh;
  constexpr int kCluster = Lay::kCluster;
  constexpr int V = 2 * N;                       // a step's dB and dC terms
  extern __shared__ float smem[];
  float* sstage = smem;                          // two buffers of kStage
  float* sdtx = sstage + 2 * Lay::kStage;        // sum_n hb of (step, channel)
  float* sga = sdtx + kSub * kCh;                // sum_n g A
  float* sred = sga + kSub * kCh;
  float* spart = sred + Lay::kRed;               // two buffers of kPart
  float2* sckpt = reinterpret_cast<float2*>(spart + 2 * Lay::kPart);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / kCluster;
  const int cl_id = blockIdx.x / kCluster;
  const int batch = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sl = threadIdx.x % kLanes;           // states 2 sl, 2 sl + 1
  const int cl = threadIdx.x / kLanes;           // the channel in the CTA
  const bool upper = sl >= kLanes / 2;           // the lanes that sum ga
  const int ch0 = blockIdx.x * kCh;
  const int ch = ch0 + cl;
  const bool live = ch < din;
  const long long row0 = static_cast<long long>(batch) * L;
  const long long state =
      (static_cast<long long>(batch) * din + ch) * N + kStates * sl;
  const int n_chunks = L / tc;
  const int n_sub = (tc + kSub - 1) / kSub;

  // dead lanes (ch >= din) run the math on zeros: their terms add nothing
  // to the sums over channels, and they store nothing
  const float2 av =
      live ? *reinterpret_cast<const float2*>(
                 a + static_cast<long long>(ch) * N + kStates * sl)
           : make_float2(0.f, 0.f);
  // the channel this thread writes dx / ddt of (kCh divides kThreads)
  const int out_ch = ch0 + threadIdx.x % kCh;
  const bool out_live = out_ch < din;
  const float out_d = out_live ? d[out_ch] : 0.f;
  float2 hbar = live ? *reinterpret_cast<const float2*>(houtbar + state)
                     : make_float2(0.f, 0.f);
  int pbuf = 0;   // partial buffer
  int sbuf = 0;   // stage buffer
  Prefetch<N> pf;
  // the last sub-chunk whose CTA partials await the cluster's sum (in
  // spart[pbuf ^ 1]): each CTA adds one slice of the entries, the CTAs'
  // partials in rank order, and writes it to bc_part
  int pending_t0 = 0, pending_len = 0;
  auto reduce_pending = [&]() {
    const float* theirs = spart + (pbuf ^ 1) * Lay::kPart;
    const int per = (pending_len * V + kCluster - 1) / kCluster;
    const int e_lo = rank * per;
    const int e_hi = min(pending_len * V, e_lo + per);
    for (int i = e_lo + threadIdx.x; i < e_hi; i += kThreads) {
      float r[kCluster];  // every rank's value in flight at once
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        r[q] = cluster.map_shared_rank(theirs, q)[i];
      }
      float acc = r[0];
#pragma unroll
      for (int q = 1; q < kCluster; ++q) acc = __fadd_rn(acc, r[q]);
      const int s = i / V, e = i % V;
      bc_part[((row0 + pending_t0 + s) * n_clusters + cl_id) * V + e] = acc;
    }
  };

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t_lo = k * tc;
    const long long part = static_cast<long long>(batch) * n_chunks + k;

    // ---- 1. checkpoints every kSub steps, the forward's bits -----------
    // x, dt and B arrive through a ring of kRing sub-chunks, kRing - 1 of
    // them in flight (cp.async) while one is walked
    float2 h = live ? *reinterpret_cast<const float2*>(
                          hseg + (part * din + ch) * N + kStates * sl)
                    : make_float2(0.f, 0.f);
    auto issue = [&](int jj) {  // sub-chunk jj into ring[jj % kRing]
      if (jj < n_sub) {
        float* buf = smem + (jj % Lay::kRing) * Lay::kP1;
        const int t0 = t_lo + jj * kSub, len = min(kSub, tc - jj * kSub);
        for (int i = threadIdx.x; i < kSub * kCh; i += kThreads) {
          const int s = i / kCh, c2 = i % kCh;
          const bool on = s < len && ch0 + c2 < din;
          const long long off = on ? (row0 + t0 + s) * din + ch0 + c2 : 0;
          cp_async4(buf + 2 * i, x + off, on);  // (x, dt) pairs
          cp_async4(buf + 2 * i + 1, dt + off, on);
        }
        for (int i = threadIdx.x; i < kSub * N; i += kThreads) {
          const bool on = i < len * N;
          cp_async4(buf + 2 * kSub * kCh + i, b + (on ? (row0 + t0) * N + i
                                                      : 0), on);
        }
      }
      cp_async_commit();  // one group a sub-chunk, empty past the end
    };
    __syncthreads();  // the last sub-chunk's readers of the area are done
#pragma unroll
    for (int jj = 0; jj < Lay::kRing - 1; ++jj) issue(jj);
    for (int j = 0; j < n_sub; ++j) {
      const int len = min(kSub, tc - j * kSub);
      sckpt[j * kThreads + threadIdx.x] = h;
      cp_async_wait<Lay::kRing - 2>();  // this thread's copies of j landed
      __syncthreads();                  // everyone's; ring[j - 1] is free
      issue(j + Lay::kRing - 1);
      if (j == n_sub - 1) {  // the reverse walk starts with this sub-chunk
        pf.load(x, dt, ybar, b, c, row0, din, ch0, t_lo + j * kSub, len);
      }
      const float* ring = smem + (j % Lay::kRing) * Lay::kP1;
      const float2* sxd = reinterpret_cast<const float2*>(ring);
      const float2* sb = reinterpret_cast<const float2*>(ring + 2 * kSub * kCh);
      auto step = [&](int s) {
        const float2 v = sxd[s * kCh + cl];
        const float2 bb = sb[(s * N) / 2 + sl];
        h.x = step_state(h.x, v.x, v.y, av.x, bb.x);
        h.y = step_state(h.y, v.x, v.y, av.y, bb.y);
      };
      if (len == kSub) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) step(s);
      } else {
        for (int s = 0; s < len; ++s) step(s);
      }
    }
    __syncthreads();  // the ring's readers are done before pass 2 stages

    // ---- 2. sub-chunks last first: recompute, then the reverse walk ----
    float2 da = make_float2(0.f, 0.f);
    float dd = 0.f;
    for (int j = n_sub - 1; j >= 0; --j) {
      const int t0 = t_lo + j * kSub;
      const int len = min(kSub, tc - j * kSub);
      float* stg = sstage + sbuf * Lay::kStage;
      pf.store(stg);
      __syncthreads();  // the stage is written; sdtx / sga / sred are free
      if (j > 0) {
        pf.load(x, dt, ybar, b, c, row0, din, ch0, t0 - kSub, kSub);
      }
      const float4* sxdy = reinterpret_cast<const float4*>(stg);
      // (B, C) of states 2 sl and 2 sl + 1 at step s: sbc[s * N / 2 + sl]
      const float4* sbc =
          reinterpret_cast<const float4*>(stg + 4 * kSub * kCh);
      const float2 h_in = sckpt[j * kThreads + threadIdx.x];
      // the sub-chunk's steps, recomputed then walked back: one basic
      // block for a full sub-chunk (no per-step branch), so the scheduler
      // overlaps one step's shuffles with the next step's arithmetic
      auto walk = [&](auto full) {
        constexpr bool kFull = decltype(full)::value;
        float h0[kSub], h1[kSub];
        float2 hh = h_in;
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          if (kFull || s < len) {
            const float4 v = sxdy[s * kCh + cl];
            const float4 w = sbc[(s * N) / 2 + sl];
            hh.x = step_state(hh.x, v.x, v.y, av.x, w.x);
            hh.y = step_state(hh.y, v.x, v.y, av.y, w.z);
          }
          h0[s] = hh.x;
          h1[s] = hh.y;
        }
#pragma unroll
        for (int s = kSub - 1; s >= 0; --s) {
          if (!kFull && s >= len) continue;
          const float4 in = sxdy[s * kCh + cl];
          const float4 w = sbc[(s * N) / 2 + sl];  // B0, C0, B1, C1
          const float xv = in.x, dtv = in.y, yb = in.z;
          const float dtx = __fmul_rn(dtv, xv);
          const float p0 = s > 0 ? h0[s - 1] : h_in.x;
          const float p1 = s > 0 ? h1[s - 1] : h_in.y;
          float db0, db1, dc0, dc1, hb, ga;
          {  // state 2 sl
            dc0 = __fmul_rn(yb, h0[s]);
            hbar.x = __fadd_rn(hbar.x, __fmul_rn(yb, w.y));
            const float decay = expf(__fmul_rn(dtv, av.x));
            const float g = __fmul_rn(__fmul_rn(hbar.x, p0), decay);
            hb = __fmul_rn(hbar.x, w.x);
            db0 = __fmul_rn(hbar.x, dtx);
            da.x = __fadd_rn(da.x, __fmul_rn(g, dtv));
            ga = __fmul_rn(g, av.x);
            hbar.x = __fmul_rn(hbar.x, decay);
          }
          {  // state 2 sl + 1
            dc1 = __fmul_rn(yb, h1[s]);
            hbar.y = __fadd_rn(hbar.y, __fmul_rn(yb, w.w));
            const float decay = expf(__fmul_rn(dtv, av.y));
            const float g = __fmul_rn(__fmul_rn(hbar.y, p1), decay);
            hb = __fadd_rn(hb, __fmul_rn(hbar.y, w.z));
            db1 = __fmul_rn(hbar.y, dtx);
            da.y = __fadd_rn(da.y, __fmul_rn(g, dtv));
            ga = __fadd_rn(ga, __fmul_rn(g, av.y));
            hbar.y = __fmul_rn(hbar.y, decay);
          }
          // sum_n hb and sum_n ga over the channel's lanes at once: the
          // lower half of the lanes sums hb, the upper half ga
          float r = __fadd_rn(upper ? ga : hb,
                              __shfl_xor_sync(0xffffffffu, upper ? hb : ga,
                                              kLanes / 2));
#pragma unroll
          for (int o = kLanes / 4; o >= 1; o >>= 1) {
            r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, o));
          }
          // the channel's first lane holds sum_n hb, its middle lane sum_n
          // g A; dx and ddt are made from them on the way out
          if (sl == 0) sdtx[s * kCh + cl] = r;
          if (sl == kLanes / 2) sga[s * kCh + cl] = r;
          dd = __fadd_rn(dd, __fmul_rn(yb, xv));
          // the warp's channels, same states: lanes < 16 sum dB, the
          // others dC, over lanes l ^ 16, l ^ 8, ... down to l ^ kLanes
          const bool hi = lane >= 16;
          float v0 = __fadd_rn(hi ? dc0 : db0,
                               __shfl_xor_sync(0xffffffffu, hi ? db0 : dc0,
                                               16));
          float v1 = __fadd_rn(hi ? dc1 : db1,
                               __shfl_xor_sync(0xffffffffu, hi ? db1 : dc1,
                                               16));
#pragma unroll
          for (int o = 8; o >= kLanes; o >>= 1) {
            v0 = __fadd_rn(v0, __shfl_xor_sync(0xffffffffu, v0, o));
            v1 = __fadd_rn(v1, __shfl_xor_sync(0xffffffffu, v1, o));
          }
          if ((lane & 15) < kLanes) {
            *reinterpret_cast<float2*>(
                &sred[(s * kWarps + warp) * V + (hi ? N : 0) +
                      kStates * (lane & 15)]) = make_float2(v0, v1);
          }
        }
      };
      if (len == kSub) {
        walk(std::true_type{});
      } else {
        walk(std::false_type{});
      }
      __syncthreads();
      if (pending_len > 0) {  // the sub-chunk before's, now every CTA's
        cluster_wait();
        reduce_pending();
      }
      // the CTA's partial of each step: its warps in order
      float* mine = spart + pbuf * Lay::kPart;
      for (int i = threadIdx.x; i < len * V; i += kThreads) {
        const int s = i / V, e = i % V;
        float r[kWarps];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) r[w] = sred[(s * kWarps + w) * V + e];
        float acc = r[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc = __fadd_rn(acc, r[w]);
        mine[i] = acc;
      }
      // dx and ddt of the sub-chunk, line by line: with s = sum_n hb,
      // dx = ybar D + s dt and ddt = sum_n g A + s x
      for (int i = threadIdx.x; i < len * kCh; i += kThreads) {
        const int s = i / kCh;
        if (out_live) {
          const float4 in = sxdy[i];
          const float r = sdtx[i];
          const long long off = (row0 + t0 + s) * din + out_ch;
          dx[off] = __fadd_rn(__fmul_rn(in.z, out_d), __fmul_rn(r, in.y));
          ddt[off] = __fadd_rn(sga[i], __fmul_rn(r, in.x));
        }
      }
      cluster_arrive();  // this partial is written; the reads of the
                         // one before are done
      pending_t0 = t0;
      pending_len = len;
      pbuf ^= 1;  // the next sub-chunk writes the other buffer
      sbuf ^= 1;
    }
    if (live) {
      *reinterpret_cast<float2*>(da_part + (part * din + ch) * N +
                                 kStates * sl) = da;
      if (sl == 0) dd_part[part * din + ch] = dd;
    }
  }
  if (live) *reinterpret_cast<float2*>(dh0 + state) = hbar;
  cluster_wait();
  reduce_pending();
  cluster_arrive();  // no CTA leaves while another reads its partials
  cluster_wait();
}

// dB and dC of each (batch row, step): the clusters' partials in order.
template <int N>
__global__ void selective_scan_bwd_sum_bc(const float* __restrict__ bc_part,
                                          long long rows, int nblk,
                                          float* __restrict__ db,
                                          float* __restrict__ dc) {
  constexpr int V = 2 * N;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= rows * V) return;
  const long long row = i / V;
  const int j = static_cast<int>(i % V);
  const float* p = bc_part + row * nblk * V + j;
  float acc = p[0];
  for (int k = 1; k < nblk; ++k)
    acc = __fadd_rn(acc, p[static_cast<long long>(k) * V]);
  if (j < N)
    db[row * N + j] = acc;
  else
    dc[row * N + j - N] = acc;
}

// out[i] = sum over p of part[p, i], p in order (dA and dD over batch rows
// and chunks).
__global__ void selective_scan_bwd_sum_parts(const float* __restrict__ part,
                                             int parts, long long width,
                                             float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= width) return;
  float acc = part[i];
  for (int p = 1; p < parts; ++p)
    acc = __fadd_rn(acc, part[static_cast<long long>(p) * width + i]);
  out[i] = acc;
}

unsigned int blocks_for(long long items, int threads) {
  return static_cast<unsigned int>((items + threads - 1) / threads);
}

template <int N>
int launch(const float* x, const float* dt, const float* b, const float* c,
           const float* a, const float* d, const float* hseg,
           const float* ybar, const float* houtbar, int batch, int L,
           int din, int tc, int nblk, float* bc_part, float* da_part,
           float* dd_part, float* dx, float* ddt, float* db, float* dc,
           float* da, float* dd, float* dh0, cudaStream_t s) {
  using Lay = Layout<N>;
  const int n_ckpt = (tc + kSub - 1) / kSub;
  const size_t smem = static_cast<size_t>(Lay::floats(n_ckpt)) *
                      sizeof(float);
  auto kernel = selective_scan_bwd_chunks<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(nblk * Lay::kCluster),
                     static_cast<unsigned>(batch));
  cfg.blockDim = dim3(Lay::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Lay::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, dt, b, c, a, d, hseg, ybar,
                           houtbar, L, din, tc, bc_part, da_part, dd_part,
                           dx, ddt, dh0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(batch) * L;
  selective_scan_bwd_sum_bc<N><<<blocks_for(rows * 2 * N, 256), 256, 0, s>>>(
      bc_part, rows, nblk, db, dc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int parts = batch * (L / tc);
  const long long wa = static_cast<long long>(din) * N;
  selective_scan_bwd_sum_parts<<<blocks_for(wa, 256), 256, 0, s>>>(
      da_part, parts, wa, da);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  selective_scan_bwd_sum_parts<<<blocks_for(din, 256), 256, 0, s>>>(
      dd_part, parts, din, dd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the backward on `stream`. x, dt, ybar, dx, ddt are (batch, L, din);
// b, c, db, dc are (batch, L, n); a, da are (din, n); d, dd are (din,);
// houtbar, dh0 are (batch, din, n); hseg is (batch, L / tc, din, n); the
// scratch is bc_part (batch, L, nblk, 2n), da_part (batch, L / tc, din, n)
// and dd_part (batch, L / tc, din), with nblk = ceil(din / 128); all
// float32, contiguous. n must be 8 or 16, tc must divide L and be at most
// 512, batch must be at most 65535. Returns the first CUDA error of its
// launches (0 on success).
extern "C" int repro_selective_scan_bwd(
    const float* x, const float* dt, const float* b, const float* c,
    const float* a, const float* d, const float* hseg, const float* ybar,
    const float* houtbar, int batch, int L, int din, int n, int tc,
    int nblk, float* bc_part, float* da_part, float* dd_part, float* dx,
    float* ddt, float* db, float* dc, float* da, float* dd, float* dh0,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || L <= 0 || din <= 0 || tc <= 0 || L % tc != 0 ||
      tc > kSub * kMaxCheckpoints || batch > 65535 ||
      nblk != (din + kClusterChannels - 1) / kClusterChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8:
      return launch<8>(x, dt, b, c, a, d, hseg, ybar, houtbar, batch, L, din,
                       tc, nblk, bc_part, da_part, dd_part, dx, ddt, db, dc,
                       da, dd, dh0, s);
    case 16:
      return launch<16>(x, dt, b, c, a, d, hseg, ybar, houtbar, batch, L,
                        din, tc, nblk, bc_part, da_part, dd_part, dx, ddt,
                        db, dc, da, dd, dh0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
