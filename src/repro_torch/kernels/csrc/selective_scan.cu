// selective_scan: the Mamba1 selective-scan forward, for Hopper.
//
// Replaces the TPU kernel `_forward` (src/repro/kernels/selective_scan.py,
// body `_kernel`): per batch row and channel i, over time t,
//
//   h_t[i, :] = exp(dt_t[i] * A[i, :]) * h_{t-1}[i, :] + (dt_t[i] x_t[i]) B_t
//   y_t[i]    = sum_n h_t[i, n] C_t[n] + D[i] x_t[i]
//
// and the state at the start of every time chunk of `tc` steps (`hseg`,
// what the backward kernel recomputes each chunk from) plus the final
// state (`hout`).
//
// What bounds it on an H100: instruction issue, not bytes. A (B 2, L
// 4096, d_inner 8192, n 16) call moves 0.82 GB (~0.25 ms at 3.35 TB/s),
// but each of its 1.07 G state-steps takes the accurate expf (8
// instructions, one MUFU.EX2) and ~8 more: the scan loop below compiles
// to ~15.7 instructions a state-step, ~0.5 ms of full issue on 132 SMs x
// 4 schedulers at 1.98 GHz (scripts/scan_issue_floor.py counts them).
// The design keeps every scheduler fed and nothing global on the
// recurrence's path:
//   - four states a lane: a channel's n states sit on n / 4 consecutive
//     lanes (8 channels a warp at n 16, 16 at n 8), so a call has n / 4
//     times the threads of one thread a channel. A CTA is 256 threads (64
//     channels at n 16, 128 at n 8), two an SM (72 / 100 KB of shared
//     memory): a (2, 8192)-channel call at n 16 is 256 CTAs, one wave on
//     132 SMs (16 warps an SM), a (8, 8192) one four. Two states a lane
//     (more threads, but more loads, products and partials a state) ran
//     ~30 % slower;
//   - the inputs arrive through a double-buffered cp.async ring: the
//     CTA's x and dt for kSeg steps (16-byte copies of whole rows of its
//     channels) and B, C for the same steps are copied into shared memory
//     while the segment before is scanned. Lanes read x and dt of their
//     channel and B, C of their states from shared memory, as broadcasts;
//   - y leaves through shared memory: each lane sums h C over its own
//     four states (state order) into one partial a step; after the
//     segment the CTA adds each (step, channel)'s n / 4 partials in lane
//     order, adds D x, and writes whole rows of y, 128-byte lines (no
//     shuffles on the step's path);
//   - the state at each chunk start (hseg) and the final state (hout)
//     leave as one 16-byte store a lane, a warp's stores 512 contiguous
//     bytes.
// The sums have a fixed order, so the bits are the same on every run.
// Every product and sum of the state update rounds on its own (__fmul_rn,
// __fadd_rn: never contracted to a multiply-add) and the exponential is
// the accurate expf, as in the plain version's torch.exp, so hseg and
// hout are the plain version's bits (and what the backward recomputes);
// y differs from it only in the order of the sum over n.

#include <cuda_runtime.h>

namespace {

constexpr int kStates = 4;    // states a lane carries (2 ran slower)
constexpr int kThreads = 256; // threads a CTA
constexpr int kMinCtas = 2;   // CTAs an SM (the launch bounds' promise)
constexpr int kSeg = 32;      // time steps a stage holds

template <int N>
struct Layout {
  static constexpr int kLanes = N / kStates;       // lanes a channel
  static constexpr int kCh = kThreads / kLanes;    // channels a CTA
  // a stage: x and dt of (kSeg, kCh), then B and C of (kSeg, N)
  static constexpr int kStage = kSeg * (2 * kCh + 2 * N);
  // two stages, then the (kSeg, kThreads) lane partials of y
  static constexpr int kFloats = 2 * kStage + kSeg * kThreads;
  static constexpr size_t kBytes = kFloats * sizeof(float);
  static_assert(N % kStates == 0 && kThreads % kCh == 0, "lanes tile");
  static_assert(kCh % 4 == 0 && N % 4 == 0, "rows copy as 16 bytes");
};

// A segment of the time axis: chunk k, steps [off, off + kSeg) of it
// (fewer at the chunk's end). Segments never cross a chunk boundary.
struct Seg {
  int k, off;
};

__device__ __forceinline__ Seg next_seg(Seg g, int tc) {
  g.off += kSeg;
  if (g.off >= tc) {
    g.off = 0;
    ++g.k;
  }
  return g;
}

// Copies of 16 or 4 bytes from global into shared memory, asynchronously
// (zeros if !on; `src` must point into the tensor either way).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool on) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool on) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(on ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// A lane's kStates consecutive floats, as one vector.
__device__ __forceinline__ void load_states(float (&v)[kStates],
                                            const float* p) {
  if constexpr (kStates == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}
__device__ __forceinline__ void store_states(float* p,
                                             const float (&v)[kStates]) {
  if constexpr (kStates == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// p[0] + p[1] + ... + p[K - 1], left to right (p 8-byte aligned; 16-byte
// when K is a multiple of 4).
template <int K>
__device__ __forceinline__ float sum_in_order(const float* p) {
  float r[K];
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      r[q] = v.x; r[q + 1] = v.y; r[q + 2] = v.z; r[q + 3] = v.w;
    }
  } else {
    static_assert(K == 2, "two or a multiple of four lanes a channel");
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  }
  float acc = r[0];
#pragma unroll
  for (int q = 1; q < K; ++q) acc = __fadd_rn(acc, r[q]);
  return acc;
}

// Grid (ceil(din / kCh), batch). CTA blockIdx.x holds channels
// [blockIdx.x * kCh, + kCh); thread threadIdx.x carries states
// [kStates sl, kStates sl + kStates) (sl = threadIdx.x % kLanes) of
// channel threadIdx.x / kLanes. `vec`: x, dt, b, c are 16-byte aligned
// and din % 4 == 0, so rows copy as 16 bytes.
template <int N>
__global__ void __launch_bounds__(kThreads, kMinCtas)
selective_scan_fwd(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ b, const float* __restrict__ c,
                   const float* __restrict__ a, const float* __restrict__ d,
                   const float* __restrict__ h0, int L, int din, int tc,
                   int vec, float* __restrict__ y, float* __restrict__ hout,
                   float* __restrict__ hseg) {
  using Lay = Layout<N>;
  constexpr int kLanes = Lay::kLanes;
  constexpr int kCh = Lay::kCh;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const sp = smem + 2 * Lay::kStage;  // (kSeg, kThreads) partials

  const int batch = blockIdx.y;
  const int sl = threadIdx.x % kLanes;
  const int cl = threadIdx.x / kLanes;
  const int ch0 = blockIdx.x * kCh;
  const int ch = ch0 + cl;
  const bool live = ch < din;
  const long long row0 = static_cast<long long>(batch) * L;
  const long long state =
      (static_cast<long long>(batch) * din + ch) * N + kStates * sl;
  const int n_chunks = L / tc;

  // dead lanes (ch >= din) scan zeros and store nothing
  float h[kStates], av[kStates];
#pragma unroll
  for (int q = 0; q < kStates; ++q) {
    h[q] = live ? h0[state + q] : 0.f;
    av[q] = live ? a[static_cast<long long>(ch) * N + kStates * sl + q]
                 : 0.f;
  }
  // the channel this thread writes y of (kCh divides kThreads)
  const int out_c = threadIdx.x % kCh;
  const bool out_live = ch0 + out_c < din;
  const float out_d = out_live ? d[ch0 + out_c] : 0.f;

  // this thread's 16-byte pieces of a stage's (kSeg, kCh) x and dt tiles
  // (piece threadIdx.x + u kThreads of kCh / 4 a row): their step, place
  // in the tile, offset from the segment's first row, and whether their
  // channels exist
  constexpr int kQ = kCh / 4;
  constexpr int kPieces = kSeg * kQ / kThreads;
  static_assert(kPieces * kThreads == kSeg * kQ, "pieces tile a stage");
  static_assert(kSeg * N / 4 <= kThreads, "one B and one C piece a thread");
  int p_step[kPieces], p_tile[kPieces];
  long long p_off[kPieces];
  bool p_col[kPieces];
#pragma unroll
  for (int u = 0; u < kPieces; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int q4 = 4 * (i % kQ);
    p_step[u] = i / kQ;
    p_tile[u] = p_step[u] * kCh + q4;
    p_off[u] = static_cast<long long>(p_step[u]) * din + ch0 + q4;
    p_col[u] = ch0 + q4 < din;
  }

  // stage segment g into buffer `st` (an empty group past the end)
  auto issue = [&](Seg g, float* st) {
    if (g.k < n_chunks) {
      const long long r = row0 + g.k * tc + g.off;
      const int len = min(kSeg, tc - g.off);
      if (vec) {
        const float* xr = x + r * din;
        const float* dr = dt + r * din;
#pragma unroll
        for (int u = 0; u < kPieces; ++u) {
          const bool on = p_col[u] && p_step[u] < len;
          cp_async16(st + p_tile[u], on ? xr + p_off[u] : x, on);
          cp_async16(st + kSeg * kCh + p_tile[u], on ? dr + p_off[u] : dt,
                     on);
        }
        if (threadIdx.x < kSeg * N / 4) {
          const int i = 4 * threadIdx.x;
          const bool on = i < len * N;
          const long long o = on ? r * N + i : 0;
          cp_async16(st + 2 * kSeg * kCh + i, b + o, on);
          cp_async16(st + 2 * kSeg * kCh + kSeg * N + i, c + o, on);
        }
      } else {
        for (int i = threadIdx.x; i < kSeg * kCh; i += kThreads) {
          const int s = i / kCh, cc = i % kCh;
          const bool on = s < len && ch0 + cc < din;
          const long long o = on ? (r + s) * din + ch0 + cc : 0;
          cp_async4(st + i, x + o, on);
          cp_async4(st + kSeg * kCh + i, dt + o, on);
        }
        for (int i = threadIdx.x; i < kSeg * N; i += kThreads) {
          const bool on = i < len * N;
          const long long o = on ? r * N + i : 0;
          cp_async4(st + 2 * kSeg * kCh + i, b + o, on);
          cp_async4(st + 2 * kSeg * kCh + kSeg * N + i, c + o, on);
        }
      }
    }
    cp_async_commit();
  };

  int buf = 0;
  issue(Seg{0, 0}, smem);
  for (Seg g{0, 0}; g.k < n_chunks; g = next_seg(g, tc), buf ^= 1) {
    const int len = min(kSeg, tc - g.off);
    float* const st = smem + buf * Lay::kStage;
    cp_async_wait_all();  // this thread's copies of the segment landed
    __syncthreads();      // everyone's; the other buffer and sp are free
    issue(next_seg(g, tc), smem + (buf ^ 1) * Lay::kStage);
    if (g.off == 0 && live) {  // the state at the start of chunk g.k
      store_states(hseg + ((static_cast<long long>(batch) * n_chunks + g.k)
                               * din + ch) * N + kStates * sl, h);
    }
    const float* sx = st;
    const float* sdt = st + kSeg * kCh;
    const float* sb = st + 2 * kSeg * kCh;
    const float* sc = sb + kSeg * N;
    auto step = [&](int s) {
      const float xv = sx[s * kCh + cl];
      const float dtv = sdt[s * kCh + cl];
      const float dtx = __fmul_rn(dtv, xv);
      float bv[kStates], cv[kStates];
      load_states(bv, sb + s * N + kStates * sl);
      load_states(cv, sc + s * N + kStates * sl);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kStates; ++q) {
        const float decay = expf(__fmul_rn(dtv, av[q]));
        h[q] = __fadd_rn(__fmul_rn(decay, h[q]), __fmul_rn(dtx, bv[q]));
        const float hc = __fmul_rn(h[q], cv[q]);
        acc = q == 0 ? hc : __fadd_rn(acc, hc);
      }
      sp[s * kThreads + threadIdx.x] = acc;
    };
    if (len == kSeg) {
#pragma unroll 8
      for (int s = 0; s < kSeg; ++s) step(s);
    } else {
      for (int s = 0; s < len; ++s) step(s);
    }
    __syncthreads();  // the segment's partials are written
    // y of the segment, row by row: the channel's partials in lane order,
    // then + D x. A pass of the CTA covers kRows rows of kCh channels.
    constexpr int kRows = kThreads / kCh;
    float* yp = y + (row0 + g.k * tc + g.off + threadIdx.x / kCh) * din +
                ch0 + out_c;
    const long long ystep = static_cast<long long>(kRows) * din;
    auto out = [&](int i, float* dst) {
      const float acc = sum_in_order<kLanes>(sp + (i / kCh) * kThreads +
                                             out_c * kLanes);
      if (out_live) *dst = __fadd_rn(acc, __fmul_rn(out_d, sx[i]));
    };
    if (len == kSeg) {
#pragma unroll
      for (int u = 0; u < kSeg / kRows; ++u, yp += ystep) {
        out(threadIdx.x + u * kThreads, yp);
      }
    } else {
      for (int i = threadIdx.x; i < len * kCh; i += kThreads, yp += ystep) {
        out(i, yp);
      }
    }
  }
  if (live) store_states(hout + state, h);
}

template <int N>
int launch(const float* x, const float* dt, const float* b, const float* c,
           const float* a, const float* d, const float* h0, int batch, int L,
           int din, int tc, float* y, float* hout, float* hseg,
           cudaStream_t s) {
  using Lay = Layout<N>;
  auto kernel = selective_scan_fwd<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Lay::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const float* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const int vec = din % 4 == 0 && aligned(x) && aligned(dt) && aligned(b) &&
                  aligned(c);
  const dim3 grid((din + Lay::kCh - 1) / Lay::kCh, batch);
  kernel<<<grid, kThreads, Lay::kBytes, s>>>(x, dt, b, c, a, d, h0, L, din,
                                             tc, vec, y, hout, hseg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the scan on `stream`. x, dt, y are (batch, L, din); b, c are
// (batch, L, n); a is (din, n); d is (din,); h0, hout are (batch, din, n);
// hseg is (batch, L / tc, din, n); all float32, contiguous, hout and hseg
// 16-byte aligned. n must be 8 or 16, tc must divide L, batch must be at
// most 65535. Returns the first CUDA error of the launch (0 on success).
extern "C" int repro_selective_scan(const float* x, const float* dt,
                                    const float* b, const float* c,
                                    const float* a, const float* d,
                                    const float* h0, int batch, int L,
                                    int din, int n, int tc, float* y,
                                    float* hout, float* hseg, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || L <= 0 || din <= 0 || tc <= 0 || L % tc != 0 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8:
      return launch<8>(x, dt, b, c, a, d, h0, batch, L, din, tc, y, hout,
                       hseg, s);
    case 16:
      return launch<16>(x, dt, b, c, a, d, h0, batch, L, din, tc, y, hout,
                        hseg, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
