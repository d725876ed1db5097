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
// What bounds it on an H100: at the training shape (B 2, L 4096, d_inner
// 8192, n 16) the inputs and outputs are ~1.3 GB (x, dt, ybar read; dx,
// ddt written), ~0.4 ms at 3.35 TB/s, against ~25 float operations and two
// exponentials per state per step. Design, simple first:
//   - one thread carries one (batch, channel): its n adjoint states hbar
//     and its dA partials in registers, as the forward kernel carries h; a
//     warp covers 32 consecutive channels, so x, dt, ybar, dx and ddt move
//     as 128-byte lines, and B_t, C_t are staged kStage steps at a time in
//     shared memory;
//   - the in-chunk state history does not fit a thread's registers (tc x n
//     floats, 32 KB at tc 512): each thread writes its chunk's states to a
//     per-launch global scratch `hist` (B, tc, din, n), one float4 line at
//     a time, and reads them back in reverse;
//   - dB_t and dC_t sum over channels with no float atomics: each step a
//     warp reduce-scatters its 2n terms over its 32 lanes with shuffles (a
//     fixed tree), the block adds its warps' sums in warp order into one
//     partial per block, and a second kernel adds the blocks' partials in
//     block order. dA and dD are written per (batch row, chunk), as the
//     reference writes them, and summed in that order by a third pass.
// Every sum has a fixed order, so the bits are the same on every run. The
// recompute rounds every product and sum on its own (__fmul_rn, __fadd_rn,
// built with --fmad=false) and uses the accurate expf, exactly as
// selective_scan.cu does, so the recomputed states are the forward's own
// bits; the outputs differ from the plain version only in the order of
// the sums over n and over channels, batch rows and chunks.
//
// Speed is later work: the scratch round trip (2 x 4.3 GB a call at the
// training shape), and one thread a channel leaves a B 2 launch with ~4
// warps an SM; splitting a channel's states across lanes would fill it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 64;     // time steps of B and C staged at once

// Every lane holds V values; afterwards lane l holds the warp's sum of
// value l >> (V == 32 ? 0 : 1). Each stage trades half of the values with
// the lane `off` away, in a fixed order.
template <int V>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[V],
                                                     int lane) {
  static_assert(V == 16 || V == 32, "2n values for n = 8 or 16");
#pragma unroll
  for (int stage = 0; stage < 5; ++stage) {
    const int off = 16 >> stage;
    const int half = (V / 2) >> stage;
    if (half >= 1) {
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? v[i] : v[i + half];
        const float keep = upper ? v[i + half] : v[i];
        v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, off));
      }
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], off));
    }
  }
  return v[0];
}

template <int N>
__device__ __forceinline__ void load_state(const float* p, float (&h)[N]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = q[i];
    h[4 * i] = v.x; h[4 * i + 1] = v.y; h[4 * i + 2] = v.z;
    h[4 * i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_state(float* p, const float (&h)[N]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    q[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_chunks(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ a, const float* __restrict__ d,
    const float* __restrict__ hseg, const float* __restrict__ ybar,
    const float* __restrict__ houtbar, int L, int din, int tc,
    float* __restrict__ hist, float* __restrict__ bc_part,
    float* __restrict__ da_part, float* __restrict__ dd_part,
    float* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ dh0) {
  static_assert(N % 4 == 0, "states move as float4");
  constexpr int V = 2 * N;               // a step's dB and dC terms
  constexpr int kShift = V == 32 ? 0 : 1;
  __shared__ float sb[kStage * N];
  __shared__ float sc[kStage * N];
  __shared__ float sred[kStage * kWarps * V];
  const int batch = blockIdx.y;
  const int nblk = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ch < din;
  const long long row0 = static_cast<long long>(batch) * L;
  const long long state = (static_cast<long long>(batch) * din + ch) * N;
  const int n_chunks = L / tc;

  // dead lanes (ch >= din) run the math on zeros: their terms add nothing
  // to the warp's sums, and they store nothing
  float av[N], hbar[N];
  float dv = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) av[n] = hbar[n] = 0.f;
  if (live) {
    load_state<N>(a + static_cast<long long>(ch) * N, av);
    load_state<N>(houtbar + state, hbar);
    dv = d[ch];
  }

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t_lo = k * tc;
    const long long part = static_cast<long long>(batch) * n_chunks + k;
    const float* h_start = hseg + (part * din + ch) * N;
    float* my_hist = hist + (static_cast<long long>(batch) * tc * din + ch)
                                * N;
    const long long hist_step = static_cast<long long>(din) * N;

    // ---- 1. the chunk's states, bit for bit the forward's ----------------
    {
      float h[N];
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = 0.f;
      if (live) load_state<N>(h_start, h);
      for (int t0 = t_lo; t0 < t_lo + tc; t0 += kStage) {
        const int steps = min(kStage, t_lo + tc - t0);
        __syncthreads();  // the last reader of sb is done
        const float* bp = b + (row0 + t0) * N;
        for (int i = threadIdx.x; i < steps * N; i += kThreads) sb[i] = bp[i];
        __syncthreads();
        if (!live) continue;
        for (int s = 0; s < steps; ++s) {
          const long long off = (row0 + t0 + s) * din + ch;
          const float xv = x[off], dtv = dt[off];
          const float dtx = __fmul_rn(dtv, xv);
#pragma unroll
          for (int n = 0; n < N; ++n) {
            const float decay = expf(__fmul_rn(dtv, av[n]));
            h[n] = __fadd_rn(__fmul_rn(decay, h[n]),
                             __fmul_rn(dtx, sb[s * N + n]));
          }
          store_state<N>(my_hist + (t0 + s - t_lo) * hist_step, h);
        }
      }
    }

    // ---- 2. the reverse accumulation -------------------------------------
    float da[N], hcur[N];  // hcur: the state after step t
    float dd = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) da[n] = hcur[n] = 0.f;
    if (live) load_state<N>(my_hist + (tc - 1) * hist_step, hcur);
    for (int w_hi = t_lo + tc; w_hi > t_lo; w_hi -= kStage) {
      const int w_lo = max(t_lo, w_hi - kStage);
      const int steps = w_hi - w_lo;
      __syncthreads();  // sb, sc and sred of the last window are read
      const float* bp = b + (row0 + w_lo) * N;
      const float* cp = c + (row0 + w_lo) * N;
      for (int i = threadIdx.x; i < steps * N; i += kThreads) {
        sb[i] = bp[i];
        sc[i] = cp[i];
      }
      __syncthreads();
      for (int s = steps - 1; s >= 0; --s) {
        const int t = w_lo + s;
        const long long off = (row0 + t) * din + ch;
        float xv = 0.f, dtv = 0.f, yb = 0.f;
        float hprev[N];
#pragma unroll
        for (int n = 0; n < N; ++n) hprev[n] = 0.f;
        if (live) {
          xv = x[off];
          dtv = dt[off];
          yb = ybar[off];
          load_state<N>(t > t_lo ? my_hist + (t - 1 - t_lo) * hist_step
                                 : h_start, hprev);
        }
        dd = __fadd_rn(dd, __fmul_rn(yb, xv));
        const float xbar = __fmul_rn(yb, dv);
        const float dtx = __fmul_rn(dtv, xv);
        float v[V];
        float dtxbar = 0.f, ddt_acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          v[N + n] = __fmul_rn(yb, hcur[n]);                   // dC term
          hbar[n] = __fadd_rn(hbar[n], __fmul_rn(yb, sc[s * N + n]));
          const float decay = expf(__fmul_rn(dtv, av[n]));
          const float g = __fmul_rn(__fmul_rn(hbar[n], hprev[n]), decay);
          const float hb = __fmul_rn(hbar[n], sb[s * N + n]);
          dtxbar = n == 0 ? hb : __fadd_rn(dtxbar, hb);
          v[n] = __fmul_rn(hbar[n], dtx);                      // dB term
          da[n] = __fadd_rn(da[n], __fmul_rn(g, dtv));
          const float ga = __fmul_rn(g, av[n]);
          ddt_acc = n == 0 ? ga : __fadd_rn(ddt_acc, ga);
          hbar[n] = __fmul_rn(hbar[n], decay);
          hcur[n] = hprev[n];
        }
        const float r = warp_reduce_scatter<V>(v, lane);
        if ((lane & ((1 << kShift) - 1)) == 0)
          sred[(s * kWarps + warp) * V + (lane >> kShift)] = r;
        if (live) {
          ddt[off] = __fadd_rn(ddt_acc, __fmul_rn(dtxbar, xv));
          dx[off] = __fadd_rn(xbar, __fmul_rn(dtxbar, dtv));
        }
      }
      __syncthreads();
      // the block's dB / dC partial of each step: its warps in order
      for (int i = threadIdx.x; i < steps * V; i += kThreads) {
        const int s = i / V, j = i % V;
        float acc = sred[(s * kWarps) * V + j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
          acc = __fadd_rn(acc, sred[(s * kWarps + w) * V + j]);
        bc_part[((row0 + w_lo + s) * nblk + blockIdx.x) * V + j] = acc;
      }
    }
    if (live) {
      store_state<N>(da_part + (part * din + ch) * N, da);
      dd_part[part * din + ch] = dd;
    }
  }
  if (live) store_state<N>(dh0 + state, hbar);
}

// dB and dC of each (batch row, step): the blocks' partials in block order.
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
           int din, int tc, int nblk, float* hist, float* bc_part,
           float* da_part, float* dd_part, float* dx, float* ddt, float* db,
           float* dc, float* da, float* dd, float* dh0, cudaStream_t s) {
  const dim3 grid(nblk, batch);
  selective_scan_bwd_chunks<N><<<grid, kThreads, 0, s>>>(
      x, dt, b, c, a, d, hseg, ybar, houtbar, L, din, tc, hist, bc_part,
      da_part, dd_part, dx, ddt, dh0);
  cudaError_t err = cudaGetLastError();
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
// scratch is hist (batch, tc, din, n), bc_part (batch, L, nblk, 2n),
// da_part (batch, L / tc, din, n) and dd_part (batch, L / tc, din), with
// nblk = ceil(din / 128); all float32, contiguous. n must be 8 or 16, tc
// must divide L, batch must be at most 65535. Returns the first CUDA error
// of its launches (0 on success).
extern "C" int repro_selective_scan_bwd(
    const float* x, const float* dt, const float* b, const float* c,
    const float* a, const float* d, const float* hseg, const float* ybar,
    const float* houtbar, int batch, int L, int din, int n, int tc,
    int nblk, float* hist, float* bc_part, float* da_part, float* dd_part,
    float* dx, float* ddt, float* db, float* dc, float* da, float* dd,
    float* dh0, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || L <= 0 || din <= 0 || tc <= 0 || L % tc != 0 ||
      batch > 65535 || nblk != (din + kThreads - 1) / kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8:
      return launch<8>(x, dt, b, c, a, d, hseg, ybar, houtbar, batch, L, din,
                       tc, nblk, hist, bc_part, da_part, dd_part, dx, ddt,
                       db, dc, da, dd, dh0, s);
    case 16:
      return launch<16>(x, dt, b, c, a, d, hseg, ybar, houtbar, batch, L,
                        din, tc, nblk, hist, bc_part, da_part, dd_part, dx,
                        ddt, db, dc, da, dd, dh0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
