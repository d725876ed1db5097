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
// What bounds it on an H100: bytes. Each step reads x and dt and writes
// y, 12 bytes a channel, against ~7 float operations for each of the n
// states; at B 8, L 2048, d_inner 8192 that is ~1.6 GB (~0.5 ms at
// 3.35 TB/s) against ~15 G operations (~0.23 ms of fp32). The TPU kernel
// keeps the (channels, n) state in VMEM across a sequential grid; here:
//   - one thread carries one (batch, channel) state, n floats, in
//     registers for the whole sequence, so the state never leaves the SM;
//   - a warp covers 32 consecutive channels, so each step's loads of x
//     and dt and its store of y are coalesced 128-byte lines; the loads of
//     kUnroll steps are issued before their math, to keep some in flight;
//   - B_t and C_t are the same for every channel of a batch row: a block
//     stages kStage steps of them in shared memory, read as broadcasts.
// The sum over n runs in a fixed order in each thread (n = 0, 1, ...), so
// the bits are the same on every run. Every product and sum rounds on its
// own (__fmul_rn, __fadd_rn: never contracted to a multiply-add) and the
// exponential is the accurate expf, as in the plain version's torch.exp,
// so the kernel differs from it only in the order of the sum over n.
//
// Speed is later work: cp.async / TMA prefetch of x and dt, and splitting
// a channel's states across lanes for occupancy at small batch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kStage = 64;     // time steps of B and C staged at once
constexpr int kUnroll = 8;     // steps whose x and dt load ahead

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ b, const float* __restrict__ c,
                   const float* __restrict__ a, const float* __restrict__ d,
                   const float* __restrict__ h0, int L, int din, int tc,
                   float* __restrict__ y, float* __restrict__ hout,
                   float* __restrict__ hseg) {
  static_assert(N % 4 == 0, "states move as float4");
  __shared__ float sb[kStage * N];
  __shared__ float sc[kStage * N];
  const int batch = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ch < din;
  const long long row0 = static_cast<long long>(batch) * L;
  const long long state = (static_cast<long long>(batch) * din + ch) * N;

  float h[N], av[N];
  float dv = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = av[n] = 0.f;
  if (live) {
    const float4* hp = reinterpret_cast<const float4*>(h0 + state);
    const float4* ap =
        reinterpret_cast<const float4*>(a + static_cast<long long>(ch) * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 hv = hp[q], aq = ap[q];
      h[4 * q] = hv.x; h[4 * q + 1] = hv.y; h[4 * q + 2] = hv.z;
      h[4 * q + 3] = hv.w;
      av[4 * q] = aq.x; av[4 * q + 1] = aq.y; av[4 * q + 2] = aq.z;
      av[4 * q + 3] = aq.w;
    }
    dv = d[ch];
  }

  const int n_chunks = L / tc;
  for (int k = 0; k < n_chunks; ++k) {
    if (live) {  // the state at the start of chunk k
      float4* sp = reinterpret_cast<float4*>(
          hseg + ((static_cast<long long>(batch) * n_chunks + k) * din + ch)
                     * N);
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        sp[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                            h[4 * q + 3]);
    }
    const int chunk_end = (k + 1) * tc;
    for (int t0 = k * tc; t0 < chunk_end; t0 += kStage) {
      const int steps = min(kStage, chunk_end - t0);
      __syncthreads();  // the last stage's B and C are read
      const float* bp = b + (row0 + t0) * N;
      const float* cp = c + (row0 + t0) * N;
      for (int i = threadIdx.x; i < steps * N; i += kThreads) {
        sb[i] = bp[i];
        sc[i] = cp[i];
      }
      __syncthreads();
      if (!live) continue;
      for (int s0 = 0; s0 < steps; s0 += kUnroll) {
        float xs[kUnroll], ds[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          xs[u] = ds[u] = 0.f;
          if (s0 + u < steps) {
            const long long off = (row0 + t0 + s0 + u) * din + ch;
            xs[u] = x[off];
            ds[u] = dt[off];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = s0 + u;
          if (s < steps) {
            const float dtx = __fmul_rn(ds[u], xs[u]);
            float acc = 0.f;
#pragma unroll
            for (int n = 0; n < N; ++n) {
              const float decay = expf(__fmul_rn(ds[u], av[n]));
              h[n] = __fadd_rn(__fmul_rn(decay, h[n]),
                               __fmul_rn(dtx, sb[s * N + n]));
              const float hc = __fmul_rn(h[n], sc[s * N + n]);
              acc = n == 0 ? hc : __fadd_rn(acc, hc);
            }
            y[(row0 + t0 + s) * din + ch] =
                __fadd_rn(acc, __fmul_rn(dv, xs[u]));
          }
        }
      }
    }
  }

  if (live) {
    float4* op = reinterpret_cast<float4*>(hout + state);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      op[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

template <int N>
void launch(const float* x, const float* dt, const float* b, const float* c,
            const float* a, const float* d, const float* h0, int batch, int L,
            int din, int tc, float* y, float* hout, float* hseg,
            cudaStream_t s) {
  const dim3 grid((din + kThreads - 1) / kThreads, batch);
  selective_scan_fwd<N><<<grid, kThreads, 0, s>>>(x, dt, b, c, a, d, h0, L,
                                                  din, tc, y, hout, hseg);
}

}  // namespace

// Runs the scan on `stream`. x, dt, y are (batch, L, din); b, c are
// (batch, L, n); a is (din, n); d is (din,); h0, hout are (batch, din, n);
// hseg is (batch, L / tc, din, n); all float32, contiguous. n must be 8 or
// 16, tc must divide L, batch must be at most 65535. Returns
// cudaGetLastError() after the launch (0 on success).
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
      launch<8>(x, dt, b, c, a, d, h0, batch, L, din, tc, y, hout, hseg, s);
      break;
    case 16:
      launch<16>(x, dt, b, c, a, d, h0, batch, L, din, tc, y, hout, hseg, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
