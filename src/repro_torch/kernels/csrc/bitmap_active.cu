// bitmap_active: the block-activity probe of active scanning, and the
// fused scan round's head built on it, for Hopper.
//
// Replaces the TPU kernel `active_blocks` (src/repro/kernels/
// bitmap_active.py, `active_blocks` and its tile body `tile_hit_any`):
//
//   flag[i] = any_w(words[row_i, w] & active[w]) != 0
//
// over block-by-group bitmaps packed 32 groups to a word. Rows are either
// all rows in order (the static prefilter, the per-block path's uploaded
// lookahead batches) or the rows named by `win`, read in place without a
// gather copy.
//
// What bounds it on an H100: bytes. Each probed row reads W words once
// (4 B each) and writes one int32 flag; there is no arithmetic to speak of
// (one AND and one OR per word). The design keeps the reads coalesced:
// for W < 32 one thread walks one row, neighbouring threads on
// neighbouring rows; for W >= 32 one warp walks one row, neighbouring
// lanes on neighbouring words, and the lanes OR their hits with one warp
// reduction. The active mask (at most a few hundred words) stays in L1.
//
// The round head (repro_round_select) is everything the fused scan round
// (src/repro/kernels/fused_scan.py, `fused_round` before its fold:
// the window, the static prefilter, the probe, `_budget_select` and
// `_gather_blocks`) computes before the fold, in ONE launch:
//
//   live     = go && lap_end - nb <= pos <= lap_end   (pos, go on the card)
//   left     = live ? min(window, lap_end - pos) : 0  (positions in range)
//   base     = wrap ? pos % nb : pos
//   ok[i]    = static_ok[order_pad[base + i]] && i < left
//   flags[i] = ok[i] && probe(order_pad[base + i])   (ok[i] without probe)
//   lane k   = the k-th flagged position: blk[k] = its block, tvalid[k] = 1;
//              lanes past the last taken one: blk 0, tvalid 0
//   new_pos  = pos + (one past the budget-th flag if there are budget
//              flags, else left)
//
// The cursor `pos` (int64) and the flag `go` (bool) are device scalars,
// the previous round's new_pos and the loop's own verdict, so a round
// reads nothing from the host and a CUDA graph of many rounds replays
// each with the cursor the round before it left. A round that is not to
// run (go false, or pos outside [lap_end - nb, lap_end]) selects
// nothing: ok, flags and tvalid all false, blk 0, new_pos = pos. A solo
// scan's lap_end is nb, with no wrap and one active row.
//
// On the TPU the reference is one jitted function and XLA fuses the
// selection arithmetic; eager PyTorch would launch ~30 small kernels for
// it (cumsum, argmax, scatter, compares) around the probe. Here the probe
// is the one above, one CTA per slice of the window (32 positions at
// W >= 32, 256 below) so the word reads spread over the SMs, and the
// selection is a look-back across the CTAs: each CTA ranks its own flags
// in shared memory and publishes its count, tagged with the call's epoch
// (so no buffer is reset between calls); its first warp adds up the
// counts of the CTAs before it, stopping once they reach the budget. A
// CTA that still has lanes to fill scatters its taken positions' blocks,
// which it holds in shared memory, to their lanes; the one holding the
// budget-th flag writes new_pos, and the last CTA writes the padding
// lanes and new_pos when the window holds fewer flags than the budget.
// Nothing is read back from memory but the counts. A CTA waits only on
// CTAs with lower indices, which are scheduled before it (the premise
// of CUB's decoupled look-back).
// The epoch lives on the device, in the look-back buffer's first word
// beside an arrival count: each CTA adds one to the word as it starts
// (one atomic, which reads the epoch), and the CTA that arrives last
// advances the epoch and zeroes the count with a second add. All the
// call's reads of the word come before that add (one address's atomics
// are ordered), so no value from the host changes between calls and a
// captured CUDA graph replays right.
// Bound: bytes (the window's order_pad, static_ok and word reads, the
// outputs), ~0.44 us at window 4096, W 88; a call is latency: the
// launch, two dependent DRAM round trips (order_pad, then words), and
// one L2 round trip for the counts. Every output is an integer or a
// bool, so the result is exact and the same on every run.
//
// The multi-query probe (repro_bitmap_active_multi) is shared-scan
// serving's form of the same test: a (Q, W) stack of active masks, one a
// query, against the same rows,
//
//   out[q, i] = any_w(words[row_i, w] & stack[q, w]) != 0,
//
// in one launch. The reference loops its Pallas kernel once a row of the
// stack (src/repro/kernels/ops.py, `active_blocks_multi`) and so reads
// the bitmap Q times; here each CTA stages the stack in shared memory
// once and walks its rows, each row's W words loaded from memory once
// (into registers) and tested against all Q masks. Bound: bytes, n·W·4
// + Q·W·4 read and Q·n·4 written.
//
// The round head also serves a slot of a shared pass: `active` may be a
// stack of n_active rows (the slot's queries), ORed at the start of each
// CTA into one mask in shared memory, which is bitwise the union of the
// rows' flags; and the cursor limit is the slot's lap end (anchor + nb)
// in place of nb, the window read from order_pad[(pos % nb) + i] of a
// wrap-filled order with `wrap` (a lap that starts mid-scan runs past
// nb). The live test becomes lap_end - nb <= pos <= lap_end.
//
// Words are uint32 bit patterns; the port carries them in int32 tensors,
// which this kernel reads as uint32. The result is exact: the same bits on
// every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
active_rows_by_thread(const unsigned* __restrict__ words,
                      const int* __restrict__ win, int n, int n_words,
                      const unsigned* __restrict__ active,
                      int* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long row = win != nullptr ? win[i] : i;
  const unsigned* w = words + row * n_words;
  unsigned acc = 0;
  for (int k = 0; k < n_words; ++k) acc |= w[k] & active[k];
  out[i] = acc != 0u;
}

__global__ void __launch_bounds__(kThreads)
active_rows_by_warp(const unsigned* __restrict__ words,
                    const int* __restrict__ win, int n, int n_words,
                    const unsigned* __restrict__ active,
                    int* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int i = static_cast<int>(t >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // uniform across the warp
  const long long row = win != nullptr ? win[i] : i;
  const unsigned* w = words + row * n_words;
  unsigned acc = 0;
  for (int k = lane; k < n_words; k += 32) acc |= w[k] & active[k];
  acc = __reduce_or_sync(0xffffffffu, acc);
  if (lane == 0) out[i] = acc != 0u;
}

// ---- the multi-query probe --------------------------------------------------

constexpr int kMultiRowWords = 32;   // thread mode: words a row, at most
constexpr int kMultiLaneWords = 16;  // warp mode: words a lane holds a pass

// Stages the (q, n_words) stack in shared memory (s_stack).
__device__ __forceinline__ void stage_stack(const unsigned* __restrict__ st,
                                            int q, int n_words,
                                            unsigned* s_stack) {
  for (int k = threadIdx.x; k < q * n_words; k += kThreads) {
    s_stack[k] = st[k];
  }
  __syncthreads();
}

// W < 32: a thread a row (grid-stride), the row's words in registers.
__global__ void __launch_bounds__(kThreads)
multi_rows_by_thread(const unsigned* __restrict__ words,
                     const int* __restrict__ win, int n, int n_words,
                     const unsigned* __restrict__ stack, int q,
                     int* __restrict__ out) {
  extern __shared__ unsigned s_stack[];
  stage_stack(stack, q, n_words, s_stack);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = win != nullptr ? win[i] : i;
    const unsigned* w = words + row * n_words;
    unsigned v[kMultiRowWords];
#pragma unroll
    for (int k = 0; k < kMultiRowWords; ++k) {
      v[k] = k < n_words ? w[k] : 0u;
    }
    for (int r = 0; r < q; ++r) {
      const unsigned* a = s_stack + r * n_words;
      unsigned acc = 0u;
#pragma unroll
      for (int k = 0; k < kMultiRowWords; ++k) {
        if (k < n_words) acc |= v[k] & a[k];
      }
      out[static_cast<long long>(r) * n + i] = acc != 0u;
    }
  }
}

// W >= 32: a warp a row (grid-stride over warps). A lane holds up to
// kMultiLaneWords of the row's words a pass (32 * 16 = 512 words, G up
// to 16,384, in one pass); a wider row takes more passes, each ORed
// into the row's flags by the same lane.
__global__ void __launch_bounds__(kThreads)
multi_rows_by_warp(const unsigned* __restrict__ words,
                   const int* __restrict__ win, int n, int n_words,
                   const unsigned* __restrict__ stack, int q,
                   int* __restrict__ out) {
  extern __shared__ unsigned s_stack[];
  stage_stack(stack, q, n_words, s_stack);
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long i = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                     (threadIdx.x >> 5);
       i < n; i += warps) {  // uniform across the warp
    const long long row = win != nullptr ? win[i] : i;
    const unsigned* w = words + row * n_words;
    for (int k0 = 0; k0 < n_words; k0 += 32 * kMultiLaneWords) {
      unsigned v[kMultiLaneWords];
#pragma unroll
      for (int u = 0; u < kMultiLaneWords; ++u) {
        const int k = k0 + lane + 32 * u;
        v[u] = k < n_words ? w[k] : 0u;
      }
      for (int r = 0; r < q; ++r) {
        const unsigned* a = s_stack + r * n_words;
        unsigned acc = 0u;
#pragma unroll
        for (int u = 0; u < kMultiLaneWords; ++u) {
          const int k = k0 + lane + 32 * u;
          if (k < n_words) acc |= v[u] & a[k];
        }
        const unsigned any = __reduce_or_sync(0xffffffffu, acc);
        if (lane == 0) {
          int* o = out + static_cast<long long>(r) * n + i;
          *o = (k0 == 0 ? 0 : *o) | (any != 0u);
        }
      }
    }
  }
}

// ---- the fused round's head ------------------------------------------------

constexpr int kWarpRows = 4;  // warp mode: window positions a warp probes
constexpr int kWarpCta = kThreads / 32 * kWarpRows;  // ... a CTA probes
constexpr int kWordPass = 8;  // warp mode: words a lane loads at once
constexpr int kRowPass = 16;  // thread mode: words a thread loads at once

struct HeadArgs {
  const int* order_pad;            // (>= pos + window,) block ids
  const unsigned char* static_ok;  // (nb,) bool
  const unsigned* words;           // (nb, n_words), or null: no probe
  const unsigned* active;          // (n_active, n_words): ORed rows
  const long long* pos;            // () the cursor, on the card
  const unsigned char* go;         // () run this round, on the card
  long long nb;
  long long lap_end;               // the cursor limit: nb, or anchor + nb
  int n_words, n_active, window, budget;
  bool wrap;                       // window from pos % nb
  unsigned char* ok;               // (window,)
  unsigned char* flags;            // (window,)
  long long* new_pos;              // ()
  int* blk;                        // (budget,)
  unsigned char* tvalid;           // (budget,)
  // [0]: (epoch << kArriveBits) | CTAs arrived; [1 + c]: CTA c's
  // (tag << kCountBits) | flag count, tag = epoch + 1 of its call.
  // Zeroed before the first call.
  unsigned long long* status;
};

constexpr int kArriveBits = 20;  // CTAs a call: < 2^20 (2^44 epochs)
constexpr int kCountBits = 16;   // a CTA's flag count (<= 256) in a word

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// One launch. Each CTA probes its slice of the window (one thread a
// position, or with kByWarp one warp a position, kWarpRows positions a
// warp), writes ok and flags, ranks its flags in shared memory and
// publishes its flag count; then its warp 0 adds up the counts of the
// CTAs before it (a look-back, stopping once they reach the budget).
// A CTA whose predecessors hold fewer than `budget` flags scatters its
// own taken positions' blocks to their lanes (the one holding the
// budget-th flag also writes new_pos); the last CTA, if the whole window
// holds fewer, writes the padding lanes and new_pos.
template <bool kByWarp>
__global__ void __launch_bounds__(kThreads) round_head_kernel(HeadArgs h) {
  constexpr int kPos = kByWarp ? kWarpCta : kThreads;  // positions a CTA
  __shared__ int s_row[kPos];
  __shared__ unsigned char s_flag[kPos];
  __shared__ int s_wcnt[kThreads / 32];
  __shared__ int s_prefix;
  __shared__ unsigned long long s_tag;
  extern __shared__ unsigned s_mask[];  // the stack's OR (n_active > 1)
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int i0 = blockIdx.x * kPos;  // the CTA's first window position
  const long long pos = *h.pos;
  const bool run = *h.go != 0 && pos >= h.lap_end - h.nb &&
                   pos <= h.lap_end;
  const long long left = run ? (h.lap_end - pos < h.window
                                    ? h.lap_end - pos : h.window)
                             : 0;  // window positions in range
  // the window's first entry of order_pad; a round that does not run
  // reads none of it
  const int* order = h.order_pad + (h.wrap ? pos % h.nb : pos);
  // the mask: one row read where it lies, or the OR of the stack's rows
  // (the union of the rows' flags) in shared memory
  const unsigned* active = h.active;
  if (h.words != nullptr && h.n_active > 1) {
    for (int k = t; k < h.n_words; k += kThreads) {
      unsigned m = 0u;
      for (int r = 0; r < h.n_active; ++r) {
        m |= h.active[static_cast<long long>(r) * h.n_words + k];
      }
      s_mask[k] = m;
    }
    __syncthreads();
    active = s_mask;
  }
  if (t == 0) {  // arrive: this call's tag is its epoch + 1, never 0
    const unsigned long long was = atomicAdd(h.status, 1ull);
    if ((was & ((1ull << kArriveBits) - 1)) == gridDim.x - 1) {
      atomicAdd(h.status, (1ull << kArriveBits) - gridDim.x);  // epoch + 1
    }
    s_tag = (was >> kArriveBits) + 1;
  }
  if constexpr (kByWarp) {
    // lane j < kWarpRows reads position p = warp * kWarpRows + j
    const int p = warp * kWarpRows + lane;
    const int i = i0 + p;
    const bool live = lane < kWarpRows && i < left;
    const int row = live ? order[i] : 0;
    const bool okv = live && h.static_ok[row] != 0;
    const unsigned* w[kWarpRows];
    bool lj[kWarpRows];
    unsigned acc[kWarpRows];
#pragma unroll
    for (int j = 0; j < kWarpRows; ++j) {
      w[j] = h.words + static_cast<long long>(__shfl_sync(0xffffffffu, row,
                                                          j)) * h.n_words;
      lj[j] = __shfl_sync(0xffffffffu, live, j);
      acc[j] = 0u;
    }
    // kWordPass words a lane for all the positions at once: every load
    // of a pass is in flight before the first is used (one round trip
    // for W <= 32 * kWordPass)
    for (int k0 = lane; k0 < h.n_words; k0 += 32 * kWordPass) {
      unsigned a[kWordPass], v[kWordPass][kWarpRows];
#pragma unroll
      for (int u = 0; u < kWordPass; ++u) {
        const int k = k0 + 32 * u;
        a[u] = k < h.n_words ? active[k] : 0u;
#pragma unroll
        for (int j = 0; j < kWarpRows; ++j) {
          v[u][j] = k < h.n_words && lj[j] ? w[j][k] : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < kWordPass; ++u) {
#pragma unroll
        for (int j = 0; j < kWarpRows; ++j) acc[j] |= v[u][j] & a[u];
      }
    }
    unsigned hit = 0u;
#pragma unroll
    for (int j = 0; j < kWarpRows; ++j) {
      const unsigned any = __reduce_or_sync(0xffffffffu, acc[j]);
      if (lane == j) hit = any;
    }
    if (lane < kWarpRows) {
      const bool f = okv && hit != 0u;
      s_row[p] = row;
      s_flag[p] = f;
      if (i < h.window) {
        h.ok[i] = okv;
        h.flags[i] = f;
      }
    }
  } else {
    const int i = i0 + t;
    bool okv = false, hit = true;
    int row = 0;
    if (i < left) {
      row = order[i];
      okv = h.static_ok[row] != 0;
      if (h.words != nullptr) {  // kRowPass words a pass, as above
        const unsigned* w = h.words + static_cast<long long>(row) * h.n_words;
        unsigned acc = 0u;
        for (int k0 = 0; k0 < h.n_words; k0 += kRowPass) {
          unsigned v[kRowPass];
#pragma unroll
          for (int u = 0; u < kRowPass; ++u) {
            v[u] = k0 + u < h.n_words ? w[k0 + u] & active[k0 + u] : 0u;
          }
#pragma unroll
          for (int u = 0; u < kRowPass; ++u) acc |= v[u];
        }
        hit = acc != 0u;
      }
    }
    s_row[t] = row;
    s_flag[t] = okv && hit;
    if (i < h.window) {
      h.ok[i] = okv;
      h.flags[i] = okv && hit;
    }
  }
  __syncthreads();  // s_row and s_flag are written

  // the CTA's flags in window order: rank of each, and the count
  const bool f = t < kPos && s_flag[t] != 0;
  const unsigned bal = __ballot_sync(0xffffffffu, f);
  if (lane == 0) s_wcnt[warp] = __popc(bal);
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int v = 0; v < kThreads / 32; ++v) {
    before += v < warp ? s_wcnt[v] : 0;
    count += s_wcnt[v];
  }
  const unsigned long long tag = s_tag;
  if (t == 0) {
    publish(h.status + 1 + blockIdx.x, (tag << kCountBits) | count);
  }
  if (warp == 0) {  // look-back: flags of the CTAs before this one
    int prefix = 0;
    for (int c0 = 0; c0 < static_cast<int>(blockIdx.x) && prefix < h.budget;
         c0 += 32) {
      const int c = c0 + lane;
      unsigned n = 0u;
      if (c < static_cast<int>(blockIdx.x)) {
        unsigned long long st;
        do {
          st = peek(h.status + 1 + c);
        } while ((st >> kCountBits) != tag);
        n = static_cast<unsigned>(st & ((1u << kCountBits) - 1u));
      }
      prefix += static_cast<int>(__reduce_add_sync(0xffffffffu, n));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const int prefix = s_prefix;
  if (prefix >= h.budget) return;  // the cut lies before this CTA
  if (f) {
    const int r = prefix + before + __popc(bal & ((1u << lane) - 1u));
    if (r < h.budget) {
      h.blk[r] = s_row[t];
      h.tvalid[r] = 1;
    }
    if (r == h.budget - 1) *h.new_pos = pos + i0 + t + 1;
  }
  if (blockIdx.x == gridDim.x - 1 && prefix + count < h.budget) {
    for (int r = prefix + count + t; r < h.budget; r += kThreads) {
      h.blk[r] = 0;
      h.tvalid[r] = 0;
    }
    if (t == 0) *h.new_pos = pos + left;
  }
}

}  // namespace

// Probes n rows on `stream`: row i is win[i] when win is not null, else i.
// words is (rows, n_words) row-major; out is (n,) int32. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_bitmap_active(const unsigned* words, const int* win,
                                   int n, int n_words,
                                   const unsigned* active, int* out,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_words >= 32) {
    const long long threads = static_cast<long long>(n) * 32;
    const int grid = static_cast<int>((threads + kThreads - 1) / kThreads);
    active_rows_by_warp<<<grid, kThreads, 0, s>>>(words, win, n, n_words,
                                                  active, out);
  } else {
    const int grid = (n + kThreads - 1) / kThreads;
    active_rows_by_thread<<<grid, kThreads, 0, s>>>(words, win, n, n_words,
                                                    active, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The multi-query probe on `stream`: out[q * n + i] (int32) for the q
// rows of `stack` ((q, n_words) row-major) against n rows of words, row
// i being win[i] when win is not null, else i. One launch; the stack is
// staged in shared memory (q * n_words * 4 bytes, at most 227 KB).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_bitmap_active_multi(const unsigned* words,
                                         const int* win, int n,
                                         int n_words,
                                         const unsigned* stack, int q,
                                         int* out, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || q == 0) return 0;
  const long long smem = static_cast<long long>(q) * n_words * 4;
  if (n_words < 1 || q < 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool by_warp = n_words >= 32;
  const long long rows_per_cta = by_warp ? kThreads / 32 : kThreads;
  long long grid = (n + rows_per_cta - 1) / rows_per_cta;
  // a few CTAs an SM, each walking many rows: the stack is staged once a
  // CTA, not once a few rows
  if (grid > 4ll * sms) grid = 4ll * sms;
  const void* fn = by_warp ? reinterpret_cast<const void*>(multi_rows_by_warp)
                           : reinterpret_cast<const void*>(
                                 multi_rows_by_thread);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (by_warp) {
    multi_rows_by_warp<<<static_cast<unsigned>(grid), kThreads,
                         static_cast<size_t>(smem), s>>>(
        words, win, n, n_words, stack, q, out);
  } else {
    multi_rows_by_thread<<<static_cast<unsigned>(grid), kThreads,
                           static_cast<size_t>(smem), s>>>(
        words, win, n, n_words, stack, q, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused round's head on `stream`, in one launch (see the header).
// `pos` (int64) and `go` (bool) point at device scalars; order_pad holds
// at least nb + window entries (wrap-filled when `wrap`). The cursor
// limit is lap_end (nb for a solo scan, anchor + nb for a slot of a
// shared pass).
// words == null runs no probe (flags = ok); otherwise words is
// (nb, n_words) row-major and active (n_active, n_words), its rows ORed.
// `status` holds 1 + ceil(window / 32) words (the epoch, then a word for
// each CTA in either mode), zeroed before its first call and never reset
// after; calls that share a buffer must not overlap. A shared pass calls
// the head once a slot a round on one stream, one call after another, so
// its calls never overlap: each finds the epoch the one before it left
// (inside one captured graph too).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_round_select(const int* order_pad,
                                  const unsigned char* static_ok,
                                  const unsigned* words, int n_words,
                                  const unsigned* active, int n_active,
                                  const long long* pos,
                                  const unsigned char* go, long long nb,
                                  long long lap_end, int wrap,
                                  int window, int budget,
                                  unsigned char* ok, unsigned char* flags,
                                  long long* new_pos, int* blk,
                                  unsigned char* tvalid,
                                  unsigned long long* status, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool by_warp = words != nullptr && n_words >= 32;
  const int per_cta = by_warp ? kWarpCta : kThreads;
  const long long ctas = (static_cast<long long>(window) + per_cta - 1) /
                         per_cta;
  const size_t smem = words != nullptr && n_active > 1
                          ? static_cast<size_t>(n_words) * 4 : 0;
  if (window < 1 || budget < 1 || nb < 1 || lap_end < nb ||
      ctas >= (1ll << kArriveBits) || (words != nullptr && n_active < 1) ||
      smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HeadArgs h{order_pad, static_ok, words, active, pos, go, nb,
                   lap_end, n_words, n_active, window, budget, wrap != 0,
                   ok, flags, new_pos, blk, tvalid, status};
  const unsigned grid = static_cast<unsigned>(ctas);
  if (by_warp) {
    round_head_kernel<true><<<grid, kThreads, smem, s>>>(h);
  } else {
    round_head_kernel<false><<<grid, kThreads, smem, s>>>(h);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by the launch functions above.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
