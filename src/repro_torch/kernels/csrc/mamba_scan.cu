// Mamba1 selective scan for Hopper: each channel's states split over four
// lanes, and the sequence cut into chunks that run in parallel.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py: mamba1_scan
// (_scan_kernel).  Computes, for x, dt (Bt, S, di), A (di, n), B, C
// (Bt, S, n), D (di,) and an optional initial state h0 (Bt, di, n):
//   h[b, d, :] <- exp(dt[b, t, d] * A[d, :]) * h[b, d, :] + dt[b, t, d] * B[b, t, :] * x[b, t, d]
//   y[b, t, d]  = sum_i h[b, d, i] * C[b, t, i] + D[d] * x[b, t, d]
// in f32, with y stored in the type of x and the last state in f32.  A null
// h0 means zeros.  Any S >= 1 and any 1 <= n <= 16 is taken (the Pallas
// kernel asserts that its sequence block divides S; serving prefill passes
// whatever prompt length arrives, and decode passes S = 1).
//
// Bound: per (t, channel, state) the step does 8 f32 operations (dt * A,
// exp, * h, dt * B, * x, +, * C, + into y; exp counted as one) on states
// that never leave the chip, against x, dt and y moved once per
// (t, channel), B and C once per t, and h0/h_last once per (channel,
// state).  At n 16 that is 128 operations per 12 bytes of f32 or 6 bytes
// of bf16 x/dt/y, about the card's balance of 20 f32 operations per byte:
// prefill is bound by bytes in f32, decode (S 1) by the state's 128 bytes
// per channel.  What a scan is really limited by is the dependence of each
// step on the last: one thread per channel over all of S would leave half
// the SMs idle at prefill's batch of 1 (64 CTAs of 128 channels) and run
// 1000 dependent steps per thread, and 16 states per thread would make
// every load of h0 and store of h_last touch 32 segments per warp.
//
// Design:
// - Four lanes per channel, four states each (lane q holds states 4q ..
//   4q + 3; lanes past n hold zeros and are never stored).  A CTA of 128
//   threads owns 32 consecutive channels of one batch row.  h0, h_last,
//   A and the chunk states move as 16-byte vectors, consecutive across a
//   warp; y is the sum of the four lanes' partial dot products (two
//   __shfl_xor_sync).  x and dt of a tile of 64 steps are staged in
//   shared memory coalesced across the CTA's channels, B and C (scalar
//   loads: their column slices need not be 16-byte aligned) zero-padded
//   to 16 states; y is staged and written back coalesced.
// - Chunks.  S is cut into chunks of L steps (the wrapper's plan: 64,
//   widened in steps of 64 to at most 32 chunks).  When S <= L one
//   launch of mamba1_scan_kernel does the whole scan from h0 and needs no
//   scratch.  Otherwise three passes:
//   1. mamba1_chunk_state_kernel scans every chunk but the last from a
//      zero state, keeping its end state and its decay, the running
//      product of the per-step factors expf(dt A), built step by step as
//      the sequential scan multiplies them;
//   2. mamba1_chunk_carry_kernel carries the true start state over the
//      chunks in order: start[c + 1] = decay[c] * start[c] + end[c],
//      written over end[c];
//   3. mamba1_scan_kernel reruns every chunk from its start state, writes
//      y, and writes h_last from the last chunk.
//   kernels/ref.py: mamba1_scan_chunked computes in this order.  The
//   passes add to the bytes: the chunk states (end and decay, written,
//   read and rewritten by the carry, read once more), and x, dt and B
//   read a second time (C only in pass 3).
// - At S = 1 (decode, 64 launches per step) mamba1_step_kernel does the
//   one step with nothing staged: each thread loads its A and D once and
//   the inputs of four batch rows before it computes, so the state moves
//   in one wave of CTAs with one memory latency exposed (at Falcon's
//   decode shape, 2048 CTAs of 32 KB staged tiles would take two waves).
// x, dt, B and C are read through their (batch, sequence) strides with
// the last dimension contiguous: the model passes column slices of its
// projections (xs of xz, B and C of x_proj's output) without a copy.  y
// and h_last are contiguous.  Uses expf (not __expf): f32 results are held
// to 2e-5 of the plain version.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kLanes = 4;                      // lanes per channel
constexpr int kLaneStates = 4;                 // states per lane
constexpr int kMaxState = kLanes * kLaneStates;  // n up to 16; others are refused
constexpr int kThreads = 128;
constexpr int kChannels = kThreads / kLanes;   // 32 channels per CTA
constexpr int kTile = 64;                      // steps staged in shared memory at a time

struct SeqStrides {
  int64_t b, s;  // elements; the last dimension is contiguous
};

// Where this thread's states live: channel d of batch row b, lane q.
struct Lane {
  int b, d, q;
  bool live;    // d < di
  bool states;  // live and lane q holds at least one state (4 q < n)
};

__device__ __forceinline__ Lane this_lane(int di, int n) {
  Lane ln;
  ln.b = blockIdx.z;
  ln.d = blockIdx.x * kChannels + threadIdx.x / kLanes;
  ln.q = threadIdx.x % kLanes;
  ln.live = ln.d < di;
  ln.states = ln.live && ln.q * kLaneStates < n;
  return ln;
}

// Four f32 values of a (rows, n)-shaped array at row `row`, states 4q ..
// 4q + 3 (zeros past n); `vec`: n % 4 == 0 and the base is 16-byte
// aligned, so one vector load does it.
__device__ __forceinline__ void load4(float (&v)[4], const float* p, int64_t row, int n,
                                      int q, bool vec) {
  if (vec) {
    const float4 w = *reinterpret_cast<const float4*>(p + row * n + q * kLaneStates);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kLaneStates; ++k) {
    const int i = q * kLaneStates + k;
    v[k] = i < n ? p[row * n + i] : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4], int64_t row, int n,
                                       int q, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p + row * n + q * kLaneStates) =
        make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kLaneStates; ++k) {
    const int i = q * kLaneStates + k;
    if (i < n) p[row * n + i] = v[k];
  }
}

// Chunk scratch: end states, then decays, each (Bt, chunks - 1, di, np4)
// f32 with np4 = n rounded up to 4, so every lane's slot is a vector.
__device__ __forceinline__ float4* chunk_slot(float* scratch, int b, int c, int d, int q,
                                              int chunks, int di, int np4) {
  const int64_t row = (static_cast<int64_t>(b) * (chunks - 1) + c) * di + d;
  return reinterpret_cast<float4*>(scratch + row * np4 + q * kLaneStates);
}

// Shared tiles of one chunk: x and dt (and y) by (step, channel), B and C
// by (step, state) zero-padded to 16 states.
struct Tiles {
  float x[kTile][kChannels];
  float dt[kTile][kChannels];
  float y[kTile][kChannels];
  __align__(16) float b[kTile][kMaxState];
  __align__(16) float c[kTile][kMaxState];
};

template <typename T>
__device__ __forceinline__ void stage(Tiles& s, const T* x, const T* dt, const T* B,
                                      const T* C, int b, int t0, int len, int d0, int di,
                                      int n, SeqStrides xs, SeqStrides dts, SeqStrides bs,
                                      SeqStrides cs, bool with_c) {
  for (int idx = threadIdx.x; idx < len * kChannels; idx += kThreads) {
    const int tt = idx / kChannels;
    const int ch = idx % kChannels;
    const int64_t t = t0 + tt;
    const int d = d0 + ch;
    const bool ok = d < di;
    s.x[tt][ch] = ok ? to_f32(x[b * xs.b + t * xs.s + d]) : 0.f;
    s.dt[tt][ch] = ok ? to_f32(dt[b * dts.b + t * dts.s + d]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < len * kMaxState; idx += kThreads) {
    const int tt = idx / kMaxState;
    const int i = idx % kMaxState;
    const int64_t t = t0 + tt;
    s.b[tt][i] = i < n ? to_f32(B[b * bs.b + t * bs.s + i]) : 0.f;
    if (with_c) s.c[tt][i] = i < n ? to_f32(C[b * cs.b + t * cs.s + i]) : 0.f;
  }
}

// The state update and the lane's share of y at one step (the four
// lanes of a channel are adjacent; lane 0 returns the channel's y).
__device__ __forceinline__ float step(float (&h)[4], const float (&a)[4], const float (&bv)[4],
                                      const float (&cv)[4], float xt, float dtt, float dd) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kLaneStates; ++k) {
    h[k] = expf(dtt * a[k]) * h[k] + dtt * bv[k] * xt;
    acc += h[k] * cv[k];
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc + xt * dd;
}

// Pass 3, and the whole scan when there is one chunk: chunk blockIdx.y
// from its start state (h0 or zeros for chunk 0, the carried state for
// the others), y for its steps, h_last from the last chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads) mamba1_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ h0, const float* __restrict__ starts, T* __restrict__ y,
    float* __restrict__ h_last, int s, int di, int n, int chunk, int vec, SeqStrides xs,
    SeqStrides dts, SeqStrides bs, SeqStrides cs) {
  __shared__ Tiles sh;
  const Lane ln = this_lane(di, n);
  const int c = blockIdx.y;
  const int chunks = gridDim.y;
  const int np4 = (n + kLaneStates - 1) / kLaneStates * kLaneStates;
  const int64_t row = static_cast<int64_t>(ln.b) * di + ln.d;

  float a[kLaneStates] = {0.f, 0.f, 0.f, 0.f};
  float h[kLaneStates] = {0.f, 0.f, 0.f, 0.f};
  if (ln.states) {
    load4(a, A, ln.d, n, ln.q, vec);
    if (c > 0) {
      const float4 w = *chunk_slot(const_cast<float*>(starts), ln.b, c - 1, ln.d, ln.q,
                                   chunks, di, np4);
      h[0] = w.x, h[1] = w.y, h[2] = w.z, h[3] = w.w;
    } else if (h0 != nullptr) {
      load4(h, h0, row, n, ln.q, vec);
    }
  }
  const float dd = ln.live ? D[ln.d] : 0.f;
  const int ch = threadIdx.x / kLanes;
  const int d0 = blockIdx.x * kChannels;
  const int t_end = min(s, (c + 1) * chunk);

  for (int t0 = c * chunk; t0 < t_end; t0 += kTile) {
    const int len = min(kTile, t_end - t0);
    stage(sh, x, dt, B, C, ln.b, t0, len, d0, di, n, xs, dts, bs, cs, true);
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < len; ++tt) {
      const float xt = sh.x[tt][ch];
      const float dtt = sh.dt[tt][ch];
      const float4 bq = *reinterpret_cast<const float4*>(&sh.b[tt][ln.q * kLaneStates]);
      const float4 cq = *reinterpret_cast<const float4*>(&sh.c[tt][ln.q * kLaneStates]);
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
      const float yt = step(h, a, bv, cv, xt, dtt, dd);
      if (ln.q == 0) sh.y[tt][ch] = yt;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < len * kChannels; idx += kThreads) {
      const int tt = idx / kChannels;
      const int d = d0 + idx % kChannels;
      if (d < di)
        store_f32(y + (static_cast<int64_t>(ln.b) * s + t0 + tt) * di + d,
                  sh.y[tt][idx % kChannels]);
    }
  }
  if (c == chunks - 1 && ln.states) store4(h_last, h, row, n, ln.q, vec);
}

// S = 1 (decode): one step, nothing staged.  A CTA owns 32 channels of
// kStepRows batch rows; each thread loads its A and D once, then issues
// the loads of all its rows before it computes any, so the state moves in
// one wave of CTAs as 16-byte vectors with one memory latency exposed.
constexpr int kStepRows = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads) mamba1_step_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_last, int batch,
    int di, int n, int vec, SeqStrides xs, SeqStrides dts, SeqStrides bs, SeqStrides cs) {
  const int d = blockIdx.x * kChannels + threadIdx.x / kLanes;
  const int q = threadIdx.x % kLanes;
  const bool live = d < di;
  const bool states = live && q * kLaneStates < n;
  const int dc = min(d, di - 1);  // a valid channel for the loads of dead lanes
  const int b0 = blockIdx.y * kStepRows;
  float a[kLaneStates] = {0.f, 0.f, 0.f, 0.f};
  if (states) load4(a, A, d, n, q, vec);
  const float dd = D[dc];
  float h[kStepRows][kLaneStates], bv[kStepRows][kLaneStates], cv[kStepRows][kLaneStates];
  float xt[kStepRows], dtt[kStepRows];
#pragma unroll
  for (int r = 0; r < kStepRows; ++r) {
    const int b = min(b0 + r, batch - 1);  // rows past the batch load row batch - 1
#pragma unroll
    for (int k = 0; k < kLaneStates; ++k) {
      h[r][k] = 0.f;
      const int i = min(q * kLaneStates + k, n - 1);
      const bool on = q * kLaneStates + k < n;
      bv[r][k] = on ? to_f32(B[b * bs.b + i]) : 0.f;
      cv[r][k] = on ? to_f32(C[b * cs.b + i]) : 0.f;
    }
    if (states && h0 != nullptr) load4(h[r], h0, static_cast<int64_t>(b) * di + d, n, q, vec);
    xt[r] = to_f32(x[b * xs.b + dc]);
    dtt[r] = to_f32(dt[b * dts.b + dc]);
  }
#pragma unroll
  for (int r = 0; r < kStepRows; ++r) {
    const int b = b0 + r;
    if (b >= batch) continue;  // uniform over the CTA
    const int64_t row = static_cast<int64_t>(b) * di + d;
    const float yt = step(h[r], a, bv[r], cv[r], xt[r], dtt[r], dd);
    if (live && q == 0) store_f32(y + row, yt);
    if (states) store4(h_last, h[r], row, n, q, vec);
  }
}

// Pass 1: every chunk but the last from a zero state; its end state and
// its decay (the product of its steps' expf(dt A)) into the scratch.
template <typename T>
__global__ void __launch_bounds__(kThreads) mamba1_chunk_state_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ B, float* __restrict__ scratch, int chunks, int di, int n,
    int chunk, int vec, SeqStrides xs, SeqStrides dts, SeqStrides bs) {
  __shared__ Tiles sh;
  const Lane ln = this_lane(di, n);
  const int c = blockIdx.y;
  const int np4 = (n + kLaneStates - 1) / kLaneStates * kLaneStates;

  float a[kLaneStates] = {0.f, 0.f, 0.f, 0.f};
  float h[kLaneStates] = {0.f, 0.f, 0.f, 0.f};
  float decay[kLaneStates] = {1.f, 1.f, 1.f, 1.f};
  if (ln.states) load4(a, A, ln.d, n, ln.q, vec);
  const int ch = threadIdx.x / kLanes;
  const int d0 = blockIdx.x * kChannels;
  const int t_end = (c + 1) * chunk;  // not the last chunk: always whole

  for (int t0 = c * chunk; t0 < t_end; t0 += kTile) {
    const int len = min(kTile, t_end - t0);
    stage(sh, x, dt, B, B, ln.b, t0, len, d0, di, n, xs, dts, bs, bs, false);
    __syncthreads();
#pragma unroll 2
    for (int tt = 0; tt < len; ++tt) {
      const float xt = sh.x[tt][ch];
      const float dtt = sh.dt[tt][ch];
      const float4 bq = *reinterpret_cast<const float4*>(&sh.b[tt][ln.q * kLaneStates]);
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int k = 0; k < kLaneStates; ++k) {
        const float dA = expf(dtt * a[k]);
        decay[k] *= dA;
        h[k] = dA * h[k] + dtt * bv[k] * xt;
      }
    }
    __syncthreads();
  }
  if (ln.states) {
    const int64_t half = static_cast<int64_t>(gridDim.z) * (chunks - 1) * di * np4;
    *chunk_slot(scratch, ln.b, c, ln.d, ln.q, chunks, di, np4) =
        make_float4(h[0], h[1], h[2], h[3]);
    *chunk_slot(scratch + half, ln.b, c, ln.d, ln.q, chunks, di, np4) =
        make_float4(decay[0], decay[1], decay[2], decay[3]);
  }
}

// Pass 2: start[c + 1] = decay[c] * start[c] + end[c], in chunk order,
// from start[0] = h0 (or zeros); written over end[c].
__global__ void __launch_bounds__(kThreads) mamba1_chunk_carry_kernel(
    const float* __restrict__ h0, float* __restrict__ scratch, int chunks, int di, int n,
    int vec) {
  const Lane ln = this_lane(di, n);
  if (!ln.states) return;
  const int np4 = (n + kLaneStates - 1) / kLaneStates * kLaneStates;
  const int64_t half = static_cast<int64_t>(gridDim.z) * (chunks - 1) * di * np4;
  float h[kLaneStates] = {0.f, 0.f, 0.f, 0.f};
  if (h0 != nullptr) load4(h, h0, static_cast<int64_t>(ln.b) * di + ln.d, n, ln.q, vec);
  // the loads of a batch of chunks are issued together, so the carry
  // waits for memory once per batch rather than once per chunk
  constexpr int kBatch = 8;
  for (int c0 = 0; c0 < chunks - 1; c0 += kBatch) {
    float4 e[kBatch], g[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < chunks - 1) {
        e[i] = *chunk_slot(scratch, ln.b, c0 + i, ln.d, ln.q, chunks, di, np4);
        g[i] = *chunk_slot(scratch + half, ln.b, c0 + i, ln.d, ln.q, chunks, di, np4);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < chunks - 1) {
        h[0] = g[i].x * h[0] + e[i].x;
        h[1] = g[i].y * h[1] + e[i].y;
        h[2] = g[i].z * h[2] + e[i].z;
        h[3] = g[i].w * h[3] + e[i].w;
        *chunk_slot(scratch, ln.b, c0 + i, ln.d, ln.q, chunks, di, np4) =
            make_float4(h[0], h[1], h[2], h[3]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* B, const void* C,
           const float* D, const float* h0, void* y, float* h_last, float* scratch, int batch,
           int s, int di, int n, int chunk, int vec, SeqStrides xs, SeqStrides dts,
           SeqStrides bs, SeqStrides cs, cudaStream_t stream) {
  const int chunks = (s + chunk - 1) / chunk;
  const int blocks = (di + kChannels - 1) / kChannels;
  const T* xp = static_cast<const T*>(x);
  const T* dtp = static_cast<const T*>(dt);
  const T* bp = static_cast<const T*>(B);
  if (chunks > 1) {
    mamba1_chunk_state_kernel<T><<<dim3(blocks, chunks - 1, batch), kThreads, 0, stream>>>(
        xp, dtp, A, bp, scratch, chunks, di, n, chunk, vec, xs, dts, bs);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    mamba1_chunk_carry_kernel<<<dim3(blocks, 1, batch), kThreads, 0, stream>>>(
        h0, scratch, chunks, di, n, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (s == 1) {
    mamba1_step_kernel<T><<<dim3(blocks, (batch + kStepRows - 1) / kStepRows), kThreads, 0,
                            stream>>>(xp, dtp, A, bp, static_cast<const T*>(C), D, h0,
                                      static_cast<T*>(y), h_last, batch, di, n, vec, xs, dts,
                                      bs, cs);
    return static_cast<int>(cudaGetLastError());
  }
  mamba1_scan_kernel<T><<<dim3(blocks, chunks, batch), kThreads, 0, stream>>>(
      xp, dtp, A, bp, static_cast<const T*>(C), D, h0, scratch, static_cast<T*>(y), h_last, s,
      di, n, chunk, vec, xs, dts, bs, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// x, dt: (Bt, S, di) and B, C: (Bt, S, n), all in `dtype`, addressed by
// the given (batch, seq) strides in elements with the last dimension
// contiguous; A (di, n), D (di,) and h0 (Bt, di, n, or null for zeros):
// contiguous f32.  y: contiguous (Bt, S, di) in `dtype`; h_last:
// contiguous (Bt, di, n) f32.  chunk: steps per chunk; when S > chunk,
// scratch holds 2 * Bt * (ceil(S / chunk) - 1) * di * (n rounded up to 4)
// f32 (otherwise it may be null).  Returns 0, a cudaError_t, or a
// negative repro::ArgError.
extern "C" int mamba1_scan_launch(const void* x, const void* dt, const void* A,
                                  const void* B, const void* C, const void* D,
                                  const void* h0, void* y, void* h_last, void* scratch,
                                  int batch, int s, int di, int n, int chunk, int64_t x_sb,
                                  int64_t x_ss, int64_t dt_sb, int64_t dt_ss, int64_t b_sb,
                                  int64_t b_ss, int64_t c_sb, int64_t c_ss, int dtype,
                                  void* stream) {
  using namespace repro;
  if (batch <= 0 || s <= 0 || di <= 0 || chunk <= 0 || batch > 65535) return kBadShape;
  const int chunks = (s + chunk - 1) / chunk;
  if (chunks > 65535 || (chunks > 1 && scratch == nullptr)) return kBadShape;
  if (n < 1 || n > kMaxState) return kBadState;
  const SeqStrides xs{x_sb, x_ss};
  const SeqStrides dts{dt_sb, dt_ss};
  const SeqStrides bs{b_sb, b_ss};
  const SeqStrides cs{c_sb, c_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* dd = static_cast<const float*>(D);
  const float* h = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  float* sc = static_cast<float*>(scratch);
  // 16-byte vectors for A, h0 and h_last when a lane's four states are
  // whole and aligned
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = n % kLaneStates == 0 && aligned(A) && aligned(h_last) &&
                  (h0 == nullptr || aligned(h0));
  if (dtype == kF32)
    return launch<float>(x, dt, a, B, C, dd, h, y, hl, sc, batch, s, di, n, chunk, vec, xs,
                         dts, bs, cs, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, dt, a, B, C, dd, h, y, hl, sc, batch, s, di, n, chunk, vec,
                                 xs, dts, bs, cs, st);
  return kBadDType;
}
