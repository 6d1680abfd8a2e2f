// Mamba1 selective scan for Hopper: one thread per channel, sequential
// over the sequence, the recurrent state in registers.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py: mamba1_scan
// (_scan_kernel).  Computes, for x, dt (Bt, S, di), A (di, n), B, C
// (Bt, S, n), D (di,) and an optional initial state h0 (Bt, di, n):
//   h[b, d, :] <- exp(dt[b, t, d] * A[d, :]) * h[b, d, :] + dt[b, t, d] * B[b, t, :] * x[b, t, d]
//   y[b, t, d]  = sum_i h[b, d, i] * C[b, t, i] + D[d] * x[b, t, d]
// in f32, with y stored in the type of x and the last state in f32.  A null
// h0 means zeros.  Any S >= 1 is taken (the Pallas kernel asserts that its
// sequence block divides S; serving prefill passes whatever prompt length
// arrives, and decode passes S = 1).
//
// Bound: per (t, channel, state) the step does 8 f32 operations (dt * A,
// exp, * h, dt * B, * x, +, * C, + into y; exp counted as one) on states
// that never leave the chip, against x, dt and y moved once per
// (t, channel), B and C once per t, and h0/h_last once per (channel,
// state).  At n 16 that is 128 operations per 12 bytes of f32 or 6 bytes
// of bf16 x/dt/y, about the card's balance of 20 f32 operations per byte:
// prefill is bound by bytes in f32, decode (S 1) by the state's 128 bytes
// per channel.  The scan is sequential in t, so what limits this first
// version is the latency of each thread's dependent steps and, at
// prefill's batch of 1, the number of CTAs: ceil(di / 128) per batch row.
//
// Design: a CTA of 128 threads owns 128 consecutive channels of one batch
// row; each thread keeps its n states, its row of A and D in registers.
// The CTA stages B_t and C_t of a chunk of 64 timesteps in shared memory,
// where every channel of the row reads them; x and dt are read, and y is
// written, coalesced across the channels of a warp.  h_last is written
// once at the end.  x, dt, B and C are read through their (batch,
// sequence) strides with the last dimension contiguous: the model passes
// column slices of its projections (xs of xz, B and C of x_proj's output)
// without a copy.  y and h_last are contiguous.  Uses expf (not __expf):
// f32 results are held to 2e-5 of the plain version.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;     // channels per CTA
constexpr int kChunk = 64;        // timesteps of B and C staged per pass
constexpr int kMaxState = 16;     // n up to this; other values are refused

struct SeqStrides {
  int64_t b, s;  // elements; the last dimension is contiguous
};

template <typename T>
__global__ void __launch_bounds__(kThreads) mamba1_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_last, int s,
    int di, int n, SeqStrides xs, SeqStrides dts, SeqStrides bs, SeqStrides cs) {
  __shared__ float b_s[kChunk * kMaxState];
  __shared__ float c_s[kChunk * kMaxState];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;

  float h[kMaxState];
  float a[kMaxState];
#pragma unroll
  for (int i = 0; i < kMaxState; ++i) {
    const bool use = live && i < n;
    const int64_t hi = (static_cast<int64_t>(b) * di + d) * n + i;
    a[i] = use ? A[static_cast<int64_t>(d) * n + i] : 0.f;
    h[i] = (use && h0 != nullptr) ? h0[hi] : 0.f;
  }
  const float dd = live ? D[d] : 0.f;

  const T* xb = x + b * xs.b + d;
  const T* dtb = dt + b * dts.b + d;
  const T* bb = B + b * bs.b;
  const T* cb = C + b * cs.b;
  T* yb = y + (static_cast<int64_t>(b) * s) * di + d;

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int len = min(kChunk, s - t0);
    for (int idx = threadIdx.x; idx < len * n; idx += kThreads) {
      const int tt = idx / n;
      const int i = idx % n;
      const int64_t t = t0 + tt;
      b_s[tt * kMaxState + i] = to_f32(bb[t * bs.s + i]);
      c_s[tt * kMaxState + i] = to_f32(cb[t * cs.s + i]);
    }
    __syncthreads();
    if (live) {
      for (int tt = 0; tt < len; ++tt) {
        const int64_t t = t0 + tt;
        const float xt = to_f32(xb[t * xs.s]);
        const float dtt = to_f32(dtb[t * dts.s]);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxState; ++i) {
          if (i < n) {
            const float dbx = dtt * b_s[tt * kMaxState + i] * xt;
            h[i] = expf(dtt * a[i]) * h[i] + dbx;
            acc += h[i] * c_s[tt * kMaxState + i];
          }
        }
        store_f32(yb + t * di, acc + xt * dd);
      }
    }
    __syncthreads();
  }

  if (live) {
    float* hp = h_last + (static_cast<int64_t>(b) * di + d) * n;
#pragma unroll
    for (int i = 0; i < kMaxState; ++i) {
      if (i < n) hp[i] = h[i];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* B, const void* C,
           const float* D, const float* h0, void* y, float* h_last, int batch, int s, int di,
           int n, SeqStrides xs, SeqStrides dts, SeqStrides bs, SeqStrides cs,
           cudaStream_t stream) {
  dim3 grid((di + kThreads - 1) / kThreads, batch);
  mamba1_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(B),
      static_cast<const T*>(C), D, h0, static_cast<T*>(y), h_last, s, di, n, xs, dts, bs,
      cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// x, dt: (Bt, S, di) and B, C: (Bt, S, n), all in `dtype`, addressed by
// the given (batch, seq) strides in elements with the last dimension
// contiguous; A (di, n), D (di,) and h0 (Bt, di, n, or null for zeros):
// contiguous f32.  y: contiguous (Bt, S, di) in `dtype`; h_last:
// contiguous (Bt, di, n) f32.  Returns 0, a cudaError_t, or a negative
// repro::ArgError.
extern "C" int mamba1_scan_launch(const void* x, const void* dt, const void* A,
                                  const void* B, const void* C, const void* D,
                                  const void* h0, void* y, void* h_last, int batch, int s,
                                  int di, int n, int64_t x_sb, int64_t x_ss, int64_t dt_sb,
                                  int64_t dt_ss, int64_t b_sb, int64_t b_ss, int64_t c_sb,
                                  int64_t c_ss, int dtype, void* stream) {
  using namespace repro;
  if (batch <= 0 || s <= 0 || di <= 0 || batch > 65535) return kBadShape;
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
  if (dtype == kF32)
    return launch<float>(x, dt, a, B, C, dd, h, y, hl, batch, s, di, n, xs, dts, bs, cs, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, dt, a, B, C, dd, h, y, hl, batch, s, di, n, xs, dts, bs,
                                 cs, st);
  return kBadDType;
}
