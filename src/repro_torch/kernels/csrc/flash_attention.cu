// Full-sequence (flash) attention for Hopper: online softmax over key
// tiles, GQA, causal or not, sliding window, ragged lengths.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (_fa_kernel).  Computes, for q (B, Sq, nq, hd) and k, v
// (B, Sk, nkv, hd):
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / g]) v[b, j, h / g]
// where query i sits at position p = i + Sk - Sq (ends aligned), key j is
// visible iff (not causal or j <= p) and (window == 0 or j > p - window),
// and masked scores take -2**30 as in the plain version.  Rows and keys
// past Sq and Sk are masked here instead of being asserted away, so the
// vocoder's cross-attention (Sq 32 over Sk 16, Sq 16 over Sk 8) runs as is.
//
// Bound: at the vocoder's shapes, launch latency; at long sequences, the
// arithmetic (4 * Sq * Sk * hd FLOPs per head against 2 * (Sq + Sk) * hd
// elements moved).  This first version does the arithmetic in f32 on the
// CUDA cores for both f32 and bf16 inputs (no TF32: f32 parity is held at
// 2e-5), and keeps everything but the K/V tiles out of device memory: one
// CTA per (query tile of 32 rows, query head, batch) reads its K/V tiles
// once into shared memory, four threads share a query row (each holds a
// quarter of head_dim of the query and of the f32 accumulator in
// registers), and key tiles that are masked for every row of the tile are
// skipped.  Tensor-core (wgmma) tiles with TMA loads are the next step.
// Inputs are read through their strides in the (B, S, H, hd) layout; only
// head_dim must be contiguous.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kRowThreads = 4;                     // threads sharing one query row
constexpr int kBlockQ = kThreads / kRowThreads;    // 32 query rows per CTA
constexpr int kBlockK = 32;                        // keys per shared-memory tile

struct Strides {
  int64_t b, s, h;  // elements; head_dim stride is 1
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int sq, int sk, int nq, int nkv, Strides qs, Strides ks,
    Strides vs, int causal, int window, float scale) {
  constexpr int kChunks = HD / (4 * kRowThreads);  // float4 chunks per thread
  constexpr int kDims = kChunks * 4;                 // head_dim slice per thread
  __shared__ __align__(16) float k_s[kBlockK * HD];
  __shared__ __align__(16) float v_s[kBlockK * HD];

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int part = tid % kRowThreads;
  const int i = tile * kBlockQ + row;
  const bool row_valid = i < sq;
  const int shift = sk - sq;
  const int qpos = i + shift;

  // this thread's dims: d = c * 16 + part * 4 + e, c < kChunks, e < 4
  float qr[kDims];
  float acc[kDims];
  const T* qp = q + b * qs.b + static_cast<int64_t>(i) * qs.s + h * qs.h;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = c * 16 + part * 4 + e;
      qr[c * 4 + e] = row_valid ? to_f32(qp[d]) * scale : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // key range: skipping tiles is exact only when every row of this tile
  // has a visible key (a causal row at a negative position has none and
  // averages V over all keys, as the plain version does)
  const int pos_lo = tile * kBlockQ + shift;
  const int pos_hi = min(tile * kBlockQ + kBlockQ, sq) - 1 + shift;
  int j_begin = 0;
  int j_end = sk;
  if (!causal || pos_lo >= 0) {
    if (causal) j_end = min(sk, pos_hi + 1);
    if (window > 0) j_begin = max(0, pos_lo - window + 1);
  }
  j_begin = (j_begin / kBlockK) * kBlockK;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int j0 = j_begin; j0 < j_end; j0 += kBlockK) {
    for (int idx = tid; idx < kBlockK * HD; idx += kThreads) {
      const int jj = idx / HD;
      const int d = idx % HD;
      const int j = j0 + jj;
      float kx = 0.f;
      float vx = 0.f;
      if (j < sk) {
        kx = to_f32(kb[static_cast<int64_t>(j) * ks.s + d]);
        vx = to_f32(vb[static_cast<int64_t>(j) * vs.s + d]);
      }
      k_s[idx] = kx;
      v_s[idx] = vx;
    }
    __syncthreads();

    float s[kBlockK];
    float mt = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBlockK; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kv4 = *reinterpret_cast<const float4*>(&k_s[jj * HD + c * 16 + part * 4]);
        dot += qr[c * 4 + 0] * kv4.x + qr[c * 4 + 1] * kv4.y + qr[c * 4 + 2] * kv4.z +
               qr[c * 4 + 3] * kv4.w;
      }
      // the four threads of a row are adjacent lanes
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int j = j0 + jj;
      float sc;
      if (j >= sk) {
        sc = -__int_as_float(0x7f800000);  // -inf: padding past Sk is excluded, not masked
      } else {
        const bool visible = (!causal || j <= qpos) && (window <= 0 || j > qpos - window);
        sc = visible ? dot : kNegInf;
      }
      s[jj] = sc;
      mt = fmaxf(mt, sc);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int x = 0; x < kDims; ++x) acc[x] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kBlockK; ++jj) {
      const float p = expf(s[jj] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 v4 = *reinterpret_cast<const float4*>(&v_s[jj * HD + c * 16 + part * 4]);
        acc[c * 4 + 0] += p * v4.x;
        acc[c * 4 + 1] += p * v4.y;
        acc[c * 4 + 2] += p * v4.z;
        acc[c * 4 + 3] += p * v4.w;
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (row_valid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = out + ((static_cast<int64_t>(b) * sq + i) * nq + h) * HD;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) store_f32(op + c * 16 + part * 4 + e, acc[c * 4 + e] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int sq,
           int sk, int nq, int nkv, Strides qs, Strides ks, Strides vs, int causal,
           int window, float scale, cudaStream_t stream) {
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, nq, batch);
  flash_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, nq, nkv, qs, ks, vs, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out, int batch,
              int sq, int sk, int nq, int nkv, Strides qs, Strides ks, Strides vs,
              int causal, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal, window,
                           scale, stream);
    case 80:  // Zamba2's shared attention; 5 float4 chunks per thread, 20 KB of K/V tiles
      return launch<T, 80>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal, window,
                            scale, stream);
    default:
      return kBadHeadDim;
  }
}

}  // namespace
}  // namespace repro

// q: (B, Sq, nq, hd), k/v: (B, Sk, nkv, hd), all in `dtype`, addressed by
// the given (batch, seq, head) strides in elements with head_dim
// contiguous; out: contiguous (B, Sq, nq, hd) in `dtype`.
// Returns 0, a cudaError_t, or a negative repro::ArgError.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int sq, int sk, int nq, int nkv, int hd,
                                      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                                      int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                      int64_t v_sh, int dtype, int causal, int window,
                                      float scale, void* stream) {
  using namespace repro;
  if (nkv <= 0 || nq % nkv != 0) return kBadGroup;
  if (batch <= 0 || sq <= 0 || sk <= 0) return kBadShape;
  const Strides qs{q_sb, q_ss, q_sh};
  const Strides ks{k_sb, k_ss, k_sh};
  const Strides vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_hd<float>(hd, q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal,
                            window, scale, s);
  if (dtype == kBF16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs,
                                    causal, window, scale, s);
  return kBadDType;
}
