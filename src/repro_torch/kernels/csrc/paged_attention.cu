// One-token decode attention over a block-paged KV pool, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:
// paged_attention (_pa_kernel, _pa_kernel_quant).  Computes, for every
// sequence b and query head h (kv head h / g):
//   out[b, h] = softmax_t(scale * q[b, h] . K[t]) V[t]
// over the tokens t < seq_lens[b] (and t > seq_lens[b] - 1 - window when
// window > 0), reading token t from page block_tables[b, t / page], slot
// t % page.  int8 pools are dequantized with their per-(page, slot, head)
// f32 scale as each element is loaded.
//
// Bound: device-memory bytes.  Every K/V element of a visible token is
// read once and used for g query rows, so the kernel does ~2g FLOPs per
// byte read, far below the card's ~295 FLOP/byte ridge.  The design
// therefore reads each visible token once per (sequence, kv head) and
// nothing else: one CTA per (kv head, sequence) loads the g query rows
// once and walks the visible tokens in tiles of kTile tokens (several
// pages: the page of each token comes from the block table), staging each
// tile's K and V in shared memory with 16-byte loads, and keeping the
// online-softmax state and the f32 accumulator on chip.  Tokens at or past
// seq_len are never read, so a row with seq_len 0 (an inactive decode
// slot) comes out as zeros; the plain version averages V there instead.
// Both are finite, and the serving path discards them.  With one CTA per
// (sequence, kv head) a small batch leaves most SMs idle: splitting the
// tokens of a row over several CTAs (flash-decoding) is the next step.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // tokens staged in shared memory per step
constexpr int kMaxGroup = 16;  // query heads per kv head held by one CTA

// 16 bytes of KT at p (16-byte aligned), widened to f32
template <typename KT>
__device__ __forceinline__ void load16(const KT* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(KT)); ++i) out[i] = to_f32(e[i]);
}

template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, QT* __restrict__ out, int nq, int nkv,
    int page, int pp, int window, float scale) {
  constexpr int kVec = 16 / sizeof(KT);   // elements per 16-byte load
  constexpr int kChunks = HD / kVec;      // 16-byte chunks per token row
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // sequence
  const int g = nq / nkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;               // (kTile, HD)
  float* v_s = k_s + kTile * HD;   // (kTile, HD)
  float* q_s = v_s + kTile * HD;   // (g, HD)   pre-scaled queries
  float* p_s = q_s + g * HD;       // (g, kTile) scores, then probabilities
  float* m_s = p_s + g * kTile;    // (g,) running max
  float* l_s = m_s + g;            // (g,) running sum
  float* a_s = l_s + g;            // (g,) rescale factor of this tile

  const int seq_len = seq_lens[b];
  const QT* qb = q + (static_cast<int64_t>(b) * nq + static_cast<int64_t>(h) * g) * HD;
  for (int i = tid; i < g * HD; i += kThreads) q_s[i] = to_f32(qb[i]) * scale;
  for (int r = tid; r < g; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  constexpr int kAcc = (kMaxGroup * HD + kThreads - 1) / kThreads;  // slots per thread
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // only visible tokens are read; a tile starts on the first visible one
  const int first_tok = window > 0 ? max(0, seq_len - window) : 0;
  const int* bt = block_tables + static_cast<int64_t>(b) * pp;
  __syncthreads();

  for (int tile0 = first_tok; tile0 < seq_len; tile0 += kTile) {
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int t = i / kChunks;
      const int c = i % kChunks;
      const int tok = tile0 + t;
      float kx[kVec];
      float vx[kVec];
      if (tok < seq_len) {
        const int64_t row = (static_cast<int64_t>(bt[tok / page]) * page + tok % page) * nkv + h;
        load16(k_pages + row * HD + c * kVec, kx);
        load16(v_pages + row * HD + c * kVec, vx);
        if (k_scales != nullptr) {
          const float ks = k_scales[row];
          const float vs = v_scales[row];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            kx[e] *= ks;
            vx[e] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[t * HD + c * kVec + e] = kx[e];
        v_s[t * HD + c * kVec + e] = vx[e];
      }
    }
    __syncthreads();

    // scores: one warp per (row, token) pair, lanes split head_dim
    for (int pr = warp; pr < g * kTile; pr += kWarps) {
      const int r = pr / kTile;
      const int t = pr % kTile;
      float s = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32) s += q_s[r * HD + d] * k_s[t * HD + d];
      s = warp_sum(s);
      if (lane == 0) p_s[r * kTile + t] = tile0 + t < seq_len ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int r = warp; r < g; r += kWarps) {
      const float m_prev = m_s[r];
      float mt = kNegInf;
      for (int t = lane; t < kTile; t += 32) mt = fmaxf(mt, p_s[r * kTile + t]);
      const float m_new = fmaxf(m_prev, warp_max(mt));
      float ls = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        // tokens past seq_len do not exist: weight 0 (not exp(-2**30 - m))
        const float p = tile0 + t < seq_len ? expf(p_s[r * kTile + t] - m_new) : 0.f;
        p_s[r * kTile + t] = p;
        ls += p;
      }
      ls = warp_sum(ls);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + ls;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // accumulator: thread owns elements e = tid + i * kThreads of (g, HD)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < g * HD) {
        const int r = e / HD;
        const int d = e % HD;
        float a = acc[i] * a_s[r];
#pragma unroll 8
        for (int t = 0; t < kTile; ++t) a += p_s[r * kTile + t] * v_s[t * HD + d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  QT* ob = out + (static_cast<int64_t>(b) * nq + static_cast<int64_t>(h) * g) * HD;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < g * HD) store_f32(ob + e, acc[i] / fmaxf(l_s[e / HD], 1e-30f));
  }
}

template <typename QT, typename KT, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scales, const float* v_scales, const int* block_tables,
           const int* seq_lens, void* out, int batch, int nq, int nkv, int page,
           int pp, int window, float scale, cudaStream_t stream) {
  const int g = nq / nkv;
  const size_t smem = sizeof(float) * (2 * kTile * HD + static_cast<size_t>(g) * HD +
                                       g * kTile + 3 * g);
  auto kernel = paged_attention_kernel<QT, KT, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(nkv, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), k_scales, v_scales, block_tables, seq_lens,
      static_cast<QT*>(out), nq, nkv, page, pp, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_hd(int hd, const void* q, const void* k_pages, const void* v_pages,
              const float* k_scales, const float* v_scales, const int* block_tables,
              const int* seq_lens, void* out, int batch, int nq, int nkv, int page,
              int pp, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<QT, KT, 32>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                seq_lens, out, batch, nq, nkv, page, pp, window, scale,
                                stream);
    case 64:
      return launch<QT, KT, 64>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                seq_lens, out, batch, nq, nkv, page, pp, window, scale,
                                stream);
    case 128:
      return launch<QT, KT, 128>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                 seq_lens, out, batch, nq, nkv, page, pp, window, scale,
                                 stream);
    default:
      return kBadHeadDim;
  }
}

}  // namespace
}  // namespace repro

// q: (B, nq, hd) in q_dtype; k/v_pages: (P, page, nkv, hd) in kv_dtype,
// contiguous and 16-byte aligned; k/v_scales: (P, page, nkv) f32 for int8
// pools, else null; block_tables: (B, pp) int32; seq_lens: (B,) int32;
// out like q.  Returns 0, a cudaError_t, or a negative repro::ArgError.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const float* k_scales,
                                      const float* v_scales, const int* block_tables,
                                      const int* seq_lens, void* out, int batch, int nq,
                                      int nkv, int hd, int page, int pp, int q_dtype,
                                      int kv_dtype, int window, float scale,
                                      void* stream) {
  using namespace repro;
  if (nkv <= 0 || nq % nkv != 0 || nq / nkv > kMaxGroup) return kBadGroup;
  if (page <= 0 || pp <= 0 || batch <= 0) return kBadShape;
  if ((kv_dtype == kI8) != (k_scales != nullptr && v_scales != nullptr)) return kBadDType;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_hd<float, float>(hd, q, k_pages, v_pages, nullptr, nullptr, block_tables,
                                   seq_lens, out, batch, nq, nkv, page, pp, window, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k_pages, v_pages, nullptr, nullptr,
                                                   block_tables, seq_lens, out, batch, nq, nkv,
                                                   page, pp, window, scale, s);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_hd<float, int8_t>(hd, q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                    seq_lens, out, batch, nq, nkv, page, pp, window, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_hd<__nv_bfloat16, int8_t>(hd, q, k_pages, v_pages, k_scales, v_scales,
                                            block_tables, seq_lens, out, batch, nq, nkv, page,
                                            pp, window, scale, s);
  return kBadDType;
}
