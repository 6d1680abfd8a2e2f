// Gradient of full-sequence (flash) attention for Hopper: FlashAttention-2's
// backward, recomputing the scores, with GQA, causal or not, sliding
// window and ragged lengths.
//
// Replaces the backward of the Pallas TPU kernel's custom VJP,
// repro/kernels/ops.py: flash_attention_trainable (_fa_bwd), which
// differentiates the jnp oracle.  For q (B, S, nq, hd), k, v (B, S, nkv,
// hd), the forward's output o and its gradient dO (both (B, S, nq, hd)),
// with query i and key j at positions i and j (Sq == Sk: the only shape a
// training forward gives it), key j visible to query i iff (not causal or
// j <= i) and (window == 0 or j > i - window):
//   S = scale q k^T, lse = logsumexp_j S, P = exp(S - lse),
//   D = rowsum(dO * o), dV = P^T dO, dP = dO V^T, dS = P * (dP - D),
//   dQ = scale dS K, dK = scale dS^T Q,
// dK and dV summed over each kv head's group of query heads.  Masked
// scores have P = 0 exactly, as the plain version's -2**30 gives.  The
// outputs are contiguous (B, S, nq|nkv, hd) tensors in the input type;
// lse and D go through an f32 scratch of (B, nq, S) each, lse in log2
// units.
//
// Bound: the arithmetic.  Five products of 2 * S * S * hd operations per
// head (the recomputed S, dV, dP, dQ, dK; half of that when causal), plus
// one more for the recomputed lse (the serving forward does not write
// it), against about 4 * S * hd elements read and 3 * S * hd written per
// head: far above the card's ~295 operations per byte, so only the tensor
// cores can approach the bound.
//
// Design, FA2's deterministic split into three kernels, none with atomics:
//
// 1. flash_attention_bwd_rows_kernel<HD, false>: one CTA per (64-row query
//    tile, query head, batch), four warps of 16 rows.  Each warp keeps its
//    Q rows as mma A fragments in registers, walks the key tiles (32 keys,
//    double-buffered in shared memory by cp.async) and keeps the online
//    row max and sum of the scaled scores: lse.  D comes from the rows of
//    o and dO, one warp-wide dot product per row.
// 2. flash_attention_bwd_kv_kernel<HD>: one CTA per (64-key tile, kv
//    head, batch), each warp 16 keys.  K and V stay in shared memory (A
//    fragments are read from there: in registers next to the dK and dV
//    accumulators they would spill at hd 128); the CTA walks every query
//    head of the group and every query tile of 32 rows that sees its keys
//    (Q, dO, lse and D double-buffered).  Per tile: S^T = K Q^T, P^T from
//    lse, dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q.
// 3. flash_attention_bwd_rows_kernel<HD, true>: the query tiles of (1)
//    again, Q and dO as A fragments in registers, K and V tiles walked as
//    in (1): S, P from lse, dP = dO V^T, dS, dQ += dS K.
//
// bf16 (every head_dim) runs all three on the tensor cores through
// warp-level mma.sync m16n8k16 with f32 accumulators, as the forward's
// mma route does: B operands laid as (n, k) rows are read as 32-bit
// pairs, those laid as (k, n) rows through ldmatrix.trans; the C
// fragment of one product is packed to bf16 as the A fragment of the next
// (P^T and dS^T, whose k dimension is then the queries; dS in (3)).
// Shared rows are padded by 8 bf16 so that fragment reads and ldmatrix
// phases are free of bank conflicts.  f32 runs the same three passes on
// the CUDA cores (the _simt_ kernels: a warp per query row or per key
// row, exact f32 fused multiply-adds), so it is held to the f32
// tolerance; f32 trains only the small configurations.

#include <math.h>

#include "common.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  int64_t b, s, h;  // elements; head_dim stride is 1
};

constexpr int kThreads = 128;    // four warps
constexpr int kRows = 64;        // query rows (kernels 1, 3) or keys (kernel 2) per CTA
constexpr int kKeyTile = 32;     // keys per shared tile of kernels 1 and 3
constexpr int kQueryTile = 32;   // query rows per shared tile of kernel 2
constexpr int kPad = 8;          // bf16 padding of a shared row
constexpr int kSimtRows = kThreads / 32;  // rows per CTA of the f32 kernels: a warp each
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int i, int j, int causal, int window) {
  return (!causal || j <= i) && (window <= 0 || j > i - window);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lane l gives the row address of
// matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of one head's (S, hd) slice (row stride ss) into a
// shared tile of rows padded to HD + kPad; rows past s are zeros.  With
// every row on a 16-byte boundary (vec16) the copy is cp.async of 16
// bytes, otherwise element by element.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int s,
                                          int64_t ss, int vec16) {
  constexpr int LD = HD + kPad;
  constexpr int kChunks = HD / 8;
  if (vec16) {
    for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      const int i = r0 + r;
      const int64_t ii = i < s ? i : 0;  // a valid address even when nothing is read
      cp_async16(dst + r * LD + c, src + ii * ss + c, i < s ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
      const int r = idx / HD;
      const int d = idx % HD;
      const int i = r0 + r;
      dst[r * LD + d] = i < s ? src[static_cast<int64_t>(i) * ss + d] : __float2bfloat16(0.f);
    }
  }
}

// A fragments (m16 x k16 per step) of a warp's 16 rows of one head, from
// global memory: a0 (row g, cols 2 t4 + {0, 1}), a1 (row g + 8), a2 and a3
// the same 8 columns on; rows past s are zeros
template <int KQ>
__device__ __forceinline__ void global_a_frags(uint32_t (&f)[KQ][4], const bf16* base,
                                               int64_t ss, const int (&rows)[2], int s, int t4) {
  const bf16* p[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) p[r] = base + static_cast<int64_t>(min(rows[r], s - 1)) * ss;
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1;
      const bool live = rows[r] < s;
      const int d = kq * 16 + 2 * t4 + (e >> 1) * 8;
      f[kq][e] = pack_bf16x2(live ? to_f32(p[r][d]) : 0.f, live ? to_f32(p[r][d + 1]) : 0.f);
    }
  }
}

// The A fragment of rows row, row + 8 and columns col + {0, 1}, col + 8 +
// {0, 1} of a shared tile with rows of LD elements
template <int LD>
__device__ __forceinline__ void smem_a_frag(uint32_t (&a)[4], const bf16* tile, int row,
                                            int col) {
  a[0] = ld32(tile + row * LD + col);
  a[1] = ld32(tile + (row + 8) * LD + col);
  a[2] = ld32(tile + row * LD + col + 8);
  a[3] = ld32(tile + (row + 8) * LD + col + 8);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync kernels
// ---------------------------------------------------------------------------

// kDQ false: lse (log2 units) and D of each query row.  kDQ true: dQ.
template <int HD, bool kDQ>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_rows_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, int s, int nq, int nkv, Strides qs,
    Strides ks, Strides vs, Strides os, Strides dos, int causal, int window, float scale_log2,
    float scale, int vec16) {
  constexpr int BN = kKeyTile;
  constexpr int LD = HD + kPad;
  constexpr int NT = BN / 8;   // n8 tiles of S and dP
  constexpr int DT = HD / 8;   // n8 tiles of dQ
  constexpr int KQ = HD / 16;  // k16 steps of Q K^T and dO V^T
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* tiles = reinterpret_cast<bf16*>(bwd_smem);  // stage st: K at 2 st, V at 2 st + 1

  // longest query tiles first when causal
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row0 = tile * kRows + warp * 16;
  const bool warp_live = row0 < s;
  const int rows[2] = {row0 + g, row0 + g + 8};
  const int64_t lrow = (static_cast<int64_t>(b) * nq + h) * s;  // this head's lse and D

  uint32_t qf[KQ][4];
  global_a_frags<KQ>(qf, q + b * qs.b + h * qs.h, qs.s, rows, s, t4);
  uint32_t df[kDQ ? KQ : 1][4];
  float lse_r[2] = {0.f, 0.f};
  float d_r[2] = {0.f, 0.f};
  if constexpr (kDQ) {
    global_a_frags<KQ>(df, dout + b * dos.b + h * dos.h, dos.s, rows, s, t4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < s) {
        lse_r[r] = lse[lrow + rows[r]];
        d_r[r] = delta[lrow + rows[r]];
      }
    }
  } else {
    // D = rowsum(dO * o), one warp-wide dot product per row
    for (int rr = 0; rr < 16 && row0 + rr < s; ++rr) {
      const int i = row0 + rr;
      const bf16* orow = o + b * os.b + static_cast<int64_t>(i) * os.s + h * os.h;
      const bf16* drow = dout + b * dos.b + static_cast<int64_t>(i) * dos.s + h * dos.h;
      float acc = 0.f;
      for (int d = lane; d < HD; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
      acc = warp_sum(acc);
      if (lane == 0) delta[lrow + i] = acc;
    }
  }

  float acc[kDQ ? DT : 1][4];
#pragma unroll
  for (int dt = 0; dt < (kDQ ? DT : 1); ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  // the keys any row of this CTA sees
  const int r_end = min(tile * kRows + kRows, s);
  const int j_begin = window > 0 ? max(0, tile * kRows - window + 1) / BN * BN : 0;
  const int j_end = causal ? r_end : s;
  const int n_tiles = (j_end - j_begin + BN - 1) / BN;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  if (n_tiles > 0) {
    load_tile<HD, BN>(tiles, kb, j_begin, s, ks.s, vec16);
    if constexpr (kDQ) load_tile<HD, BN>(tiles + BN * LD, vb, j_begin, s, vs.s, vec16);
  }
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = j_begin + it * BN;
    if (it + 1 < n_tiles) {
      bf16* next = tiles + ((it + 1) & 1) * 2 * BN * LD;
      load_tile<HD, BN>(next, kb, j0 + BN, s, ks.s, vec16);
      if constexpr (kDQ) load_tile<HD, BN>(next + BN * LD, vb, j0 + BN, s, vs.s, vec16);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile `it` has landed (the newest group may still fly)
    __syncthreads();
    const bf16* k_s = tiles + (it & 1) * 2 * BN * LD;
    const bf16* v_s = k_s + BN * LD;

    if (warp_live) {
      // S = Q K^T: rows g, g + 8; keys j0 + 8 nt + 2 t4 + {0, 1}
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf16* kr = k_s + (nt * 8 + g) * LD + kq * 16 + 2 * t4;
          mma_bf16(sc[nt], qf[kq], ld32(kr), ld32(kr + 8));
        }
      }
      // scaled to log2 units; masked keys take -2**30, keys past s -inf
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
          sc[nt][e] = j >= s ? -__int_as_float(0x7f800000)
                             : (visible(rows[e >> 1], j, causal, window) ? sc[nt][e] * scale_log2
                                                                         : kNegInf);
        }
      }

      if constexpr (!kDQ) {
        // online max and sum; a row's values sit in the quad of lanes 4g..4g+3
        float mt[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mt[0] = fmaxf(mt[0], fmaxf(sc[nt][0], sc[nt][1]));
          mt[1] = fmaxf(mt[1], fmaxf(sc[nt][2], sc[nt][3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
          l[r] *= exp2f(m[r] - mt[r]);
          m[r] = mt[r];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(sc[nt][e] - m[e >> 1]);
      } else {
        // dP = dO V^T
        float dp[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const bf16* vr = v_s + (nt * 8 + g) * LD + kq * 16 + 2 * t4;
            mma_bf16(dp[nt], df[kq], ld32(vr), ld32(vr + 8));
          }
        }
        // dS = P (dP - D), in place of S
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[nt][e] = exp2f(sc[nt][e] - lse_r[e >> 1]) * (dp[nt][e] - d_r[e >> 1]);
        // dQ += dS K: two S tiles of 8 keys are one A fragment of 16 keys;
        // K's B fragments through ldmatrix.trans, two n8 tiles per instruction
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          const uint32_t a[4] = {pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                                 pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                                 pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                 pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
          const bf16* krow = k_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                             (lane >> 4) * 8;
#pragma unroll
          for (int dt = 0; dt < DT; dt += 2) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, krow + dt * 8);
            mma_bf16(acc[dt], a, bk[0], bk[1]);
            mma_bf16(acc[dt + 1], a, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the load two tiles on
  }
  cp_async_wait_all();

  if (!warp_live) return;
  if constexpr (!kDQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (t4 == 0 && rows[r] < s) lse[lrow + rows[r]] = m[r] + log2f(l[r]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= s) continue;
      bf16* op = dq + ((static_cast<int64_t>(b) * s + rows[r]) * nq + h) * HD + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(op + dt * 8) =
            __floats2bfloat162_rn(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
    }
  }
}

template <int HD>
constexpr size_t rows_smem_bytes() {
  return 4 * kKeyTile * (HD + kPad) * sizeof(bf16);
}

template <int HD>
constexpr size_t kv_smem_bytes() {
  return (2 * kRows + 4 * kQueryTile) * (HD + kPad) * sizeof(bf16) +
         4 * kQueryTile * sizeof(float);
}

// dK and dV of a 64-key tile of one kv head, over every query head of
// its group.  One CTA an SM is all the bounds promise: with none, ptxas
// caps this kernel at 128 registers (hd 64) or 96 (hd 32) and spills.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_kv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int s,
    int nq, int nkv, Strides qs, Strides ks, Strides vs, Strides dos, int causal, int window,
    float scale_log2, float scale, int vec16) {
  constexpr int BQ = kQueryTile;
  constexpr int LD = HD + kPad;
  constexpr int NT = BQ / 8;   // n8 tiles of S^T and dP^T
  constexpr int DT = HD / 8;   // n8 tiles of dK and dV
  constexpr int KQ = HD / 16;  // k16 steps of K Q^T and V dO^T
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(bwd_smem);
  bf16* v_s = k_s + kRows * LD;
  bf16* stages = v_s + kRows * LD;  // stage st: Q at 2 st, dO at 2 st + 1
  float* stats = reinterpret_cast<float*>(stages + 4 * BQ * LD);  // st: lse, then D

  const int c0 = blockIdx.x * kRows;  // ascending: causal key tiles see the most rows first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = nq / nkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int key0 = c0 + warp * 16;
  const bool warp_live = key0 < s;
  const int keys[2] = {key0 + g, key0 + g + 8};

  load_tile<HD, kRows>(k_s, k + b * ks.b + kvh * ks.h, c0, s, ks.s, vec16);
  load_tile<HD, kRows>(v_s, v + b * vs.b + kvh * vs.h, c0, s, vs.s, vec16);
  cp_async_commit();

  // the query rows that see any key of this tile, for each head of the group
  const int c_end = min(c0 + kRows, s);
  const int i_begin = causal ? c0 / BQ * BQ : 0;
  const int i_end = window > 0 ? min(s, c_end - 1 + window) : s;
  const int per_head = (i_end - i_begin + BQ - 1) / BQ;
  const int total = group * per_head;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[dt][e] = 0.f;
      dva[dt][e] = 0.f;
    }

  for (int it = -1; it < total; ++it) {
    if (it + 1 < total) {  // stage the next query tile: Q, dO, lse, D
      const int nx = it + 1;
      const int h = kvh * group + nx / per_head;
      const int i0 = i_begin + (nx % per_head) * BQ;
      bf16* qt = stages + (nx & 1) * 2 * BQ * LD;
      load_tile<HD, BQ>(qt, q + b * qs.b + h * qs.h, i0, s, qs.s, vec16);
      load_tile<HD, BQ>(qt + BQ * LD, dout + b * dos.b + h * dos.h, i0, s, dos.s, vec16);
      float* st = stats + (nx & 1) * 2 * BQ;
      const int64_t lrow = (static_cast<int64_t>(b) * nq + h) * s;
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int i = i0 + r;
        st[r] = i < s ? lse[lrow + i] : 0.f;
        st[BQ + r] = i < s ? delta[lrow + i] : 0.f;
      }
    }
    cp_async_commit();
    if (it < 0) continue;
    cp_async_wait_one();  // tile `it` has landed (the newest group may still fly)
    __syncthreads();
    const int i0 = i_begin + (it % per_head) * BQ;
    const bf16* q_t = stages + (it & 1) * 2 * BQ * LD;
    const bf16* do_t = q_t + BQ * LD;
    const float* lse_t = stats + (it & 1) * 2 * BQ;
    const float* d_t = lse_t + BQ;

    if (warp_live) {
      // S^T = K Q^T: keys g, g + 8 of the warp; queries i0 + 8 nt + 2 t4 + {0, 1}
      float st[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        uint32_t a[4];
        smem_a_frag<LD>(a, k_s, warp * 16 + g, kq * 16 + 2 * t4);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf16* qr = q_t + (nt * 8 + g) * LD + kq * 16 + 2 * t4;
          mma_bf16(st[nt], a, ld32(qr), ld32(qr + 8));
        }
      }
      // P^T, 0 where masked and past s
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t4 + (e & 1);
          const int i = i0 + c;
          const int j = keys[e >> 1];
          st[nt][e] = (i < s && j < s && visible(i, j, causal, window))
                          ? exp2f(st[nt][e] * scale_log2 - lse_t[c])
                          : 0.f;
        }
      }
      // dV += P^T dO: two tiles of 8 queries are one A fragment of 16
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16x2(st[2 * kk][0], st[2 * kk][1]),
                               pack_bf16x2(st[2 * kk][2], st[2 * kk][3]),
                               pack_bf16x2(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                               pack_bf16x2(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const bf16* drow =
            do_t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, drow + dt * 8);
          mma_bf16(dva[dt], a, bb[0], bb[1]);
          mma_bf16(dva[dt + 1], a, bb[2], bb[3]);
        }
      }
      // dP^T = V dO^T
      float dpt[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[nt][e] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        uint32_t a[4];
        smem_a_frag<LD>(a, v_s, warp * 16 + g, kq * 16 + 2 * t4);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf16* dr = do_t + (nt * 8 + g) * LD + kq * 16 + 2 * t4;
          mma_bf16(dpt[nt], a, ld32(dr), ld32(dr + 8));
        }
      }
      // dS^T = P^T (dP^T - D), in place of P^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] *= dpt[nt][e] - d_t[nt * 8 + 2 * t4 + (e & 1)];
      // dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16x2(st[2 * kk][0], st[2 * kk][1]),
                               pack_bf16x2(st[2 * kk][2], st[2 * kk][3]),
                               pack_bf16x2(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                               pack_bf16x2(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const bf16* qrow =
            q_t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, qrow + dt * 8);
          mma_bf16(dka[dt], a, bb[0], bb[1]);
          mma_bf16(dka[dt + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the load two tiles on
  }
  cp_async_wait_all();

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= s) continue;
    const int64_t off = ((static_cast<int64_t>(b) * s + keys[r]) * nkv + kvh) * HD + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + dt * 8) =
          __floats2bfloat162_rn(dka[dt][2 * r] * scale, dka[dt][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + dt * 8) =
          __floats2bfloat162_rn(dva[dt][2 * r], dva[dt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels, a warp per row, lane l holding columns l + 32 p
// ---------------------------------------------------------------------------

template <int HD>
__host__ __device__ constexpr int per_lane() {
  return (HD + 31) / 32;
}

template <int HD>
__device__ __forceinline__ void load_row(float (&r)[per_lane<HD>()], const float* p, int lane) {
#pragma unroll
  for (int c = 0; c < per_lane<HD>(); ++c) {
    const int d = lane + 32 * c;
    r[c] = d < HD ? p[d] : 0.f;
  }
}

template <int HD>
__device__ __forceinline__ float row_dot(const float (&r)[per_lane<HD>()], const float* p,
                                         int lane) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < per_lane<HD>(); ++c) {
    const int d = lane + 32 * c;
    if (d < HD) acc = fmaf(r[c], p[d], acc);
  }
  return warp_sum(acc);
}

template <int HD>
__device__ __forceinline__ void store_row(float* p, const float (&r)[per_lane<HD>()], float mul,
                                          int lane) {
#pragma unroll
  for (int c = 0; c < per_lane<HD>(); ++c) {
    const int d = lane + 32 * c;
    if (d < HD) p[d] = r[c] * mul;
  }
}

// kDQ false: lse (log2 units) and D of query row i.  kDQ true: dQ of row i.
template <int HD, bool kDQ>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_simt_rows_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int s, int nq, int nkv, Strides qs,
    Strides ks, Strides vs, Strides os, Strides dos, int causal, int window, float scale_log2,
    float scale) {
  constexpr int P = per_lane<HD>();
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kSimtRows + threadIdx.x / 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (i >= s) return;
  const int kvh = h / (nq / nkv);
  const int64_t lrow = (static_cast<int64_t>(b) * nq + h) * s + i;
  float qr[P], dor[P];
  load_row<HD>(qr, q + b * qs.b + static_cast<int64_t>(i) * qs.s + h * qs.h, lane);
  load_row<HD>(dor, dout + b * dos.b + static_cast<int64_t>(i) * dos.s + h * dos.h, lane);
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  const int j_begin = window > 0 ? max(0, i - window + 1) : 0;
  const int j_end = causal ? i + 1 : s;
  if constexpr (!kDQ) {
    float m = -__int_as_float(0x7f800000);
    float l = 0.f;
    for (int j = j_begin; j < j_end; ++j) {
      if (!visible(i, j, causal, window)) continue;
      const float sc = row_dot<HD>(qr, kb + static_cast<int64_t>(j) * ks.s, lane) * scale_log2;
      const float mt = fmaxf(m, sc);
      l = l * exp2f(m - mt) + exp2f(sc - mt);
      m = mt;
    }
    const float d = row_dot<HD>(dor, o + b * os.b + static_cast<int64_t>(i) * os.s + h * os.h,
                                lane);
    if (lane == 0) {
      lse[lrow] = m + log2f(l);
      delta[lrow] = d;
    }
  } else {
    const float lse2 = lse[lrow];
    const float d = delta[lrow];
    float acc[P];
#pragma unroll
    for (int c = 0; c < P; ++c) acc[c] = 0.f;
    for (int j = j_begin; j < j_end; ++j) {
      if (!visible(i, j, causal, window)) continue;
      const float* kr = kb + static_cast<int64_t>(j) * ks.s;
      const float sc = row_dot<HD>(qr, kr, lane) * scale_log2;
      const float dp = row_dot<HD>(dor, vb + static_cast<int64_t>(j) * vs.s, lane);
      const float ds = exp2f(sc - lse2) * (dp - d);
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const int dd = lane + 32 * c;
        if (dd < HD) acc[c] = fmaf(ds, kr[dd], acc[c]);
      }
    }
    store_row<HD>(dq + ((static_cast<int64_t>(b) * s + i) * nq + h) * HD, acc, scale, lane);
  }
}

// dK and dV of key row j of one kv head, over every query head of its group
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_simt_kv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int s,
    int nq, int nkv, Strides qs, Strides ks, Strides vs, Strides dos, int causal, int window,
    float scale_log2, float scale) {
  constexpr int P = per_lane<HD>();
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * kSimtRows + threadIdx.x / 32;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  if (j >= s) return;
  const int group = nq / nkv;
  float kr[P], vr[P], dka[P], dva[P];
  load_row<HD>(kr, k + b * ks.b + static_cast<int64_t>(j) * ks.s + kvh * ks.h, lane);
  load_row<HD>(vr, v + b * vs.b + static_cast<int64_t>(j) * vs.s + kvh * vs.h, lane);
#pragma unroll
  for (int c = 0; c < P; ++c) {
    dka[c] = 0.f;
    dva[c] = 0.f;
  }
  const int i_begin = causal ? j : 0;
  const int i_end = window > 0 ? min(s, j + window) : s;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const int64_t lrow = (static_cast<int64_t>(b) * nq + h) * s;
    for (int i = i_begin; i < i_end; ++i) {
      if (!visible(i, j, causal, window)) continue;
      float qi[P], doi[P];
      load_row<HD>(qi, q + b * qs.b + static_cast<int64_t>(i) * qs.s + h * qs.h, lane);
      load_row<HD>(doi, dout + b * dos.b + static_cast<int64_t>(i) * dos.s + h * dos.h, lane);
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int c = 0; c < P; ++c) {
        sp = fmaf(qi[c], kr[c], sp);
        dpp = fmaf(doi[c], vr[c], dpp);
      }
      const float p = exp2f(warp_sum(sp) * scale_log2 - lse[lrow + i]);
      const float ds = p * (warp_sum(dpp) - delta[lrow + i]);
#pragma unroll
      for (int c = 0; c < P; ++c) {
        dva[c] = fmaf(p, doi[c], dva[c]);
        dka[c] = fmaf(ds, qi[c], dka[c]);
      }
    }
  }
  const int64_t off = ((static_cast<int64_t>(b) * s + j) * nkv + kvh) * HD;
  store_row<HD>(dk + off, dka, scale, lane);
  store_row<HD>(dv + off, dva, 1.f, lane);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv, *lse, *delta;
  int batch, s, nq, nkv;
  Strides qs, ks, vs, os, dos;
  int causal, window;
  float scale;
};

// whether every row a tile copy reads starts on a 16-byte boundary
bool rows_aligned16(const void* p, Strides st, int elt) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (st.b * elt) % 16 == 0 &&
         (st.s * elt) % 16 == 0 && (st.h * elt) % 16 == 0;
}

template <int HD>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t rows_smem = rows_smem_bytes<HD>();
  constexpr size_t kv_smem = kv_smem_bytes<HD>();
  auto lse_kernel = flash_attention_bwd_rows_kernel<HD, false>;
  auto dq_kernel = flash_attention_bwd_rows_kernel<HD, true>;
  auto kv_kernel = flash_attention_bwd_kv_kernel<HD>;
  static const cudaError_t attr[3] = {
      cudaFuncSetAttribute(lse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(rows_smem)),
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(rows_smem)),
      cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kv_smem))};
  for (cudaError_t e : attr)
    if (e != cudaSuccess) return static_cast<int>(e);
  const int elt = static_cast<int>(sizeof(bf16));
  const int vec16 = rows_aligned16(a.q, a.qs, elt) && rows_aligned16(a.k, a.ks, elt) &&
                    rows_aligned16(a.v, a.vs, elt) && rows_aligned16(a.dout, a.dos, elt);
  const float scale_log2 = a.scale * kLog2e;
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* o = static_cast<const bf16*>(a.o);
  const auto* dout = static_cast<const bf16*>(a.dout);
  auto* lse = static_cast<float*>(a.lse);
  auto* delta = static_cast<float*>(a.delta);
  const dim3 rows_grid((a.s + kRows - 1) / kRows, a.nq, a.batch);
  lse_kernel<<<rows_grid, kThreads, rows_smem, stream>>>(
      q, k, v, o, dout, lse, delta, nullptr, a.s, a.nq, a.nkv, a.qs, a.ks, a.vs, a.os, a.dos,
      a.causal, a.window, scale_log2, a.scale, vec16);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kv_kernel<<<dim3((a.s + kRows - 1) / kRows, a.nkv, a.batch), kThreads, kv_smem, stream>>>(
      q, k, v, dout, lse, delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.s, a.nq,
      a.nkv, a.qs, a.ks, a.vs, a.dos, a.causal, a.window, scale_log2, a.scale, vec16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<<<rows_grid, kThreads, rows_smem, stream>>>(
      q, k, v, o, dout, lse, delta, static_cast<bf16*>(a.dq), a.s, a.nq, a.nkv, a.qs, a.ks,
      a.vs, a.os, a.dos, a.causal, a.window, scale_log2, a.scale, vec16);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_simt(const Args& a, cudaStream_t stream) {
  const float scale_log2 = a.scale * kLog2e;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* o = static_cast<const float*>(a.o);
  const auto* dout = static_cast<const float*>(a.dout);
  auto* lse = static_cast<float*>(a.lse);
  auto* delta = static_cast<float*>(a.delta);
  const int blocks = (a.s + kSimtRows - 1) / kSimtRows;
  const dim3 rows_grid(blocks, a.nq, a.batch);
  flash_attention_bwd_simt_rows_kernel<HD, false><<<rows_grid, kThreads, 0, stream>>>(
      q, k, v, o, dout, lse, delta, nullptr, a.s, a.nq, a.nkv, a.qs, a.ks, a.vs, a.os, a.dos,
      a.causal, a.window, scale_log2, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_simt_kv_kernel<HD><<<dim3(blocks, a.nkv, a.batch), kThreads, 0, stream>>>(
      q, k, v, dout, lse, delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.s,
      a.nq, a.nkv, a.qs, a.ks, a.vs, a.dos, a.causal, a.window, scale_log2, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_simt_rows_kernel<HD, true><<<rows_grid, kThreads, 0, stream>>>(
      q, k, v, o, dout, lse, delta, static_cast<float*>(a.dq), a.s, a.nq, a.nkv, a.qs, a.ks,
      a.vs, a.os, a.dos, a.causal, a.window, scale_log2, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// q, o, dout: (B, S, nq, hd); k, v: (B, S, nkv, hd); all in `dtype`,
// addressed by the given (batch, seq, head) strides in elements with
// head_dim contiguous.  dq: contiguous (B, S, nq, hd), dk and dv:
// contiguous (B, S, nkv, hd), in `dtype`; lse and delta: f32 scratch of
// B * nq * S each.  bf16 runs the mma.sync kernels, f32 the CUDA-core
// ones; three launches on `stream`.  Returns 0, a cudaError_t, or a
// negative repro::ArgError.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, void* lse, void* delta, int batch, int s, int nq, int nkv, int hd,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t do_sb, int64_t do_ss, int64_t do_sh, int dtype, int causal, int window,
    float scale, void* stream) {
  using namespace repro;
  if (nkv <= 0 || nq % nkv != 0) return kBadGroup;
  if (batch <= 0 || s <= 0) return kBadShape;
  const Args a{q,      k,     v,     o,     dout,  dq,
               dk,     dv,    lse,   delta, batch, s,
               nq,     nkv,   {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
               {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh}, {do_sb, do_ss, do_sh},
               causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    switch (hd) {
      case 32:
        return launch_simt<32>(a, st);
      case 64:
        return launch_simt<64>(a, st);
      case 80:
        return launch_simt<80>(a, st);
      case 128:
        return launch_simt<128>(a, st);
      default:
        return kBadHeadDim;
    }
  }
  if (dtype != kBF16) return kBadDType;
  switch (hd) {
    case 32:
      return launch_mma<32>(a, st);
    case 64:
      return launch_mma<64>(a, st);
    case 80:
      return launch_mma<80>(a, st);
    case 128:
      return launch_mma<128>(a, st);
    default:
      return kBadHeadDim;
  }
}
