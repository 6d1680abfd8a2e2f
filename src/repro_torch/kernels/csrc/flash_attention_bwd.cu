// Gradient of full-sequence (flash) attention for Hopper, with GQA, causal
// or not, sliding window and ragged lengths.
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
// outputs are contiguous (B, S, nq|nkv, hd) tensors in the input type.
// lse is kept in log2 units of the scaled scores (log2 of sum 2^(S
// log2(e))), the unit the forward writes it in.
//
// Bound: the arithmetic.  Five products of 2 * S * S * hd operations per
// head (the recomputed S, dV, dP, dQ, dK; half of that when causal)
// against about 4 * S * hd elements read and 3 * S * hd written per head:
// far above the card's ~295 operations per byte, so only the tensor cores
// can approach the bound, and at the 989 TFLOP/s of bf16 only wgmma.
//
// Three routes, chosen by the wrapper (kernels/flash_attention.py:
// bwd_route):
//
// 1. "wgmma", bf16 at head_dim 64 and 128 (training's route; FlashAttention-
//    3's backward).  The forward writes lse (its kLse instantiation), so
//    the five products are all: nothing is recomputed but S.  Three
//    launches: flash_attention_bwd_pre_kernel (D = rowsum(dO o), lse into
//    rows padded to a multiple of 64, the f32 dQ accumulator zeroed; when
//    the caller has no lse, the mma route's lse kernel runs first),
//    flash_attention_bwd_wgmma_kernel, and flash_attention_bwd_post_kernel
//    (dQ = scale x accumulator, to bf16).  The main kernel: one CTA per
//    (128-key tile, kv head, batch), 384 threads.  The grid runs in
//    blocks of 8 (batch, kv head) pairs, so that the pairs in flight keep
//    their slices of the accumulator in L2 (2 MB each at InternLM2's
//    training shape), and inside a block by key tile first, so that the
//    causal tiles with the most query rows start first in every block and
//    the last wave is short ones (with the key tile fastest, the longest
//    tiles of the last pairs would run alone in the last wave, a tail of
//    about a fifth of the kernel).  Warpgroup 2 is the
//    producer: it gives its registers away with setmaxnreg (24 a thread;
//    240 for the consumers) and one lane loads K and V once (TMA, 128
//    keys, the 128 B swizzle) and then, for every query head of the group
//    and every 64-row query tile that sees the key tile, Q and dO (TMA
//    boxes) with the tile's lse and D (64 floats each, bulk copies) into a
//    two-stage ring with full and empty mbarriers (a third stage was no
//    faster).  Warpgroups 0 and 1 own 64 keys each, so keys are wgmma's M
//    dimension and dK, dV (hd/2 f32 each per thread) stay in registers
//    across the whole walk: the group's sum needs no atomics.  Per query
//    tile a consumer runs
//      S^T = K Q^T and dP^T = V dO^T (m64n64, both operands K-major in
//        shared memory), as two commit groups;
//      once S^T is done, P^T = exp2(S^T scale log2(e) - lse) on the f32
//        accumulator (masks only on tiles not seen whole), packed to bf16
//        in place as A fragments (no shuffle), and dV += P^T dO (A from
//        registers, B = dO MN-major: the transpose bit) while dP^T runs;
//      once dP^T is done, dS^T = P^T (dP^T - D), packed likewise, and
//        dK += dS^T Q while dV runs;
//      dS^T into shared memory (bf16, the 128 B swizzle), then dQ_part =
//        dS K with A = dS^T read MN-major (16-bit A from shared memory may
//        be transposed) and B = K MN-major.  At hd 128 each warpgroup
//        takes 64 of dQ's columns over all 128 keys after a 256-thread
//        named barrier (both halves of dS^T written); at hd 64 each takes
//        all 64 columns over its own keys.  The dS^T buffer alternates
//        between tiles, so the barrier of one tile also orders the reuse
//        of the buffer two tiles on.
//    The stage is freed once dV and dK have completed; dQ_part (32 f32 a
//    thread) is added into the accumulator with 16-byte atomicAdd of a
//    float4 (a vector red on sm_90) in a tile layout of (part, chunk,
//    thread, 4) that makes each warp's adds 512 contiguous bytes; the
//    post-pass reads a (64-row, 64-column) part per CTA, puts it in place
//    in shared memory and writes 128-byte rows.  The f32 additions arrive
//    in no fixed order, so dQ differs from run to run in its last bits;
//    dK and dV do not.
//    Shared memory at hd 128: K and V 32 KB each, Q and dO 2 x 16 KB
//    each, dS^T 2 x 16 KB, lse and D 1 KB: 161 KB, one CTA an SM.
//
// 2. "mma", bf16 at head_dim 32 and 80: FA2's deterministic split into
//    three kernels, none with atomics, on warp-level mma.sync m16n8k16
//    with f32 accumulators:
//    a. flash_attention_bwd_rows_kernel<HD, false>: one CTA per (64-row
//       query tile, query head, batch), four warps of 16 rows.  Each warp
//       keeps its Q rows as mma A fragments in registers, walks the key
//       tiles (32 keys, double-buffered in shared memory by cp.async) and
//       keeps the online row max and sum of the scaled scores: lse.  D
//       comes from the rows of o and dO, one warp-wide dot product per
//       row.
//    b. flash_attention_bwd_kv_kernel<HD>: one CTA per (64-key tile, kv
//       head, batch), each warp 16 keys.  K and V stay in shared memory;
//       the CTA walks every query head of the group and every query tile
//       of 32 rows that sees its keys (Q, dO, lse and D double-buffered).
//       Per tile: S^T = K Q^T, P^T from lse, dV += P^T dO, dP^T = V dO^T,
//       dS^T = P^T (dP^T - D), dK += dS^T Q.
//    c. flash_attention_bwd_rows_kernel<HD, true>: the query tiles of (a)
//       again, Q and dO as A fragments in registers, K and V tiles walked
//       as in (a): S, P from lse, dP = dO V^T, dS, dQ += dS K.
//    B operands laid as (n, k) rows are read as 32-bit pairs, those laid
//    as (k, n) rows through ldmatrix.trans; the C fragment of one product
//    is packed to bf16 as the A fragment of the next.  Shared rows are
//    padded by 8 bf16 so that fragment reads and ldmatrix phases are free
//    of bank conflicts.  lse is recomputed (the forward's mma route does
//    not write it): a sixth product.
//
// 3. "simt", f32: the same three passes on the CUDA cores (a warp per
//    query row or per key row, exact f32 fused multiply-adds), so it is
//    held to the f32 tolerance; f32 trains only the small configurations.
//
// Hazards met by the wgmma kernel, and what it does about them:
// - Registers: dK and dV take 128 of a thread's 240 at hd 128, S^T and
//   dP^T 64 more, and dQ's 32 accumulators are live only while S^T and
//   dP^T are dead.  Deferring a tile's dQ adds until the next tile's S^T
//   and dP^T were issued (to hide them) kept all three live: ptxas
//   spilled and serialized the wgmma (advisory C7514: ordinary
//   instructions reading one group's accumulators while a later group
//   runs), and the kernel ran far slower; the adds stay at the end of
//   their tile.
// - wgmma serialization (C7520/C7512): every branch in the consumers
//   depends on values uniform over a warpgroup (the broadcast warp
//   index, the tile counters); the per-element masks are selects.
// - Async ordering: register fences around every wgmma batch (as in the
//   forward); fence.proxy.async after the ordinary stores of dS^T and
//   before the barrier, because wgmma reads shared memory through the
//   async proxy; a consumer arrives on a stage's empty barrier only
//   after the wgmma that read it completed.
// - Ragged S: TMA zero-fills rows past S; the masks (key < S, query < S)
//   keep those rows out of every sum, and dK/dV rows past S are not
//   stored.

#include <math.h>

#include "hopper.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
// bf16 at head_dim 64 and 128: one wgmma kernel fed by TMA, between a pre-
// and a post-pass
// ---------------------------------------------------------------------------

constexpr int kWgKeys = 128;                      // keys per CTA: two warpgroups of 64
constexpr int kWgRows = 64;                       // query rows per ring stage
constexpr int kWgStages = 2;
constexpr int kWgConsumers = 2 * 128;             // warpgroups 0 and 1
constexpr int kWgThreads = kWgConsumers + 128;    // warpgroup 2 produces (one lane issues)
// registers per thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 65536
constexpr int kWgConsumerRegs = 240;
constexpr int kWgProducerRegs = 24;
constexpr int kKeyBoxBytes = kWgKeys * kBoxRowBytes;  // (128 keys, 64 columns): 16 KB
constexpr int kRowBoxBytes = kWgRows * kBoxRowBytes;  // (64 rows, 64 columns): 8 KB
constexpr int kPrePostThreads = 256;
constexpr int kGridGroups = 8;  // (batch, kv head) pairs per block of the main kernel's grid

template <int HD>
struct BwdSmem {
  static constexpr int kBoxes = HD / kBox;
  // every box is a multiple of 1024 B from a 1024 B aligned base: TMA
  // writes them, and wgmma reads them, in the 128 B swizzle
  bf16 k[kBoxes][kWgKeys * kBox];
  bf16 v[kBoxes][kWgKeys * kBox];
  bf16 q[kWgStages][kBoxes][kWgRows * kBox];
  bf16 dout[kWgStages][kBoxes][kWgRows * kBox];
  // dS^T of the CTA's 128 keys (rows of 64 queries, 128 B), swizzled as a
  // TMA box would be; two buffers, used by alternate query tiles
  bf16 ds[2][kWgKeys * kWgRows];
  float lse[kWgStages][kWgRows];
  float delta[kWgStages][kWgRows];
  uint64_t kv_full;
  uint64_t full[kWgStages], empty[kWgStages];
};

template <int HD>
constexpr size_t wgmma_smem_bytes() {
  return sizeof(BwdSmem<HD>) + 1024;  // room to align the base to 1024 B
}

// Before the main kernel: D = rowsum(dO * o) and lse copied into rows of
// s_pad (0 past s, so that a 64-row stage is one aligned bulk copy), and
// the f32 dQ accumulator zeroed.  One warp per row of (B, nq, s_pad).
template <int HD>
__global__ void __launch_bounds__(kPrePostThreads) flash_attention_bwd_pre_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ lse_pad, float* __restrict__ delta_pad, float* __restrict__ dq_acc,
    int batch, int s, int s_pad, int nq, Strides os, Strides dos) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kPrePostThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(batch) * nq * s_pad) return;
  const int i = static_cast<int>(row % s_pad);
  const int64_t bh = row / s_pad;
  const int h = static_cast<int>(bh % nq);
  const int b = static_cast<int>(bh / nq);
  float4* acc = reinterpret_cast<float4*>(dq_acc + row * HD);  // HD floats per padded row
  for (int c = lane; c < HD / 4; c += 32) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float d = 0.f;
  if (i < s) {  // the same for the whole warp
    const bf16* orow = o + b * os.b + static_cast<int64_t>(i) * os.s + h * os.h;
    const bf16* drow = dout + b * dos.b + static_cast<int64_t>(i) * dos.s + h * dos.h;
    for (int c = lane; c < HD; c += 32) d = fmaf(to_f32(orow[c]), to_f32(drow[c]), d);
    d = warp_sum(d);
  }
  if (lane == 0) {
    delta_pad[row] = d;
    lse_pad[row] = i < s ? lse[bh * s + i] : 0.f;
  }
}

// dK and dV of a 128-key tile of one kv head over every query head of its
// group, and the tile's share of dQ added into the f32 accumulator.
// Warpgroups 0 and 1 own keys c0 .. c0 + 63 and c0 + 64 .. c0 + 127;
// warpgroup 2 loads.  The header gives the design.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_attention_bwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
    float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv, int batch, int s,
    int nq, int nkv, int causal, int window, float scale_log2, float scale) {
  static_assert(HD == 64 || HD == 128, "the wgmma backward takes head_dim 64 or 128");
  constexpr int kBoxes = HD / kBox;
  constexpr int kAcc = HD / 2;     // dK and dV accumulator floats per thread (64 x HD / 128)
  constexpr int kT = kWgRows / 2;  // S^T, dP^T and dQ floats per thread (64 x 64 / 128)
  // dQ = dS K: at hd 128 each warpgroup takes 64 of its columns over all
  // 128 keys (the two share dS^T through shared memory); at hd 64 each
  // takes all 64 columns over its own 64 keys, and both add to the tile
  constexpr bool kSplitCols = HD == 128;
  constexpr int kDqKeySteps = (kSplitCols ? kWgKeys : kWgKeys / 2) / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  BwdSmem<HD>& sm = *reinterpret_cast<BwdSmem<HD>*>(smem_raw + ((1024 - (raw & 1023)) & 1023));

  // The grid is cut into blocks of kGridGroups (batch, kv head) pairs; a
  // block's CTAs are numbered by key tile first, so the longest causal
  // tiles start first (a balanced last wave), and the accumulator slices
  // of the pairs in flight (2 MB each at InternLM2's training shape) stay
  // in L2.
  const int n_kt = (s + kWgKeys - 1) / kWgKeys;
  const int pairs = batch * nkv;
  const int g0 = static_cast<int>(blockIdx.x) / (kGridGroups * n_kt) * kGridGroups;
  const int in_block = static_cast<int>(blockIdx.x) - g0 * n_kt;
  const int block_pairs = min(kGridGroups, pairs - g0);
  const int c0 = in_block / block_pairs * kWgKeys;
  const int pair = g0 + in_block % block_pairs;
  const int kvh = pair % nkv;
  const int b = pair / nkv;
  const int group = nq / nkv;
  const int n_qt = (s + kWgRows - 1) / kWgRows;
  const int s_pad = n_qt * kWgRows;
  // the query tiles that see any key of this tile, for each head of the group
  const int c_end = min(c0 + kWgKeys, s);
  const int t_begin = causal ? c0 / kWgRows : 0;
  const int i_end = window > 0 ? min(s, c_end - 1 + window) : s;
  const int per_head = (i_end + kWgRows - 1) / kWgRows - t_begin;
  const int total = group * per_head;

  // the warp index broadcast from lane 0, so that ptxas sees the role
  // branches below as uniform over each warp (else it serializes the wgmma)
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // producer warpgroup: it hands its registers to the consumers, and one
    // lane issues every load: K and V once, then per query tile Q and dO
    // (TMA boxes) and the tile's lse and D (bulk copies) into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (warp == kWgConsumers / 32 && lane == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * kWgKeys * HD * 2);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_4d(sm.k[c], &k_map, &sm.kv_full, c * kBox, kvh, c0, b);
        tma_load_4d(sm.v[c], &v_map, &sm.kv_full, c * kBox, kvh, c0, b);
      }
      for (int it = 0; it < total; ++it) {
        const int st = it % kWgStages;
        const int h = kvh * group + it / per_head;
        const int i0 = (t_begin + it % per_head) * kWgRows;
        const int64_t row = (static_cast<int64_t>(b) * nq + h) * s_pad + i0;
        mbar_wait(&sm.empty[st], ((it / kWgStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(&sm.full[st], 2 * kWgRows * HD * 2 + 2 * kWgRows * 4);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_4d(sm.q[st][c], &q_map, &sm.full[st], c * kBox, h, i0, b);
          tma_load_4d(sm.dout[st][c], &do_map, &sm.full[st], c * kBox, h, i0, b);
        }
        bulk_load(sm.lse[st], lse_pad + row, kWgRows * 4, &sm.full[st]);
        bulk_load(sm.delta[st], delta_pad + row, kWgRows * 4, &sm.full[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
  // consumers: this thread holds keys (accumulator rows) r and r + 8 of its
  // warpgroup's 64, columns 8j + col + {0, 1} of every accumulator
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  const int kw0 = c0 + wg * 64;  // the warpgroup's first key

  float dka[kAcc], dva[kAcc];
#pragma unroll
  for (int x = 0; x < kAcc; ++x) {
    dka[x] = 0.f;
    dva[x] = 0.f;
  }
  float st_[kT];                  // S^T, then P^T
  float dpt[kT];                  // dP^T, then dS^T
  float dqa[kT];                  // this warpgroup's part of the tile's dQ
  uint32_t pa[kWgRows / 16][4];   // P^T as bf16 A fragments, 16 queries each
  uint32_t dsa[kWgRows / 16][4];  // dS^T likewise
  // K and V of this warpgroup's keys: rows wg * 64 .. of every box
  const uint32_t k_rows = smem_u32(sm.k[0]) + wg * 64 * kBoxRowBytes;
  const uint32_t v_rows = smem_u32(sm.v[0]) + wg * 64 * kBoxRowBytes;
  // dQ's operands, both MN-major: dS^T rows (dS's k dimension) and K rows
  // from key dq_key0 on, K's columns from box dq_box
  const int dq_key0 = kSplitCols ? 0 : wg * 64;
  const int dq_box = kSplitCols ? wg : 0;
  // a tile's accumulator is (part, 8 chunks, 128 threads, 4 floats): each
  // thread adds 16-byte pieces, and a warp covers 512 contiguous bytes
  const int part = kSplitCols ? wg : 0;
  const int tid = threadIdx.x % 128;

  mbar_wait(&sm.kv_full, 0);
  for (int it = 0; it < total; ++it) {
    const int stg = it % kWgStages;
    const int h = kvh * group + it / per_head;
    const int qt = t_begin + it % per_head;
    const int i0 = qt * kWgRows;
    const uint32_t q_base = smem_u32(sm.q[stg][0]);
    const uint32_t do_base = smem_u32(sm.dout[stg][0]);
    mbar_wait(&sm.full[stg], (it / kWgStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: all four K-major, 16 columns of
    // head_dim per wgmma; two commit groups, so that P^T and dV go ahead
    // while dP^T still runs
    fence_regs<kT>(st_);
    fence_regs<kT>(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off_k = (kk / 4) * kKeyBoxBytes + (kk % 4) * 32;
      const uint32_t off_q = (kk / 4) * kRowBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64<0, 0>(st_, sw128_desc(k_rows + off_k, 16, 8 * kBoxRowBytes),
                         sw128_desc(q_base + off_q, 16, 8 * kBoxRowBytes), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off_k = (kk / 4) * kKeyBoxBytes + (kk % 4) * 32;
      const uint32_t off_q = (kk / 4) * kRowBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64<0, 0>(dpt, sw128_desc(v_rows + off_k, 16, 8 * kBoxRowBytes),
                         sw128_desc(do_base + off_q, 16, 8 * kBoxRowBytes), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T done, dP^T may still run
    fence_regs<kT>(st_);

    // P^T = exp2(S^T scale log2(e) - lse), masked only where some (key,
    // query) pair of the tile is hidden or past s; queries 16kk .. 16kk +
    // 15 are the accumulator's n8 blocks 2kk and 2kk + 1: the A-operand
    // layout of the next wgmma
    const bool edge = i0 + kWgRows > s || kw0 + 64 > s || (causal && kw0 + 63 > i0) ||
                      (window > 0 && kw0 <= i0 + kWgRows - 1 - window);
#pragma unroll
    for (int x = 0; x < kT; ++x) {
      const int qc = (x / 4) * 8 + col + (x % 2);  // query within the tile
      float p = fast_exp2(fmaf(st_[x], scale_log2, -sm.lse[stg][qc]));
      if (edge) {
        const int key = kw0 + r + 8 * ((x / 2) % 2);
        const int i = i0 + qc;
        p = (key < s && i < s && visible(i, key, causal, window)) ? p : 0.f;
      }
      st_[x] = p;
    }
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16x2(st_[8 * kk + 2 * e], st_[8 * kk + 2 * e + 1]);

    // dV += P^T dO: A from registers, B MN-major (head_dim contiguous, its
    // two boxes kRowBoxBytes apart), 16 queries per wgmma
    fence_regs<kAcc>(dva);
    fence_regs<kWgRows / 4>(&pa[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk)
      wgmma_rs_hd<HD>(dva, pa[kk], sw128_desc(do_base + kk * 16 * kBoxRowBytes, kRowBoxBytes,
                                              8 * kBoxRowBytes));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T done, dV may still run
    fence_regs<kT>(dpt);

    // dS^T = P^T (dP^T - D), then dK += dS^T Q as dV
#pragma unroll
    for (int x = 0; x < kT; ++x) {
      const int qc = (x / 4) * 8 + col + (x % 2);
      dpt[x] = st_[x] * (dpt[x] - sm.delta[stg][qc]);
    }
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dsa[kk][e] = pack_bf16x2(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
    fence_regs<kAcc>(dka);
    fence_regs<kWgRows / 4>(&dsa[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk)
      wgmma_rs_hd<HD>(dka, dsa[kk], sw128_desc(q_base + kk * 16 * kBoxRowBytes, kRowBoxBytes,
                                               8 * kBoxRowBytes));
    wgmma_commit();

    // dS^T into this warpgroup's 64 rows of the buffer, in the 128 B
    // swizzle, for dQ; the buffers alternate, so a tile never overwrites
    // the one the other warpgroup may still be reading
    unsigned char* ds_buf = reinterpret_cast<unsigned char*>(sm.ds[it % 2]);
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wg * 64 + r + 8 * (e & 1);
        const int j = 2 * kk + (e >> 1);  // 16-byte chunk before the swizzle
        *reinterpret_cast<uint32_t*>(ds_buf + row * kBoxRowBytes + ((j ^ (row % 8)) * 16) +
                                     col * 2) = dsa[kk][e];
      }
    }
    fence_async_smem();
    if constexpr (kSplitCols)
      named_bar_sync(1, kWgConsumers);  // both halves of dS^T are written
    else
      named_bar_sync(2 + wg, 128);

    // this warpgroup's dQ part = dS K: A = dS^T read transposed, B = K,
    // both MN-major, 16 keys per wgmma
    const uint32_t ds_base = smem_u32(ds_buf) + dq_key0 * kBoxRowBytes;
    const uint32_t kq_base = smem_u32(sm.k[dq_box]) + dq_key0 * kBoxRowBytes;
    fence_regs<kT>(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqKeySteps; ++kk)
      wgmma_ss_n64<1, 1>(
          dqa, sw128_desc(ds_base + kk * 16 * kBoxRowBytes, kKeyBoxBytes, 8 * kBoxRowBytes),
          sw128_desc(kq_base + kk * 16 * kBoxRowBytes, kKeyBoxBytes, 8 * kBoxRowBytes), kk > 0);
    wgmma_commit();

    wgmma_wait<1>();  // dV and dK done: this stage's Q and dO are no longer read
    fence_regs<kAcc>(dka);
    fence_regs<kAcc>(dva);
    fence_regs<kWgRows / 4>(&pa[0][0]);
    fence_regs<kWgRows / 4>(&dsa[0][0]);
    mbar_arrive(&sm.empty[stg]);
    wgmma_wait<0>();
    fence_regs<kT>(dqa);
    float* acc = dq_acc + ((static_cast<int64_t>(b) * nq + h) * n_qt + qt) * kWgRows * HD +
                 part * (kWgRows * 64) + tid * 4;
#pragma unroll
    for (int c = 0; c < kT / 4; ++c)
      atomicAdd(reinterpret_cast<float4*>(acc + c * 128 * 4),
                make_float4(dqa[4 * c], dqa[4 * c + 1], dqa[4 * c + 2], dqa[4 * c + 3]));
  }

  // epilogue: dK (scaled) and dV of this warpgroup's keys as bf16; keys
  // past s are left out
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = kw0 + r + 8 * rr;
    if (key >= s) continue;
    const int64_t off = ((static_cast<int64_t>(b) * s + key) * nkv + kvh) * HD + col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * rr] * scale, dka[4 * j + 2 * rr + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * rr], dva[4 * j + 2 * rr + 1]);
    }
  }
}

// After the main kernel: dQ = scale x the accumulator, as bf16 in (B, S,
// nq, HD).  One CTA per (64-row tile, 64-column part) of a head: it reads
// the part's 16 KB in the accumulator's layout (16 bytes a thread,
// coalesced), puts each value in place in shared memory, and writes the
// 64 rows as 128-byte pieces.
template <int HD>
__global__ void __launch_bounds__(kPrePostThreads) flash_attention_bwd_post_kernel(
    const float* __restrict__ dq_acc, bf16* __restrict__ dq, int s, int nq, int n_qt,
    float scale) {
  constexpr int kParts = HD / 64;
  constexpr int kLd = 64 + 4;  // padded rows
  __shared__ __align__(16) float tile[kWgRows * kLd];
  const int64_t blk = blockIdx.x;  // ((b, h, qt), part)
  const int p = static_cast<int>(blk % kParts);
  const int qt = static_cast<int>((blk / kParts) % n_qt);
  const int64_t bh = blk / kParts / n_qt;
  const int h = static_cast<int>(bh % nq);
  const int b = static_cast<int>(bh / nq);
  const float4* src = reinterpret_cast<const float4*>(dq_acc) + blk * 1024;
  for (int idx = threadIdx.x; idx < 1024; idx += kPrePostThreads) {
    // piece (chunk c, thread t): rows r and r + 8, columns col and col + 1
    const float4 a = src[idx];
    const int t = idx % 128;
    const int r = (t / 32) * 16 + (t % 32) / 4;
    const int col = 8 * (idx / 128) + 2 * (t % 4);
    *reinterpret_cast<float2*>(&tile[r * kLd + col]) = make_float2(a.x, a.y);
    *reinterpret_cast<float2*>(&tile[(r + 8) * kLd + col]) = make_float2(a.z, a.w);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kWgRows * 8; idx += kPrePostThreads) {
    const int r = idx / 8;
    const int c = (idx % 8) * 8;
    const int row = qt * kWgRows + r;
    if (row >= s) continue;
    const float4 lo = *reinterpret_cast<const float4*>(&tile[r * kLd + c]);
    const float4 hi = *reinterpret_cast<const float4*>(&tile[r * kLd + c + 4]);
    const uint4 out = make_uint4(pack_bf16x2(lo.x * scale, lo.y * scale),
                                 pack_bf16x2(lo.z * scale, lo.w * scale),
                                 pack_bf16x2(hi.x * scale, hi.y * scale),
                                 pack_bf16x2(hi.z * scale, hi.w * scale));
    *reinterpret_cast<uint4*>(dq + ((static_cast<int64_t>(b) * s + row) * nq + h) * HD +
                              p * 64 + c) = out;
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
  void *dq, *dk, *dv, *lse, *delta, *lse_pad, *dq_acc;
  int batch, s, nq, nkv;
  Strides qs, ks, vs, os, dos;
  int causal, window, lse_given;
  float scale;
};

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

// The wgmma route: lse from the forward (or, when none is given, from
// the mma route's lse kernel), the pre-pass, the main kernel, the post-pass.
template <int HD>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  int rc = make_map(&q_map, a.q, a.batch, a.s, a.nq, HD, a.qs, kWgRows);
  if (rc == 0) rc = make_map(&k_map, a.k, a.batch, a.s, a.nkv, HD, a.ks, kWgKeys);
  if (rc == 0) rc = make_map(&v_map, a.v, a.batch, a.s, a.nkv, HD, a.vs, kWgKeys);
  if (rc == 0) rc = make_map(&do_map, a.dout, a.batch, a.s, a.nq, HD, a.dos, kWgRows);
  if (rc != 0) return rc;
  constexpr size_t smem = wgmma_smem_bytes<HD>();
  constexpr size_t rows_smem = rows_smem_bytes<HD>();
  auto main_kernel = flash_attention_bwd_wgmma_kernel<HD>;
  auto lse_kernel = flash_attention_bwd_rows_kernel<HD, false>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)),
      cudaFuncSetAttribute(lse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(rows_smem))};
  for (cudaError_t e : attr)
    if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 = a.scale * kLog2e;
  const auto* o = static_cast<const bf16*>(a.o);
  const auto* dout = static_cast<const bf16*>(a.dout);
  auto* lse = static_cast<float*>(a.lse);
  auto* delta_pad = static_cast<float*>(a.delta);
  auto* lse_pad = static_cast<float*>(a.lse_pad);
  auto* dq_acc = static_cast<float*>(a.dq_acc);
  const int n_qt = (a.s + kWgRows - 1) / kWgRows;
  const int s_pad = n_qt * kWgRows;
  cudaError_t e;
  if (!a.lse_given) {
    // its D lands in delta_pad's first B * nq * S floats and is rewritten
    // in the padded layout by the pre-pass
    const int elt = static_cast<int>(sizeof(bf16));
    const int vec16 = rows_aligned16(a.q, a.qs, elt) && rows_aligned16(a.k, a.ks, elt) &&
                      rows_aligned16(a.v, a.vs, elt) && rows_aligned16(a.dout, a.dos, elt);
    lse_kernel<<<dim3((a.s + kRows - 1) / kRows, a.nq, a.batch), kThreads, rows_smem, stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), o, dout, lse, delta_pad, nullptr, a.s, a.nq, a.nkv, a.qs,
        a.ks, a.vs, a.os, a.dos, a.causal, a.window, scale_log2, a.scale, vec16);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t rows = static_cast<int64_t>(a.batch) * a.nq * s_pad;
  constexpr int kWarps = kPrePostThreads / 32;
  flash_attention_bwd_pre_kernel<HD>
      <<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kPrePostThreads, 0, stream>>>(
          o, dout, lse, lse_pad, delta_pad, dq_acc, a.batch, a.s, s_pad, a.nq, a.os, a.dos);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ctas = (a.s + kWgKeys - 1) / kWgKeys * a.nkv * a.batch;
  main_kernel<<<ctas, kWgThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse_pad, delta_pad, dq_acc, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.batch, a.s, a.nq, a.nkv, a.causal, a.window, scale_log2,
      a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t parts = static_cast<int64_t>(a.batch) * a.nq * n_qt * (HD / 64);
  flash_attention_bwd_post_kernel<HD><<<static_cast<unsigned>(parts), kPrePostThreads, 0,
                                        stream>>>(dq_acc, static_cast<bf16*>(a.dq), a.s, a.nq,
                                                  n_qt, a.scale);
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
// contiguous (B, S, nkv, hd), in `dtype`.  Routes (the wrapper's
// bwd_route): bf16 at head_dim 64 and 128 runs the wgmma kernel between
// its pre- and post-pass (q, k, v and dout must suit TMA: base addresses
// and strides multiples of 16 bytes); other bf16 the mma.sync kernels,
// f32 the CUDA-core ones.  Scratch, f32: lse (B, nq, S), read when
// lse_given (the forward's, log2 units; wgmma route only) and written
// otherwise; delta, B * nq * S on the mma and CUDA-core routes and B * nq
// * S_pad on the wgmma route (S_pad = S rounded up to 64), which also
// takes lse_pad (B * nq * S_pad) and dq_acc (B * nq * S_pad * hd); the
// other routes ignore those two.  Launches on `stream`.  Returns 0, a
// cudaError_t, or a negative repro::ArgError.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, void* lse, void* delta, void* lse_pad, void* dq_acc, int batch, int s,
    int nq, int nkv, int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh, int dtype,
    int causal, int window, int lse_given, float scale, void* stream) {
  using namespace repro;
  if (nkv <= 0 || nq % nkv != 0) return kBadGroup;
  if (batch <= 0 || s <= 0) return kBadShape;
  const bool wgmma = dtype == kBF16 && (hd == 64 || hd == 128);
  if (lse_given && !wgmma) return kBadShape;
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, lse_pad, dq_acc, batch, s, nq, nkv,
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh},
               {do_sb, do_ss, do_sh}, causal, window, lse_given, scale};
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
      return launch_wgmma<64>(a, st);
    case 80:
      return launch_mma<80>(a, st);
    case 128:
      return launch_wgmma<128>(a, st);
    default:
      return kBadHeadDim;
  }
}
