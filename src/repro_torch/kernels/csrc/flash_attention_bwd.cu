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
// lse is the forward's, in log2 units of the scaled scores (log2 of sum
// 2^(S log2(e))): both forward kernels write it (their kLse
// instantiations), and the wrapper runs the forward for it when a caller
// has none.  So the five products are all: nothing is recomputed but S.
//
// Bound: the arithmetic.  Five products of 2 * S * S * hd operations per
// head (the recomputed S, dV, dP, dQ, dK; half of that when causal)
// against about 4 * S * hd elements read and 3 * S * hd written per head:
// far above the card's ~295 operations per byte, so only the tensor cores
// can approach the bound, and at the 989 TFLOP/s of bf16 only wgmma.
//
// Two routes, chosen by the wrapper (kernels/flash_attention.py:
// bwd_route), each three launches: flash_attention_bwd_pre_kernel (D =
// rowsum(dO o) and lse into rows padded to a multiple of the query tile,
// the f32 dQ accumulator zeroed), the main kernel, and a post-pass (dQ =
// scale x accumulator, in the input type).  Both main kernels run one CTA
// per key tile of one kv head, keys as the rows of their products, so dK
// and dV stay in registers across the group's query heads and query
// tiles; per query tile they form S^T, P^T from lse, dV, dP^T, dS^T and
// dK, and add dQ_part = dS K into the accumulator with f32 atomics.
//
// 1. "wgmma", bf16 at head_dim 64 and 128 (FlashAttention-3's backward).
//    flash_attention_bwd_wgmma_kernel: one CTA per (128-key tile, kv
//    head, batch), 384 threads.  The grid runs in
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
// 2. "mma", bf16 at head_dim 32 and 80 and f32 at every head_dim, on
//    warp-level mma.sync: bf16 as m16n8k16 with f32 accumulators, f32 as
//    three m16n8k8 TF32 products of split operands (hopper.cuh:
//    mma_tf32x3, the forward's arithmetic; kernels/ref.py:
//    flash_attention_bwd_tiled(tf32x3=True) is it in plain PyTorch, held
//    to 2e-5 of the JAX oracle), so its bound is 3 x operations / 495
//    TFLOP/s of dense TF32 (the CUDA cores give 67).
//    flash_attention_bwd_mma_kernel<T, HD>: one CTA per (128-key tile, kv
//    head, batch), eight warps of 16 keys; query tiles of 64 rows (bf16)
//    or 32 (f32, whose registers and shared memory are twice as wide).
//    K and V are loaded once (cp.async, rows padded by 8 bf16 or 4 f32);
//    in bf16 each warp keeps its keys' K and V as A fragments in
//    registers.  For every query head of the group and every query tile
//    that sees the key tile, Q, dO, lse and D come through a two-stage
//    cp.async ring, and each warp runs on its own 16 keys
//      S^T = K Q^T (B fragments of Q by ldmatrix), P^T = exp2(S^T scale
//        log2(e) - lse) (masks only on tiles not seen whole);
//      dV += P^T dO: the C fragments of S^T are the A fragments (bf16
//        packed in pairs; TF32 with each k8 step's queries permuted, so
//        that C's columns 2t, 2t + 1 are A's columns t, t + 4), B = dO
//        through ldmatrix.trans (or, TF32, two rows read at the same
//        permuted queries);
//      dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q as dV;
//      dS^T into shared memory (bf16 as its rounded A fragments).
//    After one barrier all eight warps form the tile's dQ_part = dS K,
//    each an m16 tile of query rows by its share of dQ's n8 columns, over
//    the key tile's live keys: A = dS^T through ldmatrix.trans (TF32:
//    dS^T rows read at permuted keys), B = K through ldmatrix.trans, and
//    add it to the accumulator with float4 atomics in the fragment layout
//    (n8 tile, m16 tile, lane, 4), 512 contiguous bytes a warp.  A second
//    barrier a tile orders the reuse of dS^T and of the ring's stages.
//    The grid is planned from the shapes (the wrapper's bwd_plan): CTAs
//    run key tile slowest, so that causal tiles with the most query rows
//    start first; where key tiles x kv heads x batch fill less than the
//    card (the smoke configs: 8 CTAs on 132 SMs), each key tile's walk
//    over (head, query tile) is split over `splits` CTAs, which add dK
//    and dV through float4 atomics into an f32 buffer zeroed by the
//    pre-pass and converted by the post-pass.
//    Shared memory: bf16 hd 80 107 KB, f32 hd 128 217 KB; one CTA an SM.
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

#include <type_traits>

#include "hopper.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPrePostThreads = 256;

__device__ __forceinline__ bool visible(int i, int j, int causal, int window) {
  return (!causal || j <= i) && (window <= 0 || j > i - window);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// Before the main kernel (both routes): D = rowsum(dO * o) and lse copied
// into rows of s_pad (0 past s, so that a query tile's are one aligned
// copy), the f32 dQ accumulator zeroed, and, when the mma route splits
// its key tiles, the dK/dV accumulator (dkv_rows rows of HD floats after
// the query rows).  One warp per row.
template <typename T, int HD>
__global__ void __launch_bounds__(kPrePostThreads) flash_attention_bwd_pre_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ lse_pad, float* __restrict__ delta_pad, float* __restrict__ dq_acc,
    float* __restrict__ dkv_acc, int64_t dkv_rows, int batch, int s, int s_pad, int nq,
    Strides os, Strides dos) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kPrePostThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t q_rows = static_cast<int64_t>(batch) * nq * s_pad;
  if (row >= q_rows) {
    if (row - q_rows < dkv_rows) {
      float4* acc = reinterpret_cast<float4*>(dkv_acc + (row - q_rows) * HD);
      for (int c = lane; c < HD / 4; c += 32) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int i = static_cast<int>(row % s_pad);
  const int64_t bh = row / s_pad;
  const int h = static_cast<int>(bh % nq);
  const int b = static_cast<int>(bh / nq);
  float4* acc = reinterpret_cast<float4*>(dq_acc + row * HD);  // HD floats per padded row
  for (int c = lane; c < HD / 4; c += 32) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float d = 0.f;
  if (i < s) {  // the same for the whole warp
    const T* orow = o + b * os.b + static_cast<int64_t>(i) * os.s + h * os.h;
    const T* drow = dout + b * dos.b + static_cast<int64_t>(i) * dos.s + h * dos.h;
    for (int c = lane; c < HD; c += 32) d = fmaf(to_f32(orow[c]), to_f32(drow[c]), d);
    d = warp_sum(d);
  }
  if (lane == 0) {
    delta_pad[row] = d;
    lse_pad[row] = i < s ? lse[bh * s + i] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The mma route: bf16 at head_dim 32 and 80 (mma.sync m16n8k16), f32 at
// every head_dim (split TF32, m16n8k8)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaKeys = 16 * kMmaWarps;  // keys per CTA: 16 per warp

// Query rows per tile, and the padding of a shared row (elements): rows of
// HD + 8 bf16 keep every ldmatrix phase free of bank conflicts, rows of
// HD + 4 f32 every fragment read (4 g + t or 8 t + g banks), and both keep
// each row on a 16-byte boundary for cp.async and ldmatrix.
template <typename T>
struct MmaBwd;
template <>
struct MmaBwd<bf16> {
  static constexpr int kRows = 64;
  static constexpr int kPad = 8;
};
template <>
struct MmaBwd<float> {
  static constexpr int kRows = 32;
  static constexpr int kPad = 4;
};

template <typename T, int HD>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  // K and V of the key tile, two stages of Q and dO, dS^T, two stages of
  // lse and D
  constexpr int BQ = MmaBwd<T>::kRows;
  constexpr int LD = HD + MmaBwd<T>::kPad;
  constexpr int LDS = BQ + MmaBwd<T>::kPad;
  return (2 * kMmaKeys * LD + 4 * BQ * LD + kMmaKeys * LDS) * sizeof(T) +
         4 * BQ * sizeof(float);
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  return static_cast<T>(0.f);
}

// Rows [r0, r0 + ROWS) of one head's (S, HD) slice (row stride ss) into a
// shared tile of rows padded to HD + kPad; rows past s are zeros.  With
// every row on a 16-byte boundary (vec16) the copy is cp.async of 16
// bytes, otherwise element by element.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0, int s, int64_t ss,
                                          int vec16) {
  constexpr int LD = HD + MmaBwd<T>::kPad;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = HD / kVec;
  if (vec16) {
    for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kMmaThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * kVec;
      const int i = r0 + r;
      const int64_t ii = i < s ? i : 0;  // a valid address even when nothing is read
      cp_async16(dst + r * LD + c, src + ii * ss + c, i < s ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * HD; idx += kMmaThreads) {
      const int r = idx / HD;
      const int d = idx % HD;
      const int i = r0 + r;
      dst[r * LD + d] = i < s ? src[static_cast<int64_t>(i) * ss + d] : zero_of<T>();
    }
  }
}

// acc (16 rows x BQ columns) += A B^T over head_dim, for S^T = K Q^T and
// dP^T = V dO^T: A is the warp's 16 keys (bf16: A fragments held in
// registers; f32: rows of a shared tile, split per step), B the query
// tile's rows in shared memory.
template <typename T, int HD, int BQ, int KF>
__device__ __forceinline__ void keys_by_queries(float (&acc)[BQ / 8][4],
                                                const uint32_t (&af)[KF][4],
                                                const T* a_rows, const T* b_rows, int lane) {
  constexpr int LD = HD + MmaBwd<T>::kPad;
  const int g = lane / 4;
  const int t4 = lane % 4;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kq = 0; kq < HD / 8; ++kq) {
      // a0: (g, t4), a1: (g + 8, t4), a2: (g, t4 + 4), a3: (g + 8, t4 + 4)
      const float* ar = a_rows + g * LD + kq * 8 + t4;
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(ar[(e & 1) * 8 * LD + (e >> 1) * 4], a_hi[e], a_lo[e]);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const float* br = b_rows + (nt * 8 + g) * LD + kq * 8 + t4;
        mma_tf32x3(acc[nt], a_hi, a_lo, br[0], br[4]);
      }
    }
  } else {
    // B fragments of two n8 tiles per ldmatrix: matrices (rows 8nt, k 0-7),
    // (rows 8nt, k 8-15), (rows 8nt + 8, k 0-7), (rows 8nt + 8, k 8-15)
    const T* brow = b_rows + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kq = 0; kq < HD / 16; ++kq) {
#pragma unroll
      for (int nt = 0; nt < BQ / 8; nt += 2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, brow + nt * 8 * LD + kq * 16);
        mma_bf16(acc[nt], af[kq], bb[0], bb[1]);
        mma_bf16(acc[nt + 1], af[kq], bb[2], bb[3]);
      }
    }
  }
}

// acc (16 keys x HD) += C B over the query tile, for dV += P^T dO and
// dK += dS^T Q: C (16 x BQ, f32 accumulators of the previous product) is
// the A operand as it lies in registers; B (BQ x HD) is a shared tile.
template <typename T, int HD, int BQ>
__device__ __forceinline__ void keys_by_head_dim(float (&acc)[HD / 8][4],
                                                 const float (&c)[BQ / 8][4], const T* b_rows,
                                                 int lane) {
  constexpr int LD = HD + MmaBwd<T>::kPad;
  if constexpr (std::is_same<T, float>::value) {
    // A column t4 is query 2 t4 of the k8 step, column t4 + 4 query 2 t4 + 1:
    // C's (g, 2 t4), (g, 2 t4 + 1), (g + 8, ..) are a0, a2, a1, a3, and B's
    // rows are read at the same queries
    const int g = lane / 4;
    const int t4 = lane % 4;
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(c[kk][0], a_hi[0], a_lo[0]);
      split_tf32(c[kk][2], a_hi[1], a_lo[1]);
      split_tf32(c[kk][1], a_hi[2], a_lo[2]);
      split_tf32(c[kk][3], a_hi[3], a_lo[3]);
      const float* br = b_rows + (kk * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        mma_tf32x3(acc[dt], a_hi, a_lo, br[dt * 8], br[LD + dt * 8]);
    }
  } else {
    // two C tiles of 8 queries are one A fragment of 16, packed as they lie
    // (FlashAttention-2's layout); B's fragments through ldmatrix.trans, two
    // n8 tiles per instruction
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(c[2 * kk][0], c[2 * kk][1]),
                             pack_bf16x2(c[2 * kk][2], c[2 * kk][3]),
                             pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                             pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3])};
      const T* brow = b_rows + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < HD / 8; dt += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, brow + dt * 8);
        mma_bf16(acc[dt], a, bb[0], bb[1]);
        mma_bf16(acc[dt + 1], a, bb[2], bb[3]);
      }
    }
  }
}

// dK and dV of a 128-key tile of one kv head over its share of the
// (query head, query tile) walk, and each tile's dQ_part added into the
// f32 accumulator.  Warp w owns keys c0 + 16 w .. c0 + 16 w + 15.  The
// header gives the design.
template <typename T, int HD>
__global__ void __launch_bounds__(kMmaThreads, 1) flash_attention_bwd_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse_pad,
    const float* __restrict__ delta_pad, float* __restrict__ dq_acc, T* __restrict__ dk,
    T* __restrict__ dv, float* __restrict__ dkv_acc, int batch, int s, int nq, int nkv,
    Strides qs, Strides ks, Strides vs, Strides dos, int causal, int window, float scale_log2,
    float scale, int vec16, int splits) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int BQ = MmaBwd<T>::kRows;
  constexpr int LD = HD + MmaBwd<T>::kPad;
  constexpr int LDS = BQ + MmaBwd<T>::kPad;
  constexpr int NQ = BQ / 8;   // n8 tiles of S^T and dP^T
  constexpr int DT = HD / 8;   // n8 tiles of dK, dV and dQ
  constexpr int MQ = BQ / 16;  // m16 tiles of dQ
  constexpr int kDqCols = (DT + kMmaWarps / MQ - 1) / (kMmaWarps / MQ);  // dQ n8 tiles a warp
  constexpr int kKeyStep = kF32 ? 8 : 16;
  static_assert(kF32 || HD % 16 == 0, "bf16 head_dim must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* k_s = reinterpret_cast<T*>(bwd_smem);
  T* v_s = k_s + kMmaKeys * LD;
  T* stages = v_s + kMmaKeys * LD;  // stage st: Q at 2 st, dO at 2 st + 1
  T* ds_s = stages + 4 * BQ * LD;   // dS^T: a row of BQ queries per key
  float* stats = reinterpret_cast<float*>(ds_s + kMmaKeys * LDS);  // stage st: lse, then D

  // key tile slowest: causal tiles with the most query rows start first
  const int pairs = batch * nkv;
  const int sp = static_cast<int>(blockIdx.x % splits);
  const int pair = static_cast<int>(blockIdx.x / splits % pairs);
  const int kt = static_cast<int>(blockIdx.x / splits / pairs);
  const int kvh = pair % nkv;
  const int b = pair / nkv;
  const int c0 = kt * kMmaKeys;
  const int group = nq / nkv;
  const int n_qt = (s + BQ - 1) / BQ;
  const int n_kt = (s + kMmaKeys - 1) / kMmaKeys;
  // the query tiles that see any key of this tile, for each head of the
  // group, and this CTA's share of the (head, query tile) walk
  const int c_end = min(c0 + kMmaKeys, s);
  const int t_begin = causal ? c0 / BQ : 0;
  const int i_end = window > 0 ? min(s, c_end - 1 + window) : s;
  const int per_head = (i_end + BQ - 1) / BQ - t_begin;
  const int total = group * per_head;
  const int per_split = (total + splits - 1) / splits;
  const int it0 = min(total, sp * per_split);
  const int it1 = min(total, it0 + per_split);
  if (it0 >= it1) return;  // a split with nothing to add

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int kw0 = c0 + warp * 16;  // this warp's first key
  const bool live = kw0 < s;
  const int key_steps = (c_end - c0 + kKeyStep - 1) / kKeyStep;  // dQ's k steps
  // dQ: this warp's m16 tile of query rows and its n8 columns
  const int mq = warp % MQ;
  const int dq0 = warp / MQ * kDqCols;

  load_rows<T, HD, kMmaKeys>(k_s, k + b * ks.b + kvh * ks.h, c0, s, ks.s, vec16);
  load_rows<T, HD, kMmaKeys>(v_s, v + b * vs.b + kvh * vs.h, c0, s, vs.s, vec16);
  cp_async_commit();

  // Q, dO, lse and D of walk item `it` into stage `st`
  auto stage_load = [&](int it, int st) {
    const int h = kvh * group + it / per_head;
    const int i0 = (t_begin + it % per_head) * BQ;
    T* q_t = stages + st * 2 * BQ * LD;
    load_rows<T, HD, BQ>(q_t, q + b * qs.b + h * qs.h, i0, s, qs.s, vec16);
    load_rows<T, HD, BQ>(q_t + BQ * LD, dout + b * dos.b + h * dos.h, i0, s, dos.s, vec16);
    constexpr int kStatChunks = BQ / 4;  // 16-byte pieces of lse (then D)
    if (threadIdx.x < 2 * kStatChunks) {
      const int which = threadIdx.x / kStatChunks;
      const int c = (threadIdx.x % kStatChunks) * 4;
      const int64_t row = (static_cast<int64_t>(b) * nq + h) * (n_qt * BQ) + i0 + c;
      cp_async16(stats + (st * 2 + which) * BQ + c, (which ? delta_pad : lse_pad) + row, 16);
    }
  };
  stage_load(it0, 0);
  cp_async_commit();
  cp_async_wait_one();  // K and V have landed
  __syncthreads();

  // bf16: this warp's K and V rows as A fragments (rows g, g + 8; columns
  // 16 kq + 2 t4 + {0, 1} and + 8), for the whole walk
  uint32_t kf[kF32 ? 1 : HD / 16][4], vf[kF32 ? 1 : HD / 16][4];
  if constexpr (!kF32) {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = (lane >> 4) * 8;
#pragma unroll
    for (int kq = 0; kq < HD / 16; ++kq) {
      ldmatrix_x4(kf[kq], k_s + r * LD + kq * 16 + c);
      ldmatrix_x4(vf[kq], v_s + r * LD + kq * 16 + c);
    }
  }

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[dt][e] = 0.f;
      dva[dt][e] = 0.f;
    }

  for (int it = it0; it < it1; ++it) {
    const int st = (it - it0) & 1;
    if (it + 1 < it1) stage_load(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // item `it` has landed (the newest group may still fly)
    __syncthreads();
    const int h = kvh * group + it / per_head;
    const int qt = t_begin + it % per_head;
    const int i0 = qt * BQ;
    const T* q_t = stages + st * 2 * BQ * LD;
    const T* do_t = q_t + BQ * LD;
    const float* lse_t = stats + st * 2 * BQ;
    const float* d_t = lse_t + BQ;

    if (live) {
      // S^T = K Q^T: keys g, g + 8 of the warp; queries 8 nt + 2 t4 + {0, 1}
      float sa[NQ][4];
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[nt][e] = 0.f;
      keys_by_queries<T, HD, BQ>(sa, kf, k_s + warp * 16 * LD, q_t, lane);
      // P^T, 0 where hidden or past s (checked only where some pair of
      // the tile may be)
      const bool edge = i0 + BQ > s || kw0 + 16 > s || (causal && kw0 + 15 > i0) ||
                        (window > 0 && kw0 <= i0 + BQ - 1 - window);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + 2 * t4 + (e & 1);
          const float x = fmaf(sa[nt][e], scale_log2, -lse_t[qc]);
          float p = kF32 ? exp2f(x) : fast_exp2(x);
          if (edge) {
            const int key = kw0 + g + 8 * (e >> 1);
            const int i = i0 + qc;
            p = (key < s && i < s && visible(i, key, causal, window)) ? p : 0.f;
          }
          sa[nt][e] = p;
        }
      }
      keys_by_head_dim<T, HD, BQ>(dva, sa, do_t, lane);  // dV += P^T dO
      // dP^T = V dO^T, then dS^T = P^T (dP^T - D) in its place
      float dsa[NQ][4];
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsa[nt][e] = 0.f;
      keys_by_queries<T, HD, BQ>(dsa, vf, v_s + warp * 16 * LD, do_t, lane);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dsa[nt][e] = sa[nt][e] * (dsa[nt][e] - d_t[nt * 8 + 2 * t4 + (e & 1)]);
      keys_by_head_dim<T, HD, BQ>(dka, dsa, q_t, lane);  // dK += dS^T Q
      // dS^T into the warp's 16 rows of the shared tile (bf16 rounded as
      // the A fragments of dK were)
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          T* dst = ds_s + (warp * 16 + g + 8 * r) * LDS + nt * 8 + 2 * t4;
          if constexpr (kF32)
            store2(dst, dsa[nt][2 * r], dsa[nt][2 * r + 1]);
          else
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(dsa[nt][2 * r], dsa[nt][2 * r + 1]);
        }
      }
    }
    __syncthreads();  // dS^T is whole

    // dQ_part = dS K over the tile's live keys: rows 16 mq + g, + 8;
    // columns 8 (dq0 + j) + 2 t4 + {0, 1}
    float dqa[kDqCols][4];
#pragma unroll
    for (int j = 0; j < kDqCols; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
    for (int kk = 0; kk < key_steps; ++kk) {
      if constexpr (kF32) {
        // A column t4 is key 2 t4 of the k8 step, column t4 + 4 key 2 t4 + 1
        const float* dsr = ds_s + (kk * 8 + 2 * t4) * LDS + mq * 16 + g;
        uint32_t a_hi[4], a_lo[4];
        split_tf32(dsr[0], a_hi[0], a_lo[0]);
        split_tf32(dsr[8], a_hi[1], a_lo[1]);
        split_tf32(dsr[LDS], a_hi[2], a_lo[2]);
        split_tf32(dsr[LDS + 8], a_hi[3], a_lo[3]);
        const float* kr = k_s + (kk * 8 + 2 * t4) * LD + g;
#pragma unroll
        for (int j = 0; j < kDqCols; ++j) {
          const int dt = dq0 + j;
          if (dt < DT) mma_tf32x3(dqa[j], a_hi, a_lo, kr[dt * 8], kr[LD + dt * 8]);
        }
      } else {
        // A = dS from dS^T, transposed by ldmatrix: matrices (keys 0-7,
        // queries 0-7), (keys 0-7, queries 8-15), (keys 8-15, queries 0-7),
        // (keys 8-15, queries 8-15) of the step
        uint32_t a[4];
        ldmatrix_x4_trans(a, ds_s + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDS +
                                 mq * 16 + ((lane >> 3) & 1) * 8);
        const T* krow = k_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < kDqCols; j += 2) {
          const int dt = dq0 + j;
          if (j + 1 < kDqCols) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, krow + dt * 8);
            mma_bf16(dqa[j], a, bb[0], bb[1]);
            mma_bf16(dqa[j + 1], a, bb[2], bb[3]);
          } else {
            uint32_t bb[2];
            ldmatrix_x2_trans(bb, krow + dt * 8);
            mma_bf16(dqa[j], a, bb[0], bb[1]);
          }
        }
      }
    }
    float* acc = dq_acc + ((static_cast<int64_t>(b) * nq + h) * n_qt + qt) * (BQ * HD);
#pragma unroll
    for (int j = 0; j < kDqCols; ++j) {
      const int dt = dq0 + j;
      if (dt < DT)
        atomicAdd(reinterpret_cast<float4*>(acc + ((dt * MQ + mq) * 32 + lane) * 4),
                  make_float4(dqa[j][0], dqa[j][1], dqa[j][2], dqa[j][3]));
    }
  }
  cp_async_wait_all();

  if (!live) return;
  if (splits == 1) {
    // dK (scaled) and dV of this warp's keys in the input type; keys past
    // s are left out
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw0 + g + 8 * r;
      if (key >= s) continue;
      const int64_t off = ((static_cast<int64_t>(b) * s + key) * nkv + kvh) * HD + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        store2(dk + off + dt * 8, dka[dt][2 * r] * scale, dka[dt][2 * r + 1] * scale);
        store2(dv + off + dt * 8, dva[dt][2 * r], dva[dt][2 * r + 1]);
      }
    }
  } else {
    // this split's share, added in the fragment layout (n8 tile, m16 tile,
    // lane, 4) of the key tile; dV's accumulator follows all of dK's
    const int64_t tile = (static_cast<int64_t>(b) * nkv + kvh) * n_kt + kt;
    float* dk_t = dkv_acc + tile * (kMmaKeys * HD);
    float* dv_t = dk_t + static_cast<int64_t>(batch) * nkv * n_kt * (kMmaKeys * HD);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int off = ((dt * kMmaWarps + warp) * 32 + lane) * 4;
      atomicAdd(reinterpret_cast<float4*>(dk_t + off),
                make_float4(dka[dt][0], dka[dt][1], dka[dt][2], dka[dt][3]));
      atomicAdd(reinterpret_cast<float4*>(dv_t + off),
                make_float4(dva[dt][0], dva[dt][1], dva[dt][2], dva[dt][3]));
    }
  }
}

// One f32 accumulator in the fragment layout (per tile of `rows` rows of
// one head: n8 tile, m16 tile, lane, 4 floats) to be written as a
// contiguous (B, S, heads, HD) tensor, times `scale`.
struct ConvertJob {
  const float* acc;
  void* out;
  int heads, rows;
  float scale;
  int64_t pieces;  // float4 pieces: B * heads * tiles * rows * HD / 4
};

struct ConvertJobs {
  ConvertJob job[3];  // dQ; dK and dV when the key tiles were split
  int n;
};

// After the mma route's main kernel: each thread one 16-byte piece of an
// accumulator (coalesced reads), written as two pairs of rows r and r + 8.
template <typename T, int HD>
__global__ void __launch_bounds__(kPrePostThreads) flash_attention_bwd_convert_kernel(
    const __grid_constant__ ConvertJobs jobs, int s) {
  int64_t p = static_cast<int64_t>(blockIdx.x) * kPrePostThreads + threadIdx.x;
  int j = 0;
  while (j < jobs.n && p >= jobs.job[j].pieces) p -= jobs.job[j++].pieces;
  if (j == jobs.n) return;
  const ConvertJob& job = jobs.job[j];
  const int mts = job.rows / 16;
  const int per_tile = job.rows * HD / 4;
  const int n_tiles = (s + job.rows - 1) / job.rows;
  const int64_t tile = p / per_tile;
  const int x = static_cast<int>(p % per_tile);
  const int lane = x % 32;
  const int mt = x / 32 % mts;
  const int nt = x / 32 / mts;
  const int64_t bh = tile / n_tiles;
  const int h = static_cast<int>(bh % job.heads);
  const int64_t b = bh / job.heads;
  const int row = static_cast<int>(tile % n_tiles) * job.rows + mt * 16 + lane / 4;
  const int col = nt * 8 + 2 * (lane % 4);
  const float4 a = reinterpret_cast<const float4*>(job.acc)[p];
  T* out = static_cast<T*>(job.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r < s)
      store2(out + ((b * s + row + 8 * r) * job.heads + h) * HD + col,
             (r ? a.z : a.x) * job.scale, (r ? a.w : a.y) * job.scale);
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
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv, *lse, *delta, *lse_pad, *dq_acc, *dkv_acc;
  int batch, s, nq, nkv;
  Strides qs, ks, vs, os, dos;
  int causal, window, splits;
  float scale;
};

// D, lse into padded rows, the accumulators zeroed (dkv_rows rows of HD
// floats of the split dK/dV accumulator, or none)
template <typename T, int HD>
int launch_pre(const Args& a, int s_pad, int64_t dkv_rows, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(a.batch) * a.nq * s_pad + dkv_rows;
  constexpr int kWarps = kPrePostThreads / 32;
  flash_attention_bwd_pre_kernel<T, HD>
      <<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kPrePostThreads, 0, stream>>>(
          static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<float*>(a.lse_pad),
          static_cast<float*>(a.delta), static_cast<float*>(a.dq_acc),
          static_cast<float*>(a.dkv_acc), dkv_rows, a.batch, a.s, s_pad, a.nq, a.os, a.dos);
  return static_cast<int>(cudaGetLastError());
}

// The mma route: the pre-pass, the main kernel over (key tile, batch x kv
// head, split), the post-pass (dQ; dK and dV too when split).
template <typename T, int HD>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int BQ = MmaBwd<T>::kRows;
  constexpr size_t smem = mma_smem_bytes<T, HD>();
  auto kernel = flash_attention_bwd_mma_kernel<T, HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.splits < 1 || (a.splits > 1 && a.dkv_acc == nullptr)) return kBadShape;
  const int n_qt = (a.s + BQ - 1) / BQ;
  const int n_kt = (a.s + kMmaKeys - 1) / kMmaKeys;
  const int64_t kv_floats = static_cast<int64_t>(a.batch) * a.nkv * n_kt * kMmaKeys * HD;
  int rc = launch_pre<T, HD>(a, n_qt * BQ, a.splits > 1 ? 2 * kv_floats / HD : 0, stream);
  if (rc != 0) return rc;
  const int elt = static_cast<int>(sizeof(T));
  const int vec16 = rows_aligned16(a.q, a.qs, elt) && rows_aligned16(a.k, a.ks, elt) &&
                    rows_aligned16(a.v, a.vs, elt) && rows_aligned16(a.dout, a.dos, elt);
  const int64_t ctas = static_cast<int64_t>(n_kt) * a.batch * a.nkv * a.splits;
  kernel<<<static_cast<unsigned>(ctas), kMmaThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse_pad),
      static_cast<const float*>(a.delta), static_cast<float*>(a.dq_acc), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), static_cast<float*>(a.dkv_acc), a.batch, a.s, a.nq, a.nkv, a.qs,
      a.ks, a.vs, a.dos, a.causal, a.window, a.scale * kLog2e, a.scale, vec16, a.splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ConvertJobs jobs{};
  const int64_t q_floats = static_cast<int64_t>(a.batch) * a.nq * n_qt * BQ * HD;
  jobs.job[0] = {static_cast<const float*>(a.dq_acc), a.dq, a.nq, BQ, a.scale, q_floats / 4};
  jobs.n = 1;
  if (a.splits > 1) {
    const float* dk_acc = static_cast<const float*>(a.dkv_acc);
    jobs.job[1] = {dk_acc, a.dk, a.nkv, kMmaKeys, a.scale, kv_floats / 4};
    jobs.job[2] = {dk_acc + kv_floats, a.dv, a.nkv, kMmaKeys, 1.f, kv_floats / 4};
    jobs.n = 3;
  }
  int64_t pieces = 0;
  for (int j = 0; j < jobs.n; ++j) pieces += jobs.job[j].pieces;
  flash_attention_bwd_convert_kernel<T, HD>
      <<<static_cast<unsigned>((pieces + kPrePostThreads - 1) / kPrePostThreads),
         kPrePostThreads, 0, stream>>>(jobs, a.s);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma route: the pre-pass, the main kernel, the post-pass.
template <int HD>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  int rc = make_map(&q_map, a.q, a.batch, a.s, a.nq, HD, a.qs, kWgRows);
  if (rc == 0) rc = make_map(&k_map, a.k, a.batch, a.s, a.nkv, HD, a.ks, kWgKeys);
  if (rc == 0) rc = make_map(&v_map, a.v, a.batch, a.s, a.nkv, HD, a.vs, kWgKeys);
  if (rc == 0) rc = make_map(&do_map, a.dout, a.batch, a.s, a.nq, HD, a.dos, kWgRows);
  if (rc != 0) return rc;
  constexpr size_t smem = wgmma_smem_bytes<HD>();
  auto main_kernel = flash_attention_bwd_wgmma_kernel<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_qt = (a.s + kWgRows - 1) / kWgRows;
  rc = launch_pre<bf16, HD>(a, n_qt * kWgRows, 0, stream);
  if (rc != 0) return rc;
  const int ctas = (a.s + kWgKeys - 1) / kWgKeys * a.nkv * a.batch;
  main_kernel<<<ctas, kWgThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(a.lse_pad),
      static_cast<const float*>(a.delta), static_cast<float*>(a.dq_acc),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.batch, a.s, a.nq, a.nkv, a.causal,
      a.window, a.scale * kLog2e, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t parts = static_cast<int64_t>(a.batch) * a.nq * n_qt * (HD / 64);
  flash_attention_bwd_post_kernel<HD><<<static_cast<unsigned>(parts), kPrePostThreads, 0,
                                        stream>>>(static_cast<const float*>(a.dq_acc),
                                                  static_cast<bf16*>(a.dq), a.s, a.nq, n_qt,
                                                  a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// q, o, dout: (B, S, nq, hd); k, v: (B, S, nkv, hd); all in `dtype`,
// addressed by the given (batch, seq, head) strides in elements with
// head_dim contiguous.  dq: contiguous (B, S, nq, hd), dk and dv:
// contiguous (B, S, nkv, hd), in `dtype`.  lse: the forward's, f32 (B,
// nq, S) in log2 units.  Routes (the wrapper's bwd_route): bf16 at
// head_dim 64 and 128 runs the wgmma kernel (q, k, v and dout must suit
// TMA: base addresses and strides multiples of 16 bytes); bf16 at 32 and
// 80 and f32 at every head_dim the mma kernel.  Each between the pre-pass
// and a post-pass.  Scratch, f32, with S_pad = S rounded up to the
// route's query tile (64; 32 for f32): delta and lse_pad (B * nq * S_pad
// each), dq_acc (B * nq * S_pad * hd); on the mma route with splits > 1
// (the wrapper's bwd_plan), dkv_acc (2 * B * nkv * S_kpad * hd, S_kpad =
// S rounded up to 128), else null; the wgmma route takes splits 1.
// Launches on `stream`.  Returns 0, a cudaError_t, or a negative
// repro::ArgError.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, void* lse, void* delta, void* lse_pad, void* dq_acc, void* dkv_acc,
    int batch, int s, int nq, int nkv, int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,
    int dtype, int causal, int window, int splits, float scale, void* stream) {
  using namespace repro;
  if (nkv <= 0 || nq % nkv != 0) return kBadGroup;
  if (batch <= 0 || s <= 0) return kBadShape;
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, lse_pad, dq_acc, dkv_acc, batch, s,
               nq, nkv, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {o_sb, o_ss, o_sh}, {do_sb, do_ss, do_sh}, causal, window, splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    switch (hd) {
      case 32:
        return launch_mma<float, 32>(a, st);
      case 64:
        return launch_mma<float, 64>(a, st);
      case 80:
        return launch_mma<float, 80>(a, st);
      case 128:
        return launch_mma<float, 128>(a, st);
      default:
        return kBadHeadDim;
    }
  }
  if (dtype != kBF16) return kBadDType;
  switch (hd) {
    case 32:
      return launch_mma<bf16, 32>(a, st);
    case 64:
      return splits == 1 ? launch_wgmma<64>(a, st) : kBadShape;
    case 80:
      return launch_mma<bf16, 80>(a, st);
    case 128:
      return splits == 1 ? launch_wgmma<128>(a, st) : kBadShape;
    default:
      return kBadHeadDim;
  }
}
