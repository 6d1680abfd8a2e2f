// Full-sequence (flash) attention for Hopper: online softmax over key
// tiles, GQA, causal or not, sliding window, ragged lengths.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (_fa_kernel).  Computes, for q (B, Sq, nq, hd) and k, v
// (B, Sk, nkv, hd):
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / g]) v[b, j, h / g]
// where query i sits at position p = i + Sk - Sq (ends aligned), key j is
// visible iff (not causal or j <= p) and (window == 0 or j > p - window),
// and masked scores take -2**30 as in the plain version, so a causal row
// at a negative position averages V over every key.  Keys past Sk are
// excluded (weight 0) and rows past Sq are not written, so any Sq and Sk
// are accepted (the vocoder runs Sq 32 over Sk 16).  The output is a
// contiguous (B, Sq, nq, hd) tensor in the input type.
//
// Two kernels, chosen by the wrapper (kernels/flash_attention.py: route):
//
// 1. bf16 at head_dim 64 and 128: flash_attention_wgmma_kernel, on the
//    tensor cores.  Bound: the arithmetic, 4 * Sq * Sk * hd operations per
//    head against 2 * (Sq + Sk) * hd elements moved, far above the card's
//    ~295 operations per byte; the bf16 tensor cores give 989 TFLOP/s,
//    the CUDA cores 67, so only wgmma can approach the bound.  Design:
//    one CTA per (128-row query tile, query head, batch), 384 threads:
//    warpgroup 2 is the producer, warpgroups 0 and 1 consume 64 query
//    rows each.  The producer gives its registers to the consumers with
//    setmaxnreg (24 a thread for it, 240 for them), and its first lane
//    loads the Q tile once and then K and V tiles of 128 keys into
//    three-stage rings with TMA (cp.async.bulk.tensor), K of tile i with
//    V of tile i - 1, the order the consumers use them.  Each ring slot
//    has a "full" mbarrier (arrival plus transaction bytes) and an
//    "empty" mbarrier on which all 256 consumer threads arrive; K is
//    freed as soon as S is computed, V after P V.  A consumer warpgroup
//    computes S = Q K^T as eight (hd 128) or four (hd 64) wgmma
//    m64n128k16 with both operands in shared memory (K is K-major in the
//    (B, S, H, hd) layout), the online softmax on the f32 accumulator in
//    registers (row max and row sum through the quad of lanes that holds
//    a row; one FMA and one ex2 per score, the scale folded into
//    log2(e)), converts P to bf16 in registers and adds P V with wgmma
//    whose A operand is those registers and whose B operand is V in
//    shared memory, MN-major (the transpose bit).  So that the tensor
//    cores do not wait for the softmax, the two warpgroups ping-pong:
//    each issues the P V of its previous tile and the S of its next as
//    one batch of wgmma, hands the tensor cores to the other warpgroup
//    (named barriers 1 and 2), and runs its softmax while the other's
//    batch runs.  O stays in f32 registers until the epilogue, which
//    writes it as bf16 into the warpgroup's own rows of the (by then
//    idle) Q buffer in the same swizzle and stores it with one TMA store
//    per box; TMA leaves out rows past Sq.  Grid x is the query tile
//    (longest first when causal), so the CTAs that share a kv head run
//    together and K/V come from L2.  Shared memory: Q 32 KB + 3 stages
//    of 64 KB at hd 128, 225 KB in all.
//
// 2. f32 (any head_dim) and bf16 at head_dim 32 and 80:
//    flash_attention_simt_kernel, on the CUDA cores in f32.  f32 parity
//    is held at 2e-5, which rules out TF32; hd 80 rows (160 B) fit no TMA
//    swizzle span without splitting the box, and hd 32 tiles are too
//    narrow to feed wgmma.  One CTA per (32-row query tile, query head,
//    batch), four threads per query row, K/V tiles of 32 keys widened to
//    f32 in shared memory.  A register-blocked redesign is queued
//    (ROADMAP Queue 2b).
//
// Both skip key tiles exactly: a tile is skipped only when it is masked
// for every row of the query tile AND every row of that tile has a
// visible key elsewhere (a causal row at a negative position has none).
//
// Hazards met by the tensor-core kernel, and what it does about them:
// - wgmma serialized by ptxas (advisory C7520, then C7512): every HGMMA
//   was followed by a wait, at ~270 TFLOP/s.  Branches ptxas cannot
//   prove uniform over a warp made it serialize: the warp index is
//   broadcast with __shfl_sync and the mbarrier spin stays inside its asm
//   block.  A 288-thread CTA also capped the registers at 168 (ptxas
//   counts whole warpgroups), too few for S, P and O at hd 128: the
//   producer is a full warpgroup that releases its registers.
// - TMA descriptors: cuTensorMapEncodeTiled lives in the driver; it is
//   fetched with cudaGetDriverEntryPoint(ByVersion), so the plain-C nvcc
//   build needs no -lcuda.  The maps are __grid_constant__ kernel
//   parameters over the dims (hd, H, S, B) ordered by stride; the base
//   address and the H, S and B strides must be multiples of 16 bytes (the
//   wrapper checks this and copies a view that fails it; the entry point
//   refuses it with kBadTensorMap).  TMA zero-fills rows past Sq and Sk;
//   the kernel still masks those keys itself.
// - Swizzle: every tile is loaded as boxes of 64 columns (128 B rows)
//   with CU_TENSOR_MAP_SWIZZLE_128B, and every wgmma descriptor names the
//   same 128 B swizzle (layout type 1) with tiles 1024-byte aligned; a
//   hd-128 row is two boxes.  Stepping K by 16 columns inside a box adds
//   32 bytes to the descriptor's start address.
// - Fragment reuse: the m64n128 f32 accumulator of S holds, per thread,
//   rows r and r + 8 at columns 8j + 2(lane % 4) + {0, 1}; for 16-bit
//   types that is exactly the A-operand register layout of the next
//   wgmma, so P is packed to bf16x2 in place, with no shuffle.
// - Async ordering: wgmma.fence before each batch (the accumulators and
//   the A registers were written by ordinary instructions); P V and S
//   are committed as two groups, so wait_group 1 frees V's slot while S
//   may still run, and wait_group 0 comes before S is read.  The batch
//   reads P's registers and writes S and O after the issuing
//   instruction: an empty compiler fence on each, once its group is
//   done, keeps them in place (unmoved, unreused) until then.
// - Ring reuse: a consumer arrives on a slot's empty barrier only after
//   the wgmma that reads it has completed, so the producer never
//   overwrites a tile still in use.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time

#include "common.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// CUDA-core kernel: f32, and bf16 at head_dim 32 and 80
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kRowThreads = 4;                     // threads sharing one query row
constexpr int kBlockQ = kThreads / kRowThreads;    // 32 query rows per CTA
constexpr int kBlockK = 32;                        // keys per shared-memory tile

struct Strides {
  int64_t b, s, h;  // elements; head_dim stride is 1
};

// First and one-past-last key this query tile reads: tiles masked for
// every row are skipped only when every row has a visible key elsewhere.
__device__ __forceinline__ void key_range(int row0, int rows, int sq, int sk, int causal,
                                          int window, int* j_begin, int* j_end) {
  const int shift = sk - sq;
  const int pos_lo = row0 + shift;
  const int pos_hi = min(row0 + rows, sq) - 1 + shift;
  *j_begin = 0;
  *j_end = sk;
  if (!causal || pos_lo >= 0) {
    if (causal) *j_end = min(sk, pos_hi + 1);
    if (window > 0) *j_begin = max(0, pos_lo - window + 1);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_simt_kernel(
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
  const int qpos = i + sk - sq;

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

  int j_begin, j_end;
  key_range(tile * kBlockQ, kBlockQ, sq, sk, causal, window, &j_begin, &j_end);
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
int launch_simt(const void* q, const void* k, const void* v, void* out, int batch, int sq,
                int sk, int nq, int nkv, Strides qs, Strides ks, Strides vs, int causal,
                int window, float scale, cudaStream_t stream) {
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, nq, batch);
  flash_attention_simt_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, nq, nkv, qs, ks, vs, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// f32 at every head_dim the wrapper takes
int launch_simt_f32(int hd, const void* q, const void* k, const void* v, void* out, int batch,
                    int sq, int sk, int nq, int nkv, Strides qs, Strides ks, Strides vs,
                    int causal, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_simt<float, 32>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal,
                                    window, scale, stream);
    case 64:
      return launch_simt<float, 64>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal,
                                    window, scale, stream);
    case 80:  // Zamba2's shared attention; 5 float4 chunks per thread, 20 KB of K/V tiles
      return launch_simt<float, 80>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal,
                                    window, scale, stream);
    case 128:
      return launch_simt<float, 128>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal,
                                     window, scale, stream);
    default:
      return kBadHeadDim;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16 at head_dim 64 and 128 (wgmma fed by TMA)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;                // query rows per CTA: two warpgroups of 64
constexpr int kTcKeys = 128;                // keys per ring stage
constexpr int kTcStages = 3;
constexpr int kTcConsumers = 2 * 128;       // warpgroups 0 and 1
constexpr int kTcThreads = kTcConsumers + 128;  // warpgroup 2 produces (one lane issues)
// registers per thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 65536
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kBox = 64;                    // bf16 columns per TMA box: one 128 B swizzle span
constexpr int kBoxRowBytes = kBox * 2;      // 128
constexpr int kTileBytes = kTcKeys * kBoxRowBytes;  // one (128-row, 64-column) box: 16 KB

template <int HD>
struct TcSmem {
  static constexpr int kBoxes = HD / kBox;
  // each box holds 128 rows of 128 B, swizzled by TMA in 1024 B atoms of
  // 8 rows; every box is a multiple of 1024 B from a 1024 B aligned base
  __nv_bfloat16 q[kBoxes][kTcRows * kBox];
  __nv_bfloat16 k[kTcStages][kBoxes][kTcKeys * kBox];
  __nv_bfloat16 v[kTcStages][kBoxes][kTcKeys * kBox];
  uint64_t q_full;
  uint64_t full_k[kTcStages], empty_k[kTcStages];  // K and V rings have their own
  uint64_t full_v[kTcStages], empty_v[kTcStages];  // barriers: K is freed first
};

template <int HD>
constexpr size_t tc_smem_bytes() {
  return sizeof(TcSmem<HD>) + 1024;  // room to align the base to 1024 B
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase with the given parity has completed.  The
// spin stays inside the asm block: a C++ loop around try_wait is control
// flow that depends on each thread, and ptxas then serializes every wgmma
// of the kernel (advisory C7520).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One TMA box of a 4-D map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
// One box from shared memory to the 4-D map (coordinates innermost first);
// rows outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor with the 128 B swizzle (layout type 1).
// Byte offsets: K-major operands use only SBO (8 rows of 128 B); MN-major
// ones use LBO between 64-column boxes and SBO between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x in one MUFU instruction (-inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the registers across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define REPRO_WG_D8(o)                                                              \
  "+f"(d[(o) + 0]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3]),          \
      "+f"(d[(o) + 4]), "+f"(d[(o) + 5]), "+f"(d[(o) + 6]), "+f"(d[(o) + 7])

// D (64 x 128, f32) = A (shared memory, K-major) * B (shared memory, K-major),
// added to D when `accumulate` is non-zero
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24), REPRO_WG_D8(32),
        REPRO_WG_D8(40), REPRO_WG_D8(48), REPRO_WG_D8(56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, f32) += A (registers: bf16x2 fragments) * B (shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24), REPRO_WG_D8(32),
        REPRO_WG_D8(40), REPRO_WG_D8(48), REPRO_WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32) += A (registers: bf16x2 fragments) * B (shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef REPRO_WG_D8

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
    int sq, int sk, int nq, int nkv, int causal, int window, float scale_log2) {
  // scale_log2 = softmax scale * log2(e): scores stay raw until exp2
  static_assert(HD == 64 || HD == 128, "the tensor-core kernel takes head_dim 64 or 128");
  constexpr int kBoxes = HD / kBox;
  constexpr int kS = kTcKeys / 2;  // S accumulator floats per thread (64 x 128 over 128 threads)
  constexpr int kO = HD / 2;       // O accumulator floats per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  TcSmem<HD>& sm = *reinterpret_cast<TcSmem<HD>*>(smem_raw + ((1024 - (raw & 1023)) & 1023));

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  int j_begin, j_end;
  key_range(tile * kTcRows, kTcRows, sq, sk, causal, window, &j_begin, &j_end);
  j_begin = (j_begin / kTcKeys) * kTcKeys;
  const int n_tiles = (j_end - j_begin + kTcKeys - 1) / kTcKeys;

  // the warp index broadcast from lane 0, so that ptxas sees the role
  // branches below as uniform over each warp (else it serializes the wgmma)
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.empty_k[s], kTcConsumers);
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty_v[s], kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTcConsumers / 32) {
    // producer warpgroup: it hands its registers to the consumers, and one
    // lane issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kTcConsumers / 32 && lane == 0) {
      mbar_expect_tx(&sm.q_full, kTcRows * HD * 2);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load_4d(sm.q[c], &q_map, &sm.q_full, c * kBox, h, tile * kTcRows, b);
      // tile i of one ring, once its slot is free (the first round passes)
      auto load = [&](__nv_bfloat16 (*ring)[kBoxes][kTcKeys * kBox], uint64_t* full,
                      uint64_t* empty, const CUtensorMap* map, int i) {
        const int st = i % kTcStages;
        mbar_wait(&empty[st], ((i / kTcStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], kTcKeys * HD * 2);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load_4d(ring[st][c], map, &full[st], c * kBox, kvh, j_begin + i * kTcKeys, b);
      };
      // in the order the consumers use them: K of tile i with V of tile i - 1
      for (int it = 0; it <= n_tiles; ++it) {
        if (it < n_tiles) load(sm.k, sm.full_k, sm.empty_k, &k_map, it);
        if (it > 0) load(sm.v, sm.full_v, sm.empty_v, &v_map, it - 1);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // consumers: warpgroup wg owns rows wg * 64 .. wg * 64 + 63 of the tile;
  // this thread holds rows r and r + 8, columns 8j + col + {0, 1}
  const int wg = warp / 4;
  const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col = (lane % 4) * 2;
  const int i0 = tile * kTcRows + r;
  const int qpos0 = i0 + sk - sq;
  const int pos_lo = tile * kTcRows + sk - sq;
  const int pos_hi = min(tile * kTcRows + kTcRows, sq) - 1 + sk - sq;

  float o[kO];
#pragma unroll
  for (int x = 0; x < kO; ++x) o[x] = 0.f;
  float s[kS];
  uint32_t pa[kTcKeys / 16][4];     // P of the previous tile, bf16 A fragments
  float m[2] = {kNegInf, kNegInf};  // running row max of the raw scores
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
  const uint32_t q_base = smem_u32(sm.q[0]) + wg * 64 * kBoxRowBytes;

  // S = Q K^T of ring stage st: both K-major, 16 columns of head_dim per wgmma
  auto issue_s = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      const uint64_t da = sw128_desc(q_base + off, 16, 8 * kBoxRowBytes);
      const uint64_t db = sw128_desc(smem_u32(sm.k[st][0]) + off, 16, 8 * kBoxRowBytes);
      wgmma_ss_n128(s, da, db, kk > 0);
    }
  };
  // O += P V of ring stage st: V is MN-major (head_dim contiguous), 16 keys per wgmma
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint64_t db = sw128_desc(smem_u32(sm.v[st][0]) + kk * 16 * kBoxRowBytes,
                                     kTileBytes, 8 * kBoxRowBytes);
      if constexpr (HD == 128)
        wgmma_rs_n128(o, pa[kk], db);
      else
        wgmma_rs_n64(o, pa[kk], db);
    }
  };
  // mask the scores of keys j0 .. j0 + 127, update the running max and sum,
  // rescale O, and leave P in pa (exp2 with the scale folded into one FMA)
  auto softmax = [&](int j0) {
    const bool edge = j0 + kTcKeys > sk || (causal && j0 + kTcKeys - 1 > pos_lo) ||
                      (window > 0 && j0 <= pos_hi - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int x = 0; x < kS; ++x) {
      const int rr = (x / 2) % 2;
      if (edge) {
        const int j = j0 + (x / 4) * 8 + col + (x % 2);
        const int qpos = qpos0 + 8 * rr;
        if (j >= sk)
          s[x] = -__int_as_float(0x7f800000);  // -inf: past Sk is excluded, not masked
        else if ((causal && j > qpos) || (window > 0 && j <= qpos - window))
          s[x] = kNegInf;
      }
      mx[rr] = fmaxf(mx[rr], s[x]);
    }
    float alpha[2], mc[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      alpha[rr] = fast_exp2((m[rr] - mx[rr]) * scale_log2);
      m[rr] = mx[rr];
      mc[rr] = mx[rr] * scale_log2;
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int x = 0; x < kS; ++x) {
      const int rr = (x / 2) % 2;
      s[x] = fast_exp2(fmaf(s[x], scale_log2, -mc[rr]));
      l[rr] += s[x];
    }
#pragma unroll
    for (int x = 0; x < kO; ++x) o[x] *= alpha[(x / 2) % 2];
    // keys 16kk .. 16kk + 15 are the accumulator's n8 blocks 2kk and 2kk + 1:
    // the A-operand layout of the next wgmma
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // Ping-pong: the two warpgroups take turns on the tensor cores.  A turn
  // issues one batch of wgmma (P V of the previous tile and S of this
  // one) and hands over; the warpgroup then waits for its batch and runs
  // its softmax while the other's batch runs.  Warpgroup w waits for its
  // turn on named barrier 1 + w and hands over on 2 - w; both take
  // n_tiles + 1 turns, warpgroup 0 first.
  auto turn_wait = [&]() { named_bar_sync(1 + wg, kTcConsumers); };
  auto turn_pass = [&](bool last) {
    if (!(last && wg == 1)) named_bar_arrive(2 - wg, kTcConsumers);
  };
  if (wg == 1) turn_pass(false);
  mbar_wait(&sm.q_full, 0);

  for (int it = 0; it <= n_tiles; ++it) {
    const int st = it % kTcStages;
    const int prev = (it + kTcStages - 1) % kTcStages;
    if (it < n_tiles) mbar_wait(&sm.full_k[st], (it / kTcStages) & 1);
    if (it > 0) mbar_wait(&sm.full_v[prev], ((it - 1) / kTcStages) & 1);
    turn_wait();
    fence_regs<kS>(s);
    fence_regs<kO>(o);
    wgmma_fence();
    if (it > 0) {
      issue_pv(prev);
      wgmma_commit();
    }
    if (it < n_tiles) {
      issue_s(st);
      wgmma_commit();
    }
    turn_pass(it == n_tiles);
    // the batch reads pa and writes o and s asynchronously: each is fenced
    // (kept in its registers, unmoved and unreused) once its group is done
    if (it > 0) {
      if (it < n_tiles)
        wgmma_wait<1>();  // P V done, S may still run
      else
        wgmma_wait<0>();
      fence_regs<kO>(o);
      fence_regs<kTcKeys / 4>(&pa[0][0]);
      mbar_arrive(&sm.empty_v[prev]);  // V of tile it - 1 is no longer read
    }
    if (it < n_tiles) {
      wgmma_wait<0>();
      fence_regs<kS>(s);
      mbar_arrive(&sm.empty_k[st]);  // K of tile it is no longer read
      softmax(j_begin + it * kTcKeys);
    }
  }

  // epilogue: finish the row sums across the quad and normalise; write O
  // as bf16 into this warpgroup's own rows of the Q buffer (no wgmma reads
  // them any more) in the same 128 B swizzle, and let one lane store the
  // tile with TMA, which leaves out the rows past Sq
  const int row_wg = r - wg * 64;  // this thread's first row within the warpgroup's 64
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const float inv = 1.f / l[rr];
    const int row = wg * 64 + row_wg + 8 * rr;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int chunk = (j % 8) ^ (row % 8);  // 16-byte chunk after the swizzle
      unsigned char* dst = reinterpret_cast<unsigned char*>(sm.q[j / 8]) + row * kBoxRowBytes +
                           chunk * 16 + col * 2;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
  named_bar_sync(3 + wg, 128);
  const int row0 = tile * kTcRows + wg * 64;
  if (threadIdx.x % 128 == 0 && row0 < sq) {
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
      tma_store_4d(&o_map, sm.q[c] + wg * 64 * kBox, c * kBox, h, row0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before the CTA exits
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (thread-safe
// static initialisation); null if the driver does not offer it.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Map of a bf16 (B, S, H, hd) tensor as dims (hd, H, S, B), boxes of
// (64 columns, 1 head, `rows` rows, 1 batch) with the 128 B swizzle.
int make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int hd,
             Strides st, int rows) {
  const int64_t bytes[3] = {st.h * 2, st.s * 2, st.b * 2};
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return kBadTensorMap;
  for (int64_t x : bytes)
    if (x <= 0 || x % 16 != 0) return kBadTensorMap;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kBadTensorMap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(bytes[0]),
                                 static_cast<cuuint64_t>(bytes[1]),
                                 static_cast<cuuint64_t>(bytes[2])};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int batch, int sq,
                 int sk, int nq, int nkv, Strides qs, Strides ks, Strides vs, int causal,
                 int window, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, o_map;
  const Strides os{static_cast<int64_t>(sq) * nq * HD, static_cast<int64_t>(nq) * HD, HD};
  int rc = make_map(&q_map, q, batch, sq, nq, HD, qs, kTcRows);
  if (rc == 0) rc = make_map(&k_map, k, batch, sk, nkv, HD, ks, kTcKeys);
  if (rc == 0) rc = make_map(&v_map, v, batch, sk, nkv, HD, vs, kTcKeys);
  if (rc == 0) rc = make_map(&o_map, out, batch, sq, nq, HD, os, 64);
  if (rc != 0) return rc;
  constexpr size_t smem = tc_smem_bytes<HD>();
  auto kernel = flash_attention_wgmma_kernel<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((sq + kTcRows - 1) / kTcRows, nq, batch);
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, kTcThreads, smem, stream>>>(q_map, k_map, v_map, o_map, sq, sk, nq, nkv,
                                             causal, window, scale * log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// q: (B, Sq, nq, hd), k/v: (B, Sk, nkv, hd), all in `dtype`, addressed by
// the given (batch, seq, head) strides in elements with head_dim
// contiguous; out: contiguous (B, Sq, nq, hd) in `dtype`.  bf16 at head_dim
// 64 and 128 runs the tensor-core kernel (its base addresses and strides
// must be multiples of 16 bytes); everything else the CUDA-core kernel.
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
    return launch_simt_f32(hd, q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal, window,
                           scale, s);
  if (dtype != kBF16) return kBadDType;
  switch (hd) {
    case 32:
      return launch_simt<__nv_bfloat16, 32>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs,
                                            causal, window, scale, s);
    case 64:
      return launch_wgmma<64>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal, window,
                              scale, s);
    case 80:
      return launch_simt<__nv_bfloat16, 80>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs,
                                            causal, window, scale, s);
    case 128:
      return launch_wgmma<128>(q, k, v, out, batch, sq, sk, nq, nkv, qs, ks, vs, causal, window,
                               scale, s);
    default:
      return kBadHeadDim;
  }
}
