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
//    of 64 KB at hd 128, 225 KB in all.  Under training the epilogue also
//    writes each row's logsumexp (log2 units, m * scale * log2(e) +
//    log2(l)) for the backward: a template flag (kLse), so the serving
//    forward launches the instantiation without it, unchanged.
//
// 2. f32 at every head_dim, and bf16 at head_dim 32 and 80:
//    flash_attention_mma_kernel, on the tensor cores through warp-level
//    mma.sync.  Bound: the same arithmetic.  f32 is held to 2e-5 of the
//    plain version, which one TF32 product (10 mantissa bits) misses, so
//    every f32 product is split: a = a_hi + a_lo with both rounded to
//    TF32 (cvt.rna), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi into f32
//    accumulators, three m16n8k8 TF32 mma per product (CUTLASS's
//    OpMultiplyAddFastF32; kernels/ref.py: flash_attention_tf32x3 is this
//    arithmetic in plain PyTorch, held to the JAX oracle at 2e-5 on the
//    CPU).  The f32 bound is therefore 3 x operations / 495 TFLOP/s of
//    dense TF32 against bytes / 3.35 TB/s (the CUDA cores give 67
//    TFLOP/s).  bf16 at hd 32 and 80 runs m16n8k16 with f32 accumulators;
//    hd 80 rows (160 B) need no TMA box here.  Design: one CTA per
//    (64-row query tile, query head, batch), four warps of 16 query rows.
//    bf16 Q stays in registers as A fragments for the whole pass; f32 Q
//    (scaled) stays in shared memory and each warp reads and splits its
//    16 rows per key tile, which leaves the registers to O (Q and O both
//    in registers need more than 255 a thread at hd 128).  K and V
//    tiles (32 keys in f32, 64 in bf16) are double-buffered in shared
//    memory by cp.async (16-byte copies when every row starts on a
//    16-byte boundary, element copies otherwise), with rows padded by 4
//    f32 or 8 bf16 so that fragment reads and ldmatrix phases are free of
//    bank conflicts.  The online softmax runs on the S accumulators in
//    registers (row max and sum over the quad of lanes that holds a row,
//    ex2.approx of (s - m) log2(e)), and P enters P V from registers:
//    for bf16 two S tiles are one A fragment (FlashAttention-2's layout)
//    and V's B fragments come from ldmatrix.trans; for TF32 the keys of
//    each k8 step are permuted so that S's C fragment (columns 2 t, 2 t +
//    1) is P's A fragment (columns t, t + 4), and V is read at the same
//    permuted rows, so P needs no shuffle and no trip through shared
//    memory.  Per-element masks are applied only to the tiles that a
//    warp's rows do not see whole.  Under training the epilogue also
//    writes each row's logsumexp (log2 units, m log2(e) + log2(l)) for the
//    backward: a template flag (kLse), as in kernel 1.
//
// Both skip key tiles exactly: a tile is skipped only when it is masked
// for every row of the query tile AND every row of that tile has a
// visible key elsewhere (a causal row at a negative position has none).
//
// Hazards met by the wgmma kernel, and what it does about them (its TMA,
// mbarrier, swizzle and wgmma helpers live in hopper.cuh, shared with the
// backward):
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

#include <type_traits>

#include "hopper.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// Shared by both kernels
// ---------------------------------------------------------------------------

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

// kLse: also write each row's logsumexp of the scaled scores, in log2
// units (m * scale_log2 + log2(l)), to lse (B, nq, Sq) f32: the unit the
// backward takes.  A template flag, not a runtime branch: serving launches
// the instantiation without it, which is the kernel it was before.
template <int HD, bool kLse>
__global__ void __launch_bounds__(kTcThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
    float* __restrict__ lse, int sq, int sk, int nq, int nkv, int causal, int window,
    float scale_log2) {
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
      wgmma_rs_hd<HD>(o, pa[kk], sw128_desc(smem_u32(sm.v[st][0]) + kk * 16 * kBoxRowBytes,
                                             kTileBytes, 8 * kBoxRowBytes));
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
    if constexpr (kLse) {
      const int i = tile * kTcRows + row;
      if (col == 0 && i < sq)
        lse[(static_cast<int64_t>(b) * nq + h) * sq + i] = m[rr] * scale_log2 + log2f(l[rr]);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int chunk = (j % 8) ^ (row % 8);  // 16-byte chunk after the swizzle
      unsigned char* dst = reinterpret_cast<unsigned char*>(sm.q[j / 8]) + row * kBoxRowBytes +
                           chunk * 16 + col * 2;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
    }
  }
  fence_async_smem();  // visible to TMA
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

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int batch,
                 int sq, int sk, int nq, int nkv, Strides qs, Strides ks, Strides vs,
                 int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, o_map;
  const Strides os{static_cast<int64_t>(sq) * nq * HD, static_cast<int64_t>(nq) * HD, HD};
  int rc = make_map(&q_map, q, batch, sq, nq, HD, qs, kTcRows);
  if (rc == 0) rc = make_map(&k_map, k, batch, sk, nkv, HD, ks, kTcKeys);
  if (rc == 0) rc = make_map(&v_map, v, batch, sk, nkv, HD, vs, kTcKeys);
  if (rc == 0) rc = make_map(&o_map, out, batch, sq, nq, HD, os, 64);
  if (rc != 0) return rc;
  constexpr size_t smem = tc_smem_bytes<HD>();
  auto plain = flash_attention_wgmma_kernel<HD, false>;
  auto with_lse = flash_attention_wgmma_kernel<HD, true>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(plain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)),
      cudaFuncSetAttribute(with_lse, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem))};
  for (cudaError_t e : attr)
    if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((sq + kTcRows - 1) / kTcRows, nq, batch);
  const float log2e = 1.4426950408889634f;
  auto kernel = lse ? with_lse : plain;
  kernel<<<grid, kTcThreads, smem, stream>>>(q_map, k_map, v_map, o_map, lse, sq, sk, nq, nkv,
                                             causal, window, scale * log2e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Warp-level tensor-core kernel (mma.sync): f32 at every head_dim, bf16 at
// head_dim 32 and 80
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per CTA: 16 per warp

// Keys per shared-memory tile and the padding of a tile row (elements):
// rows of HD + 4 f32 or HD + 8 bf16 keep every fragment read and every
// ldmatrix phase free of bank conflicts at head_dim 32, 64, 80 and 128,
// and keep 16-byte cp.async destinations aligned.
template <typename T>
struct MmaTile;
template <>
struct MmaTile<float> {
  static constexpr int kKeys = 32;
  static constexpr int kPad = 4;
};
template <>
struct MmaTile<__nv_bfloat16> {
  static constexpr int kKeys = 64;
  static constexpr int kPad = 8;
};

template <typename T, int HD>
constexpr size_t mma_smem_bytes() {
  // two stages of a K tile and a V tile, and for f32 the CTA's Q tile
  constexpr size_t row = (HD + MmaTile<T>::kPad) * sizeof(T);
  return 4 * MmaTile<T>::kKeys * row + (std::is_same<T, float>::value ? kMmaRows * row : 0);
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  return static_cast<T>(0.f);
}

// Rows [j0, j0 + kKeys) of one kv head's K and V into a shared tile of
// rows padded to LD; rows past Sk are zeros (V must stay finite: P is 0
// there).  With every address a multiple of 16 bytes (vec16) the copy is
// cp.async of 16 bytes; otherwise element by element.
template <typename T, int HD>
__device__ __forceinline__ void load_kv_tile(T* k_dst, T* v_dst, const T* kb, const T* vb,
                                             int j0, int sk, int64_t k_ss, int64_t v_ss,
                                             int vec16) {
  constexpr int BN = MmaTile<T>::kKeys;
  constexpr int LD = HD + MmaTile<T>::kPad;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kRowChunks = HD / kVec;
  if (vec16) {
    for (int idx = threadIdx.x; idx < BN * kRowChunks; idx += kMmaThreads) {
      const int r = idx / kRowChunks;
      const int c = (idx % kRowChunks) * kVec;
      const int j = j0 + r;
      const int bytes = j < sk ? 16 : 0;
      const int64_t jj = j < sk ? j : 0;  // a valid address even when nothing is read
      cp_async16(k_dst + r * LD + c, kb + jj * k_ss + c, bytes);
      cp_async16(v_dst + r * LD + c, vb + jj * v_ss + c, bytes);
    }
  } else {
    for (int idx = threadIdx.x; idx < BN * HD; idx += kMmaThreads) {
      const int r = idx / HD;
      const int d = idx % HD;
      const int j = j0 + r;
      k_dst[r * LD + d] = j < sk ? kb[static_cast<int64_t>(j) * k_ss + d] : zero_of<T>();
      v_dst[r * LD + d] = j < sk ? vb[static_cast<int64_t>(j) * v_ss + d] : zero_of<T>();
    }
  }
}

// kLse: also write each row's logsumexp of the scaled scores, in log2
// units (m log2(e) + log2(l)), to lse (B, nq, Sq) f32, as the wgmma
// kernel's kLse does; serving launches the instantiation without it.
template <typename T, int HD, bool kLse>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int nq, int nkv, Strides qs,
    Strides ks, Strides vs, int causal, int window, float scale, int vec16) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int BN = MmaTile<T>::kKeys;
  constexpr int LD = HD + MmaTile<T>::kPad;
  constexpr int NT = BN / 8;  // n8 tiles of S, k8 steps of P V (f32)
  constexpr int DT = HD / 8;  // n8 tiles of O, k8 steps of Q K^T (f32)
  constexpr int KQ = kF32 ? HD / 8 : HD / 16;  // k steps of Q K^T
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* tiles = reinterpret_cast<T*>(mma_smem);  // stage s: K at 2s, V at 2s + 1
  float* q_s = reinterpret_cast<float*>(tiles + 4 * BN * LD);  // f32: the Q tile, scaled

  // longest query tiles first when causal
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and row + 8)
  const int t4 = lane % 4;  // fragment column pair
  const int row0 = tile * kMmaRows + warp * 16;
  const int shift = sk - sq;
  const bool warp_live = row0 < sq;
  const int rows[2] = {row0 + g, row0 + g + 8};

  // Q as A fragments: bf16 packed in pairs and kept in registers (S is
  // scaled after the product); f32 scaled into shared memory, each warp's
  // 16 rows read and split per key tile (registers hold O instead)
  uint32_t qb[kF32 ? 1 : KQ][4];
  if constexpr (kF32) {
    for (int idx = threadIdx.x; idx < kMmaRows * HD; idx += kMmaThreads) {
      const int r = idx / HD;
      const int d = idx % HD;
      const int i = tile * kMmaRows + r;
      q_s[r * LD + d] =
          i < sq ? to_f32(q[b * qs.b + static_cast<int64_t>(i) * qs.s + h * qs.h + d]) * scale
                 : 0.f;
    }
  } else {
    const T* qp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      qp[r] = q + b * qs.b + static_cast<int64_t>(min(rows[r], sq - 1)) * qs.s + h * qs.h;
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e & 1;  // a0, a2: row g; a1, a3: row g + 8
        const bool live = rows[r] < sq;
        const int d = kq * 16 + 2 * t4 + (e >> 1) * 8;
        qb[kq][e] = pack_bf16x2(live ? to_f32(qp[r][d]) : 0.f,
                                live ? to_f32(qp[r][d + 1]) : 0.f);
      }
    }
  }
  const float* q_w = q_s + (warp * 16 + g) * LD + t4;  // f32: this lane's row g, column t4

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  int j_begin, j_end;
  key_range(tile * kMmaRows, kMmaRows, sq, sk, causal, window, &j_begin, &j_end);
  j_begin = (j_begin / BN) * BN;
  const int n_tiles = (j_end - j_begin + BN - 1) / BN;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  // a tile needs per-element masks unless every key of it is visible to
  // every row of this warp
  const int wpos_lo = row0 + shift;
  const int wpos_hi = row0 + 15 + shift;

  load_kv_tile<T, HD>(tiles, tiles + BN * LD, kb, vb, j_begin, sk, ks.s, vs.s, vec16);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = j_begin + it * BN;
    if (it + 1 < n_tiles) {
      T* next = tiles + ((it + 1) & 1) * 2 * BN * LD;
      load_kv_tile<T, HD>(next, next + BN * LD, kb, vb, j0 + BN, sk, ks.s, vs.s, vec16);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile `it` has landed (the newest group may still fly)
    __syncthreads();
    const T* k_s = tiles + (it & 1) * 2 * BN * LD;
    const T* v_s = k_s + BN * LD;

    if (warp_live) {
      // S = Q K^T: rows g, g + 8; keys j0 + 8 nt + 2 t4 + {0, 1}
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        if constexpr (kF32) {
          // a0: (g, t4), a1: (g + 8, t4), a2: (g, t4 + 4), a3: (g + 8, t4 + 4)
          uint32_t a_hi[4], a_lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(q_w[(e & 1) * 8 * LD + kq * 8 + (e >> 1) * 4], a_hi[e], a_lo[e]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float* kr = k_s + (nt * 8 + g) * LD + kq * 8 + t4;
            mma_tf32x3(s[nt], a_hi, a_lo, kr[0], kr[4]);
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const T* kr = k_s + (nt * 8 + g) * LD + kq * 16 + 2 * t4;
            mma_bf16(s[nt], qb[kq], *reinterpret_cast<const uint32_t*>(kr),
                     *reinterpret_cast<const uint32_t*>(kr + 8));
          }
        }
      }
      if constexpr (!kF32) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
      }
      const bool need_mask = j0 + BN > sk || (causal && j0 + BN - 1 > wpos_lo) ||
                             (window > 0 && j0 <= wpos_hi - window);
      if (need_mask) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
            const int pos = rows[e >> 1] + shift;
            const bool visible = (!causal || j <= pos) && (window <= 0 || j > pos - window);
            // padding past Sk is excluded (-inf), masked keys take -2**30
            s[nt][e] = j >= sk ? -__int_as_float(0x7f800000) : (visible ? s[nt][e] : kNegInf);
          }
        }
      }

      // online softmax; a row's four values sit in the quad of lanes 4g..4g+3
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mt[0] = fmaxf(mt[0], fmaxf(s[nt][0], s[nt][1]));
        mt[1] = fmaxf(mt[1], fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float alpha = fast_exp2((m[r] - mt[r]) * kLog2e);
        m[r] = mt[r];
        l[r] *= alpha;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          o[dt][2 * r] *= alpha;
          o[dt][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = fast_exp2((s[nt][e] - m[e >> 1]) * kLog2e);
          l[e >> 1] += s[nt][e];
        }
      }

      // O += P V
      if constexpr (kF32) {
        // The C fragment of S (columns 2 t4, 2 t4 + 1) is used as the A
        // fragment of P (columns t4, t4 + 4) with the keys of each k8
        // step permuted: A column t4 is key 2 t4, column t4 + 4 key
        // 2 t4 + 1, and V's B fragment reads the same keys.  No shuffle.
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          uint32_t a_hi[4], a_lo[4];
          split_tf32(s[kk][0], a_hi[0], a_lo[0]);
          split_tf32(s[kk][2], a_hi[1], a_lo[1]);
          split_tf32(s[kk][1], a_hi[2], a_lo[2]);
          split_tf32(s[kk][3], a_hi[3], a_lo[3]);
          const float* vr = v_s + (kk * 8 + 2 * t4) * LD + g;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt)
            mma_tf32x3(o[dt], a_hi, a_lo, vr[dt * 8], vr[LD + dt * 8]);
        }
      } else {
        // two S tiles of 8 keys are one A fragment of 16 keys, packed as
        // they lie (FlashAttention-2's layout); V's B fragments through
        // ldmatrix.trans, two n8 tiles per instruction
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                 pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                 pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                 pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const T* vrow = v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          (lane >> 4) * 8;
#pragma unroll
          for (int dt = 0; dt < DT; dt += 2) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, vrow + dt * 8);
            mma_bf16(o[dt], a, bv[0], bv[1]);
            mma_bf16(o[dt + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the load two tiles on
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= sq) continue;
    if constexpr (kLse) {
      if (t4 == 0)
        lse[(static_cast<int64_t>(b) * nq + h) * sq + rows[r]] = m[r] * kLog2e + log2f(l[r]);
    }
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* op = out + ((static_cast<int64_t>(b) * sq + rows[r]) * nq + h) * HD + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const float x0 = o[dt][2 * r] * inv;
      const float x1 = o[dt][2 * r + 1] * inv;
      if constexpr (kF32) {
        *reinterpret_cast<float2*>(op + dt * 8) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(op + dt * 8) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <typename T, int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int batch,
               int sq, int sk, int nq, int nkv, Strides qs, Strides ks, Strides vs, int causal,
               int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<T, HD>();
  auto plain = flash_attention_mma_kernel<T, HD, false>;
  auto with_lse = flash_attention_mma_kernel<T, HD, true>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(plain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)),
      cudaFuncSetAttribute(with_lse, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem))};
  for (cudaError_t e : attr)
    if (e != cudaSuccess) return static_cast<int>(e);
  const int elt = static_cast<int>(sizeof(T));
  const int vec16 = rows_aligned16(k, ks, elt) && rows_aligned16(v, vs, elt);
  dim3 grid((sq + kMmaRows - 1) / kMmaRows, nq, batch);
  auto kernel = lse ? with_lse : plain;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sq, sk, nq, nkv, qs, ks, vs, causal, window, scale, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// q: (B, Sq, nq, hd), k/v: (B, Sk, nkv, hd), all in `dtype`, addressed by
// the given (batch, seq, head) strides in elements with head_dim
// contiguous; out: contiguous (B, Sq, nq, hd) in `dtype`.  bf16 at head_dim
// 64 and 128 runs the wgmma kernel (its base addresses and strides must be
// multiples of 16 bytes); f32 at every head_dim and bf16 at 32 and 80 the
// mma.sync kernel.  lse: null, or a contiguous f32 (B, nq, Sq) that
// receives each row's logsumexp in log2 units (either kernel's kLse
// instantiation).  Returns 0, a cudaError_t, or a negative
// repro::ArgError.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int batch, int sq, int sk, int nq, int nkv,
                                      int hd,
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
  float* lse_out = static_cast<float*>(lse);
  if (dtype == kF32) {
    switch (hd) {
      case 32:
        return launch_mma<float, 32>(q, k, v, out, lse_out, batch, sq, sk, nq, nkv, qs,
                                     ks, vs, causal, window, scale, s);
      case 64:
        return launch_mma<float, 64>(q, k, v, out, lse_out, batch, sq, sk, nq, nkv, qs,
                                     ks, vs, causal, window, scale, s);
      case 80:  // Zamba2's shared attention
        return launch_mma<float, 80>(q, k, v, out, lse_out, batch, sq, sk, nq, nkv, qs,
                                     ks, vs, causal, window, scale, s);
      case 128:
        return launch_mma<float, 128>(q, k, v, out, lse_out, batch, sq, sk, nq, nkv, qs,
                                      ks, vs, causal, window, scale, s);
      default:
        return kBadHeadDim;
    }
  }
  if (dtype != kBF16) return kBadDType;
  switch (hd) {
    case 32:
      return launch_mma<__nv_bfloat16, 32>(q, k, v, out, lse_out, batch, sq, sk, nq, nkv, qs,
                                           ks, vs, causal, window, scale, s);
    case 64:
      return launch_wgmma<64>(q, k, v, out, lse_out, batch, sq, sk, nq, nkv, qs, ks, vs, causal,
                              window, scale, s);
    case 80:
      return launch_mma<__nv_bfloat16, 80>(q, k, v, out, lse_out, batch, sq, sk, nq, nkv, qs,
                                           ks, vs, causal, window, scale, s);
    case 128:
      return launch_wgmma<128>(q, k, v, out, lse_out, batch, sq, sk, nq, nkv, qs, ks, vs,
                               causal, window, scale, s);
    default:
      return kBadHeadDim;
  }
}
