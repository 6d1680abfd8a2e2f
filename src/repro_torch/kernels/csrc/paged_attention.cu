// One-token decode attention over a block-paged KV pool, for Hopper,
// with the tokens of each row split over several CTAs (flash-decoding).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:
// paged_attention (_pa_kernel, _pa_kernel_quant).  Computes, for every
// sequence b and query head h (kv head h / g):
//   out[b, h] = softmax_t(scale * q[b, h] . K[t]) V[t]
// over the tokens t < seq_lens[b] (and t > seq_lens[b] - 1 - window when
// window > 0), reading token t from page block_tables[b, t / page], slot
// t % page.  int8 pools are dequantized with their per-(page, slot, head)
// f32 scale as each element is used.  A row with seq_len 0 (an inactive
// decode slot) reads no page and comes out as zeros; the plain version
// averages V there instead.  Both are finite, and the serving path
// discards those rows.
//
// Bound: device-memory bytes.  Every K/V element of a visible token is
// read once and used for g query rows, ~2g operations per byte read, far
// below the card's ~295 operations per byte.  So the kernel must read
// each visible token once per (sequence, kv head) and keep enough bytes
// in flight on every SM.  With one CTA per (kv head, sequence), the 14B
// decode shape (8 rows, 8 kv heads) filled 64 of 132 SMs, each walking up
// to 2048 tokens alone.  Design:
// - Split-K: the grid is (kv head x head block, sequence, split).  Split
//   s takes the tokens [s * partition, (s + 1) * partition) of its row
//   that are visible; partition (256 by default, a multiple of the 32-
//   token tile) and the number of splits, ceil(pp * page / partition),
//   come from shapes alone, so the wrapper never reads seq_lens on the
//   host.  A CTA whose tokens are all invisible (past seq_len, or before
//   the window) exits at once.  The g query heads of a kv head are taken
//   in balanced blocks of at most 4 (Qwen2.5-14B's g = 5: 3 and 2),
//   which keeps a thread under ~130 registers so that 3-4 CTAs share an
//   SM and the working CTAs run in one round.  At the 14B shape that is 16 x 8 x 8
//   = 1024 CTAs, about half of them with visible tokens; the head blocks
//   of one (sequence, split, kv head) are neighbours in the grid, so the
//   second reads its K/V from L2.
// - Each CTA writes its partial (m, l, acc[g, hd]) in f32 to scratch the
//   wrapper allocates; paged_attention_combine_kernel then merges a row's
//   partials with the usual max-rescale, in split order (no atomics, so
//   the sums are the same from run to run).  It launches right after on
//   the same stream, so a call is two launches; with one split (a row
//   of at most `partition` tokens) the first kernel writes the output
//   itself and the call is one launch.  A row whose partitions are all
//   empty gives zeros.
// - Inside a CTA (128 threads, 4 warps): K and V tiles of 32 tokens stay
//   in shared memory in their stored type (f32, bf16 or int8), loaded
//   with 16-byte cp.async into a ring of three stages (two for f32 at
//   head_dim 128), so two tiles are in flight while one is used; one
//   __syncthreads per tile.  The pool row of every token of the
//   partition is resolved through the block table once, into shared
//   memory, so a tile's copies wait on no other load, and a partition
//   may start mid-page.  Each warp owns 8 tokens of every tile and keeps
//   its own online-softmax state (in the log2 domain: q is scaled by
//   scale * log2(e), one ex2 per score); a lane owns 8 elements of
//   head_dim and holds the CTA's query rows for them in registers, so
//   one K row read from shared memory serves all the g heads, with a
//   reduction over the head_dim/8 lanes of that row.  The warps' states
//   are merged through shared memory at the end.
// Tensor cores are not used: at g = 5 rows per kv head a 64-row wgmma
// tile would be mostly empty, and the kernel is bytes-bound anyway.
//
// Hazards met, and what the kernel does about them:
// - A partition may start mid-page and a window may begin inside one: a
//   CTA's tokens are [max(first visible, s * partition), min(seq_len,
//   (s + 1) * partition)), each looked up through the block table.
// - int8 pools: the per-(page, slot, head) scales are copied beside each
//   tile and applied to every element as it is used.
// - The combine kernel must see every partial: it runs next on the same
//   stream (no host sync between the two) and reads exactly the splits
//   that held a visible token, computed from seq_lens by the same rule
//   as the split kernel; an empty partition writes nothing and is never
//   read.  Partials and the merge use the log2 domain throughout.
// - Tile loads past the partition's last token are zero-filled cp.async
//   (source size 0) and get weight 0, so no stale shared memory (NaN)
//   reaches the sums.

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                     // tokens per shared-memory stage
constexpr int kWarpTokens = kTile / kWarps;   // tokens of a tile each warp owns
constexpr int kMaxGroup = 16;                 // query heads per kv head accepted
constexpr int kHeads = 4;                     // query heads per CTA (blocks of a group)
constexpr int kElems = 8;                     // head_dim elements per lane
constexpr int kMaxSmem = 227 * 1024;          // dynamic shared memory a CTA may have

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive elements of KT at p (16- or 8-byte aligned), widened to f32
template <typename KT, int N>
__device__ __forceinline__ void load_vec(const KT* p, float* out) {
  using V = typename std::conditional<N * sizeof(KT) == 16, uint4, uint2>::type;
  static_assert(N * sizeof(KT) == sizeof(V), "one vector load");
  const V raw = *reinterpret_cast<const V*>(p);
  const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
}

// Shared-memory stages of the cp.async ring: three when a stage (K and V
// tiles) is at most 16 KB, else two (f32 at head_dim 128)
template <typename KT, int HD>
__host__ __device__ constexpr int stages_of() {
  return 2 * kTile * HD * sizeof(KT) <= 16384 ? 3 : 2;
}

template <typename KT, int HD>
__host__ __device__ constexpr size_t split_smem_bytes() {
  const size_t ring = stages_of<KT, HD>() * (2 * kTile * HD * sizeof(KT) + 2 * kTile * 4);
  const size_t merge = 4 * kWarps * kHeads * (HD + 2);
  return ring > merge ? ring : merge;
}

// 2^x in one MUFU instruction (-inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Visible tokens of a row: [first, seq_len), seq_len clamped to the table
__device__ __forceinline__ void visible_range(const int* seq_lens, int b, int pp, int page,
                                              int window, int* first, int* last) {
  const int seq_len = min(seq_lens[b], pp * page);
  *last = seq_len;
  *first = window > 0 ? max(0, seq_len - window) : 0;
}

template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_split_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages, const KT* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    QT* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_ml, int nq,
    int nkv, int page, int pp, int window, int partition, float scale_log2) {
  // scores are kept in the log2 domain (q is scaled by scale * log2(e))
  constexpr int kLanes = HD / kElems;            // lanes per token row: 4, 8, 16
  constexpr int kGroups = 32 / kLanes;           // tokens a warp takes at once
  constexpr int kSteps = kWarpTokens / kGroups;  // steps over a warp's tokens of a tile
  constexpr int kVec = 16 / sizeof(KT) < kElems ? 16 / sizeof(KT) : kElems;
  constexpr int kChunks = kElems / kVec;         // vector reads per lane and row
  constexpr int kRow16 = HD * sizeof(KT) / 16;   // 16-byte copies per token row
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kStages = stages_of<KT, HD>();
  static_assert(kSteps * kGroups == kWarpTokens, "tile split over the warps");

  const int g = nq / nkv;
  const int n_hblocks = (g + kHeads - 1) / kHeads;
  const int hbs = (g + n_hblocks - 1) / n_hblocks;  // balanced: g = 5 gives 3 and 2
  const int kvh = blockIdx.x / n_hblocks;
  const int hb = blockIdx.x % n_hblocks;
  const int h0 = kvh * g + hb * hbs;             // first query head of this CTA
  const int nh = min(hbs, g - hb * hbs);         // query heads of this CTA
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const bool direct = gridDim.z == 1;            // one split: write the output here

  int first, last;
  visible_range(seq_lens, b, pp, page, window, &first, &last);
  const int t_begin = max(first, split * partition);
  const int t_end = min(last, (split + 1) * partition);
  if (t_begin >= t_end) {
    if (direct) {  // seq_len 0: zeros
      QT* ob = out + (static_cast<int64_t>(b) * nq + h0) * HD;
      for (int i = threadIdx.x; i < nh * HD; i += kThreads) store_f32(ob + i, 0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  KT* k_s = reinterpret_cast<KT*>(smem);            // [kStages][kTile][HD]
  KT* v_s = k_s + kStages * kTile * HD;             // [kStages][kTile][HD]
  float* ks_s = reinterpret_cast<float*>(v_s + kStages * kTile * HD);  // [kStages][kTile]
  float* vs_s = ks_s + kStages * kTile;             // (int8 scales)
  // pool row (page * page_size + slot) * nkv + kv head of every token of the
  // partition, resolved once through the block table
  int* row_s = reinterpret_cast<int*>(smem + split_smem_bytes<KT, HD>());

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / kLanes;   // which token of a step
  const int sl = lane % kLanes;    // which slice of head_dim
  // this lane's dims: (c * kLanes + sl) * kVec + e, c < kChunks, e < kVec

  float qr[kHeads][kElems];
  float acc[kHeads][kElems];
  float m[kHeads], l[kHeads];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    const QT* qp = q + (static_cast<int64_t>(b) * nq + h0 + hh) * HD;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int d = (c * kLanes + sl) * kVec + e;
        qr[hh][c * kVec + e] = hh < nh ? to_f32(qp[d]) * scale_log2 : 0.f;
        acc[hh][c * kVec + e] = 0.f;
      }
    }
    m[hh] = -__int_as_float(0x7f800000);
    l[hh] = 0.f;
  }

  const int* bt = block_tables + static_cast<int64_t>(b) * pp;
  for (int i = threadIdx.x; i < t_end - t_begin; i += kThreads) {
    const int tok = t_begin + i;
    row_s[i] = (bt[tok / page] * page + tok % page) * nkv + kvh;
  }
  __syncthreads();
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
  auto load_tile = [&](int it, int st) {
    const int t0 = t_begin + it * kTile;
    for (int i = threadIdx.x; i < kTile * kRow16; i += kThreads) {
      const int t = i / kRow16;
      const int c = i % kRow16;
      const int tok = t0 + t;
      const bool ok = tok < t_end;
      const int64_t row = ok ? row_s[tok - t_begin] : 0;
      const int e = c * (16 / sizeof(KT));
      cp_async16(k_s + (st * kTile + t) * HD + e, k_pages + row * HD + e, ok);
      cp_async16(v_s + (st * kTile + t) * HD + e, v_pages + row * HD + e, ok);
    }
    if (kQuant) {
      for (int t = threadIdx.x; t < kTile; t += kThreads) {
        const int tok = t0 + t;
        const bool ok = tok < t_end;
        const int64_t row = ok ? row_s[tok - t_begin] : 0;
        cp_async4(ks_s + st * kTile + t, k_scales + row, ok);
        cp_async4(vs_s + st * kTile + t, v_scales + row, ok);
      }
    }
  };

  // prologue: the first kStages - 1 tiles in flight; one commit group per
  // tile (empty past the last) so that wait_group counts tiles
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i, i);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 2>();
    // tile it is in shared memory for every thread, and every warp is done
    // with tile it - 1, whose stage the next load overwrites
    __syncthreads();
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();

    const int t0 = t_begin + it * kTile;
    float s[kSteps][kHeads];
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const int t = warp * kWarpTokens + step * kGroups + grp;
      const bool valid = t0 + t < t_end;
      float kf[kElems];
      const KT* kr = k_s + (st * kTile + t) * HD;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        load_vec<KT, kVec>(kr + (c * kLanes + sl) * kVec, kf + c * kVec);
      if (kQuant) {
        const float ksc = ks_s[st * kTile + t];
#pragma unroll
        for (int e = 0; e < kElems; ++e) kf[e] *= ksc;
      }
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        if (hh >= nh) break;                 // uniform over the CTA
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kElems; ++e) dot += qr[hh][e] * kf[e];
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[step][hh] = valid ? dot : -__int_as_float(0x7f800000);
      }
    }
    // the warp's running max per head, over its tokens of this tile
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh >= nh) break;
      float mx = s[0][hh];
#pragma unroll
      for (int step = 1; step < kSteps; ++step) mx = fmaxf(mx, s[step][hh]);
#pragma unroll
      for (int o = kLanes; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[hh], mx);
      // no valid token seen yet: nothing to rescale (acc and l are 0)
      const float alpha = m_new == -__int_as_float(0x7f800000) ? 1.f : fast_exp2(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= alpha;
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[hh][e] *= alpha;
    }
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const int t = warp * kWarpTokens + step * kGroups + grp;
      const bool valid = t0 + t < t_end;
      float vf[kElems];
      const KT* vr = v_s + (st * kTile + t) * HD;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        load_vec<KT, kVec>(vr + (c * kLanes + sl) * kVec, vf + c * kVec);
      if (kQuant) {
        const float vsc = vs_s[st * kTile + t];
#pragma unroll
        for (int e = 0; e < kElems; ++e) vf[e] *= vsc;
      }
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        if (hh >= nh) break;
        const float p = valid ? fast_exp2(s[step][hh] - m[hh]) : 0.f;
        l[hh] += p;
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[hh][e] += p * vf[e];
      }
    }
  }

  // merge the warp's token groups (same m), then the warps through shared memory
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    if (hh >= nh) break;
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], o);
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[hh][e] += __shfl_xor_sync(0xffffffffu, acc[hh][e], o);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: reuse them for the merge
  float* w_acc = reinterpret_cast<float*>(smem);    // [kWarps][kHeads][HD]
  float* w_m = w_acc + kWarps * kHeads * HD;        // [kWarps][kHeads]
  float* w_l = w_m + kWarps * kHeads;
  if (grp == 0) {
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          w_acc[(warp * kHeads + hh) * HD + (c * kLanes + sl) * kVec + e] = acc[hh][c * kVec + e];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      w_m[warp * kHeads + hh] = m[hh];
      w_l[warp * kHeads + hh] = l[hh];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * HD; i += kThreads) {
    const int hh = i / HD;
    const int d = i % HD;
    float mm = -__int_as_float(0x7f800000);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, w_m[w * kHeads + hh]);
    float ll = 0.f;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = w_m[w * kHeads + hh];
      const float f = mw == -__int_as_float(0x7f800000) ? 0.f : fast_exp2(mw - mm);
      ll += f * w_l[w * kHeads + hh];
      a += f * w_acc[(w * kHeads + hh) * HD + d];
    }
    const int64_t bh = static_cast<int64_t>(b) * nq + h0 + hh;
    if (direct) {
      store_f32(out + bh * HD + d, a / ll);
    } else {
      part_acc[(bh * gridDim.z + split) * HD + d] = a;
      if (d == 0) {
        part_ml[(bh * gridDim.z + split) * 2] = mm;
        part_ml[(bh * gridDim.z + split) * 2 + 1] = ll;
      }
    }
  }
}

// Merges the partials of each (sequence, query head): one CTA of HD
// threads per pair, splits in order.  Only the splits that held a visible
// token are read (the same range the split kernel computes).
template <typename QT, int HD>
__global__ void __launch_bounds__(HD) paged_attention_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ seq_lens, QT* __restrict__ out, int nq, int page, int pp,
    int window, int partition, int splits) {
  const int64_t bh = blockIdx.x;
  const int b = static_cast<int>(bh / nq);
  const int d = threadIdx.x;
  int first, last;
  visible_range(seq_lens, b, pp, page, window, &first, &last);
  const int s_lo = first / partition;
  const int s_hi = last > 0 ? min(splits, (last + partition - 1) / partition) : 0;
  float mm = -__int_as_float(0x7f800000);
  for (int s = s_lo; s < s_hi; ++s) mm = fmaxf(mm, part_ml[(bh * splits + s) * 2]);
  float ll = 0.f;
  float a = 0.f;
  for (int s = s_lo; s < s_hi; ++s) {
    const float f = fast_exp2(part_ml[(bh * splits + s) * 2] - mm);
    ll += f * part_ml[(bh * splits + s) * 2 + 1];
    a += f * part_acc[(bh * splits + s) * HD + d];
  }
  store_f32(out + bh * HD + d, ll > 0.f ? a / ll : 0.f);
}

template <typename QT, typename KT, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages, const float* k_scales,
           const float* v_scales, const int* block_tables, const int* seq_lens, void* out,
           float* scratch, int batch, int nq, int nkv, int page, int pp, int window,
           int partition, int splits, float scale, cudaStream_t stream) {
  const int g = nq / nkv;
  const int n_hblocks = (g + kHeads - 1) / kHeads;
  const size_t smem = split_smem_bytes<KT, HD>() + sizeof(int) * partition;
  if (smem > kMaxSmem) return kBadShape;
  auto kernel = paged_attention_split_kernel<QT, KT, HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  float* part_acc = scratch;
  float* part_ml = splits > 1 ? scratch + static_cast<int64_t>(batch) * nq * splits * HD
                              : nullptr;
  dim3 grid(nkv * n_hblocks, batch, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), k_scales, v_scales, block_tables, seq_lens,
      static_cast<QT*>(out), part_acc, part_ml, nq, nkv, page, pp, window, partition,
      scale * 1.4426950408889634f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  paged_attention_combine_kernel<QT, HD><<<batch * nq, HD, 0, stream>>>(
      part_acc, part_ml, seq_lens, static_cast<QT*>(out), nq, page, pp, window, partition,
      splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_hd(int hd, const void* q, const void* k_pages, const void* v_pages,
              const float* k_scales, const float* v_scales, const int* block_tables,
              const int* seq_lens, void* out, float* scratch, int batch, int nq, int nkv,
              int page, int pp, int window, int partition, int splits, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<QT, KT, 32>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                seq_lens, out, scratch, batch, nq, nkv, page, pp, window,
                                partition, splits, scale, stream);
    case 64:
      return launch<QT, KT, 64>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                seq_lens, out, scratch, batch, nq, nkv, page, pp, window,
                                partition, splits, scale, stream);
    case 128:
      return launch<QT, KT, 128>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                 seq_lens, out, scratch, batch, nq, nkv, page, pp, window,
                                 partition, splits, scale, stream);
    default:
      return kBadHeadDim;
  }
}

}  // namespace
}  // namespace repro

// q: (B, nq, hd) in q_dtype; k/v_pages: (P, page, nkv, hd) in kv_dtype,
// contiguous and 16-byte aligned; k/v_scales: (P, page, nkv) f32 for int8
// pools, else null; block_tables: (B, pp) int32; seq_lens: (B,) int32;
// out like q; scratch: B * nq * splits * (hd + 2) f32 when splits > 1
// (else unused).  partition: tokens per split, a positive multiple of 32;
// splits must equal ceil(pp * page / partition).
// Returns 0, a cudaError_t, or a negative repro::ArgError.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const float* k_scales,
                                      const float* v_scales, const int* block_tables,
                                      const int* seq_lens, void* out, float* scratch,
                                      int batch, int nq, int nkv, int hd, int page, int pp,
                                      int q_dtype, int kv_dtype, int window, int partition,
                                      int splits, float scale, void* stream) {
  using namespace repro;
  if (nkv <= 0 || nq % nkv != 0 || nq / nkv > kMaxGroup) return kBadGroup;
  if (page <= 0 || pp <= 0 || batch <= 0) return kBadShape;
  if (partition <= 0 || partition % kTile != 0 ||
      splits != (pp * page + partition - 1) / partition || (splits > 1 && scratch == nullptr))
    return kBadShape;
  if ((kv_dtype == kI8) != (k_scales != nullptr && v_scales != nullptr)) return kBadDType;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_hd<float, float>(hd, q, k_pages, v_pages, nullptr, nullptr, block_tables,
                                   seq_lens, out, scratch, batch, nq, nkv, page, pp, window,
                                   partition, splits, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k_pages, v_pages, nullptr, nullptr,
                                                   block_tables, seq_lens, out, scratch, batch,
                                                   nq, nkv, page, pp, window, partition, splits,
                                                   scale, s);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_hd<float, int8_t>(hd, q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                    seq_lens, out, scratch, batch, nq, nkv, page, pp, window,
                                    partition, splits, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_hd<__nv_bfloat16, int8_t>(hd, q, k_pages, v_pages, k_scales, v_scales,
                                            block_tables, seq_lens, out, scratch, batch, nq,
                                            nkv, page, pp, window, partition, splits, scale, s);
  return kBadDType;
}
