// f32 activations times bf16 weights, the weights read in place: the
// product an f32 prefill chunk computes against a bf16 model's weights.
//
// Replaces no Pallas kernel: in the JAX package XLA computes this product
// (jnp promotes the bf16 weight to f32).  The port used to do what that
// promotion says literally, widening each weight to an f32 copy and
// running an f32 SGEMM over the copy, which reads the weight's bytes once,
// writes twice as many and reads those again.  This kernel reads each
// weight once, as bf16.
//
// Computes, for x (rows, K) f32 and w (K, N) bf16,
//   y[r, :] = x[a(r), :] @ w                        (plain form)
// or, over groups (the experts of a MoE layer, ``models/moe.py: experts``),
//   y[j, :] = x[a(j), :] @ w[e]   for the pairs j of expert e
// in f32 arithmetic.  In the grouped form expert e's pairs are the sorted
// positions offsets[e] .. offsets[e] + min(counts[e], capacity) - 1 (the
// pairs the capacity keeps), a(j) is the pair's token (``a_rows``); other
// rows of y are not written.  offsets and counts stay on the device: a
// block of an expert with no pair returns before it reads any weight.
// Up to two weights of one shape (an expert's gate and up projections)
// share the activations in one launch.
//
// Precision.  A bf16 weight is exact in bf16.  Each activation is split
// into three bf16 parts, x = x0 + x1 + x2 (x1 = bf16(x - x0), x2 =
// bf16(x - x0 - x1)), which hold its 24-bit significand; each product of
// a part with a weight is exact in f32, and the tensor cores sum them in
// f32 accumulators, the small parts first.  The tensor cores' additions
// truncate, so they sum one stage of 32 K-rows at a time from zero, and
// the running sums take each stage's in f32 on the CUDA cores (rounded
// to nearest): over K = 14336, a truncation at each of 900 mma steps
// could bias a sum by up to about 1e-4 of its size.  So the product is an f32 product,
// summed in another order than cuBLAS's SGEMM (the plain version,
// ``kernels/ref.py: mixed_matmul``).
//
// Bound.  At a prefill chunk's 64 rows and fewer every product of the
// port's models is below the card's ridge: 2 x 3 x rows operations (the
// three parts) per 2-byte weight is at most 192 operations a byte against
// about 295 for bf16.  The weight bytes at 3.35 TB/s bound it (Jamba2-Mini:
// 58 GB a chunk, 17.3 ms); the activations (64 rows x K x 4 bytes) are
// read from L2 by every column tile.
//
// Design:
// - A block of 8 warps owns 256 weight columns and up to 64 rows (four
//   m16 tiles; a tile past the block's valid rows is skipped whole, so
//   few rows cost few tensor-core cycles) and streams its weight columns
//   over its share of K through a ring of 5 stages of 32 K-rows, fed by
//   cp.async (16-byte copies, 3 stages in flight).  Each stage also holds
//   the f32 activation tile (64 x 32) of its K-rows, gathered by row.
// - Each stage's activations are split into the three bf16 parts once,
//   by the whole block, into a double-buffered tile that the warps read
//   with ldmatrix; the weight tile is read with ldmatrix.trans.  Both
//   tiles are XOR-swizzled by 16-byte chunk, so neither the copies nor
//   the ldmatrix reads meet bank conflicts.  mma.sync m16n8k16 bf16 with
//   f32 accumulators; warp w computes columns 32 w .. 32 w + 31.
// - One barrier a stage: the split of stage i + 1 runs beside the mma of
//   stage i.
// - Split-K where the column tiles alone leave the card idle (narrow N,
//   such as Jamba's x_proj of 288 columns): the wrapper's plan, from the
//   shapes alone.  Each split writes its partial sums to a scratch
//   tensor, and mixed_gemm_reduce_kernel adds them in split order, so the
//   result does not depend on the order in which blocks run.
// K must be a multiple of 4 and N of 8, the weight's row stride of 8 and
// x's of 4, each base 16-byte aligned (the wrapper checks, and the entry
// point returns kBadShape otherwise).

#include "common.cuh"

namespace repro {
namespace {

constexpr int kRowsPerBlock = 64;  // four m16 tiles
constexpr int kCols = 256;         // weight columns a block streams
constexpr int kDepth = 32;         // K-rows a stage
constexpr int kStages = 5;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpCols = kCols / kWarps;  // 32: four n8 tiles
constexpr int kMTiles = kRowsPerBlock / 16;
constexpr int kNTiles = kWarpCols / 8;
constexpr int kParts = 3;

constexpr int kWStageBytes = kDepth * kCols * 2;            // 16 KB
constexpr int kXStageBytes = kRowsPerBlock * kDepth * 4;    // 8 KB
constexpr int kPartBytes = kRowsPerBlock * kDepth * 2;      // 4 KB: one part's tile
constexpr int kSplitBytes = kParts * kPartBytes;            // 12 KB
constexpr size_t kSmemBytes = static_cast<size_t>(kStages) * (kWStageBytes + kXStageBytes) +
                              2 * kSplitBytes + kRowsPerBlock * sizeof(int);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void copy16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed copy groups of this thread are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// not volatile: the compiler may move it among the ldmatrix reads
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of K-row k's 16-byte chunk c (of 32) in a weight stage
__device__ __forceinline__ int w_offset(int k, int c) {
  return k * (kCols * 2) + ((c ^ (k & 7)) << 4);
}

// byte offset of row r's 16-byte chunk c (of 4) in one part's tile
__device__ __forceinline__ int part_offset(int r, int c) {
  return r * (kDepth * 2) + ((c ^ ((r >> 1) & 3)) << 4);
}

struct Problem {
  const float* x;
  int64_t ldx;
  const int* a_rows;       // x's row of each output row, or null: the same row
  const __nv_bfloat16* w[2];
  int64_t w_group;         // elements between two groups' weights
  int64_t ldw;
  float* y[2];
  int64_t ldy;
  float* part;             // (weights, splits, rows, N) partial sums, or null
  const int64_t* offsets;  // grouped: each group's first row; null in the plain form
  const int64_t* counts;   // grouped: each group's rows (those past capacity are dropped)
  int capacity;
  int rows, k, n, mblocks, splits, steps_per_split;
};

__global__ void __launch_bounds__(kThreads, 1) mixed_gemm_kernel(const Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* w_ring = smem;
  unsigned char* x_ring = w_ring + kStages * kWStageBytes;
  unsigned char* split = x_ring + kStages * kXStageBytes;
  int* a_row = reinterpret_cast<int*>(split + 2 * kSplitBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int group = blockIdx.y / p.mblocks;
  const int mb = blockIdx.y % p.mblocks;
  const int wi = blockIdx.z / p.splits;
  const int s = blockIdx.z % p.splits;
  const int n0 = blockIdx.x * kCols;

  // this block's rows: first output row and how many are valid
  int64_t base;
  int valid;
  if (p.counts != nullptr) {
    const int64_t count = p.counts[group];
    const int64_t left = (count < p.capacity ? count : p.capacity) -
                         static_cast<int64_t>(mb) * kRowsPerBlock;
    base = p.offsets[group] + static_cast<int64_t>(mb) * kRowsPerBlock;
    valid = static_cast<int>(left < kRowsPerBlock ? left : kRowsPerBlock);
  } else {
    base = static_cast<int64_t>(mb) * kRowsPerBlock;
    valid = min(p.rows - mb * kRowsPerBlock, kRowsPerBlock);
  }
  if (valid <= 0) return;  // an expert without pairs reads none of its weights
  const int mt_live = (valid + 15) >> 4;
  const int rows_live = mt_live * 16;
  if (tid < kRowsPerBlock)
    a_row[tid] = tid < valid ? (p.a_rows != nullptr ? p.a_rows[base + tid]
                                                    : static_cast<int>(base + tid))
                             : 0;
  __syncthreads();

  const int total_steps = (p.k + kDepth - 1) / kDepth;
  const int step0 = s * p.steps_per_split;
  const int n_steps = max(0, min(p.steps_per_split, total_steps - step0));
  const int k_hi = min(p.k, (step0 + n_steps) * kDepth);
  const __nv_bfloat16* w = p.w[wi] + group * p.w_group;

  auto load_stage = [&](int i) {
    const int slot = i % kStages;
    const int k0 = (step0 + i) * kDepth;
    unsigned char* ws = w_ring + slot * kWStageBytes;
#pragma unroll
    for (int j = 0; j < kDepth * kCols / 8 / kThreads; ++j) {  // 4 chunks a thread
      const int idx = tid + j * kThreads;
      const int kr = idx / (kCols / 8);
      const int c = idx % (kCols / 8);
      const int kk = k0 + kr;
      const int nn = n0 + c * 8;
      const bool in = kk < k_hi && nn < p.n;
      copy16(ws + w_offset(kr, c), in ? w + kk * p.ldw + nn : w, in ? 16 : 0);
    }
    unsigned char* xs = x_ring + slot * kXStageBytes;
#pragma unroll
    for (int j = 0; j < kRowsPerBlock * kDepth / 4 / kThreads; ++j) {  // 2 chunks a thread
      const int idx = tid + j * kThreads;
      const int r = idx / (kDepth / 4);
      const int c = idx % (kDepth / 4);
      if (r < rows_live) {
        const int kk = k0 + c * 4;
        const bool in = r < valid && kk < k_hi;
        copy16(xs + r * (kDepth * 4) + c * 16, in ? p.x + a_row[r] * p.ldx + kk : p.x,
               in ? 16 : 0);
      }
    }
  };

  // the three bf16 parts of a stage's activations, into split buffer `buf`
  auto split_stage = [&](int i, int buf) {
    const float* xs = reinterpret_cast<const float*>(x_ring + (i % kStages) * kXStageBytes);
    unsigned char* dst = split + buf * kSplitBytes;
#pragma unroll
    for (int j = 0; j < kRowsPerBlock * kDepth / 4 / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx / (kDepth / 4);
      const int c4 = idx % (kDepth / 4);
      if (r < rows_live) {
        const float4 v = *reinterpret_cast<const float4*>(xs + r * kDepth + c4 * 4);
        float rest[4] = {v.x, v.y, v.z, v.w};
        const int off = part_offset(r, c4 >> 1) + (c4 & 1) * 8;
#pragma unroll
        for (int q = 0; q < kParts; ++q) {
          __nv_bfloat16 h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            h[e] = __float2bfloat16_rn(rest[e]);
            rest[e] -= __bfloat162float(h[e]);
          }
          // part 0 holds the smallest piece, so the mma loop adds the small parts first
          *reinterpret_cast<uint2*>(dst + (kParts - 1 - q) * kPartBytes + off) =
              *reinterpret_cast<const uint2*>(h);
        }
      }
    }
  };

  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const bool warp_live = n0 + warp * kWarpCols < p.n;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_steps) load_stage(i);
    copy_commit();
  }
  copy_wait<kStages - 2>();  // stage 0 has landed
  __syncthreads();
  if (n_steps > 0) split_stage(0, 0);

  for (int it = 0; it < n_steps; ++it) {
    copy_wait<kStages - 3>();  // stage it + 1 has landed
    __syncthreads();  // the split of stage it is visible; stage it - 1 is free
    if (it + kStages - 1 < n_steps) load_stage(it + kStages - 1);
    copy_commit();
    if (it + 1 < n_steps) split_stage(it + 1, (it + 1) & 1);

    if (warp_live) {
      const unsigned char* ws = w_ring + (it % kStages) * kWStageBytes;
      const unsigned char* xs = split + (it & 1) * kSplitBytes;
      float st[kMTiles][kNTiles][4];  // this stage's sums
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mt][nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kDepth / 16; ++ks) {
        // B fragments of the warp's four n8 tiles: matrix lane / 8 is K-rows
        // 8 ((lane / 8) % 2) .. + 7 of columns 8 (lane / 16) .. + 7
        uint32_t b[kNTiles][2];
        const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int nt = 0; nt < kNTiles; nt += 2) {
          uint32_t r[4];
          ldsm_x4_trans(r, ws + w_offset(kr, warp * (kWarpCols / 8) + nt + (lane >> 4)));
          b[nt][0] = r[0];
          b[nt][1] = r[1];
          b[nt + 1][0] = r[2];
          b[nt + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          if (mt < mt_live) {
            const int r = mt * 16 + (lane & 15);
            const int off = part_offset(r, ks * 2 + (lane >> 4));
            uint32_t a[kParts][4];  // the three parts' fragments, read before their mma
#pragma unroll
            for (int q = 0; q < kParts; ++q) ldsm_x4(a[q], xs + q * kPartBytes + off);
#pragma unroll
            for (int q = 0; q < kParts; ++q)
#pragma unroll
              for (int nt = 0; nt < kNTiles; ++nt)
                mma16816(st[mt][nt], a[q], b[nt][0], b[nt][1]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
        if (mt < mt_live)
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += st[mt][nt][e];
    }
  }

  if (!warp_live) return;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  float* out;
  int64_t ld;
  if (p.splits > 1) {
    out = p.part + (static_cast<int64_t>(wi) * p.splits + s) * p.rows * p.n;
    ld = p.n;
  } else {
    out = p.y[wi];
    ld = p.ldy;
  }
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
    if (mt >= mt_live) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + half * 8;
      if (r >= valid) continue;
      float* row = out + (base + r) * ld;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int col = n0 + warp * kWarpCols + nt * 8 + 2 * t4;
        if (col < p.n)
          *reinterpret_cast<float2*>(row + col) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

// y[w][r, :] = sum over s, in order, of part[w][s][r, :]; four columns a thread
__global__ void mixed_gemm_reduce_kernel(const float* __restrict__ part, float* y0, float* y1,
                                         int64_t ldy, int rows, int n, int splits) {
  const int64_t quads = static_cast<int64_t>(rows) * (n / 4);
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  const int wi = blockIdx.y;
  const int64_t r = q / (n / 4);
  const int c = static_cast<int>(q % (n / 4)) * 4;
  const int64_t plane = static_cast<int64_t>(rows) * n;
  const float* src = part + static_cast<int64_t>(wi) * splits * plane + r * n + c;
  float4 sum = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(src + s * plane);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  float* dst = (wi == 0 ? y0 : y1) + r * ldy + c;
  // y's row stride is even but need not be a multiple of 4
  *reinterpret_cast<float2*>(dst) = make_float2(sum.x, sum.y);
  *reinterpret_cast<float2*>(dst + 2) = make_float2(sum.z, sum.w);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace repro

// x: (.., K) f32 rows of stride ldx; w0 (and w1, or null): `groups` weights
// (K, N) bf16 of row stride ldw, w_group elements apart; y0 (and y1): rows
// of stride ldy.  Plain form (offsets and counts null): `rows` rows.
// Grouped form: `rows` is the height of y; group e's rows are offsets[e] ..
// offsets[e] + min(counts[e], capacity) - 1, at most mblocks x 64 of them.
// a_rows (int32, or null) gives x's row of each row of y.  With splits > 1
// `part` holds (weights, splits, rows, N) f32.
extern "C" int mixed_gemm_launch(const void* x, int64_t ldx, const void* a_rows,
                                 const void* w0, const void* w1, int64_t w_group, int64_t ldw,
                                 void* y0, void* y1, int64_t ldy, void* part,
                                 const void* offsets, const void* counts, int capacity,
                                 int rows, int k, int n, int groups, int mblocks, int splits,
                                 void* stream) {
  using namespace repro;
  if (rows <= 0 || k <= 0 || n <= 0 || groups <= 0 || mblocks <= 0 || splits <= 0)
    return kBadShape;
  if (k % 4 != 0 || n % 8 != 0 || ldw % 8 != 0 || ldx % 4 != 0 || ldy % 2 != 0 ||
      w_group % 8 != 0 || !aligned16(x) || !aligned16(w0) || (w1 != nullptr && !aligned16(w1)))
    return kBadShape;
  if ((offsets == nullptr) != (counts == nullptr) || (splits > 1 && part == nullptr) ||
      groups * mblocks > 65535 || splits > 32767)
    return kBadShape;
  static const cudaError_t attr = cudaFuncSetAttribute(
      mixed_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nw = w1 != nullptr ? 2 : 1;
  const int total_steps = (k + kDepth - 1) / kDepth;
  Problem p;
  p.x = static_cast<const float*>(x);
  p.ldx = ldx;
  p.a_rows = static_cast<const int*>(a_rows);
  p.w[0] = static_cast<const __nv_bfloat16*>(w0);
  p.w[1] = static_cast<const __nv_bfloat16*>(w1 != nullptr ? w1 : w0);
  p.w_group = w_group;
  p.ldw = ldw;
  p.y[0] = static_cast<float*>(y0);
  p.y[1] = static_cast<float*>(y1 != nullptr ? y1 : y0);
  p.ldy = ldy;
  p.part = static_cast<float*>(part);
  p.offsets = static_cast<const int64_t*>(offsets);
  p.counts = static_cast<const int64_t*>(counts);
  p.capacity = capacity;
  p.rows = rows;
  p.k = k;
  p.n = n;
  p.mblocks = mblocks;
  p.splits = splits;
  p.steps_per_split = (total_steps + splits - 1) / splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kCols - 1) / kCols, groups * mblocks, nw * splits);
  mixed_gemm_kernel<<<grid, kThreads, kSmemBytes, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int64_t quads = static_cast<int64_t>(rows) * (n / 4);
  const dim3 rgrid(static_cast<unsigned>((quads + 255) / 256), nw);
  mixed_gemm_reduce_kernel<<<rgrid, 256, 0, st>>>(p.part, p.y[0], p.y[1], ldy, rows, n, splits);
  return static_cast<int>(cudaGetLastError());
}
