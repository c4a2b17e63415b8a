// The 3xTF32 design of the fused conditioned-field kernel: f32 at every width the wrapper takes
// (multiples of 64 up to 1024). field_kernel.cu holds the contract, the dispatch and the C entry
// points; this file is included by it alone.
//
// Replaces, for float32, the TPU kernel mofanerf_tpu/ops/pallas_field.py:210 fused_field_apply
// (pallas_call at :238): embedded points in, raw rgb and sigma out, every product in f32.
//
// What bounds it. The fused designs keep a row block's activations in shared memory through all
// layers and stream the whole weight stack once a block. In f32 that caps a block at 16 rows at
// W = 1024 (a 64-row [64, 1024] f32 activation alone is 256 KB, over the 227 KB a CTA can have),
// so the earlier FFMA design drew 105 MB of weights for every 16 rows and ran at a quarter of the
// FFMA bound, slower than plain PyTorch. This design goes the other way:
//   - One launch a layer, over a chunk of rows (up to 256 MB an activation, ops/field_kernel.py::
//     tf32_scratch). Activations go through device memory; a layer's weights (4 MB at W = 1024, 8
//     with their low parts) come from device memory about once a chunk and from L2 to every CTA.
//     The activation traffic is W / 4 FLOP a byte (256 at W = 1024, 64 at 256), over the ~49 at
//     which three TF32 products a product stop being bound by device memory: operations bound it.
//   - The products run on the tensor cores, as wgmma in TF32, three TF32 products for each f32
//     one: with x = hi + lo (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)), a @ b is taken as
//     lo_a @ hi_b + hi_a @ lo_b first, then hi_a @ hi_b, all summed in f32: a relative error near
//     2^-21 a product, where one TF32 product keeps about three digits. Bound: 3 x the f32 FLOP
//     at the 495 TFLOP/s dense TF32 peak.
//   - The tensor cores' f32 sums do not round to nearest: summed over all of k = 1024 in one set
//     of accumulators, the fine field's outputs moved by up to 1.4e-4 of their scale against the
//     plain version (one H100, this design's first build), over the contract's 1e-4, and the
//     error grew with k. So a k block's products go into a partial set that restarts every
//     kPromote k blocks, and the partial is added to the master set with round-to-nearest FADDs:
//     the tensor cores' error is then one of a 32-deep sum, not of the whole row. The two sets
//     need the registers of a second accumulator, which halves the rows of a CTA tile to 128.
//     Promoting every k block was both the most exact and the fastest of 1, 2, 4 and never
//     (utils/field_variants.py --tf32, PERF.md).
//     The f32 contract's checks hold unchanged (chip_smoke.py FIELD_TOL, the `cuda` tests).
//   - TF32 wgmma takes both operands K-major (the transpose bits exist for 16-bit types only).
//     The weights are split and tiled once a pack_fused_params (ops/field_kernel.py::
//     tile_weights_tf32): a tile is [2][BN output columns][32 k], the high part then the low,
//     transposed, in the 128-byte swizzle (a 128-byte row holds 32 f32 of k; one wgmma is 8 deep,
//     32 bytes of the row). The activations are split after they are loaded: A comes from
//     registers, read from the stage and split there, so the activations move as f32 once (not
//     twice, as a high and a low copy written by the producing epilogue would), and a stage holds
//     one copy of them, which leaves room for four stages.
//   - Activations live in device memory as [row tiles][k blocks][128 rows][32] f32 in the same
//     swizzle, so that a stage's A block is one contiguous 16 KB bulk copy, as its weight tile is.
//
// A CTA computes a [128 rows, BN columns] tile of one layer (BN = 128, or 64 where 128 does not
// divide the width). Warps 0-7 are two consumer warpgroups; warpgroup g owns rows [64 g, 64 g +
// 64), one m64 tile (64 partial and 64 master f32 accumulators a thread at BN = 128). Warp 8 is
// the producer: one thread fills a ring of stages (A block + weight tile, 48 KB at BN = 128: four
// stages) with cp.async.bulk on mbarriers. A k block of 32 runs four k8 steps; a step loads the
// thread's A fragment from the stage (ld.shared, conflict-free in the swizzle), splits it and
// issues three wgmma. Two register sets of A fragments alternate, so a step's loads overlap the
// previous step's products (wait_group 1). The epilogue adds the bias (and, in the view layer, the
// ray's view features), applies ReLU and stores float2s into the next layer's tiled activation.
// The skip pair is one product over k = 2W whose A blocks come from the saved activation, then
// from the running one: both halves summed unrounded, one bias, as the contract asks.
// Each chunk launches: the points into tiled, zero-padded blocks (pad_points), one layer_kernel
// a product (1 + xyz_depth + 2 * depth + 1 of them), and the two heads (heads: a warp a row, f32
// FFMA, as the contract's f32 output head). Rows past n_rows are computed on zeros and not
// written; a row's ray is row / samples.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_ptx.cuh"

namespace tf32_field {

using namespace hopper;

constexpr int kRows = 128;                      // point rows of a CTA tile and of a row tile
constexpr int kK = 32;                          // k of a stage: one 128-byte row of f32
constexpr int kBlockFloats = kRows * kK;        // an activation block [128 rows, 32 k]
constexpr int kABytes = kBlockFloats * 4;       // 16 KB
constexpr int kConsumerWarps = 8;               // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 32;  // and the producer warp
constexpr int kPromote = 1;                     // k blocks a partial sum runs before it is added

template <int BN>
struct Geo {
  static_assert(BN == 64 || BN == 128, "the 3xTF32 design takes 64 or 128 columns a CTA tile");
  static constexpr int kBTileFloats = 2 * BN * kK;  // the high and the low part, [BN, 32] each
  static constexpr int kBBytes = kBTileFloats * 4;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = BN == 128 ? 4 : 6;
  static constexpr int kAcc = BN / 2;               // accumulators of an m64 tile a thread
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a CTA can ask for");
};

// One product of the layer plan over one chunk of rows.
struct Layer {
  const float* a0;   // [row tiles][a0_kb][128][32]: the first a0_kb k blocks of A
  const float* a1;   // [row tiles][a1_kb][128][32]: the rest (the skip pair's running one)
  const float* b;    // [column tiles][a0_kb + a1_kb][2][BN][32]: the product's weight tiles
  const float* bias; // [n_cols]
  float* out;        // [row tiles][out_kb][128][32]
  const float* dirf; // the view layer: [rays][dirf_ld] view features added before the ReLU
  long long row0;    // the chunk's first row
  int a0_kb, a1_kb, out_kb;
  int n_cols;        // columns written: W, or the view layer's W / 2
  int n_col_tiles;
  int dirf_ld, n_rows, samples;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Keeps the A fragments of a step in their registers until the products that read them are
// known complete: the compiler does not see wgmma read them after it was issued.
__device__ __forceinline__ void keep(uint32_t (&r)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Offset of element (r, c) in a row tile of a tiled activation: block c / 32, row r, the 16-byte
// chunk of (c % 32) / 4 at chunk ^ (r % 8).
__device__ __forceinline__ int tiled_at(int r, int c) {
  return (c >> 5) * kBlockFloats + r * kK + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// d (+)= a[64, 8] @ b[128, 8]^T in TF32 with f32 accumulators: A from registers (the fragment of
// mma.m16n8k8, warp w of the warpgroup holding rows 16 w ..), B a K-major tile in the 128-byte
// swizzle. Thread t holds d[4 j .. 4 j + 3] at rows 16 (t / 32) + (t % 32) / 4 (and + 8), columns
// 8 j + 2 (t % 4) (and + 1), as for every wgmma shape. scale_d = 0 starts a new sum.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (+)= a[64, 8] @ b[64, 8]^T in TF32 with f32 accumulators: A from registers (the fragment of
// mma.m16n8k8, warp w of the warpgroup holding rows 16 w ..), B a K-major tile in the 128-byte
// swizzle. Thread t holds d[4 j .. 4 j + 3] at rows 16 (t / 32) + (t % 32) / 4 (and + 8), columns
// 8 j + 2 (t % 4) (and + 1), as for every wgmma shape. scale_d = 0 starts a new sum.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  if constexpr (BN == 128) {
    wgmma_tf32_n128(d, a, desc_b, scale_d);
  } else {
    wgmma_tf32_n64(d, a, desc_b, scale_d);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1) layer_kernel(const Layer p) {
  using G = Geo<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full_bar = ring + G::kStages * G::kStageBytes;
  const uint32_t empty_bar = full_bar + G::kStages * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile_m = blockIdx.x / p.n_col_tiles;
  const int tile_n = blockIdx.x - tile_m * p.n_col_tiles;
  const int n_kb = p.a0_kb + p.a1_kb;
  if (tid == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumerWarps);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one thread fills the ring with the tile's A blocks and weight tiles
    if (lane == 0) {
      const float* b = p.b + size_t(tile_n) * n_kb * G::kBTileFloats;
      for (int kb = 0; kb < n_kb; ++kb) {
        const uint32_t s = kb % G::kStages, phase = (kb / G::kStages) & 1u;
        mbar_wait(empty_bar + 8 * s, phase ^ 1u);  // passes at once the first time round
        mbar_expect_tx(full_bar + 8 * s, G::kStageBytes);
        const float* a = kb < p.a0_kb
                             ? p.a0 + (size_t(tile_m) * p.a0_kb + kb) * kBlockFloats
                             : p.a1 + (size_t(tile_m) * p.a1_kb + (kb - p.a0_kb)) * kBlockFloats;
        const uint32_t st = ring + s * G::kStageBytes;
        bulk_copy(st, a, kABytes, full_bar + 8 * s);
        bulk_copy(st + kABytes, b + size_t(kb) * G::kBTileFloats, G::kBBytes, full_bar + 8 * s);
      }
    }
    return;
  }

  // ---- consumers
  const int wg = warp >> 2, gid = lane >> 2, t4 = lane & 3;
  // this thread's A fragment in a stage: rows 64 wg + 16 (warp % 4) + gid (and + 8), columns
  // 8 k + t4 (and + 4); every such row is gid modulo 8, which sets the swizzle
  const uint32_t a_thr = uint32_t(64 * wg + 16 * (warp & 3) + gid) * 128u + uint32_t(t4) * 4u;
  float part[G::kAcc], acc[G::kAcc];   // the partial sum on the tensor cores, the master sum
#pragma unroll
  for (int i = 0; i < G::kAcc; ++i) part[i] = acc[i] = 0.f;
  uint32_t x[2][4] = {}, y[2][4] = {};  // two sets of A fragments: [0] high, [1] low parts

  // The fragment of k step k (8 deep) of the stage at sa: a0 (row gid, column t4), a1 (gid + 8,
  // t4), a2 (gid, t4 + 4), a3 (gid + 8, t4 + 4), split.
  auto load = [&](uint32_t(&f)[2][4], uint32_t sa, int k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t at = sa + a_thr + uint32_t((i & 1) * 8 * 128) +
                          (uint32_t((2 * k + (i >> 1)) ^ gid) << 4);
      const float v = ld_shared_f32(at);
      f[0][i] = tf32_rna(v);
      f[1][i] = tf32_rna(v - __uint_as_float(f[0][i]));
    }
  };

  // part (+)= lo_a hi_b + hi_a lo_b, then hi_a hi_b, for k step k of the weight tile at sb;
  // `restart` begins a new partial sum
  auto mma = [&](uint32_t(&f)[2][4], uint32_t sb, int k, bool restart) {
    const uint64_t b_hi = make_desc(sb + 32 * k), b_lo = make_desc(sb + BN * 128 + 32 * k);
    wgmma_fence();
    wgmma_tf32<BN>(part, f[1], b_hi, restart ? 0 : 1);
    wgmma_tf32<BN>(part, f[0], b_lo, 1);
    wgmma_tf32<BN>(part, f[0], b_hi, 1);
    wgmma_commit();
  };

  int prev = -1;  // a stage whose last products may still be in flight
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % G::kStages;
    mbar_wait(full_bar + 8 * s, uint32_t(kb / G::kStages) & 1u);
    const uint32_t sa = ring + s * G::kStageBytes, sb = sa + kABytes;
    const bool promote = kb % kPromote == kPromote - 1 || kb == n_kb - 1;
    load(x, sa, 0);
    mma(x, sb, 0, kb % kPromote == 0);
    wgmma_wait<1>();  // the step before (set y) is complete
    keep(y);
    if (prev >= 0 && lane == 0) mbar_arrive(empty_bar + 8 * prev);  // its stage is read
    prev = -1;
    load(y, sa, 1);
    mma(y, sb, 1, false);
    wgmma_wait<1>();
    keep(x);
    load(x, sa, 2);
    mma(x, sb, 2, false);
    wgmma_wait<1>();
    keep(y);
    load(y, sa, 3);
    mma(y, sb, 3, false);
    if (promote) {
      // the partial sum is complete: add it to the master sum, rounding to nearest
      wgmma_wait<0>();
      keep(x);
      keep(y);
      fence_acc(part);
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);
#pragma unroll
      for (int i = 0; i < G::kAcc; ++i) acc[i] += part[i];
    } else {
      wgmma_wait<1>();
      keep(x);
      prev = s;
    }
  }

  // ---- epilogue: out = relu(acc + bias [+ dirf[ray]]) into the tiled activation
  float* out = p.out + size_t(tile_m) * p.out_kb * kBlockFloats;
  const int n0 = tile_n * BN;
  const int r_lo = 64 * wg + 16 * (warp & 3) + gid, r_hi = r_lo + 8;
  const float* d_lo = nullptr;
  const float* d_hi = nullptr;
  if (p.dirf != nullptr) {
    long long g_lo = p.row0 + static_cast<long long>(tile_m) * kRows + r_lo, g_hi = g_lo + 8;
    if (g_lo >= p.n_rows) g_lo = p.n_rows - 1;  // padding rows read a real ray
    if (g_hi >= p.n_rows) g_hi = p.n_rows - 1;
    d_lo = p.dirf + size_t(g_lo / p.samples) * p.dirf_ld;
    d_hi = p.dirf + size_t(g_hi / p.samples) * p.dirf_ld;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * t4;
    if (c < p.n_cols) {
      const float2 b = *reinterpret_cast<const float2*>(p.bias + c);
      float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
      float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
      if (d_lo != nullptr) {
        const float2 dl = *reinterpret_cast<const float2*>(d_lo + c);
        const float2 dh = *reinterpret_cast<const float2*>(d_hi + c);
        v0 += dl.x, v1 += dl.y, v2 += dh.x, v3 += dh.y;
      }
      *reinterpret_cast<float2*>(out + tiled_at(r_lo, c)) =
          make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      *reinterpret_cast<float2*>(out + tiled_at(r_hi, c)) =
          make_float2(fmaxf(v2, 0.f), fmaxf(v3, 0.f));
    }
  }
}

// The chunk's embedded points [m, pe] (from row row0 of x) as a tiled activation of kp_blocks k
// blocks a row tile, zero past pe and past m.
__global__ void pad_points(const float* __restrict__ x, float* __restrict__ xp, long long row0,
                           int m, int pe, int kp_blocks, long long total) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const long long blk = i / kBlockFloats;
    const int in = static_cast<int>(i - blk * kBlockFloats);
    const long long tile = blk / kp_blocks;
    const int kb = static_cast<int>(blk - tile * kp_blocks);
    const int rr = in >> 5, phys = in & 31;
    const int c = kb * kK + ((((phys >> 2) ^ (rr & 7))) << 2) + (phys & 3);
    const long long r = tile * kRows + rr;
    xp[i] = (r < m && c < pe) ? x[size_t(row0 + r) * pe + c] : 0.f;
  }
}

// raw sigma = sigma_feat @ w_out[:W, 3] + b_out[3], raw rgb = view @ w_out[W:, :3] + b_out[:3]:
// a warp a row, lane l on column l of each k block; [rgb, sigma] written for rows < m.
__global__ void heads(const float* __restrict__ sig, const float* __restrict__ view, int kb_w,
                      int w2, const float* __restrict__ w_out, int width,
                      const float* __restrict__ b_out, float* __restrict__ out, long long row0,
                      int m) {
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= m) return;
  const int rr = static_cast<int>(r & (kRows - 1));
  const size_t at = size_t(r / kRows) * kb_w * kBlockFloats + rr * kK +
                    ((((lane >> 2) ^ (rr & 7))) << 2) + (lane & 3);
  float s = 0.f;
  for (int kb = 0; kb < kb_w; ++kb) {
    s = fmaf(sig[at + size_t(kb) * kBlockFloats], w_out[size_t(kb * kK + lane) * 4 + 3], s);
  }
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int kb = 0; kb < w2 / kK; ++kb) {
    const float v = view[at + size_t(kb) * kBlockFloats];
    const float4 w = *reinterpret_cast<const float4*>(w_out + size_t(width + kb * kK + lane) * 4);
    s0 = fmaf(v, w.x, s0);
    s1 = fmaf(v, w.y, s1);
    s2 = fmaf(v, w.z, s2);
  }
  s = warp_sum(s);
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    reinterpret_cast<float4*>(out)[row0 + r] =
        make_float4(s0 + b_out[0], s1 + b_out[1], s2 + b_out[2], s + b_out[3]);
  }
}

struct Args {
  const float* x;        // [N, pe] embedded points
  const float* dirf;     // [R, W/2] per-ray view features, N = R * samples
  const float* tiles;    // the weight stream of ops/field_kernel.py::tile_weights_tf32
  const float* b_pts;    // [W]
  const float* b_stack;  // [L, W]
  const float* b_view;   // [W/2]
  const float* w_out;    // [W + W/2, 4]: rows :W col 3 alpha, rows W: cols 0..2 rgb
  const float* b_out;    // [4]
  float* out;            // [N, 4]: raw rgb, raw sigma
  float* scratch;        // chunk_rows * (pe padded to 32 + 3 W) f32 (ops/field_kernel.py::tf32_scratch)
  int n_rows, samples, pe, width, depth, skip, xyz_depth;
  int chunk_rows;        // rows a chunk, a multiple of kRows
};

// The one of the three activation buffers that is neither a nor b.
__host__ inline int other(int a, int b) {
  for (int i = 0; i < 3; ++i) {
    if (i != a && i != b) return i;
  }
  return -1;
}

// Every launch of one field_apply call: a chunk at a time, the points, each product of the plan
// (ops/field_kernel.py::tf32_plan, whose order the weight stream follows), the heads.
template <int BN>
int run(const Args& a, cudaStream_t stream) {
  using G = Geo<BN>;
  cudaError_t e = cudaFuncSetAttribute(layer_kernel<BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (e != cudaSuccess) return int(e);
  const int W = a.width, W2 = W / 2, kw = W / kK, kp_blocks = (a.pe + kK - 1) / kK;
  const size_t chunk = size_t(a.chunk_rows);
  float* xp = a.scratch;
  float* buf[3];
  for (int i = 0; i < 3; ++i) buf[i] = a.scratch + chunk * kp_blocks * kK + size_t(i) * chunk * W;

  for (long long row0 = 0; row0 < a.n_rows; row0 += static_cast<long long>(chunk)) {
    const long long left = a.n_rows - row0;
    const int m = static_cast<int>(left < static_cast<long long>(chunk) ? left : chunk);
    const int row_tiles = (m + kRows - 1) / kRows;
    const long long total = static_cast<long long>(row_tiles) * kp_blocks * kBlockFloats;
    const long long blocks = (total + 255) / 256;
    pad_points<<<int(blocks < 65536 ? blocks : 65536), 256, 0, stream>>>(
        a.x, xp, row0, m, a.pe, kp_blocks, total);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);

    const float* w = a.tiles;  // the stream, product by product
    auto product = [&](const float* a0, int a0_kb, const float* a1, int a1_kb, const float* bias,
                       float* out, int n_cols, bool view) -> cudaError_t {
      Layer l;
      l.a0 = a0;
      l.a1 = a1;
      l.b = w;
      l.bias = bias;
      l.out = out;
      l.dirf = view ? a.dirf : nullptr;
      l.row0 = row0;
      l.a0_kb = a0_kb;
      l.a1_kb = a1_kb;
      l.out_kb = kw;
      l.n_cols = n_cols;
      l.n_col_tiles = (n_cols + BN - 1) / BN;
      l.dirf_ld = W2;
      l.n_rows = a.n_rows;
      l.samples = a.samples;
      w += size_t(l.n_col_tiles) * (a0_kb + a1_kb) * G::kBTileFloats;
      layer_kernel<BN><<<row_tiles * l.n_col_tiles, kThreads, G::kSmemBytes, stream>>>(l);
      return cudaGetLastError();
    };

    // the embedding layer, the xyz layers
    if ((e = product(xp, kp_blocks, nullptr, 0, a.b_pts, buf[0], W, false)) != cudaSuccess) {
      return int(e);
    }
    int h = 0;
    for (int li = 0; li < a.xyz_depth; ++li) {
      const int o = other(h, h);
      e = product(buf[h], kw, nullptr, 0, a.b_stack + size_t(li) * W, buf[o], W, false);
      if (e != cudaSuccess) return int(e);
      h = o;
    }
    // the sigma trunk on xyz_code, then the rgb trunk on sigma_feat, each saved (never
    // written) while its trunk runs: L0 and the mid layers, the skip pair, the post layers
    int saved = h, sigma_feat = -1;
    for (int trunk = 0; trunk < 2; ++trunk) {
      const int base = a.xyz_depth + trunk * (a.depth + 1);
      for (int li = base; li <= base + a.depth; ++li) {
        if (li == base + a.skip + 2) continue;  // the pair's second half, taken with its first
        const int o = other(saved, h);
        const bool pair = li == base + a.skip + 1;
        const int bias_row = pair ? li + 1 : li;
        e = product(buf[pair ? saved : h], kw, pair ? buf[h] : nullptr, pair ? kw : 0,
                    a.b_stack + size_t(bias_row) * W, buf[o], W, false);
        if (e != cudaSuccess) return int(e);
        h = o;
      }
      if (trunk == 0) saved = sigma_feat = h;
    }
    // the view layer, then the heads from sigma_feat and the view features
    const int v = other(sigma_feat, h);
    if ((e = product(buf[h], kw, nullptr, 0, a.b_view, buf[v], W2, true)) != cudaSuccess) {
      return int(e);
    }
    const long long threads = static_cast<long long>(m) * 32;
    heads<<<int((threads + 255) / 256), 256, 0, stream>>>(buf[sigma_feat], buf[v], kw, W2,
                                                          a.w_out, W, a.b_out, a.out, row0, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return int(cudaSuccess);
}

// Launches every kernel of the call on `stream`; returns the first cudaError_t (0 on success).
inline int launch(const Args& a, cudaStream_t stream) {
  if (a.n_rows < 0 || a.samples < 1 || a.pe < 1 || a.skip < 0 || a.depth < a.skip + 2 ||
      a.xyz_depth < 0 || a.width % 64 != 0 || a.width < 64 || a.width > 1024 ||
      a.chunk_rows < kRows || a.chunk_rows % kRows != 0) {
    return int(cudaErrorInvalidValue);
  }
  if (a.n_rows == 0) return int(cudaSuccess);
  if (a.tiles == nullptr || a.scratch == nullptr) return int(cudaErrorInvalidValue);
  return a.width % 128 == 0 ? run<128>(a, stream) : run<64>(a, stream);
}

}  // namespace tf32_field
