// The wgmma design of the fused conditioned-field kernel: bf16 at widths 256 and 1024, the
// two fields of the teacher render. field_kernel.cu holds the contract, the dispatch and the
// C entry points; this file is included by it alone.
//
// A persistent CTA of three warpgroups walks over blocks of point rows. Two consumer
// warpgroups run every product as wgmma.mma_async on 64-row tiles (A = the running
// activation, B = a weight tile, both from shared memory, f32 accumulators in registers:
// 128 a thread).
// One thread of the third warpgroup keeps a ring of weight tiles full with bulk copies that
// complete on mbarriers (full[stage] by bytes, empty[stage] by the consumers' arrival), so no
// thread spends an instruction on a copy and a layer's k loop holds no block-wide barrier.
//
// Shared memory, 1024-byte aligned: h | ring | raw sigma | barriers.
//   h     the running activation [rows, W] bf16 as W/64 blocks of [rows, 64]: a row of a block
//         is 128 bytes, and the 16-byte chunk c of row r lies at chunk c ^ (r % 8): the
//         128-byte swizzle wgmma reads K-major operands in. The epilogue writes a layer's
//         output over its input in that layout (plain 4-byte stores: the eight rows a warp
//         stores at once fall into eight different chunks, so no bank is hit twice).
//   ring  stages of one weight tile each, [256 output columns, 64 k] bf16, 32 KB, K-major in
//         the same swizzle. There are two ways to that layout: TMA tensor maps over the
//         [in, out] weights, or tiling the weights on the host side. This takes the second:
//         the wrapper copies every weight once a frame anyway, so it writes exactly these
//         images, in the order the kernel consumes them (ops/field_kernel.py::tile_weights).
//         A stage is then one contiguous cp.async.bulk, no tensor map has to be encoded
//         (nothing links libcuda), and with both operands K-major one descriptor form
//         serves A and B without the transpose bit.
// Both warpgroups consume every tile, in stream order, so each sees every phase of every
// barrier (one that skipped a fill of a stage could find the parity it waits for a fill
// early, while the copy is still under way).
// W = 256:  128 rows a CTA, warpgroup g owns rows [64 g, 64 g + 64) and all 256 columns
//           (m64n256k16); ring of 5. The view layer's 128 columns are padded to 256.
// W = 1024: 64 rows a CTA (h is 128 KB), ring of 3. A layer's 1024 columns are four tiles of
//           256, taken two at a time in two rounds over K; warpgroup g owns columns
//           [128 g, 128 g + 128) of each tile (m64n128k16, one tile into each half of its
//           accumulators) and keeps the first round's output (rounded, 64 packed registers)
//           until the second is done, since h is read until then.
// The saved activation (xyz_code, later sigma_feat) is not kept: the first half of a trunk's
// skip pair, saved @ W, is computed when the trunk starts, while h still holds it, and its
// f32 accumulators wait in a global scratch (each thread stores and reloads its own 128
// values, 16 bytes at a time; 4 KB a row, negligible beside the weights). The second half
// starts from them, so the pair is summed unrounded in the accumulators as the contract asks.
// Rows past n_rows are computed on zeros and not written; a row's ray is row / samples.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_ptx.cuh"

namespace wgmma_field {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kTileN = 256;                        // output columns of a weight tile (wgmma n)
constexpr int kTileK = 64;                         // depth of a weight tile: one swizzled row
constexpr int kTileBytes = kTileN * kTileK * 2;    // 32 KB
constexpr int kConsumerThreads = 256;              // two warpgroups
constexpr int kThreads = 384;                      // and the producer's

struct Args {
  const float* x;        // [N, pe] embedded points
  const float* dirf;     // [R, W/2] per-ray view features, N = R * samples
  const bf16* tiles;     // the weight stream: [tiles a block][256, 64], swizzled
  const float* b_pts;    // [W]
  const float* b_stack;  // [L, W]
  const float* b_view;   // [W/2]
  const bf16* w_out;     // [W + W/2, 4]: rows :W col 3 alpha, rows W: cols 0..2 rgb
  const float* b_out;    // [4]
  float* out;            // [N, 4]: raw rgb, raw sigma
  float* scratch;        // [CTAs][rows * W] f32: the skip pair's first half
  int n_rows, samples, pe, depth, skip, xyz_depth;
  int n_blocks;          // row blocks of the launch
};

template <int W>
struct Geo {
  static_assert(W == 256 || W == 1024, "the wgmma design covers widths 256 and 1024");
  static constexpr bool kSplitCols = W > 256;            // warpgroups split columns, not rows
  static constexpr int kRows = kSplitCols ? 64 : 128;    // point rows of a CTA
  static constexpr int kStages = kSplitCols ? 3 : 5;
  static constexpr int kKBlocks = W / kTileK;
  static constexpr int kNBlocks = W / kTileN;            // weight tiles across a layer
  static constexpr int kRounds = kSplitCols ? kNBlocks / 2 : 1;
  static constexpr int kViewNBlocks = (W / 2 + kTileN - 1) / kTileN;
  static constexpr int kEmptyCount = 8;                  // warps that release a stage: all
  static constexpr int kHBytes = kRows * W * 2;
  static constexpr int kHBlockBytes = kRows * 128;       // one [rows, 64] block of h
  static constexpr int kScratchFloats = kRows * W;       // a CTA's share of the scratch
  static constexpr int kSmemBytes =
      1024 + kHBytes + kStages * kTileBytes + kRows * 4 + 2 * kStages * 8;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a CTA can ask for");
};

// Weight tiles one row block consumes: the embedding layer, the hidden stack, the view layer.
template <int W>
__host__ __device__ inline int tiles_per_block(int depth, int xyz_depth) {
  using G = Geo<W>;
  return G::kNBlocks + (xyz_depth + 2 * (depth + 1)) * G::kKBlocks * G::kNBlocks +
         G::kKBlocks * G::kViewNBlocks;
}

// d (+)= a[64, 16] @ b[256, 16]^T; thread t of the warpgroup holds, for j = 0..31, rows
// 16 (t / 32) + (t % 32) / 4 (d[4j], d[4j+1]) and that + 8 (d[4j+2], d[4j+3]) at columns
// 8 j + 2 (t % 4) and the next. scale_d = 0 starts a new sum.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The same for b[128, 16] into the 64 accumulators from d[kOff] on: columns 8 j + 2 (t % 4)
// of that half for j = 0..15.
template <int kOff>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
      "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]), "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]), "+f"(d[kOff + 6]), "+f"(d[kOff + 7]),
      "+f"(d[kOff + 8]), "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]), "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]), "+f"(d[kOff + 15]),
      "+f"(d[kOff + 16]), "+f"(d[kOff + 17]), "+f"(d[kOff + 18]), "+f"(d[kOff + 19]), "+f"(d[kOff + 20]), "+f"(d[kOff + 21]), "+f"(d[kOff + 22]), "+f"(d[kOff + 23]),
      "+f"(d[kOff + 24]), "+f"(d[kOff + 25]), "+f"(d[kOff + 26]), "+f"(d[kOff + 27]), "+f"(d[kOff + 28]), "+f"(d[kOff + 29]), "+f"(d[kOff + 30]), "+f"(d[kOff + 31]),
      "+f"(d[kOff + 32]), "+f"(d[kOff + 33]), "+f"(d[kOff + 34]), "+f"(d[kOff + 35]), "+f"(d[kOff + 36]), "+f"(d[kOff + 37]), "+f"(d[kOff + 38]), "+f"(d[kOff + 39]),
      "+f"(d[kOff + 40]), "+f"(d[kOff + 41]), "+f"(d[kOff + 42]), "+f"(d[kOff + 43]), "+f"(d[kOff + 44]), "+f"(d[kOff + 45]), "+f"(d[kOff + 46]), "+f"(d[kOff + 47]),
      "+f"(d[kOff + 48]), "+f"(d[kOff + 49]), "+f"(d[kOff + 50]), "+f"(d[kOff + 51]), "+f"(d[kOff + 52]), "+f"(d[kOff + 53]), "+f"(d[kOff + 54]), "+f"(d[kOff + 55]),
      "+f"(d[kOff + 56]), "+f"(d[kOff + 57]), "+f"(d[kOff + 58]), "+f"(d[kOff + 59]), "+f"(d[kOff + 60]), "+f"(d[kOff + 61]), "+f"(d[kOff + 62]), "+f"(d[kOff + 63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_relu(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1) field_kernel_wgmma(const Args p) {
  using G = Geo<W>;
  constexpr int W2 = W / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t h_addr = (raw + 1023u) & ~1023u;
  const uint32_t ring_addr = h_addr + G::kHBytes;
  const uint32_t sig_addr = ring_addr + G::kStages * kTileBytes;
  float* sig = reinterpret_cast<float*>(smem_raw + (sig_addr - raw));  // [rows] raw sigma
  const uint32_t full_bar = sig_addr + G::kRows * 4;
  const uint32_t empty_bar = full_bar + G::kStages * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, G::kEmptyCount);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  // This CTA takes row block blockIdx.x, then the one gridDim.x further, ...; every block
  // consumes the same stream of tiles.
  const int n_tiles = tiles_per_block<W>(p.depth, p.xyz_depth);

  if (warp >= 8) {
    // ---- producer: one thread streams the tiles of every pass into the ring
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(p.tiles);
      uint32_t it = 0;
      for (int blk = blockIdx.x; blk < p.n_blocks; blk += gridDim.x) {
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const uint32_t s = it % G::kStages, phase = (it / G::kStages) & 1u;
          mbar_wait(empty_bar + 8 * s, phase ^ 1u);  // passes at once the first time round
          mbar_expect_tx(full_bar + 8 * s, kTileBytes);
          bulk_copy(ring_addr + s * kTileBytes, src + size_t(t) * kTileBytes, kTileBytes,
                    full_bar + 8 * s);
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<232>();
    const int wg = warp >> 2;                        // warpgroup 0 or 1
    const int l4 = lane >> 2, t4 = lane & 3;
    // this thread's first accumulator row in the CTA (the second is 8 further)
    const int row_lo = (G::kSplitCols ? 0 : wg * 64) + (warp & 3) * 16 + l4;
    const uint32_t a_base = h_addr + (G::kSplitCols ? 0 : wg * 64 * 128);
    const int sync_id = G::kSplitCols ? 1 : 2 + wg;  // who must agree around an in-place update:
    const int sync_n = G::kSplitCols ? 256 : 128;    // all consumers, or the rows' warpgroup
    // rows whose heads this warp computes: among those its sync group has written
    const int head_r0 = G::kSplitCols ? warp : wg * 64 + (warp & 3);
    const int head_r1 = G::kSplitCols ? G::kRows : wg * 64 + 64;
    const int head_step = G::kSplitCols ? 8 : 4;
    float4* scratch = reinterpret_cast<float4*>(p.scratch) +
                      size_t(blockIdx.x) * (G::kScratchFloats / 4) + tid;

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t stash[64];                              // W = 1024: the first round's output
    uint32_t it = 0;                                 // the next tile of the stream
    int pending = -1;                                // stage whose products are in flight

    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);
    };

    // Wait for the next tile of the stream; returns its stage.
    auto next_tile = [&]() -> uint32_t {
      const uint32_t s = it % G::kStages, phase = (it / G::kStages) & 1u;
      mbar_wait(full_bar + 8 * s, phase);
      ++it;
      return s;
    };

    // acc (+)= h[this warpgroup's 64 rows, 0 : 64 n_kb] @ its columns of the next tiles
    auto mma_tiles = [&](int n_kb, bool accumulate) {
      for (int kb = 0; kb < n_kb; ++kb) {
        const uint32_t a = a_base + kb * G::kHBlockBytes;
        const int scale0 = (accumulate || kb > 0) ? 1 : 0;
        if constexpr (G::kSplitCols) {
          // two tiles a k block, this warpgroup's 128 columns of each. With three stages a
          // tile goes back to the producer as soon as its products are complete, so that two
          // copies are under way while the third stage is read (the other warpgroup keeps
          // the tensor cores busy meanwhile; holding the first tile until the second is
          // under way reads slower)
          const uint32_t s0 = next_tile();
          wgmma_fence();
          const uint32_t b0 = ring_addr + s0 * kTileBytes + wg * (128 * 128);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_m64n128k16<0>(acc, make_desc(a + kk * 32), make_desc(b0 + kk * 32),
                                kk > 0 ? 1 : scale0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          release(int(s0));
          const uint32_t s1 = next_tile();
          wgmma_fence();
          const uint32_t b1 = ring_addr + s1 * kTileBytes + wg * (128 * 128);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_m64n128k16<64>(acc, make_desc(a + kk * 32), make_desc(b1 + kk * 32),
                                 kk > 0 ? 1 : scale0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          release(int(s1));
        } else {
          const uint32_t s = next_tile();
          wgmma_fence();
          const uint32_t b = ring_addr + s * kTileBytes;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_m64n256k16(acc, make_desc(a + kk * 32), make_desc(b + kk * 32),
                             kk > 0 ? 1 : scale0);
          }
          wgmma_commit();
          if (pending >= 0) {  // with five stages a warpgroup runs on into the next tile
            wgmma_wait<1>();   // and releases the one before it
            release(pending);
          }
          pending = int(s);
        }
      }
    };

    // All products started so far are complete and their stages released; acc may be read.
    auto drain = [&]() {
      wgmma_wait<0>();
      if (pending >= 0) release(pending);
      pending = -1;
      fence_acc(acc);
    };

    // Column of acc[4 j] (acc[4 j + 1] is the next one) in round r. W = 1024: accumulator
    // half j / 16 is column tile 2 r + j / 16, of which this warpgroup owns 128 columns.
    auto col_of = [&](int r, int j) -> int {
      return (G::kSplitCols ? (2 * r + (j >> 4)) * kTileN + wg * 128 + 8 * (j & 15) : 8 * j) +
             2 * t4;
    };

    // Address in h of this thread's pair at (row_lo, col): col = 8 * col8 + 2 * t4.
    auto h_pair = [&](int col8) -> uint32_t {
      return h_addr + (col8 >> 3) * G::kHBlockBytes + row_lo * 128 +
             (((col8 & 7) ^ (row_lo & 7)) << 4) + t4 * 4;
    };

    // h = round(relu(acc + bias)) at this thread's accumulators of round r
    auto store_dense = [&](const float* bias, int r) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = col_of(r, j);
        const float2 b = *reinterpret_cast<const float2*>(bias + col);
        const uint32_t at = h_pair(col >> 3);
        st_shared_u32(at, pack_relu(acc[4 * j] + b.x, acc[4 * j + 1] + b.y));
        st_shared_u32(at + 8 * 128, pack_relu(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y));
      }
    };

    // One hidden product over h. kind 0: h = round(relu(h @ w + bias)) in place. kind 1, the
    // skip pair's first half: the accumulators of h @ w go to the scratch, h stays. kind 2,
    // its second half: as kind 0, with the accumulators starting from the scratch.
    auto layer = [&](int n_kb, const float* bias, int kind) {
#pragma unroll
      for (int r = 0; r < G::kRounds; ++r) {
        float4* mine = scratch + r * (32 * kConsumerThreads);
        if (kind == 2) {
#pragma unroll
          for (int q = 0; q < 32; ++q) {
            const float4 v = mine[q * kConsumerThreads];
            acc[4 * q] = v.x, acc[4 * q + 1] = v.y, acc[4 * q + 2] = v.z, acc[4 * q + 3] = v.w;
          }
        }
        mma_tiles(n_kb, kind == 2);
        drain();
        if (kind == 1) {
#pragma unroll
          for (int q = 0; q < 32; ++q) {
            mine[q * kConsumerThreads] =
                make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
          }
          continue;
        }
        if (r + 1 < G::kRounds) {
          // h is still read by the next round: keep this round's output in registers
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float2 b = *reinterpret_cast<const float2*>(bias + col_of(r, j));
            stash[2 * j] = pack_relu(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
            stash[2 * j + 1] = pack_relu(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
          }
        } else {
          bar_sync(sync_id, sync_n);  // every product that reads these rows of h is complete
          if (G::kRounds > 1) {
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              const uint32_t at = h_pair(col_of(0, j) >> 3);
              st_shared_u32(at, stash[2 * j]);
              st_shared_u32(at + 8 * 128, stash[2 * j + 1]);
            }
          }
          store_dense(bias, r);
          fence_proxy_async();
          bar_sync(sync_id, sync_n);
        }
      }
    };

    const int trunk_len = p.depth + 1;
    const int n_products = 1 + p.xyz_depth + 2 * trunk_len;

    for (int blk = blockIdx.x; blk < p.n_blocks; blk += gridDim.x) {
      const long long row0 = static_cast<long long>(blk) * G::kRows;

      // --- the embedded points of the block's rows, rounded, fan-in zero-padded to 64,
      // into the first block of h (the head of the block before has read h by now)
      bar_sync(1, kConsumerThreads);
      for (int i = tid; i < G::kRows * 32; i += kConsumerThreads) {
        const int r = i >> 5, cp = i & 31, c = 2 * cp;
        const long long gr = row0 + r;
        float v0 = 0.f, v1 = 0.f;
        if (gr < p.n_rows) {
          const float* xr = p.x + size_t(gr) * p.pe;
          if (c < p.pe) v0 = xr[c];
          if (c + 1 < p.pe) v1 = xr[c + 1];
        }
        const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        st_shared_u32(h_addr + r * 128 + (((cp >> 2) ^ (r & 7)) << 4) + (cp & 3) * 4,
                      *reinterpret_cast<const uint32_t*>(&v));
      }
      fence_proxy_async();
      bar_sync(1, kConsumerThreads);

      // --- the products in stream order: the embedding layer, the xyz layers, then for each
      // trunk (sigma on xyz_code, rgb on sigma_feat) the skip pair's first half, L0, the mid
      // layers, the pair's second half, the post layers. Product q of a trunk reads layer
      // base + skip + 1 (q = 0), base + q - 1 (q = 1..skip + 1) or base + q (q > skip + 1).
      for (int pi = 0; pi < n_products; ++pi) {
        if (pi == 0) {
          layer(1, p.b_pts, 0);
          continue;
        }
        if (pi <= p.xyz_depth) {
          layer(G::kKBlocks, p.b_stack + size_t(pi - 1) * W, 0);
          continue;
        }
        const int trunk = (pi - 1 - p.xyz_depth) / trunk_len;
        const int q = (pi - 1 - p.xyz_depth) - trunk * trunk_len;
        const int base = p.xyz_depth + trunk * trunk_len;
        const int li = q == 0 ? base + p.skip + 1 : (q <= p.skip + 1 ? base + q - 1 : base + q);
        layer(G::kKBlocks, p.b_stack + size_t(li) * W, q == 0 ? 1 : (q == p.skip + 2 ? 2 : 0));
        if (trunk == 0 && q == trunk_len - 1) {
          // raw sigma = sigma_feat @ w_alpha + b_alpha, a row a warp
          const float b_alpha = p.b_out[3];
          for (int r = head_r0; r < head_r1; r += head_step) {
            float s = 0.f;
            for (int jb = 0; jb < G::kKBlocks; ++jb) {
              const float2 a = unpack(ld_shared_u32(h_addr + jb * G::kHBlockBytes + r * 128 +
                                                    ((l4 ^ (r & 7)) << 4) + t4 * 4));
              const int c = jb * 64 + 2 * lane;
              s = fmaf(a.x, __bfloat162float(p.w_out[size_t(c) * 4 + 3]), s);
              s = fmaf(a.y, __bfloat162float(p.w_out[size_t(c + 1) * 4 + 3]), s);
            }
            s = warp_sum(s);
            if (lane == 0) sig[r] = s + b_alpha;
          }
        }
      }

      // --- view layer: relu(rgb_feat @ w_view + b_view + dir_feat[ray]) into h[:, 0 : W/2]
      mma_tiles(G::kKBlocks, false);
      drain();
      bar_sync(sync_id, sync_n);
      {
        long long g_lo = row0 + row_lo, g_hi = g_lo + 8;
        if (g_lo >= p.n_rows) g_lo = p.n_rows - 1;  // padding rows read a real ray
        if (g_hi >= p.n_rows) g_hi = p.n_rows - 1;
        const float* d_lo = p.dirf + size_t(g_lo / p.samples) * W2;
        const float* d_hi = p.dirf + size_t(g_hi / p.samples) * W2;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = col_of(0, j);
          if (G::kSplitCols || 8 * j < W2) {  // at W = 256 the tile's upper half is padding
            const float2 b = *reinterpret_cast<const float2*>(p.b_view + col);
            const float2 lo = *reinterpret_cast<const float2*>(d_lo + col);
            const float2 hi = *reinterpret_cast<const float2*>(d_hi + col);
            const uint32_t at = h_pair(col >> 3);
            st_shared_u32(at, pack_relu(acc[4 * j] + b.x + lo.x, acc[4 * j + 1] + b.y + lo.y));
            st_shared_u32(at + 8 * 128,
                          pack_relu(acc[4 * j + 2] + b.x + hi.x, acc[4 * j + 3] + b.y + hi.y));
          }
        }
      }
      bar_sync(sync_id, sync_n);  // the head below reads h with plain loads: no proxy fence

      // --- raw rgb = view @ w_rgb + b_rgb, a row a warp; write [rgb, sigma]
      const bf16* w_rgb = p.w_out + size_t(W) * 4;
      for (int r = head_r0; r < head_r1; r += head_step) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f;
        for (int jb = 0; jb < W2 / 64; ++jb) {
          const float2 a = unpack(ld_shared_u32(h_addr + jb * G::kHBlockBytes + r * 128 +
                                                ((l4 ^ (r & 7)) << 4) + t4 * 4));
          const bf16* w = w_rgb + size_t(jb * 64 + 2 * lane) * 4;
          s0 = fmaf(a.x, __bfloat162float(w[0]), s0);
          s1 = fmaf(a.x, __bfloat162float(w[1]), s1);
          s2 = fmaf(a.x, __bfloat162float(w[2]), s2);
          s0 = fmaf(a.y, __bfloat162float(w[4]), s0);
          s1 = fmaf(a.y, __bfloat162float(w[5]), s1);
          s2 = fmaf(a.y, __bfloat162float(w[6]), s2);
        }
        s0 = warp_sum(s0);
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        const long long gr = row0 + r;
        if (lane == 0 && gr < p.n_rows) {
          reinterpret_cast<float4*>(p.out)[gr] =
              make_float4(s0 + p.b_out[0], s1 + p.b_out[1], s2 + p.b_out[2], sig[r]);
        }
      }
    }
  }
}

// Launches one persistent CTA an SM at most (max_ctas, which is what the scratch was sized
// for). Returns the cudaError_t of the launch.
template <int W>
int launch(Args a, int max_ctas, cudaStream_t stream) {
  using G = Geo<W>;
  cudaError_t e = cudaFuncSetAttribute(field_kernel_wgmma<W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (e != cudaSuccess) return int(e);
  a.n_blocks = (a.n_rows + G::kRows - 1) / G::kRows;
  const int grid = a.n_blocks < max_ctas ? a.n_blocks : max_ctas;
  if (grid < 1) return int(cudaErrorInvalidValue);
  field_kernel_wgmma<W><<<grid, kThreads, G::kSmemBytes, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace wgmma_field
