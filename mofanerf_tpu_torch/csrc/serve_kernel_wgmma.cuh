// The wgmma design of the fused bounded-render kernel: bf16 at the serving width W = 128, with
// 0 to 5 hidden layers, 3 + 6 * multires <= 64 and S samples a ray dividing 64, or 128.
// serve_kernel.cu holds the contract, the dispatch and the C entry point.
//
// The whole bf16 weight set fits one CTA's shared memory (166 KB at depth 4), so it is never
// streamed: a persistent CTA, one an SM, copies the pre-tiled image once at start
// (cp.async.bulk on one mbarrier, issued by one thread) and keeps it for every tile it takes.
// Its four warpgroups then work independently, each on its own items of 64 sample rows (64 / S
// whole rays; a ray of 128 samples is an item of two tiles), taken by a static stride. A
// warpgroup's tile is a chain of dependent steps (loads, sinf, products, epilogues, composite),
// so what feeds the tensor cores while one waits is the others: four of them (the launch
// bounds hold a thread to 128 registers) read faster than three at 153.
//
// Per 64-row tile every product is wgmma.mma_async with A from registers and B, a weight tile,
// from shared memory (K-major, 128-byte swizzle, as ops/serve_kernel.py::tile_student_weights
// writes it): the input layer and the hidden layers m64n128k16, the sigma|feat head m64n72k16
// (64 feature columns, sigma, zero padding to a multiple of 8), the rgb head m64n8k16. The
// activations never touch shared memory: a layer's f32 accumulators go through bias, ReLU and
// one rounding to bf16 and are packed in place into the next layer's A fragments, since the
// accumulator pair at columns 8 j + 2 (t % 4) of a thread is its A fragment of k step j / 2
// (the layout FlashAttention-3 uses for P @ V). The input layer's A fragments are computed in
// registers too: each thread places its two rows' sample points and takes sinf of the bands
// at the sixteen columns it owns. The head's epilogue adds the bias and the ray's view
// features in f32, applies ReLU and hands the rounded result to the rgb product as A.
//
// Per-row (raw sigma, rgb) go to a 1 KB buffer of the warpgroup (two, alternating, so that one
// named barrier of the warpgroup's 128 threads an item suffices: never a block-wide one), and
// the composite reads them in sample order: min(32, S) lanes a ray, each over its consecutive
// samples, joined by a warp scan of the transmittance (one thread a ray, serially, as the
// mma.sync design composites, left the other 126 threads of the warpgroup waiting: a launch
// ~20% slower on an H100, serve_variants.py's `wserial`). Sums are taken in another order
// than the mma.sync design's serial loop: f32 rounding apart, the same outputs
// (tests/test_torch_serve_kernel.py replays this order against it). An item whose
// rays all miss skips the MLP and writes the analytic background at once: the contract already
// multiplies their sigma by a zero hit, so this is the same output.
//
// Shared memory, 1024-byte aligned: weight image | biases (f32) | composite buffers | barrier.
//   image  input [128 n][64 k] | hidden l: 2 K blocks of [128][64] | head 2 K blocks of
//          [72][64] | rgb [8][64] (K = 64 of which W/2 real); row n of a block is 128 bytes
//          and its 16-byte chunk c lies at chunk c ^ (n % 8).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_ptx.cuh"
#include "serve_kernel_mma.cuh"  // sample_depth and kHalfPi: both designs place samples alike

namespace wgmma_serve {

using namespace hopper;
using bf16 = __nv_bfloat16;
using mma_serve::kHalfPi;
using mma_serve::sample_depth;

constexpr int kW = 128;                        // the width this design is built for
constexpr int kW2 = kW / 2;
constexpr int kMaxDepth = 5;                   // hidden layers whose weights fit beside the rest
constexpr int kMaxSamples = 128;
constexpr int kTileK = 64;                     // depth of a K block: one 128-byte swizzled row
constexpr int kHeadN = 72;                     // sigma|feat head columns: W/2 + 1 padded to 8
constexpr int kRgbN = 8;                       // rgb head columns: 3 padded to wgmma's least n
constexpr int kWarpgroups = 4;
constexpr int kThreads = 128 * kWarpgroups;
constexpr uint32_t kCopyChunk = 16384;         // bytes a bulk copy of the image

constexpr uint32_t kInBytes = kW * 128;                     // [128 n][64 k]
constexpr uint32_t kHiddenBlockBytes = kW * 128;            // one K block of a hidden layer
constexpr uint32_t kHiddenBytes = (kW / kTileK) * kHiddenBlockBytes;
constexpr uint32_t kHeadBlockBytes = kHeadN * 128;
constexpr uint32_t kHeadBytes = (kW / kTileK) * kHeadBlockBytes;
constexpr uint32_t kRgbBytes = kRgbN * 128;

// Items skipped (rays all missing) over every launch on this device since the count was last
// reset (serve_kernel.cu::serve_items_skipped reads it): what the skip really did, not what a
// hit mask says it would do.
__device__ unsigned long long g_items_skipped;

struct Args {
  const float* rays_o;          // [N, 3]
  const float* rays_d;          // [N, 3]
  const float* aux;             // [N, 4]: t0, t1, hit, |d|
  const bf16* dirf;             // [N, W/2]
  const unsigned char* tiles;   // the weight image (ops/serve_kernel.py::tile_student_weights)
  const float* b0;              // [W]
  const float* bl;              // [D, W]
  const float* bsig;            // [1]
  const float* bfeat;           // [W/2]
  const float* brgb;            // [3]
  float* out;                   // [N, 8]: rgb, acc, depth, disp, 0, 0
  int n_rays, n_samples, depth, multires, white_bkgd;
  int n_items;                  // work items of the launch
};

__host__ __device__ inline int rows_item(int n_samples) { return n_samples > 64 ? n_samples : 64; }

__host__ __device__ inline uint32_t image_bytes(int depth) {
  return kInBytes + uint32_t(depth) * kHiddenBytes + kHeadBytes + kRgbBytes;
}

// b0 | bl | bfeat | bsig, 3 zeros | brgb, 1 zero
__host__ __device__ inline int bias_floats(int depth) { return kW + depth * kW + kW2 + 8; }

__host__ __device__ inline size_t smem_bytes(int depth, int n_samples) {
  return 1024 + image_bytes(depth) + size_t(bias_floats(depth)) * 4 +
         size_t(kWarpgroups) * 2 * rows_item(n_samples) * 4 * sizeof(float) + 16;
}
static_assert(1024 + kInBytes + kMaxDepth * kHiddenBytes + kHeadBytes + kRgbBytes +
                      (kW + kMaxDepth * kW + kW2 + 8) * 4 + kWarpgroups * 2 * kMaxSamples * 16 +
                      16 <= 232448,
              "over the 227 KB a CTA can ask for");

// Whether this design takes the shape (ops/serve_kernel.py::uses_wgmma states the same rule
// with the dtype).
__host__ __device__ inline bool takes(int width, int depth, int multires, int n_samples) {
  return width == kW && depth >= 0 && depth <= kMaxDepth && multires >= 0 &&
         3 + 6 * multires <= kTileK && n_samples >= 1 && n_samples <= kMaxSamples &&
         (64 % n_samples == 0 || n_samples % 64 == 0);
}

// d (+)= a[64, 16] @ b[n, 16]^T on the tensor cores. a comes from registers: this thread's
// fragment of its warp's 16 rows, laid out as mma.m16n8k16 holds A (a[0], a[1]: rows
// (t % 32) / 4 and that + 8 at k 2 (t % 4) and the next; a[2], a[3]: the same 8 further in k).
// b is K-major in the 128-byte swizzle. Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (d[4j], d[4j+1]) and that + 8 (d[4j+2], d[4j+3]) at columns
// 8 j + 2 (t % 4) and the next. kFirst starts a new sum (d is only written).
template <bool kFirst>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kFirst) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

template <bool kFirst>
__device__ __forceinline__ void wgmma_n72(float (&d)[36], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kFirst) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35"
        "}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n"
        "}\n"
        :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35"
        "}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n"
        "}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

template <bool kFirst>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kFirst) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
        "}\n"
        :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
        "}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

// Keeps registers that an in-flight wgmma reads alive, unchanged, up to this point.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// pack_bf16(relu(lo), relu(hi)) in one instruction: ReLU and round-to-nearest commute
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  uint32_t v;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(hi), "f"(lo));
  return v;
}

// Column c of the input layer's input row for the point x: [x, sin(x * 2^b), cos(x * 2^b), ...]
// with cos(y) = sin(y + f32(pi/2)), zero from k0 on (the K block's padding).
__device__ __forceinline__ float embed_col(float x0, float x1, float x2, int c, int k0) {
  if (c < 3) return c == 0 ? x0 : (c == 1 ? x1 : x2);
  if (c >= k0) return 0.f;
  const int i = c - 3, band = i / 6, j = i - 6 * band;
  const int d = j < 3 ? j : j - 3;
  const float x = d == 0 ? x0 : (d == 1 ? x1 : x2);
  float arg = __fmul_rn(x, __int_as_float((127 + band) << 23));  // exact: a power of two
  if (j >= 3) arg = __fadd_rn(arg, kHalfPi);
  return sinf(arg);
}

// A layer's accumulators -> the next layer's A fragments: round(relu(acc + bias)), packed in
// place (k step kk is the accumulator pair of columns 16 kk + 2 (t % 4) and 16 kk + 8 + 2 (t % 4)).
template <int KSteps>
__device__ __forceinline__ void to_frags(const float (&acc)[4 * 2 * KSteps], const float* bias,
                                         int q, uint32_t (&a)[KSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < KSteps; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h;
      const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
      a[kk][2 * h] = pack_relu(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
      a[kk][2 * h + 1] = pack_relu(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
    }
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// out[ray] from its composited sums (the mma.sync design's finish, and the background of a
// ray whose sums are all zero)
__device__ __forceinline__ void finish(float* o, float cr, float cg, float cb, float acc_w,
                                       float acc_zw, int white_bkgd) {
  const float disp = 1.f / fmaxf(1e-10f, acc_zw / fmaxf(acc_w, 1e-10f));
  if (white_bkgd) {
    const float bg = 1.f - acc_w;
    cr += bg;
    cg += bg;
    cb += bg;
  }
  reinterpret_cast<float4*>(o)[0] = make_float4(cr, cg, cb, acc_w);
  reinterpret_cast<float4*>(o)[1] = make_float4(acc_zw, disp, 0.f, 0.f);
}

__global__ void __launch_bounds__(kThreads, 1) serve_kernel_wgmma(const Args p) {
  extern __shared__ unsigned char smem_raw[];
  const int D = p.depth, S = p.n_samples;
  const int rows_it = rows_item(S), rays_it = rows_it / S, tiles_it = rows_it / 64;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t img = (raw + 1023u) & ~1023u;
  float* bias = reinterpret_cast<float*>(smem_raw + (img - raw) + image_bytes(D));
  float* bufs = bias + bias_floats(D);                     // [warpgroups][2][rows_it][4]
  const uint32_t bar = smem_u32(bufs + kWarpgroups * 2 * rows_it * 4);
  const float* b_feat = bias + kW + D * kW;
  const float* b_sig = b_feat + kW2;
  const float* b_rgb = b_sig + 4;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbarrier_init();
  }
  for (int i = tid; i < bias_floats(D); i += kThreads) {
    const int f = i - (kW + D * kW + kW2);
    float v = 0.f;
    if (i < kW) {
      v = p.b0[i];
    } else if (i < kW + D * kW) {
      v = p.bl[i - kW];
    } else if (f < 0) {
      v = p.bfeat[i - kW - D * kW];
    } else if (f == 0) {
      v = p.bsig[0];
    } else if (f >= 4 && f < 7) {
      v = p.brgb[f - 4];
    }
    bias[i] = v;
  }
  __syncthreads();  // the barrier is initialised and the biases are in place
  if (tid == 0) {
    const uint32_t bytes = image_bytes(D);
    mbar_expect_tx(bar, bytes);
    for (uint32_t off = 0; off < bytes; off += kCopyChunk) {
      bulk_copy(img + off, p.tiles + off, bytes - off < kCopyChunk ? bytes - off : kCopyChunk, bar);
    }
  }

  const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const int q = lane % 4;
  const int r0 = warp * 16 + lane / 4;                    // this thread's rows: r0 and r0 + 8
  const int k0 = 3 + 6 * p.multires;
  const float u_den = float(S > 1 ? S - 1 : 1);
  const uint32_t w_hidden = img + kInBytes;
  const uint32_t w_head = w_hidden + uint32_t(D) * kHiddenBytes;
  const uint32_t w_rgb = w_head + kHeadBytes;
  int parity = 0;                                         // which of the two buffers is next

  for (int item = blockIdx.x * kWarpgroups + wg; item < p.n_items;
       item += gridDim.x * kWarpgroups) {
    const int ray0 = item * rays_it;
    // an item whose rays all miss writes the background; every warp finds the same answer
    bool any = false;
    for (int r = lane; r < rays_it; r += 32) {
      any = any || (ray0 + r < p.n_rays && p.aux[(ray0 + r) * 4 + 2] != 0.f);
    }
    if (!__any_sync(0xffffffffu, any)) {
      if (t < rays_it && ray0 + t < p.n_rays) {
        finish(p.out + size_t(ray0 + t) * 8, 0.f, 0.f, 0.f, 0.f, 0.f, p.white_bkgd);
      }
      if (t == 0) atomicAdd(&g_items_skipped, 1ull);
      continue;
    }
    float* buf = bufs + (wg * 2 + parity) * rows_it * 4;

    for (int tile = 0; tile < tiles_it; ++tile) {
      // this thread's two rows: ray, sample, point (rays past n_rays read the last one)
      const int row_lo = item * rows_it + tile * 64 + r0;
      int ray_of[2];
      float x[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row_lo + 8 * h, ray = gr / S, s = gr - ray * S;
        ray_of[h] = ray < p.n_rays ? ray : p.n_rays - 1;
        const float* a = p.aux + ray_of[h] * 4;
        const float z = sample_depth(a[0], a[1], s, u_den);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          x[h][d] = __fadd_rn(p.rays_o[ray_of[h] * 3 + d], __fmul_rn(p.rays_d[ray_of[h] * 3 + d], z));
        }
      }

      // --- input layer: A is the embedding, built in registers
      uint32_t a_in[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * kk + 8 * h + 2 * q;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            a_in[kk][2 * h + rr] = pack_bf16(embed_col(x[rr][0], x[rr][1], x[rr][2], c, k0),
                                             embed_col(x[rr][0], x[rr][1], x[rr][2], c + 1, k0));
          }
        }
      }
      mbar_wait(bar, 0);  // the weights are resident (at once after the first time)
      float acc[64];
      wgmma_fence();
      wgmma_n128<true>(acc, a_in[0], make_desc(img));
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) wgmma_n128<false>(acc, a_in[kk], make_desc(img + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frags(a_in);
      uint32_t a[8][4];
      to_frags<8>(acc, bias, q, a);

      // --- hidden layers
      for (int l = 0; l < D; ++l) {
        const uint32_t w = w_hidden + uint32_t(l) * kHiddenBytes;
        wgmma_fence();
        wgmma_n128<true>(acc, a[0], make_desc(w));
#pragma unroll
        for (int kk = 1; kk < 8; ++kk) {
          wgmma_n128<false>(acc, a[kk], make_desc(w + (kk / 4) * kHiddenBlockBytes + (kk % 4) * 32));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        fence_frags(a);
        to_frags<8>(acc, bias + kW + l * kW, q, a);
      }

      // --- sigma|feat head: features + bias + the ray's view features (f32), ReLU, rounded
      float acch[36];
      wgmma_fence();
      wgmma_n72<true>(acch, a[0], make_desc(w_head));
#pragma unroll
      for (int kk = 1; kk < 8; ++kk) {
        wgmma_n72<false>(acch, a[kk], make_desc(w_head + (kk / 4) * kHeadBlockBytes + (kk % 4) * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acch);
      fence_frags(a);
      uint32_t ap[4][4];
      const bf16* dirf_lo = p.dirf + size_t(ray_of[0]) * kW2;
      const bf16* dirf_hi = p.dirf + size_t(ray_of[1]) * kW2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * kk + h, c = 8 * j + 2 * q;
          const float2 b = *reinterpret_cast<const float2*>(b_feat + c);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dirf_lo + c));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dirf_hi + c));
          ap[kk][2 * h] = pack_relu(acch[4 * j] + b.x + lo.x, acch[4 * j + 1] + b.y + lo.y);
          ap[kk][2 * h + 1] = pack_relu(acch[4 * j + 2] + b.x + hi.x, acch[4 * j + 3] + b.y + hi.y);
        }
      }
      // raw sigma is column W/2: accumulator pair 8 of the threads with t % 4 == 0
      const float sig_lo = acch[32] + b_sig[0], sig_hi = acch[34] + b_sig[0];

      // --- rgb head
      float accc[4];
      wgmma_fence();
      wgmma_n8<true>(accc, ap[0], make_desc(w_rgb));
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) wgmma_n8<false>(accc, ap[kk], make_desc(w_rgb + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(accc);
      fence_frags(ap);

      // --- per-row (raw sigma, rgb) into the warpgroup's buffer
      float* lo = buf + (tile * 64 + r0) * 4;
      float* hi = lo + 8 * 4;
      if (q == 0) {
        lo[0] = sig_lo;
        lo[1] = sigmoid(accc[0] + b_rgb[0]);
        lo[2] = sigmoid(accc[1] + b_rgb[1]);
        hi[0] = sig_hi;
        hi[1] = sigmoid(accc[2] + b_rgb[0]);
        hi[2] = sigmoid(accc[3] + b_rgb[1]);
      } else if (q == 1) {
        lo[3] = sigmoid(accc[0] + b_rgb[2]);
        hi[3] = sigmoid(accc[2] + b_rgb[2]);
      }
    }
    // every row of the item is in the buffer; the other buffer's readers are done with it
    bar_sync(1 + wg, 128);

    // --- composite (f32): L = min(32, S) lanes a ray, each over S / L consecutive samples in
    // order; the transmittance in front of a lane's samples is a product scan over the ray's
    // lanes, and the lanes' sums, scaled by it, are added up across them. The warps that hold
    // the item's rays take part whole (64 or 32 threads), so every shuffle has all 32 lanes.
    const int L = S < 32 ? S : 32, chunk = S / L;
    if (warp * 32 < rays_it * L) {
      const int ri = warp * (32 / L) + lane / L, li = lane % L;
      const int ray = ray0 + ri < p.n_rays ? ray0 + ri : p.n_rays - 1;
      const float t0 = p.aux[ray * 4], t1 = p.aux[ray * 4 + 1];
      const float hit = p.aux[ray * 4 + 2], normd = p.aux[ray * 4 + 3];
      const float delta = __fmul_rn(__fdiv_rn(__fsub_rn(t1, t0), u_den), normd);
      const float last = __fmul_rn(1e10f, normd);
      float trans = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, acc_w = 0.f, acc_zw = 0.f;
      for (int c = 0; c < chunk; ++c) {
        const int s = li * chunk + c;
        const float* sp = buf + (ri * S + s) * 4;
        const float sig = __fmul_rn(fmaxf(sp[0], 0.f), hit);
        const float a = 1.f - expf(__fmul_rn(-sig, s < S - 1 ? delta : last));
        const float w = __fmul_rn(a, trans);
        cr = __fadd_rn(cr, __fmul_rn(w, sp[1]));
        cg = __fadd_rn(cg, __fmul_rn(w, sp[2]));
        cb = __fadd_rn(cb, __fmul_rn(w, sp[3]));
        acc_w = __fadd_rn(acc_w, w);
        acc_zw = __fadd_rn(acc_zw, __fmul_rn(w, sample_depth(t0, t1, s, u_den)));
        trans = __fmul_rn(trans, __fadd_rn(1.f - a, 1e-10f));
      }
      for (int o = 1; o < L; o <<= 1) {  // inclusive product scan of the lanes' transmittance
        const float v = __shfl_up_sync(0xffffffffu, trans, o, L);
        if (li >= o) trans = __fmul_rn(trans, v);
      }
      float front = __shfl_up_sync(0xffffffffu, trans, 1, L);
      if (li == 0) front = 1.f;
      float v[5] = {__fmul_rn(cr, front), __fmul_rn(cg, front), __fmul_rn(cb, front),
                    __fmul_rn(acc_w, front), __fmul_rn(acc_zw, front)};
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        for (int o = L / 2; o > 0; o >>= 1) {
          v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], o, L));
        }
      }
      if (li == 0 && ray0 + ri < p.n_rays) {
        finish(p.out + size_t(ray0 + ri) * 8, v[0], v[1], v[2], v[3], v[4], p.white_bkgd);
      }
    }
    parity ^= 1;
  }
  mbar_wait(bar, 0);  // no CTA leaves while its copy of the weights is under way
}

// Launches one persistent CTA an SM at most. Returns the cudaError_t of the launch.
inline int launch(Args a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.depth, a.n_samples);
  cudaError_t e = cudaFuncSetAttribute(serve_kernel_wgmma,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  int dev = 0, n_sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return int(e);
  e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const int rays_it = rows_item(a.n_samples) / a.n_samples;
  a.n_items = (a.n_rays + rays_it - 1) / rays_it;
  const int want = (a.n_items + kWarpgroups - 1) / kWarpgroups;
  const int grid = want < n_sms ? want : n_sms;
  serve_kernel_wgmma<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace wgmma_serve
