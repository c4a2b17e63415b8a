// The mma.sync design of the fused bounded-render kernel, the first one written: f32
// (FFMA) and every bf16 shape the wgmma design does not take. serve_kernel.cu holds the
// contract, the dispatch and the C entry point; this file is included by it.
//
// Design: a CTA takes kRows sample rows (kRows / S whole rays, ray-major) and keeps their
// activations in shared memory through every layer, so device memory sees only rays in
// and pixels out. The layers run one after another over the CTA's rows; each layer's
// weights are staged into shared memory once per CTA. bf16 products run on the tensor
// cores (mma.sync m16n8k16 with f32 accumulators, operands through ldmatrix); f32
// products run as FFMA on the CUDA cores (tensor-core TF32 would drop the f32 contract).
// One thread per ray composites its samples in order. Rays past n_rays are masked, so
// any ray count is accepted: widths that are multiples of 32 up to 128, 1 to 128 (f32) or
// 256 (bf16) samples a ray.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mma_serve {

using bf16 = __nv_bfloat16;

constexpr int kMaxWidth = 128;
constexpr int kPad = 8;  // row padding in elements: 16-byte rows for ldmatrix, spread banks
constexpr float kHalfPi = 1.57079637050628662109375f;  // float32(pi / 2), the JAX phase

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kRows = 128;  // an 8x8 FFMA tile a thread
  static constexpr int kThreads = 256;
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

template <>
struct Traits<bf16> {
  static constexpr int kRows = 256;  // a 16-row mma strip a warp
  static constexpr int kThreads = 512;
  __device__ static float to_f(bf16 x) { return __bfloat162float(x); }
  __device__ static bf16 from_f(float x) { return __float2bfloat16_rn(x); }
};

template <typename T>
struct Args {
  const float* rays_o;  // [N, 3]
  const float* rays_d;  // [N, 3]
  const float* aux;     // [N, 4]: t0, t1, hit, |d|
  const T* dirf;        // [N, W/2]
  const T* w0;          // [3 + 6*mr, W]: point rows, then embedding rows
  const float* b0;      // [W]
  const T* wl;          // [D, W, W]
  const float* bl;      // [D, W]
  const T* wsig;        // [W]
  const float* bsig;    // [1]
  const T* wfeat;       // [W, W/2]
  const float* bfeat;   // [W/2]
  const T* wrgb;        // [W/2, 3]
  const float* brgb;    // [3]
  float* out;           // [N, 8]: rgb, acc, depth, disp, 0, 0
  int n_rays, n_samples, depth, width, multires, white_bkgd;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory plan, computed the same way on the host (launch size) and in the kernel.
struct Layout {
  int k0;            // input-layer fan-in, 3 + 6*mr
  int k0p;           // ... padded to the 16-deep mma step (padding is zero)
  int nh;            // head columns: W/2 feature columns, the sigma column, zero padding
  int lda;           // activation row stride (elements)
  int ldw;           // staged weight row stride (elements)
  int kmax;          // staged weight rows
  int rays_per_cta;
  size_t off_w, off_samp, bytes;
};

template <typename T>
__host__ __device__ inline Layout make_layout(int width, int multires, int n_samples) {
  constexpr int rows = Traits<T>::kRows;
  Layout L;
  L.k0 = 3 + 6 * multires;
  L.k0p = round_up(L.k0, 16);
  L.nh = round_up(width / 2 + 1, 16);
  L.kmax = imax(width, L.k0p);
  L.lda = L.kmax + kPad;
  L.ldw = imax(width, L.nh) + kPad;
  L.rays_per_cta = rows / n_samples;
  L.off_w = align128(size_t(rows) * L.lda * sizeof(T));
  L.off_samp = L.off_w + align128(size_t(L.kmax) * L.ldw * sizeof(T));
  L.bytes = L.off_samp + size_t(rows) * 4 * sizeof(float);
  return L;
}

// Stage a [rows, cols] row-major weight block into shared memory with row stride ldw,
// rows [rows, rows_pad) zero-filled. cols is a multiple of 16, so rows move as 16-byte
// vectors when the source is 16-byte aligned.
template <typename T>
__device__ void stage_weights(T* dst, int ldw, const T* src, int rows, int rows_pad, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kThreads = Traits<T>::kThreads;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int vecs = cols / kVec;
#pragma unroll 4
    for (int i = threadIdx.x; i < rows_pad * vecs; i += kThreads) {
      const int r = i / vecs, v = i - r * vecs;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) x = reinterpret_cast<const uint4*>(src + size_t(r) * cols)[v];
      reinterpret_cast<uint4*>(dst + r * ldw)[v] = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows_pad * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ldw + c] = r < rows ? src[size_t(r) * cols + c] : Traits<T>::from_f(0.f);
    }
  }
}

// out[r, n] = sum_k act[r, k] * w[k, n] over the CTA's rows, n < ncols (a multiple of 16),
// k < kdim (a multiple of 16), accumulated in f32 and handed to epi(row, col, value).
// Every read of a row's inputs is done before epi sees that row, so epi may overwrite
// the activations in place.
//
// bf16: a warp owns 16-row strips and runs mma.sync m16n8k16 on the tensor cores, with
// operands from shared memory through ldmatrix (B transposed on the fly: the weights are
// stored [in, out], row-major).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a @ b for a 16x16 bf16 A fragment and a 16x8 bf16 B fragment, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class Epi>
__device__ void gemm_rows(const bf16* act, int lda, const bf16* w, int ldw, int kdim,
                          int ncols, Epi epi) {
  constexpr int kWarps = Traits<bf16>::kThreads / 32;
  constexpr int kTiles = kMaxWidth / 8;  // n8 output tiles at the widest layer
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;            // accumulator row / column pair
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;  // ldmatrix row address of this lane
  const int pairs = ncols / 16;
  for (int strip = warp; strip < Traits<bf16>::kRows / 16; strip += kWarps) {
    const int row0 = strip * 16;
    float acc[kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k = 0; k < kdim; k += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, act + (row0 + lrow) * lda + k + lcol);
#pragma unroll
      for (int jp = 0; jp < kTiles / 2; ++jp) {
        if (jp < pairs) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, w + (k + lrow) * ldw + jp * 16 + lcol);
          mma_bf16(acc[2 * jp], a, b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j / 2 < pairs) {
        const int c = j * 8 + 2 * t;
        epi(row0 + g, c, acc[j][0]);
        epi(row0 + g, c + 1, acc[j][1]);
        epi(row0 + g + 8, c, acc[j][2]);
        epi(row0 + g + 8, c + 1, acc[j][3]);
      }
    }
    __syncwarp();
  }
}

// f32: an 8x8 register tile a thread (16 row groups x 16 column groups of 8).
template <class Epi>
__device__ void gemm_rows(const float* act, int lda, const float* w, int ldw, int kdim,
                          int ncols, Epi epi) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const bool active = tc * 8 < ncols;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (active) {
    for (int k = 0; k < kdim; ++k) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = act[(tr * 8 + i) * lda + k];
      const float4 b0 = *reinterpret_cast<const float4*>(w + k * ldw + tc * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(w + k * ldw + tc * 8 + 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) epi(tr * 8 + i, tc * 8 + j, acc[i][j]);
  }
}

// Depth of sample s of a ray: t0 + (t1 - t0) * (s / max(S-1, 1)), rounded op by op.
__device__ inline float sample_depth(float t0, float t1, int s, float u_den) {
  return __fadd_rn(t0, __fmul_rn(__fsub_rn(t1, t0), __fdiv_rn(float(s), u_den)));
}

template <typename T>
__global__ void __launch_bounds__(Traits<T>::kThreads) serve_kernel(Args<T> p) {
  using Tr = Traits<T>;
  constexpr int kRows = Tr::kRows, kThreads = Tr::kThreads, kWarps = kThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T>(p.width, p.multires, p.n_samples);
  T* act = reinterpret_cast<T*>(smem);                       // [kRows, lda]
  T* wbuf = reinterpret_cast<T*>(smem + L.off_w);            // [kmax, ldw]
  float* samp = reinterpret_cast<float*>(smem + L.off_samp);  // [kRows, 4]: raw sigma, rgb

  const int S = p.n_samples, W = p.width, W2 = W / 2, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ray0 = blockIdx.x * L.rays_per_cta;
  const int rows_used = L.rays_per_cta * S;
  const float u_den = float(imax(S - 1, 1));

  // --- sample points, a row a thread (parked in samp until the head's outputs land there)
  for (int r = tid; r < kRows; r += kThreads) {
    const int ray = ray0 + r / S;
    float* q = samp + r * 4;
    const bool valid = r < rows_used && ray < p.n_rays;
    const float z = valid ? sample_depth(p.aux[ray * 4], p.aux[ray * 4 + 1], r % S, u_den) : 0.f;
    for (int d = 0; d < 3; ++d)
      q[d] = valid ? __fadd_rn(p.rays_o[ray * 3 + d], __fmul_rn(p.rays_d[ray * 3 + d], z)) : 0.f;
    q[3] = valid ? 1.f : 0.f;
  }
  stage_weights(wbuf, L.ldw, p.w0, L.k0, L.k0p, W);
  __syncthreads();

  // --- the input layer's input [points, sin(points * 2^k + phase)], a row a warp
  for (int r = warp; r < kRows; r += kWarps) {
    const float* q = samp + r * 4;
    for (int c = lane; c < L.k0p; c += 32) {
      float v = 0.f;
      if (q[3] != 0.f && c < L.k0) {
        if (c < 3) {
          v = q[c];
        } else {
          const int band = (c - 3) / 6, j = (c - 3) - 6 * band;
          float arg = ldexpf(q[j % 3], band);  // exact: the bands are powers of two
          if (j >= 3) arg = __fadd_rn(arg, kHalfPi);
          v = sinf(arg);
        }
      }
      act[r * L.lda + c] = Tr::from_f(v);
    }
  }
  __syncthreads();
  gemm_rows(act, L.lda, wbuf, L.ldw, L.k0p, W, [&](int r, int c, float v) {
    act[r * L.lda + c] = Tr::from_f(fmaxf(v + p.b0[c], 0.f));
  });

  // --- hidden layers
  for (int l = 0; l < p.depth; ++l) {
    __syncthreads();  // every warp is done with the staged weights
    stage_weights(wbuf, L.ldw, p.wl + size_t(l) * W * W, W, W, W);
    __syncthreads();
    const float* b = p.bl + l * W;
    gemm_rows(act, L.lda, wbuf, L.ldw, W, W, [&](int r, int c, float v) {
      act[r * L.lda + c] = Tr::from_f(fmaxf(v + b[c], 0.f));
    });
  }

  // --- head: columns [0, W/2) are the view features, column W/2 is raw sigma
  __syncthreads();
  stage_weights(wbuf, L.ldw, p.wfeat, W, W, W2);
  for (int i = tid; i < W * (L.nh - W2); i += kThreads) {
    const int r = i / (L.nh - W2), c = W2 + i % (L.nh - W2);
    wbuf[r * L.ldw + c] = c == W2 ? p.wsig[r] : Tr::from_f(0.f);
  }
  __syncthreads();
  const float bsig = p.bsig[0];
  gemm_rows(act, L.lda, wbuf, L.ldw, W, L.nh, [&](int r, int c, float v) {
    if (c < W2) {
      const int ray = min(ray0 + r / S, p.n_rays - 1);  // padding rows read a real ray
      const float pre = fmaxf(v + p.bfeat[c] + Tr::to_f(p.dirf[size_t(ray) * W2 + c]), 0.f);
      act[r * L.lda + c] = Tr::from_f(pre);
    } else if (c == W2) {
      samp[r * 4] = v + bsig;
    }
  });
  __syncthreads();

  // --- rgb = sigmoid(pre @ wrgb + brgb): wrgb zero-padded to 16 columns
  for (int i = tid; i < W2 * 16; i += kThreads) {
    const int r = i / 16, c = i % 16;
    wbuf[r * L.ldw + c] = c < 3 ? p.wrgb[r * 3 + c] : Tr::from_f(0.f);
  }
  __syncthreads();
  gemm_rows(act, L.lda, wbuf, L.ldw, W2, 16, [&](int r, int c, float v) {
    if (c < 3) samp[r * 4 + 1 + c] = 1.f / (1.f + expf(-(v + p.brgb[c])));
  });
  __syncthreads();

  // --- composite (f32), a ray a thread, samples in order
  const int ray = ray0 + tid;
  if (tid < L.rays_per_cta && ray < p.n_rays) {
    const float t0 = p.aux[ray * 4], t1 = p.aux[ray * 4 + 1];
    const float hit = p.aux[ray * 4 + 2], normd = p.aux[ray * 4 + 3];
    const float delta = __fmul_rn(__fdiv_rn(__fsub_rn(t1, t0), u_den), normd);
    const float last = __fmul_rn(1e10f, normd);
    float trans = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, acc_w = 0.f, acc_zw = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* sp = samp + (tid * S + s) * 4;
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
    const float disp = 1.f / fmaxf(1e-10f, acc_zw / fmaxf(acc_w, 1e-10f));
    if (p.white_bkgd) {
      const float bg = 1.f - acc_w;
      cr += bg;
      cg += bg;
      cb += bg;
    }
    float* o = p.out + size_t(ray) * 8;
    o[0] = cr;
    o[1] = cg;
    o[2] = cb;
    o[3] = acc_w;
    o[4] = acc_zw;
    o[5] = disp;
    o[6] = 0.f;
    o[7] = 0.f;
  }
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int rows = Traits<T>::kRows;
  if (a.width % 32 != 0 || a.width > kMaxWidth || a.n_samples < 1 || a.n_samples > rows ||
      a.depth < 0 || a.multires < 0 || 3 + 6 * a.multires > kMaxWidth || a.n_rays < 0) {
    return int(cudaErrorInvalidValue);
  }
  if (a.n_rays == 0) return int(cudaSuccess);
  const Layout L = make_layout<T>(a.width, a.multires, a.n_samples);
  cudaError_t e = cudaFuncSetAttribute(serve_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(L.bytes));
  if (e != cudaSuccess) return int(e);
  const int grid = (a.n_rays + L.rays_per_cta - 1) / L.rays_per_cta;
  serve_kernel<T><<<grid, Traits<T>::kThreads, L.bytes, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* rays_o, const void* rays_d, const void* aux, const void* dirf,
                 const void* w0, const void* b0, const void* wl, const void* bl,
                 const void* wsig, const void* bsig, const void* wfeat, const void* bfeat,
                 const void* wrgb, const void* brgb, void* out, int n_rays, int n_samples,
                 int depth, int width, int multires, int white_bkgd, void* stream) {
  Args<T> a;
  a.rays_o = static_cast<const float*>(rays_o);
  a.rays_d = static_cast<const float*>(rays_d);
  a.aux = static_cast<const float*>(aux);
  a.dirf = static_cast<const T*>(dirf);
  a.w0 = static_cast<const T*>(w0);
  a.b0 = static_cast<const float*>(b0);
  a.wl = static_cast<const T*>(wl);
  a.bl = static_cast<const float*>(bl);
  a.wsig = static_cast<const T*>(wsig);
  a.bsig = static_cast<const float*>(bsig);
  a.wfeat = static_cast<const T*>(wfeat);
  a.bfeat = static_cast<const float*>(bfeat);
  a.wrgb = static_cast<const T*>(wrgb);
  a.brgb = static_cast<const float*>(brgb);
  a.out = static_cast<float*>(out);
  a.n_rays = n_rays;
  a.n_samples = n_samples;
  a.depth = depth;
  a.width = width;
  a.multires = multires;
  a.white_bkgd = white_bkgd;
  return launch(a, static_cast<cudaStream_t>(stream));
}

}  // namespace mma_serve
