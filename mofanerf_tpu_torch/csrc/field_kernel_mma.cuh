// The mma.sync design of the fused conditioned-field kernel: bf16 (ldmatrix + mma.sync
// m16n8k16) at the widths the wgmma design does not cover (f32 runs the 3xTF32 design).
// field_kernel.cu holds the contract, the dispatch and the C entry points; this file is
// included by it alone.
//
// Design: 16 warps a CTA, each owning a [32 rows, 64 columns] tile of every layer's output
// (W/64 warps across, the rest down: 1 x 16 at W = 1024, 4 x 4 at W = 256). A CTA keeps two
// [rows, W] activations in shared memory through all layers (the running one, and the saved
// xyz_code / sigma_feat that the skip pair reads), which with a 3-deep ring of weight chunks
// caps it at 128 rows at W = 256 and 32 rows at W = 1024. All weights of the kernel form one
// stream of [16, W] chunks (w_pts, the stack, w_view) that every thread helps copy with
// cp.async into the ring, crossing layer boundaries without draining. The products run on the
// tensor cores (f32 accumulators, A through ldmatrix, the [in, out] weights as B through
// ldmatrix.trans). A layer's output overwrites its input after a barrier. The skip pair
// accumulates both halves in the same registers. Raw sigma and rgb are short dot products done
// by a warp a row. Rows past n_rows are computed on zeros and not
// written, so any N is accepted; a row's ray is row / samples.
//
// What holds this design (utils/field_variants.py, one H100 SXM at 700 W, bf16 at the packet
// shapes of the teacher render): starting the copies and drawing the stream cost more than
// half of a launch at W = 1024 and over a third at W = 256 (2048 cp.async a chunk, an integer
// division each, for every 16 rows of K), the block-wide barrier a chunk about a tenth, and
// ldmatrix + mma.sync alone run at 2.4 (W = 1024) to 3.5 (W = 256) times the tensor cores'
// time. Whether the stack fits in L2 makes no difference.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mma_field {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;          // row padding in elements: 16-byte rows, spread banks
constexpr int kWarpCols = 64;    // output columns a warp owns
constexpr int kStages = 3;       // weight chunks in flight
constexpr int kMaxWarps = 16;
constexpr int kMaxWidth = 1024;
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a CTA can ask for on sm_90

template <typename T>
struct Traits;

template <>
struct Traits<bf16> {
  static constexpr int kWarpRows = 32;  // two m16 strips
  static constexpr int kChunk = 16;     // one mma depth
  static constexpr int kTiles = 16;     // 2 strips x 8 n8 tiles
  __device__ static float to_f(bf16 x) { return __bfloat162float(x); }
  __device__ static bf16 from_f(float x) { return __float2bfloat16_rn(x); }
};

template <typename T>
struct Args {
  const float* x;        // [N, pe] embedded points
  const float* dirf;     // [R, W/2] per-ray view features, N = R * samples
  const T* w_pts;        // [k0, W], k0 = pe rounded up to 16, padding rows zero
  const float* b_pts;    // [W]
  const T* w_stack;      // [L, W, W]
  const float* b_stack;  // [L, W]
  const T* w_view;       // [W, W/2]
  const float* b_view;   // [W/2]
  const T* w_out;        // [W + W/2, 4]: rows :W col 3 alpha, rows W: cols 0..2 rgb
  const float* b_out;    // [4]
  float* out;            // [N, 4]: raw rgb, raw sigma
  int n_rows, samples, pe, width, depth, skip, xyz_depth;
  int warps_m;           // warp rows of the CTA, chosen by the host
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory plan, computed the same way on the host (launch size) and in the kernel.
struct Layout {
  int warps_n, warps_m;
  int rows;         // point rows of the CTA
  int ld;           // row stride of activations and staged weights (elements)
  int k0;           // input-layer fan-in, padded
  int stage_elems;  // elements of one staged weight chunk
  size_t off_saved, off_stage, off_sigma, bytes;
};

template <typename T>
__host__ __device__ inline Layout make_layout(int width, int pe, int warps_m) {
  Layout L;
  L.warps_n = width / kWarpCols;
  L.warps_m = warps_m;
  L.rows = warps_m * Traits<T>::kWarpRows;
  L.ld = width + kPad;
  L.k0 = round_up(pe, 16);
  L.stage_elems = Traits<T>::kChunk * L.ld;
  L.off_saved = align128(size_t(L.rows) * L.ld * sizeof(T));
  L.off_stage = L.off_saved + align128(size_t(L.rows) * L.ld * sizeof(T));
  L.off_sigma = L.off_stage + align128(size_t(kStages) * L.stage_elems * sizeof(T));
  L.bytes = L.off_sigma + size_t(L.rows) * sizeof(float);
  return L;
}

// The most warp rows (<= 16 warps in all) whose plan fits in shared memory; 0 if none.
template <typename T>
inline int pick_warps_m(int width, int pe) {
  if (width % kWarpCols != 0 || width < kWarpCols || width > kMaxWidth) return 0;
  if (pe < 1 || round_up(pe, 16) > width) return 0;
  int wm = kMaxWarps / (width / kWarpCols);
  while (wm > 0 && make_layout<T>(width, pe, wm).bytes > kSmemLimit) --wm;
  return wm;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(dst)), "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

// acc += a[0:rows, 0:kChunk] @ w[0:kChunk, 0:64] for the warp's tile. `a` points at the
// tile's first row and the chunk's first k column of an activation (row stride ld); `w` at
// the chunk's first row and the tile's first column of a staged chunk (row stride ld).
// Only the first `ncols` columns of the tile exist (a multiple of 16).
//
// bf16: acc[strip * 8 + j] is the m16n8 accumulator of row strip `strip`, n8 tile j.
__device__ __forceinline__ void warp_mma_chunk(float (&acc)[16][4], const bf16* a, const bf16* w,
                                               int ld, int ncols, int lane) {
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;  // ldmatrix row address of this lane
  uint32_t a0[4], a1[4];
  ldmatrix_x4(a0, a + lrow * ld + lcol);
  ldmatrix_x4(a1, a + (16 + lrow) * ld + lcol);
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    if (jp * 16 < ncols) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, w + lrow * ld + jp * 16 + lcol);
      mma_bf16(acc[2 * jp], a0, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a0, b[2], b[3]);
      mma_bf16(acc[8 + 2 * jp], a1, b[0], b[1]);
      mma_bf16(acc[8 + 2 * jp + 1], a1, b[2], b[3]);
    }
  }
}

// Hand every accumulator of the warp's tile to epi(row, column, value), rows and columns
// relative to the tile, columns below ncols only.
template <class Epi>
__device__ __forceinline__ void warp_epilogue(const float (&acc)[16][4], int ncols, int lane,
                                              Epi epi) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int strip = 0; strip < 2; ++strip) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;
      if (c < ncols) {
        const float(&d)[4] = acc[strip * 8 + j];
        epi(strip * 16 + g, c, d[0]);
        epi(strip * 16 + g, c + 1, d[1]);
        epi(strip * 16 + g + 8, c, d[2]);
        epi(strip * 16 + g + 8, c + 1, d[3]);
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32) field_kernel(Args<T> p) {
  using Tr = Traits<T>;
  constexpr int KC = Tr::kChunk;
  constexpr int kVec = 16 / int(sizeof(T));  // elements a 16-byte copy moves
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T>(p.width, p.pe, p.warps_m);
  T* h = reinterpret_cast<T*>(smem);                        // [rows, ld] running activation
  T* saved = reinterpret_cast<T*>(smem + L.off_saved);      // [rows, ld] xyz_code, sigma_feat
  T* stage = reinterpret_cast<T*>(smem + L.off_stage);      // [kStages][KC, ld] weight ring
  float* sig = reinterpret_cast<float*>(smem + L.off_sigma);  // [rows] raw sigma

  const int W = p.width, W2 = W / 2, ld = L.ld;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthreads / 32;
  const int row0 = (warp / L.warps_n) * Tr::kWarpRows;  // the warp's tile
  const int col0 = (warp % L.warps_n) * kWarpCols;
  const long long grow0 = static_cast<long long>(blockIdx.x) * L.rows;
  const int trunk_len = p.depth + 1;
  const int n_stack = p.xyz_depth + 2 * trunk_len;

  // --- the weight stream: chunk i of [w_pts | w_stack | w_view], KC rows each
  const int c_pts = L.k0 / KC, c_stack = n_stack * (W / KC), c_view = W / KC;
  const int c_total = c_pts + c_stack + c_view;
  auto fetch = [&](int i) {
    if (i < c_total) {
      const T* src;
      int ncols = W;
      if (i < c_pts) {
        src = p.w_pts + size_t(i) * KC * W;
      } else if (i < c_pts + c_stack) {
        src = p.w_stack + size_t(i - c_pts) * KC * W;
      } else {
        src = p.w_view + size_t(i - c_pts - c_stack) * KC * W2;
        ncols = W2;
      }
      T* dst = stage + (i % kStages) * L.stage_elems;
      const int vecs = ncols / kVec;
      for (int v = tid; v < KC * vecs; v += nthreads) {
        const int r = v / vecs, c = (v - r * vecs) * kVec;
        cp_async16(dst + r * ld + c, src + size_t(r) * ncols + c);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait count uniform
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  // --- the embedded points of the CTA's rows, rounded, fan-in zero-padded to k0
  for (int i = tid; i < L.rows * L.k0; i += nthreads) {
    const int r = i / L.k0, c = i - r * L.k0;
    const long long gr = grow0 + r;
    float v = 0.f;
    if (c < p.pe && gr < p.n_rows) v = p.x[size_t(gr) * p.pe + c];
    h[r * ld + c] = Tr::from_f(v);
  }

  float acc[Tr::kTiles][4];
  auto clear = [&]() {
#pragma unroll
    for (int j = 0; j < Tr::kTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  };
  clear();

  // acc += a[:, 0:kdim] @ (the next kdim / KC chunks of the stream)[:, 0:ncols]
  int ci = 0;
  auto gemm = [&](const T* a, int kdim, int ncols) {
    for (int k = 0; k < kdim; k += KC, ++ci) {
      cp_async_wait<kStages - 2>();  // this thread's part of chunk ci has landed
      __syncthreads();               // ... everyone's has, and chunk ci-1 is no longer read
      fetch(ci + kStages - 1);       // into the slot chunk ci-1 held
      if (col0 < ncols) {
        warp_mma_chunk(acc, a + row0 * ld + k, stage + (ci % kStages) * L.stage_elems + col0,
                       ld, ncols - col0, lane);
      }
    }
  };

  // h = round(relu(acc + bias)) in place (and into `saved` when asked), acc = 0
  auto dense_epilogue = [&](const float* bias, bool save) {
    __syncthreads();  // every warp has read its last input of this layer
    warp_epilogue(acc, W - col0, lane, [&](int r, int c, float v) {
      const int col = col0 + c, at = (row0 + r) * ld + col;
      const T y = Tr::from_f(fmaxf(v + bias[col], 0.f));
      h[at] = y;
      if (save) saved[at] = y;
    });
    clear();
    __syncthreads();
  };

  // --- xyz encoder
  gemm(h, L.k0, W);
  dense_epilogue(p.b_pts, p.xyz_depth == 0);
  int li = 0;
  for (; li < p.xyz_depth; ++li) {
    gemm(h, W, W);
    dense_epilogue(p.b_stack + size_t(li) * W, li == p.xyz_depth - 1);
  }

  // --- sigma trunk on xyz_code, then rgb trunk on sigma_feat. Layer t of a trunk: 0 is L0,
  // 1..skip the mid layers, skip+1 and skip+2 the skip pair (saved @ W, then h @ W' + b,
  // summed unrounded in the accumulators), the rest the post layers.
  for (int trunk = 0; trunk < 2; ++trunk) {
    for (int t = 0; t < trunk_len; ++t, ++li) {
      const bool pair_first = t == p.skip + 1;
      gemm(pair_first ? saved : h, W, W);
      if (!pair_first) {
        dense_epilogue(p.b_stack + size_t(li) * W, trunk == 0 && t == trunk_len - 1);
      }
    }
    if (trunk == 0) {
      // raw sigma = sigma_feat @ w_alpha + b_alpha, a row a warp
      const float b_alpha = p.b_out[3];
      for (int r = warp; r < L.rows; r += nwarps) {
        float s = 0.f;
        for (int c = lane; c < W; c += 32) {
          s = fmaf(Tr::to_f(h[r * ld + c]), Tr::to_f(p.w_out[size_t(c) * 4 + 3]), s);
        }
        s = warp_sum(s);
        if (lane == 0) sig[r] = s + b_alpha;
      }
    }
  }

  // --- view layer: relu(rgb_feat @ w_view + b_view + dir_feat[ray]) into h[:, 0:W/2]
  gemm(h, W, W2);
  __syncthreads();
  if (col0 < W2) {
    warp_epilogue(acc, W2 - col0, lane, [&](int r, int c, float v) {
      const int col = col0 + c;
      long long gr = grow0 + row0 + r;
      if (gr >= p.n_rows) gr = p.n_rows - 1;  // padding rows read a real ray
      const float pre = v + p.b_view[col] + p.dirf[size_t(gr / p.samples) * W2 + col];
      h[(row0 + r) * ld + col] = Tr::from_f(fmaxf(pre, 0.f));
    });
  }
  cp_async_wait<0>();
  __syncthreads();

  // --- raw rgb = view @ w_rgb + b_rgb, a row a warp; write [rgb, sigma]
  const T* w_rgb = p.w_out + size_t(W) * 4;
  for (int r = warp; r < L.rows; r += nwarps) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < W2; c += 32) {
      const float a = Tr::to_f(h[r * ld + c]);
      s0 = fmaf(a, Tr::to_f(w_rgb[size_t(c) * 4]), s0);
      s1 = fmaf(a, Tr::to_f(w_rgb[size_t(c) * 4 + 1]), s1);
      s2 = fmaf(a, Tr::to_f(w_rgb[size_t(c) * 4 + 2]), s2);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const long long gr = grow0 + r;
    if (lane == 0 && gr < p.n_rows) {
      reinterpret_cast<float4*>(p.out)[gr] =
          make_float4(s0 + p.b_out[0], s1 + p.b_out[1], s2 + p.b_out[2], sig[r]);
    }
  }
}

template <typename T>
int launch(Args<T> a, cudaStream_t stream) {
  if (a.n_rows < 0 || a.samples < 1 || a.skip < 0 || a.depth < a.skip + 2 || a.xyz_depth < 0) {
    return int(cudaErrorInvalidValue);
  }
  a.warps_m = pick_warps_m<T>(a.width, a.pe);
  if (a.warps_m == 0) return int(cudaErrorInvalidValue);
  if (a.n_rows == 0) return int(cudaSuccess);
  const Layout L = make_layout<T>(a.width, a.pe, a.warps_m);
  cudaError_t e = cudaFuncSetAttribute(field_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(L.bytes));
  if (e != cudaSuccess) return int(e);
  const int grid = (a.n_rows + L.rows - 1) / L.rows;
  field_kernel<T><<<grid, L.warps_n * L.warps_m * 32, L.bytes, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* x, const void* dirf, const void* w_pts, const void* b_pts,
                 const void* w_stack, const void* b_stack, const void* w_view,
                 const void* b_view, const void* w_out, const void* b_out, void* out,
                 int n_rows, int samples, int pe, int width, int depth, int skip, int xyz_depth,
                 void* stream) {
  Args<T> a;
  a.x = static_cast<const float*>(x);
  a.dirf = static_cast<const float*>(dirf);
  a.w_pts = static_cast<const T*>(w_pts);
  a.b_pts = static_cast<const float*>(b_pts);
  a.w_stack = static_cast<const T*>(w_stack);
  a.b_stack = static_cast<const float*>(b_stack);
  a.w_view = static_cast<const T*>(w_view);
  a.b_view = static_cast<const float*>(b_view);
  a.w_out = static_cast<const T*>(w_out);
  a.b_out = static_cast<const float*>(b_out);
  a.out = static_cast<float*>(out);
  a.n_rows = n_rows;
  a.samples = samples;
  a.pe = pe;
  a.width = width;
  a.depth = depth;
  a.skip = skip;
  a.xyz_depth = xyz_depth;
  a.warps_m = 0;
  return launch(a, static_cast<cudaStream_t>(stream));
}

}  // namespace mma_field
