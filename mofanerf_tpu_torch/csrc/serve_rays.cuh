// The serving path's rays and kernel B2's per-ray operands, made in one pass over every ray of a
// frame or a path (ops/serve_rays.py::serve_rays; serve_kernel.cu holds the C entry point, so
// that the serving path builds one library).
//
// Replaces no TPU kernel. It replaces the chain of small operations that makes the same tensors
// (mofanerf_tpu/ops/rays.py::get_rays, ops/bounds.py::ray_aabb_interval, the view embedding and
// its product with w_dirs in the wrapper of ops/pallas_serve.py), which XLA fused into one
// program under jit. Run eagerly, the port's plain version of that chain
// (ops/serve_rays.py::serve_rays_ref) is dozens of launches of microsecond kernels, each
// dispatched by the host before the frame's first packet can start.
//
// Contract. For F camera-to-world poses, H x W pixels and the intrinsics K, row g < n = F*H*W is
// pixel (j, i) = divmod(g mod H*W, W) of pose g / (H*W), in get_rays's row-major order; rows
// n .. n_rows-1 are the sweep's padding ray, o = d = (1, 1, 1). Each row gets rays_o and rays_d
// [3] f32; aux [4] f32 = (t0, t1, hit, |d|) as ray_aabb_interval and ray_operands define them
// (a miss has t0 = t1 = near); dirf [w2] in the compute dtype = fourier_embed(d / |d|,
// multires_views) @ w_dirs, summed in f32 and rounded once. n_hit gains the hit rows below n.
//
// What bounds it: bytes written. A ray writes 168 bytes with bf16 view features (origin and
// direction 24, aux 16, dirf 128): a 512 x 512 frame writes 44 MB, 13 us at 3.35 TB/s. Its
// arithmetic (24 sinf/cosf and 27 x 64 FMAs a ray, 0.9 GFLOP a frame) would take as long at the
// card's 67 TFLOP/s of f32 FMA, so the design keeps the FMAs' operands in shared memory, reads
// them there without bank conflicts, and makes every store wide. A block takes 256 rays. First
// one thread a ray: the pixel's direction, the slab test, |d| and the view embedding, which goes
// to shared memory; aux is one 16-byte store a thread, neighbours adjacent; origins and
// directions (12 bytes a ray) are staged in shared memory and stored as 16-byte vectors. Then the
// view features: a warp sums one 16-byte chunk of the row (8 bf16 or 4 f32 columns) for 128 rays,
// its chunk of w_dirs (which every block copies to shared memory first) read once a k for four
// rays a lane. The chunks go to a tile of the block's rows in shared memory, and from there out
// 16 bytes a thread, neighbouring threads on neighbouring chunks. (One thread a chunk, reading
// its own chunk of w_dirs, was 9x slower: 0.133 ms a 512 x 512 frame, bound by the reads of
// shared memory.)
//
// Precision: the plain version's. Divisions, the reciprocal and sqrtf round to nearest (no fast
// math); sinf and cosf are the accurate library functions that torch.sin and torch.cos call on
// the card; the slab test's differences and products round one by one, as PyTorch's elementwise
// kernels do; |d| sums its squares in the order of PyTorch's norm on the card. The pose's
// rotation (3 terms) and the view features (27 terms) sum in k order with FMAs, as cuBLAS's f32
// products of these shapes did on an H100 for frames of 64 x 64 and more (small ones take
// another of its kernels): there the outputs are the plain chain's bits on the card
// (tests/test_torch_serve_kernel.py holds them to the plain version within a stated rounding).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ray_ops {

using bf16 = __nv_bfloat16;

constexpr int kRays = 256;  // rays a block, one a thread in the first phase

struct Args {
  const float* K;          // [3, 3]
  const float* poses;      // pose f: [3, 4] rows of 4 floats at poses + f * pose_stride
  const float* lo;         // [3] the box
  const float* hi;         // [3]
  const float* w_dirs;     // [3 + 6 * multires_views, w2] f32
  float* rays_o;           // [n_rows, 3]
  float* rays_d;           // [n_rows, 3]
  float* aux;              // [n_rows, 4]
  void* dirf;              // [n_rows, w2] in the compute dtype
  int* n_hit;              // [1]: the hit rows below n are added to it
  long long pose_stride;   // floats from one pose to the next
  long long n;             // F * H * W
  long long n_rows;        // n and the padding rows after them
  int H, W;
  int multires_views;
  int w2;
  float near_, far_;
};

constexpr int kLaneRays = 4;  // rays a lane sums the view features of, 32 apart

// w_dirs | the embedding | staged origins and directions | the block's dirf rows
template <typename T>
size_t smem_bytes(int multires_views, int w2) {
  const int embed = 3 + 6 * multires_views;
  return (size_t(embed) * (w2 + kRays) + 2 * 3 * kRays) * sizeof(float) +
         size_t(kRays) * w2 * sizeof(T);
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

template <typename T>
__global__ void __launch_bounds__(kRays) make_rays(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int embed = 3 + 6 * a.multires_views;
  float* w = smem;                        // [embed][w2]
  float* emb = w + embed * a.w2;          // [embed][kRays]
  float* stage_o = emb + embed * kRays;   // [kRays * 3]
  float* stage_d = stage_o + 3 * kRays;   // [kRays * 3]

  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRays;
  const long long left = a.n_rows - r0;
  const int nr = left < kRays ? int(left) : kRays;

  for (int q = t; q < embed * a.w2 / 4; q += kRays)
    reinterpret_cast<float4*>(w)[q] = reinterpret_cast<const float4*>(a.w_dirs)[q];

  const long long r = r0 + t;
  bool hit = false;
  if (t < nr) {
    float o[3], d[3];
    if (r < a.n) {
      const long long hw = (long long)a.H * a.W;
      const long long f = r / hw;
      const int pix = int(r - f * hw);
      const int j = pix / a.W, i = pix - j * a.W;
      const float* P = a.poses + f * a.pose_stride;
      // get_rays: dirs = ((i - cx) / fx, -(j - cy) / fy, -1), rotated by the pose
      const float x = __fdiv_rn(__fsub_rn(float(i), a.K[2]), a.K[0]);
      const float y = -__fdiv_rn(__fsub_rn(float(j), a.K[5]), a.K[4]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d[c] = __fsub_rn(fmaf(y, P[4 * c + 1], __fmul_rn(x, P[4 * c])), P[4 * c + 2]);
        o[c] = P[4 * c + 3];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c] = d[c] = 1.f;
    }

    // ray_aabb_interval: the slab test clipped to [near, far]
    float t_in = 0.f, t_out = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float inv = __frcp_rn(fabsf(d[c]) < 1e-9f ? 1e-9f : d[c]);
      const float ta = __fmul_rn(__fsub_rn(a.lo[c], o[c]), inv);
      const float tb = __fmul_rn(__fsub_rn(a.hi[c], o[c]), inv);
      t_in = c ? fmaxf(t_in, fminf(ta, tb)) : fminf(ta, tb);
      t_out = c ? fminf(t_out, fmaxf(ta, tb)) : fmaxf(ta, tb);
    }
    float t0 = fmaxf(t_in, a.near_), t1 = fminf(t_out, a.far_);
    hit = t1 > t0;
    if (!hit) t0 = t1 = a.near_;
    // |d| as torch.linalg.norm sums a row of 3 on the card: (x^2 + z^2) + y^2, each rounded
    const float nd = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[2], d[2])),
                                     __fmul_rn(d[1], d[1])));
    reinterpret_cast<float4*>(a.aux)[r] = make_float4(t0, t1, hit ? 1.f : 0.f, nd);

#pragma unroll
    for (int c = 0; c < 3; ++c) {
      stage_o[3 * t + c] = o[c];
      stage_d[3 * t + c] = d[c];
    }
    // fourier_embed(d / |d|): the direction, then per band 2^k its sines and its cosines
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = __fdiv_rn(d[c], nd);
      emb[c * kRays + t] = v[c];
    }
    float band = 1.f;
    for (int k = 0; k < a.multires_views; ++k, band *= 2.f) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float xb = __fmul_rn(v[c], band);
        emb[(3 + 6 * k + c) * kRays + t] = sinf(xb);
        emb[(6 + 6 * k + c) * kRays + t] = cosf(xb);
      }
    }
  }
  const int hits = __syncthreads_count(hit && r < a.n);
  if (t == 0 && hits) atomicAdd(a.n_hit, hits);

  // origins and directions: the block's 3 * nr floats, 16 bytes a thread (r0 * 12 bytes is a
  // multiple of 16), then the last few one by one
  const int nf = 3 * nr, nv = nf / 4;
  float4* go = reinterpret_cast<float4*>(a.rays_o + 3 * r0);
  float4* gd = reinterpret_cast<float4*>(a.rays_d + 3 * r0);
  for (int q = t; q < nv; q += kRays) {
    go[q] = reinterpret_cast<const float4*>(stage_o)[q];
    gd[q] = reinterpret_cast<const float4*>(stage_d)[q];
  }
  for (int q = 4 * nv + t; q < nf; q += kRays) {
    a.rays_o[3 * r0 + q] = stage_o[q];
    a.rays_d[3 * r0 + q] = stage_d[q];
  }

  // the view features. A warp takes a 16-byte chunk of the row (V columns) for 32 * kLaneRays
  // rays, a lane kLaneRays of them: the chunk of w_dirs is the same for every lane (one broadcast
  // read of shared memory a k), the embedding of neighbouring lanes' rays adjacent. The sums go
  // to the block's tile of rows, chunk c of row r at chunk (c + r) mod chunks, so that the lanes'
  // 16-byte writes of one chunk of neighbouring rows, and the reads of a row's chunks below, fall
  // on distinct banks.
  constexpr int V = 16 / sizeof(T);
  const int chunks = a.w2 / V;
  const int warp = t / 32, lane = t % 32;
  T* tile = reinterpret_cast<T*>(stage_d + 3 * kRays);  // [kRays][w2]
  for (int item = warp; item < chunks * (kRays / (32 * kLaneRays)); item += kRays / 32) {
    const int c = item % chunks, ray0 = item / chunks * 32 * kLaneRays + lane;
    float acc[kLaneRays][V];
#pragma unroll
    for (int m = 0; m < kLaneRays; ++m)
#pragma unroll
      for (int u = 0; u < V; ++u) acc[m][u] = 0.f;
    for (int k = 0; k < embed; ++k) {
      float wv[V];
#pragma unroll
      for (int u4 = 0; u4 < V / 4; ++u4) {
        const float4 x = reinterpret_cast<const float4*>(w + k * a.w2 + c * V)[u4];
        wv[4 * u4] = x.x, wv[4 * u4 + 1] = x.y, wv[4 * u4 + 2] = x.z, wv[4 * u4 + 3] = x.w;
      }
#pragma unroll
      for (int m = 0; m < kLaneRays; ++m) {
        const float e = emb[k * kRays + ray0 + 32 * m];
#pragma unroll
        for (int u = 0; u < V; ++u) acc[m][u] = fmaf(e, wv[u], acc[m][u]);
      }
    }
#pragma unroll
    for (int m = 0; m < kLaneRays; ++m) {
      const int ray = ray0 + 32 * m;
      store16(tile + ray * a.w2 + (c + ray) % chunks * V, acc[m]);
    }
  }
  __syncthreads();
  // the block's rows out, 16 bytes a thread, neighbouring threads on neighbouring chunks
  T* out = static_cast<T*>(a.dirf) + r0 * a.w2;
  for (int q = t; q < nr * chunks; q += kRays) {
    const int ray = q / chunks, c = q - ray * chunks;
    *reinterpret_cast<uint4*>(out + (long long)q * V) =
        *reinterpret_cast<const uint4*>(tile + ray * a.w2 + (c + ray) % chunks * V);
  }
}

// Zeroes n_hit and launches one block a 256 rows on `stream`. Returns the cudaError_t.
template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(a.n_hit, 0, sizeof(int), stream);
  if (e != cudaSuccess || a.n_rows == 0) return int(e);
  const size_t smem = smem_bytes<T>(a.multires_views, a.w2);
  e = cudaFuncSetAttribute(make_rays<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const long long blocks = (a.n_rows + kRays - 1) / kRays;
  make_rays<T><<<unsigned(blocks), kRays, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace ray_ops
