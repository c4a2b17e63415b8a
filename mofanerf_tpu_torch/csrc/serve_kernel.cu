// Fused bounded-render kernel for the distilled-student serving path.
//
// Replaces the TPU kernel mofanerf_tpu/ops/pallas_serve.py::render_rays_bounded_fused
// (pallas_call at :221, body _serve_kernel at :64, embedding constants _embed_constants
// at :49). Same contract as mofanerf_tpu/render/serve.py::render_rays_bounded for a
// skipless student (skip == -1) with relu density and a folded conditioning code.
//
// What bounds it: compute. At the serving width (D=4, W=128, multires=8, S=32) one sample
// costs ~161 kFLOP (input layer 2*51*128, four 128x128 layers, the sigma|feat head
// 2*128*65, the rgb head 2*64*3): 5.2 MFLOP a ray, 1.35 TFLOP a 512x512 frame, which is
// 1.37 ms at 989 TFLOP/s dense bf16. The bytes are ~200 B a ray (origin, direction,
// interval and view features in, 8 floats out): 15.6 us a frame at 3.35 TB/s.
//
// Two designs, chosen by dtype and shape in serve_render below (ops/serve_kernel.py::uses_wgmma
// states the same rule):
//   serve_kernel_wgmma.cuh  bf16 at W = 128 with 0..5 hidden layers, 3 + 6*multires <= 64 and S
//       dividing 64, or 128 (the serving configuration: D=4, mr=8, S=32):
//       persistent CTAs that copy the pre-tiled weights into shared memory once
//       (cp.async.bulk on an mbarrier), wgmma.mma_async with A from registers, activations
//       kept in registers from layer to layer, the embedding computed in registers, and items
//       whose rays all miss skipped.
//   serve_kernel_mma.cuh    f32 (FFMA) and every other bf16 shape (the first design): a CTA
//       keeps its rows' activations in shared memory and stages each layer's weights, bf16
//       products by ldmatrix + mma.sync. Widths that are multiples of 32 up to 128, 1 to 128
//       (f32) or 256 (bf16) samples a ray.
// Both take any ray count.
//
// The library also holds serve_rays (serve_rays.cuh), which makes the rays and the per-ray
// operands (aux, dirf) that these kernels read, for every pose of a frame or a path at once.
//
// Precision contract (from the TPU kernel, pallas_serve.py:97-134): every product casts
// both operands to the compute dtype and accumulates in f32 -- including the world-space
// points of the input layer; bias adds and ReLU are f32 and each hidden layer's result is
// cast back to the compute dtype; the pre-view activation is f32 and is cast inside the
// rgb product; sigmoid and compositing are f32. The embedding uses the accurate sinf
// (arguments reach ~640 rad, where __sinf is wrong) with cos(x) = sin(x + f32(pi/2)), and
// sample placement and compositing use round-to-nearest intrinsics so that nvcc does not
// contract them into FMAs that the plain PyTorch version does not make.

#include "serve_kernel_mma.cuh"
#include "serve_kernel_wgmma.cuh"
#include "serve_rays.cuh"

namespace {

// The wgmma design takes bf16 at the shapes it is built for (ops/serve_kernel.py::uses_wgmma
// states the same rule).
inline bool uses_wgmma(int dtype, int width, int depth, int multires, int n_samples) {
  return dtype == 1 && wgmma_serve::takes(width, depth, multires, n_samples);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (the compute
// dtype of dirf and of every weight matrix; rays, aux, biases and out are float32). `tiles`
// is the weight image of ops/serve_kernel.py::tile_student_weights, read by the wgmma design
// only (which reads the biases but none of the other weight pointers). Returns the
// cudaError_t of the launch (0 on success). Launches on `stream` and does not synchronise.
extern "C" int serve_render(int dtype, const void* rays_o, const void* rays_d, const void* aux,
                            const void* dirf, const void* w0, const void* b0, const void* wl,
                            const void* bl, const void* wsig, const void* bsig,
                            const void* wfeat, const void* bfeat, const void* wrgb,
                            const void* brgb, const void* tiles, void* out, int n_rays,
                            int n_samples, int depth, int width, int multires, int white_bkgd,
                            void* stream) {
  if (uses_wgmma(dtype, width, depth, multires, n_samples)) {
    if (n_rays < 0 || tiles == nullptr) return int(cudaErrorInvalidValue);
    if (n_rays == 0) return int(cudaSuccess);
    wgmma_serve::Args a;
    a.rays_o = static_cast<const float*>(rays_o);
    a.rays_d = static_cast<const float*>(rays_d);
    a.aux = static_cast<const float*>(aux);
    a.dirf = static_cast<const wgmma_serve::bf16*>(dirf);
    a.tiles = static_cast<const unsigned char*>(tiles);
    a.b0 = static_cast<const float*>(b0);
    a.bl = static_cast<const float*>(bl);
    a.bsig = static_cast<const float*>(bsig);
    a.bfeat = static_cast<const float*>(bfeat);
    a.brgb = static_cast<const float*>(brgb);
    a.out = static_cast<float*>(out);
    a.n_rays = n_rays;
    a.n_samples = n_samples;
    a.depth = depth;
    a.multires = multires;
    a.white_bkgd = white_bkgd;
    a.n_items = 0;
    return wgmma_serve::launch(a, static_cast<cudaStream_t>(stream));
  }
  if (dtype == 0) {
    return mma_serve::launch_typed<float>(rays_o, rays_d, aux, dirf, w0, b0, wl, bl, wsig, bsig,
                                          wfeat, bfeat, wrgb, brgb, out, n_rays, n_samples, depth,
                                          width, multires, white_bkgd, stream);
  }
  if (dtype == 1) {
    return mma_serve::launch_typed<mma_serve::bf16>(rays_o, rays_d, aux, dirf, w0, b0, wl, bl,
                                                    wsig, bsig, wfeat, bfeat, wrgb, brgb, out,
                                                    n_rays, n_samples, depth, width, multires,
                                                    white_bkgd, stream);
  }
  return int(cudaErrorInvalidValue);
}

// 1 if serve_render runs the wgmma design for this dtype and shape, else 0.
extern "C" int serve_uses_wgmma(int dtype, int width, int depth, int multires, int n_samples) {
  return uses_wgmma(dtype, width, depth, multires, n_samples) ? 1 : 0;
}

// Items the wgmma design skipped on the current device since the last reset, into *count;
// reset != 0 then sets the count to 0. Synchronises with the default stream. Returns the
// cudaError_t.
extern "C" int serve_items_skipped(unsigned long long* count, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(count, wgmma_serve::g_items_skipped, sizeof(*count));
  if (e != cudaSuccess || !reset) return int(e);
  const unsigned long long zero = 0;
  return int(cudaMemcpyToSymbol(wgmma_serve::g_items_skipped, &zero, sizeof(zero)));
}

// The serving path's rays and B2's per-ray operands (serve_rays.cuh states the contract). dtype:
// 0 = float32, 1 = bfloat16, the type of dirf; every other array is float32 (n_hit int32).
// Zeroes n_hit, launches on `stream` and does not synchronise. Returns the cudaError_t.
extern "C" int serve_rays(int dtype, const void* K, const void* poses, long long pose_stride,
                          const void* lo, const void* hi, const void* w_dirs, void* rays_o,
                          void* rays_d, void* aux, void* dirf, void* n_hit, long long n,
                          long long n_rows, int H, int W, int multires_views, int w2, float near,
                          float far, void* stream) {
  const int per_chunk = dtype == 1 ? 8 : 4;  // dirf columns a 16-byte store
  const long long hw = (long long)H * W;
  if ((dtype != 0 && dtype != 1) || multires_views < 0 || w2 <= 0 || w2 % per_chunk != 0 ||
      H < 0 || W < 0 || n < 0 || n_rows < n || (hw ? n % hw != 0 : n != 0))
    return int(cudaErrorInvalidValue);
  ray_ops::Args a;
  a.K = static_cast<const float*>(K);
  a.poses = static_cast<const float*>(poses);
  a.lo = static_cast<const float*>(lo);
  a.hi = static_cast<const float*>(hi);
  a.w_dirs = static_cast<const float*>(w_dirs);
  a.rays_o = static_cast<float*>(rays_o);
  a.rays_d = static_cast<float*>(rays_d);
  a.aux = static_cast<float*>(aux);
  a.dirf = dirf;
  a.n_hit = static_cast<int*>(n_hit);
  a.pose_stride = pose_stride;
  a.n = n;
  a.n_rows = n_rows;
  a.H = H;
  a.W = W;
  a.multires_views = multires_views;
  a.w2 = w2;
  a.near_ = near;
  a.far_ = far;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? ray_ops::launch<ray_ops::bf16>(a, s) : ray_ops::launch<float>(a, s);
}
