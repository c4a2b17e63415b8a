// Fused conditioned-field kernel for the teacher two-pass render.
//
// Replaces the TPU kernel mofanerf_tpu/ops/pallas_field.py::fused_field_apply (pallas_call
// at :238, body _field_kernel at :123, operands pack_fused_params at :71). Same contract as
// mofanerf_tpu/models/field.py::apply_field_folded: embedded points [N, pe] and per-ray view
// features [R, W/2] in, raw rgb and raw sigma [N, 4] out, with the conditioning codes
// already folded into the biases. Inference only.
//
// The work: one point costs 2*(pe*W + L*W*W + W*W/2 + W + 3*W/2) FLOP, L = xyz_depth +
// 2*(depth+1) hidden layers: 53.6 MFLOP at the fine field (depth 10, W 1024, L 25) and
// 2.85 MFLOP at the coarse one (depth 8, W 256, L 21). A packet of 8192 rays is 56 TFLOP
// fine (128 samples) and 1.5 TFLOP coarse (64 samples): 57 ms and 1.5 ms at 989 TFLOP/s
// dense bf16 (in f32, three TF32 products a product at 495 TFLOP/s: 341 ms and 9.1 ms). Its
// own bytes are small (252 B in, 16 B out a point, the weights once), so operations bound it.
//
// What bounds a fused bf16 design on this card is how it feeds the tensor cores. A CTA keeps the
// activations of its rows in shared memory through all L+2 layers, so device memory sees
// only points in and 4 floats out; but it must then stream every layer's weights once a
// row block (the fine stack is 52 MB), and the rows that share one read of the stack set
// that stream: 33 FLOP a weight byte at 32 rows, far under the card's ~295. Timing variants
// (utils/field_variants.py, one H100 SXM at 700 W, the fine field) showed where the mma.sync
// design's time went: more than half in starting cp.async copies and drawing that stream, a
// tenth in the block-wide barrier every 16 rows of K, and the rest in ldmatrix + mma.sync,
// which alone ran at 2.4 times the tensor cores' time; an L2-resident stack changed nothing.
// The wgmma design answers each: copies that cost no thread an instruction, no block-wide
// barrier in a k loop, wgmma on 64-row tiles, and twice the rows a weight read at W = 1024.
// The same variants read its tensor-core side at 1.5 times the bound and its waits for the
// stream, through a ring of three stages, at about an eighth of a launch.
//
// Three designs, chosen by dtype and width in field_apply below:
//   field_kernel_tf32.cuh   f32 at every width: one launch a layer over chunks of rows whose
//       activations live in device memory, each product three TF32 wgmma products (high and
//       low parts, f32 sums), A split from registers, weights pre-split and pre-tiled.
//   field_kernel_wgmma.cuh  bf16 at W = 256 and W = 1024 (the teacher's two fields):
//       persistent warp-specialised CTAs, wgmma.mma_async on 64-row tiles, a ring of
//       pre-tiled 32 KB weight tiles filled by bulk copies that complete on mbarriers, no
//       block-wide barrier in a k loop, 128 (W = 256) or 64 (W = 1024) rows a CTA.
//   field_kernel_mma.cuh    bf16 at the other multiples of 64: cp.async ring, ldmatrix +
//       mma.sync.
// The wrapper (ops/field_kernel.py) pads any field to a width that is a multiple of 64 and a
// depth of at least skip + 2 with zeros before it gets here.
//
// Precision contract (pallas_field.py:148-204), the same for all: every product rounds both
// operands to the compute type and accumulates in f32 (in f32, three TF32 products stand for
// one); bias add and ReLU are f32; each layer's output is rounded to the compute type; the
// skip pair's first half is not rounded before the sum; pre + dir_feat is f32, then ReLU, then
// rounded; the output head is f32.

#include "field_kernel_mma.cuh"
#include "field_kernel_tf32.cuh"
#include "field_kernel_wgmma.cuh"

namespace {

// The wgmma design takes bf16 at the two widths it is built for, with an embedding that fits
// one 64-deep weight tile (ops/field_kernel.py::uses_wgmma states the same rule).
inline bool uses_wgmma(int dtype, int width, int pe) {
  return dtype == 1 && (width == 256 || width == 1024) && pe >= 1 && pe <= wgmma_field::kTileK;
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (the compute
// dtype of every weight matrix; points, view features, biases and out are float32).

// Launches on `stream`, does not synchronise, and returns the first launch's cudaError_t that
// is not 0 (0 on success). Every pointer must be 16-byte aligned. `tiles` is the design's weight
// stream (ops/field_kernel.py::tile_weights). `scratch` is f32: max_ctas * block rows * width
// for the wgmma design, which launches at most max_ctas CTAs; chunk_rows * (pe padded to 32 +
// 3 width) for the 3xTF32 design, which runs chunk_rows rows at a time (a multiple of 256).
// The mma.sync design reads neither.
extern "C" int field_apply(int dtype, const void* x, const void* dirf, const void* w_pts,
                           const void* b_pts, const void* w_stack, const void* b_stack,
                           const void* w_view, const void* b_view, const void* w_out,
                           const void* b_out, const void* tiles, void* scratch, void* out,
                           int n_rows, int samples, int pe, int width, int depth, int skip,
                           int xyz_depth, int max_ctas, int chunk_rows, void* stream) {
  if (dtype == 0) {
    tf32_field::Args a;
    a.x = static_cast<const float*>(x);
    a.dirf = static_cast<const float*>(dirf);
    a.tiles = static_cast<const float*>(tiles);
    a.b_pts = static_cast<const float*>(b_pts);
    a.b_stack = static_cast<const float*>(b_stack);
    a.b_view = static_cast<const float*>(b_view);
    a.w_out = static_cast<const float*>(w_out);
    a.b_out = static_cast<const float*>(b_out);
    a.out = static_cast<float*>(out);
    a.scratch = static_cast<float*>(scratch);
    a.n_rows = n_rows;
    a.samples = samples;
    a.pe = pe;
    a.width = width;
    a.depth = depth;
    a.skip = skip;
    a.xyz_depth = xyz_depth;
    a.chunk_rows = chunk_rows;
    return tf32_field::launch(a, static_cast<cudaStream_t>(stream));
  }
  if (uses_wgmma(dtype, width, pe)) {
    if (n_rows < 0 || samples < 1 || skip < 0 || depth < skip + 2 || xyz_depth < 0) {
      return int(cudaErrorInvalidValue);
    }
    if (n_rows == 0) return int(cudaSuccess);
    if (tiles == nullptr || scratch == nullptr || max_ctas < 1) return int(cudaErrorInvalidValue);
    wgmma_field::Args a;
    a.x = static_cast<const float*>(x);
    a.dirf = static_cast<const float*>(dirf);
    a.tiles = static_cast<const wgmma_field::bf16*>(tiles);
    a.b_pts = static_cast<const float*>(b_pts);
    a.b_stack = static_cast<const float*>(b_stack);
    a.b_view = static_cast<const float*>(b_view);
    a.w_out = static_cast<const wgmma_field::bf16*>(w_out);
    a.b_out = static_cast<const float*>(b_out);
    a.out = static_cast<float*>(out);
    a.scratch = static_cast<float*>(scratch);
    a.n_rows = n_rows;
    a.samples = samples;
    a.pe = pe;
    a.depth = depth;
    a.skip = skip;
    a.xyz_depth = xyz_depth;
    a.n_blocks = 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return width == 256 ? wgmma_field::launch<256>(a, max_ctas, s)
                        : wgmma_field::launch<1024>(a, max_ctas, s);
  }
  if (dtype == 1) {
    return mma_field::launch_typed<mma_field::bf16>(x, dirf, w_pts, b_pts, w_stack, b_stack,
                                                    w_view, b_view, w_out, b_out, out, n_rows,
                                                    samples, pe, width, depth, skip, xyz_depth,
                                                    stream);
  }
  return int(cudaErrorInvalidValue);
}

// Point rows that share one read of the weights for this dtype, width and embedding size (a
// CTA's rows: the fused designs stream the whole stack once a row block, the 3xTF32 design a
// layer's column tile once a CTA tile); 0 if not supported.
extern "C" int field_block_rows(int dtype, int width, int pe) {
  if (dtype == 0) {
    return width % 64 == 0 && width >= 64 && width <= 1024 && pe >= 1 ? tf32_field::kRows : 0;
  }
  if (uses_wgmma(dtype, width, pe)) {
    return width == 256 ? wgmma_field::Geo<256>::kRows : wgmma_field::Geo<1024>::kRows;
  }
  using namespace mma_field;
  if (dtype == 1) return pick_warps_m<bf16>(width, pe) * Traits<bf16>::kWarpRows;
  return 0;
}

// 1 if field_apply runs the wgmma design for this dtype, width and embedding size, else 0.
extern "C" int field_uses_wgmma(int dtype, int width, int pe) {
  return uses_wgmma(dtype, width, pe) ? 1 : 0;
}
