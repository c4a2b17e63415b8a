"""Where the serving kernel loses its time: timing variants on the card.

    python -m mofanerf_tpu_torch.utils.serve_variants [--variants a,b] [--iters 50]

A profiler that reads stall reasons does not run everywhere, so this script
locates a design's limit by timing. It copies the sources of
`csrc/serve_kernel.cu` into `build/variants/serve/<name>/`, patches one thing
out a copy, builds each copy with nvcc and times them in turns at the serving
packet (bf16 student D=4, W=128, multires=8; 16384 rays x 32 samples, the
first eighth of them missing the box, as chip_smoke.py's rays).

The mma.sync design (`serve_kernel_mma.cuh`: 256-row CTAs that stage each
layer's weights into shared memory, block-wide barriers around every stage,
activations in shared memory, ldmatrix + mma.sync), launched at this shape
through an entry of the copy's own:
  base         the source as it is
  stageonce    the input layer's weights staged, no other layer's (results
               wrong): what staging a layer at a time costs
  nosync       every __syncthreads removed (results wrong): what the barriers
               cost
  noembed      sin of the embedding replaced by a constant (results wrong)
  nocomposite  the compositing loop removed (results wrong)
The wgmma design (`serve_kernel_wgmma.cuh`, what `render_rays_bounded_fused`
runs at this shape), launched through `serve_render`:
  port         the source as it is, through the port's own wrapper
  wnoembed     sin of the embedding replaced by a constant (results wrong)
  wnocomposite the compositing loop over a lane's samples removed (results
               wrong; the scan and the sums across lanes stay)
  wserial      the composite one thread a ray, serially over its samples, as
               the mma.sync design composites (results right at S = 32): what
               the warp scan saves
  wnoskip      items whose rays all miss computed in full (results right)
  w3wg         three warpgroups a CTA instead of four (results right)
  wconstpts    sample points replaced by constants: no load of the rays
               (results wrong)
  wnodirf      the view features replaced by zeros: no load of them (results
               wrong)
`base`, `port` and `wserial` compute the function; they are held against
each other. Each is timed in TURNS turns (a b c ... c b a, repeated).
Then the 512x512 serving frame (`render_frame_serve`, as chip_smoke.py times
it, host clock), in FRAME_PAIRS pairs of turns, which of the two runs first
alternating:
  frame          as it is
  frame_blocking its small host-to-card copies (box, K, pose) made from
                 pageable memory, which waits for the card's queued work
                 (results right): what `utils/device.py::to_device` saves
Needs one CUDA card and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mofanerf_tpu_torch.utils import cuda_build

D, W, MR, S = 4, 128, 8, 32
N_RAYS = 16384
TURNS = 6
FRAME, FRAME_PAIRS, FRAME_REPS = 512, 10, 10

MMA, WGMMA = "serve_kernel_mma.cuh", "serve_kernel_wgmma.cuh"
_STAGE_HIDDEN = "    stage_weights(wbuf, L.ldw, p.wl + size_t(l) * W * W, W, W, W);\n"
_STAGE_HEAD = ("  stage_weights(wbuf, L.ldw, p.wfeat, W, W, W2);\n"
               "  for (int i = tid; i < W * (L.nh - W2); i += kThreads) {\n"
               "    const int r = i / (L.nh - W2), c = W2 + i % (L.nh - W2);\n"
               "    wbuf[r * L.ldw + c] = c == W2 ? p.wsig[r] : Tr::from_f(0.f);\n"
               "  }\n")
_STAGE_RGB = ("  for (int i = tid; i < W2 * 16; i += kThreads) {\n"
              "    const int r = i / 16, c = i % 16;\n"
              "    wbuf[r * L.ldw + c] = c < 3 ? p.wrgb[r * 3 + c] : Tr::from_f(0.f);\n"
              "  }\n")
# name -> (file of csrc/ to patch, [(text as it is, text in the variant)]); every occurrence
# of a text is replaced, and a text that does not occur fails the build
PATCHES = {
    "base": (MMA, []),
    "stageonce": (MMA, [(_STAGE_HIDDEN, ""), (_STAGE_HEAD, ""), (_STAGE_RGB, "")]),
    "nosync": (MMA, [("__syncthreads();", "")]),
    "noembed": (MMA, [("          v = sinf(arg);\n", "          v = 0.5f;\n")]),
    "nocomposite": (MMA, [("for (int s = 0; s < S; ++s) {\n      const float* sp = samp",
                           "for (int s = 0; s < 0; ++s) {\n      const float* sp = samp")]),
    "wnoembed": (WGMMA, [("  return sinf(arg);\n", "  return 0.5f;\n")]),
    "wnocomposite": (WGMMA, [("for (int c = 0; c < chunk; ++c) {",
                              "for (int c = 0; c < 0; ++c) {")]),
    "wserial": (WGMMA, [("const int L = S < 32 ? S : 32, chunk = S / L;",
                         "const int L = 1, chunk = S;"),
                        ("const int ri = warp * (32 / L) + lane / L, li = lane % L;",
                         "const int ri = min(warp * (32 / L) + lane / L, rays_it - 1), "
                         "li = lane % L;")]),
    "wnoskip": (WGMMA, [("if (!__any_sync(0xffffffffu, any)) {",
                         "if (false && !__any_sync(0xffffffffu, any)) {")]),
    "w3wg": (WGMMA, [("constexpr int kWarpgroups = 4;", "constexpr int kWarpgroups = 3;")]),
    "wconstpts": (WGMMA, [("x[h][d] = __fadd_rn(p.rays_o[ray_of[h] * 3 + d], "
                           "__fmul_rn(p.rays_d[ray_of[h] * 3 + d], z));",
                           "x[h][d] = 0.25f * (d + 1) + 0.01f * h;")]),
    "wnodirf": (WGMMA, [("__bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dirf_lo + c))",
                         "make_float2(0.f, 0.f)"),
                        ("__bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dirf_hi + c))",
                         "make_float2(0.f, 0.f)")]),
}

# an entry of the copy's own, so that the mma.sync design runs at a shape the dispatch of
# serve_render gives to the wgmma design
ENTRY = """
extern "C" int variant_render(const void* rays_o, const void* rays_d, const void* aux,
                              const void* dirf, const void* w0, const void* b0, const void* wl,
                              const void* bl, const void* wsig, const void* bsig,
                              const void* wfeat, const void* bfeat, const void* wrgb,
                              const void* brgb, void* out, int n_rays, int n_samples, int depth,
                              int width, int multires, int white_bkgd, void* stream) {
  return mma_serve::launch_typed<mma_serve::bf16>(rays_o, rays_d, aux, dirf, w0, b0, wl, bl,
                                                  wsig, bsig, wfeat, bfeat, wrgb, brgb, out,
                                                  n_rays, n_samples, depth, width, multires,
                                                  white_bkgd, stream);
}
"""


def build_variant(name: str) -> ctypes.CDLL:
    target, patches = PATCHES[name]
    out_dir = cuda_build.BUILD_DIR / "variants" / "serve" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in cuda_build.source_files("serve_kernel"):
        text = path.read_text()
        if path.name == target:
            for old, new in patches:
                if old not in text:
                    raise RuntimeError(f"variant {name}: the text to patch is not in "
                                       f"{path.name}:\n{old}")
                text = text.replace(old, new)
        if path.suffix == ".cu":
            text += ENTRY
        (out_dir / path.name).write_text(text)
    so = out_dir / "serve_kernel.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                           str(out_dir / "serve_kernel.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    want = "bfloat16" if target == MMA else "wgmma"
    for i, line in enumerate(log):
        # the report of the kernel the variant times: its mangled name, its usage
        if "Compiling entry function" in line and want in line:
            print(f"ptxas {name}: " + " | ".join(s.strip() for s in log[i + 1:i + 3]), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.variant_render.restype = ctypes.c_int
    lib.variant_render.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.serve_render.restype = ctypes.c_int
    lib.serve_render.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p])
    return lib


def packet_rays(n: int, seed: int, device):
    """Origins at (0, 0, 16), directions toward the head with spread and
    unnormalised lengths; the first n/8 point away (misses)."""
    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0.0, 0.0, 16.0]], np.float32), (n, 1))
    to = rng.standard_normal((n, 3)) * np.array([1.5, 1.5, 0.2]) - [0, 0, 16]
    rd = to / np.linalg.norm(to, axis=-1, keepdims=True) * rng.uniform(0.7, 1.4, (n, 1))
    rd[: n // 8] = [0.0, 0.0, 1.0]
    return (torch.from_numpy(ro).to(device),
            torch.from_numpy(rd.astype(np.float32)).to(device))


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def frame_turns(dev) -> dict:
    """ms a 512x512 serving frame as it is and with blocking host-to-card
    copies, FRAME_PAIRS turns each (alternating which runs first), FRAME_REPS
    frames a turn; the two must render the same frame. Prints each one's
    median and quartiles, and in how many pairs `frame` was the faster."""
    from mofanerf_tpu_torch.models.student import StudentConfig, init_student_params
    from mofanerf_tpu_torch.ops.rays import pose_spherical
    from mofanerf_tpu_torch.render import serve

    cfg = StudentConfig(depth=D, width=W, multires=MR, compute_dtype=torch.bfloat16)
    params = init_student_params(torch.Generator().manual_seed(1), cfg, device=dev)
    K = np.array([[1200.0, 0, FRAME / 2], [0, 1200.0, FRAME / 2], [0, 0, 1]], np.float32)
    c2w = pose_spherical(0.0, -5.0, 16.0)[:3]
    copies = {"frame": serve.to_device,
              "frame_blocking": lambda x, d: torch.as_tensor(x, dtype=torch.float32, device=d)}

    def frame():
        return serve.render_frame_serve(params, cfg, None, FRAME, FRAME, K, c2w, n_samples=S,
                                        packet_size=N_RAYS, hit_fraction=1.0)

    times, outs = {n: [] for n in copies}, {}
    try:
        for i in range(FRAME_PAIRS):
            for n in (list(copies) if i % 2 == 0 else list(reversed(copies))):
                serve.to_device = copies[n]
                outs[n] = frame()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(FRAME_REPS):
                    frame()
                torch.cuda.synchronize()
                times[n].append((time.perf_counter() - t0) / FRAME_REPS * 1e3)
    finally:
        serve.to_device = copies["frame"]
    if not all(torch.equal(outs["frame"][k], outs["frame_blocking"][k]) for k in outs["frame"]):
        raise RuntimeError("the frame with blocking copies renders another frame")
    results = {}
    for n, t in times.items():
        q1, q2, q3 = (float(v) for v in np.percentile(t, [25, 50, 75]))
        results[n] = {"ms": q2, "quartiles_ms": [q1, q3], "runs_ms": t}
        print(f"{n}: {q2:.4f} ms a {FRAME}x{FRAME} frame, median of {len(t)} turns of "
              f"{FRAME_REPS} (quartiles {q1:.4f}, {q3:.4f}; {', '.join(f'{v:.4f}' for v in t)})",
              flush=True)
    wins = sum(a < b for a, b in zip(times["frame"], times["frame_blocking"]))
    results["frame_faster_pairs"] = wins
    print(f"frame faster than frame_blocking in {wins} of {FRAME_PAIRS} pairs", flush=True)
    return results


def main(argv=None) -> int:
    from mofanerf_tpu_torch.models.student import StudentConfig, init_student_params
    from mofanerf_tpu_torch.ops import serve_kernel as sk

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(PATCHES))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_variants: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)

    names = args.variants.split(",")
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = dict(zip(names, pool.map(build_variant, names)))

    cfg = StudentConfig(depth=D, width=W, multires=MR, compute_dtype=torch.bfloat16)
    params = init_student_params(torch.Generator().manual_seed(0), cfg, device=dev)
    params["sigma"]["b"] = params["sigma"]["b"] + 1.5
    pack = sk.pack_student(params, cfg)
    ro, rd = packet_rays(N_RAYS, 0, dev)
    aux, dirf = sk.ray_operands(pack, cfg, ro, rd, 8.0, 26.0, (-2.0,) * 3, (2.0,) * 3)
    out = torch.empty((N_RAYS, 8), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    operands = [t.data_ptr() for t in (ro, rd, aux, dirf, pack.w0, pack.b0, pack.wl, pack.bl,
                                       pack.wsig, pack.bsig, pack.wfeat, pack.bfeat, pack.wrgb,
                                       pack.brgb)]
    shape = (N_RAYS, S, D, W, MR, 0)

    def run_variant(name):
        if PATCHES[name][0] == MMA:
            err = libs[name].variant_render(*operands, out.data_ptr(), *shape, stream)
        else:
            err = libs[name].serve_render(1, *operands, pack.w_tiles.data_ptr(), out.data_ptr(),
                                          *shape, stream)
        if err != 0:
            raise RuntimeError(f"variant {name}: launch failed: cudaError {err}")

    def run_port():
        return sk._serve_cuda(pack, aux, dirf, cfg, ro, rd, S, False)

    runs = {n: (lambda n=n: run_variant(n)) for n in names}
    runs["port"] = run_port
    # those that compute the function, against the port
    got = run_port()
    for name, what in (("base", "two bf16 designs, two sum orders"),
                       ("wserial", "the same design, two composite orders")):
        if name in runs:
            runs[name]()
            torch.cuda.synchronize()
            print(f"max |{name} - port| {float((out[:, :6] - got[:, :6]).abs().max()):.3e} "
                  f"over {N_RAYS} rays (rgb, acc, depth, disp; {what})", flush=True)
    sk.items_skipped(dev)
    run_port()
    print(f"items skipped by the wgmma design (counted by its kernel): "
          f"{sk.items_skipped(dev)} of {N_RAYS * S // 64}; the hit mask has "
          f"{sk.items_all_missing(aux[:, 2] > 0, S)} with no hit ray", flush=True)
    order = (list(runs) + list(reversed(runs))) * (TURNS // 2)   # in turns: a b ... b a
    times = {n: [] for n in runs}
    for n in order:
        times[n].append(cuda_ms(runs[n], args.iters))
    results = {n: {"ms": sum(t) / len(t), "runs_ms": t} for n, t in times.items()}
    for n, t in times.items():
        print(f"{n}: {sum(t) / len(t):.4f} ms a launch of {N_RAYS} rays x {S} samples, mean of "
              f"{len(t)} turns (min {min(t):.4f}, max {max(t):.4f})", flush=True)
    frames = frame_turns(dev)
    print(json.dumps({"card": smi.stdout.strip(), "serve_variants": results,
                      "serve_frames": frames}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
