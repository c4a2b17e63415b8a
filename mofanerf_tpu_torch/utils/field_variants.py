"""Where the fused field kernel loses its time: timing variants on the card.

    python -m mofanerf_tpu_torch.utils.field_variants [--fields coarse,fine] [--variants a,b]
    python -m mofanerf_tpu_torch.utils.field_variants --f32 [--f32-shapes a,b]
    python -m mofanerf_tpu_torch.utils.field_variants --tf32 [--variants a,b]

A profiler that reads stall reasons does not run everywhere, so this script
locates a design's limit by timing. It copies the sources of
`csrc/field_kernel.cu` into `build/variants/<name>/`, patches one thing out
a copy, builds each copy with nvcc and times them in turns at the teacher's
two packet shapes (bf16, 8192 rays of 64 or 128 samples).

The mma.sync design (`field_kernel_mma.cuh`: a `cp.async` ring of 16-row
weight chunks, a block-wide barrier a chunk, `ldmatrix` + `mma.sync`; it
serves bf16 at the widths the wgmma design does not cover), launched at
these shapes through an entry of the copy's own:
  base      the source as it is
  window    every weight-stack chunk read from a 1 MB window (the stream is
            L2-resident; results wrong): what the bytes cost
  nosync    the barrier of the k loop removed (results wrong): what the
            barrier cadence costs
  nofetch   no copy started after the first ring fill (results wrong): what
            starting the copies and drawing the stream cost
  bare      nosync + nofetch: ldmatrix + mma.sync alone
The wgmma design (`field_kernel_wgmma.cuh`, what `fused_field_apply` runs at
these shapes), launched through `field_apply`:
  port      the source as it is, through the port's own wrapper
  wwindow   every tile read from the first 1 MB of the stream (results wrong):
            what a stream larger than L2 costs
  nocopy    the producer marks a stage full without copying (results wrong):
            the products, barriers and epilogues alone; port minus nocopy is
            what waiting for the stream costs
Only `base` and `port` compute the function; they are held against each
other. Needs one CUDA card and nvcc; prints the card's name and power limit.

The 3xTF32 design (`field_kernel_tf32.cuh`, what `fused_field_apply` runs
in f32), launched through `field_apply`, with `--tf32` at the f32 shapes
`fine_packet/8` and `coarse_packet` (F32_SHAPES), each held against the plain
version (max |diff| and rms, the contract's scale):
  tf32      the source as it is (a partial sum promoted every kPromote = 1
            k block)
  promote2  promoted every 2 k blocks
  promote4  promoted every 4 k blocks
  nopromote promoted once, at the end (all of k in the tensor cores' sums):
            the first build's precision
  nosplitA  the activations' low part dropped (results less exact): what
            splitting A in registers costs
`--f32` builds nothing of its own: it times the port's f32 path as it is
(`fused_field_apply`, the kernel) against its plain version
(`fused_field_apply_ref`) with CUDA events, in turns (kernel, plain, plain,
kernel), at the f32 shapes of F32_SHAPES, beside the FFMA bound (67 TFLOP/s)
and the bound of three TF32 products a product (495 TFLOP/s). It imports
whichever `mofanerf_tpu_torch` comes first on the path, so an older tree is
timed by running this file with that tree on PYTHONPATH.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from mofanerf_tpu_torch.utils import cuda_build

FIELDS = {"coarse": (8, 256, 64), "fine": (10, 1024, 128)}   # depth, width, samples a ray
PACKET = 8192
# --f32: label -> (field, rays, samples a ray): the shapes chip_smoke.py's kernel phase has
# timed in f32 since the fine field's f32 shapes were cut to an eighth, and the full packet
F32_SHAPES = {"fine_packet/8": ("fine", 1024, 128), "fine_distill/8": ("fine", 4096, 1),
              "fine_fast/8": ("fine", 1024, 32), "coarse_packet": ("coarse", 8192, 64),
              "fine_packet": ("fine", 8192, 128)}
PEAK_F32, PEAK_TF32 = 67e12, 495e12   # H100 SXM, dense

MMA, WGMMA, TF32 = "field_kernel_mma.cuh", "field_kernel_wgmma.cuh", "field_kernel_tf32.cuh"
_PROMOTE = "constexpr int kPromote = 1;"
_LO_A = "      f[1][i] = tf32_rna(v - __uint_as_float(f[0][i]));\n"
_SYNC = ("      __syncthreads();               "
         "// ... everyone's has, and chunk ci-1 is no longer read\n")
_FETCH = "      fetch(ci + kStages - 1);       // into the slot chunk ci-1 held\n"
_STACK_SRC = "        src = p.w_stack + size_t(i - c_pts) * KC * W;\n"
_COPY = ("          mbar_expect_tx(full_bar + 8 * s, kTileBytes);\n"
         "          bulk_copy(ring_addr + s * kTileBytes, src + size_t(t) * kTileBytes, "
         "kTileBytes,\n"
         "                    full_bar + 8 * s);\n")
# name -> (file of csrc/ to patch, [(line as it is, line in the variant)])
PATCHES = {
    "base": (MMA, []),
    "window": (MMA, [(_STACK_SRC,
                      "        src = p.w_stack + size_t((i - c_pts) % ((1 << 20) / (KC * W * "
                      "int(sizeof(T))))) * KC * W;\n")]),
    "nosync": (MMA, [(_SYNC, "")]),
    "nofetch": (MMA, [(_FETCH, "      cp_async_commit();\n")]),
    "bare": (MMA, [(_SYNC, ""), (_FETCH, "      cp_async_commit();\n")]),
    "wwindow": (WGMMA, [("src + size_t(t) * kTileBytes", "src + size_t(t % 32) * kTileBytes")]),
    "nocopy": (WGMMA, [(_COPY, "          mbar_arrive(full_bar + 8 * s);\n")]),
    "tf32": (TF32, []),
    "promote2": (TF32, [(_PROMOTE, "constexpr int kPromote = 2;")]),
    "promote4": (TF32, [(_PROMOTE, "constexpr int kPromote = 4;")]),
    "nopromote": (TF32, [(_PROMOTE, "constexpr int kPromote = 1 << 30;")]),
    "nosplitA": (TF32, [(_LO_A, "      f[1][i] = 0u;\n")]),
}
TF32_VARIANTS = ("tf32", "promote2", "promote4", "nopromote", "nosplitA")

# an entry of the copy's own, so that the mma.sync design runs at shapes the dispatch of
# field_apply gives to the wgmma design
ENTRY = """
extern "C" int variant_apply(const void* x, const void* dirf, const void* w_pts,
                             const void* b_pts, const void* w_stack, const void* b_stack,
                             const void* w_view, const void* b_view, const void* w_out,
                             const void* b_out, void* out, int n_rows, int samples, int pe,
                             int width, int depth, int skip, int xyz_depth, void* stream) {
  return mma_field::launch_typed<mma_field::bf16>(x, dirf, w_pts, b_pts, w_stack, b_stack,
                                                  w_view, b_view, w_out, b_out, out, n_rows,
                                                  samples, pe, width, depth, skip, xyz_depth,
                                                  stream);
}
"""


def build_variant(name: str) -> ctypes.CDLL:
    target, patches = PATCHES[name]
    out_dir = cuda_build.BUILD_DIR / "variants" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in cuda_build.source_files("field_kernel"):
        text = path.read_text()
        if path.name == target:
            for old, new in patches:
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name}: the text to patch occurs "
                                       f"{text.count(old)} times in {path.name}:\n{old}")
                text = text.replace(old, new)
        if path.suffix == ".cu":
            text += ENTRY
        (out_dir / path.name).write_text(text)
    so = out_dir / "field_kernel.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                           str(out_dir / "field_kernel.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    want = {MMA: "bfloat16", WGMMA: "wgmma", TF32: "layer_kernelILi128"}[target]
    for i, line in enumerate(log):
        # the report of the kernels the variant times: the entry's mangled name, its usage
        if "Compiling entry function" in line and want in line:
            print(f"ptxas {name}: " + " | ".join(s.strip() for s in log[i + 1:i + 4]), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.variant_apply.restype = ctypes.c_int
    lib.variant_apply.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.field_apply.restype = ctypes.c_int
    lib.field_apply.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                                + [ctypes.c_void_p])
    return lib


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


def tf32_variants(names, libs, dev, card: str) -> dict:
    """The 3xTF32 design's variants in turns at the f32 packet shapes, each held
    against the plain version."""
    from mofanerf_tpu_torch.models.field import FieldConfig, fold_conditioning, init_field_params
    from mofanerf_tpu_torch.ops import field_kernel as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for label in ("fine_packet/8", "coarse_packet"):
        field, n_rays, samples = F32_SHAPES[label]
        depth, width, _ = FIELDS[field]
        cfg = FieldConfig(depth=depth, width=width, compute_dtype=torch.float32)
        gen = torch.Generator().manual_seed(3)
        params = init_field_params(gen, cfg, device=dev)
        codes = [(torch.randn(n, generator=gen) * 0.5).to(dev)
                 for n in (cfg.shape_dim, cfg.exp_dim, cfg.tex_dim)]
        fused = fk.pack_fused_params(params, fold_conditioning(params, *codes), cfg)
        n_rows = n_rays * samples
        x = (torch.rand((n_rows, cfg.pts_embed_dim), generator=gen) * 2 - 1).to(dev)
        dirf = (torch.randn((n_rays, width // 2), generator=gen) * 0.1).to(dev)
        chunk, n_scratch = fk.tf32_scratch(cfg, n_rows)
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
        outs = {n: torch.empty((n_rows, 4), dtype=torch.float32, device=dev) for n in names}
        stream = torch.cuda.current_stream(dev).cuda_stream
        operands = [t.data_ptr() for t in (x, dirf, fused.w_pts, fused.b_pts, fused.w_stack,
                                           fused.b_stack, fused.w_view, fused.b_view,
                                           fused.w_out, fused.b_out, fused.w_tiles)]
        shape = (n_rows, samples, cfg.pts_embed_dim, width, depth, cfg.skip, cfg.xyz_depth)

        def run(name):
            err = libs[name].field_apply(0, *operands, scratch.data_ptr(),
                                         outs[name].data_ptr(), *shape, 0, chunk, stream)
            if err != 0:
                raise RuntimeError(f"variant {name}: launch failed: cudaError {err}")

        with torch.no_grad():
            want = torch.cat(fk.fused_field_apply_ref(fused, x, dirf, cfg, samples), dim=-1)
        scale = max(1.0, float(want.abs().max()))
        times = {n: [] for n in names}
        for n in list(names) + list(reversed(names)):
            times[n].append(cuda_ms(lambda n=n: run(n), 3))
        row = {}
        for n in names:
            run(n)
            torch.cuda.synchronize()
            diff = (outs[n] - want).abs()
            row[n] = {"ms": sum(times[n]) / len(times[n]), "runs_ms": times[n],
                      "max_abs_err": float(diff.max()) / scale,
                      "rms_err": float(diff.square().mean().sqrt()) / scale}
            print(f"tf32 {label} {n}: {row[n]['ms']:.3f} ms "
                  f"({', '.join(f'{v:.3f}' for v in times[n])}); max|diff| / scale "
                  f"{row[n]['max_abs_err']:.3e}, rms / scale {row[n]['rms_err']:.3e} "
                  f"(the contract: 1e-4, 1e-5)", flush=True)
        results[label] = row
    print(json.dumps({"card": card, "tf32_variants": results}), flush=True)
    return results


def f32_turns(labels, dev, card: str) -> dict:
    """The f32 kernel and its plain version in turns at each shape of `labels`."""
    from mofanerf_tpu_torch.models.field import FieldConfig, fold_conditioning, init_field_params
    from mofanerf_tpu_torch.ops import field_kernel as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for label in labels:
        field, n_rays, samples = F32_SHAPES[label]
        depth, width, _ = FIELDS[field]
        cfg = FieldConfig(depth=depth, width=width, compute_dtype=torch.float32)
        gen = torch.Generator().manual_seed(3)
        params = init_field_params(gen, cfg, device=dev)
        codes = [(torch.randn(n, generator=gen) * 0.5).to(dev)
                 for n in (cfg.shape_dim, cfg.exp_dim, cfg.tex_dim)]
        fused = fk.pack_fused_params(params, fold_conditioning(params, *codes), cfg)
        n_rows = n_rays * samples
        x = (torch.rand((n_rows, cfg.pts_embed_dim), generator=gen) * 2 - 1).to(dev)
        dirf = (torch.randn((n_rays, width // 2), generator=gen) * 0.1).to(dev)
        runs = {"kernel": lambda: fk.fused_field_apply(fused, x, dirf, cfg, samples),
                "plain": lambda: fk.fused_field_apply_ref(fused, x, dirf, cfg, samples)}
        with torch.no_grad():
            got = torch.cat(runs["kernel"](), dim=-1)
            want = torch.cat(runs["plain"](), dim=-1)
            err = float((got - want).abs().max())
            times = {n: [] for n in runs}
            for n in ("kernel", "plain", "plain", "kernel"):
                times[n].append(cuda_ms(runs[n], 3 if n_rows <= 131072 else 1))
        n_layers = fused.w_stack.shape[0]
        flop = n_rows * 2 * (cfg.pts_embed_dim * width + n_layers * width * width
                             + width * (width // 2) + width + 3 * (width // 2))
        row = {n: sum(t) / len(t) for n, t in times.items()}
        row.update(runs_ms=times, rows=n_rows, tflop=flop / 1e12, max_abs_err=err,
                   max_abs_plain=float(want.abs().max()),
                   ffma_bound_ms=flop / PEAK_F32 * 1e3, tf32x3_bound_ms=3 * flop / PEAK_TF32 * 1e3)
        results[label] = row
        print(f"f32 {label} ({depth}x{width}, {n_rays} rays x {samples}): kernel "
              f"{row['kernel']:.3f} ms ({', '.join(f'{v:.3f}' for v in times['kernel'])}), plain "
              f"{row['plain']:.3f} ms ({', '.join(f'{v:.3f}' for v in times['plain'])}); FFMA "
              f"bound {row['ffma_bound_ms']:.3f} ms, 3xTF32 bound {row['tf32x3_bound_ms']:.3f} ms "
              f"({row['tflop']:.3f} TFLOP); max|kernel-plain| {err:.3e} (max|plain| "
              f"{row['max_abs_plain']:.3f})", flush=True)
    print(json.dumps({"card": card, "f32_turns": results}), flush=True)
    return results


def main(argv=None) -> int:
    from mofanerf_tpu_torch.models.field import FieldConfig, fold_conditioning, init_field_params
    from mofanerf_tpu_torch.ops import field_kernel as fk

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fields", default="coarse,fine")
    ap.add_argument("--variants", default=",".join(PATCHES))
    ap.add_argument("--f32", action="store_true", help="time the f32 path against its plain "
                                                       "version in turns (F32_SHAPES)")
    ap.add_argument("--f32-shapes", default=",".join(F32_SHAPES))
    ap.add_argument("--tf32", action="store_true", help="time the 3xTF32 design's variants "
                                                        "(TF32_VARIANTS)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("field_variants: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.f32:
        f32_turns(args.f32_shapes.split(","), dev, smi.stdout.strip())
        return 0
    if args.tf32:
        names = [n for n in args.variants.split(",") if n in TF32_VARIANTS] or list(TF32_VARIANTS)
        with ThreadPoolExecutor(max_workers=len(names)) as pool:
            libs = dict(zip(names, pool.map(build_variant, names)))
        tf32_variants(names, libs, dev, smi.stdout.strip())
        return 0

    names = [n for n in args.variants.split(",") if n not in TF32_VARIANTS]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = dict(zip(names, pool.map(build_variant, names)))
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    results = {}
    for field in args.fields.split(","):
        depth, width, samples = FIELDS[field]
        cfg = FieldConfig(depth=depth, width=width, compute_dtype=torch.bfloat16)
        gen = torch.Generator().manual_seed(3)
        params = init_field_params(gen, cfg, device=dev)
        codes = [(torch.randn(n, generator=gen) * 0.5).to(dev)
                 for n in (cfg.shape_dim, cfg.exp_dim, cfg.tex_dim)]
        fused = fk.pack_fused_params(params, fold_conditioning(params, *codes), cfg)
        n_rows = PACKET * samples
        x = (torch.rand((n_rows, cfg.pts_embed_dim), generator=gen) * 2 - 1).to(dev)
        dirf = (torch.randn((PACKET, width // 2), generator=gen) * 0.1).to(dev)
        out = torch.empty((n_rows, 4), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        max_ctas, n_scratch = fk.wgmma_scratch(cfg, n_sms)
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
        operands = [t.data_ptr() for t in (x, dirf, fused.w_pts, fused.b_pts, fused.w_stack,
                                           fused.b_stack, fused.w_view, fused.b_view,
                                           fused.w_out, fused.b_out)]
        shape = (n_rows, samples, cfg.pts_embed_dim, width, depth, cfg.skip, cfg.xyz_depth)

        def run_variant(name):
            if PATCHES[name][0] == MMA:
                err = libs[name].variant_apply(*operands, out.data_ptr(), *shape, stream)
            else:
                err = libs[name].field_apply(1, *operands, fused.w_tiles.data_ptr(),
                                             scratch.data_ptr(), out.data_ptr(), *shape,
                                             max_ctas, 0, stream)
            if err != 0:
                raise RuntimeError(f"variant {name}: launch failed: cudaError {err}")

        def run_port():
            with torch.no_grad():
                return fk.fused_field_apply(fused, x, dirf, cfg, samples)

        runs = {n: (lambda n=n: run_variant(n)) for n in names}
        runs["port"] = run_port
        # the two that compute the function, against each other
        if "base" in runs:
            runs["base"]()
            got = torch.cat(run_port(), dim=-1)
            torch.cuda.synchronize()
            print(f"{field}: max |base - port| {float((out - got).abs().max()):.3e} "
                  f"(max |port| {float(got.abs().max()):.3f}; bf16 at full gain, two sum "
                  f"orders)", flush=True)
        iters = 2 if field == "fine" else 10
        order = list(runs) + list(reversed(runs))   # in turns: a b c ... c b a
        times = {n: [] for n in runs}
        for n in order:
            times[n].append(cuda_ms(runs[n], iters))
        results[field] = {n: {"ms": sum(t) / len(t), "runs_ms": t} for n, t in times.items()}
        for n, t in times.items():
            print(f"{field} {n}: {sum(t) / len(t):.3f} ms a launch of {PACKET} rays x {samples} "
                  f"samples ({', '.join(f'{v:.3f}' for v in t)})", flush=True)
    print(json.dumps({"card": smi.stdout.strip(), "field_variants": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
