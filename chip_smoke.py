#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py                 # all phases (needs one CUDA card)
    python3 chip_smoke.py --kernel-only   # build + kernel-vs-plain phases only
    python3 chip_smoke.py --world 4       # build, then only the multi-card paths
                                          # across 4 cards over NCCL (needs 4)

Phases, each failing loudly:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build every CUDA source of mofanerf_tpu_torch/csrc with nvcc (sm_90a),
     one nvcc a source, started together, printing the build time and ptxas'
     register / shared-memory report, and count HGMMA (wgmma) instructions in
     each library's SASS;
  3. kernels, each against its plain PyTorch version on the card, timed with
     CUDA events beside its bound:
     - the serving kernel at the serving width (D=4, W=128, multires=8, S=32,
       16384 rays, hit and miss rays, unnormalised directions): bf16 through
       its wgmma design, f32 through its mma.sync design, with and without
       white background, beside two bounds (the hit rays' work, every row's);
       the items the wgmma design's kernel counts as skipped, held against
       the items the hit mask leaves without a hit ray;
     - the field kernel at full width, both of the teacher's fields (coarse
       8x256 with 64 samples a ray, fine 10x1024 with 128: the two widths the
       wgmma design takes in bf16; f32 runs the 3xTF32 design), at ragged
       shapes (fewer rows than one row block; fewer blocks than the card has
       SMs, with blocks that span rays; more blocks than SMs with a ragged
       last one), at the packet shape of the teacher path and, for the fine
       field, at distillation's (32768 points, one sample a ray) and --fast's
       (8192 rays x 32 samples; f32 on an eighth of these three, the shapes
       its earlier runs timed, and on the whole packet); bf16 once more at
       each timed shape
       with contracting weights (x 0.4, atol 5e-3); f32 timed against its
       plain version in turns (CUDA events), beside the FFMA bound and the
       bound of three TF32 products a product;
     - a yardstick, not on any path: one hidden layer's product at the packet
       shapes through torch.matmul (`layer_matmul_ms`);
  4. serving path: a seeded bf16 student artifact through the run_render CLI
     (4 views at 512x512), then a 3-pose x 3-expression rig of a
     code-conditioned student through render_path_serve; then the steady
     512x512 frame, timed and once more under torch.profiler (the card's busy
     share, the kernels and the host operations a frame);
  5. teacher path: a seeded full-width model, a seeded UV map through the
     texture encoder, then the run_render CLI's teacher route (2 views) and
     render_path with a conditioning a pose (2 poses, 2 expressions), at
     512x512 with 64 + 64 samples; then a 256x256 f32 teacher frame through
     run_render --compute_dtype float32 (the field kernel's 3xTF32 design)
     and render_path, its seconds and launches; and the JAX package's
     examples' small model (netdepth 2, netwidth 8 / 16, which the kernel
     takes padded to width 64) through the field kernel, f32 and bf16,
     against its plain version, timed against it in turns at its 64x64
     frame's shape (the median of four ~50 ms turns a side) beside the
     field's own bound (the padded shape's printed beside it), and a frame
     against the CPU's.
  6. training path: a 512x512 FaceScape-shaped fixture written by the port
     (JPEG UV maps decoded by the port), the run_train CLI at the full width of
     configs/exp_mofanerf.txt keeping its occupancy grid (updated every 4
     steps), with a checkpoint mid-run, a resumed run (the grid resumed too),
     and run_render from the last checkpoint (its held-out image, orbit and
     CLI views go through the field kernel); one small f32 step on the card
     against the CPU; the full-width step timed (median after two warm-ups,
     synchronised around each step), its peak memory and operations bound, and
     three steps under torch.profiler (busy share, the texture encoder's share).
  7. distillation path, on the training phase's checkpoint directory: the
     run_render CLI distils a student at the defaults (2000 steps of 32768
     points; the teacher's queries through the field kernel, one launch a
     step), saves it with its provenance and serves it (2 views at 512x512)
     through the serving kernel, then serves it again from the file; an
     expression rig (--distill_cond) and a two-avatar morph
     (--distill_avatars 0,1) at 100 steps, each distilled, saved and served
     again; --fast through the kept grid; and, as a reading, the PSNR of the
     served and the fast frame against the teacher's.
  8. fitting path, on the same checkpoint and fixture: a 512x512 target
     rendered through render_frame at known codes and pose, its pose file
     (that pose rotated by 5 degrees, the fixture's landmarks projected); the
     run_fit CLI (fitting 101 steps with the pose frozen for 30, then
     rendering and rendering_modulation from its codes: previews and views
     through the field kernel); the steady fit step at the 128^2, 256^2 and
     512^2 pyramid levels (median, back to back, its operations bound, peak
     memory, no host synchronisation under torch.cuda.set_sync_debug_mode,
     torch.profiler's busy share and launches); the evaluate CLI on the
     fixture's test split (plain, --render_factor 2, --fast) and export_grids
     (2 identities x 2 expressions) with one grid loaded back and rendered
     through render_frame_fast. It checks the files, that the loss fell, that
     the pose stayed on SO(3) and bit-still through the freeze, that a
     rendering frame equals render_fit_frame of the same codes, and finite
     PSNR and SSIM.
  9. RefineNet, on the same checkpoint and fixture, at the reference's full
     width (ngf 32, 4 downsamplings, 9 ResNet blocks, num_D 2, n_layers_D 3,
     loadSize 512): render_refine_trainset at 256^2 (the field kernel's
     launches counted against 16 a frame), its --fast route for one
     identity, prepare_refine_trainset, run_train_refinenet for 10 steps with
     a seeded random VGG pickled in the JAX package's layout (finite losses,
     both players moved, a checkpoint that --continue_train resumes), the
     steady refine_train_step at 512^2 (median, peak memory, no host
     synchronisation, torch.profiler's busy share and launches, its
     operations bound from the convolutions' shapes), run_refine over the
     corpus and the generator alone;
  10. device-resident training data: run_train with device_data = True at
     the full width of configs/exp_mofanerf.txt from the training phase's last
     checkpoint, 16 steps in chunks of 4 that divide neither i_print nor
     i_weights (the logs and checkpoints where the JAX loop's crossing rule
     puts them; the held-out image's field kernel launches counted), the
     resident split against estimate_device_bytes, a steady chunk's host
     synchronisations (none allowed), and the device-data step against the
     host-data step, back to back in turns.
  11. multi-card (mofanerf_tpu_torch/parallel), on the one card: a world of
     one rank over NCCL in this process (render_frame_sharded at 512x512,
     64 + 64 samples, 64 field kernel launches, against render_frame;
     render_path_serve(mesh=) of 4 views against the call without a mesh;
     the full-width train_step(mesh=) and a two-step device-data chunk under
     the mesh, bit for bit against the calls without, timed in turns with
     the flat gradient buffer's all_reduce); `python -m
     mofanerf_tpu_torch.parallel.dryrun 1` and its three lines; and a world of
     two ranks sharing the card over gloo (NCCL takes one rank a card): on
     mesh (data 2, model 1) the teacher frame (16 packets a rank) and the
     serving path against this process's single-card calls, and a full-width
     f32 data-parallel train step against the single-card step (loss within
     1e-4 relative, params within 1e-5), with the host-staged gloo all_reduce
     timed; on mesh (data 1, model 2), the fine field in model shards, the
     teacher frame (its weights gathered once a frame) and the f32 train step
     with the fine field tensor-parallel, against the same calls.
  12. image formats, after the wild-photo phase (formats_phase): every file
     of mofanerf_tpu_torch/testdata/formats decoded on the host against its
     manifest (imageio's shape, dtype, SHA-256) and header size; the 1024^2
     photo's decode, progressive against baseline, in turns; wild_preprocess
     on the wild phase's photos with the progressive D.jpg beside them, then
     run_fit on D's relit photo; run_train on the training fixture with the
     progressive 512^2 UV map for every identity; field kernel launches
     counted on both paths.
  13. the examples (mofanerf_tpu_torch/examples), after the formats phase: the eight
     synthetic-data studies through their main(), each rendering its scene with the
     rasterizer, training its teacher (8x64 + 8x128 f32, or the quick 4x32 + 4x64) and
     reading it: distill_morphable at half its JAX budgets with its gates (own > cross + 3
     dB, own > 18 dB), the other seven at their quick size; each checked to run to its
     end, its JSON's keys against the JAX package's artifact, every reading finite, and
     both kernels' launches against what its renders and steps imply (counted by shape
     too); then both kernels
     at the studies' shapes (f32 fields of 8x64 and 8x128 at a 64^2 frame's packet and at
     distillation's 8192 points; the avatar and quick students) against their plain
     versions, timed in turns with them, beside their bounds.
  The path phases check shapes, ranges, that the kernel's launch count is
  the expected one, and that a small frame or step agrees with the CPU; the
  distillation phase also that the loss fell and that an artifact served from
  its file gives the distilling call's frames.
The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero without it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# card peaks for the bound (NVIDIA H100 SXM data sheet, dense)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12   # the field kernel's f32 design: three TF32 products an f32 product
PEAK_BYTES = 3.35e12

D, W, MR, S = 4, 128, 8, 32
N_KERNEL = 16384
TOL = {"bfloat16": 2e-2, "float32": 1e-4}

# the teacher's two fields at full width: (depth, width, samples a ray in a packet)
FIELDS = {"coarse": (8, 256, 64), "fine": (10, 1024, 128)}
PACKET = 8192   # rays a packet of render_frame
TEACHER_SIDE = 512   # side of the teacher frames of the path phase
# |kernel - plain| limits as (max, rms), both times max(1, max|plain|)
FIELD_TOL = {"bfloat16": (6e-2, 6e-3), "float32": (1e-4, 1e-5)}
# bf16 is also held sharply at the packet shape, with contracting weights: the
# scale and the atol of the TPU kernel's own test
CONTRACT, CONTRACT_ATOL = 0.4, 5e-3
# the convert phase: the side of run_render's frames from the converted directory, and the
# points each field is held at against the reference's forward
CONVERT_SIDE, CONVERT_POINTS = 128, 4096
# the training phase: steps of the first run (a checkpoint at half of them) and of
# the resumed one, frame side, the orbit's downsampling, steps timed and profiled
TRAIN_STEPS = (8, 16)
TRAIN_SIDE = 512
TRAIN_ORBIT_FACTOR = 8
TIMED_STEPS, PROFILED_STEPS = 8, 3
TRAIN_GRID_EVERY = 4   # the runs' grid interval and warm-up: updates at steps 4, 8, 12, 16
# the training runs' grid threshold: the first of these quantiles of the step-0 coarse
# density whose dilated grid holds at most GRID_STEP0_SHARE of the cells
GRID_QUANTILES, GRID_STEP0_SHARE = (0.9, 0.95, 0.98, 0.99, 0.995, 0.998, 0.999), 0.15
DISTILL_SHORT_STEPS = 100   # the rig's and the morph's distillations (the first runs the default)
DISTILL_TIMED_STEPS, DISTILL_PROFILED_STEPS = 50, 10
# (rays, samples a ray) of the field kernel's small ragged checks: fewer rows than one row
# block; fewer blocks than SMs (idle CTAs in a persistent grid), 67 samples dividing no block
RAGGED = ((1, 50), (61, 67))
# (rays, samples a ray) of the field kernel on this slice's paths: distillation's teacher
# queries (DistillConfig.batch points, one a ray) and the fine field of `run_render --fast`
# (a packet of spec.render.packet_size rays, k_keep = 32 samples)
SLICE_SHAPES = {"distill": (32768, 1), "fast": (8192, 32)}
# the f32 teacher frame's side (run_render --compute_dtype float32)
F32_SIDE = 256
# the examples' small model (examples/refine_nerf_corpus.py and fit_quality.py of the JAX
# package): netdepth 2, netwidth 8 (coarse) and 16 (fine), 8 + 8 samples; its frame's side
SMALL_FIELDS = {"coarse": (2, 8, 8), "fine": (2, 16, 16)}   # depth, width, samples (fine: union)
SMALL_SIDE = 64
SMALL_TURN_MS = 50.0   # CUDA-event time a timed turn of the small model's fields
SMALL_TURNS = 4   # turns a side (kernel and plain version alternating); the median kept
# the fitting phase: run_fit's iterations and pose freeze, the initial pose's rotation off
# the target's, the steady step's warm-ups and timed steps a pyramid level, profiled steps
FIT_ITERS, FIT_FREEZE, FIT_ROTATION_DEG = 100, 30, 5.0
FIT_WARMUP, FIT_TIMED, FIT_PROFILED = 2, 6, 3
# the RefineNet phase: the corpus's render side, the refiner's side (loadSize), its
# training steps and the steady step's timed steps
REFINE_RES, REFINE_SIDE, REFINE_STEPS, REFINE_TIMED = 256, 512, 10, 6
# its WebP route: the committed pair tree (lossy renders, lossless ground truth) and the
# refiner's steps on it before the resume; the shape of the instance-norm gradient check
REFINE_WEBP_DIR = os.path.join(REPO, "mofanerf_tpu_torch", "testdata", "refine_webp")
REFINE_WEBP_STEPS, NORM_CHECK_SHAPE = 4, (1, 64, 32, 32)
# the wild-photo phase: the face family's side, identities, expressions, every k-th view of
# 120 and held-out views an expression; photo A's canvas (w, h) and its similarity (degrees,
# scale); run_fit's iterations; the mean |A - B| allowed between the two aligned photos
WILD_SIDE, WILD_IDS, WILD_EXPS, WILD_STRIDE, WILD_HOLDOUT = 512, 2, (0, 1), 4, 4
WILD_CANVAS, WILD_WARP, WILD_FIT_ITERS, WILD_AB_TOL = (640, 480), (12.0, 0.75), 20, 0.02
# the device-data phase: steps after the training phase's last checkpoint, steps a chunk,
# (i_print, i_weights) that the chunk divides neither of, steps a timed turn
DD_STEPS, DD_CHUNK, DD_INTERVALS, DD_TIMED = 16, 4, (5, 6), 8
# the image formats phase: the committed files, run_fit's iterations on D's relit photo,
# run_train's steps with the progressive UV map, (progressive, baseline) pairs of turns of
# the 1024^2 photo's decode (and of the WebP photo's against the WebP face render's), and
# (arithmetic, progressive) pairs of turns of the arithmetic photo's, more of them: its ratio
# to the progressive decode spread from 1.12x to 1.43x over two runs of 2 turns
FORMATS_DIR = os.path.join(REPO, "mofanerf_tpu_torch", "testdata", "formats")
FORMATS_FIT_ITERS, FORMATS_TRAIN_STEPS, FORMATS_DECODE_TURNS = 10, 2, 2
FORMATS_ARITH_TURNS = 6
FORMATS_WEBP = {"lossy": "photo_1024_q80.webp", "lossless": "face_512_lossless.webp"}
FORMATS_ARITH = {"arithmetic": "photo_1024_arith.jpg", "progressive": "photo_1024_progressive.jpg"}
# the wild photos of the formats phase: the progressive D, its arithmetic-coded E, the smoothed F
FORMATS_PHOTOS = {"D": "progressive 4:2:0", "E": "progressive arithmetic-coded 4:2:0",
                  "F": "progressive, ended before its last refinement scans: smoothed"}

# the examples phase (mofanerf_tpu_torch/examples), after the formats phase: distill_morphable
# at half its JAX budgets (3000 + 9000 steps took over the 150 s given it on the card), the
# other seven at their quick size: --quick (distill_synthetic's teacher cut to 400 steps of its
# 2000), or --iters 400 where the JAX script has no --quick; texture_synthetic at 800 of its 2500,
# under deterministic algorithms (the study's mode since PR 17): its seed's one trajectory, which
# passes. The recipe's densities die in some runs: with the card's atomics 5 of 8 at 2500 and
# 1 of 6 at 800, and from 1 of 8 starts perturbed at rounding size at 800, on an H100 80GB HBM3
# at 700.00 W (PERF.md, PR 16-17);
# 2500 would outlast EXAMPLES_TIMEOUT. (study, argv, JSON written)
EXAMPLES_RUNS = (
    ("distill_morphable", ["--out", "@OUT", "--iters", "1500", "--distill_steps", "4500"],
     "avatar_student_quality.json"),
    ("train_synthetic", ["--out", "@OUT", "--iters", "400"], "train_synthetic.json"),
    ("expression_synthetic", ["@OUT", "--iters", "400"], "expression_synthetic.json"),
    ("texture_synthetic", ["@OUT", "--iters", "800"], "texture_synthetic.json"),
    ("morphable_synthetic", ["--out", "@OUT", "--iters", "400"], "morphable_synthetic.json"),
    ("distill_synthetic", ["--out", "@OUT", "--quick", "--iters", "400"], "distill_quality.json"),
    ("distill_expression", ["--out", "@OUT", "--quick"], "cond_student_quality.json"),
    ("distill_scenes", ["--out", "@OUT", "--quick"], "distill_scenes.json"),
)
EXAMPLES_TIMEOUT = 400.0   # s for the eight studies together
# the kernels at the studies' shapes: f32 fields (depth, width, rays, samples a ray) and
# bf16 students (depth, width, multires, rays a packet, samples a ray); the launches of
# the kernels line are the examples phase's at each shape (the wrappers' launch_shapes)
EXAMPLE_FIELDS = {"coarse": (8, 64, 4096, 32), "fine": (8, 128, 4096, 64),
                  "distill": (8, 128, 8192, 1)}
EXAMPLE_STUDENTS = {"avatar": (4, 128, 10, 1024, 32), "quick": (3, 32, 6, 4096, 16)}


def example_shape(label):
    """The wrapper's launch_shapes key of a kernels-line row of the studies' shapes."""
    if label in EXAMPLE_FIELDS:
        return ("field", ("float32",) + EXAMPLE_FIELDS[label])
    return ("serve", ("bfloat16",) + EXAMPLE_STUDENTS[label])


def fail(failures, msg):
    print(f"FAIL: {msg}", flush=True)
    failures.append(msg)


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def in_turns(runs, min_iters=10):
    """Each of `runs` (name -> call) timed in SMALL_TURNS alternating turns (a, b, b, a, ...)
    of about SMALL_TURN_MS by CUDA events (at least `min_iters` launches), the launches of
    a turn calibrated first: (medians, turns, launches a turn)."""
    names = list(runs)
    iters = {k: max(min_iters, int(SMALL_TURN_MS / cuda_ms(fn, iters=min(5, min_iters),
                                                          warmup=2)))
             for k, fn in runs.items()}
    turns = {k: [] for k in names}
    for turn in (names + names[::-1]) * (SMALL_TURNS // 2):
        turns[turn].append(cuda_ms(runs[turn], iters=iters[turn], warmup=1))
    return {k: float(np.median(v)) for k, v in turns.items()}, turns, iters


def field_flops_per_point(cfg, n_layers):
    """Operations of the conditioned field for one point: the embedding
    layer, the hidden stack, the view layer and the two output heads."""
    W, pe = cfg.width, cfg.pts_embed_dim
    return 2 * (pe * W + n_layers * W * W + W * (W // 2) + W + 3 * (W // 2))


def field_weight_bytes(cfg, n_layers, esize):
    W, W2, pe = cfg.width, cfg.width // 2, cfg.pts_embed_dim
    weights = (pe * W + n_layers * W * W + W * W2 + W + 3 * W2) * esize
    biases = (W + n_layers * W + W2 + 4) * 4
    return weights + biases


def field_io_bytes(cfg, n_rows, n_rays):
    """Embedded points and per-ray view features in (f32), [N, 4] f32 out."""
    return n_rows * cfg.pts_embed_dim * 4 + n_rays * (cfg.width // 2) * 4 + n_rows * 16


def flops_per_sample(depth, width, multires):
    w2 = width // 2
    return 2 * ((3 + 6 * multires) * width + depth * width * width
                + width * (w2 + 1) + w2 * 3)


def kernel_bytes(n_rays, depth, width, multires, esize):
    w2 = width // 2
    per_ray = 12 + 12 + 16 + w2 * esize + 32   # o, d, aux, dirf in; 8 floats out
    weights = ((3 + 6 * multires) * width + depth * width * width + width
               + width * w2 + w2 * 3) * esize
    biases = (width + depth * width + 1 + w2 + 3) * 4
    return n_rays * per_ray + weights + biases


def kernel_rays(n, seed, device):
    """Origins at (0, 0, 16), directions toward the head with spread and
    unnormalised lengths; the first n/8 point away (misses)."""
    import torch

    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0.0, 0.0, 16.0]], np.float32), (n, 1))
    to = rng.standard_normal((n, 3)) * np.array([1.5, 1.5, 0.2]) - [0, 0, 16]
    rd = to / np.linalg.norm(to, axis=-1, keepdims=True) * rng.uniform(0.7, 1.4, (n, 1))
    rd[: n // 8] = [0.0, 0.0, 1.0]
    return (torch.from_numpy(ro).to(device),
            torch.from_numpy(rd.astype(np.float32)).to(device))


def kernel_phase(failures, dev, n_rays=N_KERNEL):
    import torch

    from mofanerf_tpu_torch.models.student import StudentConfig, init_student_params
    from mofanerf_tpu_torch.ops import serve_kernel as sk

    aabb = ((-2.0,) * 3, (2.0,) * 3)
    ro, rd = kernel_rays(n_rays, 0, dev)
    rows = {}
    for dt_name, dt, design in (("bfloat16", torch.bfloat16, "wgmma"),
                                ("float32", torch.float32, "mma.sync")):
        cfg = StudentConfig(depth=D, width=W, multires=MR, compute_dtype=dt)
        if sk.uses_wgmma(cfg, S) != (design == "wgmma"):
            fail(failures, f"serving kernel {dt_name} would not run the {design} design")
        params = init_student_params(torch.Generator().manual_seed(0), cfg, device=dev)
        params["sigma"]["b"] = params["sigma"]["b"] + 1.5   # visible structure
        pack = sk.pack_student(params, cfg)
        aux, dirf = sk.ray_operands(pack, cfg, ro, rd, 8.0, 26.0, *aabb)
        hit = aux[:, 2] > 0
        n_hit = int(hit.sum())
        errs = []
        for white in (False, True):
            got = sk._serve_cuda(pack, aux, dirf, cfg, ro, rd, S, white)
            torch.cuda.synchronize()
            ref = sk._serve_ref(pack, aux, dirf, cfg, ro, rd, S, white)
            tol = TOL[dt_name]
            err_px = float((got[:, :4] - ref[:, :4]).abs().max())
            errs.append(err_px)
            close = torch.isclose(got[:, :6], ref[:, :6], rtol=tol, atol=tol)
            # disp = 1/depth-ish: f32 sums in another order move it by ~1e-3 relative
            close[:, 5] = torch.isclose(got[:, 5], ref[:, 5], rtol=max(tol, 1e-3), atol=max(tol, 1e-3))
            bad = int((~close).sum())
            bg = 1.0 if white else 0.0
            miss = ~hit
            miss_exact = bool((got[miss, 0:3] == bg).all() and (got[miss, 3] == 0).all()
                              and (got[miss, 5] == 1e10).all())
            finite = bool(torch.isfinite(got).all())
            print(f"kernel {dt_name} ({design}) white_bkgd={white}: max|kernel-plain| rgb/acc "
                  f"{err_px:.3e} (tol {tol}), depth "
                  f"{float((got[:, 4] - ref[:, 4]).abs().max()):.3e}, "
                  f"elements outside tol {bad}, misses exact background {miss_exact}, "
                  f"finite {finite}, hits {n_hit}/{n_rays}", flush=True)
            if bad or not miss_exact or not finite:
                fail(failures, f"kernel {dt_name} white_bkgd={white} disagrees with its plain version")
        ms = cuda_ms(lambda: sk._serve_cuda(pack, aux, dirf, cfg, ro, rd, S, False), iters=50)
        plain_ms = cuda_ms(lambda: sk._serve_ref(pack, aux, dirf, cfg, ro, rd, S, False),
                           iters=5, warmup=1)
        esize = 2 if dt == torch.bfloat16 else 4
        peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
        ops_count = n_hit * S * flops_per_sample(D, W, MR)
        t_ops = ops_count / peak * 1e3
        # every row computed, misses included: what a design that skips nothing needs
        t_all = n_rays * S * flops_per_sample(D, W, MR) / peak * 1e3
        t_bytes = kernel_bytes(n_rays, D, W, MR, esize) / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        rows[dt_name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                         "max_abs_err": max(errs), "design": design}
        print(f"kernel {dt_name} ({design}): {ms:.4f} ms a launch of {n_rays} rays x {S} samples "
              f"(plain PyTorch {plain_ms:.3f} ms); bound {bound:.4f} ms "
              f"({rows[dt_name]['bound_by']}: {ops_count / 1e9:.2f} GFLOP over hit rays), "
              f"{bound / ms:.1%} of bound; every row's work {t_all:.4f} ms "
              f"({t_all / ms:.1%})", flush=True)
        if design == "wgmma":
            # the items (64 sample rows, 64 / S whole rays) the kernel itself counts as
            # skipped in one launch, against those the hit mask says have no hit ray
            sk.items_skipped(dev)
            sk._serve_cuda(pack, aux, dirf, cfg, ro, rd, S, False)
            skipped = sk.items_skipped(dev)
            n_items = -(-n_rays * S // 64)
            want = sk.items_all_missing(hit, S)
            print(f"kernel {dt_name} ({design}): items skipped {skipped} of {n_items} "
                  f"({skipped / n_items:.1%}), counted by the kernel; the hit mask has "
                  f"{want} items with no hit ray", flush=True)
            if skipped != want:
                fail(failures, f"the serving kernel skipped {skipped} items, the hit mask "
                               f"has {want} with no hit ray")
    return rows


def field_inputs(cfg, w_dirs, n_rays, n_samples, seed, dev):
    """Embedded sample points and per-ray view features as the renderer makes
    them: rays from (0, 0, 16) toward the head, depths evenly over [8, 26]."""
    import torch

    from mofanerf_tpu_torch.ops.embed import fourier_embed

    ro, rd = kernel_rays(n_rays, seed, dev)
    z = torch.linspace(8.0, 26.0, n_samples, device=dev)
    pts = ro[:, None, :] + rd[:, None, :] * z[None, :, None]
    pe = fourier_embed(pts.reshape(-1, 3), cfg.multires).contiguous()
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    dirf = (fourier_embed(viewdirs, cfg.multires_views) @ w_dirs).contiguous()
    return pe, dirf


def point_inputs(cfg, w_dirs, n, seed, dev):
    """Embedded points and view features as distillation makes them: points
    uniform in the head's box, a random unit direction each (one sample a ray)."""
    import torch

    from mofanerf_tpu_torch.ops.embed import fourier_embed

    gen = torch.Generator().manual_seed(seed)
    pts = (torch.rand((n, 3), generator=gen) * 10.0 - 5.0).to(dev)
    dirs = torch.randn((n, 3), generator=gen).to(dev)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    pe = fourier_embed(pts, cfg.multires).contiguous()
    return pe, (fourier_embed(dirs, cfg.multires_views) @ w_dirs).contiguous()


def field_kernel_phase(failures, dev):
    """Kernel B1 against its plain version at full width: both fields, bf16
    and f32, at ragged shapes and at the packet shape of the teacher path;
    the fine field also at distillation's and --fast's shapes (SLICE_SHAPES).
    Each timed shape is held sharply in bf16 with contracting weights too."""
    import torch

    from mofanerf_tpu_torch.bridge import map_tree
    from mofanerf_tpu_torch.models.field import (FieldConfig, fold_conditioning,
                                                 init_field_params)
    from mofanerf_tpu_torch.ops import field_kernel as fk

    def both(fused, pe, dirf, cfg, ns):
        """Kernel and plain version on the same operands, and the plain version's ms."""
        with torch.no_grad():
            got = torch.cat(fk.fused_field_apply(fused, pe, dirf, cfg, ns), dim=-1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = torch.cat(fk.fused_field_apply_ref(fused, pe, dirf, cfg, ns), dim=-1)
            torch.cuda.synchronize()
        return got, ref, (time.perf_counter() - t0) * 1e3

    def hold(name, dt_name, fused, pe, dirf, cfg, n_rays, ns, block):
        """The kernel against its plain version at one shape: (max |diff|, the
        plain version's ms)."""
        got, ref, ref_time = both(fused, pe, dirf, cfg, ns)
        # tolerance scaled to the output's magnitude. f32: only the order of the
        # sums differs, so this is the sharp check of the layer plan. bf16: a sum in
        # another order lands across a rounding boundary of a layer's output now and
        # then, the next layer spreads that one-ulp change over its whole width, and
        # with full-gain random weights up to 25 layers carry it on: the two versions
        # end about one bf16 ulp a layer apart in the rms and a few percent apart at
        # the worst of a million points, so bf16 is held in the max and in the rms
        # here (the 99.9% quantile is printed as a reading), and sharply with
        # contracting weights below.
        scale = max(1.0, float(ref.abs().max()))
        tol, tol_rms = (t * scale for t in FIELD_TOL[dt_name])
        diff = (got - ref).abs()
        rms = float(diff.square().mean().sqrt())
        k999 = max(1, int(0.999 * diff.numel()))
        q999 = float(diff.flatten().kthvalue(k999).values)
        bad = int((diff > tol).sum()) + int(rms > tol_rms)
        finite = bool(torch.isfinite(got).all())
        ragged = (n_rays * ns) % block != 0
        print(f"field kernel {name} {dt_name} {n_rays} rays x {ns} samples "
              f"(block {block} rows, ragged {ragged}): max|kernel-plain| rgb "
              f"{float(diff[:, :3].max()):.3e} sigma {float(diff[:, 3].max()):.3e} "
              f"rms {rms:.3e} 99.9% {q999:.3e} (tol max {tol:.3e} rms {tol_rms:.3e} = "
              f"{FIELD_TOL[dt_name]} "
              f"x max(1, max|plain| {float(ref.abs().max()):.3f})), outside tol {bad}, "
              f"finite {finite}",
              flush=True)
        if bad or not finite or got.shape != (n_rays * ns, 4):
            fail(failures, f"field kernel {name} {dt_name} {n_rays} x {ns} disagrees with its "
                           f"plain version")
        return float(diff.max()), ref_time

    def hold_sharp(name, params, codes, cfg, pe, dirf, n_rays, ns):
        """The sharp bf16 check: weights x 0.4 contract, so a rounding flip dies
        out instead of growing through the layers, and one wrong tile, swizzled
        chunk or accumulator lane stands out."""
        small = map_tree(lambda w: w * CONTRACT, params)
        fused_c = fk.pack_fused_params(small, fold_conditioning(small, *codes), cfg)
        got, ref, _ = both(fused_c, pe, dirf * CONTRACT, cfg, ns)
        diff = (got - ref).abs()
        bad = int((diff > CONTRACT_ATOL).sum())
        print(f"field kernel {name} bfloat16 {n_rays} rays x {ns} samples, "
              f"weights x {CONTRACT}: max|kernel-plain| rgb {float(diff[:, :3].max()):.3e} "
              f"sigma {float(diff[:, 3].max()):.3e} (atol {CONTRACT_ATOL}; max|plain| "
              f"{float(ref.abs().max()):.3f}), outside tol {bad}", flush=True)
        if bad or not bool(torch.isfinite(got).all()) or float(ref.abs().max()) < 0.05:
            fail(failures, f"field kernel {name} bf16 {n_rays} x {ns} with contracting weights "
                           f"disagrees with its plain version")

    rows = {}
    for name, (depth, width, n_samples) in FIELDS.items():
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            cfg = FieldConfig(depth=depth, width=width, compute_dtype=dt)
            gen = torch.Generator().manual_seed(3)
            params = init_field_params(gen, cfg, device=dev)
            codes = [(torch.randn(n, generator=gen) * s).to(dev)
                     for n, s in ((cfg.shape_dim, 1.0), (cfg.exp_dim, 0.5), (cfg.tex_dim, 0.5))]
            fused = fk.pack_fused_params(params, fold_conditioning(params, *codes), cfg)
            n_layers = fused.w_stack.shape[0]
            block = fk.block_rows(cfg)
            w_dirs = params["view"]["w_dirs"]
            worst = 0.0
            for n_rays, ns in RAGGED + ((333, n_samples - 1),):
                pe, dirf = field_inputs(cfg, w_dirs, n_rays, ns, 5, dev)
                worst = max(worst, hold(name, dt_name, fused, pe, dirf, cfg, n_rays, ns, block)[0])
            # the timed shapes: the teacher's packet, and for the fine field the two
            # shapes of this slice. f32's fine shapes keep the eighth they were cut to
            # while f32 ran FFMA (so that the rows compare with earlier runs), and the
            # whole fine packet is timed too
            part = 1 if (dt == torch.bfloat16 or name == "coarse") else 8
            timed = [("packet", PACKET // part, n_samples)]
            if name == "fine":
                timed += [(label, n // part, ns) for label, (n, ns) in SLICE_SHAPES.items()]
                if dt == torch.float32:
                    timed.append(("packet_full", PACKET, n_samples))
            for label, n_rays, ns in timed:
                if ns == 1:   # distillation: points anywhere in the box, a ray each
                    pe, dirf = point_inputs(cfg, w_dirs, n_rays, 6, dev)
                else:
                    pe, dirf = field_inputs(cfg, w_dirs, n_rays, ns, 5, dev)
                err, ref_time = hold(name, dt_name, fused, pe, dirf, cfg, n_rays, ns, block)
                if dt == torch.bfloat16:
                    hold_sharp(name, params, codes, cfg, pe, dirf, n_rays, ns)
                # the plain version's time is the comparison run above (it repeats the
                # kernel's arithmetic in f32 matmuls)
                n_rows = n_rays * ns
                esize = 2 if dt == torch.bfloat16 else 4
                ops_count = n_rows * field_flops_per_point(cfg, n_layers)
                # f32: the 3xTF32 design's floor (three TF32 products a product on the tensor
                # cores), with the FFMA bound of the f32 work beside it
                t_ffma = ops_count / PEAK_F32 * 1e3
                t_ops = (ops_count / PEAK_BF16 * 1e3 if dt == torch.bfloat16
                         else 3 * ops_count / PEAK_TF32 * 1e3)
                with torch.no_grad():
                    if dt == torch.bfloat16:
                        # about 0.2 s of launches a shape, reckoned at 30% of the peak
                        ms = cuda_ms(lambda: fk.fused_field_apply(fused, pe, dirf, cfg, ns),
                                     iters=max(2, min(20, int(60.0 / t_ops))), warmup=1)
                        turns = None
                    else:
                        # f32: the kernel and its plain version in turns (kernel, plain,
                        # plain, kernel), CUDA events, ~0.4 s of the plain version a turn
                        iters = max(1, min(10, int(400.0 / max(ref_time, 1e-3))))
                        runs = {"kernel": lambda: fk.fused_field_apply(fused, pe, dirf, cfg, ns),
                                "plain": lambda: fk.fused_field_apply_ref(fused, pe, dirf, cfg,
                                                                          ns)}
                        turns = {"kernel": [], "plain": []}
                        for turn in ("kernel", "plain", "plain", "kernel"):
                            turns[turn].append(cuda_ms(runs[turn], iters=iters, warmup=1))
                        ms = sum(turns["kernel"]) / 2
                        ref_time = sum(turns["plain"]) / 2
                w_bytes = field_weight_bytes(cfg, n_layers, esize)
                t_bytes = (field_io_bytes(cfg, n_rows, n_rays) + w_bytes) / PEAK_BYTES * 1e3
                # what the design's weight traffic (every row block streams the whole stack
                # once; f32 its high and low parts) would take out of device memory. Not a
                # floor: CTAs in flight walk the stack together and mostly hit L2, so the
                # kernel may run under it
                t_stream = (-(-n_rows // block) * w_bytes * (1 if dt == torch.bfloat16 else 2)
                            / PEAK_BYTES * 1e3)
                bound = max(t_ops, t_bytes)
                key = (name, dt_name) if label == "packet" else (name, dt_name, label)
                rows[key] = {
                    "ms": ms, "plain_ms": ref_time, "bound_ms": bound,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    # the packet's entry also covers the ragged checks before it
                    "max_abs_err": max(worst, err) if label == "packet" else err,
                    "rays": n_rays, "samples": ns,
                    "block_rows": block}
                if turns is not None:
                    rows[key].update(ffma_bound_ms=t_ffma, turns_ms=turns)
                    print(f"field kernel {name} f32 ({label}) in turns: kernel "
                          f"{', '.join(f'{v:.3f}' for v in turns['kernel'])} ms, plain "
                          f"{', '.join(f'{v:.3f}' for v in turns['plain'])} ms; FFMA bound "
                          f"{t_ffma:.3f} ms ({t_ffma / ms:.1%}), 3xTF32 bound {t_ops:.3f} ms; "
                          f"{ref_time / ms:.2f}x the plain version's speed", flush=True)
                print(f"field kernel {name} {dt_name} ({label}): {ms:.3f} ms a launch of "
                      f"{n_rays} rays x {ns} samples (plain PyTorch {ref_time:.3f} ms); "
                      f"operations bound {t_ops:.3f} ms ({ops_count / 1e12:.3f} TFLOP"
                      f"{'' if dt == torch.bfloat16 else ' of f32, three TF32 products each'}), "
                      f"bytes-once bound {t_bytes:.4f} ms; this design's weight traffic "
                      f"{t_stream:.3f} ms ({-(-n_rows // block)} row blocks x {w_bytes / 1e6:.2f} MB "
                      f"at device-memory rate, not a floor: the stream mostly hits L2); "
                      f"{bound / ms:.1%} of bound", flush=True)
    return rows


def layer_matmul_phase(dev):
    """A yardstick, not on any path: one hidden layer's product at the packet shape of each
    field through torch.matmul (bf16). It says what rate this card gives a K = 1024 and a
    K = 256 product, and so what a fused kernel has to beat to be worth fusing."""
    import torch

    out = {}
    for name, (_, width, n_samples) in FIELDS.items():
        rows = PACKET * n_samples
        gen = torch.Generator().manual_seed(9)
        a = torch.randn((rows, width), generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn((width, width), generator=gen) / width ** 0.5).to(dev, torch.bfloat16)
        ms = cuda_ms(lambda: torch.matmul(a, w), iters=20)
        tflops = 2 * rows * width * width / ms / 1e9
        out[name] = {"rows": rows, "width": width, "ms": ms, "tflops": tflops}
        print(f"yardstick {name}: torch.matmul [{rows} x {width}] @ [{width} x {width}] bf16 "
              f"{ms:.4f} ms, {tflops:.1f} TFLOP/s", flush=True)
    print(json.dumps({"layer_matmul_ms": out}), flush=True)
    return out


def n_packets(n_rays, packet_size, n_eval=None):
    """Packets sweep_rays launches for n_rays (n_eval of them kept by
    compaction) at packet_size, padded to whole 256-ray blocks."""
    p = -(-min(packet_size, n_rays) // 256) * 256
    return -(-(n_rays if n_eval is None else n_eval) // p)


def path_phase(failures, card, dev, H=512):
    import torch

    from mofanerf_tpu_torch.cli import run_render
    from mofanerf_tpu_torch.models.ism import init_ism_params
    from mofanerf_tpu_torch.models.student import StudentConfig, init_student_params
    from mofanerf_tpu_torch.ops import serve_kernel as sk
    from mofanerf_tpu_torch.ops.bounds import ray_aabb_interval
    from mofanerf_tpu_torch.ops.rays import get_rays, pose_spherical
    from mofanerf_tpu_torch.ops.sweep import bucket_fraction
    from mofanerf_tpu_torch.render.renderer import N_EXP_SLOTS, exp_code_for
    from mofanerf_tpu_torch.render.serve import render_frame_serve, render_path_serve
    from mofanerf_tpu_torch.train.distill import save_student, student_code

    from mofanerf_tpu_torch.bridge import map_tree

    gen = torch.Generator().manual_seed(1)
    n_views = 4
    pkt = 16384
    cli_pkt = min(16384, max(256, (H * H) // 4 // 256 * 256))   # run_render's packet
    K = np.array([[1200.0 * H / 512, 0, H / 2], [0, 1200.0 * H / 512, H / 2], [0, 0, 1]],
                 np.float32)
    rig_box = ((-2.0,) * 3, (2.0,) * 3)
    rig_poses = np.stack([pose_spherical(a, -5.0, 16.0) for a in (-30.0, 0.0, 30.0)])
    rig_exps = (0, 9, 14)

    # a seeded unconditioned bf16 student artifact, served by the CLI
    cfg = StudentConfig(depth=D, width=W, multires=MR, compute_dtype=torch.bfloat16)
    params = init_student_params(gen, cfg, device=dev)
    params["sigma"]["b"] = params["sigma"]["b"] + 1.5
    # a seeded teacher ISM + expression bank and an expression-conditioned student
    model = {"ism": init_ism_params(gen, device=dev),
             "exp_codes": torch.rand((N_EXP_SLOTS, 30), generator=gen).to(dev)}
    shape_code = torch.randn(50, generator=gen).to(dev)
    ccfg = StudentConfig(depth=D, width=W, multires=MR, cond_dim=30,
                         compute_dtype=torch.bfloat16)
    cparams = init_student_params(gen, ccfg, device=dev)
    cparams["sigma"]["b"] = cparams["sigma"]["b"] + 1.5
    cparams["cond"]["w_layers"] = (torch.randn((D, 30, W), generator=gen) * 0.05).to(dev)

    # expected launches: 16 a 512^2 frame for the CLI; the rig's sweep
    # compacts to its bucketed hit budget
    rig_rays = [get_rays(H, H, torch.as_tensor(K, device=dev),
                         torch.as_tensor(p[:3], device=dev)) for p in rig_poses]
    ro = torch.cat([o.reshape(-1, 3) for o, _ in rig_rays])
    rd = torch.cat([d.reshape(-1, 3) for _, d in rig_rays])
    _, _, hit = ray_aabb_interval(ro, rd, *rig_box, 8.0, 26.0)
    n_rig = ro.shape[0]
    frac = bucket_fraction(float(hit.float().mean()))
    p = -(-min(pkt, n_rig) // 256) * 256
    m = n_rig if frac >= 1.0 else min(-(-int(n_rig * frac) // p) * p, n_rig)
    expected = n_views * n_packets(H * H, cli_pkt) + len(rig_exps) * n_packets(n_rig, pkt, m)

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        art = os.path.join(tmp, "student.npz")
        save_student(art, params, cfg)

        # ---- the main path: counts zeroed just before, read just after
        torch.cuda.synchronize()
        sk.launch_count = 0
        t0 = time.perf_counter()
        frames = run_render.main(["--out_dir", os.path.join(tmp, "orbit"),
                                  "--student_path", art, "--n_views", str(n_views),
                                  "--render_factor", str(512 // H), "--n_samples", str(S),
                                  "--device", str(dev)])
        t_cli = time.perf_counter() - t0
        rig = []
        t0 = time.perf_counter()
        for e in rig_exps:
            code = student_code(model, shape_code, exp_code_for(model, e))
            out = render_path_serve(cparams, ccfg, code, rig_poses, H, H, K,
                                    n_samples=S, aabb_min=rig_box[0], aabb_max=rig_box[1],
                                    packet_size=pkt, hit_fraction=None)
            rig.append({k: v.float().cpu().numpy() for k, v in out.items()})
        torch.cuda.synchronize()
        t_rig = time.perf_counter() - t0
        launches = sk.launch_count
        n_png = len([f for f in os.listdir(os.path.join(tmp, "orbit")) if f.endswith(".png")])

    print(f"path: CLI served {frames.shape[0]} frames {frames.shape[1]}x{frames.shape[2]} "
          f"in {t_cli:.3f} s ({n_png} PNGs); rig of {len(rig_poses)} poses x "
          f"{len(rig_exps)} codes in {t_rig:.3f} s (hit budget {frac}); "
          f"kernel launches {launches} (expected {expected})", flush=True)
    if launches != expected or launches == 0:
        fail(failures, f"kernel launch count {launches} != expected {expected}")
    if frames.shape != (n_views, H, H, 3) or n_png != n_views:
        fail(failures, f"CLI output shape {frames.shape}, {n_png} PNGs")
    for name, arr in [("cli rgb", frames)] + [(f"rig {e} {k}", r[k]) for e, r in zip(rig_exps, rig)
                                              for k in ("rgb", "acc")]:
        if not np.isfinite(arr).all() or arr.min() < 0.0 or arr.max() > 1.0 + 1e-5:
            fail(failures, f"{name} not finite or outside [0, 1]: "
                           f"[{np.nanmin(arr)}, {np.nanmax(arr)}]")
    for e, r in zip(rig_exps, rig):
        if r["rgb"].shape != (len(rig_poses), H, H, 3) or not (r["acc"] > 0.5).any():
            fail(failures, f"rig expression {e}: shape {r['rgb'].shape} or empty scene")

    # agreement with the CPU render (plain PyTorch) on a small frame
    code = student_code(model, shape_code, exp_code_for(model, rig_exps[1]))
    Ks = np.array([[150.0, 0, 32.0], [0, 150.0, 32.0], [0, 0, 1]], np.float32)
    small = dict(n_samples=S, aabb_min=rig_box[0], aabb_max=rig_box[1], packet_size=1024,
                 hit_fraction=None)
    on_card = render_frame_serve(cparams, ccfg, code, 64, 64, Ks, rig_poses[1][:3], **small)
    cpu = map_tree(lambda t: t.cpu(), cparams)
    on_cpu = render_frame_serve(cpu, ccfg, code.cpu(), 64, 64, Ks, rig_poses[1][:3], **small)
    err = max(float((on_card[k].cpu() - on_cpu[k]).abs().max()) for k in ("rgb", "acc"))
    print(f"path: 64x64 frame, card vs CPU max |diff| rgb/acc {err:.3e} (tol 2e-2)", flush=True)
    if not err <= 2e-2:
        fail(failures, f"card and CPU renders differ by {err}")

    # steady-state serving speed of one 512^2 frame (hit_fraction 1.0)
    def frame():
        render_frame_serve(params, cfg, None, H, H, K, rig_poses[1][:3], n_samples=S,
                           packet_size=pkt, hit_fraction=1.0)
    frame()
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        frame()
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / reps
    print(f"path: {sec:.5f} s per 512x512 frame, {H * H / sec:.0f} rays/s "
          f"(bf16 4x128 student, 32 samples, packets of {pkt}) on {card}", flush=True)
    print(f"path: rig {t_rig / (len(rig_exps) * len(rig_poses)):.5f} s per 512x512 frame "
          f"(hit budget {frac}) on {card}", flush=True)
    profile_frames(frame, reps, card)
    return launches


def profile_frames(frame, reps, card):
    """Where a serving frame's time goes: torch.profiler over `reps` frames, the
    card's busy share (kernel time over wall time) and the kernels that fill it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            frame()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
              for e in kernels}
    busy = sum(dev_us.values()) / 1e6
    if busy <= 0:
        print("path: profiled frame: no device time in the trace (busy share not measured)",
              flush=True)
        return
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
    print(f"path: profiled {reps} frames: {wall / reps * 1e3:.3f} ms a frame under the profiler, "
          f"card busy {busy / reps * 1e3:.3f} ms a frame ({busy / wall:.1%}, idle "
          f"{1 - busy / wall:.1%}) in {len(dev_us)} kernels; top: "
          + "; ".join(f"{k[:48]} {v / reps / 1e3:.3f} ms" for k, v in top) + f" on {card}",
          flush=True)
    host = sorted((e for e in prof.key_averages() if e.device_type != torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    print("path: profiled frames, host time by operation (self, ms a frame, calls a frame): "
          + "; ".join(f"{e.key} {e.self_cpu_time_total / reps / 1e3:.3f} "
                      f"({e.count / reps:.0f})" for e in host), flush=True)


def shape_density(field_params, cfg, cond, pe_probe):
    """Give a seeded random field visible structure: rescale and shift its
    alpha head so that raw sigma over the probe points has median 0 and
    spread 3 (a random ReLU field's raw sigma has nearly one sign)."""
    import torch

    from mofanerf_tpu_torch.models.field import apply_field_sigma

    alpha = field_params["sigma"]["alpha"]
    with torch.no_grad():
        sig = apply_field_sigma(field_params, cond, pe_probe,
                                dataclasses.replace(cfg, compute_dtype=torch.float32))
        gain = 3.0 / float(sig.std())
        alpha["w"] = alpha["w"] * gain
        alpha["b"] = (alpha["b"] - sig.median()) * gain


def teacher_path_phase(failures, card, dev, field_rows, H=TEACHER_SIDE):
    """The teacher two-pass render at full width through the port's entry
    points: the CLI's teacher route, then render_path with a cond a pose."""
    import torch

    from mofanerf_tpu_torch.bridge import map_tree
    from mofanerf_tpu_torch.cli import run_render
    from mofanerf_tpu_torch.config import Config
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.ops.embed import fourier_embed
    from mofanerf_tpu_torch.ops.rays import pose_spherical
    from mofanerf_tpu_torch.render.renderer import (FrameCond, encode_texture, exp_code_for,
                                                    init_model_params, prepare_conditioning,
                                                    render_frame, render_path)

    spec = Config().model_spec()   # the CLI's default: coarse 8x256, fine 10x1024, bf16
    n_views = 2
    path_poses = np.stack([pose_spherical(-25.0, -5.0, 16.0), pose_spherical(30.0, 5.0, 16.0)])
    path_exps = (3, 14)
    packets = -(-H * H // spec.render.packet_size)
    expected = 2 * packets * (n_views + len(path_poses))   # a coarse and a fine launch a packet

    # set-up: a seeded full-width model, a seeded UV map through the texture
    # encoder, one folded conditioning an expression
    gen = torch.Generator().manual_seed(7)
    t0 = time.perf_counter()
    params = init_model_params(gen, spec, device=dev)
    uv = torch.rand((spec.uv_size, spec.uv_size, 3), generator=gen).to(dev)
    shape_code = torch.randn(spec.shape_dim, generator=gen).to(dev)
    with torch.no_grad():
        tex = encode_texture(params, spec, uv)
        conds = [prepare_conditioning(params, spec, shape_code, exp_code_for(params, e), tex)
                 for e in path_exps]
    probe_o, probe_d = kernel_rays(2048, 11, dev)
    probe = probe_o[:, None, :] + probe_d[:, None, :] * torch.linspace(8.0, 26.0, 16, device=dev)[:, None]
    for name, cond in (("coarse", conds[0].coarse), ("fine", conds[0].fine)):
        cfg = getattr(spec, name)
        shape_density(params[name], cfg, cond, fourier_embed(probe.reshape(-1, 3), cfg.multires))
    torch.cuda.synchronize()
    print(f"teacher path: model init + texture encoder + conditioning in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cpu_params = map_tree(lambda t: t.cpu(), params)
    with torch.no_grad():
        tex_cpu = encode_texture(cpu_params, spec, uv.cpu())
    tex_err = float((tex.cpu() - tex_cpu).abs().max())
    # f32 convolutions and products on both sides: sum order only
    print(f"teacher path: texture code {tuple(tex.shape)}, card vs CPU max |diff| {tex_err:.3e} "
          f"(tol 1e-4 x max|code| {float(tex_cpu.abs().max()):.3f})", flush=True)
    if tex.shape != (spec.tex_dim,) or not tex_err <= 1e-4 * max(1.0, float(tex_cpu.abs().max())):
        fail(failures, f"texture code differs between card and CPU by {tex_err}")

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        # ---- the main path: counts zeroed just before, read just after
        torch.cuda.synchronize()
        fk.launch_count = 0
        t0 = time.perf_counter()
        frames = run_render.main(["--out_dir", os.path.join(tmp, "teacher"),
                                  "--n_views", str(n_views), "--render_factor", str(512 // H),
                                  "--basedir", os.path.join(tmp, "logs"),
                                  "--uvdir", os.path.join(tmp, "uv"),
                                  "--shape_codes_path", os.path.join(tmp, "none.npy"),
                                  "--device", str(dev)])
        t_cli = time.perf_counter() - t0
        t0 = time.perf_counter()
        rgbs, disps = render_path(params, spec, conds, path_poses, (512, 512, 1200.0),
                                  render_factor=512 // H)
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t0
        launches = fk.launch_count
        n_png = len([f for f in os.listdir(os.path.join(tmp, "teacher")) if f.endswith(".png")])

    sec = t_path / len(path_poses)
    print(f"teacher path: CLI rendered {frames.shape[0]} frames {frames.shape[1]}x"
          f"{frames.shape[2]} in {t_cli:.3f} s ({n_png} PNGs, model init included); "
          f"render_path {len(path_poses)} poses x 1 expression each in {t_path:.3f} s; "
          f"field kernel launches {launches} (expected {expected}: a coarse and a fine one "
          f"a packet)", flush=True)
    print(f"teacher path: {sec:.4f} s per {H}x{H} frame, {H * H / sec:.0f} rays/s "
          f"(bf16 coarse 8x256 + fine 10x1024, 64 + 64 samples, packets of "
          f"{spec.render.packet_size}) on {card}", flush=True)
    kernel_s = packets * sum(field_rows[(name, "bfloat16")]["ms"] for name in FIELDS) / 1e3
    print(f"teacher path: {packets} packets x (coarse + fine launch, as timed in the kernel "
          f"phase) = {kernel_s:.4f} s, {kernel_s / sec:.1%} of the frame; the rest "
          f"({(sec - kernel_s) / packets * 1e3:.2f} ms a packet) is sampling, embedding and "
          f"compositing between the launches", flush=True)
    if launches != expected or launches == 0:
        fail(failures, f"field kernel launch count {launches} != expected {expected}")
    if frames.shape != (n_views, H, H, 3) or n_png != n_views:
        fail(failures, f"teacher CLI output shape {frames.shape}, {n_png} PNGs")
    if rgbs.shape != (len(path_poses), H, H, 3) or disps.shape != (len(path_poses), H, H):
        fail(failures, f"render_path output shapes {rgbs.shape}, {disps.shape}")
    for name, arr in (("teacher cli rgb", frames), ("render_path rgb", rgbs)):
        if not np.isfinite(arr).all() or arr.min() < 0.0 or arr.max() > 1.0 + 1e-5:
            fail(failures, f"{name} not finite or outside [0, 1]: "
                           f"[{np.nanmin(arr)}, {np.nanmax(arr)}]")
    if not np.isfinite(disps).all():
        fail(failures, "render_path disp not finite")
    if np.abs(rgbs[0] - rgbs[1]).max() == 0.0:
        fail(failures, "render_path: two poses and expressions gave the same frame")

    # a small frame on the card against the same frame on the CPU (the plain
    # version), every output key. f32: sum order only, through 25 layers and
    # two compositing passes. bf16: sum order moves layer outputs across
    # rounding boundaries, and the importance samples follow the coarse weights.
    Ks = np.array([[40.0, 0, 6.0], [0, 40.0, 6.0], [0, 0, 1]], np.float32)
    cpu_cond = FrameCond(*[map_tree(lambda t: t.cpu(), c) for c in conds[0]])
    for dt, tol in ((torch.float32, 2e-3), (torch.bfloat16, 6e-2)):
        sspec = dataclasses.replace(
            spec, coarse=dataclasses.replace(spec.coarse, compute_dtype=dt),
            fine=dataclasses.replace(spec.fine, compute_dtype=dt))
        on_card = render_frame(params, sspec, conds[0], 12, 12, Ks, path_poses[0][:3])
        on_cpu = render_frame(cpu_params, sspec, cpu_cond, 12, 12, Ks, path_poses[0][:3])
        errs = {k: float((on_card[k].cpu() - on_cpu[k]).abs().max()) for k in on_cpu}
        acc_max = float(on_cpu["acc"].max())
        print(f"teacher path: 12x12 frame {dt}, card vs CPU max |diff| "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol {tol} on rgb0 acc0 rgb acc; max acc {acc_max:.3f})", flush=True)
        if not all(errs[k] <= tol for k in ("rgb0", "acc0", "rgb", "acc")):
            fail(failures, f"card and CPU teacher renders differ ({dt}): {errs}")
        if not acc_max > 0.05:
            fail(failures, "teacher render is empty (acc ~ 0 everywhere)")
    return launches, sec


def f32_and_small_phase(failures, card, dev, field_rows, H=F32_SIDE):
    """Two paths the field kernel's 3xTF32 design and its padding serve: a full-width
    teacher frame in f32 through the CLI (`--compute_dtype float32`) and render_path, and
    the JAX package's examples' small model (padded to width 64 by the wrapper) through the
    kernel, f32 and bf16, against its plain version on the card and a frame against the
    CPU's. Each path's launches are counted with the count zeroed just before it."""
    import torch

    from mofanerf_tpu_torch.bridge import map_tree
    from mofanerf_tpu_torch.cli import run_render
    from mofanerf_tpu_torch.config import Config
    from mofanerf_tpu_torch.models.field import FieldConfig, fold_conditioning
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.ops.rays import get_rays, pose_spherical
    from mofanerf_tpu_torch.render.renderer import (MoFaNeRF, RenderConfig, exp_code_for,
                                                    init_model_params, prepare_conditioning,
                                                    render_frame, render_path, render_rays)

    out = {}
    spec = Config(compute_dtype="float32").model_spec()
    packets = -(-H * H // spec.render.packet_size)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        torch.cuda.synchronize()
        fk.launch_count = 0
        t0 = time.perf_counter()
        frames = run_render.main(["--out_dir", os.path.join(tmp, "f32"), "--n_views", "1",
                                  "--render_factor", str(512 // H), "--compute_dtype", "float32",
                                  "--basedir", os.path.join(tmp, "logs"),
                                  "--uvdir", os.path.join(tmp, "uv"),
                                  "--shape_codes_path", os.path.join(tmp, "none.npy"),
                                  "--device", str(dev)])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        cli_launches = fk.launch_count
    # the steady frame: render_path on a seeded f32 model, one pose
    gen = torch.Generator().manual_seed(13)
    params = init_model_params(gen, spec, device=dev)
    with torch.no_grad():
        cond = prepare_conditioning(params, spec, torch.randn(spec.shape_dim, generator=gen).to(dev),
                                    exp_code_for(params, 3),
                                    torch.randn(spec.tex_dim, generator=gen).to(dev))
    pose = pose_spherical(-25.0, -5.0, 16.0)[None]
    render_path(params, spec, [cond], pose, (512, 512, 1200.0), render_factor=512 // H)
    torch.cuda.synchronize()
    fk.launch_count = 0
    t0 = time.perf_counter()
    rgbs, _ = render_path(params, spec, [cond], pose, (512, 512, 1200.0), render_factor=512 // H)
    torch.cuda.synchronize()
    t_frame = time.perf_counter() - t0
    path_launches = fk.launch_count
    kernel_s = packets * (field_rows[("coarse", "float32")]["ms"]
                          + field_rows[("fine", "float32", "packet_full")]["ms"]) / 1e3
    print(f"f32 teacher: run_render --compute_dtype float32 rendered {frames.shape[0]} frame "
          f"{frames.shape[1]}x{frames.shape[2]} in {t_cli:.3f} s (model init included), "
          f"{cli_launches} field kernel launches (expected {2 * packets}); render_path "
          f"{t_frame:.4f} s a {H}x{H} frame, {path_launches} launches; {packets} packets x "
          f"(coarse + fine f32 launch, as timed in the kernel phase) = {kernel_s:.4f} s, "
          f"{kernel_s / t_frame:.1%} of the frame; on {card}", flush=True)
    for label, n, want in (("CLI", cli_launches, 2 * packets), ("render_path", path_launches,
                                                                 2 * packets)):
        if n != want:
            fail(failures, f"f32 teacher {label}: {n} field kernel launches, expected {want}")
    for name, arr in (("f32 teacher CLI", frames), ("f32 render_path", rgbs)):
        if arr.shape[1:3] != (H, H) or not np.isfinite(arr).all() or arr.min() < 0.0 \
                or arr.max() > 1.0 + 1e-5:
            fail(failures, f"{name}: shape {arr.shape} or values outside [0, 1]")
    out["f32_teacher"] = {"side": H, "cli_s": t_cli, "frame_s": t_frame,
                          "launches": cli_launches + path_launches, "kernel_s": kernel_s}
    del params, cond

    # the examples' small model: fields the kernel takes padded (width 64, depth 6)
    small = {}
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        sspec = MoFaNeRF(
            coarse=FieldConfig(depth=SMALL_FIELDS["coarse"][0], width=SMALL_FIELDS["coarse"][1],
                               compute_dtype=dt),
            fine=FieldConfig(depth=SMALL_FIELDS["fine"][0], width=SMALL_FIELDS["fine"][1],
                             compute_dtype=dt),
            render=RenderConfig(n_coarse=SMALL_FIELDS["coarse"][2], n_importance=8),
            uv_size=128)
        gen = torch.Generator().manual_seed(17)
        params = init_model_params(gen, sspec, device=dev)
        codes = [torch.randn(n, generator=gen).to(dev) * 0.3 for n in (50, 30, 256)]
        errs, timing = {}, {}
        for name in ("coarse", "fine"):
            cfg = getattr(sspec, name)
            fused = fk.pack_fused_params(params[name], fold_conditioning(params[name], *codes),
                                         cfg)
            pe, dirf = field_inputs(cfg, params[name]["view"]["w_dirs"], 8192,
                                    SMALL_FIELDS[name][2], 19, dev)
            with torch.no_grad():
                got = torch.cat(fk.fused_field_apply(fused, pe, dirf, cfg,
                                                     SMALL_FIELDS[name][2]), -1)
                torch.cuda.synchronize()
                ref = torch.cat(fk.fused_field_apply_ref(fused, pe, dirf, cfg,
                                                         SMALL_FIELDS[name][2]), -1)
            scale = max(1.0, float(ref.abs().max()))
            tol, tol_rms = (t * scale for t in FIELD_TOL[dt_name])
            diff = (got - ref).abs()
            errs[name] = float(diff.max())
            rms = float(diff.square().mean().sqrt())
            kcfg = fk.kernel_config(cfg)
            print(f"small model {name} {cfg.depth}x{cfg.width} {dt_name} (kernel config "
                  f"{kcfg.depth}x{kcfg.width}), 8192 rays x {SMALL_FIELDS[name][2]}: "
                  f"max|kernel-plain| {errs[name]:.3e} rms {rms:.3e} (tol max {tol:.3e} rms "
                  f"{tol_rms:.3e})", flush=True)
            if not (errs[name] <= tol and rms <= tol_rms) or not bool(torch.isfinite(got).all()):
                fail(failures, f"small model {name} {dt_name}: the kernel disagrees with its "
                               f"plain version")
            # the path's shape (the SMALL_SIDE^2 frame is one packet): the kernel and its plain
            # version in turns (kernel, plain, plain, kernel, ...), CUDA events over about
            # SMALL_TURN_MS a turn, the median turn kept
            n_rays, ns = SMALL_SIDE ** 2, SMALL_FIELDS[name][2]
            pe_t, dirf_t = field_inputs(cfg, params[name]["view"]["w_dirs"], n_rays, ns, 29, dev)
            with torch.no_grad():
                med, turns, iters = in_turns({
                    "kernel": lambda: fk.fused_field_apply(fused, pe_t, dirf_t, cfg, ns),
                    "plain": lambda: fk.fused_field_apply_ref(fused, pe_t, dirf_t, cfg, ns)})
            # the bound of the function the field computes (its own depth and width, f32
            # products at the 3xTF32 rate as the full-width rows take them), and beside it
            # that of the padded shape the kernel runs (kernel_config's depth and width)
            n_layers, n_rows = fused.w_stack.shape[0], n_rays * ns
            esize = 2 if dt == torch.bfloat16 else 4
            bounds = {}
            for shape_name, c in (("field", cfg), ("padded", kcfg)):
                ops_count = n_rows * field_flops_per_point(c, n_layers)
                t_ops = (ops_count / PEAK_BF16 if dt == torch.bfloat16
                         else 3 * ops_count / PEAK_TF32) * 1e3
                t_bytes = (field_io_bytes(c, n_rows, n_rays)
                           + field_weight_bytes(c, n_layers, esize)) / PEAK_BYTES * 1e3
                bounds[shape_name] = (max(t_ops, t_bytes),
                                      "operations" if t_ops >= t_bytes else "bytes", t_ops,
                                      t_bytes)
            timing[name] = {"ms": med["kernel"], "plain_ms": med["plain"],
                            "bound_ms": bounds["field"][0], "bound_by": bounds["field"][1],
                            "padded_bound_ms": bounds["padded"][0],
                            "max_abs_err": errs[name], "rays": n_rays, "samples": ns,
                            "kernel_config": f"{kcfg.depth}x{kcfg.width}", "turns_ms": turns,
                            "iters_a_turn": iters}
            print(f"small model {name} {dt_name} at the frame's shape ({n_rays} rays x {ns} "
                  f"samples) in turns of {iters['kernel']} / {iters['plain']} launches: kernel "
                  f"{', '.join(f'{v:.4f}' for v in turns['kernel'])} ms (median "
                  f"{med['kernel']:.4f}), plain {', '.join(f'{v:.4f}' for v in turns['plain'])} "
                  f"ms (median {med['plain']:.4f}); bound {bounds['field'][0]:.5f} ms by "
                  f"{bounds['field'][1]} ({cfg.depth}x{cfg.width}: operations "
                  f"{bounds['field'][2]:.5f} ms, bytes once {bounds['field'][3]:.5f} ms; padded "
                  f"{kcfg.depth}x{kcfg.width}: {bounds['padded'][0]:.5f} ms by "
                  f"{bounds['padded'][1]}) on {card}", flush=True)
        with torch.no_grad():
            cond = prepare_conditioning(params, sspec, codes[0], exp_code_for(params, 3), codes[2])
        Ks = np.array([[60.0, 0, SMALL_SIDE / 2], [0, 60.0, SMALL_SIDE / 2], [0, 0, 1]],
                      np.float32)
        c2w = pose_spherical(-25.0, -5.0, 16.0)[:3]
        torch.cuda.synchronize()
        fk.launch_count = 0
        on_card = render_frame(params, sspec, cond, SMALL_SIDE, SMALL_SIDE, Ks, c2w)
        torch.cuda.synchronize()
        launches = fk.launch_count
        cpu = map_tree(lambda t: t.cpu(), params)
        cpu_cond = type(cond)(*[map_tree(lambda t: t.cpu(), c) for c in cond])
        on_cpu = render_frame(cpu, sspec, cpu_cond, SMALL_SIDE, SMALL_SIDE, Ks, c2w)
        frame_err = {k: float((on_card[k].cpu() - on_cpu[k]).abs().max()) for k in on_cpu}
        want = 2 * -(-SMALL_SIDE ** 2 // min(sspec.render.packet_size, SMALL_SIDE ** 2))
        # the deterministic frame's coarse pass on every pixel. Its fine pass is not a sharp
        # check here: the importance sampler's last quantile is 1 and jumps between two bin
        # edges on opaque rays at the last bit of the coarse weights (tests/test_torch_
        # renderer.py), which 8 coarse samples a ray make common. The stochastic render of
        # the same rays from the same uniforms (all below 1) holds the coarse pass on every
        # ray and the fine pass as tests/test_torch_renderer.py holds a deterministic one:
        # five elements in six within the tolerance, all within a stated jump. Uniforms in
        # the sampler's last, floor-mass bins of an opaque ray (u near 1) are as ill-
        # conditioned, and with 8 + 8 samples a ray some rays draw one.
        ftol, jump = (2e-3, 5e-2) if dt == torch.float32 else (6e-2, 0.3)
        rays = get_rays(SMALL_SIDE, SMALL_SIDE, torch.as_tensor(Ks, device=dev),
                        torch.as_tensor(c2w, dtype=torch.float32, device=dev))
        ro, rd = (r.reshape(-1, 3) for r in rays)
        ugen = torch.Generator().manual_seed(23)
        draws = {"strat": torch.rand((ro.shape[0], sspec.render.n_coarse), generator=ugen),
                 "pdf": torch.rand((ro.shape[0], sspec.render.n_importance), generator=ugen)
                 .clamp(max=0.999)}
        with torch.no_grad():
            st_card = render_rays(params, sspec, cond, ro, rd, train=True,
                                  draws={k: v.to(dev) for k, v in draws.items()})
            st_cpu = render_rays(cpu, sspec, cpu_cond, ro.cpu(), rd.cpu(), train=True,
                                 draws=draws)
        st_diff = {k: (st_card[k].cpu() - st_cpu[k]).abs().flatten()
                   for k in ("rgb0", "acc0", "rgb", "acc")}
        st_err = {k: float(v.max()) for k, v in st_diff.items()}
        st_q = {k: float(torch.quantile(st_diff[k], 5 / 6)) for k in ("rgb", "acc")}
        print(f"small model {dt_name}: a {SMALL_SIDE}x{SMALL_SIDE} render_frame through the "
              f"field kernel, {launches} launches (expected {want}), card vs CPU max |diff| "
              + ", ".join(f"{k} {v:.2e}" for k, v in frame_err.items())
              + f" (tol {ftol} on rgb0 acc0; max acc {float(on_cpu['acc'].max()):.3f}, "
              f"max rgb {float(on_cpu['rgb'].max()):.3f}); the same rays rendered with "
              f"injected uniforms, card vs CPU max |diff| "
              + ", ".join(f"{k} {v:.2e}" for k, v in st_err.items())
              + ", fine pass 5/6 quantile " + ", ".join(f"{k} {v:.2e}" for k, v in st_q.items())
              + f" (tol {ftol}, fine pass all within {jump})", flush=True)
        if launches != want:
            fail(failures, f"small model {dt_name}: {launches} launches, expected {want}")
        if not all(frame_err[k] <= ftol for k in ("rgb0", "acc0")):
            fail(failures, f"small model {dt_name}: card and CPU frames differ: {frame_err}")
        if not (st_err["rgb0"] <= ftol and st_err["acc0"] <= ftol
                and all(v <= ftol for v in st_q.values())
                and st_err["rgb"] <= jump and st_err["acc"] <= jump):
            fail(failures, f"small model {dt_name}: card and CPU renders from the same "
                           f"uniforms differ: max {st_err}, fine 5/6 quantile {st_q}")
        for k in ("rgb", "acc"):
            if not bool(torch.isfinite(on_card[k]).all()) or float(on_card[k].min()) < 0.0 \
                    or float(on_card[k].max()) > 1.0 + 1e-5:
                fail(failures, f"small model {dt_name}: {k} not finite or outside [0, 1]")
        small[dt_name] = {"max_abs_err": max(errs.values()), "frame_err": frame_err,
                          "stochastic_err": st_err, "stochastic_fine_q56": st_q,
                          "launches": launches, "timing": timing}
    out["small_model"] = small
    return out


def _random_linear(sd, g, key, cout, cin, gain=np.sqrt(2.0)):
    """A torch Linear's weight [out, in] and bias, fan-in scaled (He)."""
    import torch

    sd[f"{key}.weight"] = torch.randn(cout, cin, generator=g) * (gain / np.sqrt(cin))
    sd[f"{key}.bias"] = torch.randn(cout, generator=g) * 0.05


def reference_field_sd(g, depth, width, skip=4, xyz_depth=3, pe=63, ve=27, shape_dim=50,
                       exp_dim=30, tex_dim=256):
    """A NeRF module's state dict in the reference's key layout
    (models/model.py:121-137; the layout mofanerf_tpu/convert.py reads)."""
    sd = {}
    _random_linear(sd, g, "xyzEncode.linears1.Linear0", width, pe + exp_dim)
    for i in range(xyz_depth):
        _random_linear(sd, g, f"xyzEncode.linears1.Linear{i + 1}", width, width)
    for name, code in (("linear_BiM_xyz", shape_dim), ("linear_uv_xyzBiM", tex_dim)):
        _random_linear(sd, g, f"{name}.linears1.Linear0", width, code + width)
        for i in range(skip):
            _random_linear(sd, g, f"{name}.linears1.Linear{i + 1}", width, width)
        _random_linear(sd, g, f"{name}.linears2.Linear0", width, code + 2 * width)
        for i in range(depth - skip - 2):
            _random_linear(sd, g, f"{name}.linears2.Linear{i + 1}", width, width)
    _random_linear(sd, g, "alpha_linear.0", 1, width, gain=1.0)
    _random_linear(sd, g, "linear_view_xyBMuv.0", width // 2, ve + width)
    _random_linear(sd, g, "rgb_linear", 3, width // 2, gain=1.0)
    return sd


def reference_tar(g, step):
    """The reference's training checkpoint (run_train.py:370-379) at full
    width, seeded: coarse 8x256 (saved through DataParallel: `module.`
    prefixes), fine 10x1024, the texture encoder (EnDeUVmap at a 512^2 UV),
    the ISM (StyleModule), 20 [1, 30] expression latents and global_step."""
    import torch

    tex = {}
    chans = (3, 32, 32, 32, 32, 64, 128, 256)
    for n, ci in enumerate(range(0, 14, 2)):
        _random_conv(tex, g, f"encoder.down1.0.{ci}", chans[n + 1], chans[n], 4, bias=True)
    _random_linear(tex, g, "encoder.down2.0", 512, 256 * 4 * 4)
    _random_linear(tex, g, "encoder.mu", 256, 512, gain=1.0)
    for di in (0, 2, 4):
        _random_linear(tex, g, f"encoder.decoding.{di}", 256, 256)
    ism = {}
    for i, cin in enumerate((50, 256, 256, 256)):
        _random_linear(ism, g, f"linears1.Linear{i}", 256, cin)
    _random_linear(ism, g, "linears_scale", 30, 256, gain=1.0)
    _random_linear(ism, g, "linears_bias", 30, 256, gain=1.0)
    coarse = reference_field_sd(g, 8, 256)
    return {"global_step": step,
            "network_fn_state_dict": {f"module.{k}": v for k, v in coarse.items()},
            "network_fine_state_dict": reference_field_sd(g, 10, 1024),
            "network_render_textureEncoder": tex,
            "network_render_idSpecific": ism,
            "optimizer_state_dict": {"state": {}, "param_groups": []},
            "expression_latent_codes_sigma": [torch.randn(1, 30, generator=g) * 0.3
                                              for _ in range(20)]}


def reference_field_forward(sd, depth, skip, xyz_depth, pts_embed, dirs_embed, exp, shape, tex):
    """The reference NeRF.forward (models/model.py:121-137) with F.linear over
    the raw state dict: an oracle independent of the converter."""
    import torch
    import torch.nn.functional as F

    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}

    def mlp(prefix, x, n1, n2):
        h = x
        for i in range(n1):
            h = F.relu(F.linear(h, sd[f"{prefix}.linears1.Linear{i}.weight"],
                                sd[f"{prefix}.linears1.Linear{i}.bias"]))
        if n2:
            h = torch.cat([x, h], dim=1)
            for i in range(n2):
                h = F.relu(F.linear(h, sd[f"{prefix}.linears2.Linear{i}.weight"],
                                    sd[f"{prefix}.linears2.Linear{i}.bias"]))
        return h

    n = pts_embed.shape[0]
    xyz = mlp("xyzEncode", torch.cat([pts_embed, exp.expand(n, -1)], 1), 1 + xyz_depth, 0)
    feat = mlp("linear_BiM_xyz", torch.cat([shape.expand(n, -1), xyz], 1), 1 + skip,
               depth - skip - 1)
    alpha = F.linear(feat, sd["alpha_linear.0.weight"], sd["alpha_linear.0.bias"])
    feat = mlp("linear_uv_xyzBiM", torch.cat([tex.expand(n, -1), feat], 1), 1 + skip,
               depth - skip - 1)
    v = F.relu(F.linear(torch.cat([dirs_embed, feat], 1), sd["linear_view_xyBMuv.0.weight"],
                        sd["linear_view_xyBMuv.0.bias"]))
    return torch.cat([F.linear(v, sd["rgb_linear.weight"], sd["rgb_linear.bias"]), alpha], 1)


def convert_phase(failures, card, dev, H=CONVERT_SIDE):
    """Weights from outside the port: a seeded full-width reference `.tar`
    through the convert_ckpt CLI into a `.pt`, held against the in-process
    conversion, both fields against the F.linear oracle of the reference's
    modules (plain f32 and B1 in bf16), run_render from the converted directory
    through B1 against render_frame, one packet under utils/profiling.trace,
    and bilinear_sample on the card against the CPU."""
    import torch

    from mofanerf_tpu_torch.bridge import map_tree
    from mofanerf_tpu_torch.cli import convert_ckpt
    from mofanerf_tpu_torch.config import Config
    from mofanerf_tpu_torch.convert import convert_checkpoint
    from mofanerf_tpu_torch.models.field import apply_field, fold_conditioning
    from mofanerf_tpu_torch.ops import bilinear_sample
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.ops.embed import fourier_embed
    from mofanerf_tpu_torch.ops.rays import get_rays, pose_spherical
    from mofanerf_tpu_torch.render.renderer import (exp_code_for, prepare_conditioning,
                                                    render_frame, render_rays)
    from mofanerf_tpu_torch.train.checkpoint import restore_checkpoint
    from mofanerf_tpu_torch.utils import profiling
    from mofanerf_tpu_torch.utils.tree import flatten_with_keystr

    spec = Config().model_spec()   # the CLIs' default: coarse 8x256, fine 10x1024, bf16
    n_views, step = 2, 123456
    packets = -(-H * H // spec.render.packet_size)
    expected = 2 * packets * n_views
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        tar = os.path.join(tmp, "reference.tar")
        ckpt = reference_tar(torch.Generator().manual_seed(21), step)
        t0 = time.perf_counter()
        torch.save(ckpt, tar)
        out["tar_save_s"] = time.perf_counter() - t0
        ckpt_dir = os.path.join(tmp, "converted")
        t0 = time.perf_counter()
        _, printed = run_cli(["--tar", tar, "--out_dir", ckpt_dir, "--device", str(dev)],
                             convert_ckpt)
        torch.cuda.synchronize()
        out["cli_s"] = time.perf_counter() - t0
        pt = os.path.join(ckpt_dir, f"{step:06d}.pt")
        out["tar_bytes"], out["pt_bytes"] = os.path.getsize(tar), os.path.getsize(pt)
        params = convert_checkpoint(tar, spec, dev)
        from mofanerf_tpu_torch.train.state import TrainState, make_optimizer

        like = TrainState(map_tree(torch.zeros_like, params),
                          make_optimizer().init(params), torch.zeros((), dtype=torch.int32,
                                                                     device=dev))
        back = restore_checkpoint(ckpt_dir, like)
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(flatten_with_keystr(back.params), flatten_with_keystr(params)))
        zero_moments = all(not t.any() for _, t in flatten_with_keystr(back.opt_state.mu)) and \
            all(not t.any() for _, t in flatten_with_keystr(back.opt_state.nu))
        print(f"convert: reference .tar {out['tar_bytes']} bytes saved in "
              f"{out['tar_save_s']:.2f} s; convert_ckpt --device {dev} in {out['cli_s']:.2f} s "
              f"-> {os.path.basename(pt)} ({out['pt_bytes']} bytes); restores to the "
              f"in-process conversion bit for bit: {same}; step {int(back.step)} "
              f"(global_step {step}); Adam count {int(back.opt_state.count)}, zero moments "
              f"{zero_moments}", flush=True)
        if not same or int(back.step) != step or int(back.opt_state.count) != 0 \
                or not zero_moments or "step 123456" not in printed:
            fail(failures, "convert_ckpt's .pt differs from the in-process conversion")

        # both fields against the F.linear oracle of the reference's modules, f32
        # (TF32 is off for matmuls): the plain field in f32, and B1 in bf16
        gen = torch.Generator().manual_seed(22)
        pts = (torch.rand((CONVERT_POINTS, 3), generator=gen) * 10.0 - 5.0).to(dev)
        dirs = torch.randn((CONVERT_POINTS, 3), generator=gen).to(dev)
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        shape, exp, tex = (torch.randn(n, generator=gen).to(dev) * 0.3 for n in (50, 30, 256))
        errs = {}
        for name, key, depth in (("coarse", "network_fn_state_dict", 8),
                                 ("fine", "network_fine_state_dict", 10)):
            cfg = getattr(spec, name)
            f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
            sd = {k: v.to(dev) for k, v in ckpt[key].items()}
            pe, de = fourier_embed(pts, cfg.multires), fourier_embed(dirs, cfg.multires_views)
            with torch.no_grad():
                oracle = reference_field_forward(sd, depth, cfg.skip, cfg.xyz_depth, pe, de,
                                                 exp[None], shape[None], tex[None])
                plain = torch.cat(apply_field(params[name], pts, dirs, shape, exp, tex, f32), 1)
                fused = fk.pack_fused_params(params[name],
                                             fold_conditioning(params[name], shape, exp, tex), cfg)
                b1 = torch.cat(fk.fused_field_apply(fused, pe.contiguous(),
                                                    (de @ params[name]["view"]["w_dirs"])
                                                    .contiguous(), cfg, 1), 1)
            scale = max(1.0, float(oracle.abs().max()))
            for label, got, dt_name in (("plain f32", plain, "float32"), ("B1 bf16", b1,
                                                                          "bfloat16")):
                diff = (got.float() - oracle).abs()
                err, rms = float(diff.max()), float(diff.square().mean().sqrt())
                tol, tol_rms = (t * scale for t in FIELD_TOL[dt_name])
                errs[f"{name} {label}"] = err
                print(f"convert: {name} field {label} vs the F.linear oracle on "
                      f"{CONVERT_POINTS} points: max|diff| {err:.3e} rms {rms:.3e} (tol max "
                      f"{tol:.3e} rms {tol_rms:.3e} = {FIELD_TOL[dt_name]} x max(1, max|oracle| "
                      f"{float(oracle.abs().max()):.3f}))", flush=True)
                if not (err <= tol and rms <= tol_rms) or not bool(torch.isfinite(got).all()):
                    fail(failures, f"convert: the {name} field ({label}) differs from the "
                                   f"reference forward by {err}")
        out["oracle_max_abs_err"] = errs

        # ---- the main path: run_render from the converted directory, B1 counted
        torch.cuda.synchronize()
        fk.launch_count = 0
        t0 = time.perf_counter()
        frames, _ = run_cli(["--out_dir", os.path.join(tmp, "frames"), "--ckpt_dir", ckpt_dir,
                             "--n_views", str(n_views), "--render_factor", str(512 // H),
                             "--basedir", os.path.join(tmp, "logs"),
                             "--uvdir", os.path.join(tmp, "uv"),
                             "--shape_codes_path", os.path.join(tmp, "none.npy"),
                             "--device", str(dev)])
        torch.cuda.synchronize()
        out["render_s"] = time.perf_counter() - t0
        out["launches"] = fk.launch_count

    # the CLI's conditioning (no identity factors, no UV map: zero codes; expression 0)
    # and orbit, through render_frame on the in-process conversion
    zeros = lambda n: torch.zeros(n, device=dev)
    with torch.no_grad():
        cond = prepare_conditioning(params, spec, zeros(spec.shape_dim),
                                    exp_code_for(params, 0), zeros(spec.tex_dim))
    focal = 1200.0 / (512 // H)
    K = np.array([[focal, 0, 0.5 * H], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)
    diffs = []
    for i, a in enumerate(np.linspace(-180, 180, n_views + 1)[:-1]):
        want = render_frame(params, spec, cond, H, H, K, pose_spherical(a, 0.0, 16.0)[:3])
        diffs.append(float(np.abs(frames[i] - want["rgb"].cpu().numpy()).max()))
    acc = float(want["acc"].mean())
    print(f"convert: run_render --ckpt_dir <converted> {n_views} views {H}x{H} in "
          f"{out['render_s']:.3f} s (model restore included); max|frame - render_frame| "
          f"{max(diffs):.3e} (tol 1e-6); mean acc {acc:.3f}; field kernel launches "
          f"{out['launches']} (expected {expected}: a coarse and a fine one a packet)",
          flush=True)
    if out["launches"] != expected:
        fail(failures, f"convert: field kernel launches {out['launches']} != {expected}")
    if frames.shape != (n_views, H, H, 3) or not np.isfinite(frames).all() or max(diffs) > 1e-6:
        fail(failures, f"convert: run_render's frames differ from render_frame's by {max(diffs)}")

    # one teacher packet under utils/profiling.trace: the file names B1's kernel
    rays_o, rays_d = get_rays(H, H, torch.from_numpy(K).to(dev),
                              torch.from_numpy(pose_spherical(0.0, 0.0, 16.0)[:3]).to(dev))
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        with profiling.trace(tmp) as prof:
            with profiling.annotate("teacher packet"), torch.no_grad():
                render_rays(params, spec, cond, rays_o.reshape(-1, 3)[:spec.render.packet_size],
                            rays_d.reshape(-1, 3)[:spec.render.packet_size])
            torch.cuda.synchronize()
        with open(prof.trace_path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernels = sorted(n for n in names if "field_kernel" in n)
    print(f"convert: profiling.trace wrote {len(names)} event names; B1's: {kernels}; the "
          f"annotation: {'teacher packet' in names}", flush=True)
    if not kernels or "teacher packet" not in names:
        fail(failures, "convert: the trace does not name the field kernel")

    uv = torch.rand((512, 512, 3), generator=gen)
    coords = torch.rand((4096, 2), generator=gen) * 520.0 - 4.0
    card_uv = bilinear_sample(uv.to(dev), coords.to(dev)).cpu()
    uv_err = float((card_uv - bilinear_sample(uv, coords)).abs().max())
    print(f"convert: bilinear_sample 4096 lookups in a 512^2 map, card vs CPU max|diff| "
          f"{uv_err:.3e} (tol 1e-6)", flush=True)
    if not uv_err <= 1e-6:
        fail(failures, f"convert: bilinear_sample differs between card and CPU by {uv_err}")
    out["bilinear_max_abs_err"] = uv_err
    out["card"] = card
    return out


def encoder_flops(spec):
    """Forward operations of the texture encoder on one UV map: seven 4x4
    stride-2 convolutions, the FC to 512, `mu`, three decoding layers."""
    from mofanerf_tpu_torch.models.tex_encoder import CONV_WIDTHS

    side, cin, ops = spec.uv_size, 3, 0
    for cout in CONV_WIDTHS:
        side = (side + 2 - 4) // 2 + 1
        ops += 2 * side * side * cout * cin * 16
        cin = cout
    flat = side * side * cin
    return ops + 2 * (flat * 512 + 512 * spec.tex_dim + 3 * spec.tex_dim ** 2)


def train_phase(failures, card, dev, tmp):
    """Training at full width through the port's entry points, in the work
    directory `tmp`: a 512^2 FaceScape-shaped fixture (JPEG UV maps read by the
    port's decoder), the run_train CLI on configs/exp_mofanerf.txt keeping its
    occupancy grid, with a checkpoint mid-run, a resumed run, run_render from
    the last checkpoint; then one small f32 step on the card against the CPU.
    Returns what the step timing and the distillation phase take on from it."""
    import torch

    from mofanerf_tpu_torch.bridge import map_tree
    from mofanerf_tpu_torch.cli import run_render, run_train
    from mofanerf_tpu_torch.config import load_config
    from mofanerf_tpu_torch.data.facescape import (load_facescape_data, load_shape_codes,
                                                   make_synthetic_dataset, read_image,
                                                   valid_persons)
    from mofanerf_tpu_torch.data.landmarks import TrainRaySampler
    from mofanerf_tpu_torch.models.field import FieldConfig
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.ops.embed import fourier_embed
    from mofanerf_tpu_torch.ops.composite import sigma_act
    from mofanerf_tpu_torch.ops.occupancy import (OccupancyGrid, dilate_occupancy, load_grid,
                                                  probe_density)
    from mofanerf_tpu_torch.render.renderer import (MoFaNeRF, RenderConfig, encode_texture,
                                                    exp_code_for, prepare_conditioning)
    from mofanerf_tpu_torch.train import loop, state as st
    from mofanerf_tpu_torch.train.checkpoint import save_checkpoint
    from mofanerf_tpu_torch.utils import image_io
    from mofanerf_tpu_torch.utils.tree import flatten_with_keystr, tree_leaves

    config = os.path.join(REPO, "configs", "exp_mofanerf.txt")
    n_first, n_total = TRAIN_STEPS
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    make_synthetic_dataset(data, n_ids=2, n_train=3, n_test=2, hw=TRAIN_SIDE, seed=0)
    print(f"train: fixture of 2 identities, {TRAIN_SIDE}x{TRAIN_SIDE} PNG frames and JPEG UV "
          f"maps written in {time.perf_counter() - t0:.2f} s", flush=True)
    # the host's JPEG decode of one UV map: the fixture's (uniform noise, the most
    # coefficients a block) and a smooth one (nearer a face texture)
    uv_path = os.path.join(data, "uv", "0", "1_neutral.jpg")
    y, x = np.mgrid[:TRAIN_SIDE, :TRAIN_SIDE]
    smooth = np.clip(np.stack([128 + 100 * np.sin(x / 37.0 + y / 53.0),
                               128 + 90 * np.cos(x / 29.0 - y / 61.0),
                               (x + y) / 4.0], -1), 0, 255).astype(np.uint8)
    smooth_path = os.path.join(tmp, "smooth.jpg")
    image_io.write_jpeg(smooth_path, smooth)
    decode_s = {}
    for name, path in (("noise", uv_path), ("smooth", smooth_path)):
        t0 = time.perf_counter()
        image_io.imread(path)
        decode_s[name] = time.perf_counter() - t0
    scale = (4096 / TRAIN_SIDE) ** 2
    print(f"train: JPEG decode of one {TRAIN_SIDE}^2 UV map on the host (pure-Python Huffman "
          f"stage): noise {decode_s['noise'] * 1e3:.1f} ms, smooth "
          f"{decode_s['smooth'] * 1e3:.1f} ms; scaled by pixels to a 4096^2 map "
          f"x{scale:.0f}: {decode_s['noise'] * scale:.1f} s and "
          f"{decode_s['smooth'] * scale:.1f} s", flush=True)

    logs = os.path.join(tmp, "logs")
    # the config's grid upkeep, its interval cut so that the runs update the grid
    flags = ["--config", config, "--i_grid", str(TRAIN_GRID_EVERY), "--grid_warmup",
             str(TRAIN_GRID_EVERY), "--expname", "smoke", "--basedir", logs,
             "--datadir", data, "--uvdir", os.path.join(data, "uv"),
             "--shape_codes_path", os.path.join(data, "factors_id.npy"),
             "--landmarks_path", os.path.join(data, "landmarks.npy"), "--person_num", "2",
             "--i_print", "1", "--i_weights", str(n_first // 2), "--i_testset", str(n_first),
             "--i_video", str(n_total), "--render_factor", str(TRAIN_ORBIT_FACTOR),
             "--device", str(dev)]
    cfg = load_config(flags)
    spec = cfg.model_spec()
    H = TRAIN_SIDE
    frame_packets = lambda n: -(-n // min(spec.render.packet_size, n))
    expected = 2 * (n_total // n_first * frame_packets((H // 2) ** 2)    # held-out images
                    + 40 * frame_packets((H // TRAIN_ORBIT_FACTOR) ** 2)   # the orbit
                    + 2 * frame_packets((512 // 2) ** 2))              # run_render, 2 views
    # the starting point: a seeded model whose alpha heads are rescaled to give both
    # fields structure over the first frame's conditioning (a seeded ReLU field is
    # mostly empty or fog, and an empty field gets no gradient), saved as step 0
    init = st.create_train_state(torch.Generator().manual_seed(0), spec, cfg.lrate,
                                 cfg.lrate_decay, device=dev)
    uv = torch.from_numpy(read_image(uv_path, is_uvmap=True, uv_size=spec.uv_size)).to(dev)
    with torch.no_grad():
        cond = prepare_conditioning(
            init.params, spec, torch.from_numpy(load_shape_codes(
                os.path.join(data, "factors_id.npy"))[0]).to(dev),
            exp_code_for(init.params, 0), encode_texture(init.params, spec, uv))
    probe_o, probe_d = kernel_rays(2048, 11, dev)
    probe = probe_o[:, None, :] + probe_d[:, None, :] * torch.linspace(
        8.0, 26.0, 16, device=dev)[:, None]
    for name in ("coarse", "fine"):
        fcfg = getattr(spec, name)
        shape_density(init.params[name], fcfg, getattr(cond, name),
                      fourier_embed(probe.reshape(-1, 3), fcfg.multires))
    save_checkpoint(os.path.join(logs, "smoke", "checkpoints"), init, 0)
    # the grid's density threshold: this shaped seeded field's density is high-frequency
    # noise, so at the config's 1.0 (and at its 90% quantile) the dilated grid marks nearly
    # every cell and run_render --fast would re-probe instead of using it. The threshold is
    # the lowest quantile of the step-0 coarse density at the grid's cells whose dilated
    # grid keeps at most GRID_STEP0_SHARE of them, so that the kept grid stays sparse, as a
    # trained face's is
    G = cfg.grid_resolution
    cells = OccupancyGrid(torch.zeros((G, G, G), dtype=torch.bool, device=dev),
                          torch.full((3,), -5.0, device=dev), torch.full((3,), 5.0, device=dev))
    density = sigma_act(spec.render.sigma_activation)(
        probe_density(init.params["coarse"], spec.coarse, cond.coarse, cells))
    for q in GRID_QUANTILES:
        grid_threshold = max(cfg.grid_density_threshold, float(torch.quantile(density, q)))
        share = float(dilate_occupancy((density > grid_threshold).reshape(G, G, G))
                      .float().mean())
        if share <= GRID_STEP0_SHARE:
            break
    flags += ["--grid_density_threshold", repr(grid_threshold)]
    print(f"train: grid density threshold {grid_threshold:.4g} (the {q:.1%} quantile of the "
          f"step-0 coarse field at the {G}^3 cells; its dilated grid holds {share:.2%} of them)",
          flush=True)

    # ---- the main path: counts zeroed just before, read just after
    torch.cuda.synchronize()
    fk.launch_count = 0
    t0 = time.perf_counter()
    run_train.main(flags + ["--n_iters", str(n_first)])
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    final = run_train.main(flags + ["--n_iters", str(n_total)])
    t_second = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = run_render.main(["--out_dir", os.path.join(tmp, "orbit"), "--n_views", "2",
                              "--render_factor", "2", "--device", str(dev)]
                             + flags[:flags.index("--i_print")])
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    launches = fk.launch_count

    exp = os.path.join(logs, "smoke")
    log = open(os.path.join(exp, "train_log.txt")).read()
    steps = [line.split() for line in log.splitlines() if line.startswith("Iteration")]
    losses = [float(f[3]) for f in steps]
    oks = [int(f[7]) for f in steps]
    ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    tests = [f for n in range(n_first, n_total + 1, n_first)
             for f in os.listdir(os.path.join(exp, f"testset_{n:06d}"))]
    orbit = os.listdir(os.path.join(exp, f"video_{n_total:06d}"))

    # batches for the timed steps, assembled as the loop assembles them
    ds = load_facescape_data(data, valid_persons(data), load_shape_codes(
        os.path.join(data, "factors_id.npy")), uvdir=os.path.join(data, "uv"))
    hh, ww, focal = ds.hwf
    K = np.array([[focal, 0, 0.5 * ww], [0, focal, 0.5 * hh], [0, 0, 1]], np.float32)
    sampler = TrainRaySampler(np.load(os.path.join(data, "landmarks.npy")) / 50.0, hh, ww,
                              lm_frac=cfg.lm_frac)
    rng, uv_cache = np.random.default_rng(7), {}
    t0 = time.perf_counter()
    batches = [loop.make_batch(n_total + i, cfg, spec, ds, K, sampler, rng, uv_cache, dev)
               for i in range(2 + TIMED_STEPS + PROFILED_STEPS)]
    t_batch = (time.perf_counter() - t0) / len(batches)
    print(f"train: run_train {n_first} steps from the step-0 checkpoint in {t_first:.2f} s, "
          f"resumed to {n_total} in {t_second:.2f} s (both with start-up, renders and saves); "
          f"run_render 2 views at 256^2 from the checkpoint in {t_render:.2f} s; field kernel "
          f"launches {launches} (expected {expected}: {n_total // n_first} held-out images, the "
          f"40-view orbit, the 2 CLI views)", flush=True)
    print(f"train: losses {[round(v, 5) for v in losses]}, step_ok {oks}; checkpoints {ckpts}; "
          f"{len(tests)} held-out PNG, {len(orbit)} orbit PNGs", flush=True)
    if launches != expected or launches == 0:
        fail(failures, f"training path: field kernel launches {launches} != expected {expected}")
    if len(losses) != n_total or not all(np.isfinite(losses)) or not all(o == 1 for o in oks):
        fail(failures, f"training: {len(losses)} logged steps, losses {losses}, step_ok {oks}")
    if not all(f"resumed from checkpoint at step {n}" in log for n in (0, n_first)):
        fail(failures, "training: a run did not resume from the checkpoint before it")
    want = {f"{n:06d}.pt" for n in (n_first // 2, n_first, n_total)}
    if not want <= set(ckpts) or len(tests) != n_total // n_first or len(orbit) != 40:
        fail(failures, f"training outputs: checkpoints {ckpts}, {len(tests)} test PNGs, "
                       f"{len(orbit)} orbit PNGs")
    if int(final.step) != n_total or int(final.opt_state.count) != n_total:
        fail(failures, f"training: final step {int(final.step)}, Adam count "
                       f"{int(final.opt_state.count)}, expected {n_total}")
    unchanged = [part for part in ("coarse", "fine", "ism", "tex_encoder", "exp_codes")
                 if all(torch.equal(a, b) for a, b in zip(tree_leaves(final.params[part]),
                                                          tree_leaves(init.params[part])))]
    if unchanged:
        fail(failures, f"training left parameter groups unchanged: {unchanged}")
    if (frames.shape != (2, 256, 256, 3) or not np.isfinite(frames).all()
            or frames.min() < 0.0 or frames.max() > 1.0 + 1e-5):
        fail(failures, f"run_render from the checkpoint: shape {frames.shape}, range "
                       f"[{np.nanmin(frames)}, {np.nanmax(frames)}]")
    # the occupancy grid the loop kept: updated every TRAIN_GRID_EVERY steps, saved
    # beside the checkpoints, resumed by the second run
    grid_path = os.path.join(exp, "checkpoints", "occupancy_grid.npz")
    n_updates = n_total // TRAIN_GRID_EVERY
    grid, ema = load_grid(grid_path, device=dev) if os.path.exists(grid_path) else (None, None)
    if grid is None or ema is None:
        fail(failures, f"training wrote no occupancy grid with its EMA at {grid_path}")
    else:
        occupied = float(grid.occ.float().mean())
        print(f"train: occupancy grid {tuple(grid.occ.shape)} written and reloaded, "
              f"{occupied:.2%} of cells occupied after {n_updates} EMA updates of the coarse "
              f"field (threshold {grid_threshold:.4g}, decay {cfg.grid_ema_decay}); "
              f"density EMA max {float(ema.max()):.3g}", flush=True)
        if "resumed occupancy grid" not in log or not bool(torch.isfinite(ema).all()):
            fail(failures, "training: the resumed run did not resume the occupancy grid")
        if not float(ema.max()) > 0.0:
            fail(failures, "training: the occupancy grid's density EMA stayed at 0")

    # one f32 step on the card against the same step on the CPU, at a small size
    fcfg = FieldConfig(depth=6, width=64, multires=4, multires_views=2)
    small = MoFaNeRF(coarse=fcfg, fine=fcfg, render=RenderConfig(n_coarse=8, n_importance=8),
                     uv_size=128)
    rng = np.random.default_rng(5)
    cpu_state = st.create_train_state(torch.Generator().manual_seed(2), small, device="cpu")
    rd = rng.normal(0, 0.05, (16, 3)) + [0.0, 0.0, -1.0]
    host = st.Batch(
        rays_o=torch.tensor([[0.0, 0.0, 16.0]] * 16),
        rays_d=torch.from_numpy(rd.astype(np.float32)),
        target_rgb=torch.from_numpy(rng.uniform(0, 1, (16, 3)).astype(np.float32)),
        shape_code=torch.from_numpy(rng.standard_normal(50).astype(np.float32)),
        exp_type=torch.tensor(4),
        uv_map=torch.from_numpy(rng.uniform(0, 1, (128, 128, 3)).astype(np.float32)))
    draws = {"strat": torch.from_numpy(rng.uniform(0, 1, (16, 8)).astype(np.float32)),
             "pdf": torch.from_numpy(rng.uniform(0, 1, (16, 8)).astype(np.float32))}
    on_card = lambda tree: map_tree(lambda t: t.to(dev), tree)
    tx = st.make_optimizer()
    ref_state, ref_m = st.train_step(cpu_state, host, None, small, tx, draws=draws)
    card_state = st.TrainState(on_card(cpu_state.params),
                               st.AdamState(cpu_state.opt_state.count.to(dev),
                                            on_card(cpu_state.opt_state.mu),
                                            on_card(cpu_state.opt_state.nu)),
                               cpu_state.step.to(dev))
    got_state, got_m = st.train_step(card_state, st.Batch(*[t.to(dev) for t in host[:6]]), None,
                                     small, tx, draws=on_card(draws))
    loss_err = abs(float(got_m["loss"]) - float(ref_m["loss"])) / abs(float(ref_m["loss"]))
    # mu = 0.1 g after one update: the gradients, held as tests/test_torch_train_state.py holds
    # them (the coarse field at 1e-6 x max|g|, what the importance samples reach at 2e-5)
    worst, bad = 0.0, []
    for (name, a), b in zip(flatten_with_keystr(got_state.opt_state.mu),
                            tree_leaves(ref_state.opt_state.mu)):
        a = a.cpu()
        scale = float(b.abs().max()) or 1.0
        atol = (1e-6 if name.startswith("['coarse']") else 2e-5) * scale
        excess = float(((a - b).abs() - 1e-4 * b.abs() - atol).max())
        worst = max(worst, float((a - b).abs().max()) / scale)
        if excess > 0:
            bad.append(name)
    print(f"train: small f32 step, card vs CPU: loss {float(got_m['loss']):.6f} vs "
          f"{float(ref_m['loss']):.6f} (rel {loss_err:.2e}, tol 1e-4); gradients (Adam mu) max "
          f"|diff| / max|g| {worst:.2e}, leaves outside tol {len(bad)}", flush=True)
    if not loss_err <= 1e-4 or bad or not (bool(got_m["step_ok"]) and bool(ref_m["step_ok"])):
        fail(failures, f"f32 train step differs between card and CPU: loss rel {loss_err}, {bad[:5]}")

    print(f"train: host batch assembly (PNG read, sampling, rays, copies) "
          f"{t_batch * 1e3:.1f} ms a batch, outside the timed steps", flush=True)
    render_flags = flags[:flags.index("--i_print")]
    return launches, final, cfg, batches, render_flags


class _Tee:
    """Standard output that is also kept, so that a phase can read what a CLI
    printed (its loss lines and timings)."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self):
        return "".join(self.parts)


def quiet(call):
    """call() with its standard output kept, synchronised with the card on
    both sides: (result, text, seconds)."""
    import contextlib

    import torch

    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = call()
    torch.cuda.synchronize()
    return result, tee.text(), time.perf_counter() - t0


def run_cli(argv, cli=None):
    """`cli`.main(argv), run_render's by default: (what it returned, what it
    printed)."""
    import contextlib

    from mofanerf_tpu_torch.cli import run_render

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = (cli or run_render).main(argv)
    return result, tee.text()


def profile_distill_steps(card, dev, spec, ckpt_dir, n_timed=DISTILL_TIMED_STEPS,
                          n_prof=DISTILL_PROFILED_STEPS):
    """Where a default distillation step's time goes, outside the counted path:
    the teacher from the checkpoint, `distill_step` timed over n_timed steps
    after warm-up (host clock, synchronised at both ends), then n_prof steps
    under torch.profiler (the card's busy share, the field kernel's share,
    launches a step, the host's operations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mofanerf_tpu_torch.render.renderer import (exp_code_for, init_model_params,
                                                    prepare_conditioning)
    from mofanerf_tpu_torch.train import distill as td
    from mofanerf_tpu_torch.train.checkpoint import restore_checkpoint

    params = restore_checkpoint(ckpt_dir, init_model_params(torch.Generator().manual_seed(0),
                                                            spec, device=dev))
    with torch.no_grad():
        cond = prepare_conditioning(params, spec, torch.zeros(spec.shape_dim, device=dev),
                                    exp_code_for(params, 0), torch.zeros(spec.tex_dim, device=dev))
    dcfg = td.DistillConfig()
    scfg = dcfg.student_config(spec.fine)
    state, tx = td.init_student(torch.Generator().manual_seed(0), scfg, dcfg.lr, dev)
    teacher = td.pack_teacher(params["fine"], spec.fine, cond.fine)
    gen = torch.Generator(device=dev).manual_seed(1)

    def steps(n):
        nonlocal state
        for _ in range(n):
            state, m = td.distill_step(state, tx, teacher, dcfg, scfg, generator=gen)
        return m["loss"]

    steps(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(n_timed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(n_prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
              for e in kernels}
    busy = sum(dev_us.values()) / 1e6
    n_launch = sum(e.count for e in kernels) / n_prof
    field = sum(v for k, v in dev_us.items() if "field" in k.lower()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    host = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"distill step: {ms:.3f} ms a step (mean of {n_timed} after 5 warm-up, host clock); "
          f"profiled {n_prof} steps: {wall / n_prof * 1e3:.3f} ms a step under the profiler, "
          f"card busy {busy / n_prof * 1e3:.3f} ms a step ({busy / wall:.1%}), the field kernel "
          f"{field / n_prof * 1e3:.3f} ms of it, in {n_launch:.0f} kernel launches a step; top: "
          + "; ".join(f"{k[:40]} {v / n_prof / 1e3:.3f} ms" for k, v in top)
          + "; host (self ms a step, calls): "
          + "; ".join(f"{e.key} {e.self_cpu_time_total / n_prof / 1e3:.3f} "
                      f"({e.count / n_prof:.0f})" for e in host) + f" on {card}", flush=True)
    return {"ms": ms, "profiled_ms": wall / n_prof * 1e3, "busy_ms": busy / n_prof * 1e3,
            "field_kernel_ms": field / n_prof * 1e3, "launches": n_launch}


def distill_phase(failures, card, dev, render_flags, tmp, teacher_sec):
    """This slice's path: from the training phase's checkpoint directory (its
    `.pt` and the occupancy grid it kept), the run_render CLI distils a student
    at the defaults (2000 steps of 32768 points, bf16 4x128; the teacher's
    queries through the field kernel), saves it and serves it from the file
    through the serving kernel; distils and serves an expression rig and a
    two-avatar morph at fewer steps; renders --fast through the grid; and reads
    the PSNR of the served and the fast frame against the teacher's."""
    import re

    import torch

    from mofanerf_tpu_torch.config import load_config
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.ops import serve_kernel as sk
    from mofanerf_tpu_torch.ops.bounds import ray_aabb_interval
    from mofanerf_tpu_torch.ops.occupancy import load_grid
    from mofanerf_tpu_torch.ops.rays import get_rays, pose_spherical
    from mofanerf_tpu_torch.ops.sweep import bucket_fraction
    from mofanerf_tpu_torch.train.distill import DistillConfig, load_student
    from mofanerf_tpu_torch.utils.metrics import img2mse, mse2psnr

    spec = load_config(render_flags).model_spec()
    ckpt_dir = os.path.join(render_flags[render_flags.index("--basedir") + 1],
                            render_flags[render_flags.index("--expname") + 1], "checkpoints")
    side = 512   # render_factor 1
    views = ["--n_views", "2", "--render_factor", "1", "--device", str(dev)]
    serve_packets = 2 * n_packets(side * side, 16384)   # run_render's packet at 512^2
    out = {"launches": {}}

    def count(name, argv, field_want, serve_want):
        """One CLI call with both kernels' counts zeroed just before it and read
        just after: (frames, printed text); fails unless the counts are the
        expected ones."""
        torch.cuda.synchronize()
        fk.launch_count, sk.launch_count = 0, 0
        t0 = time.perf_counter()
        frames, text = run_cli(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = (fk.launch_count, sk.launch_count)
        out["launches"][name] = {"field": got[0], "serve": got[1]}
        print(f"distill: {name}: {seconds:.2f} s for the call; field kernel launches {got[0]} "
              f"(expected {'some' if field_want is None else field_want}), serving kernel "
              f"launches {got[1]} (expected "
              f"{serve_want})", flush=True)
        if field_want is None:   # unknown in advance: at least one
            field_want = max(got[0], 1)
        if got != (field_want, serve_want):
            fail(failures, f"distill {name}: kernel launches {got}, expected "
                           f"{(field_want, serve_want)}")
        if (frames.shape[1:] != (side, side, 3) or not np.isfinite(frames).all()
                or frames.min() < 0.0 or frames.max() > 1.0 + 1e-5):
            fail(failures, f"distill {name}: frames {frames.shape}, range "
                           f"[{np.nanmin(frames)}, {np.nanmax(frames)}]")
        return frames, text

    # 1. the default distillation, saved with its provenance, then served from the file
    dcfg = DistillConfig()
    art = os.path.join(tmp, "student.npz")
    argv = ["--out_dir", os.path.join(tmp, "student"), "--distill", "--student_path", art] + views
    frames, text = count("--distill", argv + render_flags, dcfg.n_steps, serve_packets)
    losses = [float(v) for v in re.findall(r"\[DISTILL\] step \d+/\d+ loss (\S+)", text)]
    m = re.search(r"distilled (\d+) steps in (\S+) s", text)
    seconds = float(m.group(2)) if m else float("nan")
    ms_step = seconds / dcfg.n_steps * 1e3
    print(f"distill: {dcfg.n_steps} steps x {dcfg.batch} points (bf16 {dcfg.depth}x{dcfg.width} "
          f"student, teacher fine {spec.fine.depth}x{spec.fine.width} bf16 through the field "
          f"kernel) in {seconds:.3f} s: {dcfg.n_steps / seconds:.2f} steps/s, {ms_step:.3f} ms a "
          f"step; loss at the log windows {losses} on {card}", flush=True)
    if len(losses) != 4 or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(failures, f"distillation loss did not fall or is not finite: {losses}")
    _, scfg, prov = load_student(art, with_provenance=True, device=dev)
    grid, _ = load_grid(os.path.join(ckpt_dir, "occupancy_grid.npz"), device=dev)
    print(f"distill: artifact {os.path.getsize(art)} bytes, cond_dim {scfg.cond_dim}, "
          f"provenance {prov}", flush=True)
    if not all(k in prov for k in ("person", "expression", "aabb_min", "aabb_max", "near", "far")):
        fail(failures, f"the artifact's provenance lacks a key: {prov}")
    served, _ = count("--distill from the file", argv + render_flags, 0, serve_packets)
    diff = float(np.abs(served - frames).max())
    print(f"distill: served from the file, max |diff| to the distilling call's frames {diff:.3e}",
          flush=True)
    if diff > 1e-6:
        fail(failures, f"the artifact served from the file gives other frames ({diff})")

    out["step"] = profile_distill_steps(card, dev, spec, ckpt_dir)

    # 2. an expression rig and a two-avatar morph, each distilled, saved and served again
    n_short = DISTILL_SHORT_STEPS
    for name, flags in (("--distill_cond", ["--distill_cond", "--rig_expressions", "0,9,14"]),
                        ("--distill_avatars", ["--distill_avatars", "0,1"])):
        path = os.path.join(tmp, name.strip("-") + ".npz")
        argv = (["--out_dir", os.path.join(tmp, name.strip("-")), "--student_path", path,
                 "--distill_steps", str(n_short)] + flags + views + render_flags)
        first, text = count(name, argv, n_short, serve_packets)
        again, _ = count(name + " from the file", argv, 0, serve_packets)
        cond_dim = load_student(path, device=dev)[1].cond_dim
        moved = float(np.abs(first[0] - first[-1]).max())
        logged = re.findall(r"step \d+/\d+ loss (\S+)", text)
        print(f"distill: {name} {n_short} steps, cond_dim {cond_dim}, loss "
              f"{logged}; served from the file, max |diff| "
              f"{float(np.abs(again - first).max()):.3e}; the orbit's first and last frames "
              f"differ by {moved:.3f}", flush=True)
        if cond_dim != (30 if name == "--distill_cond" else 80) or not moved > 0.0:
            fail(failures, f"{name}: cond_dim {cond_dim}, frames moved {moved}")
        if float(np.abs(again - first).max()) > 1e-6:
            fail(failures, f"{name}: the artifact served from the file gives other frames")

    # 3. --fast through the maintained grid (re-probed when more than half occupied):
    # the launches are the packets its sweep keeps after the slab test against the box
    K = np.array([[1200.0, 0, side / 2], [0, 1200.0, side / 2], [0, 0, 1]], np.float32)
    occupied = float(grid.occ.float().mean())
    fast_want = 0
    for a in np.linspace(-180, 180, 3)[:-1]:
        o, d = get_rays(side, side, torch.as_tensor(K, device=dev),
                        torch.as_tensor(pose_spherical(a, 0.0, 16.0)[:3], device=dev))
        hit = ray_aabb_interval(o.reshape(-1, 3), d.reshape(-1, 3), grid.aabb_min,
                                grid.aabb_max, spec.render.near, spec.render.far)[2]
        frac = bucket_fraction(float(hit.float().mean()))
        n, p = side * side, spec.render.packet_size
        fast_want += n_packets(n, p, n if frac >= 1.0 else min(-(-int(n * frac) // p) * p, n))
    fast, text = count("--fast", ["--out_dir", os.path.join(tmp, "fast"), "--fast"] + views
                       + render_flags, fast_want if occupied <= 0.5 else None, 0)
    m = re.search(r"rendered 2 fast frames of \d+x\d+ in (\S+) s", text)
    fast_sec = float(m.group(1)) / 2 if m else float("nan")
    used = "using training-maintained occupancy grid" in text
    print(f"distill: --fast {fast_sec:.4f} s a {side}x{side} frame, {side * side / fast_sec:.0f} "
          f"rays/s (teacher {teacher_sec:.4f} s, {side * side / teacher_sec:.0f} rays/s; "
          f"{teacher_sec / fast_sec:.2f}x), through the maintained grid {used} ({occupied:.2%} "
          f"occupied) on {card}", flush=True)
    if not used and occupied <= 0.5:
        fail(failures, "--fast did not use the maintained grid")

    # 4. a reading, not a gate: PSNR against the teacher's frame at the orbit's first view
    teacher, _ = run_cli(["--out_dir", os.path.join(tmp, "teacher"), "--n_views", "1",
                          "--render_factor", "1", "--device", str(dev)] + render_flags)
    ref = torch.from_numpy(teacher[0])
    psnr = {k: float(mse2psnr(img2mse(torch.from_numpy(v[0]), ref)))
            for k, v in (("student", frames), ("fast", fast))}
    print(f"distill: PSNR against the teacher's frame (a reading): served student "
          f"{psnr['student']:.2f} dB, --fast {psnr['fast']:.2f} dB", flush=True)
    out.update(seconds=seconds, steps_per_s=dcfg.n_steps / seconds, ms_per_step=ms_step,
               loss_first=losses[0] if losses else None, loss_last=losses[-1] if losses else None,
               fast_s_per_frame=fast_sec, teacher_s_per_frame=teacher_sec,
               grid_occupied=occupied, psnr_student_db=psnr["student"],
               psnr_fast_db=psnr["fast"], card=card)
    return out


def host_syncs(step, n=3):
    """Where `step()` makes the host wait for the card, over n calls and then n
    more: the sites torch.cuda.set_sync_debug_mode("warn") reports (a copy from
    pageable memory, an .item(), ...), then the first one "error" mode raises at,
    with its frames in this repo. [] when there is none."""
    import traceback
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(n):
                step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message)})
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            step()
    except RuntimeError as e:
        where = [f"{os.path.relpath(f.filename, REPO)}:{f.lineno} {f.name}"
                 for f in traceback.extract_tb(e.__traceback__) if f.filename.startswith(REPO)]
        syncs.append(f"{str(e).splitlines()[0]} at {' <- '.join(reversed(where))}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return syncs


def fit_phase(failures, card, dev, render_flags, tmp):
    """This slice's paths, on the training phase's checkpoint directory and
    512^2 fixture: a target photo rendered through render_frame at known codes
    and pose, its pose file (the pose rotated by FIT_ROTATION_DEG, the
    fixture's landmarks projected), then the run_fit CLI at the full width of
    configs/exp_mofanerf.txt (fitting, rendering, rendering_modulation), the
    steady fit step at each pyramid level, evaluate on the fixture's test
    split (plain, --render_factor 2, --fast) and export_grids with a grid
    loaded back and rendered through render_frame_fast."""
    import contextlib
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mofanerf_tpu_torch.cli import evaluate, export_grids, run_fit
    from mofanerf_tpu_torch.config import load_config
    from mofanerf_tpu_torch.data.facescape import read_image
    from mofanerf_tpu_torch.data.landmarks import FitRaySampler, project_landmarks
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.ops.occupancy import render_frame_fast
    from mofanerf_tpu_torch.ops.rays import pose_spherical
    from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                    prepare_conditioning, render_frame)
    from mofanerf_tpu_torch.train import fit as tf
    from mofanerf_tpu_torch.train import fit_loop
    from mofanerf_tpu_torch.train.checkpoint import load_model
    from mofanerf_tpu_torch.utils.device import to_device
    from mofanerf_tpu_torch.utils.image_io import resize_linear, write_png
    from mofanerf_tpu_torch.utils.metrics import to8b

    cfg = load_config(render_flags)
    spec = cfg.model_spec()
    ckpt_dir = os.path.join(cfg.basedir, cfg.expname, "checkpoints")
    params, step = load_model(ckpt_dir, spec, dev)
    fcfg = tf.FitConfig(n_rand=cfg.N_rand)
    H = fcfg.H
    K = np.array([[fcfg.focal, 0, H / 2], [0, fcfg.focal, H / 2], [0, 0, 1]], np.float32)
    out = {"launches": {}}

    # ---- the target: identity 0 at expression 0 with its encoded texture, a known pose
    true_pose = pose_spherical(0.0, -5.0, 16.0)
    uv = read_image(os.path.join(cfg.uvdir, "0", "1_neutral.jpg"), is_uvmap=True,
                    uv_size=spec.uv_size)
    with torch.no_grad():
        shape = torch.from_numpy(np.load(cfg.shape_codes_path)[0].astype(np.float32)).to(dev)
        tex = encode_texture(params, spec, torch.from_numpy(uv).to(dev))
        cond = prepare_conditioning(params, spec, shape, exp_code_for(params, 0), tex)
    target = render_frame(params, spec, cond, H, H, K, true_pose[:3])["rgb"].float().cpu().numpy()
    name = "face"
    photo = os.path.join(tmp, "fit", "segRelRes", f"{name}.png")
    os.makedirs(os.path.dirname(photo))
    write_png(photo, to8b(target))
    th = np.deg2rad(FIT_ROTATION_DEG)
    dR = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    init_pose = true_pose.copy()
    init_pose[:3, :3] = (dR @ true_pose[:3, :3]).astype(np.float32)
    kp2d = project_landmarks(np.load(cfg.landmarks_path)[0, 0] / 50.0, K, true_pose)
    np.save(os.path.join(tmp, "fit", f"pose_{name}.npy"), {"pose": init_pose, "kp": kp2d},
            allow_pickle=True)
    out_dir = os.path.join(tmp, "fit", "fitting", f"segRelRes_{name}")
    argv = ["--filePath", photo, "--num_iterations", str(FIT_ITERS), "--pose_freeze_iters",
            str(FIT_FREEZE), "--device", str(dev)] + render_flags
    preview_packets = n_packets((H // 2) ** 2, spec.render.packet_size)

    def count(route, call, want):
        """One call with the field kernel's count zeroed just before and read just
        after: (result, printed text, seconds); fails unless the count is `want`
        (None: at least one)."""
        tee = _Tee(sys.stdout)
        torch.cuda.synchronize()
        fk.launch_count = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            result = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = fk.launch_count
        out["launches"][route] = got
        print(f"fit: {route}: {seconds:.2f} s for the call; field kernel launches {got} "
              f"(expected {'some' if want is None else want})", flush=True)
        if got != (max(got, 1) if want is None else want):
            fail(failures, f"fit {route}: field kernel launches {got}, expected "
                           f"{'at least 1' if want is None else want}")
        return result, tee.text(), seconds

    # ---- the CLI routes; the fit's poses kept step by step (device copies, no reads)
    poses, step_fn = [], fit_loop.fit_step

    def kept(*a, **kw):
        res = step_fn(*a, **kw)
        poses.append(res[0].codes.pose.clone())
        return res

    fit_loop.fit_step = kept
    try:
        # previews at 100 and the final one, both fields a packet
        n_previews = sum(1 for e in range(1, FIT_ITERS + 1)
                         if e % fcfg.preview_every == 0 or e in (100, 200, 300)) + 1
        state, text, fit_sec = count("fitting", lambda: run_fit.main(
            argv + ["--renderType", "fitting"]), 2 * n_previews * preview_packets)
    finally:
        fit_loop.fit_step = step_fn
    losses = [float(v) for v in re.findall(r"\[FIT\] iter \d+ loss (\S+)", text)]
    views, _, _ = count("rendering", lambda: run_fit.main(argv + ["--renderType", "rendering"]),
                        2 * 3 * preview_packets)
    mods, _, _ = count("rendering_modulation", lambda: run_fit.main(
        argv + ["--renderType", "rendering_modulation"]),
        2 * len(fit_loop.MODULATION_EXPRESSIONS) * preview_packets)
    files = sorted(os.listdir(out_dir))
    want_files = sorted(["target.png", "fit_params.npz", "fit_params.npz.opt.pt",
                         "fit_final.png", "fit_00100.png"] + list(views) + list(mods))
    R = [p[:3, :3].double().cpu().numpy() for p in poses]
    ortho = max(float(np.abs(r.T @ r - np.eye(3)).max()) for r in R)
    det = max(abs(float(np.linalg.det(r)) - 1.0) for r in R)
    still = all(torch.equal(p, poses[0]) for p in poses[:FIT_FREEZE]) and np.array_equal(
        poses[0].cpu().numpy(), init_pose.astype(np.float32))
    moved = not torch.equal(poses[-1], poses[0])

    def rot_err(pose):
        r = pose[:3, :3] @ true_pose[:3, :3].T
        return float(np.rad2deg(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))))

    final_pose = state.codes.pose.double().cpu().numpy()
    K2 = np.array([[fcfg.focal / 2, 0, H / 4], [0, fcfg.focal / 2, H / 4], [0, 0, 1]],
                  np.float32)
    view0 = state.codes._replace(pose=torch.from_numpy(pose_spherical(0.0, 0.0, 16.0)).to(dev))
    again = tf.render_fit_frame(params, spec, view0, H // 2, H // 2, K2)["rgb"].float().cpu()
    frame_diff = float(np.abs(again.numpy() - views["novel_yaw+000.png"]).max())
    print(f"fit: run_fit {FIT_ITERS + 1} steps (pose frozen {FIT_FREEZE}) in {fit_sec:.2f} s with "
          f"start-up, 2 previews and the saves; loss at the log windows {losses}; pose on SO(3): "
          f"max |R^T R - I| {ortho:.2e}, max |det R - 1| {det:.2e} over {len(poses)} steps, "
          f"bit-still through the freeze {still}; rotation error {rot_err(init_pose):.2f} -> "
          f"{rot_err(final_pose):.2f} deg; a rendering frame against render_fit_frame of the same "
          f"codes: max |diff| {frame_diff:.3e}; files {files}", flush=True)
    if files != want_files:
        fail(failures, f"run_fit wrote {files}, expected {want_files}")
    if len(losses) != FIT_ITERS // 10 + 1 or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0]:
        fail(failures, f"fit loss did not fall or is not finite: {losses}")
    if not ortho <= 1e-4 or not det <= 1e-4 or not still or not moved:
        fail(failures, f"fit pose: |R^T R - I| {ortho}, |det - 1| {det}, still through the "
                       f"freeze {still}, moved after it {moved}")
    if frame_diff > 1e-6:
        fail(failures, f"a rendering frame differs from render_fit_frame ({frame_diff})")
    if not all(np.isfinite(f).all() and f.shape == (H // 2, H // 2, 3)
               for f in list(views.values()) + list(mods.values())):
        fail(failures, "run_fit's rendering frames are not finite 256x256 frames")
    out.update(fit_seconds=fit_sec, loss_first=losses[0] if losses else None,
               loss_last=losses[-1] if losses else None, pose_ortho_err=ortho,
               rotation_err_deg=[rot_err(init_pose), rot_err(final_pose)])

    # ---- the steady fit step at each pyramid level (128^2, 256^2, 512^2)
    tx = tf.make_fit_optimizer(fcfg)
    sampler, rng = FitRaySampler(kp2d, H), np.random.default_rng(1)
    levels = {}
    for scale in (4, 2, 1):
        side = H // scale
        scaled = resize_linear(target, (side, side)).astype(np.float32)

        def batch():
            coords = sampler.sample(rng, fcfg.n_rand, scale=scale, target_img=scaled)
            return (to_device(coords, dev), to_device(scaled[coords[:, 0], coords[:, 1]], dev),
                    to_device(K / scale, dev))

        levels[side] = (scaled, batch)
    times = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for side, (_, batch) in levels.items():
        times[side] = []
        for i in range(FIT_WARMUP + FIT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = tf.fit_step(params, spec, tx, state, *batch(), FIT_FREEZE)
            torch.cuda.synchronize()
            times[side].append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    med = {side: float(np.median(t[FIT_WARMUP:])) * 1e3 for side, t in times.items()}
    ms = float(np.median([v for t in times.values() for v in t[FIT_WARMUP:]])) * 1e3
    # back to back, as the loop runs them: no synchronisation until the end
    batch = levels[H][1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FIT_TIMED):
        state, loss = tf.fit_step(params, spec, tx, state, *batch(), FIT_FREEZE)
    torch.cuda.synchronize()
    piped = (time.perf_counter() - t0) / FIT_TIMED * 1e3
    # a steady step must not synchronise with the host

    def one_step():
        nonlocal state, loss
        state, loss = tf.fit_step(params, spec, tx, state, *batch(), FIT_FREEZE)

    syncs = host_syncs(one_step)
    torch.cuda.synchronize()
    n_fine = spec.render.n_coarse + spec.render.n_importance   # the fine pass on the union
    fwd = fcfg.n_rand * (
        spec.render.n_coarse * field_flops_per_point(spec.coarse, fk._plan_len(spec.coarse))
        + n_fine * field_flops_per_point(spec.fine, fk._plan_len(spec.fine)))
    bound_ms = 2 * fwd / PEAK_BF16 * 1e3
    print(f"fit step: {ms:.2f} ms (median of {FIT_TIMED} a level after {FIT_WARMUP} warm-up, "
          f"host clock, synchronised around each step, its host batch included), "
          f"{1e3 / ms:.2f} iters/s; by level "
          + ", ".join(f"{s}^2 {v:.2f} ms" for s, v in med.items())
          + f"; back to back at 512^2 {piped:.2f} ms a step; a 2000-iteration fit's steps "
          f"{2000 * piped / 1e3:.1f} s; peak memory {peak / 2**30:.2f} GiB on {card}", flush=True)
    print(f"fit step: operations bound {bound_ms:.2f} ms = 2 x (fields {fwd / 1e12:.3f} TFLOP "
          f"forward at bf16 peak: the forward and the backward to the inputs, no weight "
          f"gradients); the step is {bound_ms / ms:.1%} of its bound; host synchronisations in "
          f"3 + 3 steady steps (torch.cuda.set_sync_debug_mode 'warn', then 'error'): "
          f"{'; '.join(syncs) if syncs else 'none'}", flush=True)
    if syncs:
        fail(failures, f"a steady fit step synchronises with the host: {'; '.join(syncs)}")
    if not np.isfinite(float(loss)):
        fail(failures, f"fit step loss {float(loss)}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(FIT_PROFILED):
            state, loss = tf.fit_step(params, spec, tx, state, *batch(), FIT_FREEZE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    self_us = [(e.key, getattr(e, "self_device_time_total", None) or e.self_cuda_time_total)
               for e in kernels]
    busy = sum(v for _, v in self_us) / 1e6
    n_launch = sum(e.count for e in kernels) / FIT_PROFILED
    products = sum(v for k, v in self_us if any(w in k.lower() for w in
                                                 ("gemm", "nvjet", "xmma", "cutlass", "sm90")))
    top = sorted(self_us, key=lambda kv: -kv[1])[:6]
    print(f"fit step: profiled {FIT_PROFILED} steps: {wall / FIT_PROFILED * 1e3:.2f} ms a step "
          f"under the profiler, card busy {busy / FIT_PROFILED * 1e3:.2f} ms a step "
          f"({busy / wall:.1%}), GEMM kernels {products / FIT_PROFILED / 1e3:.2f} ms, in "
          f"{n_launch:.0f} kernel launches a step; top: "
          + "; ".join(f"{k[:48]} {v / FIT_PROFILED / 1e3:.2f} ms" for k, v in top)
          + f" on {card}", flush=True)
    out["step"] = dict(ms=ms, ms_by_side=med, back_to_back_ms=piped, iters_per_s=1e3 / ms,
                       bound_ms=bound_ms, peak_memory_bytes=peak,
                       busy_share=busy / wall if wall else None, launches=n_launch,
                       host_syncs=len(syncs))

    # ---- evaluate on the fixture's test split, then export_grids and a fast frame
    for route, flags, want in (
            ("evaluate", [], None), ("evaluate --render_factor 2", ["--render_factor", "2"], None),
            ("evaluate --fast", ["--fast"], None)):
        ev_dir = os.path.join(tmp, "eval", route.replace(" ", "_").replace("-", ""))
        res, _, _ = count(route, lambda: evaluate.main(
            ["--out_dir", ev_dir, "--device", str(dev)] + flags + render_flags), want)
        metrics = json.load(open(os.path.join(ev_dir, "metrics.json")))
        print(f"fit: {route}: metrics.json {metrics}", flush=True)
        out[route] = metrics
        if not (metrics["n_views"] > 0 and np.isfinite(metrics["psnr_mean"])
                and np.isfinite(metrics["ssim_mean"])):
            fail(failures, f"{route}: metrics {metrics}")
    grids = os.path.join(tmp, "grids.npz")
    shares, _, _ = count("export_grids", lambda: export_grids.main(
        ["--out", grids, "--expressions", "0,1", "--device", str(dev)] + render_flags), 0)
    grid = export_grids.load_exported_grid(grids, 1, 1, device=dev)
    fast, _, _ = count("export_grids' grid through render_frame_fast", lambda: render_frame_fast(
        params, spec, cond.fine, grid, H, H, K, true_pose[:3]), None)
    rgb = fast["rgb"]
    print(f"fit: export_grids {len(shares)} grids, occupied {shares}; grid (1, 1) loaded back, "
          f"a {H}x{H} render_frame_fast frame finite {bool(torch.isfinite(rgb).all())}",
          flush=True)
    if set(shares) != {f"occ_{p}_{e}" for p in (0, 1) for e in (0, 1)} \
            or rgb.shape != (H, H, 3) or not bool(torch.isfinite(rgb).all()):
        fail(failures, f"export_grids: {shares}, fast frame {tuple(rgb.shape)}")
    out["grids_occupied"] = shares
    return out


def conv_flops(module, *shapes):
    """Forward operations of a module's convolutions on inputs of `shapes`
    (2 x multiply-adds; a transposed convolution counted on its input), from
    the shapes alone: the module runs on the meta device."""
    import torch

    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.ConvTranspose2d):
            x = inp[0]
            total[0] += 2 * x.shape[0] * x.shape[2] * x.shape[3] * mod.in_channels \
                * mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
        else:
            total[0] += 2 * out.shape[0] * out.shape[2] * out.shape[3] * mod.out_channels \
                * mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        module(*[torch.zeros(s, device="meta") for s in shapes])
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def profile_steps(step, n):
    """n calls of step() under torch.profiler: (ms a call, card busy ms a call,
    launches a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
               for e in kernels) / 1e6
    return wall / n * 1e3, busy / n * 1e3, sum(e.count for e in kernels) / n


def refine_phase(failures, card, dev, render_flags, tmp):
    """RefineNet on the training phase's checkpoint and 512^2 fixture, at the
    reference's full width (ngf 32, 4 downsamplings, 9 ResNet blocks at 512
    channels, num_D 2, n_layers_D 3, loadSize 512): the corpus through
    render_refine_trainset (plain, then --fast for one identity), its ground
    truth, run_train_refinenet for REFINE_STEPS steps with a seeded random VGG
    in the JAX package's pickle layout and a resume, the steady
    refine_train_step timed and profiled, run_refine over the corpus."""
    import contextlib
    import pickle
    import shutil

    import torch

    from mofanerf_tpu_torch.cli import (prepare_refine_trainset, render_refine_trainset,
                                        run_refine, run_train_refinenet)
    from mofanerf_tpu_torch.config import load_config
    from mofanerf_tpu_torch.models.refine.losses import VGG19Features, VGG_CONVS
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.ops.rays import pose_spherical
    from mofanerf_tpu_torch.render.renderer import (exp_code_for, prepare_conditioning,
                                                    render_frame)
    from mofanerf_tpu_torch.train import refine as tr
    from mofanerf_tpu_torch.train.checkpoint import load_model
    from mofanerf_tpu_torch.utils.image_io import image_size

    spec = load_config(render_flags).model_spec()
    root = os.path.join(tmp, "refine")
    train_dir, gt_dir = os.path.join(root, "train"), os.path.join(root, "gt")
    out = {"launches": {}}

    def count(route, call):
        """One call with the field kernel's count zeroed just before and read
        just after: (printed text, seconds, launches)."""
        tee = _Tee(sys.stdout)
        torch.cuda.synchronize()
        fk.launch_count = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            call()
        torch.cuda.synchronize()
        seconds, got = time.perf_counter() - t0, fk.launch_count
        out["launches"][route] = got
        return tee.text(), seconds, got

    # 1-2. the corpus: the plain route for both identities, --fast for one
    corpus_flags = ["--res", str(REFINE_RES), "--exp_num", "2", "--view_num", "2",
                    "--device", str(dev)] + render_flags
    _, sec, got = count("refine_corpus", lambda: render_refine_trainset.main(
        ["--out_dir", train_dir] + corpus_flags))
    with open(os.path.join(train_dir, "gt_manifest.json")) as f:
        frames = sorted(json.load(f))
    want = len(frames) * 2 * n_packets(REFINE_RES ** 2, spec.render.packet_size)
    out["corpus_s_per_frame"] = sec / max(len(frames), 1)
    print(f"refine: render_refine_trainset {len(frames)} frames at {REFINE_RES}^2 in {sec:.2f} s "
          f"({out['corpus_s_per_frame']:.3f} s a frame with start-up); field kernel launches "
          f"{got} (expected {want}: 2 a packet) on {card}", flush=True)
    if got != want or not frames:
        fail(failures, f"refine corpus: {len(frames)} frames, field kernel launches {got}, "
                       f"expected {want}")
    # the steady 256^2 frame of the plain route, apart from the CLI's start-up
    params, _ = load_model(os.path.join(render_flags[render_flags.index("--basedir") + 1],
                                        render_flags[render_flags.index("--expname") + 1],
                                        "checkpoints"), spec, dev)
    with torch.no_grad():
        cond = prepare_conditioning(params, spec, torch.zeros(spec.shape_dim, device=dev),
                                    exp_code_for(params, 0), torch.zeros(spec.tex_dim, device=dev))
    K = np.array([[2.0 * REFINE_RES, 0, REFINE_RES / 2], [0, 2.0 * REFINE_RES, REFINE_RES / 2],
                  [0, 0, 1]], np.float32)
    pose = pose_spherical(0.0, -10.0, 16.0)[:3]
    frame_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_frame(params, spec, cond, REFINE_RES, REFINE_RES, K, pose)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    out["corpus_frame_s"] = float(np.median(frame_s[1:]))
    print(f"refine: a steady {REFINE_RES}^2 render_frame {out['corpus_frame_s']:.4f} s (median of "
          f"2 after a warm-up; {frame_s})", flush=True)
    del params, cond
    fast_dir = os.path.join(tmp, "refine_fast")
    _, sec, got = count("refine_corpus --fast", lambda: render_refine_trainset.main(
        ["--out_dir", fast_dir, "--fast", "--begin_person", "0", "--end_person", "1"]
        + corpus_flags))
    with open(os.path.join(fast_dir, "gt_manifest.json")) as f:
        fast_frames = sorted(json.load(f))
    out["corpus_fast_s_per_frame"] = sec / max(len(fast_frames), 1)
    print(f"refine: render_refine_trainset --fast, identity 0: {len(fast_frames)} frames in "
          f"{sec:.2f} s ({out['corpus_fast_s_per_frame']:.3f} s a frame with a grid an "
          f"expression); field kernel launches {got} (at least one a frame)", flush=True)
    if (not fast_frames or got < len(fast_frames)
            or not all(f.startswith("0" + os.sep) for f in fast_frames)):
        fail(failures, f"refine corpus --fast: frames {fast_frames}, launches {got}")

    # 3. the ground truth, resized from the fixture's 512^2 to the renders' side
    t0 = time.perf_counter()
    prepare_refine_trainset.main(["--renders_dir", train_dir, "--out_dir", gt_dir])
    gts = [f for f in frames if os.path.exists(os.path.join(gt_dir, f))]
    sides = {image_size(os.path.join(gt_dir, f)) for f in gts}
    print(f"refine: prepare_refine_trainset {len(gts)} ground truths at {sides} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if len(gts) != len(frames) or sides != {(REFINE_RES, REFINE_RES)}:
        fail(failures, f"prepare_refine_trainset: {len(gts)} of {len(frames)}, sides {sides}")

    # 4. training: a seeded random VGG pickled in the JAX package's layout
    vgg_init = tr.init_vgg_params(torch.Generator().manual_seed(3), device="cpu")
    jax_layout = {"params": {name: {
        "kernel": vgg_init[f"convs.{k}.weight"].numpy().transpose(2, 3, 1, 0),
        "bias": vgg_init[f"convs.{k}.bias"].numpy()} for k, (name, _) in enumerate(VGG_CONVS)}}
    vgg_path = os.path.join(tmp, "vgg_random.pkl")
    with open(vgg_path, "wb") as f:
        pickle.dump(jax_layout, f)
    ckpts = os.path.join(tmp, "refine_ckpt")
    argv = ["--dataroot", root, "--checkpoints_dir", ckpts, "--vgg_weights", vgg_path,
            "--loadSize", str(REFINE_SIDE), "--display_freq", "1", "--device", str(dev)]
    t0 = time.perf_counter()
    state = run_train_refinenet.main(argv + ["--max_steps", str(REFINE_STEPS)])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    log = open(os.path.join(ckpts, "refine", "loss_log.txt")).read().splitlines()
    losses = [{k.rstrip(":"): float(v) for k, v in zip(ln.split(") ")[1].split()[::2],
                                                       ln.split(") ")[1].split()[1::2])}
              for ln in log if ln.startswith("(epoch")]
    cfg = tr.RefineConfig(load_size=REFINE_SIDE)
    init = tr.init_refine_state(torch.Generator().manual_seed(0), cfg, 1, dev)
    moved = {part: any(not torch.equal(getattr(state, part)[k], getattr(init, part)[k])
                       for k in getattr(init, part)) for part in ("g_params", "d_params")}
    saved = sorted(os.listdir(os.path.join(ckpts, "refine", "checkpoints")))
    finite = all(np.isfinite(v) for m in losses for v in m.values())
    triples = [(round(m["loss_G"], 3), round(m["loss_D"], 3), round(m["G_VGG"], 3))
               for m in losses]
    print(f"refine: run_train_refinenet {REFINE_STEPS} steps at {REFINE_SIDE}^2 in {t_train:.2f} "
          f"s with start-up; losses (loss_G, loss_D, G_VGG) {triples}"
          f"; both players moved {moved}; checkpoints {saved}", flush=True)
    if (len(losses) != REFINE_STEPS or not finite or not all(moved.values())
            or f"{REFINE_STEPS:06d}.pt" not in saved or not all(m["G_VGG"] > 0 for m in losses)):
        fail(failures, f"run_train_refinenet: {len(losses)} logged steps, finite {finite}, "
                       f"moved {moved}, checkpoints {saved}")
    text, _, _ = count("run_train_refinenet --continue_train", lambda: run_train_refinenet.main(
        argv + ["--continue_train", "--max_steps", str(REFINE_STEPS + 2)]))
    saved = sorted(os.listdir(os.path.join(ckpts, "refine", "checkpoints")))
    if f"resumed at step {REFINE_STEPS}" not in text or f"{REFINE_STEPS + 2:06d}.pt" not in saved:
        fail(failures, f"run_train_refinenet --continue_train did not resume: {saved}")

    # 5-6. the steady step at 512^2, batch 1: timed, its syncs, profiled, its bound
    vgg = {k: v.to(dev) for k, v in vgg_init.items()}
    g_tx, d_tx = tr.make_refine_optimizers(cfg, len(frames))
    gen = torch.Generator(device=dev).manual_seed(4)
    a = torch.rand((1, REFINE_SIDE, REFINE_SIDE, 3), generator=gen, device=dev) * 2 - 1
    b = torch.clamp(a + 0.1 * torch.randn(a.shape, generator=gen, device=dev), -1, 1)

    def one_step():
        nonlocal state
        state, _ = tr.refine_train_step(state, a, b, cfg, g_tx, d_tx, vgg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(2 + REFINE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    ms = float(np.median(times[2:])) * 1e3
    syncs = host_syncs(one_step)
    prof_ms, busy_ms, n_launch = profile_steps(one_step, 3)
    g, d = tr.build_models(cfg)
    side = REFINE_SIDE
    g_fwd = conv_flops(g, (1, 3, side, side))
    d_fwd = conv_flops(d, (1, 6, side, side))
    v_fwd = conv_flops(VGG19Features(device="meta"), (1, 3, side, side))
    # G forward and backward (weights and inputs); D three times (the G loss's pass
    # and its input backward; the real and the fake pair with weight backwards);
    # VGG on the fake (forward and input backward) and on the real (forward)
    step_flops = 3 * g_fwd + 6 * d_fwd + 3 * v_fwd
    bound_ms = step_flops / PEAK_F32 * 1e3
    print(f"refine step: {ms:.2f} ms at {side}^2, batch 1 (median of {REFINE_TIMED} after 2 "
          f"warm-ups, synchronised around each; all {[round(t * 1e3, 2) for t in times]}), "
          f"{1e3 / ms:.2f} steps/s; peak memory {peak / 2**30:.2f} GiB; profiled 3 steps: "
          f"{prof_ms:.2f} ms a step, the card busy {busy_ms:.2f} ms ({busy_ms / prof_ms:.1%}), "
          f"{n_launch:.0f} launches a step; host synchronisations in 3 + 3 steady steps: "
          f"{'; '.join(syncs) if syncs else 'none'} on {card}", flush=True)
    print(f"refine step: operations bound {bound_ms:.2f} ms = {step_flops / 1e12:.4f} TFLOP at "
          f"f32 peak (G forward {g_fwd / 1e9:.2f} GFLOP x 3, D forward both scales "
          f"{d_fwd / 1e9:.2f} x 6, VGG to relu5_1 {v_fwd / 1e9:.2f} x 3); the step is "
          f"{bound_ms / ms:.1%} of its bound", flush=True)
    if syncs:
        fail(failures, f"a steady refine step synchronises with the host: {'; '.join(syncs)}")
    out["step"] = dict(ms=ms, steps_per_s=1e3 / ms, bound_ms=bound_ms,
                       tflop=step_flops / 1e12, peak_memory_bytes=peak,
                       busy_share=busy_ms / prof_ms, launches=n_launch, host_syncs=len(syncs))

    # 7. inference over the corpus frames, a flat directory
    flat = os.path.join(tmp, "refine_frames", "nerf")
    os.makedirs(flat)
    for k, rel in enumerate(frames):
        shutil.copy(os.path.join(train_dir, rel), os.path.join(flat, f"{k:03d}.png"))
    t0 = time.perf_counter()
    paths = run_refine.main(["--nerf_folder", flat, "--checkpoints_dir", ckpts,
                             "--loadSize", str(REFINE_SIDE), "--device", str(dev)])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    refined = sorted(os.listdir(os.path.join(tmp, "refine_frames", "refine")))
    sizes = {image_size(p) for p in paths}
    out["refine_s_per_frame"] = sec / max(len(paths), 1)
    gen_ms = []
    for _ in range(2 + REFINE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.refine_inference(state.g_params, a, cfg)
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
    out["generator_ms"] = float(np.median(gen_ms[2:]))
    print(f"refine: run_refine {len(paths)} frames at {sides} -> {sizes} in {sec:.2f} s "
          f"({out['refine_s_per_frame']:.3f} s a frame with start-up: the seeded init, the "
          f"checkpoint, PNG reads, bicubic upsampling and PNG writes on the host); the generator "
          f"alone at {REFINE_SIDE}^2 {out['generator_ms']:.2f} ms (median of {REFINE_TIMED} after "
          f"2 warm-ups, synchronised; {g_fwd / 1e9:.1f} GFLOP, bound "
          f"{g_fwd / PEAK_F32 * 1e3:.2f} ms at f32 peak)", flush=True)
    if len(refined) != len(frames) or sizes != {(REFINE_SIDE, REFINE_SIDE)}:
        fail(failures, f"run_refine: {len(refined)} of {len(frames)} frames, sizes {sizes}")

    # 8. the WebP route; 9. the instance norm's gradient in this torch
    out["webp"] = refine_webp_route(failures, card, dev, tmp, vgg_path)
    out["instance_norm_grad"] = instance_norm_check(dev)
    return out


def _digest(a):
    """SHA-256 of an array's values, as the fixtures' manifests hash them (bool
    as 0 / 1 bytes)."""
    import hashlib
    a = np.ascontiguousarray(a, np.uint8 if a.dtype == bool else a.dtype)
    return hashlib.sha256(a.tobytes()).hexdigest()


def refine_webp_route(failures, card, dev, tmp, vgg_path):
    """RefineNet on WebP files at the phase's full width: the committed pair
    tree (renders lossy, ground truth lossless) read against its manifest
    (imageio's shape, dtype and SHA-256, re-derived by tests/test_torch_webp.py
    on the CPU) and header sizes; run_train_refinenet on it for
    REFINE_WEBP_STEPS steps (each draw decodes its pair) and a resume;
    run_refine over a flat directory of the WebP renders."""
    import glob
    import shutil

    import torch

    from mofanerf_tpu_torch.cli import run_refine, run_train_refinenet
    from mofanerf_tpu_torch.utils.image_io import image_size, imread

    with open(os.path.join(REFINE_WEBP_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    off, ms = [], {}
    for rel, entry in sorted(manifest.items()):
        path = os.path.join(REFINE_WEBP_DIR, rel)
        t0 = time.perf_counter()
        arr = imread(path)
        ms[rel] = (time.perf_counter() - t0) * 1e3
        if [list(arr.shape), str(arr.dtype), _digest(arr)] != \
                [entry["shape"], entry["dtype"], entry["sha256"]] \
                or list(image_size(path)) != entry["shape"][:2]:
            off.append(rel)
    kinds = {}
    for rel in manifest:                         # the first chunk: lossy renders, lossless truth
        with open(os.path.join(REFINE_WEBP_DIR, rel), "rb") as f:
            kinds[rel.split("/")[0]] = f.read(16)[12:16]
    print(f"refine webp: {len(manifest)} committed pair-tree files (train {kinds.get('train')}, "
          f"gt {kinds.get('gt')}) decoded on the host against their manifest: "
          f"{len(manifest) - len(off)} equal, differing {off}; ms a file "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()), flush=True)
    if off or len(manifest) < 8 or kinds != {"train": b"VP8 ", "gt": b"VP8L"}:
        fail(failures, f"refine webp: pair-tree files differing {off}, kinds {kinds}")
    root = os.path.join(tmp, "refine_webp")
    shutil.copytree(REFINE_WEBP_DIR, root, ignore=shutil.ignore_patterns("manifest.json"))
    ckpts = os.path.join(tmp, "refine_webp_ckpt")
    argv = ["--dataroot", root, "--checkpoints_dir", ckpts, "--vgg_weights", vgg_path,
            "--loadSize", str(REFINE_SIDE), "--display_freq", "1", "--device", str(dev)]
    _, _, sec = quiet(lambda: run_train_refinenet.main(
        argv + ["--max_steps", str(REFINE_WEBP_STEPS)]))
    with open(os.path.join(ckpts, "refine", "loss_log.txt")) as f:
        losses = [float(ln.split("loss_G: ")[1].split()[0]) for ln in f if ln.startswith("(epoch")]
    _, text, resume_sec = quiet(lambda: run_train_refinenet.main(
        argv + ["--continue_train", "--max_steps", str(REFINE_WEBP_STEPS + 2)]))
    saved = sorted(os.listdir(os.path.join(ckpts, "refine", "checkpoints")))
    print(f"refine webp: run_train_refinenet {REFINE_WEBP_STEPS} steps at {REFINE_SIDE}^2 on "
          f"the WebP pairs in {sec:.2f} s with start-up; loss_G {[round(v, 3) for v in losses]}; "
          f"resumed to {REFINE_WEBP_STEPS + 2} in {resume_sec:.2f} s; checkpoints {saved}",
          flush=True)
    if (len(losses) != REFINE_WEBP_STEPS or not np.isfinite(losses).all()
            or f"resumed at step {REFINE_WEBP_STEPS}" not in text
            or f"{REFINE_WEBP_STEPS + 2:06d}.pt" not in saved):
        fail(failures, f"refine webp: run_train_refinenet losses {losses}, checkpoints {saved}")
    flat = os.path.join(tmp, "refine_webp_frames", "nerf")
    os.makedirs(flat)
    renders = sorted(glob.glob(os.path.join(root, "train", "*", "*", "*.webp")))
    for k, path in enumerate(renders):
        shutil.copy(path, os.path.join(flat, f"{k:03d}.webp"))
    paths, _, refine_sec = quiet(lambda: run_refine.main(
        ["--nerf_folder", flat, "--checkpoints_dir", ckpts, "--loadSize", str(REFINE_SIDE),
         "--device", str(dev)]))
    sizes = {image_size(p) for p in paths}
    print(f"refine webp: run_refine over {len(renders)} flat WebP renders -> {len(paths)} frames "
          f"at {sizes} in {refine_sec:.2f} s with start-up on {card}", flush=True)
    if len(paths) != len(renders) or not renders or sizes != {(REFINE_SIDE, REFINE_SIDE)}:
        fail(failures, f"refine webp: run_refine wrote {len(paths)} of {len(renders)}, {sizes}")
    torch.cuda.synchronize()
    return {"files": len(manifest), "files_differing": off, "decode_ms": ms, "train_s": sec,
            "losses_G": losses, "resume_s": resume_sec, "refine_s": refine_sec,
            "refined": len(paths)}


def instance_norm_check(dev):
    """`F.instance_norm`'s input gradient against the written-out norm of
    models/refine/generator.py (the one the port runs), for an incoming
    gradient contiguous and channels-last, on the card and on this machine's
    CPU (PyTorch 2.13's CPU backward is wrong for a channels-last gradient at
    batch 1): the largest absolute difference, and the gradient's scale."""
    import torch
    import torch.nn.functional as F

    from mofanerf_tpu_torch.models.refine.generator import InstanceNorm

    gen = torch.Generator().manual_seed(11)
    x0 = torch.randn(NORM_CHECK_SHAPE, generator=gen)
    g0 = torch.randn(NORM_CHECK_SHAPE, generator=gen)
    errs = {}
    for device in (str(dev), "cpu"):
        for layout in ("contiguous", "channels_last"):
            x = x0.to(device).requires_grad_(True)
            g = g0.to(device)
            if layout == "channels_last":
                g = g.contiguous(memory_format=torch.channels_last)
            (a,) = torch.autograd.grad(F.instance_norm(x, eps=1e-5), x, g)
            (b,) = torch.autograd.grad(InstanceNorm()(x), x, g)
            errs[f"{device} {layout}"] = (float((a - b).abs().max()), float(b.abs().max()))
    print(f"refine: F.instance_norm's input gradient against the written-out norm at "
          f"{NORM_CHECK_SHAPE} (max |difference|, max |gradient|) in torch {torch.__version__}: "
          + "; ".join(f"{k} {v[0]:.3g} of {v[1]:.3g}" for k, v in errs.items()), flush=True)
    return errs


def device_data_phase(failures, card, dev, render_flags, tmp):
    """run_train with device_data = True at the full width of
    configs/exp_mofanerf.txt from the training phase's last checkpoint, chunks
    of DD_CHUNK steps that divide neither i_print nor i_weights: checkpoints
    where the JAX loop's crossing rule puts them, the held-out render through
    the field kernel counted; then the steady chunk's host synchronisations,
    the device-data step against the host-data step in turns, and the
    resident bytes against estimate_device_bytes."""
    import shutil

    import torch

    from mofanerf_tpu_torch.cli import run_train
    from mofanerf_tpu_torch.config import load_config
    from mofanerf_tpu_torch.data import device_data as ddm
    from mofanerf_tpu_torch.data.facescape import (load_facescape_data, load_shape_codes,
                                                   valid_persons)
    from mofanerf_tpu_torch.data.landmarks import TrainRaySampler
    from mofanerf_tpu_torch.data.prefetch import Prefetcher
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.train import loop, state as st
    from mofanerf_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
    from mofanerf_tpu_torch.utils.device import to_device

    basedir = render_flags[render_flags.index("--basedir") + 1]
    src = os.path.join(basedir, render_flags[render_flags.index("--expname") + 1], "checkpoints")
    start = latest_step(src)
    n_total = start + DD_STEPS
    ckpt_dir = os.path.join(basedir, "smoke_dd", "checkpoints")
    os.makedirs(ckpt_dir)
    for f in (f"{start:06d}.pt", "occupancy_grid.npz"):
        shutil.copy(os.path.join(src, f), ckpt_dir)
    i_print, i_weights = DD_INTERVALS
    flags = render_flags + ["--expname", "smoke_dd", "--device_data", "True", "--scan_steps",
                            str(DD_CHUNK), "--i_print", str(i_print), "--i_weights",
                            str(i_weights), "--i_testset", str(n_total), "--i_video", "1000000000",
                            "--n_iters", str(n_total), "--device", str(dev)]
    cfg = load_config(flags)
    spec = cfg.model_spec()

    def crossings(v):
        """Where the JAX device loop fires a hook of interval v (its `crossed`)."""
        hits, i = [], start
        while i < n_total:
            prev = i
            i += min(DD_CHUNK - i % DD_CHUNK, n_total - i)
            if i // v > prev // v:
                hits.append(i)
        return hits

    H = TRAIN_SIDE
    want = 2 * n_packets((H // 2) ** 2, spec.render.packet_size)   # the held-out image
    torch.cuda.synchronize()
    fk.launch_count = 0
    t0 = time.perf_counter()
    final = run_train.main(flags)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = fk.launch_count
    exp = os.path.join(basedir, "smoke_dd")
    log = open(os.path.join(exp, "train_log.txt")).read()
    logged = [int(line.split()[1]) for line in log.splitlines() if line.startswith("Iteration")]
    losses = [float(line.split()[3]) for line in log.splitlines() if line.startswith("Iteration")]
    saved = sorted(int(f[:-3]) for f in os.listdir(ckpt_dir) if f.endswith(".pt"))
    want_saved = sorted({start, *crossings(i_weights), n_total})
    print(f"device data: run_train device_data = True, {DD_STEPS} steps from step {start} in "
          f"chunks of {DD_CHUNK} in {sec:.2f} s with start-up, the held-out render and saves; "
          f"logged at {logged} (the crossing rule: {crossings(i_print)}), checkpoints {saved} "
          f"(the crossing rule: {want_saved}), losses {[round(v, 5) for v in losses]}; field "
          f"kernel launches {got} (expected {want}: the held-out image) on {card}", flush=True)
    if (logged != crossings(i_print) or saved != want_saved or got != want
            or not all(np.isfinite(losses)) or int(final.step) != n_total
            or "device-data path" not in log):
        fail(failures, f"device-data run: logged {logged}, checkpoints {saved}, launches {got}, "
                       f"step {int(final.step)}")
    out = {"launches": got, "run_s": sec}

    # the resident split against its estimate
    ds = load_facescape_data(cfg.datadir, valid_persons(cfg.datadir, cfg.person_num),
                             load_shape_codes(cfg.shape_codes_path), uvdir=cfg.uvdir)
    hh, ww, focal = ds.hwf
    K = np.array([[focal, 0, 0.5 * ww], [0, focal, 0.5 * hh], [0, 0, 1]], np.float32)
    landmarks = np.load(cfg.landmarks_path) / 50.0
    t0 = time.perf_counter()
    dd, bias = ddm.build_device_dataset(ds, K, ds.i_split[0], landmarks=landmarks,
                                        uv_size=spec.uv_size, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_uv = dd.uv_maps.shape[0]
    est = ddm.estimate_device_bytes(dd.images.shape[0], hh, ww, n_uv, spec.uv_size)
    out["resident_bytes"], out["estimate_bytes"] = ddm.resident_bytes(dd), est
    print(f"device data: {dd.images.shape[0]} frames of {hh}x{ww} and {n_uv} UV maps resident, "
          f"{out['resident_bytes']} bytes against estimate_device_bytes {est}; built in "
          f"{t_build:.2f} s; bias {bias}", flush=True)

    # the steady chunk: no host synchronisation; then both data paths in turns
    scfg = ddm.DeviceSamplerConfig(n_rand=cfg.N_rand, H=hh, W=ww,
                                   precrop_iters=cfg.precrop_iters,
                                   precrop_frac=cfg.precrop_frac, lm_frac=cfg.lm_frac,
                                   lm_frac_anneal_iters=cfg.lm_frac_anneal_iters, bias=bias)
    Kt = to_device(K, dev)
    tx = st.make_optimizer(cfg.lrate, cfg.lrate_decay)
    state = restore_checkpoint(ckpt_dir, st.create_train_state(
        torch.Generator().manual_seed(0), spec, cfg.lrate, cfg.lrate_decay, device=dev))
    i = [n_total]

    def device_chunk(n=DD_CHUNK):
        nonlocal state
        for _ in range(n):
            batch = ddm.sample_batch_device(dd, Kt, i[0], scfg,
                                            loop.device_generator(0, i[0], 0, dev))
            state, _ = st.train_step(state, batch, loop.device_generator(0, i[0], 1, dev),
                                     spec, tx)
            i[0] += 1

    sampler = TrainRaySampler(landmarks, hh, ww, lm_frac=cfg.lm_frac)
    rng, uv_cache = np.random.default_rng(9), {}

    def host_chunk(n=DD_CHUNK):
        nonlocal state
        batches = Prefetcher(lambda k: loop.make_batch(k, cfg, spec, ds, K, sampler, rng,
                                                       uv_cache, dev), depth=2)
        for k, batch in zip(range(i[0], i[0] + n), batches.iterate(i[0], i[0] + n)):
            state, _ = st.train_step(state, batch, loop.step_generator(0, k, dev), spec, tx)
        i[0] += n

    device_chunk()
    host_chunk()
    syncs = host_syncs(device_chunk, n=1)
    turns = {"device": [], "host": []}
    for name in ("device", "host", "host", "device", "device", "host"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (device_chunk if name == "device" else host_chunk)(DD_TIMED)
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) / DD_TIMED * 1e3)
    dev_ms, host_ms = (float(np.median(turns[k])) for k in ("device", "host"))
    print(f"device data: a steady chunk of {DD_CHUNK} steps: host synchronisations "
          f"{'; '.join(syncs) if syncs else 'none'}; back to back, {DD_TIMED} steps a turn, "
          f"turns device/host/host/device/device/host: device-data step "
          f"{[round(t, 2) for t in turns['device']]} ms, host-data step (batches on the "
          f"prefetch thread) {[round(t, 2) for t in turns['host']]} ms; medians {dev_ms:.2f} "
          f"against {host_ms:.2f} ms on {card}", flush=True)
    if syncs:
        fail(failures, f"a steady device-data chunk synchronises with the host: "
                       f"{'; '.join(syncs)}")
    out.update(device_step_ms=dev_ms, host_step_ms=host_ms, host_syncs=len(syncs),
               build_s=t_build, bias=bias)
    return out


def _random_conv(sd, g, key, cout, cin, k, bias=False):
    import torch

    sd[f"{key}.weight"] = torch.randn(cout, cin, k, k, generator=g) * (0.4 / np.sqrt(cin * k * k))
    if bias:
        sd[f"{key}.bias"] = torch.randn(cout, generator=g) * 0.1


def _random_bn(sd, g, key, c):
    import torch

    sd[f"{key}.weight"] = 1.0 + torch.randn(c, generator=g) * 0.1
    sd[f"{key}.bias"] = torch.randn(c, generator=g) * 0.1
    sd[f"{key}.running_mean"] = torch.randn(c, generator=g) * 0.1
    sd[f"{key}.running_var"] = 0.5 + torch.rand(c, generator=g)


def reference_bisenet_sd(g, n_classes=19):
    """A seeded random state dict in the key layout of the reference's
    Seg_79999_iter.pth (BiSeNet, SegmentCode/model.py + resnet.py), with
    BatchNorm running statistics."""
    sd = {}
    conv = lambda *a: _random_conv(sd, g, *a)
    bn = lambda *a: _random_bn(sd, g, *a)

    def convbn(key, cout, cin, k):
        conv(f"{key}.conv", cout, cin, k)
        bn(f"{key}.bn", cout)

    conv("cp.resnet.conv1", 64, 3, 7)
    bn("cp.resnet.bn1", 64)
    for layer, (cin, cout) in {"layer1": (64, 64), "layer2": (64, 128),
                               "layer3": (128, 256), "layer4": (256, 512)}.items():
        for i in (0, 1):
            p = f"cp.resnet.{layer}.{i}"
            conv(f"{p}.conv1", cout, cin if i == 0 else cout, 3)
            bn(f"{p}.bn1", cout)
            conv(f"{p}.conv2", cout, cout, 3)
            bn(f"{p}.bn2", cout)
            if i == 0 and cin != cout:
                conv(f"{p}.downsample.0", cout, cin, 1)
                bn(f"{p}.downsample.1", cout)
    for arm, cin in (("arm16", 256), ("arm32", 512)):
        convbn(f"cp.{arm}.conv", 128, cin, 3)
        conv(f"cp.{arm}.conv_atten", 128, 128, 1)
        bn(f"cp.{arm}.bn_atten", 128)
    convbn("cp.conv_head32", 128, 128, 3)
    convbn("cp.conv_head16", 128, 128, 3)
    convbn("cp.conv_avg", 128, 512, 1)
    convbn("ffm.convblk", 256, 256, 1)
    conv("ffm.conv1", 64, 256, 1)
    conv("ffm.conv2", 256, 64, 1)
    convbn("conv_out.conv", 256, 256, 3)
    conv("conv_out.conv_out", n_classes, 256, 1)
    return sd


def reference_hourglass_sd(g, base=16):
    """A seeded random state dict in the key layout of the reference's
    trained_model_03.t7 (defineHourglass_512_gray_skip.py), `shortcuts`
    registered on every block as the reference does."""
    import torch

    sd = {}
    conv = lambda *a, **k: _random_conv(sd, g, *a, **k)
    bn = lambda *a: _random_bn(sd, g, *a)

    def block(prefix, cin, cout, with_bn):
        conv(f"{prefix}.conv1", cout, cin, 3)
        conv(f"{prefix}.conv2", cout, cout, 3)
        conv(f"{prefix}.shortcuts", cout, cin, 1)
        if with_bn:
            bn(f"{prefix}.bn1", cout)
            bn(f"{prefix}.bn2", cout)

    ncs = [base, 2 * base, 4 * base, 8 * base + 27]
    conv("pre_conv", base, 1, 5, bias=True)
    bn("pre_bn", base)
    path = {3: "HG3", 2: "HG3.middle", 1: "HG3.middle.middle", 0: "HG3.middle.middle.middle"}
    for level, p in path.items():
        cin = base if level == 3 else ncs[2 - level]
        block(f"{p}.upper", cin, cin, False)
        block(f"{p}.low1", cin, ncs[3 - level], True)
        block(f"{p}.low2", ncs[3 - level], cin, False)
    lp = path[0] + ".middle"
    conv(f"{lp}.predict_FC1", 128, 27, 1)
    sd[f"{lp}.predict_relu1.weight"] = torch.tensor([0.2])
    conv(f"{lp}.predict_FC2", 9, 128, 1)
    conv(f"{lp}.post_FC1", 128, 9, 1)
    sd[f"{lp}.post_relu1.weight"] = torch.tensor([0.3])
    conv(f"{lp}.post_FC2", 27, 128, 1)
    for i in (1, 2, 3):
        conv(f"conv_{i}", base, base, 3 if i == 1 else 1, bias=True)
        bn(f"bn_{i}", base)
    conv("output", 1, base, 1, bias=True)
    return sd


def event_ms(fn, n, warmup=2):
    """Median of n single calls of fn timed with CUDA events, after warm-ups."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def wild_phase(failures, card, dev, render_flags, tmp):
    """The wild-photo route, end to end on the card: the synthetic face family
    generated at 512^2 (make_face_dataset, its frames rasterized on the card),
    three wild photos made from its meshes (A: a frontal render placed by a
    known similarity into a 640 x 480 JPEG, with its landmarks; B: the render
    itself as a PNG, with its landmarks; C: a PNG without landmarks), the
    wild_preprocess CLI through all four stages with seeded random BiSeNet
    and Hourglass weights in the reference's layouts, the two networks timed
    at 512^2, each stage's seconds a photo, then run_fit on A's relit photo
    and pose from the training phase's checkpoint, the field kernel counted.
    Returns ({"datagen": ...}, {"preprocess": ...})."""
    import json as _json
    import re
    import shutil

    import torch

    from mofanerf_tpu_torch.cli import run_fit, wild_preprocess
    from mofanerf_tpu_torch.config import load_config
    from mofanerf_tpu_torch.data.facescape import load_facescape_data
    from mofanerf_tpu_torch.data.landmarks import project_landmarks
    from mofanerf_tpu_torch.datagen.rasterize import rasterize_fragments, rasterize_mesh
    from mofanerf_tpu_torch.datagen.synthetic_faces import (face_landmarks, face_mesh,
                                                           make_face_dataset)
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.ops.rays import pose_spherical
    from mofanerf_tpu_torch.preprocess.align import CANONICAL_LANDMARKS_512, align_to_template
    from mofanerf_tpu_torch.preprocess.matting import apply_mask
    from mofanerf_tpu_torch.preprocess.pipeline import ROW_CUT, preprocess_dir
    from mofanerf_tpu_torch.preprocess.pose import estimate_pose_from_kp
    from mofanerf_tpu_torch.preprocess.relight import (HourglassNet, convert_hourglass_weights,
                                                       load_hourglass, relight_to_canonical)
    from mofanerf_tpu_torch.preprocess.segment import (BiSeNet, convert_bisenet_weights,
                                                       face_mask_from_parsing, load_bisenet,
                                                       segment_face, segment_logits)
    from mofanerf_tpu_torch.utils.device import f32_products
    from mofanerf_tpu_torch.utils.image_io import (imread, lab_to_rgb_u8, resize_linear,
                                                   rgb_to_lab_u8, warp_affine, write_jpeg,
                                                   write_png)

    # ---- 1. the synthetic face family at 512^2
    faces = os.path.join(tmp, "faces")
    kw = dict(n_ids=WILD_IDS, exp_ids=WILD_EXPS, res=WILD_SIDE, view_stride=WILD_STRIDE,
              n_holdout=WILD_HOLDOUT, seed=0, device=dev)
    params, _, ds_sec = quiet(lambda: make_face_dataset(faces, **kw))
    splits = {s: sum(len(_json.load(open(os.path.join(faces, f"transforms_{s}_{i}.json")))
                         ["frames"]) for i in range(WILD_IDS)) for s in ("train", "val", "test")}
    n_frames = sum(splits.values())
    codes = np.load(os.path.join(faces, "factors_id.npy"))
    ds = load_facescape_data(faces, list(range(WILD_IDS)), codes,
                             uvdir=os.path.join(faces, "uv"), testskip=1)
    uv = imread(os.path.join(faces, "uv", "0", "1_neutral.jpg"))
    lms = np.load(os.path.join(faces, "landmarks.npy"))
    frame0 = imread(ds.image_paths[0])
    listing = sorted(os.listdir(faces))
    _, again_text, again_sec = quiet(lambda: make_face_dataset(faces, **kw))
    try:
        make_face_dataset(faces, **dict(kw, seed=1))
        guard = "no error"
    except RuntimeError as e:
        guard = str(e)
    n_views = len(range(0, 120, WILD_STRIDE))
    print(f"datagen: make_face_dataset {WILD_IDS} identities x {len(WILD_EXPS)} expressions x "
          f"{n_views} views at {WILD_SIDE}^2 ({n_frames} frames: {splits}) in {ds_sec:.2f} s, "
          f"{ds_sec / n_frames * 1e3:.1f} ms a frame with its PNG; load_facescape_data reads "
          f"{len(ds.image_paths)}; a frame {frame0.shape}; UV map {uv.shape}; landmarks "
          f"{lms.shape}; a second call {again_sec:.2f} s ({again_text.count('skip existing id')} "
          f"identities skipped); a changed seed: {guard[:90]}", flush=True)
    if len(ds.image_paths) != n_frames or n_frames != WILD_IDS * len(WILD_EXPS) * n_views \
            or splits["val"] + splits["test"] != WILD_IDS * len(WILD_EXPS) * WILD_HOLDOUT:
        fail(failures, f"the face family's splits {splits} or loader count "
                       f"{len(ds.image_paths)} are off")
    if uv.shape != (256, 256, 3) or lms.shape != (300, 20, 68, 3) \
            or frame0.shape != (WILD_SIDE, WILD_SIDE, 4):
        fail(failures, f"face family files: UV {uv.shape}, landmarks {lms.shape}, "
                       f"frame {frame0.shape}")
    if again_text.count("skip existing id") != WILD_IDS or "rendered id" in again_text \
            or sorted(os.listdir(faces)) != listing:
        fail(failures, "a second make_face_dataset call rendered again")
    if "different config" not in guard:
        fail(failures, f"a changed config did not raise the resume guard's error: {guard}")

    # one 512^2 frame of the family's mesh: the rasterizer alone on the card (CUDA
    # events, median of single calls after warm-ups), then rasterize_mesh on the host clock
    verts, tris, albedo = face_mesh(params[0], 0)
    K = np.array([[1200.0, 0, WILD_SIDE / 2], [0, 1200.0, WILD_SIDE / 2], [0, 0, 1]])
    c2w = pose_spherical(0.0, 0.0, 16.0)
    vc = (verts - c2w[:3, 3]) @ c2w[:3, :3]
    args = (torch.from_numpy(vc.astype(np.float32)).to(dev),
            torch.from_numpy(tris.astype(np.int64)).to(dev),
            torch.from_numpy(np.asarray(albedo, np.float32)).to(dev),
            1200.0, 1200.0, WILD_SIDE / 2, WILD_SIDE / 2, WILD_SIDE, WILD_SIDE, 24)
    raster_ms = event_ms(lambda: rasterize_fragments(*args), 10)
    t0 = time.perf_counter()
    rgb, _, hit = rasterize_mesh(verts, tris, K, c2w, WILD_SIDE, WILD_SIDE, face_albedo=albedo,
                                 device=dev)
    mesh_ms = (time.perf_counter() - t0) * 1e3
    fragments = len(tris) * 24 * 24
    print(f"datagen: rasterize_fragments at {WILD_SIDE}^2, {len(tris)} faces, {fragments} "
          f"fragments a frame: {raster_ms:.3f} ms (CUDA events, median of 10; "
          f"{fragments / raster_ms * 1e3:.3e} fragments a second); rasterize_mesh with its host "
          f"shading and copies {mesh_ms:.1f} ms; {int(hit.sum())} pixels hit on {card}",
          flush=True)
    # the card against the CPU (the same functions, plain PyTorch there) on small inputs
    rng = np.random.default_rng(5)
    v_s, t_s, a_s = face_mesh(params[0], 1, 16, 24)
    small = dict(K=np.array([[150.0, 0, 32], [0, 150.0, 32], [0, 0, 1]]),
                 c2w=pose_spherical(30.0, -10.0, 16.0), H=64, W=64, face_albedo=a_s)
    r_card = rasterize_mesh(v_s, t_s, device=dev, **small)
    r_cpu = rasterize_mesh(v_s, t_s, device="cpu", **small)
    hit_off = int((r_card[2] != r_cpu[2]).sum())
    rgb_err = float(np.abs(r_card[0] - r_cpu[0]).max())
    img_s = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    M_s = np.array([[0.9, -0.2, 6.0], [0.2, 0.9, -4.0]])
    warp_err = float((warp_affine(torch.from_numpy(img_s).to(dev), M_s, (72, 56)).cpu()
                      - warp_affine(torch.from_numpy(img_s), M_s, (72, 56))).abs().max())
    colours = torch.from_numpy(rng.integers(0, 256, (100_000, 3), dtype=np.uint8))
    lab_off = int((rgb_to_lab_u8(colours.to(dev)).cpu() != rgb_to_lab_u8(colours)).sum()
                  + (lab_to_rgb_u8(colours.to(dev)).cpu() != lab_to_rgb_u8(colours)).sum())
    print(f"datagen: the card against the CPU: rasterize_mesh at 64^2 hit pixels differing "
          f"{hit_off}, max |rgb diff| {rgb_err:.2e}; warp_affine max |diff| {warp_err:.2e}; "
          f"8-bit Lab bytes differing (both ways, 10^5 colours) {lab_off}", flush=True)
    if hit_off or rgb_err > 1e-6 or warp_err > 1e-6 or lab_off:
        fail(failures, f"card against CPU: rasterizer hit {hit_off} / rgb {rgb_err}, warp "
                       f"{warp_err}, Lab {lab_off}")

    out_dg = {"dataset_s": ds_sec, "frames": n_frames, "splits": splits,
              "ms_a_frame": ds_sec / n_frames * 1e3, "second_call_s": again_sec,
              "rasterize_ms": raster_ms, "rasterize_mesh_ms": mesh_ms, "faces": len(tris),
              "fragments": fragments, "card_vs_cpu": {"hit_pixels_differing": hit_off,
                                                      "rgb_err": rgb_err, "warp_err": warp_err,
                                                      "lab_bytes_differing": lab_off},
              "card": card}

    # ---- 2. three wild photos
    photos = os.path.join(tmp, "wild")
    os.makedirs(photos)
    kp_b = project_landmarks(face_landmarks(params[0], 0).astype(np.float64), K, c2w)  # (row, col)
    deg, scale = WILD_WARP
    th = np.deg2rad(deg)
    S = np.array([[scale * np.cos(th), -scale * np.sin(th), 0.0],
                  [scale * np.sin(th), scale * np.cos(th), 0.0]])
    S[:, 2] = np.array([WILD_CANVAS[0] / 2 + 40, WILD_CANVAS[1] / 2 - 10]) \
        - S[:, :2] @ np.array([WILD_SIDE / 2, WILD_SIDE / 2])
    canvas = warp_affine(torch.from_numpy(rgb).to(dev), S, WILD_CANVAS)
    to8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)
    write_jpeg(os.path.join(photos, "A.jpg"), to8(canvas.cpu().numpy()))
    kp_a = (np.concatenate([kp_b[:, ::-1], np.ones((68, 1))], 1) @ S.T)[:, ::-1]
    np.save(os.path.join(photos, "kp_A.npy"), kp_a)
    write_png(os.path.join(photos, "B.png"), to8(rgb))
    np.save(os.path.join(photos, "kp_B.npy"), kp_b)
    v1, t1, a1 = face_mesh(params[1], 1)
    K_c = np.array([[1200.0, 0, 300], [0, 1200.0, 200], [0, 0, 1]])
    rgb_c, _, _ = rasterize_mesh(v1, t1, K_c, pose_spherical(20.0, 0.0, 16.0), 400, 600,
                                 face_albedo=a1, device=dev)
    write_png(os.path.join(photos, "C.png"), to8(rgb_c))

    # ---- 3. weights in the reference's layouts, seeded
    weights = os.path.join(tmp, "wild_weights")
    os.makedirs(weights)
    bisenet_sd = reference_bisenet_sd(torch.Generator().manual_seed(11))
    hourglass_sd = reference_hourglass_sd(torch.Generator().manual_seed(3))
    torch.save(bisenet_sd, os.path.join(weights, "Seg_79999_iter.pth"))
    torch.save(hourglass_sd, os.path.join(weights, "trained_model_03.t7"))
    sh = np.random.default_rng(9).normal(size=9)
    np.save(os.path.join(weights, "fcspLight.npy"), sh.reshape(9, 1))

    # ---- 4. the CLI, all four stages, on the card
    flags = ["--filePath", photos, "--landmarks3d", os.path.join(faces, "landmarks.npy"),
             "--bisenet_weights", os.path.join(weights, "Seg_79999_iter.pth"),
             "--relight_weights", os.path.join(weights, "trained_model_03.t7"),
             "--canonical_sh", os.path.join(weights, "fcspLight.npy"), "--device", str(dev)]
    _, cli_text, cli_sec = quiet(lambda: wild_preprocess.main(flags))
    outs = {sub: sorted(os.listdir(os.path.join(photos, sub)))
            for sub in ("raw", "mask", "segRes", "segRelRes")}
    shapes = {imread(os.path.join(photos, sub, f"{n}.png")).shape[:2]
              for sub in outs for n in "ABC" if os.path.exists(os.path.join(photos, sub, f"{n}.png"))}
    pose_err, kp_shapes = 0.0, set()
    for n in "ABC":
        d = np.load(os.path.join(photos, f"pose_{n}.npy"), allow_pickle=True).item()
        R = d["pose"][:3, :3].astype(np.float64)
        pose_err = max(pose_err, float(np.abs(R.T @ R - np.eye(3)).max()))
        kp_shapes.add(d["kp"].shape)
    raw_a = imread(os.path.join(photos, "raw", "A.png")).astype(np.float32) / 255
    raw_b = imread(os.path.join(photos, "raw", "B.png")).astype(np.float32) / 255
    mask_b = imread(os.path.join(photos, "mask", "B.png")) > 0
    face_b = imread(os.path.join(photos, "raw", "B.png")).max(-1) > 0   # the render's head
    inside = mask_b & face_b
    ab_diff = float(np.abs(raw_a - raw_b)[inside].mean()) if inside.any() else float("nan")
    # the CLI's mask of A against a direct segment_face call on the same aligned image
    net = load_bisenet(convert_bisenet_weights(bisenet_sd, dev))
    hg = load_hourglass(convert_hourglass_weights(hourglass_sd, dev))
    net_cpu = load_bisenet(convert_bisenet_weights(bisenet_sd, "cpu"))
    hg_cpu = load_hourglass(convert_hourglass_weights(hourglass_sd, "cpu"))
    kps = {"A": kp_a, "B": kp_b, "C": None}

    def aligned_of(name, device):
        """The photo's aligned 512^2 image as preprocess_dir makes it."""
        fname = {"A": "A.jpg", "B": "B.png", "C": "C.png"}[name]
        img = imread(os.path.join(photos, fname)).astype(np.float32)[..., :3] / 255.0
        if kps[name] is None:
            s = min(img.shape[:2])
            y0, x0 = (img.shape[0] - s) // 2, (img.shape[1] - s) // 2
            return torch.from_numpy(resize_linear(img[y0:y0 + s, x0:x0 + s], (512, 512))
                                    ).to(device), CANONICAL_LANDMARKS_512.copy()
        return align_to_template(torch.from_numpy(img).to(device), kps[name][:, ::-1].copy())

    aligned, _ = aligned_of("A", dev)
    direct = face_mask_from_parsing(segment_face(aligned, net)) * np.uint8(255)
    mask_equal = bool(np.array_equal(direct, imread(os.path.join(photos, "mask", "A.png"))))
    fallback = "[C] no landmarks available; center-crop fallback" in cli_text
    print(f"preprocess: wild_preprocess, all four stages, 3 photos: {cli_sec:.2f} s with start-up "
          f"(weights converted on the card); outputs {outs}; sides {shapes}; pose |R^T R - I| "
          f"max {pose_err:.2e}, kp {kp_shapes}; A (warped {deg} deg x {scale} into "
          f"{WILD_CANVAS}, JPEG) against B aligned: mean |diff| {ab_diff:.4f} over "
          f"{int(inside.sum())} pixels of B's mask; A's mask equals a direct segment_face "
          f"{mask_equal}; C's center-crop fallback logged {fallback}", flush=True)
    if any(v != ["A.png", "B.png", "C.png"] for v in outs.values()) or shapes != {(512, 512)}:
        fail(failures, f"wild_preprocess outputs {outs}, sides {shapes}")
    if not pose_err < 1e-5 or kp_shapes != {(68, 2)}:
        fail(failures, f"pose files: |R^T R - I| {pose_err}, kp {kp_shapes}")
    if not ab_diff <= WILD_AB_TOL:
        fail(failures, f"A's aligned photo differs from B's by {ab_diff} (tol {WILD_AB_TOL})")
    if not mask_equal or not fallback:
        fail(failures, f"A's mask equals a direct call {mask_equal}; fallback logged {fallback}")

    # the CLI's files on the card against preprocess_dir on the CPU (plain PyTorch there)
    # from the same photos and weights, held as tests/test_torch_wild_preprocess.py holds
    # the port against JAX: poses within 1e-6; raw and segRes within 1 level; the masks
    # equal wherever the CPU's top-2 BiSeNet logits are more than 1e-4 of the logits'
    # scale apart; the relit images, where the masks agree, within 4 levels, mean < 0.1
    on_cpu = os.path.join(tmp, "wild_cpu")
    shutil.copytree(photos, on_cpu, ignore=shutil.ignore_patterns(
        "raw", "mask", "segRes", "segRelRes", "pose_*", "fitting"))
    _, _, cpu_sec = quiet(lambda: preprocess_dir(
        on_cpu, landmarks_3d=lms[1, 0] / 50.0, bisenet_variables=net_cpu.state_dict(),
        relight_variables=hg_cpu.state_dict(), canonical_sh=sh, device="cpu"))
    read = lambda d, sub, n: imread(os.path.join(d, sub, f"{n}.png")).astype(np.int64)
    vs_cpu = {"pose_err": 0.0, "raw_levels": 0, "mask_off_decided": 0, "mask_off": 0,
              "seg_levels": 0, "relit_levels": 0, "relit_mean_levels": 0.0}
    for n in "ABC":
        d_card, d_cpu = (np.load(os.path.join(d, f"pose_{n}.npy"), allow_pickle=True).item()
                         for d in (photos, on_cpu))
        vs_cpu["pose_err"] = max(vs_cpu["pose_err"], *(
            float(np.abs(d_card[k].astype(np.float64) - d_cpu[k]).max()) for k in ("pose", "kp")))
        logits = segment_logits(aligned_of(n, "cpu")[0], net_cpu).sort(0).values
        near_tie = ((logits[-1] - logits[-2]) <= 1e-4 * logits.abs().max()).numpy()
        differ = read(photos, "mask", n) != read(on_cpu, "mask", n)
        same = ~differ
        vs_cpu["mask_off"] += int(differ.sum())
        vs_cpu["mask_off_decided"] += int((differ & ~near_tie).sum())
        vs_cpu["raw_levels"] = max(vs_cpu["raw_levels"], int(np.abs(
            read(photos, "raw", n) - read(on_cpu, "raw", n)).max()))
        vs_cpu["seg_levels"] = max(vs_cpu["seg_levels"], int(np.abs(
            read(photos, "segRes", n) - read(on_cpu, "segRes", n))[same].max()))
        rel = np.abs(read(photos, "segRelRes", n) - read(on_cpu, "segRelRes", n))[same]
        vs_cpu["relit_levels"] = max(vs_cpu["relit_levels"], int(rel.max()))
        vs_cpu["relit_mean_levels"] = max(vs_cpu["relit_mean_levels"], float(rel.mean()))
    print(f"preprocess: the CLI's files on the card against preprocess_dir on the CPU "
          f"({cpu_sec:.2f} s there), 3 photos: {vs_cpu}", flush=True)
    if vs_cpu["pose_err"] > 1e-6 or vs_cpu["raw_levels"] > 1 or vs_cpu["mask_off_decided"] \
            or vs_cpu["seg_levels"] > 1 or vs_cpu["relit_levels"] > 4 \
            or not vs_cpu["relit_mean_levels"] < 0.1:
        fail(failures, f"the CLI on the card differs from preprocess_dir on the CPU: {vs_cpu}")

    # ---- 5. the networks as the pipeline calls them (segment_logits and
    # relight_to_canonical set f32 with TF32 off themselves; the checks here add nothing),
    # the card against the CPU at 64^2, then at 512^2 timed, then each stage's seconds a photo
    img64 = np.random.default_rng(2).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    seg_pair = (segment_logits(torch.from_numpy(img64).to(dev), net).cpu(),
                segment_logits(torch.from_numpy(img64), net_cpu))
    rel_card, light_card = relight_to_canonical(img64, hg, sh, size=64)
    rel_cpu, light_cpu = relight_to_canonical(img64, hg_cpu, sh, size=64)
    nets_err = [float((a - b).abs().max() / b.abs().max()) for a, b in
                (seg_pair, (torch.from_numpy(light_card), torch.from_numpy(light_cpu)))]
    rel64 = float((rel_card.cpu() - rel_cpu).abs().max() * 255)
    print(f"preprocess: the card against the CPU at 64^2: segment_logits {nets_err[0]:.2e}, "
          f"relight_to_canonical's source SH {nets_err[1]:.2e} of the largest magnitude, its "
          f"relit image {rel64:.1f} levels", flush=True)
    if max(nets_err) > 1e-4 or rel64 > 4:
        fail(failures, f"the preprocessing networks on the card differ from the CPU: "
                       f"{nets_err}, relit {rel64} levels")
    seg_a = apply_mask(aligned, torch.from_numpy(direct // 255).to(dev))
    seg_a[ROW_CUT:, :] = 0
    seg_ms = event_ms(lambda: segment_logits(aligned, net), 10)
    relight_ms = event_ms(lambda: relight_to_canonical(seg_a, hg, sh), 10)
    x_l = rgb_to_lab_u8((seg_a * 255).to(torch.uint8))[..., 0].float()[None, None] / 255.0
    tl = torch.from_numpy(sh.astype(np.float32).reshape(1, 9, 1, 1)).to(dev)
    with torch.no_grad(), f32_products():   # the Hourglass alone, as relight_to_canonical calls it
        hg_ms = event_ms(lambda: hg(x_l, tl), 10)
    with torch.device("meta"):
        seg_flops = conv_flops(BiSeNet(), (1, 3, 512, 512))
        hg_flops = conv_flops(HourglassNet(), (1, 1, 512, 512), (1, 9, 1, 1))
    seg_bound, hg_bound = seg_flops / PEAK_F32 * 1e3, hg_flops / PEAK_F32 * 1e3
    stage_s: dict = {}

    def lap(stage, t0):
        torch.cuda.synchronize()
        stage_s.setdefault(stage, []).append(round(time.perf_counter() - t0, 4))
        return time.perf_counter()

    for n in "ABC":   # preprocess_dir's stage calls, its PNG writes left out
        t0 = time.perf_counter()
        al, kp_al = aligned_of(n, dev)
        estimate_pose_from_kp(kp_al, lms[1, 0] / 50.0, 1200.0)
        t0 = lap("align", t0)
        m = face_mask_from_parsing(segment_face(al, net))
        t0 = lap("mask", t0)
        seg = apply_mask(al, torch.from_numpy(m).to(dev))
        seg[ROW_CUT:, :] = 0
        t0 = lap("segment", t0)
        relight_to_canonical(seg, hg, sh)
        lap("relight", t0)
    print(f"preprocess: segment_logits at 512^2 {seg_ms:.3f} ms (BiSeNet, bound {seg_bound:.3f} "
          f"ms: {seg_flops / 1e9:.1f} GFLOP at f32 peak); the Hourglass {hg_ms:.3f} ms (bound "
          f"{hg_bound:.3f} ms: {hg_flops / 1e9:.2f} GFLOP), relight_to_canonical with its 8-bit "
          f"Lab both ways {relight_ms:.3f} ms; each stage's seconds a photo (A, B, C; "
          f"synchronised, warm) {stage_s} on {card}", flush=True)

    # ---- 6. run_fit on A's relit photo and pose, from the training checkpoint
    cfg = load_config(render_flags)
    photo = os.path.join(photos, "segRelRes", "A.png")
    argv = ["--filePath", photo, "--num_iterations", str(WILD_FIT_ITERS),
            "--pose_freeze_iters", str(WILD_FIT_ITERS // 2), "--device", str(dev)] + render_flags
    preview_packets = n_packets((512 // 2) ** 2, cfg.model_spec().render.packet_size)
    want = 2 * preview_packets   # the final preview, both fields a packet
    torch.cuda.synchronize()
    fk.launch_count = 0
    _, fit_text, fit_sec = quiet(lambda: run_fit.main(argv))
    launches = fk.launch_count
    losses = [float(v) for v in re.findall(r"\[FIT\] iter \d+ loss (\S+)", fit_text)]
    fit_dir = os.path.join(photos, "fitting", "segRelRes_A")
    files = sorted(os.listdir(fit_dir)) if os.path.isdir(fit_dir) else []
    print(f"preprocess: run_fit fitting on segRelRes/A.png with pose_A.npy, "
          f"{WILD_FIT_ITERS + 1} steps in {fit_sec:.2f} s with start-up; loss {losses}; field "
          f"kernel launches {launches} (expected {want}); files {files}", flush=True)
    if launches != want:
        fail(failures, f"wild fit: field kernel launches {launches}, expected {want}")
    if not losses or not np.isfinite(losses).all():
        fail(failures, f"wild fit loss not finite: {losses}")
    if files != sorted(["target.png", "fit_params.npz", "fit_params.npz.opt.pt", "fit_final.png"]):
        fail(failures, f"wild fit wrote {files}")
    out_pp = {"cli_s": cli_sec, "photos": 3, "stage_s": stage_s, "bisenet_ms": seg_ms,
              "bisenet_bound_ms": seg_bound, "bisenet_gflop": seg_flops / 1e9,
              "hourglass_ms": hg_ms, "hourglass_bound_ms": hg_bound, "relight_ms": relight_ms,
              "hourglass_gflop": hg_flops / 1e9, "ab_mean_abs_diff": ab_diff,
              "nets_card_vs_cpu": nets_err, "relit_card_vs_cpu_levels": rel64,
              "cli_card_vs_cpu": vs_cpu, "cpu_preprocess_s": cpu_sec,
              "pose_ortho_err": pose_err, "fit_s": fit_sec, "fit_losses": losses,
              "launches": launches, "card": card}
    return out_dg, out_pp


def formats_phase(failures, card, dev, render_flags, tmp):
    """The image formats the JAX package reads, read by the port on the card
    machine's host, then fed to the card: every committed file of
    mofanerf_tpu_torch/testdata/formats against its manifest (imageio's shape,
    dtype and SHA-256, re-derived by tests/test_torch_image_formats.py on the
    CPU) and its header size; the decode time of a 1024^2 photo, progressive
    against baseline, and arithmetic-coded against progressive, in turns;
    wild_preprocess on the wild phase's photos A-C with the progressive photo
    D.jpg, its arithmetic-coded copy E.jpg and the smoothed F.jpg (D ended
    before its last refinement scans) beside them, then run_fit on each of
    D-F's relit photos; run_train on the training fixture with each
    identity's UV map replaced by the progressive one, then by the sequential
    arithmetic-coded one, its held-out render counted. Every path counts the
    field kernel's launches with the count zeroed just before and read just
    after."""
    import re
    import shutil

    import torch

    from mofanerf_tpu_torch.cli import run_fit, run_train, wild_preprocess
    from mofanerf_tpu_torch.config import load_config
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.utils.image_io import image_size, imread

    # ---- 1. every committed file against its manifest
    with open(os.path.join(FORMATS_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    off, decode_ms = [], {}
    for name, entry in sorted(manifest.items()):
        path = os.path.join(FORMATS_DIR, name)
        t0 = time.perf_counter()
        arr = imread(path)
        decode_ms[name] = (time.perf_counter() - t0) * 1e3
        if [list(arr.shape), str(arr.dtype), _digest(arr)] != \
                [entry["shape"], entry["dtype"], entry["sha256"]] \
                or list(image_size(path)) != entry["shape"][:2]:
            off.append(name)
    print(f"formats: {len(manifest)} committed files (PNG, BMP, progressive and baseline JPEG, "
          f"arithmetic-coded and smoothed JPEG, WebP lossy, lossless, with alpha and animated) "
          f"decoded on the host against their manifest: {len(manifest) - len(off)} equal by "
          f"SHA-256, shape, dtype and header size, differing {off}; ms a file "
          + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items()), flush=True)
    if off:
        fail(failures, f"formats: files whose decode differs from the manifest: {off}")
    # the decode time of the 1024^2 photo, progressive and baseline (both 4:2:0, quality 90,
    # from one image), in turns
    photos = {k: os.path.join(FORMATS_DIR, f"photo_1024_{k}.jpg")
              for k in ("progressive", "baseline")}
    turns = {"progressive": [], "baseline": []}
    for k in ("progressive", "baseline", "baseline", "progressive") * FORMATS_DECODE_TURNS:
        t0 = time.perf_counter()
        imread(photos[k])
        turns[k].append((time.perf_counter() - t0) * 1e3)
    ms_mpx = {k: float(np.median(v)) / (1024 * 1024 / 1e6) for k, v in turns.items()}
    print(f"formats: decode of the 1024^2 photo on the host, median of "
          f"{2 * FORMATS_DECODE_TURNS} in turns: progressive {ms_mpx['progressive']:.1f} ms a "
          f"megapixel, baseline {ms_mpx['baseline']:.1f} ms a megapixel "
          f"({ms_mpx['progressive'] / ms_mpx['baseline']:.2f}x); all turns (ms) {turns}; "
          f"host of {card}", flush=True)
    # the WebP decode: the 1024^2 photo re-encoded lossy at quality 80 against the 512^2
    # face render lossless, in turns
    webp_turns = {k: [] for k in FORMATS_WEBP}
    pixels = {}
    for k in ("lossy", "lossless", "lossless", "lossy") * FORMATS_DECODE_TURNS:
        t0 = time.perf_counter()
        arr = imread(os.path.join(FORMATS_DIR, FORMATS_WEBP[k]))
        webp_turns[k].append((time.perf_counter() - t0) * 1e3)
        pixels[k] = arr.shape[0] * arr.shape[1]
    webp_ms_mpx = {k: float(np.median(v)) / (pixels[k] / 1e6) for k, v in webp_turns.items()}
    print(f"formats: WebP decode on the host, median of {2 * FORMATS_DECODE_TURNS} in turns: "
          f"lossy (VP8) {FORMATS_WEBP['lossy']} {webp_ms_mpx['lossy']:.1f} ms a megapixel, "
          f"lossless (VP8L) {FORMATS_WEBP['lossless']} {webp_ms_mpx['lossless']:.1f} ms a "
          f"megapixel; beside JPEG progressive {ms_mpx['progressive']:.1f}, baseline "
          f"{ms_mpx['baseline']:.1f}; all turns (ms) {webp_turns}; host of {card}", flush=True)
    # the arithmetic decode: the same 1024^2 photo progressive arithmetic-coded (E's coding)
    # against the progressive Huffman file, in turns
    arith_turns = {"arithmetic": [], "progressive": []}
    for k in ("arithmetic", "progressive", "progressive", "arithmetic") * FORMATS_ARITH_TURNS:
        t0 = time.perf_counter()
        imread(os.path.join(FORMATS_DIR, FORMATS_ARITH[k]))
        arith_turns[k].append((time.perf_counter() - t0) * 1e3)
    arith_ms_mpx = {k: float(np.median(v)) / (1024 * 1024 / 1e6) for k, v in arith_turns.items()}
    # each decode against its neighbour of the other kind in the same turn
    paired = float(np.median(np.divide(arith_turns["arithmetic"], arith_turns["progressive"])))
    print(f"formats: arithmetic-coded JPEG decode on the host, median of "
          f"{2 * FORMATS_ARITH_TURNS} in turns: {FORMATS_ARITH['arithmetic']} "
          f"{arith_ms_mpx['arithmetic']:.1f} ms a megapixel against "
          f"{FORMATS_ARITH['progressive']} {arith_ms_mpx['progressive']:.1f} "
          f"({arith_ms_mpx['arithmetic'] / arith_ms_mpx['progressive']:.2f}x; the median of "
          f"the paired ratios {paired:.2f}x); all turns (ms) {arith_turns}; host of {card}",
          flush=True)

    # ---- 2. wild_preprocess with the photos D-F beside A-C, then run_fit on each
    wild = os.path.join(tmp, "wild_formats")
    shutil.copytree(os.path.join(tmp, "wild"), wild, ignore=shutil.ignore_patterns(
        "raw", "mask", "segRes", "segRelRes", "pose_*", "fitting"))
    for name in FORMATS_PHOTOS:
        for f in (f"{name}.jpg", f"kp_{name}.npy"):
            shutil.copy(os.path.join(FORMATS_DIR, f), os.path.join(wild, f))
    weights = os.path.join(tmp, "wild_weights")
    flags = ["--filePath", wild, "--landmarks3d", os.path.join(tmp, "faces", "landmarks.npy"),
             "--bisenet_weights", os.path.join(weights, "Seg_79999_iter.pth"),
             "--relight_weights", os.path.join(weights, "trained_model_03.t7"),
             "--canonical_sh", os.path.join(weights, "fcspLight.npy"), "--device", str(dev)]
    _, _, cli_sec = quiet(lambda: wild_preprocess.main(flags))
    outs = {sub: sorted(os.listdir(os.path.join(wild, sub)))
            for sub in ("raw", "mask", "segRes", "segRelRes")}
    raw = {n: imread(os.path.join(wild, "raw", f"{n}.png")).astype(np.float32) / 255
           for n in "B" + "".join(FORMATS_PHOTOS)}
    inside = (imread(os.path.join(wild, "mask", "B.png")) > 0) & (raw["B"].max(-1) > 0)
    vs_b, kp_shapes = {}, {}
    for name in FORMATS_PHOTOS:
        pose = np.load(os.path.join(wild, f"pose_{name}.npy"), allow_pickle=True).item()
        kp_shapes[name] = pose["kp"].shape
        vs_b[name] = float(np.abs(raw[name] - raw["B"])[inside].mean()) if inside.any() \
            else float("nan")
    print(f"formats: wild_preprocess on A-C and the photos {FORMATS_PHOTOS}: {cli_sec:.2f} s "
          f"with start-up; outputs {outs}; kp {kp_shapes}; each against B aligned (mean |diff| "
          f"over {int(inside.sum())} pixels of B's mask, tol {WILD_AB_TOL}): {vs_b}", flush=True)
    want_outs = sorted(["A.png", "B.png", "C.png"] + [f"{n}.png" for n in FORMATS_PHOTOS])
    if any(v != want_outs for v in outs.values()):
        fail(failures, f"formats: wild_preprocess outputs {outs}")
    for name in FORMATS_PHOTOS:
        if not vs_b[name] <= WILD_AB_TOL or kp_shapes[name] != (68, 2):
            fail(failures, f"formats: {name}'s aligned photo differs from B's by {vs_b[name]}, "
                           f"or its kp {kp_shapes[name]}")
    cfg = load_config(render_flags)
    want_fit = 2 * n_packets((512 // 2) ** 2, cfg.model_spec().render.packet_size)
    fits = {}
    for name in FORMATS_PHOTOS:
        argv = ["--filePath", os.path.join(wild, "segRelRes", f"{name}.png"), "--num_iterations",
                str(FORMATS_FIT_ITERS), "--pose_freeze_iters", str(FORMATS_FIT_ITERS // 2),
                "--device", str(dev)] + render_flags
        torch.cuda.synchronize()
        fk.launch_count = 0
        _, fit_text, fit_sec = quiet(lambda: run_fit.main(argv))
        fit_launches = fk.launch_count
        losses = [float(v) for v in re.findall(r"\[FIT\] iter \d+ loss (\S+)", fit_text)]
        fits[name] = {"s": fit_sec, "losses": losses, "launches": fit_launches}
        print(f"formats: run_fit on segRelRes/{name}.png ({FORMATS_PHOTOS[name]}), "
              f"{FORMATS_FIT_ITERS + 1} steps in {fit_sec:.2f} s with start-up; loss {losses}; "
              f"field kernel launches {fit_launches} (expected {want_fit})", flush=True)
        if fit_launches != want_fit or not losses or not np.isfinite(losses).all():
            fail(failures, f"formats: run_fit on {name}: {fit_launches} launches (expected "
                           f"{want_fit}), loss {losses}")

    # ---- 3. run_train with a progressive UV map, then with a sequential arithmetic-coded one
    trains = {}
    for uv_name, sof, label in (("uv_progressive.jpg", b"\xff\xc2", "progressive (SOF2)"),
                                ("uv_arith.jpg", b"\xff\xc9", "arithmetic-coded (SOF9)")):
        tag = uv_name[:-4]
        data = os.path.join(tmp, f"data_{tag}")
        shutil.copytree(os.path.join(tmp, "data"), data)
        uvs = [os.path.join(data, "uv", i, "1_neutral.jpg") for i in ("0", "1")]
        for uv in uvs:   # both identities', so that every batch and the held-out image read one
            shutil.copy(os.path.join(FORMATS_DIR, uv_name), uv)
        with open(uvs[1], "rb") as f:
            coded = sof in f.read()
        swap = {"--expname": f"formats_{tag}", "--datadir": data,
                "--uvdir": os.path.join(data, "uv"),
                "--shape_codes_path": os.path.join(data, "factors_id.npy"),
                "--landmarks_path": os.path.join(data, "landmarks.npy")}
        train_flags = [swap.get(render_flags[i - 1], a) if i else a
                       for i, a in enumerate(render_flags)]
        n = FORMATS_TRAIN_STEPS
        train_flags += ["--i_print", "1", "--i_weights", str(10 * n), "--i_testset", str(n),
                        "--i_video", str(10 * n), "--n_iters", str(n), "--device", str(dev)]
        want_train = 2 * n_packets((TRAIN_SIDE // 2) ** 2, cfg.model_spec().render.packet_size)
        torch.cuda.synchronize()
        fk.launch_count = 0
        _, _, train_sec = quiet(lambda: run_train.main(train_flags))
        train_launches = fk.launch_count
        with open(os.path.join(cfg.basedir, f"formats_{tag}", "train_log.txt")) as f:
            log = f.read()
        train_losses = [float(line.split()[3]) for line in log.splitlines()
                        if line.startswith("Iteration")]
        trains[tag] = {"s": train_sec, "losses": train_losses, "launches": train_launches}
        print(f"formats: run_train {n} steps with each identity's UV map the {label} 512^2 JPEG "
              f"({uv_name}, marker found: {coded}): {train_sec:.2f} s with start-up; loss "
              f"{train_losses}; field kernel launches {train_launches} (expected {want_train}: "
              f"the held-out image)", flush=True)
        if not coded or train_launches != want_train or len(train_losses) != n \
                or not np.isfinite(train_losses).all():
            fail(failures, f"formats: run_train with {uv_name}: {train_launches} launches "
                           f"(expected {want_train}), losses {train_losses}")
    return {"files": len(manifest), "files_differing": off, "decode_ms": decode_ms,
            "photo_ms_a_megapixel": ms_mpx, "photo_turns_ms": turns,
            "webp_ms_a_megapixel": webp_ms_mpx, "webp_turns_ms": webp_turns,
            "arith_ms_a_megapixel": arith_ms_mpx, "arith_turns_ms": arith_turns,
            "wild_cli_s": cli_sec, "vs_b_mean_abs_diff": vs_b, "fits": fits, "trains": trains,
            "fit_launches": sum(v["launches"] for v in fits.values()),
            "train_launches": sum(v["launches"] for v in trains.values()), "card": card}


def _finite_readings(tree):
    """Every number of a study's JSON is finite (booleans and strings aside)."""
    if isinstance(tree, dict):
        return all(_finite_readings(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite_readings(v) for v in tree)
    return not isinstance(tree, float) or bool(np.isfinite(tree))


def example_launches(study, argv, result):
    """(field kernel, serving kernel) launches that a study's renders and steps imply:
    a teacher frame launches each field once a packet of 4096 rays; render_frame_fast the
    fine field once a packet; a distillation step the teacher once; a served frame the
    serving kernel once a packet; a timed packet 17 times (one warm-up, 16 timed)."""
    flags = {a: b for a, b in zip(argv, argv[1:] + [""]) if a.startswith("--")}
    res = 48 if "--quick" in argv and study in ("distill_morphable", "distill_expression") \
        else int(flags.get("--res", 64))
    frame = 2 * n_packets(res * res, 4096)   # a teacher frame, both fields

    def served(packet):
        return n_packets(res * res, packet)
    if study in ("train_synthetic",):
        return frame, 0
    if study in ("expression_synthetic", "texture_synthetic"):
        return 2 * frame, 0
    if study == "morphable_synthetic":
        return 3 * frame, 0
    if study == "distill_morphable":
        return 2 * frame + int(flags["--distill_steps"]), 2 * served(1024)
    if study == "distill_expression":
        steps = 500 if "--quick" in argv else int(flags.get("--distill_steps", 3000))
        return 2 * frame + steps + 2 * (steps // 2), 7 * served(1024)
    if study == "distill_synthetic":
        # 4 views; render_frame_fast and a timed packet at 2 keeps; 1 student (--quick) or 3;
        # the serving kernel takes the first student only, at S = 16 (--quick) or 16 and 32
        steps = int(flags.get("--distill_steps", 3000))
        quick = "--quick" in argv
        fast = 2 * (4 * n_packets(res * res, 4096) + 17)
        return (4 * frame + fast + (1 if quick else 3) * steps,
                (1 if quick else 2) * (4 * served(4096) + 17))
    if study == "distill_scenes":
        steps = 150 if "--quick" in argv else int(flags.get("--distill_steps", 3000))
        attempts = [len(r["teacher_attempts"]) for r in result["scenes"]]
        return sum(4 * frame * a + steps for a in attempts), 4 * served(4096) * len(attempts)
    raise ValueError(study)


# a study's own process: run_studies.run_study on its argv (JSON), printed as the last line
EXAMPLE_RUNNER = """
import json, sys
import torch
torch.set_num_threads(1)
from mofanerf_tpu_torch.examples.run_studies import run_study
print(json.dumps(run_study(sys.argv[1], json.loads(sys.argv[2]))))
"""


def examples_phase(failures, card, dev, tmp):
    """The synthetic-data studies of mofanerf_tpu_torch/examples, each through its main()
    as `python -m` runs it, each in a process of its own and all eight at once (their
    small steps keep the host busy and leave the card mostly idle): distill_morphable at
    EXAMPLES_RUNS' budgets with its JAX gates (applied by the study), the other seven at
    their quick size. For each: that it ran to its end with its gates, its JSON's keys
    (`_scenes.JSON_KEYS`: the JAX artifact's), every reading finite, and the field and
    serving kernels' launches against what its renders and steps imply, the counts
    (total and by shape) zeroed in its process just before its main() and read just
    after (`run_studies.run_study`). Returns each study's run and the launches by shape
    summed over the studies."""
    from mofanerf_tpu_torch.examples import _scenes

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = {}
    for study, argv, json_name in EXAMPLES_RUNS:
        out = os.path.join(tmp, "examples", study)
        os.makedirs(out, exist_ok=True)
        argv = [out if a == "@OUT" else a for a in argv] + ["--device", str(dev)]
        log = open(os.path.join(out, "log.txt"), "w")
        procs[study] = (subprocess.Popen([sys.executable, "-c", EXAMPLE_RUNNER, study,
                                          json.dumps(argv)], cwd=REPO, env=env, stdout=log,
                                         stderr=subprocess.STDOUT), log, argv, out, json_name)
    t0 = time.perf_counter()
    runs, shapes = {}, {"field": {}, "serve": {}}
    try:
        for study, (proc, log, argv, out, json_name) in procs.items():
            rc = proc.wait(timeout=max(1.0, EXAMPLES_TIMEOUT - (time.perf_counter() - t0)))
            log.close()
            with open(os.path.join(out, "log.txt")) as f:
                text = f.read()
            report = json.loads(text.strip().splitlines()[-1]) if rc == 0 else None
            if report is None or report["status"] != "ok":
                fail(failures, f"examples: {study} {argv[:-2]} did not run to its end (rc "
                               f"{rc}): {text[-2000:]}")
                continue
            launches = tuple(report["launches"])
            for name, rows in report["launch_shapes"].items():
                for *shape, n in rows:
                    shapes[name][tuple(shape)] = shapes[name].get(tuple(shape), 0) + n
            with open(os.path.join(out, json_name)) as f:
                written = json.load(f)
            want = example_launches(study, argv, written)
            keys_ok = _scenes.key_tree(written) == _scenes.JSON_KEYS[study]
            finite = _finite_readings(written)
            runs[study] = {"argv": argv[:-2], "secs": report["wall_secs"], "launches": launches,
                           "launch_shapes": report["launch_shapes"],
                           "expected_launches": want, "timing": report["timing"],
                           "json": written}
            print(f"examples: {study} {' '.join(argv[:-2])}: {report['wall_secs']:.1f} s (beside "
                  f"the other studies); field kernel launches {launches[0]} (expected "
                  f"{want[0]}), serving kernel {launches[1]} (expected {want[1]}); by shape "
                  f"{json.dumps(report['launch_shapes'])}; JSON keys as the JAX artifact's "
                  f"{keys_ok}; readings finite {finite}; {json.dumps(written)}; on {card}",
                  flush=True)
            if tuple(want) != launches or not keys_ok or not finite \
                    or written.get("device") != card:
                fail(failures, f"examples: {study}: launches {launches} (expected {want}), "
                               f"keys {keys_ok}, finite {finite}, device "
                               f"{written.get('device')!r}")
    finally:
        for proc, log, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for label in (*EXAMPLE_FIELDS, *EXAMPLE_STUDENTS):
        part, shape = example_shape(label)
        print(f"examples: {part} kernel launches at the {label} row's shape {shape}: "
              f"{shapes[part].get(shape, 0)}", flush=True)
        if not shapes[part].get(shape):
            fail(failures, f"examples: no {part} kernel launch at {shape} in the studies' runs")
    return runs, shapes


def field_row(failures, card, dev, gen, codes, tag, label, dtype, shape, seed, min_iters=10):
    """The field kernel at `shape` (depth, width, rays, samples a ray; points with one
    sample) with seeded weights and the random `codes` folded in, against its plain
    version on the card (the error, at FIELD_TOL of `dtype`) and timed in turns with it
    (CUDA events), beside its bound: bf16 products at PEAK_BF16, f32 ones as three TF32
    products (and the FFMA bound beside), or the bytes."""
    import torch

    from mofanerf_tpu_torch.models.field import (FieldConfig, fold_conditioning,
                                                 init_field_params)
    from mofanerf_tpu_torch.ops import field_kernel as fk

    depth, width, n_rays, ns = shape
    cfg = FieldConfig(depth=depth, width=width, compute_dtype=dtype)
    params = init_field_params(gen, cfg, device=dev)
    fused = fk.pack_fused_params(params, fold_conditioning(params, *codes), cfg)
    w_dirs = params["view"]["w_dirs"]
    pe, dirf = (point_inputs(cfg, w_dirs, n_rays, seed, dev) if ns == 1
                else field_inputs(cfg, w_dirs, n_rays, ns, seed, dev))
    dt_name = str(dtype).removeprefix("torch.")
    with torch.no_grad():
        got = torch.cat(fk.fused_field_apply(fused, pe, dirf, cfg, ns), -1)
        torch.cuda.synchronize()
        ref = torch.cat(fk.fused_field_apply_ref(fused, pe, dirf, cfg, ns), -1)
        scale = max(1.0, float(ref.abs().max()))
        tol, tol_rms = (t * scale for t in FIELD_TOL[dt_name])
        diff = (got.float() - ref.float()).abs()
        err, rms = float(diff.max()), float(diff.square().mean().sqrt())
        med, turns, _ = in_turns({
            "kernel": lambda: fk.fused_field_apply(fused, pe, dirf, cfg, ns),
            "plain": lambda: fk.fused_field_apply_ref(fused, pe, dirf, cfg, ns)},
            min_iters=min_iters)
    n_layers, n_rows = fused.w_stack.shape[0], n_rays * ns
    ops_count = n_rows * field_flops_per_point(cfg, n_layers)
    f32 = dtype == torch.float32
    t_ops = 3 * ops_count / PEAK_TF32 * 1e3 if f32 else ops_count / PEAK_BF16 * 1e3
    t_bytes = (field_io_bytes(cfg, n_rows, n_rays)
               + field_weight_bytes(cfg, n_layers, 4 if f32 else 2)) / PEAK_BYTES * 1e3
    row = {"ms": med["kernel"], "plain_ms": med["plain"], "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "max_abs_err": err,
           "rms_err": rms, "rays": n_rays, "samples": ns, "turns_ms": turns}
    extra = ""
    if f32:
        t_ffma = ops_count / PEAK_F32 * 1e3
        row["ffma_bound_ms"] = max(t_ffma, t_bytes)
        extra = f", FFMA {t_ffma:.5f}"
    print(f"{tag} field {label} {depth}x{width} {dt_name} ({fk.kernel_config(cfg).width} wide "
          f"in the kernel), {n_rays} rays x {ns}: max|kernel-plain| {err:.3e} rms {rms:.3e} "
          f"(tol {tol:.3e} / {tol_rms:.3e}); kernel {med['kernel']:.4f} ms, plain "
          f"{med['plain']:.4f} ms (medians of turns {turns}); bound {row['bound_ms']:.5f} ms by "
          f"{row['bound_by']} (operations {t_ops:.5f}{extra}, bytes {t_bytes:.5f}) on {card}",
          flush=True)
    if not (err <= tol and rms <= tol_rms) or not bool(torch.isfinite(got).all()):
        fail(failures, f"{tag} field {label}: the kernel disagrees with its plain version")
    return row


def student_row(failures, card, dev, gen, tag, label, shape, o, d, white_bkgd, min_iters=10):
    """The serving kernel for a seeded bf16 student of `shape` (depth, width, multires,
    rays, samples a ray; sigma bias +1.5) on the rays (o, d) in the default box, against
    its plain version on the card (rgb and acc at TOL) and timed in turns with it (CUDA
    events), beside its bound over the rays that hit the box."""
    import torch

    from mofanerf_tpu_torch.models.student import StudentConfig, init_student_params
    from mofanerf_tpu_torch.ops import serve_kernel as sk
    from mofanerf_tpu_torch.ops.bounds import DEFAULT_AABB_MAX, DEFAULT_AABB_MIN

    depth, width, mr, n_rays, ns = shape
    cfg = StudentConfig(depth=depth, width=width, multires=mr, compute_dtype=torch.bfloat16)
    params = init_student_params(gen, cfg, device=dev)
    params["sigma"]["b"] = params["sigma"]["b"] + 1.5
    pack = sk.pack_student(params, cfg)
    aux, dirf = sk.ray_operands(pack, cfg, o, d, 8.0, 26.0, DEFAULT_AABB_MIN, DEFAULT_AABB_MAX)
    n_hit = int((aux[:, 2] > 0).sum())
    with torch.no_grad():
        got = sk._serve_cuda(pack, aux, dirf, cfg, o, d, ns, white_bkgd)
        torch.cuda.synchronize()
        ref = sk._serve_ref(pack, aux, dirf, cfg, o, d, ns, white_bkgd)
        err = float((got[:, :4] - ref[:, :4]).abs().max())
        med, turns, _ = in_turns({
            "kernel": lambda: sk._serve_cuda(pack, aux, dirf, cfg, o, d, ns, white_bkgd),
            "plain": lambda: sk._serve_ref(pack, aux, dirf, cfg, o, d, ns, white_bkgd)},
            min_iters=min_iters)
    t_ops = n_hit * ns * flops_per_sample(depth, width, mr) / PEAK_BF16 * 1e3
    t_bytes = kernel_bytes(n_rays, depth, width, mr, 2) / PEAK_BYTES * 1e3
    row = {"ms": med["kernel"], "plain_ms": med["plain"], "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "max_abs_err": err,
           "rays": n_rays, "hit_rays": n_hit, "samples": ns,
           "design": "wgmma" if sk.uses_wgmma(cfg, ns) else "mma.sync", "turns_ms": turns}
    print(f"{tag} student {label} {depth}x{width} mr{mr} bf16 ({row['design']}), {n_rays} rays "
          f"({n_hit} hit the box) x {ns}: max|kernel-plain| rgb/acc {err:.3e} (tol "
          f"{TOL['bfloat16']}); kernel {med['kernel']:.4f} ms, plain {med['plain']:.4f} ms "
          f"(medians of turns {turns}); bound {row['bound_ms']:.5f} ms by {row['bound_by']} "
          f"(operations over hit rays {t_ops:.5f}, bytes {t_bytes:.5f}) on {card}", flush=True)
    if err > TOL["bfloat16"] or not bool(torch.isfinite(got).all()):
        fail(failures, f"{tag} student {label}: the kernel disagrees with its plain version")
    return row


def examples_kernel_rows(failures, card, dev):
    """The field and serving kernels at the studies' shapes (field_row, student_row):
    f32 fields of 8x64 (4096 rays x 32) and 8x128 (4096 x 64, the union of 32 + 32) of a
    64^2 teacher frame, and the 8x128 field at distill_morphable's 8192 points x 1; the
    avatar student (4x128, multires 10, bf16, 32 samples) at the served frame's packets of
    1024 rays, and the quick student (3x32, multires 6, bf16, 16 samples) at packets of
    4096 rays, on the rays of a 64^2 frame of the studies' camera grid."""
    import torch

    from mofanerf_tpu_torch.datagen.multiview import camera_grid
    from mofanerf_tpu_torch.ops.rays import get_rays

    rows = {}
    gen = torch.Generator().manual_seed(31)
    codes = [torch.randn(n, generator=gen).to(dev) * 0.3 for n in (50, 30, 256)]
    for label, shape in EXAMPLE_FIELDS.items():
        rows[label] = field_row(failures, card, dev, gen, codes, "examples'", label,
                                torch.float32, shape, 33)
    K = torch.tensor([[150.0, 0, 32.0], [0, 150.0, 32.0], [0, 0, 1]], device=dev)
    c2w = torch.as_tensor(camera_grid()[47][:3], dtype=torch.float32, device=dev)
    ro, rd = (r.reshape(-1, 3) for r in get_rays(64, 64, K, c2w))
    for label, shape in EXAMPLE_STUDENTS.items():
        packet = shape[3]
        rows[label] = student_row(failures, card, dev, gen, "examples'", label, shape,
                                  ro[:packet].contiguous(), rd[:packet].contiguous(), False)
    return rows


# the flagship chain (mofanerf_tpu_torch/examples), after the examples phase: the
# full-width model trained on studydata/faces8 for FLAGSHIP_STEPS steps of its JAX run's
# recipe (--device_data --white_bkgd) and evaluated on FLAGSHIP_EVAL_IDS identities, one
# held-out view each; then on that checkpoint, all at once, each in its own process: the
# chain's other scripts at their quick size (serve_flagship also with its default 4x128
# student at FLAGSHIP_SERVE_STEPS distillation steps on one identity, so that the serving
# kernel runs its throughput loop at that student's shape; refine_nerf_corpus with no input
# floor, as a 300-step model's renders sit far under its 16 dB), and morphable_scaling over
# the evaluation's JSON. (tag, study, argv, JSON written); @DATA, @BASE, @OUT, @PHOTOS, @EVAL
# are filled in by the phase
FLAGSHIP_DATA = os.path.join(REPO, "studydata", "faces8")
FLAGSHIP_STEPS, FLAGSHIP_EVAL_IDS, FLAGSHIP_SERVE_STEPS = 300, 2, 300
FLAGSHIP_TRAIN = ("morphable_flagship",
                  ["--stage", "train", "--data", "@DATA", "--basedir", "@BASE",
                   "--iters", str(FLAGSHIP_STEPS), "--device_data", "--white_bkgd",
                   "--i_weights", str(FLAGSHIP_STEPS), "--i_testset", "1000000000"])
FLAGSHIP_EVAL = ("morphable_flagship",
                 ["--stage", "eval", "--data", "@DATA", "--basedir", "@BASE", "--white_bkgd",
                  "--n_ids", str(FLAGSHIP_EVAL_IDS), "--n_test_views", "1",
                  "--out_json", "@OUT/morphable_flagship.json"], "morphable_flagship.json")
FLAGSHIP_MODEL = ["--data", "@DATA", "--basedir", "@BASE"]
FLAGSHIP_RUNS = (
    ("serve_quick", "serve_flagship",
     FLAGSHIP_MODEL + ["--quick", "--white_bkgd", "--out_json", "@OUT/serve_flagship.json"],
     "serve_flagship.json"),
    ("serve_default", "serve_flagship",
     FLAGSHIP_MODEL + ["--white_bkgd", "--ids", "0", "--n_test_views", "1", "--distill_steps",
                       str(FLAGSHIP_SERVE_STEPS), "--out_json", "@OUT/serve_flagship.json"],
     "serve_flagship.json"),
    ("fit_quality", "fit_quality",
     FLAGSHIP_MODEL + ["--quick", "--white_bkgd", "--out_dir", "@OUT/fit",
                       "--out_json", "@OUT/fit_quality.json"], "fit_quality.json"),
    ("expression_matrix", "expression_matrix",
     FLAGSHIP_MODEL + ["--expname", "morphable_flagship", "--n_ids", "8", "--ids", "1",
                       "--poses", "1", "--out_json", "@OUT/expression_matrix.json"],
     "expression_matrix.json"),
    ("refine_nerf_corpus", "refine_nerf_corpus",
     FLAGSHIP_MODEL + ["--quick", "--white_bkgd", "--corpus_dir", "@OUT/corpus",
                       "--min_input_psnr_db", "0", "--out_json", "@OUT/refine_nerf_quality.json"],
     "refine_nerf_quality.json"),
    ("refine_synthetic", "refine_synthetic",
     ["--quick", "--out", "@OUT", "--artifacts", "@OUT/refine_quality.json"],
     "refine_quality.json"),
    ("wild_demo", "wild_demo",
     FLAGSHIP_MODEL + ["--quick", "--photos", "@PHOTOS", "--work_dir", "@OUT/wild",
                       "--out_json", "@OUT/wild_demo.json", "--out_png", "@OUT/wild_demo.png"],
     "wild_demo.json"),
    ("morphable_scaling", "morphable_scaling",
     ["--artifacts_dir", "@EVAL", "--out_json", "@OUT/morphable_scaling.json"],
     "morphable_scaling.json"),
)
FLAGSHIP_TIMEOUT = 300.0   # s for the train and eval process, and again for the rest together
# the chain's shapes that earlier phases' rows lack: bf16 full-width fields (depth, width,
# rays, samples a ray): fit_quality's 64^2 previews and views at packets of 4096 rays, and
# serve_flagship --quick's distillation queries (batch 1024, one sample a point); bf16
# students (depth, width, multires, rays, samples a ray): the throughput loop's 65536 rays
# and the 128^2 frames' packets of 4096, of the default and the --quick student
FLAGSHIP_FIELDS = {"preview coarse": (8, 256, 4096, 64), "preview fine": (10, 1024, 4096, 128),
                   "distill quick": (10, 1024, 1024, 1)}
FLAGSHIP_STUDENTS = {"loop": (4, 128, 10, 65536, 32), "frame": (4, 128, 10, 4096, 32),
                     "quick loop": (3, 32, 6, 65536, 32), "quick frame": (3, 32, 6, 4096, 32)}
# the B1 shapes whose rows earlier phases print (the teacher's packets, distillation's
# queries, --fast's packets), for the launches by shape
TABLED_FIELDS = {("bfloat16", 8, 256, 8192, 64), ("bfloat16", 10, 1024, 8192, 128),
                 ("bfloat16", 10, 1024, 32768, 1), ("bfloat16", 10, 1024, 8192, 32)}


def flagship_shape(label):
    """The wrapper's launch_shapes key of a flagship kernel row."""
    if label in FLAGSHIP_FIELDS:
        return ("field", ("bfloat16",) + FLAGSHIP_FIELDS[label])
    return ("serve", ("bfloat16",) + FLAGSHIP_STUDENTS[label])


# runs of run_studies.run_study in one process, one after another (JSON list on argv),
# each run's report printed as one JSON line
FLAGSHIP_RUNNER = """
import json, sys
import torch
torch.set_num_threads(1)
from mofanerf_tpu_torch.examples.run_studies import run_study
for study, argv in json.loads(sys.argv[1]):
    print(json.dumps(run_study(study, argv)), flush=True)
"""


def _fill(argv, subs):
    out = []
    for a in argv:
        for k, v in subs.items():
            a = a.replace(k, v)
        out.append(a)
    return out


def _photos_argv(argv, photos):
    """wild_demo's argv: on `photos`, or without them (--flagship-only, no wild phase) on
    one photo of the face family it writes itself."""
    if photos is not None or "--photos" not in argv:
        return argv
    i = argv.index("--photos")
    return argv[:i] + ["--synthetic_photos", "1"] + argv[i + 2:]


def _flagship_procs(runs, tmp, dev, env):
    """One process a run of `runs` ((tag, [(study, argv), ...])): {tag: (process, log)}."""
    procs = {}
    for tag, seq in runs:
        log = open(os.path.join(tmp, f"{tag}.log"), "w")
        seq = [(study, argv + ([] if study == "morphable_scaling" else ["--device", str(dev)]))
               for study, argv in seq]
        procs[tag] = (subprocess.Popen([sys.executable, "-c", FLAGSHIP_RUNNER, json.dumps(seq)],
                                       cwd=REPO, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log)
    return procs


def _flagship_reports(failures, procs, tmp, t_end):
    """{tag: [run_study reports]} of the processes, each waited for until t_end; a process
    that failed or timed out, and a run that raised, is a failure."""
    reports = {}
    try:
        for tag, (proc, log) in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, t_end - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            with open(os.path.join(tmp, f"{tag}.log")) as f:
                text = f.read()
            lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"study"')]
            bad = [r for r in lines if r["status"] != "ok"]
            if rc != 0 or bad or not lines:
                fail(failures, f"flagship: {tag} did not run to its end (rc {rc}, "
                               f"{[r['status'] for r in bad]}): {text[-3000:]}")
            reports[tag] = lines
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return reports


def flagship_phase(failures, card, dev, tmp, photos):
    """The flagship chain of mofanerf_tpu_torch/examples on the card, each script through
    its main() as `python -m` runs it (run_studies.run_study: the field and serving
    kernels' launches, total and by shape, zeroed just before its main() and read just
    after): morphable_flagship trains the full-width model (8x256 + 10x1024, bf16, 64 +
    64 samples, 1024 rays a step) on studydata/faces8 for FLAGSHIP_STEPS steps and
    evaluates it (FLAGSHIP_EVAL), in one process; then FLAGSHIP_RUNS on its checkpoint at
    once. For each: that it ran to its end with its gates, its JSON's top-level keys
    (`_flagship.JSON_KEYS`), every reading finite, and its kernel launches: the
    evaluation's field launches are 4 a 128^2 frame (two packets, both fields); every
    script that renders the model launches the field kernel; serve_flagship launches the
    serving kernel 33 times (a warm-up and 32 timed) at its student's loop shape, and
    more on its frames. Returns ({tag: {...}}, launches by shape summed over the runs)."""
    from mofanerf_tpu_torch.examples import _flagship

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    base, out = os.path.join(tmp, "flagship_logs"), os.path.join(tmp, "flagship")
    os.makedirs(out, exist_ok=True)
    subs = {"@DATA": FLAGSHIP_DATA, "@BASE": base, "@PHOTOS": photos or "",
            "@EVAL": os.path.join(out, "eval")}
    runs, shapes = {}, {"field": {}, "serve": {}}
    eval_argv = _fill(FLAGSHIP_EVAL[1], dict(subs, **{"@OUT": os.path.join(out, "eval")}))
    first = [("train", [(FLAGSHIP_TRAIN[0], _fill(FLAGSHIP_TRAIN[1], subs)),
                        (FLAGSHIP_EVAL[0], eval_argv)])]
    t0 = time.perf_counter()
    reports = _flagship_reports(failures, _flagship_procs(first, out, dev, env), out,
                                t0 + FLAGSHIP_TIMEOUT)
    if len(reports.get("train", [])) != 2:
        return runs, shapes
    train_report, eval_report = reports["train"]
    train_secs = time.perf_counter() - t0
    with open(os.path.join(base, "morphable_flagship", "train_log.txt")) as f:
        print("flagship: train_log.txt " + " | ".join(f.read().splitlines()[-4:]), flush=True)
    with open(os.path.join(out, "train.log")) as f:
        steps = [ln for ln in f.read().splitlines() if ln.startswith("[TRAIN]")]
    print("flagship: " + " | ".join(steps[-2:]), flush=True)
    rest = [(tag, [(study, _fill(_photos_argv(argv, photos),
                                 dict(subs, **{"@OUT": os.path.join(out, tag)})))])
            for tag, study, argv, _ in FLAGSHIP_RUNS]
    t1 = time.perf_counter()
    reports.update(_flagship_reports(failures, _flagship_procs(rest, out, dev, env), out,
                                     t1 + FLAGSHIP_TIMEOUT))
    reports["train"] = [train_report]
    reports["eval"] = [eval_report]
    print(f"flagship: train + eval {train_secs:.1f} s; the rest at once "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    json_of = {"eval": (os.path.join(out, "eval"), FLAGSHIP_EVAL[2], "morphable_flagship")}
    json_of.update({tag: (os.path.join(out, tag), name, study)
                    for tag, study, _, name in FLAGSHIP_RUNS})
    for tag, rep in reports.items():
        if not rep:
            continue
        rep = rep[0]
        for name, rows in rep["launch_shapes"].items():
            for *shape, n in rows:
                shapes[name][tuple(shape)] = shapes[name].get(tuple(shape), 0) + n
        entry = {"secs": rep["wall_secs"], "launches": rep["launches"],
                 "launch_shapes": rep["launch_shapes"], "timing": rep["timing"]}
        if tag in json_of:
            d, name, study = json_of[tag]
            with open(os.path.join(d, name)) as f:
                written = json.load(f)
            keys_ok = set(written) == _flagship.JSON_KEYS[study]
            finite = _finite_readings(written)
            device_ok = study == "morphable_scaling" or written.get("device") == card
            entry.update(json=written, keys_ok=keys_ok, finite=finite)
            if not (keys_ok and finite and device_ok):
                fail(failures, f"flagship: {tag}: keys {keys_ok} ({sorted(written)}), finite "
                               f"{finite}, device {written.get('device')!r}")
        runs[tag] = entry
        print(f"flagship: {tag} {rep['argv'][:12]}: {rep['wall_secs']:.1f} s; field kernel "
              f"launches {rep['launches'][0]}, serving kernel {rep['launches'][1]}; by shape "
              f"{json.dumps(rep['launch_shapes'])}; timing {json.dumps(rep['timing'])}; "
              f"{json.dumps(entry.get('json'))[:1500]}; on {card}", flush=True)
    if "eval" in runs:
        j = runs["eval"]["json"]
        frames = (sum(v["n_views"] for v in j["per_identity"].values()) + len(j["per_identity"])
                  + len(j["cross_identity"]) + len(j["identity_interpolation"])
                  + 2 * sum(e["n_views"] for e in j["expression_control"]))
        if runs["eval"]["launches"] != [4 * frames, 0]:
            fail(failures, f"flagship: eval launched {runs['eval']['launches']}, expected "
                           f"[{4 * frames}, 0] for {frames} frames at 128^2")
    for tag in ("serve_quick", "serve_default", "fit_quality", "expression_matrix",
                "refine_nerf_corpus", "wild_demo"):
        if tag in runs and runs[tag]["launches"][0] <= 0:
            fail(failures, f"flagship: {tag} launched no field kernel")
    for tag, label in (("serve_quick", "quick loop"), ("serve_default", "loop")):
        if tag not in runs:
            continue
        part, shape = flagship_shape(label)
        got = dict((tuple(r[:-1]), r[-1]) for r in runs[tag]["launch_shapes"]["serve"])
        loop = runs[tag]["timing"]["throughput_loop"]
        if got.get(shape) != 33 or loop["launches_counted"] != 33 \
                or runs[tag]["launches"][1] <= 33:
            fail(failures, f"flagship: {tag}: serving launches at {shape} {got.get(shape)} "
                           f"(expected 33), loop counted {loop['launches_counted']}, all "
                           f"{runs[tag]['launches'][1]}")
        print(f"flagship: {tag}: serving kernel loop {loop['launches']} x {loop['rays']} rays x "
              f"{loop['samples']} samples of the {loop['student']} student: {loop['secs']:.4f} "
              f"s, {loop['rays_per_sec']:.4e} rays/s (CUDA events) on {card}", flush=True)
    for label in (*FLAGSHIP_FIELDS, *FLAGSHIP_STUDENTS):
        part, shape = flagship_shape(label)
        print(f"flagship: {part} kernel launches at the {label} row's shape {shape}: "
              f"{shapes[part].get(shape, 0)}", flush=True)
        if not shapes[part].get(shape):
            fail(failures, f"flagship: no {part} kernel launch at {shape}")
    untabled = {s: n for s, n in shapes["field"].items()
                if s not in TABLED_FIELDS and s[1:] not in FLAGSHIP_FIELDS.values()}
    print(f"flagship: field kernel launches at shapes without a row: {untabled}", flush=True)
    return runs, shapes


def flagship_kernel_rows(failures, card, dev):
    """The field and serving kernels at the flagship chain's new shapes (field_row,
    student_row; turns of at least 2 launches, since the plain fine field takes ~0.7 s a
    call): the full-width bf16 fields of FLAGSHIP_FIELDS, and the students of
    FLAGSHIP_STUDENTS over white on the rays of the faces8 camera at a held-out pose: the
    first 65536 of a 256^2 frame for the loop shapes, the middle 32 rows of a 128^2 frame
    for the frame shapes."""
    import torch

    from mofanerf_tpu_torch.ops.rays import get_rays, pose_spherical

    rows = {}
    gen = torch.Generator().manual_seed(37)
    codes = [torch.randn(n, generator=gen).to(dev) * 0.3 for n in (50, 30, 256)]
    for label, shape in FLAGSHIP_FIELDS.items():
        rows[label] = field_row(failures, card, dev, gen, codes, "flagship's", label,
                                torch.bfloat16, shape, 39, min_iters=2)
    with open(os.path.join(FLAGSHIP_DATA, "transforms_test_0.json")) as f:
        angle = json.load(f)["camera_angle_x"]
    c2w = torch.as_tensor(pose_spherical(20.0, -10.0, 16.0)[:3], dtype=torch.float32,
                          device=dev)
    rays = {}
    for side in (128, 256):
        focal = 0.5 * side / np.tan(0.5 * angle)
        K = torch.tensor([[focal, 0, side / 2], [0, focal, side / 2], [0, 0, 1]],
                         dtype=torch.float32, device=dev)
        rays[side] = [r.reshape(-1, 3) for r in get_rays(side, side, K, c2w)]
    for label, shape in FLAGSHIP_STUDENTS.items():
        n_rays = shape[3]
        ro, rd = rays[256] if n_rays > 4096 else rays[128]
        lo = 0 if n_rays > 4096 else 48 * 128
        rows[label] = student_row(failures, card, dev, gen, "flagship's", label, shape,
                                  ro[lo:lo + n_rays].contiguous(),
                                  rd[lo:lo + n_rays].contiguous(), True, min_iters=2)
    return rows

def train_step_timing(failures, card, dev, final, cfg, batches):
    """The full-width train step (configs/exp_mofanerf.txt: 8x256 + 10x1024, 64 + 64
    samples, the fine pass on 128, N_rand 1024, UV 512, bf16) from the trained state:
    ms a step (median after two warm-ups, synchronised around each step), peak memory,
    the share of its operations bound, and under torch.profiler the card's busy share
    and the texture encoder's share of the step's kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.train import loop, state as st
    from mofanerf_tpu_torch.utils.tree import tree_leaves

    spec = cfg.model_spec()
    n_warm, n_timed, n_prof = 2, TIMED_STEPS, PROFILED_STEPS
    tx = st.make_optimizer(cfg.lrate, cfg.lrate_decay)
    state = final
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i, batch in enumerate(batches[:n_warm + n_timed]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = st.train_step(state, batch, loop.step_generator(0, i, dev), spec, tx)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not bool(metrics["step_ok"]):
            fail(failures, f"timed train step {i} was skipped (loss {float(metrics['loss'])})")
    peak = torch.cuda.max_memory_allocated(dev)
    ms = float(np.median(times[n_warm:])) * 1e3

    n_fine = spec.render.n_coarse + spec.render.n_importance   # the fine pass on the union
    fwd_field = cfg.N_rand * (
        spec.render.n_coarse * field_flops_per_point(spec.coarse, fk._plan_len(spec.coarse))
        + n_fine * field_flops_per_point(spec.fine, fk._plan_len(spec.fine)))
    fwd_enc = encoder_flops(spec)
    bound_ms = (3 * fwd_field / PEAK_BF16 + 3 * fwd_enc / PEAK_F32) * 1e3
    print(f"train step: {ms:.2f} ms (median of {n_timed} after {n_warm} warm-up; all "
          f"{[round(t * 1e3, 2) for t in times]}), {1e3 / ms:.2f} steps/s, "
          f"{cfg.N_rand * 1e3 / ms:.0f} trained rays/s; peak memory {peak / 2**30:.2f} GiB "
          f"on {card}",
          flush=True)
    print(f"train step: operations bound {bound_ms:.2f} ms = 3 x (fields {fwd_field / 1e12:.3f} "
          f"TFLOP at bf16 peak + texture encoder {fwd_enc / 1e9:.3f} GFLOP at f32 peak); the step "
          f"is {bound_ms / ms:.1%} of its bound", flush=True)

    def one_step():
        nonlocal state
        state, _ = st.train_step(state, batches[-1], loop.step_generator(0, 99, dev), spec, tx)

    syncs = host_syncs(one_step)
    print(f"train step: host synchronisations in 3 + 3 steps (a reading, not a check; "
          f"torch.cuda.set_sync_debug_mode 'warn', then 'error'): "
          f"{'; '.join(syncs) if syncs else 'none'}", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches[n_warm + n_timed:]):
            state, _ = st.train_step(state, batch, loop.step_generator(0, 100 + i, dev), spec, tx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
               for e in kernels) / 1e6
    # the encoder's kernels: its convolutions and LeakyReLUs, forward and backward (its FC
    # layers, a few MFLOP, are not separated from the fields' products)
    enc_ops = ("aten::convolution", "aten::convolution_backward", "aten::leaky_relu",
               "aten::leaky_relu_backward")
    enc = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
              for e in events if e.key in enc_ops) / 1e6
    if busy <= 0:
        print("train step: profiled steps show no device time (busy share not measured)",
              flush=True)
        return dict(ms=ms, bound_ms=bound_ms, peak=peak, enc_share=None)
    self_us = [(e.key, getattr(e, "self_device_time_total", None) or e.self_cuda_time_total)
               for e in kernels]
    top = sorted(self_us, key=lambda kv: -kv[1])[:8]
    n_launch = sum(e.count for e in kernels) / n_prof
    # kernel time by kind: GEMM kernels (cuBLAS products, cuDNN's implicit-GEMM
    # convolutions), everything else
    products = sum(v for k, v in self_us if any(w in k.lower() for w in
                                                 ("gemm", "nvjet", "xmma", "cutlass", "sm90")))
    print(f"train step: kernel time a step by kind: GEMM kernels (products, convolutions) "
          f"{products / n_prof / 1e3:.2f} ms, other kernels (elementwise, reductions, copies) "
          f"{(busy * 1e6 - products) / n_prof / 1e3:.2f} ms", flush=True)
    print(f"train step: profiled {n_prof} steps: {wall / n_prof * 1e3:.2f} ms a step under the "
          f"profiler, card busy {busy / n_prof * 1e3:.2f} ms a step ({busy / wall:.1%}, idle "
          f"{1 - busy / wall:.1%}) in {n_launch:.0f} kernel launches a step "
          f"({len(kernels)} kernels by name; {len(tree_leaves(state.params))} parameter "
          f"leaves, each selected by the skip after one check over all of them); texture encoder "
          f"{enc / n_prof * 1e3:.2f} ms a step, {enc / busy:.1%} of the kernel time; top: "
          + "; ".join(f"{k[:48]} {v / n_prof / 1e3:.2f} ms" for k, v in top) + f" on {card}",
          flush=True)
    return dict(ms=ms, bound_ms=bound_ms, peak=peak, enc_share=enc / busy)


def multicard_inputs(dev):
    """The multi-card phase's inputs, made here from seeds: the teacher phase's
    full-width model (its alpha heads shaped on probe points) and conditioning,
    the serving phase's bf16 4x128 student, a 1024-ray batch through random pixels
    of the 512^2 view, and a fresh train state."""
    import torch
    from types import SimpleNamespace

    from mofanerf_tpu_torch.config import Config
    from mofanerf_tpu_torch.models.student import StudentConfig, init_student_params
    from mofanerf_tpu_torch.ops.embed import fourier_embed
    from mofanerf_tpu_torch.ops.rays import get_rays_at, pose_spherical
    from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                    init_model_params, prepare_conditioning)
    from mofanerf_tpu_torch.train import state as st

    H = TEACHER_SIDE
    spec = Config().model_spec()   # coarse 8x256 + fine 10x1024, bf16, 64 + 64 samples
    K = np.array([[1200.0 * H / 512, 0, H / 2], [0, 1200.0 * H / 512, H / 2], [0, 0, 1]],
                 np.float32)
    c2w = pose_spherical(-25.0, -5.0, 16.0)[:3].astype(np.float32)
    gen = torch.Generator().manual_seed(7)
    params = init_model_params(gen, spec, device=dev)
    uv = torch.rand((spec.uv_size, spec.uv_size, 3), generator=gen).to(dev)
    shape_code = torch.randn(spec.shape_dim, generator=gen).to(dev)
    with torch.no_grad():
        tex = encode_texture(params, spec, uv)
        cond = prepare_conditioning(params, spec, shape_code, exp_code_for(params, 3), tex)
    probe_o, probe_d = kernel_rays(2048, 11, dev)
    probe = probe_o[:, None, :] + probe_d[:, None, :] * torch.linspace(8.0, 26.0, 16, device=dev)[:, None]
    for name, c in (("coarse", cond.coarse), ("fine", cond.fine)):
        cfg = getattr(spec, name)
        shape_density(params[name], cfg, c, fourier_embed(probe.reshape(-1, 3), cfg.multires))
    scfg = StudentConfig(depth=D, width=W, multires=MR, compute_dtype=torch.bfloat16)
    sparams = init_student_params(torch.Generator().manual_seed(1), scfg, device=dev)
    sparams["sigma"]["b"] = sparams["sigma"]["b"] + 1.5
    rng = np.random.default_rng(12)
    coords = torch.from_numpy(rng.integers(0, H, (1024, 2)).astype(np.float32))
    ro, rd = get_rays_at(coords, torch.from_numpy(K), torch.from_numpy(c2w))
    target = torch.from_numpy(rng.uniform(0, 1, (1024, 3)).astype(np.float32))
    batch = st.Batch(rays_o=ro.to(dev), rays_d=rd.to(dev), target_rgb=target.to(dev),
                     shape_code=shape_code, exp_type=torch.tensor(3, device=dev), uv_map=uv)
    return SimpleNamespace(
        H=H, spec=spec, K=K, c2w=c2w, params=params, uv=uv, shape_code=shape_code, tex=tex,
        cond=cond, scfg=scfg, sparams=sparams, rng=rng, batch=batch,
        views=np.stack([pose_spherical(a, -5.0, 16.0) for a in (-30.0, -10.0, 10.0, 30.0)]),
        serve_kw=dict(n_samples=S, packet_size=16384, hit_fraction=None),
        state=st.create_train_state(torch.Generator().manual_seed(3), spec, device=dev),
        tx=st.make_optimizer())


def step_generator_on(dev, seed):
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def multicard_phase(failures, card, dev, step_ms, tmp):
    """The multi-card layer on the one card: a world of one rank over NCCL in
    this process (the sharded teacher frame, the sharded serving path, the
    train step and a device-data chunk, each against its single-card call),
    `parallel.dryrun 1` as a subprocess, and a world of two ranks sharing the
    card over gloo (`world_check`)."""
    import torch

    from mofanerf_tpu_torch.data.device_data import DeviceDataset, DeviceSamplerConfig
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.ops import serve_kernel as sk
    from mofanerf_tpu_torch.parallel import make_mesh
    from mofanerf_tpu_torch.parallel.collectives import all_reduce_mean
    from mofanerf_tpu_torch.parallel.world import single_rank
    from mofanerf_tpu_torch.render.renderer import render_frame, render_frame_sharded
    from mofanerf_tpu_torch.render.serve import render_path_serve
    from mofanerf_tpu_torch.train import state as st
    from mofanerf_tpu_torch.train.loop import train_chunk_device_data
    from mofanerf_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    x = multicard_inputs(dev)
    H, spec, K, c2w, params, cond = x.H, x.spec, x.K, x.c2w, x.params, x.cond
    state, batch, tx = x.state, x.batch, x.tx
    torch.cuda.synchronize()
    out = {}
    # the texture encoder's convolutions: cuDNN's deterministic algorithms, so that two
    # train steps from the same state can be held bit for bit
    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    with single_rank("cuda", os.path.join(REPO, "build")) as rdev:
        mesh = make_mesh()
        print(f"multi-card: world 1 over {torch.distributed.get_backend()} on {rdev}, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)

        # ---- the sharded teacher frame: counts zeroed just before, read just after. That
        # run makes the world's first NCCL collective (the communicator is built on it), so
        # it is not timed: the two are timed after it, in turns (single, sharded, sharded,
        # single: ~3.3 s a frame)
        times = {"single": [], "sharded": []}

        def frame(which):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = (render_frame(params, spec, cond, H, H, K, c2w) if which == "single" else
                   render_frame_sharded(params, spec, cond, H, H, K, c2w, mesh))
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
            return got

        fk.launch_count = 0
        sharded = frame("sharded")
        out["teacher_launches"] = fk.launch_count
        times["sharded"].clear()
        single = frame("single")
        frame("sharded")
        frame("sharded")
        frame("single")
        err = max(float((sharded[k] - single[k]).abs().max()) for k in single)
        out["teacher_ms"] = {k: float(np.mean(v)) * 1e3 for k, v in times.items()}
        print(f"multi-card: render_frame_sharded {H}x{H} (64 + 64 samples) max |diff| to "
              f"render_frame {err:.3e} (tol 1e-6); field kernel launches "
              f"{out['teacher_launches']} (expected 64); ms a frame in turns (the counted "
              f"frame left out), means: sharded {out['teacher_ms']['sharded']:.2f} of "
              f"{[round(t * 1e3, 1) for t in times['sharded']]}, render_frame "
              f"{out['teacher_ms']['single']:.2f} of "
              f"{[round(t * 1e3, 1) for t in times['single']]} on {card}", flush=True)
        if not err <= 1e-6:
            fail(failures, f"render_frame_sharded differs from render_frame by {err}")
        if out["teacher_launches"] != 64:
            fail(failures, f"sharded teacher frame: {out['teacher_launches']} field kernel "
                           f"launches, expected 64")

        # ---- the sharded serving path: counts zeroed just before, read just after
        torch.cuda.synchronize()
        sk.launch_count = 0
        s_sharded = render_path_serve(x.sparams, x.scfg, None, x.views, H, H, K, mesh=mesh,
                                      **x.serve_kw)
        torch.cuda.synchronize()
        out["serve_launches"] = sk.launch_count
        sk.launch_count = 0
        s_single = render_path_serve(x.sparams, x.scfg, None, x.views, H, H, K, **x.serve_kw)
        torch.cuda.synchronize()
        single_launches = sk.launch_count
        err = max(float((s_sharded[k] - s_single[k]).abs().max()) for k in s_single)
        print(f"multi-card: render_path_serve(mesh=) {len(x.views)} views {H}x{H} max |diff| "
              f"to the call without a mesh {err:.3e} (tol 1e-6); serving kernel launches "
              f"{out['serve_launches']} (the call without a mesh: {single_launches})",
              flush=True)
        if not err <= 1e-6 or out["serve_launches"] != single_launches or single_launches == 0:
            fail(failures, f"sharded serving path: max |diff| {err}, launches "
                           f"{out['serve_launches']} vs {single_launches}")

        # ---- the train step: train_step(mesh=) against train_step, same state and draws
        s_one, m_one = st.train_step(state, batch, step_generator_on(dev, 21), spec, tx)
        s_mesh, m_mesh = st.train_step(state, batch, step_generator_on(dev, 21), spec, tx,
                                       mesh=mesh)
        same = (torch.equal(m_one["loss"], m_mesh["loss"])
                and all(torch.equal(a, b) for a, b in zip(tree_leaves(s_one.params),
                                                          tree_leaves(s_mesh.params))))
        times = {"single": [], "mesh": []}
        for which in ("single", "mesh", "mesh", "single", "single", "mesh", "mesh", "single"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.train_step(state, batch, step_generator_on(dev, 22), spec, tx,
                          mesh=mesh if which == "mesh" else None)
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
        out["step_ms"] = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
        leaves = tree_leaves(state.params)
        out["grad_bytes"] = 4 * sum(t.numel() for t in leaves)
        ar = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_mean(leaves, mesh)
            torch.cuda.synchronize()
            ar.append(time.perf_counter() - t0)
        out["world1_all_reduce_ms"] = float(np.median(ar)) * 1e3
        print(f"multi-card: train_step(mesh=) at world 1 bit-equal to train_step: {same} "
              f"(loss {float(m_mesh['loss']):.6f}); ms a step in turns: mesh "
              f"{out['step_ms']['mesh']:.2f}, without {out['step_ms']['single']:.2f} (the "
              f"train-step timing's: {step_ms:.2f}); the flat gradient buffer "
              f"{out['grad_bytes']} bytes, its all_reduce ({torch.distributed.get_backend()}, "
              f"one rank) {out['world1_all_reduce_ms']:.3f} ms on {card}", flush=True)
        if not same:
            fail(failures, "train_step(mesh=) at world 1 differs from train_step")

        # ---- a two-step device-data chunk under the mesh against the one without
        n_frames, rng = 4, x.rng
        store = DeviceDataset(
            images=torch.from_numpy(rng.integers(0, 256, (n_frames, H, H, 3),
                                                 dtype=np.uint8)).to(dev),
            poses=torch.from_numpy(x.views.astype(np.float32)).to(dev),
            shape_codes=torch.from_numpy(rng.standard_normal((n_frames, spec.shape_dim))
                                         .astype(np.float32)).to(dev),
            exp_types=torch.arange(n_frames, dtype=torch.int32, device=dev),
            uv_maps=x.uv[None],
            uv_index=torch.zeros(n_frames, dtype=torch.int32, device=dev),
            lm2d=torch.from_numpy(rng.uniform(H / 4, 3 * H / 4, (n_frames, 68, 2))
                                  .astype(np.float32)).to(dev),
            fg_pixels=torch.zeros((n_frames, 16, 2), dtype=torch.int32, device=dev))
        dscfg = DeviceSamplerConfig(n_rand=1024, H=H, W=H, precrop_iters=0, precrop_frac=0.5,
                                    lm_frac=0.5, lm_frac_anneal_iters=0, bias="landmarks")
        Kt = torch.from_numpy(K).to(dev)
        c_one, cm_one = train_chunk_device_data(state, store, Kt, 0, 2, dscfg, spec, tx, 5)
        c_mesh, cm_mesh = train_chunk_device_data(state, store, Kt, 0, 2, dscfg, spec, tx, 5,
                                                  mesh=mesh)
        same = (int(c_mesh.step) == 2 and torch.equal(cm_one["loss"], cm_mesh["loss"])
                and all(torch.equal(a, b) for a, b in zip(tree_leaves(c_one.params),
                                                          tree_leaves(c_mesh.params))))
        print(f"multi-card: 2-step device-data chunk under the mesh bit-equal to the chunk "
              f"without: {same} (loss {float(cm_mesh['loss']):.6f})", flush=True)
        if not same:
            fail(failures, "the device-data chunk under the mesh differs from the one without")
        del c_one, c_mesh, s_one, s_mesh
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags

    out["dryrun_s"] = run_dryrun(failures, 1)
    out["world2"] = world_check(failures, card, dev, x, 2, "gloo", tmp,
                                refs=(single, s_single))
    print(f"multi-card: the phase in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def run_dryrun(failures, n):
    """`python -m mofanerf_tpu_torch.parallel.dryrun n` (NCCL, a card a rank) and its
    three lines; returns its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mofanerf_tpu_torch.parallel.dryrun", str(n),
                           "--timeout", "240"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip")]
    for ln in lines:
        print(f"multi-card: {ln}", flush=True)
    sec = time.perf_counter() - t0
    print(f"multi-card: parallel.dryrun {n} in {sec:.1f} s", flush=True)
    if proc.returncode != 0 or len(lines) != 3:
        fail(failures, f"parallel.dryrun {n}: rc {proc.returncode}, {len(lines)} lines; "
                       f"{proc.stderr[-2000:]}")
    return sec


def world_check(failures, card, dev, x, n, backend, tmp, refs=None, timed=0):
    """A world of n ranks (parallel/world.py): on mesh (data n, model 1) the
    teacher frame, the serving path and a full-width f32 data-parallel train
    step (256 rays); on mesh (data n/2, model 2), with the fine field in model
    shards, the teacher frame (the shards gathered once a frame) and the same
    train step with the fine field tensor-parallel. Each rank's result is held
    against the single-card call made here (`refs`: the frame and the serving
    maps, when already made). The train step in f32: in bf16 each rank's
    weight gradient (each model rank's partial input gradient) is rounded to
    bf16 before the sum, in another order than one card's (~4e-3 relative),
    which no 1e-5 bound holds. With `timed`, the ranks time that many more
    frames and bf16 steps of the whole 1024-ray batch on (data n, model 1),
    and so does this process on one card first."""
    import torch

    from mofanerf_tpu_torch.bridge import map_tree
    from mofanerf_tpu_torch.parallel import dryrun
    from mofanerf_tpu_torch.parallel.world import run_world
    from mofanerf_tpu_torch.render.renderer import render_frame
    from mofanerf_tpu_torch.render.serve import render_path_serve
    from mofanerf_tpu_torch.train import state as st
    from mofanerf_tpu_torch.utils.tree import tree_leaves

    H, spec, state = x.H, x.spec, x.state
    spec32 = dataclasses.replace(
        spec, coarse=dataclasses.replace(spec.coarse, compute_dtype=torch.float32),
        fine=dataclasses.replace(spec.fine, compute_dtype=torch.float32))
    if refs is None:
        refs = (render_frame(x.params, spec, x.cond, H, H, x.K, x.c2w),
                render_path_serve(x.sparams, x.scfg, None, x.views, H, H, x.K, **x.serve_kw))
    single, s_single = ({k: v.cpu() for k, v in r.items()} for r in refs)
    n_train = 256
    b32 = x.batch._replace(rays_o=x.batch.rays_o[:n_train], rays_d=x.batch.rays_d[:n_train],
                           target_rgb=x.batch.target_rgb[:n_train])
    ref_loss, _, ref_grads = st.batch_grads(state.params, b32, step_generator_on(dev, 31),
                                            spec32)
    ref_state, _ = st.train_step(state, b32, step_generator_on(dev, 31), spec32, x.tx)
    ref_params = [t.cpu() for t in tree_leaves(ref_state.params)]
    ref_grads = [g.cpu() for g in ref_grads]
    del ref_state
    one_card = {}
    if timed:
        def median_s(fn):
            fn()
            ts = []
            for _ in range(timed):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts))

        one_card = {"frame_s": median_s(lambda: render_frame(x.params, spec, x.cond, H, H,
                                                             x.K, x.c2w)),
                    "step_s": median_s(lambda: st.train_step(
                        state, x.batch, step_generator_on(dev, 41), spec, x.tx))}

    def cpu(tree):
        return map_tree(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, tree)

    cpu_state = st.TrainState(cpu(state.params), st.AdamState(
        state.opt_state.count.cpu(), cpu(state.opt_state.mu), cpu(state.opt_state.nu)),
        state.step.cpu())
    payload = {
        "mesh": (n, 1),
        "teacher": dict(spec=spec, params=cpu(x.params), shape=x.shape_code.cpu(), exp=3,
                        tex=x.tex.cpu(), H=H, W=H, K=x.K, c2w=x.c2w, timed=timed),
        "serve": dict(params=cpu(x.sparams), cfg=x.scfg, poses=x.views, H=H, W=H, K=x.K,
                      kw=x.serve_kw),
        "train": dict(spec=spec32, state=cpu_state, batches=[cpu(b32._asdict())],
                      draws=[None], seed=31),
    }
    # the data ranks of each part's mesh: (data n, model 1), and (data n/2, model 2)
    # with the fine field in model shards
    n_data = {"teacher": n, "train": n}
    if n % 2 == 0:
        payload["teacher:tp"] = dict(payload["teacher"], mesh=(n // 2, 2), shard=True, timed=0)
        payload["train:tp"] = dict(payload["train"], mesh=(n // 2, 2), shard=True)
        n_data.update({"teacher:tp": n // 2, "train:tp": n // 2})
    if timed:
        payload["train:bf16"] = dict(spec=spec, state=cpu_state,
                                     batches=[cpu(x.batch._asdict())], draws=[None], seed=41,
                                     timed=timed)
    path = os.path.join(tmp, f"world{n}_payload.pt")
    torch.save(payload, path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = run_world(dryrun.sharded_paths, n, path, workdir=tmp, device="cuda",
                      backend=backend, timeout_s=300.0)
    world_s = time.perf_counter() - t0
    res = {}
    for r, got in enumerate(ranks):
        s_err = max(float((got["serve"]["maps"][k] - s_single[k]).abs().max())
                    for k in s_single)
        print(f"multi-card: world {n} over {backend}, rank {r}: render_path_serve(mesh=) on "
              f"(data {n}, model 1) max |diff| to the call without a mesh {s_err:.3e} "
              f"(tol 1e-6), {got['serve']['launches']} serving kernel launches", flush=True)
        if not (s_err <= 1e-6 and got["serve"]["launches"] > 0):
            fail(failures, f"world {n} rank {r}: serve {s_err} "
                           f"({got['serve']['launches']} launches)")
        for key in [k for k in n_data if k.startswith("teacher")]:
            te, m = got[key], f"(data {n_data[key]}, model {n // n_data[key]})"
            t_err = max(float((te["maps"][k] - single[k]).abs().max()) for k in single)
            want = 2 * -(-H * H // (spec.render.packet_size * n_data[key]))
            print(f"multi-card: world {n} rank {r}: render_frame_sharded {H}x{H} on {m}"
                  f"{', model shards gathered' if key.endswith('tp') else ''} max |diff| to "
                  f"render_frame {t_err:.3e} (tol 1e-6), {te['launches']} field kernel "
                  f"launches (expected {want})", flush=True)
            if not (t_err <= 1e-6 and te["launches"] == want):
                fail(failures, f"world {n} rank {r} {key}: teacher {t_err} "
                               f"({te['launches']} launches)")
            res[f"{key}_max_diff"] = t_err
        for key in [k for k in n_data if k.startswith("train")]:
            tr_, m = got[key], f"(data {n_data[key]}, model {n // n_data[key]})"
            loss_rel = abs(float(tr_["loss"][0]) - float(ref_loss)) / abs(float(ref_loss))
            got_params = tree_leaves(tr_["params"])
            got_grads = tree_leaves(tr_["grads0"])
            p_err = max(float((a - b).abs().max()) for a, b in zip(got_params, ref_params))
            g_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(got_grads, ref_grads))
            # the params' bound: where it fails, it may only be where Adam's first update
            # (~ lr * sign(g)) met a gradient too small for its sign to survive the order of
            # the sums; then the reduced gradients themselves are held
            flips = [(a - b).abs() > 1e-5 for a, b in zip(got_params, ref_params)]
            tiny = all(bool((g[f].abs() < 1e-7).all()) for g, f in zip(ref_grads, flips))
            n_flip = sum(int(f.sum()) for f in flips)
            print(f"multi-card: world {n} rank {r}: f32 train step on {m}"
                  f"{', fine field tensor-parallel' if key.endswith('tp') else ''}, "
                  f"{n_train // n_data[key]} of {n_train} rays a rank: loss rel diff "
                  f"{loss_rel:.2e} (tol 1e-4), params max |diff| {p_err:.2e} (tol 1e-5; "
                  f"{n_flip} elements over it, all with |g| < 1e-7: {tiny}), every leaf's "
                  f"reduced gradient max rel diff {g_rel:.2e} (tol 1e-5); the gradient buffer "
                  f"({tr_['all_reduce_bytes']} bytes) all_reduce over data "
                  f"{tr_['all_reduce_sec'] * 1e3:.2f} ms", flush=True)
            if not loss_rel <= 1e-4 or not (p_err < 1e-5 or (tiny and g_rel <= 1e-5)):
                fail(failures, f"world {n} rank {r} {key}: train step loss {loss_rel}, params "
                               f"{p_err}, grads {g_rel}")
            res[f"{key}_params_max_diff"], res[f"{key}_grads_max_rel"] = p_err, g_rel
        res.update(all_reduce_ms=got["train"]["all_reduce_sec"] * 1e3,
                   all_reduce_bytes=got["train"]["all_reduce_bytes"])
        if timed:
            bf = got["train:bf16"]
            res.update(frame_s=got["teacher"]["sec"], step_s=bf["step_sec"])
            print(f"multi-card: world {n} rank {r}: a 512^2 teacher frame {res['frame_s']:.4f} s "
                  f"(one card: {one_card['frame_s']:.4f} s, {one_card['frame_s'] / res['frame_s']:.2f}x); "
                  f"a bf16 train step of 1024 rays, {1024 // n} a rank, {res['step_s'] * 1e3:.2f} ms "
                  f"(one card: {one_card['step_s'] * 1e3:.2f} ms) on {card}", flush=True)
    print(f"multi-card: world {n} ran in {world_s:.1f} s (spawn, CUDA contexts, payload "
          f"included)", flush=True)
    return dict(res, **({"one_card": one_card} if timed else {}))


def world_main(n, card, dev) -> int:
    """`--world N`: the multi-card paths across N cards over NCCL, a card a rank:
    `parallel.dryrun N`, then `world_check` with each rank's frame and step timed
    against one card's."""
    import torch

    if torch.cuda.device_count() < n:
        print(f"chip_smoke: --world {n} needs {n} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    failures: list = []
    t0 = time.perf_counter()
    x = multicard_inputs(dev)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        dry = run_dryrun(failures, n)
        res = world_check(failures, card, dev, x, n, "nccl", tmp, timed=5)
    print(f"multi-card across {n} cards: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"multi_card_world": dict(res, world=n, dryrun_s=dry, card=card)}),
          flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} failure(s)", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv) -> int:
    kernel_only = "--kernel-only" in argv
    flagship_only = "--flagship-only" in argv
    world = int(argv[argv.index("--world") + 1]) if "--world" in argv else None
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mofanerf_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else "nvidia-smi unavailable"
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"build: {len(libs)} CUDA sources in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "error", "warning")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    failures: list = []
    # each kernel's bf16 products on its wgmma design (the field kernel at its two wgmma
    # widths, the serving kernel at the serving width) must be wgmma in the machine code too:
    # count HGMMA in each library's SASS where the toolkit's cuobjdump is at hand
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    for name in ("field_kernel", "serve_kernel"):
        if not os.path.exists(cuobjdump):
            print(f"sass {name}: not checked (no cuobjdump beside nvcc)", flush=True)
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(libs[name])],
                              capture_output=True, text=True).stdout
        n_hgmma = sass.count("HGMMA")
        print(f"sass {name}: {n_hgmma} HGMMA instructions", flush=True)
        if n_hgmma == 0:
            fail(failures, f"the {name} library holds no HGMMA instruction")
    dev = torch.device("cuda")
    if world:
        return 1 if failures else world_main(world, card, dev)
    if flagship_only:
        with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as work:
            t0 = time.perf_counter()
            flagship_phase(failures, card, dev, work, None)
            print(f"path phase (flagship chain): {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        flagship_kernel_rows(failures, card, dev)
        print(f"kernel phase (the flagship chain's shapes): {time.perf_counter() - t0:.1f} s",
              flush=True)
        return 1 if failures else 0
    t0 = time.perf_counter()
    rows = kernel_phase(failures, dev)
    print(f"kernel phase (serving kernel): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    field_rows = field_kernel_phase(failures, dev)
    print(f"kernel phase (field kernel): {time.perf_counter() - t0:.1f} s", flush=True)
    layer_matmul_phase(dev)
    if kernel_only:
        return 1 if failures else 0
    t0 = time.perf_counter()
    launches = path_phase(failures, card, dev)
    print(f"path phase (serving): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    field_launches, teacher_sec = teacher_path_phase(failures, card, dev, field_rows)
    print(f"path phase (teacher): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    f32_paths = f32_and_small_phase(failures, card, dev, field_rows)
    print(f"path phase (f32 teacher frame, the examples' small model): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"f32_paths": dict(f32_paths, card=card)}), flush=True)
    t0 = time.perf_counter()
    converted = convert_phase(failures, card, dev)
    print(f"path phase (convert: reference .tar -> convert_ckpt -> run_render): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as work:
        t0 = time.perf_counter()
        train_launches, final, train_cfg, batches, render_flags = train_phase(
            failures, card, dev, work)
        print(f"path phase (training): {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        step = train_step_timing(failures, card, dev, final, train_cfg, batches)
        print(f"train step timing: {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"train_step": {
            "ms": step["ms"], "steps_per_s": 1e3 / step["ms"],
            "rays_per_s": train_cfg.N_rand * 1e3 / step["ms"], "bound_ms": step["bound_ms"],
            "peak_memory_bytes": step["peak"], "encoder_share": step["enc_share"],
            "card": card}}), flush=True)
        del final, batches
        t0 = time.perf_counter()
        dist = distill_phase(failures, card, dev, render_flags, work, teacher_sec)
        print(f"path phase (distillation, --fast): {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        fitted = fit_phase(failures, card, dev, render_flags, work)
        print(f"path phase (fitting, evaluate, export_grids): {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        refined = refine_phase(failures, card, dev, render_flags, work)
        print(f"path phase (RefineNet): {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        dd = device_data_phase(failures, card, dev, render_flags, work)
        print(f"path phase (device-resident training data): {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        multi = multicard_phase(failures, card, dev, step["ms"], work)
        print(f"path phase (multi-card: world 1 over NCCL, parallel.dryrun 1, world 2 over "
              f"gloo on one card): {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        datagen, wild = wild_phase(failures, card, dev, render_flags, work)
        print(f"path phase (data generation, wild-photo preprocessing, run_fit): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        formats = formats_phase(failures, card, dev, render_flags, work)
        print(f"path phase (image formats: the committed files, wild_preprocess -> run_fit on "
              f"a progressive, an arithmetic-coded and a smoothed photo, run_train with a "
              f"progressive and an arithmetic-coded UV map): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        examples, example_shapes = examples_phase(failures, card, dev, work)
        print(f"path phase (examples: the eight synthetic-data studies): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        flagship, flagship_shapes = flagship_phase(failures, card, dev, work,
                                                   os.path.join(work, "wild"))
        print(f"path phase (flagship chain: morphable_flagship trained on studydata/faces8 "
              f"and evaluated, the chain's scripts on its checkpoint): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    example_rows = examples_kernel_rows(failures, card, dev)
    print(f"kernel phase (the studies' shapes): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    flagship_rows = flagship_kernel_rows(failures, card, dev)
    print(f"kernel phase (the flagship chain's shapes): {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"convert": converted}), flush=True)
    print(json.dumps({"distill": dist}), flush=True)
    print(json.dumps({"fit": dict(fitted, card=card)}), flush=True)
    print(json.dumps({"refine": dict(refined, card=card)}), flush=True)
    print(json.dumps({"train_device_data": dict(dd, card=card)}), flush=True)
    print(json.dumps({"datagen": datagen}), flush=True)
    print(json.dumps({"preprocess": wild}), flush=True)
    print(json.dumps({"formats": formats}), flush=True)
    print(json.dumps({"multi_card": dict(multi, card=card)}), flush=True)
    print(json.dumps({"examples": dict(examples, card=card)}), flush=True)
    print(json.dumps({"flagship": dict(flagship, card=card)}), flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} failure(s)", file=sys.stderr)
        return 1

    main_row = rows["bfloat16"]   # the dtype the serving path runs
    launched = dist["launches"]
    fit_launched = fitted["launches"]
    # the fitting slice's renders at the teacher's packet shape (both fields a packet:
    # half of the wrapper's count a field), and its fast frames at --fast's shape
    packet_by_path = {"fit": sum(fit_launched[k] for k in
                                 ("fitting", "rendering", "rendering_modulation")) // 2,
                      "evaluate": sum(fit_launched[k] for k in
                                      ("evaluate", "evaluate --render_factor 2")) // 2,
                      "refine_corpus": refined["launches"]["refine_corpus"] // 2,
                      "train_device_data": dd["launches"] // 2,
                      "wild_fit": wild["launches"] // 2,
                      "formats_fit": formats["fit_launches"] // 2,
                      "formats_train": formats["train_launches"] // 2,
                      "convert": converted["launches"] // 2,
                      "sharded_teacher": multi["teacher_launches"] // 2,
                      # the flagship chain's 128^2 and 256^2 frames (the coarse field's count)
                      "flagship": flagship_shapes["field"].get(
                          ("bfloat16", 8, 256, PACKET, 64), 0)}
    slice_launches = {   # the later slices' paths, by the field kernel's shape
        "distill": sum(launched[k]["field"] for k in
                       ("--distill", "--distill_cond", "--distill_avatars"))
        + flagship_shapes["field"].get(("bfloat16", 10, 1024) + SLICE_SHAPES["distill"], 0),
        "fast": launched["--fast"]["field"] + fit_launched["evaluate --fast"]
        + fit_launched["export_grids' grid through render_frame_fast"]
        + refined["launches"]["refine_corpus --fast"]}
    serve_by_path = {"serving": launches,
                     "distill": sum(v["serve"] for v in launched.values()),
                     "sharded_serve": multi["serve_launches"],
                     "flagship": sum(flagship_shapes["serve"].values())}
    field_entries = []
    for name, (depth, width, _) in FIELDS.items():
        row = field_rows[(name, "bfloat16")]   # the dtype the teacher path runs
        field_entries.append({
            "name": f"fused_field_apply[{name} {depth}x{width}]",
            "route": "cuda",
            "source": "mofanerf_tpu_torch/csrc/field_kernel.cu",
            "replaces": "mofanerf_tpu/ops/pallas_field.py:238",
            # render_rays launches each field once a packet: half of the wrapper's count,
            # over the paths that render frames (the teacher render, training's renders,
            # the fit's previews and views, evaluate)
            "launches": (field_launches + train_launches) // 2 + sum(packet_by_path.values()),
            "launches_by_path": {"teacher": field_launches // 2, "train": train_launches // 2,
                                 **packet_by_path},
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "block_rows": row["block_rows"],
            "f32": field_rows[(name, "float32")],
        })
    for label, (n_rays, ns) in SLICE_SHAPES.items():
        row = field_rows[("fine", "bfloat16", label)]
        field_entries.append({
            "name": f"fused_field_apply[fine 10x1024, {label} {n_rays}x{ns}]",
            "route": "cuda",
            "source": "mofanerf_tpu_torch/csrc/field_kernel.cu",
            "replaces": "mofanerf_tpu/ops/pallas_field.py:238",
            "launches": slice_launches[label],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "block_rows": row["block_rows"],
            "f32": field_rows[("fine", "float32", label)],
        })
    # the f32 design (3xTF32) at the teacher's two packets, its launches on the f32 frame's
    # path (half of the wrapper's count a field) and the small model's (padded, width 64)
    small_launches = {k: v["launches"] // 2 for k, v in f32_paths["small_model"].items()}
    for name, key in (("coarse", ("coarse", "float32")), ("fine", ("fine", "float32",
                                                                  "packet_full"))):
        row = field_rows[key]
        depth, width, _ = FIELDS[name]
        field_entries.append({
            "name": f"fused_field_apply[{name} {depth}x{width} f32, 3xTF32 "
                    f"{row['rays']}x{row['samples']}]",
            "route": "cuda",
            "source": "mofanerf_tpu_torch/csrc/field_kernel_tf32.cuh",
            "replaces": "mofanerf_tpu/ops/pallas_field.py:238",
            "launches": f32_paths["f32_teacher"]["launches"] // 2,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "ffma_bound_ms": row["ffma_bound_ms"],
            "block_rows": row["block_rows"],
        })
    # the examples' small model, padded by the wrapper: bf16 through the mma.sync design,
    # f32 through the 3xTF32 one, each field once a frame
    for dt_name, design in (("bfloat16", "field_kernel_mma.cuh"),
                            ("float32", "field_kernel_tf32.cuh")):
        for name, (depth, width, _) in SMALL_FIELDS.items():
            row = f32_paths["small_model"][dt_name]["timing"][name]
            field_entries.append({
                "name": f"fused_field_apply[small {name} {depth}x{width} {dt_name}, padded "
                        f"{row['kernel_config']}, {row['rays']}x{row['samples']}]",
                "route": "cuda",
                "source": f"mofanerf_tpu_torch/csrc/{design}",
                "replaces": "mofanerf_tpu/ops/pallas_field.py:238",
                "launches": small_launches[dt_name],
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "padded_bound_ms": row["padded_bound_ms"],
                "library_ms": None,
            })
    # the studies' shapes: their launches at that shape in the examples phase's runs
    for label, row in example_rows.items():
        part, shape = example_shape(label)
        launches = example_shapes[part][shape]
        if label in EXAMPLE_FIELDS:
            depth, width, n_rays, ns = EXAMPLE_FIELDS[label]
            name = (f"fused_field_apply[examples {label} {depth}x{width} f32, 3xTF32 "
                    f"{n_rays}x{ns}]")
            source = "mofanerf_tpu_torch/csrc/field_kernel_tf32.cuh"
            replaces = "mofanerf_tpu/ops/pallas_field.py:238"
        else:
            depth, width, mr, n_rays, ns = EXAMPLE_STUDENTS[label]
            name = (f"render_rays_bounded_fused[examples {label} {depth}x{width} mr{mr} bf16, "
                    f"{n_rays}x{ns}]")
            source = f"mofanerf_tpu_torch/csrc/serve_kernel_{row['design'].split('.')[0]}.cuh"
            replaces = "mofanerf_tpu/ops/pallas_serve.py:221"
        field_entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    # the flagship chain's shapes: their launches in the flagship phase's runs
    for label, row in flagship_rows.items():
        part, shape = flagship_shape(label)
        if label in FLAGSHIP_FIELDS:
            depth, width, n_rays, ns = FLAGSHIP_FIELDS[label]
            name = f"fused_field_apply[flagship {label} {depth}x{width} bf16, {n_rays}x{ns}]"
            source = "mofanerf_tpu_torch/csrc/field_kernel.cu"
            replaces = "mofanerf_tpu/ops/pallas_field.py:238"
        else:
            depth, width, mr, n_rays, ns = FLAGSHIP_STUDENTS[label]
            name = (f"render_rays_bounded_fused[flagship {label} {depth}x{width} mr{mr} bf16, "
                    f"{n_rays}x{ns}]")
            source = f"mofanerf_tpu_torch/csrc/serve_kernel_{row['design'].split('.')[0]}.cuh"
            replaces = "mofanerf_tpu/ops/pallas_serve.py:221"
        field_entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": flagship_shapes[part].get(shape, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": field_entries + [{
        "name": "render_rays_bounded_fused",
        "route": "cuda",
        "source": "mofanerf_tpu_torch/csrc/serve_kernel.cu",
        "replaces": "mofanerf_tpu/ops/pallas_serve.py:221",
        "launches": sum(serve_by_path.values()),
        "launches_by_path": serve_by_path,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "design": main_row["design"],
        "f32": rows["float32"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
