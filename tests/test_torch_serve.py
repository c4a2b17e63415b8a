"""The serving slice end to end against the JAX package: the plain bounded
render, frames and multi-frame paths through the fused route (JAX: Pallas
in interpret mode; port: the kernel's plain version on the CPU), slab
compaction, and the run_render CLI on a tiny artifact. f32 to 1e-4 (disp
1e-3), bf16 to 2e-2."""
import contextlib
import importlib
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.models import ism as jism
from mofanerf_tpu.models import student as jstudent
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import student
from mofanerf_tpu_torch.ops import serve_kernel as sk
from mofanerf_tpu_torch.ops import serve_rays as sr
from mofanerf_tpu_torch.ops import sweep
from mofanerf_tpu_torch.parallel import make_mesh
from mofanerf_tpu_torch.parallel.world import single_rank
from mofanerf_tpu_torch.render import serve
from mofanerf_tpu_torch.train import distill
from mofanerf_tpu_torch.utils import profiling
from tests.test_torch_serve_kernel import pose_stack, todays_route

jax_serve = importlib.import_module("mofanerf_tpu.render.serve")
jax_sweep = importlib.import_module("mofanerf_tpu.ops.sweep")
jax_rays = importlib.import_module("mofanerf_tpu.ops.rays")
jax_distill = importlib.import_module("mofanerf_tpu.train.distill")

NEAR, FAR = 8.0, 26.0
AABB = ((-2.0,) * 3, (2.0,) * 3)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
T = torch.from_numpy


def _student(dtype, seed, **kw):
    jdt, tdt = DTYPES[dtype]
    jcfg = jstudent.StudentConfig(compute_dtype=jdt, **kw)
    tcfg = student.StudentConfig(compute_dtype=tdt, **kw)
    jp = jstudent.init_student_params(jax.random.PRNGKey(seed), jcfg)
    jp["sigma"]["b"] = jp["sigma"]["b"] + 1.0
    if "cond" in jp:
        jp["cond"]["w_layers"] = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                                   jp["cond"]["w_layers"].shape) * 0.05
    jp = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), bridge.student_to_torch(jp, tcfg, "cpu")


def _check(got, want, tol, disp_tol=None):
    for k in ("rgb", "acc", "depth"):
        g = got[k].float().numpy()
        w = np.asarray(want[k], np.float32)
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)
    dt = disp_tol or tol
    np.testing.assert_allclose(got["disp"].float().numpy(), np.asarray(want["disp"], np.float32),
                               rtol=dt, atol=dt)


@pytest.mark.parametrize("dtype,activation,white_bkgd", [
    ("float32", "relu", False), ("float32", "softplus", True), ("bfloat16", "relu", True)])
def test_render_rays_bounded_plain_path(dtype, activation, white_bkgd):
    jcfg, tcfg, jp, tp = _student(dtype, 0, depth=3, width=64, multires=6)
    rng = np.random.default_rng(0)
    ro = np.tile(np.array([[0.0, 0, 16.0]], np.float32), (96, 1))
    rd = (rng.standard_normal((96, 3)) * [0.1, 0.1, 0.0] - [0, 0, 1]).astype(np.float32)
    rd[:8] = [0, 0, 1.0]   # misses
    want = jax_serve.render_rays_bounded(jp, jcfg, None, jnp.asarray(ro), jnp.asarray(rd),
                                         NEAR, FAR, 16, *AABB, white_bkgd=white_bkgd,
                                         sigma_activation=activation)
    got = serve.render_rays_bounded(tp, tcfg, None, T(ro), T(rd), NEAR, FAR, 16, *AABB,
                                    white_bkgd=white_bkgd, sigma_activation=activation)
    tol = 1e-4 if dtype == "float32" else 2e-2
    _check(got, want, tol, 1e-3 if dtype == "float32" else tol)


def _K(H, focal):
    return np.array([[focal, 0, H / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("dtype,H,hit_fraction,packet_size", [
    ("float32", 16, 1.0, 256),
    ("float32", 16, 0.5, 64),       # compaction: hits first, background scattered back
    ("float32", 18, 1.0, 8192),     # 324 rays: not a multiple of 256, below the packet
    ("bfloat16", 18, None, 256),    # auto-budgeted compaction
])
def test_render_frame_serve_matches_jax(dtype, H, hit_fraction, packet_size):
    jcfg, tcfg, jp, tp = _student(dtype, 1, depth=3, width=128, multires=6)
    K = _K(H, 30.0)
    c2w = jax_rays.pose_spherical(10.0, -5.0, 16.0)[:3]
    kw = dict(near=NEAR, far=FAR, n_samples=8, aabb_min=AABB[0], aabb_max=AABB[1],
              packet_size=packet_size, hit_fraction=hit_fraction)
    want = jax_serve.render_frame_serve(jp, jcfg, None, H, H, jnp.asarray(K), jnp.asarray(c2w),
                                        fused=True, **kw)
    got = serve.render_frame_serve(tp, tcfg, None, H, H, K, c2w, fused=True, **kw)
    assert got["rgb"].shape == (H, H, 3) and got["acc"].shape == (H, H)
    tol = 1e-4 if dtype == "float32" else 2e-2
    _check(got, want, tol, 1e-3 if dtype == "float32" else tol)
    assert (got["acc"] > 0.5).any() and (got["acc"] == 0).any()
    # the plain route against the JAX plain route (in bf16 the two routes round
    # at different places, so each is held against its own counterpart)
    want = jax_serve.render_frame_serve(jp, jcfg, None, H, H, jnp.asarray(K), jnp.asarray(c2w),
                                        fused=False, **kw)
    got = serve.render_frame_serve(tp, tcfg, None, H, H, K, c2w, fused=False, **kw)
    _check(got, want, tol, 1e-3 if dtype == "float32" else tol)


def test_render_frame_serve_folds_a_code():
    jcfg, tcfg, jp, tp = _student("float32", 2, depth=2, width=128, multires=4, cond_dim=6)
    code = np.random.default_rng(2).standard_normal(6).astype(np.float32) * 0.3
    K = _K(16, 30.0)
    c2w = jax_rays.pose_spherical(-20.0, 5.0, 16.0)[:3]
    kw = dict(near=NEAR, far=FAR, n_samples=8, aabb_min=AABB[0], aabb_max=AABB[1],
              packet_size=256, hit_fraction=1.0)
    want = jax_serve.render_frame_serve(jp, jcfg, jnp.asarray(code), 16, 16, jnp.asarray(K),
                                        jnp.asarray(c2w), fused=True, **kw)
    got = serve.render_frame_serve(tp, tcfg, T(code), 16, 16, K, c2w, **kw)   # fused default
    _check(got, want, 1e-4, 1e-3)


@pytest.mark.parametrize("hit_fraction", [1.0, None])
def test_render_path_serve_matches_jax(hit_fraction, tmp_path):
    jcfg, tcfg, jp, tp = _student("float32", 3, depth=3, width=128, multires=6, cond_dim=5)
    code = np.random.default_rng(3).standard_normal(5).astype(np.float32) * 0.3
    poses = np.stack([jax_rays.pose_spherical(a, -5.0, 16.0) for a in (-20.0, 0.0, 25.0)])
    K = _K(16, 30.0)
    kw = dict(near=NEAR, far=FAR, n_samples=8, aabb_min=AABB[0], aabb_max=AABB[1],
              packet_size=256, hit_fraction=hit_fraction)
    want = jax_serve.render_path_serve(jp, jcfg, jnp.asarray(code), jnp.asarray(poses), 16, 16,
                                       jnp.asarray(K), fused=True, **kw)
    got = serve.render_path_serve(tp, tcfg, T(code), poses, 16, 16, K, **kw)
    assert got["rgb"].shape == (3, 16, 16, 3)
    _check(got, want, 1e-4, 1e-3)
    # the multi-card path on a world of one rank (gloo, in this process) is the path
    with single_rank("cpu", str(tmp_path)):
        sharded = serve.render_path_serve(tp, tcfg, T(code), poses, 16, 16, K, mesh=make_mesh(),
                                          **kw)
    assert set(sharded) == set(got) and all(torch.equal(sharded[k], got[k]) for k in got)


def test_compaction_and_buckets_match_jax():
    for frac in (0.0, 0.1, 0.25, 0.26, 0.74, 0.99, 1.0, 1.5):
        assert sweep.bucket_fraction(frac) == jax_sweep.bucket_fraction(frac)
    rng = np.random.default_rng(4)
    ro = np.tile(np.array([[0.0, 0, 16.0]], np.float32), (300, 1))
    rd = (rng.standard_normal((300, 3)) * [0.2, 0.2, 0.0] - [0, 0, 1]).astype(np.float32)
    for hf in (0.25, 0.5, None):
        j = jax_sweep._compact_rays(jnp.asarray(ro), jnp.asarray(rd), 64, *AABB, NEAR, FAR, hf)
        t = sweep.compact_rays(T(ro), T(rd), 64, *AABB, NEAR, FAR, hf)
        assert t[3] == j[3]
        if j[2] is None:
            assert t[2] is None
        else:
            np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))   # stable order
            np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))


def _read_png(path):
    """Decode an 8-bit RGB PNG written without filters (as write_png does)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = (int.from_bytes(body[4:8], "big"), int.from_bytes(body[0:4], "big"))
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    h, w = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_run_render_cli_serves_an_artifact(tmp_path):
    from mofanerf_tpu_torch.cli import run_render

    jcfg, tcfg, jp, _ = _student("bfloat16", 5, depth=2, width=128, multires=6)
    path = str(tmp_path / "student.npz")
    prov = jax_distill.distill_provenance(jax_distill.DistillConfig(), person=0, expression=0)
    jax_distill.save_student(path, jp, jcfg, provenance=prov)
    out = tmp_path / "frames"
    argv = ["--out_dir", str(out), "--student_path", path, "--n_views", "2",
            "--render_factor", "32", "--n_samples", "8", "--device", "cpu"]
    frames = run_render.main(argv)
    assert frames.shape == (2, 16, 16, 3) and np.isfinite(frames).all()
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert pngs == ["000.png", "001.png"]
    from mofanerf_tpu_torch.utils.metrics import to8b

    np.testing.assert_array_equal(_read_png(out / pngs[1]), to8b(frames[1]))
    # the same orbit frame rendered by the JAX package from the same artifact
    jparams, jcfg2 = jax_distill.load_student(path)
    K = jnp.asarray(np.array([[1200.0 / 32, 0, 8], [0, 1200.0 / 32, 8], [0, 0, 1]]))
    pose = jax_rays.pose_spherical(0.0, 0.0, 16.0)[:3]
    want = jax_serve.render_frame_serve(jparams, jcfg2, None, 16, 16, K, jnp.asarray(pose),
                                        near=NEAR, far=FAR, n_samples=8, packet_size=256,
                                        hit_fraction=1.0, fused=True)
    np.testing.assert_allclose(frames[1], np.asarray(want["rgb"]), rtol=2e-2, atol=2e-2)

    # provenance is enforced; an unconditioned artifact cannot serve a rig; a
    # missing artifact is distilled only when asked to; a conditioned artifact of
    # neither the expression (30) nor the avatar (80) code width is refused
    with pytest.raises(SystemExit, match="person"):
        run_render.main(argv + ["--person", "3"])
    with pytest.raises(SystemExit, match="needs an expression-conditioned student"):
        run_render.main(argv + ["--distill_cond"])
    with pytest.raises(SystemExit, match="no student artifact"):
        run_render.main(["--out_dir", str(out), "--student_path", str(tmp_path / "none.npz"),
                         "--device", "cpu"])
    ccfg = student.StudentConfig(depth=1, width=16, multires=2, cond_dim=4)
    cpath = str(tmp_path / "cond.npz")
    distill.save_student(cpath, student.init_student_params(
        torch.Generator().manual_seed(0), ccfg, device="cpu"), ccfg)
    with pytest.raises(SystemExit, match="matches neither"):
        run_render.main(["--out_dir", str(out), "--student_path", cpath, "--device", "cpu"])


def test_expression_rig_of_a_conditioned_student_matches_jax():
    """The serving rig: ISM-modulated expression codes (student_code) fold
    into a conditioned student and render through render_path_serve."""
    jax_renderer = importlib.import_module("mofanerf_tpu.render.renderer")

    jcfg, tcfg, jp, tp = _student("float32", 6, depth=2, width=128, multires=4, cond_dim=30)
    jm = jax.tree.map(np.asarray, {
        "ism": jism.init_ism_params(jax.random.PRNGKey(7)),
        "exp_codes": jax.random.uniform(jax.random.PRNGKey(8), (21, 30))})
    tm = bridge.serving_params_to_torch(jm, device="cpu")
    jm = jax.tree.map(jnp.asarray, jm)
    shape = np.random.default_rng(9).standard_normal(50).astype(np.float32)
    poses = np.stack([jax_rays.pose_spherical(a, 0.0, 16.0) for a in (-15.0, 15.0)])
    K = _K(16, 30.0)
    kw = dict(near=NEAR, far=FAR, n_samples=8, aabb_min=AABB[0], aabb_max=AABB[1],
              packet_size=256, hit_fraction=None)
    from mofanerf_tpu_torch.render.renderer import exp_code_for

    for e in (0, 9):
        jcode = jax_distill.student_code(jm, jnp.asarray(shape),
                                         jax_renderer.exp_code_for(jm, e))
        tcode = distill.student_code(tm, T(shape), exp_code_for(tm, e))
        want = jax_serve.render_path_serve(jp, jcfg, jcode, jnp.asarray(poses), 16, 16,
                                           jnp.asarray(K), fused=True, **kw)
        got = serve.render_path_serve(tp, tcfg, tcode, poses, 16, 16, K, **kw)
        _check(got, want, 1e-4, 1e-3)


# ---- the fused route: rays and operands made by one serve_rays call


def _packed_student(dtype, seed=2, depth=3, width=64, multires=6):
    cfg = student.StudentConfig(depth=depth, width=width, multires=multires, compute_dtype=dtype)
    params = student.init_student_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    params["sigma"]["b"] = params["sigma"]["b"] + 1.5
    return cfg, params


def _refuse(*args, **kw):
    raise AssertionError("a route that keeps its chain reached serve_rays")


@pytest.mark.parametrize("what,hit_fraction", [("frame", 1.0), ("frame", None), ("frame", 0.5),
                                                ("path", 1.0), ("path", None), ("path", 0.25)])
def test_cpu_route_is_the_plain_chain_bit_for_bit(monkeypatch, what, hit_fraction):
    """On CPU tensors the frame and the path make their rays and operands with
    serve_rays' plain version (its kernel wrapper is never reached) and give,
    bit for bit, the maps of the route that made them in small operations
    after its compaction (`todays_route`), in f32 and bf16."""
    monkeypatch.setattr(sr, "_serve_rays_cuda", _refuse)
    H = 20
    K = _K(H, 30.0)
    poses = pose_stack([(-20.0, 5.0), (0.0, -5.0), (25.0, 10.0)][:1 if what == "frame" else 3])
    kw = dict(near=NEAR, far=FAR, n_samples=8, aabb_min=AABB[0], aabb_max=AABB[1],
              packet_size=256, hit_fraction=hit_fraction)
    for dtype in (torch.float32, torch.bfloat16):
        cfg, params = _packed_student(dtype)
        pack = sk.pack_student(params, cfg)
        if what == "frame":
            got = {k: v[None] for k, v in serve.render_frame_serve(
                params, cfg, None, H, H, K, poses[0][:3], **kw).items()}
        else:
            got = serve.render_path_serve(pack, cfg, None, poses, H, H, K, **kw)
        want = todays_route(pack, cfg, H, H, K, poses, 256, hit_fraction, n_samples=8, box=AABB)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (dtype, k)
        assert (got["acc"] == 0).any() and (got["acc"] > 0.5).any()


@pytest.mark.parametrize("packet_size", [128, 512, 4096])
def test_operands_gathered_by_sel_are_those_made_after_compaction(packet_size):
    """hit_fraction=0.5: sweep_made gathers the kept rays' operands out of those
    serve_rays made for every ray (with the padding rows, where the budget keeps
    every ray: packets of 4096 over 1152 rays), and each packet gets the rays
    and operands that sweep_rays gives it when it makes them after its own
    compaction; the maps are the same."""
    cfg, params = _packed_student(torch.bfloat16, seed=4)
    pack = sk.pack_student(params, cfg)
    H = 24
    K = T(_K(H, 30.0))
    poses = T(pose_stack([(-15.0, 5.0), (30.0, -10.0)]))
    lo, hi = torch.tensor(AABB[0]), torch.tensor(AABB[1])
    n = 2 * H * H
    p, rows = sweep.packet_plan(n, packet_size, sk._BLOCK_R)
    made = sr.serve_rays(pack, cfg, H, H, K, poses, NEAR, FAR, lo, hi, rows)
    assert rows - n == (128 if packet_size == 4096 else (-n) % p)

    def packets(seen):
        def ray_fn(o, d, aux, dirf):
            seen.append((o, d, aux, dirf))
            return sk.render_packet_fused(pack, cfg, o, d, aux, dirf, 8, False)
        return ray_fn

    seen_made, seen_swept = [], []
    got = sweep.sweep_made(packets(seen_made), made, packet_size, 0.5, False, sk._BLOCK_R)
    want = sweep.sweep_rays(
        packets(seen_swept), made.rays_o[:n], made.rays_d[:n], packet_size, aabb_min=lo,
        aabb_max=hi, near=NEAR, far=FAR, hit_fraction=0.5, packet_multiple=sk._BLOCK_R,
        prepare=lambda o, d: sk.ray_operands(pack, cfg, o, d, NEAR, FAR, lo, hi))
    assert len(seen_made) == len(seen_swept) >= 1
    for a, b in zip(seen_made, seen_swept):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (got["acc"] == 0).any() and (got["acc"] > 0.5).any()


def test_routes_that_keep_their_chain_never_reach_serve_rays(monkeypatch, tmp_path):
    """fused=False (frame and path) and the mesh route make their rays with
    get_rays and their operands after compaction, as before: serve_rays, set to
    raise, is never called (the occupancy renderer: tests/test_torch_occupancy.py)."""
    monkeypatch.setattr(sr, "serve_rays", _refuse)
    monkeypatch.setattr(serve, "serve_rays", _refuse)
    cfg, params = _packed_student(torch.float32)
    H = 16
    K = _K(H, 30.0)
    poses = pose_stack([(-20.0, 5.0), (20.0, 5.0)])
    kw = dict(near=NEAR, far=FAR, n_samples=8, aabb_min=AABB[0], aabb_max=AABB[1],
              packet_size=256, hit_fraction=None)
    frame = serve.render_frame_serve(params, cfg, None, H, H, K, poses[0][:3], fused=False, **kw)
    path = serve.render_path_serve(params, cfg, None, poses, H, H, K, fused=False, **kw)
    assert torch.equal(frame["rgb"], path["rgb"][0])
    with single_rank("cpu", str(tmp_path)):
        sharded = serve.render_path_serve(params, cfg, None, poses, H, H, K, mesh=make_mesh(),
                                          **kw)
    assert sharded["rgb"].shape == (2, H, H, 3) and (sharded["acc"] > 0.5).any()
    with pytest.raises(AssertionError, match="reached serve_rays"):
        serve.render_frame_serve(params, cfg, None, H, H, K, poses[0][:3], **kw)


def test_tracing_counts_the_frames_whose_rays_serve_rays_made():
    """counters["serve_rays_frames"] counts the frames whose rays the kernel
    made, at its launch (1 a frame, F a path: the `cuda` test of
    tests/test_torch_serve_kernel.py). On CPU tensors serve_rays runs its plain
    version and launches nothing, so while a torch.profiler records the counter
    stays empty on every route, as it does with tracing off."""
    cfg, params = _packed_student(torch.float32)
    H = 16
    K = _K(H, 30.0)
    poses = pose_stack([(-20.0, 5.0), (0.0, 5.0), (20.0, 5.0)])
    kw = dict(near=NEAR, far=FAR, n_samples=8, aabb_min=AABB[0], aabb_max=AABB[1],
              packet_size=256)

    def traced(fn):
        profiling.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            fn()
        return profiling.counters

    try:
        for fn in (lambda: serve.render_frame_serve(params, cfg, None, H, H, K, poses[1][:3],
                                                    **kw),
                   lambda: serve.render_path_serve(params, cfg, None, poses, H, H, K, **kw),
                   lambda: serve.render_path_serve(params, cfg, None, poses, H, H, K,
                                                   fused=False, **kw)):
            counters = traced(fn)
            assert "serve_rays_frames" not in counters and counters["host_reads"] == 1
        profiling.reset()
        serve.render_path_serve(params, cfg, None, poses, H, H, K, **kw)
        assert profiling.counters == {}
    finally:
        profiling.reset()


@pytest.mark.parametrize("n", [1, 7, 1000, 262144, 15728640])
def test_hit_share_is_the_f32_mean_of_the_mask(n):
    """sweep_made buckets hit_share(count, n), compact_rays hit.float().mean():
    the same number on the CPU, at the bucket bounds and next to them too."""
    rng = np.random.default_rng(n)
    hit = torch.zeros(n, dtype=torch.bool)
    for k in sorted({0, 1, n // 4, n // 4 + 1, n // 2, n // 2 + 1, 3 * n // 4, 3 * n // 4 + 1,
                     n - 1, n, int(rng.integers(0, n + 1))}):
        if 0 <= k <= n:
            hit[:] = False
            hit[:k] = True
            assert sweep.hit_share(k, n) == hit.float().mean().item(), k
            assert (sweep.bucket_fraction(sweep.hit_share(k, n))
                    == sweep.bucket_fraction(hit.float().mean().item()))


def test_serve_rays_runs_on_cuda_or_cpu_and_counts_no_launch_on_the_cpu():
    cfg, params = _packed_student(torch.float32)
    pack = sk.pack_student(params, cfg)
    K, poses = T(_K(8, 10.0)), T(pose_stack([(0.0, 0.0)]))
    lo, hi = torch.tensor(AABB[0]), torch.tensor(AABB[1])
    before = sr.launch_count
    made = sr.serve_rays(pack, cfg, 8, 8, K, poses, NEAR, FAR, lo, hi, 70)
    assert sr.launch_count == before and made.n == 64 and made.aux.shape == (70, 4)
    assert torch.equal(made.rays_o[64:], torch.ones(6, 3)) and int(made.n_hit) == int(
        (made.aux[:64, 2] > 0).sum())
    meta = sk.pack_student(params, cfg)._replace(w_dirs=pack.w_dirs.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        sr.serve_rays(meta, cfg, 8, 8, K, poses, NEAR, FAR, lo, hi)


def test_serve_rays_refuses_w_dirs_off_a_16_byte_boundary(monkeypatch):
    """The kernel copies w_dirs 16 bytes at a time: the wrapper refuses a view
    that starts 4 bytes into its buffer (a slice of a flat parameter buffer)
    before anything is launched; pack_student's own w_dirs starts aligned."""
    def no_launch():
        raise AssertionError("serve_rays reached its launch")

    monkeypatch.setattr(sr, "_fn", no_launch)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    cfg, params = _packed_student(torch.float32)
    pack = sk.pack_student(params, cfg)
    assert pack.w_dirs.data_ptr() % 16 == 0
    flat = torch.zeros(pack.w_dirs.numel() + 1)
    view = flat[1:].view(pack.w_dirs.shape)
    view.copy_(pack.w_dirs)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    K, poses = T(_K(8, 10.0)), T(pose_stack([(0.0, 0.0)]))
    lo, hi = torch.tensor(AABB[0]), torch.tensor(AABB[1])
    with pytest.raises(ValueError, match="16-byte boundary"):
        sr._serve_rays_cuda(pack._replace(w_dirs=view), cfg, 8, 8, K, poses, NEAR, FAR, lo,
                            hi, 64)
    with pytest.raises(AssertionError, match="reached its launch"):   # aligned: on to the launch
        sr._serve_rays_cuda(pack, cfg, 8, 8, K, poses, NEAR, FAR, lo, hi, 64)
