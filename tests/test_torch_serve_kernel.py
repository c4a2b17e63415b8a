"""The fused serving kernel's plain PyTorch version against the JAX Pallas
kernel in interpret mode (f32 to 1e-4, disp to 1e-3; bf16 to 2e-2), the
wrapper's dispatch and checks, and -- on a card only -- the CUDA kernel
against its plain version."""
import importlib

import numpy as np
import pytest
import torch

from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import student
from mofanerf_tpu_torch.ops import serve_kernel as sk
from mofanerf_tpu_torch.utils import cuda_build, profiling, serve_variants


def _jax():
    """The JAX reference, imported on use: the card machine runs this file's
    `cuda` test with no JAX installed (see README, PyTorch port)."""
    import jax
    import jax.numpy as jnp

    return (jax, jnp, importlib.import_module("mofanerf_tpu.models.student"),
            importlib.import_module("mofanerf_tpu.ops.pallas_serve"),
            importlib.import_module("mofanerf_tpu.render.serve"))


NEAR, FAR = 8.0, 26.0
AABB = ((-2.0,) * 3, (2.0,) * 3)


def _rays(n, seed=0):
    """Origins at (0, 0, 16); hitting and missing, unnormalised directions;
    the first n/8 rays miss."""
    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0.0, 0, 16.0]], np.float32), (n, 1))
    to = rng.standard_normal((n, 3)) * np.array([1.5, 1.5, 0.2]) - [0, 0, 16]
    rd = to / np.linalg.norm(to, axis=-1, keepdims=True) * rng.uniform(0.7, 1.4, (n, 1))
    rd[: n // 8] = [0.0, 0, 1.0]
    return ro, rd.astype(np.float32)


def _student(dtype, seed, sigma_shift=1.5, **kw):
    jax, jnp, jstudent, _, _ = _jax()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = jstudent.StudentConfig(compute_dtype=jdt, **kw)
    tcfg = student.StudentConfig(compute_dtype=tdt, **kw)
    jp = jax.tree.map(np.asarray, jstudent.init_student_params(jax.random.PRNGKey(seed), jcfg))
    jp["sigma"]["b"] = jp["sigma"]["b"] + sigma_shift   # visible structure
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), bridge.student_to_torch(jp, tcfg, "cpu")


def _check(got, want, tol, disp_tol):
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=tol, atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(want["disp"]),
                               rtol=disp_tol, atol=disp_tol)


@pytest.mark.parametrize("dtype,white_bkgd,depth,multires,n_rays,n_samples,seed", [
    ("float32", False, 4, 8, 256, 16, 0),
    ("float32", True, 3, 6, 512, 8, 2),
    ("bfloat16", True, 4, 8, 256, 8, 1),
    ("bfloat16", False, 2, 4, 256, 16, 3),
])
def test_plain_version_matches_pallas_kernel(dtype, white_bkgd, depth, multires, n_rays,
                                             n_samples, seed):
    _, jnp, _, pallas_serve, _ = _jax()
    jcfg, tcfg, jp, tp = _student(dtype, seed, depth=depth, width=128, multires=multires)
    ro, rd = _rays(n_rays, seed)
    want = pallas_serve.render_rays_bounded_fused(
        jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), NEAR, FAR, n_samples, *AABB,
        white_bkgd=white_bkgd, interpret=True)
    got = sk.render_rays_bounded_fused_ref(tp, tcfg, torch.from_numpy(ro), torch.from_numpy(rd),
                                           NEAR, FAR, n_samples, *AABB, white_bkgd=white_bkgd)
    tol = 1e-4 if dtype == "float32" else 2e-2
    _check(got, want, tol, 1e-3 if dtype == "float32" else tol)
    # miss rays are exactly background in both
    bg = 1.0 if white_bkgd else 0.0
    miss = n_rays // 8
    assert (got["rgb"][:miss] == bg).all() and (got["acc"][:miss] == 0).all()
    assert (got["disp"][:miss] == 1e10).all()
    assert (got["acc"] > 0.5).any(), "scene unexpectedly empty"


def test_wrapper_on_cpu_is_the_plain_version():
    _, tcfg, _, tp = _student("float32", 4, depth=2, width=64, multires=4)
    ro, rd = (torch.from_numpy(a) for a in _rays(200, 4))   # not a multiple of 256
    before = sk.launch_count
    got = sk.render_rays_bounded_fused(tp, tcfg, ro, rd, NEAR, FAR, 8, *AABB)
    want = sk.render_rays_bounded_fused_ref(tp, tcfg, ro, rd, NEAR, FAR, 8, *AABB)
    for k in want:
        assert torch.equal(got[k], want[k])
    assert got["rgb"].shape == (200, 3) and got["disp"].shape == (200,)
    assert sk.launch_count == before   # the CPU path launches no kernel


def test_plain_version_serves_a_folded_conditioned_student():
    jax, jnp, jstudent, _, jax_serve = _jax()
    jcfg = jstudent.StudentConfig(depth=3, width=128, multires=6, cond_dim=6,
                                  compute_dtype=jnp.float32)
    tcfg = student.StudentConfig(depth=3, width=128, multires=6, cond_dim=6,
                                 compute_dtype=torch.float32)
    jp = jstudent.init_student_params(jax.random.PRNGKey(7), jcfg)
    jp["sigma"]["b"] = jp["sigma"]["b"] + 1.5
    jp["cond"]["w_layers"] = jax.random.normal(jax.random.PRNGKey(8),
                                               jp["cond"]["w_layers"].shape) * 0.05
    jp = jax.tree.map(np.asarray, jp)
    tp = bridge.student_to_torch(jp, tcfg, "cpu")
    code = np.random.default_rng(9).standard_normal(6).astype(np.float32) * 0.5
    ro, rd = _rays(256, 9)
    # unfolded params + code through the JAX plain path == folded through the kernel's twin
    want = jax_serve.render_rays_bounded(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(code),
                                         jnp.asarray(ro), jnp.asarray(rd), NEAR, FAR, 8, *AABB)
    folded = student.fold_student_code(tp, torch.from_numpy(code))
    got = sk.render_rays_bounded_fused(folded, tcfg, torch.from_numpy(ro), torch.from_numpy(rd),
                                       NEAR, FAR, 8, *AABB)
    _check(got, want, 1e-4, 1e-3)
    with pytest.raises(ValueError, match="fold"):
        sk.render_rays_bounded_fused(tp, tcfg, torch.from_numpy(ro), torch.from_numpy(rd),
                                     NEAR, FAR, 8, *AABB)


def test_wrapper_refuses_what_the_kernel_does_not_compute():
    _, tcfg, _, tp = _student("float32", 10, depth=3, width=32, multires=4, skip=1)
    ro, rd = (torch.from_numpy(a) for a in _rays(16, 10))
    with pytest.raises(ValueError, match="skip"):
        sk.render_rays_bounded_fused(tp, tcfg, ro, rd, NEAR, FAR, 4, *AABB)
    _, tcfg, _, tp = _student("float32", 11, depth=1, width=32, multires=4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sk.render_rays_bounded_fused(tp, tcfg, ro.to("meta"), rd.to("meta"), NEAR, FAR, 4, *AABB)
    from mofanerf_tpu_torch.render.serve import _packet_fn

    with pytest.raises(ValueError, match="relu"):
        _packet_fn(tcfg, NEAR, FAR, 4, False, True, "softplus")


@pytest.mark.parametrize("multires", [1, 4, 8, 10])
def test_embed_constants_match_jax(multires):
    A, phase = sk._embed_constants(multires)
    jA, jphase = _jax()[3]._embed_constants(multires)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(phase, jphase)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,depth,width,multires,n_samples,n_rays", [
    ("float32", 4, 128, 8, 32, 1000),     # the serving width, ragged ray count
    ("bfloat16", 4, 128, 8, 32, 1000),
    ("bfloat16", 2, 64, 10, 24, 777),     # samples that leave padding rows in a CTA
    ("float32", 0, 32, 4, 7, 300),        # no hidden layer, narrow head
    ("bfloat16", 1, 96, 6, 200, 50),      # one ray a CTA
    ("bfloat16", 3, 128, 8, 1, 600),      # one sample a ray: only the 1e10 slot
])
def test_cuda_kernel_matches_plain_version(dtype, depth, width, multires, n_samples, n_rays):
    """On the card: the hand-written kernel against its plain version, with
    misses, white background and shapes that exercise the kernel's masking."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = student.StudentConfig(depth=depth, width=width, multires=multires,
                                 compute_dtype=getattr(torch, dtype))
    tp = student.init_student_params(torch.Generator().manual_seed(12), tcfg, device=dev)
    tp["sigma"]["b"] = tp["sigma"]["b"] + 1.5
    ro, rd = (torch.from_numpy(a).to(dev) for a in _rays(n_rays, 12))
    tol = 1e-4 if dtype == "float32" else 2e-2
    for white in (False, True):
        before = sk.launch_count
        got = sk.render_rays_bounded_fused(tp, tcfg, ro, rd, NEAR, FAR, n_samples, *AABB,
                                           white_bkgd=white)
        torch.cuda.synchronize()
        assert sk.launch_count == before + 1
        want = sk.render_rays_bounded_fused_ref(tp, tcfg, ro, rd, NEAR, FAR, n_samples, *AABB,
                                                white_bkgd=white)
        for k in ("rgb", "acc", "depth"):
            torch.testing.assert_close(got[k], want[k], rtol=tol, atol=tol, msg=k)
        torch.testing.assert_close(got["disp"], want["disp"], rtol=max(tol, 1e-3),
                                   atol=max(tol, 1e-3))
        miss = n_rays // 8
        assert (got["acc"][:miss] == 0).all()
        assert (got["rgb"][:miss] == (1.0 if white else 0.0)).all()


# ---- the wgmma design's operands, on the CPU: weight image, dispatch rule, packing once


def _torch_student(depth, width, multires=8, dtype=torch.bfloat16, seed=0):
    cfg = student.StudentConfig(depth=depth, width=width, multires=multires, compute_dtype=dtype)
    params = student.init_student_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    params["sigma"]["b"] = params["sigma"]["b"] + 1.5
    return cfg, params


def _image_element(image, cfg, part, k, n):
    """Weight [k, n] of image part `part` (an index into image_plan) read at the byte
    the layout says: part rows, then K block k // 64 of [n_part, 64] rows, then within
    the 128-byte row of n the 16-byte chunk (k % 64) // 8 swizzled by the row's index."""
    plan = sk.image_plan(cfg)
    row = sum(pn * (pk // 64) for _, _, pn, pk in plan[:part])
    row += (k // 64) * plan[part][2] + n
    flat = image.contiguous().view(torch.uint8).reshape(-1)
    at = row * 128 + ((((k % 64) // 8) ^ (row % 8)) * 16) + (k % 8) * 2
    return flat[at:at + 2].view(torch.bfloat16)[0]


@pytest.mark.parametrize("depth,width,multires", [(4, 128, 8), (2, 64, 8), (0, 128, 10),
                                                  (5, 128, 4)])
def test_student_image_round_trips_and_places_each_weight(depth, width, multires):
    cfg, params = _torch_student(depth, width, multires)
    pack = sk.pack_student(params, cfg)
    w = {k: getattr(pack, k) for k in ("w0", "wl", "wsig", "wfeat", "wrgb")}
    image = sk.tile_student_weights(**w, cfg=cfg)
    W, W2, k0 = width, width // 2, 3 + 6 * multires
    head = sk.head_columns(W)
    assert head == {128: 72, 64: 40}[W] and head % 8 == 0 and head > W2
    assert image.shape == (sk.image_rows(cfg), 64) and image.dtype == torch.bfloat16
    # bytes: input [W][64], D x [W][W], head [head][W], rgb [8][64]
    assert image.numel() * 2 == 128 * (W + depth * W * W // 64 + head * W // 64 + sk.RGB_N)
    back = sk.untile_student_weights(image, cfg)
    assert torch.equal(back["w0"][:k0], pack.w0) and not back["w0"][k0:].any()
    for k in ("wl", "wsig", "wfeat", "wrgb"):
        assert torch.equal(back[k], w[k]), k
    # one spot check a kind of part: the input layer, a hidden layer, the head (a feature
    # column and the sigma column), the rgb head; zero padding where nothing is stored
    spots = [(0, pack.w0, k0 - 1, W - 1), (0, pack.w0, 1, 5)]
    if depth:
        spots += [(1 + depth - 1, pack.wl[depth - 1], W - 1, 3),
                  (1, pack.wl[0], 70 % W, W - 9)]
    spots += [(1 + depth, pack.wfeat, W - 3, W2 - 1), (1 + depth, pack.wfeat, 9, 0),
              (1 + depth, torch.cat([pack.wfeat, pack.wsig], dim=1), 66 % W, W2),
              (2 + depth, pack.wrgb, W2 - 1, 2), (2 + depth, pack.wrgb, 17, 0)]
    for part, m, k, n in spots:
        assert _image_element(image, cfg, part, k, n) == m[k, n], (part, k, n)
    if k0 < 64:
        assert _image_element(image, cfg, 0, 63, 0) == 0
    assert _image_element(image, cfg, 1 + depth, 5, head - 1) == 0
    assert _image_element(image, cfg, 2 + depth, 3, sk.RGB_N - 1) == 0


def test_pack_tiles_only_what_the_wgmma_design_holds():
    for kw in (dict(depth=4, width=128, dtype=torch.float32), dict(depth=6, width=128),
               dict(depth=4, width=96), dict(depth=2, width=64), dict(depth=4, width=128,
                                                                        multires=11)):
        cfg, params = _torch_student(**kw)
        pack = sk.pack_student(params, cfg)
        assert not sk.takes_tiles(cfg) and pack.w_tiles.shape == (0, 64), kw
    cfg, params = _torch_student(4, 128)
    pack = sk.pack_student(params, cfg)
    assert sk.takes_tiles(cfg) and pack.w_tiles.shape == (sk.image_rows(cfg), 64)
    assert pack.w_tiles.is_contiguous() and pack.w_tiles.data_ptr() % 16 == 0


# (dtype, width, depth, multires, samples) -> whether csrc/serve_kernel.cu runs the wgmma
# design: bf16, W = 128, depth <= 5, 3 + 6 mr <= 64, S dividing 64, or 128
@pytest.mark.parametrize("dtype,width,depth,multires,n_samples,wgmma", [
    (torch.bfloat16, 128, 4, 8, 32, True),     # the serving configuration
    (torch.bfloat16, 128, 4, 8, 1, True),
    (torch.bfloat16, 128, 4, 8, 16, True),
    (torch.bfloat16, 128, 4, 8, 64, True),
    (torch.bfloat16, 128, 0, 10, 128, True),
    (torch.bfloat16, 128, 5, 8, 64, True),
    (torch.bfloat16, 128, 4, 8, 24, False),    # divides no 64-row tile
    (torch.bfloat16, 128, 4, 8, 96, False),
    (torch.bfloat16, 128, 4, 8, 256, False),   # four composite buffers of 256 rows: no room
    (torch.bfloat16, 128, 6, 8, 32, False),    # the weights do not fit beside the rest
    (torch.bfloat16, 128, 4, 11, 32, False),   # the embedding is deeper than one K block
    (torch.bfloat16, 96, 4, 8, 32, False),
    (torch.bfloat16, 64, 4, 8, 32, False),
    (torch.float32, 128, 4, 8, 32, False),
])
def test_uses_wgmma_states_the_dispatch_rule(dtype, width, depth, multires, n_samples, wgmma):
    cfg = student.StudentConfig(depth=depth, width=width, multires=multires, compute_dtype=dtype)
    assert sk.uses_wgmma(cfg, n_samples) == wgmma


def _operands_as_one_function(params, cfg, rays_o, rays_d, near, far, aabb_min, aabb_max):
    """What the wrapper made for every packet before the weights were packed once a frame."""
    from mofanerf_tpu_torch.ops.bounds import ray_aabb_interval
    from mofanerf_tpu_torch.ops.embed import fourier_embed

    dt, f32 = cfg.compute_dtype, torch.float32
    t0, t1, hit = ray_aabb_interval(rays_o, rays_d, aabb_min, aabb_max, near, far)
    normd = torch.linalg.norm(rays_d, dim=-1)
    de = fourier_embed(rays_d / normd[:, None], cfg.multires_views)
    layers = params["layers"]
    return {
        "aux": torch.stack([t0, t1, hit.to(f32), normd], dim=-1).contiguous(),
        "dirf": (de @ params["view"]["w_dirs"]).to(dt).contiguous(),
        "w0": params["input"]["w"].to(dt), "b0": params["input"]["b"].to(f32),
        "wl": torch.stack([l["w"] for l in layers]).to(dt),
        "bl": torch.stack([l["b"] for l in layers]).to(f32),
        "wsig": params["sigma"]["w"].to(dt), "bsig": params["sigma"]["b"].to(f32),
        "wfeat": params["feat"]["w"].to(dt), "bfeat": params["feat"]["b"].to(f32),
        "wrgb": params["rgb"]["w"].to(dt), "brgb": params["rgb"]["b"].to(f32),
    }


@pytest.mark.parametrize("dtype,width,n_samples", [(torch.bfloat16, 128, 32),
                                                   (torch.float32, 64, 8)])
def test_packed_and_per_packet_operands_give_the_plain_version_bit_for_bit(dtype, width,
                                                                           n_samples):
    cfg, params = _torch_student(3, width, 6, dtype, seed=5)
    ro, rd = (torch.from_numpy(a) for a in _rays(300, 5))
    old = _operands_as_one_function(params, cfg, ro, rd, NEAR, FAR, *AABB)
    pack = sk.pack_student(params, cfg)
    aux, dirf = sk.ray_operands(pack, cfg, ro, rd, NEAR, FAR, *AABB)
    new = dict(pack._asdict(), aux=aux, dirf=dirf)
    for k, v in old.items():
        assert torch.equal(new[k], v) and new[k].dtype == v.dtype, k
    got = sk._serve_ref(pack, aux, dirf, cfg, ro, rd, n_samples, True)
    want = sk._serve_ref(pack._replace(**{k: old[k] for k in pack._fields if k in old}),
                         old["aux"], old["dirf"], cfg, ro, rd, n_samples, True)
    assert torch.equal(got, want)
    # the entry point takes either form and gives the same outputs
    a = sk.render_rays_bounded_fused(params, cfg, ro, rd, NEAR, FAR, n_samples, *AABB)
    b = sk.render_rays_bounded_fused(pack, cfg, ro, rd, NEAR, FAR, n_samples, *AABB)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dtype,hit_fraction", [("bfloat16", None), ("float32", 1.0)])
def test_frame_packs_once_and_matches_jax(monkeypatch, dtype, hit_fraction):
    """render_frame_serve on the CPU, its weights packed once for all its packets,
    against the JAX package's frame (Pallas in interpret mode)."""
    jax, jnp, _, _, jax_serve = _jax()
    from mofanerf_tpu_torch.render import serve

    jcfg, tcfg, jp, tp = _student(dtype, 6, depth=4, width=128, multires=8)
    H = 16
    K = np.array([[30.0, 0, H / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    c2w = np.asarray(importlib.import_module("mofanerf_tpu.ops.rays")
                     .pose_spherical(15.0, -5.0, 16.0))[:3]
    kw = dict(near=NEAR, far=FAR, n_samples=8, aabb_min=AABB[0], aabb_max=AABB[1],
              packet_size=64, hit_fraction=hit_fraction)
    packs = []
    monkeypatch.setattr(serve, "pack_student",
                        lambda *a: packs.append(1) or sk.pack_student(*a))
    got = serve.render_frame_serve(tp, tcfg, None, H, H, K, c2w, **kw)
    assert len(packs) == 1   # one pack for the frame's packets
    want = jax_serve.render_frame_serve(jp, jcfg, None, H, H, jnp.asarray(K), jnp.asarray(c2w),
                                        fused=True, **kw)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k], np.float32), rtol=tol,
                                   atol=tol, err_msg=k)
    assert (got["acc"] > 0.5).any() and (got["acc"] == 0).any()


def _wgmma_rays(case, n, seed):
    """Rays for a wgmma-design case: 'all miss' points every ray away from the box,
    'alternate' makes every other ray miss (a 2-ray tile holds one hit and one miss)."""
    ro, rd = _rays(n, seed)
    if case == "all miss":
        rd[:] = [0.0, 0.0, 1.0]
    elif case == "alternate":
        rd[0::2] = [0.0, 0.0, 1.0]
    return ro, rd


@pytest.mark.cuda
@pytest.mark.parametrize("case,depth,n_samples,n_rays,white", [
    ("all miss", 4, 32, 4096, False),      # every item skips the MLP
    ("all miss", 4, 32, 1000, True),
    ("alternate", 4, 32, 512, False),      # a tile of one hit and one miss ray
    ("ragged", 4, 32, 1001, False),        # the last tile ends mid-ray-pair
    ("ragged", 4, 32, 37, True),           # fewer tiles than the card has SMs
    ("ragged", 4, 32, 16384, True),        # the packet shape, white background
    ("ragged", 4, 64, 700, False),         # a ray a tile
    ("ragged", 4, 16, 701, True),          # four rays a tile
    ("ragged", 5, 1, 999, False),          # 64 rays a tile; the deepest stack it holds
    ("ragged", 0, 128, 301, False),        # a ray across two tiles; no hidden layer
    ("alternate", 2, 128, 77, True),       # a ray across two tiles, hits and misses
])
def test_cuda_wgmma_design_matches_plain_version(case, depth, n_samples, n_rays, white):
    """On the card: the wgmma design against the plain version (2e-2), and misses
    exactly background, at the shapes its tiles and items cut differently."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = student.StudentConfig(depth=depth, width=128, multires=8 if depth else 10,
                                 compute_dtype=torch.bfloat16)
    assert sk.uses_wgmma(tcfg, n_samples)
    tp = student.init_student_params(torch.Generator().manual_seed(20 + depth), tcfg, device=dev)
    tp["sigma"]["b"] = tp["sigma"]["b"] + 1.5
    ro, rd = (torch.from_numpy(a).to(dev) for a in _wgmma_rays(case, n_rays, n_samples))
    pack = sk.pack_student(tp, tcfg)
    aux, dirf = sk.ray_operands(pack, tcfg, ro, rd, NEAR, FAR, *AABB)
    hit = aux[:, 2] > 0
    before = sk.launch_count
    sk.items_skipped(dev)
    got = sk._serve_cuda(pack, aux, dirf, tcfg, ro, rd, n_samples, white)
    torch.cuda.synchronize()
    assert sk.launch_count == before + 1
    # the items the kernel counts as skipped are those the hit mask leaves without a hit
    assert sk.items_skipped(dev) == sk.items_all_missing(hit, n_samples)
    want = sk._serve_ref(pack, aux, dirf, tcfg, ro, rd, n_samples, white)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[:, :5], want[:, :5], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got[:, 5], want[:, 5], rtol=2e-2, atol=2e-2)
    bg = 1.0 if white else 0.0
    assert (got[~hit, 0:3] == bg).all() and (got[~hit, 3:5] == 0).all()
    assert (got[~hit, 5] == 1e10).all() and (got[:, 6:] == 0).all()
    assert bool(hit.any()) == (case != "all miss")


def test_frame_with_operands_made_once_is_the_packet_by_packet_frame():
    """The serving sweep makes the rays' operands once over all packets (padding
    included) and the weights once a frame: the same frame, bit for bit, as one
    render_rays_bounded_fused call a packet on the raw params."""
    from mofanerf_tpu_torch.ops.sweep import sweep_frame
    from mofanerf_tpu_torch.render import serve

    cfg, params = _torch_student(4, 128, seed=8)
    H = 20   # 400 rays: two packets of 256 and padding rays
    K = torch.tensor([[30.0, 0, H / 2], [0, 30.0, H / 2], [0, 0, 1]])
    c2w = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 16.0]])
    kw = dict(aabb_min=torch.tensor(AABB[0]), aabb_max=torch.tensor(AABB[1]), near=NEAR,
              far=FAR, hit_fraction=1.0, packet_multiple=256)
    got = serve.render_frame_serve(params, cfg, None, H, H, K, c2w, n_samples=8,
                                   packet_size=256, hit_fraction=1.0, aabb_min=AABB[0],
                                   aabb_max=AABB[1])
    want = sweep_frame(lambda o, d: sk.render_rays_bounded_fused(
        params, cfg, o, d, NEAR, FAR, 8, kw["aabb_min"], kw["aabb_max"]), H, H, K, c2w, 256, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (got["acc"] > 0.5).any()


def _fragment_cells():
    """(thread, k step, register, half) -> (row, column) of the input layer's A tile, as the
    wgmma design's threads build it: thread t of the warpgroup owns rows 16 (t / 32) +
    (t % 32) / 4 and that + 8, and in k step kk the columns 16 kk + 8 h + 2 (t % 4) + e."""
    cells = {}
    for t in range(128):
        r0, q = 16 * (t // 32) + (t % 32) // 4, t % 4
        for kk in range(4):
            for h in range(2):
                for rr in range(2):
                    for e in range(2):
                        cells[(t, kk, 2 * h + rr, e)] = (r0 + 8 * rr, 16 * kk + 8 * h + 2 * q + e)
    return cells


def _scan_composite(sig, rgb, z, aux, white_bkgd):
    """The wgmma design's composite in its own order, in f32 (serve_kernel_wgmma.cuh): L =
    min(32, S) lanes a ray, lane l over its S / L consecutive samples in order from a
    transmittance of 1; an inclusive product scan of the lanes' transmittance (at step o,
    lane l >= o multiplies its own by lane l - o's); each lane's sums times the scan at the
    lane before it (1 at lane 0); sums across the lanes by a shuffle-xor butterfly."""
    n, S = sig.shape
    L = min(32, S)
    chunk = S // L
    t0, t1, hit, normd = aux.unbind(-1)
    delta = (t1 - t0) / max(S - 1, 1) * normd
    dist = torch.cat([delta[:, None].expand(-1, S - 1), (1e10 * normd)[:, None]], dim=1)
    alpha = (1.0 - torch.exp(-(torch.relu(sig) * hit[:, None]) * dist)).reshape(n, L, chunk)
    rgb, z = rgb.reshape(n, L, chunk, 3), z.reshape(n, L, chunk)
    trans = torch.ones((n, L))
    sums = torch.zeros((n, L, 5))       # r, g, b, acc, acc z
    for c in range(chunk):
        w = alpha[:, :, c] * trans
        sums = sums + torch.cat([w[..., None] * rgb[:, :, c], w[..., None],
                                 (w * z[:, :, c])[..., None]], dim=-1)
        trans = trans * (1.0 - alpha[:, :, c] + 1e-10)
    o = 1
    while o < L:
        scanned = trans.clone()
        scanned[:, o:] = trans[:, o:] * trans[:, :-o]
        trans, o = scanned, 2 * o
    front = torch.cat([torch.ones((n, 1)), trans[:, :-1]], dim=1)
    sums = sums * front[..., None]
    o = L // 2
    while o:
        sums = sums + sums[:, torch.arange(L) ^ o]
        o //= 2
    rgb_sum, acc_w, acc_zw = sums[:, 0, :3], sums[:, 0, 3], sums[:, 0, 4]
    disp = 1.0 / torch.clamp(acc_zw / torch.clamp(acc_w, min=1e-10), min=1e-10)
    if white_bkgd:
        rgb_sum = rgb_sum + (1.0 - acc_w[:, None])
    zero = torch.zeros_like(acc_w)
    return torch.stack([rgb_sum[:, 0], rgb_sum[:, 1], rgb_sum[:, 2], acc_w, acc_zw, disp,
                        zero, zero], dim=-1)


@pytest.mark.parametrize("n_samples,n_rays", [(32, 6), (16, 7), (64, 3), (128, 2)])
def test_wgmma_dataflow_from_the_image_gives_the_plain_version(n_samples, n_rays):
    """The wgmma design's dataflow in plain PyTorch, from its weight image alone: the input
    layer's A tile assembled cell by cell from the threads' fragments (every cell exactly
    once), the padded shapes (K 64, head 72 columns, rgb 8), the products in order and the
    composite in the kernel's order (`_scan_composite`). Against the plain version: bf16
    roundings at the same points, sums in another order (2e-2); the composite alone, on
    the same inputs, against the plain version's serial one in f32 (rtol 1e-5, atol 1e-6)."""
    cfg, params = _torch_student(2, 128, seed=9)
    pack = sk.pack_student(params, cfg)
    w = sk.untile_student_weights(pack.w_tiles, cfg)
    ro, rd = (torch.from_numpy(a) for a in _rays(n_rays, 9))
    aux, dirf = sk.ray_operands(pack, cfg, ro, rd, NEAR, FAR, *AABB)
    f32, dt = torch.float32, torch.bfloat16
    S, rows = n_samples, n_rays * n_samples
    cells = _fragment_cells()
    assert sorted(set(cells.values())) == [(r, c) for r in range(64) for c in range(64)]
    assert len(cells) == 64 * 64

    u = torch.arange(S, dtype=f32) / max(S - 1, 1)
    z = aux[:, :1] + (aux[:, 1:2] - aux[:, :1]) * u
    pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3)
    k0 = 3 + 6 * cfg.multires

    def embed(p, c):
        if c < 3:
            return p[c]
        if c >= k0:
            return torch.tensor(0.0)
        band, j = divmod(c - 3, 6)
        arg = p[j % 3] * 2.0 ** band
        return torch.sin(arg + np.float32(np.pi / 2) if j >= 3 else arg)

    emb = torch.zeros((-(-rows // 64) * 64, 64))
    for tile in range(emb.shape[0] // 64):
        for r, c in cells.values():
            g = tile * 64 + r
            if g < rows:
                emb[g, c] = embed(pts[g], c)

    def mm(a, b):
        return a[:rows].to(dt).to(f32) @ b.to(f32)

    h = torch.relu(mm(emb, w["w0"]) + pack.b0).to(dt)
    for l in range(cfg.depth):
        h = torch.relu(mm(h, w["wl"][l]) + pack.bl[l]).to(dt)
    head = torch.cat([w["wfeat"], w["wsig"], torch.zeros((128, 7), dtype=dt)], dim=1)
    acc = mm(h, head)
    pre = torch.relu(acc[:, :64] + pack.bfeat + dirf.to(f32).repeat_interleave(S, dim=0))
    sig = (acc[:, 64] + pack.bsig).reshape(n_rays, S)
    rgb8 = torch.zeros((64, 8), dtype=dt)
    rgb8[:, :3] = w["wrgb"]
    rgb = torch.sigmoid(mm(pre, rgb8)[:, :3] + pack.brgb).reshape(n_rays, S, 3)
    want = sk._serve_ref(pack, aux, dirf, cfg, ro, rd, S, False)
    got = _scan_composite(sig, rgb, z, aux, False)
    np.testing.assert_allclose(got[:, :5].numpy(), want[:, :5].numpy(), atol=2e-2)
    assert float(want[:, 3].max()) > 0.5
    for white in (False, True):
        np.testing.assert_allclose(_scan_composite(sig, rgb, z, aux, white).numpy(),
                                   sk._composite_ref(sig, rgb, z, aux, white).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=f"white_bkgd={white}")


@pytest.mark.parametrize("hits,n_samples,skipped", [
    ([1, 0, 0, 0, 0, 1, 0], 32, 2),     # two rays an item; the last item ragged
    ([0, 0, 0, 0, 1, 0, 0, 0, 0], 16, 2),
    ([0, 1, 0], 128, 2),                # a ray an item
    ([0] * 65, 1, 2),                   # 64 rays an item
])
def test_items_all_missing_counts_the_items_the_kernel_skips(hits, n_samples, skipped):
    assert sk.items_all_missing(torch.tensor(hits, dtype=torch.bool), n_samples) == skipped


@pytest.mark.parametrize("name", list(serve_variants.PATCHES))
def test_serve_variant_patches_find_their_text(name):
    """Every timing variant's patch still finds the text it replaces in the sources."""
    target, patches = serve_variants.PATCHES[name]
    text = (cuda_build.CSRC / target).read_text()
    for old, _ in patches:
        assert old in text, old


def test_sweep_hands_each_packet_its_own_prepared_rows():
    """sweep_rays(prepare=): per-ray tensors made once over the padded, compacted rays,
    handed to each packet as its own rows, in the packet's order."""
    from mofanerf_tpu_torch.ops.sweep import sweep_rays

    ro, rd = (torch.from_numpy(a) for a in _rays(300, 3))
    seen = []

    def prepare(o, d):
        return (o[:, 2:3] * 0 + torch.arange(o.shape[0], dtype=torch.float32)[:, None],
                d * 2)

    def ray_fn(o, d, idx, d2):
        assert idx.shape == (o.shape[0], 1) and torch.equal(d2, d * 2)
        seen.append(idx[:, 0].clone())
        return {"rgb": o, "acc": idx[:, 0], "depth": idx[:, 0], "disp": idx[:, 0]}

    out = sweep_rays(ray_fn, ro, rd, 128, aabb_min=torch.tensor(AABB[0]),
                     aabb_max=torch.tensor(AABB[1]), near=NEAR, far=FAR, hit_fraction=0.5,
                     packet_multiple=64, prepare=prepare)
    assert torch.equal(torch.cat(seen), torch.arange(len(seen) * 128, dtype=torch.float32))
    plain = sweep_rays(lambda o, d: {"rgb": o, "acc": o[:, 0], "depth": o[:, 0],
                                     "disp": o[:, 0]}, ro, rd, 128,
                       aabb_min=torch.tensor(AABB[0]), aabb_max=torch.tensor(AABB[1]),
                       near=NEAR, far=FAR, hit_fraction=0.5, packet_multiple=64)
    assert torch.equal(out["rgb"], plain["rgb"])


# ---- serve_rays: the rays and the operands of every pose in one kernel


def pose_stack(angles, radius=16.0):
    """[F, 4, 4] f32 poses on the orbit at `radius`, one an (azimuth, elevation)."""
    from mofanerf_tpu_torch.ops.rays import pose_spherical

    return np.stack([pose_spherical(a, e, radius) for a, e in angles]).astype(np.float32)


def todays_route(pack, cfg, H, W, K, poses, packet_size, hit_fraction, n_samples=8, box=AABB,
                 white_bkgd=False):
    """The fused serving route as it ran before serve_rays: get_rays pose by pose,
    then sweep_rays, which compacts by its own slab test and makes the operands
    (`ray_operands`) after the compaction and the padding. [F, H, W, ...] maps."""
    from mofanerf_tpu_torch.ops.rays import get_rays
    from mofanerf_tpu_torch.ops.sweep import sweep_rays

    dev = pack.w_dirs.device
    K, poses = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (K, poses))
    lo, hi = (torch.tensor(b, dtype=torch.float32, device=dev) for b in box)
    rays = [get_rays(H, W, K, p[:3]) for p in poses]
    out = sweep_rays(
        lambda o, d, aux, dirf: sk.render_packet_fused(pack, cfg, o, d, aux, dirf, n_samples,
                                                       white_bkgd),
        torch.cat([o.reshape(-1, 3) for o, _ in rays]),
        torch.cat([d.reshape(-1, 3) for _, d in rays]), packet_size, aabb_min=lo, aabb_max=hi,
        near=NEAR, far=FAR, hit_fraction=hit_fraction, white_bkgd=white_bkgd,
        packet_multiple=sk._BLOCK_R,
        prepare=lambda o, d: sk.ray_operands(pack, cfg, o, d, NEAR, FAR, lo, hi))
    return {k: v.reshape((len(poses), H, W) + v.shape[1:]) for k, v in out.items()}


def _ulp(x, dtype=torch.float32):
    """The spacing of `dtype` at |x| (x's binade; normal numbers), in f64."""
    bits = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    x = x.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - bits)


def _rotation_scale(H, W, K, poses, rows):
    """[rows, 3]: sum over c of |dirs_c * R[r, c]|, the size of the terms that
    get_rays sums into each direction's component r (1 on the padding rows)."""
    K, R = K.double(), poses[:, :3, :3].double().abs()
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=K.device),
                          torch.arange(W, dtype=torch.float64, device=K.device), indexing="ij")
    dirs = torch.stack([((i - K[0, 2]) / K[0, 0]).abs(), ((j - K[1, 2]) / K[1, 1]).abs(),
                        torch.ones_like(i)], -1).reshape(-1, 3)
    scale = torch.einsum("nc,frc->fnr", dirs, R).reshape(-1, 3)
    return torch.cat([scale, scale.new_ones((rows - scale.shape[0], 3))])


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,H,W,angles,focal,half,pad", [
    ("viewer", "bfloat16", 512, 512, [(30.0, 10.0)], 1200.0, 5.0, 0),    # the viewer's frame
    ("viewer", "float32", 512, 512, [(-60.0, -25.0)], 1200.0, 5.0, 0),
    ("path", "bfloat16", 64, 64, [(-20.0, 5.0), (0.0, 5.0), (20.0, 5.0)], 150.0, 5.0, 0),
    ("misses", "bfloat16", 64, 64, [(15.0, -5.0)], 150.0, 2.0, 0),       # part misses the box
    ("misses", "float32", 64, 64, [(15.0, -5.0), (80.0, 30.0)], 150.0, 2.0, 0),
    ("misses", "bfloat16", 37, 29, [(10.0, 0.0), (45.0, -30.0)], 60.0, 2.0, 202),  # 2146 rays,
])                                                   # not a multiple of the block, padding after
def test_cuda_serve_rays_matches_plain_version(case, dtype, H, W, angles, focal, half, pad):
    """On the card, TF32 off: the kernel against its plain version. The rays:
    origins bit for bit, directions within 2 f32 ulp of the size of the terms
    the pose's rotation sums (cuBLAS sums them in its own order); t0 / t1 within
    1e-5 relative; hit identical but on grazing rays (t1 - t0 < 1e-4); the hit
    count the mask's sum. Then each operand against the plain version's
    arithmetic on the kernel's own inputs to it, so that the last bits of one
    step do not feed the next: |d| (ray_operands' norm of the kernel's rays)
    within 2 f32 ulp; dirf (fourier_embed of the kernel's d / |d|, times w_dirs,
    cast) within 1 ulp of the compute dtype beyond the one rounding of its f32
    sum at the size of its terms."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from mofanerf_tpu_torch.ops import serve_rays as sr
    from mofanerf_tpu_torch.ops.embed import fourier_embed

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = student.StudentConfig(depth=4, width=128, multires=10,
                                compute_dtype=getattr(torch, dtype))
    pack = sk.pack_student(student.init_student_params(torch.Generator().manual_seed(7), cfg,
                                                       device=dev), cfg)
    K = torch.tensor([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], device=dev)
    poses = torch.from_numpy(pose_stack(angles)).to(dev)
    lo, hi = torch.full((3,), -half, device=dev), torch.full((3,), half, device=dev)
    n = len(angles) * H * W
    rows = n + pad
    before = sr.launch_count
    got = sr.serve_rays(pack, cfg, H, W, K, poses, NEAR, FAR, lo, hi, rows)
    torch.cuda.synchronize()
    assert sr.launch_count == before + 1
    want = sr.serve_rays_ref(pack, cfg, H, W, K, poses, NEAR, FAR, lo, hi, rows)
    assert got.n == want.n == n and got.dirf.dtype == cfg.compute_dtype
    assert got.aux.shape == (rows, 4) and got.dirf.shape == (rows, 64)

    assert torch.equal(got.rays_o, want.rays_o)
    gap = (got.rays_d - want.rays_d).abs().double()
    assert (gap <= 2 * _ulp(_rotation_scale(H, W, K, poses, rows))).all(), float(gap.max())
    differ = got.aux[:, 2] != want.aux[:, 2]   # only grazing rays: the hit side's t1 - t0 < 1e-4
    width = torch.where(got.aux[:, 2] > 0, got.aux[:, 1] - got.aux[:, 0],
                        want.aux[:, 1] - want.aux[:, 0])
    assert (width[differ] < 1e-4).all()
    torch.testing.assert_close(got.aux[~differ, :2], want.aux[~differ, :2], rtol=1e-5, atol=0)
    hit = got.aux[:n, 2] > 0
    assert int(got.n_hit.item()) == int(hit.sum())
    assert bool(hit.all()) == (case != "misses") and bool(hit.any())

    aux, _ = sk.ray_operands(pack, cfg, got.rays_o, got.rays_d, NEAR, FAR, lo, hi)
    assert ((got.aux[:, 3] - aux[:, 3]).abs().double() <= 2 * _ulp(aux[:, 3])).all()
    de = fourier_embed(got.rays_d / got.aux[:, 3:], cfg.multires_views)
    terms = de.abs() @ pack.w_dirs.abs()
    g, w = got.dirf.double(), (de @ pack.w_dirs).to(cfg.compute_dtype).double()
    tol = _ulp(torch.maximum(g.abs(), w.abs()), cfg.compute_dtype) + _ulp(terms)
    assert ((g - w).abs() <= tol).all(), float(((g - w).abs() / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("what,H,angles,half,hit_fraction", [
    ("frame", 512, [(30.0, 10.0)], 5.0, None),           # the viewer's cell: every ray hits
    ("frame", 128, [(15.0, -5.0)], 2.0, None),           # compaction to a budget below 1
    ("path", 128, [(-20.0, 5.0), (0.0, 5.0), (20.0, 5.0)], 5.0, None),
    ("path", 96, [(-40.0, 20.0), (35.0, -10.0)], 2.0, 0.5),
])
def test_cuda_served_frames_and_paths_match_todays_route(what, H, angles, half, hit_fraction):
    """On the card: render_frame_serve and render_path_serve, whose rays and
    operands serve_rays makes, against the route that made them in small
    operations (`todays_route`), within the student.viewer cell's limits (rgb
    0.006 max, 0.0015 rms); one serve_rays launch a call, counted under tracing
    as the frames it made, and as many B2 launches as that route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from mofanerf_tpu_torch.ops import serve_rays as sr
    from mofanerf_tpu_torch.render import serve

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = student.StudentConfig(depth=4, width=128, multires=10, compute_dtype=torch.bfloat16)
    params = student.init_student_params(torch.Generator().manual_seed(9), cfg, device=dev)
    params["sigma"]["b"] = params["sigma"]["b"] + 1.5
    pack = sk.pack_student(params, cfg)
    focal = 1200.0 * H / 512
    K = np.array([[focal, 0, H / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    poses = pose_stack(angles)
    box = ((-half,) * 3, (half,) * 3)
    kw = dict(near=NEAR, far=FAR, n_samples=32, aabb_min=box[0], aabb_max=box[1],
              packet_size=16384, hit_fraction=hit_fraction)
    rays0, b2_0 = sr.launch_count, sk.launch_count
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        if what == "frame":
            got = {k: v[None] for k, v in serve.render_frame_serve(pack, cfg, None, H, H, K,
                                                                   poses[0][:3], **kw).items()}
        else:
            got = serve.render_path_serve(pack, cfg, None, poses, H, H, K, **kw)
        torch.cuda.synchronize()
    counted = dict(profiling.counters)
    profiling.reset()
    rays1, b2_1 = sr.launch_count, sk.launch_count
    want = todays_route(pack, cfg, H, H, K, poses, 16384, hit_fraction, n_samples=32, box=box)
    torch.cuda.synchronize()
    assert rays1 == rays0 + 1 and sr.launch_count == rays1
    assert counted["serve_rays_frames"] == len(angles)   # traced: 1 a frame, F a path
    assert b2_1 - b2_0 == sk.launch_count - b2_1 >= 1
    assert got["rgb"].shape == want["rgb"].shape == (len(angles), H, H, 3)
    gap = (got["rgb"] - want["rgb"]).abs()
    assert float(gap.max()) <= 0.006 and float(gap.pow(2).mean().sqrt()) <= 0.0015
    assert (got["acc"] > 0.5).any()
    if half < 5.0:
        assert (got["acc"] == 0).any()
