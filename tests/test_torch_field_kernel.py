"""The fused field kernel's operands and plain PyTorch version against the JAX
Pallas kernel in interpret mode (bf16, weights x 0.4, atol 5e-3 as in
tests/test_pallas_field.py: contracting weights keep bf16 rounding flips from
growing through the layers), the f32 plain version against
apply_field_folded (sum order only: 1e-5), the wrapper's dispatch and checks,
what the wgmma design keeps in Python (its weight stream, the order of its
products, its scratch and row-block reckoning), and -- on a card only -- the
CUDA kernel against its plain version."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.ops import field_kernel as fk

T = torch.from_numpy


def _jax():
    """The JAX reference, imported on use: the card machine runs this file's
    `cuda` tests with no JAX installed (see README, PyTorch port)."""
    import jax
    import jax.numpy as jnp

    return (jax, jnp, importlib.import_module("mofanerf_tpu.models.field"),
            importlib.import_module("mofanerf_tpu.ops.pallas_field"))


def _setup(depth, width, dtype, seed, scale=0.4):
    """JAX params (scaled) carried over the bridge, folded codes, both configs."""
    jax, jnp, jfield, _ = _jax()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = jfield.FieldConfig(depth=depth, width=width, compute_dtype=jdt)
    tcfg = tfield.FieldConfig(depth=depth, width=width, compute_dtype=tdt)
    jp = jax.tree.map(lambda w: np.asarray(w) * np.float32(scale),
                      jfield.init_field_params(jax.random.PRNGKey(seed), jcfg))
    tp = bridge.field_to_torch(jp, tcfg, "cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    codes = [np.full(n, 0.1, np.float32) for n in (50, 30, 256)]
    jcond = jfield.fold_conditioning(jp, *map(jnp.asarray, codes))
    tcond = tfield.fold_conditioning(tp, *map(T, codes))
    return jcfg, tcfg, jp, tp, jcond, tcond


def _inputs(width, n_rays, spr, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n_rays * spr, 3)).astype(np.float32) * 0.5
    dirf = rng.standard_normal((n_rays, width // 2)).astype(np.float32) * 0.1
    return pts, dirf


@pytest.mark.parametrize("depth,width", [(8, 128), (10, 64)])
def test_pack_matches_jax_operand_by_operand(depth, width):
    _, jnp, _, jpallas = _jax()
    jcfg, tcfg, jp, tp, jcond, tcond = _setup(depth, width, "bfloat16", 0)
    want = jpallas.pack_fused_params(jp, jcond, jcfg)
    got = fk.pack_fused_params(tp, tcond, tcfg)
    assert fk._plan_len(tcfg) == jpallas._plan_len(jcfg) == got.w_stack.shape[0]
    pe, W = tcfg.pts_embed_dim, width

    def f32(x):
        return np.asarray(x.astype(jnp.float32))

    # equal on the unpadded parts: the JAX operands are padded to 128 lanes,
    # the port's to the mma depth (w_pts) and to 4 output columns (w_out).
    # Weights are the same f32 values rounded to bf16 on both sides; biases
    # are f32 sums of the same terms (1e-6).
    np.testing.assert_array_equal(got.w_stack.float().numpy(), f32(want.w_stack))
    np.testing.assert_array_equal(got.w_pts.float().numpy()[:pe], f32(want.w_pts)[:pe])
    assert (got.w_pts[pe:] == 0).all() and got.w_pts.shape == (64, W)
    np.testing.assert_array_equal(got.w_view.float().numpy(), f32(want.w_view))
    np.testing.assert_array_equal(got.w_out.float().numpy(), f32(want.w_out)[:, :4])
    np.testing.assert_allclose(got.b_stack.numpy(), np.asarray(want.b_stack), atol=1e-6)
    np.testing.assert_allclose(got.b_pts.numpy(), np.asarray(want.b_pts), atol=1e-6)
    np.testing.assert_allclose(got.b_view.numpy(), np.asarray(want.b_view), atol=1e-6)
    np.testing.assert_allclose(got.b_out.numpy(), np.asarray(want.b_out)[:4], atol=1e-6)
    # the zero bias of the skip pair's first half
    skip_first = tcfg.xyz_depth + 1 + tcfg.skip
    assert (got.b_stack[skip_first] == 0).all()
    for t in got:
        assert t.is_contiguous()
    assert got.w_stack.dtype == torch.bfloat16 and got.b_stack.dtype == torch.float32


@pytest.mark.parametrize("depth,width,n_rays,spr", [
    (8, 128, 8, 16),     # one block of the JAX kernel
    (10, 128, 8, 16),    # the fine field's depth
    (8, 64, 32, 8),      # four blocks: block boundaries must not leak state
])
def test_plain_version_matches_pallas_kernel(depth, width, n_rays, spr):
    _, jnp, _, jpallas = _jax()
    from mofanerf_tpu.ops.embed import fourier_embed as jembed

    jcfg, tcfg, jp, tp, jcond, tcond = _setup(depth, width, "bfloat16", depth)
    pts, dirf = _inputs(width, n_rays, spr, depth + 1)
    pe = np.array(jembed(jnp.asarray(pts), jcfg.multires))
    want_rgb, want_sig = jpallas.fused_field_apply(
        jpallas.pack_fused_params(jp, jcond, jcfg), jnp.asarray(pe), jnp.asarray(dirf), jcfg,
        spr, block_rays=8, interpret=True)
    fused = fk.pack_fused_params(tp, tcond, tcfg)
    got_rgb, got_sig = fk.fused_field_apply_ref(fused, T(pe), T(dirf), tcfg, spr)
    assert got_rgb.shape == (n_rays * spr, 3) and got_sig.shape == (n_rays * spr, 1)
    assert got_rgb.dtype == torch.float32
    np.testing.assert_allclose(got_rgb.numpy(), np.asarray(want_rgb), atol=5e-3)
    np.testing.assert_allclose(got_sig.numpy(), np.asarray(want_sig), atol=5e-3)
    assert np.abs(np.asarray(want_rgb)).max() > 0.05   # not a comparison of zeros


@pytest.mark.parametrize("depth,width,spr", [(8, 64, 7), (10, 128, 3)])
def test_f32_plain_version_is_apply_field_folded(depth, width, spr):
    _, tcfg, _, tp, _, tcond = _setup(depth, width, "float32", 3, scale=1.0)
    rng = np.random.default_rng(4)
    n_rays = 9
    pe = T(rng.standard_normal((n_rays * spr, tcfg.pts_embed_dim)).astype(np.float32))
    dirf = T(rng.standard_normal((n_rays, width // 2)).astype(np.float32) * 0.1)
    fused = fk.pack_fused_params(tp, tcond, tcfg)
    got_rgb, got_sig = fk.fused_field_apply(fused, pe, dirf, tcfg, spr)   # CPU: plain version
    want_rgb, want_sig = tfield.apply_field_folded(tp, tcond, pe, dirf, tcfg, samples_per_ray=spr)
    np.testing.assert_allclose(got_rgb.numpy(), want_rgb.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_sig.numpy(), want_sig.numpy(), rtol=1e-5, atol=1e-5)


def test_plain_version_chunks_rows(monkeypatch):
    """Chunks must not cut a ray's view features off from its samples."""
    _, tcfg, _, tp, _, tcond = _setup(8, 64, "bfloat16", 5)
    rng = np.random.default_rng(6)
    pe = T(rng.standard_normal((10 * 7, 63)).astype(np.float32))
    dirf = T(rng.standard_normal((10, 32)).astype(np.float32))
    fused = fk.pack_fused_params(tp, tcond, tcfg)
    whole = fk.fused_field_apply_ref(fused, pe, dirf, tcfg, 7)
    monkeypatch.setattr(fk, "_REF_CHUNK", 16)   # 16 rows: not a multiple of 7 samples
    parts = fk.fused_field_apply_ref(fused, pe, dirf, tcfg, 7)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_wrapper_on_cpu_launches_nothing_and_is_differentiable():
    _, tcfg, _, tp, _, tcond = _setup(8, 64, "float32", 7, scale=1.0)
    tp["xyz"]["w_pts"].requires_grad_()
    fused = fk.pack_fused_params(tp, tcond, tcfg)
    pe = torch.randn((12, 63), generator=torch.Generator().manual_seed(0))
    dirf = torch.zeros((4, 32))
    before = fk.launch_count
    rgb, sig = fk.fused_field_apply(fused, pe, dirf, tcfg, 3)
    assert fk.launch_count == before
    (rgb.sum() + sig.sum()).backward()    # the plain version is ordinary tensor code
    assert tp["xyz"]["w_pts"].grad.abs().sum() > 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, tcfg, _, tp, _, tcond = _setup(8, 64, "float32", 8)
    fused = fk.pack_fused_params(tp, tcond, tcfg)
    pe, dirf = torch.zeros((12, 63)), torch.zeros((4, 32))
    fk.fused_field_apply(fused, pe, dirf, tcfg, 3)
    # any width the wrapper can pad to a multiple of 64 up to 1024 is taken (the operands
    # must be packed for it); wider ones are refused by name
    with pytest.raises(ValueError, match="widths up to 1024"):
        fk.fused_field_apply(fused, pe, dirf, dataclasses.replace(tcfg, width=2048), 3)
    with pytest.raises(ValueError, match="widths up to 1024"):
        fk.fused_field_apply(fused, pe, dirf, dataclasses.replace(tcfg, width=1025), 3)
    with pytest.raises(ValueError, match="dir_feat has shape"):   # packed for width 64
        fk.fused_field_apply(fused, pe, dirf, dataclasses.replace(tcfg, width=96), 3)
    with pytest.raises(ValueError, match="w_stack has shape"):   # depth 5 runs depth 6's plan
        fk.fused_field_apply(fused, pe, dirf, dataclasses.replace(tcfg, depth=5), 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fk.fused_field_apply(fused, pe, dirf,
                             dataclasses.replace(tcfg, compute_dtype=torch.float16), 3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fk.fused_field_apply(fused, pe.to("meta"), dirf.to("meta"), tcfg, 3)
    with pytest.raises(ValueError, match="pts_embed has dtype"):
        fk.fused_field_apply(fused, pe.double(), dirf, tcfg, 3)
    with pytest.raises(ValueError, match="w_stack has dtype"):   # packed for another dtype
        fk.fused_field_apply(fused, pe, dirf,
                             dataclasses.replace(tcfg, compute_dtype=torch.bfloat16), 3)
    with pytest.raises(ValueError, match="not contiguous"):
        fk.fused_field_apply(fused, torch.zeros((63, 12)).t(), dirf, tcfg, 3)
    with pytest.raises(ValueError, match="rays x"):
        fk.fused_field_apply(fused, pe, dirf, tcfg, 4)
    with pytest.raises(ValueError, match="dir_feat has shape"):
        fk.fused_field_apply(fused, pe, torch.zeros((4, 16)), tcfg, 3)
    with pytest.raises(ValueError, match="w_stack has shape"):   # packed for another depth
        fk.fused_field_apply(fused, pe, dirf, dataclasses.replace(tcfg, depth=10), 3)
    with pytest.raises(ValueError, match="is on"):
        fk.fused_field_apply(fused._replace(b_out=fused.b_out.to("meta")), pe, dirf, tcfg, 3)


def _torch_fused(depth, width, dtype=torch.bfloat16, seed=0, scale=0.4):
    """Packed operands of a seeded field made by the port alone."""
    cfg = tfield.FieldConfig(depth=depth, width=width, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    params = bridge.map_tree(lambda w: w * scale, tfield.init_field_params(gen, cfg, device="cpu"))
    codes = [torch.randn(n, generator=gen) * 0.3 for n in (50, 30, 256)]
    return cfg, fk.pack_fused_params(params, tfield.fold_conditioning(params, *codes), cfg)


@pytest.mark.parametrize("depth,width", [(8, 256), (10, 1024), (6, 256)])
def test_weight_tiles_hold_the_planned_slices_and_round_trip(depth, width):
    cfg, fused = _torch_fused(depth, width)
    plan = fk.stream_plan(cfg)
    assert fk.uses_wgmma(cfg) and fused.w_tiles.shape == (len(plan), 256, 64)
    assert fused.w_tiles.dtype == torch.bfloat16 and fused.w_tiles.is_contiguous()
    plain = fk._swizzle(fused.w_tiles)          # the swizzle is its own inverse
    assert torch.equal(fk._swizzle(plain), fused.w_tiles)
    operands = {"w_pts": fused.w_pts, "w_view": fused.w_view}
    for i, (operand, layer, k0, n0) in enumerate(plan):
        src = fused.w_stack[layer] if operand == "w_stack" else operands[operand]
        want = torch.zeros((64, 256), dtype=torch.bfloat16)     # padding is zeros
        part = src[k0:k0 + 64, n0:n0 + 256]
        want[:part.shape[0], :part.shape[1]] = part
        assert torch.equal(plain[i], want.t()), (i, operand, layer, k0, n0)
        # the stage's image: 16-byte chunk c of row n lies at chunk c ^ (n % 8)
        for n, c in ((0, 0), (13, 5), (255, 7)):
            at = (c ^ (n % 8)) * 8
            assert torch.equal(fused.w_tiles[i, n, at:at + 8], want[c * 8:c * 8 + 8, n])
    w_pts, w_stack, w_view = fk.untile_weights(fused.w_tiles, cfg)
    assert torch.equal(w_pts[:fused.w_pts.shape[0]], fused.w_pts) and (w_pts[63:] == 0).all()
    assert torch.equal(w_stack, fused.w_stack) and torch.equal(w_view, fused.w_view)


def test_no_weight_tiles_where_the_mma_design_runs():
    # f32 runs the 3xTF32 design at every width, with its own stream
    # (tests/test_torch_field_kernel_f32.py)
    for depth, width, dtype in ((8, 64, torch.bfloat16), (8, 512, torch.bfloat16),
                                (2, 16, torch.bfloat16)):
        cfg, fused = _torch_fused(depth, width, dtype)
        assert not fk.uses_wgmma(cfg) and not fk.uses_tf32(cfg)
        assert fused.w_tiles.shape == (0, 256, 64) and fused.w_tiles.dtype == dtype
    # an embedding deeper than one 64-deep tile stays with the mma design too
    wide = tfield.FieldConfig(depth=8, width=256, multires=12, compute_dtype=torch.bfloat16)
    assert wide.pts_embed_dim > 64 and not fk.uses_wgmma(wide)


@pytest.mark.parametrize("depth,width", [(8, 256), (10, 1024)])
def test_stream_order_follows_the_layer_plan(depth, width):
    _, _, jfield, jpallas = _jax()
    cfg = tfield.FieldConfig(depth=depth, width=width, compute_dtype=torch.bfloat16)
    L = jpallas._plan_len(jfield.FieldConfig(depth=depth, width=width))
    order = fk.product_layers(cfg)
    assert sorted(order) == list(range(L)) and L == fk._plan_len(cfg)
    # a trunk multiplies by its skip pair's first half first (the input still is the saved
    # activation), then L0 and the mid layers, the pair's second half, the post layers
    xd, skip = cfg.xyz_depth, cfg.skip
    assert order[:xd] == list(range(xd))
    for trunk in range(2):
        base = xd + trunk * (depth + 1)
        got = order[base:base + depth + 1]
        assert got[0] == base + skip + 1 and got[1:skip + 2] == list(range(base, base + skip + 1))
        assert got[skip + 2:] == list(range(base + skip + 2, base + depth + 1))
    plan = fk.stream_plan(cfg)
    pair, kb = (2, width // 64) if width > 256 else (1, width // 64)
    per_layer = kb * (width // 256)
    assert len(plan) == width // 256 + L * per_layer + kb * max(1, width // 512)
    assert [t[0] for t in plan[:width // 256]] == ["w_pts"] * (width // 256)
    assert all(t[0] == "w_view" for t in plan[-kb * max(1, width // 512):])
    stack = plan[width // 256:width // 256 + L * per_layer]
    assert [t[1] for t in stack[::per_layer]] == order
    # within a product: round, k block, tile of the pair; round r holds column tiles 2 r + j
    first = stack[:per_layer]
    want = [(r * pair + j) * 256 for r in range(width // 256 // pair)
            for _ in range(kb) for j in range(pair)]
    assert [t[3] for t in first] == want
    assert [t[2] for t in first[:pair * kb:pair]] == list(range(0, width, 64))
    # every [64, 256] slice of every layer exactly once
    assert len(set(stack)) == len(stack) == L * per_layer


@pytest.mark.parametrize("depth,width,n_rays,spr", [(8, 256, 5, 7), (10, 1024, 3, 5)])
def test_products_in_stream_order_give_the_plain_version(depth, width, n_rays, spr):
    """The wgmma design's dataflow in plain PyTorch, from the tile stream alone: weights read
    back tile by tile, a trunk's skip-pair first half taken before L0 and parked in f32.
    Against the plain version: f32 sums in another order, contracting weights (atol 5e-3)."""
    cfg, fused = _torch_fused(depth, width, seed=depth)
    rng = np.random.default_rng(depth)
    pe = T(rng.standard_normal((n_rays * spr, 63)).astype(np.float32))
    dirf = T(rng.standard_normal((n_rays, width // 2)).astype(np.float32) * 0.1)
    w_pts, w_stack, w_view = fk.untile_weights(fused.w_tiles, cfg)
    f32, dt = torch.float32, torch.bfloat16

    def mm(a, w):
        return a.to(dt).to(f32) @ w.to(f32)

    products = iter(fk.product_layers(cfg))
    x = torch.zeros((pe.shape[0], 64))
    x[:, :63] = pe
    h = torch.relu(mm(x, w_pts) + fused.b_pts).to(dt)
    for _ in range(cfg.xyz_depth):
        li = next(products)
        h = torch.relu(mm(h, w_stack[li]) + fused.b_stack[li]).to(dt)
    feats = []
    for _ in range(2):
        parked = mm(h, w_stack[next(products)])
        for _ in range(cfg.skip + 1):
            li = next(products)
            h = torch.relu(mm(h, w_stack[li]) + fused.b_stack[li]).to(dt)
        li = next(products)
        h = torch.relu(parked + mm(h, w_stack[li]) + fused.b_stack[li]).to(dt)
        for _ in range(cfg.depth - cfg.skip - 2):
            li = next(products)
            h = torch.relu(mm(h, w_stack[li]) + fused.b_stack[li]).to(dt)
        feats.append(h)
    assert next(products, None) is None
    ray = torch.arange(pe.shape[0]) // spr
    view = torch.relu(mm(feats[1], w_view) + fused.b_view + dirf[ray]).to(dt)
    got = mm(feats[0], fused.w_out[:width]) + mm(view, fused.w_out[width:]) + fused.b_out
    want = torch.cat(fk.fused_field_apply_ref(fused, pe, dirf, cfg, spr), dim=-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-3)
    assert want.abs().max() > 0.05


def test_scratch_and_row_block_reckoning():
    coarse = tfield.FieldConfig(depth=8, width=256, compute_dtype=torch.bfloat16)
    fine = tfield.FieldConfig(depth=10, width=1024, compute_dtype=torch.bfloat16)
    # a persistent CTA an SM parks f32 sums for its [rows, W] block
    for cfg, rows in ((coarse, 128), (fine, 64)):
        assert fk.wgmma_scratch(cfg, 132) == (132, 132 * rows * cfg.width)
        assert fk.wgmma_scratch(cfg, 7) == (7, 7 * rows * cfg.width)
        assert fk.wgmma_block_rows(cfg) == rows
        # h [rows, W] bf16 and a ring of 32 KB tiles (5 at W = 256, 3 at 1024) fit in 227 KB
        # with the barriers, the raw sigma buffer and the slack to align to 1024 bytes
        stages = 5 if cfg.width == 256 else 3
        assert rows * cfg.width * 2 + stages * 256 * 64 * 2 + rows * 4 + 16 * stages + 1024 \
            <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,depth,width,n_rays,spr", [
    ("float32", 8, 256, 37, 64),      # the coarse field, ragged against its row block
    ("bfloat16", 8, 256, 37, 63),
    ("float32", 10, 1024, 5, 127),    # the fine field
    ("bfloat16", 10, 1024, 21, 127),
    ("bfloat16", 6, 64, 300, 5),      # no post layers, many warp rows
    ("float32", 7, 192, 11, 9),       # a width that is not a power of two
    ("float32", 8, 64, 37, 7),        # 3xTF32: 64-column tiles, a view layer of 32 columns
    ("float32", 6, 64, 300, 5),       # no post layers
    ("float32", 8, 256, 3, 1),        # fewer rows than one row tile, one sample a ray
    ("float32", 10, 1024, 4096, 1),   # one sample a ray (distillation's queries)
    ("float32", 8, 256, 2100, 33),    # more row tiles than the card has SMs, ragged
    ("float32", 10, 1024, 700, 100),  # two row chunks, the second ragged
    ("float32", 2, 16, 50, 8),        # padded: width 16 -> 64, depth 2 -> skip + 2
    ("bfloat16", 2, 16, 50, 8),
    ("float32", 8, 96, 33, 5),        # padded: width 96 -> 128
    ("bfloat16", 8, 96, 33, 5),
    ("bfloat16", 8, 512, 3, 1),       # fewer rows than one block
    ("bfloat16", 8, 256, 3, 1),       # the wgmma design: fewer rows than one block,
    ("bfloat16", 10, 1024, 1, 50),
    ("bfloat16", 8, 256, 133, 67),    # blocks that span rays, a ragged last block,
    ("bfloat16", 10, 1024, 133, 67),
    ("bfloat16", 6, 256, 300, 5),     # no post layers
    ("bfloat16", 8, 256, 2100, 33),   # more blocks than the card has SMs
    ("bfloat16", 10, 1024, 700, 33),
])
def test_cuda_kernel_matches_plain_version(dtype, depth, width, n_rays, spr):
    """On the card: the hand-written kernel against its plain version. f32
    (three TF32 products a product, f32 sums) is held at 1e-4 of the output's
    scale; bf16 at atol 5e-3 with contracting weights (x 0.4), as the TPU
    kernel's test is."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = getattr(torch, dtype)
    cfg = tfield.FieldConfig(depth=depth, width=width, compute_dtype=tdt)
    gen = torch.Generator().manual_seed(depth * width)
    params = tfield.init_field_params(gen, cfg, device=dev)
    if tdt == torch.bfloat16:
        params = bridge.map_tree(lambda w: w * 0.4, params)
    codes = [(torch.randn(n, generator=gen) * 0.3).to(dev) for n in (50, 30, 256)]
    fused = fk.pack_fused_params(params, tfield.fold_conditioning(params, *codes), cfg)
    pe = torch.randn((n_rays * spr, 63), generator=gen).to(dev)
    dirf = (torch.randn((n_rays, width // 2), generator=gen) * 0.1).to(dev)
    if fk.uses_wgmma(cfg):
        assert fk.block_rows(cfg) == fk.wgmma_block_rows(cfg)
    before = fk.launch_count
    with torch.no_grad():
        got = torch.cat(fk.fused_field_apply(fused, pe, dirf, cfg, spr), dim=-1)
        torch.cuda.synchronize()
        assert fk.launch_count == before + 1
        want = torch.cat(fk.fused_field_apply_ref(fused, pe, dirf, cfg, spr), dim=-1)
    assert got.shape == (n_rays * spr, 4) and torch.isfinite(got).all()
    tol = 5e-3 if tdt == torch.bfloat16 else 1e-4 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    # the kernel builds no graph: operands that require grad are refused
    with pytest.raises(ValueError, match="inference only"):
        fk.fused_field_apply(fused, pe.requires_grad_(), dirf, cfg, spr)
