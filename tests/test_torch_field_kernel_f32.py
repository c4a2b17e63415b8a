"""The fused field kernel's wrapper for every field the JAX package renders,
and the f32 (3xTF32) design's operands and arithmetic, on the CPU.

- The wrapper pads any field to the kernel's config (`kernel_config`: depth
  lifted to skip + 2, width raised to a multiple of 64 that holds the padded
  embedding) with zeros: the CPU path (the plain version on the padded
  operands) against JAX's `apply_field_folded` on the unpadded tree, f32 at
  1e-5 (sum order only, as tests/test_torch_field.py), bf16 against the
  kernel's bf16 contract written in JAX ops on that tree (products of bf16
  operands summed in f32, f32 bias adds, outputs rounded to bf16) at the
  TPU kernel test's atol 5e-3 with contracting weights (x 0.4).
- The examples' small model (netdepth 2, netwidth 8 coarse and 16 fine)
  renders through the wrapper, against JAX's renderer.
- The padded operands and the 3xTF32 weight stream give back the field's
  weights; the split is exact to 2^-22 and rounds as `cvt.rna.tf32.f32`.
- The 3xTF32 products emulated bit by bit through the whole layer plan hold
  against JAX's f32 `apply_field_folded` within chip_smoke.py's
  FIELD_TOL["float32"], where one TF32 product a product does not."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FIELD_TOL
from mofanerf_tpu.models import field as jfield
from mofanerf_tpu.ops.embed import fourier_embed as jembed
from mofanerf_tpu.render import renderer as jr
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.ops import field_kernel as fk
from mofanerf_tpu_torch.render import renderer as tr
from mofanerf_tpu_torch.utils import cuda_build, field_variants

T = torch.from_numpy
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (depth, width, multires) of fields the JAX package renders and the kernel's old rule refused:
# no post layers, a width that is not a multiple of 64, and an embedding wider than the field
PADDED = [(2, 16, 10), (5, 64, 10), (8, 96, 10), (8, 64, 12)]


def _field(depth, width, multires, dtype, seed, scale=1.0):
    """JAX params (scaled) and the port's copy, folded codes, both configs."""
    jdt, tdt = DTYPES[dtype]
    jcfg = jfield.FieldConfig(depth=depth, width=width, multires=multires, compute_dtype=jdt)
    tcfg = tfield.FieldConfig(depth=depth, width=width, multires=multires, compute_dtype=tdt)
    jp = jax.tree.map(lambda w: np.asarray(w) * np.float32(scale),
                      jfield.init_field_params(jax.random.PRNGKey(seed), jcfg))
    tp = bridge.field_to_torch(jp, tcfg, "cpu")
    codes = [np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 0.3
             for n in (50, 30, 256)]
    jp = jax.tree.map(jnp.asarray, jp)
    jcond = jfield.fold_conditioning(jp, *map(jnp.asarray, codes))
    tcond = tfield.fold_conditioning(tp, *map(T, codes))
    return jcfg, tcfg, jp, tp, jcond, tcond


def _points(cfg, n_rays, spr, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n_rays * spr, 3)).astype(np.float32)
    pe = np.asarray(jembed(jnp.asarray(pts), cfg.multires))
    dirf = rng.standard_normal((n_rays, cfg.width // 2)).astype(np.float32) * 0.1
    return pe, dirf


def _jax_contract(p, cond, pe, dirf, cfg, spr):
    """The kernel's rounding contract in JAX ops on the unpadded tree: products of
    compute-dtype operands summed in f32, f32 bias adds and ReLU, each layer's
    output rounded; the skip pair summed unrounded; the output heads f32."""
    dt, f32 = cfg.compute_dtype, jnp.float32

    def mm(a, w):
        return jnp.dot(a.astype(dt), w.astype(dt), preferred_element_type=f32)

    def dense(h, w, b):
        return jax.nn.relu(mm(h, w) + b.astype(f32)).astype(dt)

    x = p["xyz"]
    h = dense(pe, x["w_pts"], cond["xyz_b"])
    for layer in x["layers"]:
        h = dense(h, layer["w"], layer["b"])

    def trunk(t, saved, b0, bskip):
        h = dense(saved, t["w_feat0"], b0)
        for layer in t["mid"]:
            h = dense(h, layer["w"], layer["b"])
        h = jax.nn.relu(mm(saved, t["w_skip_feat"]) + mm(h, t["w_skip_h"])
                        + bskip.astype(f32)).astype(dt)
        for layer in t["post"]:
            h = dense(h, layer["w"], layer["b"])
        return h

    sigma_feat = trunk(p["sigma"], h, cond["sigma_b0"], cond["sigma_bskip"])
    rgb_feat = trunk(p["rgb"], sigma_feat, cond["rgb_b0"], cond["rgb_bskip"])
    v = p["view"]
    pre = mm(rgb_feat, v["w_feat"]) + v["b"].astype(f32)
    view = jax.nn.relu(pre + jnp.repeat(dirf, spr, axis=0)).astype(dt)
    s = p["sigma"]
    sigma = mm(sigma_feat, s["alpha"]["w"]) + s["alpha"]["b"]
    rgb = mm(view, v["rgb"]["w"]) + v["rgb"]["b"]
    return np.asarray(rgb), np.asarray(sigma)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth,width,multires", PADDED)
def test_wrapper_takes_every_field_jax_renders(depth, width, multires, dtype):
    scale = 1.0 if dtype == "float32" else 0.4
    jcfg, tcfg, jp, tp, jcond, tcond = _field(depth, width, multires, dtype, depth, scale)
    kcfg = fk.kernel_config(tcfg)
    assert kcfg.width % 64 == 0 and kcfg.width >= max(width, tcfg.pts_embed_dim)
    assert kcfg.depth == max(depth, tcfg.skip + 2)
    assert (kcfg.width, kcfg.depth) != (width, depth)    # each of these needs the repair
    n_rays, spr = 9, 5
    pe, dirf = _points(tcfg, n_rays, spr, depth + width)
    fused = fk.pack_fused_params(tp, tcond, tcfg)
    got_rgb, got_sig = fk.fused_field_apply(fused, T(pe), T(dirf), tcfg, spr)   # CPU: plain
    assert got_rgb.shape == (n_rays * spr, 3) and got_sig.shape == (n_rays * spr, 1)
    if dtype == "float32":
        want_rgb, want_sig = jfield.apply_field_folded(jp, jcond, jnp.asarray(pe),
                                                       jnp.asarray(dirf), jcfg, spr)
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        want_rgb, want_sig = _jax_contract(jp, jcond, jnp.asarray(pe), jnp.asarray(dirf),
                                           jcfg, spr)
        tol = dict(rtol=0, atol=5e-3)
    np.testing.assert_allclose(got_rgb.numpy(), np.asarray(want_rgb), **tol)
    np.testing.assert_allclose(got_sig.numpy(), np.asarray(want_sig), **tol)
    assert np.abs(np.asarray(want_rgb)).max() > 0.05     # not a comparison of zeros


def test_bf16_contract_in_jax_is_the_pallas_kernels():
    """The JAX-side contract above is the TPU kernel's, at a field both take."""
    from mofanerf_tpu.ops import pallas_field as jpallas

    jcfg, _, jp, _, jcond, _ = _field(8, 128, 10, "bfloat16", 3, 0.4)
    pe, dirf = _points(jcfg, 8, 16, 4)
    want = jpallas.fused_field_apply(jpallas.pack_fused_params(jp, jcond, jcfg),
                                     jnp.asarray(pe), jnp.asarray(dirf), jcfg, 16,
                                     block_rays=8, interpret=True)
    got = _jax_contract(jp, jcond, jnp.asarray(pe), jnp.asarray(dirf), jcfg, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=5e-3)


def _small_specs(**render_kw):
    """The examples' small model: netdepth 2, netwidth 8 (coarse) and 16 (fine),
    8 + 8 samples, f32."""
    rkw = dict(n_coarse=8, n_importance=8, packet_size=8, **render_kw)
    jspec = jr.MoFaNeRF(coarse=jfield.FieldConfig(depth=2, width=8),
                        fine=jfield.FieldConfig(depth=2, width=16),
                        render=jr.RenderConfig(**rkw), uv_size=128)
    tspec = tr.MoFaNeRF(coarse=tfield.FieldConfig(depth=2, width=8),
                        fine=tfield.FieldConfig(depth=2, width=16),
                        render=tr.RenderConfig(**rkw), uv_size=128)
    return jspec, tspec


def test_render_rays_of_the_examples_small_model_matches_jax():
    jspec, tspec = _small_specs()
    jp = jax.tree.map(np.array, jr.init_model_params(jax.random.PRNGKey(2), jspec))
    rng = np.random.default_rng(2)
    probe = rng.uniform(-1, 1, (512, 3)).astype(np.float32) * [3, 3, 9] + [0, 0, -1]
    codes = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (50, 30, 256)]
    for name in ("coarse", "fine"):
        # a random ReLU field's raw sigma has nearly one sign: rescale each alpha head
        # to spread 3 over probe points, most of them empty, so the render has structure
        cfg, p = getattr(jspec, name), jax.tree.map(jnp.asarray, jp[name])
        cond = jfield.fold_conditioning(p, *map(jnp.asarray, codes))
        sig = np.asarray(jfield.apply_field_sigma(p, cond, jembed(jnp.asarray(probe),
                                                                  cfg.multires), cfg))
        gain = np.float32(3.0 / max(float(sig.std()), 1e-3))
        alpha = jp[name]["sigma"]["alpha"]
        alpha["w"] = alpha["w"] * gain
        alpha["b"] = (alpha["b"] - np.quantile(sig, 0.9)) * gain
    tp = bridge.model_params_to_torch(jp, tspec, device="cpu")
    jparams = jax.tree.map(jnp.asarray, jp)
    jcond = jr.prepare_conditioning(jparams, jspec, jnp.asarray(codes[0]),
                                    jr.exp_code_for(jparams, 3), jnp.asarray(codes[2]))
    tcond = tr.prepare_conditioning(tp, tspec, T(codes[0]), tr.exp_code_for(tp, 3),
                                    T(codes[2]))
    n = 24
    ro = np.tile(np.array([[0.0, 0.0, 16.0]], np.float32), (n, 1))
    rd = (rng.standard_normal((n, 3)) * [0.12, 0.12, 0.0] - [0, 0, 1]).astype(np.float32)
    want = jr.render_rays(jparams, jspec, jcond, jnp.asarray(ro), jnp.asarray(rd), train=False)
    got = tr.render_rays(tp, tspec, tcond, T(ro), T(rd), train=False)
    assert set(got) >= {"rgb0", "acc0", "rgb", "acc", "disp", "depth"}
    for k in ("rgb0", "acc0", "disp0", "rgb", "acc", "depth"):
        g, w = got[k].numpy(), np.asarray(want[k], np.float32)
        assert g.shape == w.shape and np.isfinite(g).all(), k
        # depth in scene units (8..26): relative; colours and opacities 1e-4 (f32 sum order)
        err = np.abs(g - w) / (1.0 + np.abs(w) * (10 if k in ("depth", "disp0") else 0))
        assert err.max() <= 1e-4, (k, err.max())
    acc = np.asarray(want["acc"])
    assert acc.min() < 0.9 and acc.max() > 0.1 and acc.std() > 0.05   # a scene, not fog or void


@pytest.mark.parametrize("depth,width,multires,dtype", [
    (8, 96, 10, "float32"),      # 3xTF32 stream, BN = 128
    (2, 16, 10, "float32"),      # 3xTF32 stream, BN = 64, depth lifted
    (8, 200, 10, "bfloat16"),    # the wgmma design's stream at the padded width 256
    (5, 64, 12, "bfloat16"),     # the mma.sync design (no stream), pe 75 -> width 128
])
def test_padded_operands_give_back_the_fields_weights(depth, width, multires, dtype):
    _, tcfg, _, tp, _, tcond = _field(depth, width, multires, dtype, 1)
    kcfg = fk.kernel_config(tcfg)
    W, w, w2 = kcfg.width, width, width // 2
    dt = DTYPES[dtype][1]
    fused = fk.pack_fused_params(tp, tcond, tcfg)
    assert tuple(fused.w_tiles.shape) == fk._stream_shape(kcfg)

    def field_stack(params):
        x, s, r = params["xyz"], params["sigma"], params["rgb"]
        ws = [layer["w"] for layer in x["layers"]]
        for t in (s, r):
            ws += [t["w_feat0"], *[m["w"] for m in t["mid"]], t["w_skip_feat"], t["w_skip_h"],
                   *[m["w"] for m in t["post"]]]
        return ws

    ws = field_stack(tp)
    assert fused.w_stack.shape == (fk._plan_len(kcfg), W, W) == (len(ws), W, W)
    for li, wl in enumerate(ws):
        assert torch.equal(fused.w_stack[li, :w, :w], wl.to(dt))
        assert (fused.w_stack[li, w:] == 0).all() and (fused.w_stack[li, :, w:] == 0).all()
    assert (fused.b_stack[:, w:] == 0).all() and (fused.b_pts[w:] == 0).all()
    pe = tcfg.pts_embed_dim
    assert torch.equal(fused.w_pts[:pe, :w], tp["xyz"]["w_pts"].to(dt))
    assert (fused.w_pts[pe:] == 0).all() and (fused.w_pts[:, w:] == 0).all()
    assert torch.equal(fused.w_view[:w, :w2], tp["view"]["w_feat"].to(dt))
    assert (fused.w_view[w:] == 0).all() and (fused.w_view[:, w2:] == 0).all()
    assert (fused.b_view[w2:] == 0).all()
    assert torch.equal(fused.w_out[:w, 3:], tp["sigma"]["alpha"]["w"].to(dt))
    assert torch.equal(fused.w_out[W:W + w2, :3], tp["view"]["rgb"]["w"].to(dt))
    assert (fused.w_out[w:W] == 0).all() and (fused.w_out[W + w2:] == 0).all()
    assert (fused.w_out[:W, :3] == 0).all() and (fused.w_out[W:, 3] == 0).all()

    if fk.uses_wgmma(kcfg):
        w_pts, w_stack, w_view = fk.untile_weights(fused.w_tiles, tcfg)
        assert torch.equal(w_stack, fused.w_stack) and torch.equal(w_view, fused.w_view)
        assert torch.equal(w_pts[:fused.w_pts.shape[0]], fused.w_pts)
    elif fk.uses_tf32(kcfg):
        parts = fk.untile_weights_tf32(fused.w_tiles, tcfg)
        plan = fk.tf32_plan(tcfg)
        assert len(parts) == len(plan) == 1 + kcfg.xyz_depth + 2 * kcfg.depth + 1
        for (hi, lo), (pieces, n_cols) in zip(parts, plan):
            mats = [{"w_pts": fused.w_pts, "w_view": fused.w_view}.get(op) for op, _ in pieces]
            mats = [fused.w_stack[li] if m is None else m for m, (_, li) in zip(mats, pieces)]
            want = torch.cat(mats)
            k, n = want.shape
            assert n == n_cols and hi.shape[0] % fk.TF32_K == 0 and hi.shape[1] % 64 == 0
            assert torch.equal(hi[:k, :n] + lo[:k, :n], (hi + lo)[:k, :n])
            err = (hi[:k, :n].double() + lo[:k, :n].double() - want.double()).abs()
            assert (err <= want.double().abs() * 2.0 ** -22).all()
            assert (hi[k:] == 0).all() and (hi[:, n:] == 0).all() and (lo[k:] == 0).all()
        # the pair is one product over k = 2W: [saved, h] @ [W_a; W_b]
        pairs = [pieces for pieces, _ in plan if len(pieces) == 2]
        base = kcfg.xyz_depth
        assert [[li for _, li in p] for p in pairs] == [
            [base + kcfg.skip + 1, base + kcfg.skip + 2],
            [base + kcfg.depth + 1 + kcfg.skip + 1, base + kcfg.depth + 1 + kcfg.skip + 2]]
    else:
        assert fused.w_tiles.shape[0] == 0


def test_tf32_stream_holds_the_planned_tiles_in_the_swizzle():
    """Tile by tile: product, column tile, k block, [hi; lo] of the transposed slice, its
    16-byte chunk c of row n at chunk c ^ (n % 8)."""
    _, tcfg, _, tp, _, tcond = _field(8, 128, 10, "float32", 5)
    fused = fk.pack_fused_params(tp, tcond, tcfg)
    bn = fk.tf32_cols(tcfg)
    assert bn == 128 and fused.w_tiles.shape[1:] == (2, bn, 32)
    at = 0
    for pieces, _ in fk.tf32_plan(tcfg):
        w = fk._tf32_pieces(fused.w_pts, fused.w_stack, fused.w_view, pieces, tcfg)
        k, n = w.shape
        for j in range(n // bn):
            for kb in range(k // 32):
                hi, lo = fk.tf32_split(w[kb * 32:(kb + 1) * 32, j * bn:(j + 1) * bn].t())
                tile = fused.w_tiles[at]
                for row, c in ((0, 0), (9, 3), (bn - 1, 7)):
                    got = c ^ (row % 8)
                    assert torch.equal(tile[0, row, got * 4:got * 4 + 4], hi[row, c * 4:c * 4 + 4])
                    assert torch.equal(tile[1, row, got * 4:got * 4 + 4], lo[row, c * 4:c * 4 + 4])
                at += 1
    assert at == fused.w_tiles.shape[0]


def test_tf32_split_is_exact_to_2_22_and_rounds_as_cvt_rna():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * np.exp(rng.uniform(-20, 20, 20000))).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0, -3.0]
    hi, lo = fk.tf32_split(T(x))
    bits_hi = hi.view(torch.int32).numpy()
    bits_lo = lo.view(torch.int32).numpy()
    assert (bits_hi & 0x1FFF == 0).all() and (bits_lo & 0x1FFF == 0).all()
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x.astype(np.float64))
    assert (err <= np.abs(x).astype(np.float64) * 2.0 ** -22).all()
    # nearest of the two TF32 neighbours, ties away from zero, either sign
    for bits, want in ((0x3F801000, 0x3F802000), (0x3F800FFF, 0x3F800000),
                       (0x3F803000, 0x3F804000), (0xBF801000, 0xBF802000),
                       (0x3F801001, 0x3F802000), (0x7F7FF000, 0x7F800000)):
        v = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
        got = int(fk.tf32_round(v).view(torch.int32)) & 0xFFFFFFFF
        assert got == want, (hex(bits), hex(got))


def _tf32x3(a, w):
    """a @ w in three TF32 products, each exact, summed in f32: lo_a hi_w + hi_a lo_w,
    then hi_a hi_w."""
    ah, al = fk.tf32_split(a)
    wh, wl = fk.tf32_split(w)
    return (al @ wh + ah @ wl) + ah @ wh


def _tf32x1(a, w):
    return fk.tf32_round(a) @ fk.tf32_round(w)


@pytest.mark.parametrize("depth,width,spr", [(8, 64, 7), (10, 128, 3)])
def test_3xtf32_emulation_holds_the_f32_contract(depth, width, spr):
    jcfg, tcfg, jp, tp, jcond, tcond = _field(depth, width, 10, "float32", 11)
    pe, dirf = _points(tcfg, 40, spr, 12)
    fused = fk.pack_fused_params(tp, tcond, tcfg)
    want = np.concatenate([np.asarray(a) for a in jfield.apply_field_folded(
        jp, jcond, jnp.asarray(pe), jnp.asarray(dirf), jcfg, spr)], axis=-1)
    scale = max(1.0, float(np.abs(want).max()))
    tol, tol_rms = (t * scale for t in FIELD_TOL["float32"])
    errs = {}
    for name, product in (("3xTF32", _tf32x3), ("1xTF32", _tf32x1)):
        got = torch.cat(fk._ref_apply(fused, T(pe), T(dirf), tcfg, spr, layer_mm=product), -1)
        diff = np.abs(got.numpy() - want)
        errs[name] = (float(diff.max()), float(np.sqrt((diff ** 2).mean())))
    assert errs["3xTF32"][0] <= tol and errs["3xTF32"][1] <= tol_rms, errs
    # the check is sharp: one TF32 product a product (about three digits) fails it
    assert errs["1xTF32"][0] > tol, errs


def test_tf32_scratch_and_chunks():
    fine = tfield.FieldConfig(depth=10, width=1024)
    coarse = tfield.FieldConfig(depth=8, width=256)
    small = tfield.FieldConfig(depth=2, width=16, multires=12)
    # a chunk holds at most 256 MB an activation, in whole 128-row tiles
    assert fk.tf32_scratch(fine, 10 ** 7) == (65536, 65536 * (64 + 3 * 1024))
    assert fk.tf32_scratch(coarse, 524288) == (262144, 262144 * (64 + 3 * 256))
    assert fk.tf32_scratch(fine, 1) == (128, 128 * (64 + 3 * 1024))
    assert fk.tf32_scratch(fine, 4097) == (4224, 4224 * (64 + 3 * 1024))
    # the padded small field: width 128 (pe 75 padded to 80, then to 128), k of 96
    assert fk.kernel_config(small).width == 128
    assert fk.tf32_scratch(small, 300) == (384, 384 * (96 + 3 * 128))
    assert fk.tf32_cols(fine) == fk.tf32_cols(coarse) == 128
    assert fk.tf32_cols(dataclasses.replace(coarse, width=192)) == 64
    assert fk.uses_tf32(fine) and not fk.uses_wgmma(fine)


@pytest.mark.parametrize("name", sorted(n for n, (_, p) in field_variants.PATCHES.items() if p))
def test_field_variant_patches_find_their_text(name):
    """utils/field_variants.py patches the kernel's sources by text: each patch must
    still find its line exactly once, or the variant it times is not the one named."""
    target, patches = field_variants.PATCHES[name]
    text = next(p for p in cuda_build.source_files("field_kernel") if p.name == target).read_text()
    for old, _ in patches:
        assert text.count(old) == 1, (name, old)
