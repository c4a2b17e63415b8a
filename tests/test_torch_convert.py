"""The port's reference-checkpoint converter (mofanerf_tpu_torch/convert.py)
and its CLI (cli/convert_ckpt.py).

Seeded state dicts in the reference's exact key layout (tests/test_convert.py
builds them) are converted by both packages: the port's tree equals, bit for
bit, what `bridge` makes of the JAX converter's output (fields, ISM, texture
encoder, expression bank), with and without DataParallel's `module.`
prefixes. The port's field on the converted params matches an independent
F.linear forward of the reference's modules over the raw state dicts
(tests/test_convert.py::torch_field_forward) at rtol = atol = 1e-4 (f32; only
the order of sums differs, the port splitting each concat-input matrix). A
whole `.tar` (tests/test_convert_checkpoint.py's layout and widths) renders
through the port's convert_checkpoint + render_rays as through JAX's, two
passes from a 512^2 UV map, at the 3e-3 of the JAX converter's own test.
The CLI converts a full-width `.tar` into a `.pt` that restores to the
in-process conversion with the `.tar`'s step and a fresh Adam state."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu import convert as jconvert
from mofanerf_tpu.models.field import FieldConfig as JFieldConfig
from mofanerf_tpu.render import renderer as jr
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch import convert as tconvert
from mofanerf_tpu_torch.cli import convert_ckpt
from mofanerf_tpu_torch.models.field import FieldConfig, apply_field
from mofanerf_tpu_torch.ops.embed import fourier_embed
from mofanerf_tpu_torch.render import renderer as tr
from mofanerf_tpu_torch.train import checkpoint as ck
from mofanerf_tpu_torch.train import state as tstate
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr
from tests.test_convert import _lin, make_field_sd, torch_field_forward
from tests.test_convert_checkpoint import (CFG_C, CFG_F, EXP_SLOT, FAR, N_COARSE, N_IMP, NEAR,
                                           TEX_DIM, _make_ism_sd)


def _port_cfg(c: JFieldConfig) -> FieldConfig:
    return FieldConfig(depth=c.depth, width=c.width, skip=c.skip, tex_dim=c.tex_dim)


def _tex_sd(g, tex_dim):
    """The reference texture encoder's state dict (EnDeUVmap at a 512^2 UV)."""
    widths = [(3, 32), (32, 32), (32, 32), (32, 32), (32, 64), (64, 128), (128, 256)]
    sd = {}
    for ci, (cin, cout) in zip(range(0, 14, 2), widths):
        sd[f"encoder.down1.0.{ci}.weight"] = torch.randn(cout, cin, 4, 4, generator=g) * 0.1
        sd[f"encoder.down1.0.{ci}.bias"] = torch.randn(cout, generator=g) * 0.05
    sd.update(_lin("encoder.down2.0", 512, 256 * 4 * 4, g))
    sd.update(_lin("encoder.mu", tex_dim, 512, g))
    for di in (0, 2, 4):
        sd.update(_lin(f"encoder.decoding.{di}", tex_dim, tex_dim, g))
    return sd


def _write_tar(path, cfg_c, cfg_f, tex_dim, seed=11, step=1000):
    g = torch.Generator().manual_seed(seed)
    sd_c, sd_f = make_field_sd(cfg_c, g), make_field_sd(cfg_f, g)
    sd_c["alpha_linear.0.bias"] = sd_c["alpha_linear.0.bias"] + 2.0
    sd_f["alpha_linear.0.bias"] = sd_f["alpha_linear.0.bias"] + 2.0
    ckpt = {"global_step": step,
            "network_fn_state_dict": {f"module.{k}": v for k, v in sd_c.items()},
            "network_fine_state_dict": {f"module.{k}": v for k, v in sd_f.items()},
            "network_render_textureEncoder": _tex_sd(g, tex_dim),
            "network_render_idSpecific": _make_ism_sd(g),
            "optimizer_state_dict": {"state": {}, "param_groups": []},
            "expression_latent_codes_sigma": [torch.randn(1, 30, generator=g) * 0.3
                                              for _ in range(20)]}
    torch.save(ckpt, path)
    return ckpt


def _assert_equal(got, want):
    g, w = flatten_with_keystr(got), flatten_with_keystr(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), k


@pytest.mark.parametrize("part", ["field", "ism", "tex_encoder", "exp_codes"])
def test_conversion_bit_exact_against_the_jax_converter(part):
    g = torch.Generator().manual_seed(0)
    if part == "field":
        sd = make_field_sd(CFG_C, g)
        got = tconvert.convert_field(sd, _port_cfg(CFG_C), "cpu")
        want = bridge.field_to_torch(jconvert.convert_field(sd, CFG_C), _port_cfg(CFG_C), "cpu")
    elif part == "ism":
        sd = _make_ism_sd(g)
        got = tconvert.convert_ism(sd, device="cpu")
        want = bridge.to_torch(jconvert.convert_ism(sd), "cpu")
    elif part == "tex_encoder":
        sd = _tex_sd(g, TEX_DIM)
        got = tconvert.convert_tex_encoder(sd, "cpu")
        want = bridge.tex_encoder_to_torch(jconvert.convert_tex_encoder(sd), TEX_DIM, 512, "cpu")
    else:
        latents = [torch.randn(1, 30, generator=g) for _ in range(20)]
        got = {"bank": tconvert.convert_exp_codes(latents, device="cpu")}
        want = bridge.to_torch({"bank": jconvert.convert_exp_codes(latents)}, "cpu")
        assert got["bank"].shape == (21, 30) and not got["bank"][20].any()
    _assert_equal(got, want)


def test_module_prefix_is_dropped():
    g = torch.Generator().manual_seed(1)
    sd = make_field_sd(CFG_F, g)
    plain = tconvert.convert_field(sd, _port_cfg(CFG_F), "cpu")
    wrapped = tconvert.convert_field({f"module.{k}": v for k, v in sd.items()},
                                     _port_cfg(CFG_F), "cpu")
    _assert_equal(wrapped, plain)
    ism = _make_ism_sd(g)
    _assert_equal(tconvert.convert_ism({f"module.{k}": v for k, v in ism.items()}, device="cpu"),
                  tconvert.convert_ism(ism, device="cpu"))


def test_field_against_the_reference_forward():
    cfg = _port_cfg(CFG_F)
    g = torch.Generator().manual_seed(2)
    sd = make_field_sd(CFG_F, g)
    params = tconvert.convert_field(sd, cfg, "cpu")
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.standard_normal((64, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.standard_normal((64, 3)).astype(np.float32))
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    shape, exp, tex = (torch.from_numpy((rng.standard_normal(n) * 0.3).astype(np.float32))
                       for n in (50, 30, TEX_DIM))
    rgb, sigma = apply_field(params, pts, dirs, shape, exp, tex, cfg)
    rgb_t, sigma_t = torch_field_forward(sd, CFG_F, fourier_embed(pts, cfg.multires), exp[None],
                                         shape[None], tex[None],
                                         fourier_embed(dirs, cfg.multires_views))
    torch.testing.assert_close(rgb, rgb_t, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sigma, sigma_t, rtol=1e-4, atol=1e-4)


def test_whole_tar_renders_as_jax(tmp_path):
    path = str(tmp_path / "001000.tar")
    _write_tar(path, CFG_C, CFG_F, TEX_DIM)
    rkw = dict(n_coarse=N_COARSE, n_importance=N_IMP, near=NEAR, far=FAR)
    jspec = jr.MoFaNeRF(coarse=CFG_C, fine=CFG_F, render=jr.RenderConfig(**rkw), tex_dim=TEX_DIM)
    tspec = tr.MoFaNeRF(coarse=_port_cfg(CFG_C), fine=_port_cfg(CFG_F),
                        render=tr.RenderConfig(**rkw), tex_dim=TEX_DIM)
    jparams = jconvert.convert_checkpoint(path, CFG_C, CFG_F)
    tparams = tconvert.convert_checkpoint(path, tspec, "cpu")
    _assert_equal(tparams, bridge.model_params_to_torch(jparams, tspec, "cpu"))

    rng = np.random.default_rng(9)
    shape = (rng.standard_normal(50) * 0.3).astype(np.float32)
    uv = rng.uniform(0, 1, (512, 512, 3)).astype(np.float32)
    ro = np.zeros((5, 3), np.float32)
    rd = (rng.standard_normal((5, 3)) * 1.3).astype(np.float32)
    jp = {k: (jnp.asarray(v) if k == "exp_codes" else v) for k, v in jparams.items()}
    jtex = jr.encode_texture(jp, jspec, jnp.asarray(uv))
    jcond = jr.prepare_conditioning(jp, jspec, jnp.asarray(shape),
                                    jr.exp_code_for(jp, EXP_SLOT), jtex)
    want = jr.render_rays(jp, jspec, jcond, jnp.asarray(ro), jnp.asarray(rd))
    with torch.no_grad():
        ttex = tr.encode_texture(tparams, tspec, torch.from_numpy(uv))
        tcond = tr.prepare_conditioning(tparams, tspec, torch.from_numpy(shape),
                                        tr.exp_code_for(tparams, EXP_SLOT), ttex)
        # widths 32 and 48 are not the field kernel's (multiples of 64): the plain route
        got = tr.render_rays(tparams, tspec, tcond, torch.from_numpy(ro), torch.from_numpy(rd),
                             autograd=True)
    for k in ("rgb0", "acc0", "rgb", "acc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=3e-3, atol=3e-3,
                                   err_msg=k)
    assert float(got["acc"].max()) > 0.1


def test_cli_writes_a_pt_that_restores_the_conversion(tmp_path, capsys):
    full_c, full_f = JFieldConfig(depth=8, width=256), JFieldConfig(depth=10, width=1024)
    tar = str(tmp_path / "ref.tar")
    _write_tar(tar, full_c, full_f, 256, seed=4, step=4321)
    out = str(tmp_path / "ckpt")
    path = convert_ckpt.main(["--tar", tar, "--out_dir", out, "--device", "cpu"])
    assert os.path.basename(path) == "004321.pt" and "step 4321" in capsys.readouterr().out
    spec = tr.MoFaNeRF()
    want = tconvert.convert_checkpoint(tar, spec, "cpu")
    target = tstate.create_train_state(torch.Generator().manual_seed(0), spec, device="cpu")
    got = ck.restore_checkpoint(out, target)
    assert int(got.step) == 4321 and int(got.opt_state.count) == 0
    _assert_equal(got.params, want)
    assert all(not t.any() for t in flatten_with_keystr(got.opt_state.nu) for t in t[1:])
    # --step overrides the .tar's global_step
    path = convert_ckpt.main(["--tar", tar, "--out_dir", out, "--step", "7", "--device", "cpu"])
    assert os.path.basename(path) == "000007.pt"
