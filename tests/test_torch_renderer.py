"""The teacher two-pass renderer of the port against the JAX package's, from
the same model params (the whole tree through the bridge) and rays made with
numpy from a seed, on every output key.

f32: the two differ in the order of sums only. The fields agree to ~1e-5 and
compositing keeps that: 1e-4 (`depth` and `z_std` are in scene units, 8..26,
and `disp` follows depth, so those are held relatively). The coarse pass
(`rgb0 disp0 acc0`, and every key when there is no fine pass) is held at that
on every ray. One thing downstream of it is not continuous: the last quantile
of the deterministic importance sampler is exactly 1, it always lands in the
last bin, and there (u - cdf_below) / denom divides an f32 cancellation error
of ~1e-7 by the bin's mass, which on an opaque ray is the sampler's 1e-5 floor;
under its 1e-5 guard the last bit of the cumulative sum picks one of two bin
edges. With these tests' wide bins (16 samples a ray) that sample moves by up
to a unit of depth; it takes the 1e10 end distance in compositing, so where
the fine pass sees few samples it can move a colour by ~1e-2. Nearly every
opaque ray has such a last bin, so the deterministic render cannot name the
rays to exempt. It is held twice instead:
- deterministic (`train=False`): five fine-pass elements in six at the tight
  tolerance and the rest at a stated jump;
- stochastic (`train=True`) with the JAX function's own uniforms, drawn in
  the test and injected into the port: they lie in [0, 1), so no quantile is
  1 and nothing jumps: every key on every ray at the tight tolerance, no
  quantile. This is the sharp check of sampler, sort, fine pass and compositing.
  With `fine_on_union=False` the fine pass sees only the 16 resampled depths:
  the gaps between their clusters are several units of depth, sigma follows
  sin(512 x) so a last-bit change of a depth moves it by ~1e-3, and
  alpha = 1 - exp(-sigma * gap) multiplies that by the gap: 5e-3 there.
bf16: the port's renderer follows the
fused kernel's contract on every device (products summed in f32, f32 bias
adds, f32 outputs) while the JAX XLA path also adds biases and rounds outputs
in bf16, so the two are close, not equal: 3e-2 on colours and opacities in
the deterministic render (coarse pass on every ray, fine pass 5/6 with a jump
of 0.3), and 5e-2 on every ray in the stochastic one on the union of samples."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.models import field as jfield
from mofanerf_tpu.ops.embed import fourier_embed as jembed
from mofanerf_tpu.ops.rays import pose_spherical
from mofanerf_tpu.render import renderer as jr
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.parallel import make_mesh
from mofanerf_tpu_torch.parallel.world import single_rank
from mofanerf_tpu_torch.render import renderer as tr

T = torch.from_numpy
KEYS = ("rgb0", "disp0", "acc0", "rgb", "disp", "acc", "depth", "z_std")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _specs(dtype="float32", **render_kw):
    jdt, tdt = DTYPES[dtype]
    rkw = {**dict(n_coarse=16, n_importance=16, packet_size=8), **render_kw}
    jspec = jr.MoFaNeRF(coarse=jfield.FieldConfig(depth=8, width=64, compute_dtype=jdt),
                        fine=jfield.FieldConfig(depth=10, width=128, compute_dtype=jdt),
                        render=jr.RenderConfig(**rkw), uv_size=128)
    tspec = tr.MoFaNeRF(coarse=tfield.FieldConfig(depth=8, width=64, compute_dtype=tdt),
                        fine=tfield.FieldConfig(depth=10, width=128, compute_dtype=tdt),
                        render=tr.RenderConfig(**rkw), uv_size=128)
    return jspec, tspec


def _codes(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (50, 30, 256)]


_MODEL = {}


def _model(seed=0):
    """JAX model params with visible structure (a random ReLU field's raw
    sigma has nearly one sign: rescale each alpha head to median 0, spread 3
    over probe points), as numpy, and the port's copy through the bridge."""
    if seed in _MODEL:
        return _MODEL[seed]
    jspec, tspec = _specs()
    jp = jax.tree.map(np.array, jr.init_model_params(jax.random.PRNGKey(seed), jspec))
    rng = np.random.default_rng(seed)
    probe = rng.uniform(-1, 1, (512, 3)).astype(np.float32) * [3, 3, 9] + [0, 0, -1]
    codes = _codes(100)
    for name in ("coarse", "fine"):
        cfg = getattr(jspec, name)
        p = jax.tree.map(jnp.asarray, jp[name])
        cond = jfield.fold_conditioning(p, *map(jnp.asarray, codes))
        sig = np.asarray(jfield.apply_field_sigma(
            p, cond, jembed(jnp.asarray(probe.astype(np.float32)), cfg.multires), cfg))
        gain = np.float32(3.0 / sig.std())
        alpha = jp[name]["sigma"]["alpha"]
        alpha["w"] = alpha["w"] * gain
        alpha["b"] = (alpha["b"] - np.float32(np.median(sig))) * gain
    _MODEL[seed] = (jp, bridge.model_params_to_torch(jp, tspec, device="cpu"))
    return _MODEL[seed]


def _conds(jp, tp, jspec, tspec, seed=100, exp=3):
    shape, _, tex = _codes(seed)
    jparams = jax.tree.map(jnp.asarray, jp)
    jcond = jr.prepare_conditioning(jparams, jspec, jnp.asarray(shape),
                                    jr.exp_code_for(jparams, exp), jnp.asarray(tex))
    tcond = tr.prepare_conditioning(tp, tspec, T(shape), tr.exp_code_for(tp, exp), T(tex))
    return jparams, jcond, tcond


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0.0, 0.0, 16.0]], np.float32), (n, 1))
    rd = (rng.standard_normal((n, 3)) * [0.12, 0.12, 0.0] - [0, 0, 1]).astype(np.float32)
    rd *= rng.uniform(0.8, 1.3, (n, 1)).astype(np.float32)     # unnormalised
    return ro, rd


COARSE_KEYS = ("rgb0", "disp0", "acc0")


def _check(got, want, tol, keys, jump=None):
    """Every key within `tol` (depth, disp and z_std relatively). With `jump`,
    one fine-pass element in six may exceed `tol`, by no more than `jump`
    (3 x `jump` for depth, in scene units): see the module docstring on the
    sampler. `z_std` is the spread of the very samples that jump, on any
    opaque ray: half of its elements within 10 x `tol`, all within one unit
    of depth. The coarse keys never get the allowance."""
    assert set(got) == set(want) == set(keys)
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k], np.float32)
        assert g.shape == w.shape, k
        err = np.abs(g - w)
        scene_units = k == "depth"
        if k in ("depth", "disp", "disp0") or (k == "z_std" and jump is None):
            err = err / (1.0 + 10 * np.abs(w))
        if jump is None or k in COARSE_KEYS:
            assert err.max() <= tol, (k, err.max())
        elif k == "z_std":
            assert np.median(err) <= 10 * tol and err.max() <= 1.0, (k, np.median(err), err.max())
        else:
            assert np.quantile(err, 5 / 6) <= tol, (k, np.quantile(err, 5 / 6))
            assert err.max() <= (3 * jump if scene_units else jump), (k, err.max())


def _train_pair(jspec, tspec, jparams, jcond, tp, tcond, ro, rd, seed=9):
    """The stochastic render of both packages from the same draws: the JAX
    function's own (its key split as render_rays splits it), injected into
    the port. The uniforms lie in [0, 1): no importance quantile is 1."""
    n, rc = ro.shape[0], tspec.render
    key = jax.random.PRNGKey(seed)
    want = jr.render_rays(jparams, jspec, jcond, jnp.asarray(ro), jnp.asarray(rd), key=key,
                          train=True)
    k_strat, k_pdf, k_nc, k_nf = jax.random.split(key, 4)
    n_fine = rc.n_importance + (rc.n_coarse if rc.fine_on_union else 0)
    draws = {"strat": jax.random.uniform(k_strat, (n, rc.n_coarse)),
             "pdf": jax.random.uniform(k_pdf, (n, rc.n_importance)),
             "noise_c": jax.random.normal(k_nc, (n, rc.n_coarse)),
             "noise_f": jax.random.normal(k_nf, (n, n_fine))}
    draws = {k: T(np.array(v)) for k, v in draws.items()}
    assert float(draws["pdf"].max()) < 1.0
    got = tr.render_rays(tp, tspec, tcond, T(ro), T(rd), train=True, draws=draws)
    return got, want


def test_model_tree_crosses_the_bridge_and_conditioning_matches():
    jspec, tspec = _specs()
    jp, tp = _model()
    assert set(tp) == {"coarse", "fine", "ism", "tex_encoder", "exp_codes"}
    for name in ("coarse", "fine", "ism"):
        for (k, a), (_, b) in zip(bridge.flatten_with_keystr(jp[name]),
                                  bridge.flatten_with_keystr(tp[name])):
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f"{name}{k}")
    np.testing.assert_array_equal(tp["exp_codes"].numpy(), jp["exp_codes"])
    with pytest.raises(ValueError, match="keys"):
        bridge.model_params_to_torch({k: v for k, v in jp.items() if k != "ism"}, tspec, "cpu")
    with pytest.raises(ValueError, match="w_pts|shape"):
        bridge.model_params_to_torch(jp, dataclasses.replace(
            tspec, fine=dataclasses.replace(tspec.fine, width=64)), "cpu")
    # the port's own init lays out the same tree
    own = tr.init_model_params(torch.Generator().manual_seed(0), tspec, device="cpu")
    assert [(k, tuple(v.shape)) for k, v in bridge.flatten_with_keystr(own)] == \
        [(k, tuple(v.shape)) for k, v in bridge.flatten_with_keystr(tp)]

    _, jcond, tcond = _conds(jp, tp, jspec, tspec)
    for jc, tc in zip(jcond, tcond):
        assert set(jc) == set(tc)
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-5, atol=1e-5)
    # the texture code from a UV map through both encoders
    uv = np.random.default_rng(1).uniform(0, 1, (128, 128, 3)).astype(np.float32)
    want = jr.encode_texture(jax.tree.map(jnp.asarray, jp), jspec, jnp.asarray(uv))
    got = tr.encode_texture(tp, tspec, T(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_conditioning_is_differentiable_in_the_codes():
    _, tspec = _specs()
    _, tp = _model()
    shape, exp, tex = (T(c).requires_grad_() for c in _codes(5))
    cond = tr.prepare_conditioning(tp, tspec, shape, exp, tex)
    ro, rd = (T(a) for a in _rays(6, 5))
    out = tr.render_rays(tp, tspec, cond, ro, rd)    # on the CPU: plain tensor code
    (out["rgb"].sum() + out["acc"].sum()).backward()
    for c in (shape, exp, tex):
        assert c.grad is not None and torch.isfinite(c.grad).all() and c.grad.abs().sum() > 0


@pytest.mark.parametrize("dtype,render_kw", [
    ("float32", {}),
    ("float32", {"fine_on_union": False}),
    ("float32", {"white_bkgd": True, "sigma_activation": "softplus"}),
    ("float32", {"lindisp": True}),
    ("float32", {"n_importance": 0}),
    ("bfloat16", {}),
    ("bfloat16", {"fine_on_union": False, "white_bkgd": True}),
], ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items()) or "default")
def test_render_rays_matches_jax(dtype, render_kw):
    jspec, tspec = _specs(dtype, **render_kw)
    jp, tp = _model()
    jparams, jcond, tcond = _conds(jp, tp, jspec, tspec)
    ro, rd = _rays(40, 2)
    want = jr.render_rays(jparams, jspec, jcond, jnp.asarray(ro), jnp.asarray(rd), train=False)
    got = tr.render_rays(tp, tspec, tcond, T(ro), T(rd), train=False)
    keys = KEYS if tspec.render.n_importance > 0 else ("rgb", "disp", "acc", "depth")
    rc = tspec.render
    if dtype == "float32":
        _check(got, want, 1e-4, keys, jump=None if not rc.n_importance else 5e-2)
    else:
        # depth and z_std follow the importance samples, which follow the coarse
        # weights: a bf16-sized change of those moves samples by a fraction of a bin
        _check(got, want, 3e-2, keys, jump=0.3)
    # the sharp check of everything after the coarse pass: no quantile is 1
    if rc.n_importance and (dtype == "float32" or rc.fine_on_union):
        tol = {"float32": 1e-4 if rc.fine_on_union else 5e-3, "bfloat16": 5e-2}[dtype]
        _check(*_train_pair(jspec, tspec, jparams, jcond, tp, tcond, ro, rd), tol, keys)
    acc = got["acc"].numpy()
    assert acc.max() > 0.5 and acc.std() > 0      # a scene, not a void
    if tspec.render.white_bkgd:
        assert got["rgb"].max() <= 1.0 + 1e-5


def test_render_rays_train_with_injected_draws():
    """The stochastic render with the JAX function's own draws injected."""
    jspec, tspec = _specs(raw_noise_std=0.5)
    jp, tp = _model()
    jparams, jcond, tcond = _conds(jp, tp, jspec, tspec)
    n = 24
    ro, rd = _rays(n, 3)
    got, want = _train_pair(jspec, tspec, jparams, jcond, tp, tcond, ro, rd)
    _check(got, want, 1e-4, KEYS)
    # without draws the generator supplies them, reproducibly; without either it raises
    a = tr.render_rays(tp, tspec, tcond, T(ro), T(rd), train=True,
                       generator=torch.Generator().manual_seed(1))
    b = tr.render_rays(tp, tspec, tcond, T(ro), T(rd), train=True,
                       generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["rgb"], got["rgb"])
    with pytest.raises(ValueError, match="Generator"):
        tr.render_rays(tp, tspec, tcond, T(ro), T(rd), train=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_frame_pads_the_last_packet(dtype):
    """5 x 5 = 25 rays in packets of 8: the last packet carries 7 rays of ones."""
    jspec, tspec = _specs(dtype)
    jp, tp = _model()
    jparams, jcond, tcond = _conds(jp, tp, jspec, tspec)
    K = np.array([[12.0, 0, 2.5], [0, 12.0, 2.5], [0, 0, 1]], np.float32)
    c2w = np.array(pose_spherical(20.0, -10.0, 16.0), np.float32)[:3]
    want = jr.render_frame(jparams, jspec, jcond, 5, 5, jnp.asarray(K), jnp.asarray(c2w))
    got = tr.render_frame(tp, tspec, tcond, 5, 5, K, c2w)
    assert got["rgb"].shape == (5, 5, 3) and got["acc"].shape == (5, 5)
    # a frame's rays come from each package's own get_rays: their directions
    # differ in the last bit, and sin(512 x) carries that to ~1e-4 in a colour
    if dtype == "float32":
        _check(got, want, 2e-4, KEYS, jump=5e-2)
    else:
        _check(got, want, 3e-2, KEYS, jump=0.3)
    # the frame is render_rays on its rays in packets of 8, the last one padded
    # with rays of ones and cut: bitwise, so the sharp checks of render_rays
    # hold for frames too
    from mofanerf_tpu_torch.ops.rays import get_rays
    fo, fd = (torch.cat([r.reshape(-1, 3), torch.ones((7, 3))]) for r in get_rays(5, 5, T(K), T(c2w)))
    rows = [tr.render_rays(tp, tspec, tcond, fo[i:i + 8], fd[i:i + 8]) for i in range(0, 32, 8)]
    for k in KEYS:
        assert torch.equal(got[k].reshape((25,) + rows[0][k].shape[1:]),
                           torch.cat([r[k] for r in rows])[:25]), k
    # packing once a frame gives what packing in every packet gives
    ro, rd = _rays(8, 4)
    pack = tr.pack_frame(tp, tspec, tcond)
    a = tr.render_rays(tp, tspec, tcond, T(ro), T(rd), pack=pack)
    b = tr.render_rays(tp, tspec, tcond, T(ro), T(rd))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_render_path_with_render_factor(tmp_path):
    jspec, tspec = _specs()
    jp, tp = _model()
    jparams, jcond, tcond = _conds(jp, tp, jspec, tspec)
    _, jcond2, tcond2 = _conds(jp, tp, jspec, tspec, seed=101, exp=14)
    poses = np.stack([pose_spherical(a, -5.0, 16.0) for a in (-30.0, 40.0)])
    hwf = (12, 12, 30.0)
    want_rgb, want_disp = jr.render_path(jparams, jspec, [jcond, jcond2], poses, hwf,
                                         render_factor=2)
    got_rgb, got_disp = tr.render_path(tp, tspec, [tcond, tcond2], poses, hwf, render_factor=2)
    assert got_rgb.shape == want_rgb.shape == (2, 6, 6, 3) and got_disp.shape == (2, 6, 6)
    _check({"rgb": T(got_rgb), "disp": T(got_disp)}, {"rgb": want_rgb, "disp": want_disp},
           2e-4, ("rgb", "disp"), jump=5e-2)   # each package's own rays: see above
    # one cond for the whole path, [N, 4, 4] poses, no down-sampling
    one_rgb, _ = tr.render_path(tp, tspec, tcond, poses[:1], (6, 6, 15.0))
    np.testing.assert_allclose(one_rgb[0], got_rgb[0], rtol=0, atol=1e-6)
    # the multi-card frame on a world of one rank (gloo, in this process) is the frame
    K = np.array([[15.0, 0, 3.0], [0, 15.0, 3.0], [0, 0, 1]], np.float32)
    one = tr.render_frame(tp, tspec, tcond, 6, 6, K, poses[0][:3])
    with single_rank("cpu", str(tmp_path)):
        sharded = tr.render_frame_sharded(tp, tspec, tcond, 6, 6, K, poses[0][:3], make_mesh())
    assert set(sharded) == set(one) and all(torch.equal(sharded[k], one[k]) for k in one)
