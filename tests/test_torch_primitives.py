"""Port primitives against the JAX package: fourier_embed, get_rays,
pose_spherical, ray_aabb_interval, bounded_z_vals and composite. Inputs are
made with numpy from a seed and fed to both; f32 throughout."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu_torch.ops import bounds, composite, embed, rays

# by module path: the JAX package's ops/__init__ exports functions of these names
jbounds = importlib.import_module("mofanerf_tpu.ops.bounds")
jcomposite = importlib.import_module("mofanerf_tpu.ops.composite")
jembed = importlib.import_module("mofanerf_tpu.ops.embed")
jrays = importlib.import_module("mofanerf_tpu.ops.rays")
jmetrics = importlib.import_module("mofanerf_tpu.utils.metrics")

T = torch.from_numpy


@pytest.mark.parametrize("num_freqs,include_input", [(0, True), (0, False), (4, True),
                                                     (8, True), (10, False)])
def test_fourier_embed(num_freqs, include_input):
    x = np.random.default_rng(0).uniform(-5, 5, (2, 37, 3)).astype(np.float32)
    want = np.asarray(jembed.fourier_embed(jnp.asarray(x), num_freqs, include_input))
    got = embed.fourier_embed(T(x), num_freqs, include_input).numpy()
    assert got.shape == want.shape == (2, 37, embed.embed_dim(3, num_freqs, include_input))
    # sin/cos of arguments up to 5 * 2^9: both are accurate f32 sines
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert embed.embed_dim(3, num_freqs, include_input) == \
        jembed.embed_dim(3, num_freqs, include_input)


@pytest.mark.parametrize("H,W", [(16, 16), (9, 14)])
def test_get_rays(H, W):
    rng = np.random.default_rng(1)
    K = np.array([[30.0, 0, W / 2], [0, 31.0, H / 2], [0, 0, 1]], np.float32)
    c2w = rng.standard_normal((3, 4)).astype(np.float32)
    jo, jd = jrays.get_rays(H, W, jnp.asarray(K), jnp.asarray(c2w))
    to, td = rays.get_rays(H, W, T(K), T(c2w))
    assert td.shape == (H, W, 3) and to.shape == (H, W, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta,phi,radius", [(0.0, 0.0, 16.0), (-135.0, 20.0, 12.5),
                                              (90.0, -45.0, 3.0)])
def test_pose_spherical(theta, phi, radius):
    np.testing.assert_array_equal(rays.pose_spherical(theta, phi, radius),
                                  jrays.pose_spherical(theta, phi, radius))


def _ray_batch(n=64, seed=2):
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((n, 3)) * 4 + [0, 0, 12]).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd[:4] = [[0, 0, -1], [1, 0, 0], [0, 1e-12, -1], [0, 0, 1]]  # axis-aligned + tiny
    return ro, rd


def test_ray_aabb_interval():
    ro, rd = _ray_batch()
    for near, far in ((0.0, 30.0), (8.0, 14.0)):
        jt0, jt1, jhit = jbounds.ray_aabb_interval(
            jnp.asarray(ro), jnp.asarray(rd), (-3.0, -2.0, -4.0), (3.0, 2.0, 4.0), near, far)
        t0, t1, hit = bounds.ray_aabb_interval(T(ro), T(rd), (-3.0, -2.0, -4.0),
                                               (3.0, 2.0, 4.0), near, far)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        assert hit.any() and (~hit).any()
        np.testing.assert_allclose(t0.numpy(), np.asarray(jt0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t1.numpy(), np.asarray(jt1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_samples", [1, 8, 32])
def test_bounded_z_vals_deterministic(n_samples):
    rng = np.random.default_rng(3)
    t0 = rng.uniform(5, 10, 40).astype(np.float32)
    t1 = (t0 + rng.uniform(0, 6, 40)).astype(np.float32)
    want = np.asarray(jbounds.bounded_z_vals(None, jnp.asarray(t0), jnp.asarray(t1), n_samples))
    got = bounds.bounded_z_vals(None, T(t0), T(t1), n_samples).numpy()
    assert got.shape == (40, n_samples)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bounded_z_vals_perturbed_takes_injected_uniforms():
    rng = np.random.default_rng(4)
    t0 = rng.uniform(5, 10, 16).astype(np.float32)
    t1 = (t0 + 4).astype(np.float32)
    u = rng.uniform(size=(16, 8)).astype(np.float32)
    got = bounds.bounded_z_vals(T(u), T(t0), T(t1), 8, perturb=1.0).numpy()
    # the JAX formula with the same draws in place of its key's
    base = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    uu = np.clip(base + (u - 0.5) / 7.0, 0.0, 1.0)
    np.testing.assert_allclose(got, t0[:, None] + (t1 - t0)[:, None] * uu, rtol=1e-6, atol=1e-5)
    assert (got >= t0[:, None] - 1e-5).all() and (got <= t1[:, None] + 1e-5).all()
    with pytest.raises(ValueError):
        bounds.bounded_z_vals(None, T(t0), T(t1), 8, perturb=1.0)


@pytest.mark.parametrize("activation", ["relu", "softplus"])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_composite(activation, white_bkgd):
    rng = np.random.default_rng(5)
    n, s = 48, 16
    raw_rgb = rng.standard_normal((n, s, 3)).astype(np.float32)
    raw_sigma = (rng.standard_normal((n, s)) * 3).astype(np.float32)
    raw_sigma[:4] = -5.0     # empty rays
    z = np.sort(rng.uniform(8, 26, (n, s)), axis=-1).astype(np.float32)
    rd = (rng.standard_normal((n, 3)) * 1.3).astype(np.float32)
    want = jcomposite.composite(jnp.asarray(raw_rgb), jnp.asarray(raw_sigma), jnp.asarray(z),
                                jnp.asarray(rd), 0.0, white_bkgd, None,
                                sigma_activation=activation)
    got = composite.composite(T(raw_rgb), T(raw_sigma), T(z), T(rd), 0.0, white_bkgd, None,
                              sigma_activation=activation)
    for name in ("rgb", "acc", "weights", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.disp.numpy(), np.asarray(want.disp), rtol=1e-4, atol=1e-4)


def test_composite_noise_and_activation_names():
    rng = np.random.default_rng(6)
    raw_rgb = T(rng.standard_normal((4, 5, 3)).astype(np.float32))
    raw_sigma = T(rng.standard_normal((4, 5)).astype(np.float32))
    z = T(np.tile(np.linspace(8, 12, 5, dtype=np.float32), (4, 1)))
    rd = T(np.ones((4, 3), np.float32))
    noise = T(rng.standard_normal((4, 5)).astype(np.float32))
    a = composite.composite(raw_rgb, raw_sigma, z, rd, 0.5, False, noise)
    b = composite.composite(raw_rgb, raw_sigma + 0.5 * noise, z, rd)
    np.testing.assert_allclose(a.rgb.numpy(), b.rgb.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        composite.composite(raw_rgb, raw_sigma, z, rd, 0.5)
    with pytest.raises(ValueError):
        composite.sigma_act("exp")
    assert jcomposite.sigma_act("relu") is jax.nn.relu   # same names on both sides


def test_metrics():
    from mofanerf_tpu_torch.utils import metrics

    rng = np.random.default_rng(7)
    a = rng.uniform(-0.2, 1.2, (5, 6, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (5, 6, 3)).astype(np.float32)
    mse = metrics.img2mse(T(a), T(b))
    np.testing.assert_allclose(float(mse), float(jmetrics.img2mse(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(metrics.mse2psnr(mse)),
                               float(jmetrics.mse2psnr(jnp.asarray(float(mse)))), rtol=1e-5)
    np.testing.assert_array_equal(metrics.to8b(T(a)), jmetrics.to8b(a))
    np.testing.assert_array_equal(metrics.to8b(a), jmetrics.to8b(a))


@pytest.mark.parametrize("case", ["equal", "noisy", "shifted", "gray-range"])
def test_ssim(case):
    """The port's host-side SSIM against the JAX package's (both numpy f64)."""
    from mofanerf_tpu_torch.utils import metrics

    rng = np.random.default_rng(8)
    a = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    b = {"equal": a, "noisy": np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1),
         "shifted": np.roll(a, 3, axis=1), "gray-range": a * 0.5 + 0.2}[case]
    want = jmetrics.ssim(a, b)
    assert metrics.ssim(a, b) == want
    assert (want == 1.0) == (case == "equal")


def test_ndc_rays():
    """ndc_rays at f32 rounding against the JAX package's."""
    rng = np.random.default_rng(9)
    ro = (rng.standard_normal((48, 3)) + [0, 0, 16]).astype(np.float32)
    rd = (rng.standard_normal((48, 3)) * 0.2 + [0, 0, -1]).astype(np.float32)
    want = jrays.ndc_rays(32, 24, 40.0, 1.0, jnp.asarray(ro), jnp.asarray(rd))
    got = rays.ndc_rays(32, 24, 40.0, 1.0, T(ro), T(rd))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_transmittance_backward_is_torch_cumprods():
    """composite's transmittance product differentiates as torch.cumprod does
    on inputs without zeros, bit for bit, without torch's test for zeros (a
    read back to the host)."""
    x = (torch.from_numpy(np.random.default_rng(10).uniform(1e-10, 1.0, (64, 17)))
         .float().requires_grad_(True))
    g = torch.from_numpy(np.random.default_rng(11).standard_normal((64, 17))).float()
    want = torch.autograd.grad(torch.cumprod(x, -1), x, g)[0]
    out = composite._PositiveCumprod.apply(x)
    assert torch.equal(out, torch.cumprod(x, -1))
    assert torch.equal(torch.autograd.grad(out, x, g)[0], want)
