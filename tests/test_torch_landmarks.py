"""The port's training ray sampler (mofanerf_tpu_torch/data/landmarks.py)
against the JAX package's: one np.random.Generator seed gives identical
coordinates, with landmarks, with the foreground bias (no landmarks), with
the centre precrop and along the landmark anneal; and the rays through them
(`get_rays_at`) agree at f32 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.data import landmarks as jlm
from mofanerf_tpu.ops.rays import get_rays_at as jget_rays_at
from mofanerf_tpu.ops.rays import pose_spherical
from mofanerf_tpu_torch.data import landmarks as tlm
from mofanerf_tpu_torch.ops.rays import get_rays_at

H = W = 48
K = np.array([[96.0, 0, 24.0], [0, 96.0, 24.0], [0, 0, 1]], np.float32)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    landmarks = rng.uniform(-1, 1, (3, 20, 68, 3)).astype(np.float32) * 2 / 50 * 25
    target = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    target[:, : W // 3] = 0.0   # background to the left
    return landmarks, target


@pytest.mark.parametrize("case", ["landmarks", "foreground", "uniform", "precrop", "anneal"])
def test_sampler_coordinates_are_identical(case):
    landmarks, target = _inputs()
    lms = None if case in ("foreground", "uniform") else landmarks
    kw = {}
    if case == "precrop":
        kw["precrop_frac"] = 0.5
    if case != "uniform":
        kw["target_img"] = target
    j = jlm.TrainRaySampler(lms, H, W, lm_frac=0.6)
    t = tlm.TrainRaySampler(lms, H, W, lm_frac=0.6)
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    for i, theta in enumerate((-30.0, 0.0, 25.0)):
        pose = pose_spherical(theta, -10.0, 16.0)
        if case == "anneal":
            kw["lm_frac"] = tlm.anneal_lm_frac(i * 40, 0.6, 100)
            assert kw["lm_frac"] == jlm.anneal_lm_frac(i * 40, 0.6, 100)
        a = j.sample(rj, 300, K, pose, 1, 4 + i, **kw)
        b = t.sample(rt, 300, K, pose, 1, 4 + i, **kw)
        assert b.dtype == np.int32 and b.shape == (300, 2)
        np.testing.assert_array_equal(a, b)
        assert (b >= 0).all() and (b[:, 0] < H).all() and (b[:, 1] < W).all()
    # the generators are left in the same state
    assert rj.integers(1 << 30) == rt.integers(1 << 30)


def test_project_landmarks_and_anneal():
    landmarks, _ = _inputs(1)
    pose = pose_spherical(15.0, 5.0, 16.0)
    np.testing.assert_array_equal(tlm.project_landmarks(landmarks[0, 0], K, pose),
                                  jlm.project_landmarks(landmarks[0, 0], K, pose))
    for i, n in ((0, 10), (5, 10), (20, 10), (3, 0)):
        assert tlm.anneal_lm_frac(i, 0.6, n) == jlm.anneal_lm_frac(i, 0.6, n)


def test_get_rays_at_matches_jax():
    rng = np.random.default_rng(2)
    coords = rng.integers(0, H, (64, 2)).astype(np.float32)
    pose = pose_spherical(-20.0, 10.0, 16.0)
    jo, jd = jget_rays_at(jnp.asarray(coords), jnp.asarray(K), jnp.asarray(pose))
    to, td = get_rays_at(torch.from_numpy(coords), torch.from_numpy(K),
                         torch.from_numpy(pose.astype(np.float32)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scale", [1, 2, 4, 8])
@pytest.mark.parametrize("target", ["none", "image", "black"])
def test_fit_sampler_coordinates_are_identical(scale, target):
    """FitRaySampler: one seed gives the JAX package's coordinates bit for bit
    at every pyramid scale, without a target, with one (its black pixels
    dropped, the jaw outline added) and with an all-black one (the uniform
    fallback)."""
    side = 128 // scale
    rng = np.random.default_rng(3)
    kp2d = rng.uniform(20, 108, (68, 2))
    img = {"none": None, "black": np.zeros((side, side, 3), np.float32),
           "image": rng.uniform(0, 1, (side, side, 3)).astype(np.float32)}[target]
    if target == "image":
        img[:, : side // 3] = 0.0
    want = jlm.FitRaySampler(kp2d, 128).sample(np.random.default_rng(11), 200, scale, img)
    got = tlm.FitRaySampler(kp2d, 128).sample(np.random.default_rng(11), 200, scale, img)
    assert got.dtype == want.dtype == np.int32 and got.shape == (200, 2)
    np.testing.assert_array_equal(got, want)
