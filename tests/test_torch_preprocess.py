"""The port's host-side preprocessing (mofanerf_tpu_torch/preprocess/ and the
image operations it adds to utils/image_io.py) against the JAX package's and,
where the JAX package calls OpenCV, against cv2 itself. Same seeded numpy
inputs on both sides.

Tolerances: the float64 landmark, pose and SH work <= 1e-9; the aligned image
<= 1e-5 of JAX's (cv2.warpAffine); `warp_affine` <= 1e-5 of cv2 at 64^2,
border ring included; `hull_mask` byte-equal on fuzzed landmark sets; the
8-bit Lab conversions byte-equal to cv2 (the share of equal bytes asserted at
1.0, as measured; the acceptance bound is 1 LSB).
"""
import cv2
import numpy as np
import pytest
import torch

from mofanerf_tpu.preprocess import align as jalign
from mofanerf_tpu.preprocess import matting as jmat
from mofanerf_tpu.preprocess import pose as jpose
from mofanerf_tpu.preprocess import sh as jsh
from mofanerf_tpu.preprocess.segment import face_mask_from_parsing as j_face_mask
from mofanerf_tpu_torch.preprocess import align as talign
from mofanerf_tpu_torch.preprocess import matting as tmat
from mofanerf_tpu_torch.preprocess import pose as tpose
from mofanerf_tpu_torch.preprocess import sh as tsh
from mofanerf_tpu_torch.preprocess.segment import face_mask_from_parsing as t_face_mask
from mofanerf_tpu_torch.utils.image_io import lab_to_rgb_u8, rgb_to_lab_u8, warp_affine

TPL = jalign.CANONICAL_LANDMARKS_512


def _similarity(rng, scale=None, deg=None):
    s = rng.uniform(0.6, 1.4) if scale is None else scale
    th = np.deg2rad(rng.uniform(-25, 25) if deg is None else deg)
    return np.array([[s * np.cos(th), -s * np.sin(th), rng.uniform(-40, 40)],
                     [s * np.sin(th), s * np.cos(th), rng.uniform(-40, 40)]])


def _noisy_landmarks(rng, M):
    kp = np.concatenate([TPL, np.ones((68, 1))], 1) @ M.T
    return kp + rng.normal(0, 2.0, kp.shape)


def test_canonical_template_is_the_jax_packages():
    np.testing.assert_array_equal(talign.CANONICAL_LANDMARKS_512, TPL)


@pytest.mark.parametrize("seed", range(4))
def test_procrustes_and_warped_landmarks_match_jax(seed):
    rng = np.random.default_rng(seed)
    kp = _noisy_landmarks(rng, _similarity(rng))
    np.testing.assert_allclose(talign.procrustes_similarity(kp, TPL),
                               jalign.procrustes_similarity(kp, TPL), rtol=0, atol=1e-9)
    img = rng.uniform(0, 1, (96, 80, 3)).astype(np.float32)
    _, want = jalign.align_to_template(img, kp)
    _, got = talign.align_to_template(torch.from_numpy(img), kp)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_align_to_template_image_matches_jax(seed):
    """The aligned 512^2 image: cv2.warpAffine on the JAX side, the port's
    warp_affine here, from a photo whose landmarks sit off the template."""
    rng = np.random.default_rng(10 + seed)
    h, w = 120, 100
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    M = _similarity(rng, scale=rng.uniform(0.15, 0.25))
    M[:, 2] = [w / 2 - 0.2 * 256, h / 2 - 0.2 * 256]
    kp = _noisy_landmarks(rng, M)
    want, _ = jalign.align_to_template(img, kp)
    got, _ = talign.align_to_template(torch.from_numpy(img), kp)
    assert got.shape == (512, 512, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_warp_affine_matches_cv2_border_included(seed):
    """A rotated, scaled and shifted 64^2 image: every output pixel,
    including the ring whose bilinear taps fall partly outside the input
    (they blend with the constant border 0), and a gray image."""
    rng = np.random.default_rng(20 + seed)
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    M = _similarity(rng, scale=rng.uniform(0.7, 1.4), deg=rng.uniform(-30, 30))
    M[:, 2] = rng.uniform(-16, 16, 2)
    want = cv2.warpAffine(img, M, (64, 64), flags=cv2.INTER_LINEAR)
    got = warp_affine(torch.from_numpy(img), M, (64, 64)).numpy()
    ring = (want.max(-1) > 0) & (cv2.warpAffine(np.ones((64, 64), np.float32), M, (64, 64)) < 1)
    assert ring.sum() > 20   # the border ring is exercised
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    gray = img[..., 0]
    np.testing.assert_allclose(warp_affine(torch.from_numpy(gray), M, (48, 72)).numpy(),
                               cv2.warpAffine(gray, M, (48, 72), flags=cv2.INTER_LINEAR),
                               rtol=0, atol=1e-5)


def test_pose_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(3):
        rvec = rng.normal(0, 0.5, 3)
        np.testing.assert_allclose(tpose.rodrigues(rvec), jpose.rodrigues(rvec), atol=1e-12)
    lm3d = rng.uniform(-1, 1, (68, 3))
    R = jpose.rodrigues(np.array([0.1, -0.25, 0.05]))
    kp = jpose._project_ortho(lm3d, 95.0, np.array([250.0, 270.0]), R) \
        + rng.normal(0, 0.5, (68, 2))
    np.testing.assert_allclose(tpose._project_ortho(lm3d, 95.0, np.array([250.0, 270.0]), R),
                               jpose._project_ortho(lm3d, 95.0, np.array([250.0, 270.0]), R),
                               atol=1e-9)
    want = jpose.fit_pose_orthographic(kp, lm3d)
    got = tpose.fit_pose_orthographic(kp, lm3d)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tpose.pose_to_c2w(*want[:3]), jpose.pose_to_c2w(*want[:3]),
                               atol=1e-9)
    c2w_t, res_t = tpose.estimate_pose_from_kp(kp, lm3d)
    c2w_j, res_j = jpose.estimate_pose_from_kp(kp, lm3d)
    np.testing.assert_allclose(c2w_t, c2w_j, rtol=0, atol=1e-9)
    assert abs(res_t - res_j) <= 1e-9


def test_sh_matches_jax():
    n = np.random.default_rng(4).normal(size=(50, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    coeffs = np.random.default_rng(5).normal(size=9)
    np.testing.assert_allclose(tsh.sh_basis(n), jsh.sh_basis(n), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tsh.sh_shading(n, coeffs), jsh.sh_shading(n, coeffs),
                               rtol=0, atol=1e-9)


def _fuzzed_landmarks(rng, t):
    """Landmark sets of every awkward kind: template-like faces under a
    similarity, collinear runs, repeated points, tiny clusters, points far
    outside the image."""
    kind = t % 5
    n = int(rng.integers(3, 80))
    if kind == 0:
        return _noisy_landmarks(rng, _similarity(rng)) * rng.uniform(0.3, 1.2)
    if kind == 1:
        d = rng.integers(-5, 6, 2)
        return rng.integers(-50, 560, 2) + np.outer(rng.integers(-40, 40, n), d)
    if kind == 2:
        return np.repeat(rng.uniform(-10, 520, (max(1, n // 10), 2)), 10, 0)
    if kind == 3:
        return rng.uniform(0, 4, (n, 2)) + rng.integers(-2, 520, 2)
    return rng.normal(rng.uniform(-100, 600, 2), rng.choice([3, 40, 300, 2000]), (n, 2))


@pytest.mark.parametrize("chunk", range(4))
def test_hull_mask_byte_equal_to_jax(chunk):
    """50 fuzzed landmark sets a chunk, 200 in all: cv2.convexHull +
    cv2.fillConvexPoly on the JAX side, the port's hull and 16.16 edge walk
    here, byte for byte."""
    rng = np.random.default_rng(100 + chunk)
    for t in range(50):
        shape = tuple(int(v) for v in rng.integers(16, 520, 2))
        kp = _fuzzed_landmarks(rng, t)
        np.testing.assert_array_equal(tmat.hull_mask(shape, kp), jmat.hull_mask(shape, kp),
                                      err_msg=f"set {t} of chunk {chunk}")


def test_apply_mask_and_parse_mask_match_jax():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (40, 30, 3)).astype(np.float32)
    mask = (rng.uniform(size=(40, 30)) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(tmat.apply_mask(img, mask), jmat.apply_mask(img, mask))
    np.testing.assert_array_equal(
        tmat.apply_mask(torch.from_numpy(img), torch.from_numpy(mask)).numpy(),
        jmat.apply_mask(img, mask))
    parse = rng.integers(0, 19, (512, 64))
    np.testing.assert_array_equal(t_face_mask(parse), j_face_mask(parse))


def _lab_inputs():
    rng = np.random.default_rng(7)
    colours = rng.integers(0, 256, (100_000, 3), dtype=np.uint8)
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    return np.concatenate([colours, ramp])[None]


@pytest.mark.parametrize("code", ["RGB2LAB", "LAB2RGB"])
def test_lab_u8_matches_cv2(code):
    """10^5 seeded colours and the gray ramp through cv2's 8-bit conversion
    and the port's. Measured: every byte equal (checked on all 2^24 inputs of
    each direction while writing the tables); held here at a share of 1.0
    and within 1 LSB."""
    x = _lab_inputs()
    port = rgb_to_lab_u8 if code == "RGB2LAB" else lab_to_rgb_u8
    want = cv2.cvtColor(x, getattr(cv2, f"COLOR_{code}"))
    got = port(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() == 1.0


def test_lab_round_trip_is_lossy_like_cv2():
    """RGB -> Lab -> RGB moves out-of-gamut colours by up to ~22 in cv2; the
    port moves the same colours by the same amounts."""
    x = _lab_inputs()
    want = cv2.cvtColor(cv2.cvtColor(x, cv2.COLOR_RGB2LAB), cv2.COLOR_LAB2RGB)
    got = lab_to_rgb_u8(rgb_to_lab_u8(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(want.astype(int) - x.astype(int)).max() > 5


def test_landmark_sources_match_jax(tmp_path):
    kp = np.random.default_rng(8).uniform(0, 500, (68, 2))
    np.save(tmp_path / "kp_a.npy", kp)
    for xy in (False, True):
        want = jalign.PrecomputedLandmarkSource(str(tmp_path), xy).detect(None, "a")
        got = talign.PrecomputedLandmarkSource(str(tmp_path), xy).detect(None, "a")
        np.testing.assert_array_equal(got, want)
    assert talign.get_landmark_source(None, None) is None
    assert talign.PrecomputedLandmarkSource(str(tmp_path)).detect(None, "b") is None
    # a predictor path that does not exist falls through to the precomputed source
    src = talign.get_landmark_source(str(tmp_path), str(tmp_path / "missing.dat"))
    assert isinstance(src, talign.PrecomputedLandmarkSource)
