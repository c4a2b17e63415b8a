"""Sample placement of the port against the JAX package's: the deterministic
paths to one unit in the last place of a depth (the frame render feeds these
into sin(512 x), so the last bits matter), the random paths with the uniforms
drawn by `jax.random.uniform` here and injected into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.ops import sampling as jsampling
from mofanerf_tpu_torch.ops import sampling

T = torch.from_numpy


def _assert_within_ulps(got, want, ulps=1):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want), ulps * np.spacing(np.abs(want)) + 1e-30)


def _near_far(n, seed):
    rng = np.random.default_rng(seed)
    near = rng.uniform(2.0, 9.0, (n, 1)).astype(np.float32)
    far = near + rng.uniform(5.0, 20.0, (n, 1)).astype(np.float32)
    return near, far


@pytest.mark.parametrize("n_samples,lindisp", [(64, False), (17, False), (64, True), (2, False)])
def test_stratified_z_vals_deterministic(n_samples, lindisp):
    near, far = _near_far(11, n_samples)
    want = jsampling.stratified_z_vals(None, jnp.asarray(near), jnp.asarray(far), n_samples,
                                       0.0, lindisp)
    got = sampling.stratified_z_vals(None, T(near), T(far), n_samples, 0.0, lindisp)
    _assert_within_ulps(got.numpy(), want)
    # the reference frame's own interval is reproduced exactly
    eight, twentysix = np.full((3, 1), 8.0, np.float32), np.full((3, 1), 26.0, np.float32)
    want = jsampling.stratified_z_vals(None, jnp.asarray(eight), jnp.asarray(twentysix),
                                       n_samples, 0.0, lindisp)
    got = sampling.stratified_z_vals(None, T(eight), T(twentysix), n_samples, 0.0, lindisp)
    if not lindisp:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _assert_within_ulps(got.numpy(), want)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_z_vals_with_injected_uniforms(lindisp):
    near, far = _near_far(9, 5)
    key = jax.random.PRNGKey(3)
    want = jsampling.stratified_z_vals(key, jnp.asarray(near), jnp.asarray(far), 32, 1.0, lindisp)
    u = np.array(jax.random.uniform(key, (9, 32)))      # the draw the JAX function makes
    got = sampling.stratified_z_vals(T(u), T(near), T(far), 32, 1.0, lindisp)
    # lower + (upper - lower) * u: a fused multiply-add on one side moves the last bits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=0)
    z = got.numpy()
    assert (np.diff(z, axis=-1) >= 0).all() and (z >= near).all() and (z <= far).all()


def _bins_weights(n, m, seed, zero=False):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(8.0, 26.0, (n, m)).astype(np.float32), axis=-1)
    w = rng.uniform(0.0, 1.0, (n, m - 1)).astype(np.float32) ** 4   # peaky, like a surface
    if zero:
        w[: n // 2] = 0.0    # rays that hit nothing: every bin gets the 1e-5 floor
    return bins, w


@pytest.mark.parametrize("n_samples,zero", [(64, False), (33, False), (64, True)])
def test_sample_pdf_deterministic(n_samples, zero):
    bins, w = _bins_weights(13, 63, n_samples, zero)
    want = jsampling.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), n_samples, det=True)
    got = sampling.sample_pdf(None, T(bins), T(w), n_samples, det=True)
    assert got.shape == (13, n_samples)
    # the quantiles are bitwise the same; the cumulative sums run in another
    # order (sequential here, a tree under XLA), one ulp of a cdf value apart in
    # places, which the division by a thin bin's mass stretches: nine depths in
    # ten within one ulp, 99 in 100 within eight. Where a quantile falls on the
    # edge of a bin whose mass is under the 1e-5 guard, the two cdfs may pick
    # neighbouring bins and the guard makes that a jump, of at most one bin.
    err = np.abs(got.numpy() - np.asarray(want))
    ulp = np.spacing(np.float32(26.0))
    assert np.quantile(err, 0.9) <= ulp and np.quantile(err, 0.99) <= 8 * ulp
    assert err.max() <= np.diff(bins, axis=-1).max()
    if zero:   # uniform weights give evenly spread samples
        g = got.numpy()[0]
        assert g.min() >= bins[0].min() and g.max() <= bins[0].max()
        assert (np.diff(g) > 0).all()


def test_sample_pdf_with_injected_uniforms_and_detach():
    bins, w = _bins_weights(7, 31, 2)
    key = jax.random.PRNGKey(5)
    want = jsampling.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 24, det=False)
    u = np.array(jax.random.uniform(key, (7, 24)))
    wt = T(w).requires_grad_()
    got = sampling.sample_pdf(T(u), T(bins), wt, 24, det=False)
    err = np.abs(got.numpy() - np.asarray(want))   # as in the deterministic case
    assert np.quantile(err, 0.99) <= 8 * np.spacing(np.float32(26.0))
    assert err.max() <= np.diff(bins, axis=-1).max()
    assert not got.requires_grad     # resampled depths are constants for the loss


def test_random_draws_come_from_the_generator_only():
    near, far = (T(a) for a in _near_far(5, 1))
    with pytest.raises(ValueError, match="Generator"):
        sampling.stratified_z_vals(None, near, far, 8, 1.0)
    bins, w = (T(a) for a in _bins_weights(5, 9, 1))
    with pytest.raises(ValueError, match="Generator"):
        sampling.sample_pdf(None, bins, w, 4, det=False)
    with pytest.raises(ValueError, match="shape"):
        sampling.sample_pdf(torch.zeros(5, 3), bins, w, 4, det=False)
    a = sampling.stratified_z_vals(None, near, far, 8, 1.0,
                                   generator=torch.Generator().manual_seed(4))
    b = sampling.stratified_z_vals(None, near, far, 8, 1.0,
                                   generator=torch.Generator().manual_seed(4))
    torch.manual_seed(123)   # the global RNG plays no part
    c = sampling.stratified_z_vals(None, near, far, 8, 1.0,
                                   generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and torch.equal(a, c)
    s = sampling.sample_pdf(None, bins, w, 6, generator=torch.Generator().manual_seed(4))
    assert s.shape == (5, 6) and (s >= bins.min()).all() and (s <= bins.max()).all()
