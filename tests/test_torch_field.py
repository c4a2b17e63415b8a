"""The conditioned field of the port against the JAX package's, from the same
params (through the bridge) and numpy inputs made from a seed. Everything is
f32 on the CPU, where the two differ only in the order of sums: 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.models import field as jfield
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import field as tfield

T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(depth, width=64, seed=0):
    jcfg = jfield.FieldConfig(depth=depth, width=width)
    tcfg = tfield.FieldConfig(depth=depth, width=width)
    jp = jax.tree.map(np.asarray, jfield.init_field_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), bridge.field_to_torch(jp, tcfg, "cpu")


def _codes(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (50, 30, 256)]


@pytest.mark.parametrize("depth", [8, 10])
def test_fold_conditioning_matches_jax(depth):
    _, _, jp, tp = _pair(depth)
    codes = _codes(1)
    want = jfield.fold_conditioning(jp, *map(jnp.asarray, codes))
    got = tfield.fold_conditioning(tp, *map(T, codes))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("depth,per_ray", [(8, True), (8, False), (10, True), (10, False)])
def test_apply_field_folded_matches_jax(depth, per_ray):
    jcfg, tcfg, jp, tp = _pair(depth, seed=2)
    codes = _codes(3)
    jcond = jfield.fold_conditioning(jp, *map(jnp.asarray, codes))
    tcond = tfield.fold_conditioning(tp, *map(T, codes))
    rng = np.random.default_rng(4)
    n_rays, spr = 6, 5
    pe = rng.standard_normal((n_rays * spr, tcfg.pts_embed_dim)).astype(np.float32)
    dirf = rng.standard_normal((n_rays if per_ray else n_rays * spr, 32)).astype(np.float32) * 0.1
    kw = dict(samples_per_ray=spr) if per_ray else {}
    jr, js = jfield.apply_field_folded(jp, jcond, jnp.asarray(pe), jnp.asarray(dirf), jcfg, **kw)
    tr, ts = tfield.apply_field_folded(tp, tcond, T(pe), T(dirf), tcfg, **kw)
    assert tr.shape == (n_rays * spr, 3) and ts.shape == (n_rays * spr, 1)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("depth", [8, 10])
def test_apply_field_sigma_and_apply_field_match_jax(depth):
    jcfg, tcfg, jp, tp = _pair(depth, seed=5)
    codes = _codes(6)
    jcond = jfield.fold_conditioning(jp, *map(jnp.asarray, codes))
    tcond = tfield.fold_conditioning(tp, *map(T, codes))
    rng = np.random.default_rng(7)
    pe = rng.standard_normal((20, tcfg.pts_embed_dim)).astype(np.float32)
    want = jfield.apply_field_sigma(jp, jcond, jnp.asarray(pe), jcfg)
    got = tfield.apply_field_sigma(tp, tcond, T(pe), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # unfolded apply from raw points, view directions and codes; the highest
    # embedding band multiplies a point by 512, so sin/cos differ by ~1e-5
    pts = rng.standard_normal((20, 3)).astype(np.float32)
    dirs = rng.standard_normal((20, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jr, js = jfield.apply_field(jp, jnp.asarray(pts), jnp.asarray(dirs),
                                *map(jnp.asarray, codes), jcfg)
    tr, ts = tfield.apply_field(tp, T(pts), T(dirs), *map(T, codes), tcfg)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("depth,width", [(8, 64), (10, 128)])
def test_init_layout_and_bounds(depth, width):
    jcfg = jfield.FieldConfig(depth=depth, width=width)
    tcfg = tfield.FieldConfig(depth=depth, width=width)
    assert (tcfg.pts_embed_dim, tcfg.views_embed_dim) == (jcfg.pts_embed_dim,
                                                          jcfg.views_embed_dim) == (63, 27)
    jp = jax.tree.map(np.asarray, jfield.init_field_params(jax.random.PRNGKey(0), jcfg))
    tp = tfield.init_field_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    shapes_j = [(k, v.shape) for k, v in bridge.flatten_with_keystr(jp)]
    shapes_t = [(k, tuple(v.shape)) for k, v in bridge.flatten_with_keystr(tp)]
    assert shapes_t == shapes_j
    bridge._check_shapes(tp, tfield.field_param_shapes(tcfg))   # raises on a mismatch
    assert tfield.field_param_count(tp) == jfield.field_param_count(jp)

    # Xavier bounds over the concatenated fan-in, torch-Linear bias bounds
    W, gain = width, np.sqrt(2.0)
    bounds = {
        ("xyz", "w_pts"): gain * np.sqrt(6.0 / (63 + 30 + W)),
        ("xyz", "b"): 1 / np.sqrt(63 + 30),
        ("sigma", "w_feat0"): gain * np.sqrt(6.0 / (50 + W + W)),
        ("sigma", "w_skip_h"): gain * np.sqrt(6.0 / (50 + 2 * W + W)),
        ("rgb", "w_skip_code"): gain * np.sqrt(6.0 / (256 + 2 * W + W)),
        ("rgb", "b_skip"): 1 / np.sqrt(256 + 2 * W),
        ("view", "w_dirs"): gain * np.sqrt(6.0 / (27 + W + W // 2)),
    }
    for (a, b), bound in bounds.items():
        for leaf in (tp[a][b].numpy(), jp[a][b]):
            assert np.abs(leaf).max() <= bound
            assert np.abs(leaf).max() > 0.9 * bound, (a, b)


def test_gradient_flows_through_the_fold():
    """Fitting optimises the codes through fold_conditioning and the field."""
    _, tcfg, _, tp = _pair(8, seed=8)
    codes = [T(c).requires_grad_() for c in _codes(9)]
    cond = tfield.fold_conditioning(tp, *codes)
    rng = np.random.default_rng(10)
    pe = T(rng.standard_normal((8, 63)).astype(np.float32))
    dirf = T(rng.standard_normal((8, 32)).astype(np.float32))
    rgb, sigma = tfield.apply_field_folded(tp, cond, pe, dirf, tcfg)
    (rgb.sum() + sigma.sum()).backward()
    for c in codes:
        assert c.grad is not None and torch.isfinite(c.grad).all() and c.grad.abs().sum() > 0


def test_bridge_rejects_a_wrong_field_layout():
    jcfg, tcfg, _, _ = _pair(8)
    jp = jax.tree.map(np.asarray, jfield.init_field_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="post"):       # two more post layers at depth 10
        bridge.field_to_torch(jp, tfield.FieldConfig(depth=10, width=64), "cpu")
    with pytest.raises(ValueError, match="w_pts"):
        bridge.field_to_torch(jp, tfield.FieldConfig(depth=8, width=128), "cpu")
    bad = dict(jp, view={k: v for k, v in jp["view"].items() if k != "rgb"})
    with pytest.raises(ValueError, match="keys"):
        bridge.field_to_torch(bad, tcfg, "cpu")
