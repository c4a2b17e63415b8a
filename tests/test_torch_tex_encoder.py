"""The texture encoder of the port against the JAX (flax) one: the flax
variables cross the bridge (conv kernels [kh, kw, in, out] -> [out, in, kh,
kw], dense kernels transposed, the first dense layer reading an NHWC flatten)
and the same seeded UV maps go through both. f32 on the CPU, sums of up to
4096 terms in another order: 1e-5 of the code's scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.models.tex_encoder import TextureEncoder as JaxTextureEncoder
from mofanerf_tpu.render import renderer as jrenderer
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models.tex_encoder import TextureEncoder, init_tex_encoder_params
from mofanerf_tpu_torch.render import renderer

T = torch.from_numpy


def _flax_variables(tex_dim, uv_size, seed):
    enc = JaxTextureEncoder(tex_dim=tex_dim)
    v = enc.init(jax.random.PRNGKey(seed), jnp.zeros((1, uv_size, uv_size, 3)))
    v = jax.tree.map(np.asarray, v)
    # flax starts biases at zero: give them values so that their mapping is tested
    rng = np.random.default_rng(seed)
    for layer in v["params"].values():
        layer["bias"] = rng.standard_normal(layer["bias"].shape).astype(np.float32) * 0.1
    return enc, v


@pytest.mark.parametrize("uv_size,tex_dim,batch", [(128, 256, 2), (128, 64, None), (256, 32, 1)])
def test_encoder_matches_flax(uv_size, tex_dim, batch):
    enc, v = _flax_variables(tex_dim, uv_size, seed=uv_size + tex_dim)
    state = bridge.tex_encoder_to_torch(v, tex_dim, uv_size, device="cpu")
    rng = np.random.default_rng(1)
    shape = (uv_size, uv_size, 3) if batch is None else (batch, uv_size, uv_size, 3)
    uv = rng.uniform(0, 1, shape).astype(np.float32)

    jspec = jrenderer.MoFaNeRF(tex_dim=tex_dim, uv_size=uv_size)
    tspec = renderer.MoFaNeRF(tex_dim=tex_dim, uv_size=uv_size)
    want = np.asarray(jrenderer.encode_texture({"tex_encoder": jax.tree.map(jnp.asarray, v)},
                                               jspec, jnp.asarray(uv)))
    got = renderer.encode_texture({"tex_encoder": state}, tspec, T(uv))
    assert got.shape == want.shape == ((tex_dim,) if batch is None else (batch, tex_dim))
    tol = 1e-5 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert np.abs(want).max() > 1e-3

    # the module itself, loaded with the same state, gives the same code
    module = TextureEncoder(tex_dim, uv_size)
    module.load_state_dict(state)
    with torch.no_grad():
        direct = module(T(uv) if batch is not None else T(uv)[None])
    np.testing.assert_array_equal(direct.numpy().reshape(want.shape), got.numpy())


def test_bridge_checks_the_encoder_tree():
    _, v = _flax_variables(32, 128, seed=3)
    with pytest.raises(ValueError, match="fc.weight"):     # the flatten depends on uv_size
        bridge.tex_encoder_to_torch(v, 32, 256, device="cpu")
    missing = {"params": {k: x for k, x in v["params"].items() if k != "mu"}}
    with pytest.raises(ValueError, match="layers"):
        bridge.tex_encoder_to_torch(missing, 32, 128, device="cpu")
    with pytest.raises(ValueError, match="too small"):
        TextureEncoder(32, 64)


def test_init_and_gradients():
    gen = torch.Generator().manual_seed(0)
    state = init_tex_encoder_params(gen, tex_dim=16, uv_size=128, device="cpu")
    module = TextureEncoder(16, 128)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in module.state_dict().items()}
    _, v = _flax_variables(16, 128, seed=4)
    n_flax = sum(x.size for x in jax.tree.leaves(v))
    assert sum(x.numel() for x in state.values()) == n_flax
    assert all((x == 0).all() for k, x in state.items() if k.endswith("bias"))
    w = state["convs.3.weight"]                       # fan-in-scaled normal kernels
    assert abs(float(w.std()) * np.sqrt(32 * 16) - 1.0) < 0.1
    # differentiable with respect to its weights (the training step updates them)
    state = {k: x.requires_grad_() for k, x in state.items()}
    spec = renderer.MoFaNeRF(tex_dim=16, uv_size=128)
    uv = torch.rand((128, 128, 3), generator=gen)
    renderer.encode_texture({"tex_encoder": state}, spec, uv).sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in state.values())
    assert state["convs.0.weight"].grad.abs().sum() > 0
