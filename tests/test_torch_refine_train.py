"""The port's RefineNet training (mofanerf_tpu_torch/train/refine.py) against
the JAX package's, at tests/test_refine.py's small config (ngf / ndf 8, 2
downsamplings, 2 blocks, n_layers_D 2, 32 x 32).

- `refine_train_step` taken step by step from JAX's carried state (each
  step starts from JAX's state, bridged; free runs of two correct
  implementations separate through Adam's per-element normalisation), with
  and without the VGG and L1 terms: the losses at rtol 1e-4, the new
  moments mu and nu at rtol 1e-4 (atol 1e-6 of the tree's largest), the
  new parameters at rtol 1e-4 but where Adam's update takes the sign of a
  gradient that is 0 but for rounding (within 2.5 x lr, under 2% of the
  elements); the counts and the step.
- The rate across the constant-to-decay boundary against optax's.
- The checkpoint round trip, and a directory of the JAX package's Orbax
  steps read (refused before the port read them).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mofanerf_tpu.models.refine.losses import VGG19Features as JVGG
from mofanerf_tpu.train import refine as jref
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.train import refine as tref
from mofanerf_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr

SZ = 32
SMALL = dict(ngf=8, ndf=8, n_downsampling=2, n_blocks=2, num_D=2, n_layers_D=2, use_vgg=False,
             niter=2, niter_decay=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the suite runs
    several workers on the machine's cores, and torch's default of a thread a
    core makes them spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (1, SZ, SZ, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    return a, b


def _close_tree(got, want, what, lr=None):
    """Leaf by leaf at rtol 1e-4 with atol 1e-6 of the tree's largest value
    (the biases of convolutions followed by an instance norm have a gradient
    that is 0 but for rounding, in both packages). With `lr`, parameters:
    where Adam's update took the sign of such a gradient, within 2.5 x lr,
    on under 2% of the tree's elements."""
    pairs = [(k, t.numpy(), w.numpy()) for (k, t), (_, w) in
             zip(flatten_with_keystr(got), flatten_with_keystr(want))]
    atol = 1e-6 * max(float(np.abs(w).max()) for _, _, w in pairs)
    n_bad = n_all = 0
    for k, t, w in pairs:
        if lr is None:
            np.testing.assert_allclose(t, w, rtol=1e-4, atol=atol, err_msg=f"{what}{k}")
            continue
        bad = ~np.isclose(t, w, rtol=1e-4, atol=atol)
        assert np.abs(t - w)[bad].max(initial=0.0) <= 2.5 * lr, f"{what}{k}"
        n_bad, n_all = n_bad + bad.sum(), n_all + bad.size
    assert n_bad <= 0.02 * max(n_all, 1), f"{what}: {n_bad} of {n_all} outside rtol 1e-4"


@pytest.mark.parametrize("terms", ["gan", "gan_vgg_l1"])
def test_train_step_matches_jax_step_by_step(terms):
    extra = dict(use_vgg=True, lambda_l1=5.0) if terms == "gan_vgg_l1" else {}
    jcfg = jref.RefineConfig(**{**SMALL, **extra})
    tcfg = tref.RefineConfig(**{**SMALL, **extra})
    a, b = _inputs()
    js = jax.jit(lambda k: jref.init_refine_state(k, jcfg, image_size=SZ))(jax.random.PRNGKey(0))
    g_jtx, d_jtx = jref.make_refine_optimizers(jcfg)
    g_ttx, d_ttx = tref.make_refine_optimizers(tcfg)
    jvgg = tvgg = None
    if jcfg.use_vgg:
        jvgg = jax.tree.map(np.asarray, jax.jit(JVGG().init)(jax.random.PRNGKey(7),
                                                             jnp.zeros((1, SZ, SZ, 3))))
        tvgg = bridge.vgg_to_torch(jvgg, device="cpu")
    jstep = jax.jit(lambda s: jref.refine_train_step(s, jnp.asarray(a), jnp.asarray(b), jcfg,
                                                     g_jtx, d_jtx, jvgg))
    for i in range(2):
        ts = bridge.refine_state_to_torch(jax.tree.map(np.asarray, js), tcfg, device="cpu")
        ts, tm = tref.refine_train_step(ts, torch.from_numpy(a), torch.from_numpy(b), tcfg,
                                        g_ttx, d_ttx, tvgg)
        js, jm = jstep(js)
        want = bridge.refine_state_to_torch(jax.tree.map(np.asarray, js), tcfg, device="cpu")
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=k)
        assert (float(tm["G_VGG"]) > 0) == jcfg.use_vgg
        assert int(ts.step) == int(want.step) == i + 1
        for name in ("g", "d"):
            opt, wopt = getattr(ts, f"{name}_opt"), getattr(want, f"{name}_opt")
            assert int(opt.count) == int(wopt.count) == i + 1
            _close_tree(opt.mu, wopt.mu, f"{name} mu")
            _close_tree(opt.nu, wopt.nu, f"{name} nu")
            _close_tree(getattr(ts, f"{name}_params"), getattr(want, f"{name}_params"),
                        f"{name} params", lr=tcfg.lr)


def test_rate_across_the_decay_boundary_matches_optax():
    """Constant gradients 1: each update is -rate(count) / (1 + eps), for 3
    steps an epoch, 2 epochs constant, 2 of decay, and past the end."""
    cfg = dict(lr=3e-4, niter=2, niter_decay=2)
    g_jtx, _ = jref.make_refine_optimizers(jref.RefineConfig(**cfg), steps_per_epoch=3)
    g_ttx, _ = tref.make_refine_optimizers(tref.RefineConfig(**cfg), steps_per_epoch=3)
    jp = {"w": jnp.zeros(4)}
    jopt = g_jtx.init(jp)
    tp = {"w": torch.zeros(4)}
    topt = g_ttx.init(tp)
    rates = []
    for _ in range(16):
        ju, jopt = g_jtx.update({"w": jnp.ones(4)}, jopt, jp)
        new_p, mu, nu, count = g_ttx.update([torch.ones(4)], topt, [tp["w"]])
        topt = topt._replace(count=count, mu={"w": mu[0]}, nu={"w": nu[0]})
        np.testing.assert_allclose(new_p[0].numpy(), np.asarray(ju["w"]), rtol=1e-6, atol=1e-12)
        rates.append(float(-ju["w"][0]))
    assert rates[:7] == pytest.approx([3e-4] * 7, rel=1e-5)       # counts 0..6: constant
    assert rates[8] == pytest.approx(3e-4 * (1 - 2 / 6), rel=1e-5)
    assert rates[12:] == [0.0] * 4                                 # counts >= 12: zero


def test_checkpoint_round_trip(tmp_path):
    cfg = tref.RefineConfig(**SMALL)
    g_tx, d_tx = tref.make_refine_optimizers(cfg)
    state = tref.init_refine_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    a, b = _inputs()
    state, _ = tref.refine_train_step(state, torch.from_numpy(a), torch.from_numpy(b), cfg,
                                      g_tx, d_tx)
    path = save_checkpoint(str(tmp_path), state, 1)
    assert os.path.basename(path) == "000001.pt"
    keys = torch.load(path, weights_only=True)
    assert "['g_params']['stem.weight']" in keys and "['d_opt']['count']" in keys
    fresh = tref.init_refine_state(torch.Generator().manual_seed(5), cfg, device="cpu")
    back = restore_checkpoint(str(tmp_path), fresh)
    for (k, x), (_, y) in zip(flatten_with_keystr(tref.refine_tree(back)),
                              flatten_with_keystr(tref.refine_tree(state))):
        assert torch.equal(x, y), k
    # a directory of Orbax steps only (refused, naming the ROADMAP item, before the
    # port read them) is read: a digit-named directory without a step is not one
    from mofanerf_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

    os.makedirs(tmp_path / "orbax" / "000011")
    assert latest_step(str(tmp_path / "orbax")) is None
    jcfg = jref.RefineConfig(**SMALL)
    js = jax.jit(lambda k: jref.init_refine_state(k, jcfg, image_size=SZ))(jax.random.PRNGKey(6))
    jax_save_checkpoint(str(tmp_path / "orbax"), js, 10)
    assert latest_step(str(tmp_path / "orbax")) == 10
    back = restore_checkpoint(str(tmp_path / "orbax"), fresh, spec=cfg)
    want = bridge.refine_state_to_torch(jax.tree.map(np.asarray, js), cfg, device="cpu")
    for (k, x), (_, y) in zip(flatten_with_keystr(tref.refine_tree(back)),
                              flatten_with_keystr(tref.refine_tree(want))):
        assert torch.equal(x, y), k
    # another model's state is refused
    with pytest.raises(ValueError, match="does not hold"):
        restore_checkpoint(str(tmp_path), tref.init_refine_state(
            torch.Generator(), dataclasses.replace(cfg, n_blocks=1), device="cpu"))


def test_inference_matches_jax():
    jcfg, tcfg = jref.RefineConfig(**SMALL), tref.RefineConfig(**SMALL)
    js = jax.jit(lambda k: jref.init_refine_state(k, jcfg, image_size=SZ))(jax.random.PRNGKey(3))
    ts = bridge.refine_state_to_torch(jax.tree.map(np.asarray, js), tcfg, device="cpu")
    a = np.random.default_rng(4).uniform(-1, 1, (2, SZ, SZ, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jref.refine_inference(p, x, jcfg))(js.g_params, jnp.asarray(a))
    got = tref.refine_inference(ts.g_params, torch.from_numpy(a), tcfg)
    assert got.shape == (2, SZ, SZ, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
