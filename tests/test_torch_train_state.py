"""The port's training step (mofanerf_tpu_torch/train/state.py) against the
JAX package's (mofanerf_tpu/train/state.py), from the same params (the JAX
init carried across by the bridge) and the same numpy batch, in f32 at a
small size: widths 64, 8 + 8 samples, UV 128, 16 rays, raw_noise_std = 0.
The sample placement is stochastic (perturb = 1) with the JAX step's own
uniforms, drawn here from its key and injected into the port (`draws=`):
both sides are then deterministic, and no importance quantile is exactly 1.
The fields embed points with 4 bands (multires 4): at 10, sin(512 x) turns
a last-bit difference of a sample's depth into a visible change of the
field, and the jitted JAX render's `rgb` moves by ~9e-3 from eager JAX's
there (tests/torch_train_grad_spread.py).
(With perturb = 0 the sampler's last quantile is 1, and on opaque rays the
last bit of a cumulative sum picks one of two bin edges for it: the fine
colour of such a ray jumps by up to ~0.1 between two correct
implementations; see tests/test_torch_renderer.py.)

- `lr_at`, and Adam against optax.adam on the same gradients: params, mu,
  nu and count at rtol 1e-6 after 3 updates;
- the loss and every leaf's gradient against jax.value_and_grad of the JAX
  step's loss (jitted): rtol 1e-4, atol 1e-6 x the leaf's max |g| (f32; the
  order of sums differs) for the coarse field, which only the coarse pass
  reaches; the leaves the fine pass reaches through its importance samples
  (fine field, texture encoder, ISM, expression bank) at atol 2e-5 x
  max |g|: jitted JAX's own gradients differ from eager JAX's by up to
  1.1e-5 x max |g| there, the port's from eager JAX's by up to 4.2e-6 x
  max |g| (tests/torch_train_grad_spread.py prints these spreads; eager JAX
  takes ~18 s, too long for this file);
- two train_steps from a state carried across by `train_state_to_torch`:
  losses at rtol 1e-4;
- a NaN target: params and Adam state bit-identical, `step` advanced; the
  next good update equal to JAX's for the same sequence (learning rate and
  bias correction follow the accepted updates, not `step`), per leaf within
  5e-4 in the L2 norm, against 1.5% and ~14% for the two wrong counts."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mofanerf_tpu.models import field as jfield
from mofanerf_tpu.ops.rays import get_rays_at as jget_rays_at
from mofanerf_tpu.ops.rays import pose_spherical
from mofanerf_tpu.render import renderer as jr
from mofanerf_tpu.train import state as jstate
from mofanerf_tpu.utils.metrics import img2mse as jimg2mse
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.render import renderer as tr
from mofanerf_tpu_torch.train import state as tstate
from mofanerf_tpu_torch.utils.tree import tree_leaves, tree_unflatten

N_RAYS, N_SAMPLES, UV, SIDE = 16, 8, 128, 32
MULTIRES = 4
# a fast schedule (decay 10x in 150 steps) so that lr_at(accepted updates) and
# lr_at(step) differ by 1.5% after one skipped step
LRATE, DECAY = 5e-5, 0.1
UPDATE_TOL = 5e-4   # relative L2 error of an update, per leaf


def _specs():
    rkw = dict(n_coarse=N_SAMPLES, n_importance=N_SAMPLES, perturb=1.0, raw_noise_std=0.0,
               packet_size=64)
    fkw = dict(depth=6, width=64, multires=MULTIRES, multires_views=2)
    jspec = jr.MoFaNeRF(coarse=jfield.FieldConfig(**fkw), fine=jfield.FieldConfig(**fkw),
                        render=jr.RenderConfig(**rkw), uv_size=UV)
    tspec = tr.MoFaNeRF(coarse=tfield.FieldConfig(**fkw), fine=tfield.FieldConfig(**fkw),
                        render=tr.RenderConfig(**rkw), uv_size=UV)
    return jspec, tspec


def _batch(seed, nan=False):
    """One batch as numpy: rays through random pixels of a 32x32 view."""
    rng = np.random.default_rng(seed)
    K = np.array([[64.0, 0, SIDE / 2], [0, 64.0, SIDE / 2], [0, 0, 1]], np.float32)
    pose = pose_spherical(float(rng.uniform(-40, 40)), -10.0, 16.0).astype(np.float32)
    coords = rng.integers(6, SIDE - 6, (N_RAYS, 2)).astype(np.float32)
    ro, rd = jget_rays_at(jnp.asarray(coords), jnp.asarray(K), jnp.asarray(pose))
    target = rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32)
    if nan:
        target[3, 1] = np.nan
    return dict(rays_o=np.asarray(ro), rays_d=np.asarray(rd), target_rgb=target,
                shape_code=(rng.standard_normal(50) * 0.3).astype(np.float32),
                exp_type=int(rng.integers(0, 20)),
                uv_map=rng.uniform(0, 1, (UV, UV, 3)).astype(np.float32))


def jax_batch(b):
    return jstate.Batch(**{k: (jnp.asarray(v, jnp.int32) if k == "exp_type" else jnp.asarray(v))
                           for k, v in b.items()})


def torch_batch(b):
    return tstate.Batch(**{k: (torch.tensor(v) if k == "exp_type" else torch.from_numpy(v.copy()))
                           for k, v in b.items()})


def jax_draws(key):
    """The uniforms jax's render_rays(train=True) draws from `key`, as the
    port's `draws`."""
    k_strat, k_pdf, _, _ = jax.random.split(key, 4)
    return {"strat": torch.from_numpy(np.array(jax.random.uniform(k_strat, (N_RAYS, N_SAMPLES)))),
            "pdf": torch.from_numpy(np.array(jax.random.uniform(k_pdf, (N_RAYS, N_SAMPLES))))}


def jax_loss(params, spec, batch, key):
    """The loss of the JAX train_step (mofanerf_tpu/train/state.py), as a function."""
    tex = jr.encode_texture(params, spec, batch.uv_map)
    cond = jr.prepare_conditioning(params, spec, batch.shape_code,
                                   jr.exp_code_for(params, batch.exp_type), tex)
    out = jr.render_rays(params, spec, cond, batch.rays_o, batch.rays_d, key, train=True)
    img_loss = jimg2mse(out["rgb"], batch.target_rgb)
    return img_loss + jimg2mse(out["rgb0"], batch.target_rgb), img_loss


@pytest.fixture(scope="module")
def setup():
    """The JAX state and the two jitted JAX functions of this module, built once."""
    jspec, tspec = _specs()
    # one compiled init: op by op it takes several times longer
    jstate0 = jax.jit(lambda k: jstate.create_train_state(k, jspec, LRATE, DECAY))(
        jax.random.PRNGKey(0))
    tx = jstate.make_optimizer(LRATE, DECAY)
    step = jax.jit(lambda s, b, k: jstate.train_step(s, b, k, jspec, tx))
    grad = jax.jit(jax.value_and_grad(lambda p, b, k: jax_loss(p, jspec, b, k), has_aux=True))
    return dict(jspec=jspec, tspec=tspec, jstate0=jstate0, step=step, grad=grad)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def carried(setup):
    return bridge.train_state_to_torch(to_numpy(setup["jstate0"]), setup["tspec"], device="cpu")


def test_lr_at_matches_jax():
    for step in (0, 1, 7, 1500, 123456):
        for lrate, decay in ((5e-5, 250), (1e-3, 1)):
            np.testing.assert_allclose(float(tstate.lr_at(step, lrate, decay)),
                                       float(jstate.lr_at(step, lrate, decay)), rtol=1e-6)


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(4).astype(np.float32),
                    rng.standard_normal((2, 2)).astype(np.float32)]}
    tx = optax.adam(learning_rate=lambda c: jstate.lr_at(c, LRATE, DECAY), b1=0.9, b2=0.999,
                    eps=1e-8)
    jp = jax.tree.map(jnp.asarray, params)
    jo = tx.init(jp)
    ours = tstate.make_optimizer(LRATE, DECAY)
    tp = bridge.to_torch(params, device="cpu")
    to = ours.init(tp)
    for k in range(3):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 10.0 ** (k - 1)).astype(np.float32),
                         params)
        upd, jo = tx.update(jax.tree.map(jnp.asarray, g), jo, jp)
        jp = optax.apply_updates(jp, upd)
        new_p, mu, nu, count = ours.update([torch.from_numpy(x) for x in tree_leaves(g)], to,
                                           tree_leaves(tp))
        tp = tree_unflatten(params, new_p)
        to = tstate.AdamState(count, tree_unflatten(params, mu), tree_unflatten(params, nu))
    adam, sched = jo
    assert int(to.count) == int(adam.count) == int(sched.count) == 3
    for ours_t, theirs in ((tp, jp), (to.mu, adam.mu), (to.nu, adam.nu)):
        for a, b in zip(tree_leaves(ours_t), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)


def test_loss_and_every_gradient_match_jax(setup):
    b = _batch(1)
    (jl, jimg), jg = setup["grad"](setup["jstate0"].params, jax_batch(b), jax.random.PRNGKey(3))
    state = carried(setup)
    leaves = tree_leaves(state.params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, img = tstate.loss_fn(tree_unflatten(state.params, live), setup["tspec"], torch_batch(b),
                               draws=jax_draws(jax.random.PRNGKey(3)))
    grads = torch.autograd.grad(loss, live)
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(img), float(jimg), rtol=1e-4)
    want = bridge.model_params_to_torch(to_numpy(jg), setup["tspec"], device="cpu")
    names = [k for k, _ in bridge.flatten_with_keystr(state.params)]
    for name, got, ref in zip(names, grads, tree_leaves(want)):
        scale = float(ref.abs().max())
        atol = (1e-6 if name.startswith("['coarse']") else 2e-5) * scale
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=atol, err_msg=name)
    # every part of the model learns from a step
    for part in ("coarse", "fine", "ism", "tex_encoder", "exp_codes"):
        idx = [i for i, n in enumerate(names) if n.startswith(f"['{part}']")]
        assert max(float(grads[i].abs().max()) for i in idx) > 0, part


def _run(setup, batches):
    """The same sequence of batches through both steps from the carried
    state: [(jax state, jax metrics)], [(port state, port metrics)]."""
    js, ts = setup["jstate0"], carried(setup)
    tx = tstate.make_optimizer(LRATE, DECAY)
    jout, tout = [], []
    for k, b in enumerate(batches):
        js, jm = setup["step"](js, jax_batch(b), jax.random.PRNGKey(k))
        ts, tm = tstate.train_step(ts, torch_batch(b), None, setup["tspec"], tx,
                                   draws=jax_draws(jax.random.PRNGKey(k)))
        jout.append((js, jm))
        tout.append((ts, tm))
    return jout, tout


def test_two_steps_match_jax(setup):
    jout, tout = _run(setup, [_batch(2), _batch(3)])
    for (js, jm), (ts, tm) in zip(jout, tout):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]), rtol=1e-4)
        assert bool(tm["step_ok"]) and bool(jm["step_ok"])
        assert int(ts.step) == int(js.step) and int(ts.opt_state.count) == int(js.opt_state[0].count)


def test_nonfinite_step_is_skipped_and_counts_follow_accepted_updates(setup):
    seq = [_batch(4), _batch(5, nan=True), _batch(6)]
    jout, tout = _run(setup, seq)
    (_, _), (ts1, _) = jout[0], tout[0]
    (js2, jm2), (ts2, tm2) = jout[1], tout[1]
    assert not bool(tm2["step_ok"]) and not bool(jm2["step_ok"])
    assert not np.isfinite(float(tm2["loss"]))
    # the skipped step leaves params and Adam state bit for bit, advances step only
    for a, b in zip(tree_leaves(ts1.params) + tree_leaves(ts1.opt_state.mu)
                    + tree_leaves(ts1.opt_state.nu),
                    tree_leaves(ts2.params) + tree_leaves(ts2.opt_state.mu)
                    + tree_leaves(ts2.opt_state.nu)):
        assert torch.equal(a, b)
    assert int(ts2.opt_state.count) == 1 and int(ts2.step) == 2
    assert int(js2.opt_state[0].count) == int(js2.opt_state[1].count) == 1
    # the next good update: lr_at(1) and bias correction at 2 accepted updates, as optax
    (js3, jm3), (ts3, tm3) = jout[2], tout[2]
    assert int(ts3.opt_state.count) == 2 and int(ts3.step) == 3
    np.testing.assert_allclose(float(tm3["loss"]), float(jm3["loss"]), rtol=1e-4)
    jdelta = bridge.model_params_to_torch(
        jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), js3.params, js2.params),
        setup["tspec"], device="cpu")
    names = [k for k, _ in bridge.flatten_with_keystr(ts3.params)]
    # held per leaf in the L2 norm: an element whose two gradients nearly cancel
    # has a noisy Adam ratio, but a wrong count moves every element (lr by 1.5%,
    # bias correction by ~14%)
    assert 1 - float(tstate.lr_at(2, LRATE, DECAY) / tstate.lr_at(1, LRATE, DECAY)) > 20 * UPDATE_TOL
    for name, a, b, ref in zip(names, tree_leaves(ts3.params), tree_leaves(ts2.params),
                               tree_leaves(jdelta)):
        err = float(torch.linalg.norm(a - b - ref) / torch.linalg.norm(ref))
        assert err <= UPDATE_TOL, (name, err)
