"""The port's fitting step (mofanerf_tpu_torch/train/fit.py) against the JAX
package's (mofanerf_tpu/train/fit.py), from the same model params (the JAX
init through the bridge), the same initial codes (JAX's, injected) and the
same numpy coordinates and targets, in f32 at a small size: depth 8, width
32, 8 + 8 samples, 32 rays at 16 x 16.

The fields embed points with 4 bands (multires 4): at 10, sin(512 x) makes
the fit's gradients hypersensitive to the last bits of a sample's position,
and the jitted JAX loss's own gradients move by about a percent from eager
JAX's there (the pose's most), while eager JAX takes too long for this file.
At 4 bands both are the same function to f32 rounding. The render is the
deterministic one (`train=False`) the fit differentiates.

- every code's gradient (pose, shape, exp, tex, light) of one fit loss against
  jax.value_and_grad: rtol 1e-4, atol 1e-5 x the leaf's max |g|;
- `fit_lr_schedule` at counts 0, 333 and 1600: rtol 1e-6;
- the three-group Adam against optax.multi_transform after 3 updates of the
  same gradients: counts equal, moments and codes at rtol 1e-6;
- `project_pose_so3` (Newton polar steps) against JAX's SVD projection
  within 1e-5 on noisy and on valid poses;
- a 15-step trajectory from JAX's initial codes, with and without a pose
  freeze that the run crosses: each step from JAX's state held at rtol 1e-5
  on the loss and within 1e-3 of a step on the codes; the port's free run
  (see the test for why its tolerance is wider)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mofanerf_tpu.models import field as jfield
from mofanerf_tpu.ops.rays import pose_spherical
from mofanerf_tpu.render import renderer as jr
from mofanerf_tpu.train import fit as jfit
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.render import renderer as tr
from mofanerf_tpu_torch.train import fit as tfit
from mofanerf_tpu_torch.utils.tree import tree_leaves

N_RAYS, SIDE, FOCAL = 32, 16, 20.0
K = np.array([[FOCAL, 0, SIDE / 2], [0, FOCAL, SIDE / 2], [0, 0, 1]], np.float32)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5   # atol x the leaf's max |g|
CODE_TOL = 1e-3                     # of a step's size (the base learning rate)


def _specs():
    fkw = dict(depth=8, width=32, multires=4)
    rkw = dict(n_coarse=8, n_importance=8)
    jspec = jr.MoFaNeRF(coarse=jfield.FieldConfig(**fkw), fine=jfield.FieldConfig(**fkw),
                        render=jr.RenderConfig(**rkw), uv_size=128)
    tspec = tr.MoFaNeRF(coarse=tfield.FieldConfig(**fkw), fine=tfield.FieldConfig(**fkw),
                        render=tr.RenderConfig(**rkw), uv_size=128)
    return jspec, tspec


@pytest.fixture(scope="module")
def model():
    jspec, tspec = _specs()
    jp = jr.init_model_params(jax.random.PRNGKey(0), jspec)
    tp = bridge.model_params_to_torch(jax.tree.map(np.asarray, jp), tspec, device="cpu")
    return jspec, tspec, jp, tp


def _jax_codes(cfg, seed=1, yaw=10.0):
    return jfit.init_fit_state(jax.random.PRNGKey(seed), cfg,
                               pose_spherical(yaw, -5.0, 16.0)).codes


def _to_torch(codes) -> tfit.FitCodes:
    return tfit.FitCodes(*[torch.tensor(np.asarray(c)) for c in codes])


def _batch(seed):
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(0, SIDE, N_RAYS), rng.integers(0, SIDE, N_RAYS)],
                      -1).astype(np.float32)
    return coords, rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32)


def test_fit_gradients_match_jax(model):
    """The gradient of one fit loss with respect to each code, the pose's
    included: the port differentiates render_rays(autograd=True) through the
    rays (get_rays_at), as JAX does."""
    jspec, tspec, jp, tp = model
    codes = _jax_codes(jfit.FitConfig(n_rand=N_RAYS, H=SIDE, W=SIDE, focal=FOCAL))
    codes = codes._replace(light=jnp.asarray([0.8, 1.3]),
                           exp=jnp.asarray(np.random.default_rng(2).normal(0, 0.5, 30),
                                           jnp.float32))
    coords, target = _batch(4)

    def jloss(c):
        from mofanerf_tpu.ops.rays import get_rays_at
        ro, rd = get_rays_at(jnp.asarray(coords), jnp.asarray(K), c.pose)
        cond = jr.prepare_conditioning(jp, jspec, c.shape, c.exp, c.tex)
        out = jr.render_rays(jp, jspec, cond, ro, rd, key=None, train=False)
        return jnp.mean(jnp.abs(c.light[0] * out["rgb"] - target))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(codes)
    live = tfit.FitCodes(*[c.requires_grad_(True) for c in _to_torch(codes)])
    loss = tfit.fit_loss(tp, tspec, live, torch.from_numpy(coords), torch.from_numpy(target),
                         torch.from_numpy(K))
    got = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for name, g, w in zip(tfit.FitCodes._fields, got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(w).max(), err_msg=name)
    # the model's weights take no gradient
    assert not any(t.requires_grad for t in tree_leaves(tp))


@pytest.mark.parametrize("count", [0, 333, 1600])
def test_fit_lr_schedule(count):
    want = float(jfit.fit_lr_schedule(2e-3, 2000, 1.1)(count))
    got = tfit.fit_lr_schedule(2e-3, 2000, 1.1)(torch.tensor(count, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(float(got), {0: 2e-3, 333: 2e-3 / 1.1, 1600: 5e-4}[count],
                               rtol=1e-5)


def test_fit_optimizer_state_matches_optax():
    """Three updates of the same gradients (the pose's zero in the first, as
    under a freeze): each group's count, mu and nu leaf by leaf, and the
    codes, against optax.multi_transform's. The frozen group still counts."""
    cfg = jfit.FitConfig(n_iters=12)   # a stage every 2 counts: the rate moves
    rng = np.random.default_rng(6)
    codes = _jax_codes(cfg)
    jtx, ttx = jfit.make_fit_optimizer(cfg), tfit.make_fit_optimizer(cfg)
    jstate, tcodes = jtx.init(codes), _to_torch(codes)
    tstate = tfit.fit_state_from_codes(tcodes, cfg).opt_state
    for i in range(3):
        g = [rng.normal(0, s, np.shape(c)).astype(np.float32)
             for c, s in zip(codes, (1e-2, 1e-3, 1e-1, 1.0, 1e-4))]
        if i == 0:
            g[3] = np.zeros_like(g[3])
        jg = jfit.FitCodes(*[jnp.asarray(v) for v in g])
        upd, jstate = jtx.update(jg, jstate, codes)
        codes = optax.apply_updates(codes, upd)
        tcodes, tstate = ttx.update(tfit.FitCodes(*[torch.from_numpy(v) for v in g]), tstate,
                                    tcodes)
    for name, c, w in zip(tfit.FitCodes._fields, tcodes, codes):
        np.testing.assert_allclose(c.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    for group, names in tfit.FIT_GROUPS.items():
        adam, sched = jstate.inner_states[group].inner_state
        assert int(tstate[group].count) == int(adam.count) == int(sched.count) == 3
        for name in names:
            for moment in ("mu", "nu"):
                np.testing.assert_allclose(
                    getattr(tstate[group], moment)[name].numpy(),
                    np.asarray(getattr(getattr(adam, moment), name)), rtol=1e-6, atol=1e-12,
                    err_msg=f"{group} {moment} {name}")


def _poses(seed, noise):
    """(valid pose, perturbed pose) as in tests/test_fit.py::test_project_pose_so3."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    valid = np.eye(4)
    valid[:3, :3] = q
    valid[:3, 3] = rng.normal(0, 3, 3)
    noisy = valid.copy()
    noisy[:3, :3] += noise * rng.normal(size=(3, 3))
    noisy[3] = [0.05, -0.01, 0.02, 0.93]
    return valid.astype(np.float32), noisy.astype(np.float32)


@pytest.mark.parametrize("seed,noise", [(3, 0.2), (4, 0.2), (5, 1e-3), (6, 0.05)])
def test_project_pose_so3(seed, noise):
    valid, noisy = _poses(seed, noise)
    want = np.asarray(jfit.project_pose_so3(jnp.asarray(noisy)))
    got = tfit.project_pose_so3(torch.from_numpy(noisy)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    R = got[:3, :3]
    np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(R) - 1.0) < 1e-5
    np.testing.assert_array_equal(got[3], [0.0, 0.0, 0.0, 1.0])
    np.testing.assert_array_equal(got[:3, 3], noisy[:3, 3])
    # a valid rigid pose maps to itself
    again = tfit.project_pose_so3(torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(again, valid, atol=1e-5)


@pytest.mark.parametrize("freeze", [0, 5])
def test_fit_trajectory_matches_jax(model, freeze):
    """15 fit steps from JAX's initial codes on one batch (a target rendered
    from other codes, as tests/test_fit.py fits), with and without a pose
    freeze that the run crosses.

    Step by step: each of JAX's 15 states (codes, optax's state, step) is
    carried across (`bridge.fit_state_to_torch`) and the port's step from it
    is held against JAX's next state: the loss at rtol 1e-5, every code within
    CODE_TOL of a step, the counts equal, each group's first moments at rtol
    1e-4 (atol 1e-4 x the leaf's max). Free-running, the port's own 15 steps:
    the pose bit-still through the freeze and on SO(3), the loss falling, and
    each step's loss within 2e-3 of JAX's: two free runs separate, the L1
    loss's residual signs and Adam's per-element normalisation amplifying
    last-bit differences step by step, and JAX's jitted and eager steps
    separate from each other by more than the port does from either."""
    jspec, tspec, jp, tp = model
    cfg = jfit.FitConfig(n_iters=30, n_rand=N_RAYS, H=SIDE, W=SIDE, focal=FOCAL,
                         pose_freeze_iters=freeze)
    tcfg = tfit.FitConfig(**dataclasses.asdict(cfg))
    jstate = jfit.init_fit_state(jax.random.PRNGKey(1), cfg, pose_spherical(10.0, -5.0, 16.0))
    free = tfit.fit_state_from_codes(_to_torch(jstate.codes), tcfg)
    coords, _ = _batch(0)
    truth = jstate.codes._replace(shape=jstate.codes.shape + 0.5,
                                  pose=jnp.asarray(pose_spherical(13.0, -5.0, 16.0)))
    from mofanerf_tpu.ops.rays import get_rays_at
    ro, rd = get_rays_at(jnp.asarray(coords), jnp.asarray(K), truth.pose)
    target = np.asarray(jr.render_rays(jp, jspec, jr.prepare_conditioning(
        jp, jspec, truth.shape, truth.exp, truth.tex), ro, rd)["rgb"])
    batch = (torch.from_numpy(coords), torch.from_numpy(target.copy()), torch.from_numpy(K))

    jtx, ttx = jfit.make_fit_optimizer(cfg), tfit.make_fit_optimizer(tcfg)
    jstep = jax.jit(lambda s: jfit.fit_step(jp, jspec, jtx, s, jnp.asarray(coords),
                                            jnp.asarray(target), jnp.asarray(K), freeze))
    pose0 = free.codes.pose.clone()
    jlosses, flosses = [], []
    for i in range(15):
        carried = bridge.fit_state_to_torch(jax.tree.map(np.asarray, jstate), device="cpu")
        jstate, jloss = jstep(jstate)
        jlosses.append(float(jloss))
        got, loss = tfit.fit_step(tp, tspec, ttx, carried, *batch, freeze)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg=f"loss of step {i}")
        want = bridge.fit_state_to_torch(jax.tree.map(np.asarray, jstate), device="cpu")
        assert int(got.step) == int(want.step) == i + 1
        for name, c, w in zip(tfit.FitCodes._fields, got.codes, want.codes):
            np.testing.assert_allclose(c.numpy(), w.numpy(), rtol=0, atol=CODE_TOL * cfg.lr,
                                       err_msg=f"{name} after step {i}")
        for group, names in tfit.FIT_GROUPS.items():
            assert int(got.opt_state[group].count) == int(want.opt_state[group].count)
            for name in names:
                a, b = got.opt_state[group].mu[name].numpy(), want.opt_state[group].mu[name].numpy()
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                           err_msg=f"{group} mu {name} after step {i}")

        free, floss = tfit.fit_step(tp, tspec, ttx, free, *batch, freeze)
        flosses.append(float(floss))
        if i < freeze:
            assert torch.equal(free.codes.pose, pose0), f"pose moved in frozen step {i}"
        R = free.codes.pose[:3, :3].numpy()
        np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(flosses, jlosses, rtol=2e-3)
    assert flosses[-1] < flosses[0]
    assert not torch.equal(free.codes.pose, pose0)


def test_init_fit_codes_draw_from_a_cpu_generator():
    """Codes come from a CPU generator: the same seed gives the same codes;
    the statistics scale and shift them; the expression starts from exp_init."""
    pose = pose_spherical(0.0, 0.0, 16.0)
    a = tfit.init_fit_codes(torch.Generator().manual_seed(3), pose, device="cpu")
    b = tfit.init_fit_codes(torch.Generator().manual_seed(3), pose, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert float(a.shape.std()) < 0.2 and torch.equal(a.exp, torch.zeros(30))
    assert torch.equal(a.light, torch.ones(2))
    np.testing.assert_array_equal(a.pose.numpy(), pose)
    stats = ((np.full(50, 2.0), np.full(50, 3.0)), (np.full(256, -1.0), np.full(256, 0.5)))
    exp0 = torch.arange(30, dtype=torch.float32)
    c = tfit.init_fit_codes(torch.Generator().manual_seed(3), pose, *stats, exp_init=exp0,
                            device="cpu")
    torch.testing.assert_close(c.shape, 2.0 + 3.0 * a.shape / 0.1)
    torch.testing.assert_close(c.tex, -1.0 + 0.5 * a.tex / 0.1)
    assert torch.equal(c.exp, exp0)
    state = tfit.init_fit_state(torch.Generator().manual_seed(3), tfit.FitConfig(), pose,
                                device="cpu")
    assert int(state.step) == 0 and set(state.opt_state) == set(tfit.FIT_GROUPS)
