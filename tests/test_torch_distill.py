"""Distillation in the port (mofanerf_tpu_torch/train/distill.py) against the
JAX package's (mofanerf_tpu/train/distill.py), in f32 at a small size: a
teacher FieldConfig of depth 8, width 64 (4 + 2 embedding bands), a student
of depth 2, width 32, batches of 64 points. Both sides start from one JAX
init of the student (`init_point_field` patched to return it, carried across
by the bridge), and each step's random draws are rebuilt from
the JAX loop's own keys, `fold_in(fold_in(PRNGKey(seed + 1), done), i)`, and
injected (`draws=`); the teacher runs through the fused field kernel's plain
version on the CPU, which at f32 is `apply_field_folded`'s arithmetic.

- `student_config`, `init_point_field` / `refold_cond`, `init_student`'s warm
  start (both arches), constant-rate Adam against `optax.adam(lr)`: rtol 1e-6;
- `_sample_points` and `_sample_exp_code` with JAX's draws: atol 1e-6
  (normalisation and clipping in f32);
- `distill_loss` and its gradients against `jax.value_and_grad`: the loss at
  rtol 1e-5, every leaf at rtol 1e-4 and atol 1e-6 x its max |g| (the order
  of f32 sums differs);
- the B1 re-biasing helper against a full `pack_fused_params`, leaf by leaf,
  exactly (it copies the same f32 values);
- three steps each of `distill`, `distill_expressions` and `distill_avatars`:
  the per-step losses (rtol 1e-5 stepping the port's `distill_step` beside
  JAX's; the printed log lines of both loops, 5 decimals, at atol 1e-5); the final
  Adam first moments (the gradients' running sum) at rtol 1e-4, atol 1e-5 x
  the leaf's max (the later steps' gradients are taken at params that differ
  as below); the final params at atol 2e-5, 2% of one Adam step of
  1e-3 (Adam divides by the gradient's own size, so a leaf element whose
  gradient is ~1e-8 moves by a visible part of a step on a last-bit
  difference; a wrong gradient moves an element by a whole step);
The CLI's routes are tested in tests/test_torch_run_render.py."""
import importlib
import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mofanerf_tpu.models import field as jfield
from mofanerf_tpu.models import ism as jism
from mofanerf_tpu.models import student as jstudent
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.models import student as tstudent
from mofanerf_tpu_torch.ops import field_kernel as fk
from mofanerf_tpu_torch.train import distill as td
from mofanerf_tpu_torch.train import state as tstate
from mofanerf_tpu_torch.utils.tree import tree_leaves, tree_unflatten

jd = importlib.import_module("mofanerf_tpu.train.distill")

BATCH, SEED = 64, 2
TEACHER = dict(depth=8, width=64, multires=4, multires_views=2)
STUDENT = dict(depth=2, width=32)
T = torch.from_numpy


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _dcfg(mod, dtype, **kw):
    return mod.DistillConfig(batch=BATCH, compute_dtype=dtype, aabb_min=(-3.0, -3.0, -3.0),
                             aabb_max=(3.0, 3.0, 3.0), **STUDENT, **kw)


def _jdcfg(**kw):
    return _dcfg(jd, jnp.float32, **kw)


def _tdcfg(**kw):
    return _dcfg(td, torch.float32, **kw)


@pytest.fixture(scope="module")
def teacher():
    """A JAX teacher field with density over part of the box, its folded
    conditioning at random codes, and both carried across."""
    jcfg = jfield.FieldConfig(**TEACHER, compute_dtype=jnp.float32)
    tcfg = tfield.FieldConfig(**TEACHER, compute_dtype=torch.float32)
    jp = jfield.init_field_params(jax.random.PRNGKey(0), jcfg)
    jp["sigma"]["alpha"]["b"] = jp["sigma"]["alpha"]["b"] + 2.0
    rng = np.random.default_rng(1)
    codes = [rng.standard_normal(n).astype(np.float32) * s
             for n, s in ((50, 1.0), (30, 0.5), (256, 0.5))]
    jc = jfield.fold_conditioning(jp, *map(jnp.asarray, codes))
    tp = bridge.field_to_torch(_np(jp), tcfg, device="cpu")
    tc = bridge.to_torch(_np(jc), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jc=jc, tp=tp, tc=tc)


def _assert_state_close(ours, theirs):
    """A student state after a few steps against JAX's (see the docstring)."""
    _assert_tree_close(ours.params, theirs.params, rtol=0, atol=2e-5)
    for a, b in zip(tree_leaves(ours.opt_state.mu), jax.tree.leaves(theirs.opt_state[0].mu)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-12))


def _assert_tree_close(ours, theirs, rtol=1e-6, atol=0.0):
    a, b = tree_leaves(ours), jax.tree.leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y), rtol=rtol, atol=atol)


def point_draws(key, n):
    """The draws of JAX's `_sample_points(key, dcfg, n)`, by the port's names."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    n_ray = n // 2
    n_uni = n - n_ray
    arrs = {"pts_u": jax.random.uniform(k1, (n_uni, 3)),
            "dirs_u": jax.random.normal(k2, (n_uni, 3)),
            "o_dir": jax.random.normal(k3, (n_ray, 3)),
            "targets": jax.random.uniform(k4, (n_ray, 3)),
            "t": jax.random.uniform(k5, (n_ray,))}
    return {k: T(np.array(v)) for k, v in arrs.items()}


def exp_draws(key, n):
    """The draws of JAX's `_sample_exp_code(key, bank)` for a bank of n rows."""
    ki, kj, ka = jax.random.split(key, 3)
    return {"exp_i": int(jax.random.randint(ki, (), 0, n)),
            "exp_j": int(jax.random.randint(kj, (), 0, n)),
            "exp_a": T(np.array(jax.random.uniform(ka, (), minval=-0.25, maxval=1.25)))}


def start_from(monkeypatch, init):
    """Both packages' distillations start their student from the JAX tree
    `init` (each draws its own from a seed otherwise)."""
    monkeypatch.setattr(jd, "init_point_field",
                        lambda key, cfg: (jax.tree.map(jnp.asarray, init), None))
    monkeypatch.setattr(td, "init_point_field", lambda generator, cfg, device="cuda": (
        bridge.to_torch(_np(init), device="cpu"), None))


def step_key(seed, i, log_every):
    """The key of step i in JAX's loop of windows of `log_every` steps."""
    done = i - i % log_every
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed + 1), done), i - done)


# ----------------------------------------------------------------- init, Adam


@pytest.mark.parametrize("arch", ["mlp", "field"])
def test_student_config_init_and_warm_start_match_jax(arch, teacher, monkeypatch):
    jdc, tdc = _jdcfg(arch=arch), _tdcfg(arch=arch)
    jscfg, tscfg = jdc.student_config(teacher["jcfg"]), tdc.student_config(teacher["tcfg"])
    for f in ("depth", "width", "multires", "multires_views"):
        assert getattr(jscfg, f) == getattr(tscfg, f)
    assert type(tscfg).__name__ == type(jscfg).__name__
    jparams, jcond = jstudent.init_point_field(jax.random.PRNGKey(4), jscfg)
    tparams = bridge.to_torch(_np(jparams), device="cpu")
    # the field arch's folded zero-code conditioning, and its refold
    _, tcond = tstudent.init_point_field(torch.Generator().manual_seed(0), tscfg, device="cpu")
    assert (tcond is None) == (jcond is None) == (arch == "mlp")
    if arch == "field":
        _assert_tree_close(tstudent.refold_cond(tparams, tscfg), jcond)
    jstate, _ = jd.init_student(jax.random.PRNGKey(4), jscfg, 1e-3)
    monkeypatch.setattr(td, "init_point_field", lambda g, cfg, device: (tparams, None))
    tstate_, tx = td.init_student(None, tscfg, 1e-3, "cpu")
    _assert_tree_close(tstate_.params, jstate.params)
    if arch == "field":
        _assert_tree_close(tstate_.cond, jstate.cond)
    assert tx.lrate_decay is None and int(tstate_.step) == 0 and int(tstate_.opt_state.count) == 0
    # the warm start moved the density bias alone, and not the caller's tree
    sigma_b = tparams["sigma"]["b"] if arch == "mlp" else tparams["sigma"]["alpha"]["b"]
    got_b = (tstate_.params["sigma"]["b"] if arch == "mlp"
             else tstate_.params["sigma"]["alpha"]["b"])
    np.testing.assert_allclose(got_b.numpy(), sigma_b.numpy() + 0.5, rtol=1e-7)
    with pytest.raises(ValueError, match="arch='mlp'"):
        _tdcfg(arch="field", cond_dim=3).student_config(teacher["tcfg"])


def test_constant_rate_adam_matches_optax():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(4).astype(np.float32)]}
    tx = optax.adam(1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    jo = tx.init(jp)
    ours = tstate.Adam(lrate=1e-3, lrate_decay=None)
    tp = bridge.to_torch(params, device="cpu")
    to = ours.init(tp)
    for k in range(3):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 10.0 ** (k - 1)).astype(
            np.float32), params)
        upd, jo = tx.update(jax.tree.map(jnp.asarray, g), jo, jp)
        jp = optax.apply_updates(jp, upd)
        new_p, mu, nu, count = ours.update([T(x) for x in tree_leaves(g)], to, tree_leaves(tp))
        tp = {"a": new_p[0], "b": [new_p[1]]}
        to = tstate.AdamState(count, {"a": mu[0], "b": [mu[1]]}, {"a": nu[0], "b": [nu[1]]})
    assert int(to.count) == int(jo[0].count) == 3
    _assert_tree_close(tp, jp, rtol=1e-6)
    _assert_tree_close(to.mu, jo[0].mu, rtol=1e-6)
    _assert_tree_close(to.nu, jo[0].nu, rtol=1e-6)


# ------------------------------------------------------------------ sampling


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_points_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    jp, jdirs = jd._sample_points(key, _jdcfg(), BATCH)
    tp, tdirs = td._sample_points(_tdcfg(), BATCH, "cpu", draws=point_draws(key, BATCH))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tdirs.numpy(), np.asarray(jdirs), atol=1e-6)
    # the ray points come first and lie in the box
    assert (tp.abs() <= 3.0).all()
    # without draws the port draws from its generator
    g = torch.Generator().manual_seed(0)
    pts, dirs = td._sample_points(_tdcfg(), BATCH, "cpu", generator=g)
    assert pts.shape == (BATCH, 3) and torch.allclose(dirs.norm(dim=-1), torch.ones(BATCH))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_exp_code_matches_jax(seed):
    bank = np.random.default_rng(seed).standard_normal((5, 30)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jd._sample_exp_code(key, jnp.asarray(bank))
    got = td._sample_exp_code(T(bank), exp_draws(key, 5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    drawn = td._sample_exp_code(T(bank), generator=torch.Generator().manual_seed(seed))
    assert drawn.shape == (30,) and torch.isfinite(drawn).all()


# ------------------------------------------------------------- loss, gradient


@pytest.mark.parametrize("arch,activation", [("mlp", "relu"), ("mlp", "softplus"),
                                             ("field", "relu")])
def test_distill_loss_and_gradients_match_jax(arch, activation, teacher):
    jscfg = _jdcfg(arch=arch).student_config(teacher["jcfg"])
    tscfg = _tdcfg(arch=arch).student_config(teacher["tcfg"])
    jstate, _ = jd.init_student(jax.random.PRNGKey(5), jscfg)
    # half the student's raw density below zero, so that the dead-zone term counts
    head = jstate.params["sigma"] if arch == "mlp" else jstate.params["sigma"]["alpha"]
    head["b"] = head["b"] - 2.0
    tp = bridge.to_torch(_np(jstate.params), device="cpu")
    key = jax.random.PRNGKey(9)
    jpts, jdirs = jd._sample_points(key, _jdcfg(), BATCH)

    def jloss(p):
        return jd.distill_loss(p, jscfg, jstudent.refold_cond(p, jscfg), teacher["jp"],
                               teacher["jcfg"], teacher["jc"], jpts, jdirs, activation)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jstate.params)
    tt = td.pack_teacher(teacher["tp"], teacher["tcfg"], teacher["tc"])
    tpts, tdirs = T(np.asarray(jpts)), T(np.asarray(jdirs))
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    live = tree_unflatten(tp, leaves)
    tl, tm = td.distill_loss(live, tscfg, tstudent.refold_cond(live, tscfg), tt, tpts, tdirs,
                             activation)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("loss_rgb", "loss_sigma", "loss_dead"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5, atol=1e-8)
    assert float(jm["loss_dead"]) > 0   # the rescue term is exercised
    for a, b in zip(tg, jax.tree.leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * max(np.abs(b).max(), 1e-12))


def test_rebias_matches_a_full_pack(teacher):
    """The re-biased pack of one conditioning equals a full pack of it, leaf
    by leaf, also for a wgmma-design shape (bf16 at width 256: weight tiles)."""
    rng = np.random.default_rng(3)
    for cfg in (teacher["tcfg"], tfield.FieldConfig(depth=8, width=256,
                                                   compute_dtype=torch.bfloat16)):
        params = (teacher["tp"] if cfg.width == 64 else
                  tfield.init_field_params(torch.Generator().manual_seed(1), cfg, device="cpu"))

        def cond():
            codes = [T(rng.standard_normal(n).astype(np.float32)) for n in (50, 30, 256)]
            return tfield.fold_conditioning(params, *codes)

        base = fk.pack_fused_params(params, cond(), cfg)
        other = cond()
        got = fk.rebias_fused_params(base, other, cfg)
        want = fk.pack_fused_params(params, other, cfg)
        for name in fk.FusedParams._fields:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and a.is_contiguous(), name
            assert torch.equal(a, b), name
        # the weights are shared, not copied
        assert got.w_stack.data_ptr() == base.w_stack.data_ptr()
        assert got.w_tiles.data_ptr() == base.w_tiles.data_ptr()
        assert not torch.equal(base.b_stack, want.b_stack)


# ------------------------------------------------------------ the three loops


def _logged(text, tag):
    return [float(m) for m in re.findall(rf"\[{tag}\] step \d+/\d+ loss ([-0-9.]+)", text)]


def test_distill_three_steps_match_jax(teacher, monkeypatch):
    jdc, tdc = _jdcfg(n_steps=3), _tdcfg(n_steps=3)
    jscfg = jdc.student_config(teacher["jcfg"])
    tscfg = tdc.student_config(teacher["tcfg"])
    start_from(monkeypatch, jstudent.init_point_field(jax.random.PRNGKey(SEED), jscfg)[0])
    draws = lambda i: point_draws(step_key(SEED, i, 1), BATCH)   # noqa: E731

    # step by step, the port's distill_step beside JAX's
    js, jtx = jd.init_student(jax.random.PRNGKey(SEED), jscfg, jdc.lr)
    ts, ttx = td.init_student(None, tscfg, tdc.lr, "cpu")
    tt = td.pack_teacher(teacher["tp"], teacher["tcfg"], teacher["tc"])
    jstep = jax.jit(lambda s, k: jd.distill_step(s, jtx, teacher["jp"], teacher["jcfg"],
                                                 teacher["jc"], jdc, jscfg, k))
    for i in range(3):
        js, jm = jstep(js, step_key(SEED, i, 1))
        ts, tm = td.distill_step(ts, ttx, tt, tdc, tscfg, draws(i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_state_close(ts, js)
    assert int(ts.step) == 3 and int(ts.opt_state.count) == 3

    # the loops as a whole
    out = io.StringIO()
    with redirect_stdout(out):
        jstate_, _ = jd.distill(teacher["jp"], teacher["jcfg"], teacher["jc"], jdc, seed=SEED,
                                log_every=1)
        tstate_, got_cfg = td.distill(teacher["tp"], teacher["tcfg"], teacher["tc"], tdc,
                                      seed=SEED, log_every=1, draws=draws)
    assert got_cfg == tscfg
    _assert_state_close(tstate_, jstate_)
    logged = _logged(out.getvalue(), "DISTILL")
    # printed to 5 decimals: each line within its rounding and rtol 1e-5
    assert len(logged) == 6, out.getvalue()
    np.testing.assert_allclose(logged[3:], logged[:3], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="distill_expressions"):
        td.distill(teacher["tp"], teacher["tcfg"], teacher["tc"], _tdcfg(cond_dim=30))


@pytest.fixture(scope="module")
def model():
    """A small JAX model (fine = the teacher field; ISM; expression bank) and
    the port's copy of the parts distillation reads."""
    from mofanerf_tpu.render.renderer import MoFaNeRF
    jspec = MoFaNeRF(coarse=jfield.FieldConfig(**TEACHER, compute_dtype=jnp.float32),
                     fine=jfield.FieldConfig(**TEACHER, compute_dtype=jnp.float32))
    from mofanerf_tpu_torch.render.renderer import MoFaNeRF as TSpec
    tspec = TSpec(coarse=tfield.FieldConfig(**TEACHER, compute_dtype=torch.float32),
                  fine=tfield.FieldConfig(**TEACHER, compute_dtype=torch.float32))
    fine = jfield.init_field_params(jax.random.PRNGKey(11), jspec.fine)
    fine["sigma"]["alpha"]["b"] = fine["sigma"]["alpha"]["b"] + 2.0
    jm = {"fine": fine, "ism": jism.init_ism_params(jax.random.PRNGKey(12)),
          "exp_codes": jax.random.uniform(jax.random.PRNGKey(13), (21, 30))}
    tm = {"fine": bridge.field_to_torch(_np(fine), tspec.fine, device="cpu"),
          **bridge.serving_params_to_torch(_np(jm), device="cpu")}
    rng = np.random.default_rng(14)
    avatars = [(rng.standard_normal(50).astype(np.float32),
                rng.standard_normal(256).astype(np.float32) * 0.5) for _ in range(2)]
    return dict(jspec=jspec, tspec=tspec, jm=jm, tm=tm, avatars=avatars)


@pytest.mark.parametrize("kind", ["expressions", "avatars"])
def test_conditioned_distillation_three_steps_matches_jax(kind, model, monkeypatch):
    n_ids = 3
    exp_ids = [0, 5, 9]
    if kind == "expressions":
        cond_dim = 30
        shape, tex = model["avatars"][0]
    else:
        cond_dim = 80
    jdc, tdc = _jdcfg(n_steps=3, cond_dim=cond_dim), _tdcfg(n_steps=3, cond_dim=cond_dim)
    jscfg = jdc.student_config(model["jspec"].fine)
    init = jstudent.init_point_field(jax.random.PRNGKey(SEED), jscfg)[0]
    # give the trunk's code weights (zero at init) values, so that the code's
    # gradient path through every layer is compared too
    init["cond"]["w_layers"] = jax.random.normal(jax.random.PRNGKey(15),
                                                 init["cond"]["w_layers"].shape) * 0.05

    def draws(i):
        kc, kp = jax.random.split(step_key(SEED, i, 1))
        d = point_draws(kp, BATCH)
        if kind == "avatars":
            ka, kc = jax.random.split(kc)
            d["avatar"] = int(jax.random.randint(ka, (), 0, 2))
        d.update(exp_draws(kc, n_ids))
        return d

    start_from(monkeypatch, init)
    out = io.StringIO()
    with redirect_stdout(out):
        if kind == "expressions":
            jstate_, _ = jd.distill_expressions(
                model["jm"], model["jspec"], jnp.asarray(shape), jnp.asarray(tex), jdc,
                exp_ids=exp_ids, seed=SEED, log_every=1)
            tstate_, tscfg = td.distill_expressions(
                model["tm"], model["tspec"], T(shape), T(tex), tdc, exp_ids=exp_ids, seed=SEED,
                log_every=1, draws=draws)
            tag = "DISTILL-EXP"
        else:
            jstate_, _ = jd.distill_avatars(
                model["jm"], model["jspec"], [tuple(map(jnp.asarray, a)) for a in model["avatars"]],
                jdc, exp_ids=exp_ids, seed=SEED, log_every=1)
            tstate_, tscfg = td.distill_avatars(
                model["tm"], model["tspec"], [tuple(map(T, a)) for a in model["avatars"]], tdc,
                exp_ids=exp_ids, seed=SEED, log_every=1, draws=draws)
            tag = "DISTILL-AVATARS"
    assert tscfg.cond_dim == cond_dim
    _assert_state_close(tstate_, jstate_)
    logged = _logged(out.getvalue(), tag)
    # printed to 5 decimals: each line within its rounding and rtol 1e-5
    assert len(logged) == 6, out.getvalue()
    np.testing.assert_allclose(logged[3:], logged[:3], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="cond_dim"):
        td.distill_expressions(model["tm"], model["tspec"], T(model["avatars"][0][0]),
                               T(model["avatars"][0][1]), _tdcfg(cond_dim=5))

