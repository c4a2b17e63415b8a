"""The student field, its code fold, the ISM and the student conditioning
codes: port against the JAX package on the same weights (via the bridge)
and the same numpy inputs. f32 to 1e-4; bf16 to 2e-2, since the two
frameworks round bf16 products at different places."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.models import ism as jism
from mofanerf_tpu.models import student as jstudent
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import ism, student
from mofanerf_tpu_torch.render.renderer import exp_code_for
from mofanerf_tpu_torch.train import distill

jax_distill = importlib.import_module("mofanerf_tpu.train.distill")
jrenderer = importlib.import_module("mofanerf_tpu.render.renderer")

T = torch.from_numpy
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(dtype, seed=0, **kw):
    jdt, tdt = DTYPES[dtype]
    jcfg = jstudent.StudentConfig(compute_dtype=jdt, **kw)
    tcfg = student.StudentConfig(compute_dtype=tdt, **kw)
    jp = jstudent.init_student_params(jax.random.PRNGKey(seed), jcfg)
    if "cond" in jp:   # nonzero trunk injections so the fold is exercised
        jp["cond"]["w_layers"] = jax.random.normal(
            jax.random.PRNGKey(seed + 1), jp["cond"]["w_layers"].shape) * 0.1
    jp = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), bridge.student_to_torch(jp, tcfg, "cpu")


def _inputs(cfg, n_rays=24, spr=8, seed=0):
    rng = np.random.default_rng(seed)
    pe = rng.uniform(-1, 1, (n_rays * spr, cfg.pts_embed_dim)).astype(np.float32)
    dirf = (rng.standard_normal((n_rays, cfg.width // 2)) * 0.3).astype(np.float32)
    return pe, dirf


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [-1, 2])
def test_apply_student(dtype, skip):
    jcfg, tcfg, jp, tp = _pair(dtype, depth=4, width=64, multires=6, skip=skip)
    pe, dirf = _inputs(tcfg)
    jr, js = jstudent.apply_student(jp, jnp.asarray(pe), jnp.asarray(dirf), jcfg,
                                    samples_per_ray=8)
    tr, ts = student.apply_student(tp, T(pe), T(dirf), tcfg, samples_per_ray=8)
    assert tr.dtype == DTYPES[dtype][1] and tr.shape == (24 * 8, 3) and ts.shape == (24 * 8, 1)
    tol = TOL[dtype]
    np.testing.assert_allclose(tr.float().numpy(), np.asarray(jr, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(ts.float().numpy(), np.asarray(js, np.float32), rtol=tol, atol=tol)


def test_apply_student_per_point_dirs():
    jcfg, tcfg, jp, tp = _pair("float32", depth=2, width=32, multires=4)
    pe, _ = _inputs(tcfg, n_rays=10, spr=1)
    dirf = np.random.default_rng(1).standard_normal((10, 16)).astype(np.float32)
    jr, js = jstudent.apply_student(jp, jnp.asarray(pe), jnp.asarray(dirf), jcfg)
    tr, ts = student.apply_student(tp, T(pe), T(dirf), tcfg)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)


def test_fold_student_code_and_point_apply():
    jcfg, tcfg, jp, tp = _pair("float32", depth=3, width=32, multires=4, cond_dim=6)
    code = np.random.default_rng(2).standard_normal(6).astype(np.float32)
    jf = jstudent.fold_student_code(jp, jnp.asarray(code))
    tf = student.fold_student_code(tp, T(code))
    assert "cond" not in tf and set(tf) == set(jf)
    for (k, a), (_, b) in zip(bridge.flatten_with_keystr(jax.tree.map(np.asarray, jf)),
                              bridge.flatten_with_keystr(tf)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-6, err_msg=k)
    # an unconditioned student folds to itself
    assert student.fold_student_code(tf, T(code)) is tf
    # point_apply folds the code on the fly
    pe, dirf = _inputs(tcfg, n_rays=6, spr=4)
    jr, js = jstudent.point_apply(jp, jnp.asarray(code), jnp.asarray(pe), jnp.asarray(dirf),
                                  jcfg, samples_per_ray=4)
    tr, ts = student.point_apply(tp, T(code), T(pe), T(dirf), tcfg, samples_per_ray=4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)


def test_field_config_waits_for_the_next_slice():
    """The wait is over: `student.FieldConfig` is the real config of the
    conditioned field and `point_apply` dispatches it to apply_field_folded,
    as the JAX package's does (f32, sum order only: 1e-5)."""
    from mofanerf_tpu.models import field as jfield
    from mofanerf_tpu_torch.models import field as tfield

    assert student.FieldConfig is tfield.FieldConfig
    kw = dict(depth=8, width=32)
    jcfg, tcfg = jfield.FieldConfig(**kw), student.FieldConfig(**kw)
    jp = jax.tree.map(np.asarray, jfield.init_field_params(jax.random.PRNGKey(0), jcfg))
    tp = bridge.field_to_torch(jp, tcfg, device="cpu")
    rng = np.random.default_rng(1)
    codes = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (50, 30, 256)]
    jcond = jfield.fold_conditioning(jax.tree.map(jnp.asarray, jp), *map(jnp.asarray, codes))
    tcond = tfield.fold_conditioning(tp, *map(T, codes))
    pe = rng.standard_normal((12, tcfg.pts_embed_dim)).astype(np.float32)
    dirf = rng.standard_normal((3, 16)).astype(np.float32) * 0.1
    jr, js = jstudent.point_apply(jax.tree.map(jnp.asarray, jp), jcond, jnp.asarray(pe),
                                  jnp.asarray(dirf), jcfg, samples_per_ray=4)
    tr, ts = student.point_apply(tp, tcond, T(pe), T(dirf), tcfg, samples_per_ray=4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def _model(seed=3):
    jp = {"ism": jism.init_ism_params(jax.random.PRNGKey(seed)),
          "exp_codes": jax.random.uniform(jax.random.PRNGKey(seed + 1),
                                          (jrenderer.N_EXP_SLOTS, 30))}
    jp = jax.tree.map(np.asarray, jp)
    return jax.tree.map(jnp.asarray, jp), bridge.serving_params_to_torch(jp, device="cpu")


def test_modulate_expression():
    jm, tm = _model()
    shape = np.random.default_rng(4).standard_normal(50).astype(np.float32)
    for e in (0, 7, 20):
        jexp = jrenderer.exp_code_for(jm, e)
        texp = exp_code_for(tm, e)
        np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
        want = jism.modulate_expression(jm["ism"], jnp.asarray(shape), jexp)
        got = ism.modulate_expression(tm["ism"], T(shape), texp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    scale, bias = ism.apply_ism(tm["ism"], T(shape))
    assert scale.shape == bias.shape == (30,)


def test_student_code_and_avatar_code():
    jm, tm = _model(seed=5)
    rng = np.random.default_rng(6)
    shape = rng.standard_normal(50).astype(np.float32)
    mix = 0.3
    jraw = (1 - mix) * jrenderer.exp_code_for(jm, 2) + mix * jrenderer.exp_code_for(jm, 9)
    traw = (1 - mix) * exp_code_for(tm, 2) + mix * exp_code_for(tm, 9)
    want = jax_distill.student_code(jm, jnp.asarray(shape), jraw)
    got = distill.student_code(tm, T(shape), traw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    want = jax_distill.avatar_code(jm, jnp.asarray(shape), jraw)
    got = distill.avatar_code(tm, T(shape), traw)
    assert got.shape == (80,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_init_bounds_follow_the_jax_init():
    """Same layout, same per-leaf bounds: torch draws every leaf inside the
    JAX init's uniform bound, and the trunk injections start at zero."""
    cfg = student.StudentConfig(depth=2, width=32, multires=4, cond_dim=5)
    tp = student.init_student_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    pe = cfg.pts_embed_dim
    a_in = np.sqrt(2.0) * np.sqrt(6.0 / (pe + 5 + 32))
    assert float(tp["input"]["w"].abs().max()) <= a_in
    assert float(tp["input"]["b"].abs().max()) <= 1 / np.sqrt(pe + 5)
    assert float(tp["cond"]["w_in"].abs().max()) <= a_in
    assert float(tp["cond"]["w_layers"].abs().max()) == 0.0
    a = ism.init_ism_params(torch.Generator().manual_seed(2), device="cpu")
    assert a["layers"][0]["w"].shape == (50, 256) and a["scale"]["w"].shape == (256, 30)
