"""The port's fitting loop (mofanerf_tpu_torch/train/fit_loop.py) against
the JAX package's (mofanerf_tpu/train/fit_loop.py) on the CPU at a small
size (depth 8, width 64, the least the field kernel renders, 8 + 8 samples,
multires 4 as in tests/test_torch_fit.py): a 16 x 16 target, 16 rays a step,
a compressed pyramid schedule.

- `fit` end to end from JAX's initial codes (injected) and the same seed: the
  same pixel coordinates every step (bit for bit), each step's loss within
  2e-3 of JAX's (free runs; tests/test_torch_fit.py holds each step sharply),
  the same files, and each package's `load_fit_codes` reads the other's
  `fit_params.npz`;
- a resume from the port's own checkpoint continues the counts and moments;
  one from a JAX checkpoint (codes only) warns and restarts them;
- the render modes: frames equal `render_fit_frame` of the same codes, PNGs
  within one 8-bit level of JAX's."""
import os

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from mofanerf_tpu.models import field as jfield
from mofanerf_tpu.ops.rays import pose_spherical
from mofanerf_tpu.render import renderer as jr
from mofanerf_tpu.train import fit as jfit
from mofanerf_tpu.train import fit_loop as jloop
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.render import renderer as tr
from mofanerf_tpu_torch.train import fit as tfit
from mofanerf_tpu_torch.train import fit_loop as tloop

SIDE = 16
CFG = dict(n_iters=12, n_rand=16, H=SIDE, W=SIDE, focal=20.0, change_epoch=(0, 3, 6, 9, 11),
           ckpt_every=5, preview_every=10)


@pytest.fixture(scope="module")
def model():
    fkw = dict(depth=8, width=64, multires=4)   # the field kernel renders widths of 64k
    rkw = dict(n_coarse=8, n_importance=8)
    jspec = jr.MoFaNeRF(coarse=jfield.FieldConfig(**fkw), fine=jfield.FieldConfig(**fkw),
                        render=jr.RenderConfig(**rkw), uv_size=128)
    tspec = tr.MoFaNeRF(coarse=tfield.FieldConfig(**fkw), fine=tfield.FieldConfig(**fkw),
                        render=tr.RenderConfig(**rkw), uv_size=128)
    jp = jr.init_model_params(jax.random.PRNGKey(4), jspec)
    tp = bridge.model_params_to_torch(jax.tree.map(np.asarray, jp), tspec, device="cpu")
    return jspec, tspec, jp, tp


def _target():
    target = np.full((SIDE, SIDE, 3), 0.4, np.float32)
    target[4:12, 4:12] = 0.8
    target[:, :2] = 0.0   # a black border the sampler drops
    return target


def _kp2d():
    return np.random.default_rng(2).uniform(4, 12, (68, 2))


class _Recording:
    """A FitRaySampler subclass factory that keeps every batch of coordinates."""

    def __init__(self, base):
        self.coords = []
        rec = self

        class Sampler(base):
            def sample(self, *a, **kw):
                out = super().sample(*a, **kw)
                rec.coords.append(out.copy())
                return out

        self.cls = Sampler


class _JaxWithRecordedSteps:
    """Stands in for the `jax` module in mofanerf_tpu.train.fit_loop: `jax.jit`
    of the fit step records each step's loss, everything else is jax's."""

    def __init__(self, losses):
        self.losses = losses

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def run(*args):
            out = jitted(*args)
            self.losses.append(float(out[1]))
            return out

        return run


def test_fit_matches_jax_end_to_end(model, tmp_path, monkeypatch):
    jspec, tspec, jp, tp = model
    pose = pose_spherical(0.0, 0.0, 16.0)
    jcfg, tcfg = jfit.FitConfig(**CFG), tfit.FitConfig(**CFG)
    jrec, trec = _Recording(jloop.FitRaySampler), _Recording(tloop.FitRaySampler)
    monkeypatch.setattr(jloop, "FitRaySampler", jrec.cls)
    monkeypatch.setattr(tloop, "FitRaySampler", trec.cls)
    jlosses, tlosses = [], []
    monkeypatch.setattr(jloop, "jax", _JaxWithRecordedSteps(jlosses))
    step = tloop.fit_step

    def recorded(*args, **kw):
        out = step(*args, **kw)
        tlosses.append(float(out[1]))
        return out

    monkeypatch.setattr(tloop, "fit_step", recorded)

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jstate = jloop.fit(jp, jspec, _target(), pose, _kp2d(), str(jdir), jcfg, seed=0)
    init = jfit.init_fit_state(jax.random.PRNGKey(0), jcfg, pose).codes
    tstate = tloop.fit(tp, tspec, _target(), pose, _kp2d(), str(tdir), tcfg, seed=0,
                       init_codes=tfit.FitCodes(*[torch.tensor(np.asarray(c)) for c in init]))

    n = CFG["n_iters"] + 1
    assert len(trec.coords) == len(jrec.coords) == n
    for i, (a, b) in enumerate(zip(trec.coords, jrec.coords)):
        np.testing.assert_array_equal(a, b, err_msg=f"coordinates of step {i}")
    assert len(tlosses) == len(jlosses) == n
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-3)
    assert int(tstate.step) == int(jstate.step) == n
    assert sorted(os.listdir(tdir)) == ["fit_00010.png", "fit_final.png", "fit_params.npz",
                                        "fit_params.npz" + tloop.OPT_SUFFIX, "target.png"]
    assert {"fit_00010.png", "fit_final.png", "fit_params.npz", "target.png"} <= set(
        os.listdir(jdir))
    np.testing.assert_array_equal(imageio.imread(tdir / "target.png"),
                                  imageio.imread(jdir / "target.png"))

    # each package reads the other's fit_params.npz
    codes, n_read = tloop.load_fit_codes(str(jdir / "fit_params.npz"), device="cpu")
    assert n_read == n
    for name, c, w in zip(tfit.FitCodes._fields, codes, jstate.codes):
        np.testing.assert_array_equal(c.numpy(), np.asarray(w), err_msg=name)
    jcodes, n_read = jloop.load_fit_codes(str(tdir / "fit_params.npz"))
    assert n_read == n
    for name, c, w in zip(tfit.FitCodes._fields, tstate.codes, jcodes):
        np.testing.assert_array_equal(c.numpy(), np.asarray(w), err_msg=name)


def test_fit_resumes_its_optimizer_state(model, tmp_path, capsys):
    """A resume from the port's checkpoint continues the step, the groups'
    counts and moments; from codes alone (a JAX checkpoint) it warns and
    restarts them."""
    _, tspec, _, tp = model
    pose = pose_spherical(0.0, 0.0, 16.0)
    cfg = tfit.FitConfig(**dict(CFG, n_iters=3, ckpt_every=100))
    first = tloop.fit(tp, tspec, _target(), pose, _kp2d(), str(tmp_path), cfg, seed=1)
    saved = tloop.load_fit_opt_state(str(tmp_path / "fit_params.npz"), first.opt_state)
    for group in tfit.FIT_GROUPS:
        assert int(saved[group].count) == 4
        for name, mu in first.opt_state[group].mu.items():
            assert torch.equal(saved[group].mu[name], mu)
    again = tloop.fit(tp, tspec, _target(), pose, _kp2d(), str(tmp_path), cfg, seed=1,
                      resume=True)
    assert int(again.step) == 8 and int(again.opt_state["tex"].count) == 8
    assert "WARNING" not in capsys.readouterr().out

    os.remove(tmp_path / ("fit_params.npz" + tloop.OPT_SUFFIX))
    restarted = tloop.fit(tp, tspec, _target(), pose, _kp2d(), str(tmp_path), cfg, seed=1,
                          resume=True)
    assert "resuming without optimizer state" in capsys.readouterr().out
    assert int(restarted.step) == 12 and int(restarted.opt_state["tex"].count) == 4


def test_render_modes_match_jax(model, tmp_path):
    """`rendering` and `rendering_modulation` from the same codes: the port's
    frames are render_fit_frame's, its PNGs within one 8-bit level of JAX's."""
    jspec, tspec, jp, tp = model
    cfg = jfit.FitConfig(**CFG)
    rng = np.random.default_rng(3)
    jcodes = jfit.init_fit_state(jax.random.PRNGKey(2), cfg, pose_spherical(5.0, 0, 16.0)).codes
    jcodes = jcodes._replace(light=np.asarray([1.2, 1.0], np.float32))
    tcodes = tfit.FitCodes(*[torch.tensor(np.asarray(c)) for c in jcodes])
    presets = {"shape": rng.normal(0, 1, (2, 50)).astype(np.float32),
               "texture": rng.normal(0, 0.1, (1, 1, 256)).astype(np.float32)}
    tcfg = tfit.FitConfig(**CFG)

    novel = tloop.render_novel_views(tp, tspec, tcodes, str(tmp_path / "t"), tcfg)
    mod = tloop.render_modulation(tp, tspec, tcodes, str(tmp_path / "t"), tp["exp_codes"],
                                  presets=presets, cfg=tcfg)
    jloop.render_novel_views(jp, jspec, jcodes, str(tmp_path / "j"), cfg)
    jloop.render_modulation(jp, jspec, jcodes, str(tmp_path / "j"), jp["exp_codes"],
                            presets=presets, cfg=cfg)
    assert sorted(novel) == ["novel_yaw+000.png", "novel_yaw+060.png", "novel_yaw-060.png"]
    assert sorted(mod) == sorted([f"exp_{e:02d}.png" for e in tloop.MODULATION_EXPRESSIONS]
                                 + ["shape_preset_0.png", "shape_preset_1.png",
                                    "texture_preset_0.png"])
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "j"):
        a = imageio.imread(tmp_path / "t" / name).astype(int)
        b = imageio.imread(tmp_path / "j" / name).astype(int)
        assert a.shape == b.shape == (SIDE // 2, SIDE // 2, 3)
        assert np.abs(a - b).max() <= 1, name
    # a frame is render_fit_frame's of the same codes at the preview camera
    K = np.array([[10.0, 0, 4.0], [0, 10.0, 4.0], [0, 0, 1]], np.float32)
    want = tfit.render_fit_frame(tp, tspec, tcodes._replace(exp=tp["exp_codes"][9]), 8, 8, K)
    np.testing.assert_array_equal(mod["exp_09.png"], want["rgb"].numpy())
    view = tcodes._replace(pose=torch.from_numpy(pose_spherical(60.0, 0.0, 16.0)))
    np.testing.assert_array_equal(novel["novel_yaw+060.png"],
                                  tfit.render_fit_frame(tp, tspec, view, 8, 8, K)["rgb"].numpy())
