"""The flagship chain of mofanerf_tpu_torch/examples against the JAX package's
scripts (examples/*.py), on the CPU.

One tiny face family made once by the JAX package's `make_face_dataset` (2
identities x 2 expressions, 32x32, every sixth view, 4 held out an
expression), and one small-tier JAX TrainState (morphable_flagship --small:
2x16 + 2x32 f32, 8 + 8 samples, UV maps of 512) written as an Orbax step by
the JAX package's `save_checkpoint`; its params are drawn with numpy into the
tree of `create_train_state` (`tests/test_torch_examples.py::_seeded_state`:
JAX's own init of this spec compiles for ~24 s on the CPU). The port reads
that step through its own Orbax reader. On it:

- both packages' `morphable_flagship --stage eval --small --white_bkgd`: every
  dB reading of the two JSONs (held out, cross-identity, interpolation against
  the rasterized intermediate faces, expression control, the expression
  matrix) within 0.02 dB, every SSIM within 1e-3, the mean opaque depth within
  1e-2, each curtain fraction (a count of pixels whose opacity passes 0.5 and
  whose depth falls short of the head box, mean of 2 views of 1024 pixels)
  within 4 pixels' share: the seeded field is fog, and its maps, which agree
  within 1e-4, put many pixels within 1e-4 of those thresholds; and the frames
  they score, rendered by each package's render_frame (f32) from the same
  codes: the maps the evaluation reads (rgb, acc, depth; depth relatively)
  within 1e-4 on 99% of the pixels and within 1e-3 (depth 5e-3) on all, the
  coarse pass's rgb0 and acc0 within 1e-4 on 95% and 2e-3 on all. Not 1e-4 on
  every pixel: the fields embed points with 10 bands, sin(2^9 x) at |x| up to
  ~16, where one ulp of the argument is ~1e-4 rad and the two libraries' sines
  round differently; the coarse pass's 8 samples turn that into up to ~1.4e-3
  of opacity at a few pixels (tests/test_torch_renderer.py holds the renderer
  itself at 4 bands, 1e-4 on every pixel);
- `serve_flagship`'s probed serving box (build_proposal_grid + grid_aabb over
  the identities), equal;
- `fit_quality`'s numpy-drawn initial pose and its projected landmarks, equal
  to the JAX script's lines (written out here);
- `refine_nerf_corpus`'s corpus: the JAX and the port's
  `render_refine_trainset` on the same step, the same files and manifest, the
  PNGs within one level of 255.
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.config import Config as JaxConfig
from mofanerf_tpu.datagen.synthetic_faces import face_landmarks as jax_face_landmarks
from mofanerf_tpu.datagen.synthetic_faces import make_face_dataset as jax_make_face_dataset
from mofanerf_tpu.train.checkpoint import save_checkpoint as jax_save
from mofanerf_tpu_torch.examples import _flagship, fit_quality, morphable_flagship
from mofanerf_tpu_torch.examples import serve_flagship
from mofanerf_tpu_torch.render.renderer import render_frame
from mofanerf_tpu_torch.utils.image_io import imread
from tests.test_torch_examples import _seeded_state

REPO = Path(__file__).resolve().parents[1]
EXPNAME = "flag"
SMALL = dict(netdepth=2, netwidth=16, netdepth_fine=2, netwidth_fine=32, N_samples=8,
             N_importance=8, compute_dtype="float32", packet_size=1024)


def jax_script(name):
    """The JAX package's examples/<name>.py as a module (its main() reads sys.argv)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name, argv):
    saved = sys.argv
    sys.argv = [f"{name}.py"] + list(argv)
    try:
        jax_script(name).main()
    finally:
        sys.argv = saved


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """(data dir, run dir) of the tiny face family and the small model's Orbax step."""
    root = tmp_path_factory.mktemp("flagship")
    data = root / "faces"
    jax_make_face_dataset(str(data), n_ids=2, exp_ids=(0, 1), res=32, view_stride=6,
                          n_holdout=4, n_lat=16, n_lon=24)
    from mofanerf_tpu.train import state as js

    jspec = JaxConfig(person_num=2, white_bkgd=True, **SMALL).model_spec()
    state = _seeded_state(jspec, js.make_optimizer(), seed=0)
    # the coarse density shifted down: 2% of the proposal grid's cells occupied, so that
    # the probed serving box is not the whole default box
    params = jax.tree.map(lambda x: x, state.params)
    params["coarse"]["sigma"]["alpha"]["b"] = jnp.full((1,), -5.0, jnp.float32)
    state = js.TrainState(params, state.opt_state, state.step)
    jax_save(str(root / "logs" / EXPNAME / "checkpoints"), state, 7)
    return data, root / "logs"


@pytest.fixture(scope="module")
def models(family):
    """The step restored by each package: (port cfg, spec, params, Faces), (JAX spec, params)."""
    from mofanerf_tpu.train import state as js
    from mofanerf_tpu.train.checkpoint import restore_checkpoint as jax_restore

    data, base = family
    args = argparse.Namespace(data=str(data), basedir=str(base), expname=EXPNAME, n_ids=2,
                              aabb_source="probe")
    cfg = _flagship.data_config(args, white_bkgd=True, **SMALL)
    spec = cfg.model_spec()
    cpu = torch.device("cpu")
    params, step = _flagship.restore(cfg, spec, cpu, required=True)
    assert step == 7
    fc = _flagship.Faces(cfg, params, spec, range(2), cpu)
    jspec = JaxConfig(person_num=2, white_bkgd=True, **SMALL).model_spec()
    jp = jax_restore(str(base / EXPNAME / "checkpoints"),
                     _seeded_state(jspec, js.make_optimizer(), seed=1)).params
    return (args, cfg, spec, params, fc), (jspec, jp)


def _model_flags(family):
    data, base = family
    return ["--data", str(data), "--basedir", str(base), "--expname", EXPNAME, "--n_ids", "2"]


@pytest.fixture(scope="module")
def evals(family, tmp_path_factory):
    """Both packages' evaluation JSONs of the step (expression matrix of 1 identity)."""
    out = tmp_path_factory.mktemp("evals")
    flags = _model_flags(family) + ["--stage", "eval", "--small", "--white_bkgd",
                                    "--n_test_views", "2", "--exp_matrix_ids", "1"]
    run_jax("morphable_flagship", flags + ["--out_json", str(out / "jax" / "m.json")])
    morphable_flagship.main(flags + ["--out_json", str(out / "port" / "m.json"),
                                     "--device", "cpu"])
    return tuple(json.load(open(out / k / "m.json")) for k in ("jax", "port"))


def test_eval_readings_match_jax(evals):
    j, t = evals
    assert set(t) == set(j) | {"device"}
    assert t["model"] == j["model"] and t["dataset"] == j["dataset"]
    assert t["recipe"] == j["recipe"]
    assert set(t["per_identity"]) == set(j["per_identity"])
    for pid, a in j["per_identity"].items():
        b = t["per_identity"][pid]
        assert b["n_views"] == a["n_views"]
        assert abs(b["psnr"] - a["psnr"]) < 0.02 and abs(b["ssim"] - a["ssim"]) < 1e-3, pid
        assert abs(b["curtain_fraction"] - a["curtain_fraction"]) <= 4.01 / 1024, pid
        assert abs(b["mean_opaque_depth"] - a["mean_opaque_depth"]) < 1e-2, pid
    for a, b in zip(j["cross_identity"], t["cross_identity"], strict=True):
        assert (a["own_id"], a["other_id"]) == (b["own_id"], b["other_id"])
        assert abs(a["cross_psnr"] - b["cross_psnr"]) < 0.02
    for a, b in zip(j["identity_interpolation"], t["identity_interpolation"], strict=True):
        assert a["t"] == b["t"]
        assert abs(a["psnr_vs_gt_interp"] - b["psnr_vs_gt_interp"]) < 0.02, a["t"]
        assert abs(a["ssim_vs_gt_interp"] - b["ssim_vs_gt_interp"]) < 1e-3, a["t"]
    for a, b in zip(j["expression_control"], t["expression_control"], strict=True):
        assert (a["exp"], a["n_views"]) == (b["exp"], b["n_views"])
        assert abs(a["own_exp_psnr"] - b["own_exp_psnr"]) < 0.02
        assert abs(a["wrong_exp_psnr"] - b["wrong_exp_psnr"]) < 0.02
    for a, b in zip(j["expression_transfer_matrix"], t["expression_transfer_matrix"],
                    strict=True):
        assert a["id"] == b["id"] and set(a["per_exp"]) == set(b["per_exp"])
        for e, r in a["per_exp"].items():
            assert abs(r["psnr"] - b["per_exp"][e]["psnr"]) < 0.02, e
            assert abs(r["ssim"] - b["per_exp"][e]["ssim"]) < 1e-3, e


def test_eval_frames_match_jax(family, models):
    """The frames the evaluation scores: both packages' render_frame of the step at three
    held-out views of identity 0 (its own codes and that view's expression)."""
    from mofanerf_tpu.render import renderer as jr

    (_, _, spec, params, fc), (jspec, jp) = models
    jtex = jr.encode_texture(jp, jspec, jnp.asarray(fc.uv(0).numpy()))
    np.testing.assert_allclose(fc.tex(0).numpy(), np.asarray(jtex), atol=1e-4)
    views = fc.test_idx[0]
    assert len(views) >= 3
    for i in views[:3]:
        exp = int(fc.ds.exp_types[i])
        jc = jr.prepare_conditioning(jp, jspec, jnp.asarray(fc.codes[0]),
                                     jr.exp_code_for(jp, exp), jtex)
        want = jr.render_frame(jp, jspec, jc, fc.H, fc.W, jnp.asarray(fc.K),
                               jnp.asarray(fc.ds.poses[i][:3]))
        # the same texture code on both sides: the encoders' f32 sums (a 512^2 UV map)
        # differ by up to 1e-4, held above
        cond = fc.cond_of(fc.codes[0], exp, torch.from_numpy(np.asarray(jtex)))
        got = render_frame(params, spec, cond, fc.H, fc.W, fc.K, fc.pose(i))
        for k, share, worst in (("rgb", 0.99, 1e-3), ("acc", 0.99, 1e-3), ("depth", 0.99, 5e-3),
                                ("rgb0", 0.95, 2e-3), ("acc0", 0.95, 2e-3)):
            err = np.abs(got[k].numpy() - np.asarray(want[k]))
            if k == "depth":   # scene units: relative
                err = err / (1.0 + 10 * np.abs(np.asarray(want[k])))
            assert np.quantile(err, share) <= 1e-4 and err.max() <= worst, (i, k, err.max())


def test_serve_probed_box_matches_jax(models):
    """serve_flagship's serving box (`--aabb_source probe`): the union over identities of
    the boxes of build_proposal_grid at the bank's first expression, as the JAX script
    probes it."""
    from mofanerf_tpu.ops import occupancy as jocc
    from mofanerf_tpu.render import renderer as jr

    (args, cfg, spec, params, fc), (jspec, jp) = models
    box = serve_flagship.serving_box(args, cfg, spec, params, fc, [0, 1], 7)
    lo_u = hi_u = None
    for pid in (0, 1):
        tex = jr.encode_texture(jp, jspec, jnp.asarray(fc.uv(pid).numpy()))
        c = jr.prepare_conditioning(jp, jspec, jnp.asarray(fc.codes[pid]),
                                    jr.exp_code_for(jp, fc.exp_bank[0]), tex)
        lo_p, hi_p = jocc.grid_aabb(jocc.build_proposal_grid(jp, jspec, c))
        lo_u = lo_p if lo_u is None else np.minimum(lo_u, lo_p)
        hi_u = hi_p if hi_u is None else np.maximum(hi_u, hi_p)
    assert box == (tuple(float(v) for v in lo_u), tuple(float(v) for v in hi_u))
    assert box != ((-5.0,) * 3, (5.0,) * 3)   # the grid is partly occupied


def test_fit_quality_draws_match_the_jax_script(family):
    """fit_quality's initial pose (np.random.default_rng(3)) and the identity's landmarks
    through (K, pose): the JAX script's lines, written out here."""
    data, _ = family
    pose_true = np.eye(4, dtype=np.float32)
    pose_true[:3, :3] = np.array([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]])
    pose_true[:3, 3] = [9.6, 0.5, 12.8]
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)

    rng = np.random.default_rng(3)
    ang = np.deg2rad(6.0)
    rx, ry = rng.uniform(-ang, ang, 2)

    def rot_y(a):
        return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])

    def rot_x(a):
        return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])

    want = pose_true.copy()
    want[:3, :3] = rot_y(ry) @ rot_x(rx) @ pose_true[:3, :3]
    want[:3, 3] = pose_true[:3, 3] + rng.uniform(-0.4, 0.4, 3)
    got = fit_quality.perturbed_pose(pose_true, 6.0)
    assert got.dtype == want.dtype and np.array_equal(got, want)

    p = np.load(data / "face_params.npy")[1]
    lm3 = jax_face_landmarks(p, 1)
    Rt, t = pose_true[:3, :3], pose_true[:3, 3]
    pc = (lm3 - t) @ Rt
    z = -pc[:, 2]
    kp_want = np.stack([K[1, 2] - K[1, 1] * pc[:, 1] / z, K[0, 2] + K[0, 0] * pc[:, 0] / z], -1)
    from mofanerf_tpu_torch.datagen.synthetic_faces import face_landmarks

    np.testing.assert_array_equal(face_landmarks(p, 1), lm3)
    np.testing.assert_array_equal(fit_quality.project_kp(face_landmarks(p, 1), K, pose_true),
                                  kp_want)
    assert fit_quality.rot_err_deg(want, pose_true) == pytest.approx(
        float(np.rad2deg(np.arccos(np.clip(
            (np.trace(want[:3, :3] @ pose_true[:3, :3].T) - 1) / 2, -1, 1)))), abs=0)


def test_refine_corpus_renders_match_jax(family, tmp_path):
    """refine_nerf_corpus's step 1: both packages' render_refine_trainset on the step, with
    the script's config flags: the same files, manifest and draws, the renders within one
    level."""
    from mofanerf_tpu.cli.render_refine_trainset import main as jax_render
    from mofanerf_tpu_torch.cli.render_refine_trainset import main as port_render
    from mofanerf_tpu_torch.examples import refine_nerf_corpus

    data, base = family
    args = argparse.Namespace(data=str(data), basedir=str(base), expname=EXPNAME, n_ids=2,
                              white_bkgd=True, near=8.0, far=26.0, small_model=False)
    flags = refine_nerf_corpus.config_flags(args)
    for k, v in SMALL.items():
        flags += [f"--{k}", str(v)]
    common = ["--exp_num", "2", "--view_num", "2", "--res", "24"]
    jax_render(["--out_dir", str(tmp_path / "jax")] + common + flags)
    port_render(["--out_dir", str(tmp_path / "port"), "--device", "cpu"] + common + flags)
    mj = json.load(open(tmp_path / "jax" / "gt_manifest.json"))
    mt = json.load(open(tmp_path / "port" / "gt_manifest.json"))
    assert mj == mt and len(mj) == 8
    for rel in mj:
        a = imread(str(tmp_path / "jax" / rel)).astype(int)
        b = imread(str(tmp_path / "port" / rel)).astype(int)
        assert a.shape == b.shape == (24, 24, 3) and np.abs(a - b).max() <= 1, rel
