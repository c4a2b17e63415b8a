"""The run_render CLI's routes (mofanerf_tpu_torch/cli/run_render.py) on the
CPU at a tiny size: fields 6 x 64 (4 + 4 samples, f32, UV 128), 16 x 16
frames, a two-identity fixture, a seeded teacher (no checkpoint).

- `--distill`, `--distill_cond` (a two-expression rig) and `--distill_avatars
  0,1` each distil a student (4 steps), save it with its provenance, and a
  second call serves it from the file with the same frames; an expression-
  conditioned artifact also serves a single `--expression`, and an avatar
  artifact its own ids with no flag;
- every provenance and cond_dim refusal of the student route;
- the render settings come from the config on every route: `--white_bkgd
  True` renders the teacher on white (the difference to black is 1 - acc of
  the same render), and an artifact without provenance served with `--far
  20` renders exactly as render_frame_serve at far 20, on white with
  `--white_bkgd True`."""
import os
import re

import numpy as np
import pytest
import torch

from mofanerf_tpu_torch.cli import run_render
from mofanerf_tpu_torch.config import load_config
from mofanerf_tpu_torch.data.facescape import make_synthetic_dataset, read_image
from mofanerf_tpu_torch.models.student import StudentConfig, init_student_params
from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame)
from mofanerf_tpu_torch.render.serve import render_frame_serve
from mofanerf_tpu_torch.train.checkpoint import save_checkpoint
from mofanerf_tpu_torch.train.distill import load_student, save_student
from mofanerf_tpu_torch.train.state import create_train_state

CONFIG = ["--netdepth", "6", "--netwidth", "64", "--netdepth_fine", "6", "--netwidth_fine", "64",
          "--N_samples", "4", "--N_importance", "4", "--compute_dtype", "float32",
          "--uv_size", "128", "--device", "cpu"]
# the CLI's camera at --render_factor 32: 16 x 16 frames
K16 = np.array([[1200.0 / 32, 0, 8.0], [0, 1200.0 / 32, 8.0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    data = d / "data"
    make_synthetic_dataset(str(data), n_ids=2, n_train=1, n_test=1, hw=16)
    config = CONFIG + ["--expname", "smoke", "--basedir", str(d / "logs"), "--datadir", str(data),
                       "--uvdir", str(data / "uv"),
                       "--shape_codes_path", str(data / "factors_id.npy")]
    return dict(dir=d, config=config)


def _argv(world, name, *extra):
    return (["--out_dir", str(world["dir"] / name), "--n_views", "2", "--render_factor", "32",
             "--n_samples", "8", "--distill_steps", "4"] + list(extra) + world["config"])


ROUTES = {
    "distill": (["--distill"], 0, "DISTILL"),
    "rig": (["--distill_cond", "--rig_expressions", "0,1"], 30, "DISTILL-EXP"),
    "avatars": (["--distill_avatars", "0,1"], 80, "DISTILL-AVATARS"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_distill_routes_save_and_serve_from_the_file(route, world, capsys):
    flags, cond_dim, tag = ROUTES[route]
    path = str(world["dir"] / f"{route}.npz")
    argv = _argv(world, route, *flags, "--student_path", path, "--person", "1")
    frames = run_render.main(argv)
    out = capsys.readouterr().out
    assert frames.shape == (2, 16, 16, 3) and np.isfinite(frames).all()
    assert frames.min() >= 0.0 and frames.max() <= 1.0
    losses = [float(v) for v in re.findall(rf"\[{tag}\] step \d+/4 loss ([0-9.]+)", out)]
    assert len(losses) == 4 and np.isfinite(losses).all(), out
    assert re.search(r"distilled 4 steps in [0-9.]+ s", out) and "saved student artifact" in out
    params, scfg, prov = load_student(path, with_provenance=True, device="cpu")
    assert scfg.cond_dim == cond_dim and prov["n_steps"] == 4
    assert prov["near"] == 8.0 and prov["far"] == 26.0 and prov["aabb_min"] == [-5.0] * 3
    assert prov["expression"] == 0
    if route == "avatars":
        assert prov["avatar_ids"] == [0, 1] and "person" not in prov
    else:
        assert prov["person"] == 1 and "avatar_ids" not in prov
    # a second call serves the saved artifact: no distillation, the same frames
    again = run_render.main(argv)
    out = capsys.readouterr().out
    assert "loaded student artifact" in out and "distilled" not in out
    np.testing.assert_array_equal(again, frames)


def test_conditioned_artifacts_serve_their_codes(world, capsys):
    rig = str(world["dir"] / "rig2.npz")
    run_render.main(_argv(world, "rig2", "--distill_cond", "--student_path", rig))
    # the same student renders a single --expression (its code from the bank) without
    # a rig flag, and that frame differs from the rig's first (expression 9)
    single = run_render.main(_argv(world, "single", "--student_path", rig, "--expression", "3"))
    rigged = run_render.main(_argv(world, "rig2", "--distill_cond", "--student_path", rig))
    assert np.isfinite(single).all() and np.abs(single[0] - rigged[0]).max() > 0
    # an avatar artifact carries its ids: --student_path alone morphs between them
    av = str(world["dir"] / "av2.npz")
    morph = run_render.main(_argv(world, "av2", "--distill_avatars", "0,1", "--student_path", av))
    capsys.readouterr()
    served = run_render.main(_argv(world, "av3", "--student_path", av))
    assert "avatar ids from artifact: [0, 1]" in capsys.readouterr().out
    np.testing.assert_array_equal(served, morph)


def test_student_route_refusals(world):
    plain = str(world["dir"] / "plain.npz")
    run_render.main(_argv(world, "plain", "--distill", "--student_path", plain))
    rig = str(world["dir"] / "rig3.npz")
    run_render.main(_argv(world, "rig3", "--distill_cond", "--student_path", rig))
    av = str(world["dir"] / "av4.npz")
    run_render.main(_argv(world, "av4", "--distill_avatars", "0,1", "--student_path", av))
    cases = [
        (["--student_path", plain, "--person", "1"], "distilled for person 0"),
        (["--student_path", plain, "--expression", "2"], "distilled at expression 0"),
        (["--student_path", plain, "--distill_cond"], "needs an expression-conditioned student"),
        (["--student_path", rig, "--distill_avatars", "0,1"], r"needs a \[shape ; exp\]"),
        (["--student_path", av, "--distill_avatars", "1,0"], r"covers avatars \[0, 1\]"),
        (["--distill_avatars", " , "], "parses to an empty list"),
        (["--distill_cond", "--rig_expressions", ",", "--student_path", rig],
         "parses to an empty list"),
        (["--student_path", str(world["dir"] / "none.npz")], "no student artifact"),
    ]
    for extra, match in cases:
        with pytest.raises(SystemExit, match=match):
            run_render.main(_argv(world, "refused", *extra))
    # an avatar-conditioned artifact without its ids matches no route
    cfg = StudentConfig(depth=1, width=32, multires=10, cond_dim=80, compute_dtype=torch.float32)
    bare = str(world["dir"] / "bare80.npz")
    save_student(bare, init_student_params(torch.Generator().manual_seed(0), cfg, device="cpu"),
                 cfg)
    with pytest.raises(SystemExit, match="matches neither"):
        run_render.main(_argv(world, "refused", "--student_path", bare))
    # an expression-conditioned student takes any --expression
    frames = run_render.main(_argv(world, "ok", "--student_path", rig, "--expression", "5"))
    assert np.isfinite(frames).all()


def test_teacher_route_reads_white_bkgd_from_the_config(world):
    # a checkpoint whose density leaves part of the frame see-through (a seeded
    # field is fog): alpha heads x 3, shifted down by 10
    spec = load_config(world["config"]).model_spec()
    state = create_train_state(torch.Generator().manual_seed(5), spec, device="cpu")
    for name in ("coarse", "fine"):
        alpha = state.params[name]["sigma"]["alpha"]
        alpha["w"], alpha["b"] = alpha["w"] * 3.0, alpha["b"] - 10.0
    ckpt = str(world["dir"] / "white_ckpt")
    save_checkpoint(ckpt, state, 1)
    black = run_render.main(_argv(world, "black", "--ckpt_dir", ckpt))
    white = run_render.main(_argv(world, "white", "--ckpt_dir", ckpt, "--white_bkgd", "True"))
    # the same render: rgb on white = rgb on black + (1 - acc)
    config = dict(zip(world["config"][::2], world["config"][1::2]))
    shape = torch.from_numpy(np.load(config["--shape_codes_path"])[0].astype(np.float32))
    uv = read_image(os.path.join(config["--uvdir"], "0", "1_neutral.jpg"), is_uvmap=True,
                    uv_size=spec.uv_size)
    with torch.no_grad():
        tex = encode_texture(state.params, spec, torch.from_numpy(uv))
    cond = prepare_conditioning(state.params, spec, shape, exp_code_for(state.params, 0), tex)
    pose = pose_spherical(-180.0, 0.0, 16.0)[:3]
    acc = render_frame(state.params, spec, cond, 16, 16, K16, pose)["acc"].numpy()
    assert acc.min() < 0.9 and acc.max() > 0.1   # both background and density in view
    np.testing.assert_allclose(white[0] - black[0], np.repeat((1.0 - acc)[..., None], 3, -1),
                               atol=1e-5)


def test_student_route_reads_far_and_background_from_the_config(world):
    cfg = StudentConfig(depth=2, width=64, multires=6, compute_dtype=torch.float32)
    params = init_student_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    params["sigma"]["b"] = params["sigma"]["b"] + 1.5
    path = str(world["dir"] / "noprov.npz")
    save_student(path, params, cfg)   # no provenance: the config's bounds apply
    pose = pose_spherical(-180.0, 0.0, 16.0)[:3]

    def want(far, white):
        return render_frame_serve(params, cfg, None, 16, 16, K16, pose, near=8.0, far=far,
                                  n_samples=8, packet_size=256, hit_fraction=1.0,
                                  white_bkgd=white)["rgb"].numpy()

    got = run_render.main(_argv(world, "far", "--student_path", path, "--far", "20"))
    np.testing.assert_allclose(got[0], want(20.0, False), atol=1e-6)
    assert np.abs(want(20.0, False) - want(26.0, False)).max() > 1e-3
    got = run_render.main(_argv(world, "far", "--student_path", path, "--far", "20",
                                "--white_bkgd", "True"))
    np.testing.assert_allclose(got[0], want(20.0, True), atol=1e-6)
