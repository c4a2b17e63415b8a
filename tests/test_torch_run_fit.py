"""The fitting CLI of the port (mofanerf_tpu_torch/cli/run_fit.py) on the CPU
at a tiny size: fields 6 x 64 (4 + 4 samples, multires 4, f32, UV 128), 32
rays a step, a 32 x 32 photo (the fit's pyramid resizes it to the 512-pixel
levels), a port checkpoint of seeded weights.

- `--renderType fitting` writes the target, the codes, the optimiser state
  and the final preview; `rendering` and `rendering_modulation` read the codes
  and write the novel views (each equal to `render_fit_frame` of the codes)
  and the re-rigged frames with the preset swaps; `--is_load_par` resumes;
- the default device is the card: without one the CLI raises;
- a directory of the JAX package's Orbax steps only (refused, naming ROADMAP
  A3, before the port read them) is read: a step of another tree is refused
  naming what differs, a TrainState of the model is fitted against."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mofanerf_tpu_torch.cli import run_fit
from mofanerf_tpu_torch.config import load_config
from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.train.checkpoint import load_model, save_checkpoint
from mofanerf_tpu_torch.train.fit import FitConfig, render_fit_frame
from mofanerf_tpu_torch.train.fit_loop import MODULATION_EXPRESSIONS, load_fit_codes
from mofanerf_tpu_torch.train.state import create_train_state
from mofanerf_tpu_torch.utils.image_io import imread, write_png

CONFIG = ["--netdepth", "6", "--netwidth", "64", "--netdepth_fine", "6", "--netwidth_fine", "64",
          "--N_samples", "4", "--N_importance", "4", "--multires", "4", "--N_rand", "32",
          "--compute_dtype", "float32", "--uv_size", "128"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("fitcli")
    rng = np.random.default_rng(0)
    os.makedirs(d / "data" / "segRelRes")
    photo = d / "data" / "segRelRes" / "face.png"
    write_png(str(photo), rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    np.save(d / "data" / "pose_face.npy",
            {"pose": pose_spherical(5.0, -3.0, 16.0), "kp": rng.uniform(200, 312, (68, 2))},
            allow_pickle=True)
    np.save(d / "presets.npy", {"shape": rng.normal(0, 1, (1, 50)).astype(np.float32),
                                "texture": rng.normal(0, 0.1, (2, 1, 256)).astype(np.float32)},
            allow_pickle=True)
    spec = load_config(CONFIG).model_spec()
    save_checkpoint(str(d / "ckpt"), create_train_state(torch.Generator().manual_seed(1), spec,
                                                        device="cpu"), 7)
    argv = ["--filePath", str(photo), "--ckpt_dir", str(d / "ckpt"), "--device", "cpu",
            "--num_iterations", "3", "--pose_freeze_iters", "2"] + CONFIG
    return dict(dir=d, argv=argv, out=d / "data" / "fitting" / "segRelRes_face", spec=spec)


def test_run_fit_all_render_types(world, capsys):
    out, argv = world["out"], world["argv"]
    state = run_fit.main(argv + ["--renderType", "fitting"])
    assert "loaded model checkpoint" in capsys.readouterr().out
    assert int(state.step) == 4
    assert sorted(os.listdir(out)) == ["fit_final.png", "fit_params.npz", "fit_params.npz.opt.pt",
                                       "target.png"]
    assert imread(str(out / "fit_final.png")).shape == (256, 256, 3)
    codes, step = load_fit_codes(str(out / "fit_params.npz"), device="cpu")
    assert step == 4 and torch.equal(codes.tex, state.codes.tex)

    views = run_fit.main(argv + ["--renderType", "rendering"])
    params, _ = load_model(str(world["dir"] / "ckpt"), world["spec"], "cpu")
    K = np.array([[600.0, 0, 128.0], [0, 600.0, 128.0], [0, 0, 1]], np.float32)
    for yaw in (-60, 0, 60):
        name = f"novel_yaw{yaw:+04d}.png"
        view = codes._replace(pose=torch.from_numpy(pose_spherical(float(yaw), 0.0, 16.0)))
        want = render_fit_frame(params, world["spec"], view, 256, 256, K)["rgb"].numpy()
        np.testing.assert_array_equal(views[name], want)
        assert (out / name).exists()

    frames = run_fit.main(argv + ["--renderType", "rendering_modulation", "--predef_par",
                                  str(world["dir"] / "presets.npy")])
    want = sorted([f"exp_{e:02d}.png" for e in MODULATION_EXPRESSIONS]
                  + ["shape_preset_0.png", "texture_preset_0.png", "texture_preset_1.png"])
    assert sorted(frames) == want and all((out / n).exists() for n in want)
    assert all(f.shape == (256, 256, 3) and np.isfinite(f).all() for f in frames.values())
    assert np.abs(frames["exp_09.png"] - frames["exp_14.png"]).max() > 0

    resumed = run_fit.main(argv + ["--renderType", "fitting", "--is_load_par"])
    assert int(resumed.step) == 8 and int(resumed.opt_state["pose_light"].count) == 8


def test_run_fit_defaults_to_the_card(world):
    argv = [a for a in world["argv"] if a not in ("--device", "cpu")]
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fit.main(argv)


def test_run_fit_refuses_orbax_only_checkpoints(world, tmp_path, capsys):
    import jax

    from mofanerf_tpu.config import load_config as jax_load_config
    from mofanerf_tpu.train.state import create_train_state as jax_create_train_state

    jax_save_checkpoint(str(tmp_path / "other"), {"w": jnp.ones(3)}, 10)
    argv = world["argv"] + ["--ckpt_dir", str(tmp_path / "other")]
    with pytest.raises(ValueError, match="does not hold this model's state"):
        run_fit.main(argv)
    jspec = jax_load_config(CONFIG).model_spec()
    jax_save_checkpoint(str(tmp_path / "model"),
                        jax_create_train_state(jax.random.PRNGKey(5), jspec), 20)
    state = run_fit.main(world["argv"] + ["--ckpt_dir", str(tmp_path / "model"),
                                          "--num_iterations", "1"])
    assert "(step 20)" in capsys.readouterr().out and int(state.step) == 2


def test_fit_config_defaults_are_the_references():
    cfg = FitConfig()
    assert (cfg.n_iters, cfg.n_rand, cfg.lr, cfg.lr_shape, cfg.focal, cfg.change_epoch) == (
        2000, 1024, 2e-3, 4e-3, 1200.0, (0, 600, 1000, 1300, 1500))
