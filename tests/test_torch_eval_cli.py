"""The evaluation and grid-export CLIs of the port
(mofanerf_tpu_torch/cli/{evaluate,export_grids}.py) against the JAX
package's, on the same params: a seeded JAX train state saved as an Orbax
checkpoint for the JAX CLIs and, carried across by the bridge, as a `.pt`
for the port's; a two-identity fixture of 16 x 16 frames
(`make_synthetic_dataset`); fields 6 x 64, 4 + 4 samples, f32, UV 128.

- evaluate, plain, with `--render_factor 2` and with `--fast`: each view's
  PSNR within 0.01 dB and SSIM within 1e-3 of JAX's (the deterministic
  render's importance sampler puts its last sample on one of two bin edges on
  opaque rays, by the last bit of a cumulative sum, in either package: see
  tests/test_torch_renderer.py), the same metrics.json keys, finite values;
- export_grids for 2 identities x 2 expressions: each grid's bits equal to
  JAX's (a cell could differ only where its density lies within rounding of
  the threshold; none does here), and each package's `load_exported_grid`
  reads the other's file."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from mofanerf_tpu.cli import evaluate as jevaluate
from mofanerf_tpu.cli import export_grids as jexport
from mofanerf_tpu.config import load_config as jload_config
from mofanerf_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from mofanerf_tpu.train.state import create_train_state as jcreate_train_state
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.cli import evaluate, export_grids
from mofanerf_tpu_torch.config import load_config
from mofanerf_tpu_torch.data.facescape import make_synthetic_dataset
from mofanerf_tpu_torch.ops.occupancy import render_frame_fast
from mofanerf_tpu_torch.train.checkpoint import save_checkpoint

CONFIG = ["--netdepth", "6", "--netwidth", "64", "--netdepth_fine", "6", "--netwidth_fine", "64",
          "--N_samples", "4", "--N_importance", "4", "--compute_dtype", "float32",
          "--uv_size", "128"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("evalcli")
    data = d / "data"
    make_synthetic_dataset(str(data), n_ids=2, n_train=1, n_test=2, hw=16)
    config = CONFIG + ["--datadir", str(data), "--uvdir", str(data / "uv"), "--person_num", "2",
                       "--shape_codes_path", str(data / "factors_id.npy")]
    jspec = jload_config(config).model_spec()
    jstate = jcreate_train_state(jax.random.PRNGKey(3), jspec)
    jsave_checkpoint(str(d / "jax_ckpt"), jstate, 1)
    tstate = bridge.train_state_to_torch(jax.tree.map(np.asarray, jstate),
                                         load_config(config).model_spec(), device="cpu")
    save_checkpoint(str(d / "pt_ckpt"), tstate, 1)
    return dict(dir=d, config=config)


class _Recorder:
    """Stands in for `ssim` in the JAX CLI: keeps each view's (render, truth)."""

    def __init__(self, ssim):
        self.ssim, self.pairs = ssim, []

    def __call__(self, a, b):
        self.pairs.append((np.asarray(a), np.asarray(b)))
        return self.ssim(a, b)


@pytest.mark.parametrize("flags", [[], ["--render_factor", "2"], ["--fast"]],
                         ids=["plain", "render_factor2", "fast"])
def test_evaluate_matches_jax(world, monkeypatch, flags):
    d, name = world["dir"], "-".join(flags) or "plain"
    rec = _Recorder(jevaluate.ssim)
    monkeypatch.setattr(jevaluate, "ssim", rec)
    jevaluate.main(["--ckpt_dir", str(d / "jax_ckpt"), "--out_dir", str(d / f"j{name}")] + flags
                   + world["config"])
    got = evaluate.main(["--ckpt_dir", str(d / "pt_ckpt"), "--out_dir", str(d / f"t{name}"),
                         "--device", "cpu"] + flags + world["config"])
    assert got["n_views"] == len(rec.pairs) == 2   # one view an identity at testskip 8
    for i, (rgb, gt) in enumerate(rec.pairs):
        psnr = -10 * np.log10(max(float(np.mean((rgb - gt) ** 2)), 1e-10))
        assert abs(got["psnr"][i] - psnr) < 1e-2, (i, got["psnr"][i], psnr)
        assert abs(got["ssim"][i] - rec.ssim(rgb, gt)) < 1e-3, i
    want = json.load(open(d / f"j{name}" / "metrics.json"))
    have = json.load(open(d / f"t{name}" / "metrics.json"))
    assert set(have) == set(want) == {"n_views", "psnr_mean", "ssim_mean", "psnr_std"}
    assert all(np.isfinite(v) for v in have.values())
    assert sorted(os.listdir(d / f"t{name}")) == sorted(os.listdir(d / f"j{name}"))
    side = 16 // (2 if "--render_factor" in flags else 1)
    assert rec.pairs[0][0].shape == (side, side, 3)


def test_export_grids_match_jax_and_load_across(world):
    d = world["dir"]
    argv = ["--expressions", "0,3", "--resolution", "16", "--threshold", "0.5"] + world["config"]
    jexport.main(["--out", str(d / "jgrids.npz"), "--ckpt_dir", str(d / "jax_ckpt")] + argv)
    shares = export_grids.main(["--out", str(d / "tgrids.npz"), "--ckpt_dir",
                                str(d / "pt_ckpt"), "--device", "cpu"] + argv)
    keys = {f"occ_{p}_{e}" for p in (0, 1) for e in (0, 3)}
    assert set(shares) == keys
    with np.load(d / "jgrids.npz") as j, np.load(d / "tgrids.npz") as t:
        assert set(t.files) == set(j.files) == keys | {"resolution", "aabb_min", "aabb_max"}
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for pid, exp in ((0, 0), (1, 3)):
        mine = export_grids.load_exported_grid(str(d / "jgrids.npz"), pid, exp, device="cpu")
        theirs = jexport.load_exported_grid(str(d / "tgrids.npz"), pid, exp)
        np.testing.assert_array_equal(mine.occ.numpy(), np.asarray(theirs.occ))
        np.testing.assert_array_equal(mine.aabb_min.numpy(), np.asarray(theirs.aabb_min))
        assert mine.occ.shape == (16, 16, 16) and mine.occ.dtype == torch.bool
    assert 0.0 < np.mean(list(shares.values())) < 1.0


def test_exported_grid_renders_fast(world):
    """A grid loaded back renders a frame through render_frame_fast."""
    d = world["dir"]
    export_grids.main(["--out", str(d / "one.npz"), "--ckpt_dir", str(d / "pt_ckpt"),
                       "--max_persons", "1", "--device", "cpu"] + world["config"])
    grid = export_grids.load_exported_grid(str(d / "one.npz"), 0, 0, device="cpu")
    from mofanerf_tpu_torch.render.renderer import exp_code_for, prepare_conditioning
    from mofanerf_tpu_torch.train.checkpoint import load_model
    spec = load_config(world["config"]).model_spec()
    params, step = load_model(str(d / "pt_ckpt"), spec, "cpu")
    assert step == 1
    with torch.no_grad():
        cond = prepare_conditioning(params, spec, torch.zeros(50), exp_code_for(params, 0),
                                    torch.zeros(256))
    K = np.array([[37.5, 0, 8.0], [0, 37.5, 8.0], [0, 0, 1]], np.float32)
    from mofanerf_tpu.ops.rays import pose_spherical
    out = render_frame_fast(params, spec, cond.fine, grid, 16, 16, K,
                            pose_spherical(0.0, 0.0, 16.0)[:3])
    assert out["rgb"].shape == (16, 16, 3) and bool(torch.isfinite(out["rgb"]).all())


def test_clis_refuse_without_a_checkpoint(world, tmp_path):
    for main, extra in ((evaluate.main, []), (export_grids.main, ["--out", str(tmp_path / "g")])):
        with pytest.raises(SystemExit, match="no checkpoint"):
            main(["--ckpt_dir", str(tmp_path / "none"), "--device", "cpu"] + extra
                 + world["config"])
