"""The port's training loop (mofanerf_tpu_torch/train/loop.py) against the
JAX package's (mofanerf_tpu/train/loop.py), on the synthetic FaceScape
fixture at a small size (widths 64, 8 + 8 samples, multires 4, UV 128, 16
rays, f32).

- The slice as a whole: three iterations of the port's batch assembly
  (`make_batch`) and step against the JAX loop's body (its batch closure,
  restated here, and its jitted `train_step`), from one state carried across
  by the bridge and one np.random.Generator seed: identical coordinates,
  targets at atol 1e-6, losses at rtol 1e-4. The JAX step's uniforms are
  drawn from its key and injected (see tests/test_torch_train_state.py).
- `train()` on the CPU writes args.txt, config.txt, the log, the `.pt`
  checkpoints, the held-out PNG and the orbit PNGs, and resumes.
- Either data path resumes from a directory of the JAX package's Orbax
  steps only (refused, naming ROADMAP A3, before the port read them; the
  grid upkeep of `i_grid > 0` is tested in
  tests/test_torch_occupancy.py, the device-resident path in
  tests/test_torch_device_data.py)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu import config as jconfig
from mofanerf_tpu.data import facescape as jfs
from mofanerf_tpu.data.landmarks import TrainRaySampler as JSampler
from mofanerf_tpu.data.landmarks import anneal_lm_frac as janneal
from mofanerf_tpu.ops.rays import get_rays_at as jget_rays_at
from mofanerf_tpu.train import state as jstate
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch import config as tconfig
from mofanerf_tpu_torch.data import facescape as tfs
from mofanerf_tpu_torch.data.landmarks import TrainRaySampler
from mofanerf_tpu_torch.train import loop as tloop
from mofanerf_tpu_torch.train import state as tstate

SEED = 3
FLAGS = dict(netdepth=6, netwidth=64, netdepth_fine=6, netwidth_fine=64, multires=4,
             multires_views=2, N_rand=16, N_samples=8, N_importance=8, uv_size=128,
             precrop_iters=1, lm_frac_anneal_iters=2, compute_dtype="float32",
             packet_size=256, testskip=1, i_grid=0, person_num=2)


def _paths(d):
    return dict(datadir=str(d), uvdir=str(d / "uv"), shape_codes_path=str(d / "factors_id.npy"),
                landmarks_path=str(d / "landmarks.npy"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A JAX-written fixture, both configs, the JAX state and its jitted step."""
    d = tmp_path_factory.mktemp("fixture")
    jfs.make_synthetic_dataset(str(d), n_ids=2, n_train=3, n_test=1, hw=32, seed=1)
    jcfg = jconfig.Config(**FLAGS, **_paths(d))
    tcfg = tconfig.Config(**FLAGS, **_paths(d))
    jspec, tspec = jcfg.model_spec(), tcfg.model_spec()
    tx = jstate.make_optimizer(jcfg.lrate, jcfg.lrate_decay)
    js = jax.jit(lambda k: jstate.create_train_state(k, jspec, jcfg.lrate, jcfg.lrate_decay))(
        jax.random.PRNGKey(SEED))
    step = jax.jit(lambda s, b, k: jstate.train_step(s, b, k, jspec, tx))
    return dict(jcfg=jcfg, tcfg=tcfg, jspec=jspec, tspec=tspec, js=js, step=step)


def _dataset(mod, cfg):
    persons = mod.valid_persons(cfg.datadir, cfg.person_num)
    ds = mod.load_facescape_data(cfg.datadir, persons, mod.load_shape_codes(cfg.shape_codes_path),
                                 uvdir=cfg.uvdir, half_res=cfg.half_res, testskip=cfg.testskip)
    H, W, focal = ds.hwf
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)
    landmarks = np.load(cfg.landmarks_path) / 50.0
    return ds, K, landmarks


def jax_make_batch(i, cfg, spec, ds, K, sampler, rng, uv_cache):
    """The JAX loop's batch closure (mofanerf_tpu/train/loop.py, `make_batch`)."""
    img_i = int(rng.choice(ds.i_split[0]))
    pid = int(ds.id_codes[img_i])
    if pid not in uv_cache:
        uv_cache[pid] = jfs.read_image(ds.uv_paths[pid], is_uvmap=True, uv_size=spec.uv_size)
    target = jfs.read_image(ds.image_paths[img_i], half_res=cfg.half_res, white_bkgd=cfg.white_bkgd)
    pose = ds.poses[img_i]
    precrop = cfg.precrop_frac if i < cfg.precrop_iters else None
    coords = sampler.sample(rng, cfg.N_rand, K, pose, pid, int(ds.exp_types[img_i]),
                            precrop_frac=precrop, target_img=target,
                            lm_frac=janneal(i, cfg.lm_frac, cfg.lm_frac_anneal_iters))
    rays_o, rays_d = jget_rays_at(jnp.asarray(coords, jnp.float32), jnp.asarray(K),
                                  jnp.asarray(pose))
    batch = jstate.Batch(rays_o=rays_o, rays_d=rays_d,
                         target_rgb=jnp.asarray(target[coords[:, 0], coords[:, 1]]),
                         shape_code=jnp.asarray(ds.shape_codes[img_i]),
                         exp_type=jnp.asarray(int(ds.exp_types[img_i]), jnp.int32),
                         uv_map=jnp.asarray(uv_cache[pid]))
    return batch, coords


def jax_draws(key, n_rays, n_coarse, n_importance):
    k_strat, k_pdf, _, _ = jax.random.split(key, 4)
    return {"strat": torch.from_numpy(np.array(jax.random.uniform(k_strat, (n_rays, n_coarse)))),
            "pdf": torch.from_numpy(np.array(jax.random.uniform(k_pdf, (n_rays, n_importance))))}


def test_three_iterations_match_the_jax_loop_body(world):
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    jds, jK, jlm = _dataset(jfs, jcfg)
    tds, tK, tlm = _dataset(tfs, tcfg)
    np.testing.assert_array_equal(jK, tK)
    jsampler = JSampler(jlm, *jds.hwf[:2], lm_frac=jcfg.lm_frac)
    tsampler = TrainRaySampler(tlm, *tds.hwf[:2], lm_frac=tcfg.lm_frac)
    jrng, trng = np.random.default_rng(SEED + 1), np.random.default_rng(SEED + 1)
    juv, tuv = {}, {}
    js = world["js"]
    ts = bridge.train_state_to_torch(jax.tree.map(np.asarray, js), world["tspec"], device="cpu")
    tx = tstate.make_optimizer(tcfg.lrate, tcfg.lrate_decay)
    for i in range(3):
        jb, jcoords = jax_make_batch(i, jcfg, world["jspec"], jds, jK, jsampler, jrng, juv)
        tb = tloop.make_batch(i, tcfg, world["tspec"], tds, tK, tsampler, trng, tuv, "cpu")
        np.testing.assert_array_equal(tb.coords, jcoords)
        np.testing.assert_allclose(tb.target_rgb.numpy(), np.asarray(jb.target_rgb), atol=1e-6)
        np.testing.assert_allclose(tb.rays_d.numpy(), np.asarray(jb.rays_d), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tb.shape_code.numpy(), np.asarray(jb.shape_code))
        assert int(tb.exp_type) == int(jb.exp_type)
        np.testing.assert_allclose(tb.uv_map.numpy(), np.asarray(jb.uv_map), atol=1e-5)
        key = jax.random.PRNGKey(SEED * 1_000_003 + i)
        js, jm = world["step"](js, jb, key)
        ts, tm = tstate.train_step(ts, tb, None, world["tspec"], tx,
                                   draws=jax_draws(key, tcfg.N_rand, tcfg.N_samples,
                                                   tcfg.N_importance))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        assert bool(tm["step_ok"]) and int(ts.step) == int(js.step) == i + 1
        # iteration 0 draws from the centre crop (precrop_iters = 1), the others do not
        side = tds.hwf[0]
        in_crop = (np.abs(tb.coords - side // 2) <= side // 4).all()
        assert in_crop == (i == 0)


def test_train_writes_its_outputs_and_resumes(tmp_path):
    d = tmp_path / "data"
    tfs.make_synthetic_dataset(str(d), n_ids=2, n_train=2, n_test=1, hw=32)
    cfg_file = tmp_path / "exp.txt"
    cfg_file.write_text("expname = tiny\nN_rand = 16  # rays a step\n")
    flags = dict(FLAGS, N_rand=16)
    cfg = tconfig.load_config(
        ["--config", str(cfg_file), "--basedir", str(tmp_path / "logs")]
        + [f"--{k}={v}" for k, v in {**flags, **_paths(d), "i_print": 1, "i_weights": 2,
                                       "i_testset": 3, "i_video": 3, "render_factor": 8}.items()])
    state = tloop.train(cfg, n_iters=3, device="cpu")
    exp = tmp_path / "logs" / "tiny"
    assert int(state.step) == 3
    assert (exp / "config.txt").read_text() == cfg_file.read_text()
    assert "N_rand = 16" in (exp / "args.txt").read_text()
    assert sorted(os.listdir(exp / "checkpoints")) == ["000002.pt", "000003.pt"]
    assert len(os.listdir(exp / "testset_000003")) == 1
    assert len(os.listdir(exp / "video_000003")) == 40
    log = (exp / "train_log.txt").read_text()
    assert "FRESH run" in log and "Iteration 3" in log and "step_ok: 1" in log
    # a second run resumes from step 3
    again = tloop.train(cfg, n_iters=4, device="cpu")
    assert int(again.step) == 4
    log = (exp / "train_log.txt").read_text()
    assert "resumed from checkpoint at step 3" in log and "Iteration 4" in log
    assert "000004.pt" in os.listdir(exp / "checkpoints")


@pytest.mark.parametrize("flag,item", [({"device_data": False}, "ROADMAP A3"),
                                       ({"device_data": True}, "ROADMAP A3")])
def test_unported_options_raise_naming_the_roadmap_item(tmp_path, flag, item):
    """A checkpoint directory of the JAX package's Orbax steps only, on either
    data path: refused, naming `item`, until the port read Orbax steps; now
    the loop resumes from the JAX step and goes on writing `.pt` (the
    device-resident path, refused here until ROADMAP A5's port, trains too:
    tests/test_torch_device_data.py)."""
    from mofanerf_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

    d = tmp_path / "data"
    tfs.make_synthetic_dataset(str(d), n_ids=2, n_train=1, n_test=1, hw=16)
    cfg = tconfig.Config(**{**FLAGS, **flag, **_paths(d), "basedir": str(tmp_path)})
    ckpts = tmp_path / cfg.expname / "checkpoints"
    jspec = jconfig.Config(**FLAGS, **_paths(d)).model_spec()
    jax_state = jstate.create_train_state(jax.random.PRNGKey(3), jspec)
    jax_save_checkpoint(str(ckpts), jax_state._replace(step=jnp.int32(100)), 100)
    state = tloop.train(cfg, n_iters=101, device="cpu")
    log = (tmp_path / cfg.expname / "train_log.txt").read_text()
    assert int(state.step) == 101 and "resumed from checkpoint at step 100" in log
    assert item not in log and "000101.pt" in os.listdir(ckpts)
