"""The port's device-resident data path (mofanerf_tpu_torch/data/device_data.py
and train/loop.py's `_train_device_data`) against the JAX package's, on the
synthetic FaceScape fixture at 24 x 24.

- `build_device_dataset` in every bias mode (auto with and without
  landmarks, fg from an RGBA alpha at half resolution, expdelta, none, an
  unknown mode that falls back to uniform, expdelta reservoirs left
  unfilled at pixel (0, 0)): every array bit-equal, the same mode, but for
  what goes through the area resize, which sums in f64 where cv2 sums in
  f32: the UV maps (atol 1e-6) and the half-resolution images (one level).
- `sample_batch_device` with the JAX sampler's own draws injected (split
  into k_img, k_box, k_pick, k_jit, k_mask as it splits them): coordinates
  equal, rays and targets within 1e-6, in the precrop, the anneal and after
  it, for each bias.
- `_auto_scan_steps` against JAX's; `train(device_data=True)` on the CPU
  checkpoints on the JAX loop's steps for a scan_steps that divides no
  interval, keeps its grid and resumes.
"""
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu import config as jconfig
from mofanerf_tpu.data import device_data as jdd
from mofanerf_tpu.data import facescape as jfs
from mofanerf_tpu.train import loop as jloop
from mofanerf_tpu.train import state as jstate
from mofanerf_tpu_torch import config as tconfig
from mofanerf_tpu_torch.data import device_data as tdd
from mofanerf_tpu_torch.data import facescape as tfs
from mofanerf_tpu_torch.train import loop as tloop
from mofanerf_tpu_torch.train.checkpoint import latest_step

HW = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the suite runs
    several workers on the machine's cores, and torch's default of a thread a
    core makes them spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("dd")
    jfs.make_synthetic_dataset(str(d), n_ids=2, n_train=3, n_test=1, hw=HW)
    # an RGBA frame with a transparent background for the alpha mask
    rgba = np.zeros((HW, HW, 4), np.uint8)
    rgba[6:18, 5:17] = (200, 100, 50, 255)
    rgba[8:10, 8:12, 3] = 128
    imageio.imwrite(str(d / "rgba.png"), rgba)
    lms = np.random.default_rng(4).uniform(-1, 1, (2, 20, 68, 3)).astype(np.float32)
    out = {}
    for name, mod in (("jax", jfs), ("torch", tfs)):
        ds = mod.load_facescape_data(str(d), [0, 1], mod.load_shape_codes(
            str(d / "factors_id.npy")), uvdir=str(d / "uv"), testskip=1)
        ds.image_paths = list(ds.image_paths)
        ds.image_paths[int(ds.i_split[0][1])] = str(d / "rgba.png")
        out[name] = ds
    H, W, focal = out["torch"].hwf
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)
    return d, out, K, lms


def _same_pose_pairs(ds):
    """The train split's frames with their poses shared across expressions,
    so that expdelta finds siblings: frame k takes frame 0's pose of its id."""
    import copy

    ds = copy.copy(ds)
    ds.poses = ds.poses.copy()
    idx = ds.i_split[0]
    for i in idx:
        first = [j for j in idx if ds.id_codes[j] == ds.id_codes[i]][0]
        ds.poses[i] = ds.poses[first]
    return ds


BUILDS = {
    "auto_landmarks": dict(landmarks=True),
    "auto_fg": dict(),
    "fg_half_res": dict(bias_override="fg", half_res=True),
    "fg_white_alpha": dict(bias_override="fg", white_bkgd=True),
    "fg_white_no_alpha": dict(bias_override="fg", white_bkgd=True, indices=[0, 2]),
    "expdelta": dict(bias_override="expdelta", same_pose=True),
    "expdelta_unfilled": dict(bias_override="expdelta"),
    "none": dict(bias_override="none", landmarks=True),
    "unknown": dict(bias_override="bogus", landmarks=True),
}


def _build(mod, ds, K, lms, kw, device=None):
    kw = dict(kw)
    if kw.pop("same_pose", False):
        ds = _same_pose_pairs(ds)
    idx = np.asarray(ds.i_split[0])
    if "indices" in kw:
        idx = idx[kw.pop("indices")]
    if kw.pop("landmarks", False):
        kw["landmarks"] = lms
    extra = {} if device is None else {"device": device}
    return mod.build_device_dataset(ds, K, idx, uv_size=32, fg_reservoir=64, seed=5, **kw,
                                    **extra)


@pytest.mark.parametrize("mode", list(BUILDS))
def test_build_device_dataset_matches_jax(fixture, mode):
    _, dss, K, lms = fixture
    jd, jbias = _build(jdd, dss["jax"], K, lms, BUILDS[mode])
    td, tbias = _build(tdd, dss["torch"], K, lms, BUILDS[mode], device="cpu")
    assert tbias == jbias
    for name in jdd.DeviceDataset._fields:
        a, b = getattr(td, name).numpy(), np.asarray(getattr(jd, name))
        assert a.dtype == b.dtype, name
        if name == "uv_maps":   # the area resize sums in f64, cv2's in f32
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)
        elif name == "images" and BUILDS[mode].get("half_res"):
            # the same f64-against-f32 sums, rounded to uint8: ties may round apart
            np.testing.assert_allclose(a.astype(int), b.astype(int), rtol=0, atol=1,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    if mode == "expdelta":
        assert tbias == "fg"
    if mode == "expdelta_unfilled":
        # no frame has a same-pose sibling: the reservoirs stay at pixel (0, 0)
        assert tbias == "none" and not td.fg_pixels.any()
    if mode == "unknown":
        assert tbias == "bogus"
    if mode == "fg_white_no_alpha":
        assert tbias == "none"
    assert tdd.resident_bytes(td) == sum(np.asarray(x).nbytes for x in jd)


def test_landmarks_bias_needs_landmarks(fixture):
    _, dss, K, _ = fixture
    with pytest.raises(ValueError, match="no landmarks"):
        tdd.build_device_dataset(dss["torch"], K, dss["torch"].i_split[0], uv_size=32,
                                 bias_override="landmarks", device="cpu")


def _jax_draws(key, n, n_images, n_pick):
    """The draws of mofanerf_tpu/data/device_data.py::sample_batch_device."""
    k_img, k_box, k_pick, k_jit, k_mask = jax.random.split(key, 5)
    t = lambda x: torch.from_numpy(np.array(x))
    return {"img": t(jax.random.randint(k_img, (), 0, n_images)),
            "box": t(jax.random.uniform(k_box, (n, 2))),
            "pick": t(jax.random.randint(k_pick, (n,), 0, n_pick)),
            "jit": t(jax.random.normal(k_jit, (n, 2))),
            "mask": t(jax.random.uniform(k_mask, (n,)))}


@pytest.mark.parametrize("mode", ["auto_landmarks", "auto_fg", "none", "unknown"])
@pytest.mark.parametrize("i", [2, 6, 40])
def test_sample_batch_with_jax_draws_matches(fixture, monkeypatch, mode, i):
    """precrop_iters 4, anneal over 20: i = 2 in the crop, 6 in the anneal,
    40 after it."""
    _, dss, K, lms = fixture
    jd, bias = _build(jdd, dss["jax"], K, lms, BUILDS[mode])
    td, _ = _build(tdd, dss["torch"], K, lms, BUILDS[mode], device="cpu")
    n = 512
    scfg = jdd.DeviceSamplerConfig(n_rand=n, H=HW, W=HW, precrop_iters=4, precrop_frac=0.5,
                                   lm_frac=0.8, lm_frac_anneal_iters=20, bias=bias)
    tcfg = tdd.DeviceSamplerConfig(**scfg.__dict__)
    seen = []
    real = jdd.get_rays_at

    def record(coords, *a):
        seen.append(np.asarray(coords))
        return real(coords, *a)

    monkeypatch.setattr(jdd, "get_rays_at", record)
    key = jax.random.PRNGKey(100 + i)
    jb = jdd.sample_batch_device(jd, jnp.asarray(K), jnp.asarray(i, jnp.int32), key, scfg)
    n_pick = td.fg_pixels.shape[1] if bias == "fg" else 68
    tb = tdd.sample_batch_device(td, torch.from_numpy(K), i, tcfg,
                                 draws=_jax_draws(key, n, td.images.shape[0], n_pick))
    np.testing.assert_array_equal(tb.coords.numpy(), seen[0])
    for name in ("rays_o", "rays_d", "target_rgb"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ("shape_code", "exp_type"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    np.testing.assert_allclose(tb.uv_map.numpy(), np.asarray(jb.uv_map), rtol=0, atol=1e-6)
    rows, cols = tb.coords[:, 0], tb.coords[:, 1]
    if i < 4:   # the centre half-box only
        assert rows.min() >= HW / 4 and rows.max() < 3 * HW / 4
    if bias != "none" and bias != "bogus" and i == 40:
        # the biased share is drawn (0.8 of the rays): not the uniform box alone
        assert (tb.coords != tdd.sample_batch_device(
            td, torch.from_numpy(K), i,
            tdd.DeviceSamplerConfig(**{**tcfg.__dict__, "lm_frac": 0.0}),
            draws=_jax_draws(key, n, td.images.shape[0], n_pick)).coords).any()


def test_sample_batch_from_a_generator(fixture):
    """The generator path: the same generator seed gives the same batch,
    coordinates are integers inside the frame, targets are stored pixels."""
    _, dss, K, lms = fixture
    td, bias = _build(tdd, dss["torch"], K, lms, BUILDS["auto_fg"], device="cpu")
    scfg = tdd.DeviceSamplerConfig(n_rand=64, H=HW, W=HW, precrop_iters=0, precrop_frac=0.5,
                                   lm_frac=0.5, lm_frac_anneal_iters=0, bias=bias)
    Kt = torch.from_numpy(K)
    a = tdd.sample_batch_device(td, Kt, 3, scfg, tloop.device_generator(0, 3, 0, "cpu"))
    b = tdd.sample_batch_device(td, Kt, 3, scfg, tloop.device_generator(0, 3, 0, "cpu"))
    c = tdd.sample_batch_device(td, Kt, 4, scfg, tloop.device_generator(0, 4, 0, "cpu"))
    assert torch.equal(a.coords, b.coords) and not torch.equal(a.coords, c.coords)
    assert torch.equal(a.coords, a.coords.floor())
    assert a.coords.min() >= 0 and a.coords.max() <= HW - 1
    flat = td.images.reshape(-1, 3).float() / 255.0
    assert all((flat == t).all(-1).any() for t in a.target_rgb)


@pytest.mark.parametrize("intervals", [
    dict(i_print=10, i_weights=20, i_testset=10 ** 9, i_video=10 ** 9, i_grid=10),
    dict(i_print=100, i_weights=300, i_testset=50, i_video=0, i_grid=0),
    dict(i_print=7, i_weights=21, i_testset=0, i_video=0, i_grid=0),
    dict(i_print=10 ** 9, i_weights=10 ** 9, i_testset=10 ** 9, i_video=10 ** 9, i_grid=0),
])
def test_auto_scan_steps_matches_jax(intervals):
    j = jconfig.Config(**intervals)
    t = tconfig.Config(**intervals)
    for n in (20, 60, 1000):
        assert tloop._auto_scan_steps(t, n) == jloop._auto_scan_steps(j, n)


TINY = dict(person_num=2, netdepth=2, netwidth=8, netdepth_fine=2, netwidth_fine=8,
            N_samples=4, N_importance=4, N_rand=64, precrop_iters=4, lm_frac_anneal_iters=8,
            compute_dtype="float32", uv_size=128, packet_size=256, i_print=10,
            i_weights=10, i_testset=10 ** 9, i_video=10 ** 9, i_grid=0, device_data=True,
            scan_steps=7, testskip=1)


def _cfg(mod, d, tmp, **kw):
    return mod.Config(expname="dd", basedir=str(tmp), datadir=str(d), uvdir=str(d / "uv"),
                      shape_codes_path=str(d / "factors_id.npy"), **{**TINY, **kw})


def _steps(exp):
    ckpt = os.path.join(exp, "checkpoints")
    return sorted(int(f.split(".")[0]) for f in os.listdir(ckpt)
                  if f.split(".")[0].isdigit())


def test_interval_crossing_checkpoints_on_jax_steps(fixture, tmp_path, monkeypatch):
    """scan_steps 7 divides neither i_weights (10) nor i_print: the chunks end
    at 7, 14, 20, and the checkpoints land where JAX's `crossed()` puts them
    (as tests/test_device_data.py::test_device_loop_interval_crossing runs it)."""
    d = fixture[0]

    def no_update(state, batch, key, spec, tx):
        """The JAX loop's chunks with a step that only counts, on a state
        that holds only the step: where its hooks fire and what it saves are
        compared (its saves recorded), and this keeps its compile short."""
        zero = jnp.sum(batch.target_rgb) * 0.0
        return state._replace(step=state.step + 1), {"loss": zero, "psnr": zero}

    saved = []
    monkeypatch.setattr(jloop, "train_step", no_update)
    monkeypatch.setattr(jloop, "create_train_state", lambda *a: jstate.TrainState(
        params={}, opt_state=(), step=jnp.asarray(0, jnp.int32)))
    monkeypatch.setattr(jloop, "save_checkpoint", lambda ckpt, state, step: saved.append(step))
    jloop.train(_cfg(jconfig, d, tmp_path / "jax"), n_iters=20)
    tloop.train(_cfg(tconfig, d, tmp_path / "torch"), n_iters=20, device="cpu")
    assert _steps(tmp_path / "torch" / "dd") == sorted(set(saved)) == [14, 20]
    logged = [line.split()[1] for line in open(tmp_path / "torch" / "dd" / "train_log.txt")
              if line.startswith("Iteration")]
    assert logged == ["14", "20"]


def test_device_data_trains_keeps_its_grid_and_resumes(fixture, tmp_path):
    """`train(device_data=True)` on the CPU: the loss is finite, the grid is
    updated and saved, a held-out render goes through the renderer, and a
    second run resumes from the last checkpoint."""
    d = fixture[0]
    cfg = _cfg(tconfig, d, tmp_path, netdepth=6, netdepth_fine=6, netwidth=64, netwidth_fine=64,
               multires=4, multires_views=2, N_rand=32, i_print=3, i_weights=3, i_grid=3,
               grid_warmup=3, grid_resolution=8, i_testset=6, render_factor=8, scan_steps=0)
    state = tloop.train(cfg, n_iters=6, device="cpu")
    exp = tmp_path / "dd"
    assert int(state.step) == 6 and latest_step(str(exp / "checkpoints")) == 6
    assert os.path.exists(exp / "checkpoints" / "occupancy_grid.npz")
    assert len(os.listdir(exp / "testset_000006")) == 1
    log = (exp / "train_log.txt").read_text()
    assert "device-data path: 6 frames resident, bias=fg, 3 steps a chunk" in log
    assert "Iteration 6" in log and "step_ok: 1" in log
    again = tloop.train(cfg, n_iters=8, device="cpu")
    assert int(again.step) == 8 and latest_step(str(exp / "checkpoints")) == 8
    assert "resumed from checkpoint at step 6" in (exp / "train_log.txt").read_text()


def test_estimate_device_bytes_matches_jax():
    for args in ((1440, 128, 128), (6, 512, 512, 2, 512, 2048)):
        assert tdd.estimate_device_bytes(*args) == jdd.estimate_device_bytes(*args)
