"""Occupancy grids in the port (mofanerf_tpu_torch/ops/occupancy.py, the grid
upkeep of train/loop.py, `run_render --fast`) against the JAX package's
(mofanerf_tpu/ops/occupancy.py), in f32 at a small size: fields of depth 8,
width 64 (4 + 2 embedding bands), grids of 5 to 8 cells a side, 16 x 16
frames. The fine field of the culled render runs through the fused field
kernel's plain version on the CPU (at f32 `apply_field_folded`'s arithmetic).

- `dilate_occupancy`, `occupancy_lookup`, `ray_aabb_hit`, `grid_aabb`: equal;
- `probe_density` at rtol 1e-5 (atol 1e-5 x the largest |sigma|; the order
  of f32 sums differs), and the grids built from it (`build_occupancy_grid`,
  `build_proposal_grid`, two EMA steps of `update_occupancy_grid`) equal,
  with thresholds chosen away from every probed value;
- `render_rays_occupancy` on a full, a shell and an empty grid, and
  `render_frame_fast` at hit_fraction None (auto-bucketed), 1.0 and 0.5:
  rgb, acc and depth at atol 1e-5 (depth rtol 1e-5), disp at rtol 1e-3;
- a grid saved by JAX loads in the port and back, bits and EMA equal;
- `run_train` on the CPU at the config file's own `i_grid` writes
  `occupancy_grid.npz`, and at `--i_grid 2 --grid_warmup 2` updates it,
  saves it and resumes it;
- `run_render --fast` through the maintained grid, re-probing the coarse
  field when the grid is more than half occupied or missing."""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.models import field as jfield
from mofanerf_tpu.render import renderer as jr
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.ops import occupancy as to
from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.render import renderer as tr

jo = importlib.import_module("mofanerf_tpu.ops.occupancy")

NEAR, FAR = 8.0, 26.0
FIELD = dict(depth=8, width=64, multires=4, multires_views=2)
T = torch.from_numpy


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grids(occ, lo, hi):
    """The same grid in both packages."""
    jg = jo.OccupancyGrid(jnp.asarray(occ), jnp.asarray(lo, jnp.float32),
                          jnp.asarray(hi, jnp.float32))
    tg = to.OccupancyGrid(T(np.asarray(occ)), torch.tensor(lo, dtype=torch.float32),
                          torch.tensor(hi, dtype=torch.float32))
    return jg, tg


@pytest.fixture(scope="module")
def field():
    jcfg = jfield.FieldConfig(**FIELD, compute_dtype=jnp.float32)
    tcfg = tfield.FieldConfig(**FIELD, compute_dtype=torch.float32)
    jp = jfield.init_field_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    codes = [rng.standard_normal(n).astype(np.float32) * s
             for n, s in ((50, 1.0), (30, 0.5), (256, 0.5))]
    jc = jfield.fold_conditioning(jp, *map(jnp.asarray, codes))
    _shape_density(jp, jcfg, jc)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jc=jc,
                tp=bridge.field_to_torch(_np(jp), tcfg, device="cpu"),
                tc=bridge.to_torch(_np(jc), device="cpu"))


def _shape_density(params, cfg, cond):
    """Give a seeded field structure in the head's box: rescale its alpha head
    so that raw sigma at the cells of an 8^3 grid over [-5, 5]^3 has median 0
    and spread 3 (a seeded ReLU field's density has nearly one sign)."""
    g = jo.OccupancyGrid(jnp.zeros((8, 8, 8), bool), jnp.full(3, -5.0), jnp.full(3, 5.0))
    sig = np.asarray(jo.probe_density(params, cfg, cond, g))
    gain = 3.0 / sig.std()
    alpha = params["sigma"]["alpha"]
    alpha["w"] = alpha["w"] * gain
    alpha["b"] = (alpha["b"] - np.median(sig)) * gain


def _threshold_away(values, q=0.5):
    """A threshold near the q-quantile of the positive `values`, in the widest
    gap there: no value lies within 1e-4 of it."""
    v = np.unique(np.asarray(values).ravel())
    v = v[v > 0]
    i = int(q * len(v))
    lo, hi = max(i - 8, 0), min(i + 8, len(v) - 1)
    k = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    assert v[k + 1] - v[k] > 2e-4
    return float(0.5 * (v[k] + v[k + 1]))


@pytest.mark.parametrize("cells", [0, 1, 2])
def test_dilate_matches_jax(cells):
    occ = np.random.default_rng(cells).random((8, 8, 8)) < 0.05
    want = jo.dilate_occupancy(jnp.asarray(occ), cells)
    got = to.dilate_occupancy(T(occ), cells)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lookup_and_slab_test_match_jax():
    rng = np.random.default_rng(2)
    jg, tg = _grids(rng.random((6, 6, 6)) < 0.4, [-2.0, -1.0, -3.0], [2.0, 3.0, 1.0])
    pts = rng.uniform(-4, 4, (50, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(to.occupancy_lookup(tg, T(pts)).numpy(),
                                  np.asarray(jo.occupancy_lookup(jg, jnp.asarray(pts))))
    ro = rng.uniform(-20, 20, (200, 3)).astype(np.float32)
    rd = (rng.uniform(-1, 1, (200, 3)) - ro / 40).astype(np.float32)
    rd[:5, 1:] = 0.0   # axis-parallel rays: the 1e-9 guard
    np.testing.assert_array_equal(
        to.ray_aabb_hit(tg, T(ro), T(rd), NEAR, FAR).numpy(),
        np.asarray(jo.ray_aabb_hit(jg, jnp.asarray(ro), jnp.asarray(rd), NEAR, FAR)))


@pytest.mark.parametrize("margin", [0, 1, 3])
def test_grid_aabb_matches_jax(margin):
    occ = np.zeros((8, 8, 8), bool)
    occ[2:4, 5, 1:7] = True
    for o in (occ, np.zeros_like(occ)):
        jg, tg = _grids(o, [-4.0, -3.0, -5.0], [4.0, 5.0, 5.0])
        assert to.grid_aabb(tg, margin) == jo.grid_aabb(jg, margin)


@pytest.mark.parametrize("activation", ["relu", "softplus"])
def test_probe_and_build_match_jax(activation, field):
    G = 8
    jg, tg = _grids(np.zeros((G, G, G), bool), [-5.0] * 3, [5.0] * 3)
    want = np.asarray(jo.probe_density(field["jp"], field["jcfg"], field["jc"], jg))
    got = to.probe_density(field["tp"], field["tcfg"], field["tc"], tg, chunk=100).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    act = jax.nn.relu if activation == "relu" else jax.nn.softplus
    thr = _threshold_away(act(want))
    kw = dict(resolution=G, density_threshold=thr, sigma_activation=activation)
    jgrid = jo.build_occupancy_grid(field["jp"], field["jcfg"], field["jc"], **kw)
    tgrid = to.build_occupancy_grid(field["tp"], field["tcfg"], field["tc"], chunk=128, **kw)
    assert 0.05 < float(tgrid.occ.float().mean()) < 1.0
    np.testing.assert_array_equal(tgrid.occ.numpy(), np.asarray(jgrid.occ))
    np.testing.assert_array_equal(tgrid.aabb_min.numpy(), np.asarray(jgrid.aabb_min))


def test_update_grid_over_two_ema_steps_matches_jax(field):
    G = 8
    rng = np.random.default_rng(4)
    jg, tg = _grids(np.zeros((G, G, G), bool), [-5.0] * 3, [5.0] * 3)
    ema0 = rng.uniform(0, 8, G ** 3).astype(np.float32)
    fresh = jax.nn.relu(jo.probe_density(field["jp"], field["jcfg"], field["jc"], jg))
    thr = _threshold_away(np.maximum(ema0 * 0.5, np.asarray(fresh)))
    kw = dict(decay=0.5, density_threshold=thr)
    jema, tema = jnp.asarray(ema0), T(ema0)
    for _ in range(2):
        jg, jema = jo.update_occupancy_grid(jg, jema, field["jp"], field["jcfg"], field["jc"], **kw)
        tg, tema = to.update_occupancy_grid(tg, tema, field["tp"], field["tcfg"], field["tc"], **kw)
        np.testing.assert_allclose(tema.numpy(), np.asarray(jema), rtol=1e-5,
                                   atol=1e-5 * float(jnp.abs(jema).max()))
        np.testing.assert_array_equal(tg.occ.numpy(), np.asarray(jg.occ))
    assert tg.occ.any() and not tg.occ.all()


def _check_maps(got, want):
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(want["disp"]), rtol=1e-3)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0.0, 0.0, 16.0]], np.float32), (n, 1))
    rd = rng.standard_normal((n, 3)) * [0.15, 0.15, 0.05] + [0.0, 0.0, -1.0]
    return ro, rd.astype(np.float32)


@pytest.mark.parametrize("kind", ["full", "shell", "empty"])
def test_render_rays_occupancy_matches_jax(kind, field):
    if kind == "full":
        occ, box, s_probe, k_keep = np.ones((4, 4, 4), bool), (-30.0, 30.0), 16, 16
    elif kind == "shell":
        G, box = 16, (-4.0, 4.0)
        t = (np.arange(G) + 0.5) / G * 8.0 - 4.0
        X, Y, Z = np.meshgrid(t, t, t, indexing="ij")
        R = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
        occ, s_probe, k_keep = (R > 2.0) & (R < 3.0), 64, 8
    else:
        occ, box, s_probe, k_keep = np.zeros((4, 4, 4), bool), (-30.0, 30.0), 16, 8
    jg, tg = _grids(occ, [box[0]] * 3, [box[1]] * 3)
    ro, rd = _rays(32, 5)
    for white in (False, True):
        want = jo.render_rays_occupancy(field["jp"], field["jcfg"], field["jc"], jg,
                                        jnp.asarray(ro), jnp.asarray(rd), NEAR, FAR, s_probe,
                                        k_keep, white)
        got = to.render_rays_occupancy(field["tp"], field["tcfg"], field["tc"], tg, T(ro), T(rd),
                                       NEAR, FAR, s_probe, k_keep, white)
        _check_maps(got, want)
    if kind == "empty":
        assert float(got["acc"].abs().max()) == 0.0 and bool((got["rgb"] == 1.0).all())
    else:
        assert float(got["acc"].max()) > 0.1


def test_grid_file_moves_between_packages(tmp_path):
    rng = np.random.default_rng(6)
    for G, with_ema in ((5, True), (8, False)):   # 125 bits: packbits pads the last byte
        jg, _ = _grids(rng.random((G, G, G)) < 0.3, [-5.0, -4.0, -3.0], [5.0, 4.0, 3.0])
        ema = rng.random(G ** 3).astype(np.float32) if with_ema else None
        a, b = str(tmp_path / f"jax{G}.npz"), str(tmp_path / f"port{G}.npz")
        jo.save_grid(a, jg, None if ema is None else jnp.asarray(ema))
        tg, tema = to.load_grid(a, device="cpu")
        np.testing.assert_array_equal(tg.occ.numpy(), np.asarray(jg.occ))
        np.testing.assert_array_equal(tg.aabb_max.numpy(), np.asarray(jg.aabb_max))
        assert (tema is None) == (ema is None)
        to.save_grid(b, tg, tema)
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
                assert za[k].dtype == zb[k].dtype, k
        jg2, jema2 = jo.load_grid(b)
        np.testing.assert_array_equal(np.asarray(jg2.occ), np.asarray(jg.occ))
        if with_ema:
            np.testing.assert_array_equal(np.asarray(jema2), ema)


@pytest.fixture(scope="module")
def model():
    """A small two-pass model in both packages and one frame's conditioning."""
    jspec = jr.MoFaNeRF(coarse=jfield.FieldConfig(**FIELD, compute_dtype=jnp.float32),
                        fine=jfield.FieldConfig(**FIELD, compute_dtype=jnp.float32),
                        render=jr.RenderConfig(n_coarse=8, n_importance=8, packet_size=64),
                        uv_size=128)
    tspec = tr.MoFaNeRF(coarse=tfield.FieldConfig(**FIELD, compute_dtype=torch.float32),
                        fine=tfield.FieldConfig(**FIELD, compute_dtype=torch.float32),
                        render=tr.RenderConfig(n_coarse=8, n_importance=8, packet_size=64),
                        uv_size=128)
    jp = jr.init_model_params(jax.random.PRNGKey(3), jspec)
    rng = np.random.default_rng(7)
    shape = rng.standard_normal(50).astype(np.float32)
    tex = (rng.standard_normal(256) * 0.5).astype(np.float32)
    jc = jr.prepare_conditioning(jp, jspec, jnp.asarray(shape), jr.exp_code_for(jp, 3),
                                 jnp.asarray(tex))
    for name in ("coarse", "fine"):
        _shape_density(jp[name], getattr(jspec, name), getattr(jc, name))
    tp = bridge.model_params_to_torch(_np(jp), tspec, device="cpu")
    tc = tr.FrameCond(*[bridge.to_torch(_np(c), device="cpu") for c in jc])
    return dict(jspec=jspec, tspec=tspec, jp=jp, jc=jc, tp=tp, tc=tc)


def test_proposal_grid_matches_jax(model):
    G = 8
    jg, _ = _grids(np.zeros((G, G, G), bool), [-5.0] * 3, [5.0] * 3)
    coarse = jax.nn.relu(jo.probe_density(model["jp"]["coarse"], model["jspec"].coarse,
                                          model["jc"].coarse, jg))
    kw = dict(resolution=G, density_threshold=_threshold_away(coarse, 0.7))
    want = jo.build_proposal_grid(model["jp"], model["jspec"], model["jc"], **kw)
    got = to.build_proposal_grid(model["tp"], model["tspec"], model["tc"], **kw)
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(want.occ))
    assert got.occ.any() and not got.occ.all()


@pytest.mark.parametrize("hit_fraction", [None, 1.0, 0.5])
def test_render_frame_fast_matches_jax(hit_fraction, model):
    occ = np.zeros((8, 8, 8), bool)
    occ[2:6, 2:6, 3:6] = True
    jg, tg = _grids(occ, [-2.0] * 3, [2.0] * 3)
    K = np.array([[12.0, 0, 8.0], [0, 12.0, 8.0], [0, 0, 1]], np.float32)
    pose = pose_spherical(20.0, -10.0, 16.0)[:3].astype(np.float32)
    want = jo.render_frame_fast(model["jp"], model["jspec"], model["jc"].fine, jg, 16, 16,
                                jnp.asarray(K), jnp.asarray(pose), s_probe=16, k_keep=8,
                                hit_fraction=hit_fraction)
    got = to.render_frame_fast(model["tp"], model["tspec"], model["tc"].fine, tg, 16, 16, K,
                               pose, s_probe=16, k_keep=8, hit_fraction=hit_fraction)
    assert got["rgb"].shape == (16, 16, 3)
    _check_maps(got, want)
    acc = got["acc"].numpy()
    assert (acc == 0).any() and acc.max() > 0.1   # background and the culled head both in view


def test_render_frame_fast_never_reaches_serve_rays(monkeypatch, model):
    """The occupancy renderer keeps its own rays and compaction (sweep_frame):
    serve_rays, set to raise, is never called."""
    from mofanerf_tpu_torch.ops import serve_rays
    from mofanerf_tpu_torch.render import serve

    def refuse(*args, **kw):
        raise AssertionError("the occupancy renderer reached serve_rays")

    monkeypatch.setattr(serve_rays, "serve_rays", refuse)
    monkeypatch.setattr(serve, "serve_rays", refuse)
    occ = np.zeros((8, 8, 8), bool)
    occ[2:6, 2:6, 3:6] = True
    _, tg = _grids(occ, [-2.0] * 3, [2.0] * 3)
    K = np.array([[12.0, 0, 8.0], [0, 12.0, 8.0], [0, 0, 1]], np.float32)
    got = to.render_frame_fast(model["tp"], model["tspec"], model["tc"].fine, tg, 16, 16, K,
                               pose_spherical(20.0, -10.0, 16.0)[:3].astype(np.float32),
                               s_probe=16, k_keep=8, hit_fraction=None)
    assert got["rgb"].shape == (16, 16, 3) and (got["acc"] > 0.1).any()


# ------------------------------------------------------------------ the loop


def _train_flags(tmp_path, d):
    return ["--basedir", str(tmp_path / "logs"), "--expname", "grid", "--datadir", str(d),
            "--uvdir", str(d / "uv"), "--shape_codes_path", str(d / "factors_id.npy"),
            "--landmarks_path", str(d / "landmarks.npy"), "--netdepth", "6", "--netwidth", "64",
            "--netdepth_fine", "6", "--netwidth_fine", "64", "--multires", "4",
            "--multires_views", "2", "--N_rand", "16", "--N_samples", "8", "--N_importance", "8",
            "--uv_size", "128", "--compute_dtype", "float32", "--person_num", "2",
            "--grid_resolution", "8", "--sigma_activation", "softplus", "--i_testset", "100",
            "--i_video", "100", "--device", "cpu"]


def test_run_train_keeps_saves_and_resumes_the_grid(tmp_path):
    from mofanerf_tpu_torch.cli import run_train
    from mofanerf_tpu_torch.data.facescape import make_synthetic_dataset

    d = tmp_path / "data"
    make_synthetic_dataset(str(d), n_ids=2, n_train=2, n_test=1, hw=32)
    flags = _train_flags(tmp_path, d)
    ckpt = tmp_path / "logs" / "grid" / "checkpoints"
    grid_path = str(ckpt / "occupancy_grid.npz")
    # the config file's own i_grid (500; the first update after grid_warmup 1000): the
    # grid is kept from the start, and saved, empty, beside the checkpoint
    config = os.path.join(os.path.dirname(__file__), "..", "configs", "exp_mofanerf.txt")
    run_train.main(["--config", config, "--n_iters", "2"] + flags)
    grid, ema = to.load_grid(grid_path, device="cpu")
    assert grid.occ.shape == (8, 8, 8) and not grid.occ.any() and float(ema.abs().max()) == 0.0
    os.remove(grid_path)
    for f in os.listdir(ckpt):
        os.remove(ckpt / f)

    # updates every 2 steps once 2 have passed, saved at each checkpoint and at the end
    small = flags + ["--i_grid", "2", "--grid_warmup", "2", "--i_weights", "2"]
    run_train.main(small + ["--n_iters", "2"])
    grid2, ema2 = to.load_grid(grid_path, device="cpu")
    assert float(ema2.min()) > 0.0   # softplus: every cell holds density
    log = (tmp_path / "logs" / "grid" / "train_log.txt").read_text()
    assert "resumed occupancy grid" not in log
    run_train.main(small + ["--n_iters", "4"])
    log = (tmp_path / "logs" / "grid" / "train_log.txt").read_text()
    assert "resumed from checkpoint at step 2" in log and "resumed occupancy grid" in log
    _, ema4 = to.load_grid(grid_path, device="cpu")
    # one more EMA step (decay 0.95) from the resumed EMA: never below its decay
    assert (ema4 >= ema2 * 0.95 - 1e-6).all() and not torch.equal(ema4, ema2)
    assert sorted(os.listdir(ckpt)) == ["000002.pt", "000004.pt", "occupancy_grid.npz"]


def test_run_render_fast_uses_the_maintained_grid(tmp_path, capsys):
    from mofanerf_tpu_torch.cli import run_render
    from mofanerf_tpu_torch.config import load_config

    ckpt = tmp_path / "ckpt"
    os.makedirs(ckpt)
    config = ["--netdepth", "6", "--netwidth", "64", "--netdepth_fine", "6", "--netwidth_fine",
              "64", "--compute_dtype", "float32", "--uv_size", "128", "--packet_size", "64",
              "--shape_codes_path", str(tmp_path / "none.npy"), "--uvdir", str(tmp_path / "uv"),
              "--device", "cpu"]
    argv = ["--out_dir", str(tmp_path / "o"), "--n_views", "2", "--render_factor", "32", "--fast",
            "--ckpt_dir", str(ckpt)] + config
    # no grid: the coarse field is probed
    probed = run_render.main(argv)
    assert "using training-maintained" not in capsys.readouterr().out
    assert probed.shape == (2, 16, 16, 3) and np.isfinite(probed).all()
    # a maintained grid is used, and the frames are render_frame_fast's through it
    occ = np.zeros((8, 8, 8), bool)
    occ[2:6, 2:6, 2:6] = True
    _, tg = _grids(occ, [-5.0] * 3, [5.0] * 3)
    to.save_grid(str(ckpt / "occupancy_grid.npz"), tg)
    frames = run_render.main(argv)
    assert "using training-maintained occupancy grid" in capsys.readouterr().out
    spec = load_config(config).model_spec()
    params = tr.init_model_params(torch.Generator().manual_seed(0), spec, device="cpu")
    cond = tr.prepare_conditioning(params, spec, torch.zeros(50), tr.exp_code_for(params, 0),
                                   torch.zeros(256))
    K = np.array([[1200.0 / 32, 0, 8.0], [0, 1200.0 / 32, 8.0], [0, 0, 1]], np.float32)
    want = to.render_frame_fast(params, spec, cond.fine, tg, 16, 16, K,
                                pose_spherical(-180.0, 0.0, 16.0)[:3])["rgb"].numpy()
    np.testing.assert_allclose(frames[0], want, atol=1e-6)
    # a saturated grid is re-probed
    _, full = _grids(np.ones((8, 8, 8), bool), [-5.0] * 3, [5.0] * 3)
    to.save_grid(str(ckpt / "occupancy_grid.npz"), full)
    again = run_render.main(argv)
    assert "re-probing the coarse field" in capsys.readouterr().out
    np.testing.assert_array_equal(again, probed)
