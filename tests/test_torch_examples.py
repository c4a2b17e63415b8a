"""The port's synthetic-data studies (mofanerf_tpu_torch/examples/) on the CPU.

- Every study end to end at a tiny size: 16x16 frames, 40 of the 120 views
  (every third), 3 teacher steps of 64 rays on a 2x16 + 2x32 teacher with
  8 + 8 samples, 3 distillation and 3 fitting steps. The gates cannot hold
  after 3 steps: a study whose gate fails raises AssertionError after its JSON
  is written; distill_scenes refuses to distil a teacher under its gate, so
  its run here lowers that gate (the gate itself is held by its own test
  below). The JSON's keys are held equal to those of the JAX package's
  committed artifact plus "device" (artifacts/avatar_student_quality.json,
  cond_student_quality.json, distill_quality.json's students' rows,
  distill_scenes.json), and to the keys the JAX script writes since the
  artifact was made (the SSIM readings): `_scenes.JSON_KEYS`, which
  chip_smoke.py's examples phase holds the card's runs to, and which a test
  here holds to the artifacts.
- The host sampler (`_scenes.HostSampler`, `object_coords`) against the JAX
  scripts' draws for the same seed: their numpy calls written out here.
- Two parity tests against the JAX package, its draws injected:
  * a 4x32 + 4x64 teacher (the quick studies' teacher, 16 + 16 samples,
    sigma noise 1) from one JAX init carried across by the bridge: two
    train_steps on identical batches of distill_morphable's scene (losses at
    rtol 1e-4), then its 16x16 frame through render_frame (rgb and acc at
    atol 2e-3). Its fields embed points with 4 bands, not the studies' 10:
    at 10 a last-bit difference of the first step's gradients grows into a
    4% loss difference at the second (the loss from equal params agrees to
    2e-5 there), as the importance samples move with the weights' last bits
    and sin(512 x) turns that into a visible change of the field;
  * from that teacher, two distill_avatars steps of a 4x128 f32 student from
    one JAX init (params at atol 2e-5: 2% of one Adam step), then the served
    16x16 frame of each identity (rgb and acc at atol 1e-4).
"""
import dataclasses
import functools
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.datagen import multiview
from mofanerf_tpu_torch.examples import (_scenes, distill_expression, distill_morphable,
                                         distill_scenes, distill_synthetic,
                                         expression_synthetic, morphable_synthetic,
                                         run_studies, texture_synthetic, train_synthetic)
from mofanerf_tpu_torch.utils.tree import tree_leaves

REPO = Path(__file__).resolve().parents[1]
ARTIFACTS = REPO / "artifacts"
TINY = ["--res", "16", "--iters", "3", "--device", "cpu"]


def _holds_keys(res, study):
    return _scenes.key_tree(res) == _scenes.JSON_KEYS[study]


def _artifact(name):
    with open(ARTIFACTS / name) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this file: its small operations gain nothing from
    more, and beside the suite's other workers many threads a process slow
    them tenfold and more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(monkeypatch):
    """The studies at the tiny size: a 2x16 + 2x32 teacher with 8 + 8 samples,
    64 rays a batch, every third view of the camera grid."""
    real_spec, real_grid = _scenes.teacher_spec, multiview.camera_grid

    def spec(coarse=(8, 64), fine=(8, 128), n_samples=32, **kw):
        return real_spec((2, 16), (2, 32), 8, **kw)

    monkeypatch.setattr(_scenes, "teacher_spec", spec)
    monkeypatch.setattr(_scenes, "N_RAND", 64)
    monkeypatch.setattr(_scenes, "N_OBJ", 38)
    for mod in (multiview, texture_synthetic):
        monkeypatch.setattr(mod, "camera_grid", lambda: real_grid()[::3])


def _run(mod, argv, json_path, gate=True):
    """Run a study; a gate that fails after 3 steps raises AssertionError once
    the JSON is written. Returns (the JSON, the timing)."""
    try:
        _, timing = mod.main(argv)
    except AssertionError:
        assert gate
        timing = None
    with open(json_path) as f:
        return json.load(f), timing


def _finite(values):
    return all(np.isfinite(v) for v in values if isinstance(v, float))


def test_train_and_distill_synthetic(tiny, tmp_path):
    """train_synthetic and distill_synthetic --quick on one cube dataset."""
    out = str(tmp_path)
    res, timing = _run(train_synthetic, ["--out", out] + TINY, tmp_path / "train_synthetic.json",
                       gate=False)
    assert _holds_keys(res, "train_synthetic")
    assert res["device"] == "cpu" and _finite(res.values()) and timing["teacher_secs"] > 0
    res, timing = _run(distill_synthetic, ["--out", out, "--quick", "--distill_steps", "3"]
                       + TINY, tmp_path / "distill_quality.json", gate=False)
    assert _holds_keys(res, "distill_synthetic")
    assert [(r["student"], r["samples"]) for r in res["students"]] == [("mlp_32x3_mr6", 16)]
    assert _finite(res["students"][0].values())
    assert timing["students"][0]["serving_kernel"] is True


def test_expression_and_distill_expression(tiny, tmp_path):
    """expression_synthetic and distill_expression on one two-cube dataset."""
    out = str(tmp_path)
    res, _ = _run(expression_synthetic, [out] + TINY, tmp_path / "expression_synthetic.json")
    assert _holds_keys(res, "expression_synthetic")
    res, _ = _run(distill_expression, ["--out", out, "--distill_steps", "3"] + TINY,
                  tmp_path / "cond_student_quality.json")
    assert _holds_keys(res, "distill_expression")
    for e in ("0", "1"):
        assert _finite(res["per_expression"][e].values())


def test_texture_synthetic(tiny, tmp_path):
    res, _ = _run(texture_synthetic, [str(tmp_path)] + TINY, tmp_path / "texture_synthetic.json")
    assert _holds_keys(res, "texture_synthetic")
    assert np.isfinite(res["mean_rgb_uv0"] + res["mean_rgb_uv1"]).all()


def test_morphable_synthetic_fits(tiny, tmp_path):
    res, timing = _run(morphable_synthetic, ["--out", str(tmp_path), "--fit_iters", "3"] + TINY,
                       tmp_path / "morphable_synthetic.json", gate=False)
    assert _holds_keys(res, "morphable_synthetic")
    assert _finite(res.values()) and res["fit_loss_min"] <= res["fit_loss_first"]
    assert timing["fit_secs"] > 0


def test_distill_morphable(tiny, tmp_path):
    res, _ = _run(distill_morphable, ["--out", str(tmp_path), "--distill_steps", "3"] + TINY,
                  tmp_path / "avatar_student_quality.json")
    assert _holds_keys(res, "distill_morphable")
    for pid in ("0", "1"):
        assert _finite(res["per_identity"][pid].values())
    assert res["student"] == "4x128 cond_dim=80"


def _key_paths(tree, at=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield at + (k,)
            yield from _key_paths(v, at + (k,))
    elif isinstance(tree, list):
        yield from _key_paths(tree[0], at + ("[]",))


@pytest.mark.parametrize("study, artifact", [
    ("distill_morphable", "avatar_student_quality.json"),
    ("distill_expression", "cond_student_quality.json"),
    ("distill_synthetic", "distill_quality.json"),
    ("distill_scenes", "distill_scenes.json"),
])
def test_json_keys_hold_the_jax_artifacts(study, artifact):
    """_scenes.JSON_KEYS holds every key of the JAX package's committed artifact, and
    beyond them only "device" and the SSIM readings the JAX script writes since."""
    theirs = set(_key_paths(_scenes.key_tree(_artifact(artifact))))
    ours = set(_key_paths(_scenes.JSON_KEYS[study]))
    assert theirs <= ours
    assert all(p[-1] == "device" or "ssim" in p[-1] for p in ours - theirs), ours - theirs


def test_run_study_reports_a_study(tiny, tmp_path):
    """run_studies.run_study, as chip_smoke.py's examples phase calls it: the study's
    status, its launches (none on the CPU, where the wrappers run their plain
    versions) and its timing."""
    row = run_studies.run_study("train_synthetic", ["--out", str(tmp_path)] + TINY)
    assert row["status"] == "ok" and row["launches"] == [0, 0]
    assert row["launch_shapes"] == {"field": [], "serve": []}
    assert row["timing"]["teacher_secs"] > 0 and row["wall_secs"] > 0
    assert _holds_keys(json.loads((tmp_path / "train_synthetic.json").read_text()),
                       "train_synthetic")


@pytest.fixture
def small_scenes(tiny, monkeypatch):
    """distill_scenes' three scenes at a quarter of their meshes' resolution
    (the shell's sphere 7 x 10 of 28 x 40, the torus 10 x 5 of 40 x 20, the
    face's sphere 12 x 16 of 64 x 96), to keep the CPU's rasterizer short, and
    distillation batches of 1024 points (of 32768)."""
    sphere, torus, face = distill_scenes._sphere, distill_scenes._torus, distill_scenes.face_mesh
    monkeypatch.setattr(distill_scenes, "_sphere",
                        lambda n_lat=28, n_lon=40: sphere(max(4, n_lat // 4), max(6, n_lon // 4)))
    monkeypatch.setattr(distill_scenes, "_torus", lambda: torus(n_u=10, n_v=5))
    monkeypatch.setattr(distill_scenes, "face_mesh",
                        lambda p, expression=0: face(p, expression, n_lat=12, n_lon=16))
    monkeypatch.setattr(distill_scenes, "DistillConfig",
                        functools.partial(distill_scenes.DistillConfig, batch=1024))


def test_distill_scenes(small_scenes, tmp_path, monkeypatch):
    """The study with its gate lowered to -inf: three steps cannot reach a
    teacher the gate passes."""
    monkeypatch.setattr(distill_scenes, "GATE_DB", -np.inf)
    argv = ["--out", str(tmp_path), "--distill_steps", "3"] + TINY
    res, timing = _run(distill_scenes, argv, tmp_path / "distill_scenes.json", gate=False)
    assert _holds_keys(res, "distill_scenes")
    assert [r["scene"] for r in res["scenes"]] == ["shell", "concave", "face"]
    for row in res["scenes"]:
        assert _scenes.key_tree(row) == _scenes.JSON_KEYS["distill_scenes"]["scenes"][0]
        assert len(row["teacher_attempts"]) == 1 and _finite(row.values())
    assert [t["scene"] for t in timing["scenes"]] == ["shell", "concave", "face"]


def test_distill_scenes_gate_refuses_an_unconverged_teacher(small_scenes, tmp_path,
                                                            monkeypatch):
    """Under the gate every attempt of the retry schedule runs (lr, lr/4, lr/8
    for 1x, 2x, 3x the steps) and the study raises before distilling."""
    real = distill_scenes.build_scenes
    monkeypatch.setattr(distill_scenes, "build_scenes",
                        lambda: dict(list(real().items())[:1]))
    argv = ["--out", str(tmp_path), "--iters", "1", "--res", "16", "--device", "cpu"]
    with pytest.raises(RuntimeError, match=r"teacher failed to converge in 3 attempts"):
        distill_scenes.main(argv)
    assert not (tmp_path / "distill_scenes.json").exists()


# ---------------------------------------------------------------- host sampler


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """Six RGBA training views of 24x20 (object masks of varied size, one
    empty), written as PNG, as a dataset the sampler reads."""
    from types import SimpleNamespace

    from mofanerf_tpu_torch.utils.png import write_png

    d = tmp_path_factory.mktemp("views")
    rng = np.random.default_rng(5)
    paths = []
    for i, side in enumerate((0, 3, 8, 14, 20, 24)):
        rgba = np.zeros((24, 20, 4), np.uint8)
        rgba[:side, :side] = rng.integers(60, 256, (min(side, 24), min(side, 20), 4))
        rgba[:side, :side, 3] = 255
        paths.append(str(d / f"{i}.png"))
        write_png(paths[-1], rgba)
    return SimpleNamespace(image_paths=paths, i_split=(np.arange(6), [], []))


def _jax_script_batch(rng, ds, load, n_rand, n_obj_max, H=24, W=20):
    """The numpy calls of the JAX scripts' batch closures (e.g. `batch_for` of
    examples/train_synthetic.py:81-100, `batch` of distill_morphable.py:133-153)."""
    img_i = int(rng.choice(ds.i_split[0]))
    target, mask = load(ds.image_paths[img_i])
    obj_r, obj_c = np.nonzero(mask)
    n_obj = min(n_obj_max, obj_r.shape[0])
    pick = rng.integers(0, obj_r.shape[0], n_obj) if n_obj else np.empty(0, int)
    coords = np.concatenate([
        np.stack([obj_r[pick], obj_c[pick]], -1).reshape(n_obj, 2),
        np.stack([rng.integers(0, H, n_rand - n_obj), rng.integers(0, W, n_rand - n_obj)], -1)],
        0)
    return img_i, coords, target[coords[:, 0], coords[:, 1]]


@pytest.mark.parametrize("study, seed, load, n_rand, n_obj", [
    ("train_synthetic", 0, "load_rgb", 1024, lambda i: 614),
    ("texture_synthetic", 1, "load_rgb", 1024, lambda i: 614),
    ("distill_synthetic", 0, "load_rgb", 1024, lambda i: int(614 * min(1.0, i / 1000))),
    ("distill_morphable --quick", 0, "load_rgb", 512, lambda i: int(512 * 0.6)),
    ("distill_scenes", 2, "load_white", 1024, lambda i: int(614 * min(1.0, i / 1000))),
])
def test_host_sampler_draws_the_jax_scripts_pixels(views, study, seed, load, n_rand, n_obj):
    """The same views, pixels and targets as the JAX script for its seed, over
    steps that cross the annealing of the object bias (0, 1, 999, 1000, ...)."""
    load = getattr(_scenes, load)
    ours = _scenes.HostSampler(views, seed, load=load)
    rng = np.random.default_rng(seed)
    for i in (0, 1, 2, 500, 999, 1000, 1001, 3, 4, 5):
        img_i, coords, target = ours.draw(n_rand, n_obj(i))
        want = _jax_script_batch(rng, views, load, n_rand, n_obj(i))
        assert img_i == want[0]
        np.testing.assert_array_equal(coords, want[1])
        np.testing.assert_array_equal(target, want[2])
    # the stream goes on alike: morphable_synthetic's fit draws from the same generator
    assert ours.rng.integers(0, 1 << 30) == rng.integers(0, 1 << 30)


def test_scene_pieces():
    v, f = _scenes.octahedron()
    np.testing.assert_array_equal(v, [[2.2, 0, 0], [-2.2, 0, 0], [0, 2.2, 0], [0, -2.2, 0],
                                      [0, 0, 2.2], [0, 0, -2.2]])
    assert f.shape == (8, 3) and _scenes.cube(1.8)[0].max() == 1.8
    codes = _scenes.one_hot_shape_codes()
    assert codes.shape == (300, 50) and codes.sum() == 2 and codes[0, 0] == codes[1, 1] == 1
    uv = _scenes.flat_uv((0.2, 0.5, 0.8))
    assert uv.shape == (128, 128, 3) and uv.dtype == np.float32
    np.testing.assert_array_equal(uv[5, 7], np.float32([0.2, 0.5, 0.8]))
    a = np.zeros((4, 4, 3))
    assert _scenes.psnr(a, a) == 100.0 and abs(_scenes.psnr(a, a + 0.1) - 20.0) < 1e-9
    acc = np.array([[0.9, 0.2], [0.6, 0.5]])
    assert _scenes.area(acc) == 0.5
    rgb = np.arange(12, dtype=np.float64).reshape(2, 2, 3)
    np.testing.assert_array_equal(_scenes.mean_rgb(rgb, acc), rgb[[0, 1], [0, 0]].mean(0))
    np.testing.assert_array_equal(_scenes.mean_rgb(rgb, acc * 0), rgb.mean((0, 1)))


# ------------------------------------------------------------ parity with JAX


def _jax_train_draws(key, n, n_c, n_f):
    """render_rays(train=True)'s draws from `key`, by the port's names."""
    k_strat, k_pdf, k_nc, k_nf = jax.random.split(key, 4)
    arrs = {"strat": jax.random.uniform(k_strat, (n, n_c)),
            "pdf": jax.random.uniform(k_pdf, (n, n_f)),
            "noise_c": jax.random.normal(k_nc, (n, n_c)),
            "noise_f": jax.random.normal(k_nf, (n, n_c + n_f))}
    return {k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}


def _seeded_state(jspec, jtx, seed):
    """A JAX train state of `jspec`'s tree, its params drawn with numpy: each
    matrix or kernel Glorot-uniform with the relu gain (the fields' init),
    each vector in +-0.1. It stands for JAX's own init, which compiles for
    13-20 s on the CPU."""
    from mofanerf_tpu.render import renderer as jr
    from mofanerf_tpu.train import state as js

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jr.init_model_params(k, jspec), jax.random.PRNGKey(0))

    def draw(leaf):
        fans = np.prod(leaf.shape[:-1]) + leaf.shape[-1] if len(leaf.shape) > 1 else None
        bound = 0.1 if fans is None else np.sqrt(12.0 / fans)
        return jnp.asarray(rng.uniform(-bound, bound, leaf.shape).astype(leaf.dtype))
    params = jax.tree.map(draw, shapes)
    return js.TrainState(params, jax.jit(jtx.init)(params), jnp.asarray(0, jnp.int32))


@pytest.fixture(scope="module")
def teacher_pair(tmp_path_factory):
    """The quick studies' teacher (4x32 + 4x64, 16 + 16 samples, sigma noise 1)
    in both packages from one JAX init, two steps taken by each on the same
    two batches of distill_morphable's scene (16x16, every third view)."""
    from mofanerf_tpu.models.field import FieldConfig as JField
    from mofanerf_tpu.render import renderer as jr
    from mofanerf_tpu.train import state as js
    from mofanerf_tpu_torch.train import state as ts

    d = str(tmp_path_factory.mktemp("scene"))
    for pid, mesh in ((0, _scenes.cube(1.8)), (1, _scenes.octahedron())):
        multiview.render_identity(pid, {0: mesh}, d, res=16, view_stride=3, device="cpu")
    codes = _scenes.one_hot_shape_codes()
    ds, H, W, K = _scenes.load_dataset(d, [0, 1], codes)
    tspec = _scenes.teacher_spec((4, 32), (4, 64), n_samples=16)
    tspec = dataclasses.replace(tspec, **{k: dataclasses.replace(getattr(tspec, k), multires=4)
                                          for k in ("coarse", "fine")})
    jspec = jr.MoFaNeRF(coarse=JField(depth=4, width=32, multires=4),
                        fine=JField(depth=4, width=64, multires=4),
                        render=jr.RenderConfig(n_coarse=16, n_importance=16, packet_size=4096,
                                               raw_noise_std=1.0), uv_size=128)
    uvs = [_scenes.flat_uv(0.7), _scenes.flat_uv((0.2, 0.5, 0.8))]
    jtx = js.make_optimizer(lrate=1e-3)
    j0 = _seeded_state(jspec, jtx, seed=0)
    jstep = jax.jit(lambda s, b, k: js.train_step(s, b, k, jspec, jtx))
    tstate = bridge.train_state_to_torch(jax.tree.map(np.asarray, j0), tspec, device="cpu")
    ttx = ts.make_optimizer(lrate=1e-3)
    sampler = _scenes.HostSampler(ds, seed=0)
    jstate, losses = j0, []
    for i in range(2):
        img_i, coords, target = sampler.draw(64, 38)
        pid = int(ds.id_codes[img_i])
        tb = _scenes.make_batch(ds, K, img_i, coords, target, codes[pid], 0,
                                torch.from_numpy(uvs[pid]), torch.device("cpu"))
        jb = js.Batch(*(jnp.asarray(np.asarray(v)) for v in tb[:6]))
        key = jax.random.PRNGKey(i)
        jstate, jm = jstep(jstate, jb, key)
        tstate, tm = ts.train_step(tstate, tb, None, tspec, ttx,
                                   draws=_jax_train_draws(key, 64, 16, 16))
        losses.append((float(tm["loss"]), float(jm["loss"])))
    return dict(jr=jr, jspec=jspec, tspec=tspec, jstate=jstate, tstate=tstate, losses=losses,
                ds=ds, K=K, codes=codes, uvs=uvs)


def _conds(pair, params_j, params_t, pid):
    from mofanerf_tpu_torch.render import renderer as tr

    jr, jspec, tspec = pair["jr"], pair["jspec"], pair["tspec"]
    shape, uv = pair["codes"][pid], pair["uvs"][pid]
    jtex = jr.encode_texture(params_j, jspec, jnp.asarray(uv))
    jc = jr.prepare_conditioning(params_j, jspec, jnp.asarray(shape),
                                 jr.exp_code_for(params_j, 0), jtex)
    with torch.no_grad():
        ttex = tr.encode_texture(params_t, tspec, torch.from_numpy(uv))
        tc = tr.prepare_conditioning(params_t, tspec, torch.from_numpy(shape),
                                     tr.exp_code_for(params_t, 0), ttex)
    return jc, tc, np.array(jtex)


def test_teacher_two_steps_then_frame_match_jax(teacher_pair):
    from mofanerf_tpu_torch.render import renderer as tr

    for ours, theirs in teacher_pair["losses"]:
        np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    ds, K = teacher_pair["ds"], teacher_pair["K"]
    pose = ds.poses[int(ds.i_split[2][0])][:3]
    jp, tp = teacher_pair["jstate"].params, teacher_pair["tstate"].params
    jc, tc, _ = _conds(teacher_pair, jp, tp, 0)
    jout = teacher_pair["jr"].render_frame(jp, teacher_pair["jspec"], jc, 16, 16, jnp.asarray(K),
                                           jnp.asarray(pose))
    tout = tr.render_frame(tp, teacher_pair["tspec"], tc, 16, 16, K, pose)
    for k in ("rgb", "acc"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=2e-3)
    assert float(np.asarray(jout["acc"]).max()) > 0.05   # the frame holds the object


def test_distill_avatars_two_steps_then_served_frame_match_jax(teacher_pair, monkeypatch):
    from mofanerf_tpu.models import student as jstudent
    from mofanerf_tpu.render.serve import render_frame_serve as jserve
    from mofanerf_tpu_torch.render.serve import render_frame_serve as tserve

    jd = importlib.import_module("mofanerf_tpu.train.distill")
    td = importlib.import_module("mofanerf_tpu_torch.train.distill")

    jp = teacher_pair["jstate"].params
    tp = bridge.model_params_to_torch(jax.tree.map(np.asarray, jp), teacher_pair["tspec"], "cpu")
    avatars = []
    for pid in (0, 1):
        _, _, tex = _conds(teacher_pair, jp, tp, pid)
        avatars.append((teacher_pair["codes"][pid], tex))
    box = dict(n_steps=2, batch=256, aabb_min=(-3.0,) * 3, aabb_max=(3.0,) * 3, cond_dim=80)
    jdc = jd.DistillConfig(compute_dtype=jnp.float32, **box)
    tdc = td.DistillConfig(compute_dtype=torch.float32, **box)
    scfg = tdc.student_config(teacher_pair["tspec"].fine)
    init = jstudent.init_point_field(jax.random.PRNGKey(3),
                                     jdc.student_config(teacher_pair["jspec"].fine))[0]
    monkeypatch.setattr(jd, "init_point_field",
                        lambda key, cfg: (jax.tree.map(jnp.asarray, init), None))
    monkeypatch.setattr(td, "init_point_field", lambda generator, cfg, device="cuda": (
        bridge.to_torch(jax.tree.map(np.asarray, init), device="cpu"), None))

    def draws(i):
        # JAX's loop key of step i at log_every 1, split as its conditioned step splits it
        kc, kp = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(1), i), 0))
        ka, kc = jax.random.split(kc)
        k1, k2, k3, k4, k5 = jax.random.split(kp, 5)
        ki, kj, kw = jax.random.split(kc, 3)
        arrs = {"pts_u": jax.random.uniform(k1, (128, 3)),
                "dirs_u": jax.random.normal(k2, (128, 3)),
                "o_dir": jax.random.normal(k3, (128, 3)),
                "targets": jax.random.uniform(k4, (128, 3)),
                "t": jax.random.uniform(k5, (128,)),
                "exp_a": jax.random.uniform(kw, (), minval=-0.25, maxval=1.25)}
        out = {k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}
        out.update(avatar=int(jax.random.randint(ka, (), 0, 2)),
                   exp_i=int(jax.random.randint(ki, (), 0, 1)),
                   exp_j=int(jax.random.randint(kj, (), 0, 1)))
        return out

    jst, jscfg = jd.distill_avatars(jp, teacher_pair["jspec"],
                                    [tuple(map(jnp.asarray, a)) for a in avatars], jdc,
                                    exp_ids=[0], seed=0, log_every=1)
    tst, tscfg = td.distill_avatars(tp, teacher_pair["tspec"],
                                    [tuple(map(torch.from_numpy, a)) for a in avatars], tdc,
                                    exp_ids=[0], seed=0, log_every=1, draws=draws)
    assert tscfg == scfg and int(tst.step) == 2
    for a, b in zip(jax.tree.leaves(jst.params), tree_leaves(tst.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5)
    ds, K = teacher_pair["ds"], teacher_pair["K"]
    pose = ds.poses[int(ds.i_split[2][0])][:3]
    kw = dict(near=8.0, far=26.0, n_samples=32, aabb_min=(-3.0,) * 3, aabb_max=(3.0,) * 3,
              packet_size=1024, hit_fraction=1.0)
    for pid in (0, 1):
        jcode = jd.avatar_code(jp, jnp.asarray(avatars[pid][0]),
                               teacher_pair["jr"].exp_code_for(jp, 0))
        with torch.no_grad():
            tcode = td.avatar_code(tp, torch.from_numpy(avatars[pid][0]), tp["exp_codes"][0])
        jout = jserve(jst.params, jscfg, jcode, 16, 16, jnp.asarray(K), jnp.asarray(pose), **kw)
        tout = tserve(tst.params, tscfg, tcode, 16, 16, K, pose, **kw)
        for k in ("rgb", "acc"):
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-4)


@pytest.mark.parametrize("cfg, want", [
    (dict(depth=4, width=128, multires=8), True),      # the serving student
    (dict(depth=3, width=32, multires=6), True),       # distill_synthetic --quick's
    (dict(depth=4, width=128, multires=10), True),     # the avatar student
    (dict(depth=6, width=192, skip=3, multires=8), False),
    (dict(depth=8, width=256, skip=4, multires=10), False),
    (dict(depth=4, width=96, skip=2, multires=8), False),
    (dict(depth=4, width=48, multires=8), False),      # not a multiple of 32
    (dict(depth=4, width=128, multires=21), False),    # a 129-wide embedding
])
def test_serving_kernel_says_which_students_it_takes(cfg, want):
    """distill_synthetic serves a student through the serving kernel where it takes it,
    else through the plain bounded render; `takes` is what a launch requires, and
    the wrapper's check raises exactly where it is false."""
    from mofanerf_tpu_torch.models.student import StudentConfig
    from mofanerf_tpu_torch.ops import serve_kernel as sk

    for dt in (torch.bfloat16, torch.float32):
        scfg = StudentConfig(compute_dtype=dt, **cfg)
        assert sk.takes(scfg) is want
        if want:
            sk._check_config(scfg)
        else:
            with pytest.raises(ValueError):
                sk._check_config(scfg)
    assert not sk.takes(StudentConfig(compute_dtype=torch.float16, **dict(cfg, skip=-1)))
