"""The port stands alone: no module of mofanerf_tpu_torch (nor chip_smoke.py)
imports jax, mofanerf_tpu or the Orbax stack (orbax, tensorstore, zstandard),
every module imports with them blocked, and the entry points refuse to fall
back to the CPU when no card is present."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "mofanerf_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _imported_names(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports_in_source(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "mofanerf_tpu", "cv2", "imageio",
                            "PIL", "orbax", "tensorstore", "zstandard"), (path, name)


def test_every_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert "mofanerf_tpu_torch.ops.serve_kernel" in mods and len(mods) > 15
    assert {"mofanerf_tpu_torch.train.distill", "mofanerf_tpu_torch.ops.occupancy",
            "mofanerf_tpu_torch.train.fit", "mofanerf_tpu_torch.train.fit_loop",
            "mofanerf_tpu_torch.cli.run_fit", "mofanerf_tpu_torch.cli.evaluate",
            "mofanerf_tpu_torch.cli.export_grids", "mofanerf_tpu_torch.data.device_data",
            "mofanerf_tpu_torch.models.refine.generator",
            "mofanerf_tpu_torch.models.refine.discriminator",
            "mofanerf_tpu_torch.models.refine.encoder", "mofanerf_tpu_torch.models.refine.losses",
            "mofanerf_tpu_torch.train.refine", "mofanerf_tpu_torch.data.refine_dataset",
            "mofanerf_tpu_torch.utils.visualizer", "mofanerf_tpu_torch.cli.render_refine_trainset",
            "mofanerf_tpu_torch.cli.prepare_refine_trainset",
            "mofanerf_tpu_torch.cli.run_train_refinenet",
            "mofanerf_tpu_torch.cli.run_refine",
            "mofanerf_tpu_torch.preprocess", "mofanerf_tpu_torch.preprocess.align",
            "mofanerf_tpu_torch.preprocess.bn_fold", "mofanerf_tpu_torch.preprocess.matting",
            "mofanerf_tpu_torch.preprocess.pipeline", "mofanerf_tpu_torch.preprocess.pose",
            "mofanerf_tpu_torch.preprocess.relight", "mofanerf_tpu_torch.preprocess.segment",
            "mofanerf_tpu_torch.preprocess.sh", "mofanerf_tpu_torch.cli.wild_preprocess",
            "mofanerf_tpu_torch.datagen", "mofanerf_tpu_torch.datagen.mesh",
            "mofanerf_tpu_torch.datagen.multiview", "mofanerf_tpu_torch.datagen.rasterize",
            "mofanerf_tpu_torch.datagen.synthetic_faces",
            "mofanerf_tpu_torch.cli.align_clip", "mofanerf_tpu_torch.convert",
            "mofanerf_tpu_torch.cli.convert_ckpt", "mofanerf_tpu_torch.train.orbax",
            "mofanerf_tpu_torch.utils.ocdbt", "mofanerf_tpu_torch.utils.zstd",
            "mofanerf_tpu_torch.utils.profiling", "mofanerf_tpu_torch.ops.uv_sample",
            "mofanerf_tpu_torch.parallel", "mofanerf_tpu_torch.parallel.mesh",
            "mofanerf_tpu_torch.parallel.collectives", "mofanerf_tpu_torch.parallel.world",
            "mofanerf_tpu_torch.parallel.dryrun",
            "mofanerf_tpu_torch.examples._flagship",
            "mofanerf_tpu_torch.examples.morphable_flagship",
            "mofanerf_tpu_torch.examples.serve_flagship",
            "mofanerf_tpu_torch.examples.fit_quality",
            "mofanerf_tpu_torch.examples.expression_matrix",
            "mofanerf_tpu_torch.examples.refine_synthetic",
            "mofanerf_tpu_torch.examples.refine_nerf_corpus",
            "mofanerf_tpu_torch.examples.wild_demo",
            "mofanerf_tpu_torch.examples.morphable_scaling"} <= set(mods)
    code = f"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "flax", "optax", "mofanerf_tpu", "cv2", "imageio", "PIL",
                    "orbax", "tensorstore", "zstandard"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for m in list(sys.modules):
    if m.split(".")[0] in ("jax", "jaxlib", "mofanerf_tpu", "cv2", "imageio", "PIL", "orbax",
                           "tensorstore", "zstandard"):
        del sys.modules[m]
import importlib
for m in {mods!r}:
    importlib.import_module(m)
assert not any(m.split(".")[0] in ("jax", "mofanerf_tpu") for m in sys.modules)
print("imported", len({mods!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(mods)}" in proc.stdout


def test_entry_points_default_to_the_card(tmp_path):
    """With no device argument the entry points ask for the card: on a
    machine without one they raise instead of running on the CPU."""
    from mofanerf_tpu_torch import bridge
    from mofanerf_tpu_torch.cli import run_render
    from mofanerf_tpu_torch.models.ism import init_ism_params
    from mofanerf_tpu_torch.models.student import StudentConfig, init_student_params
    from mofanerf_tpu_torch.train.distill import load_student, save_student

    cfg = StudentConfig(depth=1, width=16, multires=2)
    params = init_student_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    path = str(tmp_path / "s.npz")
    save_student(path, params, cfg)
    calls = [
        lambda: load_student(path),
        lambda: init_student_params(torch.Generator().manual_seed(0), cfg),
        lambda: init_ism_params(torch.Generator().manual_seed(0)),
        lambda: bridge.to_torch({"w": np.zeros(2, np.float32)}),
        lambda: run_render.main(["--out_dir", str(tmp_path / "o"), "--student_path", path,
                                 "--n_views", "1", "--render_factor", "64"]),
    ]
    if torch.cuda.is_available():
        got, _ = load_student(path)
        assert got["input"]["w"].device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_teacher_entry_points_default_to_the_card(tmp_path):
    """The teacher and training slices' entry points ask for the card too."""
    from mofanerf_tpu_torch import bridge
    from mofanerf_tpu_torch.cli import run_render
    from mofanerf_tpu_torch.models.field import FieldConfig, init_field_params
    from mofanerf_tpu_torch.models.tex_encoder import init_tex_encoder_params
    from mofanerf_tpu_torch.cli import run_train
    from mofanerf_tpu_torch.config import Config
    from mofanerf_tpu_torch.render.renderer import MoFaNeRF, init_model_params
    from mofanerf_tpu_torch.models.student import StudentConfig, init_point_field
    from mofanerf_tpu_torch.ops.occupancy import OccupancyGrid, load_grid, save_grid
    from mofanerf_tpu_torch.train.distill import init_student
    from mofanerf_tpu_torch.train.loop import train
    from mofanerf_tpu_torch.train.state import create_train_state

    cfg = FieldConfig(depth=6, width=64)
    spec = MoFaNeRF(coarse=cfg, fine=cfg, uv_size=128)
    gen = torch.Generator().manual_seed(0)
    grid_path = str(tmp_path / "grid.npz")
    save_grid(grid_path, OccupancyGrid(torch.zeros((2, 2, 2), dtype=torch.bool),
                                       torch.full((3,), -1.0), torch.full((3,), 1.0)))
    on_cpu = bridge.to_numpy(init_model_params(gen, spec, device="cpu"))
    flax_like = {"params": {"mu": {"kernel": np.zeros((512, 256), np.float32),
                                   "bias": np.zeros(256, np.float32)}}}
    teacher_argv = ["--out_dir", str(tmp_path / "t"), "--n_views", "1", "--render_factor", "64",
                    "--netwidth", "64", "--netwidth_fine", "64", "--N_samples", "4",
                    "--N_importance", "4", "--basedir", str(tmp_path / "logs"),
                    "--uvdir", str(tmp_path / "uv"),
                    "--shape_codes_path", str(tmp_path / "none.npy")]
    calls = [
        lambda: init_field_params(gen, cfg),
        lambda: init_model_params(gen, spec),
        lambda: init_tex_encoder_params(gen, tex_dim=16, uv_size=128),
        lambda: bridge.field_to_torch(on_cpu["coarse"], cfg),
        lambda: run_render.main(teacher_argv),
        lambda: create_train_state(gen, spec),
        lambda: init_point_field(gen, cfg),
        lambda: init_student(gen, StudentConfig(depth=1, width=16)),
        lambda: load_grid(grid_path),
        lambda: train(Config(basedir=str(tmp_path / "logs")), n_iters=1),
        lambda: run_train.main(["--basedir", str(tmp_path / "logs"), "--n_iters", "1"]),
    ]
    if torch.cuda.is_available():
        assert init_field_params(gen, cfg)["xyz"]["w_pts"].device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # a malformed tree fails on its layout, before any device is asked for
    with pytest.raises(ValueError, match="layers"):
        bridge.tex_encoder_to_torch(flax_like)


def test_fitting_entry_points_default_to_the_card(tmp_path):
    """The fitting slice's entry points and the evaluation and export CLIs ask
    for the card too."""
    from mofanerf_tpu_torch.cli import evaluate, export_grids, run_fit
    from mofanerf_tpu_torch.train.fit import FitConfig, init_fit_codes, init_fit_state
    from mofanerf_tpu_torch.train.fit_loop import load_fit_codes

    pose = np.eye(4, dtype=np.float32)
    path = str(tmp_path / "fit_params.npz")
    np.savez(path, shape=np.zeros(50), tex=np.zeros(256), exp=np.zeros(30), pose=pose,
             light=np.ones(2), step=0)
    grids = str(tmp_path / "grids.npz")
    np.savez_compressed(grids, resolution=2, aabb_min=-np.ones(3), aabb_max=np.ones(3),
                        occ_0_0=np.packbits(np.ones(8, bool)))
    calls = [
        lambda: init_fit_codes(torch.Generator().manual_seed(0), pose),
        lambda: init_fit_state(torch.Generator().manual_seed(0), FitConfig(), pose),
        lambda: load_fit_codes(path),
        lambda: export_grids.load_exported_grid(grids, 0, 0),
        lambda: run_fit.main(["--filePath", str(tmp_path / "face.png")]),
        lambda: evaluate.main(["--ckpt_dir", str(tmp_path)]),
        lambda: export_grids.main(["--out", str(tmp_path / "g.npz"), "--ckpt_dir",
                                   str(tmp_path)]),
    ]
    if torch.cuda.is_available():
        assert load_fit_codes(path)[0].pose.device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_teacher_cli_renders_and_refuses_by_roadmap_item(tmp_path):
    """The CLI's teacher route on the CPU at a tiny size: seeded weights, a UV
    JPEG, a port checkpoint; the --fast and --distill routes from the same
    teacher; and a directory of the JAX package's Orbax steps (refused, naming
    ROADMAP A3, before the port read them): a step the JAX package saved
    renders the PNGs the JAX run_render writes from it (f32; within one level
    of 255, the rounding of a last bit)."""
    from mofanerf_tpu_torch.cli import run_render
    from mofanerf_tpu_torch.config import load_config
    from mofanerf_tpu_torch.train.checkpoint import save_checkpoint
    from mofanerf_tpu_torch.train.state import create_train_state
    from mofanerf_tpu_torch.utils.image_io import write_jpeg

    np.save(tmp_path / "factors_id.npy",
            np.random.default_rng(0).standard_normal((3, 50)).astype(np.float32))
    argv = ["--out_dir", str(tmp_path / "t"), "--n_views", "2", "--render_factor", "64",
            "--netwidth", "64", "--netwidth_fine", "64", "--N_samples", "6",
            "--N_importance", "6", "--basedir", str(tmp_path / "logs"),
            "--uvdir", str(tmp_path / "uv"), "--person", "2", "--expression", "5",
            "--shape_codes_path", str(tmp_path / "factors_id.npy"), "--device", "cpu"]
    frames = run_render.main(argv)
    assert frames.shape == (2, 8, 8, 3) and np.isfinite(frames).all()
    assert frames.min() >= 0.0 and frames.max() <= 1.0
    assert sorted(os.listdir(tmp_path / "t")) == ["000.png", "001.png"]
    # another person's shape code renders another frame
    other = run_render.main(argv[:argv.index("--person")] + ["--person", "0"]
                            + argv[argv.index("--person") + 2:])
    assert np.abs(other - frames).max() > 0

    # the occupancy-culled route (no maintained grid: the coarse field is probed)
    fast = run_render.main(argv + ["--fast"])
    assert fast.shape == (2, 8, 8, 3) and np.isfinite(fast).all()
    # the person's UV JPEG is read and encoded: another texture code, another frame
    os.makedirs(tmp_path / "uv" / "2")
    write_jpeg(str(tmp_path / "uv" / "2" / "1_neutral.jpg"),
               np.random.default_rng(3).integers(0, 256, (32, 32, 3), dtype=np.uint8))
    textured = run_render.main(argv)
    assert np.isfinite(textured).all() and np.abs(textured - frames).max() > 0
    # a port checkpoint is loaded: other weights, another frame
    spec = load_config(argv[argv.index("--netwidth"):]).model_spec()
    state = create_train_state(torch.Generator().manual_seed(1), spec, device="cpu")
    save_checkpoint(str(tmp_path / "pt"), state, 5)
    trained = run_render.main(argv + ["--ckpt_dir", str(tmp_path / "pt")])
    assert np.isfinite(trained).all() and np.abs(trained - textured).max() > 0
    # a directory of the JAX package's Orbax steps is read
    import imageio.v2 as imageio
    import jax

    from mofanerf_tpu.cli import run_render as jax_run_render
    from mofanerf_tpu.config import load_config as jax_load_config
    from mofanerf_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
    from mofanerf_tpu.train.state import create_train_state as jax_create_train_state

    f32 = ["--compute_dtype", "float32", "--ckpt_dir", str(tmp_path / "ckpts")]
    flags = argv[argv.index("--netwidth"):argv.index("--device")] + ["--compute_dtype", "float32"]
    jspec = jax_load_config(flags).model_spec()
    jax_save_checkpoint(str(tmp_path / "ckpts"),
                        jax_create_train_state(jax.random.PRNGKey(2), jspec), 1000)
    jax_argv = argv[:argv.index("--device")] + f32
    jax_argv[jax_argv.index("--out_dir") + 1] = str(tmp_path / "jax")
    jax_run_render.main(jax_argv)
    from_jax = run_render.main(argv + f32)
    assert np.isfinite(from_jax).all() and np.abs(from_jax - trained).max() > 0
    for name in ("000.png", "001.png"):
        ours = imageio.imread(tmp_path / "t" / name).astype(int)
        theirs = imageio.imread(tmp_path / "jax" / name).astype(int)
        assert ours.shape == theirs.shape and np.abs(ours - theirs).max() <= 1, name
    # a student distilled from the teacher and served, with no artifact path
    student = run_render.main(argv + ["--person", "1", "--distill", "--distill_steps", "2"])
    assert student.shape == (2, 8, 8, 3) and np.isfinite(student).all()


def test_weights_in_entry_points_default_to_the_card(tmp_path):
    """The converter of the reference's `.tar` and its CLI ask for the card
    too (before they read the file)."""
    from mofanerf_tpu_torch import convert
    from mofanerf_tpu_torch.cli import convert_ckpt
    from mofanerf_tpu_torch.render.renderer import MoFaNeRF

    calls = [
        lambda: convert.convert_ism({}),
        lambda: convert.convert_exp_codes([]),
        lambda: convert.convert_tex_encoder({}),
        lambda: convert_ckpt.main(["--tar", str(tmp_path / "missing.tar"), "--out_dir",
                                   str(tmp_path / "out")]),
    ]
    if torch.cuda.is_available():
        assert convert.convert_exp_codes([]).device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(FileNotFoundError):
        convert.convert_checkpoint(str(tmp_path / "missing.tar"), MoFaNeRF(), "cpu")


def test_refine_and_device_data_entry_points_default_to_the_card(tmp_path):
    """This slice's entry points ask for the card too: the device-resident
    dataset, the refiner's state, and the four RefineNet CLIs."""
    from types import SimpleNamespace

    from mofanerf_tpu_torch.cli import (prepare_refine_trainset, render_refine_trainset,
                                        run_refine, run_train_refinenet)
    from mofanerf_tpu_torch.data.device_data import build_device_dataset
    from mofanerf_tpu_torch.train.refine import RefineConfig, init_refine_state, init_vgg_params

    ds = SimpleNamespace(image_paths=[], id_codes=np.zeros(0), uv_paths={})
    calls = [
        lambda: build_device_dataset(ds, np.eye(3), np.zeros(0, np.int64)),
        lambda: init_refine_state(torch.Generator().manual_seed(0), RefineConfig(ngf=4)),
        lambda: init_vgg_params(torch.Generator().manual_seed(0)),
        lambda: render_refine_trainset.main(["--out_dir", str(tmp_path / "c")]),
        lambda: run_train_refinenet.main(["--dataroot", str(tmp_path)]),
        lambda: run_refine.main(["--nerf_folder", str(tmp_path)]),
    ]
    if torch.cuda.is_available():
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the ground-truth pairing is host work: it asks for no device
    with pytest.raises(SystemExit, match="gt_manifest"):
        prepare_refine_trainset.main(["--renders_dir", str(tmp_path), "--out_dir",
                                      str(tmp_path / "gt")])


def test_preprocess_and_datagen_entry_points_default_to_the_card(tmp_path):
    """The preprocessing and data-generation entry points ask for the card
    too: the pipeline, its CLI, the two weight converters, the rasterizer,
    render_identity and make_face_dataset (which writes nothing first)."""
    from mofanerf_tpu_torch.cli import wild_preprocess
    from mofanerf_tpu_torch.datagen.multiview import render_identity
    from mofanerf_tpu_torch.datagen.rasterize import rasterize_mesh
    from mofanerf_tpu_torch.datagen.synthetic_faces import make_face_dataset
    from mofanerf_tpu_torch.preprocess.pipeline import preprocess_dir
    from mofanerf_tpu_torch.preprocess.relight import convert_hourglass_weights
    from mofanerf_tpu_torch.preprocess.segment import convert_bisenet_weights

    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float64)
    faces = np.array([[0, 1, 2]], np.int32)
    calls = [
        lambda: preprocess_dir(str(tmp_path)),
        lambda: wild_preprocess.main(["--filePath", str(tmp_path)]),
        lambda: convert_bisenet_weights({}),
        lambda: convert_hourglass_weights({}),
        lambda: rasterize_mesh(verts, faces, np.eye(3), np.eye(4), 8, 8),
        lambda: render_identity(0, {0: (verts, faces)}, str(tmp_path / "r")),
        lambda: make_face_dataset(str(tmp_path / "faces"), n_ids=1, exp_ids=(0,), res=8),
    ]
    if torch.cuda.is_available():
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "faces").exists()


def test_multi_card_entry_points_default_to_the_card(tmp_path):
    """The multi-card layer asks for the card too: init_distributed, a world
    of ranks, a world of one, and the dryrun's entry, before any rank starts
    or any process group is made."""
    import torch.distributed as dist

    from mofanerf_tpu_torch.parallel import init_distributed
    from mofanerf_tpu_torch.parallel import dryrun
    from mofanerf_tpu_torch.parallel.world import run_world, single_rank

    def world_of_one():
        with single_rank(workdir=str(tmp_path)):
            pass

    calls = [
        lambda: init_distributed(init_method=f"file://{tmp_path}/store", rank=0, world_size=1),
        lambda: run_world(dryrun.sharded_paths, 2, {}, workdir=str(tmp_path)),
        world_of_one,
        lambda: dryrun.main(["1", "--timeout", "30"]),
    ]
    if torch.cuda.is_available():
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not dist.is_initialized()
