"""The port's four RefineNet CLIs against the JAX package's, on a synthetic
FaceScape fixture of two identities at 16 x 16 (fields 6 x 64, 4 + 4
samples, f32, UV 128) and one teacher: a seeded JAX train state saved as an
Orbax checkpoint for the JAX CLIs and, carried across by the bridge, as a
`.pt` for the port's.

- render_refine_trainset, plain and `--fast`: the same file tree and
  manifest; each frame within 2 levels of JAX's on 99% of its values and
  within 24 everywhere (the deterministic render's importance sampler puts
  its last sample on one of two bin edges on opaque rays by the last bit of
  a cumulative sum, in either package: tests/test_torch_renderer.py); the
  resume and `--begin_person` / `--end_person`.
- prepare_refine_trainset on the JAX corpus: the same tree, ground-truth
  pixels equal to JAX's, resized from 16 to 12 (`--res 12`).
- run_train_refinenet: the same checkpoint steps and loss-log lines, finite
  losses, both players moved, `--continue_train` resumes; the VGG term from
  a pickle in JAX's layout; a pickle of JAX arrays refused.
- run_refine from one refiner state (Orbax for JAX, `.pt` for the port):
  the same files, within 1 level.
"""
import json
import os
import pickle

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from mofanerf_tpu.cli import prepare_refine_trainset as jprepare
from mofanerf_tpu.cli import render_refine_trainset as jrender
from mofanerf_tpu.cli import run_refine as jrefine
from mofanerf_tpu.cli import run_train_refinenet as jtrain
from mofanerf_tpu.config import load_config as jload_config
from mofanerf_tpu.models.refine.losses import VGG19Features as JVGG
from mofanerf_tpu.train import refine as jref
from mofanerf_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from mofanerf_tpu.train.state import create_train_state as jcreate_train_state
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.cli import (prepare_refine_trainset, render_refine_trainset, run_refine,
                                    run_train_refinenet)
from mofanerf_tpu_torch.config import load_config
from mofanerf_tpu_torch.data.facescape import make_synthetic_dataset
from mofanerf_tpu_torch.train import refine as tref
from mofanerf_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

CONFIG = ["--netdepth", "6", "--netwidth", "64", "--netdepth_fine", "6", "--netwidth_fine", "64",
          "--N_samples", "4", "--N_importance", "4", "--compute_dtype", "float32",
          "--uv_size", "128"]


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
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("refinecli")
    data = d / "data"
    make_synthetic_dataset(str(data), n_ids=2, n_train=3, n_test=1, hw=16)
    config = CONFIG + ["--datadir", str(data), "--uvdir", str(data / "uv"), "--person_num", "2",
                       "--shape_codes_path", str(data / "factors_id.npy")]
    jspec = jload_config(config).model_spec()
    jstate = jax.jit(lambda k: jcreate_train_state(k, jspec))(jax.random.PRNGKey(3))
    jsave_checkpoint(str(d / "jax_ckpt"), jstate, 1)
    tstate = bridge.train_state_to_torch(jax.tree.map(np.asarray, jstate),
                                         load_config(config).model_spec(), device="cpu")
    save_checkpoint(str(d / "pt_ckpt"), tstate, 1)
    return dict(dir=d, config=config)


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def _jax_render(argv):
    """JAX's render_refine_trainset with its model init in one compiled
    program (eager flax init compiles each operation apart)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "create_train_state", lambda key, spec: jax.jit(
            lambda k: jcreate_train_state(k, spec))(key))
        jrender.main(argv)


def _render_both(world, name, flags):
    d = world["dir"]
    argv = ["--exp_num", "2", "--view_num", "2", "--res", "16"] + flags + world["config"]
    _jax_render(["--out_dir", str(d / f"j{name}"), "--ckpt_dir", str(d / "jax_ckpt")] + argv)
    render_refine_trainset.main(["--out_dir", str(d / f"t{name}"), "--ckpt_dir",
                                 str(d / "pt_ckpt"), "--device", "cpu"] + argv)
    return d / f"j{name}", d / f"t{name}"


@pytest.fixture(scope="module")
def corpus(world):
    return _render_both(world, "corpus", [])


@pytest.mark.parametrize("route", ["plain", "fast"])
def test_render_refine_trainset_matches_jax(world, corpus, route):
    j, t = corpus if route == "plain" else _render_both(world, "fast", ["--fast"])
    assert _files(t) == _files(j)
    with open(j / "gt_manifest.json") as f, open(t / "gt_manifest.json") as g:
        want, got = json.load(f), json.load(g)
    assert got == want and len(got) == 2 * 2   # 2 identities x 2 expressions, one frame each
    for rel in got:
        a = imageio.imread(t / rel).astype(int)
        b = imageio.imread(j / rel).astype(int)
        assert a.shape == b.shape == (16, 16, 3)
        diff = np.abs(a - b)
        assert np.mean(diff <= 2) >= 0.99 and diff.max() <= 24, (rel, diff.max())


def test_render_refine_trainset_resumes_and_shards(world, corpus, capsys):
    d = world["dir"]
    _, t = corpus
    before = {f: os.path.getmtime(t / f) for f in _files(t) if f.endswith(".png")}
    render_refine_trainset.main(["--out_dir", str(t), "--ckpt_dir", str(d / "pt_ckpt"),
                                 "--exp_num", "2", "--view_num", "2", "--res", "16",
                                 "--device", "cpu"] + world["config"])
    assert "skip existing" in capsys.readouterr().out
    assert {f: os.path.getmtime(t / f) for f in before} == before
    out = d / "shard"
    render_refine_trainset.main(["--out_dir", str(out), "--begin_person", "1",
                                 "--end_person", "2", "--exp_num", "1", "--view_num", "1",
                                 "--res", "16", "--device", "cpu"] + world["config"])
    assert "WARNING: no checkpoint" in capsys.readouterr().out
    assert not (out / "0").exists() and (out / "1").exists()


def test_prepare_refine_trainset_matches_jax(world, corpus):
    """The GT tree from the JAX corpus, the renders at 12 x 12 so that each
    16 x 16 ground truth is resized (INTER_AREA on uint8)."""
    d = world["dir"]
    j, _ = corpus
    small = d / "small"
    _jax_render(["--out_dir", str(small), "--ckpt_dir", str(d / "jax_ckpt"), "--exp_num", "1",
                 "--view_num", "2", "--res", "12"] + world["config"])
    for renders in (j, small):
        jprepare.main(["--renders_dir", str(renders), "--out_dir", str(renders) + "_jgt"])
        prepare_refine_trainset.main(["--renders_dir", str(renders),
                                      "--out_dir", str(renders) + "_tgt"])
        jgt, tgt = (renders.parent / (renders.name + suffix) for suffix in ("_jgt", "_tgt"))
        assert _files(tgt) == _files(jgt) and len(_files(tgt)) > 0
        for f in _files(tgt):
            a, b = imageio.imread(tgt / f), imageio.imread(jgt / f)
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=f)
    with pytest.raises(SystemExit, match="gt_manifest"):
        prepare_refine_trainset.main(["--renders_dir", str(d), "--out_dir", str(d / "x")])


@pytest.fixture(scope="module")
def pairs(world, corpus):
    j, _ = corpus
    root = world["dir"] / "pairs"
    os.makedirs(root)
    os.symlink(j, root / "train")
    prepare_refine_trainset.main(["--renders_dir", str(j), "--out_dir", str(root / "gt")])
    return root


TRAIN = ["--loadSize", "32", "--ngf", "4", "--niter", "1", "--niter_decay", "1",
         "--display_freq", "2", "--save_epoch_freq", "1"]


@pytest.fixture
def small_refiner(monkeypatch):
    """Both packages' CLIs on a small refiner (`--ngf 4`; RefineConfig's ndf 4,
    n_layers_D 1, one downsampling and one block, set the same way in both),
    JAX's init in one compiled program: this keeps JAX's compiles short."""
    small = dict(ndf=4, n_layers_D=1, n_downsampling=1, n_blocks=1)
    for mod in (jref, tref):
        monkeypatch.setattr(mod, "RefineConfig", _with(mod.RefineConfig, small))
    for cli in (jtrain, jrefine):
        monkeypatch.setattr(cli, "RefineConfig", jref.RefineConfig)
        monkeypatch.setattr(cli, "init_refine_state", _jitted_init)
    for cli in (run_train_refinenet, run_refine):
        monkeypatch.setattr(cli, "RefineConfig", tref.RefineConfig)


def test_run_train_refinenet_matches_jax(world, pairs, small_refiner, capsys):
    d = world["dir"]
    argv = ["--dataroot", str(pairs), "--max_steps", "6", "--no_vgg_loss"] + TRAIN
    jtrain.main(argv + ["--checkpoints_dir", str(d / "jref")])
    state = run_train_refinenet.main(argv + ["--checkpoints_dir", str(d / "tref"),
                                             "--device", "cpu"])
    jck, tck = d / "jref" / "refine" / "checkpoints", d / "tref" / "refine" / "checkpoints"
    assert (sorted(f[:-3] for f in os.listdir(tck)) == sorted(os.listdir(jck))
            == ["000004", "000006"])
    jlog = open(d / "jref" / "refine" / "loss_log.txt").read().splitlines()[1:]
    tlog = open(d / "tref" / "refine" / "loss_log.txt").read().splitlines()[1:]
    # the same epochs, steps and terms, in the same order
    strip = lambda lines: [(ln.split(" time:")[0], ln.split(") ")[1].split()[::2]) for ln in lines]
    assert strip(tlog) == strip(jlog) and len(tlog) == 3
    assert all(np.isfinite(float(v)) for ln in tlog for v in ln.split(") ")[1].split()[1::2])
    fresh = tref.init_refine_state(torch.Generator().manual_seed(0),
                                   tref.RefineConfig(ngf=4, load_size=32), 4, "cpu")
    for part in ("g_params", "d_params"):
        assert any(not torch.equal(getattr(state, part)[k], getattr(fresh, part)[k])
                   for k in getattr(state, part))
    # resume: a second call continues from step 6 to the end of the schedule
    again = run_train_refinenet.main(["--dataroot", str(pairs), "--max_steps", "7",
                                      "--no_vgg_loss", "--continue_train", "--checkpoints_dir",
                                      str(d / "tref"), "--device", "cpu"] + TRAIN)
    assert "resumed at step 6" in capsys.readouterr().out and int(again.step) == 7

    # the VGG term from a pickle in the JAX package's layout (numpy leaves)
    variables = jax.tree.map(np.asarray, JVGG().init(jax.random.PRNGKey(0),
                                                     np.zeros((1, 32, 32, 3), np.float32)))
    with open(d / "vgg.pkl", "wb") as f:
        pickle.dump(variables, f)
    def train_with(*flags, out):
        return run_train_refinenet.main(["--dataroot", str(pairs), "--max_steps", "1",
                                         "--checkpoints_dir", str(d / out), "--device", "cpu",
                                         *flags] + TRAIN + ["--display_freq", "1"])

    train_with("--vgg_weights", str(d / "vgg.pkl"), out="tvgg")
    assert "WARNING" not in capsys.readouterr().out
    vgg_line = open(d / "tvgg" / "refine" / "loss_log.txt").read().splitlines()[1]
    assert float(vgg_line.split("G_VGG: ")[1].split()[0]) > 0
    with open(d / "jaxvgg.pkl", "wb") as f:
        pickle.dump(jax.tree.map(jax.numpy.asarray, variables), f)
    with pytest.raises(ValueError, match="JAX arrays"):
        train_with("--vgg_weights", str(d / "jaxvgg.pkl"), out="tjaxvgg")
    train_with(out="novgg")
    assert "WARNING: no --vgg_weights given" in capsys.readouterr().out


def _jitted_init(key, *args, **kw):
    """JAX's `init_refine_state` in one compiled program (eager flax init
    compiles each operation apart)."""
    return jax.jit(lambda k: jref.init_refine_state(k, *args, **kw))(key)


def _with(cls, defaults):
    """`cls` with other defaults for some of its fields."""
    import dataclasses

    return dataclasses.make_dataclass(cls.__name__, [
        (f.name, f.type, dataclasses.field(default=defaults.get(f.name, f.default)))
        for f in dataclasses.fields(cls)], frozen=True)


def test_run_refine_matches_jax(world, corpus, small_refiner):
    d = world["dir"]
    j, _ = corpus
    frames = d / "frames"
    os.makedirs(frames)
    for k, rel in enumerate(sorted(json.load(open(j / "gt_manifest.json")))[:3]):
        os.symlink(j / rel, frames / f"{k:03d}.png")
    jcfg = jref.RefineConfig(ngf=4, load_size=32)
    js = _jitted_init(jax.random.PRNGKey(5), jcfg, image_size=32)
    jsave_checkpoint(str(d / "jr" / "refine" / "checkpoints"), js, 3)
    ts = bridge.refine_state_to_torch(jax.tree.map(np.asarray, js),
                                      tref.RefineConfig(ngf=4, load_size=32), device="cpu")
    save_checkpoint(str(d / "tr" / "refine" / "checkpoints"), ts, 3)
    argv = ["--nerf_folder", str(frames), "--loadSize", "32", "--ngf", "4"]
    jrefine.main(argv + ["--checkpoints_dir", str(d / "jr")])
    want = {f: imageio.imread(d / "refine" / f) for f in os.listdir(d / "refine")}
    paths = run_refine.main(argv + ["--checkpoints_dir", str(d / "tr"), "--device", "cpu"])
    assert sorted(os.path.basename(p) for p in paths) == sorted(want) == [
        "000.png", "001.png", "002.png"]
    for p in paths:
        got = imageio.imread(p)
        assert got.shape == (32, 32, 3)
        assert np.abs(got.astype(int) - want[os.path.basename(p)].astype(int)).max() <= 1
    back = restore_checkpoint(str(d / "tr" / "refine" / "checkpoints"),
                              tref.init_refine_state(torch.Generator(), tref.RefineConfig(
                                  ngf=4, load_size=32), device="cpu"))
    assert all(torch.equal(back.g_params[k], ts.g_params[k]) for k in ts.g_params)
