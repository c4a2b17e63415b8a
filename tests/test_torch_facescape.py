"""The port's FaceScape loader (mofanerf_tpu_torch/data/facescape.py)
against the JAX package's, on fixtures written by either package: the same
dataset fields, and the same images from `read_image` in every mode (PNG
frames at atol 1e-5; JPEG UV maps within the JPEG tolerance of
tests/test_torch_image_io.py: max 2/255, mean 0.5/255)."""
import os

import numpy as np
import pytest

from mofanerf_tpu.data import facescape as jfs
from mofanerf_tpu_torch.data import facescape as tfs
from mofanerf_tpu_torch.utils.image_io import write_png


def _fields_equal(a, b):
    assert a.image_paths == b.image_paths
    for name in ("poses", "id_codes", "shape_codes", "exp_types", "render_poses"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert a.hwf == b.hwf
    for x, y in zip(a.i_split, b.i_split):
        np.testing.assert_array_equal(x, y)
    assert a.uv_paths == b.uv_paths


def _load(mod, d, persons, **kw):
    return mod.load_facescape_data(str(d), persons, mod.load_shape_codes(str(d / "factors_id.npy")),
                                   uvdir=str(d / "uv"), **kw)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kw", [{}, {"half_res": True, "testskip": 2}], ids=["full", "half"])
def test_loaders_agree_on_either_fixture(tmp_path, writer, kw):
    mod = jfs if writer == "jax" else tfs
    persons = mod.make_synthetic_dataset(str(tmp_path), n_ids=2, n_train=3, n_test=3, hw=32,
                                         seed=5)
    assert tfs.valid_persons(str(tmp_path)) == jfs.valid_persons(str(tmp_path)) == persons
    assert tfs.valid_persons(str(tmp_path), 1) == jfs.valid_persons(str(tmp_path), 1)
    _fields_equal(_load(tfs, tmp_path, persons, **kw), _load(jfs, tmp_path, persons, **kw))


def test_both_fixtures_hold_the_same_draws(tmp_path):
    jfs.make_synthetic_dataset(str(tmp_path / "j"), n_ids=2, hw=16, seed=3)
    tfs.make_synthetic_dataset(str(tmp_path / "t"), n_ids=2, hw=16, seed=3)
    for rel in ("factors_id.npy", "landmarks.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "j" / rel), np.load(tmp_path / "t" / rel))
    for rel in ("0/train_000.png", "1/test_001.png"):
        np.testing.assert_array_equal(tfs.read_image(str(tmp_path / "j" / rel)),
                                      tfs.read_image(str(tmp_path / "t" / rel)))
    for name in os.listdir(tmp_path / "j"):
        if name.endswith(".json"):
            assert (tmp_path / "j" / name).read_text() == (tmp_path / "t" / name).read_text()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("uv_size", [32, 128, 512])
def test_read_uv_maps_agree(tmp_path, writer, uv_size):
    mod = jfs if writer == "jax" else tfs
    mod.make_synthetic_dataset(str(tmp_path), n_ids=1, hw=32, seed=1)
    path = str(tmp_path / "uv" / "0" / "1_neutral.jpg")
    got = tfs.read_image(path, is_uvmap=True, uv_size=uv_size)
    ref = jfs.read_image(path, is_uvmap=True, uv_size=uv_size)
    assert got.shape == ref.shape == (uv_size, uv_size, 3) and got.dtype == np.float32
    d = np.abs(got - ref)
    assert d.max() <= 2 / 255 + 1e-6 and d.mean() <= 0.5 / 255, (d.max(), d.mean())


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray"])
@pytest.mark.parametrize("mode", [{}, {"half_res": True}, {"white_bkgd": True},
                                  {"half_res": True, "white_bkgd": True},
                                  {"is_uvmap": True, "uv_size": 64}],
                         ids=["plain", "half", "white", "half-white", "uv"])
def test_read_image_png_modes_agree(tmp_path, kind, mode):
    import imageio.v2 as imageio

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)
    img = {"rgb": img[..., :3], "rgba": img, "gray": img[..., 0]}[kind]
    path = str(tmp_path / "f.png")
    if kind == "rgb":
        write_png(path, img)
    else:
        imageio.imwrite(path, img)
    got, ref = tfs.read_image(path, **mode), jfs.read_image(path, **mode)
    assert got.shape == ref.shape and got.shape[-1] == 3 and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
