"""The port's RefineNet host side against the JAX package's and cv2:
`utils/image_io.py::resize_cubic` (cv2 INTER_CUBIC on float32, within 2e-6)
and `resize_area_u8` (cv2 INTER_AREA on uint8, byte-equal), enlarging and
shrinking; `RefinePairDataset` (the same pairs, images within 2e-6);
`ImagePool` (the same draws, the same outputs); `Visualizer` (the same log
lines, the same pixels, a byte-equal HTML index)."""
import os

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from mofanerf_tpu.data.prefetch import ImagePool as JPool
from mofanerf_tpu.data.refine_dataset import RefinePairDataset as JPairs
from mofanerf_tpu.utils import visualizer as jvis
from mofanerf_tpu_torch.data.prefetch import ImagePool
from mofanerf_tpu_torch.data.refine_dataset import RefinePairDataset
from mofanerf_tpu_torch.utils import visualizer as tvis
from mofanerf_tpu_torch.utils.image_io import resize_area_u8, resize_cubic

SIZES = [((256, 256), (512, 512)), ((512, 512), (256, 256)), ((17, 23), (40, 31)),
         ((60, 90), (32, 48)), ((33, 20), (11, 45)), ((16, 16), (32, 32))]


@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_cubic_matches_cv2(src, dst):
    img = np.random.default_rng(0).uniform(0, 1, src + (3,)).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_CUBIC)
    got = resize_cubic(img, dst[::-1])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("src,dst", SIZES + [((64, 64), (16, 16)), ((48, 48), (20, 20))])
def test_resize_area_u8_matches_cv2_bytes(src, dst):
    rng = np.random.default_rng(1)
    for shape in (src + (3,), src):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
        got = resize_area_u8(img, dst[::-1])
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    for root in ("renders", "gt"):
        for e in ("0", "5"):
            os.makedirs(d / root / "1" / e)
            for v in range(2):
                side = 16 if root == "renders" else 24
                imageio.imwrite(str(d / root / "1" / e / f"{v:02d}.png"),
                                rng.integers(0, 255, (side, side, 3), dtype=np.uint8))
    imageio.imwrite(str(d / "renders" / "gray.png"), rng.integers(0, 255, (16, 16),
                                                                   dtype=np.uint8))
    return d


@pytest.mark.parametrize("flat", [False, True])
def test_pair_dataset_matches_jax(tree, flat):
    root = tree / "renders" / "1" / "0" if flat else tree / "renders"
    b_root = None if flat else str(tree / "gt")
    j = JPairs(str(root), b_root, load_size=32, flat=flat)
    t = RefinePairDataset(str(root), b_root, load_size=32, flat=flat)
    assert t.a_paths == j.a_paths and t.b_paths == j.b_paths and len(t) == len(j)
    for i in range(len(t)):
        for flip in (False, True):
            (ta, tb), (ja, jb) = t.get(i, flip), j.get(i, flip)
            np.testing.assert_allclose(ta, ja, rtol=0, atol=2e-6)
            assert ta.shape == (32, 32, 3) and ta.min() >= -1 and ta.max() <= 1
            if tb is None:
                assert jb is None
            else:
                np.testing.assert_allclose(tb, jb, rtol=0, atol=2e-6)


@pytest.mark.parametrize("size", [0, 3])
def test_image_pool_matches_jax(size):
    j, t = JPool(size, seed=4), ImagePool(size, seed=4)
    rng = np.random.default_rng(2)
    for _ in range(6):
        batch = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
        np.testing.assert_array_equal(t.query(batch), j.query(batch))


def test_visualizer_matches_jax(tmp_path, capsys):
    visuals = {"input": np.random.default_rng(3).uniform(-0.1, 1.1, (8, 8, 3)),
               "fake": np.full((8, 8, 3), 0.5)}
    outs = {}
    for name, mod in (("jax", jvis), ("torch", tvis)):
        v = mod.Visualizer(str(tmp_path / name), "exp")
        v.print_errors(2, 30, {"loss_G": 1.23456, "loss_D": np.float32(0.5)}, 0.25)
        for epoch in (1, 2):
            v.save_images(epoch, visuals)
        path = v.save_result_image(str(tmp_path / name / "res"), "frame", visuals["input"])
        outs[name] = (v, path)
    (jv, jpath), (tv, tpath) = outs["jax"], outs["torch"]
    jlog, tlog = open(jv.log_path).read().splitlines(), open(tv.log_path).read().splitlines()
    want = "(epoch: 2, iters: 30, time: 0.250) loss_G: 1.235 loss_D: 0.500"
    assert tlog[1:] == jlog[1:] == [want]
    assert tlog[0].startswith("================ Training Loss (")
    jweb, tweb = tmp_path / "jax" / "web", tmp_path / "torch" / "web"
    assert open(tweb / "index.html").read() == open(jweb / "index.html").read()
    assert sorted(os.listdir(tweb / "images")) == sorted(os.listdir(jweb / "images"))
    for f in os.listdir(jweb / "images"):
        np.testing.assert_array_equal(imageio.imread(tweb / "images" / f),
                                      imageio.imread(jweb / "images" / f))
    np.testing.assert_array_equal(imageio.imread(tpath), imageio.imread(jpath))
