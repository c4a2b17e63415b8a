"""The port's wild-photo pipeline (preprocess/pipeline.py::preprocess_dir and
cli/wild_preprocess.py) against the JAX package's on the same folder at the
pipeline's 512^2: photos as a JPEG, a PNG and a BMP with precomputed
landmarks, and a PNG without (the center-crop route).

Held: the same files; pose files within 1e-6; the PNGs within 1 LSB
(truncation to bytes flips a level on 1e-7 float differences). With the
networks (random weights in the reference's layouts): the mask differs only
at pixels where JAX's top-2 BiSeNet logits are within 1e-4 of the logits'
scale of each other, and the relit image, where the masks agree, within 4
levels (a relit L flipped by one level moves RGB by a few through Lab) with a
mean under 0.1 level.
"""
import os
import shutil

import cv2
import numpy as np
import pytest
import torch
from PIL import Image
from test_preprocess_oracle import make_bisenet_sd, make_hourglass_sd

from mofanerf_tpu.datagen.synthetic_faces import face_landmarks, sample_identity_params
from mofanerf_tpu.preprocess import pipeline as jpipe
from mofanerf_tpu.preprocess import relight as jrel
from mofanerf_tpu.preprocess import segment as jseg
from mofanerf_tpu.preprocess.align import CANONICAL_LANDMARKS_512, align_to_template
from mofanerf_tpu_torch.cli import wild_preprocess
from mofanerf_tpu_torch.preprocess import pipeline as tpipe
from mofanerf_tpu_torch.preprocess import relight as trel
from mofanerf_tpu_torch.preprocess import segment as tseg
from mofanerf_tpu_torch.utils.image_io import imread, write_jpeg, write_png

OUT_DIRS = ("raw", "mask", "segRes", "segRelRes")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _photo(rng, h, w):
    """A smooth seeded photo (bilinear upsampling of a coarse noise grid)."""
    coarse = rng.uniform(0, 255, (12, 16, 3)).astype(np.float32)
    return np.clip(cv2.resize(coarse, (w, h)), 0, 255).astype(np.uint8)


def _kp(rng, scale, deg, shift):
    """The template's landmarks under a similarity, with detector noise,
    as (row, col)."""
    th = np.deg2rad(deg)
    R = scale * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    xy = CANONICAL_LANDMARKS_512 @ R.T + shift + rng.normal(0, 1.5, (68, 2))
    return xy[:, ::-1]


def _folder(d, with_bmp=True):
    rng = np.random.default_rng(0)
    os.makedirs(d)
    write_jpeg(os.path.join(d, "A.jpg"), _photo(rng, 480, 640))
    np.save(os.path.join(d, "kp_A.npy"), _kp(rng, 0.75, 12.0, (140.0, 60.0)))
    write_png(os.path.join(d, "B.png"), _photo(rng, 512, 512))
    np.save(os.path.join(d, "kp_B.npy"), _kp(rng, 1.0, 0.0, (0.0, 0.0)))
    write_png(os.path.join(d, "C.png"), _photo(rng, 400, 600))
    if with_bmp:
        Image.fromarray(_photo(rng, 300, 280)).save(os.path.join(d, "D.bmp"))
        np.save(os.path.join(d, "kp_D.npy"), _kp(rng, 0.5, -8.0, (10.0, 20.0)))


def _lm3d():
    return face_landmarks(sample_identity_params(2, 0)[1], 0).astype(np.float64)


def _outputs(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _compare_poses(a, b, names):
    for name in names:
        pa = np.load(os.path.join(a, f"pose_{name}.npy"), allow_pickle=True).item()
        pb = np.load(os.path.join(b, f"pose_{name}.npy"), allow_pickle=True).item()
        assert sorted(pa) == sorted(pb) == ["kp", "pose"]
        for k in ("pose", "kp"):
            assert pa[k].dtype == pb[k].dtype == np.float32
            np.testing.assert_allclose(pa[k], pb[k], rtol=0, atol=1e-6, err_msg=f"{name} {k}")


def test_preprocess_dir_matches_jax_without_networks(tmp_path, capsys):
    """The fallbacks: convex-hull masks, pass-through relight; the three
    landmark routes and the BMP reader."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _folder(jdir)
    shutil.copytree(jdir, tdir)
    jpipe.preprocess_dir(jdir, landmarks_3d=_lm3d())
    capsys.readouterr()
    tpipe.preprocess_dir(tdir, landmarks_3d=_lm3d(), device="cpu")
    log = capsys.readouterr().out
    assert "[C] no landmarks available; center-crop fallback" in log
    assert log.count("BiSeNet weights unavailable; convex-hull mask fallback") == 4
    assert log.count("relight weights unavailable; pass-through") == 4
    assert _outputs(tdir) == _outputs(jdir)
    _compare_poses(jdir, tdir, "ABCD")
    for sub in OUT_DIRS:
        for name in "ABCD":
            a = imread(os.path.join(jdir, sub, f"{name}.png")).astype(int)
            b = imread(os.path.join(tdir, sub, f"{name}.png")).astype(int)
            assert a.shape == b.shape and a.shape[:2] == (512, 512)
            assert np.abs(a - b).max() <= 1, (sub, name)
    seg = imread(os.path.join(tdir, "segRes", "A.png"))
    assert seg[0, 0].sum() == 0 and seg[260, 256].sum() > 0 and seg[450:].max() == 0


def _nets():
    bsd = make_bisenet_sd(torch.Generator().manual_seed(11))
    hsd = make_hourglass_sd(torch.Generator().manual_seed(3))
    sh = np.random.default_rng(9).normal(size=9)
    return bsd, hsd, sh


def test_preprocess_dir_matches_jax_with_networks(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _folder(jdir, with_bmp=False)
    for name in ("B.png", "kp_B.npy", "C.png"):   # A alone: the networks dominate the time
        os.remove(os.path.join(jdir, name))
    shutil.copytree(jdir, tdir)
    bsd, hsd, sh = _nets()
    jb, jh = jseg.convert_bisenet_weights(bsd), jrel.convert_hourglass_weights(hsd)
    jpipe.preprocess_dir(jdir, landmarks_3d=_lm3d(), bisenet_variables=jb,
                         relight_variables=jh, canonical_sh=sh)
    tpipe.preprocess_dir(tdir, landmarks_3d=_lm3d(),
                         bisenet_variables=tseg.convert_bisenet_weights(bsd, "cpu"),
                         relight_variables=trel.convert_hourglass_weights(hsd, "cpu"),
                         canonical_sh=sh, device="cpu")
    assert _outputs(tdir) == _outputs(jdir)
    _compare_poses(jdir, tdir, "A")
    # JAX's logit margins on A's aligned image decide where the masks may differ
    img = np.asarray(Image.open(os.path.join(jdir, "A.jpg")), np.float32) / 255.0
    kp = np.load(os.path.join(jdir, "kp_A.npy"))[:, ::-1]
    aligned, _ = align_to_template(img, kp)
    import jax.numpy as jnp
    x = (aligned - jseg._MEAN) / jseg._STD
    logits = np.sort(np.asarray(jseg.BiSeNet().apply(jb, jnp.asarray(x[None])))[0], -1)
    near_tie = logits[..., -1] - logits[..., -2] <= 1e-4 * np.abs(logits).max()
    read = lambda d, sub: imread(os.path.join(d, sub, "A.png")).astype(int)
    assert np.abs(read(jdir, "raw") - read(tdir, "raw")).max() <= 1
    differ = read(jdir, "mask") != read(tdir, "mask")
    assert not (differ & ~near_tie).any()
    same = ~differ
    assert np.abs(read(jdir, "segRes") - read(tdir, "segRes"))[same].max() <= 1
    rel = np.abs(read(jdir, "segRelRes") - read(tdir, "segRelRes"))[same]
    print(f"mask pixels that differ {differ.sum()}; relit max {rel.max()} mean {rel.mean():.4f}")
    assert rel.max() <= 4 and rel.mean() < 0.1, (rel.max(), rel.mean())


def test_cli_equals_preprocess_dir(tmp_path, capsys):
    """The CLI loads `.pth` / `.t7` files with torch.load, takes --landmarks3d
    as `lm[1, 0] / 50` and writes what preprocess_dir writes from the same
    converted weights."""
    bsd, hsd, sh = _nets()
    weights = tmp_path / "w"
    weights.mkdir()
    torch.save(bsd, weights / "Seg_79999_iter.pth")
    torch.save(hsd, weights / "trained_model_03.t7")
    np.save(weights / "fcspLight.npy", sh.reshape(9, 1))
    lms = np.zeros((3, 20, 68, 3), np.float32)
    lms[1, 0] = _lm3d() * 50.0
    np.save(weights / "landmarks.npy", lms)
    a, b = str(tmp_path / "cli"), str(tmp_path / "direct")
    _folder(a, with_bmp=False)
    for name in ("A.jpg", "kp_A.npy", "C.png"):
        os.remove(os.path.join(a, name))
    shutil.copytree(a, b)
    wild_preprocess.main(["--filePath", a, "--landmarks3d", str(weights / "landmarks.npy"),
                          "--bisenet_weights", str(weights / "Seg_79999_iter.pth"),
                          "--relight_weights", str(weights / "trained_model_03.t7"),
                          "--canonical_sh", str(weights / "fcspLight.npy"), "--device", "cpu"])
    tpipe.preprocess_dir(b, landmarks_3d=lms[1, 0] / 50.0,
                         bisenet_variables=tseg.convert_bisenet_weights(bsd, "cpu"),
                         relight_variables=trel.convert_hourglass_weights(hsd, "cpu"),
                         canonical_sh=sh, device="cpu")
    assert "[B] done" in capsys.readouterr().out
    assert _outputs(a) == _outputs(b)
    for sub in OUT_DIRS:
        np.testing.assert_array_equal(imread(os.path.join(a, sub, "B.png")),
                                      imread(os.path.join(b, sub, "B.png")))
    _compare_poses(a, b, "B")


def test_stages_and_unreadable_photo(tmp_path):
    """--stages writes only the named stages; a photo neither package reads
    (a JPEG of 12-bit samples, which imageio refuses too) stops the run
    naming the file (it is not skipped)."""
    d = str(tmp_path / "p")
    _folder(d, with_bmp=False)
    wild_preprocess.main(["--filePath", d, "--stages", "align,segment", "--device", "cpu"])
    assert os.listdir(os.path.join(d, "mask")) == []
    assert os.listdir(os.path.join(d, "segRelRes")) == []
    assert sorted(os.listdir(os.path.join(d, "segRes"))) == ["A.png", "B.png", "C.png"]
    Image.fromarray(_photo(np.random.default_rng(1), 64, 64)).save(os.path.join(d, "E.jpg"))
    with open(os.path.join(d, "E.jpg"), "rb") as f:
        data = f.read()
    sof = data.index(b"\xff\xc0")
    with open(os.path.join(d, "E.jpg"), "wb") as f:     # the frame's sample precision: 12 bits
        f.write(data[:sof + 4] + bytes([12]) + data[sof + 5:])
    with pytest.raises(ValueError, match=r"E\.jpg: JPEG of 12-bit samples"):
        tpipe.preprocess_dir(d, device="cpu")
