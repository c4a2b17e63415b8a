"""The port's image files (mofanerf_tpu_torch/utils/image_io.py) against what
the JAX package reads them with: `imageio.imread` (Pillow, libjpeg-turbo)
and `cv2.resize(INTER_AREA)`.

PNG reads are exact, for every row filter. JPEG decodes are held at max
|diff| <= 2/255 and mean <= 0.5/255 of imageio's (the decoder follows
libjpeg's integer IDCT, fancy upsampling and colour transform, so in
practice they are equal); the resize at atol 1e-5."""
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from mofanerf_tpu_torch.utils import image_io as iio

JPEG_MAX, JPEG_MEAN = 2, 0.5   # in 8-bit levels


def _scene(h, w, seed=0):
    """Smooth colour ramps with noise: chroma edges and flat areas both."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0), 128 + 90 * np.cos(x / 5.0 - y / 13.0),
                    (x * 3 + y * 2) % 256], -1) + rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    """A PNG whose rows use the given filter types in turn (0-4), made here
    from the PNG specification's filter definitions."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}[bpp]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    out = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (iio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_png_read_is_exact_against_imageio(tmp_path, channels):
    img = _scene(21, 34)
    img = img[..., 0] if channels == 1 else (
        img if channels == 3 else np.concatenate([img, img[..., :1] // 2 + 60], -1))
    # imageio's own writer (Pillow, adaptive filters) and every filter type in turn
    imageio.imwrite(tmp_path / "a.png", img)
    (tmp_path / "b.png").write_bytes(_filtered_png(img, [0, 1, 2, 3, 4, 4, 3, 1]))
    for name in ("a.png", "b.png"):
        ref = imageio.imread(tmp_path / name)
        got = iio.imread(str(tmp_path / name))
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_png_write_reads_back(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (9, 14, 3), dtype=np.uint8)
    iio.write_png(str(tmp_path / "o.png"), img)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "o.png"), img)
    np.testing.assert_array_equal(iio.imread(str(tmp_path / "o.png")), img)
    assert iio.image_size(str(tmp_path / "o.png")) == (9, 14)


def _assert_jpeg_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= JPEG_MAX and d.mean() <= JPEG_MEAN, (d.max(), d.mean())


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("shape", [(64, 64), (37, 53), (9, 15)])
def test_jpeg_decode_matches_imageio(tmp_path, subsampling, shape):
    for k, img in enumerate([_scene(*shape),
                             np.random.default_rng(2).integers(0, 256, shape + (3,), np.uint8)]):
        path = tmp_path / f"{k}.jpg"
        Image.fromarray(img).save(path, quality=75, subsampling=subsampling)
        _assert_jpeg_close(iio.imread(str(path)), imageio.imread(path))


def test_jpeg_gray_and_restart_intervals(tmp_path):
    Image.fromarray(_scene(40, 44)[..., 0]).save(tmp_path / "g.jpg")
    _assert_jpeg_close(iio.imread(str(tmp_path / "g.jpg")), imageio.imread(tmp_path / "g.jpg"))
    Image.fromarray(_scene(64, 80)).save(tmp_path / "r.jpg", restart_marker_blocks=3)
    assert b"\xff\xdd" in (tmp_path / "r.jpg").read_bytes()
    _assert_jpeg_close(iio.imread(str(tmp_path / "r.jpg")), imageio.imread(tmp_path / "r.jpg"))


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_own_jpeg_encoder_reads_in_both(tmp_path, quality):
    img = _scene(40, 56, seed=3)
    iio.write_jpeg(str(tmp_path / "e.jpg"), img, quality)
    ref = imageio.imread(tmp_path / "e.jpg")
    _assert_jpeg_close(iio.imread(str(tmp_path / "e.jpg")), ref)
    # a faithful encoding of the image, not only a decodable one
    assert np.abs(ref.astype(np.int64) - img.astype(np.int64)).mean() < 20


def test_progressive_jpeg_raises(tmp_path):
    """The progressive file this test once saw refused now reads back as
    imageio reads it (the name is kept; tests/test_torch_image_formats.py
    holds the progressive decoder case by case)."""
    Image.fromarray(_scene(32, 32)).save(tmp_path / "p.jpg", progressive=True)
    _assert_jpeg_close(iio.imread(str(tmp_path / "p.jpg")), imageio.imread(tmp_path / "p.jpg"))


@pytest.mark.parametrize("src,dst", [((64, 64), (32, 32)), ((64, 64), (8, 8)),
                                     ((48, 48), (32, 32)), ((16, 16), (512, 512)),
                                     ((30, 20), (7, 9)), ((10, 12), (25, 31))],
                         ids=["x1/2", "x1/8", "48to32", "16to512", "ragged-down", "ragged-up"])
def test_resize_area_matches_cv2(src, dst):
    rng = np.random.default_rng(4)
    for img in (rng.uniform(0, 1, src + (3,)).astype(np.float32),
                rng.uniform(0, 1, src).astype(np.float32)):
        ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
        got = iio.resize_area(img, (dst[1], dst[0]))
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((512, 512), (64, 64)), ((512, 512), (128, 128)),
                                     ((512, 512), (256, 256)), ((512, 512), (512, 512)),
                                     ((16, 16), (64, 64)), ((30, 20), (7, 9))],
                         ids=["512to64", "512to128", "512to256", "512to512", "16to64",
                              "ragged"])
def test_resize_linear_matches_cv2(src, dst):
    """cv2.resize at its default INTER_LINEAR (the fit's pyramid), f32 images
    in colour and gray: atol 1e-6 (both compute two taps an axis in f32
    weights; the port sums in f64)."""
    rng = np.random.default_rng(5)
    for img in (rng.uniform(0, 1, src + (3,)).astype(np.float32),
                rng.uniform(0, 1, src).astype(np.float32)):
        ref = cv2.resize(img, (dst[1], dst[0]))
        got = iio.resize_linear(img, (dst[1], dst[0]))
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _top_down(data: bytes) -> bytes:
    """The same BMP stored top-down: rows reversed, the height negated."""
    off = struct.unpack("<I", data[10:14])[0]
    w, h, _, bpp = struct.unpack("<iiHH", data[18:30])
    stride = (w * bpp // 8 + 3) // 4 * 4
    rows = [data[off + i * stride:off + (i + 1) * stride] for i in range(h)]
    return data[:22] + struct.pack("<i", -h) + data[26:off] + b"".join(rows[::-1])


@pytest.mark.parametrize("kind", ["rgb24", "rgbx32", "gray8", "palette8"])
@pytest.mark.parametrize("order", ["bottom_up", "top_down"])
def test_bmp_read_matches_imageio(tmp_path, kind, order):
    """Uncompressed BMPs as imageio (Pillow) writes them: 24-bit, 32-bit
    (Pillow reads its fourth byte as padding), 8-bit with the gray ramp for
    a palette ([H, W]) and 8-bit through a colour palette; odd widths, so
    rows are padded; bottom-up as written and top-down."""
    img = _scene(13, 7 if kind != "rgbx32" else 6)
    path = str(tmp_path / "x.bmp")
    if kind == "rgb24":
        imageio.imwrite(path, img)
    elif kind == "rgbx32":
        imageio.imwrite(path, np.concatenate([img, img[..., :1]], -1))
    elif kind == "gray8":
        imageio.imwrite(path, img[..., 1])
    else:
        Image.fromarray(img).quantize(16).save(path)
    if order == "top_down":
        with open(path, "rb") as f:
            data = _top_down(f.read())
        with open(path, "wb") as f:
            f.write(data)
    want = imageio.imread(path)
    got = iio.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_unreadable_files_raise_naming_the_file(tmp_path):
    path = tmp_path / "x.bmp"
    imageio.imwrite(str(path), _scene(8, 8))
    data = bytearray(path.read_bytes())
    data[30:34] = struct.pack("<I", 1)   # RLE8
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"x\.bmp: BMP of 24 bits, compression 1"):
        iio.imread(str(path))
    (tmp_path / "y.gif").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match=r"y\.gif: neither a PNG, a JPEG, a BMP nor a WebP file"):
        iio.imread(str(tmp_path / "y.gif"))


@pytest.mark.parametrize("channels", [1, 4])
def test_png_write_gray_and_rgba(tmp_path, channels):
    img = _scene(9, 11)
    img = img[..., 0] if channels == 1 else np.concatenate([img, img[..., :1]], -1)
    iio.write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "x.png")), img)
