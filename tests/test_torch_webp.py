"""WebP files read by the port (mofanerf_tpu_torch/utils/webp.py over vp8.py
and vp8l.py, through image_io.imread / image_size) against
`imageio.v2.imread` on the same file: the same shape, dtype and every value;
where imageio raises, the port raises a ValueError naming the file.

The files come from Pillow (lossy at every quality and method, lossless,
alpha, animations), from libwebp's own encoder through ctypes for the
options Pillow does not expose (segments, simple and strong loop filters,
sharpness, filter strength, alpha filters and compression, SNS, sharp YUV,
near-lossless), and from the writers below: `vp8_frame` (a VP8 key frame
with any header: 1-8 token partitions, segment maps with absolute or delta
quantizers and filter levels, loop-filter deltas, quantizer deltas,
probability updates, skip flags, every intra mode, coefficients up to the
largest token) and `riff` (any container: VP8X flags, ALPH, ANIM / ANMF
frames at offsets, metadata and unknown chunks). The constant tables are
held against the copies compiled into the sandbox's libwebp.

The committed WebP fixtures of mofanerf_tpu_torch/testdata/formats/ (in its
manifest, remade with the other formats by tests/test_torch_image_formats.py)
and the RefineNet pair tree of mofanerf_tpu_torch/testdata/refine_webp/ (its
own manifest) are written here. Regenerate the pair tree (Pillow and imageio
needed; deterministic):

    JAX_PLATFORMS=cpu python -m tests.test_torch_webp mofanerf_tpu_torch/testdata/refine_webp
"""
import ctypes
import glob
import io
import json
import os
import struct
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from mofanerf_tpu.data.refine_dataset import RefinePairDataset as JPairs
from mofanerf_tpu_torch.data.refine_dataset import RefinePairDataset
from mofanerf_tpu_torch.utils import image_io as iio
from mofanerf_tpu_torch.utils import vp8, vp8l
from tests.test_torch_image_formats import FIXTURES, array_digest, scene

PAIRS = os.path.join(os.path.dirname(iio.__file__), "..", "testdata", "refine_webp")

# ---------------------------------------------------------------------------
# writers


def pil_webp(img, **kw):
    bio = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img)).save(bio, format="WEBP", **kw)
    return bio.getvalue()


_CONFIG = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
           "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
           "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
           "show_compressed", "preprocessing", "partitions", "partition_limit",
           "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact",
           "use_delta_palette", "use_sharp_yuv", "qmin", "qmax"]


class _Config(ctypes.Structure):      # libwebp's WebPConfig (encode.h), spare room at the end
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int)
                for n in _CONFIG] + [("spare", ctypes.c_uint32 * 16)]


class _Picture(ctypes.Structure):     # libwebp's WebPPicture, spare room at the end
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int), ("width", ctypes.c_int),
                ("height", ctypes.c_int), ("y", ctypes.c_void_p), ("u", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
                ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
                ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
                ("pad2", ctypes.c_uint32 * 3), ("writer", ctypes.c_void_p),
                ("custom_ptr", ctypes.c_void_p), ("extra_info_type", ctypes.c_int),
                ("extra_info", ctypes.c_void_p), ("stats", ctypes.c_void_p),
                ("error_code", ctypes.c_int), ("progress_hook", ctypes.c_void_p),
                ("user_data", ctypes.c_void_p), ("pad3", ctypes.c_uint32 * 3),
                ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p), ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2), ("spare", ctypes.c_uint8 * 256)]


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 8)]


def libwebp_path():
    import PIL
    from PIL import _webp  # noqa: F401  (loads libwebp and the libsharpyuv it links)
    return glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                  "libwebp-*.so*"))[0]


def libwebp_encode(img, **config):
    """A WebP file from libwebp's WebPEncode with any WebPConfig field set
    (ABI 0x0209: libwebp 1.x accepts any 2.x minor)."""
    lib = ctypes.CDLL(libwebp_path())
    cfg = _Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(75.0), 0x0209)
    for k, v in config.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), config
    pic = _Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), 0x0209)
    h, w, c = img.shape
    pic.width, pic.height, pic.use_argb = w, h, int(bool(cfg.lossless))
    buf = np.ascontiguousarray(img, np.uint8)
    imp = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert imp(ctypes.byref(pic), buf.ctypes.data_as(ctypes.c_void_p), w * c)
    wr = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.addressof(wr)
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    out = ctypes.string_at(wr.mem, wr.size) if ok else None
    lib.WebPMemoryWriterClear(ctypes.byref(wr))
    lib.WebPPictureFree(ctypes.byref(pic))
    assert ok, pic.error_code
    return out


def chunk(tag, payload):
    return tag + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def riff(*chunks, riff_size=None):
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body) if riff_size is None else riff_size) + body


def vp8x(w, h, flags):
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def chunks_of(data):
    """[(tag, payload)] of a RIFF WebP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos + 4:pos + 8], "little")
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def anmf(x, y, w, h, frame_chunks, flags=0):
    return chunk(b"ANMF", (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                 + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                 + (100).to_bytes(3, "little") + bytes([flags]) + b"".join(frame_chunks))


class _BoolWriter:
    """RFC 6386 7.3's boolean encoder, flushed as libvpx flushes it."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def put(self, prob, bit):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= 0xFFFFFF
                self.count = 8

    def value(self, v, n):
        for i in reversed(range(n)):
            self.put(128, (v >> i) & 1)

    def signed(self, v, n):
        self.value(abs(v), n)
        self.put(128, int(v < 0))

    def flag_signed(self, v, n):
        self.put(128, int(v is not None))
        if v is not None:
            self.signed(v, n)

    def bytes(self):
        for _ in range(32):
            self.put(128, 0)
        return bytes(self.out)


def _tree_paths(tree):
    """{leaf: [(prob index, bit), ...]} of a libwebp-style tree."""
    paths = {}

    def walk(i, path):
        for bit in (0, 1):
            nxt = tree[2 * i + bit]
            step = path + [(i, bit)]
            if nxt > 0:
                walk(nxt, step)
            else:
                paths[-nxt] = step
    walk(0, [])
    return paths


_BMODE_PATHS = _tree_paths(vp8.YMODES_INTRA4)


def _put_tokens(bw, bands, ctx, first, levels):
    """One block's levels (zig-zag order) as libwebp's GetCoeffs reads them."""
    nz = [n for n in range(first, 16) if levels[n]]
    last = nz[-1] if nz else first - 1
    n, p = first, bands[first][ctx]
    while n < 16:
        if n > last:
            bw.put(p[0], 0)
            return
        bw.put(p[0], 1)
        while not levels[n]:
            bw.put(p[1], 0)
            n += 1
            p = bands[n][0]
        bw.put(p[1], 1)
        v = abs(levels[n])
        if v == 1:
            bw.put(p[2], 0)
            nxt = 1
        else:
            bw.put(p[2], 1)
            nxt = 2
            if v <= 4:
                bw.put(p[3], 0)
                bw.put(p[4], int(v > 2))
                if v > 2:
                    bw.put(p[5], v - 3)
            elif v <= 10:
                bw.put(p[3], 1)
                bw.put(p[6], 0)
                bw.put(p[7], int(v > 6))
                if v <= 6:
                    bw.put(159, v - 5)
                else:
                    bw.put(165, (v - 7) >> 1)
                    bw.put(145, (v - 7) & 1)
            else:
                bw.put(p[3], 1)
                bw.put(p[6], 1)
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                bw.put(p[8], cat >> 1)
                bw.put(p[9 + (cat >> 1)], cat & 1)
                extra = v - 3 - (8 << cat)
                probs = vp8.CAT_PROBS[cat]
                for i, q in enumerate(probs):
                    bw.put(q, (extra >> (len(probs) - 1 - i)) & 1)
        bw.put(128, int(levels[n] < 0))
        n += 1
        p = bands[n][nxt]


def vp8_frame(h, w, seed, profile=0, segment=None, simple=0, level=20, sharpness=0,
              lf_delta=None, parts=0, base_q=40, dq=(None,) * 5, updates=0.0, skip=None,
              p4=0.5, big=0.02, density=0.3):
    """A VP8 key frame (a `VP8 ` chunk's payload) of random modes and
    coefficient levels, with every header field chosen:
    segment = dict(update_map, update_data, absolute, quant, filter, probs);
    lf_delta = (ref deltas, mode deltas) (None entries stay unset);
    dq: the five quantizer deltas (None: not coded); updates: the share of
    token probabilities updated; skip: the skip probability (None: not
    coded); p4: the share of 4x4 macroblocks; big: the share of levels drawn
    up to the largest token (67 + 2047)."""
    rng = np.random.default_rng(seed)
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    hd = _BoolWriter()
    hd.put(128, int(rng.integers(2)))            # colour space
    hd.put(128, int(rng.integers(2)))            # clamping type
    seg = segment or {}
    hd.put(128, int(segment is not None))
    seg_probs = [255, 255, 255]
    if segment is not None:
        hd.put(128, seg["update_map"])
        hd.put(128, seg["update_data"])
        if seg["update_data"]:
            hd.put(128, seg["absolute"])
            for q in seg["quant"]:
                hd.flag_signed(q, 7)
            for f in seg["filter"]:
                hd.flag_signed(f, 6)
        if seg["update_map"]:
            for p in seg["probs"]:
                hd.put(128, int(p is not None))
                if p is not None:
                    hd.value(p, 8)
            seg_probs = [255 if p is None else p for p in seg["probs"]]
    hd.put(128, simple)
    hd.value(level, 6)
    hd.value(sharpness, 3)
    hd.put(128, int(lf_delta is not None))
    if lf_delta is not None:
        hd.put(128, 1)
        for deltas in lf_delta:
            for d in deltas:
                hd.flag_signed(d, 6)
    hd.value(parts, 2)
    hd.value(base_q, 7)
    for d in dq:
        hd.flag_signed(d, 4)
    hd.put(128, 0)                               # refresh_entropy_probs
    probs = vp8.COEFF_PROBS.astype(np.int64).copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    up = bool(rng.random() < updates)
                    hd.put(int(vp8.COEFF_UPDATE_PROBS[t, b, c, p]), int(up))
                    if up:
                        probs[t, b, c, p] = int(rng.integers(1, 256))
                        hd.value(int(probs[t, b, c, p]), 8)
    hd.put(128, int(skip is not None))
    if skip is not None:
        hd.value(skip, 8)
    band_probs = probs.tolist()
    bands = [[band_probs[t][vp8.BANDS[n]] for n in range(17)] for t in range(4)]
    n_parts = 1 << parts
    tokens = [_BoolWriter() for _ in range(n_parts)]
    top_modes = [[0] * 4 for _ in range(mb_w)]
    top_nz = [[0] * 9 for _ in range(mb_w)]      # Y 0-3, U 4-5, V 6-7, Y2 8

    def levels(n):
        out = [0] * 16
        for i in range(16):
            if rng.random() < density:
                v = int(rng.integers(1, 2115)) if rng.random() < big else int(rng.geometric(0.4))
                out[i] = v if rng.random() < 0.5 else -v
        return out[:n] + [0] * (16 - n)
    for my in range(mb_h):
        left_modes, left_nz = [0] * 4, [0] * 9
        tw = tokens[my & (n_parts - 1)]
        for mx in range(mb_w):
            if seg.get("update_map"):
                s = int(rng.integers(4))
                hd.put(seg_probs[0], s >> 1)
                hd.put(seg_probs[1 + (s >> 1)], s & 1)
            skipped = skip is not None and rng.random() < 0.3
            if skip is not None:
                hd.put(skip, int(skipped))
            is4 = rng.random() < p4
            hd.put(145, int(not is4))
            if not is4:
                m = int(rng.integers(4))         # DC, TM, V, H
                hd.put(156, int(m in (1, 3)))
                hd.put(128 if m in (1, 3) else 163, int(m in (1, 2)))
                top_modes[mx], left_modes = [m] * 4, [m] * 4
            else:
                for y in range(4):
                    for x in range(4):
                        m = int(rng.integers(10))
                        prob = vp8.BMODE_PROBS[top_modes[mx][x], left_modes[y]]
                        for i, bit in _BMODE_PATHS[m]:
                            hd.put(int(prob[i]), bit)
                        top_modes[mx][x] = left_modes[y] = m
            uv = int(rng.integers(4))
            hd.put(142, int(uv != 0))
            if uv:
                hd.put(114, int(uv != 2))
                if uv != 2:
                    hd.put(183, int(uv == 1))
            tn, ln = top_nz[mx], left_nz
            if skipped:
                for k in range(8):
                    tn[k] = ln[k] = 0
                if not is4:
                    tn[8] = ln[8] = 0
                continue
            first = 0
            if not is4:
                lv = levels(16)
                _put_tokens(tw, bands[1], tn[8] + ln[8], 0, lv)
                tn[8] = ln[8] = int(any(lv))
                first = 1
            ac = bands[0] if not is4 else bands[3]
            for y in range(4):
                for x in range(4):
                    lv = levels(16)
                    _put_tokens(tw, ac, ln[y] + tn[x], first, lv)
                    tn[x] = ln[y] = int(any(lv[first:]))
            for base in (4, 6):
                for y in range(2):
                    for x in range(2):
                        lv = levels(16)
                        _put_tokens(tw, bands[2], ln[base + y] + tn[base + x], 0, lv)
                        tn[base + x] = ln[base + y] = int(any(lv))
    first_part = hd.bytes()
    part_bytes = [t.bytes() for t in tokens]
    tag = (profile << 1) | (1 << 4) | (len(first_part) << 5)
    return (tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + struct.pack("<HH", w, h) + first_part
            + b"".join(len(p).to_bytes(3, "little") for p in part_bytes[:-1])
            + b"".join(part_bytes))


class _LsbWriter:
    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, v, n):
        self.acc |= (v & ((1 << n) - 1)) << self.n
        self.n += n

    def bytes(self):
        return self.acc.to_bytes((self.n + 7) // 8, "little")


_REV8 = [int(f"{i:08b}"[::-1], 2) for i in range(256)]


def _vp8l_codes(bw, cache_bits=0):
    """The five prefix codes of a group, every literal at length 8 (the
    code-length code: symbols 0 and 8 at length 1), one distance symbol."""
    for size in (256 + 24 + ((1 << cache_bits) if cache_bits else 0), 256, 256, 256):
        bw.put(0, 1)                            # normal code
        bw.put(12 - 4, 4)                       # code-length codes up to symbol 8's place
        for sym in vp8l.CODE_LENGTH_ORDER[:12]:
            bw.put(1 if sym in (0, 8) else 0, 3)
        bw.put(0, 1)                            # lengths for the whole alphabet
        for k in range(size):
            bw.put(int(k < 256), 1)             # canonical: 0 -> "0", 8 -> "1"
    bw.put(1, 1)                                # distance: simple, one 1-bit symbol
    bw.put(0, 1)
    bw.put(0, 1)
    bw.put(0, 1)


def _vp8l_pixels(bw, argb):
    for a in np.asarray(argb, np.uint32).ravel().tolist():
        for shift in (8, 16, 0, 24):            # green, red, blue, alpha
            bw.put(_REV8[(a >> shift) & 0xFF], 8)


def vp8l_frame(h, w, seed, transforms=(), alpha_used=1):
    """A VP8L bitstream of random residuals under the given transforms (in
    reading order): ("predictor", bits, modes or None), ("cross", bits),
    ("green",), ("palette", n colours); every code at length 8 (the decoder
    reads it through its two-level tables), no cache."""
    rng = np.random.default_rng(seed)
    bw = _LsbWriter()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(alpha_used, 1)
    bw.put(0, 3)
    xs = w
    for t in transforms:
        bw.put(1, 1)
        kind = t[0]
        if kind in ("predictor", "cross"):
            bw.put(0 if kind == "predictor" else 1, 2)
            bits = t[1]
            bw.put(bits - 2, 3)
            tw, th = -(-xs // (1 << bits)), -(-h // (1 << bits))
            data = rng.integers(0, 1 << 32, (th, tw), dtype=np.uint64).astype(np.uint32)
            if kind == "predictor":
                modes = rng.integers(0, 16, (th, tw)) if t[2] is None else np.resize(t[2], (th, tw))
                data = (data & np.uint32(0xFFFF00FF)) | (modes.astype(np.uint32) << 8)
            bw.put(0, 1)                        # no cache
            _vp8l_codes(bw)
            _vp8l_pixels(bw, data)
        elif kind == "green":
            bw.put(2, 2)
        else:
            n = t[1]
            bw.put(3, 2)
            bw.put(n - 1, 8)
            bw.put(0, 1)
            _vp8l_codes(bw)
            _vp8l_pixels(bw, rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32))
            xs = -(-xs // (1 << (0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3)))
    bw.put(0, 1)                                # no more transforms
    bw.put(0, 1)                                # no cache
    bw.put(0, 1)                                # no meta codes
    _vp8l_codes(bw)
    _vp8l_pixels(bw, rng.integers(0, 1 << 32, (h, xs), dtype=np.uint64).astype(np.uint32))
    return bw.bytes()


# ---------------------------------------------------------------------------
# contents


def face(h, w, seed=0):
    """The face family's UV texture, tiled to h x w."""
    from mofanerf_tpu_torch.datagen.synthetic_faces import face_uv_map, sample_identity_params
    uv = face_uv_map(sample_identity_params(2, seed)[seed % 2], seed % 3, 64)
    img = (np.clip(uv, 0, 1) * 255).astype(np.uint8)
    return np.tile(img, (-(-h // 64), -(-w // 64), 1))[:h, :w]


def content(kind, h, w, seed=0, channels=3):
    if kind == "random":
        return np.random.default_rng(seed).integers(0, 256, (h, w, channels), dtype=np.uint8)
    if kind == "smooth":
        return scene(h, w, seed, channels)
    img = face(h, w, seed)
    if channels == 4:
        img = np.concatenate([img, scene(h, w, seed, 4)[..., 3:]], -1)
    return img


# ---------------------------------------------------------------------------
# the port against imageio


def _check(tmp_path, data, name="x.webp"):
    """The port's array against imageio's (shape, dtype, every value), and
    image_size against the shape; both refuse alike, the port naming the
    file. -> imageio's array, or None where both refuse."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        ref = imageio.imread(path)
    except Exception:                            # noqa: BLE001  (imageio raises many kinds)
        ref = None
    if ref is None:
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            iio.imread(str(path))
        return None
    got = iio.imread(str(path))
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)
    assert iio.image_size(str(path)) == ref.shape[:2]
    return ref


SHAPES = [(1, 1), (1, 17), (17, 1), (37, 53), (64, 64), (129, 65)]


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [0, 5, 25, 50, 75, 90, 100])
def test_lossy_every_quality_and_method(tmp_path, quality, method):
    """VP8 from Pillow at every shape (1-pixel rows and columns, odd sizes,
    partial macroblocks) on random, smooth and face content."""
    for kind in ("random", "smooth", "face"):
        for h, w in SHAPES:
            img = content(kind, h, w, seed=h + w)
            ref = _check(tmp_path, pil_webp(img, quality=quality, method=method))
            assert ref.shape == (h, w, 3)


@pytest.mark.parametrize("case", ["alpha_quality_0", "alpha_quality_40", "alpha_quality_100",
                                  "filter_none", "filter_fast", "filter_best", "raw",
                                  "raw_gradient", "odd_sizes"])
def test_lossy_with_alpha(tmp_path, case):
    """VP8X + ALPH + VP8: Pillow's alpha_quality (level reduction below 100),
    then libwebp's alpha_filtering (none, fast, best: horizontal, vertical,
    gradient by row) and alpha_compression (raw or VP8L) through ctypes."""
    h, w = (37, 53) if case != "odd_sizes" else (17, 1)
    img = content("face", h, w, seed=3, channels=4)
    img[..., 3] = np.where(np.arange(w)[None, :] % 7 == 0, 0, img[..., 3])
    if case.startswith("alpha_quality"):
        data = pil_webp(img, quality=70, alpha_quality=int(case.rsplit("_", 1)[1]))
    elif case.startswith("filter"):
        data = libwebp_encode(img, alpha_filtering=["none", "fast", "best"].index(case[7:]),
                              alpha_quality=90)
    elif case.startswith("raw"):
        data = libwebp_encode(img, alpha_compression=0,
                              alpha_filtering=2 if case == "raw_gradient" else 0)
    else:
        data = libwebp_encode(img, alpha_filtering=2)
    tags = [t for t, _ in chunks_of(data)]
    assert tags[:3] == [b"VP8X", b"ALPH", b"VP8 "], tags
    assert _check(tmp_path, data).shape == (h, w, 4)


LOSSLESS = ["q0_m0", "q50_m3", "q100_m6", "q100_m0", "colors2", "colors4", "colors16",
            "colors256", "smooth", "random", "random_cache", "exact", "opaque", "alpha_used",
            "one_row", "one_column"]


@pytest.mark.parametrize("case", LOSSLESS)
def test_lossless(tmp_path, case):
    """VP8L from Pillow: quality and method spans (transforms, meta codes,
    the colour cache, backward references), palettes of <= 2, 4, 16 (pixel
    bundling) and 256 colours, exact, opaque (3 channels) against
    alpha_is_used (4)."""
    rng = np.random.default_rng(LOSSLESS.index(case))
    kw = dict(lossless=True)
    img = content("smooth", 45, 61, seed=2, channels=4)
    if case.startswith("q"):
        q, m = case[1:].split("_m")
        kw.update(quality=int(q), method=int(m))
    elif case.startswith("colors"):
        n = int(case[6:])
        pal = rng.integers(0, 256, (n, 4), dtype=np.uint8)
        img = pal[rng.integers(0, n, (45, 61))]
    elif case.startswith("random"):
        img = content("random", 45, 61, channels=4)
        if case == "random_cache":                 # repeats for the cache and references
            img = img[rng.integers(0, 3, 45)][:, rng.integers(0, 61, 61)]
    elif case == "exact":
        img[::3, ::2, 3] = 0
        kw.update(exact=True)
    elif case == "opaque":
        img = img[..., :3]
    elif case == "alpha_used":
        img[..., 3] = 255
        img[0, 0, 3] = 254
    elif case == "one_row":
        img = img[:1]
    elif case == "one_column":
        img = img[:, :1]
    data = pil_webp(img, **kw)
    assert chunks_of(data)[0][0] == b"VP8L"
    assert _check(tmp_path, data).shape == img.shape[:2] + (4 if img.shape[2] == 4 else 3,)


@pytest.mark.parametrize("case", ["segments1", "segments4_simple", "simple_sharp7",
                                  "strong_sharp3", "filter0", "sns0", "sns100", "preprocess",
                                  "sharp_yuv", "near_lossless", "lossless_m6_q100"])
def test_libwebp_encoder_options(tmp_path, case):
    """Files from libwebp's WebPEncode with the WebPConfig fields Pillow does
    not expose."""
    opts = {"segments1": dict(segments=1), "segments4_simple": dict(segments=4, filter_type=0),
            "simple_sharp7": dict(filter_type=0, filter_sharpness=7, filter_strength=80),
            "strong_sharp3": dict(filter_type=1, filter_sharpness=3, filter_strength=100),
            "filter0": dict(filter_strength=0), "sns0": dict(sns_strength=0),
            "sns100": dict(sns_strength=100, quality=20), "preprocess": dict(preprocessing=2),
            "sharp_yuv": dict(use_sharp_yuv=1), "near_lossless": dict(lossless=1, near_lossless=40),
            "lossless_m6_q100": dict(lossless=1, method=6, quality=100)}[case]
    img = content("face", 70, 90, seed=1)
    _check(tmp_path, libwebp_encode(img, **opts))


def _vp8_case(case):
    return {
        "plain": dict(),
        "partitions2": dict(parts=1), "partitions4": dict(parts=2), "partitions8": dict(parts=3),
        "segments_absolute": dict(segment=dict(update_map=1, update_data=1, absolute=1,
                                               quant=[10, 60, None, 127], filter=[0, 30, 63, None],
                                               probs=[100, None, 200])),
        "segments_delta": dict(segment=dict(update_map=1, update_data=1, absolute=0,
                                            quant=[-40, 5, None, 60], filter=[-20, 10, None, 40],
                                            probs=[None, 50, 128])),
        "segments_no_data": dict(segment=dict(update_map=1, update_data=0, probs=[120, 60, 30])),
        "segments_no_map": dict(segment=dict(update_map=0, update_data=1, absolute=0,
                                             quant=[20, None, None, None], filter=[5, 0, 0, 0])),
        "lf_deltas": dict(lf_delta=([10, None, -3, 4], [-25, 7, None, 1]), sharpness=5),
        "lf_deltas_simple": dict(simple=1, lf_delta=([-30, 0, 0, 0], [40, None, None, None])),
        "simple_sharpness": dict(simple=1, level=40, sharpness=6),
        "level63_sharp1": dict(level=63, sharpness=1), "no_filter": dict(level=0),
        "quant_deltas": dict(dq=(-15, 7, -8, 15, -15), base_q=3),
        "quant_high": dict(dq=(None, 15, 15, 15, 15), base_q=127),
        "updates": dict(updates=0.3), "skip": dict(skip=90),
        "skip_all_4x4": dict(skip=200, p4=1.0), "all_16x16": dict(p4=0.0),
        "profile3": dict(profile=3), "dense_big": dict(density=0.9, big=0.3, base_q=100),
    }[case]


VP8_CASES = ["plain", "partitions2", "partitions4", "partitions8", "segments_absolute",
             "segments_delta", "segments_no_data", "segments_no_map", "lf_deltas",
             "lf_deltas_simple", "simple_sharpness", "level63_sharp1", "no_filter", "quant_deltas",
             "quant_high", "updates", "skip", "skip_all_4x4", "all_16x16", "profile3", "dense_big"]


@pytest.mark.parametrize("case", VP8_CASES)
def test_vp8_header_variants(tmp_path, case):
    """Key frames from `vp8_frame`: what libwebp's encoder never writes
    (2-8 partitions, relative segment data, segment maps without data, loop
    filter deltas, quantizer deltas at both ends of the tables, probability
    updates, profiles 1-3, levels up to the largest token, which wrap in
    int16 once dequantised) decoded as libwebp decodes it."""
    kw = _vp8_case(case)
    for seed, (h, w) in enumerate([(40, 50), (17, 33)]):
        data = riff(chunk(b"VP8 ", vp8_frame(h, w, seed, **kw)))
        assert _check(tmp_path, data).shape == (h, w, 3)


def test_vp8_header_variants_parse_as_written():
    """The writer's fields reach the port's header parser as written."""
    hd = vp8._parse_header(vp8_frame(40, 50, 0, parts=3, simple=1, level=33, sharpness=6,
                                     **_vp8_case("segments_delta")))
    assert (len(hd.parts), hd.filter_type, hd.level, hd.sharpness) == (8, 1, 33, 6)
    assert (hd.use_segment, hd.update_map, hd.absolute_delta) == (1, 1, 0)
    assert hd.seg_quant == [-40, 5, 0, 60] and hd.seg_filter == [-20, 10, 0, 40]


VP8L_CASES = {
    "predictor_every_mode": [("predictor", 2, None)],
    "predictor_modes_14_15": [("predictor", 2, [14, 15, 13, 0])],
    "cross_color": [("cross", 3)],
    "green_cross_predictor": [("green",), ("cross", 2), ("predictor", 3, None)],
    "predictor_then_green": [("predictor", 4, None), ("green",)],
    "palette2": [("palette", 2)], "palette3": [("palette", 3)], "palette11": [("palette", 11)],
    "palette200": [("palette", 200)],
    "palette_then_predictor": [("palette", 7), ("predictor", 2, None)],
    "all_four": [("green",), ("predictor", 2, None), ("cross", 5), ("palette", 13)],
}


@pytest.mark.parametrize("case", sorted(VP8L_CASES))
def test_vp8l_transform_variants(tmp_path, case):
    """Lossless streams from `vp8l_frame`: random residuals under the
    transforms in orders and combinations Pillow does not write, predictor
    modes 14 and 15 (libwebp's black sentinels) among them."""
    for seed, (h, w) in enumerate([(13, 21), (7, 5)]):
        data = riff(chunk(b"VP8L", vp8l_frame(h, w, seed, VP8L_CASES[case])))
        assert _check(tmp_path, data).shape == (h, w, 4)


def _still(img, **kw):
    """(chunks of a Pillow still, without the container)"""
    return chunks_of(pil_webp(img, **kw))


@pytest.mark.parametrize("case", ["offset_lossy", "offset_lossless", "offset_alpha",
                                  "pillow_animation", "pillow_animation_alpha"])
def test_animation_first_frame(tmp_path, case):
    """An animation's first frame, at its offset, on the transparent black
    canvas WebPAnimDecoder starts from (RGB unless the VP8X alpha flag)."""
    if case.startswith("pillow"):
        ch = 4 if case.endswith("alpha") else 3
        frames = [Image.fromarray(content("face", 40, 50, seed=s, channels=ch)) for s in range(3)]
        bio = io.BytesIO()
        frames[0].save(bio, format="WEBP", save_all=True, append_images=frames[1:], quality=70)
        data = bio.getvalue()
    else:
        alpha = case == "offset_alpha"
        img = content("smooth", 30, 20, seed=5, channels=4 if alpha else 3)
        still = _still(img, lossless=case == "offset_lossless", quality=60)
        frame = [c for c in still if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]
        second = _still(content("smooth", 40, 50, seed=6), quality=60)[-1:]
        data = riff(vp8x(50, 40, 0x02 | (0x10 if alpha else 0)),
                    chunk(b"ANIM", bytes(6)),
                    anmf(12, 6, 20, 30, [chunk(t, p) for t, p in frame]),
                    anmf(0, 0, 50, 40, [chunk(t, p) for t, p in second]))
    ref = _check(tmp_path, data)
    assert ref.shape[:2] == (40, 50)


def _container_case(case):
    img = content("face", 23, 31, seed=7, channels=4)
    lossy = _still(img, quality=70)                                # VP8X, ALPH, VP8
    vp8x_c, alph, vp8_c = lossy
    lossless = _still(img, lossless=True)[0]                       # VP8L
    plain = _still(img[..., :3], quality=70)[0]                    # VP8
    c = lambda t, p: chunk(t, p)                                   # noqa: E731
    v = vp8x(31, 23, 0x10)
    return {
        "alpha_flag_cleared": riff(vp8x(31, 23, 0), c(*alph), c(*vp8_c)),
        "vp8x_vp8l_without_alpha_flag": riff(vp8x(31, 23, 0), c(*lossless)),
        "vp8x_alpha_flag_vp8l": riff(v, c(*lossless)),
        "vp8x_alpha_flag_vp8": riff(v, c(*plain)),
        "metadata_chunks": riff(vp8x(31, 23, 0x10 | 0x20 | 0x08 | 0x04), c(b"ICCP", b"icc"),
                                c(*alph), c(*vp8_c), c(b"EXIF", b"II*\x00\x08\x00\x00\x00\x00\x00"),
                                c(b"XMP ", b"<x/>")),
        "exif_without_tiff_header": riff(vp8x(31, 23, 0x18), c(*alph), c(*vp8_c),
                                         c(b"EXIF", b"Exif\x00\x00abc")),
        "exif_not_flagged": riff(vp8x(31, 23, 0x10), c(*alph), c(*vp8_c), c(b"EXIF", b"abc")),
        "unknown_chunks": riff(v, c(b"ABCD", b"12345"), c(*alph), c(*vp8_c), c(b"WXYZ", b"1")),
        "trailing_bytes": riff(c(*plain)) + b"\x00garbage",
        "alph_after_vp8": riff(v, c(*vp8_c), c(*alph)),
        "alph_before_vp8l": riff(v, c(*alph), c(*lossless)),
        "two_images": riff(v, c(*alph), c(*vp8_c), c(*plain)),
        "canvas_mismatch": riff(vp8x(32, 23, 0x10), c(*alph), c(*vp8_c)),
        "anmf_without_anim": riff(vp8x(31, 23, 0x02), anmf(0, 0, 31, 23, [c(*plain)])),
        "anmf_not_animated": riff(vp8x(31, 23, 0), c(b"ANIM", bytes(6)),
                                  anmf(0, 0, 31, 23, [c(*plain)])),
        "frame_past_canvas": riff(vp8x(31, 23, 0x02), c(b"ANIM", bytes(6)),
                                  anmf(2, 2, 31, 23, [c(*plain)])),
        "bad_flags": riff(vp8x(31, 23, 0x11), c(*alph), c(*vp8_c)),
        "riff_short": riff(c(*plain), riff_size=len(plain[1]) + 100),
        "riff_odd": riff(c(*plain), riff_size=len(plain[1]) + 13),
        "raw_alpha_short": riff(v, c(b"ALPH", b"\x00" + bytes(10)), c(*vp8_c)),
        "alpha_header_reserved": riff(v, c(b"ALPH", bytes([0xC1]) + alph[1][1:]), c(*vp8_c)),
        "vp8_not_keyframe": riff(c(b"VP8 ", bytes([plain[1][0] | 1]) + plain[1][1:])),
        "vp8_partition_past_chunk": riff(c(b"VP8 ", bytes([0xE0, 0xFF, 0xFF]) + plain[1][3:])),
        "vp8l_version": riff(c(b"VP8L", lossless[1][:4] + bytes([lossless[1][4] | 0x20])
                               + lossless[1][5:])),
    }[case]


CONTAINER = ["alpha_flag_cleared", "vp8x_vp8l_without_alpha_flag", "vp8x_alpha_flag_vp8l",
             "vp8x_alpha_flag_vp8", "metadata_chunks", "exif_without_tiff_header",
             "exif_not_flagged", "unknown_chunks", "trailing_bytes", "alph_after_vp8",
             "alph_before_vp8l", "two_images", "canvas_mismatch", "anmf_without_anim",
             "anmf_not_animated", "frame_past_canvas", "bad_flags", "riff_short", "riff_odd",
             "raw_alpha_short", "alpha_header_reserved", "vp8_not_keyframe",
             "vp8_partition_past_chunk", "vp8l_version"]


@pytest.mark.parametrize("case", CONTAINER)
def test_container_variants(tmp_path, case):
    """The container as libwebp's demuxer and WebPGetFeatures read it:
    Pillow's channels rule, alpha kept or dropped by the VP8X flag,
    metadata, unknown chunks and padding skipped, the EXIF block's TIFF
    header (imageio parses it), and the files refused."""
    _check(tmp_path, _container_case(case))


def test_exif_block_damaged_past_its_tiff_header(tmp_path):
    """A still with Pillow's EXIF block (IFD0 and an Exif IFD), every byte
    past the block's 8-byte TIFF header flipped, and the block cut after each
    of those bytes (chunk and RIFF sizes kept whole): imageio reads every
    one, Pillow's EXIF parser dropping what it cannot read, and so does the
    port, value for value."""
    ex = Image.Exif()
    ex[0x010F], ex[0x0110], ex[0x8769] = "Maker", "Model", {0x9003: "2020:01:01 00:00:00"}
    bio = io.BytesIO()
    Image.fromarray(content("face", 24, 32, seed=1)).save(bio, format="WEBP", quality=80,
                                                           exif=ex.tobytes())
    data = bio.getvalue()
    at = data.index(b"EXIF")
    (n,) = struct.unpack("<I", data[at + 4:at + 8])
    start, rest = at + 8, data[at + 8 + n + n % 2:]
    variants = []
    for k in range(8, n):
        flipped = bytearray(data)
        flipped[start + k] ^= 0xFF
        variants.append(bytes(flipped))
        body = data[:at] + chunk(b"EXIF", data[start:start + k]) + rest
        variants.append(body[:4] + struct.pack("<I", len(body) - 8) + body[8:])
    for i, v in enumerate(variants):
        assert _check(tmp_path, v, f"e{i}.webp") is not None


@pytest.mark.parametrize("kind", ["lossy", "lossy_alpha", "lossless", "lossless_alpha",
                                  "animation", "vp8_partitions"])
def test_truncated_and_corrupted(tmp_path, kind):
    """Cut files and single flipped bits: the port reads what imageio reads,
    value for value, and refuses what it refuses."""
    rng = np.random.default_rng(["lossy", "lossy_alpha", "lossless", "lossless_alpha",
                                 "animation", "vp8_partitions"].index(kind))
    img = content("face", 21, 27, seed=2, channels=4)
    if kind == "lossy":
        data = pil_webp(img[..., :3], quality=60)
    elif kind == "lossy_alpha":
        data = pil_webp(img, quality=60)
    elif kind == "lossless":
        data = pil_webp(img[..., :3], lossless=True)
    elif kind == "lossless_alpha":
        data = pil_webp(img, lossless=True)
    elif kind == "animation":
        data = riff(vp8x(27, 21, 0x12), chunk(b"ANIM", bytes(6)),
                    anmf(4, 2, 19, 13, [chunk(t, p) for t, p in _still(img[:13, :19], quality=50)
                                        if t != b"VP8X"]))
    else:
        data = riff(chunk(b"VP8 ", vp8_frame(21, 27, 9, parts=2, skip=60)))
    cuts = sorted(set(rng.integers(1, len(data), 12).tolist()) | {1, 2, 5, 8, 13, len(data) - 20})
    for cut in cuts:
        _check(tmp_path, data[:len(data) - cut])
    for _ in range(40):
        flipped = bytearray(data)
        pos = int(rng.integers(0, len(data)))
        flipped[pos] ^= 1 << int(rng.integers(8))
        _check(tmp_path, bytes(flipped))


# ---------------------------------------------------------------------------
# the tables, against the copies compiled into libwebp


@pytest.mark.parametrize("name", ["COEFF_PROBS", "COEFF_UPDATE_PROBS", "BMODE_PROBS", "DC_TABLE",
                                  "AC_TABLE", "CODE_TO_PLANE"])
def test_tables_match_libwebp(name):
    """Each constant table equals a copy in the sandbox's libwebp, found by
    its first entries (the mode probabilities' first row is RFC 6386's
    231, 120, 48, 89, ...)."""
    blob = open(libwebp_path(), "rb").read()
    if name == "CODE_TO_PLANE":
        table = vp8l.CODE_TO_PLANE
    elif name == "AC_TABLE":
        table = vp8.AC_TABLE.astype("<u2").tobytes()
    else:
        table = getattr(vp8, name).astype(np.uint8).tobytes()
    head = table[:33 + 8] if name.startswith("COEFF") else table[:12]
    at = blob.find(head)
    assert at >= 0, name
    assert blob[at:at + len(table)] == table


def test_code_length_order_and_rfc_rows():
    assert vp8l.CODE_LENGTH_ORDER == (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
                                      14, 15)
    assert vp8.BMODE_PROBS[0, 0].tolist() == [231, 120, 48, 89, 115, 113, 120, 152, 112]
    assert (vp8.DC_TABLE[[0, 117, 127]].tolist(), vp8.AC_TABLE[[0, 127]].tolist()) == \
        ([4, 132, 157], [4, 284])


# ---------------------------------------------------------------------------
# the committed files and the slice


def _manifest_names(root):
    with open(os.path.join(root, "manifest.json")) as f:
        return json.load(f)


def _webp_fixtures():
    return sorted(n for n in _manifest_names(FIXTURES) if n.endswith(".webp"))


@pytest.mark.parametrize("name", _webp_fixtures())
def test_webp_fixture_sizes_and_kinds(name):
    """image_size of every committed WebP from its headers, equal to the
    manifest's shape (the pixels are held by
    test_torch_image_formats.py::test_fixtures_match_their_manifest)."""
    entry = _manifest_names(FIXTURES)[name]
    path = os.path.join(FIXTURES, name)
    assert list(iio.image_size(path)) == entry["shape"][:2]
    with open(path, "rb") as f:
        assert f.read(4) == b"RIFF"


def test_refine_pair_tree_matches_its_manifest():
    """The committed pair tree (lossy renders, lossless ground truth): each
    file's imageio array matches the manifest (re-derived here), the port
    reads the same, and image_size agrees."""
    manifest = _manifest_names(PAIRS)
    files = sorted(os.path.relpath(os.path.join(r, f), PAIRS) for r, _, fs in os.walk(PAIRS)
                   for f in fs if f.endswith(".webp"))
    assert files == sorted(manifest) and len(files) >= 8
    kinds = set()
    for rel in files:
        path = os.path.join(PAIRS, rel)
        ref = imageio.imread(path)
        entry = manifest[rel]
        assert [list(ref.shape), str(ref.dtype), array_digest(ref)] == \
            [entry["shape"], entry["dtype"], entry["sha256"]], rel
        got = iio.imread(path)
        assert array_digest(got) == entry["sha256"] and got.shape == ref.shape
        assert list(iio.image_size(path)) == entry["shape"][:2]
        with open(path, "rb") as f:
            kinds.add((rel.split(os.sep)[0], chunks_of(f.read())[0][0]))
    assert kinds == {("train", b"VP8 "), ("gt", b"VP8L")}


@pytest.mark.parametrize("flat", [False, True])
def test_refine_pairs_match_jax(flat):
    """The JAX RefinePairDataset and the port's on the WebP pair tree: the
    same pairs, images within 2e-6 (as tests/test_torch_refine_data.py holds
    PNG), flipped and not, at the refiner's load sizes."""
    root = os.path.join(PAIRS, "train", "0", "0") if flat else os.path.join(PAIRS, "train")
    b_root = None if flat else os.path.join(PAIRS, "gt")
    for load in (64, 256):
        j = JPairs(root, b_root, load_size=load, flat=flat)
        t = RefinePairDataset(root, b_root, load_size=load, flat=flat)
        assert t.a_paths == j.a_paths and t.b_paths == j.b_paths and len(t) == len(j) > 0
        for i in range(len(t)):
            for flip in (False, True):
                (ta, tb), (ja, jb) = t.get(i, flip), j.get(i, flip)
                np.testing.assert_allclose(ta, ja, rtol=0, atol=2e-6)
                assert ta.shape == (load, load, 3)
                if jb is None:
                    assert tb is None
                else:
                    np.testing.assert_allclose(tb, jb, rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# the committed files: written here


def _face_render(side, identity, expression, view):
    """A face of the family rasterised at side^2, framed as the formats
    fixtures' canvas photo frames it, turned by `view` degrees."""
    from mofanerf_tpu_torch.datagen.rasterize import rasterize_mesh
    from mofanerf_tpu_torch.datagen.synthetic_faces import face_mesh, sample_identity_params
    from mofanerf_tpu_torch.ops.rays import pose_spherical

    params = sample_identity_params(2, 0)[identity]
    verts, tris, albedo = face_mesh(params, expression)
    f = 1200.0 / 512 * side
    K = np.array([[f, 0, side / 2], [0, f, side / 2], [0, 0, 1]])
    rgb, _, _ = rasterize_mesh(verts, tris, K, pose_spherical(view, -10.0, 16.0), side, side,
                               face_albedo=albedo, device="cpu")
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def webp_fixture_files(photo_jpeg):
    """The committed WebP fixtures of testdata/formats: {name: bytes}. The
    1024^2 photo is photo_1024_progressive.jpg's picture (its bytes given;
    as imageio reads it) re-encoded lossy at quality 80; the 512^2 face
    render is lossless."""
    photo = imageio.imread(io.BytesIO(photo_jpeg))
    render = _face_render(512, 0, 0, 0.0)
    small = content("face", 37, 53, seed=3, channels=4)
    frames = [Image.fromarray(content("smooth", 40, 50, seed=s)) for s in range(2)]
    bio = io.BytesIO()
    frames[0].save(bio, format="WEBP", save_all=True, append_images=frames[1:], quality=70)
    offset = riff(vp8x(50, 40, 0x12), chunk(b"ANIM", bytes(6)),
                  anmf(12, 6, 37, 29, [chunk(t, p) for t, p in
                                        chunks_of(pil_webp(small[:29, :37], quality=75))
                                        if t != b"VP8X"]))
    return {
        "photo_1024_q80.webp": pil_webp(photo, quality=80),
        "face_512_lossless.webp": pil_webp(render, lossless=True),
        "lossy_alpha.webp": pil_webp(small, quality=60),
        "lossless_alpha.webp": pil_webp(small, lossless=True),
        "palette16_lossless.webp": pil_webp(
            np.random.default_rng(5).integers(0, 256, (16, 3), dtype=np.uint8)[
                np.random.default_rng(6).integers(0, 16, (29, 41))], lossless=True),
        "vp8_partitions8.webp": riff(chunk(b"VP8 ", vp8_frame(40, 50, 1, parts=3, skip=80,
                                                              **_vp8_case("segments_delta")))),
        "animation_offset.webp": offset,
        "animation_pillow.webp": bio.getvalue(),
    }


def make_pair_tree(out_dir):
    """The RefineNet pair tree: train/<id>/<exp>/<view>.webp (lossy renders
    at quality 70, the ground truth blurred and shrunk to 128^2 as a NeRF
    render would miss detail) and gt/<id>/<exp>/<view>.webp (lossless 256^2
    face renders), 2 identities x 1 expression x 2 views; manifest.json
    (imageio's shape, dtype, SHA-256)."""
    from mofanerf_tpu_torch.utils.image_io import resize_area_u8

    manifest = {}
    for identity in (0, 1):
        for view in (0, 1):
            gt = _face_render(256, identity, 0, (-20.0, 25.0)[view])
            render = resize_area_u8(gt, (128, 128))
            for sub, data in (("gt", pil_webp(gt, lossless=True)),
                              ("train", pil_webp(render, quality=70))):
                rel = os.path.join(sub, str(identity), "0", f"{view:02d}.webp")
                path = os.path.join(out_dir, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    f.write(data)
                ref = imageio.imread(path)
                manifest[rel] = {"shape": list(ref.shape), "dtype": str(ref.dtype),
                                 "sha256": array_digest(ref)}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    print(json.dumps(make_pair_tree(sys.argv[1]), indent=1))
