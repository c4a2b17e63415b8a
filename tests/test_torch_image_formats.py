"""Every image file the JAX package's readers take, read by the port
(mofanerf_tpu_torch/utils/image_io.py::imread, image_size) against
`imageio.v2.imread` on the same file: the same shape, dtype and values, for
JPEG too (the decoder follows libjpeg-turbo's islow IDCT and upsampling, so
it is held tighter here than the 2-level contract of
tests/test_torch_image_io.py).
Where imageio raises, the port raises a ValueError naming the file.

The files come from Pillow where it can write them, else from the writers
below: `jpeg_file` (sequential SOF0 / SOF1, progressive SOF2 with DC
successive approximation and AC spectral selection with EOB runs, lossless
SOF3; any sampling factors, component ids, colour markers, restart interval
and sample precision; flat Huffman tables), `png_file` (every colour type
and depth, PLTE, tRNS, Adam7, the five row filters in turn) and `bmp_file`
(the 12-byte core header and BITMAPINFOHEADER to V5, 1- to 32-bit,
palettes, BI_BITFIELDS, RLE8 / RLE4, bottom-up or top-down). The committed
fixtures of mofanerf_tpu_torch/testdata/formats/ are held against their
manifest, which is re-derived from imageio here (the WebP fixtures are
written by tests/test_torch_webp.py). Regenerate them (Pillow and imageio
needed; deterministic):

    JAX_PLATFORMS=cpu python -m tests.test_torch_image_formats mofanerf_tpu_torch/testdata/formats
"""
import hashlib
import io
import json
import os
import shutil
import struct
import sys
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from mofanerf_tpu.data import facescape as jfs
from mofanerf_tpu.datagen.synthetic_faces import face_landmarks, sample_identity_params
from mofanerf_tpu.preprocess import pipeline as jpipe
from mofanerf_tpu_torch.data import facescape as tfs
from mofanerf_tpu_torch.preprocess import pipeline as tpipe
from mofanerf_tpu_torch.utils import image_io as iio

FIXTURES = os.path.join(os.path.dirname(iio.__file__), "..", "testdata", "formats")

# ---------------------------------------------------------------------------
# writers of what Pillow cannot write, and the fixtures

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)


def scene(h, w, seed=0, channels=3):
    """Smooth colour ramps with noise: chroma edges and flat areas both."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    planes = [128 + 100 * np.sin(x / 7.0 + y / 11.0), 128 + 90 * np.cos(x / 5.0 - y / 13.0),
              (x * 3 + y * 2) % 256, 128 + 120 * np.sin((x - y) / 9.0)]
    img = np.stack(planes[:channels], -1) + rng.normal(0, 20, (h, w, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# JPEG


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _flat_table(symbols, length):
    """A Huffman table of every symbol at one code length."""
    counts = [0] * 16
    counts[length - 1] = len(symbols)
    codes = {s: (i, length) for i, s in enumerate(symbols)}
    return bytes(counts) + bytes(symbols), codes


DC_TABLE = _flat_table(list(range(16)), 5)
LOSSLESS_TABLE = _flat_table(list(range(17)), 5)   # lossless differences reach 16
AC_TABLE = _flat_table([0xF0] + [r << 4 for r in range(15)]
                       + [(r << 4) | s for r in range(16) for s in range(1, 15)], 8)


def _magnitude(v):
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(marker, body):
    return b"\xff" + bytes([marker]) + struct.pack(">H", len(body) + 2) + body


def _fdct_blocks(plane, bh, bw, q):
    """Quantised DCT coefficients [bh * bw, 64] (zig-zag order) of a plane
    padded by edge replication to bh x bw blocks."""
    h, w = plane.shape
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    m[0] /= np.sqrt(2.0)
    p = np.pad(plane.astype(np.float64), ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge") - 128
    blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    coef = m @ blocks @ m.T
    return np.round(coef / q.reshape(8, 8)).astype(np.int64).reshape(-1, 64)[:, ZIGZAG]


def _block_order(ci, comps, mcus_x, mcus_y, interleaved, sizes):
    """(component index, block row, block col) in scan order, by MCU."""
    if interleaved:
        for my in range(mcus_y):
            for mx in range(mcus_x):
                yield [(c, my * comps[c][1] + dy, mx * comps[c][0] + dx)
                       for c in ci for dy in range(comps[c][1]) for dx in range(comps[c][0])]
    else:
        c = ci[0]
        bh, bw = -(-sizes[c][0] // 8), -(-sizes[c][1] // 8)
        for by in range(bh):
            for bx in range(bw):
                yield [(c, by, bx)]


def jpeg_file(planes, factors=None, ids=None, mode="baseline", scans=None, restart=0,
              precision=8, app=(b"JFIF",), predictor=1, point_transform=0, cut=None):
    """JPEG bytes of component planes (uint8, each at its own sampled size,
    ceil(W * h / hmax) x ceil(H * v / vmax)); `factors` [(h, v)] (default
    1 x 1), `ids` the component ids (default 1, 2, ...), `mode` "baseline"
    (SOF0), "extended" (SOF1), "progressive" (SOF2: `scans` a list of
    (component indices, Ss, Se, Ah, Al); AC scans need Ah = 0) or "lossless"
    (SOF3: `predictor` 1-7, `point_transform`). `app`: b"JFIF" for an APP0
    JFIF marker, ("Adobe", t) for an APP14 Adobe marker of transform t.
    `cut`: keep only this many scans and end the file there (no EOI)."""
    n = len(planes)
    factors = factors or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    H = planes[0].shape[0] * vmax // factors[0][1]
    W = planes[0].shape[1] * hmax // factors[0][0]
    out = bytearray(b"\xff\xd8")
    for a in app:
        if a == b"JFIF":
            out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
        else:
            out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, a[1]))
    base = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
    q = base.astype(np.int64)   # the Annex K luminance table for every component
    sof = {"baseline": 0xC0, "extended": 0xC1, "progressive": 0xC2, "lossless": 0xC3}[mode]
    if mode != "lossless":
        out += _segment(0xDB, b"\x00" + bytes(q[ZIGZAG].astype(np.uint8)))
    body = struct.pack(">BHHB", precision, H, W, n)
    for i in range(n):
        body += bytes([ids[i], (factors[i][0] << 4) | factors[i][1], 0])
    out += _segment(sof, body)
    if mode == "lossless":
        out += _segment(0xC4, b"\x00" + LOSSLESS_TABLE[0])
    else:
        out += _segment(0xC4, b"\x00" + DC_TABLE[0]) + _segment(0xC4, b"\x10" + AC_TABLE[0])
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    mcus_x, mcus_y = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    sizes = [(-(-H * f[1] // vmax), -(-W * f[0] // hmax)) for f in factors]
    if mode == "lossless":
        scans = [(list(range(n)),)]
        coefs = None
    else:
        coefs = [_fdct_blocks(p, mcus_y * f[1], mcus_x * f[0], q).reshape(
            mcus_y * f[1], mcus_x * f[0], 64) for p, f in zip(planes, factors)]
        if scans is None:
            scans = [(list(range(n)), 0, 63, 0, 0)]
    for si, scan in enumerate(scans):
        if cut is not None and si == cut:
            return bytes(out)
        ci = scan[0]
        if mode == "lossless":
            sos = bytes([len(ci)]) + b"".join(bytes([ids[c], 0x00]) for c in ci) \
                + bytes([predictor, 0, point_transform])
            data = _lossless_scan(planes, factors, ci, restart, predictor, point_transform,
                                  precision, W, H, hmax, vmax)
        else:
            ss, se, ah, al = scan[1:]
            sos = bytes([len(ci)]) + b"".join(bytes([ids[c], 0x00]) for c in ci) \
                + bytes([ss, se, (ah << 4) | al])
            interleaved = len(ci) > 1
            data = _dct_scan(coefs, factors, ci, mcus_x, mcus_y, interleaved, sizes, restart,
                             ss, se, ah, al)
        out += _segment(0xDA, sos) + data
    return bytes(out + b"\xff\xd9")


def _dct_scan(coefs, factors, ci, mcus_x, mcus_y, interleaved, sizes, restart, ss, se, ah, al):
    dc_codes, ac_codes = DC_TABLE[1], AC_TABLE[1]
    out = bytearray()
    bits, preds, eobrun = _Bits(), {}, [0]

    def flush_eob():
        if eobrun[0]:
            r = eobrun[0].bit_length() - 1
            bits.put(*ac_codes[r << 4])
            if r:
                bits.put(eobrun[0] - (1 << r), r)
            eobrun[0] = 0

    for m, units in enumerate(_block_order(ci, factors, mcus_x, mcus_y, interleaved, sizes)):
        if restart and m and m % restart == 0:
            flush_eob()
            out += bits.flush() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            bits, preds = _Bits(), {}
        for c, by, bx in units:
            row = coefs[c][by, bx]
            if ss == 0:
                if ah == 0:
                    v = int(row[0]) >> al
                    s, b = _magnitude(v - preds.get(c, 0))
                    preds[c] = v
                    bits.put(*dc_codes[s])
                    if s:
                        bits.put(b, s)
                else:
                    bits.put((int(row[0]) >> al) & 1, 1)
                if se == 0:
                    continue
            # the point transform of an AC coefficient rounds its magnitude down
            band = [(abs(int(v)) >> al) * (1 if v >= 0 else -1) for v in row[max(ss, 1):se + 1]]
            last = max((k for k, v in enumerate(band) if v), default=-1)
            sequential = ss == 0    # a sequential scan: DC and AC, an EOB a block
            if last < 0 and not sequential:
                eobrun[0] += 1
                if eobrun[0] == 0x7FFF:
                    flush_eob()
                continue
            if not sequential:
                flush_eob()
            run = 0
            for v in band[:last + 1]:
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    bits.put(*ac_codes[0xF0])
                    run -= 16
                s, b = _magnitude(v)
                bits.put(*ac_codes[(run << 4) | s])
                bits.put(b, s)
                run = 0
            if last < len(band) - 1:
                if sequential:
                    bits.put(*ac_codes[0x00])
                else:
                    eobrun[0] += 1
    flush_eob()
    return bytes(out + bits.flush())


def _lossless_scan(planes, factors, ci, restart, predictor, pt, precision, W, H, hmax, vmax):
    """One interleaved (or single-component) lossless scan, MCU by MCU as the
    JPEG specification orders samples (H.1.2), restarts resetting the
    predictors to 2^(P - Pt - 1) in their first row."""
    dc_codes = LOSSLESS_TABLE[1]
    bits, out = _Bits(), bytearray()
    vals = [(planes[c].astype(np.int64) >> pt) for c in ci]
    if len(ci) > 1:
        mcus_x, mcus_y = -(-W // hmax), -(-H // vmax)
        padded = [np.pad(v, ((0, mcus_y * factors[c][1] - v.shape[0]),
                             (0, mcus_x * factors[c][0] - v.shape[1])), mode="edge")
                  for v, c in zip(vals, ci)]
    else:
        padded = vals
        mcus_x, mcus_y = vals[0].shape[1], vals[0].shape[0]
    default = 1 << (precision - pt - 1)
    n_mcu = mcus_x * mcus_y
    restart_row = {c: 0 for c in range(len(ci))}
    for m in range(n_mcu):
        if restart and m and m % restart == 0:
            out += bits.flush() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            bits = _Bits()
        my, mx = divmod(m, mcus_x)
        if restart and m % restart == 0:
            for k in restart_row:
                restart_row[k] = my * (factors[ci[k]][1] if len(ci) > 1 else 1)
        for k, c in enumerate(ci):
            hv = factors[c] if len(ci) > 1 else (1, 1)
            p = padded[k]
            for dy in range(hv[1]):
                for dx in range(hv[0]):
                    y, x = my * hv[1] + dy, mx * hv[0] + dx
                    first_row = y == restart_row[k]
                    if first_row and x == 0:
                        pred = default
                    elif first_row:
                        pred = p[y, x - 1]
                    elif x == 0:
                        pred = p[y - 1, x]
                    else:
                        a, b, cc = int(p[y, x - 1]), int(p[y - 1, x]), int(p[y - 1, x - 1])
                        pred = {1: a, 2: b, 3: cc, 4: a + b - cc, 5: a + ((b - cc) >> 1),
                                6: b + ((a - cc) >> 1), 7: (a + b) >> 1}[predictor]
                    d = (int(p[y, x]) - int(pred)) % 65536
                    d = d - 65536 if d >= 32768 else d
                    if d == -32768:
                        bits.put(*dc_codes[16])
                        continue
                    s, b = _magnitude(d)
                    bits.put(*dc_codes[s])
                    if s:
                        bits.put(b, s)
    return bytes(out + bits.flush())


def ycc_planes(img, factors):
    """RGB uint8 [H, W, 3] -> Y, Cb, Cr planes, each box-averaged to its sampled size."""
    x = img.astype(np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    full = [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    return subsample(full, factors)


def subsample(full, factors):
    H, W = full[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    out = []
    for p, (h, v) in zip(full, factors):
        sy, sx = vmax // v, hmax // h
        ch, cw = -(-H * v // vmax), -(-W * h // hmax)
        padded = np.pad(p, ((0, ch * sy - H), (0, cw * sx - W)), mode="edge")
        out.append(np.clip(np.round(padded.reshape(ch, sy, cw, sx).mean((1, 3))), 0, 255
                           ).astype(np.uint8))
    return out


# ---------------------------------------------------------------------------
# PNG

ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]   # (x0, y0, dx, dy)


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _pack_rows(samples, depth):
    """[h, n] samples (n = width x channels) -> rows of bytes at `depth` bits."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    padded = np.zeros((h, -(-n // per) * per), np.int64)
    padded[:, :n] = samples
    g = padded.reshape(h, -1, per)
    shifts = depth * np.arange(per - 1, -1, -1)
    return (g << shifts).sum(-1).astype(np.uint8)


def _filter_rows(rows, bpp, kinds):
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y in range(rows.shape[0]):
        kind = kinds[y % len(kinds)]
        cur = rows[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def png_file(samples, color, depth, palette=None, trns=None, interlace=False,
             kinds=(0, 1, 2, 3, 4)):
    """PNG bytes of integer samples [H, W] or [H, W, C] (palette indices for
    colour type 3), colour type `color`, bit depth `depth`; `palette` [n, 3]
    uint8; `trns` the tRNS chunk's body; row filters `kinds` in turn."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    ch = 1 if s.ndim == 2 else s.shape[2]
    flat = s.reshape(h, w * ch)
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = s[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                raw += _filter_rows(_pack_rows(sub.reshape(sub.shape[0], -1), depth), bpp, kinds)
    else:
        raw = _filter_rows(_pack_rows(flat, depth), bpp, kinds)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                                             0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(raw)
    half = len(z) // 2   # two IDAT chunks
    return out + _chunk(b"IDAT", z[:half]) + _chunk(b"IDAT", z[half:]) + _chunk(b"IEND", b"")


# ---------------------------------------------------------------------------
# BMP


def _rle(rows, rle4):
    """RLE8 / RLE4 pixel data of index rows (bottom-up order given): runs of
    equal pixels encoded, other stretches in absolute mode, a delta escape once,
    an end of line a row and an end of bitmap."""
    out = bytearray()
    for y, row in enumerate(rows):
        row = [int(v) for v in row]
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or len(row) - x < 3:
                n = min(run, len(row) - x)
                val = row[x] if not rle4 else (row[x] << 4) | row[x]
                out += bytes([n, val])
                x += n
                continue
            # absolute mode: up to the next run of 3 or 255 pixels
            end = x
            while end < len(row) and end - x < 254 and not (
                    end + 2 < len(row) and row[end] == row[end + 1] == row[end + 2]):
                end += 1
            n = end - x
            if n < 3:
                out += bytes([1, row[x] if not rle4 else row[x] << 4])
                x += 1
                continue
            if rle4:
                n -= n % 2        # Pillow reads n // 2 bytes of two pixels
                vals = row[x:x + n]
                data = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n, 2))
            else:
                data = bytes(row[x:x + n])
            out += bytes([0, n]) + data
            if len(data) % 2:
                out += b"\x00"
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_file(pixels, bits, palette=None, header=40, compression=0, masks=None,
             top_down=False):
    """BMP bytes. `pixels`: [H, W] indices (bits <= 8) or [H, W, 3 | 4] RGB(A)
    uint8; `palette` [n, 3] RGB; `masks` (r, g, b[, a]) for BI_BITFIELDS
    (compression 3); 16-bit raw pixels are 5-5-5. `header` 12 (OS/2 core),
    40, 108 or 124 bytes."""
    p = np.asarray(pixels)
    h, w = p.shape[:2]
    rows = p[::-1] if not top_down else p
    if bits <= 8:
        if compression in (1, 2):
            data = _rle(rows, compression == 2)
        else:
            data = b"".join(_pack_rows(r[None].astype(np.int64), bits).tobytes().ljust(
                ((w * bits + 31) >> 3) & ~3, b"\x00") for r in rows)
    else:
        px = rows.astype(np.uint32)
        if bits == 16 and masks is None:
            masks = (0x7C00, 0x3E0, 0x1F)
        if bits in (16, 32) and masks is not None:
            val = np.zeros((h, w), np.uint32)
            for c, m in enumerate(masks):
                if m:
                    shift = (m & -m).bit_length() - 1
                    width = bin(m).count("1")
                    val |= ((px[..., c] >> (8 - width)) << shift).astype(np.uint32) & m
            rowbytes = val.astype("<u4").view(np.uint8).reshape(h, w, 4)[..., :bits // 8]
        else:
            bgr = px[..., [2, 1, 0] + ([3] if px.shape[2] == 4 else [])].astype(np.uint8)
            if bits == 32 and bgr.shape[2] == 3:
                bgr = np.concatenate([bgr, np.zeros_like(bgr[..., :1])], -1)
            rowbytes = bgr
        stride = ((w * bits + 31) >> 3) & ~3
        data = b"".join(r.tobytes().ljust(stride, b"\x00") for r in rowbytes)
    pal = b""
    if bits <= 8:
        entry = 3 if header == 12 else 4
        pal = b"".join(bytes([c[2], c[1], c[0]]) + b"\x00" * (entry - 3) for c in
                       np.asarray(palette, np.uint8))
    extra = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835,
                           len(palette) if bits <= 8 else 0, 0)
        if header >= 52:
            m = list(masks or (0, 0, 0)) + [0] * (4 - len(masks or (0, 0, 0)))
            info += struct.pack("<IIII", *m)[:header - 40]
            info = info.ljust(header, b"\x00")
        elif compression == 3:
            extra = struct.pack("<III", *masks[:3])
    offset = 14 + len(info) + len(extra) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
    return head + info + extra + pal + data


# ---------------------------------------------------------------------------
# the committed fixtures


def array_digest(a):
    """SHA-256 of an array's values in C order (bool as 0 / 1 bytes: Pillow's
    1-bit arrays hold 255 for True)."""
    a = np.ascontiguousarray(a, np.uint8 if a.dtype == bool else a.dtype)
    return hashlib.sha256(a.tobytes()).hexdigest()


def _canvas_photo():
    """chip_smoke.py's wild phase's photo A on the CPU: the face family's
    identity 0 (seed 0) rendered frontally at 512^2 and placed by the phase's
    similarity (12 degrees, scale 0.75) into a 640 x 480 canvas; with its
    landmarks (row, col)."""
    import torch

    from mofanerf_tpu_torch.data.landmarks import project_landmarks
    from mofanerf_tpu_torch.datagen.rasterize import rasterize_mesh
    from mofanerf_tpu_torch.datagen.synthetic_faces import (face_landmarks, face_mesh,
                                                           sample_identity_params)
    from mofanerf_tpu_torch.ops.rays import pose_spherical
    from mofanerf_tpu_torch.utils.image_io import warp_affine

    side, canvas_wh, (deg, scale) = 512, (640, 480), (12.0, 0.75)
    params = sample_identity_params(2, 0)
    verts, tris, albedo = face_mesh(params[0], 0)
    K = np.array([[1200.0, 0, side / 2], [0, 1200.0, side / 2], [0, 0, 1]])
    c2w = pose_spherical(0.0, 0.0, 16.0)
    rgb, _, _ = rasterize_mesh(verts, tris, K, c2w, side, side, face_albedo=albedo, device="cpu")
    kp_b = project_landmarks(face_landmarks(params[0], 0).astype(np.float64), K, c2w)
    th = np.deg2rad(deg)
    S = np.array([[scale * np.cos(th), -scale * np.sin(th), 0.0],
                  [scale * np.sin(th), scale * np.cos(th), 0.0]])
    S[:, 2] = np.array([canvas_wh[0] / 2 + 40, canvas_wh[1] / 2 - 10]) \
        - S[:, :2] @ np.array([side / 2, side / 2])
    canvas = warp_affine(torch.from_numpy(rgb), S, canvas_wh).numpy()
    kp = (np.concatenate([kp_b[:, ::-1], np.ones((68, 1))], 1) @ S.T)[:, ::-1]
    return (np.clip(canvas, 0, 1) * 255).astype(np.uint8), kp


def make_fixtures(out_dir):
    """Write the committed format fixtures and manifest.json (each file's
    shape, dtype and the SHA-256 of `imageio.v2.imread`'s array)."""
    import imageio.v2 as imageio
    from PIL import Image

    from mofanerf_tpu_torch.datagen.synthetic_faces import face_uv_map, sample_identity_params

    os.makedirs(out_dir, exist_ok=True)
    files = {}

    def pil(name, img, **kw):
        bio = io.BytesIO()
        Image.fromarray(img).save(bio, **kw)
        files[name] = bio.getvalue()

    canvas, kp = _canvas_photo()
    pil("D.jpg", canvas, format="JPEG", quality=90, progressive=True, subsampling=2)
    np.save(os.path.join(out_dir, "kp_D.npy"), kp)
    uv = face_uv_map(sample_identity_params(2, 0)[0], 0, 512)
    pil("uv_progressive.jpg", (np.clip(uv, 0, 1) * 255).astype(np.uint8), format="JPEG",
        quality=90, progressive=True, subsampling=2)
    # a smooth photo (the identity's UV map at 1024^2, mild noise) for the decode timing
    photo = np.clip(face_uv_map(sample_identity_params(2, 0)[1], 1, 1024) * 255
                    + np.random.default_rng(7).normal(0, 3, (1024, 1024, 3)), 0, 255
                    ).astype(np.uint8)
    pil("photo_1024_progressive.jpg", photo, format="JPEG", quality=90, progressive=True,
        subsampling=2)
    pil("photo_1024_baseline.jpg", photo, format="JPEG", quality=90, subsampling=2)
    # arithmetic coding and block smoothing: written by tests/test_torch_jpeg_arith.py
    from tests.test_torch_jpeg_arith import arith_fixture_files
    files.update(arith_fixture_files(canvas, uv, photo, files["D.jpg"]))
    # broken-off scans: written by tests/test_torch_jpeg_broken.py
    from tests.test_torch_jpeg_broken import broken_fixture_files
    files.update(broken_fixture_files(canvas, files["D.jpg"]))
    for name in ("E", "F", "G"):
        np.save(os.path.join(out_dir, f"kp_{name}.npy"), kp)
    rng = np.random.default_rng(3)
    img = scene(23, 29, seed=4)
    gray = img[..., 0]
    # PNG: every row of the port's table
    g16 = (gray.astype(np.uint16) * 257 + rng.integers(0, 257, gray.shape)).astype(np.uint16)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = rng.integers(0, 16, gray.shape)
    files["gray1.png"] = png_file(gray >> 7, 0, 1)
    files["gray2.png"] = png_file(gray >> 6, 0, 2)
    files["gray4_adam7.png"] = png_file(gray >> 4, 0, 4, interlace=True)
    files["gray16.png"] = png_file(g16, 0, 16)
    files["rgb16.png"] = png_file(img.astype(np.uint16) * 257 + 3, 2, 16)
    files["rgba16_adam7.png"] = png_file(np.concatenate([img, gray[..., None]], -1).astype(
        np.uint16) * 256 + 77, 6, 16, interlace=True)
    files["graya16.png"] = png_file(np.stack([g16, 65535 - g16], -1), 4, 16)
    files["palette4_trns.png"] = png_file(idx, 3, 4, palette=pal, trns=bytes(range(0, 160, 10)))
    files["palette8.png"] = png_file(idx, 3, 8, palette=pal)
    files["gray8_trns.png"] = png_file(gray, 0, 8, trns=b"\x00\x80")
    # BMP: every variant the port reads beyond 8-, 24- and 32-bit raw
    files["pal1.bmp"] = bmp_file(gray >> 7, 1, palette=pal[:2])
    files["pal4.bmp"] = bmp_file(idx, 4, palette=pal)
    files["rgb555.bmp"] = bmp_file(img, 16)
    files["rgb565.bmp"] = bmp_file(img, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F))
    files["bgra32_bitfields.bmp"] = bmp_file(
        np.concatenate([img, gray[..., None]], -1), 32, header=124, compression=3,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    files["rle8.bmp"] = bmp_file(idx * 3, 8, palette=rng.integers(0, 256, (48, 3), np.uint8),
                                 compression=1)
    files["rle4.bmp"] = bmp_file(idx, 4, palette=pal, compression=2)
    files["os2_core24.bmp"] = bmp_file(img, 24, header=12)
    # WebP: written by tests/test_torch_webp.py
    from tests.test_torch_webp import webp_fixture_files
    files.update(webp_fixture_files(files["photo_1024_progressive.jpg"]))
    manifest = {}
    for name, data in sorted(files.items()):
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        ref = imageio.imread(path)
        manifest[name] = {"shape": list(ref.shape), "dtype": str(ref.dtype),
                          "sha256": array_digest(ref)}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


# ---------------------------------------------------------------------------
# the port against imageio


def _check(path):
    """The port's array against imageio's, equal in shape, dtype and every
    value (JPEG too), and image_size against its shape."""
    ref = imageio.imread(path)
    got = iio.imread(str(path))
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)
    assert iio.image_size(str(path)) == ref.shape[:2]
    return got


def _both_raise(path):
    with pytest.raises(Exception):
        imageio.imread(path)
    with pytest.raises(ValueError, match=os.path.basename(str(path)).replace(".", r"\.")):
        iio.imread(str(path))


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return path


def _pil_jpeg(tmp_path, name, img, **kw):
    path = tmp_path / name
    Image.fromarray(img).save(path, format="JPEG", **kw)
    return path


# ---------------------------------------------------------------------------
# JPEG

@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("shape", [(37, 53), (9, 15), (64, 64)])
@pytest.mark.parametrize("restart", [None, "blocks", "rows"])
def test_progressive_jpeg_matches_imageio(tmp_path, subsampling, shape, restart):
    """Pillow's progressive script: DC first and refinement, AC bands with
    successive approximation and EOB runs, AC refinement; restart intervals
    in every scan when asked."""
    kw = {None: {}, "blocks": dict(restart_marker_blocks=3), "rows": dict(restart_marker_rows=1)}
    for k, img in enumerate([scene(*shape), np.random.default_rng(2).integers(
            0, 256, shape + (3,), np.uint8)]):
        path = _pil_jpeg(tmp_path, f"{k}.jpg", img, quality=80, progressive=True,
                         subsampling=subsampling, **kw[restart])
        if restart:
            assert b"\xff\xdd" in path.read_bytes()
        _check(path)


@pytest.mark.parametrize("quality", [30, 95])
def test_progressive_gray_and_cmyk(tmp_path, quality):
    img = scene(29, 41)
    _check(_pil_jpeg(tmp_path, "g.jpg", img[..., 0], quality=quality, progressive=True))
    cmyk = Image.fromarray(scene(29, 41, channels=4), mode="CMYK")
    cmyk.save(tmp_path / "c.jpg", quality=quality, progressive=True)
    _check(tmp_path / "c.jpg")


SCRIPTS = {
    # non-interleaved DC scans, DC successive approximation, spectral bands
    "dc_each": [([0], 0, 0, 0, 1), ([1], 0, 0, 0, 0), ([2], 0, 0, 0, 0), ([0], 0, 0, 1, 0),
                ([0], 1, 63, 0, 0), ([1], 1, 9, 0, 0), ([1], 10, 63, 0, 0), ([2], 1, 63, 0, 0)],
    "bands": [([0, 1, 2], 0, 0, 0, 2), ([0], 1, 2, 0, 0), ([0], 3, 20, 0, 0),
              ([0], 21, 63, 0, 0), ([0, 1, 2], 0, 0, 2, 1), ([2], 1, 63, 0, 0),
              ([1], 1, 63, 0, 0), ([0, 1, 2], 0, 0, 1, 0)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("factors", [[(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)],
                                     [(1, 2), (1, 1), (1, 1)], [(3, 1), (1, 1), (1, 1)]],
                         ids=["444", "420", "440", "h3"])
@pytest.mark.parametrize("restart", [0, 2])
def test_progressive_scripts(tmp_path, script, factors, restart):
    """Scan scripts Pillow does not write, at sampling factors it does not write."""
    img = scene(23, 37, seed=1)
    data = jpeg_file(ycc_planes(img, factors), factors=factors, mode="progressive",
                     scans=SCRIPTS[script], restart=restart)
    _check(_write(tmp_path, "p.jpg", data))


def test_extended_sequential_sof1(tmp_path):
    img = scene(21, 30)
    data = jpeg_file(ycc_planes(img, [(2, 1), (1, 1), (1, 1)]), factors=[(2, 1), (1, 1), (1, 1)],
                     mode="extended", restart=4)
    assert data[data.index(b"\xff\xc1"):][:2] == b"\xff\xc1"
    _check(_write(tmp_path, "e.jpg", data))


FACTORS = [[(1, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)], [(2, 2), (1, 1), (1, 1)],
           [(4, 1), (1, 1), (1, 1)], [(1, 4), (1, 1), (1, 1)], [(3, 1), (1, 1), (1, 1)],
           [(4, 2), (1, 1), (1, 1)], [(2, 4), (1, 1), (1, 1)], [(3, 2), (1, 1), (1, 1)],
           [(4, 1), (2, 1), (1, 1)], [(2, 2), (1, 2), (2, 1)], [(1, 1), (2, 2), (1, 1)],
           [(3, 2), (1, 1), (3, 1)], [(2, 2), (2, 2), (1, 1)], [(1, 3), (1, 1), (1, 1)]]


@pytest.mark.parametrize("factors", FACTORS, ids=lambda f: "_".join(f"{h}{v}" for h, v in f))
@pytest.mark.parametrize("shape", [(37, 53), (9, 15), (2, 3)])
def test_every_sampling_factor(tmp_path, factors, shape):
    """Fancy h2v1, h1v2, h2v2 and box replication for every other integral
    ratio, each component on its own ratio to the frame's maxima."""
    img = scene(*shape, seed=3)
    data = jpeg_file(ycc_planes(img, factors), factors=factors)
    _check(_write(tmp_path, "s.jpg", data))


@pytest.mark.parametrize("factors", [[(3, 1), (2, 1), (1, 1)], [(4, 2), (2, 1), (1, 1)],
                                     [(4, 4), (2, 2), (1, 1)], [(3, 3), (1, 1), (1, 1)],
                                     [(2, 2), (2, 2), (2, 2)]],
                         ids=["non_integral", "11_units", "21_units", "11_units_3x3",
                              "12_units"])
def test_sampling_factors_imageio_refuses(tmp_path, factors):
    """A ratio that is not an integer, and MCUs of more than 10 data units."""
    img = scene(16, 24)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    planes = [img[:-(-16 * v // vmax), :-(-24 * h // hmax), i] for i, (h, v) in enumerate(factors)]
    data = jpeg_file(planes, factors=factors)
    _both_raise(_write(tmp_path, "n.jpg", data))


@pytest.mark.parametrize("case", ["cmyk_pillow", "cmyk_plain", "cmyk_adobe0", "ycck",
                                  "ycck_420", "rgb_adobe", "rgb_ids", "adobe0_jfif",
                                  "ycc_no_marker"])
def test_colour_spaces(tmp_path, case):
    """4 components as CMYK (inverted, as Pillow returns it) or YCCK by the
    Adobe marker; 3 components as RGB or YCbCr as libjpeg picks."""
    img = scene(19, 27, channels=4)
    f3 = [(1, 1)] * 3
    if case == "cmyk_pillow":
        Image.fromarray(img, mode="CMYK").save(tmp_path / "x.jpg", quality=85)
        path = tmp_path / "x.jpg"
    else:
        planes = {"cmyk_plain": ([img[..., i] for i in range(4)], [(1, 1)] * 4, (), None),
                  "cmyk_adobe0": ([img[..., i] for i in range(4)], [(1, 1)] * 4,
                                  (("Adobe", 0),), None),
                  "ycck": (ycc_planes(img[..., :3], f3) + [img[..., 3]], [(1, 1)] * 4,
                           (("Adobe", 2),), None),
                  "ycck_420": (subsample(
                      [p.astype(np.float64) for p in ycc_planes(img[..., :3], f3)]
                      + [img[..., 3].astype(np.float64)], [(2, 2), (1, 1), (1, 1), (2, 2)]),
                      [(2, 2), (1, 1), (1, 1), (2, 2)], (("Adobe", 2),), None),
                  "rgb_adobe": ([img[..., i] for i in range(3)], f3, (("Adobe", 0),), None),
                  "rgb_ids": ([img[..., i] for i in range(3)], f3, (), [82, 71, 66]),
                  "adobe0_jfif": (ycc_planes(img[..., :3], f3), f3, (b"JFIF", ("Adobe", 0)),
                                  None),
                  "ycc_no_marker": (ycc_planes(img[..., :3], f3), f3, (), None)}[case]
        data = jpeg_file(planes[0], factors=planes[1], app=planes[2], ids=planes[3])
        path = _write(tmp_path, "x.jpg", data)
    got = _check(path)
    assert got.shape[2] == (4 if "cmyk" in case or "ycck" in case else 3)


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_gray_every_predictor(tmp_path, predictor):
    img = scene(13, 22)[..., 1]
    for pt, restart in ((0, 0), (2, 44)):
        data = jpeg_file([img], mode="lossless", predictor=predictor, point_transform=pt,
                         restart=restart, app=())
        _check(_write(tmp_path, f"l{pt}.jpg", data))


@pytest.mark.parametrize("case", ["rgb", "rgb_420", "cmyk"])
def test_lossless_colour(tmp_path, case):
    img = scene(13, 22, channels=4)
    f = {"rgb": [(1, 1)] * 3, "rgb_420": [(2, 2), (1, 1), (1, 1)], "cmyk": [(1, 1)] * 4}[case]
    planes = subsample([img[..., i].astype(np.float64) for i in range(len(f))], f)
    data = jpeg_file(planes, factors=f, mode="lossless", predictor=4,
                     app=(("Adobe", 0),) if case != "cmyk" else ())
    _check(_write(tmp_path, "l.jpg", data))


@pytest.mark.parametrize("case", ["precision12", "lossless_ycc", "lossless_restart",
                                  "truncated", "truncated_progressive", "two_components"])
def test_jpegs_imageio_refuses(tmp_path, case):
    img = scene(16, 24)
    f3 = [(1, 1)] * 3
    if case == "precision12":
        data = jpeg_file(ycc_planes(img, f3), mode="extended", precision=12)
    elif case == "lossless_ycc":
        data = jpeg_file(ycc_planes(img, f3), mode="lossless")
    elif case == "lossless_restart":    # not a whole number of MCU rows
        data = jpeg_file([img[..., 0]], mode="lossless", restart=5, app=())
    elif case == "truncated":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG")
        data = buf.getvalue()[:len(buf.getvalue()) * 2 // 3]
    elif case == "truncated_progressive":
        buf = io.BytesIO()
        Image.fromarray(scene(48, 48)).save(buf, format="JPEG", progressive=True)
        data = buf.getvalue()[:len(buf.getvalue()) - 40]
    else:
        data = jpeg_file([img[..., 0], img[..., 1]])
    _both_raise(_write(tmp_path, "x.jpg", data))


def test_progressive_needing_block_smoothing_raises(tmp_path, monkeypatch):
    """A progressive file that ends (with EOI) before its last scans leaves
    coefficient bits unknown: libjpeg smooths its blocks, and the port reads
    it as imageio does, smoothing included (without the smoothing the
    pixels differ). The name is from when the port refused such files."""
    img = scene(32, 40)
    data = jpeg_file(ycc_planes(img, [(1, 1)] * 3), mode="progressive",
                     scans=SCRIPTS["bands"], cut=5) + b"\xff\xd9"
    path = _write(tmp_path, "s.jpg", data)
    assert imageio.imread(path).shape == (32, 40, 3)
    got = _check(path)
    from mofanerf_tpu_torch.utils import jpeg
    monkeypatch.setattr(jpeg, "_smoothing_ok", lambda comps: False)
    assert (iio.imread(str(path)) != got).any()


def test_arithmetic_coding_raises(tmp_path):
    """A Huffman-coded scan under an arithmetic-coded frame header (SOF9):
    the arithmetic decoder reads the Huffman bits as libjpeg's does, and the
    port returns imageio's array (the name is from when the port refused
    SOF9); the header gives the size either way."""
    data = jpeg_file(ycc_planes(scene(16, 16), [(1, 1)] * 3))
    data = data.replace(b"\xff\xc0", b"\xff\xc9", 1)
    path = _write(tmp_path, "a.jpg", data)
    _check(path)
    assert iio.image_size(str(tmp_path / "a.jpg")) == (16, 16)


# ---------------------------------------------------------------------------
# PNG

PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _png_samples(color, depth, h, w, rng):
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    top = (1 << depth) if color != 3 else min(1 << depth, 12)
    s = rng.integers(0, top, (h, w, ch))
    return s[..., 0] if ch == 1 else s


def _trns(color, depth, rng):
    if color == 3:
        return bytes(rng.integers(0, 256, 7, dtype=np.uint8))
    if color == 0:
        return (1 % (1 << depth)).to_bytes(2, "big")
    if color == 2:
        return b"\x00\x01\x00\x02\x00\x03"
    return None


@pytest.mark.parametrize("kind", PNG_KINDS, ids=lambda k: f"c{k[0]}d{k[1]}")
@pytest.mark.parametrize("interlace", [False, True], ids=["flat", "adam7"])
def test_png_every_colour_type_and_depth(tmp_path, kind, interlace):
    """Every legal (colour type, depth), with and without tRNS, flat and
    Adam7, at sizes where Adam7's passes are empty (1 x 1, 3 x 2, 7 x 5)."""
    color, depth = kind
    rng = np.random.default_rng(color * 100 + depth)
    palette = rng.integers(0, 256, (12, 3), dtype=np.uint8) if color == 3 else None
    for h, w in ((23, 29), (1, 1), (3, 2), (7, 5), (2, 9)):
        s = _png_samples(color, depth, h, w, rng)
        for trns in (None, _trns(color, depth, rng)):
            if trns is None and h == 1 and w == 1 and color == 4:
                continue
            data = png_file(s, color, depth, palette=palette, trns=trns, interlace=interlace)
            _check(_write(tmp_path, f"p{h}x{w}.png", data))


def test_png_adam7_passes_skip_empty_ones():
    """The passes' sizes as the writer makes them: the 1 x 1 file holds one
    pass of one row, the 3 x 2 file four passes."""
    assert [((1 - y0 + dy - 1) // dy, (1 - x0 + dx - 1) // dx) for x0, y0, dx, dy in ADAM7
            ].count((1, 1)) == 1
    passes = [(max(0, -(-(3 - y0) // dy)), max(0, -(-(2 - x0) // dx))) for x0, y0, dx, dy in ADAM7]
    assert sum(1 for ph, pw in passes if ph and pw) == 4


def test_png_pillow_files(tmp_path):
    img = scene(17, 23)
    for mode, arr in (("1", img[..., 0] > 128), ("L", img[..., 0]), ("LA", img[..., :2]),
                      ("I;16", img[..., 0].astype(np.uint16) * 250)):
        Image.fromarray(arr, mode=None if mode != "I;16" else "I;16").save(tmp_path / "a.png")
        _check(tmp_path / "a.png")
    Image.fromarray(img).quantize(5).save(tmp_path / "p.png", bits=4)
    _check(tmp_path / "p.png")
    Image.fromarray(img).save(tmp_path / "t.png", transparency=(1, 2, 3))
    _check(tmp_path / "t.png")


# ---------------------------------------------------------------------------
# BMP

BMP_CASES = ["pal1", "bw1", "pal4", "gray4", "pal8", "rgb555", "rgb565", "bf555", "rgb24_bf",
             "v4_rgb24", "v5_bgra"]


@pytest.mark.parametrize("case,top_down", [(c, t) for c in BMP_CASES for t in (False, True)]
                         + [(c, False) for c in ("rle8", "rle4", "rle8_gray", "os2_pal1",
                                                 "os2_pal4", "os2_pal8", "os2_24")])
def test_bmp_variants(tmp_path, case, top_down):
    """1- and 4-bit palettes, 16-bit 5-5-5 and 5-6-5, BI_BITFIELDS, RLE8 and
    RLE4, the OS/2 core header, V4 and V5 headers; odd widths (padded rows);
    bottom-up, and top-down where the header allows it."""
    rng = np.random.default_rng(7)
    img = scene(13, 11, seed=5)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = rng.integers(0, 16, (13, 11))
    idx[3, :] = 5      # long runs for the run-length encoders
    gray16 = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
    kw = dict(top_down=top_down)
    data = {
        "pal1": lambda: bmp_file(idx % 2, 1, palette=pal[:2], **kw),
        "bw1": lambda: bmp_file(idx % 2, 1, palette=np.array([[0] * 3, [255] * 3]), **kw),
        "pal4": lambda: bmp_file(idx, 4, palette=pal, **kw),
        "gray4": lambda: bmp_file(idx[:, :3], 4, palette=gray16, **kw),
        "pal8": lambda: bmp_file(idx * 9, 8, palette=rng.integers(0, 256, (144, 3), np.uint8),
                                 **kw),
        "rle8": lambda: bmp_file(idx * 9, 8, palette=rng.integers(0, 256, (144, 3), np.uint8),
                                 compression=1),
        "rle4": lambda: bmp_file(idx, 4, palette=pal, compression=2),
        "rle8_gray": lambda: bmp_file(idx, 8, palette=gray16, compression=1),
        "rgb555": lambda: bmp_file(img, 16, **kw),
        "rgb565": lambda: bmp_file(img, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F), **kw),
        "bf555": lambda: bmp_file(img, 16, compression=3, masks=(0x7C00, 0x3E0, 0x1F), **kw),
        "rgb24_bf": lambda: bmp_file(img, 24, compression=3, masks=(0xFF0000, 0xFF00, 0xFF),
                                     **kw),
        "os2_pal1": lambda: bmp_file(idx % 2, 1, palette=pal[:2], header=12),
        "os2_pal4": lambda: bmp_file(idx, 4, palette=pal, header=12),
        "os2_pal8": lambda: bmp_file(idx, 8, palette=pal, header=12),
        "os2_24": lambda: bmp_file(img, 24, header=12),
        "v4_rgb24": lambda: bmp_file(img, 24, header=108, **kw),
        "v5_bgra": lambda: bmp_file(np.concatenate([img, img[..., :1]], -1), 32, header=124,
                                    compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                    **kw),
    }[case]()
    _check(_write(tmp_path, "b.bmp", data))


@pytest.mark.parametrize("masks", [(0xFF0000, 0xFF00, 0xFF, 0x0),
                                   (0xFF000000, 0xFF0000, 0xFF00, 0x0),
                                   (0xFF000000, 0xFF00, 0xFF, 0x0),
                                   (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                                   (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                                   (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)],
                         ids=lambda m: "_".join(f"{v:x}" for v in m))
def test_bmp_32bit_bitfields(tmp_path, masks):
    img = np.concatenate([scene(9, 7), scene(9, 7, seed=2)[..., :1]], -1)
    data = bmp_file(img, 32, header=124, compression=3, masks=masks)
    _check(_write(tmp_path, "b.bmp", data))


def test_bmp_unsupported_layouts_raise(tmp_path):
    img = scene(6, 5)
    _both_raise(_write(tmp_path, "m.bmp", bmp_file(img, 16, compression=3,
                                                   masks=(0xF00, 0xF0, 0xF))))
    data = bytearray(bmp_file(img, 24))
    data[28:30] = (2).to_bytes(2, "little")      # 2 bits a pixel
    _both_raise(_write(tmp_path, "d.bmp", bytes(data)))


# ---------------------------------------------------------------------------
# the committed fixtures


def test_fixtures_match_their_manifest():
    """Each committed file: imageio's array matches the manifest (re-derived
    here, so it cannot drift), and the port reads the same array, by hash,
    and size."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    names = sorted(n for n in os.listdir(FIXTURES) if n != "manifest.json"
                   and not n.endswith(".npy"))
    assert names == sorted(manifest)
    for name in names:
        path = os.path.join(FIXTURES, name)
        ref = imageio.imread(path)
        entry = manifest[name]
        assert [list(ref.shape), str(ref.dtype), array_digest(ref)] == \
            [entry["shape"], entry["dtype"], entry["sha256"]], name
        got = _check(path)
        assert array_digest(got) == entry["sha256"], name
    for name in "DEFG":
        kp = np.load(os.path.join(FIXTURES, f"kp_{name}.npy"))
        assert kp.shape == (68, 2) and np.isfinite(kp).all()


# ---------------------------------------------------------------------------
# the slice: the JAX package's readers and the port's on the same files


def _fixture_images():
    return sorted(n for n in os.listdir(FIXTURES) if not n.endswith((".json", ".npy")))


@pytest.mark.parametrize("name", _fixture_images())
def test_read_image_matches_jax(name):
    """data/facescape.py::read_image of both packages on every committed file:
    as a frame (alpha dropped, or composited over white) and as a UV map
    resized to 64^2 (cv2's INTER_AREA against the port's, atol 1e-5 of the
    values' scale: a 16-bit PNG divided by 255 reaches 257)."""
    path = os.path.join(FIXTURES, name)
    for white in (False, True):
        want = jfs.read_image(path, white_bkgd=white)
        got = tfs.read_image(path, white_bkgd=white)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    want = jfs.read_image(path, is_uvmap=True, uv_size=64)
    np.testing.assert_allclose(tfs.read_image(path, is_uvmap=True, uv_size=64), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _wild_pipeline_matches_jax(tmp_path, capsys, name):
    """preprocess_dir of both packages on the committed photo `name`.jpg
    and its landmarks, without networks: the same files, poses within 1e-6,
    PNGs within 1 level (as tests/test_torch_wild_preprocess.py holds the
    pipeline)."""
    lm3d = face_landmarks(sample_identity_params(2, 0)[1], 0).astype(np.float64)
    dirs = {k: tmp_path / k for k in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
        for f in (f"{name}.jpg", f"kp_{name}.npy"):
            shutil.copy(os.path.join(FIXTURES, f), d / f)
    jpipe.preprocess_dir(str(dirs["jax"]), landmarks_3d=lm3d)
    tpipe.preprocess_dir(str(dirs["port"]), landmarks_3d=lm3d, device="cpu")
    capsys.readouterr()
    listing = {k: sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
                         for f in fs) for k, d in dirs.items()}
    assert listing["port"] == listing["jax"]
    pj, pt = (np.load(d / f"pose_{name}.npy", allow_pickle=True).item() for d in dirs.values())
    for k in ("pose", "kp"):
        np.testing.assert_allclose(pt[k], pj[k], rtol=0, atol=1e-6)
    for sub in ("raw", "mask", "segRes", "segRelRes"):
        a, b = (iio.imread(str(d / sub / f"{name}.png")).astype(int) for d in dirs.values())
        assert a.shape == b.shape == (512, 512, 3) or a.shape == b.shape == (512, 512)
        assert np.abs(a - b).max() <= 1, sub


def test_wild_pipeline_on_the_progressive_photo_matches_jax(tmp_path, capsys):
    """The progressive 4:2:0 photo D.jpg (chip_smoke.py's canvas)."""
    _wild_pipeline_matches_jax(tmp_path, capsys, "D")


@pytest.mark.parametrize("name", ["E", "F"], ids=["arithmetic", "smoothed"])
def test_wild_pipeline_on_the_arithmetic_and_smoothed_photos_matches_jax(tmp_path, capsys,
                                                                          name):
    """E.jpg (D's canvas, progressive arithmetic-coded) and F.jpg (D.jpg ended
    before its last refinement scans, smoothed by libjpeg as it reads it)."""
    _wild_pipeline_matches_jax(tmp_path, capsys, name)


def test_wild_pipeline_on_the_broken_scan_photo_matches_jax(tmp_path, capsys):
    """G.jpg (D.jpg with a stretch of a middle scan's data cut out, read as
    libjpeg reads a scan that breaks off)."""
    _wild_pipeline_matches_jax(tmp_path, capsys, "G")


if __name__ == "__main__":
    print(json.dumps(make_fixtures(sys.argv[1]), indent=1))
