"""Image files without imageio, Pillow or OpenCV: the port's counterpart of
the `imageio.imread` / `imageio.imwrite` / `cv2.resize(INTER_AREA)` calls
of mofanerf_tpu/data/facescape.py.

- PNG: 8-bit gray, RGB and RGBA, non-interlaced, read with `zlib` and
  numpy un-filtering; RGB written unfiltered.
- JPEG: a baseline (sequential Huffman) decoder for gray and YCbCr at
  4:4:4, 4:2:2 and 4:2:0, with restart intervals. It follows libjpeg's
  defaults, which is what `imageio` reads JPEG through (Pillow): the
  integer "islow" IDCT, "fancy" triangular chroma upsampling and the
  fixed-point YCbCr -> RGB transform, all in integer arithmetic, vectorised
  over blocks. The Huffman stage is pure Python. Progressive files raise.
- A small baseline JPEG encoder (4:4:4, the standard quantisation and
  Huffman tables of the JPEG specification, Annex K).
- `resize_area`: `cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`
  for float images, area-weighted when shrinking, OpenCV's INTER_AREA
  coefficients when enlarging.
- `resize_linear`: `cv2.resize(img, (w, h))` at its default INTER_LINEAR for
  float images: two taps an axis, no antialiasing.
- BMP: uncompressed 24- and 32-bit and 8-bit paletted files, bottom-up or
  top-down, read as Pillow reads them.
- On tensors, on whichever device they lie: `warp_affine`
  (`cv2.warpAffine(img, M, size, flags=INTER_LINEAR)` on float32 images, with
  a constant border of 0, in cv2's float32 arithmetic) and `rgb_to_lab_u8` / `lab_to_rgb_u8` (cv2's 8-bit
  `COLOR_RGB2LAB` / `COLOR_LAB2RGB`, byte for byte).
"""
from __future__ import annotations

import functools
import struct
import zlib
from array import array

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# ---------------------------------------------------------------------------
# PNG


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 image as a PNG (standard library only): [H, W] gray,
    [H, W, 3] RGB or [H, W, 4] RGBA."""
    h, w = img.shape[:2]
    color = {1: 0, 3: 2, 4: 6}[1 if img.ndim == 2 else img.shape[2]]
    raw = b"".join(b"\x00" + np.ascontiguousarray(img[i]).tobytes() for i in range(h))
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}   # color type -> channels (gray, RGB, RGBA)


def _unfilter_sequential(kind: int, line: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) rows, in place: each byte needs the one
    decoded bpp bytes to its left."""
    for x in range(len(line)):
        a = line[x - bpp] if x >= bpp else 0
        b = prev[x]
        if kind == 3:
            line[x] = (line[x] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            line[x] = (line[x] + pred) & 0xFF


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS:
        raise ValueError(f"PNG of bit depth {depth}, color type {color}: only 8-bit gray, "
                         "RGB and RGBA are read")
    if interlace:
        raise ValueError("interlaced PNG is not read")
    bpp = _PNG_CHANNELS[color]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:     # Sub: a running sum over the pixels, per channel, mod 256
            out[y] = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:     # Up
            out[y] = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_sequential(kind, buf, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0-4")
        prev = out[y]
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


# ---------------------------------------------------------------------------
# JPEG: tables

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# Annex K.1 quantisation tables (natural order)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_Q_CHROMA = np.full(64, 99, np.int64)
_Q_CHROMA.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                   [24, 26, 56, 99], [47, 66, 99, 99]]


def _ac_values(head):
    """Annex K.3 AC symbol lists: the listed head, then every other run/size
    symbol in increasing order."""
    symbols = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
    return list(head) + sorted(set(symbols) - set(head))


# Annex K.3 Huffman tables: (code counts by length 1..16, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_values([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
    0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82]))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_values([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
    0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
    0xF1]))


def _canonical_codes(counts, symbols):
    """[(symbol, code, length)] of a JPEG Huffman table (Annex C)."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((symbols[k], code, length))
            code += 1
            k += 1
        code <<= 1
    return out


def _lookup_table(counts, symbols):
    """A 65536-entry table: the next 16 bits of the stream -> length << 8 | symbol
    (0 where no code matches)."""
    lut = [0] * 65536
    for sym, code, length in _canonical_codes(counts, symbols):
        start = code << (16 - length)
        lut[start:start + (1 << (16 - length))] = [(length << 8) | sym] * (1 << (16 - length))
    return lut


# ---------------------------------------------------------------------------
# JPEG: integer IDCT (libjpeg's jidctint.c "islow"), vectorised over blocks

_CONST_BITS, _PASS1_BITS = 13, 2
_F = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
      "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
      "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(s):
    """One pass of jidctint.c over axis -2 of int64 [..., 8, 8] (rows 0..7 of
    the axis are the 8 inputs); returns the 8 outputs before descaling."""
    z2, z3 = s[..., 2, :], s[..., 6, :]
    z1 = (z2 + z3) * _F["0_541196100"]
    tmp2 = z1 - z3 * _F["1_847759065"]
    tmp3 = z1 + z2 * _F["0_765366865"]
    tmp0 = (s[..., 0, :] + s[..., 4, :]) << _CONST_BITS
    tmp1 = (s[..., 0, :] - s[..., 4, :]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = s[..., 7, :], s[..., 5, :], s[..., 3, :], s[..., 1, :]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=-2)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients int [B, 8, 8] (natural order, [v, u]) ->
    samples uint8 [B, 8, 8], bit for bit as libjpeg's jpeg_idct_islow."""
    c = coef.astype(np.int64)
    ws = _descale(_idct_1d(c), _CONST_BITS - _PASS1_BITS)                   # columns
    out = _descale(_idct_1d(ws.swapaxes(-1, -2)), _CONST_BITS + _PASS1_BITS + 3)
    out = out.swapaxes(-1, -2)
    # libjpeg's range-limit table: the value taken mod 1024 into [-512, 511], + 128, clamped
    out = ((out + 512) & 1023) - 512
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# JPEG: upsampling and colour (libjpeg's jdsample.c "fancy" and jdcolor.c)


def _upsample_h2(x: np.ndarray, width: int) -> np.ndarray:
    """h2v1 fancy upsampling along axis 1 of int [H, w] (w = the component's
    real width): 3/4 nearer + 1/4 further sample, ends copied."""
    if width <= 2:      # libjpeg replicates when the row is this short
        return np.repeat(x[:, :width], 2, axis=1)
    x = x[:, :width].astype(np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * width), np.int64)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0], out[:, -1] = x[:, 0], x[:, -1]
    return out


def _upsample_h2v2(x: np.ndarray, height: int, width: int) -> np.ndarray:
    """h2v2 fancy upsampling of int [H, W] at the component's real size:
    vertical 3:1 column sums, then a horizontal 3:1 blend with libjpeg's
    rounding (8 and 7); the rows beyond each edge repeat the edge row."""
    x = x[:height, :width].astype(np.int64)
    if width <= 2:
        return np.repeat(np.repeat(x, 2, axis=0), 2, axis=1)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * height, 2 * width), np.int64)
    for v, other in ((0, above), (1, below)):
        colsum = 3 * x + other
        last = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
        nxt = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
        rows = out[v::2]
        rows[:, 0::2] = (3 * colsum + last + 8) >> 4
        rows[:, 1::2] = (3 * colsum + nxt + 7) >> 4
        rows[:, 0] = (4 * colsum[:, 0] + 8) >> 4
        rows[:, -1] = (4 * colsum[:, -1] + 7) >> 4
    return out


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB (jdcolor.c, 16 fraction bits)."""
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((fix(1.40200) * cr + one_half) >> 16)
    g = y + ((-fix(0.34414) * cb + one_half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# JPEG: decoder


class _Component:
    def __init__(self, ident, h, v, tq):
        self.ident, self.h, self.v, self.tq = ident, h, v, tq
        self.coef = None    # array('i') of [blocks_y * blocks_x * 64], zig-zag order
        self.blocks_x = self.blocks_y = 0   # the MCU-padded block grid
        self.width = self.height = 0        # samples the component really has


def _entropy_segments(data: bytes, pos: int):
    """The entropy-coded bytes after an SOS, split at restart markers and
    unstuffed, and the position of the marker that ends them."""
    segments, start, i = [], pos, pos
    n = len(data)
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            raise ValueError("JPEG entropy-coded data runs past the end of the file")
        nxt = data[i + 1]
        if nxt == 0x00 or nxt == 0xFF:
            i += 1 if nxt == 0xFF else 2
            continue
        segments.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= nxt <= 0xD7:
            i += 2
            start = i
            continue
        return segments, i


def _decode_scan(segments, scan, mcus_x, mcus_y, restart):
    """Huffman-decode one sequential scan into each component's coefficients.
    `scan`: [(component, dc table, ac table)]."""
    interleaved = len(scan) > 1
    if interleaved:
        units = [(c, dc, ac, dy, dx) for c, dc, ac in scan for dy in range(c.v)
                 for dx in range(c.h)]
        n_mcu_x, n_mcu = mcus_x, mcus_x * mcus_y
    else:
        c = scan[0][0]
        n_mcu_x = -(-c.width // 8)
        n_mcu = n_mcu_x * -(-c.height // 8)
        units = [(c, scan[0][1], scan[0][2], 0, 0)]
    per_interval = restart if restart else n_mcu
    if len(segments) < -(-n_mcu // per_interval):
        raise ValueError("JPEG scan holds fewer restart intervals than its MCUs need")
    mcu = 0
    for seg in segments:
        if mcu >= n_mcu:
            break
        buf = seg + b"\x00" * 8
        p = 0
        preds = {id(u[0]): 0 for u in units}
        for _ in range(min(per_interval, n_mcu - mcu)):
            my, mx = divmod(mcu, n_mcu_x)
            for comp, dcl, acl, dy, dx in units:
                if interleaved:
                    by, bx = my * comp.v + dy, mx * comp.h + dx
                else:
                    by, bx = my, mx
                coef = comp.coef
                base = (by * comp.blocks_x + bx) * 64
                q = p >> 3
                win = int.from_bytes(buf[q:q + 5], "big")
                o = p & 7
                code = dcl[(win >> (24 - o)) & 0xFFFF]
                if not code:
                    raise ValueError("JPEG: invalid Huffman code")
                ln, s = code >> 8, code & 0xFF
                p += ln
                diff = 0
                if s:
                    o += ln
                    bits = (win >> (40 - o - s)) & ((1 << s) - 1)
                    diff = bits if bits >> (s - 1) else bits - (1 << s) + 1
                    p += s
                pred = preds[id(comp)] + diff
                preds[id(comp)] = pred
                coef[base] = pred
                k = 1
                while k < 64:
                    q = p >> 3
                    win = int.from_bytes(buf[q:q + 5], "big")
                    o = p & 7
                    code = acl[(win >> (24 - o)) & 0xFFFF]
                    if not code:
                        raise ValueError("JPEG: invalid Huffman code")
                    ln, rs = code >> 8, code & 0xFF
                    p += ln
                    s = rs & 15
                    if not s:
                        if rs != 0xF0:
                            break           # end of block
                        k += 16
                        continue
                    k += rs >> 4
                    o += ln
                    bits = (win >> (40 - o - s)) & ((1 << s) - 1)
                    p += s
                    if k < 64:
                        coef[base + k] = bits if bits >> (s - 1) else bits - (1 << s) + 1
                    k += 1
            mcu += 1
    if mcu < n_mcu:
        raise ValueError("JPEG scan ends before its last MCU")


def read_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> uint8 [H, W] (gray) or [H, W, 3] (RGB)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    qt, dc_luts, ac_luts = {}, {}, {}
    comps, frame, restart, adobe = [], None, 0, None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:
            pos -= 1
            continue
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker in (0xC0, 0xC1):
            precision, height, width, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"JPEG of {precision}-bit samples: only 8-bit is read")
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                                body[8 + 3 * i]) for i in range(nc)]
            frame = (height, width)
        elif marker == 0xC2 or marker == 0xC6 or marker == 0xCA or marker == 0xCE:
            raise ValueError("progressive JPEG is not supported: only baseline "
                             "(sequential Huffman) files are read")
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"JPEG frame type 0x{marker:02X} is not supported: only baseline "
                             "(sequential Huffman) files are read")
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qt[tq] = table
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                symbols = list(body[i + 17:i + 17 + sum(counts)])
                (ac_luts if tc else dc_luts)[th] = _lookup_table(counts, symbols)
                i += 17 + sum(counts)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe = body[11] if len(body) > 11 else None
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcus_x, mcus_y = -(-frame[1] // (8 * hmax)), -(-frame[0] // (8 * vmax))
            for c in comps:
                if c.coef is None:
                    c.width = -(-frame[1] * c.h // hmax)
                    c.height = -(-frame[0] * c.v // vmax)
                    c.blocks_x, c.blocks_y = mcus_x * c.h, mcus_y * c.v
                    c.coef = array("i", bytes(4 * 64 * c.blocks_x * c.blocks_y))
            ns = body[0]
            by_id = {c.ident: c for c in comps}
            scan = [(by_id[body[1 + 2 * i]], dc_luts[body[2 + 2 * i] >> 4],
                     ac_luts[body[2 + 2 * i] & 15]) for i in range(ns)]
            ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
            if ss != 0 or se != 63:
                raise ValueError("progressive JPEG is not supported")
            segments, pos = _entropy_segments(data, pos)
            _decode_scan(segments, scan, mcus_x, mcus_y, restart)
    if frame is None or any(c.coef is None for c in comps):
        raise ValueError("JPEG without a complete frame")

    height, width = frame
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        coef = np.frombuffer(c.coef, np.int32).astype(np.int64).reshape(-1, 64)
        natural = np.empty_like(coef)
        natural[:, ZIGZAG] = coef
        blocks = idct_islow((natural * qt[c.tq]).reshape(-1, 8, 8))
        plane = blocks.reshape(c.blocks_y, c.blocks_x, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c.blocks_y * 8, c.blocks_x * 8)
        ratio = (hmax // c.h, vmax // c.v)
        if ratio == (1, 1):
            up = plane
        elif ratio == (2, 1):
            up = _upsample_h2(plane[:c.height], c.width)
        elif ratio == (2, 2):
            up = _upsample_h2v2(plane, c.height, c.width)
        else:
            raise ValueError(f"JPEG chroma subsampling {ratio} is not supported "
                             "(4:4:4, 4:2:2 and 4:2:0 are)")
        planes.append(up[:height, :width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if len(planes) != 3:
        raise ValueError(f"JPEG with {len(planes)} components: gray and 3-component are read")
    rgb_ids = [c.ident for c in comps] == [ord("R"), ord("G"), ord("B")]
    if adobe == 0 or rgb_ids:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


# ---------------------------------------------------------------------------
# JPEG: encoder (baseline, 4:4:4)


def _quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's quality scaling of a base table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    m[0] /= np.sqrt(2.0)
    return m


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.write((1 << (8 - self.n)) - 1, 8 - self.n)   # pad with ones
        return bytes(self.out)


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """uint8 [H, W, 3] RGB -> baseline JPEG bytes, YCbCr 4:4:4, the Annex K
    quantisation tables scaled by `quality` as libjpeg scales them, and the
    Annex K Huffman tables."""
    h, w = img.shape[:2]
    x = np.asarray(img, np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    qtabs = [_quality_table(_Q_LUMA, quality), _quality_table(_Q_CHROMA, quality)]
    bh, bw = -(-h // 8), -(-w // 8)
    m = _dct_matrix()
    quantised = []
    for i, p in enumerate(planes):
        padded = np.pad(p, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge") - 128.0
        blocks = padded.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        coef = m @ blocks @ m.T
        q = qtabs[min(i, 1)].reshape(8, 8)
        quantised.append(np.round(coef / q).astype(np.int64).reshape(-1, 64)[:, ZIGZAG])

    tables = [(_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA)]
    codes = [({s: (c, n) for s, c, n in _canonical_codes(*dc)},
              {s: (c, n) for s, c, n in _canonical_codes(*ac)}) for dc, ac in tables]
    bw_ = _BitWriter()
    preds = [0] * len(planes)

    def magnitude(v):
        s = abs(v).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    for blk in range(bh * bw):
        for ci, qz in enumerate(quantised):
            dc_codes, ac_codes = codes[min(ci, 1)]
            row = qz[blk].tolist()
            s, bits = magnitude(row[0] - preds[ci])
            preds[ci] = row[0]
            bw_.write(*dc_codes[s])
            if s:
                bw_.write(bits, s)
            run = 0
            last = max((k for k in range(1, 64) if row[k]), default=0)
            for k in range(1, last + 1):
                v = row[k]
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    bw_.write(*ac_codes[0xF0])
                    run -= 16
                s, bits = magnitude(v)
                bw_.write(*ac_codes[(run << 4) | s])
                bw_.write(bits, s)
                run = 0
            if last < 63:
                bw_.write(*ac_codes[0x00])
    scan = bw_.flush()

    def segment(marker, body):
        return b"\xff" + bytes([marker]) + struct.pack(">H", len(body) + 2) + body

    out = bytearray(b"\xff\xd8")
    out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i in range(2):
        out += segment(0xDB, bytes([i]) + bytes(qtabs[i][ZIGZAG].astype(np.uint8)))
    nc = len(planes)
    sof = struct.pack(">BHHB", 8, h, w, nc)
    for i in range(nc):
        sof += bytes([i + 1, 0x11, min(i, 1)])
    out += segment(0xC0, sof)
    for i, (dc, ac) in enumerate(tables):
        out += segment(0xC4, bytes([0x00 | i]) + bytes(dc[0]) + bytes(dc[1]))
        out += segment(0xC4, bytes([0x10 | i]) + bytes(ac[0]) + bytes(ac[1]))
    sos = bytes([nc]) + b"".join(bytes([i + 1, (min(i, 1) << 4) | min(i, 1)])
                                 for i in range(nc)) + b"\x00\x3f\x00"
    out += segment(0xDA, sos)
    out += scan + b"\xff\xd9"
    return bytes(out)


def write_jpeg(path: str, img: np.ndarray, quality: int = 75) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))


def read_bmp(data: bytes) -> np.ndarray:
    """Uncompressed BMP bytes -> uint8 as Pillow reads them: 24- and 32-bit
    files as [H, W, 3] (a 32-bit file's fourth byte is padding), 8-bit files
    as [H, W] when the palette is the gray ramp, else [H, W, 3] through the
    palette; rows bottom-up (height > 0) or top-down (height < 0)."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (header,) = struct.unpack("<I", data[14:18])
    if header < 40:
        raise ValueError(f"BMP header of {header} bytes: only BITMAPINFOHEADER and later")
    w, h, _, bpp, compression = struct.unpack("<iiHHI", data[18:34])
    (colors,) = struct.unpack("<I", data[46:50])
    if compression != 0 or bpp not in (8, 24, 32):
        raise ValueError(f"BMP of {bpp} bits, compression {compression}: only uncompressed "
                         "8-, 24- and 32-bit files are read")
    rows, stride = abs(h), (w * bpp // 8 + 3) // 4 * 4
    pix = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(rows, stride)
    if h > 0:
        pix = pix[::-1]
    if bpp == 8:
        n = colors or 256
        pal = np.frombuffer(data, np.uint8, 4 * n, 14 + header).reshape(n, 4)[:, 2::-1]
        idx = pix[:, :w]
        if (pal == np.arange(n, dtype=np.uint8)[:, None]).all():
            return np.ascontiguousarray(idx)
        return np.ascontiguousarray(pal[idx])
    k = bpp // 8
    return np.ascontiguousarray(pix[:, :w * k].reshape(rows, w, k)[:, :, 2::-1])


def imread(path: str) -> np.ndarray:
    """Read a PNG, a baseline JPEG or an uncompressed BMP file, told apart by
    its first bytes, as uint8 [H, W] or [H, W, C]. A file that cannot be
    read raises naming it."""
    with open(path, "rb") as f:
        data = f.read()
    readers = {PNG_SIGNATURE: read_png, b"\xff\xd8": read_jpeg, b"BM": read_bmp}
    for magic, read in readers.items():
        if data.startswith(magic):
            try:
                return read(data)
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from e
    raise ValueError(f"{path}: neither a PNG, a JPEG nor a BMP file")


def image_size(path: str) -> tuple:
    """(H, W) of a PNG or JPEG file from its header, without decoding it."""
    with open(path, "rb") as f:
        data = f.read(1 << 16)
    if data[:8] == PNG_SIGNATURE:
        w, h = struct.unpack(">II", data[16:24])
        return h, w
    return imread(path).shape[:2]


# ---------------------------------------------------------------------------
# cv2.resize(..., interpolation=INTER_AREA)


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of OpenCV's area resize when shrinking (each output
    pixel the overlap-weighted mean of the input pixels it covers)."""
    scale = src / dst
    out = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            out[dx, sx1 - 1] = (sx1 - fsx1) / cell
        out[dx, sx1:sx2] = 1.0 / cell
        if fsx2 - sx2 > 1e-3:
            out[dx, sx2] = min(min(fsx2 - sx2, 1.0), cell) / cell
    return out


def _area_up_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of OpenCV's INTER_AREA when enlarging: two taps,
    sx = floor(dx * src / dst), fx = fractional part of (dx + 1) - (sx + 1) *
    dst / src where positive, else 0; the last input column is clamped."""
    scale, inv = src / dst, dst / src
    out = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        sx = int(np.floor(dx * scale))
        fx = np.float32((dx + 1) - (sx + 1) * inv)
        fx = np.float32(0.0) if fx <= 0 else fx - np.float32(np.floor(fx))
        if sx < 0:
            sx, fx = 0, 0.0
        if sx + 1 >= src:
            out[dx, min(sx, src - 1)] = 1.0
        else:
            out[dx, sx] = 1.0 - float(fx)
            out[dx, sx + 1] = float(fx)
    return out


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_AREA)` for a float
    [H, W] or [H, W, C] image; `size` is (width, height) as cv2 takes it."""
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (out_h, out_w) == (h, w):
        return img.copy()
    if out_h <= h and out_w <= w:
        wy, wx = _area_weights(h, out_h), _area_weights(w, out_w)
    else:   # cv2 enlarges through its linear path with INTER_AREA's coefficients
        wy, wx = _area_up_weights(h, out_h), _area_up_weights(w, out_w)
    return _separable(img, wy, wx)


def _separable(img: np.ndarray, wy: np.ndarray, wx: np.ndarray) -> np.ndarray:
    """[H, W(, C)] -> wy @ img @ wx^T over the two image axes, summed in f64,
    in img's dtype."""
    out = np.einsum("ij,jk...->ik...", wy, img.astype(np.float64))
    out = np.einsum("kl,il...->ik...", wx, out)
    return out.astype(img.dtype)


# ---------------------------------------------------------------------------
# cv2.resize(...) at its default interpolation, INTER_LINEAR


def _linear_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of OpenCV's INTER_LINEAR: the half-pixel source
    position (dx + 0.5) * src / dst - 0.5 between taps sx = floor of it and
    sx + 1, its fractional part fx (taken in f64, then rounded to f32) the
    second tap's weight and 1 - fx (in f32) the first's; clamped to the edge
    pixel at both ends."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    sx = np.floor(pos).astype(np.int64)
    fx = (pos - sx).astype(np.float32)
    edge = (sx < 0) | (sx >= src - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, src - 1)
    out = np.zeros((dst, src), np.float64)
    rows = np.arange(dst)
    out[rows, sx] = np.float32(1.0) - fx
    inner = ~edge
    out[rows[inner], sx[inner] + 1] = fx[inner]
    return out


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """`cv2.resize(img, size)` (INTER_LINEAR) for a float [H, W] or
    [H, W, C] image; `size` is (width, height) as cv2 takes it. A shrink
    takes two taps an axis (512 -> 64 reads 2 x 2 of each 8 x 8 block), not
    a box average."""
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (out_h, out_w) == (h, w):
        return img.copy()
    return _separable(img, _linear_weights(h, out_h), _linear_weights(w, out_w))


def _area_taps(src: int, dst: int):
    """OpenCV's shrinking INTER_AREA taps: ([dst, T] source index, [dst, T]
    f32 weight), each output's taps in OpenCV's order, unused ones weight 0."""
    scale = src / dst
    taps = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        taps.append(row)
    T = max(len(r) for r in taps)
    idx = np.zeros((dst, T), np.int64)
    wgt = np.zeros((dst, T), np.float32)
    for dx, row in enumerate(taps):
        for t, (sx, a) in enumerate(row):
            idx[dx, t], wgt[dx, t] = sx, a
    return idx, wgt


def resize_area_u8(img: np.ndarray, size) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_AREA)` for a uint8
    [H, W] or [H, W, C] image, byte for byte; `size` is (width, height).

    cv2 takes three paths, each reproduced with its arithmetic: an integer
    reduction sums the block in integers, then rounds half up for 2 x 2 (its
    vector code adds 2 and shifts by 2) and otherwise rounds the f32 product
    of the sum and 1/area to nearest even; any other reduction accumulates
    each row's taps, then the rows, in f32 in OpenCV's order and rounds to
    nearest even; an enlargement is its fixed-point linear path (weights in
    2048ths, the horizontal pass exact in integers, the vertical pass as its
    vector code runs it: ((b * (S >> 4)) >> 16) a tap, summed, + 2, >> 2)."""
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (out_h, out_w) == (h, w):
        return img.copy()
    if out_h <= h and out_w <= w:
        if h % out_h == 0 and w % out_w == 0:
            sy, sx = h // out_h, w // out_w
            sums = img.astype(np.int64).reshape((out_h, sy, out_w, sx) + img.shape[2:]).sum((1, 3))
            if (sy, sx) == (2, 2):
                return ((sums + 2) >> 2).astype(np.uint8)
            out = np.rint(sums.astype(np.float32) * np.float32(1.0 / (sy * sx)))
            return np.clip(out, 0, 255).astype(np.uint8)
        (yi, yw), (xi, xw) = _area_taps(h, out_h), _area_taps(w, out_w)
        f = img.astype(np.float32)
        rows = np.zeros((h, out_w) + img.shape[2:], np.float32)
        for t in range(xi.shape[1]):
            wt = xw[:, t].reshape((1, out_w) + (1,) * (img.ndim - 2))
            rows += f[:, xi[:, t]] * wt
        acc = np.zeros((out_h, out_w) + img.shape[2:], np.float32)
        for t in range(yi.shape[1]):
            wt = yw[:, t].reshape((out_h, 1) + (1,) * (img.ndim - 2))
            acc += wt * rows[yi[:, t]]
        return np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    wy = np.rint(_area_up_weights(h, out_h) * 2048).astype(np.int64)
    wx = np.rint(_area_up_weights(w, out_w) * 2048).astype(np.int64)
    rows = np.einsum("kl,il...->ik...", wx, img.astype(np.int64)) >> 4
    acc = np.zeros((out_h,) + rows.shape[1:], np.int64)
    for i in range(out_h):
        for j in np.nonzero(wy[i])[0]:
            acc[i] += (wy[i, j] * rows[j]) >> 16
    return np.clip((acc + 2) >> 2, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# cv2.resize(..., interpolation=INTER_CUBIC)


def _cubic_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of OpenCV's INTER_CUBIC: taps sx - 1 .. sx + 2 around
    the half-pixel source position's floor sx, Keys' kernel with a = -0.75 in
    f32 (the fourth weight 1 minus the other three), taps past an edge
    clamped to the edge pixel."""
    A = np.float32(-0.75)
    one = np.float32(1.0)
    out = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        fx = np.float32((dx + 0.5) * (src / dst) - 0.5)
        sx = int(np.floor(fx))
        x = np.float32(fx - np.float32(sx))
        c0 = ((A * (x + one) - 5 * A) * (x + one) + 8 * A) * (x + one) - 4 * A
        c1 = ((A + 2) * x - (A + 3)) * x * x + one
        c2 = ((A + 2) * (one - x) - (A + 3)) * (one - x) * (one - x) + one
        c3 = one - c0 - c1 - c2
        for k, c in enumerate((c0, c1, c2, c3)):
            out[dx, min(max(sx - 1 + k, 0), src - 1)] += float(c)
    return out


def resize_cubic(img: np.ndarray, size) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)` for a float
    [H, W] or [H, W, C] image; `size` is (width, height). It overshoots the
    input's range near edges: callers clip."""
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (out_h, out_w) == (h, w):
        return img.copy()
    return _separable(img, _cubic_weights(h, out_h), _cubic_weights(w, out_w))


# ---------------------------------------------------------------------------
# cv2.warpAffine(img, M, size, flags=INTER_LINEAR), on tensors


def _invert_affine(M: np.ndarray) -> np.ndarray:
    """`cv2.invertAffineTransform`: the [2, 3] inverse of a [2, 3] affine map,
    in float64 (0 where the map is singular)."""
    M = np.asarray(M, np.float64)
    det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = M[1, 1] * d, M[0, 0] * d, -M[0, 1] * d, -M[1, 0] * d
    return np.array([[a11, a12, -a11 * M[0, 2] - a12 * M[1, 2]],
                     [a21, a22, -a21 * M[0, 2] - a22 * M[1, 2]]])


_WARP_VECTOR = 16   # output pixels a step of cv2's vectorised row loop (8 float32 lanes x 2)


def warp_affine(img: torch.Tensor, M: np.ndarray, size) -> torch.Tensor:
    """`cv2.warpAffine(img, M, size, flags=cv2.INTER_LINEAR)` for a float32
    [H, W] or [H, W, C] tensor, on its device. Output pixel (x, y) samples the
    input bilinearly at M^-1 (x, y, 1), in float32 as cv2's vectorised loop
    computes it: M^-1 rounded to float32, a row's base y * m1 + m2 rounded,
    then fma(m0, x, base); the row's last (width mod 16) pixels take cv2's
    scalar tail, fma(x, m0, y * m1) + m2. (A fused multiply-add is one
    rounding of an exact float64 product and sum.) The weights are the
    coordinates' fractional parts, blended as a + f (b - a) in float32. The
    border is the constant 0: a tap outside the input reads 0, so a pixel
    whose taps fall partly outside blends with 0. `size` is (width, height)
    as cv2 takes it."""
    out_w, out_h = int(size[0]), int(size[1])
    m = torch.from_numpy(_invert_affine(M).astype(np.float32)).to(img.device)
    h, w = img.shape[:2]
    dev = img.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(out_w, dtype=torch.float64, device=dev)[None, :]
    body = xs < out_w // _WARP_VECTOR * _WARP_VECTOR

    def coord(r):
        m0, m1, m2 = m[r, 0].double(), m[r, 1], m[r, 2]
        vec = (m0 * xs + (ys * m1 + m2).double()).float()
        tail = (m0 * xs + (ys * m1).double()).float() + m2
        return torch.where(body, vec, tail)

    sx, sy = coord(0), coord(1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(h * w, -1)

    def tap(dx, dy):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return flat[torch.where(inside, yi * w + xi, 0)] * inside[..., None]

    fx, fy = fx[..., None], fy[..., None]
    p00, p01, p10, p11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
    top = p00 + fx * (p01 - p00)
    bot = p10 + fx * (p11 - p10)
    return (top + fy * (bot - top)).reshape((out_h, out_w) + tuple(img.shape[2:]))


# ---------------------------------------------------------------------------
# cv2.cvtColor(uint8, COLOR_RGB2LAB / COLOR_LAB2RGB), on tensors
#
# cv2's 8-bit conversions are integer arithmetic on tables it builds in
# software floating point: RGB -> Lab through an sRGB gamma table scaled by
# 2^3, a fixed-point (2^12) RGB -> XYZ matrix over the D65 white, a cube-root
# table scaled by 2^15 and rounding descales; Lab -> RGB through an L -> (Y,
# f(Y)) table, fixed-point divisions of a and b, an f^-1 table, a fixed-point
# XYZ -> RGB matrix and an inverse-gamma table of 4096 entries. The tables
# below are cv2's: float32 arithmetic rounded as cv2 rounds (half to even),
# checked byte for byte against cv2 on all 2^24 inputs of each direction.

_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_LAB_BASE = 1 << 14
_INV_GAMMA_SIZE = 1 << 12
_AB_MIN = -8145      # the least index of the f^-1 table that a and b reach
_SRGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
                         [0.019334, 0.119193, 0.950227]])
_XYZ_TO_SRGB = np.array([[3.240479, -1.53715, -0.498535], [-0.969256, 1.875991, 0.041556],
                         [0.055648, -0.204043, 1.057311]])
_D65 = np.array([0.950456, 1.0, 1.088754])


def _round_even(x) -> np.ndarray:
    return np.rint(np.asarray(x, np.float64)).astype(np.int64)


@functools.cache
def _lab_tables_np() -> dict:
    f32 = np.float32
    gamma = lambda x: np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    inv_gamma = lambda x: np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)
    x = np.arange(256).astype(f32) / f32(255)
    gamma_b = _round_even(f32(255 << _GAMMA_SHIFT) * gamma(x.astype(np.float64)).astype(f32))
    lthresh, lscale, lbias = f32(216) / f32(24389), f32(841) / f32(108), f32(16) / f32(116)
    x = np.arange(256 * 3 // 2 << _GAMMA_SHIFT).astype(f32) / f32(255 << _GAMMA_SHIFT)
    f = np.where(x < lthresh, x * lscale + lbias, np.cbrt(x.astype(np.float64)).astype(f32))
    cbrt_b = _round_even(f32(1 << _LAB_SHIFT2) * f.astype(f32))
    cbrt_b[324] -= 1   # cv2's software cube root is one float32 step low here
    to_xyz = _round_even((1 << _LAB_SHIFT) * _SRGB_TO_XYZ / _D65[:, None])
    # Lab -> RGB
    y_b, fy_b = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for i in range(256):
        if i <= 20:
            y_b[i] = _round_even(f32(i * _LAB_BASE * 20 * 9) / f32(17 * 29 ** 3))
            fy_b[i] = _round_even(f32(_LAB_BASE) * (f32(16) / f32(116)
                                                    + f32(i * 5) / f32(3 * 17 * 29)))
        else:
            fy = f32(i * 100 * _LAB_BASE) / f32(255 * 116) + f32(16 * _LAB_BASE) / f32(116)
            fy_b[i] = _round_even(fy)
            y_b[i] = _round_even(fy * fy * fy / f32(_LAB_BASE * _LAB_BASE))
    v = np.arange(_AB_MIN, 2 * _LAB_BASE, dtype=np.int64)
    trunc_div = lambda a, b: np.sign(a) * (np.abs(a) // b)   # C's division, b > 0
    xz_b = np.where(v <= 3390,
                    trunc_div(v * 108, 841) - _LAB_BASE * 16 // 116 * 108 // 841,
                    trunc_div(trunc_div(v * v, _LAB_BASE) * v, _LAB_BASE))
    x = f32(1) / f32(_INV_GAMMA_SIZE) * np.arange(_INV_GAMMA_SIZE).astype(f32)
    inv_gamma_b = _round_even(f32(255) * inv_gamma(x.astype(np.float64)).astype(f32))
    to_rgb = _round_even((1 << _LAB_SHIFT) * _XYZ_TO_SRGB * _D65[None, :])
    return {"gamma": gamma_b, "cbrt": cbrt_b, "to_xyz": to_xyz, "y": y_b, "fy": fy_b,
            "xz": xz_b, "inv_gamma": inv_gamma_b, "to_rgb": to_rgb}


@functools.cache
def _lab_tables(dev: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in _lab_tables_np().items()}


def _descale(v: torch.Tensor, n: int) -> torch.Tensor:
    return (v + (1 << (n - 1))) >> n


def rgb_to_lab_u8(rgb: torch.Tensor) -> torch.Tensor:
    """`cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB)` for a uint8 [..., 3] tensor, on
    its device, byte for byte: L scaled to 0..255, a and b offset by 128."""
    t = _lab_tables(rgb.device)
    lin = t["gamma"][rgb.long()]                              # [..., 3], scaled by 2^3
    # integer products written out: CUDA has no integer matmul
    xyz = _descale((lin[..., None, :] * t["to_xyz"]).sum(-1), _LAB_SHIFT)
    fx, fy, fz = t["cbrt"][xyz].unbind(-1)
    one = 1 << _LAB_SHIFT2
    L = _descale(((116 * 255 + 50) // 100) * fy - (16 * 255 * one + 50) // 100, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * one, _LAB_SHIFT2)
    b = _descale(200 * (fy - fz) + 128 * one, _LAB_SHIFT2)
    return torch.stack([L, a, b], -1).clamp(0, 255).to(torch.uint8)


def lab_to_rgb_u8(lab: torch.Tensor) -> torch.Tensor:
    """`cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)` for a uint8 [..., 3] tensor, on
    its device, byte for byte (lossy: out-of-gamut colours clip)."""
    t = _lab_tables(lab.device)
    L, a, b = lab.long().unbind(-1)
    y, fy = t["y"][L], t["fy"][L]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _LAB_BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _LAB_BASE // 200 + 1
    x, z = t["xz"][fy + adiv - _AB_MIN], t["xz"][fy - bdiv - _AB_MIN]
    xyz = torch.stack([x, y, z], -1)
    shift = _LAB_SHIFT + 14 - 12
    rgb = _descale((xyz[..., None, :] * t["to_rgb"]).sum(-1), shift).clamp(0, _INV_GAMMA_SIZE - 1)
    return t["inv_gamma"][rgb].to(torch.uint8)
