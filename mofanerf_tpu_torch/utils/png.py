"""PNG files without Pillow: the port's counterpart of what `imageio.v2.imread`
returns for a PNG (Pillow's modes, then imageio's conversions), and an 8-bit
writer.

Every colour type at every legal bit depth, palettes, tRNS and Adam7
interlacing, read with `zlib` and numpy un-filtering. What comes back, as
imageio gives it (tRNS is never applied: Pillow keeps it aside and imageio
drops it, a palette image's included):

| colour type, depth     | array                                         |
|------------------------|-----------------------------------------------|
| gray 1                 | bool [H, W]                                   |
| gray 2, 4, 8           | uint8 [H, W], scaled to 0-255                 |
| gray 16                | uint16 [H, W]                                 |
| RGB 8, 16              | uint8 [H, W, 3] (16: each sample's high byte) |
| palette 1, 2, 4, 8     | uint8 [H, W, 3] through the palette           |
| gray + alpha 8         | uint8 [H, W, 2]                               |
| gray + alpha 16        | uint8 [H, W, 4]: gray three times, alpha      |
| RGBA 8, 16             | uint8 [H, W, 4]                               |
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}             # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2)]


def _chunk(tag: bytes, data: bytes) -> bytes:
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
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


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


def _unfilter(raw: bytes, pos: int, h: int, stride: int, bpp: int) -> tuple:
    """Un-filter h rows of `stride` bytes (each after its filter byte) from
    raw[pos:]; returns ([h, stride] uint8, the position after them)."""
    end = pos + h * (stride + 1)
    if len(raw) < end:
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1), pos).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:     # Sub: a running sum over the pixels, per byte of a pixel, mod 256
            padded = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            padded[:stride] = line
            out[y] = np.cumsum(padded.reshape(-1, bpp), axis=0, dtype=np.uint8
                               ).reshape(-1)[:stride]
        elif kind == 2:     # Up
            out[y] = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_sequential(kind, buf, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0-4")
        prev = out[y]
    return out, end


def unpack_samples(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """[h, stride] bytes -> [h, n] integer samples at `depth` bits (big-endian,
    most significant bits first, rows padded to a byte)."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, :2 * n].reshape(h, n, 2).astype(np.uint16) @ np.array([256, 1], np.uint16)
    if depth == 8:
        return rows[:, :n]
    per = 8 // depth
    shifts = depth * np.arange(per - 1, -1, -1)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :n].astype(np.uint8)


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes -> what `imageio.v2.imread` returns for the file (see the
    module's table): bool, uint8 or uint16, [H, W] or [H, W, C]."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth not in _DEPTHS.get(color, ()):
        raise ValueError(f"PNG of bit depth {depth}, color type {color} is not a legal "
                         "combination")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)      # the filters' byte distance

    def stride(width):
        return (width * ch * depth + 7) // 8

    raw = zlib.decompress(b"".join(idat))
    if interlace:
        samples = np.zeros((h, w * ch), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            ph, pw = -(-(h - y0) // dy) if h > y0 else 0, -(-(w - x0) // dx) if w > x0 else 0
            if not ph or not pw:        # an empty pass has no rows, not even filter bytes
                continue
            rows, at = _unfilter(raw, at, ph, stride(pw), bpp)
            sub = unpack_samples(rows, pw * ch, depth).reshape(ph, pw, ch)
            samples.reshape(h, w, ch)[y0::dy, x0::dx] = sub
    else:
        rows, _ = _unfilter(raw, 0, h, stride(w), bpp)
        samples = unpack_samples(rows, w * ch, depth)
    s = samples.reshape(h, w, ch)
    if color == 0:
        g = s[..., 0]
        if depth == 1:
            return g.astype(bool)
        if depth in (2, 4):
            return (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return g.copy()
    if color == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        return pal[s[..., 0]]
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
        if color == 4:      # Pillow opens 16-bit gray + alpha as RGBA
            return np.ascontiguousarray(s[..., [0, 0, 0, 1]])
    return np.ascontiguousarray(s)


def png_size(data: bytes) -> tuple:
    """(H, W) of PNG bytes from IHDR."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    w, h = struct.unpack(">II", data[16:24])
    return h, w
