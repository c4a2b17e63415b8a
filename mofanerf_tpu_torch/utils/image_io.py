"""Image files without imageio, Pillow or OpenCV: the port's counterpart of
the `imageio.v2.imread` / `imageio.imwrite` / `cv2.resize` / `cv2.warpAffine`
/ `cv2.cvtColor` calls of the JAX package.

- `imread` returns, for every PNG, JPEG, BMP and WebP that the JAX
  package's readers take, what `imageio.v2.imread` returns: the same shape,
  dtype and values (PNG, BMP and WebP exactly; JPEG bit for bit with
  libjpeg-turbo's islow IDCT, fancy upsampling and colour transform). The
  decoders: `png.py` (every colour type and depth, tRNS, Adam7), `jpeg.py`
  (baseline, extended, progressive and lossless Huffman frames, any sampling
  factors, CMYK and YCCK), `read_bmp` below and `webp.py` (lossy `vp8.py`
  with its alpha plane, lossless `vp8l.py`, an animation's first frame).
  `image_size` reads (H, W) from the header of each, decoding no pixel
  data.
- `write_png` (8-bit gray, RGB, RGBA) and `write_jpeg` (baseline 4:4:4).
- `resize_area`: `cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`
  for float images, area-weighted when shrinking, OpenCV's INTER_AREA
  coefficients when enlarging.
- `resize_linear`: `cv2.resize(img, (w, h))` at its default INTER_LINEAR for
  float images: two taps an axis, no antialiasing.
- On tensors, on whichever device they lie: `warp_affine`
  (`cv2.warpAffine(img, M, size, flags=INTER_LINEAR)` on float32 images, with
  a constant border of 0, in cv2's float32 arithmetic) and `rgb_to_lab_u8` /
  `lab_to_rgb_u8` (cv2's 8-bit `COLOR_RGB2LAB` / `COLOR_LAB2RGB`, byte for
  byte).
"""
from __future__ import annotations

import functools
import struct

import numpy as np
import torch

from .jpeg import jpeg_size, read_jpeg, write_jpeg  # noqa: F401  (re-exported)
from .png import PNG_SIGNATURE, png_size, read_png, unpack_samples, write_png  # noqa: F401
from .webp import is_webp, read_webp, webp_size

# ---------------------------------------------------------------------------
# BMP, as Pillow's BmpImagePlugin reads it

# BI_BITFIELDS masks Pillow reads, by bits a pixel (every other layout raises)
_BMP_MASKS = {
    32: [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)],
    24: [(0xFF0000, 0xFF00, 0xFF)],
    16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)],
}


def _bmp_header(data: bytes) -> dict:
    """The fields of a BMP's file and info headers that Pillow reads."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    if size == 12:      # OS/2 1.x / Windows 2 core header: 16-bit sizes, 3-byte palette entries
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        return dict(offset=offset, size=size, width=w, height=h, top_down=False, bits=bits,
                    compression=0, colors=0, entry=3, masks=None)
    if size not in (40, 52, 56, 64, 108, 124):
        raise ValueError(f"BMP header of {size} bytes is not read")
    w, h, _, bits, compression = struct.unpack("<IIHHI", data[18:34])
    top_down = data[25] == 0xFF
    if top_down:
        h = 2 ** 32 - h
    (colors,) = struct.unpack("<I", data[46:50])
    masks = None
    if compression == 3:
        if size >= 52:   # in the header; a fourth (alpha) from V3 on
            masks = struct.unpack("<IIII", data[54:70]) if size >= 56 else \
                struct.unpack("<III", data[54:66]) + (0,)
        else:            # after a 40-byte header: three, no alpha
            masks = struct.unpack("<III", data[54:66]) + (0,)
    return dict(offset=offset, size=size, width=w, height=h, top_down=top_down, bits=bits,
                compression=compression, colors=colors, entry=4, masks=masks)


def _bmp_rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """RLE8 / RLE4 pixel data -> [height, width] indices in file row order,
    as Pillow's BmpRleDecoder reads them (its reading of a delta escape, a
    row overrun and absolute runs included)."""
    out = bytearray()
    x, n, want = 0, len(data), width * height
    while len(out) < want:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:                               # encoded run
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = (byte >> 4, byte & 0x0F)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                         # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:                         # end of bitmap
            break
        elif byte == 2:                         # delta: Pillow skips two bytes, then reads
            if pos + 2 > n:                     # right and up from the next two
                break
            if pos + 4 > n:
                raise ValueError("BMP run-length delta runs past the end of the file")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * width)
            x = len(out) % width
        else:                                   # absolute run
            nbytes = byte // 2 if rle4 else byte
            chunk = data[pos:pos + nbytes]
            pos += len(chunk)
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 0x0F))
            else:
                out += chunk
            if len(chunk) < nbytes:
                break
            x += byte
            pos += pos % 2                      # to a 16-bit boundary of the file
    if len(out) < want:
        raise ValueError("BMP run-length data ends before its last pixel")
    return np.frombuffer(bytes(out[:want]), np.uint8).reshape(height, width)


def read_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> what `imageio.v2.imread` returns (Pillow's BMP modes):
    1-, 4- and 8-bit palette files (raw, RLE4, RLE8) as uint8 [H, W, 3]
    through the palette, or, where the palette is Pillow's gray ramp, bool
    [H, W] (2 colours, black and white) or uint8 [H, W] (the indices);
    16-bit (5-5-5, or 5-6-5 by BI_BITFIELDS), 24-bit and 32-bit files as
    uint8 [H, W, 3], [H, W, 4] where BI_BITFIELDS gives an alpha mask; the
    12-byte core header and BITMAPINFOHEADER to V5; rows bottom-up or
    top-down."""
    hd = _bmp_header(data)
    w, h, bits, comp = hd["width"], hd["height"], hd["bits"], hd["compression"]
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP of {bits} bits a pixel is not read")
    offset = hd["offset"]
    if bits <= 8:
        if comp not in (0, 1, 2):
            raise ValueError(f"BMP of {bits} bits, compression {comp} is not read")
        colors = hd["colors"] or 1 << bits
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} colours")
        entry = hd["entry"]
        raw_pal = data[14 + hd["size"]:14 + hd["size"] + entry * colors]
        gray_vals = (0, 255) if colors == 2 else range(colors)
        gray = all(raw_pal[i * entry:i * entry + 3] == bytes([v]) * 3
                   for i, v in enumerate(gray_vals))
        if offset == 14 + hd["size"]:     # Pillow skips a palette the offset forgot
            offset += 4 * colors
        if comp in (1, 2):
            if gray and colors == 2:
                raise ValueError("run-length BMP with a black and white palette is not read")
            idx = _bmp_rle(data, offset, w, h, comp == 2)
        else:
            stride = ((w * bits + 31) >> 3) & ~3
            rows = np.frombuffer(data, np.uint8, h * stride, offset).reshape(h, stride)
            # a gray palette makes Pillow unpack the rows as 1-bit or 8-bit pixels, whatever
            # the file's depth
            unpack = (1 if colors == 2 else 8) if gray else bits
            if (w * unpack + 7) // 8 > stride:
                raise ValueError(f"BMP rows of {stride} bytes cannot hold {w} pixels of "
                                 f"{unpack} bits")
            idx = unpack_samples(rows, w, unpack)
        if not hd["top_down"]:
            idx = idx[::-1]
        if gray:
            return np.ascontiguousarray(idx.astype(bool) if colors == 2 else idx)
        pal = np.zeros((max(256, colors), 3), np.uint8)
        n = len(raw_pal) // entry
        pal[:n] = np.frombuffer(raw_pal[:n * entry], np.uint8).reshape(n, entry)[:, 2::-1]
        return np.ascontiguousarray(pal[idx])
    if comp == 3:
        masks = hd["masks"] if bits == 32 else hd["masks"][:3]
        if masks not in _BMP_MASKS.get(bits, []):
            raise ValueError(f"BMP bitfields layout {tuple(hex(m) for m in masks)} at {bits} "
                             "bits is not read")
        if masks == (0, 0, 0, 0):
            masks = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    elif comp == 0:
        masks = {16: (0x7C00, 0x3E0, 0x1F), 24: (0xFF0000, 0xFF00, 0xFF),
                 32: (0xFF0000, 0xFF00, 0xFF)}[bits]
    else:
        raise ValueError(f"BMP of {bits} bits, compression {comp} is not read")
    stride = ((w * bits + 31) >> 3) & ~3
    k = bits // 8
    rows = np.frombuffer(data, np.uint8, h * stride, offset).reshape(h, stride)
    px = rows[:, :w * k].reshape(h, w, k).astype(np.uint32) \
        @ (np.uint32(1) << (8 * np.arange(k, dtype=np.uint32)))
    if not hd["top_down"]:
        px = px[::-1]
    out = []
    for m in masks:
        if not m:
            continue
        shift, width = (m & -m).bit_length() - 1, bin(m).count("1")
        v = ((px & m) >> shift).astype(np.int64)
        out.append(v if width == 8 else v * 255 // ((1 << width) - 1))
    return np.stack(out, axis=-1).astype(np.uint8)


def imread(path: str) -> np.ndarray:
    """Read a PNG, JPEG, BMP or WebP file, told apart by its first bytes, as
    `imageio.v2.imread` reads it: the same shape, dtype (uint8, or bool for
    1-bit gray, uint16 for 16-bit gray PNG) and values. A file that cannot
    be read raises a ValueError naming it."""
    with open(path, "rb") as f:
        data = f.read()
    readers = {PNG_SIGNATURE: read_png, b"\xff\xd8": read_jpeg, b"BM": read_bmp}
    read = next((r for magic, r in readers.items() if data.startswith(magic)),
                read_webp if is_webp(data) else None)
    if read is None:
        raise ValueError(f"{path}: neither a PNG, a JPEG, a BMP nor a WebP file")
    try:
        return read(data)
    except (ValueError, IndexError, struct.error) as e:
        raise ValueError(f"{path}: {e}") from e


def image_size(path: str) -> tuple:
    """(H, W) of a PNG, JPEG, BMP or WebP file, from its headers alone."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(PNG_SIGNATURE):
            return png_size(data)
        if data.startswith(b"BM"):
            hd = _bmp_header(data)
            return hd["height"], hd["width"]
        if data.startswith(b"\xff\xd8"):
            return jpeg_size(data)
        if is_webp(data):
            return webp_size(data)
    except (ValueError, struct.error) as e:
        raise ValueError(f"{path}: {e}") from e
    raise ValueError(f"{path}: neither a PNG, a JPEG, a BMP nor a WebP file")


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
