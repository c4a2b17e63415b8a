"""VP8L, WebP's lossless bitstream (RFC 9649), decoded as libwebp 1.6 decodes
it: the port's counterpart of the lossless half of what `imageio.v2.imread`
returns for a WebP file (Pillow over libwebp).

- `read_vp8l(data)`: a `VP8L` chunk's payload -> (uint8 [H, W, 4] RGBA, the
  header's `alpha_is_used` hint).
- `decode_alpha_stream(data, width, height)`: the entropy-coded image of a
  compressed `ALPH` chunk (no header; its green channel is the alpha plane).
- `vp8l_size(data)`: (H, W, alpha_is_used) from the 5-byte header alone.

The stages follow the RFC and libwebp's `vp8l_dec.c`: the four transforms
(predictor with its 14 modes, cross-colour, subtract-green, colour indexing
with pixel bundling) read in order and inverted in reverse; prefix codes in
the simple and the normal form (the 19-entry code-length code), meta prefix
codes through the entropy image, the colour cache, and LZ77 backward
references through the 120-entry distance map. Prefix codes that are not
complete, references out of the image and data that end before the last
pixel raise ValueError, where libwebp refuses the file. The entropy stage is
serial Python over two-level lookup tables; the transforms are numpy, but
for the predictor modes that need the pixel to their left, which run
pixel by pixel.
"""
from __future__ import annotations

import numpy as np

SIGNATURE = 0x2F
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# RFC 9649 5.2.2's distance map, libwebp's kCodeToPlane: (dy << 4) | (8 - dx)
CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c"
    "58454b343c035759131d565a232d444c555b333d68026769121e666a222e545c434d"
    "656b323e78017779535d111f646c424e767a212f757b313f636d525e00747c414f10"
    "20626e30737d515f40727e616f50717f6070")
NUM_LITERALS, NUM_LENGTHS, NUM_DISTANCES = 256, 24, 40
ALPHABET = (NUM_LITERALS + NUM_LENGTHS, NUM_LITERALS, NUM_LITERALS, NUM_LITERALS, NUM_DISTANCES)
MAX_CACHE_BITS = 11
ROOT_BITS = 8
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)

# the bit reversal of every 15-bit value (canonical codes are read LSB first)
_REV15 = sum(((np.arange(1 << 15) >> b) & 1) << (14 - b) for b in range(15)).tolist()


class _Bits:
    """LSB-first bit reader over a byte string, past whose end it reads
    zeros; `overrun()` says whether more bits were taken than libwebp's
    reader holds (8 x max(len, 8): its first window is 8 bytes wide)."""

    __slots__ = ("data", "pos", "val", "nbits", "limit")

    def __init__(self, data: bytes):
        self.data, self.pos, self.val, self.nbits = data, 0, 0, 0
        self.limit = 8 * max(len(data), 8)

    def read(self, n: int) -> int:
        if self.nbits < n:
            self.val |= int.from_bytes(self.data[self.pos:self.pos + 8], "little") << self.nbits
            self.pos += 8
            self.nbits += 64
        v = self.val & ((1 << n) - 1)
        self.val >>= n
        self.nbits -= n
        return v

    def symbol(self, table) -> int:
        t, rb = table
        if self.nbits < 32:
            self.val |= int.from_bytes(self.data[self.pos:self.pos + 8], "little") << self.nbits
            self.pos += 8
            self.nbits += 64
        e = t[self.val & ((1 << rb) - 1)]
        if e < 0:
            e = t[(-e >> 4) + ((self.val >> rb) & ((1 << (-e & 15)) - 1))]
        n = e & 15
        self.val >>= n
        self.nbits -= n
        return e >> 4

    def consumed(self) -> int:
        return 8 * self.pos - self.nbits

    def overrun(self) -> bool:
        return self.consumed() > self.limit


def build_table(lengths, root: int = ROOT_BITS):
    """A canonical prefix code from its code lengths -> (table, root bits):
    entries (symbol << 4) | length, indexed by the next root bits; an entry
    -((offset << 4) | bits) points to a second-level table. One coded symbol
    reads no bits; otherwise the code must be complete (libwebp's rule)."""
    syms = [s for s, n in enumerate(lengths) if n]
    if not syms:
        raise ValueError("VP8L prefix code without a symbol")
    if len(syms) == 1:
        return [syms[0] << 4], 0
    if sum(1 << (15 - lengths[s]) for s in syms) != 1 << 15:
        raise ValueError("VP8L prefix code is not complete")
    syms.sort(key=lambda s: (lengths[s], s))
    rb = min(lengths[syms[-1]], root)
    t = [0] * (1 << rb)
    longer = {}
    code, prev = 0, lengths[syms[0]]
    for s in syms:
        n = lengths[s]
        code <<= n - prev
        prev = n
        r = _REV15[code] >> (15 - n)
        if n <= rb:
            t[r::1 << n] = [(s << 4) | n] * (1 << (rb - n))
        else:
            longer.setdefault(r & ((1 << rb) - 1), []).append((r >> rb, n, s))
        code += 1
    for head, codes in longer.items():
        sb = max(n for _, n, _ in codes) - rb
        off = len(t)
        t.extend([0] * (1 << sb))
        for r, n, s in codes:
            t[off + r:off + (1 << sb):1 << (n - rb)] = [(s << 4) | n] * (1 << (sb - n + rb))
        t[head] = -((off << 4) | sb)
    return t, rb


def _read_code(br: _Bits, size: int):
    """One prefix code of an alphabet of `size` symbols -> its table."""
    lengths = [0] * size
    if br.read(1):                               # simple: one or two symbols
        two = br.read(1)
        s = br.read(8 if br.read(1) else 1)
        if s < size:
            lengths[s] = 1
        if two:
            s = br.read(8)
            if s < size:
                lengths[s] = 1
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[CODE_LENGTH_ORDER[i]] = br.read(3)
        cl_table = build_table(cl, 7)
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > size:
                raise ValueError("VP8L code lengths run past their alphabet")
        else:
            max_symbol = size
        sym, prev = 0, 8
        while sym < size:
            if max_symbol == 0:
                break
            max_symbol -= 1
            c = br.symbol(cl_table)
            if c < 16:
                lengths[sym] = c
                sym += 1
                if c:
                    prev = c
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
                rep = br.read(extra) + offset
                if sym + rep > size:
                    raise ValueError("VP8L code length repeat runs past its alphabet")
                lengths[sym:sym + rep] = [prev if c == 16 else 0] * rep
                sym += rep
    if br.overrun():
        raise ValueError("VP8L data end inside a prefix code")
    return build_table(lengths)


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _copy_length(sym: int, br: _Bits) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _plane_distance(code: int, xsize: int) -> int:
    if code > 120:
        return code - 120
    d = CODE_TO_PLANE[code - 1]
    return max(1, (d >> 4) * xsize + 8 - (d & 15))


class _Stream:
    """One entropy-coded image: its colour cache and prefix code groups."""

    def __init__(self, br: _Bits, xsize: int, ysize: int, level0: bool):
        self.cache_bits = 0
        if br.read(1):
            self.cache_bits = br.read(4)
            if not 1 <= self.cache_bits <= MAX_CACHE_BITS:
                raise ValueError(f"VP8L colour cache of {self.cache_bits} bits")
        self.meta, self.meta_bits, self.meta_xsize = None, 0, 0
        n_groups = 1
        if level0 and br.read(1):
            self.meta_bits = br.read(3) + 2
            self.meta_xsize = _subsample(xsize, self.meta_bits)
            image = decode_image(br, self.meta_xsize, _subsample(ysize, self.meta_bits))
            self.meta = ((image >> 8) & 0xFFFF).astype(np.int64).ravel().tolist()
            n_groups = max(self.meta) + 1
        if br.overrun():
            raise ValueError("VP8L data end inside the entropy image")
        used = set(self.meta) if self.meta is not None else {0}
        sizes = list(ALPHABET)
        sizes[0] += (1 << self.cache_bits) if self.cache_bits else 0
        self.groups = {}
        for g in range(n_groups):
            # every group is read and checked; only the groups the entropy image names are kept
            codes = [_read_code(br, size) for size in sizes]
            if g in used:
                self.groups[g] = codes


def decode_image(br: _Bits, xsize: int, ysize: int, stream: _Stream = None,
                 alpha8: bool = False) -> np.ndarray:
    """The entropy-coded pixels of one image -> ARGB uint32 [ysize, xsize].
    A sub-image (transform data, the entropy image) reads its own header
    here; the main image passes its already-read stream. With `alpha8`
    (libwebp's 8-bit alpha path) data that end during the symbol that
    completes the image are accepted, as libwebp accepts them there."""
    if stream is None:
        stream = _Stream(br, xsize, ysize, level0=False)
    total = xsize * ysize
    out = [0] * total
    cache_bits = stream.cache_bits
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    meta, mbits, mxs = stream.meta, stream.meta_bits, stream.meta_xsize
    if meta is None:                            # one group: looked up at each row's start
        meta, mbits, mxs = [0], 30, 1
    mask = (1 << mbits) - 1
    groups = stream.groups
    data = br.data
    val, nbits, pos = br.val, br.nbits, br.pos
    pix = col = row = 0
    cached = 0
    g = groups[meta[0]]
    (gt, grb), (rt, rrb), (bt, brb), (at, arb) = g[:4]
    lit_limit = NUM_LITERALS + NUM_LENGTHS
    while pix < total:
        if (col & mask) == 0:
            g = groups[meta[(row >> mbits) * mxs + (col >> mbits)]]
            (gt, grb), (rt, rrb), (bt, brb), (at, arb) = g[:4]
        if nbits < 64:
            if 8 * pos - nbits > br.limit:      # past the data's end: libwebp stops here
                break
            val |= int.from_bytes(data[pos:pos + 16], "little") << nbits
            pos += 16
            nbits += 128
        e = gt[val & ((1 << grb) - 1)]
        if e < 0:
            e = gt[(-e >> 4) + ((val >> grb) & ((1 << (-e & 15)) - 1))]
        n = e & 15
        val >>= n
        nbits -= n
        code = e >> 4
        if code < NUM_LITERALS:
            e = rt[val & ((1 << rrb) - 1)]
            if e < 0:
                e = rt[(-e >> 4) + ((val >> rrb) & ((1 << (-e & 15)) - 1))]
            n = e & 15
            val >>= n
            red = e >> 4
            nbits -= n
            e = bt[val & ((1 << brb) - 1)]
            if e < 0:
                e = bt[(-e >> 4) + ((val >> brb) & ((1 << (-e & 15)) - 1))]
            n = e & 15
            val >>= n
            blue = e >> 4
            nbits -= n
            e = at[val & ((1 << arb) - 1)]
            if e < 0:
                e = at[(-e >> 4) + ((val >> arb) & ((1 << (-e & 15)) - 1))]
            n = e & 15
            val >>= n
            nbits -= n
            out[pix] = ((e >> 4) << 24) | (red << 16) | (code << 8) | blue
            pix += 1
            col += 1
            if col == xsize:
                col = 0
                row += 1
        elif code < lit_limit:
            br.val, br.nbits, br.pos = val, nbits, pos
            length = _copy_length(code - NUM_LITERALS, br)
            dist = _plane_distance(_copy_length(br.symbol(g[4]), br), xsize)
            val, nbits, pos = br.val, br.nbits, br.pos
            if 8 * pos - nbits > br.limit and not (alpha8 and pix + length >= total):
                break
            if dist > pix or length > total - pix:
                raise ValueError("VP8L backward reference outside the image")
            if dist >= length:
                out[pix:pix + length] = out[pix - dist:pix - dist + length]
            else:
                for i in range(pix, pix + length):
                    out[i] = out[i - dist]
            pix += length
            col += length
            while col >= xsize:
                col -= xsize
                row += 1
            if col & mask:
                g = groups[meta[(row >> mbits) * mxs + (col >> mbits)]]
                (gt, grb), (rt, rrb), (bt, brb), (at, arb) = g[:4]
        elif cache is not None and code < lit_limit + len(cache):
            # the cache holds every pixel decoded so far, inserted in order: the ones since the
            # last lookup go in now
            for i in range(cached, pix):
                a = out[i]
                cache[((a * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = a
            cached = pix
            out[pix] = cache[code - lit_limit]
            pix += 1
            col += 1
            if col == xsize:
                col = 0
                row += 1
        else:
            raise ValueError("VP8L colour cache code without a cache")
        if alpha8 and 8 * pos - nbits > br.limit:
            break
    br.val, br.nbits, br.pos = val, nbits, pos
    if br.overrun() and not (alpha8 and pix >= total):
        raise ValueError("VP8L data end before the last pixel")
    return np.array(out, np.uint32).reshape(ysize, xsize)


# ---------------------------------------------------------------------------
# transforms


def _add_pixels(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-channel sums mod 256 of packed ARGB words."""
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) \
        | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _average2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _select(left: int, top: int, top_left: int) -> int:
    d = 0
    for s in (24, 16, 8, 0):
        tl = (top_left >> s) & 0xFF
        d += abs(((left >> s) & 0xFF) - tl) - abs(((top >> s) & 0xFF) - tl)
    return top if d <= 0 else left


def _clamp_full(left: int, top: int, top_left: int) -> int:
    v = 0
    for s in (24, 16, 8, 0):
        c = ((left >> s) & 0xFF) + ((top >> s) & 0xFF) - ((top_left >> s) & 0xFF)
        v |= (0 if c < 0 else 255 if c > 255 else c) << s
    return v


def _clamp_half(avg: int, top_left: int) -> int:
    v = 0
    for s in (24, 16, 8, 0):
        a = (avg >> s) & 0xFF
        d = a - ((top_left >> s) & 0xFF)
        c = a + ((d + (d < 0)) >> 1)            # C's division: toward zero
        v |= (0 if c < 0 else 255 if c > 255 else c) << s
    return v


_FROM_TOP = (0, 2, 3, 4, 8, 9, 14, 15)           # modes that do not read the left pixel


def _predict_from_top(mode, top, tr, tl):
    """Predictions of the modes that read only the row above (vectorised);
    14 and 15 are libwebp's black sentinels."""
    out = np.full(mode.shape, 0xFF000000, np.uint32)
    for m, v in ((2, top), (3, tr), (4, tl), (8, _average2(tl, top)), (9, _average2(top, tr))):
        sel = mode == m
        out[sel] = v[sel]
    return out


def _inverse_predictor(res: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    h, w = res.shape
    out = np.empty_like(res)
    row = res[0].tolist()
    acc = 0xFF000000                            # the first row: black, then left prediction
    for x in range(w):
        v = row[x]
        acc = ((((acc & 0xFF00FF00) + (v & 0xFF00FF00)) & 0xFF00FF00)
               | (((acc & 0x00FF00FF) + (v & 0x00FF00FF)) & 0x00FF00FF))
        row[x] = acc
    out[0] = row
    col_mode = np.arange(w) >> bits
    for y in range(1, h):
        mode = ((modes[y >> bits, col_mode] >> 8) & 0xF).astype(np.int64)
        mode[0] = 2
        first = _add_pixels(int(res[y, 0]), int(out[y - 1, 0]))
        top = out[y - 1]
        tr = np.empty_like(top)
        tr[:-1] = top[1:]
        tr[-1] = first                          # the rightmost pixel's top-right: this row's first
        tl = np.empty_like(top)
        tl[1:] = top[:-1]
        tl[0] = top[0]
        from_top = np.isin(mode, _FROM_TOP)
        line = _add_pixels(res[y], _predict_from_top(mode, top, tr, tl))
        line[0] = first
        left_x = np.flatnonzero(~from_top)
        if len(left_x):
            cur = line.tolist()
            r = res[y].tolist()
            t, trl, tll = top.tolist(), tr.tolist(), tl.tolist()
            ms = mode.tolist()
            for x in left_x.tolist():
                m, left = ms[x], cur[x - 1]
                if m == 1:
                    p = left
                elif m == 5:
                    p = _average2(_average2(left, trl[x]), t[x])
                elif m == 6:
                    p = _average2(left, tll[x])
                elif m == 7:
                    p = _average2(left, t[x])
                elif m == 10:
                    p = _average2(_average2(left, tll[x]), _average2(t[x], trl[x]))
                elif m == 11:
                    p = _select(left, t[x], tll[x])
                elif m == 12:
                    p = _clamp_full(left, t[x], tll[x])
                else:
                    p = _clamp_half(_average2(left, t[x]), tll[x])
                v = r[x]
                cur[x] = ((((v & 0xFF00FF00) + (p & 0xFF00FF00)) & 0xFF00FF00)
                          | (((v & 0x00FF00FF) + (p & 0x00FF00FF)) & 0x00FF00FF))
            line = np.array(cur, np.uint32)
        out[y] = line
    return out


def _inverse_cross_color(img: np.ndarray, bits: int, codes: np.ndarray) -> np.ndarray:
    h, w = img.shape
    c = codes[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits].astype(np.int64)

    def s8(v):
        return ((v & 0xFF) ^ 0x80) - 0x80

    a = img.astype(np.int64)
    green = s8(a >> 8)
    red = ((a >> 16) + ((s8(c) * green) >> 5)) & 0xFF
    blue = ((a + ((s8(c >> 8) * green) >> 5) + ((s8(c >> 16) * s8(red)) >> 5)) & 0xFF)
    return ((a & 0xFF00FF00) | (red << 16) | blue).astype(np.uint32)


def _inverse_subtract_green(img: np.ndarray) -> np.ndarray:
    g = (img >> 8) & 0xFF
    return _add_pixels(img, (g << 16) | g)


def _inverse_color_indexing(img: np.ndarray, bits: int, width: int,
                            palette: np.ndarray) -> np.ndarray:
    idx = ((img >> 8) & 0xFF).astype(np.int64)
    if bits:
        per = 1 << bits
        bpp = 8 >> bits
        x = np.arange(width)
        idx = (idx[:, x >> bits] >> (bpp * (x & (per - 1)))) & ((1 << bpp) - 1)
    return palette[idx]


def _read_transforms(br: _Bits, xsize: int, ysize: int):
    """The transforms in reading order: (type, bits, width of the image the
    inverse produces, data) each; and the width of the coded image."""
    transforms, seen = [], set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("VP8L transform used twice")
        seen.add(kind)
        if kind in (PREDICTOR, CROSS_COLOR):
            bits = br.read(3) + 2
            data = decode_image(br, _subsample(xsize, bits), _subsample(ysize, bits))
            transforms.append((kind, bits, xsize, data))
        elif kind == COLOR_INDEXING:
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            colors = decode_image(br, n, 1)[0]
            palette = np.zeros(1 << (8 >> bits), np.uint32)
            palette[:n] = np.cumsum(colors.view(np.uint8).reshape(n, 4), axis=0,
                                    dtype=np.uint8).reshape(-1).view(np.uint32)
            transforms.append((kind, bits, xsize, palette))
            xsize = _subsample(xsize, bits)
        else:
            transforms.append((kind, 0, xsize, None))
    return transforms, xsize


def _apply_inverse(img: np.ndarray, transforms) -> np.ndarray:
    for kind, bits, width, data in reversed(transforms):
        if kind == PREDICTOR:
            img = _inverse_predictor(img, bits, data)
        elif kind == CROSS_COLOR:
            img = _inverse_cross_color(img, bits, data)
        elif kind == SUBTRACT_GREEN:
            img = _inverse_subtract_green(img)
        else:
            img = _inverse_color_indexing(img, bits, width, data)
    return img


def decode_stream(br: _Bits, width: int, height: int, alpha: bool = False) -> np.ndarray:
    """A level-0 image (transforms, colour cache, meta codes, pixels) ->
    ARGB uint32 [height, width]."""
    transforms, xsize = _read_transforms(br, width, height)
    stream = _Stream(br, xsize, height, level0=True)
    # libwebp's 8-bit alpha path: a palette alone, no cache, one-symbol red, blue and alpha
    alpha8 = (alpha and len(transforms) == 1 and transforms[0][0] == COLOR_INDEXING
              and not stream.cache_bits
              and all(len(g[k][0]) == 1 for g in stream.groups.values() for k in (1, 2, 3)))
    pixels = decode_image(br, xsize, height, stream, alpha8=alpha8)
    return _apply_inverse(pixels, transforms)


def vp8l_size(data: bytes) -> tuple:
    """(H, W, alpha_is_used) of a VP8L bitstream, from its header."""
    if len(data) < 5 or data[0] != SIGNATURE or data[4] >> 5:
        raise ValueError("not a VP8L bitstream")
    bits = int.from_bytes(data[1:5], "little")
    return ((bits >> 14) & 0x3FFF) + 1, (bits & 0x3FFF) + 1, (bits >> 28) & 1


def read_vp8l(data: bytes):
    """A VP8L bitstream -> (uint8 [H, W, 4] RGBA, alpha_is_used)."""
    h, w, alpha_used = vp8l_size(data)
    br = _Bits(data)
    br.read(8)
    br.read(32)
    argb = decode_stream(br, w, h)
    rgba = np.stack([(argb >> s) & 0xFF for s in (16, 8, 0, 24)], -1).astype(np.uint8)
    return rgba, alpha_used


def decode_alpha_stream(data: bytes, width: int, height: int) -> np.ndarray:
    """A compressed ALPH chunk's bitstream (after its 1-byte header) -> the
    unfiltered alpha plane uint8 [height, width] (the green channel)."""
    br = _Bits(data)
    argb = decode_stream(br, width, height, alpha=True)
    return ((argb >> 8) & 0xFF).astype(np.uint8)
