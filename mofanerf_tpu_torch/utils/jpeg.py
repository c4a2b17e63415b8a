"""JPEG files without Pillow: the port's counterpart of what `imageio.v2.imread`
returns for a JPEG (Pillow over libjpeg-turbo 3, at Pillow's defaults).

- Decoding: Huffman-coded baseline and extended sequential (SOF0, SOF1),
  progressive (SOF2: DC first and refinement scans, AC spectral selection
  with EOB runs, AC refinement with correction bits, restart intervals in
  every scan type) and lossless (SOF3, predictors 1-7, point transform)
  frames, and arithmetic-coded sequential and progressive ones (SOF9,
  SOF10, with DAC conditioning; `jpeg_arith.py`), at 8-bit precision; any
  sampling factors 1-4. The Huffman and arithmetic stages are pure Python
  (the Huffman one on 65536-entry lookup tables); the rest follows libjpeg's
  defaults in integer arithmetic, vectorised over blocks: block smoothing of
  progressive files whose scans leave low coefficients' bits unknown (a file
  ended before its last scans), the "islow" IDCT as libjpeg-turbo's SIMD code
  computes it, "fancy" triangle upsampling for h2v1, h1v2 and h2v2 ratios
  and box replication for every other integer ratio (lossless frames
  replicate at every ratio), and the fixed-point YCbCr -> RGB transform.
- Markers as libjpeg reads them: other bytes between markers skipped, RSTn
  and TEM without a length; a frame of one scan of every component may end
  after that scan (libjpeg has put out every row before it looks for EOI),
  any other must reach its EOI. Segment lengths and tables checked as
  jdmarker.c and Pillow's header parser check them; a sequential frame
  without Huffman tables 0 and 1 gets the standard ones (jstdhuff.c).
- Scans that break off (`_ScanReader`): data that ends at a marker before
  its MCUs do is read as libjpeg reads it, zero bits to finish the MCU and
  the rest of the restart interval left as it stands (a lossless scan
  finishes its MCU row); missing or out-of-order restart markers resync as
  jpeg_resync_to_restart does; a Huffman code no table entry matches
  decodes as 0 after 17 bits. Block smoothing takes, for the rows past the
  last scan's data, the progression status from before that scan.
- Colour, as libjpeg picks it and Pillow returns it: 1 component -> uint8
  [H, W]; 3 -> [H, W, 3], YCbCr unless an Adobe marker says RGB (transform
  0) without a JFIF marker, or the component ids are "R", "G", "B"; 4 ->
  [H, W, 4] CMYK, inverted as Pillow inverts it ("CMYK;I"), converted from
  YCCK first when an Adobe marker's transform is not 0.
- Refused (ValueError), where imageio refuses too: samples of other than 8
  bits, 2-component frames, non-integral sampling ratios, lossless YCbCr or
  YCCK (libjpeg-turbo converts no lossless colours), lossless restart
  intervals that are not whole MCU rows, data that runs past the file's end,
  bad segment lengths and Huffman or quantisation tables, arithmetic-coded
  lossless (SOF11) and hierarchical frames (SOF5-SOF7, SOF13-SOF15), reserved
  markers, an arithmetic-coded scan that needs bytes past the 64 KiB blocks
  Pillow has handed libjpeg (`jpeg_arith.py`); no other exception type on
  the cut and bit-flipped files tried. One file imageio reads is refused: a sequential file whose
  data ends the file with no marker (a damaged EOI), which libjpeg finishes
  when its bit reader never has to refill past the end.
- A small baseline encoder (4:4:4, the Annex K quantisation and Huffman
  tables)."""
from __future__ import annotations

import re
import struct
from array import array

import numpy as np

from mofanerf_tpu_torch.utils import jpeg_arith

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

# frame markers: SOF0 baseline, SOF1 extended sequential, SOF2 progressive, SOF3 lossless,
# and their arithmetic-coded counterparts SOF9-SOF11: (kind, arithmetic)
_SOF_KINDS = {0xC0: ("sequential", False), 0xC1: ("sequential", False),
              0xC2: ("progressive", False), 0xC3: ("lossless", False),
              0xC9: ("sequential", True), 0xCA: ("progressive", True),
              0xCB: ("lossless", True)}
# markers libjpeg reads without a length (RSTn, TEM), the frames it refuses (the
# hierarchical SOF5-SOF7 and SOF13-SOF15, and JPG), and every marker it knows (it
# refuses the reserved rest)
_PARAMETERLESS = set(range(0xD0, 0xD8)) | {0x01}
_UNSUPPORTED_FRAMES = {0xC5, 0xC6, 0xC7, 0xC8, 0xCD, 0xCE, 0xCF}
_KNOWN = (set(_SOF_KINDS) | _PARAMETERLESS | _UNSUPPORTED_FRAMES
          | {0xC4, 0xCC, 0xD8, 0xD9, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE} | set(range(0xE0, 0xF0)))


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
    (0 where no code matches); None for counts that need a code of all ones
    or longer than its length, which jdhuff.c refuses when a scan uses the
    table."""
    codes = _canonical_codes(counts, symbols)
    if any(code >> length or code == (1 << length) - 1 for _, code, length in codes):
        return None
    lut = [0] * 65536
    for sym, code, length in codes:
        start = code << (16 - length)
        lut[start:start + (1 << (16 - length))] = [(length << 8) | sym] * (1 << (16 - length))
    return lut


# ---------------------------------------------------------------------------
# integer IDCT (libjpeg's "islow", as libjpeg-turbo's SIMD jsimd_idct_islow
# computes it on x86), vectorised over blocks

_CONST_BITS, _PASS1_BITS = 13, 2
_F = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
      "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
      "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _wrap(x, bits):
    """x in `bits`-bit two's complement (a SIMD lane's wrap-around)."""
    half = 1 << (bits - 1)
    return ((x + half) & ((half << 1) - 1)) - half


def _descale(x, n):
    """Round and shift right by n in 32-bit lanes, then saturate to 16 bits
    (the SIMD code's paddd, psrad and packssdw)."""
    return np.clip(_wrap(x + (1 << (n - 1)), 32) >> n, -32768, 32767)


def _idct_1d(s):
    """One pass of jidctint.c's islow over axis -2 of int64 [..., 8, 8] (rows
    0..7 of the axis are the 8 inputs, 16-bit); returns the 8 outputs before
    descaling. The sums in0 +- in4, in7 + in3 and in5 + in1 are taken in 16
    bits, as the SIMD code takes them; every product and later sum is exact
    (the 32-bit wrap is applied with the descaling)."""
    z2, z3 = s[..., 2, :], s[..., 6, :]
    z1 = (z2 + z3) * _F["0_541196100"]
    tmp2 = z1 - z3 * _F["1_847759065"]
    tmp3 = z1 + z2 * _F["0_765366865"]
    tmp0 = _wrap(s[..., 0, :] + s[..., 4, :], 16) << _CONST_BITS
    tmp1 = _wrap(s[..., 0, :] - s[..., 4, :], 16) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = s[..., 7, :], s[..., 5, :], s[..., 3, :], s[..., 1, :]
    z1, z2 = t0 + t3, t1 + t2
    z3, z4 = _wrap(t0 + t2, 16), _wrap(t1 + t3, 16)
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


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Quantised coefficients int [B, 8, 8] (natural order, [v, u]) and
    their quantisation table [8, 8] -> samples uint8 [B, 8, 8], bit for bit
    as libjpeg-turbo's jsimd_idct_islow (SSE2 / AVX2): the dequantised values
    kept to 16 bits, a block whose AC rows 1-7 are zero passed through the
    first pass as its first row << 2 (16-bit), each pass's outputs saturated
    to 16 bits, the samples to [-128, 127] before the +128 level shift. On
    coefficients whose passes stay in range (every well-formed file tried)
    this equals the C jpeg_idct_islow and its range-limit table."""
    c = coef.astype(np.int64)
    deq = _wrap(c * q.astype(np.int64), 16)
    ws = _descale(_idct_1d(deq), _CONST_BITS - _PASS1_BITS)                 # columns
    dc_only = ~c[:, 1:, :].any(axis=(1, 2))
    ws[dc_only] = _wrap(deq[dc_only, :1, :] << _PASS1_BITS, 16)
    out = _descale(_idct_1d(ws.swapaxes(-1, -2)), _CONST_BITS + _PASS1_BITS + 3)
    return (np.clip(out.swapaxes(-1, -2), -128, 127) + 128).astype(np.uint8)


# ---------------------------------------------------------------------------
# upsampling and colour (libjpeg's jdsample.c and jdcolor.c)


def _upsample_h2(x: np.ndarray, width: int) -> np.ndarray:
    """h2v1 fancy upsampling along axis 1 of int [H, w] (w = the component's
    real width): 3/4 nearer + 1/4 further sample, ends copied."""
    x = x[:, :width].astype(np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * width), np.int64)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0], out[:, -1] = x[:, 0], x[:, -1]
    return out


def _context_rows(x: np.ndarray, height: int):
    """The rows of int [H, W] up to the component's real height, with the rows
    above and below each (the edge rows repeated), as libjpeg's context rows."""
    x = x[:height].astype(np.int64)
    return (x, np.concatenate([x[:1], x[:-1]], axis=0),
            np.concatenate([x[1:], x[-1:]], axis=0))


def _upsample_h1v2(x: np.ndarray, height: int) -> np.ndarray:
    """h1v2 fancy upsampling (libjpeg-turbo 2.1+): each output row 3/4 of the
    nearer input row + 1/4 of the further, rounding biases 1 (upper) and 2."""
    x, above, below = _context_rows(x, height)
    out = np.empty((2 * height, x.shape[1]), np.int64)
    out[0::2] = (3 * x + above + 1) >> 2
    out[1::2] = (3 * x + below + 2) >> 2
    return out


def _upsample_h2v2(x: np.ndarray, height: int, width: int) -> np.ndarray:
    """h2v2 fancy upsampling of int [H, W] at the component's real size:
    vertical 3:1 column sums, then a horizontal 3:1 blend with libjpeg's
    rounding (8 and 7); the rows beyond each edge repeat the edge row."""
    x, above, below = _context_rows(x[:, :width], height)
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


def _upsample(plane: np.ndarray, comp, hmax: int, vmax: int, fancy: bool) -> np.ndarray:
    """A component's decoded plane at the frame's full sampling, as
    jdsample.c's jinit_upsampler picks the method for its ratio."""
    if hmax % comp.h or vmax % comp.v:
        raise ValueError(f"JPEG sampling ratio {hmax}/{comp.h} x {vmax}/{comp.v} is not "
                         "integral")
    rx, ry = hmax // comp.h, vmax // comp.v
    if (rx, ry) == (1, 1):
        return plane
    if fancy and (rx, ry) == (2, 1) and comp.width > 2:
        return _upsample_h2(plane[:comp.height], comp.width)
    if fancy and (rx, ry) == (1, 2):
        return _upsample_h1v2(plane, comp.height)
    if fancy and (rx, ry) == (2, 2) and comp.width > 2:
        return _upsample_h2v2(plane, comp.height, comp.width)
    return np.repeat(np.repeat(plane, ry, axis=0), rx, axis=1)


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
# entropy-coded segments and the Huffman stage


class _Component:
    def __init__(self, ident, h, v, tq):
        if not (1 <= h <= 4 and 1 <= v <= 4):
            raise ValueError(f"JPEG sampling factors {h} x {v} outside 1..4")
        self.ident, self.h, self.v, self.tq = ident, h, v, tq
        self.coef = None    # array('i') of [blocks_y * blocks_x * 64], zig-zag order
        self.blocks_x = self.blocks_y = 0   # the MCU-padded block grid
        self.width = self.height = 0        # samples the component really has
        self.bits = [-1] * 64               # progressive: the last Al of each coefficient
        self.prev_bits = [-1] * 64          # ... before the last scan of this component
        self.q = None                       # the quantisation table latched at its first scan
        self.samples = None                 # lossless: the decoded samples


_UNSTUFF = re.compile(rb"\xff+\x00")
_i16 = jpeg_arith._i16
_BAD_CODE = 17 << 8     # what a code no table entry matches decodes as: 17 bits, symbol 0
_PAD = 4096     # zero bytes after an interval's data: more than one MCU of a DCT scan reads


class _ScanReader:
    """A Huffman scan's entropy-coded data as libjpeg reads it (jdhuff.c's
    bit reader over jdmarker.c's read_restart_marker and
    jpeg_resync_to_restart).

    A restart interval's data runs to the next marker, which is then latched;
    fill_bit_buffer reads a run of 0xFF bytes then 0x00 as one 0xFF, and a
    run before a marker code as padding. A decoder that needs bits past the
    data reads zeros to finish its MCU, and `insufficient` is set: the
    interval's later MCUs are left as they stand. At a restart the latched
    marker is resolved by `jpeg_arith.resync_action`; a marker left latched
    gives the interval no data, and `insufficient` is cleared only when none
    is. `last_good` is the iMCU row of the last MCU begun with data
    (jdcoefct.c's last_good_iMCU_row, which block smoothing reads)."""

    def __init__(self, data: bytes, pos: int, pad: int = _PAD):
        self.data, self.pos, self.pad = data, pos, pad
        self.marker, self.marker_pos = 0, pos
        self.insufficient, self.next_rst, self.last_good = False, 0, -1
        self.buf, self.n_bits = b"", 0

    def _latch(self) -> int:
        """Latch the next marker (jdmarker.c's next_marker); the position
        where the data before its 0xFF run ends."""
        i = jpeg_arith.marker_after(self.data, self.pos)
        if i >= len(self.data):
            raise ValueError("JPEG entropy-coded data runs past the end of the file")
        end = i
        while end > self.pos and self.data[end - 1] == 0xFF:
            end -= 1
        self.marker, self.marker_pos, self.pos = self.data[i + 1], i, i + 2
        return end

    def _restart(self) -> None:
        while True:
            action = jpeg_arith.resync_action(self.marker, self.next_rst)
            if action == 1:
                self.marker = 0
                break
            if action == 3:
                break
            self._latch()
        self.next_rst = (self.next_rst + 1) & 7
        if not self.marker:
            self.insufficient = False

    def intervals(self, n_units: int, per: int, row_of):
        """Yield the first unit (MCU, or MCU row of a lossless scan) of each
        restart interval of `per` units and the units it holds, with
        `self.buf` (the interval's data and `pad` zero bytes) and
        `self.n_bits` (its bits of data) set; `row_of(unit)` is its iMCU
        row."""
        for start in range(0, n_units, per):
            if not self.insufficient:   # consume_data's test precedes the restart
                self.last_good = row_of(start)
            if start:
                self._restart()
            seg = b""
            if not self.marker:
                begin = self.pos
                seg = _UNSTUFF.sub(b"\xff", self.data[begin:self._latch()])
            self.buf, self.n_bits = seg + bytes(self.pad), 8 * len(seg)
            yield start, min(per, n_units - start)

    def mcus(self, n_mcu: int, restart: int, row_of):
        """Yield (MCU, whether it begins its interval) for each MCU that
        libjpeg decodes: the MCUs of an interval up to the one that read past
        its data (the decoder sets `insufficient` after it)."""
        for start, count in self.intervals(n_mcu, restart or n_mcu, row_of):
            for mcu in range(start, start + count):
                if self.insufficient:
                    break
                if mcu > start:
                    self.last_good = row_of(mcu)
                yield mcu, mcu == start


def _scan_layout(scan, mcus_x, mcus_y, unit=8):
    """(units, MCUs a row, MCUs): the data units of one MCU as (component,
    dc table, ac table, dy, dx), the scan's MCU grid (a non-interleaved
    scan's MCU is one unit of its component's own grid)."""
    if len(scan) > 1:
        units = [(c, dc, ac, dy, dx) for c, dc, ac in scan for dy in range(c.v)
                 for dx in range(c.h)]
        if len(units) > 10:     # libjpeg's D_MAX_BLOCKS_IN_MCU
            raise ValueError(f"JPEG scan of {len(units)} data units an MCU (at most 10)")
        return units, mcus_x, mcus_x * mcus_y
    c = scan[0][0]
    n_x = -(-c.width // unit)
    return [(c, scan[0][1], scan[0][2], 0, 0)], n_x, n_x * -(-c.height // unit)


def _receive_dc(buf, p, table):
    """One DC difference (or lossless difference) at bit `p` of `buf`: its
    Huffman category, then that many bits, sign-extended (T.81 F.2.2.1); the
    category 16 of lossless JPEG has no extra bits (H.1.2.2). A code no
    table entry matches reads 17 bits and decodes as 0, as jdhuff.c's
    jpeg_huff_decode fakes it. -> (diff, p)."""
    q = p >> 3
    win = int.from_bytes(buf[q:q + 5], "big")
    o = p & 7
    code = table[(win >> (24 - o)) & 0xFFFF] or _BAD_CODE
    ln, s = code >> 8, code & 0xFF
    p += ln
    if not s:
        return 0, p
    if s == 16:
        return 32768, p
    bits = (win >> (40 - o - ln - s)) & ((1 << s) - 1)
    return (bits if bits >> (s - 1) else bits - (1 << s) + 1), p + s


def _correct(coef, base, k, se, r, buf, p, p1, m1):
    """The correction bits of an AC refinement scan (jdphuff.c): from `k`
    through `se`, one bit for each coefficient that already holds a value,
    stopping at the zero coefficient that has `r` zeros before it (64: none
    stops it). -> (k, p)."""
    while k <= se:
        c = coef[base + k]
        if c:
            if (buf[p >> 3] >> (7 - (p & 7))) & 1 and not c & p1:
                coef[base + k] = _i16(c + (p1 if c >= 0 else m1))
            p += 1
        else:
            r -= 1
            if r < 0:
                break
        k += 1
    return k, p


def _row_of(interleaved, n_mcu_x, scan):
    """An MCU's iMCU row: its MCU row, or in a one-component scan (an MCU a
    block) its block row over the component's vertical sampling factor."""
    v = 1 if interleaved else scan[0][0].v
    return lambda mcu: mcu // n_mcu_x // v


def _decode_scan(rd, scan, mcus_x, mcus_y, restart):
    """Huffman-decode one sequential scan into each component's coefficients.
    `scan`: [(component, dc table, ac table)]; `rd` the scan's _ScanReader.
    A run past the last zig-zag index lands on index 63, as jdhuff.c's
    natural-order table's extra entries put it."""
    interleaved = len(scan) > 1
    units, n_mcu_x, n_mcu = _scan_layout(scan, mcus_x, mcus_y)
    for mcu, first in rd.mcus(n_mcu, restart, _row_of(interleaved, n_mcu_x, scan)):
        if first:
            buf, n_bits, p = rd.buf, rd.n_bits, 0
            preds = {id(u[0]): 0 for u in units}
        my, mx = divmod(mcu, n_mcu_x)
        for comp, dcl, acl, dy, dx in units:
            if interleaved:
                by, bx = my * comp.v + dy, mx * comp.h + dx
            else:
                by, bx = my, mx
            coef = comp.coef
            base = (by * comp.blocks_x + bx) * 64
            diff, p = _receive_dc(buf, p, dcl)
            pred = preds[id(comp)] + diff
            preds[id(comp)] = pred
            coef[base] = ((pred + 0x8000) & 0xFFFF) - 0x8000     # a JCOEF
            k = 1
            while k < 64:
                q = p >> 3
                win = int.from_bytes(buf[q:q + 5], "big")
                o = p & 7
                code = acl[(win >> (24 - o)) & 0xFFFF] or _BAD_CODE
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
                coef[base + (k if k < 64 else 63)] = bits if bits >> (s - 1) \
                    else bits - (1 << s) + 1
                k += 1
        if p > n_bits:
            rd.insufficient = True


def _decode_progressive_scan(rd, scan, mcus_x, mcus_y, restart, ss, se, ah, al):
    """Huffman-decode one progressive scan (jdphuff.c) into the coefficients
    the earlier scans left: DC first (Ah = 0) or refinement, or an AC band
    Ss..Se of one component, first or refinement, with EOB runs."""
    interleaved = len(scan) > 1
    units, n_mcu_x, n_mcu = _scan_layout(scan, mcus_x, mcus_y)
    p1, m1 = 1 << al, -(1 << al)
    for mcu, first in rd.mcus(n_mcu, restart, _row_of(interleaved, n_mcu_x, scan)):
        if first:
            buf, n_bits, p = rd.buf, rd.n_bits, 0
            preds = {id(u[0]): 0 for u in units}
            eobrun = 0
        my, mx = divmod(mcu, n_mcu_x)
        for comp, dcl, acl, dy, dx in units:
            if interleaved:
                by, bx = my * comp.v + dy, mx * comp.h + dx
            else:
                by, bx = my, mx
            coef = comp.coef
            base = (by * comp.blocks_x + bx) * 64
            if ss == 0:
                if ah:      # DC refinement: one bit
                    if (buf[p >> 3] >> (7 - (p & 7))) & 1:
                        coef[base] = _i16(coef[base] | p1)
                    p += 1
                    continue
                diff, p = _receive_dc(buf, p, dcl)
                pred = preds[id(comp)] + diff
                preds[id(comp)] = pred
                coef[base] = _i16(pred * p1)
                continue
            if ah == 0:     # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    q = p >> 3
                    win = int.from_bytes(buf[q:q + 5], "big")
                    o = p & 7
                    code = acl[(win >> (24 - o)) & 0xFFFF] or _BAD_CODE
                    ln, rs = code >> 8, code & 0xFF
                    p += ln
                    r, s = rs >> 4, rs & 15
                    o += ln
                    if s:
                        k += r
                        bits = (win >> (40 - o - s)) & ((1 << s) - 1)
                        p += s
                        coef[base + (k if k < 64 else 63)] = _i16(
                            (bits if bits >> (s - 1) else bits - (1 << s) + 1) * p1)
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + ((win >> (40 - o - r)) & ((1 << r) - 1)) - 1
                        p += r
                        break
                    k += 1
                continue
            # AC refinement: newly non-zero coefficients of magnitude 1 << al, and a
            # correction bit for each coefficient that already holds a value
            k = ss
            if not eobrun:
                while k <= se:
                    q = p >> 3
                    win = int.from_bytes(buf[q:q + 5], "big")
                    o = p & 7
                    code = acl[(win >> (24 - o)) & 0xFFFF] or _BAD_CODE
                    ln, rs = code >> 8, code & 0xFF
                    p += ln
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if (buf[p >> 3] >> (7 - (p & 7))) & 1 else m1
                        p += 1
                    elif r != 15:
                        o += ln
                        eobrun = (1 << r) + ((win >> (40 - o - r)) & ((1 << r) - 1))
                        p += r
                        break
                    k, p = _correct(coef, base, k, se, r, buf, p, p1, m1)
                    if s:
                        coef[base + (k if k < 64 else 63)] = s
                    k += 1
            if eobrun:
                _, p = _correct(coef, base, k, se, 64, buf, p, p1, m1)
                eobrun -= 1
        if p > n_bits:
            rd.insufficient = True


# lossless predictors 1-7 (T.81 Table H.1) of the samples left (a), above (b), above-left (c)
_PREDICTORS = {1: lambda a, b, c: a, 2: lambda a, b, c: b, 3: lambda a, b, c: c,
               4: lambda a, b, c: a + b - c, 5: lambda a, b, c: a + ((b - c) >> 1),
               6: lambda a, b, c: b + ((a - c) >> 1), 7: lambda a, b, c: (a + b) >> 1}


def _decode_lossless_scan(rd, scan, mcus_x, mcus_y, restart, predictor, pt):
    """Huffman-decode one lossless scan (jdlhuff.c) into each component's
    differences, an MCU row at a time, then undo the prediction (jdlossls.c)
    an iMCU row at a time. The first row of an iMCU row whose undifferencer
    was reset (the scan's first, a restart, a row decoded after the data ran
    out) predicts from the left, its first sample from 2^(P - Pt - 1); every
    other first column from above. The MCU row that runs past its interval's
    data reads zeros to its end; later rows of the interval are zero."""
    interleaved = len(scan) > 1
    units, n_mcu_x, n_mcu = _scan_layout(scan, mcus_x, mcus_y, unit=1)
    if restart and restart % n_mcu_x:
        raise ValueError(f"lossless JPEG restart interval {restart} is not a whole number of "
                         f"MCU rows ({n_mcu_x} MCUs)")
    n_rows = n_mcu // n_mcu_x
    diffs = {id(c): np.zeros((c.blocks_y, c.blocks_x), np.int64) for c, _, _ in scan}
    resets = {id(c): set() for c, _, _ in scan}    # iMCU rows whose undifferencer restarts

    def imcu(comp, row):
        return row if interleaved else row // comp.v

    rd.pad = n_mcu_x * len(units) * 4 + 16
    for start, count in rd.intervals(n_rows, restart // n_mcu_x if restart else n_rows,
                                     lambda row: row):
        p = 0
        for my in range(start, start + count):
            if my == start or rd.insufficient:
                for comp, _, _ in scan:
                    resets[id(comp)].add(imcu(comp, my))
            if rd.insufficient:
                continue
            for mx in range(n_mcu_x):
                for comp, dcl, _, dy, dx in units:
                    y, x = (my * comp.v + dy, mx * comp.h + dx) if interleaved else (my, mx)
                    diffs[id(comp)][y, x], p = _receive_dc(rd.buf, p, dcl)
            if p > rd.n_bits:
                rd.insufficient = True
    for comp, _, _ in scan:
        d = diffs[id(comp)].tolist()
        out = []
        for y, row in enumerate(d):
            if y % comp.v == 0 and y // comp.v in resets[id(comp)]:
                acc, cur = 1 << (8 - pt - 1), []    # 2^(P - Pt - 1) at P = 8 bits
                for dv in row:
                    acc = (acc + dv) & 0xFFFF
                    cur.append(acc)
                out.append(cur)
                continue
            up, predict = out[-1], _PREDICTORS[predictor]
            cur = [(up[0] + row[0]) & 0xFFFF]
            for x in range(1, len(row)):
                cur.append((predict(cur[-1], up[x], up[x - 1]) + row[x]) & 0xFFFF)
            out.append(cur)
        comp.samples = (np.array(out, np.int64) << pt) & 0xFF


# ---------------------------------------------------------------------------
# the decoder


def _frame(body):
    precision, height, width, nc = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"JPEG of {precision}-bit samples: only 8-bit is read")
    if nc not in (1, 3, 4):
        raise ValueError(f"JPEG with {nc} components: 1, 3 and 4 are read")
    if not height or not width:
        raise ValueError(f"JPEG frame of {height} x {width} samples")
    return height, width, [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                      body[7 + 3 * i] & 15, body[8 + 3 * i]) for i in range(nc)]


def _check_length(marker, body, length):
    """jdmarker.c's checks of a SOFn, SOS or DRI segment's `length`, made
    once the fields they need are read: `body` may be cut short by the
    file's end (libjpeg then waits for more, and Pillow gives up)."""
    n = length - 2
    cut = len(body) < n
    if marker == 0xDD:
        ok = n == 2
    elif marker == 0xDA:
        ok = (1 <= body[0] <= 4 and n == 4 + 2 * body[0]) if body else cut
    else:
        ok = n == 6 + 3 * body[5] if len(body) >= 6 else cut
    if not ok:
        raise ValueError(f"JPEG marker 0x{marker:02X} segment of a bad length ({length})")


def _quant_tables(body, length):
    """{table: int64 [64] natural order} of a DQT segment of `length`; a
    table cut short by the segment's end is refused, as libjpeg-turbo 3 and
    Pillow's header parser refuse it. `body` may be cut short by the file's
    end: the tables read up to there."""
    out, i, n_body = {}, 0, length - 2
    if n_body < 0:
        raise ValueError("JPEG DQT segment of a bad length")
    while i < n_body and i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        if tq >= 4:
            raise ValueError(f"JPEG quantisation table {tq} (at most 3)")
        n = 64 * (2 if pq else 1)
        if n_body - i - 1 < n:
            raise ValueError("JPEG DQT segment ends inside a table")
        if i + 1 + n > len(body):
            break
        table = np.empty(64, np.int64)
        table[ZIGZAG] = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
        out[tq] = table
        i += 1 + n
    return out


def _huffman_tables(body, length):
    """[(class, table, counts, symbols)] of a DHT segment of `length`, as
    jdmarker.c's get_dht checks it; `body` may be cut short by the file's
    end, as in _quant_tables."""
    out, i, n_body = [], 0, length - 2
    while n_body - i > 16 and i + 17 <= len(body):
        index, counts = body[i], list(body[i + 1:i + 17])
        n = sum(counts)
        if n > 256 or n > n_body - i - 17:
            raise ValueError("JPEG Huffman table of more symbols than its segment holds")
        if i + 17 + n > len(body):
            break
        if index & ~0x10 >= 4:
            raise ValueError(f"JPEG Huffman table index 0x{index:02X}")
        out.append((index >> 4, index & 3, counts, list(body[i + 17:i + 17 + n])))
        i += 17 + n
    if i == len(body) == n_body or (len(body) < n_body and n_body - i > 16):
        return out
    raise ValueError("JPEG DHT segment of a bad length")


def _check_progressive(ns, ss, se, ah, al):
    """libjpeg's checks of a progressive scan's parameters (jdphuff.c)."""
    bad = ss > se or se > 63 or al > 13 or (ah and ah != al + 1)
    bad = bad or (ss == 0 and se != 0) or (ss > 0 and ns != 1)
    if bad:
        raise ValueError(f"JPEG progressive scan parameters Ss={ss} Se={se} Ah={ah} Al={al} "
                         f"over {ns} components are invalid")


# ---------------------------------------------------------------------------
# block smoothing (libjpeg-turbo 2.1+'s jdcoefct.c decompress_smooth_data)


def _w(*rows):
    """A 5 x 5 weight of the DC values two blocks around (rows -2..2 above to
    below, columns -2..2 left to right), from its non-zero rows by offset."""
    out = np.zeros((5, 5), np.int64)
    for dy, row in rows:
        out[dy + 2] = row
    return out


# the coefficients smoothing estimates, by zig-zag index (1-9): their natural
# position, the weights when the component's AC coefficients are all unknown
# (the DC then smoothed too), and otherwise (None: not estimated)
_SMOOTH_TERMS = [
    (1, 1, _w((-2, [-1, -1, 0, 1, 1]), (-1, [-3, 13, 0, -13, 3]), (0, [-3, 38, 0, -38, 3]),
              (1, [-3, 13, 0, -13, 3]), (2, [-1, -1, 0, 1, 1])),
     _w((0, [-7, 50, 0, -50, 7]))),
    (2, 8, _w((-2, [-1, -3, -3, -3, -1]), (-1, [-1, 13, 38, 13, -1]),
              (1, [1, -13, -38, -13, 1]), (2, [1, 3, 3, 3, 1])),
     _w((-2, [0, 0, -7, 0, 0]), (-1, [0, 0, 50, 0, 0]), (1, [0, 0, -50, 0, 0]),
        (2, [0, 0, 7, 0, 0]))),
    (3, 16, _w((-2, [0, 0, 1, 0, 0]), (-1, [0, 2, 7, 2, 0]), (0, [0, -5, -14, -5, 0]),
               (1, [0, 2, 7, 2, 0]), (2, [0, 0, 1, 0, 0])),
     _w((-2, [0, 0, -1, 0, 0]), (-1, [0, 0, 13, 0, 0]), (0, [0, 0, -24, 0, 0]),
        (1, [0, 0, 13, 0, 0]), (2, [0, 0, -1, 0, 0]))),
    (4, 9, _w((-2, [-1, 0, 0, 0, 1]), (-1, [0, 9, 0, -9, 0]), (1, [0, -9, 0, 9, 0]),
              (2, [1, 0, 0, 0, -1])),
     _w((-2, [0, -1, 0, 1, 0]), (-1, [-1, 10, 0, -10, 1]), (1, [1, -10, 0, 10, -1]),
        (2, [0, 1, 0, -1, 0]))),
    (5, 2, _w((-1, [0, 2, -5, 2, 0]), (0, [1, 7, -14, 7, 1]), (1, [0, 2, -5, 2, 0])),
     _w((0, [-1, 13, -24, 13, -1]))),
    (6, 3, _w((-1, [0, 1, 0, -1, 0]), (0, [0, 2, 0, -2, 0]), (1, [0, 1, 0, -1, 0])), None),
    (7, 10, _w((-1, [0, 1, -3, 1, 0]), (1, [0, -1, 3, -1, 0])), None),
    (8, 17, _w((-1, [0, 1, 0, -1, 0]), (0, [0, -3, 0, 3, 0]), (1, [0, 1, 0, -1, 0])), None),
    (9, 24, _w((-1, [0, 1, 2, 1, 0]), (1, [0, -1, -2, -1, 0])), None),
]
_SMOOTH_DC = _w((-2, [-2, -6, -8, -6, -2]), (-1, [-6, 6, 42, 6, -6]), (0, [-8, 42, 152, 42, -8]),
                (1, [-6, 6, 42, 6, -6]), (2, [-2, -6, -8, -6, -2]))
_SMOOTH_NATURAL = [0] + [t[1] for t in _SMOOTH_TERMS]


def _smoothing_ok(comps) -> bool:
    """jdcoefct.c's smoothing_ok once every scan is in (Pillow decodes in one
    pass): every component has a latched table, some DC bits and the ten
    quantisation entries smoothing divides by non-zero, and some component has one of its first
    nine AC coefficients not fully known."""
    for c in comps:
        if c.q is None or not all(c.q[n] for n in _SMOOTH_NATURAL) or c.bits[0] < 0:
            return False
    return any(b != 0 for c in comps for b in c.bits[1:10])


def _div_round(num, q, al=None):
    """libjpeg's estimate from num: (q * 128 + |num|) // (q * 256) with num's
    sign, its magnitude held under 2^al when al > 0."""
    pred = ((q << 7) + np.abs(num)) // (q << 8)
    if al is not None and al > 0:
        pred = np.minimum(pred, (1 << al) - 1)
    return np.where(num >= 0, pred, -pred)


def _smoothed(coef: np.ndarray, comp, imcu_rows: int, bits) -> np.ndarray:
    """A component's coefficients (int64 [blocks, 64], zig-zag order) as
    libjpeg-turbo's block smoothing hands them to the IDCT: each of the first
    nine AC coefficients still 0 whose bits are not all known estimated from
    the DC values of the 5 x 5 blocks around (its magnitude held under 2^Al);
    where no AC coefficient of the component is known at all, all nine from a
    wider kernel and the DC smoothed too. The neighbours repeat the edge
    blocks; below, the rows follow libjpeg's count of block rows by iMCU row
    (the MCU padding's rows are read where it reaches them). `bits`: the
    component's progression status (the last Al of each coefficient)."""
    q = comp.q
    bits = bits[:10]
    change_dc = all(b == -1 for b in bits[1:10])
    hb, wb = -(-comp.height // 8), -(-comp.width // 8)
    grid = coef.reshape(comp.blocks_y, comp.blocks_x, 64)
    dc = grid[..., 0]
    g = np.arange(hb)
    rows = np.where(g // comp.v < imcu_rows - 1, comp.v, hb % comp.v or comp.v)
    image_row, image_rows = (g // comp.v) * rows + g % comp.v, rows * imcu_rows
    prev = np.where(image_row > 0, g - 1, g)
    nxt = np.where(image_row < image_rows - 1, g + 1, g)
    row_sel = [np.where(image_row > 1, g - 2, prev), prev, g, nxt,
               np.where(image_row < image_rows - 2, g + 2, nxt)]
    col = np.arange(wb)
    col_sel = [np.clip(col + d, 0, wb - 1) for d in (-2, -1, 0, 1, 2)]
    near = np.stack([np.stack([dc[r][:, cs] for cs in col_sel]) for r in row_sel])
    out = grid[:hb, :wb].copy()
    q00 = int(q[0])
    for k, nat, w_all, w_known in _SMOOTH_TERMS:
        w = w_all if change_dc else w_known
        if bits[k] == 0 or w is None:
            continue
        pred = _div_round(q00 * np.tensordot(w, near, axes=([0, 1], [0, 1])), int(q[nat]),
                          bits[k])
        out[..., k] = np.where(out[..., k] == 0, pred, out[..., k])
    if change_dc:
        out[..., 0] = _div_round(q00 * np.tensordot(_SMOOTH_DC, near, axes=([0, 1], [0, 1])),
                                 q00)
    grid = grid.copy()
    grid[:hb, :wb] = ((out + 0x8000) & 0xFFFF) - 0x8000     # JCOEF
    return grid.reshape(-1, 64)


def _smoothed_rows(coef, comp, imcu_rows, last_good, n_scans):
    """Block smoothing as decompress_smooth_data picks the status for each
    iMCU row: past `last_good` (the last scan ran out of data above them;
    None: it did not) the status before each component's last scan (all
    unknown when the file has one scan)."""
    out = _smoothed(coef, comp, imcu_rows, comp.bits)
    if last_good is None:
        return out
    before = comp.prev_bits if n_scans > 1 else [-1] * 64
    late = np.repeat(np.arange(comp.blocks_y) // comp.v > last_good, comp.blocks_x)
    return np.where(late[:, None], _smoothed(coef, comp, imcu_rows, before), out)


def read_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> what `imageio.v2.imread` returns: uint8 [H, W] (gray),
    [H, W, 3] (RGB) or [H, W, 4] (CMYK, inverted as Pillow returns it)."""
    if data[:3] != b"\xff\xd8\xff":      # Pillow's test of the file's first bytes
        raise ValueError("not a JPEG file")
    qt, dc_luts, ac_luts = {}, {}, {}
    cond = jpeg_arith.Conditioning()
    comps, frame, kind, arith, restart, adobe, jfif = [], None, None, False, 0, None, False
    n_scans, last_good = 0, None
    single_scan = None      # at the first scan: one scan of every component, not progressive
    pos = 2
    while True:
        pos = jpeg_arith.marker_after(data, pos)    # libjpeg skips other bytes between markers
        if pos + 2 > len(data):
            if single_scan:     # libjpeg has put out every row before it looks for EOI
                break
            raise ValueError("JPEG ends before its end-of-image marker")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if marker == 0x01 and single_scan is None:
            raise ValueError("JPEG marker 0x01 before the first scan: Pillow's header parser "
                             "refuses it")
        if marker in _PARAMETERLESS:
            continue
        if marker in _UNSUPPORTED_FRAMES:
            raise ValueError(f"JPEG frame type 0x{marker:02X} (hierarchical, or JPG) is not "
                             "read, as libjpeg reads none")
        if marker not in _KNOWN:
            raise ValueError(f"JPEG marker 0x{marker:02X} is reserved: libjpeg refuses it")
        if marker == 0xD8:
            raise ValueError("JPEG with a second start-of-image marker")
        if marker in _SOF_KINDS and frame is not None:
            raise ValueError("JPEG with a second frame header")
        if pos + 2 > len(data):
            if single_scan:
                break
            raise ValueError("JPEG ends inside a marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if marker in (0xDA, 0xDD) or marker in _SOF_KINDS:
            _check_length(marker, body, length)
        if pos + length > len(data):
            if not single_scan:
                raise ValueError("JPEG ends inside a marker segment")
            # libjpeg reads the segment up to the file's end, then waits for more
            if marker == 0xC4:
                _huffman_tables(body, length)
            elif marker == 0xDB:
                _quant_tables(body, length)
            break
        pos += max(length, 2)   # jdmarker.c's skip_variable skips nothing for a length < 2
        if marker in _SOF_KINDS:
            height, width, comps = _frame(body)
            frame, (kind, arith) = (height, width), _SOF_KINDS[marker]
            if arith and kind == "lossless":
                raise ValueError("arithmetic-coded lossless JPEG (SOF11): libjpeg-turbo reads "
                                 "none")
        elif marker == 0xCC:
            cond.define(body)
        elif marker == 0xDB:
            qt.update(_quant_tables(body, length))
        elif marker == 0xC4:
            for tc, th, counts, symbols in _huffman_tables(body, length):
                (ac_luts if tc else dc_luts)[th] = (_lookup_table(counts, symbols),
                                                    max(symbols, default=0))
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = body[0]
            if single_scan:
                raise ValueError("JPEG with a second scan after a scan of every component: "
                                 "libjpeg expects its end-of-image marker there")
            if single_scan is None:
                single_scan = kind != "progressive" and ns == len(comps)
            unit = 1 if kind == "lossless" else 8
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcus_x = -(-frame[1] // (unit * hmax))
            mcus_y = -(-frame[0] // (unit * vmax))
            for c in comps:
                if c.coef is None:
                    c.width = -(-frame[1] * c.h // hmax)
                    c.height = -(-frame[0] * c.v // vmax)
                    c.blocks_x, c.blocks_y = mcus_x * c.h, mcus_y * c.v
                    c.coef = array("i", bytes(4 * 64 * c.blocks_x * c.blocks_y)) \
                        if kind != "lossless" else []
            by_id = {c.ident: c for c in comps}
            if any(body[1 + 2 * i] not in by_id for i in range(ns)):
                raise ValueError("JPEG scan names a component the frame does not have")
            if len({body[1 + 2 * i] for i in range(ns)}) < ns:
                raise ValueError("JPEG scan names a component twice")
            if n_scans == 0 and kind == "sequential" and not arith:
                # jstdhuff.c: jdhuff.c's start fills tables 0 and 1 the file leaves out
                for luts, tables in ((dc_luts, (_DC_LUMA, _DC_CHROMA)),
                                     (ac_luts, (_AC_LUMA, _AC_CHROMA))):
                    for th, table in enumerate(tables):
                        if th not in luts:
                            luts[th] = (_lookup_table(*table), max(table[1]))
            ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, \
                body[3 + 2 * ns] & 15
            n_scans += 1
            if kind != "lossless":      # jdinput.c's latch_quant_tables
                for i in range(ns):
                    c = by_id[body[1 + 2 * i]]
                    if c.q is None:
                        if c.tq not in qt:
                            raise ValueError(f"JPEG component {c.ident} names a missing "
                                             "quantisation table")
                        c.q = qt[c.tq].copy()
            if kind == "progressive":
                _check_progressive(ns, ss, se, ah, al)
                lo, hi = min(ss, 1), max(se, 9)     # jdphuff.c's start_pass: the status before
                for i in range(ns):
                    c = by_id[body[1 + 2 * i]]
                    c.prev_bits[lo:hi + 1] = (c.bits[lo:hi + 1] if n_scans > 1
                                              else [0] * (hi + 1 - lo))
                    c.bits[ss:se + 1] = [al] * (se + 1 - ss)
            if arith:
                scan = [(by_id[body[1 + 2 * i]], body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15)
                        for i in range(ns)]
                mode = "sequential" if kind != "progressive" else \
                    ("dc_" if ss == 0 else "ac_") + ("refine" if ah else "first")
                units, n_mcu_x, n_mcu = _scan_layout(scan, mcus_x, mcus_y)
                # libjpeg has been handed the 64 KiB blocks up to the end of this header
                block = jpeg_arith.PILLOW_BLOCK
                pos = jpeg_arith.decode_scan(data, pos, units, n_mcu_x, n_mcu, restart, mode,
                                             ss, se, al, cond, block * ((pos - 1) // block + 1))
                last_good = None    # jdarith.c never runs out of data: every row is good
                continue
            need_dc = kind != "progressive" or (ss == 0 and ah == 0)
            need_ac = kind == "sequential" or (kind == "progressive" and ss > 0)
            scan = []
            for i in range(ns):
                dc = dc_luts.get(body[2 + 2 * i] >> 4) if need_dc else (None, 0)
                ac = ac_luts.get(body[2 + 2 * i] & 15) if need_ac else (None, 0)
                if dc is None or ac is None:
                    raise ValueError("JPEG scan names a Huffman table the file does not define")
                # jdhuff.c's jpeg_make_d_derived_tbl: codes that fit, DC categories to 15
                if (need_dc and (dc[0] is None or dc[1] > (16 if kind == "lossless" else 15))) \
                        or (need_ac and ac[0] is None):
                    raise ValueError("JPEG scan uses a bad Huffman table")
                scan.append((by_id[body[1 + 2 * i]], dc[0], ac[0]))
            rd = _ScanReader(data, pos)
            if kind == "progressive":
                _decode_progressive_scan(rd, scan, mcus_x, mcus_y, restart, ss, se, ah, al)
                last_good = rd.last_good if rd.last_good < mcus_y - 1 else None
            elif kind == "lossless":
                if not 1 <= ss <= 7:
                    raise ValueError(f"lossless JPEG predictor {ss} is not one of 1-7")
                _decode_lossless_scan(rd, scan, mcus_x, mcus_y, restart, ss, al)
            else:
                _decode_scan(rd, scan, mcus_x, mcus_y, restart)
            pos = rd.marker_pos
    if frame is None or any(c.coef is None for c in comps) or (
            kind == "lossless" and any(c.samples is None for c in comps)):
        raise ValueError("JPEG without a complete frame")
    smooth = kind == "progressive" and _smoothing_ok(comps)

    height, width = frame
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        if kind == "lossless":
            plane = c.samples
        else:
            coef = np.frombuffer(c.coef, np.int32).astype(np.int64).reshape(-1, 64)
            if smooth:
                coef = _smoothed_rows(coef, c, -(-height // (8 * vmax)), last_good, n_scans)
            natural = np.empty_like(coef)
            natural[:, ZIGZAG] = coef
            # a component no scan named has no table: jddctmgr.c's zero multipliers
            q = np.zeros(64, np.int64) if c.q is None else c.q
            blocks = idct_islow(natural.reshape(-1, 8, 8), q.reshape(8, 8))
            plane = blocks.reshape(c.blocks_y, c.blocks_x, 8, 8).transpose(0, 2, 1, 3)
            plane = plane.reshape(c.blocks_y * 8, c.blocks_x * 8)
        planes.append(_upsample(plane, c, hmax, vmax, kind != "lossless")[:height, :width])
    ids = [c.ident for c in comps]
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if len(planes) == 3:
        rgb = (not jfif and adobe == 0) if adobe is not None or jfif \
            else ids == [ord("R"), ord("G"), ord("B")]
        if rgb:
            return np.stack(planes, axis=-1).astype(np.uint8)
        if kind == "lossless":
            raise ValueError("lossless JPEG in YCbCr: libjpeg-turbo converts no lossless colours")
        return _ycc_to_rgb(*planes)
    if adobe is None or adobe == 0:     # CMYK
        cmyk = np.stack(planes, axis=-1)
    elif kind == "lossless":
        raise ValueError("lossless JPEG in YCCK: libjpeg-turbo converts no lossless colours")
    else:                               # YCCK -> CMYK, as libjpeg converts it
        cmyk = np.concatenate([255 - _ycc_to_rgb(*planes[:3]).astype(np.int64),
                               planes[3][..., None]], axis=-1)
    return (255 - cmyk).astype(np.uint8)


def jpeg_size(data: bytes) -> tuple:
    """(H, W) of JPEG bytes from the first frame header, without decoding."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0xD9, 0xDA) or 0xD0 <= marker <= 0xD7:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            height, width = struct.unpack(">HH", data[pos + 5:pos + 9])
            return height, width
        pos += 2 + length
    raise ValueError("JPEG without a frame header before its first scan")


# ---------------------------------------------------------------------------
# encoder (baseline, 4:4:4)


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
