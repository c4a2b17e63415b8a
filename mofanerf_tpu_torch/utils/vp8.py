"""VP8 key frames, WebP's lossy bitstream (RFC 6386), decoded as libwebp 1.6
decodes them, with libwebp's own output stage: the port's counterpart of the
lossy half of what `imageio.v2.imread` returns for a WebP file (Pillow over
libwebp, RGBA out of `WebPAnimDecoder`).

- `read_vp8(data, alpha=None)`: a `VP8 ` chunk's payload (and the payload of
  the frame's `ALPH` chunk, if any) -> uint8 [H, W, 4] RGBA.
- `vp8_size(data)`: (H, W) from the frame header alone.
- `decode_alpha(data, width, height)`: an `ALPH` payload -> uint8 [H, W].

Decoding follows the RFC as libwebp's `vp8_dec.c`, `tree_dec.c`,
`quant_dec.c` and `frame_dec.c` implement it: the frame header and the
boolean decoder; segmentation (map, quantizer and filter-level updates,
absolute or delta); the loop filter's type, level, sharpness and mode and
reference deltas; 1-8 token partitions; the quantizer indices with their
deltas through the DC and AC tables (Y2 DC x 2, Y2 AC x 155 / 100 with a
floor of 8, UV DC capped at 132); coefficient probability updates; the
16x16, 4x4 (ten modes, above and left contexts) and chroma intra modes; the
token trees, with macroblocks skipped that have no coefficients; the inverse
WHT and DCT (libwebp on x86-64 inverts blocks of more than three tokens in
16-bit SSE2 arithmetic, reproduced here, which differs from 32-bit only on
levels no encoder writes); prediction from the unfiltered picture with the RFC's edges
(127 above, 129 to the left, the above-right pixels of the right-hand
sub-blocks taken from the macroblock above and to the right); the normal and
simple loop filters in macroblock order (a macroblock without coefficients
filters no inner edges unless it is B_PRED).

The output stage is libwebp's, not the RFC's: the "fancy" upsampler of the
chroma planes (9-3-3-1 weights with its own rounding, rows and columns at the
picture's edges replicated) and the 14-bit fixed-point YUV -> RGB transform
with its clipping. The alpha plane is raw or a VP8L image (its green
channel), unfiltered horizontally, vertically or by gradient; the
level-reduction flag is read and ignored, as libwebp ignores it when it is not
asked to dither.

The token and mode stages are serial Python, as in `jpeg.py`; the
transforms, the prediction of whole blocks, the loop filter (macroblocks on
one wavefront at a time), the upsampling and the colour transform are numpy.
Data that end inside a partition raise ValueError, as libwebp refuses them.
"""
from __future__ import annotations

import numpy as np

from . import vp8l


def _table(*rows: str) -> bytes:
    return bytes.fromhex("".join(rows))


# RFC 6386 13.5: the default token probabilities [type][band][context][node]
COEFF_PROBS = np.frombuffer(_table(
    "808080808080808080808080808080808080808080808080808080808080808080"
    "fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff808080"
    "0162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb808080"
    "01b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff808080"
    "01ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3ab8080808080"
    "0198fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e08080808080"
    "0101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf80"
    "0195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff80"
    "0181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff80"
    "01c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc7808080"
    "01b6f9ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080"
    "019df7ffece7ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe0808080"
    "0101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80"
    "015ff7fdd4b7ffff808080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff808080"
    "0118effbdadbffcd808080c933dbffc4ba8080808080452ebeefc9daffe4808080"
    "01bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff8080808080808080"
    "01e2ff8080808080808080f7c0ff8080808080808080f080ff8080808080808080"
    "0186fcffff808080808080d53efaffff808080808080375dff8080808080808080"
    "808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd880"
    "0170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff80"
    "0134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff80"
    "01b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb808080"
    "01def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff808080"
    "0179ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd808080"
    "0101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080"
), np.uint8).reshape(4, 8, 3, 11)
# RFC 6386 13.4: the probabilities that each of those is updated in the header
COEFF_UPDATE_PROBS = np.frombuffer(_table(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "b0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffffffff"
    "fff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffffffffff"
    "fff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffeffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffbfefefffffffffffffffffefffeffffffffffffffff"
    "fffefdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfeffffff"
    "fffeffffffffffffffffffdffefeffffffffffffffffeefdfefeffffffffffffff"
    "fff8fefffffffffffffffff9feffffffffffffffffffffffffffffffffffffffff"
    "fffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcffffffffffffffffffffffffffffffffffffffffff"
    "fffefefffffffffffffffffdffffffffffffffffffffffffffffffffffffffffff"
    "fffefdfffffffffffffffffafffffffffffffffffffffeffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffeffffffff"
    "fffdfeffffffffffffffffecfdfefffffffffffffffffbfdfdfefeffffffffffff"
    "fffefefffffffffffffffffefefeffffffffffffffffffffffffffffffffffffff"
    "fffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdffffffffffffff"
    "fffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefeffffffffffff"
    "fffefcfffffffffffffffff8fefdfffffffffffffffffdfffefeffffffffffffff"
    "fffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffeffffffffffffffffff"
    "fffcfffffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffff"
    "fffffdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
), np.uint8).reshape(4, 8, 3, 11)
# RFC 6386 11.5: the key frame's 4x4 mode probabilities [above][left][node], in
# libwebp's order of the modes (below)
BMODE_PROBS = np.frombuffer(_table(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98"
    "721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce47"
    "3f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b50"
    "4266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216"
    "585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d"
    "271c55ab3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e172"
    "2213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d1"
    "6450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c0171952"
    "8a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39"
    "363970b8052926a6d51e221a8598740a2086271335dd1a722049ff1f0941ea020f017649"
    "4b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c4966012262"
    "7d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a"
    "39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25"
    "442d8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c955"
    "4b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d1"
    "2d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420"
    "654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418"
), np.uint8).reshape(10, 10, 9)
# RFC 6386 14.1: the quantizer step of each index
DC_TABLE = np.frombuffer(_table(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c"
    "1d1e1f20212223242525262728292a2b2c2d2e2e2f303132333435363738393a"
    "3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f50515253545556575859"
    "5b5d5f6062646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d"
), np.uint8).astype(np.int64)
AC_TABLE = np.frombuffer(_table(
    "0400050006000700080009000a000b000c000d000e000f001000110012001300"
    "1400150016001700180019001a001b001c001d001e001f002000210022002300"
    "2400250026002700280029002a002b002c002d002e002f003000310032003300"
    "3400350036003700380039003a003c003e00400042004400460048004a004c00"
    "4e00500052005400560058005a005c005e00600062006400660068006a006c00"
    "6e0070007200740077007a007d0080008300860089008c008f00920095009800"
    "9b009e00a100a400a700aa00ad00b100b500b900bd00c100c500c900cd00d100"
    "d500d900dd00e100e500ea00ef00f500f900fe00030108010d01120117011c01"
), "<u2").astype(np.int64)

ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)   # the 17th: a sentinel
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# modes (libwebp's numbering; the 16x16 and chroma modes share the first four)
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
DC_PRED, TM_PRED, V_PRED, H_PRED = B_DC, B_TM, B_VE, B_HE
# the 4x4 mode tree: leaves are -mode, inner nodes the index of their pair
YMODES_INTRA4 = (-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7,
                 -B_VL, 8, -B_HD, -B_HU)
_SHIFT = [0] + [8 - r.bit_length() for r in range(1, 256)]
_SIGNATURE = b"\x9d\x01\x2a"


class _BoolReader:
    """The boolean decoder as libwebp runs it: `range - 1` kept, the value a
    uint64 window compared in 32 bits (which decides data no encoder
    writes), bytes loaded 7 at a time, then 1; one zero byte past the end
    raises `eof`, which the frame checks as libwebp does."""

    __slots__ = ("buf", "pos", "end", "value", "rng", "bits", "eof")

    def __init__(self, buf: bytes, start: int, end: int):
        self.buf, self.pos, self.end = buf, start, end
        self.value, self.rng, self.bits, self.eof = 0, 254, -8, False
        self._load()

    def _load(self):
        if self.pos + 8 <= self.end:
            seven = int.from_bytes(self.buf[self.pos:self.pos + 7], "big")
            self.value = ((self.value << 56) | seven) & 0xFFFFFFFFFFFFFFFF
            self.pos += 7
            self.bits += 56
        elif self.pos < self.end:
            self.value = ((self.value << 8) | self.buf[self.pos]) & 0xFFFFFFFFFFFFFFFF
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value = (self.value << 8) & 0xFFFFFFFFFFFFFFFF
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        split = (self.rng * prob) >> 8
        b = self.bits
        if ((self.value >> b) & 0xFFFFFFFF) > split:
            r = self.rng - split
            self.value -= (split + 1) << b
            s = _SHIFT[r]
            self.rng = (r << s) - 1
            self.bits = b - s
            return 1
        r = split + 1
        s = _SHIFT[r]
        self.rng = (r << s) - 1
        self.bits = b - s
        return 0

    def signed(self, v: int) -> int:
        if self.bits < 0:
            self._load()
        b = self.bits
        split = self.rng >> 1
        self.bits = b - 1
        if (split - ((self.value >> b) & 0xFFFFFFFF)) & 0x80000000:
            self.rng = (self.rng - 1) | 1
            self.value -= (split + 1) << b
            return -v
        self.rng |= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        while n > 0:
            n -= 1
            v |= self.bit(0x80) << n
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


def _large_value(br: _BoolReader, p) -> int:
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    bit1 = br.bit(p[8])
    cat = 2 * bit1 + br.bit(p[9 + bit1])
    v = 0
    for q in CAT_PROBS[cat]:
        v += v + br.bit(q)
    return v + 3 + (8 << cat)


def _coeffs(br: _BoolReader, bands, ctx: int, dq, n: int, base: int, idx: list, val: list) -> int:
    """One block's tokens from position n (libwebp's GetCoeffs): the nonzero
    coefficients, dequantised and wrapped to int16, go to (idx, val) at
    flat index base + raster position; returns the position after the last
    one read."""
    p = bands[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        nxt = bands[n + 1]
        if not br.bit(p[2]):
            v = 1
            p = nxt[1]
        else:
            v = _large_value(br, p)
            p = nxt[2]
        c = br.signed(v) * dq[n > 0]
        idx.append(base + ZIGZAG[n])
        val.append(((c + 32768) & 0xFFFF) - 32768)
        n += 1
    return 16


def vp8_size(data: bytes) -> tuple:
    """(H, W) of a VP8 key frame, from its header (libwebp's VP8GetInfo
    checks included)."""
    if len(data) < 10 or data[3:6] != _SIGNATURE:
        raise ValueError("not a VP8 key frame")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    w, h = ((data[7] << 8) | data[6]) & 0x3FFF, ((data[9] << 8) | data[8]) & 0x3FFF
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or not w or not h:
        raise ValueError("VP8 frame that is not a shown key frame, or of no size")
    return h, w


# ---------------------------------------------------------------------------
# the frame header


class _Header:
    pass


def _step(table, index: int, top: int = 127) -> int:
    """A quantizer step, its index clipped to [0, top]."""
    return int(table[min(max(index, 0), top)])


def _parse_header(data: bytes) -> _Header:
    hd = _Header()
    if len(data) < 10:
        raise ValueError("VP8 frame header truncated")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise ValueError("VP8 frame is not a key frame")
    if ((bits >> 1) & 7) > 3:
        raise ValueError("VP8 profile above 3")
    if not (bits >> 4) & 1:
        raise ValueError("VP8 frame not shown")
    part0 = bits >> 5
    if data[3:6] != _SIGNATURE:
        raise ValueError("VP8 key frame without its start code")
    hd.width = ((data[7] << 8) | data[6]) & 0x3FFF
    hd.height = ((data[9] << 8) | data[8]) & 0x3FFF
    if part0 > len(data) - 10:
        raise ValueError("VP8 first partition runs past the data")
    br = hd.br = _BoolReader(data, 10, 10 + part0)
    br.bit(0x80)                                   # colour space
    br.bit(0x80)                                   # clamping type (libwebp always clamps)
    # segmentation
    hd.use_segment = br.bit(0x80)
    hd.update_map, hd.absolute_delta = 0, 1
    hd.seg_quant, hd.seg_filter = [0] * 4, [0] * 4
    hd.seg_probs = [255, 255, 255]
    if hd.use_segment:
        hd.update_map = br.bit(0x80)
        if br.bit(0x80):
            hd.absolute_delta = br.bit(0x80)
            hd.seg_quant = [br.signed_value(7) if br.bit(0x80) else 0 for _ in range(4)]
            hd.seg_filter = [br.signed_value(6) if br.bit(0x80) else 0 for _ in range(4)]
        if hd.update_map:
            hd.seg_probs = [br.value_bits(8) if br.bit(0x80) else 255 for _ in range(3)]
    if br.eof:
        raise ValueError("VP8 segment header truncated")
    # loop filter
    hd.simple = br.bit(0x80)
    hd.level = br.value_bits(6)
    hd.sharpness = br.value_bits(3)
    hd.use_lf_delta = br.bit(0x80)
    hd.ref_lf_delta, hd.mode_lf_delta = [0] * 4, [0] * 4
    if hd.use_lf_delta and br.bit(0x80):
        for deltas in (hd.ref_lf_delta, hd.mode_lf_delta):
            for i in range(4):
                if br.bit(0x80):
                    deltas[i] = br.signed_value(6)
    hd.filter_type = 0 if hd.level == 0 else 1 if hd.simple else 2
    if br.eof:
        raise ValueError("VP8 filter header truncated")
    # token partitions: sizes of all but the last, which takes the rest
    n_parts = 1 << br.value_bits(2)
    start = 10 + part0
    size_left = len(data) - start
    if size_left < 3 * (n_parts - 1):
        raise ValueError("VP8 partition sizes truncated")
    part_start = start + 3 * (n_parts - 1)
    size_left -= 3 * (n_parts - 1)
    hd.parts = []
    for p in range(n_parts - 1):
        s = start + 3 * p
        psize = min(data[s] | (data[s + 1] << 8) | (data[s + 2] << 16), size_left)
        hd.parts.append(_BoolReader(data, part_start, part_start + psize))
        part_start += psize
        size_left -= psize
    hd.parts.append(_BoolReader(data, part_start, len(data)))
    if part_start >= len(data):
        raise ValueError("VP8 last partition is empty")
    # quantizers
    base_q = br.value_bits(7)
    dq = [br.signed_value(4) if br.bit(0x80) else 0 for _ in range(5)]  # y1 dc, y2 dc/ac, uv dc/ac
    hd.quant = []
    for s in range(4):
        if hd.use_segment:
            q = hd.seg_quant[s] + (0 if hd.absolute_delta else base_q)
        else:
            q = base_q
        # (y1, y2, uv) x (dc, ac); y2 ac x 155 / 100 as (x * 101581) >> 16, uv dc capped at 132
        hd.quant.append(((_step(DC_TABLE, q + dq[0]), _step(AC_TABLE, q)),
                         (_step(DC_TABLE, q + dq[1]) * 2,
                          max(_step(AC_TABLE, q + dq[2]) * 101581 >> 16, 8)),
                         (_step(DC_TABLE, q + dq[3], 117), _step(AC_TABLE, q + dq[4]))))
    br.bit(0x80)                                   # refresh_entropy_probs, ignored
    probs = COEFF_PROBS.astype(np.int64).copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(int(COEFF_UPDATE_PROBS[t, b, c, p])):
                        probs[t, b, c, p] = br.value_bits(8)
    # bands[type][position] -> the three contexts' probabilities, as lists
    band_probs = probs.tolist()
    hd.bands = [[band_probs[t][BANDS[n]] for n in range(17)] for t in range(4)]
    hd.use_skip = br.bit(0x80)
    hd.skip_prob = br.value_bits(8) if hd.use_skip else 0
    return hd


def _parse_modes(hd: _Header, mb_w: int, mb_h: int):
    """Partition 0's per-macroblock data: segment, skip flag, whether 4x4,
    the 16 sub-block modes (or the 16x16 mode), the chroma mode."""
    br = hd.br
    segs, skips, is4, ymodes, uvmodes = [], [], [], [], []
    top = [[B_DC] * 4 for _ in range(mb_w)]
    for _ in range(mb_h):
        left = [B_DC] * 4
        for mx in range(mb_w):
            if hd.update_map:
                s = (br.bit(hd.seg_probs[1]) if not br.bit(hd.seg_probs[0])
                     else br.bit(hd.seg_probs[2]) + 2)
            else:
                s = 0
            segs.append(s)
            skips.append(br.bit(hd.skip_prob) if hd.use_skip else 0)
            t = top[mx]
            if br.bit(145):                       # 16x16
                if br.bit(156):
                    m = TM_PRED if br.bit(128) else H_PRED
                else:
                    m = V_PRED if br.bit(163) else DC_PRED
                is4.append(False)
                ymodes.append(m)
                t[:] = [m] * 4
                left = [m] * 4
            else:
                modes = []
                for y in range(4):
                    ym = left[y]
                    for x in range(4):
                        prob = BMODE_PROBS[t[x], ym]
                        i = YMODES_INTRA4[br.bit(int(prob[0]))]
                        while i > 0:
                            i = YMODES_INTRA4[2 * i + br.bit(int(prob[i]))]
                        ym = -i
                        t[x] = ym
                    modes += t
                    left[y] = ym
                is4.append(True)
                ymodes.append(modes)
            uvmodes.append(DC_PRED if not br.bit(142) else V_PRED if not br.bit(114)
                           else TM_PRED if br.bit(183) else H_PRED)
        if br.eof:
            raise ValueError("VP8 first partition ends before its last macroblock")
    return segs, skips, is4, ymodes, uvmodes


def _parse_tokens(hd: _Header, mb_w: int, mb_h: int, segs, skips, is4):
    """The token partitions -> dequantised coefficients [n_mb, 24, 16]
    (raster order in a block; Y blocks 0-15, U 16-19, V 20-23; the DCs of a
    16x16 macroblock from its inverse WHT); per macroblock, whether any
    block has a coefficient (libwebp's non_zero_y | non_zero_uv); per block,
    whether libwebp inverts it with its 16-bit (SSE2) transform: a luma
    block whose last token lies past position 3, the four blocks of a
    chroma plane of which one has one past position 0."""
    n_mb = mb_w * mb_h
    idx, val = [], []
    y2_idx, y2_val, y2_mbs, y2_full = [], [], [], []
    wide = np.zeros(n_mb, bool)       # a block whose last token sits past its first position
    simd = np.zeros((n_mb, 24), bool)
    top_nz, top_dc = [0] * mb_w, [0] * mb_w
    bands = hd.bands
    n_parts = len(hd.parts)
    for my in range(mb_h):
        br = hd.parts[my & (n_parts - 1)]
        left_nz = left_dc = 0
        for mx in range(mb_w):
            m = my * mb_w + mx
            if skips[m]:
                top_nz[mx] = left_nz = 0
                if not is4[m]:
                    top_dc[mx] = left_dc = 0
                continue
            qy, qy2, quv = hd.quant[segs[m]]
            base = m * 384
            big = False
            if not is4[m]:
                nz = _coeffs(br, bands[1], top_dc[mx] + left_dc, qy2, 0, 16 * len(y2_mbs),
                             y2_idx, y2_val)
                top_dc[mx] = left_dc = int(nz > 0)
                y2_mbs.append(m)
                y2_full.append(nz > 1)
                first, ac = 1, bands[0]
            else:
                first, ac = 0, bands[3]
            tnz, lnz = top_nz[mx] & 0x0F, left_nz & 0x0F
            for y in range(4):
                left = lnz & 1
                for x in range(4):
                    nz = _coeffs(br, ac, left + (tnz & 1), qy, first, base + 64 * y + 16 * x,
                                 idx, val)
                    left = int(nz > first)
                    big |= nz > 1
                    simd[m, 4 * y + x] = nz > 3
                    tnz = (tnz >> 1) | (left << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (left << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = top_nz[mx] >> (4 + ch), left_nz >> (4 + ch)
                for y in range(2):
                    left = lnz & 1
                    for x in range(2):
                        nz = _coeffs(br, bands[2], left + (tnz & 1), quv, 0,
                                     base + 256 + 32 * ch + 32 * y + 16 * x, idx, val)
                        left = int(nz > 0)
                        if nz > 1:
                            big = True
                            simd[m, 16 + 2 * ch:20 + 2 * ch] = True
                        tnz = (tnz >> 1) | (left << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (left << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mx], left_nz = out_t, out_l
            wide[m] = big
        if br.eof:
            raise ValueError("VP8 token partition ends before its last macroblock")
    coeffs = np.zeros(n_mb * 384, np.int64)
    coeffs[np.array(idx, np.int64)] = val
    coeffs = coeffs.reshape(n_mb, 16 + 8, 16)
    if y2_mbs:                                   # the Y DCs of 16x16 macroblocks
        dc = np.zeros(len(y2_mbs) * 16, np.int64)
        dc[np.array(y2_idx, np.int64)] = y2_val
        dc = dc.reshape(-1, 16)
        full = np.array(y2_full)
        out = np.repeat(((dc[:, :1] + 3) >> 3), 16, axis=1)
        if full.any():
            out[full] = _iwht(dc[full])
        coeffs[np.array(y2_mbs), :16, 0] = ((out + 32768) & 0xFFFF) - 32768
    nonzero = wide | (coeffs[:, :, 0] != 0).any(1)
    return coeffs, nonzero, simd


# ---------------------------------------------------------------------------
# inverse transforms


def _mul1(x):
    return ((x * 20091) >> 16) + x


def _mul2(x):
    return (x * 35468) >> 16


def _iwht(dc: np.ndarray) -> np.ndarray:
    """libwebp's TransformWHT: [n, 16] -> the 16 Y DCs [n, 16], block order."""
    i = dc.reshape(-1, 4, 4)                     # [n, row, col]
    a0, a1 = i[:, 0] + i[:, 3], i[:, 1] + i[:, 2]
    a2, a3 = i[:, 1] - i[:, 2], i[:, 0] - i[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1)   # [n, row, col]
    dcr = t[:, :, 0] + 3
    b0, b1 = dcr + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    b2, b3 = t[:, :, 1] - t[:, :, 2], dcr - t[:, :, 3]
    out = np.stack([(b0 + b1) >> 3, (b3 + b2) >> 3, (b0 - b1) >> 3, (b3 - b2) >> 3], 2)
    return out.reshape(-1, 16)                   # [n, row i, (0, 16, 32, 48)/16 -> col]


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _idct(c: np.ndarray, simd: bool = False) -> np.ndarray:
    """libwebp's TransformOne (RFC 14.3) on blocks [..., 16] -> residuals
    [..., 4, 4] (row, col), each to be added to its prediction and clipped.
    With `simd`, as its SSE2 Transform computes them: each pass's sums in
    16 bits (the same values unless a stream's levels exceed what any
    encoder writes)."""
    wrap = _wrap16 if simd else (lambda x: x)                # noqa: E731
    shape = c.shape[:-1]
    c = c.reshape(-1, 4, 4)
    i0, i1, i2, i3 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]        # rows, [n, col]
    a, b = i0 + i2, i0 - i2
    cc, d = _mul2(i1) - _mul1(i3), _mul1(i1) + _mul2(i3)
    t = wrap(np.stack([a + d, b + cc, b - cc, a - d], 2))     # [n, col, k]
    dc = t[:, 0] + 4                                          # [n, k]
    a, b = dc + t[:, 2], dc - t[:, 2]
    cc, d = _mul2(t[:, 1]) - _mul1(t[:, 3]), _mul1(t[:, 1]) + _mul2(t[:, 3])
    out = np.stack([wrap(a + d) >> 3, wrap(b + cc) >> 3, wrap(b - cc) >> 3, wrap(a - d) >> 3], 2)
    return out.reshape(shape + (4, 4))


# ---------------------------------------------------------------------------
# prediction


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top: list, left: list) -> list:
    """A 4x4 block's prediction (libwebp's *4_C): top = the corner, the 4
    pixels above and the 4 above-right; left = the 4 to the left. -> 16
    values, rows first."""
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    if mode == B_DC:
        return [(A + B + C + D + I + J + K + L + 4) >> 3] * 16
    if mode == B_TM:
        return [min(max(t + l - X, 0), 255) for l in left for t in (A, B, C, D)]
    if mode == B_VE:
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == B_HE:
        return ([_avg3(X, I, J)] * 4 + [_avg3(I, J, K)] * 4 + [_avg3(J, K, L)] * 4
                + [_avg3(K, L, L)] * 4)
    if mode == B_RD:
        # along the down-right diagonals, the bottom-left one first
        v = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I), _avg3(B, A, X),
             _avg3(C, B, A), _avg3(D, C, B)]
        return [v[3 - y + x] for y in range(4) for x in range(4)]
    if mode == B_LD:
        v = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(E, F, G),
             _avg3(F, G, H), _avg3(G, H, H)]
        return [v[x + y] for y in range(4) for x in range(4)]
    if mode == B_VR:
        r0 = [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)]
        r1 = [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D)]
        return (r0 + r1 + [_avg3(J, I, X)] + r0[:3] + [_avg3(K, J, I)] + r1[:3])
    if mode == B_VL:
        r0 = [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)]
        r1 = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)]
        return r0 + r1 + r0[1:] + [_avg3(E, F, G)] + r1[1:] + [_avg3(F, G, H)]
    if mode == B_HD:
        return [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C),
                _avg2(J, I), _avg3(J, I, X), _avg2(I, X), _avg3(I, X, A),
                _avg2(K, J), _avg3(K, J, I), _avg2(J, I), _avg3(J, I, X),
                _avg2(L, K), _avg3(L, K, J), _avg2(K, J), _avg3(K, J, I)]
    # B_HU
    return [_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L),
            _avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L),
            _avg2(K, L), _avg3(K, L, L), L, L,
            L, L, L, L]


def _pred_block(mode: int, top: np.ndarray, left: np.ndarray, corner: int, size: int,
                has_top: bool, has_left: bool) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction (libwebp's *16_C / *8uv_C, DC
    by which edges exist)."""
    if mode == DC_PRED:
        shift = size.bit_length() - 1            # 4 for 16, 3 for 8
        if has_top and has_left:
            v = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif has_left:
            v = (int(left.sum()) + (size >> 1)) >> shift
        elif has_top:
            v = (int(top.sum()) + (size >> 1)) >> shift
        else:
            v = 0x80
        return np.full((size, size), v, np.int64)
    if mode == V_PRED:
        return np.broadcast_to(top, (size, size))
    if mode == H_PRED:
        return np.broadcast_to(left[:, None], (size, size))
    return np.clip(top[None, :] + left[:, None] - corner, 0, 255)


def _reconstruct(hd: _Header, mb_w: int, mb_h: int, is4, ymodes, uvmodes, res):
    """Prediction plus residual, macroblock by macroblock, from the unfiltered
    picture. Planes carry one row above (127) and one column to the left
    (129; 127 in the corner of the top row); the luma plane 4 columns more
    on the right (127) for the top row's above-right pixels."""
    Y = np.empty((16 * mb_h + 1, 16 * mb_w + 5), np.int64)
    Y[0], Y[1:, 0] = 127, 129
    U = np.empty((2, 8 * mb_h + 1, 8 * mb_w + 1), np.int64)
    U[:, 0], U[:, 1:, 0] = 127, 129
    res_y = res[:, :16].reshape(-1, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(-1, 16, 16)
    res_uv = res[:, 16:].reshape(-1, 2, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5).reshape(-1, 2, 8, 8)
    for my in range(mb_h):
        y0 = 16 * my
        for mx in range(mb_w):
            m = my * mb_w + mx
            x0 = 16 * mx
            if is4[m]:
                w = Y[y0:y0 + 17, x0:x0 + 21].tolist()
                if my > 0 and mx == mb_w - 1:    # above-right of the last column: replicated
                    w[0][17:21] = [w[0][16]] * 4
                for r in (4, 8, 12):             # the right-hand sub-blocks' above-right
                    w[r][17:21] = w[0][17:21]
                rb = res[m, :16].reshape(16, 16).tolist()
                modes = ymodes[m]
                for n in range(16):
                    oy, ox = 1 + 4 * (n >> 2), 1 + 4 * (n & 3)
                    rowa = w[oy - 1]
                    pred = _pred4(modes[n], rowa[ox - 1:ox + 8],
                                  [w[oy + k][ox - 1] for k in range(4)])
                    rr = rb[n]
                    for k in range(16):
                        v = pred[k] + rr[k]
                        w[oy + (k >> 2)][ox + (k & 3)] = 0 if v < 0 else 255 if v > 255 else v
                Y[y0 + 1:y0 + 17, x0 + 1:x0 + 17] = [r[1:17] for r in w[1:17]]
            else:
                pred = _pred_block(ymodes[m], Y[y0, x0 + 1:x0 + 17], Y[y0 + 1:y0 + 17, x0],
                                   int(Y[y0, x0]), 16, my > 0, mx > 0)
                Y[y0 + 1:y0 + 17, x0 + 1:x0 + 17] = np.clip(pred + res_y[m], 0, 255)
            c0, d0 = 8 * my, 8 * mx
            for ch in range(2):
                P = U[ch]
                pred = _pred_block(uvmodes[m], P[c0, d0 + 1:d0 + 9], P[c0 + 1:c0 + 9, d0],
                                   int(P[c0, d0]), 8, my > 0, mx > 0)
                P[c0 + 1:c0 + 9, d0 + 1:d0 + 9] = np.clip(pred + res_uv[m, ch], 0, 255)
    return (Y[1:, 1:16 * mb_w + 1].copy(), U[0, 1:, 1:].copy(), U[1, 1:, 1:].copy())


# ---------------------------------------------------------------------------
# the loop filter


def _filter_strengths(hd: _Header):
    """[segment][is 4x4] -> (limit, interior limit, hev threshold), libwebp's
    PrecomputeFilterStrengths."""
    out = []
    for s in range(4):
        base = hd.level
        if hd.use_segment:
            base = hd.seg_filter[s] + (0 if hd.absolute_delta else hd.level)
        row = []
        for i4 in (0, 1):
            level = base
            if hd.use_lf_delta:
                level += hd.ref_lf_delta[0] + (hd.mode_lf_delta[0] if i4 else 0)
            level = min(max(level, 0), 63)
            if level > 0:
                ilevel = level
                if hd.sharpness > 0:
                    ilevel >>= 2 if hd.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - hd.sharpness)
                ilevel = max(ilevel, 1)
                hev = 2 if level >= 40 else 1 if level >= 15 else 0
                row.append((2 * level + ilevel, ilevel, hev))
            else:
                row.append((0, 0, 0))
        out.append(row)
    return out


def _filter_lines(px, limit, ilevel, hev_t, kind):
    """Filter lines across an edge: px int64 [n, 8] = p3 p2 p1 p0 q0 q1 q2 q3
    (modified in place); limit / ilevel / hev_t [n]; kind "simple", "mb" or
    "inner" (libwebp's DoFilter2 / 6 / 4 under NeedsFilter and Hev)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = px.T
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * limit + 1
    if kind == "simple":
        hev = mask
    else:
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
            mask &= np.abs(a - b) <= ilevel
        hev = mask & ((np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t))
    if hev.any():                                # DoFilter2
        a = 3 * (q0[hev] - p0[hev]) + np.clip(p1[hev] - q1[hev], -128, 127)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        px[hev, 3] = np.clip(p0[hev] + a2, 0, 255)
        px[hev, 4] = np.clip(q0[hev] - a1, 0, 255)
    if kind == "simple":
        return
    rest = mask & ~hev
    if not rest.any():
        return
    P2, P1, P0, Q0, Q1, Q2 = (v[rest] for v in (p2, p1, p0, q0, q1, q2))
    if kind == "mb":                             # DoFilter6
        a = np.clip(3 * (Q0 - P0) + np.clip(P1 - Q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        px[rest, 1:7] = np.clip(np.stack([P2 + a3, P1 + a2, P0 + a1, Q0 - a1, Q1 - a2, Q2 - a3],
                                         1), 0, 255)
    else:                                        # DoFilter4
        a = 3 * (Q0 - P0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        px[rest, 2:6] = np.clip(np.stack([P1 + a3, P0 + a2, Q0 - a1, Q1 - a3], 1), 0, 255)


def _edge_lines(base, stride, ys, xs, size, offset, vertical):
    """Flat indices [n * size, 8] of the lines across one edge of each listed
    macroblock (x = xs + offset for a vertical edge, else y = ys + offset)."""
    k = np.arange(size)
    taps = np.arange(-4, 4)
    if vertical:
        idx = (ys[:, None, None] + k[:, None]) * stride + xs[:, None, None] + offset + taps
    else:
        idx = (ys[:, None, None] + offset + taps) * stride + xs[:, None, None] + k[:, None]
    return (base + idx).reshape(-1, 8)


def _loop_filter(hd, mb_w, mb_h, Y, U, V, segs, is4, nonzero, skips):
    """The loop filter in macroblock order: each macroblock's left edge, inner
    vertical edges, top edge, inner horizontal edges. Macroblocks on one
    wavefront (mx + 2 my = t) touch disjoint pixels and are filtered
    together, the three planes of one step in one pass."""
    if hd.filter_type == 0:
        return
    table = _filter_strengths(hd)
    n_mb = mb_w * mb_h
    seg = np.array(segs)
    i4 = np.array(is4, np.int64)
    lim, il, hev = (np.array([table[s][k][j] for s, k in zip(seg, i4)]) for j in range(3))
    skipped = np.array(skips, bool) if hd.use_skip else np.zeros(n_mb, bool)
    inner = i4.astype(bool) | (~skipped & nonzero)
    my_all, mx_all = np.divmod(np.arange(n_mb), mb_w)
    wave = mx_all + 2 * my_all
    simple = hd.filter_type == 1
    wy, wc = Y.shape[1], U.shape[1]
    nu = U.size
    buf = np.concatenate([Y.ravel(), U.ravel(), V.ravel()])
    for t in range(int(wave.max()) + 1):
        sel = np.flatnonzero((wave == t) & (lim > 0))
        if not len(sel):
            continue
        my, mx = my_all[sel], mx_all[sel]
        left, top, inn = np.flatnonzero(mx > 0), np.flatnonzero(my > 0), np.flatnonzero(inner[sel])
        for vertical, outer in ((True, left), (False, top)):
            # the macroblock edge, then the three inner edges (chroma: one)
            for s, plus, kind, off, c_off in ((outer, 4, "mb", 0, 0), (inn, 0, "inner", 4, 4),
                                              (inn, 0, "inner", 8, None),
                                              (inn, 0, "inner", 12, None)):
                if not len(s):
                    continue
                ys, xs = 16 * my[s], 16 * mx[s]
                parts = [_edge_lines(0, wy, ys, xs, 16, off, vertical)]
                reps = [16]
                if not simple and c_off is not None:
                    for base in (Y.size, Y.size + nu):
                        parts.append(_edge_lines(base, wc, ys // 2, xs // 2, 8, c_off, vertical))
                        reps.append(8)
                idx = np.concatenate(parts)
                m = sel[s]
                params = [np.concatenate([np.repeat(v, r) for r in reps])
                          for v in (lim[m] + plus, il[m], hev[m])]
                px = buf[idx]
                _filter_lines(px, *params, "simple" if simple else kind)
                buf[idx] = px
    Y[:] = buf[:Y.size].reshape(Y.shape)
    U[:] = buf[Y.size:Y.size + nu].reshape(U.shape)
    V[:] = buf[Y.size + nu:].reshape(V.shape)


# ---------------------------------------------------------------------------
# libwebp's output stage


def _upsample(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler (UpsampleRgbaLinePair over EmitFancyRGB): a
    chroma plane [(h + 1) // 2, (w + 1) // 2] -> [h, w]. Each pixel mixes its
    nearest sample, the two beside it and the one across, 9-3-3-1, in
    libwebp's two roundings; the picture's first and last rows and columns
    use their nearest row or column twice."""
    c = plane.astype(np.int64)
    ch, cw = c.shape
    y = np.arange(h)
    near_r = y >> 1
    far_r = np.clip(np.where(y & 1, near_r + 1, near_r - 1), 0, ch - 1)
    x = np.arange(w)
    near_c = x >> 1
    far_c = np.where(x & 1, (x >> 1) + 1, (x >> 1) - 1)
    edge = (x == 0) | (far_c >= cw)
    far_c = np.clip(far_c, 0, cw - 1)
    nn = c[near_r][:, near_c]
    nf = c[near_r][:, far_c]                    # the near row, the far column
    fn = c[far_r][:, near_c]
    ff = c[far_r][:, far_c]
    out = (((nn + 3 * nf + 3 * fn + ff + 8) >> 3) + nn) >> 1
    out[:, edge] = ((3 * nn + fn + 2) >> 2)[:, edge]
    return out


def _yuv_to_rgb(y, u, v) -> np.ndarray:
    """libwebp's VP8YUVToR/G/B: 14-bit multipliers, 6 bits kept, clipped."""
    def mult_hi(a, coeff):
        return (a * coeff) >> 8

    def clip8(a):
        return np.where((a & ~16383) == 0, a >> 6, np.where(a < 0, 0, 255))

    yy = mult_hi(y, 19077)
    r = clip8(yy + mult_hi(v, 26149) - 14234)
    g = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(yy + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# the alpha plane


def _unfilter(a: np.ndarray, method: int) -> np.ndarray:
    """libwebp's WebPUnfilters: horizontal, vertical, gradient (the first row
    horizontal from 0; the first column from the pixel above)."""
    a = a.astype(np.int64)
    h, w = a.shape
    if method == 0:
        return a.astype(np.uint8)
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0]) & 0xFF
    if method == 1:
        for y in range(1, h):
            row = a[y].copy()
            row[0] += out[y - 1, 0]
            out[y] = np.cumsum(row) & 0xFF
    elif method == 2:
        out[1:] = (np.cumsum(a[1:], axis=0) + out[0]) & 0xFF
    else:
        for y in range(1, h):
            prev, cur = out[y - 1].tolist(), a[y].tolist()
            left = top_left = prev[0]
            row = [0] * w
            for x in range(w):
                top = prev[x]
                g = left + top - top_left
                left = (cur[x] + (0 if g < 0 else 255 if g > 255 else g)) & 0xFF
                top_left = top
                row[x] = left
            out[y] = row
    return out.astype(np.uint8)


def decode_alpha(data: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk's payload -> alpha uint8 [height, width] (libwebp's
    ALPHInit / ALPHDecode)."""
    if len(data) <= 1:
        raise ValueError("ALPH chunk without data")
    method, filt, pre, rsrv = data[0] & 3, (data[0] >> 2) & 3, (data[0] >> 4) & 3, data[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError(f"ALPH header {data[0]:#04x} is not read")
    if method == 0:
        if len(data) - 1 < width * height:
            raise ValueError("raw ALPH chunk shorter than its plane")
        plane = np.frombuffer(data, np.uint8, width * height, 1).reshape(height, width)
    else:
        plane = vp8l.decode_alpha_stream(data[1:], width, height)
    return _unfilter(plane, filt)


# ---------------------------------------------------------------------------


def read_vp8(data: bytes, alpha: bytes = None) -> np.ndarray:
    """A VP8 key frame (and its ALPH payload) -> uint8 [H, W, 4] RGBA, as
    libwebp writes it in MODE_RGBA (alpha 255 without an ALPH chunk)."""
    hd = _parse_header(data)
    w, h = hd.width, hd.height
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    segs, skips, is4, ymodes, uvmodes = _parse_modes(hd, mb_w, mb_h)
    coeffs, nonzero, simd = _parse_tokens(hd, mb_w, mb_h, segs, skips, is4)
    res = _idct(coeffs)
    if simd.any():
        res[simd] = _idct(coeffs[simd], simd=True)
    Y, U, V = _reconstruct(hd, mb_w, mb_h, is4, ymodes, uvmodes, res)
    _loop_filter(hd, mb_w, mb_h, Y, U, V, segs, is4, nonzero, skips)
    ch, cw = (h + 1) >> 1, (w + 1) >> 1
    rgb = _yuv_to_rgb(Y[:h, :w], _upsample(U[:ch, :cw], h, w), _upsample(V[:ch, :cw], h, w))
    a = decode_alpha(alpha, w, h) if alpha is not None else np.full((h, w), 255, np.uint8)
    return np.concatenate([rgb, a[..., None]], -1)
