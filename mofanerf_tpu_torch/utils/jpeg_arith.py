"""Arithmetic-coded JPEG scans (ITU-T T.81 Annex D, F.1.4.4 and G.1.3),
decoded as libjpeg-turbo's jdarith.c decodes them, for utils/jpeg.py.

`decode_scan` reads one scan (sequential SOF9, or a progressive SOF10 DC
first, DC refinement, AC first or AC refinement scan) into the same
per-component coefficient buffers (array('i'), zig-zag order) that the
Huffman stages of utils/jpeg.py fill. Pure Python, one binary decision at a
time:

- the QM coder with Table D.2's probability estimation, its registers and
  byte reading as libjpeg's: a 0xFF byte followed by 0x00 is a data 0xFF,
  further 0xFF bytes are padding, and a marker met inside the data makes the
  coder read zeros from then on (legal in arithmetic coding);
- the DC statistics (S0 conditioned on the previous difference through the
  DAC bounds L and U, magnitude categories from X1), the AC statistics (EOB,
  zero and magnitude bins a coefficient, the magnitude bins split at Kx), the
  fixed 0.5 bin of signs and refinement bits;
- restart intervals: each resets the coder, the DC predictions and contexts,
  and the statistics its scan type uses; a restart marker out of sequence is
  handled as libjpeg's jpeg_resync_to_restart handles it;
- damaged data as libjpeg meets it: a magnitude or spectral overflow warns
  there and leaves the rest of the restart interval undecoded (`ct = -1`);
  coefficients are 16-bit (JCOEF) and wrap as libjpeg's do.

imageio reads a JPEG through Pillow, which hands libjpeg the file 64 KiB at
a time and lets it suspend for more; libjpeg's arithmetic decoder cannot
suspend, so a scan that needs a byte past the data handed over so far fails
there. `decode_scan` refuses the same scans: `limit` is where that data ends.
"""
from __future__ import annotations

# T.81 Table D.2: (Qe, Next_Index_MPS, Next_Index_LPS, Switch_MPS) by state
# index; state 113 is the fixed probability 0.5 of the sign and refinement bins
_TABLE_D2 = [
    (0x5A1D, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0), (0x080B, 4, 18, 0),
    (0x03D8, 5, 20, 0), (0x01DA, 6, 23, 0), (0x00E5, 7, 25, 0), (0x006F, 8, 28, 0),
    (0x0036, 9, 30, 0), (0x001A, 10, 33, 0), (0x000D, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5A7F, 15, 15, 1), (0x3F25, 16, 36, 0),
    (0x2CF2, 17, 38, 0), (0x207C, 18, 39, 0), (0x17B9, 19, 40, 0), (0x1182, 20, 42, 0),
    (0x0CEF, 21, 43, 0), (0x09A1, 22, 45, 0), (0x072F, 23, 46, 0), (0x055C, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0), (0x01B1, 28, 54, 0),
    (0x0144, 29, 56, 0), (0x00F5, 30, 57, 0), (0x00B7, 31, 59, 0), (0x008A, 32, 60, 0),
    (0x0068, 33, 62, 0), (0x004E, 34, 63, 0), (0x003B, 35, 32, 0), (0x002C, 9, 33, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 38, 64, 0), (0x3A0D, 39, 65, 0), (0x2EF1, 40, 67, 0),
    (0x261F, 41, 68, 0), (0x1F33, 42, 69, 0), (0x19A8, 43, 70, 0), (0x1518, 44, 72, 0),
    (0x1177, 45, 73, 0), (0x0E74, 46, 74, 0), (0x0BFB, 47, 75, 0), (0x09F8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05CD, 51, 48, 0), (0x04DE, 52, 50, 0),
    (0x040F, 53, 50, 0), (0x0363, 54, 51, 0), (0x02D4, 55, 52, 0), (0x025C, 56, 53, 0),
    (0x01F8, 57, 54, 0), (0x01A4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00F6, 61, 58, 0), (0x00CB, 62, 59, 0), (0x00AB, 63, 61, 0), (0x008F, 32, 61, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 66, 80, 0), (0x412C, 67, 81, 0), (0x37D8, 68, 82, 0),
    (0x2FE8, 69, 83, 0), (0x293C, 70, 84, 0), (0x2379, 71, 86, 0), (0x1EDF, 72, 87, 0),
    (0x1AA9, 73, 87, 0), (0x174E, 74, 72, 0), (0x1424, 75, 72, 0), (0x119C, 76, 74, 0),
    (0x0F6B, 77, 74, 0), (0x0D51, 78, 75, 0), (0x0BB6, 79, 77, 0), (0x0A40, 48, 77, 0),
    (0x5832, 81, 80, 1), (0x4D1C, 82, 88, 0), (0x438E, 83, 89, 0), (0x3BDD, 84, 90, 0),
    (0x34EE, 85, 91, 0), (0x2EAE, 86, 92, 0), (0x299A, 87, 93, 0), (0x2516, 71, 86, 0),
    (0x5570, 89, 88, 1), (0x4CA9, 90, 95, 0), (0x44D9, 91, 96, 0), (0x3E22, 92, 97, 0),
    (0x3824, 93, 99, 0), (0x32B4, 94, 99, 0), (0x2E17, 86, 93, 0), (0x56A8, 96, 95, 1),
    (0x4F46, 97, 101, 0), (0x47E5, 98, 102, 0), (0x41CF, 99, 103, 0), (0x3C3D, 100, 104, 0),
    (0x375E, 93, 99, 0), (0x5231, 102, 105, 0), (0x4C0F, 103, 106, 0), (0x4639, 104, 107, 0),
    (0x415E, 99, 103, 0), (0x5627, 106, 105, 1), (0x50E7, 107, 108, 0), (0x4B85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504F, 107, 111, 0), (0x5A10, 111, 110, 1), (0x5522, 109, 112, 0),
    (0x59EB, 111, 112, 1), (0x5A1D, 113, 113, 0),
]
FIXED = 113     # the state of the fixed 0.5 bin

# by statistics byte sv (bit 7 the MPS, bits 0-6 the state): Qe, the byte after
# an MPS, the byte after an LPS (the MPS exchanged where Switch_MPS says so)
_QE = [_TABLE_D2[sv & 0x7F][0] if (sv & 0x7F) < len(_TABLE_D2) else 0 for sv in range(256)]
_AFTER_MPS = [(sv & 0x80) | _TABLE_D2[sv & 0x7F][1] if (sv & 0x7F) < len(_TABLE_D2) else sv
              for sv in range(256)]
_AFTER_LPS = [((sv & 0x80) ^ (_TABLE_D2[sv & 0x7F][3] << 7)) | _TABLE_D2[sv & 0x7F][2]
              if (sv & 0x7F) < len(_TABLE_D2) else sv for sv in range(256)]

DC_BINS, AC_BINS = 64, 256
PILLOW_BLOCK = 65536    # bytes Pillow hands libjpeg a call (ImageFile.MAXBLOCK)


class Conditioning:
    """The DAC marker's tables: DC bounds L and U and AC split Kx by table
    number, libjpeg's defaults L = 0, U = 1, Kx = 5."""

    def __init__(self):
        self.dc_l, self.dc_u, self.ac_k = [0] * 16, [1] * 16, [5] * 16

    def define(self, body: bytes) -> None:
        """Apply a DAC marker's body (pairs of table index, value), as
        jdmarker.c's get_dac checks it."""
        if len(body) % 2:
            raise ValueError("JPEG DAC marker of an odd length")
        for i in range(0, len(body), 2):
            index, val = body[i], body[i + 1]
            if index >= 32:
                raise ValueError(f"JPEG DAC table index {index} (at most 31)")
            if index >= 16:
                self.ac_k[index - 16] = val
            else:
                lo, hi = val & 15, val >> 4
                if lo > hi:
                    raise ValueError(f"JPEG DAC bounds L={lo} > U={hi}")
                self.dc_l[index], self.dc_u[index] = lo, hi


def _i16(v: int) -> int:
    """A value stored in a 16-bit JCOEF."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def decode_scan(data: bytes, pos: int, units, n_mcu_x: int, n_mcu: int, restart: int,
                mode: str, ss: int, se: int, al: int, cond: Conditioning, limit: int) -> int:
    """Decode one arithmetic-coded scan whose entropy-coded data starts at
    data[pos] into its components' coefficients (`comp.coef`, zig-zag order).

    `units`: the data units of one MCU as (component, DC table, AC table, dy,
    dx), with `n_mcu_x` MCUs a row and `n_mcu` in all (utils/jpeg.py's
    `_scan_layout`); `mode`: "sequential", "dc_first", "dc_refine",
    "ac_first" or "ac_refine"; `ss`..`se` the spectral band, `al` the point
    transform; `limit`: the end of the data libjpeg has been handed (reading
    past it or past the file fails). Returns the position of the marker that
    ends the scan (where libjpeg reads its next marker; len(data) when the
    file ends first)."""
    end = min(len(data), limit)
    interleaved = len(units) > 1    # a one-component scan's MCU is one data unit
    comps = list({id(u[0]): u[:3] for u in units}.values())
    dc_stats = {td: bytearray(DC_BINS) for _, td, _ in comps}
    ac_stats = {ta: bytearray(AC_BINS) for _, _, ta in comps}
    fixed = bytearray([FIXED])
    qe_of, after_mps, after_lps = _QE, _AFTER_MPS, _AFTER_LPS
    # the coder's registers, its read position and the marker it met (0: none)
    a = c = 0
    ct = -16
    p, marker = pos, 0

    def get() -> int:
        nonlocal p
        if p >= end:
            if p >= len(data):
                raise ValueError("JPEG arithmetic-coded data runs past the end of the file")
            raise ValueError(
                f"JPEG arithmetic-coded scan reads past byte {limit}: imageio's reader hands "
                f"libjpeg {PILLOW_BLOCK} bytes a call, and libjpeg's arithmetic decoder cannot "
                "wait for more")
        p += 1
        return data[p - 1]

    def decide(st: bytearray, i: int) -> int:
        """One binary decision with the statistics byte st[i] (jdarith.c's
        arith_decode: renormalisation and byte input per D.2.6, then D.2.4-5)."""
        nonlocal a, c, ct, marker
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if marker:
                    byte = 0
                else:
                    byte = get()
                    if byte == 0xFF:
                        byte = get()
                        while byte == 0xFF:
                            byte = get()
                        if byte:
                            marker, byte = byte, 0
                        else:
                            byte = 0xFF
                c = (c << 8) | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = qe_of[sv]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = after_mps[sv]
                return sv >> 7
            a = qe
            st[i] = after_lps[sv]
            return (sv >> 7) ^ 1
        if a < 0x8000:
            if a < qe:
                st[i] = after_lps[sv]
                return (sv >> 7) ^ 1
            st[i] = after_mps[sv]
        return sv >> 7

    def next_marker() -> None:
        """jdmarker.c's next_marker: skip to the next marker and latch it."""
        nonlocal marker
        while True:
            byte = get()
            while byte != 0xFF:
                byte = get()
            byte = get()
            while byte == 0xFF:
                byte = get()
            if byte:
                marker = byte
                return

    next_rst = 0
    preds = {id(comp): 0 for comp, _, _ in comps}
    contexts = {id(comp): 0 for comp, _, _ in comps}

    def process_restart() -> None:
        """jdarith.c's process_restart over jdmarker.c's read_restart_marker
        and jpeg_resync_to_restart."""
        nonlocal marker, next_rst, a, c, ct
        if not marker:
            next_marker()
        while True:
            action = resync_action(marker, next_rst)
            if action == 1:
                marker = 0
                break
            if action == 3:
                break
            next_marker()
        next_rst = (next_rst + 1) & 7
        for comp, td, ta in comps:
            if mode in ("sequential", "dc_first"):
                dc_stats[td][:] = bytes(DC_BINS)
                preds[id(comp)] = contexts[id(comp)] = 0
            if mode in ("sequential", "ac_first", "ac_refine"):
                ac_stats[ta][:] = bytes(AC_BINS)
        a = c = 0
        ct = -16

    def magnitude(st, i, big):
        """The magnitude category and bit pattern of a non-zero AC value (F.23,
        F.24) from bin st[i], the categories past the second at bin `big`:
        |v| - 1, or None on a magnitude overflow."""
        m = decide(st, i)
        if m and decide(st, i):
            m = 2
            i = big
            while decide(st, i):
                m <<= 1
                if m == 0x8000:
                    return None
                i += 1
        v = m
        i += 14
        m >>= 1
        while m:
            if decide(st, i):
                v |= m
            m >>= 1
        return v

    def dc_diff(comp, td) -> int | None:
        """A DC difference (F.19-F.24) with its context, or None on a
        magnitude overflow; updates the component's context."""
        st = dc_stats[td]
        s0 = contexts[id(comp)]
        if not decide(st, s0):
            contexts[id(comp)] = 0
            return 0
        sign = decide(st, s0 + 1)
        i = s0 + 2 + sign
        m = decide(st, i)
        if m:
            i = 20
            while decide(st, i):
                m <<= 1
                if m == 0x8000:
                    return None
                i += 1
        if m < (1 << cond.dc_l[td]) >> 1:
            contexts[id(comp)] = 0
        elif m > (1 << cond.dc_u[td]) >> 1:
            contexts[id(comp)] = 12 + 4 * sign
        else:
            contexts[id(comp)] = 4 + 4 * sign
        v = m
        i += 14
        m >>= 1
        while m:
            if decide(st, i):
                v |= m
            m >>= 1
        v += 1
        return -v if sign else v

    togo = restart
    for mcu in range(n_mcu):
        if restart:
            if togo == 0:
                process_restart()
                togo = restart
            togo -= 1
        if ct == -1 and mode != "dc_refine":
            continue
        my, mx = divmod(mcu, n_mcu_x)
        for comp, td, ta, dy, dx in units:
            if interleaved:
                base = ((my * comp.v + dy) * comp.blocks_x + mx * comp.h + dx) * 64
            else:
                base = (my * comp.blocks_x + mx) * 64
            coef = comp.coef
            if mode == "dc_refine":
                if decide(fixed, 0):
                    coef[base] = _i16(coef[base] | (1 << al))
                continue
            if mode in ("sequential", "dc_first"):
                diff = dc_diff(comp, td)
                if diff is None:
                    ct = -1
                    break
                pred = (preds[id(comp)] + diff) & 0xFFFF
                preds[id(comp)] = pred
                if mode == "dc_first":
                    coef[base] = _i16(pred << al)
                    continue
                coef[base] = _i16(pred)
                lo, hi = 1, 63
            else:
                lo, hi = ss, se
            st = ac_stats[ta]
            tbl_k = cond.ac_k[ta]
            if mode == "ac_refine":
                p1, m1 = 1 << al, -(1 << al)
                kex = hi
                while kex > 0 and not coef[base + kex]:
                    kex -= 1
                k = lo
                while k <= hi:
                    i = 3 * (k - 1)
                    if k > kex and decide(st, i):
                        break                           # end of block
                    while True:
                        old = coef[base + k]
                        if old:                         # a correction bit
                            if decide(st, i + 2):
                                coef[base + k] = _i16(old + (m1 if old < 0 else p1))
                            break
                        if decide(st, i + 1):           # newly non-zero
                            coef[base + k] = m1 if decide(fixed, 0) else p1
                            break
                        i += 3
                        k += 1
                        if k > hi:
                            ct = -1                     # spectral overflow
                            break
                    if ct == -1:
                        break
                    k += 1
                if ct == -1:
                    break
                continue
            k = lo
            while k <= hi:
                i = 3 * (k - 1)
                if decide(st, i):
                    break                               # end of block
                while not decide(st, i + 1):
                    i += 3
                    k += 1
                    if k > hi:
                        ct = -1                         # spectral overflow
                        break
                if ct == -1:
                    break
                sign = decide(fixed, 0)
                v = magnitude(st, i + 2, 189 if k <= tbl_k else 217)
                if v is None:
                    ct = -1                             # magnitude overflow
                    break
                v += 1
                coef[base + k] = _i16((-v if sign else v) << al)
                k += 1
            if ct == -1:
                break
    # where libjpeg reads its next marker: the one the coder met, else the next in the data
    return p - 2 if marker else marker_after(data, p)


def resync_action(marker: int, next_rst: int) -> int:
    """What libjpeg does at a restart with `marker` latched where it expects
    RST`next_rst` (jdmarker.c's jpeg_resync_to_restart, the expected marker
    included): 1 take the marker and go on with the data after it, 2 skip to
    the next marker and decide again, 3 leave it latched (the interval reads
    no data)."""
    if marker < 0xC0:
        return 2                            # not a valid marker
    if not 0xD0 <= marker <= 0xD7:
        return 3                            # a valid marker other than RSTn
    ahead = (marker - 0xD0 - next_rst) & 7
    if ahead in (1, 2):
        return 3                            # one of the next two restarts
    if ahead in (6, 7):
        return 2                            # one of the two before
    return 1                                # the expected one, or too far away


def marker_after(data: bytes, pos: int) -> int:
    """The position of the 0xFF before the next marker code at or after
    data[pos], as jdmarker.c's next_marker finds it (other bytes, and 0xFF
    0x00 pairs, skipped; repeated 0xFF bytes are padding); len(data) when
    the data ends first."""
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return len(data)
        code = pos + 1
        while code < len(data) and data[code] == 0xFF:
            code += 1
        if code >= len(data):
            return len(data)
        if data[code]:
            return code - 1
        pos = code + 1
