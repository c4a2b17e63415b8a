"""Arithmetic-coded JPEGs (SOF9-SOF11, DAC, restarts) and the progressive
JPEGs libjpeg smooths, read by the port (utils/jpeg.py, utils/jpeg_arith.py)
against `imageio.v2.imread` (Pillow over libjpeg-turbo) on the same bytes:
the same uint8 array, or both refuse (the port with a ValueError naming the
file).

Pillow writes no arithmetic-coded JPEG, so this file writes them:
`ArithEncoder` is the QM coder of T.81 Annex D as libjpeg's encoder runs it
(its probability table read from the libjpeg that Pillow loads, not from the
port), and `arith_jpeg_file` writes sequential (SOF9) and progressive (SOF10:
DC first and refinement, AC first and refinement) scans of it, with restart
intervals and DAC conditioning, over tests/test_torch_image_formats.py's
pieces (its scenes, forward DCT, scan scripts and block order).
"""
import ctypes
import io
import os
import struct

import imageio.v2 as imageio
import numpy as np
import PIL
import pytest

from mofanerf_tpu_torch.utils import image_io as iio
from mofanerf_tpu_torch.utils import jpeg_arith
from tests.test_torch_image_formats import (SCRIPTS, ZIGZAG, _block_order, _both_raise, _check,
                                            _fdct_blocks, _segment, _write, jpeg_file, scene,
                                            ycc_planes)


def _libjpeg_table():
    """libjpeg's jpeg_aritab (Table D.2 packed as Qe << 16 | NMPS << 8 |
    Switch << 7 | NLPS) from the libjpeg Pillow loads."""
    libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    name = next(n for n in os.listdir(libs) if n.startswith("libjpeg"))
    tab = (ctypes.c_int64 * 114).in_dll(ctypes.CDLL(os.path.join(libs, name)), "jpeg_aritab")
    return list(tab)


ARITAB = _libjpeg_table()


class ArithEncoder:
    """T.81 D.1's encoder with libjpeg's jcarith.c registers: C with its
    spacer bits, the stacked 0xFF bytes (sc) and zero bytes (zc), carry
    propagation into the byte buffer, byte stuffing, and D.1.8's flush."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def _byte_out(self, temp):
        if temp > 0xFF:     # a carry over every stacked 0xFF
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st, i, val):
        sv = st[i]
        packed = ARITAB[sv & 0x7F]
        qe, nm, nl = packed >> 16, (packed >> 8) & 0xFF, packed & 0xFF
        self.a -= qe
        if val != sv >> 7:      # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _encode_magnitude(enc, st, i, v, big):
    """F.8 and F.9 for an AC value: the magnitude category of v = |value| - 1
    from bin st[i], the categories past the second from bin `big`, then v's
    bits below its top one."""
    m = 0
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v >> 1
        if v2:
            enc.encode(st, i, 1)
            m = 2
            i = big
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                v2 >>= 1
                i += 1
    enc.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1


class _ScanState:
    """One restart interval's statistics (tables 0-3), predictions and contexts."""

    def __init__(self):
        self.dc = [bytearray(64) for _ in range(4)]
        self.ac = [bytearray(256) for _ in range(4)]
        self.fixed = bytearray([113])
        self.pred, self.ctx = {}, {}


def _encode_dc(enc, s, c, tbl, value, dac):
    st, s0 = s.dc[tbl], s.ctx.get(c, 0)
    v = value - s.pred.get(c, 0)
    if v == 0:
        enc.encode(st, s0, 0)
        s.ctx[c] = 0
        return
    s.pred[c] = value
    enc.encode(st, s0, 1)
    if v > 0:
        enc.encode(st, s0 + 1, 0)
        i, ctx = s0 + 2, 4
    else:
        v = -v
        enc.encode(st, s0 + 1, 1)
        i, ctx = s0 + 3, 8
    v -= 1
    m = 0
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v
        i = 20
        while v2 >> 1:
            v2 >>= 1
            enc.encode(st, i, 1)
            m <<= 1
            i += 1
    enc.encode(st, i, 0)
    lo, hi = dac.get(("dc", tbl), (0, 1))
    if m < (1 << lo) >> 1:
        ctx = 0
    elif m > (1 << hi) >> 1:
        ctx += 8
    s.ctx[c] = ctx
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1


def _encode_ac(enc, s, tbl, row, ss, se, al, kx):
    """F.5 (sequential, al = 0) or G.1.3.2's first AC scan of one block."""
    st = s.ac[tbl]
    band = {k: (abs(int(row[k])) >> al) * (1 if row[k] >= 0 else -1) for k in range(ss, se + 1)}
    ke = max((k for k in band if band[k]), default=ss - 1)
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(st, i, 0)
        while not band[k]:
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        v = band[k]
        enc.encode(st, i + 1, 1)
        enc.encode(s.fixed, 0, 1 if v < 0 else 0)
        _encode_magnitude(enc, st, i + 2, abs(v) - 1, 189 if k <= kx else 217)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _encode_ac_refine(enc, s, tbl, row, ss, se, ah, al):
    """G.1.3.3: one AC refinement scan of one block."""
    st = s.ac[tbl]

    def mag(k, shift):
        return abs(int(row[k])) >> shift

    ke = max((k for k in range(ss, se + 1) if mag(k, al)), default=ss - 1)
    kex = max((k for k in range(ss, ke + 1) if mag(k, ah)), default=ss - 1)
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(st, i, 0)
        while True:
            v = mag(k, al)
            if v:
                if v >> 1:
                    enc.encode(st, i + 2, v & 1)
                else:
                    enc.encode(st, i + 1, 1)
                    enc.encode(s.fixed, 0, 1 if row[k] < 0 else 0)
                break
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def arith_jpeg_file(planes, factors=None, mode="sequential", scans=None, restart=0, dac=None,
                    app=(b"JFIF",), sof=None, q=None, tables=None, cut=None, pad_to=None,
                    trailer=b"\xff\xd9"):
    """Arithmetic-coded JPEG bytes of component planes (uint8, each at its
    sampled size). `mode` "sequential" (SOF9, one interleaved scan unless
    `scans` lists (component indices,) groups) or "progressive" (SOF10:
    `scans` (component indices, Ss, Se, Ah, Al), SCRIPTS' form); `restart` the
    interval in MCUs; `dac` {("dc", t): (L, U), ("ac", t): Kx} written as one
    DAC marker; `sof` another frame marker; `q` the quantisation table in
    natural order (default Annex K's luminance one); `tables` (DC, AC) table
    numbers a component; `cut` keeps only that many scans (with `trailer`
    after them); `pad_to`: before a scan whose data would cross the next multiple of
    this many bytes after its header, a COM segment that starts its header
    there."""
    n = len(planes)
    factors = factors or [(1, 1)] * n
    tables = tables or [(min(i, 1), min(i, 1)) for i in range(n)]
    dac = dac or {}
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    H = planes[0].shape[0] * vmax // factors[0][1]
    W = planes[0].shape[1] * hmax // factors[0][0]
    out = bytearray(b"\xff\xd8")
    for a in app:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                  14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                  18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                  49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
                 np.int64) if q is None else np.asarray(q, np.int64)
    out += _segment(0xDB, b"\x00" + bytes(q[ZIGZAG].astype(np.uint8)))
    if sof is None:
        sof = 0xC9 if mode == "sequential" else 0xCA
    body = struct.pack(">BHHB", 8, H, W, n)
    for i in range(n):
        body += bytes([i + 1, (factors[i][0] << 4) | factors[i][1], 0])
    out += _segment(sof, body)
    if dac:
        out += _segment(0xCC, b"".join(
            bytes([t, (v[1] << 4) | v[0]]) if kind == "dc" else bytes([16 + t, v])
            for (kind, t), v in sorted(dac.items())))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    mcus_x, mcus_y = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    sizes = [(-(-H * f[1] // vmax), -(-W * f[0] // hmax)) for f in factors]
    q_div = np.where(q == 0, 1, q)
    coefs = [_fdct_blocks(p, mcus_y * f[1], mcus_x * f[0], q_div).reshape(
        mcus_y * f[1], mcus_x * f[0], 64) for p, f in zip(planes, factors)]
    if scans is None:
        scans = [(list(range(n)), 0, 63, 0, 0)]
    elif mode == "sequential":
        scans = [(list(s[0]), 0, 63, 0, 0) for s in scans]
    for si, (ci, ss, se, ah, al) in enumerate(scans):
        if cut is not None and si == cut:
            return bytes(out + trailer)
        sos = bytes([len(ci)]) + b"".join(
            bytes([c + 1, (tables[c][0] << 4) | tables[c][1]]) for c in ci) \
            + bytes([ss, se, (ah << 4) | al])
        data = _arith_scan(coefs, factors, ci, mcus_x, mcus_y, sizes, restart, mode, ss, se,
                           ah, al, tables, dac)
        if pad_to:      # libjpeg holds the blocks up to the end of the SOS header
            start = len(out) + 4 + len(sos)
            limit = pad_to * ((start - 1) // pad_to + 1)
            if start + len(data) > limit:
                gap = limit - len(out)
                out += _segment(0xFE, b"\x00" * (gap - 4 if gap >= 4 else gap - 4 + pad_to))
        out += _segment(0xDA, sos) + data
    return bytes(out + trailer)


def _arith_scan(coefs, factors, ci, mcus_x, mcus_y, sizes, restart, mode, ss, se, ah, al, tables,
                dac):
    enc, s, out = ArithEncoder(), _ScanState(), bytearray()
    interleaved = len(ci) > 1
    for m, units in enumerate(_block_order(ci, factors, mcus_x, mcus_y, interleaved, sizes)):
        if restart and m and m % restart == 0:
            out += enc.finish() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            enc, s = ArithEncoder(), _ScanState()
        for c, by, bx in units:
            row = coefs[c][by, bx]
            td, ta = tables[c]
            if mode == "sequential":
                _encode_dc(enc, s, c, td, int(row[0]), dac)
                _encode_ac(enc, s, ta, row, 1, 63, 0, dac.get(("ac", ta), 5))
            elif ss == 0 and ah == 0:
                _encode_dc(enc, s, c, td, int(row[0]) >> al, dac)
            elif ss == 0:
                enc.encode(s.fixed, 0, (int(row[0]) >> al) & 1)
            elif ah == 0:
                _encode_ac(enc, s, ta, row, ss, se, al, dac.get(("ac", ta), 5))
            else:
                _encode_ac_refine(enc, s, ta, row, ss, se, ah, al)
    return bytes(out + enc.finish())


F444, F420, F422 = [(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)]


def _colour(shape, factors, seed=0):
    return ycc_planes(scene(*shape, seed=seed), factors)


# ---------------------------------------------------------------------------
# the coder and its table


def test_probability_table_is_libjpegs():
    """The port's Table D.2 and its state transitions against libjpeg's own
    jpeg_aritab."""
    for sv in range(256):
        idx = sv & 0x7F
        if idx > 113:
            continue
        packed = ARITAB[idx]
        assert jpeg_arith._QE[sv] == packed >> 16
        assert jpeg_arith._AFTER_MPS[sv] == (sv & 0x80) ^ ((packed >> 8) & 0xFF)
        assert jpeg_arith._AFTER_LPS[sv] == (sv & 0x80) ^ (packed & 0xFF)


# ---------------------------------------------------------------------------
# sequential (SOF9)


@pytest.mark.parametrize("factors", [F444, F420, F422, "gray"], ids=["444", "420", "422", "gray"])
@pytest.mark.parametrize("shape", [(37, 53), (16, 16), (9, 15)])
def test_sequential(tmp_path, factors, shape):
    planes = [scene(*shape, seed=2)[..., 1]] if factors == "gray" else _colour(shape, factors)
    data = arith_jpeg_file(planes, factors=None if factors == "gray" else factors)
    _check(_write(tmp_path, "a.jpg", data))


@pytest.mark.parametrize("restart", [1, 3, 5, 7])
@pytest.mark.parametrize("factors", [F444, F420], ids=["444", "420"])
def test_sequential_restarts(tmp_path, restart, factors):
    """Restart intervals that are not whole MCU rows (the 37 x 53 frame is 7
    MCUs wide at 4:4:4, 4 at 4:2:0), each resetting the coder and statistics."""
    data = arith_jpeg_file(_colour((37, 53), factors), factors=factors, restart=restart)
    assert b"\xff\xd0" in data
    _check(_write(tmp_path, "r.jpg", data))


@pytest.mark.parametrize("dac", [{("dc", 0): (0, 0), ("dc", 1): (2, 5), ("ac", 0): 1,
                                  ("ac", 1): 20},
                                 {("dc", 0): (3, 3), ("ac", 0): 63, ("ac", 1): 0},
                                 {("dc", 0): (1, 15), ("dc", 1): (0, 2), ("ac", 0): 2}],
                         ids=["mixed", "narrow", "wide"])
def test_sequential_dac_conditioning(tmp_path, dac):
    """DAC with non-default L, U and Kx for both tables."""
    img = np.random.default_rng(5).integers(0, 256, (24, 40, 3), np.uint8)
    for name, planes in (("s", _colour((29, 41), F420)), ("n", ycc_planes(img, F420))):
        data = arith_jpeg_file(planes, factors=F420, dac=dac, restart=3)
        assert b"\xff\xcc" in data
        _check(_write(tmp_path, f"{name}.jpg", data))


def test_sequential_non_interleaved_and_tables(tmp_path):
    """Three one-component scans (one scan a component), and the components
    on DC and AC tables 2 and 3."""
    planes = _colour((21, 30), F420)
    data = arith_jpeg_file(planes, factors=F420, scans=[([0],), ([2],), ([1],)],
                           tables=[(2, 3), (3, 2), (0, 0)], restart=2)
    _check(_write(tmp_path, "n.jpg", data))


# ---------------------------------------------------------------------------
# progressive (SOF10)

ARITH_SCRIPTS = dict(SCRIPTS, pillow=[
    ([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
    ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0),
    ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)])


@pytest.mark.parametrize("script", sorted(ARITH_SCRIPTS))
@pytest.mark.parametrize("factors", [F444, F420, F422], ids=["444", "420", "422"])
@pytest.mark.parametrize("restart", [0, 3])
def test_progressive_scripts(tmp_path, script, factors, restart):
    """Every progressive script of tests/test_torch_image_formats.py and the
    script libjpeg writes by default (AC refinement included), arithmetic-coded."""
    data = arith_jpeg_file(_colour((23, 37), factors, seed=1), factors=factors,
                           mode="progressive", scans=ARITH_SCRIPTS[script], restart=restart)
    _check(_write(tmp_path, "p.jpg", data))


def test_progressive_gray_noise(tmp_path):
    """Grey noise: long magnitude categories, EOB late in every block."""
    img = np.random.default_rng(9).integers(0, 256, (33, 47), np.uint8)
    data = arith_jpeg_file([img], mode="progressive", scans=[
        ([0], 0, 0, 0, 1), ([0], 1, 63, 0, 2), ([0], 1, 63, 2, 1), ([0], 0, 0, 1, 0),
        ([0], 1, 63, 1, 0)], restart=4)
    _check(_write(tmp_path, "g.jpg", data))


# ---------------------------------------------------------------------------
# what imageio refuses


@pytest.mark.parametrize("sof", [0xCB, 0xCD, 0xCE, 0xCF])
def test_lossless_and_hierarchical_frames(tmp_path, sof):
    """SOF11 (arithmetic lossless) and SOF13-SOF15 (hierarchical): both refuse;
    the header still gives the size."""
    data = arith_jpeg_file(_colour((16, 16), F444), sof=sof)
    path = _write(tmp_path, "h.jpg", data)
    _both_raise(path)
    assert iio.image_size(str(path)) == (16, 16)


def test_scan_past_pillows_first_block(tmp_path):
    """A scan whose data crosses the 64 KiB block that Pillow hands libjpeg:
    libjpeg's arithmetic decoder cannot wait for the next block, so imageio
    refuses it; the same scans padded to start at a block boundary read."""
    img = np.random.default_rng(1).integers(0, 256, (96, 256, 3), np.uint8)
    planes = ycc_planes(img, F444)
    script = [([0, 1, 2], 0, 0, 0, 0), ([0], 1, 63, 0, 0), ([1], 1, 63, 0, 0),
              ([2], 1, 63, 0, 0)]
    crossing = arith_jpeg_file(planes, mode="progressive", scans=script, q=np.ones(64))
    assert len(crossing) > 65536
    _both_raise(_write(tmp_path, "x.jpg", crossing))
    _check(_write(tmp_path, "ok.jpg", arith_jpeg_file(planes, mode="progressive", scans=script,
                                                      q=np.ones(64), pad_to=65536)))


# ---------------------------------------------------------------------------
# damaged files: cut, cut with an EOI put back, and bits flipped in the scans


def _scan_data(data):
    """[(start, end)] of each scan's entropy-coded bytes (restart markers
    inside)."""
    out, i = [], 2
    while i < len(data) - 1:
        if data[i] == 0xFF and data[i + 1] == 0xDA:
            j = start = i + 2 + (data[i + 2] << 8 | data[i + 3])
            while not (data[j] == 0xFF and data[j + 1] not in (0x00, 0xFF)
                       and not 0xD0 <= data[j + 1] <= 0xD7):
                j += 1
            out.append((start, j))
            i = j
        else:
            i += 1
    return out


DAMAGED = {
    "sequential_420": lambda: arith_jpeg_file(_colour((37, 53), F420), factors=F420),
    "sequential_restart": lambda: arith_jpeg_file(_colour((37, 53), F420), factors=F420,
                                                  restart=2),
    "progressive_420": lambda: arith_jpeg_file(_colour((37, 53), F420), factors=F420,
                                               mode="progressive",
                                               scans=ARITH_SCRIPTS["pillow"]),
    "progressive_restart": lambda: arith_jpeg_file(_colour((37, 53), F444),
                                                   mode="progressive",
                                                   scans=ARITH_SCRIPTS["pillow"], restart=3),
}


def _same_or_both_raise(path):
    """imageio's array and the port's equal, or both raise."""
    try:
        imageio.imread(path)
    except Exception:
        _both_raise(path)
        return None
    return _check(path)


@pytest.mark.parametrize("name", sorted(DAMAGED))
@pytest.mark.parametrize("seed", range(4))
def test_flipped_bits(tmp_path, name, seed):
    """Bits flipped in the entropy-coded data (markers made or unmade among
    them): libjpeg decodes the damage, warns where a magnitude or the
    spectral position overflows and leaves the rest of the interval
    undecoded, reads zeros after a marker it meets, and resynchronises at
    restart markers; its SIMD IDCT saturates the garbage. The port returns
    the same pixels or refuses where imageio refuses."""
    data = DAMAGED[name]()
    rng = np.random.default_rng(seed)
    scans = _scan_data(data)
    for k in range(6):
        start, end = scans[int(rng.integers(len(scans)))]
        flipped = bytearray(data)
        flipped[int(rng.integers(start, end))] ^= 1 << int(rng.integers(8))
        _same_or_both_raise(_write(tmp_path, f"f{k}.jpg", bytes(flipped)))


@pytest.mark.parametrize("name", sorted(DAMAGED))
@pytest.mark.parametrize("eoi", [False, True], ids=["cut", "cut_eoi"])
def test_cut_files(tmp_path, name, eoi):
    """The file cut at six places inside its scans, as it is (imageio reads a
    one-scan file whose decoder never needs the lost bytes, and refuses the
    rest) and with an EOI marker put back (the coder reads zeros past it)."""
    data = DAMAGED[name]()
    rng = np.random.default_rng(11)
    scans = _scan_data(data)
    for k in range(6):
        start, end = scans[int(rng.integers(len(scans)))]
        cut = int(rng.integers(start, end + 1))
        _same_or_both_raise(_write(tmp_path, f"c{k}.jpg",
                                   data[:cut] + (b"\xff\xd9" if eoi else b"")))


@pytest.mark.parametrize("shift", range(-3, 3))
def test_scan_end_at_pillows_block_boundary(tmp_path, shift):
    """The last scan's data ending a few bytes either side of the 64 KiB
    boundary: imageio refuses from the first byte its decoder would need
    past it, and so does the port."""
    img = np.random.default_rng(1).integers(0, 256, (64, 256, 3), np.uint8)
    data = arith_jpeg_file(ycc_planes(img, F444), mode="progressive", q=np.ones(64), scans=[
        ([0, 1, 2], 0, 0, 0, 0), ([0], 1, 63, 0, 0), ([1], 1, 63, 0, 0), ([2], 1, 63, 0, 0)])
    gap = 65536 - (len(data) - 2) + shift      # a COM segment moving the EOI to 65536 + shift
    _same_or_both_raise(_write(tmp_path, "b.jpg",
                               data[:2] + _segment(0xFE, bytes(gap - 4)) + data[2:]))


# ---------------------------------------------------------------------------
# block smoothing of progressive files whose scans leave bits unknown


def _huffman_progressive(script, factors, shape, cut):
    return jpeg_file(_colour(shape, factors, seed=1), factors=factors, mode="progressive",
                     scans=SCRIPTS[script], cut=cut) + b"\xff\xd9"


@pytest.mark.parametrize("cut", range(1, 9))
@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("factors", [F444, F420], ids=["444", "420"])
def test_smoothing_huffman_cut_after_each_scan(tmp_path, cut, script, factors):
    """A progressive file ended (EOI) after each scan of each script: DC-only
    stages (the DC interpolated over 5 x 5 blocks, nine AC estimates), stages
    with some AC bands known (five estimates, each under 2^Al), DC at Al > 0,
    a component with no scan yet (no smoothing at all). 37 rows at 4:2:0: a
    partial last iMCU row."""
    _check(_write(tmp_path, "s.jpg", _huffman_progressive(script, factors, (37, 53), cut)))


@pytest.mark.parametrize("cut", range(1, 11))
def test_smoothing_pillow_file_cut_after_each_scan(tmp_path, cut):
    """Pillow's (libjpeg's default) progressive script, 4:2:0, AC refinement
    scans among them, ended after each of its ten scans."""
    buf = io.BytesIO()
    PIL.Image.fromarray(scene(45, 61, seed=3)).save(buf, format="JPEG", quality=85,
                                                    progressive=True, subsampling=2)
    data = buf.getvalue()
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    assert len(sos) == 10
    cut_at = sos[cut] if cut < len(sos) else len(data) - 2
    _check(_write(tmp_path, "p.jpg", data[:cut_at] + b"\xff\xd9"))


@pytest.mark.parametrize("zero_at", list(range(11)) + [None])
def test_smoothing_quantisation_zeros(tmp_path, zero_at):
    """A quantisation entry of 0 at zig-zag position 0-9 (DC and the nine
    estimated coefficients) turns smoothing off for the whole image, one at
    10 does not: the Huffman file cut after its DC scans and the
    arithmetic one after its first AC band."""
    for name, data in (
            ("h", _huffman_progressive("bands", F420, (29, 35), 2)),
            ("a", arith_jpeg_file(_colour((29, 35), F420, seed=2), factors=F420,
                                  mode="progressive", scans=ARITH_SCRIPTS["pillow"], cut=2))):
        data = bytearray(data)
        dqt = data.index(b"\xff\xdb") + 5
        if zero_at is not None:
            data[dqt + zero_at] = 0
        _check(_write(tmp_path, f"{name}.jpg", bytes(data)))


GRAY_SCRIPT = [([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
               ([0], 0, 0, 1, 0), ([0], 1, 63, 1, 0)]


@pytest.mark.parametrize("factors,cut", [(f, c) for f in ("420", "422") for c in range(1, 11)]
                         + [("gray", c) for c in range(1, len(GRAY_SCRIPT) + 1)])
def test_smoothing_arithmetic_cut_after_each_scan(tmp_path, factors, cut):
    """An arithmetic-coded progressive file ended after each scan of
    libjpeg's default script (a grey one's six): smoothing is the same for
    both entropy codes."""
    if factors == "gray":
        planes, sampling, scans = [scene(37, 53, seed=4)[..., 0]], None, GRAY_SCRIPT
    else:
        sampling = {"420": F420, "422": F422}[factors]
        planes, scans = _colour((37, 53), sampling, seed=4), ARITH_SCRIPTS["pillow"]
    data = arith_jpeg_file(planes, factors=sampling, mode="progressive", scans=scans, cut=cut)
    _check(_write(tmp_path, "c.jpg", data))


# ---------------------------------------------------------------------------
# the committed fixtures of mofanerf_tpu_torch/testdata/formats/


def quality_table(quality):
    """libjpeg's scaling of Annex K's luminance table to `quality`."""
    base = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def arith_fixture_files(canvas, uv, photo, d_jpg):
    """The committed files of this slice, by name: E.jpg (the wild photo D's
    canvas, progressive arithmetic-coded 4:2:0 at quality 90 with libjpeg's
    default script), F.jpg (D.jpg ended before its last four scans, so that
    libjpeg smooths it), uv_arith.jpg (the UV map, sequential arithmetic
    4:2:0) and photo_1024_arith.jpg (the 1024^2 decode-timing photo as E is
    coded, its scans placed in Pillow's 64 KiB blocks)."""
    q = quality_table(90)
    sos = [i for i in range(len(d_jpg) - 1) if d_jpg[i] == 0xFF and d_jpg[i + 1] == 0xDA]
    return {
        "E.jpg": arith_jpeg_file(ycc_planes(canvas, F420), factors=F420, mode="progressive",
                                 scans=ARITH_SCRIPTS["pillow"], q=q),
        "F.jpg": d_jpg[:sos[6]] + b"\xff\xd9",
        "uv_arith.jpg": arith_jpeg_file(ycc_planes((np.clip(uv, 0, 1) * 255).astype(np.uint8),
                                                   F420), factors=F420, q=q),
        "photo_1024_arith.jpg": arith_jpeg_file(ycc_planes(photo, F420), factors=F420,
                                                mode="progressive",
                                                scans=ARITH_SCRIPTS["pillow"], q=q,
                                                pad_to=jpeg_arith.PILLOW_BLOCK),
    }
