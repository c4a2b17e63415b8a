"""A Zstandard decoder in Python and numpy (RFC 8878).

Reads the frames that the JAX package's Orbax checkpoints hold (each zarr
chunk is one frame, `train/orbax.py`) without a compression library:

- frames: the header's window, dictionary-ID and content-size fields, many
  blocks a frame, the content checksum (XXH64) checked when the frame has
  one; skippable frames are passed over;
- blocks: raw, RLE and compressed;
- literals: raw, RLE, Huffman-coded with 1 or 4 streams, and treeless (the
  frame's previous Huffman table); Huffman weights given directly or
  FSE-coded;
- sequences: FSE tables in their predefined, RLE, compressed and repeat
  modes, and the three repeat offsets.

The Huffman literals are the hot path. A stream's decoding table is looked
up at every bit position at once with numpy (`_huffman_stream`); what is
left to Python is following the chain of positions, one `bytes` index and
one subtraction a literal. A frame that uses a dictionary is refused.

`STATS` counts what was decoded by kind (blocks, literal types, table modes),
a few additions a block.
"""
from __future__ import annotations

import collections
import struct

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50   # 0x184D2A5? : the low nibble is free
MAX_BLOCK = 128 * 1024

STATS: collections.Counter = collections.Counter()


class ZstdError(ValueError):
    """A frame that is corrupt, truncated or uses what this decoder refuses."""


def _highbit(v: int) -> int:
    return v.bit_length() - 1


# ---------------------------------------------------------------- bit streams

class _ForwardBits:
    """Bits read from the start of `data`, least significant first (the FSE
    table descriptions)."""

    def __init__(self, data, start: int = 0):
        self.data, self.pos = data, 8 * start

    def peek(self, n: int) -> int:
        q, r = divmod(self.pos, 8)
        chunk = int.from_bytes(self.data[q:q + (r + n + 7) // 8], "little")
        return (chunk >> r) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.pos += n

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v


class _BackwardBits:
    """Bits read from the end of `data` towards its start (RFC 8878 4.1.2): the
    last byte's highest set bit marks the end, and bits past the start read as
    zeros (`pos` then goes negative, which is how a stream's end is seen)."""

    def __init__(self, data):
        if not data or data[-1] == 0:
            raise ZstdError("bitstream has no end mark")
        self.data = data
        self.pos = 8 * (len(data) - 1) + _highbit(data[-1])

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        lo = self.pos - n
        self.pos = lo
        if lo >= 0:
            q, r = divmod(lo, 8)
            chunk = int.from_bytes(self.data[q:(lo + n + 7) // 8], "little")
            return (chunk >> r) & ((1 << n) - 1)
        hi = lo + n
        if hi <= 0:
            return 0
        chunk = int.from_bytes(self.data[:(hi + 7) // 8], "little") & ((1 << hi) - 1)
        return chunk << -lo


# ---------------------------------------------------------------------- FSE

def _read_fse_counts(data, start: int, max_symbol: int, max_log: int):
    """An FSE table description (RFC 8878 4.1.1): (normalised counts, accuracy
    log, bytes read)."""
    bits = _ForwardBits(data, start)
    log = bits.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} > {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description runs past the last symbol")
        mx = 2 * threshold - 1 - remaining
        v = bits.peek(nbits)
        if (v & (threshold - 1)) < mx:
            count = v & (threshold - 1)
            bits.skip(nbits - 1)
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bits.skip(nbits)
        count -= 1   # -1: a probability below one
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                rep = bits.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return counts, log, (bits.pos + 7) // 8 - start


def _fse_table(counts, log: int):
    """Decoding table of normalised `counts`: (symbol, bits, base) a state."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = list(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("corrupt FSE distribution")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbol[u]
        state = nxt[s]
        nxt[s] += 1
        nbits[u] = log - _highbit(state)
        base[u] = (state << nbits[u]) - size
    return symbol, nbits, base, log


def _rle_table(sym: int):
    return [sym], [0], [0], 0


_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
               -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1]
_PREDEFINED = {"ll": (_LL_DEFAULT, 6), "of": (_OF_DEFAULT, 5), "ml": (_ML_DEFAULT, 6)}
_PREDEFINED_TABLES: dict = {}
_MAX = {"ll": (35, 9), "of": (31, 8), "ml": (52, 9)}   # (max symbol, max accuracy log)

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


# ------------------------------------------------------------------ Huffman

def _huffman_weights(data, start: int):
    """The Huffman tree description at `start`: (weights of the listed symbols,
    bytes read). The last symbol's weight is implied (RFC 8878 4.2.1)."""
    head = data[start]
    if head >= 128:
        n = head - 127
        size = (n + 1) // 2
        raw = data[start + 1:start + 1 + size]
        if len(raw) != size:
            raise ZstdError("truncated Huffman weights")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], 1 + size
    body = data[start + 1:start + 1 + head]
    if len(body) != head:
        raise ZstdError("truncated Huffman weights")
    counts, log, used = _read_fse_counts(body, 0, 255, 6)
    symbol, nbits, base, _ = _fse_table(counts, log)
    bits = _BackwardBits(body[used:])
    s1, s2 = bits.read(log), bits.read(log)
    weights = []
    while True:   # two interleaved states; the stream's end gives the other state's last
        weights.append(symbol[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.pos < 0:
            weights.append(symbol[s2])
            break
        weights.append(symbol[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.pos < 0:
            weights.append(symbol[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return weights, 1 + head


def _huffman_table(weights):
    """(symbol a table index, bits a table index, max bits) from the weights,
    completed by the implied last one."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights are all zero")
    max_bits = _highbit(total) + 1
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights do not complete a tree")
    weights = list(weights) + [_highbit(rest) + 1]
    if max_bits > 11 or len(weights) > 256:
        raise ZstdError("corrupt Huffman table")
    sym = np.zeros(1 << max_bits, np.uint8)
    nb = np.zeros(1 << max_bits, np.uint8)
    pos = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                sym[pos:pos + n] = s
                nb[pos:pos + n] = max_bits + 1 - w
                pos += n
    return sym, nb, max_bits


def _huffman_stream(data, table, n_out: int) -> bytes:
    """One Huffman stream of `n_out` literals. The window of the next max_bits
    bits at every bit position is built with numpy, eight byte-aligned passes;
    its table entry gives the literal and the bits it takes, so the Python loop
    only follows positions."""
    sym_t, nb_t, m = table
    if n_out == 0:
        return b""
    if not data or data[-1] == 0:
        raise ZstdError("Huffman stream has no end mark")
    start = 8 * (len(data) - 1) + _highbit(data[-1])
    # v[q] holds the bytes q-2, q-1, q of the stream (zeros before it): bits 8q-16 .. 8q+7
    a = np.zeros(len(data) + 2, np.uint32)
    a[2:] = np.frombuffer(bytes(data), np.uint8)
    v = a[:-2] | (a[1:-1] << 8) | (a[2:] << 16)
    shifts = np.arange(16 - m, 24 - m, dtype=np.uint32)   # the m bits below position 8q + r
    window = ((v[:, None] >> shifts) & ((1 << m) - 1)).astype(np.uint16).ravel()
    lit = np.take(sym_t, window).tobytes()
    took = np.take(nb_t, window).tobytes()
    out = bytearray(n_out)
    p = start
    try:
        for i in range(n_out):
            out[i] = lit[p]
            p -= took[p]
    except IndexError:
        raise ZstdError("Huffman stream ends early") from None
    if p != 0:
        raise ZstdError(f"Huffman stream not consumed exactly ({p} bits off)")
    return bytes(out)


# ------------------------------------------------------------------- frames

class _FrameState:
    """What a frame's blocks hand on: the Huffman table, the three FSE tables
    and the repeat offsets."""

    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(block, st: _FrameState):
    """(literals, bytes read) of a compressed block's literals section."""
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):   # raw or RLE
        STATS["literals_raw" if kind == 0 else "literals_rle"] += 1
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (block[1] << 4), 2
        else:
            size, head = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if kind == 0:
            lits = bytes(block[head:head + size])
            if len(lits) != size:
                raise ZstdError("truncated raw literals")
            return lits, head + size
        return bytes([block[head]]) * size, head + 1
    head, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    value = int.from_bytes(block[:head], "little") >> 4
    regen = value & ((1 << bits) - 1)
    comp = value >> bits
    streams = 1 if fmt == 0 else 4
    body = block[head:head + comp]
    if len(body) != comp:
        raise ZstdError("truncated compressed literals")
    pos = 0
    if kind == 2:
        weights, pos = _huffman_weights(body, 0)
        st.huffman = _huffman_table(weights)
        STATS["literals_huffman"] += 1
    else:
        if st.huffman is None:
            raise ZstdError("treeless literals with no earlier Huffman table")
        STATS["literals_treeless"] += 1
    STATS[f"huffman_{streams}_streams"] += 1
    if streams == 1:
        return _huffman_stream(body[pos:], st.huffman, regen), head + comp
    s1, s2, s3 = struct.unpack_from("<3H", body, pos)
    pos += 6
    bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, comp]
    if bounds[3] > comp:
        raise ZstdError("corrupt literal jump table")
    part = (regen + 3) // 4
    sizes = [part, part, part, regen - 3 * part]
    if sizes[3] < 0:
        raise ZstdError("corrupt literal sizes")
    return b"".join(_huffman_stream(body[bounds[i]:bounds[i + 1]], st.huffman, sizes[i])
                    for i in range(4)), head + comp


def _sequences(block, pos: int, st: _FrameState):
    """The sequences section from `pos` to the block's end: a list of
    (literal length, offset, match length)."""
    b0 = block[pos]
    if b0 == 0:
        return []
    if b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        n, pos = ((b0 - 128) << 8) + block[pos + 1], pos + 2
    else:
        n, pos = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00, pos + 3
    modes = block[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        mode = (modes >> shift) & 3
        STATS[f"fse_{('predefined', 'rle', 'compressed', 'repeat')[mode]}"] += 1
        if mode == 0:
            if name not in _PREDEFINED_TABLES:
                _PREDEFINED_TABLES[name] = _fse_table(*_PREDEFINED[name])
            st.tables[name] = _PREDEFINED_TABLES[name]
        elif mode == 1:
            st.tables[name] = _rle_table(block[pos])
            pos += 1
        elif mode == 2:
            counts, log, used = _read_fse_counts(block, pos, *_MAX[name])
            st.tables[name] = _fse_table(counts, log)
            pos += used
        elif st.tables[name] is None:
            raise ZstdError(f"repeat mode with no earlier {name} table")
    (ll_sym, ll_nb, ll_base, ll_log), (of_sym, of_nb, of_base, of_log), \
        (ml_sym, ml_nb, ml_base, ml_log) = st.tables["ll"], st.tables["of"], st.tables["ml"]
    bits = _BackwardBits(block[pos:])
    read = bits.read
    sll, sof, sml = read(ll_log), read(of_log), read(ml_log)
    r1, r2, r3 = st.reps
    out = []
    for i in range(n):
        of_code, ml_code, ll_code = of_sym[sof], ml_sym[sml], ll_sym[sll]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ZstdError("corrupt sequence codes")
        ov = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if ov > 3:
            off = ov - 3
            r1, r2, r3 = off, r1, r2
        else:
            k = ov - 1 + (ll == 0)
            if k == 0:
                off = r1
            elif k == 1:
                off, r1, r2 = r2, r2, r1
            elif k == 2:
                off, r1, r2, r3 = r3, r3, r1, r2
            else:
                off = r1 - 1
                r1, r2, r3 = off, r1, r2
        out.append((ll, off, ml))
        if i + 1 < n:
            sll = ll_base[sll] + read(ll_nb[sll])
            sml = ml_base[sml] + read(ml_nb[sml])
            sof = of_base[sof] + read(of_nb[sof])
    if bits.pos != 0:
        raise ZstdError("sequence bitstream not consumed exactly")
    st.reps = [r1, r2, r3]
    return out


def _compressed_block(block, out: bytearray, st: _FrameState) -> None:
    lits, pos = _literals(block, st)
    lp = 0
    for ll, off, ml in _sequences(block, pos, st):
        if lp + ll > len(lits):
            raise ZstdError("sequence runs past the literals")
        out += lits[lp:lp + ll]
        lp += ll
        if off <= 0 or off > len(out):
            raise ZstdError(f"match offset {off} outside the window")
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:   # the match overlaps what it writes: a repeated pattern
            pattern = bytes(out[start:])
            out += (pattern * (ml // off + 1))[:ml]
    out += lits[lp:]


def _frame_header(data, pos: int):
    """(content size or None, checksum flag, bytes read) of the frame header
    after the magic; a dictionary is refused."""
    fhd = data[pos]
    fcs_flag, single, reserved, checksum, dict_flag = (
        fhd >> 6, (fhd >> 5) & 1, (fhd >> 3) & 1, (fhd >> 2) & 1, fhd & 3)
    if reserved:
        raise ZstdError("reserved bit set in the frame header")
    p = pos + 1
    window = None
    if not single:
        wd = data[p]
        exp, mant = wd >> 3, wd & 7
        window = (1 << (10 + exp)) + ((1 << (10 + exp)) >> 3) * mant
        p += 1
    dsize = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(data[p:p + dsize], "little")
    p += dsize
    if dict_id:
        raise ZstdError(f"frame uses dictionary {dict_id}; no dictionaries are known")
    fsize = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = None
    if fsize:
        content = int.from_bytes(data[p:p + fsize], "little") + (256 if fsize == 2 else 0)
        p += fsize
    if window is None:
        window = content
    return content, window, checksum, p - pos


def _one_frame(data, pos: int):
    """(content, position after the frame) of the frame at `pos`."""
    content_size, window, checksum, used = _frame_header(data, pos)
    pos += used
    block_max = min(window or MAX_BLOCK, MAX_BLOCK)
    out = bytearray()
    st = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            raise ZstdError("reserved block type")
        if size > block_max:
            raise ZstdError(f"block of {size} bytes > the frame's limit {block_max}")
        if kind == 0:
            STATS["block_raw"] += 1
            chunk = data[pos:pos + size]
            if len(chunk) != size:
                raise ZstdError("truncated raw block")
            out += chunk
            pos += size
        elif kind == 1:
            STATS["block_rle"] += 1
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            STATS["block_compressed"] += 1
            block = data[pos:pos + size]
            if len(block) != size:
                raise ZstdError("truncated compressed block")
            _compressed_block(block, out, st)
            pos += size
        if last:
            break
    if content_size is not None and len(out) != content_size:
        raise ZstdError(f"frame content {len(out)} bytes, its header says {content_size}")
    if checksum:
        STATS["checksum"] += 1
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(out) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return bytes(out), pos


def decompress(data) -> bytes:
    """The content of every frame in `data`, one after another."""
    data = memoryview(data).cast("B") if not isinstance(data, (bytes, bytearray)) else data
    parts, pos = [], 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == _SKIPPABLE:
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        try:
            part, pos = _one_frame(data, pos + 4)
        except (IndexError, struct.error):
            raise ZstdError("truncated or corrupt frame") from None
        parts.append(part)
    return b"".join(parts)


# ------------------------------------------------------------------- XXH64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of `data` (the frame content checksum keeps its low 32 bits)."""
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed
        v4 = (seed - _P1) & _M64
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data, 0)
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        p = (n // 32) * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, p)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (k,) = struct.unpack_from("<I", data, p)
        h = (_rotl(h ^ (k * _P1 & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)
