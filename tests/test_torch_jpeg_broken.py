"""Huffman-coded JPEGs whose scans break off before the next marker, read
by the port (mofanerf_tpu_torch/utils/jpeg.py::read_jpeg) as `imageio.v2.imread`
reads them (Pillow over libjpeg-turbo 3), byte for byte, or refused with a
ValueError exactly where imageio refuses.

libjpeg's rule: the bit reader that meets a marker supplies zero bits, the
MCU is finished from them, and the rest of the restart interval is left as
it stands (zero coefficients, or the earlier scans' bits in a progressive
file, which block smoothing then estimates with the progression status from
before the last scan); a lossless scan finishes its MCU row from zeros and
leaves the later rows of the interval at 2^(P - 1). A restart marker resets
the rule; a missing or out-of-order one is resolved by jdmarker.c's
jpeg_resync_to_restart.

The files are Pillow's (baseline, progressive, with restart markers every
block or row) and the lossless writer of tests/test_torch_image_formats.py,
with a stretch of one scan's entropy-coded data cut out: in the first, a
middle and the last scan, the cut scan then followed by its own next marker
(SOS or DHT), by EOI or by a DQT; restart markers dropped, swapped, shifted
or replaced; every cut and every flipped byte of one small file. The
committed fixtures G.jpg and canvas_restart_cut.jpg of
mofanerf_tpu_torch/testdata/formats/ are written by `broken_fixture_files`
(through tests/test_torch_image_formats.py's maker)."""
import io
import re
import struct

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from mofanerf_tpu_torch.utils.jpeg import read_jpeg
from tests.test_torch_image_formats import jpeg_file, scene


def scan_spans(data):
    """[(first byte, end)] of each scan's entropy-coded data: `end` is the
    position of the marker after it that is not RSTn."""
    out, pos = [], 2
    while pos + 4 <= len(data) and data[pos + 1] != 0xD9:
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if data[pos + 1] != 0xDA:
            pos += 2 + length
            continue
        start = end = pos + 2 + length
        while True:
            end = data.index(b"\xff", end)
            if data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
                end += 2
                continue
            break
        out.append((start, end))
        pos = end
    return out


def cut_scan(data, k, a, b):
    """`data` with the fraction [a, b) of scan k's entropy-coded bytes cut
    out (b = 1 keeps the marker that ends the scan)."""
    start, end = scan_spans(data)[k]
    n = end - start
    return data[:start + int(a * n)] + data[start + int(b * n):]


def pillow_jpeg(img, **kw):
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, format="JPEG", quality=90, **kw)
    return bio.getvalue()


def same_as_imageio(data):
    """Assert the port reads `data` as imageio does, or refuses it with a
    ValueError where imageio refuses it; "read" or "refused"."""
    try:
        ref = imageio.imread(io.BytesIO(data))
    except Exception:
        with pytest.raises(ValueError):
            read_jpeg(data)
        return "refused"
    got = read_jpeg(data)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    return "read"


_IMG = scene(96, 96, seed=1)
_FILES = {
    "baseline": pillow_jpeg(_IMG),
    "baseline_rst": pillow_jpeg(_IMG, restart_marker_blocks=1),
    "progressive": pillow_jpeg(_IMG, progressive=True),
    "progressive_rst": pillow_jpeg(_IMG, progressive=True, restart_marker_blocks=1),
    "baseline_420_rst_rows": pillow_jpeg(_IMG, subsampling=2, restart_marker_rows=1),
    "progressive_420_rst": pillow_jpeg(_IMG, progressive=True, subsampling=2,
                                       restart_marker_blocks=3),
}
_SCAN = {"first": 0, "middle": 5, "last": 9}   # Pillow's progressive script: ten scans


@pytest.mark.parametrize("cut", [(0.3, 0.6), (0.7, 0.9)], ids=["at30", "at70"])
@pytest.mark.parametrize("kind", ["baseline", "baseline_rst"] + [
    f"{f}:{s}" for f in ("progressive", "progressive_rst") for s in _SCAN])
def test_broken_scan_reads_as_imageio(kind, cut):
    """The kinds the port misread or refused: a baseline scan and the first,
    a middle and the last progressive scan, with and without restart markers,
    a middle stretch of the data cut out and the scan's marker kept. imageio
    reads every one."""
    name, _, which = kind.partition(":")
    data = cut_scan(_FILES[name], _SCAN.get(which, 0), *cut)
    assert same_as_imageio(data) == "read"


@pytest.mark.parametrize("name", ["baseline", "progressive", "progressive_rst",
                                  "progressive_420_rst"])
@pytest.mark.parametrize("follow", ["EOI", "next", "DQT"])
def test_broken_scan_then_each_marker(name, follow):
    """Every scan cut at two points and followed by EOI, by its own next
    marker (SOS, or the DHT before the next scan) or by a copy of the file's
    DQT (a DQT between scans; it changes nothing, the tables being latched
    at each component's first scan)."""
    data = _FILES[name]
    at = data.index(b"\xff\xdb")
    dqt = data[at:at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]]
    outcomes = set()
    for start, end in scan_spans(data):
        for a in (0.2, 0.6):
            j = start + int(a * (end - start))
            tail = {"EOI": b"\xff\xd9", "next": data[end:], "DQT": dqt + data[end:]}[follow]
            outcomes.add(same_as_imageio(data[:j] + tail))
    assert "read" in outcomes


@pytest.mark.parametrize("name", ["baseline_rst", "progressive_rst", "baseline_420_rst_rows",
                                  "progressive_420_rst"])
def test_restart_markers_dropped_swapped_or_replaced(name):
    """Restart markers dropped, two swapped, one shifted by 1-7 (libjpeg's
    resync: one or two ahead leaves the marker and its interval reads no
    data, one or two behind skips to the next marker, further is taken), one
    made a reserved marker (skipped) or a DHT (then read as one, which
    imageio refuses)."""
    data = _FILES[name]
    rsts = [m.start() for m in re.finditer(rb"\xff[\xd0-\xd7]", data)]
    outcomes = []
    for j in rsts[3::max(1, len(rsts) // 6)]:
        variants = [data[:j] + data[j + 2:]]
        for code in [0xD0 + ((data[j + 1] - 0xD0 + d) & 7) for d in range(1, 8)] + [0x05, 0xC4]:
            variants.append(data[:j + 1] + bytes([code]) + data[j + 2:])
        for v in variants:
            outcomes.append(same_as_imageio(v))
    for a, b in zip(rsts[2::len(rsts) // 4], rsts[6::len(rsts) // 4]):
        swapped = bytearray(data)
        swapped[a + 1], swapped[b + 1] = data[b + 1], data[a + 1]
        outcomes.append(same_as_imageio(bytes(swapped)))
    assert outcomes.count("read") > len(outcomes) // 2


def _lossless(n, restart, predictor):
    img = scene(40, 48, seed=2)
    planes = [img[..., 0]] if n == 1 else [img[..., i] for i in range(3)]
    rgb = {} if n == 1 else {"app": (("Adobe", 0),), "ids": [ord("R"), ord("G"), ord("B")]}
    return jpeg_file(planes, mode="lossless", predictor=predictor, restart=restart, **rgb)


@pytest.mark.parametrize("n", [1, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("restart", [0, 48, 96], ids=["no_rst", "rst_row", "rst_2rows"])
@pytest.mark.parametrize("predictor", [1, 4, 7])
def test_lossless_broken_scan(n, restart, predictor):
    """The lossless (SOF3) decoder under the same cuts: a stretch cut out at
    three points, and the data ended there with EOI. The MCU row that runs
    out is finished from zero bits; the later rows of its interval are
    2^(P - Pt - 1), their undifferencer reset. (A cut between a 0xFF and its
    stuffed 0x00 can leave a marker that both refuse.)"""
    data = _lossless(n, restart, predictor)
    assert same_as_imageio(data) == "read"
    (start, end), = scan_spans(data)
    outcomes = []
    for a in (0.1, 0.45, 0.8):
        outcomes.append(same_as_imageio(cut_scan(data, 0, a, a + 0.07)))
        outcomes.append(same_as_imageio(data[:start + int(a * (end - start))] + b"\xff\xd9"))
    assert outcomes.count("read") >= 4


def test_refusals_where_imageio_refuses():
    """A file that ends inside a scan (imageio: "image file is truncated"), a
    short DQT between scans (libjpeg-turbo 3 refuses it) and a progressive
    scan whose Huffman table is missing are refused; a baseline file without
    its Huffman tables is read with the standard ones (jstdhuff.c), as
    imageio reads it."""
    prog, base = _FILES["progressive_rst"], _FILES["baseline"]
    start, end = scan_spans(prog)[4]
    assert same_as_imageio(prog[:(start + end) // 2]) == "refused"
    short_dqt = b"\xff\xdb\x00\x08\x01\x01\x00\x01\x05\x02"
    assert same_as_imageio(prog[:end] + short_dqt + prog[end:]) == "refused"
    dht = [m.start() for m in re.finditer(rb"\xff\xc4", prog)]
    skip = 2 + struct.unpack(">H", prog[dht[0] + 2:dht[0] + 4])[0]
    assert same_as_imageio(prog[:dht[0]] + prog[dht[0] + skip:]) == "refused"
    without = base
    while b"\xff\xc4" in without:
        at = without.index(b"\xff\xc4")
        without = without[:at] + without[at + 2 + struct.unpack(">H", without[at + 2:at + 4])[0]:]
    assert same_as_imageio(without) == "read"


def test_every_cut_and_flipped_byte_of_one_file():
    """A 16 x 24 progressive 4:2:0 file with a restart marker every block: cut
    after every byte, and every byte flipped (XOR 0xFF): the port reads what
    imageio reads, equal, and refuses what it refuses, with a ValueError and
    no other exception."""
    data = pillow_jpeg(scene(16, 24, seed=5), progressive=True, subsampling=2,
                       restart_marker_blocks=1)
    outcomes = []
    for n in range(2, len(data)):
        outcomes.append(same_as_imageio(data[:n]))
    for i in range(len(data)):
        flipped = bytearray(data)
        flipped[i] ^= 0xFF
        outcomes.append(same_as_imageio(bytes(flipped)))
    assert 0 < outcomes.count("read") < len(outcomes)


def broken_fixture_files(canvas, d_jpg):
    """The committed broken-scan files, by name: G.jpg (the wild photo D.jpg
    with a middle stretch of its sixth scan, the first luma AC refinement's
    data, cut out: its last rows keep the earlier scans' bits and are smoothed
    with the status from before that scan) and canvas_restart_cut.jpg (D's
    canvas as baseline 4:2:0 with a restart marker every MCU row, a stretch
    across three restart intervals cut out and a later marker shifted one
    ahead)."""
    base = pillow_jpeg(canvas, subsampling=2, restart_marker_rows=1)
    start, end = scan_spans(base)[0]
    cut = base[:start + (end - start) // 3] + base[start + (end - start) * 2 // 5:]
    rsts = [m.start() for m in re.finditer(rb"\xff[\xd0-\xd7]", cut)]
    j = rsts[len(rsts) * 3 // 4]
    cut = cut[:j + 1] + bytes([0xD0 + ((cut[j + 1] - 0xD0 + 1) & 7)]) + cut[j + 2:]
    return {"G.jpg": cut_scan(d_jpg, 5, 0.5, 0.6), "canvas_restart_cut.jpg": cut}
