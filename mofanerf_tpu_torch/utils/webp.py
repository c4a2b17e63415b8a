"""WebP files without Pillow: the port's counterpart of what `imageio.v2.imread`
returns for a WebP (Pillow's `WebPImageFile` over libwebp 1.6's
`WebPAnimDecoder`, frame 0).

- `read_webp(data)` -> uint8 [H, W, 4] when the file has alpha, else
  [H, W, 3]. Pillow's rule, from libwebp's `WebPGetFeatures`: the `VP8X`
  alpha flag, overridden by a `VP8L` header's `alpha_is_used` hint, or-ed
  with the presence of an `ALPH` chunk. The pixels come from the frame the
  demuxer keeps: a `VP8X` file's `ALPH` is dropped when its alpha flag is
  clear (alpha 255 then).
- `webp_size(data)` -> (H, W) from the headers alone (the `VP8X` canvas, else
  the bitstream's own size).

The RIFF container as libwebp's demuxer reads it: `VP8 ` / `VP8L` alone, or
`VP8X` with its flags and canvas; `ALPH`; `ANIM` / `ANMF` (the first frame,
at its offset, on a transparent black canvas: `WebPAnimDecoder` builds frame
0 without blending or disposal); `ICCP`, `EXIF`, `XMP ` and unknown chunks
skipped, but for the TIFF header of the EXIF block, which imageio's metadata
reading parses and refuses when it is not one; odd sizes padded. A file
shorter than its RIFF size, a chunk that runs past it, a second image,
misplaced chunks and bad bitstreams raise ValueError, as Pillow refuses
them. The bitstreams: `vp8.py` (lossy, its alpha plane) and `vp8l.py`
(lossless).
"""
from __future__ import annotations

import numpy as np

from . import vp8, vp8l

MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
ALPHA_FLAG, ANIMATION_FLAG, EXIF_FLAG = 0x10, 0x02, 0x08
VALID_FLAGS = 0x3E                  # alpha, animation, ICC, EXIF, XMP
# TIFF headers Pillow accepts in an EXIF block (imageio parses it as metadata)
TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a")
_IMAGE = (b"VP8 ", b"VP8L")


def is_webp(data: bytes) -> bool:
    """Pillow's test of a WebP file: RIFF, WEBP and a known first chunk."""
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in (b"VP8 ", b"VP8L",
                                                                             b"VP8X")


def _le(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _bitstream_features(tag: bytes, payload: bytes, size: int):
    """(width, height, has alpha) of a VP8 / VP8L chunk (libwebp's
    VP8GetInfo / VP8LGetInfo checks), size its chunk's size field."""
    if tag == b"VP8 ":
        if len(payload) < 10:
            raise ValueError("VP8 chunk shorter than its frame header")
        h, w = vp8.vp8_size(payload)
        if (_le(payload[:3]) >> 5) >= size:
            raise ValueError("VP8 first partition as long as its chunk")
        return w, h, 0
    h, w, alpha = vp8l.vp8l_size(payload)
    return w, h, alpha


def _features(data: bytes) -> bool:
    """libwebp's WebPGetFeatures(...).has_alpha on the whole file, as Pillow
    asks it; a file it refuses keeps Pillow's default, RGBA."""
    riff = _le(data[4:8])
    if riff < 12 or riff > MAX_CHUNK_PAYLOAD:
        return True
    pos, end = 12, len(data)
    has_alpha = vp8x = False
    canvas = None
    if data[pos:pos + 4] == b"VP8X":
        if _le(data[pos + 4:pos + 8]) != 10 or end - pos < 18:
            return True
        flags = data[pos + 8]
        canvas = (1 + _le(data[pos + 12:pos + 15]), 1 + _le(data[pos + 15:pos + 18]))
        if canvas[0] * canvas[1] >= MAX_IMAGE_AREA:
            return True
        has_alpha, vp8x = bool(flags & ALPHA_FLAG), True
        if flags & ANIMATION_FLAG:
            return has_alpha
        pos += 18
    alpha_chunk = False
    if vp8x:                                     # optional chunks up to the image
        total = 22
        while True:
            if end - pos < 8:                  # not enough data: the VP8X answer stands
                return has_alpha or alpha_chunk
            size = _le(data[pos + 4:pos + 8])
            if size > MAX_CHUNK_PAYLOAD:
                return True
            disk = (8 + size + 1) & ~1
            total += disk
            if total > riff:
                return True
            if data[pos:pos + 4] in _IMAGE:
                break
            if end - pos < disk:
                return has_alpha or alpha_chunk
            alpha_chunk |= data[pos:pos + 4] == b"ALPH"
            pos += disk
    tag = data[pos:pos + 4]
    if end - pos < 8:
        return has_alpha or alpha_chunk if vp8x else True
    size = _le(data[pos + 4:pos + 8])
    if tag in _IMAGE:
        if riff >= 12 and size > riff - 12:
            return True
        payload = data[pos + 8:]
    else:
        return True                              # a raw bitstream after RIFF is not read here
    if len(payload) < (10 if tag == b"VP8 " else 5):
        return has_alpha or alpha_chunk if vp8x else True
    try:
        w, h, alpha = _bitstream_features(tag, payload, size)
    except ValueError:
        return True
    if tag == b"VP8L":
        has_alpha = bool(alpha)
    if canvas is not None and canvas != (w, h):
        return True
    return has_alpha or alpha_chunk


class _Frame:
    def __init__(self):
        self.x = self.y = 0
        self.width = self.height = 0
        self.alpha = None            # (offset, size) of the ALPH chunk, header included
        self.image = None            # (offset, size) of the VP8 / VP8L chunk
        self.complete = False


def _store_frame(data: bytes, pos: int, end: int, frame: _Frame, min_size: int = 0) -> int:
    """libwebp's demux StoreFrame: an ALPH and an image chunk from pos ->
    where it stopped."""
    if end - pos < 8 or end - pos < min_size:
        raise ValueError("WebP frame truncated")
    while True:
        start = pos
        tag, size = data[pos:pos + 4], _le(data[pos + 4:pos + 8])
        pos += 8
        if size > MAX_CHUNK_PAYLOAD:
            raise ValueError("WebP chunk size out of range")
        padded = size + (size & 1)
        if padded > end - pos:
            raise ValueError(f"WebP {tag!r} chunk runs past the file")
        if tag == b"ALPH" and frame.alpha is None:
            frame.alpha = (start, 8 + padded)
        elif tag in _IMAGE and frame.image is None:
            if tag == b"VP8L" and frame.alpha is not None:
                raise ValueError("WebP VP8L image after an ALPH chunk")
            w, h, alpha = _bitstream_features(tag, data[start + 8:start + 8 + padded], size)
            frame.image = (start, 8 + padded)
            frame.width, frame.height = w, h
            frame.complete = True
        else:                                    # the frame ends before this chunk
            return start
        pos += padded
        if pos == end:
            return pos
        if end - pos < 8:
            raise ValueError("WebP chunk header truncated")


def _demux(data: bytes):
    """libwebp's WebPDemux on a whole file -> (canvas width, canvas height,
    the first frame, the payload of the first EXIF chunk the VP8X flags
    announce, or None)."""
    if len(data) < 20:
        raise ValueError("WebP file truncated")
    riff = _le(data[4:8])
    if riff < 8 or riff > MAX_CHUNK_PAYLOAD:
        raise ValueError("WebP RIFF size out of range")
    end = riff + 8
    if len(data) < end:
        raise ValueError("WebP file shorter than its RIFF size")
    pos = 12
    tag = data[pos:pos + 4]
    if tag in _IMAGE:                            # a simple file: one image chunk
        frame = _Frame()
        if end - pos < 8:
            raise ValueError("WebP image chunk truncated")
        _store_frame(data, pos, end, frame)
        frame.alpha = None                       # no VP8X: no alpha flag
        if not frame.complete:
            raise ValueError("WebP file without an image")
        return frame.width, frame.height, frame, None
    if tag != b"VP8X":
        raise ValueError(f"WebP file starting with a {tag!r} chunk")
    size = _le(data[pos + 4:pos + 8])
    if size > MAX_CHUNK_PAYLOAD or size < 10:
        raise ValueError("VP8X chunk size out of range")
    size += size & 1
    if size > end - pos - 8:
        raise ValueError("VP8X chunk runs past the file")
    flags = data[pos + 8]
    cw, ch = 1 + _le(data[pos + 12:pos + 15]), 1 + _le(data[pos + 15:pos + 18])
    if cw * ch >= MAX_IMAGE_AREA:
        raise ValueError("VP8X canvas too large")
    pos += 8 + size
    if end - pos < 8:
        raise ValueError("WebP file without an image")
    animated = bool(flags & ANIMATION_FLAG)
    frames, anim, exif = [], 0, None
    while True:
        start = pos
        tag, size = data[pos:pos + 4], _le(data[pos + 4:pos + 8])
        if size > MAX_CHUNK_PAYLOAD:
            raise ValueError("WebP chunk size out of range")
        padded = size + (size & 1)
        if padded > end - pos - 8:
            raise ValueError(f"WebP {tag!r} chunk runs past the file")
        if tag == b"VP8X":
            raise ValueError("WebP file with a second VP8X chunk")
        if tag in (b"ALPH",) + _IMAGE:
            if anim or animated or frames:
                raise ValueError("WebP still image in an animation, or a second image")
            frame = _Frame()
            pos = _store_frame(data, pos, end, frame)
            if not flags & ALPHA_FLAG:
                frame.alpha = None               # the demuxer drops alpha without the flag
            frames.append(frame)
        elif tag == b"ANIM":
            if padded < 6:
                raise ValueError("ANIM chunk too short")
            anim += 1
            pos += 8 + padded
        elif tag == b"ANMF":
            if not anim:
                raise ValueError("ANMF chunk before the ANIM chunk")
            if padded < 16:
                raise ValueError("ANMF chunk too short")
            frame = _Frame()
            body = pos + 8
            frame.x, frame.y = 2 * _le(data[body:body + 3]), 2 * _le(data[body + 3:body + 6])
            fw, fh = 1 + _le(data[body + 6:body + 9]), 1 + _le(data[body + 9:body + 12])
            if fw * fh >= MAX_IMAGE_AREA:
                raise ValueError("ANMF frame too large")
            after = _store_frame(data, body + 16, end, frame, padded - 16)
            if after - (body + 16) > padded - 16:
                raise ValueError("ANMF frame's chunks run past it")
            pos = after
            if animated and (frame.alpha or frame.image):
                if frames and not frames[-1].complete:
                    raise ValueError("WebP frame after an incomplete one")
                frames.append(frame)
        else:                                    # ICCP, EXIF, XMP and unknown chunks
            if tag == b"EXIF" and flags & EXIF_FLAG and exif is None:
                exif = data[pos + 8:pos + 8 + size]
            pos += 8 + padded
        if pos == end:
            break
        if end - pos < 8:
            raise ValueError("WebP chunk header truncated")
    if flags & ~VALID_FLAGS or not frames:
        raise ValueError("WebP VP8X flags invalid, or no frame")
    for f in frames:
        if not f.complete or (f.alpha and f.alpha[0] > f.image[0]):
            raise ValueError("WebP frame without an image, or its alpha after it")
        if not animated and (f.x or f.y or (f.width, f.height) != (cw, ch)):
            raise ValueError("WebP image differs from its VP8X canvas")
        if f.x + f.width > cw or f.y + f.height > ch:
            raise ValueError("WebP frame runs past its canvas")
    return cw, ch, frames[0], exif


def _decode_frame(data: bytes, frame: _Frame) -> np.ndarray:
    """WebPDecode on the frame's chunks (ALPH, then VP8 / VP8L) -> RGBA."""
    start, size = frame.image
    tag = data[start:start + 4]
    payload = data[start + 8:start + size]      # the bitstream runs to the frame's end
    if tag == b"VP8L":
        rgba, _ = vp8l.read_vp8l(payload)
        return rgba
    alpha = None
    if frame.alpha is not None:
        a0 = frame.alpha[0]
        alpha = data[a0 + 8:a0 + 8 + _le(data[a0 + 4:a0 + 8])]
    return vp8.read_vp8(payload, alpha)


def read_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> what `imageio.v2.imread` returns: uint8 [H, W, 4] with
    alpha, else [H, W, 3] (see the module's docstring)."""
    if not is_webp(data):
        raise ValueError("not a WebP file")
    has_alpha = _features(data)
    cw, ch, frame, exif = _demux(data)
    while exif and exif.startswith(b"Exif\x00\x00"):
        exif = exif[6:]
    if exif and (len(exif) < 8 or not exif.startswith(TIFF_PREFIXES)):
        # imageio reads the EXIF block through Pillow, which refuses this header
        raise ValueError(f"WebP EXIF block without a TIFF header: {exif[:8]!r}")
    img = _decode_frame(data, frame)
    canvas = np.zeros((ch, cw, 4), np.uint8)
    canvas[frame.y:frame.y + frame.height, frame.x:frame.x + frame.width] = img
    return canvas if has_alpha else np.ascontiguousarray(canvas[..., :3])


def webp_size(data: bytes) -> tuple:
    """(H, W) of a WebP file from its headers: the VP8X canvas, else the
    VP8 / VP8L frame header."""
    if not is_webp(data):
        raise ValueError("not a WebP file")
    tag = data[12:16]
    if tag == b"VP8X":
        if len(data) < 30:
            raise ValueError("VP8X chunk truncated")
        return 1 + _le(data[27:30]), 1 + _le(data[24:27])
    if tag == b"VP8 ":
        return vp8.vp8_size(data[20:30])
    return vp8l.vp8l_size(data[20:25])[:2]
