"""Face matting: convex-hull landmark mask.

Parity with tools/wild_fit_base.py:346-420 (`get_image_hull_mask` +
`merge_add_mask`): the face region is the filled convex hull of the 68
landmarks; everything outside is zeroed. The port of
mofanerf_tpu/preprocess/matting.py without OpenCV: `convex_hull` and
`fill_convex_poly` are `cv2.convexHull` and `cv2.fillConvexPoly(mask, hull,
1)` (8-connected outline, shift 0) on integer points, pixel for pixel.
"""
from __future__ import annotations

import numpy as np

_XY_SHIFT = 16   # cv2's fixed point for polygon edges: 16.16


def convex_hull(points: np.ndarray) -> np.ndarray:
    """[K, 2] integer (x, y) vertices of the convex hull of `points`, without
    repeated or collinear vertices (Andrew's monotone chain)."""
    pts = sorted(set(map(tuple, np.asarray(points, np.int64).reshape(-1, 2).tolist())))
    if len(pts) <= 2:
        return np.asarray(pts, np.int64).reshape(-1, 2)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    chains = []
    for seq in (pts, pts[::-1]):
        chain = []
        for q in seq:
            while len(chain) >= 2 and cross(chain[-2], chain[-1], q) <= 0:
                chain.pop()
            chain.append(q)
        chains.append(chain[:-1])
    return np.asarray(chains[0] + chains[1], np.int64)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine: the segment cut to the image, or None when it misses."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _line8(mask: np.ndarray, p1, p2, value: int) -> None:
    """cv2's 8-connected line (its LineIterator, left to right)."""
    h, w = mask.shape[:2]
    x1, y1 = p1
    x2, y2 = p2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy, sx, sy = x2 - x1, y2 - y1, 1, 1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    if dy < 0:
        dy, sy = -dy, -1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x1, y1
    for _ in range(dx + 1):
        mask[y, x] = value
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if steep:
            y += sy
            x += sx if minor else 0
        else:
            x += sx
            y += sy if minor else 0


def fill_convex_poly(mask: np.ndarray, vertices: np.ndarray, value: int = 1) -> None:
    """`cv2.fillConvexPoly(mask, vertices, value)` on integer (x, y) vertices,
    in place: the outline drawn as 8-connected lines, then the rows between
    the two edge walks from the topmost vertex, whose x steps in 16.16 fixed
    point with rounded slopes, each row filled between its rounded ends
    inclusive."""
    v = [(int(p[0]), int(p[1])) for p in np.asarray(vertices).reshape(-1, 2)]
    n = len(v)
    if n == 0:
        return
    h, w = mask.shape[:2]
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    prev = v[-1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line8(mask, prev, p, value)
        prev = p
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    one, half = 1 << _XY_SHIFT, 1 << (_XY_SHIFT - 1)
    idx, step = [imin, imin], [1, n - 1]
    ex, edx, eye = [-one, -one], [0, 0], [ymin, ymin]
    edges, y = n, ymin
    while True:
        for i in range(2):
            if y < eye[i]:
                continue
            i0 = idx[i]
            i1 = (i0 + step[i]) % n
            while True:
                edges -= 1           # cv2's `edges-- > 0`
                if edges < 0:
                    break
                ty = v[i1][1]
                if ty > y:
                    xs, xe = v[i0][0] << _XY_SHIFT, v[i1][0] << _XY_SHIFT
                    num, den = (xe - xs) * 2 + (ty - y), 2 * (ty - y)
                    eye[i], ex[i], idx[i] = ty, xs, i1
                    edx[i] = -(-num // den) if num < 0 else num // den   # C's division
                    break
                i0, i1 = i1, (i1 + step[i]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            xx1, xx2 = (ex[left] + half) >> _XY_SHIFT, (ex[right] + half) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                mask[y, max(xx1, 0):min(xx2, w - 1) + 1] = value
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def hull_mask(shape_hw, kp_xy: np.ndarray) -> np.ndarray:
    """[H, W] uint8 mask = filled convex hull of landmarks ((x, y) order),
    the landmarks truncated to int32 as cv2 takes them."""
    mask = np.zeros(shape_hw[:2], np.uint8)
    fill_convex_poly(mask, convex_hull(np.asarray(kp_xy).astype(np.int32)), 1)
    return mask


def apply_mask(img, mask):
    """img * mask, on numpy arrays or tensors alike."""
    return img * mask[..., None].astype(img.dtype) if isinstance(img, np.ndarray) \
        else img * mask[..., None].to(img.dtype)
