"""Pieces every runner shares: seeds, cameras, weights made on the device
from the seed, and the sample of answers kept for the comparison."""
from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *path: int, bits: int = 62) -> int:
    """A seed of `bits` bits for the stream `path` of the run's `--seed`
    (any whole number, however large)."""
    state = np.random.SeedSequence([seed % (1 << 128), *path]).generate_state(2, np.uint64)
    return int((int(state[0]) << 64 | int(state[1])) % (1 << bits))


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *path))


def device_generator(seed: int, *path: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *path))


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Camera-to-world [4, 4] on a sphere about the head: (0, 0, radius) is
    the frontal camera looking down -z; theta turns about y, phi about x."""
    t = np.eye(4, dtype=np.float64)
    t[2, 3] = radius
    p = math.radians(phi_deg)
    rot_phi = np.array([[1, 0, 0, 0], [0, math.cos(p), -math.sin(p), 0],
                        [0, math.sin(p), math.cos(p), 0], [0, 0, 0, 1]])
    th = math.radians(theta_deg)
    rot_theta = np.array([[math.cos(th), 0, -math.sin(th), 0], [0, 1, 0, 0],
                          [math.sin(th), 0, math.cos(th), 0], [0, 0, 0, 1]])
    return (rot_theta @ rot_phi @ t).astype(np.float32)


def intrinsics(H: int, W: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)


def draw_poses(g: np.random.Generator, camera: dict, n: int) -> np.ndarray:
    """n camera-to-world matrices drawn uniformly on the camera grid."""
    el = g.uniform(*camera["elevation_deg"], n)
    az = g.uniform(*camera["azimuth_deg"], n)
    return np.stack([pose_spherical(a, e, camera["radius"]) for a, e in zip(az, el)])


# --- weights made on the device -------------------------------------------------

ALIGN = 64   # f32 elements: leaves start 256 bytes apart

def _is_shape(tree) -> bool:
    return isinstance(tree, tuple) and all(isinstance(x, int) for x in tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif not _is_shape(tree):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tuple(tree)


def _rebuild(tree, values, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}/{k}") for k, v in tree.items()}
    if not _is_shape(tree):
        return [_rebuild(v, values, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return values[prefix]


def init_uniform(shapes, rule, generator: torch.Generator, device, centred=()) -> dict:
    """Fill a tree of shapes in a few large calls on the device: one draw of
    U(0, 1) for every element, then `a * u + c` with each leaf's (a, c) from
    `rule(path, shape)`. Returns the tree of tensors: views of one buffer,
    each starting on a 256-byte boundary (the field kernel reads some
    operands as they are passed, with 16-byte loads). Weights [in, out] whose
    path ends with one of `centred` have their mean over `in` taken out."""
    leaves = list(_leaves(shapes))
    sizes = [math.prod(s) for _, s in leaves]
    spans = [-(-n // ALIGN) * ALIGN for n in sizes]
    ac = torch.tensor([rule(p, s) for p, s in leaves], dtype=torch.float32)
    counts = torch.tensor(spans)
    a = torch.repeat_interleave(ac[:, 0], counts).to(device)
    c = torch.repeat_interleave(ac[:, 1], counts).to(device)
    flat = torch.rand(sum(spans), generator=generator, device=device).mul_(a).add_(c)
    out, at = {}, 0
    for (p, s), n, span in zip(leaves, sizes, spans):
        out[p] = flat[at:at + n].view(s)
        if p.endswith(centred):
            out[p].sub_(out[p].mean(0, keepdim=True))
        at += span
    return _rebuild(shapes, out)


HEADS = ("/alpha/w", "/alpha/b", "/sigma/w", "/sigma/b", "/rgb/w", "/rgb/b")
HEAD_WEIGHTS = tuple(h for h in HEADS if h.endswith("/w"))


def he_rule(path: str, shape) -> tuple:
    """Uniform init with the variance of He's rule: a weight [in, out] (or a
    convolution's [out, in, kh, kw] under `tex_encoder`) of fan-in f draws from
    U(-b, b) with b = sqrt(6 / f); a bias from U(-1/sqrt(f), 1/sqrt(f)) with f
    its layer's width, zero in the texture encoder; the expression bank
    U(0, 1). The output heads draw their weights at a fraction of He's
    spread, to be centred (HEAD_WEIGHTS): the colour heads (`rgb`) at a fifth,
    the density heads (the teacher's `alpha`, the student's `sigma`) at a
    fiftieth with a bias from U(0.2, 0.6). The field is then a translucent
    medium whose every sample adds to a ray's colour, with colours inside the
    sigmoid's slope. (With He's spread the heads' outputs share one large
    offset a seed, from the mean of their ReLU inputs: the density of every
    point of some seeds is negative, their frames come out empty, and the
    colours sit at 0 or 1.)"""
    name = path.rsplit("/", 1)[-1]
    if path.endswith("exp_codes"):
        return (1.0, 0.0)
    if "tex_encoder" in path:
        if name.endswith("bias"):
            return (0.0, 0.0)
        fan_in = math.prod(shape[1:])
        b = math.sqrt(3.0 / fan_in)
        return (2 * b, -b)
    if path.endswith(("/alpha/b", "/sigma/b")):
        return (0.4, 0.2)
    if path.endswith(HEAD_WEIGHTS):
        spread = 0.2 if path.endswith("/rgb/w") else 0.02
        b = spread * math.sqrt(6.0 / shape[-2])
        return (2 * b, -b)
    if len(shape) == 1:           # a bias: its layer's width stands for its fan-in
        b = 1.0 / math.sqrt(shape[0])
        return (2 * b, -b)
    b = math.sqrt(6.0 / shape[-2])
    return (2 * b, -b)


class Reservoir:
    """A uniform sample of at most k of the items offered, drawn from its own
    generator: which answers of a window the comparison reads."""

    def __init__(self, k: int, g: np.random.Generator):
        self.k, self.g, self.items, self.seen = k, g, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.g.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item
