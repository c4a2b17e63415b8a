"""The one generator of requests: a traffic file's parameters and the run's
seed give the list of requests a window takes in order.

A request names a subject (an avatar or an identity), an expression, and the
camera of each of its `frames_per_request` frames, drawn on the traffic's
camera grid: `radius`, `elevation_deg` and `azimuth_deg` ranges, `focal` at
`size` x `size`. With `azimuth_step_deg` a request's frames turn about the
head from a drawn start at a drawn elevation (a turntable); without it each
frame's camera is drawn on its own. Every request has the same size, so
every seed gives the same work in another order."""
from __future__ import annotations

import numpy as np

from benchmark.common import draw_poses, intrinsics, pose_spherical, rng


def requests(traffic: dict, seed: int, n: int | None = None) -> list:
    g = rng(seed, 20)
    cam = traffic["camera"]
    n = n or traffic["requests"]
    frames = traffic.get("frames_per_request", 1)
    out = []
    for _ in range(n):
        subject = int(g.integers(0, traffic["subjects"]))
        expression = int(g.integers(0, traffic.get("expressions", 1)))
        if "azimuth_step_deg" in traffic:
            el = g.uniform(*cam["elevation_deg"])
            a0 = g.uniform(*cam["azimuth_deg"])
            poses = np.stack([pose_spherical(a0 + k * traffic["azimuth_step_deg"], el,
                                             cam["radius"]) for k in range(frames)])
        else:
            poses = draw_poses(g, cam, frames)
        out.append({"subject": subject, "expression": expression, "poses": poses})
    return out


def camera_K(traffic: dict) -> np.ndarray:
    s = traffic["size"]
    return intrinsics(s, s, traffic["camera"]["focal"])
