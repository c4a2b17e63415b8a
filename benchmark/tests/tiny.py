"""Cells of the benchmark at a size the CPU runs in seconds: the committed
configuration and traffic files with their sizes cut."""
from __future__ import annotations

import json

from benchmark import harness

TEACHER = dict(netdepth=6, netwidth=32, netdepth_fine=6, netwidth_fine=64, N_samples=8,
               N_importance=8, N_rand=32, uv_size=128, packet_size=256)
STUDENT = dict(depth=2, width=32, multires=4)
CAMERA = {"size": 32, "camera": {"radius": 16.0, "elevation_deg": [-30.0, 45.0],
                                  "azimuth_deg": [-90.0, 90.0], "focal": 60.0}}
TRAFFIC = {
    "train-device-data": dict(identities=2, expressions=2, views=2, scan_steps=3,
                              check_chunks=[1, 2, 1], trace_steps=2, first_step=600),
    "viewer-frames": dict(requests=64, packet_size=256, check_rays=64, warmup_requests=1),
    "turntable-paths": dict(requests=8, frames_per_request=4, azimuth_step_deg=90.0,
                            packet_size=256, check_rays=64),
    "teacher-views": dict(requests=8, frames_per_request=2, check_rays=16, subjects=2),
}


def tiny_cell(name: str) -> dict:
    c = harness.cell(harness.load_benchmark(), name)
    size = TEACHER if "netwidth" in c["config"] else STUDENT
    c["config"] = dict(c["config"], **size)
    c["traffic"] = json.loads(json.dumps(c["traffic"]))
    c["traffic"].update(CAMERA, **TRAFFIC[c["workload"]["traffic"]])
    return c
