"""Serving a distilled student: a closed loop with one client whose requests
are frames (`render/serve.py::render_frame_serve`) or camera paths
(`render_path_serve`: one stream of packets over all the path's rays,
compaction pooled), of one of the traffic's avatars, each packed once at
set-up (`ops/serve_kernel.py::pack_student`). A unit of the window is one
request, timed from the call to the card's end of it.

The comparison draws pixels of the window's requests from the seed and
renders their rays through the reference student in f32."""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.common import HEAD_WEIGHTS, Reservoir, device_generator, he_rule, init_uniform, rng
from benchmark.runners.teacher_model import sync
from benchmark.runners.teacher_frames import pixel_gaps
from benchmark.reference import student as ref_student
from benchmark.reference.precision import Precision, full_f32
from benchmark.traffic import camera_K, requests
from mofanerf_tpu_torch.models.student import StudentConfig, student_param_shapes
from mofanerf_tpu_torch.ops.serve_kernel import pack_student
from mofanerf_tpu_torch.render.serve import render_frame_serve, render_path_serve

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def student_config(cfg: dict) -> StudentConfig:
    return StudentConfig(depth=cfg["depth"], width=cfg["width"], skip=cfg["skip"],
                         multires=cfg["multires"], multires_views=cfg["multires_views"],
                         cond_dim=cfg["cond_dim"], compute_dtype=DTYPES[cfg["compute_dtype"]])


class Runner:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: str):
        self.cfg, self.traffic, self.dev = cfg, traffic, torch.device(device)
        self.scfg = student_config(cfg)
        self.marks = []
        shapes = {"avatars": [student_param_shapes(self.scfg)] * traffic["subjects"]}
        self.avatars = init_uniform(shapes, he_rule, device_generator(seed, 40, device=self.dev),
                                    self.dev, HEAD_WEIGHTS)["avatars"]
        self.marks.append(("weights", time.perf_counter()))
        self.packs = [pack_student(p, self.scfg) for p in self.avatars]
        self.marks.append(("packs", time.perf_counter()))
        self.requests = requests(traffic, seed)
        self.K = camera_K(traffic)
        self.size = traffic["size"]
        self.path = traffic["entry"] == "render_path_serve"
        self.seed, self.g_check = seed, rng(seed, 42)
        self.begin()
        for _ in range(traffic["warmup_requests"]):
            self.unit()
        self.sync()
        self.begin()

    def begin(self) -> None:
        self.next, self.latency_s, self.host_s, self.served = 0, [], [], []
        self.kept = Reservoir(self.traffic["check_requests"], rng(self.seed, 41))

    def unit(self, tracing: bool = False) -> None:
        r = self.requests[self.next % len(self.requests)]
        self.next += 1
        c, t = self.cfg, self.traffic
        kw = dict(near=c["near"], far=c["far"], n_samples=c["n_samples"],
                  aabb_min=tuple(c["aabb_min"]), aabb_max=tuple(c["aabb_max"]),
                  white_bkgd=c["white_bkgd"], packet_size=t["packet_size"])
        pack = self.packs[r["subject"]]
        t0 = time.perf_counter()
        if self.path:
            out = render_path_serve(pack, self.scfg, None, r["poses"], self.size, self.size,
                                    self.K, **kw)
        else:
            out = render_frame_serve(pack, self.scfg, None, self.size, self.size, self.K,
                                     r["poses"][0][:3], **kw)
        t1 = time.perf_counter()
        self.sync()
        self.latency_s.append(time.perf_counter() - t0)
        self.host_s.append(t1 - t0)
        self.served.append(r)
        rgb = out["rgb"].reshape(-1, self.size, self.size, 3)
        self.kept.offer((r, rgb))

    def sync(self) -> None:
        sync(self.dev)

    def frames(self) -> int:
        return sum(len(r["poses"]) for r in self.served)

    def end_to_end(self, seconds: float) -> dict:
        out = {"serve_frames_per_s": self.frames() / seconds}
        if not self.path:
            out["serve_frame_p95_ms"] = float(np.percentile(self.latency_s, 95)) * 1e3
        return out

    def layer_info(self) -> dict:
        """Counts of the window's requests: their rays and, by the reference's
        slab test, the rays that hit the head's box."""
        K = torch.from_numpy(self.K).to(self.dev)
        n_hit = 0
        for r in self.served:
            for pose in r["poses"]:
                ro, rd = frame_rays(K, torch.from_numpy(pose).to(self.dev), self.size)
                n_hit += int(ref_student.box_interval(ro, rd, self.cfg["aabb_min"],
                                                      self.cfg["aabb_max"], self.cfg["near"],
                                                      self.cfg["far"])[2].sum())
        c = self.cfg
        return {"requests": len(self.served), "frames": self.frames(),
                "rays": self.frames() * self.size ** 2, "hit_rays": n_hit,
                "host_s": list(self.host_s), "student": (c["depth"], c["width"], c["multires"]),
                "n_samples": c["n_samples"]}

    # --- the comparison --------------------------------------------------------------

    def collect(self) -> dict:
        n = self.traffic["check_rays"]
        items = self.kept.items
        frames = [(r, rgb[f], f) for r, rgb in items for f in range(rgb.shape[0])]
        pick = self.g_check.choice(len(frames), min(len(frames), self.traffic["check_frames"]),
                                   replace=False)
        per = -(-n // len(pick))
        pix = []
        for k in pick:
            r, rgb, f = frames[k]
            idx = self.g_check.choice(self.size ** 2, per, replace=False)
            pix.append((r["subject"], r["poses"][f], idx,
                        rgb.reshape(-1, 3)[torch.from_numpy(idx).to(rgb.device)].float()))
        self.kept.items = []
        return {"pixels": pix}

    def reference_rgb(self, sample: dict, precision: Precision) -> list:
        K = torch.from_numpy(self.K).to(self.dev)
        out = []
        with torch.no_grad(), full_f32():
            for subject, pose, idx, _ in sample["pixels"]:
                ro, rd = frame_rays(K, torch.from_numpy(pose).to(self.dev), self.size)
                sel = torch.from_numpy(idx).to(self.dev)
                out.append(ref_student.render(self.avatars[subject], self.cfg, ro[sel], rd[sel],
                                              precision)["rgb"])
        return out

    def numbers(self, sample: dict, candidate) -> dict:
        if not hasattr(self, "_ref"):
            self._ref = self.reference_rgb(sample, Precision("f32"))
        if candidate == "program":
            got = [p[-1] for p in sample["pixels"]]
        else:
            got = self.reference_rgb(sample, candidate)
        return pixel_gaps(got, self._ref)

    def release_reference(self) -> None:
        self.__dict__.pop("_ref", None)


def frame_rays(K: torch.Tensor, c2w: torch.Tensor, size: int):
    """The pinhole rays of a size x size frame, flat in row-major order."""
    j, i = torch.meshgrid(torch.arange(size, dtype=torch.float32, device=K.device),
                          torch.arange(size, dtype=torch.float32, device=K.device),
                          indexing="ij")
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], -1).reshape(-1, 3)
    rd = dirs @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rd.shape), rd
