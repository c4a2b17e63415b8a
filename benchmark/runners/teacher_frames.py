"""Teacher frames: each request is an (identity, expression) pair of the
traffic, whose conditioning (texture encoder, ISM, fold: `prepare_conditioning`)
and kernel operands (`pack_frame`) are made once, then its views rendered
one frame at a time by `render/renderer.py::render_frame` (the field kernel,
coarse and fine). A unit of the window is one whole request, its set-up and
all its frames, so that a window pays one set-up for `frames_per_request`
frames, as the traffic has it.

The comparison draws pixels of the window's frames from the seed and renders
their rays through the reference in f32."""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.common import Reservoir, rng
from benchmark.counts import teacher_ray_flops
from benchmark.runners.teacher_model import make_params, program_config, sync
from benchmark.reference import nerf
from benchmark.reference.precision import Precision, full_f32
from benchmark.traffic import camera_K, requests
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for, pack_frame,
                                                prepare_conditioning, render_frame)


class Runner:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: str):
        self.cfg, self.traffic, self.dev = cfg, traffic, torch.device(device)
        self.spec = program_config(cfg).model_spec()
        self.params = make_params(self.spec, seed, self.dev)
        self.marks = [("weights", time.perf_counter())]
        g = rng(seed, 30)
        n_sub, S = traffic["subjects"], cfg["uv_size"]
        self.shape_codes = torch.from_numpy(
            g.standard_normal((n_sub, cfg["input_ch_shapeCodes"])).astype(np.float32)).to(self.dev)
        self.uv_maps = torch.from_numpy(
            g.uniform(0, 1, (n_sub, S, S, 3)).astype(np.float32)).to(self.dev)
        self.requests = requests(traffic, seed)
        self.K = camera_K(traffic)
        self.size = traffic["size"]
        self.seed, self.g_check = seed, rng(seed, 32)
        self.begin()
        self._begin_request()   # a request's set-up and one frame warm every shape
        self._frame(self.req["poses"][0])
        self.sync()
        self.begin()

    def _begin_request(self):
        r = self.requests[self.next % len(self.requests)]
        with torch.no_grad():
            tex = encode_texture(self.params, self.spec, self.uv_maps[r["subject"]])
            cond = prepare_conditioning(self.params, self.spec, self.shape_codes[r["subject"]],
                                        exp_code_for(self.params, r["expression"]), tex)
            self.cond, self.pack = cond, pack_frame(self.params, self.spec, cond)
        self.req = r

    def _frame(self, pose):
        out = render_frame(self.params, self.spec, self.cond, self.size, self.size, self.K,
                           pose[:3], pack=self.pack)
        self.sync()          # a frame is served when it is on the card, whole
        return out["rgb"]

    def unit(self, tracing: bool = False) -> None:
        self._begin_request()
        self.next += 1
        for pose in self.req["poses"]:
            rgb = self._frame(pose)
            self.kept.offer((self.req["subject"], self.req["expression"], pose, rgb))
            self.frames += 1

    def sync(self) -> None:
        sync(self.dev)

    def begin(self) -> None:
        self.next, self.frames = 0, 0
        self.kept = Reservoir(self.traffic["check_frames"], rng(self.seed, 31))

    def end_to_end(self, seconds: float) -> dict:
        return {"render_rays_per_s": self.frames * self.size ** 2 / seconds}

    def layer_info(self) -> dict:
        return {"frames": self.frames, "rays": self.frames * self.size ** 2,
                "ray_flops": teacher_ray_flops(self.cfg)}

    # --- the comparison --------------------------------------------------------------

    def collect(self) -> dict:
        """A draw of pixels of the kept frames, with the program's colour."""
        n = self.traffic["check_rays"]
        items = self.kept.items
        per = -(-n // len(items))
        pix = []
        for subject, expression, pose, rgb in items:
            idx = self.g_check.choice(self.size ** 2, per, replace=False)
            pix.append((subject, expression, pose, idx,
                        rgb.reshape(-1, 3)[torch.from_numpy(idx).to(rgb.device)].float()))
        del self.pack, self.cond
        self.kept.items = []
        return {"pixels": pix}

    def reference_rgb(self, sample: dict, precision: Precision) -> list:
        out = []
        K = torch.from_numpy(self.K).to(self.dev)
        with torch.no_grad(), full_f32():
            for subject, expression, pose, idx, _ in sample["pixels"]:
                fc = nerf.codes(self.params, self.shape_codes[subject], expression,
                                self.uv_maps[subject], precision)
                rows = torch.from_numpy(idx // self.size).float().to(self.dev)
                cols = torch.from_numpy(idx % self.size).float().to(self.dev)
                c2w = torch.from_numpy(pose).to(self.dev)
                dirs = torch.stack([(cols - K[0, 2]) / K[0, 0], -(rows - K[1, 2]) / K[1, 1],
                                    -torch.ones_like(cols)], -1)
                rd = dirs @ c2w[:3, :3].T
                ro = c2w[:3, 3].expand(rd.shape)
                chunks = [nerf.render_rays(self.params, self.cfg, fc, ro[a:a + 512],
                                           rd[a:a + 512], precision)["rgb"]
                          for a in range(0, rd.shape[0], 512)]
                out.append(torch.cat(chunks))
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


def pixel_gaps(got: list, ref: list) -> dict:
    """Over the drawn pixels' colour channels: the widest gap (rgb_max_gap),
    the root mean square (rgb_rms_gap), the mean (rgb_mean_gap) and the
    median (rgb_median_gap) of the gaps."""
    d = torch.cat([(a.float() - b).reshape(-1) for a, b in zip(got, ref)]).abs()
    if not bool(torch.isfinite(d).all()):
        return {k: float("inf") for k in ("rgb_max_gap", "rgb_rms_gap", "rgb_mean_gap",
                                          "rgb_median_gap")}
    return {"rgb_max_gap": float(d.max()), "rgb_rms_gap": float(d.pow(2).mean().sqrt()),
            "rgb_mean_gap": float(d.mean()), "rgb_median_gap": float(d.median())}
