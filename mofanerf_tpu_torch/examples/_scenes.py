"""What the synthetic-data studies share: their meshes, UV maps and codes,
the teacher they train, the object-biased host ray sampler, the readings.

Every study of this package renders its own multiview dataset with the
software rasterizer (datagen/), trains a small two-pass teacher on it and
reads the result; the JAX package's `examples/*.py` write these pieces out
in each script, and here they are written once. The host sampler keeps
`np.random.default_rng(seed)` and the scripts' order of draws, so that a
study draws the same images and pixels as its JAX script for the same seed.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Callable, Dict

import numpy as np
import torch

from mofanerf_tpu_torch.data.facescape import load_facescape_data
from mofanerf_tpu_torch.models.field import FieldConfig
from mofanerf_tpu_torch.ops.rays import get_rays_at
from mofanerf_tpu_torch.render.renderer import MoFaNeRF, RenderConfig
from mofanerf_tpu_torch.train.state import (Batch, create_train_state, make_optimizer,
                                            train_step)
from mofanerf_tpu_torch.utils.device import resolve_device, to_device
from mofanerf_tpu_torch.utils.image_io import imread
from mofanerf_tpu_torch.utils.metrics import ssim as _ssim

UV_SIZE = 128        # the studies' UV maps and texture encoder
N_RAND = 1024        # rays a teacher batch
N_OBJ = 614          # of them drawn on object pixels (60%)

CUBE_VERTS = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                       [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64)
CUBE_FACES = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
                       [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]],
                      np.int32)
OCTA_FACES = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                       [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
RED, BLUE = (0.9, 0.2, 0.2), (0.2, 0.3, 0.9)


def _keys(*names, **nested):
    """A key tree (see `key_tree`): each of `names` a reading, each of `nested` an
    object's tree (a one-element list for a list of objects)."""
    return {**dict.fromkeys(names), **nested}


_PER_EXPRESSION = _keys("teacher_area", "cond_area", "cond_psnr_vs_teacher_db",
                        "uncond_psnr_vs_teacher_db", "cond_ssim_vs_teacher")
_PER_IDENTITY = _keys("own_psnr_db", "cross_psnr_db", "own_ssim", "cross_ssim")
_OCC = _keys("psnr_vs_teacher_db", "rays_per_sec")
# the key tree of each study's JSON: its JAX script's readings and "device"; for the four
# with a committed JAX artifact (artifacts/avatar_student_quality.json and the rest), the
# artifact's keys and the SSIM readings the JAX scripts write since
JSON_KEYS = {
    "train_synthetic": _keys("scene", "train_psnr_first_db", "train_psnr_last_db",
                             "heldout_psnr_db", "device"),
    "expression_synthetic": _keys("area_exp0", "area_exp1", "area_ratio", "iters", "device"),
    "texture_synthetic": _keys("mean_rgb_uv0", "mean_rgb_uv1", "red_dominant_uv0",
                               "blue_dominant_uv1", "iters", "device"),
    "morphable_synthetic": _keys("own_psnr_db", "cross_gt_psnr_db", "swapped_code_psnr_db",
                                 "swap_mean_abs_diff", "fit_loss_first", "fit_loss_min",
                                 "fit_psnr_db", "iters", "fit_iters", "device"),
    "distill_synthetic": _keys(
        "scene", "teacher_psnr_vs_gt_db", "teacher_ssim_vs_gt", "device",
        occupancy_real_grid=_keys("occ_fraction", keep16=_OCC, keep32=_OCC),
        students=[_keys("student", "samples", "psnr_vs_teacher_db", "psnr_vs_gt_db",
                        "ssim_vs_teacher", "ssim_vs_gt", "rays_per_sec", "distill_sec")]),
    "distill_morphable": _keys("teacher", "student", "distill_steps", "distill_secs", "device",
                               per_identity={"0": _PER_IDENTITY, "1": _PER_IDENTITY}),
    "distill_expression": _keys(
        "teacher", "conditioned_student", "distill_steps", "cond_distill_secs", "device",
        per_expression={"0": _PER_EXPRESSION, "1": _PER_EXPRESSION},
        interpolation=_keys("area_exp0", "area_mid", "area_exp1", "monotone")),
    "distill_scenes": _keys(
        "study", "teacher", "student", "teacher_lr", "teacher_gate_db", "white_bkgd",
        "sigma_activation", "psnr_vs_teacher_spread_db", "device",
        scenes=[_keys("scene", "n_verts", "n_faces", "teacher_psnr_vs_gt_db",
                      "teacher_ssim_vs_gt", "student_psnr_vs_teacher_db",
                      "student_ssim_vs_teacher", "student_psnr_vs_gt_db", "student_ssim_vs_gt",
                      "distill_sec",
                      teacher_attempts=[_keys("lr", "seed", "iters", "teacher_psnr_vs_gt_db")])]),
}


def key_tree(tree):
    """A JSON's keys as a tree: an object's keys map to their values' trees, a list of
    objects to a one-element list of its first object's tree, anything else to None."""
    if isinstance(tree, dict):
        return {k: key_tree(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [key_tree(tree[0])]
    return None


def cube(scale: float):
    """(verts, faces) of the axis-aligned cube with half-side `scale`."""
    return CUBE_VERTS * scale, CUBE_FACES


def octahedron(radius: float = 2.2):
    """(verts, faces) of the octahedron with its vertices at +-radius on the axes."""
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                 np.float64) * radius
    return v, OCTA_FACES


def two_cubes():
    """The two-expression scene of one identity: a small cube (expression 0)
    and a large one (expression 1)."""
    return {0: cube(1.0), 1: cube(2.2)}


def flat_uv(color) -> np.ndarray:
    """A UV map of one colour (a grey level or an RGB triple), [128, 128, 3] f32."""
    return np.broadcast_to(np.asarray(color, np.float32), (UV_SIZE, UV_SIZE, 3)).copy()


def one_hot_shape_codes(n: int = 2) -> np.ndarray:
    """FaceScape's [300, 50] identity factors, zero but for identity i's
    factor i (distinct identities, i < n)."""
    codes = np.zeros((300, 50), np.float32)
    codes[np.arange(n), np.arange(n)] = 1.0
    return codes


def teacher_spec(coarse=(8, 64), fine=(8, 128), n_samples: int = 32,
                 compute_dtype=torch.float32, **render) -> MoFaNeRF:
    """The studies' two-pass teacher: (depth, width) of each field, n_samples
    coarse + n_samples importance samples, packets of 4096 rays, sigma noise
    of std 1 (it keeps dead-ReLU densities trainable), UV maps of 128."""
    return MoFaNeRF(
        coarse=FieldConfig(depth=coarse[0], width=coarse[1], compute_dtype=compute_dtype),
        fine=FieldConfig(depth=fine[0], width=fine[1], compute_dtype=compute_dtype),
        render=RenderConfig(n_coarse=n_samples, n_importance=n_samples, packet_size=4096,
                            raw_noise_std=1.0, **render),
        uv_size=UV_SIZE,
    )


def load_dataset(data_dir: str, ids, shape_codes=None):
    """(dataset, H, W, K) of a rendered study dataset, every test view kept."""
    codes = np.zeros((300, 50), np.float32) if shape_codes is None else shape_codes
    ds = load_facescape_data(data_dir, list(ids), codes, testskip=1)
    H, W, focal = ds.hwf
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    return ds, H, W, K


def load_rgb(path: str):
    """(rgb [H, W, 3] f32 in [0, 1], object mask): alpha dropped, the object
    where the colours sum above 0.05."""
    rgb = imread(path).astype(np.float32)[..., :3] / 255.0
    return rgb, rgb.sum(-1) > 0.05


def load_white(path: str):
    """(rgb over white, object mask from alpha) of an RGBA frame."""
    img = np.asarray(imread(path), np.float32) / 255.0
    if img.shape[-1] == 4:
        a = img[..., 3:]
        return img[..., :3] * a + (1.0 - a), img[..., 3] > 0.02
    return img[..., :3], img[..., :3].sum(-1) > 0.05


class HostSampler:
    """The studies' object-biased ray sampler: a random training view, then
    `n_obj` pixels drawn with replacement from its object mask (fewer when
    the mask is smaller) and the rest uniform over the frame. Images are read
    once and kept."""

    def __init__(self, ds, seed: int, load: Callable = load_rgb):
        self.ds, self.load, self.images = ds, load, {}
        self.rng = np.random.default_rng(seed)

    def view(self, img_i: int):
        if img_i not in self.images:
            self.images[img_i] = self.load(self.ds.image_paths[img_i])
        return self.images[img_i]

    def draw(self, n_rays: int = N_RAND, n_obj: int = N_OBJ):
        """(view index, coords [n_rays, 2] int (row, col), target rgb [n_rays, 3])."""
        img_i = int(self.rng.choice(self.ds.i_split[0]))
        target, mask = self.view(img_i)
        coords = object_coords(self.rng, mask, n_rays, n_obj)
        return img_i, coords, target[coords[:, 0], coords[:, 1]]


def object_coords(rng: np.random.Generator, mask: np.ndarray, n_rays: int, n_obj: int):
    """min(n_obj, object pixels) coords drawn on the mask, the rest uniform:
    the JAX scripts' draws, in their order."""
    H, W = mask.shape
    obj_r, obj_c = np.nonzero(mask)
    n_obj = min(n_obj, obj_r.shape[0])
    pick = rng.integers(0, obj_r.shape[0], n_obj) if n_obj else np.empty(0, np.int64)
    n_uni = n_rays - n_obj
    return np.concatenate([
        np.stack([obj_r[pick], obj_c[pick]], -1).reshape(n_obj, 2),
        np.stack([rng.integers(0, H, n_uni), rng.integers(0, W, n_uni)], -1)], 0)


def make_batch(ds, K, img_i, coords, target, shape_code, exp_type: int, uv,
               dev: torch.device) -> Batch:
    """A train_step batch of the rays through `coords` of view `img_i`."""
    ro, rd = get_rays_at(to_device(coords, dev), to_device(K, dev),
                         to_device(ds.poses[img_i], dev))
    return Batch(ro, rd, to_device(target, dev), to_device(shape_code, dev),
                 torch.tensor(int(exp_type), device=dev), uv)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_teacher(spec: MoFaNeRF, lrate: float, batch_fn: Callable[[int], Batch], iters: int,
                  dev: torch.device, seed: int = 0, log_every: int = 500, tag: str = "TEACHER"):
    """`iters` train_steps of a teacher made from `seed` on `batch_fn(i)`.
    Returns (state, seconds, log): the log holds (step, loss, psnr) of every
    `log_every`-th step and the last, the only steps whose metrics are read."""
    state = create_train_state(torch.Generator().manual_seed(seed), spec, lrate=lrate, device=dev)
    tx = make_optimizer(lrate=lrate)
    gen = torch.Generator(device=dev).manual_seed(seed)
    log = []
    sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        state, m = train_step(state, batch_fn(i), gen, spec, tx)
        if i % log_every == 0 or i == iters - 1:
            log.append((i, float(m["loss"]), float(m["psnr"])))
            print(f"[{tag}] iter {i} loss {log[-1][1]:.4f} psnr {log[-1][2]:.2f} "
                  f"({(i + 1) / (time.perf_counter() - t0):.1f} it/s)", flush=True)
    sync(dev)
    return state, time.perf_counter() - t0, log


def uv_tensor(color, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(flat_uv(color)).to(dev)


def psnr(a, b) -> float:
    """PSNR in dB of two images in [0, 1], capped at 100 dB."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-10)))


def ssim(a, b) -> float:
    return float(_ssim(np.asarray(a), np.asarray(b)))


def area(acc) -> float:
    """Share of the frame whose opacity exceeds 0.5."""
    return float((np.asarray(acc) > 0.5).mean())


def mean_rgb(rgb, acc) -> np.ndarray:
    """Mean colour over the pixels of opacity above 0.5 (the frame's when none)."""
    rgb, hit = np.asarray(rgb), np.asarray(acc) > 0.5
    return rgb[hit].mean(0) if hit.any() else rgb.mean((0, 1))


def np_maps(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in out.items()}


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    lines = smi.stdout.strip().splitlines()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if smi.returncode == 0 and len(lines) > index:
        return lines[index].strip()
    return torch.cuda.get_device_name(dev)


def timed_ms(fn: Callable[[], object], dev: torch.device, reps: int = 16) -> float:
    """ms a call of `fn`: CUDA events around `reps` calls after one warm-up on
    the card; one call on the host clock elsewhere (a CPU run is a test, not
    a measurement)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync(dev)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def add_device_flags(p) -> None:
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (tests)")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")


def device_of(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else args.device)


def default_out(name: str) -> str:
    """A study's default output directory, under the temporary directory."""
    import tempfile

    return os.path.join(tempfile.gettempdir(), name)


def write_json(path: str, result: dict, timing: dict | None = None) -> None:
    """Write a study's readings; its timing (not a reading of the JAX
    script's JSON) is printed as one `[TIMING]` JSON line."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1)
    print(f"wrote {path}", flush=True)
    if timing is not None:
        print("[TIMING] " + json.dumps(timing), flush=True)


def gate(ok: bool, what) -> None:
    """A study's pass/fail check (the JAX script's assert), raised under -O too."""
    if not ok:
        raise AssertionError(what)


def rate(n: int, secs: float):
    return n / secs if secs > 0 else None
