"""Device-resident training data and batch sampling on the device
(counterpart of mofanerf_tpu/data/device_data.py).

The training split (images as uint8, poses, codes, UV maps, projected
landmark pixels or foreground-pixel reservoirs) is read once on the host
and kept on the card. A batch is drawn there from a `torch.Generator` on
the card: the centre crop during `precrop_iters`, the annealed landmark or
foreground bias after it, a uniform fill, the rays through the chosen
pixels and the targets gathered from the uint8 image. Nothing of a batch
reads back to the host, so the loop fires steps back to back
(train/loop.py::_train_device_data).

Semantics against the host sampler (data/landmarks.py::TrainRaySampler),
as in the JAX package: the biased fraction is a per-ray Bernoulli(frac)
rather than an exact count; the foreground bias draws from a fixed
reservoir of foreground pixels sampled once at build time; the random
stream is the device generator's. `sample_batch_device(draws=...)` takes
the draws instead, so that a test feeds the JAX sampler's own.

Reproduced from the JAX package (ROADMAP C): `expdelta` reservoirs of
frames left unfilled hold pixel (0, 0), which the sampler then draws; an
unknown `ray_bias` falls back to uniform sampling.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from mofanerf_tpu_torch.data.facescape import read_image
from mofanerf_tpu_torch.data.landmarks import project_landmarks
from mofanerf_tpu_torch.ops.rays import get_rays_at
from mofanerf_tpu_torch.train.state import Batch
from mofanerf_tpu_torch.utils.device import resolve_device
from mofanerf_tpu_torch.utils.image_io import imread, resize_area


class DeviceDataset(NamedTuple):
    """Training split, resident on the device. The bias mode (a string kept
    beside it) selects how the biased fraction of rays is drawn: 'landmarks'
    from gaussian clouds around `lm2d`, 'fg' from `fg_pixels`, else uniform."""

    images: torch.Tensor       # [N, H, W, 3] uint8
    poses: torch.Tensor        # [N, 4, 4] f32
    shape_codes: torch.Tensor  # [N, shape_dim] f32
    exp_types: torch.Tensor    # [N] int32
    uv_maps: torch.Tensor      # [P, S, S, 3] f32
    uv_index: torch.Tensor     # [N] int32 image -> uv_maps row
    lm2d: torch.Tensor         # [N, 68, 2] f32 projected (row, col) pixels
    fg_pixels: torch.Tensor    # [N, F, 2] int32 foreground reservoir


@dataclasses.dataclass(frozen=True)
class DeviceSamplerConfig:
    """Sampling parameters fixed for a run."""

    n_rand: int
    H: int
    W: int
    precrop_iters: int
    precrop_frac: float
    lm_frac: float
    lm_frac_anneal_iters: int
    bias: str                 # 'landmarks' | 'fg' | 'none'


def estimate_device_bytes(n_images: int, H: int, W: int,
                          n_uv: int = 8, uv_size: int = 512,
                          fg_reservoir: int = 2048) -> int:
    """Rough device-memory footprint of a DeviceDataset."""
    return (n_images * H * W * 3                       # uint8 images
            + n_images * (16 * 4 + 68 * 2 * 4 + fg_reservoir * 2 * 4 + 64)
            + n_uv * uv_size * uv_size * 3 * 4)


def resident_bytes(dd: DeviceDataset) -> int:
    """The bytes a DeviceDataset's tensors hold."""
    return sum(t.numel() * t.element_size() for t in dd)


def _fg_mask(path: str, img: np.ndarray, half_res: bool,
             white_bkgd: bool) -> Optional[np.ndarray]:
    """Foreground mask for the fg-bias reservoir: the source alpha channel
    when the file has one; else a brightness threshold on the RGB when the
    background is black; else None (the caller then degrades the bias to
    'none' rather than bake a uniform reservoir)."""
    raw = imread(path)
    if raw.ndim == 3 and raw.shape[-1] == 4:
        a = raw[..., 3].astype(np.float32) / 255.0
        if half_res:
            a = resize_area(a, (a.shape[1] // 2, a.shape[0] // 2))
        return a > 0.02
    if not white_bkgd:
        return img.sum(-1) > 0.02
    return None


def _expdelta_reservoirs(ds, idx, imgs, W, fg_reservoir, rng):
    """Per-image reservoirs of expression-informative pixels: frames grouped
    by (identity, camera pose), each frame's reservoir drawn with probability
    proportional to its largest per-pixel difference from its same-pose
    siblings. Returns (fg array, any_filled)."""
    groups = {}
    for k, i in enumerate(idx):
        key = (int(ds.id_codes[int(i)]),
               np.round(np.asarray(ds.poses[int(i)][:3]), 5).tobytes())
        groups.setdefault(key, []).append(k)
    fg = np.zeros((len(idx), fg_reservoir, 2), np.int32)
    filled = False
    for ks in groups.values():
        if len(ks) < 2:
            continue
        stack = np.stack([imgs[k].astype(np.float32) for k in ks])
        for a_pos, k in enumerate(ks):
            delta = np.abs(stack - stack[a_pos]).mean(-1).max(0).reshape(-1)
            s = float(delta.sum())
            if s <= 0.0:
                continue
            pick = rng.choice(delta.shape[0], size=fg_reservoir, p=delta / s)
            fg[k, :, 0] = pick // W
            fg[k, :, 1] = pick % W
            filled = True
    return fg, filled


def build_device_dataset(
    ds,                              # data.facescape.FacescapeDataset
    K: np.ndarray,
    indices: np.ndarray,             # images to include (the train split)
    landmarks: Optional[np.ndarray] = None,  # [n_ids, n_exps, 68, 3] world
    uv_size: int = 512,
    fg_reservoir: int = 2048,
    half_res: bool = False,
    white_bkgd: bool = False,
    seed: int = 0,
    bias_override: Optional[str] = None,  # None/'auto' | 'expdelta' | 'fg' | 'landmarks' | 'none'
    device="cuda",
):
    """Read the split once on the host and place it on `device`. Returns
    (DeviceDataset, bias mode). The host draws (foreground and expdelta
    reservoirs) are the JAX package's, from `np.random.default_rng(seed)` in
    the same order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    idx = np.asarray(indices, np.int64)
    n = len(idx)
    imgs = []
    fg = np.zeros((n, fg_reservoir, 2), np.int32)
    lm2d = np.zeros((n, 68, 2), np.float32)
    if bias_override in (None, "auto"):
        bias = "landmarks" if landmarks is not None else "fg"
    else:
        bias = bias_override
        if bias == "landmarks" and landmarks is None:
            raise ValueError("bias_override='landmarks' but no landmarks given")
    has_fg = False
    for k, i in enumerate(idx):
        img = read_image(ds.image_paths[int(i)], half_res=half_res, white_bkgd=white_bkgd)
        imgs.append(np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8))
        if landmarks is not None:
            lm3 = landmarks[int(ds.id_codes[i]), int(ds.exp_types[i])]
            lm2d[k] = project_landmarks(lm3, K, ds.poses[int(i)]).astype(np.float32)
        else:
            mask = _fg_mask(ds.image_paths[int(i)], img, half_res, white_bkgd)
            if mask is not None:
                r, c = np.nonzero(mask)
                if r.shape[0] > 0:
                    pick = rng.integers(0, r.shape[0], fg_reservoir)
                    fg[k, :, 0] = r[pick]
                    fg[k, :, 1] = c[pick]
                    has_fg = True
    if bias == "expdelta":
        fg, filled = _expdelta_reservoirs(ds, idx, imgs, imgs[0].shape[1], fg_reservoir, rng)
        # from here on the reservoirs are read as the fg mode's
        bias = "fg" if filled else "none"
    elif bias == "fg" and not has_fg:
        bias = "none"

    persons = sorted({int(ds.id_codes[i]) for i in idx})
    slot = {p: s for s, p in enumerate(persons)}
    uv_maps = np.zeros((len(persons), uv_size, uv_size, 3), np.float32)
    for p, s in slot.items():
        if p in ds.uv_paths:
            uv_maps[s] = read_image(ds.uv_paths[p], is_uvmap=True, uv_size=uv_size)
    uv_index = np.asarray([slot[int(ds.id_codes[i])] for i in idx], np.int32)

    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    dd = DeviceDataset(
        images=to(np.stack(imgs)),
        poses=to(ds.poses[idx].astype(np.float32)),
        shape_codes=to(ds.shape_codes[idx].astype(np.float32)),
        exp_types=to(ds.exp_types[idx].astype(np.int32)),
        uv_maps=to(uv_maps),
        uv_index=to(uv_index),
        lm2d=to(lm2d),
        fg_pixels=to(fg),
    )
    return dd, bias


def draw_batch(dd: DeviceDataset, scfg: DeviceSamplerConfig,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The random draws of one batch, on the dataset's device: the image
    index [1], the box uniforms [n, 2], the reservoir or landmark picks [n],
    the landmark jitter normals [n, 2] and the bias-mask uniforms [n] (the
    JAX sampler's k_img, k_box, k_pick, k_jit, k_mask)."""
    n, dev = scfg.n_rand, dd.images.device
    n_pick = dd.fg_pixels.shape[1] if scfg.bias == "fg" else dd.lm2d.shape[1]
    return {
        "img": torch.randint(0, dd.images.shape[0], (1,), generator=generator, device=dev),
        "box": torch.rand((n, 2), generator=generator, device=dev),
        "pick": torch.randint(0, n_pick, (n,), generator=generator, device=dev),
        "jit": torch.randn((n, 2), generator=generator, device=dev),
        "mask": torch.rand((n,), generator=generator, device=dev),
    }


def _row(t: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """t[img] for a [1] index tensor on t's device, without a host read."""
    return torch.index_select(t, 0, img)[0]


def sample_batch_device(
    dd: DeviceDataset,
    K: torch.Tensor,
    i: int,
    scfg: DeviceSamplerConfig,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> Batch:
    """One training batch drawn on the device at iteration `i` (a Python
    int: the schedule's scalars are host arithmetic in f32, as the JAX
    sampler's are on its traced counter). The draws come from `draws` or
    `generator`. The float operations are the JAX sampler's, in its order:
    the coordinates are floored before the rays are made, so the ray and the
    gathered supervision pixel agree. `Batch.coords` holds the [n, 2] f32
    (row, col) coordinates on the device."""
    H, W = scfg.H, scfg.W
    dev = dd.images.device
    if draws is None:
        draws = draw_batch(dd, scfg, generator)
    img = draws["img"].reshape(1).to(device=dev, dtype=torch.int64)
    f32 = np.float32
    fi = f32(i)

    # precrop window (the full frame once i >= precrop_iters)
    active = bool(fi < scfg.precrop_iters)
    dH = H // 2 * scfg.precrop_frac
    dW = W // 2 * scfg.precrop_frac
    lo_r, hi_r = (f32(H / 2 - dH), f32(H / 2 + dH)) if active else (f32(0.0), f32(H))
    lo_c, hi_c = (f32(W / 2 - dW), f32(W / 2 + dW)) if active else (f32(0.0), f32(W))
    u = draws["box"]
    rows_u = torch.floor(float(lo_r) + u[:, 0] * float(hi_r - lo_r))
    cols_u = torch.floor(float(lo_c) + u[:, 1] * float(hi_c - lo_c))

    # the biased share: annealed, and none while the precrop is active
    if scfg.lm_frac_anneal_iters > 0:
        frac = f32(scfg.lm_frac) * np.clip(fi / f32(scfg.lm_frac_anneal_iters), f32(0), f32(1))
    else:
        frac = f32(scfg.lm_frac)
    frac = f32(0.0) if active else frac

    if scfg.bias == "landmarks":
        pts = dd.lm2d[img, draws["pick"]] + draws["jit"] * (0.025 * H)
        rows_b, cols_b = pts[:, 0], pts[:, 1]
    elif scfg.bias == "fg":
        picked = dd.fg_pixels[img, draws["pick"]].to(torch.float32)
        rows_b, cols_b = picked[:, 0], picked[:, 1]
    else:
        rows_b, cols_b = rows_u, cols_u

    use_b = draws["mask"] < float(frac)
    rows = torch.floor(torch.clamp(torch.where(use_b, rows_b, rows_u), 0, H - 1))
    cols = torch.floor(torch.clamp(torch.where(use_b, cols_b, cols_u), 0, W - 1))
    coords = torch.stack([rows, cols], dim=-1)

    rays_o, rays_d = get_rays_at(coords, K, _row(dd.poses, img))
    flat = (img * H + rows.to(torch.int64)) * W + cols.to(torch.int64)
    tgt = dd.images.reshape(-1, 3)[flat]
    return Batch(
        rays_o=rays_o,
        rays_d=rays_d,
        target_rgb=tgt.to(torch.float32) / 255.0,
        shape_code=_row(dd.shape_codes, img),
        exp_type=_row(dd.exp_types, img),
        uv_map=_row(dd.uv_maps, _row(dd.uv_index, img).reshape(1)),
        coords=coords,
    )
