"""Host-side training driver (counterpart of mofanerf_tpu/train/loop.py,
the host-data path).

Each iteration picks a random training image, reads the target and the
identity's UV map (cached on the card after its first read), draws
landmark-biased ray coordinates (a centre crop during `precrop_iters`),
and runs one step (train/state.py: the run's state copied once into flat
buffers, `FlatTrainState`, stepped in place); on their intervals it logs,
checkpoints and renders a held-out image and the orbit through the
inference renderer (kernel B1 on the card), as PNGs. Batches are assembled by `make_batch` on
a prefetch thread while the card runs the previous step.

With `i_grid > 0` the loop keeps an occupancy grid of the coarse field
(ops/occupancy.py): every `i_grid` steps, once `grid_warmup` steps have passed, it
re-probes the density under the step's conditioning into an EMA, and it
saves the grid as `occupancy_grid.npz` beside every checkpoint; a resumed
run resumes the grid. `run_render --fast` and distillation read it.

With `device_data` the training split is kept on the card and each batch
is drawn there (data/device_data.py): `_train_device_data` fires chunks of
`scan_steps` steps back to back with no host read inside a chunk, and
fires the interval hooks whenever a chunk crosses an interval, so the
checkpoints land on the JAX loop's steps whatever `scan_steps` is.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from mofanerf_tpu_torch.config import Config
from mofanerf_tpu_torch.data.device_data import (DeviceDataset, DeviceSamplerConfig,
                                                 build_device_dataset, sample_batch_device)
from mofanerf_tpu_torch.data.facescape import (FacescapeDataset, load_facescape_data,
                                               load_shape_codes, read_image, valid_persons)
from mofanerf_tpu_torch.data.landmarks import TrainRaySampler, anneal_lm_frac
from mofanerf_tpu_torch.data.prefetch import Prefetcher
from mofanerf_tpu_torch.ops.occupancy import (OccupancyGrid, load_grid, save_grid,
                                              update_occupancy_grid)
from mofanerf_tpu_torch.ops.rays import get_rays_at
from mofanerf_tpu_torch.render.renderer import (MoFaNeRF, encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame, render_path)
from mofanerf_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from mofanerf_tpu_torch.train.state import (Batch, FlatTrainState, create_train_state,
                                            make_optimizer)
from mofanerf_tpu_torch.utils import profiling
from mofanerf_tpu_torch.utils.device import resolve_device, to_device
from mofanerf_tpu_torch.utils.image_io import write_png
from mofanerf_tpu_torch.utils.logger import TrainLogger
from mofanerf_tpu_torch.utils.metrics import to8b


def _uv_map(ds: FacescapeDataset, spec: MoFaNeRF, pid: int, uv_cache: dict, device):
    """The identity's UV map on `device`, read once."""
    if pid not in uv_cache:
        uv = read_image(ds.uv_paths[pid], is_uvmap=True, uv_size=spec.uv_size)
        uv_cache[pid] = torch.from_numpy(uv).to(device)
    return uv_cache[pid]


def make_batch(i: int, cfg: Config, spec: MoFaNeRF, ds: FacescapeDataset, K: np.ndarray,
               sampler: TrainRaySampler, rng: np.random.Generator, uv_cache: dict,
               device) -> Batch:
    """Host-side batch assembly of iteration `i`: a random training image,
    its target and UV map, ray coordinates drawn from `rng` (precrop and the
    landmark anneal by `i`), and the rays through them, on `device`."""
    img_i = int(rng.choice(ds.i_split[0]))
    pid = int(ds.id_codes[img_i])
    uv_map = _uv_map(ds, spec, pid, uv_cache, device)
    target = read_image(ds.image_paths[img_i], half_res=cfg.half_res, white_bkgd=cfg.white_bkgd)
    pose = ds.poses[img_i]
    precrop = cfg.precrop_frac if i < cfg.precrop_iters else None
    coords = sampler.sample(
        rng, cfg.N_rand, K, pose, pid, int(ds.exp_types[img_i]),
        precrop_frac=precrop, target_img=target,
        lm_frac=anneal_lm_frac(i, cfg.lm_frac, cfg.lm_frac_anneal_iters),
    )
    rays_o, rays_d = get_rays_at(torch.from_numpy(coords.astype(np.float32)),
                                 torch.from_numpy(np.asarray(K, np.float32)),
                                 torch.from_numpy(np.asarray(pose, np.float32)))
    return Batch(
        rays_o=rays_o.to(device),
        rays_d=rays_d.to(device),
        target_rgb=torch.from_numpy(target[coords[:, 0], coords[:, 1]]).to(device),
        shape_code=torch.from_numpy(ds.shape_codes[img_i]).to(device),
        exp_type=torch.tensor(int(ds.exp_types[img_i]), dtype=torch.int64, device=device),
        uv_map=uv_map,
        coords=coords,
    )


def step_generator(seed: int, i: int, device) -> torch.Generator:
    """The random draws of iteration i (the JAX loop keys its step with
    PRNGKey(seed * 1_000_003 + i))."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + i)


def train(cfg: Config, n_iters: Optional[int] = None, seed: int = 0, device="cuda"):
    """Train from cfg; resumes from the newest `.pt` in the experiment's
    checkpoints unless `no_reload`. Returns the final TrainState."""
    dev = resolve_device(device)
    spec = cfg.model_spec()
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    os.makedirs(exp_dir, exist_ok=True)
    logger = TrainLogger(os.path.join(exp_dir, "train_log.txt"))

    # per-run config snapshot: args.txt with every flag, config.txt mirroring
    # the config file when one was used
    with open(os.path.join(exp_dir, "args.txt"), "w") as f:
        for k, v in sorted(dataclasses.asdict(cfg).items()):
            f.write(f"{k} = {v}\n")
    if cfg.config and os.path.exists(cfg.config):
        with open(cfg.config) as src, open(os.path.join(exp_dir, "config.txt"), "w") as dst:
            dst.write(src.read())

    persons = valid_persons(cfg.datadir, cfg.person_num)
    shape_codes = load_shape_codes(cfg.shape_codes_path)
    ds = load_facescape_data(cfg.datadir, persons, shape_codes, uvdir=cfg.uvdir,
                             half_res=cfg.half_res, testskip=cfg.testskip)
    H, W, focal = ds.hwf
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)

    landmarks = None
    if os.path.exists(cfg.landmarks_path):
        landmarks = np.load(cfg.landmarks_path) / 50.0   # world units
    sampler = TrainRaySampler(landmarks, H, W, lm_frac=cfg.lm_frac)

    state = create_train_state(torch.Generator().manual_seed(seed), spec, cfg.lrate,
                               cfg.lrate_decay, device=dev)
    tx = make_optimizer(cfg.lrate, cfg.lrate_decay)
    start = 0
    if not cfg.no_reload and latest_step(ckpt_dir) is not None:
        state = restore_checkpoint(ckpt_dir, state, spec=spec)
        start = int(state.step)
        logger.note(f"resumed from checkpoint at step {start}")
    else:
        logger.note("no checkpoint found — FRESH run (step and lr schedule "
                    "start at 0; log below appends to any prior run's)")

    grid, density_ema = None, None
    grid_path = os.path.join(ckpt_dir, "occupancy_grid.npz")
    if cfg.i_grid > 0:
        G = cfg.grid_resolution
        grid = OccupancyGrid(torch.zeros((G, G, G), dtype=torch.bool, device=dev),
                             torch.full((3,), -5.0, device=dev), torch.full((3,), 5.0, device=dev))
        density_ema = torch.zeros(G ** 3, dtype=torch.float32, device=dev)
        if start > 0 and os.path.exists(grid_path):
            grid, ema = load_grid(grid_path, device=dev)
            if ema is not None:
                density_ema = ema
            logger.note("resumed occupancy grid")

    def save(step, state, grid, density_ema):
        path = save_checkpoint(ckpt_dir, state, step)
        if grid is not None:
            save_grid(grid_path, grid, density_ema)
        return path

    uv_cache: dict = {}
    rng = np.random.default_rng(seed + 1)
    # eval renders draw from their own generator: `rng` is consumed on the
    # prefetch thread
    rng_eval = np.random.default_rng(seed + 2)
    n_total = n_iters if n_iters is not None else cfg.n_iters
    if cfg.device_data:
        return _train_device_data(cfg, spec, state, tx, ds, K, landmarks, logger, exp_dir,
                                  grid, density_ema, save, start, n_total, seed, uv_cache,
                                  rng_eval, dev)
    def sample(i):
        with profiling.annotate("mofanerf.train.sample"):
            return make_batch(i, cfg, spec, ds, K, sampler, rng, uv_cache, dev)

    t_last, i_last = time.perf_counter(), start
    batches = Prefetcher(sample, depth=2).iterate(start, n_total)
    # the run's one copy of the state into flat buffers, updated in place step by step
    flat = FlatTrainState(state)
    state = flat.state()
    for i, batch in zip(range(start, n_total), batches):
        metrics = flat.step_(batch, step_generator(seed, i, dev), spec, tx)

        if grid is not None and (i + 1) >= cfg.grid_warmup and (i + 1) % cfg.i_grid == 0:
            grid, density_ema = _update_grid(cfg, spec, state.params, batch, grid, density_ema)

        if (i + 1) % cfg.i_print == 0:
            loss, psnr, ok = _read_metrics(metrics)
            rate, t_last, i_last = _rate(i + 1, i_last, t_last)
            print(f"[TRAIN] iter {i + 1} loss {loss:.5f} psnr {psnr:.2f} ok {ok} "
                  f"it/s {rate:.2f}", flush=True)
            logger.write(i + 1, Loss=loss, PSNR=psnr, step_ok=ok)

        if (i + 1) % cfg.i_weights == 0:
            path = save(i + 1, state, grid, density_ema)
            logger.note(f"checkpoint saved: {path}")

        if (i + 1) % cfg.i_testset == 0 and len(ds.i_split[2]) > 0:
            _render_test_image(spec, state, ds, K, rng_eval, exp_dir, i + 1, uv_cache, dev)

        if (i + 1) % cfg.i_video == 0:
            _render_orbit(cfg, spec, state, ds, rng_eval, exp_dir, i + 1, uv_cache, dev)

    save(n_total, state, grid, density_ema)
    logger.note("training finished")
    return state


def _read_metrics(metrics: dict) -> tuple:
    """(loss, psnr, step_ok) of a step's metrics, read back from the card."""
    return (profiling.host_read(metrics["loss"]), profiling.host_read(metrics["psnr"]),
            int(profiling.host_read(metrics["step_ok"])))


def _rate(i: int, i_last: int, t_last: float) -> tuple:
    """(steps a second since the last print, now, i): the print's reads have
    waited for the card, so the interval holds exactly its steps (the first
    one, the loop's start-up too)."""
    now = time.perf_counter()
    return (i - i_last) / (now - t_last), now, i


def _auto_scan_steps(cfg: Config, n_total: int) -> int:
    """Steps a chunk of the device-data path: the gcd of every active
    logging / checkpoint interval (so that chunk ends land on them), capped
    at 100."""
    g = 0
    for v in (cfg.i_print, cfg.i_weights, cfg.i_testset, cfg.i_video, cfg.i_grid):
        if 0 < v <= n_total:
            g = math.gcd(g, v)
    return max(1, min(g or 100, 100))


def device_generator(seed: int, i: int, use: int, device) -> torch.Generator:
    """The device-data path's draws of iteration i: use 0 its batch, 1 its
    step, 2 the grid update's batch (the JAX loop folds i, then the use, into
    PRNGKey(seed * 7919 + 13))."""
    base = (seed * 7919 + 13) * 1_000_003 + i
    return torch.Generator(device=device).manual_seed(3 * base + use)


def train_chunk_device_data(state, store: DeviceDataset, K: torch.Tensor, i0: int,
                            n_steps: int, scfg: DeviceSamplerConfig, spec: MoFaNeRF, tx,
                            seed: int, mesh=None):
    """Steps i0 .. i0 + n_steps - 1 of the device-data path, back to back with
    no host read: step i's batch drawn on the device from
    device_generator(seed, i, 0), its render's draws from (seed, i, 1).
    Under `mesh` every rank draws the same whole batch and trains on its rows
    (train_step(mesh=)). The chunk copies `state` once into flat buffers of
    its own and updates those in place (FlatTrainState); `state` is left as
    it was. Returns (state, the last step's metrics)."""
    dev = store.images.device
    metrics = None
    with profiling.annotate("mofanerf.train.chunk"):
        flat = FlatTrainState(state)
        for i in range(i0, i0 + n_steps):
            with profiling.annotate("mofanerf.train.sample"):
                batch = sample_batch_device(store, K, i, scfg, device_generator(seed, i, 0, dev))
                draws = device_generator(seed, i, 1, dev)
            metrics = flat.step_(batch, draws, spec, tx, mesh=mesh)
    return flat.state(), metrics


def _train_device_data(cfg, spec, state, tx, ds, K, landmarks, logger, exp_dir, grid,
                       density_ema, save, start, n_total, seed, uv_cache, rng_eval, dev):
    """The device-resident loop: the train split on the card, batches drawn
    there, chunks of C steps fired back to back. Nothing is read back inside
    a chunk: the metrics are read only when a chunk crosses `i_print`, and
    each interval hook fires when the chunk crossed a multiple of its
    interval, not only when a chunk ends on one."""
    H, W, _ = ds.hwf
    dd, bias = build_device_dataset(
        ds, K, ds.i_split[0], landmarks=landmarks, uv_size=spec.uv_size,
        half_res=cfg.half_res, white_bkgd=cfg.white_bkgd, seed=seed,
        bias_override=cfg.ray_bias, device=dev)
    scfg = DeviceSamplerConfig(
        n_rand=cfg.N_rand, H=H, W=W, precrop_iters=cfg.precrop_iters,
        precrop_frac=cfg.precrop_frac, lm_frac=cfg.lm_frac,
        lm_frac_anneal_iters=cfg.lm_frac_anneal_iters, bias=bias)
    Kt = to_device(K, dev)
    C = cfg.scan_steps if cfg.scan_steps > 0 else _auto_scan_steps(cfg, n_total)
    logger.note(f"device-data path: {dd.images.shape[0]} frames resident, bias={bias}, "
                f"{C} steps a chunk")

    t_last, i_last = time.perf_counter(), start
    i = start
    metrics = None
    while i < n_total:
        prev = i
        n = min(C - i % C, n_total - i)
        state, metrics = train_chunk_device_data(state, dd, Kt, i, n, scfg, spec, tx, seed)
        i += n

        def crossed(v: int) -> bool:
            return v > 0 and (i // v) > (prev // v)

        if grid is not None and i >= cfg.grid_warmup and crossed(cfg.i_grid):
            gbatch = sample_batch_device(dd, Kt, i, scfg, device_generator(seed, i, 2, dev))
            grid, density_ema = _update_grid(cfg, spec, state.params, gbatch, grid,
                                             density_ema)

        if crossed(cfg.i_print):
            loss, psnr, ok = _read_metrics(metrics)
            rate, t_last, i_last = _rate(i, i_last, t_last)
            print(f"[TRAIN] iter {i} loss {loss:.5f} psnr {psnr:.2f} ok {ok} it/s {rate:.2f}",
                  flush=True)
            logger.write(i, Loss=loss, PSNR=psnr, step_ok=ok)

        if crossed(cfg.i_weights):
            path = save(i, state, grid, density_ema)
            logger.note(f"checkpoint saved: {path}")

        if crossed(cfg.i_testset) and len(ds.i_split[2]) > 0:
            _render_test_image(spec, state, ds, K, rng_eval, exp_dir, i, uv_cache, dev)

        if crossed(cfg.i_video):
            _render_orbit(cfg, spec, state, ds, rng_eval, exp_dir, i, uv_cache, dev)

    save(n_total, state, grid, density_ema)
    logger.note("training finished")
    return state


def _update_grid(cfg: Config, spec: MoFaNeRF, params, batch: Batch, grid: OccupancyGrid,
                 density_ema: torch.Tensor):
    """One EMA update of the grid from the COARSE field under the batch's
    conditioning (the fine field is unconstrained off its importance samples)."""
    with torch.no_grad():
        tex = encode_texture(params, spec, batch.uv_map)
        cond = prepare_conditioning(params, spec, batch.shape_code,
                                    exp_code_for(params, batch.exp_type), tex)
        return update_occupancy_grid(grid, density_ema, params["coarse"], spec.coarse,
                                     cond.coarse, cfg.grid_ema_decay,
                                     cfg.grid_density_threshold, spec.render.sigma_activation)


def _frame_cond(spec, state, ds, idx, uv_cache, device):
    params = state.params
    with torch.no_grad():
        tex = encode_texture(params, spec, _uv_map(ds, spec, int(ds.id_codes[idx]), uv_cache,
                                                   device))
        return prepare_conditioning(
            params, spec, torch.from_numpy(ds.shape_codes[idx]).to(device),
            exp_code_for(params, int(ds.exp_types[idx])), tex)


def _render_orbit(cfg, spec, state, ds, rng, exp_dir, step, uv_cache, device):
    """The orbit over `render_poses` for a random training frame's codes,
    as PNG frames (the port writes no video)."""
    train_i = int(rng.choice(ds.i_split[0]))
    cond = _frame_cond(spec, state, ds, train_i, uv_cache, device)
    rgbs, _ = render_path(state.params, spec, cond, ds.render_poses, ds.hwf,
                          render_factor=max(2, cfg.render_factor))
    out_dir = os.path.join(exp_dir, f"video_{step:06d}")
    os.makedirs(out_dir, exist_ok=True)
    for k, rgb in enumerate(rgbs):
        write_png(os.path.join(out_dir, f"{k:03d}.png"), to8b(rgb))


def _render_test_image(spec, state, ds, K, rng, exp_dir, step, uv_cache, device):
    """A half-resolution render of a random held-out frame."""
    test_i = int(rng.choice(ds.i_split[2]))
    cond = _frame_cond(spec, state, ds, test_i, uv_cache, device)
    H, W, _ = ds.hwf
    out = render_frame(state.params, spec, cond, H // 2, W // 2, K / 2, ds.poses[test_i][:3])
    out_dir = os.path.join(exp_dir, f"testset_{step:06d}")
    os.makedirs(out_dir, exist_ok=True)
    write_png(os.path.join(out_dir, f"{test_i:03d}.png"), to8b(out["rgb"]))
