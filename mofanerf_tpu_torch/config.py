"""Dataclass config with file + CLI merge (counterpart of
mofanerf_tpu/config.py, with torch dtypes in `model_spec`).

Reads the reference's `key = value  # comment` config-file format, so the
shipped `configs/exp_mofanerf.txt` works unchanged. Flag names match the
reference's where a counterpart exists, and every flag of the JAX package's
config is kept (training, the device-resident data pipeline and occupancy
upkeep read theirs), so that one config file serves both packages.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from mofanerf_tpu_torch.models.field import FieldConfig
from mofanerf_tpu_torch.render.renderer import MoFaNeRF, RenderConfig


@dataclasses.dataclass
class Config:
    """All experiment flags (defaults = the reference's parser + the shipped
    configs/exp_mofanerf.txt values)."""

    # experiment / paths
    expname: str = "mofanerf"
    basedir: str = "./logs"
    datadir: str = "./data/multiViewImages"
    uvdir: str = "./data/textureMap300"
    shape_codes_path: str = "./data/factors_id.npy"
    landmarks_path: str = "./data/1_975_landmarks.npy"
    person_num: int = 300
    config: Optional[str] = None

    # network sizes
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 10
    netwidth_fine: int = 1024
    input_ch_shapeCodes: int = 50
    input_ch_textureCodes: int = 256
    input_ch_expCodes: int = 30
    multires: int = 10
    multires_views: int = 4

    # training
    N_rand: int = 1024
    lrate: float = 5e-5
    lrate_decay: int = 250
    chunk: int = 196608
    netchunk: int = 196608
    no_batching: bool = True
    no_reload: bool = False
    precrop_iters: int = 500
    precrop_frac: float = 0.5
    n_iters: int = 600000
    # landmark-bias anneal (see data/landmarks.py::anneal_lm_frac): ramp the
    # biased fraction 0 -> lm_frac over lm_frac_anneal_iters steps
    lm_frac: float = 0.6
    lm_frac_anneal_iters: int = 10000

    # training-time occupancy-grid maintenance (ops/occupancy.py): EMA
    # re-probe every i_grid steps; grid_warmup delays the first probe until
    # the field has structure. i_grid = 0 disables maintenance.
    i_grid: int = 500
    grid_warmup: int = 1000
    grid_resolution: int = 64
    grid_density_threshold: float = 1.0
    grid_ema_decay: float = 0.95

    # rendering
    N_samples: int = 64
    N_importance: int = 64
    perturb: float = 1.0
    use_viewdirs: bool = True
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    half_res: bool = False
    testskip: int = 8
    render_factor: int = 0
    near: float = 8.0
    far: float = 26.0
    lindisp: bool = False
    sigma_activation: str = "relu"  # 'softplus' = training-stability option

    # precision / packeting
    compute_dtype: str = "bfloat16"   # hot-path matmul dtype
    packet_size: int = 8192           # rays a packet of a full frame

    # device-resident data pipeline (data/device_data.py): keep the train
    # split in device memory and sample batches there, scan_steps optimizer
    # steps per dispatch (0 = auto from the logging intervals); use when the
    # split fits device memory (uint8 images).
    device_data: bool = False
    scan_steps: int = 0
    # biased-ray source for the device sampler: 'auto' (landmarks when
    # available, else foreground reservoir), 'landmarks', 'fg', 'none', or
    # 'expdelta' — reservoirs of pixels where the frame differs from its
    # same-pose siblings under other expressions, concentrating gradient
    # on expression-informative regions (data/device_data.py)
    ray_bias: str = "auto"

    # logging / checkpoint intervals
    i_print: int = 100
    i_img: int = 5000
    i_weights: int = 100000
    i_testset: int = 100000
    i_video: int = 50000

    # dataset
    dataset_type: str = "blender"
    uv_size: int = 512                # UV map side; >=128 (encoder = 7
                                      # stride-2 convs). Smaller sides cut
                                      # the texture-encoder cost per step.

    def model_spec(self) -> MoFaNeRF:
        dt = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
        return MoFaNeRF(
            coarse=FieldConfig(
                depth=self.netdepth, width=self.netwidth,
                multires=self.multires, multires_views=self.multires_views,
                shape_dim=self.input_ch_shapeCodes,
                exp_dim=self.input_ch_expCodes,
                tex_dim=self.input_ch_textureCodes,
                compute_dtype=dt,
            ),
            fine=FieldConfig(
                depth=self.netdepth_fine, width=self.netwidth_fine,
                multires=self.multires, multires_views=self.multires_views,
                shape_dim=self.input_ch_shapeCodes,
                exp_dim=self.input_ch_expCodes,
                tex_dim=self.input_ch_textureCodes,
                compute_dtype=dt,
            ),
            render=RenderConfig(
                n_coarse=self.N_samples, n_importance=self.N_importance,
                perturb=self.perturb, raw_noise_std=self.raw_noise_std,
                white_bkgd=self.white_bkgd, near=self.near, far=self.far,
                lindisp=self.lindisp, packet_size=self.packet_size,
                sigma_activation=self.sigma_activation,
            ),
            shape_dim=self.input_ch_shapeCodes,
            exp_dim=self.input_ch_expCodes,
            tex_dim=self.input_ch_textureCodes,
            uv_size=self.uv_size,
        )


def _coerce(value: str, typ):
    if typ is bool or typ == Optional[bool]:
        return value.strip().lower() in ("true", "1", "yes")
    if typ is int:
        return int(float(value))
    if typ is float:
        return float(value)
    return value.strip()


def parse_config_file(path: str) -> dict:
    """Parse the reference's `key = value  # comment` file format."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def load_config(argv: Optional[list] = None, defaults: Optional[Config] = None) -> Config:
    """CLI + config-file merged Config (file values override defaults; CLI
    overrides the file — same precedence as configargparse)."""
    base = defaults or Config()
    fields = {f.name: f for f in dataclasses.fields(Config)}

    parser = argparse.ArgumentParser()
    for name in fields:
        parser.add_argument(f"--{name}", type=str, default=None)
    args, _ = parser.parse_known_args(argv)

    values = dataclasses.asdict(base)
    cfg_path = args.config or values.get("config")
    if cfg_path:
        file_vals = parse_config_file(cfg_path)
        for k, v in file_vals.items():
            if k in fields:
                ftype = type(values[k]) if values[k] is not None else str
                values[k] = _coerce(v, ftype)
    for name in fields:
        cli_val = getattr(args, name)
        if cli_val is not None:
            ftype = type(values[name]) if values[name] is not None else str
            values[name] = _coerce(cli_val, ftype)
    return Config(**values)
