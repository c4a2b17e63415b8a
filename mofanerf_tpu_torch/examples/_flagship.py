"""What the flagship chain's scripts share: the model config from their flags,
the trained checkpoint, the face family's dataset with its held-out split by
identity and its per-identity texture codes, the ground truth rasterized on
demand, and the readings.

The chain (counterparts of the JAX package's examples/morphable_flagship.py,
serve_flagship.py, fit_quality.py, expression_matrix.py, refine_nerf_corpus.py
and wild_demo.py) trains one model at the reference's width on the procedural
face family (`studydata/faces8`) and reads it back. Its run directory defaults
to one under the temporary directory (`default_basedir`), never the JAX
package's `studydata/logs`, and its JSONs to `examples/artifacts/` of this
package (`artifact`).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from mofanerf_tpu_torch.config import Config
from mofanerf_tpu_torch.data.facescape import (load_facescape_data, load_shape_codes,
                                               read_image)
from mofanerf_tpu_torch.datagen.rasterize import rasterize_mesh
from mofanerf_tpu_torch.datagen.synthetic_faces import face_mesh
from mofanerf_tpu_torch.examples import _scenes
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning)
from mofanerf_tpu_torch.train.checkpoint import load_model
from mofanerf_tpu_torch.utils.device import to_device

ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")

# the JAX scripts' small models: serve_flagship.py and fit_quality.py (--small_model) take
# 2x8 + 2x16; morphable_flagship.py --small and wild_demo.py --small_model 2x16 + 2x32
SMALL_SERVE = dict(netdepth=2, netwidth=8, netdepth_fine=2, netwidth_fine=16, N_samples=8,
                   N_importance=8, compute_dtype="float32", packet_size=1024)
SMALL_FLAGSHIP = dict(netdepth=2, netwidth=16, netdepth_fine=2, netwidth_fine=32, N_samples=8,
                      N_importance=8, compute_dtype="float32", packet_size=1024)


# the top-level keys of each script's JSON: its JAX script's, and "device" (the card's
# name and power limit) where the JAX script writes none
JSON_KEYS = {
    "morphable_flagship": {"study", "model", "dataset", "recipe", "per_identity",
                           "mean_heldout_psnr", "mean_heldout_ssim", "mean_curtain_fraction",
                           "cross_identity", "identity_interpolation", "expression_control",
                           "device"},
    "serve_flagship": {"study", "model_step", "student", "aabb", "white_bkgd", "per_identity",
                       "mean_psnr_vs_teacher_db", "mean_ssim_vs_teacher", "fused_rays_per_sec",
                       "device"},
    "fit_quality": {"study", "model_step", "target", "schedule", "fitted_psnr_db",
                    "fitted_ssim", "code_recovery", "pose_recovery", "light_scale", "outputs",
                    "device"},
    "expression_matrix": {"study", "step", "bank", "per_id", "summary", "device"},
    "refine_synthetic": {"corpus", "generator", "steps", "train_secs",
                         "heldout_input_psnr_db", "heldout_refined_psnr_db", "psnr_gain_db",
                         "per_view", "device"},
    "refine_nerf_corpus": {"study", "corpus", "generator", "loss", "steps", "train_secs",
                           "heldout_input_psnr_db", "heldout_refined_psnr_db", "psnr_gain_db",
                           "psnr_gain_median_db", "views_improved", "views_total",
                           "min_input_psnr_db", "heldout_input_ssim", "heldout_refined_ssim",
                           "heldout_input_vgg_dist", "heldout_refined_vgg_dist", "vgg_note",
                           "per_view", "device"},
    "wild_demo": {"study", "model", "fallbacks", "note", "photos", "collage", "device"},
    "morphable_scaling": {"study", "recipe", "points", "resolution_points", "note"},
}


def artifact(name: str) -> str:
    """A JSON's (or PNG's) default path: this package's examples/artifacts/."""
    return os.path.join(ARTIFACTS, name)


def default_basedir() -> str:
    """The chain's run directory (train writes, the others read), under the temporary
    directory: the JAX scripts' `studydata/logs` holds that package's tracked logs."""
    return _scenes.default_out("mofanerf_flagship_logs")


def add_model_flags(p, data: str = "studydata/faces8", expname: str = "morphable_flagship",
                    n_ids: int = 8) -> None:
    """--data, --basedir, --expname, --n_ids (the JAX scripts' flags) and the device flags."""
    p.add_argument("--data", default=data)
    p.add_argument("--basedir", default=default_basedir())
    p.add_argument("--expname", default=expname)
    p.add_argument("--n_ids", type=int, default=n_ids,
                   help="identity count of the trained checkpoint/dataset")
    _scenes.add_device_flags(p)


def data_config(args, **kw) -> Config:
    """The Config of the flags' dataset and run directory, with `kw` on top."""
    return Config(expname=args.expname, basedir=args.basedir, datadir=args.data,
                  uvdir=os.path.join(args.data, "uv"),
                  shape_codes_path=os.path.join(args.data, "factors_id.npy"),
                  person_num=args.n_ids, **kw)


def ckpt_dir(cfg: Config) -> str:
    return os.path.join(cfg.basedir, cfg.expname, "checkpoints")


def restore(cfg: Config, spec, dev, required: bool = False):
    """(params, step) of the newest checkpoint (a `.pt`, or the JAX package's Orbax
    step) of the run; seeded weights and step None when there is none, which
    `required` refuses."""
    params, step = load_model(ckpt_dir(cfg), spec, dev)
    if step is None and required:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir(cfg)}")
    return params, step


class Faces:
    """The face family of a run: its dataset (every held-out view), shape codes,
    camera, generator parameters, held-out views by identity, and the texture
    codes and folded conditionings of the model's params, made once each."""

    def __init__(self, cfg: Config, params, spec, persons, dev):
        self.params, self.spec, self.dev = params, spec, dev
        self.codes = load_shape_codes(cfg.shape_codes_path)
        self.ds = load_facescape_data(cfg.datadir, list(persons), self.codes,
                                      uvdir=cfg.uvdir, testskip=1)
        self.H, self.W, focal = self.ds.hwf
        self.K = np.array([[focal, 0, 0.5 * self.W], [0, focal, 0.5 * self.H], [0, 0, 1]],
                          np.float32)
        self.face_params = np.load(os.path.join(cfg.datadir, "face_params.npy"))
        self.white_bkgd = cfg.white_bkgd
        self.test_idx = {}
        for i in self.ds.i_split[2]:
            self.test_idx.setdefault(int(self.ds.id_codes[i]), []).append(int(i))
        self.exp_bank = sorted(set(int(e) for e in self.ds.exp_types))
        self._tex, self._cond = {}, {}

    def uv(self, pid: int) -> torch.Tensor:
        uv = read_image(self.ds.uv_paths[pid], is_uvmap=True, uv_size=self.spec.uv_size)
        return to_device(uv, self.dev)

    def tex(self, pid: int) -> torch.Tensor:
        if pid not in self._tex:
            with torch.no_grad():
                self._tex[pid] = encode_texture(self.params, self.spec, self.uv(pid))
        return self._tex[pid]

    def shape(self, pid: int) -> torch.Tensor:
        return to_device(self.codes[pid], self.dev)

    def cond(self, pid: int, exp: int):
        if (pid, exp) not in self._cond:
            self._cond[(pid, exp)] = self.cond_of(self.shape(pid), exp, self.tex(pid))
        return self._cond[(pid, exp)]

    def cond_of(self, shape, exp: int, tex):
        with torch.no_grad():
            return prepare_conditioning(self.params, self.spec, to_device(shape, self.dev),
                                        exp_code_for(self.params, exp), tex)

    def gt(self, i: int) -> np.ndarray:
        return read_image(self.ds.image_paths[i], white_bkgd=self.white_bkgd)

    def pose(self, i: int) -> np.ndarray:
        return self.ds.poses[i][:3]

    def raster_gt(self, p, exp: int, i: int, res: int, white: bool) -> np.ndarray:
        """The true face of generator parameters `p` at expression `exp`, rasterized
        at view i's pose at res^2 (the camera scaled to it), over white when `white`."""
        Kr = self.K * (res / self.H)
        Kr[2, 2] = 1.0
        v, f, alb = face_mesh(p, exp)
        gt, _, mask = rasterize_mesh(v, f, Kr, np.asarray(self.ds.poses[i]), res, res,
                                     face_albedo=alb, device=self.dev)
        if white:
            gt = gt * mask[..., None] + (1.0 - mask[..., None])
        return gt

