"""Per-avatar distillation of the teacher's conditioned fine field into a
small student for the serving path, and the student artifacts (counterpart
of mofanerf_tpu/train/distill.py).

Distillation is in point space: each step draws a batch of (point,
direction) pairs -- half along random orbit rays through the sampling box,
half uniform in it -- and the student matches the teacher's activated
outputs there: rgb error weighted by the teacher's local opacity, density in
log1p space, and a linear pull on the student's raw density where it sits in
relu's dead zone under teacher mass.

The teacher's queries are inference: they go through the fused field kernel
(`ops/field_kernel.py::fused_field_apply`, one sample a ray), its operands
packed once a distillation; a conditioned distillation draws a new teacher
conditioning every step and swaps only the biases it folds into
(`rebias_fused_params`). The student is plain differentiable PyTorch
(`point_apply` under autograd), updated by Adam at a constant rate, as
`optax.adam(lr)`. Nothing is read back to the host within a step: the loss
is read at log windows only.

The random draws come from a device `torch.Generator` seeded from `seed`, or
are injected a step at a time (`draws`: step -> {name: tensor}), with the
names and shapes of the JAX draws: `pts_u` U(0,1) [n_uni, 3], `dirs_u`
N(0,1) [n_uni, 3], `o_dir` N(0,1) [n_ray, 3], `targets` U(0,1) [n_ray, 3],
`t` U(0,1) [n_ray]; a conditioned step also `exp_i`, `exp_j` (bank rows),
`exp_a` (the mix weight, U(-0.25, 1.25) before its clip) and, for avatars,
`avatar`.

An artifact is one `.npz`: the student's f32 params keyed by JAX key path
(`['layers'][0]['w']`) plus a JSON `__meta__` holding the StudentConfig
(compute_dtype by dtype name) and an optional provenance block. The port
reads and writes exactly the JAX package's format, so artifacts move between
the two packages both ways.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from mofanerf_tpu_torch.bridge import flatten_with_keystr
from mofanerf_tpu_torch.models.field import FieldConfig, fold_conditioning
from mofanerf_tpu_torch.models.ism import modulate_expression
from mofanerf_tpu_torch.models.student import (StudentConfig, init_point_field, point_apply,
                                               refold_cond, student_param_shapes)
from mofanerf_tpu_torch.ops.bounds import DEFAULT_AABB_MAX, DEFAULT_AABB_MIN
from mofanerf_tpu_torch.ops.composite import sigma_act
from mofanerf_tpu_torch.ops.embed import fourier_embed
from mofanerf_tpu_torch.ops.field_kernel import (FusedParams, fused_field_apply,
                                                 pack_fused_params, rebias_fused_params)
from mofanerf_tpu_torch.render.renderer import N_EXPRESSIONS
from mofanerf_tpu_torch.train.state import Adam, AdamState
from mofanerf_tpu_torch.utils.device import f32_products, resolve_device
from mofanerf_tpu_torch.utils.tree import tree_leaves, tree_unflatten

Params = Dict[str, Any]
Draws = Dict[str, torch.Tensor]

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Distillation settings (fields and defaults as the JAX DistillConfig)."""
    arch: str = "mlp"             # "mlp" (the lean StudentConfig) | "field"
    depth: int = 4
    width: int = 128
    skip: int = -1                # mlp arch: pe re-injection layer (-1 off)
    multires: int = 0             # 0: the teacher's band count
    cond_dim: int = 0             # > 0 (mlp arch): a code-conditioned student
    n_steps: int = 2000
    batch: int = 32768
    lr: float = 1e-3
    ray_frac: float = 0.5         # share of the points drawn along view rays
    cam_radius: float = 16.0      # ray origins orbit the head at this radius
    near: float = 8.0
    far: float = 26.0
    aabb_min: Tuple[float, float, float] = DEFAULT_AABB_MIN
    aabb_max: Tuple[float, float, float] = DEFAULT_AABB_MAX
    teacher_sigma_activation: str = "relu"  # the teacher's training activation;
                                  # the student always serves relu
    compute_dtype: Any = torch.bfloat16

    def student_config(self, teacher: FieldConfig):
        """The lean unconditioned or code-conditioned MLP (models/student.py),
        or with arch='field' the trunk architecture with 1-dim codes."""
        mr = self.multires or teacher.multires
        if self.arch == "mlp":
            return StudentConfig(
                depth=self.depth, width=self.width, skip=self.skip,
                multires=mr, multires_views=teacher.multires_views,
                cond_dim=self.cond_dim, compute_dtype=self.compute_dtype,
            )
        if self.cond_dim:
            raise ValueError("conditioned students use arch='mlp'")
        return FieldConfig(
            depth=self.depth, width=self.width,
            multires=mr, multires_views=teacher.multires_views,
            shape_dim=1, exp_dim=1, tex_dim=1,
            compute_dtype=self.compute_dtype,
        )


class StudentState(NamedTuple):
    params: Params
    cond: Any           # folded zero-code conditioning (field arch) or None (mlp arch)
    opt_state: Any      # AdamState
    step: torch.Tensor  # int32 scalar


class Teacher(NamedTuple):
    """The teacher field as the fused field kernel reads it."""
    fused: FusedParams       # B1's operands for the current conditioning
    w_dirs: torch.Tensor     # view.w_dirs [views_embed_dim, W/2] f32
    cfg: FieldConfig


def pack_teacher(params: Params, cfg: FieldConfig, cond: Params) -> Teacher:
    """Cast and tile the teacher's weights for the kernel, once a distillation."""
    with torch.no_grad():
        return Teacher(pack_fused_params(params, cond, cfg), params["view"]["w_dirs"], cfg)


def init_student(generator: torch.Generator, cfg, lr: float = 1e-3, device="cuda"):
    """(StudentState, Adam at the constant rate `lr`), the params drawn from
    `generator`. The sigma head's bias starts 0.5 up: a student whose raw
    density is negative everywhere gets no density gradient through relu and
    stays empty."""
    dev = resolve_device(device)
    params = dict(init_point_field(generator, cfg, device=dev)[0])
    if isinstance(cfg, StudentConfig):
        params["sigma"] = dict(params["sigma"], b=params["sigma"]["b"] + 0.5)
    else:   # the field arch keeps the trunk layout: the alpha head sits in sigma
        alpha = params["sigma"]["alpha"]
        params["sigma"] = dict(params["sigma"], alpha=dict(alpha, b=alpha["b"] + 0.5))
    tx = Adam(lrate=lr, lrate_decay=None)
    return StudentState(params, refold_cond(params, cfg), tx.init(params),
                        torch.zeros((), dtype=torch.int32, device=dev)), tx


def _draw(draws: Draws | None, generator, name: str, shape, normal: bool, dev) -> torch.Tensor:
    if draws is not None and name in draws:
        return torch.as_tensor(draws[name], dtype=torch.float32).to(dev)
    if generator is None:
        raise ValueError(f"the draw {name!r} needs injected draws or a torch.Generator")
    fn = torch.randn if normal else torch.rand
    return fn(shape, generator=generator, dtype=torch.float32, device=generator.device).to(dev)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


@functools.lru_cache(maxsize=16)
def _box(aabb_min, aabb_max, device: torch.device):
    """The sampling box on `device`, made once: a copy from host memory per
    step would wait for the card's queued work."""
    return (torch.tensor(aabb_min, dtype=torch.float32, device=device),
            torch.tensor(aabb_max, dtype=torch.float32, device=device))


def _sample_points(dcfg: DistillConfig, batch: int, device, draws: Draws | None = None,
                   generator: torch.Generator | None = None):
    """(pts [B,3], dirs [B,3]): `ray_frac` of the batch along random orbit
    rays clipped to the box, first, then the rest uniform in the box with
    random directions."""
    dev = torch.device(device)
    lo, hi = _box(tuple(dcfg.aabb_min), tuple(dcfg.aabb_max), dev)
    n_ray = int(batch * dcfg.ray_frac)
    n_uni = batch - n_ray

    def draw(name, shape, normal=False):
        return _draw(draws, generator, name, shape, normal, dev)

    # uniform coverage
    pts_u = lo + draw("pts_u", (n_uni, 3)) * (hi - lo)
    dirs_u = _unit(draw("dirs_u", (n_uni, 3), normal=True))
    # view-distribution points: origins on the camera orbit sphere, rays
    # toward a jittered point in the volume, depths uniform in [near, far]
    origins = _unit(draw("o_dir", (n_ray, 3), normal=True)) * dcfg.cam_radius
    targets = lo + draw("targets", (n_ray, 3)) * (hi - lo)
    d = _unit(targets - origins)
    t = dcfg.near + draw("t", (n_ray,)) * (dcfg.far - dcfg.near)
    pts_r = torch.minimum(torch.maximum(origins + d * t[:, None], lo), hi)
    return torch.cat([pts_r, pts_u]), torch.cat([d, dirs_u])


def _field_raw(params: Params, cfg, cond, pts: torch.Tensor, dirs: torch.Tensor):
    """Raw (rgb [N,3], sigma [N]) in f32 of a differentiable field (the
    student) at points/dirs."""
    pe = fourier_embed(pts, cfg.multires)
    dirf = fourier_embed(dirs, cfg.multires_views) @ params["view"]["w_dirs"]
    raw_rgb, raw_sigma = point_apply(params, cond, pe, dirf, cfg)
    return raw_rgb.float(), raw_sigma[:, 0].float()


def _teacher_raw(teacher: Teacher, pts: torch.Tensor, dirs: torch.Tensor):
    """Raw (rgb [N,3], sigma [N]) in f32 of the teacher through the fused
    field kernel, each point a ray of one sample."""
    cfg = teacher.cfg
    with torch.no_grad():
        pe = fourier_embed(pts, cfg.multires).contiguous()
        dirf = (fourier_embed(dirs, cfg.multires_views) @ teacher.w_dirs).contiguous()
        raw_rgb, raw_sigma = fused_field_apply(teacher.fused, pe, dirf, cfg, samples_per_ray=1)
    return raw_rgb, raw_sigma[:, 0]


def _field_outputs(raw, sigma_activation: str = "relu"):
    """Activated (rgb [N,3], sigma [N]) from raw outputs."""
    raw_rgb, raw_sigma = raw
    return torch.sigmoid(raw_rgb), sigma_act(sigma_activation)(raw_sigma)


def distill_loss(student_params: Params, student_cfg, student_cond, teacher: Teacher,
                 pts: torch.Tensor, dirs: torch.Tensor, teacher_sigma_activation: str = "relu"):
    """(loss, {loss_rgb, loss_sigma, loss_dead}) of the student against the
    teacher at points/dirs, differentiable in `student_params`. The teacher's
    density is read with its training activation, the student's with relu."""
    rgb_t, sig_t = _field_outputs(_teacher_raw(teacher, pts, dirs), teacher_sigma_activation)
    raw_rgb_s, raw_sig_s = _field_raw(student_params, student_cfg, student_cond, pts, dirs)
    rgb_s = torch.sigmoid(raw_rgb_s)
    sig_s = torch.relu(raw_sig_s)
    # rgb matters where the teacher has mass: weight by local opacity at a
    # nominal step (about the serving sample spacing)
    w = 1.0 - torch.exp(-sig_t * 0.25)
    loss_rgb = torch.mean(w[:, None] * (rgb_s - rgb_t) ** 2)
    loss_sig = torch.mean((torch.log1p(sig_s) - torch.log1p(sig_t)) ** 2)
    # relu dead-zone rescue: where the teacher has density and the student's
    # raw sigma is negative, the log1p term has no gradient; a linear pull on
    # the raw value restores it there and vanishes once the point is alive
    dead = (sig_t > 0.01) & (raw_sig_s < 0.0)
    loss_dead = torch.mean(torch.where(dead, -raw_sig_s * torch.log1p(sig_t),
                                       torch.zeros_like(raw_sig_s)))
    return loss_rgb + loss_sig + loss_dead, {
        "loss_rgb": loss_rgb, "loss_sigma": loss_sig, "loss_dead": loss_dead,
    }


def _update(state: StudentState, tx: Adam, student_cfg, loss_of):
    """One Adam step of the student on `loss_of(params) -> (loss, metrics)`;
    returns (new state, detached metrics with "loss")."""
    leaves = tree_leaves(state.params)
    with f32_products():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = loss_of(tree_unflatten(state.params, live))
        grads = list(torch.autograd.grad(loss, live, allow_unused=True,
                                         materialize_grads=True))
    new_p, mu, nu, count = tx.update(grads, state.opt_state, leaves)
    params = tree_unflatten(state.params, new_p)
    with torch.no_grad():
        cond = refold_cond(params, student_cfg)
    opt = AdamState(count, tree_unflatten(state.opt_state.mu, mu),
                    tree_unflatten(state.opt_state.nu, nu))
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    return StudentState(params, cond, opt, state.step + 1), metrics


def distill_step(state: StudentState, tx: Adam, teacher: Teacher, dcfg: DistillConfig,
                 student_cfg, draws: Draws | None = None,
                 generator: torch.Generator | None = None):
    """One distillation step of an unconditioned student: (state, metrics)."""
    dev = state.step.device
    pts, dirs = _sample_points(dcfg, dcfg.batch, dev, draws, generator)
    return _update(state, tx, student_cfg, lambda p: distill_loss(
        p, student_cfg, refold_cond(p, student_cfg), teacher, pts, dirs,
        dcfg.teacher_sigma_activation))


def _loop(n_steps: int, step, log_every: int, tag: str) -> None:
    """Run `step(i) -> loss` n_steps times, printing the loss at the end of
    each window of `log_every` steps (the only host reads of the loop)."""
    window = log_every if log_every > 0 else n_steps
    for i in range(n_steps):
        loss = step(i)
        if log_every and ((i + 1) % window == 0 or i + 1 == n_steps):
            print(f"[{tag}] step {i + 1}/{n_steps} loss {float(loss):.5f}", flush=True)


def _params_device(params: Params) -> torch.device:
    return params["view"]["w_dirs"].device


def distill(teacher_params: Params, teacher_cfg: FieldConfig, teacher_cond: Params,
            dcfg: DistillConfig = DistillConfig(), seed: int = 0, log_every: int = 0,
            draws: Callable[[int], Draws] | None = None):
    """Distil an unconditioned student from the teacher field at one folded
    conditioning, on the teacher's device. Returns (StudentState,
    student_cfg). `draws(i)` injects step i's draws."""
    if dcfg.cond_dim:
        raise ValueError("plain distill() would leave the conditioning weights untrained "
                         "(no code is sampled): use distill_expressions for cond_dim > 0")
    dev = _params_device(teacher_params)
    student_cfg = dcfg.student_config(teacher_cfg)
    state, tx = init_student(torch.Generator().manual_seed(seed), student_cfg, dcfg.lr, dev)
    teacher = pack_teacher(teacher_params, teacher_cfg, teacher_cond)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def step(i):
        nonlocal state
        state, m = distill_step(state, tx, teacher, dcfg, student_cfg,
                                draws(i) if draws else None, gen)
        return m["loss"]

    _loop(dcfg.n_steps, step, log_every, "DISTILL")
    return state, student_cfg


# ---------------------------------------------------------------------------
# Code-conditioned distillation: one student per (identity, texture) over the
# expression bank, or over several avatars
# ---------------------------------------------------------------------------

def _sample_exp_code(exp_bank: torch.Tensor, draws: Draws | None = None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """A random point on (and at the corners of) the expression simplex's
    edges: `(1 - a) * bank[i] + a * bank[j]`, the weight drawn U(-0.25, 1.25)
    and clipped to [0, 1] (point mass at the trained expressions plus the
    pairwise interpolations the rig sweeps). Stays on the device."""
    n, dev = exp_bank.shape[0], exp_bank.device

    def index(name):
        if draws is not None and name in draws:
            return torch.as_tensor(draws[name], dtype=torch.int64).reshape(1).to(dev)
        return torch.randint(0, n, (1,), generator=generator, device=generator.device).to(dev)

    i, j = index("exp_i"), index("exp_j")
    a = _draw(draws, generator, "exp_a", (), False, dev)
    if draws is None or "exp_a" not in draws:
        a = a * 1.5 - 0.25
    a = torch.clamp(a, 0.0, 1.0)
    return (1.0 - a) * torch.index_select(exp_bank, 0, i)[0] + a * torch.index_select(
        exp_bank, 0, j)[0]


def conditioned_step(state: StudentState, tx: Adam, teacher: Teacher, sample_code,
                     dcfg: DistillConfig, student_cfg, draws: Draws | None = None,
                     generator: torch.Generator | None = None):
    """One step of conditioned distillation: draw a code and the teacher's
    folded conditioning for it (`sample_code(draws, generator)`), re-bias the
    teacher's kernel operands, and match the student under that code at a
    shared point batch. Returns (state, metrics)."""
    dev = state.step.device
    with torch.no_grad():
        code, cond = sample_code(draws, generator)
        teacher = teacher._replace(fused=rebias_fused_params(teacher.fused, cond, teacher.cfg))
    pts, dirs = _sample_points(dcfg, dcfg.batch, dev, draws, generator)
    return _update(state, tx, student_cfg, lambda p: distill_loss(
        p, student_cfg, code, teacher, pts, dirs, dcfg.teacher_sigma_activation))


def distill_conditioned(teacher_params: Params, teacher_cfg: FieldConfig, sample_code,
                        dcfg: DistillConfig, seed: int = 0, log_every: int = 0,
                        tag: str = "DISTILL-COND",
                        draws: Callable[[int], Draws] | None = None):
    """Generic conditioned distillation: every step `sample_code` draws a
    member of the teacher family (a student code and the teacher's folded
    conditioning for it) and the student, whose code folds into biases,
    matches the teacher there. Returns (StudentState, student_cfg)."""
    if dcfg.cond_dim <= 0:
        raise ValueError("conditioned distillation needs cond_dim > 0")
    dev = _params_device(teacher_params)
    student_cfg = dcfg.student_config(teacher_cfg)
    state, tx = init_student(torch.Generator().manual_seed(seed), student_cfg, dcfg.lr, dev)
    zero = [torch.zeros(n, device=dev)
            for n in (teacher_cfg.shape_dim, teacher_cfg.exp_dim, teacher_cfg.tex_dim)]
    with torch.no_grad():
        teacher = pack_teacher(teacher_params, teacher_cfg,
                               fold_conditioning(teacher_params, *zero))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def step(i):
        nonlocal state
        state, m = conditioned_step(state, tx, teacher, sample_code, dcfg, student_cfg,
                                    draws(i) if draws else None, gen)
        return m["loss"]

    _loop(dcfg.n_steps, step, log_every, tag)
    return state, student_cfg


def _exp_bank(model_params: Params, exp_ids) -> torch.Tensor:
    ids = list(range(N_EXPRESSIONS)) if exp_ids is None else list(exp_ids)
    bank = model_params["exp_codes"]
    return torch.index_select(bank, 0, torch.tensor(ids, device=bank.device))


def distill_expressions(model_params: Params, spec, shape_code: torch.Tensor,
                        tex_code: torch.Tensor, dcfg: DistillConfig | None = None, exp_ids=None,
                        seed: int = 0, log_every: int = 0,
                        draws: Callable[[int], Draws] | None = None):
    """One code-conditioned student covering the expressions `exp_ids`
    (default: the 20 trained) and their pairwise mixes for one identity and
    texture; serve it with `student_code(model_params, shape, raw_exp)` as
    the code."""
    if dcfg is None:
        dcfg = DistillConfig(cond_dim=int(spec.exp_dim))
    if dcfg.cond_dim != spec.exp_dim:
        raise ValueError(f"cond_dim {dcfg.cond_dim} != exp_dim {spec.exp_dim}")
    bank = _exp_bank(model_params, exp_ids)
    teacher_params, ism = model_params["fine"], model_params["ism"]

    def sample_code(draws, generator):
        exp_mod = modulate_expression(ism, shape_code, _sample_exp_code(bank, draws, generator))
        return exp_mod, fold_conditioning(teacher_params, shape_code, exp_mod, tex_code)

    return distill_conditioned(teacher_params, spec.fine, sample_code, dcfg, seed, log_every,
                               "DISTILL-EXP", draws)


def distill_avatars(model_params: Params, spec, avatars, dcfg: DistillConfig | None = None,
                    exp_ids=None, seed: int = 0, log_every: int = 0,
                    draws: Callable[[int], Draws] | None = None):
    """One student serving several avatars (`avatars`: a list of (shape_code,
    tex_code)) across the expression bank, conditioned on [shape ; modulated
    expression]; serve it with `avatar_code(model_params, shape, raw_exp)`."""
    cond_dim = int(spec.shape_dim) + int(spec.exp_dim)
    if dcfg is None:
        dcfg = DistillConfig(cond_dim=cond_dim)
    if dcfg.cond_dim != cond_dim:
        raise ValueError(f"cond_dim {dcfg.cond_dim} != shape_dim+exp_dim {cond_dim}")
    bank = _exp_bank(model_params, exp_ids)
    shapes = torch.stack([a[0] for a in avatars])   # [A, S]
    texs = torch.stack([a[1] for a in avatars])     # [A, T]
    teacher_params, ism = model_params["fine"], model_params["ism"]

    def sample_code(draws, generator):
        if draws is not None and "avatar" in draws:
            i = torch.as_tensor(draws["avatar"], dtype=torch.int64).reshape(1).to(shapes.device)
        else:
            i = torch.randint(0, shapes.shape[0], (1,), generator=generator,
                              device=generator.device).to(shapes.device)
        shape = torch.index_select(shapes, 0, i)[0]
        tex = torch.index_select(texs, 0, i)[0]
        exp_mod = modulate_expression(ism, shape, _sample_exp_code(bank, draws, generator))
        return torch.cat([shape, exp_mod]), fold_conditioning(teacher_params, shape, exp_mod, tex)

    return distill_conditioned(teacher_params, spec.fine, sample_code, dcfg, seed, log_every,
                               "DISTILL-AVATARS", draws)


# ---------------------------------------------------------------------------
# Deployable student artifacts: one .npz per avatar
# ---------------------------------------------------------------------------

def distill_provenance(dcfg: DistillConfig, **extra) -> Dict[str, Any]:
    """Provenance block for a student artifact: the distillation AABB and
    ray bounds the student was trained inside, plus caller-supplied identity
    fields (person/expression/avatar ids; None values are dropped)."""
    prov: Dict[str, Any] = {
        "aabb_min": [float(v) for v in dcfg.aabb_min],
        "aabb_max": [float(v) for v in dcfg.aabb_max],
        "near": float(dcfg.near),
        "far": float(dcfg.far),
        "teacher_sigma_activation": dcfg.teacher_sigma_activation,
        "n_steps": int(dcfg.n_steps),
    }
    for k, v in extra.items():
        if v is not None:
            prov[k] = v
    return prov


def save_student(path: str, params: Params, cfg,
                 provenance: Dict[str, Any] | None = None) -> None:
    """Write a student as one deployable file (the JAX package's format)."""
    if not isinstance(cfg, StudentConfig):
        raise TypeError("artifacts are for StudentConfig")
    arrs = {k: v.detach().float().cpu().numpy() for k, v in flatten_with_keystr(params)}
    meta = dataclasses.asdict(cfg)
    meta["compute_dtype"] = _DTYPE_NAMES[cfg.compute_dtype]
    if provenance:
        meta["provenance"] = provenance
    np.savez(path, __meta__=json.dumps(meta), **arrs)


def load_student(path: str, with_provenance: bool = False, device="cuda"):
    """Load a save_student artifact -> (params, StudentConfig) or, with
    `with_provenance`, (params, StudentConfig, provenance-dict) where the
    dict is empty for artifacts saved without one."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        prov = meta.pop("provenance", {})
        meta["compute_dtype"] = _DTYPES[meta["compute_dtype"]]
        cfg = StudentConfig(**meta)

        def leaf(key, shape):
            arr = z[key]
            if arr.shape != tuple(shape):
                raise ValueError(f"{path}: {key} has shape {arr.shape}, "
                                 f"the config needs {tuple(shape)}")
            return torch.from_numpy(arr.astype(np.float32)).to(dev)

        def build(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: build(v, f"{prefix}[{k!r}]") for k, v in tree.items()}
            if isinstance(tree, list):
                return [build(v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
            return leaf(prefix, tree)

        params = build(student_param_shapes(cfg))
    if with_provenance:
        return params, cfg, prov
    return params, cfg


def student_code(model_params: Params, shape_code: torch.Tensor,
                 raw_exp_code: torch.Tensor) -> torch.Tensor:
    """The conditioning code an expression-conditioned student expects: the
    ISM-modulated expression latent. `raw_exp_code` is a bank latent
    (`exp_code_for`) or any convex mixture of them."""
    return modulate_expression(model_params["ism"], shape_code, raw_exp_code)


def avatar_code(model_params: Params, shape_code: torch.Tensor,
                raw_exp_code: torch.Tensor) -> torch.Tensor:
    """The conditioning code a multi-avatar student expects:
    [shape_code ; ISM-modulated expression latent]."""
    return torch.cat([shape_code, student_code(model_params, shape_code, raw_exp_code)])
