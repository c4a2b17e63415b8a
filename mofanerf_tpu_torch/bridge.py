"""Carry parameters between the JAX package and the port.

A JAX param tree handed over as numpy arrays (`jax.tree.map(np.asarray, p)`)
becomes the port's tree of tensors with the same nesting and the same
[in, out] weight layout, so `x @ W` means the same on both sides. Covers the
student (`input`, `layers[i]`, `sigma`, `feat`, `view.w_dirs`, `rgb`, and
`cond.{w_in, w_layers}` when cond_dim > 0) and the teacher parts the serving
path reads: the ISM and the [21, 30] `exp_codes` bank; the whole teacher
(`model_params_to_torch`) and a training state with its Adam moments
(`train_state_to_torch`); RefineNet's flax variables (`refine_params_to_torch`:
HWIO kernels to OIHW, transposed-conv kernels flipped), its VGG
(`vgg_to_torch`) and its training state (`refine_state_to_torch`); the
preprocessing networks' folded variables (`bisenet_params_to_torch`,
`hourglass_params_to_torch`: HWIO kernels to OIHW, the folded BatchNorm
pairs as they are).

Trees are also flattened by JAX key path (`['layers'][0]['w']`), in JAX's
leaf order (dict keys sorted), which is how student artifacts name their
arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from mofanerf_tpu_torch.models.field import FieldConfig, field_param_shapes
from mofanerf_tpu_torch.models.student import StudentConfig, student_param_shapes
from mofanerf_tpu_torch.models.tex_encoder import CONV_WIDTHS, TextureEncoder
from mofanerf_tpu_torch.render.renderer import N_EXP_SLOTS, MoFaNeRF
from mofanerf_tpu_torch.utils.device import resolve_device
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr, map_tree  # noqa: F401 (re-exported)

Params = Dict[str, Any]


def _check_shapes(tree, shapes, where: str = "") -> None:
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"param tree{where}: expected keys {sorted(shapes)}, got {got}")
        for k in shapes:
            _check_shapes(tree[k], shapes[k], f"{where}[{k!r}]")
    elif isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            raise ValueError(f"param tree{where}: expected a list of {len(shapes)}")
        for i, s in enumerate(shapes):
            _check_shapes(tree[i], s, f"{where}[{i}]")
    elif tuple(tree.shape) != tuple(shapes):
        raise ValueError(f"param {where}: shape {tuple(tree.shape)} != {tuple(shapes)}")


def to_torch(tree, device="cuda"):
    """numpy leaves -> tensors on `device`, dtype kept."""
    dev = resolve_device(device)
    return map_tree(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def to_numpy(tree):
    """tensor leaves -> numpy arrays (for `jax.tree.map(jnp.asarray, ...)`)."""
    return map_tree(lambda t: t.detach().cpu().numpy(), tree)


def student_to_torch(tree, cfg: StudentConfig, device="cuda") -> Params:
    """A JAX student param tree (numpy leaves) -> the port's student params,
    checked leaf by leaf against `cfg`'s layout."""
    _check_shapes(tree, student_param_shapes(cfg))
    return to_torch(tree, device)


def field_to_torch(tree, cfg: FieldConfig, device="cuda") -> Params:
    """A JAX conditioned-field param tree (numpy leaves) -> the port's field
    params, checked leaf by leaf against `cfg`'s layout."""
    _check_shapes(tree, field_param_shapes(cfg))
    return to_torch(tree, device)


def tex_encoder_to_torch(variables, tex_dim: int = 256, uv_size: int = 512,
                         device="cuda") -> Params:
    """The flax variables of the JAX TextureEncoder (`{"params": {Conv_0..6,
    Dense_0, mu, decoding_0..2}}`, numpy leaves) -> the state dict of the
    port's TextureEncoder, checked against its shapes."""
    p = variables["params"]
    names = {f"convs.{i}": f"Conv_{i}" for i in range(len(CONV_WIDTHS))}
    names.update({"fc": "Dense_0", "mu": "mu"})
    names.update({f"decoding.{i}": f"decoding_{i}" for i in range(3)})
    if set(p) != set(names.values()):
        raise ValueError(f"texture encoder: expected layers {sorted(names.values())}, "
                         f"got {sorted(p)}")
    state = {}
    for ours, theirs in names.items():
        kernel = np.asarray(p[theirs]["kernel"])
        state[f"{ours}.weight"] = np.ascontiguousarray(
            kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T)
        state[f"{ours}.bias"] = np.asarray(p[theirs]["bias"])
    want = TextureEncoder(tex_dim, uv_size, device="meta").state_dict()
    _check_shapes(state, {k: tuple(v.shape) for k, v in want.items()})
    return to_torch(state, device)


def serving_params_to_torch(model_params, device="cuda") -> Params:
    """The teacher parts the serving path reads, from a JAX model param tree
    (numpy leaves): {"ism": ..., "exp_codes": [21, exp_dim]}. The whole tree
    goes through `model_params_to_torch`."""
    ism = model_params["ism"]
    exp_codes = np.asarray(model_params["exp_codes"])
    exp_dim = np.shape(ism["scale"]["w"])[1]
    if exp_codes.shape != (N_EXP_SLOTS, exp_dim):
        raise ValueError(
            f"exp_codes shape {exp_codes.shape} != ({N_EXP_SLOTS}, {exp_dim})")
    return to_torch({"ism": ism, "exp_codes": exp_codes}, device)


def model_params_to_torch(model_params, spec: MoFaNeRF, device="cuda") -> Params:
    """The whole tree of the JAX `init_model_params` (numpy leaves) -> the
    port's model params: `coarse`, `fine`, `ism`, `tex_encoder`, `exp_codes`."""
    want = {"coarse", "fine", "ism", "tex_encoder", "exp_codes"}
    if set(model_params) != want:
        raise ValueError(f"model params: expected keys {sorted(want)}, got {sorted(model_params)}")
    out = serving_params_to_torch(model_params, device)
    if out["exp_codes"].shape[1] != spec.exp_dim:
        raise ValueError(f"exp_codes are {out['exp_codes'].shape[1]}-dim, the spec's {spec.exp_dim}")
    out["coarse"] = field_to_torch(model_params["coarse"], spec.coarse, device)
    out["fine"] = field_to_torch(model_params["fine"], spec.fine, device)
    out["tex_encoder"] = tex_encoder_to_torch(model_params["tex_encoder"], spec.tex_dim,
                                              spec.uv_size, device)
    return out


def train_state_to_torch(state, spec: MoFaNeRF, device="cuda"):
    """A JAX TrainState (numpy leaves: `jax.tree.map(np.asarray, state)`) ->
    the port's TrainState. optax.adam's state `(ScaleByAdamState(count, mu,
    nu), ScaleByScheduleState(count))` becomes one AdamState: the two counts
    advance and revert together, so they must agree."""
    from mofanerf_tpu_torch.train.state import AdamState, TrainState

    dev = resolve_device(device)
    adam, sched = state.opt_state
    count = int(np.asarray(adam.count))
    if count != int(np.asarray(sched.count)):
        raise ValueError(f"optimiser counts differ: adam {count}, schedule "
                         f"{int(np.asarray(sched.count))}")
    as_int = lambda v: torch.tensor(int(np.asarray(v)), dtype=torch.int32, device=dev)
    return TrainState(
        params=model_params_to_torch(state.params, spec, dev),
        opt_state=AdamState(as_int(count), model_params_to_torch(adam.mu, spec, dev),
                            model_params_to_torch(adam.nu, spec, dev)),
        step=as_int(state.step),
    )


def fit_state_to_torch(state, device="cuda"):
    """A JAX FitState (numpy leaves: `jax.tree.map(np.asarray, state)`) -> the
    port's FitState. optax.multi_transform's state holds, for each group of
    `train/fit.py::FIT_GROUPS`, `(ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count))` with the group's codes in mu and nu; the
    two counts advance together, so they must agree."""
    from mofanerf_tpu_torch.train.fit import FIT_GROUPS, FitCodes, FitState
    from mofanerf_tpu_torch.train.state import AdamState

    dev = resolve_device(device)
    as_int = lambda v: torch.tensor(int(np.asarray(v)), dtype=torch.int32, device=dev)
    as_f32 = lambda v: torch.from_numpy(np.array(v, np.float32)).to(dev)
    opt = {}
    for group, names in FIT_GROUPS.items():
        adam, sched = state.opt_state.inner_states[group].inner_state
        if int(np.asarray(adam.count)) != int(np.asarray(sched.count)):
            raise ValueError(f"{group}: optimiser counts differ: adam "
                             f"{int(np.asarray(adam.count))}, schedule "
                             f"{int(np.asarray(sched.count))}")
        opt[group] = AdamState(as_int(adam.count),
                               {n: as_f32(getattr(adam.mu, n)) for n in names},
                               {n: as_f32(getattr(adam.nu, n)) for n in names})
    codes = FitCodes(*[as_f32(getattr(state.codes, n)) for n in FitCodes._fields])
    return FitState(codes, opt, as_int(state.step))



def _flax_paths(module) -> Dict[str, tuple]:
    """{torch layer name: (flax path, kind)} of a RefineNet module. Its
    convolutions, transposed convolutions and ResNet blocks are numbered in
    the order the torch module registers them, which is the JAX module's
    order of creation (`Conv_k`, `ConvTranspose_k`, `ResnetBlock_k`); the
    discriminator's `scales.k` is `scale_k`."""
    from mofanerf_tpu_torch.models.refine.discriminator import MultiscaleDiscriminator
    from mofanerf_tpu_torch.models.refine.generator import ResnetBlock

    out: Dict[str, tuple] = {}
    counts: Dict[str, int] = {}

    def nested(prefix, child, flax_name):
        for name, (path, kind) in _flax_paths(child).items():
            out[f"{prefix}.{name}"] = ((flax_name,) + path, kind)

    def walk(m, prefix):
        for name, child in m.named_children():
            here = f"{prefix}{name}"
            if isinstance(m, MultiscaleDiscriminator) and name == "scales":
                for k, scale in enumerate(child):
                    nested(f"{here}.{k}", scale, f"scale_{k}")
                continue
            kind = ("ConvTranspose" if isinstance(child, torch.nn.ConvTranspose2d)
                    else "Conv" if isinstance(child, torch.nn.Conv2d)
                    else "ResnetBlock" if isinstance(child, ResnetBlock) else None)
            if kind is None:
                walk(child, here + ".")
                continue
            k = counts.get(kind, 0)
            counts[kind] = k + 1
            if kind == "ResnetBlock":
                nested(here, child, f"ResnetBlock_{k}")
            else:
                out[here] = ((f"{kind}_{k}",), kind)

    walk(module, "")
    return out


def refine_params_to_torch(variables, module, device="cuda") -> Params:
    """The flax variables of a JAX RefineNet module (`{"params": ...}`, numpy
    leaves) -> the state dict of the port's `module` (GlobalGenerator,
    LocalEnhancer, MultiscaleDiscriminator, InstanceFeatureEncoder): HWIO
    kernels to OIHW, transposed-conv kernels flipped in both spatial axes and
    laid out [in, out, kh, kw] (models/refine/generator.py), checked against
    the module's shapes."""
    p = variables["params"]
    state = {}
    for name, (path, kind) in _flax_paths(module).items():
        leaf = p
        for key in path:
            leaf = leaf[key]
        kernel = np.asarray(leaf["kernel"], np.float32)
        if kind == "ConvTranspose":
            kernel = kernel[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            kernel = kernel.transpose(3, 2, 0, 1)
        state[f"{name}.weight"] = np.ascontiguousarray(kernel)
        state[f"{name}.bias"] = np.asarray(leaf["bias"], np.float32)
    _check_shapes(state, {k: tuple(v.shape) for k, v in module.state_dict().items()})
    return to_torch(state, device)


def vgg_to_torch(variables, device="cuda") -> Params:
    """The JAX VGG19Features variables (numpy leaves) -> the port's state dict."""
    from mofanerf_tpu_torch.models.refine.losses import vgg_from_jax_layout

    return to_torch(vgg_from_jax_layout(variables), device)


def refine_state_to_torch(state, cfg, device="cuda"):
    """A JAX RefineState (numpy leaves: `jax.tree.map(np.asarray, state)`) ->
    the port's RefineState: both players' params, and optax.adam's state
    `(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))` as one
    AdamState each (the two counts must agree)."""
    from mofanerf_tpu_torch.train.refine import RefineState, build_models
    from mofanerf_tpu_torch.train.state import AdamState

    dev = resolve_device(device)
    g, d = build_models(cfg)
    as_int = lambda v: torch.tensor(int(np.asarray(v)), dtype=torch.int32, device=dev)

    def opt(o, module):
        adam, sched = o
        if int(np.asarray(adam.count)) != int(np.asarray(sched.count)):
            raise ValueError(f"optimiser counts differ: adam {int(np.asarray(adam.count))}, "
                             f"schedule {int(np.asarray(sched.count))}")
        return AdamState(as_int(adam.count), refine_params_to_torch(adam.mu, module, dev),
                         refine_params_to_torch(adam.nu, module, dev))

    return RefineState(refine_params_to_torch(state.g_params, g, dev),
                       refine_params_to_torch(state.d_params, d, dev),
                       opt(state.g_opt, g), opt(state.d_opt, d), as_int(state.step))


def _flax_to_state(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested flax params -> flat torch names: a path joined by dots, a conv
    `kernel` (HWIO) becoming `weight` (OIHW), every other leaf kept."""
    out: Dict[str, np.ndarray] = {}
    for key, leaf in tree.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, dict):
            out.update(_flax_to_state(leaf, name + "."))
        elif key == "kernel":
            out[f"{prefix}weight"] = np.ascontiguousarray(np.asarray(leaf).transpose(3, 2, 0, 1))
        else:
            out[name] = np.asarray(leaf)
    return out


def bisenet_params_to_torch(variables, device="cuda") -> Params:
    """The JAX BiSeNet's flax variables (numpy leaves; BatchNorms folded into
    `bn_scale` / `bn_shift`, kept as they are) -> the port's BiSeNet
    parameters (preprocess/segment.py), checked against its layout."""
    from mofanerf_tpu_torch.preprocess.segment import BiSeNet, state_to_device

    return state_to_device(_flax_to_state(variables["params"]), BiSeNet, resolve_device(device))


def hourglass_params_to_torch(variables, device="cuda") -> Params:
    """The JAX HourglassNet's flax variables (numpy leaves) -> the port's
    HourglassNet parameters (preprocess/relight.py), checked against its
    layout."""
    from mofanerf_tpu_torch.preprocess.relight import HourglassNet
    from mofanerf_tpu_torch.preprocess.segment import state_to_device

    return state_to_device(_flax_to_state(variables["params"]), HourglassNet,
                           resolve_device(device))
