"""RefineNet (pix2pixHD) adversarial training (counterpart of
mofanerf_tpu/train/refine.py).

  loss_G = LSGAN(D(A, G(A)), real) + lambda_feat * feature matching
           + lambda_feat * VGG + lambda_l1 * L1(G(A), B)
  loss_D = 0.5 * (LSGAN(D(A, G(A)).detach, fake) + LSGAN(D(A, B), real))

Two Adams (b1 0.5, b2 0.999) on `train/state.py::Adam`'s arithmetic, whose
rate is constant for `niter` epochs of steps, then falls linearly to 0 over
`niter_decay` epochs. Both gradients are taken at the old parameters before
either update, as the JAX step takes them in one program: the G loss
against D at `state.d_params`, the D loss on the old G's fake, detached.
The discriminator sees concat(A, image) on the channel axis.

The models are `nn.Module`s in NCHW; the state holds their state dicts, and
a step runs them with `torch.func.functional_call`. Inputs and outputs are
NHWC in [-1, 1], as the JAX package's. Convolutions and products run in full
f32 (TF32 off in cuBLAS and cuDNN), as the training step's do.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from mofanerf_tpu_torch.models.refine.discriminator import MultiscaleDiscriminator
from mofanerf_tpu_torch.models.refine.generator import GlobalGenerator
from mofanerf_tpu_torch.models.refine.losses import (VGG19Features, feature_matching_loss,
                                                     lsgan_loss, vgg_perceptual_loss)
from mofanerf_tpu_torch.train.state import Adam, AdamState
from mofanerf_tpu_torch.utils.device import f32_products, resolve_device
from mofanerf_tpu_torch.utils.tree import tree_leaves, tree_unflatten

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    ngf: int = 32
    ndf: int = 64
    n_downsampling: int = 4
    n_blocks: int = 9
    num_D: int = 2
    n_layers_D: int = 3
    lr: float = 1e-4
    beta1: float = 0.5
    lambda_feat: float = 10.0
    use_vgg: bool = True
    # an L1 anchor on G's output (beyond the reference, off by default)
    lambda_l1: float = 0.0
    niter: int = 19          # epochs at constant lr
    niter_decay: int = 1     # epochs of linear decay
    load_size: int = 512


class RefineState(NamedTuple):
    g_params: Params       # GlobalGenerator's state dict
    d_params: Params       # MultiscaleDiscriminator's state dict
    g_opt: AdamState
    d_opt: AdamState
    step: torch.Tensor     # int32 scalar


@functools.lru_cache(maxsize=8)
def build_models(cfg: RefineConfig):
    """(generator, discriminator): the layer structure only, on the meta
    device; the weights come from a state at call time."""
    g = GlobalGenerator(3, 3, cfg.ngf, cfg.n_downsampling, cfg.n_blocks, device="meta")
    d = MultiscaleDiscriminator(6, cfg.ndf, cfg.n_layers_D, cfg.num_D, device="meta")
    return g, d


@functools.lru_cache(maxsize=1)
def vgg_model() -> VGG19Features:
    return VGG19Features(device="meta")


@dataclasses.dataclass(frozen=True)
class RefineAdam(Adam):
    """Adam whose rate is `lr` for `const` updates, then falls linearly to 0
    over `decay` updates (in f32 on the device)."""

    const: int = 0
    decay: int = 1

    def rate(self, count: torch.Tensor):
        frac = torch.clamp((count.to(torch.float32) - self.const) / self.decay, 0.0, 1.0)
        return self.lrate * (1.0 - frac)


def make_refine_optimizers(cfg: RefineConfig, steps_per_epoch: int = 1):
    """The (G, D) Adam pair with the reference's epoch schedule, per step."""
    mk = lambda: RefineAdam(cfg.lr, None, b1=cfg.beta1, b2=0.999,
                            const=cfg.niter * steps_per_epoch,
                            decay=max(1, cfg.niter_decay * steps_per_epoch))
    return mk(), mk()


def _init_params(module: torch.nn.Module, generator: torch.Generator, device) -> Params:
    """Kernels from a truncated normal of variance 1/fan_in (flax's
    lecun_normal; a transposed conv's fan-in is kh * kw * in, as flax counts
    it), biases zero; the draws from a CPU `generator`."""
    out = {}
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            out[name] = torch.zeros(p.shape, dtype=torch.float32, device=device)
            continue
        shape = tuple(p.shape)
        is_transposed = isinstance(module.get_submodule(name.rsplit(".", 1)[0]),
                                   torch.nn.ConvTranspose2d)
        fan_in = shape[0] * shape[2] * shape[3] if is_transposed else int(np.prod(shape[1:]))
        w = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        out[name] = (w * (np.sqrt(1.0 / fan_in) / 0.87962566103423978)).to(device)
    return out


def init_refine_state(generator: torch.Generator, cfg: RefineConfig,
                      steps_per_epoch: int = 1, device="cuda") -> RefineState:
    dev = resolve_device(device)
    g, d = build_models(cfg)
    g_params = _init_params(g, generator, dev)
    d_params = _init_params(d, generator, dev)
    g_tx, d_tx = make_refine_optimizers(cfg, steps_per_epoch)
    return RefineState(g_params, d_params, g_tx.init(g_params), d_tx.init(d_params),
                       torch.zeros((), dtype=torch.int32, device=dev))


def init_vgg_params(generator: torch.Generator, device="cuda") -> Params:
    """Seeded random VGG19Features weights (no pretrained weights ship)."""
    return _init_params(vgg_model(), generator, resolve_device(device))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _update(tx: RefineAdam, grads, opt: AdamState, params: Params):
    new_p, mu, nu, count = tx.update(grads, opt, tree_leaves(params))
    return (tree_unflatten(params, new_p),
            AdamState(count, tree_unflatten(opt.mu, mu), tree_unflatten(opt.nu, nu)))


def refine_train_step(
    state: RefineState,
    input_a: torch.Tensor,    # [B, H, W, 3] NeRF render, in [-1, 1]
    real_b: torch.Tensor,     # [B, H, W, 3] ground truth, in [-1, 1]
    cfg: RefineConfig,
    g_tx: RefineAdam,
    d_tx: RefineAdam,
    vgg_params: Optional[Params] = None,
):
    """One adversarial step: (new state, metrics as 0-dim tensors). Nothing
    is read back to the host."""
    g, d = build_models(cfg)
    a, real = _nchw(input_a), _nchw(real_b)
    g_names, d_names = sorted(state.g_params), sorted(state.d_params)
    with f32_products():
        g_live = {k: state.g_params[k].detach().requires_grad_(True) for k in g_names}
        d_live = {k: state.d_params[k].detach().requires_grad_(True) for k in d_names}
        fake = torch.func.functional_call(g, g_live, (a,))
        # the real pair's features: the D loss differentiates them, the G loss
        # reads them detached
        pred_real = torch.func.functional_call(d, d_live, (torch.cat([a, real], 1),))
        pred_fake = torch.func.functional_call(d, state.d_params, (torch.cat([a, fake], 1),))
        loss_gan = lsgan_loss(pred_fake, is_real=True)
        loss_feat = cfg.lambda_feat * feature_matching_loss(pred_fake, pred_real,
                                                            cfg.n_layers_D, cfg.num_D)
        loss_vgg = torch.zeros((), device=a.device)
        if cfg.use_vgg and vgg_params is not None:
            loss_vgg = cfg.lambda_feat * vgg_perceptual_loss(vgg_model(), vgg_params, fake, real)
        loss_l1 = cfg.lambda_l1 * torch.mean(torch.abs(fake - real))
        g_total = loss_gan + loss_feat + loss_vgg + loss_l1
        g_grads = torch.autograd.grad(g_total, [g_live[k] for k in g_names])

        pred_fake_d = torch.func.functional_call(d, d_live, (torch.cat([a, fake.detach()], 1),))
        d_total = 0.5 * (lsgan_loss(pred_fake_d, False) + lsgan_loss(pred_real, True))
        d_grads = torch.autograd.grad(d_total, [d_live[k] for k in d_names])

    g_params, g_opt = _update(g_tx, list(g_grads), state.g_opt, state.g_params)
    d_params, d_opt = _update(d_tx, list(d_grads), state.d_opt, state.d_params)
    metrics = {"loss_G": g_total.detach(), "loss_D": d_total.detach(),
               "G_GAN": loss_gan.detach(), "G_feat": loss_feat.detach(),
               "G_VGG": loss_vgg.detach()}
    return RefineState(g_params, d_params, g_opt, d_opt, state.step + 1), metrics


def refine_inference(g_params: Params, input_a: torch.Tensor, cfg: RefineConfig) -> torch.Tensor:
    """G(A) for a batch of renders [B, H, W, 3] in [-1, 1], NHWC out."""
    g, _ = build_models(cfg)
    with torch.no_grad(), f32_products():
        out = torch.func.functional_call(g, g_params, (_nchw(input_a),))
    return out.permute(0, 2, 3, 1)


def refine_tree(state: RefineState) -> Dict[str, Any]:
    """The state as a tree keyed as the JAX RefineState's fields."""
    return {"g_params": state.g_params, "d_params": state.d_params,
            "g_opt": {"count": state.g_opt.count, "mu": state.g_opt.mu, "nu": state.g_opt.nu},
            "d_opt": {"count": state.d_opt.count, "mu": state.d_opt.mu, "nu": state.d_opt.nu},
            "step": state.step}


def refine_from_tree(tree: Dict[str, Any]) -> RefineState:
    opt = lambda o: AdamState(o["count"], o["mu"], o["nu"])
    return RefineState(tree["g_params"], tree["d_params"], opt(tree["g_opt"]),
                       opt(tree["d_opt"]), tree["step"])
