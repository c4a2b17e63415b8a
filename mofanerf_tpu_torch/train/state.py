"""Train state and the training step (counterpart of
mofanerf_tpu/train/state.py).

A step: texture encoding, conditioning fold, the coarse and fine render of
a batch of rays, MSE(fine) + MSE(coarse), and Adam over all trainable
state (both fields, the texture encoder, the ISM, the expression bank) with
the exponential decay `lrate * 0.1^(t / (lrate_decay * 1500))`.

The render is differentiated through `apply_field_folded`
(`render_rays(autograd=True)`), as the JAX step differentiates its XLA
field; products in f32 run in full f32 (no TF32), forward and backward.

Adam is a plain function on tensors whose state is optax's: the update
count and the moments `mu`, `nu`. `optax.adam(learning_rate=schedule)`
counts updates itself, and a skipped step reverts the whole optimiser
state, so the learning rate and the bias correction of an update follow
the number of accepted updates, while `TrainState.step` counts every step.
The skip of a non-finite step is a select on the device over every leaf,
with no host synchronisation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from mofanerf_tpu_torch.parallel.collectives import (ModelAxis, all_reduce_mean, all_true,
                                                     data_rows, model_axis)
from mofanerf_tpu_torch.render.renderer import (MoFaNeRF, encode_texture, exp_code_for,
                                                init_model_params, prepare_conditioning,
                                                render_rays, train_draws)
from mofanerf_tpu_torch.utils import profiling
from mofanerf_tpu_torch.utils.device import f32_products, resolve_device
from mofanerf_tpu_torch.utils.metrics import img2mse, mse2psnr
from mofanerf_tpu_torch.utils.tree import map_tree, tree_leaves, tree_unflatten

Params = Dict[str, Any]


class AdamState(NamedTuple):
    """optax's `(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))`
    with the two equal counts held once."""

    count: torch.Tensor   # int32 scalar: accepted updates
    mu: Params
    nu: Params


class TrainState(NamedTuple):
    params: Params
    opt_state: AdamState
    step: torch.Tensor    # int32 scalar: every step, skipped ones too


def lr_at(step, lrate: float = 5e-5, lrate_decay: int = 250) -> torch.Tensor:
    """The schedule lrate * 0.1^(step / (lrate_decay * 1500)), in f32."""
    decay_steps = lrate_decay * 1500
    return lrate * (0.1 ** (torch.as_tensor(step).to(torch.float32) / decay_steps))


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam with torch's defaults (betas 0.9 / 0.999, eps 1e-8) on the
    decaying schedule, as optax.adam computes it; `lrate_decay=None` keeps
    the rate constant at `lrate`, as `optax.adam(lrate)` (distillation)."""

    lrate: float = 5e-5
    lrate_decay: int | None = 250
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params) -> AdamState:
        count = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
        return AdamState(count, map_tree(torch.zeros_like, params),
                         map_tree(torch.zeros_like, params))

    def rate(self, count: torch.Tensor):
        """The learning rate of the update that follows `count` accepted ones."""
        if self.lrate_decay is None:
            return self.lrate
        return lr_at(count, self.lrate, self.lrate_decay)

    def update(self, grads, state: AdamState, params):
        """One update of leaf lists (tree_leaves order): returns (new params,
        new mu, new nu, new count)."""
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                torch._foreach_mul(tree_leaves(state.mu), b1))
        sq = torch._foreach_mul(grads, grads)
        nu = torch._foreach_add(torch._foreach_mul(sq, 1 - b2),
                                torch._foreach_mul(tree_leaves(state.nu), b2))
        count = state.count + 1
        t = count.to(torch.float32)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t   # f32 on the device: no host round trip
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        upd = torch._foreach_mul(upd, -self.rate(state.count))
        return torch._foreach_add(params, upd), mu, nu, count


def make_optimizer(lrate: float = 5e-5, lrate_decay: int = 250) -> Adam:
    return Adam(lrate, lrate_decay)


def create_train_state(generator: torch.Generator, spec: MoFaNeRF, lrate: float = 5e-5,
                       lrate_decay: int = 250, device="cuda") -> TrainState:
    dev = resolve_device(device)
    params = init_model_params(generator, spec, device=dev)
    return TrainState(params, make_optimizer(lrate, lrate_decay).init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


class Batch(NamedTuple):
    """One training batch: N rays from one (identity, expression) frame."""

    rays_o: torch.Tensor      # [N, 3]
    rays_d: torch.Tensor      # [N, 3]
    target_rgb: torch.Tensor  # [N, 3]
    shape_code: torch.Tensor  # [shape_dim]
    exp_type: torch.Tensor    # int scalar
    uv_map: torch.Tensor      # [uv_size, uv_size, 3]
    coords: Any = None        # [N, 2] (row, col) of the rays: host int32, or f32 on the device


def loss_fn(params: Params, spec: MoFaNeRF, batch: Batch,
            generator: torch.Generator | None = None,
            draws: Dict[str, torch.Tensor] | None = None,
            tp: ModelAxis | None = None):
    """(MSE(fine) + MSE(coarse), MSE(fine)) of a batch, differentiable in
    `params`. The random draws come from `draws` or `generator`. With the
    model axis `tp`, a fine field in column blocks runs tensor-parallel."""
    with profiling.annotate("mofanerf.train.encode"):
        tex = encode_texture(params, spec, batch.uv_map)
    with profiling.annotate("mofanerf.train.condition"):
        cond = prepare_conditioning(params, spec, batch.shape_code,
                                    exp_code_for(params, batch.exp_type), tex, tp)
    with profiling.annotate("mofanerf.train.forward"):
        out = render_rays(params, spec, cond, batch.rays_o, batch.rays_d, generator=generator,
                          train=True, draws=draws, autograd=True, tp=tp)
        img_loss = img2mse(out["rgb"], batch.target_rgb)
        loss = img_loss
        if "rgb0" in out:
            loss = loss + img2mse(out["rgb0"], batch.target_rgb)
    return loss, img_loss


def _rank_rows(batch: Batch, generator, spec: MoFaNeRF, draws, mesh):
    """This data rank's rows of the whole batch and of its draws (those of
    `generator` drawn for the whole batch, then cut)."""
    if generator is not None:
        draws = train_draws(generator, spec, batch.rays_o.shape[0], batch.rays_o.device, draws)
    rows = {k: data_rows(getattr(batch, k), mesh) for k in ("rays_o", "rays_d", "target_rgb")}
    if batch.coords is not None:
        rows["coords"] = data_rows(batch.coords, mesh)
    return batch._replace(**rows), {k: data_rows(v, mesh) for k, v in (draws or {}).items()}


def batch_grads(params: Params, batch: Batch, generator: torch.Generator | None,
                spec: MoFaNeRF, draws: Dict[str, torch.Tensor] | None = None, mesh=None):
    """(loss, fine MSE, gradients in tree_leaves order) of a batch, detached.
    Under `mesh` (see train_step) of this rank's rows, then averaged over
    `data` in one flat all_reduce."""
    tp = model_axis(mesh)
    if mesh is not None:
        batch, draws = _rank_rows(batch, generator, spec, draws, mesh)
        generator = None
    with f32_products():
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, img_loss = loss_fn(tree_unflatten(params, live), spec, batch, generator, draws, tp)
        with profiling.annotate("mofanerf.train.backward"):
            grads = list(torch.autograd.grad(loss, live, allow_unused=True,
                                             materialize_grads=True))
    loss, img_loss = loss.detach(), img_loss.detach()
    if mesh is not None:
        with profiling.annotate("mofanerf.train.backward"):
            *grads, loss, img_loss = all_reduce_mean(grads + [loss, img_loss], mesh)
    return loss, img_loss, grads


def train_step(state: TrainState, batch: Batch, generator: torch.Generator | None,
               spec: MoFaNeRF, tx: Adam, skip_nonfinite: bool = True,
               draws: Dict[str, torch.Tensor] | None = None, mesh=None):
    """One optimisation step. Returns (new_state, metrics), all on the
    params' device; nothing is read back to the host.

    skip_nonfinite: when the loss or any gradient is non-finite, keep the
    old params and optimiser state (count included) and only advance
    `step`.

    mesh (parallel/mesh.py): every rank passes the whole batch; it trains on
    its `data` rows (and on the rows of the whole batch's draws: those of
    `generator` are drawn for the whole batch), the texture encoder and the
    conditioning run whole on every rank, and the gradients, the loss and
    the fine MSE are averaged over `data` in one flat all_reduce before Adam,
    so that every rank takes the same step and the same skip. State whose
    fine field is in model shards (shard_params, Adam's moments alike) runs
    it tensor-parallel over `model`."""
    leaves = tree_leaves(state.params)
    tp = model_axis(mesh)
    loss, img_loss, grads = batch_grads(state.params, batch, generator, spec, draws, mesh)
    metrics = {"loss": loss, "psnr": mse2psnr(img_loss)}
    with profiling.annotate("mofanerf.train.optimizer"):
        new_p, new_mu, new_nu, count = tx.update(grads, state.opt_state, leaves)
        if skip_nonfinite:
            # one check over a flat copy of every gradient: a check a leaf costs
            # a few launches a leaf (isfinite is several kernels on the card)
            finite = torch.isfinite(torch.cat([g.reshape(-1) for g in grads])).all()
            ok = torch.isfinite(loss) & finite
            if tp is not None:   # the model ranks hold other blocks of the fine field
                ok = all_true(ok, tp.group)

            def pick(new, old):
                return [torch.where(ok, n, o) for n, o in zip(new, old)]

            new_p = pick(new_p, leaves)
            new_mu = pick(new_mu, tree_leaves(state.opt_state.mu))
            new_nu = pick(new_nu, tree_leaves(state.opt_state.nu))
            count = torch.where(ok, count, state.opt_state.count)
            metrics["step_ok"] = ok
    opt = AdamState(count, tree_unflatten(state.opt_state.mu, new_mu),
                    tree_unflatten(state.opt_state.nu, new_nu))
    return TrainState(tree_unflatten(state.params, new_p), opt, state.step + 1), metrics
