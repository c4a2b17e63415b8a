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
Params, moments and gradients each live in one flat f32 buffer
(ops/flat_adam.py), so the update, the finite check and the skip of a
non-finite step are two launches on the device, with no host
synchronisation. A lone `train_step` copies the state it is given into
buffers of its own (`FlatTrainState`) and updates those in place; the
training loops (train/loop.py) copy once, a run or a chunk, and step in
place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from mofanerf_tpu_torch.ops import flat_adam
from mofanerf_tpu_torch.ops.flat_adam import FlatLayout
from mofanerf_tpu_torch.parallel.collectives import (ModelAxis, all_reduce_mean_, all_true,
                                                     data_rows, model_axis)
from mofanerf_tpu_torch.render.renderer import (MoFaNeRF, encode_texture, exp_code_for,
                                                init_model_params, prepare_conditioning,
                                                render_rays, train_draws)
from mofanerf_tpu_torch.utils import profiling
from mofanerf_tpu_torch.utils.device import f32_products, resolve_device
from mofanerf_tpu_torch.utils.metrics import img2mse, mse2psnr
from mofanerf_tpu_torch.utils.tree import tree_leaves, tree_unflatten

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
    the rate constant at `lrate`, as `optax.adam(lrate)` (distillation).
    Its state and its updates live in flat buffers (ops/flat_adam.py)."""

    lrate: float = 5e-5
    lrate_decay: int | None = 250
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params) -> AdamState:
        leaves = tree_leaves(params)
        layout = FlatLayout.of(leaves)
        dev = leaves[0].device
        count = torch.zeros((), dtype=torch.int32, device=dev)
        return AdamState(count, tree_unflatten(params, layout.views(layout.zeros(dev))),
                         tree_unflatten(params, layout.views(layout.zeros(dev))))

    def rate(self, count: torch.Tensor):
        """The learning rate of the update that follows `count` accepted ones."""
        if self.lrate_decay is None:
            return self.lrate
        return lr_at(count, self.lrate, self.lrate_decay)

    def apply_(self, p, mu, nu, g, count, flag=None) -> None:
        """One update of flat buffers (FlatLayout) in place: params `p`, moments
        `mu`, `nu` and `count` advance where `flag` (an int32 scalar, see
        flat_adam.all_finite) is non-zero or None, and keep their values where
        it is 0."""
        t = (count + 1).to(torch.float32)
        bc1, bc2 = 1 - self.b1 ** t, 1 - self.b2 ** t   # f32 on the device: no host round trip
        flat_adam.adam_(p, mu, nu, g, count, -self.rate(count), bc1, bc2, flag,
                        self.b1, self.b2, self.eps)

    def update(self, grads, state: AdamState, params):
        """One update of leaf lists (tree_leaves order), out of place: returns
        (new params, new mu, new nu, new count), the leaves views of new flat
        buffers."""
        layout = FlatLayout.of(params)
        p, mu, nu, g = (layout.pack(x) for x in (params, tree_leaves(state.mu),
                                                  tree_leaves(state.nu), grads))
        count = state.count.clone()
        self.apply_(p, mu, nu, g, count)
        return layout.views(p), layout.views(mu), layout.views(nu), count


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
                spec: MoFaNeRF, draws: Dict[str, torch.Tensor] | None = None, mesh=None,
                into=None):
    """(loss, fine MSE, gradients in tree_leaves order) of a batch, detached.
    The gradients are views of one flat f32 buffer (FlatLayout of the
    leaves, with two elements to spare at its end): `into`'s `(buffer, its
    leaf views)` when given, else a new one. Under `mesh` (see train_step)
    of this rank's rows, then averaged over `data` with the loss and the
    fine MSE in one all_reduce of that buffer."""
    tp = model_axis(mesh)
    if mesh is not None:
        batch, draws = _rank_rows(batch, generator, spec, draws, mesh)
        generator = None
    leaves = tree_leaves(params)
    if into is None:
        layout = FlatLayout.of(leaves)
        flat = layout.zeros(leaves[0].device, extra=2)
        into = flat, layout.views(flat)
    flat, views = into
    with f32_products():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, img_loss = loss_fn(tree_unflatten(params, live), spec, batch, generator, draws, tp)
        with profiling.annotate("mofanerf.train.backward"):
            grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
            torch._foreach_copy_(views, list(grads))
    loss, img_loss = loss.detach(), img_loss.detach()
    if mesh is not None:
        with profiling.annotate("mofanerf.train.backward"):
            flat[-2:].copy_(torch.stack([loss, img_loss]))
            all_reduce_mean_(flat, mesh)
            loss, img_loss = flat[-2:].clone().unbind()
    return loss, img_loss, views


class FlatTrainState:
    """A TrainState copied into flat buffers that it owns (ops/flat_adam.py:
    params, Adam's moments, the gradients), which `step_` updates in place.
    The state it was made from is never written; `state()` hands out a
    TrainState whose leaves are views of its buffers."""

    def __init__(self, state: TrainState):
        leaves = tree_leaves(state.params)
        self.like = state.params
        self.layout = layout = FlatLayout.of(leaves)
        opt = state.opt_state
        self.p = layout.pack(leaves)
        self.mu = layout.pack(tree_leaves(opt.mu))
        self.nu = layout.pack(tree_leaves(opt.nu))
        # with two elements to spare for the loss and fine MSE batch_grads reduces under a mesh
        g_ext = layout.zeros(self.p.device, extra=2)
        self.g, self.into = g_ext[:layout.size], (g_ext, layout.views(g_ext))
        self.params = tree_unflatten(state.params, layout.views(self.p))
        self.count = opt.count.clone()
        self.step = state.step.clone()
        self.flag = torch.ones((), dtype=torch.int32, device=self.p.device)

    def state(self) -> TrainState:
        views = lambda flat: tree_unflatten(self.like, self.layout.views(flat))  # noqa: E731
        return TrainState(views(self.p), AdamState(self.count, views(self.mu), views(self.nu)),
                          self.step)

    def step_(self, batch: Batch, generator: torch.Generator | None, spec: MoFaNeRF, tx: Adam,
              skip_nonfinite: bool = True, draws: Dict[str, torch.Tensor] | None = None,
              mesh=None):
        """One optimisation step in place (see train_step); returns its metrics."""
        tp = model_axis(mesh)
        loss, img_loss, _ = batch_grads(self.params, batch, generator, spec, draws, mesh,
                                        into=self.into)
        metrics = {"loss": loss, "psnr": mse2psnr(img_loss)}
        with profiling.annotate("mofanerf.train.optimizer"):
            flag = None
            if skip_nonfinite:
                flag = flat_adam.all_finite(self.g, loss, self.flag)
                if tp is not None:   # the model ranks hold other blocks of the fine field
                    flag = all_true(flag != 0, tp.group).to(torch.int32)
                metrics["step_ok"] = flag != 0
            tx.apply_(self.p, self.mu, self.nu, self.g, self.count, flag)
        self.step.add_(1)
        return metrics


def train_step(state: TrainState, batch: Batch, generator: torch.Generator | None,
               spec: MoFaNeRF, tx: Adam, skip_nonfinite: bool = True,
               draws: Dict[str, torch.Tensor] | None = None, mesh=None):
    """One optimisation step. Returns (new_state, metrics), all on the
    params' device; nothing is read back to the host. `state` is left as it
    was: the step copies it into flat buffers of its own (FlatTrainState),
    and the new state's leaves are views of those.

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
    it tensor-parallel over `model`, each rank's shards in its own buffers."""
    flat = FlatTrainState(state)
    metrics = flat.step_(batch, generator, spec, tx, skip_nonfinite, draws, mesh)
    return flat.state(), metrics
