"""Ray-marching sample placement: stratified depths and inverse-CDF
importance sampling (counterpart of mofanerf_tpu/ops/sampling.py).

The JAX functions take a PRNG key; the two frameworks' generators never
agree, so the random draws are injected here: a tensor `u` of U(0, 1) draws,
or a `torch.Generator` to draw them from when `u` is None. No global RNG is
read.
"""
from __future__ import annotations

import torch


def _unit_steps(n: int, device) -> torch.Tensor:
    """n evenly spaced values over [0, 1], rounded as `jnp.linspace(0, 1, n)`
    rounds them under XLA: i * (1 / (n - 1)) in f32 with the end point exactly
    1 (`torch.linspace` and i / (n - 1) differ from that in the last bit, and
    the depths feed sin(512 x))."""
    div = max(n - 1, 1)
    steps = torch.arange(n, dtype=torch.float32, device=device) * (
        torch.ones((), dtype=torch.float32, device=device) / div)
    if n > 1:
        steps[-1:].fill_(1.0)   # a fill on the device: assigning a Python number copies from the host
    return steps


def _draw(u, generator, shape, device, what: str) -> torch.Tensor:
    if u is not None:
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"{what}: uniforms have shape {tuple(u.shape)}, need {tuple(shape)}")
        return u
    if generator is None:
        raise ValueError(f"{what} requires uniforms `u` or a torch.Generator")
    gdev = generator.device
    return torch.rand(shape, generator=generator, dtype=torch.float32, device=gdev).to(device)


def stratified_z_vals(
    u: torch.Tensor | None,
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    perturb: float = 0.0,
    lindisp: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Place `n_samples` depths per ray in [near, far].

    near/far: [..., 1] tensors. Returns [..., n_samples]. With perturb > 0
    each sample is jittered uniformly within its stratum by `u` (U(0, 1)
    draws of the output's shape) or by draws from `generator`."""
    t_vals = _unit_steps(n_samples, near.device)
    if lindisp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals

    if perturb > 0.0:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        t_rand = _draw(u, generator, z_vals.shape, z_vals.device, "stratified perturbation")
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_pdf(
    u: torch.Tensor | None,
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of `n_samples` new depths from coarse weights.

    bins: [N_rays, M] bin edges (z-midpoints), weights: [N_rays, M-1]. A 1e-5
    weight floor, right-continuous searchsorted, and a guard for degenerate
    intervals at 1e-5. `det` takes evenly spaced quantiles; otherwise `u`
    ([N_rays, n_samples] U(0, 1) draws) or `generator` gives them.

    The result is detached: resampling positions are constants with respect
    to the loss."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, M]

    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = _unit_steps(n_samples, cdf.device).expand(shape)
    else:
        u = _draw(u, generator, shape, cdf.device, "stochastic sample_pdf")

    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    last_bin = bins.shape[-1] - 1
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=last_bin))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=last_bin))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    samples = bins_below + t * (bins_above - bins_below)
    return samples.detach()
