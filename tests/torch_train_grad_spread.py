"""How closely a training step can agree with the JAX package's, on the CPU:
the spreads behind the tolerances of tests/test_torch_train_state.py.

    JAX_PLATFORMS=cpu python tests/torch_train_grad_spread.py   # ~1 min

Not a test (pytest does not collect it). On that file's specs and batch it
prints:
1. the relative loss gap between the port and the jitted JAX loss with
   perturb = 0 at multires 10: the deterministic importance sampler's last
   quantile is 1 and can land on either edge of a bin on opaque rays;
2. with the JAX step's own uniforms injected into the port (perturb = 1),
   the largest |diff| of the rendered `rgb0` / `rgb` between jitted JAX,
   eager JAX and the port, at multires 10 and 4;
3. at multires 4, the largest |diff| / max|g| of each leaf group's gradient
   for each pair of jitted JAX, eager JAX and the port, and how long the
   eager JAX gradient takes.
"""
import dataclasses
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_train_state as T  # noqa: E402
from mofanerf_tpu.render import renderer as jr  # noqa: E402
from mofanerf_tpu_torch import bridge  # noqa: E402
from mofanerf_tpu_torch.render import renderer as tr  # noqa: E402
from mofanerf_tpu_torch.utils.tree import tree_leaves, tree_unflatten  # noqa: E402

GROUPS = ("coarse", "fine", "tex_encoder", "ism", "exp_codes")


def specs(multires, perturb):
    jspec, tspec = T._specs()
    out = []
    for spec in (jspec, tspec):
        field = dataclasses.replace(spec.coarse, multires=multires)
        out.append(dataclasses.replace(spec, coarse=field, fine=field,
                                       render=dataclasses.replace(spec.render, perturb=perturb)))
    return out


def states(jspec, tspec):
    js = jax.jit(lambda k: T.jstate.create_train_state(k, jspec, T.LRATE, T.DECAY))(
        jax.random.PRNGKey(0))
    return js, bridge.train_state_to_torch(T.to_numpy(js), tspec, device="cpu")


def port_loss_and_grads(ts, tspec, batch, draws):
    live = [p.detach().requires_grad_(True) for p in tree_leaves(ts.params)]
    loss, _ = T.tstate.loss_fn(tree_unflatten(ts.params, live), tspec, T.torch_batch(batch),
                               draws=draws)
    return float(loss), [g.numpy() for g in torch.autograd.grad(loss, live)]


def main():
    b = T._batch(1)
    key = jax.random.PRNGKey(3)

    jspec, tspec = specs(10, 0.0)
    js, ts = states(jspec, tspec)
    (jl, _), _ = jax.jit(jax.value_and_grad(
        lambda p, bb, k: T.jax_loss(p, jspec, bb, k), has_aux=True))(js.params, T.jax_batch(b), key)
    tl, _ = port_loss_and_grads(ts, tspec, b, None)
    print(f"1. perturb 0, multires 10: loss port {tl:.6f}, jitted JAX {float(jl):.6f}, "
          f"relative gap {abs(tl - float(jl)) / float(jl):.2e}")

    for multires in (10, 4):
        jspec, tspec = specs(multires, 1.0)
        js, ts = states(jspec, tspec)
        jb, tb = T.jax_batch(b), T.torch_batch(b)
        cond = lambda s, p: jr.prepare_conditioning(
            p, s, jb.shape_code, jr.exp_code_for(p, jb.exp_type), jr.encode_texture(p, s, jb.uv_map))
        render = lambda p, c: jr.render_rays(p, jspec, c, jb.rays_o, jb.rays_d, key, train=True)
        eager = render(js.params, cond(jspec, js.params))
        jitted = jax.jit(lambda p: render(p, cond(jspec, p)))(js.params)
        tc = tr.prepare_conditioning(ts.params, tspec, tb.shape_code,
                                     tr.exp_code_for(ts.params, tb.exp_type),
                                     tr.encode_texture(ts.params, tspec, tb.uv_map))
        with torch.no_grad():
            port = tr.render_rays(ts.params, tspec, tc, tb.rays_o, tb.rays_d, train=True,
                                  autograd=True, draws=T.jax_draws(key))
        for k in ("rgb0", "rgb"):
            e, j, p = np.asarray(eager[k]), np.asarray(jitted[k]), port[k].numpy()
            print(f"2. multires {multires} {k}: max|diff| jit-eager {np.abs(j - e).max():.2e}, "
                  f"port-eager {np.abs(p - e).max():.2e}, port-jit {np.abs(p - j).max():.2e}")

    jspec, tspec = specs(4, 1.0)
    js, ts = states(jspec, tspec)
    fn = lambda p, bb, k: T.jax_loss(p, jspec, bb, k)
    (_, _), gj = jax.jit(jax.value_and_grad(fn, has_aux=True))(js.params, T.jax_batch(b), key)
    t0 = time.perf_counter()
    (_, _), ge = jax.value_and_grad(fn, has_aux=True)(js.params, T.jax_batch(b), key)
    t_eager = time.perf_counter() - t0
    _, gp = port_loss_and_grads(ts, tspec, b, T.jax_draws(key))
    as_port = lambda g: [t.numpy() for t in tree_leaves(
        bridge.model_params_to_torch(T.to_numpy(g), tspec, device="cpu"))]
    gj, ge = as_port(gj), as_port(ge)
    names = [k for k, _ in bridge.flatten_with_keystr(ts.params)]
    print(f"3. multires 4 gradients (eager JAX took {t_eager:.1f} s): largest |diff| / max|g| "
          f"of a leaf, by group")
    for group in GROUPS:
        idx = [i for i, n in enumerate(names) if n.startswith(f"['{group}']")]

        def spread(a, c):
            return max(np.abs(a[i] - c[i]).max() / max(np.abs(c[i]).max(), 1e-30) for i in idx)

        def outside(a, c, atol):
            return sum(int((np.abs(a[i] - c[i]) > 1e-4 * np.abs(c[i]) + atol
                            * np.abs(c[i]).max()).sum()) for i in idx)

        print(f"   {group:12s} jit-eager {spread(gj, ge):.2e}  port-eager {spread(gp, ge):.2e}  "
              f"port-jit {spread(gp, gj):.2e}; elements outside rtol 1e-4 + 1e-6 x max|g|: "
              f"port-eager {outside(gp, ge, 1e-6)}, port-jit {outside(gp, gj, 1e-6)}")


if __name__ == "__main__":
    main()
