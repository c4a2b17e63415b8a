"""Time the port's restore of a full-width model from Orbax steps that the
JAX package wrote, in each layout (a script, not a test; run on the CPU, no
card needed):

    JAX_PLATFORMS=cpu python tests/torch_orbax_restore_time.py [--seed 0]
        [--layouts ocdbt_zarr2,ocdbt_zarr3,files_zarr2,files_zarr3]

The JAX package makes a TrainState at the reference's widths (coarse 8x256,
fine 10x1024: 32,493,178 params), fills its Adam moments with seeded
values as a trained state has (mu ~ N(0, 1e-3), nu ~ |N(0, 1e-6)|), and
saves, in each layout of orbax's PyTreeCheckpointHandler (`use_ocdbt` x
`use_zarr3`; ocdbt_zarr2 is what `save_checkpoint` writes), two steps: the
params alone (`{"params": ...}`) and the whole TrainState. The port then
restores them, timed on the host clock: the params-only step through
`train/checkpoint.py::load_model` (what run_render and run_fit do) and the
TrainState through `restore_checkpoint` (what a resumed run_train does).
The restored trees are checked bit for bit against `bridge` of the JAX
state."""
import argparse
import os
import sys
import tempfile
import time

import jax
import numpy as np
import orbax.checkpoint as ocp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_platforms", "cpu")

from mofanerf_tpu.render.renderer import MoFaNeRF as JMoFaNeRF  # noqa: E402
from mofanerf_tpu.train.state import create_train_state  # noqa: E402
from mofanerf_tpu_torch import bridge  # noqa: E402
from mofanerf_tpu_torch.render.renderer import MoFaNeRF  # noqa: E402
from mofanerf_tpu_torch.train import checkpoint as ck  # noqa: E402
from mofanerf_tpu_torch.train.state import create_train_state as port_state  # noqa: E402
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr  # noqa: E402

LAYOUTS = {"ocdbt_zarr2": (True, False), "ocdbt_zarr3": (True, True),
           "files_zarr2": (False, False), "files_zarr3": (False, True)}


def _save(ckpt_dir, tree, step, use_ocdbt, use_zarr3):
    """`tree` at ckpt_dir/<step:06d>, as save_checkpoint lays a step out,
    through the handler of the layout; its bytes on disk."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"{step:06d}")
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=use_ocdbt, use_zarr3=use_zarr3)
    ocp.Checkpointer(handler).save(path, args=ocp.args.PyTreeSave(tree), force=True)
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def _equal(a, b):
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(flatten_with_keystr(a), flatten_with_keystr(b)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layouts", default=",".join(LAYOUTS))
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    state = create_train_state(jax.random.PRNGKey(args.seed), JMoFaNeRF())
    adam, sched = state.opt_state
    mu = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3).astype(np.float32),
                      adam.mu)
    nu = jax.tree.map(lambda x: np.abs(rng.standard_normal(x.shape) * 1e-6).astype(np.float32),
                      adam.nu)
    state = state._replace(opt_state=(adam._replace(mu=mu, nu=nu), sched))
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(state.params))
    spec = MoFaNeRF()
    want = bridge.train_state_to_torch(jax.tree.map(np.asarray, state), spec, "cpu")
    target = port_state(torch.Generator().manual_seed(0), spec, device="cpu")
    ok = True
    for layout in args.layouts.split(","):
        use_ocdbt, use_zarr3 = LAYOUTS[layout]
        with tempfile.TemporaryDirectory() as d_params, tempfile.TemporaryDirectory() as d_state:
            size_params = _save(d_params, {"params": state.params}, 1000, use_ocdbt, use_zarr3)
            size_state = _save(d_state, state, 1000, use_ocdbt, use_zarr3)
            t0 = time.perf_counter()
            params, step = ck.load_model(d_params, spec, "cpu")
            t_params = time.perf_counter() - t0
            t0 = time.perf_counter()
            whole = ck.restore_checkpoint(d_state, target, spec=spec)
            t_state = time.perf_counter() - t0
        same = _equal(params, want.params) and _equal(ck._as_tree(whole), ck._as_tree(want))
        ok = ok and same and step == 1000
        print(f"full-width Orbax steps, {layout}: {n} params; the params-only step "
              f"({size_params} bytes on disk) restored by load_model in {t_params:.2f} s, the "
              f"TrainState (params, Adam mu and nu; {size_state} bytes) by restore_checkpoint "
              f"in {t_state:.2f} s on the CPU (host clock, {os.cpu_count()} cores); step "
              f"{step}; bit-exact against bridge: {same}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
