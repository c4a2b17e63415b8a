"""Time the port's restore of a full-width model from an Orbax step that the
JAX package wrote (a script, not a test; run on the CPU, no card needed):

    JAX_PLATFORMS=cpu python tests/torch_orbax_restore_time.py [--seed 0]

The JAX package makes a TrainState at the reference's widths (coarse 8x256,
fine 10x1024: 32,493,178 params), fills its Adam moments with seeded
values as a trained state has (mu ~ N(0, 1e-3), nu ~ |N(0, 1e-6)|), and
saves it with `mofanerf_tpu.train.checkpoint.save_checkpoint`. The port
then restores it, timed on the host clock: the params alone
(`train/checkpoint.py::load_model`, what run_render and run_fit do) and the
whole TrainState (`restore_checkpoint`, what a resumed run_train does). The
restored trees are checked bit for bit against `bridge` of the JAX state."""
import argparse
import os
import sys
import tempfile
import time

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_platforms", "cpu")

from mofanerf_tpu.render.renderer import MoFaNeRF as JMoFaNeRF  # noqa: E402
from mofanerf_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from mofanerf_tpu.train.state import create_train_state  # noqa: E402
from mofanerf_tpu_torch import bridge  # noqa: E402
from mofanerf_tpu_torch.render.renderer import MoFaNeRF  # noqa: E402
from mofanerf_tpu_torch.train import checkpoint as ck  # noqa: E402
from mofanerf_tpu_torch.train.state import create_train_state as port_state  # noqa: E402
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
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
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, state, 1000)
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(d) for f in fs)
        t0 = time.perf_counter()
        params, step = ck.load_model(d, spec, "cpu")
        t_params = time.perf_counter() - t0
        target = port_state(torch.Generator().manual_seed(0), spec, device="cpu")
        t0 = time.perf_counter()
        whole = ck.restore_checkpoint(d, target, spec=spec)
        t_state = time.perf_counter() - t0
    want = bridge.train_state_to_torch(jax.tree.map(np.asarray, state), spec, "cpu")
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten_with_keystr(ck._as_tree(whole)), flatten_with_keystr(ck._as_tree(want))))
    same = same and all(torch.equal(a, b) for (_, a), (_, b) in
                        zip(flatten_with_keystr(params), flatten_with_keystr(want.params)))
    print(f"full-width Orbax step: {n} params, {size} bytes on disk; the port restored "
          f"the params in {t_params:.2f} s and the whole TrainState (params, Adam mu and nu) "
          f"in {t_state:.2f} s on the CPU (host clock, {os.cpu_count()} cores); step {step}; "
          f"bit-exact against bridge: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
