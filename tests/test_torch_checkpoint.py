"""The port's train-state checkpoints (mofanerf_tpu_torch/train/checkpoint.py):
a save restores bit for bit, `latest_step` finds the newest `.pt`, a run
resumed after 3 steps ends where 5 uninterrupted steps end (bit for bit on
the CPU), and a directory that holds only the JAX package's Orbax steps is
read: its newest step restores as the bridge carries the JAX state across
(tests/test_torch_orbax.py holds the reader itself)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.models.field import FieldConfig as JFieldConfig
from mofanerf_tpu.render import renderer as jr
from mofanerf_tpu.train import state as jst
from mofanerf_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models.field import FieldConfig
from mofanerf_tpu_torch.render.renderer import MoFaNeRF, RenderConfig
from mofanerf_tpu_torch.train import checkpoint as ck
from mofanerf_tpu_torch.train import state as st
from mofanerf_tpu_torch.train.loop import step_generator
from mofanerf_tpu_torch.utils.tree import tree_leaves

SPEC = MoFaNeRF(coarse=FieldConfig(depth=6, width=32, multires=4, multires_views=2),
                fine=FieldConfig(depth=6, width=32, multires=4, multires_views=2),
                render=RenderConfig(n_coarse=8, n_importance=8), uv_size=128)


def _state(seed=0):
    return st.create_train_state(torch.Generator().manual_seed(seed), SPEC, device="cpu")


def _batch(k):
    rng = np.random.default_rng(100 + k)
    rd = rng.normal(0, 0.05, (16, 3)) + [0.0, 0.0, -1.0]
    return st.Batch(
        rays_o=torch.tensor([[0.0, 0.0, 16.0]] * 16), rays_d=torch.from_numpy(rd.astype(np.float32)),
        target_rgb=torch.from_numpy(rng.uniform(0, 1, (16, 3)).astype(np.float32)),
        shape_code=torch.from_numpy(rng.standard_normal(50).astype(np.float32)),
        exp_type=torch.tensor(int(rng.integers(0, 20))),
        uv_map=torch.from_numpy(rng.uniform(0, 1, (128, 128, 3)).astype(np.float32)))


def _steps(state, ks):
    tx = st.make_optimizer()
    for k in ks:
        state, _ = st.train_step(state, _batch(k), step_generator(0, k, "cpu"), SPEC, tx)
    return state


def _assert_same(a, b):
    assert int(a.step) == int(b.step) and int(a.opt_state.count) == int(b.opt_state.count)
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt_state.mu) + tree_leaves(a.opt_state.nu),
                    tree_leaves(b.params) + tree_leaves(b.opt_state.mu) + tree_leaves(b.opt_state.nu)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_is_bit_exact(tmp_path):
    state = _steps(_state(), [0])
    path = ck.save_checkpoint(str(tmp_path), state, 1)
    assert os.path.basename(path) == "000001.pt"
    back = ck.restore_checkpoint(str(tmp_path), _state(seed=5))
    _assert_same(back, state)
    # the params alone, into a model param tree
    params = ck.restore_checkpoint(str(tmp_path), _state(seed=5).params)
    for x, y in zip(tree_leaves(params), tree_leaves(state.params)):
        assert torch.equal(x, y)
    # keys are JAX key paths
    keys = torch.load(path, weights_only=True)
    assert "['params']['coarse']['xyz']['b']" in keys and "['opt_state']['count']" in keys
    assert "['step']" in keys and "['params']['tex_encoder']['convs.0.weight']" in keys


def test_latest_step_and_replacing_a_step(tmp_path):
    assert ck.latest_step(str(tmp_path / "none")) is None
    assert ck.latest_step(str(tmp_path)) is None
    s0 = _state()
    for step in (3, 12, 7):
        ck.save_checkpoint(str(tmp_path), s0, step)
    (tmp_path / "000099.pt.123.tmp").write_bytes(b"partial")
    (tmp_path / "notes.txt").write_text("x")
    os.makedirs(tmp_path / "000200")   # an Orbax step directory is not a .pt
    assert ck.latest_step(str(tmp_path)) == 12
    assert ck.orbax_steps(str(tmp_path)) == [200]
    # a save at an existing step replaces it
    s1 = _steps(s0, [0])
    ck.save_checkpoint(str(tmp_path), s1, 12)
    _assert_same(ck.restore_checkpoint(str(tmp_path), _state()), s1)
    _assert_same(ck.restore_checkpoint(str(tmp_path), _state(), step=7), s0)


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    straight = _steps(_state(), range(5))
    first = _steps(_state(), range(3))
    ck.save_checkpoint(str(tmp_path), first, 3)
    resumed = _steps(ck.restore_checkpoint(str(tmp_path), _state(seed=9)), range(3, 5))
    _assert_same(resumed, straight)


def test_orbax_only_directory_raises_naming_a3(tmp_path):
    """The directory was refused, naming ROADMAP A3, before the port read
    Orbax steps; now its newest step restores, and a step that holds another
    tree raises naming what differs. An empty directory still raises."""
    fkw = dict(depth=6, width=32, multires=4, multires_views=2)
    jspec = jr.MoFaNeRF(coarse=JFieldConfig(**fkw), fine=JFieldConfig(**fkw),
                        render=jr.RenderConfig(n_coarse=8, n_importance=8), uv_size=128)
    jstate = jst.create_train_state(jax.random.PRNGKey(4), jspec)
    jax_save_checkpoint(str(tmp_path), jstate, 10)
    assert ck.orbax_steps(str(tmp_path)) == [10] and ck.latest_step(str(tmp_path)) == 10
    back = ck.restore_checkpoint(str(tmp_path), _state(), spec=SPEC)
    _assert_same(back, bridge.train_state_to_torch(jax.tree.map(np.asarray, jstate), SPEC, "cpu"))
    jax_save_checkpoint(str(tmp_path), {"w": jnp.ones(3)}, 20)
    with pytest.raises(ValueError, match="does not hold this model's state"):
        ck.restore_checkpoint(str(tmp_path), _state(), spec=SPEC)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ck.restore_checkpoint(str(tmp_path / "empty"), _state())


def test_another_models_checkpoint_is_refused(tmp_path):
    ck.save_checkpoint(str(tmp_path), _state(), 1)
    other = MoFaNeRF(coarse=FieldConfig(depth=6, width=64), fine=SPEC.fine, uv_size=128)
    with pytest.raises(ValueError, match="coarse"):
        ck.restore_checkpoint(str(tmp_path), st.create_train_state(
            torch.Generator().manual_seed(0), other, device="cpu"))
