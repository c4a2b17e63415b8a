"""The port's multi-card training (mofanerf_tpu_torch/parallel, train_step(mesh=),
train_chunk_device_data(mesh=)) on the CPU over gloo, against itself at
world 1 and against the JAX package's single-device train step.

Worlds 1, 2 and 4 are spawned once each (a module-scoped fixture); their
ranks run the port's worker `parallel/dryrun.py::sharded_paths` from the JAX
init carried across by the bridge, on numpy-made batches with the JAX step's
own uniforms injected (perturb = 1, multires 4: see
tests/test_torch_train_state.py), and the checks are parametrised over what
they returned. The children import torch and the port only. At a small size:
coarse 8x16, fine 8x32, 4 + 4 samples, UV 128, 64 rays.

- tensor parallelism at (data 1, model 2) and (data 2, model 2): the fine
  field's raw outputs, the loss and every leaf's gradient of the whole model
  with the fine field in model shards against the unsharded ones, within
  1e-5 of each leaf's max |value| (a wrong reduction over model, as an
  all_gather whose backward sums, gives n_model x the gradients of every leaf
  before the fine field's first layer: the texture encoder, the ISM, the
  expression bank);
- train_step(mesh=) over four batches, the third with one non-finite target
  on one rank: at worlds 2 and 4 (and (data 2, model 2) with the fine field
  in shards) against world 1, losses within 1e-4 relative and params within
  1e-5 (tests/test_scaling.py's bounds: the mean over ranks sums in another
  order); every world's losses against the JAX step's at rtol 1e-4
  (tests/test_torch_train_state.py's); every rank skips the non-finite step;
- the device-data chunk (two steps, batches drawn on the device from a
  shared generator) at world 2 against world 1, and world 1 against the call
  without a mesh, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.models import field as jfield
from mofanerf_tpu.ops.rays import get_rays_at as jget_rays_at
from mofanerf_tpu.ops.rays import pose_spherical
from mofanerf_tpu.render import renderer as jr
from mofanerf_tpu.train import state as jstate
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.data.device_data import DeviceDataset, DeviceSamplerConfig
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.parallel import dryrun
from mofanerf_tpu_torch.parallel.world import run_world
from mofanerf_tpu_torch.render import renderer as tr
from mofanerf_tpu_torch.train import state as tstate
from mofanerf_tpu_torch.train.loop import train_chunk_device_data
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr

N_RAYS, N_SAMPLES, UV, SIDE = 64, 4, 128, 32
NAN_ROW = 40   # a row of the second half: data rank 1 of 2, rank 2 of 4
N_STEPS = 4


def _specs():
    rkw = dict(n_coarse=N_SAMPLES, n_importance=N_SAMPLES, perturb=1.0, raw_noise_std=0.0)
    jspec = jr.MoFaNeRF(coarse=jfield.FieldConfig(depth=8, width=16, multires=4),
                        fine=jfield.FieldConfig(depth=8, width=32, multires=4),
                        render=jr.RenderConfig(**rkw), uv_size=UV)
    tspec = tr.MoFaNeRF(coarse=tfield.FieldConfig(depth=8, width=16, multires=4),
                        fine=tfield.FieldConfig(depth=8, width=32, multires=4),
                        render=tr.RenderConfig(**rkw), uv_size=UV)
    return jspec, tspec


def _batch(seed, nan=False):
    """A whole batch as numpy: rays through random pixels of a 32x32 view."""
    rng = np.random.default_rng(seed)
    K = np.array([[64.0, 0, SIDE / 2], [0, 64.0, SIDE / 2], [0, 0, 1]], np.float32)
    pose = pose_spherical(float(rng.uniform(-40, 40)), -10.0, 16.0).astype(np.float32)
    coords = rng.integers(6, SIDE - 6, (N_RAYS, 2)).astype(np.float32)
    ro, rd = jget_rays_at(jnp.asarray(coords), jnp.asarray(K), jnp.asarray(pose))
    target = rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32)
    if nan:
        target[NAN_ROW, 1] = np.nan
    return dict(rays_o=np.asarray(ro), rays_d=np.asarray(rd), target_rgb=target,
                shape_code=(rng.standard_normal(50) * 0.3).astype(np.float32),
                exp_type=int(rng.integers(0, 20)),
                uv_map=rng.uniform(0, 1, (UV, UV, 3)).astype(np.float32))


def _torch_batch(b):
    return {k: (torch.tensor(v) if k == "exp_type" else torch.from_numpy(v.copy()))
            for k, v in b.items()}


def _draws(key):
    """The uniforms of the JAX step keyed `key`, for the whole batch."""
    k_strat, k_pdf, _, _ = jax.random.split(key, 4)
    return {"strat": torch.from_numpy(np.array(jax.random.uniform(k_strat, (N_RAYS, N_SAMPLES)))),
            "pdf": torch.from_numpy(np.array(jax.random.uniform(k_pdf, (N_RAYS, N_SAMPLES))))}


def _store():
    """A small device-resident split (numpy-made): 4 frames of 16x16."""
    rng = np.random.default_rng(7)
    n, side = 4, 16
    poses = np.stack([pose_spherical(a, -10.0, 16.0) for a in (-30.0, -10.0, 10.0, 30.0)])
    return DeviceDataset(
        images=torch.from_numpy(rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)),
        poses=torch.from_numpy(poses.astype(np.float32)),
        shape_codes=torch.from_numpy((rng.standard_normal((n, 50)) * 0.3).astype(np.float32)),
        exp_types=torch.from_numpy(rng.integers(0, 20, n).astype(np.int32)),
        uv_maps=torch.from_numpy(rng.uniform(0, 1, (1, UV, UV, 3)).astype(np.float32)),
        uv_index=torch.zeros(n, dtype=torch.int32),
        lm2d=torch.from_numpy(rng.uniform(4, 12, (n, 68, 2)).astype(np.float32)),
        fg_pixels=torch.zeros((n, 16, 2), dtype=torch.int32))


STORE_K = torch.tensor([[32.0, 0, 8.0], [0, 32.0, 8.0], [0, 0, 1]])
SCFG = DeviceSamplerConfig(n_rand=N_RAYS, H=16, W=16, precrop_iters=0, precrop_frac=0.5,
                           lm_frac=0.5, lm_frac_anneal_iters=0, bias="landmarks")


@pytest.fixture(scope="module")
def setup():
    """The JAX init and the JAX steps over the batch sequence; the port's
    state carried across; the payload parts the worlds share."""
    jspec, tspec = _specs()
    jstate0 = jax.jit(lambda k: jstate.create_train_state(k, jspec))(jax.random.PRNGKey(0))
    tx = jstate.make_optimizer()
    step = jax.jit(lambda s, b, k: jstate.train_step(s, b, k, jspec, tx))
    batches = [_batch(10 + k, nan=(k == 2)) for k in range(N_STEPS)]
    js, jlosses = jstate0, []
    for k, b in enumerate(batches):
        jb = jstate.Batch(**{n: (jnp.asarray(v, jnp.int32) if n == "exp_type" else jnp.asarray(v))
                             for n, v in b.items()})
        js, jm = step(js, jb, jax.random.PRNGKey(k))
        jlosses.append(float(jm["loss"]))
    state0 = bridge.train_state_to_torch(jax.tree.map(np.asarray, jstate0), tspec, device="cpu")
    train = dict(spec=tspec, state=state0, batches=[_torch_batch(b) for b in batches],
                 draws=[_draws(jax.random.PRNGKey(k)) for k in range(N_STEPS)])
    tp_batch = _torch_batch(batches[0])
    tp = dict(spec=tspec, params=state0.params, batch=tp_batch, draws=train["draws"][0],
              pts=torch.from_numpy(np.random.default_rng(8).standard_normal((96, 3))
                                   .astype(np.float32) * 2.0))
    chunk = dict(spec=tspec, state=state0, store=_store(), K=STORE_K, scfg=SCFG, i0=0,
                 n_steps=2, seed=5)
    return dict(tspec=tspec, jlosses=np.array(jlosses), train=train, tp=tp, chunk=chunk,
                state0=state0)


# world size -> the payload's parts, each with its mesh (data, model)
def _payload(n, s):
    parts = {1: {"train": (1, 1), "chunk": (1, 1)},
             2: {"tp": (1, 2), "train": (2, 1), "chunk": (2, 1)},
             4: {"tp": (2, 2), "train": (4, 1), "train:tp": (2, 2)}}[n]
    return {key: dict(s[key.split(":")[0]], mesh=mesh, shard=key == "train:tp")
            for key, mesh in parts.items()}


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    """Worlds 1, 2 and 4 of gloo ranks on the CPU, each spawned once."""
    return {n: run_world(dryrun.sharded_paths, n, _payload(n, setup),
                         workdir=str(tmp_path_factory.mktemp("w")), device="cpu", timeout_s=120.0)
            for n in (1, 2, 4)}


def _max_rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("n", [2, 4], ids=["model2", "data2_model2"])
def test_tensor_parallel_fine_field_and_every_gradient(worlds, n):
    for r in worlds[n]:
        whole, sharded = r["tp"]["whole"], r["tp"]["sharded"]
        for k in ("raw_rgb", "raw_sigma"):
            assert _max_rel(sharded[k], whole[k]) <= 1e-5, k
        assert _max_rel(sharded["loss"], whole["loss"]) <= 1e-5
        names = [p for p, _ in flatten_with_keystr(whole["grads"])]
        pairs = zip(names, [g for _, g in flatten_with_keystr(sharded["grads"])],
                    [g for _, g in flatten_with_keystr(whole["grads"])])
        for name, got, ref in pairs:
            assert got.shape == ref.shape, name
            assert _max_rel(got, ref) <= 1e-5, (name, _max_rel(got, ref))
        # the gradient reaches the leaves before the fine field's first layer
        for part in ("['ism']", "['exp_codes']", "['tex_encoder']"):
            assert any(float(g.abs().max()) > 0 for nm, g in
                       flatten_with_keystr(whole["grads"]) if nm.startswith(part)), part


@pytest.mark.parametrize("key", ["1:train", "2:train", "4:train", "4:train:tp"])
def test_train_step_over_the_mesh(worlds, setup, key):
    n, part = int(key[0]), key[2:]
    base = worlds[1][0]["train"]
    for r in worlds[n]:
        got = r[part]
        # every rank took the same steps; the third was skipped everywhere
        assert got["ok"].tolist() == [True, True, False, True]
        assert got["count"] == 3 and got["step"] == N_STEPS
        assert not np.isfinite(float(got["loss"][2]))
        good = [0, 1, 3]
        np.testing.assert_allclose(got["loss"].numpy()[good], setup["jlosses"][good], rtol=1e-4)
        np.testing.assert_allclose(got["loss"].numpy()[good], base["loss"].numpy()[good],
                                   rtol=1e-4)
        err = max(float((a - b).abs().max()) for (_, a), (_, b) in
                  zip(flatten_with_keystr(got["params"]), flatten_with_keystr(base["params"])))
        assert err < 1e-5, err
    moved = max(float((a - b).abs().max()) for (_, a), (_, b) in
                zip(flatten_with_keystr(worlds[n][0][part]["params"]),
                    flatten_with_keystr(setup["state0"].params)))
    assert moved > 1e-5


def test_device_data_chunk_over_the_mesh(worlds, setup):
    c = setup["chunk"]
    state, m = train_chunk_device_data(c["state"], c["store"], c["K"], 0, 2, c["scfg"],
                                       c["spec"], tstate.make_optimizer(), c["seed"])
    one, two = worlds[1][0]["chunk"], worlds[2]
    # world 1 draws the whole batch as the call without a mesh does: bit for bit
    assert torch.equal(one["loss"], m["loss"])
    for (_, a), (_, b) in zip(flatten_with_keystr(one["params"]),
                              flatten_with_keystr(state.params)):
        assert torch.equal(a, b)
    for r in two:
        got = r["chunk"]
        assert got["step"] == 2
        np.testing.assert_allclose(float(got["loss"]), float(one["loss"]), rtol=1e-4)
        err = max(float((a - b).abs().max()) for (_, a), (_, b) in
                  zip(flatten_with_keystr(got["params"]), flatten_with_keystr(one["params"])))
        assert err < 1e-5, err
