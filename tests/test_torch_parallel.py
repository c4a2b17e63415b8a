"""The port's multi-card layer (mofanerf_tpu_torch/parallel) on the CPU over
gloo: meshes, the tensor-parallel rule, the sharded teacher frame and the
sharded serving path, against the JAX package's sharded functions on the
8-device virtual mesh and against the port's own single-card calls.

Each world is spawned once (a module-scoped fixture): its ranks run the
port's worker `parallel/dryrun.py::sharded_paths` on numpy-made inputs (the
JAX params carried across by the bridge) and return what every rank got, and
the checks are parametrised over the results. The children import torch and
the port only.

- world 2, mesh (data 2, model 1); world 4, mesh (data 2, model 2) with the
  fine field in model shards (gathered once a frame) and the serving path on
  (data 4, model 1);
- render_frame_sharded against JAX's on a mesh of the same shape at
  tests/test_torch_renderer.py's render_frame tolerance, and within 1e-6 of
  the port's render_frame; render_path_serve(mesh=) against JAX's at
  tests/test_torch_serve.py's tolerances and against the port's single call
  at rtol 1e-5, atol 1e-6 (tests/test_scaling.py's bound);
- every rank holds the whole result."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.models import field as jfield
from mofanerf_tpu.models import student as jstudent
from mofanerf_tpu.ops.embed import fourier_embed as jembed
from mofanerf_tpu.ops.rays import pose_spherical
from mofanerf_tpu.parallel import mesh as jmesh
from mofanerf_tpu.render import renderer as jr
from mofanerf_tpu.render import serve as jserve
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.models import student as tstudent
from mofanerf_tpu_torch.parallel import (dryrun, make_mesh, make_multihost_mesh, ray_sharding,
                                         replicated)
from mofanerf_tpu_torch.parallel.world import run_world, single_rank
from mofanerf_tpu_torch.render import renderer as tr
from mofanerf_tpu_torch.render import serve as tserve
from test_torch_renderer import _check as check_render
from test_torch_serve import _check as check_serve

REPO = Path(__file__).resolve().parents[1]
T = torch.from_numpy
H = W = 16
K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
C2W = np.asarray(pose_spherical(15.0, -10.0, 16.0), np.float32)[:3]
SERVE_POSES = np.stack([pose_spherical(a, -5.0, 16.0) for a in (-20.0, 0.0, 25.0)])
SERVE_KW = dict(near=8.0, far=26.0, n_samples=8, aabb_min=(-2.0,) * 3, aabb_max=(2.0,) * 3,
                packet_size=256, hit_fraction=None)
# world size -> (the payload's mesh, the teacher frame's params in model shards,
# the serving path's mesh)
WORLDS = {2: ((2, 1), False, (2, 1)), 4: ((2, 2), True, (4, 1))}


def _specs():
    fkw = dict(depth=8, multires=10)
    rkw = dict(n_coarse=4, n_importance=4, packet_size=16)
    jspec = jr.MoFaNeRF(coarse=jfield.FieldConfig(width=64, **fkw),
                        fine=jfield.FieldConfig(width=128, **fkw),
                        render=jr.RenderConfig(**rkw), uv_size=128)
    tspec = tr.MoFaNeRF(coarse=tfield.FieldConfig(width=64, **fkw),
                        fine=tfield.FieldConfig(width=128, **fkw),
                        render=tr.RenderConfig(**rkw), uv_size=128)
    return jspec, tspec


def _codes():
    rng = np.random.default_rng(100)
    return [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (50, 30, 256)]


@pytest.fixture(scope="module")
def teacher():
    """JAX model params with visible structure (each alpha head rescaled to
    median 0, spread 3 over probe points, as tests/test_torch_renderer.py
    does), the JAX conditioning, and the port's params and conditioning."""
    jspec, tspec = _specs()
    jp = jax.tree.map(np.array, jr.init_model_params(jax.random.PRNGKey(5), jspec))
    probe = np.random.default_rng(5).uniform(-1, 1, (512, 3)).astype(np.float32) * [3, 3, 9]
    shape, _, tex = _codes()
    for name in ("coarse", "fine"):
        cfg = getattr(jspec, name)
        p = jax.tree.map(jnp.asarray, jp[name])
        cond = jfield.fold_conditioning(p, jnp.asarray(shape), jnp.asarray(_codes()[1]),
                                        jnp.asarray(tex))
        sig = np.asarray(jfield.apply_field_sigma(
            p, cond, jembed(jnp.asarray(probe.astype(np.float32) + [0, 0, -1]), cfg.multires),
            cfg))
        gain = np.float32(3.0 / sig.std())
        jp[name]["sigma"]["alpha"]["w"] = jp[name]["sigma"]["alpha"]["w"] * gain
        jp[name]["sigma"]["alpha"]["b"] = (jp[name]["sigma"]["alpha"]["b"]
                                           - np.float32(np.median(sig))) * gain
    jparams = jax.tree.map(jnp.asarray, jp)
    jcond = jr.prepare_conditioning(jparams, jspec, jnp.asarray(shape),
                                    jr.exp_code_for(jparams, 3), jnp.asarray(tex))
    tp = bridge.model_params_to_torch(jp, tspec, device="cpu")
    tcond = tr.prepare_conditioning(tp, tspec, T(shape), tr.exp_code_for(tp, 3), T(tex))
    return dict(jspec=jspec, tspec=tspec, jparams=jparams, jcond=jcond, tparams=tp, tcond=tcond,
                shape=shape, tex=tex)


@pytest.fixture(scope="module")
def student():
    kw = dict(depth=3, width=128, multires=6, cond_dim=5)
    jcfg = jstudent.StudentConfig(compute_dtype=jnp.float32, **kw)
    tcfg = tstudent.StudentConfig(compute_dtype=torch.float32, **kw)
    jp = jstudent.init_student_params(jax.random.PRNGKey(3), jcfg)
    jp["sigma"]["b"] = jp["sigma"]["b"] + 1.0
    jp["cond"]["w_layers"] = jax.random.normal(jax.random.PRNGKey(4),
                                               jp["cond"]["w_layers"].shape) * 0.05
    jp = jax.tree.map(np.asarray, jp)
    code = np.random.default_rng(3).standard_normal(5).astype(np.float32) * 0.3
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jax.tree.map(jnp.asarray, jp),
                tparams=bridge.student_to_torch(jp, tcfg, "cpu"), code=code)


@pytest.fixture(scope="module", params=sorted(WORLDS), ids=lambda n: f"world{n}")
def world(request, teacher, student, tmp_path_factory):
    """One world of gloo ranks on the CPU, spawned once: what each rank returned."""
    n = request.param
    mesh, shard, serve_mesh = WORLDS[n]
    payload = {
        "mesh": mesh,
        "rules": dataclasses.replace(teacher["tspec"], fine=tfield.FieldConfig(depth=10,
                                                                            width=1024)),
        "psum": n // 2 if n == 4 else n,
        "teacher": dict(spec=teacher["tspec"], params=teacher["tparams"], shape=T(teacher["shape"]),
                        exp=3, tex=T(teacher["tex"]), H=H, W=W, K=K, c2w=C2W, shard=shard),
        "serve": dict(params=student["tparams"], cfg=student["tcfg"], cond=T(student["code"]),
                      poses=SERVE_POSES, H=H, W=W, K=K, kw=SERVE_KW, mesh=serve_mesh),
    }
    ranks = run_world(dryrun.sharded_paths, n, payload, workdir=str(tmp_path_factory.mktemp("w")),
                      device="cpu", timeout_s=120.0)
    return n, ranks


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh()


def test_ray_sharding_and_replicated_match_jax(tmp_path):
    """The placements, one a mesh axis, of a ray batch (rows split over
    `data`) and of a replicated leaf equal JAX's P("data") and P() on the
    (data, model) and the (dcn, data, model) meshes."""
    from torch.distributed.tensor import Replicate, Shard

    def placements(mesh, spec):
        split = spec[0] if len(spec) else ()
        split = split if isinstance(split, tuple) else (split,)
        return tuple(Shard(0) if name in split else Replicate() for name in mesh.axis_names)

    with single_rank("cpu", str(tmp_path)):
        for mesh, jm in ((make_mesh(), jmesh.make_mesh(devices=jax.devices()[:1])),
                         (make_multihost_mesh(), jmesh.make_multihost_mesh())):
            assert mesh.mesh_dim_names == jm.axis_names
            assert ray_sharding(mesh) == placements(jm, jmesh.ray_sharding(jm).spec)
            assert replicated(mesh) == placements(jm, jmesh.replicated(jm).spec)
            assert Shard(0) in ray_sharding(mesh) and Shard(0) not in replicated(mesh)


def test_mesh_shapes_and_the_multihost_sum(world):
    n, ranks = world
    for r in ranks:
        assert r["mesh"] == WORLDS[n][0]
        # dcn = world / ranks a host: 2 hosts of 2 at world 4, one host at world 2
        assert r["psum"]["shape"] == ([2, 2, 1] if n == 4 else [1, 2, 1])
        np.testing.assert_allclose(r["psum"]["sum"], 28.0)


def test_shard_rules_shard_exactly_the_leaves_jax_shards(world):
    """At the flagship widths (shapes only), the port's rule on its mesh and
    JAX's on make_mesh(2, 2) of the virtual devices shard the same leaves."""
    n, ranks = world
    jspec = dataclasses.replace(_specs()[0], fine=jfield.FieldConfig(depth=10, width=1024))
    shapes = jax.eval_shape(lambda: jr.init_model_params(jax.random.PRNGKey(0), jspec))
    n_model = WORLDS[n][0][1]
    jrules = jmesh.shard_params_rules(
        shapes, jmesh.make_mesh(n_data=2, n_model=n_model, devices=jax.devices()[:2 * n_model]))
    want = sorted(jax.tree_util.keystr(kp) for kp, s in
                  jax.tree_util.tree_flatten_with_path(jrules)[0] if s.spec != jax.sharding.PartitionSpec())
    assert (len(want) > 0) == (n_model > 1)
    for r in ranks:
        assert r["rules"] == want


def test_render_frame_sharded_matches_jax_and_render_frame(world, teacher):
    n, ranks = world
    (n_data, n_model), _, _ = WORLDS[n]
    jm = jmesh.make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:n])
    want = jr.render_frame_sharded(teacher["jparams"], teacher["jspec"], teacher["jcond"], H, W,
                                   jnp.asarray(K), jnp.asarray(C2W), jm)
    single = tr.render_frame(teacher["tparams"], teacher["tspec"], teacher["tcond"], H, W, K, C2W)
    for r in ranks:
        got = r["teacher"]["maps"]
        assert got["rgb"].shape == (H, W, 3)
        # each package's own rays: see tests/test_torch_renderer.py (render_frame)
        check_render(got, want, 2e-4, tuple(want), jump=5e-2)
        for k in single:
            np.testing.assert_allclose(got[k].numpy(), single[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
        assert float(got["acc"].max()) > 0.05   # a scene, not an empty frame


def test_render_path_serve_mesh_matches_jax_and_the_single_call(world, student):
    n, ranks = world
    jm = jmesh.make_mesh(n_data=WORLDS[n][2][0], n_model=1, devices=jax.devices()[:n])
    kw = dict(SERVE_KW)
    want = jserve.render_path_serve(student["jparams"], student["jcfg"], jnp.asarray(student["code"]),
                                    jnp.asarray(SERVE_POSES), H, W, jnp.asarray(K), fused=True,
                                    mesh=jm, **kw)
    single = tserve.render_path_serve(student["tparams"], student["tcfg"], T(student["code"]),
                                      SERVE_POSES, H, W, K, **kw)
    for r in ranks:
        got = r["serve"]["maps"]
        assert got["rgb"].shape == (3, H, W, 3)
        check_serve(got, want, 1e-4, 1e-3)
        for k in single:
            np.testing.assert_allclose(got[k].numpy(), single[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_dryrun_prints_its_three_lines(tmp_path):
    """`python -m mofanerf_tpu_torch.parallel.dryrun 2 --device cpu`: the
    flagship train step over (data 1, model 2), the device-data chunk and the
    serving sweep, one line each."""
    env = dict(os.environ, PYTHONPATH=str(REPO), TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "mofanerf_tpu_torch.parallel.dryrun", "2",
                           "--device", "cpu", "--timeout", "120"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip")]
    assert len(lines) == 3, proc.stdout
    assert "train OK: flagship 10x1024 fine, mesh=(data=1, model=2)" in lines[0]
    assert "device-data OK" in lines[1] and "serve OK" in lines[2]
