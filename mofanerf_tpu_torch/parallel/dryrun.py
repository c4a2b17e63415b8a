"""Run the multi-card paths on a world of ranks (counterpart of
__graft_entry__.py::dryrun_multichip).

    python -m mofanerf_tpu_torch.parallel.dryrun N [--device cpu] [--backend gloo]

spawns N ranks (parallel/world.py), one process each; with N even the mesh
is (data N/2, model 2), else (data N, model 1). Every rank runs:

  (a) one train step at the flagship widths (coarse 8x256 + fine 10x1024,
      bf16; 4 + 4 samples, UV 128, 4 rays a data rank): the fine field in
      model shards, tensor-parallel; the batch over data;
  (b) a two-step device-data chunk (train/loop.py::train_chunk_device_data)
      under the same mesh;
  (c) a sharded serving sweep (render_path_serve(mesh=)) held against the
      single-card sweep;

and rank 0 prints one line for each. The default device is the card: NCCL
with a card a rank, gloo for ranks that share one (`--backend gloo`).

`sharded_paths` is the other worker of this module: from given inputs it
runs the port's sharded functions (and, where a rank can, their whole
counterparts) and returns what they return, for holding them against the
single-card paths and the JAX package's.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from mofanerf_tpu_torch.ops.flat_adam import FlatLayout
from mofanerf_tpu_torch.parallel.collectives import all_reduce_mean_, model_axis
from mofanerf_tpu_torch.parallel.mesh import (axis_size, gather_params, make_mesh,
                                              make_multihost_mesh, shard_params,
                                              shard_params_rules, sharded_leaves)
from mofanerf_tpu_torch.utils.tree import map_tree, tree_leaves, tree_unflatten


def _to(tree, dev):
    return map_tree(lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, tree)


def _cpu(tree):
    return map_tree(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, tree)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def shard_state(state, rules, mesh):
    """A TrainState's params and Adam moments in this rank's model shards."""
    from mofanerf_tpu_torch.train.state import AdamState, TrainState

    opt = state.opt_state
    return TrainState(shard_params(state.params, rules, mesh),
                      AdamState(opt.count, shard_params(opt.mu, rules, mesh),
                                shard_params(opt.nu, rules, mesh)), state.step)


def _state_to(state, dev):
    from mofanerf_tpu_torch.train.state import AdamState, TrainState

    opt = state.opt_state
    return TrainState(_to(state.params, dev),
                      AdamState(opt.count.to(dev), _to(opt.mu, dev), _to(opt.nu, dev)),
                      state.step.to(dev))


# ---------------------------------------------------------------------------
# the dryrun


def dryrun_rank(dev: torch.device, payload=None) -> Dict[str, float]:
    """(a), (b) and (c) of the module docstring on this rank."""
    from mofanerf_tpu_torch.data.device_data import DeviceDataset, DeviceSamplerConfig
    from mofanerf_tpu_torch.models.field import FieldConfig
    from mofanerf_tpu_torch.models.student import StudentConfig, init_point_field
    from mofanerf_tpu_torch.ops.rays import pose_spherical
    from mofanerf_tpu_torch.render.renderer import MoFaNeRF, RenderConfig
    from mofanerf_tpu_torch.render.serve import render_path_serve
    from mofanerf_tpu_torch.train.loop import train_chunk_device_data
    from mofanerf_tpu_torch.train.state import (Batch, create_train_state, make_optimizer,
                                                train_step)

    world = dist.get_world_size()
    n_model = 2 if world % 2 == 0 else 1
    n_data = world // n_model
    mesh = make_mesh(n_data, n_model)
    lead = dist.get_rank() == 0

    # (a) the flagship widths (tools/config_parser.py:17-24), few rays and samples
    spec = MoFaNeRF(coarse=FieldConfig(depth=8, width=256, compute_dtype=torch.bfloat16),
                    fine=FieldConfig(depth=10, width=1024, compute_dtype=torch.bfloat16),
                    render=RenderConfig(n_coarse=4, n_importance=4), uv_size=128)
    state = create_train_state(torch.Generator().manual_seed(0), spec, device=dev)
    tx = make_optimizer()
    rules = shard_params_rules(state.params, mesh)
    w_rule = rules["fine"]["sigma"]["w_feat0"][-1]
    if (n_model > 1) != (getattr(w_rule, "dim", None) == 1):
        raise RuntimeError(f"tensor-parallel rule inactive: w_feat0 placed {w_rule}")
    state = shard_state(state, rules, mesh)

    n_rays = 4 * n_data
    g = torch.Generator().manual_seed(1)
    rd = torch.randn((n_rays, 3), generator=g)
    rd = (rd / torch.linalg.norm(rd, dim=-1, keepdim=True)).to(dev)
    batch = Batch(rays_o=torch.zeros((n_rays, 3), device=dev), rays_d=rd,
                  target_rgb=torch.full((n_rays, 3), 0.5, device=dev),
                  shape_code=torch.zeros(spec.shape_dim, device=dev),
                  exp_type=torch.zeros((), dtype=torch.int64, device=dev),
                  uv_map=torch.full((spec.uv_size, spec.uv_size, 3), 0.5, device=dev))
    new_state, metrics = train_step(state, batch, torch.Generator(device=dev).manual_seed(2),
                                    spec, tx, mesh=mesh)
    loss = float(metrics["loss"])
    if not np.isfinite(loss) or int(new_state.step) != 1:
        raise RuntimeError(f"flagship train step: loss {loss}, step {int(new_state.step)}")
    if lead:
        print(f"dryrun_multichip train OK: flagship 10x1024 fine, mesh=(data={n_data}, "
              f"model={n_model}), loss={loss:.4f}", flush=True)

    # (b) the device-resident data path under the same mesh: two steps, the
    # batch sampled on the device, the fine field still in model shards
    Hd = Wd = 8
    n_frames = 4
    store = DeviceDataset(
        images=torch.randint(0, 255, (n_frames, Hd, Wd, 3), generator=g,
                             dtype=torch.uint8).to(dev),
        poses=torch.eye(4).repeat(n_frames, 1, 1).to(dev),
        shape_codes=torch.zeros((n_frames, spec.shape_dim), device=dev),
        exp_types=torch.zeros((n_frames,), dtype=torch.int32, device=dev),
        uv_maps=torch.full((1, spec.uv_size, spec.uv_size, 3), 0.5, device=dev),
        uv_index=torch.zeros((n_frames,), dtype=torch.int32, device=dev),
        lm2d=torch.full((n_frames, 68, 2), Hd / 2.0, device=dev),
        fg_pixels=torch.zeros((n_frames, 16, 2), dtype=torch.int32, device=dev))
    scfg = DeviceSamplerConfig(n_rand=4 * n_data, H=Hd, W=Wd, precrop_iters=0,
                               precrop_frac=0.5, lm_frac=0.5, lm_frac_anneal_iters=0,
                               bias="landmarks")
    Kd = torch.tensor([[10.0, 0, Wd / 2], [0, 10.0, Hd / 2], [0, 0, 1]], device=dev)
    dstate, dm = train_chunk_device_data(state, store, Kd, 0, 2, scfg, spec, tx, seed=5,
                                         mesh=mesh)
    dloss = float(dm["loss"])
    if not np.isfinite(dloss) or int(dstate.step) != 2:
        raise RuntimeError(f"device-data chunk: loss {dloss}, step {int(dstate.step)}")
    if lead:
        print(f"dryrun_multichip device-data OK: 2-step chunk, batches sampled on the "
              f"device, loss={dloss:.4f}", flush=True)

    # (c) the sharded serving sweep against one card's (rays are independent and
    # the compaction is global: the maps agree)
    scfg_s = StudentConfig(depth=2, width=32, multires=4, compute_dtype=torch.float32)
    sparams, scond = init_point_field(torch.Generator().manual_seed(3), scfg_s, device=dev)
    sparams["sigma"]["b"] = sparams["sigma"]["b"] + 1.0   # a non-empty field
    H = W = 16
    Ks = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
    poses = np.stack([pose_spherical(a, -10.0, 16.0) for a in (0.0, 90.0)])
    kw = dict(near=8.0, far=26.0, n_samples=8, packet_size=256, hit_fraction=1.0)
    single = render_path_serve(sparams, scfg_s, scond, poses, H, W, Ks, **kw)
    sharded = render_path_serve(sparams, scfg_s, scond, poses, H, W, Ks, mesh=mesh, **kw)
    err = float((single["rgb"] - sharded["rgb"]).abs().max())
    if not torch.isfinite(sharded["rgb"]).all() or not err < 1e-4:
        raise RuntimeError(f"sharded serve deviates: {err}")
    if lead:
        print(f"dryrun_multichip serve OK: sharded sweep == single (max {err:.2e})",
              flush=True)
    return {"loss": loss, "device_data_loss": dloss, "serve_err": err}


# ---------------------------------------------------------------------------
# the sharded paths from given inputs


def _median_sec(fn, n: int, dev) -> float | None:
    """The median seconds of n calls of fn after one warm-up, each ending in
    a synchronisation of the card (None for n = 0)."""
    if n == 0:
        return None
    fn()
    times = []
    for _ in range(n):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _sharded_leaves(spec, mesh):
    """The key paths that shard_params_rules shards in the whole model tree
    of `spec` (meta tensors: shapes only)."""
    from mofanerf_tpu_torch.render.renderer import init_model_params

    params = init_model_params(torch.Generator().manual_seed(0), spec, device="meta")
    return sharded_leaves(params, shard_params_rules(params, mesh))


def _psum(per_host: int):
    """A gradient-style sum of arange(8) held in blocks over (dcn, data) of a
    multihost mesh of `per_host` ranks a host: the data groups first, then
    dcn."""
    os.environ["LOCAL_WORLD_SIZE"] = str(per_host)   # what torchrun sets on each host
    mesh = make_multihost_mesh(n_model=1)
    n = axis_size(mesh, "dcn") * axis_size(mesh, "data")
    rank = mesh.get_local_rank("dcn") * axis_size(mesh, "data") + mesh.get_local_rank("data")
    x = torch.arange(8.0).reshape(n, -1)[rank].sum()
    dist.all_reduce(x, group=mesh.get_group("data"))
    dist.all_reduce(x, group=mesh.get_group("dcn"))
    return {"shape": [axis_size(mesh, k) for k in ("dcn", "data", "model")], "sum": float(x)}


def _teacher(t, mesh, dev):
    from mofanerf_tpu_torch.ops import field_kernel as fk
    from mofanerf_tpu_torch.render.renderer import (exp_code_for, prepare_conditioning,
                                                    render_frame_sharded)

    spec, params = t["spec"], _to(t["params"], dev)
    rules = None
    if t.get("shard") and model_axis(mesh) is not None:
        rules = shard_params_rules(params, mesh)
        params = shard_params(params, rules, mesh)
    with torch.no_grad():
        cond = prepare_conditioning(params, spec, t["shape"].to(dev),
                                    exp_code_for(params, t["exp"]), t["tex"].to(dev),
                                    model_axis(mesh) if rules else None)

    def frame():
        return render_frame_sharded(params, spec, cond, t["H"], t["W"], t["K"], t["c2w"], mesh,
                                    rules=rules)

    _sync(dev)
    fk.launch_count = 0
    maps = frame()
    _sync(dev)
    return {"maps": _cpu(maps), "launches": fk.launch_count,
            "sec": _median_sec(frame, t.get("timed", 0), dev)}


def _serve(t, mesh, dev):
    from mofanerf_tpu_torch.ops import serve_kernel as sk
    from mofanerf_tpu_torch.render.serve import render_path_serve

    params = _to(t["params"], dev)
    cond = None if t.get("cond") is None else t["cond"].to(dev)
    _sync(dev)
    sk.launch_count = 0
    maps = render_path_serve(params, t["cfg"], cond, t["poses"], t["H"], t["W"], t["K"],
                             mesh=mesh, **t.get("kw", {}))
    _sync(dev)
    return {"maps": _cpu(maps), "launches": sk.launch_count}


def _tp(t, mesh, dev):
    """The whole model's loss and every leaf's gradient, and the fine
    field's raw outputs, with the fine field whole and in model shards
    (tensor-parallel); the shards' gradients gathered whole."""
    from mofanerf_tpu_torch.models.field import apply_field_folded
    from mofanerf_tpu_torch.ops.embed import fourier_embed
    from mofanerf_tpu_torch.render.renderer import (exp_code_for, prepare_conditioning)
    from mofanerf_tpu_torch.train.state import Batch, loss_fn

    spec, params = t["spec"], _to(t["params"], dev)
    batch = Batch(**_to(t["batch"], dev))
    draws = _to(t["draws"], dev)
    rules = shard_params_rules(params, mesh)
    tp = model_axis(mesh)
    out = {}
    for name, tree, axis in (("whole", params, None),
                             ("sharded", shard_params(params, rules, mesh), tp)):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
        p = tree_unflatten(tree, live)
        loss, _ = loss_fn(p, spec, batch, None, draws, axis)
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        grads = tree_unflatten(tree, list(grads))
        if axis is not None:
            grads = gather_params(grads, rules, mesh)
        with torch.no_grad():
            cond = prepare_conditioning(p, spec, batch.shape_code,
                                        exp_code_for(p, batch.exp_type),
                                        torch.zeros(spec.tex_dim, device=dev), axis)
            pts = t["pts"].to(dev)
            dirs = pts / torch.linalg.norm(pts, dim=-1, keepdim=True)
            dir_feat = fourier_embed(dirs, spec.fine.multires_views) @ p["fine"]["view"]["w_dirs"]
            raw = apply_field_folded(p["fine"], cond.fine, fourier_embed(pts, spec.fine.multires),
                                     dir_feat, spec.fine, tp=axis)
        out[name] = {"loss": loss.detach().cpu(), "grads": _cpu(grads),
                     "raw_rgb": raw[0].cpu(), "raw_sigma": raw[1].cpu()}
    return out


def _train(t, mesh, dev):
    """train_step(mesh=) over a sequence of whole batches from a given
    state; the reduced gradients of the first batch; the all_reduce of a
    gradient tree's flat buffer, timed."""
    from mofanerf_tpu_torch.train.state import Batch, batch_grads, make_optimizer, train_step

    spec = t["spec"]
    tx = make_optimizer()
    state = _state_to(t["state"], dev)
    rules = None
    if t.get("shard") and model_axis(mesh) is not None:
        rules = shard_params_rules(state.params, mesh)
        state = shard_state(state, rules, mesh)
    batches = [Batch(**_to(b, dev)) for b in t["batches"]]
    draws = [None if d is None else _to(d, dev) for d in t["draws"]]

    def gen(k):
        return torch.Generator(device=dev).manual_seed(t.get("seed", 0) + k)

    _, _, grads = batch_grads(state.params, batches[0], gen(0), spec, draws[0], mesh)
    grads = tree_unflatten(state.params, grads)
    if rules is not None:
        grads = gather_params(grads, rules, mesh)
    loss, psnr, ok = [], [], []
    state0 = state
    for k, (b, d) in enumerate(zip(batches, draws)):
        state, m = train_step(state, b, gen(k), spec, tx, draws=d, mesh=mesh)
        loss.append(m["loss"])
        psnr.append(m["psnr"])
        ok.append(m["step_ok"])
    params = state.params if rules is None else gather_params(state.params, rules, mesh)
    leaves = tree_leaves(state.params)
    flat = FlatLayout.of(leaves).pack(leaves)
    return {"loss": torch.stack(loss).cpu(), "psnr": torch.stack(psnr).cpu(),
            "ok": torch.stack(ok).cpu(), "params": _cpu(params), "grads0": _cpu(grads),
            "count": int(state.opt_state.count), "step": int(state.step),
            "step_sec": _median_sec(lambda: train_step(state0, batches[0], gen(0), spec, tx,
                                                       draws=draws[0], mesh=mesh),
                                    t.get("timed", 0), dev),
            "all_reduce_sec": _median_sec(lambda: all_reduce_mean_(flat, mesh), 3, dev),
            "all_reduce_bytes": 4 * flat.numel()}


def _chunk(t, mesh, dev):
    from mofanerf_tpu_torch.data.device_data import DeviceDataset
    from mofanerf_tpu_torch.train.loop import train_chunk_device_data
    from mofanerf_tpu_torch.train.state import make_optimizer

    state = _state_to(t["state"], dev)
    store = DeviceDataset(*_to(list(t["store"]), dev))
    state, m = train_chunk_device_data(state, store, t["K"].to(dev), t["i0"], t["n_steps"],
                                       t["scfg"], t["spec"], make_optimizer(),
                                       t["seed"], mesh)
    return {"loss": m["loss"].cpu(), "params": _cpu(state.params), "step": int(state.step)}


_PARTS = {"teacher": _teacher, "serve": _serve, "tp": _tp, "train": _train, "chunk": _chunk}


def sharded_paths(dev: torch.device, payload: Dict[str, Any]) -> Dict[str, Any]:
    """The parts of `payload` on this rank, in its order, each on the
    (data, model) mesh of its own "mesh", else of payload["mesh"] (default:
    every rank on data). A part's key is its name, or its name, ":" and a
    label, so that a part can run twice:

    - "rules": a MoFaNeRF spec -> the sorted key paths that
      shard_params_rules shards in its whole model tree;
    - "psum": ranks a host -> the (dcn, data, model) shape of a multihost mesh
      and the sum of arange(8) over it;
    - "teacher": render_frame_sharded of given params, codes and camera
      (`shard`: the params in model shards, gathered a frame; `timed`: the
      median s of that many more frames);
    - "serve": render_path_serve(mesh=) of a given student and poses;
    - "tp": loss_fn's loss and gradients and the fine field's outputs, whole
      and tensor-parallel;
    - "train": train_step(mesh=) over given whole batches and draws (None:
      a generator seeded `seed + k`) from a given TrainState, the first
      batch's reduced gradients, the s of the gradient buffer's all_reduce
      (`timed`: the median s of that many more first steps);
    - "chunk": train_chunk_device_data from a given state and DeviceDataset.

    Tensors come in on the CPU and go back on it. `payload` may also be the
    path of a file that torch.save wrote it to (inputs too large to pass
    through the spawn's pipe and shared memory: a full-width model)."""
    if isinstance(payload, str):
        payload = torch.load(payload, weights_only=False)   # written by the caller
    mesh = make_mesh(*payload.get("mesh", (None, 1)))
    out = {"mesh": tuple(mesh.shape)}
    for key, t in payload.items():
        name = key.split(":")[0]
        if name == "rules":
            out[key] = _sharded_leaves(t, mesh)
        elif name == "psum":
            out[key] = _psum(t)
        elif name in _PARTS:
            out[key] = _PARTS[name](t, make_mesh(*t["mesh"]) if "mesh" in t else mesh, dev)
    return out


def main(argv=None) -> int:
    from mofanerf_tpu_torch.parallel.world import run_world

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds for the world")
    args = ap.parse_args(argv)
    run_world(dryrun_rank, args.n, device=args.device, backend=args.backend,
              timeout_s=args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
