"""Process groups, device meshes and the tensor-parallel rule (counterpart of
mofanerf_tpu/parallel/mesh.py).

JAX's mesh is single-controller: one process drives every device, and a
sharded function takes and returns global arrays. The port follows PyTorch's
idiom instead, one process a card:

- every rank calls a sharded function with the same replicated inputs
  (params, conditioning, poses, the whole batch), as the JAX call receives
  them;
- every rank gets back the whole result, as JAX returns a global array.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the default
process group with the axes ("data", "model"), or ("dcn", "data", "model")
across hosts, made by `init_device_mesh`: what `jax.sharding.Mesh` is to the
JAX package. The sharded functions run explicit collectives on the axes'
process groups (parallel/collectives.py), so every collective is visible and
counted; no DTensor is made.

- `data`: rays (a frame's, a serving path's, a batch's rows) split in
  contiguous blocks, one a data rank, and gathered back on every rank.
- `model`: the fine field's hidden layers split by output column
  (`shard_params_rules`). The train step's autograd route runs them
  tensor-parallel; inference gathers the weights once a frame and runs the
  field kernel whole.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mofanerf_tpu_torch.utils.device import resolve_device
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr

Params = Dict[str, Any]
# a collective that waits longer raises instead of hanging its rank
_TIMEOUT = timedelta(seconds=60)


def init_distributed(device="cuda", backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     local_rank: int | None = None) -> torch.device:
    """Join the default process group and return this rank's device.

    rank, world_size and local_rank default to torchrun's RANK, WORLD_SIZE and
    LOCAL_RANK; init_method to "env://" (torchrun's MASTER_ADDR and
    MASTER_PORT). The backend is NCCL for the card and gloo for the CPU unless
    `backend` names one (gloo also carries CUDA tensors, staged through the
    host: several ranks sharing one card). On the card the rank takes card
    `local_rank % device_count`; without a card it raises unless device="cpu"."""
    dev = resolve_device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)   # the card's context, before the mesh looks for one
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=_TIMEOUT)
    return dev


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call parallel.init_distributed first "
                           "(one process a card)")
    return dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" or torch.cuda.is_initialized() else "cpu"


def make_mesh(n_data: int | None = None, n_model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over the default group's world. Default: every
    rank on the data axis (ray and batch parallelism); n_model > 1 carves a
    tensor-parallel axis for the fine field's width. Ranks are laid out
    row-major, model fastest, as the JAX package reshapes its devices."""
    world = _world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a (data={n_data}, model={n_model}) mesh needs {n_data * n_model} "
                         f"ranks; the world has {world}")
    return init_device_mesh(_device_type(), (n_data, n_model), mesh_dim_names=("data", "model"))


def make_multihost_mesh(n_model: int = 1) -> DeviceMesh:
    """A (dcn, data, model) mesh: `dcn` across hosts (world / ranks a host,
    1 in a single-node world), (data, model) within a host. Ranks a host:
    torchrun's LOCAL_WORLD_SIZE, else the whole world."""
    world = _world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host or per_host % n_model:
        raise ValueError(f"{world} ranks do not split into hosts of {per_host} ranks with "
                         f"model axes of {n_model}")
    return init_device_mesh(_device_type(), (world // per_host, per_host // n_model, n_model),
                            mesh_dim_names=("dcn", "data", "model"))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of a named axis; 1 for an axis the mesh does not have."""
    return mesh[name].size() if name in mesh.mesh_dim_names else 1


def axis_rank(mesh: DeviceMesh, name: str) -> int:
    return mesh.get_local_rank(name) if name in mesh.mesh_dim_names else 0


def _placement_types():
    # DTensor's placement classes; torch.distributed.tensor takes ~1 s to import,
    # so not when a module of the port is imported
    from torch.distributed.tensor import Replicate, Shard

    return Shard, Replicate


def ray_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of a ray batch [N, ...]: rows split over `data`, one
    placement a mesh axis."""
    Shard, Replicate = _placement_types()
    return tuple(Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    _, Replicate = _placement_types()
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


# Declarative tensor-parallel policy for the fine field (models/field.py
# layout, the JAX package's keys). Keys are the EXACT leaf names of hidden
# weight matrices [in, out] and their biases; the output dim (trunk width W
# or view width W/2) shards over 'model'. The tiny output heads stay
# replicated: 'alpha' (W -> 1 density) and the view stage's final 'rgb'
# dense (W/2 -> 3).
_TP_WEIGHT_KEYS = frozenset({
    "w",             # generic dense layers ('layers' / 'mid' / 'post' lists)
    "w_pts", "w_exp",                     # xyz encoder input blocks
    "w_feat0", "w_code0",                 # trunk layer 0 blocks
    "w_skip_code", "w_skip_feat", "w_skip_h",  # trunk skip-layer blocks
    "w_dirs", "w_feat",                   # view stage input blocks
})
_TP_BIAS_KEYS = frozenset({"b", "b0", "b_skip"})


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def _placements(mesh: DeviceMesh, dim: int | None) -> tuple:
    Shard, Replicate = _placement_types()
    return tuple(Shard(dim) if name == "model" and dim is not None else Replicate()
                 for name in mesh.mesh_dim_names)


def shard_params_rules(params: Params, mesh: DeviceMesh) -> Params:
    """A tree of placements matching `params`, one placement a mesh axis.

    Policy (by leaf NAME, as the JAX package's): inside the 'fine' subtree,
    hidden weight matrices (`_TP_WEIGHT_KEYS`) shard their output dim over
    'model' and the matching biases (`_TP_BIAS_KEYS`) their only dim; the
    heads ('alpha', the view stage's 'rgb' dense) and everything outside
    'fine' replicate, and so does a leaf whose last dim does not divide the
    model axis. With n_model == 1 everything replicates. Leaves need only a
    `shape` (meta tensors will do)."""
    n_model = axis_size(mesh, "model")

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if (n_model == 1 or "fine" not in path or "alpha" in path
                or ("view" in path and "rgb" in path)
                or len(shape) < 1 or shape[-1] % n_model):
            return _placements(mesh, None)
        if path[-1] in _TP_WEIGHT_KEYS and len(shape) == 2:
            return _placements(mesh, 1)
        if path[-1] in _TP_BIAS_KEYS and len(shape) == 1:
            return _placements(mesh, 0)
        return _placements(mesh, None)

    return _map_with_path(rule, params)


def _model_dim(placements) -> int | None:
    Shard, _ = _placement_types()
    dims = [p.dim for p in placements if isinstance(p, Shard)]
    return dims[0] if dims else None


def sharded_leaves(params: Params, rules: Params) -> list:
    """The key paths (as jax.tree_util.keystr writes them) of the leaves of
    `params` that `rules` shards, sorted."""
    flags = _zip_map(lambda leaf, pl: _model_dim(pl) is not None, params, rules)
    return sorted(path for path, sharded in flatten_with_keystr(flags) if sharded)


def shard_params(params: Params, rules: Params, mesh: DeviceMesh) -> Params:
    """This rank's shards of the whole tree `params`: each leaf that `rules`
    shards over 'model' cut to the rank's block of its dim (a copy); the rest
    as they are."""
    n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")

    def cut(leaf, placements):
        dim = _model_dim(placements)
        if dim is None:
            return leaf
        return leaf.chunk(n, dim=dim)[r].clone()

    return _zip_map(cut, params, rules)


def gather_params(params: Params, rules: Params, mesh: DeviceMesh) -> Params:
    """The whole tree from this rank's shards, on every rank: the leaves that
    `rules` shards over 'model', gathered along their dim in one collective."""
    from mofanerf_tpu_torch.parallel.collectives import gather_blocks

    flat = []
    _zip_map(lambda leaf, pl: flat.append((leaf, _model_dim(pl))), params, rules)
    whole = iter(gather_blocks([(leaf, dim) for leaf, dim in flat if dim is not None],
                               mesh, "model"))
    return _zip_map(lambda leaf, pl: leaf if _model_dim(pl) is None else next(whole),
                    params, rules)
