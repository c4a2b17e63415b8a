"""Multi-card scale-out over torch.distributed (counterpart of
mofanerf_tpu/parallel): one process a card, meshes with `data` and `model`
axes, explicit collectives. See mesh.py for the semantics."""
from mofanerf_tpu_torch.parallel.mesh import (
    gather_params,
    init_distributed,
    make_mesh,
    make_multihost_mesh,
    ray_sharding,
    replicated,
    shard_params,
    shard_params_rules,
)

__all__ = ["gather_params", "init_distributed", "make_mesh", "make_multihost_mesh",
           "ray_sharding", "replicated", "shard_params", "shard_params_rules"]
