from mofanerf_tpu_torch.datagen.mesh import load_obj, save_obj, apply_rt_scale, clip_faces_by_distance
from mofanerf_tpu_torch.datagen.rasterize import rasterize_mesh
from mofanerf_tpu_torch.datagen.multiview import (
    camera_grid,
    render_identity,
    write_transforms_json,
)

__all__ = [
    "load_obj",
    "save_obj",
    "apply_rt_scale",
    "clip_faces_by_distance",
    "rasterize_mesh",
    "camera_grid",
    "render_identity",
    "write_transforms_json",
]
