from mofanerf_tpu_torch.preprocess.align import (
    CANONICAL_LANDMARKS_512,
    procrustes_similarity,
    align_to_template,
    PrecomputedLandmarkSource,
    DlibLandmarkSource,
    get_landmark_source,
)
from mofanerf_tpu_torch.preprocess.pose import rodrigues, fit_pose_orthographic, pose_to_c2w
from mofanerf_tpu_torch.preprocess.matting import hull_mask, apply_mask
from mofanerf_tpu_torch.preprocess.sh import sh_basis, sh_shading

__all__ = [
    "CANONICAL_LANDMARKS_512",
    "procrustes_similarity",
    "align_to_template",
    "PrecomputedLandmarkSource",
    "DlibLandmarkSource",
    "get_landmark_source",
    "rodrigues",
    "fit_pose_orthographic",
    "pose_to_c2w",
    "hull_mask",
    "apply_mask",
    "sh_basis",
    "sh_shading",
]
