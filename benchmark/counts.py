"""Operations, bytes and peaks of the measured work: the yardstick of every
roofline and utilisation share the benchmark reports.

A frozen copy of the arithmetic that `chip_smoke.py` carries (its lines
332-370 for the fields and the serving kernel, 1588 for the texture encoder,
174-177 for the peaks), written on plain numbers so that nothing of the
program is imported. The layer plan of the field kernel follows
`ops/field_kernel.py::_plan_len`.
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16 = 989e12     # FLOP/s
PEAK_F32 = 67e12       # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM bytes/s


def embed_dim(multires: int) -> int:
    """Width of the positional encoding of a 3-vector at `multires` bands."""
    return 3 + 6 * multires


def field_layers(depth: int, skip: int = 4, xyz_depth: int = 3) -> int:
    """W x W products a point of the conditioned field goes through: the xyz
    encoder's hidden layers and two trunks of (first layer, `skip` middle
    layers, the skip layer's two products, the layers after it)."""
    per_trunk = 1 + skip + 2 + max(0, depth - skip - 2)
    return xyz_depth + 2 * per_trunk


def field_flops_per_point(width: int, multires: int, n_layers: int) -> int:
    """Operations of the conditioned field for one point: the embedding
    layer, the hidden stack, the view layer and the two output heads."""
    W, pe = width, embed_dim(multires)
    return 2 * (pe * W + n_layers * W * W + W * (W // 2) + W + 3 * (W // 2))


def field_weight_bytes(width: int, multires: int, n_layers: int, esize: int) -> int:
    W, W2, pe = width, width // 2, embed_dim(multires)
    weights = (pe * W + n_layers * W * W + W * W2 + W + 3 * W2) * esize
    biases = (W + n_layers * W + W2 + 4) * 4
    return weights + biases


def field_io_bytes(width: int, multires: int, n_rows: int, n_rays: int) -> int:
    """Embedded points and per-ray view features in (f32), [N, 4] f32 out."""
    return n_rows * embed_dim(multires) * 4 + n_rays * (width // 2) * 4 + n_rows * 16


def field_launch_bound_s(width: int, depth: int, multires: int, n_rays: int,
                         n_samples: int, esize: int = 2) -> float:
    """Least time of one field-kernel launch over n_rays x n_samples points:
    the larger of its operations at the bf16 peak and its bytes at HBM's."""
    n_layers = field_layers(depth)
    rows = n_rays * n_samples
    ops = rows * field_flops_per_point(width, multires, n_layers)
    nbytes = (field_weight_bytes(width, multires, n_layers, esize)
              + field_io_bytes(width, multires, rows, n_rays))
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES)


def student_flops_per_sample(depth: int, width: int, multires: int) -> int:
    """Operations of the serving student for one sample."""
    w2 = width // 2
    return 2 * ((3 + 6 * multires) * width + depth * width * width
                + width * (w2 + 1) + w2 * 3)


def serve_kernel_bytes(n_rays: int, depth: int, width: int, multires: int, esize: int) -> int:
    w2 = width // 2
    per_ray = 12 + 12 + 16 + w2 * esize + 32   # o, d, aux, dirf in; 8 floats out
    weights = ((3 + 6 * multires) * width + depth * width * width + width
               + width * w2 + w2 * 3) * esize
    biases = (width + depth * width + 1 + w2 + 3) * 4
    return n_rays * per_ray + weights + biases


def serve_launch_bound_s(n_hit: int, n_rays: int, depth: int, width: int, multires: int,
                         n_samples: int, esize: int = 2) -> float:
    """Least time of one serving-kernel launch: the operations of its hit rays
    (the misses need none) at the bf16 peak, or its bytes at HBM's."""
    ops = n_hit * n_samples * student_flops_per_sample(depth, width, multires)
    return max(ops / PEAK_BF16,
               serve_kernel_bytes(n_rays, depth, width, multires, esize) / PEAK_BYTES)


CONV_WIDTHS = (32, 32, 32, 32, 64, 128, 256)


def encoder_flops(uv_size: int, tex_dim: int) -> int:
    """Forward operations of the texture encoder on one UV map: seven 4x4
    stride-2 convolutions, the FC to 512, `mu`, three decoding layers."""
    side, cin, ops = uv_size, 3, 0
    for cout in CONV_WIDTHS:
        side = (side + 2 - 4) // 2 + 1
        ops += 2 * side * side * cout * cin * 16
        cin = cout
    flat = side * side * cin
    return ops + 2 * (flat * 512 + 512 * tex_dim + 3 * tex_dim ** 2)


def teacher_ray_flops(cfg: dict) -> int:
    """Forward field operations of one teacher ray: the coarse samples through
    the coarse field and the union of coarse and importance samples through
    the fine one."""
    n_c = cfg["N_samples"]
    n_f = cfg["N_samples"] + cfg["N_importance"]
    fc = field_flops_per_point(cfg["netwidth"], cfg["multires"], field_layers(cfg["netdepth"]))
    ff = field_flops_per_point(cfg["netwidth_fine"], cfg["multires"],
                               field_layers(cfg["netdepth_fine"]))
    return n_c * fc + n_f * ff


def train_step_flops(cfg: dict) -> tuple:
    """(field operations, encoder operations) of one train step, forward and
    backward: three times the forward's, as a step's bound counts them."""
    fields = cfg["N_rand"] * teacher_ray_flops(cfg)
    enc = encoder_flops(cfg["uv_size"], cfg["input_ch_textureCodes"])
    return 3 * fields, 3 * enc


def train_step_bound_s(cfg: dict) -> float:
    """Least time of a train step: the fields at the bf16 peak, the texture
    encoder (full f32) at the f32 peak."""
    fields, enc = train_step_flops(cfg)
    return fields / PEAK_BF16 + enc / PEAK_F32
