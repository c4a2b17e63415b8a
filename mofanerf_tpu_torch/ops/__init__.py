from mofanerf_tpu_torch.ops.uv_sample import bilinear_sample

__all__ = ["bilinear_sample"]
