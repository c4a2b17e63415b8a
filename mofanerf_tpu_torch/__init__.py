"""PyTorch + CUDA port of the mofanerf_tpu package for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths and function names so each
counterpart is easy to find; it imports torch and numpy only, never jax or
mofanerf_tpu. Entry points default to the card (``device="cuda"``) and
raise when no card is present; pass ``device="cpu"`` explicitly to run the
plain PyTorch versions of the kernels on the CPU.

Ported so far: the distilled-student serving path (``render/serve.py``, one
hand-written CUDA kernel a packet: ``ops/serve_kernel.py`` +
``csrc/serve_kernel.cu``), the teacher two-pass render (``render/renderer.py``,
the conditioned field through ``ops/field_kernel.py`` +
``csrc/field_kernel.cu``), and training (``cli/run_train.py``,
``train/{loop,state,checkpoint}.py``, ``data/``).
"""
