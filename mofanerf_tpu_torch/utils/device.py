"""Device selection shared by the port's entry points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for `device`, refusing to run without a card.

    Entry points default to "cuda"; on a machine with no card they raise
    here instead of carrying on on the CPU. Pass device="cpu" to ask for
    the CPU explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def to_device(x, dev: torch.device) -> torch.Tensor:
    """A small host array (box, K, pose, a batch's coordinates) as f32 on
    `dev`. To the card it goes from page-locked memory without blocking: a
    plain copy from pageable memory waits for the card's queued work, which
    would keep the host's set-up of the next frame or step from overlapping
    the card's work on this one."""
    t = torch.as_tensor(x, dtype=torch.float32)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it where it does not start on a 16-byte boundary. The
    CUDA kernels load their operands 16 bytes at a time, and a view at another
    offset (a leaf of a flat parameter buffer, say) would fault with a
    misaligned address; a new allocation starts on a 256-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@contextlib.contextmanager
def f32_products():
    """f32 matrix products and convolutions in full f32 (TF32 off in cuBLAS
    and cuDNN) inside the block, forward and backward alike; the previous
    settings are restored after it."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
